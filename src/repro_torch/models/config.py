"""Model configuration (port of the JAX package's `models/config.py`,
unchanged as plain data).

A model is a stack of *stages*. Each stage is one of
  "attn"    — self-attention block (GQA or MLA) + FFN (dense or MoE)
  "local"   — same, sliding-window attention (gemma2-style alternation)
  "mamba"   — Mamba2 SSD block
and stacks are expressed as a repeating PATTERN (layers = pattern × repeats
[+ remainder]).
Hybrid models (zamba2) additionally own SHARED attention blocks invoked
between pattern groups.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_base: float = 10000.0
    rope_dim: Optional[int] = None      # defaults to head_dim
    softcap: Optional[float] = None     # gemma2 attn logit softcap
    sliding_window: Optional[int] = None  # used by "local" stages


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention (v2-lite flavour: no q-lora)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    num_shared: int = 0           # always-on shared experts (same d_expert)
    shared_d_ff: Optional[int] = None  # if set: one fused shared FFN this wide
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    first_dense: int = 0          # leading layers with dense FFN instead
    first_dense_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2               # d_inner = expand · d_model
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256              # SSD chunk length for training


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense|moe|mla_moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttnConfig] = None
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    pattern: Tuple[str, ...] = ("attn",)
    # hybrid (zamba2): a shared attn+FFN block invoked after every pattern
    # group, alternating between `num_shared_blocks` parameter sets.
    num_shared_blocks: int = 0
    shared_every: int = 0         # mamba layers per shared-attn invocation
    ffn_type: str = "glu"         # glu | mlp
    norm_type: str = "rmsnorm"    # rmsnorm | layernorm
    post_norms: bool = False      # gemma2 sandwich norms
    final_softcap: Optional[float] = None
    embed_scale: bool = False     # gemma2 √d_model embedding scaling
    tie_embeddings: bool = False
    input_mode: str = "tokens"    # tokens | embeddings (stubbed frontend)
    dtype: str = "bfloat16"
    # quantized-serving defaults (the paper's operating point)
    weight_bits: int = 4
    act_bits: Optional[int] = None  # None => float activations in GeMV

    def __post_init__(self):
        assert self.num_layers >= len(self.pattern)
        if self.family in ("ssm",):
            assert self.ssm is not None
        if self.mla is not None:
            assert self.attn is not None, "MLA still needs head counts"

    # -- stage stacking -------------------------------------------------------

    @property
    def pattern_repeats(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def remainder_stages(self) -> Tuple[str, ...]:
        rem = self.num_layers - self.pattern_repeats * len(self.pattern)
        return self.pattern[:rem]

    @property
    def moe_layers(self) -> int:
        if self.moe is None:
            return 0
        return self.num_layers - self.moe.first_dense

    # -- convenience dims -----------------------------------------------------

    @property
    def q_dim(self) -> int:
        if self.mla is not None:
            return self.attn.num_heads * (self.mla.qk_nope_head_dim
                                          + self.mla.qk_rope_head_dim)
        return self.attn.num_heads * self.attn.head_dim

    @property
    def kv_dim(self) -> int:
        return self.attn.num_kv_heads * self.attn.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + stacks + head)."""
        from . import model  # local import to avoid cycle
        from .params import count_params
        return count_params(model.param_defs(self))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared only)."""
        total = self.param_count()
        if self.moe is None:
            return total
        e, k = self.moe.num_experts, self.moe.top_k
        ffn = 3 * self.d_model * self.moe.d_expert  # per expert (GLU)
        inactive = self.moe_layers * (e - k) * ffn
        return total - inactive
