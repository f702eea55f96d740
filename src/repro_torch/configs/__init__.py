"""Architecture registry of the port: the paper's llama2-7b and every
architecture of the JAX package's zoo — the dense qwen2-7b, starcoder2-3b,
gemma2-2b and gemma2-9b (tied embeddings), musicgen-medium and pixtral-12b
(embedding inputs from a stubbed frontend), the mixture-of-experts
qwen2-moe-a2.7b and deepseek-v2-lite-16b (MLA, a leading dense-FFN layer),
the SSM mamba2-1.3b (tied embeddings) and the hybrid zamba2-7b (Mamba2
layers with two shared attention blocks) — and reduced ("tiny") variants
for CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import MLAConfig, ModelConfig, SSMConfig
from .shapes import SHAPES, ShapeProfile  # noqa: F401  (re-exported)

# arch id -> (module, long_500k runnable?) — the JAX package's registry
ARCHS = {
    "deepseek-v2-lite-16b": ("deepseek_v2_lite_16b", False),
    "qwen2-moe-a2.7b": ("qwen2_moe_a2_7b", False),
    "starcoder2-3b": ("starcoder2_3b", False),
    "gemma2-2b": ("gemma2_2b", True),
    "gemma2-9b": ("gemma2_9b", True),
    "qwen2-7b": ("qwen2_7b", False),
    "musicgen-medium": ("musicgen_medium", False),
    "mamba2-1.3b": ("mamba2_1_3b", True),
    "pixtral-12b": ("pixtral_12b", False),
    "zamba2-7b": ("zamba2_7b", True),
    "llama2-7b": ("llama2_7b", False),
}

#: the ten assigned architectures (every one but the paper's llama2-7b)
ASSIGNED = [k for k in ARCHS if k != "llama2-7b"]


def get_config(arch: str) -> ModelConfig:
    mod, _ = ARCHS[arch]
    return importlib.import_module(f".{mod}", __package__).get_config()


def long_ok(arch: str) -> bool:
    return ARCHS[arch][1]


def cells(include_paper_model: bool = False):
    """All live (arch, shape) dry-run cells, and the skipped ones
    (long_500k for an arch without sub-quadratic state)."""
    archs = list(ARCHS) if include_paper_model else ASSIGNED
    out, skipped = [], []
    for a in archs:
        for s in SHAPES:
            if s == "long_500k" and not long_ok(a):
                skipped.append((a, s))
            else:
                out.append((a, s))
    return out, skipped


def tiny_config(arch: str) -> ModelConfig:
    """Same family and topology at tiny dims — the JAX package's
    `tiny_config` (MoE: 8 experts, top-2, d_expert 32, a fused shared FFN
    64 wide where the config has shared experts, leading dense layers 96
    wide; MLA: rank 32, head dims 16/8/16; SSM: state 16, heads of 16,
    chunk 8, no FFN; hybrid: 5 layers of a ("mamba",) × 2 pattern, a
    shared block after every 2)."""
    cfg = get_config(arch)
    attn = cfg.attn and dataclasses.replace(
        cfg.attn, num_heads=4, num_kv_heads=min(cfg.attn.num_kv_heads, 2),
        head_dim=16, sliding_window=8 if cfg.attn.sliding_window else None)
    mla = cfg.mla and MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                                qk_rope_head_dim=8, v_head_dim=16)
    moe = cfg.moe and dataclasses.replace(
        cfg.moe, num_experts=8, top_k=2, d_expert=32,
        shared_d_ff=64 if (cfg.moe.num_shared or cfg.moe.shared_d_ff)
        else None,
        first_dense_d_ff=96 if cfg.moe.first_dense else 0)
    ssm = cfg.ssm and SSMConfig(d_state=16, head_dim=16, expand=2,
                                n_groups=1, d_conv=4, chunk=8)
    if cfg.family == "hybrid":
        layers, pattern, shared_every = 5, ("mamba",) * 2, 2
    else:
        first = cfg.moe.first_dense if cfg.moe else 0
        layers = first + 2 * len(cfg.pattern)
        pattern, shared_every = cfg.pattern, cfg.shared_every
    return dataclasses.replace(
        cfg, name=f"tiny-{cfg.name}", num_layers=layers, d_model=64,
        d_ff=0 if cfg.ssm and cfg.family == "ssm" else 128,
        vocab_size=256, attn=attn, mla=mla, moe=moe, ssm=ssm,
        pattern=pattern, shared_every=shared_every)
