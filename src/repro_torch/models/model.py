"""Decoder LM (port of the JAX package's `models/model.py`) for attention
stacks with dense or mixture-of-experts FFNs — the paper's llama2-7b and
its kin, and qwen2-moe.

Parameters keep the JAX package's layout: each pattern stage's parameters
are stacked along a leading "stack" axis, and so are its decode caches. The
JAX package runs a `lax.scan` over that axis; here it is a Python loop over
layers. Three entry points:
  forward(params, batch)                 → logits  [scoring]
  prefill(params, batch, max_seq)        → logits, cache
  decode_step(params, cache, tok, pos)   → logits, cache   [one token]

MLA (with deepseek's leading dense-FFN layers), SSM, hybrid, tied-embedding
and embedding-input configurations wait for the rest of the model zoo
(ROADMAP A7) and raise `NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import attention as attn_mod
from . import moe as moe_mod
from .config import ModelConfig
from .layers import embed, ffn, lm_head, norm
from .params import ParamDef, init_params  # noqa: F401  (re-exported)


ATTN_IMPLS = ("sdpa", "kernel")
#: MoE capacity factor of prefill and decode (the JAX package's)
SERVE_CAPACITY = 2.0


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the configuration kinds the port does not have yet."""
    what = [name for name, on in (
        ("MLA attention", cfg.mla is not None),
        ("leading dense-FFN layers", bool(cfg.moe and cfg.moe.first_dense)),
        ("SSM stages", cfg.ssm is not None or "mamba" in cfg.pattern),
        ("hybrid shared blocks", cfg.num_shared_blocks > 0),
        ("embedding inputs", cfg.input_mode != "tokens"),
        ("tied embeddings", cfg.tie_embeddings)) if on]
    if what or cfg.attn is None:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(what) or 'no attention config'} not "
            f"ported yet (ROADMAP A7); the port serves attention stacks "
            f"with dense or MoE FFNs")


# ---------------------------------------------------------------------------
# Stack plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StackPlan:
    first: int          # leading dense-FFN attn layers (deepseek)
    repeats: int        # pattern repeats in the main stack
    trailing: int       # trailing stages (same kind as pattern[0])


def stack_plan(cfg: ModelConfig) -> StackPlan:
    check_supported(cfg)
    if cfg.num_layers % len(cfg.pattern):
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers not "
                         f"divisible by pattern {cfg.pattern}")
    return StackPlan(first=0, repeats=cfg.num_layers // len(cfg.pattern),
                     trailing=0)


# ---------------------------------------------------------------------------
# Parameter definitions (see params.ParamDef)
# ---------------------------------------------------------------------------

def _stk(stack, shape, axes, **kw):
    pre = ("stack",) * len(stack)
    return ParamDef(tuple(stack) + tuple(shape), pre + tuple(axes), **kw)


def _norm_defs(cfg, stack, dim=None):
    d = dim or cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"scale": _stk(stack, (d,), ("embed",), init="ones"),
                "bias": _stk(stack, (d,), ("embed",), init="zeros")}
    return {"scale": _stk(stack, (d,), ("embed",), init="zeros")}


def _attn_defs(cfg: ModelConfig, stack):
    e, a = cfg.d_model, cfg.attn
    d = {
        "wq": _stk(stack, (e, a.num_heads * a.head_dim), ("embed", "heads")),
        "wk": _stk(stack, (e, a.num_kv_heads * a.head_dim),
                   ("embed", "kv_heads")),
        "wv": _stk(stack, (e, a.num_kv_heads * a.head_dim),
                   ("embed", "kv_heads")),
        "wo": _stk(stack, (a.num_heads * a.head_dim, e), ("heads", "embed")),
    }
    if a.qkv_bias:
        d["bq"] = _stk(stack, (a.num_heads * a.head_dim,), ("heads",),
                       init="zeros")
        d["bk"] = _stk(stack, (a.num_kv_heads * a.head_dim,), ("kv_heads",),
                       init="zeros")
        d["bv"] = _stk(stack, (a.num_kv_heads * a.head_dim,), ("kv_heads",),
                       init="zeros")
    return d


def _ffn_defs(cfg: ModelConfig, stack):
    e, f = cfg.d_model, cfg.d_ff
    if cfg.ffn_type == "glu":
        return {"up": _stk(stack, (e, f), ("embed", "mlp")),
                "gate": _stk(stack, (e, f), ("embed", "mlp")),
                "down": _stk(stack, (f, e), ("mlp", "embed"))}
    return {"up": _stk(stack, (e, f), ("embed", "mlp")),
            "up_b": _stk(stack, (f,), ("mlp",), init="zeros"),
            "down": _stk(stack, (f, e), ("mlp", "embed")),
            "down_b": _stk(stack, (e,), ("embed",), init="zeros")}


def _moe_defs(cfg: ModelConfig, stack):
    e, mc = cfg.d_model, cfg.moe
    ex, f = mc.num_experts, mc.d_expert
    d = {
        "router": _stk(stack, (e, ex), ("embed", "experts"),
                       init="small_normal"),
        "w_up": _stk(stack, (ex, e, f), ("experts", "embed", "expert_mlp"),
                     fan_in_axes=(-2,)),
        "w_gate": _stk(stack, (ex, e, f), ("experts", "embed", "expert_mlp"),
                       fan_in_axes=(-2,)),
        "w_down": _stk(stack, (ex, f, e), ("experts", "expert_mlp", "embed"),
                       fan_in_axes=(-2,)),
    }
    shared = mc.shared_d_ff or (mc.num_shared * f if mc.num_shared else 0)
    if shared:
        d["shared_up"] = _stk(stack, (e, shared), ("embed", "mlp"))
        d["shared_gate"] = _stk(stack, (e, shared), ("embed", "mlp"))
        d["shared_down"] = _stk(stack, (shared, e), ("mlp", "embed"))
    return d


def _stage_defs(cfg: ModelConfig, stack, use_moe: bool):
    d = {"ln1": _norm_defs(cfg, stack), "attn": _attn_defs(cfg, stack),
         "ln2": _norm_defs(cfg, stack)}
    if use_moe:
        d["moe"] = _moe_defs(cfg, stack)
    else:
        d["ffn"] = _ffn_defs(cfg, stack)
    if cfg.post_norms:
        d["ln1_post"] = _norm_defs(cfg, stack)
        d["ln2_post"] = _norm_defs(cfg, stack)
    return d


def param_defs(cfg: ModelConfig):
    plan = stack_plan(cfg)
    return {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
        "stages": {str(i): _stage_defs(cfg, (plan.repeats,),
                                       cfg.moe is not None)
                   for i in range(len(cfg.pattern))},
        "final_norm": _norm_defs(cfg, ()),
        "lm_head": ParamDef((cfg.d_model, cfg.vocab_size),
                            ("embed", "vocab")),
    }


def layer_params(tree, i: int):
    """Layer i of a stacked parameter (or cache) tree: every leaf indexed
    on its leading stack axis (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Stage application
# ---------------------------------------------------------------------------

def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.attn.sliding_window if kind == "local" else None


def _finish_stage(x, h, p, cfg: ModelConfig, act_bits, impl,
                  capacity_factor: Optional[float] = None):
    """Residual + FFN half of an attention stage → (x, aux loss: the
    router's, 0 for a dense FFN). A MoE FFN runs at the config's capacity
    factor unless `capacity_factor` is given (prefill and decode take 2.0,
    as the JAX package's do)."""
    if cfg.post_norms:
        h = norm(h, p["ln1_post"], cfg.norm_type)
    x = x + h
    h = norm(x, p["ln2"], cfg.norm_type)
    aux = None
    if "moe" in p:
        mc = cfg.moe if capacity_factor is None else dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor)
        h, aux = moe_mod.moe_ffn(h, p["moe"], mc, cfg.ffn_type, act_bits,
                                 impl)
    else:
        h = ffn(h, p["ffn"], cfg.ffn_type, act_bits, impl)
    if cfg.post_norms:
        h = norm(h, p["ln2_post"], cfg.norm_type)
    return x + h, aux


class Model:
    """Functional wrapper bound to a ModelConfig."""

    def __init__(self, cfg: ModelConfig, act_bits: Optional[int] = None,
                 impl=None, kv_bits: Optional[int] = None,
                 attn_impl: str = "sdpa"):
        check_supported(cfg)
        self.cfg = cfg
        self.act_bits = act_bits
        self.impl = impl
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{attn_impl!r}")
        self.kv_bits = kv_bits      # 8 → int8 KV cache
        # decode attention: "sdpa" (plain, widens the cache) or "kernel"
        # (the flash-decode kernel B4 on the raw cache; its plain version
        # on CPU tensors, where the JAX package says "kernel_interpret")
        self.attn_impl = attn_impl

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    def _layers(self, params):
        """(layer params, pattern index, kind) in stack order."""
        cfg = self.cfg
        for r in range(stack_plan(cfg).repeats):
            for i, kind in enumerate(cfg.pattern):
                yield layer_params(params["stages"][str(i)], r), i, r, kind

    def _embed_in(self, params, tokens):
        cfg = self.cfg
        return embed(tokens, params["embed"], cfg.embed_scale, cfg.d_model,
                     dtype=self.dtype)

    def _logits(self, params, x):
        return lm_head(x, params["lm_head"], self.cfg.final_softcap,
                       self.act_bits, self.impl)

    # -- full-sequence forward ----------------------------------------------

    def forward(self, params, batch):
        """batch: {"tokens" (B,S)} → logits (B,S,V), aux loss (the MoE
        routers' summed over layers; 0 without MoE)."""
        cfg = self.cfg
        x = self._embed_in(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        ab, impl = self.act_bits, self.impl
        aux = torch.zeros((), device=x.device)
        for p, _i, _r, kind in self._layers(params):
            h = attn_mod.gqa_forward(norm(x, p["ln1"], cfg.norm_type),
                                     p["attn"], cfg.attn, _window(cfg, kind),
                                     positions, ab, impl)
            x, a = _finish_stage(x, h, p, cfg, ab, impl)
            if a is not None:
                aux = aux + a
        x = norm(x, params["final_norm"], cfg.norm_type)
        return self._logits(params, x), aux

    # -- caches ----------------------------------------------------------------

    def _slots(self, kind: str, max_seq: int) -> int:
        window = _window(self.cfg, kind)
        return min(window, max_seq) if window else max_seq

    def init_cache(self, batch: int, max_seq: int, device=None):
        cfg, plan = self.cfg, stack_plan(self.cfg)
        stages = {}
        for i, kind in enumerate(cfg.pattern):
            c = attn_mod.gqa_cache_init(batch, self._slots(kind, max_seq),
                                        cfg.attn, self.dtype, self.kv_bits,
                                        device)
            stages[str(i)] = {k: v.expand(plan.repeats, *v.shape).clone()
                              for k, v in c.items()}
        return {"stages": stages}

    # -- decode ------------------------------------------------------------------

    def decode_step(self, params, cache, inp, pos):
        """One token for the whole batch. inp: (B,) int tokens; pos: the
        current position (int or (B,) tensor). The cache is updated in
        place; returns (logits (B, V), cache)."""
        cfg = self.cfg
        x = self._embed_in(params, inp[:, None])
        pos = torch.as_tensor(pos, device=x.device)
        ab, impl = self.act_bits, self.impl
        for p, i, r, kind in self._layers(params):
            c = layer_params(cache["stages"][str(i)], r)
            h, _ = attn_mod.gqa_decode(norm(x, p["ln1"], cfg.norm_type),
                                       p["attn"], cfg.attn,
                                       _window(cfg, kind), c, pos, ab, impl,
                                       attn_impl=self.attn_impl)
            x, _ = _finish_stage(x, h, p, cfg, ab, impl, SERVE_CAPACITY)
        x = norm(x, params["final_norm"], cfg.norm_type)
        return self._logits(params, x)[:, 0], cache

    # -- prefill -------------------------------------------------------------------

    def _kv_to_cache(self, kind: str, kv, max_seq: int) -> dict:
        """Full-sequence attention products → position-stamped decode
        cache."""
        k, v = kv
        b, s = k.shape[:2]
        slots = self._slots(kind, max_seq)
        c = attn_mod.gqa_cache_init(b, slots, self.cfg.attn, k.dtype,
                                    self.kv_bits, k.device)
        keep = min(s, slots)
        ps = torch.arange(s - keep, s, device=k.device)
        ring = ps % slots
        if self.kv_bits == 8:
            kq, ks = attn_mod._kv_quant(k[:, s - keep:])
            vq, vs = attn_mod._kv_quant(v[:, s - keep:])
            c["k"][:, ring], c["v"][:, ring] = kq, vq
            c["k_scale"][:, ring], c["v_scale"][:, ring] = ks, vs
        else:
            c["k"][:, ring] = k[:, s - keep:]
            c["v"][:, ring] = v[:, s - keep:]
        c["positions"][:, ring] = ps.to(torch.int32)
        return c

    def prefill(self, params, batch, max_seq: int):
        """One full-sequence pass producing (last-token logits, decode
        cache in the stacked layout)."""
        cfg = self.cfg
        x = self._embed_in(params, batch["tokens"])
        s = x.shape[1]
        if s > max_seq:
            raise ValueError(f"prompt length {s} exceeds max_seq={max_seq}")
        positions = torch.arange(s, device=x.device)
        ab, impl = self.act_bits, self.impl
        per_stage: dict = {str(i): [] for i in range(len(cfg.pattern))}
        for p, i, _r, kind in self._layers(params):
            h, kv = attn_mod.gqa_forward(norm(x, p["ln1"], cfg.norm_type),
                                         p["attn"], cfg.attn,
                                         _window(cfg, kind), positions, ab,
                                         impl, return_kv=True)
            per_stage[str(i)].append(self._kv_to_cache(kind, kv, max_seq))
            x, _ = _finish_stage(x, h, p, cfg, ab, impl, SERVE_CAPACITY)
        cache = {"stages": {
            i: {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
            for i, cs in per_stage.items()}}
        x = norm(x, params["final_norm"], cfg.norm_type)
        return self._logits(params, x[:, -1:])[:, 0], cache
