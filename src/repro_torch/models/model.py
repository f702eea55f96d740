"""Decoder LM (port of the JAX package's `models/model.py`): stacks of
attention stages — GQA or MLA, with dense or mixture-of-experts FFNs — and
of Mamba2 stages, token or embedding inputs, a separate or a tied output
head: the paper's llama2-7b and every architecture of the JAX package's
zoo.

Parameters keep the JAX package's layout, each stack's parameters stacked
along a leading "stack" axis, and so are their decode caches:
  first    — leading dense-FFN attention layers (deepseek)
  stages   — the repeating pattern, one entry per pattern stage
  shared   — the hybrid's (zamba2) shared attention blocks, invoked after
             every pattern group: invocation r reads parameters
             shared[r mod num_shared_blocks] but its own cache shared[r]
  trailing — remainder layers (zamba2: 81 = 13·6 + 3)
The JAX package runs a `lax.scan` over each stack; here it is a Python
loop over layers, each stacked parameter unbound once a pass (views; one
stack op a leaf in the backward). Three entry points:
  forward(params, batch)                 → logits, aux  [scoring, training]
  prefill(params, batch, max_seq)        → logits, cache
  decode_step(params, cache, inp, pos)   → logits, cache   [one token]
A batch holds "tokens" (B, S), or "embeddings" (B, S, E) for a config
whose frontend is stubbed (`input_mode="embeddings"`); `inp` is then (B,)
tokens or (B, E) embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import embed, ffn, lm_head, norm, softcap
from .params import ParamDef, init_params  # noqa: F401  (re-exported)


ATTN_IMPLS = ("sdpa", "kernel")
#: MoE capacity factor of prefill and decode (the JAX package's)
SERVE_CAPACITY = 2.0


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration with attention stages (or hybrid shared
    blocks) but no attention config, or Mamba2 stages but no SSM
    config."""
    attention = (any(k != "mamba" for k in cfg.pattern)
                 or cfg.num_shared_blocks > 0)
    if attention and cfg.attn is None:
        raise NotImplementedError(
            f"{cfg.name}: attention stages with no attention config")
    if "mamba" in cfg.pattern and cfg.ssm is None:
        raise NotImplementedError(
            f"{cfg.name}: Mamba2 stages with no SSM config")


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
    if cfg.family == "hybrid":
        groups = cfg.num_layers // cfg.shared_every
        return StackPlan(first=0, repeats=groups,
                         trailing=cfg.num_layers - groups * cfg.shared_every)
    first = cfg.moe.first_dense if cfg.moe else 0
    body = cfg.num_layers - first
    if body % len(cfg.pattern):
        raise ValueError(f"{cfg.name}: {body} layers after {first} leading "
                         f"ones not divisible by pattern {cfg.pattern}")
    return StackPlan(first=first, repeats=body // len(cfg.pattern),
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
    if cfg.mla is not None:
        m, h = cfg.mla, a.num_heads
        return {
            "wq": _stk(stack, (e, h * (m.qk_nope_head_dim
                                       + m.qk_rope_head_dim)),
                       ("embed", "heads")),
            "w_dkv": _stk(stack, (e, m.kv_lora_rank + m.qk_rope_head_dim),
                          ("embed", "lora")),
            "kv_norm": _norm_defs(
                dataclasses.replace(cfg, norm_type="rmsnorm"), stack,
                m.kv_lora_rank),
            "w_uk": _stk(stack, (m.kv_lora_rank, h * m.qk_nope_head_dim),
                         ("lora", "heads")),
            "w_uv": _stk(stack, (m.kv_lora_rank, h * m.v_head_dim),
                         ("lora", "heads")),
            "wo": _stk(stack, (h * m.v_head_dim, e), ("heads", "embed")),
        }
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


def _ffn_defs(cfg: ModelConfig, stack, d_ff: Optional[int] = None):
    e, f = cfg.d_model, d_ff or cfg.d_ff
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


def _mamba_defs(cfg: ModelConfig, stack):
    e, s = cfg.d_model, cfg.ssm
    di, h = cfg.d_inner, cfg.ssm_heads
    conv_ch = di + 2 * s.n_groups * s.d_state
    proj_out = 2 * di + 2 * s.n_groups * s.d_state + h
    return {
        "in_proj": _stk(stack, (e, proj_out), ("embed", "inner")),
        "conv_w": _stk(stack, (s.d_conv, conv_ch), ("conv", "inner")),
        "conv_b": _stk(stack, (conv_ch,), ("inner",), init="zeros"),
        "dt_bias": _stk(stack, (h,), ("state",), init="zeros"),
        "a_log": _stk(stack, (h,), ("state",), init="arange_neg"),
        "d_skip": _stk(stack, (h,), ("state",), init="ones"),
        "out_norm": {"scale": _stk(stack, (di,), ("inner",), init="zeros")},
        "out_proj": _stk(stack, (di, e), ("inner", "embed")),
    }


def _stage_defs(cfg: ModelConfig, kind: str, stack, use_moe: bool,
                dense_d_ff: Optional[int] = None):
    if kind == "mamba":
        return {"ln": _norm_defs(cfg, stack),
                "mamba": _mamba_defs(cfg, stack)}
    d = {"ln1": _norm_defs(cfg, stack), "attn": _attn_defs(cfg, stack),
         "ln2": _norm_defs(cfg, stack)}
    if use_moe:
        d["moe"] = _moe_defs(cfg, stack)
    else:
        d["ffn"] = _ffn_defs(cfg, stack, dense_d_ff)
    if cfg.post_norms:
        d["ln1_post"] = _norm_defs(cfg, stack)
        d["ln2_post"] = _norm_defs(cfg, stack)
    return d


def param_defs(cfg: ModelConfig):
    """The JAX package's tree: `embed` only where tokens come in or the
    head is tied to it, `lm_head` only where it is not; `first` only where
    the config has leading dense-FFN layers; `shared` (one entry per
    parameter set) and `trailing` only for a hybrid."""
    plan = stack_plan(cfg)
    use_moe = cfg.moe is not None
    defs: dict = {}
    if cfg.input_mode == "tokens" or cfg.tie_embeddings:
        defs["embed"] = ParamDef((cfg.vocab_size, cfg.d_model),
                                 ("vocab", "embed"))
    if plan.first:
        defs["first"] = _stage_defs(cfg, cfg.pattern[0], (plan.first,),
                                    use_moe=False,
                                    dense_d_ff=cfg.moe.first_dense_d_ff)
    defs["stages"] = {str(i): _stage_defs(cfg, kind, (plan.repeats,),
                                          use_moe)
                      for i, kind in enumerate(cfg.pattern)}
    if cfg.num_shared_blocks:
        defs["shared"] = _stage_defs(cfg, "attn", (cfg.num_shared_blocks,),
                                     use_moe=False)
    if plan.trailing:
        defs["trailing"] = _stage_defs(cfg, cfg.pattern[0], (plan.trailing,),
                                       use_moe)
    defs["final_norm"] = _norm_defs(cfg, ())
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   ("embed", "vocab"))
    return defs


def param_pspecs(cfg: ModelConfig, mesh=None, rules=None):
    """The `PartitionSpec` of every parameter of `cfg` on `mesh`."""
    from ..parallel.sharding import defs_to_pspecs
    return defs_to_pspecs(param_defs(cfg), mesh, rules)


def layer_params(tree, i: int):
    """Layer i of a stacked parameter (or cache) tree: every leaf indexed
    on its leading stack axis (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> list:
    """The n layers of a stacked parameter tree: tensor leaves unbound
    along their leading stack axis (views; their gradient is one stack of
    the layers' gradients), other leaves (bit-plane, quantized) indexed."""
    if isinstance(tree, dict):
        cols = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: c[i] for k, c in cols.items()} for i in range(n)]
    if isinstance(tree, torch.Tensor):
        return list(torch.unbind(tree))
    return [tree[i] for i in range(n)]


# ---------------------------------------------------------------------------
# Stage application
# ---------------------------------------------------------------------------

def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.attn.sliding_window if kind == "local" else None


#: the stacks that sit at the top of a parameter or cache tree; the
#: pattern stages sit under "stages", by their index
_TOP_STACKS = ("first", "shared", "trailing")


def _stack(tree, name: str):
    """The stacked subtree of a parameter or cache tree that holds the
    layer stack `name`: "first", "shared", "trailing" or a pattern stage's
    index."""
    return tree[name] if name in _TOP_STACKS else tree["stages"][name]


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
                 impl=None, remat: bool = False,
                 kv_bits: Optional[int] = None, attn_impl: str = "sdpa"):
        check_supported(cfg)
        self.cfg = cfg
        self.act_bits = act_bits
        self.impl = impl
        # layer-level remat of `forward` under autograd: each leading or
        # trailing layer and each pattern group (with its shared-block
        # invocation) is one `torch.utils.checkpoint` unit, as each scan
        # body is one `jax.checkpoint` in the JAX package
        self.remat = remat
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{attn_impl!r}")
        self.kv_bits = kv_bits      # 8 → int8 KV cache (GQA stages)
        # decode attention: "sdpa" (plain, widens the cache) or "kernel"
        # (the flash-decode kernel B4 on the raw cache; its plain version
        # on CPU tensors, where the JAX package says "kernel_interpret");
        # MLA ignores it, as in the JAX package
        self.attn_impl = attn_impl

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    def _units(self, params) -> list:
        """The layers in order, grouped as the JAX package's scan bodies:
        each leading dense-FFN layer alone; each pattern group's stages
        followed by its shared-block invocation (group r reads parameter
        set r mod num_shared_blocks and cache r); each trailing layer
        alone. A layer is (layer params, stack name, index in the stack's
        cache, kind)."""
        cfg, plan = self.cfg, stack_plan(self.cfg)
        units = []
        if plan.first:
            units += [[(p, "first", r, cfg.pattern[0])] for r, p in
                      enumerate(_unstack(params["first"], plan.first))]
        stages = [_unstack(params["stages"][str(i)], plan.repeats)
                  for i in range(len(cfg.pattern))]
        shared = (_unstack(params["shared"], cfg.num_shared_blocks)
                  if cfg.num_shared_blocks else None)
        for r in range(plan.repeats):
            unit = [(stages[i][r], str(i), r, kind)
                    for i, kind in enumerate(cfg.pattern)]
            if shared:
                unit.append((shared[r % cfg.num_shared_blocks], "shared", r,
                             "attn"))
            units.append(unit)
        if plan.trailing:
            units += [[(p, "trailing", r, cfg.pattern[0])] for r, p in
                      enumerate(_unstack(params["trailing"], plan.trailing))]
        return units

    def _layers(self, params):
        """Every layer of `_units`, in order."""
        for unit in self._units(params):
            yield from unit

    def _embed_in(self, params, batch):
        """batch["embeddings"] (a stubbed frontend's) in the model's dtype,
        or the token embedding of batch["tokens"]."""
        cfg = self.cfg
        if cfg.input_mode == "embeddings":
            return batch["embeddings"].to(self.dtype)
        return embed(batch["tokens"], params["embed"], cfg.embed_scale,
                     cfg.d_model, dtype=self.dtype)

    def _logits(self, params, x):
        cfg = self.cfg
        if cfg.tie_embeddings:
            # a float product against the embedding table outside the
            # bit-plane kernels, in x's dtype, as in the JAX package
            # (`ServeEngine` holds a tied table in that dtype already)
            logits = x @ params["embed"].to(x.dtype).T
            return softcap(logits.to(torch.float32), cfg.final_softcap)
        return lm_head(x, params["lm_head"], cfg.final_softcap,
                       self.act_bits, self.impl)

    def _attention(self, h, p, kind: str, positions, return_kv=False):
        """A stage's full-sequence attention (MLA or GQA)."""
        cfg, ab, impl = self.cfg, self.act_bits, self.impl
        if cfg.mla is not None:
            return attn_mod.mla_forward(h, p["attn"], cfg.attn, cfg.mla,
                                        positions, ab, impl, return_kv)
        return attn_mod.gqa_forward(h, p["attn"], cfg.attn,
                                    _window(cfg, kind), positions, ab, impl,
                                    return_kv)

    # -- full-sequence forward ----------------------------------------------

    def forward(self, params, batch):
        """batch: {"tokens" (B,S) | "embeddings" (B,S,E)} → logits
        (B,S,V), aux loss (the MoE routers' summed over layers; 0 without
        MoE). Differentiable in the float parameters; with `remat` and
        autograd on, each unit of `_units` is recomputed in the
        backward instead of keeping its activations."""
        cfg = self.cfg
        x = self._embed_in(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        ab, impl = self.act_bits, self.impl

        def run(x, aux, unit):
            for p, _name, _r, kind in unit:
                if kind == "mamba":
                    h, _ = ssm_mod.mamba_forward(
                        norm(x, p["ln"], cfg.norm_type), p["mamba"], cfg, ab,
                        impl)
                    x = x + h
                    continue
                h = self._attention(norm(x, p["ln1"], cfg.norm_type), p,
                                    kind, positions)
                x, a = _finish_stage(x, h, p, cfg, ab, impl)
                if a is not None:
                    aux = aux + a
            return x, aux

        remat = self.remat and torch.is_grad_enabled()
        aux = torch.zeros((), device=x.device)
        for unit in self._units(params):
            if remat:
                x, aux = checkpoint(run, x, aux, unit, use_reentrant=False)
            else:
                x, aux = run(x, aux, unit)
        x = norm(x, params["final_norm"], cfg.norm_type)
        return self._logits(params, x), aux

    # -- caches ----------------------------------------------------------------

    def _slots(self, kind: str, max_seq: int) -> int:
        window = _window(self.cfg, kind)
        return min(window, max_seq) if window else max_seq

    def _layer_cache(self, kind: str, batch: int, max_seq: int, dtype,
                     device) -> dict:
        cfg = self.cfg
        if kind == "mamba":
            return ssm_mod.mamba_cache_init(batch, cfg, dtype, device)
        if cfg.mla is not None:
            return attn_mod.mla_cache_init(batch, max_seq, cfg.mla, dtype,
                                           device)
        return attn_mod.gqa_cache_init(batch, self._slots(kind, max_seq),
                                       cfg.attn, dtype, self.kv_bits,
                                       device)

    def init_cache(self, batch: int, max_seq: int, device=None):
        cfg, plan = self.cfg, stack_plan(self.cfg)

        def stacked(kind, n):
            c = self._layer_cache(kind, batch, max_seq, self.dtype, device)
            return {k: v.expand(n, *v.shape).clone() for k, v in c.items()}
        cache: dict = {}
        if plan.first:
            cache["first"] = stacked(cfg.pattern[0], plan.first)
        cache["stages"] = {str(i): stacked(kind, plan.repeats)
                           for i, kind in enumerate(cfg.pattern)}
        if cfg.num_shared_blocks:
            # one cache per invocation, not per parameter set
            cache["shared"] = stacked("attn", plan.repeats)
        if plan.trailing:
            cache["trailing"] = stacked(cfg.pattern[0], plan.trailing)
        return cache

    # -- decode ------------------------------------------------------------------

    def decode_step(self, params, cache, inp, pos):
        """One token for the whole batch. inp: (B,) int tokens, or (B, E)
        embeddings for a stubbed frontend; pos: the current position (int
        or (B,) tensor). The cache is updated in place; returns (logits
        (B, V), cache)."""
        cfg = self.cfg
        key = "embeddings" if cfg.input_mode == "embeddings" else "tokens"
        x = self._embed_in(params, {key: inp[:, None]})
        pos = torch.as_tensor(pos, device=x.device)
        ab, impl = self.act_bits, self.impl
        for p, name, r, kind in self._layers(params):
            c = layer_params(_stack(cache, name), r)
            if kind == "mamba":
                h, _ = ssm_mod.mamba_decode(norm(x, p["ln"], cfg.norm_type),
                                            p["mamba"], cfg, c, ab, impl)
                x = x + h
                continue
            h = norm(x, p["ln1"], cfg.norm_type)
            if cfg.mla is not None:
                h, _ = attn_mod.mla_decode(h, p["attn"], cfg.attn, cfg.mla,
                                           c, pos, ab, impl)
            else:
                h, _ = attn_mod.gqa_decode(h, p["attn"], cfg.attn,
                                           _window(cfg, kind), c, pos, ab,
                                           impl, attn_impl=self.attn_impl)
            x, _ = _finish_stage(x, h, p, cfg, ab, impl, SERVE_CAPACITY)
        x = norm(x, params["final_norm"], cfg.norm_type)
        return self._logits(params, x)[:, 0], cache

    # -- prefill -------------------------------------------------------------------

    def _kv_to_cache(self, kind: str, kv, max_seq: int) -> dict:
        """A stage's full-sequence products → its decode cache: a Mamba2
        stage's is the one `mamba_forward` returned; MLA's (c_kv, k_rope)
        go in slots 0..s−1, GQA's (k, v) in the ring of the stage's slots,
        each stamped with its position."""
        if kind == "mamba":
            return kv
        if self.cfg.mla is not None:
            c_kv, k_rope = kv
            b, s = c_kv.shape[:2]
            c = self._layer_cache(kind, b, max_seq, c_kv.dtype, c_kv.device)
            c["c_kv"][:, :s] = c_kv
            c["k_rope"][:, :s] = k_rope
            c["positions"][:, :s] = torch.arange(s, dtype=torch.int32,
                                                 device=c_kv.device)
            return c
        k, v = kv
        b, s = k.shape[:2]
        slots = self._slots(kind, max_seq)
        c = self._layer_cache(kind, b, max_seq, k.dtype, k.device)
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
        x = self._embed_in(params, batch)
        s = x.shape[1]
        if s > max_seq:
            raise ValueError(f"prompt length {s} exceeds max_seq={max_seq}")
        positions = torch.arange(s, device=x.device)
        ab, impl = self.act_bits, self.impl
        per_stack: dict = {}
        for p, name, _r, kind in self._layers(params):
            if kind == "mamba":
                h, kv = ssm_mod.mamba_forward(
                    norm(x, p["ln"], cfg.norm_type), p["mamba"], cfg, ab,
                    impl)
                x = x + h
            else:
                h, kv = self._attention(norm(x, p["ln1"], cfg.norm_type), p,
                                        kind, positions, return_kv=True)
                x, _ = _finish_stage(x, h, p, cfg, ab, impl, SERVE_CAPACITY)
            per_stack.setdefault(name, []).append(
                self._kv_to_cache(kind, kv, max_seq))
        cache: dict = {"stages": {}}
        for name, cs in per_stack.items():
            c = {k: torch.stack([one[k] for one in cs]) for k in cs[0]}
            if name in _TOP_STACKS:
                cache[name] = c
            else:
                cache["stages"][name] = c
        x = norm(x, params["final_norm"], cfg.norm_type)
        return self._logits(params, x[:, -1:])[:, 0], cache
