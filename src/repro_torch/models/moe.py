"""Mixture-of-Experts FFN with capacity-based dispatch (port of the JAX
package's `models/moe.py`, GShard-style).

Tokens are split into groups; each group gives every expert a buffer of
`_capacity` rows. A token's row in an expert's buffer is its rank among the
group's tokens routed there, in token order (a cumulative sum over the
group); a token ranked at or past the capacity is dropped by that expert.
The JAX package writes dispatch and combine as einsums against one-hot
(G, S, Ex, C) tensors; here they are one scatter of the kept (token,
expert) pairs into a zeroed (Ex, G·C, E) buffer and one gather back — the
same rows, positions and drops, with no O(S·Ex·C) tensor.

The routed experts' matrices are E-stacked: dense (Ex, din, dout) arrays,
or E-stacked `BitplaneWeights`, whose whole stack goes through ONE launch
of B3 (`kernels/bitplane_gemv/ops.py:bitplane_gemv` on (Ex, rows, din)
activations), where the JAX package vmaps B3 over the experts.

Supports the two MoE flavours of the JAX package's zoo:
  deepseek-v2-lite: 64 routed / top-6 + 2 always-on shared experts,
                    first layer dense (first_dense=1: the model's
                    `first` stack);
  qwen2-moe:        60 routed / top-4 + 4 shared experts (padded to 64
                    routed by the config).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import backends
from ..core.bitplane import BitplaneWeights
from .config import MoEConfig
from .layers import _gelu, dense, dense_group


GROUP_SIZE = 256   # tokens per dispatch group (GShard "group" dim)


def _expert_mm(xe: torch.Tensor, w, impl=None,
               counts: Optional[torch.Tensor] = None,
               live: Optional[int] = None) -> torch.Tensor:
    """Per-expert matmul (Ex, R, din) × w → (Ex, R, dout).

    `w` is a dense (Ex, din, dout) tensor, or an E-stacked BitplaneWeights,
    whose stack runs as one bit-plane GeMV over all experts (B3's stacked
    launch on CUDA tensors). `counts` (Ex,) int32 on the device, where
    given, says that expert e's rows at and past counts[e] are zero: the
    kernel then writes their zeros without reading them; `live`, a host
    int, bounds the experts with rows (the kernel's grid walks that many).
    A callable `impl`
    standing for a backend (the serve engine's `EngineLinear`) resolves to
    that backend's kernel impl, as the JAX package reads its `.mode`; any
    other callable takes the whole stack, `impl(xe, w, None)`."""
    if isinstance(w, BitplaneWeights):
        impl = backends.resolve_impl(getattr(impl, "backend", impl))
        if callable(impl):
            out = impl(xe, w, None)
        else:
            from ..kernels.bitplane_gemv import ops as bp
            out = bp.bitplane_gemv(xe, w, impl=impl, counts=counts,
                                   live=live)
        return out.to(xe.dtype)
    return torch.einsum("erd,edf->erf", xe, w.to(xe.dtype))


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, (c + 7) // 8 * 8)   # pad to 8 for clean tiling


def _route(x: torch.Tensor, w_router, cfg: MoEConfig) -> tuple:
    """`router`, plus the top-k expert indices (..., k) in descending
    probability, the lower index first on a tie (`jax.lax.top_k`'s rule:
    a stable descending sort)."""
    logits = dense(x, w_router).to(torch.float32)            # (..., Ex)
    probs = torch.softmax(logits, dim=-1)
    top_idx = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[..., :cfg.top_k]
    mask = torch.zeros_like(probs).scatter_(-1, top_idx, 1.0)
    gates = probs * mask
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balancing auxiliary loss (Switch/GShard form), over ALL tokens
    me = probs.reshape(-1, cfg.num_experts).mean(dim=0)
    ce = mask.reshape(-1, cfg.num_experts).mean(dim=0) / cfg.top_k
    aux = cfg.num_experts * (me * ce).sum() * cfg.router_aux_weight
    return gates, mask, aux, top_idx


def router(x: torch.Tensor, w_router, cfg: MoEConfig) -> tuple:
    """x (..., E_model) → gates (..., Ex), top-k mask (..., Ex), aux
    loss."""
    gates, mask, aux, _ = _route(x, w_router, cfg)
    return gates, mask, aux


def _shared(x: torch.Tensor, p, act_bits, impl) -> torch.Tensor:
    """The always-on shared experts, fused into one GLU FFN; up/gate as
    one group (one B2 launch at act_bits on the kernel backend)."""
    sup, sgt = dense_group(x, (p["shared_up"], p["shared_gate"]),
                           act_bits=act_bits, impl=impl)
    sh = _gelu(sgt.to(torch.float32)).to(x.dtype) * sup
    return dense(sh, p["shared_down"], act_bits=act_bits, impl=impl)


def moe_ffn(x: torch.Tensor, p, cfg: MoEConfig, ffn_type: str = "glu",
            act_bits=None, impl=None, group_size: int = GROUP_SIZE
            ) -> tuple:
    """x (B, S, E) → (B, S, E), aux loss.

    Grouped capacity dispatch: tokens are partitioned into groups of
    `group_size` (one group if that does not divide the token count), each
    with capacity C = S_g·k·cf/Ex rounded up to 8. The routed experts see
    an (Ex, G·C, E) buffer, row g·C + c of expert e the token of group g
    ranked c among those routed to e; rows nobody fills stay zero.

    Params p: router (E, Ex); w_up/w_gate (Ex, E, F); w_down (Ex, F, E);
    shared_* optional fused shared-expert FFN.
    """
    b, s, e = x.shape
    t = b * s
    gsz = min(group_size, t)
    if t % gsz:
        gsz = t            # fall back to one group (tiny/odd shapes)
    g = t // gsz
    ex, k = cfg.num_experts, cfg.top_k
    xf = x.reshape(g, gsz, e)
    gates, mask, aux, top_idx = _route(xf, p["router"], cfg)  # (G,S,Ex)
    cap = _capacity(gsz, cfg)

    # rank of each token within its expert's per-group buffer, in token
    # order; kept below the capacity
    pos_in_e = torch.cumsum(mask, dim=1) - 1.0                 # (G,S,Ex)
    pos = torch.gather(pos_in_e, 2, top_idx).to(torch.long)    # (G,S,k)
    keep = pos < cap
    # flat row (e·G + g)·C + c of each kept pair; dropped pairs go to a
    # spare last row
    grp = torch.arange(g, device=x.device)[:, None, None]
    rows = ex * g * cap
    slot = torch.where(keep, (top_idx * g + grp) * cap + pos, rows)
    buf = x.new_zeros((rows + 1, e))
    buf[slot.reshape(-1)] = xf[:, :, None, :].expand(g, gsz, k, e
                                                     ).reshape(-1, e)
    xe = buf[:rows].view(ex, g * cap, e)
    # with one group, expert e's rows past its kept count are zero: the
    # kernel may skip them; and at most min(Ex, tokens · k) experts have
    # rows, known on the host (no sync)
    counts = (mask[0].sum(dim=0).clamp(max=cap).to(torch.int32)
              if g == 1 else None)
    live = min(ex, gsz * k) if g == 1 else None

    if ffn_type == "glu":
        up = _expert_mm(xe, p["w_up"], impl, counts, live)
        gt = _expert_mm(xe, p["w_gate"], impl, counts, live)
        h = _gelu(gt.to(torch.float32)).to(x.dtype) * up
    else:
        h = _gelu(_expert_mm(xe, p["w_up"], impl, counts, live)
                  .to(torch.float32)).to(x.dtype)
    ye = _expert_mm(h, p["w_down"], impl, counts, live)        # (Ex,GC,E)

    # combine: each token's kept experts' rows, weighted by its gates (in
    # x's dtype, as the JAX package's combine tensor), summed in f32
    w = torch.where(keep, torch.gather(gates, 2, top_idx), 0.0
                    ).to(x.dtype)
    picked = ye.reshape(rows, e)[torch.where(keep, slot, 0)]   # (G,S,k,E)
    out = (w.to(torch.float32)[..., None] * picked.to(torch.float32)
           ).sum(dim=-2).to(x.dtype)

    if "shared_up" in p:  # always-on shared expert(s), fused into one FFN
        out = out.reshape(t, e) + _shared(xf.reshape(t, e), p, act_bits,
                                          impl)
    return out.reshape(b, s, e), aux


def moe_decode(x: torch.Tensor, p, cfg: MoEConfig, ffn_type: str = "glu",
               act_bits=None, impl=None) -> torch.Tensor:
    """Decode-time MoE on dense expert weights: every expert computes
    every token (no capacity, no drops), weighted by the gates, which are
    zero for unselected experts."""
    b, s, e = x.shape
    t = b * s
    xf = x.reshape(t, e)
    gates, _, _ = router(xf, p["router"], cfg)
    if ffn_type == "glu":
        up = torch.einsum("td,edf->tef", xf, p["w_up"].to(x.dtype))
        gt = torch.einsum("td,edf->tef", xf, p["w_gate"].to(x.dtype))
        h = _gelu(gt.to(torch.float32)).to(x.dtype) * up
    else:
        h = _gelu(torch.einsum("td,edf->tef", xf, p["w_up"].to(x.dtype))
                  .to(torch.float32)).to(x.dtype)
    h = h * gates.to(x.dtype)[..., None]   # zero for unselected experts
    out = torch.einsum("tef,efd->td", h, p["w_down"].to(x.dtype))
    if "shared_up" in p:
        out = out + _shared(xf, p, act_bits, impl)
    return out.reshape(b, s, e)
