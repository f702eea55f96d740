"""Fused multi-layer bit-plane GeMV — one launch for a whole concurrency
group (q/k/v, up/gate): port of the JAX package's
`kernels/bitplane_gemv/program.py`, around the CUDA kernel B2
(`csrc/program_gemv.cu`).

Each layer keeps its own blocking (bn_l, bm_l) from `_pick_blocks`, and its
tiles are padded up to the group's (BN, BM) envelope with exactness-
preserving values — zero plane bits, codes padded with the layer's z_a, and
the epilogue's `+ BN·z_a·z_w` term on the padded BN — so the padded rows
cancel algebraically and the fused result is integer-identical to the
per-leaf path (`ops.bitplane_gemv_bitserial`). Fully padded grid cells
carry z_a = z_w = 0, zero codes and zero scales and contribute exactly 0.

The weights are packed into the slot-major layout once per group and
reused on every call (`fused_group_linears(..., packed=)`); the per-call
work is the activation side only.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ...core.quant import QuantSpec, quantize_activations
from .. import build
from . import kernel as bp_kernel
from . import ops as bp_ops
from . import ref

#: launches of the fused CUDA kernel (its plain version counts in ref.CALLS)
LAUNCHES = {"program_gemv": 0}


def static_zero(spec: QuantSpec) -> int:
    """The static zero point `quantize_activations` bakes into codes."""
    return spec.zero_point if spec.symmetric else spec.levels // 2


@dataclasses.dataclass(frozen=True)
class LayerTiles:
    """Static per-layer tiling of one program member."""

    n: int          # reduction dim
    m: int          # output dim
    q: int          # weight bits
    g: int          # weight scale groups
    z_w: int        # weight zero point
    p: int          # activation bits
    z_a: int        # activation zero point
    bn: int         # this layer's own reduction block
    bm: int         # this layer's own output block
    n_tiles: int
    m_tiles: int


@dataclasses.dataclass(frozen=True)
class ProgramKernelPlan:
    """The fused launch's static geometry — a pure function of the layer
    shapes and the concurrency groups."""

    layers: tuple                # LayerTiles per program layer
    groups: tuple                # concurrency groups, indices into layers
    slot_layer: tuple            # (S,) layer index per m-slot
    slot_mtile: tuple            # (S,) that layer's m-tile index
    bn_max: int                  # padded reduction-block envelope BN
    bm_max: int                  # padded output-block envelope BM
    nt_max: int                  # reduction tiles per slot NT
    q_max: int
    p_max: int

    @property
    def slots(self) -> int:
        return len(self.slot_layer)


@functools.lru_cache(maxsize=512)
def build_plan(metas: tuple, groups: Optional[tuple] = None
               ) -> ProgramKernelPlan:
    """metas: tuple of (n, m, q, g, z_w, p, z_a) per layer. Slots walk the
    concurrency groups in order, round-robin across each group's
    members."""
    layers = []
    for n, m, q, g, z_w, p, z_a in metas:
        bn, bm = bp_ops._pick_blocks(n, m, None, None,
                                     n // g if g > 1 else None)
        layers.append(LayerTiles(
            n=n, m=m, q=q, g=g, z_w=z_w, p=p, z_a=z_a, bn=bn, bm=bm,
            n_tiles=-(-n // bn), m_tiles=-(-m // bm)))
    if groups is None:
        groups = tuple((i,) for i in range(len(layers)))
    slot_layer, slot_mtile = [], []
    for grp in groups:
        for r in range(max(layers[l].m_tiles for l in grp)):
            for l in grp:
                if r < layers[l].m_tiles:
                    slot_layer.append(l)
                    slot_mtile.append(r)
    return ProgramKernelPlan(
        layers=tuple(layers), groups=tuple(tuple(g) for g in groups),
        slot_layer=tuple(slot_layer), slot_mtile=tuple(slot_mtile),
        bn_max=max(L.bn for L in layers), bm_max=max(L.bm for L in layers),
        nt_max=max(L.n_tiles for L in layers),
        q_max=max(L.q for L in layers), p_max=max(L.p for L in layers))


def plan_from_weights(ws: Sequence, a_spec: QuantSpec,
                      groups: Optional[tuple] = None) -> ProgramKernelPlan:
    """Plan for a group of `BitplaneWeights` sharing one activation spec."""
    z_a = static_zero(a_spec)
    metas = tuple((bw.n, bw.m, bw.bits, bw.scale.shape[0], bw.zero,
                   a_spec.bits, z_a) for bw in ws)
    return build_plan(metas, groups)


# ---------------------------------------------------------------------------
# slot-major packing: every (slot, reduction tile) cell gets a fixed-size
# block, padded to the envelope
# ---------------------------------------------------------------------------

def _pad_to(x: torch.Tensor, shape: tuple, value=0) -> torch.Tensor:
    widths = []
    for have, want in zip(reversed(x.shape), reversed(shape)):
        widths += [0, want - have]
    return torch.nn.functional.pad(x, widths, value=value)


def pack_weights(plan: ProgramKernelPlan, leaves: Sequence):
    """leaves[l]: BitplaneWeights → planes_t (S, NT, q_max, BN//32, BM)
    int32 and scale_t (S, NT, 1, BM) f32. Pad bits and scales are zero;
    scale rows past a layer's true reduction length are zeroed by
    `_expand_scales`, so padded cells contribute nothing."""
    wb = plan.bn_max // 32
    blocks, scales = [], []
    for L, bw in zip(plan.layers, leaves):
        wl = L.bn // 32
        planes = bp_ops._pad_axis(bw.planes, wl, 1)
        planes = bp_ops._pad_axis(planes, L.bm, 2)
        planes = planes.reshape(L.q, L.n_tiles, wl, L.m_tiles, L.bm)
        planes = planes.permute(3, 1, 0, 2, 4)      # (MT, NT, q, wl, bm)
        blocks.append(_pad_to(planes, (L.m_tiles, plan.nt_max, plan.q_max,
                                       wb, plan.bm_max)))
        scale = bp_ops._pad_axis(
            bp_ops._expand_scales(bw, L.bn, L.n_tiles * L.bn), L.bm, 1)
        scale = scale.reshape(L.n_tiles, L.m_tiles, L.bm).permute(1, 0, 2)
        scales.append(_pad_to(scale, (L.m_tiles, plan.nt_max,
                                      plan.bm_max))[:, :, None, :])
    planes_t = torch.stack([blocks[l][r] for l, r
                            in zip(plan.slot_layer, plan.slot_mtile)])
    scale_t = torch.stack([scales[l][r] for l, r
                           in zip(plan.slot_layer, plan.slot_mtile)])
    return planes_t.contiguous(), scale_t.contiguous()


def pack_codes(plan: ProgramKernelPlan, codes: Sequence[torch.Tensor]
               ) -> torch.Tensor:
    """codes[l]: (B, n_l) uint8 → (S, NT, B, BN), padded with each layer's
    z_a inside its live tiles and with 0 on fully-padded grid steps."""
    per_layer = []
    for L, c in zip(plan.layers, codes):
        b = c.shape[0]
        c = bp_ops._pad_axis(c, L.bn, 1, value=L.z_a)
        tiles = c.reshape(b, L.n_tiles, L.bn).permute(1, 0, 2)
        tiles = _pad_to(tiles, (L.n_tiles, b, plan.bn_max), value=L.z_a)
        per_layer.append(_pad_to(tiles, (plan.nt_max, b, plan.bn_max)))
    # a host-side list of views, not a device index tensor: building one
    # would be a synchronous host-to-device copy on every call
    return torch.stack([per_layer[l] for l in plan.slot_layer])


@functools.lru_cache(maxsize=512)
def pack_params(plan: ProgramKernelPlan) -> np.ndarray:
    """(S, NT, 4) int32 [z_a, z_w, valid, layer] — zeros on fully-padded
    steps so their epilogue terms vanish exactly."""
    out = np.zeros((plan.slots, plan.nt_max, 4), np.int32)
    for s, (l, _r) in enumerate(zip(plan.slot_layer, plan.slot_mtile)):
        L = plan.layers[l]
        for nt in range(L.n_tiles):
            out[s, nt] = (L.z_a, L.z_w, 1, l)
        out[s, L.n_tiles:, 3] = l
    return out


# ---------------------------------------------------------------------------
# the fused kernel
# ---------------------------------------------------------------------------

def program_gemv(plan: ProgramKernelPlan, codes_t, planes_t, scale_t,
                 params_t, *, fidelity: str = "code") -> torch.Tensor:
    """ONE launch for the whole group → (S, B, BM) f32 un-activation-scaled
    outputs, gathered per layer by `gather_outputs`. CUDA tensors go to the
    kernel B2; CPU tensors to its plain version. The kernel always runs the
    bit-serial schedule, which gives the integers of either fidelity."""
    if fidelity not in ("code", "bitserial"):
        raise ValueError(
            f"fidelity must be 'code' or 'bitserial', got {fidelity!r}")
    s, nt, b, bn = codes_t.shape
    kw = dict(q_max=plan.q_max, p_max=plan.p_max, bn=plan.bn_max)
    if not codes_t.is_cuda:
        return ref.program_gemv_ref(codes_t, planes_t, scale_t, params_t,
                                    **kw)
    want = {"codes": (codes_t, torch.uint8, (s, nt, b, plan.bn_max)),
            "planes": (planes_t, torch.int32,
                       (s, nt, plan.q_max, plan.bn_max // 32, plan.bm_max)),
            "scales": (scale_t, torch.float32, (s, nt, 1, plan.bm_max)),
            "params": (params_t, torch.int32, (s, nt, 4))}
    for name, (t, dt, shape) in want.items():
        if (t.device != codes_t.device or t.dtype != dt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"program_gemv: {name} must be a contiguous {dt} {shape} on "
                f"{codes_t.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if plan.bn_max > bp_kernel.MAX_BN or max(plan.q_max, plan.p_max) > \
            bp_kernel.MAX_BITS:
        raise ValueError(f"program_gemv: envelope BN={plan.bn_max}, "
                         f"q={plan.q_max}, p={plan.p_max} exceeds the kernel")
    out = torch.empty((s, b, plan.bm_max), dtype=torch.float32,
                      device=codes_t.device)
    lib = build.library("program_gemv")
    LAUNCHES["program_gemv"] += 1
    build.check(lib.program_gemv_launch(
        params_t.data_ptr(), codes_t.data_ptr(), planes_t.data_ptr(),
        scale_t.data_ptr(), out.data_ptr(), s, nt, b, plan.bn_max,
        plan.bm_max, plan.q_max, plan.p_max, bp_kernel._stream()),
        "program_gemv")
    return out


def gather_outputs(plan: ProgramKernelPlan, out: torch.Tensor) -> list:
    """(S, B, BM) slot outputs → per-layer (B, m_l), un-activation-scaled.
    Each slot's reduction tiles were folded in ascending order, so each
    layer's accumulation order matches the per-leaf kernel's."""
    slot_of = {(l, r): s for s, (l, r)
               in enumerate(zip(plan.slot_layer, plan.slot_mtile))}
    outs = []
    for l, L in enumerate(plan.layers):
        parts = [out[slot_of[(l, r)], :, :L.bm] for r in range(L.m_tiles)]
        outs.append(torch.cat(parts, dim=-1)[:, :L.m])
    return outs


# ---------------------------------------------------------------------------
# whole-group entry points
# ---------------------------------------------------------------------------

def _quantize_batched(xs: Sequence[torch.Tensor],
                      specs: Sequence[QuantSpec]) -> tuple:
    """Quantize every layer's activations, batching same-(shape, spec)
    layers into one `quantize_activations` call. Per-row quantization is
    rowwise independent, so stacking gives bitwise the same codes and
    scales; layers handing in the SAME tensor object share one
    quantization outright.

    Returns `(stacked_codes, stacked_scales, layout)` with one codes/scales
    tensor per bucket and a per-layer `(bucket, row_start, b)` triple."""
    buckets: dict = {}
    raw: list = [None] * len(xs)
    for i, (x, spec) in enumerate(zip(xs, specs)):
        key = (tuple(x.shape), spec)
        grp = buckets.setdefault(key, {"xs": [], "ids": {}})
        off = grp["ids"].get(id(x))
        if off is None:
            off = len(grp["xs"])
            grp["ids"][id(x)] = off
            grp["xs"].append(x)
        raw[i] = (key, off * x.shape[0], x.shape[0])
    order = list(buckets)
    codes, scales = [], []
    for key in order:
        (_shape, spec), grp = key, buckets[key]["xs"]
        stacked = grp[0] if len(grp) == 1 else torch.cat(grp, dim=0)
        aq = quantize_activations(stacked, spec)
        codes.append(aq.values)
        scales.append(aq.scale)
    layout = tuple((order.index(key), s, b) for key, s, b in raw)
    return tuple(codes), tuple(scales), layout


def run_program(plan: ProgramKernelPlan, leaves: Sequence,
                xs: Sequence[torch.Tensor], specs: Sequence[QuantSpec], *,
                fidelity: str = "code", packed: Optional[tuple] = None
                ) -> tuple:
    """Quantize each layer's (B, n_l) activations, execute the whole group
    as ONE fused launch, return per-layer (B, m_l) f32 outputs —
    integer-identical to per-leaf `bitplane_gemv_bitserial` calls.

    `packed` is `(planes_t, scale_t, params_t)` from `pack_group` — the
    weights are static, so callers that run many steps pack them once."""
    if packed is None:
        packed = pack_group(plan, leaves, xs[0].device)
    planes_t, scale_t, params_t = packed
    codes, scales, layout = _quantize_batched(xs, specs)
    codes_t = pack_codes(plan, [codes[bi][s:s + b] for bi, s, b in layout])
    out = program_gemv(plan, codes_t, planes_t, scale_t, params_t,
                       fidelity=fidelity)
    outs = gather_outputs(plan, out)
    return tuple(o * scales[bi][s:s + b]
                 for o, (bi, s, b) in zip(outs, layout))


def pack_group(plan: ProgramKernelPlan, leaves: Sequence, device) -> tuple:
    """(planes_t, scale_t, params_t) of a group, ready for `run_program`."""
    planes_t, scale_t = pack_weights(plan, tuple(leaves))
    params_t = torch.from_numpy(pack_params(plan)).to(device)
    return planes_t, scale_t, params_t


def group_plan(ws: Sequence, act_bits: int) -> ProgramKernelPlan:
    """The plan `fused_group_linears` runs a group of leaves under."""
    return plan_from_weights(tuple(ws), QuantSpec(bits=act_bits),
                             groups=(tuple(range(len(ws))),))


def fused_group_linears(x: torch.Tensor, ws: Sequence, act_bits: int, *,
                        fidelity: str = "code",
                        packed: Optional[tuple] = None) -> tuple:
    """k independent linears sharing ONE input (q/k/v, up/gate) as one
    launch. The input is quantized once — bitwise the same as quantizing
    per leaf."""
    spec = QuantSpec(bits=act_bits)
    plan = group_plan(ws, act_bits)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    outs = run_program(plan, tuple(ws), (x2,) * len(ws),
                       (spec,) * len(ws), fidelity=fidelity, packed=packed)
    return tuple(o.reshape(*lead, bw.m) for o, bw in zip(outs, ws))
