"""Fused multi-layer bit-plane GeMV — one launch for a whole concurrency
group (q/k/v, up/gate): port of the JAX package's
`kernels/bitplane_gemv/program.py`, around the CUDA kernel B2 (`group_kernel`
in `csrc/bitplane_gemv.cu`, the block body of B1 over a table of members).

The main path (`fused_group_linears`, `run_program`) describes each layer
of the group as a member of a `GroupTable`: its own leaf planes, read in
place, its own tile scales, blocking (bn from `_pick_blocks`), q, p and
zero points, and its own column range of one (B, ΣM) output. The table is
static per group and cached by `MVDRAMEngine.packed_group` (a q/k/v or
up/gate group) or by `GemvProgram.kernel_table` (a whole decode block of a
compiled program, `GemvProgram.run_kernel`); a call quantizes the input
once, pads the codes to the widest member and launches once. A table of at
most `kernel.MAX_MEMBERS` members is a by-value kernel parameter; a longer
one lies in device memory, uploaded once, and each launch rewrites only
its members' codes and output pointers there. Each member's result is
integer-identical to the per-leaf path (`ops.bitplane_gemv_bitserial`),
and its f32 epilogue runs in the same tile order, so the outputs are
bitwise equal.

The JAX module's slot-major API stays as its port: `build_plan`,
`pack_weights`, `pack_codes`, `pack_params`, `gather_outputs` and the
slot-major `program_gemv`, whose layers' tiles are padded up to the group's
(BN, BM) envelope with exactness-preserving values (zero plane bits, codes
padded with the layer's z_a, the epilogue's `+ BN·z_a·z_w` on the padded BN;
fully padded cells carry z_a = z_w = 0, zero codes and zero scales). On the
card it runs the same kernel, each slot a member described by strides.
"""
from __future__ import annotations

import ctypes
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

#: launches of the fused CUDA kernel (its plain version counts in
#: ref.CALLS); `program_gemv_fold` the second launch of a call whose
#: reduction is split over blocks
LAUNCHES = {"program_gemv": 0, "program_gemv_fold": 0}


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
# the member table: each layer of a group read in place from its own leaf
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MemberTiles:
    """Static geometry of one member of a group launch: its blocking, bits
    and zero points, and where its columns lie in the group's (B, ΣM)
    output and its strips in the launch's grid."""

    m: int          # output columns
    q: int          # weight bits
    p: int          # activation bits
    z_a: int        # activation zero point
    z_w: int        # weight zero point
    bn: int         # this layer's own reduction block
    tiles: int      # reduction tiles; the codes are read to tiles·bn
    col: int        # first column in the group's output
    strip0: int     # first 128-column strip of the launch's grid

    @property
    def n_pad(self) -> int:
        return self.tiles * self.bn

    @property
    def strips(self) -> int:
        return -(-self.m // bp_kernel.STRIP)


def member_tiles(plan: ProgramKernelPlan) -> tuple:
    """The members of a plan's layers, in layer order, their columns and
    strips laid end to end."""
    out, col, strip = [], 0, 0
    for L in plan.layers:
        out.append(MemberTiles(m=L.m, q=L.q, p=L.p, z_a=L.z_a, z_w=L.z_w,
                               bn=L.bn, tiles=L.n_tiles, col=col,
                               strip0=strip))
        col += L.m
        strip += out[-1].strips
    return tuple(out)


def tile_scales(bw, bn: int, tiles: int) -> torch.Tensor:
    """A leaf's (tiles, M) per-tile scales, as `ops._expand_scales` gives
    them, copied only where the leaf's own cannot serve: per-channel scales
    (one row) as a stride-0 view, per-group scales with one group a tile as
    they are. No tile starts past the leaf's rows in either case, so no row
    is zeroed."""
    g, m = bw.scale.shape
    if g == 1:
        return bw.scale.expand(tiles, m)
    if g == tiles and bw.n == g * bn:
        return bw.scale
    return bp_ops._expand_scales(bw, bn, tiles * bn).contiguous()


@dataclasses.dataclass(frozen=True, eq=False)
class GroupTable:
    """A group's static launch description, built once per group: its
    members and the tensors they read in place (each leaf's planes and tile
    scales). `owned_bytes` is the device memory it holds beyond the
    leaves': the tile scales it had to copy."""

    members: tuple      # MemberTiles per layer
    planes: tuple       # each member's (q, W, M) int32 leaf planes
    scales: tuple       # each member's (tiles, M) f32 tile scales
    owned_bytes: int
    _ctable: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def cols(self) -> int:
        return sum(M.m for M in self.members)

    @property
    def strips(self) -> int:
        return sum(M.strips for M in self.members)

    @property
    def tiles_max(self) -> int:
        return max(M.tiles for M in self.members)

    @property
    def q_max(self) -> int:
        return max(M.q for M in self.members)

    def split(self, b: int, sms: int) -> tuple:
        """(tiles_per_block, splits): `kernel.split_plan` over the group's
        strips and its longest reduction; a member of fewer tiles leaves
        the blocks of its later splits idle."""
        return bp_kernel.split_plan(self.tiles_max,
                                    self.strips * bp_kernel.STRIP, b, sms)

    def workspace_shape(self, b: int, splits: int) -> tuple:
        """Each tile's int32 correction for the fold, (tiles, B, ΣM), or
        nothing with one split."""
        return (0,) if splits == 1 else (self.tiles_max, b, self.cols)

    def members_c(self) -> "ctypes.Array":
        """Every member as the kernel's `Member`, its static fields set
        (its per-call fields, `a`, `a_row` and `out`, are 0), built on
        first use."""
        arr = self._ctable.get("members")
        if arr is None:
            arr = (bp_kernel.Member * len(self.members))()
            for e, M, pl, sc in zip(arr, self.members, self.planes,
                                    self.scales):
                e.planes, e.scales = pl.data_ptr(), sc.data_ptr()
                e.a_tile = M.bn
                e.plane_stride, e.word_stride = pl.stride(0), pl.stride(1)
                e.tile_stride = M.bn // 32 * pl.stride(1)
                e.scale_stride, e.out_row = sc.stride(0), self.cols
                e.col, e.m, e.words = M.col, M.m, pl.shape[1]
                e.tiles, e.bn, e.q, e.mask = M.tiles, M.bn, M.q, (1 << M.p) - 1
                e.z_a, e.zero, e.strip0 = M.z_a, M.z_w, M.strip0
                e.vec = int(M.m % 4 == 0 and pl.data_ptr() % 16 == 0)
            self._ctable["members"] = arr
        return arr

    def ctable(self) -> "bp_kernel.Table":
        """The by-value kernel table (at most `kernel.MAX_MEMBERS`
        members) with every static field set, built on first use; a launch
        fills in its codes and output pointers (the kernel parameter is
        copied at the launch, so the next launch may overwrite them)."""
        tab = self._ctable.get("table")
        if tab is None:
            if len(self.members) > bp_kernel.MAX_MEMBERS:
                raise ValueError(
                    f"program_gemv: {len(self.members)} members, a by-value "
                    f"table holds {bp_kernel.MAX_MEMBERS}")
            tab = bp_kernel.Table()
            tab.n = len(self.members)
            for i, e in enumerate(self.members_c()):
                tab.m[i] = e
            self._ctable["table"] = tab
        return tab

    def device_table(self, device) -> torch.Tensor:
        """The members in device memory, for a launch of more members than
        a by-value table holds: uploaded once, static fields and all; each
        launch then rewrites only the per-call fields (`call_fields`)."""
        key = ("device", str(device))
        gtab = self._ctable.get(key)
        if gtab is None:
            gtab = torch.frombuffer(bytearray(self.members_c()),
                                    dtype=torch.uint8).to(device)
            self._ctable[key] = gtab
        return gtab

    def call_fields(self, codes: Sequence[torch.Tensor],
                    out: torch.Tensor) -> np.ndarray:
        """(n, 5) int64: the fields of each member that a launch sets —
        `a`, `planes`, `scales`, `out`, `a_row`, the first five 8-byte
        fields of the kernel's `Member` in its order — for codes[l] and the
        group's (B, ΣM) f32 output."""
        rows = np.empty((len(self.members), 5), np.int64)
        for row, c, pl, sc, M in zip(rows, codes, self.planes, self.scales,
                                     self.members):
            row[:] = (c.data_ptr(), pl.data_ptr(), sc.data_ptr(),
                      out.data_ptr() + 4 * M.col, c.stride(0))
        return rows


def member_table(plan: ProgramKernelPlan, leaves: Sequence) -> GroupTable:
    """The member table of a plan's layers (`leaves[l]`: BitplaneWeights)."""
    members = member_tiles(plan)
    scales = tuple(tile_scales(bw, M.bn, M.tiles)
                   for M, bw in zip(members, leaves))
    owned = sum(s.numel() * s.element_size()
                for s, bw in zip(scales, leaves)
                if s.data_ptr() != bw.scale.data_ptr())
    return GroupTable(members=members,
                      planes=tuple(bw.planes for bw in leaves),
                      scales=scales, owned_bytes=owned)


def _check_group(table: GroupTable, codes: Sequence[torch.Tensor]) -> int:
    if len(codes) != len(table.members):
        raise ValueError(f"program_gemv: {len(codes)} code tensors for "
                         f"{len(table.members)} members")
    b = codes[0].shape[0]
    for c, M in zip(codes, table.members):
        if (c.dtype != torch.uint8 or c.ndim != 2 or c.shape[0] != b
                or c.shape[1] < M.n_pad or c.stride(1) != 1):
            raise ValueError(
                f"program_gemv: codes must be uint8 (B, >= {M.n_pad}) rows "
                f"of unit stride, all of B = {b}; got {c.dtype} "
                f"{tuple(c.shape)} strides {c.stride()}")
    return b


def group_gemv(table: GroupTable, codes: Sequence[torch.Tensor], *,
               fidelity: str = "code") -> torch.Tensor:
    """ONE launch for the whole group. codes[l]: member l's (B, >= n_pad_l)
    uint8 p-bit codes padded with its z_a (members that share an input pass
    the same tensor) → (B, ΣM) f32 un-activation-scaled, member l in
    columns [col_l, col_l + m_l). CUDA tensors go to the kernel B2, CPU
    tensors to its plain version; the kernel always runs the bit-serial
    schedule, which gives the integers of either fidelity."""
    if fidelity not in ("code", "bitserial"):
        raise ValueError(
            f"fidelity must be 'code' or 'bitserial', got {fidelity!r}")
    b = _check_group(table, codes)
    if not codes[0].is_cuda:
        return ref.group_gemv_ref(codes, table.planes, table.scales,
                                  table.members, table.cols,
                                  fidelity=fidelity)
    dev = codes[0].device
    for c, pl, sc, M in zip(codes, table.planes, table.scales,
                            table.members):
        if c.device != dev or pl.device != dev or sc.device != dev:
            raise ValueError(f"program_gemv: codes, planes and scales must "
                             f"all be on {dev}")
        if pl.dtype != torch.int32 or not pl.is_contiguous() \
                or sc.dtype != torch.float32 or sc.stride(-1) != 1:
            raise ValueError("program_gemv: planes must be contiguous "
                             "int32, scales f32 rows of unit stride")
        if M.bn % 32 or not 32 <= M.bn <= bp_kernel.MAX_BN \
                or not 1 <= max(M.q, M.p) <= bp_kernel.MAX_BITS:
            raise ValueError(f"program_gemv: bn={M.bn}, q={M.q}, p={M.p} "
                             f"outside what the kernel takes")
    tpb, splits = table.split(b, bp_kernel._sms(dev))
    out = torch.empty((b, table.cols), dtype=torch.float32, device=dev)
    ws = torch.empty(table.workspace_shape(b, splits), dtype=torch.int32,
                     device=dev)
    lib = build.library("bitplane_gemv")
    n = len(table.members)
    if n <= bp_kernel.MAX_MEMBERS:
        tab = table.ctable()
        for i, (c, M) in enumerate(zip(codes, table.members)):
            e = tab.m[i]
            e.a, e.a_row = c.data_ptr(), c.stride(0)
            e.out = out.data_ptr() + 4 * M.col
        by_value, gtab = ctypes.addressof(tab), None
    else:
        # a whole decode block: the table in device memory, this call's
        # fields written into it on the launch's stream
        gtab = table.device_table(dev).data_ptr()
        rows = table.call_fields(codes, out)
        build.check(lib.gemv_table_pointers(
            gtab, rows.ctypes.data, n, bp_kernel._stream()),
            "program_gemv (member table)")
        by_value = None
    LAUNCHES["program_gemv"] += 1
    LAUNCHES["program_gemv_fold"] += int(splits > 1)
    build.check(lib.gemv_group_launch(
        by_value, gtab, n, table.strips,
        ws.data_ptr() if splits > 1 else None, table.cols, b, table.q_max,
        tpb, splits, bp_kernel._stream()), "program_gemv")
    return out


# ---------------------------------------------------------------------------
# the slot-major entry (the JAX module's layout)
# ---------------------------------------------------------------------------

def _slot_members(plan: ProgramKernelPlan, codes_t, planes_t, scale_t,
                  out) -> "ctypes.Array":
    """Each slot of the envelope as a member: its layer's live tiles, the
    envelope's BN as bn, strides over the slot-major blocks."""
    s, nt, b, bn = codes_t.shape
    bm, wpt, q_max = plan.bm_max, bn // 32, plan.q_max
    members = (bp_kernel.Member * s)()
    for k, l in enumerate(plan.slot_layer):
        L, e = plan.layers[l], members[k]
        e.a = codes_t.data_ptr() + k * nt * b * bn
        e.planes = planes_t.data_ptr() + 4 * k * nt * q_max * wpt * bm
        e.scales = scale_t.data_ptr() + 4 * k * nt * bm
        e.out = out.data_ptr() + 4 * k * b * bm
        e.a_row, e.a_tile = bn, b * bn
        e.plane_stride, e.tile_stride = wpt * bm, q_max * wpt * bm
        e.word_stride = e.scale_stride = e.out_row = e.m = bm
        e.col, e.strip0 = k * bm, k * bm // bp_kernel.STRIP
        e.words, e.tiles, e.bn = L.n_tiles * wpt, L.n_tiles, bn
        e.q, e.mask, e.z_a, e.zero = L.q, (1 << plan.p_max) - 1, L.z_a, L.z_w
        e.vec = 1
    return members


def program_gemv(plan: ProgramKernelPlan, codes_t, planes_t, scale_t,
                 params_t, *, fidelity: str = "code") -> torch.Tensor:
    """The slot-major entry: ONE launch for the whole plan → (S, B, BM) f32
    un-activation-scaled outputs, gathered per layer by `gather_outputs`.
    CUDA tensors go to the kernel B2, each slot a member whose z_a and z_w
    are its layer's (`pack_params` gives the same, and zeros on the fully
    padded tiles, which the kernel skips: their scales are zero); CPU
    tensors to its plain version. The slots' table lies in device memory
    (it outgrows a kernel parameter)."""
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
            bp_kernel.MAX_BITS or planes_t.data_ptr() % 16:
        raise ValueError(f"program_gemv: envelope BN={plan.bn_max}, "
                         f"q={plan.q_max}, p={plan.p_max} exceeds the kernel")
    out = torch.empty((s, b, plan.bm_max), dtype=torch.float32,
                      device=codes_t.device)
    cols = s * plan.bm_max
    tiles = max(L.n_tiles for L in plan.layers)
    tpb, splits = bp_kernel.split_plan(tiles, cols, b,
                                       bp_kernel._sms(codes_t.device))
    ws = torch.empty((tiles, b, cols) if splits > 1 else (0,),
                     dtype=torch.int32, device=codes_t.device)
    members = _slot_members(plan, codes_t, planes_t, scale_t, out)
    gtab = torch.frombuffer(members, dtype=torch.uint8).to(codes_t.device)
    lib = build.library("bitplane_gemv")
    LAUNCHES["program_gemv"] += 1
    LAUNCHES["program_gemv_fold"] += int(splits > 1)
    build.check(lib.gemv_group_launch(
        None, gtab.data_ptr(), s, cols // bp_kernel.STRIP,
        ws.data_ptr() if splits > 1 else None, cols, b, plan.q_max, tpb,
        splits, bp_kernel._stream()), "program_gemv")
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


def pack_group(plan: ProgramKernelPlan, leaves: Sequence, device) -> tuple:
    """(planes_t, scale_t, params_t) of a plan in the slot-major layout,
    ready for the slot-major `program_gemv`."""
    planes_t, scale_t = pack_weights(plan, tuple(leaves))
    params_t = torch.from_numpy(pack_params(plan)).to(device)
    return planes_t, scale_t, params_t


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


def block_codes(table: GroupTable, xs: Sequence[torch.Tensor],
                specs: Sequence[QuantSpec]) -> tuple:
    """What one launch over `table` reads: quantize each member's (B, n_l)
    activations (`_quantize_batched`), pad each bucket's codes once with its
    z_a to its widest member. Returns (codes per member, views into the
    padded buckets; activation scales per member)."""
    codes, scales, layout = _quantize_batched(xs, specs)
    width, z_a = [0] * len(codes), [0] * len(codes)
    for M, (bi, _s, _b) in zip(table.members, layout):
        width[bi], z_a[bi] = max(width[bi], M.n_pad), M.z_a
    padded = [torch.nn.functional.pad(c, (0, w - c.shape[1]), value=z)
              for c, w, z in zip(codes, width, z_a)]
    return ([padded[bi][s:s + b] for bi, s, b in layout],
            [scales[bi][s:s + b] for bi, s, b in layout])


def run_program(plan: ProgramKernelPlan, leaves: Sequence,
                xs: Sequence[torch.Tensor], specs: Sequence[QuantSpec], *,
                fidelity: str = "code", table: Optional[GroupTable] = None
                ) -> tuple:
    """Quantize each layer's (B, n_l) activations, execute the whole plan
    as ONE launch over its member table, return per-layer (B, m_l) f32
    outputs — bitwise the per-leaf `bitplane_gemv_bitserial` calls'.

    `table` is the plan's `member_table` — the weights are static, so
    callers that run many steps build it once."""
    if table is None:
        table = member_table(plan, leaves)
    codes, scales = block_codes(table, xs, specs)
    out = group_gemv(table, codes, fidelity=fidelity)
    return tuple(out[:, M.col:M.col + M.m] * sc
                 for M, sc in zip(table.members, scales))


def group_plan(ws: Sequence, act_bits: int) -> ProgramKernelPlan:
    """The plan `fused_group_linears` runs a group of leaves under."""
    return plan_from_weights(tuple(ws), QuantSpec(bits=act_bits),
                             groups=(tuple(range(len(ws))),))


def group_table(ws: Sequence, act_bits: int) -> GroupTable:
    """The member table `fused_group_linears` launches a group with."""
    return member_table(group_plan(ws, act_bits), ws)


def fused_group_linears(x: torch.Tensor, ws: Sequence, act_bits: int, *,
                        fidelity: str = "code",
                        table: Optional[GroupTable] = None) -> tuple:
    """k independent linears sharing ONE input (q/k/v, up/gate) as one
    launch. The input is quantized once — bitwise the same as quantizing
    per leaf — and padded once, to the widest member's blocks."""
    spec = QuantSpec(bits=act_bits)
    plan = group_plan(ws, act_bits)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    outs = run_program(plan, tuple(ws), (x2,) * len(ws),
                       (spec,) * len(ws), fidelity=fidelity, table=table)
    return tuple(o.reshape(*lead, bw.m) for o, bw in zip(outs, ws))
