"""Host side of B2's member table (`kernels/bitplane_gemv/program.py`) and
of B5's redesign (`kernels/quant_matmul/kernel.py`), on the CPU.

B2 launches B1's block body over a table of members, each a leaf read in
place. These tests hold the table's geometry (strip-to-member mapping,
column offsets, the split plan over the group's strips at the H100's 132
SMs, workspace shapes), the tile scales it reads without a copy, and its
plain version, bitwise against per-leaf `gemv_bs_ref` and against the JAX
package's fused launch in interpret mode.

B5 now runs B3's blocking: the tests replay its conversion of a code to
c − zero by the 2^23 magic number, exactly, for every code and zero point,
and its work items, split plan and fold order in float32 against the plain
version. The kernels themselves run only on the card
(`tests/test_torch_cuda.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbp
from repro.core import quant as jq
from repro.kernels.bitplane_gemv import program as jprog
from repro_torch import convert
from repro_torch.core import quant as tq
from repro_torch.core.bitplane import make_bitplane_weights
from repro_torch.kernels.bitplane_gemv import kernel as bkernel
from repro_torch.kernels.bitplane_gemv import ops as tops
from repro_torch.kernels.bitplane_gemv import program as tprog
from repro_torch.kernels.bitplane_gemv import ref as tref
from repro_torch.kernels.quant_matmul import kernel as qkernel
from repro_torch.kernels.quant_matmul import ops as qops
from repro_torch.kernels.quant_matmul import ref as qref
from test_torch_model import fresh_jax_caches  # noqa: F401

H100_SMS = 132   # SMs of an H100 SXM, the card the plan is written for


def _metas(cfgs):
    """(n, m, q, g, z_w, p, z_a) per (n, m, q, p, groups) member; z_w and
    z_a the symmetric zero points of q and p bits."""
    return tuple((n, m, q, g, 1 << (q - 1), p, 1 << (p - 1))
                 for n, m, q, p, g in cfgs)


def _geometry(cfgs) -> tprog.GroupTable:
    """A table with the members' geometry only (no tensors)."""
    plan = tprog.build_plan(_metas(cfgs))
    return tprog.GroupTable(members=tprog.member_tiles(plan), planes=(),
                            scales=(), owned_bytes=0)


# (name, members (n, m, q, p, groups), B, members' first columns, first
# strips, split plan, workspace shape)
GEOMETRY = [
    ("q/k/v", [(4096, 4096, 2, 4, 1)] * 3, 4, (0, 4096, 8192), (0, 32, 64),
     (1, 8), (8, 4, 12288)),
    ("q/k/v prefill", [(4096, 4096, 2, 4, 1)] * 3, 64, (0, 4096, 8192),
     (0, 32, 64), (8, 1), (0,)),
    ("up/gate", [(4096, 11008, 2, 4, 1)] * 2, 4, (0, 11008), (0, 86),
     (2, 4), (8, 4, 22016)),
    ("up/gate prefill", [(4096, 11008, 2, 4, 1)] * 2, 64, (0, 11008),
     (0, 86), (8, 1), (0,)),
    ("mixed q/p, ragged M", [(300, 90, 2, 2, 1), (300, 90, 3, 3, 1),
                             (300, 90, 4, 2, 1), (160, 40, 5, 4, 1)], 3,
     (0, 90, 180, 270), (0, 1, 2, 3), (1, 2), (2, 3, 310)),
    ("grouped, ragged M", [(320, 200, 2, 2, 2), (480, 130, 4, 3, 3),
                           (512, 256, 4, 2, 1)], 2, (0, 200, 330),
     (0, 2, 4), (1, 3), (3, 2, 586)),
]


@pytest.mark.parametrize("name,cfgs,b,cols,strip0,split,ws",
                         GEOMETRY, ids=[g[0] for g in GEOMETRY])
def test_member_table_geometry(name, cfgs, b, cols, strip0, split, ws):
    table = _geometry(cfgs)
    assert tuple(M.col for M in table.members) == cols
    assert tuple(M.strip0 for M in table.members) == strip0
    assert table.cols == sum(m for _n, m, *_ in cfgs)
    assert table.strips == sum(-(-m // bkernel.STRIP) for _n, m, *_ in cfgs)
    assert table.split(b, H100_SMS) == split
    assert table.workspace_shape(b, split[1]) == ws
    # each grid strip belongs to the member the kernel picks (the last
    # whose first strip is at or before it), and its columns to the
    # member's own columns
    for x in range(table.strips):
        mine = [i for i, M in enumerate(table.members) if M.strip0 <= x][-1]
        M = table.members[mine]
        assert M.strip0 <= x < M.strip0 + M.strips
        c0 = (x - M.strip0) * bkernel.STRIP
        assert 0 <= c0 < M.m
    # the plan covers every tile of every member once
    tpb, splits = split
    for M in table.members:
        assert (splits - 1) * tpb < table.tiles_max <= splits * tpb
        assert M.tiles <= splits * tpb
    # as many blocks as the plan's target, unless the tiles run out first
    blocks = table.strips * -(-b // bkernel.ROWS) * splits
    assert blocks >= bkernel.BLOCKS_PER_SM * H100_SMS \
        or splits == table.tiles_max


def _jax_and_torch_leaves(rng, cfgs):
    jws, tws = [], []
    for n, m, q, _p, g in cfgs:
        w = rng.normal(size=(n, m)).astype(np.float32)
        jbw = jbp.make_bitplane_weights(
            jnp.asarray(w),
            jq.QuantSpec(bits=q, group_size=n // g if g > 1 else -1))
        jws.append(jbw)
        tws.append(convert.bitplane_from_numpy(
            np.asarray(jbw.planes), np.asarray(jbw.scale), jbw.zero,
            np.asarray(jbw.col_sum), jbw.n, jbw.spec, device="cpu"))
    return jws, tws


# one input shared by members of different blocking: n = 640 with bn 512
# (codes padded to 1024), 320 and 128 (640); n = 2048 with grouped scales
# that span several tiles (copied) and one group a tile (read in place)
SHARED = [
    [(640, 96, 2, 4, 1), (640, 130, 3, 4, 2), (640, 40, 2, 4, 5)],
    [(2048, 64, 2, 3, 2), (2048, 72, 4, 3, 16), (2048, 33, 1, 3, 1)],
]


@pytest.mark.parametrize("cfgs", SHARED)
def test_fused_group_linears_over_members_of_other_blocking(rng, cfgs):
    """The shared codes padded once to the widest member: bitwise JAX's
    fused launch (interpret mode) and the per-leaf path; one call of the
    plain version."""
    act_bits = cfgs[0][3]
    jws, tws = _jax_and_torch_leaves(rng, cfgs)
    x = rng.normal(size=(3, cfgs[0][0])).astype(np.float32)
    want = jprog.fused_group_linears(jnp.asarray(x), jws, act_bits,
                                     interpret=True)
    table = tprog.group_table(tws, act_bits)
    assert len({M.n_pad for M in table.members}) > 1 or cfgs[0][0] == 2048
    c0 = dict(tref.CALLS)
    got = tprog.fused_group_linears(torch.from_numpy(x), tws, act_bits,
                                    table=table)
    assert tref.CALLS["program_gemv"] == c0["program_gemv"] + 1
    assert tref.CALLS["gemv_bs"] == c0["gemv_bs"]
    spec = tq.QuantSpec(bits=act_bits)
    for w_, g_, bw in zip(want, got, tws):
        assert np.array_equal(g_.numpy(), np.asarray(w_))
        assert torch.equal(g_, tops.bitplane_gemv_bitserial(
            torch.from_numpy(x), bw, spec))


@pytest.mark.parametrize("n,m,g", [(640, 96, 1), (640, 130, 2),
                                   (640, 40, 5), (2048, 64, 2),
                                   (2048, 72, 16), (300, 90, 1)])
def test_tile_scales_read_the_leaf_in_place(n, m, g):
    """The table's tile scales equal `_expand_scales`'s rows; they are the
    leaf's own storage (a stride-0 view of per-channel scales, or one group
    a tile) unless a group spans several tiles."""
    gen = torch.Generator().manual_seed(n + m + g)
    bw = make_bitplane_weights(torch.randn((n, m), generator=gen),
                               tq.QuantSpec(bits=2,
                                            group_size=n // g if g > 1
                                            else -1))
    bn, _ = tops._pick_blocks(n, m, None, None, n // g if g > 1 else None)
    tiles = -(-n // bn)
    got = tprog.tile_scales(bw, bn, tiles)
    assert torch.equal(got, tops._expand_scales(bw, bn, tiles * bn))
    in_place = g == 1 or g == tiles
    assert (got.data_ptr() == bw.scale.data_ptr()) == in_place
    if g == 1:
        assert got.stride(0) == 0


def test_engine_tables_hold_no_copy(rng):
    """An engine's group table reads the leaves' planes and per-channel
    scales in place: it owns no device memory of its own."""
    from repro_torch.core.engine import MVDRAMEngine
    _, tws = _jax_and_torch_leaves(rng, [(512, m, 2, 4, 1)
                                         for m in (128, 96, 200)])
    eng = MVDRAMEngine()
    table = eng.packed_group(tws, 4)
    assert eng.packed_group(tws, 4) is table
    assert table.owned_bytes == 0
    assert all(p is bw.planes for p, bw in zip(table.planes, tws))


@pytest.mark.parametrize("cfgs,groups", [
    ([(300, 90, 2, 2, 1), (300, 90, 3, 3, 1), (300, 90, 4, 2, 1),
      (160, 40, 5, 4, 1)], ((0, 1, 2), (3,))),
    ([(320, 200, 2, 2, 2), (480, 130, 4, 3, 3), (512, 256, 4, 2, 1)],
     None)])
@pytest.mark.parametrize("fidelity", ["code", "bitserial"])
def test_group_plain_version_is_per_leaf_gemv_bs(cfgs, groups, fidelity):
    """`group_gemv` on the CPU (B2's plain version) on given codes, each
    member in its own blocking and columns: bitwise per-leaf `gemv_bs_ref`
    on the same codes; one call of the plain version, none of B1's."""
    gen = torch.Generator().manual_seed(len(cfgs))
    plan = tprog.build_plan(_metas(cfgs), groups)
    tws = [make_bitplane_weights(torch.randn((n, m), generator=gen),
                                 tq.QuantSpec(bits=q, group_size=n // g
                                              if g > 1 else -1))
           for n, m, q, _p, g in cfgs]
    table = tprog.member_table(plan, tws)
    codes = []
    for (n, _m, _q, p, _g), M in zip(cfgs, table.members):
        c = torch.randint(0, 1 << p, (2, n), generator=gen).to(torch.uint8)
        codes.append(torch.nn.functional.pad(c, (0, M.n_pad - n + 5),
                                             value=M.z_a))
    c0 = dict(tref.CALLS)
    out = tprog.group_gemv(table, codes, fidelity=fidelity)
    assert tref.CALLS["program_gemv"] == c0["program_gemv"] + 1
    assert tref.CALLS["gemv_bs"] == c0["gemv_bs"]
    assert out.shape == (2, table.cols)
    for c, bw, M in zip(codes, tws, table.members):
        want = tref.gemv_bs_ref(
            c[:, :M.n_pad].contiguous(), bw.planes,
            tops._expand_scales(bw, M.bn, M.n_pad), q=M.q, p=M.p, z_a=M.z_a,
            z_w=M.z_w, bn=M.bn, fidelity=fidelity)
        assert torch.equal(out[:, M.col:M.col + M.m], want)
    with pytest.raises(ValueError, match="uint8"):
        tprog.group_gemv(table, [c[:, :8] for c in codes])


# ---------------------------------------------------------------------------
# B5: the magic-number conversion, work items, split plan and fold order
# ---------------------------------------------------------------------------

MAGIC = np.float32(2.0 ** 23)


def _dequant(words: np.ndarray, q: int, j: int, zero: int) -> np.ndarray:
    """The kernel's c − zero of row j of uint32 words, in float32:
    as_float(0x4B000000 | ((w >> q·j) & mask)) − (2^23 + zero)."""
    code = (words >> np.uint32(q * j)) & np.uint32((1 << q) - 1)
    f = (np.uint32(0x4B000000) | code).view(np.float32)
    return f - (MAGIC + np.float32(zero))


@pytest.mark.parametrize("q", [1, 2, 4, 8])
def test_b5_magic_conversion_is_exact(q):
    """For every code and every zero point of q bits: exactly c − zero,
    and the codes of a word the plain version's unpacking gives."""
    levels = 1 << q
    per = 32 // q
    codes = np.arange(levels, dtype=np.uint32)
    for zero in range(levels):
        got = _dequant(codes, q, 0, zero)
        assert got.dtype == np.float32
        assert np.array_equal(got, (codes.astype(np.int64) - zero)
                              .astype(np.float32))
    rng = np.random.default_rng(q)
    words = rng.integers(0, 1 << 32, size=(7, 5), dtype=np.uint64).astype(
        np.uint32)
    unpacked = qref.unpack_codes_axis0(
        torch.from_numpy(words.view(np.int32)), q, 7 * per).numpy()
    zero = levels // 2
    for j in range(per):
        assert np.array_equal(_dequant(words, q, j, zero),
                              (unpacked[j::per] - zero).astype(np.float32))


def test_b5_split_plan_on_the_main_path():
    """B5 takes B3's plan: at llama2-7b's decode shapes (B = 4) every call
    splits; at a 64-row prefill a wide output does not."""
    got = {(n, m, gs): qkernel.split_plan(-(-n // bn), m, 4, H100_SMS)
           for n, m, gs, bn in ((4096, 4096, -1, 512),
                                (4096, 11008, -1, 512),
                                (11008, 4096, -1, 512),
                                (4096, 32000, -1, 512),
                                (4096, 4096, 128, 128))}
    assert got == {(4096, 4096, -1): (1, 8), (4096, 11008, -1): (1, 8),
                   (11008, 4096, -1): (1, 22), (4096, 32000, -1): (2, 4),
                   (4096, 4096, 128): (1, 32)}
    assert qkernel.split_plan(8, 11008, 64, H100_SMS) == (8, 1)
    assert qkernel.workspace_shape(1, 64, 11008) == (0,)
    assert qkernel.workspace_shape(4, 4, 32000) == (4, 4, 32000)


UNIT = 4      # words of a B5 work item (csrc/quant_matmul.cu kUnit)
WARPS = 8


def _emulate_quant_matmul(a, words, scale_tiles, *, q, zero, bn, tpb):
    """B5's schedule in float32: per work item (UNIT words of one tile)
    Σ a·(c − zero) by the magic conversion, times the tile's scale into its
    warp's partial (warps take a block's items in turn), the warps' sum in
    warp order per split, then the fold of the splits in split order."""
    b, n_pad = a.shape
    w_all, m = words.shape
    per = 32 // q
    tiles, wpt = n_pad // bn, bn // per
    upt = -(-wpt // UNIT)
    splits = -(-tiles // tpb)
    u32 = words.view(np.uint32)
    parts = []
    for s in range(splits):
        t0, nt = s * tpb, min(tpb, tiles - s * tpb)
        warp = np.zeros((WARPS, b, m), np.float32)
        for it in range(nt * upt):
            t = t0 + it // upt
            w0 = t * wpt + (it % upt) * UNIT
            live = min(UNIT, (t + 1) * wpt - w0, w_all - w0)
            if live <= 0:
                continue
            acc = np.zeros((b, m), np.float32)
            for u in range(live):
                for j in range(per):
                    row = (w0 + u) * per + j
                    acc += a[:, row:row + 1] * _dequant(u32[w0 + u], q, j,
                                                        zero)[None]
            warp[it % WARPS] += acc * scale_tiles[t][None]
        part = np.zeros((b, m), np.float32)
        for w in range(WARPS):
            part += warp[w]
        parts.append(part)
    out = np.zeros((b, m), np.float32)
    for p in parts:                                  # split order
        out += p
    return out, splits


# (n, m, B, q, group size): ragged n and m, every q, grouped scales
EMULATED_QMM = [(300, 90, 3, 2, -1), (1000, 40, 2, 4, -1),
                (512, 33, 1, 8, 128), (640, 20, 2, 1, 320),
                (2048, 12, 4, 2, 128)]


@pytest.mark.parametrize("n,m,b,q,gs", EMULATED_QMM)
@pytest.mark.parametrize("tpb", [1, 2, 8])
def test_b5_schedule_and_fold_order_hold_the_plain_version(n, m, b, q, gs,
                                                           tpb):
    """One split and several, within the kernel's tolerance (rtol 1e-5,
    atol 1e-5·max|plain|) of the plain version."""
    gen = torch.Generator().manual_seed(n + m + q)
    wq = tq.quantize_weights(torch.randn((n, m), generator=gen),
                             tq.QuantSpec(bits=q, group_size=gs))
    bn, _ = tops._pick_blocks(n, m, None, None, gs if gs > 0 else None)
    x = torch.randn((b, n), generator=gen)
    a = tops._pad_axis(x, bn, 1).contiguous()
    scale_t = qops._expand_scales_qt(wq, bn, a.shape[1]).contiguous()
    words = qops.packed_codes(wq)
    want = qref.quant_matmul_ref(a, words, scale_t, q=q, zero=wq.zero,
                                 bn=bn).numpy()
    got, splits = _emulate_quant_matmul(
        a.numpy(), words.numpy(), scale_t.numpy(), q=q, zero=wq.zero, bn=bn,
        tpb=min(tpb, a.shape[1] // bn))
    assert splits >= 1
    tol = 1e-5 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol)
