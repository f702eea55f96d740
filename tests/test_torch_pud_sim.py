"""Port parity: the PUD simulator's GeMV paths, on the CPU.

The port's `core/pud/gemv.py` against the JAX package's on the same numpy
codes: on-the-fly encoding and template selection; `mvdram_gemv` on its
three executors (the naive micro-op oracle, the sequential per-tile path,
the wave-parallel one) against `quantized_gemv_reference` and bitwise
against the JAX simulator, reliable-column placement included; staging
(every resident bit row, matrix block, checksum and staged count, and the
weight-load bits on ragged shapes); `mvdram_gemv_batched` with its
partials, per-(request, tile) OpCounts, wave maxima, lane masks and
resident launches; the exactness of the code matmul at its largest sums.
Outputs are compared bitwise: the port's float epilogue follows the JAX
package's float64 order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import quant as j_quant
from repro.core.pud import gemv as j_gemv
from repro_torch.core import quant as t_quant
from repro_torch.core.bitplane import activation_plane_popcounts
from repro_torch.core.pud import gemv as t_gemv
from repro_torch.core.pud.adder import code_matmul
from repro_torch.core.pud.timing import (DDR4_2400, bank_waves, price_gemv,
                                         simulated_wave_time)
from test_torch_model import fresh_jax_caches  # noqa: F401

GEOM = dict(subarray_cols=64, n_sub_max=32)
SMALL = dict(subarray_cols=16, n_sub_max=32, channels=2, banks_per_channel=2)


def _geoms(**kw):
    return j_gemv.PudGeometry(**kw), t_gemv.PudGeometry(**kw)


def _qt(codes, scale, zero, bits):
    """The same quantized tensor in both packages."""
    codes = np.asarray(codes, np.uint8)
    scale = np.asarray(scale, np.float32)
    j = j_quant.QuantizedTensor(values=jnp.asarray(codes),
                                scale=jnp.asarray(scale), zero=zero,
                                spec=j_quant.QuantSpec(bits=bits))
    t = t_quant.QuantizedTensor(values=torch.from_numpy(codes),
                                scale=torch.from_numpy(scale), zero=zero,
                                spec=t_quant.QuantSpec(bits=bits))
    return j, t


def _pair(rng, n, m, q, p, g=1, b=None):
    """Random weight and activation codes with scales, in both packages."""
    w = rng.integers(0, 2 ** q, size=(n, m))
    a = rng.integers(0, 2 ** p, size=(n,) if b is None else (b, n))
    ascale = rng.random((1,) if b is None else (b, 1)) + 0.1
    jw, tw = _qt(w, rng.random((g, m)) + 0.1, 2 ** (q - 1), q)
    ja, ta = _qt(a, ascale, 2 ** (p - 1), p)
    return jw, ja, tw, ta


def _c(counts):
    return [c.asdict() for c in counts]


def _same_report(rt, rj):
    assert rt.tiles == rj.tiles and rt.waves == rj.waves
    assert (rt.skipped_bits, rt.r_bits, rt.aggregate_bits) == \
        (rj.skipped_bits, rj.r_bits, rj.aggregate_bits)
    assert _c(rt.tile_runtime) == _c(rj.tile_runtime)
    assert _c(rt.tile_preload) == _c(rj.tile_preload)
    assert _c(rt.wave_max) == _c(rj.wave_max)
    assert rt.runtime.asdict() == rj.runtime.asdict()


# ---------------------------------------------------------------------------
# Encoding and template selection
# ---------------------------------------------------------------------------

def test_encode_commands_and_template_selection():
    a = np.array([0b1010, 0b0001, 0], np.uint8)
    plan = t_gemv.encode_commands(a, p=4, sparsity=True)
    assert plan.adds == [(0, 1), (0, 3), (1, 0)]    # j-major, k-minor
    assert plan.skipped == 9
    assert len(t_gemv.encode_commands(a, p=4, sparsity=False).adds) == 12
    sel = t_gemv.select_templates(torch.from_numpy(a),
                                  t_gemv.build_templates(3, 4))
    assert sel.popcounts == (1, 1, 0, 1) and sel.skipped == 9
    assert t_gemv.build_templates(3, 4) is t_gemv.build_templates(3, 4)


@settings(max_examples=10, deadline=None)
@given(n=st.integers(1, 40), p=st.integers(1, 8), b=st.integers(1, 4),
       sparsity=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_encoding_matches_jax(n, p, b, sparsity, seed):
    codes = np.random.default_rng(seed).integers(0, 2 ** p, size=(b, n))
    codes = codes.astype(np.uint8)
    tt, jt = t_gemv.build_templates(n, p), j_gemv.build_templates(n, p)
    assert (tt.n_sub, tt.p, tt.r) == (jt.n_sub, jt.p, jt.r)
    assert [o.cost.asdict() for o in tt.offsets] == \
        [o.cost.asdict() for o in jt.offsets]
    tp = t_gemv.encode_commands(torch.from_numpy(codes[0]), p, sparsity)
    jp = j_gemv.encode_commands(codes[0], p, sparsity)
    assert (tp.adds, tp.skipped) == (jp.adds, jp.skipped)
    ts = t_gemv.select_templates(codes[0], tt, sparsity)
    js = j_gemv.select_templates(codes[0], jt, sparsity)
    assert [r.tolist() for r in ts.rows_per_offset] == \
        [r.tolist() for r in js.rows_per_offset]
    assert (ts.zero_slots, ts.skipped) == (js.zero_slots, js.skipped)
    tb = t_gemv.select_templates_batched(torch.from_numpy(codes), tt,
                                         sparsity)
    jb = j_gemv.select_templates_batched(codes, jt, sparsity)
    np.testing.assert_array_equal(tb.popcounts, jb.popcounts)
    np.testing.assert_array_equal(tb.skipped, jb.skipped)
    _ja, ta = _qt(codes, np.ones((b, 1)), 0, p)
    np.testing.assert_array_equal(activation_plane_popcounts(ta).numpy(),
                                  tb.popcounts.sum(axis=0))


# ---------------------------------------------------------------------------
# Per-call GeMV: three executors, the reference and the JAX simulator
# ---------------------------------------------------------------------------

@settings(max_examples=10, deadline=None)
@given(q=st.integers(1, 4), p=st.integers(1, 4), n=st.sampled_from([16, 40]),
       m=st.integers(1, 10), sparsity=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_mvdram_gemv_exact_and_equal_to_jax(q, p, n, m, sparsity, seed):
    rng = np.random.default_rng(seed)
    jw, ja, tw, ta = _pair(rng, n, m, q, p)
    jg, tg = _geoms(**GEOM)
    ref = t_quant.quantized_gemv_reference(ta, tw)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(j_quant.quantized_gemv_reference(ja, jw)),
        rtol=1e-6, atol=1e-6)
    outs = []
    for kw in ({}, {"wave": False}, {"naive": True}):
        out, rep = t_gemv.mvdram_gemv(ta, tw, sparsity=sparsity, geom=tg,
                                      **kw)
        jout, jrep = j_gemv.mvdram_gemv(ja, jw, sparsity=sparsity, geom=jg,
                                        **kw)
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        _same_report(rep, jrep)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4)
        outs.append(out)
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_subarray_states_naive_vectorized_and_jax(rng):
    """The accumulator rows (value + complement tracks) land bit-identical
    on the naive and vectorized single-tile paths, and on the JAX's."""
    q, p, n = 3, 3, 24
    w = rng.integers(0, 2 ** q, size=(n, 6)).astype(np.uint8)
    a = rng.integers(0, 2 ** p, size=(n,)).astype(np.uint8)
    jg, tg = _geoms(subarray_cols=32, n_sub_max=n)
    subs = []
    for naive in (False, True):
        out, rt, pre, sub = t_gemv.mvdram_gemv_subarray(
            torch.from_numpy(w), a, q, p, geom=tg, naive=naive)
        jout, jrt, jpre, jsub = j_gemv.mvdram_gemv_subarray(
            w, a, q, p, geom=jg, naive=naive)
        np.testing.assert_array_equal(out.numpy(), jout)
        np.testing.assert_array_equal(sub.data.numpy(), jsub.data)
        assert (rt.asdict(), pre.asdict()) == (jrt.asdict(), jpre.asdict())
        subs.append(sub.data.numpy())
    lay = t_gemv.HorizontalLayout(n_sub=n, m_sub=6, q=q, p=p,
                                  subarray_cols=32)
    rows = np.asarray(lay.acc_rows + lay.acc_c_rows)
    np.testing.assert_array_equal(subs[0][rows], subs[1][rows])


@pytest.mark.parametrize("wave", [True, False])
def test_reliable_columns_fewer_slots_than_outputs(rng, wave):
    q, p, n, m = 2, 3, 24, 13
    jg, tg = _geoms(**SMALL)
    rel = np.zeros(16, dtype=bool)
    rel[[0, 1, 5, 6, 10, 11]] = True       # three q=2 runs
    np.testing.assert_array_equal(t_gemv.usable_output_slots(rel, q),
                                  j_gemv.usable_output_slots(rel, q))
    jw, ja, tw, ta = _pair(rng, n, m, q, p)
    out, rep = t_gemv.mvdram_gemv(ta, tw, geom=tg, reliable_cols=rel,
                                  wave=wave)
    jout, jrep = j_gemv.mvdram_gemv(ja, jw, geom=jg, reliable_cols=rel,
                                    wave=wave)
    assert rep.col_chunks == -(-m // 3) == 5
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    _same_report(rep, jrep)
    for b in (True, False):     # slots of runs longer than q; trailing run
        np.testing.assert_array_equal(
            t_gemv.usable_output_slots(np.array([1, 1, 1, 0, 1, b]), 2),
            j_gemv.usable_output_slots(np.array([1, 1, 1, 0, 1, b]), 2))


def test_wave_counts_match_analytic_and_simulated_time():
    """Dense activation bits: the simulated per-wave maxima equal the
    analytic per-tile closed form and price to the analytic t_bank."""
    jg, tg = _geoms(**SMALL)
    q, p, n, m = 3, 4, 64, 12
    w = np.random.default_rng(7).integers(0, 2 ** q, size=(n, m))
    jw, tw = _qt(w, np.ones((1, m)), 0, q)
    ja, ta = _qt(np.full((n,), 2 ** p - 1), np.ones(1), 0, p)
    out, rep = t_gemv.mvdram_gemv(ta, tw, geom=tg)
    cost = t_gemv.mvdram_gemv_cost(m, n, q, p, bit_density=1.0, geom=tg,
                                   usable_cols=tg.subarray_cols)
    assert rep.tiles == cost.tiles == 6
    assert rep.waves == cost.waves == bank_waves(rep.tiles, tg) == 2
    for mx in rep.wave_max:
        assert (mx.row_copy, mx.maj3, mx.maj5) == \
            (cost.ops_per_tile.row_copy, cost.ops_per_tile.maj3,
             cost.ops_per_tile.maj5)
    t_sim = simulated_wave_time(rep, DDR4_2400)
    assert t_sim == cost.waves * cost.ops_per_tile.pud_ops * DDR4_2400.t_op
    assert price_gemv(cost, tg).t_compute >= t_sim
    _jo, jrep = j_gemv.mvdram_gemv(ja, jw, geom=jg)
    from repro.core.pud.timing import simulated_wave_time as j_swt
    assert t_sim == j_swt(jrep)


def test_gemv_input_errors(rng):
    jg, tg = _geoms(**GEOM)
    _jw, _ja, tw, ta = _pair(rng, 48, 4, 3, 3)
    bad = t_quant.QuantizedTensor(values=tw.values,
                                  scale=torch.ones((5, 4)), zero=tw.zero,
                                  spec=tw.spec)
    with pytest.raises(ValueError, match="divisible by G=5"):
        t_gemv.mvdram_gemv(ta, bad, geom=tg)
    with pytest.raises(ValueError, match="naive micro-op oracle"):
        t_gemv.mvdram_gemv(ta, tw, geom=tg, naive=True, wave=True)
    with pytest.raises(ValueError, match="no usable output slots"):
        t_gemv.mvdram_gemv(ta, tw, geom=tg,
                           reliable_cols=np.zeros(64, dtype=bool))
    _jw, _ja, tw, tab = _pair(rng, 16, 4, 2, 2, b=2)
    with pytest.raises(ValueError, match="shared waves only"):
        t_gemv.mvdram_gemv(tab, tw, geom=tg, naive=True)
    with pytest.raises(ValueError, match="shared waves only"):
        t_gemv.mvdram_gemv(tab, tw, geom=tg, wave=False)
    with pytest.raises(ValueError, match="batched GeMV takes"):
        t_gemv.mvdram_gemv_batched(ta, tw, geom=tg)


# ---------------------------------------------------------------------------
# Staging and the resident batched executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,q,p", [(40, 12, 3, 4), (70, 30, 2, 2),
                                     (16, 5, 4, 1)])
def test_staging_bitwise_and_weight_load_bits(rng, n, m, q, p):
    """Every staged group's bank rows, float32 matrix block, checksum, bank
    keys and staged counts equal the JAX package's, on ragged reduction and
    column chunks; the staged bits reconcile with the analytic cost."""
    jg, tg = _geoms(**SMALL)
    jw, _ja, tw, _ta = _pair(rng, n, m, q, p)
    ts = t_gemv.stage_matrix(tw, p, geom=tg)
    js = j_gemv.stage_matrix(jw, p, geom=jg)
    assert (ts.n_chunks, ts.col_chunks, ts.waves, ts.m_per_tile) == \
        (js.n_chunks, js.col_chunks, js.waves, js.m_per_tile)
    np.testing.assert_array_equal(ts.preload, js.preload)
    assert len(ts.groups) == len(js.groups)
    for tgp, jgp in zip(ts.groups, js.groups):
        np.testing.assert_array_equal(tgp.bank.data.numpy(), jgp.bank.data)
        np.testing.assert_array_equal(tgp.matrix_block.numpy(),
                                      jgp.matrix_block)
        np.testing.assert_array_equal(tgp.checksum.numpy(), jgp.checksum)
        np.testing.assert_array_equal(tgp.flat_idx.numpy(), jgp.flat_idx)
        np.testing.assert_array_equal(tgp.bank_keys, jgp.bank_keys)
        np.testing.assert_array_equal(tgp.tiles_idx, jgp.tiles_idx)
    cost = t_gemv.mvdram_gemv_cost(m, n, q, p, geom=tg,
                                   usable_cols=tg.subarray_cols)
    assert ts.staged_counts.host_bits_written == cost.weight_load_bits
    assert ts.nbytes == sum(
        g.bank.data.numel() + 4 * g.matrix_block.numel()
        + 8 * g.checksum.numel() for g in ts.groups)


@settings(max_examples=8, deadline=None)
@given(n=st.integers(3, 80), m=st.integers(1, 30), q=st.integers(1, 4),
       p=st.integers(1, 4), b=st.integers(1, 6), grouped=st.booleans(),
       sparsity=st.booleans(), masked=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_batched_gemv_matches_jax(n, m, q, p, b, grouped, sparsity, masked,
                                  seed):
    """`mvdram_gemv_batched` (fresh staging and resident): outputs,
    partials, per-(request, tile) OpCounts, wave maxima and staging
    bitwise against the JAX simulator, lane masks included."""
    rng = np.random.default_rng(seed)
    jg, tg = _geoms(**SMALL)
    g = 1
    if grouped:      # two scale groups, each a whole number of chunks
        n, g = 64 * int(rng.integers(1, 3)), 2
    jw, ja, tw, ta = _pair(rng, n, m, q, p, g=g, b=b)
    mask = None
    if masked:
        mask = rng.random(b) < 0.5
        mask[int(rng.integers(0, b))] = True
    staged = t_gemv.stage_matrix(tw, p, geom=tg)
    jstaged = j_gemv.stage_matrix(jw, p, geom=jg)
    for t_st, j_st in ((None, None), (staged, jstaged)):
        out, rep = t_gemv.mvdram_gemv_batched(
            ta, tw, sparsity=sparsity, geom=tg, staged=t_st, lane_mask=mask)
        jout, jrep = j_gemv.mvdram_gemv_batched(
            ja, jw, sparsity=sparsity, geom=jg, staged=j_st, lane_mask=mask)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        assert rep.resident == jrep.resident == (t_st is not None)
        for rt, rj in zip(rep.requests, jrep.requests):
            _same_report(rt, rj)
        assert _c(rep.wave_max) == _c(jrep.wave_max)
        assert rep.shared_preload.asdict() == jrep.shared_preload.asdict()
        assert rep.staged.asdict() == jrep.staged.asdict()
    # the executor's integer partials: exact per-chunk products
    a = ta.values.numpy().astype(np.int64)
    codes, popc, zeros, _sk, _rb = t_gemv._chunk_arrays_batched(
        a.astype(np.uint32), n, staged.n_sub, p, sparsity)
    part, _rt = t_gemv._execute_staged(staged, codes, popc, zeros, b)
    w = tw.values.numpy().astype(np.int64)
    for ci in range(staged.n_chunks):
        j0, j1 = ci * staged.n_sub, min((ci + 1) * staged.n_sub, n)
        np.testing.assert_array_equal(part[:, ci].numpy(),
                                      a[:, j0:j1] @ w[j0:j1])


def test_code_matmul_exact_at_the_largest_sums():
    """n_sub 128 × code 255 against all-ones rows sums to 32,640 per
    column, exactly; through the whole batched GeMV, 8-bit all-ones codes
    against 8-bit all-ones weights give 128·255·255 per chunk exactly, in
    both packages."""
    codes = torch.full((3, 4, 128), 255.0)
    rows = torch.ones((3, 128, 1024))
    out = code_matmul(codes, rows)
    assert out.dtype == torch.float32 and bool((out == 32640.0).all())
    n, m, q, p = 256, 8, 8, 8
    jg, tg = _geoms(subarray_cols=1024, n_sub_max=128)
    jw, tw = _qt(np.full((n, m), 255), np.ones((1, m)), 0, q)
    ja, ta = _qt(np.full((4, n), 255), np.ones((4, 1)), 0, p)
    out, rep = t_gemv.mvdram_gemv_batched(ta, tw, geom=tg)
    jout, _ = j_gemv.mvdram_gemv_batched(ja, jw, geom=jg)
    assert bool((out == float(n * 255 * 255)).all())
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    staged = t_gemv.stage_matrix(tw, p, geom=tg)
    c, pc, z, _s, _r = t_gemv._chunk_arrays_batched(
        np.full((4, n), 255, np.uint32), n, 128, p, True)
    part, _ = t_gemv._execute_staged(staged, c, pc, z, 4)
    assert bool((part == 128 * 255 * 255).all())
