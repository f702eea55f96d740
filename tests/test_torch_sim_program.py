"""Port parity: compiled programs executed in the PUD simulator, on the CPU.

`GemvProgram.run` (the fused wave-major executor, `stage_program` /
`execute_program`) and its layer-major oracle, lane masks on capacity
programs, restaging after eviction, `FabricProgram.run` with page-in from
the spill tier and its `FabricReport`, `price_program(executed=)` /
`price_fabric(executed=)` and `simulated_wave_time`, and the `"sim"`
backend's routes — each against the JAX package on the same weights and
activations: outputs and per-(request, tile) OpCounts bitwise, executed
wave maxima and ledgers equal, prices equal float for float.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import backends as j_backends
from repro.core import bitplane as j_bitplane
from repro.core import engine as j_engine
from repro.core import quant as j_quant
from repro.core.pud import fabric as j_fabric
from repro.core.pud import gemv as j_gemv
from repro.core.pud.timing import simulated_wave_time as j_swt
from repro_torch.core import backends as t_backends
from repro_torch.core import engine as t_engine
from repro_torch.core import quant as t_quant
from repro_torch.core.bitplane import make_bitplane_weights
from repro_torch.core.pud import fabric as t_fabric
from repro_torch.core.pud import gemv as t_gemv
from repro_torch.core.pud.timing import simulated_wave_time as t_swt
from test_torch_model import fresh_jax_caches  # noqa: F401

# a small rank (4 parallel tiles): programs wrap waves, groups share
# boundary waves, B = 6 exceeds the wave capacity
GEOM = dict(subarray_cols=32, n_sub_max=16, channels=2, banks_per_channel=2)
# one subarray a bank and a thin row budget (the JAX fabric tests'): two
# 16-row layers fit, four spill
TINY = dict(subarray_rows=64, subarray_cols=32, n_sub_max=16, channels=1,
            banks_per_channel=2, subarrays_per_bank=1)


class Both:
    """One engine per package, every weight registered in both."""

    def __init__(self, geom=GEOM, pool=None, **kw):
        jg, tg = j_gemv.PudGeometry(**geom), t_gemv.PudGeometry(**geom)
        jpool = tpool = None
        if pool is not None:
            jpool = j_fabric.FabricPool(geom=jg, **pool)
            tpool = t_fabric.FabricPool(geom=tg, **pool)
        self.j = j_engine.MVDRAMEngine(geom=jg, pool=jpool, **kw)
        self.t = t_engine.MVDRAMEngine(geom=tg, pool=tpool, **kw)

    def register(self, name, w, q, p, gs=-1):
        """Quantize once (the port's codes, bitwise the JAX package's) and
        install the same codes in the JAX engine without tracing a kernel
        per shape: its simulator reads only the codes and the shapes."""
        h = self.t.register(name, torch.from_numpy(w),
                            t_quant.QuantSpec(bits=q, group_size=gs),
                            a_spec=t_quant.QuantSpec(bits=p))
        wq = h.wq
        spec = j_quant.QuantSpec(bits=q, group_size=gs)
        jwq = j_quant.QuantizedTensor(
            values=wq.values.numpy(), scale=wq.scale.numpy(), zero=wq.zero,
            spec=spec, col_sum=wq.col_sum.numpy())
        jbw = j_bitplane.BitplaneWeights(
            planes=h.weights.planes.numpy().view(np.uint32),
            scale=wq.scale.numpy(), zero=wq.zero,
            col_sum=wq.col_sum.numpy(), n=h.weights.n, spec=spec)
        self.j._install(name, jbw, jwq, j_quant.QuantSpec(bits=p))

    def compile(self, names, **kw):
        return self.j.compile(names, **kw), self.t.compile(names, **kw)


def _random_block(rng, layers, **engine_kw):
    """`layers` random heterogeneous linears (ragged reduction dims, mixed
    q/p, some grouped scales) and a random concurrency-group partition."""
    eng = Both(**engine_kw)
    names = []
    for i in range(layers):
        q, p = int(rng.integers(2, 5)), int(rng.integers(1, 4))
        if rng.random() < 0.3:
            n, gs = int(rng.integers(2, 5)) * 16, 16
        else:
            n, gs = int(rng.integers(3, 40)), -1
        m = int(rng.integers(2, 3 * (32 // q)))
        eng.register(f"l{i}", rng.normal(size=(n, m)).astype(np.float32),
                     q, p, gs)
        names.append(f"l{i}")
    groups, cur = [], [0]
    for i in range(1, layers):
        if rng.random() < 0.5:
            cur.append(i)
        else:
            groups.append(cur)
            cur = [i]
    groups.append(cur)
    return eng, names, groups


def _xs(rng, prog, b):
    return [rng.normal(size=(b, h.plan.n)).astype(np.float32)
            for h in prog.handles]


def _run(prog, xs, **kw):
    if isinstance(prog, t_engine.GemvProgram) or \
            isinstance(prog, t_engine.FabricProgram):
        return prog.run([torch.from_numpy(x) for x in xs], **kw)
    return prog.run([jnp.asarray(x) for x in xs], **kw)


def _counts(rep):
    return [[[c.asdict() for c in r.tile_runtime] for r in layer.requests]
            for layer in rep.reports]


def _same(a_outs, a_rep, b_outs, b_rep):
    """Outputs and per-(request, tile) counts bitwise (either package)."""
    for a, b in zip(a_outs, b_outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert _counts(a_rep) == _counts(b_rep)
    for ra, rb in zip(a_rep.reports, b_rep.reports):
        assert [c.asdict() for c in ra.wave_max] == \
            [c.asdict() for c in rb.wave_max]
        assert [r.skipped_bits for r in ra.requests] == \
            [r.skipped_bits for r in rb.requests]
        assert ra.staged.asdict() == rb.staged.asdict()
        assert ra.resident and rb.resident
        assert ra.shared_preload.host_bits_written == 0


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 10 ** 6), layers=st.integers(1, 4),
       b=st.integers(1, 6), sparsity=st.booleans())
def test_fused_run_matches_layer_major_and_jax(seed, layers, b, sparsity):
    rng = np.random.default_rng(seed)
    eng, names, groups = _random_block(rng, layers)
    eng.j.sparsity = eng.t.sparsity = sparsity
    jp, tp = eng.compile(names, groups=groups)
    xs = _xs(rng, tp, b)
    to, tr = _run(tp, xs)
    jo, jr = _run(jp, xs)
    lo, lr = _run(tp, xs, layer_major=True)
    assert tr.fused and not lr.fused
    assert tr.waves == tp.sched.waves == jr.waves
    _same(to, tr, jo, jr)
    _same(to, tr, lo, lr)
    assert tr.executed_wave_ops == jr.executed_wave_ops
    assert [c.asdict() for c in tr.wave_max] == \
        [c.asdict() for c in jr.wave_max]
    assert tr.executed_counts.asdict() == jr.executed_counts.asdict()
    assert tr.encode_ops == jr.encode_ops
    assert tr.repeated_staging.host_bits_written == 0
    assert t_swt(tr) == j_swt(jr)
    tc = eng.t.price_program(tp, batch=b, executed=tr)
    jc = eng.j.price_program(jp, batch=b, executed=jr)
    assert tc.asdict() == jc.asdict()
    assert tc.t_compute >= t_swt(tr) > 0.0
    # the partials the fused run read out: exact per-chunk products
    for h, x, part in zip(tp.handles, xs, tr.partials):
        a = t_quant.quantize_activations(torch.from_numpy(x), h.a_spec)
        a = a.values.numpy().astype(np.int64)
        w = h.wq.values.numpy().astype(np.int64)
        for ci in range(part.shape[1]):
            j0 = ci * h.plan.n_sub
            j1 = min(j0 + h.plan.n_sub, h.plan.n)
            np.testing.assert_array_equal(part[:, ci].numpy(),
                                          a[:, j0:j1] @ w[j0:j1])


def _dense(n, b, p):
    codes = np.full((b, n), (1 << p) - 1, dtype=np.uint8)
    return (j_quant.QuantizedTensor(values=jnp.asarray(codes),
                                    scale=jnp.ones((b, 1), jnp.float32),
                                    zero=0, spec=j_quant.QuantSpec(bits=p)),
            t_quant.QuantizedTensor(values=torch.from_numpy(codes),
                                    scale=torch.ones((b, 1)), zero=0,
                                    spec=t_quant.QuantSpec(bits=p)))


def test_stage_and_execute_program_against_jax(rng):
    """The fused plan's arrays, and a dense-bit execution: executed waves
    reconcile with the analytic price exactly, in both packages."""
    eng = Both()
    eng.register("a", rng.normal(size=(32, 8)).astype(np.float32), 4, 2)
    eng.register("b", rng.normal(size=(16, 8)).astype(np.float32), 4, 2)
    jp, tp = eng.compile(["a", "b"], groups=[[0, 1]])
    tplan = t_gemv.stage_program([eng.t.staged_for(h) for h in tp.handles],
                                 tp.sched)
    jplan = j_gemv.stage_program([eng.j.staged_for(h) for h in jp.handles],
                                 jp.sched)
    for f in ("gchunk", "mask_r", "static", "add_rc", "add_m3", "colidx",
              "mult", "valid", "gout", "bank_keys", "chunk0", "out0"):
        np.testing.assert_array_equal(getattr(tplan, f), getattr(jplan, f))
    np.testing.assert_array_equal(tplan.matrix.numpy(), jplan.matrix)
    np.testing.assert_array_equal(tplan.checksum.numpy(), jplan.checksum)
    assert [(w.lo, w.hi, w.out_lo, w.out_hi, len(w.segments))
            for w in tplan.waves] == \
        [(w.lo, w.hi, w.out_lo, w.out_hi, len(w.segments))
         for w in jplan.waves]
    b = 2
    (ja, ta), (jb, tb) = _dense(32, b, 2), _dense(16, b, 2)
    tres = t_gemv.execute_program(tplan, [ta, tb], [h.wq for h in tp.handles],
                                  [h.templates for h in tp.handles])
    jres = j_gemv.execute_program(jplan, [ja, jb], [h.wq for h in jp.handles],
                                  [h.templates for h in jp.handles])
    np.testing.assert_array_equal(tres.wave_max, jres.wave_max)
    np.testing.assert_array_equal(tres.counts_total, jres.counts_total)
    np.testing.assert_array_equal(tres.encode_layer_ops,
                                  jres.encode_layer_ops)
    for a, c in zip(tres.rt_arrs, jres.rt_arrs):
        np.testing.assert_array_equal(a, c)
    for a, c in zip(tres.outs, jres.outs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    rep = t_engine.ProgramReport(reports=(), fused=True, waves=tres.waves,
                                 wave_max_arr=tres.wave_max, batch=b)
    analytic = eng.t.price_program(tp, bit_density=1.0, batch=b)
    executed = eng.t.price_program(tp, bit_density=1.0, batch=b,
                                   executed=rep)
    assert executed.t_compute == pytest.approx(analytic.t_compute)
    with pytest.raises(ValueError, match="layer 0 stages"):
        t_gemv.stage_program([eng.t.staged_for(h) for h in tp.handles][::-1],
                             tp.sched)


@pytest.mark.parametrize("layer_major", [False, True])
def test_masked_capacity_program_matches_compacted(layer_major):
    rng = np.random.default_rng(5)
    eng, names, groups = _random_block(rng, 3)
    b = 5
    jp, tp = eng.compile(names, groups=groups, b_max=b)
    _jc, tc = eng.compile(names, groups=groups)
    mask = np.array([True, False, True, True, False])
    xs = _xs(rng, tp, b)
    to, tr = _run(tp, xs, lane_mask=mask, layer_major=layer_major)
    jo, jr = _run(jp, xs, lane_mask=mask, layer_major=layer_major)
    co, cr = _run(tc, [x[mask] for x in xs], layer_major=layer_major)
    _same(to, tr, jo, jr)
    assert tr.batch == 3 and tr.lanes == b
    for o, c in zip(to, co):
        assert torch.equal(o[torch.from_numpy(mask)], c)
        assert not o[torch.from_numpy(~mask)].any()
    for lm, lc in zip(tr.reports, cr.reports):
        active = [r for r, k in zip(lm.requests, mask) if k]
        assert [r.runtime.asdict() for r in active] == \
            [r.runtime.asdict() for r in lc.requests]
        for r, k in zip(lm.requests, mask):
            if not k:
                assert not any(r.runtime.asdict().values())
    if not layer_major:
        assert tr.executed_wave_ops == cr.executed_wave_ops
        assert eng.t.price_program(tp, batch=3, executed=tr).asdict() == \
            eng.t.price_program(tc, batch=3, executed=cr).asdict() == \
            eng.j.price_program(jp, batch=3, executed=jr).asdict()


def test_occupancy_changes_reuse_plan_and_rows_and_validate():
    rng = np.random.default_rng(31)
    eng, names, _ = _random_block(rng, 2)
    _jp, tp = eng.compile(names, b_max=4)
    xs = _xs(rng, tp, 4)
    fused, staged = set(), set()
    for mask in ([True] * 4, [True, False, True, False],
                 [False, False, False, True]):
        _o, rep = _run(tp, xs, lane_mask=np.array(mask))
        fused.add(id(tp._fused))
        staged.add(tuple(id(s) for s in tp._fused_staged))
        assert rep.batch == sum(mask) and rep.lanes == 4
        assert rep.repeated_staging.host_bits_written == 0
    assert len(fused) == len(staged) == 1
    assert eng.t.residency_stats()["staged_layers"] == 2
    with pytest.raises(ValueError, match="b_max=4"):
        _run(tp, [x[:2] for x in xs])
    with pytest.raises(ValueError, match="no active lanes"):
        _run(tp, xs, lane_mask=np.zeros(4, bool))
    with pytest.raises(ValueError, match="lane_mask shape"):
        _run(tp, xs, lane_mask=np.ones(3, bool))
    with pytest.raises(ValueError, match="activations for a 2-layer"):
        _run(tp, xs[:1])


def test_run_follows_restaging_after_evict_reregister():
    rng = np.random.default_rng(11)
    eng, names, _ = _random_block(rng, 2)
    jp, tp = eng.compile(names)
    xs = _xs(rng, tp, 2)
    _run(tp, xs)
    first = tp._fused
    eng.t.evict("l0")
    assert eng.t.staged_for("l0") is None
    with pytest.raises(ValueError, match="no longer resident"):
        _run(tp, xs)
    w = rng.normal(size=(tp.handles[0].plan.n, tp.handles[0].plan.m))
    q, p = tp.handles[0].plan.q, tp.handles[0].plan.p
    eng.register("l0", w.astype(np.float32), q, p)
    with pytest.raises(ValueError, match="stale handle"):
        _run(tp, xs)
    jp, tp = eng.compile(names)
    to, tr = _run(tp, xs)
    jo, jr = _run(jp, xs)
    _same(to, tr, jo, jr)
    assert tp._fused is not first
    # pool compaction moves rows: the staged rows drop and restage
    before = eng.t.staged_for("l1")
    eng.t._on_pool_move("l1", eng.t.handles["l1"].placement,
                        eng.t.handles["l1"].placement)
    assert eng.t.staged_for("l1") is not before
    to2, tr2 = _run(tp, xs)
    _same(to2, tr2, jo, jr)


def test_executed_pricing_validation():
    rng = np.random.default_rng(17)
    eng, names, _ = _random_block(rng, 2)
    _jp, tp = eng.compile(names)
    xs = _xs(rng, tp, 2)
    _o, fused = _run(tp, xs)
    _o, layer = _run(tp, xs, layer_major=True)
    with pytest.raises(ValueError, match="simulated column width"):
        eng.t.price_program(tp, batch=2, usable_cols=65536, executed=fused)
    with pytest.raises(ValueError, match="fused wave-major"):
        eng.t.price_program(tp, batch=2, executed=layer)
    with pytest.raises(ValueError, match="no fused-wave counts"):
        t_swt(layer)
    with pytest.raises(ValueError, match="lane batch"):
        eng.t.price_program(tp, batch=3, executed=fused)


def _spill_engines(seed=0):
    """Four 16×8 layers on a fabric that holds two (the rest spilled), and
    a big single pool: both packages."""
    rng = np.random.default_rng(seed)
    fab = Both(geom=TINY, pool=dict(dimms=1, compute_reserve=10),
               on_full="spill")
    big = Both(geom=dict(TINY, subarrays_per_bank=4))
    for i in range(4):
        w = rng.normal(size=(16, 8)).astype(np.float32)
        fab.register(f"l{i}", w, 4, 4)
        big.register(f"l{i}", w, 4, 4)
    names = [f"l{i}" for i in range(4)]
    return fab, big, names


def test_fabric_run_pages_in_from_spill_and_reconciles():
    fab, big, names = _spill_engines()
    assert len(fab.t.pool.spilled()) == len(fab.j.pool.spilled()) == 2
    jp, tp = fab.compile(names)
    _jb, tb = big.compile(names)
    assert isinstance(tp, t_engine.FabricProgram)
    rng = np.random.default_rng(1)
    for step in range(2):
        xs = [rng.normal(size=(2, 16)).astype(np.float32) for _ in names]
        to, tr = _run(tp, xs)
        jo, jr = _run(jp, xs)
        bo, br = _run(tb, xs)
        _same(to, tr, jo, jr)
        _same(to, tr, bo, br)
        assert (tr.spill_restage_bits, tr.spill_restages, tr.waves,
                tr.fused, tr.batch, tr.lanes, tr.layers) == \
            (jr.spill_restage_bits, jr.spill_restages, jr.waves, jr.fused,
             jr.batch, jr.lanes, jr.layers)
        assert tr.part_indices == jr.part_indices
        assert tr.spill_restages >= 2
        assert tr.staged.asdict() == jr.staged.asdict()
        tc = fab.t.price_fabric(tp, batch=2, executed=tr)
        jc = fab.j.price_fabric(jp, batch=2, executed=jr)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.t_spill_restage == fab.t.cxl.restage_time(
            tr.spill_restage_bits, tr.spill_restages) > 0
    assert tp.steps == 2
    assert fab.t.residency_stats() == fab.j.residency_stats()
    with pytest.raises(ValueError, match="parts"):
        fab.t.price_fabric(tp, batch=2, executed=t_engine.FabricReport(
            (), (), (), ()))


def test_sim_backend_routes_and_sim_linear_reuse():
    rng = np.random.default_rng(3)
    eng = Both(geom=dict(subarray_cols=64, n_sub_max=32))
    eng.register("w", rng.normal(size=(48, 20)).astype(np.float32), 3, 4)
    x1 = rng.normal(size=(48,)).astype(np.float32)
    xb = rng.normal(size=(3, 48)).astype(np.float32)
    assert t_backends.get_backend("sim") is t_backends.SIM
    assert t_backends.SIM.kernel_impl is None
    for x, kw in ((x1, {}), (x1, {"naive": True}), (x1, {"wave": False}),
                  (xb, {})):
        to, tr = eng.t.gemv("w", torch.from_numpy(x), backend="sim", **kw)
        jo, jr = eng.j.gemv("w", jnp.asarray(x), backend=j_backends.SIM,
                            **kw)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert tr.runtime.asdict() == jr.runtime.asdict()
    assert eng.t.residency_stats()["staged_layers"] == 1   # 2-D only
    ref = t_backends.REFERENCE.gemv(eng.t, eng.t.handles["w"],
                                    torch.from_numpy(xb))
    np.testing.assert_allclose(to.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    # the serving route: a leaf the engine has never seen is placed once,
    # then found again by identity
    bw = make_bitplane_weights(torch.from_numpy(
        rng.normal(size=(32, 12)).astype(np.float32)),
        t_quant.QuantSpec(bits=2))
    lin = t_engine.EngineLinear(eng.t, backend="sim")
    o1 = lin(torch.from_numpy(xb[:, :32]), bw, act_bits=4)
    n_handles = len(eng.t.handles)
    o2 = lin(torch.from_numpy(xb[:, :32]), bw, act_bits=4)
    assert len(eng.t.handles) == n_handles == 2 and torch.equal(o1, o2)
    lin(torch.from_numpy(xb[:, :32]), bw, act_bits=3)
    assert len(eng.t.handles) == 3                 # act_bits keys apart
    with pytest.raises(ValueError, match="act_bits"):
        lin(torch.from_numpy(xb[:, :32]), bw)
    # run_program through the sim backend is the program's own run
    _jp, tp = eng.compile(["w"])
    via = t_backends.SIM.run_program(eng.t, tp, [torch.from_numpy(xb)])
    direct, _rep = tp.run([torch.from_numpy(xb)])
    assert torch.equal(via[0], direct[0])
    with pytest.raises(ValueError, match=r"\(N,\) vector"):
        eng.t.gemv("w", torch.zeros((2, 2, 48)), backend="sim")
    eng.t.register("f", torch.from_numpy(
        rng.normal(size=(48, 4)).astype(np.float32)),
        t_quant.QuantSpec(bits=2))
    with pytest.raises(ValueError, match="quantized activations"):
        eng.t.gemv("f", torch.from_numpy(x1), backend="sim")
    with pytest.raises(ValueError, match="float activations"):
        eng.t.compile(["f"]).run([torch.from_numpy(xb)])
    # the kernel backend's gemv (its plain versions on the CPU)
    ko = eng.t.gemv("w", torch.from_numpy(xb), backend="kernel")
    np.testing.assert_allclose(ko.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
