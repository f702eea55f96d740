"""Port parity: fault injection, ABFT verification and the recovery ladder,
on the CPU.

* `FaultModel.none()` produces no session, and an engine built with it is
  bit-identical — outputs and per-(request, tile) OpCounts — to one with no
  fault layer, single launches and fused programs alike (property-tested,
  with no Hypothesis deadline: the first example pays JAX's warm-up).
* The fault draws are the JAX package's, draw for draw, for one seed: weak
  maps, column flips, accumulator corruption (applied here to tensors).
* Transient faults: every corruption detected (coverage 1.0), bounded
  retries restore exact outputs, the traces and prices equal JAX's.
* Persistent weak banks: quarantine, restage on healthy banks, host
  recompute, permanent degradation — the same ladder and counters as the
  JAX engine.
* No global RNG anywhere in the port's `core/pud/` (grep).
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import backends as j_backends
from repro.core.pud import faults as j_faults
from repro_torch.core import backends as t_backends
from repro_torch.core import engine as t_engine
from repro_torch.core.pud import faults as t_faults
from repro_torch.core.pud import gemv as t_gemv
from repro_torch.core.pud.residency import CapacityError, DramPool
from repro_torch.core.quant import QuantSpec
from test_torch_model import fresh_jax_caches  # noqa: F401
from test_torch_sim_program import Both, _run, _same

GEOM = dict(subarray_cols=32, n_sub_max=16, channels=2, banks_per_channel=2)
BIG = dict(subarray_cols=32, n_sub_max=16)


def _models(**kw):
    return j_faults.FaultModel(**kw), t_faults.FaultModel(**kw)


def _policies(**kw):
    return j_faults.FaultPolicy(**kw), t_faults.FaultPolicy(**kw)


def _faulty(geom, model, policy=None, **kw):
    """Both packages' engines under the same fault model and policy."""
    jm, tm = _models(**model)
    jp, tp = _policies(**(policy or {}))
    eng = Both(geom=geom, **kw)
    eng.j = type(eng.j)(geom=eng.j.geom, fault_model=jm, fault_policy=jp)
    eng.t = type(eng.t)(geom=eng.t.geom, fault_model=tm, fault_policy=tp)
    return eng


def _gemv(eng, name, x):
    to, tr = eng.t.gemv(name, torch.from_numpy(x), backend="sim")
    jo, jr = eng.j.gemv(name, jnp.asarray(x), backend=j_backends.SIM)
    return to, tr, jo, jr


def _same_trace(tr, jr):
    for f in ("corrupted", "detected", "retries", "retry_wave_ops",
              "unresolved", "unresolved_banks"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert tr.retry_counts.asdict() == jr.retry_counts.asdict()
    assert tr.coverage == jr.coverage


# ---------------------------------------------------------------------------
# The model, the session and its draws
# ---------------------------------------------------------------------------

def test_model_policy_and_session_basics():
    assert t_faults.FaultModel.none().session() is None
    assert not t_faults.FaultModel.none().enabled
    assert t_faults.FaultModel(transient_ber=0.1).session() is not None
    for field in ("transient_ber", "weak_cell_rate", "weak_flip_prob"):
        for bad in (1.5, -0.1):
            with pytest.raises(ValueError, match="probability"):
                t_faults.FaultModel(**{field: bad})
    with pytest.raises(ValueError, match="enabled"):
        t_faults.FaultSession(t_faults.FaultModel.none())
    assert t_faults.FaultPolicy() == t_faults.FaultPolicy(
        max_wave_retries=2, quarantine_after=2, degrade_after=2)
    m = t_faults.FaultModel(weak_cell_rate=0.2, seed=9)
    s1, s2 = m.session(), m.session()
    a1, b1 = s1.weak_mask(0, 3, 64), s1.weak_mask(1, 0, 64)
    b2, a2 = s2.weak_mask(1, 0, 64), s2.weak_mask(0, 3, 64)
    np.testing.assert_array_equal(a1, a2)      # visit order does not matter
    np.testing.assert_array_equal(b1, b2)


@pytest.mark.parametrize("model", [
    dict(transient_ber=0.3, seed=4),
    dict(weak_cell_rate=0.05, weak_flip_prob=0.5, seed=7),
    dict(transient_ber=0.2, weak_cell_rate=0.02, seed=11)])
def test_fault_draws_equal_jax(model):
    """One seed, the same sequence of calls: weak maps, column flips, wave
    flips and accumulator corruption (numpy arrays in the JAX package,
    tensors here) land on the same cells, with the same counters."""
    jm, tm = _models(**model)
    js, ts = jm.session(), tm.session()
    keys = np.array([[0, 0], [0, 1], [1, 3], [2, 5]])
    rng = np.random.default_rng(0)
    for step in range(3):
        np.testing.assert_array_equal(ts.weak_mask(1, step, 48),
                                      js.weak_mask(1, step, 48))
        np.testing.assert_array_equal(ts.flip_columns(48, 1, step),
                                      js.flip_columns(48, 1, step))
        np.testing.assert_array_equal(ts.flip_tiles(keys, 48),
                                      js.flip_tiles(keys, 48))
        acc = rng.integers(0, 1 << 12, size=(3, 4, 48))
        jacc, tacc = acc.copy(), torch.from_numpy(acc.copy())
        np.testing.assert_array_equal(ts.corrupt_accumulator(tacc, keys),
                                      js.corrupt_accumulator(jacc, keys))
        np.testing.assert_array_equal(tacc.numpy(), jacc)
        # every corrupted cell moved its column sum by exactly ±1
        moved = np.abs(tacc.numpy() - acc).sum(axis=-1)
        assert set(np.unique(moved)) <= {0, 1}
    assert ts.stats() == js.stats()


def test_trace_merge():
    a = t_faults.FaultTrace(corrupted=2, detected=2, retries=1,
                            retry_wave_ops=[5], unresolved=[(0, 0, 1)],
                            unresolved_banks=[(0, 1)])
    b = t_faults.FaultTrace(corrupted=1, detected=1, retries=2,
                            retry_wave_ops=[7, 9], unresolved=[(1, 2, 0)],
                            unresolved_banks=[(0, 1), (1, 0)])
    a.merge(b)
    assert (a.corrupted, a.detected, a.retries) == (3, 3, 3)
    assert a.retry_wave_ops == [5, 7, 9]
    assert a.unresolved == [(0, 0, 1), (1, 2, 0)]
    assert a.unresolved_banks == [(0, 1), (1, 0)]
    assert t_faults.FaultTrace().coverage == 1.0


# ---------------------------------------------------------------------------
# Faults off: bit-identical
# ---------------------------------------------------------------------------

def _register_random(eng, rng, layers):
    names = []
    for i in range(layers):
        q, p = int(rng.integers(2, 5)), int(rng.integers(1, 4))
        n, m = int(rng.integers(3, 40)), int(rng.integers(2, 3 * (32 // q)))
        eng.register(f"l{i}", torch.from_numpy(
            rng.normal(size=(n, m)).astype(np.float32)), QuantSpec(bits=q),
            a_spec=QuantSpec(bits=p))
        names.append(f"l{i}")
    return names


@settings(max_examples=6, deadline=None)
@given(layers=st.integers(1, 4), b=st.sampled_from([1, 2, 6]),
       seed=st.integers(0, 50))
def test_none_model_is_bit_identical(layers, b, seed):
    geom = t_gemv.PudGeometry(**GEOM)
    plain = t_engine.MVDRAMEngine(geom=geom)
    none = t_engine.MVDRAMEngine(geom=geom,
                                 fault_model=t_faults.FaultModel.none(),
                                 fault_policy=t_faults.FaultPolicy())
    assert none._fault_session is None
    n0 = _register_random(plain, np.random.default_rng(seed), layers)
    _register_random(none, np.random.default_rng(seed), layers)
    xs = [torch.from_numpy(np.random.default_rng(seed + 99 + i).normal(
        size=(b, plain.handles[n].plan.n)).astype(np.float32))
        for i, n in enumerate(n0)]
    for name, x in zip(n0, xs):
        o0, r0 = plain.gemv(name, x, backend="sim")
        o1, r1 = none.gemv(name, x, backend="sim")
        assert torch.equal(o0, o1) and r1.fault is None
        assert [[c.asdict() for c in r.tile_runtime] for r in r0.requests] \
            == [[c.asdict() for c in r.tile_runtime] for r in r1.requests]
    p0, p1 = plain.compile(n0), none.compile(n0)
    outs0, rep0 = p0.run(xs)
    outs1, rep1 = p1.run(xs)
    assert rep1.fault is None and rep1.retry_wave_ops == ()
    _same(outs0, rep0, outs1, rep1)
    c0 = plain.price_program(p0, batch=b, executed=rep0)
    c1 = none.price_program(p1, batch=b, executed=rep1)
    assert c0.asdict() == c1.asdict()
    assert c1.t_retry == 0.0 and c1.retry_waves == 0


# ---------------------------------------------------------------------------
# Transient faults: ABFT detection and retries
# ---------------------------------------------------------------------------

def test_transient_faults_detected_retried_exact_and_equal_to_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(48, 40)).astype(np.float32)
    x = rng.normal(size=(3, 48)).astype(np.float32)
    clean = Both(geom=GEOM)
    clean.register("w", w, 4, 4)
    out0, _r, _jo, _jr = _gemv(clean, "w", x)
    eng = _faulty(GEOM, dict(transient_ber=0.05, seed=7))
    eng.register("w", w, 4, 4)
    to, tr, jo, jr = _gemv(eng, "w", x)
    tt = tr.fault
    assert tt.corrupted > 0 and tt.detected == tt.corrupted
    assert tt.retries > 0 and not tt.unresolved
    assert len(tt.retry_wave_ops) == tt.retries
    _same_trace(tt, jr.fault)
    assert torch.equal(to, out0)          # a retry re-draws: exact again
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    stats = eng.t.residency_stats()
    assert stats == eng.j.residency_stats()
    assert stats["fault_corrupted"] == tt.corrupted
    assert stats["fault_retries"] == tt.retries
    assert stats["transient_injections"] >= tt.corrupted


def test_detection_coverage_over_many_launches():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    eng = _faulty(GEOM, dict(transient_ber=0.02, seed=13),
                  dict(max_wave_retries=3))
    eng.register("w", w, 4, 4)
    for _ in range(6):
        _gemv(eng, "w", x)
    stats = eng.t.residency_stats()
    assert stats == eng.j.residency_stats()
    assert stats["fault_corrupted"] >= 5
    assert stats["fault_detected"] == stats["fault_corrupted"]


def test_fused_program_retries_reconcile_into_price():
    rng = np.random.default_rng(12)
    eng = _faulty(GEOM, dict(transient_ber=0.3, seed=5),
                  dict(max_wave_retries=4, degrade_after=100))
    clean = Both(geom=GEOM)
    shapes = [(int(rng.integers(3, 40)), int(rng.integers(2, 20)))
              for _ in range(3)]
    for i, (n, m) in enumerate(shapes):
        w = rng.normal(size=(n, m)).astype(np.float32)
        eng.register(f"l{i}", w, 3, 2)
        clean.register(f"l{i}", w, 3, 2)
    names = [f"l{i}" for i in range(3)]
    jp, tp = eng.compile(names, groups=[[0, 1, 2]])
    _jc, tc = clean.compile(names, groups=[[0, 1, 2]])
    xs = [rng.normal(size=(2, n)).astype(np.float32) for n, _m in shapes]
    to, tr = _run(tp, xs)
    jo, jr = _run(jp, xs)
    co, cr = _run(tc, xs)
    _same(to, tr, jo, jr)
    _same_trace(tr.fault, jr.fault)
    assert tr.fault.corrupted > 0 and tr.fault.coverage == 1.0
    assert tr.retry_wave_ops == tuple(tr.fault.retry_wave_ops)
    if not tr.fault.unresolved:
        for a, b in zip(to, co):
            assert torch.equal(a, b)
    cost = eng.t.price_program(tp, batch=2, executed=tr)
    assert cost.asdict() == eng.j.price_program(jp, batch=2,
                                                executed=jr).asdict()
    costc = clean.t.price_program(tc, batch=2, executed=cr)
    assert cost.retry_waves == len(tr.fault.retry_wave_ops) > 0
    assert cost.t_retry == sum(tr.fault.retry_wave_ops) * eng.t.timing.t_op
    assert cost.t_total - cost.t_retry == pytest.approx(costc.t_total)
    assert cost.e_retry == eng.t.energy.ledger_energy(tr.retry_counts) > 0


def test_masked_fault_injection_draws_only_active_lanes():
    def build(b_max=None):
        eng = _faulty(GEOM, dict(transient_ber=5e-2, seed=11),
                      dict(max_wave_retries=4))
        wrng = np.random.default_rng(9)
        for i in range(2):
            eng.register(f"l{i}", wrng.normal(size=(32, 16)).astype(
                np.float32), 3, 2)
        return eng, eng.compile(["l0", "l1"], b_max=b_max)

    eng_m, (jpm, tpm) = build(b_max=3)
    _eng_c, (_jpc, tpc) = build()
    xs = [np.random.default_rng(3).normal(size=(3, 32)).astype(np.float32)
          for _ in range(2)]
    mask = np.array([True, False, True])
    om, rm = _run(tpm, xs, lane_mask=mask)
    jm, jr = _run(jpm, xs, lane_mask=mask)
    oc, rc = _run(tpc, [x[mask] for x in xs])
    _same(om, rm, jm, jr)
    for a, c in zip(om, oc):
        assert torch.equal(a[torch.from_numpy(mask)], c)
        assert not a[torch.from_numpy(~mask)].any()
    assert rm.fault.corrupted == rc.fault.corrupted > 0
    assert rm.retry_wave_ops == rc.retry_wave_ops


# ---------------------------------------------------------------------------
# Persistent faults: quarantine, restage, host recompute, degradation
# ---------------------------------------------------------------------------

def test_persistent_fault_quarantines_and_restages_clean():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(48, 40)).astype(np.float32)
    x = rng.normal(size=(3, 48)).astype(np.float32)
    clean = Both(geom=BIG)
    clean.register("w", w, 4, 4)
    outb, _r, _jo, _jr = _gemv(clean, "w", x)
    eng = _faulty(BIG, dict(weak_cell_rate=0.004, weak_flip_prob=1.0,
                            seed=11),
                  dict(max_wave_retries=1, quarantine_after=1,
                       degrade_after=8))
    eng.register("w", w, 4, 4)
    o1, r1, jo1, jr1 = _gemv(eng, "w", x)
    assert r1.fault.unresolved                  # sticky: retries can't fix
    _same_trace(r1.fault, jr1.fault)
    np.testing.assert_allclose(o1.numpy(), outb.numpy(), rtol=2e-5,
                               atol=1e-5)       # host recompute
    stats = eng.t.residency_stats()
    assert stats == eng.j.residency_stats()
    assert stats["fault_quarantines"] >= 1 and stats["fault_restages"] >= 1
    assert eng.t.pool.quarantined() == eng.j.pool.quarantined()
    assert eng.t.pool.is_resident("w")
    h = eng.t.handles["w"]
    assert not any(eng.t.pool.is_quarantined(*cb) for cb in h.placement.banks)
    o2, r2, jo2, jr2 = _gemv(eng, "w", x)
    assert r2.fault.corrupted == 0              # healthy banks now
    assert torch.equal(o2, outb)
    np.testing.assert_array_equal(o2.numpy(), np.asarray(jo2))
    assert not eng.t.is_degraded(h)


def test_fault_storm_degrades_to_the_reference_path():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(48, 40)).astype(np.float32)
    x = rng.normal(size=(3, 48)).astype(np.float32)
    eng = _faulty(GEOM, dict(weak_cell_rate=0.05, weak_flip_prob=1.0,
                             seed=3),
                  dict(max_wave_retries=1, quarantine_after=1,
                       degrade_after=2))
    eng.register("w", w, 4, 4)
    h = eng.t.handles["w"]
    ref = t_backends.REFERENCE.gemv(eng.t, h, torch.from_numpy(x))
    for _ in range(3):
        out, rep, _jo, _jr = _gemv(eng, "w", x)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                                   atol=1e-5)
        if eng.t.is_degraded(h):
            break
    assert eng.t.is_degraded(h) and eng.j.is_degraded("w")
    stats = eng.t.residency_stats()
    assert stats == eng.j.residency_stats()
    assert stats["degraded_layers"] == ["w"]
    out, rep = eng.t.gemv("w", torch.from_numpy(x), backend="sim")
    assert rep is None and torch.equal(out, ref)


def test_quarantine_bank_and_fault_keys_follow_restaging():
    geom = t_gemv.PudGeometry(**GEOM)
    pool = DramPool(geom)
    eng = t_engine.MVDRAMEngine(
        geom=geom, pool=pool,
        fault_model=t_faults.FaultModel(weak_cell_rate=0.05,
                                        weak_flip_prob=0.0, seed=3))
    w = torch.from_numpy(np.random.default_rng(4).normal(
        size=(20, 12)).astype(np.float32))
    h = eng.register("w", w, QuantSpec(bits=2), a_spec=QuantSpec(bits=2))
    st = eng.staged_for(h)
    for g in st.groups:                  # fault keys are the pool's homes
        np.testing.assert_array_equal(
            g.bank_keys, [h.placement.banks[t] for t in g.tiles_idx])
    victim = h.placement.banks[0]
    assert pool.quarantine_bank(*victim) == ["w"]
    assert eng.staged_for(h) is None     # evicted: the staged rows dropped
    h2 = eng.register("w", w, QuantSpec(bits=2), a_spec=QuantSpec(bits=2))
    assert victim not in set(h2.placement.banks)
    for g in eng.staged_for(h2).groups:
        np.testing.assert_array_equal(
            g.bank_keys, [h2.placement.banks[t] for t in g.tiles_idx])
    for c in range(geom.channels):
        for b in range(geom.banks_per_channel):
            pool.quarantine_bank(c, b)
    with pytest.raises(CapacityError, match="quarantined"):
        pool.place("w2", [16], 1)


# ---------------------------------------------------------------------------
# No global RNG
# ---------------------------------------------------------------------------

def test_no_global_rng_in_core_pud():
    """All randomness in the port's PUD layer flows through explicit seeded
    numpy Generators: numpy's legacy global-state entry points, the stdlib
    `random` module and torch's global generator are banned."""
    pud = pathlib.Path(__file__).resolve().parent.parent \
        / "src" / "repro_torch" / "core" / "pud"
    banned = re.compile(
        r"np\.random\.(?!default_rng\b|Generator\b)\w+"
        r"|numpy\.random\.(?!default_rng\b|Generator\b)\w+"
        r"|torch\.(rand|randn|randint|randperm|bernoulli|multinomial"
        r"|normal|manual_seed|seed)\b"
        r"|^\s*import random\b|^\s*from random import\b",
        re.MULTILINE)
    offenders = []
    for path in sorted(pud.glob("*.py")):
        for m in banned.finditer(path.read_text()):
            offenders.append(f"{path.name}: {m.group(0)}")
    assert not offenders, f"implicit global RNG in core/pud/: {offenders}"
    assert (pud / "faults.py").exists()
