"""Port parity: the DRAM residency session's host side
(`repro_torch.core.pud`: geometry, layouts, the §VII schedules, `DramPool`)
and the engine's placement (`repro_torch.core.engine.MVDRAMEngine`)
against the JAX package's, on the CPU.

Every scenario runs twice, once on each package's modules, and records
what it observes: placements with their banks and row spans, `stats()`,
listener calls, schedules slot by slot, and the text of every error
raised. The two records must be EQUAL — integers, tuples and strings
exactly (nothing here is a float but utilization, itself a ratio of the
same integers). The scenarios are those of `tests/test_residency.py`,
plus seeded random sequences of every pool operation.
"""
import dataclasses
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as j_engine
from repro.core.bitplane import from_quantized as j_fq
from repro.core import quant as j_quant
from repro.core.pud import layout as j_layout
from repro.core.pud import residency as j_res
from repro.core.pud import schedule as j_sched
from repro_torch.core import engine as t_engine
from repro_torch.core import quant as t_quant
from repro_torch.core.bitplane import from_quantized as t_fq
from repro_torch.core.bitplane import to_quantized
from repro_torch.core.pud import layout as t_layout
from repro_torch.core.pud import residency as t_res
from repro_torch.core.pud import schedule as t_sched
from test_torch_model import fresh_jax_caches  # noqa: F401


def _pkg(res, sched, layout):
    return types.SimpleNamespace(
        DramPool=res.DramPool, RowSpan=res.RowSpan,
        CapacityError=res.CapacityError, ResidencyError=res.ResidencyError,
        tile_resident_rows=res.tile_resident_rows,
        PudGeometry=sched.PudGeometry, schedule_tiles=sched.schedule_tiles,
        schedule_batch=sched.schedule_batch,
        schedule_program=sched.schedule_program, layout=layout)


JAX = _pkg(j_res, j_sched, j_layout)
PORT = _pkg(t_res, t_sched, t_layout)


def obs(x):
    """A package-neutral record of `x`: dataclasses by type name and
    fields, containers element by element, exceptions by type and text."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, obs(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return ("dict",) + tuple((obs(k), obs(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return tuple(obs(v) for v in x)
    if isinstance(x, BaseException):
        return (type(x).__name__, str(x))
    return x


def _both(scenario):
    """The scenario's record on the JAX package and on the port."""
    return scenario(JAX), scenario(PORT)


def _try(log, fn, *args, **kw):
    """Call fn, logging its result or the error it raised."""
    try:
        out = fn(*args, **kw)
    except (ValueError, KeyError) as e:
        log.append(obs(e))
        return None
    log.append(obs(out))
    return out


def _tiny(m, **kw):
    return m.PudGeometry(**{**dict(subarray_rows=64, subarray_cols=32,
                                   n_sub_max=16, channels=2,
                                   banks_per_channel=2,
                                   subarrays_per_bank=1), **kw})


def _watch(pool, log):
    pool.evict_listeners.append(lambda n, p: log.append(("evict", n, obs(p))))
    pool.move_listeners.append(
        lambda n, o, new: log.append(("move", n, obs(o), obs(new))))


# ---------------------------------------------------------------------------
# PudGeometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    dict(channels=0), dict(subarray_rows=-512), dict(n_sub_max=0),
    dict(banks_per_channel=-1), dict(subarray_cols=0),
    dict(subarrays_per_bank=0), dict(real_cols=0), dict(channels=2.5),
    dict(banks_per_channel=True),
])
def test_geometry_validation_matches(bad):
    errs = []
    for m in (JAX, PORT):
        with pytest.raises(ValueError, match="positive int") as e:
            m.PudGeometry(**bad)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_geometry_frozen_hashable_and_derived():
    g = PORT.PudGeometry(subarray_cols=64, n_sub_max=32)
    assert g == PORT.PudGeometry(subarray_cols=64, n_sub_max=32)
    assert {g: 1}[PORT.PudGeometry(subarray_cols=64, n_sub_max=32)] == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        g.channels = 8
    j = JAX.PudGeometry(subarray_cols=64, n_sub_max=32)
    for attr in ("parallel_tiles", "banks", "bank_rows"):
        assert getattr(g, attr) == getattr(j, attr)
    assert obs(g) == obs(j)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_sub", [1, 2, 16, 100, 128])
@pytest.mark.parametrize("q,p", [(1, 1), (2, 4), (4, 4), (8, 8)])
def test_layouts_match(n_sub, q, p):
    def run(m):
        log = [m.layout.accumulator_width(n_sub, p),
               obs(m.layout.horizontal_capacity_report(n_sub, q, p)),
               obs(m.layout.VerticalLayout(n_sub=n_sub, m_sub=3, q=q, p=p))]
        lay = _try(log, m.layout.HorizontalLayout, n_sub=n_sub,
                   m_sub=max(1, 64 // q), q=q, p=p)
        if lay is not None:
            log += [lay.r, lay.rows_used, lay.cols_used, lay.col(2, q - 1),
                    lay.matrix_rows, lay.acc_rows, lay.scratch5,
                    obs(lay.capacity_breakdown())]
        _try(log, m.layout.HorizontalLayout, n_sub=n_sub, m_sub=2000, q=q,
             p=p)
        return log
    j, t = _both(run)
    assert j == t


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def _schedule_record(sched):
    return [obs(sched), sched.layers, sched.tiles, sched.waves,
            sched.waves_unfused, sched.waves_shared,
            [obs(sched.wave_members(w)) for w in range(sched.waves)],
            [obs(sched.layer_slots(l)) for l in range(sched.layers)]]


@pytest.mark.parametrize("seed", range(4))
def test_schedule_program_matches(seed):
    """Seeded grids, concurrency groups and explicit per-tile placements
    (and the default continuing rotation): the same slots, waves and
    `waves_shared`."""
    rng = np.random.default_rng(seed)
    layers = int(rng.integers(1, 7))
    grids = [(int(rng.integers(1, 5)), int(rng.integers(1, 6)))
             for _ in range(layers)]
    order = list(rng.permutation(layers))
    groups, i = [], 0
    while i < layers:
        k = int(rng.integers(1, 4))
        groups.append([int(x) for x in order[i:i + k]])
        i += k

    def run(m):
        geom = m.PudGeometry(channels=int(rng_c), banks_per_channel=int(rng_b))
        banks = [[(int(c), int(b)) for c, b in zip(
            prng.integers(0, geom.channels, n * cc),
            prng.integers(0, geom.banks_per_channel, n * cc))]
            for n, cc in grids]
        log = _schedule_record(m.schedule_program(grids, geom))
        log += _schedule_record(m.schedule_program(grids, geom,
                                                   groups=groups))
        log += _schedule_record(m.schedule_program(
            grids, geom, groups=groups, placements=banks))
        _try(log, m.schedule_program, grids, geom, groups=groups[:-1])
        for n, cc in grids:
            ws = m.schedule_tiles(n, cc, geom)
            log += [obs(ws), ws.tiles, ws.waves,
                    [obs(ws.wave_members(w)) for w in range(ws.waves)]]
            bs = m.schedule_batch(n, cc, 3, geom)
            log += [bs.tiles, bs.waves, bs.weight_loads,
                    bs.unshared_weight_loads, bs.reuse_factor]
        _try(log, m.schedule_batch, 2, 2, 0, geom)
        return log

    rng_c, rng_b = rng.integers(1, 4), rng.integers(1, 5)
    prng = np.random.default_rng(seed + 100)
    j = run(JAX)
    prng = np.random.default_rng(seed + 100)
    t = run(PORT)
    assert j == t


# ---------------------------------------------------------------------------
# DramPool: the scenarios of tests/test_residency.py
# ---------------------------------------------------------------------------

def _full_then_lru(m):
    log = []
    one = dataclasses.replace(_tiny(m), channels=1, banks_per_channel=1)
    pool = m.DramPool(one, compute_reserve=10)
    _watch(pool, log)
    for name in ("a", "b", "c", "d", "e"):
        _try(log, pool.place, name, [4], 1)
    _try(log, pool.place, "f", [4], 1, on_full="raise")
    pool.touch("a")
    _try(log, pool.place, "f", [4], 1, on_full="evict")
    _try(log, pool.place, "g", [4], 1, on_full="bogus")
    _try(log, pool.place, "h", [], 1)
    log += [obs(pool.stats()), pool.free_rows, pool.bank_capacity]
    multi = m.DramPool(_tiny(m), compute_reserve=10)
    _watch(multi, log)
    for name in ("p", "q", "r", "s", "t"):
        _try(log, multi.place, name, [16], 1, on_full="evict")
    log += [obs(multi.stats()), obs(multi.placements)]
    return log


def _reservations(m):
    log = []
    pool = m.DramPool(_tiny(m), compute_reserve=10)
    RS = m.RowSpan
    _try(log, pool.reserve, "pinned", [RS(channel=0, bank=0, row0=0,
                                          rows=20)])
    _try(log, pool.reserve, "intruder", [RS(channel=0, bank=0, row0=10,
                                            rows=20)])
    _try(log, pool.reserve, "neighbor", [RS(channel=0, bank=0, row0=20,
                                            rows=10)])
    _try(log, pool.reserve, "tall", [RS(channel=1, bank=0, row0=50,
                                        rows=20)])
    _try(log, pool.reserve, "pinned", [RS(channel=1, bank=1, row0=0,
                                          rows=2)])
    _try(log, pool.place, "auto", [8], 1)
    _try(log, pool.place, "auto", [16], 1)
    _try(log, pool.place, "auto", [8], 2, replace=True)
    _try(log, pool.evict, "nobody")
    log += [obs(pool.stats()), obs(pool.placements), pool.replacements,
            [pool.can_place([c], 1) for c in (1, 4, 8, 16, 20)],
            pool.can_place([], 1)]
    return log


def _compaction(m):
    log = []
    one = dataclasses.replace(_tiny(m), channels=1, banks_per_channel=1)
    pool = m.DramPool(one, compute_reserve=10)
    _watch(pool, log)
    for name in ("a", "b", "c", "d", "e"):
        pool.place(name, [4], 1)
    pool.evict("b")
    pool.evict("d")
    _try(log, pool.place, "big", [8], 1, on_full="raise")
    log.append(obs(pool.compact()))
    _try(log, pool.place, "big", [8], 1, on_full="raise")
    log.append(obs(pool.stats()))
    pins = m.DramPool(one, compute_reserve=10)
    _watch(pins, log)
    pins.reserve("pin", [m.RowSpan(channel=0, bank=0, row0=14, rows=10)])
    pins.place("a", [4], 1)
    pins.place("b", [4], 1)
    pins.evict("a")
    log.append(obs(pins.compact()))
    _try(log, pins.place, "c", [4], 1)
    log += [obs(pins.placements), obs(pins.stats())]
    return log


def _quarantine(m):
    log = []
    pool = m.DramPool(_tiny(m), compute_reserve=10)
    _watch(pool, log)
    for i in range(3):
        pool.place(f"l{i}", [8], 2)
    log.append(pool.quarantine_bank(0, 1))
    log.append(pool.quarantine_bank(0, 1))              # idempotent
    _try(log, pool.quarantine_bank, 5, 0)
    log += [pool.quarantined(), pool.is_quarantined(0, 1)]
    _try(log, pool.reserve, "x", [m.RowSpan(channel=0, bank=1, row0=0,
                                            rows=2)])
    for i in range(3, 6):
        _try(log, pool.place, f"l{i}", [8], 1, on_full="evict")
    for c, b in ((0, 0), (1, 0), (1, 1)):
        pool.quarantine_bank(c, b)
    _try(log, pool.place, "none", [4], 1)
    log += [pool.can_place([4], 1), obs(pool.stats()),
            obs(pool.placements)]
    return log


@pytest.mark.parametrize("scenario", [_full_then_lru, _reservations,
                                      _compaction, _quarantine])
def test_pool_scenarios_match(scenario):
    j, t = _both(scenario)
    assert j == t
    assert len(j) > 5


@pytest.mark.parametrize("seed", range(3))
def test_pool_random_operations_match(seed):
    """Seeded sequences of place (raise/evict, replace), reserve, evict,
    touch, compact, quarantine and can_place: the same record at every
    step."""
    def run(m):
        rng = np.random.default_rng(seed)
        geom = _tiny(m, subarrays_per_bank=2)
        pool = m.DramPool(geom, compute_reserve=int(rng.integers(8, 20)))
        log = []
        _watch(pool, log)
        names = [f"w{i}" for i in range(8)]
        for step in range(60):
            op = int(rng.integers(0, 8))
            name = names[int(rng.integers(0, len(names)))]
            rows = [int(r) for r in rng.integers(1, 17,
                                                 int(rng.integers(1, 4)))]
            cc = int(rng.integers(1, 3))
            if op <= 2:
                _try(log, pool.place, name, rows, cc,
                     replace=bool(rng.integers(0, 2)),
                     on_full=("raise", "evict")[op % 2])
            elif op == 3:
                _try(log, pool.evict, name)
            elif op == 4:
                pool.touch(name)
            elif op == 5:
                log.append(obs(pool.compact()))
            elif op == 6:
                _try(log, pool.quarantine_bank,
                     int(rng.integers(0, geom.channels + 1)),
                     int(rng.integers(0, geom.banks_per_channel)))
            else:
                _try(log, pool.reserve, name, [m.RowSpan(
                    channel=int(rng.integers(0, geom.channels)),
                    bank=int(rng.integers(0, geom.banks_per_channel)),
                    row0=int(rng.integers(0, 80)),
                    rows=int(rng.integers(1, 20)))])
            log += [pool.can_place(rows, cc), obs(pool.stats())]
        log.append(obs(pool.placements))
        return log
    j, t = _both(run)
    assert j == t


# ---------------------------------------------------------------------------
# the engine's placement
# ---------------------------------------------------------------------------

GEOM = dict(subarray_cols=32, n_sub_max=16, channels=2, banks_per_channel=2)


def _engines(**kw):
    return (j_engine.MVDRAMEngine(geom=j_sched.PudGeometry(**GEOM), **kw),
            t_engine.MVDRAMEngine(geom=t_sched.PudGeometry(**GEOM), **kw))


def _handle_record(h):
    return [h.name, obs(h.plan), obs(h.templates), obs(h.placement),
            None if h.a_spec is None else h.a_spec.bits]


def _leaf_pair(rng, n, m, q):
    w = rng.normal(size=(n, m)).astype(np.float32)
    jq = j_quant.quantize_weights(jnp.asarray(w), j_quant.QuantSpec(bits=q))
    tq = t_quant.quantize_weights(torch.from_numpy(w),
                                  t_quant.QuantSpec(bits=q))
    return w, jq, tq


def test_engine_register_places_like_jax(rng):
    """register and register_packed, float and quantized activations,
    ragged shapes: the same plans, templates, placements and pool
    stats; re-registration replaces; eviction and compaction reach the
    handles through the pool's listeners."""
    je, te = _engines(on_full="evict")
    shapes = [(40, 12, 4, 4), (16, 40, 2, 3), (100, 7, 3, None),
              (33, 20, 4, 2)]
    for i, (n, m, q, p) in enumerate(shapes):
        w = rng.normal(size=(n, m)).astype(np.float32)
        jh = je.register(f"l{i}", jnp.asarray(w), j_quant.QuantSpec(bits=q),
                         a_spec=p and j_quant.QuantSpec(bits=p))
        th = te.register(f"l{i}", torch.from_numpy(w),
                         t_quant.QuantSpec(bits=q),
                         a_spec=p and t_quant.QuantSpec(bits=p))
        assert _handle_record(jh) == _handle_record(th)
        np.testing.assert_array_equal(np.asarray(jh.wq.values),
                                      th.wq.values.numpy())
    # packed leaves: the same placements, codes recovered only on demand
    for i, (n, m, q, p) in enumerate(shapes[:2]):
        w, jq, tq = _leaf_pair(rng, n, m, q)
        jh = je.register_packed(f"p{i}", j_fq(jq), j_quant.QuantSpec(bits=p))
        th = te.register_packed(f"p{i}", t_fq(tq), t_quant.QuantSpec(bits=p))
        assert th._wq is None                      # nothing recovered yet
        assert _handle_record(jh) == _handle_record(th)
        wq = th.wq
        assert th.wq is wq                          # computed once, kept
        np.testing.assert_array_equal(wq.values.numpy(),
                                      np.asarray(jh.wq.values))
        np.testing.assert_array_equal(
            wq.values.numpy(), to_quantized(th.weights).values.numpy())
    assert je.residency_stats() == te.residency_stats()
    assert je.storage_bytes("l1") == te.storage_bytes("l1")
    assert je.price("l0") == te.price("l0")
    # replace, evict, compact
    for e in (je, te):
        e.evict("l1")
        e.pool.compact()
    for name in je.handles:
        assert _handle_record(je.handles[name]) == \
            _handle_record(te.handles[name])
    assert je.handles["l1"].placement is None
    assert je.residency_stats() == te.residency_stats()
    with pytest.raises(ValueError, match="2-D weight leaf"):
        te.register_packed("bad", te.handles["l0"].weights.__class__(
            planes=torch.zeros((2, 2, 1, 4), dtype=torch.int32),
            scale=torch.ones(2, 1, 4), zero=2,
            col_sum=torch.zeros(2, 4, dtype=torch.int32), n=32,
            spec=t_quant.QuantSpec(bits=2)), t_quant.QuantSpec(bits=4))


def test_leaf_identity_one_rule_and_reregistration(rng):
    """The engine finds a placed leaf again by `leaf_key` (where its planes
    and scales lie, and the planes' shape — the rule `packed_group` keys
    its member tables by), holding the leaf; re-registering a name under
    other weights drops the old entry with the old placement, and an
    eviction prunes the name."""
    te = t_engine.MVDRAMEngine(geom=t_sched.PudGeometry(**GEOM))
    a = t_fq(_leaf_pair(rng, 64, 16, 2)[2])
    b = t_fq(_leaf_pair(rng, 64, 16, 2)[2])
    spec = t_quant.QuantSpec(bits=4)
    te.register_packed("w", a, spec)
    key_a = t_engine.leaf_key(a) + (4,)
    assert te._leaf_names[key_a][0] == "w" and te._leaf_names[key_a][1] is a
    # a view of the same storage has the same identity
    view = dataclasses.replace(a, planes=a.planes[:], scale=a.scale[:])
    assert t_engine.leaf_key(view) == t_engine.leaf_key(a)
    first = te.handles["w"].placement
    te.register_packed("w", b, spec)                 # re-registration
    assert key_a not in te._leaf_names
    assert te._leaf_names[t_engine.leaf_key(b) + (4,)][0] == "w"
    assert te.pool.replacements == 1
    assert first is not te.handles["w"].placement
    assert len(te._leaf_names) == 1
    te.evict("w")
    assert te._leaf_names == {} and te.handles["w"].placement is None
    # the member-table cache follows the same rule
    tab = te.packed_group([a, b], 4)
    assert te.packed_group([view, b], 4) is tab


def test_new_modules_import_no_jax():
    """Importing the residency session, its pricing and the serving path
    loads neither JAX nor the JAX package; the TPU constants stay
    behind."""
    code = ("import sys; import repro_torch.core.pud, "
            "repro_torch.core.engine, repro_torch.serve.engine, "
            "repro_torch.serve.scheduler; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
    from repro_torch.core.pud import timing
    assert not hasattr(timing, "TPU_V5E") and not hasattr(timing, "TpuV5e")
