"""Port parity: the DRAM fabric (`repro_torch.core.pud.fabric.FabricPool`)
and the engine's fabric programs (`MVDRAMEngine.compile` over a
`FabricPool`, `FabricProgram.price`) against the JAX package's, on the CPU.

Each scenario runs on both packages and records placements in global
coordinates, per-DIMM homes, `stats()` (per DIMM too), the spill ledger,
listener calls and the text of every error; the records must be EQUAL.
The scenarios are those of `tests/test_fabric.py` — striping, capacity and
residency errors, rebalancing from the hot module to the cold, the spill
tier with page-in — plus seeded random sequences of every fabric
operation. The engine side compiles the same registered block on both
packages (2 and 4 DIMMs, with and without the spill tier) and holds its
parts, groups and `FabricCost.asdict()` equal, floats exactly.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as j_engine
from repro.core import quant as j_quant
from repro.core.pud import fabric as j_fab
from repro.core.pud import residency as j_res
from repro.core.pud import schedule as j_sched
from repro_torch.core import engine as t_engine
from repro_torch.core import quant as t_quant
from repro_torch.core.pud import fabric as t_fab
from repro_torch.core.pud import residency as t_res
from repro_torch.core.pud import schedule as t_sched
from test_torch_model import fresh_jax_caches  # noqa: F401
from test_torch_residency import _try, _watch, obs

JAX = types.SimpleNamespace(fab=j_fab, res=j_res, sched=j_sched,
                            engine=j_engine, quant=j_quant,
                            tensor=lambda w: jnp.asarray(w))
PORT = types.SimpleNamespace(fab=t_fab, res=t_res, sched=t_sched,
                             engine=t_engine, quant=t_quant,
                             tensor=lambda w: torch.from_numpy(w))


def _tiny(m, **kw):
    return m.sched.PudGeometry(**{**dict(
        subarray_rows=64, subarray_cols=32, n_sub_max=16, channels=1,
        banks_per_channel=2, subarrays_per_bank=1), **kw})


def _record(pool):
    return [obs(pool.stats()), obs(pool.placements),
            {n: pool.dimm_of(n) for n in pool.placements},
            pool.spilled(), [obs(pool.spill_entry(n)) for n in pool.spilled()],
            pool.spill_ledger(), pool.quarantined(), pool.utilization]


def _both(scenario):
    j, t = scenario(JAX), scenario(PORT)
    assert j == t
    return t


# ---------------------------------------------------------------------------
# FabricPool scenarios
# ---------------------------------------------------------------------------

def _striping_and_errors(m):
    log = []
    pool = m.fab.FabricPool(geom=_tiny(m), dimms=2, compute_reserve=10)
    _watch(pool, log)
    for name in "abcd":
        _try(log, pool.place, name, [16], 1)
    _try(log, pool.place, "e", [16, 16], 1)                 # capacity
    _try(log, pool.evict, "ghost")
    _try(log, pool.place, "a", [16], 1)
    _try(log, pool.spill, "ghost")
    _try(log, pool.restage, "a")
    _try(log, pool.quarantine_bank, 7, 0)
    _try(log, pool.place, "x", [16], 1, on_full="bogus")
    _try(log, pool.place, "x", [4], 1, dimm=5)
    _try(log, pool.place, "a", [4], 1, replace=True, dimm=1)
    _try(log, m.fab.FabricPool, dimms=0)
    log += [pool.is_quarantined(9, 0), m.fab.requested_rows([16, 3], 2),
            pool.bank_capacity, pool.total_rows] + _record(pool)
    return log


def _rebalance(m):
    log = []
    pool = m.fab.FabricPool(geom=_tiny(m), dimms=2, compute_reserve=10)
    _watch(pool, log)
    for i in range(2):
        pool.place(f"l{i}", [16], 1, dimm=0)
    log.append(obs(pool.rebalance(max_spread=0.25)))
    log += _record(pool)
    pool.place("l2", [4], 1, dimm=1)
    pool.quarantine_bank(1, 1)
    log.append(obs(pool.compact()))
    log += _record(pool)
    return log


def _spill_tier(m):
    log = []
    pool = m.fab.FabricPool(geom=_tiny(m), dimms=1, compute_reserve=10)
    _watch(pool, log)
    for i in range(4):
        _try(log, pool.place, f"l{i}", [16], 1, on_full="spill")
    log += _record(pool)
    for name in ("l0", "l1", "l0"):
        _try(log, pool.restage, name)
        log += _record(pool)
    _try(log, pool.evict, pool.spilled()[0])            # tier-only evict
    hot = sorted(pool.placements)[0]
    pool.placements[hot] = dataclasses.replace(pool.placements[hot],
                                               pinned=True)
    _try(log, pool.spill, hot)
    _try(log, pool.place, "l9", [16], 1, on_full="evict")
    log += _record(pool)
    return log


@pytest.mark.parametrize("scenario", [_striping_and_errors, _rebalance,
                                      _spill_tier])
def test_fabric_scenarios_match(scenario):
    _both(scenario)


@pytest.mark.parametrize("seed", range(4))
def test_fabric_random_operations_match(seed):
    """Seeded place (raise/evict/spill, pinned to a DIMM or not), evict,
    touch, spill, restage, quarantine, compact and rebalance sequences on
    3 DIMMs: the same record at every step."""
    def run(m):
        rng = np.random.default_rng(seed)
        pool = m.fab.FabricPool(geom=_tiny(m, subarrays_per_bank=2),
                                dimms=3, compute_reserve=10)
        log = []
        _watch(pool, log)
        names = [f"t{i}" for i in range(10)]
        for _step in range(50):
            op = int(rng.integers(0, 9))
            name = names[int(rng.integers(0, len(names)))]
            rows = [int(r) for r in rng.integers(1, 17,
                                                 int(rng.integers(1, 3)))]
            if op <= 2:
                dimm = int(rng.integers(0, 3)) if rng.integers(0, 3) == 0 \
                    else None
                _try(log, pool.place, name, rows, 1,
                     replace=pool.is_resident(name),
                     on_full=("raise", "evict", "spill")[op], dimm=dimm)
            elif op == 3:
                _try(log, pool.evict, name)
            elif op == 4:
                pool.touch(name)
            elif op == 5:
                _try(log, pool.spill, name)
            elif op == 6:
                _try(log, pool.restage, name)
            elif op == 7:
                _try(log, pool.quarantine_bank, int(rng.integers(0, 3)),
                     int(rng.integers(0, 2)))
            else:
                log.append(obs(pool.compact() if rng.integers(0, 2)
                               else pool.rebalance(max_spread=0.1)))
            log += _record(pool)
        return log
    _both(run)


# ---------------------------------------------------------------------------
# the engine on a fabric: compile into parts, price them
# ---------------------------------------------------------------------------

# ragged reduction and column chunks and mixed q/p, as tests/test_fabric.py
_BLOCK = [("a", 40, 24, 4, 4), ("b", 40, 24, 4, 4), ("c", 40, 36, 2, 4),
          ("d", 24, 40, 4, 2), ("e", 16, 8, 4, 4), ("f", 16, 8, 3, 4)]


def _fabric_engine(m, dimms, spill, seed=3):
    geom = m.sched.PudGeometry(subarray_cols=32, n_sub_max=16, channels=2,
                               banks_per_channel=2)
    if spill:      # a thin row budget: only some of the block stays hot
        geom = dataclasses.replace(geom, subarray_rows=160,
                                   subarrays_per_bank=1)
    pool = m.fab.FabricPool(geom=geom, dimms=dimms,
                            compute_reserve=10 if spill else None)
    eng = m.engine.MVDRAMEngine(geom=geom, pool=pool,
                                on_full="spill" if spill else "raise")
    rng = np.random.default_rng(seed)
    for nm, n, mm, q, p in _BLOCK:
        w = rng.normal(size=(n, mm)).astype(np.float32)
        eng.register(nm, m.tensor(w), m.quant.QuantSpec(bits=q),
                     a_spec=m.quant.QuantSpec(bits=p))
    return eng


@pytest.mark.parametrize("dimms,spill", [(1, True), (2, False), (2, True),
                                         (4, False)])
def test_fabric_program_parts_and_price_match(dimms, spill):
    def run(m):
        eng = _fabric_engine(m, dimms, spill)
        prog = eng.compile([nm for nm, *_ in _BLOCK],
                           groups=[[0, 1, 2], [3], [4, 5]], b_max=3)
        log = [type(prog).__name__, prog.layers, obs(eng.residency_stats())]
        for part in prog.parts:
            log += [part.indices, part.groups,
                    [h.name for h in part.handles],
                    None if part.prog is None else obs(part.prog.sched)]
        for batch in (1, 2, 3):
            for cols in (None, 65536):
                log.append(obs(prog.price(batch=batch,
                                          usable_cols=cols).asdict()))
        log.append(obs(prog.price(bit_density=0.25, batch=2).asdict()))
        return log
    out = _both(run)
    assert out[0] == "FabricProgram"


def test_price_fabric_needs_a_fabric_and_compile_errors():
    def run(m):
        geom = m.sched.PudGeometry(subarray_cols=32, n_sub_max=16)
        eng = m.engine.MVDRAMEngine(geom=geom)
        w = np.ones((16, 8), np.float32)
        for nm in ("a", "b"):
            eng.register(nm, m.tensor(w), m.quant.QuantSpec(bits=2),
                         a_spec=m.quant.QuantSpec(bits=4))
        log = []
        prog = eng.compile(["a", "b"])
        fab = m.engine.MVDRAMEngine(
            geom=geom, pool=m.fab.FabricPool(geom=geom, dimms=2))
        for nm in ("a", "b"):
            fab.register(nm, m.tensor(w), m.quant.QuantSpec(bits=2),
                         a_spec=m.quant.QuantSpec(bits=4))
        fprog = fab.compile(["a", "b"])
        _try(log, eng.price_fabric, fprog)
        _try(log, eng.compile, [])
        _try(log, eng.compile, ["a", "a"])
        _try(log, eng.compile, ["a"], b_max=0)
        eng.evict("a")
        _try(log, eng.compile, ["a", "b"])
        fab.evict("b")
        _try(log, fab.compile, ["a", "b"])
        log.append(obs(prog.price().asdict()))
        return log
    _both(run)
