"""Port parity: the DDR4 pricing (`repro_torch.core.pud.gemv`'s cost models
and `repro_torch.core.pud.timing`) against the JAX package's, on the CPU.

The pricing is host arithmetic in Python floats, ported in the JAX
package's order, so every cost is held EQUAL — `asdict()` of every
`GemvCost`, `PudCost`, `BatchedPudCost`, `ProgramCost` and `FabricCost`,
floats compared exactly — over a grid of (m, n, q, p, bit density,
sparsity, batch, usable columns, geometry), and on programs priced with
spill traffic, the flat and per-command energy models and the CXL tier.
"""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.core.pud import gemv as j_gemv
from repro.core.pud import schedule as j_sched
from repro.core.pud import timing as j_timing
from repro_torch.core.pud import adder as t_adder
from repro_torch.core.pud import gemv as t_gemv
from repro_torch.core.pud import schedule as t_sched
from repro_torch.core.pud import timing as t_timing
from repro.core.pud import adder as j_adder
from test_torch_residency import obs

SHAPES = [(32000, 4096), (4096, 4096), (11008, 4096), (4096, 11008),
          (7, 300), (130, 129), (1, 1)]
BITS = [(2, 1), (2, 4), (4, 4), (3, 8), (8, 2)]
GEOMS = [dict(), dict(channels=2, banks_per_channel=3, n_sub_max=64),
         dict(subarray_cols=32, n_sub_max=16, channels=2,
              banks_per_channel=2)]


def _geoms(i):
    return j_sched.PudGeometry(**GEOMS[i]), t_sched.PudGeometry(**GEOMS[i])


def test_adder_and_templates_match():
    for chain in range(0, 40):
        assert obs(j_adder.adder_cost(chain)) == obs(t_adder.adder_cost(chain))
    for n_sub, p in itertools.product((1, 2, 16, 100, 128), range(1, 9)):
        assert obs(j_gemv.build_templates(n_sub, p)) == \
            obs(t_gemv.build_templates(n_sub, p))
    for n_sub, q, p, d, sp in itertools.product(
            (1, 16, 128), (1, 2, 4), (1, 4, 8), (0.0, 0.3, 0.5, 1.0),
            (True, False)):
        assert obs(j_gemv.mvdram_tile_cost(n_sub, q, p, d, sp)) == \
            obs(t_gemv.mvdram_tile_cost(n_sub, q, p, d, sp))


@pytest.mark.parametrize("gi", range(len(GEOMS)))
@pytest.mark.parametrize("m,n", SHAPES)
def test_gemv_costs_and_prices_match(m, n, gi):
    jg, tg = _geoms(gi)
    for (q, p), d, sp, cols in itertools.product(
            BITS, (0.25, 0.5, 1.0), (True, False), (None, 1024, 4096)):
        jc = j_gemv.mvdram_gemv_cost(m, n, q, p, d, sp, jg, usable_cols=cols)
        tc = t_gemv.mvdram_gemv_cost(m, n, q, p, d, sp, tg, usable_cols=cols)
        assert obs(jc) == obs(tc)
        assert j_timing.price_gemv(jc, jg).asdict() == \
            t_timing.price_gemv(tc, tg).asdict()
        for batch in (1, 3, 4):
            assert j_timing.price_gemv_batched(jc, batch, jg).asdict() == \
                t_timing.price_gemv_batched(tc, batch, tg).asdict()
    for q, p in BITS:
        jc = j_gemv.conventional_pud_cost(m, n, q, p, 0.5, jg)
        tc = t_gemv.conventional_pud_cost(m, n, q, p, 0.5, tg)
        assert obs(jc) == obs(tc)
        assert j_timing.price_gemv(jc, jg).asdict() == \
            t_timing.price_gemv(tc, tg).asdict()
        assert j_timing.compare_gemv(m, n, q, p, geom=jg) == \
            t_timing.compare_gemv(m, n, q, p, geom=tg)
    assert j_timing.bank_waves(m * n % 9000 + 1, jg) == \
        t_timing.bank_waves(m * n % 9000 + 1, tg)


def test_constants_and_models_match():
    """The paper's calibrated DDR4, i7-9700K, Jetson, energy and CXL
    constants are carried over as they are."""
    for name in ("DDR4_2400", "DDR4_ENERGY", "LPDDR5_CDPIM", "CXL_TIER"):
        assert obs(getattr(j_timing, name)) == obs(getattr(t_timing, name))
    assert obs(j_timing.CpuBaseline()) == obs(t_timing.CpuBaseline())
    assert obs(j_timing.GpuBaseline()) == obs(t_timing.GpuBaseline())
    for m, n, q, p in ((32000, 4096, 2, 1), (4096, 4096, 4, 4)):
        for cls in ("CpuBaseline", "GpuBaseline"):
            j, t = getattr(j_timing, cls)(), getattr(t_timing, cls)()
            assert j.gemv_time(m, n, q, p) == t.gemv_time(m, n, q, p)
            assert j.gemv_energy(m, n, q, p) == t.gemv_energy(m, n, q, p)
    for model in ("DDR4_ENERGY", "LPDDR5_CDPIM"):
        j, t = getattr(j_timing, model), getattr(t_timing, model)
        for attr in ("e_row_copy", "e_maj3", "e_maj5", "e_majx_other"):
            assert getattr(j, attr) == getattr(t, attr)
    assert obs(j_timing.EnergyModel.zero()) == obs(t_timing.EnergyModel.zero())
    for bits, restages in ((0, None), (10_000, None), (10_000, 3), (0, 2)):
        assert j_timing.CXL_TIER.restage_time(bits, restages) == \
            t_timing.CXL_TIER.restage_time(bits, restages)
    for pkg in (j_timing, t_timing):
        with pytest.raises(ValueError, match="negative restage"):
            pkg.CXL_TIER.restage_time(-1)
    rng = np.random.default_rng(0)
    for _ in range(20):
        waves = [float(x) for x in rng.random(int(rng.integers(1, 8)))]
        layers = int(rng.integers(1, 6))
        first = [int(x) for x in rng.integers(0, len(waves), layers)]
        enc = [float(x) for x in rng.random(layers)]
        assert j_timing._encode_timeline(waves, first, enc) == \
            t_timing._encode_timeline(waves, first, enc)


def _program_inputs(pkg_gemv, pkg_sched, geom, seed):
    rng = np.random.default_rng(seed)
    layers = int(rng.integers(1, 7))
    shapes = [(int(rng.integers(1, 300)), int(rng.integers(1, 300)),
               int(rng.integers(1, 5)), int(rng.integers(1, 9)))
              for _ in range(layers)]
    costs = [pkg_gemv.mvdram_gemv_cost(m, n, q, p, 0.5, True, geom,
                                       usable_cols=geom.subarray_cols)
             for m, n, q, p in shapes]
    grids = [(c.tiles // max(1, -(-m // (geom.subarray_cols // q))),
              -(-m // (geom.subarray_cols // q)))
             for c, (m, n, q, p) in zip(costs, shapes)]
    groups = [[l] for l in range(layers)]
    if layers > 2:
        groups = [[0, 1]] + [[l] for l in range(2, layers)]
    sched = pkg_sched.schedule_program(grids, geom, groups=groups)
    return costs, sched


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("gi", [0, 2])
def test_price_program_and_fabric_match(seed, gi):
    """`price_program` (flat and per-command energy, spill traffic, batch)
    and `combine_fabric_costs` of its parts: equal `asdict()`s."""
    jg, tg = _geoms(gi)
    jc, js = _program_inputs(j_gemv, j_sched, jg, seed)
    tc, ts = _program_inputs(t_gemv, t_sched, tg, seed)
    assert obs(js) == obs(ts)
    jparts, tparts = [], []
    for batch, energy, spill in itertools.product(
            (1, 2, 4), (None, "DDR4_ENERGY", "LPDDR5_CDPIM"),
            ((0, 0), (123_456, 2))):
        kw = dict(batch=batch, spill_restage_bits=spill[0],
                  spill_restages=spill[1])
        j = j_timing.price_program(
            jc, js, geom=jg, spill=j_timing.CXL_TIER,
            energy=energy and getattr(j_timing, energy), **kw)
        t = t_timing.price_program(
            tc, ts, geom=tg, spill=t_timing.CXL_TIER,
            energy=energy and getattr(t_timing, energy), **kw)
        assert j.asdict() == t.asdict()
        assert (j.t_total, j.e_total) == (t.t_total, t.e_total)
        if batch == 2:
            jparts.append(j)
            tparts.append(t)
    dimms = [0, 1, None, 1, 0, None]
    for n in (1, 3, 6):
        j = j_timing.combine_fabric_costs(jparts[:n], dimms[:n], dimms=2,
                                          batch=2)
        t = t_timing.combine_fabric_costs(tparts[:n], dimms[:n], dimms=2,
                                          batch=2)
        assert j.asdict() == t.asdict() and j.e_total == t.e_total
    for pkg, parts, c, s in ((j_timing, jparts, jc, js),
                             (t_timing, tparts, tc, ts)):
        with pytest.raises(ValueError, match="needs a CxlModel"):
            pkg.price_program(c, s, spill_restage_bits=8)
        with pytest.raises(ValueError, match="batch must be >= 1"):
            pkg.price_program(c, s, batch=0)
        with pytest.raises(ValueError, match="out of range"):
            pkg.combine_fabric_costs(parts[:1], [3], dimms=2, batch=2)
        with pytest.raises(ValueError, match="zero fabric parts"):
            pkg.combine_fabric_costs([], [], dimms=2)


def test_cost_dataclasses_keep_their_fields():
    """The port's cost records have the JAX package's fields, in order (so
    `asdict()` keys and the `OpCounts` vector order agree)."""
    pairs = [(j_gemv.GemvCost, t_gemv.GemvCost)] + [
        (getattr(j_timing, n), getattr(t_timing, n)) for n in (
            "PudCost", "BatchedPudCost", "ProgramCost", "FabricCost",
            "DDR4Model", "EnergyModel", "CxlModel")]
    for j, t in pairs:
        assert [f.name for f in dataclasses.fields(j)] == \
            [f.name for f in dataclasses.fields(t)]
    from repro.core.pud import device as j_device
    from repro_torch.core.pud import device as t_device
    assert j_device._COUNT_FIELDS == t_device._COUNT_FIELDS
    c = t_device.OpCounts(1, 2, 3, 4, 5, 6, 7)
    assert obs(t_device.OpCounts.from_vector(c.vector())) == obs(c)
    assert obs(c.merge(c)) == obs(c.scaled(2))
    assert c.pud_ops == 10
    with pytest.raises(ValueError, match="count vector has 2"):
        t_device.OpCounts.from_vector([1, 2])
