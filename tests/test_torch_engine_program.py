"""Port parity: the compiled decode program and the residency session on
the serving path, on the CPU.

* `GemvProgram.run_kernel` (one B2 launch over a whole decode block; here
  its plain version) BITWISE against the JAX package's `run_kernel` in
  interpret mode and against per-leaf plain B1, with lane masks, capacity
  programs, grouped scales, blocks of more than 8 members (the device
  table's plain twin) and its input errors; `Backend.run_program` on both
  backends.
* The device-memory member table: the fields a launch rewrites are the
  first five of the kernel's `Member`, in its order.
* Tiny `ServeEngine`s (llama2-7b, qwen2-moe-a2.7b, mamba2-1.3b; 1 and 2
  DIMMs, with and without the spill tier, and a fabric small enough to
  spill): the same leaf names, `residency_stats()`, `price_decode_step()`
  and tick prices (seconds and Joules) at every occupancy, floats equal;
  the placement fallback forced as `tests/test_serve.py` forces it.
* A tiny `ContinuousBatcher`: the same priced clock (`sim_time_s`) and
  per-request `first_token_s` / `finish_s` as the JAX batcher.
"""
import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as j_tiny_config
from repro.core import engine as j_engine
from repro.core import quant as j_quant
from repro.core.pud import fabric as j_fab
from repro.core.pud import residency as j_res
from repro.core.pud.gemv import PudGeometry as JGeom
from repro.models.model import param_defs as j_param_defs
from repro.models.params import init_params as j_init_params
from repro.serve import engine as j_serve
from repro.serve.scheduler import ContinuousBatcher as JBatcher
from repro.serve.scheduler import Request as JRequest
from repro_torch import convert
from repro_torch.configs import tiny_config
from repro_torch.core import backends
from repro_torch.core import engine as t_engine
from repro_torch.core import quant as t_quant
from repro_torch.core.pud import fabric as t_fab
from repro_torch.core.pud import residency as t_res
from repro_torch.core.pud.gemv import PudGeometry as TGeom
from repro_torch.kernels.bitplane_gemv import kernel as bkernel
from repro_torch.kernels.bitplane_gemv import ops as tops
from repro_torch.kernels.bitplane_gemv import program as tprog
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.serve import engine as t_serve
from test_torch_model import fresh_jax_caches  # noqa: F401
from test_torch_residency import obs

GEOM = dict(subarray_cols=64, n_sub_max=32)

# (n, m, q, p, scale groups): ragged n, sub-block m, mixed bits, grouped
# scales (tests/test_program_kernel.py's blocks), and a block of 10
# members — more than a by-value table holds
BLOCKS = {
    "qkv+down": [(300, 90, 2, 2, 1), (300, 90, 3, 3, 1), (300, 90, 4, 2, 1),
                 (160, 40, 5, 4, 1)],
    "grouped": [(320, 200, 2, 2, 2), (480, 130, 4, 3, 3),
                (512, 256, 4, 2, 1)],
    "ten members": [(32 * (1 + i % 3), 8 + 24 * (i % 3), 2 + i % 3, 4, 1)
                    for i in range(10)],
}


def _build(cfgs, b, seed=0, groups=None, b_max=None):
    """The same block registered on both engines, and its activations."""
    rng = np.random.default_rng(seed)
    je = j_engine.MVDRAMEngine(geom=JGeom(**GEOM))
    te = t_engine.MVDRAMEngine(geom=TGeom(**GEOM))
    xs = []
    for i, (n, m, q, p, g) in enumerate(cfgs):
        w = rng.normal(size=(n, m)).astype(np.float32)
        gs = n // g if g > 1 else -1
        je.register(f"l{i}", jnp.asarray(w),
                    j_quant.QuantSpec(bits=q, group_size=gs),
                    a_spec=j_quant.QuantSpec(bits=p))
        te.register(f"l{i}", torch.from_numpy(w),
                    t_quant.QuantSpec(bits=q, group_size=gs),
                    a_spec=t_quant.QuantSpec(bits=p))
        xs.append(rng.normal(size=(b, n)).astype(np.float32))
    names = [f"l{i}" for i in range(len(cfgs))]
    return (je.compile(names, groups=groups, b_max=b_max),
            te.compile(names, groups=groups, b_max=b_max), xs)


def _per_leaf(prog, xs):
    return [tops.bitplane_gemv_bitserial(torch.from_numpy(x), h.weights,
                                         h.a_spec, impl="reference")
            for h, x in zip(prog.handles, xs)]


@pytest.mark.parametrize("name,b", [("qkv+down", 1), ("qkv+down", 3),
                                    ("grouped", 2), ("ten members", 3)])
def test_run_kernel_bitwise_against_jax_and_per_leaf(name, b):
    jp, tp, xs = _build(BLOCKS[name], b)
    got = tp.run_kernel([torch.from_numpy(x) for x in xs])
    want = jp.run_kernel([jnp.asarray(x) for x in xs], interpret=True)
    for o, w, leaf in zip(got, want, _per_leaf(tp, xs)):
        assert o.dtype == torch.float32
        np.testing.assert_array_equal(o.numpy(), np.asarray(w))
        assert torch.equal(o, leaf)
    assert tp.kernel_steps == 1
    assert obs(tp.kernel_plan()) == obs(jp.kernel_plan())
    assert tp.kernel_table() is tp.kernel_table()        # built once


def test_lane_mask_capacity_and_backend_route():
    cfgs = BLOCKS["ten members"]
    jp, tp, xs = _build(cfgs, 4, groups=[[0, 1, 2], [3], [4, 5], [6], [7],
                                         [8, 9]], b_max=4)
    mask = np.array([True, False, True, False])
    tx = [torch.from_numpy(x) for x in xs]
    got = tp.run_kernel(tx, lane_mask=mask)
    want = jp.run_kernel([jnp.asarray(x) for x in xs], lane_mask=mask,
                         interpret=True)
    for o, w, leaf in zip(got, want, _per_leaf(tp, xs)):
        np.testing.assert_array_equal(o.numpy(), np.asarray(w))
        assert torch.equal(o[mask], leaf[mask])
        assert not o[~mask].any()
    with pytest.raises(ValueError, match="b_max"):
        tp.run_kernel([x[:2] for x in tx])
    with pytest.raises(ValueError, match="active lanes"):
        tp.run_kernel(tx, lane_mask=np.zeros(4, bool))
    with pytest.raises(ValueError, match="lane_mask shape"):
        tp.run_kernel(tx, lane_mask=np.ones(3, bool))
    # the kernel backend routes the block to run_kernel; the reference
    # backend runs it per leaf, with the same numbers
    via_kernel = backends.KERNEL.run_program(tp.engine, tp, tx,
                                             lane_mask=mask)
    via_leaf = backends.REFERENCE.run_program(tp.engine, tp, tx,
                                              lane_mask=mask)
    for a, b_, o in zip(via_kernel, via_leaf, got):
        assert torch.equal(a, o) and torch.equal(b_, o)


def test_run_kernel_input_errors():
    jp, tp, xs = _build(BLOCKS["qkv+down"][:1], 2)
    tx = [torch.from_numpy(x) for x in xs]
    with pytest.raises(ValueError, match="activations for a 1-layer"):
        tp.run_kernel(tx + tx)
    with pytest.raises(ValueError, match="expects"):
        tp.run_kernel([x[:, :-1] for x in tx])
    one = tp.run_kernel([x[0] for x in tx])          # (N,) → (M,)
    assert one[0].ndim == 1
    assert torch.equal(one[0], _per_leaf(tp, [x[:1] for x in xs])[0][0])
    # a float-activation layer has no bit-serial stream to run
    te = t_engine.MVDRAMEngine(geom=TGeom(**GEOM))
    te.register("f", torch.ones(64, 8), t_quant.QuantSpec(bits=2))
    prog = te.compile(["f"])
    with pytest.raises(ValueError, match="float activations"):
        prog.run_kernel([torch.ones(1, 64)])
    with pytest.raises(ValueError, match="float activations"):
        prog.kernel_plan()


def test_device_table_fields():
    """A table of more than `kernel.MAX_MEMBERS` members goes to the card
    in device memory: its static fields are those of the by-value table's
    members, and each launch writes `call_fields` — codes, planes, scales,
    output (at the member's column) and the codes' row stride — over the
    first 40 bytes of every 128-byte `Member`."""
    _jp, tp, xs = _build(BLOCKS["ten members"], 3)
    table = tp.kernel_table()
    n = len(table.members)
    assert n > bkernel.MAX_MEMBERS
    assert ctypes.sizeof(bkernel.Member) == 128
    assert bkernel.Member.a_tile.offset == 40
    assert [f[0] for f in bkernel.Member._fields_[:5]] == \
        ["a", "planes", "scales", "out", "a_row"]
    with pytest.raises(ValueError, match="by-value table holds"):
        table.ctable()
    arr = table.members_c()
    assert table.members_c() is arr
    for e, M, pl, sc in zip(arr, table.members, table.planes, table.scales):
        assert (e.planes, e.scales) == (pl.data_ptr(), sc.data_ptr())
        assert (e.col, e.m, e.strip0, e.tiles, e.bn, e.q) == \
            (M.col, M.m, M.strip0, M.tiles, M.bn, M.q)
        assert (e.z_a, e.zero, e.mask) == (M.z_a, M.z_w, (1 << M.p) - 1)
        assert e.a is None and e.out is None and e.out_row == table.cols
    gtab = table.device_table("cpu")
    assert gtab.dtype == torch.uint8 and gtab.numel() == 128 * n
    assert table.device_table("cpu") is gtab
    assert bytes(gtab.numpy()) == bytes(arr)
    codes, _ = tprog.block_codes(table, [torch.from_numpy(x) for x in xs],
                                 [h.a_spec for h in tp.handles])
    out = torch.empty((3, table.cols))
    rows = table.call_fields(codes, out)
    assert rows.shape == (n, 5) and rows.dtype == np.int64
    for row, c, pl, sc, M in zip(rows, codes, table.planes, table.scales,
                                 table.members):
        assert tuple(row) == (c.data_ptr(), pl.data_ptr(), sc.data_ptr(),
                              out.data_ptr() + 4 * M.col, c.stride(0))
    # the rows, written over the static table, give the launch's members
    words = np.frombuffer(bytes(arr), np.int64).reshape(n, 16).copy()
    words[:, :5] = rows
    filled = (bkernel.Member * n).from_buffer_copy(words.tobytes())
    for e, c, M in zip(filled, codes, table.members):
        assert (e.a, e.a_row, e.out) == (c.data_ptr(), c.stride(0),
                                         out.data_ptr() + 4 * M.col)
        assert (e.col, e.tiles, e.z_a) == (M.col, M.tiles, M.z_a)


# ---------------------------------------------------------------------------
# tiny ServeEngine and batcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried():
    made = {}

    def get(arch):
        if arch not in made:
            jcfg = dataclasses.replace(j_tiny_config(arch), dtype="float32")
            tcfg = dataclasses.replace(tiny_config(arch), dtype="float32")
            jparams = j_init_params(j_param_defs(jcfg),
                                    jax.random.PRNGKey(0))
            tparams = convert.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, jparams), "cpu")
            made[arch] = jcfg, tcfg, jparams, tparams
        return made[arch]
    return get


def _small_fabric(monkeypatch):
    """Both packages' serving fabrics built of 2-bank DIMMs of one
    subarray a bank, so the spill tier fills up at tiny widths."""
    geom = dict(channels=1, banks_per_channel=2, subarrays_per_bank=1)
    jreal, treal = j_fab.FabricPool, t_fab.FabricPool
    monkeypatch.setattr(j_fab, "FabricPool",
                        lambda dimms: jreal(geom=JGeom(**geom), dimms=dimms))
    monkeypatch.setattr(t_serve, "FabricPool",
                        lambda dimms: treal(geom=TGeom(**geom), dimms=dimms))


def _serving(je, te):
    """What both ServeEngines report of their residency and prices."""
    assert list(je.mvdram.handles) == list(te.mvdram.handles)
    assert je.residency_stats() == te.residency_stats()
    assert je.price_decode_step() == te.price_decode_step()
    assert je.price_decode_step(bit_density=0.3, batch=2) == \
        te.price_decode_step(bit_density=0.3, batch=2)
    for k in range(1, je.slots + 1):
        assert je.decode_tick_cost_s(k) == te.decode_tick_cost_s(k)
        assert je.decode_tick_energy_j(k) == te.decode_tick_energy_j(k)
    for e in (je, te):
        with pytest.raises(ValueError, match="occupancy must be an int"):
            e.decode_tick_cost_s(je.slots + 1)
    return te.residency_stats()


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen2-moe-a2.7b",
                                  "mamba2-1.3b"])
@pytest.mark.parametrize("kw", [{}, {"dimms": 2}, {"spill_tier": True},
                                {"spill_tier": True, "small": 1}],
                         ids=["dimms1", "dimms2", "spill", "spill_small"])
def test_serve_engine_residency_and_prices_match(carried, monkeypatch, arch,
                                                 kw):
    jcfg, tcfg, jparams, tparams = carried(arch)
    kw = dict(kw)
    small = kw.pop("small", None)
    if small:
        _small_fabric(monkeypatch)
    for act_bits in ((4, None) if not kw else (4,)):
        je = j_serve.ServeEngine(jcfg, jparams, max_seq=16, batch_slots=3,
                                 quantized=True, act_bits=act_bits, **kw)
        te = t_serve.ServeEngine(tcfg, tparams, max_seq=16, batch_slots=3,
                                 quantized=True, act_bits=act_bits,
                                 device="cpu", **kw)
        stats = _serving(je, te)
        assert stats["resident_program"] and not stats["placement_fallback"]
        want = "FabricProgram" if kw else "GemvProgram"
        assert type(te.decode_program).__name__ == want
    if small:
        assert stats["spilled"] > 0 and stats["placements"] > 0


def test_placement_fallback_matches(carried, monkeypatch):
    """A pool with almost no resident rows: both packages roll placement
    back, warn and serve program-less (tests/test_serve.py:204)."""
    jcfg, tcfg, jparams, tparams = carried("llama2-7b")

    def tiny_engine(mod, geom_cls, pool_cls):
        orig = mod.MVDRAMEngine

        def make(**kw):
            geom = geom_cls()
            return orig(pool=pool_cls(geom, compute_reserve=geom.bank_rows
                                      - 4), **kw)
        return make
    monkeypatch.setattr(j_serve, "MVDRAMEngine",
                        tiny_engine(j_serve, JGeom, j_res.DramPool))
    monkeypatch.setattr(t_serve, "MVDRAMEngine",
                        tiny_engine(t_serve, TGeom, t_res.DramPool))
    with pytest.warns(RuntimeWarning, match="does not fit the DramPool"):
        je = j_serve.ServeEngine(jcfg, jparams, max_seq=16, quantized=True)
    with pytest.warns(RuntimeWarning, match="does not fit the DramPool"):
        te = t_serve.ServeEngine(tcfg, tparams, max_seq=16, quantized=True,
                                 device="cpu")
    assert te.decode_program is None and te.placement_fallback
    stats = te.residency_stats()
    assert stats == je.residency_stats()
    assert stats["placements"] == 0 and not stats["resident_program"]
    assert te.price_decode_step() is None
    assert te.decode_tick_cost_s(1) is None
    assert te.decode_tick_energy_j(1) is None
    out = te.generate(torch.zeros((1, 4), dtype=torch.long), max_new=3)
    assert tuple(out.shape) == (1, 7)
    assert t_serve.ServeEngine(tcfg, tparams, max_seq=16,
                               device="cpu").residency_stats() is None


def test_batcher_priced_clock_matches_jax(carried):
    """The same traffic through both batchers on a 2-DIMM engine: the same
    priced DDR4 clock, tick for tick, and the same stamps per request (the
    clock depends on the tick masks, not on the tokens)."""
    jcfg, tcfg, jparams, tparams = carried("llama2-7b")
    kw = dict(max_seq=24, batch_slots=2, quantized=True, act_bits=4,
              dimms=2)
    jb = JBatcher(jcfg, None, prefill_chunk=2,
                  engine=j_serve.ServeEngine(jcfg, jparams, **kw))
    tb = ContinuousBatcher(tcfg, None, prefill_chunk=2,
                           engine=t_serve.ServeEngine(tcfg, tparams,
                                                      device="cpu", **kw))
    rng = np.random.default_rng(5)
    for i, (n, m) in enumerate(((3, 2), (5, 1), (2, 3))):
        p = rng.integers(0, jcfg.vocab_size, size=n).tolist()
        jb.submit(JRequest(rid=i, prompt=p, max_new=m))
        tb.submit(Request(rid=i, prompt=p, max_new=m))
    while jb.pending or jb.in_flight:
        jb.tick()
        tb.tick()
        assert tb.sim_time_s == jb.sim_time_s > 0.0
    assert tb.pending == tb.in_flight == 0
    assert (tb.ticks, tb.program_ticks, tb.occupancy_ticks) == \
        (jb.ticks, jb.program_ticks, jb.occupancy_ticks)
    stamps = lambda b: sorted((r.rid, r.first_token_s, r.finish_s)
                              for r in b.finished)
    assert stamps(tb) == stamps(jb)
    assert all(r.first_token_s > 0 and r.finish_s >= r.first_token_s
               for r in tb.finished)
