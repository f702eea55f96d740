"""Port parity: one GeMV column-sharded across a fabric's DIMMs.

`plan_column_shards` (bounds, caps, errors, the resolved spec) and
`slice_quantized_cols` (code for code) equal the JAX package's; the
port's `register_sharded`/`gemv_sharded` runs bitwise JAX's
`gemv_sharded` and the port's own unsharded `run_resident` — outputs and
per-(request, tile) OpCounts — for the five (dimms, n, m, q, p) cases of
tests/test_fabric.py, with the 1-D and lane-masked calls, the staleness
and eviction errors word for word.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as j_engine
from repro.core import quant as j_quant
from repro.core.pud import fabric as j_fabric
from repro.core.pud import gemv as j_gemv
from repro_torch.core import engine as t_engine
from repro_torch.core import quant as t_quant
from repro_torch.core.pud import fabric as t_fabric
from repro_torch.core.pud import gemv as t_gemv
from test_torch_model import fresh_jax_caches  # noqa: F401

GEOM = dict(subarray_cols=32, n_sub_max=16, channels=2, banks_per_channel=2)


@pytest.mark.parametrize("col_chunks,shards", [(7, 3), (2, 5), (4, 1),
                                               (12, 8), (1, 1), (9, 4)])
def test_plan_column_shards_equals_jax(col_chunks, shards):
    j = j_fabric.plan_column_shards(col_chunks, shards)
    t = t_fabric.plan_column_shards(col_chunks, shards, device="cpu")
    assert t == t_fabric.ColumnShardPlan(
        col_chunks=j.col_chunks, shards=j.shards,
        chunk_bounds=j.chunk_bounds, axis=j.axis, pspec=j.pspec)
    assert t.shards == min(shards, col_chunks)
    sizes = np.diff(t.chunk_bounds)
    assert sizes.max() - sizes.min() <= 1 and sizes.sum() == col_chunks
    # on the one-device host mesh the model axis (size 1) carries "mlp"
    assert t.pspec == ("model",)
    assert t.bounds_cols(7 * col_chunks - 3, 7) == \
        j.bounds_cols(7 * col_chunks - 3, 7)


def test_plan_column_shards_bounds_and_errors():
    plan = t_fabric.plan_column_shards(7, 3, device="cpu")
    assert plan.chunk_bounds == (0, 3, 5, 7)
    assert plan.bounds_cols(50, 8) == (0, 24, 40, 50)
    with pytest.raises(ValueError, match="column chunk"):
        t_fabric.plan_column_shards(0, 2, device="cpu")
    with pytest.raises(ValueError, match="shard"):
        t_fabric.plan_column_shards(4, 0, device="cpu")
    with pytest.raises(ValueError, match="DIMM"):
        t_fabric.fabric_mesh(0, device="cpu")
    # a mesh whose model axis does not divide the chunks: replicated
    wide = t_fabric.fabric_mesh(1, device="cpu")
    assert t_fabric.plan_column_shards(5, 2, mesh=wide).pspec == ("model",)


@pytest.mark.parametrize("gs", [-1, 8])
def test_slice_quantized_cols_equals_jax(rng, gs):
    w = rng.normal(size=(32, 40)).astype(np.float32)
    jwq = j_quant.quantize_weights(jnp.asarray(w),
                                   j_quant.QuantSpec(bits=4, group_size=gs))
    twq = t_quant.quantize_weights(torch.from_numpy(w),
                                   t_quant.QuantSpec(bits=4, group_size=gs))
    for lo, hi in ((0, 16), (16, 40), (8, 24), (39, 40)):
        j = j_quant.slice_quantized_cols(jwq, lo, hi)
        t = t_quant.slice_quantized_cols(twq, lo, hi)
        ref = t_quant.quantize_weights(torch.from_numpy(w[:, lo:hi]),
                                       twq.spec)
        for a, b, c in ((t.values, j.values, ref.values),
                        (t.scale, j.scale, ref.scale),
                        (t.col_sum, j.col_sum, ref.col_sum)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(a.numpy(), c.numpy())
        assert t.zero == j.zero == ref.zero
    with pytest.raises(ValueError, match="out of range"):
        t_quant.slice_quantized_cols(twq, 8, 48)
    with pytest.raises(ValueError, match="column slicing"):
        t_quant.slice_quantized_cols(
            t_quant.QuantizedTensor(twq.values[None], twq.scale[None],
                                    twq.zero, twq.spec), 0, 1)


def _engines(dimms):
    jg, tg = j_gemv.PudGeometry(**GEOM), t_gemv.PudGeometry(**GEOM)
    return (j_engine.MVDRAMEngine(geom=jg, pool=j_fabric.FabricPool(
                geom=jg, dimms=dimms)),
            t_engine.MVDRAMEngine(geom=tg, pool=t_fabric.FabricPool(
                geom=tg, dimms=dimms)),
            t_engine.MVDRAMEngine(geom=tg))


def _tiles(rep):
    return [[c.asdict() for c in r.tile_runtime] for r in rep.requests]


@pytest.mark.parametrize("dimms,n,m,q,p", [
    (1, 64, 96, 4, 4), (2, 64, 96, 4, 4), (4, 40, 52, 4, 4),
    (2, 40, 52, 2, 4), (2, 24, 36, 4, 2),
])
def test_sharded_gemv_bitwise_jax_and_unsharded(dimms, n, m, q, p, rng):
    w = rng.normal(size=(n, m)).astype(np.float32)
    x = rng.normal(size=(3, n)).astype(np.float32)
    x1 = rng.normal(size=(n,)).astype(np.float32)
    je, te, oracle = _engines(dimms)
    wspec, aspec = (dict(bits=q), dict(bits=p))
    jsh = je.register_sharded("w", jnp.asarray(w), j_quant.QuantSpec(**wspec),
                              a_spec=j_quant.QuantSpec(**aspec))
    tsh = te.register_sharded("w", torch.from_numpy(w),
                              t_quant.QuantSpec(**wspec),
                              a_spec=t_quant.QuantSpec(**aspec))
    assert tsh.col_bounds == jsh.col_bounds and tsh.plan.pspec == \
        jsh.plan.pspec and tsh.shards == jsh.shards
    assert [te.pool.dimm_of(h.name) for h in tsh.parts] == \
        [je.pool.dimm_of(h.name) for h in jsh.parts] == \
        [d % dimms for d in range(tsh.shards)]
    h = oracle.register("w", torch.from_numpy(w), t_quant.QuantSpec(**wspec),
                        a_spec=t_quant.QuantSpec(**aspec))
    ref, rref = oracle.run_resident(h, torch.from_numpy(x),
                                    oracle.staged_for(h))

    jout, jreps = je.gemv_sharded(jsh, jnp.asarray(x))
    tout, treps = te.gemv_sharded(tsh, torch.from_numpy(x))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tout.numpy(), ref.numpy())
    # shard d's tile (ci, cj) is the unsharded tile (ci, lo_chunk + cj)
    bounds, cc = tsh.plan.chunk_bounds, tsh.plan.col_chunks
    unsharded = _tiles(rref)
    for d, (jr, tr) in enumerate(zip(jreps, treps)):
        assert _tiles(tr) == _tiles(jr)
        cc_d = bounds[d + 1] - bounds[d]
        assert te.staged_for(tsh.parts[d]).col_chunks == cc_d
        for b, tiles in enumerate(_tiles(tr)):
            for t, c in enumerate(tiles):
                ci, cj = divmod(t, cc_d)
                assert c == unsharded[b][ci * cc + bounds[d] + cj]

    o1, _ = te.gemv_sharded("w", torch.from_numpy(x1))
    j1, _ = je.gemv_sharded("w", jnp.asarray(x1))
    r1, _ = oracle.run_resident(h, torch.from_numpy(x1)[None],
                                oracle.staged_for(h))
    assert o1.ndim == 1
    np.testing.assert_array_equal(o1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(o1.numpy(), r1[0].numpy())

    mask = np.array([True, False, True])
    om, _ = te.gemv_sharded(tsh, torch.from_numpy(x), lane_mask=mask)
    jm, _ = je.gemv_sharded(jsh, jnp.asarray(x), lane_mask=mask)
    np.testing.assert_array_equal(om.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(om.numpy()[1], 0)
    np.testing.assert_array_equal(om.numpy()[[0, 2]], ref.numpy()[[0, 2]])
    with pytest.raises(ValueError, match=rf"expects \(\.\.\., {n}\)"):
        te.gemv_sharded(tsh, torch.zeros(3, n + 1))


def _err(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


def test_sharded_handle_staleness_and_eviction(rng):
    w = rng.normal(size=(32, 48)).astype(np.float32)
    x = rng.normal(size=(32,)).astype(np.float32)
    je, te, _ = _engines(2)
    msgs = []
    for eng, arr, qs in ((je, jnp.asarray, j_quant.QuantSpec),
                         (te, torch.from_numpy, t_quant.QuantSpec)):
        sh = eng.register_sharded("w", arr(w), qs(bits=4), a_spec=qs(bits=4))
        sh2 = eng.register_sharded("w", arr(w), qs(bits=4),
                                   a_spec=qs(bits=4))
        stale = _err(lambda: eng.gemv_sharded(sh, arr(x)))
        eng.evict(sh2.parts[0])
        gone = _err(lambda: eng.gemv_sharded(sh2, arr(x)))
        msgs.append((stale, gone))
    assert msgs[0] == msgs[1]
    assert "stale sharded handle 'w'" in msgs[1][0]
    assert "no longer resident" in msgs[1][1]


def test_sharded_on_a_plain_pool_and_the_dimm_pin(rng):
    """On a plain `DramPool` the default is one shard (the oracle
    configuration); more shards are placed unpinned; pinning a placement
    to a DIMM needs a fabric."""
    eng = t_engine.MVDRAMEngine(geom=t_gemv.PudGeometry(**GEOM))
    w = torch.from_numpy(rng.normal(size=(32, 48)).astype(np.float32))
    spec = t_quant.QuantSpec(bits=4)
    sh = eng.register_sharded("w", w, spec, a_spec=spec)
    assert sh.shards == 1 and sh.col_bounds == (0, 48)
    two = eng.register_sharded("v", w, spec, a_spec=spec, shards=2)
    assert two.col_bounds == (0, 24, 48)
    out, _ = eng.gemv_sharded(two, w[:, 0])
    ref, _ = eng.gemv_sharded(sh, w[:, 0])
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    with pytest.raises(ValueError, match=">= 1 shard"):
        eng.register_sharded("u", w, spec, shards=0)
    with pytest.raises(ValueError, match="needs a FabricPool"):
        eng._install("u", sh.parts[0].weights, spec, dimm=0)
