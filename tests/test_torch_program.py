"""Port parity: the fused multi-layer GeMV (`kernels/bitplane_gemv/
program.py`, kernel B2; on the CPU its plain version) against the JAX
package's `program.py` run in interpret mode.

Plans and packed tensors must be EXACTLY the JAX package's; fused outputs
BITWISE equal to JAX's fused launch and to the port's own per-leaf path.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbp
from repro.core import quant as jq
from repro.kernels.bitplane_gemv import program as jprog
from repro_torch import convert
from repro_torch.core import backends
from repro_torch.core import quant as tq
from repro_torch.core.engine import EngineLinear, MVDRAMEngine
from repro_torch.kernels.bitplane_gemv import ops as tops
from repro_torch.kernels.bitplane_gemv import program as tprog
from repro_torch.kernels.bitplane_gemv import ref as tref
from repro_torch.models.layers import dense, dense_group
from test_torch_model import fresh_jax_caches  # noqa: F401

# (n, m, q, p, groups), concurrency groups — the blocks of
# tests/test_program_kernel.py
BLOCKS = [
    ([(300, 90, 2, 2, 1), (300, 90, 3, 3, 1), (300, 90, 4, 2, 1),
      (160, 40, 5, 4, 1)], ((0, 1, 2), (3,))),
    ([(320, 200, 2, 2, 2), (480, 130, 4, 3, 3), (512, 256, 4, 2, 1)], None),
    ([(256, 40, 3, 2, 1)], None),
]


def _leaves(rng, cfgs, B):
    jws, tws, xs = [], [], []
    for n, m, q, _p, g in cfgs:
        w = rng.normal(size=(n, m)).astype(np.float32)
        jbw = jbp.make_bitplane_weights(
            jnp.asarray(w),
            jq.QuantSpec(bits=q, group_size=n // g if g > 1 else -1))
        jws.append(jbw)
        tws.append(convert.bitplane_from_numpy(
            np.asarray(jbw.planes), np.asarray(jbw.scale), jbw.zero,
            np.asarray(jbw.col_sum), jbw.n, jbw.spec, device="cpu"))
        xs.append(rng.normal(size=(B, n)).astype(np.float32))
    return jws, tws, xs


def _plans(cfgs, jws, tws, groups):
    metas = [(bw.n, bw.m, bw.bits, bw.scale.shape[0], bw.zero, p,
              1 << (p - 1)) for bw, (_n, _m, _q, p, _g) in zip(jws, cfgs)]
    return (jprog.build_plan(tuple(metas), groups),
            tprog.build_plan(tuple(metas), groups))


@pytest.mark.parametrize("cfgs,groups", BLOCKS)
def test_plan_and_packing_exact(rng, cfgs, groups):
    jws, tws, xs = _leaves(rng, cfgs, 2)
    jplan, tplan = _plans(cfgs, jws, tws, groups)
    assert [dataclasses.astuple(L) for L in tplan.layers] == \
        [dataclasses.astuple(L) for L in jplan.layers]
    for f in ("groups", "slot_layer", "slot_mtile", "bn_max", "bm_max",
              "nt_max", "q_max", "p_max"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    jp, js = jprog.pack_weights(jplan, tuple(jws))
    tp, ts = tprog.pack_weights(tplan, tuple(tws))
    assert np.array_equal(np.asarray(jp).view(np.int32), tp.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    codes = [rng.integers(0, 1 << p, size=(2, n)).astype(np.uint8)
             for n, _m, _q, p, _g in cfgs]
    jc = jprog.pack_codes(jplan, [jnp.asarray(c) for c in codes])
    tc = tprog.pack_codes(tplan, [torch.from_numpy(c) for c in codes])
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(jprog.pack_params(jplan), tprog.pack_params(tplan))


@pytest.mark.parametrize("cfgs,groups,B", [
    (*blk, b) for blk, b in zip(BLOCKS, (3, 2, 1))])
def test_run_program_bitwise_equals_jax_and_per_leaf(rng, cfgs, groups, B):
    jws, tws, xs = _leaves(rng, cfgs, B)
    jplan, tplan = _plans(cfgs, jws, tws, groups)
    jspecs = [jq.QuantSpec(bits=c[3]) for c in cfgs]
    tspecs = [tq.QuantSpec(bits=c[3]) for c in cfgs]
    want = jprog.run_program(jplan, tuple(jws),
                             [jnp.asarray(x) for x in xs], jspecs,
                             interpret=True, donate=False)
    got = tprog.run_program(tplan, tuple(tws),
                            [torch.from_numpy(x) for x in xs], tspecs)
    for w_, g_, bw, x, spec in zip(want, got, tws, xs, tspecs):
        assert np.array_equal(g_.numpy(), np.asarray(w_))
        leaf = tops.bitplane_gemv_bitserial(torch.from_numpy(x), bw, spec)
        assert torch.equal(g_, leaf)


@pytest.mark.parametrize("act_bits", [2, 4])
def test_fused_group_linears_bitwise(rng, act_bits):
    n = 256
    cfgs = [(n, m, 3, act_bits, 1) for m in (90, 128, 200)]
    jws, tws, _ = _leaves(rng, cfgs, 1)
    x = rng.normal(size=(2, 3, n)).astype(np.float32)
    want = jprog.fused_group_linears(jnp.asarray(x), jws, act_bits,
                                     interpret=True)
    c0 = tref.CALLS["program_gemv"]
    got = tprog.fused_group_linears(torch.from_numpy(x), tws, act_bits)
    assert tref.CALLS["program_gemv"] == c0 + 1      # ONE launch
    for w_, g_, bw in zip(want, got, tws):
        assert g_.shape == (2, 3, bw.m)
        assert np.array_equal(g_.numpy(), np.asarray(w_))


def test_code_equals_bitserial_inside_fused(rng):
    cfgs, groups = BLOCKS[1]
    _, tws, xs = _leaves(rng, cfgs, 2)
    plan = tprog.plan_from_weights(tws, tq.QuantSpec(bits=2))
    planes_t, scale_t, params_t = tprog.pack_group(plan, tws, "cpu")
    codes = [torch.from_numpy(rng.integers(0, 4, size=(2, bw.n)).astype(
        np.uint8)) for bw in tws]
    codes_t = tprog.pack_codes(plan, codes)
    a = tprog.program_gemv(plan, codes_t, planes_t, scale_t, params_t)
    b = tprog.program_gemv(plan, codes_t, planes_t, scale_t, params_t,
                           fidelity="bitserial")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="fidelity"):
        tprog.program_gemv(plan, codes_t, planes_t, scale_t, params_t,
                           fidelity="nope")


def test_dense_group_routes_through_the_kernel_group_hook(rng):
    """q/k/v sharing one input fuse into ONE fused launch through
    `EngineLinear`'s group hook, bitwise equal to per-leaf dense(); the
    engine packs each group's weights once and reuses them."""
    n = 256
    cfgs = [(n, m, 3, 3, 1) for m in (90, 128, 200)]
    _, tws, _ = _leaves(rng, cfgs, 1)
    x = torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32))
    eng = MVDRAMEngine()
    lin = EngineLinear(eng, backend=backends.KERNEL)
    c0 = dict(tref.CALLS)
    fused = dense_group(x, tuple(tws), act_bits=3, impl=lin)
    assert tref.CALLS["program_gemv"] == c0["program_gemv"] + 1
    assert tref.CALLS["gemv_bs"] == c0["gemv_bs"]
    assert eng.routed_linears == 3
    for f, w in zip(fused, tws):
        assert torch.equal(f, dense(x, w, act_bits=3, impl=lin))
    dense_group(x, tuple(tws), act_bits=3, impl=lin)
    assert len(eng._packed) == 1
    # the reference backend runs per leaf with the same numbers
    ref_lin = EngineLinear(MVDRAMEngine(), backend="reference")
    for f, g in zip(fused, dense_group(x, tuple(tws), act_bits=3,
                                       impl=ref_lin)):
        assert torch.equal(f, g)
    # float activations never fuse
    c1 = tref.CALLS["program_gemv"]
    dense_group(x, tuple(tws), act_bits=None, impl=lin)
    assert tref.CALLS["program_gemv"] == c1


def test_backend_registry():
    assert backends.get_backend(None) is backends.KERNEL
    assert backends.get_backend("reference") is backends.REFERENCE
    assert backends.resolve_impl(None) == "kernel"
    assert backends.resolve_impl(backends.REFERENCE) == "reference"
    assert backends.get_backend(backends.KERNEL) is backends.KERNEL
    with pytest.raises(ValueError, match="unknown"):
        backends.get_backend("pallas")
    with pytest.raises(ValueError, match="already registered"):
        backends.register_backend(backends.ReferenceBackend())
