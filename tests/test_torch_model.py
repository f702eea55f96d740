"""Port parity: tiny llama2-7b (`tiny_config`, float32, 2 KV heads so GQA is
exercised) in `repro_torch` against the JAX package, both built from the
same numpy parameter tree (`repro_torch.convert`).

Layers match at 1e-6; prefill and decode logits at rtol/atol 1e-4 —
unquantized and quantized with float activations (B3's plain version) —
and with the int8 KV cache.

With 4-bit activations the reference itself is not reproducible at model
level: the symmetric quantizer maps every row's absmax element onto the
±7.5 rounding tie, so a 1-ulp change anywhere upstream (torch and XLA
differ by an ulp in mean, rsqrt, cos/sin, gelu and softmax; XLA's own jit
and eager paths differ too) flips a negative absmax between two codes.
tests/test_torch_serve.py asserts that the JAX package's jitted and eager
prefill logits differ there, and that off the tie the port follows JAX
token for token. Here the act_bits=4 model is held BITWISE against the
same model whose every bit-plane linear is the JAX package's kernel: the
float ops are the port's, the linears JAX's (each linear is bitwise equal
on equal inputs — tests/test_torch_bitplane_gemv.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as j_tiny_config
from repro.core.bitplane import BitplaneWeights as JBitplaneWeights
from repro.core.quant import QuantSpec as JQuantSpec
from repro.kernels.bitplane_gemv import ops as jops
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.models.model import param_defs as j_param_defs
from repro.models.params import init_params as j_init_params
from repro.serve.quantize import quantize_params as j_quantize_params
from repro_torch import convert
from repro_torch.configs import tiny_config
from repro_torch.core.engine import EngineLinear, MVDRAMEngine
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model, param_defs
from repro_torch.serve.quantize import quantize_params

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS, MAX_SEQ = 2, 6, 3, 16


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    """Leave no JAX trace behind. Other test files count kernel launches
    at trace time, and a jit-cache hit on a trace made here, in the same
    process, would hide a launch from them. Imported by every port test
    file that runs JAX."""
    yield
    jax.clear_caches()


def _cfgs():
    return (dataclasses.replace(j_tiny_config("llama2-7b"), dtype="float32"),
            dataclasses.replace(tiny_config("llama2-7b"), dtype="float32"))


@pytest.fixture(scope="module")
def carried():
    """JAX parameters, and the same values as the port's parameters."""
    jcfg, tcfg = _cfgs()
    jparams = j_init_params(j_param_defs(jcfg), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, convert.params_from_numpy(tree, "cpu")


def test_tiny_config_and_defs_match_jax(carried):
    jcfg, tcfg, jparams, tparams = carried
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jshapes = jax.tree_util.tree_map(lambda d: d.shape, j_param_defs(jcfg),
                                     is_leaf=lambda x: hasattr(x, "shape"))
    tshapes = jax.tree_util.tree_map(lambda d: d.shape, param_defs(tcfg),
                                     is_leaf=lambda x: hasattr(x, "shape"))
    assert tshapes == jshapes
    assert tcfg.param_count() == jcfg.param_count()


def test_rmsnorm_rope_ffn_match(rng, carried):
    _, _, _, tparams = carried
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    g = rng.normal(size=(64,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(g))),
        rtol=1e-6, atol=1e-6)
    pos = np.arange(5)
    jc, js = jlayers.rope_frequencies(16, 10000.0, jnp.asarray(pos))
    tc, ts = tlayers.rope_frequencies(16, 10000.0, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    xh = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(xh), torch.from_numpy(
            np.array(jc)), torch.from_numpy(np.array(js))).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(xh), jc, js)),
        rtol=1e-6, atol=1e-6)
    p = {k: v[0] for k, v in tparams["stages"]["0"]["ffn"].items()}
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    np.testing.assert_allclose(
        tlayers.ffn(torch.from_numpy(x), p, "glu").numpy(),
        np.asarray(jlayers.ffn(jnp.asarray(x), jp, "glu")),
        rtol=1e-6, atol=1e-6)


def _models(carried, quantized, kv_bits=None):
    jcfg, tcfg, jparams, tparams = carried
    if quantized:
        jparams = j_quantize_params(jparams, jcfg.weight_bits)
        tparams = quantize_params(tparams, tcfg.weight_bits)
    impl = EngineLinear(MVDRAMEngine()) if quantized else None
    return (JModel(jcfg, kv_bits=kv_bits), jparams,
            Model(tcfg, impl=impl, kv_bits=kv_bits), tparams)


class JaxLinear:
    """A `dense` impl that runs every bit-plane linear through the JAX
    package's kernel path (`impl="jnp"`, bitwise equal to its Pallas
    kernel for single-group scales) on numpy copies of the inputs."""

    def __call__(self, x, w, act_bits=None):
        jw = JBitplaneWeights(
            planes=jnp.asarray(w.planes.numpy().view(np.uint32)),
            scale=jnp.asarray(w.scale.numpy()), zero=w.zero,
            col_sum=jnp.asarray(w.col_sum.numpy()), n=w.n,
            spec=JQuantSpec(bits=w.spec.bits))
        xj = jnp.asarray(x.numpy())
        out = (jops.bitplane_gemv_bitserial(xj, jw, JQuantSpec(bits=act_bits),
                                            impl="jnp") if act_bits
               else jops.bitplane_gemv(xj, jw, impl="jnp"))
        return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("kv_bits", [None, 8])
def test_prefill_and_decode_logits_match(rng, carried, quantized, kv_bits):
    """Unquantized, and quantized with float activations (B3's plain
    version in every linear)."""
    jm, jp, tm, tp = _models(carried, quantized, kv_bits)
    toks = rng.integers(0, 256, size=(B, S + STEPS))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, MAX_SEQ)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])},
                            MAX_SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jstage, tstage = jc["stages"]["0"], tc["stages"]["0"]
    assert set(tstage) == set(jstage)
    np.testing.assert_array_equal(tstage["positions"].numpy(),
                                  np.asarray(jstage["positions"]))
    for t in range(S, S + STEPS):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t]),
                                jnp.int32(t))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t]), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {t}")


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_act_bits4_model_bitwise_with_jax_linears(rng, carried, kv_bits):
    """The port's act_bits=4 model (q/k/v and up/gate fused through B2's
    plain version, the rest through B1's) equals, bitwise, the same model
    with JAX's bit-plane kernels in every linear — prefill and decode."""
    _, tcfg, _, tparams = carried
    qp = quantize_params(tparams, tcfg.weight_bits)
    port = Model(tcfg, act_bits=4, impl=EngineLinear(MVDRAMEngine()),
                 kv_bits=kv_bits)
    hybrid = Model(tcfg, act_bits=4, impl=JaxLinear(), kv_bits=kv_bits)
    toks = torch.from_numpy(rng.integers(0, 256, size=(B, S + STEPS)))
    with torch.no_grad():
        a, ca = port.prefill(qp, {"tokens": toks[:, :S]}, MAX_SEQ)
        b, cb = hybrid.prefill(qp, {"tokens": toks[:, :S]}, MAX_SEQ)
        assert torch.equal(a, b)
        for t in range(S, S + STEPS):
            a, ca = port.decode_step(qp, ca, toks[:, t], t)
            b, cb = hybrid.decode_step(qp, cb, toks[:, t], t)
            assert torch.equal(a, b), f"decode step {t}"


def test_forward_matches(rng, carried):
    jm, jp, tm, tp = _models(carried, False)
    toks = rng.integers(0, 256, size=(B, S))
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_quantized_leaves_equal_jax(carried):
    jcfg, tcfg, jparams, tparams = carried
    jq = j_quantize_params(jparams, 2)["stages"]["0"]["attn"]["wq"]
    tq = quantize_params(tparams, 2)["stages"]["0"]["attn"]["wq"]
    assert np.array_equal(np.asarray(jq.planes).view(np.int32),
                          tq.planes.numpy())
    assert np.array_equal(np.asarray(jq.scale), tq.scale.numpy())
    assert np.array_equal(np.asarray(jq.col_sum), tq.col_sum.numpy())


@pytest.mark.parametrize("window", [None, 12])
def test_flash_attention_matches_jax_and_direct(rng, window):
    """The blocked long-prompt path at a small block size."""
    q = rng.normal(size=(1, 40, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 40, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, 40, 2, 16)).astype(np.float32)
    want = np.asarray(jattn._flash_sdpa(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), window, None, 0.25,
                                        block=16))
    tq_, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tattn._flash_sdpa(tq_, tk, tv, window, None, 0.25, block=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    direct = tattn._sdpa(tq_, tk, tv, tattn._causal_mask(40, 40, window),
                         None, 0.25)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_unported_configs_raise():
    """Embedding inputs and hybrid shared blocks are ported now (the
    shared block's parameters stacked over its two sets); attention
    stages with no attention config are refused."""
    cfg = tiny_config("llama2-7b")
    Model(dataclasses.replace(cfg, input_mode="embeddings"))
    hybrid = dataclasses.replace(cfg, num_shared_blocks=2, shared_every=1)
    Model(hybrid)
    assert param_defs(hybrid)["shared"]["attn"]["wq"].shape[0] == 2
    with pytest.raises(NotImplementedError, match="no attention config"):
        Model(dataclasses.replace(cfg, attn=None))
