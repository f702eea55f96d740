"""Port parity: the fused-dequant matmul baseline (B5) of `repro_torch`
against the JAX package, on the same numpy inputs.

Packing is held bitwise; the GeMV (on CPU tensors, the kernel's plain
version) against JAX `quant_matmul(impl="pallas_interpret")` over the grid
of tests/test_kernels.py at rtol 1e-5 and atol 1e-5·max|ref| — B3's rule:
both sum in f32, in another order; and a tiny llama2-7b with every GeMV
leaf a 2-bit `QuantizedTensor` (the JAX leaves carried across with
`convert.quantized_from_numpy`) against the JAX model on the same leaves,
prefill and decode logits at rtol/atol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as j_tiny_config
from repro.core import backends as jbackends
from repro.core import quant as jq
from repro.kernels.quant_matmul import ops as jops
from repro.models.model import Model as JModel
from repro.models.model import param_defs as j_param_defs
from repro.models.params import init_params as j_init_params
from repro.serve.quantize import QUANT_LEAF_NAMES as J_LEAF_NAMES
from repro_torch import convert
from repro_torch.configs import tiny_config
from repro_torch.core import quant as tq
from repro_torch.core.engine import EngineLinear, MVDRAMEngine
from repro_torch.kernels.quant_matmul import kernel as tkernel
from repro_torch.kernels.quant_matmul import ops as tops
from repro_torch.kernels.quant_matmul import ref as tref
from repro_torch.models.model import Model
from repro_torch.serve.quantize import QUANT_LEAF_NAMES
from test_torch_model import fresh_jax_caches  # noqa: F401

SHAPES = [(512, 256, 1), (384, 300, 3), (1000, 130, 2)]
BITS_GROUPS = [(4, -1), (8, 256), (2, -1)]


def _weights(rng, n, m, q, gs):
    w = rng.normal(size=(n, m)).astype(np.float32)
    jqt = jq.quantize_weights(jnp.asarray(w),
                              jq.QuantSpec(bits=q, group_size=gs))
    return jqt, _carry(jqt)


def _carry(jqt):
    return convert.quantized_from_numpy(
        np.asarray(jqt.values), np.asarray(jqt.scale), jqt.zero, jqt.spec,
        np.asarray(jqt.col_sum), "cpu")


@pytest.mark.parametrize("n,m", [(300, 90), (512, 40), (33, 7)])
@pytest.mark.parametrize("q", [1, 2, 3, 4, 8])
def test_pack_weight_codes_bitwise(rng, n, m, q):
    codes = rng.integers(0, 1 << q, size=(n, m)).astype(np.uint8)
    want = np.asarray(jops.pack_weight_codes(jnp.asarray(codes), q))
    got = tops.pack_weight_codes(torch.from_numpy(codes), q)
    assert got.dtype == torch.int32
    assert np.array_equal(want.view(np.int32), got.numpy())
    back = tref.unpack_codes_axis0(got, q, n)
    assert np.array_equal(back.numpy(), codes.astype(np.int32))


def test_pack_stacked_leaf_layer_by_layer(rng):
    codes = rng.integers(0, 4, size=(3, 70, 20)).astype(np.uint8)
    got = tops.pack_weight_codes(torch.from_numpy(codes), 2)
    for i in range(3):
        want = np.asarray(jops.pack_weight_codes(jnp.asarray(codes[i]), 2))
        assert np.array_equal(want.view(np.int32), got[i].numpy())


# the grid's valid cells (a group must divide n), and n = 384 with q8 in
# groups of 128 in place of the 256 that does not divide it
GRID = [(n, m, b, q, gs) for n, m, b in SHAPES for q, gs in BITS_GROUPS
        if gs < 0 or n % gs == 0] + [(384, 300, 3, 8, 128)]


@pytest.mark.parametrize("n,m,b,q,gs", GRID)
def test_quant_matmul_matches_pallas_interpret(rng, n, m, b, q, gs):
    jqt, tqt = _weights(rng, n, m, q, gs)
    a = rng.normal(size=(b, n)).astype(np.float32)
    want = np.asarray(jops.quant_matmul(jnp.asarray(a), jqt,
                                        impl="pallas_interpret"))
    got = tops.quant_matmul(torch.from_numpy(a), tqt)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)


def test_quant_matmul_blocks_and_leading_dims(rng):
    """Explicit blocks, a (2, 3, N) input and the packing-density rule."""
    jqt, tqt = _weights(rng, 256, 160, 4, -1)
    a = rng.normal(size=(2, 3, 256)).astype(np.float32)
    want = np.asarray(jops.quant_matmul(jnp.asarray(a), jqt,
                                        impl="pallas_interpret", bn=64,
                                        bm=128))
    got = tops.quant_matmul(torch.from_numpy(a), tqt, bn=64, bm=128)
    assert got.shape == (2, 3, 160)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    _, t3 = _weights(rng, 128, 128, 3, -1)
    with pytest.raises(ValueError, match="packing.*density"):
        tops.quant_matmul(torch.zeros(1, 128), t3, bn=64)
    with pytest.raises(ValueError, match="impl"):
        tops.quant_matmul(torch.zeros(1, 256), tqt, impl="pallas")


@pytest.mark.parametrize("n,m,g", [(320, 200, 2), (512, 96, 4)])
def test_expand_scales_and_dequantize_match_jax(rng, n, m, g):
    jqt, tqt = _weights(rng, n, m, 2, n // g)
    assert np.array_equal(np.asarray(jq.dequantize_weights(jqt)),
                          tq.dequantize_weights(tqt).numpy())
    bn = 32
    n_pad = n + 64                    # two padded tiles of zero scales
    assert np.array_equal(np.asarray(jops._expand_scales_qt(jqt, bn, n_pad)),
                          tops._expand_scales_qt(tqt, bn, n_pad).numpy())


def test_quantized_from_numpy_carries_every_field(rng):
    jqt, tqt = _weights(rng, 96, 40, 3, 32)
    assert np.array_equal(np.asarray(jqt.values), tqt.values.numpy())
    assert tqt.values.dtype == torch.uint8
    assert np.array_equal(np.asarray(jqt.scale), tqt.scale.numpy())
    assert np.array_equal(np.asarray(jqt.col_sum), tqt.col_sum.numpy())
    assert (tqt.zero, tqt.spec.bits, tqt.spec.group_size) == (
        jqt.zero, 3, 32)


def test_cpu_tensors_run_the_plain_version_and_cache_the_words(rng):
    _, tqt = _weights(rng, 256, 40, 2, -1)
    l0, c0 = dict(tkernel.LAUNCHES), dict(tref.CALLS)
    a = torch.randn(2, 256)
    first = tops.quant_matmul(a, tqt)
    words = tqt.packed
    assert words is not None
    assert torch.equal(tops.quant_matmul(a, tqt), first)
    assert tqt.packed is words               # packed once, then reused
    assert tkernel.LAUNCHES == l0
    assert tref.CALLS["quant_matmul"] == c0["quant_matmul"] + 2


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

B, S, STEPS, MAX_SEQ = 2, 6, 3, 16


def _quantize_tree(tree, fn, names, path=()):
    if isinstance(tree, dict):
        return {k: _quantize_tree(v, fn, names, path + (k,))
                for k, v in tree.items()}
    return fn(tree) if path and path[-1] in names and tree.ndim >= 2 \
        else tree


def _jax_leaf(w, bits):
    """One JAX QuantizedTensor per matrix, stacked along the stack axis."""
    spec = jq.QuantSpec(bits=bits)
    if w.ndim == 2:
        return jq.quantize_weights(w, spec)
    parts = [jq.quantize_weights(w[i], spec) for i in range(w.shape[0])]
    return jq.QuantizedTensor(
        values=jnp.stack([p.values for p in parts]),
        scale=jnp.stack([p.scale for p in parts]), zero=parts[0].zero,
        spec=spec, col_sum=jnp.stack([p.col_sum for p in parts]))


@pytest.fixture(scope="module")
def quantized_models():
    jcfg = dataclasses.replace(j_tiny_config("llama2-7b"), dtype="float32")
    tcfg = dataclasses.replace(tiny_config("llama2-7b"), dtype="float32")
    assert QUANT_LEAF_NAMES == J_LEAF_NAMES
    jparams = j_init_params(j_param_defs(jcfg), jax.random.PRNGKey(3))
    jqp = _quantize_tree(jparams, lambda w: _jax_leaf(w, jcfg.weight_bits),
                         J_LEAF_NAMES)

    def carry(tree):
        if isinstance(tree, dict):
            return {k: carry(v) for k, v in tree.items()}
        if isinstance(tree, jq.QuantizedTensor):
            return _carry(tree)
        return convert.params_from_numpy(np.asarray(tree), "cpu")

    return jcfg, tcfg, jqp, carry(jqp)


@pytest.mark.parametrize("engine", [False, True])
def test_quantized_leaf_model_matches_jax(rng, quantized_models, engine):
    """Prefill and decode logits of the port on QuantizedTensor leaves (B5's
    plain version in every linear) against the JAX model on the same leaves
    through its Pallas kernel; with an EngineLinear the leaves take its
    backend's impl, as JAX's take the engine's `.mode`."""
    jcfg, tcfg, jqp, tqp = quantized_models
    jm = JModel(jcfg, impl=jbackends.PALLAS_INTERPRET)
    tm = Model(tcfg, impl=EngineLinear(MVDRAMEngine()) if engine else None)
    toks = rng.integers(0, tcfg.vocab_size, size=(B, S + STEPS))
    c0 = tref.CALLS["quant_matmul"]
    jl, jc = jm.prefill(jqp, {"tokens": jnp.asarray(toks[:, :S])}, MAX_SEQ)
    with torch.no_grad():
        tl, tc = tm.prefill(tqp, {"tokens": torch.from_numpy(toks[:, :S])},
                            MAX_SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for t in range(S, S + STEPS):
        jl, jc = jm.decode_step(jqp, jc, jnp.asarray(toks[:, t]),
                                jnp.int32(t))
        with torch.no_grad():
            tl, tc = tm.decode_step(tqp, tc, torch.from_numpy(toks[:, t]),
                                    t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"decode step {t}")
    # 7 linears per layer and the lm_head, per forward pass
    per_pass = 7 * tcfg.num_layers + 1
    assert tref.CALLS["quant_matmul"] - c0 == per_pass * (1 + STEPS)
