"""Port parity: quantization and bit-plane packing of `repro_torch` against
the JAX package, EXACTLY (codes, scales, col_sum, packed planes).

The same numpy inputs go through both packages; a scale one ulp off would
flip codes, so every comparison is `np.array_equal`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbp
from repro.core import quant as jq
from repro_torch import convert
from repro_torch.core import bitplane as tbp
from repro_torch.core import quant as tq
from test_torch_model import fresh_jax_caches  # noqa: F401

# (n, m, groups): ragged n (not a multiple of 32), grouped scales
WEIGHT_SHAPES = [(300, 90, 1), (160, 40, 1), (320, 200, 2), (480, 130, 3),
                 (512, 256, 4)]


def _specs(bits, n, g, symmetric=True):
    gs = n // g if g > 1 else -1
    return (jq.QuantSpec(bits=bits, symmetric=symmetric, group_size=gs),
            tq.QuantSpec(bits=bits, symmetric=symmetric, group_size=gs))


@pytest.mark.parametrize("n,m,g", WEIGHT_SHAPES)
@pytest.mark.parametrize("bits", [2, 3, 4, 5])
def test_weight_codes_scales_planes_exact(rng, n, m, g, bits):
    w = rng.normal(size=(n, m)).astype(np.float32)
    js, ts = _specs(bits, n, g)
    jqt = jq.quantize_weights(jnp.asarray(w), js)
    tqt = tq.quantize_weights(torch.from_numpy(w), ts)
    assert np.array_equal(np.asarray(jqt.values), tqt.values.numpy())
    assert np.array_equal(np.asarray(jqt.scale), tqt.scale.numpy())
    assert np.array_equal(np.asarray(jqt.col_sum), tqt.col_sum.numpy())
    assert jqt.zero == tqt.zero
    jbw = jbp.make_bitplane_weights(jnp.asarray(w), js)
    tbw = tbp.make_bitplane_weights(torch.from_numpy(w), ts)
    assert np.array_equal(np.asarray(jbw.planes).view(np.int32),
                          tbw.planes.numpy())
    assert (tbw.n, tbw.bits, tbw.m) == (jbw.n, jbw.bits, jbw.m)
    np.testing.assert_array_equal(
        np.asarray(jq.dequantize_weights(jqt)),
        tq.dequantize_weights(tqt).numpy())


@pytest.mark.parametrize("bits", [2, 4])
def test_asymmetric_weights_exact(rng, bits):
    w = (rng.normal(size=(256, 64)) + 0.3).astype(np.float32)
    js, ts = _specs(bits, 256, 1, symmetric=False)
    jqt = jq.quantize_weights(jnp.asarray(w), js)
    tqt = tq.quantize_weights(torch.from_numpy(w), ts)
    assert np.array_equal(np.asarray(jqt.values), tqt.values.numpy())
    assert np.array_equal(np.asarray(jqt.scale), tqt.scale.numpy())


@pytest.mark.parametrize("shape", [(3, 300), (1, 64), (2, 5, 160)])
@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("symmetric", [True, False])
def test_activation_codes_and_scales_exact(rng, shape, bits, symmetric):
    a = (rng.normal(size=shape) * 3).astype(np.float32)
    js, ts = _specs(bits, shape[-1], 1, symmetric)
    jqt = jq.quantize_activations(jnp.asarray(a), js)
    tqt = tq.quantize_activations(torch.from_numpy(a), ts)
    assert np.array_equal(np.asarray(jqt.values), tqt.values.numpy())
    assert np.array_equal(np.asarray(jqt.scale), tqt.scale.numpy())
    assert jqt.zero == tqt.zero
    np.testing.assert_array_equal(np.asarray(jq.dequantize_activations(jqt)),
                                  tq.dequantize_activations(tqt).numpy())


@pytest.mark.parametrize("n,m,g", WEIGHT_SHAPES[:3])
@pytest.mark.parametrize("bits", [2, 5])
def test_to_quantized_round_trip(rng, n, m, g, bits):
    w = rng.normal(size=(n, m)).astype(np.float32)
    _, ts = _specs(bits, n, g)
    qt = tq.quantize_weights(torch.from_numpy(w), ts)
    back = tbp.to_quantized(tbp.from_quantized(qt))
    assert torch.equal(back.values, qt.values)
    assert torch.equal(back.scale, qt.scale)
    assert back.zero == qt.zero


def test_pack_unpack_bitplanes_match_jax(rng):
    planes = rng.integers(0, 2, size=(3, 100, 33)).astype(np.uint8)
    jp = np.asarray(jbp.pack_bitplanes(jnp.asarray(planes)))
    tp = tbp.pack_bitplanes(torch.from_numpy(planes))
    assert np.array_equal(jp.view(np.int32), tp.numpy())
    assert np.array_equal(np.asarray(jbp.unpack_bitplanes(jnp.asarray(jp),
                                                          100)),
                          tbp.unpack_bitplanes(tp, 100).numpy())
    # bit 31 of a word is the int32 sign bit: still unpacked as a 1
    assert (tp < 0).any()


def test_decompose_bits_matches_jax(rng):
    v = rng.integers(0, 32, size=(7, 9)).astype(np.uint8)
    assert np.array_equal(np.asarray(jbp.decompose_bits(jnp.asarray(v), 5)),
                          tbp.decompose_bits(torch.from_numpy(v), 5).numpy())


def test_bitplane_from_numpy_carries_jax_weights(rng):
    w = rng.normal(size=(300, 90)).astype(np.float32)
    js, ts = _specs(3, 300, 1)
    jbw = jbp.make_bitplane_weights(jnp.asarray(w), js)
    got = convert.bitplane_from_numpy(
        np.asarray(jbw.planes), np.asarray(jbw.scale), jbw.zero,
        np.asarray(jbw.col_sum), jbw.n, jbw.spec, device="cpu")
    own = tbp.make_bitplane_weights(torch.from_numpy(w), ts)
    for f in ("planes", "scale", "col_sum"):
        assert torch.equal(getattr(got, f), getattr(own, f))
    assert (got.zero, got.n, got.spec) == (own.zero, own.n, own.spec)


def test_reference_gemvs_match_jax_oracles(rng):
    """The pure-tensor oracles of core.bitplane: bit-serial exact up to the
    final f32 multiplies, float path at f32 tolerance."""
    w = rng.normal(size=(256, 48)).astype(np.float32)
    a = rng.normal(size=(2, 256)).astype(np.float32)
    js, ts = _specs(3, 256, 1)
    jbw = jbp.make_bitplane_weights(jnp.asarray(w), js)
    tbw = tbp.make_bitplane_weights(torch.from_numpy(w), ts)
    ajq = jq.quantize_activations(jnp.asarray(a), jq.QuantSpec(bits=4))
    atq = tq.quantize_activations(torch.from_numpy(a), tq.QuantSpec(bits=4))
    np.testing.assert_array_equal(
        np.asarray(jbp.bitplane_gemv_bitserial(ajq, jbw)),
        tbp.bitplane_gemv_bitserial(atq, tbw).numpy())
    ref = np.asarray(jbp.bitplane_gemv_f32(jnp.asarray(a), jbw))
    np.testing.assert_allclose(
        tbp.bitplane_gemv_f32(torch.from_numpy(a), tbw).numpy(), ref,
        rtol=1e-5, atol=1e-5 * np.abs(ref).max())
