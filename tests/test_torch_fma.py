"""The epilogue of the integer bit-plane kernels (B1, B2) folds each tile's
correction into the output as one fused multiply-add,
`out = fma(f32(corr_t), scale_t, out)`. The plain versions emulate it in
float64 (`kernels/bitplane_gemv/ref.py:fma_f32`): the exact product, the
sum rounded to odd, one cast to float32.

Held against exact rational arithmetic rounded to nearest-even in float32
and against the JAX package's `o + c*s` under jit (one fused rounding on
the CPU): a constructed case whose float64 sum lands on a float32
midpoint, a few thousand random and near-midpoint triples, and B1's and
B2's plain versions on inputs whose second tile hits such a midpoint,
bitwise against the JAX package's kernels in interpret mode.
"""
import types
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitplane_gemv import kernel as jkernel
from repro.kernels.bitplane_gemv import program as jprog
from repro_torch.kernels.bitplane_gemv import ref
from test_torch_model import fresh_jax_caches  # noqa: F401

#: 231 · 4648233 = 2^30 − 1: a correction of 231 times a 24-bit scale
#: lands 2^-30 of a half-ulp below a float32 midpoint, inside float64's
#: rounding of the sum
C_MID, S_MID = 231, 4648233


def _round_f32(x: Fraction) -> np.float32:
    """An exact rational, rounded to nearest-even float32 (normal range)."""
    if x == 0:
        return np.float32(0.0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    unit = Fraction(2) ** (e - 23)
    mant = round(x / unit)              # Fraction rounds half to even
    return np.float32(sign * float(mant * unit))


def _oracle(c, s, o) -> np.ndarray:
    return np.array([_round_f32(Fraction(float(ci)) * Fraction(float(si))
                                + Fraction(float(oi)))
                     for ci, si, oi in zip(c, s, o)], dtype=np.float32)


def _double_rounded(c, s, o) -> np.ndarray:
    """The repaired emulation: float64 round to nearest, then float32."""
    return (c.astype(np.float64) * s.astype(np.float64)
            + o.astype(np.float64)).astype(np.float32)


_jax_fma = jax.jit(lambda o, c, s: o + c * s)


def _port(c, s, o) -> np.ndarray:
    return ref.fma_f32(*(torch.from_numpy(v) for v in (c, s, o))).numpy()


def test_constructed_midpoint_case():
    o = np.array([1 + 2.0 ** -23], np.float32)
    c = np.array([2.0 ** 23 + 1], np.float32)
    s = np.array([(2 ** 23 - 1) * 2.0 ** -70], np.float32)
    want = np.float32(1 + 2.0 ** -23)
    assert _port(c, s, o)[0] == want
    assert np.asarray(_jax_fma(o, c, s))[0] == want
    assert _oracle(c, s, o)[0] == want
    assert _double_rounded(c, s, o)[0] == np.float32(1 + 2.0 ** -22)


def _near_midpoints(rng, n):
    """Triples whose exact sum lies just inside a float32 midpoint of the
    output (either side, either sign): out has a random exponent E and
    last bit, corr·scale = ±(2^30 − 1)·2^(E−54)."""
    e = rng.integers(-30, 30, size=n)
    mant = rng.integers(1 << 23, 1 << 24, size=n)
    o = (rng.choice([-1, 1], size=n) * mant * 2.0 ** (e - 23)).astype(
        np.float32)
    s = (rng.choice([-1, 1], size=n) * S_MID * 2.0 ** (e - 54)).astype(
        np.float32)
    return np.full(n, C_MID, np.float32), s, o


def _random(rng, n):
    c = rng.integers(-(1 << 26), 1 << 26, size=n).astype(np.float32)
    s = (rng.normal(size=n) * 2.0 ** rng.integers(-40, -10, size=n)).astype(
        np.float32)
    o = (rng.normal(size=n) * 2.0 ** rng.integers(-10, 10, size=n)).astype(
        np.float32)
    return c, s, o


@pytest.mark.parametrize("kind", ["random", "near_midpoint"])
def test_triples_match_exact_rounding_and_jax(rng, kind):
    c, s, o = (_random if kind == "random" else _near_midpoints)(rng, 2000)
    want = _oracle(c, s, o)
    np.testing.assert_array_equal(_port(c, s, o), want)
    np.testing.assert_array_equal(np.asarray(_jax_fma(o, c, s)), want)
    if kind == "near_midpoint":       # the repaired rounding differed here
        assert (_double_rounded(c, s, o) != want).sum() > 500


def _midpoint_tiles(rng, m):
    """One row of codes, q8 weight planes and two tiles' scales (bn 32):
    tile 0 sets out = scale_0 (a correction of 1), tile 1 adds 231·scale_1,
    near a midpoint in every even column and at random in the odd ones."""
    n, bn = 64, 32
    codes = np.zeros((1, n), np.uint8)
    codes[0, 0] = codes[0, bn] = 1
    w = np.zeros((n, m), np.int64)
    w[0] = 1
    w[bn] = np.where(np.arange(m) % 2 == 0, C_MID,
                     rng.integers(0, 256, size=m))
    planes = np.stack([
        (((w >> i) & 1).reshape(n // 32, 32, m)
         << np.arange(32)[None, :, None]).sum(1) for i in range(8)]
    ).astype(np.uint32)
    _, s_mid, o = _near_midpoints(rng, m)
    s = np.where(np.arange(m) % 2 == 0, s_mid,
                 (rng.normal(size=m) * 2.0 ** -20).astype(np.float32))
    scales = np.stack([o, s]).astype(np.float32)
    want = _oracle(w[bn].astype(np.float32), s, o)
    return codes, planes, scales, want


def test_gemv_bs_ref_hits_midpoints_bitwise_with_jax(rng):
    m = 256
    codes, planes, scales, want = _midpoint_tiles(rng, m)
    kw = dict(q=8, p=4, z_a=0, z_w=0, bn=32)
    got = ref.gemv_bs_ref(torch.from_numpy(codes),
                          torch.from_numpy(planes.view(np.int32)),
                          torch.from_numpy(scales), **kw).numpy()
    jout = np.asarray(jkernel.gemv_bs_pallas(
        jnp.asarray(codes), jnp.asarray(planes), jnp.asarray(scales),
        bm=128, interpret=True, **kw))
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got, jout)


def test_program_gemv_ref_hits_midpoints_bitwise_with_jax(rng):
    m = 128
    codes, planes, scales, want = _midpoint_tiles(rng, m)
    # one slot of two reduction tiles, B2's packed layout
    codes_t = codes.reshape(1, 2, 32).transpose(1, 0, 2)[None]
    planes_t = planes.transpose(1, 0, 2)[None, :, :, None, :]
    scale_t = scales[None, :, None, :]
    params_t = np.array([[[0, 0, 1, 0]] * 2], np.int32)
    got = ref.program_gemv_ref(
        torch.from_numpy(codes_t), torch.from_numpy(planes_t.view(np.int32)),
        torch.from_numpy(scale_t), torch.from_numpy(params_t), q_max=8,
        p_max=4, bn=32).numpy()
    plan = types.SimpleNamespace(q_max=8, p_max=4, bn_max=32, bm_max=m)
    jout = np.asarray(jprog.program_gemv(
        plan, jnp.asarray(codes_t), jnp.asarray(planes_t),
        jnp.asarray(scale_t), jnp.asarray(params_t), interpret=True))
    np.testing.assert_array_equal(got[0, 0], want)
    np.testing.assert_array_equal(got, jout)
