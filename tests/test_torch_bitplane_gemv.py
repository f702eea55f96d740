"""Port parity: the bit-plane GeMV entry points of `repro_torch` (on the
CPU, the plain versions of the CUDA kernels B1 and B3) against the JAX
package's Pallas kernels run in interpret mode.

B1 (`bitplane_gemv_codes`, `bitplane_gemv_bitserial`) must be BITWISE equal:
both take the exact integer correction per reduction tile and fold it into
the output with one fused multiply-add per tile, in ascending tile order.
B3 (`bitplane_gemv`) sums floats in another order: it is held at the
tolerance of tests/test_kernels.py (rtol 1e-5, atol 1e-5·max|ref|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbp
from repro.core import quant as jq
from repro.kernels.bitplane_gemv import ops as jops
from repro_torch import convert
from repro_torch.core import quant as tq
from repro_torch.kernels.bitplane_gemv import kernel as tkernel
from repro_torch.kernels.bitplane_gemv import ops as tops
from repro_torch.kernels.bitplane_gemv import ref as tref
from test_torch_model import fresh_jax_caches  # noqa: F401

# (n, m, q, p, groups) — the shape grid of tests/test_program_kernel.py:
# ragged n, m below the 128 output block, weight bits 2..5, activation
# bits 2..4, grouped scales
LAYERS = [(300, 90, 2, 2, 1), (300, 90, 3, 3, 1), (300, 90, 4, 2, 1),
          (160, 40, 5, 4, 1), (320, 200, 2, 2, 2), (480, 130, 4, 3, 3),
          (512, 256, 4, 2, 1), (256, 40, 3, 2, 1), (1000, 130, 3, 4, 1)]
# each layer at one batch size, B = 1..3 across the grid. B=2 stays off
# the first four layers: tests/test_program_kernel.py counts the JAX
# kernel's trace-time launches for exactly those at B=2, and a trace made
# earlier in the same process would be a jit-cache hit there
LAYERS_B = [(*layer, b) for layer, b in zip(LAYERS,
                                             (1, 3, 1, 3, 2, 2, 3, 1, 2))]


def _weights(rng, n, m, q, g):
    w = rng.normal(size=(n, m)).astype(np.float32)
    spec = jq.QuantSpec(bits=q, group_size=n // g if g > 1 else -1)
    jbw = jbp.make_bitplane_weights(jnp.asarray(w), spec)
    tbw = convert.bitplane_from_numpy(
        np.asarray(jbw.planes), np.asarray(jbw.scale), jbw.zero,
        np.asarray(jbw.col_sum), jbw.n, jbw.spec, device="cpu")
    return jbw, tbw


@pytest.mark.parametrize("n,m,q,p,g,B", LAYERS_B)
def test_bitserial_bitwise_equals_pallas_interpret(rng, n, m, q, p, g, B):
    jbw, tbw = _weights(rng, n, m, q, g)
    a = (rng.normal(size=(B, n)) * 2).astype(np.float32)
    want = np.asarray(jops.bitplane_gemv_bitserial(
        jnp.asarray(a), jbw, jq.QuantSpec(bits=p), impl="pallas_interpret"))
    got = tops.bitplane_gemv_bitserial(torch.from_numpy(a), tbw,
                                       tq.QuantSpec(bits=p))
    assert got.dtype == torch.float32 and got.shape == (B, m)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,m,q,p,g", LAYERS[:5])
def test_codes_bitwise_equals_pallas_interpret(rng, n, m, q, p, g):
    """Un-activation-scaled integer path on raw codes, lead dims kept."""
    jbw, tbw = _weights(rng, n, m, q, g)
    codes = rng.integers(0, 1 << p, size=(2, 2, n)).astype(np.uint8)
    z_a = 1 << (p - 1)
    want = np.asarray(jops.bitplane_gemv_codes(
        jnp.asarray(codes), jbw, p, z_a, impl="pallas_interpret"))
    got = tops.bitplane_gemv_codes(torch.from_numpy(codes), tbw, p, z_a)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,m,q,p,g", LAYERS[::2])
def test_bitserial_fidelity_equals_code(rng, n, m, q, p, g):
    _, tbw = _weights(rng, n, m, q, g)
    a = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    spec = tq.QuantSpec(bits=p)
    code = tops.bitplane_gemv_bitserial(a, tbw, spec, fidelity="code")
    bits = tops.bitplane_gemv_bitserial(a, tbw, spec, fidelity="bitserial")
    assert torch.equal(code, bits)
    ref = tops.bitplane_gemv_bitserial(a, tbw, spec, impl="reference")
    assert torch.equal(code, ref)


@pytest.mark.parametrize("n,m,q,p,g,B", LAYERS_B)
def test_float_gemv_within_tolerance(rng, n, m, q, p, g, B):
    jbw, tbw = _weights(rng, n, m, q, g)
    a = rng.normal(size=(B, n)).astype(np.float32)
    want = np.asarray(jops.bitplane_gemv(jnp.asarray(a), jbw,
                                         impl="pallas_interpret"))
    got = tops.bitplane_gemv(torch.from_numpy(a), tbw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_cpu_tensors_run_the_plain_versions(rng):
    """A wrapper takes its plain version only because the tensor lies on
    the CPU: the kernel launch counters stay put, the plain ones move."""
    _, tbw = _weights(rng, 256, 40, 3, 1)
    a = torch.from_numpy(rng.normal(size=(2, 256)).astype(np.float32))
    k0, r0 = dict(tkernel.LAUNCHES), dict(tref.CALLS)
    tops.bitplane_gemv(a, tbw)
    tops.bitplane_gemv_bitserial(a, tbw, tq.QuantSpec(bits=4))
    assert tkernel.LAUNCHES == k0
    assert tref.CALLS["gemv_f"] == r0["gemv_f"] + 1
    assert tref.CALLS["gemv_bs"] == r0["gemv_bs"] + 1


def test_blocking_matches_jax():
    for args in [(300, 90, None, None, None), (11008, 4096, None, None,
                                               None),
                 (4096, 32000, None, None, None), (320, 200, None, None, 160),
                 (256, 40, 64, 64, None)]:
        assert tops._pick_blocks(*args) == jops._pick_blocks(*args)
    with pytest.raises(ValueError, match="group_size=48"):
        tops._pick_blocks(512, 256, None, None, 48)


@pytest.mark.parametrize("n,m,q,p,g", [(300, 90, 2, 2, 1),
                                       (480, 130, 4, 3, 3)])
def test_expand_scales_matches_jax(rng, n, m, q, p, g):
    jbw, tbw = _weights(rng, n, m, q, g)
    bn, _ = tops._pick_blocks(n, m, None, None, n // g if g > 1 else None)
    n_pad = -(-n // bn) * bn
    assert np.array_equal(np.asarray(jops._expand_scales(jbw, bn, n_pad)),
                          tops._expand_scales(tbw, bn, n_pad).numpy())


def test_value_errors(rng):
    _, tbw = _weights(rng, 256, 40, 3, 1)
    a = torch.zeros((2, 256))
    with pytest.raises(ValueError, match="impl"):
        tops.bitplane_gemv(a, tbw, impl="pallas")
    with pytest.raises(ValueError, match=r"fidelity.*nope.*\(2, 256\)"):
        tkernel.gemv_bs(torch.zeros((2, 256), dtype=torch.uint8),
                        tbw.planes, torch.zeros((1, 40)), q=3, p=2, z_a=0,
                        z_w=0, bn=256, fidelity="nope")
