"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where no CUDA device is visible. On a GPU
machine run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The shapes cover what `chip_smoke.py`'s llama2-7b shapes do not: output
widths that are not a multiple of the 32-column strip, more than one
8-row group of the batch, ragged reduction tails and grouped scales.
"""
import pytest
import torch

from repro_torch.core.bitplane import make_bitplane_weights
from repro_torch.core.quant import QuantSpec
from repro_torch.kernels.bitplane_gemv import kernel, ops, program, ref

pytestmark = pytest.mark.cuda

# (n, m, q, p, groups, B)
SHAPES = [(300, 90, 2, 4, 1, 3), (1000, 130, 3, 2, 1, 11),
          (512, 40, 5, 4, 2, 1), (4096, 200, 2, 4, 1, 17),
          (11008, 64, 2, 8, 1, 4)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _leaf(gen, n, m, q, g):
    w = torch.randn((n, m), generator=gen, device="cuda")
    return make_bitplane_weights(
        w, QuantSpec(bits=q, group_size=n // g if g > 1 else -1))


@pytest.mark.parametrize("n,m,q,p,g,b", SHAPES)
def test_gemv_bs_bitwise_equals_plain(gen, n, m, q, p, g, b):
    bw = _leaf(gen, n, m, q, g)
    x = torch.randn((b, n), generator=gen, device="cuda")
    k0 = kernel.LAUNCHES["gemv_bs"]
    got = ops.bitplane_gemv_bitserial(x, bw, QuantSpec(bits=p))
    want = ops.bitplane_gemv_bitserial(x, bw, QuantSpec(bits=p),
                                       impl="reference")
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["gemv_bs"] == k0 + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,m,q,p,g,b", SHAPES)
def test_gemv_f_within_tolerance(gen, n, m, q, p, g, b):
    bw = _leaf(gen, n, m, q, g)
    x = torch.randn((b, n), generator=gen, device="cuda")
    got = ops.bitplane_gemv(x, bw)
    want = ops.bitplane_gemv(x, bw, impl="reference")
    torch.cuda.synchronize()
    tol = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("b", [1, 4, 9])
def test_program_gemv_bitwise_equals_plain_and_per_leaf(gen, b):
    ws = [_leaf(gen, 300, m, q, 1) for m, q in ((90, 2), (130, 3), (40, 4))]
    x = torch.randn((b, 300), generator=gen, device="cuda")
    c0 = dict(ref.CALLS)
    fused = program.fused_group_linears(x, ws, 4)
    assert ref.CALLS == c0                   # no plain version on the card
    spec = QuantSpec(bits=4)
    for f, w in zip(fused, ws):
        assert torch.equal(f, ops.bitplane_gemv_bitserial(x, w, spec))
        assert torch.equal(f, ops.bitplane_gemv_bitserial(
            x, w, spec, impl="reference"))


def test_wrappers_reject_bad_inputs(gen):
    bw = _leaf(gen, 256, 64, 2, 1)
    codes = torch.zeros((2, 256), dtype=torch.uint8, device="cuda")
    scales = torch.zeros((1, 64), device="cuda")
    with pytest.raises(ValueError, match="int32"):
        kernel.gemv_bs(codes, bw.planes.float(), scales, q=2, p=4, z_a=8,
                       z_w=2, bn=256)
    with pytest.raises(ValueError, match="bn"):
        kernel.gemv_bs(codes, bw.planes, scales, q=2, p=4, z_a=8, z_w=2,
                       bn=1024)
    with pytest.raises(ValueError, match="cpu"):
        kernel.gemv_bs(codes, bw.planes.cpu(), scales, q=2, p=4, z_a=8,
                       z_w=2, bn=256)
