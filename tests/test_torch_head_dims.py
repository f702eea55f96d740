"""B4 (flash-decode) at head dims other than the built 32, 64, 128 and
256: the port's plain version against the JAX package's
`decode_attention_pallas` in interpret mode at D ∈ {16, 80, 112} (tiny
configs use 16, zamba2-7b 112) and at 320 and 512, above the kernel's fast
body (its generic body takes them), bf16 and int8 caches, rtol/atol 1e-5
(tests/test_decode_kernel.py's tolerance); and the wrapper's checks, which
take every D ≥ 1. The kernel itself at these dims runs on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import kernel as tkernel
from test_torch_decode_attention import TOL, _both, _cache
from test_torch_model import fresh_jax_caches  # noqa: F401


@pytest.mark.parametrize("d", [16, 80, 112, 320, 512])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("window", [None, 100])
def test_plain_version_matches_pallas_interpret_at_any_head_dim(rng, d, kv,
                                                                window):
    b, s, h, hkv = 2, 256, 4, 2
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    pos = np.array([200, 131], np.int32)
    stamps = np.tile(np.where(np.arange(s) <= 200, np.arange(s), -1)
                     .astype(np.int32), (b, 1))
    k, v, ks, vs = _cache(rng, b, s, hkv, d, kv)
    got, want = _both(pos, q, k, v, stamps, ks, vs, kv, window)
    assert got.shape == (b, h, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("d", [1, 16, 100, 112, 200, 256])
def test_wrapper_takes_every_head_dim_up_to_256(d):
    """The wrapper's checks (run here on CPU tensors) pass for any D ≤ 256,
    whether or not its K/V rows are whole 16-byte loads."""
    b, s, h = 1, 8, 2
    kv = torch.zeros((b, s, h, d), dtype=torch.bfloat16)
    tkernel._check(torch.zeros(b, dtype=torch.int32),
                   torch.zeros((b, h, d)), kv, kv.clone(),
                   torch.zeros((b, s), dtype=torch.int32), None, None)


@pytest.mark.parametrize("d", [257, 320, 512, 1000])
def test_wrapper_takes_head_dims_above_256(d):
    """Above the fast body's 256 the wrapper refuses nothing JAX takes:
    its checks pass for float and int8 caches, 16-byte rows or not."""
    b, s, h = 1, 8, 2
    pos = torch.zeros(b, dtype=torch.int32)
    st = torch.zeros((b, s), dtype=torch.int32)
    kv = torch.zeros((b, s, h, d), dtype=torch.bfloat16)
    tkernel._check(pos, torch.zeros((b, h, d)), kv, kv.clone(), st, None,
                   None)
    k8 = torch.zeros((b, s, h, d), dtype=torch.int8)
    sc = torch.ones((b, s, h))
    tkernel._check(pos, torch.zeros((b, h, d), dtype=torch.bfloat16), k8,
                   k8.clone(), st, sc, sc.clone())
