"""Wrapper of the fused-dequant GeMV CUDA kernel B5 (`csrc/quant_matmul.cu`),
the counterpart of the JAX package's `quant_matmul_pallas`.

A CUDA tensor goes to the kernel, or the wrapper raises; a CPU tensor goes
to the plain version in `ref.py`. There is no other fallback.
"""
from __future__ import annotations

import torch

from .. import build
from ..bitplane_gemv.kernel import _sms, _stream, split_plan
from . import ref

#: launches of the CUDA kernel (the plain version counts in ref.CALLS):
#: `quant_matmul` one per call, `quant_matmul_fold` the second launch of a
#: call whose reduction is split over blocks
LAUNCHES = {"quant_matmul": 0, "quant_matmul_fold": 0}

KERNEL_BITS = (1, 2, 4, 8)   # code widths whose words the kernel unpacks


def _check(a, codes, scale_tiles, q: int, bn: int) -> None:
    what = "quant_matmul"
    for name, t, dt in (("activations", a, torch.float32),
                        ("codes", codes, torch.int32),
                        ("scales", scale_tiles, torch.float32)):
        if t.device != a.device:
            raise ValueError(f"{what}: {name} on {t.device}, activations on "
                             f"{a.device}")
        if t.dtype != dt:
            raise ValueError(f"{what}: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q not in KERNEL_BITS:
        raise ValueError(f"{what}: the kernel takes q in {KERNEL_BITS}, got "
                         f"q={q}")
    per = 32 // q
    b, n = a.shape
    w, m = codes.shape
    if bn % 32 or n % bn or not (n - bn) // per < w <= n // per:
        raise ValueError(f"{what}: codes {tuple(codes.shape)} do not fit "
                         f"q={q} and activations padded to N={n} (bn={bn})")
    if tuple(scale_tiles.shape) != (n // bn, m):
        raise ValueError(f"{what}: scales {tuple(scale_tiles.shape)} != "
                         f"{(n // bn, m)}")


def workspace_shape(splits: int, b: int, m: int) -> tuple:
    """Each split's f32 partial, (splits, B, M), that the fold sums in
    split order; nothing with one split. The split is B3's plan
    (`bitplane_gemv.kernel.split_plan`): the kernel has B3's blocking."""
    return (0,) if splits == 1 else (splits, b, m)


def quant_matmul(a, codes, scale_tiles, *, q: int, zero: int,
                 bn: int) -> torch.Tensor:
    """a (B, N) f32 padded with 0 to a multiple of bn (itself a multiple of
    32); codes (W, M) int32, the leaf's packed words, W = ceil(n/per) (the
    plain version reads words past W as zero codes; the kernel skips them,
    as their activations are the zero padding); scale_tiles (N/bn, M) f32
    → (B, M) f32."""
    if not a.is_cuda:
        return ref.quant_matmul_ref(a, codes, scale_tiles, q=q, zero=zero,
                                    bn=bn)
    _check(a, codes, scale_tiles, q, bn)
    b, n = a.shape
    w, m = codes.shape
    tiles = n // bn
    tpb, splits = split_plan(tiles, m, b, _sms(a.device))
    out = torch.empty((b, m), dtype=torch.float32, device=a.device)
    ws = torch.empty(workspace_shape(splits, b, m), dtype=torch.float32,
                     device=a.device)
    lib = build.library("quant_matmul")
    LAUNCHES["quant_matmul"] += 1
    LAUNCHES["quant_matmul_fold"] += int(splits > 1)
    build.check(lib.quant_matmul_launch(
        a.data_ptr(), codes.data_ptr(), scale_tiles.data_ptr(),
        out.data_ptr(), ws.data_ptr() if splits > 1 else None, b, n, w, m,
        q, zero, bn, tpb, splits, _stream()), "quant_matmul")
    return out
