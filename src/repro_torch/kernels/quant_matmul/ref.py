"""Plain PyTorch version of the fused-dequant matmul B5, shape for shape
(port of the JAX package's `kernels/quant_matmul/ref.py`).

It is what the wrapper runs for CPU tensors; the tests hold it against the
JAX package and `chip_smoke.py` holds the CUDA kernel against it on the
card.
"""
from __future__ import annotations

import torch

#: calls of the plain version — a run on the card shows that the main path
#: never reached it (only `chip_smoke.py`'s comparisons do)
CALLS = {"quant_matmul": 0}


def unpack_codes_axis0(words: torch.Tensor, q: int, n: int) -> torch.Tensor:
    """(W, M) int32 words (the JAX package's uint32 bit patterns) → (n, M)
    int32 codes, code j of word w at bits [jq, (j+1)q) being row w·per + j
    (per = 32 // q). Rows past the last word are zero codes."""
    per = 32 // q
    shifts = torch.arange(per, dtype=torch.int32,
                          device=words.device)[None, :, None] * q
    codes = (words[:, None, :] >> shifts) & ((1 << q) - 1)
    codes = codes.reshape(words.shape[0] * per, words.shape[-1])
    if codes.shape[0] < n:
        codes = torch.nn.functional.pad(codes, (0, 0, 0, n - codes.shape[0]))
    return codes[:n]


def quant_matmul_ref(a, codes_packed, scale_tiles, *, q: int, zero: int,
                     bn: int) -> torch.Tensor:
    """Same contract as `kernel.quant_matmul`: a (B, N) f32 padded with 0
    to a multiple of bn; codes_packed (W, M) int32 with W ≤ N/per (missing
    words are zero codes); scale_tiles (N/bn, M) f32 → (B, M) f32, the sum
    over tiles of a_t · ((codes_t − zero) · scale_t)."""
    CALLS["quant_matmul"] += 1
    b, n = a.shape
    m = codes_packed.shape[-1]
    t = n // bn
    codes = unpack_codes_axis0(codes_packed, q, n).to(torch.float32)
    w_t = (codes.reshape(t, bn, m) - zero) * scale_tiles[:, None, :]
    a_t = a.to(torch.float32).reshape(b, t, bn)
    return torch.einsum("btn,tnm->bm", a_t, w_t)
