"""Public entry points of the fused-dequant matmul, the processor-side
baseline the paper compares MVDRAM against (port of the JAX package's
`kernels/quant_matmul/ops.py`).

Same blocking as the JAX function (`_pick_blocks` with the group-size
rule) and the port's impl strings: `impl="kernel"` goes to the kernel
wrapper (the CUDA kernel for CUDA tensors, its plain version for CPU
tensors), `impl="reference"` always to the plain version.

The JAX function packs the codes on every call. Weights are static, so the
port packs a leaf once and keeps the words on it (`QuantizedTensor.packed`,
see `packed_codes`): the numbers are the same. The kernel reads the words
unpadded and masks the ragged end of N and M itself, where the JAX function
pads the words and scales to its blocks.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.quant import QuantizedTensor
from ..bitplane_gemv.ops import _pad_axis, _pick_blocks
from . import kernel, ref

IMPLS = ("kernel", "reference")


def pack_weight_codes(values: torch.Tensor, q: int) -> torch.Tensor:
    """(..., N, M) uint codes → (..., ceil(N/per), M) int32, per = 32 // q
    codes per word packed along N (code j of word w, row w·per + j, at bits
    [jq, (j+1)q)): the JAX package's uint32 words as int32 bit patterns."""
    if values.ndim > 2:
        return torch.stack([pack_weight_codes(v, q) for v in values])
    per = 32 // q
    v = _pad_axis(values.to(torch.int64), per, 0)
    n, m = v.shape
    shifts = torch.arange(per, dtype=torch.int64,
                          device=v.device)[None, :, None] * q
    words = (v.reshape(n // per, per, m) << shifts).sum(dim=1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def packed_codes(wq: QuantizedTensor) -> torch.Tensor:
    """The leaf's packed words, packed on first use and kept on the leaf.
    A layer-stacked leaf packs every layer at once; its layers (indexed
    with `wq[i]`) then carry their slice of the words."""
    if wq.packed is None:
        wq.packed = pack_weight_codes(wq.values, wq.bits)
    return wq.packed


def _expand_scales_qt(wq: QuantizedTensor, bn: int, n_pad: int
                      ) -> torch.Tensor:
    """(G, M) group scales → (n_pad/bn, M) per-reduction-tile scales; rows
    of tiles that start at or past N are zero."""
    g, m = wq.scale.shape
    n = wq.values.shape[0]
    gs = n // g
    tiles = n_pad // bn
    if g == 1:
        s = wq.scale.expand(tiles, m)
    else:
        if gs % bn:
            raise ValueError(f"group size {gs} must be a multiple of bn={bn}")
        s = torch.repeat_interleave(wq.scale, gs // bn, dim=0)
        s = _pad_axis(s, tiles, 0)[:tiles]
    starts = torch.arange(tiles, device=s.device) * bn
    return torch.where((starts < n)[:, None], s,
                       torch.zeros((), dtype=s.dtype, device=s.device))


def quant_matmul(a: torch.Tensor, wq: QuantizedTensor, *,
                 impl: str = "kernel", bn: Optional[int] = None,
                 bm: Optional[int] = None) -> torch.Tensor:
    """Float activations (…, N) × packed q-bit codes → (…, M) f32. `bm`
    is checked as the JAX function checks it; the kernel's own column
    strip is fixed."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1]).to(torch.float32)
    n, m = wq.values.shape
    q = wq.bits
    g = wq.scale.shape[0]
    bn, bm = _pick_blocks(n, m, bn, bm, n // g if g > 1 else None)
    per = 32 // q
    if bn % per != 0:
        raise ValueError(
            f"reduction block bn={bn} must be a multiple of the packing "
            f"density 32//q={per} (q={q}, weight shape {(n, m)})")
    a2 = _pad_axis(a2, bn, 1).contiguous()
    scale_t = _expand_scales_qt(wq, bn, a2.shape[1]).contiguous()
    fn = kernel.quant_matmul if impl == "kernel" else ref.quant_matmul_ref
    out = fn(a2, packed_codes(wq), scale_t, q=q, zero=wq.zero, bn=bn)
    return out.reshape(*lead, m)
