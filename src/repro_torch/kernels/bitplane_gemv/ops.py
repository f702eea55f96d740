"""Public entry points for bit-plane GeMV (port of the JAX package's
`kernels/bitplane_gemv/ops.py`).

Handles padding of the activations to the reduction block, scale expansion
to per-reduction-tile rows, activation quantization for the bit-serial mode
and dispatch: `impl="kernel"` goes to the kernel wrappers (the CUDA kernel
for CUDA tensors, its plain version for CPU tensors), `impl="reference"`
always to the plain versions. The blocking is the JAX package's
(`_pick_blocks`), so the per-tile accumulation order is the reference's.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.bitplane import BitplaneWeights
from ...core.quant import QuantSpec, quantize_activations
from . import kernel, ref

DEFAULT_BN = 512   # reduction-dim block (multiple of 32-bit packing)
DEFAULT_BM = 256   # output-dim block
IMPLS = ("kernel", "reference")


def _pick_blocks(n: int, m: int, bn: Optional[int], bm: Optional[int],
                 group_size: Optional[int] = None):
    bn = bn or min(DEFAULT_BN, n)
    bm = bm or min(DEFAULT_BM, m)
    if group_size and group_size > 0:
        if group_size % 32 != 0:
            raise ValueError(
                f"scale group size must be a multiple of 32 (the bit-plane "
                f"word width), got group_size={group_size} for an "
                f"(N={n}, M={m}) matrix")
        bn = min(bn, group_size)   # per-group scales stay tile-local
    bn = max(32, (bn // 32) * 32)
    # bm stays a multiple of 128 even when m < 128 (the fused program's
    # envelope pads small layers up to it)
    bm = max(128, (bm // 128) * 128)
    return bn, bm


def _pad_axis(x: torch.Tensor, mult: int, axis: int, value=0
              ) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if not pad:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    return torch.nn.functional.pad(x, widths, value=value)


def _expand_scales(bw: BitplaneWeights, bn: int, n_pad: int
                   ) -> torch.Tensor:
    """(G, M) group scales → (n_pad//bn, M) per-reduction-tile scales.
    Scale rows of tiles that start at or past the true reduction length are
    zero, so padded tiles contribute nothing."""
    g, m = bw.scale.shape
    gs = bw.n // g
    tiles = n_pad // bn
    if g == 1:
        s = bw.scale.expand(tiles, m)
    else:
        if gs % bn:
            raise ValueError(f"group size {gs} must be a multiple of bn={bn}")
        s = torch.repeat_interleave(bw.scale, gs // bn, dim=0)
        s = _pad_axis(s, tiles, 0)[:tiles]
    starts = torch.arange(tiles, device=s.device) * bn
    return torch.where((starts < bw.n)[:, None], s,
                       torch.zeros((), dtype=s.dtype, device=s.device))


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def bitplane_gemv(a: torch.Tensor, bw: BitplaneWeights, *,
                  impl: str = "kernel", bn: Optional[int] = None,
                  bm: Optional[int] = None,
                  counts: Optional[torch.Tensor] = None,
                  live: Optional[int] = None) -> torch.Tensor:
    """Float activations (…, N) × packed bit-plane weights → (…, M) f32.

    An expert stack — planes (E, q, W, M) — takes activations (E, R, N)
    and gives (E, R, M), expert e's rows through expert e's matrix (the
    JAX package's `jax.vmap` over the experts), in ONE launch. `counts`
    (E,) int32, stacks only: expert e's rows at and past counts[e] are
    taken as zero (their outputs are zero); `live` (with counts): at most
    that many experts have rows."""
    _check_impl(impl)
    if bw.planes.ndim == 4:
        return _gemv_experts(a, bw, impl, bn, bm, counts, live)
    if counts is not None or live is not None:
        raise ValueError("counts and live apply to an expert stack only")
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1]).to(torch.float32)
    g = bw.scale.shape[0]
    bn, _bm = _pick_blocks(bw.n, bw.m, bn, bm,
                           bw.n // g if g > 1 else None)
    a2 = _pad_axis(a2, bn, 1).contiguous()
    scale_t = _expand_scales(bw, bn, a2.shape[1])
    fn = kernel.gemv_f if impl == "kernel" else ref.gemv_f_ref
    out = fn(a2, bw.planes, scale_t, q=bw.bits, zero=bw.zero, bn=bn)
    return out.reshape(*lead, bw.m)


def _gemv_experts(a, bw, impl, bn, bm, counts, live) -> torch.Tensor:
    """`bitplane_gemv` on an expert stack. A bf16 (E, R, N) stack goes to
    the kernel as it is (read in place, unpadded, on the tensor cores);
    any other is cast to f32 and padded once for B3's block body.
    Per-channel scales go to the kernel as a stride-0 view over the tiles
    (every tile of a ceil(N/bn)·bn padding starts below N)."""
    e, q, _w, m = bw.planes.shape
    if a.ndim != 3 or a.shape[0] != e or a.shape[2] != bw.n:
        raise ValueError(f"expert stack of {e} (N={bw.n}, M={m}) matrices "
                         f"needs activations (E, R, N), got "
                         f"{tuple(a.shape)}")
    g = bw.scale.shape[-2]
    bn, _bm = _pick_blocks(bw.n, m, bn, bm, bw.n // g if g > 1 else None)
    if a.dtype == torch.bfloat16:
        a3 = a.contiguous()
    else:
        a3 = _pad_axis(a.to(torch.float32), bn, 2).contiguous()
    tiles = -(-bw.n // bn)
    if g == 1:
        scale_t = bw.scale.expand(e, tiles, m)
    else:
        scale_t = torch.stack([_expand_scales(bw[i], bn, tiles * bn)
                               for i in range(e)])
    fn = kernel.gemv_f_experts if impl == "kernel" else ref.gemv_f_experts_ref
    return fn(a3, bw.planes, scale_t, counts, q=q, zero=bw.zero, bn=bn,
              live=live)


def bitplane_gemv_bitserial(a: torch.Tensor, bw: BitplaneWeights,
                            a_spec: QuantSpec, *, impl: str = "kernel",
                            bn: Optional[int] = None,
                            bm: Optional[int] = None,
                            fidelity: str = "code") -> torch.Tensor:
    """Quantize activations to p-bit codes, then integer bit-plane GeMV —
    the exact integer computation of the paper. The activation scale is a
    separate f32 multiply after the kernel."""
    aq = quantize_activations(a, a_spec)
    out = bitplane_gemv_codes(aq.values, bw, a_spec.bits, int(aq.zero),
                              impl=impl, bn=bn, bm=bm, fidelity=fidelity)
    return out * aq.scale.reshape(out.shape[:-1] + (1,))


def bitplane_gemv_codes(a_codes: torch.Tensor, bw: BitplaneWeights, p: int,
                        z_a: int, *, impl: str = "kernel",
                        bn: Optional[int] = None, bm: Optional[int] = None,
                        fidelity: str = "code") -> torch.Tensor:
    """(…, N) uint8 activation codes × bit-plane weights → un-a-scaled
    f32."""
    _check_impl(impl)
    lead = a_codes.shape[:-1]
    a2 = a_codes.reshape(-1, a_codes.shape[-1])
    g = bw.scale.shape[0]
    bn, _bm = _pick_blocks(bw.n, bw.m, bn, bm,
                           bw.n // g if g > 1 else None)
    a2 = _pad_axis(a2, bn, 1, value=z_a).contiguous()  # pad at the zero pt
    scale_t = _expand_scales(bw, bn, a2.shape[1])
    kw = dict(q=bw.bits, p=p, z_a=z_a, z_w=bw.zero, bn=bn,
              fidelity=fidelity)
    if impl == "kernel":
        out = kernel.gemv_bs(a2, bw.planes, scale_t, **kw)
    else:
        out = ref.gemv_bs_ref(a2, bw.planes, scale_t, **kw)
    return out.reshape(*lead, bw.m)
