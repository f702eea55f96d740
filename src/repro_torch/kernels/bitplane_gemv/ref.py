"""Plain PyTorch versions of the bit-plane GeMV kernels, shape for shape.

Each function computes exactly what its CUDA kernel computes, on the same
padded inputs, and is what a wrapper runs for CPU tensors. The tests hold
these against the JAX package; `chip_smoke.py` holds the kernels against
these on the card.

Rounding rule of the integer kernels (B1, B2). Each reduction tile's
correction is an exact integer; the epilogue folds it into the output as
ONE fused multiply-add per tile, in ascending tile order:

    out = fma(f32(corr_t), scale_t, out)

which is what XLA does on the CPU for the JAX package's `out += corr·scale`.
Here that step is emulated in float64: the product of two 24-bit
significands is exact in float64, and the sum `corr·scale + out` is rounded
to odd in float64 (round to nearest, then, if the two-sum error is not
zero, the neighbour toward the error whose last significand bit is 1)
before the cast to float32. Rounding to odd with 53 ≥ 24 + 2 bits makes
the two roundings one correctly rounded fma. The activation-scale multiply
afterwards stays a separate float32 multiply.

The integer dots run in float64 too: every partial sum is an integer far
below 2^53, so they are exact, and float64 matmuls exist on both devices
(integer matmuls do not on CUDA).
"""
from __future__ import annotations

from typing import Optional

import torch

#: calls of each plain version — a run on the card shows that the main path
#: never reached them (only `chip_smoke.py`'s comparisons do)
CALLS = {"gemv_bs": 0, "gemv_f": 0, "program_gemv": 0, "gemv_f_experts": 0}


def _unpack_codes(planes: torch.Tensor, q: int, dtype) -> torch.Tensor:
    """(..., q, W, M) int32 planes → (..., W*32, M) codes Σ_i 2^i W^(i)."""
    *lead, _q, w, m = planes.shape
    shifts = torch.arange(32, dtype=torch.int32, device=planes.device)
    codes = None
    for i in range(q):
        bits = (planes[..., i, :, None, :] >> shifts[:, None]) & 1
        bits = bits.to(dtype) * float(1 << i)
        codes = bits if codes is None else codes + bits
    return codes.reshape(*lead, w * 32, m)


def fma_f32(c: torch.Tensor, s: torch.Tensor, o: torch.Tensor
            ) -> torch.Tensor:
    """Correctly rounded float32 fma(c, s, o) of float32 operands: the
    exact product in float64, the sum rounded to odd in float64, then one
    cast to float32."""
    p = c.to(torch.float64) * s.to(torch.float64)         # exact
    o = o.to(torch.float64)
    r = p + o
    t = r - p                                             # two-sum error
    err = (p - (r - t)) + (o - t)
    even = (r.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(r.dtype)
    r = torch.where((err != 0) & even, torch.nextafter(r, toward), r)
    return r.to(torch.float32)


def _fma_chain(corr: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """corr (..., T, B, M) exact integers (float64), scales (..., T, 1, M)
    f32 → Σ_t in ascending order as `out = fma(f32(corr_t), scale_t, out)`."""
    c32 = corr.to(torch.float32)
    out = torch.zeros_like(c32[..., 0, :, :])
    for t in range(corr.shape[-3]):
        out = fma_f32(c32[..., t, :, :], scales[..., t, :, :], out)
    return out


def _pad_words(planes: torch.Tensor, n: int) -> torch.Tensor:
    """(q, W, M) leaf planes → (q, n/32, M), zero words appended."""
    pad = n // 32 - planes.shape[1]
    return torch.nn.functional.pad(planes, (0, 0, 0, pad)) if pad else planes


def gemv_bs_ref(a_codes, planes, scale_tiles, *, q: int, p: int, z_a: int,
                z_w: int, bn: int, fidelity: str = "code") -> torch.Tensor:
    """Same contract as `kernel.gemv_bs`: a_codes (B, N) uint8 padded with
    z_a; planes (q, W, M) int32 with W ≤ N/32 (missing words are zero
    bits); scale_tiles (N/bn, M) f32 → (B, M). `fidelity="code"` takes one
    dot per weight plane against the codes, `"bitserial"` the q·p dots of
    the decomposed planes — identical integers."""
    CALLS["gemv_bs"] += 1
    return _gemv_bs(a_codes, planes, scale_tiles, q=q, p=p, z_a=z_a,
                    z_w=z_w, bn=bn, fidelity=fidelity)


def _gemv_bs(a_codes, planes, scale_tiles, *, q, p, z_a, z_w, bn,
             fidelity):
    """`gemv_bs_ref`'s arithmetic, uncounted (B2's plain version runs it
    per member)."""
    b, n = a_codes.shape
    m = planes.shape[-1]
    t = n // bn
    planes = _pad_words(planes, n)
    a = a_codes.to(torch.int64)
    a_t = (a & ((1 << p) - 1)).reshape(b, t, bn).transpose(0, 1)
    if fidelity == "code":
        w = _unpack_codes(planes, q, torch.float64).reshape(t, bn, m)
        acc = torch.matmul(a_t.to(torch.float64), w)          # (t, B, M)
    else:
        acc = 0
        for i in range(q):
            w_i = _unpack_codes(planes[i:i + 1], 1, torch.float64)
            w_i = w_i.reshape(t, bn, m)
            for k in range(p):
                a_k = ((a_t >> k) & 1).to(torch.float64)
                acc = acc + float(1 << (i + k)) * torch.matmul(a_k, w_i)
        w = _unpack_codes(planes, q, torch.float64).reshape(t, bn, m)
    col_sum = w.sum(dim=1, keepdim=True)                       # (t, 1, M)
    sum_a = a.reshape(b, t, bn).sum(-1).T[..., None].to(torch.float64)
    corr = acc - z_a * col_sum - z_w * sum_a + bn * z_a * z_w
    return _fma_chain(corr, scale_tiles[:, None, :])


def gemv_f_ref(a, planes, scale_tiles, *, q: int, zero: int,
               bn: int) -> torch.Tensor:
    """Same contract as `kernel.gemv_f`: a (B, N) f32 padded with 0;
    planes and scale_tiles as `gemv_bs_ref` → (B, M) f32."""
    CALLS["gemv_f"] += 1
    return _gemv_f(a, planes, scale_tiles, q=q, zero=zero, bn=bn)


def _gemv_f(a, planes, scale_tiles, *, q, zero, bn):
    """`gemv_f_ref`'s arithmetic, uncounted (the stacked plain version
    runs it per expert)."""
    b, n = a.shape
    m = planes.shape[-1]
    t = n // bn
    planes = _pad_words(planes, n)
    a_t = a.to(torch.float32).reshape(b, t, bn).transpose(0, 1)  # (t,B,bn)
    acc = None
    for i in range(q):
        w_i = _unpack_codes(planes[i:i + 1], 1, torch.float32)
        part = torch.matmul(a_t, w_i.reshape(t, bn, m)) * float(1 << i)
        acc = part if acc is None else acc + part
    corr = acc - zero * a_t.sum(-1, keepdim=True)               # (t, B, M)
    return torch.einsum("tbm,tm->bm", corr, scale_tiles.to(torch.float32))


def gemv_f_experts_ref(a, planes, scale_tiles, counts=None, *, q: int,
                       zero: int, bn: int,
                       live: Optional[int] = None) -> torch.Tensor:
    """Same contract as `kernel.gemv_f_experts`: a (E, R, N) f32 padded
    with 0 to a multiple of bn, or bf16 unpadded (widened to f32 and padded
    here, as the TPU kernel widens its block); planes (E, q, W, M) int32;
    scale_tiles (E, N/bn, M) f32 (any strides); counts (E,) int32 or None;
    live: at most that many experts have rows (counts given) → (E, R, M)
    f32: B3's plain version per expert, expert e's rows at and past
    counts[e] taken as zero. Counts one call."""
    CALLS["gemv_f_experts"] += 1
    if a.dtype == torch.bfloat16:
        a = a.to(torch.float32)
        pad = (-a.shape[2]) % bn
        if pad:
            a = torch.nn.functional.pad(a, (0, pad))
    if counts is not None:
        if live is not None and int((counts > 0).sum()) > live:
            raise ValueError(f"gemv_f_experts: {int((counts > 0).sum())} "
                             f"experts have rows, above live={live}")
        rows = torch.arange(a.shape[1], device=a.device) < counts[:, None]
        a = torch.where(rows[..., None], a, 0.0)
    return torch.stack([_gemv_f(a[e], planes[e], scale_tiles[e], q=q,
                                zero=zero, bn=bn)
                        for e in range(a.shape[0])])


def program_gemv_ref(codes_t, planes_t, scale_t, params_t, *, q_max: int,
                     p_max: int, bn: int) -> torch.Tensor:
    """Same contract as `program.program_gemv`: codes_t (S, NT, B, BN)
    uint8; planes_t (S, NT, q_max, BN/32, BM) int32; scale_t (S, NT, 1, BM)
    f32; params_t (S, NT, 4) int32 [z_a, z_w, valid, layer] → (S, B, BM).
    `bn` is the padded envelope BN, as in the kernel's epilogue."""
    CALLS["program_gemv"] += 1
    w = _unpack_codes(planes_t, q_max, torch.float64)      # (S, NT, BN, BM)
    a = codes_t.to(torch.int64)
    acc = torch.matmul((a & ((1 << p_max) - 1)).to(torch.float64), w)
    col_sum = w.sum(dim=-2, keepdim=True)                  # (S, NT, 1, BM)
    sum_a = a.sum(-1, keepdim=True).to(torch.float64)      # (S, NT, B, 1)
    z_a = params_t[..., 0, None, None].to(torch.float64)
    z_w = params_t[..., 1, None, None].to(torch.float64)
    corr = acc - z_a * col_sum - z_w * sum_a + bn * z_a * z_w
    return _fma_chain(corr, scale_t)


def group_gemv_ref(codes, planes, scale_tiles, members, cols: int, *,
                   fidelity: str = "code") -> torch.Tensor:
    """Same contract as `program.group_gemv`: member l (`members[l]`, with
    its col, q, p, z_a, z_w and bn) is `gemv_bs_ref` in its own blocking
    on codes[l] (B, >= n_pad_l), its planes (q, W, M) and tile scales
    (n_pad_l/bn, M), written to columns [col, col + M) of the (B, cols)
    output. Counts one call of B2's plain version."""
    CALLS["program_gemv"] += 1
    out = torch.zeros((codes[0].shape[0], cols), dtype=torch.float32,
                      device=codes[0].device)
    for c, pl, st, mb in zip(codes, planes, scale_tiles, members):
        out[:, mb.col:mb.col + pl.shape[-1]] = _gemv_bs(
            c[:, :st.shape[0] * mb.bn], pl, st, q=mb.q, p=mb.p, z_a=mb.z_a,
            z_w=mb.z_w, bn=mb.bn, fidelity=fidelity)
    return out
