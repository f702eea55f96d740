"""Low-bit quantization substrate (port of `repro.core.quant`).

MVDRAM operates on low-bit (1..8 bit) unsigned codes with a zero-point
offset; the signed result is recovered on the processor side:

    a = a_u - z_a,  w = w_u - z_w
    o = Σ a_u w_u  -  z_a Σ w_u  -  z_w Σ a_u  +  N z_a z_w

Codes and scales here are bit-for-bit those of the JAX package: the scale is
`absmax / max(levels//2 - 0.5, 0.5)` taken as a true IEEE divide, and codes
round half-to-even (`torch.round`, like `jnp.round`), all eager. A scale
moved by one ulp flips codes, so nothing here may be fused or reassociated.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How a tensor is quantized.

    bits:        1..8
    symmetric:   if True zero_point = 2^(bits-1) (mid), scale covers absmax;
                 if False min/max asymmetric.
    group_size:  group length along the reduction axis; -1 = per-column.
    """

    bits: int = 4
    symmetric: bool = True
    group_size: int = -1

    @property
    def levels(self) -> int:
        return 1 << self.bits

    @property
    def zero_point(self) -> int:
        return (1 << (self.bits - 1)) if self.bits > 1 else 0


@dataclasses.dataclass
class QuantizedTensor:
    """Unsigned quantized tensor + metadata.

    values:  uint8 codes in [0, 2^bits), (N, M) for weights (N = reduction
             dim) or (..., N) for activations.
    scale:   f32, (G, M) for weights with G groups, (..., 1) for activations.
    zero:    integer zero point (static).
    col_sum: int32 Σ_j values[j, m] per output column (weights only).
    packed:  the codes packed 32/bits to a word along N, for the
             fused-dequant kernel B5; filled on first use by
             `kernels.quant_matmul.ops.packed_codes` (weights only).

    Layer-stacked weights carry a leading stack dim on every tensor field.
    """

    values: torch.Tensor
    scale: torch.Tensor
    zero: int
    spec: QuantSpec
    col_sum: Optional[torch.Tensor] = None
    packed: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def bits(self) -> int:
        return self.spec.bits

    def _map(self, fn) -> "QuantizedTensor":
        return dataclasses.replace(
            self, values=fn(self.values), scale=fn(self.scale),
            col_sum=None if self.col_sum is None else fn(self.col_sum),
            packed=None if self.packed is None else fn(self.packed))

    def __getitem__(self, i) -> "QuantizedTensor":
        """Index the leading stack dim of layer-stacked weights."""
        return self._map(lambda t: t[i])

    def to(self, device) -> "QuantizedTensor":
        return self._map(lambda t: t.to(device))


def _true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as an IEEE divide. PyTorch's CUDA division by a Python scalar
    multiplies by the scalar's reciprocal, which can move the result by one
    ulp; dividing by a tensor of the same value does not."""
    return x / torch.full_like(x, c)


def _group_reshape(x: torch.Tensor, group_size: int):
    """(N, M) -> (G, gs, M) view along the reduction dim."""
    n = x.shape[0]
    gs = n if group_size in (-1, 0) else group_size
    if n % gs:
        raise ValueError(f"reduction dim {n} not divisible by group {gs}")
    return x.reshape(n // gs, gs, *x.shape[1:]), gs


def quantize_weights(w: torch.Tensor, spec: QuantSpec) -> QuantizedTensor:
    """Quantize a (N, M) weight matrix (N = reduction dim) to unsigned
    codes."""
    if w.ndim != 2:
        raise ValueError(f"weights must be (N, M), got {tuple(w.shape)}")
    wg, _gs = _group_reshape(w.to(torch.float32), spec.group_size)
    if spec.symmetric:
        absmax = wg.abs().amax(dim=1, keepdim=True)          # (G, 1, M)
        scale = _true_div(absmax, max(spec.levels // 2 - 0.5, 0.5))
    else:
        lo = wg.amin(dim=1, keepdim=True)
        hi = wg.amax(dim=1, keepdim=True)
        scale = _true_div(hi - lo, float(max(spec.levels - 1, 1)))
    zero = spec.zero_point if spec.symmetric else spec.levels // 2
    q = torch.round(wg / scale.clamp_min(1e-12)) + zero
    q = q.clamp(0, spec.levels - 1).to(torch.uint8).reshape(w.shape)
    col_sum = q.to(torch.int32).sum(dim=0, dtype=torch.int32)
    return QuantizedTensor(values=q, scale=scale[:, 0], zero=int(zero),
                           spec=spec, col_sum=col_sum)


def quantize_activations(a: torch.Tensor, spec: QuantSpec
                         ) -> QuantizedTensor:
    """Quantize activations (..., N) per row (per token) to unsigned
    codes."""
    af = a.to(torch.float32)
    if spec.symmetric:
        absmax = af.abs().amax(dim=-1, keepdim=True)
        scale = _true_div(absmax, max(spec.levels // 2 - 0.5, 0.5))
        zero = spec.zero_point
    else:
        lo = af.amin(dim=-1, keepdim=True)
        hi = af.amax(dim=-1, keepdim=True)
        scale = _true_div(hi - lo, float(max(spec.levels - 1, 1)))
        zero = spec.levels // 2
    q = (torch.round(af / scale.clamp_min(1e-12)) + zero
         ).clamp(0, spec.levels - 1).to(torch.uint8)
    return QuantizedTensor(values=q, scale=scale, zero=int(zero), spec=spec)


def dequantize_weights(qt: QuantizedTensor) -> torch.Tensor:
    """Back to f32 (N, M)."""
    n, m = qt.values.shape
    g = qt.scale.shape[0]
    vg = qt.values.reshape(g, n // g, m).to(torch.float32)
    return ((vg - qt.zero) * qt.scale[:, None, :]).reshape(n, m)


def dequantize_activations(qt: QuantizedTensor) -> torch.Tensor:
    return (qt.values.to(torch.float32) - qt.zero) * qt.scale


def quantized_gemv_reference(aq: QuantizedTensor, wq: QuantizedTensor
                             ) -> torch.Tensor:
    """Integer-domain GeMV with processor-side zero-point correction — the
    algebra MVDRAM executes (unsigned integer MACs in DRAM, correction and
    scaling on the processor), and the oracle the PUD simulator is held
    against. Weight scale groups split the reduction dim."""
    a_u = aq.values.to(torch.int64)                 # (..., N)
    w_u = wq.values.to(device=a_u.device, dtype=torch.int64)  # (N, M)
    n = a_u.shape[-1]
    g = wq.scale.shape[0]
    gs = n // g
    a_g = a_u.reshape(*a_u.shape[:-1], g, gs)
    w_g = w_u.reshape(g, gs, -1)
    # exact integer partials per group (float64 holds every sum < 2^53)
    acc = torch.einsum("...gn,gnm->...gm", a_g.to(torch.float64),
                       w_g.to(torch.float64)).to(torch.int64)
    sum_a = a_g.sum(dim=-1)                          # (..., g)
    sum_w = w_g.sum(dim=1)                           # (g, M)
    corr = (acc - aq.zero * sum_w - wq.zero * sum_a[..., None]
            + gs * aq.zero * wq.zero)
    out = torch.einsum("...gm,gm->...m", corr.to(torch.float32),
                       wq.scale.to(a_u.device))
    return out * aq.scale.to(a_u.device)


def slice_quantized_cols(wq: QuantizedTensor, lo: int, hi: int
                         ) -> QuantizedTensor:
    """Column slice [lo, hi) of a quantized (N, M) weight tensor (views).

    Slicing COMMUTES with quantization: scales are per (group, column),
    the zero point is a tensor-wide constant and `col_sum` is per output
    column, so `slice_quantized_cols(quantize_weights(w), lo, hi)` equals
    `quantize_weights(w[:, lo:hi])` code for code — the algebra of the
    fabric's column-sharded GeMV."""
    if wq.values.ndim != 2:
        raise ValueError(
            f"column slicing needs a (N, M) weight tensor, got shape "
            f"{tuple(wq.values.shape)}")
    m = wq.values.shape[1]
    if not 0 <= lo < hi <= m:
        raise ValueError(
            f"column slice [{lo}, {hi}) out of range for M={m}")
    return QuantizedTensor(
        values=wq.values[:, lo:hi], scale=wq.scale[:, lo:hi],
        zero=wq.zero, spec=wq.spec,
        col_sum=None if wq.col_sum is None else wq.col_sum[lo:hi])


# ---------------------------------------------------------------------------
# Straight-through fake quantization (quantization-aware training, so that a
# trained model can be served through the bit-plane engine)
# ---------------------------------------------------------------------------

class _FakeQuant(torch.autograd.Function):

    @staticmethod
    def forward(ctx, w, bits, group_size):
        spec = QuantSpec(bits=bits, group_size=group_size)
        if w.ndim == 1:
            qt = quantize_weights(w[:, None], spec)
            return dequantize_weights(qt)[:, 0]
        w2 = w.reshape(w.shape[0], -1) if w.ndim > 2 else w
        return dequantize_weights(quantize_weights(w2, spec)).reshape(w.shape)

    @staticmethod
    def backward(ctx, g):
        return g, None, None            # straight through


def fake_quant(w: torch.Tensor, bits: int, group_size: int) -> torch.Tensor:
    """Quantize then dequantize (float32 out) with a straight-through
    gradient. A 1-D leaf is one column; a leaf of more than 2 dims is
    (shape[0], rest)."""
    return _FakeQuant.apply(w, bits, group_size)


# Code words are computed in int64 (torch has no uint32 arithmetic on every
# device) and stored as int32 bit patterns, the port's convention for
# uint32 words (as `BitplaneWeights.planes`).

def pack_codes(values: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack uint codes along the LAST axis into 32-bit words (little-endian
    within the word; int32 bit patterns); zero-pads to a word boundary."""
    per = 32 // bits
    *lead, n = values.shape
    pad = (-n) % per
    v = values.to(torch.int64)
    if pad:
        v = torch.cat([v, v.new_zeros((*lead, pad))], dim=-1)
        n += pad
    shifts = torch.arange(per, dtype=torch.int64, device=v.device) * bits
    words = (v.reshape(*lead, n // per, per) << shifts).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words
                       ).to(torch.int32)


def unpack_codes(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """The inverse of `pack_codes`: (..., W) words (int32 bit patterns, or
    any integer type holding the uint32 value) → (..., n) uint8 codes."""
    per = 32 // bits
    shifts = torch.arange(per, dtype=torch.int64,
                          device=packed.device) * bits
    words = packed.to(torch.int64) & 0xFFFFFFFF
    v = (words[..., None] >> shifts) & ((1 << bits) - 1)
    return v.reshape(*packed.shape[:-1], packed.shape[-1] * per
                     )[..., :n].to(torch.uint8)
