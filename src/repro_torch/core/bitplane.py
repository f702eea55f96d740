"""Bit-plane decomposition algebra (port of `repro.core.bitplane`).

A q-bit unsigned weight matrix W_u (N×M) is decomposed into q binary planes
W^(i) with W_u = Σ_i 2^i · W^(i), so

    a_u · W_u = Σ_i 2^i (a_u · W^(i)) = Σ_i Σ_k 2^{i+k} (a^(k) · W^(i)).

Planes are stored packed, 32 reduction-dim bits per word, in the JAX
package's layout: planes (q, N/32, M), bit j of word [i, w, m] is
W^(i)[32w + j, m]. The port carries the words as int32 bit patterns (the
JAX package's uint32 reinterpreted), because PyTorch has no shifts on
uint32 on the CPU; every consumer masks after shifting, so the sign bit is
harmless.
"""
from __future__ import annotations

import dataclasses

import torch

from .quant import QuantSpec, QuantizedTensor, quantize_weights


@dataclasses.dataclass
class BitplaneWeights:
    """Packed bit-plane representation of a quantized (N, M) weight matrix.

    planes:  int32 (q, N//32, M) (leading stack dims allowed)
    scale:   f32 (G, M) per-group scales (groups along N)
    zero:    static int zero point
    col_sum: int32 (M,) = Σ_j W_u[j, m] for the zero-point correction
    n:       original reduction length
    """

    planes: torch.Tensor
    scale: torch.Tensor
    zero: int
    col_sum: torch.Tensor
    n: int
    spec: QuantSpec

    @property
    def bits(self) -> int:
        return self.planes.shape[-3]

    @property
    def m(self) -> int:
        return self.planes.shape[-1]

    def __getitem__(self, i) -> "BitplaneWeights":
        """Index the leading stack dim of layer-stacked weights."""
        return BitplaneWeights(planes=self.planes[i], scale=self.scale[i],
                               zero=self.zero, col_sum=self.col_sum[i],
                               n=self.n, spec=self.spec)

    def to(self, device) -> "BitplaneWeights":
        return dataclasses.replace(self, planes=self.planes.to(device),
                                   scale=self.scale.to(device),
                                   col_sum=self.col_sum.to(device))


def decompose_bits(values: torch.Tensor, bits: int) -> torch.Tensor:
    """uint codes -> (bits, ...) binary uint8 planes along a new leading
    axis."""
    v = values.to(torch.int32)
    return torch.stack([(v >> i) & 1 for i in range(bits)]).to(torch.uint8)


def pack_bitplanes(planes: torch.Tensor) -> torch.Tensor:
    """(q, N, M) binary -> (q, N//32, M) int32, bit j of a word = row
    n*32+j. Packs with bitwise OR (bit 31 lands on the int32 sign bit)."""
    q, n, m = planes.shape
    pad = (-n) % 32
    p = planes.to(torch.int32)
    if pad:
        p = torch.cat([p, p.new_zeros((q, pad, m))], dim=1)
    p = p.reshape(q, (n + pad) // 32, 32, m)
    out = p[:, :, 0].clone()
    for j in range(1, 32):
        out |= p[:, :, j] << j
    return out


def unpack_bitplanes(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(q, W, M) int32 -> (q, n, M) binary uint8."""
    q, w, m = packed.shape
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None, :] >> shifts[None, None, :, None]) & 1
    return bits.reshape(q, w * 32, m)[:, :n].to(torch.uint8)


def _pack_codes_planes(values: torch.Tensor, bits: int) -> torch.Tensor:
    """(N, M) uint8 codes -> (bits, N//32, M) packed planes, one plane at a
    time so a full-width matrix never holds all q unpacked planes."""
    v = values.to(torch.int32)
    return torch.cat([pack_bitplanes(((v >> i) & 1)[None])
                      for i in range(bits)])


def make_bitplane_weights(w: torch.Tensor, spec: QuantSpec
                          ) -> BitplaneWeights:
    """Quantize a dense f32 (N, M) matrix and pack it into bit planes."""
    return from_quantized(quantize_weights(w, spec))


def from_quantized(qt: QuantizedTensor) -> BitplaneWeights:
    return BitplaneWeights(planes=_pack_codes_planes(qt.values, qt.spec.bits),
                           scale=qt.scale, zero=qt.zero, col_sum=qt.col_sum,
                           n=qt.values.shape[0], spec=qt.spec)


def to_quantized(bw: BitplaneWeights) -> QuantizedTensor:
    """Exact inverse of `from_quantized`: the (N, M) unsigned codes back
    from the packed planes."""
    planes = unpack_bitplanes(bw.planes, bw.n).to(torch.int32)  # (q, N, M)
    codes = torch.zeros_like(planes[0])
    for i in range(bw.bits):
        codes |= planes[i] << i
    return QuantizedTensor(values=codes.to(torch.uint8), scale=bw.scale,
                           zero=bw.zero, spec=bw.spec, col_sum=bw.col_sum)


# ---------------------------------------------------------------------------
# Reference GeMV paths (oracles)
# ---------------------------------------------------------------------------

def bitplane_gemv_f32(a: torch.Tensor, bw: BitplaneWeights) -> torch.Tensor:
    """f32 activations × bit-plane weights:
    o = Σ_g scale_g · (Σ_i 2^i (a_g · W_g^(i)) − z_w Σ a_g)."""
    planes = unpack_bitplanes(bw.planes, bw.n).to(torch.float32)  # (q,N,M)
    af = a.to(torch.float32)
    g = bw.scale.shape[0]
    gs = bw.n // g
    a_g = af.reshape(*af.shape[:-1], g, gs)
    p_g = planes.reshape(bw.bits, g, gs, bw.m)
    acc = torch.einsum("...gn,qgnm->...qgm", a_g, p_g)
    weights = 2.0 ** torch.arange(bw.bits, dtype=torch.float32,
                                  device=a.device)
    acc = torch.einsum("...qgm,q->...gm", acc, weights)
    corr = acc - bw.zero * a_g.sum(dim=-1)[..., None]
    return torch.einsum("...gm,gm->...m", corr, bw.scale)


def bitplane_gemv_bitserial(aq: QuantizedTensor, bw: BitplaneWeights
                            ) -> torch.Tensor:
    """Fully bit-decomposed GeMV — both operands as binary planes: the exact
    integer computation MVDRAM performs in DRAM (single scale group)."""
    if bw.scale.shape[0] != 1:
        raise NotImplementedError("bit-serial path is per-partition (g==1)")
    p = aq.spec.bits
    # integer dots in float64: every partial sum is an integer < 2^53
    a_planes = decompose_bits(aq.values, p).to(torch.float64)    # (p,...,N)
    w_planes = unpack_bitplanes(bw.planes, bw.n).to(torch.float64)
    acc = torch.einsum("p...n,qnm->...pqm", a_planes, w_planes)
    dev = acc.device
    wts = 2.0 ** (torch.arange(p, device=dev)[:, None]
                  + torch.arange(bw.bits, device=dev)[None, :]).double()
    acc = torch.einsum("...pqm,pq->...m", acc, wts).to(torch.int64)
    sum_a = aq.values.to(torch.int64).sum(dim=-1, keepdim=True)
    corr = (acc - aq.zero * bw.col_sum.to(torch.int64) - bw.zero * sum_a
            + bw.n * aq.zero * bw.zero)
    return corr.to(torch.float32) * bw.scale[0] * aq.scale


def activation_plane_popcounts(aq: QuantizedTensor) -> torch.Tensor:
    """#set bits per activation plane, (p,) int64 — drives the sparsity
    skip plan and the command-count model (paper §V-D template
    selection)."""
    planes = decompose_bits(aq.values, aq.spec.bits)
    return planes.to(torch.int64).sum(dim=tuple(range(1, planes.ndim)))
