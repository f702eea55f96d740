"""Model → bit-plane serving transform (port of the JAX package's
`serve/quantize.py`).

Swaps every GeMV-shaped weight leaf for its packed bit-plane representation
(`BitplaneWeights`); `models.layers.dense` then routes those projections
through the bit-plane kernels. Norms, embeddings and MoE routers stay in
floating point. Routed-expert tensors are quantized per expert (E-stacked
bit planes) and served through `models.moe._expert_mm`.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.bitplane import BitplaneWeights, make_bitplane_weights
from ..core.quant import QuantSpec
from ..models.params import ParamDef, init_params

# weight-leaf basenames served by the bit-plane engine (the JAX package's
# set; in_proj/out_proj are a Mamba2 stage's, whose conv, dt, A, D and out
# norm leaves stay float). MLA's w_uk/w_uv stay float: the absorbed decode
# contracts them per head in float32 einsums, not through `dense`
QUANT_LEAF_NAMES = frozenset({
    "wq", "wk", "wv", "wo", "w_dkv",
    "up", "gate", "down", "shared_up", "shared_gate", "shared_down",
    "in_proj", "out_proj", "lm_head",
    "w_up", "w_gate", "w_down",
})


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _quantize_leaf(w: torch.Tensor, bits: int) -> BitplaneWeights:
    """One (N, M) matrix, or a stack of them quantized matrix by matrix
    (the stack's float copy is never duplicated)."""
    spec = QuantSpec(bits=bits, group_size=-1)
    if w.ndim == 2:
        return make_bitplane_weights(w, spec)
    if w.ndim == 3:
        return _stack([make_bitplane_weights(w[i], spec)
                       for i in range(w.shape[0])])
    return _stack([_quantize_leaf(w[i], bits) for i in range(w.shape[0])])


def quantize_params(params, bits: int):
    """Concrete params → serving params (bit-plane leaves swapped in).
    Leaves that are already `BitplaneWeights` pass through."""
    def fn(path, leaf):
        if (path and path[-1] in QUANT_LEAF_NAMES
                and isinstance(leaf, torch.Tensor) and leaf.ndim >= 2):
            return _quantize_leaf(leaf, bits)
        return leaf
    return _walk(params, fn)


def _stack(parts: list) -> BitplaneWeights:
    """BitplaneWeights of one shape → one with a new leading stack dim."""
    return BitplaneWeights(
        planes=torch.stack([p.planes for p in parts]),
        scale=torch.stack([p.scale for p in parts]),
        zero=parts[0].zero,
        col_sum=torch.stack([p.col_sum for p in parts]),
        n=parts[0].n, spec=parts[0].spec)


def init_quantized_params(defs, bits: int, generator: torch.Generator,
                          device=None):
    """`quantize_params(init_params(defs, generator, device), bits)`
    without the float model: each weight leaf is drawn and quantized, and
    its floats freed, before the next is drawn, a stacked leaf one index of
    its leading (layer) dim at a time. So the device holds the serving
    parameters and at most one layer's float copy of one leaf (qwen2-moe's
    routed experts: 0.74 GB of one layer's `w_up` where the whole leaf is
    17.7 GB). Each draw is `init_params` of the leaf, or of one layer of
    it, in tree order; the planes are `quantize_params`' of those floats.
    They are other random weights than `init_params` of the whole tree
    gives from the same generator: the truncated normal draws by
    rejection, so a slice's numbers depend on the slice's size."""
    def fn(path, d: ParamDef):
        if not (path and path[-1] in QUANT_LEAF_NAMES and len(d.shape) >= 2):
            return init_params(d, generator, device)
        if len(d.shape) == 2:
            return _quantize_leaf(init_params(d, generator, device), bits)
        one = dataclasses.replace(d, shape=d.shape[1:], axes=d.axes[1:])
        return _stack([_quantize_leaf(init_params(one, generator, device),
                                      bits) for _ in range(d.shape[0])])
    return _walk(defs, fn)


def quantize_defs(defs, bits: int):
    """The def tree as serving parameters without allocating (the
    dry-run): each servable leaf a `BitplaneWeights` over meta tensors —
    planes (…, bits, ⌈N/32⌉, M) int32 (the JAX package's uint32 words as
    bit patterns), scale (…, 1, M) float32, col_sum (…, M) int32 — and
    every other leaf a meta tensor of its shape and dtype."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def fn(path, d: ParamDef):
        if not (path and path[-1] in QUANT_LEAF_NAMES and len(d.shape) >= 2):
            return meta(d.shape, getattr(torch, d.dtype))
        *lead, n, m = d.shape
        spec = QuantSpec(bits=bits, group_size=-1)
        return BitplaneWeights(
            planes=meta((*lead, bits, (n + 31) // 32, m), torch.int32),
            scale=meta((*lead, 1, m), torch.float32), zero=spec.zero_point,
            col_sum=meta((*lead, m), torch.int32), n=n, spec=spec)
    return _walk(defs, fn)


def serving_bytes(defs, bits: int) -> dict:
    """Device bytes: bf16 dense vs packed bit-plane serving (the capacity
    win)."""
    dense_b = packed_b = 0

    def fn(path, d: ParamDef):
        nonlocal dense_b, packed_b
        dense_b += d.size * 2
        if path and path[-1] in QUANT_LEAF_NAMES and len(d.shape) >= 2:
            *lead, n, m = d.shape
            k = 1
            for x in lead:
                k *= x
            packed_b += k * (bits * ((n + 31) // 32) * m * 4 + m * 4 + m * 4)
        else:
            packed_b += d.size * 2
        return d

    _walk(defs, fn)
    return {"dense_bf16": dense_b, "bitplane": packed_b,
            "ratio": dense_b / max(packed_b, 1)}

