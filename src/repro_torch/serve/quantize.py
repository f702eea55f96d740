"""Model → bit-plane serving transform (port of the JAX package's
`serve/quantize.py`).

Swaps every GeMV-shaped weight leaf for its packed bit-plane representation
(`BitplaneWeights`); `models.layers.dense` then routes those projections
through the bit-plane kernels. Norms and embeddings stay in floating point.
"""
from __future__ import annotations

import torch

from ..core.bitplane import BitplaneWeights, make_bitplane_weights
from ..core.quant import QuantSpec
from ..models.params import ParamDef

# weight-leaf basenames served by the bit-plane engine (the JAX package's
# set; the MoE/MLA/SSM names wait for those models' port)
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
    lead = w.shape[:-2]
    flat = w.reshape((-1,) + w.shape[-2:])
    parts = [make_bitplane_weights(flat[i], spec)
             for i in range(flat.shape[0])]

    def stack(xs):
        return torch.stack(xs).reshape(lead + xs[0].shape)

    return BitplaneWeights(
        planes=stack([p.planes for p in parts]),
        scale=stack([p.scale for p in parts]),
        zero=parts[0].zero,
        col_sum=stack([p.col_sum for p in parts]),
        n=w.shape[-2], spec=spec)


def quantize_params(params, bits: int):
    """Concrete params → serving params (bit-plane leaves swapped in).
    Leaves that are already `BitplaneWeights` pass through."""
    def fn(path, leaf):
        if (path and path[-1] in QUANT_LEAF_NAMES
                and isinstance(leaf, torch.Tensor) and leaf.ndim >= 2):
            return _quantize_leaf(leaf, bits)
        return leaf
    return _walk(params, fn)


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

