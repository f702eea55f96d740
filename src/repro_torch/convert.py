"""Weights carried across from the JAX package, as numpy arrays.

`jax.random` and `torch.Generator` draw different numbers from one seed, so
a test that compares the two packages builds both models from the same
numpy tree: the JAX package's parameter tree with every leaf converted by
`np.asarray` (stacked stages included). Nothing here imports JAX: the
caller hands over numpy arrays and plain attributes.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.bitplane import BitplaneWeights
from .core.quant import QuantSpec, QuantizedTensor
from .device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    # copy: JAX hands out read-only buffers
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device=None):
    """Nested dict of numpy arrays → the same tree of tensors on `device`
    (the GPU unless the caller asks for the CPU). A node with `planes`,
    `scale`, `zero`, `col_sum`, `n` and `spec` (a JAX `BitplaneWeights`
    whose arrays are numpy, stacked over layers and experts or not)
    becomes the port's `BitplaneWeights` (`bitplane_from_numpy`)."""
    device = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if hasattr(t, "planes"):
            return bitplane_from_numpy(t.planes, t.scale, t.zero, t.col_sum,
                                       t.n, t.spec, device)
        return _tensor(t, device)

    return walk(tree)


def bitplane_from_numpy(planes, scale, zero: int, col_sum, n: int, spec,
                        device=None) -> BitplaneWeights:
    """A JAX `BitplaneWeights`' fields → the port's: uint32 planes are
    reinterpreted as int32 bit patterns (leading layer and expert dims
    kept); `spec` is anything with `bits`, `symmetric` and
    `group_size`."""
    device = resolve_device(device)
    words = np.ascontiguousarray(np.asarray(planes, dtype=np.uint32))
    return BitplaneWeights(
        planes=_tensor(words.view(np.int32), device),
        scale=_tensor(np.asarray(scale, np.float32), device),
        zero=int(zero), col_sum=_tensor(np.asarray(col_sum, np.int32),
                                        device),
        n=int(n), spec=QuantSpec(bits=spec.bits, symmetric=spec.symmetric,
                                 group_size=spec.group_size))


def quantized_from_numpy(values, scale, zero: int, spec, col_sum=None,
                         device=None) -> QuantizedTensor:
    """A JAX `QuantizedTensor`'s fields → the port's: uint8 codes, f32
    scales and int32 column sums carried bit for bit (leading stack dims
    included); `spec` is anything with `bits`, `symmetric` and
    `group_size`."""
    device = resolve_device(device)
    return QuantizedTensor(
        values=_tensor(np.asarray(values, np.uint8), device),
        scale=_tensor(np.asarray(scale, np.float32), device),
        zero=int(zero),
        spec=QuantSpec(bits=spec.bits, symmetric=spec.symmetric,
                       group_size=spec.group_size),
        col_sum=None if col_sum is None else _tensor(
            np.asarray(col_sum, np.int32), device))


def opt_state_from_numpy(state, device=None) -> dict:
    """A JAX AdamW state {"m": tree, "v": tree, "count": ()} whose leaves
    are numpy → the port's (`optim.adamw`): float32 moments and a 0-dim
    int32 count on `device` (the GPU unless the caller asks for the CPU)."""
    device = resolve_device(device)

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        return _tensor(np.asarray(t, np.float32), device)
    return {"m": f32(state["m"]), "v": f32(state["v"]),
            "count": _tensor(np.asarray(state["count"], np.int32), device)}
