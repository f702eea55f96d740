"""Parameter definitions (port of the JAX package's `models/params.py`).

Model code builds a tree (nested dicts) of ParamDef — shape + logical axis
names + init — and `init_params` materializes it with a `torch.Generator`.
`jax.random.truncated_normal` cannot be reproduced in PyTorch, so tests that
compare with the JAX package carry its parameters across instead
(`repro_torch.convert`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim
    init: str = "normal"              # normal | zeros | ones | small_normal
    fan_in_axes: Tuple[int, ...] = () # dims whose product is fan-in
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def _fan_in(d: ParamDef) -> int:
    if not d.fan_in_axes:
        return d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
    f = 1
    for ax in d.fan_in_axes:
        f *= d.shape[ax]
    return f


def tree_map(fn, tree):
    """Map over the leaves of a nested-dict tree (dict order kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def init_params(defs, generator: torch.Generator, device=None):
    """Materialize a ParamDef tree (layout-preserving) on `device` (the
    generator's device by default), drawing leaves in tree order from
    `generator`: truncated normal at ±3σ with σ = 1/√fan_in (0.1× for
    small_normal), as the JAX package does."""
    device = torch.device(device or generator.device)

    def make(d: ParamDef):
        dt = getattr(torch, d.dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        if d.init == "arange_neg":
            h = d.shape[-1]
            base = torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                          device=device))
            return base.expand(d.shape).to(dt).clone()
        std = 1.0 / math.sqrt(_fan_in(d))
        if d.init == "small_normal":
            std *= 0.1
        t = torch.empty(d.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, std, -3 * std, 3 * std,
                                    generator=generator)
        return t.to(dt)

    return tree_map(make, defs)


def abstract_params(defs):
    """The def tree as meta-device tensors of each leaf's shape and dtype:
    shapes to build a step on without allocating (the dry-run)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=getattr(
        torch, d.dtype), device="meta"), defs)


def count_params(defs) -> int:
    return sum(d.size for d in tree_leaves(defs))


def param_bytes(defs) -> int:
    return sum(d.size * getattr(torch, d.dtype).itemsize
               for d in tree_leaves(defs))

