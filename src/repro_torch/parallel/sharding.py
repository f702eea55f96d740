"""Logical-axis sharding rules (port of the JAX package's
`parallel/sharding.py`).

Every parameter and activation dimension is named with a LOGICAL axis
("embed", "mlp", "heads", …). A rule table maps logical axes onto PHYSICAL
mesh axes ("pod", "data", "model"). Rules resolve defensively:

  * physical axes absent from the running mesh are dropped;
  * a dim that does not divide by its mesh axes falls back to replicated.

`logical_to_pspec` gives the same `PartitionSpec` as the JAX package for
the same mesh shape. Placing tensors by spec across several GPUs is not
ported: on a mesh of more than one device `constrain` and
`defs_to_shardings` raise rather than quietly replicate. Off-mesh and on a
one-device mesh `constrain` is the identity.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from ..launch.mesh import Mesh

DEFAULT_RULES: dict = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,           # long-context profile remaps → "data"
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    "experts": "model",
    "capacity": None,
    # parameters
    "layers": None,
    "stack": None,            # pattern-position axis of stacked stages
    "expert_mlp": None,
    "lora": None,             # MLA latent dims
    "state": None,            # SSM state / conv dims
    "conv": None,
    "inner": "model",         # SSM d_inner projections
    "fsdp_embed": ("pod", "data"),
}

LONG_CONTEXT_RULES = dict(DEFAULT_RULES, kv_seq=("model", "data"))

MULTI_DEVICE = ("placing tensors by PartitionSpec across several devices "
                "is the multi-device half of training (ROADMAP A11), not "
                "ported")


class PartitionSpec(tuple):
    """One entry a tensor dim: a mesh axis name, a tuple of them, or None
    (replicated) — `jax.sharding.PartitionSpec` as a tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (only ever built for a one-device mesh)."""

    mesh: Mesh
    spec: PartitionSpec


class _Active:
    mesh: Optional[Mesh] = None
    rules: dict = DEFAULT_RULES


_ACTIVE = _Active()


@contextlib.contextmanager
def axis_rules(mesh: Optional[Mesh], rules: Optional[dict] = None):
    """Activate (mesh, rules) for constrain()/defs_to_* inside the block."""
    prev = (_ACTIVE.mesh, _ACTIVE.rules)
    _ACTIVE.mesh = mesh
    _ACTIVE.rules = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _ACTIVE.mesh, _ACTIVE.rules = prev


def current_mesh() -> Optional[Mesh]:
    return _ACTIVE.mesh


def _resolve(axis_name: Optional[str], dim: int, mesh, rules: dict,
             taken: set) -> tuple:
    """One logical axis → tuple of usable physical axes (possibly empty)."""
    rule = rules.get(axis_name) if axis_name else None
    if rule is None:
        return ()
    phys = (rule,) if isinstance(rule, str) else tuple(rule)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    size = 1
    for ax in phys:
        if ax not in mesh.axis_names or ax in taken:
            continue
        if dim % (size * sizes[ax]):
            continue
        out.append(ax)
        size *= sizes[ax]
    return tuple(out)


def logical_to_pspec(axes, shape, mesh=None,
                     rules: Optional[dict] = None) -> PartitionSpec:
    mesh = mesh or _ACTIVE.mesh
    rules = rules or _ACTIVE.rules
    if mesh is None:
        return P()
    taken: set = set()
    parts = []
    for name, dim in zip(axes, shape):
        phys = _resolve(name, dim, mesh, rules, taken)
        taken.update(phys)
        if not phys:
            parts.append(None)
        elif len(phys) == 1:
            parts.append(phys[0])
        else:
            parts.append(tuple(phys))
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def _one_device(mesh, what: str) -> None:
    if mesh.devices.size > 1:
        raise NotImplementedError(
            f"{what} on a mesh of {mesh.devices.size} devices "
            f"{dict(zip(mesh.axis_names, mesh.devices.shape))}: "
            f"{MULTI_DEVICE}")


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """The identity off-mesh and on a one-device mesh; raises on a mesh of
    more than one device."""
    mesh = _ACTIVE.mesh
    if mesh is None:
        return x
    _one_device(mesh, "constrain")
    return x


def _map_defs(fn, defs):
    from ..models.params import ParamDef  # local: avoids import cycle
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


def defs_to_pspecs(defs, mesh=None, rules: Optional[dict] = None):
    return _map_defs(lambda d: logical_to_pspec(d.axes, d.shape, mesh,
                                                rules), defs)


def defs_to_shardings(defs, mesh=None, rules: Optional[dict] = None):
    """A tree of `NamedSharding` for a one-device mesh; raises on a mesh
    of more than one device."""
    mesh = mesh or _ACTIVE.mesh
    if mesh is None:
        raise ValueError("defs_to_shardings needs a mesh")
    _one_device(mesh, "defs_to_shardings")
    return _map_defs(lambda d: NamedSharding(
        mesh, logical_to_pspec(d.axes, d.shape, mesh, rules)), defs)


def tree_shardings_like(tree, defs, mesh=None,
                        rules: Optional[dict] = None):
    """Shardings for a VALUE tree whose structure matches the def tree
    (e.g. optimizer states replicate the param layout)."""
    sh = defs_to_shardings(defs, mesh, rules)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        return s
    return walk(tree, sh)
