"""Logical-axis sharding rules and placement (port of the JAX package's
`parallel/sharding.py`).

Every parameter and activation dimension is named with a LOGICAL axis
("embed", "mlp", "heads", …). A rule table maps logical axes onto PHYSICAL
mesh axes ("pod", "data", "model"). Rules resolve defensively:

  * physical axes absent from the running mesh are dropped;
  * a dim that does not divide by its mesh axes falls back to replicated.

`logical_to_pspec` gives the same `PartitionSpec` as the JAX package for
the same mesh shape. On a mesh over a process group (`launch.mesh.
make_dist_mesh`) a `NamedSharding` is a list of DTensor placements — a
mesh axis that a dim names shards that dim, every other axis replicates —
and `place` puts a tensor there. Compute stays local to a rank: the
trainer gathers the full leaves before the model runs (`train/step.py`),
so `constrain` is the identity on plain tensors and a `redistribute` on a
DTensor. Off-mesh it is the identity.
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


class PartitionSpec(tuple):
    """One entry a tensor dim: a mesh axis name, a tuple of them, or None
    (replicated) — `jax.sharding.PartitionSpec` as a tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _spec_axes(spec) -> dict:
    """Mesh axis → the tensor dim of `spec` that names it."""
    dim_of = {}
    for d, part in enumerate(spec):
        for ax in ((part,) if isinstance(part, str) else part or ()):
            dim_of[ax] = d
    return dim_of


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh. `placements`: one DTensor placement a mesh axis —
    `Shard(d)` for the axis that tensor dim d names (a dim named by a
    tuple of axes, such as ("pod", "data"), is sharded over each of them,
    in mesh-axis order), `Replicate()` for every other axis."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        from torch.distributed.tensor import Replicate, Shard
        dim_of = _spec_axes(self.spec)
        return [Shard(dim_of[ax]) if ax in dim_of else Replicate()
                for ax in self.mesh.axis_names]

    def shard_shape(self, shape) -> tuple:
        """The shape of one device's shard of a tensor of `shape`."""
        sizes = self.mesh.shape
        out = list(shape)
        for ax, d in _spec_axes(self.spec).items():
            out[d] //= sizes[ax]
        return tuple(out)


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


def batch_axes(mesh, rows: int, rules: Optional[dict] = None) -> tuple:
    """The mesh axes that split a global batch of `rows` rows (the
    "batch" rule's axes present in `mesh` that divide it)."""
    part = (logical_to_pspec(("batch",), (rows,), mesh, rules) or (None,))[0]
    return (part,) if isinstance(part, str) else tuple(part or ())


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Off-mesh, and on a plain tensor (each rank computes on its own
    full leaves), the identity; a DTensor is redistributed to the spec of
    `axes` on the active mesh."""
    mesh = _ACTIVE.mesh
    from torch.distributed.tensor import DTensor
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_pspec(axes, x.shape, mesh, _ACTIVE.rules)
    return x.redistribute(mesh.device_mesh,
                          NamedSharding(mesh, spec).placements)


def place(x, sharding):
    """`x` (the whole tensor, the same on every rank) as a DTensor laid out
    by `sharding` on its mesh's process group: each rank keeps its own
    chunk, nothing is sent. A tree of tensors takes the matching tree of
    shardings."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(x, dict):
        return {k: place(v, sharding[k]) for k, v in x.items()}
    mesh = sharding.mesh
    if mesh.device_mesh is None:
        raise ValueError(f"placing a tensor on a mesh of "
                         f"{mesh.devices.size} devices needs a process "
                         f"group (launch.mesh.make_dist_mesh)")
    return distribute_tensor(x, mesh.device_mesh, sharding.placements,
                             src_data_rank=None)


def _map_defs(fn, defs):
    from ..models.params import ParamDef  # local: avoids import cycle
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


def defs_to_pspecs(defs, mesh=None, rules: Optional[dict] = None):
    return _map_defs(lambda d: logical_to_pspec(d.axes, d.shape, mesh,
                                                rules), defs)


def defs_to_shardings(defs, mesh=None, rules: Optional[dict] = None):
    """A tree of `NamedSharding`, one a leaf of the def tree."""
    mesh = mesh or _ACTIVE.mesh
    if mesh is None:
        raise ValueError("defs_to_shardings needs a mesh")
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
