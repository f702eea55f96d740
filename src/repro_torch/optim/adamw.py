"""AdamW + schedules (port of the JAX package's `optim/adamw.py`).

State layout mirrors the parameter tree leaf for leaf: {"m": tree, "v":
tree, "count": 0-dim int32}. Moments and updates are float32 whatever the
compute dtype. The update runs IN PLACE under `torch.no_grad()` — the
port's counterpart of the JAX step's donated buffers — and returns
(params, state, metrics) as the JAX function does. The schedule is computed
on the device from `count`, so a step never waits on the host.

Leaves may be DTensor shards (the sharded trainer's): the update is
elementwise, so it runs on each rank's local shards, and the clipping norm
is the norm of the whole gradient (`global_norm`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..models.params import tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"      # cosine | linear | constant


def _as_step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32)


def linear_warmup(step, warmup: int) -> torch.Tensor:
    """min(1, (step + 1) / max(warmup, 1)) in float32."""
    return torch.clamp((_as_step(step) + 1) / max(warmup, 1), max=1.0)


def cosine_schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at `step` (an int or an int32 tensor): linear
    warmup, then cosine, linear or constant to `total_steps`, float32."""
    step = _as_step(step)
    warm = linear_warmup(step, cfg.warmup_steps)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "linear":
        return cfg.lr * warm * (1.0 - t)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def tree_leaves(tree) -> list:
    """Leaves of a nested-dict tree in sorted-key order (JAX's)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the same storage), or `x`."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _counted_once(x: torch.Tensor) -> bool:
    """Whether this rank's shard of `x` enters the global sum: a plain
    tensor always; a DTensor on the rank at coordinate 0 of every mesh
    axis that replicates it, so each element is counted once."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return True
    coord = x.device_mesh.get_coordinate()
    return all(isinstance(pl, Shard) or c == 0
               for pl, c in zip(x.placements, coord))


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²), in float32, summed leaf by leaf. Over
    DTensor leaves it is the norm of the whole tree: each rank sums its
    shards (a replicated shard on one replica only), and the sums are
    all-reduced over every axis of the mesh."""
    total, mesh = None, None
    for leaf in tree_leaves(tree):
        if hasattr(leaf, "device_mesh"):
            mesh = leaf.device_mesh
        if not _counted_once(leaf):
            continue
        s = _local(leaf).to(torch.float32).square().sum()
        total = s if total is None else total + s
    if mesh is not None:
        import torch.distributed as dist
        if total is None:
            total = torch.zeros((), dtype=torch.float32,
                                device=_local(tree_leaves(tree)[0]).device)
        for d in range(mesh.ndim):
            dist.all_reduce(total, group=mesh.get_group(d))
    return torch.sqrt(total)


def adamw_init(params) -> dict:
    leaves = tree_leaves(params)
    device = _local(leaves[0]).device if leaves else None
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(grads, state, params, cfg: AdamWConfig):
    """→ (params, state, metrics), params and state updated in place.
    Grads may be bf16 (compressed); moments and updates are float32.
    Gradients are clipped by their global norm, moments bias-corrected at
    the new count, and leaves with ndim < 2 (norms, biases) not decayed."""
    with torch.no_grad():
        count = state["count"]
        gnorm = global_norm(grads)
        if cfg.clip_norm is not None:
            scale = torch.where(gnorm > cfg.clip_norm,
                                cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                                torch.ones_like(gnorm))
        else:
            scale = torch.ones_like(gnorm)
        lr = cosine_schedule(count, cfg)
        count.add_(1)
        n = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full_like(n, cfg.b1), n)
        bc2 = 1 - torch.pow(torch.full_like(n, cfg.b2), n)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            g, m, v, p = _local(g), _local(m), _local(v), _local(p)
            g = g.to(torch.float32) * scale
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            del g
            step = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            if cfg.weight_decay and p.ndim >= 2:   # no decay on norms/bias
                step.add_(p.to(torch.float32), alpha=cfg.weight_decay)
            p.sub_(step.mul_(lr).to(p.dtype))
    return params, state, {"grad_norm": gnorm, "lr": lr}
