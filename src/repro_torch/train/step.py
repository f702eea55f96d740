"""Loss + train step (port of the JAX package's `train/step.py`).

Microbatched gradient accumulation (activation memory ∝ microbatch, not
global batch) in float32, optional remat of the whole loss, bf16 gradient
compression (`parallel.compress`), AdamW in float32, in place.

On a mesh over a process group (`launch.mesh.make_dist_mesh`) the step is
SHARDED, with GSPMD's semantics: each rank holds its shard of every
parameter and moment (DTensors placed by the leaves' logical specs), and a
step

  1. gathers the full float parameters;
  2. runs the unmodified `accumulate_grads` on the rank's rows of the
     global batch — the rows its coordinates on the batch axes ("pod",
     "data") own; ranks that differ only on "model" compute the same rows;
  3. takes the gradient mean over the batch axes (in bf16 when gradients
     are compressed) straight into each parameter's shard layout
     (reduce-scatter or all-reduce), and runs AdamW on the local shards.

The metrics are the global ones (means over the batch axes; `grad_norm`
the norm of the whole gradient).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..models.model import Model
from ..optim.adamw import AdamWConfig, adamw_update, tree_leaves
from ..parallel.compress import compress_tree_for_sync
from ..parallel.sharding import DEFAULT_RULES, batch_axes, constrain


def loss_fn(model: Model, params, batch, z_loss: float = 1e-4):
    """→ (loss, metrics): mean next-token cross-entropy (over `mask`'s
    positions when the batch has one) + z_loss·mean(logsumexp²) + the MoE
    routers' aux loss; `ppl` is exp(ce) clipped at exp(20)."""
    logits, aux = model.forward(params, batch)     # (B,S,V) f32
    labels = batch["labels"].to(torch.int64)
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - torch.gather(logits, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is not None:
        mask = mask.to(torch.float32)
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = (nll * mask).sum() / denom
        zl = (logz.square() * mask).sum() / denom
    else:
        ce = nll.mean()
        zl = logz.square().mean()
    loss = ce + z_loss * zl + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux,
                  "ppl": torch.exp(torch.clamp(ce, max=20.0))}


def _microbatch_stack(batch, k: int) -> dict:
    """(B, …) → (k, B/k, …) views, microbatch i taking rows i, k+i, 2k+i, …
    (the JAX package's STRIDED layout, which keeps every microbatch
    sharded like the full batch)."""
    def f(x):
        b = x.shape[0]
        return x.reshape(b // k, k, *x.shape[1:]).transpose(0, 1)
    return {name: f(x) for name, x in batch.items()}


def _tree_like(tree, leaves):
    """A tree of `tree`'s structure with `leaves` (an iterator, or a list)
    in sorted-key order. (A top-level recursion: a nested recursive
    closure would be a reference cycle that keeps the leaves — a whole
    gradient tree — alive until the cyclic collector runs.)"""
    leaves = iter(leaves)
    if isinstance(tree, dict):
        return {k: _tree_like(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def accumulate_grads(model: Model, params, batch, num_microbatches: int = 1,
                     z_loss: float = 1e-4, remat: bool = False):
    """→ (float32 gradient tree of `params`' structure, the last
    microbatch's metrics, detached): the mean over k microbatches of
    their gradients, accumulated in float32."""
    leaves = tree_leaves(params)

    def grads_of(mb):
        with torch.enable_grad():
            xs = [p.detach().requires_grad_(True) for p in leaves]
            tree = _tree_like(params, xs)

            def lf():
                return loss_fn(model, tree, mb, z_loss)
            if remat:          # whole-loss remat; prefer Model(remat=True)
                loss, metrics = checkpoint(lf, use_reentrant=False)
            else:
                loss, metrics = lf()
            gs = torch.autograd.grad(loss, xs, allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g
              for g, x in zip(gs, xs)]
        return gs, {k: v.detach() for k, v in metrics.items()}

    batch = {k: constrain(x, "batch", *([None] * (x.ndim - 1)))
             for k, x in batch.items()}
    k = num_microbatches
    if k <= 1:
        gs, metrics = grads_of(batch)
        gs = [g.to(torch.float32) for g in gs]
    else:
        stacked = _microbatch_stack(batch, k)
        gs = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for p in leaves]
        for i in range(k):
            g_i, metrics = grads_of({n: x[i] for n, x in stacked.items()})
            for a, g in zip(gs, g_i):
                a.add_(g.to(torch.float32))
            del g_i
        for a in gs:
            a.div_(k)
    return _tree_like(params, gs), metrics


def _local_rows(batch: dict, mesh, dims: list) -> dict:
    """This rank's rows of the global batch: Shard(0) over the mesh dims
    `dims`, the first of them major."""
    dm = mesh.device_mesh
    coord, n, r = dm.get_coordinate(), 1, 0
    for d in dims:
        r = r * dm.size(d) + coord[d]
        n *= dm.size(d)
    rows = next(iter(batch.values())).shape[0] // n
    return {k: x[r * rows:(r + 1) * rows] for k, x in batch.items()}


def _mean_into_shard(g: torch.Tensor, p, dims: list, n: int):
    """This rank's gradient `g` (of its rows) → the mean over the batch
    dims `dims` (n ranks), as a DTensor in `p`'s placements: first cut
    locally to `p`'s layout on the other mesh dims (no communication),
    then reduced over `dims` — a reduce-scatter where `p` is sharded on
    that dim, an all-reduce of the cut piece where it is replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dm = p.device_mesh
    cut = [Replicate() if d in dims else pl
           for d, pl in enumerate(p.placements)]
    piece = DTensor.from_local(g, dm, [Replicate()] * dm.ndim,
                               run_check=False).redistribute(dm, cut)
    src = [Partial() if d in dims else pl for d, pl in enumerate(cut)]
    out = DTensor.from_local(piece.to_local(), dm, src, run_check=False,
                             shape=p.shape, stride=p.stride()
                             ).redistribute(dm, p.placements)
    if n > 1:
        out.to_local().div_(n)
    return out


def _global_metrics(metrics: dict, dm, dims: list, n: int) -> dict:
    """Each scalar metric averaged over the batch dims; `ppl` from the
    global `ce`. (The mean of the ranks' means is the global mean: every
    rank has as many rows, and masks are refused.)"""
    import torch.distributed as dist
    keys = sorted(k for k in metrics if k != "ppl")
    v = torch.stack([metrics[k].to(torch.float32) for k in keys])
    for d in dims:
        dist.all_reduce(v, group=dm.get_group(d))
    if n > 1:
        v = v / n
    out = dict(zip(keys, v.unbind()))
    out["ppl"] = torch.exp(torch.clamp(out["ce"], max=20.0))
    return out


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    num_microbatches: int = 1, z_loss: float = 1e-4,
                    remat: bool = False, compress_grads: bool = True,
                    mesh=None, rules=None):
    """Returns train_step(params, opt_state, batch) → (params, opt_state,
    metrics), params and state updated in place. With a `mesh` over a
    process group the step is the sharded one (module docstring): params
    and moments are DTensors, `batch` the global batch, `rules` overrides
    of the default rule table."""
    sharded = getattr(mesh, "device_mesh", None) is not None
    rules = dict(DEFAULT_RULES, **(rules or {}))

    def train_step(params, opt_state, batch):
        if sharded:
            rows = next(iter(batch.values())).shape[0]
            dims = [mesh.axis_names.index(a)
                    for a in batch_axes(mesh, rows, rules)]
            n = 1
            for d in dims:
                n *= mesh.device_mesh.size(d)
            if n > 1 and "mask" in batch:
                raise ValueError(
                    "a masked batch over several batch shards: the mean "
                    "of the ranks' masked means is not the global one")
            batch = _local_rows(batch, mesh, dims)
            with torch.no_grad():
                full = _tree_like(params, [p.full_tensor() for p in
                                           tree_leaves(params)])
        else:
            full = params
        grads, metrics = accumulate_grads(model, full, batch,
                                          num_microbatches, z_loss, remat)
        del full
        if compress_grads:
            grads = compress_tree_for_sync(grads)
        if sharded:
            grads = _tree_like(params, [
                _mean_into_shard(g, p, dims, n) for g, p in
                zip(tree_leaves(grads), tree_leaves(params))])
            metrics = _global_metrics(metrics, mesh.device_mesh, dims, n)
        params, opt_state, opt_metrics = adamw_update(grads, opt_state,
                                                      params, opt_cfg)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step
