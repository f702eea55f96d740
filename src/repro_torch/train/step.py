"""Loss + train step (port of the JAX package's `train/step.py`).

Microbatched gradient accumulation (activation memory ∝ microbatch, not
global batch) in float32, optional remat of the whole loss, bf16 gradient
compression (`parallel.compress`), AdamW in float32, in place.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..models.model import Model
from ..optim.adamw import AdamWConfig, adamw_update, tree_leaves
from ..parallel.compress import compress_tree_for_sync
from ..parallel.sharding import constrain


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


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    num_microbatches: int = 1, z_loss: float = 1e-4,
                    remat: bool = False, compress_grads: bool = True):
    """Returns train_step(params, opt_state, batch) → (params, opt_state,
    metrics), params and state updated in place."""

    def train_step(params, opt_state, batch):
        grads, metrics = accumulate_grads(model, params, batch,
                                          num_microbatches, z_loss, remat)
        if compress_grads:
            grads = compress_tree_for_sync(grads)
        params, opt_state, opt_metrics = adamw_update(grads, opt_state,
                                                      params, opt_cfg)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step
