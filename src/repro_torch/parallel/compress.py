"""Gradient compression (port of the JAX package's `parallel/compress.py`).

A ring all-reduce is reduce-scatter + all-gather. Each phase is
compressed on its own:

  reduce-scatter in bf16   (the accumulation precision)
  all-gather   in int8     (per-shard absmax scaling, optionally with
                            stochastic rounding)

so the wire carries 2 + 1 bytes an element (and one scale a rank) where a
float32 all-reduce carries 8. Exposed two ways:

  compressed_allreduce_mean(x, group)  — the mean over a process group
  compress_tree_for_sync(grads)        — float32 gradients cast to bf16, as
                                         the trainer does before the
                                         gradient mean and AdamW by default
  int8_quantize / int8_dequantize      — per-tensor absmax int8
"""
from __future__ import annotations

from typing import Optional

import torch


def int8_quantize(x: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """Per-tensor absmax int8 → (codes, scale). With a `generator`, uniform
    noise in [-0.5, 0.5) is added before rounding (stochastic rounding)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax().clamp_min(1e-12)
    scale = amax / torch.full_like(amax, 127.0)   # an IEEE divide
    y = xf / scale
    if generator is not None:
        y = y + (torch.rand(y.shape, generator=generator,
                            device=generator.device).to(y.device) - 0.5)
    return torch.round(y).clamp(-127, 127).to(torch.int8), scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


#: each collective's name before torch 2.13 named it `<name>_single`
_OLDER = {"reduce_scatter": "reduce_scatter_tensor",
          "all_gather": "all_gather_into_tensor"}


def _collective(name: str):
    """torch.distributed's `<name>_single`, or its older name where the
    running torch predates it."""
    import torch.distributed as dist
    return getattr(dist, f"{name}_single", None) or \
        getattr(dist, _OLDER[name])


def compressed_allreduce_mean(x: torch.Tensor, group=None,
                              generator: Optional[torch.Generator] = None
                              ) -> torch.Tensor:
    """The mean of `x` over the ranks of `group` (the default group when
    None) with compressed wire traffic: `x` flattened and zero-padded to a
    multiple of the rank count n, a bf16 reduce-scatter, each rank's part
    divided by n and quantized to int8 by its own absmax (`generator`:
    stochastic rounding), then an int8 all-gather and a float32 all-gather
    of the n scales. Returns `x`'s shape and dtype."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    wire = flat.to(torch.bfloat16).contiguous()
    part = torch.empty(wire.numel() // n, dtype=torch.bfloat16,
                       device=x.device)
    _collective("reduce_scatter")(part, wire, group=group)
    q, scale = int8_quantize(part.to(torch.float32) / n, generator)
    qg = torch.empty(wire.numel(), dtype=torch.int8, device=x.device)
    _collective("all_gather")(qg, q, group=group)
    sg = torch.empty(n, dtype=torch.float32, device=x.device)
    _collective("all_gather")(sg, scale.reshape(1), group=group)
    out = (qg.reshape(n, -1).to(torch.float32) * sg[:, None]).reshape(-1)
    return out[:x.numel()].reshape(x.shape).to(x.dtype)


def compress_tree_for_sync(grads):
    """Every float32 leaf of a nested-dict tree cast to bf16; other leaves
    as they are."""
    if isinstance(grads, dict):
        return {k: compress_tree_for_sync(v) for k, v in grads.items()}
    return grads.to(torch.bfloat16) if grads.dtype == torch.float32 \
        else grads
