"""Gradient compression (port of the JAX package's `parallel/compress.py`,
without the collective).

  int8_quantize / int8_dequantize  — per-tensor absmax int8, optionally
                                     with stochastic rounding
  compress_tree_for_sync(grads)    — float32 gradients cast to bf16, as the
                                     trainer does before AdamW by default

`compressed_allreduce_mean` (a bf16 reduce-scatter and an int8 all-gather
over a named mesh axis) needs collectives across devices and is not
ported (ROADMAP A11, the multi-device half).
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


def compress_tree_for_sync(grads):
    """Every float32 leaf of a nested-dict tree cast to bf16; other leaves
    as they are."""
    if isinstance(grads, dict):
        return {k: compress_tree_for_sync(v) for k, v in grads.items()}
    return grads.to(torch.bfloat16) if grads.dtype == torch.float32 \
        else grads
