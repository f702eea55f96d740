"""Public entry point of flash-decode attention (port of the JAX package's
`kernels/decode_attention/ops.py`).

Same signature and layouts as the JAX function, with the port's impl
strings: `impl="kernel"` goes to the kernel wrapper (the CUDA kernel for
CUDA tensors, its plain version for CPU tensors), `impl="reference"` always
to the plain version. Where the JAX wrapper expands GQA heads with
`jnp.repeat` and pads the cache to its block, the kernel reads KV head
h // (H / Hkv) in place and masks the ragged end of the cache itself, so
nothing is copied here. What the padding changes is kept: a lane with no
valid slot divides by the padded slot count (`ref.padded_slots`), as the
JAX wrapper's does.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref

IMPLS = ("kernel", "reference")


def decode_attention(pos, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_positions, k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None, *,
                     window: Optional[int] = None,
                     impl: str = "kernel") -> torch.Tensor:
    """One-token attention against a position-stamped cache.

    pos: scalar or (B,) per-lane positions; q (B, H, D); k/v (B, S, Hkv, D)
    float — or int8 with k_scale/v_scale (B, S, Hkv); kv_positions (B, S)
    per-lane stamps (a (S,) vector is broadcast). Returns (B, H, D) in
    q.dtype.

    A lane with no valid slot (every score the finite NEG_INF) gets Σ v
    over its S slots divided by `ref.padded_slots(S)`, as the JAX wrapper's
    padded cache gives it.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    b, h, d = q.shape
    s = k.shape[1]
    if (k.dtype == torch.int8) != (k_scale is not None) \
            or (k_scale is None) != (v_scale is None):
        raise ValueError(f"int8 caches need k_scale and v_scale, float "
                         f"caches neither (k {k.dtype}, k_scale "
                         f"{'given' if k_scale is not None else None})")
    pos = torch.as_tensor(pos, device=q.device).to(torch.int32)
    pos = pos.expand(b).contiguous()
    kv_positions = torch.as_tensor(kv_positions, device=q.device).to(
        torch.int32).expand(b, s).contiguous()
    fn = kernel.decode_attention if impl == "kernel" \
        else ref.decode_attention_ref
    return fn(pos, q.contiguous(), k, v, kv_positions, k_scale, v_scale,
              scale=d ** -0.5, window=window)
