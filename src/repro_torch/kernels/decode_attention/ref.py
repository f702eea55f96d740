"""Plain PyTorch version of the flash-decode kernel B4, shape for shape (port
of the JAX package's `kernels/decode_attention/ref.py`).

A dense softmax over every slot of the cache, in float32. It is what the
wrapper runs for CPU tensors; the tests hold it against the JAX package and
`chip_smoke.py` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38   # the JAX package's constant: finite, so a lane
                          # with no valid slot averages v instead of NaN
BLOCK = 1024              # the JAX wrapper's KV block (it pads S to it)

#: calls of the plain version — a run on the card shows that the main path
#: never reached it (only `chip_smoke.py`'s comparisons do)
CALLS = {"decode_attention": 0}


def padded_slots(s: int) -> int:
    """The slot count the JAX wrapper pads a cache of `s` slots to,
    ceil(s / min(BLOCK, s))·min(BLOCK, s): what a lane with no valid slot
    divides Σ v by."""
    blk = min(BLOCK, s)
    return -(-s // blk) * blk


def slot_mask(pos: torch.Tensor, kv_positions: torch.Tensor, window
              ) -> torch.Tensor:
    """(B, S) bool: a slot counts iff 0 ≤ stamp ≤ pos (and pos − stamp <
    window when windowed)."""
    ok = (kv_positions >= 0) & (kv_positions <= pos[:, None])
    if window is not None:
        ok &= (pos[:, None] - kv_positions) < window
    return ok


def decode_attention_ref(pos, q, k, v, kv_positions, k_scale, v_scale, *,
                         scale: float, window) -> torch.Tensor:
    """Same contract as `kernel.decode_attention`: pos (B,) int32; q (B, H,
    D); k/v (B, S, Hkv, D) float, or int8 with k_scale/v_scale (B, S, Hkv)
    f32 (None for a float cache); kv_positions (B, S) int32 → (B, H, D) in
    q's dtype. Query head h reads KV head h // (H / Hkv). The softmax also
    counts `padded_slots(S)` − S slots of zero v whose score is NEG_INF
    (the JAX wrapper's padding): they weigh 1 in a lane with no valid slot
    and nothing elsewhere."""
    CALLS["decode_attention"] += 1
    h, hkv = q.shape[1], k.shape[2]
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    if k.dtype == torch.int8:
        kf = kf * k_scale.to(torch.float32)[..., None]
        vf = vf * v_scale.to(torch.float32)[..., None]
    if hkv != h:
        kf = kf.repeat_interleave(h // hkv, dim=2)
        vf = vf.repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.to(torch.float32), kf) * scale
    ok = slot_mask(pos, kv_positions, window)
    s = torch.where(ok[:, None, :], s,
                    torch.full((), NEG_INF, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    w = torch.exp(s - m)
    den = w.sum(dim=-1, keepdim=True)
    pad = padded_slots(k.shape[1]) - k.shape[1]
    if pad:
        den = den + pad * torch.exp(NEG_INF - m)
    w = w / den
    return torch.einsum("bht,bthd->bhd", w, vf).to(q.dtype)
