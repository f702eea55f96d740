"""Wrapper of the flash-decode CUDA kernel B4 (`csrc/decode_attention.cu`),
the counterpart of the JAX package's `decode_attention_pallas`.

The kernel splits each lane's cache over blocks by a host-side plan
(`decode_plan`): a block takes one range of slots of one KV head of one
lane, for all the query heads of that KV head. With several splits each
block writes its softmax partials into a workspace and a second launch,
queued behind the first without a launch gap, folds them in split order.

A CUDA tensor goes to the kernel, or the wrapper raises; a CPU tensor goes
to the plain version in `ref.py`. There is no other fallback.
"""
from __future__ import annotations

import torch

from .. import build
from ..bitplane_gemv.kernel import _sms, _stream
from . import ref

#: launches of the CUDA kernel (the plain version counts in ref.CALLS);
#: `decode_attention_fold` the second launch of a call whose plan splits
LAUNCHES = {"decode_attention": 0, "decode_attention_fold": 0}

#: the largest head dim on the kernel's fast body (built for 32, 64, 128
#: and 256, any D up to 256 rounded up to the next); a larger D takes its
#: generic body, which only has to be right
FAST_HEAD_DIM = 256
Q_TYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: the plan: blocks a launch aims for on each SM and slots a split takes
#: at least (so that its K/V rows outweigh its partial), both swept on an
#: H100 (`launch/bench_decode.py --plans`, PERF.md); slots a split takes at
#: most (its valid-slot list in shared memory: the CUDA source's limit), in
#: whole 32-slot ballot words
BLOCKS_PER_SM = 4
MIN_CHUNK = 128
MAX_CHUNK = 1024
CHUNK_ALIGN = 32


def decode_plan(b: int, s: int, hkv: int, sms: int) -> tuple:
    """(chunk, splits): each lane's S slots in `splits` ranges of `chunk`
    slots (the last one ragged). As many splits as keep the grid of
    splits × Hkv × B blocks within BLOCKS_PER_SM on each of the card's
    `sms` SMs (one wave: a second, partial wave of blocks costs as much as
    the first), unless ranges would fall below MIN_CHUNK slots; at least
    enough that none exceeds MAX_CHUNK. Made from shapes alone: which slots
    are valid is for the blocks to find."""
    if min(b, s, hkv, sms) < 1:
        raise ValueError(f"decode_plan: b={b}, s={s}, hkv={hkv}, sms={sms} "
                         f"must be >= 1")
    want = max(1, BLOCKS_PER_SM * sms // (b * hkv))
    splits = max(min(want, -(-s // MIN_CHUNK)), -(-s // MAX_CHUNK))
    chunk = -(-(-(-s // splits)) // CHUNK_ALIGN) * CHUNK_ALIGN
    return chunk, -(-s // chunk)


def workspace_shapes(b: int, hkv: int, splits: int, g: int, d: int
                     ) -> tuple:
    """Shapes of the f32 workspace a plan of `splits` takes: each split's
    accumulator (B, Hkv, splits, g, D) and (m, l) (B, Hkv, splits, g, 2)
    per query head; nothing with one split, whose blocks write the
    output."""
    if splits == 1:
        return (0,), (0,)
    return (b, hkv, splits, g, d), (b, hkv, splits, g, 2)


def _check(pos, q, k, v, kv_positions, k_scale, v_scale) -> None:
    what = "decode_attention"
    b, h, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"{what}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)} as (B, S, Hkv, D)")
    s, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"{what}: {h} query heads not a multiple of {hkv} "
                         f"KV heads")
    if d < 1:
        raise ValueError(f"{what}: head dim {d} < 1")
    if q.dtype not in Q_TYPES or k.dtype not in KV_TYPES \
            or v.dtype != k.dtype:
        raise ValueError(f"{what}: q {q.dtype} / k {k.dtype} / v {v.dtype} "
                         f"not supported (q in {tuple(Q_TYPES)}, k = v in "
                         f"{tuple(KV_TYPES)})")
    int8 = k.dtype == torch.int8
    named = [("pos", pos, torch.int32, (b,)),
             ("kv_positions", kv_positions, torch.int32, (b, s))]
    if int8:
        named += [("k_scale", k_scale, torch.float32, (b, s, hkv)),
                  ("v_scale", v_scale, torch.float32, (b, s, hkv))]
    elif k_scale is not None or v_scale is not None:
        raise ValueError(f"{what}: scales given for a {k.dtype} cache")
    for name, t, dt, shape in named:
        if t is None or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be {dt} {shape}, got "
                             f"{None if t is None else (t.dtype, tuple(t.shape))}")
    for name, t in [("q", q), ("k", k), ("v", v)] + [(n, t) for n, t, _, _
                                                      in named]:
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    # on the fast body a K/V row of whole 16-byte loads is read so; any
    # other row element by element, at any alignment
    if d <= FAST_HEAD_DIM and d * k.element_size() % 16 == 0:
        for name, t in (("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{what}: {name} must be 16-byte aligned "
                                 f"(the kernel loads 16 bytes a thread)")


def decode_attention(pos, q, k, v, kv_positions, k_scale, v_scale, *,
                     scale: float, window) -> torch.Tensor:
    """pos (B,) int32 per-lane positions; q (B, H, D) f32 or bf16; k/v
    (B, S, Hkv, D) f32, bf16 or int8 with k_scale/v_scale (B, S, Hkv) f32
    (None for a float cache); kv_positions (B, S) int32 stamps → (B, H, D)
    in q's dtype. A slot counts iff 0 ≤ stamp ≤ pos (and pos − stamp <
    window when `window` is not None). A lane with no valid slot gets
    Σ v / `ref.padded_slots(S)`, as the JAX wrapper's padded cache gives
    it."""
    if not q.is_cuda:
        return ref.decode_attention_ref(pos, q, k, v, kv_positions, k_scale,
                                        v_scale, scale=scale, window=window)
    _check(pos, q, k, v, kv_positions, k_scale, v_scale)
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    chunk, splits = decode_plan(b, s, hkv, _sms(q.device))
    acc_shape, ml_shape = workspace_shapes(b, hkv, splits, h // hkv, d)
    ws_acc = torch.empty(acc_shape, dtype=torch.float32, device=q.device)
    ws_ml = torch.empty(ml_shape, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lib = build.library("decode_attention")
    LAUNCHES["decode_attention"] += 1
    LAUNCHES["decode_attention_fold"] += int(splits > 1)
    build.check(lib.decode_attention_launch(
        pos.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_positions.data_ptr(),
        0 if k_scale is None else k_scale.data_ptr(),
        0 if v_scale is None else v_scale.data_ptr(), out.data_ptr(),
        ws_acc.data_ptr(), ws_ml.data_ptr(), b, s, ref.padded_slots(s), h,
        hkv, d, Q_TYPES[q.dtype], KV_TYPES[k.dtype], chunk, splits,
        float(scale), -1 if window is None else int(window), _stream()),
        "decode_attention")
    return out
