"""Attention (port of the JAX package's `models/attention.py`): grouped-query
attention and deepseek-v2's multi-head latent attention (MLA), each with a
full-sequence path (prefill) and a one-token cached path (decode).

KV caches are position-stamped ring buffers: alongside k/v a `positions`
tensor (init −1); sliding-window ("local") layers allocate only `window`
slots and rotate. Masks come from the stamped positions, never from slot
order. The decode step writes the new token into the cache IN PLACE, where
the JAX package returns an updated copy (donated under jit).

The MLA cache holds only the normalized latent `c_kv` and the rotated
shared key `k_rope` a slot, with the same position stamps; its decode is
the absorbed one (queries through `w_uk`, the context through `w_uv`, both
float32 einsums), and it never runs the flash-decode kernel B4.
"""
from __future__ import annotations

from typing import Optional

import torch

from .config import AttnConfig, MLAConfig
from .layers import (apply_rope, dense, dense_group, rmsnorm,
                     rope_frequencies, softcap)

NEG_INF = -2.3819763e38  # ~ lowest bf16-representable; used pre-softmax

FLASH_THRESHOLD = 2048   # use blocked attention above this sequence length
FLASH_BLOCK = 1024
FLASH_Q_CHUNK = 4096     # long prefills also chunk the query axis
FLASH_P_BF16 = False     # score/p tiles in bf16 (the flash-kernel recipe):
#                          halves the blocked attention's traffic at ~1e-2
#                          relative error; set per run by the dry-run's
#                          --flash-bf16


def _causal_mask(s_q: int, s_k: int, window: Optional[int],
                 device=None) -> torch.Tensor:
    """(s_q, s_k) additive mask; queries are the LAST s_q of s_k
    positions."""
    qi = torch.arange(s_q, device=device)[:, None] + (s_k - s_q)
    kj = torch.arange(s_k, device=device)[None, :]
    ok = kj <= qi
    if window is not None:
        ok &= (qi - kj) < window
    return _additive(ok)


def _additive(ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, torch.zeros((), device=ok.device),
                       torch.full((), NEG_INF, device=ok.device))


def _sdpa(q, k, v, mask, cap: Optional[float], scale: float):
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,D'), mask broadcastable (B,1,Sq,Sk)."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = softcap(scores, cap) + mask
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhgst,bthv->bshgv", w, v.to(torch.float32))
    return ctx.reshape(b, sq, h * v.shape[-1]).to(q.dtype)


def _flash_sdpa(q, k, v, window: Optional[int], cap: Optional[float],
                scale: float, block: int = FLASH_BLOCK):
    """Blocked causal attention with running (max, denom, acc): peak memory
    O(Sq·block) instead of O(Sq·Sk). Same-length q/k (prefill path). Key
    blocks entirely in a query chunk's future are skipped — their masked
    scores would contribute exactly zero. With `FLASH_P_BF16` the score
    product takes q and k in q's dtype and p enters the PV product rounded
    to bf16 (v in its own dtype), as the JAX package's; each product is
    widened to float32 after it, and the running statistics stay
    float32."""
    b, s, h, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    if hkv != h:                       # query head i attends kv head i//g
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    lowp = FLASH_P_BF16
    qf = q if lowp else q.to(torch.float32)
    nb = -(-s // block)

    def process(q_c, q_lo: int):
        sq = q_c.shape[1]
        q_pos = torch.arange(q_lo, q_lo + sq, device=q.device)
        m = torch.full((b, h, sq), NEG_INF, device=q.device)
        l = torch.zeros((b, h, sq), device=q.device)
        acc = torch.zeros((b, h, sq, dv), device=q.device)
        for jb in range(nb):
            lo = jb * block
            if lo >= q_lo + sq:
                break
            k_j = k[:, lo:lo + block].to(qf.dtype)
            v_j = v[:, lo:lo + block]
            v_j = v_j if lowp else v_j.to(torch.float32)
            k_pos = torch.arange(lo, lo + k_j.shape[1], device=q.device)
            ok = k_pos[None, :] <= q_pos[:, None]
            if window is not None:
                ok &= (q_pos[:, None] - k_pos[None, :]) < window
            sc = torch.einsum("bshd,bthd->bhst", q_c,
                              k_j).to(torch.float32) * scale
            sc = softcap(sc, cap)
            sc = torch.where(ok[None, None], sc,
                             torch.full((), NEG_INF, device=q.device))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            p_v = p.to(torch.bfloat16).to(v_j.dtype) if lowp else p
            pv = torch.einsum("bhst,bthv->bhsv", p_v, v_j)
            acc = acc * alpha[..., None] + pv.to(torch.float32)
            l = l * alpha + p.sum(dim=-1)
            m = m_new
        return acc / l.clamp_min(1e-30)[..., None]      # (b, h, sq, dv)

    if s > FLASH_Q_CHUNK and s % FLASH_Q_CHUNK == 0:
        ctx = torch.cat([process(qf[:, c:c + FLASH_Q_CHUNK], c)
                         for c in range(0, s, FLASH_Q_CHUNK)], dim=2)
    else:
        ctx = process(qf, 0)
    return ctx.transpose(1, 2).reshape(b, s, h * dv).to(q.dtype)


def _attend(q, k, v, window, cap, scale):
    """Dispatch direct vs blocked attention by sequence length."""
    s = q.shape[1]
    if s > FLASH_THRESHOLD:
        return _flash_sdpa(q, k, v, window, cap, scale, FLASH_BLOCK)
    return _sdpa(q, k, v, _causal_mask(s, s, window, q.device), cap, scale)


def gqa_forward(x, p, acfg: AttnConfig, window: Optional[int],
                positions: torch.Tensor, act_bits=None, impl=None,
                return_kv: bool = False):
    """Full-sequence self-attention. x (B,S,E); positions (S,)."""
    b, s, _ = x.shape
    h, hkv, d = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
    q, k, v = dense_group(x, (p["wq"], p["wk"], p["wv"]),
                          (p.get("bq"), p.get("bk"), p.get("bv")),
                          act_bits, impl)
    q = q.reshape(b, s, h, d)
    k = k.reshape(b, s, hkv, d)
    v = v.reshape(b, s, hkv, d)
    rd = acfg.rope_dim or d
    cos, sin = rope_frequencies(rd, acfg.rope_base, positions)
    q = apply_rope(q, cos, sin, rd)
    k = apply_rope(k, cos, sin, rd)
    ctx = _attend(q, k, v, window, acfg.softcap, d ** -0.5)
    out = dense(ctx, p["wo"], act_bits=act_bits, impl=impl)
    return (out, (k, v)) if return_kv else out


def _kv_quant(x):
    """(B,S,Hkv,D) → int8 codes + per-(B,S,Hkv) f32 scale (absmax/127)."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    scale = (absmax / torch.full_like(absmax, 127.0)).clamp_min(1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def _kv_dequant(q, scale):
    return q.to(torch.float32) * scale[..., None].to(torch.float32)


def gqa_decode(x, p, acfg: AttnConfig, window: Optional[int], cache: dict,
               pos, act_bits=None, impl=None, attn_impl: str = "sdpa"):
    """One-token step. x (B,1,E); cache {k,v:(B,Sc,Hkv,D),
    positions:(B,Sc)}, updated in place and returned.

    A cache created with kv_bits=8 (keys "k_scale"/"v_scale" present)
    stores keys/values as int8 with per-(token, head) scales.

    `attn_impl="kernel"` runs the flash-decode kernel B4 on the raw (int8
    or float) cache; a softcapped config stays on `_sdpa`, as in the JAX
    package."""
    b = x.shape[0]
    h, hkv, d = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
    sc = cache["k"].shape[1]
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    pos = pos.expand(b) if pos.ndim == 0 else pos            # per lane
    q, k, v = dense_group(x, (p["wq"], p["wk"], p["wv"]),
                          (p.get("bq"), p.get("bk"), p.get("bv")),
                          act_bits, impl)
    q = q.reshape(b, 1, h, d)
    k = k.reshape(b, 1, hkv, d)
    v = v.reshape(b, 1, hkv, d)
    rd = acfg.rope_dim or d
    cos, sin = rope_frequencies(rd, acfg.rope_base, pos[:, None])
    q = apply_rope(q, cos, sin, rd)
    k = apply_rope(k, cos, sin, rd)
    slot = pos if window is None else pos % sc
    lane = torch.arange(b, device=x.device)
    int8_kv = "k_scale" in cache
    if int8_kv:
        kq, ks = _kv_quant(k)
        vq, vs = _kv_quant(v)
        cache["k"][lane, slot] = kq[:, 0]
        cache["v"][lane, slot] = vq[:, 0]
        cache["k_scale"][lane, slot] = ks[:, 0]
        cache["v_scale"][lane, slot] = vs[:, 0]
    else:
        cache["k"][lane, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][lane, slot] = v[:, 0].to(cache["v"].dtype)
    cache["positions"][lane, slot] = pos.to(cache["positions"].dtype)
    pos_all = cache["positions"]
    if attn_impl != "sdpa" and acfg.softcap is None:
        # flash-decode reads the RAW cache: no widened copy of it is made
        from ..kernels.decode_attention import ops as dk
        ctx = dk.decode_attention(
            pos, q[:, 0], cache["k"], cache["v"], pos_all,
            cache.get("k_scale"), cache.get("v_scale"), window=window)
        ctx = ctx.reshape(b, 1, h * d).to(x.dtype)
    else:
        if int8_kv:
            k_use = _kv_dequant(cache["k"], cache["k_scale"]).to(x.dtype)
            v_use = _kv_dequant(cache["v"], cache["v_scale"]).to(x.dtype)
        else:
            k_use, v_use = cache["k"], cache["v"]
        ok = (pos_all >= 0) & (pos_all <= pos[:, None])
        if window is not None:
            ok &= (pos[:, None] - pos_all) < window
        # (B,1,1,1,Sc): lane dim aligned with the scores' (b,hkv,g,sq,t)
        mask = _additive(ok)[:, None, None, None, :]
        ctx = _sdpa(q, k_use, v_use, mask, acfg.softcap, d ** -0.5)
    out = dense(ctx, p["wo"], act_bits=act_bits, impl=impl)
    return out, cache


def gqa_cache_init(batch: int, slots: int, acfg: AttnConfig, dtype,
                   kv_bits=None, device=None) -> dict:
    hkv, d = acfg.num_kv_heads, acfg.head_dim
    cache = {"positions": torch.full((batch, slots), -1, dtype=torch.int32,
                                     device=device)}
    if kv_bits == 8:
        for name in ("k", "v"):
            cache[name] = torch.zeros((batch, slots, hkv, d),
                                      dtype=torch.int8, device=device)
            cache[f"{name}_scale"] = torch.zeros((batch, slots, hkv),
                                                 device=device)
    else:
        for name in ("k", "v"):
            cache[name] = torch.zeros((batch, slots, hkv, d), dtype=dtype,
                                      device=device)
    return cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v2-lite flavour)
# ---------------------------------------------------------------------------

def _mla_latent(x, p, acfg: AttnConfig, mla: MLAConfig, positions,
                act_bits, impl) -> tuple:
    """q (B,S,H,dn+dr) with its rope half rotated, the normalized latent
    c_kv (B,S,L) and the rotated shared key k_rope (B,S,1,dr). `wq` and
    `w_dkv` are two linears, as in the JAX package: at act_bits each
    quantizes its own activations."""
    b, s, _ = x.shape
    h = acfg.num_heads
    dn, dr, lr = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.kv_lora_rank
    q = dense(x, p["wq"], act_bits=act_bits, impl=impl).reshape(
        b, s, h, dn + dr)
    dkv = dense(x, p["w_dkv"], act_bits=act_bits, impl=impl)   # (B,S,L+dr)
    c_kv = rmsnorm(dkv[..., :lr], p["kv_norm"]["scale"])
    cos, sin = rope_frequencies(dr, acfg.rope_base, positions)
    q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], cos, sin)], dim=-1)
    k_rope = apply_rope(dkv[..., lr:].reshape(b, s, 1, dr), cos, sin)
    return q, c_kv, k_rope


def _up(c_kv, w, lr: int, h: int) -> torch.Tensor:
    """(B,S,L) latent through a float (L, H·d) up-projection, in float32 →
    (B,S,H,d)."""
    return torch.einsum("btl,lhd->bthd", c_kv.to(torch.float32),
                        w.reshape(lr, h, -1).to(torch.float32))


def mla_forward(x, p, acfg: AttnConfig, mla: MLAConfig,
                positions: torch.Tensor, act_bits=None, impl=None,
                return_kv: bool = False):
    """Full-sequence MLA. Params: wq (E, H·(dn+dr)), w_dkv (E, L+dr),
    kv_norm (L,), w_uk (L, H·dn), w_uv (L, H·dv), wo (H·dv, E); w_uk and
    w_uv stay float."""
    b, s, _ = x.shape
    h, dn, dr = acfg.num_heads, mla.qk_nope_head_dim, mla.qk_rope_head_dim
    lr = mla.kv_lora_rank
    q, c_kv, k_rope = _mla_latent(x, p, acfg, mla, positions, act_bits,
                                  impl)
    k = torch.cat([_up(c_kv, p["w_uk"], lr, h).to(x.dtype),
                   k_rope.expand(b, s, h, dr)], dim=-1)
    v = _up(c_kv, p["w_uv"], lr, h).to(x.dtype)
    ctx = _attend(q, k, v, None, None, (dn + dr) ** -0.5)
    out = dense(ctx, p["wo"], act_bits=act_bits, impl=impl)
    return (out, (c_kv, k_rope[:, :, 0])) if return_kv else out


def mla_decode(x, p, acfg: AttnConfig, mla: MLAConfig, cache: dict, pos,
               act_bits=None, impl=None):
    """Absorbed one-token MLA. x (B,1,E); cache {c_kv (B,Sc,L), k_rope
    (B,Sc,dr), positions (B,Sc)}, updated in place and returned. A slot
    counts if 0 ≤ stamp ≤ pos."""
    b = x.shape[0]
    h, dn, dr = acfg.num_heads, mla.qk_nope_head_dim, mla.qk_rope_head_dim
    lr = mla.kv_lora_rank
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    pos = pos.expand(b) if pos.ndim == 0 else pos            # per lane
    q, c_kv, k_rope = _mla_latent(x, p, acfg, mla, pos[:, None], act_bits,
                                  impl)
    lane = torch.arange(b, device=x.device)
    cache["c_kv"][lane, pos] = c_kv[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][lane, pos] = k_rope[:, 0, 0].to(cache["k_rope"].dtype)
    cache["positions"][lane, pos] = pos.to(cache["positions"].dtype)
    ckv_all = cache["c_kv"].to(torch.float32)                  # (B,Sc,L)
    pos_all = cache["positions"]
    # absorb q_nope through W_uk: (B,1,H,dn)·(L,H,dn) → (B,1,H,L)
    q_abs = torch.einsum("bshd,lhd->bshl", q[..., :dn].to(torch.float32),
                         p["w_uk"].reshape(lr, h, dn).to(torch.float32))
    scores = (torch.einsum("bshl,btl->bhst", q_abs, ckv_all)
              + torch.einsum("bshr,btr->bhst", q[..., dn:].to(torch.float32),
                             cache["k_rope"].to(torch.float32))
              ) * (dn + dr) ** -0.5
    ok = (pos_all >= 0) & (pos_all <= pos[:, None])
    w = torch.softmax(scores + _additive(ok)[:, None, None, :], dim=-1)
    ctx_l = torch.einsum("bhst,btl->bshl", w, ckv_all)
    ctx = torch.einsum("bshl,lhd->bshd", ctx_l,
                       p["w_uv"].reshape(lr, h, -1).to(torch.float32))
    ctx = ctx.reshape(b, 1, -1).to(x.dtype)
    return dense(ctx, p["wo"], act_bits=act_bits, impl=impl), cache


def mla_cache_init(batch: int, slots: int, mla: MLAConfig, dtype,
                   device=None) -> dict:
    return {
        "c_kv": torch.zeros((batch, slots, mla.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, slots, mla.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "positions": torch.full((batch, slots), -1, dtype=torch.int32,
                                device=device),
    }
