"""Mamba2 (state-space duality) block (port of the JAX package's
`models/ssm.py`): the chunked SSD scan of a full sequence (prefill) and the
constant-state recurrence of one token (decode).

Shapes follow the Mamba2 paper: d_inner = expand·d_model splits into H heads
of P = head_dim; B/C projections have G groups of N = d_state channels
(head h reads group h·G//H). The chunked algorithm computes, per chunk of
Q tokens,
    intra:  Y_ij = C_i·B_j · exp(Σ_{t∈(j,i]} a_t) · dt_j x_j   (j ≤ i)
    inter:  a running state S carried across chunks
so a prefill costs O(L·Q) plus L/Q state steps, and decode keeps a single
(B, H, P, N) float32 state per layer.

`in_proj` and `out_proj` go through `layers.dense`, so bit-plane leaves
reach B1 (4-bit activations) or B3 (float activations). The convolution
and the recurrence are elementwise and stay plain float32 torch, as the JAX
package keeps them outside any Pallas kernel. Their einsums rely on
PyTorch's default float32 matmul precision ("highest": no TF32), which
`chip_smoke.py` pins on the card. The decode step updates its layer's
conv window and state in place in the stacked cache, as the port's
attention caches are updated.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense, rmsnorm


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    s = cfg.ssm
    di, g, n, h = cfg.d_inner, s.n_groups, s.d_state, cfg.ssm_heads
    idx = [di, 2 * di, 2 * di + g * n, 2 * di + 2 * g * n]
    z = zxbcdt[..., :idx[0]]
    x = zxbcdt[..., idx[0]:idx[1]]
    bmat = zxbcdt[..., idx[1]:idx[2]]
    cmat = zxbcdt[..., idx[2]:idx[3]]
    dt = zxbcdt[..., idx[3]:idx[3] + h]
    return z, x, bmat, cmat, dt


def _silu(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """silu in float32, cast to `dtype` (where the JAX package casts)."""
    return F.silu(x.to(torch.float32)).to(dtype)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv. x (B,L,C), w (K,C), b (C,); the taps summed
    in order, as the JAX package sums them."""
    k, l = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = pad[:, 0:l] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + l] * w[i]
    return out + b


def conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor):
    """x_t (B,C); conv_state (B,K-1,C) → (out (B,C), new state). The new
    state is a view of a fresh (B,K,C) window, so a caller may copy it
    over `conv_state`."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)          # (B,K,C)
    out = torch.einsum("bkc,kc->bc", window.to(torch.float32),
                       w.to(torch.float32)) + b
    return out, window[:, 1:]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) → (..., Q, Q): M[i,j] = Σ_{t∈(j,i]} a_t for i≥j else −inf
    (whose exp is an exact zero)."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    ii = torch.arange(q, device=a.device)
    mask = ii[:, None] >= ii[None, :]
    return diff.masked_fill(~mask, -torch.inf)


def ssd_forward(x, bmat, cmat, dt, a_log, d_skip, chunk: int):
    """Chunked SSD scan.

    x (B,L,H,P); bmat/cmat (B,L,G,N); dt (B,L,H) (post-softplus);
    a_log (H,); d_skip (H,). Returns y (B,L,H,P) in x's dtype and the final
    state (B,H,P,N) float32. L must divide by min(chunk, L).
    """
    bsz, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    rep = h // g
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"seq {l} must divide by chunk {q}")
    nc = l // q
    f32 = torch.float32
    a = (-torch.exp(a_log.to(f32)))[None, None] * dt.to(f32)        # (B,L,H)
    xr = (x.to(f32) * dt.to(f32)[..., None]).reshape(bsz, nc, q, h, p)
    br = bmat.to(f32).repeat_interleave(rep, dim=2).reshape(bsz, nc, q, h, n)
    cr = cmat.to(f32).repeat_interleave(rep, dim=2).reshape(bsz, nc, q, h, n)
    ar = a.reshape(bsz, nc, q, h)
    cum = torch.cumsum(ar, dim=2)                                 # (B,nc,Q,H)

    # intra-chunk (diagonal blocks)
    lmat = torch.exp(_segsum(ar.permute(0, 1, 3, 2)))             # (B,nc,H,Q,Q)
    scores = torch.einsum("bcihn,bcjhn->bchij", cr, br)           # (B,nc,H,Q,Q)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores * lmat, xr)

    # chunk-final states and the inter-chunk running state: s_before[c]
    # is the state entering chunk c
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)             # (B,nc,Q,H)
    s_chunk = torch.einsum("bcjhn,bcjh,bcjhp->bchpn", br, decay_to_end, xr)
    chunk_decay = torch.exp(cum[:, :, -1])                        # (B,nc,H)
    s_run = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    before = []
    for c in range(nc):
        before.append(s_run)
        s_run = chunk_decay[:, c, :, None, None] * s_run + s_chunk[:, c]
    s_before = torch.stack(before, dim=1)                         # (B,nc,H,P,N)

    y_off = torch.einsum("bcihn,bcih,bchpn->bcihp", cr, torch.exp(cum),
                         s_before)
    y = (y_diag + y_off).reshape(bsz, l, h, p)
    y = y + d_skip.to(f32)[None, None, :, None] * x.to(f32)
    return y.to(x.dtype), s_run


def ssd_step(x_t, b_t, c_t, dt_t, a_log, d_skip, state):
    """One-token recurrence. x_t (B,H,P); b_t/c_t (B,G,N); dt_t (B,H);
    state (B,H,P,N) float32 → (y (B,H,P) in x_t's dtype, new state)."""
    h = x_t.shape[1]
    rep = h // b_t.shape[1]
    f32 = torch.float32
    bh = b_t.to(f32).repeat_interleave(rep, dim=1)                # (B,H,N)
    ch = c_t.to(f32).repeat_interleave(rep, dim=1)
    da = torch.exp(-torch.exp(a_log.to(f32))[None] * dt_t.to(f32))
    xd = x_t.to(f32) * dt_t.to(f32)[..., None]                    # (B,H,P)
    new_state = (da[..., None, None] * state
                 + torch.einsum("bhp,bhn->bhpn", xd, bh))
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
    y = y + d_skip.to(f32)[None, :, None] * x_t.to(f32)
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------

def _conv_split(conv_out: torch.Tensor, cfg: ModelConfig, lead: tuple):
    """The activated conv output → x (*lead, H, P), B and C (*lead, G, N)."""
    s, di = cfg.ssm, cfg.d_inner
    gn = s.n_groups * s.d_state
    xs = conv_out[..., :di].reshape(*lead, cfg.ssm_heads, s.head_dim)
    bmat = conv_out[..., di:di + gn].reshape(*lead, s.n_groups, s.d_state)
    cmat = conv_out[..., di + gn:].reshape(*lead, s.n_groups, s.d_state)
    return xs, bmat, cmat


def _gate_out(y, z, p, x_dtype, act_bits, impl):
    """y · silu(z), the out norm, then `out_proj`."""
    y = y * _silu(z, x_dtype)
    y = rmsnorm(y, p["out_norm"]["scale"])
    return dense(y, p["out_proj"], act_bits=act_bits, impl=impl)


def mamba_forward(x, p, cfg: ModelConfig, act_bits=None, impl=None):
    """Full-sequence Mamba2 block. x (B,S,E) → (B,S,E), decode cache
    ({"conv": the raw pre-activation tail window, left-padded with zeros
    when S < K−1; "ssm": the final state})."""
    s = cfg.ssm
    bsz, l, _ = x.shape
    zxbcdt = dense(x, p["in_proj"], act_bits=act_bits, impl=impl)
    z, xs, bmat, cmat, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)
    conv_out = _silu(causal_conv(conv_in, p["conv_w"], p["conv_b"]),
                     x.dtype)
    xs, bmat, cmat = _conv_split(conv_out, cfg, (bsz, l))
    dtv = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    y, state = ssd_forward(xs, bmat, cmat, dtv, p["a_log"], p["d_skip"],
                           s.chunk)
    out = _gate_out(y.reshape(bsz, l, cfg.d_inner), z, p, x.dtype,
                    act_bits, impl)
    k = s.d_conv - 1
    tail = F.pad(conv_in, (0, 0, max(0, k - l), 0))[:, -k:]
    return out, {"conv": tail, "ssm": state}


def mamba_decode(x, p, cfg: ModelConfig, cache: dict, act_bits=None,
                 impl=None):
    """One-token Mamba2 step. x (B,1,E); cache = {"conv": (B,K-1,C),
    "ssm": (B,H,P,N)}, both updated in place and returned."""
    bsz = x.shape[0]
    zxbcdt = dense(x[:, 0], p["in_proj"], act_bits=act_bits, impl=impl)
    z, xs, bmat, cmat, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)                 # (B,C)
    conv_out, window = conv_step(conv_in, cache["conv"], p["conv_w"],
                                 p["conv_b"])
    cache["conv"].copy_(window)    # a view of conv_step's own window copy
    xs, bmat, cmat = _conv_split(_silu(conv_out, x.dtype), cfg, (bsz,))
    dtv = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    y, state = ssd_step(xs, bmat, cmat, dtv, p["a_log"], p["d_skip"],
                        cache["ssm"])
    cache["ssm"].copy_(state)
    out = _gate_out(y.reshape(bsz, cfg.d_inner), z, p, x.dtype, act_bits,
                    impl)
    return out[:, None], cache


def mamba_cache_init(batch: int, cfg: ModelConfig, dtype,
                     device=None) -> dict:
    s = cfg.ssm
    conv_ch = cfg.d_inner + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }
