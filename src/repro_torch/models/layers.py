"""Shared building blocks (port of the JAX package's `models/layers.py`):
norms, rotary embeddings, FFNs, embedding table, and the quantization-aware
`dense` — the single choke point through which every GeMV-shaped projection
runs, so the bit-plane kernels take over any linear layer at serving time
when its weight leaf is swapped for `BitplaneWeights`.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..core import backends
from ..core.bitplane import BitplaneWeights
from ..core.quant import QuantSpec, QuantizedTensor


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None,
          act_bits: Optional[int] = None, impl=None) -> torch.Tensor:
    """x (..., N) @ w (N, M). `w` may be:

      torch.Tensor       — dense matmul (unquantized serving)
      BitplaneWeights    — bit-plane kernels (float or bit-serial acts)
      QuantizedTensor    — fused-dequant kernel B5 (the baseline)

    `impl` is a `core.backends.Backend` (None → the default backend), an
    impl string of the bit-plane entry points, or a callable
    `(x, w, act_bits) -> out` (e.g. `core.engine.EngineLinear`) that routes
    every BitplaneWeights linear through the engine.
    """
    if isinstance(w, BitplaneWeights):
        if callable(impl):
            out = impl(x, w, act_bits)
        else:
            from ..kernels.bitplane_gemv import ops as bp
            impl = backends.resolve_impl(impl)
            if act_bits:
                out = bp.bitplane_gemv_bitserial(
                    x, w, QuantSpec(bits=act_bits), impl=impl)
            else:
                out = bp.bitplane_gemv(x, w, impl=impl)
        out = out.to(x.dtype)
    elif isinstance(w, QuantizedTensor):
        from ..kernels.quant_matmul import ops as qm
        # an EngineLinear routes bit-plane leaves only: here it stands for
        # its backend (the JAX package reads the same off its `.mode`)
        impl = backends.resolve_impl(getattr(impl, "backend", impl))
        out = qm.quant_matmul(x, w, impl=impl).to(x.dtype)
    else:
        out = torch.einsum("...n,nm->...m", x, w.to(x.dtype))
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def dense_group(x: torch.Tensor, ws, bs=None, act_bits: Optional[int] = None,
                impl=None) -> tuple:
    """k independent projections of ONE input — q/k/v, up/gate. An `impl`
    exposing a `.group` hook (an `EngineLinear`: the kernel backend fuses
    the group's BitplaneWeights into ONE launch) takes the fused path;
    anything else runs per-leaf `dense` with identical results."""
    ws = tuple(ws)
    bs = tuple(bs) if bs is not None else (None,) * len(ws)
    group = getattr(impl, "group", None)
    if (group is not None and act_bits and len(ws) > 1
            and all(isinstance(w, BitplaneWeights) for w in ws)):
        outs = [o.to(x.dtype) for o in group(x, ws, act_bits)]
        return tuple(o if b is None else o + b.to(o.dtype)
                     for o, b in zip(outs, bs))
    return tuple(dense(x, w, b, act_bits, impl) for w, b in zip(ws, bs))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = True) -> torch.Tensor:
    """RMSNorm with (1+γ) parametrization (gemma/llama-compatible), in
    f32."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    g = scale.to(torch.float32)
    y = y * (1.0 + g) if zero_centered else y * g
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def norm(x, p, norm_type: str):
    if norm_type == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# -- rotary ------------------------------------------------------------------

def rope_frequencies(dim: int, base: float, positions: torch.Tensor
                     ) -> tuple:
    """positions (...,) → cos/sin (..., dim/2) for rotate-half RoPE."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (base ** exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rope_dim: Optional[int] = None) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (..., S, d/2) broadcast over heads."""
    d = rope_dim or x.shape[-1]
    xr, xp = x[..., :d], x[..., d:]
    x1, x2 = torch.chunk(xr.to(torch.float32), 2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]      # add head axis
    rot = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([rot.to(x.dtype), xp], dim=-1)


# -- FFN ---------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def ffn(x: torch.Tensor, p, ffn_type: str, act_bits=None, impl=None):
    """GLU (gated, tanh-GELU) or classic 2-layer MLP."""
    if ffn_type == "glu":
        up, gate = dense_group(x, (p["up"], p["gate"]), act_bits=act_bits,
                               impl=impl)
        h = _gelu(gate.to(torch.float32)).to(x.dtype) * up
    else:
        h = dense(x, p["up"], p.get("up_b"), act_bits=act_bits, impl=impl)
        h = _gelu(h.to(torch.float32)).to(x.dtype)
    return dense(h, p["down"], p.get("down_b"), act_bits=act_bits, impl=impl)


# -- embedding / head --------------------------------------------------------

def embed(tokens: torch.Tensor, table: torch.Tensor, scale: bool,
          d_model: int, dtype: Optional[torch.dtype] = None
          ) -> torch.Tensor:
    """Rows of `table`, cast to `dtype` after the gather (the same values
    as casting the whole table first, without converting every row)."""
    x = table[tokens]
    if dtype is not None:
        x = x.to(dtype)
    if scale:
        x = x * embed_scale(d_model, x.dtype)
    return x


@functools.lru_cache(maxsize=None)
def embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) as the model's dtype rounds it, `tensor(d_model,
    dtype) ** 0.5`, as a Python float: the product with it is bitwise the
    product with that 0-d tensor, and a scalar operand needs no copy from
    the host (which a CUDA graph's capture refuses)."""
    return float(torch.tensor(d_model, dtype=dtype) ** 0.5)


def lm_head(x: torch.Tensor, w, cap: Optional[float], act_bits=None,
            impl=None) -> torch.Tensor:
    logits = dense(x, w, act_bits=act_bits, impl=impl).to(torch.float32)
    return softcap(logits, cap)
