"""Serving engine (port of the JAX package's `serve/engine.py`): batched
prefill + per-token decode over fixed lanes, optionally with bit-plane
weights, and the axis map of the decode cache's leaves that the continuous
batcher (`serve/scheduler.py`) resets and freezes lanes through.

Quantized serving swaps every GeMV-shaped leaf for packed `BitplaneWeights`
and routes the model's linears through `core.engine.EngineLinear`. On the
default (kernel) backend, each decode step runs:
  * q/k/v and up/gate as one fused launch per group (B2) when activations
    are quantized (`act_bits`), `wo`, `down` and `lm_head` per leaf (B1);
  * every linear through B3 when activations stay float (`act_bits=None`).

Decode is the JAX package's per-token loop (its `scan=False` oracle); the
bucketed masked scan has no counterpart here. The KV cache is updated in
place. Requests of different lengths share the lanes through
`serve.scheduler.ContinuousBatcher`. The DRAM residency session
(`_place_model`), the compiled `decode_program` and the DDR4 pricing of
decode ticks (the batcher's priced clock) wait for the simulator's port
(ROADMAP A9).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..core import backends
from ..core.engine import EngineLinear, MVDRAMEngine
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.model import Model
from .quantize import quantize_params


#: the axes of each decode-cache leaf of one layer (the JAX package's
#: `_CACHE_AXES`); a leaf of the stacked layout ("first", "stages",
#: "shared", "trailing") has its stack axes in front of these
CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", None),
    "v": ("batch", "kv_seq", "kv_heads", None),
    "c_kv": ("batch", "kv_seq", None),
    "k_rope": ("batch", "kv_seq", None),
    "positions": ("batch", "kv_seq"),
    "conv": ("batch", None, "inner"),
    "ssm": ("batch", "inner", None, None),
    "k_scale": ("batch", "kv_seq", "kv_heads"),
    "v_scale": ("batch", "kv_seq", "kv_heads"),
}


def cache_leaves(cache, path=()):
    """Every leaf of a decode-cache tree as (path, leaf, lane axis, kv_seq
    axis or None), the axes counted behind the leaf's leading stack
    axes."""
    if isinstance(cache, dict):
        for k, v in cache.items():
            yield from cache_leaves(v, path + (k,))
        return
    axes = CACHE_AXES[path[-1]]
    lead = cache.ndim - len(axes)
    seq = lead + axes.index("kv_seq") if "kv_seq" in axes else None
    yield path, cache, lead + axes.index("batch"), seq


@dataclasses.dataclass
class Request:
    tokens: list
    max_new: int
    done: bool = False


def params_to(params, device):
    """Move a parameter tree (tensors and BitplaneWeights) to `device`."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


class ServeEngine:
    """Greedy/temperature batched generation over fixed lanes."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int = 512,
                 batch_slots: int = 4, quantized: bool = False,
                 act_bits: Optional[int] = None, impl=None,
                 kv_bits: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_seq = max_seq
        self.slots = batch_slots
        self.mvdram: Optional[MVDRAMEngine] = None
        # the resident DRAM program of the JAX package; the port compiles
        # none until the simulator is ported (ROADMAP A9)
        self.decode_program = None
        params = params_to(params, self.device)
        if cfg.tie_embeddings:
            # the tied head reads the whole table every step in the model's
            # dtype (the JAX package casts it per call): hold it so once;
            # its rows embed the tokens with the same values either way
            params = {**params,
                      "embed": params["embed"].to(getattr(torch, cfg.dtype))}
        model_impl = impl
        if quantized:
            params = quantize_params(params, cfg.weight_bits)
            self.mvdram = MVDRAMEngine()
            model_impl = EngineLinear(self.mvdram,
                                      backend=backends.get_backend(impl))
        self.params = params
        self.model = Model(cfg, act_bits=act_bits if quantized else None,
                           impl=model_impl, kv_bits=kv_bits)

    @torch.no_grad()
    def generate(self, prompts, max_new: int = 32, temperature: float = 0.0,
                 seed: int = 0, max_new_per_lane=None) -> torch.Tensor:
        """prompts: int (B, S0), B ≤ slots, equal-length prompts (requests
        of different lengths go through `serve.scheduler.ContinuousBatcher`,
        which shares the lanes between them). Returns
        (B, S0 + max_new) tokens. `max_new_per_lane` (optional (B,) ints ≤
        max_new) caps lanes individually: a lane past its budget re-emits
        its last token (a 0-budget lane its final prompt token)."""
        prompts = torch.as_tensor(prompts, device=self.device).long()
        b, s0 = prompts.shape
        if b > self.slots:
            raise ValueError(
                f"prompts batch {b} exceeds the engine's {self.slots} "
                f"lanes (prompts shape {tuple(prompts.shape)})")
        if s0 + max_new > self.max_seq:
            raise ValueError(
                f"prompt ({s0}) + max_new ({max_new}) exceeds the cache "
                f"horizon max_seq={self.max_seq}")
        steps_vec = torch.full((b,), max_new - 1, device=self.device)
        budget = None
        if max_new_per_lane is not None:
            budget = torch.as_tensor(max_new_per_lane, device=self.device)
            steps_vec = torch.minimum(budget - 1, steps_vec)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        logits, cache = self.model.prefill(self.params, {"tokens": prompts},
                                           self.max_seq)
        cur = self._sample(logits, temperature, gen)
        if budget is not None:
            cur = torch.where(budget > 0, cur, prompts[:, -1])
        toks = [prompts]
        for t in range(max_new):
            toks.append(cur[:, None])
            if t == max_new - 1:
                break
            logits, cache = self.model.decode_step(self.params, cache, cur,
                                                   s0 + t)
            cur = torch.where(t < steps_vec,
                              self._sample(logits, temperature, gen), cur)
        return torch.cat(toks, dim=1)

    @staticmethod
    def _sample(logits, temperature, gen) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def throughput_tokens_per_s(self, b: int = 1, n: int = 16) -> float:
        """Measured decode tokens/s on this engine's device: b·n generated
        tokens over the wall time of `generate` (prefill included), after a
        warm-up call, synchronised on CUDA."""
        prompts = torch.zeros((b, 8), dtype=torch.long, device=self.device)
        self.generate(prompts, max_new=n)
        self._sync()
        t0 = time.perf_counter()
        self.generate(prompts, max_new=n)
        self._sync()
        return b * n / (time.perf_counter() - t0)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
