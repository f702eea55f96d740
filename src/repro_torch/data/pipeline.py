"""Deterministic, resumable synthetic LM data (port of the JAX package's
`data/pipeline.py`).

Every batch is a PURE FUNCTION of (seed, step): restarts and replays see
identical data with no iterator state to checkpoint. Tokens follow the JAX
package's noisy affine recurrence, so models have real structure to learn;
labels are next-token.

The draws come from a CPU `torch.Generator` seeded from (seed, step) by a
splitmix64 mix, so a batch is the same whatever device it is placed on.
They are not JAX's threefry draws: the port's stream is its own, and tests
that compare the two packages feed JAX's batches to both.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _batch_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of batch (seed, step)."""
    mixed = _splitmix64(_splitmix64(seed & _MASK64) ^ (step & _MASK64))
    return torch.Generator().manual_seed(mixed >> 1)   # a 63-bit seed


def make_batch(seed: int, step: int, *, batch: int, seq: int, vocab: int,
               embed_dim: int = 0, device=None) -> dict:
    """→ {"tokens" (B,S), "labels" (B,S)} int32 (+ "embeddings" (B,S,E)
    bf16 if asked) on `device` (the GPU unless the caller asks for the
    CPU).

    tokens[t+1] = (5·tokens[t] + 17 + ε) mod vocab with ε ∈ {0,1,2}: a FIXED
    noisy transition table — memorizable by any model with an embedding and
    a head (cross-entropy floor = ln 3 ≈ 1.10).
    """
    device = resolve_device(device)
    gen = _batch_generator(seed, step)
    x0 = torch.randint(0, vocab, (batch,), generator=gen)
    eps = torch.randint(0, 3, (batch, seq + 1), generator=gen)
    toks = torch.empty((batch, seq + 1), dtype=torch.int64)
    toks[:, 0] = x0
    for t in range(seq):
        toks[:, t + 1] = (5 * toks[:, t] + 17 + eps[:, t]) % vocab
    out = {"tokens": toks[:, :seq].to(torch.int32),
           "labels": toks[:, 1:].to(torch.int32)}
    if embed_dim:
        out["embeddings"] = torch.randn((batch, seq, embed_dim),
                                        generator=gen).to(torch.bfloat16)
    return {k: v.to(device) for k, v in out.items()}


@dataclasses.dataclass
class SyntheticLM:
    """Stateless iterator facade over make_batch."""

    vocab: int
    seq: int
    batch: int
    seed: int = 0
    embed_dim: int = 0          # >0 → also emit frontend-stub embeddings

    def batch_at(self, step: int, device=None) -> dict:
        return make_batch(self.seed, step, batch=self.batch, seq=self.seq,
                          vocab=self.vocab, embed_dim=self.embed_dim,
                          device=device)

    def specs(self) -> dict:
        """name → (shape, dtype) of a batch."""
        d = {"tokens": ((self.batch, self.seq), torch.int32),
             "labels": ((self.batch, self.seq), torch.int32)}
        if self.embed_dim:
            d["embeddings"] = ((self.batch, self.seq, self.embed_dim),
                               torch.bfloat16)
        return d
