"""Fault injection for processing-using-DRAM (port of the JAX package's
`core/pud/faults.py`, the reliability layer).

MVDRAM's MAJX primitive is an *analog* trick — timing-violating ACT/PRE on
unmodified DDR4 — and the paper only trusts its result on calibrated
reliable columns (Table I). Real PuD success rates are probabilistic,
per-cell, and drift over time. This module gives the bit-exact simulator
that failure mode, deterministically:

  `FaultModel`    frozen, seeded configuration. `transient_ber` is the
                  per-(request, tile) probability that one wave's
                  accumulator output is corrupted by a one-shot MAJX upset
                  (a fresh draw every execution, so a retry usually
                  succeeds). `weak_cell_rate` populates a *sticky* weak-
                  cell map per (channel, bank): the same columns fail on
                  every pass over that bank — the fault a retry cannot fix
                  and bank quarantine exists for. `FaultModel.none()`
                  (the default) produces NO session, so the fault-free
                  path is provably bit-identical to the pre-fault code.

  `FaultSession`  the mutable per-engine stream: one explicit numpy
                  `np.random.Generator` seeded from the model (no global
                  RNG anywhere in `core/pud/` — tested by grep), plus the
                  cached weak-cell maps. Weak maps derive from an
                  order-independent child seed `[seed, tag, channel,
                  bank]`. The draws are numpy's on the host, so a seed
                  gives the JAX package's stream draw for draw; only the
                  flips they pick are applied to the accumulator tensors,
                  on whatever device those live.

  `FaultTrace`    what one launch observed: ground-truth corrupted cells,
                  ABFT-detected cells, bounded retries (with their op
                  bills, reconciled into `timing.price_program`), and the
                  cells/banks still corrupt when the retry budget ran out
                  — the engine's quarantine/degrade escalation input.

Every injection is a SINGLE bit-0 flip of one column of one (request,
tile) accumulator value, so a corrupted cell's column-sum always moves by
exactly ±1 — the ABFT checksum can never see a cancelling pair, and
detection coverage is a theorem, not a statistic.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .device import OpCounts

# Sub-stream tag separating weak-cell map derivation from the session's
# transient stream (np.random.default_rng accepts a seed sequence).
_WEAK_STREAM = 0x57EAC


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Seeded, deterministic MAJX fault configuration.

    transient_ber:   per-(request, tile) per-wave probability of a one-shot
                     output corruption (re-drawn on every execution).
    weak_cell_rate:  per-column probability that a (channel, bank) column is
                     permanently weak (sticky across the session).
    weak_flip_prob:  probability that a weak bank actually corrupts a given
                     pass (1.0 = deterministic persistent fault; retries on
                     the same bank always fail until it is quarantined).
    seed:            root of the explicit `np.random.Generator` stream.
    """

    transient_ber: float = 0.0
    weak_cell_rate: float = 0.0
    weak_flip_prob: float = 1.0
    seed: int = 0

    def __post_init__(self):
        for field in ("transient_ber", "weak_cell_rate", "weak_flip_prob"):
            v = getattr(self, field)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{field} must be a probability in [0, 1], "
                                 f"got {v}")

    @classmethod
    def none(cls) -> "FaultModel":
        """The fault-free model: `session()` returns None, so every executor
        takes the exact pre-fault code path (bit-identical)."""
        return cls()

    @property
    def enabled(self) -> bool:
        return self.transient_ber > 0.0 or self.weak_cell_rate > 0.0

    def session(self) -> Optional["FaultSession"]:
        return FaultSession(self) if self.enabled else None


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Engine recovery escalation ladder.

    max_wave_retries: bounded re-executions of a faulty wave segment before
                      the launch reports the cells unresolved.
    quarantine_after: unresolved-fault strikes against one (channel, bank)
                      before the pool quarantines it (evict + restage
                      elsewhere).
    degrade_after:    host-fallback recomputations of one linear before the
                      engine degrades it permanently to the reference
                      backend.
    """

    max_wave_retries: int = 2
    quarantine_after: int = 2
    degrade_after: int = 2


@dataclasses.dataclass
class FaultTrace:
    """Per-launch fault observability (attached to the batch report)."""

    corrupted: int = 0          # ground-truth corrupted (request, tile) cells
    detected: int = 0           # of those, cells the ABFT checksum flagged
    retries: int = 0            # wave-segment re-executions performed
    retry_wave_ops: list = dataclasses.field(default_factory=list)
    # Complete per-command ledger of the retries: each re-executed wave
    # segment re-bills its full `OpCounts` slice (commands, readout bits,
    # host ops), merged here so `timing.price_program` can price retry
    # ENERGY exactly, next to the `retry_wave_ops` time bill.
    retry_counts: "OpCounts" = dataclasses.field(default_factory=OpCounts)
    unresolved: list = dataclasses.field(default_factory=list)
    #                 ^ (request, layer, tile) cells corrupt past the budget
    unresolved_banks: list = dataclasses.field(default_factory=list)
    #                 ^ (channel, bank) homes of unresolved cells

    @property
    def coverage(self) -> float:
        """Detected / corrupted (1.0 when nothing was corrupted)."""
        return self.detected / self.corrupted if self.corrupted else 1.0

    def merge(self, other: "FaultTrace") -> None:
        self.corrupted += other.corrupted
        self.detected += other.detected
        self.retries += other.retries
        self.retry_wave_ops.extend(other.retry_wave_ops)
        self.retry_counts = self.retry_counts.merge(other.retry_counts)
        self.unresolved.extend(other.unresolved)
        for cb in other.unresolved_banks:
            if cb not in self.unresolved_banks:
                self.unresolved_banks.append(cb)


class FaultSession:
    """Mutable fault stream for one engine lifetime.

    All randomness flows through ONE explicit `np.random.Generator` (the
    transient stream) plus order-independent per-(channel, bank) child
    generators for the sticky weak-cell maps — never a global RNG.
    """

    def __init__(self, model: FaultModel):
        if not model.enabled:
            raise ValueError("FaultSession requires an enabled FaultModel; "
                             "use FaultModel.none() -> session() is None")
        self.model = model
        self._rng = np.random.default_rng(model.seed)
        self._weak: dict = {}
        self.transient_injections = 0
        self.persistent_injections = 0

    # -- weak-cell maps ------------------------------------------------------

    def weak_mask(self, channel: int, bank: int, cols: int) -> np.ndarray:
        """Sticky per-(channel, bank) weak-column mask, (cols,) bool.

        Derived from `[seed, tag, channel, bank]`, so the map is a pure
        function of the model and the bank id — independent of visit order.
        """
        key = (channel, bank, cols)
        mask = self._weak.get(key)
        if mask is None:
            child = np.random.default_rng(
                [self.model.seed, _WEAK_STREAM, channel, bank])
            mask = child.random(cols) < self.model.weak_cell_rate
            self._weak[key] = mask
        return mask

    def bank_is_weak(self, channel: int, bank: int, cols: int) -> bool:
        return bool(self.weak_mask(channel, bank, cols).any())

    def _weak_fires(self) -> bool:
        """Does the weak map corrupt this pass? (weak_flip_prob subsampling;
        1.0 keeps persistent faults deterministic so retries cannot fix
        them — that is what quarantine is for.)"""
        if self.model.weak_flip_prob >= 1.0:
            return True
        return bool(self._rng.random() < self.model.weak_flip_prob)

    # -- device-level injection (Subarray.majx / BankArray.majx) -------------

    def flip_columns(self, cols: int, channel: int = 0,
                     bank: int = 0) -> np.ndarray:
        """(cols,) bool flip mask for ONE subarray-level MAJX result."""
        flips = np.zeros(cols, dtype=bool)
        if self.model.weak_cell_rate > 0.0:
            weak = self.weak_mask(channel, bank, cols)
            if weak.any() and self._weak_fires():
                flips |= weak
                self.persistent_injections += int(weak.sum())
        if self.model.transient_ber > 0.0:
            trans = self._rng.random(cols) < self.model.transient_ber
            trans &= ~flips
            flips |= trans
            self.transient_injections += int(trans.sum())
        return flips

    def flip_tiles(self, bank_keys: Sequence, cols: int) -> np.ndarray:
        """(tiles, cols) bool flip masks for one wave-level MAJX."""
        flips = np.zeros((len(bank_keys), cols), dtype=bool)
        for t, (ch, bk) in enumerate(bank_keys):
            flips[t] = self.flip_columns(cols, int(ch), int(bk))
        return flips

    # -- accumulator-level injection (vectorized executors) ------------------

    def corrupt_accumulator(self, acc_val: torch.Tensor,
                            bank_keys: np.ndarray) -> np.ndarray:
        """Corrupt one wave's (B, T, cols) int64 accumulator VALUES in
        place, on their device.

        Returns the (B, T) ground-truth corrupted-cell mask on the host (for
        coverage accounting — the detector never sees it). Each corrupted
        cell takes exactly one bit-0 flip of one column: persistent faults
        hit the bank's first weak column (every request, every pass the
        weak map fires); transient faults hit a fresh random column of cells
        not already corrupted, so flips can never cancel pairwise.
        """
        B, T, cols = acc_val.shape
        hit = np.zeros((B, T), dtype=bool)
        if self.model.weak_cell_rate > 0.0:
            for t in range(T):
                ch, bk = int(bank_keys[t][0]), int(bank_keys[t][1])
                weak = self.weak_mask(ch, bk, cols)
                if not weak.any() or not self._weak_fires():
                    continue
                c0 = int(np.argmax(weak))
                acc_val[:, t, c0] ^= 1
                self.persistent_injections += B
                hit[:, t] = True
        if self.model.transient_ber > 0.0:
            trans = self._rng.random((B, T)) < self.model.transient_ber
            trans &= ~hit
            if trans.any():
                bs, ts = np.nonzero(trans)
                picks = self._rng.integers(0, cols, size=bs.size)
                idx = tuple(torch.as_tensor(v, dtype=torch.long,
                                            device=acc_val.device)
                            for v in (bs, ts, picks))
                acc_val[idx] ^= 1
                self.transient_injections += int(bs.size)
                hit |= trans
        return hit

    def stats(self) -> dict:
        return {
            "transient_injections": self.transient_injections,
            "persistent_injections": self.persistent_injections,
            "weak_banks": sum(1 for m in self._weak.values() if m.any()),
        }
