"""DRAM residency: capacity-aware placement of weight matrices in the rank.

Port of the JAX package's `core/pud/residency.py` (plain Python, no JAX).

The paper's end-to-end throughput wins (§VI) come from weights LIVING in
DRAM across the whole inference pipeline — staged once at load time, then
served read-only by every decode step. This module owns that lifetime:

  `DramPool`    the allocator. Each (channel, bank) of the `PudGeometry`
                owns `subarrays_per_bank × subarray_rows` rows, minus a
                per-bank compute reserve (accumulator / carry / scratch
                region of the currently-computing subarray — shared by all
                resident layers, since a bank computes one tile at a time,
                §VII). The remaining rows hold resident weight bit-planes:
                per tile, 2 constant rows + a (matrix, complement) row pair
                per reduction row of its chunk — exactly the rows
                `gemv.load_matrix` writes, so a placement's `staged`
                accounting reconciles bit-for-bit with the simulator's
                per-tile preload OpCounts (tested).

  `Placement`   one matrix's persistent home: which (channel, bank) each
                tile computes on (the pool rotates the §VII round-robin
                cursor ACROSS registrations so co-resident layers spread
                over the rank instead of all piling onto bank 0 — the
                precondition for cross-layer wave sharing in
                `schedule.schedule_program`), and the contiguous row span
                reserved in each bank.

Collisions are impossible by construction for pool-driven placement (spans
are carved from per-bank free lists) and rejected with `ResidencyError` for
manual `reserve()` pins. Capacity exhaustion either raises `CapacityError`
(with the per-bank shortfall) or, under `on_full="evict"`, retires
least-recently-used placements until the new matrix fits — the
reuse/capacity-managed allocation RACAM and Sangam apply to DRAM-PIM
(PAPERS.md), with eviction stats kept for the serving layer. Eviction
churn fragments the first-fit row space; `compact()` defragments each
bank (sliding spans down and notifying `move_listeners` so owners restage
the moved rows), and `ServeEngine` invokes it on `CapacityError` before
giving up on a resident decode program.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .device import OpCounts
from .layout import accumulator_width
from .schedule import PudGeometry


class ResidencyError(ValueError):
    """Invalid residency operation (collision, unknown name, double place)."""


class CapacityError(ResidencyError):
    """The pool cannot hold the requested placement."""


@dataclasses.dataclass(frozen=True)
class RowSpan:
    """A contiguous run of resident rows in one bank."""

    channel: int
    bank: int
    row0: int
    rows: int

    @property
    def row1(self) -> int:
        return self.row0 + self.rows

    def overlaps(self, other: "RowSpan") -> bool:
        return (self.channel == other.channel and self.bank == other.bank
                and self.row0 < other.row1 and other.row0 < self.row1)


@dataclasses.dataclass(frozen=True)
class Placement:
    """One matrix's persistent DRAM home (place-then-execute step ①)."""

    name: str
    n_chunks: int
    col_chunks: int
    banks: tuple           # (tiles,) of (channel, bank) in tile order
    spans: tuple           # (RowSpan,) one per occupied bank
    staged: OpCounts       # one-time staging traffic paid at placement
    seq: int               # placement sequence number (LRU bookkeeping)
    pinned: bool = False   # manual reserve(): compaction never moves it

    @property
    def tiles(self) -> int:
        return self.n_chunks * self.col_chunks

    @property
    def resident_rows(self) -> int:
        return sum(s.rows for s in self.spans)


def tile_resident_rows(n_c: int) -> int:
    """Rows one tile keeps resident: 2 constants + (matrix, complement)
    row pair per reduction row — the exact rows `gemv.load_matrix` stages."""
    return 2 + 2 * n_c


def default_compute_reserve(geom: PudGeometry, p_max: int = 8) -> int:
    """Per-bank working-set rows (accumulator + complements, carry, temp,
    MAJ scratch) for the widest accumulator this geometry can need — shared
    by every resident layer, since a bank computes one tile at a time."""
    r = accumulator_width(min(geom.n_sub_max, geom.subarray_rows), p_max)
    return 2 * r + 9


class DramPool:
    """Capacity-aware allocator over one rank's (channel, bank) row space."""

    def __init__(self, geom: PudGeometry = PudGeometry(),
                 compute_reserve: Optional[int] = None):
        self.geom = geom
        self.compute_reserve = (default_compute_reserve(geom)
                                if compute_reserve is None
                                else compute_reserve)
        if self.compute_reserve >= geom.bank_rows:
            raise ValueError(
                f"compute reserve {self.compute_reserve} leaves no resident "
                f"rows in a {geom.bank_rows}-row bank")
        self.placements: dict[str, Placement] = {}
        # per-(channel, bank) list of occupied (row0, row1, name), sorted
        self._occ: dict[tuple, list] = {
            (c, b): [] for c in range(geom.channels)
            for b in range(geom.banks_per_channel)}
        self._cursor = 0       # rotating §VII bank cursor across placements
        self._seq = 0          # monotonic placement/touch counter
        self._lru: dict[str, int] = {}
        # Quarantined (channel, bank) homes: analog-fault escalation marks a
        # bank unhealthy, evicts its residents, and excludes it from every
        # future placement rotation / first-fit / reserve pin.
        self._quarantined: set = set()
        self.evictions = 0
        self.replacements = 0
        self.compactions = 0
        self.moved_placements = 0
        self.restaged_bits = 0     # host writes re-paid for compaction moves
        self.quarantine_evictions = 0
        # called as fn(name, placement) on EVERY eviction — including the
        # pool-driven ones (LRU on_full, replace) — so owners (the engine)
        # can drop staged state and invalidate handles
        self.evict_listeners: list = []
        # called as fn(name, old_placement, new_placement) when compact()
        # physically moves a placement's row spans — owners must restage
        # the moved rows (the engine drops the staged BankArrays; they
        # rebuild lazily against the new spans)
        self.move_listeners: list = []

    # -- capacity accounting -------------------------------------------------

    @property
    def bank_capacity(self) -> int:
        """Resident rows available per bank (after the compute reserve)."""
        return self.geom.bank_rows - self.compute_reserve

    @property
    def total_rows(self) -> int:
        return self.bank_capacity * self.geom.banks

    @property
    def used_rows(self) -> int:
        return sum(p.resident_rows for p in self.placements.values())

    @property
    def free_rows(self) -> int:
        return self.total_rows - self.used_rows

    @property
    def utilization(self) -> float:
        return self.used_rows / self.total_rows if self.total_rows else 0.0

    def stats(self) -> dict:
        return {
            "placements": len(self.placements),
            "total_rows": self.total_rows,
            "used_rows": self.used_rows,
            "free_rows": self.free_rows,
            "utilization": self.utilization,
            "evictions": self.evictions,
            "replacements": self.replacements,
            "compactions": self.compactions,
            "moved_placements": self.moved_placements,
            "restaged_bits": self.restaged_bits,
            "staged_bits": sum(p.staged.host_bits_written
                               for p in self.placements.values()),
            "quarantined_banks": len(self._quarantined),
            "quarantine_evictions": self.quarantine_evictions,
        }

    # -- placement -----------------------------------------------------------

    def _healthy_slots(self) -> list:
        """Rank slots in §VII rotation order, quarantined banks excluded.
        With nothing quarantined this is exactly the (channels ·
        banks_per_channel)-slot rotation, so placement is unchanged."""
        g = self.geom
        slots = [(s % g.channels, (s // g.channels) % g.banks_per_channel)
                 for s in range(g.parallel_tiles)]
        return [cb for cb in slots if cb not in self._quarantined]

    def _tile_banks(self, tiles: int) -> list:
        """Continue the §VII round-robin from the pool cursor: tile t of the
        new matrix computes on rank slot (cursor + t), so co-resident layers
        stagger across banks instead of all starting at (0, 0). Quarantined
        banks drop out of the rotation — the surviving slots absorb their
        tiles."""
        healthy = self._healthy_slots()
        if not healthy:
            raise CapacityError(
                f"every bank of the rank is quarantined "
                f"({len(self._quarantined)}/{self.geom.parallel_tiles})")
        return [healthy[(self._cursor + t) % len(healthy)]
                for t in range(tiles)]

    def _demand(self, banks: Sequence, chunk_rows: Sequence[int],
                col_chunks: int) -> dict:
        """Per-(channel, bank) resident-row demand of one matrix."""
        need: dict[tuple, int] = {}
        for t, cb in enumerate(banks):
            n_c = chunk_rows[t // col_chunks]
            need[cb] = need.get(cb, 0) + tile_resident_rows(n_c)
        return need

    def _find_gap(self, cb: tuple, rows: int) -> Optional[int]:
        """First-fit contiguous free run of `rows` rows in bank `cb`."""
        if cb in self._quarantined:
            return None
        cur = 0
        for row0, row1, _name in self._occ[cb]:
            if row0 - cur >= rows:
                return cur
            cur = max(cur, row1)
        if self.bank_capacity - cur >= rows:
            return cur
        return None

    def place(self, name: str, chunk_rows: Sequence[int], col_chunks: int,
              replace: bool = False, on_full: str = "raise") -> Placement:
        """Assign a matrix a persistent home.

        chunk_rows: (n_chunks,) reduction rows per chunk (ragged tail
        included) — together with `col_chunks` this is the matrix's tile
        grid in chunk-major order.
        replace:    re-registering an existing name evicts its old placement
                    first (counted in `replacements`); without it the name
                    collision raises.
        on_full:    "raise" → `CapacityError` naming the shortfall;
                    "evict" → retire least-recently-used placements until
                    the new matrix fits (or nothing is left to evict).
        """
        if on_full not in ("raise", "evict"):
            raise ValueError(f"on_full must be 'raise' or 'evict', "
                             f"got {on_full!r}")
        chunk_rows = list(chunk_rows)
        if not chunk_rows or col_chunks < 1:
            raise ResidencyError(
                f"empty tile grid for {name!r}: chunk_rows={chunk_rows}, "
                f"col_chunks={col_chunks}")
        if name in self.placements:
            if not replace:
                prev = self.placements[name]
                raise ResidencyError(
                    f"{name!r} is already resident ({prev.resident_rows} "
                    f"rows across {len(prev.spans)} bank span(s), pool "
                    f"{self.used_rows}/{self.total_rows} rows used); "
                    f"evict() it or pass replace=True to re-register")
            self.evict(name)
            self.replacements += 1
        tiles = len(chunk_rows) * col_chunks
        banks = self._tile_banks(tiles)
        need = self._demand(banks, chunk_rows, col_chunks)
        while True:
            short = {cb: rows for cb, rows in need.items()
                     if self._find_gap(cb, rows) is None}
            if not short:
                break
            if on_full == "evict":
                # targeted: only evicting a resident of a SHORT bank can
                # help; pick the least-recently-used such occupant
                cands = {e[2] for cb in short for e in self._occ[cb]
                         if e[2] in self._lru}
                if cands:
                    victim = min(cands, key=self._lru.get)
                    self.evict(victim)
                    self.evictions += 1
                    continue
            worst = max(short.items(), key=lambda kv: kv[1])
            raise CapacityError(
                f"cannot place {name!r}: {len(short)} bank(s) lack a "
                f"contiguous run (worst: channel {worst[0][0]} bank "
                f"{worst[0][1]} needs {worst[1]} rows, bank capacity "
                f"{self.bank_capacity}, pool free {self.free_rows} rows)")
        spans = []
        for cb, rows in sorted(need.items()):
            row0 = self._find_gap(cb, rows)
            self._occ[cb].append((row0, row0 + rows, name))
            self._occ[cb].sort()
            spans.append(RowSpan(channel=cb[0], bank=cb[1],
                                 row0=row0, rows=rows))
        staged_rows = sum(need.values())
        placement = Placement(
            name=name, n_chunks=len(chunk_rows), col_chunks=col_chunks,
            banks=tuple(banks), spans=tuple(spans),
            staged=OpCounts(
                host_bits_written=staged_rows * self.geom.subarray_cols),
            seq=self._seq)
        self.placements[name] = placement
        self._lru[name] = self._seq
        self._seq += 1
        self._cursor = (self._cursor + tiles) % self.geom.parallel_tiles
        return placement

    def reserve(self, name: str, spans: Sequence[RowSpan]) -> Placement:
        """Pin an explicit row range (manual placement). Overlap with any
        resident span — or the per-bank capacity — is rejected. Pinned
        spans are immovable: `compact()` packs pool-driven placements
        AROUND them, since a caller that fixed absolute row addresses may
        coordinate them with state the pool cannot see."""
        if name in self.placements:
            prev = self.placements[name]
            raise ResidencyError(
                f"{name!r} is already resident ({prev.resident_rows} rows "
                f"across {len(prev.spans)} bank span(s)); evict() it before "
                f"pinning new rows")
        spans = tuple(spans)
        for s in spans:
            if s.row1 > self.bank_capacity or s.row0 < 0:
                raise CapacityError(
                    f"span {s} exceeds bank capacity {self.bank_capacity}")
            if (s.channel, s.bank) in self._quarantined:
                raise ResidencyError(
                    f"span {s} pins rows on quarantined bank "
                    f"(channel {s.channel}, bank {s.bank})")
            for row0, row1, other in self._occ[(s.channel, s.bank)]:
                if s.row0 < row1 and row0 < s.row1:
                    raise ResidencyError(
                        f"span {s} overlaps resident placement {other!r} "
                        f"(rows {row0}..{row1} of channel {s.channel} "
                        f"bank {s.bank})")
        for s in spans:
            self._occ[(s.channel, s.bank)].append((s.row0, s.row1, name))
            self._occ[(s.channel, s.bank)].sort()
        placement = Placement(
            name=name, n_chunks=1, col_chunks=1,
            banks=((spans[0].channel, spans[0].bank),) if spans else (),
            spans=spans,
            staged=OpCounts(host_bits_written=sum(s.rows for s in spans)
                            * self.geom.subarray_cols),
            seq=self._seq, pinned=True)
        self.placements[name] = placement
        self._lru[name] = self._seq
        self._seq += 1
        return placement

    def evict(self, name: str) -> Placement:
        """Remove a placement, freeing its row spans. Returns the retired
        `Placement` (its `staged` bits are what a re-load would pay).
        Notifies `evict_listeners` — pool-driven evictions (LRU, replace)
        go through here too, so owners always see the retirement."""
        if name not in self.placements:
            raise ResidencyError(
                f"{name!r} is not resident ({len(self.placements)} resident "
                f"placement(s), {self.free_rows}/{self.total_rows} rows "
                f"free)")
        placement = self.placements.pop(name)
        self._lru.pop(name, None)
        for cb in self._occ:
            self._occ[cb] = [e for e in self._occ[cb] if e[2] != name]
        for fn in self.evict_listeners:
            fn(name, placement)
        return placement

    # -- bank health ---------------------------------------------------------

    def is_quarantined(self, channel: int, bank: int) -> bool:
        return (channel, bank) in self._quarantined

    def quarantined(self) -> list:
        return sorted(self._quarantined)

    def quarantine_bank(self, channel: int, bank: int) -> list:
        """Mark one (channel, bank) unhealthy: its residents are evicted
        (owners notified through `evict_listeners`, exactly like LRU
        evictions) and no future placement — rotation, first-fit, or
        `reserve()` pin — will touch it. Returns the evicted placement
        names so the caller (the engine's fault-recovery policy) can
        re-place them on healthy banks. Idempotent."""
        cb = (channel, bank)
        if cb in self._quarantined:
            return []
        if not (0 <= channel < self.geom.channels
                and 0 <= bank < self.geom.banks_per_channel):
            raise ResidencyError(
                f"no such bank: channel {channel}, bank {bank} in a "
                f"{self.geom.channels}x{self.geom.banks_per_channel} rank")
        self._quarantined.add(cb)
        victims = sorted({e[2] for e in self._occ[cb]})
        for name in victims:
            self.evict(name)
            self.quarantine_evictions += 1
        return victims

    def compact(self) -> dict:
        """Defragment every bank: slide pool-driven resident spans down so
        the free rows coalesce.

        First-fit placement leaves unusable gaps after eviction churn — a
        bank can hold enough free rows in total yet reject a block that
        needs them contiguous. Compaction moves each bank's movable spans
        toward the bottom in order (no span ever moves up through
        another, so every move is downward and stays within capacity),
        packing AROUND `reserve()` pins, which never move. It rebuilds the
        affected `Placement`s with the new row ranges and notifies
        `move_listeners(name, old, new)` so owners restage the moved rows
        — physically moved weight bit-planes are no longer where the
        staged `BankArray`s put them. `ServeEngine` calls this on
        `CapacityError` before giving up on a resident decode program.
        Returns {"moved": n, "freed_gaps": pre-compaction interior gap
        rows}.
        """
        moved_names: set = set()
        gap_rows = 0
        for cb in self._occ:
            entries = sorted(self._occ[cb])
            prev_end = 0
            for row0, row1, _name in entries:
                gap_rows += row0 - prev_end
                prev_end = row1
            pins = [e for e in entries
                    if self.placements[e[2]].pinned]
            new_entries = list(pins)
            cur = 0
            for row0, row1, name in entries:
                if self.placements[name].pinned:
                    continue
                rows = row1 - row0
                # skip over any pin the span would overlap; pins are
                # ascending and cur only grows, so one pass suffices
                for p0, p1, _p in pins:
                    if p0 < cur + rows and p1 > cur:
                        cur = p1
                if row0 != cur:
                    moved_names.add(name)
                new_entries.append((cur, cur + rows, name))
                cur += rows
            self._occ[cb] = sorted(new_entries)
        for name in sorted(moved_names):
            old = self.placements[name]
            spans = []
            for cb in sorted(self._occ):
                for row0, row1, owner in self._occ[cb]:
                    if owner == name:
                        spans.append(RowSpan(channel=cb[0], bank=cb[1],
                                             row0=row0, rows=row1 - row0))
            new = dataclasses.replace(old, spans=tuple(spans))
            self.placements[name] = new
            # a moved placement's rows must be physically rewritten at the
            # new addresses — the owner restages lazily via move_listeners,
            # and that traffic is real DRAM-write cost the stats must show
            # (Placement.staged keeps its one-time-at-placement meaning,
            # which the program/oracle reconciliations depend on)
            self.restaged_bits += old.staged.host_bits_written
            for fn in self.move_listeners:
                fn(name, old, new)
        self.compactions += 1
        self.moved_placements += len(moved_names)
        return {"moved": len(moved_names), "freed_gaps": gap_rows}

    def can_place(self, chunk_rows: Sequence[int], col_chunks: int) -> bool:
        """Feasibility probe: would `place()` succeed right now without any
        eviction? Pure read — cursor, occupancy and LRU state untouched, so
        the fabric's rebalancer can test a destination DIMM before paying a
        migration's evict/restage churn."""
        chunk_rows = list(chunk_rows)
        if not chunk_rows or col_chunks < 1:
            return False
        try:
            banks = self._tile_banks(len(chunk_rows) * col_chunks)
        except CapacityError:
            return False
        need = self._demand(banks, chunk_rows, col_chunks)
        return all(self._find_gap(cb, rows) is not None
                   for cb, rows in need.items())

    def touch(self, name: str) -> None:
        """LRU bump on execution (the engine calls this per GeMV launch)."""
        if name in self._lru:
            self._lru[name] = self._seq
            self._seq += 1

    def is_resident(self, name: str) -> bool:
        return name in self.placements
