"""DRAM fabric: multi-DIMM sharded residency with a tiered capacity spill
(port of the JAX package's `core/pud/fabric.py`; plain Python).

The paper's end-to-end evaluation (§VI) scales GeMV throughput across FOUR
DDR4 modules; until now the repo served everything from one `DramPool`, so
model size was capped by one pool and throughput by one channel. This
module federates several `DramPool`-backed DIMM devices into one
`FabricPool` — the fabric layer Sangam's chiplet scale-out and
CXL-attached capacity tiering (PAPERS.md) describe for DRAM-PIM:

  `FabricPool`   drop-in for `DramPool` wherever the engine talks to a
                 pool (place / evict / touch / compact / quarantine /
                 listeners), but placements land on one of `dimms` member
                 pools picked by a rotating DIMM cursor, so co-registered
                 layers stripe across modules. Coordinates are GLOBAL:
                 DIMM d's local channel c is fabric channel
                 ``d * geom.channels + c``, which keeps fault keys,
                 quarantine bookkeeping and weak-cell maps distinct per
                 module for free (the fault session keys per
                 (channel, bank)).

  rebalance()    cross-DIMM compaction. Per-bank `DramPool.compact()`
                 already slides spans inside a bank; the fabric extends it
                 ACROSS modules — when one pool fragments or quarantines
                 banks faster than its peers, whole placements migrate to
                 the coldest DIMM through the existing `move_listeners`
                 contract, so owners restage exactly as they do for an
                 intra-bank move.

  spill tier     capacity tiering: when `on_full="spill"`, placements that
                 do not fit anywhere are not fatal — the fabric retires
                 the least-recently-used resident to a CXL-latency spill
                 tier (`SpillEntry` remembers its grid and staging bits)
                 and pages it back on demand (`restage()`), so a compiled
                 program can serve a model larger than ANY single pool.
                 Every page-in's rewritten bits are counted
                 (`spill_restaged_bits`) and priced exactly by
                 `timing.CxlModel` inside `price_program`.

  plan_column_shards / fabric_mesh
                 the column-chunk tensor-parallel split of ONE GeMV
                 across DIMMs (`engine.register_sharded`), expressed
                 through the sharding rules (`parallel/sharding.py`) over
                 a host mesh (`launch/mesh.py`).

A fabric program's parts execute in the PUD simulator
(`engine.FabricProgram.run`, paging spilled parts in first).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .residency import (CapacityError, DramPool, Placement, ResidencyError,
                        tile_resident_rows)
from .schedule import PudGeometry


def requested_rows(chunk_rows: Sequence[int], col_chunks: int) -> int:
    """Total resident rows one tile grid demands (all tiles, all banks)."""
    return col_chunks * sum(tile_resident_rows(n_c) for n_c in chunk_rows)


@dataclasses.dataclass(frozen=True)
class SpillEntry:
    """One cold layer parked in the spill tier: everything `restage()`
    needs to page it back into a DIMM, plus the staging bits a page-in
    must rewrite (the quantity `CxlModel.restage_time` prices)."""

    name: str
    bits: int
    chunk_rows: tuple
    col_chunks: int

    @property
    def rows(self) -> int:
        return requested_rows(self.chunk_rows, self.col_chunks)


@dataclasses.dataclass(frozen=True)
class ColumnShardPlan:
    """Contiguous column-chunk ranges of one GeMV, one per shard.

    `chunk_bounds[d] : chunk_bounds[d+1]` is shard d's slice of the column
    chunks (np.array_split-style: sizes differ by at most one, ragged last
    chunk included). `pspec` records how the sharding rules resolved the
    logical "mlp" (output-column) axis on the fabric mesh — `"model"` when
    the mesh's model axis divides the chunks, `None` (replicated,
    host-side reduction only) otherwise.
    """

    col_chunks: int
    shards: int
    chunk_bounds: tuple
    axis: str = "mlp"
    pspec: tuple = (None,)

    def bounds_cols(self, m: int, m_per_tile: int) -> tuple:
        """Chunk bounds converted to output-column offsets into M."""
        return tuple(min(cb * m_per_tile, m) for cb in self.chunk_bounds)


def fabric_mesh(dimms: int, device=None):
    """Host mesh whose "model" axis carries the per-DIMM column shards,
    over the devices `launch.mesh.make_host_mesh` covers (capped at their
    count)."""
    from ...launch.mesh import make_host_mesh

    if dimms < 1:
        raise ValueError(f"fabric mesh needs >= 1 DIMM, got {dimms}")
    return make_host_mesh(model=dimms, device=device)


def plan_column_shards(col_chunks: int, shards: int, mesh=None,
                       rules=None, device=None) -> ColumnShardPlan:
    """Split `col_chunks` column chunks of one GeMV into `shards`
    contiguous ranges, expressing the split through the sharding rules:
    the logical "mlp" axis (output columns) maps onto the mesh "model"
    axis exactly as `parallel/sharding.py` would shard an MLP weight. The
    mesh defaults to `fabric_mesh(shards, device)`."""
    if col_chunks < 1:
        raise ValueError(f"need >= 1 column chunk, got {col_chunks}")
    if shards < 1:
        raise ValueError(f"need >= 1 shard, got {shards}")
    shards = min(shards, col_chunks)
    base, extra = divmod(col_chunks, shards)
    bounds = [0]
    for d in range(shards):
        bounds.append(bounds[-1] + base + (1 if d < extra else 0))
    from ...parallel.sharding import axis_rules, logical_to_pspec

    rules = dict(rules or {"mlp": "model"})
    if mesh is None:
        mesh = fabric_mesh(shards, device)
    with axis_rules(mesh, rules):
        spec = logical_to_pspec(("mlp",), (col_chunks,), mesh, rules)
    return ColumnShardPlan(col_chunks=col_chunks, shards=shards,
                           chunk_bounds=tuple(bounds), pspec=tuple(spec))


class FabricPool:
    """Federation of `dimms` `DramPool` devices behind the pool protocol.

    Placements carry global (channel, bank) coordinates; the member pools
    never learn they are part of a fabric. The fabric owns the cross-DIMM
    policy: which module a new layer lands on (rotating DIMM cursor),
    which resident gets retired when everything is full (fabric-wide LRU,
    evicted or spilled per `on_full`), and when a whole placement migrates
    to a colder module (`rebalance()`).
    """

    def __init__(self, geom: PudGeometry = PudGeometry(), dimms: int = 2,
                 compute_reserve: Optional[int] = None):
        if dimms < 1:
            raise ValueError(f"fabric needs >= 1 DIMM, got {dimms}")
        self.geom = geom                   # per-DIMM geometry
        self.dimms = dimms
        self.pools = [DramPool(geom, compute_reserve) for _ in range(dimms)]
        self.placements: dict[str, Placement] = {}   # global coordinates
        self._local: dict[str, int] = {}             # name -> home DIMM
        self._grids: dict[str, tuple] = {}           # name -> (chunk_rows, cc)
        self._spilled: dict[str, SpillEntry] = {}
        self._migrating: set = set()
        self._dimm_cursor = 0
        self._seq = 0
        self._lru: dict[str, int] = {}
        self.evictions = 0
        self.replacements = 0
        self.compactions = 0
        self.migrations = 0
        self.migrated_bits = 0
        self.spills = 0
        self.spill_restages = 0
        self.spill_restaged_bits = 0
        # same owner contract as DramPool: fn(name, placement) on every
        # eviction, fn(name, old, new) when resident rows physically move
        # (member compaction AND fabric-level migration both land here)
        self.evict_listeners: list = []
        self.move_listeners: list = []
        for d, pool in enumerate(self.pools):
            pool.evict_listeners.append(self._member_evict_forwarder(d))
            pool.move_listeners.append(self._member_move_forwarder(d))

    # -- coordinate translation ---------------------------------------------

    def _globalize(self, dimm: int, local: Placement) -> Placement:
        off = dimm * self.geom.channels
        return dataclasses.replace(
            local,
            banks=tuple((c + off, b) for c, b in local.banks),
            spans=tuple(dataclasses.replace(s, channel=s.channel + off)
                        for s in local.spans))

    def locate(self, name: str) -> tuple:
        """(home DIMM, LOCAL placement) of a resident layer — the local
        banks are what per-part wave schedules and `price_program`'s
        channel accounting index with."""
        if name not in self._local:
            raise ResidencyError(
                f"{name!r} is not resident on the fabric "
                f"({len(self.placements)} resident, "
                f"{len(self._spilled)} spilled)")
        d = self._local[name]
        return d, self.pools[d].placements[name]

    def dimm_of(self, name: str) -> int:
        return self.locate(name)[0]

    # -- member listener forwarding -----------------------------------------

    def _member_evict_forwarder(self, dimm: int):
        def _forward(name, local_placement):
            global_p = self.placements.pop(name, None)
            self._local.pop(name, None)
            self._lru.pop(name, None)
            if name in self._migrating:
                return      # fabric migration: move_listeners fire instead
            if global_p is None:
                global_p = self._globalize(dimm, local_placement)
            for fn in self.evict_listeners:
                fn(name, global_p)
        return _forward

    def _member_move_forwarder(self, dimm: int):
        def _forward(name, old_local, new_local):
            old_g = self.placements.get(name)
            if old_g is None:
                old_g = self._globalize(dimm, old_local)
            new_g = self._globalize(dimm, new_local)
            self.placements[name] = new_g
            for fn in self.move_listeners:
                fn(name, old_g, new_g)
        return _forward

    # -- capacity accounting -------------------------------------------------

    @property
    def bank_capacity(self) -> int:
        return self.pools[0].bank_capacity

    @property
    def total_rows(self) -> int:
        return sum(p.total_rows for p in self.pools)

    @property
    def used_rows(self) -> int:
        return sum(p.used_rows for p in self.pools)

    @property
    def free_rows(self) -> int:
        return self.total_rows - self.used_rows

    @property
    def utilization(self) -> float:
        return self.used_rows / self.total_rows if self.total_rows else 0.0

    def _occupancy_str(self) -> str:
        return ", ".join(
            f"dimm{d} {p.used_rows}/{p.total_rows} rows "
            f"({p.utilization:.0%}, {len(p.quarantined())} quarantined "
            f"bank(s))" for d, p in enumerate(self.pools))

    def stats(self) -> dict:
        merged = {
            "dimms": self.dimms,
            "placements": len(self.placements),
            "total_rows": self.total_rows,
            "used_rows": self.used_rows,
            "free_rows": self.free_rows,
            "utilization": self.utilization,
            "evictions": self.evictions + sum(p.evictions
                                              for p in self.pools),
            "replacements": self.replacements,
            "compactions": self.compactions,
            "moved_placements": sum(p.moved_placements for p in self.pools),
            "restaged_bits": sum(p.restaged_bits for p in self.pools),
            "staged_bits": sum(p.stats()["staged_bits"] for p in self.pools),
            "quarantined_banks": sum(len(p.quarantined())
                                     for p in self.pools),
            "quarantine_evictions": sum(p.quarantine_evictions
                                        for p in self.pools),
            "migrations": self.migrations,
            "migrated_bits": self.migrated_bits,
            "spilled": len(self._spilled),
            "spills": self.spills,
            "spill_restages": self.spill_restages,
            "spill_restaged_bits": self.spill_restaged_bits,
            "per_dimm": [p.stats() for p in self.pools],
        }
        return merged

    # -- placement -----------------------------------------------------------

    def _record(self, name: str, dimm: int, local: Placement,
                chunk_rows: Sequence[int], col_chunks: int) -> Placement:
        global_p = self._globalize(dimm, local)
        self.placements[name] = global_p
        self._local[name] = dimm
        self._grids[name] = (tuple(chunk_rows), col_chunks)
        self._lru[name] = self._seq
        self._seq += 1
        return global_p

    def _victims(self, dimm_order: Sequence[int]) -> list:
        """Retirement candidates on the candidate DIMMs, LRU-first."""
        pool_set = set(dimm_order)
        cands = [n for n, d in self._local.items()
                 if d in pool_set and not self.placements[n].pinned]
        return sorted(cands, key=self._lru.get)

    def place(self, name: str, chunk_rows: Sequence[int], col_chunks: int,
              replace: bool = False, on_full: str = "raise",
              dimm: Optional[int] = None) -> Placement:
        """Assign a layer a persistent home on one member DIMM.

        The rotating DIMM cursor picks the starting module (so successive
        registrations stripe across the fabric); every module is tried in
        rotation before capacity handling kicks in. `dimm` pins the layer
        to one module. on_full adds "spill" to DramPool's
        "raise"/"evict": retire the fabric-LRU resident to the spill tier
        and retry, so registration of a model larger than the whole
        resident fabric still succeeds.
        """
        if on_full not in ("raise", "evict", "spill"):
            raise ValueError(f"on_full must be 'raise', 'evict' or "
                             f"'spill', got {on_full!r}")
        chunk_rows = list(chunk_rows)
        if name in self.placements:
            if not replace:
                prev = self.placements[name]
                raise ResidencyError(
                    f"{name!r} is already resident on dimm"
                    f"{self._local[name]} ({prev.resident_rows} rows); "
                    f"evict() it or pass replace=True to re-register")
            self.evict(name)
            self.replacements += 1
        self._spilled.pop(name, None)   # a fresh place supersedes the tier
        if dimm is not None and not 0 <= dimm < self.dimms:
            raise ResidencyError(
                f"no such DIMM: {dimm} in a {self.dimms}-DIMM fabric")
        if dimm is not None:
            order = [dimm]
        else:
            order = [(self._dimm_cursor + k) % self.dimms
                     for k in range(self.dimms)]
        last_err: Optional[CapacityError] = None
        # each retirement round frees at least one placement, so the loop
        # is bounded by the resident count at entry
        for _attempt in range(len(self.placements) + 2):
            for d in order:
                try:
                    local = self.pools[d].place(name, chunk_rows, col_chunks,
                                                on_full="raise")
                except CapacityError as e:
                    last_err = e
                    continue
                if dimm is None:
                    self._dimm_cursor = (d + 1) % self.dimms
                return self._record(name, d, local, chunk_rows, col_chunks)
            if on_full == "raise":
                break
            victims = self._victims(order)
            if not victims:
                break
            if on_full == "evict":
                self.evict(victims[0])
                self.evictions += 1
            else:
                self.spill(victims[0])
        need = requested_rows(chunk_rows, col_chunks)
        raise CapacityError(
            f"fabric cannot place {name!r}: {need} rows requested, "
            f"{self.free_rows} free across {self.dimms} DIMM(s) "
            f"[{self._occupancy_str()}]"
            + (f"; last per-bank shortfall: {last_err}" if last_err else ""))

    def evict(self, name: str) -> Placement:
        """Retire a resident placement (owners notified via the forwarded
        member `evict_listeners`). A spilled-only name is removed from the
        tier without an owner notification — it was already evicted when
        it spilled."""
        if name in self._local:
            d = self._local[name]
            global_p = self.placements[name]
            self.pools[d].evict(name)    # forwarder pops fabric dicts
            return global_p
        if name in self._spilled:
            self._spilled.pop(name)
            self._grids.pop(name, None)
            return None
        raise ResidencyError(
            f"{name!r} is not resident on the fabric "
            f"({len(self.placements)} resident placement(s), "
            f"{len(self._spilled)} spilled, {self.free_rows}/"
            f"{self.total_rows} rows free)")

    def touch(self, name: str) -> None:
        if name in self._local:
            self.pools[self._local[name]].touch(name)
            self._lru[name] = self._seq
            self._seq += 1

    def is_resident(self, name: str) -> bool:
        return name in self.placements

    # -- spill tier ----------------------------------------------------------

    def is_spilled(self, name: str) -> bool:
        return name in self._spilled

    def spilled(self) -> list:
        return sorted(self._spilled)

    def spill_entry(self, name: str) -> Optional[SpillEntry]:
        return self._spilled.get(name)

    def spill(self, name: str) -> SpillEntry:
        """Retire a resident layer to the capacity tier. The DRAM rows are
        freed (owners see a normal eviction and drop staged state); the
        entry keeps the grid and staging bits `restage()` pages back."""
        if name not in self._local:
            raise ResidencyError(
                f"cannot spill {name!r}: not resident "
                f"({len(self.placements)} resident placement(s))")
        global_p = self.placements[name]
        if global_p.pinned:
            raise ResidencyError(
                f"cannot spill pinned placement {name!r} "
                f"({global_p.resident_rows} rows)")
        chunk_rows, col_chunks = self._grids[name]
        entry = SpillEntry(name=name, bits=global_p.staged.host_bits_written,
                           chunk_rows=chunk_rows, col_chunks=col_chunks)
        self.pools[self._local[name]].evict(name)
        self._spilled[name] = entry
        self.spills += 1
        return entry

    def restage(self, name: str, on_full: str = "spill") -> Placement:
        """Page a spilled layer back into DRAM residency, spilling colder
        residents if nothing fits. The rewritten staging bits are the
        restage traffic `CxlModel` prices in `price_program`."""
        entry = self._spilled.get(name)
        if entry is None:
            raise ResidencyError(
                f"{name!r} is not in the spill tier "
                f"({len(self._spilled)} spilled entr(ies): "
                f"{self.spilled()})")
        placement = self.place(name, list(entry.chunk_rows),
                               entry.col_chunks, on_full=on_full)
        self.spill_restages += 1
        self.spill_restaged_bits += placement.staged.host_bits_written
        return placement

    def spill_ledger(self) -> tuple:
        """(spill_restaged_bits, spill_restages) snapshot — the page-in
        traffic counters a caller diffs around a decode step to attribute
        that step's CXL traffic (`FabricReport.part_spill_bits` does this
        per part; `timing.price_program` prices the bits into
        `t_spill_restage` and, per command, `e_spill`)."""
        return (self.spill_restaged_bits, self.spill_restages)

    # -- bank health ---------------------------------------------------------

    def _split_channel(self, channel: int) -> tuple:
        dimm, local = divmod(channel, self.geom.channels)
        if not 0 <= dimm < self.dimms:
            raise ResidencyError(
                f"no such bank: global channel {channel} in a "
                f"{self.dimms}-DIMM fabric of "
                f"{self.geom.channels}-channel modules "
                f"(valid range 0..{self.dimms * self.geom.channels - 1})")
        return dimm, local

    def is_quarantined(self, channel: int, bank: int) -> bool:
        try:
            dimm, local = self._split_channel(channel)
        except ResidencyError:
            return False
        return self.pools[dimm].is_quarantined(local, bank)

    def quarantined(self) -> list:
        out = []
        for d, pool in enumerate(self.pools):
            off = d * self.geom.channels
            out.extend((c + off, b) for c, b in pool.quarantined())
        return sorted(out)

    def quarantine_bank(self, channel: int, bank: int) -> list:
        dimm, local = self._split_channel(channel)
        return self.pools[dimm].quarantine_bank(local, bank)

    # -- cross-DIMM rebalancing ----------------------------------------------

    def _healthy_rows(self, dimm: int) -> int:
        pool = self.pools[dimm]
        healthy = pool.geom.banks - len(pool.quarantined())
        return pool.bank_capacity * healthy

    def _healthy_utilization(self, dimm: int) -> float:
        cap = self._healthy_rows(dimm)
        return self.pools[dimm].used_rows / cap if cap > 0 else float("inf")

    def _migrate(self, name: str, dst: int) -> bool:
        """Move one whole placement to DIMM `dst` through the move_listener
        contract (owners restage exactly as for an intra-bank compaction
        move). Returns False — with the placement back on its source DIMM —
        if the destination rejects it after all."""
        src = self._local[name]
        if dst == src:
            return False
        chunk_rows, col_chunks = self._grids[name]
        old_g = self.placements[name]
        old_lru = self._lru.get(name)
        # land on the destination FIRST: member pools are independent, so
        # the name transiently exists on both and a destination rejection
        # leaves the fabric exactly as it was (no rollback to get wrong)
        try:
            local = self.pools[dst].place(name, list(chunk_rows),
                                          col_chunks, on_full="raise")
        except CapacityError:
            return False
        self._migrating.add(name)
        try:
            self.pools[src].evict(name)   # forwarder pops fabric dicts
        finally:
            self._migrating.discard(name)
        new_g = self._record(name, dst, local, chunk_rows, col_chunks)
        if old_lru is not None:       # migration is not a use: keep LRU age
            self._lru[name] = old_lru
        # physically moved rows must be rewritten at the new module —
        # notify owners so they restage lazily, like a compaction move
        self.migrations += 1
        self.migrated_bits += old_g.staged.host_bits_written
        for fn in self.move_listeners:
            fn(name, old_g, new_g)
        return True

    def rebalance(self, max_spread: float = 0.25) -> dict:
        """Cross-DIMM defragmentation: while the healthy-capacity
        utilization spread between the hottest and coldest module exceeds
        `max_spread`, migrate the hottest module's LRU placement to the
        coldest one (feasibility-probed first, pins never move). Run by
        `compact()` so eviction churn, quarantine storms and spill paging
        drift back toward an even stripe."""
        migrated = []
        if self.dimms < 2:
            return {"migrated": migrated}
        for _round in range(len(self.placements) + 1):
            utils = [self._healthy_utilization(d) for d in range(self.dimms)]
            hot = max(range(self.dimms), key=utils.__getitem__)
            cold = min(range(self.dimms), key=utils.__getitem__)
            spread = utils[hot] - utils[cold]
            if spread <= max_spread:
                break
            moved = False
            for name in self._victims([hot]):
                chunk_rows, col_chunks = self._grids[name]
                if not self.pools[cold].can_place(chunk_rows, col_chunks):
                    continue
                # moving must strictly shrink the hot-cold gap: migration
                # keeps the LRU age, so without this an oversized tenant
                # ping-pongs between two near-even modules (each hop
                # rewriting its staged bits) until the round bound
                cap_h, cap_c = (self._healthy_rows(hot),
                                self._healthy_rows(cold))
                if cap_h > 0 and cap_c > 0:
                    rows = requested_rows(chunk_rows, col_chunks)
                    gap = abs((utils[hot] - rows / cap_h)
                              - (utils[cold] + rows / cap_c))
                    if gap >= spread:
                        continue
                if self._migrate(name, cold):
                    migrated.append(name)
                    moved = True
                    break
            if not moved:
                break
        return {"migrated": migrated}

    def compact(self) -> dict:
        """Per-bank defragmentation on every member, then cross-DIMM
        rebalancing. Returns the merged {"moved", "freed_gaps",
        "migrated"} so `ServeEngine`'s CapacityError retry sees both
        levels at once."""
        moved = 0
        freed = 0
        for pool in self.pools:
            r = pool.compact()
            moved += r["moved"]
            freed += r["freed_gaps"]
        reb = self.rebalance()
        self.compactions += 1
        return {"moved": moved, "freed_gaps": freed,
                "migrated": len(reb["migrated"])}

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        return (f"FabricPool(dimms={self.dimms}, "
                f"resident={len(self.placements)}, "
                f"spilled={len(self._spilled)}, "
                f"rows={self.used_rows}/{self.total_rows})")
