"""Tile placement + wave scheduling across channels and banks (paper §VII).

Port of the JAX package's `core/pud/schedule.py` (plain Python, no JAX).

A GeMV is partitioned into (reduction_chunk, column_chunk) subarray tiles
(`gemv.mvdram_gemv`). The DRAM rank executes `channels × banks_per_channel`
subarrays concurrently; tiles beyond that capacity serialize in WAVES. This
module owns the static placement:

  tile t  →  channel  t mod C,  bank  (t div C) mod B,  wave  t div (C·B)

i.e. round-robin over channels first (each channel has its own command bus),
then over the banks of a channel, matching the §VII experimental setup of
4 DDR4 modules × 16 concurrently-computing subarrays each. The wave count
equals `timing.bank_waves` — the same ceil-division the analytic price model
bills compute with — so simulated and analytic wave accounting reconcile
(tested).

`PudGeometry` lives here (the placement resources ARE the geometry);
`gemv.py` re-exports it for compatibility.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PudGeometry:
    """Physical resources available to one GeMV launch.

    `subarray_cols` is the simulated width (kept small for tractability);
    `real_cols` is the physical bitline count used by the cost model
    (65,536 across the chips of a DDR4 rank, paper §II-B).
    `subarrays_per_bank` bounds RESIDENCY capacity (`residency.DramPool`):
    a bank computes in one subarray at a time (§VII), but weight rows of
    other layers stay parked in its sibling subarrays — a DDR4 bank's 64K
    rows hold 128 subarrays of 512.

    Frozen AND validated: instances are hashable, so a geometry can key the
    backend/template caches directly, and every dimension must be a positive
    int — a zero channel count or negative row budget fails at construction
    with a clear ValueError instead of corrupting downstream placement math.
    """

    subarray_rows: int = 512
    subarray_cols: int = 1024
    real_cols: int = 65536
    n_sub_max: int = 128          # paper §VII: N ≤ 128 per subarray
    channels: int = 4             # four DDR4 modules (paper §VII)
    banks_per_channel: int = 16   # concurrently computing subarrays / channel
    subarrays_per_bank: int = 128  # residency capacity per bank (§II-B)

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                raise ValueError(
                    f"PudGeometry.{f.name} must be a positive int, got {v!r}")

    @property
    def parallel_tiles(self) -> int:
        return self.channels * self.banks_per_channel

    @property
    def banks(self) -> int:
        """All (channel, bank) slots of the rank — the residency pool's
        row-space is partitioned across these."""
        return self.channels * self.banks_per_channel

    @property
    def bank_rows(self) -> int:
        """Rows one bank can park (compute + resident weights)."""
        return self.subarrays_per_bank * self.subarray_rows


@dataclasses.dataclass(frozen=True)
class TileAssignment:
    """One tile's slot in the rank: which subarray computes it, and when."""

    tile: int        # linear index: chunk * col_chunks + col_chunk
    chunk: int       # reduction chunk (rows j0..j1 of the matrix)
    col_chunk: int   # column chunk (outputs m0..m1)
    channel: int
    bank: int
    wave: int


@dataclasses.dataclass(frozen=True)
class WaveSchedule:
    """Static placement of all tiles of one GeMV onto (channel, bank, wave)."""

    n_chunks: int
    col_chunks: int
    geom: PudGeometry
    assignments: tuple  # (tiles,) TileAssignment, in tile order

    @property
    def tiles(self) -> int:
        return self.n_chunks * self.col_chunks

    @property
    def waves(self) -> int:
        return math.ceil(self.tiles / self.geom.parallel_tiles)

    def wave_members(self, wave: int) -> tuple:
        lo = wave * self.geom.parallel_tiles
        hi = min(lo + self.geom.parallel_tiles, self.tiles)
        return self.assignments[lo:hi]


def schedule_tiles(n_chunks: int, col_chunks: int,
                   geom: PudGeometry) -> WaveSchedule:
    """Round-robin §VII placement; tile order is chunk-major (the same order
    the sequential oracle executes, so per-tile results line up 1:1)."""
    asg = []
    for t in range(n_chunks * col_chunks):
        ci, mi = divmod(t, col_chunks)
        slot = t // geom.channels
        asg.append(TileAssignment(
            tile=t, chunk=ci, col_chunk=mi,
            channel=t % geom.channels,
            bank=slot % geom.banks_per_channel,
            wave=slot // geom.banks_per_channel))
    return WaveSchedule(n_chunks=n_chunks, col_chunks=col_chunks, geom=geom,
                        assignments=tuple(asg))


# ---------------------------------------------------------------------------
# Cross-request wave sharing (reuse-aware co-scheduling, RACAM-style)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchSchedule:
    """Co-schedule of B GeMV requests against ONE registered matrix.

    Reuse-aware placement: every request partitions into the SAME
    (reduction_chunk, column_chunk) tile grid, so the B requests' instances
    of weight tile t are co-located on tile t's single (channel, bank, wave)
    slot of the base `WaveSchedule`. Within that slot the weight rows are
    loaded ONCE per wave and the B per-request command streams execute
    back-to-back against the resident rows — the batch axis shares the
    wave's RowCopy/write weight traffic instead of paying it B times, which
    is the reuse-aware mapping RACAM applies to ML inference in DRAM.

    `weight_loads` / `unshared_weight_loads` quantify the reuse: one tile
    load per slot versus one per (request, tile) if each request launched
    its own independent pass.
    """

    batch: int
    base: WaveSchedule

    @property
    def tiles(self) -> int:
        return self.base.tiles

    @property
    def waves(self) -> int:
        return self.base.waves

    @property
    def n_chunks(self) -> int:
        return self.base.n_chunks

    @property
    def col_chunks(self) -> int:
        return self.base.col_chunks

    @property
    def geom(self) -> PudGeometry:
        return self.base.geom

    def wave_members(self, wave: int) -> tuple:
        """Tiles of `wave`; each member slot serves all `batch` requests."""
        return self.base.wave_members(wave)

    @property
    def weight_loads(self) -> int:
        """Per-wave weight-tile loads under sharing: one per tile slot."""
        return self.tiles

    @property
    def unshared_weight_loads(self) -> int:
        """Loads B independent sequential passes would pay."""
        return self.batch * self.tiles

    @property
    def reuse_factor(self) -> float:
        """Weight-traffic amortization of the co-schedule (== batch)."""
        return self.unshared_weight_loads / self.weight_loads


# ---------------------------------------------------------------------------
# Cross-layer program scheduling (residency sessions: one decode step's
# sequence of resident GeMVs as a single interleaved command schedule)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProgramSlot:
    """One tile of one layer in the fused command stream."""

    layer: int       # index into the program's layer sequence
    tile: int        # layer-local linear tile index
    chunk: int
    col_chunk: int
    channel: int
    bank: int
    wave: int        # GLOBAL wave index, fused across layers


@dataclasses.dataclass(frozen=True)
class ProgramSchedule:
    """Wave slots extended across the layers of one decode step.

    The per-layer §VII placement stays what `schedule_tiles` computes for a
    solo launch; what fuses is the WAVE axis: layers in the same concurrency
    `group` (independent GeMVs on the same input — q/k/v, up/gate) pack
    their tiles into shared waves greedily (one tile per (channel, bank)
    per wave), and a group boundary — a data dependency — flushes to a
    fresh wave. `waves` is therefore ≤ the Σ of per-layer solo wave counts;
    `waves_shared` is the rank-idle waves the fusion reclaimed, which
    `timing.price_program` turns into compute time (cross-layer command-bus
    interleaving: one channel's bus streams consecutive layers' command
    templates back-to-back with no staging traffic in between).
    """

    geom: PudGeometry
    layer_tiles: tuple       # (L,) tiles per layer
    groups: tuple            # concurrency groups: tuples of layer indices
    slots: tuple             # (Σ tiles,) ProgramSlot, global issue order

    @property
    def layers(self) -> int:
        return len(self.layer_tiles)

    @property
    def tiles(self) -> int:
        return len(self.slots)

    @property
    def waves(self) -> int:
        return (self.slots[-1].wave + 1) if self.slots else 0

    @property
    def waves_unfused(self) -> int:
        """Σ of per-layer solo wave counts (no cross-layer sharing)."""
        return sum(math.ceil(t / self.geom.parallel_tiles)
                   for t in self.layer_tiles)

    @property
    def waves_shared(self) -> int:
        return self.waves_unfused - self.waves

    def wave_members(self, wave: int) -> tuple:
        return tuple(s for s in self.slots if s.wave == wave)

    def layer_slots(self, layer: int) -> tuple:
        return tuple(s for s in self.slots if s.layer == layer)


def schedule_program(grids, geom: PudGeometry,
                     groups=None, placements=None) -> ProgramSchedule:
    """Fuse L layers' tile grids into one interleaved wave schedule.

    grids:      (L,) of (n_chunks, col_chunks).
    groups:     concurrency groups as iterables of layer indices, in
                execution order; layers inside a group are independent and
                may share waves. Default: every layer its own group (purely
                sequential — still zero re-staging, no wave sharing).
    placements: optional (L,) of per-tile (channel, bank) sequences (e.g.
                from `residency.Placement.banks`); defaults to the
                residency pool's CONTINUING §VII round-robin — the bank
                cursor rotates across layers, so co-scheduled group
                members stagger over the rank instead of colliding on
                bank (0, 0).

    Packing is greedy in slot order: a tile joins the current wave unless
    its (channel, bank) is already occupied there or the wave is full; a
    group boundary always opens a fresh wave (data dependency).
    """
    grids = [tuple(g) for g in grids]
    if groups is None:
        groups = [(l,) for l in range(len(grids))]
    groups = tuple(tuple(g) for g in groups)
    seen = [l for g in groups for l in g]
    if sorted(seen) != list(range(len(grids))):
        raise ValueError(
            f"groups must partition the {len(grids)} layers exactly, "
            f"got {groups}")
    slots = []
    wave = 0
    occupied: set = set()

    def _flush():
        nonlocal wave, occupied
        if occupied:
            wave += 1
            occupied = set()

    cursor = 0
    for group in groups:
        _flush()
        for layer in group:
            n_chunks, col_chunks = grids[layer]
            tiles_l = n_chunks * col_chunks
            if placements is not None:
                banks = list(placements[layer])
            else:
                banks = [((cursor + t) % geom.channels,
                          ((cursor + t) // geom.channels)
                          % geom.banks_per_channel)
                         for t in range(tiles_l)]
                cursor = (cursor + tiles_l) % geom.parallel_tiles
            for t in range(n_chunks * col_chunks):
                cb = banks[t]
                if cb in occupied or len(occupied) >= geom.parallel_tiles:
                    wave += 1
                    occupied = set()
                occupied.add(cb)
                ci, mi = divmod(t, col_chunks)
                slots.append(ProgramSlot(
                    layer=layer, tile=t, chunk=ci, col_chunk=mi,
                    channel=cb[0], bank=cb[1], wave=wave))
    return ProgramSchedule(geom=geom,
                           layer_tiles=tuple(g[0] * g[1] for g in grids),
                           groups=groups, slots=tuple(slots))


def schedule_batch(n_chunks: int, col_chunks: int, batch: int,
                   geom: PudGeometry) -> BatchSchedule:
    """Place B requests' tile grids on one shared set of (channel, bank,
    wave) slots. The base placement is the round-robin §VII schedule — the
    reuse comes from mapping every request's tile t to the SAME slot, so the
    slot's weight rows serve the whole batch."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    return BatchSchedule(batch=batch,
                         base=schedule_tiles(n_chunks, col_chunks, geom))
