"""Command-level timing + energy model for PUD GeMV, and analytic
processor baselines (port of the JAX package's `core/pud/timing.py`;
plain Python floats in the same order, so every price equals the JAX
package's exactly).

The repro band for this paper is "no DDR4+FPGA testbed available": the PUD
path is therefore *modeled*, with the model's free constants calibrated to
the paper's own measured endpoints and every anchor documented here:

  A1 (Fig. 12, q=2/p=1):  in-DRAM compute of a 32000×4096 GeMV = 0.14 ms and
      host aggregation = 0.05 ms (total 0.19 ms) on 4× DDR4-2400 modules.
  A2 (Fig. 12):           CPU (i7-9700K + DDR4-2400 77 GB/s) = 1.44 ms,
      GPU (Jetson Orin Nano) = 1.70 ms for the same GeMV.
  A3 (Fig. 14):           MVDRAM energy advantage 30.5× vs CPU, 8.87× vs GPU
      at q=2/p=1 ⇒ CPU ≈ 60 W package, GPU ≈ 15 W, PUD op ≈ 6 nJ.

Model structure (see PudCost): a GeMV is partitioned into subarray tiles
(gemv.mvdram_gemv_cost). Tiles execute concurrently across channels × banks;
tiles beyond that run in waves. Within a bank, PUD ops (RowCopy / MAJX —
each an ACT·PRE·ACT sequence with violated timing) serialize at `t_op`.
The per-channel command bus can issue one fused AAP sequence per `t_cmd`;
whichever constraint is tighter bounds the compute phase. Output aggregation
streams accumulator rows over the DDR data bus at `agg_bw`. Command encoding
(O(N·p) on one host core) overlaps execution (paper §V-E) and only its
non-overlapped remainder is charged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .device import OpCounts, _COUNT_FIELDS
from .gemv import GemvCost, PudGeometry
from .schedule import ProgramSchedule


# ---------------------------------------------------------------------------
# Hardware constant sets
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DDR4Model:
    """DDR4-2400, 4 modules driven by DRAM Bender (paper §VII)."""

    t_op: float = 9.25e-9        # s per PUD op in a bank (violated ACT·PRE·ACT
    #                              ≈ 11 tCK incl. recovery; calibrated to A1)
    t_cmd: float = 0.833e-9      # s per command-bus slot (1 tCK @ 1200 MHz)
    agg_bw: float = 47e9         # B/s effective readout over 4 channels (A1:
    #                              0.05 ms for ~2.4 MB of accumulator rows)
    host_encode_rate: float = 1e9  # activation bits scanned / s (§V-E)
    e_op: float = 4.75e-9         # J per PUD op: one ~65k-cell row activation
    #                              pair (calibrated to A3)
    e_bit_io: float = 15e-12     # J per DRAM↔host bit over the DDR bus
    e_host_op: float = 0.1e-9    # J per host integer op during aggregation
    idle_power: float = 0.5      # W — FPGA controller active power during in-DRAM


@dataclasses.dataclass(frozen=True)
class CpuBaseline:
    """i7-9700K + DDR4-2400 running ggml-style quantized GeMV (Table II).

    Low-bit GeMV on CPU is memory-bound but does NOT reach the 77 GB/s pin
    bandwidth: dequant-and-dot of packed codes sustains ~23 GB/s effective
    (A2: 32000×4096 2-bit in 1.44 ms ⇒ 22.8 GB/s).
    """

    eff_bw: float = 22.8e9       # B/s effective on packed low-bit weights
    eff_flops: float = 2.0e11    # int8/fp32 mixed MAC/s (8 cores AVX2)
    power: float = 60.0          # W package under GeMV load (A3)

    def gemv_time(self, m: int, n: int, q: int, p: int) -> float:
        bytes_w = m * n * q / 8 + n * max(p, 8) / 8 + m * 4
        flops = 2.0 * m * n
        return max(bytes_w / self.eff_bw, flops / self.eff_flops)

    def gemv_energy(self, m: int, n: int, q: int, p: int) -> float:
        return self.power * self.gemv_time(m, n, q, p)


@dataclasses.dataclass(frozen=True)
class GpuBaseline:
    """Jetson Orin Nano (LPDDR5 68 GB/s) (Table II).

    Slightly slower than the desktop CPU on these GeMVs (A2) — launch
    overheads + lower effective bandwidth on low-bit codes; normalized to
    DDR4 energy per the paper's methodology.
    """

    eff_bw: float = 19.3e9       # B/s (A2: 1.70 ms on the anchor GeMV)
    eff_flops: float = 1.3e12
    power: float = 14.6          # W (A3)
    launch_overhead: float = 25e-6

    def gemv_time(self, m: int, n: int, q: int, p: int) -> float:
        bytes_w = m * n * q / 8 + n * max(p, 8) / 8 + m * 4
        flops = 2.0 * m * n
        return self.launch_overhead + max(bytes_w / self.eff_bw,
                                          flops / self.eff_flops)

    def gemv_energy(self, m, n, q, p) -> float:
        return self.power * self.gemv_time(m, n, q, p)


DDR4_2400 = DDR4Model()


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Per-COMMAND energy pricing for the executed PUD stack.

    `DDR4Model.e_op` charges one flat Joule figure per PUD op — fine for the
    analytic gemv-level formulas, but the executed path knows exactly which
    commands ran: the `BankArray` ledger records RowCopy / MAJ3 / MAJ5 /
    wider-MAJX counts per tile, and each of those is a different number of
    timing-violated activations on the command bus (RowCopy is ACT·PRE·ACT =
    2 activations + 1 precharge; a MAJX issues X activations before the
    closing precharge — frac-ops in the multi-row activation sense of
    SiDRAM/DRAM Bender). This model prices those primitives individually so
    `price_program` can reconcile `e_total` EXACTLY against the executed
    per-command ledger, including fault-retry re-bills and CXL page-in
    traffic.

    Calibration (DDR4): the A3 anchor mix for the 32000×4096 q=2/p=1 GeMV
    is 410176 RowCopies + 36864 MAJ3 + 36864 MAJ5 = 483904 PUD ops issuing
    1115264 activations (avg 2.3047 ACT/op). With `e_pre = 0.35·e_act`,
    `e_act = 1.79e-9` reproduces `DDR4Model.e_op = 4.75e-9` J/op on that
    mix to <0.1% (pinned by test), so gemv-level and per-command pricing
    tell one story at the anchor.

    The LPDDR5 point (`LPDDR5_CDPIM`) takes CD-PIM's geometry (PAPERS.md):
    LPDDR5 rows are ~4× shorter than the 65k-cell DDR4 rows and run at
    lower voltage, so activation energy drops ~3×; the narrower x16 channel
    keeps per-bit I/O cheaper too.
    """

    name: str = "ddr4_2400"
    e_act: float = 1.79e-9       # J per (timing-violated) row activation
    e_pre: float = 0.6265e-9     # J per precharge closing an op sequence
    e_bit_io: float = 15e-12     # J per DRAM<->host bit (readout / encode IO)
    e_host_op: float = 0.1e-9    # J per host integer op during aggregation
    idle_power: float = 0.5      # W controller active power during in-DRAM

    # One PUD op = <activations>·e_act + one closing precharge.
    @property
    def e_row_copy(self) -> float:
        return 2 * self.e_act + self.e_pre

    @property
    def e_maj3(self) -> float:
        return 3 * self.e_act + self.e_pre

    @property
    def e_maj5(self) -> float:
        return 5 * self.e_act + self.e_pre

    @property
    def e_majx_other(self) -> float:
        return 7 * self.e_act + self.e_pre

    def pud_energy(self, counts: OpCounts) -> float:
        """Joules of the in-DRAM commands in an `OpCounts` ledger slice."""
        return (counts.row_copy * self.e_row_copy
                + counts.maj3 * self.e_maj3
                + counts.maj5 * self.e_maj5
                + counts.majx_other * self.e_majx_other)

    def io_energy(self, bits: int) -> float:
        """Joules of `bits` crossing the DRAM<->host data bus."""
        return bits * self.e_bit_io

    def host_energy(self, int_ops: int) -> float:
        """Joules of `int_ops` host integer operations."""
        return int_ops * self.e_host_op

    def ledger_energy(self, counts: OpCounts) -> float:
        """Full Joules of one ledger slice: PUD commands + its recorded
        readout/write bits + its host integer ops. This is what a fault
        retry re-bills — the wave segment re-runs end to end."""
        return (self.pud_energy(counts)
                + self.io_energy(counts.host_bits_read
                                 + counts.host_bits_written)
                + self.host_energy(counts.host_int_ops))

    @classmethod
    def zero(cls) -> "EnergyModel":
        """An inert model: every per-command cost is zero, so every priced
        `e_*` term is exactly 0.0 (the `FaultModel.none()` pattern —
        provably no effect on timing, tested)."""
        return cls(name="inert", e_act=0.0, e_pre=0.0, e_bit_io=0.0,
                   e_host_op=0.0, idle_power=0.0)


DDR4_ENERGY = EnergyModel()

LPDDR5_CDPIM = EnergyModel(
    name="lpddr5_cdpim", e_act=0.62e-9, e_pre=0.22e-9, e_bit_io=4e-12,
    e_host_op=0.08e-9, idle_power=0.3)


@dataclasses.dataclass(frozen=True)
class CxlModel:
    """CXL-attached capacity tier behind the DRAM fabric's spill path.

    Cold layers parked in the tier pay nothing while parked; paging one
    back into DIMM residency rewrites its staged bit-planes through the
    CXL link (Sangam's chiplet scale-out attaches exactly this kind of
    far-memory pool, PAPERS.md). Bandwidth is the sustained far-memory
    read a x8 CXL 2.0 device delivers into a host-driven row rewrite;
    latency is the per-page-in protocol round trip.
    """

    restage_bw: float = 12e9     # B/s sustained tier -> DIMM rewrite
    latency: float = 600e-9      # s protocol round trip per page-in

    def restage_time(self, bits: int, restages: Optional[int] = None
                     ) -> float:
        """Seconds to page `bits` of staged rows back in over `restages`
        separate page-ins (default: one if there is anything to move)."""
        if bits < 0 or (restages is not None and restages < 0):
            raise ValueError(
                f"negative restage traffic: bits={bits}, "
                f"restages={restages}")
        if restages is None:
            restages = 1 if bits else 0
        return restages * self.latency + (bits / 8) / self.restage_bw


CXL_TIER = CxlModel()


@dataclasses.dataclass(frozen=True)
class H100:
    """Per-device roofline constants of the card the port runs on, an
    NVIDIA H100 SXM, for the dry-run (`launch/dryrun.py`). The JAX
    package prices its dry-run on the chip it targets (its `TpuV5e`);
    that class has no twin here because the port's dry-run prices the
    port's own step on the port's own card, with the figures `PERF.md`
    uses for it: dense bf16 tensor-core peak, HBM3 rate, NVLink rate per
    direction, device memory."""

    peak_flops_bf16: float = 989e12   # FLOP/s
    hbm_bw: float = 3.35e12           # B/s
    nvlink_bw: float = 450e9          # B/s per direction
    hbm_bytes: float = 80e9           # capacity


H100_SXM = H100()


# ---------------------------------------------------------------------------
# PUD cost evaluation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PudCost:
    """Priced execution of one GeMV launch."""

    t_compute: float      # in-DRAM phase (bank/bus bound, waves serialized)
    t_aggregate: float    # accumulator-row readout + host shift-accumulate
    t_encode_extra: float # encoding time not hidden behind execution
    t_prearrange: float   # host→DRAM activation writes (conventional PUD)
    e_pud: float
    e_io: float
    e_host: float

    @property
    def t_total(self) -> float:
        return (self.t_compute + self.t_aggregate + self.t_encode_extra
                + self.t_prearrange)

    @property
    def e_total(self) -> float:
        return self.e_pud + self.e_io + self.e_host

    def asdict(self):
        d = dataclasses.asdict(self)
        d["t_total"] = self.t_total
        d["e_total"] = self.e_total
        return d


def bank_waves(tiles: int, geom: PudGeometry = PudGeometry()) -> int:
    """Serialized execution waves: tiles round-robin over channels, then over
    the banks of each channel (§VII placement, `schedule.schedule_tiles`).

    Equals ceil(tiles / geom.parallel_tiles) — the wave count the simulator
    reports in `TileReport.waves` (tested reconciliation).
    """
    tiles_per_channel = math.ceil(tiles / geom.channels)
    return math.ceil(tiles_per_channel / geom.banks_per_channel)


def simulated_wave_time(report, model: DDR4Model = DDR4_2400) -> float:
    """Bank-bound compute time from the simulator's per-wave op maxima.

    The simulated counterpart of `price_gemv`'s analytic t_bank: each wave is
    bound by its slowest bank (`TileReport.wave_max`), waves serialize. Also
    accepts a `BatchReport` — its `wave_max` entries already sum the B
    per-request command streams that time-share each bank — and a fused
    `engine.ProgramReport`, whose `wave_max` entries are the EXECUTED
    cross-layer fused waves; `price_program` reconciles its bank term
    against exactly these counts via `executed_wave_ops`. A LAYER-MAJOR
    run's ProgramReport carries no fused-wave counts and is rejected
    rather than silently priced as zero seconds.
    """
    if getattr(report, "fused", None) is False:
        raise ValueError(
            "layer-major ProgramReports have no fused-wave counts; price "
            "each reports[l].wave_max, or run the program wave-major")
    return sum(c.pud_ops for c in report.wave_max) * model.t_op


def price_gemv(cost: GemvCost, geom: PudGeometry = PudGeometry(),
               model: DDR4Model = DDR4_2400) -> PudCost:
    """Price an analytic GemvCost (MVDRAM or conventional PUD)."""
    ops_tile = cost.ops_per_tile.pud_ops
    tiles_per_channel = math.ceil(cost.tiles / geom.channels)
    # Bank-serial: waves of ops at t_op. Bus-serial: every op of every tile on
    # the channel needs one AAP slot.
    t_bank = bank_waves(cost.tiles, geom) * ops_tile * model.t_op
    t_bus = tiles_per_channel * ops_tile * model.t_cmd
    t_compute = max(t_bank, t_bus)
    t_aggregate = (cost.aggregate_bits / 8) / model.agg_bw
    t_encode = cost.encode_host_ops / model.host_encode_rate
    t_encode_extra = max(0.0, t_encode - t_compute)
    t_prearrange = (cost.vector_prearrange_bits / 8) / model.agg_bw

    rt = cost.runtime
    e_pud = rt.pud_ops * model.e_op
    e_io = (rt.host_bits_read + rt.host_bits_written
            + cost.vector_prearrange_bits) * model.e_bit_io
    e_host = (rt.host_int_ops * model.e_host_op
              + model.idle_power * t_compute)
    return PudCost(t_compute=t_compute, t_aggregate=t_aggregate,
                   t_encode_extra=t_encode_extra, t_prearrange=t_prearrange,
                   e_pud=e_pud, e_io=e_io, e_host=e_host)


# ---------------------------------------------------------------------------
# Cross-request wave sharing: batched pricing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchedPudCost:
    """Priced execution of one SHARED-WAVE batched launch of B GeMVs.

    Compute streams are data-dependent per request, so within each wave slot
    the B command streams serialize on the bank (t_compute ≈ B× a single
    pass); readout and encoding scale with B likewise. What the co-schedule
    amortizes is the per-wave WEIGHT staging: `t_weight_load` /
    `weight_load_bits` are paid ONCE for the batch, where B independent
    launches (`sequential`) each re-stage their waves' weight rows. The
    simulator's `BatchReport.shared_preload` records the same amortized
    bits (reconciled by test).
    """

    batch: int
    t_compute: float       # B per-request streams, waves serialized
    t_aggregate: float     # B accumulator readouts
    t_encode_extra: float  # non-overlapped remainder of B encodes
    t_weight_load: float   # per-wave weight staging — paid once, shared
    weight_load_bits: int  # the amortized DRAM-write traffic (once)
    e_pud: float
    e_io: float
    e_host: float
    sequential: PudCost    # what ONE independent launch costs (incl. reload)

    @property
    def t_total(self) -> float:
        return (self.t_compute + self.t_aggregate + self.t_encode_extra
                + self.t_weight_load)

    @property
    def e_total(self) -> float:
        return self.e_pud + self.e_io + self.e_host

    @property
    def t_sequential_total(self) -> float:
        """B independent launches, each re-staging its wave weights."""
        return self.batch * (self.sequential.t_total + self.t_weight_load)

    @property
    def amortization(self) -> float:
        """Shared-wave speedup over B independent passes."""
        return self.t_sequential_total / self.t_total

    def asdict(self):
        d = dataclasses.asdict(self)
        d["sequential"] = self.sequential.asdict()
        d["t_total"] = self.t_total
        d["t_sequential_total"] = self.t_sequential_total
        d["amortization"] = self.amortization
        return d


def price_gemv_batched(cost: GemvCost, batch: int,
                       geom: PudGeometry = PudGeometry(),
                       model: DDR4Model = DDR4_2400) -> BatchedPudCost:
    """Price B GeMVs co-scheduled in shared waves (`schedule.schedule_batch`).

    The per-request analytic `cost` is a single-pass `mvdram_gemv_cost`; the
    batched launch bills B× its data-dependent command stream per wave slot
    (the streams time-share the bank), B× aggregation/encoding, but exactly
    ONE staging of each wave's weight rows (`cost.weight_load_bits`) — the
    amortized AAP/write counts the simulator's `BatchReport` reports, not B
    independent passes.
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    ops_tile = cost.ops_per_tile.pud_ops
    tiles_per_channel = math.ceil(cost.tiles / geom.channels)
    t_bank = bank_waves(cost.tiles, geom) * batch * ops_tile * model.t_op
    t_bus = tiles_per_channel * batch * ops_tile * model.t_cmd
    t_compute = max(t_bank, t_bus)
    t_aggregate = batch * (cost.aggregate_bits / 8) / model.agg_bw
    t_encode = batch * cost.encode_host_ops / model.host_encode_rate
    t_encode_extra = max(0.0, t_encode - t_compute)
    t_weight_load = (cost.weight_load_bits / 8) / model.agg_bw

    rt = cost.runtime
    e_pud = batch * rt.pud_ops * model.e_op
    e_io = (batch * (rt.host_bits_read + rt.host_bits_written)
            + cost.weight_load_bits) * model.e_bit_io
    e_host = (batch * rt.host_int_ops * model.e_host_op
              + model.idle_power * t_compute)
    return BatchedPudCost(
        batch=batch, t_compute=t_compute, t_aggregate=t_aggregate,
        t_encode_extra=t_encode_extra, t_weight_load=t_weight_load,
        weight_load_bits=cost.weight_load_bits,
        e_pud=e_pud, e_io=e_io, e_host=e_host,
        sequential=price_gemv(cost, geom, model))


# ---------------------------------------------------------------------------
# Residency sessions: pricing one compiled decode program
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProgramCost:
    """Priced execution of ONE decode step through a compiled `GemvProgram`.

    Every layer's weights are RESIDENT (placed once by the `DramPool`), so
    the step pays ZERO weight staging: `t_weight_load == 0` and
    `weight_load_bits == 0`, with `staged_bits` recording the one-time
    placement traffic already paid — the simulator's resident `BatchReport`
    shows the same zero repeated staging (reconciled by test). Compute is
    priced on the FUSED cross-layer wave schedule: each global wave is bound
    by its slowest member bank (members may come from different layers),
    and each channel's command bus streams consecutive layers' templates
    back-to-back — `waves_shared` counts the rank-idle waves the
    interleaving reclaimed at concurrency-group boundaries (q/k/v, up/gate).

    `sequential` is the per-layer baseline: each GeMV launched in
    isolation, re-staging its weight rows every decode step (what the old
    per-call `register`/`gemv` API paid); `residency_speedup` is the
    end-to-end step-time ratio the resident program buys.
    """

    layers: int
    batch: int
    t_compute: float       # fused waves, bank/bus bound
    t_aggregate: float     # per-layer accumulator readouts (serialized)
    t_encode_extra: float  # encoding not hidden behind compute
    t_weight_load: float   # 0.0 — weights are resident
    weight_load_bits: int  # 0 — zero repeated staging
    staged_bits: int       # one-time placement staging (already paid)
    waves: int             # fused global wave count
    waves_shared: int      # waves reclaimed by cross-layer interleaving
    e_pud: float
    e_io: float
    e_host: float
    sequential: tuple      # (L,) per-layer isolated BatchedPudCost
    # Fault retries: EXTRA wave serializations a fault-injected run paid
    # (bounded re-execution of corrupt wave segments, `gemv` ABFT path);
    # zero on fault-free runs, so the pre-fault pricing is unchanged.
    t_retry: float = 0.0
    retry_waves: int = 0
    # Capacity-tier paging: staged bits the step rewrote paging spilled
    # layers back from the CXL tier (`FabricPool.restage`), priced by
    # `CxlModel.restage_time`; zero on all-hot steps, so resident pricing
    # is unchanged — the same separate-term pattern as `t_retry`.
    t_spill_restage: float = 0.0
    spill_restage_bits: int = 0
    spill_restages: int = 0
    # Speculative encode overlap: `t_encode` is the FULL host-side encode
    # time of the step (all layers); the pipelined timeline (layer k+1
    # encodes under layer k's waves) exposes only `t_encode_extra` of it.
    # A non-overlapped host would serialize all of `t_encode` in front of
    # compute — `encode_overlap_speedup` is what the overlap buys.
    t_encode: float = 0.0
    # The isolated-launch baseline runs the SAME causal-speculative encode
    # pipeline (launch l+1's encode under launch l's waves, `_encode_
    # timeline` over the layer-major schedule) — this is its exposed
    # stall, replacing the parts' own per-layer `max(0, e_l - c_l)`
    # charges (which let a launch consume activations before they are
    # encoded) in `t_sequential_total`, so `residency_speedup` compares
    # one encode model against itself.
    t_seq_encode_extra: float = 0.0
    # Per-command energy split-outs (EnergyModel path): retry re-bills and
    # CXL page-in bit traffic land as separate terms, the `t_retry` /
    # `t_spill_restage` pattern. Zero under the legacy flat-e_op pricing.
    e_retry: float = 0.0
    e_spill: float = 0.0

    @property
    def t_total(self) -> float:
        return (self.t_compute + self.t_aggregate + self.t_encode_extra
                + self.t_weight_load + self.t_retry
                + self.t_spill_restage)

    @property
    def e_total(self) -> float:
        return (self.e_pud + self.e_io + self.e_host
                + self.e_retry + self.e_spill)

    @property
    def t_sequential_total(self) -> float:
        """One decode step as L isolated launches, each re-staging —
        encode exposure priced by the same causal pipeline as `t_total`'s
        (`t_seq_encode_extra`), not the parts' own intra-layer hiding."""
        return (sum(c.t_total - c.t_encode_extra for c in self.sequential)
                + self.t_seq_encode_extra)

    @property
    def residency_speedup(self) -> float:
        return self.t_sequential_total / self.t_total

    @property
    def encode_overlap_speedup(self) -> float:
        """Step time with encode fully serialized ahead of compute, over
        the pipelined step time (only the non-hidden remainder charged)."""
        return (self.t_total + self.t_encode
                - self.t_encode_extra) / self.t_total

    def asdict(self):
        d = dataclasses.asdict(self)
        d["sequential"] = [c.asdict() for c in self.sequential]
        d["t_total"] = self.t_total
        d["t_sequential_total"] = self.t_sequential_total
        d["residency_speedup"] = self.residency_speedup
        d["encode_overlap_speedup"] = self.encode_overlap_speedup
        return d


def _encode_timeline(wave_times, first_wave, encode_times) -> float:
    """End time of the speculative encode/wave pipeline.

    One host core encodes layer activations in LAYER ORDER while earlier
    layers' waves execute in the banks (the §V-E overlap, extended across
    the fused program): wave `w` cannot start until every layer whose FIRST
    scheduled wave is `w` has finished encoding. `encode_times[l]` is layer
    l's host encode time; `first_wave[l]` its earliest wave;
    `wave_times[w]` the bank time of fused wave `w`. Returns the finish
    time of the last wave — at most `sum(encode_times)` later than the
    un-stalled `sum(wave_times)`, so the exposed remainder never exceeds
    what full up-front encoding would charge.
    """
    done, d = [], 0.0
    for e in encode_times:
        d += e
        done.append(d)
    ready: dict[int, float] = {}
    for layer, w in enumerate(first_wave):
        ready[w] = max(ready.get(w, 0.0), done[layer])
    s = 0.0
    for w, t in enumerate(wave_times):
        s = max(s, ready.get(w, 0.0)) + t
    return s


def price_program(costs, sched: ProgramSchedule, batch: int = 1,
                  geom: PudGeometry = PudGeometry(),
                  model: DDR4Model = DDR4_2400,
                  executed_wave_ops=None,
                  retry_wave_ops=None,
                  spill_restage_bits: int = 0,
                  spill_restages: int = 0,
                  spill: Optional[CxlModel] = None,
                  energy: Optional[EnergyModel] = None,
                  executed_counts: Optional[OpCounts] = None,
                  retry_counts: Optional[OpCounts] = None,
                  executed_encode_ops=None) -> ProgramCost:
    """Price one decode step of a compiled program of resident GeMVs.

    costs: (L,) per-layer analytic `GemvCost` (single-pass, e.g.
    `mvdram_gemv_cost` at matching geometry); sched: the fused cross-layer
    `ProgramSchedule` from `schedule.schedule_program`.

    Bank-bound compute walks the FUSED waves (max member ops per wave,
    serialized); bus-bound compute sums each channel's command slots over
    the whole program (cross-layer interleaving — no staging traffic
    competes for the bus). Weight staging is zero; the per-layer
    `sequential` baseline re-prices each layer as an isolated
    `price_gemv_batched` launch (staging included) for the residency
    speedup the nightly floor guards.

    `executed_wave_ops` — (waves,) PUD op counts per EXECUTED fused wave
    (the per-wave maxima of a wave-major simulator run, B lanes already
    summed; `engine.ProgramReport.executed_wave_ops`) — replaces the
    analytic bank-serialization estimate with the measurement, after
    checking that execution ran exactly the waves this schedule fused. At
    dense activation bits and non-ragged grids the two are equal (tested).

    `retry_wave_ops` — PUD op counts of the EXTRA waves fault retries cost
    (one entry per re-executed wave segment, B lanes summed;
    `gemv.ProgramRunResult.retry_wave_ops`) — lands as a separate `t_retry`
    term so fault-storm overhead is visible next to, not folded into, the
    scheduled compute time. The base wave-count validation is unchanged:
    retries are extras on top of the schedule's waves, not members of it.

    `spill_restage_bits` / `spill_restages` — staged bits (and page-in
    count) this step rewrote bringing spilled layers back from the
    capacity tier (`FabricPool.restage`); priced by `spill`
    (a `CxlModel`, required when the traffic is non-zero) into the
    separate `t_spill_restage` term, exactly the `t_retry` pattern —
    all-hot steps price unchanged.

    Encoding is priced as a PIPELINE, not a lump: the host encodes layer
    k+1's activations while layer k's waves execute (`_encode_timeline`),
    so only the stall the timeline actually exposes past `t_compute`
    lands in `t_encode_extra` — the executor runs the same just-in-time
    per-layer encode order, making this term a measurement of the real
    overlap rather than the old whole-step `max(0, t_encode - t_compute)`
    bound (which it never exceeds). `executed_encode_ops` — (L,) per-layer
    host encode ops the run actually performed (active lanes only;
    `engine.ProgramReport.encode_ops`) — replaces the analytic
    `batch × encode_host_ops` estimate in both `t_encode` and the
    timeline.

    `energy` switches the `e_*` terms from the flat `DDR4Model.e_op`
    estimate to per-command pricing: with `executed_counts` (the run's
    complete `OpCounts` ledger, retries included) and `retry_counts` (the
    slice fault retries re-billed), `e_pud`/`e_io`/`e_host` price the
    fault-free base ledger, `e_retry` prices the retry slice end to end
    (`EnergyModel.ledger_energy`), and `e_spill` prices CXL page-in bit
    traffic — summing EXACTLY to the energy of everything the banks
    recorded (reconciled bit-for-bit by test and bench). Without executed
    counts the same per-command weights price the analytic per-layer
    ledgers. `energy=None` keeps the legacy flat pricing unchanged.
    """
    costs = list(costs)
    if len(costs) != sched.layers:
        raise ValueError(
            f"{len(costs)} layer costs for a {sched.layers}-layer schedule")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    ops = [c.ops_per_tile.pud_ops for c in costs]
    wave_ops: dict[int, int] = {}
    chan_ops = [0] * geom.channels
    first_wave = [sched.waves] * len(costs)
    for s in sched.slots:
        wave_ops[s.wave] = max(wave_ops.get(s.wave, 0), ops[s.layer])
        chan_ops[s.channel] += ops[s.layer]
        first_wave[s.layer] = min(first_wave[s.layer], s.wave)
    if executed_wave_ops is not None:
        executed_wave_ops = list(executed_wave_ops)
        if len(executed_wave_ops) != sched.waves:
            raise ValueError(
                f"execution ran {len(executed_wave_ops)} fused waves for a "
                f"{sched.waves}-wave schedule — the executed program does "
                f"not match the schedule being priced")
        wave_times = [float(w) * model.t_op for w in executed_wave_ops]
        t_bank = float(sum(executed_wave_ops)) * model.t_op
    else:
        wave_times = [batch * wave_ops.get(w, 0) * model.t_op
                      for w in range(sched.waves)]
        t_bank = batch * sum(wave_ops.values()) * model.t_op
    t_bus = batch * max(chan_ops) * model.t_cmd if sched.slots else 0.0
    t_compute = max(t_bank, t_bus)
    t_aggregate = batch * sum(c.aggregate_bits for c in costs) / 8 \
        / model.agg_bw
    if executed_encode_ops is not None:
        executed_encode_ops = list(executed_encode_ops)
        if len(executed_encode_ops) != len(costs):
            raise ValueError(
                f"{len(executed_encode_ops)} per-layer encode op counts "
                f"for a {len(costs)}-layer program")
        encode_times = [float(e) / model.host_encode_rate
                        for e in executed_encode_ops]
    else:
        encode_times = [batch * c.encode_host_ops / model.host_encode_rate
                        for c in costs]
    t_encode = sum(encode_times)
    timeline = _encode_timeline(wave_times, first_wave, encode_times)
    t_encode_extra = max(0.0, timeline - t_compute)
    # the isolated-launch baseline under the SAME causal-speculative
    # pipeline: launch l is one big "wave" and launch l+1's encode runs
    # under it — its exposed stall replaces the parts' per-layer encode
    # charges inside `t_sequential_total`
    seq = tuple(price_gemv_batched(c, batch, geom, model) for c in costs)
    seq_waves = [c.t_compute for c in seq]
    seq_timeline = _encode_timeline(seq_waves, list(range(len(seq))),
                                    encode_times)
    t_seq_encode_extra = max(0.0, seq_timeline - sum(seq_waves))

    if energy is None:
        e_pud = batch * sum(c.runtime.pud_ops for c in costs) * model.e_op
        e_io = batch * sum(c.runtime.host_bits_read
                           + c.runtime.host_bits_written
                           for c in costs) * model.e_bit_io
        e_host = (batch * sum(c.runtime.host_int_ops for c in costs)
                  * model.e_host_op + model.idle_power * t_compute)
        e_retry = 0.0
        e_spill = 0.0
    elif executed_counts is not None:
        retry_c = retry_counts if retry_counts is not None else OpCounts()
        base_c = OpCounts(*(getattr(executed_counts, f) - getattr(retry_c, f)
                            for f in _COUNT_FIELDS))
        for f in _COUNT_FIELDS:
            if getattr(base_c, f) < 0:
                raise ValueError(
                    f"retry ledger exceeds the executed total on {f}: "
                    f"{getattr(retry_c, f)} > {getattr(executed_counts, f)}")
        e_pud = energy.pud_energy(base_c)
        e_io = energy.io_energy(base_c.host_bits_read
                                + base_c.host_bits_written)
        e_host = (energy.host_energy(base_c.host_int_ops)
                  + energy.idle_power * t_compute)
        e_retry = energy.ledger_energy(retry_c)
        e_spill = energy.io_energy(spill_restage_bits)
    else:
        e_pud = batch * sum(energy.pud_energy(c.runtime) for c in costs)
        e_io = energy.io_energy(
            batch * sum(c.runtime.host_bits_read + c.runtime.host_bits_written
                        for c in costs))
        e_host = (energy.host_energy(
            batch * sum(c.runtime.host_int_ops for c in costs))
            + energy.idle_power * t_compute)
        e_retry = 0.0
        e_spill = energy.io_energy(spill_restage_bits)
    retry_wave_ops = list(retry_wave_ops) if retry_wave_ops else []
    t_retry = float(sum(retry_wave_ops)) * model.t_op
    if spill_restage_bits or spill_restages:
        if spill is None:
            raise ValueError(
                f"spill_restage_bits={spill_restage_bits} "
                f"(restages={spill_restages}) needs a CxlModel to price "
                f"the tier traffic — pass spill=")
        t_spill = spill.restage_time(spill_restage_bits, spill_restages)
    else:
        t_spill = 0.0
    return ProgramCost(
        layers=len(costs), batch=batch,
        t_compute=t_compute, t_aggregate=t_aggregate,
        t_encode_extra=t_encode_extra,
        t_weight_load=0.0, weight_load_bits=0,
        staged_bits=sum(c.weight_load_bits for c in costs),
        waves=sched.waves, waves_shared=sched.waves_shared,
        e_pud=e_pud, e_io=e_io, e_host=e_host,
        sequential=seq,
        t_retry=t_retry, retry_waves=len(retry_wave_ops),
        t_spill_restage=t_spill, spill_restage_bits=spill_restage_bits,
        spill_restages=spill_restages,
        t_encode=t_encode, t_seq_encode_extra=t_seq_encode_extra,
        e_retry=e_retry, e_spill=e_spill)


# ---------------------------------------------------------------------------
# Fabric sessions: pricing one decode step across multiple DIMM parts
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FabricCost:
    """Priced execution of one decode step of a `FabricProgram`.

    Each part is a per-DIMM `ProgramCost`; modules execute their parts'
    waves INDEPENDENTLY (separate command buses, separate banks — the §VII
    wave parallelism extended across modules), so fused compute overlaps:
    `t_compute` is the max over DIMMs of each module's summed part
    compute, plus any part whose home module is unknown (a spilled part
    priced before paging) serialized on top. Host-side terms — accumulator
    readout, non-overlapped encoding, fault retries, CXL restage traffic —
    share one host and SUM across parts.
    """

    dimms: int
    batch: int
    parts: tuple          # per-part ProgramCost
    part_dimms: tuple     # home DIMM per part (None → serialized)
    t_compute: float      # overlapped across modules
    t_aggregate: float
    t_encode_extra: float
    t_retry: float
    t_spill_restage: float
    spill_restage_bits: int
    spill_restages: int
    staged_bits: int
    waves: int
    waves_shared: int
    e_pud: float
    e_io: float
    e_host: float
    t_encode: float = 0.0
    e_retry: float = 0.0
    e_spill: float = 0.0

    @property
    def layers(self) -> int:
        return sum(c.layers for c in self.parts)

    @property
    def t_total(self) -> float:
        return (self.t_compute + self.t_aggregate + self.t_encode_extra
                + self.t_retry + self.t_spill_restage)

    @property
    def e_total(self) -> float:
        return (self.e_pud + self.e_io + self.e_host
                + self.e_retry + self.e_spill)

    @property
    def t_serial_compute(self) -> float:
        """Fused compute with the cross-DIMM overlap removed (every part's
        waves serialized on one module) — the single-pool contrast the
        scale-out speedup is measured against."""
        return sum(c.t_compute for c in self.parts)

    @property
    def t_serial_total(self) -> float:
        return (self.t_serial_compute + self.t_aggregate
                + self.t_encode_extra + self.t_retry
                + self.t_spill_restage)

    @property
    def scaleout_speedup(self) -> float:
        return self.t_serial_total / self.t_total

    @property
    def t_sequential_total(self) -> float:
        """Per-layer isolated launches, re-staging every step (the same
        baseline `ProgramCost.t_sequential_total` prices)."""
        return sum(c.t_sequential_total for c in self.parts)

    @property
    def residency_speedup(self) -> float:
        return self.t_sequential_total / self.t_total

    @property
    def encode_overlap_speedup(self) -> float:
        """Fabric step with every part's encode serialized up front, over
        the pipelined step (same definition as `ProgramCost`)."""
        return (self.t_total + self.t_encode
                - self.t_encode_extra) / self.t_total

    def asdict(self):
        d = dataclasses.asdict(self)
        d["parts"] = [c.asdict() for c in self.parts]
        d["part_dimms"] = list(self.part_dimms)
        d["layers"] = self.layers
        d["t_total"] = self.t_total
        d["t_serial_total"] = self.t_serial_total
        d["scaleout_speedup"] = self.scaleout_speedup
        d["t_sequential_total"] = self.t_sequential_total
        d["residency_speedup"] = self.residency_speedup
        d["encode_overlap_speedup"] = self.encode_overlap_speedup
        return d


def combine_fabric_costs(parts, part_dimms, dimms: int,
                         batch: int = 1) -> FabricCost:
    """Fold per-part `ProgramCost`s into one `FabricCost`.

    parts: per-part priced costs (from `price_program`, spill term
    included where the part paged layers in); part_dimms: the home DIMM
    of each part, or None for a part not currently resident anywhere
    (priced conservatively as serialized compute).
    """
    parts = tuple(parts)
    part_dimms = tuple(part_dimms)
    if len(parts) != len(part_dimms):
        raise ValueError(
            f"{len(parts)} part costs vs {len(part_dimms)} part DIMMs")
    if not parts:
        raise ValueError("cannot combine zero fabric parts")
    if any(c.batch != batch for c in parts):
        raise ValueError(
            f"part batches {[c.batch for c in parts]} != fabric "
            f"batch {batch}")
    for d in part_dimms:
        if d is not None and not 0 <= d < dimms:
            raise ValueError(
                f"part DIMM {d} out of range for a {dimms}-DIMM fabric")
    per_dimm: dict[int, float] = {}
    serial = 0.0
    for c, d in zip(parts, part_dimms):
        if d is None:
            serial += c.t_compute
        else:
            per_dimm[d] = per_dimm.get(d, 0.0) + c.t_compute
    t_compute = (max(per_dimm.values()) if per_dimm else 0.0) + serial
    return FabricCost(
        dimms=dimms, batch=batch, parts=parts, part_dimms=part_dimms,
        t_compute=t_compute,
        t_aggregate=sum(c.t_aggregate for c in parts),
        t_encode_extra=sum(c.t_encode_extra for c in parts),
        t_retry=sum(c.t_retry for c in parts),
        t_spill_restage=sum(c.t_spill_restage for c in parts),
        spill_restage_bits=sum(c.spill_restage_bits for c in parts),
        spill_restages=sum(c.spill_restages for c in parts),
        staged_bits=sum(c.staged_bits for c in parts),
        waves=sum(c.waves for c in parts),
        waves_shared=sum(c.waves_shared for c in parts),
        e_pud=sum(c.e_pud for c in parts),
        e_io=sum(c.e_io for c in parts),
        e_host=sum(c.e_host for c in parts),
        t_encode=sum(c.t_encode for c in parts),
        e_retry=sum(c.e_retry for c in parts),
        e_spill=sum(c.e_spill for c in parts))


# ---------------------------------------------------------------------------
# Convenience: full comparison row (used by benchmarks/fig12 etc.)
# ---------------------------------------------------------------------------

def compare_gemv(m: int, n: int, q: int, p: int, bit_density: float = 0.5,
                 sparsity: bool = True,
                 geom: PudGeometry = PudGeometry(),
                 model: DDR4Model = DDR4_2400,
                 cpu: CpuBaseline = CpuBaseline(),
                 gpu: GpuBaseline = GpuBaseline()) -> dict:
    from .gemv import conventional_pud_cost, mvdram_gemv_cost

    mv = price_gemv(mvdram_gemv_cost(m, n, q, p, bit_density, sparsity, geom),
                    geom, model)
    conv = price_gemv(conventional_pud_cost(m, n, q, p, bit_density, geom),
                      geom, model)
    t_cpu, e_cpu = cpu.gemv_time(m, n, q, p), cpu.gemv_energy(m, n, q, p)
    t_gpu, e_gpu = gpu.gemv_time(m, n, q, p), gpu.gemv_energy(m, n, q, p)
    return {
        "m": m, "n": n, "q": q, "p": p,
        "mvdram_ms": mv.t_total * 1e3,
        "mvdram_compute_ms": mv.t_compute * 1e3,
        "mvdram_aggregate_ms": mv.t_aggregate * 1e3,
        "conventional_pud_ms": conv.t_total * 1e3,
        "conventional_prearrange_ms": conv.t_prearrange * 1e3,
        "cpu_ms": t_cpu * 1e3, "gpu_ms": t_gpu * 1e3,
        "speedup_vs_cpu": t_cpu / mv.t_total,
        "speedup_vs_gpu": t_gpu / mv.t_total,
        "mvdram_mj": mv.e_total * 1e3, "cpu_mj": e_cpu * 1e3,
        "gpu_mj": e_gpu * 1e3,
        "energy_ratio_vs_cpu": e_cpu / mv.e_total,
        "energy_ratio_vs_gpu": e_gpu / mv.e_total,
    }
