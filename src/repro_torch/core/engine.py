"""MVDRAMEngine — the system-level orchestrator (paper §IV): port of the
JAX package's `core/engine.py`, around explicit two-phase
PLACE-THEN-EXECUTE residency sessions.

Phase ① — place (`register` / `register_packed`): build the partition plan
(N ≤ 128 per subarray, q·M per column budget, §VII "Matrix Partitioning")
and give the matrix a PERSISTENT home in the DRAM geometry: the engine's
`DramPool` (or a multi-DIMM `FabricPool`) carves subarray row ranges out of
each (channel, bank) for the matrix's tiles. ALL the linears of a model
co-reside at once; the pool rotates the §VII bank cursor across
registrations so co-resident layers stagger over the rank.

Phase ② — execute: `gemv()` runs one resident GeMV through a `Backend`
(the sim backend against the handle's staged rows, `staged_for`), and
`compile([...handles...])` fuses a decode step's SEQUENCE of resident
GeMVs into one `GemvProgram` whose interleaved command schedule extends
the wave slots across layers (`pud.schedule.schedule_program`).
`GemvProgram.run` EXECUTES that fused schedule in the PUD simulator (one
batched step per global wave, against the staged rows, zero repeated
staging; `run(layer_major=True)` is the bit-exactness oracle), and
`price_program` prices one step on the DDR4 model
(`pud.timing.price_program`) — analytically, or with `executed=` against
the run's own executed wave counts and command ledger. Prices are
host-side calculations in Python floats, in the JAX package's order, so
every price equals its.

The simulator's bit state (bank rows, matrix blocks, accumulators,
partials, checksums) lives on the device of each leaf's planes; its
ledger and encoding are on the host. A `FaultModel` arms seeded MAJX fault
injection with ABFT verification, bounded wave retries and the recovery
ladder (bank quarantine → host recompute on the reference backend →
permanent degradation).

On the card, `GemvProgram.run_kernel` runs the whole decode block as ONE B2
launch (`kernels/bitplane_gemv/program.py:run_program`, the CUDA
`group_kernel` over a member table that reads every leaf in place), bitwise
equal to per-leaf B1 — the yardstick the simulator's outputs are held
against. Serving's per-linear routing (`linear`, `linear_group`,
`packed_group`, `EngineLinear`) is the port's earlier slices'.

One GeMV can also be registered column-sharded across a fabric's DIMMs
(`register_sharded`: quantized once, sliced into contiguous column-chunk
shards by `fabric.plan_column_shards`, shard d placed on DIMM d mod
dimms); `gemv_sharded` runs each shard's resident launch on the leaf's
device and scatters the disjoint columns on the host, bitwise the
unsharded launch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Optional, Sequence, Union

import numpy as np
import torch

from . import backends as _backends
from .backends import Backend
from .bitplane import BitplaneWeights, from_quantized, to_quantized
from .pud.device import _COUNT_FIELDS, OpCounts
from .pud.fabric import ColumnShardPlan, FabricPool, plan_column_shards
from .pud.faults import FaultModel, FaultPolicy, FaultTrace
from .pud.gemv import (CommandTemplates, PudGeometry, StagedWaves,
                       _lane_mask_arg, build_templates,
                       conventional_pud_cost, execute_program,
                       mvdram_gemv_batched, mvdram_gemv_cost, stage_matrix,
                       stage_program)
from .pud.residency import CapacityError, DramPool, Placement
from .pud.schedule import ProgramSchedule, schedule_batch, schedule_program
from .pud.timing import (CXL_TIER, DDR4_2400, DDR4_ENERGY, CpuBaseline,
                         CxlModel, DDR4Model, EnergyModel, FabricCost,
                         GpuBaseline, ProgramCost, combine_fabric_costs,
                         price_gemv, price_program)
from .quant import (QuantSpec, QuantizedTensor, quantize_activations,
                    quantize_weights, slice_quantized_cols)

if TYPE_CHECKING:
    from ..kernels.bitplane_gemv.program import GroupTable


def leaf_key(w: BitplaneWeights) -> tuple:
    """The identity of a weight leaf in the engine's caches: where its
    planes and scales lie, and the planes' shape. Every map keyed by it
    also holds the leaf, so its storage cannot be freed and reused by
    another leaf while the entry lives."""
    return (w.planes.data_ptr(), tuple(w.planes.shape), w.scale.data_ptr())


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Static placement of one M×N q-bit GeMV onto the DRAM geometry."""

    m: int
    n: int
    q: int
    p: int
    n_sub: int
    n_chunks: int
    m_per_tile: int
    col_chunks: int

    @property
    def tiles(self) -> int:
        return self.n_chunks * self.col_chunks


def make_plan(m: int, n: int, q: int, p: int,
              geom: PudGeometry, usable_cols: Optional[int] = None
              ) -> PartitionPlan:
    cols = usable_cols if usable_cols is not None else geom.real_cols
    n_sub = min(geom.n_sub_max, n)
    m_per_tile = cols // q
    return PartitionPlan(m=m, n=n, q=q, p=p, n_sub=n_sub,
                         n_chunks=math.ceil(n / n_sub),
                         m_per_tile=m_per_tile,
                         col_chunks=math.ceil(m / m_per_tile))


@dataclasses.dataclass
class GemvHandle:
    """A weight matrix registered with the engine — RESIDENT in DRAM.

    `templates` are the static per-bit-offset command templates (§V-C) for
    this matrix's tile shape; None for float activations. `placement` is
    the matrix's persistent home in the engine's pool, with the one-time
    staging traffic in `placement.staged`.

    `wq`, the matrix's unsigned codes, is read only by the simulator: it is
    recovered from the packed planes (`to_quantized`, exact) on first
    access and kept, so a serving session never holds a second copy of
    its weights.
    """

    name: str
    weights: BitplaneWeights
    plan: PartitionPlan
    a_spec: Optional[QuantSpec]  # None => float activations (w-bit / a-fp)
    templates: Optional[CommandTemplates] = None
    placement: Optional[Placement] = None
    _wq: Optional[QuantizedTensor] = dataclasses.field(default=None,
                                                       repr=False)

    @property
    def wq(self) -> QuantizedTensor:
        if self._wq is None:
            self._wq = to_quantized(self.weights)
        return self._wq


@dataclasses.dataclass
class ShardedHandle:
    """One GeMV registered column-chunk tensor-parallel across the fabric.

    `parts[d]` is a regular `GemvHandle` over the quantized sub-matrix of
    output columns `col_bounds[d] : col_bounds[d+1]` (sliced from ONE
    quantization of the full matrix — `quant.slice_quantized_cols`
    commutes with quantization, so each shard's codes equal the oracle's
    matching columns code for code), placed on DIMM `d % dimms`. Each
    module executes its shard's waves independently; the host scatters the
    disjoint partial outputs (`MVDRAMEngine.gemv_sharded`), bitwise the
    unsharded single-pool launch. `plan` records how the split was
    expressed through the sharding rules (`fabric.plan_column_shards`).
    """

    name: str
    parts: tuple           # (shards,) GemvHandle, one per column shard
    col_bounds: tuple      # (shards+1,) output-column offsets into M
    plan: ColumnShardPlan
    n: int
    m: int

    @property
    def shards(self) -> int:
        return len(self.parts)


class ProgramReport:
    """Accounting for decode steps executed through a `GemvProgram`.

    `reports[l]` is the layer's resident `BatchReport`: outputs and
    per-tile runtime OpCounts bit-identical to a sequential per-layer
    `gemv`, but with ZERO weight staging (`shared_preload` empty) — the
    staging was paid ONCE at placement and is recorded in `staged`.

    Fused wave-major runs (the default) construct the per-layer reports
    LAZILY from the executor's array-native counts. They additionally
    carry the EXECUTED fused-wave serialization: `fused` is True, `waves`
    counts the fused waves the step actually ran (== the compiled
    schedule's), and `wave_max[w]` is the field-wise max over wave w's
    member tiles of the B-summed per-tile OpCounts.
    `timing.simulated_wave_time` prices that measured serialization
    directly, and `MVDRAMEngine.price_program(..., executed=report)`
    reconciles the program price against it. Layer-major oracle runs
    report `fused=False` with `waves` = the Σ of per-layer solo wave
    counts. `partials` (fused runs) holds each layer's (B, n_chunks, M)
    int64 per-chunk partials on the device, before the host's correction.
    """

    def __init__(self, reports=None, builder=None, fused: bool = False,
                 waves: int = 0, wave_max_arr=None, batch: int = 1,
                 retry_wave_ops=(), fault: Optional[FaultTrace] = None,
                 lanes: Optional[int] = None, counts_total_arr=None,
                 encode_ops=None, partials=None):
        self._reports = reports
        self._builder = builder
        self.fused = fused
        self.waves = waves
        self.batch = batch          # OCCUPIED lanes the step executed
        # lane CAPACITY of the launch (== batch unless an occupancy mask
        # idled some lanes — masked lanes bill zero ops, so `batch` is what
        # `price_program(..., executed=…)` reconciles against)
        self.lanes = batch if lanes is None else lanes
        self._wave_max_arr = wave_max_arr
        # fault-retry waves the step EXECUTED beyond the schedule (ABFT
        # re-runs of corrupt wave segments, each entry one wave's B-summed
        # PUD op bill)
        self.retry_wave_ops = tuple(retry_wave_ops)
        self.fault = fault          # merged FaultTrace (None = faults off)
        # complete executed command ledger of the step (retries included)
        # and per-layer host encode ops of the speculative-encode walk —
        # the per-command ENERGY reconciliation inputs; None on hand-built
        # or layer-major reports (pricing falls back to the analytic model)
        self._counts_total_arr = counts_total_arr
        self.encode_ops = (tuple(int(e) for e in encode_ops)
                           if encode_ops is not None else None)
        self.partials = partials

    @property
    def executed_counts(self) -> Optional[OpCounts]:
        """`OpCounts` of EVERYTHING the step executed (lanes and tiles
        summed, fault-retry re-bills included) — exactly what the resident
        banks' ledgers recorded. None when the run carried no array-native
        total."""
        if self._counts_total_arr is None:
            return None
        return OpCounts.from_vector(self._counts_total_arr)

    @property
    def retry_counts(self) -> OpCounts:
        """`OpCounts` slice of `executed_counts` that fault retries
        re-billed (empty on fault-free runs)."""
        if self.fault is None:
            return OpCounts()
        return self.fault.retry_counts

    @property
    def reports(self) -> tuple:
        if self._reports is None:
            self._reports = self._builder()
        return self._reports

    @property
    def wave_max(self) -> tuple:
        """(waves,) OpCounts: executed per-fused-wave maxima (empty for
        layer-major runs — their serialization is per-layer, in
        `reports[l].wave_max`)."""
        if self._wave_max_arr is None:
            return ()
        return tuple(OpCounts(*map(int, row))
                     for row in self._wave_max_arr.tolist())

    @property
    def executed_wave_ops(self) -> tuple:
        """(waves,) PUD op count per executed fused wave (B-summed) — what
        the bank-serialization reconciliation consumes."""
        if self._wave_max_arr is None:
            return ()
        idx = [_COUNT_FIELDS.index(f)
               for f in ("row_copy", "maj3", "maj5", "majx_other")]
        return tuple(int(r) for r in self._wave_max_arr[:, idx].sum(axis=1))

    @property
    def layers(self) -> int:
        return len(self.reports)

    @property
    def staged(self) -> OpCounts:
        """One-time placement staging behind this step (already paid)."""
        total = OpCounts()
        for r in self.reports:
            if r.staged is not None:
                total = total.merge(r.staged)
        return total

    @property
    def repeated_staging(self) -> OpCounts:
        """Weight staging paid BY this decode step — zero for residents."""
        total = OpCounts()
        for r in self.reports:
            total = total.merge(r.shared_preload)
        return total


class GemvProgram:
    """A decode step's sequence of resident GeMVs, compiled once.

    Built by `MVDRAMEngine.compile`: the layers' tile grids fuse into one
    interleaved wave schedule (`ProgramSchedule` — concurrency groups like
    q/k/v or up/gate share boundary waves), and each layer's weight
    bit-planes are staged into resident `BankArray`s exactly once (lazily,
    on the first `run`). `run` then executes any number of decode steps
    against those rows with zero re-staging — WAVE-MAJOR by default: the
    simulator walks the fused schedule's slot order directly, one batched
    step per global wave (`gemv.stage_program`/`execute_program`). The
    retained layer-by-layer path (`run(..., layer_major=True)`) is the
    bit-exactness oracle. `price` prices one step on the DDR4 model;
    `run_kernel` runs the whole block on the card as one B2 launch.
    """

    def __init__(self, engine: "MVDRAMEngine", handles: tuple,
                 sched: ProgramSchedule, groups: tuple,
                 b_max: Optional[int] = None):
        self.engine = engine
        self.handles = handles
        self.sched = sched
        self.groups = groups
        # lane CAPACITY baked into the program (None = fixed-B): every
        # run launches exactly b_max lanes, with the per-tick occupancy
        # carried by run_kernel(lane_mask=…)
        self.b_max = b_max
        self.steps = 0
        self.kernel_steps = 0       # decode blocks run via run_kernel()
        self._fused = None          # gemv.FusedProgram, built lazily
        self._fused_staged = None   # the StagedWaves the plan indexes
        self._kernel_plan = None    # ProgramKernelPlan, built lazily
        self._kernel_table = None   # its member table, built once

    @property
    def layers(self) -> int:
        return len(self.handles)

    def __repr__(self):
        return (f"<GemvProgram {self.layers} layers, "
                f"{self.sched.tiles} tiles, {self.sched.waves} waves "
                f"({self.sched.waves_shared} shared)>")

    def _check_layer(self, h) -> None:
        if h.a_spec is None:
            raise ValueError(
                f"layer {h.name!r} serves float activations — there is "
                f"no bit-serial command stream to run")

    def _staged_layers(self) -> tuple:
        staged = []
        for h in self.handles:
            st = self.engine.staged_for(h)
            if st is None:
                raise ValueError(
                    f"layer {h.name!r} is no longer resident (evicted?); "
                    f"re-register it before running the program")
            staged.append(st)
        return tuple(staged)

    def run(self, activations: Sequence[torch.Tensor],
            layer_major: bool = False,
            lane_mask: Optional[np.ndarray] = None):
        """Execute one decode step in the PUD simulator: activations[l] is
        layer l's (B, N_l) lane batch (or an (N_l,) vector, promoted to
        B=1). Returns ([(B, M_l) outputs], `ProgramReport`) — outputs and
        per-tile runtime OpCounts bit-identical to sequential per-layer
        `gemv`, with no weight row re-staged. Outputs are on the device of
        the leaves' planes.

        The default path executes the FUSED wave schedule directly (one
        batched simulator step per global wave, cross-layer boundary waves
        included); `layer_major=True` runs the retained per-layer oracle.
        The fused path requires every layer to carry the same lane batch.

        `lane_mask` (B,) bool executes the step at partial occupancy: the
        launch still carries all B lanes (B == `b_max` for a capacity
        program), but masked lanes bill zero ops and return zero rows —
        active lanes are bit-identical to a compacted launch, the report's
        `batch` is the OCCUPIED lane count (what `price` reconciles) and
        `lanes` the capacity."""
        if len(activations) != self.layers:
            raise ValueError(
                f"{len(activations)} activations for a {self.layers}-layer "
                f"program")
        if layer_major:
            outs, reports = [], []
            for h, x, staged in zip(self.handles, activations,
                                    self._staged_layers()):
                self._check_layer(h)
                squeeze = x.ndim == 1
                if squeeze:
                    x = x[None, :]
                # the same resident launch the sim backend executes
                out, rep = self.engine.run_resident(h, x, staged,
                                                    lane_mask=lane_mask)
                outs.append(out[0] if squeeze else out)
                reports.append(rep)
            self.steps += 1
            fault = None
            if any(r.fault is not None for r in reports):
                fault = FaultTrace()
                for r in reports:
                    if r.fault is not None:
                        fault.merge(r.fault)
            lanes = reports[0].batch if reports else 1
            active = (lanes if lane_mask is None
                      else int(np.count_nonzero(lane_mask)))
            return outs, ProgramReport(
                reports=tuple(reports), fused=False,
                waves=sum(r.waves for r in reports),
                batch=active, lanes=lanes,
                retry_wave_ops=fault.retry_wave_ops if fault else (),
                fault=fault)

        xs, squeezes = [], []
        for h, x in zip(self.handles, activations):
            self._check_layer(h)
            squeeze = x.ndim == 1
            if squeeze:
                x = x[None, :]
            xs.append(x.to(h.weights.planes.device))
            squeezes.append(squeeze)
        lane_mask = _lane_mask_arg(
            lane_mask, xs[0].shape[0] if xs else 1)
        staged = self._staged_layers()
        if (self._fused is None or self._fused_staged is None
                or any(a is not b
                       for a, b in zip(self._fused_staged, staged))):
            # (re)index the fused plan over the CURRENT resident rows —
            # eviction/re-registration or pool compaction re-stages a
            # layer, and the plan must follow it (the old plan goes first:
            # at full width each holds GBs of the device)
            self._fused = None
            self._fused = stage_program(staged, self.sched,
                                        b_max=self.b_max)
            self._fused_staged = staged
            if self.engine._fault_session is not None:
                # fault keys track the CURRENT pool homes, not the banks
                # the schedule was compiled against — a quarantine restage
                # moved the layer, and injection must follow it
                self._fused.bank_keys = np.asarray(
                    [self.handles[s.layer].placement.banks[s.tile]
                     for s in self.sched.slots], dtype=np.int64)
        aqs = [quantize_activations(x, h.a_spec)
               for h, x in zip(self.handles, xs)]
        res = execute_program(
            self._fused, aqs, [h.wq for h in self.handles],
            [h.templates for h in self.handles],
            sparsity=self.engine.sparsity,
            fault=self.engine._fault_session,
            max_retries=self.engine.fault_policy.max_wave_retries,
            lane_mask=lane_mask)
        for h in self.handles:
            self.engine.pool.touch(h.name)
        lanes = xs[0].shape[0] if xs else 1
        active = (lanes if lane_mask is None
                  else int(np.count_nonzero(lane_mask)))
        report = ProgramReport(
            builder=_resident_report_builder(staged, res, self.engine.geom),
            fused=True, waves=res.waves, wave_max_arr=res.wave_max,
            batch=active, lanes=lanes,
            retry_wave_ops=res.retry_wave_ops, fault=res.fault,
            counts_total_arr=res.counts_total,
            encode_ops=res.encode_layer_ops, partials=res.partials)
        outs = res.outs
        if res.fault is not None:
            self.engine._record_fault(res.fault)
            if res.fault.unresolved:
                # cells still corrupt past the retry budget: quarantine the
                # failing banks and host-recompute the affected layers
                outs = self.engine._recover(self.handles, xs, outs,
                                            res.fault)
                if lane_mask is not None:
                    # the host recompute sees the masked lanes' raw
                    # activations — keep their rows contractually zero
                    keep = torch.from_numpy(lane_mask)[:, None]
                    outs = [torch.where(keep.to(o.device), o, 0.0)
                            for o in outs]
        outs = [o[0] if sq else o for o, sq in zip(outs, squeezes)]
        self.steps += 1
        return outs, report

    @property
    def sim_bytes(self) -> int:
        """Device bytes the simulator holds for this program: its layers'
        staged rows (bank rows, matrix blocks, checksums) and its fused
        plan (the padded matrix copy and gather indices); 0 before the
        first `run`."""
        staged = sum(self.engine._staged[h.name].nbytes
                     for h in self.handles if h.name in self.engine._staged)
        return staged + (self._fused.nbytes if self._fused is not None
                         else 0)

    def kernel_plan(self):
        """The fused launch geometry of this program — the kernel-side twin
        of its `ProgramSchedule`, built once from the handles' static
        shapes, bits and zero points and the same concurrency groups."""
        if self._kernel_plan is None:
            from ..kernels.bitplane_gemv import program as bp_program
            metas = []
            for h in self.handles:
                self._check_layer(h)
                bw = h.weights
                metas.append((bw.n, bw.m, bw.bits, bw.scale.shape[0],
                              bw.zero, h.a_spec.bits,
                              bp_program.static_zero(h.a_spec)))
            self._kernel_plan = bp_program.build_plan(tuple(metas),
                                                      self.groups)
        return self._kernel_plan

    def kernel_table(self) -> "GroupTable":
        """The member table of the block's one launch: one member per
        layer, each reading its leaf's planes and scales in place. The
        weights are static, so it is built once."""
        if self._kernel_table is None:
            from ..kernels.bitplane_gemv import program as bp_program
            self._kernel_table = bp_program.member_table(
                self.kernel_plan(), tuple(h.weights for h in self.handles))
        return self._kernel_table

    def run_kernel(self, activations: Sequence[torch.Tensor],
                   fidelity: str = "code",
                   lane_mask: Optional[np.ndarray] = None) -> list:
        """Execute one decode step as ONE B2 launch over the whole block.
        activations[l] is layer l's (B, N_l) lane batch (or (N_l,),
        promoted to B=1; B must equal `b_max` for a capacity program).
        Returns per-layer (B, M_l) outputs bitwise equal to per-leaf
        `bitplane_gemv_bitserial` calls; masked lanes return zero rows.
        CUDA tensors run the kernel, CPU tensors its plain version."""
        from ..kernels.bitplane_gemv import program as bp_program
        if len(activations) != self.layers:
            raise ValueError(
                f"{len(activations)} activations for a {self.layers}-layer "
                f"program")
        xs, squeezes = [], []
        for h, x in zip(self.handles, activations):
            self._check_layer(h)
            squeeze = x.ndim == 1
            if squeeze:
                x = x[None, :]
            if x.shape[-1] != h.weights.n:
                raise ValueError(
                    f"layer {h.name!r} expects (..., {h.weights.n}) "
                    f"activations, got shape {tuple(x.shape)}")
            xs.append(x)
            squeezes.append(squeeze)
        b = xs[0].shape[0] if xs else 1
        if self.b_max is not None and b != self.b_max:
            raise ValueError(
                f"capacity program launches exactly b_max={self.b_max} "
                f"lanes, got B={b}; mask idle lanes with lane_mask")
        lane_mask = _lane_mask_arg(lane_mask, b)
        outs = bp_program.run_program(
            self.kernel_plan(), tuple(h.weights for h in self.handles),
            tuple(xs), tuple(h.a_spec for h in self.handles),
            fidelity=fidelity, table=self.kernel_table())
        if lane_mask is not None:
            keep = torch.from_numpy(lane_mask).to(outs[0].device)[:, None]
            outs = [torch.where(keep, o, 0.0) for o in outs]
        self.kernel_steps += 1
        return [o[0] if sq else o for o, sq in zip(outs, squeezes)]

    def price(self, bit_density: float = 0.5, batch: int = 1,
              usable_cols: Optional[int] = None,
              executed: Optional[ProgramReport] = None) -> ProgramCost:
        return self.engine.price_program(self, bit_density=bit_density,
                                         batch=batch,
                                         usable_cols=usable_cols,
                                         executed=executed)


def _resident_report_builder(staged_layers: tuple, res, geom: PudGeometry):
    """Deferred per-layer `BatchReport` construction for a fused run — the
    reports are bit-identical to the layer-major oracle's but only
    materialize when read, keeping the decode path array-native."""
    def build():
        from .pud.gemv import _build_batch_report
        reps = []
        for st, rt, sk, rb in zip(staged_layers, res.rt_arrs, res.skipped,
                                  res.r_bits):
            bsched = schedule_batch(st.n_chunks, st.col_chunks,
                                    rt.shape[0], geom)
            reps.append(_build_batch_report(
                st, bsched, rt, np.zeros_like(st.preload), sk, rb,
                resident=True))
        return tuple(reps)
    return build


@dataclasses.dataclass
class _FabricPart:
    """One DIMM's slice of a fabric program: the block layers co-resident
    on that module (or a single spilled layer awaiting page-in), the
    part-local concurrency groups, and the compiled per-module program."""

    indices: tuple                       # original layer indices, ascending
    handles: tuple                       # the engine's GemvHandles
    groups: tuple                        # part-LOCAL concurrency groups
    prog: Optional[GemvProgram] = None
    placements: tuple = ()               # placements `prog` was built from


class FabricReport:
    """Accounting for a fabric decode step: one `ProgramReport` per
    per-module part, plus the spill-tier restage bill the step actually
    paid paging cold parts in. `reports` reassembles the per-layer
    `BatchReport`s in the block's ORIGINAL layer order, so everything
    downstream of a single-pool `ProgramReport` reads a fabric report
    identically."""

    def __init__(self, parts: tuple, part_indices: tuple,
                 part_spill_bits: tuple, part_spill_restages: tuple):
        self.parts = tuple(parts)
        self.part_indices = tuple(tuple(ix) for ix in part_indices)
        # restage bits/count paid by THIS step, per part (0 for residents)
        self.part_spill_bits = tuple(part_spill_bits)
        self.part_spill_restages = tuple(part_spill_restages)
        self.fused = all(p.fused for p in self.parts)
        self.waves = sum(p.waves for p in self.parts)
        self.batch = self.parts[0].batch if self.parts else 1
        self.lanes = self.parts[0].lanes if self.parts else 1
        fault = None
        if any(p.fault is not None for p in self.parts):
            fault = FaultTrace()
            for p in self.parts:
                if p.fault is not None:
                    fault.merge(p.fault)
        self.fault = fault
        self.retry_wave_ops = tuple(op for p in self.parts
                                    for op in p.retry_wave_ops)

    @property
    def spill_restage_bits(self) -> int:
        return sum(self.part_spill_bits)

    @property
    def spill_restages(self) -> int:
        return sum(self.part_spill_restages)

    @property
    def reports(self) -> tuple:
        n = sum(len(ix) for ix in self.part_indices)
        out = [None] * n
        for rep, ix in zip(self.parts, self.part_indices):
            for j, li in enumerate(ix):
                out[li] = rep.reports[j]
        return tuple(out)

    @property
    def layers(self) -> int:
        return sum(len(ix) for ix in self.part_indices)

    @property
    def staged(self) -> OpCounts:
        total = OpCounts()
        for r in self.reports:
            if r.staged is not None:
                total = total.merge(r.staged)
        return total

    @property
    def repeated_staging(self) -> OpCounts:
        total = OpCounts()
        for r in self.reports:
            total = total.merge(r.shared_preload)
        return total


class FabricProgram:
    """A decode block compiled across the DRAM fabric.

    `MVDRAMEngine.compile` on a `FabricPool` engine partitions the block
    by residency: each DIMM's co-resident layers become one per-module
    `GemvProgram` part (waves fused within the module exactly as on a
    single pool), and spilled layers become single-layer parts that `run`
    pages in from the capacity tier on first touch. Parts execute their
    OWN module's channels, so the combined price overlaps their compute
    (`MVDRAMEngine.price_fabric`); outputs and per-tile runtime OpCounts
    stay bit-identical to the single-pool program. On the card each
    resident part's program runs as one B2 launch
    (`parts[k].prog.run_kernel`).

    The program survives fabric churn: cross-DIMM migration, member-pool
    compaction and spill/restage each swap a member's placement, and
    `run` re-localizes + recompiles exactly the affected part."""

    def __init__(self, engine: "MVDRAMEngine", handles: tuple,
                 groups: tuple, b_max: Optional[int], parts: tuple):
        self.engine = engine
        self.handles = handles
        self.groups = groups
        self.b_max = b_max
        self.parts = parts
        self.steps = 0

    @property
    def layers(self) -> int:
        return len(self.handles)

    def __repr__(self):
        spilled = sum(1 for p in self.parts if p.prog is None)
        return (f"<FabricProgram {self.layers} layers, "
                f"{len(self.parts)} parts ({spilled} awaiting page-in), "
                f"{self.engine.pool.dimms} dimms>")

    def _ensure_part(self, part: _FabricPart) -> tuple:
        """Make every member resident and the part's program current.
        Returns (restage_bits, restages) paid HERE paging members in from
        the spill tier — the exact bill `price_fabric` reconciles."""
        pool = self.engine.pool
        paid_bits, paid_restages = 0, 0
        for h in part.handles:
            if pool.is_resident(h.name):
                cur = pool.placements.get(h.name)
                if h.placement is not cur:
                    h.placement = cur    # migration/compaction moved it
            elif pool.is_spilled(h.name):
                h.placement = pool.restage(h.name)
                paid_bits += h.placement.staged.host_bits_written
                paid_restages += 1
            else:
                raise ValueError(
                    f"layer {h.name!r} is no longer resident on the "
                    f"fabric (evicted?); re-register it before running "
                    f"the program")
        placements = tuple(h.placement for h in part.handles)
        if part.prog is None or placements != part.placements:
            part.prog = self.engine._compile_part(part.handles, part.groups,
                                                  self.b_max)
            part.placements = placements
        return paid_bits, paid_restages

    def run(self, activations: Sequence[torch.Tensor],
            layer_major: bool = False,
            lane_mask: Optional[np.ndarray] = None):
        """Execute one decode step across the fabric in the PUD simulator.
        Same contract as `GemvProgram.run` — activations in the block's
        original layer order, outputs returned in that order, bit-identical
        to the single-pool program — plus demand paging: parts whose
        members sit in the spill tier restage first, and the returned
        `FabricReport` carries the restage bits/count this step paid."""
        if len(activations) != self.layers:
            raise ValueError(
                f"{len(activations)} activations for a {self.layers}-layer "
                f"program")
        outs = [None] * self.layers
        part_reports, part_bits, part_restages = [], [], []
        for part in self.parts:
            bits, restages = self._ensure_part(part)
            xs = [activations[i] for i in part.indices]
            os, rep = part.prog.run(xs, layer_major=layer_major,
                                    lane_mask=lane_mask)
            for i, o in zip(part.indices, os):
                outs[i] = o
            part_reports.append(rep)
            part_bits.append(bits)
            part_restages.append(restages)
        self.steps += 1
        report = FabricReport(
            parts=tuple(part_reports),
            part_indices=tuple(p.indices for p in self.parts),
            part_spill_bits=tuple(part_bits),
            part_spill_restages=tuple(part_restages))
        return outs, report

    def price(self, bit_density: float = 0.5, batch: int = 1,
              usable_cols: Optional[int] = None,
              executed: Optional[FabricReport] = None) -> FabricCost:
        return self.engine.price_fabric(self, bit_density=bit_density,
                                        batch=batch,
                                        usable_cols=usable_cols,
                                        executed=executed)


class MVDRAMEngine:
    """Processor-DRAM co-designed GeMV engine: the residency session, the
    PUD simulator that executes it (with fault injection and its recovery
    ladder), its DDR4 pricing, and the routing of every lane-batched
    quantized linear of a serving model (with the member tables of its
    fused B2 launches)."""

    def __init__(self, geom: PudGeometry = PudGeometry(),
                 timing: DDR4Model = DDR4_2400,
                 cpu: CpuBaseline = CpuBaseline(),
                 gpu: GpuBaseline = GpuBaseline(),
                 sparsity: bool = True,
                 pool: Optional[Union[DramPool, FabricPool]] = None,
                 on_full: str = "evict",
                 fault_model: Optional[FaultModel] = None,
                 fault_policy: Optional[FaultPolicy] = None,
                 cxl: Optional[CxlModel] = None,
                 energy: Optional[EnergyModel] = None):
        self.geom = geom
        self.timing = timing
        self.cpu = cpu
        self.gpu = gpu
        self.sparsity = sparsity
        self.pool = pool if pool is not None else DramPool(geom)
        self.on_full = on_full
        # CXL capacity-tier constants pricing FabricPool spill restages
        self.cxl = cxl if cxl is not None else CXL_TIER
        # per-command energy pricing of program steps
        self.energy = energy if energy is not None else DDR4_ENERGY
        # fault injection + recovery ladder: FaultModel.none() yields NO
        # session, so the default engine takes the exact pre-fault paths
        self.fault_model = (fault_model if fault_model is not None
                            else FaultModel.none())
        self.fault_policy = (fault_policy if fault_policy is not None
                             else FaultPolicy())
        self._fault_session = self.fault_model.session()
        self._bank_strikes: dict = {}     # (channel, bank) -> unresolved hits
        self._fallback_counts: dict = {}  # name -> host recomputations
        self._degraded: set = set()       # names served by the host path
        self.fault_corrupted = 0
        self.fault_detected = 0
        self.fault_retries = 0
        self.fault_host_fallbacks = 0
        self.fault_quarantines = 0
        self.fault_restages = 0
        self.handles: dict[str, GemvHandle] = {}
        self.sharded: dict[str, ShardedHandle] = {}
        # the simulator's staged rows per resident handle, built lazily
        self._staged: dict[str, StagedWaves] = {}
        # leaf_key + (act_bits,) → (handle name, leaf): a leaf the serving
        # layer already placed is found again by identity, never placed
        # twice; entries are pruned on eviction
        self._leaf_names: dict[tuple, tuple] = {}
        self.routed_linears = 0   # serving linears routed through linear()
        # (act_bits, leaf keys) → (leaves, member table)
        self._packed: dict = {}
        # pool-driven evictions (LRU on_full, replace) must drop the staged
        # rows and invalidate the handle's placement just like engine.evict
        self.pool.evict_listeners.append(self._on_pool_evict)
        # pool compaction and fabric migration physically move resident
        # rows: the staged BankArrays no longer mirror them, so drop them
        # (they restage lazily against the new spans) and follow the
        # placement update
        self.pool.move_listeners.append(self._on_pool_move)

    def _on_pool_evict(self, name: str, placement: Placement) -> None:
        self._staged.pop(name, None)
        self._leaf_names = {k: v for k, v in self._leaf_names.items()
                            if v[0] != name}
        h = self.handles.get(name)
        if h is not None and h.placement is placement:
            h.placement = None

    def _on_pool_move(self, name: str, old: Placement,
                      new: Placement) -> None:
        self._staged.pop(name, None)
        h = self.handles.get(name)
        if h is not None and h.placement is old:
            h.placement = new

    # -- phase ①: place (weights into "DRAM") ---------------------------------

    def register(self, name: str, w: torch.Tensor, w_spec: QuantSpec,
                 a_spec: Optional[QuantSpec] = None) -> GemvHandle:
        """Quantize + pack an (N, M) weight matrix and PLACE it in the
        residency pool. Re-registering a name evicts its previous
        placement first."""
        wq = quantize_weights(w, w_spec)
        return self._install(name, from_quantized(wq), a_spec, wq=wq)

    def register_packed(self, name: str, bw: BitplaneWeights,
                        a_spec: Optional[QuantSpec] = None) -> GemvHandle:
        """Register an ALREADY-PACKED (N, M) weight leaf (e.g. a serving
        engine's `BitplaneWeights`); its codes are recovered from the
        planes only when the simulator first reads them (`GemvHandle.wq`)."""
        if bw.planes.ndim != 3:
            raise ValueError(
                "register_packed takes a 2-D weight leaf (packed planes "
                "(q, N//32, M)); stacked expert leaves are served per-expert")
        return self._install(name, bw, a_spec)

    def register_sharded(self, name: str, w: torch.Tensor,
                         w_spec: QuantSpec,
                         a_spec: Optional[QuantSpec] = None,
                         shards: Optional[int] = None) -> ShardedHandle:
        """Register ONE (N, M) GeMV column-chunk tensor-parallel across the
        fabric: quantize once, slice the quantized tensor into contiguous
        column-chunk shards (`fabric.plan_column_shards` expresses the
        split through `parallel/sharding.py` rules over a `launch/mesh.py`
        host mesh of the devices of `w`'s kind), and place shard d on DIMM
        `d % dimms` as the regular handle `{name}@shard{d}`. `shards`
        defaults to the pool's DIMM count (1 on a plain `DramPool` — the
        single-pool oracle configuration). Execute with `gemv_sharded`."""
        fabric = isinstance(self.pool, FabricPool)
        if shards is None:
            shards = self.pool.dimms if fabric else 1
        if shards < 1:
            raise ValueError(f"need >= 1 shard, got {shards}")
        wq = quantize_weights(w, w_spec)
        n, m = int(wq.values.shape[0]), int(wq.values.shape[1])
        q = wq.spec.bits
        _chunk_rows, col_chunks = self._sim_grid(n, m, q)
        plan = plan_column_shards(col_chunks, shards, device=w.device)
        m_per_tile = max(self.geom.subarray_cols // q, 1)
        bounds = plan.bounds_cols(m, m_per_tile)
        dimms = self.pool.dimms if fabric else 1
        parts = []
        for d in range(plan.shards):
            wq_d = slice_quantized_cols(wq, bounds[d], bounds[d + 1])
            parts.append(self._install(
                f"{name}@shard{d}", from_quantized(wq_d), a_spec, wq=wq_d,
                dimm=(d % dimms) if fabric else None))
        sh = ShardedHandle(name=name, parts=tuple(parts),
                           col_bounds=bounds, plan=plan, n=n, m=m)
        self.sharded[name] = sh
        return sh

    def _sim_grid(self, n: int, m: int, q: int):
        """The matrix's tile grid at the SIMULATED geometry (what the pool
        places): per-chunk reduction rows + col chunks."""
        n_sub = min(self.geom.n_sub_max, n)
        n_chunks = math.ceil(n / n_sub)
        chunk_rows = [min((ci + 1) * n_sub, n) - ci * n_sub
                      for ci in range(n_chunks)]
        m_per_tile = self.geom.subarray_cols // q
        return chunk_rows, math.ceil(m / max(m_per_tile, 1))

    def _install(self, name: str, bw: BitplaneWeights,
                 a_spec: Optional[QuantSpec],
                 wq: Optional[QuantizedTensor] = None,
                 dimm: Optional[int] = None) -> GemvHandle:
        """Shared tail of every registration entry: one plan/template/
        placement/handle construction. `dimm` pins the placement to one
        fabric module (the column-shard path puts shard d on DIMM d); it
        requires a `FabricPool`."""
        p = a_spec.bits if a_spec is not None else 16
        plan = make_plan(m=bw.m, n=bw.n, q=bw.bits, p=p, geom=self.geom)
        templates = (build_templates(plan.n_sub, p)
                     if a_spec is not None else None)
        chunk_rows, col_chunks = self._sim_grid(bw.n, bw.m, bw.bits)
        place_kwargs = {}
        if dimm is not None:
            if not isinstance(self.pool, FabricPool):
                raise ValueError(
                    f"dimm={dimm} pinning needs a FabricPool; this engine's "
                    f"pool is a {type(self.pool).__name__}")
            place_kwargs["dimm"] = dimm
        placement = self.pool.place(
            name, chunk_rows, col_chunks,
            replace=(name in self.handles or self.pool.is_resident(name)),
            on_full=self.on_full, **place_kwargs)
        self._staged.pop(name, None)
        h = GemvHandle(name=name, weights=bw, plan=plan, a_spec=a_spec,
                       templates=templates, placement=placement, _wq=wq)
        self.handles[name] = h
        if a_spec is not None:
            self._leaf_names[leaf_key(bw) + (a_spec.bits,)] = (name, bw)
        return h

    def evict(self, handle: Union[GemvHandle, str]) -> Placement:
        """Retire a matrix from residency (its handle stays registered
        for the kernel path; the sim falls back to per-call staging). The
        staged rows and the handle's placement drop via the pool's evict
        listener — the same path pool-driven LRU evictions take."""
        h = self.handles[handle] if isinstance(handle, str) else handle
        return self.pool.evict(h.name)

    def staged_for(self, handle: Union[GemvHandle, str]
                   ) -> Optional[StagedWaves]:
        """The handle's resident staged rows — built lazily on first use,
        on the device of the leaf's planes, then reused by every launch
        (zero re-staging). None when the matrix is not resident (evicted)
        or serves float activations.

        A STALE handle — its name has since been re-registered with other
        weights — is rejected loudly: silently staging the old matrix
        under the current name would poison the cache for every later
        launch of the new registration."""
        h = self.handles[handle] if isinstance(handle, str) else handle
        if self.handles.get(h.name) is not h:
            raise ValueError(
                f"stale handle {h.name!r}: the name was re-registered with "
                f"different weights; re-compile programs against the "
                f"current handle")
        if (h.a_spec is None or h.placement is None
                or self.pool.placements.get(h.name) is not h.placement):
            return None
        if h.name not in self._staged:
            st = stage_matrix(h.wq, h.a_spec.bits, geom=self.geom)
            if self._fault_session is not None:
                # fault keys must follow the POOL's per-tile homes — the
                # staging schedule's default rotation only matches a fresh
                # pool, and quarantine exists precisely to MOVE a matrix
                # off its weak banks on restage
                banks = h.placement.banks
                for g in st.groups:
                    g.bank_keys = np.asarray(
                        [banks[t] for t in g.tiles_idx], dtype=np.int64)
                    g.bank.fault_keys = g.bank_keys
            self._staged[h.name] = st
        return self._staged[h.name]

    # -- phase ②: execute (encode, execute, aggregate) ------------------------

    def gemv(self, handle: Union[GemvHandle, str], a: torch.Tensor,
             backend: Union[Backend, str, None] = None,
             fidelity: str = "code", naive: bool = False,
             wave: Optional[bool] = None):
        """Execute the registered GeMV on a (N,) activation vector or a
        (B, N) lane batch through a `Backend` (core.backends):

          REFERENCE  the plain bit-plane versions
          KERNEL     the CUDA kernels (their plain versions on the CPU)
          SIM        the PUD simulator — a (B, N) lane batch executes
                     against the handle's RESIDENT staged rows (zero
                     re-staging; `BatchReport.resident`), a (N,) vector
                     runs the per-call staging oracle; returns
                     (out, report)

        `fidelity` selects the kernel's bit-serial schedule; `naive=True`
        runs the sim micro-op by micro-op (the oracle); `wave` toggles the
        sim's wave-parallel BankArray dispatch."""
        h = self.handles[handle] if isinstance(handle, str) else handle
        be = _backends.get_backend(backend)
        self.pool.touch(h.name)
        return be.gemv(self, h, a, fidelity=fidelity, naive=naive, wave=wave)

    def run_resident(self, handle: GemvHandle, x: torch.Tensor,
                     staged: StagedWaves,
                     lane_mask: Optional[np.ndarray] = None):
        """One resident lane-batched launch against already-staged rows —
        the single execution path shared by the sim backend and layer-major
        `GemvProgram` steps (zero weight re-staging). With a fault session
        active the launch ABFT-verifies each wave and retries corrupt
        segments; cells still corrupt past the budget escalate through
        `_recover` (quarantine / host recompute / degrade). `lane_mask`
        executes at partial occupancy (masked lanes bill zero ops and
        return zero rows)."""
        x = x.to(handle.weights.planes.device)
        aq = quantize_activations(x, handle.a_spec)
        out, report = mvdram_gemv_batched(
            aq, handle.wq, sparsity=self.sparsity, geom=self.geom,
            templates=handle.templates, staged=staged,
            fault=self._fault_session,
            max_retries=self.fault_policy.max_wave_retries,
            lane_mask=lane_mask)
        self.pool.touch(handle.name)
        if report.fault is not None:
            self._record_fault(report.fault)
            if report.fault.unresolved:
                out = self._recover([handle], [x], [out], report.fault)[0]
                if lane_mask is not None:
                    keep = torch.as_tensor(np.asarray(lane_mask, bool),
                                           device=out.device)[:, None]
                    out = torch.where(keep, out, 0.0)
        return out, report

    def gemv_sharded(self, sharded: Union[ShardedHandle, str],
                     a: torch.Tensor,
                     lane_mask: Optional[np.ndarray] = None):
        """Execute a column-sharded GeMV: each shard runs its resident
        simulator launch (`run_resident`, on the leaf's device) on its own
        DIMM's banks, and the host scatters the per-shard partials into the
        full (B, M) output — the shards cover DISJOINT output columns, so
        the result is bitwise the unsharded single-pool launch. Returns
        (out on `a`'s device, (per-shard BatchReport, ...))."""
        sh = self.sharded[sharded] if isinstance(sharded, str) else sharded
        if self.sharded.get(sh.name) is not sh:
            raise ValueError(
                f"stale sharded handle {sh.name!r}: the name was "
                f"re-registered; re-resolve it before launching")
        x = a
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        if x.shape[-1] != sh.n:
            raise ValueError(
                f"sharded GeMV {sh.name!r} expects (..., {sh.n}) "
                f"activations, got shape {tuple(x.shape)}")
        out = torch.zeros((int(x.shape[0]), sh.m), dtype=torch.float32)
        reports = []
        for d, part in enumerate(sh.parts):
            staged = self.staged_for(part)
            if staged is None:
                raise ValueError(
                    f"shard {part.name!r} of {sh.name!r} is no longer "
                    f"resident (evicted?); re-register the sharded GeMV")
            o, rep = self.run_resident(part, x, staged, lane_mask=lane_mask)
            lo, hi = sh.col_bounds[d], sh.col_bounds[d + 1]
            # disjoint column ranges: the host-side reduction is an exact
            # scatter of each module's partial into its slice
            out[:, lo:hi] += o.to(device="cpu", dtype=torch.float32)
            reports.append(rep)
        out = out[0] if squeeze else out
        return out.to(a.device), tuple(reports)

    # -- fault recovery (ABFT escalation ladder) ------------------------------

    def is_degraded(self, handle: Union[GemvHandle, str]) -> bool:
        """Has the fault-recovery ladder demoted this linear to the host
        reference path? (`SimBackend.gemv` routes degraded handles there so
        serving keeps answering under a fault storm.)"""
        name = handle if isinstance(handle, str) else handle.name
        return name in self._degraded

    def _record_fault(self, trace: FaultTrace) -> None:
        self.fault_corrupted += trace.corrupted
        self.fault_detected += trace.detected
        self.fault_retries += trace.retries

    def _recover(self, handles, xs, outs, trace: FaultTrace) -> list:
        """Escalate a launch's unresolved fault cells per `FaultPolicy`:
        strike the failing banks — `quarantine_after` strikes quarantines
        the bank in the pool and restages its evicted residents on healthy
        banks — then recompute the corrupted layers' outputs on the
        reference backend's plain versions (correct by construction). A
        layer host-recomputed `degrade_after` times degrades permanently
        to that path."""
        for cb in trace.unresolved_banks:
            cb = (int(cb[0]), int(cb[1]))
            self._bank_strikes[cb] = self._bank_strikes.get(cb, 0) + 1
            if (self._bank_strikes[cb] >= self.fault_policy.quarantine_after
                    and not self.pool.is_quarantined(*cb)):
                victims = self.pool.quarantine_bank(*cb)
                self.fault_quarantines += 1
                for name in victims:
                    self._restage_elsewhere(name)
        outs = list(outs)
        for layer in sorted({l for (_b, l, _t) in trace.unresolved}):
            h = handles[layer]
            outs[layer] = _backends.REFERENCE.gemv(self, h, xs[layer])
            self.fault_host_fallbacks += 1
            n = self._fallback_counts.get(h.name, 0) + 1
            self._fallback_counts[h.name] = n
            if n >= self.fault_policy.degrade_after:
                self._degraded.add(h.name)
        return outs

    def _restage_elsewhere(self, name: str) -> None:
        """Re-place a resident that a bank quarantine evicted — onto the
        surviving healthy banks, compacting once if fragmented. If the
        rank is out of healthy capacity the layer degrades to the host
        path instead of failing the launch."""
        h = self.handles.get(name)
        if h is None:
            return
        chunk_rows, col_chunks = self._sim_grid(
            h.weights.n, h.weights.m, h.weights.bits)
        for attempt in range(2):
            try:
                h.placement = self.pool.place(
                    name, chunk_rows, col_chunks, on_full=self.on_full)
                self.fault_restages += 1
                return
            except CapacityError:
                if attempt == 0:
                    self.pool.compact()
        self._degraded.add(name)

    # -- serving-side routing --------------------------------------------------

    def linear(self, x: torch.Tensor, w: BitplaneWeights,
               act_bits: Optional[int] = None,
               backend: Union[Backend, str, None] = None) -> torch.Tensor:
        """One lane-batched quantized linear: x (..., N) — typically the
        (lanes, N) decode batch — executes as ONE batched GeMV launch."""
        self.routed_linears += 1
        return _backends.get_backend(backend).linear(self, x, w, act_bits)

    def linear_group(self, x: torch.Tensor, ws: Sequence[BitplaneWeights],
                     act_bits: Optional[int] = None,
                     backend: Union[Backend, str, None] = None) -> tuple:
        """k independent serving linears sharing ONE input (q/k/v,
        up/gate): the kernel backend fuses them into a single launch, the
        reference backend runs them per leaf with identical results."""
        self.routed_linears += len(ws)
        return _backends.get_backend(backend).linear_group(
            self, x, tuple(ws), act_bits)

    def sim_linear(self, x: torch.Tensor, w: BitplaneWeights,
                   act_bits: int) -> torch.Tensor:
        """The sim backend's audit route: resolve (or lazily place) the
        weight leaf as a resident handle and execute against its staged
        rows. The identity key (`leaf_key`) carries act_bits: the same
        leaf served at different activation precisions gets distinct
        registrations."""
        entry = self._leaf_names.get(leaf_key(w) + (act_bits,))
        if entry is not None and entry[0] in self.handles:
            name = entry[0]
        else:
            # unseen leaf: lazily place it (registration records the
            # identity key, so later audits of the same leaf reuse it)
            name = f"_linear_{w.planes.data_ptr()}_{act_bits}"
            self.register_packed(name, w, QuantSpec(bits=act_bits))
        out, _report = self.gemv(name, x, backend=_backends.SIM)
        return out

    def packed_group(self, ws: Sequence[BitplaneWeights], act_bits: int
                     ) -> GroupTable:
        """The member table of a group's fused B2 launch
        (`program.GroupTable`: each member reads its leaf's planes and
        scales in place, so it holds no copy of the weights), built on first
        use and cached by the leaves' identities (`leaf_key`): weights are
        static, so every later decode step reuses it. The JAX package
        re-packs a slot-major copy inside each traced call; the numbers are
        the same."""
        from ..kernels.bitplane_gemv import program as bp_program
        key = (act_bits,) + tuple(leaf_key(w) for w in ws)
        hit = self._packed.get(key)
        if hit is None:
            hit = (tuple(ws), bp_program.group_table(ws, act_bits))
            self._packed[key] = hit
        return hit[1]

    # -- compiled decode programs ---------------------------------------------

    def compile(self, handles: Sequence[Union[GemvHandle, str]],
                groups: Optional[Sequence[Sequence[int]]] = None,
                b_max: Optional[int] = None
                ) -> Union[GemvProgram, FabricProgram]:
        """Fuse a decode step's sequence of resident GeMVs into one
        interleaved command schedule. `groups` marks independent layers
        that may share waves — e.g. [[0, 1, 2], [3]] for q/k/v then o — by
        index into `handles`; default is fully sequential. `b_max`
        compiles a CAPACITY program: every run launches exactly `b_max`
        lanes and per-tick occupancy flows through `lane_mask`. On a
        `FabricPool` engine the block compiles into per-DIMM parts
        (`FabricProgram`)."""
        if b_max is not None and (not isinstance(b_max, int) or b_max < 1):
            raise ValueError(f"b_max must be a positive int, got {b_max!r}")
        hs = tuple(self.handles[h] if isinstance(h, str) else h
                   for h in handles)
        if not hs:
            raise ValueError("compile() needs at least one handle")
        names = [h.name for h in hs]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(
                f"handle(s) {dup} appear more than once in the program; "
                f"register tied weights under distinct names to reuse a "
                f"matrix within one decode step")
        groups_t = (tuple(tuple(g) for g in groups)
                    if groups is not None else None)
        if isinstance(self.pool, FabricPool):
            return self._compile_fabric(hs, groups_t, b_max)
        for h in hs:
            if not self.pool.is_resident(h.name):
                raise ValueError(
                    f"{h.name!r} is not resident; register it (or re-place "
                    f"after eviction) before compiling")
        grids = [(h.placement.n_chunks, h.placement.col_chunks) for h in hs]
        placements = [h.placement.banks for h in hs]
        sched = schedule_program(grids, self.geom, groups=groups_t,
                                 placements=placements)
        return GemvProgram(self, hs, sched,
                           groups_t or tuple((i,) for i in range(len(hs))),
                           b_max=b_max)

    def _local_banks(self, h: GemvHandle) -> tuple:
        """The handle's per-tile (channel, bank) homes in its OWN module's
        coordinates — what per-part wave schedules and `price_program`'s
        per-channel command-bus accounting index with."""
        if isinstance(self.pool, FabricPool):
            _dimm, local = self.pool.locate(h.name)
            return local.banks
        return h.placement.banks

    def _compile_part(self, hs: tuple, groups: tuple,
                      b_max: Optional[int]) -> GemvProgram:
        """One fabric part — the layers co-resident on a single DIMM —
        compiled exactly like a single-pool program over that module's
        local bank coordinates."""
        grids = [(h.placement.n_chunks, h.placement.col_chunks) for h in hs]
        placements = [self._local_banks(h) for h in hs]
        sched = schedule_program(grids, self.geom, groups=groups,
                                 placements=placements)
        return GemvProgram(self, hs, sched, groups, b_max=b_max)

    def _compile_fabric(self, hs: tuple, groups_t: Optional[tuple],
                        b_max: Optional[int]) -> FabricProgram:
        """Partition a decode block across the fabric: each DIMM's
        co-resident layers compile into one per-module part (waves fused
        within the module, concurrency groups subset to the part's
        members), and each SPILLED layer becomes its own single-layer
        part, paged in on demand."""
        groups_t = groups_t or tuple((i,) for i in range(len(hs)))
        pool = self.pool
        home: dict[int, Optional[int]] = {}
        for i, h in enumerate(hs):
            if pool.is_resident(h.name):
                home[i] = pool.dimm_of(h.name)
            elif pool.is_spilled(h.name):
                home[i] = None
            else:
                raise ValueError(
                    f"{h.name!r} is neither resident nor spilled on the "
                    f"fabric; register it (or re-place after eviction) "
                    f"before compiling")
        buckets: dict = {}
        for i in range(len(hs)):
            key = home[i] if home[i] is not None else ("spill", i)
            buckets.setdefault(key, []).append(i)
        resident_keys = sorted(k for k in buckets if isinstance(k, int))
        spill_keys = sorted((k for k in buckets if not isinstance(k, int)),
                            key=lambda k: k[1])
        parts = []
        for key in resident_keys + spill_keys:
            indices = tuple(buckets[key])
            pos = {li: j for j, li in enumerate(indices)}
            sub_groups = tuple(
                tuple(pos[li] for li in g if li in pos)
                for g in groups_t if any(li in pos for li in g))
            parts.append(_FabricPart(
                indices=indices,
                handles=tuple(hs[li] for li in indices),
                groups=sub_groups))
        program = FabricProgram(self, hs, groups_t, b_max, tuple(parts))
        for part in parts:
            # resident parts compile eagerly so `price` works at once;
            # spilled parts wait for their page-in
            if all(pool.is_resident(h.name) for h in part.handles):
                part.prog = self._compile_part(part.handles, part.groups,
                                               b_max)
                part.placements = tuple(h.placement for h in part.handles)
        return program

    def price_program(self, program: GemvProgram, bit_density: float = 0.5,
                      batch: int = 1,
                      usable_cols: Optional[int] = None,
                      executed: Optional[ProgramReport] = None,
                      spill_restage_bits: int = 0,
                      spill_restages: int = 0) -> ProgramCost:
        """DDR4 price of one fused decode step. Defaults to the SIMULATED
        column width so `staged_bits` reconciles exactly with the pool's
        placement accounting; pass `usable_cols=geom.real_cols` for
        paper-scale pricing — the schedule is then re-fused over the
        real-width tile grids with the SAME concurrency groups.

        `executed` — the `ProgramReport` of a fused wave-major `run` —
        reconciles the bank-serialization term against the EXECUTED
        fused-wave counts instead of the analytic per-layer estimate (the
        measured per-wave maxima, B lanes already summed, replace
        `bit_density`-expected ops). Only valid at the simulated column
        width and for a fused run's report. It also reconciles ENERGY and
        ENCODE: the run's complete command ledger (`executed_counts`, retry
        re-bills split back out via `retry_counts`) prices `e_*` per
        command, and the encode walk's per-layer `encode_ops` feed the
        pipelined encode timeline — `e_total` then equals the ledger's
        energy float for float."""
        cols = usable_cols if usable_cols is not None else \
            self.geom.subarray_cols
        executed_wave_ops = None
        retry_wave_ops = None
        executed_counts = None
        retry_counts = None
        executed_encode_ops = None
        if executed is not None:
            if cols != self.geom.subarray_cols:
                raise ValueError(
                    "executed fused-wave counts are measured at the "
                    "simulated column width; price real-width schedules "
                    "analytically")
            if not executed.fused:
                raise ValueError(
                    "executed reconciliation needs a fused wave-major "
                    "run's ProgramReport (run(..., layer_major=True) "
                    "reports have no fused-wave counts)")
            if executed.batch != batch:
                raise ValueError(
                    f"executed fused-wave counts sum a B={executed.batch} "
                    f"lane batch; pricing at batch={batch} would mix it "
                    f"with analytic terms at a different batch")
            executed_wave_ops = executed.executed_wave_ops
            # ABFT fault-retry waves the step executed beyond the schedule
            # reconcile as an explicit extra serialization term (t_retry)
            retry_wave_ops = executed.retry_wave_ops or None
            executed_counts = executed.executed_counts
            if executed_counts is not None:
                retry_counts = executed.retry_counts
            executed_encode_ops = executed.encode_ops
        costs = []
        for h in program.handles:
            p = h.plan
            costs.append(mvdram_gemv_cost(p.m, p.n, p.q, p.p, bit_density,
                                          self.sparsity, self.geom,
                                          usable_cols=cols))
        if cols == self.geom.subarray_cols:
            sched = program.sched
        else:
            grids = []
            for h in program.handles:
                plan = make_plan(h.plan.m, h.plan.n, h.plan.q, h.plan.p,
                                 self.geom, usable_cols=cols)
                grids.append((plan.n_chunks, plan.col_chunks))
            sched = schedule_program(grids, self.geom, groups=program.groups)
        return price_program(costs, sched, batch=batch,
                             geom=self.geom, model=self.timing,
                             executed_wave_ops=executed_wave_ops,
                             retry_wave_ops=retry_wave_ops,
                             spill_restage_bits=spill_restage_bits,
                             spill_restages=spill_restages,
                             spill=self.cxl, energy=self.energy,
                             executed_counts=executed_counts,
                             retry_counts=retry_counts,
                             executed_encode_ops=executed_encode_ops)

    def _provisional_part_prog(self, part: _FabricPart) -> GemvProgram:
        """A throwaway schedule for a spilled part that has never been
        paged in — the analytic price needs a wave count but there is no
        placement to localize, so the default round-robin rotation stands
        in (exactly what `place` will produce for a fresh single-layer
        part)."""
        grids = []
        for h in part.handles:
            bw = h.weights
            chunk_rows, col_chunks = self._sim_grid(bw.n, bw.m, bw.bits)
            grids.append((len(chunk_rows), col_chunks))
        sched = schedule_program(grids, self.geom, groups=part.groups)
        return GemvProgram(self, part.handles, sched, part.groups,
                           b_max=part.prog.b_max if part.prog else None)

    def price_fabric(self, program: FabricProgram,
                     bit_density: float = 0.5, batch: int = 1,
                     usable_cols: Optional[int] = None,
                     executed: Optional[FabricReport] = None
                     ) -> FabricCost:
        """DDR4 price of one fabric decode step: each part priced like a
        single-pool program over its OWN module's command bus, then
        combined — per-module parts overlap, host-side terms sum.
        Never-paged spill parts price their restage analytically from the
        spill ledger; `executed=` (a `FabricReport`) reconciles both the
        wave serialization AND the restage bits the run actually paid."""
        if not isinstance(self.pool, FabricPool):
            raise ValueError(
                f"price_fabric needs a FabricPool engine, pool is "
                f"{type(self.pool).__name__}")
        if executed is not None and len(executed.parts) != len(program.parts):
            raise ValueError(
                f"executed report has {len(executed.parts)} parts, "
                f"program has {len(program.parts)}")
        costs, part_dimms = [], []
        for k, part in enumerate(program.parts):
            rep = executed.parts[k] if executed is not None else None
            if executed is not None:
                sb = executed.part_spill_bits[k]
                sr = executed.part_spill_restages[k]
            else:
                sb = sum(self.pool.spill_entry(h.name).bits
                         for h in part.handles
                         if self.pool.is_spilled(h.name))
                sr = sum(1 for h in part.handles
                         if self.pool.is_spilled(h.name))
            prog_k = part.prog or self._provisional_part_prog(part)
            costs.append(self.price_program(
                prog_k, bit_density=bit_density, batch=batch,
                usable_cols=usable_cols, executed=rep,
                spill_restage_bits=sb, spill_restages=sr))
            dimms_here = {self.pool.dimm_of(h.name) for h in part.handles
                          if self.pool.is_resident(h.name)}
            part_dimms.append(dimms_here.pop()
                              if len(dimms_here) == 1 else None)
        return combine_fabric_costs(costs, tuple(part_dimms),
                                    dimms=self.pool.dimms, batch=batch)

    # -- pricing (paper-faithful DDR4 numbers) --------------------------------

    def price(self, handle: Union[GemvHandle, str],
              bit_density: float = 0.5) -> dict:
        h = self.handles[handle] if isinstance(handle, str) else handle
        p = h.plan
        mv_cost = mvdram_gemv_cost(p.m, p.n, p.q, p.p, bit_density,
                                   self.sparsity, self.geom)
        conv_cost = conventional_pud_cost(p.m, p.n, p.q, p.p, bit_density,
                                          self.geom)
        mv = price_gemv(mv_cost, self.geom, self.timing)
        conv = price_gemv(conv_cost, self.geom, self.timing)
        return {
            "plan": dataclasses.asdict(p),
            "mvdram": mv.asdict(),
            "conventional_pud": conv.asdict(),
            "cpu_s": self.cpu.gemv_time(p.m, p.n, p.q, p.p),
            "gpu_s": self.gpu.gemv_time(p.m, p.n, p.q, p.p),
            "cpu_j": self.cpu.gemv_energy(p.m, p.n, p.q, p.p),
            "gpu_j": self.gpu.gemv_energy(p.m, p.n, p.q, p.p),
        }

    # -- model-level helpers ---------------------------------------------------

    def storage_bytes(self, handle: Union[GemvHandle, str]) -> int:
        """Device bytes of the packed representation (the capacity win)."""
        h = self.handles[handle] if isinstance(handle, str) else handle
        bw = h.weights
        return int(bw.planes.numel() * 4 + bw.scale.numel() * 4
                   + bw.col_sum.numel() * 4)

    def residency_stats(self) -> dict:
        """Pool capacity/eviction stats plus the engine's staged-layer
        count (matrices whose simulator rows are staged) and the
        fault-recovery ladder's live counters — the serving layer surfaces
        this."""
        stats = self.pool.stats()
        stats["staged_layers"] = len(self._staged)
        stats["registered"] = len(self.handles)
        stats["fault_corrupted"] = self.fault_corrupted
        stats["fault_detected"] = self.fault_detected
        stats["fault_retries"] = self.fault_retries
        stats["fault_host_fallbacks"] = self.fault_host_fallbacks
        stats["fault_quarantines"] = self.fault_quarantines
        stats["fault_restages"] = self.fault_restages
        stats["degraded_layers"] = sorted(self._degraded)
        if self._fault_session is not None:
            stats.update(self._fault_session.stats())
        return stats


class EngineLinear:
    """Routes `models.layers.dense`'s BitplaneWeights branch through an
    `MVDRAMEngine` — the hook `ServeEngine` installs so every quantized
    linear of the serving model goes through the engine. Passed wherever a
    `dense(..., impl=...)` goes."""

    def __init__(self, engine: MVDRAMEngine,
                 backend: Union[Backend, str, None] = None):
        self.engine = engine
        self.backend = _backends.get_backend(backend)

    def __call__(self, x: torch.Tensor, w: BitplaneWeights,
                 act_bits: Optional[int] = None) -> torch.Tensor:
        return self.engine.linear(x, w, act_bits=act_bits,
                                  backend=self.backend)

    def group(self, x: torch.Tensor, ws: Sequence[BitplaneWeights],
              act_bits: Optional[int] = None) -> tuple:
        """The grouped-linear hook `models.layers.dense_group` probes for:
        q/k/v (and up/gate) fuse into one launch on the kernel backend."""
        return self.engine.linear_group(x, ws, act_bits=act_bits,
                                        backend=self.backend)
