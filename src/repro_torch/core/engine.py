"""MVDRAMEngine — the system-level orchestrator (paper §IV): port of the
residency half of the JAX package's `core/engine.py`, around explicit
two-phase PLACE-THEN-EXECUTE residency sessions.

Phase ① — place (`register` / `register_packed`): build the partition plan
(N ≤ 128 per subarray, q·M per column budget, §VII "Matrix Partitioning")
and give the matrix a PERSISTENT home in the DRAM geometry: the engine's
`DramPool` (or a multi-DIMM `FabricPool`) carves subarray row ranges out of
each (channel, bank) for the matrix's tiles. ALL the linears of a model
co-reside at once; the pool rotates the §VII bank cursor across
registrations so co-resident layers stagger over the rank.

Phase ② — `compile([...handles...])` fuses a decode step's SEQUENCE of
resident GeMVs into one `GemvProgram` whose interleaved command schedule
extends the wave slots across layers (`pud.schedule.schedule_program`), and
`price_program` prices one step of it on the DDR4 model
(`pud.timing.price_program`): a host-side calculation in Python floats, in
the JAX package's order, so every price equals its.

On the card, `GemvProgram.run_kernel` runs the whole decode block as ONE B2
launch (`kernels/bitplane_gemv/program.py:run_program`, the CUDA
`group_kernel` over a member table that reads every leaf in place), bitwise
equal to per-leaf B1.

The simulator's side — `GemvProgram.run`, `FabricProgram.run`, the staged
rows, `gemv`, the sim backend, faults and recovery, the column-sharded
registration — comes with the simulator's port. Serving's per-linear
routing (`linear`, `linear_group`, `packed_group`, `EngineLinear`) is the
port's earlier slices'.
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
from .pud.fabric import FabricPool
from .pud.gemv import (CommandTemplates, PudGeometry, build_templates,
                       conventional_pud_cost, mvdram_gemv_cost)
from .pud.residency import DramPool, Placement
from .pud.schedule import ProgramSchedule, schedule_program
from .pud.timing import (CXL_TIER, DDR4_2400, DDR4_ENERGY, CpuBaseline,
                         CxlModel, DDR4Model, EnergyModel, FabricCost,
                         GpuBaseline, ProgramCost, combine_fabric_costs,
                         price_gemv, price_program)
from .quant import QuantSpec, QuantizedTensor, quantize_weights

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


def _lane_mask_arg(lane_mask, b: int):
    """Validate a lane-occupancy mask against the launch capacity: (B,)
    bool with at least one active lane (an all-masked tick has nothing to
    execute — skip it instead). None passes through: all lanes active."""
    if lane_mask is None:
        return None
    m = np.asarray(lane_mask, dtype=bool)
    if m.shape != (b,):
        raise ValueError(
            f"lane_mask shape {m.shape} does not match the lane batch "
            f"B={b}")
    if not m.any():
        raise ValueError(
            "lane_mask has no active lanes — skip the tick instead of "
            "executing an empty one")
    return m


class GemvProgram:
    """A decode step's sequence of resident GeMVs, compiled once.

    Built by `MVDRAMEngine.compile`: the layers' tile grids fuse into one
    interleaved wave schedule (`ProgramSchedule` — concurrency groups like
    q/k/v or up/gate share boundary waves). `price` prices one step of it
    on the DDR4 model; `run_kernel` runs the whole block on the card as
    one B2 launch.
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
        self.kernel_steps = 0       # decode blocks run via run_kernel()
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
              usable_cols: Optional[int] = None) -> ProgramCost:
        return self.engine.price_program(self, bit_density=bit_density,
                                         batch=batch,
                                         usable_cols=usable_cols)


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


class FabricProgram:
    """A decode block compiled across the DRAM fabric.

    `MVDRAMEngine.compile` on a `FabricPool` engine partitions the block
    by residency: each DIMM's co-resident layers become one per-module
    `GemvProgram` part (waves fused within the module exactly as on a
    single pool), and spilled layers become single-layer parts that page
    in from the capacity tier. Parts execute their OWN module's channels,
    so the combined price overlaps their compute
    (`MVDRAMEngine.price_fabric`). On the card each resident part's
    program runs as one B2 launch (`parts[k].prog.run_kernel`)."""

    def __init__(self, engine: "MVDRAMEngine", handles: tuple,
                 groups: tuple, b_max: Optional[int], parts: tuple):
        self.engine = engine
        self.handles = handles
        self.groups = groups
        self.b_max = b_max
        self.parts = parts

    @property
    def layers(self) -> int:
        return len(self.handles)

    def __repr__(self):
        spilled = sum(1 for p in self.parts if p.prog is None)
        return (f"<FabricProgram {self.layers} layers, "
                f"{len(self.parts)} parts ({spilled} awaiting page-in), "
                f"{self.engine.pool.dimms} dimms>")

    def price(self, bit_density: float = 0.5, batch: int = 1,
              usable_cols: Optional[int] = None) -> FabricCost:
        return self.engine.price_fabric(self, bit_density=bit_density,
                                        batch=batch,
                                        usable_cols=usable_cols)


class MVDRAMEngine:
    """Processor-DRAM co-designed GeMV engine: the residency session, its
    DDR4 pricing, and the routing of every lane-batched quantized linear
    of a serving model (with the member tables of its fused B2
    launches)."""

    def __init__(self, geom: PudGeometry = PudGeometry(),
                 timing: DDR4Model = DDR4_2400,
                 cpu: CpuBaseline = CpuBaseline(),
                 gpu: GpuBaseline = GpuBaseline(),
                 sparsity: bool = True,
                 pool: Optional[Union[DramPool, FabricPool]] = None,
                 on_full: str = "evict",
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
        self.handles: dict[str, GemvHandle] = {}
        # leaf_key + (act_bits,) → (handle name, leaf): a leaf the serving
        # layer already placed is found again by identity, never placed
        # twice; entries are pruned on eviction
        self._leaf_names: dict[tuple, tuple] = {}
        self.routed_linears = 0   # serving linears routed through linear()
        # (act_bits, leaf keys) → (leaves, member table)
        self._packed: dict = {}
        # pool-driven evictions (LRU on_full, replace) invalidate the
        # handle's placement just like engine.evict
        self.pool.evict_listeners.append(self._on_pool_evict)
        # pool compaction and fabric migration move resident rows: follow
        # the placement update
        self.pool.move_listeners.append(self._on_pool_move)

    def _on_pool_evict(self, name: str, placement: Placement) -> None:
        self._leaf_names = {k: v for k, v in self._leaf_names.items()
                            if v[0] != name}
        h = self.handles.get(name)
        if h is not None and h.placement is placement:
            h.placement = None

    def _on_pool_move(self, name: str, old: Placement,
                      new: Placement) -> None:
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
                 wq: Optional[QuantizedTensor] = None) -> GemvHandle:
        """Shared tail of both registration entries: one plan/template/
        placement/handle construction."""
        p = a_spec.bits if a_spec is not None else 16
        plan = make_plan(m=bw.m, n=bw.n, q=bw.bits, p=p, geom=self.geom)
        templates = (build_templates(plan.n_sub, p)
                     if a_spec is not None else None)
        chunk_rows, col_chunks = self._sim_grid(bw.n, bw.m, bw.bits)
        placement = self.pool.place(
            name, chunk_rows, col_chunks,
            replace=(name in self.handles or self.pool.is_resident(name)),
            on_full=self.on_full)
        h = GemvHandle(name=name, weights=bw, plan=plan, a_spec=a_spec,
                       templates=templates, placement=placement, _wq=wq)
        self.handles[name] = h
        if a_spec is not None:
            self._leaf_names[leaf_key(bw) + (a_spec.bits,)] = (name, bw)
        return h

    def evict(self, handle: Union[GemvHandle, str]) -> Placement:
        """Retire a matrix from residency (its handle stays registered
        for the kernel path); the handle's placement drops via the pool's
        evict listener — the same path pool-driven LRU evictions take."""
        h = self.handles[handle] if isinstance(handle, str) else handle
        return self.pool.evict(h.name)

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
                      spill_restage_bits: int = 0,
                      spill_restages: int = 0) -> ProgramCost:
        """DDR4 price of one fused decode step. Defaults to the SIMULATED
        column width so `staged_bits` reconciles exactly with the pool's
        placement accounting; pass `usable_cols=geom.real_cols` for
        paper-scale pricing — the schedule is then re-fused over the
        real-width tile grids with the SAME concurrency groups."""
        cols = usable_cols if usable_cols is not None else \
            self.geom.subarray_cols
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
                             spill_restage_bits=spill_restage_bits,
                             spill_restages=spill_restages,
                             spill=self.cxl, energy=self.energy)

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
                     usable_cols: Optional[int] = None) -> FabricCost:
        """DDR4 price of one fabric decode step: each part priced like a
        single-pool program over its OWN module's command bus, then
        combined — per-module parts overlap, host-side terms sum. Spilled
        parts price their restage from the spill ledger."""
        if not isinstance(self.pool, FabricPool):
            raise ValueError(
                f"price_fabric needs a FabricPool engine, pool is "
                f"{type(self.pool).__name__}")
        costs, part_dimms = [], []
        for part in program.parts:
            sb = sum(self.pool.spill_entry(h.name).bits
                     for h in part.handles
                     if self.pool.is_spilled(h.name))
            sr = sum(1 for h in part.handles
                     if self.pool.is_spilled(h.name))
            prog_k = part.prog or self._provisional_part_prog(part)
            costs.append(self.price_program(
                prog_k, bit_density=bit_density, batch=batch,
                usable_cols=usable_cols,
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
        count and the fault-recovery ladder's counters, as the JAX engine
        reports them with no fault model: the simulator's staged rows and
        its fault injection come with the simulator's port, so these stay
        0 here."""
        stats = self.pool.stats()
        stats["staged_layers"] = 0
        stats["registered"] = len(self.handles)
        for k in ("fault_corrupted", "fault_detected", "fault_retries",
                  "fault_host_fallbacks", "fault_quarantines",
                  "fault_restages"):
            stats[k] = 0
        stats["degraded_layers"] = []
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
