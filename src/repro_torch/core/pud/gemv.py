"""In-DRAM GeMV via on-the-fly vector encoding (paper §V) on the horizontal
matrix layout (paper §VI): port of the JAX package's `core/pud/gemv.py`.

The execution model, per subarray tile (n_sub reduction rows × m_sub outputs,
q weight bits, p activation bits):

  load      host writes the weight-bit planes once (amortized over inference):
            bitline m*q+i, row j  holds  W^(i)[j, m]  (+ inverted rows for the
            dual-track adder).
  encode    the PROCESSOR scans the activation codes a_u[j] bit-by-bit and
            emits `acc += matrix_row[j] << k` exactly when bit k of a_u[j] is
            set (on-the-fly vector encoding). A zero bit emits either a
            constant-zero add (conventional) or NOTHING (bit-sparsity
            optimization, §V-D).
  execute   dual-track MAJ3/MAJ5 ripple adds inside the subarray; every
            bitline accumulates in parallel, so one add serves all m_sub
            outputs × q weight bits at once (qM-way parallelism, §VI-D).
  readout   the processor reads the r accumulator rows ROW-WISE and
            shift-accumulates  o_m = Σ_b 2^b Σ_i 2^i acc_b[m*q+i].

Integer partial sums from all tiles are aggregated with the zero-point
correction of `core.quant.quantized_gemv_reference`.

Template architecture (§V-C/§V-D): the command stream of one add at bit
offset k is STATIC, so `build_templates(n_sub, p)` precomputes one
`BitOffsetTemplate` per offset, once per tile shape; per inference the
processor only SELECTS templates by popcount. The micro-op-by-micro-op path
is retained behind `naive=True` as the bit-exact oracle, and the sequential
per-tile path behind `wave=False`.

Wave execution (§VII): tiles are placed on (channel, bank, wave) slots by
`schedule.schedule_tiles` and whole waves advance through one
`device.BankArray` step. Cross-request wave sharing runs B activation
vectors against the same resident rows (`mvdram_gemv_batched`). Residency
sessions stage a matrix once (`stage_matrix`) and execute any number of
launches against the staged rows; a compiled decode program executes
wave-major across layers (`stage_program` / `execute_program`).

Where things live. The bit state — bank rows, the float32 matrix blocks
the code matmul reads, accumulators, partials and ABFT checksums — is torch
on the device of the weight codes (`wq.values.device`: the card in serving,
the CPU in the tests). Encoding, template selection and the command ledger
are numpy on the host: they read the activation codes, which cross to the
host once per launch (one copy for all layers of a fused program). The §V-D
linearity collapse — the p per-offset ripple-carries as ONE product of the
codes with the resident rows — runs as a float32 batched matmul with TF32
off (`adder.code_matmul`), exact because no sum reaches 2^24. The float
epilogue (`_aggregate_host`) follows the JAX package's order in float64, so
outputs on the CPU equal its simulator's bit for bit.

A column-sharded GeMV (`engine.MVDRAMEngine.gemv_sharded`) runs each
shard's resident launch here and scatters the disjoint columns on the host.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from ..quant import QuantizedTensor
from .adder import (_bit_weights, add_row_at_offset, add_rows_batched,
                    adder_cost, clear_accumulator, code_matmul,
                    write_accumulator_wave)
from .device import _COUNT_FIELDS, BankArray, OpCounts, Subarray
from .faults import FaultSession, FaultTrace
from .layout import HorizontalLayout, VerticalLayout, accumulator_width
from .schedule import (BatchSchedule, ProgramSchedule,  # noqa: F401 (re-export)
                       PudGeometry, WaveSchedule, schedule_batch,
                       schedule_tiles)


def _host_codes(values) -> np.ndarray:
    """Unsigned codes (a tensor on any device, or an array) as a host
    uint32 array — what encoding and template selection read."""
    if isinstance(values, torch.Tensor):
        return values.cpu().numpy().astype(np.uint32)
    return np.asarray(values, dtype=np.uint32)


def _codes_on(values, device) -> torch.Tensor:
    """Unsigned codes as an integer tensor on `device`."""
    if isinstance(values, torch.Tensor):
        return values.to(device)
    return torch.as_tensor(np.asarray(values).astype(np.int64),
                           device=device)


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


# ---------------------------------------------------------------------------
# On-the-fly encoding
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CommandPlan:
    """The data-dependent part of the command stream for one tile.

    adds:     (j, k) pairs — `acc += matrix_row[j] << k`; emitted only for set
              activation bits when `sparsity` (otherwise zero-adds included
              with src=None).
    skipped:  count of zero bits elided by the sparsity optimization.
    """

    adds: list
    skipped: int
    n: int
    p: int


def _activation_bits(a_codes, p: int) -> np.ndarray:
    """(..., n) uint codes → (..., n, p) boolean bit matrix, one pass —
    leading axes (the lane batch) ride the same vectorized extraction."""
    a = _host_codes(a_codes)
    return ((a[..., None] >> np.arange(p, dtype=np.uint32)) & 1).astype(bool)


def encode_commands(a_codes, p: int, sparsity: bool = True) -> CommandPlan:
    """Scan activation codes bit-serially → add schedule (paper §V-C).

    O(N·p) host work, done as one vectorized bit extraction; with
    `sparsity`, zero bits are skipped entirely. Add order is j-major,
    k-minor.
    """
    bits = _activation_bits(a_codes, p)
    n = bits.shape[0]
    if sparsity:
        js, ks = np.nonzero(bits)           # row-major ⇒ j-major, k-minor
        adds = list(zip(js.tolist(), ks.tolist()))
        return CommandPlan(adds=adds, skipped=n * p - len(adds), n=n, p=p)
    js = np.repeat(np.arange(n), p).tolist()
    ks = np.tile(np.arange(p), n).tolist()
    mask = bits.ravel().tolist()
    adds = [(j if set_ else None, k) for j, k, set_ in zip(js, ks, mask)]
    return CommandPlan(adds=adds, skipped=0, n=n, p=p)


# ---------------------------------------------------------------------------
# Static command templates (paper §V-C) + popcount selection (§V-D)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BitOffsetTemplate:
    """Static command skeleton for any add at bit offset k.

    The stream is data-independent: chain_len = r − k ripple steps, each a
    fixed RowCopy/MAJ3/MAJ5 sequence (`adder.adder_cost`). Only the matrix
    row address is patched in at issue time.
    """

    offset: int
    chain_len: int
    cost: OpCounts              # per-add command cost


@dataclasses.dataclass(frozen=True)
class CommandTemplates:
    """Per-bit-offset templates for one (n_sub, p) tile shape.

    Built once per shape and cached process-wide (`build_templates`);
    `engine.GemvHandle` holds the instance for its registered matrix so no
    per-inference work rebuilds command streams.
    """

    n_sub: int
    p: int
    r: int
    offsets: tuple              # (p,) BitOffsetTemplate


@functools.lru_cache(maxsize=None)
def build_templates(n_sub: int, p: int) -> CommandTemplates:
    r = accumulator_width(n_sub, p)
    offs = tuple(BitOffsetTemplate(offset=k, chain_len=r - k,
                                   cost=adder_cost(r - k))
                 for k in range(p))
    return CommandTemplates(n_sub=n_sub, p=p, r=r, offsets=offs)


@dataclasses.dataclass
class TemplatePlan:
    """Popcount-selected instantiation of the templates for one activation
    vector — the only data-dependent state built per inference.

    rows_per_offset[k]: matrix-row indices j whose activation bit k is set
                        (template k is issued once per entry).
    zero_slots[k]:      zero-bit count at offset k — skipped under
                        `sparsity`, issued as zero-row adds otherwise.
    """

    templates: CommandTemplates
    rows_per_offset: tuple
    zero_slots: tuple
    sparsity: bool

    @property
    def skipped(self) -> int:
        return int(sum(self.zero_slots)) if self.sparsity else 0

    @property
    def popcounts(self) -> tuple:
        return tuple(len(r) for r in self.rows_per_offset)


def select_templates(a_codes, templates: CommandTemplates,
                     sparsity: bool = True) -> TemplatePlan:
    """Vectorized §V-D selection: one bit extraction + p nonzero scans."""
    bits = _activation_bits(a_codes, templates.p)
    rows = tuple(np.nonzero(bits[:, k])[0] for k in range(templates.p))
    zeros = tuple(int(bits.shape[0] - r.shape[0]) for r in rows)
    return TemplatePlan(templates=templates, rows_per_offset=rows,
                        zero_slots=zeros, sparsity=sparsity)


@dataclasses.dataclass
class BatchTemplatePlan:
    """§V-D selection for a whole (B, n) lane batch, built in ONE pass.

    The command executor only needs two data-dependent quantities per
    request: the raw activation CODES (the §V-D linearity collapse feeds
    them straight into one matmul — Σ_k 2^k·bit_k IS the code) and the
    per-offset POPCOUNTS (command billing). `plan(b)` materializes a
    classic per-request `TemplatePlan` for the per-tile oracle paths.
    """

    templates: CommandTemplates
    codes: np.ndarray          # (B, n) uint32 raw activation codes
    popcounts: np.ndarray      # (B, p) set bits per offset
    zero_slots: np.ndarray     # (B, p) zero bits per offset
    sparsity: bool

    @property
    def batch(self) -> int:
        return self.codes.shape[0]

    @property
    def skipped(self) -> np.ndarray:
        """(B,) zero bits elided per request (0 when sparsity is off)."""
        if not self.sparsity:
            return np.zeros(self.batch, dtype=np.int64)
        return self.zero_slots.sum(axis=1)

    def plan(self, b: int) -> TemplatePlan:
        return select_templates(self.codes[b], self.templates, self.sparsity)


def select_templates_batched(a_codes, templates: CommandTemplates,
                             sparsity: bool = True) -> BatchTemplatePlan:
    """Vectorized §V-D selection over the batch axis: one bit extraction +
    one reduction serve all B requests."""
    codes = _host_codes(a_codes)
    if codes.ndim != 2:
        raise ValueError(
            f"batched selection takes (B, n) codes, got shape {codes.shape}")
    bits = _activation_bits(codes, templates.p)          # (B, n, p)
    popc = bits.sum(axis=1, dtype=np.int64)              # (B, p)
    return BatchTemplatePlan(templates=templates, codes=codes,
                             popcounts=popc,
                             zero_slots=codes.shape[1] - popc,
                             sparsity=sparsity)


# ---------------------------------------------------------------------------
# Single-subarray execution (bit-exact simulation)
# ---------------------------------------------------------------------------

def load_matrix(sub: Subarray, lay: HorizontalLayout,
                w_codes, col_base: int = 0) -> None:
    """Preload weight bit-planes (+ complements) into the matrix rows.

    w_codes: (n_sub, m_sub) unsigned codes with q bits each.
    Placed at bitline col_base + m*q + i (Fig. 10). Constant rows written too.
    """
    n_sub, m_sub = w_codes.shape
    cols, dev = sub.cols, sub.device
    sub.host_write_row(lay.zero_row, torch.zeros(cols, dtype=torch.uint8,
                                                 device=dev))
    sub.host_write_row(lay.one_row, torch.ones(cols, dtype=torch.uint8,
                                               device=dev))
    rows = torch.zeros((n_sub, cols), dtype=torch.uint8, device=dev)
    w = _codes_on(w_codes, dev).to(torch.int32)
    at = torch.arange(m_sub, device=dev) * lay.q
    for i in range(lay.q):
        rows[:, col_base + at + i] = ((w >> i) & 1).to(torch.uint8)
    for j in range(n_sub):
        sub.host_write_row(lay.matrix_rows[j], rows[j])
        sub.host_write_row(lay.inv_matrix_rows[j], 1 - rows[j])


def execute_plan(sub: Subarray, lay: HorizontalLayout,
                 plan: CommandPlan) -> None:
    """Issue the encoded command stream micro-op by micro-op (naive oracle)."""
    clear_accumulator(sub, lay)
    for j, k in plan.adds:
        if j is None:  # conventional zero-add (sparsity disabled)
            add_row_at_offset(sub, lay, lay.zero_row, lay.one_row,
                              offset=k, chain_len=lay.r - k)
        else:
            add_row_at_offset(sub, lay, lay.matrix_rows[j],
                              lay.inv_matrix_rows[j],
                              offset=k, chain_len=lay.r - k)


def execute_plan_templated(sub: Subarray, lay: HorizontalLayout,
                           tplan: TemplatePlan) -> None:
    """Vectorized compute phase: one batched ripple-carry per bit offset.

    Bit-identical accumulator state and identical OpCounts vs
    `execute_plan` on the same activation vector.
    """
    if tplan.templates.r != lay.r:
        raise ValueError(
            f"template/layout accumulator mismatch: template plan built "
            f"for r={tplan.templates.r}, layout has r={lay.r}")
    clear_accumulator(sub, lay)
    for k, tmpl in enumerate(tplan.templates.offsets):
        add_rows_batched(sub, lay, tplan.rows_per_offset[k], offset=k,
                         n_zero_adds=(0 if tplan.sparsity
                                      else tplan.zero_slots[k]))


def _decode_rows(rows: torch.Tensor) -> torch.Tensor:
    """(r, cols) accumulator bit rows → (cols,) int64 column values."""
    w = _bit_weights(rows.shape[0], rows.device)
    return (rows.to(torch.int64) * w[:, None]).sum(dim=0)


def read_outputs(sub: Subarray, lay: HorizontalLayout, m_sub: int,
                 col_base: int = 0) -> torch.Tensor:
    """Row-wise readout + host shift-accumulate (no bit transposition).

    Returns int64 (m_sub,) = Σ_j a_u[j] · w_u[j, m] for this tile.
    """
    dev = sub.device
    rows = torch.stack([sub.host_read_row(r) for r in lay.acc_rows])
    col_vals = _decode_rows(rows)                                  # (cols,)
    m_idx = col_base + torch.arange(m_sub, device=dev)[:, None] * lay.q
    i_idx = torch.arange(lay.q, device=dev)[None, :]
    shifts = torch.arange(lay.q, dtype=torch.int64, device=dev)
    out = (col_vals[m_idx + i_idx] << shifts).sum(dim=1)
    # r row-reads already counted by host_read_row; the shift-accumulate is
    # m_sub·q integer ops on the host (§VI-C).
    sub.counts.host_int_ops += m_sub * lay.q
    return out


def _plan_for(a_codes, n_sub: int, p: int, sparsity: bool, naive: bool):
    """Build the per-chunk execution plan once (shared by all column tiles)."""
    if naive:
        return encode_commands(a_codes, p, sparsity)
    return select_templates(a_codes, build_templates(n_sub, p), sparsity)


def _run_plan(sub: Subarray, lay: HorizontalLayout, plan) -> None:
    if isinstance(plan, TemplatePlan):
        execute_plan_templated(sub, lay, plan)
    else:
        execute_plan(sub, lay, plan)


def mvdram_gemv_subarray(w_codes, a_codes, q: int, p: int,
                         sparsity: bool = True,
                         geom: PudGeometry = PudGeometry(),
                         reliable_cols=None, col_base: int = 0,
                         naive: bool = False, plan=None):
    """One-tile MVDRAM GeMV: returns (partials int64 (m,), runtime OpCounts,
    preload OpCounts, Subarray). The subarray lives on the device of
    `w_codes` (the CPU for a host array).

    `naive=True` executes command-by-command (the oracle); the default path
    runs the template-selected vectorized stream. `plan` (a CommandPlan or
    TemplatePlan matching `naive`) lets callers reuse one encoding across
    column tiles.
    """
    n_sub, m_sub = w_codes.shape
    dev = w_codes.device if isinstance(w_codes, torch.Tensor) else "cpu"
    lay = HorizontalLayout(n_sub=n_sub, m_sub=m_sub, q=q, p=p,
                           subarray_rows=geom.subarray_rows,
                           subarray_cols=geom.subarray_cols - col_base)
    sub = Subarray(rows=geom.subarray_rows, cols=geom.subarray_cols,
                   reliable_cols=reliable_cols, device=dev)
    load_matrix(sub, lay, w_codes, col_base)
    preload = sub.counts
    sub.counts = OpCounts()
    if plan is None:
        plan = _plan_for(a_codes, n_sub, p, sparsity, naive)
    _run_plan(sub, lay, plan)
    out = read_outputs(sub, lay, m_sub, col_base)
    return out, sub.counts, preload, sub


# ---------------------------------------------------------------------------
# Reliable-column placement (paper §VII, Table I)
# ---------------------------------------------------------------------------

def usable_output_slots(reliable, q: int) -> np.ndarray:
    """Starts of non-overlapping runs of q consecutive reliable columns.

    MVDRAM only places an output's q weight-bit columns on such runs; the gaps
    are the "slight data transfer overhead for unused columns" of §VII.
    """
    if isinstance(reliable, torch.Tensor):
        reliable = reliable.cpu().numpy()
    starts, run, i = [], 0, 0
    n = reliable.shape[0]
    while i < n:
        if reliable[i]:
            run += 1
            if run == q:
                starts.append(i - q + 1)
                run = 0
        else:
            run = 0
        i += 1
    return np.asarray(starts, dtype=np.int64)


# ---------------------------------------------------------------------------
# Full GeMV: partition across subarrays, aggregate on host
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TileReport:
    n_chunks: int
    col_chunks: int
    tiles: int
    runtime: OpCounts
    preload: OpCounts
    skipped_bits: int
    r_bits: int
    aggregate_bits: int  # output bits crossing the data bus
    # Wave-level accounting (§VII placement): tiles serialize in `waves`
    # across the channels × banks rank; a wave is bound by its slowest bank,
    # so `wave_max[w]` keeps the field-wise max OpCounts over wave w's tiles.
    # `tile_runtime`/`tile_preload` hold the per-tile counts in tile order —
    # the wave path and the sequential oracle produce identical entries.
    waves: int = 0
    wave_max: tuple = ()
    tile_runtime: tuple = ()
    tile_preload: tuple = ()


@dataclasses.dataclass
class BatchReport:
    """Shared-wave accounting for one batched launch of B GeMVs.

    `requests[b]` is a full per-request `TileReport`, bit-identical —
    outputs AND per-tile OpCounts — to what `mvdram_gemv` reports for
    request b alone. The batch-level fields record the PHYSICAL shared
    execution instead:

      shared_preload   weight/constant staging summed over tiles, counted
                       ONCE.
      runtime          Σ_b per-request runtime: the B data-dependent command
                       streams time-share each bank within its wave slot.
      wave_max[w]      max over wave w's tiles of the B-summed per-tile ops —
                       the slowest bank bounds the shared wave
                       (`timing.simulated_wave_time` prices this directly).
    """

    batch: int
    schedule: BatchSchedule
    requests: tuple            # (B,) TileReport
    shared_preload: OpCounts
    runtime: OpCounts
    wave_max: tuple
    # Residency: a launch against already-resident rows pays ZERO staging
    # (`shared_preload` empty, `resident` True); `staged` records the
    # one-time placement staging those rows cost.
    resident: bool = False
    staged: Optional[OpCounts] = None
    # ABFT fault observability: None on fault-free launches; a `FaultTrace`
    # when a `faults.FaultSession` rode along.
    fault: Optional[FaultTrace] = None

    @property
    def tiles(self) -> int:
        return self.schedule.tiles

    @property
    def waves(self) -> int:
        return self.schedule.waves

    @property
    def unshared_preload(self) -> OpCounts:
        """Staging traffic B independent passes would pay."""
        return self.shared_preload.scaled(self.batch)

    @property
    def amortized_preload_bits(self) -> int:
        """DRAM-write bits the wave sharing saved vs B sequential passes."""
        return (self.batch - 1) * self.shared_preload.host_bits_written


def mvdram_gemv(aq: QuantizedTensor, wq: QuantizedTensor,
                sparsity: bool = True,
                geom: PudGeometry = PudGeometry(),
                reliable_cols=None, naive: bool = False,
                templates: Optional[CommandTemplates] = None,
                wave: Optional[bool] = None):
    """Full MVDRAM GeMV in the integer domain + host-side dequantization,
    on the device of the weight codes.

    Equal to `core.quant.quantized_gemv_reference` up to its float32
    rounding. Weight group scales must align with subarray partitions:
    G == 1 or group_size % n_sub == 0.

    Each reduction chunk is encoded ONCE (plan + skipped count shared by all
    its column tiles). `templates` short-circuits the template build for
    full-size chunks; `naive=True` runs the retained micro-op oracle end to
    end. `wave` selects wave-parallel execution (default when not naive);
    `wave=False` runs the retained sequential per-tile path — the bit-exact
    oracle for outputs AND per-tile OpCounts.

    Batched entry: 2-D (B, N) activation codes dispatch to
    `mvdram_gemv_batched` — B requests in shared waves, returning a
    ((B, M) f32, `BatchReport`) pair.
    """
    a_u = _host_codes(aq.values)
    if a_u.ndim == 2:
        if naive or wave is False:
            raise ValueError(
                "batched GeMV executes shared waves only; the per-request "
                "oracle is B separate mvdram_gemv calls (naive/wave=False)")
        return mvdram_gemv_batched(aq, wq, sparsity=sparsity, geom=geom,
                                   reliable_cols=reliable_cols,
                                   templates=templates)
    if a_u.ndim != 1:
        raise ValueError(
            f"GeMV takes a (N,) activation vector or a (B, N) batch, got "
            f"ndim={a_u.ndim}")
    if wave is None:
        wave = not naive
    if wave and naive:
        raise ValueError("the naive micro-op oracle is per-tile only; "
                         "use wave=False (or omit wave) with naive=True")
    w_u = wq.values
    dev = w_u.device
    n, m = w_u.shape
    q, p = wq.spec.bits, aq.spec.bits
    n_sub, n_chunks, gs, g = _partition_checks(n, wq, geom)
    reliable_cols = _host_mask(reliable_cols)

    slots = _output_slots(reliable_cols, q, geom)
    m_per_tile = slots.shape[0]
    col_chunks = math.ceil(m / m_per_tile)
    sched = schedule_tiles(n_chunks, col_chunks, geom)

    # Encode each reduction chunk ONCE (plan shared by all its column tiles).
    plans, skipped, r_bits = _chunk_plans(a_u, n, n_sub, p, sparsity, naive,
                                          templates)

    if wave:
        partials, rt_arr, pre_arr = _gemv_waves(
            w_u, q, p, geom, plans, sched, slots, reliable_cols, n_sub, m)
        tile_rt = [OpCounts(*r) for r in rt_arr.tolist()]
        tile_pre = [OpCounts(*r) for r in pre_arr.tolist()]
    else:
        partials = torch.zeros((n_chunks, m), dtype=torch.int64, device=dev)
        tile_rt = [None] * sched.tiles
        tile_pre = [None] * sched.tiles
        for ci in range(n_chunks):
            j0, j1 = ci * n_sub, min((ci + 1) * n_sub, n)
            for mi in range(col_chunks):
                m0, m1 = mi * m_per_tile, min((mi + 1) * m_per_tile, m)
                w_tile = w_u[j0:j1, m0:m1]
                if reliable_cols is None:
                    out, rt, pre, _ = mvdram_gemv_subarray(
                        w_tile, a_u[j0:j1], q, p, sparsity, geom,
                        plan=plans[ci], naive=naive)
                else:
                    out, rt, pre = _gemv_tile_on_slots(
                        w_tile, a_u[j0:j1], q, p, sparsity, geom,
                        reliable_cols, slots[: m1 - m0], plan=plans[ci])
                partials[ci, m0:m1] = out
                tile_rt[ci * col_chunks + mi] = rt
                tile_pre[ci * col_chunks + mi] = pre
        rt_arr = _counts_matrix(tile_rt)
        pre_arr = _counts_matrix(tile_pre)

    # Totals + per-wave maxima in two reductions (waves are contiguous tile
    # ranges under the round-robin placement).
    runtime = OpCounts(*map(int, rt_arr.sum(axis=0)))
    preload = OpCounts(*map(int, pre_arr.sum(axis=0)))
    wave_max = _wave_maxima(rt_arr, sched.waves, geom.parallel_tiles)

    out = _aggregate_host(partials, _codes_on(aq.values, dev), w_u, aq, wq,
                          n_chunks, n_sub, gs, g)
    out = out * aq.scale.to(device=dev, dtype=torch.float64).reshape(-1)[0]

    report = TileReport(
        n_chunks=n_chunks, col_chunks=col_chunks,
        tiles=n_chunks * col_chunks, runtime=runtime, preload=preload,
        skipped_bits=skipped, r_bits=r_bits,
        aggregate_bits=n_chunks * col_chunks * r_bits * geom.subarray_cols,
        waves=sched.waves, wave_max=tuple(wave_max),
        tile_runtime=tuple(tile_rt), tile_preload=tuple(tile_pre))
    return out.to(torch.float32), report


# -- shared helpers (single + batched entries) --------------------------------

def _host_mask(reliable_cols) -> Optional[np.ndarray]:
    if reliable_cols is None:
        return None
    if isinstance(reliable_cols, torch.Tensor):
        return reliable_cols.cpu().numpy().astype(bool)
    return np.asarray(reliable_cols).astype(bool)


def _partition_checks(n: int, wq: QuantizedTensor, geom: PudGeometry):
    n_sub = min(geom.n_sub_max, n)
    n_chunks = math.ceil(n / n_sub)
    g = wq.scale.shape[0]
    if n % g:
        raise ValueError(
            f"weight scale groups must tile the reduction dim: N={n} is not "
            f"divisible by G={g} groups (group_size must divide N)")
    gs = n // g
    if g > 1 and gs % n_sub:
        raise ValueError(f"group size {gs} must be a multiple of n_sub {n_sub}")
    return n_sub, n_chunks, gs, g


def _output_slots(reliable_cols, q: int, geom: PudGeometry) -> np.ndarray:
    if reliable_cols is not None:
        slots = usable_output_slots(reliable_cols[:geom.subarray_cols], q)
    else:
        slots = np.arange(geom.subarray_cols // q) * q
    if slots.shape[0] == 0:
        raise ValueError(
            f"no usable output slots: need a run of q={q} consecutive "
            f"reliable columns in the first {geom.subarray_cols} bitlines")
    return slots


def _chunk_plans(a_u: np.ndarray, n: int, n_sub: int, p: int, sparsity: bool,
                 naive: bool, templates: Optional[CommandTemplates]):
    """Encode one activation vector per reduction chunk; returns
    (plans, skipped bit count, max accumulator width)."""
    plans, skipped, r_bits = [], 0, 0
    for ci in range(math.ceil(n / n_sub)):
        j0, j1 = ci * n_sub, min((ci + 1) * n_sub, n)
        n_c = j1 - j0
        if not naive and templates is not None and templates.n_sub == n_c:
            plan = select_templates(a_u[j0:j1], templates, sparsity)
        else:
            plan = _plan_for(a_u[j0:j1], n_c, p, sparsity, naive)
        plans.append(plan)
        skipped += plan.skipped    # threaded out — no per-tile re-encode
        r_bits = max(r_bits, accumulator_width(n_c, p))
    return plans, skipped, r_bits


def _counts_matrix(counts) -> np.ndarray:
    """(tiles,) OpCounts sequence → (tiles, fields) int64 matrix."""
    return np.asarray([[getattr(c, f) for f in _COUNT_FIELDS]
                       for c in counts], dtype=np.int64)


def _wave_maxima(rt_arr: np.ndarray, waves: int, parallel_tiles: int):
    return [OpCounts(*map(int, rt_arr[w * parallel_tiles:
                                      (w + 1) * parallel_tiles].max(axis=0)))
            for w in range(waves)]


def _aggregate_host(partials, a_u, w_u, aq, wq, n_chunks, n_sub, gs, g):
    """Host aggregation with zero-point correction (paper §II-C2 / quant.py).

    Broadcasts over any leading batch axes: partials (…, n_chunks, m) int64,
    a_u (…, n) and w_u (n, m) codes, all on one device. Returns the
    per-group-scaled float64 output WITHOUT the activation scale (caller
    applies its own per-request scale shape). The correction is exact in
    int64; the group scales multiply in float64 and the groups sum in order,
    one addition at a time, as the JAX package's numpy reduction does, so
    every output is the same float64.
    """
    m = partials.shape[-1]
    lead = tuple(partials.shape[:-2])
    chunk_per_group = gs // n_sub if g > 1 else n_chunks
    acc_g = partials.reshape(*lead, g, chunk_per_group, m).sum(dim=-2)
    a_g = a_u.to(torch.int64).reshape(*lead, g, gs)
    w_g = w_u.to(torch.int64).reshape(g, gs, m)
    sum_a = a_g.sum(dim=-1)                                       # (…, g)
    sum_w = w_g.sum(dim=1)                                        # (g, m)
    corr = (acc_g - aq.zero * sum_w - wq.zero * sum_a[..., None]
            + gs * aq.zero * wq.zero)
    scale = wq.scale.to(device=partials.device, dtype=torch.float64)
    prod = corr.to(torch.float64) * scale                         # (…, g, m)
    out = prod[..., 0, :]
    for i in range(1, g):
        out = out + prod[..., i, :]
    return out


def _gemv_waves(w_u: torch.Tensor, q: int, p: int, geom: PudGeometry,
                plans: list, sched: WaveSchedule, slots: np.ndarray,
                reliable_cols: Optional[np.ndarray], n_sub: int, m: int):
    """Single-request wave execution — the batched executor at B=1."""
    partials, rt_arr, pre_arr = _gemv_waves_batched(
        w_u, q, p, geom, [plans], sched, slots, reliable_cols, n_sub, m)
    return partials[0], rt_arr[0], pre_arr[0]


# ---------------------------------------------------------------------------
# Place-then-execute: staging (step ① — weights become resident) is split
# from compute (steps ②–④) so a residency session stages ONCE and decodes
# many times against the same resident rows.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StagedGroup:
    """One wave group's resident state: a `BankArray` whose matrix rows hold
    the group's weight bit-planes (+ complements), plus the gather/scatter
    indices the compute phase reuses every launch. Tensors live on the
    staged matrix's device; index arrays read by the ledger stay on the
    host."""

    lay: HorizontalLayout
    bank: BankArray
    matrix_block: torch.Tensor  # float32 (T, n_c, cols) resident rows
    chunks: np.ndarray         # (T,) reduction-chunk index per tile
    tiles_idx: np.ndarray      # (T,) linear tile ids (scatter targets)
    m_subs: np.ndarray         # (T,) live outputs per tile
    flat_idx: torch.Tensor     # (n_valid,) partials scatter indices
    valid_ravel: np.ndarray    # (T·m_per_tile,) bool gather mask
    # ABFT checksum row per tile (GeMV linearity: the column sum of the
    # resident rows is itself a weight row, so the expected accumulator
    # COLUMN SUM is codes·checksum — one extra dot per tile).
    checksum: torch.Tensor = None     # int64 (T, n_c)
    bank_keys: np.ndarray = None      # int64 (T, 2) (channel, bank) per tile
    valid_idx: torch.Tensor = None    # (n_valid,) positions of valid_ravel
    chunks_t: torch.Tensor = None     # `chunks` on the staged device


@dataclasses.dataclass
class StagedWaves:
    """One matrix staged resident in wave order — the executable half of a
    `residency.Placement`.

    Built once (`stage_matrix` / registration), then `_execute_staged` runs
    any number of activation batches against the SAME resident rows with
    zero re-staging: `preload` records the one-time staging counts (they
    reconcile exactly with the placement's `staged` bits and with the
    per-call oracle's `TileReport.preload`), and every subsequent launch
    bills only compute/readout commands.
    """

    n_chunks: int
    col_chunks: int
    n: int
    m: int
    q: int
    p: int
    n_sub: int
    geom: PudGeometry
    m_per_tile: int
    slot_cols: np.ndarray      # (m_per_tile·q,) output bitlines
    waves: int
    groups: list               # StagedGroup, wave-major order
    preload: np.ndarray        # (tiles, len(_COUNT_FIELDS)) staging counts
    device: torch.device = None
    slot_cols_t: torch.Tensor = None  # `slot_cols` on the staged device

    @property
    def tiles(self) -> int:
        return self.n_chunks * self.col_chunks

    @property
    def staged_counts(self) -> OpCounts:
        return OpCounts(*map(int, self.preload.sum(axis=0)))

    @property
    def nbytes(self) -> int:
        """Device bytes of the staged state: bank rows, matrix blocks and
        checksums."""
        return sum(t.numel() * t.element_size() for g in self.groups
                   for t in (g.bank.data, g.matrix_block, g.checksum))


def _stage_waves(w_u: torch.Tensor, q: int, p: int, geom: PudGeometry,
                 sched: WaveSchedule, slots: np.ndarray,
                 reliable_cols: Optional[np.ndarray], n_sub: int,
                 m: int) -> StagedWaves:
    """Step ①: gather + host-write every wave group's weight bit-planes into
    resident `BankArray`s, once, on the device of `w_u`. Out-of-range output
    columns (ragged last column chunk) are masked to zero — exactly the
    empty bitlines the sequential loader leaves. Tiles of a wave sharing a
    reduction-chunk length n_c (hence one row layout / accumulator width r)
    form one group; the ragged last chunk adds at most one extra group per
    wave."""
    dev = w_u.device
    w_u = w_u.to(torch.uint8)
    n = w_u.shape[0]
    cols = geom.subarray_cols
    m_per_tile = slots.shape[0]
    rel = (reliable_cols[:cols] if reliable_cols is not None else None)
    q_arange = np.arange(q)
    slot_cols = (slots[:, None] + q_arange[None, :]).ravel()  # (m_per·q,)
    slot_cols_t = _index(slot_cols, dev)
    q_shift = torch.arange(q, dtype=torch.uint8, device=dev)
    zeros = torch.zeros(cols, dtype=torch.uint8, device=dev)
    ones = torch.ones(cols, dtype=torch.uint8, device=dev)
    preload = np.zeros((sched.tiles, len(_COUNT_FIELDS)), dtype=np.int64)
    groups: list = []

    def chunk_len(ci: int) -> int:
        return min((ci + 1) * n_sub, n) - ci * n_sub

    for w in range(sched.waves):
        members = sched.wave_members(w)
        for n_c in sorted({chunk_len(a.chunk) for a in members}):
            group = [a for a in members if chunk_len(a.chunk) == n_c]
            T = len(group)
            chunks = np.asarray([a.chunk for a in group])
            m0s = np.asarray([a.col_chunk for a in group]) * m_per_tile
            m_subs = np.minimum(m0s + m_per_tile, m) - m0s
            lay = HorizontalLayout(n_sub=n_c, m_sub=m_per_tile, q=q, p=p,
                                   subarray_rows=geom.subarray_rows,
                                   subarray_cols=cols)
            # Only the layout's row prefix is ever touched — allocating the
            # full 512 physical rows per bank would just zero dead pages.
            bank = BankArray(T, rows=lay.rows_used, cols=cols,
                             reliable_cols=rel, device=dev)
            row_idx = chunks[:, None] * n_sub + np.arange(n_c)[None, :]
            col_idx = m0s[:, None] + np.arange(m_per_tile)[None, :]
            valid = col_idx < m                                # (T, m_per)
            w_grp = w_u[_index(row_idx, dev)[:, :, None],
                        _index(np.minimum(col_idx, m - 1), dev)[:, None, :]]
            w_grp = w_grp * torch.as_tensor(valid, device=dev)[:, None, :]
            bits = (w_grp[..., None] >> q_shift) & 1       # (T, n_c, m_per, q)
            rows_block = torch.zeros((T, n_c, cols), dtype=torch.uint8,
                                     device=dev)
            rows_block[:, :, slot_cols_t] = bits.reshape(T, n_c, -1)
            bank.host_write_row(lay.zero_row, zeros)
            bank.host_write_row(lay.one_row, ones)
            bank.host_write_rows(lay.matrix_rows, rows_block)
            bank.host_write_rows(lay.inv_matrix_rows, 1 - rows_block)
            tiles_idx = np.asarray([a.tile for a in group])
            preload[tiles_idx] = bank.counts_matrix()
            bank.reset_counts()
            flat_idx = (chunks[:, None] * m + col_idx)[valid]  # (n_valid,)
            bank_keys = np.asarray([(a.channel, a.bank) for a in group],
                                   dtype=np.int64)
            bank.fault_keys = bank_keys
            valid_ravel = valid.ravel()
            groups.append(StagedGroup(
                lay=lay, bank=bank,
                matrix_block=rows_block.to(torch.float32),
                chunks=chunks, tiles_idx=tiles_idx, m_subs=m_subs,
                flat_idx=_index(flat_idx, dev), valid_ravel=valid_ravel,
                checksum=rows_block.sum(dim=-1, dtype=torch.int64),
                bank_keys=bank_keys,
                valid_idx=_index(np.nonzero(valid_ravel)[0], dev),
                chunks_t=_index(chunks, dev)))
    return StagedWaves(n_chunks=sched.n_chunks, col_chunks=sched.col_chunks,
                       n=n, m=m, q=q, p=p, n_sub=n_sub, geom=geom,
                       m_per_tile=m_per_tile, slot_cols=slot_cols,
                       waves=sched.waves, groups=groups, preload=preload,
                       device=dev, slot_cols_t=slot_cols_t)


def stage_matrix(wq: QuantizedTensor, p: int,
                 geom: PudGeometry = PudGeometry(),
                 reliable_cols=None) -> StagedWaves:
    """Stage a quantized matrix resident for p-bit activations, on the
    device of its codes (public entry: the engine stages each registered
    handle once at placement)."""
    w_u = wq.values
    n, m = w_u.shape
    n_sub = min(geom.n_sub_max, n)
    n_chunks = math.ceil(n / n_sub)
    reliable_cols = _host_mask(reliable_cols)
    slots = _output_slots(reliable_cols, wq.spec.bits, geom)
    col_chunks = math.ceil(m / slots.shape[0])
    sched = schedule_tiles(n_chunks, col_chunks, geom)
    return _stage_waves(w_u, wq.spec.bits, p, geom, sched, slots,
                        reliable_cols, n_sub, m)


def _chunk_arrays_batched(a_u: np.ndarray, n: int, n_sub: int, p: int,
                          sparsity: bool,
                          templates: Optional[CommandTemplates] = None):
    """Per-chunk executor state for a (B, n) host lane batch, vectorized
    over the batch axis (`select_templates_batched` per chunk).

    Returns (codes, popc, zero_adds, skipped, r_bits): per-chunk lists of
    (B, n_c) float32 raw codes, (B, p) popcounts, (B, p) zero-add billing
    (None under sparsity), the (B,) per-request skipped-bit totals, and the
    max accumulator width.
    """
    codes, popc, zeros = [], [], []
    skipped = np.zeros(a_u.shape[0], dtype=np.int64)
    r_bits = 0
    for ci in range(math.ceil(n / n_sub)):
        j0, j1 = ci * n_sub, min((ci + 1) * n_sub, n)
        n_c = j1 - j0
        tmpl = (templates if templates is not None and templates.n_sub == n_c
                else build_templates(n_c, p))
        sel = select_templates_batched(a_u[:, j0:j1], tmpl, sparsity)
        codes.append(sel.codes.astype(np.float32))
        popc.append(sel.popcounts)
        zeros.append(None if sparsity else sel.zero_slots)
        skipped += sel.skipped
        r_bits = max(r_bits, accumulator_width(n_c, p))
    return codes, popc, zeros, skipped, r_bits


def _lane_mask_arg(lane_mask, B: int):
    """Validate a lane-occupancy mask against the launch capacity: (B,)
    bool with at least one active lane (an all-masked tick has nothing to
    execute — skip it instead). None passes through: all lanes active."""
    if lane_mask is None:
        return None
    if isinstance(lane_mask, torch.Tensor):
        lane_mask = lane_mask.cpu().numpy()
    m = np.asarray(lane_mask, dtype=bool)
    if m.shape != (B,):
        raise ValueError(
            f"lane_mask shape {m.shape} does not match the lane batch "
            f"B={B}")
    if not m.any():
        raise ValueError(
            "lane_mask has no active lanes — skip the tick instead of "
            "executing an empty one")
    return m


def _lanes(lane_mask, device) -> Optional[torch.Tensor]:
    """Device index tensor of a mask's active lanes (None: all lanes)."""
    if lane_mask is None:
        return None
    return _index(np.nonzero(lane_mask)[0], device)


def _zero_masked(out: torch.Tensor, keep: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Masked lanes' rows set to exactly 0.0 (`keep`: the (B,) lane mask
    on the output's device; None keeps every row)."""
    if keep is None:
        return out
    return torch.where(keep[:, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _keep(lane_mask, device) -> Optional[torch.Tensor]:
    return (None if lane_mask is None
            else torch.as_tensor(lane_mask, device=device))


def _corrupt_active(fault: FaultSession, acc: torch.Tensor, bank_keys,
                    lane_mask) -> np.ndarray:
    """Fault-inject only the OCCUPIED lanes of a capacity launch: a masked
    lane executes nothing physically, so it cannot be corrupted — and its
    zero ABFT expectation (zero codes → zero column sum) must never see an
    injected flip. Returns the full-(B, T) ground-truth corrupted mask
    (host; False on masked lanes)."""
    if lane_mask is None:
        return fault.corrupt_accumulator(acc, bank_keys)
    idx = _lanes(lane_mask, acc.device)
    sub = acc.index_select(0, idx)
    hit_sub = fault.corrupt_accumulator(sub, bank_keys)
    acc[idx] = sub
    hit = np.zeros(tuple(acc.shape[:2]), dtype=bool)
    hit[lane_mask] = hit_sub
    return hit


def _group_retry_ops(lay: HorizontalLayout,
                     n_adds_all: np.ndarray) -> np.ndarray:
    """Per-(request, tile) PUD ops of ONE re-execution of a staged group:
    the 2·r clear RowCopies plus each offset's add template (RowCopy +
    MAJ3 + MAJ5) times its popcount — the same static-template math the
    first pass bills, so a retry is priced exactly like the wave it
    repeats."""
    p = n_adds_all.shape[-1]
    per_add = np.asarray([adder_cost(lay.r - k).pud_ops for k in range(p)],
                         dtype=np.int64)
    return 2 * lay.r + (n_adds_all * per_add).sum(axis=-1)     # (B, T)


def _acc_matmul(codes: torch.Tensor, matrix: torch.Tensor,
                mask) -> torch.Tensor:
    """§V-D linearity collapse: (B, T, n) codes × (T, n, cols) resident rows
    → (B, T, cols) int64 accumulators, masked to each tile's r bits."""
    acc = code_matmul(codes.transpose(0, 1), matrix).to(torch.int64)
    return acc.transpose(0, 1) & mask


def _detected(expected: torch.Tensor, acc: torch.Tensor) -> np.ndarray:
    """ABFT check on the host: cells whose accumulator column sum is not
    codes·checksum."""
    return (expected != acc.sum(dim=2)).cpu().numpy()


def _verify_and_retry_group(g: StagedGroup, bank: BankArray,
                            lay: HorizontalLayout,
                            group_codes: torch.Tensor,
                            acc_val: torch.Tensor, n_adds_all: np.ndarray,
                            fault: FaultSession, max_retries: int,
                            trace: FaultTrace, layer: int = 0,
                            lane_mask=None) -> torch.Tensor:
    """Inject + ABFT-verify + bounded re-execution of one wave group.

    The expected accumulator COLUMN SUM of a correct (request, tile) cell
    is codes·checksum (GeMV linearity), and every injection is a single ±1
    column-sum perturbation, so `expected != actual` flags exactly the
    corrupted cells. A retry re-executes the WHOLE group segment with
    fresh fault draws — billed to the bank ledger like the first pass and
    recorded as an extra wave in `trace.retry_wave_ops`. Cells that come
    back clean are merged; sticky cells that outlive the budget are
    reported unresolved, with their (channel, bank) homes, for the
    engine's quarantine/degrade escalation.
    """
    mask = (1 << lay.r) - 1
    expected = (group_codes.to(torch.int64)
                * g.checksum[None]).sum(dim=-1)                # (B, T)
    corrupted = _corrupt_active(fault, acc_val, g.bank_keys, lane_mask)
    detected = _detected(expected, acc_val)
    trace.corrupted += int(corrupted.sum())
    trace.detected += int((detected & corrupted).sum())
    tries = 0
    while detected.any() and tries < max_retries:
        tries += 1
        acc_new = _acc_matmul(group_codes, g.matrix_block, mask)
        _corrupt_active(fault, acc_new, g.bank_keys, lane_mask)
        det_new = _detected(expected, acc_new)
        fix = detected & ~det_new
        acc_val = torch.where(
            torch.as_tensor(fix, device=acc_val.device)[..., None],
            acc_new, acc_val)
        detected &= det_new
        # the retry re-runs the segment end to end: re-bill clear + add
        # templates + readout, and record the extra wave's serialization
        clear_accumulator(bank, lay)
        for k in range(n_adds_all.shape[-1]):
            bank.charge_adds(adder_cost(lay.r - k), n_adds_all[..., k])
        bank.charge_host_read(lay.acc_rows)
        ops_bt = _group_retry_ops(lay, n_adds_all)
        if lane_mask is not None:
            # masked lanes re-execute nothing — their share of the retry
            # wave (static clears included) bills zero ops
            ops_bt = ops_bt * lane_mask[:, None]
        trace.retries += 1
        trace.retry_wave_ops.append(int(ops_bt.sum(axis=0).max()))
    if detected.any():
        for b, t in zip(*np.nonzero(detected)):
            trace.unresolved.append((int(b), layer, int(g.tiles_idx[t])))
            cb = (int(g.bank_keys[t][0]), int(g.bank_keys[t][1]))
            if cb not in trace.unresolved_banks:
                trace.unresolved_banks.append(cb)
    return acc_val


def _execute_staged(staged: StagedWaves, chunk_codes: list, chunk_popc: list,
                    chunk_zero_adds: list, B: int,
                    fault: Optional[FaultSession] = None,
                    max_retries: int = 0,
                    trace: Optional[FaultTrace] = None,
                    lane_mask=None):
    """Steps ②–④ against resident rows: run B activation streams through
    every staged wave group, with NO weight staging.

    §V-D linearity collapses the p per-offset ripple-carries into ONE code
    matmul per group (Σ_k 2^k bits_k = codes; addition mod 2^r commutes
    with the collapse), so the whole wave × batch advances in a single
    batched step — bit-identical to issuing `add_rows_batched_wave` per
    offset. Commands are still billed per offset template. Returns
    partials (B, n_chunks, m) int64 on the staged device and the host
    (B, tiles, len(_COUNT_FIELDS)) runtime count matrix.

    `fault` corrupts each group's accumulator values per its model; ABFT
    checksum verification then localizes the corrupt (request, tile) cells
    and re-executes the group up to `max_retries` times, accumulating
    observations into `trace`. With `fault=None` this path is the
    pre-fault executor — outputs AND counts.

    `lane_mask` (B,) bool arms a capacity launch: callers zero the masked
    lanes' codes/popcounts, this executor arms the bank ledgers with the
    mask and fault injection skips them; outputs of masked lanes come back
    zero.
    """
    dev = staged.device
    m, p = staged.m, staged.p
    q_shift = torch.arange(staged.q, dtype=torch.int64, device=dev)
    partials = torch.zeros((B, staged.n_chunks * m), dtype=torch.int64,
                           device=dev)
    rt_arrs = np.zeros((B, staged.tiles, len(_COUNT_FIELDS)), dtype=np.int64)
    active = _lanes(lane_mask, dev)
    # every chunk's codes in one (B, n_chunks, n_sub) block, one copy to
    # the device (the ragged last chunk zero-padded)
    codes = np.zeros((B, staged.n_chunks, staged.n_sub), dtype=np.float32)
    for ci, c in enumerate(chunk_codes):
        codes[:, ci, :c.shape[1]] = c
    codes = torch.from_numpy(codes).to(dev)
    for g in staged.groups:
        bank, lay = g.bank, g.lay
        T = g.chunks.shape[0]
        bank.set_batch(B, lane_mask)
        clear_accumulator(bank, lay)
        group_codes = codes[:, g.chunks_t, :lay.n_sub]         # (B, T, n_c)
        acc_val = _acc_matmul(group_codes, g.matrix_block,
                              (1 << lay.r) - 1)                # (B, T, cols)
        group_popc = np.stack([chunk_popc[c] for c in g.chunks],
                              axis=1)                          # (B, T, p)
        n_adds_all = group_popc
        if chunk_zero_adds[g.chunks[0]] is not None:
            n_adds_all = n_adds_all + np.stack(
                [chunk_zero_adds[c] for c in g.chunks], axis=1)
        for k in range(p):
            bank.charge_adds(adder_cost(lay.r - k), n_adds_all[..., k])
        # readout: each request reads its accumulator rows back at its
        # turn; the VALUES come from the arithmetic track, which on the
        # reliable slot columns is bit-identical to the rows each occupant
        # held.
        bank.charge_host_read(lay.acc_rows)
        if fault is not None:
            acc_val = _verify_and_retry_group(
                g, bank, lay, group_codes, acc_val, n_adds_all, fault,
                max_retries, trace, lane_mask=lane_mask)
        # one deferred row materialization for all p offsets: the rows end
        # up holding the bank's final (post-retry) time-shared occupant —
        # under occupancy masking, the LAST ACTIVE lane's accumulator
        write_accumulator_wave(bank, lay,
                               acc_val if active is None
                               else acc_val.index_select(0, active))
        outs = (acc_val[:, :, staged.slot_cols_t]
                .reshape(B, T, staged.m_per_tile, staged.q)
                << q_shift).sum(dim=-1)                        # (B, T, m_per)
        bank.charge_host_int_ops(g.m_subs * staged.q)
        rt_arrs[:, g.tiles_idx] = bank.counts_matrix()
        # scatter the group's outputs into every request's partials in one
        # flat index write (ragged tails masked at staging)
        partials[:, g.flat_idx] = outs.reshape(B, -1)[:, g.valid_idx]
    return partials.reshape(B, staged.n_chunks, m), rt_arrs


def _gemv_waves_batched(w_u: torch.Tensor, q: int, p: int,
                        geom: PudGeometry, plans_b: list,
                        sched: WaveSchedule, slots: np.ndarray,
                        reliable_cols: Optional[np.ndarray], n_sub: int,
                        m: int):
    """Execute B requests' scheduled tiles wave by wave through one shared
    `BankArray(batch=B)`: stage the wave groups fresh (weight rows gathered
    and RowCopied ONCE for all B requests), then run the compute phase.
    Residency sessions call the two halves separately and skip the staging
    on every launch after the first.

    plans_b: (B,) lists of per-reduction-chunk plans (one per request).
    Returns partials (B, n_chunks, m) plus host (B, tiles,
    len(_COUNT_FIELDS)) runtime and preload count matrices.
    """
    B = len(plans_b)
    n = w_u.shape[0]

    def chunk_len(ci: int) -> int:
        return min((ci + 1) * n_sub, n) - ci * n_sub

    # Per-chunk selection state from the already-built plans; `codes` holds
    # the raw activation codes Σ_k 2^k·bit_k as float32.
    chunk_codes = [None] * sched.n_chunks
    chunk_popc = [None] * sched.n_chunks
    chunk_zero_adds = [None] * sched.n_chunks
    for ci in range(sched.n_chunks):
        n_c = chunk_len(ci)
        codes = np.zeros((B, n_c), dtype=np.float32)
        popc = np.zeros((B, p), dtype=np.int64)
        for b, plans in enumerate(plans_b):
            for k, rows_k in enumerate(plans[ci].rows_per_offset):
                codes[b, rows_k] += float(1 << k)
                popc[b, k] = rows_k.shape[0]
        chunk_codes[ci] = codes
        chunk_popc[ci] = popc
        if not plans_b[0][ci].sparsity:
            chunk_zero_adds[ci] = np.asarray(
                [plans[ci].zero_slots for plans in plans_b], np.int64)

    staged = _stage_waves(w_u, q, p, geom, sched, slots, reliable_cols,
                          n_sub, m)
    partials, rt_arrs = _execute_staged(staged, chunk_codes, chunk_popc,
                                        chunk_zero_adds, B)
    pre_arrs = np.broadcast_to(
        staged.preload, (B,) + staged.preload.shape).copy()
    return partials, rt_arrs, pre_arrs


def mvdram_gemv_batched(aq: QuantizedTensor, wq: QuantizedTensor,
                        sparsity: bool = True,
                        geom: PudGeometry = PudGeometry(),
                        reliable_cols=None,
                        templates: Optional[CommandTemplates] = None,
                        staged: Optional[StagedWaves] = None,
                        fault: Optional[FaultSession] = None,
                        max_retries: int = 0,
                        lane_mask: Optional[np.ndarray] = None):
    """B GeMVs against one resident matrix, executed in SHARED waves, on
    the device of the weight codes.

    `aq.values` is (B, N) activation codes with per-request scales (B, 1).
    The B requests' tile grids are co-scheduled on one set of (channel,
    bank, wave) slots (`schedule.schedule_batch`): each wave group's weight
    rows are staged once, and all B popcount-selected command streams
    ripple against them on the batch axis of `device.BankArray`.

    Returns ((B, M) float32, `BatchReport`). Outputs and per-tile OpCounts
    of `report.requests[b]` are bit-identical to `mvdram_gemv(aq_b, wq,
    ...)` run alone.

    `staged` (a `StagedWaves` for THIS matrix) executes against
    already-resident rows: the launch pays ZERO weight staging —
    `report.shared_preload` and every per-request preload are zero,
    `report.resident` is True — while outputs and per-tile RUNTIME
    OpCounts stay bit-identical to the fresh-staging path.

    `fault` runs the launch under fault injection with ABFT verification
    and up to `max_retries` wave-segment re-executions; the observations
    land in `report.fault`.

    `lane_mask` (B,) bool executes the launch at CAPACITY B with only the
    masked-true lanes occupied: masked lanes' codes/popcounts are zeroed,
    the bank ledgers are armed with the mask (masked lanes bill exactly
    zero ops) and their output rows come back zero — active lanes stay
    bit-identical to a compacted launch of just those lanes.
    """
    a_u = _host_codes(aq.values)
    if a_u.ndim != 2:
        raise ValueError(
            f"batched GeMV takes (B, N) activation codes, got shape "
            f"{a_u.shape}")
    w_u = wq.values
    dev = w_u.device
    B = a_u.shape[0]
    n, m = w_u.shape
    q, p = wq.spec.bits, aq.spec.bits
    n_sub, n_chunks, gs, g = _partition_checks(n, wq, geom)
    reliable_cols = _host_mask(reliable_cols)

    slots = _output_slots(reliable_cols, q, geom)
    m_per_tile = slots.shape[0]
    col_chunks = math.ceil(m / m_per_tile)
    bsched = schedule_batch(n_chunks, col_chunks, B, geom)

    # Per-chunk §V-D selection, one vectorized pass over the whole lane
    # batch (the command TEMPLATES are shared — only selections differ).
    codes, popc, zero_adds, skipped_b, r_bits = _chunk_arrays_batched(
        a_u, n, n_sub, p, sparsity, templates)
    lane_mask = _lane_mask_arg(lane_mask, B)
    if lane_mask is not None:
        # masked lanes select nothing: zero codes make the ABFT expectation
        # (codes·checksum) zero to match the zero accumulator, and zero
        # popcounts bill zero add templates
        off = ~lane_mask
        for ci in range(len(codes)):
            codes[ci][off] = 0.0
            popc[ci][off] = 0
            if zero_adds[ci] is not None:
                zero_adds[ci][off] = 0
        skipped_b = skipped_b * lane_mask

    resident = staged is not None
    if resident:
        _check_staged(staged, n, m, q, p, n_sub, geom, slots)
    else:
        staged = _stage_waves(w_u, q, p, geom, bsched.base, slots,
                              reliable_cols, n_sub, m)
    trace = FaultTrace() if fault is not None else None
    partials, rt_arrs = _execute_staged(staged, codes, popc, zero_adds, B,
                                        fault=fault, max_retries=max_retries,
                                        trace=trace, lane_mask=lane_mask)
    # Resident launches stage nothing: the placement already paid the
    # preload (recorded in `StagedWaves.preload` / `Placement.staged`).
    pre_arr = (np.zeros_like(staged.preload) if resident
               else staged.preload)
    report = _build_batch_report(staged, bsched, rt_arrs, pre_arr,
                                 skipped_b, r_bits, resident, fault=trace)

    out = _aggregate_host(partials, _codes_on(aq.values, dev), w_u, aq, wq,
                          n_chunks, n_sub, gs, g)
    out = out * aq.scale.to(device=dev, dtype=torch.float64).reshape(B, 1)
    # the host-side zero-point correction sees the masked lanes' raw
    # activations — their rows are contractually zero, not garbage
    out = _zero_masked(out, _keep(lane_mask, dev))
    return out.to(torch.float32), report


def _build_batch_report(staged: StagedWaves, bsched: BatchSchedule,
                        rt_arrs: np.ndarray, pre_arr: np.ndarray,
                        skipped_b: np.ndarray, r_bits: int,
                        resident: bool,
                        fault: Optional[FaultTrace] = None) -> BatchReport:
    """Materialize per-request `TileReport`s + shared batch accounting from
    array-native executor counts. Shared by the batched launch path and the
    fused program executor's LAZY report builder — both produce the same
    per-(request, tile) numbers, so the report shape is identical.
    """
    B = rt_arrs.shape[0]
    n_chunks, col_chunks = staged.n_chunks, staged.col_chunks
    geom = staged.geom
    tiles = n_chunks * col_chunks
    agg_bits = tiles * r_bits * geom.subarray_cols
    pt = geom.parallel_tiles
    pre_objs = tuple(OpCounts(*r) for r in pre_arr.tolist())
    preload = OpCounts(*map(int, pre_arr.sum(axis=0)))
    requests = []
    for b in range(B):
        rt_arr = rt_arrs[b]
        requests.append(TileReport(
            n_chunks=n_chunks, col_chunks=col_chunks, tiles=tiles,
            runtime=OpCounts(*map(int, rt_arr.sum(axis=0))),
            preload=preload,
            skipped_bits=int(skipped_b[b]), r_bits=r_bits,
            aggregate_bits=agg_bits, waves=bsched.waves,
            wave_max=tuple(_wave_maxima(rt_arr, bsched.waves, pt)),
            tile_runtime=tuple(OpCounts(*r) for r in rt_arr.tolist()),
            tile_preload=pre_objs))
    # Physical shared accounting: weight staging once (zero when resident);
    # the B compute streams time-share each bank, so a wave is bound by its
    # slowest SUMMED tile.
    batch_runtime = OpCounts(*map(int, rt_arrs.sum(axis=(0, 1))))
    batch_wave_max = _wave_maxima(rt_arrs.sum(axis=0), bsched.waves, pt)
    return BatchReport(batch=B, schedule=bsched, requests=tuple(requests),
                       shared_preload=preload,
                       runtime=batch_runtime,
                       wave_max=tuple(batch_wave_max),
                       resident=resident,
                       staged=staged.staged_counts,
                       fault=fault)


def _check_staged(staged: StagedWaves, n: int, m: int, q: int, p: int,
                  n_sub: int, geom: PudGeometry, slots: np.ndarray) -> None:
    """Reject executing a launch against staging for a DIFFERENT matrix /
    precision / geometry — resident rows only serve the shape they hold."""
    if (staged.n, staged.m, staged.q, staged.p, staged.n_sub) != \
            (n, m, q, p, n_sub) or staged.geom != geom:
        raise ValueError(
            f"staged waves hold a ({staged.n}x{staged.m}) q={staged.q}/"
            f"p={staged.p} matrix at {staged.geom}; this launch is "
            f"({n}x{m}) q={q}/p={p} at {geom}")
    if staged.m_per_tile != slots.shape[0]:
        raise ValueError(
            f"staged output slots ({staged.m_per_tile}/tile) do not match "
            f"this launch's reliability mask ({slots.shape[0]}/tile)")


# ---------------------------------------------------------------------------
# Fused cross-layer wave execution: run a whole decode step's GeMV sequence
# WAVE-MAJOR through `schedule.schedule_program`'s fused slot order. One
# batched step advances every tile of a global wave — tiles drawn from
# DIFFERENT layers' layouts — against the layers' resident staged rows.
# Staging is untouched: the plan only indexes into the `StagedWaves` the
# placements already paid for.
# ---------------------------------------------------------------------------

_F = len(_COUNT_FIELDS)
_RC_I = _COUNT_FIELDS.index("row_copy")
_M3_I = _COUNT_FIELDS.index("maj3")
_M5_I = _COUNT_FIELDS.index("maj5")
_HBR_I = _COUNT_FIELDS.index("host_bits_read")
_HIO_I = _COUNT_FIELDS.index("host_int_ops")
_PUD_I = np.asarray([_COUNT_FIELDS.index(f) for f in
                     ("row_copy", "maj3", "maj5", "majx_other")])


@dataclasses.dataclass
class FusedSegment:
    """One contiguous run of a single layer-group's tiles inside one fused
    wave — the unit that touches a resident `BankArray` (charge + final
    accumulator materialization)."""

    group: StagedGroup
    pos: np.ndarray            # (T_seg,) tile positions inside group.bank
    lo: int                    # [lo, hi) slice of the wave's tile axis
    hi: int
    pos_t: torch.Tensor = None  # `pos` on the staged device


@dataclasses.dataclass
class FusedWave:
    """One global wave of the fused schedule: slots [lo, hi) of the plan's
    slot-ordered arrays, outputs [out_lo, out_hi) of the flat gather index,
    split into per-(layer, group) segments."""

    lo: int
    hi: int
    out_lo: int
    out_hi: int
    segments: list             # (FusedSegment,)
    valid_idx: torch.Tensor = None  # live (tile, output) positions, flat


@dataclasses.dataclass
class FusedProgram:
    """Executable wave-major plan for one compiled decode program.

    Built once (`stage_program`) from the layers' already-resident
    `StagedWaves` and the fused `ProgramSchedule`; every array is in global
    SLOT order (slots are wave-contiguous), so executing wave w is slicing
    [lo, hi) out of each and issuing one batched step:

      matrix[lo:hi]   (T_w, n_pad, cols) resident weight rows, zero-padded
                      past each tile's own reduction depth — one matmul
                      advances the whole wave even when its tiles come
                      from layers with different n_sub/q/p.
      static[lo:hi]   per-tile data-INdependent charges (each tile's own
                      layout: 2·r clear copies, r·cols readout bits,
                      m_sub·q host aggregation ops).
      add_rc/add_m3   per-(tile, bit-offset) static add-template costs —
                      one einsum against the popcount selections bills the
                      whole wave's data-dependent commands.
      colidx/mult     per-tile readout gather (each tile's own slot columns
                      and weight-bit shifts; `mult` is zero on padding).

    `matrix` and `checksum` live on the staged device, with device twins
    (`*_t`) of the gather indices the wave walk reads there; the charge
    arrays stay on the host beside the ledger.
    """

    sched: ProgramSchedule
    stageds: tuple             # (L,) StagedWaves (resident, NOT re-staged)
    geom: PudGeometry
    n_pad: int
    p_max: int
    chunk0: np.ndarray         # (L+1,) global chunk-id offsets
    out0: np.ndarray           # (L+1,) flat-output offsets (n_chunks·m each)
    matrix: torch.Tensor       # (S, n_pad, cols) float32
    gchunk: np.ndarray         # (S,) global chunk ids
    mask_r: np.ndarray         # (S, 1) accumulator masks (1<<r)−1
    static: np.ndarray         # (S, _F) data-independent per-tile charges
    add_rc: np.ndarray         # (S, p_max) RowCopies per add at offset k
    add_m3: np.ndarray         # (S, p_max) MAJ3 (== MAJ5) per add at offset k
    colidx: np.ndarray         # (S, m_max, q_max) readout column gather
    mult: np.ndarray           # (S, m_max, q_max) weight-bit shifts (0 = pad)
    valid: np.ndarray          # (S, m_max) live outputs
    gout: np.ndarray           # (n_valid,) flat global output indices
    waves: list                # (W,) FusedWave
    checksum: torch.Tensor = None  # (S, n_pad) ABFT column-sum row per slot
    bank_keys: np.ndarray = None   # (S, 2) (channel, bank) home per slot
    # Lane CAPACITY the program serves (None = unmasked fixed-B): a
    # capacity program always executes at B == b_max, with the per-tick
    # occupancy carried by `execute_program(lane_mask=…)`.
    b_max: Optional[int] = None
    gchunk_t: torch.Tensor = None
    mask_r_t: torch.Tensor = None
    colidx_t: torch.Tensor = None
    mult_t: torch.Tensor = None
    gout_t: torch.Tensor = None

    @property
    def layers(self) -> int:
        return len(self.stageds)

    @property
    def tiles(self) -> int:
        return self.sched.tiles

    @property
    def device(self) -> torch.device:
        return self.matrix.device

    @property
    def nbytes(self) -> int:
        """Device bytes of the plan's own tensors (the padded matrix copy,
        checksums and gather indices)."""
        return sum(t.numel() * t.element_size() for t in (
            self.matrix, self.checksum, self.gchunk_t, self.mask_r_t,
            self.colidx_t, self.mult_t, self.gout_t))


def stage_program(stageds, sched: ProgramSchedule,
                  b_max: Optional[int] = None) -> FusedProgram:
    """Index L layers' resident staged rows into one wave-major plan.

    No weight row is written INTO the device here — `matrix` gathers the
    float32 execution-side blocks the per-layer staging already built
    (the same blocks the layer-major path matmuls against), zero-padded to
    the program's deepest reduction chunk so one batched step spans
    layouts. The host metadata is built per slot; the matrix is gathered
    with one indexed copy per staged group.

    `b_max` declares the lane CAPACITY the program serves: every execution
    must then launch exactly `b_max` lanes, with per-tick occupancy
    expressed through `execute_program(lane_mask=…)`.
    """
    if b_max is not None and (not isinstance(b_max, int) or b_max < 1):
        raise ValueError(f"b_max must be a positive int, got {b_max!r}")
    stageds = tuple(stageds)
    if len(stageds) != sched.layers:
        raise ValueError(
            f"{len(stageds)} staged layers for a {sched.layers}-layer "
            f"schedule")
    for l, st in enumerate(stageds):
        if st.tiles != sched.layer_tiles[l]:
            raise ValueError(
                f"layer {l} stages {st.tiles} tiles but the schedule "
                f"places {sched.layer_tiles[l]}")
    geom = stageds[0].geom
    dev = stageds[0].device
    cols = geom.subarray_cols
    # per-layer tile -> (StagedGroup, position inside the group's bank)
    tile_maps = []
    for st in stageds:
        tm = {}
        for g in st.groups:
            for pos, t in enumerate(g.tiles_idx.tolist()):
                tm[t] = (g, pos)
        tile_maps.append(tm)
    chunk0 = np.cumsum([0] + [st.n_chunks for st in stageds])
    out0 = np.cumsum([0] + [st.n_chunks * st.m for st in stageds])
    n_pad = max(st.n_sub for st in stageds)
    p_max = max(st.p for st in stageds)
    m_max = max(st.m_per_tile for st in stageds)
    q_max = max(st.q for st in stageds)
    S = sched.tiles
    matrix = torch.zeros((S, n_pad, cols), dtype=torch.float32, device=dev)
    gchunk = np.zeros(S, dtype=np.int64)
    mask_r = np.zeros((S, 1), dtype=np.int64)
    static = np.zeros((S, _F), dtype=np.int64)
    add_rc = np.zeros((S, p_max), dtype=np.int64)
    add_m3 = np.zeros((S, p_max), dtype=np.int64)
    colidx = np.zeros((S, m_max, q_max), dtype=np.int64)
    mult = np.zeros((S, m_max, q_max), dtype=np.int64)
    valid = np.zeros((S, m_max), dtype=bool)
    gout_parts, m_sub_per_slot = [], np.zeros(S, dtype=np.int64)
    gathers: dict = {}         # id(group) -> (group, [slot], [pos])

    for s_i, slot in enumerate(sched.slots):
        st = stageds[slot.layer]
        g, pos = tile_maps[slot.layer][slot.tile]
        lay = g.lay
        r = lay.r
        gathers.setdefault(id(g), (g, [], []))
        gathers[id(g)][1].append(s_i)
        gathers[id(g)][2].append(pos)
        gchunk[s_i] = chunk0[slot.layer] + slot.chunk
        mask_r[s_i] = (1 << r) - 1
        m_sub = int(g.m_subs[pos])
        static[s_i, _RC_I] = 2 * r                # clear_accumulator
        static[s_i, _HBR_I] = r * cols            # accumulator readout
        static[s_i, _HIO_I] = m_sub * st.q        # host shift-accumulate
        for k in range(st.p):
            c = adder_cost(r - k)
            add_rc[s_i, k] = c.row_copy
            add_m3[s_i, k] = c.maj3               # maj5 charge is identical
        colidx[s_i, :st.m_per_tile, :st.q] = \
            st.slot_cols.reshape(st.m_per_tile, st.q)
        mult[s_i, :m_sub, :st.q] = 1 << np.arange(st.q, dtype=np.int64)
        valid[s_i, :m_sub] = True
        m_sub_per_slot[s_i] = m_sub
        m0 = slot.col_chunk * st.m_per_tile
        gout_parts.append(out0[slot.layer] + slot.chunk * st.m
                          + m0 + np.arange(m_sub, dtype=np.int64))
    for g, s_idx, pos in gathers.values():
        matrix[_index(s_idx, dev), :g.lay.n_sub] = \
            g.matrix_block.index_select(0, _index(pos, dev))
    gout = (np.concatenate(gout_parts) if gout_parts
            else np.zeros(0, dtype=np.int64))
    out_ptr = np.concatenate([[0], np.cumsum(m_sub_per_slot)])

    # wave boundaries (slots are wave-contiguous) + per-(layer, group)
    # segments inside each wave
    waves = []
    w_lo = 0
    for s_i in range(1, S + 1):
        if s_i < S and sched.slots[s_i].wave == sched.slots[w_lo].wave:
            continue
        segments = []
        seg_lo = w_lo
        for j in range(w_lo + 1, s_i + 1):
            here = (None if j == s_i
                    else tile_maps[sched.slots[j].layer]
                    [sched.slots[j].tile][0])
            prev = tile_maps[sched.slots[j - 1].layer][sched.slots[j - 1].tile][0]
            if here is not prev:
                pos = np.asarray(
                    [tile_maps[sched.slots[k].layer][sched.slots[k].tile][1]
                     for k in range(seg_lo, j)], dtype=np.int64)
                segments.append(FusedSegment(group=prev, pos=pos,
                                             lo=seg_lo - w_lo, hi=j - w_lo,
                                             pos_t=_index(pos, dev)))
                seg_lo = j
        waves.append(FusedWave(
            lo=w_lo, hi=s_i, out_lo=int(out_ptr[w_lo]),
            out_hi=int(out_ptr[s_i]), segments=segments,
            valid_idx=_index(np.nonzero(valid[w_lo:s_i].ravel())[0], dev)))
        w_lo = s_i
    bank_keys = np.asarray([(slot.channel, slot.bank)
                            for slot in sched.slots], dtype=np.int64)
    return FusedProgram(sched=sched, stageds=stageds, geom=geom,
                        n_pad=n_pad, p_max=p_max, chunk0=chunk0, out0=out0,
                        matrix=matrix, gchunk=gchunk, mask_r=mask_r,
                        static=static, add_rc=add_rc, add_m3=add_m3,
                        colidx=colidx, mult=mult, valid=valid, gout=gout,
                        waves=waves,
                        # ABFT checksum per slot: the column sum of a tile's
                        # resident rows (zero on the n_pad padding, so the
                        # padded code gather contributes nothing)
                        checksum=matrix.sum(dim=-1).to(torch.int64),
                        bank_keys=bank_keys, b_max=b_max,
                        gchunk_t=_index(gchunk, dev),
                        mask_r_t=_index(mask_r, dev),
                        colidx_t=_index(colidx, dev),
                        mult_t=_index(mult, dev),
                        gout_t=_index(gout, dev))


@dataclasses.dataclass
class ProgramRunResult:
    """Array-native result of one fused wave-major decode step.

    `wave_max[w]` is the field-wise max over wave w's member tiles of the
    B-summed per-tile counts — the EXECUTED fused-wave serialization that
    `timing.simulated_wave_time` prices and `price_program(executed=…)`
    reconciles against the schedule it fused. Per-(request, tile) counts
    (`rt_arrs`, gathered back from the resident banks' ledgers) are
    bit-identical to the layer-major oracle's. Outputs and partials are on
    the staged device; every count is on the host.
    """

    outs: list                 # (L,) float32 (B, M_l)
    rt_arrs: list              # (L,) (B, tiles_l, _F) runtime counts
    skipped: list              # (L,) (B,) skipped zero bits per request
    r_bits: list               # (L,) max accumulator width per layer
    wave_max: np.ndarray       # (W, _F) executed per-wave maxima (B-summed)
    # Fault-injected runs: PUD op count of every EXTRA wave a retry cost,
    # plus the launch's `FaultTrace`; empty/None on fault-free runs.
    retry_wave_ops: list = dataclasses.field(default_factory=list)
    fault: Optional[FaultTrace] = None
    # Energy accounting: the step's COMPLETE executed command ledger
    # (lanes+tiles summed, retry re-bills included), and the per-layer host
    # encode ops the speculative-encode walk performed (active lanes only).
    counts_total: Optional[np.ndarray] = None      # (_F,)
    encode_layer_ops: Optional[np.ndarray] = None  # (L,)
    # (L,) int64 (B, n_chunks_l, M_l) per-chunk integer partials — what
    # the tiles' accumulators read out, before the host's correction
    partials: Optional[list] = None

    @property
    def waves(self) -> int:
        return self.wave_max.shape[0]


def _verify_and_retry_wave(plan: FusedProgram, wv: FusedWave,
                           codes_w: torch.Tensor, acc: torch.Tensor,
                           counts_all: np.ndarray, fault: FaultSession,
                           max_retries: int, trace: FaultTrace,
                           retry_wave_ops: list,
                           lane_mask=None) -> torch.Tensor:
    """Inject + ABFT-verify + bounded re-execution of one FUSED wave.

    Same contract as `_verify_and_retry_group`, at fused-wave granularity:
    the expected column sum of every member slot is codes·checksum, a
    retry re-runs the wave's matmul with fresh fault draws, re-bills each
    segment's ledger, and records the wave's B-summed slowest-tile PUD
    serialization as one extra wave in `retry_wave_ops`. Cells corrupt
    past the budget are reported as (request, layer, tile) with their
    (channel, bank) homes.
    """
    lo, hi = wv.lo, wv.hi
    expected = (codes_w.to(torch.int64)
                * plan.checksum[None, lo:hi]).sum(dim=-1)      # (B, T)
    corrupted = _corrupt_active(fault, acc, plan.bank_keys[lo:hi], lane_mask)
    detected = _detected(expected, acc)
    trace.corrupted += int(corrupted.sum())
    trace.detected += int((detected & corrupted).sum())
    # B-summed, slowest member tile: the serialization one extra execution
    # of this wave costs (identical math to the base `wave_max` rows)
    wave_pud = int(counts_all.sum(axis=0)[lo:hi][:, _PUD_I]
                   .sum(axis=-1).max())
    # full per-command bill of ONE re-execution of this wave (all member
    # tiles, lanes summed) — what each retry re-charges into the bank
    # ledgers below, mirrored into the trace for energy pricing
    wave_counts = OpCounts.from_vector(counts_all[:, lo:hi].sum(axis=(0, 1)))
    tries = 0
    while detected.any() and tries < max_retries:
        tries += 1
        acc_new = _acc_matmul(codes_w, plan.matrix[lo:hi],
                              plan.mask_r_t[lo:hi])
        _corrupt_active(fault, acc_new, plan.bank_keys[lo:hi], lane_mask)
        det_new = _detected(expected, acc_new)
        fix = detected & ~det_new
        acc = torch.where(torch.as_tensor(fix, device=acc.device)[..., None],
                          acc_new, acc)
        detected &= det_new
        for seg in wv.segments:
            seg.group.bank.charge_counts(
                counts_all[:, lo + seg.lo:lo + seg.hi], tiles=seg.pos)
        trace.retries += 1
        trace.retry_wave_ops.append(wave_pud)
        trace.retry_counts = trace.retry_counts.merge(wave_counts)
        retry_wave_ops.append(wave_pud)
    if detected.any():
        for b, t in zip(*np.nonzero(detected)):
            slot = plan.sched.slots[lo + int(t)]
            trace.unresolved.append((int(b), slot.layer, slot.tile))
            cb = (int(plan.bank_keys[lo + int(t)][0]),
                  int(plan.bank_keys[lo + int(t)][1]))
            if cb not in trace.unresolved_banks:
                trace.unresolved_banks.append(cb)
    return acc


def execute_program(plan: FusedProgram, aqs, wqs, templates_list=None,
                    sparsity: bool = True,
                    fault: Optional[FaultSession] = None,
                    max_retries: int = 0,
                    lane_mask: Optional[np.ndarray] = None
                    ) -> ProgramRunResult:
    """One decode step, wave-major: encode every layer's (B, N_l) lane batch
    once, then walk the fused schedule's waves — each wave ONE batched step
    (padded code gather → one matmul across all member tiles, even when
    they belong to different layers → vectorized heterogeneous charges →
    per-segment accumulator materialization into the resident banks).
    Zero weight staging: the plan only reads resident rows.

    Outputs and per-(request, tile) OpCounts are bit-identical to executing
    the layers one at a time through `_execute_staged` (the layer-major
    oracle); only the WAVE axis — and hence the executed wave serialization
    — changes.

    The activation codes of ALL layers cross to the host in one copy (the
    launch's only wait on the device when no fault model runs): the host
    encodes and bills from them, while the code matmuls read the same codes
    on the device.

    `fault` runs the step under injection: each wave's accumulator is
    ABFT-verified against the per-slot checksums and re-executed up to
    `max_retries` times (each retry an EXTRA wave, its serialization
    recorded in `retry_wave_ops`); unresolved (request, layer, tile) cells
    land in the returned `fault` trace for the engine's quarantine/degrade
    escalation. With `fault=None` the path is the pre-fault executor.

    `lane_mask` (B,) bool runs the CAPACITY program at partial occupancy:
    the launch still carries B == `plan.b_max` lanes, but masked lanes'
    codes and popcounts are zeroed before the wave walk, the resident
    ledgers are armed with the mask (masked lanes bill exactly zero ops),
    fault injection draws only over active lanes, and masked output rows
    come back zero. Active lanes are bit-identical — outputs AND
    per-(request, tile) OpCounts — to a compacted fixed-B launch of just
    those lanes.

    Host-side encoding is SPECULATIVE: the walk encodes each layer (in
    layer order) just before the first wave that executes one of its tiles
    — layer k+1's encode runs under layer k's waves, the §V-E overlap
    extended across the fused program. `timing.price_program` prices that
    pipeline with the run's own `encode_layer_ops`.
    """
    L = plan.layers
    if len(aqs) != L or len(wqs) != L:
        raise ValueError(f"{len(aqs)} activations / {len(wqs)} weights for "
                         f"a {L}-layer plan")
    if templates_list is None:
        templates_list = [None] * L
    dev = plan.device
    C_total = int(plan.chunk0[-1])
    a_devs = []
    B = None
    for l, aq in enumerate(aqs):
        a = _codes_on(aq.values, dev)
        if a.ndim != 2:
            raise ValueError(
                f"fused program execution takes (B, N) lane batches; layer "
                f"{l} got shape {tuple(a.shape)}")
        if B is None:
            B = a.shape[0]
        elif a.shape[0] != B:
            raise ValueError(
                f"every layer shares the decode lane batch: layer {l} has "
                f"B={a.shape[0]}, layer 0 has B={B}")
        a_devs.append(a)
    # one device-to-host copy of every layer's codes
    flat = _host_codes(torch.cat([a.reshape(-1).to(torch.uint8)
                                  for a in a_devs]))
    bounds = np.cumsum([0] + [a.numel() for a in a_devs])
    a_us = [flat[bounds[l]:bounds[l + 1]].reshape(tuple(a.shape))
            for l, a in enumerate(a_devs)]

    if plan.b_max is not None and B != plan.b_max:
        raise ValueError(
            f"capacity program compiled for b_max={plan.b_max} lanes, "
            f"launched with B={B} — run at capacity and express occupancy "
            f"through lane_mask")
    lane_mask = _lane_mask_arg(lane_mask, B)
    active_b = B if lane_mask is None else int(np.count_nonzero(lane_mask))
    keep = _keep(lane_mask, dev)

    for st in plan.stageds:
        for g in st.groups:
            g.bank.set_batch(B, lane_mask)

    codes_g = torch.zeros((B, C_total, plan.n_pad), dtype=torch.float32,
                          device=dev)
    popc_g = np.zeros((B, C_total, plan.p_max), dtype=np.int64)
    skipped: list = [None] * L
    r_bits_l: list = [None] * L
    encode_layer_ops = np.zeros(L, dtype=np.int64)
    slot_layer = np.asarray([s.layer for s in plan.sched.slots],
                            dtype=np.int64)
    slot_wave = np.asarray([s.wave for s in plan.sched.slots],
                           dtype=np.int64)
    first_wave = np.full(L, len(plan.waves), dtype=np.int64)
    np.minimum.at(first_wave, slot_layer, slot_wave)

    # Data-INdependent charges for the whole program up front (broadcast
    # statics, masked lanes zeroed); each layer's data-DEPENDENT add
    # billing joins when the layer is encoded. Command ACCOUNTING is
    # order-independent, so the ledgers see exactly what an up-front
    # executor would bill.
    counts_all = np.broadcast_to(plan.static,
                                 (B,) + plan.static.shape).copy()
    if lane_mask is not None:
        counts_all *= lane_mask[:, None, None]

    def _encode_layer(l: int) -> None:
        """Host-side encode of layer l's (B, N_l) lane batch: its popcount
        rows and its slots' data-dependent add templates (one einsum over
        just this layer's slots); its codes go into the device code rows
        straight from the device activations."""
        st = plan.stageds[l]
        _codes, popc, zeros, sk, rb = _chunk_arrays_batched(
            a_us[l], st.n, st.n_sub, st.p, sparsity, templates_list[l])
        c0, c1 = int(plan.chunk0[l]), int(plan.chunk0[l + 1])
        a = a_devs[l].to(torch.float32)
        pad = st.n_chunks * st.n_sub - st.n
        if pad:
            a = torch.nn.functional.pad(a, (0, pad))
        blk = a.reshape(B, st.n_chunks, st.n_sub)
        if keep is not None:
            blk = torch.where(keep[:, None, None], blk, 0.0)
        codes_g[:, c0:c1, :st.n_sub] = blk
        for ci in range(st.n_chunks):
            bill = popc[ci] if zeros[ci] is None else popc[ci] + zeros[ci]
            popc_g[:, c0 + ci, :st.p] = bill
        if lane_mask is not None:
            popc_g[~lane_mask, c0:c1] = 0
            sk = sk * lane_mask
        skipped[l] = sk
        r_bits_l[l] = rb
        encode_layer_ops[l] = active_b * st.n * st.p
        sl = np.nonzero(slot_layer == l)[0]
        popc_s = popc_g[:, plan.gchunk[sl], :]            # (B, S_l, p_max)
        counts_all[:, sl, _RC_I] += np.einsum("bsk,sk->bs", popc_s,
                                              plan.add_rc[sl])
        m3 = np.einsum("bsk,sk->bs", popc_s, plan.add_m3[sl])
        counts_all[:, sl, _M3_I] += m3
        counts_all[:, sl, _M5_I] += m3

    wave_max = np.zeros((len(plan.waves), _F), dtype=np.int64)
    trace = FaultTrace() if fault is not None else None
    retry_wave_ops: list = []
    # the rows end up holding the bank's final time-shared occupant — the
    # last ACTIVE lane under occupancy masking
    last_lane = (-1 if lane_mask is None
                 else int(np.nonzero(lane_mask)[0][-1]))
    partials_flat = torch.zeros((B, int(plan.out0[-1])), dtype=torch.int64,
                                device=dev)
    next_enc = 0
    for w, wv in enumerate(plan.waves):
        # speculative encode deadline: every layer with a tile in this (or
        # an earlier) wave must be encoded; the host encodes in layer
        # order, so that's the prefix through the last such layer
        need = np.nonzero(first_wave <= w)[0]
        need_hi = int(need[-1]) + 1 if need.size else 0
        while next_enc < need_hi:
            _encode_layer(next_enc)
            next_enc += 1
        lo, hi = wv.lo, wv.hi
        wave_max[w] = counts_all[:, lo:hi].sum(axis=0).max(axis=0)
        codes_w = codes_g[:, plan.gchunk_t[lo:hi], :]     # (B, T, n_pad)
        # §V-D linearity collapse across the WHOLE fused wave: one matmul
        # advances every member tile, each against its own layer's resident
        # rows (zero-padding past a tile's reduction depth contributes 0)
        acc = _acc_matmul(codes_w, plan.matrix[lo:hi],
                          plan.mask_r_t[lo:hi])            # (B, T, cols)
        if fault is not None:
            acc = _verify_and_retry_wave(plan, wv, codes_w, acc, counts_all,
                                         fault, max_retries, trace,
                                         retry_wave_ops,
                                         lane_mask=lane_mask)
        # readout: every tile's own slot columns and q shifts
        ti = torch.arange(hi - lo, device=dev)[:, None, None]
        vals = (acc[:, ti, plan.colidx_t[lo:hi]]
                * plan.mult_t[lo:hi]).sum(dim=-1)         # (B, T, m_max)
        partials_flat[:, plan.gout_t[wv.out_lo:wv.out_hi]] = \
            vals.reshape(B, -1)[:, wv.valid_idx]
        # the resident banks stay the accounting + bit-state authority:
        # bill each segment's ledger and materialize the final time-shared
        # accumulator state of exactly the tiles this wave advanced
        for seg in wv.segments:
            seg.group.bank.charge_counts(
                counts_all[:, lo + seg.lo:lo + seg.hi], tiles=seg.pos)
            write_accumulator_wave(seg.group.bank, seg.group.lay,
                                   acc[last_lane, seg.lo:seg.hi],
                                   tiles=seg.pos_t)

    # a layer with no scheduled tile never hit an encode deadline — encode
    # it now so skipped/r_bits are complete (degenerate, defensive)
    while next_enc < L:
        _encode_layer(next_enc)
        next_enc += 1

    rt_arrs, outs, partials = [], [], []
    counts_total = np.zeros(_F, dtype=np.int64)
    for l, (st, aq, wq) in enumerate(zip(plan.stageds, aqs, wqs)):
        rt = np.zeros((B, st.tiles, _F), dtype=np.int64)
        for g in st.groups:
            rt[:, g.tiles_idx] = g.bank.counts_matrix()
        counts_total += rt.sum(axis=(0, 1))
        rt_arrs.append(rt)
        n_sub, n_chunks, gs, grp = _partition_checks(st.n, wq, plan.geom)
        part = partials_flat[:, plan.out0[l]:plan.out0[l + 1]] \
            .reshape(B, st.n_chunks, st.m)
        partials.append(part)
        out = _aggregate_host(part, a_devs[l], wq.values.to(dev), aq, wq,
                              n_chunks, n_sub, gs, grp)
        out = out * aq.scale.to(device=dev,
                                dtype=torch.float64).reshape(B, 1)
        # the host zero-point correction sees masked lanes' raw
        # activations — their rows are contractually zero
        outs.append(_zero_masked(out, keep).to(torch.float32))
    return ProgramRunResult(outs=outs, rt_arrs=rt_arrs, skipped=skipped,
                            r_bits=r_bits_l, wave_max=wave_max,
                            retry_wave_ops=retry_wave_ops, fault=trace,
                            counts_total=counts_total,
                            encode_layer_ops=encode_layer_ops,
                            partials=partials)


def _gemv_tile_on_slots(w_tile, a_tile, q, p, sparsity, geom,
                        reliable_cols, slots, plan=None, naive=False):
    """Tile execution with per-output column slots on reliable runs."""
    n_sub, m_sub = w_tile.shape
    dev = w_tile.device if isinstance(w_tile, torch.Tensor) else "cpu"
    lay = HorizontalLayout(n_sub=n_sub, m_sub=geom.subarray_cols // q,
                           q=q, p=p, subarray_rows=geom.subarray_rows,
                           subarray_cols=geom.subarray_cols)
    sub = Subarray(rows=geom.subarray_rows, cols=geom.subarray_cols,
                   reliable_cols=reliable_cols[:geom.subarray_cols],
                   device=dev)
    cols = sub.cols
    sub.host_write_row(lay.zero_row, torch.zeros(cols, dtype=torch.uint8,
                                                 device=dev))
    sub.host_write_row(lay.one_row, torch.ones(cols, dtype=torch.uint8,
                                               device=dev))
    w = _codes_on(w_tile, dev).to(torch.int32)
    at = _index(slots[:m_sub], dev)
    for j in range(n_sub):
        row = torch.zeros(cols, dtype=torch.uint8, device=dev)
        for i in range(q):
            row[at + i] = ((w[j] >> i) & 1).to(torch.uint8)
        sub.host_write_row(lay.matrix_rows[j], row)
        sub.host_write_row(lay.inv_matrix_rows[j], 1 - row)
    preload = sub.counts
    sub.counts = OpCounts()
    if plan is None:
        plan = _plan_for(a_tile, n_sub, p, sparsity, naive)
    _run_plan(sub, lay, plan)
    rows = torch.stack([sub.host_read_row(r) for r in lay.acc_rows])
    col_vals = _decode_rows(rows)
    idx = at[:, None] + torch.arange(q, device=dev)[None, :]
    out = (col_vals[idx]
           << torch.arange(q, dtype=torch.int64, device=dev)).sum(dim=1)
    sub.counts.host_int_ops += m_sub * q
    return out, sub.counts, preload


# ---------------------------------------------------------------------------
# Analytic cost models (same formulas as the simulator; validated by test)
# ---------------------------------------------------------------------------

def mvdram_tile_cost(n_sub: int, q: int, p: int, bit_density: float,
                     sparsity: bool = True, r: Optional[int] = None) -> OpCounts:
    """Expected runtime ops of one subarray tile.

    bit_density = average fraction of set activation bits (paper uses 50%).
    Chain length of an add at bit-offset k is r - k (static templates, §V-C).
    """
    if r is None:
        r = accumulator_width(n_sub, p)
    c = OpCounts(row_copy=2 * r)  # clear_accumulator
    for k in range(p):
        n_adds = n_sub * (bit_density if sparsity else 1.0)
        a = adder_cost(r - k)
        c = c.merge(OpCounts(
            row_copy=int(round(a.row_copy * n_adds)),
            maj3=int(round(a.maj3 * n_adds)),
            maj5=int(round(a.maj5 * n_adds))))
    return c


@dataclasses.dataclass
class GemvCost:
    """Analytic cost of a full M×N q-bit × p-bit GeMV (one engine launch)."""

    m: int
    n: int
    q: int
    p: int
    tiles: int
    waves: int                 # ceil(tiles / geom.parallel_tiles)
    ops_per_tile: OpCounts
    runtime: OpCounts          # all tiles
    r_bits: int
    aggregate_bits: int        # DRAM→host output bits
    encode_host_ops: int       # O(N·p) command-template patching
    vector_prearrange_bits: int  # host→DRAM activation writes (0 for MVDRAM)
    # Per-wave weight staging (matrix + complement rows + constants): paid
    # once per GeMV launch — and once per BATCH under cross-request wave
    # sharing (`timing.price_gemv_batched` amortizes exactly this).
    weight_load_bits: int = 0


def mvdram_gemv_cost(m: int, n: int, q: int, p: int,
                     bit_density: float = 0.5, sparsity: bool = True,
                     geom: PudGeometry = PudGeometry(),
                     usable_cols: Optional[int] = None) -> GemvCost:
    """Cost of MVDRAM's horizontal-layout GeMV at real-DRAM geometry."""
    cols = usable_cols if usable_cols is not None else geom.real_cols
    n_sub = min(geom.n_sub_max, n)
    n_chunks = math.ceil(n / n_sub)
    m_per_tile = cols // q
    col_chunks = math.ceil(m / m_per_tile)
    tiles = n_chunks * col_chunks
    r = accumulator_width(n_sub, p)
    per_tile = mvdram_tile_cost(n_sub, q, p, bit_density, sparsity, r)
    runtime = per_tile.scaled(tiles)
    agg_bits = tiles * r * cols
    runtime.host_bits_read = agg_bits
    runtime.host_int_ops = tiles * min(m, m_per_tile) * q
    return GemvCost(m=m, n=n, q=q, p=p, tiles=tiles,
                    waves=math.ceil(tiles / geom.parallel_tiles),
                    ops_per_tile=per_tile, runtime=runtime, r_bits=r,
                    aggregate_bits=agg_bits, encode_host_ops=n * p,
                    vector_prearrange_bits=0,
                    # per tile: 2 constant rows + one (matrix, complement)
                    # row pair per reduction row of its chunk; summing the
                    # chunk lengths (Σ n_c = n) keeps this exact on ragged
                    # shapes, reconciling with the simulator's staged bits
                    weight_load_bits=col_chunks
                    * (2 * n_chunks + 2 * n) * cols)


def conventional_pud_cost(m: int, n: int, q: int, p: int,
                          bit_density: float = 0.5,
                          geom: PudGeometry = PudGeometry()) -> GemvCost:
    """Cost of the conventional vertical-layout PUD GeMV (paper §III, Fig. 5).

    One column per output ⇒ M columns used; the p-bit activation vector must
    be PRE-ARRANGED into every output's column (M·N·p host-written bits), and
    outputs come back bit-transposed (host transpose ops ∝ M·r).
    """
    lay = VerticalLayout(n_sub=1, m_sub=1, q=q, p=p)  # for r only
    # Rows limit the reduction chunk: each column stacks n_v·(q+p) operand bits.
    n_v = max(1, (geom.subarray_rows - 2 * lay.r - 16) // (q + p))
    n_chunks = math.ceil(n / n_v)
    col_chunks = math.ceil(m / geom.real_cols)
    tiles = n_chunks * col_chunks
    r = lay.r
    # Per column-MAC: q·p AND partial products (MAJ3 + 4 copies each) and
    # (q·p - 1) ripple adds of ~r bits to accumulate them + n_v accumulations.
    per_mac = OpCounts(row_copy=5 * q * p, maj3=q * p)
    adds_per_mac = q * p  # partial-product aggregation (bit-serial)
    add = adder_cost(r)
    per_col = OpCounts(
        row_copy=(per_mac.row_copy + add.row_copy * adds_per_mac) * n_v,
        maj3=(per_mac.maj3 + add.maj3 * adds_per_mac) * n_v,
        maj5=add.maj5 * adds_per_mac * n_v)
    runtime = per_col.scaled(tiles)  # all M columns advance in lock-step
    agg_bits = tiles * r * geom.real_cols
    runtime.host_bits_read = agg_bits
    runtime.host_bits_written = m * n * p  # the pre-arranging cost (§V-A)
    runtime.host_int_ops = m * r * n_chunks  # bit-transposition (§VI-A)
    return GemvCost(m=m, n=n, q=q, p=p, tiles=tiles,
                    waves=math.ceil(tiles / geom.parallel_tiles),
                    ops_per_tile=per_col, runtime=runtime, r_bits=r,
                    aggregate_bits=agg_bits, encode_host_ops=0,
                    vector_prearrange_bits=m * n * p,
                    weight_load_bits=m * n * q)
