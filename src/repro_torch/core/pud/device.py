"""Functional model of a DRAM subarray under PUD command streams (port of
the JAX package's `core/pud/device.py`).

Unmodified-DRAM PUD exposes exactly two primitives (paper §II-C), both
realized by timing-violating ACT/PRE sequences:

  RowCopy  — ACT(src) → PRE → ACT(dst) before precharge completes: the bitline
             still carries src's values, so dst's cells latch them.
  MAJX     — ACT/PRE/ACT in rapid succession activates X rows simultaneously;
             the sense amplifiers resolve each bitline to the MAJORITY of the
             X connected cells, and that value is written back to ALL X rows
             (inputs are destroyed — callers must copy operands first).

The model is bit-exact and column-parallel. The BIT STATE (`data`) is a
torch uint8 tensor on the device the caller names — the device of the
weight leaf being simulated: the card in serving, the CPU in the tests.
The COMMAND LEDGER (`counts`, `shared`, `extra`) is int64 on the host, in
numpy, exactly as the JAX package keeps it: it depends only on host-known
quantities (static templates, activation popcounts), so it never waits on
the device. Host reads/writes of rows are tracked separately — they model
the DDR data-bus traffic that PUD avoids (or, for output aggregation,
requires).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class OpCounts:
    """Command + data-bus accounting for one PUD execution."""

    row_copy: int = 0
    maj3: int = 0
    maj5: int = 0
    majx_other: int = 0
    host_bits_written: int = 0   # processor → DRAM (pre-arranging cost)
    host_bits_read: int = 0      # DRAM → processor (output aggregation)
    host_int_ops: int = 0        # processor-side aggregation arithmetic

    def merge(self, other: "OpCounts") -> "OpCounts":
        return OpCounts(*(getattr(self, f) + getattr(other, f)
                          for f in _COUNT_FIELDS))

    def scaled(self, k: int) -> "OpCounts":
        return OpCounts(*(getattr(self, f) * k for f in _COUNT_FIELDS))

    @property
    def pud_ops(self) -> int:
        return self.row_copy + self.maj3 + self.maj5 + self.majx_other

    def asdict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_vector(cls, vec) -> "OpCounts":
        """An `OpCounts` from a `_COUNT_FIELDS`-ordered count vector — the
        array-native form the `BankArray` ledger and the program executor
        carry."""
        vec = [int(v) for v in vec]
        if len(vec) != len(_COUNT_FIELDS):
            raise ValueError(
                f"count vector has {len(vec)} entries, "
                f"expected {len(_COUNT_FIELDS)}")
        return cls(*vec)

    def vector(self) -> np.ndarray:
        """The `_COUNT_FIELDS`-ordered int64 vector form (inverse of
        `from_vector`)."""
        return np.asarray([getattr(self, f) for f in _COUNT_FIELDS],
                          dtype=np.int64)


_COUNT_FIELDS = tuple(f.name for f in dataclasses.fields(OpCounts))


def as_bits(bits, device) -> torch.Tensor:
    """A 0/1 row block (numpy, list or tensor) as uint8 on `device`."""
    if isinstance(bits, torch.Tensor):
        return bits.to(device=device, dtype=torch.uint8)
    return torch.as_tensor(np.asarray(bits).astype(np.uint8), device=device)


def _reliable(reliable_cols, cols: int, device):
    """(host bool mask, device bool mask, all reliable?) of a column
    reliability mask (None: every column reliable)."""
    if reliable_cols is None:
        rel = np.ones(cols, dtype=bool)
    elif isinstance(reliable_cols, torch.Tensor):
        rel = reliable_cols.cpu().numpy().astype(bool)
    else:
        rel = np.asarray(reliable_cols).astype(bool)
    return rel, torch.as_tensor(rel, device=device), bool(rel.all())


class Subarray:
    """One DRAM subarray: `rows` wordlines × `cols` bitlines of single bits,
    held on `device`."""

    def __init__(self, rows: int = 512, cols: int = 1024,
                 reliable_cols=None, device="cpu"):
        self.rows = rows
        self.cols = cols
        self.device = torch.device(device)
        self.data = torch.zeros((rows, cols), dtype=torch.uint8,
                                device=self.device)
        self.counts = OpCounts()
        # Reliability mask (paper Table I): MAJX results are only trusted on
        # calibrated columns; MVDRAM places operands on reliable columns only.
        self.reliable, self._rel, _ = _reliable(reliable_cols, cols,
                                                self.device)
        # Optional fault injection (faults.FaultSession): when set, every
        # MAJX result may be corrupted per the session's model. `fault_key`
        # is this subarray's (channel, bank) identity for weak-cell lookup.
        self.fault_session = None
        self.fault_key = (0, 0)

    # -- PUD primitives ------------------------------------------------------

    def row_copy(self, src: int, dst: int) -> None:
        self.data[dst] = self.data[src]
        self.counts.row_copy += 1

    def majx(self, rows: list[int]) -> None:
        """Simultaneous activation of len(rows) rows: every bitline resolves to
        the majority of the connected cells; the result overwrites ALL
        activated rows. On non-reliable columns the analog outcome is
        undefined — modeled as unchanged (MVDRAM never reads them)."""
        x = len(rows)
        if x % 2 != 1 or x < 3:
            raise ValueError(f"MAJX needs an odd row count >= 3, got {x} "
                             f"rows {list(rows)!r}")
        votes = self.data[list(rows)].sum(dim=0)
        result = (votes > x // 2).to(torch.uint8)
        out = torch.where(self._rel, result, self.data[rows[0]])
        if self.fault_session is not None:
            flips = self.fault_session.flip_columns(self.cols,
                                                    *self.fault_key)
            # analog upsets only matter on columns MVDRAM trusts
            out = out ^ as_bits(flips & self.reliable, self.device)
        for r in rows:
            self.data[r] = out
        if x == 3:
            self.counts.maj3 += 1
        elif x == 5:
            self.counts.maj5 += 1
        else:
            self.counts.majx_other += 1

    # -- host (processor) access over the DDR data bus ------------------------

    def host_write_row(self, row: int, bits) -> None:
        if tuple(bits.shape) != (self.cols,):
            raise ValueError(f"host_write_row expects a ({self.cols},) row, "
                             f"got shape {tuple(bits.shape)}")
        self.data[row] = as_bits(bits, self.device)
        self.counts.host_bits_written += self.cols

    def host_read_row(self, row: int) -> torch.Tensor:
        self.counts.host_bits_read += self.cols
        return self.data[row].clone()


class BankArray:
    """All subarrays of one execution WAVE as a (tiles, rows, cols) bit array.

    The rank computes `channels × banks_per_channel` subarrays concurrently
    (paper §VII); within a wave every bank receives the same command stream
    skeleton (the static templates are shared), so a broadcast PUD primitive
    advances ALL tiles in one tensor step.

    Cross-request wave sharing: with `batch=B` the array models B activation
    vectors executed against the SAME resident weight rows. The physical bit
    state stays (tiles, rows, cols) — the B per-request command streams
    TIME-SHARE each bank back-to-back within the wave slot, so the weight
    rows are loaded exactly once (`host_write_row(s)` traffic is charged
    once). The per-request accumulator VALUES ride a (batch, tiles, cols)
    arithmetic track during execution (`adder.add_rows_batched_wave`); the
    LAST request's accumulator is what the rows materialize. Only the
    command LEDGER grows the batch axis: data-dependent compute streams are
    billed per (request, tile), while broadcast commands appear in every
    request's view.

    Command accounting is split into a `shared` OpCounts (broadcast ops every
    tile executes) plus a per-tile ledger `extra` (data-dependent add streams
    differ per tile via popcount selection), both int64 on the HOST;
    `tile_counts()` materializes the per-tile totals — per (request, tile)
    when batched — identical to what the sequential per-tile oracle counts.
    The bit state `data` lives on `device`.

    Fused cross-layer waves: the per-tile ledger spans EVERY count field, so
    tiles with heterogeneous layouts (tiles of DIFFERENT layers sharing one
    wave) can each be billed their own clear/add/readout commands in one
    `charge_counts` step; `write_accumulator_wave(..., tiles=…)`
    materializes a wave segment's final accumulator state into just the
    banks that wave touched.
    """

    # ledger columns for the narrow charge helpers
    _RC = _COUNT_FIELDS.index("row_copy")
    _M3 = _COUNT_FIELDS.index("maj3")
    _M5 = _COUNT_FIELDS.index("maj5")
    _HI = _COUNT_FIELDS.index("host_int_ops")

    def __init__(self, tiles: int, rows: int = 512, cols: int = 1024,
                 reliable_cols=None, batch: int | None = None,
                 device="cpu"):
        self.tiles = tiles
        self.rows = rows
        self.cols = cols
        self.batch = batch
        self.lane_mask = None
        self.device = torch.device(device)
        lead = () if batch is None else (batch,)
        self.data = torch.zeros((tiles, rows, cols), dtype=torch.uint8,
                                device=self.device)
        self.reliable, self._rel, self.all_reliable = _reliable(
            reliable_cols, cols, self.device)
        self.shared = OpCounts()
        self.extra = np.zeros(lead + (tiles, len(_COUNT_FIELDS)),
                              dtype=np.int64)
        # Optional fault injection: `fault_keys` is a (tiles, 2) array of
        # (channel, bank) identities so each tile of the wave draws from its
        # own bank's weak-cell map.
        self.fault_session = None
        self.fault_keys = None

    # -- broadcast PUD primitives (one command, all banks of the wave) -------

    def row_copy(self, src: int, dst: int) -> None:
        self.data[:, dst, :] = self.data[:, src, :]
        self.shared.row_copy += 1

    def majx(self, rows: list[int]) -> None:
        x = len(rows)
        if x % 2 != 1 or x < 3:
            raise ValueError(f"MAJX needs an odd row count >= 3, got {x} "
                             f"rows {list(rows)!r}")
        votes = self.data[:, list(rows), :].sum(dim=-2)
        result = (votes > x // 2).to(torch.uint8)
        out = torch.where(self._rel, result, self.data[:, rows[0], :])
        if self.fault_session is not None:
            keys = (self.fault_keys if self.fault_keys is not None
                    else [(0, 0)] * self.tiles)
            flips = self.fault_session.flip_tiles(keys, self.cols)
            out = out ^ as_bits(flips & self.reliable, self.device)
        for r in rows:
            self.data[:, r, :] = out
        if x == 3:
            self.shared.maj3 += 1
        elif x == 5:
            self.shared.maj5 += 1
        else:
            self.shared.majx_other += 1

    # -- host access (per-bank data bus; traffic uniform across the wave) ----

    def host_write_row(self, row: int, bits) -> None:
        """Broadcast one (cols,) row to every tile (constant rows); in batched
        mode the write also broadcasts across requests and is charged once —
        the physical row is loaded a single time."""
        if tuple(bits.shape) != (self.cols,):
            raise ValueError(f"host_write_row expects a ({self.cols},) row, "
                             f"got shape {tuple(bits.shape)}")
        self.data[:, row, :] = as_bits(bits, self.device)
        self.shared.host_bits_written += self.cols

    def host_write_rows(self, rows_idx, bits) -> None:
        """Per-tile block write: bits is (tiles, len(rows_idx), cols). In
        batched mode the block (the weight rows) broadcasts across requests
        and its bus traffic is charged ONCE — the shared-wave RowCopy/write
        amortization."""
        rows_idx = np.asarray(rows_idx)
        want = (self.tiles, rows_idx.shape[0], self.cols)
        if tuple(bits.shape) != want:
            raise ValueError(f"host_write_rows expects a (tiles, n_rows, "
                             f"cols) = {want} block, got shape "
                             f"{tuple(bits.shape)}")
        idx = torch.as_tensor(rows_idx, dtype=torch.long, device=self.device)
        self.data[:, idx, :] = as_bits(bits, self.device)
        self.shared.host_bits_written += rows_idx.shape[0] * self.cols

    def host_read_rows(self, rows_idx) -> torch.Tensor:
        """(tiles, len(rows_idx), cols) block read (output aggregation)."""
        rows_idx = np.asarray(rows_idx)
        self.charge_host_read(rows_idx)
        idx = torch.as_tensor(rows_idx, dtype=torch.long, device=self.device)
        return self.data[:, idx, :].clone()

    def charge_host_read(self, rows_idx) -> None:
        """Bill the readout traffic of a row block without materializing the
        copy — for callers whose VALUES come from the arithmetic track (the
        batched executor) while the bus charge is identical."""
        self.shared.host_bits_read += np.asarray(rows_idx).shape[0] * self.cols

    # -- accounting (host, int64) ---------------------------------------------

    def charge_adds(self, per_add: OpCounts, n_adds: np.ndarray) -> None:
        """Bill `n_adds[…, t]` copies of a static add template to each tile
        (each (request, tile) when batched) — one vectorized ledger update
        for the whole wave."""
        self.extra[..., self._RC] += per_add.row_copy * n_adds
        self.extra[..., self._M3] += per_add.maj3 * n_adds
        self.extra[..., self._M5] += per_add.maj5 * n_adds

    def charge_host_int_ops(self, n_per_tile: np.ndarray) -> None:
        """Bill aggregation arithmetic: (tiles,) host integer op counts
        (broadcast across the batch axis when batched — every request reads
        its own outputs back)."""
        self.extra[..., self._HI] += n_per_tile

    def charge_counts(self, delta: np.ndarray,
                      tiles: np.ndarray | None = None) -> None:
        """Merge a per-tile count-delta block into the ledger.

        delta: (…, T, len(_COUNT_FIELDS)) int64, `_COUNT_FIELDS` order —
        heterogeneous per-tile charges (each tile its OWN layout's clear /
        add / readout commands, as a fused cross-layer wave needs). `tiles`
        restricts the charge to those ledger positions (a wave SEGMENT of
        this bank); positions must be unique within one call.
        """
        if tiles is None:
            self.extra += delta
        else:
            self.extra[..., np.asarray(tiles), :] += delta

    def counts_matrix(self) -> np.ndarray:
        """Per-tile totals as a (…, tiles, len(_COUNT_FIELDS)) int64 matrix
        in `_COUNT_FIELDS` order.

        With a lane-occupancy mask armed (`set_batch(batch, lane_mask=…)`),
        MASKED lanes bill zero: their views drop both the broadcast
        `shared` commands and any per-lane `extra` charges, so a free lane
        of a capacity-`B_max` serving tick contributes nothing to per-wave
        maxima, priced costs, or ABFT-reconciled op counts."""
        base = np.array([getattr(self.shared, f) for f in _COUNT_FIELDS],
                        dtype=np.int64)
        cm = base + self.extra
        if self.batch is not None and self.lane_mask is not None:
            cm = cm * self.lane_mask[:, None, None]
        return cm

    def tile_counts(self):
        """Per-tile totals: (tiles,) list, or (batch, tiles) nested lists in
        batched mode. Shared broadcast commands appear in EVERY view."""
        cm = self.counts_matrix()
        if self.batch is None:
            return [OpCounts(*row) for row in cm.tolist()]
        return [[OpCounts(*row) for row in b] for b in cm.tolist()]

    def reset_counts(self) -> None:
        self.shared = OpCounts()
        self.extra = np.zeros_like(self.extra)

    def set_batch(self, batch: int | None,
                  lane_mask: np.ndarray | None = None) -> None:
        """Re-arm the command ledger for a new launch over `batch` requests.

        Residency sessions keep a staged `BankArray` (weight rows written
        once at placement) alive across decode steps; each step starts by
        resetting the ledger to the step's lane count. The bit STATE is
        untouched — matrix rows stay resident, accumulator rows are
        re-cleared by the executor's `clear_accumulator`.

        `lane_mask` — a (batch,) bool occupancy vector — arms the ledger
        for a CAPACITY launch: `batch` is the program's B_max and only the
        True lanes are occupied this tick; masked lanes' `counts_matrix`
        views read zero."""
        if lane_mask is not None:
            if batch is None:
                raise ValueError(
                    "lane_mask requires a batched ledger (batch=None given)")
            lane_mask = np.asarray(lane_mask, dtype=bool)
            if lane_mask.shape != (batch,):
                raise ValueError(
                    f"lane_mask shape {lane_mask.shape} does not match the "
                    f"launch capacity batch={batch}")
        self.batch = batch
        self.lane_mask = lane_mask
        lead = () if batch is None else (batch,)
        self.shared = OpCounts()
        self.extra = np.zeros(lead + (self.tiles, len(_COUNT_FIELDS)),
                              dtype=np.int64)
