"""Dual-track MAJ-based addition inside a subarray (port of the JAX
package's `core/pud/adder.py`, paper §II-C1, §VII).

Unmodified DRAM has no NOT, so every logical value is kept in two tracks:
the value row and its complement row (inverted matrix rows are written at
load time; accumulator/carry rows maintain both tracks throughout).

Full-adder identities used (x0,x1,x2 inputs; s1 carry, s0 sum):
    s1  = MAJ3(x0, x1, x2)
    s0  = MAJ5(x0, x1, x2, ~s1, ~s1)
and the complement track uses the self-duality of majority:
    ~MAJ(x...) = MAJ(~x...).

MAJX destroys its inputs (all activated rows are overwritten with the
result), so operands are first RowCopied into scratch rows; the scratch rows
then hold the result, which is RowCopied to its destination.

Three execution granularities share the same command accounting:

  `add_row_at_offset`       one add, micro-op by micro-op (the naive oracle —
                            every RowCopy/MAJX touches the bit array).
  `add_rows_batched`        ALL adds sharing one bit offset as a single
                            ripple-carry over an (n_adds, cols) operand
                            block; commands are charged analytically
                            (`adder_cost` per add), so OpCounts and the final
                            accumulator state are identical to the naive path.
  `add_rows_batched_wave`   the same collapse ACROSS a whole wave of banks: a
                            (tiles, n_sub) participation mask drives one
                            batched matmul over the BankArray's (tiles, rows,
                            cols) state, each tile billed for its own
                            popcount.

The bit state is torch on the bank's device; popcounts and the ledger are
numpy on the host. Every popcount product runs through `code_matmul`:
float32 with TF32 off, exact because its sums stay far below 2^24.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .device import BankArray, OpCounts, Subarray
from .layout import HorizontalLayout


def code_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched float32 `a @ b` of small integers, exact: TF32 is switched
    off for the product (every operand is an integer below 2^8 and every
    sum below 2^24, so IEEE float32 arithmetic loses nothing)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _maj3_into(sub: Subarray, lay: HorizontalLayout,
               srcs: list[int], dst: int) -> None:
    t = lay.scratch5
    for k, s in enumerate(srcs):
        sub.row_copy(s, t[k])
    sub.majx(t[:3])
    sub.row_copy(t[0], dst)


def _maj5_into(sub: Subarray, lay: HorizontalLayout,
               srcs: list[int], dst: int) -> None:
    t = lay.scratch5
    for k, s in enumerate(srcs):
        sub.row_copy(s, t[k])
    sub.majx(t)
    sub.row_copy(t[0], dst)


def add_row_at_offset(sub: Subarray, lay: HorizontalLayout,
                      x_row: int, x_c_row: int, offset: int,
                      chain_len: int) -> None:
    """Accumulator += (row x) << offset, ripple-carry over `chain_len` bits.

    chain_len is STATIC (data-independent): the caller derives it from the
    maximum value the accumulator can hold after this addition, exactly like
    MVDRAM's pre-built command templates (§V-C).

    Per bit position b (acc_b = acc bit, c = incoming carry):
        carry' = MAJ3(acc_b, c, 0)        = acc_b AND c
        sum    = MAJ5(acc_b, c, 0, ~carry', ~carry')
    (a full adder with the third input hardwired 0 — the incoming addend
    enters as the initial carry, which is what a shifted +x<<k is).
    """
    carry, carry_c = lay.carry_rows
    sub.row_copy(x_row, carry)
    sub.row_copy(x_c_row, carry_c)
    top = min(offset + chain_len, lay.r)
    for b in range(offset, top):
        acc, acc_c = lay.acc_rows[b], lay.acc_c_rows[b]
        # New carry (and complement) live in DEDICATED temp rows — they must
        # survive while scratch5 is reused as MAJ5 operand staging.
        nc, nc_c = lay.temp_rows
        t = lay.scratch5
        # carry' = MAJ3(acc, carry, zero)                       [4 rc + maj3]
        sub.row_copy(acc, t[0]); sub.row_copy(carry, t[1])
        sub.row_copy(lay.zero_row, t[2])
        sub.majx(t[:3]); sub.row_copy(t[0], nc)
        # ~carry' = MAJ3(acc_c, carry_c, one)  (majority self-duality)
        sub.row_copy(acc_c, t[0]); sub.row_copy(carry_c, t[1])
        sub.row_copy(lay.one_row, t[2])
        sub.majx(t[:3]); sub.row_copy(t[0], nc_c)
        # sum = MAJ5(acc, carry, zero, ~carry', ~carry')        [6 rc + maj5]
        sub.row_copy(acc, t[0]); sub.row_copy(carry, t[1])
        sub.row_copy(lay.zero_row, t[2])
        sub.row_copy(nc_c, t[3]); sub.row_copy(nc_c, t[4])
        sub.majx(t)
        sub.row_copy(t[0], acc)                # acc_b := sum
        # ~sum = MAJ5(acc_c, carry_c, one, carry', carry')      [6 rc + maj5]
        sub.row_copy(acc_c, t[0]); sub.row_copy(carry_c, t[1])
        sub.row_copy(lay.one_row, t[2])
        sub.row_copy(nc, t[3]); sub.row_copy(nc, t[4])
        sub.majx(t)
        sub.row_copy(t[0], acc_c)              # acc_b complement := ~sum
        # carry ← carry'                                         [2 rc]
        sub.row_copy(nc, carry)
        sub.row_copy(nc_c, carry_c)


def clear_accumulator(sub: Subarray | BankArray,
                      lay: HorizontalLayout) -> None:
    """2·r RowCopies; on a BankArray each copy broadcasts to every bank of
    the wave (one command per channel bus slot, §VII)."""
    for b in range(lay.r):
        sub.row_copy(lay.zero_row, lay.acc_rows[b])
        sub.row_copy(lay.one_row, lay.acc_c_rows[b])


@functools.lru_cache(maxsize=None)
def adder_cost(chain_len: int) -> OpCounts:
    """Op count of one `add_row_at_offset` with the given ripple length.

    Per bit 22 RowCopy + 2 MAJ3 + 2 MAJ5; +2 RowCopy carry-track
    initialization. This IS the static command template for one add —
    the stream depends only on (offset, chain_len), never on in-DRAM data.
    Cached per chain length; callers treat the returned OpCounts as
    immutable, like the template instances.
    """
    return OpCounts(row_copy=22 * chain_len + 2, maj3=2 * chain_len,
                    maj5=2 * chain_len)


def _bit_weights(r: int, device) -> torch.Tensor:
    return torch.ones(r, dtype=torch.int64, device=device) \
        << torch.arange(r, dtype=torch.int64, device=device)


def add_rows_batched(sub: Subarray, lay: HorizontalLayout,
                     matrix_js, offset: int, n_zero_adds: int = 0) -> None:
    """Accumulator += Σ_j (matrix row j) << offset, all j at once.

    Modular addition is associative, so issuing `add_row_at_offset` once per
    j (each a full ripple over chain_len = r - offset bits, i.e. addition
    mod 2^r above bit `offset`) leaves the accumulator at exactly
        acc' = (acc + Σ_j row_j << offset) mod 2^r.
    The (n_adds, cols) operand block is reduced in one step and the new
    accumulator bits (+ complements) written back.

    Commands are charged per add via `adder_cost(chain_len)` — the same
    static template the naive path executes — so OpCounts match the naive
    oracle exactly. `n_zero_adds` bills the conventional (sparsity-off)
    zero-row adds, which cost commands but cannot change the value.
    """
    matrix_js = np.asarray(matrix_js, dtype=np.int64)
    chain_len = lay.r - offset
    if matrix_js.size:
        dev = sub.device
        rows_idx = torch.as_tensor(np.asarray(lay.matrix_rows)[matrix_js],
                                   device=dev)
        addend = sub.data[rows_idx].to(torch.int64).sum(dim=0) << offset
        acc_idx = torch.as_tensor(lay.acc_rows, device=dev)
        acc_c_idx = torch.as_tensor(lay.acc_c_rows, device=dev)
        acc_val = (sub.data[acc_idx].to(torch.int64)
                   * _bit_weights(lay.r, dev)[:, None]).sum(dim=0)
        total = (acc_val + addend) & ((1 << lay.r) - 1)
        shifts = torch.arange(lay.r, dtype=torch.int64, device=dev)
        new_bits = ((total[None, :] >> shifts[:, None]) & 1).to(torch.uint8)
        rel = sub._rel[None, :]
        old, old_c = sub.data[acc_idx], sub.data[acc_c_idx]
        sub.data[acc_idx] = torch.where(rel, new_bits, old)
        sub.data[acc_c_idx] = torch.where(rel, 1 - new_bits, old_c)
    n_adds = int(matrix_js.size) + n_zero_adds
    if n_adds:
        per_add = adder_cost(chain_len)
        sub.counts.row_copy += per_add.row_copy * n_adds
        sub.counts.maj3 += per_add.maj3 * n_adds
        sub.counts.maj5 += per_add.maj5 * n_adds


# ---------------------------------------------------------------------------
# Wave-parallel execution (all banks of a wave advance in one step)
# ---------------------------------------------------------------------------

def write_accumulator_wave(bank: BankArray, lay: HorizontalLayout,
                           acc_val: torch.Tensor, tiles=None) -> None:
    """Materialize the running accumulator VALUE into the accumulator rows
    (+ complement track) of every bank of the wave.

    Callers issuing all p bit offsets pass `write_bits=False` to
    `add_rows_batched_wave` and flush once here: the intermediate row states
    are never observed. On non-reliable columns the rows keep their prior
    bits (never read out).

    Batched acc_val (B, tiles, cols): the B requests time-share the physical
    rows, so the LAST request's accumulator is the state the bank is left
    in — that is what gets materialized.

    `tiles` (host array or device index tensor) restricts the write to a
    subset of the bank's tile positions (acc_val then carries that subset
    on its tile axis) — a fused cross-layer wave touches only the SEGMENT
    of each layer's resident bank that executes in this wave.
    """
    if acc_val.ndim == 3:
        acc_val = acc_val[-1]       # the bank's final time-shared occupant
    dev = bank.device
    # the layout's accumulator rows (and their complements) are one run
    # each: index them by slice, which moves nothing to the device
    acc_idx = slice(lay.acc_rows[0], lay.acc_rows[0] + lay.r)
    acc_c_idx = slice(lay.acc_c_rows[0], lay.acc_c_rows[0] + lay.r)
    # r ≤ 16 for any legal layout, so decode in int32 (half the traffic)
    shifts = torch.arange(lay.r, dtype=torch.int32, device=dev)
    new_bits = ((acc_val.to(torch.int32)[..., None, :] >> shifts[:, None])
                & 1).to(torch.uint8)
    if tiles is not None:
        t_idx = torch.as_tensor(tiles, dtype=torch.long, device=dev)
        if bank.all_reliable:
            bank.data[t_idx, acc_idx, :] = new_bits
            bank.data[t_idx, acc_c_idx, :] = 1 - new_bits
        else:
            rel = bank._rel
            old = bank.data[t_idx, acc_idx, :]
            old_c = bank.data[t_idx, acc_c_idx, :]
            bank.data[t_idx, acc_idx, :] = torch.where(rel, new_bits, old)
            bank.data[t_idx, acc_c_idx, :] = torch.where(rel, 1 - new_bits,
                                                         old_c)
        return
    if bank.all_reliable:
        bank.data[:, acc_idx, :] = new_bits
        bank.data[:, acc_c_idx, :] = 1 - new_bits
    else:
        rel = bank._rel
        bank.data[:, acc_idx, :] = torch.where(
            rel, new_bits, bank.data[:, acc_idx, :])
        bank.data[:, acc_c_idx, :] = torch.where(
            rel, 1 - new_bits, bank.data[:, acc_c_idx, :])


def add_rows_batched_wave(bank: BankArray, lay: HorizontalLayout,
                          masks, offset: int,
                          n_zero_adds: np.ndarray | None = None,
                          matrix_block: torch.Tensor | None = None,
                          acc_val: torch.Tensor | None = None,
                          write_bits: bool = True) -> torch.Tensor:
    """Accumulator[t] += Σ_j masks[…, t, j]·(matrix row j of tile t) << offset,
    for every tile t of the wave at once.

    `masks` is the (tiles, n_sub) boolean popcount selection (host numpy,
    or a tensor) — tiles from different reduction chunks participate with
    different matrix rows, but the command TEMPLATE (offset, chain length)
    is shared, so the whole wave advances in one batched matmul + one
    accumulator rewrite. Value semantics and per-tile command charges are
    exactly `add_rows_batched` applied to each tile.

    Cross-request wave sharing: on a `BankArray(batch=B)` the masks carry a
    leading batch axis (B, tiles, n_sub) — B activation vectors' popcount
    selections against the SAME resident weight rows. One broadcast matmul
    then advances all B×tiles accumulator values, each (request, tile)
    billed for its own popcount; the physical accumulator rows materialize
    the last request's state (`write_accumulator_wave`).

    `n_zero_adds[…, t]` bills conventional zero-row adds when the
    bit-sparsity optimization is disabled. `matrix_block` (the (tiles, n_sub,
    cols) float32 matrix rows, static during compute and SHARED across the
    batch) and `acc_val` (the running (…, tiles, cols) int64 accumulator
    value) let a caller issuing all p offsets skip re-reading bank state;
    returns the updated accumulator value either way. `write_bits=False`
    defers the row materialization — the caller must finish with
    `write_accumulator_wave`.
    """
    dev = bank.device
    masks_np = (masks.cpu().numpy() if isinstance(masks, torch.Tensor)
                else np.asarray(masks))
    chain_len = lay.r - offset
    n_adds = masks_np.sum(axis=-1, dtype=np.int64)
    if acc_val is None:
        acc_idx = torch.as_tensor(lay.acc_rows, device=dev)
        acc_val = (bank.data[:, acc_idx, :].to(torch.int64)
                   * _bit_weights(lay.r, dev)[:, None]).sum(dim=-2)
        if masks_np.ndim == 3:
            # batched masks over the shared rows: every request starts from
            # the same decoded accumulator state, on its own batch lane
            acc_val = acc_val.expand(
                (masks_np.shape[0],) + tuple(acc_val.shape)).clone()
    if n_adds.any():
        if matrix_block is None:
            # (tiles, n_sub, cols) resident rows — batch-invariant by design
            rows = torch.as_tensor(lay.matrix_rows, device=dev)
            matrix_block = bank.data[:, rows, :].to(torch.float32)
        mm = torch.as_tensor(masks_np, device=dev).to(torch.float32)
        if mm.ndim == 3:   # batched (B, T, n): one batch entry per tile
            prod = code_matmul(mm.transpose(0, 1), matrix_block)  # (T, B, c)
            addend = prod.to(torch.int64).transpose(0, 1) << offset
        else:
            addend = code_matmul(mm[:, None, :], matrix_block)[:, 0, :] \
                .to(torch.int64) << offset
        acc_val = (acc_val + addend) & ((1 << lay.r) - 1)
        if write_bits:
            write_accumulator_wave(bank, lay, acc_val)
    if n_zero_adds is not None:
        n_adds = n_adds + np.asarray(n_zero_adds, dtype=np.int64)
    bank.charge_adds(adder_cost(chain_len), n_adds)
    return acc_val
