"""The analytic cost half of in-DRAM GeMV (port of the command templates
and cost models of the JAX package's `core/pud/gemv.py`, paper §V–§VI).

Per subarray tile (n_sub reduction rows × m_sub outputs, q weight bits, p
activation bits) the processor scans the activation codes bit by bit and
emits `acc += matrix_row[j] << k` for each set bit k of a_u[j] (on-the-fly
vector encoding); every bitline accumulates in parallel, so one add serves
all m_sub outputs × q weight bits at once. The command stream of one add at
bit offset k is STATIC — it depends only on (offset, chain length r − k) —
so `build_templates` precomputes one `BitOffsetTemplate` per offset, once
per tile shape, and the cost models below price whole GeMVs from them.

The functional simulator that executes these streams (staging, encoding,
the wave executor, faults) comes with the simulator's port.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

from .adder import adder_cost
from .device import OpCounts
from .layout import VerticalLayout, accumulator_width
from .schedule import PudGeometry  # noqa: F401 (re-export)


# ---------------------------------------------------------------------------
# Static command templates (paper §V-C)
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
