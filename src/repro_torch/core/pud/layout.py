"""Row/column allocation inside one subarray.

Port of the JAX package's `core/pud/layout.py` (plain Python, no JAX).

Horizontal matrix layout (paper §VI, Fig. 10): for an (N_sub × M_sub) q-bit
weight tile, weight bit i of output column m lives at bitline  m*q + i,
and reduction index j lives at matrix row j.  Regions (paper §IV):

  constants    : 1 all-zeros row + 1 all-ones row
  matrix rows  : N_sub rows (+ N_sub inverted rows for the dual-track adder)
  computation  : r accumulator bit rows + r complements, 2 carry tracks,
                 MAJ scratch (3 for MAJ3, 5 for MAJ5 — reused)
  output rows  : the accumulator rows themselves are read out row-wise

Accumulator width r = p + q_guard + ceil(log2(N_sub)): the max value of a
column accumulator is (2^p - 1) * N_sub.
"""
from __future__ import annotations

import dataclasses
import math


def accumulator_width(n_sub: int, p: int) -> int:
    """Bits r needed by a column accumulator: max value is (2^p − 1)·N_sub.

    Single source of truth — the layout, the command templates and the
    analytic cost models all derive r from here.
    """
    return p + math.ceil(math.log2(max(n_sub, 2))) + 1


@dataclasses.dataclass
class HorizontalLayout:
    n_sub: int              # reduction rows in this subarray (<=128, §VII)
    m_sub: int              # outputs in this subarray
    q: int                  # weight bits
    p: int                  # activation bits
    subarray_rows: int = 512
    subarray_cols: int = 1024

    def __post_init__(self):
        self.r = accumulator_width(self.n_sub, self.p)
        c = 0
        self.zero_row = c; c += 1
        self.one_row = c; c += 1
        self.matrix_rows = list(range(c, c + self.n_sub)); c += self.n_sub
        self.inv_matrix_rows = list(range(c, c + self.n_sub)); c += self.n_sub
        self.acc_rows = list(range(c, c + self.r)); c += self.r
        self.acc_c_rows = list(range(c, c + self.r)); c += self.r
        self.carry_rows = [c, c + 1]; c += 2           # carry + complement
        self.temp_rows = [c, c + 1]; c += 2            # new-carry staging
        self.scratch5 = list(range(c, c + 5)); c += 5  # MAJ3 uses first 3
        self.rows_used = c
        if self.rows_used > self.subarray_rows:
            raise ValueError(
                f"layout needs {self.rows_used} rows > {self.subarray_rows}")
        if self.q * self.m_sub > self.subarray_cols:
            raise ValueError(
                f"layout needs {self.q * self.m_sub} cols > {self.subarray_cols}")

    def col(self, m: int, i: int) -> int:
        """Bitline of weight-bit i for output m (Fig. 10)."""
        return m * self.q + i

    @property
    def cols_used(self) -> int:
        return self.q * self.m_sub

    def capacity_breakdown(self) -> dict:
        """Row usage per region — reproduces paper Fig. 15."""
        return {
            "constant_rows": 2,
            "matrix_rows": self.n_sub,
            "inverted_matrix_rows": self.n_sub,
            "computation_rows": 2 * self.r + 2 + 2 + 5,
            "output_rows": self.r,  # aliased onto acc rows; counted as in Fig.15
        }


def horizontal_capacity_report(n_sub: int, q: int = 4, p: int = 4,
                               subarray_rows: int = 512) -> dict:
    """Fraction of subarray rows spent on each region (paper Fig. 15)."""
    lay = HorizontalLayout(n_sub=n_sub, m_sub=1, q=q, p=p,
                           subarray_rows=max(subarray_rows, 4 * n_sub + 64),
                           subarray_cols=q)
    br = lay.capacity_breakdown()
    total = sum(br.values())
    return {**br, "total_rows": total,
            "overhead_fraction": (br["computation_rows"] + br["output_rows"]
                                  + br["constant_rows"]) / total}


@dataclasses.dataclass
class VerticalLayout:
    """Conventional PUD layout (paper §VI-A, Fig. 7b): every operand bit of a
    MAC is stacked vertically in ONE column; one column per output. Used only
    by the analytic cost model — MVDRAM exists to avoid this layout.

    Costs modeled:
      * input pre-arranging: the p-bit activation vector must be replicated
        into every output's column: N*p bits per column, M columns → M*N*p
        host-written bits (paper §V-A).
      * bit-transposed readout: outputs land vertically; the processor reads r
        rows and transposes M r-bit values (host_int_ops ~ M*r).
    """
    n_sub: int
    m_sub: int
    q: int
    p: int
    subarray_rows: int = 512

    def __post_init__(self):
        self.r = self.p + self.q + math.ceil(math.log2(max(self.n_sub, 2)))
        # vertical needs, per column: N*(q+p) operand bits stacked in rows +
        # accumulator + scratch → limits n_sub much harder than horizontal.
        self.rows_used = self.n_sub * (self.q + self.p) + 2 * self.r + 9

    @property
    def cols_used(self) -> int:
        return self.m_sub  # one column per output — the parallelism loss
