"""Command accounting of one PUD execution (port of the `OpCounts` ledger of
the JAX package's `core/pud/device.py`).

The functional subarray and bank-array models (`Subarray`, `BankArray`)
come with the simulator's port; the pricing reads only this ledger.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
        """An `OpCounts` from a `_COUNT_FIELDS`-ordered count vector."""
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
