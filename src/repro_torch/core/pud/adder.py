"""Static cost of one dual-track MAJ-based add (port of `adder_cost` from
the JAX package's `core/pud/adder.py`, paper §II-C1, §VII).

Unmodified DRAM has no NOT, so every logical value is kept in two tracks
(value row and complement row); a full adder is s1 = MAJ3(x0, x1, x2),
s0 = MAJ5(x0, x1, x2, ~s1, ~s1), and MAJX destroys its inputs, so operands
are RowCopied into scratch rows first. The functional adders that execute
these streams come with the simulator's port.
"""
from __future__ import annotations

import functools

from .device import OpCounts


@functools.lru_cache(maxsize=None)
def adder_cost(chain_len: int) -> OpCounts:
    """Op count of one add with the given ripple length.

    Per bit 22 RowCopy + 2 MAJ3 + 2 MAJ5; +2 RowCopy carry-track
    initialization. This IS the static command template for one add —
    the stream depends only on (offset, chain_len), never on in-DRAM data.
    Cached per chain length; callers treat the returned OpCounts as
    immutable, like the template instances.
    """
    return OpCounts(row_copy=22 * chain_len + 2, maj3=2 * chain_len,
                    maj5=2 * chain_len)
