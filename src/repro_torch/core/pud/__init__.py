"""Cost model of Processing-Using-DRAM on unmodified DRAM, and the DRAM
residency session (port of the JAX package's `core/pud`; no JAX, no torch).

`device.py`    — `OpCounts`, the command + data-bus ledger
`layout.py`    — horizontal (MVDRAM) and vertical (conventional PUD) layouts
`adder.py`     — the static cost of one dual-track MAJ3/MAJ5 add
`schedule.py`  — §VII channel/bank tile placement, wave scheduling, and
                 cross-layer program schedules (fused decode steps)
`residency.py` — capacity-aware DramPool placement: matrices get persistent
                 (channel, bank, row-range) homes; multi-layer co-residency
`fabric.py`    — FabricPool: several DIMM pools striped, rebalanced, with a
                 CXL spill tier
`gemv.py`      — static command templates and the analytic GeMV cost models
`timing.py`    — DDR4-2400 command timing + energy model, CPU/GPU baselines,
                 compiled-program and fabric pricing

The bit-level simulator (subarrays, adders, staging, the wave executor,
faults) comes with a later slice.
"""
from .device import OpCounts
from .layout import (HorizontalLayout, VerticalLayout, accumulator_width,
                     horizontal_capacity_report)
from .schedule import (BatchSchedule, ProgramSchedule, ProgramSlot,
                       PudGeometry, TileAssignment, WaveSchedule,
                       schedule_batch, schedule_program, schedule_tiles)
from .residency import (CapacityError, DramPool, Placement, ResidencyError,
                        RowSpan, tile_resident_rows)
from .fabric import FabricPool, SpillEntry, requested_rows
from .gemv import (BitOffsetTemplate, CommandTemplates, GemvCost,
                   build_templates, conventional_pud_cost, mvdram_gemv_cost,
                   mvdram_tile_cost)
from .timing import (BatchedPudCost, CXL_TIER, CpuBaseline, CxlModel,
                     DDR4_2400, DDR4_ENERGY, DDR4Model, EnergyModel,
                     FabricCost, GpuBaseline, LPDDR5_CDPIM, ProgramCost,
                     PudCost, bank_waves, combine_fabric_costs, compare_gemv,
                     price_gemv, price_gemv_batched, price_program)
