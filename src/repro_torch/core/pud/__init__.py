"""Processing-Using-DRAM on unmodified DRAM: the bit-exact simulator, its
cost model and the DRAM residency session (port of the JAX package's
`core/pud`; no JAX).

`device.py`    — `Subarray`/`BankArray` bit state (torch, on the device of
                 the leaf being simulated) and the `OpCounts` ledger (host)
`layout.py`    — horizontal (MVDRAM) and vertical (conventional PUD) layouts
`adder.py`     — dual-track MAJ3/MAJ5 ripple adders: micro-op, batched,
                 wave-parallel
`faults.py`    — seeded MAJX fault models, ABFT traces
`schedule.py`  — §VII channel/bank tile placement, wave scheduling, and
                 cross-layer program schedules (fused decode steps)
`residency.py` — capacity-aware DramPool placement: matrices get persistent
                 (channel, bank, row-range) homes; multi-layer co-residency
`fabric.py`    — FabricPool: several DIMM pools striped, rebalanced, with a
                 CXL spill tier
`gemv.py`      — encoding, templates, the single-subarray / per-call /
                 staged / fused executors, and the analytic cost models
`timing.py`    — DDR4-2400 command timing + energy model, CPU/GPU baselines,
                 compiled-program and fabric pricing
"""
from .device import BankArray, OpCounts, Subarray
from .layout import (HorizontalLayout, VerticalLayout, accumulator_width,
                     horizontal_capacity_report)
from .adder import adder_cost
from .faults import FaultModel, FaultPolicy, FaultSession, FaultTrace
from .schedule import (BatchSchedule, ProgramSchedule, ProgramSlot,
                       PudGeometry, TileAssignment, WaveSchedule,
                       schedule_batch, schedule_program, schedule_tiles)
from .residency import (CapacityError, DramPool, Placement, ResidencyError,
                        RowSpan, tile_resident_rows)
from .fabric import (ColumnShardPlan, FabricPool, SpillEntry, fabric_mesh,
                     plan_column_shards, requested_rows)
from .gemv import (BatchReport, BitOffsetTemplate, CommandTemplates,
                   FusedProgram, GemvCost, ProgramRunResult, StagedWaves,
                   TileReport, build_templates, conventional_pud_cost,
                   execute_program, mvdram_gemv, mvdram_gemv_batched,
                   mvdram_gemv_cost, mvdram_tile_cost, stage_matrix,
                   stage_program)
from .timing import (BatchedPudCost, CXL_TIER, CpuBaseline, CxlModel,
                     DDR4_2400, DDR4_ENERGY, DDR4Model, EnergyModel,
                     FabricCost, GpuBaseline, LPDDR5_CDPIM, ProgramCost,
                     PudCost, bank_waves, combine_fabric_costs, compare_gemv,
                     price_gemv, price_gemv_batched, price_program,
                     simulated_wave_time)
