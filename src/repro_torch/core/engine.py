"""The MVDRAM engine's serving-side routing (port of the part of the JAX
package's `core/engine.py` that serving runs: `MVDRAMEngine.linear`,
`MVDRAMEngine.linear_group` and `EngineLinear`).

The DRAM pool, placement, compiled `GemvProgram`s, fault injection and DDR4
pricing wait for the simulator's port (ROADMAP A9).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Sequence, Union

import torch

from . import backends as _backends
from .backends import Backend
from .bitplane import BitplaneWeights

if TYPE_CHECKING:
    from ..kernels.bitplane_gemv.program import GroupTable


class MVDRAMEngine:
    """Routes every lane-batched quantized linear of a serving model, and
    holds the member tables of the fused B2 launches."""

    def __init__(self):
        self.routed_linears = 0   # serving linears routed through linear()
        # (act_bits, leaf identities) → (leaves, member table); holding
        # the leaves keeps their storage, and so the keys, alive
        self._packed: dict = {}

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
        use and cached: weights are static, so every later decode step
        reuses it. The JAX package re-packs a slot-major copy inside each
        traced call; the numbers are the same."""
        from ..kernels.bitplane_gemv import program as bp_program
        key = (act_bits,) + tuple(
            (w.planes.data_ptr(), tuple(w.planes.shape),
             w.scale.data_ptr()) for w in ws)
        hit = self._packed.get(key)
        if hit is None:
            hit = (tuple(ws), bp_program.group_table(ws, act_bits))
            self._packed[key] = hit
        return hit[1]


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
