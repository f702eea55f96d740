"""Execution backends for the serving linears — the ONE place backend names
live (port of the JAX package's `core/backends.py`).

  `Backend.gemv(engine, handle, a, **opts)`   one registered GeMV
  `Backend.linear(engine, x, w, act_bits)`    one serving linear
  `Backend.linear_group(engine, x, ws, b)`    k linears sharing one input
                                              (q/k/v, up/gate)
  `Backend.run_program(engine, prog, xs)`     a compiled GemvProgram decode
                                              block — kernel: one B2
                                              launch; sim: the fused wave
                                              schedule; default: per-leaf
  `Backend.kernel_impl`                       the impl string of the
                                              bit-plane entry points

Three backends:
  * `KERNEL` (the default): the CUDA kernels for CUDA tensors — B3 for float
    activations, B1 per leaf, and B2 fusing a group into one launch — and
    their plain versions for CPU tensors (the JAX package's
    `PallasBackend` twin);
  * `REFERENCE`: always the plain versions (the JAX package's `JnpBackend`
    twin, and the host path the fault-recovery ladder recomputes on);
  * `SIM`: the bit-exact PUD simulator (`core/pud`), its state on the
    device of the weight leaf.
"""
from __future__ import annotations

import abc
from typing import Optional, Union

import torch


class Backend(abc.ABC):
    """One way to execute a serving linear on packed bit-plane weights."""

    #: registry name (unique)
    name: str = ""

    @property
    @abc.abstractmethod
    def kernel_impl(self) -> Optional[str]:
        """The `kernels/bitplane_gemv/ops.py` impl string of this backend;
        None for a backend with no kernel lowering (sim)."""

    @abc.abstractmethod
    def gemv(self, engine, handle, a: torch.Tensor, **opts):
        """Execute handle's GeMV on a (N,) vector or (B, N) lane batch."""

    def linear(self, engine, x: torch.Tensor, w, act_bits: Optional[int]):
        """One lane-batched serving linear on a packed weight leaf."""
        from ..kernels.bitplane_gemv import ops as bp_ops
        from .quant import QuantSpec
        if act_bits:
            return bp_ops.bitplane_gemv_bitserial(
                x, w, QuantSpec(bits=act_bits), impl=self.kernel_impl)
        return bp_ops.bitplane_gemv(x, w, impl=self.kernel_impl)

    def linear_group(self, engine, x: torch.Tensor, ws: tuple,
                     act_bits: Optional[int]) -> tuple:
        """k serving linears sharing one input. Default: per-leaf
        `linear` calls — backends that can fuse them override."""
        return tuple(self.linear(engine, x, w, act_bits) for w in ws)

    def run_program(self, engine, program, activations, *,
                    lane_mask=None, fidelity: str = "code"):
        """Execute a compiled `GemvProgram` decode block; returns per-layer
        outputs. Default: per-leaf linears — identical results, no fusion;
        masked lanes return zero rows."""
        outs = []
        for h, x in zip(program.handles, activations):
            program._check_layer(h)
            out = self.linear(engine, x, h.weights, h.a_spec.bits)
            if lane_mask is not None:
                keep = torch.as_tensor(lane_mask, dtype=torch.bool,
                                       device=out.device)
                out = torch.where(keep[:, None], out, 0.0)
            outs.append(out)
        return outs

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class ReferenceBackend(Backend):
    """The plain PyTorch versions, on any device (the kernels' oracle)."""

    name = "reference"

    @property
    def kernel_impl(self) -> str:
        return "reference"

    def gemv(self, engine, handle, a, **opts):
        from .bitplane import bitplane_gemv_bitserial, bitplane_gemv_f32
        from .quant import quantize_activations
        a = a.to(handle.weights.planes.device)
        if handle.a_spec is None:
            return bitplane_gemv_f32(a, handle.weights)
        aq = quantize_activations(a, handle.a_spec)
        return bitplane_gemv_bitserial(aq, handle.weights)


class KernelBackend(Backend):
    """The CUDA kernels (plain versions for CPU tensors); a group of
    linears with quantized activations fuses into ONE B2 launch, bitwise
    equal to the per-leaf path."""

    name = "kernel"

    @property
    def kernel_impl(self) -> str:
        return "kernel"

    def gemv(self, engine, handle, a, *, fidelity: str = "code", **opts):
        from ..kernels.bitplane_gemv import ops as bp_ops
        if handle.a_spec is None:
            return bp_ops.bitplane_gemv(a, handle.weights,
                                        impl=self.kernel_impl)
        return bp_ops.bitplane_gemv_bitserial(
            a, handle.weights, handle.a_spec, impl=self.kernel_impl,
            fidelity=fidelity)

    def linear_group(self, engine, x, ws, act_bits):
        if not act_bits or len(ws) < 2:
            return super().linear_group(engine, x, ws, act_bits)
        from ..kernels.bitplane_gemv import program as bp_program
        table = (engine.packed_group(ws, act_bits)
                 if engine is not None else None)
        return bp_program.fused_group_linears(x, ws, act_bits, table=table)

    def run_program(self, engine, program, activations, *,
                    lane_mask=None, fidelity: str = "code"):
        """The program-aware path: one B2 launch per decode block."""
        return program.run_kernel(activations, fidelity=fidelity,
                                  lane_mask=lane_mask)


class SimBackend(Backend):
    """Bit-exact PUD command-stream simulation (the ground truth), its bit
    state on the device of the weight leaf.

    Residency-aware: a 2-D lane batch against a handle whose placement is
    live in the engine's pool executes against its staged rows
    (`StagedWaves`) with zero re-staging; 1-D vectors, the naive micro-op
    oracle and `wave=False` run the per-call staging paths — and never
    touch (or lazily build) the resident staging. Returns (out, report).
    """

    name = "sim"

    @property
    def kernel_impl(self) -> None:
        return None

    def gemv(self, engine, handle, a, *, naive: bool = False,
             wave=None, **opts):
        from .pud.gemv import mvdram_gemv
        from .quant import quantize_activations
        if handle.a_spec is None:
            raise ValueError("PUD simulation needs quantized activations")
        if a.ndim not in (1, 2):
            raise ValueError(
                f"sim backend takes a (N,) vector or a (B, N) lane "
                f"batch, got shape {tuple(a.shape)}")
        if engine.is_degraded(handle):
            # the fault-recovery ladder demoted this linear to the host
            # path (persistent bank faults past the retry/quarantine
            # budget) — serve it from the plain versions, no simulated
            # command stream
            return REFERENCE.gemv(engine, handle, a), None
        resident_eligible = (a.ndim == 2 and not naive
                             and wave is not False)
        staged = engine.staged_for(handle) if resident_eligible else None
        if staged is not None:
            return engine.run_resident(handle, a, staged)
        aq = quantize_activations(a.to(handle.weights.planes.device),
                                  handle.a_spec)
        return mvdram_gemv(aq, handle.wq, sparsity=engine.sparsity,
                           geom=engine.geom, naive=naive,
                           templates=handle.templates, wave=wave)

    def linear(self, engine, x, w, act_bits):
        if not act_bits:
            raise ValueError(
                "the sim audit route executes bit-serial command "
                "streams — float-activation linears need act_bits")
        return engine.sim_linear(x, w, act_bits)

    def run_program(self, engine, program, activations, *,
                    lane_mask=None, fidelity: str = "code"):
        """The simulator executes its own fused wave schedule."""
        outs, _report = program.run(activations, lane_mask=lane_mask)
        return outs


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    if not backend.name:
        raise ValueError("backend needs a non-empty name")
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} is already registered")
    _REGISTRY[backend.name] = backend
    return backend


def backend_names() -> tuple:
    return tuple(sorted(_REGISTRY))


REFERENCE = register_backend(ReferenceBackend())
KERNEL = register_backend(KernelBackend())
SIM = register_backend(SimBackend())
DEFAULT = KERNEL


def get_backend(spec: Union[str, Backend, None]) -> Backend:
    """Resolve a backend spec: None → the default, `Backend` → itself,
    registry name → the instance."""
    if spec is None:
        return DEFAULT
    if isinstance(spec, Backend):
        return spec
    if isinstance(spec, str):
        if spec not in _REGISTRY:
            raise ValueError(
                f"unknown backend {spec!r}; registered backends: "
                f"{backend_names()}")
        return _REGISTRY[spec]
    raise TypeError(f"cannot resolve a backend from {spec!r}")


def resolve_impl(impl) -> Union[str, object]:
    """Resolve a layer-level `impl` to what the bit-plane entry points
    consume: None → the default backend's impl string; a `Backend` → its
    impl; a callable (e.g. `EngineLinear`) or an impl string passes
    through."""
    if impl is None:
        return DEFAULT.kernel_impl
    if isinstance(impl, Backend):
        return impl.kernel_impl
    return impl
