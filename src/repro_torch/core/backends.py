"""Execution backends for the serving linears — the ONE place backend names
live (port of the JAX package's `core/backends.py`).

  `Backend.linear(engine, x, w, act_bits)`    one serving linear
  `Backend.linear_group(engine, x, ws, b)`    k linears sharing one input
                                              (q/k/v, up/gate)
  `Backend.run_program(engine, prog, xs)`     a compiled GemvProgram decode
                                              block — kernel: one B2
                                              launch; default: per-leaf
  `Backend.kernel_impl`                       the impl string of the
                                              bit-plane entry points

Two backends:
  * `KERNEL` (the default): the CUDA kernels for CUDA tensors — B3 for float
    activations, B1 per leaf, and B2 fusing a group into one launch — and
    their plain versions for CPU tensors;
  * `REFERENCE`: always the plain versions (the JAX package's `JnpBackend`
    twin).
The PUD simulator backend waits for the simulator's port.
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
    def kernel_impl(self) -> str:
        """The `kernels/bitplane_gemv/ops.py` impl string of this
        backend."""

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


class KernelBackend(Backend):
    """The CUDA kernels (plain versions for CPU tensors); a group of
    linears with quantized activations fuses into ONE B2 launch, bitwise
    equal to the per-leaf path."""

    name = "kernel"

    @property
    def kernel_impl(self) -> str:
        return "kernel"

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
