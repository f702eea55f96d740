"""Training loop: async checkpoints, failure recovery, elastic restart,
straggler watchdog (port of the JAX package's `train/loop.py`).

The loop's contract:
    (1) every step's data is a pure function of (seed, step)   [data/]
    (2) state advances atomically per step (in place, after the step's
        gradients exist; a failure raised before the step leaves it whole)
    (3) a committed checkpoint exists every `ckpt_every` steps [checkpoint.py]
so recovery = restore the latest commit + replay; with deterministic
kernels (`torch.use_deterministic_algorithms(True)` and
`CUBLAS_WORKSPACE_CONFIG` on CUDA) a recovered run is BITWISE identical to
an uninterrupted one. `SimulatedFailure` injects failures for tests and
drills.

On a mesh over a process group (`launch.mesh.make_dist_mesh`, one rank a
device) parameters and AdamW moments are DTensors placed by their logical
specs (`defs_to_shardings`), the step is the sharded one
(`train/step.py`), and checkpoints gather on save and re-place on restore.
Elastic restart: build a Trainer on a DIFFERENT mesh and restore the same
directory — leaves are re-placed by the new mesh's logical rules.

Straggler watchdog: an EWMA-style median of step times flags outliers
(> factor × median) as events.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..data.pipeline import SyntheticLM
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.model import Model, param_defs
from ..models.params import init_params
from ..optim.adamw import AdamWConfig, adamw_init
from ..parallel.sharding import axis_rules, defs_to_shardings, place
from . import checkpoint as ckpt
from .step import make_train_step


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerConfig:
    num_microbatches: int = 1
    z_loss: float = 1e-4
    remat: bool = False
    compress_grads: bool = True
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_async: bool = True
    keep_ckpts: int = 3
    straggler_factor: float = 3.0
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, opt: AdamWConfig,
                 tcfg: TrainerConfig, mesh=None, rules: Optional[dict] = None,
                 global_batch: int = 8, seq_len: int = 128,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 device=None):
        sharded = getattr(mesh, "device_mesh", None) is not None
        if mesh is not None and mesh.devices.size > 1 and not sharded:
            raise ValueError(
                f"a mesh of {mesh.devices.size} devices without a process "
                f"group: one process drives one device; build the mesh "
                f"with launch.mesh.make_dist_mesh, one rank a device")
        self.cfg, self.opt, self.tcfg = cfg, opt, tcfg
        self.mesh, self.rules = mesh, rules
        if sharded and device is None:
            device = mesh.local_device
        self.device = resolve_device(device)
        self.model = Model(cfg)
        self.defs = param_defs(cfg)
        self.data = SyntheticLM(
            vocab=cfg.vocab_size, seq=seq_len, batch=global_batch,
            seed=tcfg.seed,
            embed_dim=cfg.d_model if cfg.input_mode == "embeddings" else 0)
        self.failure_hook = failure_hook
        self.step_times: list = []
        self.straggler_events: list = []
        self.recoveries = 0
        self._step = make_train_step(self.model, opt, tcfg.num_microbatches,
                                     tcfg.z_loss, tcfg.remat,
                                     tcfg.compress_grads,
                                     mesh if sharded else None, rules)
        self.param_sh = self.opt_sh = None
        if sharded:
            with axis_rules(mesh, rules):
                self.param_sh = defs_to_shardings(self.defs)
            self.opt_sh = {"m": self.param_sh, "v": self.param_sh,
                           "count": None}

    # -- state ----------------------------------------------------------------

    def init_state(self):
        """Params from the seed (the same whole tree on every rank, each
        rank keeping its shards when sharded) and zero moments."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = init_params(self.defs, gen, self.device)
        if self.param_sh is not None:
            params = place(params, self.param_sh)
        return 0, params, adamw_init(params)

    def restore_or_init(self):
        if self.tcfg.ckpt_dir:
            path = ckpt.latest_checkpoint(self.tcfg.ckpt_dir)
            if path:
                sh = ({"params": self.param_sh, "opt": self.opt_sh}
                      if self.param_sh is not None else None)
                step, tree = ckpt.restore_checkpoint(path, self.device, sh)
                return step, tree["params"], tree["opt"]
        return self.init_state()

    # -- loop -----------------------------------------------------------------

    def run(self, num_steps: int, log_every: int = 10):
        step, params, opt_state = self.restore_or_init()
        history = []
        target = step + num_steps
        while step < target:
            batch = self.data.batch_at(step, device=self.device)
            t0 = time.perf_counter()
            try:
                if self.failure_hook:
                    self.failure_hook(step)
                with axis_rules(self.mesh, self.rules):
                    params, opt_state, metrics = self._step(
                        params, opt_state, batch)
                # the step's one host wait
                loss, ppl, gnorm = torch.stack(
                    [metrics["loss"], metrics["ppl"],
                     metrics["grad_norm"]]).tolist()
            except SimulatedFailure:
                self.recoveries += 1
                ckpt.wait_for_saves()
                params = opt_state = None          # free before restoring
                step, params, opt_state = self.restore_or_init()
                continue
            dt = time.perf_counter() - t0
            self._watch_stragglers(step, dt)
            step += 1
            if step % log_every == 0 or step == target:
                history.append({"step": step, "loss": loss, "ppl": ppl,
                                "grad_norm": gnorm, "sec_per_step": dt})
            if (self.tcfg.ckpt_dir and
                    (step % self.tcfg.ckpt_every == 0 or step == target)):
                ckpt.save_checkpoint(self.tcfg.ckpt_dir, step,
                                     {"params": params, "opt": opt_state},
                                     keep=self.tcfg.keep_ckpts,
                                     async_=self.tcfg.ckpt_async)
        ckpt.wait_for_saves()
        return params, opt_state, history

    def _watch_stragglers(self, step: int, dt: float):
        self.step_times.append(dt)
        if len(self.step_times) >= 8:
            ewma = float(np.median(self.step_times[-32:]))
            if dt > self.tcfg.straggler_factor * ewma:
                self.straggler_events.append(
                    {"step": step, "sec": dt, "median": ewma})
