"""Training launcher (port of the JAX package's `launch/train.py`, plus
`--device`):

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b \
        --tiny --steps 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --tiny --steps 200 --batch 8 --seq 128 --ckpt-dir runs/run1
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama2-7b --tiny --steps 20 --mesh-model 2

Runs on the GPU unless `--device cpu` is given, with deterministic kernels
(`torch.use_deterministic_algorithms(True)`; cuBLAS gets the fixed
workspace `CUBLAS_WORKSPACE_CONFIG` that this needs), so a run recovered
from a checkpoint is bitwise the uninterrupted one. The mode only warns
for an op with no deterministic CUDA implementation (a float `cumsum`:
the MoE dispatch's ranks, the Mamba2 scan). One process trains on one
device. Under `torchrun` (WORLD_SIZE > 1) each rank takes one device
(CUDA device LOCAL_RANK on `nccl`, or the CPU on `gloo` with
`--device cpu`) and the run is sharded over a ("data", "model") mesh of
WORLD_SIZE / --mesh-model by --mesh-model (`launch.mesh.make_dist_mesh`).
Prints one JSON line of history a logged step (rank 0 only).
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from ..configs import ARCHS, get_config, tiny_config
from ..device import resolve_device
from ..models.model import stack_plan
from ..optim.adamw import AdamWConfig
from ..train.loop import Trainer, TrainerConfig
from .mesh import make_dist_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)

    # read when cuBLAS makes its first handle, so before any CUDA work
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _train(args)
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def _train(args) -> None:
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1:
        if world % args.mesh_model:
            raise ValueError(f"--mesh-model {args.mesh_model} does not "
                             f"divide {world} ranks")
        mesh = make_dist_mesh((world // args.mesh_model, args.mesh_model),
                              ("data", "model"), args.device)
        device, lead = mesh.local_device, torch.distributed.get_rank() == 0
    else:
        mesh, device, lead = None, resolve_device(args.device), True
    cfg = tiny_config(args.arch) if args.tiny else get_config(args.arch)
    if lead:
        print(f"arch={cfg.name} plan={stack_plan(cfg)} devices={world} "
              f"mesh={mesh and mesh.shape}")

    trainer = Trainer(
        cfg,
        AdamWConfig(lr=args.lr, total_steps=args.steps,
                    warmup_steps=max(args.steps // 20, 5)),
        TrainerConfig(num_microbatches=args.microbatches, remat=args.remat,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        mesh=mesh, global_batch=args.batch, seq_len=args.seq, device=device)
    _, _, history = trainer.run(args.steps)
    if lead:
        for h in history:
            print(json.dumps(h))
        if trainer.straggler_events:
            print("straggler events:", trainer.straggler_events)
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
