"""Atomic checkpoints (port of the JAX package's `train/checkpoint.py`, the
same on-disk layout, so a checkpoint written by either package restores in
the other).

Layout (one directory per step):
    <dir>/step_00001230.tmp/   — written first
        manifest.json          — step, leaf paths, shapes, dtypes
        arrays.npz             — one entry per leaf ("|"-joined key paths)
    <dir>/step_00001230/       — atomic rename when complete
        COMMIT                 — marker written LAST; restores ignore
                                 directories without it (torn saves are
                                 invisible)

Trees are nested dicts with tensor leaves (params / opt-state layout).
bfloat16 leaves are stored as their raw 16-bit words under the manifest
dtype "bfloat16", as the JAX package's numpy bfloat16 arrays are.

Async saves snapshot every leaf to host memory synchronously (a copy, so
the next in-place step cannot change it) and write in a daemon thread;
`wait_for_saves()` joins before the next save or shutdown and re-raises
what the write raised (a full disk is an error, not a lost checkpoint).

Sharded trees (DTensor leaves, the sharded trainer's): every rank gathers
every leaf, synchronously, before the snapshot — no collective is ever
issued from the writer thread — and rank 0 alone writes; every rank waits
for the commit (a barrier after the write, in `wait_for_saves` for an
async save). `restore_checkpoint(..., shardings=...)` re-places each leaf
onto the GIVEN shardings, whose mesh may differ from the one that saved
(elastic restart onto another mesh): the layout is re-resolved by the
logical rules, not recorded in the checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device

_SEP = "|"  # path separator inside npz keys (keys may contain "/")


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _unflatten(pairs):
    root: dict = {}
    for path, val in pairs:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = val
    return root


def _to_numpy(t: torch.Tensor) -> tuple:
    """→ (array to store, manifest dtype)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                ).view(torch.bfloat16)
    if str(a.dtype) != dtype:
        a = a.view(np.dtype(dtype))
    return torch.from_numpy(a)


class _AsyncSaver:
    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.sharded = False       # the last save was a sharded tree's

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.sharded:           # every rank waits for rank 0's commit
            self.sharded = False
            torch.distributed.barrier()
        err, self._error = self._error, None
        if err is not None:
            raise err

    def submit(self, fn):
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:    # re-raised by wait()
                self._error = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()


_SAVER = _AsyncSaver()


def _is_sharded(tree) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(v, DTensor) for _, v in _flatten(tree))


def save_checkpoint(ckpt_dir: str, step: int, tree, keep: int = 3,
                    async_: bool = False) -> str:
    sharded = _is_sharded(tree)
    if sharded:
        _SAVER.wait()              # every rank: the previous commit first
    writer = not sharded or torch.distributed.get_rank() == 0
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
    # snapshot NOW: the trainer updates its tensors in place (a sharded
    # leaf is gathered on every rank, here, never in the writer thread)
    host = []
    for p, v in _flatten(tree):
        if sharded and hasattr(v, "full_tensor"):
            v = v.full_tensor()
        if writer:
            host.append((p, v.detach().to("cpu", copy=True).contiguous()))
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"

    def write():
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays, leaves = {}, {}
        for p, v in host:
            a, dtype = _to_numpy(v)
            arrays[_SEP.join(p)] = a
            leaves[_SEP.join(p)] = {"shape": list(v.shape), "dtype": dtype}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": leaves}, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        with open(os.path.join(final, "COMMIT"), "w") as f:
            f.write("ok\n")
        _prune(ckpt_dir, keep)

    if writer and async_:
        _SAVER.submit(write)
    elif writer:
        _SAVER.wait()
        write()
    _SAVER.sharded = sharded
    if not async_:
        _SAVER.wait()      # a sharded save: the barrier after the commit
    return final


def wait_for_saves():
    _SAVER.wait()


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(_committed(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _committed(ckpt_dir: str):
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "COMMIT")):
                out.append(int(name.split("_")[1]))
    return out


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _committed(ckpt_dir)
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step_{max(steps):08d}")


def restore_checkpoint(path: str, device=None, shardings=None):
    """→ (step, tree) with every leaf on `device` (the GPU unless the
    caller asks for the CPU). `shardings`: a tree matching the saved one
    (or part of it) of `parallel.sharding.NamedSharding`, or None leaves;
    a leaf with a sharding is re-placed onto it as a DTensor (its mesh
    may differ from the one that saved: elastic restore)."""
    from ..parallel.sharding import place
    device = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    sh_flat = dict(_flatten(shardings)) if isinstance(shardings, dict) \
        else {}
    pairs = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key in data.files:
            t = _from_numpy(data[key], manifest["leaves"][key]["dtype"])
            path_t = tuple(key.split(_SEP))
            t = t.to(device)
            sh = sh_flat.get(path_t)
            pairs.append((path_t, place(t, sh) if sh is not None else t))
    return manifest["step"], _unflatten(pairs)
