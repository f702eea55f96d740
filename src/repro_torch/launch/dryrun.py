"""Dry-run of the port (port of the JAX package's `launch/dryrun.py`): the
roofline terms of every (arch × shape) cell on the production meshes,
priced on H100 constants (`core.pud.timing.H100_SXM`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama2-7b \\
        --shape decode_32k [--mesh multi] [--quant-bits 2] [--out f.json]

Each record is THE PORT'S ESTIMATE, not XLA's: the cell's step is built
on the meta device (shapes only; nothing is allocated, no kernel runs) and
counted as it runs:

  flops             `torch.utils.flop_counter.FlopCounterMode` over one
                    device's share of the step: matmul-class ops only
                    (mm, bmm, addmm, baddbmm, convolutions, attention);
                    also split by the operands' dtype (`flops_by_dtype`)
  write_bytes       Σ result bytes of every op that materializes one (a
                    `TorchDispatchMode`; views excluded), plus the train
                    step's gathered parameters and reduced gradient
                    shards; `hbm_bytes = arg_bytes + 2·write_bytes`, the
                    JAX dry-run's roofline input
  arg_bytes         one device's shards of the step's inputs under their
                    logical specs: params (and AdamW moments), the batch
                    or the decode cache
  collective_bytes  the bytes one device receives in the collectives the
                    port's sharded train step issues on that mesh (ring
                    model: an all-gather of each sharded parameter, the
                    gradient mean as a reduce-scatter or an all-reduce of
                    the cut piece), known exactly from the specs; None for
                    prefill and decode, which have no multi-device path in
                    the port, so their bottleneck is compute or memory
  roofline          the JAX package's formulas (`roofline`,
                    `model_flops_for`) on H100 constants

One device's share is the port's: each rank runs the whole model on its
rows of the batch (the batch axes "pod" and "data" split the work; ranks
that differ only on "model" repeat it), so `flops` is counted at the
per-device batch and `useful_flops_ratio` shows that repetition. Train
builds forward, backward and the AdamW update (on the shards); prefill
`Model.prefill`; decode `make_serve_step`. Quantized serving cells
(`--quant-bits`) run the plain versions of the bit-plane GeMVs, since no
kernel launches on meta: `flops` then counts those plain versions' float
products (one per bit plane), not the kernels' integer work.

What has no twin: `launch/hlo_analysis.py` parses the post-optimization
HLO text that XLA compiles; the port compiles no HLO (eager PyTorch and
hand-written CUDA), so its counts come from the dispatcher instead, and
there is no while-loop trip count to recover (the port's loops run in
Python, each iteration dispatched and counted).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from ..configs import SHAPES, ShapeProfile, cells, get_config
from ..core.bitplane import BitplaneWeights
from ..core.pud.timing import H100_SXM
from ..models import attention as attn_mod
from ..models.model import Model, param_defs
from ..models.params import count_params, param_bytes, tree_map
from ..optim.adamw import AdamWConfig, adamw_update, tree_leaves
from ..parallel.compress import compress_tree_for_sync
from ..parallel.sharding import (DEFAULT_RULES, LONG_CONTEXT_RULES,
                                 NamedSharding, batch_axes,
                                 logical_to_pspec)
from ..serve.engine import cache_pspecs, make_serve_step
from ..serve.quantize import quantize_defs
from ..train.step import accumulate_grads
from .mesh import Mesh, make_production_mesh

ESTIMATE = ("the port's estimate: torch FlopCounterMode and dispatch-mode "
            "byte counts on the meta device, priced on H100 constants; "
            "not XLA's cost analysis")
#: the H100 SXM's float32 rate off the tensor cores (FLOP/s), for
#: `compute_s_by_dtype` only: the roofline keeps the JAX package's one
#: bf16 peak for every FLOP
F32_FLOPS = 67e12
#: ops that create or alias storage without writing it
_NO_WRITE = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh"}


class _Counter(TorchDispatchMode):
    """Result bytes of every materializing op, and the matmul-class FLOPs
    by the first operand's dtype."""

    def __init__(self):
        super().__init__()
        self.write_bytes = 0
        self.flops_by_dtype: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            dt = str(next(a for a in _pytree_leaves(args)
                          if isinstance(a, torch.Tensor)).dtype)
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0) + n
        if not func.is_view and packet.__name__ not in _NO_WRITE:
            self.write_bytes += sum(
                t.numel() * t.element_size() for t in _pytree_leaves(out)
                if isinstance(t, torch.Tensor))
        return out


@contextlib.contextmanager
def _counted():
    """→ a dict filled on exit with `flops` (FlopCounterMode's total),
    `flops_by_dtype` and `write_bytes` of everything run inside."""
    res: dict = {}
    fc, wc = FlopCounterMode(display=False), _Counter()
    with fc, wc:
        yield res
    res.update(flops=float(fc.get_total_flops()),
               flops_by_dtype={k: float(v) for k, v in
                               sorted(wc.flops_by_dtype.items())},
               write_bytes=float(wc.write_bytes))


def _summed(counts) -> dict:
    """The `_counted` dicts of a step's parts added up."""
    out = {"flops": 0.0, "flops_by_dtype": {}, "write_bytes": 0.0}
    for c in counts:
        out["flops"] += c["flops"]
        out["write_bytes"] += c["write_bytes"]
        for dt, n in c["flops_by_dtype"].items():
            out["flops_by_dtype"][dt] = out["flops_by_dtype"].get(dt, 0) + n
    return out


@contextlib.contextmanager
def _flash(bf16: bool, block: Optional[int]):
    """The blocked attention's knobs set for one cell, then restored."""
    prev = attn_mod.FLASH_P_BF16, attn_mod.FLASH_BLOCK
    attn_mod.FLASH_P_BF16 = bf16 or prev[0]
    attn_mod.FLASH_BLOCK = block or prev[1]
    try:
        yield
    finally:
        attn_mod.FLASH_P_BF16, attn_mod.FLASH_BLOCK = prev


def roofline(flops: float, bytes_hbm: float, coll_bytes: Optional[float],
             model_flops: float, chips: int, hw=H100_SXM) -> dict:
    """All inputs PER-DEVICE but model_flops (global). `coll_bytes` None:
    no collective term (the bottleneck is compute or memory)."""
    t_c = flops / hw.peak_flops_bf16
    t_m = bytes_hbm / hw.hbm_bw
    t_x = None if coll_bytes is None else coll_bytes / hw.nvlink_bw
    terms = [(t_c, "compute"), (t_m, "memory")]
    if t_x is not None:
        terms.append((t_x, "collective"))
    dom = max(terms)
    useful = model_flops / max(flops * chips, 1.0)
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "bottleneck": dom[1], "bound_s": dom[0],
            "model_flops_global": model_flops,
            "useful_flops_ratio": useful,
            "roofline_fraction": (model_flops / chips / hw.peak_flops_bf16)
            / max(dom[0], 1e-30)}


def model_flops_for(cfg, profile, n_active: int) -> float:
    """6·N_active·D for training; 2·N_active·D per generated/processed
    token at inference."""
    tokens = profile.global_batch * profile.seq_len
    if profile.kind == "train":
        return 6.0 * n_active * tokens
    if profile.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * profile.global_batch  # decode: one token/lane


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _nbytes(shape, dtype) -> int:
    n = 1
    for s in shape:
        n *= s
    return n * dtype.itemsize


def _shard_bytes(t: torch.Tensor, axes, mesh, rules) -> int:
    """Bytes of one device's shard of `t` under the logical `axes`."""
    if mesh is None:
        return _nbytes(t.shape, t.dtype)
    sh = NamedSharding(mesh, logical_to_pspec(axes, t.shape, mesh, rules))
    return _nbytes(sh.shard_shape(t.shape), t.dtype)


def train_collective_bytes(defs, mesh, rules, wire_bytes: int,
                           batch: tuple) -> dict:
    """The bytes one device receives in the sharded train step's
    collectives (ring model): each parameter sharded over n_s devices
    all-gathered, (n_s−1)/n_s of it in float32; each gradient (in
    `wire_bytes` an element) reduced over the `batch` axes — reduce-
    scattered, (n−1)/n of it, over the batch axes that shard the
    parameter, and its piece all-reduced, 2(n−1)/n, over the others."""
    sizes = mesh.shape
    gather = reduce = 0.0
    for d in tree_leaves(defs):
        spec = logical_to_pspec(d.axes, d.shape, mesh, rules)
        named = {ax for part in spec for ax in
                 ((part,) if isinstance(part, str) else part or ())}
        n_s = 1
        for ax in named:
            n_s *= sizes[ax]
        gather += d.size * torch.float32.itemsize * (n_s - 1) / n_s
        g = float(d.size * wire_bytes)
        n_rs = n_ar = 1
        for ax in batch:
            if ax in named:
                n_rs *= sizes[ax]
            else:
                n_ar *= sizes[ax]
        reduce += g * (n_rs - 1) / n_rs + 2 * (g / n_s) * (n_ar - 1) / n_ar
    return {"param_all_gather": gather, "grad_reduce": reduce,
            "total": gather + reduce}


def _serving_params(defs, quant_bits: Optional[int]):
    """bf16 serving weights (float32 leaves of ≥ 2 dims), or the
    bit-plane tree (`quantize_defs`)."""
    if quant_bits:
        return quantize_defs(defs, quant_bits)
    return tree_map(lambda d: _meta(
        d.shape, torch.bfloat16 if d.dtype == "float32" and len(d.shape) >= 2
        else getattr(torch, d.dtype)), defs)


def _leaf_arrays(tree):
    """Every tensor of a parameter tree, bit-plane leaves opened."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, BitplaneWeights):
            yield from (leaf.planes, leaf.scale, leaf.col_sum)
        else:
            yield leaf


def estimate(cfg, profile: ShapeProfile, mesh: Optional[Mesh] = None,
             rules: Optional[dict] = None, microbatches: int = 1,
             remat: bool = False, kv_bits: Optional[int] = None,
             quant_bits: Optional[int] = None) -> dict:
    """One cell's counts and roofline: `cfg` under `profile` on `mesh`
    (None: one device), `rules` overriding the default table. The train
    step compresses its gradients to bf16 (the trainer's default)."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    chips = 1 if mesh is None else int(mesh.devices.size)
    batch_split = () if mesh is None else batch_axes(
        mesh, profile.global_batch, rules)
    split = 1
    for ax in batch_split:
        split *= mesh.shape[ax]
    rows = profile.global_batch // split
    model = Model(cfg, remat=remat, kv_bits=kv_bits)
    defs = param_defs(cfg)
    s = profile.seq_len
    emb = cfg.d_model if cfg.input_mode == "embeddings" else 0
    rec = {"flops_split": split, "local_batch": rows}
    t0 = time.perf_counter()
    if profile.kind == "train":
        wire = torch.bfloat16
        batch = {"tokens": _meta((rows, s), torch.int32),
                 "labels": _meta((rows, s), torch.int32)}
        if emb:
            batch["embeddings"] = _meta((rows, s, emb), torch.bfloat16)
        full = tree_map(lambda d: _meta(d.shape, getattr(torch, d.dtype)),
                        defs)
        shard = tree_map(lambda d: _meta(
            d.shape if mesh is None else NamedSharding(
                mesh, logical_to_pspec(d.axes, d.shape, mesh, rules)
            ).shard_shape(d.shape), getattr(torch, d.dtype)), defs)
        state = {"m": tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32), shard),
            "v": tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), shard),
            "count": torch.zeros((), dtype=torch.int32, device="meta")}
        with _counted() as c_grads:
            grads, _ = accumulate_grads(model, full, batch, microbatches,
                                        remat=remat)
        with _counted() as c_compress:
            grads = compress_tree_for_sync(grads)
        del grads
        g_shard = tree_map(lambda p: _meta(p.shape, wire), shard)
        with _counted() as c_adamw:
            adamw_update(g_shard, state, shard, AdamWConfig())
        gathered = reduced = 0
        if mesh is not None:
            for d, p in zip(tree_leaves(defs), tree_leaves(shard)):
                if tuple(p.shape) != tuple(d.shape):
                    gathered += _nbytes(d.shape, p.dtype)
                reduced += _nbytes(p.shape, wire)
        parts = {"grads": c_grads, "compress": c_compress,
                 "adamw": c_adamw}
        counts = _summed(parts.values())
        counts["write_bytes"] += gathered + reduced
        rec["write_bytes_by_part"] = {
            **{k: c["write_bytes"] for k, c in parts.items()},
            "gathers_and_reduce": float(gathered + reduced)}
        arg = sum(_nbytes(p.shape, p.dtype) + 2 * _nbytes(
            p.shape, torch.float32) for p in tree_leaves(shard)) + 4
        arg += sum(_nbytes(x.shape, x.dtype) for x in batch.values())
        if mesh is None or chips == 1:
            coll, note = 0.0, "one device: no collective"
        else:
            c = train_collective_bytes(defs, mesh, rules, wire.itemsize,
                                       batch_split)
            coll, note = c["total"], c
    else:
        params = _serving_params(defs, quant_bits)
        last_mlp = lambda t: (None,) * (t.ndim - 1) + ("mlp",)
        if quant_bits:
            # the JAX dry-run's spec for the packed tree: every array's
            # last dim (outputs) on "mlp"
            arg = sum(_shard_bytes(t, last_mlp(t), mesh, rules)
                      for t in _leaf_arrays(params))
        else:
            arg = sum(_shard_bytes(t, d.axes, mesh, rules) for t, d in
                      zip(tree_leaves(params), tree_leaves(defs)))
        coll = None
        note = "no multi-device serving path in the port"
        if profile.kind == "prefill":
            key = "embeddings" if emb else "tokens"
            x = (_meta((rows, s, emb), torch.bfloat16) if emb
                 else _meta((rows, s), torch.int32))
            arg += _nbytes(x.shape, x.dtype)
            with torch.no_grad(), _counted() as counts:
                model.prefill(params, {key: x}, max_seq=s)
        else:
            glob = model.init_cache(profile.global_batch, s, device="meta")
            if mesh is None:
                arg += sum(_nbytes(t.shape, t.dtype)
                           for t in tree_leaves(glob))
            else:
                for t, spec in _paired(glob, cache_pspecs(glob, mesh,
                                                          rules)):
                    arg += _nbytes(NamedSharding(mesh, spec).shard_shape(
                        t.shape), t.dtype)
            del glob
            cache = model.init_cache(rows, s, device="meta")
            inp = (_meta((rows, emb), torch.bfloat16) if emb
                   else _meta((rows,), torch.int32))
            arg += _nbytes(inp.shape, inp.dtype) + 4
            step = make_serve_step(model)
            with torch.no_grad(), _counted() as counts:
                step(params, cache, inp, s - 1)
    rec.update(counts)
    rec["build_s"] = time.perf_counter() - t0
    rec["arg_bytes"] = float(arg)
    rec["hbm_bytes"] = rec["arg_bytes"] + 2 * rec["write_bytes"]
    rec["collective_bytes"] = coll
    rec["collective_note"] = note
    rec["compute_s_by_dtype"] = {
        dt: n / (H100_SXM.peak_flops_bf16 if dt == "torch.bfloat16"
                 else F32_FLOPS) for dt, n in rec["flops_by_dtype"].items()}
    mf = model_flops_for(cfg, profile, cfg.active_param_count())
    rec["roofline"] = roofline(rec["flops"], rec["hbm_bytes"], coll, mf,
                               chips)
    return rec


def _paired(tree, specs):
    """(leaf, spec) of a tree and its matching spec tree."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _paired(tree[k], specs[k])
    else:
        yield tree, specs


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             microbatches: int = 1, remat: bool = False,
             extra_rules: Optional[dict] = None,
             kv_bits: Optional[int] = None,
             quant_bits: Optional[int] = None, flash_bf16: bool = False,
             flash_block: Optional[int] = None,
             ssd_chunk: Optional[int] = None, cfg=None) -> dict:
    """One (arch × shape) cell on the production mesh → its record.
    `cfg` replaces the arch's published config (tests: a tiny one)."""
    cfg = cfg or get_config(arch)
    if ssd_chunk and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=ssd_chunk))
    profile = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)
    if shape == "long_500k":
        rules = dict(LONG_CONTEXT_RULES)
    elif profile.kind in ("decode", "prefill"):
        rules = {"kv_seq": "model"}   # sequence-sharded KV (flash-decoding)
    else:
        rules = {}
    rules.update(extra_rules or {})
    defs = param_defs(cfg)
    rec = {"estimate": ESTIMATE, "hardware": dataclasses.asdict(H100_SXM),
           "arch": arch, "config": cfg.name, "shape": shape,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "chips": int(mesh.devices.size), "params": count_params(defs),
           "active_params": cfg.active_param_count(),
           "param_bytes_f32": param_bytes(defs), "kind": profile.kind,
           "microbatches": microbatches, "remat": remat,
           "kv_bits": kv_bits, "quant_bits": quant_bits,
           "flash_bf16": flash_bf16, "flash_block": flash_block,
           "rules": {k: str(v) for k, v in rules.items()}}
    if quant_bits and profile.kind != "train":
        rec["flops_note"] = ("matmul-class ops of the plain bit-plane "
                             "GeMVs (a float product a plane), not the "
                             "kernels' integer work")
    with _flash(flash_bf16, flash_block):
        rec.update(estimate(cfg, profile, mesh, rules, microbatches, remat,
                            kv_bits, quant_bits if profile.kind != "train"
                            else None))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--rules", default=None,
                    help='JSON logical-rule overrides, e.g. {"kv_seq":"data"}')
    ap.add_argument("--kv-bits", type=int, default=None)
    ap.add_argument("--quant-bits", type=int, default=None)
    ap.add_argument("--flash-bf16", action="store_true")
    ap.add_argument("--flash-block", type=int, default=None)
    ap.add_argument("--ssd-chunk", type=int, default=None)
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        live, skipped = cells()
        for a, s in live:
            print(f"RUN  {a} {s}")
        for a, s in skipped:
            print(f"SKIP {a} {s} (long_500k needs sub-quadratic attention)")
        return

    extra = json.loads(args.rules) if args.rules else None
    rec = run_cell(args.arch, args.shape, args.mesh == "multi",
                   args.microbatches, args.remat, extra,
                   kv_bits=args.kv_bits, quant_bits=args.quant_bits,
                   flash_bf16=args.flash_bf16, flash_block=args.flash_block,
                   ssd_chunk=args.ssd_chunk)
    js = json.dumps(rec, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(js)
    print(js)
    print(f"\nOK {args.arch} × {args.shape} × {rec['mesh']}: "
          f"args/dev = {rec['arg_bytes'] / 2**30:.2f} GiB, "
          f"bottleneck = {rec['roofline']['bottleneck']} (the port's "
          f"estimate)")


if __name__ == "__main__":
    main()
