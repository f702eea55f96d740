#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device and build: the card, then every CUDA kernel built from
     `src/repro_torch/csrc/` with nvcc for sm_90a;
  2. kernels: B1 gemv_bs, B2 program_gemv and B3 gemv_f against their plain
     PyTorch versions on the card, at the shapes llama2-7b's decode gives
     them (B = 4 lanes): B1 and B2 bitwise, B2 also bitwise against per-leaf
     B1, B3 within rtol 1e-5 / atol 1e-5·max|plain|; each timed beside its
     plain version, a bf16 torch.matmul of the same product (a yardstick the
     port never calls) and its bound;
  3. slice, act_bits=4: full-width llama2-7b (random weights from a seed,
     2-bit planes) serves 4 requests of 16 prompt tokens and 16 new tokens
     through `ServeEngine(quantized=True, act_bits=4)`; the launch counts
     must show B1 and B2 ran and no plain version did, and the prefill
     logits must equal, bitwise, those of the same model on the plain
     versions;
  4. slice, act_bits=None: the same through B3;
  5. the kernels line, then the card's name and power limit, then the
     result line.
Any failed check raises, and the script exits nonzero without a result
line. It needs one CUDA device and exits nonzero without one.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

B = 4                      # decode lanes of the slice
PROMPT, NEW = 16, 16       # tokens per request
SEED = 0
HBM_BYTES_S = 3.35e12      # H100 SXM device memory rate
PEAK_OPS_S = {"int8": 1979e12, "float32": 67e12}
L2_BYTES = 50 * 2**20
B3_RTOL = 1e-5

# TPU kernels replaced (file:line of the Pallas entry point)
REPLACES = {
    "gemv_bs": "src/repro/kernels/bitplane_gemv/kernel.py:155",
    "program_gemv": "src/repro/kernels/bitplane_gemv/program.py:257",
    "gemv_f": "src/repro/kernels/bitplane_gemv/kernel.py:84",
}
SOURCES = {
    "gemv_bs": "src/repro_torch/csrc/bitplane_gemv.cu",
    "program_gemv": "src/repro_torch/csrc/program_gemv.cu",
    "gemv_f": "src/repro_torch/csrc/bitplane_gemv.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def graph_ms(calls, reps: int) -> float:
    """Device time of one call, from a CUDA graph of `reps` calls replayed
    after a warm-up; the calls cycle over inputs whose total exceeds the
    L2 cache, so each call reads its operands from device memory as the
    decode step does."""
    import torch
    for c in calls:
        c()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            calls[i % len(calls)]()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def eager_ms(call, reps: int = 3) -> float:
    import torch
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def copies_for(nbytes: int) -> int:
    """Distinct input copies to cycle so that they overflow the L2."""
    return max(1, min(16, -(-3 * L2_BYTES // max(nbytes, 1))))


def nbytes(*ts) -> int:
    return sum(nbytes(*t) if isinstance(t, (list, tuple))
               else t.numel() * t.element_size() for t in ts)


def bound(in_bytes: int, out_bytes: int, ops: float, kind: str):
    """Least time for the work: bytes moved at the memory rate vs
    operations at the peak rate of their type (ms, and which bounds)."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plane_bound_ms(planes) -> float:
    """The weight planes alone at the memory rate: the floor of a decode
    GeMV, whatever its activations and arithmetic."""
    return nbytes(planes) / HBM_BYTES_S * 1e3


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# (n, m) and calls per decode step's layer (lm_head: per step). B1 takes
# wo, down and lm_head; B3 also takes q/k/v and up/gate, which B2 takes
# per group at act_bits.
LEAF_SHAPES = {"wo": ((4096, 4096), 1), "down": ((11008, 4096), 1),
               "lm_head": ((4096, 32000), 1)}
B3_ONLY_SHAPES = {"q/k/v": ((4096, 4096), 3), "up/gate": ((4096, 11008), 2)}
GROUP_SHAPES = {"qkv": [(4096, 4096)] * 3, "up_gate": [(4096, 11008)] * 2}


def _leaf(n, m, gen, bits):
    import torch
    from repro_torch.core.bitplane import make_bitplane_weights
    from repro_torch.core.quant import QuantSpec
    w = torch.randn((n, m), generator=gen, device="cuda")
    return make_bitplane_weights(w, QuantSpec(bits=bits))


def _leaf_inputs(x, bw, act_bits):
    """The padded operands `ops.bitplane_gemv_codes`/`bitplane_gemv` hand
    to B1/B3 for activations x (B, n)."""
    import torch
    from repro_torch.core.quant import QuantSpec, quantize_activations
    from repro_torch.kernels.bitplane_gemv import ops
    bn, _ = ops._pick_blocks(bw.n, bw.m, None, None, None)
    aq = quantize_activations(x, QuantSpec(bits=act_bits))
    codes = ops._pad_axis(aq.values, bn, 1, value=aq.zero).contiguous()
    a = ops._pad_axis(x.to(torch.float32), bn, 1).contiguous()
    scale_t = ops._expand_scales(bw, bn, codes.shape[1])
    bs_kw = dict(q=bw.bits, p=act_bits, z_a=aq.zero, z_w=bw.zero, bn=bn)
    f_kw = dict(q=bw.bits, zero=bw.zero, bn=bn)
    return codes, a, scale_t, bs_kw, f_kw


def phase_kernels(weight_bits: int, act_bits: int) -> dict:
    import torch
    from repro_torch.core.quant import QuantSpec
    from repro_torch.kernels.bitplane_gemv import kernel, ops, program, ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = {"gemv_bs": [], "gemv_f": [], "program_gemv": []}

    # B1 and B3 per leaf
    for name, ((n, m), count) in {**LEAF_SHAPES, **B3_ONLY_SHAPES}.items():
        bw = _leaf(n, m, gen, weight_bits)
        x = torch.randn((B, n), generator=gen, device="cuda")
        codes, a, scale_t, bs_kw, f_kw = _leaf_inputs(x, bw, act_bits)
        k_copies = [(_leaf(n, m, gen, weight_bits) if i else bw)
                    for i in range(copies_for(nbytes(bw.planes)))]
        wlib = [torch.randn((n, m), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
                for _ in range(copies_for(n * m * 2))]
        xb = x.to(torch.bfloat16)
        lib_ms = graph_ms([lambda w=w: torch.matmul(xb, w) for w in wlib],
                          20)
        del wlib
        ops_count = 2.0 * B * n * m
        for kname, kfn, rfn, arg, kw, kind, exact in (
                ("gemv_bs", kernel.gemv_bs, ref.gemv_bs_ref, codes, bs_kw,
                 "int8", True),
                ("gemv_f", kernel.gemv_f, ref.gemv_f_ref, a, f_kw,
                 "float32", False)):
            if kname == "gemv_bs" and name not in LEAF_SHAPES:
                continue            # q/k/v and up/gate run on B2 at act_bits
            got = kfn(arg, bw.planes, scale_t, **kw)
            want = rfn(arg, bw.planes, scale_t, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if exact and not torch.equal(got, want):
                raise AssertionError(f"{kname} {name}: kernel != plain "
                                     f"(max|Δ| {err})")
            if not exact:
                tol = B3_RTOL * want.abs() + B3_RTOL * float(want.abs().max())
                if not bool(((got - want).abs() <= tol).all()):
                    raise AssertionError(f"{kname} {name}: max|Δ| {err} "
                                         f"outside rtol/atol {B3_RTOL}")
            ms = graph_ms([lambda c=c: kfn(arg, c.planes, scale_t, **kw)
                           for c in k_copies], 50)
            plain = eager_ms(lambda: rfn(arg, bw.planes, scale_t, **kw))
            # the function needs the leaf's scales once, not the per-tile
            # rows that `_expand_scales` hands the kernel
            t_bound, by = bound(nbytes(arg, bw.planes, bw.scale),
                                nbytes(got), ops_count, kind)
            rows[kname].append(dict(
                shape=name, n=n, m=m, count=count, max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=t_bound, bound_by=by,
                plane_bound_ms=plane_bound_ms(bw.planes),
                library_ms=lib_ms))
        del k_copies

    # B2: q/k/v and up/gate, one launch per group
    spec = QuantSpec(bits=act_bits)
    for gname, shapes in GROUP_SHAPES.items():
        ws = [_leaf(n, m, gen, weight_bits) for n, m in shapes]
        n = shapes[0][0]
        x = torch.randn((B, n), generator=gen, device="cuda")
        plan = program.group_plan(ws, act_bits)
        packed = program.pack_group(plan, ws, "cuda")
        codes, scales, layout = program._quantize_batched(
            (x,) * len(ws), (spec,) * len(ws))
        codes_t = program.pack_codes(
            plan, [codes[bi][s:s + b] for bi, s, b in layout])
        planes_t = packed[0]
        kw = dict(q_max=plan.q_max, p_max=plan.p_max, bn=plan.bn_max)
        got = program.program_gemv(plan, codes_t, *packed)
        want = ref.program_gemv_ref(codes_t, *packed, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"program_gemv {gname}: kernel != plain "
                                 f"(max|Δ| {err})")
        fused = program.fused_group_linears(x, ws, act_bits, packed=packed)
        per_leaf = [ops.bitplane_gemv_bitserial(x, w, spec) for w in ws]
        for f, p in zip(fused, per_leaf):
            if not torch.equal(f, p):
                raise AssertionError(f"program_gemv {gname}: fused != "
                                     f"per-leaf gemv_bs")
        k_copies = [packed] + [
            program.pack_group(plan, [_leaf(n_, m_, gen, weight_bits)
                                      for n_, m_ in shapes], "cuda")
            for _ in range(copies_for(nbytes(planes_t)) - 1)]
        ms = graph_ms([lambda p=p: program.program_gemv(plan, codes_t, *p)
                       for p in k_copies], 50)
        del k_copies
        plain = eager_ms(lambda: ref.program_gemv_ref(codes_t, *packed,
                                                      **kw))
        m_all = sum(m for _, m in shapes)
        wlib = [torch.randn((n, m_all), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
                for _ in range(copies_for(n * m_all * 2))]
        xb = x.to(torch.bfloat16)
        lib_ms = graph_ms([lambda w=w: torch.matmul(xb, w) for w in wlib],
                          20)
        del wlib
        # the group's u8 codes once (the slots share them), and each
        # leaf's planes and scales
        t_bound, by = bound(
            B * n + nbytes([w.planes for w in ws], [w.scale for w in ws]),
            nbytes(fused), 2.0 * B * n * m_all, "int8")
        rows["program_gemv"].append(dict(
            shape=gname, n=n, m=m_all, count=1, max_abs_err=err, ms=ms,
            plain_ms=plain, bound_ms=t_bound, bound_by=by,
            plane_bound_ms=plane_bound_ms([w.planes for w in ws]),
            library_ms=lib_ms))
    for kname, rs in rows.items():
        for r in rs:
            emit({"phase": "kernel_check", "kernel": kname, **r})
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the slice, full-width llama2-7b
# ---------------------------------------------------------------------------

def counts() -> dict:
    from repro_torch.kernels.bitplane_gemv import kernel, program, ref
    return {"launches": {**kernel.LAUNCHES, **program.LAUNCHES},
            "plain": dict(ref.CALLS)}


def reset_counts() -> None:
    from repro_torch.kernels.bitplane_gemv import kernel, program, ref
    for d in (kernel.LAUNCHES, program.LAUNCHES, ref.CALLS):
        for k in d:
            d[k] = 0


def resident_gb(eng) -> dict:
    """Device memory the engine holds after warm-up: its weight leaves'
    bit planes (with scales and column sums), the slot-major copies of the
    fused q/k/v and up/gate groups that B2 reads, and all that the
    allocator holds (embedding and KV cache included)."""
    import torch
    from repro_torch.core.bitplane import BitplaneWeights

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [tree] if isinstance(tree, BitplaneWeights) else []
    planes = sum(nbytes(w.planes, w.scale, w.col_sum)
                 for w in leaves(eng.params))
    packed = sum(nbytes(p) for _, p in eng.mvdram._packed.values())
    return {"leaf_planes_gb": planes / 1e9, "packed_groups_gb": packed / 1e9,
            "allocated_gb": torch.cuda.memory_allocated() / 1e9}


def phase_slice(cfg, qparams, prompts, act_bits, must_run) -> dict:
    """Serve the requests through the kernel backend, with the counts
    zeroed just before and read just after; then hold the prefill logits
    against the same model on the plain versions."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, qparams, max_seq=PROMPT + NEW + 1,
                      batch_slots=B, quantized=True, act_bits=act_bits,
                      device="cuda")
    eng.generate(prompts[:, :4], max_new=2)      # pack B2 groups, warm up
    torch.cuda.synchronize()
    resident = resident_gb(eng)
    reset_counts()
    t0 = time.perf_counter()
    toks = eng.generate(prompts, max_new=NEW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    seen = counts()
    for k in must_run:
        if seen["launches"][k] <= 0:
            raise AssertionError(f"act_bits={act_bits}: {k} never launched "
                                 f"on the slice ({seen})")
    if any(seen["plain"].values()):
        raise AssertionError(f"act_bits={act_bits}: a plain version ran on "
                             f"the card ({seen})")
    if tuple(toks.shape) != (B, PROMPT + NEW) or \
            not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"bad tokens {tuple(toks.shape)}")
    if not torch.equal(toks[:, :PROMPT], prompts):
        raise AssertionError("prompt tokens not echoed")

    with torch.no_grad():
        got, _ = eng.model.prefill(eng.params, {"tokens": prompts},
                                   eng.max_seq)
        ref_eng = ServeEngine(cfg, qparams, max_seq=PROMPT + NEW + 1,
                              batch_slots=B, quantized=True,
                              act_bits=act_bits, impl="reference",
                              device="cuda")
        want, _ = ref_eng.model.prefill(ref_eng.params,
                                        {"tokens": prompts}, eng.max_seq)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite logits")
    err = float((got - want).abs().max())
    if act_bits and not torch.equal(got, want):
        raise AssertionError(f"act_bits={act_bits}: kernel logits != plain "
                             f"logits (max|Δ| {err})")
    # B3 sums in another order than its plain version, and bf16
    # activations between the 32 layers amplify that, so the float path is
    # held to agreement of the logits at bf16 resolution (a wrong kernel
    # misses by the logits' own size)
    if not act_bits:
        scale = float(want.abs().max())
        if err > 0.05 * scale:
            raise AssertionError(f"act_bits=None: logits differ from the "
                                 f"plain versions' (max|Δ| {err}, "
                                 f"max|logit| {scale})")
    out = {"phase": f"slice_act_bits_{act_bits}", "tokens_shape":
           list(toks.shape), "seconds": dt,
           "tokens_per_s": B * NEW / dt, **seen, "resident": resident,
           "prefill_logits_max_abs_err_vs_plain": err}
    emit(out)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repo)
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import param_defs
    from repro_torch.models.params import init_params
    from repro_torch.serve.quantize import quantize_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    build.build_all(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(build.SIGNATURES)})

    cfg = get_config("llama2-7b")
    rows = phase_kernels(cfg.weight_bits, act_bits=4)

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(param_defs(cfg), gen, "cuda")
    qparams = quantize_params(params, cfg.weight_bits)
    del params
    torch.cuda.synchronize()
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                            device="cuda")
    emit({"phase": "model", "config": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "weight_bits": cfg.weight_bits,
          "dtype": cfg.dtype, "depth_cut": None,
          "setup_seconds": time.perf_counter() - t0,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    s4 = phase_slice(cfg, qparams, prompts, 4, ("gemv_bs", "program_gemv"))
    sf = phase_slice(cfg, qparams, prompts, None, ("gemv_f",))

    launches = {**s4["launches"]}
    launches["gemv_f"] = sf["launches"]["gemv_f"]
    # per kernel, its shapes summed as one decode layer (plus lm_head) calls
    # them; `kernel_ms`/`max_abs_diff` repeat `ms`/`max_abs_err` under the
    # names PERF.md's kernel table uses, and `plane_bound_ms` is the planes
    # alone at the memory rate
    kernels = []
    for kname, rs in rows.items():
        row = {
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            **{key: sum(r[key] * r["count"] for r in rs)
               for key in ("ms", "plain_ms", "bound_ms", "plane_bound_ms",
                           "library_ms")},
            "bound_by": max(("bytes", "operations"), key=lambda by: sum(
                r["bound_ms"] * r["count"] for r in rs
                if r["bound_by"] == by)),
            "shapes": {r["shape"]: r["count"] for r in rs}}
        row["kernel_ms"], row["max_abs_diff"] = row["ms"], row["max_abs_err"]
        kernels.append(row)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
