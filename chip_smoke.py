#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device and build: the card, then every CUDA kernel built from
     `src/repro_torch/csrc/` with nvcc for sm_90a;
  2. kernels: B1 gemv_bs, B2 program_gemv (through the member table that
     reads each leaf in place) and B3 gemv_f against their plain
     PyTorch versions on the card, at the shapes llama2-7b's decode gives
     them (B = 4 lanes; B1 and B3 at all four of 4096→4096, 4096→11008,
     11008→4096 and 4096→32000, with their split plan; B1 and B3 also at
     the 64-row prefill of up/gate and lm_head, where the plan has one
     split and the block folds its own tiles, each also timed through a
     workspace and the fold launch that several splits take): B1 and B2
     bitwise, B2 also bitwise against per-leaf B1, B3 within rtol 1e-5 /
     atol 1e-5·max|plain|; B1 and B3 also at q4 at mamba2-1.3b's and
     zamba2-7b's in_proj and out_proj (B = 4); each timed beside its plain
     version, a bf16 torch.matmul of the same product (a yardstick the
     port never calls) and its bound;
  3. slice, act_bits=4: full-width llama2-7b (random weights from a seed,
     2-bit planes) serves 4 requests of 16 prompt tokens and 16 new tokens
     through `ServeEngine(quantized=True, act_bits=4)`; the launch counts
     must show B1 and B2 (and their folds) ran and no plain version did,
     the engine must hold no copy of the groups' weights (B2's member
     tables above 0.01 GB), and the prefill logits must equal, bitwise,
     those of the same model on the plain versions;
  4. slice, act_bits=None: the same through B3 (and its fold); each
     slice's `ServeEngine` tries the residency session on one DIMM, which
     llama2-7b outgrows (37 of its 225 leaves), and falls back with a
     warning (`placement_fallback`, `construct_seconds`);
  4a. the DRAM residency session on phase 3's tree: `ServeEngine(
     quantized=True, act_bits=4)` on 8 DIMMs (all 225 leaves resident,
     no fallback) and on 4 DIMMs with the spill tier (resident + spilled
     = 225, the spill ledger), each with its stats and its DDR4-model
     price of a decode step and of a tick at occupancy 1 to 4 (the
     model's seconds and Joules, not the card's); then B2 over a whole
     decode block: every part of the 8-DIMM program through `run_kernel`
     on seeded (4, N) activations, the counts zeroed just before and read
     just after each (one B2 launch, its fold when split, nothing else,
     no plain version; a table of more than 8 members in device memory),
     every output bitwise per-leaf B1's, lanes masked to exactly 0, B2
     bitwise its plain version; each part timed beside the same leaves'
     B1 launches, its plain version and its planes at the memory rate;
  5. kernels: B4 decode_attention (split over the cache by its plan, a
     fold launch merging the splits) against its plain version at
     llama2-7b's full context (B = 4 lanes, 4096 stamped slots, 32 heads of
     128) with a bf16 and an int8 cache, at the slice's own call (16–31
     valid slots of 4096), at B = 1, at qwen2-7b's and starcoder2-3b's GQA
     (7 and 12 query heads a KV head) with 4096 slots, on small GQA,
     windowed ring-buffer and no-valid-slot shapes, and at head dims 16 and
     112 (between the kernel's built sizes) and 320 (its generic body) on
     caches of 4096 slots, and at pixtral-12b's own call (GQA 32 over 8,
     int8, 16–31 valid slots) and zamba2-7b's (32 heads of 112, int8,
     16–31 valid slots) (rtol/atol 1e-5 for a float32 output, one bf16
     ulp plus 1e-5·max for a bf16 one); B5 quant_matmul at llama2-7b's
     decode shapes, q2, and one grouped shape, with B3's split plan (rtol
     1e-5, atol 1e-5·max|plain|); each timed beside its plain version, its
     bound and
     a PyTorch yardstick the port never calls (scaled_dot_product_attention
     on the bf16 cache; a bf16 torch.matmul);
  6. slice, act_bits=4, int8 KV cache over 4096 slots, attention through
     B4: `Model(attn_impl="kernel")` on the quantized parameters behind
     `EngineLinear(MVDRAMEngine())` serves the same requests; B4 must run
     32 times a decode step (each with its fold launch, the plan splitting
     the 4096 slots), B1 and B2 as often as `launches_per_pass` says (and
     their folds), no plain version, no copy of the groups' weights.
     A replay holds B4 against its plain version at every
     layer of every step on the path's own inputs; each decode step's
     logits are compared with the same model on `attn_impl="sdpa"` fed the
     same tokens: reported at act_bits=4 (chaotic there, see PERF.md), held
     to 5 % of max|logit| with float activations;
  7. profile: `repro_torch.launch.profile_decode.profile` serves the
     act_bits=None (B3) and act_bits=4 slices once more (8 new tokens)
     under torch.profiler, one line with both runs' device busy share and
     top kernels;
  7a. continuous batching, act_bits=4: `serve.ContinuousBatcher` on
     `ServeEngine(quantized=True)` serves 8 requests (prompts of 5 to 32
     tokens from seed 0, 4 to 16 new tokens each) over the 4 lanes,
     prompts streamed in chunks of 8 through the decode path, all
     submitted at once so lanes recycle: with a bf16 cache and `sdpa`
     attention, then with an int8 cache of 4096 slots and the engine's
     model swapped for one with `attn_impl="kernel"` (B4, lanes at
     positions up to 32 apart). Counts zeroed just before `run()`: B1
     and B2 (and B4) exactly `launches_per_pass` times each decode step,
     their folds ran, no plain version. Every request done with its
     max_new tokens; the shortest, the longest and the first request
     admitted into a recycled lane each equal to serving it alone in a
     fresh batcher of 4 lanes; in one tick every frozen lane's rows of
     every cache leaf held bitwise across each step it sits frozen in
     (and every B4 call of the tick held against its plain version), and
     a free lane holding its last request's state held bitwise across a
     whole tick. Reports ticks, program ticks, occupancy, tokens/s, wall
     per tick, the host's waits on the device a tick (sync debug mode),
     peak and allocated memory, and the wall of one decode step taken in
     turns as `Model.decode_step` alone, as the batcher's step with no
     lane frozen and with every lane frozen (the undo log at its
     largest), beside the card's name and power limit; the bf16 run's
     engine serves from 8 DIMMs, and its priced DDR4 clock
     (`sim_time_s`) must equal its program ticks priced one by one, in
     the order they ran;
  7b. the functional PUD simulator (`sim_llama2_7b`): part 0 of phase
     4a's 8-DIMM decode program (its 28 or 29 leaves, about four decode
     layers) staged in simulated DDR4 on the card and run through
     `GemvProgram.run` (the fused wave-major executor) on seeded (4, N)
     activations: staged state on cuda; each leaf's integer partials
     bitwise an exact float64 product of its codes; outputs within
     rtol 1e-4 / atol 1e-4·max|B2| of `run_kernel` (B2); the layer-major
     oracle bitwise (outputs and per-(lane, tile) counts); the bf16
     batcher's 1-lane and 3-lane tick masks (active rows bitwise, masked
     rows 0, masked lanes billing 0 ops); the executed DDR4 price's bank
     term equal to `simulated_wave_time` and its `e_total` to the
     ledger's energy, beside the analytic price at the run's bit
     density; one 4096→4096 leaf under transient faults with retries
     (coverage 1.0, outputs bitwise the fault-free run's, retries in the
     price). Reports tiles, staging and run seconds, host waits per run
     and the staged GB;
  8. slice, the baseline: every linear a q2 `QuantizedTensor` (float
     activations) through B5, 225 calls a step (and their folds) and no
     plain version;
     its prefill logits within 5 % of max|logit| of the plain versions';
  8a. training (`train_llama2_7b`): llama2-7b at full width cut to 8 of
     its 32 layers (1.881 G params; all 32 layers' float32 params,
     gradients and AdamW moments, about 108 GB, outgrow the card) trains
     8 steps through `Trainer.run` on the port's data stream: batch 8 ×
     512 in 2 strided microbatches, bf16 compute, bf16-compressed
     gradients, AdamW; under `torch.use_deterministic_algorithms` (scoped
     to 8a and 8b). Holds every loss finite and the last below the
     first, 3 steps replayed from the seed bitwise, one step with
     layer-level remat bitwise the step without, the k=2 gradients
     within 2e-2 (relative L2 a leaf) of k=1; reports losses, grad norms,
     seconds per step (median of steps 2–8), tokens/s, peak and resident
     GB, the step's bound (bf16 products, float32 attention, AdamW's
     bytes) and the share of it reached, one step's parts;
  8b. recovery (`train_recovery_llama2_7b`): one layer at full width, a
     `SimulatedFailure` in a run with async checkpoints every 2 steps
     (in a temporary directory, removed after): params and AdamW state
     bitwise the uninterrupted run's; GB written, seconds to snapshot,
     write and restore;
  8c. train-then-serve (`train_to_serve_llama2_7b`): 8a's trained
     params quantized to q2 and served through `ServeEngine(quantized=
     True, act_bits=4)` (4 lanes, 16-token prompts from the data stream,
     8 greedy tokens): B1 and B2 launch counts exact, no plain version,
     every B1/B2 call of a replay bitwise its plain version, prefill
     logits bitwise;
  8d. column shards (`column_shards_llama2_7b`): `down` and `lm_head` at
     full width, q2/p4, registered column-sharded over 8 DIMMs
     (`register_sharded`) and run by the simulator on the card
     (`gemv_sharded`, B = 4): outputs and per-tile counts bitwise the
     unsharded `run_resident`, a lane-masked and a 1-D call;
  8e. the sharded trainer (`train_sharded_llama2_7b`): an nccl process
     group of world size 1 in this process and a (1, 1) mesh over the
     card; llama2-7b at full width, 2 layers, 3 steps of 8a's batch:
     losses, params and AdamW moments bitwise the plain `Trainer`'s, its
     async checkpoint restored into a plain `Trainer` bitwise,
     `compressed_allreduce_mean` on nccl bitwise its plain recomputation;
     seconds per step of both;
  8f. the dry-run (`dryrun_llama2_7b`, on the host's meta device):
     `launch/dryrun.py:run_cell` for llama2-7b × train_4k and decode_32k
     on the (16, 16) production mesh, their rooflines on H100 constants
     (the port's estimate); the same counting on 8a's training config,
     its bound beside 8a's measured step and the hand-reckoned bound; the
     card's memory against the constants' capacity;
  9. kernels: B3 over a stack of experts (`gemv_f_experts`, one launch
     per stack) at qwen2-moe-a2.7b's shapes (64 experts of 2048→1408 and
     1408→2048, q4, 8 capacity rows), with every expert full and with the
     row counts of a decode step's routing (16 (token, expert) pairs of 4
     lanes; at deepseek-v2-lite-16b's top-6, 24), a ragged M, one expert,
     an empty expert beside a full one:
     each shape on f32 activations padded for B3's block body and on the
     same values in bf16, unpadded, on the tensor cores (the MoE path's
     kernel, its grid over `live` expert slots: 16 and 24 at the routed
     shapes);
     rtol 1e-5 / atol 1e-5·max|plain| against the plain version; timed
     beside the plain version, its bound (full capacity, and what the
     routed experts need; the bf16 kernel's operations at the bf16
     tensor-core rate, its products being exact) and a torch.bmm of a
     bf16 stack of the same shape;
 10. slice, qwen2-moe-a2.7b at full width (24 layers, 64 experts, q4;
     random weights from a seed, drawn and quantized one leaf at a time
     after llama2-7b's weights are freed), act_bits=None: the same 4
     requests through B3, the bf16 expert stacks through the tensor-core
     stacked launch (72 a forward pass, no f32 or per-expert launch);
     prefill logits on the kernel run's expert choices within 5 % of
     max|logit| of the same model on the plain versions, and the count of
     (token, layer) top-k expert sets that differ between the two runs;
     every stacked call of a replay held against its plain version;
 11. slice, qwen2-moe-a2.7b, act_bits=4: B2 on q/k/v and the shared
     up/gate, B1 on wo, the shared down and lm_head, the stacked B3 on the
     experts; every stacked call of a replay held against its plain
     version on the path's own inputs and every B1 and B2 call bitwise,
     the prefill logits reported; no copy of the groups' weights;
 12. profile: `profile_decode` on the act_bits=None MoE slice;
 13. slices, gemma2-9b at full width (42 layers, q4, the output head tied
     to the embedding table; random weights drawn and quantized one leaf
     at a time after qwen2-moe's are freed), act_bits=4 then None through
     `ServeEngine`: every launch count exact (B2 on q/k/v and up/gate, B1
     on wo and down, or B3 on all seven; no lm_head leaf), their folds
     ran, no plain version; prefill logits bitwise (act_bits=4) or within
     5 % of max|logit| of the plain versions'; the tied head (a bf16
     torch.matmul against the table, then the final softcap) timed; the
     act_bits=None slice profiled once (8 new tokens);
 14. slice, pixtral-12b at full width (40 layers, q4, embedding inputs:
     seeded bf16 frames, (B, 16, 5120) for the prompt and one (B, 5120) a
     step): phase 6's checks through `Model.prefill`/`decode_step`, B4 40
     times a decode step on its GQA (32 query heads over 8);
 15. slices, deepseek-v2-lite-16b at full width and a third of its depth
     (9 of 27 layers: one with a dense FFN, 8 MoE with 64 experts at top-6
     and two shared; MLA, whose absorbed decode never runs B4),
     act_bits=None then 4: phase 10 and 11's checks, every launch count
     exact (24 bf16 stacked launches a forward pass), the `live` bounds
     seen and the most experts with rows in one stacked call;
 16. slices, mamba2-1.3b at full width (48 Mamba2 layers, q4, the head
     tied to the embedding table; the chunked SSD scan and the recurrence
     in float32 torch), act_bits=4 then None through `ServeEngine`:
     phase 13's checks, B1 96 a pass (in_proj and out_proj a layer) or B3
     96, no B2; with float activations the 5 % rule on the prefill logits
     is held with float32 activations between the layers (bf16 ones make
     the SSM chaotic: the plain model's own move under a 1e-6 nudge of
     every B3 output is reported beside it);
 16a. continuous batching on mamba2-1.3b, act_bits=4: phase 7a's
     traffic and checks, B1 96 times a decode step and no B2, the conv
     and SSM state rows reset on admission and undone for frozen lanes;
 17. slice, zamba2-7b at full width (81 Mamba2 layers and 13 invocations
     of two shared attention blocks, 32 heads of 112, q4): phase 6's
     checks through `Model`, B1 189 and B2 26 a pass, B4 13 times a
     decode step (one per invocation, each on its own cache), the float
     decode logits against `sdpa`'s held with float32 activations and
     reported with bf16 ones;
 18. the kernels line (B2 over a whole decode block as its own row,
     `program_gemv_block`), then the card's name and power limit, then
     the result line.
The single-executable decode: every serving slice above (3, 4, 6, 8, 8c,
10, 11, 13 to 17) serves first through the per-token loop
(`generate(scan=False)`, or phase 6's loop on `Model`) with the checks
listed, then the same requests through `generate(scan=True)`, whose
decode steps of one power-of-two trip bucket replay as one captured CUDA
graph (pixtral-12b: a `DecodeGraph` fed its frames): greedy tokens equal
to the loop's, no plain version, and launches equal to the loop's plus
what the bucket's extra steps launch eagerly (one eager step counted);
its capture seconds, tokens/s and wall per pass stand beside the loop's
(`scan` in the slice's line). Phase 3 also holds seeded temperature
sampling token for token between the two paths. Each batcher phase (7a,
16a) also serves its requests through the graph tick
(`ContinuousBatcher(scan=True)`, every trip bucket captured first) beside
a per-step batcher, tick by tick: the cache bitwise after every tick, the
outputs equal, the launches exact (`graph_tick`). The profiles (7, 12,
13) profile the default path, the graph. A `decode_graph` line before
the kernels line sums the seconds these checks took.
Any failed check raises, and the script exits nonzero without a result
line. It needs one CUDA device and exits nonzero without one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

# cuBLAS reads this when it makes its first handle: a fixed workspace, so
# that the training phases can run under torch.use_deterministic_algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

B = 4                      # decode lanes of the slice
PROMPT, NEW = 16, 16       # tokens per request
SEED = 0
HBM_BYTES_S = 3.35e12      # H100 SXM device memory rate
PEAK_OPS_S = {"int8": 1979e12, "float32": 67e12, "bfloat16": 989e12}
L2_BYTES = 50 * 2**20
B3_RTOL = 1e-5

# TPU kernels replaced (file:line of the Pallas entry point)
REPLACES = {
    "gemv_bs": "src/repro/kernels/bitplane_gemv/kernel.py:155",
    "program_gemv": "src/repro/kernels/bitplane_gemv/program.py:257",
    "gemv_f": "src/repro/kernels/bitplane_gemv/kernel.py:84",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:72",
    "quant_matmul": "src/repro/kernels/quant_matmul/kernel.py:45",
    "gemv_f_experts": "src/repro/kernels/bitplane_gemv/kernel.py:84 "
                      "gemv_f_pallas under jax.vmap at "
                      "src/repro/models/moe.py:45",
    "gemv_f_experts_mma": "src/repro/kernels/bitplane_gemv/kernel.py:84 "
                          "gemv_f_pallas under jax.vmap at "
                          "src/repro/models/moe.py:45",
}
SOURCES = {
    "gemv_bs": "src/repro_torch/csrc/bitplane_gemv.cu",
    "program_gemv": "src/repro_torch/csrc/bitplane_gemv.cu",
    "gemv_f": "src/repro_torch/csrc/bitplane_gemv.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "quant_matmul": "src/repro_torch/csrc/quant_matmul.cu",
    "gemv_f_experts": "src/repro_torch/csrc/bitplane_gemv.cu",
    "gemv_f_experts_mma": "src/repro_torch/csrc/experts_mma.cu",
}
CONTEXT = 4096             # llama2-7b's published context (KV-cache slots)
MOE_ARCH = "qwen2-moe-a2.7b"
DEEPSEEK_LAYERS = 9        # of 27: the depth cut of its slices
LOGIT_RTOL = 0.05          # of max|logit|, for paths that are not bitwise
RESIDENT_DIMMS = 8         # a fabric that holds all of llama2-7b at q2


START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "elapsed_s": time.perf_counter() - START}),
          flush=True)


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
# B1 and B3 at the slices' prefill (B·PROMPT rows), where the plan has one
# split: B3 runs up/gate so in the slices' prefill; not counted per layer
PREFILL_SHAPES = {"up/gate prefill": (4096, 11008),
                  "lm_head prefill": (4096, 32000)}
GROUP_SHAPES = {"qkv": [(4096, 4096)] * 3, "up_gate": [(4096, 11008)] * 2}
# B1 and B3 at the SSM and hybrid slices' own leaves, q4, B lanes:
# mamba2-1.3b's and zamba2-7b's in_proj and out_proj (not counted in
# llama2-7b's decode layer)
SSM_SHAPES = {"mamba2-1.3b in_proj": (2048, 8512),
              "mamba2-1.3b out_proj": (4096, 2048),
              "zamba2-7b in_proj": (3584, 14576),
              "zamba2-7b out_proj": (7168, 3584)}
SSM_BITS = 4


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


def _fold_through_workspace(kname, arg, planes, scale_t, kw, tpb):
    """One B1/B3 call at a one-split plan, its tiles folded through a
    workspace and the second launch (the way several splits are folded)
    instead of in the block: what the in-block fold is measured against."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.bitplane_gemv import kernel
    b, n = arg.shape
    m = planes.shape[-1]
    tiles = n // kw["bn"]
    out = torch.empty((b, m), dtype=torch.float32, device=arg.device)
    lib = build.library("bitplane_gemv")
    head = (arg.data_ptr(), planes.data_ptr(), scale_t.data_ptr(),
            out.data_ptr())
    dims = (b, n, planes.shape[1], m, kw["q"])
    if kname == "gemv_bs":
        ws = torch.empty((tiles, b, m), dtype=torch.int32, device=arg.device)
        rc = lib.gemv_bs_launch(*head, ws.data_ptr(), *dims, kw["p"],
                                kw["z_a"], kw["z_w"], kw["bn"], tpb, 1,
                                kernel._stream())
    else:
        ws = torch.empty((1, b, m), dtype=torch.float32, device=arg.device)
        rc = lib.gemv_f_launch(*head, ws.data_ptr(), *dims, kw["zero"],
                               kw["bn"], tpb, 1, kernel._stream())
    build.check(rc, kname)
    return out


def phase_kernels(weight_bits: int, act_bits: int) -> dict:
    import torch
    from repro_torch.core.quant import QuantSpec, quantize_activations
    from repro_torch.kernels.bitplane_gemv import kernel, ops, program, ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = {"gemv_bs": [], "gemv_f": [], "program_gemv": []}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    # B1 and B3 per leaf: decode shapes, then prefill ones, then the SSM
    # and hybrid leaves at their own bits
    shapes = [(name, nm, count, B, weight_bits) for name, (nm, count)
              in {**LEAF_SHAPES, **B3_ONLY_SHAPES}.items()] + [
        (name, nm, 0, B * PROMPT, weight_bits)
        for name, nm in PREFILL_SHAPES.items()] + [
        (name, nm, 0, B, SSM_BITS) for name, nm in SSM_SHAPES.items()]
    for name, (n, m), count, batch, bits in shapes:
        bw = _leaf(n, m, gen, bits)
        x = torch.randn((batch, n), generator=gen, device="cuda")
        codes, a, scale_t, bs_kw, f_kw = _leaf_inputs(x, bw, act_bits)
        k_copies = [(_leaf(n, m, gen, bits) if i else bw)
                    for i in range(copies_for(nbytes(bw.planes)))]
        wlib = [torch.randn((n, m), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
                for _ in range(copies_for(n * m * 2))]
        xb = x.to(torch.bfloat16)
        lib_ms = graph_ms([lambda w=w: torch.matmul(xb, w) for w in wlib],
                          20)
        del wlib
        ops_count = 2.0 * batch * n * m
        tiles = codes.shape[1] // bs_kw["bn"]
        plan = dict(zip(("tiles_per_block", "splits"),
                        kernel.split_plan(tiles, m, batch, sms)))
        if (plan["splits"] == 1) != (name in PREFILL_SHAPES):
            raise AssertionError(f"{name}: plan {plan} (one split expected "
                                 f"at the prefill shapes only)")
        for kname, kfn, rfn, arg, kw, kind, exact in (
                ("gemv_bs", kernel.gemv_bs, ref.gemv_bs_ref, codes, bs_kw,
                 "int8", True),
                ("gemv_f", kernel.gemv_f, ref.gemv_f_ref, a, f_kw,
                 "float32", False)):
            # q/k/v and up/gate run on B2 at act_bits: B1 is measured there
            # but not counted in a decode layer
            calls = count if kname == "gemv_f" or name in LEAF_SHAPES else 0
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
            extra = {}
            if plan["splits"] == 1:
                tpb = plan["tiles_per_block"]
                via_ws = _fold_through_workspace(kname, arg, bw.planes,
                                                 scale_t, kw, tpb)
                torch.cuda.synchronize()
                if not torch.equal(via_ws, got):
                    raise AssertionError(f"{kname} {name}: workspace fold "
                                         f"!= in-block fold")
                extra["workspace_fold_ms"] = graph_ms(
                    [lambda c=c: _fold_through_workspace(
                        kname, arg, c.planes, scale_t, kw, tpb)
                     for c in k_copies], 50)
            plain = eager_ms(lambda: rfn(arg, bw.planes, scale_t, **kw))
            # the function needs the leaf's scales once, not the per-tile
            # rows that `_expand_scales` hands the kernel
            t_bound, by = bound(nbytes(arg, bw.planes, bw.scale),
                                nbytes(got), ops_count, kind)
            rows[kname].append(dict(
                shape=name, n=n, m=m, rows=batch, q=bits, count=calls,
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=t_bound,
                bound_by=by, plane_bound_ms=plane_bound_ms(bw.planes),
                library_ms=lib_ms, **plan, **extra))
        del k_copies

    # B2: q/k/v and up/gate, one launch per group over its member table
    spec = QuantSpec(bits=act_bits)
    for gname, shapes in GROUP_SHAPES.items():
        ws = [_leaf(n, m, gen, weight_bits) for n, m in shapes]
        n = shapes[0][0]
        x = torch.randn((B, n), generator=gen, device="cuda")
        table = program.group_table(ws, act_bits)
        aq = quantize_activations(x, spec)
        codes = [torch.nn.functional.pad(
            aq.values, (0, table.members[0].n_pad - n),
            value=aq.zero)] * len(ws)
        plain_args = (codes, table.planes, table.scales, table.members,
                      table.cols)
        got = program.group_gemv(table, codes)
        want = ref.group_gemv_ref(*plain_args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"program_gemv {gname}: kernel != plain "
                                 f"(max|Δ| {err})")
        fused = program.fused_group_linears(x, ws, act_bits, table=table)
        per_leaf = [ops.bitplane_gemv_bitserial(x, w, spec) for w in ws]
        for f, p in zip(fused, per_leaf):
            if not torch.equal(f, p):
                raise AssertionError(f"program_gemv {gname}: fused != "
                                     f"per-leaf gemv_bs")
        k_copies = [table] + [
            program.group_table([_leaf(n_, m_, gen, weight_bits)
                                 for n_, m_ in shapes], act_bits)
            for _ in range(copies_for(nbytes(table.planes)) - 1)]
        ms = graph_ms([lambda t=t: program.group_gemv(t, codes)
                       for t in k_copies], 50)
        del k_copies
        plain = eager_ms(lambda: ref.group_gemv_ref(*plain_args))
        m_all = table.cols
        wlib = [torch.randn((n, m_all), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
                for _ in range(copies_for(n * m_all * 2))]
        xb = x.to(torch.bfloat16)
        lib_ms = graph_ms([lambda w=w: torch.matmul(xb, w) for w in wlib],
                          20)
        del wlib
        # the group's u8 codes once (the members share them), and each
        # leaf's planes and scales
        t_bound, by = bound(
            B * n + nbytes(table.planes, [w.scale for w in ws]),
            nbytes(got), 2.0 * B * n * m_all, "int8")
        rows["program_gemv"].append(dict(
            shape=gname, n=n, m=m_all, count=1, max_abs_err=err, ms=ms,
            plain_ms=plain, bound_ms=t_bound, bound_by=by,
            plane_bound_ms=plane_bound_ms(table.planes),
            library_ms=lib_ms, **dict(zip(("tiles_per_block", "splits"),
                                          table.split(B, sms)))))
    for kname, rs in rows.items():
        for r in rs:
            emit({"phase": "kernel_check", "kernel": kname, **r})
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the slice, full-width llama2-7b
# ---------------------------------------------------------------------------

def _counters() -> tuple:
    """(launch counters, plain-version counters) of every kernel."""
    from repro_torch.kernels.bitplane_gemv import kernel, program, ref
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.quant_matmul import ref as qref
    return ((kernel.LAUNCHES, program.LAUNCHES, dk.LAUNCHES, qk.LAUNCHES),
            (ref.CALLS, dref.CALLS, qref.CALLS))


def counts() -> dict:
    launches, plain = _counters()
    return {"launches": {k: v for d in launches for k, v in d.items()},
            "plain": {k: v for d in plain for k, v in d.items()}}


def reset_counts() -> None:
    for d in sum(_counters(), ()):
        for k in d:
            d[k] = 0


def resident_gb(params, mvdram) -> dict:
    """Device memory a served model holds after warm-up: its weight
    leaves' bit planes (with scales and column sums), what the engine's B2
    member tables of the fused q/k/v and up/gate groups hold beyond the
    leaves (tile scales they had to copy; B2 reads the planes in place),
    and all that the allocator holds (embedding and KV cache included)."""
    import torch
    from repro_torch.core.bitplane import BitplaneWeights

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [tree] if isinstance(tree, BitplaneWeights) else []
    planes = sum(nbytes(w.planes, w.scale, w.col_sum)
                 for w in leaves(params))
    packed = sum(t.owned_bytes for _, t in mvdram._packed.values())
    return {"leaf_planes_gb": planes / 1e9, "packed_groups_gb": packed / 1e9,
            "allocated_gb": torch.cuda.memory_allocated() / 1e9}


def held_no_copy(resident: dict, what: str) -> None:
    """B2 reads the leaves in place: an engine that holds a copy of the
    groups' weights (above 0.01 GB) fails the run."""
    if resident["packed_groups_gb"] > 0.01:
        raise AssertionError(f"{what}: the engine holds "
                             f"{resident['packed_groups_gb']} GB of group "
                             f"copies beside the leaves")


def stage_kinds(cfg) -> list:
    """The kind of every stage a forward pass runs, in order (a hybrid's
    shared-block invocations as "attn"): `Model._layers` without the
    parameters."""
    from repro_torch.models.model import stack_plan
    plan = stack_plan(cfg)
    shared = ["attn"] if cfg.num_shared_blocks else []
    return ([cfg.pattern[0]] * plan.first
            + (list(cfg.pattern) + shared) * plan.repeats
            + [cfg.pattern[0]] * plan.trailing)


def launches_per_pass(cfg, act_bits) -> dict:
    """Launches of each GeMV kernel in one forward pass of `cfg` served
    through the kernel backend (folds apart): at act_bits, B2 once per
    fused group (GQA's q/k/v, a GLU's up/gate, the shared experts'
    up/gate) and B1 on every other bit-plane linear (MLA's wq, w_dkv and
    wo each, the downs, a Mamba2 stage's in_proj and out_proj, lm_head
    unless the head is tied to the embedding); with float activations B3
    on each of those leaves; the bf16 stacked B3 on each expert stack."""
    from repro_torch.models.model import stack_plan
    plan = stack_plan(cfg)
    kinds = stage_kinds(cfg)
    mamba_layers = kinds.count("mamba")
    attn_layers = len(kinds) - mamba_layers
    moe_layers = plan.repeats * len(cfg.pattern) if cfg.moe else 0
    dense_layers = attn_layers - moe_layers
    groups = members = 0
    singles = 2 * mamba_layers
    if cfg.mla is not None:
        singles += 3 * attn_layers
    else:
        groups, members = attn_layers, 3 * attn_layers
        singles += attn_layers
    if cfg.ffn_type == "glu":
        groups, members = groups + dense_layers, members + 2 * dense_layers
        singles += dense_layers
    else:
        singles += 2 * dense_layers
    if cfg.moe and (cfg.moe.num_shared or cfg.moe.shared_d_ff):
        groups, members = groups + moe_layers, members + 2 * moe_layers
        singles += moe_layers
    singles += 0 if cfg.tie_embeddings else 1
    stacks = (3 if cfg.ffn_type == "glu" else 2) * moe_layers
    return {"program_gemv": groups if act_bits else 0,
            "gemv_bs": singles if act_bits else 0,
            "gemv_f": 0 if act_bits else members + singles,
            "gemv_f_experts_mma": stacks, "gemv_f_experts": 0}


def eager_step_counts(model, params, max_seq: int, inp) -> dict:
    """Launches of ONE eager decode step of `model` (B lanes at position
    PROMPT of a fresh cache of `max_seq` slots, input `inp`): what each
    step of a decode graph's replay must add to the counts."""
    import torch
    cache = model.init_cache(B, max_seq, "cuda")
    reset_counts()
    with torch.no_grad():
        model.decode_step(params, cache, inp, PROMPT)
    torch.cuda.synchronize()
    return counts()["launches"]


def held_scan_counts(what, seen, loop_seen, step, extra: int) -> None:
    """A scan run's counts must be its loop run's plus what `extra` more
    eager decode steps launch (the trip bucket's frozen tail), with no
    plain version."""
    for k, v in loop_seen["launches"].items():
        if seen["launches"][k] != v + extra * step[k]:
            raise AssertionError(
                f"{what}, scan: {k} launched {seen['launches'][k]} times, "
                f"not the loop's {v} + {extra} eager steps of {step[k]}")
    if any(seen["plain"].values()):
        raise AssertionError(f"{what}, scan: a plain version ran on the "
                             f"card ({seen})")


def scan_served(eng, prompts, loop_toks, loop_seen, new, what) -> dict:
    """`generate(scan=True)` on the requests the loop served (the `scan`
    fields of the slice's line): one call captures the (B, trip) decode
    graph, then a counted, timed call must give the loop's greedy tokens
    with the loop's launches plus the trip's extra steps, no plain
    version."""
    import torch
    t_part = time.perf_counter()
    trip = min(eng.max_seq - prompts.shape[1] - 1,
               1 << (new - 2).bit_length())
    step = eager_step_counts(eng.model, eng.params, eng.max_seq,
                             prompts[:, 0])
    t0 = time.perf_counter()
    eng.generate(prompts, max_new=new)           # captures the graph
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    walls, toks, seen = timed_calls(
        lambda: eng.generate(prompts, max_new=new))
    held_scan_counts(what, seen, loop_seen, step, trip - (new - 1))
    if not torch.equal(toks, loop_toks):
        raise AssertionError(
            f"{what}: scan tokens differ from the loop's at "
            f"{int((toks != loop_toks).sum())} positions")
    dt = statistics.median(walls)
    graph = eng.decode_graphs[(B, trip)]
    # where a call's wall goes: the eager prefill, and the replay alone
    # (on the graph's buffers as the last call left them)
    with torch.no_grad():
        prefill_s = min(timed_calls(lambda: eng.model.prefill(
            eng.params, {"tokens": prompts}, eng.max_seq))[0])
    replay_s = min(timed_calls(graph.captured.run)[0])
    return added({
        "trip": trip, "lanes": B, "capture_seconds": graph.captured.capture_s,
        "first_call_seconds": first, "seconds": dt, "walls_s": walls,
        "tokens_per_s": B * new / dt, "wall_per_pass_ms": dt / new * 1e3,
        "prefill_ms": prefill_s * 1e3, "replay_ms": replay_s * 1e3,
        "replay_ms_per_step": replay_s / trip * 1e3,
        "tokens_equal_loop": True,
        "launches_equal_loop_plus_steps": trip - (new - 1)}, t_part)


#: timed calls of a scan run (the first one counted); one call is a few
#: hundred ms, so a collector's pause would move a single reading
SCAN_CALLS = 3


def timed_calls(call) -> tuple:
    """(the walls of SCAN_CALLS synchronized calls, the first's result,
    the counts of the first alone, zeroed just before it)."""
    import torch
    walls = []
    for i in range(SCAN_CALLS):
        torch.cuda.synchronize()
        if i == 0:
            reset_counts()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            first, seen = out, counts()
    return walls, first, seen


#: seconds each check of the single-executable decode took, in order
ADDED_SECONDS: list = []


def added(fields: dict, t0: float) -> dict:
    """`fields` with the seconds since `t0` (`added_seconds`), which also
    count into the smoke's total."""
    dt = time.perf_counter() - t0
    ADDED_SECONDS.append(dt)
    return {**fields, "added_seconds": dt}


def served(cfg, qparams, prompts, act_bits, must_run=(), want=None,
           new=NEW, sampled=False):
    """Serve the requests (`new` tokens each) through the kernel backend,
    with the counts zeroed just before and read just after: (engine,
    tokens, the phase line's fields). Fails if a kernel of `must_run`
    never launched, a count differs from `want`, a plain version ran, the
    engine holds a copy of the groups' weights or the tokens are
    wrong. The loop (`scan=False`) serves first; then the same requests
    through the decode graph (`scan_served`); with `sampled`, seeded
    temperature sampling must give the same tokens on both paths."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    what = f"{cfg.name} act_bits={act_bits}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, qparams, max_seq=PROMPT + NEW + 1,
                      batch_slots=B, quantized=True, act_bits=act_bits,
                      device="cuda")
    construct = time.perf_counter() - t0
    # pack B2 groups, warm up
    eng.generate(prompts[:, :4], max_new=2, scan=False)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    resident = resident_gb(eng.params, eng.mvdram)
    held_no_copy(resident, what)
    reset_counts()
    t0 = time.perf_counter()
    toks = eng.generate(prompts, max_new=new, scan=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    seen = counts()
    for k in must_run:
        if seen["launches"][k] <= 0:
            raise AssertionError(f"{what}: {k} never launched ({seen})")
    for k, v in (want or {}).items():
        if seen["launches"][k] != v:
            raise AssertionError(f"{what}: {k} launched "
                                 f"{seen['launches'][k]} times, not {v} "
                                 f"({seen})")
    if any(seen["plain"].values()):
        raise AssertionError(f"{what}: a plain version ran on the card "
                             f"({seen})")
    if tuple(toks.shape) != (B, PROMPT + new) or \
            not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{what}: bad tokens {tuple(toks.shape)}")
    if not torch.equal(toks[:, :PROMPT], prompts):
        raise AssertionError(f"{what}: prompt tokens not echoed")
    fields = {
        "tokens_shape": list(toks.shape), "seconds": dt,
        "tokens_per_s": B * new / dt, "wall_per_pass_ms": dt / new * 1e3,
        "setup_seconds": setup, "construct_seconds": construct,
        "placement_fallback": eng.placement_fallback,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **seen,
        "resident": resident}
    fields["scan"] = scan_served(eng, prompts, toks, seen, new, what)
    if sampled:
        fields["scan"]["sampled"] = sampled_check(eng, prompts, new, what)
    return eng, toks, fields


def sampled_check(eng, prompts, new, what) -> dict:
    """Seeded temperature sampling on the card: the decode graph's tokens
    equal the loop's (both draw the same noise from the seed, step by
    step)."""
    import torch
    t0 = time.perf_counter()
    kw = dict(max_new=new, temperature=0.8, seed=SEED + 9)
    hot = eng.generate(prompts, **kw)
    loop = eng.generate(prompts, scan=False, **kw)
    if not torch.equal(hot, loop):
        raise AssertionError(
            f"{what}: sampled tokens differ between scan and loop at "
            f"{int((hot != loop).sum())} positions")
    greedy = eng.generate(prompts, max_new=new)
    return added({"temperature": kw["temperature"], "seed": kw["seed"],
                  "tokens_equal_loop": True,
                  "positions_differing_from_greedy": int(
                      (hot != greedy).sum())}, t0)


def tied_head(eng) -> dict:
    """The tied head of a decode step (`Model._logits`: B rows against the
    whole embedding table in the model's dtype, then the final softcap),
    timed on the card beside the table's bytes at the memory rate."""
    import torch
    table = eng.params["embed"]
    x = torch.randn((B, 1, table.shape[1]), device="cuda",
                    dtype=table.dtype)
    ms = graph_ms([lambda: eng.model._logits(eng.params, x)], 20)
    return {"tied_head_ms": ms, "table_gb": nbytes(table) / 1e9,
            "table_bound_ms": nbytes(table) / HBM_BYTES_S * 1e3}


def prefill_logits(cfg, qparams, prompts, act_bits, impl=None):
    """The requests' prefill logits through a new `ServeEngine` on the
    kernel backend (impl None) or on the plain versions ("reference")."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, qparams, max_seq=PROMPT + NEW + 1, batch_slots=B,
                      quantized=True, act_bits=act_bits, impl=impl,
                      device="cuda")
    with torch.no_grad():
        return eng.model.prefill(eng.params, {"tokens": prompts},
                                 eng.max_seq)[0]


def ssm_float_check(cfg, qparams, prompts) -> dict:
    """Float activations on a model with Mamba2 stages. In bf16 its logits
    are chaotic: one bf16 rounding flip between the SSM's ops grows layer
    by layer to a different answer (PERF.md §6), so B3's summation order
    alone moves them by a quarter of their size. The 5 % rule is held with
    float32 activations between the layers instead (the same planes and
    kernels), and the plain model's own move in bf16 when every B3 output
    is nudged by 1e-6 of itself is reported beside it."""
    import torch
    from repro_torch.kernels.bitplane_gemv import ref
    f32 = dataclasses.replace(cfg, dtype="float32")
    got = prefill_logits(f32, qparams, prompts, None)
    want = prefill_logits(f32, qparams, prompts, None, "reference")
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if not bool(torch.isfinite(got).all()) or err > LOGIT_RTOL * scale:
        raise AssertionError(f"{cfg.name} float32 activations: logits "
                             f"differ from the plain versions' (max|Δ| "
                             f"{err}, max|logit| {scale})")
    plain = prefill_logits(cfg, qparams, prompts, None, "reference")
    real = ref.gemv_f_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def nudged(*args, **kw):
        o = real(*args, **kw)
        return o * (1 + 1e-6 * torch.randn(o.shape, generator=gen,
                                           device=o.device))
    ref.gemv_f_ref = nudged
    try:
        moved = prefill_logits(cfg, qparams, prompts, None, "reference")
    finally:
        ref.gemv_f_ref = real
    return {"prefill_logits_float32_max_abs_err_vs_plain": err,
            "max_abs_logit_float32": scale,
            "plain_prefill_logits_moved_by_1e-6_nudge": float(
                (moved - plain).abs().max())}


def phase_slice(cfg, qparams, prompts, act_bits, must_run, want=None,
                name=None, sampled=False) -> dict:
    """Serve the requests (`served`); then hold the prefill logits against
    the same model on the plain versions: bitwise at act_bits, within 5 %
    of max|logit| with float activations (with Mamba2 stages: float32
    ones, `ssm_float_check`). A tied head is timed too."""
    import torch
    eng, _, out = served(cfg, qparams, prompts, act_bits, must_run, want,
                         sampled=sampled)
    with torch.no_grad():
        got, _ = eng.model.prefill(eng.params, {"tokens": prompts},
                                   eng.max_seq)
    want_l = prefill_logits(cfg, qparams, prompts, act_bits, "reference")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite logits")
    err = float((got - want_l).abs().max())
    if act_bits and not torch.equal(got, want_l):
        raise AssertionError(f"act_bits={act_bits}: kernel logits != plain "
                             f"logits (max|Δ| {err})")
    # B3 sums in another order than its plain version, and bf16
    # activations between the layers amplify that, so the float path is
    # held to agreement of the logits at bf16 resolution (a wrong kernel
    # misses by the logits' own size)
    scale = float(want_l.abs().max())
    if not act_bits and cfg.ssm is None and err > LOGIT_RTOL * scale:
        raise AssertionError(f"act_bits=None: logits differ from the "
                             f"plain versions' (max|Δ| {err}, "
                             f"max|logit| {scale})")
    out = {"phase": name or f"slice_act_bits_{act_bits}", **out,
           "prefill_logits_max_abs_err_vs_plain": err,
           "max_abs_logit": scale}
    if not act_bits and cfg.ssm is not None:
        out |= ssm_float_check(cfg, qparams, prompts)
    if cfg.tie_embeddings:
        out |= tied_head(eng)
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 4a: the DRAM residency session, its DDR4 price, B2 per decode block
# ---------------------------------------------------------------------------

def placed_leaves(qparams) -> int:
    """Matrices `ServeEngine._place_model` registers: every 2-D bit-plane
    leaf, a layer-stacked one once per layer, expert stacks left out."""
    from repro_torch.core.bitplane import BitplaneWeights
    if isinstance(qparams, dict):
        return sum(placed_leaves(v) if k not in ("w_up", "w_gate", "w_down")
                   else 0 for k, v in qparams.items())
    if not isinstance(qparams, BitplaneWeights):
        return 0
    return {3: 1, 4: qparams.planes.shape[0]}.get(qparams.planes.ndim, 0)


def residency(eng, leaves: int, what: str) -> dict:
    """The engine's residency stats and DDR4-model prices (seconds and
    Joules of the model, not of the card); fails unless the whole model
    is placed, resident or spilled, with a compiled program."""
    st = eng.residency_stats()
    if eng.placement_fallback or eng.decode_program is None:
        raise AssertionError(f"{what}: fell back to program-less serving")
    if st["placements"] + st.get("spilled", 0) != leaves:
        raise AssertionError(f"{what}: {st['placements']} resident + "
                             f"{st.get('spilled', 0)} spilled != {leaves}")
    step = eng.price_decode_step()
    ticks = {str(k): {"s": eng.decode_tick_cost_s(k),
                      "j": eng.decode_tick_energy_j(k)}
             for k in range(1, B + 1)}
    if not all(v["s"] > 0 and v["j"] > 0 for v in ticks.values()):
        raise AssertionError(f"{what}: a tick priced at 0 ({ticks})")
    keep = ("dimms", "placements", "spilled", "utilization", "used_rows",
            "total_rows", "staged_bits", "compactions", "migrations",
            "spills", "spill_restages", "spill_restaged_bits",
            "placement_fallback", "resident_program")
    return {"stats": {k: st[k] for k in keep if k in st},
            "parts": len(eng.decode_program.parts),
            "priced_step": {k: step[k] for k in (
                "layers", "batch", "t_total", "e_pud", "e_io", "e_host",
                "e_spill", "t_compute",
                "t_aggregate", "t_encode_extra", "t_spill_restage",
                "spill_restage_bits", "spill_restages", "waves",
                "waves_shared", "t_sequential_total", "residency_speedup",
                "scaleout_speedup")},
            "tick_price": ticks}


def phase_residency(cfg, qparams) -> dict:
    """The residency session at full width on phase 3's quantized tree:
    `ServeEngine(quantized=True, act_bits=4)` on 8 DIMMs (every leaf
    resident, no fallback) and on the paper's 4 DIMMs with the spill tier
    (resident + spilled = every leaf), with their DDR4-model prices at
    occupancy 1 to B. Then B2 over a whole decode block: each resident
    part of the 8-DIMM program through `run_kernel` on seeded (B, N)
    activations, the counts zeroed just before each and read just after
    (one B2 launch, its fold when split, nothing else, no plain version),
    every output bitwise per-leaf B1's, masked lanes exactly 0. Each
    part's launch is timed beside the same leaves' B1 launches, its plain
    version and the planes at the memory rate. B2 is timed with CUDA
    events around eager launches (its table's per-call copy is pageable,
    which a graph cannot capture), the leaves' B1 from a CUDA graph."""
    import numpy as np
    import torch
    from repro_torch.kernels.bitplane_gemv import kernel, ops, program, ref
    from repro_torch.serve.engine import ServeEngine
    leaves = placed_leaves(qparams)
    out = {"phase": "residency_llama2_7b", "card": nvidia_smi(),
           "leaves": leaves, "prices_are": "the DDR4 model's, not the card's"}
    for key, kw in (("dimms_8", {"dimms": RESIDENT_DIMMS}),
                    ("dimms_4_spill", {"dimms": 4, "spill_tier": True})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, qparams, max_seq=PROMPT + NEW + 1,
                          batch_slots=B, quantized=True, act_bits=4,
                          device="cuda", **kw)
        out[key] = {"construct_seconds": time.perf_counter() - t0,
                    "allocated_gb": torch.cuda.memory_allocated() / 1e9,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    **residency(eng, leaves, key)}
        if "spill" in key:
            ledger = eng.mvdram.pool.spill_ledger()
            out[key]["spill_ledger"] = list(ledger)
            if not out[key]["stats"]["spilled"] or \
                    not out[key]["priced_step"]["t_spill_restage"] > 0:
                raise AssertionError(f"{key}: nothing spilled or no restage "
                                     f"term ({out[key]})")
            del eng
        else:
            eng8 = eng
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mask = np.arange(B) % 2 == 0
    parts = []
    for k, part in enumerate(eng8.decode_program.parts):
        prog = part.prog
        table = prog.kernel_table()
        specs = [h.a_spec for h in prog.handles]
        xs = [torch.randn((B, h.weights.n), generator=gen, device="cuda")
              for h in prog.handles]
        _, splits = table.split(B, sms)
        reset_counts()
        got = prog.run_kernel(xs)
        torch.cuda.synchronize()
        seen = counts()
        want = {name: 0 for name in seen["launches"]}
        want["program_gemv"] = 1
        want["program_gemv_fold"] = int(splits > 1)
        if seen["launches"] != want or any(seen["plain"].values()):
            raise AssertionError(f"part {k}: launches {seen}, not one B2 "
                                 f"launch ({splits} splits)")
        for h, x, o in zip(prog.handles, xs, got):
            leaf = ops.bitplane_gemv_bitserial(x, h.weights, h.a_spec)
            if not torch.equal(o, leaf):
                raise AssertionError(f"part {k} {h.name}: whole-block B2 "
                                     f"!= per-leaf B1")
        masked = prog.run_kernel(xs, lane_mask=mask)
        keep = torch.from_numpy(mask).cuda()[:, None]
        for o, mo in zip(got, masked):
            if not (torch.equal(mo[keep[:, 0]], o[keep[:, 0]])
                    and bool((mo[~keep[:, 0]] == 0).all())):
                raise AssertionError(f"part {k}: lane mask broke a row")
        codes, _ = program.block_codes(table, xs, specs)
        k_out = program.group_gemv(table, codes)
        p_out = ref.group_gemv_ref(codes, table.planes, table.scales,
                                   table.members, table.cols)
        err = float((k_out - p_out).abs().max())
        if not torch.equal(k_out, p_out):
            raise AssertionError(f"part {k}: B2 != its plain version "
                                 f"(max|Δ| {err})")
        del k_out, p_out
        ms = eager_ms(lambda: program.group_gemv(table, codes), reps=10)
        leaf_in = [_leaf_inputs(x, h.weights, h.a_spec.bits)
                   for h, x in zip(prog.handles, xs)]
        # the same leaves through B1, one launch (and fold) each, from a
        # CUDA graph: device time without the host's launch gaps
        b1_ms = graph_ms([lambda: [
            kernel.gemv_bs(c, h.weights.planes, st, **kw)
            for (c, _a, st, kw, _f), h in zip(leaf_in, prog.handles)]], 5)
        plain = eager_ms(lambda: ref.group_gemv_ref(
            codes, table.planes, table.scales, table.members, table.cols),
            reps=1)
        del leaf_in
        ops_count = 2.0 * B * sum(h.weights.n * h.weights.m
                                  for h in prog.handles)
        t_bound, by = bound(
            nbytes(codes, table.planes,
                   [h.weights.scale for h in prog.handles]),
            B * table.cols * 4, ops_count, "int8")
        parts.append({"part": k, "members": len(prog.handles),
                      "cols": table.cols, "strips": table.strips,
                      "splits": splits, "max_abs_err": err, "ms": ms,
                      "per_leaf_b1_ms": b1_ms, "plain_ms": plain,
                      "bound_ms": t_bound, "bound_by": by,
                      "plane_bound_ms": plane_bound_ms(table.planes),
                      "planes_gb": nbytes(table.planes) / 1e9})
    out["b2_whole_block"] = parts
    out["b2_whole_block_launches"] = len(parts)
    emit(out)
    return out, eng8


# ---------------------------------------------------------------------------
# phase 7b: the functional PUD simulator on part 0 of the 8-DIMM program
# ---------------------------------------------------------------------------

SIM_BER = 0.05             # transient MAJX upsets per (lane, tile) a wave
SIM_RETRIES = 4            # wave retries before the recovery ladder


def _tile_counts(rep) -> list:
    """Per-(layer, lane) per-tile runtime OpCounts of a ProgramReport."""
    return [[r.tile_runtime for r in layer.requests] for layer in rep.reports]


def _timed_run(prog, xs, **kw):
    """One `prog.run`, its wall seconds and the host's waits on the device
    in it (the sync debug mode's warnings)."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            outs, rep = prog.run(xs, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = sum("synchroniz" in str(w.message) for w in caught)
    return outs, rep, dt, waits


def phase_sim(eng8, tick_masks) -> dict:
    """The functional PUD simulator at full width: part 0 of the 8-DIMM
    `ServeEngine`'s decode program (phase 4a's `eng8`), its bit state
    staged on the card, run on seeded (B, N) activations through
    `GemvProgram.run` (the fused wave-major executor). Checks: every
    staged tensor on cuda; each leaf's integer partials equal to an
    independent exact product of the activation and weight codes (float64
    on the card), bitwise; outputs within rtol 1e-4 / atol 1e-4·max|B2|
    of `run_kernel` (B2); the layer-major oracle bitwise in outputs and
    per-(lane, tile) counts; two occupancy masks of the bf16 batcher's
    ticks (1 and 3 lanes) with active rows bitwise the full run's, masked
    rows 0 and masked lanes billing 0 ops; `price_program(executed=)`'s
    bank term (its price with the command bus's time at 0) equal to
    `simulated_wave_time` and its `e_total` equal to the executed ledger's
    energy; one 4096→4096 leaf under transient faults with retries:
    detection coverage 1.0, outputs bitwise the fault-free run's, the
    retry waves in the price. Prices are the DDR4 model's, not the
    card's."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.engine import MVDRAMEngine
    from repro_torch.core.pud.faults import FaultModel, FaultPolicy
    from repro_torch.core.pud.timing import simulated_wave_time
    from repro_torch.core.quant import quantize_activations
    mv = eng8.mvdram
    prog = eng8.decode_program.parts[0].prog
    hs = prog.handles
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    xs = [torch.randn((B, h.weights.n), generator=gen, device="cuda")
          for h in hs]
    out = {"phase": "sim_llama2_7b", "card": nvidia_smi(),
           "prices_are": "the DDR4 model's, not the card's",
           "leaves": len(hs), "tiles": prog.sched.tiles,
           "waves": prog.sched.waves}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stageds = [mv.staged_for(h) for h in hs]
    torch.cuda.synchronize()
    out["staging_s"] = time.perf_counter() - t0
    # the first run also indexes the fused plan over the staged rows
    outs, rep, out["first_run_s"], out["first_run_host_waits"] = \
        _timed_run(prog, xs)
    outs, rep, out["run_s"], out["host_waits_per_run"] = _timed_run(prog, xs)
    on_card = all(g.bank.data.is_cuda and g.matrix_block.is_cuda
                  and g.checksum.is_cuda for st in stageds
                  for g in st.groups) and prog._fused.matrix.is_cuda \
        and all(o.is_cuda for o in outs)
    if not on_card:
        raise AssertionError("sim: staged state or outputs off the card")
    out["staged_gb"] = prog.sim_bytes / 1e9
    out["staged_rows_gb"] = sum(st.nbytes for st in stageds) / 1e9
    out["allocated_gb"] = torch.cuda.memory_allocated() / 1e9
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # 2. integer partials against an exact float64 product of the codes
    set_bits, all_bits = 0, 0
    for h, x, part in zip(hs, xs, rep.partials):
        aq = quantize_activations(x, h.a_spec)
        st = mv.staged_for(h)
        pad = st.n_chunks * st.n_sub - st.n
        a = torch.nn.functional.pad(aq.values.double(), (0, pad))
        w = torch.nn.functional.pad(h.wq.values.double(), (0, 0, 0, pad))
        exact = torch.einsum("bcn,cnm->bcm",
                             a.reshape(B, st.n_chunks, st.n_sub),
                             w.reshape(st.n_chunks, st.n_sub, st.m))
        if not torch.equal(part, exact.to(torch.int64)):
            raise AssertionError(f"sim {h.name}: partials != the exact "
                                 f"product of the codes")
        bits = (aq.values.int()[..., None]
                >> torch.arange(h.a_spec.bits, device="cuda")) & 1
        set_bits += int(bits.sum())
        all_bits += bits.numel()
        del a, w, exact
    out["partials_exact_leaves"] = len(hs)
    out["bit_density"] = set_bits / all_bits

    # 3. outputs against B2 over the same block
    b2 = prog.run_kernel(xs)
    err, scale = 0.0, 0.0
    for h, o, k in zip(hs, outs, b2):
        d = (o - k).abs()
        err = max(err, float(d.max()))
        scale = max(scale, float(k.abs().max()))
        if bool((d > 1e-4 * k.abs() + 1e-4 * float(k.abs().max())).any()):
            raise AssertionError(f"sim {h.name}: outputs off B2's by "
                                 f"{float(d.max())}")
    out["max_abs_err_vs_b2"] = err
    out["max_abs_b2"] = scale

    # 4. the layer-major oracle
    t0 = time.perf_counter()
    outs_l, rep_l = prog.run(xs, layer_major=True)
    torch.cuda.synchronize()
    out["layer_major_s"] = time.perf_counter() - t0
    if not all(torch.equal(a, b) for a, b in zip(outs, outs_l)) or \
            _tile_counts(rep) != _tile_counts(rep_l):
        raise AssertionError("sim: fused != layer-major")

    # 5. occupancy masks of the bf16 batcher's ticks
    picked = {}
    for m in tick_masks:
        picked.setdefault(int(m.sum()), np.asarray(m, bool))
    masks_run = []
    for k in (1, 3):
        if k not in picked:
            raise AssertionError(f"sim: no {k}-lane tick among the "
                                 f"batcher's masks {sorted(picked)}")
        mask = picked[k]
        mo, mrep, _, _ = _timed_run(prog, xs, lane_mask=mask)
        keep = torch.from_numpy(mask).cuda()
        for o, a in zip(mo, outs):
            if not (torch.equal(o[keep], a[keep])
                    and bool((o[~keep] == 0).all())):
                raise AssertionError(f"sim: lane mask {mask} broke a row")
        for lay_m, lay_f in zip(mrep.reports, rep.reports):
            for b in range(B):
                got = lay_m.requests[b].runtime
                if mask[b] and got != lay_f.requests[b].runtime or \
                        not mask[b] and any(got.asdict().values()):
                    raise AssertionError(f"sim: lane {b} of mask {mask} "
                                         f"billed {got}")
        masks_run.append(mask.tolist())
    out["lane_masks"] = masks_run

    # 6. the executed price against the analytic one
    def bank_term(**kw) -> float:
        """A price's bank term: its compute time with the command bus's
        time per slot at 0."""
        timing = mv.timing
        mv.timing = dataclasses.replace(timing, t_cmd=0.0)
        try:
            return mv.price_program(prog, batch=B, **kw).t_compute
        finally:
            mv.timing = timing

    cost = mv.price_program(prog, batch=B, executed=rep)
    bank = bank_term(executed=rep)
    timing = mv.timing
    sim_t = simulated_wave_time(rep, timing)
    if bank != sim_t:
        raise AssertionError(f"sim: bank term {bank} != "
                             f"simulated_wave_time {sim_t}")
    en, ex = mv.energy, rep.executed_counts
    ledger_j = (en.pud_energy(ex) + en.io_energy(ex.host_bits_read
                                                 + ex.host_bits_written)
                + (en.host_energy(ex.host_int_ops)
                   + en.idle_power * cost.t_compute) + 0.0 + 0.0)
    if cost.e_total != ledger_j:
        raise AssertionError(f"sim: e_total {cost.e_total} != the ledger's "
                             f"{ledger_j}")
    analytic = mv.price_program(prog, bit_density=out["bit_density"],
                                batch=B)
    out["executed_price"] = {"t_total": cost.t_total,
                             "t_compute": cost.t_compute,
                             "bank_s": bank, "e_total": cost.e_total}
    out["analytic_price"] = {
        "t_total": analytic.t_total, "t_compute": analytic.t_compute,
        "bank_s": bank_term(bit_density=out["bit_density"]),
        "e_total": analytic.e_total}

    # 7. faults on one resident square leaf (4096→4096 at full width)
    i = next(j for j, h in enumerate(hs) if h.weights.n == h.weights.m)
    feng = MVDRAMEngine(geom=mv.geom,
                        fault_model=FaultModel(transient_ber=SIM_BER,
                                               seed=SEED),
                        fault_policy=FaultPolicy(max_wave_retries=SIM_RETRIES))
    feng.register_packed("leaf", hs[i].weights, a_spec=hs[i].a_spec)
    fprog = feng.compile(["leaf"], b_max=B)
    (fo,), frep, out_s, _ = _timed_run(fprog, [xs[i]])
    tr = frep.fault
    if not (tr.corrupted > 0 and tr.coverage == 1.0 and not tr.unresolved
            and torch.equal(fo, outs[i])):
        raise AssertionError(f"sim faults: {tr}")
    fcost = feng.price_program(fprog, batch=B, executed=frep)
    if fcost.retry_waves != len(tr.retry_wave_ops) or not \
            fcost.retry_waves > 0 or \
            fcost.t_retry != sum(tr.retry_wave_ops) * timing.t_op:
        raise AssertionError(f"sim faults: retries {tr.retry_wave_ops} "
                             f"not in the price {fcost.t_retry}")
    out["faults"] = {"leaf": hs[i].name, "transient_ber": SIM_BER,
                     "max_retries": SIM_RETRIES, "corrupted": tr.corrupted,
                     "detected": tr.detected, "coverage": tr.coverage,
                     "retries": tr.retries, "run_s": out_s,
                     "t_retry": fcost.t_retry, "e_retry": fcost.e_retry}
    del feng, fprog
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 5: B4 and B5 against their plain versions
# ---------------------------------------------------------------------------

def _held(name, got, want) -> float:
    """Max |Δ| of a kernel's output against its plain version's, raising
    outside the stated tolerance: rtol/atol 1e-5 for a float32 output
    (tests/test_decode_kernel.py:42); for a bf16 output one bf16 ulp
    (2^-7 relative: both round float32 results that differ in the last
    bits) plus 1e-5·max|plain|."""
    import torch
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if got.dtype == torch.float32:
        tol = 1e-5 + 1e-5 * w.abs()
    else:
        tol = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) \
            + 1e-5 * float(w.abs().max())
    if not bool(torch.isfinite(g).all()) or not bool(((g - w).abs()
                                                      <= tol).all()):
        raise AssertionError(f"{name}: kernel outside tolerance of the "
                             f"plain version (max|Δ| {err})")
    return err


def _ring_stamps(pos, slots: int):
    """Stamps of a ring buffer of `slots` slots per lane that has seen
    positions 0..pos: slot t holds the newest position ≡ t mod slots, or
    -1 if there is none yet."""
    import torch
    t = torch.arange(slots, device=pos.device, dtype=torch.int32)
    st = pos[:, None] - (pos[:, None] - t[None, :]) % slots
    return torch.where(st >= 0, st, torch.full_like(st, -1))


# (name, B, S, H, Hkv, D, q/cache type, stamps, window, count per decode
# layer): the full-context llama2-7b shapes, the slice's own call (an int8
# cache of CONTEXT slots of which each lane has stamped 16–31: the count,
# one call a decode layer, is this row's, the call the slice makes) and
# pixtral-12b's (GQA 32 over 8), GQA at the full context (qwen2-7b: 28
# query heads over 4 KV heads; starcoder2-3b: 24 over 2), one lane, then
# small GQA, windowed ring-buffer and no-valid-slot shapes. Stamps: "full"
# every slot valid, "ring" a ring buffer at several positions, "one empty"
# lane 0 partly filled and lane 1 empty, "path" slots 0..pos with pos
# 15–30.
DECODE_SHAPES = [
    ("llama2-7b bf16 cache", 4, CONTEXT, 32, 32, 128, "bf16", "full", None,
     0),
    ("llama2-7b int8 cache", 4, CONTEXT, 32, 32, 128, "int8", "full", None,
     0),
    ("path: int8 cache, 16-31 valid slots", 4, CONTEXT, 32, 32, 128, "int8",
     "path", None, 1),
    ("pixtral-12b path: gqa 32/8, int8, 16-31 valid slots", 4, CONTEXT, 32,
     8, 128, "int8", "path", None, 0),
    ("zamba2-7b path: mha 32 heads of 112, int8, 16-31 valid slots", 4,
     CONTEXT, 32, 32, 112, "int8", "path", None, 0),
    ("llama2-7b int8 cache B=1", 1, CONTEXT, 32, 32, 128, "int8", "full",
     None, 0),
    ("qwen2-7b gqa int8 cache", 4, CONTEXT, 28, 4, 128, "int8", "full", None,
     0),
    ("qwen2-7b gqa bf16 cache", 4, CONTEXT, 28, 4, 128, "bf16", "full", None,
     0),
    ("starcoder2-3b gqa bf16 cache", 4, CONTEXT, 24, 2, 128, "bf16", "full",
     None, 0),
    ("gqa Hkv=8 f32", 2, 1000, 32, 8, 128, "f32", "full", None, 0),
    ("ring window=1024 int8", 4, 1024, 32, 32, 128, "int8", "ring", 1024, 0),
    ("lane without valid slot f32", 2, 512, 32, 32, 128, "f32", "one empty",
     None, 0),
    # head dims between the built sizes: 16 (tiny configs), 112
    # (zamba2-7b), at full context; 320, above the fast body (256)
    ("D=16 int8 cache", 4, CONTEXT, 32, 32, 16, "int8", "full", None, 0),
    ("D=16 bf16 cache", 4, CONTEXT, 32, 32, 16, "bf16", "full", None, 0),
    ("D=112 int8 cache", 4, CONTEXT, 32, 32, 112, "int8", "full", None, 0),
    ("D=112 bf16 cache", 4, CONTEXT, 32, 32, 112, "bf16", "full", None, 0),
    ("D=320 bf16 cache", 4, CONTEXT, 32, 32, 320, "bf16", "full", None, 0),
]


def _decode_inputs(gen, b, s, h, hkv, d, kind, fill, window):
    import torch
    dt = torch.float32 if kind == "f32" else torch.bfloat16
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(dt)
    kf = torch.randn((b, s, hkv, d), generator=gen, device="cuda")
    vf = torch.randn((b, s, hkv, d), generator=gen, device="cuda")
    ks = vs = None
    if kind == "int8":
        ks = kf.abs().amax(-1) / 127 + 1e-8
        vs = vf.abs().amax(-1) / 127 + 1e-8
        k = torch.round(kf / ks[..., None]).to(torch.int8)
        v = torch.round(vf / vs[..., None]).to(torch.int8)
    else:
        k, v = kf.to(dt), vf.to(dt)
    del kf, vf
    pos = torch.full((b,), s - 1, device="cuda", dtype=torch.int32)
    stamps = torch.arange(s, device="cuda", dtype=torch.int32).repeat(b, 1)
    if fill == "ring":              # lanes at several ring positions
        pos = torch.tensor([5000, 4100, 1500, 700][:b], device="cuda",
                           dtype=torch.int32)
        stamps = _ring_stamps(pos, s)
    elif fill == "one empty":       # lane 0 partly filled, lane 1 empty
        pos[0] = 300
        stamps[0] = torch.where(stamps[0] <= 300, stamps[0], -1)
        stamps[1] = -1
    elif fill == "path":            # a 16-token prompt and 0–14 new tokens
        pos = torch.tensor([15, 20, 26, 30][:b], device="cuda",
                           dtype=torch.int32)
        stamps = torch.where(stamps <= pos[:, None], stamps, -1)
    return pos, q, k, v, stamps, ks, vs


def phase_decode_attention() -> list:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel, ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, b, s, h, hkv, d, kind, fill, window, count in DECODE_SHAPES:
        pos, q, k, v, stamps, ks, vs = _decode_inputs(gen, b, s, h, hkv, d,
                                                      kind, fill, window)
        args = (pos, q, k, v, stamps, ks, vs)
        kw = dict(scale=d ** -0.5, window=window)
        got = kernel.decode_attention(*args, **kw)
        want = ref.decode_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        err = _held(f"decode_attention {name}", got, want)
        caches = [(k, v, ks, vs)] + [
            tuple(None if t is None else t.clone() for t in (k, v, ks, vs))
            for _ in range(copies_for(nbytes(k, v)) - 1)]
        ms = graph_ms([lambda c=c: kernel.decode_attention(
            pos, q, c[0], c[1], stamps, c[2], c[3], **kw) for c in caches],
            20)
        del caches
        plain = eager_ms(lambda: ref.decode_attention_ref(*args, **kw))
        # what this run's data needs: a lane with a valid slot reads only
        # its valid slots' K, V (and scales), an empty lane every slot
        ok = ref.slot_mask(pos, stamps, window)
        read = torch.where(ok.any(1), ok.sum(1), torch.full_like(pos, s))
        slots = int(read.sum())
        per_slot = hkv * d * k.element_size() * 2 + (8 * hkv if ks is not
                                                     None else 0)
        t_bound, by = bound(slots * per_slot + nbytes(pos, q, stamps),
                            nbytes(got), 4.0 * h * d * slots, "float32")
        # yardstick: SDPA on the bf16 cache (K/V heads expanded for GQA and
        # the slot mask passed where some slot is masked)
        kb = k.float() * ks[..., None] if ks is not None else k.float()
        vb = v.float() * vs[..., None] if vs is not None else v.float()
        kb = kb.to(torch.bfloat16).repeat_interleave(h // hkv, 2)
        vb = vb.to(torch.bfloat16).repeat_interleave(h // hkv, 2)
        qb = q.to(torch.bfloat16)[:, :, None]
        mask = None if bool(ok.all()) else ok[:, None, None, :]
        lib_ms = graph_ms([lambda: F.scaled_dot_product_attention(
            qb, kb.transpose(1, 2), vb.transpose(1, 2), attn_mask=mask)],
            20)
        del kb, vb
        chunk, splits = kernel.decode_plan(b, s, hkv, sms)
        rows.append(dict(shape=name, b=b, s=s, h=h, hkv=hkv, d=d,
                         cache=kind, window=window, slots_read=slots,
                         chunk=chunk, splits=splits,
                         blocks=splits * hkv * b, count=count,
                         max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=t_bound, bound_by=by,
                         library_ms=lib_ms))
        del args, k, v
    for r in rows:
        emit({"phase": "kernel_check", "kernel": "decode_attention", **r})
    return rows


# (n, m, group size, calls per decode layer; lm_head: per step)
QMM_SHAPES = {"q/k/v/wo 4096→4096": (4096, 4096, -1, 4),
              "up/gate 4096→11008": (4096, 11008, -1, 2),
              "down 11008→4096": (11008, 4096, -1, 1),
              "lm_head 4096→32000": (4096, 32000, -1, 1),
              "4096→4096 gs=128": (4096, 4096, 128, 0)}


def phase_quant_matmul(weight_bits: int) -> list:
    import torch
    from repro_torch.core.quant import QuantSpec, quantize_weights
    from repro_torch.kernels.bitplane_gemv.kernel import split_plan
    from repro_torch.kernels.bitplane_gemv.ops import _pad_axis, _pick_blocks
    from repro_torch.kernels.quant_matmul import kernel, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []

    def leaf(n, m, gs):
        w = torch.randn((n, m), generator=gen, device="cuda")
        wq = quantize_weights(w, QuantSpec(bits=weight_bits, group_size=gs))
        ops.packed_codes(wq)
        return wq

    for name, (n, m, gs, count) in QMM_SHAPES.items():
        wq = leaf(n, m, gs)
        x = torch.randn((B, n), generator=gen, device="cuda")
        bn, _ = _pick_blocks(n, m, None, None, gs if gs > 0 else None)
        a = _pad_axis(x, bn, 1).contiguous()
        scale_t = ops._expand_scales_qt(wq, bn, a.shape[1]).contiguous()
        kw = dict(q=weight_bits, zero=wq.zero, bn=bn)
        got = kernel.quant_matmul(a, wq.packed, scale_t, **kw)
        want = ref.quant_matmul_ref(a, wq.packed, scale_t, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
        if not bool(((got - want).abs() <= tol).all()):
            raise AssertionError(f"quant_matmul {name}: max|Δ| {err} "
                                 f"outside rtol/atol 1e-5")
        copies = [wq] + [leaf(n, m, gs) for _ in
                         range(copies_for(nbytes(wq.packed)) - 1)]
        ms = graph_ms([lambda c=c: kernel.quant_matmul(a, c.packed, scale_t,
                                                       **kw)
                       for c in copies], 50)
        del copies
        plain = eager_ms(lambda: ref.quant_matmul_ref(a, wq.packed, scale_t,
                                                      **kw))
        # the packed codes and the leaf's scales once, the activations
        # and the output
        t_bound, by = bound(nbytes(wq.packed, wq.scale, x), nbytes(got),
                            2.0 * B * n * m, "float32")
        wlib = [torch.randn((n, m), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
                for _ in range(copies_for(n * m * 2))]
        xb = x.to(torch.bfloat16)
        lib_ms = graph_ms([lambda w=w: torch.matmul(xb, w) for w in wlib],
                          20)
        del wlib
        plan = split_plan(a.shape[1] // bn, m, B, sms)
        rows.append(dict(shape=name, n=n, m=m, group_size=gs, count=count,
                         max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=t_bound, bound_by=by, library_ms=lib_ms,
                         tiles_per_block=plan[0], splits=plan[1]))
    for r in rows:
        emit({"phase": "kernel_check", "kernel": "quant_matmul", **r})
    return rows


# ---------------------------------------------------------------------------
# phase 6: B4 on the decode path, the int8 cache at full context
# ---------------------------------------------------------------------------

def teacher_forced(model, params, inputs) -> list:
    """The logits of every decode step of `model` fed `inputs` (B, S)
    tokens or (B, S, E) frame embeddings: the first PROMPT as the prompt,
    then one a step up to the last but one."""
    import torch
    key = "embeddings" if model.cfg.input_mode == "embeddings" else "tokens"
    steps = []
    with torch.no_grad():
        _, cache = model.prefill(params, {key: inputs[:, :PROMPT]}, CONTEXT)
        for t in range(PROMPT, inputs.shape[1] - 1):
            logits, cache = model.decode_step(params, cache, inputs[:, t], t)
            steps.append(logits)
    return steps


def greedy(model, params, prompts, new: int):
    """`ServeEngine.generate`'s greedy loop on a `Model`: (tokens, the
    logits of every decode step)."""
    import torch
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompts}, CONTEXT)
        cur = torch.argmax(logits, dim=-1)
        toks, steps = [prompts, cur[:, None]], []
        for t in range(new - 1):
            logits, cache = model.decode_step(params, cache, cur,
                                              prompts.shape[1] + t)
            steps.append(logits)
            cur = torch.argmax(logits, dim=-1)
            toks.append(cur[:, None])
    return torch.cat(toks, dim=1), steps


def attn_kernel_scan(cfg, qparams, prompts, loop_toks, loop_seen,
                     what) -> dict:
    """The token slices of `phase_attn_kernel_slice` through
    `generate(scan=True)`: a `ServeEngine` of CONTEXT slots with the int8
    cache, its model swapped for one with attention through B4
    (`scan_served`'s checks against the phase's greedy loop)."""
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, qparams, max_seq=CONTEXT, batch_slots=B,
                      quantized=True, act_bits=4, kv_bits=8, device="cuda")
    eng.model = Model(cfg, act_bits=4, impl=eng.model.impl, kv_bits=8,
                      attn_impl="kernel")
    return scan_served(eng, prompts, loop_toks, loop_seen, NEW, what)


def frames_scan(model, params, frames, loop_steps, loop_seen,
                what) -> dict:
    """A stubbed frontend's slice (frames in, `teacher_forced`) through a
    `DecodeGraph` of B lanes and the trip bucket of NEW tokens that feeds
    step t's frames from its static buffer: each step's argmax must be
    that of the loop's logits, its launches the loop's plus the extra
    steps', no plain version."""
    import torch
    from repro_torch.serve.decode_graph import DecodeGraph
    t_part = time.perf_counter()
    trip = 1 << (NEW - 2).bit_length()
    step = eager_step_counts(model, params, CONTEXT, frames[:, PROMPT])
    with torch.no_grad():
        graph = DecodeGraph(model, params,
                            model.init_cache(B, CONTEXT, "cuda"), B, trip)

    def run():
        with torch.no_grad():
            _, cache = model.prefill(
                params, {"embeddings": frames[:, :PROMPT]}, CONTEXT)
            return graph.run(
                cache, torch.zeros(B, dtype=torch.long, device="cuda"),
                PROMPT, torch.full((B,), trip, device="cuda"), 0.0,
                frames=frames[:, PROMPT:PROMPT + trip].transpose(0, 1))
    run()
    walls, toks, seen = timed_calls(lambda: run().clone())
    held_scan_counts(what, seen, loop_seen, step, trip - (NEW - 1))
    dt = statistics.median(walls)
    want = torch.stack([torch.argmax(lg, dim=-1) for lg in loop_steps])
    if not torch.equal(toks[:NEW - 1], want):
        raise AssertionError(
            f"{what}: the graph's argmax differs from the loop's at "
            f"{int((toks[:NEW - 1] != want).sum())} positions")
    return added({
        "trip": trip, "lanes": B, "capture_seconds": graph.captured.capture_s,
        "seconds": dt, "walls_s": walls, "tokens_per_s": B * NEW / dt,
        "wall_per_pass_ms": dt / NEW * 1e3, "tokens_equal_loop": True,
        "launches_equal_loop_plus_steps": trip - (NEW - 1)}, t_part)


def phase_attn_kernel_slice(cfg, qparams, inputs, name) -> dict:
    """act_bits=4 with an int8 KV cache of CONTEXT slots: `Model` on the
    quantized parameters behind `EngineLinear(MVDRAMEngine())`, decode
    attention through B4. `inputs` are the prompts (B, PROMPT), then
    decoded greedily, or for a stubbed frontend frames (B, PROMPT + NEW, E)
    fed one a step. Counts zeroed just before the run, read just after;
    then the checks of the module docstring's phase 6."""
    import torch
    from repro_torch.core.engine import EngineLinear, MVDRAMEngine
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.models.model import Model
    embeds = cfg.input_mode == "embeddings"
    mvdram = MVDRAMEngine()
    impl = EngineLinear(mvdram)
    kern = Model(cfg, act_bits=4, impl=impl, kv_bits=8, attn_impl="kernel")

    def run(new: int):
        """(the inputs fed, every decode step's logits) of `new` passes."""
        if embeds:
            x = inputs[:, :PROMPT + new]
            return x, teacher_forced(kern, qparams, x)
        return greedy(kern, qparams, inputs[:, :PROMPT], new)
    run(2)                                            # warm up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks, steps = run(NEW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    seen = counts()
    resident = resident_gb(qparams, mvdram)
    kinds = stage_kinds(cfg)       # a hybrid's shared invocations too
    per_step = len(kinds) - kinds.count("mamba")
    want = per_step * (NEW - 1)
    if seen["launches"]["decode_attention"] != want:
        raise AssertionError(f"B4 launched {seen['launches']} times, not "
                             f"{want} ({per_step} a decode step)")
    for k, v in launches_per_pass(cfg, 4).items():
        if seen["launches"][k] != v * NEW:
            raise AssertionError(f"{k} launched {seen['launches'][k]} "
                                 f"times, not {v * NEW} ({v} a pass)")
    # and a fold after each call whose plan splits the cache
    _, splits = dk.decode_plan(
        B, CONTEXT, cfg.attn.num_kv_heads,
        torch.cuda.get_device_properties(0).multi_processor_count)
    if seen["launches"]["decode_attention_fold"] != want * (splits > 1):
        raise AssertionError(f"B4's fold launched {seen['launches']} times, "
                             f"not {want * (splits > 1)} ({splits} splits)")
    held_no_copy(resident, f"{cfg.name} act_bits=4, attention through B4")
    for k in ("gemv_bs", "gemv_bs_fold", "program_gemv",
              "program_gemv_fold"):
        if seen["launches"][k] <= 0:
            raise AssertionError(f"{k} never launched ({seen})")
    if any(seen["plain"].values()):
        raise AssertionError(f"a plain version ran on the card ({seen})")
    if not embeds and not torch.equal(toks[:, :PROMPT], inputs):
        raise AssertionError("prompt tokens not echoed")
    scan = (frames_scan(kern, qparams, inputs, steps, seen, name) if embeds
            else attn_kernel_scan(cfg, qparams, inputs, toks, seen, name))
    # B4 against its plain version at every layer of every step, on the
    # path's own inputs (a replay, after the counts were read)
    real, held = dops.decode_attention, []

    def checked(*args, impl="kernel", **kw):
        got = real(*args, impl=impl, **kw)
        held.append(_held("decode_attention on the path", got,
                          real(*args, impl="reference", **kw)))
        return got

    dops.decode_attention = checked
    try:
        teacher_forced(kern, qparams, toks)
    finally:
        dops.decode_attention = real
    if len(held) != want:
        raise AssertionError(f"{len(held)} B4 calls held on the replay, "
                             f"not {want}")
    # logits against the same model on attn_impl="sdpa" (the cache widened
    # to bf16 where B4 widens it to f32), fed the same inputs. With 4-bit
    # activations they are reported only: the quantizer's absmax tie turns
    # any last-bit difference into a different code, and a one-ulp change of
    # a few cache entries moves these logits by a third of their size
    # (PERF.md §6). With float activations (B3 in every linear) they
    # are held to 5 % of max|logit|, the rule of PERF.md §2; with Mamba2
    # stages with float32 activations between the layers, where bf16 ones
    # are chaotic (`ssm_float_check`).
    fcfg = dataclasses.replace(cfg, dtype="float32") if cfg.ssm else cfg
    runs = [("act_bits_4", 4, cfg), ("act_bits_None", None, fcfg)]
    if cfg.ssm:                     # reported only: chaotic in bf16
        runs.append(("act_bits_None_bf16", None, cfg))
    spread = {}
    for key, ab, c in runs:
        got = steps if ab == 4 else teacher_forced(
            Model(c, act_bits=None, impl=impl, kv_bits=8,
                  attn_impl="kernel"), qparams, toks)
        want_l = teacher_forced(Model(c, act_bits=ab, impl=impl, kv_bits=8),
                                qparams, toks)
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"{key}: non-finite logits")
        spread[key] = {
            "max_abs_err": [float((g - w).abs().max())
                            for g, w in zip(got, want_l)],
            "max_abs_logit": max(float(w.abs().max()) for w in want_l)}
    torch.cuda.synchronize()
    sf = spread["act_bits_None"]
    if max(sf["max_abs_err"]) > LOGIT_RTOL * sf["max_abs_logit"]:
        raise AssertionError(f"act_bits=None: B4 decode logits differ from "
                             f"sdpa's ({sf})")
    out = {"phase": name, "inputs": "embeddings" if embeds else "tokens",
           "inputs_shape": list(toks.shape), "seconds": dt,
           "tokens_per_s": B * NEW / dt, "wall_per_pass_ms": dt / NEW * 1e3,
           "scan": scan, **seen, "resident": resident, "kv_slots": CONTEXT,
           "b4_calls_per_decode_step": per_step,
           "b4_vs_plain_on_path": {"calls": len(held),
                                   "max_abs_err": max(held)},
           **{f"decode_logits_vs_sdpa_{k}": v for k, v in spread.items()},
           "act_bits_None_activations": fcfg.dtype}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 7: where a forward pass's device time goes, from a profiler trace
# ---------------------------------------------------------------------------

def phase_profile(cfg, qparams) -> dict:
    """`profile_decode` at full width on the slices' weights, with float
    activations (B3 in every linear) and with act_bits=4 (B1 and B2)."""
    import torch
    from repro_torch.launch.profile_decode import profile
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    # half the slices' new tokens: the profiler's event processing, not
    # the run, takes most of this phase's time
    runs = [profile(cfg, qparams, act_bits=ab, batch=B, prompt_len=PROMPT,
                    tokens=NEW // 2, gen=gen) for ab in (None, 4)]
    for r in runs:
        if not r["top_kernels"] or r["device_kernel_s"] <= 0:
            raise AssertionError(f"profile at act_bits={r['act_bits']} saw "
                                 f"no device time")
    out = {"phase": "profile_decode", "runs": runs}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phases 7a and 16a: continuous batching
# ---------------------------------------------------------------------------

# the batcher phases' traffic: 8 requests over the B lanes, submitted at
# once (so lanes recycle mid-run), prompts streamed in chunks of 8
BATCH_PROMPTS = (5, 9, 12, 16, 20, 24, 28, 32)
BATCH_NEW = (16, 4, 12, 8, 16, 6, 10, 5)
BATCH_CHUNK = 8
BATCH_MAX_SEQ = 64         # the horizon of the phases without B4


def batcher_requests(cfg) -> list:
    """(prompt, max_new) of the batcher traffic, tokens from seed 0."""
    import torch
    gen = torch.Generator().manual_seed(SEED)
    return [(torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist(),
             m) for n, m in zip(BATCH_PROMPTS, BATCH_NEW)]


def batcher(eng, reqs, rids=None, scan=False):
    """A fresh `ContinuousBatcher` on `eng` with the requests `rids` (all
    by default) submitted: the per-step tick, or with `scan` the graph
    tick."""
    from repro_torch.serve import ContinuousBatcher, Request
    b = ContinuousBatcher(eng.cfg, None, engine=eng,
                          prefill_chunk=BATCH_CHUNK, scan=scan)
    for i, (p, m) in enumerate(reqs):
        if rids is None or i in rids:
            b.submit(Request(rid=i, prompt=p, max_new=m))
    return b


def lane_rows(cache, lanes) -> dict:
    """Copies of the lanes' rows of every cache leaf, by (lane, path)."""
    from repro_torch.serve.engine import cache_leaves
    return {(i, path): leaf.select(axis, i).clone() for i in lanes
            for path, leaf, axis, _ in cache_leaves(cache)}


def held_rows(what, cache, rows) -> int:
    """Fails unless every row of `rows` is bitwise what `cache` holds."""
    import torch
    now = lane_rows(cache, sorted({i for i, _ in rows}))
    for key, want in rows.items():
        if not torch.equal(now[key], want):
            raise AssertionError(f"{what}: lane {key[0]}'s {key[1]} moved "
                                 f"while it was frozen")
    return len(rows)


def checked_tick(b, replay_b4: bool) -> dict:
    """One tick of `b` in which each lane frozen at a step is held to keep
    every cache leaf bitwise across that step, and (`replay_b4`) each B4
    call is held against its plain version on the same inputs."""
    from repro_torch.kernels.decode_attention import ops as dops
    real_step, real_b4 = b._step, dops.decode_attention
    seen = {"frozen_lane_steps": 0, "leaf_rows_held": 0, "b4": []}

    def step(tok, pos, frozen):
        rows = lane_rows(b.cache, frozen)
        logits = real_step(tok, pos, frozen)
        seen["leaf_rows_held"] += held_rows("frozen step", b.cache, rows)
        seen["frozen_lane_steps"] += len(frozen)
        return logits

    def b4(*args, impl="kernel", **kw):
        got = real_b4(*args, impl=impl, **kw)
        seen["b4"].append(_held("decode_attention in a batcher tick", got,
                                real_b4(*args, impl="reference", **kw)))
        return got

    b._step = step
    if replay_b4:
        dops.decode_attention = b4
    try:
        b.tick()
    finally:
        del b._step                     # the class's method again
        dops.decode_attention = real_b4
    return seen


def same_cache(a, b) -> bool:
    from repro_torch.serve.engine import cache_leaves
    import torch
    return all(torch.equal(x, y) for (_, x, *_), (_, y, *_) in
               zip(cache_leaves(a), cache_leaves(b)))


def graph_ticks(eng, reqs, out, want_for, what) -> dict:
    """The requests through the graph tick (`scan=True`, every trip
    bucket captured first) beside the per-step tick, tick by tick: the
    cache bitwise the loop's after every tick, the outputs the loop run's,
    the graph ticks' launches (counted around each) exactly `want_for`
    their decode steps, no plain version. Each graph tick is timed between
    synchronizations."""
    import collections
    import torch
    t_part = time.perf_counter()
    loop, graph = batcher(eng, reqs), batcher(eng, reqs, scan=True)
    capture = graph.capture_graphs()
    seen = {"launches": collections.Counter(),
            "plain": collections.Counter()}
    wall, ticks = 0.0, 0
    while graph.pending or graph.in_flight:
        loop.tick()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.tick()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        for k, v in counts().items():
            seen[k].update(v)
        ticks += 1
        if not same_cache(graph.cache, loop.cache):
            raise AssertionError(f"{what}: the graph tick's cache differs "
                                 f"from the loop tick's after tick {ticks}")
    if loop.pending or loop.in_flight or loop.ticks != ticks:
        raise AssertionError(f"{what}: the loop took {loop.ticks} ticks, "
                             f"the graph {ticks}")
    for b in (graph, loop):
        if {r.rid: r.out for r in b.finished} != out:
            raise AssertionError(f"{what}: {'graph' if b.scan else 'loop'} "
                                 f"tick outputs differ from the run's")
    for k, v in want_for(graph.decode_steps).items():
        if seen["launches"][k] != v:
            raise AssertionError(f"{what}, graph tick: {k} launched "
                                 f"{seen['launches'][k]} times, not {v}")
    if any(seen["plain"].values()):
        raise AssertionError(f"{what}, graph tick: a plain version ran")
    return added({
        "buckets": sorted(graph.tick_graphs), "capture_seconds": capture,
        "ticks": ticks, "decode_steps": graph.decode_steps,
        "tokens_out": graph.tokens_out, "seconds": wall,
        "tokens_per_s": graph.tokens_out / wall,
        "wall_per_tick_ms": wall / ticks * 1e3,
        "caches_bitwise_loop_ticks": ticks, "outputs_equal_loop": True},
        t_part)


def step_ms(b) -> dict:
    """Wall of one decode step (synchronized, the median of 6 taken in
    turns): `Model.decode_step` alone at one int position, as
    `ServeEngine.generate` calls it; the batcher's `_step` with no lane
    frozen; and with every lane frozen, the undo log at its largest. The
    steps write b's cache, which is thrown away after."""
    import statistics
    import torch
    tok = torch.zeros(B, dtype=torch.long, device=b.device)
    pos = torch.full((B,), b.max_seq - 1, dtype=torch.long, device=b.device)
    runs = {
        "decode_step_ms": lambda: b.model.decode_step(
            b.params, b.cache, tok, b.max_seq - 1),
        "batcher_step_ms_no_lane_frozen": lambda: b._step(tok, pos, ()),
        "batcher_step_ms_every_lane_frozen": lambda: b._step(
            tok, pos, tuple(range(B)))}
    times = {k: [] for k in runs}
    with torch.no_grad():
        for _ in range(6):
            for k, run in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def phase_batcher(cfg, qparams, name, max_seq=BATCH_MAX_SEQ,
                  attn_kernel=False, must_run=(), dimms=1,
                  masks_out=None) -> dict:
    """`ContinuousBatcher` at act_bits=4 on `ServeEngine(quantized=True)`
    (with `attn_kernel`: an int8 cache, the engine's model swapped for one
    with `attn_impl="kernel"`, attention through B4). The counts are zeroed
    just before `run()` and read just after: every launch count exact per
    decode step, no plain version. Then: every request done with max_new
    tokens; the shortest, the longest and the first request admitted into
    a recycled lane each equal to serving it alone in a fresh batcher;
    one tick with every frozen lane's rows held bitwise at each step (and
    each B4 call against its plain version), and a whole tick of a free
    lane that holds its last request's state. With `dimms` > 1 the engine
    serves from a fabric of that many DIMMs, and the batcher's priced DDR4
    clock must equal its program ticks priced one by one in the order they
    ran. `masks_out` (a list) receives every program tick's lane mask, in
    order."""
    import collections
    import torch
    import warnings
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine
    kv_bits = 8 if attn_kernel else None
    eng = ServeEngine(cfg, qparams, max_seq=max_seq, batch_slots=B,
                      quantized=True, act_bits=4, kv_bits=kv_bits,
                      device="cuda", dimms=dimms)
    if dimms > 1 and eng.decode_program is None:
        raise AssertionError(f"{name}: no resident program on {dimms} "
                             f"DIMMs")
    if attn_kernel:
        eng.model = Model(cfg, act_bits=4, impl=eng.model.impl,
                          kv_bits=kv_bits, attn_impl="kernel")
    reqs = batcher_requests(cfg)
    warm = batcher(eng, [(reqs[0][0], 2)])      # packs B2's member tables
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b = batcher(eng, reqs)
    occs = []                    # each program tick's occupancy, in order
    real_account = b._account_program

    def account(steps):
        occs.extend(int(m.sum()) for m in b.tick_masks(steps))
        if masks_out is not None:
            masks_out.extend(b.tick_masks(steps))
        real_account(steps)
    b._account_program = account
    reset_counts()
    # every wait of the host on the device in the run, as the sync debug
    # mode reports it (the batcher reads the next tokens once a tick)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            done = b.run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    seen = counts()
    del b._account_program
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    if sorted(r.rid for r in done) != list(range(len(reqs))) or not all(
            r.done and len(r.out) == reqs[r.rid][1] for r in done):
        raise AssertionError(f"{name}: requests not served in full "
                             f"{[(r.rid, r.done, len(r.out)) for r in done]}")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.out):
        raise AssertionError(f"{name}: tokens outside the vocabulary")
    per_step = 0
    if attn_kernel:
        kinds = stage_kinds(cfg)
        per_step = len(kinds) - kinds.count("mamba")
        _, splits = dk.decode_plan(
            B, max_seq, cfg.attn.num_kv_heads,
            torch.cuda.get_device_properties(0).multi_processor_count)

    def want_for(steps: int) -> dict:
        want = {k: v * steps for k, v in launches_per_pass(cfg, 4).items()}
        if attn_kernel:
            want["decode_attention"] = per_step * steps
            want["decode_attention_fold"] = per_step * steps * (splits > 1)
        return want
    want = want_for(b.decode_steps)
    for k, v in want.items():
        if seen["launches"][k] != v:
            raise AssertionError(f"{name}: {k} launched "
                                 f"{seen['launches'][k]} times, not {v} "
                                 f"({b.decode_steps} decode steps)")
    for k in must_run:
        if seen["launches"][k] <= 0:
            raise AssertionError(f"{name}: {k} never launched ({seen})")
    if any(seen["plain"].values()):
        raise AssertionError(f"{name}: a plain version ran on the card "
                             f"({seen})")
    stats = {
        "ticks": b.ticks, "program_ticks": b.program_ticks,
        "decode_steps": b.decode_steps,
        "occupancy_ticks": {str(k): v for k, v in
                            sorted(b.occupancy_ticks.items())},
        "tokens_out": b.tokens_out, "seconds": dt,
        "tokens_per_s": b.tokens_out / dt,
        "wall_per_tick_ms": dt / b.ticks * 1e3,
        "wall_per_decode_step_ms": dt / b.decode_steps * 1e3,
        "host_syncs_per_tick": syncs / b.ticks,
        "sim_time_s": b.sim_time_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "allocated_gb": torch.cuda.memory_allocated() / 1e9}
    if collections.Counter(occs) != b.occupancy_ticks:
        raise AssertionError(f"{name}: recorded occupancies {occs} do not "
                             f"add up to {b.occupancy_ticks}")
    if eng.decode_program is not None:
        # the priced clock (DDR4 model seconds, not the card's): the ticks
        # priced one by one in the order they ran, and grouped by
        # occupancy (another order of the same float additions)
        clock = 0.0
        for occ in occs:
            clock += eng.decode_tick_cost_s(occ)
        grouped = sum(eng.decode_tick_cost_s(k) * v
                      for k, v in b.occupancy_ticks.items())
        if b.sim_time_s != clock or not clock > 0:
            raise AssertionError(f"{name}: sim_time_s {b.sim_time_s} != "
                                 f"its priced ticks {clock}")
        stats |= {
            "dimms": dimms, "priced_clock": "DDR4 model, not the card",
            "sim_time_s_by_occupancy": grouped,
            "tick_cost_s": {str(k): eng.decode_tick_cost_s(k)
                            for k in sorted(b.occupancy_ticks)},
            "first_token_s": {r.rid: r.first_token_s for r in done},
            "finish_s": {r.rid: r.finish_s for r in done}}
    out = {r.rid: r.out for r in done}
    # interleaved equals solo: the shortest and the longest prompt, and
    # the first request admitted into a recycled lane (rid B)
    solo = {}
    for rid in sorted({BATCH_PROMPTS.index(min(BATCH_PROMPTS)),
                       BATCH_PROMPTS.index(max(BATCH_PROMPTS)), B}):
        (alone,) = batcher(eng, reqs, {rid}).run()
        solo[rid] = alone.out
        if alone.out != out[rid]:
            raise AssertionError(f"{name}: request {rid} served alone gave "
                                 f"{alone.out}, interleaved {out[rid]}")
    del b
    # frozen lanes: tick 1 of the first B requests has lanes frozen inside
    # the others' prefill chunks; then, once one lane is free (holding its
    # request's state), a whole tick of it
    c = batcher(eng, reqs, set(range(B)))
    c.tick()
    steps_before = c.decode_steps
    step_check = checked_tick(c, attn_kernel)
    tick_steps = c.decode_steps - steps_before
    if not step_check["frozen_lane_steps"]:
        raise AssertionError(f"{name}: no lane frozen in the checked tick")
    if attn_kernel and len(step_check["b4"]) != per_step * tick_steps:
        raise AssertionError(f"{name}: {len(step_check['b4'])} B4 calls "
                             f"held in the tick, not {per_step} a step")
    while all(not lane.free for lane in c.lanes):
        c.tick()
    free = [i for i, lane in enumerate(c.lanes) if lane.free]
    rows = lane_rows(c.cache, free)
    c.tick()
    tick_rows = held_rows(f"{name}: a free lane's tick", c.cache, rows)
    stats |= step_ms(c)
    del c
    stats["graph_tick"] = graph_ticks(eng, reqs, out, want_for, name)
    torch.cuda.synchronize()
    line = {
        "phase": name, "card": nvidia_smi(), "lanes": B,
        "requests": len(reqs), "prompt_lens": list(BATCH_PROMPTS),
        "max_new": list(BATCH_NEW), "prefill_chunk": BATCH_CHUNK,
        "max_seq": max_seq, "kv_bits": kv_bits,
        "attn_impl": eng.model.attn_impl, **stats, **seen,
        "interleaved_equals_solo": sorted(solo),
        "frozen_check": {
            "tick_frozen_lane_steps": step_check["frozen_lane_steps"],
            "tick_leaf_rows_held": step_check["leaf_rows_held"],
            "free_lanes_held_a_whole_tick": free,
            "free_lane_leaf_rows_held": tick_rows},
        "b4_vs_plain_in_tick": {
            "calls": len(step_check["b4"]),
            "max_abs_err": max(step_check["b4"])} if attn_kernel else None}
    emit(line)
    return line


# ---------------------------------------------------------------------------
# phase 8: the baseline, every linear a QuantizedTensor through B5
# ---------------------------------------------------------------------------

def quantized_tensor_params(params, bits: int):
    """Every GeMV leaf (the port's QUANT_LEAF_NAMES) as a q-bit
    QuantizedTensor, quantized matrix by matrix and stacked, its codes
    packed once; the float leaf is dropped as soon as it is quantized."""
    import torch
    from repro_torch.core.quant import (QuantizedTensor, QuantSpec,
                                        quantize_weights)
    from repro_torch.kernels.quant_matmul import ops
    from repro_torch.serve.quantize import QUANT_LEAF_NAMES
    spec = QuantSpec(bits=bits)

    def leaf(w):
        if w.ndim == 2:
            qt = quantize_weights(w, spec)
        else:
            parts = [quantize_weights(w[i], spec) for i in range(len(w))]
            qt = QuantizedTensor(
                values=torch.stack([p.values for p in parts]),
                scale=torch.stack([p.scale for p in parts]),
                zero=parts[0].zero, spec=spec,
                col_sum=torch.stack([p.col_sum for p in parts]))
        ops.packed_codes(qt)
        return qt

    def walk(tree):
        for k in list(tree):
            if isinstance(tree[k], dict):
                walk(tree[k])
            elif k in QUANT_LEAF_NAMES and tree[k].ndim >= 2:
                tree[k] = leaf(tree.pop(k))
        return tree

    return walk(params)


def phase_baseline_slice(cfg, prompts) -> dict:
    import torch
    from repro_torch.models.model import param_defs
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import ServeEngine
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)  # the same model
    qt = quantized_tensor_params(init_params(param_defs(cfg), gen, "cuda"),
                                 cfg.weight_bits)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    eng = ServeEngine(cfg, qt, max_seq=PROMPT + NEW + 1, batch_slots=B,
                      device="cuda")
    eng.generate(prompts[:, :4], max_new=2, scan=False)  # warm up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks = eng.generate(prompts, max_new=NEW, scan=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    seen = counts()
    per_pass = 7 * cfg.num_layers + 1
    if seen["launches"]["quant_matmul"] != per_pass * NEW:
        raise AssertionError(f"B5 launched {seen['launches']} times, not "
                             f"{per_pass} a forward pass")
    if seen["launches"]["quant_matmul_fold"] <= 0:
        raise AssertionError(f"B5's fold never launched ({seen})")
    if any(seen["plain"].values()):
        raise AssertionError(f"a plain version ran on the card ({seen})")
    if not torch.equal(toks[:, :PROMPT], prompts):
        raise AssertionError("prompt tokens not echoed")
    with torch.no_grad():
        got, _ = eng.model.prefill(eng.params, {"tokens": prompts},
                                   eng.max_seq)
        ref_eng = ServeEngine(cfg, qt, max_seq=PROMPT + NEW + 1,
                              batch_slots=B, impl="reference",
                              device="cuda")
        want, _ = ref_eng.model.prefill(ref_eng.params,
                                        {"tokens": prompts}, eng.max_seq)
    torch.cuda.synchronize()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if not bool(torch.isfinite(got).all()) or err > LOGIT_RTOL * scale:
        raise AssertionError(f"B5 prefill logits differ from the plain "
                             f"versions' (max|Δ| {err}, max|logit| {scale})")
    scan = scan_served(eng, prompts, toks, seen, NEW,
                       f"{cfg.name} baseline")
    out = {"phase": "slice_baseline_quant_matmul",
           "tokens_shape": list(toks.shape), "seconds": dt,
           "tokens_per_s": B * NEW / dt,
           "wall_per_pass_ms": dt / NEW * 1e3, "scan": scan, **seen,
           "setup_seconds": setup,
           "allocated_gb": torch.cuda.memory_allocated() / 1e9,
           "prefill_logits_max_abs_err_vs_plain": err,
           "max_abs_logit": scale}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phases 8a-8d: training on the card, train-then-serve, the column shards
# ---------------------------------------------------------------------------

# llama2-7b at full width cut to 8 of its 32 layers: the whole model's
# float32 params, gradients and AdamW moments (about 108 GB) outgrow the
# card's 80 GB; 8 layers hold 1.881 G params, about 34 GB before
# activations
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 8, 512, 2
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 8, 1e-3, 2
REPLAY_STEPS = 3
MICRO_RTOL = 2e-2          # k=2 against k=1 gradients, relative L2 a leaf
RECOVERY_STEPS, RECOVERY_CKPT_EVERY, RECOVERY_FAIL_AT = 3, 2, 2
SERVE_NEW = 8              # greedy tokens of the train-then-serve slice
SHARD_DIMMS = 8
SHARD_SHAPES = {"down": (11008, 4096), "lm_head": (4096, 32000)}
SHARDED_LAYERS, SHARDED_STEPS = 2, 3
COMPRESS_SHAPE = (11008, 4096)   # one gradient leaf (`down`) of llama2-7b
DRYRUN_CELLS = ("train_4k", "decode_32k")


@contextlib.contextmanager
def deterministic():
    """`torch.use_deterministic_algorithms(True)` over the training phases,
    the setting before restored after them, so no serving phase runs under
    it. The mode also fills every `torch.empty` with NaN; that is turned
    off here (every kernel of the path writes its output whole, and the
    replay checks would show one that does not)."""
    import torch
    import torch.utils.deterministic as det
    prev = (torch.are_deterministic_algorithms_enabled(),
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0])
        det.fill_uninitialized_memory = prev[1]


def train_config(layers: int):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama2-7b"), num_layers=layers)


def trainer(cfg, mesh=None, **tkw):
    """The phase's `Trainer`: the global batch in TRAIN_MICRO strided
    microbatches, bf16 compute, bf16-compressed gradients (the default),
    AdamW with a short warmup over TRAIN_STEPS, params from the seed on
    the card; sharded over `mesh` when one is given."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import Trainer, TrainerConfig
    return Trainer(cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                                    total_steps=TRAIN_STEPS),
                   TrainerConfig(num_microbatches=TRAIN_MICRO, seed=SEED,
                                 **tkw),
                   mesh=mesh, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                   device="cuda")


def same_trees(a, b) -> bool:
    from repro_torch.optim.adamw import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch_equal(x, y)
                                      for x, y in zip(la, lb))


def torch_equal(x, y) -> bool:
    import torch
    return x.dtype == y.dtype and torch.equal(x, y)


def train_bound(cfg, tokens: int, seq: int, n_params: int) -> dict:
    """The least time of one step (ms): the bf16 products (6·N·T over the
    linears' N params and T tokens) at 989 TFLOP/s, the float32 einsum
    attention (full S×S scores: QKᵀ and PV, forward and twice that
    backward, 12·T·S·H·D a layer) at 67 TFLOP/s, and AdamW's bytes
    (read the bf16 gradient; read and write m, v and the float32 param:
    26 B a param) at the memory rate."""
    e, a, layers = cfg.d_model, cfg.attn, cfg.num_layers
    linear = layers * (2 * e * a.num_heads * a.head_dim
                       + 2 * e * a.num_kv_heads * a.head_dim
                       + 3 * e * cfg.d_ff) + e * cfg.vocab_size
    mm_ops = 6 * linear * tokens
    attn_ops = 12 * tokens * seq * a.num_heads * a.head_dim * layers
    opt_bytes = 26 * n_params
    terms = {"bf16_products_ms": mm_ops / PEAK_OPS_S["bfloat16"] * 1e3,
             "f32_attention_ms": attn_ops / PEAK_OPS_S["float32"] * 1e3,
             "adamw_bytes_ms": opt_bytes / HBM_BYTES_S * 1e3}
    return {"bound_ms": sum(terms.values()), **terms,
            "linear_params": linear, "bf16_tflop": mm_ops / 1e12,
            "f32_attention_tflop": attn_ops / 1e12,
            "adamw_gb": opt_bytes / 1e9}


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_train():
    """llama2-7b at full width, TRAIN_LAYERS of its layers, trained on
    the card through `Trainer.run` (the port's own data stream). Holds:
    every loss finite and the last below the first; the first
    REPLAY_STEPS steps run twice from the seed bitwise equal; one step
    with layer-level remat (`Model(remat=True)`) bitwise the same step
    without it; the k=2 microbatch gradients within MICRO_RTOL (relative
    L2 a leaf) of one k=1 batch. Reports the loss and grad norm of every
    step, seconds per step (median of steps 2–8), tokens/s, peak and
    resident GB, the step's bound and the share of it reached, and one
    step's gradient, compression and AdamW seconds apart. Returns (the
    line, the config, the trained params quantized to q2, prompts from
    the data stream)."""
    import statistics
    import torch
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params, init_params
    from repro_torch.optim.adamw import adamw_update, tree_leaves
    from repro_torch.parallel.compress import compress_tree_for_sync
    from repro_torch.serve.quantize import quantize_params
    from repro_torch.train.step import accumulate_grads
    t_phase = time.perf_counter()
    cfg = train_config(TRAIN_LAYERS)
    tr = trainer(cfg)
    n_params = count_params(tr.defs)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"phase": "train_llama2_7b", "card": nvidia_smi(),
           "config": cfg.name, "layers": cfg.num_layers,
           "depth_cut": {"layers": 32, "trained": TRAIN_LAYERS},
           "d_model": cfg.d_model, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "params": n_params, "dtype": cfg.dtype,
           "global_batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "microbatches": TRAIN_MICRO, "compress_grads": True,
           "lr": TRAIN_LR, "warmup_steps": TRAIN_WARMUP,
           "steps": TRAIN_STEPS,
           "allocated_before_gb": torch.cuda.memory_allocated() / 1e9,
           **train_bound(cfg, tokens, TRAIN_SEQ, n_params)}
    with deterministic():
        # bitwise replay of the first steps from the seed
        first, _, _ = trainer(cfg).run(REPLAY_STEPS)
        second, _, _ = trainer(cfg).run(REPLAY_STEPS)
        if not same_trees(first, second):
            raise AssertionError(f"train: {REPLAY_STEPS} steps replayed "
                                 f"from the seed differ")
        del first, second
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        (params, opt_state, hist), run_s = _timed(
            lambda: tr.run(TRAIN_STEPS, log_every=1))
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["resident_gb"] = torch.cuda.memory_allocated() / 1e9
        del opt_state
        losses = [h["loss"] for h in hist]
        secs = [h["sec_per_step"] for h in hist]
        med = statistics.median(secs[1:])
        out |= {"losses": losses,
                "grad_norms": [h["grad_norm"] for h in hist],
                "sec_per_step": secs, "sec_per_step_median_2_8": med,
                "tokens_per_s": tokens / med,
                "share_of_bound": out["bound_ms"] / 1e3 / med,
                "run_s": run_s, "stragglers": tr.straggler_events}
        if len(losses) != TRAIN_STEPS or not all(
                math.isfinite(x) for x in losses):
            raise AssertionError(f"train: losses {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train: the loss did not fall {losses}")
        qparams = quantize_params(params, cfg.weight_bits)
        del params
        torch.cuda.empty_cache()
        prompts = tr.data.batch_at(TRAIN_STEPS, device="cuda")["tokens"][
            :B, :PROMPT].to(torch.int64)

        # one step with and without layer-level remat, from the seed's
        # state: the same params bitwise; the parts of the plain one timed
        batch = tr.data.batch_at(0, device="cuda")
        stepped, remat = {}, {}
        for on in (False, True):
            _, p, s = tr.init_state()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            model = Model(cfg, remat=on)
            (g, _), g_s = _timed(lambda: accumulate_grads(
                model, p, batch, TRAIN_MICRO))
            g, c_s = _timed(lambda: compress_tree_for_sync(g))
            _, a_s = _timed(lambda: adamw_update(g, s, p, tr.opt))
            del g, s
            peak = torch.cuda.max_memory_allocated()
            remat[str(on)] = {"peak_gb": peak / 1e9,
                              "peak_above_start_gb": (peak - base) / 1e9,
                              "grads_s": g_s, "compress_s": c_s,
                              "adamw_s": a_s}
            stepped[on] = p
            del p
        remat_bitwise = same_trees(stepped[False], stepped[True])
        del stepped
        torch.cuda.empty_cache()
        out["remat"] = {"bitwise": remat_bitwise, **remat}
        if not remat_bitwise:
            raise AssertionError("train: the step with remat differs")

        # k=2 microbatches against one batch, gradients on the seed's params
        p = init_params(tr.defs, torch.Generator(device="cuda").manual_seed(
            SEED), "cuda")
        model = Model(cfg)
        g1, _ = accumulate_grads(model, p, batch, 1)
        g2, _ = accumulate_grads(model, p, batch, TRAIN_MICRO)
        rel = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                  for a, b in zip(tree_leaves(g2), tree_leaves(g1)))
        out["microbatch_grads"] = {
            "k": [1, TRAIN_MICRO], "max_rel_l2_a_leaf": rel,
            "tolerance": MICRO_RTOL,
            "grad_norm_k1": float(torch.stack(
                [x.norm() for x in tree_leaves(g1)]).norm()),
            "grad_norm_k2": float(torch.stack(
                [x.norm() for x in tree_leaves(g2)]).norm())}
        del g1
        if not rel <= MICRO_RTOL:
            raise AssertionError(f"train: k={TRAIN_MICRO} gradients off k=1 "
                                 f"by {rel} (relative L2)")
    # the same gradients with the deterministic mode off: reported, not
    # held (does this path need the mode to replay bitwise?)
    g_off, _ = accumulate_grads(model, p, batch, TRAIN_MICRO)
    out["k2_grads_bitwise_with_the_mode_off"] = same_trees(g_off, g2)
    del p, g2, g_off
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out, cfg, qparams, prompts


def phase_train_recovery() -> dict:
    """llama2-7b at full width, one layer (464.6 M params): an
    uninterrupted run of RECOVERY_STEPS steps against one with a
    checkpoint every RECOVERY_CKPT_EVERY steps (async saves) and a
    `SimulatedFailure` before step RECOVERY_FAIL_AT: after restoring the
    latest commit and replaying, params and AdamW state bitwise equal.
    Reports GB written, seconds to snapshot, to finish the writes and to
    restore; the checkpoints live in a temporary directory removed
    afterwards. A full disk fails the run."""
    import shutil
    import tempfile
    import torch
    from repro_torch.models.params import count_params
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import SimulatedFailure
    t_phase = time.perf_counter()
    cfg = train_config(1)
    tmp = tempfile.mkdtemp(prefix="train_recovery_")
    timed = {"save_snapshot_s": [], "save_wait_s": [], "restore_s": []}
    real = (ckpt.save_checkpoint, ckpt.wait_for_saves,
            ckpt.restore_checkpoint)

    def clocked(key, fn):
        def call(*args, **kw):
            r, dt = _timed(lambda: fn(*args, **kw))
            timed[key].append(dt)
            return r
        return call

    fail = {RECOVERY_FAIL_AT}

    def hook(step):
        if step in fail:
            fail.discard(step)
            raise SimulatedFailure(f"injected before step {step}")
    out = {"phase": "train_recovery_llama2_7b", "card": nvidia_smi(),
           "layers": cfg.num_layers, "steps": RECOVERY_STEPS,
           "ckpt_every": RECOVERY_CKPT_EVERY, "failure_at": RECOVERY_FAIL_AT,
           "disk_free_gb": shutil.disk_usage(tmp).free / 1e9}
    try:
        with deterministic():
            clean = trainer(cfg)
            p_clean, s_clean, _ = clean.run(RECOVERY_STEPS)
            out["params"] = count_params(clean.defs)
            faulty = trainer(cfg, ckpt_dir=tmp,
                             ckpt_every=RECOVERY_CKPT_EVERY)
            faulty.failure_hook = hook
            ckpt.save_checkpoint = clocked("save_snapshot_s", real[0])
            ckpt.wait_for_saves = clocked("save_wait_s", real[1])
            ckpt.restore_checkpoint = clocked("restore_s", real[2])
            try:
                p_faulty, s_faulty, _ = faulty.run(RECOVERY_STEPS)
            finally:
                (ckpt.save_checkpoint, ckpt.wait_for_saves,
                 ckpt.restore_checkpoint) = real
        if faulty.recoveries != 1:
            raise AssertionError(f"recovery: {faulty.recoveries} recoveries")
        bitwise = same_trees({"p": p_clean, "s": s_clean},
                             {"p": p_faulty, "s": s_faulty})
        if not bitwise:
            raise AssertionError("recovery: params or AdamW state differ "
                                 "from the uninterrupted run's")
        sizes = {name: sum(os.path.getsize(os.path.join(tmp, name, f))
                           for f in os.listdir(os.path.join(tmp, name)))
                 for name in sorted(os.listdir(tmp))}
        out |= {"bitwise": bitwise, "recoveries": faulty.recoveries,
                "checkpoints": {k: v / 1e9 for k, v in sizes.items()},
                "gb_written": sum(sizes.values()) / 1e9, **timed,
                "latest": os.path.basename(ckpt.latest_checkpoint(tmp))}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del p_clean, s_clean, p_faulty, s_faulty
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def phase_train_to_serve(cfg, qparams, prompts) -> dict:
    """The trained params quantized to q2 and served through
    `ServeEngine(quantized=True, act_bits=4)`: 4 lanes, 16-token prompts
    from the data stream, SERVE_NEW greedy tokens. B1 and B2 (and their
    folds) must run, every launch count exact, no plain version; a replay
    holds every B1 and B2 call bitwise against its plain version; the
    prefill logits bitwise those of the plain versions. Reports how many
    generated tokens follow the data's recurrence (5·t + 17 + ε, ε ∈
    {0, 1, 2}, mod vocab)."""
    import torch
    t_phase = time.perf_counter()
    want = {k: v * SERVE_NEW for k, v in launches_per_pass(cfg, 4).items()}
    eng, toks, fields = served(cfg, qparams, prompts, 4,
                               ("gemv_bs", "gemv_bs_fold", "program_gemv",
                                "program_gemv_fold"), want, new=SERVE_NEW)
    held = held_on_path(eng, prompts, new=SERVE_NEW)
    for k in ("gemv_bs", "program_gemv"):
        if held[k]["calls"] <= 0:
            raise AssertionError(f"train-to-serve: no {k} call held")
    with torch.no_grad():
        got, _ = eng.model.prefill(eng.params, {"tokens": prompts},
                                   eng.max_seq)
    plain = prefill_logits(cfg, qparams, prompts, 4, "reference")
    if not torch.equal(got, plain):
        raise AssertionError("train-to-serve: kernel prefill logits != "
                             "plain logits")
    t = toks.to(torch.int64)
    eps = (t[:, PROMPT:] - 5 * t[:, PROMPT - 1:-1] - 17) % cfg.vocab_size
    out = {"phase": "train_to_serve_llama2_7b", **fields,
           "held_on_path": held,
           "recurrence_hits": int((eps <= 2).sum()),
           "generated": int(eps.numel()),
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


def phase_column_shards() -> dict:
    """llama2-7b's `down` (11008→4096) and `lm_head` (4096→32000) at full
    width, q2 weights, 4-bit activations, each registered column-sharded
    over a fresh SHARD_DIMMS-DIMM `FabricPool` (`register_sharded`) and run
    by the simulator on the card (`gemv_sharded`) on B = 4 seeded
    activations. Holds the outputs bitwise the unsharded `run_resident` of
    the same matrix on one pool, every shard's per-(lane, tile) counts
    equal to the unsharded tiles they cover, one lane-masked call
    (masked row 0, the others bitwise) and one 1-D call. Reports shards,
    tiles per shard, the resolved spec, registration, staging and run
    seconds."""
    import numpy as np
    import torch
    from repro_torch.core.engine import MVDRAMEngine
    from repro_torch.core.pud.fabric import FabricPool
    from repro_torch.core.quant import QuantSpec
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    out = {"phase": "column_shards_llama2_7b", "card": nvidia_smi(),
           "dimms": SHARD_DIMMS, "weight_bits": 2, "act_bits": 4, "b": B,
           "matrices": {}}
    wspec, aspec = QuantSpec(bits=2), QuantSpec(bits=4)
    for name, (n, m) in SHARD_SHAPES.items():
        w = torch.randn((n, m), generator=gen, device="cuda") * n ** -0.5
        x = torch.randn((B, n), generator=gen, device="cuda")
        eng = MVDRAMEngine(pool=FabricPool(dimms=SHARD_DIMMS))
        sh, reg_s = _timed(lambda: eng.register_sharded(name, w, wspec,
                                                        a_spec=aspec))
        stageds, stage_s = _timed(lambda: [eng.staged_for(h)
                                           for h in sh.parts])
        (got, reps), first_s = _timed(lambda: eng.gemv_sharded(sh, x))
        (got, reps), run_s = _timed(lambda: eng.gemv_sharded(sh, x))
        oracle = MVDRAMEngine()
        h = oracle.register(name, w, wspec, a_spec=aspec)
        st, o_stage_s = _timed(lambda: oracle.staged_for(h))
        (ref, rref), o_run_s = _timed(lambda: oracle.run_resident(h, x, st))
        if not (got.is_cuda and torch.equal(got, ref)):
            raise AssertionError(f"shards {name}: output != unsharded")
        # shard d's tile (ci, cj) is the unsharded tile (ci, lo + cj)
        bounds, cc = sh.plan.chunk_bounds, sh.plan.col_chunks
        for d, rep in enumerate(reps):
            cc_d = bounds[d + 1] - bounds[d]
            for b, req in enumerate(rep.requests):
                want = rref.requests[b].tile_runtime
                for t, c in enumerate(req.tile_runtime):
                    ci, cj = divmod(t, cc_d)
                    if c.asdict() != want[ci * cc + bounds[d] + cj].asdict():
                        raise AssertionError(
                            f"shards {name}: shard {d} lane {b} tile {t} "
                            f"counts differ from the unsharded tile")
        mask = np.array([True, False, True, True])
        om, _ = eng.gemv_sharded(sh, x, lane_mask=mask)
        if not (torch.equal(om[mask], ref[mask]) and
                not bool(om[~mask].any())):
            raise AssertionError(f"shards {name}: lane-masked call wrong")
        o1, _ = eng.gemv_sharded(sh, x[0])
        r1, _ = oracle.run_resident(h, x[:1], st)
        if not (o1.ndim == 1 and torch.equal(o1, r1[0])):
            raise AssertionError(f"shards {name}: 1-D call wrong")
        out["matrices"][name] = {
            "n": n, "m": m, "shards": sh.shards, "pspec": sh.plan.pspec,
            "col_chunks": cc, "chunk_bounds": bounds,
            "col_bounds": sh.col_bounds,
            "tiles_per_shard": [s.n_chunks * s.col_chunks for s in stageds],
            "dimm_of_shard": [eng.pool.dimm_of(p.name) for p in sh.parts],
            "register_s": reg_s, "staging_s": stage_s,
            "first_run_s": first_s, "run_s": run_s,
            "unsharded_staging_s": o_stage_s, "unsharded_run_s": o_run_s,
            "staged_gb": sum(s.nbytes for s in stageds) / 1e9,
            "max_abs_out": float(ref.abs().max())}
        del eng, oracle, stageds, st, w, x
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def phase_train_sharded() -> dict:
    """The sharded trainer on the one card: an `nccl` process group of
    world size 1 in this process (from a `HashStore`), a (1, 1) ("data",
    "model") mesh (`make_dist_mesh`), llama2-7b at full width cut to
    SHARDED_LAYERS layers, the phase-8a batch (8 × 512 in 2 microbatches),
    SHARDED_STEPS steps with an async checkpoint at the last. Holds: the
    losses, params and AdamW state bitwise the plain one-device
    `Trainer`'s from the same seed; the sharded run's checkpoint restored
    into a plain `Trainer` bitwise; `compressed_allreduce_mean` on NCCL
    over a gradient-sized leaf bitwise its plain recomputation (the bf16
    round trip, /1, the int8 absmax round trip). Reports seconds per step
    of both trainers and the collective's time. The checkpoints live in a
    temporary directory removed after; the group is destroyed."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_dist_mesh
    from repro_torch.parallel.compress import (compressed_allreduce_mean,
                                               int8_dequantize,
                                               int8_quantize)
    t_phase = time.perf_counter()
    cfg = train_config(SHARDED_LAYERS)
    out = {"phase": "train_sharded_llama2_7b", "card": nvidia_smi(),
           "layers": cfg.num_layers, "steps": SHARDED_STEPS,
           "global_batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "microbatches": TRAIN_MICRO}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    tmp = tempfile.mkdtemp(prefix="train_sharded_")
    try:
        mesh = make_dist_mesh((1, 1), ("data", "model"))
        with deterministic():
            p_plain, s_plain, h_plain = trainer(cfg).run(SHARDED_STEPS,
                                                         log_every=1)
            sharded = trainer(cfg, mesh, ckpt_dir=tmp,
                              ckpt_every=SHARDED_STEPS)
            p_shard, s_shard, h_shard = sharded.run(SHARDED_STEPS,
                                                    log_every=1)
            full = {"params": _gathered(p_shard), "opt": _gathered(s_shard)}
            del p_shard, s_shard
            if not [h["loss"] for h in h_shard] == \
                    [h["loss"] for h in h_plain]:
                raise AssertionError(f"sharded: losses {h_shard} != the "
                                     f"plain trainer's {h_plain}")
            if not same_trees(full, {"params": p_plain, "opt": s_plain}):
                raise AssertionError("sharded: params or AdamW state "
                                     "differ from the plain trainer's")
            del p_plain, s_plain
            torch.cuda.empty_cache()
            plain = trainer(cfg, ckpt_dir=tmp)
            (step, p_rest, s_rest), restore_s = _timed(
                plain.restore_or_init)
            if not (step == SHARDED_STEPS and same_trees(
                    {"params": p_rest, "opt": s_rest}, full)):
                raise AssertionError(f"sharded: its checkpoint (step "
                                     f"{step}) does not restore bitwise "
                                     f"into the plain trainer")
            del p_rest, s_rest, full
            torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
        g = torch.randn(COMPRESS_SHAPE, generator=gen, device="cuda")
        got, comm_s = _timed(lambda: compressed_allreduce_mean(g))
        want, plain_s = _timed(lambda: int8_dequantize(*int8_quantize(
            g.to(torch.bfloat16).to(torch.float32) / 1)).reshape(g.shape))
        if not (got.dtype == g.dtype and torch.equal(got, want)):
            raise AssertionError("compressed_allreduce_mean on NCCL at "
                                 "world 1 != its plain recomputation")
        out |= {
            "mesh": mesh.shape, "backend": dist.get_backend(),
            "losses": [h["loss"] for h in h_shard],
            "bitwise_plain": True, "checkpoint_restores_bitwise": True,
            "sec_per_step_sharded": [h["sec_per_step"] for h in h_shard],
            "sec_per_step_plain": [h["sec_per_step"] for h in h_plain],
            "restore_s": restore_s,
            "compressed_allreduce": {
                "shape": list(COMPRESS_SHAPE), "bitwise": True,
                "max_abs_err_vs_input": float((got - g).abs().max()),
                "seconds": comm_s, "plain_seconds": plain_s}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def _gathered(tree):
    """Every DTensor leaf of a tree gathered whole (others as they are)."""
    if isinstance(tree, dict):
        return {k: _gathered(v) for k, v in tree.items()}
    return tree.full_tensor() if hasattr(tree, "full_tensor") else tree


def phase_dryrun(train_out: dict) -> dict:
    """The port's dry-run on the host (the meta device; no card memory):
    `run_cell` for llama2-7b × DRYRUN_CELLS on the (16, 16) production
    mesh, each record's roofline on H100 constants; then the same counting
    (`dryrun.estimate`) on phase 8a's own training configuration on one
    device, its bound printed beside the step that phase measured and the
    hand-reckoned bound (`train_bound`). Holds every count positive and
    finite, each record labelled the port's estimate, the decode cell
    without a collective term, and the card's memory within 10 % of the
    H100 constants' capacity."""
    import torch
    from repro_torch.configs import ShapeProfile
    from repro_torch.core.pud.timing import H100_SXM
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    out = {"phase": "dryrun_llama2_7b", "card": nvidia_smi(),
           "hardware": dataclasses.asdict(H100_SXM),
           "card_total_memory": total, "estimate": dryrun.ESTIMATE}
    if not abs(total - H100_SXM.hbm_bytes) <= 0.1 * H100_SXM.hbm_bytes:
        raise AssertionError(f"dryrun: the card has {total} B, the H100 "
                             f"constants {H100_SXM.hbm_bytes}")
    keys = ("flops", "flops_by_dtype", "compute_s_by_dtype", "write_bytes",
            "arg_bytes", "hbm_bytes", "collective_bytes", "flops_split",
            "local_batch", "build_s", "roofline")
    for shape in DRYRUN_CELLS:
        r = dryrun.run_cell("llama2-7b", shape)
        if not (r["estimate"] == dryrun.ESTIMATE and r["flops"] > 0 and
                math.isfinite(r["roofline"]["bound_s"]) and
                r["hbm_bytes"] > 0):
            raise AssertionError(f"dryrun {shape}: {r}")
        if (r["kind"] == "train") != (r["collective_bytes"] is not None):
            raise AssertionError(f"dryrun {shape}: collective term "
                                 f"{r['collective_bytes']}")
        out[shape] = {"mesh": r["mesh"], "chips": r["chips"],
                      **{k: r[k] for k in keys}}
    cfg = train_config(TRAIN_LAYERS)
    own = dryrun.estimate(cfg, ShapeProfile("train_llama2_7b", "train",
                                            TRAIN_SEQ, TRAIN_BATCH),
                          microbatches=TRAIN_MICRO)
    measured = train_out["sec_per_step_median_2_8"]
    bound = own["roofline"]["bound_s"]
    out["train_llama2_7b"] = {
        **{k: own[k] for k in keys},
        "write_bytes_by_part": own["write_bytes_by_part"],
        "dryrun_bound_ms": bound * 1e3,
        "dryrun_compute_ms_by_dtype": sum(
            own["compute_s_by_dtype"].values()) * 1e3,
        "measured_step_ms": measured * 1e3,
        "share_of_dryrun_bound": bound / measured,
        "hand_bound_ms": train_out["bound_ms"],
        "hand_terms_ms": {k: train_out[k] for k in (
            "bf16_products_ms", "f32_attention_ms", "adamw_bytes_ms")}}
    if not (bound > 0 and math.isfinite(bound)):
        raise AssertionError(f"dryrun train_llama2_7b: bound {bound}")
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 9: B3 over a stack of experts against its plain version
# ---------------------------------------------------------------------------

# (name, E, R, n, m, q, counts, calls per decode layer). The decode path
# gives each stack the row counts of its routing, 4 lanes' top-k picks into
# 8 capacity rows an expert (counts k: qwen2-moe's 4, 16 (token, expert)
# pairs; deepseek-v2-lite's 6, 24 pairs); the full-capacity rows read
# every expert's planes
EXPERT_SHAPES = [
    ("up/gate 2048→1408, routed", 64, 8, 2048, 1408, 4, 4, 2),
    ("down 1408→2048, routed", 64, 8, 1408, 2048, 4, 4, 1),
    ("deepseek up/gate 2048→1408, routed top-6", 64, 8, 2048, 1408, 4, 6,
     0),
    ("deepseek down 1408→2048, routed top-6", 64, 8, 1408, 2048, 4, 6, 0),
    ("up/gate 2048→1408, full", 64, 8, 2048, 1408, 4, None, 0),
    ("down 1408→2048, full", 64, 8, 1408, 2048, 4, None, 0),
    ("ragged M 300→90", 5, 6, 300, 90, 3, None, 0),
    ("one expert 2048→1408", 1, 8, 2048, 1408, 4, None, 0),
    ("empty and full experts 2048→1408", 4, 8, 2048, 1408, 4,
     [0, 8, 3, 0], 0),
]


def _expert_stack(e, n, m, q, gen):
    import torch
    from repro_torch.serve.quantize import _quantize_leaf
    return _quantize_leaf(torch.randn((e, n, m), generator=gen,
                                      device="cuda"), q)


def _routed_counts(e, gen, lanes=B, k=4):
    """Rows per expert of one decode step: `lanes` tokens, each routed to
    k distinct experts."""
    import torch
    picks = torch.stack([torch.randperm(e, generator=gen, device="cuda")[:k]
                         for _ in range(lanes)])
    return torch.bincount(picks.reshape(-1), minlength=e).to(torch.int32)


def _held_b3(name, got, want, counts=None) -> float:
    """Max |Δ| of a B3 output against its plain version's, raising outside
    rtol/atol B3_RTOL (atol relative to max|plain|), or, for a stack with
    `counts`, if a row at or past its expert's count is not zero."""
    import torch
    err = float((got - want).abs().max())
    tol = B3_RTOL * want.abs() + B3_RTOL * float(want.abs().max())
    if not bool(torch.isfinite(got).all()) or not bool(
            ((got - want).abs() <= tol).all()):
        raise AssertionError(f"{name}: max|Δ| {err} outside rtol/atol "
                             f"{B3_RTOL}")
    if counts is not None:
        rows = torch.arange(got.shape[1], device=got.device)
        if bool(got[rows[None, :] >= counts[:, None]].any()):
            raise AssertionError(f"{name}: rows past a count are not zero")
    return err


def phase_expert_kernels() -> tuple:
    """(f32 rows, bf16 rows): the stacked B3 at every EXPERT_SHAPES entry,
    on f32 activations padded for B3's block body (`experts_kernel`) and
    on the same values in bf16, unpadded, on the tensor cores
    (`experts_mma_kernel`, the MoE path's), with the plan over `live`
    expert slots (16 at a decode step's routing: 4 lanes × top-4)."""
    import torch
    from repro_torch.kernels.bitplane_gemv import kernel, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, rows16 = [], []
    for name, e, r, n, m, q, spec, count in EXPERT_SHAPES:
        bw = _expert_stack(e, n, m, q, gen)
        routed = isinstance(spec, int)
        counts = (None if spec is None else _routed_counts(e, gen, k=spec)
                  if routed else
                  torch.tensor(spec, dtype=torch.int32, device="cuda"))
        x = torch.randn((e, r, n), generator=gen, device="cuda")
        live_rows = r * e
        if counts is not None:      # rows past a count are zero, as routed
            live = torch.arange(r, device="cuda") < counts[:, None]
            x = torch.where(live[..., None], x, 0.0)
            live_rows = int(counts.clamp(max=r).sum())
        bn, _ = ops._pick_blocks(n, m, None, None, None)
        a = ops._pad_axis(x, bn, 2).contiguous()
        scale_t = bw.scale.expand(e, a.shape[2] // bn, m)
        kw = dict(q=q, zero=bw.zero, bn=bn)
        got = kernel.gemv_f_experts(a, bw.planes, scale_t, counts, **kw)
        want = ref.gemv_f_experts_ref(a, bw.planes, scale_t, counts, **kw)
        torch.cuda.synchronize()
        err = _held_b3(f"gemv_f_experts {name}", got, want, counts)
        copies = [bw] + [_expert_stack(e, n, m, q, gen) for _ in
                         range(copies_for(nbytes(bw.planes)) - 1)]
        ms = graph_ms([lambda c=c: kernel.gemv_f_experts(
            a, c.planes, scale_t, counts, **kw) for c in copies], 20)
        plain = eager_ms(lambda: ref.gemv_f_experts_ref(
            a, bw.planes, scale_t, counts, **kw), reps=1)
        # full capacity: every expert's planes, scales and rows; routed:
        # what this run's counts need (the planes and scales of experts
        # with rows, their live rows); the whole output is written
        busy = (e if counts is None else int((counts > 0).sum()))
        per_expert = nbytes(bw.planes[0], bw.scale[0])
        t_full, by_full = bound(nbytes(x, bw.planes, bw.scale), nbytes(got),
                                2.0 * e * r * n * m, "float32")
        t_bound, by = bound(busy * per_expert + live_rows * n * 4,
                            nbytes(got), 2.0 * live_rows * n * m,
                            "float32")
        wlib = [torch.randn((e, n, m), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
                for _ in range(copies_for(e * n * m * 2))]
        xb = x.to(torch.bfloat16)
        lib_ms = graph_ms([lambda w=w: torch.bmm(xb, w) for w in wlib], 20)
        del wlib
        plan = kernel.split_plan(a.shape[2] // bn, m, r, sms, experts=e)
        plane_ms = busy * nbytes(bw.planes[0]) / HBM_BYTES_S * 1e3
        rows.append(dict(
            shape=name, experts=e, rows=r, n=n, m=m, q=q,
            experts_with_rows=busy, live_rows=live_rows, count=count,
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=t_bound,
            bound_by=by, full_capacity_bound_ms=t_full,
            full_capacity_bound_by=by_full, plane_bound_ms=plane_ms,
            library_ms=lib_ms, tiles_per_block=plan[0], splits=plan[1]))

        # the same values in bf16, unpadded: the tensor-core kernel over
        # `live` expert slots (the MoE path's bound: 4 lanes × top-k)
        tiles = -(-n // bn)
        s16 = bw.scale.expand(e, tiles, m)
        slots = min(e, B * spec) if routed else e
        kw16 = dict(kw, live=slots)
        got = kernel.gemv_f_experts(xb, bw.planes, s16, counts, **kw16)
        want = ref.gemv_f_experts_ref(xb, bw.planes, s16, counts, **kw16)
        torch.cuda.synchronize()
        err = _held_b3(f"gemv_f_experts bf16 {name}", got, want, counts)
        ms = graph_ms([lambda c=c: kernel.gemv_f_experts(
            xb, c.planes, s16, counts, **kw16) for c in copies], 20)
        del copies
        plain = eager_ms(lambda: ref.gemv_f_experts_ref(
            xb, bw.planes, s16, counts, **kw16), reps=1)
        # the products are exact in f32 (tests/test_torch_experts_mma.py),
        # so the operations count at the bf16 tensor-core rate
        t_full, by_full = bound(nbytes(xb, bw.planes, bw.scale),
                                nbytes(got), 2.0 * e * r * n * m,
                                "bfloat16")
        t_bound, by = bound(busy * per_expert + live_rows * n * 2,
                            nbytes(got), 2.0 * live_rows * n * m,
                            "bfloat16")
        plan = kernel.mma_plan(tiles, m, r, sms, e, slots)
        rows16.append(dict(
            shape=name, experts=e, rows=r, n=n, m=m, q=q, live=slots,
            experts_with_rows=busy, live_rows=live_rows, count=count,
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=t_bound,
            bound_by=by, full_capacity_bound_ms=t_full,
            full_capacity_bound_by=by_full, plane_bound_ms=plane_ms,
            library_ms=lib_ms, tiles_per_block=plan[0], splits=plan[1]))
        del bw, x, a, xb
    for kname, rs in (("gemv_f_experts", rows),
                      ("gemv_f_experts_mma", rows16)):
        for row in rs:
            emit({"phase": "kernel_check", "kernel": kname, **row})
    return rows, rows16


# ---------------------------------------------------------------------------
# phases 10-12: qwen2-moe-a2.7b at full width
# ---------------------------------------------------------------------------

def phase_zoo_model(arch: str, layers: Optional[int] = None):
    """A configuration's serving parameters at full width, drawn and
    quantized one leaf (and one layer of a stacked leaf) at a time: the
    float model (qwen2-moe-a2.7b's 60.6 GB, deepseek-v2-lite-16b's 62.8 GB)
    never lies on the card. `layers` cuts the depth (never the width) to
    keep the smoke in its time budget. Returns (config, parameters, the
    requests' prompts: tokens, or frames (B, PROMPT + NEW, E) in the
    model's dtype for a stubbed frontend)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import param_defs, stack_plan
    from repro_torch.serve.quantize import init_quantized_params
    cfg = full = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qparams = init_quantized_params(param_defs(cfg), cfg.weight_bits, gen,
                                    "cuda")
    torch.cuda.synchronize()
    if cfg.input_mode == "embeddings":
        prompts = torch.randn((B, PROMPT + NEW, cfg.d_model), generator=gen,
                              device="cuda").to(getattr(torch, cfg.dtype))
    else:
        prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                                generator=gen, device="cuda")
    plan = stack_plan(cfg)
    line = {"phase": "model", "config": cfg.name, "layers": cfg.num_layers,
            "first_dense": plan.first, "d_model": cfg.d_model,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
            "tied_head": cfg.tie_embeddings, "inputs": cfg.input_mode,
            "weight_bits": cfg.weight_bits, "dtype": cfg.dtype,
            "depth_cut": layers and {"layers": full.num_layers,
                                     "served": layers},
            "setup_seconds": time.perf_counter() - t0,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "allocated_gb": torch.cuda.memory_allocated() / 1e9}
    if cfg.attn:
        line |= {"heads": cfg.attn.num_heads,
                 "kv_heads": cfg.attn.num_kv_heads,
                 "head_dim": cfg.attn.head_dim}
    if cfg.ssm:
        line |= {"ssm": dataclasses.asdict(cfg.ssm), "d_inner": cfg.d_inner,
                 "ssm_heads": cfg.ssm_heads}
    if cfg.num_shared_blocks:
        line |= {"shared_blocks": cfg.num_shared_blocks,
                 "shared_every": cfg.shared_every,
                 "shared_invocations": plan.repeats,
                 "trailing": plan.trailing}
    if cfg.moe:
        line |= {"experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
                 "d_expert": cfg.moe.d_expert,
                 "shared_d_ff": cfg.moe.shared_d_ff
                 or cfg.moe.num_shared * cfg.moe.d_expert,
                 "first_dense_d_ff": cfg.moe.first_dense_d_ff}
    if cfg.mla:
        line["mla"] = dataclasses.asdict(cfg.mla)
    emit(line)
    return cfg, qparams, prompts


class RouteLog:
    """Records each MoE layer's top-k expert sets (`moe._route`) while
    installed: `with RouteLog() as log: ...`, then `log.sets`."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.real, self.sets = moe._route, []

        def recorded(*args, **kw):
            out = self.real(*args, **kw)
            self.sets.append(torch.sort(out[3], dim=-1).values)
            return out
        moe._route = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self.real


class ForcedRoutes:
    """While installed, the i-th MoE layer call routes its tokens to the
    experts of `sets[i]` (another run's `RouteLog.sets`), gated by its own
    router probabilities over them: the same run with the other run's
    expert choices."""

    def __init__(self, sets):
        self.sets = sets

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.real, pending = moe._route, iter(self.sets)

        def forced(x, w_router, cfg):
            _, _, aux, _ = self.real(x, w_router, cfg)
            idx = next(pending)
            probs = torch.softmax(moe.dense(x, w_router).to(torch.float32),
                                  dim=-1)
            mask = torch.zeros_like(probs).scatter_(-1, idx, 1.0)
            gates = probs * mask
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            return gates, mask, aux, idx
        moe._route = forced
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self.real


def held_on_path(eng, prompts, new=NEW) -> dict:
    """Replay the requests with every stacked B3 call held against its
    plain version on the same inputs (rtol/atol 1e-5), and every B1 and B2
    call bitwise (after the counted run). Also, for each `live` bound the
    stacked calls passed (the experts a call can route: min(E, tokens·k)),
    its calls and the most experts that had rows in one."""
    import torch
    from repro_torch.kernels.bitplane_gemv import kernel, program, ref
    held = {"gemv_f_experts": [], "gemv_bs": [], "program_gemv": []}
    real = (kernel.gemv_f_experts, kernel.gemv_bs, program.group_gemv)
    live: dict = {}

    def experts(a, planes, scale_tiles, counts=None, **kw):
        got = real[0](a, planes, scale_tiles, counts, **kw)
        want = ref.gemv_f_experts_ref(a, planes, scale_tiles, counts, **kw)
        held["gemv_f_experts"].append(
            _held_b3("gemv_f_experts on the path", got, want, counts))
        busy = a.shape[0] if counts is None else int((counts > 0).sum())
        seen = live.setdefault(str(kw.get("live")), {
            "calls": 0, "experts_with_rows_max": 0})
        seen["calls"] += 1
        seen["experts_with_rows_max"] = max(seen["experts_with_rows_max"],
                                            busy)
        return got

    def bitwise(name, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} on the path: kernel != plain")
        held[name].append(0.0)
        return got

    def leaf(*args, **kw):
        return bitwise("gemv_bs", real[1](*args, **kw),
                       ref.gemv_bs_ref(*args, **kw))

    def group(table, codes, **kw):
        return bitwise("program_gemv", real[2](table, codes, **kw),
                       ref.group_gemv_ref(codes, table.planes, table.scales,
                                          table.members, table.cols, **kw))

    kernel.gemv_f_experts, kernel.gemv_bs, program.group_gemv = (
        experts, leaf, group)
    try:
        eng.generate(prompts, max_new=new, scan=False)
    finally:
        kernel.gemv_f_experts, kernel.gemv_bs, program.group_gemv = real
    return {**{k: {"calls": len(v), "max_abs_err": max(v, default=None)}
               for k, v in held.items()}, "live": live}


def phase_moe_slice(cfg, qparams, prompts, act_bits, tag: str) -> dict:
    """Serve the requests (`served`, every launch count exact); then the
    checks of the module docstring's phase 10 or 11."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    what = f"{cfg.name} act_bits={act_bits}"
    want = {k: v * NEW for k, v in launches_per_pass(cfg, act_bits).items()}
    eng, _, fields = served(cfg, qparams, prompts, act_bits, want=want)
    with torch.no_grad():
        with RouteLog() as k_log:
            got, _ = eng.model.prefill(eng.params, {"tokens": prompts},
                                       eng.max_seq)
        ref_eng = ServeEngine(cfg, qparams, max_seq=PROMPT + NEW + 1,
                              batch_slots=B, quantized=True,
                              act_bits=act_bits, impl="reference",
                              device="cuda")
        with RouteLog() as p_log:
            want_l, _ = ref_eng.model.prefill(ref_eng.params,
                                              {"tokens": prompts},
                                              eng.max_seq)
        # the plain versions on the kernel run's expert choices
        with ForcedRoutes(k_log.sets):
            same_l, _ = ref_eng.model.prefill(ref_eng.params,
                                              {"tokens": prompts},
                                              eng.max_seq)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite logits")
    err, scale = float((got - want_l).abs().max()), float(want_l.abs().max())
    err_same = float((got - same_l).abs().max())
    flips = sum(int((a != b).any(-1).sum())
                for a, b in zip(k_log.sets, p_log.sets))
    out = {"phase": f"slice_{tag}_act_bits_{act_bits}", **fields,
           "prefill_logits_max_abs_err_vs_plain": err,
           "max_abs_logit": scale,
           "routed_token_layers": sum(int(a.shape[0] * a.shape[1])
                                      for a in k_log.sets),
           "expert_sets_differing_vs_plain": flips,
           "prefill_logits_max_abs_err_vs_plain_same_experts": err_same}
    # float activations: the logits within 5 % of max|logit| of the plain
    # versions' on the kernel run's expert choices (router flips alone
    # break the plain 5 % rule, PERF.md §6). At act_bits=4 the logits are
    # chaotic: reported. Either way every stacked call of a replay is held
    # against its plain version on the path's inputs, and at act_bits=4
    # every B1 and B2 call bitwise.
    if not act_bits and err_same > LOGIT_RTOL * scale:
        raise AssertionError(f"{what}: logits differ from the plain "
                             f"versions' on the same experts (max|Δ| "
                             f"{err_same}, max|logit| {scale})")
    if not act_bits and err > LOGIT_RTOL * scale and flips == 0:
        raise AssertionError(f"{what}: logits differ from the plain "
                             f"versions' (max|Δ| {err}, max|logit| "
                             f"{scale}) with the same experts routed")
    out["held_on_path"] = held = held_on_path(eng, prompts)
    if held["gemv_f_experts"]["calls"] != want["gemv_f_experts_mma"]:
        raise AssertionError(f"{what}: {held['gemv_f_experts']['calls']} "
                             f"stacked calls held on the replay, not "
                             f"{want['gemv_f_experts_mma']}")
    emit(out)
    return out


def phase_model_profile(cfg, qparams, act_bits=None, tokens=NEW) -> dict:
    """`profile_decode` on a full-width model's slice: busy share and top
    kernels."""
    import torch
    from repro_torch.launch.profile_decode import profile
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    run = profile(cfg, qparams, act_bits=act_bits, batch=B,
                  prompt_len=PROMPT, tokens=tokens, gen=gen)
    if not run["top_kernels"] or run["device_kernel_s"] <= 0:
        raise AssertionError(f"profile of {cfg.name} saw no device time")
    emit(run)
    return run


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
    s4 = phase_slice(cfg, qparams, prompts, 4,
                     ("gemv_bs", "gemv_bs_fold", "program_gemv",
                      "program_gemv_fold"), sampled=True)
    sf = phase_slice(cfg, qparams, prompts, None, ("gemv_f", "gemv_f_fold"))
    res, eng8 = phase_residency(cfg, qparams)
    rows["decode_attention"] = phase_decode_attention()
    rows["quant_matmul"] = phase_quant_matmul(cfg.weight_bits)
    sa = phase_attn_kernel_slice(cfg, qparams, prompts,
                                 "slice_act_bits_4_kv8_attn_kernel")
    phase_profile(cfg, qparams)
    llama_b1 = ("gemv_bs", "gemv_bs_fold", "program_gemv",
                "program_gemv_fold")
    tick_masks = []
    phase_batcher(cfg, qparams, "batcher_llama2_7b_act_bits_4",
                  must_run=llama_b1, dimms=RESIDENT_DIMMS,
                  masks_out=tick_masks)
    phase_sim(eng8, tick_masks)
    del eng8
    torch.cuda.empty_cache()
    phase_batcher(cfg, qparams,
                  "batcher_llama2_7b_act_bits_4_kv8_attn_kernel",
                  max_seq=CONTEXT, attn_kernel=True, must_run=llama_b1)
    del qparams                       # the baseline needs the float weights
    torch.cuda.empty_cache()
    sb = phase_baseline_slice(cfg, prompts)
    torch.cuda.empty_cache()          # llama2-7b's weights are all freed

    # training at full width, train-then-serve, the column shards
    tout, tcfg, tq, tprompts = phase_train()
    phase_train_recovery()
    phase_train_to_serve(tcfg, tq, tprompts)
    del tq
    torch.cuda.empty_cache()
    phase_column_shards()
    phase_train_sharded()
    phase_dryrun(tout)

    _, rows["gemv_f_experts_mma"] = phase_expert_kernels()
    moe_cfg, moe_params, moe_prompts = phase_zoo_model(MOE_ARCH)
    smf = phase_moe_slice(moe_cfg, moe_params, moe_prompts, None,
                          "qwen2_moe")
    phase_moe_slice(moe_cfg, moe_params, moe_prompts, 4, "qwen2_moe")
    phase_model_profile(moe_cfg, moe_params)
    del moe_params
    torch.cuda.empty_cache()

    # the rest of the attention zoo at full width, each model's weights
    # freed before the next is drawn
    zoo, zoo_params, zoo_prompts = phase_zoo_model("gemma2-9b")
    for ab, folds in ((4, ("gemv_bs_fold", "program_gemv_fold")),
                      (None, ("gemv_f_fold",))):
        phase_slice(zoo, zoo_params, zoo_prompts, ab, folds,
                    {k: v * NEW for k, v in
                     launches_per_pass(zoo, ab).items()},
                    name=f"slice_gemma2_9b_act_bits_{ab}")
    # one profile (8 new tokens): the profiler's event processing, not the
    # run, takes most of a profile's time
    phase_model_profile(zoo, zoo_params, None, NEW // 2)
    del zoo_params
    torch.cuda.empty_cache()
    zoo, zoo_params, zoo_prompts = phase_zoo_model("pixtral-12b")
    phase_attn_kernel_slice(zoo, zoo_params, zoo_prompts,
                            "slice_pixtral_12b_act_bits_4_kv8_attn_kernel")
    del zoo_params, zoo_prompts
    torch.cuda.empty_cache()
    # deepseek at a third of its depth (a dense layer and 8 MoE of 26):
    # its replays hold every stacked call against the plain version, the
    # smoke's longest phases (PERF.md §5)
    zoo, zoo_params, zoo_prompts = phase_zoo_model("deepseek-v2-lite-16b",
                                                   layers=DEEPSEEK_LAYERS)
    for ab in (None, 4):
        phase_moe_slice(zoo, zoo_params, zoo_prompts, ab, "deepseek_v2")
    del zoo_params
    torch.cuda.empty_cache()

    # the SSM and the hybrid at full width and depth
    zoo, zoo_params, zoo_prompts = phase_zoo_model("mamba2-1.3b")
    for ab, folds in ((4, ("gemv_bs_fold",)), (None, ("gemv_f_fold",))):
        phase_slice(zoo, zoo_params, zoo_prompts, ab, folds,
                    {k: v * NEW for k, v in
                     launches_per_pass(zoo, ab).items()},
                    name=f"slice_mamba2_1_3b_act_bits_{ab}")
    phase_batcher(zoo, zoo_params, "batcher_mamba2_1_3b_act_bits_4",
                  must_run=("gemv_bs", "gemv_bs_fold"))
    del zoo_params
    torch.cuda.empty_cache()
    zoo, zoo_params, zoo_prompts = phase_zoo_model("zamba2-7b")
    phase_attn_kernel_slice(zoo, zoo_params, zoo_prompts,
                            "slice_zamba2_7b_act_bits_4_kv8_attn_kernel")
    del zoo_params, zoo_prompts
    torch.cuda.empty_cache()

    launches = {**s4["launches"]}
    launches["gemv_f"] = sf["launches"]["gemv_f"]
    launches["gemv_f_fold"] = sf["launches"]["gemv_f_fold"]
    launches["decode_attention"] = sa["launches"]["decode_attention"]
    launches["decode_attention_fold"] = \
        sa["launches"]["decode_attention_fold"]
    launches["quant_matmul"] = sb["launches"]["quant_matmul"]
    launches["quant_matmul_fold"] = sb["launches"]["quant_matmul_fold"]
    for k in ("gemv_f_experts_mma", "gemv_f_experts_mma_fold"):
        launches[k] = smf["launches"][k]
    # per kernel, its shapes summed as one decode layer (plus lm_head) calls
    # them; `kernel_ms`/`max_abs_diff` repeat `ms`/`max_abs_err` under the
    # names PERF.md's kernel table uses, `plane_bound_ms` (bit-plane
    # kernels only) is the planes alone at the memory rate, and
    # `fold_launches` (B1, B2, B3, B4, B5, the stacked B3) the second
    # launches of split calls; the stacked B3's shapes are a MoE layer's
    kernels = []
    for kname, rs in rows.items():
        keys = ("ms", "plain_ms", "bound_ms", "library_ms") + (
            ("plane_bound_ms",) if "plane_bound_ms" in rs[0] else ())
        row = {
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            **{key: sum(r[key] * r["count"] for r in rs) for key in keys},
            "bound_by": max(("bytes", "operations"), key=lambda by: sum(
                r["bound_ms"] * r["count"] for r in rs
                if r["bound_by"] == by)),
            "shapes": {r["shape"]: r["count"] for r in rs}}
        row["kernel_ms"], row["max_abs_diff"] = row["ms"], row["max_abs_err"]
        if kname + "_fold" in launches:
            row["fold_launches"] = launches[kname + "_fold"]
        kernels.append(row)
    # B2 over a whole decode block (phase 4a): the 8-DIMM program's parts,
    # one launch each, summed as one decode step runs them
    blk = res["b2_whole_block"]
    kernels.append({
        "name": "program_gemv_block", "route": "cuda",
        "source": SOURCES["program_gemv"],
        "replaces": REPLACES["program_gemv"],
        "launches": res["b2_whole_block_launches"],
        "max_abs_err": max(p["max_abs_err"] for p in blk),
        **{key: sum(p[key] for p in blk) for key in (
            "ms", "plain_ms", "bound_ms", "plane_bound_ms",
            "per_leaf_b1_ms")},
        "bound_by": max(("bytes", "operations"), key=lambda by: sum(
            p["bound_ms"] for p in blk if p["bound_by"] == by)),
        "library_ms": None,
        "shapes": {f"part {p['part']}: {p['members']} leaves": 1
                   for p in blk}})
    kernels[-1]["kernel_ms"] = kernels[-1]["ms"]
    kernels[-1]["max_abs_diff"] = kernels[-1]["max_abs_err"]
    emit({"phase": "decode_graph", "checks": len(ADDED_SECONDS),
          "added_seconds": sum(ADDED_SECONDS)})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
