"""Profile the port's generation on the GPU: where the decode time goes.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        --arch llama2-7b --act-bits 4 --batch 4 --prompt-len 16 --tokens 16
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        --arch qwen2-moe-a2.7b

Builds the model at full width with random weights from `--seed` (drawn
and quantized one leaf at a time, `init_quantized_params`), serves
one warm-up request batch, then runs `ServeEngine.generate` once timed and
once more under `torch.profiler` (`profile`, which `chip_smoke.py` also
calls), and prints one JSON line: the wall time of the timed call, the
device time summed over all kernels of the profiled call, the device busy
share (kernel time / unprofiled wall time: kernels run on one stream and
do not overlap, and the profiler slows the host, not the kernels) and the
kernels that took the most device time. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs import ARCHS, get_config
from ..models.model import param_defs
from ..serve.engine import ServeEngine
from ..serve.quantize import init_quantized_params

TOP = 12                  # kernels listed, by device time


def _kernel_us(evt) -> float:
    """Device time of a kernel row of `key_averages()`; 0 for the rows of
    the PyTorch ops that launched kernels (their device time is their
    kernels', which have rows of their own)."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile(cfg, qparams, *, act_bits, batch: int, prompt_len: int,
            tokens: int, gen: torch.Generator) -> dict:
    """Serve one warm-up batch of random prompts through `ServeEngine` on
    `qparams`, then time one more and profile a third: the result line's
    fields (module docstring)."""
    eng = ServeEngine(cfg, qparams, max_seq=prompt_len + tokens,
                      batch_slots=batch, quantized=True, act_bits=act_bits,
                      device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device="cuda")
    eng.generate(prompts, max_new=tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, max_new=tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, max_new=tokens)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    kernels = [(e.key, _kernel_us(e), e.count) for e in prof.key_averages()
               if _kernel_us(e) > 0]
    device_s = sum(us for _, us, _ in kernels) / 1e6
    kernels.sort(key=lambda k: -k[1])
    return {
        "phase": "profile_decode", "config": cfg.name,
        "layers": cfg.num_layers, "act_bits": act_bits, "batch": batch,
        "prompt_len": prompt_len, "new_tokens": tokens, "wall_s": wall,
        "profiled_wall_s": profiled_wall,
        "tokens_per_s": batch * tokens / wall,
        "device_kernel_s": device_s, "device_busy_share": device_s / wall,
        "top_kernels": [{"name": k[:80], "device_ms": us / 1e3,
                         "calls": n} for k, us, n in kernels[:TOP]],
        "device": torch.cuda.get_device_name(0)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b", choices=list(ARCHS))
    ap.add_argument("--act-bits", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")

    cfg = get_config(args.arch)
    if cfg.input_mode == "embeddings":
        raise SystemExit(f"{cfg.name} has a stubbed frontend: "
                         f"ServeEngine.generate takes tokens")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    qparams = init_quantized_params(param_defs(cfg), cfg.weight_bits, gen,
                                    "cuda")
    print(json.dumps(profile(cfg, qparams, act_bits=args.act_bits,
                             batch=args.batch, prompt_len=args.prompt_len,
                             tokens=args.tokens, gen=gen)), flush=True)


if __name__ == "__main__":
    main()
