"""Serving launcher — batched generation, optionally through the bit-plane
kernels (the paper's deployment mode). Port of the JAX package's
`launch/serve.py`, plus `--device`:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --tiny --quantized --bits 2 --act-bits 4 --tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2-moe-a2.7b --quantized --tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --tiny --quantized --act-bits 4 --tokens 8 --device cpu

Runs on the GPU unless `--device cpu` is given. Quantized serving draws and
quantizes the weights one leaf at a time (`init_quantized_params`), so a
full-width model whose float weights would not fit beside its planes (the
60.6 GB of qwen2-moe-a2.7b in float32) never lies on the device in float.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs import ARCHS, get_config, tiny_config
from ..device import resolve_device
from ..models.model import param_defs
from ..models.params import init_params
from ..serve.engine import ServeEngine
from ..serve.quantize import init_quantized_params, serving_bytes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--quantized", action="store_true",
                    help="serve linears through the bit-plane kernels")
    ap.add_argument("--bits", type=int, default=None)
    ap.add_argument("--act-bits", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = tiny_config(args.arch) if args.tiny else get_config(args.arch)
    if args.bits:
        cfg = dataclasses.replace(cfg, weight_bits=args.bits)
    if cfg.input_mode == "embeddings":
        raise SystemExit(f"{cfg.name} has a stubbed frontend: serve it "
                         f"through Model.prefill/decode_step on embeddings")
    defs = param_defs(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = (init_quantized_params(defs, cfg.weight_bits, gen, device)
              if args.quantized else init_params(defs, gen, device))
    print("serving bytes:", serving_bytes(defs, cfg.weight_bits))

    eng = ServeEngine(cfg, params,
                      max_seq=args.prompt_len + args.tokens + 1,
                      batch_slots=args.batch, quantized=args.quantized,
                      act_bits=args.act_bits, device=device)
    del params
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len),
                            generator=gen, device=device)
    out = eng.generate(prompts, max_new=args.tokens)
    print("generated shape:", tuple(out.shape))
    print("tokens/s:", round(eng.throughput_tokens_per_s(
        b=args.batch, n=min(args.tokens, 16)), 2))


if __name__ == "__main__":
    main()
