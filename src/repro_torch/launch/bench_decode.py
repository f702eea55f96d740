"""Time the flash-decode kernel B4 at `chip_smoke.py`'s shapes on one GPU.

    python3 src/repro_torch/launch/bench_decode.py [--src DIR] [--label L]
        [--shapes SUBSTR,...] [--plans BPS:MIN_CHUNK,...]
        [--variants NAME,...] [--repeat N] [--build-only]

`--src` picks the `repro_torch` package to time (default: this tree's
`src`), so one card can time an older checkout's kernel with the same
script: unpack it (`git archive <commit> | tar -x -C build/parent`) and
pass `--src build/parent/src`. The shapes, their inputs (chip_smoke's
seed through `chip_smoke._decode_inputs`) and the timing
(`chip_smoke.graph_ms`: a CUDA graph of 20 calls over input copies that
overflow the L2) are this tree's `chip_smoke.py`'s, whichever package is
timed.

On this tree's package, `--plans` times other plan constants
(`kernel.BLOCKS_PER_SM`, `kernel.MIN_CHUNK`), and `--variants` builds the
CUDA source with one of the `VARIANTS` edits into `build/variants/` and
times it beside the shipped build. Every configuration is held against the
plain version (`ref.decode_attention_ref`, chip_smoke's tolerance) before
it is timed; within a shape, the configurations are timed in turn, so
their times compare within one run.

Prints the card's name and power limit, then one JSON line per (shape,
configuration): `ms` (the median of `--repeat` timings) and `ms_all`, the
plan, the launches of one call (the split grid plus the fold), max|Δ|.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

#: edits of `csrc/decode_attention.cu` (text → replacement), each built as
#: its own library: the GQA head counts a lane group holds without the
#: kGH = 2 and 4 builds (the largest, kLaneFloats / PE heads, for every
#: g > kGroups)
VARIANTS = {
    "gh_1_or_many": [("if constexpr (kExact && 2 < kMany) {",
                      "if constexpr (false) {"),
                     ("if constexpr (kExact && 4 < kMany) {",
                      "if constexpr (false) {")],
}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _variant_sources(build, names) -> dict:
    """name → (patched source, library path) under build/variants/."""
    text = (build.CSRC / "decode_attention.cu").read_text()
    out = {}
    for name in names:
        src = text
        for old, new in VARIANTS[name]:
            if old not in src:
                raise ValueError(f"variant {name}: {old!r} not in the "
                                 f"source")
            src = src.replace(old, new)
        digest = hashlib.sha256(src.encode()).hexdigest()[:16]
        d = ROOT / "build" / "variants"
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"decode_attention-{name}-{digest}.cu"
        path.write_text(src)
        out[name] = (path, path.with_suffix(".so"))
    return out


def _build_variants(build, names) -> dict:
    """Compile the variants, all at once; name → loaded library."""
    srcs = _variant_sources(build, names)
    procs = {}
    for name, (src, lib) in srcs.items():
        if lib.exists():
            continue
        cmd = [build._nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-o",
               str(lib), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
    libs = {}
    for name, (_, path) in srcs.items():
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in build.SIGNATURES["decode_attention"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default=None)
    ap.add_argument("--shapes", default="",
                    help="comma-separated substrings of shape names")
    ap.add_argument("--plans", default="",
                    help="BLOCKS_PER_SM:MIN_CHUNK pairs, comma-separated")
    ap.add_argument("--variants", default="",
                    help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--build-only", action="store_true",
                    help="build the package's kernels and the variants, "
                         "then exit")
    args = ap.parse_args(argv)

    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("bench_decode: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import kernel, ref
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")
    # after the package: chip_smoke puts this tree's src on the path
    smoke = _load("chip_smoke_bench", ROOT / "chip_smoke.py")
    label = args.label or str(src)
    this_tree = src == (ROOT / "src").resolve()
    if (args.plans or args.variants) and not this_tree:
        raise ValueError("--plans and --variants time this tree's package")

    base = build.library("decode_attention")
    if args.build_only:
        _build_variants(build, [n for n in args.variants.split(",") if n])
        return 0
    print(smoke.nvidia_smi(), flush=True)
    configs = [("shipped", None, None)]
    for pair in filter(None, args.plans.split(",")):
        bps, mc = (int(x) for x in pair.split(":"))
        configs.append((f"plan {bps}:{mc}", (bps, mc), None))
    names = [n for n in args.variants.split(",") if n]
    for name, lib in _build_variants(build, names).items():
        configs.append((name, None, lib))

    @contextlib.contextmanager
    def configured(plan, lib):
        saved = (getattr(kernel, "BLOCKS_PER_SM", None),
                 getattr(kernel, "MIN_CHUNK", None))
        if plan:
            kernel.BLOCKS_PER_SM, kernel.MIN_CHUNK = plan
        build._loaded["decode_attention"] = lib or base
        try:
            yield
        finally:
            if plan:
                kernel.BLOCKS_PER_SM, kernel.MIN_CHUNK = saved
            build._loaded["decode_attention"] = base

    warm = torch.randn((8192, 8192), device="cuda")
    for _ in range(50):              # clocks up before the first shape
        warm @ warm
    del warm
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 2)
    wanted = [w for w in args.shapes.split(",") if w]
    for name, b, s, h, hkv, d, kind, fill, window, _ in smoke.DECODE_SHAPES:
        inputs = smoke._decode_inputs(gen, b, s, h, hkv, d, kind, fill,
                                      window)
        if wanted and not any(w in name for w in wanted):
            continue
        pos, q, k, v, stamps, ks, vs = inputs
        kw = dict(scale=d ** -0.5, window=window)
        want = ref.decode_attention_ref(*inputs, **kw)
        caches = [(k, v, ks, vs)] + [
            tuple(None if t is None else t.clone() for t in (k, v, ks, vs))
            for _ in range(smoke.copies_for(smoke.nbytes(k, v)) - 1)]
        for cname, plan, lib in configs:
            row = {"bench": "decode_attention", "tree": label,
                   "config": cname, "shape": name}
            with configured(plan, lib):
                if hasattr(kernel, "decode_plan"):
                    row["chunk"], row["splits"] = kernel.decode_plan(
                        b, s, hkv, sms)
                before = sum(kernel.LAUNCHES.values())
                try:
                    got = kernel.decode_attention(*inputs, **kw)
                except ValueError as e:        # a head dim it refuses
                    print(json.dumps({**row, "refused": str(e)}),
                          flush=True)
                    continue
                row["launches"] = sum(kernel.LAUNCHES.values()) - before
                torch.cuda.synchronize()
                row["max_abs_err"] = smoke._held(f"{cname} {name}", got,
                                                 want)
                times = [smoke.graph_ms(
                    [lambda c=c: kernel.decode_attention(
                        pos, q, c[0], c[1], stamps, c[2], c[3], **kw)
                     for c in caches], 20) for _ in range(args.repeat)]
            row["ms"] = statistics.median(times)
            row["ms_all"] = times
            print(json.dumps(row), flush=True)
        del caches, inputs, k, v, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
