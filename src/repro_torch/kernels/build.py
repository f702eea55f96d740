"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source compiles with `nvcc` into its own shared library
with a plain C interface, loaded with `ctypes`: seconds per build, and no
PyTorch headers. Libraries land in `build/kernels/` at the repository root
(listed in `.gitignore`), named by a hash of the sources, so an edited
source rebuilds and an unchanged one loads from the earlier build.

Nothing builds at import time: a wrapper calls `library(name)` at its first
launch, and `build_all()` compiles every source at once, in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
#: -split-compile=0: each source's device code is optimised on every CPU,
#: so B4's many template instantiations do not build one after another
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-split-compile=0")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C entry points of each source: name → (argtypes), all returning the
#: launch's cudaError_t as an int
SIGNATURES = {
    "bitplane_gemv": {
        # codes, planes, scales, out, ws, B, n_pad, n_words, M, q, p, z_a,
        # z_w, bn, tiles_per_block, splits, stream
        "gemv_bs_launch": [_P] * 5 + [_I] * 11 + [_P],
        # a, planes, scales, out, ws, B, n_pad, n_words, M, q, zero, bn,
        # tiles_per_block, splits, stream
        "gemv_f_launch": [_P] * 5 + [_I] * 9 + [_P],
        # a, planes, scales, out, ws, counts or null, E, R, n_pad,
        # n_words, M, q, zero, bn, scale expert stride, scale tile stride,
        # tiles_per_block, splits, stream
        "gemv_f_experts_launch": [_P] * 6 + [_I] * 12 + [_P],
        # table (host), table (device) or null, n, strips, ws, ws_cols, B,
        # q_max, tiles_per_block, splits, stream
        "gemv_group_launch": [_P, _P, _I, _I, _P] + [_I] * 5 + [_P],
        # device table, its per-call fields (n rows of 5 int64), n, stream
        "gemv_table_pointers": [_P, _P, _I, _P],
    },
    "experts_mma": {
        # a (bf16), planes, scales, out, ws, counts or null, E, R, N,
        # n_words, M, q, zero, bn, scale expert stride, scale tile stride,
        # live, tiles_per_block, splits, stream
        "gemv_f_experts_mma_launch": [_P] * 6 + [_I] * 13 + [_P],
    },
    "decode_attention": {
        # pos, q, k, v, stamps, k_scale, v_scale, out, ws_acc, ws_ml, B, S,
        # s_pad, H, Hkv, D, q_type, kv_type, chunk, splits, scale, window,
        # stream
        "decode_attention_launch": [_P] * 10 + [_I] * 10 + [_F, _I, _P],
    },
    "quant_matmul": {
        # a, words, scales, out, ws, B, n_pad, W, M, q, zero, bn,
        # tiles_per_block, splits, stream
        "quant_matmul_launch": [_P] * 5 + [_I] * 9 + [_P],
    },
}

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "CUDA kernels cannot be built")
    return str(path)


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path, verbose: bool) -> list:
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(out),
           str(CSRC / f"{name}.cu")]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build_all(verbose: bool = False) -> dict:
    """Compile every source not yet built, one `nvcc` per source, all
    started together. Returns {name: path}; raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SIGNATURES:
        out = _target(name)
        if out.exists() and not verbose:
            continue
        # a private file per process, renamed into place: concurrent
        # builds never load a half-written library
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[name] = (out, tmp, subprocess.Popen(
            _command(name, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} ---\n{log}")
            continue
        os.replace(tmp, out)
        if verbose and log:
            print(f"nvcc {name}:\n{log}", flush=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: _target(name) for name in SIGNATURES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/{name}.cu`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = _target(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
