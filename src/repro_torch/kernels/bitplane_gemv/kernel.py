"""Wrappers of the per-leaf bit-plane GeMV CUDA kernels (`csrc/
bitplane_gemv.cu`; `csrc/experts_mma.cu` for bf16 expert stacks): B1
`gemv_bs` (integer activation codes) and B3 `gemv_f` (float
activations), the counterparts of the JAX package's `gemv_bs_pallas` and
`gemv_f_pallas`; B3 over a stack of experts in one
launch (`gemv_f_experts`, where the JAX package vmaps `gemv_f_pallas`
over the experts in `models/moe.py`: f32 stacks on B3's block body, bf16
stacks read in place on the tensor cores); and the member table (`Member`,
`Table`) through which B2 (`program.py`) launches the same block body over
a group.

A CUDA tensor goes to the kernel, or the wrapper raises; a CPU tensor goes
to the plain version in `ref.py`. There is no other fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import build
from . import ref

#: launches of each CUDA kernel (the plain versions count in ref.CALLS):
#: `gemv_bs`/`gemv_f`/`gemv_f_experts` one per call (the last for f32
#: stacks, `gemv_f_experts_mma` for bf16 ones), `*_fold` the second launch
#: of a call whose reduction is split over blocks
LAUNCHES = {"gemv_bs": 0, "gemv_f": 0, "gemv_f_experts": 0,
            "gemv_f_experts_mma": 0, "gemv_bs_fold": 0, "gemv_f_fold": 0,
            "gemv_f_experts_fold": 0, "gemv_f_experts_mma_fold": 0}

MAX_BN = 512   # bn the kernels take (16 words per reduction tile)
MAX_BITS = 8

# The kernels' blocking (csrc/bitplane_gemv.cu): a block owns a strip of
# STRIP output columns, ROWS batch rows and at most MAX_TILES_PER_BLOCK
# consecutive reduction tiles.
STRIP = 128
ROWS = 4
MAX_TILES_PER_BLOCK = 8
#: blocks a launch aims for on each SM (chosen, not tuned on the card)
BLOCKS_PER_SM = 4
#: members of a by-value table (B2's group launch)
MAX_MEMBERS = 8
#: the bf16 expert stack's kernel: batch rows of a block (two 8-row
#: n-tiles of mma.m16n8k16), experts a launch scans for rows, and the
#: weight zero points it takes (bf16 (128 + zero) exact)
MMA_ROWS = 16
MAX_EXPERTS_MMA = 256
MAX_ZERO_MMA = 128


class Member(ctypes.Structure):
    """One weight matrix of a launch, field for field the CUDA source's
    `Member`: pointers to its activations `a`, planes, tile scales and
    output; element strides (planes: between planes, tiles and words;
    activations: between batch rows and tiles; scales between tiles; output
    between rows); its first workspace column `col`, columns `m`, live
    `words`, `tiles`, `bn`, `q`, code `mask`, zero points `z_a` and `zero`,
    first strip `strip0` of the launch and whether 16-byte loads are
    allowed (`vec`)."""

    _fields_ = ([(f, ctypes.c_void_p) for f in ("a", "planes", "scales",
                                                 "out")]
                + [(f, ctypes.c_longlong) for f in (
                    "a_row", "a_tile", "plane_stride", "tile_stride")]
                + [(f, ctypes.c_int) for f in (
                    "word_stride", "scale_stride", "out_row", "col", "m",
                    "words", "tiles", "bn", "q", "mask", "z_a", "zero",
                    "strip0", "vec", "pad0", "pad1")])


class Table(ctypes.Structure):
    """The by-value member table of a group launch (the CUDA `Table`)."""

    _fields_ = [("m", Member * MAX_MEMBERS), ("n", ctypes.c_int),
                ("pad", ctypes.c_int)]


def split_plan(tiles: int, m: int, b: int, sms: int, experts: int = 1,
               live: Optional[int] = None, rows_per_block: int = ROWS
               ) -> tuple:
    """(tiles_per_block, splits): how a launch splits the reduction tiles
    of every column strip over blocks. Enough splits that the grid reaches
    BLOCKS_PER_SM blocks on each of the card's `sms` SMs, unless there are
    fewer tiles than that; at most MAX_TILES_PER_BLOCK tiles a block;
    splits = ceil(tiles / tiles_per_block). With one split a block owns
    every tile and writes the output itself; with more, a second launch
    folds a workspace. A stack of `experts` matrices counts the strips of
    the `live` experts that can have rows (all of them by default); a block
    takes `rows_per_block` of the b batch rows."""
    live = experts if live is None else live
    if min(tiles, m, b, sms, experts, live, rows_per_block) < 1 \
            or live > experts:
        raise ValueError(f"split_plan: tiles={tiles}, m={m}, b={b}, "
                         f"sms={sms}, experts={experts}, live={live}, "
                         f"rows_per_block={rows_per_block} must be >= 1 "
                         f"(live <= experts)")
    per_split = live * -(-m // STRIP) * -(-b // rows_per_block)
    want = min(tiles, -(-BLOCKS_PER_SM * sms // per_split))
    tpb = min(tiles // want, MAX_TILES_PER_BLOCK)
    return tpb, -(-tiles // tpb)


def workspace_shape(kind: str, tiles: int, splits: int, b: int,
                    m: int) -> tuple:
    """Shape of the workspace a launch folds (empty with one split):
    gemv_bs keeps each tile's exact int32 correction, (tiles, B, M), so
    that the fold runs the f32 epilogue in tile order; gemv_f each split's
    f32 partial, (splits, B, M)."""
    if splits == 1:
        return (0,)
    return (tiles, b, m) if kind == "gemv_bs" else (splits, b, m)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_inputs(what: str, a, planes, scale_tiles, a_dtype, *, q: int,
                 bn: int, bits: tuple = (),
                 strided_scales: bool = False) -> None:
    """Device, dtype, shape and contiguity checks shared by the wrappers.
    `strided_scales`: the launch reads the scales through strides (the
    stacked one), so they need a unit column stride only."""
    dev = a.device
    for name, t, dt in (("activations", a, a_dtype),
                        ("planes", planes, torch.int32),
                        ("scales", scale_tiles, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, activations "
                             f"on {dev}")
        if t.dtype != dt:
            raise ValueError(f"{what}: {name} must be {dt}, got {t.dtype}")
        if not (t.is_contiguous() or (name == "scales" and strided_scales
                                      and t.stride(-1) == 1)):
            raise ValueError(f"{what}: {name} must be contiguous")
    if bn % 32 or not 32 <= bn <= MAX_BN:
        raise ValueError(f"{what}: bn={bn} must be a multiple of 32 in "
                         f"[32, {MAX_BN}]")
    for name, v in (("q", q),) + bits:
        if not 1 <= v <= MAX_BITS:
            raise ValueError(f"{what}: {name}={v} outside [1, {MAX_BITS}]")


def _check_gemv(what, a, planes, scale_tiles, q, bn):
    b, n = a.shape
    m = planes.shape[-1]
    words = planes.shape[1] if planes.ndim == 3 else -1
    if n % bn or planes.ndim != 3 or planes.shape[0] != q \
            or not (n - bn) // 32 < words <= n // 32:
        raise ValueError(f"{what}: planes {tuple(planes.shape)} do not fit "
                         f"q={q} and activations padded to N={n} (bn={bn})")
    if tuple(scale_tiles.shape) != (n // bn, m):
        raise ValueError(f"{what}: scales {tuple(scale_tiles.shape)} != "
                         f"{(n // bn, m)}")
    return b, n, words, m


def gemv_bs(a_codes, planes, scale_tiles, *, q: int, p: int, z_a: int,
            z_w: int, bn: int, fidelity: str = "code") -> torch.Tensor:
    """a_codes (B, N) uint8 padded to a multiple of bn with z_a; planes
    (q, W, M) int32, the leaf's own, W = ceil(n/32) words (the kernel reads
    words past W as zero bits); scale_tiles (N/bn, M) f32 → (B, M) f32,
    un-activation-scaled. `fidelity` picks the plain version's schedule;
    the kernel always runs the bit-serial one (identical integers)."""
    if fidelity not in ("code", "bitserial"):
        raise ValueError(
            f"fidelity must be 'code' or 'bitserial', got {fidelity!r} "
            f"(a_codes shape {tuple(a_codes.shape)})")
    if not a_codes.is_cuda:
        return ref.gemv_bs_ref(a_codes, planes, scale_tiles, q=q, p=p,
                               z_a=z_a, z_w=z_w, bn=bn, fidelity=fidelity)
    _check_inputs("gemv_bs", a_codes, planes, scale_tiles, torch.uint8, q=q,
                 bn=bn, bits=(("p", p),))
    b, n, words, m = _check_gemv("gemv_bs", a_codes, planes, scale_tiles,
                                 q, bn)
    tiles = n // bn
    tpb, splits = split_plan(tiles, m, b, _sms(a_codes.device))
    out = torch.empty((b, m), dtype=torch.float32, device=a_codes.device)
    ws = torch.empty(workspace_shape("gemv_bs", tiles, splits, b, m),
                     dtype=torch.int32, device=a_codes.device)
    lib = build.library("bitplane_gemv")
    LAUNCHES["gemv_bs"] += 1
    LAUNCHES["gemv_bs_fold"] += int(splits > 1)
    build.check(lib.gemv_bs_launch(
        a_codes.data_ptr(), planes.data_ptr(), scale_tiles.data_ptr(),
        out.data_ptr(), ws.data_ptr() if splits > 1 else None, b, n, words,
        m, q, p, z_a, z_w, bn, tpb, splits, _stream()), "gemv_bs")
    return out


def gemv_f(a, planes, scale_tiles, *, q: int, zero: int,
           bn: int) -> torch.Tensor:
    """a (B, N) f32 padded to a multiple of bn with 0; planes and
    scale_tiles as `gemv_bs` → (B, M) f32."""
    if not a.is_cuda:
        return ref.gemv_f_ref(a, planes, scale_tiles, q=q, zero=zero, bn=bn)
    _check_inputs("gemv_f", a, planes, scale_tiles, torch.float32, q=q,
                 bn=bn)
    b, n, words, m = _check_gemv("gemv_f", a, planes, scale_tiles, q, bn)
    tiles = n // bn
    tpb, splits = split_plan(tiles, m, b, _sms(a.device))
    out = torch.empty((b, m), dtype=torch.float32, device=a.device)
    ws = torch.empty(workspace_shape("gemv_f", tiles, splits, b, m),
                     dtype=torch.float32, device=a.device)
    lib = build.library("bitplane_gemv")
    LAUNCHES["gemv_f"] += 1
    LAUNCHES["gemv_f_fold"] += int(splits > 1)
    build.check(lib.gemv_f_launch(
        a.data_ptr(), planes.data_ptr(), scale_tiles.data_ptr(),
        out.data_ptr(), ws.data_ptr() if splits > 1 else None, b, n, words,
        m, q, zero, bn, tpb, splits, _stream()), "gemv_f")
    return out


def gemv_f_experts(a, planes, scale_tiles, counts=None, *, q: int,
                   zero: int, bn: int,
                   live: Optional[int] = None) -> torch.Tensor:
    """B3 over a stack of E experts in ONE launch over all experts'
    strips: (E, R, M) f32, expert e's rows through expert e's planes.

    a: (E, R, N) f32 padded to a multiple of bn with 0 (B3's block body,
    `experts_kernel`), or (E, R, N) bf16 unpadded, read in place on the
    tensor cores (`experts_mma_kernel`; N is bw.n). planes (E, q, W, M)
    int32 (each expert's leaf planes, W = ceil(N/32)); scale_tiles (E,
    tiles, M) f32 with unit column stride (a stride-0 view over the tiles
    of per-channel scales is read as it is); counts (E,) int32 or None.
    Rows at and past counts[e] are taken as zero: the kernel writes their
    outputs as zero without reading them. `live` (bf16 stacks, with
    counts): at most that many experts have rows (the caller's bound, e.g.
    min(E, tokens · top_k)); the grid walks that many expert slots and the
    split plan counts only their strips."""
    if not a.is_cuda:
        return ref.gemv_f_experts_ref(a, planes, scale_tiles, counts, q=q,
                                      zero=zero, bn=bn, live=live)
    what = "gemv_f_experts"
    if a.ndim != 3 or planes.ndim != 4 or scale_tiles.ndim != 3:
        raise ValueError(f"{what}: activations {tuple(a.shape)}, planes "
                         f"{tuple(planes.shape)}, scales "
                         f"{tuple(scale_tiles.shape)} must be 3-, 4- and "
                         f"3-dimensional")
    e, r, n = a.shape
    m = planes.shape[-1]
    if planes.shape[0] != e or scale_tiles.shape[0] != e:
        raise ValueError(f"{what}: {e} experts of activations, "
                         f"{planes.shape[0]} of planes, "
                         f"{scale_tiles.shape[0]} of scales")
    if counts is not None and (counts.device != a.device
                               or counts.dtype != torch.int32
                               or tuple(counts.shape) != (e,)
                               or not counts.is_contiguous()):
        raise ValueError(f"{what}: counts must be a contiguous ({e},) "
                         f"int32 tensor on {a.device}")
    if a.dtype == torch.bfloat16:
        return _gemv_f_experts_mma(a, planes, scale_tiles, counts, q=q,
                                   zero=zero, bn=bn, live=live)
    _check_inputs(what, a, planes, scale_tiles, torch.float32, q=q, bn=bn,
                  strided_scales=True)
    _check_gemv(what, a[0], planes[0], scale_tiles[0], q, bn)
    if e * -(-r // ROWS) > 65535:
        raise ValueError(f"{what}: {e} experts of {r} rows exceed the "
                         f"grid's 65535 row groups")
    tiles = n // bn
    tpb, splits = split_plan(tiles, m, r, _sms(a.device), experts=e)
    out = torch.empty((e, r, m), dtype=torch.float32, device=a.device)
    # each expert's split partials (E, splits, R, M), folded in split order
    ws = torch.empty((0,) if splits == 1 else (e, splits, r, m),
                     dtype=torch.float32, device=a.device)
    lib = build.library("bitplane_gemv")
    LAUNCHES["gemv_f_experts"] += 1
    LAUNCHES["gemv_f_experts_fold"] += int(splits > 1)
    build.check(lib.gemv_f_experts_launch(
        a.data_ptr(), planes.data_ptr(), scale_tiles.data_ptr(),
        out.data_ptr(), ws.data_ptr() if splits > 1 else None,
        None if counts is None else counts.data_ptr(), e, r, n,
        planes.shape[2], m, q, zero, bn, scale_tiles.stride(0),
        scale_tiles.stride(1), tpb, splits, _stream()), what)
    return out


def mma_plan(tiles: int, m: int, r: int, sms: int, experts: int,
             live: int) -> tuple:
    """(tiles_per_block, splits) of the bf16 stack's kernel: `split_plan`
    over the strips of `live` expert slots, a block taking MMA_ROWS rows."""
    return split_plan(tiles, m, r, sms, experts=experts, live=live,
                      rows_per_block=MMA_ROWS)


def _gemv_f_experts_mma(a, planes, scale_tiles, counts, *, q, zero, bn,
                        live) -> torch.Tensor:
    """`gemv_f_experts` on a bf16 (E, R, N) stack, unpadded, on the tensor
    cores: no copy of the activations."""
    what = "gemv_f_experts"
    e, r, n = a.shape
    m = planes.shape[-1]
    _check_inputs(what, a, planes, scale_tiles, torch.bfloat16, q=q, bn=bn,
                  strided_scales=True)
    words, tiles = -(-n // 32), -(-n // bn)
    if planes.shape[1:3] != (q, words):
        raise ValueError(f"{what}: planes {tuple(planes.shape)} do not fit "
                         f"q={q} and N={n} ({words} words)")
    if tuple(scale_tiles.shape[1:]) != (tiles, m):
        raise ValueError(f"{what}: scales {tuple(scale_tiles.shape)} != "
                         f"{(e, tiles, m)}")
    if not 0 <= zero <= MAX_ZERO_MMA or e > MAX_EXPERTS_MMA:
        raise ValueError(f"{what}: zero={zero} outside [0, {MAX_ZERO_MMA}] "
                         f"or {e} experts above {MAX_EXPERTS_MMA}")
    live = e if counts is None or live is None else min(live, e)
    if live < 1 or live * -(-r // MMA_ROWS) > 65535:
        raise ValueError(f"{what}: live={live} expert slots of {r} rows "
                         f"do not fit the grid")
    tpb, splits = mma_plan(tiles, m, r, _sms(a.device), e, live)
    out = torch.empty((e, r, m), dtype=torch.float32, device=a.device)
    ws = torch.empty((0,) if splits == 1 else (e, splits, r, m),
                     dtype=torch.float32, device=a.device)
    lib = build.library("experts_mma")
    LAUNCHES["gemv_f_experts_mma"] += 1
    LAUNCHES["gemv_f_experts_mma_fold"] += int(splits > 1)
    build.check(lib.gemv_f_experts_mma_launch(
        a.data_ptr(), planes.data_ptr(), scale_tiles.data_ptr(),
        out.data_ptr(), ws.data_ptr() if splits > 1 else None,
        None if counts is None else counts.data_ptr(), e, r, n, words, m, q,
        zero, bn, scale_tiles.stride(0), scale_tiles.stride(1), live, tpb,
        splits, _stream()), what)
    return out
