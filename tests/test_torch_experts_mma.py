"""B3 over an expert stack with bf16 activations: the arithmetic of the
tensor-core kernel (`csrc/experts_mma.cu` `experts_mma_kernel`) replayed
on the CPU, its plain version, its split plan over the experts a step can
route, and `_expert_mm` on a bf16 stack, against the JAX package.

The replay builds every weight value the way a lane does (byte t of each
plane word, one nibble a k16 chunk spread into bytes by a multiply, the
bytes turned into bf16 128 + c by a byte permute and into c − zero by a
bf16 subtraction; q = 8 with its top bit added back by an fma), pairs each
lane's bytes with the activations its 16-byte load gives the same k-slots,
rounds each mma's sum once to f32, multiplies each warp item's sum (its
1–2 words) by its tile scale, adds the warps in warp order and the splits
in split order. It is held against the plain version and against the JAX
package's `gemv_f_pallas` in interpret mode under `jax.vmap`, at B3's
tolerance (rtol 1e-5, atol 1e-5·max|ref|, tests/test_kernels.py): the
products a·(c − zero) are exact in f32 (checked here for every bf16 value
and every q ≤ 8 code), so only the order of the sums differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitplane_gemv import ops as jops
from repro.models import moe as jmoe
from repro_torch.kernels.bitplane_gemv import kernel as tkernel
from repro_torch.kernels.bitplane_gemv import ops as tops
from repro_torch.kernels.bitplane_gemv import ref as tref
from repro_torch.models import moe as tmoe
from test_torch_model import fresh_jax_caches  # noqa: F401
from test_torch_moe import _expert_stack

MASK32 = 0xFFFFFFFF
SMS = 132                  # the H100 SXM's SMs (the plan's card)


def _b3_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _bf16(x) -> np.ndarray:
    """float32 values rounded to bf16 (round to nearest even), as f32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _bf16_bits(bits) -> np.ndarray:
    """bf16 bit patterns (uint) → their values as f32."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def _lane_codes(words, q: int, t: int):
    """words (q, ...) uint32 plane words → lane t's two code words (k16
    chunk 0 and 1): byte b of chunk kc holds the q-bit code of bit
    8t + 4kc + b, built as the kernel builds it (the word shifted by 8t,
    one nibble a chunk spread into bytes by a multiply per plane)."""
    w = words.astype(np.uint64) >> np.uint64(8 * t)
    c0 = np.zeros(w.shape[1:], np.uint64)
    c1 = np.zeros_like(c0)
    for i in range(q):
        mul = np.uint64(0x00204081 << i)
        c0 |= ((w[i] & np.uint64(0xF)) * mul & np.uint64(MASK32)) \
            & np.uint64(0x01010101 << i)
        if q <= 4:      # bits 4..7 spread to 4 + 8k + i, shifted down after
            c1 |= ((w[i] & np.uint64(0xF0)) * mul & np.uint64(MASK32)) \
                & np.uint64(0x10101010 << i)
        else:
            c1 |= (((w[i] >> np.uint64(4)) & np.uint64(0xF)) * mul
                   & np.uint64(MASK32)) & np.uint64(0x01010101 << i)
    if q <= 4:
        c1 >>= np.uint64(4)
    return c0, c1


def _byte_values(c, q: int, zero: int) -> list:
    """The 4 bytes of code words c → c_b − zero as the kernel's bf16 steps
    give them (each step rounded to bf16, which must leave it exact)."""
    bias = np.float32(128 + zero)
    assert _bf16(bias) == bias
    out = []
    for b in range(4):
        byte = (c >> np.uint64(8 * b)) & np.uint64(0xFF)
        if q <= 7:
            v = _bf16(_bf16_bits(0x4300 | byte) - bias)
        else:
            lo = _bf16(_bf16_bits(0x4300 | (byte & np.uint64(0x7F))) - bias)
            hi = _bf16(_bf16_bits(0x4300 | (byte >> np.uint64(7)))
                       - np.float32(128))
            v = _bf16(hi * np.float32(128) + lo)
        out.append(v)
    return out


def _lane_values(words, q: int, zero: int) -> np.ndarray:
    """(q, W, M) plane words → (W, 2, 16, M): each word's A values of k16
    chunk kc, k-slot 4t + b being byte b of lane t's code word."""
    _, nw, m = words.shape
    vals = np.zeros((nw, 2, 4, 4, m), np.float32)
    for t in range(4):
        for kc, c in enumerate(_lane_codes(words, q, t)):
            for b, v in enumerate(_byte_values(c, q, zero)):
                vals[:, kc, t, b] = v
    return vals.reshape(nw, 2, 16, m)


def _lane_rows(kc: int) -> list:
    """The reduction rows (within a word) of chunk kc's k-slots 4t + b:
    the elements of lane t's 16-byte load (rows 8t .. 8t + 7 of the word)
    that `mma_bf16` takes for chunk kc, 8t + 4kc + b."""
    return [8 * t + 4 * kc + b for t in range(4) for b in range(4)]


def _weight_values(words, q: int, zero: int) -> np.ndarray:
    """(q, W, M) plane words → (32·W, M) f32 values c − zero of every
    reduction row, assembled lane by lane as the kernel does."""
    lanes = _lane_values(words, q, zero)
    vals = np.zeros((lanes.shape[0], 32, lanes.shape[-1]), np.float32)
    for kc in (0, 1):
        vals[:, _lane_rows(kc)] = lanes[:, kc]
    return vals.reshape(-1, lanes.shape[-1])


def _replay(a, planes, scale_t, counts, *, q, zero, bn, live):
    """The tensor-core kernel's arithmetic on (E, R, N) bf16-valued f32
    activations: (E, R, M) f32."""
    e_n, r_n, n = a.shape
    m = planes.shape[-1]
    nw, tiles = -(-n // 32), -(-n // bn)
    wpt = bn // 32
    u_max = 2 if q <= 4 else 1            # words of a warp item
    upt = -(-wpt // u_max)
    tpb, splits = tkernel.mma_plan(tiles, m, r_n, SMS, e_n, live)
    words = planes.numpy().view(np.uint32)
    out = np.zeros((e_n, r_n, m), np.float32)
    for e in range(e_n):
        rows = r_n if counts is None else min(int(counts[e]), r_n)
        if rows <= 0:
            continue
        lanes = _lane_values(words[e], q, zero)
        x = np.zeros((rows, nw * 32), np.float32)
        x[:, :n] = a[e, :rows]
        parts = []
        for s in range(splits):
            warp = np.zeros((8, rows, m), np.float32)
            for tl in range(min(tpb, tiles - s * tpb)):
                tt = s * tpb + tl
                for it in range(upt):       # U words of tile tt an item
                    w0 = tt * wpt + it * u_max
                    nlive = min(u_max, wpt - it * u_max, nw - w0)
                    if nlive <= 0:
                        continue
                    d = np.zeros((rows, m), np.float32)  # a fresh chain
                    for w in range(w0, w0 + nlive):
                        for kc in (0, 1):
                            ks = [32 * w + k for k in _lane_rows(kc)]
                            prod = x[:, ks].astype(np.float64) \
                                @ lanes[w, kc].astype(np.float64)
                            d = (d + prod).astype(np.float32)  # one mma
                    wg = (tl * upt + it) % 8
                    sc = scale_t[e, tt].numpy().astype(np.float64)
                    warp[wg] = (d * sc + warp[wg]).astype(np.float32)
            block = warp[0]
            for w in range(1, 8):
                block = block + warp[w]
            parts.append(block)
        y = parts[0]
        for p in parts[1:]:
            y = y + p
        out[e, :rows] = y
    return out


def _jax_vmap(xb, jw):
    """JAX's `_expert_mm` inner call: B3 in interpret mode under jax.vmap
    over the experts, on the bf16 stack, f32 out."""
    return np.asarray(jax.vmap(lambda xx, ww: jops.bitplane_gemv(
        xx, ww, impl="pallas_interpret"))(xb, jw))


def _bf16_stack(rng, e, r, n, counts):
    x = _bf16(rng.normal(size=(e, r, n)))
    if counts is not None:                       # dispatched rows only
        x[np.arange(r)[None, :] >= np.asarray(counts)[:, None]] = 0.0
    return x


@pytest.mark.parametrize("q", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("e,r,n,m,counts", [
    (4, 6, 300, 90, [6, 0, 2, 4]), (3, 8, 1000, 40, None)])
def test_replay_of_the_mma_arithmetic_matches_plain_and_jax(rng, q, e, r,
                                                            n, m, counts):
    jw, tw = _expert_stack(rng, e, n, m, q)
    x = _bf16_stack(rng, e, r, n, counts)
    bn, _ = tops._pick_blocks(n, m, None, None, None)
    tiles = -(-n // bn)
    scale_t = tw.scale.expand(e, tiles, m)
    ct = None if counts is None else torch.tensor(counts, dtype=torch.int32)
    live = e if counts is None else sum(c > 0 for c in counts)
    got = _replay(x, tw.planes, scale_t, ct, q=q, zero=tw.zero, bn=bn,
                  live=live)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    plain = tref.gemv_f_experts_ref(xt, tw.planes, scale_t, ct, q=q,
                                    zero=tw.zero, bn=bn, live=live)
    _b3_close(got, plain.numpy())
    _b3_close(got, _jax_vmap(jnp.asarray(x, jnp.bfloat16), jw))
    if counts is not None:
        for i, c in enumerate(counts):
            assert not got[i, c:].any()


@pytest.mark.parametrize("q", [1, 2, 3, 4, 5, 6, 7, 8])
def test_lane_codes_are_the_planes_codes(rng, q):
    """The kernel's byte layout gives every reduction row's code exactly,
    and its bf16 steps give c − zero exactly, for every q ≤ 8."""
    codes = rng.integers(0, 1 << q, size=(64, 7))
    planes = np.zeros((q, 2, 7), np.uint32)
    for i in range(q):
        bits = ((codes >> i) & 1).astype(np.uint64).reshape(2, 32, 7)
        planes[i] = (bits << np.arange(32, dtype=np.uint64)[None, :, None]
                     ).sum(1).astype(np.uint32)
    zero = 1 << (q - 1)
    np.testing.assert_array_equal(_weight_values(planes, q, zero),
                                  (codes - zero).astype(np.float32))


def test_every_bf16_times_every_code_is_exact_in_f32():
    """a·(c − zero) for every finite bf16 a and every c − zero of q ≤ 8
    (|c − zero| ≤ 255) is exact in f32 wherever it lies in f32's range:
    the tensor cores' products are those of JAX's f32-HIGHEST dot."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    a = _bf16_bits(bits)
    a = a[np.isfinite(a)].astype(np.float64)
    fmax = float(np.finfo(np.float32).max)
    for v in range(-255, 256):
        exact = a * v                                 # exact in float64
        with np.errstate(over="ignore"):              # outside f32: inf
            f32 = (a.astype(np.float32) * np.float32(v)).astype(np.float64)
        inside = np.abs(exact) <= fmax
        np.testing.assert_array_equal(f32[inside], exact[inside])


def test_live_plan_fills_the_card_at_decode():
    """qwen2-moe's stacks at a 4-lane decode step (at most 16 of 64
    experts with rows, 8 capacity rows, one 16-row block) split their 4
    and 3 reduction tiles until the grid reaches BLOCKS_PER_SM blocks on
    each of 132 SMs; at full capacity (live = 64) one split; live =
    experts is the plan without `live`."""
    want = tkernel.BLOCKS_PER_SM * SMS
    for tiles, m in ((4, 1408), (3, 2048)):
        tpb, splits = tkernel.mma_plan(tiles, m, 8, SMS, 64, 16)
        assert 16 * -(-m // tkernel.STRIP) * splits >= want
        assert splits > 1 and tpb * splits >= tiles
        assert tkernel.mma_plan(tiles, m, 8, SMS, 64, 64) == (tiles, 1)
        for b in (4, 8, 64):
            assert tkernel.split_plan(tiles, m, b, SMS, experts=64,
                                      live=64) == \
                tkernel.split_plan(tiles, m, b, SMS, experts=64)
    with pytest.raises(ValueError, match="live"):
        tkernel.split_plan(4, 1408, 8, SMS, experts=4, live=5)


def test_expert_mm_on_a_bf16_stack_matches_jax(rng):
    """`_expert_mm` on a bf16 (Ex, R, din) stack: its f32 GeMV (before the
    cast back to bf16) at B3's tolerance against JAX's vmap of B3 in
    interpret mode; its bf16 result is that GeMV cast, and within one
    bf16 rounding of JAX's `_expert_mm`."""
    ex, g, c, n, m, q = 8, 1, 8, 300, 90, 4
    jw, tw = _expert_stack(rng, ex, n, m, q)
    counts = [3, 0, 8, 1, 0, 0, 2, 5]
    x = _bf16_stack(rng, ex, g * c, n, counts)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ct = torch.tensor(counts, dtype=torch.int32)
    f32 = tops.bitplane_gemv(xt, tw, counts=ct, live=6)
    _b3_close(f32.numpy(), _jax_vmap(jnp.asarray(x, jnp.bfloat16), jw))
    got = tmoe._expert_mm(xt, tw, None, ct, 6)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))
    want = np.asarray(jmoe._expert_mm(
        jnp.asarray(x, jnp.bfloat16)[None], jw, "pallas_interpret")
        .astype(jnp.float32))[0]
    gf = got.float().numpy()
    assert (np.abs(gf - want)
            <= 2.0 ** -7 * np.maximum(np.abs(gf), np.abs(want))
            + 1e-5 * np.abs(want).max()).all()


def test_bf16_stack_reaches_the_plain_version_unpadded(rng):
    """On CPU tensors a bf16 stack goes to the plain version as it is
    (unpadded), which widens and pads it; more experts with rows than
    `live` is refused."""
    _, tw = _expert_stack(rng, 3, 300, 40, 2)
    x = torch.from_numpy(_bf16_stack(rng, 3, 4, 300, None)).to(
        torch.bfloat16)
    seen = []
    real = tref.gemv_f_experts_ref

    def spy(a, *args, **kw):
        seen.append((a.dtype, tuple(a.shape)))
        return real(a, *args, **kw)

    tref.gemv_f_experts_ref = spy
    try:
        out = tops.bitplane_gemv(x, tw)
    finally:
        tref.gemv_f_experts_ref = real
    assert seen == [(torch.bfloat16, (3, 4, 300))]
    _b3_close(out.numpy(), tops.bitplane_gemv(x.float(), tw).numpy())
    with pytest.raises(ValueError, match="live"):
        tops.bitplane_gemv(x, tw, counts=torch.tensor(
            [1, 2, 3], dtype=torch.int32), live=2)
