"""Host-side plan of the flash-decode kernel B4 (`kernels/decode_attention/
kernel.py`): how each lane's cache splits into ranges of slots over blocks,
and the workspace the fold of the splits takes. These run on the CPU; the
kernel itself runs only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).

The last tests replay the kernel's arithmetic (csrc/decode_attention.cu)
in plain PyTorch: per (lane, KV head) and split, the softmax of the g query
heads over the split's valid slots in base 2 (scores times log2 e), kept as
(m, l, acc), then the fold online in split order ((M, L, A) rescaled by
2^(M − M') for each split's M' = max(M, m_s), out = A / L), and for a lane
none of whose splits has a valid slot each split's Σ v over its range,
added in split order, / s_pad. That must agree with the plain version and with JAX's
`decode_attention` in interpret mode at rtol/atol 1e-5: it checks the
algebra of the split and the fold, not the CUDA code.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jops
from repro_torch.kernels.decode_attention import kernel, ref
from test_torch_decode_attention import TOL, _cache
from test_torch_model import fresh_jax_caches  # noqa: F401

H100_SMS = 132   # SMs of an H100 SXM, the card the plan is written for
LOG2E = 1.4426950408889634


def _chip_smoke_shapes():
    """chip_smoke.py's B4 shapes (B, S, Hkv), read from the script."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [(name, b, s, hkv) for name, b, s, _, hkv, *_ in
            mod.DECODE_SHAPES]


CHIP_SHAPES = _chip_smoke_shapes()


@pytest.mark.parametrize("name,b,s,hkv", CHIP_SHAPES,
                         ids=[c[0] for c in CHIP_SHAPES])
def test_plan_at_every_chip_smoke_shape(name, b, s, hkv):
    """One wave of blocks (at most BLOCKS_PER_SM on each SM) unless a range
    would fall below MIN_CHUNK slots; ranges of whole 32-slot ballot words
    that cover the cache once."""
    chunk, splits = kernel.decode_plan(b, s, hkv, H100_SMS)
    assert chunk % kernel.CHUNK_ALIGN == 0 and chunk <= kernel.MAX_CHUNK
    assert (splits - 1) * chunk < s <= splits * chunk
    blocks = splits * hkv * b
    assert blocks <= kernel.BLOCKS_PER_SM * H100_SMS \
        or splits == -(-s // kernel.MAX_CHUNK)
    assert blocks >= min(kernel.BLOCKS_PER_SM * H100_SMS // 2,
                         -(-s // kernel.MIN_CHUNK) * hkv * b)


def test_plan_on_the_main_paths():
    """4096 slots: llama2-7b (32 KV heads) at B = 4 and 1, qwen2-7b (4) at
    B = 4 and 1, starcoder2-3b (2) at B = 4: 512, 512, 512, 128 and 256
    blocks."""
    got = {(b, hkv): kernel.decode_plan(b, 4096, hkv, H100_SMS)
           for b, hkv in ((4, 32), (1, 32), (4, 4), (1, 4), (4, 2))}
    assert got == {(4, 32): (1024, 4), (1, 32): (256, 16),
                   (4, 4): (128, 32), (1, 4): (128, 32), (4, 2): (128, 32)}
    with pytest.raises(ValueError, match="s=0"):
        kernel.decode_plan(1, 0, 1, H100_SMS)


@pytest.mark.parametrize("b,hkv", [(1, 1), (4, 32), (2, 8), (1, 4)])
def test_plan_covers_every_cache_length(b, hkv):
    """For every S from 1 to 4096: at least one split, the ranges cover the
    slots once, none above MAX_CHUNK."""
    for s in range(1, 4097):
        chunk, splits = kernel.decode_plan(b, s, hkv, H100_SMS)
        assert splits >= 1 and chunk <= kernel.MAX_CHUNK
        assert (splits - 1) * chunk < s <= splits * chunk, (s, chunk, splits)


@pytest.mark.parametrize("splits,want", [
    (1, ((0,), (0,))), (4, ((4, 32, 4, 1, 128), (4, 32, 4, 1, 2))),
    (32, ((4, 4, 32, 7, 128), (4, 4, 32, 7, 2)))])
def test_workspace_shapes(splits, want):
    hkv, g = (32, 1) if splits < 32 else (4, 7)
    assert kernel.workspace_shapes(4, hkv, splits, g, 128) == want


def _replay(pos, q, k, v, stamps, ks, vs, *, scale, window):
    """The kernel's split and fold in plain float32 PyTorch (see the module
    docstring), at the plan for an H100."""
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    chunk, splits = kernel.decode_plan(b, s, hkv, H100_SMS)
    kf, vf = k.float(), v.float()
    if ks is not None:
        kf, vf = kf * ks[..., None], vf * vs[..., None]
    ok = ref.slot_mask(pos, stamps, window)
    out = torch.empty((b, h, d))
    for lane in range(b):
        for hk in range(hkv):
            qh = q[lane, hk * g:(hk + 1) * g].float()            # (g, D)
            parts = []
            for sp in range(splits):
                idx = torch.nonzero(ok[lane, sp * chunk:(sp + 1) * chunk]
                                    )[:, 0] + sp * chunk
                if len(idx) == 0:                 # l = 0: weighs nothing
                    parts.append(None)
                    continue
                sc = qh @ kf[lane, idx, hk].T * (scale * LOG2E)   # base 2
                m = sc.max(1).values
                p = torch.exp2(sc - m[:, None])
                parts.append((m, p.sum(1), p @ vf[lane, idx, hk]))
            if all(pt is None for pt in parts):   # the lane's mean of v
                total = torch.zeros(d)
                for sp in range(splits):          # each split's range sum
                    total += vf[lane, sp * chunk:(sp + 1) * chunk, hk
                                ].sum(0)
                out[lane, hk * g:(hk + 1) * g] = total / ref.padded_slots(s)
                continue
            big = torch.full((g,), -torch.inf)
            acc = torch.zeros((g, d))
            den = torch.zeros(g)
            for pt in parts:                      # online, in split order
                if pt is None:
                    continue
                m_new = torch.maximum(big, pt[0])
                fa, fb = torch.exp2(big - m_new), torch.exp2(pt[0] - m_new)
                acc = acc * fa[:, None] + pt[2] * fb[:, None]
                den = den * fa + pt[1] * fb
                big = m_new
            out[lane, hk * g:(hk + 1) * g] = acc / den[:, None]
    return out


def _stamps(b, s, fill):
    """(pos, stamps) numpy: every slot valid, a wrapped ring, lane 0's valid
    slots all in the first split, or lane 1 without a valid slot."""
    t = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    pos = np.full(b, s - 1, np.int32)
    if fill == "ring":
        pos = (np.arange(b, dtype=np.int32) * 41 + 2 * s + 7)
        t = pos[:, None] - (pos[:, None] - t) % s
    elif fill == "one split":
        pos[0] = 20
        t[0] = np.where(t[0] <= 20, t[0], -1)
    elif fill == "empty":
        pos[0] = s // 2
        t[0] = np.where(t[0] <= s // 2, t[0], -1)
        t[1] = -1
    return pos, t


# (B, S, H, Hkv, D, cache, stamps, window): GQA of 1, 2, 7 and 12 query
# heads a KV head; f32, bf16 and int8 caches; S not a multiple of the
# plan's 128-slot ranges; D of the fast body and above it (320, 512)
REPLAY_CASES = [
    (2, 300, 4, 4, 128, "f32", "full", None),
    (2, 300, 4, 2, 64, "bf16", "ring", 100),
    (2, 300, 14, 2, 128, "int8", "one split", None),
    (1, 300, 12, 1, 112, "int8", "full", None),
    (2, 300, 8, 4, 16, "int8", "empty", None),
    (2, 257, 7, 1, 16, "f32", "empty", None),
    (2, 300, 4, 2, 320, "bf16", "full", None),
    (1, 200, 2, 1, 512, "f32", "ring", 64),
    (2, 1000, 4, 4, 128, "int8", "ring", 300),
]


@pytest.mark.parametrize("b,s,h,hkv,d,kv,fill,window", REPLAY_CASES)
def test_split_and_fold_replay_matches_plain_and_jax(rng, b, s, h, hkv, d,
                                                     kv, fill, window):
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    pos, stamps = _stamps(b, s, fill)
    k, v, ks, vs = _cache(rng, b, s, hkv, d, kv)
    jdt = jnp.bfloat16 if kv == "bf16" else None
    jkv = [jnp.asarray(x, jdt) if jdt else jnp.asarray(x) for x in (k, v)]
    want_jax = np.asarray(jops.decode_attention(
        jnp.asarray(pos), jnp.asarray(q), *jkv, jnp.asarray(stamps),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs), window=window,
        impl="pallas_interpret"))
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))
    tk, tv = t(k), t(v)
    if kv == "bf16":
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    args = (t(pos), t(q), tk, tv, t(stamps), t(ks), t(vs))
    kw = dict(scale=d ** -0.5, window=window)
    got = _replay(*args, **kw)
    plain = ref.decode_attention_ref(*args, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), want_jax, **TOL)
    if fill == "empty":
        vf = v.astype(np.float32) * (1.0 if vs is None else vs[..., None])
        np.testing.assert_allclose(
            got.numpy()[1],
            np.repeat(vf[1].sum(0) / ref.padded_slots(s), h // hkv, axis=0),
            **TOL)


def test_replay_splits_the_cache():
    """The replay's cases reach several splits, a ragged last one, and
    splits without a valid slot beside ones with."""
    plans = {(b, s, hkv): kernel.decode_plan(b, s, hkv, H100_SMS)
             for b, s, _, hkv, *_ in REPLAY_CASES}
    assert all(splits > 1 for _, splits in plans.values())
    assert any(s % chunk for (_, s, _), (chunk, _) in plans.items())
    assert plans[(2, 300, 2)] == (128, 3)


def test_bench_variants_edit_the_source():
    """`launch/bench_decode.py` builds each of its VARIANTS by editing the
    CUDA source: every text it replaces stands there exactly once, so each
    variant differs from the shipped build where it says."""
    from repro_torch.launch import bench_decode
    src = (Path(kernel.__file__).resolve().parents[2] / "csrc"
           / "decode_attention.cu").read_text()
    assert bench_decode.VARIANTS
    for name, edits in bench_decode.VARIANTS.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, (name, old)
