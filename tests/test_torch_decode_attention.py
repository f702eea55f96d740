"""Port parity: flash-decode attention (B4) of `repro_torch` against the JAX
package, on the same numpy inputs.

Kernel level: the port's `decode_attention` (on CPU tensors, its plain
version) against JAX `ops.decode_attention(impl="pallas_interpret")` over
the grid of tests/test_decode_kernel.py — GQA, window None/100, a bf16 or
int8 cache — at rtol/atol 1e-5 (float32 queries and outputs, the reference
test's tolerance), plus a lane with no valid slot and per-lane ring-buffer
stamps.

Model level: tiny llama2-7b (float32, 2 KV heads for 4 query heads, a
sliding-window "local" stage beside the global one) with
`Model(attn_impl="kernel")` against JAX `Model(attn_impl="kernel_interpret")`,
decode logits at rtol/atol 1e-4 (tests/test_decode_kernel.py:98), with a
float and an int8 KV cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as j_tiny_config
from repro.kernels.decode_attention import ops as jops
from repro.models.model import Model as JModel
from repro.models.model import param_defs as j_param_defs
from repro.models.params import init_params as j_init_params
from repro_torch import convert
from repro_torch.configs import tiny_config
from repro_torch.kernels.decode_attention import kernel as tkernel
from repro_torch.kernels.decode_attention import ops as tops
from repro_torch.kernels.decode_attention import ref as tref
from repro_torch.models.model import Model
from test_torch_model import fresh_jax_caches  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _cache(rng, b, s, hkv, d, kv):
    """k, v and, for int8, their scales, as numpy arrays."""
    kf = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    vf = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    if kv == "int8":
        ks = (np.abs(kf).max(-1) / 127 + 1e-8).astype(np.float32)
        vs = (np.abs(vf).max(-1) / 127 + 1e-8).astype(np.float32)
        return (np.round(kf / ks[..., None]).astype(np.int8),
                np.round(vf / vs[..., None]).astype(np.int8), ks, vs)
    # bf16 values, held as float32 numpy arrays (exact)
    bf = lambda x: np.array(jnp.asarray(x, jnp.bfloat16).astype(
        jnp.float32))
    return bf(kf), bf(vf), None, None


def _both(pos, q, k, v, stamps, ks, vs, kv, window):
    """The JAX kernel in interpret mode and the port's entry point (CPU
    tensors: its plain version) on the same inputs."""
    jdt = jnp.bfloat16 if kv == "bf16" else None
    jk, jv = ((jnp.asarray(k, jdt), jnp.asarray(v, jdt)) if jdt
              else (jnp.asarray(k), jnp.asarray(v)))
    jargs = (jnp.asarray(pos), jnp.asarray(q), jk, jv, jnp.asarray(stamps),
             None if ks is None else jnp.asarray(ks),
             None if vs is None else jnp.asarray(vs))
    want = jops.decode_attention(*jargs, window=window,
                                 impl="pallas_interpret", block=128)
    tdt = torch.bfloat16 if kv == "bf16" else None
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))
    tk, tv = t(k), t(v)
    if tdt:
        tk, tv = tk.to(tdt), tv.to(tdt)
    got = tops.decode_attention(t(pos), t(q), tk, tv, t(stamps), t(ks),
                                t(vs), window=window)
    return got, np.asarray(want)


@pytest.mark.parametrize("b,s,h,hkv,d", [(2, 256, 8, 4, 64),
                                         (1, 512, 4, 4, 32),
                                         (2, 384, 8, 1, 128)])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_attention_matches_pallas_interpret(rng, b, s, h, hkv, d,
                                                   window, kv):
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    pos = np.int32(s // 2 + 3)
    stamps = np.where(np.arange(s) <= s // 2 + 3, np.arange(s),
                      -1).astype(np.int32)
    k, v, ks, vs = _cache(rng, b, s, hkv, d, kv)
    got, want = _both(pos, q, k, v, stamps, ks, vs, kv, window)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_lane_with_no_valid_slot_averages_v(rng, kv):
    """Every score of lane 1 is the finite NEG_INF: each slot weighs 1 and
    the lane gets the mean of v, in both packages (not NaN)."""
    b, s, h, hkv, d = 2, 256, 4, 2, 32
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    pos = np.array([200, 50], np.int32)
    stamps = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    stamps[1] = -1
    k, v, ks, vs = _cache(rng, b, s, hkv, d, kv)
    got, want = _both(pos, q, k, v, stamps, ks, vs, kv, None)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    vf = v.astype(np.float32) * (1.0 if vs is None else vs[..., None])
    np.testing.assert_allclose(got.numpy()[1],
                               np.repeat(vf[1].mean(0), h // hkv, axis=0),
                               **TOL)


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_empty_lane_divides_by_the_padded_slot_count(rng, kv, impl):
    """S = 1500 is not a multiple of the JAX wrapper's block (1024): it pads
    the cache to 2048 slots of zero v and stamp -1, and a lane with no
    valid slot weighs all 2048 alike. The port gives that lane Σ v / 2048
    too, with no padding copy; the lane with valid slots is unchanged."""
    b, s, h, hkv, d = 2, 1500, 4, 2, 32
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    pos = np.array([1200, 700], np.int32)
    stamps = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    stamps[1] = -1
    k, v, ks, vs = _cache(rng, b, s, hkv, d, kv)
    jargs = [jnp.asarray(x) for x in (pos, q, k, v, stamps)]
    want = np.asarray(jops.decode_attention(
        *jargs, None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs), impl=impl))
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))
    got = tops.decode_attention(t(pos), t(q), t(k), t(v), t(stamps), t(ks),
                                t(vs)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    vf = v.astype(np.float32) * (1.0 if vs is None else vs[..., None])
    np.testing.assert_allclose(
        got[1], np.repeat(vf[1].sum(0) / 2048, h // hkv, axis=0), **TOL)
    assert tref.padded_slots(s) == 2048


@pytest.mark.parametrize("window", [None, 64])
def test_ring_buffer_per_lane_positions(rng, window):
    """Per-lane positions, and stamps of a ring buffer that has wrapped:
    slot t holds the newest position ≡ t mod S."""
    b, s, h, hkv, d = 3, 128, 4, 4, 64
    pos = np.array([300, 127, 40], np.int32)
    stamps = np.full((b, s), -1, np.int32)
    for lane, p in enumerate(pos):
        for t in range(max(0, p - s + 1), p + 1):
            stamps[lane, t % s] = t
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k, v, ks, vs = _cache(rng, b, s, hkv, d, "int8")
    got, want = _both(pos, q, k, v, stamps, ks, vs, "int8", window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_queries_round_like_jax(rng):
    """A bf16 query gives a bf16 output: the two packages' float32 results
    may round to neighbouring bf16 values, so they agree to one bf16 ulp."""
    b, s, h, d = 2, 256, 4, 64
    qf = rng.normal(size=(b, h, d)).astype(np.float32)
    k, v, _, _ = _cache(rng, b, s, h, d, "bf16")
    stamps = np.arange(s, dtype=np.int32)
    want = np.asarray(jops.decode_attention(
        jnp.int32(s - 1), jnp.asarray(qf, jnp.bfloat16),
        jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
        jnp.asarray(stamps), impl="pallas_interpret",
        block=128).astype(jnp.float32))
    got = tops.decode_attention(
        s - 1, torch.from_numpy(qf).to(torch.bfloat16),
        torch.from_numpy(k).to(torch.bfloat16),
        torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(stamps))
    assert got.dtype == torch.bfloat16
    g = got.to(torch.float32).numpy()
    ulp = 2.0 ** -7 * np.maximum(np.abs(g), np.abs(want))
    assert (np.abs(g - want) <= ulp + 1e-6).all()


def test_cpu_tensors_run_the_plain_version(rng):
    q = torch.randn(1, 4, 32)
    k = torch.randn(1, 16, 4, 32)
    l0, c0 = dict(tkernel.LAUNCHES), dict(tref.CALLS)
    tops.decode_attention(3, q, k, k, torch.arange(16))
    assert tkernel.LAUNCHES == l0
    assert tref.CALLS["decode_attention"] == c0["decode_attention"] + 1


def test_value_errors():
    q = torch.zeros(1, 4, 32)
    k = torch.zeros(1, 16, 4, 32)
    with pytest.raises(ValueError, match="impl"):
        tops.decode_attention(0, q, k, k, torch.arange(16), impl="pallas")
    with pytest.raises(ValueError, match="int8 caches"):
        tops.decode_attention(0, q, k.to(torch.int8), k.to(torch.int8),
                              torch.arange(16))
    with pytest.raises(ValueError, match="attn_impl"):
        Model(tiny_config("llama2-7b"), attn_impl="kernel_interpret")


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

B, S, STEPS, MAX_SEQ, WINDOW = 2, 6, 5, 16, 4


def _local_global(cfg):
    """Tiny llama2-7b with a sliding-window stage beside the global one."""
    return dataclasses.replace(
        cfg, dtype="float32", pattern=("attn", "local"),
        attn=dataclasses.replace(cfg.attn, sliding_window=WINDOW))


@pytest.fixture(scope="module")
def carried():
    jcfg = _local_global(j_tiny_config("llama2-7b"))
    tcfg = _local_global(tiny_config("llama2-7b"))
    assert tcfg.attn.num_kv_heads < tcfg.attn.num_heads
    jparams = j_init_params(j_param_defs(jcfg), jax.random.PRNGKey(2))
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_model_decode_with_kernel_attention_matches_jax(rng, carried,
                                                        kv_bits):
    """Decode logits of the port's kernel path against JAX's kernel path
    (and the port's own sdpa path), with the local stage's ring buffer
    wrapping during the steps."""
    jcfg, tcfg, jparams, tparams = carried
    jm = JModel(jcfg, kv_bits=kv_bits, attn_impl="kernel_interpret")
    tm = Model(tcfg, kv_bits=kv_bits, attn_impl="kernel")
    ts = Model(tcfg, kv_bits=kv_bits)
    toks = rng.integers(0, tcfg.vocab_size, size=(B, S + STEPS))
    _, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                       MAX_SEQ)
    with torch.no_grad():
        _, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(
            toks[:, :S])}, MAX_SEQ)
        _, sc = ts.prefill(tparams, {"tokens": torch.from_numpy(
            toks[:, :S])}, MAX_SEQ)
    step = jax.jit(jm.decode_step)
    c0 = tref.CALLS["decode_attention"]
    for t in range(S, S + STEPS):
        jl, jc = step(jparams, jc, jnp.asarray(toks[:, t]), jnp.int32(t))
        with torch.no_grad():
            tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(toks[:, t]),
                                    t)
            sl, sc = ts.decode_step(tparams, sc, torch.from_numpy(toks[:, t]),
                                    t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"decode step {t}")
        np.testing.assert_allclose(tl.numpy(), sl.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f"sdpa step {t}")
    # every layer of every step went through B4's entry point
    assert tref.CALLS["decode_attention"] - c0 == STEPS * tcfg.num_layers
