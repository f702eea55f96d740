"""Port parity: training (`data/pipeline.py`, `optim/adamw.py`,
`parallel/compress.py`, `train/{step,checkpoint,loop}.py`,
`launch/train.py`, `Model(remat=)`, `core/quant.py`'s `fake_quant` and
`pack_codes`/`unpack_codes`) against the JAX package on the CPU.

Tolerances, each stated where it is held:
  * `fake_quant`, `pack_codes`/`unpack_codes`: bitwise;
  * schedules: rtol 1e-6 (float32 arithmetic in another order);
  * `adamw_update` on identical params, grads and state: rtol 1e-5,
    atol 1e-7 (a few float32 ulps of each elementwise chain);
  * `loss_fn` at float32: rtol 1e-5; the gradient tree: max|Δ| ≤ 1e-4 ·
    max|g| per leaf (measured ≤ 7e-6: torch and XLA sum in other orders);
  * one train step against JAX's: metrics rtol 1e-5; params rtol 1e-4,
    atol 1e-6 (AdamW's first step maps each gradient to ±lr, so a
    gradient near 0 moves its parameter by up to 2·lr between packages:
    checked to be none here);
  * k=4 microbatches against k=1: rtol 2e-4, atol 2e-5 (JAX's own bound,
    tests/test_train.py);
  * remat against no remat, failure recovery, resume: bitwise;
  * the two Trainers from one checkpoint over 5 steps of the same
    batches: loss, ppl, grad_norm rtol 1e-4.
"""
import contextlib
import dataclasses
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as j_tiny_config
from repro.core import quant as j_quant
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.model import Model as JModel
from repro.models.model import param_defs as j_param_defs
from repro.models.params import init_params as j_init_params
from repro.optim import adamw as j_adamw
from repro.parallel import compress as j_compress
from repro.train import checkpoint as j_ckpt
from repro.train import loop as j_loop
from repro.train import step as j_step
from repro_torch import convert
from repro_torch.configs import tiny_config
from repro_torch.core import quant as t_quant
from repro_torch.data.pipeline import SyntheticLM, make_batch
from repro_torch.launch import train as t_launch
from repro_torch.models.model import Model, param_defs
from repro_torch.models.params import init_params
from repro_torch.optim import adamw as t_adamw
from repro_torch.parallel import compress
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import step as t_step
from repro_torch.train.loop import SimulatedFailure, Trainer, TrainerConfig
from test_torch_model import fresh_jax_caches  # noqa: F401


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(
        x, torch.Tensor) else x)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _f32(arch):
    return (dataclasses.replace(j_tiny_config(arch), dtype="float32"),
            dataclasses.replace(tiny_config(arch), dtype="float32"))


def _carried(arch, seed=0):
    """JAX params from a key, and the same values as port tensors."""
    jcfg, tcfg = _f32(arch)
    jp = j_init_params(j_param_defs(jcfg), jax.random.PRNGKey(seed))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    return jcfg, tcfg, jp, tp


# -- quantization-aware training pieces ---------------------------------------

@pytest.mark.parametrize("shape,bits,gs", [
    ((32, 24), 2, -1), ((32, 24), 4, 8), ((40,), 4, -1), ((16,), 2, 8),
    ((3, 16, 8), 4, -1), ((2, 8, 5), 2, 2)])
def test_fake_quant_forward_and_straight_through(rng, shape, bits, gs):
    w = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    jy, vjp = jax.vjp(lambda v: j_quant.fake_quant(v, bits, gs),
                      jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = t_quant.fake_quant(tw, bits, gs)
    np.testing.assert_array_equal(_np(ty), np.asarray(jy))        # bitwise
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tw.grad.numpy(), g)
    np.testing.assert_array_equal(np.asarray(vjp(jnp.asarray(g))[0]), g)


@pytest.mark.parametrize("bits,n", [(1, 70), (2, 33), (4, 16), (4, 9),
                                    (8, 13)])
def test_pack_unpack_codes_equal_jax(rng, bits, n):
    codes = rng.integers(0, 1 << bits, size=(3, 2, n)).astype(np.uint8)
    jp = j_quant.pack_codes(jnp.asarray(codes), bits)
    tp = t_quant.pack_codes(torch.from_numpy(codes), bits)
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy().view(np.uint32), np.asarray(jp))
    back = t_quant.unpack_codes(tp, bits, n)
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_quant.unpack_codes(jp, bits, n)))
    # words given as the uint32 values (int64) unpack the same
    np.testing.assert_array_equal(t_quant.unpack_codes(
        torch.from_numpy(np.asarray(jp).astype(np.int64)), bits, n).numpy(),
        codes)


def test_int8_quantize_and_bf16_compression(rng):
    x = rng.normal(size=(5, 7)).astype(np.float32)
    jq, js = j_compress.int8_quantize(jnp.asarray(x))
    tq, ts = compress.int8_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_allclose(compress.int8_dequantize(tq, ts).numpy(), x,
                               atol=float(ts) / 2 + 1e-7)
    gen = torch.Generator().manual_seed(0)
    sq, _ = compress.int8_quantize(torch.from_numpy(x), gen)
    assert (sq.to(torch.int32) - tq.to(torch.int32)).abs().max() <= 1
    tree = {"a": torch.ones(2), "b": {"c": torch.ones(2, dtype=torch.int32)}}
    out = compress.compress_tree_for_sync(tree)
    assert out["a"].dtype == torch.bfloat16
    assert out["b"]["c"].dtype == torch.int32


# -- data ---------------------------------------------------------------------

def test_data_stream_determinism_structure_and_dtypes():
    d = SyntheticLM(vocab=64, seq=16, batch=4, seed=9)
    b1, b2 = d.batch_at(5, device="cpu"), d.batch_at(5, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], d.batch_at(6, "cpu")["tokens"])
    assert not torch.equal(b1["tokens"], SyntheticLM(
        vocab=64, seq=16, batch=4, seed=10).batch_at(5, "cpu")["tokens"])
    assert b1["tokens"].dtype == b1["labels"].dtype == torch.int32
    assert tuple(b1["tokens"].shape) == (4, 16)
    # labels are the next token of the same stream, which follows the
    # recurrence with ε ∈ {0, 1, 2}
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    t = torch.cat([b1["tokens"], b1["labels"][:, -1:]], 1).to(torch.int64)
    eps = (t[:, 1:] - 5 * t[:, :-1] - 17) % 64
    assert set(eps.unique().tolist()) <= {0, 1, 2}
    assert int(t.max()) < 64 and int(t.min()) >= 0
    e = make_batch(3, 1, batch=2, seq=8, vocab=32, embed_dim=6,
                   device="cpu")
    assert e["embeddings"].dtype == torch.bfloat16
    assert tuple(e["embeddings"].shape) == (2, 8, 6)
    assert SyntheticLM(32, 8, 2, embed_dim=6).specs() == {
        "tokens": ((2, 8), torch.int32), "labels": ((2, 8), torch.int32),
        "embeddings": ((2, 8, 6), torch.bfloat16)}


def test_data_without_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLM(vocab=8, seq=4, batch=2).batch_at(0)


# -- optimizer ----------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedules_equal_jax(schedule):
    cfg = dict(lr=3e-3, warmup_steps=7, total_steps=40, schedule=schedule)
    jc, tc = j_adamw.AdamWConfig(**cfg), t_adamw.AdamWConfig(**cfg)
    for step in range(0, 48, 3):
        np.testing.assert_allclose(
            float(t_adamw.cosine_schedule(step, tc)),
            float(j_adamw.cosine_schedule(jnp.int32(step), jc)), rtol=1e-6)
        np.testing.assert_allclose(
            float(t_adamw.linear_warmup(step, 7)),
            float(j_adamw.linear_warmup(jnp.int32(step), 7)), rtol=1e-6)


@pytest.mark.parametrize("clip,wd,bf16", [(1.0, 0.1, False),
                                          (None, 0.1, True),
                                          (50.0, 0.0, False)])
def test_adamw_update_equals_jax(rng, clip, wd, bf16):
    """Three updates in a row on identical params, grads and state: params,
    moments, count and metrics at rtol 1e-5 / atol 1e-7; leaves with
    ndim < 2 not decayed."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip,
               weight_decay=wd)
    jc, tc = j_adamw.AdamWConfig(**cfg), t_adamw.AdamWConfig(**cfg)
    p = {"w": rng.normal(size=(6, 5)), "norm": rng.normal(size=(5,)),
         "stack": {"k": rng.normal(size=(2, 3, 4))}}
    p = jax.tree_util.tree_map(lambda a: a.astype(np.float32), p)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = convert.params_from_numpy(p, "cpu")
    js = j_adamw.adamw_init(jp)
    ts = t_adamw.adamw_init(tp)
    for i in range(3):
        g = jax.tree_util.tree_map(
            lambda a: (3 * rng.normal(size=a.shape)).astype(np.float32), p)
        jg = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32),
            g)
        # the same values (bf16 ones are exact in float32), as the port's
        # compressed gradients where JAX's are bf16
        tg = convert.params_from_numpy(jax.tree_util.tree_map(
            lambda a: np.asarray(a.astype(jnp.float32)), jg), "cpu")
        if bf16:
            tg = compress.compress_tree_for_sync(tg)
        jp, js, jm = j_adamw.adamw_update(jg, js, jp, jc)
        out = t_adamw.adamw_update(tg, ts, tp, tc)
        assert out[0] is tp and out[1] is ts        # updated in place
        tm = out[2]
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
        for (path, a), (_, b) in zip(_flat(tp), _flat(
                jax.tree_util.tree_map(np.asarray, jp))):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-7,
                                       err_msg=str(path))
        for key in ("m", "v"):
            for (_, a), (_, b) in zip(_flat(ts[key]), _flat(
                    jax.tree_util.tree_map(np.asarray, js[key]))):
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                           atol=1e-7)
        assert int(ts["count"]) == int(js["count"]) == i + 1
        assert ts["count"].dtype == torch.int32


def test_adamw_skips_decay_on_norms():
    tp = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    st = t_adamw.adamw_init(tp)
    zero = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    t_adamw.adamw_update(zero, st, tp, t_adamw.AdamWConfig(
        lr=0.5, warmup_steps=1, weight_decay=0.1, schedule="constant"))
    assert torch.equal(tp["b"], torch.ones(2))
    assert torch.allclose(tp["w"], torch.full((2, 2), 1 - 0.5 * 0.1))


# -- loss and gradients -------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama2-7b", "qwen2-moe-a2.7b",
                                  "mamba2-1.3b"])
def test_loss_and_gradient_tree_equal_jax(arch):
    jcfg, tcfg, jp, tp = _carried(arch)
    jb = JSyntheticLM(vocab=jcfg.vocab_size, seq=16, batch=4,
                      seed=1).batch_at(0)
    if arch == "llama2-7b":          # the masked mean
        jb = dict(jb, mask=jnp.asarray(
            np.random.default_rng(0).random((4, 16)) < 0.7, jnp.float32))
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: j_step.loss_fn(JModel(jcfg), p, b), has_aux=True))
    (jl, jm), jg = vg(jp, jb)
    tg, tm = t_step.accumulate_grads(Model(tcfg), tp, _t(jb))
    for k in ("loss", "ce", "aux", "ppl"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    if arch == "qwen2-moe-a2.7b":
        assert float(tm["aux"]) > 0
    jflat = dict(_flat(jax.tree_util.tree_map(np.asarray, jg)))
    tflat = dict(_flat(tg))
    assert sorted(jflat) == sorted(tflat)
    for path, a in tflat.items():
        assert a.dtype == torch.float32
        b = jflat[path]
        err = np.abs(a.numpy() - b).max()
        assert err <= 1e-4 * np.abs(b).max(), (path, err)


# -- the train step -----------------------------------------------------------

@pytest.mark.parametrize("compress_grads", [False, True])
def test_train_step_equals_jax(compress_grads):
    jcfg, tcfg, jp, tp = _carried("llama2-7b")
    jb = JSyntheticLM(vocab=jcfg.vocab_size, seq=16, batch=8,
                      seed=2).batch_at(0)
    ocfg = dict(warmup_steps=1, total_steps=10)
    js = jax.jit(j_step.make_train_step(
        JModel(jcfg), j_adamw.AdamWConfig(**ocfg),
        compress_grads=compress_grads))
    jp2, jst, jm = js(jp, j_adamw.adamw_init(jp), jb)
    ts = t_step.make_train_step(Model(tcfg), t_adamw.AdamWConfig(**ocfg),
                                compress_grads=compress_grads)
    tp2, tst, tm = ts(tp, t_adamw.adamw_init(tp), _t(jb))
    for k in ("loss", "ce", "ppl", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    for (path, a), (_, b) in zip(_flat(tp2), _flat(
            jax.tree_util.tree_map(np.asarray, jp2))):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6,
                                   err_msg=str(path))
    assert int(tst["count"]) == int(jst["count"]) == 1


def test_microbatched_step_matches_single():
    """k=4 strided microbatches against one batch, at JAX's own bound
    (rtol 2e-4, atol 2e-5, float32)."""
    cfg = dataclasses.replace(tiny_config("llama2-7b"), dtype="float32")
    batch = SyntheticLM(vocab=cfg.vocab_size, seq=16, batch=8).batch_at(
        0, "cpu")
    ocfg = t_adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    outs = []
    for k in (1, 4):
        params = init_params(param_defs(cfg), torch.Generator().manual_seed(0),
                             "cpu")
        outs.append(t_step.make_train_step(Model(cfg), ocfg, k,
                                           compress_grads=False)(
            params, t_adamw.adamw_init(params), batch)[0])
    for (path, a), (_, b) in zip(_flat(outs[0]), _flat(outs[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=str(path))
    rows = t_step._microbatch_stack(batch, 4)["tokens"]
    assert torch.equal(rows[1], batch["tokens"][1::4])       # strided


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen2-moe-a2.7b",
                                  "zamba2-7b"])
def test_remat_is_bitwise(arch):
    """Layer-level remat (`Model(remat=True)`: a checkpoint per layer or
    pattern group with its shared block) and whole-loss remat give the
    gradients of the plain backward bitwise."""
    cfg = dataclasses.replace(tiny_config(arch), dtype="float32")
    params = init_params(param_defs(cfg), torch.Generator().manual_seed(1),
                         "cpu")
    batch = SyntheticLM(vocab=cfg.vocab_size, seq=16, batch=2).batch_at(
        0, "cpu")
    base, bm = t_step.accumulate_grads(Model(cfg), params, batch)
    for model, whole in ((Model(cfg, remat=True), False), (Model(cfg), True)):
        g, m = t_step.accumulate_grads(model, params, batch, remat=whole)
        assert torch.equal(m["loss"], bm["loss"])
        for (path, a), (_, b) in zip(_flat(g), _flat(base)):
            assert torch.equal(a, b), path
    # without autograd, remat is the plain forward
    with torch.no_grad():
        a, _ = Model(cfg, remat=True).forward(params, batch)
        b, _ = Model(cfg).forward(params, batch)
    assert torch.equal(a, b)


# -- checkpoints --------------------------------------------------------------

def test_checkpoint_roundtrip_atomicity_and_prune(tmp_path):
    tree = {"a": {"b": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "c": torch.ones(4, dtype=torch.bfloat16) * 1.5,
            "n": torch.tensor(7, dtype=torch.int32)}
    path = t_ckpt.save_checkpoint(str(tmp_path / "r"), 7, tree)
    step, back = t_ckpt.restore_checkpoint(path, device="cpu")
    assert step == 7
    assert torch.equal(back["a"]["b"], tree["a"]["b"])
    assert back["c"].dtype == torch.bfloat16 and torch.equal(back["c"],
                                                             tree["c"])
    assert back["n"].dtype == torch.int32 and int(back["n"]) == 7
    d = str(tmp_path / "p")
    for s in (10, 20, 30, 40):
        t_ckpt.save_checkpoint(d, s, {"x": torch.ones(3)}, keep=2,
                               async_=True)
    t_ckpt.wait_for_saves()
    os.makedirs(os.path.join(d, "step_00000050"))          # torn write
    assert t_ckpt.latest_checkpoint(d).endswith("step_00000040")
    kept = sorted(p for p in os.listdir(d) if os.path.exists(
        os.path.join(d, p, "COMMIT")))
    assert kept == ["step_00000030", "step_00000040"]
    assert t_ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_async_save_snapshots_and_reports_failure(tmp_path, monkeypatch):
    x = torch.zeros(3)
    t_ckpt.save_checkpoint(str(tmp_path), 1, {"x": x}, async_=True)
    x.add_(5)                          # an in-place step after the snapshot
    t_ckpt.wait_for_saves()
    _, back = t_ckpt.restore_checkpoint(t_ckpt.latest_checkpoint(
        str(tmp_path)), device="cpu")
    assert torch.equal(back["x"], torch.zeros(3))

    def full(*args, **kw):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(t_ckpt, "_to_numpy", full)    # the writer's step
    t_ckpt.save_checkpoint(str(tmp_path), 2, {"x": x}, async_=True)
    with pytest.raises(OSError, match="No space left"):
        t_ckpt.wait_for_saves()        # the writer's error, not a skip
    t_ckpt.wait_for_saves()            # reported once
    assert t_ckpt.latest_checkpoint(str(tmp_path)).endswith("step_00000001")


def test_checkpoints_restore_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"p": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                    "s": rng.normal(size=(2, 3, 4)).astype(np.float32)},
              "opt": {"count": np.int32(3)}}
    half = rng.normal(size=(5,)).astype(np.float32)
    # JAX writes, the port reads
    jtree = jax.tree_util.tree_map(jnp.asarray, arrays)
    jtree["h"] = jnp.asarray(half, jnp.bfloat16)
    path = j_ckpt.save_checkpoint(str(tmp_path / "j"), 4, jtree)
    step, back = t_ckpt.restore_checkpoint(path, device="cpu")
    assert step == 4
    for (pa, a), (pb, b) in zip(_flat(back), _flat(jtree)):
        assert pa == pb
        np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))
    assert back["h"].dtype == torch.bfloat16
    assert back["opt"]["count"].dtype == torch.int32
    # the port writes, JAX reads
    ttree = dict(convert.params_from_numpy(arrays, "cpu"),
                 h=torch.from_numpy(half).to(torch.bfloat16))
    path = t_ckpt.save_checkpoint(str(tmp_path / "t"), 9, ttree)
    step, jback = j_ckpt.restore_checkpoint(path)
    assert step == 9
    assert np.asarray(jback["h"]).dtype == np.dtype(jnp.bfloat16)
    for (pa, a), (pb, b) in zip(_flat(jback), _flat(ttree)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a, np.float32), _np(b))
    assert np.asarray(jback["opt"]["count"]).dtype == np.int32


# -- the Trainer --------------------------------------------------------------

def _trainer(tmp, arch="llama2-7b", failure_hook=None, ckpt_every=10,
             cfg=None, **kw):
    return Trainer(cfg or tiny_config(arch),
                   t_adamw.AdamWConfig(lr=1e-2, warmup_steps=5,
                                       total_steps=200, schedule="cosine"),
                   TrainerConfig(ckpt_dir=tmp, ckpt_every=ckpt_every,
                                 ckpt_async=False, seed=3, **kw),
                   global_batch=4, seq_len=32, failure_hook=failure_hook,
                   device="cpu")


class _JaxBatches:
    """The JAX package's data stream, handed to the port's Trainer."""

    def __init__(self, data):
        self.data = data

    def batch_at(self, step, device=None):
        return {k: v.to(device) for k, v in
                _t(self.data.batch_at(step)).items()}


def test_trainers_continue_one_checkpoint_alike(tmp_path):
    """The JAX Trainer saves step 1; the port's restores it
    (`restore_or_init`) and both run 5 steps on the same (JAX) batches,
    with their histories at rtol 1e-4 (float32 compute, bf16-compressed
    gradients)."""
    jcfg, tcfg = _f32("llama2-7b")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    kw = dict(ckpt_every=1, ckpt_async=False, seed=3)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=20)
    jt = j_loop.Trainer(jcfg, j_adamw.AdamWConfig(**ocfg),
                        j_loop.TrainerConfig(ckpt_dir=jdir, **kw),
                        global_batch=4, seq_len=16)
    jt.run(1)
    shutil.copytree(jdir, tdir)
    tt = Trainer(tcfg, t_adamw.AdamWConfig(**ocfg),
                 TrainerConfig(ckpt_dir=tdir, **kw), global_batch=4,
                 seq_len=16, device="cpu")
    tt.data = _JaxBatches(jt.data)
    step, tp, _ = tt.restore_or_init()
    assert step == 1 and tp["embed"].device.type == "cpu"
    _, _, jh = jt.run(5, log_every=1)
    _, _, th = tt.run(5, log_every=1)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == \
        [2, 3, 4, 5, 6]
    for a, b in zip(th, jh):
        for k in ("loss", "ppl", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    assert t_ckpt.latest_checkpoint(tdir).endswith("step_00000006")


def test_opt_state_from_numpy():
    jp = {"w": jnp.ones((2, 3)), "b": {"c": jnp.zeros(3)}}
    st = jax.tree_util.tree_map(np.asarray, j_adamw.adamw_init(jp))
    out = convert.opt_state_from_numpy(st, "cpu")
    assert out["count"].dtype == torch.int32 and out["count"].ndim == 0
    assert out["m"]["w"].dtype == torch.float32
    assert tuple(out["v"]["b"]["c"].shape) == (3,)


def test_loss_decreases(tmp_path):
    """JAX's test_loss_decreases bounds on the port's own stream."""
    tr = _trainer(str(tmp_path / "a"))
    _, _, hist = tr.run(60, log_every=10)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    assert last < first - 0.3, (first, last)
    assert last < np.log(tr.cfg.vocab_size), last
    assert all(h["sec_per_step"] > 0 for h in hist)


def test_failure_recovery_is_bitwise_deterministic(tmp_path):
    """Crashes at steps 7 and 13 restore the latest commit and replay:
    params and optimizer state bitwise those of an uninterrupted run."""
    clean = _trainer(str(tmp_path / "clean"), ckpt_every=5)
    p_clean, s_clean, _ = clean.run(16)
    crash_at = {7, 13}

    def hook(step):
        if step in crash_at:
            crash_at.discard(step)
            raise SimulatedFailure(f"injected at {step}")
    faulty = _trainer(str(tmp_path / "faulty"), failure_hook=hook,
                      ckpt_every=5)
    p_faulty, s_faulty, _ = faulty.run(16)
    assert faulty.recoveries == 2
    for (path, a), (_, b) in zip(_flat({"p": p_clean, "s": s_clean}),
                                 _flat({"p": p_faulty, "s": s_faulty})):
        assert torch.equal(a, b), path


def test_resume_from_checkpoint_continues(tmp_path):
    d = str(tmp_path / "resume")
    _trainer(d, ckpt_every=5).run(10)
    tr2 = _trainer(d, ckpt_every=5)
    step, _, _ = tr2.restore_or_init()
    assert step == 10
    _, _, hist = tr2.run(5)
    assert hist[-1]["step"] == 15


def test_cli_trains_on_the_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        t_launch.main(["--arch", "llama2-7b", "--tiny", "--steps", "3",
                       "--batch", "4", "--seq", "16", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path), "--remat"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("arch=tiny-llama2-7b") and "mesh=None" in \
        lines[0]
    hist = [json.loads(x) for x in lines[1:] if x.startswith("{")]
    assert [h["step"] for h in hist] == [3]
    assert set(hist[0]) == {"step", "loss", "ppl", "grad_norm",
                            "sec_per_step"}
    assert np.isfinite(hist[0]["loss"])
    assert t_ckpt.latest_checkpoint(str(tmp_path)).endswith("step_00000003")
