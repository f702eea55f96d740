"""Port parity: the Mamba2 block (`models/ssm.py`) and tiny mamba2-1.3b
(`tiny_config`: 2 layers, d_model 64, state 16, heads of 16, chunk 8, the
head tied to the embedding) against the JAX package, on the same numpy
inputs and parameter tree.

The conv, the chunked SSD scan (L = 24 over chunks of 8, so the state runs
across chunks), the one-token recurrence and the whole block at rtol/atol
1e-4, the tolerance of the JAX package's own SSD test (tests/test_ssm.py);
the model's forward, prefill, decode and every cache leaf at the same
tolerance, unquantized and quantized with float activations (B3's plain
version); the act_bits=4 model bitwise against the same model with the JAX
package's kernel in every bit-plane linear (B1 on in_proj and out_proj);
`ServeEngine`'s greedy tokens against JAX `ServeEngine`'s; the CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import tiny_config as j_tiny_config
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro.models.model import param_defs as j_param_defs
from repro.models.params import init_params as j_init_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.quantize import quantize_params as j_quantize_params
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, long_ok, tiny_config
from repro_torch.core.engine import EngineLinear, MVDRAMEngine
from repro_torch.models import ssm as tssm
from repro_torch.models.model import Model, layer_params, param_defs
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.quantize import init_quantized_params, quantize_params
from test_torch_model import JaxLinear, fresh_jax_caches  # noqa: F401

ARCH = "mamba2-1.3b"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS, MAX_SEQ = 2, 8, 3, 16


def _shapes(defs):
    return jax.tree_util.tree_map(lambda d: d.shape, defs,
                                  is_leaf=lambda x: hasattr(x, "shape"))


@pytest.fixture(scope="module")
def carried():
    """Tiny mamba2 (float32) in both packages, on the same values."""
    jcfg = dataclasses.replace(j_tiny_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tiny_config(ARCH), dtype="float32")
    jparams = j_init_params(j_param_defs(jcfg), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, convert.params_from_numpy(tree, "cpu")


def _ssd_inputs(rng, bsz=2, l=24, h=4, p=8, g=2, n=4):
    return (rng.normal(size=(bsz, l, h, p)).astype(np.float32),
            rng.normal(size=(bsz, l, g, n)).astype(np.float32),
            rng.normal(size=(bsz, l, g, n)).astype(np.float32),
            rng.uniform(0.01, 0.3, size=(bsz, l, h)).astype(np.float32),
            np.log(rng.uniform(0.5, 4.0, size=(h,))).astype(np.float32),
            rng.normal(size=(h,)).astype(np.float32))


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _close(got, want, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **{**TOL, **kw})


# -- the block's parts ---------------------------------------------------------

def test_configs_and_trees_match_jax(carried):
    jcfg, tcfg, _, tparams = carried
    assert ARCH in ARCHS and long_ok(ARCH)
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for tc, jc in ((tcfg, jcfg), (get_config(ARCH), j_get_config(ARCH))):
        assert _shapes(param_defs(tc)) == _shapes(j_param_defs(jc))
        assert tc.param_count() == jc.param_count()
    assert set(tparams) == {"embed", "stages", "final_norm"}   # tied head
    assert tcfg.d_ff == 0


def test_causal_conv_and_conv_step_match_jax(rng):
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    (jx, jw, jb), (tx, tw, tb) = _both((x, w, b))
    _close(tssm.causal_conv(tx, tw, tb), jssm.causal_conv(jx, jw, jb))
    st = rng.normal(size=(2, 3, 12)).astype(np.float32)
    jout, jst = jssm.conv_step(jx[:, 0], jnp.asarray(st), jw, jb)
    tout, tst = tssm.conv_step(tx[:, 0], torch.from_numpy(st), tw, tb)
    _close(tout, jout)
    _close(tst, jst)


def test_segsum_masks_to_exact_zeros(rng):
    a = torch.from_numpy(rng.normal(size=(3, 6)).astype(np.float32))
    lmat = torch.exp(tssm._segsum(a))
    assert bool((torch.triu(lmat, diagonal=1) == 0).all())
    np.testing.assert_allclose(
        lmat.numpy(), np.exp(np.asarray(jssm._segsum(jnp.asarray(a.numpy())))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunk", [8, 24, 64])
def test_ssd_forward_matches_jax(rng, chunk):
    """L = 24: three chunks of 8 (the state runs across chunks), one chunk
    of 24, and a chunk longer than the sequence."""
    arrays = _ssd_inputs(rng)
    ja, ta = _both(arrays)
    jy, js = jssm.ssd_forward(*ja, chunk)
    ty, ts = tssm.ssd_forward(*ta, chunk)
    _close(ty, jy)
    _close(ts, js)


def test_ssd_forward_refuses_a_ragged_chunking(rng):
    _, ta = _both(_ssd_inputs(rng, l=12))
    with pytest.raises(ValueError, match="must divide by chunk 8"):
        tssm.ssd_forward(*ta, 8)


def test_ssd_step_matches_jax_and_the_scan(rng):
    x, bm, cm, dt, a_log, d = _ssd_inputs(rng)
    state = rng.normal(size=(2, 4, 8, 4)).astype(np.float32)
    (jx, jb, jc, jdt, ja, jd, js), (tx, tb, tc, tdt, ta, td, ts) = _both(
        (x, bm, cm, dt, a_log, d, state))
    jy, jn = jssm.ssd_step(jx[:, 0], jb[:, 0], jc[:, 0], jdt[:, 0], ja, jd,
                           js)
    ty, tn = tssm.ssd_step(tx[:, 0], tb[:, 0], tc[:, 0], tdt[:, 0], ta, td,
                           ts)
    _close(ty, jy)
    _close(tn, jn)
    # the recurrence from a zero state follows the chunked scan
    y_scan, s_scan = tssm.ssd_forward(tx, tb, tc, tdt, ta, td, 8)
    st = torch.zeros((2, 4, 8, 4))
    for t in range(x.shape[1]):
        yt, st = tssm.ssd_step(tx[:, t], tb[:, t], tc[:, t], tdt[:, t], ta,
                               td, st)
        _close(yt, y_scan[:, t].numpy())
    _close(st, s_scan.numpy())


def _mamba_layer(carried):
    jcfg, tcfg, jparams, tparams = carried
    jp = jax.tree_util.tree_map(lambda v: v[0], jparams["stages"]["0"])
    return jcfg, tcfg, jp["mamba"], layer_params(tparams["stages"]["0"],
                                                 0)["mamba"]


@pytest.mark.parametrize("l", [2, 16])
def test_mamba_forward_and_decode_match_jax(rng, carried, l):
    """The block and its cache; at L = 2 < K − 1 the conv tail is
    left-padded with zeros. Then two decode steps from that cache, the
    port's updated in place."""
    jcfg, tcfg, jp, tp = _mamba_layer(carried)
    x = rng.normal(size=(B, l + 2, 64)).astype(np.float32)
    jout, jc = jssm.mamba_forward(jnp.asarray(x[:, :l]), jp, jcfg)
    with torch.no_grad():
        tout, tc = tssm.mamba_forward(torch.from_numpy(x[:, :l]), tp, tcfg)
    _close(tout, jout)
    for k in ("conv", "ssm"):
        _close(tc[k], jc[k])
    if l == 2:
        assert bool((tc["conv"][:, 0] == 0).all())
    storage = {k: v.data_ptr() for k, v in tc.items()}
    for t in range(l, l + 2):
        jout, jc = jssm.mamba_decode(jnp.asarray(x[:, t:t + 1]), jp, jcfg,
                                     jc)
        with torch.no_grad():
            tout, tc2 = tssm.mamba_decode(torch.from_numpy(x[:, t:t + 1]),
                                          tp, tcfg, tc)
        assert tc2 is tc
        assert {k: v.data_ptr() for k, v in tc.items()} == storage
        _close(tout, jout)
        for k in ("conv", "ssm"):
            _close(tc[k], jc[k], err_msg=f"{k} at step {t}")


def test_mamba_cache_init_matches_jax(carried):
    jcfg, tcfg, _, _ = carried
    jc = jssm.mamba_cache_init(3, jcfg, jnp.bfloat16)
    tc = tssm.mamba_cache_init(3, tcfg, torch.bfloat16)
    for k in ("conv", "ssm"):
        assert tuple(tc[k].shape) == jc[k].shape
        assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype)


# -- the model -------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_forward_prefill_decode_and_caches_match_jax(rng, carried,
                                                     quantized):
    jcfg, tcfg, jp, tp = carried
    if quantized:
        jp = j_quantize_params(jp, jcfg.weight_bits)
        tp = quantize_params(tp, tcfg.weight_bits)
    jm = JModel(jcfg)
    tm = Model(tcfg, impl=EngineLinear(MVDRAMEngine()) if quantized
               else None)
    toks = rng.integers(0, 256, size=(B, S + STEPS))
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks[:, :S])})
    with torch.no_grad():
        tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks[:, :S])})
    _close(tl, jl)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, MAX_SEQ)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])},
                            MAX_SEQ)
    _close(tl, jl)
    for t in range(S, S + STEPS):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t]),
                                jnp.int32(t))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t]), t)
        _close(tl, jl, err_msg=f"decode step {t}")
    assert set(tc) == set(jc) == {"stages"}
    for k in ("conv", "ssm"):
        _close(tc["stages"]["0"][k], jc["stages"]["0"][k])


def test_init_cache_and_decode_from_it_match_jax(rng, carried):
    jcfg, tcfg, jp, tp = carried
    jm, tm = JModel(jcfg), Model(tcfg)
    jc, tc = jm.init_cache(B, MAX_SEQ), tm.init_cache(B, MAX_SEQ)
    assert _shapes(tc) == jax.tree_util.tree_map(lambda v: v.shape, jc)
    toks = rng.integers(0, 256, size=(B, 3))
    for t in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t]),
                                jnp.int32(t))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t]), t)
        _close(tl, jl)


def test_act_bits4_model_bitwise_with_jax_linears(rng, carried):
    """in_proj and out_proj through B1's plain version, bitwise against
    the same model with the JAX package's kernel in every linear: prefill
    and decode."""
    _, cfg, _, tparams = carried
    qp = quantize_params(tparams, cfg.weight_bits)
    port = Model(cfg, act_bits=4, impl=EngineLinear(MVDRAMEngine()))
    hybrid = Model(cfg, act_bits=4, impl=JaxLinear())
    toks = torch.from_numpy(rng.integers(0, 256, size=(B, S + STEPS)))
    with torch.no_grad():
        a, ca = port.prefill(qp, {"tokens": toks[:, :S]}, MAX_SEQ)
        b, cb = hybrid.prefill(qp, {"tokens": toks[:, :S]}, MAX_SEQ)
        assert torch.equal(a, b)
        for t in range(S, S + STEPS):
            a, ca = port.decode_step(qp, ca, toks[:, t], t)
            b, cb = hybrid.decode_step(qp, cb, toks[:, t], t)
            assert torch.equal(a, b), f"decode step {t}"
        for k in ("conv", "ssm"):
            assert torch.equal(ca["stages"]["0"][k], cb["stages"]["0"][k])


# -- serving ------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_serve_tokens_match_jax(carried, quantized):
    jcfg, tcfg, jp, tp = carried
    prompts = np.random.default_rng(1).integers(0, 256, size=(2, 8))
    want = np.asarray(JServeEngine(jcfg, jp, max_seq=20, batch_slots=2,
                                   quantized=quantized).generate(
        jnp.asarray(prompts, jnp.int32), max_new=6, scan=False))
    got = ServeEngine(tcfg, tp, max_seq=20, batch_slots=2,
                      quantized=quantized, device="cpu").generate(
        prompts, max_new=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_quantized_params_keeps_the_ssm_leaves_float():
    cfg = tiny_config(ARCH)
    qp = init_quantized_params(param_defs(cfg), cfg.weight_bits,
                               torch.Generator().manual_seed(0), "cpu")
    m = qp["stages"]["0"]["mamba"]
    assert type(m["in_proj"]).__name__ == "BitplaneWeights"
    assert type(m["out_proj"]).__name__ == "BitplaneWeights"
    for k in ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip"):
        assert isinstance(m[k], torch.Tensor), k
    assert isinstance(m["out_norm"]["scale"], torch.Tensor)
    np.testing.assert_allclose(m["a_log"][0].numpy(),
                               np.log(np.arange(1, 9, dtype=np.float32)),
                               rtol=1e-6)


def test_serve_cli_runs_mamba2_on_cpu(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", ARCH, "--tiny", "--quantized", "--act-bits",
                    "4", "--tokens", "4", "--batch", "2", "--device", "cpu"])
    assert "generated shape: (2, 20)" in capsys.readouterr().out
