"""Port parity: tied embeddings (gemma2-2b, gemma2-9b: the head is the
embedding table, with the final softcap) and embedding inputs from a stubbed
frontend (musicgen-medium, pixtral-12b: no token table) against the JAX
package, at tiny size (`tiny_config`, float32), both built from the same
numpy parameter tree.

Configs and parameter trees equal JAX's; forward, prefill and 3 decode steps
at rtol/atol 1e-4 (the port's model tolerance, tests/test_torch_model.py),
unquantized and quantized with float activations; the tied head and the
embedding-input decode step on their own at 1e-5; the port's decode steps
against its own forward at JAX's tolerance (tests/test_models.py: 2e-4);
the act_bits=4 models bitwise against the same model with the JAX package's
kernel in every bit-plane linear (the activation tie makes model-level
act_bits=4 irreproducible otherwise, ROADMAP C).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import tiny_config as j_tiny_config
from repro.models.model import Model as JModel
from repro.models.model import param_defs as j_param_defs
from repro.models.params import init_params as j_init_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.quantize import quantize_params as j_quantize_params
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, tiny_config
from repro_torch.core.engine import EngineLinear, MVDRAMEngine
from repro_torch.models.model import Model, param_defs
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.quantize import init_quantized_params, quantize_params
from test_torch_model import JaxLinear, fresh_jax_caches  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS, MAX_SEQ = 2, 6, 3, 16
TIED = ("gemma2-2b", "gemma2-9b")
EMBEDDING_INPUTS = ("musicgen-medium", "pixtral-12b")


def _shapes(defs):
    return jax.tree_util.tree_map(lambda d: d.shape, defs,
                                  is_leaf=lambda x: hasattr(x, "shape"))


@pytest.fixture(scope="module", params=TIED + EMBEDDING_INPUTS)
def carried(request):
    """A tiny model (float32) in both packages, on the same values."""
    arch = request.param
    jcfg = dataclasses.replace(j_tiny_config(arch), dtype="float32")
    tcfg = dataclasses.replace(tiny_config(arch), dtype="float32")
    jparams = j_init_params(j_param_defs(jcfg), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return arch, jcfg, tcfg, jparams, convert.params_from_numpy(tree, "cpu")


def _inputs(cfg, rng, n=S + STEPS):
    """(B, n) tokens, or (B, n, E) frame embeddings for a stubbed
    frontend, as numpy."""
    if cfg.input_mode == "embeddings":
        return rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, size=(B, n))


def _batch(cfg, x, lib):
    key = "embeddings" if cfg.input_mode == "embeddings" else "tokens"
    return {key: jnp.asarray(x) if lib == "jax" else torch.from_numpy(x)}


# -- configuration ----------------------------------------------------------

def test_configs_and_trees_match_jax(carried):
    arch, jcfg, tcfg, _, tparams = carried
    assert arch in ARCHS
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for tc, jc in ((tcfg, jcfg), (get_config(arch), j_get_config(arch))):
        assert _shapes(param_defs(tc)) == _shapes(j_param_defs(jc))
        assert tc.param_count() == jc.param_count()
    tied = arch in TIED
    assert ("lm_head" in tparams) == (not tied)
    assert ("embed" in tparams) == tied


def test_init_quantized_params_draws_the_trees(carried):
    """No `lm_head` leaf where the head is tied, no `embed` where the
    inputs are embeddings; the table stays float."""
    _, _, tcfg, _, _ = carried
    defs = param_defs(tcfg)
    qp = init_quantized_params(defs, tcfg.weight_bits,
                               torch.Generator().manual_seed(0), "cpu")
    assert qp.keys() == defs.keys()
    if "embed" in qp:
        assert isinstance(qp["embed"], torch.Tensor)


# -- the model against JAX ---------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_forward_prefill_decode_match_jax(rng, carried, quantized):
    _, jcfg, tcfg, jp, tp = carried
    if quantized:
        jp = j_quantize_params(jp, jcfg.weight_bits)
        tp = quantize_params(tp, tcfg.weight_bits)
    jm = JModel(jcfg)
    tm = Model(tcfg, impl=EngineLinear(MVDRAMEngine()) if quantized
               else None)
    x = _inputs(tcfg, rng)
    jl, _ = jm.forward(jp, _batch(jcfg, x[:, :S], "jax"))
    with torch.no_grad():
        tl, _ = tm.forward(tp, _batch(tcfg, x[:, :S], "torch"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jl, jc = jm.prefill(jp, _batch(jcfg, x[:, :S], "jax"), MAX_SEQ)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, _batch(tcfg, x[:, :S], "torch"), MAX_SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for t in range(S, S + STEPS):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(x[:, t]), jnp.int32(t))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(x[:, t]), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {t}")


def test_tied_head_matches_jax(rng):
    """The tied head alone: x · embedᵀ in x's dtype, then the final
    softcap in float32; and with the table held in bf16 (as `ServeEngine`
    holds it) the bf16 logits are the same as casting it per call."""
    jcfg = dataclasses.replace(j_tiny_config("gemma2-9b"), dtype="float32")
    tcfg = dataclasses.replace(tiny_config("gemma2-9b"), dtype="float32")
    table = rng.normal(size=(256, 64)).astype(np.float32)
    x = rng.normal(size=(B, 3, 64)).astype(np.float32) * 4
    want = np.asarray(JModel(jcfg)._logits({"embed": jnp.asarray(table)},
                                           jnp.asarray(x)))
    got = Model(tcfg)._logits({"embed": torch.from_numpy(table)},
                              torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.abs(want).max() <= tcfg.final_softcap
    m16 = Model(tiny_config("gemma2-9b"))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    t32 = torch.from_numpy(table)
    assert torch.equal(m16._logits({"embed": t32}, xb),
                       m16._logits({"embed": t32.to(torch.bfloat16)}, xb))


def test_embedding_input_decode_matches_jax(rng):
    """One decode step on (B, E) frames from an empty cache, in the
    model's dtype: the inputs are cast, not embedded."""
    arch = "pixtral-12b"
    jcfg = dataclasses.replace(j_tiny_config(arch), dtype="float32")
    tcfg = dataclasses.replace(tiny_config(arch), dtype="float32")
    jp = j_init_params(j_param_defs(jcfg), jax.random.PRNGKey(1))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    frame = rng.normal(size=(B, 64)).astype(np.float64)
    jm, tm = JModel(jcfg), Model(tcfg)
    want, _ = jm.decode_step(jp, jm.init_cache(B, 8),
                             jnp.asarray(frame, jnp.float32), jnp.int32(0))
    with torch.no_grad():
        got, cache = tm.decode_step(tp, tm.init_cache(B, 8),
                                    torch.from_numpy(frame), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert cache["stages"]["0"]["positions"][:, :, 0].tolist() == \
        [[0, 0], [0, 0]]


@pytest.mark.parametrize("arch", ["gemma2-2b", "musicgen-medium"])
def test_decode_matches_forward(rng, arch):
    """The port's decode steps from an empty cache against its own forward
    over the same inputs (the JAX package's test, tests/test_models.py)."""
    cfg = dataclasses.replace(tiny_config(arch), dtype="float32")
    model = Model(cfg)
    params = convert.params_from_numpy(jax.tree_util.tree_map(
        np.asarray, j_init_params(j_param_defs(
            dataclasses.replace(j_tiny_config(arch), dtype="float32")),
            jax.random.PRNGKey(0))), "cpu")
    n = 12
    x = _inputs(cfg, rng, n)
    with torch.no_grad():
        logits, _ = model.forward(params, _batch(cfg, x, "torch"))
        cache = model.init_cache(B, n)
        for t in range(n):
            lg, cache = model.decode_step(params, cache,
                                          torch.from_numpy(x[:, t]), t)
            np.testing.assert_allclose(lg.numpy(), logits[:, t].numpy(),
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"step {t}")


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_act_bits4_model_bitwise_with_jax_linears(rng, carried, kv_bits):
    """act_bits=4 (q/k/v and up/gate fused through B2's plain version, the
    rest through B1's; the tied head a float product) bitwise against the
    same model with JAX's kernel in every bit-plane linear: prefill and
    decode."""
    _, _, tcfg, _, tparams = carried
    qp = quantize_params(tparams, tcfg.weight_bits)
    port = Model(tcfg, act_bits=4, impl=EngineLinear(MVDRAMEngine()),
                 kv_bits=kv_bits)
    hybrid = Model(tcfg, act_bits=4, impl=JaxLinear(), kv_bits=kv_bits)
    x = torch.from_numpy(_inputs(tcfg, rng))
    with torch.no_grad():
        a, ca = port.prefill(qp, _batch(tcfg, x[:, :S].numpy(), "torch"),
                             MAX_SEQ)
        b, cb = hybrid.prefill(qp, _batch(tcfg, x[:, :S].numpy(), "torch"),
                               MAX_SEQ)
        assert torch.equal(a, b)
        for t in range(S, S + STEPS):
            a, ca = port.decode_step(qp, ca, x[:, t], t)
            b, cb = hybrid.decode_step(qp, cb, x[:, t], t)
            assert torch.equal(a, b), f"decode step {t}"


# -- serving ------------------------------------------------------------------

def test_gemma2_serve_tokens_match_jax():
    """Greedy tokens of the tied-head model through `ServeEngine`, float
    and quantized with float activations, against JAX `ServeEngine`."""
    arch = "gemma2-2b"
    jcfg = dataclasses.replace(j_tiny_config(arch), dtype="float32")
    tcfg = dataclasses.replace(tiny_config(arch), dtype="float32")
    jp = j_init_params(j_param_defs(jcfg), jax.random.PRNGKey(2))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    prompts = np.random.default_rng(1).integers(0, 256, size=(2, 6))
    for q in (False, True):
        want = np.asarray(JServeEngine(jcfg, jp, max_seq=20, batch_slots=2,
                                       quantized=q).generate(
            jnp.asarray(prompts, jnp.int32), max_new=6, scan=False))
        got = ServeEngine(tcfg, tp, max_seq=20, batch_slots=2, quantized=q,
                          device="cpu").generate(prompts, max_new=6)
        np.testing.assert_array_equal(got.numpy(), want)


def test_serve_engine_holds_the_tied_table_in_the_model_dtype():
    cfg = tiny_config("gemma2-2b")
    params = init_quantized_params(param_defs(cfg), cfg.weight_bits,
                                   torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(cfg, params, max_seq=12, batch_slots=2,
                      quantized=True, device="cpu")
    assert eng.params["embed"].dtype == torch.bfloat16
    assert params["embed"].dtype == torch.float32
    assert torch.equal(eng.params["embed"],
                       params["embed"].to(torch.bfloat16))
    out = eng.generate(torch.zeros((2, 4), dtype=torch.long), max_new=3)
    assert tuple(out.shape) == (2, 7)


@pytest.mark.parametrize("arch", EMBEDDING_INPUTS)
def test_serve_cli_refuses_embedding_inputs(arch):
    from repro_torch.launch import serve as serve_cli
    with pytest.raises(SystemExit, match="stubbed frontend"):
        serve_cli.main(["--arch", arch, "--tiny", "--device", "cpu"])


def test_serve_cli_runs_gemma2_on_cpu(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", "gemma2-2b", "--tiny", "--quantized",
                    "--act-bits", "4", "--tokens", "4", "--batch", "2",
                    "--device", "cpu"])
    assert "generated shape: (2, 20)" in capsys.readouterr().out
