"""Port parity: multi-head latent attention (`mla_forward`, the absorbed
`mla_decode`, `mla_cache_init`) and deepseek-v2-lite-16b — MLA, one leading
dense-FFN layer (`first`), 64 routed experts at top-6 with 2 shared — against
the JAX package, on the same numpy inputs.

The MLA layers at rtol/atol 1e-5, float and quantized (float activations);
the tiny model (`tiny_config`, float32) built from JAX's numpy tree:
config, stack plan, parameter and cache trees equal JAX's; forward (and the
routers' aux loss), prefill and 3 decode steps at rtol/atol 1e-4 (the
port's model tolerance), unquantized and quantized; decode steps against
the port's own forward with ample capacity at JAX's 2e-4
(tests/test_models.py); greedy tokens of `ServeEngine` against JAX's.

At act_bits=4 the model is held in two parts, as tests/test_torch_moe.py
holds qwen2-moe (ROADMAP C): bitwise against the same model with the JAX
package's kernel in every bit-plane linear and B3's stacked plain version in
the expert stacks; and with JAX's kernel in the stacks too, each stack call
at B3's tolerance against the port's plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import tiny_config as j_tiny_config
from repro.models import attention as jattn
from repro.models.config import AttnConfig as JAttnConfig
from repro.models.config import MLAConfig as JMLAConfig
from repro.models.model import Model as JModel
from repro.models.model import param_defs as j_param_defs
from repro.models.model import stack_plan as j_stack_plan
from repro.models.params import init_params as j_init_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.quantize import quantize_params as j_quantize_params
from repro.serve.quantize import serving_bytes as j_serving_bytes
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, tiny_config
from repro_torch.core.bitplane import BitplaneWeights
from repro_torch.core.engine import EngineLinear, MVDRAMEngine
from repro_torch.kernels.bitplane_gemv import kernel as tkernel
from repro_torch.kernels.bitplane_gemv import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models.config import AttnConfig, MLAConfig, SSMConfig
from repro_torch.models.model import Model, param_defs, stack_plan
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.quantize import (QUANT_LEAF_NAMES,
                                        init_quantized_params,
                                        quantize_params, serving_bytes)
from test_torch_experts_mma import SMS, _b3_close, _bf16_stack, _replay
from test_torch_model import fresh_jax_caches  # noqa: F401
from test_torch_moe import JaxExperts, JaxLinears, _def_leaves

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
B, S, STEPS, MAX_SEQ = 2, 6, 3, 16


@pytest.fixture(scope="module")
def carried():
    """Tiny deepseek (float32) in both packages, on the same values."""
    jcfg = dataclasses.replace(j_tiny_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tiny_config(ARCH), dtype="float32")
    jparams = j_init_params(j_param_defs(jcfg), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, convert.params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def quantized(carried):
    jcfg, tcfg, jparams, tparams = carried
    return (j_quantize_params(jparams, jcfg.weight_bits),
            quantize_params(tparams, tcfg.weight_bits))


def _shapes(defs):
    return jax.tree_util.tree_map(lambda d: d.shape, defs,
                                  is_leaf=lambda x: hasattr(x, "shape"))


# -- the MLA layers ----------------------------------------------------------

E, H = 32, 4
ACFG = dict(num_heads=H, num_kv_heads=H, head_dim=16, rope_base=10000.0)
MLA = dict(kv_lora_rank=24, qk_nope_head_dim=16, qk_rope_head_dim=8,
           v_head_dim=16)


def _mla_params(rng, quantized):
    def n(*shape):
        return (rng.normal(size=shape) * 0.1).astype(np.float32)
    p = {"wq": n(E, H * 24), "w_dkv": n(E, 32),
         "kv_norm": {"scale": n(24)}, "w_uk": n(24, H * 16),
         "w_uv": n(24, H * 16), "wo": n(H * 16, E)}
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = convert.params_from_numpy(p, "cpu")
    if quantized:           # wq, w_dkv, wo: w_uk/w_uv are not listed
        jp, tp = j_quantize_params(jp, 4), quantize_params(tp, 4)
        assert isinstance(tp["w_dkv"], BitplaneWeights)
        assert isinstance(tp["w_uk"], torch.Tensor)
    return jp, tp


@pytest.mark.parametrize("quantized", [False, True])
def test_mla_layers_match_jax(rng, quantized):
    """mla_forward (output and cache products), then decode steps on the
    prefill's cache at per-lane positions — lane 1 three steps behind, over
    slots stamped past its position, which the mask leaves out — outputs
    and caches."""
    jp, tp = _mla_params(rng, quantized)
    jac, jm = JAttnConfig(**ACFG), JMLAConfig(**MLA)
    tac, tm = AttnConfig(**ACFG), MLAConfig(**MLA)
    x = rng.normal(size=(2, S + STEPS, E)).astype(np.float32)
    jo, (jc, jk) = jattn.mla_forward(jnp.asarray(x[:, :S]), jp, jac, jm,
                                     jnp.arange(S), return_kv=True)
    to, (tc, tk) = tattn.mla_forward(torch.from_numpy(x[:, :S]), tp, tac, tm,
                                     torch.arange(S), return_kv=True)
    for got, want in ((to, jo), (tc, jc), (tk, jk)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LAYER_TOL)
    jcache = jattn.mla_cache_init(2, MAX_SEQ, jm, jnp.float32)
    tcache = tattn.mla_cache_init(2, MAX_SEQ, tm, torch.float32)
    assert jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                  jcache) == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in tcache.items()}
    tcache["c_kv"][:, :S], tcache["k_rope"][:, :S] = tc, tk
    tcache["positions"][:, :S] = torch.arange(S, dtype=torch.int32)
    jcache = {k: jnp.asarray(v.numpy()) for k, v in tcache.items()}
    for t in range(S, S + STEPS):
        pos = np.array([t, t - 3], np.int32)
        jo, jcache = jattn.mla_decode(jnp.asarray(x[:, t:t + 1]), jp, jac,
                                      jm, jcache, jnp.asarray(pos))
        to, tcache = tattn.mla_decode(torch.from_numpy(x[:, t:t + 1]), tp,
                                      tac, tm, tcache, torch.from_numpy(pos))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **LAYER_TOL,
                                   err_msg=f"step {t}")
        for k in ("c_kv", "k_rope", "positions"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]), **LAYER_TOL)


def test_mla_absorbed_decode_equals_expanded_forward(rng):
    """The absorbed one-token path from an empty cache against the
    expanded full-sequence one (the JAX package's own test)."""
    _, tp = _mla_params(rng, False)
    tac, tm = AttnConfig(**ACFG), MLAConfig(**MLA)
    s = 12
    x = torch.from_numpy(rng.normal(size=(2, s, E)).astype(np.float32))
    full = tattn.mla_forward(x, tp, tac, tm, torch.arange(s))
    cache = tattn.mla_cache_init(2, s, tm, torch.float32)
    for t in range(s):
        out, cache = tattn.mla_decode(x[:, t:t + 1], tp, tac, tm, cache, t)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(),
                                   **TOL)


# -- configuration ----------------------------------------------------------

def test_config_plan_and_first_stage_match_jax(carried):
    """Configs, stack plans (one leading dense layer, then the repeats),
    parameter trees — `first` with its own d_ff and no experts, MLA's
    leaves with `kv_norm` as wide as the latent — and byte counts."""
    jcfg, tcfg, _, tparams = carried
    assert ARCH in ARCHS
    full, jfull = get_config(ARCH), j_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.num_layers == 3 and tcfg.moe.first_dense_d_ff == 96
    for tc, jc in ((tcfg, jcfg), (full, jfull)):
        assert dataclasses.astuple(stack_plan(tc)) == \
            dataclasses.astuple(j_stack_plan(jc))
        assert _shapes(param_defs(tc)) == _shapes(j_param_defs(jc))
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        for bits in (2, 4):
            assert serving_bytes(param_defs(tc), bits) == \
                j_serving_bytes(j_param_defs(jc), bits)
    assert dataclasses.astuple(stack_plan(full)) == (1, 26, 0)
    first = param_defs(full)["first"]
    assert "moe" not in first and first["ffn"]["up"].shape == (1, 2048, 10944)
    assert first["attn"]["kv_norm"]["scale"].shape == (1, 512)
    assert param_defs(full)["stages"]["0"]["attn"]["w_dkv"].shape == \
        (26, 2048, 576)
    assert set(tparams) == {"embed", "first", "stages", "final_norm",
                            "lm_head"}


def test_full_width_bytes():
    """The byte reckoning of the chip run's memory plan: 15.71 B
    parameters, 14.39 B of them routed experts; q4 planes of 7.72 GB in
    the quantized leaves; one layer's float32 `w_up` stack 0.74 GB."""
    cfg = get_config(ARCH)
    defs = param_defs(cfg)
    assert cfg.param_count() == 15_706_484_224
    moe = defs["stages"]["0"]["moe"]
    assert sum(moe[k].size for k in ("w_up", "w_gate", "w_down")) == \
        26 * 64 * 3 * 2048 * 1408
    assert moe["w_up"].size // 26 * 4 == 738_197_504
    planes = 0
    for path, d in _def_leaves(defs):
        if path[-1] in QUANT_LEAF_NAMES:
            *lead, n, m = d.shape
            planes += int(np.prod(lead)) * 4 * -(-n // 32) * m * 4
    assert planes == 7_718_305_792


def test_init_quantized_params_draws_the_first_stage():
    """`first` and the MLA leaves drawn leaf by leaf: wq, w_dkv, wo and
    the dense FFN as bit planes, w_uk/w_uv and kv_norm float."""
    cfg = tiny_config(ARCH)
    qp = init_quantized_params(param_defs(cfg), cfg.weight_bits,
                               torch.Generator().manual_seed(0), "cpu")
    attn = qp["first"]["attn"]
    for k in ("wq", "w_dkv", "wo"):
        assert isinstance(attn[k], BitplaneWeights)
        assert attn[k].planes.shape[0] == 1
    for k in ("w_uk", "w_uv"):
        assert isinstance(attn[k], torch.Tensor)
    assert isinstance(qp["first"]["ffn"]["down"], BitplaneWeights)
    assert tuple(qp["stages"]["0"]["moe"]["w_up"].planes.shape[:2]) == (2, 8)


def test_live_plan_at_deepseeks_decode_counts():
    """A 4-lane decode step routes 24 (token, expert) pairs, so at most 24
    of 64 experts have rows (`live`): each stack's plan fills the card at
    BLOCKS_PER_SM blocks an SM of 132 with 2 splits of its 4 up/gate
    tiles and 3 of its 3 down tiles."""
    want = tkernel.BLOCKS_PER_SM * SMS
    for (tiles, m), plan in (((4, 1408), (2, 2)), ((3, 2048), (1, 3))):
        assert tkernel.mma_plan(tiles, m, 8, SMS, 64, 24) == plan
        tpb, splits = plan
        assert 24 * -(-m // tkernel.STRIP) * splits >= want
        assert tpb * splits >= tiles > tpb * (splits - 1)


def test_replay_at_deepseeks_decode_counts(rng):
    """The tensor-core kernel's arithmetic, replayed with the plan of
    live = 24 on 64 experts of a decode step's routing (4 lanes, top-6,
    8 capacity rows), against B3's stacked plain version."""
    e, r, n, m, q = 64, 8, 256, 96, 4
    picks = np.stack([rng.permutation(e)[:6] for _ in range(4)])
    counts = np.bincount(picks.reshape(-1), minlength=e).astype(np.int32)
    assert (counts > 0).sum() <= 24
    w = rng.normal(size=(e, n, m)).astype(np.float32)
    tw = quantize_params({"w_up": torch.from_numpy(w)}, q)["w_up"]
    x = _bf16_stack(rng, e, r, n, counts)
    bn = 256
    scale_t = tw.scale.expand(e, -(-n // bn), m)
    got = _replay(x, tw.planes, scale_t, counts, q=q, zero=tw.zero, bn=bn,
                  live=24)
    want = tref.gemv_f_experts_ref(
        torch.from_numpy(x).to(torch.bfloat16), tw.planes, scale_t,
        torch.from_numpy(counts), q=q, zero=tw.zero, bn=bn, live=24)
    _b3_close(got, want.numpy())


# -- the tiny model ---------------------------------------------------------

def _models(carried, quantized, q):
    jcfg, tcfg, jparams, tparams = carried
    if q:
        jparams, tparams = quantized
    impl = EngineLinear(MVDRAMEngine()) if q else None
    return JModel(jcfg), jparams, Model(tcfg, impl=impl), tparams


@pytest.mark.parametrize("q", [False, True])
def test_model_matches_jax(rng, carried, quantized, q):
    """Forward (logits and the routers' aux loss), prefill (logits and the
    cache of `first` and the stages) and 3 decode steps; quantized with
    float activations through B3's plain versions."""
    jm, jp, tm, tp = _models(carried, quantized, q)
    toks = rng.integers(0, 256, size=(B, S + STEPS))
    jl, ja = jm.forward(jp, {"tokens": jnp.asarray(toks[:, :S])})
    with torch.no_grad():
        tl, ta = tm.forward(tp, {"tokens": torch.from_numpy(toks[:, :S])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-6)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, MAX_SEQ)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])},
                            MAX_SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert _shapes(jc) == _shapes(tc)
    for name in ("first", "stages"):
        jstack = jc[name] if name == "first" else jc[name]["0"]
        tstack = tc[name] if name == "first" else tc[name]["0"]
        np.testing.assert_array_equal(tstack["positions"].numpy(),
                                      np.asarray(jstack["positions"]))
    np.testing.assert_allclose(tc["first"]["c_kv"].numpy(),
                               np.asarray(jc["first"]["c_kv"]), **TOL)
    for t in range(S, S + STEPS):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t]),
                                jnp.int32(t))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t]), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {t}")
    assert int(tc["first"]["positions"][0, 0, S + STEPS - 1]) == \
        S + STEPS - 1


def test_decode_matches_forward_ample_capacity(rng, carried):
    """Decode steps from an empty cache against the port's own forward
    (the JAX package's test, capacity factor 8: no drops either way)."""
    _, tcfg, _, tp = carried
    cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=8.0))
    model = Model(cfg)
    n = 12
    toks = torch.from_numpy(rng.integers(0, 256, size=(B, n)))
    with torch.no_grad():
        logits, _ = model.forward(tp, {"tokens": toks})
        cache = model.init_cache(B, n)
        assert set(cache) == {"first", "stages"}
        for t in range(n):
            lg, cache = model.decode_step(tp, cache, toks[:, t], t)
            np.testing.assert_allclose(lg.numpy(), logits[:, t].numpy(),
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"step {t}")


def test_act_bits4_model_bitwise_with_jax_linears(rng, carried, quantized):
    """act_bits=4: wq, w_dkv and wo each through B1's plain version (two
    linears then wo, as in the JAX package), the dense and shared up/gate
    through B2's, the downs and lm_head through B1's, the experts through
    B3's stacked one — bitwise equal to the same model with JAX's kernel in
    every bit-plane linear; with JAX's kernel in every expert stack too,
    each stack call within B3's tolerance of the port's."""
    _, tcfg, _, _ = carried
    _, qp = quantized
    eng = MVDRAMEngine()
    port = Model(tcfg, act_bits=4, impl=EngineLinear(eng))
    hybrid = Model(tcfg, act_bits=4, impl=JaxLinears())
    jax_experts = JaxExperts()
    all_jax = Model(tcfg, act_bits=4, impl=jax_experts)
    toks = torch.from_numpy(rng.integers(0, 256, size=(B, S + STEPS)))
    with torch.no_grad():
        a, ca = port.prefill(qp, {"tokens": toks[:, :S]}, MAX_SEQ)
        b, cb = hybrid.prefill(qp, {"tokens": toks[:, :S]}, MAX_SEQ)
        _, cc = all_jax.prefill(qp, {"tokens": toks[:, :S]}, MAX_SEQ)
        assert torch.equal(a, b)
        for t in range(S, S + STEPS):
            a, ca = port.decode_step(qp, ca, toks[:, t], t)
            b, cb = hybrid.decode_step(qp, cb, toks[:, t], t)
            _, cc = all_jax.decode_step(qp, cc, toks[:, t], t)
            assert torch.equal(a, b), f"decode step {t}"
    # 3 stacks a MoE layer, 2 MoE layers, prefill and 3 decode steps
    assert jax_experts.held == 3 * 2 * (1 + STEPS)
    # a pass: 3 MLA linears a layer, the dense FFN's 3 and the shared
    # FFN's 3 (up/gate as one group), lm_head
    assert eng.routed_linears == (1 + STEPS) * (3 * 3 + 3 + 2 * 3 + 1)


@pytest.mark.parametrize("q", [False, True])
def test_serve_tokens_match_jax(carried, q):
    jcfg, tcfg, jparams, tparams = carried
    prompts = np.random.default_rng(1).integers(0, 256, size=(3, 6))
    want = np.asarray(JServeEngine(jcfg, jparams, max_seq=24, batch_slots=3,
                                   quantized=q).generate(
        jnp.asarray(prompts, jnp.int32), max_new=8, scan=False))
    got = ServeEngine(tcfg, tparams, max_seq=24, batch_slots=3, quantized=q,
                      device="cpu").generate(prompts, max_new=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_cli_runs_deepseek_on_cpu(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", ARCH, "--tiny", "--quantized", "--act-bits",
                    "4", "--tokens", "4", "--batch", "2", "--device", "cpu"])
    assert "generated shape: (2, 20)" in capsys.readouterr().out


# -- what is still refused ---------------------------------------------------

TINY_SSM = SSMConfig(d_state=16, head_dim=16, chunk=8)


@pytest.mark.parametrize("what,change", [
    ("SSM stages", dict(ssm=TINY_SSM, pattern=("mamba",))),
    ("SSM stages", dict(ssm=TINY_SSM, pattern=("attn", "mamba"),
                        num_layers=4)),
    ("hybrid shared blocks", dict(num_shared_blocks=2, shared_every=1)),
    ("no attention config", dict(attn=None, mla=None)),
])
def test_check_supported_refuses_only_ssm_and_hybrid(what, change):
    """SSM stages and hybrid shared blocks are ported now: the model and
    its tree build (beside MLA stages too); only attention stages with no
    attention config are refused."""
    cfg = dataclasses.replace(tiny_config(ARCH), moe=None, **change)
    assert get_config("mamba2-1.3b").name == "mamba2-1.3b"
    if what == "no attention config":
        with pytest.raises(NotImplementedError, match=what):
            Model(cfg)
        with pytest.raises(NotImplementedError, match=what):
            param_defs(cfg)
        return
    Model(cfg)
    defs = param_defs(cfg)
    kinds = {"mamba" if "mamba" in d else "attn"
             for d in defs["stages"].values()}
    assert kinds == set(cfg.pattern)
    assert ("shared" in defs) == (what == "hybrid shared blocks")
