"""Port parity: the mixture-of-experts FFN (`repro_torch.models.moe`) and
tiny qwen2-moe-a2.7b against the JAX package, on the same numpy inputs.

Router gates, masks and aux loss at 1e-5; `moe_ffn` (capacity dispatch,
with and without drops, one group and several, shared experts) and
`moe_decode` on float weights at 1e-4 (tests/test_moe.py's tolerance);
E-stacked BitplaneWeights through `_expert_mm` at B3's tolerance (rtol
1e-5, atol 1e-5·max|ref|, tests/test_kernels.py) against JAX's
`pallas_interpret`; quantized expert stacks bitwise; the tiny model's
forward, prefill and decode at 1e-4, unquantized and with float
activations, and its greedy tokens against JAX `ServeEngine`.

At act_bits=4 the model is held bitwise against the same model with the
JAX package's kernel in every bit-plane linear (the integer kernels B1/B2
are bitwise equal on equal inputs). The routed experts take float
activations at every act_bits (B3, as in the JAX package), and B3 sums
floats in another order than XLA, so the expert stacks cannot be bitwise:
the act_bits=4 model is also run with the JAX package's kernel in every
expert stack, and each of those calls is held at B3's tolerance against
the port's plain version on the same inputs (ROADMAP C).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import tiny_config as j_tiny_config
from repro.core.bitplane import BitplaneWeights as JBitplaneWeights
from repro.core.quant import QuantSpec as JQuantSpec
from repro.kernels.bitplane_gemv import ops as jops
from repro.models import moe as jmoe
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.model import Model as JModel
from repro.models.model import param_defs as j_param_defs
from repro.models.params import init_params as j_init_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.quantize import quantize_params as j_quantize_params
from repro.serve.quantize import serving_bytes as j_serving_bytes
from repro_torch import convert
from repro_torch.configs import get_config, tiny_config
from repro_torch.core.backends import REFERENCE
from repro_torch.core.bitplane import BitplaneWeights
from repro_torch.core.engine import EngineLinear, MVDRAMEngine
from repro_torch.kernels.bitplane_gemv import kernel as tkernel
from repro_torch.kernels.bitplane_gemv import ref as tref
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MLAConfig, MoEConfig, SSMConfig
from repro_torch.models.model import Model, param_defs
from repro_torch.models.params import init_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.quantize import (QUANT_LEAF_NAMES,
                                        init_quantized_params,
                                        quantize_params, serving_bytes)
from test_torch_model import JaxLinear, fresh_jax_caches  # noqa: F401

ARCH = "qwen2-moe-a2.7b"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS, MAX_SEQ = 2, 6, 3, 16


def _b3_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def carried():
    """Tiny qwen2-moe (float32) in both packages, on the same values."""
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


def _moe_weights(rng, d, ex, f, shared):
    def n(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    p = {"router": n(d, ex, scale=0.5), "w_up": n(ex, d, f, scale=d ** -.5),
         "w_gate": n(ex, d, f, scale=d ** -.5),
         "w_down": n(ex, f, d, scale=f ** -.5)}
    if shared:
        p |= {"shared_up": n(d, shared, scale=d ** -.5),
              "shared_gate": n(d, shared, scale=d ** -.5),
              "shared_down": n(shared, d, scale=shared ** -.5)}
    return p


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


# -- configuration ----------------------------------------------------------

def test_configs_and_defs_match_jax(carried):
    jcfg, tcfg, _, _ = carried
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    for tc, jc in ((tcfg, jcfg), (get_config(ARCH), j_get_config(ARCH))):
        jshapes = jax.tree_util.tree_map(
            lambda d: d.shape, j_param_defs(jc),
            is_leaf=lambda x: hasattr(x, "shape"))
        tshapes = jax.tree_util.tree_map(
            lambda d: d.shape, param_defs(tc),
            is_leaf=lambda x: hasattr(x, "shape"))
        assert tshapes == jshapes
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()


def test_full_width_bytes():
    """The byte reckoning the chip run's memory plan rests on: 15.14 B
    parameters, 13.29 B of them routed experts; a float32 `w_up` leaf of
    17.7 GB; 7.42 GB of q4 planes in all the quantized leaves."""
    cfg = get_config(ARCH)
    defs = param_defs(cfg)
    assert cfg.param_count() == 15_146_403_840
    experts = 24 * 64 * 3 * 2048 * 1408
    assert sum(defs["stages"]["0"]["moe"][k].size
               for k in ("w_up", "w_gate", "w_down")) == experts
    assert defs["stages"]["0"]["moe"]["w_up"].size * 4 == 17_716_740_096
    planes = 0
    for path_leaf in _def_leaves(defs):
        path, d = path_leaf
        if path[-1] in QUANT_LEAF_NAMES:
            *lead, n, m = d.shape
            planes += int(np.prod(lead)) * 4 * -(-n // 32) * m * 4
    assert planes == 7_415_922_688


def _def_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _def_leaves(v, path + (k,))
    else:
        yield path, tree


def test_mla_and_ssm_configs_still_raise():
    """MLA, leading dense-FFN layers and SSM stages are all ported now (a
    MoE config takes them); a Mamba2 stage needs an SSM config."""
    cfg = tiny_config(ARCH)
    for ok in (dataclasses.replace(cfg, mla=MLAConfig()),
               dataclasses.replace(cfg, moe=dataclasses.replace(
                   cfg.moe, first_dense=1, first_dense_d_ff=96)),
               dataclasses.replace(cfg, ssm=SSMConfig(), pattern=("mamba",))):
        Model(ok)
        assert set(param_defs(ok)) >= {"stages", "lm_head"}
    assert "mamba" in param_defs(dataclasses.replace(
        cfg, ssm=SSMConfig(), pattern=("mamba",)))["stages"]["0"]
    assert get_config("mamba2-1.3b").ssm == SSMConfig()
    with pytest.raises(NotImplementedError, match="no SSM config"):
        Model(dataclasses.replace(cfg, pattern=("mamba",)))


# -- router, capacity -------------------------------------------------------

@pytest.mark.parametrize("ties", [False, True])
def test_router_matches_jax(rng, ties):
    """Gates, top-k mask and aux loss; with every logit equal (ties),
    both pick the lowest expert indices."""
    cfg = MoEConfig(num_experts=8, top_k=3, d_expert=16)
    jcfg = JMoEConfig(num_experts=8, top_k=3, d_expert=16)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32) * 0.3
    if ties:
        w[:] = 0.0
    jg, jm, ja = jmoe.router(jnp.asarray(x), jnp.asarray(w), jcfg)
    tg, tm, ta = tmoe.router(torch.from_numpy(x), torch.from_numpy(w), cfg)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-5)
    if ties:
        assert (tm.numpy()[..., :3] == 1).all() and tm.numpy().sum() == 30


@pytest.mark.parametrize("tokens,k,cf,ex", [
    (4, 4, 2.0, 64), (64, 4, 2.0, 64), (256, 6, 1.25, 64), (12, 2, 1.25, 8),
    (1000, 2, 1.0, 8), (7, 1, 0.5, 3)])
def test_capacity_matches_jax(tokens, k, cf, ex):
    cfg = MoEConfig(num_experts=ex, top_k=k, d_expert=8, capacity_factor=cf)
    jcfg = JMoEConfig(num_experts=ex, top_k=k, d_expert=8,
                      capacity_factor=cf)
    assert tmoe._capacity(tokens, cfg) == jmoe._capacity(tokens, jcfg)
    assert tmoe._capacity(tokens, cfg) % 8 == 0


# -- the FFN on float weights -----------------------------------------------

@pytest.mark.parametrize("s,cf,group,shared,ffn_type", [
    (6, 1.25, 256, 64, "glu"),      # one group, no drops, shared experts
    (40, 0.25, 256, 64, "glu"),     # one group, drops
    (48, 0.5, 48, None, "glu"),     # two groups, drops, no shared
    (12, 2.0, 4, 64, "mlp"),        # several groups, classic MLP experts
])
def test_moe_ffn_matches_jax(rng, s, cf, group, shared, ffn_type):
    ex, d, f = 8, 32, 24
    cfg = MoEConfig(num_experts=ex, top_k=2, d_expert=f, capacity_factor=cf)
    jcfg = JMoEConfig(num_experts=ex, top_k=2, d_expert=f,
                      capacity_factor=cf)
    jp, tp = _both(_moe_weights(rng, d, ex, f, shared))
    x = rng.normal(size=(2, s, d)).astype(np.float32)
    jo, ja = jmoe.moe_ffn(jnp.asarray(x), jp, jcfg, ffn_type,
                          group_size=group)
    to, ta = tmoe.moe_ffn(torch.from_numpy(x), tp, cfg, ffn_type,
                          group_size=group)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-5)
    if cf < 1:   # the case drops tokens: some (token, expert) pair lost
        gsz = min(group, 2 * s)
        _, mask, _ = tmoe.router(torch.from_numpy(x).reshape(-1, gsz, d),
                                 tp["router"], cfg)
        assert bool((mask.sum(dim=1) > tmoe._capacity(gsz, cfg)).any())


def test_moe_decode_matches_jax(rng):
    ex, d, f = 8, 32, 24
    cfg = MoEConfig(num_experts=ex, top_k=2, d_expert=f)
    jcfg = JMoEConfig(num_experts=ex, top_k=2, d_expert=f)
    jp, tp = _both(_moe_weights(rng, d, ex, f, 64))
    x = rng.normal(size=(3, 1, d)).astype(np.float32)
    np.testing.assert_allclose(
        tmoe.moe_decode(torch.from_numpy(x), tp, cfg).numpy(),
        np.asarray(jmoe.moe_decode(jnp.asarray(x), jp, jcfg)), **TOL)


# -- expert stacks as bit planes --------------------------------------------

def _expert_stack(rng, ex, n, m, q):
    w = rng.normal(size=(ex, n, m)).astype(np.float32)
    jq = j_quantize_params({"w_up": jnp.asarray(w)}, q)["w_up"]
    tq = quantize_params({"w_up": torch.from_numpy(w)}, q)["w_up"]
    return jq, tq


@pytest.mark.parametrize("ex,g,c,n,m,q", [
    (8, 1, 8, 64, 32, 4), (8, 2, 8, 32, 64, 4), (4, 1, 8, 300, 90, 2),
    (1, 1, 16, 130, 40, 3)])
def test_expert_mm_matches_pallas_interpret(rng, ex, g, c, n, m, q):
    """`_expert_mm` on an E-stacked BitplaneWeights (B3's stacked plain
    version) against the JAX package's vmap of B3 in interpret mode."""
    jw, tw = _expert_stack(rng, ex, n, m, q)
    xe = rng.normal(size=(g, ex, c, n)).astype(np.float32)
    want = np.asarray(jmoe._expert_mm(jnp.asarray(xe), jw,
                                      "pallas_interpret"))
    xt = torch.from_numpy(xe.transpose(1, 0, 2, 3).reshape(ex, g * c, n)
                          .copy())
    for impl in (None, EngineLinear(MVDRAMEngine())):
        got = tmoe._expert_mm(xt, tw, impl)
        got = got.reshape(ex, g, c, m).permute(1, 0, 2, 3).numpy()
        _b3_close(got, want)


def test_expert_mm_counts_skip_only_zero_rows(rng):
    """Rows past an expert's count are zero in the dispatch buffer: with
    counts the result is the same, bitwise."""
    jw, tw = _expert_stack(rng, 4, 64, 48, 4)
    counts = torch.tensor([0, 3, 8, 5], dtype=torch.int32)
    xe = torch.from_numpy(rng.normal(size=(4, 8, 64)).astype(np.float32))
    live = torch.arange(8)[None, :] < counts[:, None]
    xe = torch.where(live[..., None], xe, 0.0)
    with_counts = tmoe._expert_mm(xe, tw, None, counts)
    assert torch.equal(with_counts, tmoe._expert_mm(xe, tw, None))
    assert not bool(with_counts[0].any())
    assert not bool(with_counts[1, 3:].any())


def test_stacked_plain_version_is_the_per_expert_loop(rng):
    """The stacked plain version is B3's plain version per expert, bitwise;
    one call counts once, and rows past counts[e] count as zero."""
    _, tw = _expert_stack(rng, 5, 300, 90, 3)
    a = torch.from_numpy(rng.normal(size=(5, 6, 512)).astype(np.float32))
    a[..., 300:] = 0.0
    scale_t = tw.scale.expand(5, 1, 90)
    c0 = dict(tref.CALLS)
    got = tref.gemv_f_experts_ref(a, tw.planes, scale_t, q=3, zero=tw.zero,
                                  bn=512)
    assert tref.CALLS["gemv_f_experts"] == c0["gemv_f_experts"] + 1
    for e in range(5):
        want = tref.gemv_f_ref(a[e], tw.planes[e], scale_t[e], q=3,
                               zero=tw.zero, bn=512)
        assert torch.equal(got[e], want)
    counts = torch.tensor([6, 0, 2, 4, 1], dtype=torch.int32)
    cut = tref.gemv_f_experts_ref(a, tw.planes, scale_t, counts, q=3,
                                  zero=tw.zero, bn=512)
    for e, cnt in enumerate(counts.tolist()):
        assert torch.equal(cut[e, :cnt], got[e, :cnt])
        assert not bool(cut[e, cnt:].any())


def test_cpu_tensors_run_the_stacked_plain_version(rng):
    _, tw = _expert_stack(rng, 3, 64, 40, 4)
    xe = torch.from_numpy(rng.normal(size=(3, 8, 64)).astype(np.float32))
    k0, r0 = dict(tkernel.LAUNCHES), dict(tref.CALLS)
    tmoe._expert_mm(xe, tw)
    assert tkernel.LAUNCHES == k0
    assert tref.CALLS["gemv_f_experts"] == r0["gemv_f_experts"] + 1
    assert tref.CALLS["gemv_f"] == r0["gemv_f"]      # no per-expert call


def test_split_plan_takes_every_experts_strips():
    """qwen2-moe's stacks fill the card without splitting the tiles; one
    expert plans as one leaf does."""
    assert tkernel.split_plan(4, 1408, 8, 132, experts=64) == (4, 1)
    assert tkernel.split_plan(3, 2048, 8, 132, experts=64) == (3, 1)
    for args in ((22, 256, 4, 132), (4, 1408, 8, 132), (8, 4096, 4, 132)):
        assert tkernel.split_plan(*args, experts=1) == \
            tkernel.split_plan(*args)
    assert tkernel.split_plan(8, 130, 4, 132, experts=2) == (1, 8)
    with pytest.raises(ValueError, match="experts=0"):
        tkernel.split_plan(4, 128, 4, 132, experts=0)


def test_quantized_expert_stacks_equal_jax(carried, quantized):
    """(L, E, q, W, M) planes, (L, E, 1, M) scales, (L, E, M) col_sum,
    bitwise; JAX's quantized tree carried across from numpy gives the same
    leaves; serving_bytes counts the stacks as the JAX package does."""
    jcfg, tcfg, _, _ = carried
    jq, tq = quantized
    carried_q = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jq), "cpu")
    for k in ("w_up", "w_gate", "w_down", "shared_up", "shared_down"):
        jw = jq["stages"]["0"]["moe"][k]
        for tw in (tq["stages"]["0"]["moe"][k],
                   carried_q["stages"]["0"]["moe"][k]):
            assert isinstance(tw, BitplaneWeights)
            assert np.array_equal(np.asarray(jw.planes).view(np.int32),
                                  tw.planes.numpy())
            assert np.array_equal(np.asarray(jw.scale), tw.scale.numpy())
            assert np.array_equal(np.asarray(jw.col_sum),
                                  tw.col_sum.numpy())
            assert (tw.zero, tw.n) == (jw.zero, jw.n)
    w_up = tq["stages"]["0"]["moe"]["w_up"]
    assert tuple(w_up.planes.shape) == (2, 8, 4, 2, 32)
    assert tuple(w_up[1].planes.shape) == (8, 4, 2, 32)
    assert tuple(w_up[1][3].planes.shape) == (4, 2, 32)
    assert torch.equal(w_up[1][3].planes, w_up.planes[1, 3])
    assert isinstance(tq["stages"]["0"]["moe"]["router"], torch.Tensor)
    for bits in (2, 4):
        assert serving_bytes(param_defs(tcfg), bits) == \
            j_serving_bytes(j_param_defs(jcfg), bits)
        full = get_config(ARCH)
        assert serving_bytes(param_defs(full), bits) == \
            j_serving_bytes(j_param_defs(j_get_config(ARCH)), bits)


def test_init_quantized_params_quantizes_its_own_draws(carried):
    _, tcfg, _, _ = carried
    defs = param_defs(tcfg)

    def draws(tree, gen, path=()):
        if isinstance(tree, dict):
            return {k: draws(v, gen, path + (k,)) for k, v in tree.items()}
        if path[-1] in QUANT_LEAF_NAMES and len(tree.shape) >= 3:
            one = dataclasses.replace(tree, shape=tree.shape[1:],
                                      axes=tree.axes[1:])
            return torch.stack([init_params(one, gen)
                                for _ in range(tree.shape[0])])
        return init_params(tree, gen)

    want = quantize_params(draws(defs, torch.Generator().manual_seed(3)),
                           tcfg.weight_bits)
    got = init_quantized_params(defs, tcfg.weight_bits,
                                torch.Generator().manual_seed(3), "cpu")

    def check(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                check(a[k], b[k])
        elif isinstance(a, BitplaneWeights):
            assert isinstance(b, BitplaneWeights)
            for f in ("planes", "scale", "col_sum"):
                assert torch.equal(getattr(a, f), getattr(b, f))
        else:
            assert torch.equal(a, b)
    check(want, got)


# -- the tiny model ---------------------------------------------------------

def _models(carried, quantized, q):
    jcfg, tcfg, jparams, tparams = carried
    if q:
        jparams, tparams = quantized
    impl = EngineLinear(MVDRAMEngine()) if q else None
    return JModel(jcfg), jparams, Model(tcfg, impl=impl), tparams


@pytest.mark.parametrize("q", [False, True])
def test_model_matches_jax(rng, carried, quantized, q):
    """Forward (logits and the routers' aux loss), prefill and 3 decode
    steps; quantized with float activations through B3's plain versions,
    the expert stacks through its stacked one."""
    jm, jp, tm, tp = _models(carried, quantized, q)
    toks = rng.integers(0, 256, size=(B, S + STEPS))
    jl, ja = jm.forward(jp, {"tokens": jnp.asarray(toks[:, :S])})
    with torch.no_grad():
        tl, ta = tm.forward(tp, {"tokens": torch.from_numpy(toks[:, :S])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-6)
    assert float(ta) > 0
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, MAX_SEQ)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])},
                            MAX_SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for t in range(S, S + STEPS):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t]),
                                jnp.int32(t))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t]), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {t}")


class JaxLinears(JaxLinear):
    """`JaxLinear`, standing for the reference backend where a layer asks
    for one (the expert stacks: B3's stacked plain version)."""

    backend = REFERENCE


class JaxExperts(JaxLinear):
    """`JaxLinear`, and every expert stack through the JAX package's
    vmap of B3 (`impl="jnp"`), each call also held at B3's tolerance
    against the port's stacked plain version on the same inputs."""

    def __init__(self):
        self.held = 0

    def __call__(self, x, w, act_bits=None):
        if w.planes.ndim == 3:
            return super().__call__(x, w, act_bits)
        jw = JBitplaneWeights(
            planes=jnp.asarray(w.planes.numpy().view(np.uint32)),
            scale=jnp.asarray(w.scale.numpy()), zero=w.zero,
            col_sum=jnp.asarray(w.col_sum.numpy()), n=w.n,
            spec=JQuantSpec(bits=w.spec.bits))
        out = np.array(jax.vmap(lambda xx, ww: jops.bitplane_gemv(
            xx, ww, impl="jnp"))(jnp.asarray(x.numpy()), jw))
        _b3_close(tmoe._expert_mm(x, w, "reference").numpy(), out)
        self.held += 1
        return torch.from_numpy(out)


def test_act_bits4_model_bitwise_with_jax_linears(rng, carried, quantized):
    """act_bits=4: q/k/v and shared up/gate through B2's plain version,
    wo, shared_down and lm_head through B1's, the experts through B3's
    stacked one — bitwise equal to the same model with JAX's kernel in
    every bit-plane linear; and with JAX's kernel in every expert stack
    too, each stack call within B3's tolerance of the port's."""
    _, tcfg, _, _ = carried
    _, qp = quantized
    port = Model(tcfg, act_bits=4, impl=EngineLinear(MVDRAMEngine()))
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
    # 3 stacks a layer, 2 layers, prefill and 3 decode steps
    assert jax_experts.held == 3 * 2 * (1 + STEPS)


@pytest.mark.parametrize("q", [False, True])
def test_serve_tokens_match_jax(carried, q):
    jcfg, tcfg, jparams, tparams = carried
    prompts = np.random.default_rng(1).integers(0, 256, size=(3, 6))
    jeng = JServeEngine(jcfg, jparams, max_seq=24, batch_slots=3,
                        quantized=q)
    want = np.asarray(jeng.generate(jnp.asarray(prompts, jnp.int32),
                                    max_new=8, scan=False))
    teng = ServeEngine(tcfg, tparams, max_seq=24, batch_slots=3,
                       quantized=q, device="cpu")
    r0 = dict(tref.CALLS)
    got = teng.generate(prompts, max_new=8)
    np.testing.assert_array_equal(got.numpy(), want)
    if q:    # one stacked call per expert matrix: 3 a layer, 2 layers
        assert tref.CALLS["gemv_f_experts"] - r0["gemv_f_experts"] == \
            3 * 2 * 8


@pytest.mark.parametrize("extra", [[], ["--act-bits", "4"]])
def test_serve_cli_runs_qwen2_moe_on_cpu(capsys, extra):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", ARCH, "--tiny", "--quantized", "--tokens",
                    "4", "--batch", "2", "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert "generated shape: (2, 20)" in out
    assert "tokens/s:" in out
