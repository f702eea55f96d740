"""Port parity: the hybrid (tiny zamba2-7b: Mamba2 layers in groups of two,
a shared attention + GLU block invoked after every group, alternating
between two parameter sets, a trailing Mamba2 layer) against the JAX
package, on the same numpy parameter tree.

The stack plan and parameter tree; forward, prefill, decode and every
cache leaf at rtol/atol 1e-4 (the port's model tolerance), unquantized and
quantized with float activations, with a bf16 and an int8 KV cache, and
decode attention through B4's plain version; a configuration with three
groups, where invocation 2 reads parameter set 0 but its own cache 2; the
act_bits=4 model bitwise against the same model with the JAX package's
kernel in every bit-plane linear; `ServeEngine`'s greedy tokens against
JAX `ServeEngine`'s; the CLI.
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
from repro.models.model import stack_plan as j_stack_plan
from repro.models.params import init_params as j_init_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.quantize import quantize_params as j_quantize_params
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, long_ok, tiny_config
from repro_torch.core.engine import EngineLinear, MVDRAMEngine
from repro_torch.models import model as tmodel
from repro_torch.models.model import Model, param_defs, stack_plan
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.quantize import quantize_params
from test_torch_model import JaxLinear, fresh_jax_caches  # noqa: F401

ARCH = "zamba2-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS, MAX_SEQ = 2, 8, 3, 16


def _shapes(defs):
    return jax.tree_util.tree_map(lambda d: d.shape, defs,
                                  is_leaf=lambda x: hasattr(x, "shape"))


def _carry(layers=None, key=0):
    """A tiny zamba2 (float32, `layers` Mamba2 layers) in both packages,
    on the same values."""
    jcfg = dataclasses.replace(j_tiny_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tiny_config(ARCH), dtype="float32")
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        tcfg = dataclasses.replace(tcfg, num_layers=layers)
    jparams = j_init_params(j_param_defs(jcfg), jax.random.PRNGKey(key))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, convert.params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def carried():
    return _carry()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _cache_close(tc, jc):
    jl = dict(_leaves(jc))
    tl = dict(_leaves(tc))
    assert set(tl) == set(jl)
    for path, v in tl.items():
        np.testing.assert_allclose(v.float().numpy(),
                                   np.asarray(jl[path], np.float32), **TOL,
                                   err_msg=str(path))


def _run_both(jm, jp, tm, tp, toks):
    """Prefill on toks[:, :S], then decode the rest one token a step:
    logits and every cache leaf held at TOL."""
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, MAX_SEQ)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])},
                            MAX_SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _cache_close(tc, jc)
    for t in range(S, toks.shape[1]):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t]),
                                jnp.int32(t))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t]), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {t}")
    _cache_close(tc, jc)
    return tc


# -- configuration -----------------------------------------------------------

def test_configs_plans_and_trees_match_jax(carried):
    jcfg, tcfg, _, tparams = carried
    assert ARCH in ARCHS and long_ok(ARCH)
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for tc, jc in ((tcfg, jcfg), (get_config(ARCH), j_get_config(ARCH))):
        assert dataclasses.astuple(stack_plan(tc)) == \
            dataclasses.astuple(j_stack_plan(jc))
        assert _shapes(param_defs(tc)) == _shapes(j_param_defs(jc))
        assert tc.param_count() == jc.param_count()
    assert dataclasses.astuple(stack_plan(get_config(ARCH))) == (0, 13, 3)
    assert dataclasses.astuple(stack_plan(tcfg)) == (0, 2, 1)
    assert set(tparams) == {"embed", "stages", "shared", "trailing",
                            "final_norm", "lm_head"}
    assert tparams["shared"]["attn"]["wq"].shape[0] == 2


def test_layer_order_and_shared_indices():
    """Each group's stages, then its shared invocation (parameters r mod
    2, cache r), then the trailing layers."""
    cfg = dataclasses.replace(tiny_config(ARCH), num_layers=7)
    params = tmodel.init_params(param_defs(cfg),
                                torch.Generator().manual_seed(0), "cpu")
    seen = [(name, r, kind) for _p, name, r, kind
            in Model(cfg)._layers(params)]
    group = [("0", "mamba"), ("1", "mamba"), ("shared", "attn")]
    assert seen == [(n, r, k) for r in range(3) for n, k in group] + [
        ("trailing", 0, "mamba")]
    wq = params["shared"]["attn"]["wq"]
    shared = [p["attn"]["wq"] for p, name, _r, _k
              in Model(cfg)._layers(params) if name == "shared"]
    for r, w in enumerate(shared):
        assert w.data_ptr() == wq[r % 2].data_ptr()


# -- the model against JAX ---------------------------------------------------

@pytest.mark.parametrize("quantized,kv_bits", [(False, None), (False, 8),
                                               (True, None)])
def test_prefill_decode_and_caches_match_jax(rng, carried, quantized,
                                             kv_bits):
    jcfg, tcfg, jp, tp = carried
    if quantized:
        jp = j_quantize_params(jp, jcfg.weight_bits)
        tp = quantize_params(tp, tcfg.weight_bits)
    jm = JModel(jcfg, kv_bits=kv_bits)
    tm = Model(tcfg, impl=EngineLinear(MVDRAMEngine()) if quantized
               else None, kv_bits=kv_bits)
    toks = rng.integers(0, 256, size=(B, S + STEPS))
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks[:, :S])})
    with torch.no_grad():
        tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks[:, :S])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _run_both(jm, jp, tm, tp, toks)


def test_decode_attention_through_b4_matches_jax(rng, carried):
    """The shared blocks' decode attention through B4 (its plain version
    on the CPU) on the int8 cache, against the JAX package's `sdpa`."""
    jcfg, tcfg, jp, tp = carried
    toks = rng.integers(0, 256, size=(B, S + STEPS))
    _run_both(JModel(jcfg, kv_bits=8), jp,
              Model(tcfg, kv_bits=8, attn_impl="kernel"), tp, toks)


def test_invocation_r_reads_cache_r():
    """Three groups over two parameter sets: invocation 2 reads parameters
    shared[0] and cache shared[2]. A port that read cache r mod 2 would
    attend over invocation 0's keys and miss JAX's logits; its cache
    would hold two stamped invocations, not three."""
    jcfg, tcfg, jp, tp = _carry(layers=7, key=3)
    assert dataclasses.astuple(stack_plan(tcfg)) == (0, 3, 1)
    toks = np.random.default_rng(4).integers(0, 256, size=(B, S + STEPS))
    tc = _run_both(JModel(jcfg), jp, Model(tcfg), tp, toks)
    pos = tc["shared"]["positions"]
    assert tuple(pos.shape[:2]) == (3, B)
    for r in range(3):
        assert int(pos[r].max()) == S + STEPS - 1, f"invocation {r}"
    for r, (a, b) in enumerate(((0, 2), (1, 2))):
        assert not torch.equal(tc["shared"]["k"][a], tc["shared"]["k"][b])


def test_init_cache_matches_jax(carried):
    jcfg, tcfg, _, _ = carried
    for kv_bits in (None, 8):
        jc = JModel(jcfg, kv_bits=kv_bits).init_cache(B, MAX_SEQ)
        tc = Model(tcfg, kv_bits=kv_bits).init_cache(B, MAX_SEQ)
        assert {p: tuple(v.shape) for p, v in _leaves(tc)} == \
            {p: v.shape for p, v in _leaves(jc)}
        assert tuple(tc["shared"]["k"].shape[:1]) == (2,)   # 2 invocations


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_act_bits4_model_bitwise_with_jax_linears(rng, carried, kv_bits):
    """act_bits=4: the shared blocks' q/k/v and up/gate through B2's plain
    version, wo, down, in_proj, out_proj and lm_head through B1's, bitwise
    against the same model with JAX's kernel in every bit-plane linear."""
    _, tcfg, _, tparams = carried
    qp = quantize_params(tparams, tcfg.weight_bits)
    port = Model(tcfg, act_bits=4, impl=EngineLinear(MVDRAMEngine()),
                 kv_bits=kv_bits)
    hybrid = Model(tcfg, act_bits=4, impl=JaxLinear(), kv_bits=kv_bits)
    toks = torch.from_numpy(rng.integers(0, 256, size=(B, S + STEPS)))
    with torch.no_grad():
        a, ca = port.prefill(qp, {"tokens": toks[:, :S]}, MAX_SEQ)
        b, cb = hybrid.prefill(qp, {"tokens": toks[:, :S]}, MAX_SEQ)
        assert torch.equal(a, b)
        for t in range(S, S + STEPS):
            a, ca = port.decode_step(qp, ca, toks[:, t], t)
            b, cb = hybrid.decode_step(qp, cb, toks[:, t], t)
            assert torch.equal(a, b), f"decode step {t}"
    for (path, x), (_, y) in zip(_leaves(ca), _leaves(cb)):
        assert torch.equal(x, y), path


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


def test_serve_cli_runs_zamba2_on_cpu(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", ARCH, "--tiny", "--quantized", "--act-bits",
                    "4", "--tokens", "4", "--batch", "2", "--device", "cpu"])
    assert "generated shape: (2, 20)" in capsys.readouterr().out
