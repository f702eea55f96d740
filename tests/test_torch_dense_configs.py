"""Port parity: the dense qwen2-7b (GQA with a qkv bias) and starcoder2-3b
(LayerNorm with bias, classic GeLU MLP with biases) in the port's registry
against the JAX package, at tiny size (`tiny_config`, float32), both built
from the same numpy parameter tree: forward, prefill and 3 decode steps at
rtol/atol 1e-4, unquantized and quantized with float activations.
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
from repro.serve.quantize import quantize_params as j_quantize_params
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, tiny_config
from repro_torch.core.engine import EngineLinear, MVDRAMEngine
from repro_torch.models.model import Model, param_defs
from repro_torch.serve.quantize import quantize_params
from test_torch_model import fresh_jax_caches  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS, MAX_SEQ = 2, 6, 3, 16
DENSE = ("qwen2-7b", "starcoder2-3b")


@pytest.fixture(scope="module", params=DENSE)
def carried(request):
    arch = request.param
    jcfg = dataclasses.replace(j_tiny_config(arch), dtype="float32")
    tcfg = dataclasses.replace(tiny_config(arch), dtype="float32")
    jparams = j_init_params(j_param_defs(jcfg), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return arch, jcfg, tcfg, jparams, convert.params_from_numpy(tree, "cpu")


def test_registered_configs_match_jax(carried):
    arch, jcfg, tcfg, _, _ = carried
    assert arch in ARCHS
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert get_config(arch).param_count() == j_get_config(arch).param_count()


@pytest.mark.parametrize("quantized", [False, True])
def test_forward_prefill_decode_match_jax(rng, carried, quantized):
    _, jcfg, tcfg, jp, tp = carried
    if quantized:
        jp = j_quantize_params(jp, jcfg.weight_bits)
        tp = quantize_params(tp, tcfg.weight_bits)
    jm = JModel(jcfg)
    tm = Model(tcfg, impl=EngineLinear(MVDRAMEngine()) if quantized
               else None)
    assert set(param_defs(tcfg)["stages"]["0"]) == \
        set(j_param_defs(jcfg)["stages"]["0"])
    toks = rng.integers(0, 256, size=(B, S + STEPS))
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks[:, :S])})
    with torch.no_grad():
        tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks[:, :S])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
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
