"""Port parity: `repro_torch`'s ServeEngine against the JAX package's, on
tiny llama2-7b (float32, 2-bit weights), plus the port's package rules.

Greedy generation is token-for-token equal to JAX `ServeEngine` (its
per-token loop) unquantized and with float activations. With 4-bit
activations the symmetric quantizer puts every row's absmax element on the
±7.5 rounding tie, so the JAX package does not reproduce itself across its
jitted and eager prefill (asserted below), and no other implementation can
follow it token for token. The port's act_bits=4 engine is held token for
token against JAX `ServeEngine` with that tie moved off (the absmax on
code ±7 in both packages' quantizer), and against the same engine with the
JAX package's kernel in every bit-plane linear.
"""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.bitplane_gemv.ops as jops
import repro.kernels.bitplane_gemv.program as jprog
import repro_torch.kernels.bitplane_gemv.ops as tops
import repro_torch.kernels.bitplane_gemv.program as tprog
from repro.configs import tiny_config as j_tiny_config
from repro.core.bitplane import BitplaneWeights as JBitplaneWeights
from repro.core.quant import QuantizedTensor as JQuantizedTensor
from repro.models.model import param_defs as j_param_defs
from repro.models.params import init_params as j_init_params
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.quantize import quantize_params as j_quantize_params
from repro.serve.quantize import serving_bytes as j_serving_bytes
from repro_torch import convert
from repro_torch.configs import tiny_config
from repro_torch.core.bitplane import BitplaneWeights
from repro_torch.core.quant import QuantizedTensor
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import param_defs
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.quantize import quantize_params, serving_bytes
from test_torch_model import JaxLinear, fresh_jax_caches  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
MAX_SEQ, NEW = 24, 8


@pytest.fixture(scope="module")
def carried():
    jcfg = dataclasses.replace(j_tiny_config("llama2-7b"), dtype="float32")
    tcfg = dataclasses.replace(tiny_config("llama2-7b"), dtype="float32")
    assert jcfg.weight_bits == tcfg.weight_bits == 2
    jparams = j_init_params(j_param_defs(jcfg), jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    prompts = np.random.default_rng(1).integers(0, 256, size=(3, 6))
    return jcfg, tcfg, jparams, tparams, prompts


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("per_lane", [None, [8, 3, 0]])
def test_greedy_tokens_match_jax(carried, quantized, per_lane):
    jcfg, tcfg, jparams, tparams, prompts = carried
    jeng = JServeEngine(jcfg, jparams, max_seq=MAX_SEQ, batch_slots=3,
                        quantized=quantized)
    want = np.asarray(jeng.generate(jnp.asarray(prompts, jnp.int32),
                                    max_new=NEW, scan=False,
                                    max_new_per_lane=per_lane))
    teng = ServeEngine(tcfg, tparams, max_seq=MAX_SEQ, batch_slots=3,
                       quantized=quantized, device="cpu")
    got = teng.generate(prompts, max_new=NEW, max_new_per_lane=per_lane)
    assert got.shape == (3, 6 + NEW)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_lane", [None, [8, 3, 0]])
def test_act_bits4_tokens_match_jax_linears(carried, per_lane):
    _, tcfg, _, tparams, prompts = carried
    kw = dict(max_seq=MAX_SEQ, batch_slots=3, quantized=True, act_bits=4,
              device="cpu")
    port = ServeEngine(tcfg, tparams, **kw)
    hybrid = ServeEngine(tcfg, tparams, **kw)
    hybrid.model.impl = JaxLinear()
    got = port.generate(prompts, max_new=NEW, max_new_per_lane=per_lane)
    want = hybrid.generate(prompts, max_new=NEW, max_new_per_lane=per_lane)
    assert torch.equal(got, want)
    assert port.mvdram.routed_linears > 0


def test_jax_act_bits4_engine_runs_on_the_same_params(carried):
    """The JAX package's own act_bits=4 engine on the carried parameters
    does not reproduce itself: its jitted and eager prefill logits differ
    by more than 1 % of the largest logit, because jit rounds the float ops
    differently and a 1-ulp move of a row's absmax flips that element's
    code on the ±7.5 tie. With float activations the two agree."""
    jcfg, _, jparams, _, prompts = carried
    toks = {"tokens": jnp.asarray(prompts, jnp.int32)}
    spread = {}
    for act_bits in (None, 4):
        jeng = JServeEngine(jcfg, jparams, max_seq=MAX_SEQ, batch_slots=3,
                            quantized=True, act_bits=act_bits)
        jitted, _ = jeng._prefill(jeng.params, toks)
        eager, _ = jeng.model.prefill(jeng.params, toks, max_seq=MAX_SEQ)
        spread[act_bits] = float(jnp.max(jnp.abs(jitted - eager))
                                 / jnp.max(jnp.abs(jitted)))
    assert spread[None] < 1e-5
    assert spread[4] > 1e-2


def _quantize_off_the_tie(mp):
    """Swap both packages' activation quantizer for one that maps each
    row's absmax to code ±7 (levels // 2 − 1) instead of the ±7.5 tie;
    otherwise the same steps (true divide, round half to even, clip)."""
    def div(spec):
        return max(spec.levels // 2 - 1, 1)

    def jax_quant(a, spec):
        af = a.astype(jnp.float32)
        scale = jnp.max(jnp.abs(af), axis=-1, keepdims=True) / div(spec)
        q = jnp.clip(jnp.round(af / jnp.maximum(scale, 1e-12))
                     + spec.zero_point, 0, spec.levels - 1)
        return JQuantizedTensor(values=q.astype(jnp.uint8), scale=scale,
                                zero=int(spec.zero_point), spec=spec)

    def torch_quant(a, spec):
        af = a.to(torch.float32)
        scale = af.abs().amax(-1, keepdim=True) / div(spec)
        q = torch.clamp(torch.round(af / torch.clamp(scale, min=1e-12))
                        + spec.zero_point, 0, spec.levels - 1)
        return QuantizedTensor(values=q.to(torch.uint8), scale=scale,
                               zero=int(spec.zero_point), spec=spec)

    for mod in (jops, jprog):
        mp.setattr(mod, "quantize_activations", jax_quant)
    for mod in (tops, tprog):
        mp.setattr(mod, "quantize_activations", torch_quant)


@pytest.mark.parametrize("per_lane", [None, [8, 3, 0]])
def test_act_bits4_tokens_match_jax_off_the_tie(carried, monkeypatch,
                                                per_lane):
    """Off the tie, greedy act_bits=4 generation is token-for-token equal
    to JAX `ServeEngine` (its per-token loop): what separates the two at
    the real quantizer is the tie, not the port's model."""
    jcfg, tcfg, jparams, tparams, prompts = carried
    try:
        with monkeypatch.context() as mp:
            _quantize_off_the_tie(mp)
            jeng = JServeEngine(jcfg, jparams, max_seq=MAX_SEQ,
                                batch_slots=3, quantized=True, act_bits=4)
            want = np.asarray(jeng.generate(
                jnp.asarray(prompts, jnp.int32), max_new=NEW, scan=False,
                max_new_per_lane=per_lane))
            teng = ServeEngine(tcfg, tparams, max_seq=MAX_SEQ,
                               batch_slots=3, quantized=True, act_bits=4,
                               device="cpu")
            got = teng.generate(prompts, max_new=NEW,
                                max_new_per_lane=per_lane)
    finally:
        jax.clear_caches()      # no trace of the swapped quantizer survives
    assert teng.mvdram.routed_linears > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_seeded_sampling_reproducible(carried):
    _, tcfg, _, tparams, prompts = carried
    eng = ServeEngine(tcfg, tparams, max_seq=MAX_SEQ, batch_slots=3,
                      quantized=True, act_bits=4, device="cpu")
    a = eng.generate(prompts, max_new=6, temperature=0.8, seed=11)
    b = eng.generate(prompts, max_new=6, temperature=0.8, seed=11)
    c = eng.generate(prompts, max_new=6, temperature=0.8, seed=12)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == (3, 12)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size
    assert torch.equal(a[:, :6], torch.from_numpy(prompts))


def test_generate_rejects_overflow_and_extra_lanes(carried):
    _, tcfg, _, tparams, prompts = carried
    eng = ServeEngine(tcfg, tparams, max_seq=12, batch_slots=2,
                      device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        eng.generate(prompts, max_new=2)
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(prompts[:2], max_new=8)


def test_no_device_on_a_cuda_less_host_raises(carried, monkeypatch):
    _, tcfg, _, tparams, _ = carried
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tcfg, tparams)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy({"w": np.zeros(2)})


def test_quantize_params_and_serving_bytes_match_jax(carried):
    jcfg, tcfg, jparams, tparams, _ = carried
    jq = j_quantize_params(jparams, 2)
    tq = quantize_params(tparams, 2)

    def kinds(tree, cls):
        if isinstance(tree, dict):
            return {k: kinds(v, cls) for k, v in tree.items()}
        return isinstance(tree, cls)
    assert kinds(tq, BitplaneWeights) == kinds(jq, JBitplaneWeights)
    assert quantize_params(tq, 2)["lm_head"] is tq["lm_head"]
    assert serving_bytes(param_defs(tcfg), 2) == \
        j_serving_bytes(j_param_defs(jcfg), 2)


def test_serve_cli_on_cpu(capsys):
    serve_cli.main(["--arch", "llama2-7b", "--tiny", "--quantized",
                    "--act-bits", "4", "--tokens", "4", "--batch", "2",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated shape: (2, 20)" in out
    assert "tokens/s:" in out


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {name}"


def test_chip_smoke_alone_or_without_a_card_fails(tmp_path):
    """Without a CUDA device — and in a directory holding nothing of the
    repo but chip_smoke.py — the script exits nonzero and prints no result
    line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((tmp_path, tmp_path / "chip_smoke.py"),
                        (ROOT, ROOT / "chip_smoke.py")):
        run = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={"PATH": "/usr/bin:/bin",
                                  "CUDA_VISIBLE_DEVICES": ""})
        assert run.returncode != 0
        assert '"ok": true' not in run.stdout
