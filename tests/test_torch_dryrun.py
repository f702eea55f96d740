"""Port parity: the dry-run tooling (`configs/shapes.py`, `configs.cells`,
`launch/mesh.py:make_production_mesh`, `models/params.py:abstract_params`
/`param_bytes`, `models/model.py:param_pspecs`, `serve/quantize.py:
quantize_defs`, `serve/engine.py:make_serve_step`/`cache_pspecs`,
`models/attention.py:FLASH_P_BF16`, `core/pud/timing.py:H100` and
`launch/dryrun.py`) against the JAX package's pure pieces.

Held exactly: the cells, the shape profiles, parameter counts and bytes,
every parameter and cache spec on the (16, 16) and (2, 16, 16) production
meshes, the packed shapes of `quantize_defs`, `model_flops_for` of every
cell and `roofline`'s formulas (on the same constants), FlopCounterMode's
count of a tiny dense layer against the hand count, and the collective
bytes of a small tree against the hand count. The blocked attention with
`FLASH_P_BF16` is held to JAX's with the flag at 2e-2 of max|out| (the
recipe's "~1e-2 relative error": torch rounds each bf16 product's result
to bf16, XLA keeps it float32), and to the port's float32 path at the
same bound. `run_cell` completes on the meta device for a tiny cell of
each kind and for full-width llama2-7b × decode_32k.
"""
import contextlib
import dataclasses
import io
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.core.pud import timing as jtiming
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.parallel import sharding as jsh
from repro.serve import engine as jengine
from repro.serve import quantize as jquantize
from repro_torch import configs as tconfigs
from repro_torch.core.bitplane import BitplaneWeights
from repro_torch.core.pud.timing import H100, H100_SXM
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.models.params import ParamDef
from repro_torch.parallel import sharding as tsh
from repro_torch.serve import engine as tengine
from repro_torch.serve import quantize as tquantize
from test_torch_model import fresh_jax_caches  # noqa: F401

ARCHS = list(tconfigs.ARCHS)
MESHES = {"16x16": False, "2x16x16": True}
SERVE_RULES = {"kv_seq": "model"}


@pytest.fixture(scope="module")
def jdryrun():
    """The JAX dry-run module. Importing it sets XLA_FLAGS to force 512
    host devices (it is meant to run as its own process), so the variable
    is put back at once, before any JAX backend of this process reads
    it."""
    prev = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return mod


class FakeMesh:
    """Duck-typed JAX mesh: the rules read only axis_names and
    devices.shape (jax.make_mesh would need 256 devices)."""

    def __init__(self, mesh):
        self.axis_names = mesh.axis_names
        self.devices = np.empty(mesh.devices.shape)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_shape_profiles_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}


@pytest.mark.parametrize("paper", [False, True])
def test_cells_equal_jax(paper):
    assert tconfigs.cells(paper) == jconfigs.cells(paper)
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED


def test_list_prints_the_jax_cells():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun.main(["--list"])
    live, skipped = jconfigs.cells()
    want = [f"RUN  {a} {s}" for a, s in live] + [
        f"SKIP {a} {s} (long_500k needs sub-quadratic attention)"
        for a, s in skipped]
    assert out.getvalue().splitlines() == want


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_bytes_equal_jax(arch):
    t = tmodel.param_defs(tconfigs.get_config(arch))
    j = jmodel.param_defs(jconfigs.get_config(arch))
    assert tparams.count_params(t) == jparams.count_params(j)
    assert tparams.param_bytes(t) == jparams.param_bytes(j)


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen2-moe-a2.7b",
                                  "mamba2-1.3b", "zamba2-7b"])
def test_abstract_params_are_meta_tensors_of_jax_shapes(arch):
    t = dict(_flat(tparams.abstract_params(
        tmodel.param_defs(tconfigs.get_config(arch)))))
    j = dict(_flat(jparams.abstract_params(
        jmodel.param_defs(jconfigs.get_config(arch)))))
    assert sorted(t) == sorted(j)
    for k, v in t.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == j[k].shape
        assert str(v.dtype).removeprefix("torch.") == str(j[k].dtype)


def test_production_mesh():
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16}
    assert m.devices.size == 256 and m.device_mesh is None
    assert m.devices.flat[0] == torch.device("meta")
    assert make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_jax(arch, mesh):
    tm = make_production_mesh(multi_pod=MESHES[mesh])
    t = dict(_flat(tmodel.param_pspecs(tconfigs.get_config(arch), tm)))
    j = dict(_flat(jmodel.param_pspecs(jconfigs.get_config(arch),
                                       FakeMesh(tm))))
    assert sorted(t) == sorted(j)
    assert {k: tuple(v) for k, v in t.items()} == \
        {k: tuple(v) for k, v in j.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_equal_jax(arch, mesh):
    """decode_32k's cache (128 lanes × 32768 slots) under the serving
    rules, built on the meta device and by jax.eval_shape."""
    prof = tconfigs.SHAPES["decode_32k"]
    tm = make_production_mesh(multi_pod=MESHES[mesh])
    cache = tmodel.Model(tconfigs.get_config(arch)).init_cache(
        prof.global_batch, prof.seq_len, device="meta")
    jm = jmodel.Model(jconfigs.get_config(arch))
    jcache = jax.eval_shape(lambda: jm.init_cache(prof.global_batch,
                                                  prof.seq_len))
    t = dict(_flat(tengine.cache_pspecs(cache, tm, {
        **tsh.DEFAULT_RULES, **SERVE_RULES})))
    j = dict(_flat(jengine.cache_pspecs(jcache, FakeMesh(tm), {
        **jsh.DEFAULT_RULES, **SERVE_RULES})))
    assert sorted(t) == sorted(j)
    assert {k: tuple(v) for k, v in t.items()} == \
        {k: tuple(v) for k, v in j.items()}
    shapes = {k: tuple(v.shape) for k, v in _flat(cache)}
    assert shapes == {k: v.shape for k, v in _flat(jcache)}


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_defs_shapes_equal_jax(arch, bits):
    t = dict(_flat(tquantize.quantize_defs(
        tmodel.param_defs(tconfigs.get_config(arch)), bits)))
    j = jquantize.quantize_defs(jmodel.param_defs(jconfigs.get_config(arch)),
                                bits)
    j = dict(_flat(j))
    assert sorted(t) == sorted(j)
    packed = 0
    for k, v in t.items():
        if isinstance(v, BitplaneWeights):
            w = j[k]
            packed += 1
            # the port keeps JAX's uint32 plane words as int32 bit patterns
            assert (v.planes.dtype, w.planes.dtype) == (torch.int32,
                                                        jnp.uint32)
            assert tuple(v.planes.shape) == w.planes.shape
            assert tuple(v.scale.shape) == w.scale.shape
            assert tuple(v.col_sum.shape) == w.col_sum.shape
            assert (v.n, v.zero, v.bits) == (w.n, w.zero, w.spec.bits)
            assert v.planes.device.type == "meta"
        else:
            assert tuple(v.shape) == j[k].shape
            assert str(v.dtype).removeprefix("torch.") == str(j[k].dtype)
    assert packed > 0


@pytest.mark.parametrize("cell", tconfigs.cells(True)[0],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_model_flops_equal_jax(jdryrun, cell):
    arch, shape = cell
    t = dryrun.model_flops_for(tconfigs.get_config(arch),
                               tconfigs.SHAPES[shape],
                               tconfigs.get_config(arch)
                               .active_param_count())
    j = jdryrun.model_flops_for(jconfigs.get_config(arch),
                                jshapes.SHAPES[shape],
                                jconfigs.get_config(arch)
                                .active_param_count())
    assert t == j


@pytest.mark.parametrize("coll", [None, 0.0, 3e9])
def test_roofline_formulas_equal_jax(jdryrun, coll):
    """The port's `roofline` on the JAX package's constants gives JAX's
    record; with no collective term (None) the bottleneck is chosen
    between compute and memory."""
    c = jtiming.TPU_V5E
    hw = types.SimpleNamespace(peak_flops_bf16=c.peak_flops_bf16,
                               hbm_bw=c.hbm_bw, nvlink_bw=c.ici_bw)
    args = (4.2e15, 2.1e12, coll, 3.3e18, 256)
    t = dryrun.roofline(*args, hw=hw)
    j = jdryrun.roofline(*args[:2], coll or 0.0, *args[3:])
    if coll is None:
        assert t["collective_s"] is None
        assert t["bottleneck"] in ("compute", "memory")
        j = {**j, "collective_s": None}
    assert t == j


def test_h100_constants():
    assert dataclasses.asdict(H100_SXM) == {
        "peak_flops_bf16": 989e12, "hbm_bw": 3.35e12, "nvlink_bw": 450e9,
        "hbm_bytes": 80e9}
    assert isinstance(H100_SXM, H100)


def test_flop_counter_counts_a_tiny_dense_layer_by_hand():
    """Tiny llama2-7b cut to one layer, forward on the meta device: the
    linears (q, k, v, o, up, gate, down, lm_head) and attention's two
    products (QKᵀ and PV over the causal S × S, computed whole)."""
    cfg = dataclasses.replace(tconfigs.tiny_config("llama2-7b"),
                              num_layers=1)
    b, s = 3, 24
    e, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, hkv, d = cfg.attn.num_heads, cfg.attn.num_kv_heads, cfg.attn.head_dim
    t = b * s
    linear = 2 * t * (e * h * d + 2 * e * hkv * d + h * d * e + 3 * e * f
                      + e * v)
    attention = 2 * (2 * b * h * s * s * d)
    params = tparams.abstract_params(tmodel.param_defs(cfg))
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    with torch.no_grad(), dryrun._counted() as c:
        tmodel.Model(cfg).forward(params, {"tokens": tokens})
    assert c["flops"] == linear + attention
    assert sum(c["flops_by_dtype"].values()) == c["flops"]
    # the float32 attention einsums apart from the bf16 linears
    assert c["flops_by_dtype"]["torch.float32"] == attention
    assert c["write_bytes"] > 0


def test_train_collective_bytes_by_hand():
    """On the (16, 16) mesh: (64, 256) embed × mlp shards "model" 16 ways;
    a (64,) norm is replicated. Each gathered at 15/16 of its float32
    bytes; each bf16 gradient all-reduced over "data" (16) on its piece."""
    defs = {"w": ParamDef((64, 256), ("embed", "mlp")),
            "n": ParamDef((64,), ("embed",))}
    got = dryrun.train_collective_bytes(
        defs, make_production_mesh(), dryrun.DEFAULT_RULES, 2, ("data",))
    gather = 64 * 256 * 4 * 15 / 16
    reduce = (2 * (64 * 256 * 2 / 16) * 15 / 16
              + 2 * (64 * 2) * 15 / 16)
    assert got == {"param_all_gather": gather, "grad_reduce": reduce,
                   "total": gather + reduce}


@pytest.fixture
def flash_flags(monkeypatch):
    def set_(on: bool):
        monkeypatch.setattr(tattn, "FLASH_P_BF16", on)
        monkeypatch.setattr(jattn, "FLASH_P_BF16", on)
    return set_


@pytest.mark.parametrize("hkv", [4, 2])
def test_flash_p_bf16_follows_jax(flash_flags, hkv):
    b, s, h, d, block = 2, 48, 4, 16, 16
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((b, s, n, d)).astype(np.float32)
               for n in (h, hkv, hkv))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    flash_flags(True)
    got = tattn._flash_sdpa(tq, tk, tv, None, None, d ** -0.5, block)
    want = np.asarray(jattn._flash_sdpa(jq, jk, jv, None, None, d ** -0.5,
                                        block=block), np.float32)
    flash_flags(False)
    f32 = tattn._flash_sdpa(tq, tk, tv, None, None, d ** -0.5, block)
    got = got.to(torch.float32).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-2 * scale
    assert np.abs(got - f32.to(torch.float32).numpy()).max() <= 2e-2 * scale
    assert not np.array_equal(got, f32.to(torch.float32).numpy())


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_run_cell_on_a_tiny_config(shape):
    cfg = tconfigs.tiny_config("llama2-7b")
    r = dryrun.run_cell("llama2-7b", shape, cfg=cfg)
    assert r["estimate"] == dryrun.ESTIMATE and "not XLA" in r["estimate"]
    assert r["hardware"] == dataclasses.asdict(H100_SXM)
    assert r["kind"] == tconfigs.SHAPES[shape].kind
    assert r["chips"] == 256 and r["flops_split"] == 16
    assert r["flops"] > 0 and r["write_bytes"] > 0 and r["arg_bytes"] > 0
    assert r["hbm_bytes"] == r["arg_bytes"] + 2 * r["write_bytes"]
    roof = r["roofline"]
    if r["kind"] == "train":
        assert sum(r["write_bytes_by_part"].values()) == r["write_bytes"]
        assert r["collective_bytes"] == r["collective_note"]["total"] > 0
        assert roof["collective_s"] > 0
    else:
        assert r["collective_bytes"] is None and roof["collective_s"] is None
        assert roof["bottleneck"] in ("compute", "memory")


def test_run_cell_quantized_and_flash_bf16():
    cfg = tconfigs.tiny_config("llama2-7b")
    q = dryrun.run_cell("llama2-7b", "decode_32k", quant_bits=2, cfg=cfg)
    f = dryrun.run_cell("llama2-7b", "decode_32k", cfg=cfg)
    assert "plain bit-plane" in q["flops_note"] and "flops_note" not in f
    assert q["arg_bytes"] < f["arg_bytes"]         # packed planes
    p = dryrun.run_cell("llama2-7b", "prefill_32k", flash_bf16=True,
                        cfg=cfg)
    assert "torch.bfloat16" in p["flops_by_dtype"]
    assert tattn.FLASH_P_BF16 is False              # restored


def test_run_cell_full_width_llama2_7b_decode_32k():
    r = dryrun.run_cell("llama2-7b", "decode_32k")
    assert r["params"] == jparams.count_params(
        jmodel.param_defs(jconfigs.get_config("llama2-7b")))
    assert r["local_batch"] == 8 and r["mesh"] == "16x16"
    # one token a lane: the counted products cover the model's 2·N a token
    assert r["flops"] >= 2 * r["active_params"] * r["local_batch"] * 0.9
    assert r["roofline"]["bottleneck"] == "memory"
