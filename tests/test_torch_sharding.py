"""Port parity: the logical sharding rules (`parallel/sharding.py`) and the
host mesh (`launch/mesh.py`) against the JAX package.

Every scenario of tests/test_sharding.py, on the same duck-typed meshes,
gives the port's `PartitionSpec` equal (as a tuple, exactly) to JAX's
`logical_to_pspec`; so do the def trees of tiny llama2-7b, gemma2-2b,
qwen2-moe-a2.7b and mamba2-1.3b. `constrain` is the identity off-mesh and
on plain tensors. Placement over several ranks is held in
tests/test_torch_multidevice.py.
"""
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as j_tiny_config
from repro.models.model import param_defs as j_param_defs
from repro.parallel import sharding as jsh
from repro_torch.configs import tiny_config
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models.model import param_defs
from repro_torch.models.params import ParamDef
from repro_torch.parallel import sharding as tsh


class FakeMesh:
    """Duck-typed mesh: only axis_names + devices.shape are consulted."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESH_1POD = FakeMesh((16, 16), ("data", "model"))
MESH_2POD = FakeMesh((2, 16, 16), ("pod", "data", "model"))
MESH_SMALL = FakeMesh((2, 4), ("data", "model"))
MESHES = {"1pod": MESH_1POD, "2pod": MESH_2POD, "2x4": MESH_SMALL}

# (axes, shape, mesh, rules, the spec tests/test_sharding.py expects)
SCENARIOS = [
    (("embed", "mlp"), (4096, 16384), "1pod", "default", (None, "model")),
    (("batch", "seq"), (256, 4096), "1pod", "default", ("data",)),
    (("batch", "seq"), (256, 4096), "2pod", "default", (("pod", "data"),)),
    (("kv_heads",), (8,), "1pod", "default", ()),
    (("batch",), (1,), "2pod", "default", ()),
    (("mlp", "vocab"), (16384, 256000), "1pod", "default", ("model",)),
    (("batch", "kv_seq"), (1, 524288), "1pod", "long",
     (None, ("model", "data"))),
    (("embed",), (1024,), "1pod", "default", ()),
    (("heads", "embed"), (4096, 4096), "2x4", "long", ("model",)),
    ((None, "experts", "embed"), (3, 64, 2048), "2x4", "default",
     (None, "model")),
]
RULES = {"default": (jsh.DEFAULT_RULES, tsh.DEFAULT_RULES),
         "long": (jsh.LONG_CONTEXT_RULES, tsh.LONG_CONTEXT_RULES)}


@pytest.mark.parametrize("axes,shape,mesh,rules,want", SCENARIOS)
def test_logical_to_pspec_equals_jax(axes, shape, mesh, rules, want):
    jr, tr = RULES[rules]
    j = jsh.logical_to_pspec(axes, shape, MESHES[mesh], jr)
    t = tsh.logical_to_pspec(axes, shape, MESHES[mesh], tr)
    assert isinstance(t, tsh.PartitionSpec)
    assert tuple(t) == tuple(j) == want


def test_rule_tables_equal_jax():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert tsh.LONG_CONTEXT_RULES == jsh.LONG_CONTEXT_RULES


def test_defs_to_pspecs_small_tree():
    defs = {"w": ParamDef((1024, 4096), ("embed", "mlp")),
            "b": {"scale": ParamDef((1024,), ("embed",))}}
    specs = tsh.defs_to_pspecs(defs, MESH_1POD, tsh.DEFAULT_RULES)
    assert specs["w"] == tsh.P(None, "model")
    assert specs["b"]["scale"] == tsh.P()


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ["llama2-7b", "gemma2-2b",
                                  "qwen2-moe-a2.7b", "mamba2-1.3b"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_defs_to_pspecs_model_trees_equal_jax(arch, mesh):
    """Every leaf of the tiny def tree resolves to JAX's spec, under the
    rules the active context holds (here the long-context profile)."""
    with jsh.axis_rules(MESHES[mesh], {"kv_seq": ("model", "data")}):
        j = dict(_flat(jsh.defs_to_pspecs(
            j_param_defs(j_tiny_config(arch)))))
    with tsh.axis_rules(MESHES[mesh], {"kv_seq": ("model", "data")}):
        t = dict(_flat(tsh.defs_to_pspecs(param_defs(tiny_config(arch)))))
    assert sorted(t) == sorted(j)
    assert {k: tuple(v) for k, v in t.items()} == \
        {k: tuple(v) for k, v in j.items()}
    assert any(tuple(v) for v in t.values())   # something is sharded


def test_axis_rules_context_isolation():
    with tsh.axis_rules(None, {"embed": "model"}):
        assert tsh.current_mesh() is None
        assert tsh.logical_to_pspec(("embed",), (8,)) == tsh.P()
    assert tsh._ACTIVE.rules is not None and tsh.current_mesh() is None
    x = torch.ones((4, 4))
    assert tsh.constrain(x, "batch", "embed") is x


def test_host_mesh_on_the_cpu():
    mesh = make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.devices[0, 0] == torch.device("cpu")
    assert make_host_mesh(model=4, device="cpu").shape == \
        {"data": 1, "model": 1}          # capped at the devices there are
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.empty((2, 2), object), ("data",))


def test_host_mesh_without_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()


def test_one_device_mesh_constrains_and_places():
    mesh = make_host_mesh(device="cpu")
    defs = param_defs(tiny_config("llama2-7b"))
    x = torch.ones((2, 3))
    with tsh.axis_rules(mesh):
        assert tsh.current_mesh() is mesh
        assert tsh.constrain(x, "batch", None) is x
        sh = tsh.defs_to_shardings(defs)
    # the 1×1 mesh resolves every size-1 axis, as JAX's one-device mesh
    assert sh["stages"]["0"]["ffn"]["up"] == tsh.NamedSharding(
        mesh, tsh.P(None, None, "model"))
    like = tsh.tree_shardings_like({"m": {"up": 0}}, {"m": {"up": defs[
        "stages"]["0"]["ffn"]["up"]}}, mesh)
    assert like["m"]["up"].spec == tsh.P(None, None, "model")
