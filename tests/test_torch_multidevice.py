"""Port parity: training across devices — placement by logical specs over a
torch `DeviceMesh`, the compressed all-reduce, the sharded step and
elastic restore — on 4 `gloo` ranks on the CPU.

The ranks are spawned once for the module (`torch.multiprocessing`, the
group initialised through a `FileStore` under a temporary directory, so
parallel test workers never share a port); they write their results to
files and the tests below assert on them. A spawn that does not finish
within `JOIN_S` fails every test of the module instead of hanging it.

The reference of the sharded step is JAX's SINGLE-device jitted step on
the same numpy params and batch, computed in this process (the reference's
own 8-device test of the same claim, tests/test_multidevice.py, cannot run
under jax 0.9's Explicit mesh axes; its claim is sharded ≈ single device).

Tolerances, each the reference's own where it has one:
  * the sharded step against JAX's one-device step: max|Δparam| < 2e-4,
    |Δloss| < 1e-4 (tests/test_multidevice.py); its grad_norm rtol 1e-5
    (tests/test_torch_train.py's bound for one step's metrics);
  * `compressed_allreduce_mean` on 4 × 37 against the mean: relative error
    < 0.02 (tests/test_multidevice.py: the int8 all-gather's quantization);
  * `global_norm` over shards against the one-device norm: rtol 1e-6
    (float32 sums in another order);
  * elastic restore: every restored leaf bitwise the saved one.
"""
import dataclasses
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import tiny_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.mesh import make_dist_mesh
from repro_torch.models.model import Model, param_defs
from repro_torch.optim.adamw import AdamWConfig, adamw_init, global_norm
from repro_torch.parallel.compress import compressed_allreduce_mean
from repro_torch.parallel.sharding import (P, NamedSharding, axis_rules,
                                           constrain, defs_to_shardings,
                                           place)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.step import make_train_step

RANKS = 4
JOIN_S = 300
STEP_MESHES = ((2, 2), (1, 4))
RESTORE_MESHES = ((1, 4), (4, 1))
SEP = "|"


def _tag(shape) -> str:
    return "x".join(map(str, shape))


def _step_cfg():
    """tests/test_multidevice.py's config: tiny llama2-7b in float32."""
    return dataclasses.replace(tiny_config("llama2-7b"), dtype="float32",
                               d_model=64, d_ff=128)


def _trainer(mesh, ckpt_dir):
    """tests/test_multidevice.py's elastic drill: tiny llama2-7b, batch
    4 × 16, a committed checkpoint every 10 steps."""
    return Trainer(tiny_config("llama2-7b"),
                   AdamWConfig(warmup_steps=2, total_steps=50),
                   TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=10,
                                 ckpt_async=False),
                   mesh=mesh, global_batch=4, seq_len=16)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _unflat(flat: dict) -> dict:
    root: dict = {}
    for key, v in flat.items():
        *path, last = key.split(SEP)
        node = root
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return root


def _full(tree) -> dict:
    """Every leaf gathered (a collective: every rank calls it)."""
    return {SEP.join(p): (v.full_tensor() if hasattr(v, "full_tensor")
                          else v) for p, v in _flat(tree)}


# -- the ranks ---------------------------------------------------------------

def _steps(work: str, rank: int, res: dict) -> None:
    """One sharded step on each mesh of STEP_MESHES from the parent's
    numpy params and batch; a masked batch refused; global_norm over the
    placed params; constrain on a DTensor."""
    ref = np.load(os.path.join(work, "ref.npz"))
    cfg = _step_cfg()
    numpy_params = _unflat({k[2:]: ref[k] for k in ref.files
                            if k.startswith("p" + SEP)})
    batch = {k: torch.from_numpy(ref["batch" + SEP + k].copy())
             for k in ("tokens", "labels")}
    for shape in STEP_MESHES:
        tag = _tag(shape)
        mesh = make_dist_mesh(shape, ("data", "model"), "cpu")
        with axis_rules(mesh):
            sh = defs_to_shardings(param_defs(cfg))
        params = place(params_from_numpy(numpy_params, "cpu"), sh)
        plain = params_from_numpy(numpy_params, "cpu")
        norms = (float(global_norm(params)), float(global_norm(plain)))
        step = make_train_step(Model(cfg), AdamWConfig(warmup_steps=1,
                                                       total_steps=10),
                               compress_grads=False, mesh=mesh)
        with axis_rules(mesh):
            p2, _, m2 = step(params, adamw_init(params), batch)
        full = _full(p2)
        if rank == 0:
            np.savez(os.path.join(work, f"step_{tag}.npz"),
                     **{k: v.numpy() for k, v in full.items()})
        local = dict(_flat(p2))[("stages", "0", "attn", "wq")].to_local()
        res[tag] = {"loss": float(m2["loss"]), "ce": float(m2["ce"]),
                    "grad_norm": float(m2["grad_norm"]),
                    "global_norm_sharded": norms[0],
                    "global_norm_plain": norms[1],
                    "wq_shard_shape": list(local.shape)}
        with axis_rules(mesh):
            try:
                step(params, adamw_init(params),
                     {**batch, "mask": torch.ones(batch["tokens"].shape)})
                res[tag]["mask_refused"] = False
            except ValueError as e:
                res[tag]["mask_refused"] = "masked batch" in str(e)
            x = place(torch.arange(32.0).reshape(8, 4),
                      NamedSharding(mesh, P()))
            y = constrain(x, "batch", None)
            res[tag]["constrained"] = {
                "shard_dims": [pl.dim if pl.is_shard() else None
                               for pl in y.placements],
                "local_shape": list(y.to_local().shape),
                "same_values": bool(torch.equal(y.full_tensor(),
                                                x.full_tensor()))}


def _compressed(work: str, rank: int, res: dict) -> None:
    x = torch.arange(4 * 37, dtype=torch.float32).reshape(4, 37) / 7.0
    got = compressed_allreduce_mean(x[rank])
    ref = x.mean(dim=0)
    res["compressed"] = {
        "rel": float((got - ref).abs().max() / ref.abs().max()),
        "shape": list(got.shape), "dtype": str(got.dtype)}


def _elastic(work: str, rank: int, res: dict) -> None:
    """10 steps on (2, 2) with a committed checkpoint at step 10; restored
    onto each mesh of RESTORE_MESHES (a copy of the directory each) and
    trained on to step 15."""
    import torch.distributed as dist
    saved_dir = os.path.join(work, "ckpt_2x2")
    tr = _trainer(make_dist_mesh((2, 2), ("data", "model"), "cpu"),
                  saved_dir)
    _, _, hist = tr.run(10)
    res["trained_2x2"] = {"final": hist[-1]["step"],
                          "loss": hist[-1]["loss"]}
    if rank == 0:
        for shape in RESTORE_MESHES:
            shutil.copytree(saved_dir,
                            os.path.join(work, f"ckpt_{_tag(shape)}"))
    dist.barrier()
    _, saved = ckpt.restore_checkpoint(ckpt.latest_checkpoint(saved_dir),
                                       "cpu")
    saved = dict(_flat(saved))
    for shape in RESTORE_MESHES:
        tag = _tag(shape)
        tr = _trainer(make_dist_mesh(shape, ("data", "model"), "cpu"),
                      os.path.join(work, f"ckpt_{tag}"))
        step, params, opt = tr.restore_or_init()
        got = _full({"params": params, "opt": opt})
        bitwise = sorted(got) == sorted(SEP.join(k) for k in saved) and all(
            v.dtype == saved[tuple(k.split(SEP))].dtype
            and torch.equal(v, saved[tuple(k.split(SEP))])
            for k, v in got.items())
        head = list(params["lm_head"].to_local().shape)
        del params, opt
        _, _, hist = tr.run(5)
        res[f"restored_{tag}"] = {"step": step, "bitwise": bitwise,
                                  "lm_head_shard_shape": head,
                                  "final": hist[-1]["step"],
                                  "loss": hist[-1]["loss"]}


def _cli(work: str, rank: int, res: dict) -> None:
    """`launch/train.py` as `torchrun` runs it (WORLD_SIZE set, the group
    already up): a (2, 2) mesh from --mesh-model 2, history on rank 0.
    It destroys the group when done, so it runs last."""
    import contextlib
    import io
    from repro_torch.launch import train as launch_train
    os.environ["WORLD_SIZE"] = str(RANKS)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main(["--arch", "llama2-7b", "--tiny", "--steps", "3",
                           "--batch", "4", "--seq", "16", "--device", "cpu",
                           "--mesh-model", "2"])
    res["cli"] = out.getvalue().splitlines()


def _rank_main(rank: int, work: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), RANKS),
        rank=rank, world_size=RANKS)
    res: dict = {}
    try:
        for part in (_steps, _compressed, _elastic, _cli):
            try:
                part(work, rank, res)
            except Exception as e:       # recorded, then raised
                res[part.__name__] = f"{type(e).__name__}: {e}"
                raise
    finally:
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        if dist.is_initialized():
            dist.destroy_process_group()


# -- the parent ----------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    """tests/test_torch_model.py's fixture of that name (imported lazily
    here, so that the spawned ranks never import JAX)."""
    yield
    import jax
    jax.clear_caches()


@pytest.fixture(scope="module")
def jax_step():
    """JAX's one-device jitted step (tests/test_multidevice.py's): the
    numpy params and batch it starts from, its params after the step and
    its loss."""
    import jax
    from repro.configs import tiny_config as j_tiny_config
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.models.model import Model as JModel
    from repro.models.model import param_defs as j_param_defs
    from repro.models.params import init_params as j_init_params
    from repro.optim.adamw import AdamWConfig as JAdamWConfig
    from repro.optim.adamw import adamw_init as j_adamw_init
    from repro.train.step import make_train_step as j_make_train_step
    cfg = dataclasses.replace(j_tiny_config("llama2-7b"), dtype="float32",
                              d_model=64, d_ff=128)
    params = j_init_params(j_param_defs(cfg), jax.random.PRNGKey(0))
    batch = JSyntheticLM(vocab=cfg.vocab_size, seq=16, batch=8).batch_at(0)
    start = {SEP.join(p): np.array(v) for p, v in _flat(
        jax.tree_util.tree_map(np.asarray, params))}
    step = j_make_train_step(JModel(cfg), JAdamWConfig(warmup_steps=1,
                                                       total_steps=10),
                             compress_grads=False)
    p1, _, m1 = jax.jit(step)(params, j_adamw_init(params), batch)
    after = {SEP.join(p): np.array(v) for p, v in _flat(
        jax.tree_util.tree_map(np.asarray, p1))}
    return {"start": start, "after": after, "loss": float(m1["loss"]),
            "grad_norm": float(m1["grad_norm"]),
            "batch": {k: np.array(v) for k, v in batch.items()}}


@pytest.fixture(scope="module")
def ranks(jax_step, tmp_path_factory):
    """Spawn RANKS gloo ranks once; → (per-rank result dicts, work dir)."""
    work = str(tmp_path_factory.mktemp("ranks"))
    np.savez(os.path.join(work, "ref.npz"),
             **{"p" + SEP + k: v for k, v in jax_step["start"].items()},
             **{"batch" + SEP + k: v for k, v in jax_step["batch"].items()})
    ctx = mp.start_processes(_rank_main, args=(work,), nprocs=RANKS,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"{RANKS} ranks did not finish in {JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    res = []
    for r in range(RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res, work


@pytest.mark.parametrize("shape", STEP_MESHES, ids=_tag)
def test_sharded_step_params_match_jax_single_device(ranks, jax_step, shape):
    res, work = ranks
    got = np.load(os.path.join(work, f"step_{_tag(shape)}.npz"))
    want = jax_step["after"]
    assert sorted(got.files) == sorted(want)
    d = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert d < 2e-4, d


@pytest.mark.parametrize("shape", STEP_MESHES, ids=_tag)
def test_sharded_step_loss_matches_jax_single_device(ranks, jax_step,
                                                     shape):
    res, _ = ranks
    losses = [r[_tag(shape)]["loss"] for r in res]
    assert all(abs(x - jax_step["loss"]) < 1e-4 for x in losses), \
        (losses, jax_step["loss"])


@pytest.mark.parametrize("shape", STEP_MESHES, ids=_tag)
def test_sharded_step_grad_norm_matches_jax_single_device(ranks, jax_step,
                                                          shape):
    """The norm of the mean gradient, before clipping (AdamW's first step
    and the clipping hide a gradient's scale from the params)."""
    res, _ = ranks
    for r in res:
        np.testing.assert_allclose(r[_tag(shape)]["grad_norm"],
                                   jax_step["grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("shape", STEP_MESHES, ids=_tag)
def test_params_are_sharded_by_their_specs(ranks, shape):
    """wq (stack, embed, heads·head_dim) shards its last dim over "model"."""
    res, _ = ranks
    model = shape[1]
    assert all(r[_tag(shape)]["wq_shard_shape"] == [2, 64, 64 // model]
               for r in res)


@pytest.mark.parametrize("shape", STEP_MESHES, ids=_tag)
def test_global_norm_over_shards_is_the_one_device_norm(ranks, shape):
    res, _ = ranks
    for r in res:
        got = r[_tag(shape)]
        np.testing.assert_allclose(got["global_norm_sharded"],
                                   got["global_norm_plain"], rtol=1e-6)
    assert len({r[_tag(shape)]["grad_norm"] for r in res}) == 1


@pytest.mark.parametrize("shape", STEP_MESHES, ids=_tag)
def test_a_masked_batch_over_batch_shards(ranks, shape):
    """Refused where the batch is split (the ranks' masked means are not
    the global one); taken where it is not."""
    res, _ = ranks
    want = shape[0] > 1
    assert all(r[_tag(shape)]["mask_refused"] is want for r in res)


@pytest.mark.parametrize("shape", STEP_MESHES, ids=_tag)
def test_constrain_redistributes_a_dtensor(ranks, shape):
    res, _ = ranks
    for r in res:
        c = r[_tag(shape)]["constrained"]
        assert c["same_values"]
        assert c["local_shape"] == [8 // shape[0], 4]
        assert c["shard_dims"] == [0, None]   # Shard(0) on "data"


def test_compressed_allreduce_mean(ranks):
    res, _ = ranks
    for r in res:
        c = r["compressed"]
        assert c["shape"] == [37] and c["dtype"] == "torch.float32"
        assert c["rel"] < 0.02, c


def test_ten_steps_on_2x2_commit_a_checkpoint(ranks):
    res, work = ranks
    assert all(r["trained_2x2"]["final"] == 10 for r in res)
    assert ckpt.latest_checkpoint(os.path.join(work, "ckpt_2x2")).endswith(
        "step_00000010")
    assert len({r["trained_2x2"]["loss"] for r in res}) == 1


@pytest.mark.parametrize("shape", RESTORE_MESHES, ids=_tag)
def test_elastic_restore_is_bitwise_and_trains_on(ranks, shape):
    res, _ = ranks
    for r in res:
        got = r[f"restored_{_tag(shape)}"]
        assert got["step"] == 10
        assert got["bitwise"]
        assert got["final"] == 15
        assert np.isfinite(got["loss"])
    # re-placed by the new mesh's rules: lm_head (64, 256) shards its
    # vocab over "model"
    assert all(r[f"restored_{_tag(shape)}"]["lm_head_shard_shape"] ==
               [64, 256 // shape[1]] for r in res)


def test_the_launcher_under_torchrun_shards_over_the_mesh(ranks):
    res, _ = ranks
    lead = res[0]["cli"]
    assert lead[0].startswith("arch=tiny-llama2-7b") and \
        "devices=4 mesh={'data': 2, 'model': 2}" in lead[0]
    hist = [json.loads(x) for x in lead[1:] if x.startswith("{")]
    assert [h["step"] for h in hist] == [3] and np.isfinite(hist[0]["loss"])
    assert all(r["cli"] == [] for r in res[1:])    # rank 0 alone prints
