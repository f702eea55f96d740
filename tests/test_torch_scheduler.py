"""Port parity: `repro_torch.serve.scheduler.ContinuousBatcher` against the
JAX package's batcher on the same requests, tiny configs in float32 with
the same parameters (`repro_torch.convert`), on the CPU.

Token streams per request, `ticks`, `program_ticks`, `occupancy_ticks` and
the `tick_masks()` of every tick are equal for every cache kind of the zoo:
full GQA caches (llama2-7b, qwen2-7b), gemma2-2b's ring of 8 slots with
max_seq 24 (a frozen lane's scratch write lands in slot 23 mod 8 = 7, a
live one), int8 K/V with scales, MoE with frozen lanes routed beside active
ones (qwen2-moe-a2.7b; deepseek-v2-lite-16b with MLA's latent cache),
Mamba2's conv and SSM state, and zamba2-7b's shared-block caches. A frozen
lane's every cache leaf is held bitwise across each step it is frozen in.
The reference's own invariants (tests/test_scheduler.py) are mirrored on
the port alone.
"""
import dataclasses
import pathlib
import re

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import tiny_config as j_tiny_config
from repro.models.model import param_defs as j_param_defs
from repro.models.params import init_params as j_init_params
from repro.serve.engine import _CACHE_AXES as J_CACHE_AXES
from repro.serve.scheduler import ContinuousBatcher as JBatcher
from repro.serve.scheduler import Request as JRequest
from repro_torch import convert
from repro_torch.configs import tiny_config
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.serve.engine import CACHE_AXES, ServeEngine, cache_leaves
from test_torch_model import JaxLinear, fresh_jax_caches  # noqa: F401
from test_torch_serve import _quantize_off_the_tie

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: (prompt length, max_new) of the parity traffic: 5 requests over 3
#: lanes, chunks of 4, so lanes recycle and decode lanes sit frozen inside
#: other lanes' prefill chunks
TRAFFIC = ((4, 5), (12, 3), (8, 6), (4, 2), (9, 4))
#: one family of each cache kind, with its batcher options
KINDS = {
    "full": ("llama2-7b", {}),
    "gqa": ("qwen2-7b", {}),
    "ring": ("gemma2-2b", {}),
    "int8": ("llama2-7b", {"kv_bits": 8}),
    "moe": ("qwen2-moe-a2.7b", {}),
    "mla_moe": ("deepseek-v2-lite-16b", {}),
    "ssm": ("mamba2-1.3b", {}),
    "hybrid": ("zamba2-7b", {}),
}


@pytest.fixture(scope="module")
def carried():
    """arch → (JAX config, port config, JAX parameters, the same values as
    the port's parameters), made once per arch."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg = dataclasses.replace(j_tiny_config(arch), dtype="float32")
            tcfg = dataclasses.replace(tiny_config(arch), dtype="float32")
            jparams = j_init_params(j_param_defs(jcfg),
                                    jax.random.PRNGKey(0))
            tparams = convert.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, jparams), "cpu")
            made[arch] = jcfg, tcfg, jparams, tparams
        return made[arch]
    return get


def _batcher(carried, arch, **kw):
    _, tcfg, _, tparams = carried(arch)
    return ContinuousBatcher(tcfg, tparams, device="cpu", **kw)


def _requests(vocab, shape=TRAFFIC, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=n).tolist(), m) for n, m in shape]


def _lane_rows(cache, lane):
    """A copy of one lane's rows of every cache leaf, by path."""
    return {path: leaf.select(axis, lane).clone()
            for path, leaf, axis, _ in cache_leaves(cache)}


class FrozenWatch:
    """Wraps a batcher's `_step`: each lane frozen at a step must keep every
    cache leaf bitwise across it. Counts the steps in which a lane holding
    a request sat frozen beside an active lane."""

    def __init__(self, batcher):
        self.b, self.real, self.shared = batcher, batcher._step, 0
        batcher._step = self

    def __call__(self, tok, pos, frozen):
        before = {i: _lane_rows(self.b.cache, i) for i in frozen}
        logits = self.real(tok, pos, frozen)
        for i, rows in before.items():
            after = _lane_rows(self.b.cache, i)
            for path, want in rows.items():
                assert torch.equal(after[path], want), (i, path)
        occupied = {i for i, lane in enumerate(self.b.lanes)
                    if not lane.free}
        if occupied & set(frozen) and len(frozen) < len(self.b.lanes):
            self.shared += 1
        return logits


@pytest.mark.parametrize("kind", list(KINDS))
def test_batcher_matches_jax_batcher(carried, kind):
    """Same requests through both batchers, tick by tick: every tick's
    masks, then each request's tokens, done flag and clock stamps, and
    the tick and program counters."""
    arch, kw = KINDS[kind]
    jcfg, _, jparams, _ = carried(arch)
    jb = JBatcher(jcfg, jparams, max_seq=24, lanes=3, prefill_chunk=4, **kw)
    tb = _batcher(carried, arch, max_seq=24, lanes=3, prefill_chunk=4, **kw)
    watch = FrozenWatch(tb)
    for i, (p, m) in enumerate(_requests(jcfg.vocab_size)):
        jb.submit(JRequest(rid=i, prompt=p, max_new=m))
        tb.submit(Request(rid=i, prompt=p, max_new=m))
    while jb.pending or jb.in_flight:
        want = [m.tolist() for m in jb.tick_masks()]
        assert [m.tolist() for m in tb.tick_masks()] == want
        jb.tick()
        tb.tick()
    assert tb.pending == tb.in_flight == 0
    assert watch.shared > 0
    assert (tb.ticks, tb.program_ticks, tb.occupancy_ticks, tb.tokens_out) \
        == (jb.ticks, jb.program_ticks, jb.occupancy_ticks, jb.tokens_out)
    key = lambda r: (r.rid, r.out, r.done, r.first_token_s, r.finish_s)
    assert sorted(map(key, tb.finished)) == sorted(map(key, jb.finished))
    assert len(tb.finished) == len(TRAFFIC)
    assert tb.sim_time_s == jb.sim_time_s == 0.0


def test_cache_axes_equal_jax():
    assert CACHE_AXES == J_CACHE_AXES


@pytest.mark.parametrize("kind", list(KINDS))
def test_cache_axis_map_covers_every_leaf(carried, kind):
    """Every leaf of each family's batcher cache has an entry in the axis
    map; its lane axis spans the lanes, its kv_seq axis the stage's slots
    (a ring's window, else max_seq)."""
    arch, kw = KINDS[kind]
    b = _batcher(carried, arch, max_seq=24, lanes=3, **kw)
    window = b.cfg.attn.sliding_window if b.cfg.attn else None
    leaves = list(cache_leaves(b.cache))
    assert {p[-1] for p, *_ in leaves} <= set(CACHE_AXES)
    for path, leaf, lane, seq in leaves:
        assert leaf.shape[lane] == 3, path
        if seq is not None:
            assert leaf.shape[seq] in (24, window), path
    if kind == "hybrid":
        assert {p[0] for p, *_ in leaves} == {"stages", "shared", "trailing"}
    if kind == "mla_moe":
        assert {p[0] for p, *_ in leaves} == {"first", "stages"}


@pytest.mark.parametrize("kind", list(KINDS))
def test_frozen_lane_leaves_bitwise_across_a_tick(carried, kind):
    """A lane frozen for a whole tick (free, beside a lane in prefill) keeps
    every cache leaf bitwise, including ring slots and recurrent state it
    held from an earlier request; so does every lane at every step it is
    frozen in."""
    arch, kw = KINDS[kind]
    b = _batcher(carried, arch, max_seq=24, lanes=2, prefill_chunk=4, **kw)
    FrozenWatch(b)
    reqs = _requests(b.cfg.vocab_size, ((10, 2), (12, 3), (8, 4)))
    for i, (p, m) in enumerate(reqs[:2]):
        b.submit(Request(rid=i, prompt=p, max_new=m))
    b.run()                       # both lanes now hold stale state
    b.submit(Request(rid=2, prompt=reqs[2][0], max_new=reqs[2][1]))
    held = 0
    while b.pending or b.in_flight:
        b._admit()
        idle = [i for i, s in enumerate(b._plan_steps()) if s == 0]
        assert idle == [1]
        rows = _lane_rows(b.cache, 1)
        b.tick()
        got = _lane_rows(b.cache, 1)
        assert all(torch.equal(got[k], v) for k, v in rows.items())
        held += 1
    assert held >= 4
    # what lane 1 holds is the earlier request's: stamps or state
    assert any(bool((v >= 0).any()) if k[-1] == "positions"
               else k[-1] == "ssm" and bool(v.any())
               for k, v in got.items())


def test_reset_lane_in_place(carried):
    """Admission resets one lane: stamps −1 and conv/SSM state 0 in every
    stack, nothing else touched, and no leaf replaced."""
    b = _batcher(carried, "zamba2-7b", max_seq=24, lanes=3)
    for path, leaf, *_ in cache_leaves(b.cache):
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape))
    before = {p: (leaf, leaf.clone()) for p, leaf, *_ in
              cache_leaves(b.cache)}
    b._reset_lane(1)
    for path, leaf, axis, _ in cache_leaves(b.cache):
        same, old = before[path]
        assert leaf is same
        want = old.clone()
        if path[-1] == "positions":
            want.select(axis, 1).fill_(-1)
        elif path[-1] in ("conv", "ssm"):
            want.select(axis, 1).zero_()
        assert torch.equal(leaf, want), path


# ---------------------------------------------------------------------------
# the JAX package's invariants (tests/test_scheduler.py), on the port alone
# ---------------------------------------------------------------------------

def _solo(carried, arch, prompt, max_new, max_seq=48, lanes=1):
    b = _batcher(carried, arch, max_seq=max_seq, lanes=lanes)
    b.submit(Request(rid=0, prompt=list(prompt), max_new=max_new))
    (done,) = b.run()
    return done.out


@pytest.mark.parametrize("arch", ["llama2-7b", "mamba2-1.3b"])
def test_interleaved_equals_solo(carried, arch):
    vocab = carried(arch)[1].vocab_size
    reqs = _requests(vocab, ((5, 6), (11, 4), (3, 9), (8, 5)), seed=0)
    solo = [_solo(carried, arch, p, n) for p, n in reqs]
    b = _batcher(carried, arch, max_seq=48, lanes=2)
    for i, (p, n) in enumerate(reqs):
        b.submit(Request(rid=i, prompt=p, max_new=n))
    done = b.run()
    assert len(done) == 4
    assert {r.rid: r.out for r in done} == dict(enumerate(solo))


def test_lane_recycling_no_crosstalk(carried):
    """Request C lands in the lane A used; A's stale stamps are invisible."""
    (pa, _), (pc, _) = _requests(256, ((12, 0), (4, 0)), seed=1)
    solo_c = _solo(carried, "qwen2-7b", pc, 5)
    b = _batcher(carried, "qwen2-7b", max_seq=48, lanes=1)
    b.submit(Request(rid=0, prompt=pa, max_new=3))
    b.submit(Request(rid=1, prompt=pc, max_new=5))
    done = b.run()
    assert {r.rid for r in done} == {0, 1}
    assert next(r for r in done if r.rid == 1).out == solo_c


def test_throughput_counts_ticks(carried):
    b = _batcher(carried, "llama2-7b", max_seq=32, lanes=4)
    for i in range(4):
        b.submit(Request(rid=i, prompt=[1, 2, 3], max_new=4))
    b.run()
    # 4 lanes in parallel: total ticks ≈ prompt+gen, not 4×
    assert b.ticks <= 3 + 4 + 2, b.ticks
    assert b.decode_steps >= b.program_ticks >= b.ticks


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 2 ** 16), lanes=st.integers(1, 3),
       n=st.integers(2, 5))
def test_random_admission_pattern_property(carried, seed, lanes, n):
    """Any queue of requests with random prompt and generation lengths over
    few lanes: every request finishes and matches its solo output."""
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, 256, size=rng.integers(2, 10)).tolist(),
             int(rng.integers(1, 7))) for _ in range(n)]
    solo = [_solo(carried, "llama2-7b", p, m, max_seq=32) for p, m in reqs]
    b = _batcher(carried, "llama2-7b", max_seq=32, lanes=lanes)
    for i, (p, m) in enumerate(reqs):
        b.submit(Request(rid=i, prompt=p, max_new=m))
    done = b.run()
    assert len(done) == n and all(r.done for r in done)
    for r in done:
        assert r.out == solo[r.rid], (r.rid, r.out, solo[r.rid])


def test_submit_rejects_oversized_prompt(carried):
    b = _batcher(carried, "llama2-7b", max_seq=16, lanes=1)
    with pytest.raises(ValueError, match=r"14 tokens.*max_new \(4\).*15"):
        b.submit(Request(rid=7, prompt=list(range(14)), max_new=4))
    assert b.pending == 0
    b.submit(Request(rid=8, prompt=list(range(11)), max_new=4))
    (done,) = b.run()
    assert done.done and len(done.out) == 4


def test_submit_rejects_empty_prompt_and_no_tokens(carried):
    b = _batcher(carried, "llama2-7b", max_seq=16, lanes=1)
    with pytest.raises(ValueError, match="empty prompt"):
        b.submit(Request(rid=3, prompt=[], max_new=2))
    with pytest.raises(ValueError, match="max_new"):
        b.submit(Request(rid=4, prompt=[1, 2], max_new=0))
    assert b.pending == 0


def test_bad_prefill_chunk_and_embedding_inputs_refused(carried):
    with pytest.raises(ValueError, match="prefill_chunk"):
        _batcher(carried, "llama2-7b", prefill_chunk=0)
    cfg = tiny_config("pixtral-12b")
    eng = ServeEngine(cfg, {}, max_seq=16, batch_slots=1, device="cpu")
    with pytest.raises(ValueError, match="embeddings"):
        ContinuousBatcher(cfg, None, engine=eng)


def test_run_returns_starved_requests(carried):
    b = _batcher(carried, "llama2-7b", max_seq=32, lanes=1)
    for i in range(3):
        b.submit(Request(rid=i, prompt=[1, 2, 3, 4], max_new=6))
    assert b.pending == 3 and b.in_flight == 0
    out = b.run(max_ticks=2)
    assert {r.rid for r in out} == {0, 1, 2}
    assert not any(r.done for r in out)
    assert b.in_flight == 1 and b.pending == 2
    out = b.run()
    assert all(r.done for r in out) and len(out) == 3
    assert b.pending == 0 and b.in_flight == 0


@pytest.mark.parametrize("arch", ["llama2-7b", "mamba2-1.3b"])
def test_batcher_matches_generate_at_full_occupancy(carried, arch):
    """The batcher on the same engine as `ServeEngine.generate` gives the
    same greedy tokens at full occupancy."""
    _, tcfg, _, tparams = carried(arch)
    rng = np.random.default_rng(5)
    s0, max_new = 6, 5
    prompts = rng.integers(0, tcfg.vocab_size, size=(2, s0))
    eng = ServeEngine(tcfg, tparams, max_seq=48, batch_slots=2,
                      device="cpu")
    toks = eng.generate(prompts, max_new=max_new).numpy()
    b = ContinuousBatcher(tcfg, None, engine=eng)
    assert b.device == eng.device and b.model is eng.model
    for i in range(2):
        b.submit(Request(rid=i, prompt=prompts[i].tolist(),
                         max_new=max_new))
    by = {r.rid: r.out for r in b.run()}
    for i in range(2):
        assert by[i] == toks[i, s0:].tolist(), (i, by[i], toks[i, s0:])


def test_prefill_chunk_invariance(carried):
    reqs = _requests(256, ((9, 3), (4, 5), (13, 2)), seed=9)
    outs = []
    for chunk in (1, 4, 8):
        b = _batcher(carried, "llama2-7b", max_seq=32, lanes=2,
                     prefill_chunk=chunk)
        for i, (p, m) in enumerate(reqs):
            b.submit(Request(rid=i, prompt=p, max_new=m))
        outs.append({r.rid: r.out for r in b.run()})
    assert outs[0] == outs[1] == outs[2]


def test_act_bits4_tokens_bitwise_with_jax_linears(carried):
    """act_bits=4 through the bit-plane kernels' plain versions, token for
    token the same as the batcher whose every bit-plane linear is the JAX
    package's kernel (tests/test_torch_serve.py says why not JAX's own
    act_bits=4 model)."""
    _, tcfg, _, tparams = carried("llama2-7b")
    kw = dict(max_seq=24, batch_slots=2, quantized=True, act_bits=4,
              device="cpu")
    port, hybrid = ServeEngine(tcfg, tparams, **kw), \
        ServeEngine(tcfg, tparams, **kw)
    hybrid.model.impl = JaxLinear()
    outs = []
    for eng in (port, hybrid):
        b = ContinuousBatcher(tcfg, None, engine=eng, prefill_chunk=4)
        for i, (p, m) in enumerate(_requests(256, ((6, 3), (3, 4)))):
            b.submit(Request(rid=i, prompt=p, max_new=m))
        outs.append({r.rid: r.out for r in b.run()})
    assert outs[0] == outs[1]
    assert port.mvdram.routed_linears > 0


def test_act_bits4_tokens_match_jax_batcher_off_the_tie(carried,
                                                        monkeypatch):
    """Off the activation quantizer's tie, the act_bits=4 batcher gives the
    JAX batcher's tokens on its quantized engine, and the same priced DDR4
    clock."""
    jcfg, tcfg, jparams, tparams = carried("llama2-7b")
    kw = dict(max_seq=24, lanes=2, prefill_chunk=4, quantized=True,
              act_bits=4)
    outs, clocks = [], []
    try:
        with monkeypatch.context() as mp:
            _quantize_off_the_tie(mp)
            for b, req in ((JBatcher(jcfg, jparams, **kw), JRequest),
                           (ContinuousBatcher(tcfg, tparams, device="cpu",
                                              **kw), Request)):
                for i, (p, m) in enumerate(
                        _requests(256, ((6, 3), (3, 4), (5, 2)))):
                    b.submit(req(rid=i, prompt=p, max_new=m))
                outs.append({r.rid: r.out for r in b.run()})
                clocks.append(b.sim_time_s)
    finally:
        jax.clear_caches()      # no trace of the swapped quantizer survives
    assert outs[0] == outs[1]
    assert b.engine.mvdram.routed_linears > 0
    assert clocks[1] == clocks[0] > 0.0


def test_no_device_on_a_cuda_less_host_raises(carried, monkeypatch):
    _, tcfg, _, tparams = carried("llama2-7b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(tcfg, tparams)


def test_no_bare_assert_in_port_serve():
    banned = re.compile(r"^\s*assert\b", re.MULTILINE)
    files = sorted((ROOT / "src" / "repro_torch" / "serve").glob("*.py"))
    assert any(f.name == "scheduler.py" for f in files)
    offenders = [f.name for f in files if banned.search(f.read_text())]
    assert not offenders, f"bare assert — raise ValueError: {offenders}"


def test_serve_cli_help_runs(capsys):
    with pytest.raises(SystemExit) as exit_:
        serve_cli.main(["--help"])
    assert exit_.value.code == 0
    assert "--arch" in capsys.readouterr().out
