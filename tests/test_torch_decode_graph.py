"""Port parity of the single-executable decode (`repro_torch.serve.
decode_graph`): `ServeEngine.generate(scan=True)` and the batcher's masked
tick, whose bodies run eagerly on the CPU (the captured graphs' plain
versions), against the JAX package's masked `lax.scan`s and against the
port's own per-step loops, on tiny configs in float32 with the same
parameters (`repro_torch.convert`).

Greedy decode is token for token JAX's scan for every cache kind of the
zoo (and for act_bits=4 with the quantizer's ±7.5 tie moved off, as in
tests/test_torch_serve.py); scan and loop agree token for token greedy
and with seeded sampling (the JAX package's tests/test_serve.py
contract); the (lanes, trip bucket) graphs follow JAX's buckets; per-lane
budgets freeze a lane's tail; one engine's calls leak no state into each
other; the graph tick follows JAX's batcher tick for tick and is bitwise
the per-step tick, outputs and every cache leaf. Also: gemma2's embedding
scale as a Python float, the embedding-input graph, and the launch
counters a replay adds.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.scheduler import ContinuousBatcher as JBatcher
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs import tiny_config
from repro_torch.kernels.bitplane_gemv import kernel as bp_kernel
from repro_torch.models.layers import embed, embed_scale
from repro_torch.models.model import Model, param_defs
from repro_torch.models.params import init_params
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.serve.decode_graph import CapturedBody, DecodeGraph
from repro_torch.serve.engine import ServeEngine, cache_leaves
from test_torch_model import fresh_jax_caches  # noqa: F401
from test_torch_scheduler import (  # noqa: F401
    KINDS, TRAFFIC, _requests, carried)
from test_torch_serve import _quantize_off_the_tie

MAX_SEQ = 24


def _prompts(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _engines(carried, arch, kw, **ekw):
    jcfg, tcfg, jparams, tparams = carried(arch)
    j = JServeEngine(jcfg, jparams, max_seq=MAX_SEQ, batch_slots=3, **kw,
                     **ekw)
    t = ServeEngine(tcfg, tparams, max_seq=MAX_SEQ, batch_slots=3,
                    device="cpu", **kw, **ekw)
    return j, t


@pytest.mark.parametrize("kind", list(KINDS))
def test_scan_matches_jax_scan_greedy(carried, kind):
    """Every cache kind: full, GQA, gemma2's ring, int8 K/V, MoE, MLA,
    Mamba2 state and the hybrid's shared caches; 6-token prompts, 8 new
    tokens (trip 8: the ring of 8 slots wraps), one lane capped."""
    arch, kw = KINDS[kind]
    jeng, teng = _engines(carried, arch, kw)
    prompts = _prompts(teng.cfg.vocab_size, (3, 6))
    for per_lane in (None, [8, 3, 0]):
        want = np.asarray(jeng.generate(jnp.asarray(prompts, jnp.int32),
                                        max_new=8,
                                        max_new_per_lane=per_lane))
        got = teng.generate(prompts, max_new=8, max_new_per_lane=per_lane)
        np.testing.assert_array_equal(got.numpy(), want)
    assert set(teng.decode_graphs) == {(3, t) for t in jeng._decode_fns}


def test_scan_matches_jax_scan_act_bits4_off_the_tie(carried, monkeypatch):
    """Quantized llama2-7b with 4-bit activations through the bit-plane
    kernels' plain versions, against JAX's scan, with the quantizer's
    absmax tie moved off in both packages."""
    jcfg, tcfg, jparams, tparams = carried("llama2-7b")
    prompts = _prompts(tcfg.vocab_size, (3, 6))
    kw = dict(max_seq=MAX_SEQ, batch_slots=3, quantized=True, act_bits=4)
    try:
        with monkeypatch.context() as mp:
            _quantize_off_the_tie(mp)
            want = np.asarray(JServeEngine(jcfg, jparams, **kw).generate(
                jnp.asarray(prompts, jnp.int32), max_new=8))
            teng = ServeEngine(tcfg, tparams, device="cpu", **kw)
            got = teng.generate(prompts, max_new=8)
    finally:
        jax.clear_caches()      # no trace of the swapped quantizer survives
    np.testing.assert_array_equal(got.numpy(), want)
    assert teng.mvdram.routed_linears > 0


@pytest.fixture(scope="module")
def llama():
    """Tiny llama2-7b in float32 (the JAX tests' model), its parameters
    drawn by the port."""
    cfg = dataclasses.replace(tiny_config("llama2-7b"), dtype="float32")
    return cfg, init_params(param_defs(cfg), torch.Generator().manual_seed(0),
                            "cpu")


@pytest.mark.parametrize("quantized", [False, True])
def test_scan_matches_loop_greedy_and_sampled(llama, quantized):
    """tests/test_serve.py's contract: the scan is token for token the
    loop, greedy and with seeded temperature sampling (both draw the same
    noise from the seed, step by step)."""
    cfg, params = llama
    eng = ServeEngine(cfg, params, max_seq=48, quantized=quantized,
                      act_bits=4 if quantized else None, device="cpu")
    prompts = _prompts(cfg.vocab_size, (2, 8))
    assert torch.equal(eng.generate(prompts, max_new=10),
                       eng.generate(prompts, max_new=10, scan=False))
    hot = eng.generate(prompts, max_new=6, temperature=0.8, seed=11)
    assert torch.equal(hot, eng.generate(prompts, max_new=6, temperature=0.8,
                                         seed=11, scan=False))
    assert not torch.equal(hot, eng.generate(prompts, max_new=6,
                                             temperature=0.8, seed=12))
    assert not torch.equal(hot, eng.generate(prompts, max_new=6))


def test_bucketed_graphs_across_requests(llama):
    """Four (max_new, temperature) mixes, trips 3, 8, 5 and 4, take the
    buckets {4, 8}: two graphs for the two lanes, each equal to the loop."""
    cfg, params = llama
    eng = ServeEngine(cfg, params, max_seq=40, device="cpu")
    prompts = _prompts(cfg.vocab_size, (2, 8))
    for max_new, temp, seed in [(4, 0.0, 0), (9, 0.0, 0), (6, 0.9, 5),
                                (5, 1.3, 2)]:
        got = eng.generate(prompts, max_new=max_new, temperature=temp,
                           seed=seed)
        want = eng.generate(prompts, max_new=max_new, temperature=temp,
                            seed=seed, scan=False)
        assert torch.equal(got, want), (max_new, temp)
    assert set(eng.decode_graphs) == {(2, 4), (2, 8)}


def test_per_lane_budgets(llama):
    """A lane past its budget re-emits its frozen token while the other
    keeps generating; tokens inside every budget are the uniform run's,
    and the loop applies the same freeze."""
    cfg, params = llama
    eng = ServeEngine(cfg, params, max_seq=32, device="cpu")
    prompts = _prompts(cfg.vocab_size, (2, 6))
    full = eng.generate(prompts, max_new=8)
    capped = eng.generate(prompts, max_new=8, max_new_per_lane=[3, 8])
    assert torch.equal(capped[1], full[1])
    assert torch.equal(capped[0, :6 + 3], full[0, :6 + 3])
    assert bool((capped[0, 6 + 3:] == capped[0, 6 + 2]).all())
    assert torch.equal(capped, eng.generate(prompts, max_new=8,
                                            max_new_per_lane=[3, 8],
                                            scan=False))


@pytest.mark.parametrize("kind", ["full", "ring", "ssm", "hybrid"])
def test_no_state_leaks_between_generate_calls(carried, kind):
    """Two calls on one engine, the second with a shorter prompt on the
    same (lanes, trip) graph, equal what fresh engines give: the second
    sees no entry, stamp or recurrent state of the first."""
    arch, kw = KINDS[kind]
    _, tcfg, _, tparams = carried(arch)

    def engine():
        return ServeEngine(tcfg, tparams, max_seq=MAX_SEQ, batch_slots=2,
                           device="cpu", **kw)
    # lengths the SSD scan's chunk of 8 divides
    long_p = _prompts(tcfg.vocab_size, (2, 16), seed=2)
    short_p = _prompts(tcfg.vocab_size, (2, 8), seed=3)
    eng = engine()
    first = eng.generate(long_p, max_new=4)
    second = eng.generate(short_p, max_new=4)
    assert list(eng.decode_graphs) == [(2, 4)]
    assert torch.equal(first, engine().generate(long_p, max_new=4))
    assert torch.equal(second, engine().generate(short_p, max_new=4))


def test_swapped_model_gets_its_own_graphs(carried):
    """A model swapped into the engine after a capture (as the smoke swaps
    in attention through B4) is not served by the old model's graphs."""
    _, tcfg, _, tparams = carried("llama2-7b")
    eng = ServeEngine(tcfg, tparams, max_seq=MAX_SEQ, batch_slots=2,
                      device="cpu")
    prompts = _prompts(tcfg.vocab_size, (2, 6))
    eng.generate(prompts, max_new=4)
    old = eng.decode_graphs[(2, 4)]
    eng.model = Model(tcfg, kv_bits=8, attn_impl="kernel")
    got = eng.generate(prompts, max_new=4)
    assert eng.decode_graphs[(2, 4)] is not old
    assert eng.decode_graphs[(2, 4)].model is eng.model
    assert torch.equal(got, eng.generate(prompts, max_new=4, scan=False))


def _cache_equal(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x, *_), (_, y, *_) in
               zip(cache_leaves(a), cache_leaves(b)))


@pytest.mark.parametrize("kind", list(KINDS))
def test_graph_tick_matches_jax_and_the_loop_tick(carried, kind):
    """The masked tick (`scan=True`) beside JAX's batcher and the per-step
    tick (`scan=False`) on the same requests: every tick's masks equal
    JAX's, the cache after every tick bitwise the loop's, and the request
    outputs, stamps and counters equal to both."""
    arch, kw = KINDS[kind]
    jcfg, tcfg, jparams, tparams = carried(arch)
    jb = JBatcher(jcfg, jparams, max_seq=24, lanes=3, prefill_chunk=4, **kw)
    sb, lb = (ContinuousBatcher(tcfg, tparams, max_seq=24, lanes=3,
                                prefill_chunk=4, device="cpu", scan=scan,
                                **kw) for scan in (True, False))
    for i, (p, m) in enumerate(_requests(jcfg.vocab_size)):
        jb.submit(JRequest(rid=i, prompt=p, max_new=m))
        sb.submit(Request(rid=i, prompt=p, max_new=m))
        lb.submit(Request(rid=i, prompt=p, max_new=m))
    ticks = 0
    while jb.pending or jb.in_flight:
        want = [m.tolist() for m in jb.tick_masks()]
        assert [m.tolist() for m in sb.tick_masks()] == want
        jb.tick()
        sb.tick()
        lb.tick()
        assert _cache_equal(sb.cache, lb.cache), ticks
        ticks += 1
    assert sb.pending == sb.in_flight == 0
    assert set(sb.tick_graphs) == {1, 4} and not lb.tick_graphs
    key = lambda r: (r.rid, r.out, r.done, r.first_token_s, r.finish_s)
    assert sorted(map(key, sb.finished)) == sorted(map(key, jb.finished)) \
        == sorted(map(key, lb.finished))
    assert len(sb.finished) == len(TRAFFIC)
    counters = lambda b: (b.ticks, b.program_ticks, b.occupancy_ticks,
                          b.tokens_out, b.decode_steps)
    assert counters(sb) == counters(lb)
    assert counters(sb)[:4] == (jb.ticks, jb.program_ticks,
                                jb.occupancy_ticks, jb.tokens_out)


def test_batcher_default_is_the_loop_on_the_cpu(carried):
    _, tcfg, _, tparams = carried("llama2-7b")
    b = ContinuousBatcher(tcfg, tparams, max_seq=24, lanes=2,
                          prefill_chunk=8, device="cpu")
    assert b.scan is False
    b = ContinuousBatcher(tcfg, tparams, max_seq=24, lanes=2,
                          prefill_chunk=6, device="cpu", scan=True)
    assert b.capture_graphs() == 0.0          # nothing captured on the CPU
    assert sorted(b.tick_graphs) == [1, 2, 4, 6]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d_model", [2304, 3584])
def test_embed_scale_is_the_tensor_product(dtype, d_model):
    """gemma2's embedding scale as a Python float gives, bitwise, the
    product with the 0-d tensor `tensor(d_model, dtype) ** 0.5` that it
    replaced (gemma2-2b's and gemma2-9b's widths)."""
    gen = torch.Generator().manual_seed(d_model)
    table = torch.randn((64, d_model), generator=gen) * 4
    tokens = torch.randint(0, 64, (3, 5), generator=gen)
    x = table[tokens].to(dtype)
    want = x * torch.tensor(d_model, dtype=dtype) ** 0.5
    got = embed(tokens, table, True, d_model, dtype=dtype)
    assert torch.equal(got, want)
    assert embed_scale(d_model, dtype) == float(
        torch.tensor(d_model, dtype=dtype) ** 0.5)


def test_frames_graph_matches_teacher_forced_steps():
    """A model that takes embeddings (pixtral-12b's stubbed frontend): the
    graph feeds step t's frames from its static buffer; its tokens are
    the argmax of the eager steps' logits on the same frames."""
    cfg = dataclasses.replace(tiny_config("pixtral-12b"), dtype="float32")
    gen = torch.Generator().manual_seed(4)
    params = init_params(param_defs(cfg), gen, "cpu")
    model = Model(cfg)
    frames = torch.randn((2, 6 + 4, cfg.d_model), generator=gen)
    _, cache = model.prefill(params, {"embeddings": frames[:, :6]}, 16)
    graph = DecodeGraph(model, params, model.init_cache(2, 16, "cpu"), 2, 4)
    got = graph.run(cache, torch.zeros(2, dtype=torch.long), 6,
                    torch.full((2,), 4), 0.0,
                    frames=frames[:, 6:].transpose(0, 1)).clone()
    want = []
    for t in range(4):
        logits, cache = model.decode_step(params, cache, frames[:, 6 + t],
                                          6 + t)
        want.append(torch.argmax(logits, dim=-1))
    assert torch.equal(got, torch.stack(want))


def test_replay_adds_what_the_capture_counted(monkeypatch):
    """The launch counters on a (faked) CUDA capture: the warm-up's real
    launches count, the capture's are taken back, and every replay adds
    what the body counted; a body that fails to capture raises and leaves
    the counters as they were."""
    replays = []

    class Graph:
        def replay(self):
            replays.append(1)

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setitem(bp_kernel.LAUNCHES, "gemv_bs", 0)
    monkeypatch.setitem(bp_kernel.LAUNCHES, "gemv_bs_fold", 0)

    def body():
        bp_kernel.LAUNCHES["gemv_bs"] += 3
        bp_kernel.LAUNCHES["gemv_bs_fold"] += 1

    def warm():
        bp_kernel.LAUNCHES["gemv_bs"] += 1

    cap = CapturedBody(body, warm, torch.device("cuda"))
    assert (bp_kernel.LAUNCHES["gemv_bs"],
            bp_kernel.LAUNCHES["gemv_bs_fold"]) == (1, 0)
    cap.run()
    cap.run()
    assert len(replays) == 2
    assert (bp_kernel.LAUNCHES["gemv_bs"],
            bp_kernel.LAUNCHES["gemv_bs_fold"]) == (7, 2)

    def broken():
        bp_kernel.LAUNCHES["gemv_bs"] += 5
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        CapturedBody(broken, lambda: None, torch.device("cuda"))
    assert bp_kernel.LAUNCHES["gemv_bs"] == 7
