"""The single-executable decode: a run of decode steps as one CUDA graph,
the port's counterpart of the JAX package's masked, jitted `lax.scan`
(`ServeEngine._decode_scan_fn` and `ContinuousBatcher._tick_fn`).

A `CapturedBody` runs a Python `body()` that launches the steps' kernels
on static buffers. On a CUDA device it warms one step up on a side stream
(B2's member tables packed, the kernels built, every host plan cached),
captures `body()` into a `torch.cuda.CUDAGraph` and replays that graph at
each `run()`; a capture that fails raises, and nothing falls back to the
eager loop. On the CPU `body()` runs as it is: that is the graph's plain
version, which the tests hold against the JAX package.

A body may launch nothing whose arguments the host would have to read or
write at run time: no copy from the host, no read to the host, and no
plan that depends on a value on the device. Every host plan of the decode
path (B1/B3 `split_plan`, B2's member tables, B4's `decode_plan`, the MoE
`live` bound) is made from shapes alone, so it is fixed for a batch and
cache size and is frozen into the graph with the launch it belongs to.

The kernels' launch counters (`LAUNCHES`, and the plain versions'
`CALLS`) are Python counters that a wrapper bumps as it launches: a replay
runs no Python. So a capture records what the body added to each (and
takes it back, since the capture launched nothing), and every replay adds
it again; the counts read the same as those of the eager steps.

`DecodeGraph` is `ServeEngine.generate(scan=True)`'s body: `trip` decode
steps of a `Model` over an engine-owned cache whose addresses never
change, with the JAX package's per-lane budgets (`steps`) and its
temperature as a value on the device (`sample_traced`), so one graph per
(lanes, trip bucket) serves every (max_new, temperature) mix.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def _counters() -> tuple:
    """Every kernel launch counter and plain-version call counter."""
    from ..kernels.bitplane_gemv import kernel, program, ref
    from ..kernels.decode_attention import kernel as dk
    from ..kernels.decode_attention import ref as dref
    from ..kernels.quant_matmul import kernel as qk
    from ..kernels.quant_matmul import ref as qref
    return (kernel.LAUNCHES, program.LAUNCHES, dk.LAUNCHES, qk.LAUNCHES,
            ref.CALLS, dref.CALLS, qref.CALLS)


class CapturedBody:
    """`body()` as one CUDA graph on a CUDA `device`, captured here and
    replayed by `run()`; on any other device `run()` calls `body()`.

    `warm()` runs once on a side stream before the capture: one step of
    the body, on the same buffers, whose writes the caller can afford.
    `pool` (a `torch.cuda.graph_pool_handle()`) lets graphs that never
    replay at the same time share their memory. `capture_s` is the wall
    of the warm-up and the capture."""

    def __init__(self, body: Callable[[], None], warm: Callable[[], None],
                 device: torch.device, pool=None):
        self.body = body
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.added: list = []        # (counter dict, key, count) a replay
        self.capture_s = 0.0
        if device.type == "cuda":
            self._capture(warm, device, pool)

    @torch.no_grad()
    def _capture(self, warm, device, pool) -> None:
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warm()
        torch.cuda.current_stream(device).wait_stream(side)
        counters = _counters()
        before = [dict(d) for d in counters]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool):
                self.body()
        finally:
            # the capture launched nothing: what the body counted is what
            # each replay launches
            added = [(d, k, d[k] - was[k]) for d, was in zip(counters, before)
                     for k in d]
            for d, was in zip(counters, before):
                d.update(was)
        self.added = [a for a in added if a[2]]
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    @torch.no_grad()
    def run(self) -> None:
        if self.graph is None:
            self.body()
            return
        self.graph.replay()
        for d, k, n in self.added:
            d[k] += n


def copy_cache(dst, src) -> None:
    """Copy a decode-cache tree leaf by leaf into one of the same layout
    (keys, shapes and dtypes; raises otherwise), in place."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(dst) != set(src):
            got = sorted(src) if isinstance(src, dict) else type(src)
            raise ValueError(f"cache trees differ: {sorted(dst)} vs {got}")
        for k in dst:
            copy_cache(dst[k], src[k])
        return
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(f"cache leaf {tuple(src.shape)} {src.dtype} does "
                         f"not fit {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


def _race(logits: torch.Tensor, temperature: torch.Tensor,
          noise: torch.Tensor) -> torch.Tensor:
    """The exponential race: argmax(p / E) over softmax(logits / T), E ~
    Exp(1) independent per entry, draws category i with probability p_i
    (the same distribution as multinomial sampling)."""
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.argmax(probs / noise, dim=-1)


def sample(logits: torch.Tensor, temperature: float,
           gen: torch.Generator) -> torch.Tensor:
    """Greedy (temperature ≤ 0, no draw) or temperature sampling by the
    exponential race on one fresh draw of noise from `gen`: token for token
    what `sample_traced` gives on the same draw."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    t = torch.full((), temperature, dtype=torch.float32,
                   device=logits.device)
    noise = torch.empty(logits.shape, dtype=torch.float32,
                        device=logits.device).exponential_(generator=gen)
    return _race(logits, t, noise)


def sample_traced(logits: torch.Tensor, temperature: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
    """`sample` with the temperature a 0-d float32 tensor on the device
    (the JAX package's `_sample_traced`): both branches computed and the
    one the temperature picks selected, so one graph serves greedy and
    sampled decode. The positive temperature divides exactly as in
    `sample`; the stand-in 1 only feeds the branch that is not taken."""
    greedy = torch.argmax(logits, dim=-1)
    hot = temperature > 0.0
    safe = torch.where(hot, temperature, 1.0)
    return torch.where(hot, _race(logits, safe, noise), greedy)


class DecodeGraph:
    """`trip` decode steps of `model` over `cache` (the engine's, for
    `batch` lanes) as one captured body: the JAX package's masked scan.

    Static inputs: `cur` (B,) the tokens to feed at step 0, `pos0` the 0-d
    position of step 0, `steps` (B,) each lane's budget (step t samples
    while t < steps[lane], after that the lane re-emits its token),
    `temperature` 0-d float32 and `noise` (trip, B, V) the steps' Exp(1)
    draws; for a model that takes embeddings, `frames` (trip, B, E) is
    step t's input instead of the last token. Static output: `tokens`
    (trip, B), each step's token."""

    def __init__(self, model, params, cache: dict, batch: int, trip: int,
                 pool=None):
        leaf = cache
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        dev = leaf.device
        cfg = model.cfg
        self.model, self.params, self.cache, self.trip = (model, params,
                                                          cache, trip)
        long = dict(dtype=torch.long, device=dev)
        self.cur = torch.zeros(batch, **long)
        self.pos0 = torch.zeros((), **long)
        self.steps = torch.zeros(batch, **long)
        self.temperature = torch.zeros((), dtype=torch.float32, device=dev)
        self.noise = torch.ones((trip, batch, cfg.vocab_size),
                                dtype=torch.float32, device=dev)
        self.frames = (torch.zeros((trip, batch, cfg.d_model),
                                   dtype=model.dtype, device=dev)
                       if cfg.input_mode == "embeddings" else None)
        self.tokens = torch.zeros((trip, batch), **long)
        self.captured = CapturedBody(lambda: self._body(trip),
                                     lambda: self._step(0, self.cur), dev,
                                     pool)

    def _step(self, t: int, cur: torch.Tensor) -> torch.Tensor:
        inp = cur if self.frames is None else self.frames[t]
        logits, _ = self.model.decode_step(self.params, self.cache, inp,
                                           self.pos0 + t)
        nxt = torch.where(self.steps > t,
                          sample_traced(logits, self.temperature,
                                        self.noise[t]), cur)
        self.tokens[t].copy_(nxt)
        return nxt

    def _body(self, n: int) -> None:
        cur = self.cur
        for t in range(n):
            cur = self._step(t, cur)

    def run(self, cache: dict, cur: torch.Tensor, pos0: int,
            steps: torch.Tensor, temperature: float,
            gen: Optional[torch.Generator] = None,
            frames: Optional[torch.Tensor] = None,
            kept: Optional[int] = None) -> torch.Tensor:
        """Load the static inputs (the prefill's `cache` copied into the
        graph's; with `gen`, the steps' noise drawn one step after another,
        the order in which the loop draws it) and run the steps → the
        static (trip, B) tokens, valid until the next run. The graph runs
        all `trip` steps; where nothing was captured (the CPU) the body
        stops after the first `kept` (all by default), the steps whose
        tokens the caller keeps: the rest only write cache slots that the
        next run's copy overwrites."""
        copy_cache(self.cache, cache)
        self.cur.copy_(cur)
        self.pos0.fill_(pos0)
        self.steps.copy_(steps)
        self.temperature.fill_(temperature)
        if gen is not None:
            for t in range(self.trip):
                self.noise[t].exponential_(generator=gen)
        if self.frames is not None:
            self.frames.copy_(frames)
        if self.captured.graph is None:
            with torch.no_grad():
                self._body(min(kept or self.trip, self.trip))
        else:
            self.captured.run()
        return self.tokens
