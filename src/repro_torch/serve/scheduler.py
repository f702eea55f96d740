"""Continuous batching (port of the JAX package's `serve/scheduler.py`):
requests of DIFFERENT lengths share the decode lanes.

Every scheduler tick runs `trip` decode steps of `Model.decode_step` over
all lanes:

  * a lane in PREFILL phase streams its prompt in CHUNKS: up to
    `prefill_chunk` tokens advance through the decode path in one tick,
    interleaved with other lanes' generation;
  * a lane in DECODE phase feeds its previously sampled token (one step);
  * a FREE lane, or a lane whose step budget for this tick is exhausted,
    is FROZEN at that step: its step is computed (token 0 at position
    max_seq − 1, exactly as in the JAX package, so a mixture-of-experts
    layer routes it with the other lanes), and then every cache leaf of
    that lane is put back as it was.

The trip count buckets to the next power of two, capped at
`prefill_chunk`, as the JAX package's executables do. With `scan` (the
default on CUDA) a tick is the JAX package's masked scan: the bucket's
steps run as ONE captured CUDA graph (`serve.decode_graph.CapturedBody`),
one graph per bucket, over static inputs (each lane's tokens, first
position and step budget) filled from pinned host memory before the
replay; on the CPU the graph's body runs eagerly. A capture that fails
raises. Without `scan` (the default on the CPU, where the tests hold it
step by step) a tick is a Python loop of `_step` calls: the oracle, and
bitwise what the graph gives, outputs and cache.

The JAX package freezes a lane with a select over every leaf of the whole
cache at every step. The port's caches are updated in place, so the freeze
undoes the step's writes: a frozen lane writes position max_seq − 1, so
what a step can write is, for every stacked leaf, the (lane, (max_seq − 1)
mod slots) row of each K/V, scale, stamp and latent leaf (a full cache and
a ring of window slots alike: in a ring that slot may hold a live entry,
which the undo restores), and the lane's whole conv and SSM state rows
(`serve.engine.CACHE_AXES`). The loop gathers the frozen lanes' rows
before a step and scatters them back after it (`_step`, by a host tuple of
lanes); the graph saves every lane's rows, runs the step and selects the
saved rows back where the step's mask says a lane is frozen.

Each lane's next token is the argmax of the logits at its last active
step, kept on the device and read to the host once a tick: nothing else on
the decode path copies from the host or reads to the host. Lane admission
is O(1): position stamps −1 invalidate the previous occupant's entries,
and the recurrent state is zeroed.

The batcher rides on a `ServeEngine` residency session: a quantized
engine compiles the model's GeMV sequence into a CAPACITY program (`b_max`
= lanes), and every inner decode step is accounted against it at the
step's lane occupancy (`decode_tick_cost_s`): `sim_time_s` is the priced
DDR4 clock (the model's seconds, not the card's) that stamps each
request's `first_token_s` and `finish_s`, as in the JAX package. An
engine without a program (unquantized, or a model that did not fit its
pool) leaves it at 0.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from .decode_graph import CapturedBody
from .engine import ServeEngine, cache_leaves


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list            # token ids
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # traffic bookkeeping: priced DDR4-clock stamps
    arrival_s: float = 0.0
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None


@dataclasses.dataclass
class _Lane:
    req: Optional[Request] = None
    pos: int = 0            # next position to write
    fed: int = 0            # prompt tokens already fed
    last_tok: int = 0

    @property
    def free(self):
        return self.req is None

    @property
    def prefilling(self):
        return self.req is not None and self.fed < len(self.req.prompt)


class TickGraph:
    """One trip bucket of the batcher's masked tick (the JAX package's
    `_tick_fn` body) as a captured body over the batcher's cache. Static
    input `plan` (B, trip + 2): each lane's tokens of the tick, its first
    position and its step budget; static output `nxt` (B,): each lane's
    argmax at its last active step (0 for a lane with no step)."""

    def __init__(self, batcher: "ContinuousBatcher", trip: int, pool=None):
        self.b, self.trip = batcher, trip
        lanes = len(batcher.lanes)
        dev = batcher.device
        self.plan = torch.zeros((lanes, trip + 2), dtype=torch.long,
                                device=dev)
        self.nxt = torch.zeros(lanes, dtype=torch.long, device=dev)
        # the rows a step of a frozen lane writes, with the shape its lane
        # mask broadcasts to
        self.rows = []
        for _, leaf, lane_axis, seq_axis in cache_leaves(batcher.cache):
            rows = leaf if seq_axis is None else leaf.select(
                seq_axis, (batcher.max_seq - 1) % leaf.shape[seq_axis])
            shape = [1] * rows.ndim
            shape[lane_axis] = lanes
            self.rows.append((rows, shape))
        # the warm-up step runs with every budget 0: every lane frozen, so
        # it leaves the cache bitwise as it was
        self.captured = CapturedBody(self._body,
                                     lambda: self._step(0, self.nxt), dev,
                                     pool)

    def _step(self, t: int, nxt: torch.Tensor) -> torch.Tensor:
        b = self.b
        steps = self.plan[:, self.trip + 1]
        active = steps > t
        tok = torch.where(active, self.plan[:, t], 0)
        pos = torch.where(active, self.plan[:, self.trip] + t,
                          b.max_seq - 1)
        saved = [rows.clone() for rows, _ in self.rows]
        logits, _ = b.model.decode_step(b.params, b.cache, tok, pos)
        frozen = ~active
        for (rows, shape), old in zip(self.rows, saved):
            torch.where(frozen.view(shape), old, rows, out=rows)
        return torch.where(steps - 1 == t, torch.argmax(logits, -1), nxt)

    def _body(self) -> None:
        nxt = torch.zeros_like(self.nxt)
        for t in range(self.trip):
            nxt = self._step(t, nxt)
        self.nxt.copy_(nxt)

    def run(self, plan: torch.Tensor) -> torch.Tensor:
        """Load the (B, trip + 2) host `plan` and run the tick's steps →
        the static `nxt`, valid until the next run."""
        if self.plan.is_cuda:
            plan = plan.pin_memory()
        self.plan.copy_(plan, non_blocking=True)
        self.captured.run()
        return self.nxt


class ContinuousBatcher:
    """Fixed-lane continuous batching over a `ServeEngine`'s model, on the
    engine's device (the GPU unless `device` or the engine says
    otherwise). `scan`: a tick as one captured graph of its trip bucket
    (True), or as the per-step loop, the oracle (False); by default the
    graph on CUDA and the loop elsewhere."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int = 256,
                 lanes: int = 4, kv_bits: Optional[int] = None,
                 quantized: bool = False, act_bits: Optional[int] = None,
                 prefill_chunk: int = 8,
                 engine: Optional[ServeEngine] = None, device=None,
                 scan: Optional[bool] = None):
        if not isinstance(prefill_chunk, int) or prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be a positive int, got "
                f"{prefill_chunk!r}")
        if engine is None:
            engine = ServeEngine(cfg, params, max_seq=max_seq,
                                 batch_slots=lanes, quantized=quantized,
                                 act_bits=act_bits, kv_bits=kv_bits,
                                 device=device)
        if engine.cfg.input_mode != "tokens":
            raise ValueError(
                f"{engine.cfg.name} takes embeddings from a stubbed "
                f"frontend; the batcher feeds token ids")
        self.engine = engine
        self.cfg = engine.cfg
        self.params = engine.params
        self.model = engine.model
        self.max_seq = engine.max_seq
        self.device = engine.device
        self.prefill_chunk = prefill_chunk
        self.lanes = [_Lane() for _ in range(engine.slots)]
        self.cache = self.model.init_cache(engine.slots, engine.max_seq,
                                           engine.device)
        self._lane_index: dict = {}
        self.scan = self.device.type == "cuda" if scan is None else scan
        self.tick_graphs: dict = {}         # trip bucket -> TickGraph
        self._graph_pool = None
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.ticks = 0
        self.decode_steps = 0       # Model.decode_step calls (trip a tick)
        # resident-program accounting: every inner decode step is one
        # execution of the engine's program at that step's lane occupancy
        self.program_ticks = 0
        self.sim_time_s = 0.0
        self.occupancy_ticks: dict = {}
        self.tokens_out = 0

    def _upload(self, host: torch.Tensor) -> torch.Tensor:
        """A host tensor on the batcher's device; to a GPU through pinned
        memory and without waiting for the device."""
        if self.device.type != "cuda":
            return host.to(self.device)
        return host.pin_memory().to(self.device, non_blocking=True)

    def _tick_graph(self, trip: int) -> TickGraph:
        """The tick graph of a trip bucket, captured on first use."""
        graph = self.tick_graphs.get(trip)
        if graph is None:
            if self.device.type == "cuda" and self._graph_pool is None:
                # the batcher's graphs never replay at once: one pool
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = self.tick_graphs[trip] = TickGraph(self, trip,
                                                       self._graph_pool)
        return graph

    def capture_graphs(self) -> float:
        """Capture the graph of every trip bucket a tick can take now (so
        that no capture falls inside a timed run) → the seconds they
        took."""
        trips = {min(self.prefill_chunk, 1 << (k - 1).bit_length())
                 for k in range(1, self.prefill_chunk + 1)}
        return sum(self._tick_graph(t).captured.capture_s
                   for t in sorted(trips))

    def _reset_lane(self, lane: int) -> None:
        """Invalidate one lane in place: position stamps → −1 (masks the
        previous occupant's KV entries), recurrent states → 0. K/V payloads
        and scales can stay: stamps gate them."""
        for path, leaf, lane_axis, _ in cache_leaves(self.cache):
            if path[-1] == "positions":
                leaf.select(lane_axis, lane).fill_(-1)
            elif path[-1] in ("ssm", "conv"):
                leaf.select(lane_axis, lane).zero_()

    def _step(self, tok: torch.Tensor, pos: torch.Tensor,
              frozen: tuple) -> torch.Tensor:
        """One decode step of every lane → logits (B, V); the lanes in
        `frozen` keep every cache leaf bit-identical: the rows their step
        writes are gathered before it and scattered back after it."""
        log = []
        if frozen:
            if frozen not in self._lane_index:
                self._lane_index[frozen] = self._upload(torch.tensor(frozen))
            idx = self._lane_index[frozen]
            for _, leaf, lane_axis, seq_axis in cache_leaves(self.cache):
                rows = leaf if seq_axis is None else leaf.select(
                    seq_axis, (self.max_seq - 1) % leaf.shape[seq_axis])
                log.append((rows, lane_axis, rows.index_select(lane_axis,
                                                               idx)))
        logits, _ = self.model.decode_step(self.params, self.cache, tok, pos)
        for rows, lane_axis, saved in log:
            rows.index_copy_(lane_axis, idx, saved)
        return logits

    # -- API ---------------------------------------------------------------

    def submit(self, req: Request):
        """Queue a request, validating it against the cache horizon up
        front: an oversized request would be truncated mid-prefill, and an
        empty prompt has no token to start from."""
        if not req.prompt:
            raise ValueError(
                f"request {req.rid}: empty prompt — there is no token to "
                f"prefill and no logits to decode from")
        if req.max_new < 1:
            raise ValueError(
                f"request {req.rid}: max_new={req.max_new} must be >= 1")
        if len(req.prompt) + req.max_new > self.max_seq - 1:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)} tokens) + "
                f"max_new ({req.max_new}) exceeds the usable horizon "
                f"max_seq - 1 = {self.max_seq - 1} (the last slot is the "
                f"frozen-lane scratch); it would be truncated mid-flight")
        self.queue.append(req)

    def run(self, max_ticks: int = 10_000):
        """Tick until every request finishes or the budget expires.

        Returns finished requests PLUS any the budget starved — queued or
        still in flight — flagged `done=False` (they also stay in
        `self.queue`/lanes and keep counting in `pending`/`in_flight`)."""
        while self.queue or any(not lane.free for lane in self.lanes):
            if self.ticks >= max_ticks:
                break
            self.tick()
        starved = [lane.req for lane in self.lanes if lane.req is not None]
        starved += self.queue
        return self.finished + starved

    @property
    def pending(self) -> int:
        """Requests still waiting for a lane."""
        return len(self.queue)

    @property
    def in_flight(self) -> int:
        """Requests currently occupying a lane."""
        return sum(0 if lane.free else 1 for lane in self.lanes)

    # -- one tick -----------------------------------------------------------

    def _admit(self):
        for i, lane in enumerate(self.lanes):
            if lane.free and self.queue:
                req = self.queue.pop(0)
                lane.req, lane.pos, lane.fed = req, 0, 0
                lane.last_tok = req.prompt[0]
                self._reset_lane(i)

    def _plan_steps(self) -> list:
        """Per-lane inner-step budget for this tick: 0 free / 1 decode /
        min(prefill_chunk, remaining prompt) prefill."""
        steps = []
        for lane in self.lanes:
            if lane.free:
                steps.append(0)
            elif lane.prefilling:
                steps.append(min(self.prefill_chunk,
                                 len(lane.req.prompt) - lane.fed))
            else:
                steps.append(1)
        return steps

    def tick_masks(self, steps: Optional[list] = None) -> list:
        """(trip,) per-inner-step lane-occupancy masks of the NEXT tick
        (step t runs the lanes with more than t steps budgeted)."""
        if steps is None:
            steps = self._plan_steps()
        sv = np.asarray(steps)
        return [sv > t for t in range(int(sv.max(initial=0)))]

    def _account_program(self, steps: list):
        """Advance the priced DDR4 clock by this tick's resident-program
        executions: inner step t runs the capacity program at occupancy
        = |lanes with steps > t| (masked lanes bill zero, so the
        per-occupancy price IS the masked execution's price)."""
        for m in self.tick_masks(steps):
            occ = int(m.sum())
            self.program_ticks += 1
            self.occupancy_ticks[occ] = self.occupancy_ticks.get(occ, 0) + 1
            cost = self.engine.decode_tick_cost_s(occ) \
                if self.engine.decode_program is not None else None
            if cost is not None:
                self.sim_time_s += cost

    @torch.no_grad()
    def tick(self):
        self._admit()
        steps = self._plan_steps()
        trip_need = max(steps)
        if trip_need == 0:
            return                      # nothing in flight, nothing queued
        # power-of-two trip bucket, as the JAX package's executables
        trip = min(self.prefill_chunk, 1 << (trip_need - 1).bit_length())
        self._account_program(steps)
        nxt = (self._tick_scan(steps, trip) if self.scan
               else self._tick_loop(steps, trip))
        self.decode_steps += trip
        nxt = nxt.tolist()                 # the tick's one read to the host
        for i, lane in enumerate(self.lanes):
            if lane.free:
                continue
            adv = steps[i]
            lane.pos += adv
            if lane.fed < len(lane.req.prompt):
                lane.fed += adv
                if lane.fed == len(lane.req.prompt):     # prompt done →
                    lane.last_tok = nxt[i]               # first sampled tok
                    lane.req.out.append(lane.last_tok)
                    self.tokens_out += 1
                    if lane.req.first_token_s is None:
                        lane.req.first_token_s = self.sim_time_s
            else:
                lane.last_tok = nxt[i]
                lane.req.out.append(lane.last_tok)
                self.tokens_out += 1
            if len(lane.req.out) >= lane.req.max_new:
                lane.req.done = True
                lane.req.finish_s = self.sim_time_s
                self.finished.append(lane.req)
                lane.req = None
        self.ticks += 1

    def _tick_scan(self, steps: list, trip: int) -> torch.Tensor:
        """The tick as one replay of its bucket's graph: lane i feeds
        tokens[i][t] at position pos0[i] + t while t < steps[i]."""
        plan = []
        for lane, s in zip(self.lanes, steps):
            if lane.free:
                toks = []
            elif lane.prefilling:
                toks = lane.req.prompt[lane.fed:lane.fed + s]
            else:
                toks = [lane.last_tok]
            plan.append(toks + [0] * (trip - len(toks)) + [lane.pos, s])
        return self._tick_graph(trip).run(torch.tensor(plan))

    def _tick_loop(self, steps: list, trip: int) -> torch.Tensor:
        """The tick as a Python loop of `_step` calls, the oracle."""
        # the (token, position, last active step?) of every lane at every
        # step: lane i feeds its tokens at pos0 + t while t < steps[i], then
        # token 0 at max_seq − 1, frozen
        plan = [[], [], []]
        for t in range(trip):
            for rows in plan:
                rows.append([])
            for lane, s in zip(self.lanes, steps):
                if t >= s:
                    tok, pos, last = 0, self.max_seq - 1, 0
                else:
                    tok = (lane.req.prompt[lane.fed + t] if lane.prefilling
                           else lane.last_tok)
                    pos, last = lane.pos + t, int(t == s - 1)
                for rows, v in zip(plan, (tok, pos, last)):
                    rows[-1].append(int(v))
        toks, poss, lasts = self._upload(torch.tensor(plan))
        nxt = torch.zeros(len(self.lanes), dtype=torch.long,
                          device=self.device)
        for t in range(trip):
            frozen = tuple(i for i, s in enumerate(steps) if t >= s)
            logits = self._step(toks[t], poss[t], frozen)
            nxt = torch.where(lasts[t] > 0, torch.argmax(logits, -1), nxt)
        return nxt
