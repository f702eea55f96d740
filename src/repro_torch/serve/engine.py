"""Serving engine (port of the JAX package's `serve/engine.py`): batched
prefill + per-token decode over fixed lanes, optionally with bit-plane
weights, and the axis map of the decode cache's leaves that the continuous
batcher (`serve/scheduler.py`) resets and freezes lanes through.

Quantized serving swaps every GeMV-shaped leaf for packed `BitplaneWeights`
and routes the model's linears through `core.engine.EngineLinear`. On the
default (kernel) backend, each decode step runs:
  * q/k/v and up/gate as one fused launch per group (B2) when activations
    are quantized (`act_bits`), `wo`, `down` and `lm_head` per leaf (B1);
  * every linear through B3 when activations stay float (`act_bits=None`).

Decode (`generate`) is the JAX package's single-executable decode by
default (`scan=True`): the prefill runs eagerly, then the decode steps of
one power-of-two trip bucket run as ONE captured CUDA graph
(`serve.decode_graph.DecodeGraph`), one graph per (lanes, bucket), over an
engine-owned cache that the prefill's cache is copied into; on the CPU the
graph's body runs eagerly. A capture that fails raises. `scan=False` is
the per-token Python loop, kept as the oracle: both give the same tokens,
greedy and seeded sampling alike. Nothing on the decode path may copy from
the host or read to the host. Requests of different lengths share the
lanes through `serve.scheduler.ContinuousBatcher`.

Quantized serving is a RESIDENCY SESSION, as in the JAX package: at
startup every 2-D quantized weight leaf of the model is registered into
ONE `DramPool` (or, with `dimms > 1` or `spill_tier`, a `FabricPool` of
several DIMMs with a CXL spill tier), and the block's GeMV sequence is
compiled into a capacity `GemvProgram` (a `FabricProgram` of per-DIMM
parts on a fabric) whose fused wave schedule prices each decode tick on
the DDR4 model (`price_decode_step`, `decode_tick_cost_s`,
`decode_tick_energy_j`: the model's seconds and Joules, not the card's). A
model that does not fit falls back to program-less serving with a
`RuntimeWarning`. On the card, `decode_program.run_kernel` (one per DIMM
part) runs a whole decode block as one B2 launch.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional, Union

import torch

from ..core import backends
from ..core.bitplane import BitplaneWeights
from ..core.engine import (EngineLinear, FabricProgram, GemvProgram,
                           MVDRAMEngine)
from ..core.pud.fabric import FabricPool
from ..core.pud.residency import CapacityError
from ..core.quant import QuantSpec
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.model import Model
from ..parallel.sharding import logical_to_pspec
from .decode_graph import DecodeGraph, sample
from .quantize import quantize_params

# Independent linears of one block — they read the SAME input, so their
# tiles may share waves in the compiled decode program (q/k/v on the
# attention input, up/gate on the FFN input).
_CONCURRENT_LEAVES = (("wq", "wk", "wv"), ("up", "gate"),
                      ("shared_up", "shared_gate"))

#: the axes of each decode-cache leaf of one layer (the JAX package's
#: `_CACHE_AXES`); a leaf of the stacked layout ("first", "stages",
#: "shared", "trailing") has its stack axes in front of these
CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", None),
    "v": ("batch", "kv_seq", "kv_heads", None),
    "c_kv": ("batch", "kv_seq", None),
    "k_rope": ("batch", "kv_seq", None),
    "positions": ("batch", "kv_seq"),
    "conv": ("batch", None, "inner"),
    "ssm": ("batch", "inner", None, None),
    "k_scale": ("batch", "kv_seq", "kv_heads"),
    "v_scale": ("batch", "kv_seq", "kv_heads"),
}


def cache_leaves(cache, path=()):
    """Every leaf of a decode-cache tree as (path, leaf, lane axis, kv_seq
    axis or None), the axes counted behind the leaf's leading stack
    axes."""
    if isinstance(cache, dict):
        for k, v in cache.items():
            yield from cache_leaves(v, path + (k,))
        return
    axes = CACHE_AXES[path[-1]]
    lead = cache.ndim - len(axes)
    seq = lead + axes.index("kv_seq") if "kv_seq" in axes else None
    yield path, cache, lead + axes.index("batch"), seq


def cache_pspecs(cache, mesh=None, rules=None):
    """The `PartitionSpec` of every leaf of a decode-cache tree (tensors or
    anything with a `shape`): the leaf's `CACHE_AXES`, its leading stack
    dims unsharded."""
    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        axes = CACHE_AXES[path[-1]]
        full = ("stack",) * (len(tree.shape) - len(axes)) + axes
        return logical_to_pspec(full, tree.shape, mesh, rules)
    return walk(cache)


def make_serve_step(model: Model):
    """serve_step(params, cache, inp, pos) → (logits, cache): one decode
    step of `model` (the cache updated in place)."""
    def serve_step(params, cache, inp, pos):
        return model.decode_step(params, cache, inp, pos)
    return serve_step


@dataclasses.dataclass
class Request:
    tokens: list
    max_new: int
    done: bool = False


def params_to(params, device):
    """Move a parameter tree (tensors and BitplaneWeights) to `device`."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


class ServeEngine:
    """Greedy/temperature batched generation over fixed lanes."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int = 512,
                 batch_slots: int = 4, quantized: bool = False,
                 act_bits: Optional[int] = None, impl=None,
                 kv_bits: Optional[int] = None, device=None,
                 dimms: int = 1, spill_tier: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_seq = max_seq
        self.slots = batch_slots
        self.mvdram: Optional[MVDRAMEngine] = None
        # GemvProgram on a single pool, FabricProgram when dimms > 1 or
        # spill_tier — both price through the same surface
        self.decode_program: Optional[Union[GemvProgram,
                                            FabricProgram]] = None
        # True when the model did not fit the pool and serving fell back
        # to the program-less path
        self.placement_fallback = False
        self._tick_price_cache: dict = {}
        # the decode graphs by (lanes, trip bucket), the JAX package's
        # `_decode_fns`; their caches by lanes, and the model they are of
        self.decode_graphs: dict = {}
        self._decode_caches: dict = {}
        self._graphs_of: Optional[Model] = None
        self._graph_pool = None
        params = params_to(params, self.device)
        if cfg.tie_embeddings:
            # the tied head reads the whole table every step in the model's
            # dtype (the JAX package casts it per call): hold it so once;
            # its rows embed the tokens with the same values either way
            params = {**params,
                      "embed": params["embed"].to(getattr(torch, cfg.dtype))}
        model_impl = impl
        if quantized:
            params = quantize_params(params, cfg.weight_bits)
            # residency session: the whole model co-resides in one pool.
            # on_full="raise", so a model that outgrows the pool fails
            # placement VISIBLY (and falls back to program-less serving)
            # instead of LRU-evicting the layers just placed; with
            # spill_tier, placements that fit no module park in the CXL
            # capacity tier instead
            if dimms > 1 or spill_tier:
                self.mvdram = MVDRAMEngine(
                    pool=FabricPool(dimms=max(1, dimms)),
                    on_full="spill" if spill_tier else "raise")
            else:
                self.mvdram = MVDRAMEngine(on_full="raise")
            self.decode_program = self._place_model(params, act_bits)
            model_impl = EngineLinear(self.mvdram,
                                      backend=backends.get_backend(impl))
        self.params = params
        self.model = Model(cfg, act_bits=act_bits if quantized else None,
                           impl=model_impl, kv_bits=kv_bits)

    def _place_model(self, qparams, act_bits: Optional[int]
                     ) -> Optional[Union[GemvProgram, FabricProgram]]:
        """Register every quantized weight leaf into the engine's pool
        (the whole model becomes co-resident, heterogeneous shapes
        included) and compile the decode step's GeMV sequence into one
        fused program. Layer-stacked leaves unstack into one resident
        matrix per layer (views: no weight is copied); per-expert MoE
        stacks (w_up/w_gate/w_down) serve through the stacked expert path
        and stay un-pooled. Leaf names, decode order and groups are the
        JAX package's."""
        a_spec = QuantSpec(bits=act_bits) if act_bits else None
        leaves: list = []   # (stage_path, stack_idx, leaf_name, weights)

        def walk(tree, path=()):
            if isinstance(tree, dict):
                for k in tree:
                    walk(tree[k], path + (str(k),))
                return
            if not isinstance(tree, BitplaneWeights):
                return
            leaf = path[-1]
            if leaf in ("w_up", "w_gate", "w_down"):   # per-expert stacks
                return
            stage = "/".join(path[:-1])
            if tree.planes.ndim == 3:
                leaves.append((stage, -1, leaf, tree))
            elif tree.planes.ndim == 4:                # layer-stacked stage
                for i in range(tree.planes.shape[0]):
                    leaves.append((stage, i, leaf, tree[i]))

        walk(qparams)
        if not leaves:
            return None
        # decode order: layer-major (stage, stack index), leaves within
        leaves.sort(key=lambda e: (e[0], e[1]))
        names = []

        def place(pending):
            for stage, idx, leaf, bw in pending:
                name = f"{stage}/{leaf}" + (f"#{idx}" if idx >= 0 else "")
                self.mvdram.register_packed(name, bw, a_spec=a_spec)
                names.append(name)

        try:
            try:
                place(leaves)
            except CapacityError:
                # first-fit gaps may add up to the rows we need without a
                # contiguous run anywhere: defragment the pool and retry
                # the remaining placements once
                self.mvdram.pool.compact()
                place(leaves[len(names):])
        except CapacityError as e:
            # the model does not fit the pool: roll the partial residency
            # back and serve without a resident decode program
            self.placement_fallback = True
            for name in names:
                if self.mvdram.pool.is_resident(name):
                    self.mvdram.evict(name)
            warnings.warn(
                f"model does not fit the DramPool even after compaction "
                f"({len(names)}/{len(leaves)} linears placed before "
                f"capacity ran out); serving without a resident decode "
                f"program. {e}", RuntimeWarning, stacklevel=2)
            return None
        # concurrency groups: leaves of one (stage, layer) that read the
        # same input (q/k/v, up/gate) may share waves; the rest serializes
        groups, used = [], set()
        index = {(e[0], e[1], e[2]): i for i, e in enumerate(leaves)}
        for i, (stage, idx, leaf, _bw) in enumerate(leaves):
            if i in used:
                continue
            group = [i]
            for peers in _CONCURRENT_LEAVES:
                if leaf in peers:
                    group = [index[(stage, idx, p)] for p in peers
                             if (stage, idx, p) in index]
            used.update(group)
            groups.append(group)
        # CAPACITY program: every tick launches all `slots` lanes and the
        # scheduler's occupancy rides in as a lane mask
        return self.mvdram.compile(names, groups=groups, b_max=self.slots)

    def price_decode_step(self, bit_density: float = 0.5,
                          batch: Optional[int] = None) -> Optional[dict]:
        """DDR4-model price of one resident decode step through the
        compiled program (zero repeated weight staging), next to the
        per-layer re-staging baseline. None without a program."""
        if self.decode_program is None:
            return None
        cost = self.decode_program.price(bit_density=bit_density,
                                         batch=batch or self.slots)
        return cost.asdict()

    def decode_tick_cost_s(self, occupancy: int,
                           bit_density: float = 0.5) -> Optional[float]:
        """DDR4-model seconds of ONE decode tick of the resident program at
        the given lane occupancy — what the batcher's priced clock
        advances by per tick. Cached per occupancy (the price is a pure
        function of the compiled schedule and the lane count). None
        without a program."""
        if self.decode_program is None:
            return None
        if not isinstance(occupancy, int) or not \
                (1 <= occupancy <= self.slots):
            raise ValueError(
                f"occupancy must be an int in [1, {self.slots}] "
                f"(the compiled lane capacity), got {occupancy!r}")
        key = (occupancy, bit_density)
        if key not in self._tick_price_cache:
            cost = self.decode_program.price(bit_density=bit_density,
                                             batch=occupancy)
            self._tick_price_cache[key] = (cost.t_total, cost.e_total)
        return self._tick_price_cache[key][0]

    def decode_tick_energy_j(self, occupancy: int,
                             bit_density: float = 0.5) -> Optional[float]:
        """DDR4-model Joules of ONE decode tick at the given lane occupancy
        — the per-command `EnergyModel` twin of `decode_tick_cost_s`,
        sharing its cache. None without a program."""
        if self.decode_tick_cost_s(occupancy, bit_density) is None:
            return None
        return self._tick_price_cache[(occupancy, bit_density)][1]

    def residency_stats(self) -> Optional[dict]:
        """The engine's pool counters plus the serving-level flags:
        `placement_fallback` (the model did not fit the pool and serves
        program-less) and `resident_program` (a compiled decode program
        is live). None for unquantized engines."""
        if self.mvdram is None:
            return None
        stats = self.mvdram.residency_stats()
        stats["placement_fallback"] = self.placement_fallback
        stats["resident_program"] = self.decode_program is not None
        return stats

    def _decode_graph(self, b: int, trip: int) -> DecodeGraph:
        """The decode graph of `b` lanes and `trip` steps, captured on
        first use over the engine's cache for `b` lanes (kept for the
        engine's life). A model swapped in after a capture gets graphs of
        its own."""
        if self._graphs_of is not self.model:
            self.decode_graphs.clear()
            self._decode_caches.clear()
            self._graphs_of = self.model
        graph = self.decode_graphs.get((b, trip))
        if graph is None:
            if b not in self._decode_caches:
                self._decode_caches[b] = self.model.init_cache(
                    b, self.max_seq, self.device)
            if self.device.type == "cuda" and self._graph_pool is None:
                # the engine's graphs never replay at once: one pool
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = DecodeGraph(self.model, self.params,
                                self._decode_caches[b], b, trip,
                                pool=self._graph_pool)
            self.decode_graphs[(b, trip)] = graph
        return graph

    @torch.no_grad()
    def generate(self, prompts, max_new: int = 32, temperature: float = 0.0,
                 seed: int = 0, scan: bool = True,
                 max_new_per_lane=None) -> torch.Tensor:
        """prompts: int (B, S0), B ≤ slots, equal-length prompts (requests
        of different lengths go through `serve.scheduler.ContinuousBatcher`,
        which shares the lanes between them). Returns
        (B, S0 + max_new) tokens.

        `scan=True` (the default) runs the decode steps as one captured
        CUDA graph of trip min(max_seq − S0 − 1, the power of two ≥
        max_new − 1) steps, whose steps past max_new − 1 run frozen and
        are dropped (on the CPU, the graph's body eagerly, up to the last
        kept step); a capture that fails raises. `scan=False` is the
        per-token loop, the oracle: the same tokens, greedy and with
        `temperature` > 0 on the same `seed`. `max_new_per_lane` (optional
        (B,) ints ≤ max_new) caps lanes individually: a lane past its
        budget re-emits its last token (a 0-budget lane its final prompt
        token)."""
        prompts = torch.as_tensor(prompts, device=self.device).long()
        b, s0 = prompts.shape
        if b > self.slots:
            raise ValueError(
                f"prompts batch {b} exceeds the engine's {self.slots} "
                f"lanes (prompts shape {tuple(prompts.shape)})")
        if s0 + max_new > self.max_seq:
            raise ValueError(
                f"prompt ({s0}) + max_new ({max_new}) exceeds the cache "
                f"horizon max_seq={self.max_seq}")
        steps_vec = torch.full((b,), max_new - 1, device=self.device)
        budget = None
        if max_new_per_lane is not None:
            budget = torch.as_tensor(max_new_per_lane, device=self.device)
            steps_vec = torch.minimum(budget - 1, steps_vec)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        logits, cache = self.model.prefill(self.params, {"tokens": prompts},
                                           self.max_seq)
        cur = sample(logits, temperature, gen)
        if budget is not None:
            cur = torch.where(budget > 0, cur, prompts[:, -1])
        if scan and max_new > 1:
            # the power-of-two trip bucket, capped at the cache horizon, as
            # the JAX package's executables: a bounded set of graphs
            trip = min(self.max_seq - s0 - 1,
                       1 << (max_new - 2).bit_length())
            rest = self._decode_graph(b, trip).run(
                cache, cur, s0, steps_vec, temperature,
                gen if temperature > 0.0 else None, kept=max_new - 1)
            return torch.cat([prompts, cur[:, None],
                              rest[:max_new - 1].T], dim=1)
        toks = [prompts]
        for t in range(max_new):
            toks.append(cur[:, None])
            if t == max_new - 1:
                break
            logits, cache = self.model.decode_step(self.params, cache, cur,
                                                   s0 + t)
            cur = torch.where(t < steps_vec,
                              sample(logits, temperature, gen), cur)
        return torch.cat(toks, dim=1)

    def throughput_tokens_per_s(self, b: int = 1, n: int = 16) -> float:
        """Measured decode tokens/s on this engine's device: b·n generated
        tokens over the wall time of `generate` on its default path
        (prefill included, and the frozen steps of the trip bucket past
        n − 1), after a warm-up call that captures the bucket's graph,
        synchronised on CUDA."""
        prompts = torch.zeros((b, 8), dtype=torch.long, device=self.device)
        self.generate(prompts, max_new=n)
        self._sync()
        t0 = time.perf_counter()
        self.generate(prompts, max_new=n)
        self._sync()
        return b * n / (time.perf_counter() - t0)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
