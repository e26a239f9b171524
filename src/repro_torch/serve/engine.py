"""Continuous-batching LM serving engine (torch).

Mirrors ``repro/serve/engine.py``.  Slot model: the decode step runs a
FIXED [slots] batch every tick; each slot carries its own cache position
(the per-slot ``index`` vector, see ``models/layers.attention_decode``).
New requests are prefilled one at a time, left-padded into a prompt
bucket, and inserted into free slots between ticks, so admission never
stalls running streams.  Interactive requests jump the queue; one whose
admission timeout lapses is shed to the batch tier.

Where the reference's mechanics are JAX's, the port's are eager PyTorch:
  * no per-bucket ``jit``: a prefill is one ``lm_prefill`` call at the
    bucket's length;
  * the insert writes the prefill's cache into the slot of the engine's
    stacked caches in place (batch axis 1 of every ``[nB, slots, ...]``
    leaf, by layout), and ``lm_decode`` updates them in place, where the
    reference donates and rebuilds them (``docs/torch_lm.md``);
  * a tick reads its next tokens and the ``[slots]`` index vector back in
    one copy, where the reference reads each active slot's index on its
    own.

``splan=make_plan(cfg, mesh, decode_batch=slots)`` serves through a mesh
plan: every prefill and decode runs under it (the MoE's EP paths on a
mesh whose ``model`` axis divides the experts).  A held-once plan runs on
the mesh's one device, which must be the engine's.  Under a plan whose
positions own their shards the engine's device is the controller (one of
the mesh's devices): the parameters are placed by ``param_specs`` (a tree
already placed is kept), the slot caches are allocated as pieces by
``cache_specs``, a prefilled request is copied into the pieces that own
its slot (every copy of a replicated piece, and every position's copy of
the ``index`` vector), and a tick runs every position and reads back its
next tokens and the index in one copy, as the held-once engine does.  The
engine prefills one request at a time (B = 1), so an EP model's serving
mesh has ``data`` = 1.

The engine is per-pod and shares nothing but the process-global
``serve.queue_depth`` gauge, which the forest router reads.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (Mesh, P, Sharded, ShardingPlan,
                                       cache_specs, lm_device, make_plan,
                                       physical, shard_params, shard_tensor,
                                       zeros_sharded)
from repro_torch.models import lm as LM
from repro_torch.models import positions as PS
from repro_torch.train.tree import tree_map
from repro_torch.models.registry import get_bundle
from repro_torch.obs import METRICS, MetricsRegistry, TRACER
from repro_torch.serve.router import (QUEUE_DEPTH_METRIC, TIER_BATCH,
                                      TIER_INTERACTIVE)

__all__ = ["Request", "ServeEngine"]

Params = dict[str, Any]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # [P] int32
    max_new_tokens: int = 16
    eos_token: int = -1                # -1: never stop early
    priority: int = TIER_BATCH         # router tier (TIER_INTERACTIVE
    #                                    jumps the queue; the default
    #                                    matches submit()'s)
    submitted_at: float = 0.0
    timeout_s: float | None = None     # admission timeout: an interactive
    #                                    request still queued past this
    #                                    SHEDS to the batch tier instead
    #                                    of camping the queue front
    shed: bool = False                 # it happened
    # filled at completion:
    tokens: list[int] = dataclasses.field(default_factory=list)
    first_token_at: float = 0.0
    finished_at: float = 0.0


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _first_leaf(tree) -> torch.Tensor | None:
    if not isinstance(tree, dict):
        return tree
    for v in tree.values():
        leaf = _first_leaf(v)
        if leaf is not None:
            return leaf
    return None


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Params, *,
                 slots: int = 4, max_ctx: int = 256,
                 prompt_buckets: tuple[int, ...] = (32, 64, 128),
                 splan: ShardingPlan | None = None,
                 dtype=torch.bfloat16, device=None):
        if cfg.encoder_layers:
            raise ValueError("the engine serves decoder-only LMs")
        self.device = resolve_device(device)
        self.splan = splan or make_plan(cfg, None)
        self.own = self.splan.own_shards
        if self.own:
            if physical(self.device) not in \
                    self.splan.mesh.physical_devices():
                raise ValueError(f"the engine's device {self.device} is "
                                 f"none of the plan's mesh's")
            params = shard_params(params, self.splan)
        else:
            params_device = _first_leaf(params).device
            if physical(params_device) != physical(self.device):
                raise ValueError(f"params lie on {params_device}, the "
                                 f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_ctx = max_ctx
        self.buckets = tuple(b for b in prompt_buckets if b < max_ctx)
        if not self.own and isinstance(self.splan.mesh, Mesh) and \
                lm_device(self.splan.mesh) != physical(self.device):
            raise ValueError(f"the plan's mesh stands on "
                             f"{lm_device(self.splan.mesh)}, the engine "
                             f"runs on {self.device}")
        self.bundle = get_bundle(cfg)
        if self.own:
            self.caches = self._own_caches(dtype)
        else:
            self.caches = LM.init_caches(cfg, slots, max_ctx, dtype=dtype,
                                         device=self.device)
            self.caches["index"] = torch.zeros(slots, dtype=torch.int32,
                                               device=self.device)
        self._free = list(range(slots))
        self._active: dict[int, Request] = {}
        self._queue: deque[Request] = deque()
        self._done: list[Request] = []
        self._remaining = np.zeros(slots, np.int64)
        self._cur_tokens = torch.zeros((slots, 1), dtype=torch.int64,
                                       device=self.device)
        self._uid = 0
        self.ticks = 0
        self.shed_count = 0            # admission timeouts shed to batch
        # per-engine observability: the engine's own registry (one engine
        # per pod shares nothing); fixed-bucket latency histograms back the
        # p50/p99 fields of stats()
        self.metrics = MetricsRegistry()
        self._queue_wait_h = self.metrics.histogram("serve.queue_wait_s")
        self._e2e_h = self.metrics.histogram("serve.e2e_latency_s")

    def _own_caches(self, dtype) -> Params:
        """The slot caches as pieces by ``cache_specs``, each allocated on
        its position's device (K/V and the hybrid's ``shared`` K/V by
        ``decode_cache``, the SSD ``conv`` window by its rows, its f32
        ``state`` by ``ssm_state``), and the ``[slots]`` index
        replicated."""
        mesh = self.splan.mesh
        like = LM.init_caches(self.cfg, self.slots, self.max_ctx,
                              dtype=dtype, device="meta")
        like["index"] = torch.zeros(self.slots, dtype=torch.int32,
                                    device="meta")
        caches = tree_map(lambda spec, t: zeros_sharded(
            t.shape, t.dtype, mesh, spec), cache_specs(like, self.splan),
            like)
        caches["index"] = shard_tensor(
            torch.zeros(self.slots, dtype=torch.int32, device=self.device),
            mesh, P())
        return caches

    def _insert_own(self, cache1, slot: int, length: int) -> None:
        """``_insert_fn`` over pieces: each position that owns slot
        ``slot`` copies row 0 of its own piece of every leaf of the
        prefill's cache (K/V, the SSD conv window and state, the shared
        K/V; the same plan holds the same blocks of every other dimension,
        and a one-row batch is held whole at every data position)."""
        for name, small in cache1.items():
            if name == "index":
                continue
            for leaf, src in small.items():
                dst: Sharded = self.caches[name][leaf]
                if tuple(src.spec)[2:] != tuple(dst.spec)[2:] or \
                        src.parts(1) != 1:
                    raise ValueError(f"a prefill cache under {src.spec!r} "
                                     f"does not fit slots under "
                                     f"{dst.spec!r}")
                for pos, t in dst.pieces.items():
                    lo = dst.offset(pos, 1)
                    if lo <= slot < lo + t.shape[1]:
                        t[:, slot - lo].copy_(src.pieces[pos][:, 0])
        for t in self.caches["index"].pieces.values():
            t[slot] = length

    # ------------------------------------------------------------------
    def _prefill_fn(self, params, tokens):
        """One left-padded prompt batch -> (logits, caches at max_ctx)."""
        return LM.lm_prefill(self.cfg, params, tokens, splan=self.splan,
                             ctx=self.max_ctx)

    def _insert_fn(self, cache1, slot: int, length: int,
                   first_token: int) -> None:
        """Copy a batch-1 prefill cache into slot ``slot`` of the engine's
        caches, in place: every leaf (K/V, the SSD conv window and its f32
        state) is ``[nB, B, ...]``, so the batch axis is 1, and the slot's
        whole previous cache is overwritten."""
        if self.own:
            self._insert_own(cache1, slot, length)
            self._cur_tokens[slot, 0] = first_token
            return
        for name, small in cache1.items():
            if name == "index":
                continue
            for leaf, t in small.items():
                self.caches[name][leaf][:, slot].copy_(t[:, 0])
        self.caches["index"][slot] = length
        self._cur_tokens[slot, 0] = first_token

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, *, max_new_tokens: int = 16,
               eos_token: int = -1, priority: int = TIER_BATCH,
               timeout_s: float | None = None) -> int:
        """Queue a request.  ``timeout_s`` is the per-request admission
        timeout: an interactive (``TIER_INTERACTIVE``) request still
        waiting past it is SHED to the batch tier -- demoted to the queue
        back with ``shed=True`` -- rather than holding the queue front
        forever."""
        self._uid += 1
        req = Request(self._uid, np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, eos_token=eos_token,
                      priority=priority, submitted_at=time.perf_counter(),
                      timeout_s=timeout_s)
        # priority admission: interactive requests jump the queue
        if priority == TIER_INTERACTIVE:
            self._queue.appendleft(req)
        else:
            self._queue.append(req)
        self.metrics.counter("serve.requests").inc()
        # the process-global arrival-load gauge the forest router reads
        # (serve/router.live_queue_depth): inc on submit, dec on admit
        METRICS.counter(QUEUE_DEPTH_METRIC).inc()
        return req.uid

    def _shed_timed_out(self) -> None:
        """Admission-timeout ladder: demote interactive requests whose
        wait exceeded their ``timeout_s`` to the batch tier (queue back,
        ``shed`` flagged)."""
        now = time.perf_counter()
        kept, shed = [], []
        for req in self._queue:
            if (req.timeout_s is not None
                    and req.priority == TIER_INTERACTIVE
                    and now - req.submitted_at >= req.timeout_s):
                req.priority = TIER_BATCH
                req.shed = True
                shed.append(req)
            else:
                kept.append(req)
        if shed:
            self._queue = deque(kept + shed)
            self.shed_count += len(shed)
            self.metrics.counter("serve.shed").inc(len(shed))
            for req in shed:
                TRACER.event("serve.shed", uid=req.uid)

    def _admit_one(self, req: Request, slot: int) -> None:
        # admission ends the queue wait -- recorded whether or not the
        # request was shed on the way in
        self._queue_wait_h.record(time.perf_counter() - req.submitted_at)
        METRICS.counter(QUEUE_DEPTH_METRIC).inc(-1)
        with TRACER.span("serve.prefill", uid=req.uid, slot=slot,
                         shed=req.shed):
            P = len(req.prompt)
            b = _bucket(P, self.buckets) if self.buckets else P
            toks = np.zeros((1, b), np.int64)
            toks[0, b - P:] = req.prompt       # left-pad into the bucket
            logits, cache1 = self._prefill_fn(
                self.params, torch.from_numpy(toks).to(self.device))
            first = int(torch.argmax(logits[0]))
            self._insert_fn(cache1, slot, b, first)
        req.tokens.append(first)
        req.first_token_at = time.perf_counter()
        self._active[slot] = req
        self._remaining[slot] = req.max_new_tokens - 1

    def step(self) -> list[Request]:
        """One engine tick: admit into free slots, one decode step, collect
        finished requests.  Returns newly finished requests."""
        self._shed_timed_out()
        while self._free and self._queue:
            self._admit_one(self._queue.popleft(), self._free.pop())
        if not self._active:
            return []
        with TRACER.span("serve.execute", tick=self.ticks,
                         active=len(self._active)):
            logits, self.caches = self.bundle.decode(
                self.cfg, self.params, self.caches, self._cur_tokens,
                self.splan)
            nxt = torch.argmax(logits, dim=-1)
            self._cur_tokens = nxt[:, None]
            # the next tokens and the [slots] index vector, in one copy
            index = (PS.cache_index(self.caches, nxt.device) if self.own
                     else self.caches["index"])
            host = torch.cat([nxt, index.to(nxt.dtype)])
            host = host.cpu().numpy()
            nxt_np, idx_np = host[:self.slots], host[self.slots:]
        self.ticks += 1
        finished = []
        for slot, req in list(self._active.items()):
            if self._remaining[slot] <= 0:
                continue
            tok = int(nxt_np[slot])
            req.tokens.append(tok)
            self._remaining[slot] -= 1
            if self._remaining[slot] <= 0 or tok == req.eos_token \
                    or idx_np[slot] >= self.max_ctx - 1:
                req.finished_at = time.perf_counter()
                self._e2e_h.record(req.finished_at - req.submitted_at)
                finished.append(req)
                self._done.append(req)
                del self._active[slot]
                self._free.append(slot)
        return finished

    def run_until_drained(self, max_ticks: int = 10_000) -> list[Request]:
        t = 0
        while (self._queue or self._active) and t < max_ticks:
            self.step()
            t += 1
        return self._done

    # ------------------------------------------------------------------
    def stats(self) -> dict[str, float]:
        if not self._done:
            return {}
        lat = [r.finished_at - r.submitted_at for r in self._done]
        ttft = [r.first_token_at - r.submitted_at for r in self._done]
        toks = sum(len(r.tokens) for r in self._done)
        span = max(r.finished_at for r in self._done) - \
            min(r.submitted_at for r in self._done)
        return {
            "requests": len(self._done),
            "mean_latency_s": float(np.mean(lat)),
            "p95_latency_s": float(np.percentile(lat, 95)),
            "mean_ttft_s": float(np.mean(ttft)),
            "tokens": toks,
            "tokens_per_s": toks / max(span, 1e-9),
            "ticks": self.ticks,
            "shed": self.shed_count,
            # bucket-interpolated tails from the per-engine histograms:
            # queue wait is submit -> admission, e2e is submit -> last token
            "p50_queue_wait_s": self._queue_wait_h.percentile(50),
            "p99_queue_wait_s": self._queue_wait_h.percentile(99),
            "p50_latency_s": self._e2e_h.percentile(50),
            "p99_latency_s": self._e2e_h.percentile(99),
        }
