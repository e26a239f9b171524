"""Cost-based query optimizer: plan, algorithm and tier chosen per query
(torch).

Mirrors ``repro/db/optimizer.py``.  The paper's central finding is that the
best configuration -- UDF-centric or relation-centric plan, algorithm,
placement -- flips with model scale x data scale.
``ForestQueryEngine.infer(plan="auto", algorithm="auto")``,
``infer_rows(..., "auto")`` and the serving plane's ``register_model(...,
"auto")`` all route through ``CostBasedOptimizer``, in three phases:

  lookup     decisions persist in the store's decision catalog keyed by
             (model fingerprint, dataset name, dataset signature, mesh
             signature, candidate sets); a repeat is a dictionary lookup.
             Swept like compiled plans: ``engine.invalidate(model_id)``,
             ``store.drop`` / a re-``put`` of the dataset.
  score      every feasible (algorithm x plan x tier) cell gets an analytic
             roofline cost: closed-form FLOP / byte counts per algorithm
             (``_forest_flop_bytes``, the reference's, verbatim) through
             ``launch/roofline.roofline_terms`` with the peaks CALIBRATED on
             the store's device (``launch/roofline.resolve_peaks``).
  autotune   cells within ``uncertainty_band`` of the best are measured: a
             warm run each, then interleaved timed rounds (min of
             ``probe_iters``), then a hillclimb of the winner's ``n_parts``
             / ``batch_pages`` while the budget lasts.  At most once per
             decision key (``optimizer.autotune_runs``).

The candidate set depends on the device.  On a CPU store it is the
reference's ``DEFAULT_ALGORITHMS`` (the eager algorithms).  On a CUDA store
it is the six hand-written kernels, ``CUDA_ALGORITHMS`` (with the two plans,
12 cells): the reference leaves its Pallas kernels out only because they
run in interpret mode off the TPU, and on the card the eager versions must
never be on the main path.  An explicit ``algorithms=`` or a pinned axis
still wins.  An entry point whose caller named no algorithm passes
``algorithms_for(None)``: the reference's default argument pins
``"predicated"`` there, which a CPU store keeps, and a CUDA store leaves
the axis free, so ``infer(ds, forest, plan="auto")`` chooses a kernel.

The analytic model is the reference's jnp algorithms' (it counts, for
example, HummingBird's ``[B, T, L]`` product that the fused kernel never
materializes); the 16x uncertainty band sends close cells to measurement.
A probe's wall is the host clock around ``_infer`` / ``infer_rows``, whose
stages end in a device synchronise, so it covers the kernels.

Tier placement is scored (an off-device dataset that fits the device budget
is also costed on the device tier) and the best rung is ADVICE on
``Decision.tier``; ``infer(..., auto_move=True)`` applies it.  The result of
an off-device scan lands in pinned host memory in the port (ROADMAP section
3, item 3): ``rows x 4`` bytes of D2H a query on every off-device rung
alike, so it is left out of the cost as the reference leaves it out.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Sequence

import numpy as np

from repro_torch.db.executor import DEFAULT_STREAM_BATCH_BYTES
from repro_torch.kernels.ops import (FUSED_KERNEL_ALGORITHMS,
                                     KERNEL_ALGORITHMS)
from repro_torch.launch.roofline import resolve_peaks, roofline_terms
from repro_torch.obs import METRICS, TRACER

__all__ = ["Decision", "CostBasedOptimizer", "dataset_signature",
           "DEFAULT_ALGORITHM", "DEFAULT_ALGORITHMS", "CUDA_ALGORITHMS",
           "DEFAULT_PLANS", "ROW_DECISION_DATASET"]

#: the algorithm an entry point runs when its caller names none
DEFAULT_ALGORITHM = "predicated"

#: candidate algorithms on a CPU store: the reference's three eager ones
DEFAULT_ALGORITHMS = ("predicated", "hummingbird", "quickscorer")

#: candidate algorithms on a CUDA store: the six hand-written kernels
CUDA_ALGORITHMS = tuple(FUSED_KERNEL_ALGORITHMS) + tuple(KERNEL_ALGORITHMS)

#: candidate plans: the bare ``rel`` re-partitions the model every query (the
#: paper's uncached baseline), so it never wins steady state
DEFAULT_PLANS = ("udf", "rel+reuse")

#: the dataset slot of row-batch (serving-plane) decisions; "#" never names
#: a stored dataset, so dataset sweeps never touch them
ROW_DECISION_DATASET = "#rows"


def dataset_signature(ds) -> tuple:
    """The dataset facts a decision is conditioned on: rows, width, storage
    format, tier and page layout.  Any change gives a new key."""
    return (int(ds.num_rows), int(ds.num_features),
            getattr(ds, "storage_format", "dense"),
            getattr(ds, "tier", "device"),
            int(ds.page_rows), int(ds.num_pages))


@dataclasses.dataclass(frozen=True)
class Decision:
    """One persisted optimizer verdict: the winning execution cell."""

    algorithm: str
    plan: str                     # "udf" | "rel+reuse"
    tier: str                     # recommended scan tier (advice, applied
    #                               only under ``infer(..., auto_move=True)``)
    n_parts: int | None           # rel tree partitions (None: the default)
    batch_pages: int | None       # scan batch (None: the default)
    predicted_s: float            # analytic roofline estimate of the cell
    measured_s: float | None      # autotune probe wall (None: model-trusted)
    source: str                   # "measured" | "model"
    cells_scored: int = 0         # analytic candidates enumerated
    cells_measured: int = 0       # probes the autotune pass paid

    def overrides(self) -> dict[str, Any]:
        """Keywords of ``engine._infer`` that execute this decision."""
        return dict(algorithm=self.algorithm, plan=self.plan,
                    n_parts=self.n_parts, batch_pages=self.batch_pages)


@dataclasses.dataclass
class _Cell:
    """A feasible configuration under scoring."""
    algorithm: str
    plan: str
    tier: str
    n_parts: int | None = None
    batch_pages: int | None = None
    predicted_s: float = float("inf")
    measured_s: float | None = None


def _forest_flop_bytes(algorithm: str, *, rows: int, trees: int,
                       depth: int, f_used: int) -> tuple[float, float, float]:
    """Closed-form (flops, stream_bytes, gather_bytes) of one algorithm
    over ``rows`` samples, the reference's model verbatim: dot FLOPs are
    ``2·result·K``, elementwise ops one FLOP per output element, bytes
    per-boundary operand + result traffic (f32), loop trip counts multiply.
    Gather traffic is returned apart: its bandwidth is calibrated apart."""
    B, T, d = float(rows), float(trees), float(depth)
    I = float(2 ** depth - 1)         # internal nodes (complete tree)
    L = float(2 ** depth)             # leaves
    W = float(-(-int(L) // 32))       # quickscorer uint32 mask words
    if algorithm.startswith("predicated") or algorithm.startswith("compiled"):
        # per level: 3 node-table gathers + take_along_axis on x [B,T],
        # compare + index update (~6 elementwise ops on [B,T])
        flops = d * B * T * 6.0
        gather_bytes = d * B * T * 4.0 * 4.0          # f/thr/dl/xv lookups
        stream_bytes = d * B * T * 4.0 * 2.0          # idx read+write
        flops += B * T * 2.0                          # leaf gather + sum
        gather_bytes += B * T * 4.0
    elif algorithm.startswith("hummingbird"):
        # S = predicates [B,T,I]; S @ C -> [B,T,L] (2·B·T·L·I flops);
        # one-hot count-match [B,T,L]; onehot ⊙ leaf -> [B] (2·B·T·L)
        flops = 2.0 * B * T * L * I + B * T * I * 4.0 + B * T * L * 3.0
        gather_bytes = B * T * I * 4.0                # xv feature gather
        stream_bytes = B * T * (I * 3.0 + L * 4.0) * 4.0
    elif algorithm.startswith("quickscorer"):
        # all-node predicates [B,T,I], mask AND-reduce over [B,T,I,W]
        # words, lowest-surviving-bit leaf pick [B,T,W]
        flops = B * T * I * (4.0 + 2.0 * W) + B * T * W * 3.0
        gather_bytes = B * T * I * 4.0
        stream_bytes = (B * T * I * W + B * T * (I + W) * 2.0) * 4.0
    elif algorithm.startswith("naive"):
        # while_loop per (sample, tree): ~depth iterations, serial gathers
        flops = d * B * T * 8.0
        gather_bytes = d * B * T * 4.0 * 5.0
        stream_bytes = d * B * T * 4.0
    else:                             # unknown / kernel variant: model as
        flops = d * B * T * 6.0       # predicated-shaped work
        gather_bytes = d * B * T * 16.0
        stream_bytes = d * B * T * 8.0
    return flops, stream_bytes, gather_bytes


class CostBasedOptimizer:
    """Scores, measures and caches (algorithm x plan x tier x blocks)
    decisions for a ``ForestQueryEngine`` (module note).  ``algorithms``
    None takes the store device's candidate set."""

    def __init__(self, engine, *,
                 algorithms: Sequence[str] | None = None,
                 plans: Sequence[str] = DEFAULT_PLANS,
                 measure_budget_s: float = 4.0,
                 max_measurements: int = 12,
                 uncertainty_band: float = 16.0,
                 probe_iters: int = 3,
                 hillclimb: bool = True):
        # weak: the engine owns its optimizer, and a strong back-reference
        # would keep dead engines' store hooks alive until a gc pass
        self._engine = weakref.ref(engine)
        if algorithms is None:
            algorithms = CUDA_ALGORITHMS \
                if engine.store.device.type == "cuda" else DEFAULT_ALGORITHMS
        self.algorithms = tuple(algorithms)
        self.plans = tuple(plans)
        self.measure_budget_s = measure_budget_s
        self.max_measurements = max_measurements
        self.uncertainty_band = uncertainty_band
        self.probe_iters = probe_iters
        self.hillclimb = hillclimb

    def algorithms_for(self, algorithm: str | None
                       ) -> tuple[str, ...] | None:
        """The ``algorithms=`` an entry point's ``algorithm`` argument
        pins: None (this optimizer's candidates) for ``"auto"``, the name
        for a named one, and for None (the caller named none)
        ``DEFAULT_ALGORITHM`` on a CPU store, as the reference's default
        argument pins it, but nothing on a CUDA store (module note)."""
        if algorithm == "auto":
            return None
        if algorithm is None:
            if self.engine.store.device.type == "cuda":
                return None
            algorithm = DEFAULT_ALGORITHM
        return (algorithm,)

    @property
    def engine(self):
        eng = self._engine()
        if eng is None:
            raise ReferenceError("optimizer outlived its query engine")
        return eng

    # -- analytic roofline scoring -----------------------------------------
    def score_cell(self, cell: _Cell, *, rows: int, trees: int, depth: int,
                   f_used: int, data_nbytes: int, num_pages: int,
                   page_rows: int, peaks: dict) -> float:
        """Analytic seconds for one cell over the whole dataset scan."""
        flops, stream_b, gather_b = _forest_flop_bytes(
            cell.algorithm, rows=rows, trees=trees, depth=depth,
            f_used=f_used)
        # gather traffic at its own calibrated bandwidth, folded into the
        # single memory term as equivalent streaming bytes
        gather_bw = peaks.get("gather_bandwidth", peaks["hbm_bandwidth"])
        eq_bytes = stream_b + gather_b * (peaks["hbm_bandwidth"] / gather_bw)
        # rel plans materialize [n_parts, B] partials at a stage boundary
        # and fold them; udf keeps everything in one stage
        n_parts = cell.n_parts or 1
        if cell.plan.startswith("rel"):
            eq_bytes += 3.0 * 4.0 * n_parts * rows    # write+read+fold
        # on a model mesh the rel plans fold the model-axis partials: one
        # f32 a row crosses the axis (the reference's psum term)
        coll = 0.0
        fplan = getattr(self.engine, "fplan", None)
        if fplan is not None and fplan.model_axis is not None \
                and cell.plan.startswith("rel"):
            coll = 4.0 * rows
        terms = roofline_terms(flops_per_chip=flops,
                               bytes_per_chip=eq_bytes,
                               coll_bytes_per_chip=coll, peak=peaks)
        cost = terms["step_s_lower_bound"]
        # tier transfer: an off-device scan streams every byte through the
        # host -> device link once a query (disk also pays the file read,
        # modeled at half the link rate)
        h2d = peaks.get("h2d_bandwidth", peaks["hbm_bandwidth"])
        if cell.tier == "host":
            cost += data_nbytes / h2d
        elif cell.tier == "disk":
            cost += data_nbytes / h2d + data_nbytes / (h2d / 2.0)
        # dispatch overhead: one a stage a batch (udf: 1 stage; rel:
        # cross-product + aggregate + postprocess)
        dispatch = peaks.get("dispatch_s", 5e-6)
        bp = cell.batch_pages or num_pages
        n_batches = max(1, -(-num_pages // max(bp, 1)))
        stages = 1 if cell.plan == "udf" else 3
        cost += dispatch * n_batches * stages
        return cost

    def _enumerate(self, *, tier: str, fits_device: bool,
                   algorithms: Sequence[str], plans: Sequence[str],
                   ) -> list[_Cell]:
        tiers = [tier]
        if tier != "device" and fits_device:
            tiers.append("device")    # promotion candidate (advice)
        return [_Cell(algorithm=a, plan=p, tier=t)
                for t in tiers for a in algorithms for p in plans]

    def scored_cells(self, dataset: str, forest, *,
                     algorithms: Sequence[str] | None = None,
                     plans: Sequence[str] | None = None) -> list[_Cell]:
        """Every feasible cell of a scan of ``dataset``, scored and sorted
        cheapest first (what ``decide`` ranks)."""
        eng = self.engine
        store = eng.store
        ds = store.get(dataset)
        budget = store.device_budget_bytes
        fits = budget is None or store.device_nbytes + ds.nbytes <= budget
        cells = self._enumerate(
            tier=dataset_signature(ds)[3], fits_device=fits,
            algorithms=tuple(algorithms or self.algorithms),
            plans=tuple(plans or self.plans))
        kw = dict(rows=int(ds.num_pages) * int(ds.page_rows),
                  trees=int(forest.num_trees), depth=int(forest.depth),
                  f_used=int(forest.n_features), data_nbytes=int(ds.nbytes),
                  num_pages=int(ds.num_pages), page_rows=int(ds.page_rows),
                  peaks=resolve_peaks(store.device))
        for c in cells:
            if c.plan.startswith("rel"):
                c.n_parts = eng._resolve_n_parts(forest, c.algorithm, None)
            c.predicted_s = self.score_cell(c, **kw)
        cells.sort(key=lambda c: c.predicted_s)
        return cells

    # -- measurement probes ---------------------------------------------------
    def _probe(self, run, budget_left: float) -> float | None:
        """Warm once, then min-of-``probe_iters`` timed runs; None when the
        budget is already spent."""
        if budget_left <= 0:
            return None
        run()                          # warm: build and cache the plan
        best = float("inf")
        for _ in range(max(1, self.probe_iters)):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        METRICS.counter("optimizer.measurements").inc()
        return best

    def _autotune(self, cells: list[_Cell], make_runner,
                  neighbors) -> tuple[_Cell, int]:
        """Measure-and-refine pass over the uncertain ``cells`` (sorted
        best-analytic-first).  ``make_runner(cell)`` returns a zero-arg
        callable executing the cell; ``neighbors(cell)`` yields hillclimb
        variants of the winner.  Returns (winner, probes)."""
        METRICS.counter("optimizer.autotune_runs").inc()
        t0 = time.perf_counter()
        measured = 0
        with TRACER.span("optimizer.autotune", candidates=len(cells)):
            live: list[tuple[_Cell, Any]] = []
            for cell in cells:
                if measured >= self.max_measurements:
                    break
                left = self.measure_budget_s - (time.perf_counter() - t0)
                # always measure at least the top two: a budget too small
                # to compare anything would degrade to the model's ranking
                if measured >= 2 and left <= 0:
                    break
                run = make_runner(cell)
                run()                  # warm: build and cache the plan
                live.append((cell, run))
                measured += 1
                METRICS.counter("optimizer.measurements").inc()
            # timed runs interleaved across cells round-robin, so that a
            # transient load spike lands on every candidate alike; at least
            # one full round even past the budget
            for round_ in range(max(1, self.probe_iters)):
                if round_ > 0 and time.perf_counter() - t0 \
                        >= self.measure_budget_s:
                    break
                for cell, run in live:
                    t1 = time.perf_counter()
                    run()
                    dt = time.perf_counter() - t1
                    if cell.measured_s is None or dt < cell.measured_s:
                        cell.measured_s = dt
            done = [c for c in cells if c.measured_s is not None]
            best = min(done, key=lambda c: c.measured_s) if done \
                else cells[0]
            # hillclimb the winner's block sizes while budget remains
            if self.hillclimb and done:
                improved = True
                while improved:
                    improved = False
                    for cand in neighbors(best):
                        left = self.measure_budget_s - \
                            (time.perf_counter() - t0)
                        if left <= 0 or measured >= self.max_measurements:
                            break
                        got = self._probe(make_runner(cand), left)
                        if got is None:
                            break
                        cand.measured_s = got
                        measured += 1
                        if got < best.measured_s:
                            best, improved = cand, True
        return best, measured

    def _persist(self, key: tuple, dataset: str, decision: Decision
                 ) -> Decision:
        self.engine.store.put_decision(key, decision)
        METRICS.counter("optimizer.decisions").inc()
        TRACER.event("optimizer.decision", dataset=dataset,
                     algorithm=decision.algorithm, plan=decision.plan,
                     tier=decision.tier, source=decision.source)
        return decision

    @staticmethod
    def _verdict(best: _Cell, *, tier: str, batch_pages: int | None,
                 cells_scored: int, measured: int) -> Decision:
        return Decision(
            algorithm=best.algorithm, plan=best.plan, tier=tier,
            n_parts=best.n_parts, batch_pages=batch_pages,
            predicted_s=best.predicted_s, measured_s=best.measured_s,
            source="measured" if best.measured_s is not None else "model",
            cells_scored=cells_scored, cells_measured=measured)

    # -- dataset-scan decisions (ForestQueryEngine.infer) -------------------
    def decide(self, dataset: str, forest, *, model_id: str | None = None,
               algorithms: Sequence[str] | None = None,
               plans: Sequence[str] | None = None) -> Decision:
        """The decision for a full scan of ``dataset``: a catalog lookup
        after the first call per key, which pays the score and autotune
        passes."""
        eng = self.engine
        store = eng.store
        ds = store.get(dataset)
        sig = dataset_signature(ds)
        mid = eng._model_key(forest, model_id)
        # the candidate sets are part of the key: a decision under a pinned
        # axis must never be served for the unconstrained auto query
        algorithms = tuple(algorithms or self.algorithms)
        plans = tuple(plans or self.plans)
        key = (mid, dataset, sig, eng.mesh_id, algorithms, plans)
        hit = store.get_decision(key)
        if hit is not None:
            METRICS.counter("optimizer.decision_cache_hits").inc()
            return hit
        METRICS.counter("optimizer.decision_cache_misses").inc()
        with TRACER.span("optimizer.decide", dataset=dataset,
                         model=mid[:12]) as sp:
            cells = self.scored_cells(dataset, forest, algorithms=algorithms,
                                      plans=plans)
            # the executable winner runs on the CURRENT tier; other rungs
            # are scored for the tier advice only
            here = [c for c in cells if c.tier == sig[3]]
            uncertain = [c for c in here if c.predicted_s
                         <= here[0].predicted_s * self.uncertainty_band]

            def make_runner(cell: _Cell):
                return lambda: eng._infer(
                    dataset, forest, model_id=model_id,
                    algorithm=cell.algorithm, plan=cell.plan,
                    n_parts=cell.n_parts, batch_pages=cell.batch_pages)

            def neighbors(cell: _Cell):
                out = []
                # a model mesh fixes n_parts to its axis: nothing to climb
                if cell.plan.startswith("rel") and cell.n_parts \
                        and eng.fplan.model_axis is None:
                    for np_ in (max(1, cell.n_parts // 2),
                                min(int(forest.num_trees),
                                    cell.n_parts * 2)):
                        if np_ != cell.n_parts:
                            out.append(dataclasses.replace(
                                cell, n_parts=np_, measured_s=None))
                if sig[3] != "device":
                    bp = cell.batch_pages or self._default_batch_pages(ds)
                    for bp_ in (max(1, bp // 2),
                                min(int(ds.num_pages), bp * 2)):
                        if bp_ != bp:
                            out.append(dataclasses.replace(
                                cell, batch_pages=bp_, measured_s=None))
                return out

            measured = 0
            if len(uncertain) > 1:
                best, measured = self._autotune(uncertain, make_runner,
                                                neighbors)
            else:
                best = here[0]
            decision = self._verdict(
                best, tier=cells[0].tier,     # best overall rung = advice
                batch_pages=best.batch_pages, cells_scored=len(cells),
                measured=measured)
            sp.set(algorithm=decision.algorithm, plan=decision.plan,
                   source=decision.source, measured=measured)
        return self._persist(key, dataset, decision)

    def _default_batch_pages(self, ds) -> int:
        """The engine's off-device default batch (half the device budget
        in pages): the hillclimb's starting point."""
        budget = self.engine.store.device_budget_bytes
        target = budget // 2 if budget else DEFAULT_STREAM_BATCH_BYTES
        return min(int(ds.num_pages),
                   max(1, target // max(int(ds.page_nbytes), 1)))

    # -- row-batch decisions (the serving plane's register_model) -----------
    def decide_rows(self, forest, batch_rows: int, *,
                    model_id: str | None = None,
                    algorithms: Sequence[str] | None = None,
                    plans: Sequence[str] | None = None) -> Decision:
        """The decision for padded row batches of ``batch_rows``: the same
        score -> autotune -> persist pipeline, probed through
        ``engine.infer_rows``, keyed under the ``"#rows"`` sentinel (dataset
        sweeps never touch it; ``engine.invalidate(model_id)`` does)."""
        eng = self.engine
        store = eng.store
        mid = eng._model_key(forest, model_id)
        B, F = int(batch_rows), int(forest.n_features)
        algorithms = tuple(algorithms or self.algorithms)
        plans = tuple(p for p in (plans or self.plans)
                      if p in ("udf", "rel+reuse"))
        key = (mid, ROW_DECISION_DATASET, (B, F), eng.mesh_id, algorithms,
               plans)
        hit = store.get_decision(key)
        if hit is not None:
            METRICS.counter("optimizer.decision_cache_hits").inc()
            return hit
        METRICS.counter("optimizer.decision_cache_misses").inc()
        with TRACER.span("optimizer.decide", dataset=ROW_DECISION_DATASET,
                         model=mid[:12]) as sp:
            peaks = resolve_peaks(store.device)
            cells = [_Cell(algorithm=a, plan=p, tier="device")
                     for a in algorithms for p in plans]
            for c in cells:
                if c.plan.startswith("rel"):
                    c.n_parts = eng._resolve_n_parts(forest, c.algorithm,
                                                     None)
                c.predicted_s = self.score_cell(
                    c, rows=B, trees=int(forest.num_trees),
                    depth=int(forest.depth), f_used=F,
                    data_nbytes=B * F * 4, num_pages=1, page_rows=B,
                    peaks=peaks)
            cells.sort(key=lambda c: c.predicted_s)
            uncertain = [c for c in cells if c.predicted_s
                         <= cells[0].predicted_s * self.uncertainty_band]
            x = np.zeros((B, F), np.float32)

            def make_runner(cell: _Cell):
                return lambda: eng.infer_rows(
                    forest, x, algorithm=cell.algorithm, plan=cell.plan,
                    model_id=mid, n_parts=cell.n_parts)

            measured = 0
            if len(uncertain) > 1:
                best, measured = self._autotune(uncertain, make_runner,
                                                lambda c: [])
            else:
                best = cells[0]
            decision = self._verdict(best, tier="device", batch_pages=None,
                                     cells_scored=len(cells),
                                     measured=measured)
            sp.set(algorithm=decision.algorithm, plan=decision.plan,
                   source=decision.source, measured=measured)
        return self._persist(key, ROW_DECISION_DATASET, decision)
