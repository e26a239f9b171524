"""Physical query plans for in-database forest inference (torch).

Mirrors the single-device template of ``repro/db/query.py`` over a dense,
device-tier dataset: three plans over the same logical query

    SCAN -> PREDICT -> AGGREGATE -> WRITE          (Sec. 3.2/3.3, Fig. 3)

  udf        UDF-centric: the whole forest inside one transform UDF.
             Compiles to ONE stage.
  rel        Relation-centric: CROSS-PRODUCT(tree partitions x sample
             block) -> aggregate -> postprocess/write, after a
             model-partitioning stage: FOUR stages.  Deliberately uncached
             (the paper's no-reuse baseline).
  rel+reuse  netsDB-OPT: the partition stage's output is materialized in
             the model cache and reused across queries on the same model,
             so a steady-state query runs only the three data stages.

The cross product is one kernel launch per tree partition (``n_parts``
defaults to one partition per kernel tree tile, ``_resolve_n_parts``).
A fused algorithm (``*_pallas_fused``) gives [B] per partition; a raw one
(``*_pallas``) gives [B, per] that ``aggregate_raw`` folds at once, so
the [B, T] matrix never exists whole.  The aggregate stage folds the
[n_parts, B] partials sequentially in partition order, as the reference
does.  The plain algorithms (``predicated``, ...) run the eager torch
oracles.

Compiled-plan cache: a plan's stage list is built once and reused
(``plan_reuse_hit``).  Plan keys carry the model id at key[1]
(``invalidate``) and the dataset at key[2] (``store.drop`` ->
``invalidate_dataset``); row plans (``infer_rows``, the serving plane's
entry point) put the ``"#rows"`` sentinel at key[2], so dropping a
dataset never sweeps them.  ``rel+reuse`` plan keys also carry
``id(mat)``, and the entry pins that materialization.

Every plan runs over a dataset on any tier of the store: the tier is a
property of the scan (``db/executor.py``), not of the plan, so plans and
their cache keys are the same on every tier and stay valid across
``store.move``.  A scan over a host- or disk-tier table streams it in
batches (by default half the store's ``device_budget_bytes`` each, or
``DEFAULT_STREAM_BATCH_BYTES`` with no budget) and returns its predictions
in host memory.

The sparse plane: over a CSR dataset (``store.put_sparse``) every plan
runs the same kernels on a compact tile.  At plan build (udf) or in the
model-partition stage (rel plans) ``_sparse_prepass`` compacts the forest
onto its used features and builds the gather's inverse map, once; each
batch's page block then goes through the ``gather:csr-compact`` operator
(``kernels/gather.py``), which is not a breaker: it shares the udf stage
or the rel plan's cross-product stage.  Compaction keeps thresholds,
leaves and tree order, so CSR predictions equal the dense plane's bit for
bit.  The storage format is part of every plan and model key, and a CSR
batch signature also pins the page capacity.  ``infer_rows`` scores dense
rows only, as in the reference.

Tracing (``repro_torch.obs``; reference ``query.py:569-592``): ``infer``
is the observability boundary.  With ``TRACER`` enabled the query runs
under a ``query.infer`` root span and ``QueryResult.trace`` carries its
``TraceSummary`` (span counts, per-name seconds, the ``METRICS`` counter
deltas); disabled, ``infer`` is a tail call to ``_infer``.  Inside:
``plan.build`` when a cached plan is built, ``plan.partition`` when a model
is partitioned, ``query.write`` for ``write_as``, and at every
compiled-plan cache lookup (udf and rel+reuse queries, both ``infer_rows``
plans) a ``plan.cache`` event and one of ``plan.cache_hits`` /
``plan.cache_misses``; the bare ``rel`` plan consults no cache.
``infer_rows`` runs under a ``query.infer_rows`` span.

Faults (``db/faults.py``, reference ``query.py:757-983``): ``infer``'s
``injector`` / ``retry_policy`` arm the scan's five sites, and
``deadline_s`` budgets the whole query from its start; a query that runs
out of budget returns a PARTIAL result whose ``degraded`` report holds the
rows scored and missing and the row mask (scored rows bit-identical to an
unbounded run, missing rows NaN).

The optimizer (``db/optimizer.py``, reference ``query.py:645-660,
790-810``): ``plan="auto"`` / ``algorithm="auto"`` in ``infer`` resolve
through ``engine.optimizer.decide`` (the result's ``decision``), and in
``infer_rows`` through ``decide_rows``; either axis can be pinned while the
other stays auto, and an explicit ``n_parts`` / ``batch_pages`` wins over
the decision's.  ``invalidate`` and ``invalidate_dataset`` sweep the
store's decisions with the plans.  Meshes (ROADMAP queue 1, item 12) have
no entry point yet.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import weakref
from typing import Any

import numpy as np
import torch

from repro_torch.core import algorithms as algs
from repro_torch.core import postprocess as post
from repro_torch.core.forest import (Forest, compact_forest, pad_trees,
                                     tree_slice)
from repro_torch.core.reuse import (MaterializedModel, ModelReuseCache,
                                    fingerprint_forest, mesh_signature)
from repro_torch.db.executor import (DEFAULT_STREAM_BATCH_BYTES, ScanStats,
                                     StreamingScanExecutor)
from repro_torch.db.faults import (Deadline, DegradedReport, FaultInjector,
                                   RetryPolicy)
from repro_torch.db.operators import (Operator, StageReport, run_stages,
                                      split_into_stages)
from repro_torch.db.optimizer import (DEFAULT_ALGORITHM, CostBasedOptimizer,
                                      Decision)
from repro_torch.db.store import TensorBlockStore
from repro_torch.kernels.gather import csr_block_to_dense, gather_inverse_map
from repro_torch.kernels.ops import (FUSED_KERNEL_ALGORITHMS,
                                     KERNEL_ALGORITHMS, default_tree_block,
                                     packed_nodes, share_packed_nodes)
from repro_torch.obs import METRICS, TRACER, TraceSummary

__all__ = ["QueryResult", "RowBatchResult", "CompiledQueryPlan",
           "ForestQueryEngine"]

#: sentinel in the DATASET slot (key[2]) of row-plan cache keys: row
#: batches come from the serving plane, not a stored dataset, so
#: ``store.drop`` -> ``invalidate_dataset`` never sweeps them
ROW_PLAN_DATASET = "#rows"


@dataclasses.dataclass
class QueryResult:
    predictions: torch.Tensor         # [N] final probabilities / regressands;
    #                                   on the device for a device-tier
    #                                   table, else in host memory (pinned
    #                                   on the card)
    plan: str
    algorithm: str
    num_stages: int
    stage_reports: list[StageReport]
    partition_s: float                # model-partition stage (0 on reuse hit)
    infer_s: float                    # cross-product / UDF stages
    aggregate_s: float                # aggregate + postprocess stages
    write_s: float
    total_s: float
    reuse_hit: bool = False           # model-cache OR plan-cache hit
    plan_reuse_hit: bool = False      # compiled-plan cache hit specifically
    storage_format: str = "dense"
    n_parts: int = 1                  # tree partitions (rel plans)
    tier: str = "device"
    scan: ScanStats | None = None
    trace: TraceSummary | None = None  # the query's spans and counter
    #                                   deltas while TRACER is enabled
    degraded: DegradedReport | None = None   # a PARTIAL result's report
    #                                   (deadline_s expired mid-scan)
    decision: Decision | None = None  # the optimizer verdict this query
    #                                   ran under ("auto" queries only)

    def breakdown(self) -> dict[str, float]:
        return {"partition": self.partition_s, "inference": self.infer_s,
                "aggregate": self.aggregate_s, "write": self.write_s,
                "total": self.total_s}


@dataclasses.dataclass
class RowBatchResult:
    """Result of the row-level serving entry point (``infer_rows``): the
    predictions, whether the compiled plan was reused, and the wall the
    call paid -- no stage reports, no scan telemetry."""

    predictions: torch.Tensor         # [B]; masked-out padding rows are NaN
    plan_reuse_hit: bool
    algorithm: str
    plan: str
    batch_rows: int                   # the padded batch signature B
    rows_scored: int                  # real rows (row_mask True count)
    total_s: float


@dataclasses.dataclass
class CompiledQueryPlan:
    """A built plan: its stage list, closing over the device forest."""

    stages: list
    num_stages: int                   # reported count (incl. partition stage)
    mat: Any = None                   # rel plans: pins the MaterializedModel
    #                                   whose id() keys this entry, so the id
    #                                   cannot be reused while the entry lives
    build_time_s: float = 0.0         # set by ModelReuseCache.get_or_build


def _predict_fn(algorithm: str):
    """Raw per-tree score backend [B, T]: eager oracles or raw kernels."""
    if algorithm in algs.ALGORITHMS:
        return functools.partial(algs.predict_raw, algorithm=algorithm)
    if algorithm in KERNEL_ALGORITHMS:
        return KERNEL_ALGORITHMS[algorithm]
    raise ValueError(f"unknown algorithm {algorithm!r}")


def _predict_sum_fn(algorithm: str):
    """(forest, x) -> [B] summed raw margins; returns (fn, is_fused)."""
    if algorithm in FUSED_KERNEL_ALGORITHMS:
        return FUSED_KERNEL_ALGORITHMS[algorithm], True
    predict = _predict_fn(algorithm)
    return (lambda forest, x: post.aggregate_raw(predict(forest, x))), False


class ForestQueryEngine:
    """Executes forest-inference queries against a TensorBlockStore.

    Each engine owns its model-partition cache (``reuse_cache``) and its
    compiled-plan cache unless the caller passes them in, and its
    ``optimizer`` (replaceable: tests install tighter budgets)."""

    def __init__(self, store: TensorBlockStore,
                 reuse_cache: ModelReuseCache | None = None,
                 plan_cache: ModelReuseCache | None = None):
        self.store = store
        self.mesh_id = mesh_signature()
        self.cache = reuse_cache if reuse_cache is not None \
            else ModelReuseCache()
        self.plan_cache = plan_cache if plan_cache is not None \
            else ModelReuseCache()
        # id -> content fingerprint, dropped when the Forest is collected
        self._fingerprints: dict[int, str] = {}
        store.register_invalidator(self.invalidate_dataset)
        store.register_model_invalidator(self.invalidate)
        self.optimizer = CostBasedOptimizer(self)

    # -- cache keys and sweeps ---------------------------------------------
    def _model_key(self, forest: Forest, model_id: str | None) -> str:
        if model_id is not None:
            return model_id
        k = id(forest)
        fp = self._fingerprints.get(k)
        if fp is None:
            fp = fingerprint_forest(forest)
            self._fingerprints[k] = fp
            weakref.finalize(forest, self._fingerprints.pop, k, None)
        return fp

    def invalidate(self, model_id: str | None = None) -> int:
        """Sweep the model-partition cache (model id at key[0]), the
        compiled-plan cache (model id at key[1]) and the store's optimizer
        decisions (fingerprint at key[0]): all entries, or one model's.
        Returns entries dropped."""
        return (self.cache.invalidate(model_id)
                + self.plan_cache.invalidate(model_id, key_index=1)
                + self.store.drop_decisions(model_id=model_id))

    def invalidate_dataset(self, dataset: str) -> int:
        """``store.drop``'s hook: sweep the plans built against ``dataset``
        and the decisions keyed on it (``drop`` sweeps those itself first;
        this keeps a direct call equivalent).  Partitioned models do not
        depend on a dataset and stay.  Returns entries dropped."""
        return (self.plan_cache.invalidate(dataset, key_index=2)
                + self.store.drop_decisions(dataset=dataset))

    # -- sparse prepass (the sparse plane's plan-build half) ----------------
    def _sparse_prepass(self, forest: Forest):
        """(compact forest, inverse map, f_used) for a forest on the
        store's device: the forest remapped onto its used-feature union and
        the gather's column -> slot table, built once per plan build
        (cached with the plan or the materialized model)."""
        cf, gather_idx = compact_forest(forest)
        inv_map = gather_inverse_map(gather_idx, forest.n_features,
                                     device=self.store.device)
        return cf, inv_map, int(gather_idx.numel())

    @staticmethod
    def _gather_operator(inv_map: torch.Tensor, f_used: int) -> Operator:
        """SCAN-side feature gather: CSR page block -> dense compact tile.
        Not a breaker: it runs in the stage of the kernel it feeds."""

        def gather(state):
            state = dict(state)
            state["x"] = csr_block_to_dense(state["x"], inv_map, f_used)
            return state

        return Operator("gather:csr-compact", gather)

    # -- model partition stage (the reusable one) ---------------------------
    def _partition_model(self, forest: Forest, algorithm: str,
                         num_parts: int, *, storage_format: str = "dense"
                         ) -> MaterializedModel:
        """The forest on the store's device, its tree axis padded to a
        multiple of ``num_parts``, and (``aux["nodes"]``) its node records
        as the kernels read them, built here once so that no partition
        launch builds any.  Over CSR pages the forest is first compacted
        (``_sparse_prepass``), and ``aux["inv_map"]`` / ``aux["f_used"]``
        feed the gather operator.  The kernels' structure tensors come
        from ``kernels.ops``'s per-(depth, device) cache, and the eager
        oracles build their own."""
        with TRACER.span("plan.partition", algorithm=algorithm,
                         num_parts=num_parts, storage_format=storage_format):
            dev = self.store.device
            aux: dict[str, Any] = {}
            forest = forest.to(dev)
            if storage_format == "csr":
                forest, aux["inv_map"], aux["f_used"] = \
                    self._sparse_prepass(forest)
            forest_p, true_T = pad_trees(forest, num_parts)
            aux["nodes"] = packed_nodes(forest_p)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return MaterializedModel(forest=forest_p, true_num_trees=true_T,
                                     aux=aux)

    # -- plan bodies ----------------------------------------------------------
    def _udf_ops(self, forest: Forest, algorithm: str, true_T: int,
                 sparse_aux: tuple | None = None):
        """The UDF-centric plan body; ``sparse_aux`` = (inv_map, f_used)
        over CSR pages."""
        predict_sum, _ = _predict_sum_fn(algorithm)
        meta = dict(model_type=forest.model_type, task=forest.task,
                    num_trees=true_T, base_score=forest.base_score)

        def udf(state):
            state = dict(state)
            state["pred"] = post.postprocess(
                predict_sum(forest, state["x"]), **meta)
            return state

        ops = [Operator("scan", lambda s: s)]
        if sparse_aux is not None:
            ops.append(self._gather_operator(*sparse_aux))
        return ops + [
            Operator("transform:forest-udf", udf),
            Operator("write", lambda s: s, breaker=True),
        ]

    def _rel_ops(self, mat: MaterializedModel, algorithm: str,
                 n_parts: int):
        """The relation-centric plan body over a partitioned model."""
        predict_sum, _ = _predict_sum_fn(algorithm)
        forest = mat.forest
        meta = dict(model_type=forest.model_type, task=forest.task,
                    num_trees=mat.true_num_trees,
                    base_score=forest.base_score)
        per = forest.num_trees // n_parts
        parts = [tree_slice(forest, p * per, per) for p in range(n_parts)]
        for p, part in enumerate(parts):
            share_packed_nodes(part, mat.aux["nodes"][p * per:(p + 1) * per])

        def cross_product(state):
            """CROSS-PRODUCT(tree partition, sample block) -> partials
            [n_parts, B]: partial[p, b] = sum of partition p's tree scores
            on sample b, one kernel launch per partition."""
            x = state["x"]
            partials = torch.empty((n_parts, x.shape[0]),
                                   dtype=torch.float32, device=x.device)
            for p, part in enumerate(parts):
                partials[p] = predict_sum(part, x)
            state = dict(state)
            state["partials"] = partials
            return state

        def aggregate(state):
            state = dict(state)
            partials = state.pop("partials")
            # sequential fold in partition order, as the reference does
            summed = partials[0]
            for p in range(1, partials.shape[0]):
                summed = summed + partials[p]
            state["summed"] = summed
            return state

        def postprocess_op(state):
            state = dict(state)
            state["pred"] = post.postprocess(state.pop("summed"), **meta)
            return state

        ops = [Operator("scan", lambda s: s)]
        if "inv_map" in mat.aux:
            # the gather shares the cross-product stage: the compact tile
            # is its input, not a new materialization boundary
            ops.append(self._gather_operator(mat.aux["inv_map"],
                                             mat.aux["f_used"]))
        return ops + [
            Operator("cross-product:partial-agg", cross_product,
                     breaker=True),
            Operator("aggregate", aggregate, breaker=True),
            Operator("postprocess", postprocess_op),
            Operator("write", lambda s: s, breaker=True),
        ]

    def _resolve_n_parts(self, forest: Forest, algorithm: str,
                         n_parts: int | None) -> int:
        """Tree-partition count of the rel plans: an explicit ``n_parts``
        wins; kernel algorithms take one partition per kernel tree tile
        (``ceil(T / default_tree_block)``, sized for the fused or the raw
        kernel it will launch); the eager oracles take ``min(4, T)``."""
        if n_parts is not None:
            return max(1, int(n_parts))
        if "pallas" not in algorithm:
            return min(4, forest.num_trees)
        _, fused = _predict_sum_fn(algorithm)
        bt = default_tree_block(forest, fused=fused)
        return max(1, -(-forest.num_trees // bt))

    def _partitioned(self, forest: Forest, mid: str, algorithm: str,
                     n_parts: int, fmt: str
                     ) -> tuple[MaterializedModel, bool]:
        """The cached partitioned model and whether it was a hit; a CSR
        materialization (the compacted forest) is its own entry."""
        before = self.cache.stats.hits
        mat = self.cache.get_or_build(
            (mid, algorithm, n_parts, self.mesh_id, fmt),
            lambda: self._partition_model(forest, algorithm, n_parts,
                                          storage_format=fmt))
        return mat, self.cache.stats.hits > before

    def _udf_plan(self, forest: Forest, algorithm: str,
                  fmt: str = "dense") -> CompiledQueryPlan:
        forest, sparse_aux = forest.to(self.store.device), None
        if fmt == "csr":
            forest, inv_map, f_used = self._sparse_prepass(forest)
            sparse_aux = (inv_map, f_used)
        fp, true_T = pad_trees(forest, 1)
        stages = split_into_stages(self._udf_ops(fp, algorithm, true_T,
                                                 sparse_aux))
        return CompiledQueryPlan(stages=stages, num_stages=len(stages))

    def _rel_plan(self, mat: MaterializedModel, algorithm: str,
                  n_parts: int) -> CompiledQueryPlan:
        stages = split_into_stages(self._rel_ops(mat, algorithm, n_parts))
        return CompiledQueryPlan(stages=stages, num_stages=len(stages) + 1,
                                 mat=mat)

    def _cached_plan(self, key: tuple, build, plan: str, **attrs
                     ) -> tuple[CompiledQueryPlan, bool]:
        """The compiled-plan cache lookup: the plan and whether it was a
        hit, counted and traced (a ``plan.build`` span on a miss).  ``plan``
        labels the lookup ("udf", "rel+reuse", "udf-rows",
        "rel+reuse-rows")."""

        def traced_build() -> CompiledQueryPlan:
            with TRACER.span("plan.build", plan=plan, **attrs):
                return build()

        before = self.plan_cache.stats.hits
        qplan = self.plan_cache.get_or_build(key, traced_build)
        hit = self.plan_cache.stats.hits > before
        METRICS.counter("plan.cache_hits" if hit
                        else "plan.cache_misses").inc()
        TRACER.event("plan.cache", hit=hit, plan=plan)
        return qplan, hit

    # -- entry points -------------------------------------------------------
    def infer(self, dataset: str, forest: Forest, **kw) -> QueryResult:
        """Run the end-to-end inference query over a stored dataset (the
        keywords are ``_infer``'s).  The observability boundary: with
        ``TRACER`` enabled the query runs under a ``query.infer`` root span
        and ``QueryResult.trace`` is its ``TraceSummary``; disabled, a tail
        call."""
        if not TRACER.enabled:
            return self._infer(dataset, forest, **kw)
        mark = TRACER.mark()
        before = METRICS.counter_values()
        with TRACER.span("query.infer", dataset=dataset,
                         plan=kw.get("plan", "udf"),
                         algorithm=kw.get("algorithm") or DEFAULT_ALGORITHM
                         ) as root:
            res = self._infer(dataset, forest, **kw)
            root.set(tier=res.tier, storage_format=res.storage_format,
                     reuse_hit=res.reuse_hit)
        res.trace = TRACER.summarize(root, since=mark,
                                     counters_before=before,
                                     counters_now=METRICS.counter_values())
        return res

    def _infer(self, dataset: str, forest: Forest, *,
               algorithm: str | None = None, plan: str = "udf",
               batch_pages: int | None = None, write_as: str | None = None,
               model_id: str | None = None, n_parts: int | None = None,
               prefetch_depth: int = 2, deadline_s: float | None = None,
               injector: FaultInjector | None = None,
               retry_policy: RetryPolicy | None = None,
               auto_move: bool = False) -> QueryResult:
        """Run the end-to-end inference query over a stored dataset.

        ``plan="auto"`` / ``algorithm="auto"`` resolve through the
        optimizer (module note): the first query per (model, dataset
        signature) pays a bounded score and measure pass, later ones a
        catalog lookup.  ``algorithm`` None (the default) runs
        ``"predicated"``; under ``plan="auto"`` it pins that name on a CPU
        store, as the reference does, and leaves a CUDA store's six kernels
        to the optimizer.  ``auto_move`` also applies the decision's tier
        advice (``store.move`` before the scan, then one decision under the
        new tier's signature); off by default, since a query should not
        silently migrate a dataset.

        ``batch_pages`` pages go to each scan batch.  By default a
        device-tier table is one batch; a host- or disk-tier table streams
        in batches of half the store's ``device_budget_bytes`` (two page
        buffers in flight fit the budget), or of
        ``DEFAULT_STREAM_BATCH_BYTES`` with no budget, in whole pages and at
        least one.  ``prefetch_depth`` 2 overlaps batch i+1's pages and
        batch i-1's drain with batch i's stages; 1 is the synchronous
        reference.  ``n_parts`` overrides the rel plans' tree-partition
        count.  ``write_as`` registers the predictions as a new dataset
        where they landed (the WRITE operator's sink).

        ``injector`` / ``retry_policy`` arm the scan's fault sites and
        bound their recovery; ``deadline_s`` is the query's budget, read
        at batch boundaries: out of budget, the result is PARTIAL, with a
        ``degraded`` report (module note).

        A CSR dataset runs the sparse plane (module note), and its result
        says ``storage_format == "csr"``.  Its default batch is the same
        (all pages on the device tier); a compact tile of ``batch_rows x
        F_used`` floats can exceed the card, so wide sparse tables pass
        ``batch_pages`` (choosing it is the optimizer's, ROADMAP queue 1
        item 10).

        A kept divergence (ROADMAP section 3, item 3): the predictions of a
        host- or disk-tier scan are the scan's pinned host buffer, where
        the reference always returns a device array
        (``repro/db/query.py:974``)."""
        decision = None
        if plan == "auto" or algorithm == "auto":
            pinned = dict(
                algorithms=self.optimizer.algorithms_for(algorithm),
                plans=None if plan == "auto" else (plan,))
            decision = self.optimizer.decide(dataset, forest,
                                             model_id=model_id, **pinned)
            if auto_move and decision.tier != self.store.get(dataset).tier:
                self.store.move(dataset, decision.tier)
                # the move changed the dataset signature: decide once under
                # the new tier (persisted, so still one-shot)
                decision = self.optimizer.decide(dataset, forest,
                                                 model_id=model_id, **pinned)
            algorithm, plan = decision.algorithm, decision.plan
            if n_parts is None:
                n_parts = decision.n_parts
            if batch_pages is None:
                batch_pages = decision.batch_pages
        algorithm = algorithm or DEFAULT_ALGORITHM
        if plan not in ("udf", "rel", "rel+reuse"):
            raise ValueError(f"unknown plan {plan!r}")
        _predict_sum_fn(algorithm)             # reject unknown names early
        ds = self.store.get(dataset)
        t_query0 = time.perf_counter()
        # the deadline budgets the whole query from here (plan build and
        # scan), as a caller on the request path sees it
        deadline = Deadline(deadline_s, start=t_query0) \
            if deadline_s is not None else None
        if batch_pages is None:
            batch_pages = ds.num_pages
            if ds.tier != "device":
                budget = self.store.device_budget_bytes
                target = budget // 2 if budget else DEFAULT_STREAM_BATCH_BYTES
                fit = target // max(ds.page_nbytes, 1)
                batch_pages = min(ds.num_pages, max(1, fit))
        fmt = ds.storage_format
        if fmt == "csr":
            batch_sig = (ds.num_features, ds.pages.capacity, ds.num_pages,
                         ds.page_rows, batch_pages)
        else:
            batch_sig = (ds.num_features, ds.num_pages, ds.page_rows,
                         batch_pages)
        partition_s = 0.0
        model_hit = plan_hit = False
        prefix: list[StageReport] = []

        if plan == "udf":
            mid = self._model_key(forest, model_id)
            qplan, plan_hit = self._cached_plan(
                ("udf-plan", mid, dataset, algorithm, fmt, batch_sig,
                 self.mesh_id),
                lambda: self._udf_plan(forest, algorithm, fmt), "udf",
                algorithm=algorithm, storage_format=fmt)
            n_parts = 1
        else:
            n_parts = self._resolve_n_parts(forest, algorithm, n_parts)
            t0 = time.perf_counter()
            if plan == "rel+reuse":
                mid = self._model_key(forest, model_id)
                mat, model_hit = self._partitioned(forest, mid, algorithm,
                                                   n_parts, fmt)
            else:
                mat = self._partition_model(forest, algorithm, n_parts,
                                            storage_format=fmt)
            partition_s = time.perf_counter() - t0
            prefix = [StageReport(
                name="stageP:model-partition",
                operators=("partition-model",), seconds=partition_s,
                materialized_bytes=sum(
                    a.nbytes for a in mat.forest.arrays().values()))]
            if plan == "rel+reuse":
                # id(mat) ties the entry to THIS materialization; the entry
                # pins mat so the id cannot be reused while it lives
                qplan, plan_hit = self._cached_plan(
                    ("rel-plan", mid, dataset, algorithm, n_parts, fmt,
                     batch_sig, self.mesh_id, id(mat)),
                    lambda: self._rel_plan(mat, algorithm, n_parts),
                    "rel+reuse", algorithm=algorithm, storage_format=fmt)
            else:
                qplan = self._rel_plan(mat, algorithm, n_parts)
        reuse_hit = model_hit or plan_hit

        executor = StreamingScanExecutor(
            qplan.stages, prefetch_depth=prefetch_depth, injector=injector,
            retry_policy=retry_policy, deadline=deadline)
        predictions, batch_reports, scan = executor.execute(ds, batch_pages)
        reports = prefix + batch_reports
        degraded = None
        if scan.deadline_hit:
            mask = executor.last_mask
            rows_scored = int(mask.sum())
            degraded = DegradedReport(
                rows_scored=rows_scored,
                rows_missing=ds.num_rows - rows_scored, cause="deadline",
                deadline_s=deadline_s, row_mask=mask)

        write_s = 0.0
        if write_as is not None:
            t0 = time.perf_counter()
            with TRACER.span("query.write", dataset=write_as):
                self.store.put_result(write_as, predictions, ds.num_rows)
            write_s = time.perf_counter() - t0
        total_s = time.perf_counter() - t_query0

        def _has(rep, *names):
            return any(n in op for op in rep.operators for n in names)

        infer_s = sum(r.seconds for r in reports
                      if _has(r, "forest-udf", "cross-product"))
        aggregate_s = sum(r.seconds for r in reports
                          if _has(r, "aggregate", "postprocess")
                          and not _has(r, "cross-product", "forest-udf"))
        return QueryResult(
            predictions=predictions, plan=plan, algorithm=algorithm,
            num_stages=qplan.num_stages, stage_reports=reports,
            partition_s=0.0 if reuse_hit else partition_s, infer_s=infer_s,
            aggregate_s=aggregate_s, write_s=write_s, total_s=total_s,
            reuse_hit=reuse_hit, plan_reuse_hit=plan_hit,
            storage_format=fmt, n_parts=n_parts, tier=ds.tier, scan=scan,
            degraded=degraded, decision=decision)

    def infer_rows(self, forest: Forest, x, *,
                   row_mask: np.ndarray | None = None,
                   algorithm: str | None = None, plan: str = "udf",
                   model_id: str | None = None,
                   n_parts: int | None = None) -> RowBatchResult:
        """Score a PRE-PADDED row batch against the compiled-plan cache.

        The serving plane's hot path: ``x`` is ``[B, F]`` rows already
        padded to a fixed batch signature, so every call with the same
        (model, algorithm, plan, B, F) reuses one compiled plan -- no store
        round-trip, no scan executor, and (``rel+reuse``) no
        re-partitioning.  ``row_mask`` marks the real rows: padding rows
        come back NaN.  The bare ``rel`` plan is refused: serving runs
        cached plans only.

        ``plan="auto"`` / ``algorithm="auto"`` resolve through the
        optimizer's row-batch decision (``decide_rows``, persisted per
        (model, batch signature)); the serving plane resolves it once, at
        ``register_model``.  ``algorithm`` None is ``infer``'s."""
        if plan == "auto" or algorithm == "auto":
            dec = self.optimizer.decide_rows(
                forest, int(getattr(x, "shape", (len(x),))[0]),
                model_id=model_id,
                algorithms=self.optimizer.algorithms_for(algorithm),
                plans=None if plan == "auto" else (plan,))
            algorithm, plan = dec.algorithm, dec.plan
            if n_parts is None:
                n_parts = dec.n_parts
        algorithm = algorithm or DEFAULT_ALGORITHM
        if plan not in ("udf", "rel+reuse"):
            raise ValueError(f"infer_rows serves cached plans only (udf / "
                             f"rel+reuse), got {plan!r}")
        _predict_sum_fn(algorithm)
        t0 = time.perf_counter()
        x = torch.as_tensor(x, dtype=torch.float32, device=self.store.device)
        if x.dim() != 2:
            raise ValueError(f"expected [B, F] rows, got shape "
                             f"{tuple(x.shape)}")
        B, F = x.shape
        mask = None
        if row_mask is not None:
            mask = np.asarray(row_mask, bool)
            if mask.shape != (B,):
                raise ValueError(f"row_mask shape {mask.shape} != ({B},)")
        mid = self._model_key(forest, model_id)
        batch_sig = (B, F)
        fmt = "dense"                  # row batches are dense rows

        with TRACER.span("query.infer_rows", plan=plan, algorithm=algorithm,
                         batch_rows=B) as sp:
            if plan == "udf":
                qplan, plan_hit = self._cached_plan(
                    ("udf-row-plan", mid, ROW_PLAN_DATASET, algorithm, fmt,
                     batch_sig, self.mesh_id),
                    lambda: self._udf_plan(forest, algorithm, fmt),
                    "udf-rows", algorithm=algorithm)
            else:
                n_parts = self._resolve_n_parts(forest, algorithm, n_parts)
                mat, _ = self._partitioned(forest, mid, algorithm, n_parts,
                                           fmt)
                qplan, plan_hit = self._cached_plan(
                    ("rel-row-plan", mid, ROW_PLAN_DATASET, algorithm,
                     n_parts, fmt, batch_sig, self.mesh_id, id(mat)),
                    lambda: self._rel_plan(mat, algorithm, n_parts),
                    "rel+reuse-rows", algorithm=algorithm)
            state, _ = run_stages(qplan.stages, {"x": x})
            preds = state["pred"]
            rows_scored = B
            if mask is not None:
                rows_scored = int(mask.sum())
                # padding rows never leak: their predictions are NaN
                preds = torch.where(
                    torch.as_tensor(mask, device=preds.device), preds,
                    torch.full_like(preds, float("nan")))
            sp.set(reuse_hit=plan_hit, rows=rows_scored)
        return RowBatchResult(
            predictions=preds, plan_reuse_hit=plan_hit, algorithm=algorithm,
            plan=plan, batch_rows=B, rows_scored=rows_scored,
            total_s=time.perf_counter() - t0)
