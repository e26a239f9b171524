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

Not ported yet, and refused with ``NotImplementedError``: host/disk tiers
(ROADMAP queue 1, item 6), CSR datasets (item 7), ``plan="auto"`` (item
10), meshes (item 12).
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
from repro_torch.core.forest import Forest, pad_trees, tree_slice
from repro_torch.core.reuse import (MaterializedModel, ModelReuseCache,
                                    fingerprint_forest, mesh_signature)
from repro_torch.db.executor import ScanStats, StreamingScanExecutor
from repro_torch.db.operators import (Operator, StageReport, run_stages,
                                      split_into_stages)
from repro_torch.db.store import TensorBlockStore
from repro_torch.kernels.ops import (FUSED_KERNEL_ALGORITHMS,
                                     KERNEL_ALGORITHMS, default_tree_block)

__all__ = ["QueryResult", "RowBatchResult", "CompiledQueryPlan",
           "ForestQueryEngine"]

#: sentinel in the DATASET slot (key[2]) of row-plan cache keys: row
#: batches come from the serving plane, not a stored dataset, so
#: ``store.drop`` -> ``invalidate_dataset`` never sweeps them
ROW_PLAN_DATASET = "#rows"

_AUTO_REFUSED = ("the cost-based optimizer is not ported yet (ROADMAP "
                 "queue 1, item 10)")


@dataclasses.dataclass
class QueryResult:
    predictions: torch.Tensor         # [N] final probabilities / regressands
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
    compiled-plan cache unless the caller passes them in."""

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
        """Sweep BOTH the model-partition cache (model id at key[0]) and
        the compiled-plan cache (model id at key[1]): all entries, or one
        model's.  Returns entries dropped."""
        return (self.cache.invalidate(model_id)
                + self.plan_cache.invalidate(model_id, key_index=1))

    def invalidate_dataset(self, dataset: str) -> int:
        """``store.drop``'s hook: sweep the plans built against
        ``dataset``.  Partitioned models do not depend on a dataset and
        stay.  Returns entries dropped."""
        return self.plan_cache.invalidate(dataset, key_index=2)

    # -- model partition stage (the reusable one) ---------------------------
    def _partition_model(self, forest: Forest,
                         num_parts: int) -> MaterializedModel:
        """The forest on the store's device, its tree axis padded to a
        multiple of ``num_parts``.  ``aux`` stays empty: the kernels'
        structure tensors come from ``kernels.ops``'s per-(depth, device)
        cache, and the eager oracles build their own."""
        dev = self.store.device
        forest_p, true_T = pad_trees(forest.to(dev), num_parts)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return MaterializedModel(forest=forest_p, true_num_trees=true_T,
                                 aux={})

    # -- plan bodies ----------------------------------------------------------
    @staticmethod
    def _udf_ops(forest: Forest, algorithm: str, true_T: int):
        predict_sum, _ = _predict_sum_fn(algorithm)
        meta = dict(model_type=forest.model_type, task=forest.task,
                    num_trees=true_T, base_score=forest.base_score)

        def udf(state):
            state = dict(state)
            state["pred"] = post.postprocess(
                predict_sum(forest, state["x"]), **meta)
            return state

        return [
            Operator("scan", lambda s: s),
            Operator("transform:forest-udf", udf),
            Operator("write", lambda s: s, breaker=True),
        ]

    @staticmethod
    def _rel_ops(mat: MaterializedModel, algorithm: str, n_parts: int):
        """The relation-centric plan body over a partitioned model."""
        predict_sum, _ = _predict_sum_fn(algorithm)
        forest = mat.forest
        meta = dict(model_type=forest.model_type, task=forest.task,
                    num_trees=mat.true_num_trees,
                    base_score=forest.base_score)
        per = forest.num_trees // n_parts
        parts = [tree_slice(forest, p * per, per) for p in range(n_parts)]

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

        return [
            Operator("scan", lambda s: s),
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
                     n_parts: int) -> tuple[MaterializedModel, bool]:
        """The cached partitioned model and whether it was a hit."""
        before = self.cache.stats.hits
        mat = self.cache.get_or_build(
            (mid, algorithm, n_parts, self.mesh_id, "dense"),
            lambda: self._partition_model(forest, n_parts))
        return mat, self.cache.stats.hits > before

    def _udf_plan(self, forest: Forest, algorithm: str) -> CompiledQueryPlan:
        fp, true_T = pad_trees(forest.to(self.store.device), 1)
        stages = split_into_stages(self._udf_ops(fp, algorithm, true_T))
        return CompiledQueryPlan(stages=stages, num_stages=len(stages))

    def _rel_plan(self, mat: MaterializedModel, algorithm: str,
                  n_parts: int) -> CompiledQueryPlan:
        stages = split_into_stages(self._rel_ops(mat, algorithm, n_parts))
        return CompiledQueryPlan(stages=stages, num_stages=len(stages) + 1,
                                 mat=mat)

    def _cached_plan(self, key: tuple, build) -> tuple[CompiledQueryPlan,
                                                       bool]:
        before = self.plan_cache.stats.hits
        qplan = self.plan_cache.get_or_build(key, build)
        return qplan, self.plan_cache.stats.hits > before

    # -- entry points -------------------------------------------------------
    def infer(self, dataset: str, forest: Forest, *,
              algorithm: str = "predicated", plan: str = "udf",
              batch_pages: int | None = None, write_as: str | None = None,
              model_id: str | None = None, n_parts: int | None = None,
              prefetch_depth: int = 2) -> QueryResult:
        """Run the end-to-end inference query over a stored dataset.

        ``batch_pages`` pages go to each scan batch (default: the whole
        dataset, one batch).  ``n_parts`` overrides the rel plans'
        tree-partition count.  ``write_as`` registers the predictions as a
        new dataset (the WRITE operator's sink)."""
        if plan == "auto" or algorithm == "auto":
            raise NotImplementedError(_AUTO_REFUSED)
        if plan not in ("udf", "rel", "rel+reuse"):
            raise ValueError(f"unknown plan {plan!r}")
        _predict_sum_fn(algorithm)             # reject unknown names early
        ds = self.store.get(dataset)
        t_query0 = time.perf_counter()
        if batch_pages is None:
            batch_pages = ds.num_pages
        batch_sig = (ds.num_features, ds.num_pages, ds.page_rows,
                     batch_pages)
        fmt = ds.storage_format
        partition_s = 0.0
        model_hit = plan_hit = False
        prefix: list[StageReport] = []

        if plan == "udf":
            mid = self._model_key(forest, model_id)
            qplan, plan_hit = self._cached_plan(
                ("udf-plan", mid, dataset, algorithm, fmt, batch_sig,
                 self.mesh_id), lambda: self._udf_plan(forest, algorithm))
            n_parts = 1
        else:
            n_parts = self._resolve_n_parts(forest, algorithm, n_parts)
            t0 = time.perf_counter()
            if plan == "rel+reuse":
                mid = self._model_key(forest, model_id)
                mat, model_hit = self._partitioned(forest, mid, algorithm,
                                                   n_parts)
            else:
                mat = self._partition_model(forest, n_parts)
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
                    lambda: self._rel_plan(mat, algorithm, n_parts))
            else:
                qplan = self._rel_plan(mat, algorithm, n_parts)
        reuse_hit = model_hit or plan_hit

        executor = StreamingScanExecutor(qplan.stages,
                                         prefetch_depth=prefetch_depth)
        predictions, batch_reports, scan = executor.execute(ds, batch_pages)
        reports = prefix + batch_reports

        write_s = 0.0
        if write_as is not None:
            t0 = time.perf_counter()
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
            storage_format=fmt, n_parts=n_parts, tier=ds.tier, scan=scan)

    def infer_rows(self, forest: Forest, x, *,
                   row_mask: np.ndarray | None = None,
                   algorithm: str = "predicated", plan: str = "udf",
                   model_id: str | None = None,
                   n_parts: int | None = None) -> RowBatchResult:
        """Score a PRE-PADDED row batch against the compiled-plan cache.

        The serving plane's hot path: ``x`` is ``[B, F]`` rows already
        padded to a fixed batch signature, so every call with the same
        (model, algorithm, plan, B, F) reuses one compiled plan -- no store
        round-trip, no scan executor, and (``rel+reuse``) no
        re-partitioning.  ``row_mask`` marks the real rows: padding rows
        come back NaN.  The bare ``rel`` plan is refused: serving runs
        cached plans only."""
        if plan == "auto" or algorithm == "auto":
            raise NotImplementedError(_AUTO_REFUSED)
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

        if plan == "udf":
            qplan, plan_hit = self._cached_plan(
                ("udf-row-plan", mid, ROW_PLAN_DATASET, algorithm, "dense",
                 batch_sig, self.mesh_id),
                lambda: self._udf_plan(forest, algorithm))
        else:
            n_parts = self._resolve_n_parts(forest, algorithm, n_parts)
            mat, _ = self._partitioned(forest, mid, algorithm, n_parts)
            qplan, plan_hit = self._cached_plan(
                ("rel-row-plan", mid, ROW_PLAN_DATASET, algorithm, n_parts,
                 "dense", batch_sig, self.mesh_id, id(mat)),
                lambda: self._rel_plan(mat, algorithm, n_parts))
        state, _ = run_stages(qplan.stages, {"x": x})
        preds = state["pred"]
        rows_scored = B
        if mask is not None:
            rows_scored = int(mask.sum())
            # padding rows never leak: their predictions are NaN
            preds = torch.where(torch.as_tensor(mask, device=preds.device),
                                preds, torch.full_like(preds, float("nan")))
        return RowBatchResult(
            predictions=preds, plan_reuse_hit=plan_hit, algorithm=algorithm,
            plan=plan, batch_rows=B, rows_scored=rows_scored,
            total_s=time.perf_counter() - t0)
