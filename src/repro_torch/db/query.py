"""Physical query plans for in-database forest inference (torch).

Mirrors ``repro/db/query.py`` for the UDF-centric plan over a dense,
device-tier dataset -- the paper's in-database query

    SCAN -> PREDICT -> AGGREGATE -> WRITE          (Sec. 3.2/3.3, Fig. 3)

with the whole forest inside one transform UDF.  With a fused algorithm
(``*_pallas_fused``) each scan batch is ONE kernel launch that returns the
per-sample margin sums; ``core.postprocess`` then applies the mean or the
base score and sigmoid.  The plain algorithms (``predicated``, ...) run the
eager torch oracles and aggregate their [B, T] scores.

Compiled-plan cache: the stage list, keyed on
``("udf-plan", model id, dataset, algorithm, storage format, batch
signature, device layout)``, is built once; a repeated query reuses it
(``plan_reuse_hit``).  Plan keys carry the model id at key[1]
(``invalidate``) and the dataset at key[2] (``store.drop`` ->
``invalidate_dataset``).

Not ported yet, and refused with ``NotImplementedError``: the ``rel`` /
``rel+reuse`` plans and ``infer_rows`` (ROADMAP queue 1, item 5), the
unfused ``*_pallas`` kernels (queue 2, items 4-6), host/disk tiers (item
6), CSR datasets (item 7), ``plan="auto"`` (item 10), meshes (item 12).
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import torch

from repro_torch.core import algorithms as algs
from repro_torch.core import postprocess as post
from repro_torch.core.forest import Forest, pad_trees
from repro_torch.core.reuse import (ModelReuseCache, fingerprint_forest,
                                    mesh_signature)
from repro_torch.db.executor import ScanStats, StreamingScanExecutor
from repro_torch.db.operators import Operator, StageReport, split_into_stages
from repro_torch.db.store import TensorBlockStore
from repro_torch.kernels.ops import FUSED_KERNEL_ALGORITHMS

__all__ = ["QueryResult", "CompiledQueryPlan", "ForestQueryEngine"]

#: the reference's unfused kernel backends, ported in the next slice
UNFUSED_KERNEL_ALGORITHMS = ("predicated_pallas", "hummingbird_pallas",
                             "quickscorer_pallas")


@dataclasses.dataclass
class QueryResult:
    predictions: torch.Tensor         # [N] final probabilities / regressands
    plan: str
    algorithm: str
    num_stages: int
    stage_reports: list[StageReport]
    partition_s: float                # model-partition stage (udf: 0)
    infer_s: float                    # forest-udf stages
    aggregate_s: float
    write_s: float
    total_s: float
    reuse_hit: bool = False           # plan-cache hit
    plan_reuse_hit: bool = False      # compiled-plan cache hit specifically
    storage_format: str = "dense"
    n_parts: int = 1
    tier: str = "device"
    scan: ScanStats | None = None

    def breakdown(self) -> dict[str, float]:
        return {"partition": self.partition_s, "inference": self.infer_s,
                "aggregate": self.aggregate_s, "write": self.write_s,
                "total": self.total_s}


@dataclasses.dataclass
class CompiledQueryPlan:
    """A built plan: its stage list, closing over the device forest."""

    stages: list
    num_stages: int
    build_time_s: float = 0.0         # set by ModelReuseCache.get_or_build


def _predict_sum_fn(algorithm: str):
    """(forest, x) -> [B] summed raw margins; returns (fn, is_fused)."""
    if algorithm in FUSED_KERNEL_ALGORITHMS:
        return FUSED_KERNEL_ALGORITHMS[algorithm], True
    if algorithm in algs.ALGORITHMS:
        def predict_sum(forest, x):
            return post.aggregate_raw(algs.predict_raw(forest, x, algorithm))
        return predict_sum, False
    if algorithm in UNFUSED_KERNEL_ALGORITHMS:
        raise NotImplementedError(
            f"{algorithm!r}: the unfused [B, T] kernels are not ported yet "
            f"(ROADMAP queue 2, items 4-6)")
    raise ValueError(f"unknown algorithm {algorithm!r}")


class ForestQueryEngine:
    """Executes forest-inference queries against a TensorBlockStore.

    Each engine owns its plan cache unless the caller passes one in (the
    model-partition cache arrives with the rel plans)."""

    def __init__(self, store: TensorBlockStore,
                 plan_cache: ModelReuseCache | None = None):
        self.store = store
        self.mesh_id = mesh_signature()
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
        """Sweep the compiled-plan cache (all entries, or one model's).
        Returns entries dropped."""
        return self.plan_cache.invalidate(model_id, key_index=1)

    def invalidate_dataset(self, dataset: str) -> int:
        """``store.drop``'s hook: sweep the plans built against
        ``dataset``.  Returns entries dropped."""
        return self.plan_cache.invalidate(dataset, key_index=2)

    # -- plan body ----------------------------------------------------------
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

    # -- entry point --------------------------------------------------------
    def infer(self, dataset: str, forest: Forest, *,
              algorithm: str = "predicated", plan: str = "udf",
              batch_pages: int | None = None, write_as: str | None = None,
              model_id: str | None = None,
              prefetch_depth: int = 2) -> QueryResult:
        """Run the end-to-end inference query over a stored dataset.

        ``batch_pages`` pages go to each scan batch (default: the whole
        dataset, one batch).  ``write_as`` registers the predictions as a
        new dataset (the WRITE operator's sink)."""
        if plan in ("rel", "rel+reuse"):
            raise NotImplementedError(
                f"plan {plan!r} is not ported yet (ROADMAP queue 1, item 5)")
        if plan == "auto" or algorithm == "auto":
            raise NotImplementedError(
                "the cost-based optimizer is not ported yet (ROADMAP queue "
                "1, item 10)")
        if plan != "udf":
            raise ValueError(f"unknown plan {plan!r}")
        _predict_sum_fn(algorithm)             # reject unknown names early
        ds = self.store.get(dataset)
        t_query0 = time.perf_counter()
        if batch_pages is None:
            batch_pages = ds.num_pages
        batch_sig = (ds.num_features, ds.num_pages, ds.page_rows,
                     batch_pages)
        mid = self._model_key(forest, model_id)
        pkey = ("udf-plan", mid, dataset, algorithm, ds.storage_format,
                batch_sig, self.mesh_id)

        def build_udf() -> CompiledQueryPlan:
            fp, true_T = pad_trees(forest.to(self.store.device), 1)
            stages = split_into_stages(self._udf_ops(fp, algorithm, true_T))
            return CompiledQueryPlan(stages=stages, num_stages=len(stages))

        before = self.plan_cache.stats.hits
        qplan = self.plan_cache.get_or_build(pkey, build_udf)
        plan_hit = self.plan_cache.stats.hits > before

        executor = StreamingScanExecutor(qplan.stages,
                                         prefetch_depth=prefetch_depth)
        predictions, reports, scan = executor.execute(ds, batch_pages)

        write_s = 0.0
        if write_as is not None:
            t0 = time.perf_counter()
            self.store.put_result(write_as, predictions, ds.num_rows)
            write_s = time.perf_counter() - t0
        total_s = time.perf_counter() - t_query0
        infer_s = sum(r.seconds for r in reports
                      if any("forest-udf" in op for op in r.operators))
        return QueryResult(
            predictions=predictions, plan=plan, algorithm=algorithm,
            num_stages=qplan.num_stages, stage_reports=reports,
            partition_s=0.0, infer_s=infer_s, aggregate_s=0.0,
            write_s=write_s, total_s=total_s, reuse_hit=plan_hit,
            plan_reuse_hit=plan_hit, storage_format=ds.storage_format,
            n_parts=1, tier=ds.tier, scan=scan)
