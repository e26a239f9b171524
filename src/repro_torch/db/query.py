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
store's decisions with the plans.

The mesh (``dist/sharding.py``; reference ``query.py:376-478``): an engine
runs on its store's ``mesh`` (``fplan`` is its axis mapping), one
controller over positions it addresses.  The store splits every page
batch into ``data``-axis row shards (``db/executor.py``), and

  udf        on a mesh with a data axis, ``transform:forest-udf@shard_map``:
             the forest is replicated over ``data`` (once a card, held by
             the plan), and each row shard is one ``predict_sum`` at its
             home, with the CSR gather inside, so a compact tile exists
             only at the local batch: ``n_data`` launches a batch;
  rel        on a mesh with a model axis, ``cross-product:psum-agg``: the
             partition stage pads T to a multiple of ``n_model`` and places
             tree shard m at the positions (*, m) (``fplan.shard_forest``,
             kept in the materialized model); position (d, m) runs one
             ``predict_sum`` over its tree shard and its row shard (fused
             names sum in-kernel, raw names through their [B_local,
             T_local] sum), and the ``n_model`` partials of a row shard are
             folded at its home IN MODEL ORDER: ``n_data * n_model``
             launches a batch.

The fold is the mesh-less aggregate's sequential partition-order sum over
the same partials, so a mesh query equals the mesh-less one at
``n_parts = n_model`` bit for bit (the reference's ``psum`` is proven
equal to the same fold; an NCCL all-reduce's order would not be).  On a
model mesh ``n_parts`` is ``n_model`` and an explicit one is ignored; a
rel query on a mesh with no model axis runs the mesh-less template on
each row shard.  Phase 2 (``postprocess``) runs once a batch over the
shards gathered at the store's device (``db/shards.py:map_gathered``), so
a plan's result is one tensor a batch.  Batches are whole data-axis units
(``batch_pages`` rounds up), ``infer_rows`` refuses a batch the data axis
does not divide, plan,
model and decision keys carry ``mesh_signature``, and
``QueryResult.mesh_devices`` is the mesh's position count.
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
from repro_torch.db.shards import (RowShards, device_of, map_gathered,
                                   map_shards, place)
from repro_torch.dist.sharding import ForestShardingPlan, physical, replica
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
    mesh_devices: int = 1             # mesh positions (1 off-mesh)

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
    ``optimizer`` (replaceable: tests install tighter budgets).  It runs
    on its store's ``mesh``: the store pads and splits the batches the
    engine's stages take."""

    def __init__(self, store: TensorBlockStore,
                 reuse_cache: ModelReuseCache | None = None,
                 plan_cache: ModelReuseCache | None = None):
        self.store = store
        self.mesh = store.mesh
        self.fplan: ForestShardingPlan = store.fplan
        self.mesh_id = mesh_signature(self.mesh)
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
    def _local_gather(inv_map: torch.Tensor, f_used: int):
        """CSR page block -> dense compact tile on the block's device, with
        the inverse map placed there once a card."""
        maps: dict[torch.device, torch.Tensor] = {}

        def gather(block):
            dev = physical(device_of(block))
            inv = maps.get(dev)
            if inv is None:
                inv = maps[dev] = place(inv_map, dev)
            return csr_block_to_dense(block, inv, f_used)

        return gather

    def _gather_operator(self, inv_map: torch.Tensor,
                         f_used: int) -> Operator:
        """SCAN-side feature gather: CSR page block -> dense compact tile,
        shard by shard on a data mesh.  Not a breaker: it runs in the
        stage of the kernel it feeds."""
        local = self._local_gather(inv_map, f_used)

        def gather(state):
            state = dict(state)
            state["x"] = map_shards(state["x"], local)
            return state

        return Operator("gather:csr-compact", gather,
                        devices=self.fplan.positions)

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
        oracles build their own.

        On a model mesh (``num_parts == n_model``) the tree shards are
        placed too (``fplan.shard_forest``, kept in ``aux["tree_shards"]``),
        each with its node records: a view of the whole model's on the
        store's card, built on its own card elsewhere."""
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
            if self.fplan.model_axis is not None:
                per = forest_p.num_trees // num_parts
                aux["tree_shards"] = self.fplan.shard_forest(forest_p)
                for m, reps in enumerate(aux["tree_shards"]):
                    for shard in reps.values():
                        if physical(shard.device) == physical(dev):
                            share_packed_nodes(
                                shard, aux["nodes"][m * per:(m + 1) * per])
                        else:
                            packed_nodes(shard)
            cards = (self.mesh.physical_devices() if self.mesh is not None
                     else [dev])
            for card in cards:
                if card.type == "cuda":
                    torch.cuda.synchronize(card)
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

        if self.fplan.data_axis is not None:
            # data parallelism: one launch a row shard, at its home, over
            # the forest's replica there; the CSR gather runs inside, so
            # the compact tile exists only at the local batch
            replicas = self.fplan.replicas(forest)
            gather = self._local_gather(*sparse_aux) \
                if sparse_aux is not None else None

            def body(x_local):
                f = replicas[physical(device_of(x_local))]
                if gather is not None:
                    x_local = gather(x_local)
                return predict_sum(f, x_local)

            def udf_mesh(state):
                state = dict(state)
                state["pred"] = map_gathered(
                    map_shards(state.pop("x"), body),
                    lambda s: post.postprocess(s, **meta), self.store.device)
                return state

            return [
                Operator("scan", lambda s: s),
                Operator("transform:forest-udf@shard_map", udf_mesh,
                         devices=self.fplan.positions),
                Operator("write", lambda s: s, breaker=True),
            ]

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

        def postprocess_op(state):
            state = dict(state)
            state["pred"] = map_gathered(
                state.pop("summed"), lambda s: post.postprocess(s, **meta),
                self.store.device)
            return state

        if self.fplan.model_axis is not None:
            return self._rel_mesh_ops(mat, predict_sum, postprocess_op)

        per = forest.num_trees // n_parts
        parts = [tree_slice(forest, p * per, per) for p in range(n_parts)]
        for p, part in enumerate(parts):
            share_packed_nodes(part, mat.aux["nodes"][p * per:(p + 1) * per])
        # the partitions at each card a row shard lives on (on a mesh with
        # no model axis); off-mesh, or on the store's card, themselves
        part_sets = {physical(forest.device): parts}
        if self.fplan.data_axis is not None:
            for dev in self.fplan.data_devices:
                dev = physical(dev)
                if dev not in part_sets:
                    part_sets[dev] = [replica(p, dev) for p in parts]
                    for p in part_sets[dev]:
                        packed_nodes(p)

        def partials_of(x):
            """partial[p, b] = sum of partition p's tree scores on sample
            b, one kernel launch per partition."""
            partials = torch.empty((n_parts, x.shape[0]),
                                   dtype=torch.float32, device=x.device)
            for p, part in enumerate(part_sets[physical(x.device)]):
                partials[p] = predict_sum(part, x)
            return partials

        def fold(partials):
            # sequential fold in partition order, as the reference does
            summed = partials[0]
            for p in range(1, partials.shape[0]):
                summed = summed + partials[p]
            return summed

        def cross_product(state):
            """CROSS-PRODUCT(tree partition, sample block) -> partials
            [n_parts, B] (a row shard's on a data mesh)."""
            state = dict(state)
            state["partials"] = map_shards(state["x"], partials_of)
            return state

        def aggregate(state):
            state = dict(state)
            state["summed"] = map_shards(state.pop("partials"), fold)
            return state

        ops = [Operator("scan", lambda s: s)]
        if "inv_map" in mat.aux:
            # the gather shares the cross-product stage: the compact tile
            # is its input, not a new materialization boundary
            ops.append(self._gather_operator(mat.aux["inv_map"],
                                             mat.aux["f_used"]))
        # on a data-only mesh these run shard by shard (positions; 1
        # off-mesh)
        dv = self.fplan.positions
        return ops + [
            Operator("cross-product:partial-agg", cross_product,
                     breaker=True, devices=dv),
            Operator("aggregate", aggregate, breaker=True, devices=dv),
            Operator("postprocess", postprocess_op),
            Operator("write", lambda s: s, breaker=True),
        ]

    def _rel_mesh_ops(self, mat: MaterializedModel, predict_sum,
                      postprocess_op):
        """The relation-centric plan body on a model mesh: position (d, m)
        runs ONE ``predict_sum`` over tree shard m and row shard d (the
        CSR gather inside, once a card), and the row shard's ``n_model``
        partials are folded at its home in model order, the mesh-less
        aggregate's association (module note)."""
        fplan = self.fplan
        shards = mat.aux["tree_shards"]
        gather = self._local_gather(mat.aux["inv_map"], mat.aux["f_used"]) \
            if "inv_map" in mat.aux else None
        grid = [[physical(fplan.position(d, m)) for m in range(fplan.n_model)]
                for d in range(fplan.n_data)]

        def row_shard(d: int, x_local):
            home = grid[d][0]
            tiles: dict[torch.device, Any] = {}
            summed = None
            for m, dev in enumerate(grid[d]):
                tile = tiles.get(dev)
                if tile is None:
                    tile = place(x_local, dev)
                    if gather is not None:
                        tile = gather(tile)
                    tiles[dev] = tile
                part = place(predict_sum(shards[m][dev], tile), home)
                summed = part if summed is None else summed + part
            return summed

        def cross_product(state):
            state = dict(state)
            x = state.pop("x")
            if not isinstance(x, RowShards):     # a mesh with no data axis
                x = RowShards([x])
            state["summed"] = x.map(row_shard)
            return state

        return [
            Operator("scan", lambda s: s),
            Operator("cross-product:psum-agg", cross_product, breaker=True,
                     devices=fplan.positions),
            Operator("postprocess", postprocess_op),
            Operator("write", lambda s: s, breaker=True),
        ]

    def _resolve_n_parts(self, forest: Forest, algorithm: str,
                         n_parts: int | None) -> int:
        """Tree-partition count of the rel plans: on a model mesh, the
        ``model`` axis (one tree shard a position along it; an explicit
        ``n_parts`` is ignored); else an explicit ``n_parts`` wins; kernel
        algorithms take one partition per kernel tree tile
        (``ceil(T / default_tree_block)``, sized for the fused or the raw
        kernel it will launch); the eager oracles take ``min(4, T)``."""
        if self.fplan.model_axis is not None:
            return self.fplan.n_model
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
    def train(self, dataset: str, cfg, **kw):
        """Train a forest ON a stored dataset (``db/train.py``), streaming
        every pass through the tier ladder and the scan executor the
        plans use.  The forest lands in the store's model catalog under
        ``model_name`` (default ``f"{dataset}:model"``), on the store's
        device.  Returns a ``TrainResult`` whose forest equals
        ``core.train.train_forest`` on the resident rows bit for bit,
        given the same bin edges."""
        from repro_torch.db.train import train_streaming
        return train_streaming(self, dataset, cfg, **kw)

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
        unit = self.fplan.n_data
        if batch_pages is None:
            batch_pages = ds.num_pages
            if ds.tier != "device":
                # in data-axis units, rounded down, so the round-up below
                # cannot push two buffers past the budget
                budget = self.store.device_budget_bytes
                target = budget // 2 if budget else DEFAULT_STREAM_BATCH_BYTES
                fit = target // max(ds.page_nbytes, 1)
                batch_pages = min(ds.num_pages,
                                  max(unit, fit // unit * unit))
        if unit > 1:
            # whole data units: the store pads num_pages to one
            batch_pages = min(-(-batch_pages // unit) * unit, ds.num_pages)
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
                    a.nbytes for a in mat.forest.arrays().values()),
                devices=(self.fplan.positions
                         if self.fplan.model_axis is not None else 1))]
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
            qplan.stages, sharding=self.store.data_sharding(),
            prefetch_depth=prefetch_depth, injector=injector,
            retry_policy=retry_policy, deadline=deadline,
            min_batch_pages=unit)
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
            degraded=degraded, decision=decision,
            mesh_devices=self.fplan.positions)

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
        ``register_model``.  ``algorithm`` None is ``infer``'s.

        On a data mesh ``B`` must divide the ``data`` axis: the batch is
        split into row shards like a scan batch, and the predictions come
        back gathered on the store's device."""
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
        nd = self.fplan.n_data
        if nd > 1 and B % nd:
            raise ValueError(f"row batch {B} must divide the mesh data axis "
                             f"({nd}): pick bucket sizes that are axis "
                             f"multiples")
        sharding = self.store.data_sharding()
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
            state, _ = run_stages(qplan.stages, {
                "x": x if sharding is None else sharding.split(x)})
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
