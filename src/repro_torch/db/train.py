"""In-database streamed training: the other half of the lifecycle (torch).

Mirrors ``repro/db/train.py``.  The ``StreamingScanExecutor`` and the
tiered ``TensorBlockStore`` that page inference batches onto the device
also drive ``core.train.grow_forest_scanned``'s per-level scans, so
training reads host-, disk- and device-tier pages, dense or CSR, as
inference does, and the trained ``Forest`` lands in the store's model
catalog, where the serving plane and the optimizer find it.

Three streaming passes, each through the executor (at most two live page
buffers, the scan's spans and counters):

  1. SKETCH (``train.sketch``; skipped when the caller gives edges): a
     global-stride row sample, taken batch by batch (CSR pages densified
     per batch to the full feature space, missing as NaN), capped at
     ``sketch_rows`` rows, finalised into bin edges by
     ``core.train.edges_from_sample``.
  2. BIN INGEST (``train.bin_ingest``): each batch is binned on the
     device (``core.train.bin_features``, NaN -> the MISSING slot) and
     written through ``store.stream_writer`` into a new relation
     ``<dataset>::bins``: uint8, the same page geometry, on the source's
     tier by default, its tail padded with the MISSING bin.  The device
     batch is copied straight into the tier's storage (on the disk tier,
     the mmap), so the binned matrix never exists whole in host memory.
  3. LEVEL SCANS (``train.level``, ``max_depth + 1`` a tree): each scan
     streams the bins relation.  A routing stage updates the node-of
     frontier on the device (``core.train.route_level``), fed each
     batch's slice of the frontier through the executor's ``extras``; the
     new frontier drains through the executor (``result_key="node_of"``,
     int32); the ``on_batch`` hook copies the batch's bins and frontier
     to the host and accumulates the level's histograms there, in global
     row order (``core.train.hist_update``).

BIT-IDENTITY: given the same bin edges, the streamed trainer gives a
forest bit-identical to ``core.train.train_forest`` on any tier, format
and batch geometry: routing is exact, ``np.add.at`` adds consecutive row
slices in the order of one whole-array call, and page padding rows carry
g = h = 0.  The level scans run with the fault ladders off: an
injector-free plan is never reordered or split.

The per-level histograms are host state (``2^level x F x (num_bins + 1)``
float64, sized by the model, not the data).

On a mesh (reference ``train.py:134-140, 178-209, 345``) every pass runs
over the store's ``data`` axis: batches are whole data units
(``_mesh_round``, and the halving floor), the executor splits each into
row shards, and the densify, binning and routing stages run shard by
shard at each shard's home (the routed frontier gathered at the store's
device); the hooks take the shards in row order, so the histograms add
the same rows in the same order and the forest is the mesh-less one bit
for bit.  The forest lands in the model catalog as one copy on the
store's device: where the reference lays its tree blocks over ``model``
here (``shard_forest``), the port's relation-centric plans place them in
their partition stage and keep them with the plan, so a dropped model's
shards go with its plans.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.forest import Forest
from repro_torch.core.reuse import fingerprint_forest
from repro_torch.core.train import (TrainConfig, bin_features,
                                    edges_from_sample, grow_forest_scanned,
                                    hist_update, route_level)
from repro_torch.db.executor import (DEFAULT_STREAM_BATCH_BYTES, ScanStats,
                                     StreamingScanExecutor)
from repro_torch.db.operators import Operator, split_into_stages
from repro_torch.db.shards import map_shards, place, row_offsets, to_host
from repro_torch.kernels.gather import csr_block_to_dense, gather_inverse_map
from repro_torch.obs import METRICS, TRACER

__all__ = ["TrainResult", "train_streaming", "DEFAULT_SKETCH_ROWS"]

#: cap on the rows the quantile sketch keeps (its host footprint is
#: ``min(num_rows, sketch_rows) * F`` floats, never the full matrix)
DEFAULT_SKETCH_ROWS = 65536


@dataclasses.dataclass
class TrainResult:
    """What ``ForestQueryEngine.train`` returns.  ``scan_stats`` holds one
    ``ScanStats`` per executor pass in order: the sketch (if run), the
    bin ingest, then every level scan."""

    forest: Forest
    model_name: str
    fingerprint: str
    edges: np.ndarray                 # [F, num_bins - 1] bin boundaries
    bins_dataset: str                 # the in-store binned relation
    cfg: TrainConfig
    scan_stats: list[ScanStats]
    tier: str                         # the source dataset's tier
    storage_format: str               # "dense" | "csr"
    num_scans: int = 0                # executor passes (sketch, bins too)
    sketch_rows_used: int = 0         # rows the sketch kept (0: edges given)
    wall_s: float = 0.0
    #: the trainer touches per-batch blocks and the capped sketch only;
    #: nothing here materialises the [N, F] matrix
    materialized_full_x: bool = False
    #: wall seconds of each pass: "sketch", "bin_ingest", "levels"
    pass_s: dict = dataclasses.field(default_factory=dict)
    #: one entry a level scan: its ``level`` (0 = no routing), ``route_s``
    #: (the routing stage's seconds: CUDA-event device time on the card)
    #: and ``hist_s`` (host seconds in ``hist_update``)
    levels: list = dataclasses.field(default_factory=list)


def _auto_batch_pages(engine, ds) -> int:
    """``ForestQueryEngine._infer``'s default batch: the whole table on the
    device tier, else half the device budget (or the fixed default) a
    batch, in data-axis units rounded down, and at least one unit."""
    if ds.tier == "device":
        return ds.num_pages
    budget = engine.store.device_budget_bytes
    target = budget // 2 if budget else DEFAULT_STREAM_BATCH_BYTES
    unit = engine.fplan.n_data
    fit = target // max(ds.page_nbytes, 1)
    return min(ds.num_pages, max(unit, fit // unit * unit))


def _mesh_round(engine, ds, batch_pages: int) -> int:
    """Page batches in whole data-axis units (``_infer``'s rule)."""
    nd = engine.fplan.n_data
    if nd > 1:
        batch_pages = min(-(-batch_pages // nd) * nd, ds.num_pages)
    return batch_pages


def _source_ops(ds) -> list[Operator]:
    """Stage prefix that turns a source block into dense [rows, F] float:
    nothing for the dense plane; for CSR pages a per-batch densify to the
    FULL feature space with NaN fill, so missing bins to MISSING."""
    if ds.storage_format != "csr":
        return []
    F = ds.num_features
    inv_full = gather_inverse_map(np.arange(F), F, device=ds.device)

    def densify(state):
        state = dict(state)
        state["x"] = map_shards(state["x"], lambda block: csr_block_to_dense(
            block, place(inv_full, block.tensors()[0].device), F))
        return state

    return [Operator("train:densify-csr", densify)]


def train_streaming(engine, dataset: str, cfg: TrainConfig, *,
                    model_name: str | None = None,
                    edges: np.ndarray | None = None,
                    batch_pages: int | None = None,
                    prefetch_depth: int = 2,
                    bins_tier: str | None = None,
                    sketch_rows: int = DEFAULT_SKETCH_ROWS) -> TrainResult:
    """Train ``cfg``'s forest ON a stored dataset, streaming every pass.

    ``edges`` skips the sketch (parity tests give the resident trainer the
    same edges); ``bins_tier`` places the binned relation (default: the
    source's tier); ``batch_pages`` / ``prefetch_depth`` drive the
    executor as in ``engine.infer``.  The forest is pinned in the store's
    model catalog under ``model_name`` (default ``f"{dataset}:model"``);
    re-pinning a name sweeps the replaced forest's compiled plans and
    optimizer decisions (``store.put_model``)."""
    store = engine.store
    ds = store.get(dataset)
    fmt, tier = ds.storage_format, ds.tier
    N, F = ds.num_rows, ds.num_features
    if ds.labels is None:
        raise ValueError(f"dataset {dataset!r} has no labels to train on")
    if cfg.num_bins > 255:
        raise ValueError(
            f"num_bins must fit the uint8 bins relation (<= 255 with the "
            f"MISSING slot), got {cfg.num_bins}")
    y = ds.labels.cpu().numpy().astype(np.float32)[:N]
    name = model_name or f"{dataset}:model"
    bins_name = f"{dataset}::bins"
    dev = store.device
    R = ds.page_rows
    scan_stats: list[ScanStats] = []
    pass_s: dict[str, float] = {}
    levels: list[dict] = []
    t0 = time.perf_counter()
    METRICS.counter("train.runs").inc()

    def executor(ops, result_key=None):
        return StreamingScanExecutor(split_into_stages(ops),
                                     sharding=store.data_sharding(),
                                     prefetch_depth=prefetch_depth,
                                     result_key=result_key,
                                     min_batch_pages=engine.fplan.n_data)

    with TRACER.span("train.forest", dataset=dataset, model=name,
                     model_type=cfg.model_type, num_trees=cfg.num_trees,
                     tier=tier, storage_format=fmt) as root:
        src_bp = _mesh_round(engine, ds, batch_pages if batch_pages
                             is not None else _auto_batch_pages(engine, ds))

        # -- pass 1: quantile sketch -> bin edges --------------------------
        sketch_used = 0
        if edges is None:
            t_pass = time.perf_counter()
            stride = max(1, -(-N // max(1, int(sketch_rows))))
            sample_parts: list[np.ndarray] = []

            def sketch_batch(first: int, n: int, state) -> None:
                for off, xs in row_offsets(state["x"]):
                    lo = first * R + off
                    idx = np.arange(lo, min(lo + xs.shape[0], N))
                    sel = idx[(idx % stride) == 0] - lo
                    if sel.size:
                        rows = torch.as_tensor(sel, device=xs.device)
                        sample_parts.append(xs[rows].cpu().numpy())

            with TRACER.span("train.sketch", dataset=dataset,
                             stride=stride):
                _, _, st = executor(_source_ops(ds)).execute(
                    ds, src_bp, on_batch=sketch_batch)
            scan_stats.append(st)
            sample = (np.concatenate(sample_parts) if sample_parts
                      else np.zeros((0, F), np.float32))
            sketch_used = int(sample.shape[0])
            edges = edges_from_sample(sample, cfg.num_bins)
            pass_s["sketch"] = time.perf_counter() - t_pass
        edges = np.asarray(edges, np.float32)
        edges_t = torch.from_numpy(edges).to(dev)

        # -- pass 2: streamed binning into the <dataset>::bins relation ----
        t_pass = time.perf_counter()
        writer = store.stream_writer(
            bins_name, num_rows=N, num_features=F, dtype=torch.uint8,
            page_rows=R, tier=bins_tier if bins_tier is not None else tier,
            fill=cfg.num_bins)

        def bin_op(state):
            state = dict(state)
            state["bins"] = map_shards(state["x"], lambda xs: bin_features(
                xs, place(edges_t, xs.device)).to(torch.uint8))
            return state

        def ingest_batch(first: int, n: int, state) -> None:
            lo = first * R
            real = min(lo + n * R, N) - lo
            for off, bins in row_offsets(state["bins"]):
                if off < real:
                    writer.write(bins[:real - off])

        try:
            with TRACER.span("train.bin_ingest", dataset=dataset,
                             bins=bins_name):
                _, _, st = executor(
                    _source_ops(ds) + [Operator("train:bin-features",
                                                bin_op)]
                ).execute(ds, src_bp, on_batch=ingest_batch)
        except BaseException:
            writer.abort()
            raise
        scan_stats.append(st)
        bins_ds = writer.close()
        pass_s["bin_ingest"] = time.perf_counter() - t_pass
        total = bins_ds.num_pages * bins_ds.page_rows
        bins_bp = _mesh_round(engine, bins_ds,
                              batch_pages if batch_pages is not None
                              else _auto_batch_pages(engine, bins_ds))

        # -- pass 3..: per-level scans over the bins relation ---------------
        def run_scan(node_of, *, route=None, hist=None):
            ops: list[Operator] = []
            if route is not None:
                level_r, feat, sbin, dleft, term = route
                feat_t = torch.as_tensor(feat, device=dev)
                sbin_t = torch.as_tensor(sbin, device=dev)
                dleft_t = torch.as_tensor(dleft, device=dev)
                term_t = torch.as_tensor(term, device=dev)

                def route_op(state):
                    state = dict(state)
                    x, node = state["x"], state["node_of"]
                    routed = []
                    for off, xs in row_offsets(x):
                        d = xs.device
                        routed.append(route_level(
                            xs, place(node[off: off + xs.shape[0]], d),
                            place(feat_t, d), place(sbin_t, d),
                            place(dleft_t, d), place(term_t, d),
                            level=level_r, num_bins=cfg.num_bins))
                    # gathered at the store's device, in row order
                    state["node_of"] = torch.cat(
                        [place(r, node.device) for r in routed])
                    return state

                ops.append(Operator("train:route-level", route_op))

            hg = hh = None
            if hist is not None:
                g, h, level_h = hist
                hg = np.zeros(((1 << level_h), F, cfg.num_bins + 1),
                              np.float64)
                hh = np.zeros_like(hg)

            def extras(first: int, n: int) -> dict:
                lo = first * R
                return {"node_of": torch.from_numpy(
                    node_of[lo: lo + n * R]).to(dev)}

            hist_s = [0.0]

            def on_batch(first: int, n: int, state) -> None:
                lo = first * R
                nb = (to_host(state["node_of"]) if route is not None
                      else node_of[lo: lo + n * R])
                bins_np = to_host(state["x"])
                t_h = time.perf_counter()
                hist_update(hg, hh, bins_np, nb,
                            g[lo: lo + n * R], h[lo: lo + n * R])
                hist_s[0] += time.perf_counter() - t_h

            ex = executor(ops, "node_of" if route is not None else None)
            with TRACER.span("train.level",
                             level=route[0] + 1 if route else 0,
                             hist=hist is not None):
                out, reports, st = ex.execute(
                    bins_ds, bins_bp,
                    extras=extras if route is not None else None,
                    on_batch=on_batch if hist is not None else None)
            scan_stats.append(st)
            levels.append(dict(level=route[0] + 1 if route else 0,
                               route_s=sum(r.seconds for r in reports),
                               hist_s=hist_s[0]))
            METRICS.counter("train.level_scans").inc()
            hists = (hg, hh) if hist is not None else None
            if route is None:
                return node_of, hists
            new_node = np.zeros_like(node_of)
            new_node[:N] = out.cpu().numpy()   # padding rows stay inert
            return new_node, hists

        t_pass = time.perf_counter()
        forest = grow_forest_scanned(run_scan, y=y, num_rows=N,
                                     num_features=F, total_rows=total,
                                     edges=edges, cfg=cfg, device=dev)
        pass_s["levels"] = time.perf_counter() - t_pass
        METRICS.counter("train.trees_grown").inc(cfg.num_trees)

        # -- land it in the store's model catalog ---------------------------
        fp = fingerprint_forest(forest)
        store.put_model(name, forest, fingerprint=fp, trained_on=dataset,
                        bins_dataset=bins_name, num_bins=cfg.num_bins,
                        streamed=True)
        root.set(fingerprint=fp, scans=len(scan_stats))

    return TrainResult(
        forest=forest, model_name=name, fingerprint=fp, edges=edges,
        bins_dataset=bins_name, cfg=cfg, scan_stats=scan_stats,
        tier=tier, storage_format=fmt, num_scans=len(scan_stats),
        sketch_rows_used=sketch_used, wall_s=time.perf_counter() - t0,
        pass_s=pass_s, levels=levels)
