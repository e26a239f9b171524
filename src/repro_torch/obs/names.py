"""The port's catalog of exported span / event / metric names.

Names are string literals at the call sites; this module is the list of
what the port's observability plane emits, and every name below appears,
in backticks, in ``docs/torch_observability.md`` (``tests/
test_torch_obs.py`` checks both).  It is the port's own catalog, not the
reference's ``repro/obs/names.py``: a name stays out until the port emits
it.  ``SPAN_PREFIXES`` covers the dynamically named per-stage spans
(``stage:<stage name>``).
"""

from __future__ import annotations

__all__ = ["SPAN_NAMES", "SPAN_PREFIXES", "EVENT_NAMES", "METRIC_NAMES"]

#: every statically named span the port can emit
SPAN_NAMES = (
    # query engine (db/query.py)
    "query.infer",
    "query.infer_rows",
    "plan.build",
    "plan.partition",
    "query.write",
    # streaming scan executor (db/executor.py)
    "scan.execute",
    "scan.batch",
    "scan.disk_read",
    "scan.dma_in",
    "scan.transfer_wait",
    "scan.compute",
    "scan.drain_submit",
    "scan.drain_write",
    # tensor-block store (db/store.py)
    "store.put",
    "store.put_sparse",
    "store.move",
    # external loaders (db/loader.py)
    "load.parse",
    "load.convert",
    "load.transfer",
    # forest serving plane (serve/forest.py)
    "serve.tick",
    "serve.coalesce",
    # LM serving engine (serve/engine.py)
    "serve.prefill",
    "serve.execute",
    # cost-based optimizer (db/optimizer.py)
    "optimizer.decide",
    "optimizer.autotune",
    # in-database streamed training (db/train.py)
    "train.forest",
    "train.sketch",
    "train.bin_ingest",
    "train.level",
)

#: prefixes of dynamically named spans
SPAN_PREFIXES = (
    "stage:",            # per-pipeline-stage spans (db/operators.Stage.run)
)

#: every span-event (instant) name
EVENT_NAMES = (
    "plan.cache",        # compiled-plan cache consulted (hit= attr)
    # the fault plane (db/faults.py, db/executor.py)
    "fault.injected",    # an armed site fired (site=, call=)
    "retry",             # a retry re-attempt (site=, attempt=)
    "degrade.sync_drain",  # the drain fell back to the synchronous drain
    "batch.resubmit",    # a batch re-enqueued or halved (site=)
    "deadline.hit",      # the scan stopped at its deadline
    "serve.shed",        # an admission timeout demoted a request to batch
    "optimizer.decision",  # a decision was made and persisted (cell attrs)
)

#: every process-global METRICS counter, and the serving plane's
#: per-engine / per-model instruments
METRIC_NAMES = (
    # compiled-plan cache (db/query.py)
    "plan.cache_hits",
    "plan.cache_misses",
    # streaming scan rollups (db/executor.py)
    "scan.batches",
    "scan.bytes_streamed",
    "scan.retries",
    "scan.faults_injected",
    "scan.batch_resubmits",
    "scan.degraded_to_sync",
    "scan.deadline_hits",
    # store / loader (db/store.py, db/loader.py)
    "store.puts",
    "store.moves",
    "load.external_loads",
    # forest serving plane (serve/forest.py; per-engine / per-model
    # registries except serve.queue_depth, the process-global arrival-load
    # gauge the router reads)
    "serve.requests",
    "serve.shed",
    "serve.queue_wait_s",
    "serve.e2e_latency_s",
    "serve.queue_depth",
    "serve.ticks",
    "serve.coalesce_width",
    "serve.padding_rows",
    "serve.plan_hits",
    "serve.plan_misses",
    # cost-based optimizer (db/optimizer.py)
    "optimizer.decisions",
    "optimizer.decision_cache_hits",
    "optimizer.decision_cache_misses",
    "optimizer.autotune_runs",
    "optimizer.measurements",
    # in-database streamed training (db/train.py)
    "train.runs",
    "train.trees_grown",
    "train.level_scans",
)
