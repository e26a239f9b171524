"""Port parity: the host and disk tiers of the store and the streaming scan.

The port on the CPU device against itself and against the reference:

  * ``tier="auto"`` cascades device budget -> host budget -> disk, with
    per-tier accounting and catalog tiers; a disk ``page_slice`` is a lazy
    memmap view;
  * host- and disk-tier predictions are bit-identical to the port's device
    tier at the same ``batch_pages``, for udf, rel and rel+reuse over all
    seven algorithm names, and match the reference engine's host and disk
    tiers under the parity contract (bitwise on integer leaves, 1e-6
    otherwise);
  * the off-device default batch comes from the device budget or from
    ``DEFAULT_STREAM_BATCH_BYTES``; at most 2 page buffers are in flight;
    depth 1 and depth 2 agree bit for bit;
  * ``move`` round trips and rolls back on a failed spill write;
    ``drop`` and re-put, spill files, ``stream_writer`` / ``put_stream``;
  * the scan's reader thread stops, and its errors reach the caller, on
    every exit.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.reuse import ModelReuseCache as JCache
from repro.db.query import ForestQueryEngine as JEngine
from repro.db.store import TensorBlockStore as JStore
from repro_torch.db import store as store_mod
from repro_torch.db.faults import ScanFault
from repro_torch.db.executor import (MAX_IN_FLIGHT, ScanSource,
                                     StreamingScanExecutor)
from repro_torch.db.operators import Operator, split_into_stages
from repro_torch.db.query import ForestQueryEngine
from repro_torch.db.store import TensorBlockStore

from test_torch_forest import port_forest
from test_torch_query import PAGE, _forest, _rows
from test_torch_rel import ALGORITHMS

TIERS = ("device", "host", "disk")
FUSED = "predicated_pallas_fused"
N = 150                                        # _rows(): 5 pages of 32


def _store(x, **kw):
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE, **kw)
    for tier in TIERS:
        store.put(tier, x, tier=tier)
    return store


def _reader_threads() -> list[threading.Thread]:
    return [t for t in threading.enumerate() if t.name == "scan-reader"]


# -- the ladder ---------------------------------------------------------------


def test_auto_cascade_device_host_disk_and_accounting():
    x = np.ones((256, 8), np.float32)
    store = TensorBlockStore(device="cpu", default_page_rows=32,
                             device_budget_bytes=int(x.nbytes * 1.5),
                             host_budget_bytes=int(x.nbytes * 1.5))
    a, b, c = store.put("a", x), store.put("b", x), store.put("c", x)
    assert (a.tier, b.tier, c.tier) == TIERS
    assert isinstance(a.data, torch.Tensor) and isinstance(b.data,
                                                           torch.Tensor)
    assert isinstance(c.data, np.memmap)
    assert store.device_nbytes == a.nbytes == x.nbytes
    assert store.host_nbytes == b.nbytes and store.disk_nbytes == c.nbytes
    assert [store.catalog()[k]["tier"] for k in "abc"] == list(TIERS)
    assert store.put("d", x).tier == "disk"      # the ladder has no floor
    assert store.put("e", x, tier="device").tier == "device"
    assert store.put("f", x, tier="disk").tier == "disk"
    # no budget: every auto ingest stays on the device, as before the tiers
    plain = TensorBlockStore(device="cpu")
    assert plain.put("g", x).tier == "device"
    with pytest.raises(ValueError, match="unknown tier"):
        plain.put("h", x, tier="hbm")


def test_datasets_are_scan_sources_on_every_tier():
    store = _store(_rows(0))
    for tier in TIERS:
        ds = store.get(tier)
        assert isinstance(ds, ScanSource), tier
        assert ds.page_nbytes == PAGE * ds.num_features * 4
        assert ds.pageable == (tier == "disk")
        out = torch.empty((64, 9))
        got = ds.to_device(ds.page_slice(1, 2), out)
        assert got is out
        assert torch.equal(got.nan_to_num(), store.get("device").data[
            32:96].nan_to_num())


def test_disk_page_slice_is_a_lazy_memmap_view():
    x = _rows(1)
    store = _store(x)
    ds = store.get("disk")
    blk = ds.page_slice(2, 3)
    assert isinstance(blk, np.memmap) and blk.base is not None
    assert np.shares_memory(blk, ds.data)
    np.testing.assert_array_equal(np.asarray(blk)[:N - 2 * PAGE],
                                  x[2 * PAGE:])
    assert np.isnan(np.asarray(blk)[N - 2 * PAGE:]).all()  # pad rows
    out = torch.empty((3 * PAGE, 9))
    assert ds.to_device(blk, out) is out
    assert torch.equal(out.nan_to_num(), torch.from_numpy(
        np.asarray(blk)).nan_to_num())


def test_reput_unlinks_and_never_truncates_a_mapped_file():
    x = _rows(2)
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    old = store.put("d", x, tier="disk").data
    store.put("d", 2 * x, tier="disk")
    np.testing.assert_array_equal(np.asarray(old)[:N], x)   # still readable
    np.testing.assert_array_equal(np.asarray(store.get("d").data)[:N], 2 * x)
    assert len(os.listdir(store.spill_dir)) == 1


# -- the scan: tiers against the device tier and the reference ----------------


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("plan", ["udf", "rel", "rel+reuse"])
def test_off_device_tiers_bit_identical_to_device(plan, algorithm):
    x = _rows(3)
    tf = port_forest(_forest(integer_leaves=False, T=12))
    engine = ForestQueryEngine(_store(x))
    kw = dict(algorithm=algorithm, plan=plan, batch_pages=2, n_parts=3)
    ref = engine.infer("device", tf, **kw)
    assert ref.scan.bytes_streamed == 0 and ref.tier == "device"
    for tier in ("host", "disk"):
        for depth in (2, 1):
            res = engine.infer(tier, tf, prefetch_depth=depth, **kw)
            assert res.tier == res.scan.tier == tier
            assert res.scan.batches == 3
            assert res.scan.bytes_streamed == 5 * PAGE * 9 * 4
            assert res.scan.max_in_flight == depth
            assert torch.equal(res.predictions, ref.predictions), \
                (tier, depth)


@pytest.mark.parametrize("tier", ["host", "disk"])
@pytest.mark.parametrize("plan,algorithm,integer_leaves", [
    ("udf", "predicated_pallas_fused", True),
    ("udf", "quickscorer_pallas_fused", False),
    ("rel", "predicated_pallas", True),
    ("rel+reuse", "hummingbird_pallas", False),
    ("rel+reuse", "predicated", True)])
def test_tiers_match_the_reference_engine(tier, plan, algorithm,
                                          integer_leaves):
    x = _rows(4)
    jf = _forest(integer_leaves=integer_leaves)
    jstore = JStore(default_page_rows=PAGE)
    jstore.put("t", x, tier=tier)
    jengine = JEngine(jstore, reuse_cache=JCache(), plan_cache=JCache())
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    store.put("t", x, tier=tier)
    engine = ForestQueryEngine(store)
    kw = dict(algorithm=algorithm, plan=plan, batch_pages=2, n_parts=3)
    want = jengine.infer("t", jf, **kw)
    got = engine.infer("t", port_forest(jf), **kw)
    assert got.tier == want.tier == tier
    assert got.scan.batches == want.scan.batches == 3
    assert got.scan.bytes_streamed == want.scan.bytes_streamed
    w, g = np.asarray(want.predictions), got.predictions.numpy()
    assert g.shape == (N,) and np.isfinite(g).all()
    if integer_leaves:
        assert np.array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_default_batch_is_half_the_device_budget(tier):
    x = _rows(5)
    tf = port_forest(_forest(integer_leaves=False))
    page = PAGE * 9 * 4
    budget = 4 * page + page // 2              # two buffers of 2 pages fit
    host_budget = None if tier == "host" else 1
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE,
                             device_budget_bytes=budget,
                             host_budget_bytes=host_budget)
    ds = store.put("t", x)
    assert ds.tier == tier
    res = ForestQueryEngine(store).infer("t", tf, algorithm=FUSED)
    assert res.scan.batch_pages == 2 and res.scan.batches == 3
    assert 2 * res.scan.batch_pages * ds.page_nbytes <= budget
    ref = ForestQueryEngine(_store(x)).infer("device", tf, algorithm=FUSED,
                                             batch_pages=2)
    assert torch.equal(res.predictions, ref.predictions)


def test_default_batch_without_budget_uses_stream_bytes(monkeypatch):
    import repro_torch.db.query as q
    x = _rows(6)
    tf = port_forest(_forest(integer_leaves=False))
    store = _store(x)
    engine = ForestQueryEngine(store)
    monkeypatch.setattr(q, "DEFAULT_STREAM_BATCH_BYTES",
                        3 * store.get("host").page_nbytes)
    assert engine.infer("host", tf, algorithm=FUSED).scan.batch_pages == 3
    assert engine.infer("device", tf, algorithm=FUSED).scan.batch_pages == 5
    # floored at one page
    monkeypatch.setattr(q, "DEFAULT_STREAM_BATCH_BYTES", 1)
    res = engine.infer("disk", tf, algorithm=FUSED)
    assert res.scan.batch_pages == 1 and res.scan.batches == 5


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_at_most_two_page_buffers_and_depths_agree(tier):
    """A probe stage records each batch's page buffer: two buffers take
    turns at depth 2, one serves every batch at depth 1."""
    x = _rows(7)
    ds = _store(x).get(tier)
    seen = []

    def probe(state):
        seen.append(state["x"].data_ptr())
        return state

    def udf(state):
        state = dict(state)
        state["pred"] = torch.nansum(state["x"], dim=1)
        return state

    stages = split_into_stages([Operator("probe", probe),
                                Operator("udf", udf),
                                Operator("write", lambda s: s,
                                         breaker=True)])
    outs = {}
    for depth in (2, 1):
        seen.clear()
        out, _, stats = StreamingScanExecutor(
            stages, prefetch_depth=depth).execute(ds, 1)
        assert stats.batches == len(seen) == 5
        assert stats.max_in_flight == depth <= MAX_IN_FLIGHT
        assert len(set(seen)) == depth
        assert not stats.drain_async and not stats.pinned_staging
        outs[depth] = out
    assert torch.equal(outs[1], outs[2])
    assert torch.equal(outs[1], torch.nansum(torch.from_numpy(x), dim=1))


def test_a_slow_disk_read_still_counts_two_buffers(monkeypatch):
    """A page buffer is in flight from when the reader starts to fill it:
    with each disk read far slower than the stages, the stages release
    batch i's buffer before batch i+1's read ends, and depth 2 still
    counts two buffers."""
    ds = _store(_rows(7)).get("disk")
    read = type(ds).read_pages

    def slow_read(self, block, out):
        time.sleep(0.05)
        return read(self, block, out)

    monkeypatch.setattr(type(ds), "read_pages", slow_read)

    def udf(state):
        state = dict(state)
        state["pred"] = torch.nansum(state["x"], dim=1)
        return state

    stages = split_into_stages([Operator("udf", udf),
                                Operator("write", lambda s: s,
                                         breaker=True)])
    for depth in (2, 1):
        _, _, stats = StreamingScanExecutor(
            stages, prefetch_depth=depth).execute(ds, 2)
        assert stats.batches == 3 and stats.max_in_flight == depth


def test_one_batch_scan_takes_one_buffer():
    store = _store(_rows(8))
    res = ForestQueryEngine(store).infer(
        "disk", port_forest(_forest(integer_leaves=False)), algorithm=FUSED,
        batch_pages=5)
    assert res.scan.batches == 1 and res.scan.max_in_flight == 1


def test_inline_drain_hides_nothing_on_the_cpu():
    store = _store(_rows(9))
    engine = ForestQueryEngine(store)
    tf = port_forest(_forest(integer_leaves=False))
    for depth in (1, 2):
        s = engine.infer("host", tf, algorithm=FUSED, batch_pages=2,
                         prefetch_depth=depth).scan
        assert s.drain_s > 0 and s.drain_wait_s >= s.drain_s
        assert s.drain_overlap_s == 0.0 and not s.drain_async
        assert s.transfer_wait_s > 0 and s.transfer_issue_s > 0


# -- the reader thread --------------------------------------------------------


class _Delegate:
    """A dataset seen through a wrapper that overrides some of it."""

    def __init__(self, ds):
        self.ds = ds

    def __getattr__(self, name):
        return getattr(self.ds, name)


class _FailingSource(_Delegate):
    """A dataset whose third page read raises."""

    def page_slice(self, first_page, num_pages):
        if first_page >= 2:
            raise OSError("page read failed")
        return self.ds.page_slice(first_page, num_pages)


@pytest.mark.parametrize("depth", [1, 2])
def test_reader_error_reaches_the_caller_and_the_thread_stops(depth):
    """A failing page read is an ``OSError`` at the ``disk_page_read``
    site: its batch goes once to the back of the plan, then the scan
    raises ``ScanFault`` (as the reference's does), the thread stopped."""
    ds = _store(_rows(10)).get("disk")
    stages = split_into_stages([Operator("udf", lambda s: {
        **s, "pred": s["x"][:, 0]}, breaker=True)])
    with pytest.raises(ScanFault, match="page read failed") as info:
        StreamingScanExecutor(stages, prefetch_depth=depth).execute(
            _FailingSource(ds), 1)
    assert info.value.site == "disk_page_read"
    assert isinstance(info.value.cause, OSError)
    assert not _reader_threads()


def test_stage_error_stops_the_reader():
    ds = _store(_rows(11)).get("disk")
    calls = []

    def udf(state):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("stage failed")
        return {**state, "pred": state["x"][:, 0]}

    stages = split_into_stages([Operator("udf", udf, breaker=True)])
    with pytest.raises(RuntimeError, match="stage failed"):
        StreamingScanExecutor(stages).execute(ds, 1)
    assert len(calls) == 2 and not _reader_threads()


def test_stage_error_survives_a_reader_that_does_not_stop(monkeypatch):
    """A reader stuck in a page read past the join timeout is reported
    on the stage's error, which still reaches the caller as it is."""
    from repro_torch.db import executor as ex
    monkeypatch.setattr(ex, "READER_JOIN_S", 0.05)
    ds = _store(_rows(11)).get("disk")
    stuck, go = threading.Event(), threading.Event()

    class _StuckSource(_Delegate):
        def page_slice(self, first_page, num_pages):
            if first_page == 2:
                stuck.set()
                go.wait(10)
            return self.ds.page_slice(first_page, num_pages)

    calls = []

    def udf(state):
        calls.append(1)
        if len(calls) == 2:                    # batch 1, once batch 0's
            stuck.wait(10)                     # buffer took the reader
            raise RuntimeError("stage failed")  # into batch 2
        return {**state, "pred": state["x"][:, 0]}

    stages = split_into_stages([Operator("udf", udf, breaker=True)])
    try:
        with pytest.raises(RuntimeError, match="stage failed") as info:
            StreamingScanExecutor(stages).execute(_StuckSource(ds), 1)
        assert "reader thread did not stop" in "".join(
            getattr(info.value, "__notes__", []))
    finally:
        go.set()
        for t in _reader_threads():
            t.join(10)
    assert not _reader_threads()


@pytest.mark.parametrize("depth", [1, 2])
def test_transfer_wait_excludes_loads_issued_ahead(depth):
    """At depth 2 the host tier's next batch is loaded before the current
    one's stages, on their thread: that is issue time, not exposed wait.
    At depth 1 every load is waited for."""
    ds = _store(_rows(12)).get("host")
    calls = []

    class _SlowSource(_Delegate):
        def to_device(self, block, out):
            calls.append(1)
            if len(calls) > 1:                 # every load after the first
                threading.Event().wait(0.02)
            return self.ds.to_device(block, out)

    stages = split_into_stages([Operator("udf", lambda s: {
        **s, "pred": s["x"][:, 0]}, breaker=True)])
    _, _, s = StreamingScanExecutor(stages, prefetch_depth=depth).execute(
        _SlowSource(ds), 1)
    slow = 0.02 * (s.batches - 1)
    assert s.transfer_issue_s >= slow
    if depth == 1:
        assert s.transfer_wait_s >= slow
    else:
        assert 0 <= s.transfer_wait_s < 0.02


# -- move, drop, spill files --------------------------------------------------


def test_move_round_trip_keeps_predictions_and_plans():
    x = _rows(12)
    store = _store(x)
    engine = ForestQueryEngine(store)
    tf = port_forest(_forest(integer_leaves=False))
    kw = dict(algorithm=FUSED, plan="udf", batch_pages=2)
    ref = engine.infer("device", tf, **kw)
    for tier in ("host", "disk", "host", "device", "disk", "device"):
        moved = store.move("device", tier)
        assert moved.tier == store.catalog()["device"]["tier"] == tier
        assert moved.num_pages == 5 and moved.page_rows == PAGE
        res = engine.infer("device", tf, **kw)
        assert res.tier == tier and res.plan_reuse_hit    # plan still valid
        assert torch.equal(res.predictions, ref.predictions), tier
    assert store.move("device", "device") is store.get("device")
    with pytest.raises(ValueError, match="unknown tier"):
        store.move("device", "tape")


def test_failed_spill_write_rolls_the_move_back(monkeypatch):
    x = _rows(13)
    store = _store(x)
    before = (store.catalog(), {k: list(v) for k, v in
                                store._disk_paths.items()},
              sorted(os.listdir(store.spill_dir)))
    real = store_mod.mmap_array

    def full_disk(path, arr):
        with open(path, "wb") as fh:            # a partial file, then fail
            fh.write(b"\0" * 64)
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(store_mod, "mmap_array", full_disk)
    with pytest.raises(OSError, match="No space"):
        store.move("host", "disk")
    after = (store.catalog(), store._disk_paths,
             sorted(os.listdir(store.spill_dir)))
    assert after == before                      # no orphan, nothing moved
    assert store.get("host").tier == "host"
    monkeypatch.setattr(store_mod, "mmap_array", real)
    assert store.move("host", "disk").tier == "disk"
    assert len(os.listdir(store.spill_dir)) == 2


def test_spill_file_lifecycle():
    x = _rows(14)
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    store.put("d", x)
    store.put("h", x, tier="host")
    assert store._spill_dir is None             # no spill, no directory
    store.move("d", "disk")
    store.put("k", x, tier="disk")
    assert len(os.listdir(store.spill_dir)) == 2
    store.move("d", "host")                     # leaving disk deletes it
    assert len(os.listdir(store.spill_dir)) == 1
    store.move("d", "disk")
    assert len(os.listdir(store.spill_dir)) == 2
    assert store.drop("d") == 0 and store.drop("k") == 0
    assert os.listdir(store.spill_dir) == []
    assert store.disk_nbytes == 0 and store.host_nbytes == store.get(
        "h").nbytes


def test_drop_and_reput_with_other_page_rows():
    x = _rows(15)
    # a regression forest on integer leaves: other batch shapes, same bits
    tf = port_forest(_forest(integer_leaves=True))
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    store.put("d", x)
    engine = ForestQueryEngine(store)
    ref = engine.infer("d", tf, algorithm=FUSED)
    assert engine.infer("d", tf, algorithm=FUSED).plan_reuse_hit
    for tier in ("host", "disk"):
        assert store.drop("d") == 1              # sweeps the plan
        ds = store.put("d", x, page_rows=PAGE // 2, tier=tier)
        assert ds.num_pages == 10
        res = engine.infer("d", tf, algorithm=FUSED, batch_pages=3)
        assert res.tier == tier and res.scan.batches == 4
        assert not res.plan_reuse_hit
        assert torch.equal(res.predictions, ref.predictions)


# -- streamed ingest and the WRITE sink ---------------------------------------


@pytest.mark.parametrize("tier", TIERS)
def test_put_stream_equals_put(tier):
    x = _rows(16)
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    whole = store.put("whole", x, tier=tier)
    parts = store.put_stream("parts", (x[i:i + 40] for i in range(0, N, 40)),
                             num_rows=N, num_features=9, tier=tier)
    assert parts.tier == tier and parts.num_pages == whole.num_pages
    a = store_mod._host_rows(whole.data)
    b = store_mod._host_rows(parts.data)
    assert torch.equal(a.nan_to_num(-7.0), b.nan_to_num(-7.0))
    assert torch.isnan(b[N:]).all()


def test_stream_writer_overrun_short_close_and_abort():
    x = _rows(17)
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    w = store.stream_writer("w", num_rows=N, num_features=9, tier="disk")
    w.write(x[:100])
    with pytest.raises(ValueError, match="overruns"):
        w.write(x[:100])
    with pytest.raises(ValueError, match="wrote 100 rows, declared 150"):
        w.close()
    assert len(os.listdir(store.spill_dir)) == 1
    w.abort()
    assert os.listdir(store.spill_dir) == [] and "w" not in store
    with pytest.raises(RuntimeError, match="closed"):
        w.write(x[:1])
    w.abort()                                   # idempotent

    def bad_batches():
        yield x[:50]
        raise KeyError("source died")

    with pytest.raises(KeyError):
        store.put_stream("s", bad_batches(), num_rows=N, num_features=9,
                         tier="disk")
    assert os.listdir(store.spill_dir) == [] and "s" not in store
    done = store.stream_writer("ok", num_rows=N, num_features=9,
                               tier="host")
    done.write(x)
    assert done.close().tier == "host"
    with pytest.raises(RuntimeError, match="closed"):
        done.close()


def test_write_as_from_an_off_device_result():
    x = _rows(18)
    store = _store(x)
    engine = ForestQueryEngine(store)
    tf = port_forest(_forest(integer_leaves=False))
    for tier in ("host", "disk"):
        res = engine.infer(tier, tf, algorithm=FUSED, batch_pages=2,
                           write_as=f"{tier}:pred")
        out = store.get(f"{tier}:pred")
        assert out.num_rows == N and out.tier == "device"   # the CPU store
        assert torch.equal(out.data[:, 0], res.predictions)
        assert res.write_s > 0


# -- the mesh half --------------------------------------------------------------


def _mesh_store(x, **kw):
    from repro_torch.launch.mesh import make_local_mesh
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE,
                             mesh=make_local_mesh(2, 4, devices=["cpu"] * 8),
                             **kw)
    for tier in TIERS:
        store.put(tier, x, tier=tier)
    return store


@pytest.mark.parametrize("plan", ["udf", "rel", "rel+reuse"])
@pytest.mark.parametrize("tier", ["host", "disk"])
def test_mesh_off_device_tiers_bit_identical_to_device(tier, plan):
    """Host- and disk-tier pages in data-unit batches through the mesh
    plans: bit for bit the mesh's device tier and the mesh-less one."""
    x = _rows(6)
    tf = port_forest(_forest(integer_leaves=False))
    engine = ForestQueryEngine(_mesh_store(x))
    kw = dict(algorithm=FUSED, plan=plan)
    got = engine.infer(tier, tf, batch_pages=1, **kw)
    dev = engine.infer("device", tf, **kw)
    flat = ForestQueryEngine(_store(x)).infer(
        "device", tf, n_parts=None if plan == "udf" else 4, **kw)
    assert got.tier == tier and got.mesh_devices == 8
    assert got.scan.batch_pages == 2 and got.scan.batches == 3
    assert torch.equal(got.predictions, dev.predictions)
    assert torch.equal(got.predictions, flat.predictions)


def test_mesh_default_batch_stays_in_the_budget():
    """The budget batch is sized in data units rounding down, so two
    buffers stay within the budget."""
    x = _rows(5)
    tf = port_forest(_forest(integer_leaves=False))
    page = PAGE * 9 * 4
    budget = 5 * page
    store = _mesh_store(x, device_budget_bytes=budget)
    ds = store.put("t", x)
    assert ds.tier == "host" and ds.num_pages == 6
    res = ForestQueryEngine(store).infer("t", tf, algorithm=FUSED)
    assert res.scan.batch_pages == 2 and res.scan.batches == 3
    assert 2 * res.scan.batch_pages * ds.page_nbytes <= budget


def test_mesh_move_keeps_the_padded_layout():
    x = _rows(7)
    tf = port_forest(_forest(integer_leaves=False))
    store = _mesh_store(x)
    engine = ForestQueryEngine(store)
    before = engine.infer("disk", tf, algorithm=FUSED, plan="rel")
    moved = store.move("disk", "device")
    assert moved.num_pages % 2 == 0
    after = engine.infer("disk", tf, algorithm=FUSED, plan="rel")
    assert torch.equal(before.predictions, after.predictions)
