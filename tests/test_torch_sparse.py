"""Port parity: the sparse data plane (CSR pages, the gather prepass,
compact forests, ``put_sparse`` on every tier, the plans over CSR).

Mirrors ``tests/test_sparse.py``'s tests outside the loader and the bf16
tree tiles, which wait for their own items.  The same numpy inputs from a
seed go through the reference and the port: the page arrays, inverse maps
and compact tiles are equal exactly; CSR predictions equal dense ones bit
for bit for every plan x algorithm on every tier (compaction keeps
thresholds, leaves and tree order); against the reference engine's CSR
queries they are bit-identical on the integer leaves of a regression
forest.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.forest import compact_forest as jcompact_forest
from repro.core.forest import make_forest as jmake_forest
from repro.core.forest import used_feature_counts as jused_feature_counts
from repro.core.reuse import ModelReuseCache as JCache
from repro.db.query import ForestQueryEngine as JEngine
from repro.db.sparse import csr_from_dense as jcsr_from_dense
from repro.db.sparse import csr_pages_from_dense as jcsr_pages_from_dense
from repro.db.sparse import densify_csr as jdensify_csr
from repro.db.sparse import paginate_csr as jpaginate_csr
from repro.db.store import TensorBlockStore as JStore
from repro.kernels.gather import csr_block_to_dense as jcsr_block_to_dense
from repro.kernels.gather import gather_inverse_map as jgather_inverse_map
from repro_torch.core.forest import compact_forest, used_feature_counts
from repro_torch.core.postprocess import predict_proba
from repro_torch.core.reuse import ModelReuseCache
from repro_torch.db import store as store_mod
from repro_torch.db.executor import MAX_IN_FLIGHT, ScanSource
from repro_torch.db.query import ForestQueryEngine
from repro_torch.db.sparse import (CSRPages, concat_pages, csr_from_dense,
                                   csr_pages_from_dense, densify_csr,
                                   paginate_csr)
from repro_torch.db.store import TensorBlockStore
from repro_torch.kernels.gather import (csr_block_to_dense, gather_columns,
                                        gather_inverse_map)

from conftest import random_forest_arrays
from test_torch_forest import port_forest

TIERS = ("device", "host", "disk")
PLANS = ("udf", "rel", "rel+reuse")
ALGORITHMS = ["predicated_pallas_fused", "hummingbird_pallas_fused",
              "quickscorer_pallas_fused", "predicated_pallas",
              "hummingbird_pallas", "quickscorer_pallas", "predicated"]
N, F, PAGE = 300, 24, 64


def _nan_heavy(n=N, f=F, nan_frac=0.7, seed=0):
    """Bosch-like rows: mostly missing, some exact zeros."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, f)).astype(np.float32)
    x[r.random((n, f)) < 0.05] = 0.0              # explicit zeros are data
    x[r.random((n, f)) < nan_frac] = np.nan
    x[::17] = np.nan                              # whole missing rows
    return x


def _forest(*, F=F, T=10, depth=4, seed=3, integer_leaves=True):
    fe, th, dl, lv = random_forest_arrays(None, T=T, depth=depth, F=F,
                                          seed=seed)
    if integer_leaves:
        lv = np.random.default_rng(seed).integers(-8, 9, lv.shape).astype(
            np.float32)
        return jmake_forest(fe, th, lv, default_left=dl, n_features=F,
                            model_type="xgboost", task="regression",
                            base_score=0.5)
    return jmake_forest(fe, th, lv, default_left=dl, n_features=F)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def _stores(x, **kw):
    """A port store holding ``x`` dense ("d-<tier>") and as CSR
    ("s-<tier>") on every tier."""
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE, **kw)
    for tier in TIERS:
        store.put(f"d-{tier}", x, tier=tier)
        store.put_sparse(f"s-{tier}", x, tier=tier)
    return store


# -- storage: CSR pages -------------------------------------------------------


def test_csr_arrays_equal_the_reference():
    x = _nan_heavy()
    for drop_zeros in (False, True):
        want = jcsr_from_dense(x, drop_zeros=drop_zeros)
        got = csr_from_dense(x, drop_zeros=drop_zeros)
        for w, g in zip(want, got):
            assert g.numpy().dtype == w.dtype
            assert np.array_equal(g.numpy(), w)
        for multiple in (1, 3):
            wp = jpaginate_csr(*want, num_rows=N, page_rows=PAGE,
                               n_features=F, pages_multiple=multiple)
            gp = paginate_csr(*got, num_rows=N, page_rows=PAGE,
                              n_features=F, pages_multiple=multiple)
            for w, g in zip(wp, gp):
                assert g.numpy().dtype == w.dtype and g.shape == w.shape
                assert np.array_equal(g.numpy(), w)
            np.testing.assert_array_equal(
                densify_csr(*gp, F).numpy(), jdensify_csr(*wp, F))


def test_csr_pages_roundtrip():
    x = _nan_heavy()
    pages = csr_pages_from_dense(x, page_rows=PAGE)
    assert pages.tier == "device" and pages.n_features == F
    assert pages.capacity % 128 == 0
    dense = densify_csr(*pages.arrays(), F).numpy()
    got = dense[:N]
    # missing stays missing, present values (zeros included) exact
    assert np.array_equal(np.isnan(got), np.isnan(x))
    m = ~np.isnan(x)
    np.testing.assert_array_equal(got[m], x[m])
    assert np.isnan(dense[N:]).all()          # padding rows: all missing
    ref = jcsr_pages_from_dense(x, page_rows=PAGE)
    for g, w in zip(pages.arrays(), (ref.indptr, ref.indices, ref.values)):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_csr_page_batch_determinism():
    store = TensorBlockStore(device="cpu", default_page_rows=32)
    ds = store.put_sparse("s", _nan_heavy())
    assert isinstance(ds, ScanSource)
    blocks = [ds.page_slice(first, min(2, ds.num_pages - first))
              for first in range(0, ds.num_pages, 2)]
    # every full block has the SAME array shapes: one plan per batching
    shapes = {tuple(tuple(a.shape) for a in b.arrays())
              for b in blocks[:-1]}
    assert len(shapes) == 1
    again = [ds.page_slice(first, min(2, ds.num_pages - first))
             for first in range(0, ds.num_pages, 2)]
    for a, b in zip(blocks, again):
        for u, v in zip(a.arrays(), b.arrays()):
            assert torch.equal(u, v)


def test_chunked_pagination_equals_the_whole_table():
    """Pages made chunk by chunk (whole pages each, as the card builds a
    table too large to hold unpaginated) and concatenated are the whole
    table's pages, capacity included."""
    x = _nan_heavy(n=500, nan_frac=0.5, seed=4)
    x[:64] = np.nan                               # a sparse first chunk
    whole = paginate_csr(*csr_from_dense(x), num_rows=500, page_rows=32,
                         n_features=F)
    blocks = [paginate_csr(*csr_from_dense(x[lo:lo + 64]),
                           num_rows=len(x[lo:lo + 64]), page_rows=32,
                           n_features=F) for lo in range(0, 500, 64)]
    assert len({b[1].shape[1] for b in blocks}) > 1
    got = concat_pages(blocks, n_features=F)
    for g, w in zip(got.arrays(), whole):
        assert torch.equal(g, w)


def test_page_offsets_past_2_16_and_duplicate_columns():
    """A page of 4 dense rows of 20,000 features holds 80,000 entries:
    int32 page-local offsets carry it.  A row with two entries for one
    column is refused at pagination (the gather could not order them)."""
    x = np.random.default_rng(5).normal(size=(6, 20_000)).astype(np.float32)
    ip, ix, vl = paginate_csr(*csr_from_dense(x), num_rows=6, page_rows=4,
                              n_features=20_000)
    assert int(ip[0, -1]) == 80_000 > 1 << 16
    assert ip.dtype == torch.int32 and ix.shape[1] == 80_000
    np.testing.assert_array_equal(densify_csr(ip, ix, vl, 20_000)[:6], x)
    indptr = np.array([0, 3, 4], np.int64)
    dup = np.array([1, 5, 1, 2], np.int32)
    with pytest.raises(ValueError, match="two entries for one column"):
        paginate_csr(indptr, dup, np.ones(4, np.float32), num_rows=2,
                     page_rows=2, n_features=8)
    unsorted = np.array([5, 1, 3, 2], np.int32)   # no duplicate: accepted
    ip, ix, vl = paginate_csr(indptr, unsorted, np.arange(4, dtype=np.float32),
                              num_rows=2, page_rows=2, n_features=8)
    assert densify_csr(ip, ix, vl, 8)[0, 5] == 0.0
    with pytest.raises(ValueError, match="column ids"):
        paginate_csr(indptr, np.array([1, 8, 2, 3], np.int32),
                     np.ones(4, np.float32), num_rows=2, page_rows=2,
                     n_features=8)


def test_catalog_tags_format_and_compresses():
    x = _nan_heavy()
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    store.put("d", x)
    store.put_sparse("s", x)
    cat = store.catalog()
    assert cat["d"]["format"] == "dense" and "nnz" not in cat["d"]
    assert cat["s"]["format"] == "csr"
    assert cat["s"]["nnz"] == int((~np.isnan(x)).sum())
    assert cat["s"]["bytes"] < cat["d"]["bytes"]
    assert cat["s"]["pages"] == cat["d"]["pages"]


# -- the gather prepass -------------------------------------------------------


def test_gather_inverse_map_and_tile_equal_the_reference():
    x = _nan_heavy(nan_frac=0.5)
    jf = _forest(F=F, T=6, depth=3, seed=9)
    jcf, jgidx = jcompact_forest(jf)
    cf, gidx = compact_forest(port_forest(jf))
    assert np.array_equal(gidx.numpy(), jgidx)
    jinv = jgather_inverse_map(jgidx, F)
    inv = gather_inverse_map(gidx, F)
    assert inv.dtype == torch.int32 and np.array_equal(inv.numpy(), jinv)
    # a padded table: the first occurrence of a repeated column wins
    padded = np.array([3, 7, 9, 3, 3], np.int32)
    assert np.array_equal(gather_inverse_map(padded, 12).numpy(),
                          jgather_inverse_map(padded, 12))
    jpages = jcsr_pages_from_dense(x, page_rows=PAGE)
    pages = csr_pages_from_dense(x, page_rows=PAGE)
    f_used = int(gidx.numel())
    want = np.asarray(jcsr_block_to_dense(jpages, jnp.asarray(jinv),
                                          f_used))
    got = csr_block_to_dense(pages, inv, f_used).numpy()
    assert got.shape == (pages.num_rows_padded, f_used)
    np.testing.assert_array_equal(got, want)
    # and it is the dense plane's column gather, NaN where missing, over
    # the real slots (the padding slots are never read; the CSR tile
    # leaves them missing)
    real = np.unique(gidx.numpy()).size
    dense = torch.from_numpy(np.concatenate(
        [x, np.full((pages.num_rows_padded - N, F), np.nan, np.float32)]))
    np.testing.assert_array_equal(
        got[:, :real], gather_columns(dense, gidx).numpy()[:, :real])
    assert np.isnan(got[:, real:]).all()


# -- the model half: used-feature compaction ----------------------------------


def test_compact_forest_invariants():
    Fw = 10_000
    fe, th, dl, lv = random_forest_arrays(None, T=6, depth=4, F=Fw, seed=7)
    jf = jmake_forest(fe, th, lv, default_left=dl, n_features=Fw)
    tf = port_forest(jf)
    counts = used_feature_counts(tf)
    assert np.array_equal(counts, jused_feature_counts(jf))
    assert (counts <= tf.num_internal).all()
    compact, gidx = compact_forest(tf)
    jcompact, jgidx = jcompact_forest(jf)
    g = gidx.numpy()
    assert np.array_equal(g, jgidx)
    assert np.array_equal(compact.feature.numpy(),
                          np.asarray(jcompact.feature))
    f_used = np.unique(g).size
    real = g[:f_used]
    assert np.array_equal(real, np.unique(real))
    assert (g[f_used:] == g[0]).all()
    assert compact.n_features == g.size and compact.n_features % 8 == 0
    assert int(compact.feature.max()) < f_used    # never a padding slot
    for name in ("threshold", "leaf_value", "default_left"):
        assert torch.equal(getattr(compact, name), getattr(tf, name))


def test_compaction_skips_pass_through_nodes():
    jf = _forest(F=40, T=3, depth=3, seed=2, integer_leaves=False)
    tf = port_forest(jf)
    th = tf.threshold.clone()
    th[:, 0] = float("inf")                       # every root passes through
    tf = type(tf)(**{**tf.__dict__, "threshold": th})
    want = [np.unique(tf.feature[t][torch.isfinite(th[t])].numpy()).size
            for t in range(3)]
    assert list(used_feature_counts(tf)) == want


@pytest.mark.parametrize("algorithm", ["predicated", "hummingbird",
                                       "quickscorer"])
def test_compact_forest_prediction_parity(algorithm):
    Fw = 2000
    tf = port_forest(_forest(F=Fw, T=5, depth=4, seed=11,
                             integer_leaves=False))
    compact, gidx = compact_forest(tf)
    r = np.random.default_rng(2)
    x = r.normal(size=(32, Fw)).astype(np.float32)
    x[r.random(x.shape) < 0.5] = np.nan
    xt = torch.from_numpy(x)
    want = predict_proba(tf, xt, algorithm=algorithm)
    got = predict_proba(compact, gather_columns(xt, gidx),
                        algorithm=algorithm)
    assert np.array_equal(_bits(got), _bits(want))


# -- put_sparse on every tier, move, spill files ----------------------------


def test_put_sparse_on_every_tier_and_zero_copy_handoff():
    x = _nan_heavy()
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    ref = store.put_sparse("ref", x, tier="device")
    for tier in TIERS:
        ds = store.put_sparse(tier, x, tier=tier)
        assert ds.tier == ds.pages.tier == tier and ds.num_rows == N
        kinds = {type(a) for a in ds.pages.arrays()}
        assert kinds == ({np.memmap} if tier == "disk" else {torch.Tensor})
        for a, b in zip(ds.pages.tensors(), ref.pages.tensors()):
            assert torch.equal(a, b)
        # csr= and pages= entry points give the same pages
        csr = csr_from_dense(x)
        by_csr = store.put_sparse("c", csr=csr, num_rows=N, num_features=F,
                                  tier=tier)
        by_pages = store.put_sparse("p", pages=ds.pages, num_rows=N,
                                    tier=tier)
        for a, b, c in zip(by_csr.pages.tensors(), by_pages.pages.tensors(),
                           ref.pages.tensors()):
            assert torch.equal(a, c) and torch.equal(b, c)
        # a handoff already on the tier is zero-copy
        assert all(a is b for a, b in zip(by_pages.pages.arrays(),
                                          ds.pages.arrays()))
    files = sorted(os.listdir(store.spill_dir))
    assert [f.rsplit(".", 2)[1] for f in files if f.startswith("disk-")] \
        == ["indices", "indptr", "values"]
    with pytest.raises(ValueError, match="num_rows"):
        store.put_sparse("bad", pages=ref.pages)
    with pytest.raises(ValueError, match="need one of"):
        store.put_sparse("bad")


def test_auto_cascade_counts_csr_bytes():
    x = _nan_heavy()
    probe = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    nbytes = probe.put_sparse("s", x).nbytes
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE,
                             device_budget_bytes=int(nbytes * 1.5),
                             host_budget_bytes=int(nbytes * 1.5))
    tiers = [store.put_sparse(k, x).tier for k in "abc"]
    assert tiers == list(TIERS)
    assert store.device_nbytes == store.host_nbytes == store.disk_nbytes \
        == nbytes


def test_move_csr_round_trip_and_spill_files():
    x = _nan_heavy()
    store = _stores(x)
    engine = ForestQueryEngine(store)
    tf = port_forest(_forest())
    kw = dict(algorithm="predicated_pallas_fused", plan="udf", batch_pages=2)
    ref = engine.infer("s-device", tf, **kw)
    for tier in ("host", "disk", "device", "disk", "host", "device"):
        moved = store.move("s-device", tier)
        assert moved.tier == moved.pages.tier == tier
        assert store.catalog()["s-device"]["tier"] == tier
        res = engine.infer("s-device", tf, **kw)
        assert res.tier == tier and res.plan_reuse_hit
        assert res.storage_format == "csr"
        assert torch.equal(res.predictions, ref.predictions), tier
        on_disk = [p for p in os.listdir(store.spill_dir)
                   if p.startswith("s-device-")]
        assert len(on_disk) == (3 if tier == "disk" else 0)
    store.drop("s-disk")
    assert not [p for p in os.listdir(store.spill_dir)
                if p.startswith("s-disk-")]


def test_failed_csr_spill_rolls_the_move_back(monkeypatch):
    x = _nan_heavy()
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    store.put_sparse("s", x, tier="host")
    before = (store.catalog(), dict(store._disk_paths),
              sorted(os.listdir(store.spill_dir)))
    real = store_mod.mmap_array
    calls = []

    def fail_third(path, arr):
        calls.append(path)
        if len(calls) == 3:                 # indptr, indices land; values
            with open(path, "wb") as fh:    # fails half written
                fh.write(b"\0" * 64)
            raise OSError(28, "No space left on device")
        return real(path, arr)

    monkeypatch.setattr(store_mod, "mmap_array", fail_third)
    with pytest.raises(OSError, match="No space"):
        store.move("s", "disk")
    after = (store.catalog(), store._disk_paths,
             sorted(os.listdir(store.spill_dir)))
    assert after == before and store.get("s").tier == "host"
    monkeypatch.setattr(store_mod, "mmap_array", real)
    assert store.move("s", "disk").tier == "disk"
    assert len(os.listdir(store.spill_dir)) == 3


# -- the plans over CSR ------------------------------------------------------


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("plan", PLANS)
def test_csr_equals_dense_on_every_tier(plan, algorithm):
    """Same model, same rows: the CSR plane (compaction + gather) gives the
    dense plane's predictions bit for bit on every tier, with the dense
    plan's stage count, and streams all three page arrays off-device."""
    x = _nan_heavy(seed=1)
    store = _stores(x)
    engine = ForestQueryEngine(store)
    tf = port_forest(_forest(seed=4, integer_leaves=False))
    kw = dict(algorithm=algorithm, plan=plan, batch_pages=2)
    want = engine.infer("d-device", tf, **kw)
    for tier in TIERS:
        got = engine.infer(f"s-{tier}", tf, **kw)
        assert got.storage_format == "csr" and got.tier == tier
        assert got.num_stages == want.num_stages
        assert np.array_equal(_bits(got.predictions), _bits(
            want.predictions)), tier
        ds = store.get(f"s-{tier}")
        assert got.scan.bytes_streamed == (0 if tier == "device"
                                           else ds.nbytes)
        assert got.scan.max_in_flight <= MAX_IN_FLIGHT
        names = [op for r in got.stage_reports for op in r.operators]
        assert "gather:csr-compact" in names
        first = next(r for r in got.stage_reports
                     if "gather:csr-compact" in r.operators)
        # the gather shares the stage of the kernel it feeds
        assert any(n in first.operators for n in
                   ("transform:forest-udf", "cross-product:partial-agg"))


@pytest.mark.parametrize("algorithm", ["predicated_pallas_fused",
                                       "hummingbird_pallas",
                                       "quickscorer_pallas_fused",
                                       "predicated"])
@pytest.mark.parametrize("plan", PLANS)
def test_csr_queries_match_the_reference_engine(plan, algorithm):
    x = _nan_heavy(seed=2)
    jf = _forest(seed=5)
    jstore = JStore(default_page_rows=PAGE)
    jstore.put_sparse("s", x)
    jengine = JEngine(jstore, reuse_cache=JCache(), plan_cache=JCache())
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    store.put_sparse("s", x)
    engine = ForestQueryEngine(store)
    kw = dict(algorithm=algorithm, plan=plan,
              n_parts=None if plan == "udf" else 3)
    want = jengine.infer("s", jf, **kw)
    got = engine.infer("s", port_forest(jf), **kw)
    assert want.storage_format == got.storage_format == "csr"
    assert got.num_stages == want.num_stages
    assert [r.name for r in got.stage_reports] == \
        [r.name for r in want.stage_reports]
    assert np.array_equal(got.predictions.numpy(),
                          np.asarray(want.predictions))


def test_plan_cache_separates_formats():
    x = _nan_heavy()
    store = _stores(x)
    engine = ForestQueryEngine(store, reuse_cache=ModelReuseCache(),
                               plan_cache=ModelReuseCache())
    tf = port_forest(_forest())
    kw = dict(algorithm="predicated", plan="udf", model_id="fmt-sep")
    first = [engine.infer(n, tf, **kw) for n in ("d-device", "s-device")]
    assert not any(r.plan_reuse_hit for r in first)
    again = [engine.infer(n, tf, **kw) for n in ("d-device", "s-device")]
    assert all(r.plan_reuse_hit for r in again)
    assert len(engine.plan_cache) == 2
    keys = list(engine.plan_cache._store) \
        if hasattr(engine.plan_cache, "_store") else None
    if keys is not None:
        assert {k[4] for k in keys} == {"dense", "csr"}


def test_rel_reuse_model_cache_separates_formats():
    """The partitioned model is keyed on the format too: the CSR plane's
    materialization is the COMPACTED forest, with its gather table."""
    x = _nan_heavy()
    store = _stores(x)
    cache = ModelReuseCache()
    engine = ForestQueryEngine(store, reuse_cache=cache,
                               plan_cache=ModelReuseCache())
    kw = dict(algorithm="predicated", plan="rel+reuse", model_id="m-fmt")
    engine.infer("d-device", port_forest(_forest()), **kw)
    tf = port_forest(_forest())
    r2 = engine.infer("s-device", tf, **kw)
    assert not r2.reuse_hit
    assert cache.stats.misses == 2
    r3 = engine.infer("s-host", tf, **kw)          # any tier: the same model
    assert r3.reuse_hit


def test_infer_rows_stays_dense():
    x = _nan_heavy()
    store = _stores(x)
    engine = ForestQueryEngine(store)
    tf = port_forest(_forest())
    rows = engine.infer_rows(tf, np.nan_to_num(x[:16]))
    assert rows.predictions.shape == (16,)
    keys = list(engine.plan_cache._store) \
        if hasattr(engine.plan_cache, "_store") else []
    assert all(k[4] == "dense" for k in keys if k[0] == "udf-row-plan")


def test_criteo_scale_end_to_end():
    """F = 10,000 at 96 % missing, end to end through the CSR store and the
    gather prepass: the compact tile is F_used wide, not F, and CSR ==
    dense bit for bit, against the reference's CSR query too."""
    Fw = 10_000
    jf = _forest(F=Fw, T=8, depth=6, seed=17)
    assert jused_feature_counts(jf).max() <= 64
    x = _nan_heavy(n=96, f=Fw, nan_frac=0.96, seed=5)
    store = TensorBlockStore(device="cpu", default_page_rows=32)
    store.put("wide-d", x)
    store.put_sparse("wide-s", x)
    engine = ForestQueryEngine(store)
    tf = port_forest(jf)
    kw = dict(algorithm="predicated_pallas_fused", plan="udf")
    rd = engine.infer("wide-d", tf, **kw)
    rs = engine.infer("wide-s", tf, **kw)
    assert rs.storage_format == "csr"
    assert np.array_equal(_bits(rs.predictions), _bits(rd.predictions))
    compact, gidx = compact_forest(tf)
    tile = csr_block_to_dense(store.get("wide-s").page_slice(0, 1),
                              gather_inverse_map(gidx, Fw), gidx.numel())
    assert tile.shape == (32, gidx.numel()) and gidx.numel() < Fw
    jstore = JStore(default_page_rows=32)
    jstore.put_sparse("wide-s", x)
    want = JEngine(jstore, reuse_cache=JCache(),
                   plan_cache=JCache()).infer("wide-s", jf, **kw)
    assert np.array_equal(rs.predictions.numpy(),
                          np.asarray(want.predictions))


def test_csr_pages_slice_in_their_own_tier():
    x = _nan_heavy()
    store = _stores(x)
    for tier in TIERS:
        ds = store.get(f"s-{tier}")
        blk = ds.page_slice(1, 2)
        assert isinstance(blk, CSRPages) and blk.num_pages == 2
        if tier == "disk":
            assert all(isinstance(a, np.memmap) for a in blk.arrays())
        out = ds.empty_block(2, device="cpu")
        assert ds.to_device(blk, out) is out
        for a, b in zip(out.tensors(), store.get("s-device")
                        .page_slice(1, 2).tensors()):
            assert torch.equal(a, b)


# -- the mesh half --------------------------------------------------------------


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("tier", TIERS)
def test_mesh_csr_equals_dense_and_meshless(tier, plan):
    """CSR pages through the mesh plans: the gather runs in each row shard,
    and the predictions equal the mesh's dense plane and the mesh-less
    CSR plane bit for bit."""
    from repro_torch.launch.mesh import make_local_mesh
    x = _nan_heavy(seed=4)
    tf = port_forest(_forest())
    mesh = make_local_mesh(2, 4, devices=["cpu"] * 8)
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE, mesh=mesh)
    store.put(f"d-{tier}", x, tier=tier)
    store.put_sparse(f"s-{tier}", x, tier=tier)
    assert store.get(f"s-{tier}").num_pages % 2 == 0
    engine = ForestQueryEngine(store)
    kw = dict(algorithm="hummingbird_pallas_fused", plan=plan)
    csr = engine.infer(f"s-{tier}", tf, batch_pages=2, **kw)
    dense = engine.infer(f"d-{tier}", tf, **kw)
    flat = ForestQueryEngine(_stores(x)).infer(
        f"s-{tier}", tf, n_parts=None if plan == "udf" else 4, **kw)
    assert csr.storage_format == "csr" and csr.mesh_devices == 8
    assert torch.equal(csr.predictions, dense.predictions)
    assert torch.equal(csr.predictions, flat.predictions)


def test_mesh_pages_handed_over_pad_to_the_data_axis():
    from repro_torch.launch.mesh import make_local_mesh
    x = _nan_heavy(seed=5)
    pages = csr_pages_from_dense(x, page_rows=PAGE)
    assert pages.num_pages == 5
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE,
                             mesh=make_local_mesh(4, 2, devices=["cpu"] * 8))
    ds = store.put_sparse("p", pages=pages, num_rows=N)
    assert ds.num_pages == 8
    ip, ix, vl = ds.pages.tensors()
    assert not ip[5:].any() and (ix[5:] == F).all() and not vl[5:].any()
    want = ForestQueryEngine(_stores(x)).infer(
        "s-device", port_forest(_forest()), algorithm="predicated")
    got = ForestQueryEngine(store).infer("p", port_forest(_forest()),
                                         algorithm="predicated")
    assert torch.equal(got.predictions, want.predictions)
