"""Port parity: the external loaders (``db/loader.py``) and the store's
labels.

The same numpy arrays go to both packages' writers, which must write the
same bytes, and both packages' loaders read the same file, which must give
the same values bit for bit (the port parses to float64 and rounds to
float32 as the reference does).  Then the ``LoadTiming`` contracts of the
reference's own loader tests (``tests/test_db.py``, ``tests/test_sparse.py``),
the host- and disk-tier ingest of ``tests/test_disk_tier.py`` /
``tests/test_streaming.py`` (zero-copy handoff, file names, no transfer,
udf queries bit for bit the device-tier load's), load -> put -> infer
against the reference engine's, and ``synth_dataset``'s stable seed.
Everything runs on the CPU device; the card's half is in
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 10.
"""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.reuse import ModelReuseCache as JCache
from repro.db import loader as jld
from repro.db.query import ForestQueryEngine as JEngine
from repro.db.store import TensorBlockStore as JStore
from repro_torch.core.reuse import ModelReuseCache
from repro_torch.db import loader as ld
from repro_torch.db.query import ForestQueryEngine
from repro_torch.db.sparse import densify_csr
from repro_torch.db.store import TensorBlockStore

from test_torch_forest import port_forest
from test_torch_sparse import _forest

PAGE = 32
SPARSE_ALGO = "hummingbird_pallas_fused"
#: the reference loaders' own test shapes (tests/test_db.py,
#: tests/test_sparse.py): 50 fraud rows, 40 Bosch rows, 10 Epsilon rows
SHAPES = dict(fraud=50, bosch=40, epsilon=10)


def _data(name: str, rows: int | None = None):
    return ld.synth_dataset(name, max_rows=rows or SHAPES[name])


def _bosch_like(n=300, f=24, seed=5):
    """Mostly missing rows with exact zeros (dropped by LIBSVM)."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, f)).astype(np.float32)
    x[r.random(x.shape) < 0.7] = np.nan
    x[r.random(x.shape) < 0.05] = 0.0
    y = (r.random(n) < 0.5).astype(np.float32)
    return x, y


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _engine(store):
    return ForestQueryEngine(store, reuse_cache=ModelReuseCache(),
                             plan_cache=ModelReuseCache())


# ---------------------------------------------------------------------------
# writers: the reference's bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_writers_write_the_reference_bytes(tmp_path, name):
    x, y = _data(name)
    x = x.copy()
    x[0, :3] = [0.0, -0.0, 1e-30]                 # zeros and a tiny value
    x[1, 0] = np.float32(123456789.0)
    for fmt, write, jwrite, args in (
            ("csv", ld.write_csv, jld.write_csv, (x,)),
            ("svm", ld.write_libsvm, jld.write_libsvm, (x, y)),
            ("arr", ld.write_array_rows, jld.write_array_rows, (x,))):
        if fmt != "svm" and np.isnan(x).any():
            continue                    # CSV and array rows carry no NaN
        ours, theirs = tmp_path / f"p.{fmt}", tmp_path / f"r.{fmt}"
        write(str(ours), *args)
        jwrite(str(theirs), *args)
        assert ours.read_bytes() == theirs.read_bytes(), fmt


def test_libsvm_writer_reference_bytes_on_empty_rows(tmp_path):
    x, y = _bosch_like(n=20)
    x[3] = np.nan                                   # a row with no items
    ld.write_libsvm(str(tmp_path / "p.svm"), x, y)
    jld.write_libsvm(str(tmp_path / "r.svm"), x, y)
    assert (tmp_path / "p.svm").read_bytes() == \
        (tmp_path / "r.svm").read_bytes()


# ---------------------------------------------------------------------------
# loaders: the reference's values, bit for bit, from the same file
# ---------------------------------------------------------------------------


def test_csv_loader_matches_the_reference(tmp_path):
    x, _ = _data("fraud", 300)
    p = str(tmp_path / "d.csv")
    jld.write_csv(p, x)
    got, timing = ld.load_csv_external(p, device="cpu")
    want, _ = jld.load_csv_external(p)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.array_equal(_bits(got), _bits(want))
    assert timing.transfer_s > 0


@pytest.mark.parametrize("missing_as_nan", [True, False])
def test_libsvm_dense_loader_matches_the_reference(tmp_path, missing_as_nan):
    x, y = _bosch_like()
    p = str(tmp_path / "d.svm")
    jld.write_libsvm(p, x, y)
    got, labels, _ = ld.load_libsvm_external(
        p, x.shape[1], device="cpu", missing_as_nan=missing_as_nan)
    want, jlabels, _ = jld.load_libsvm_external(
        p, x.shape[1], missing_as_nan=missing_as_nan)
    assert np.array_equal(_bits(got), _bits(want))
    assert labels.dtype == np.float32 and np.array_equal(labels, jlabels)


@pytest.mark.parametrize("page_rows,pages_multiple", [(32, 1), (64, 4)])
def test_libsvm_csr_loader_matches_the_reference(tmp_path, page_rows,
                                                 pages_multiple):
    x, y = _bosch_like()
    p = str(tmp_path / "d.svm")
    jld.write_libsvm(p, x, y)
    pages, labels, _ = ld.load_libsvm_csr_external(
        p, x.shape[1], page_rows=page_rows, pages_multiple=pages_multiple,
        device="cpu")
    jpages, jlabels, _ = jld.load_libsvm_csr_external(
        p, x.shape[1], page_rows=page_rows, pages_multiple=pages_multiple)
    assert pages.tier == "device" and pages.n_features == x.shape[1]
    for ours, theirs in zip(pages.arrays(), (jpages.indptr, jpages.indices,
                                             jpages.values)):
        theirs = np.asarray(theirs)
        assert ours.numpy().dtype == theirs.dtype
        assert np.array_equal(ours.numpy().view(np.int32),
                              theirs.view(np.int32))
    assert np.array_equal(labels, jlabels)


def test_libsvm_parse_matches_the_reference_item_by_item(tmp_path):
    """The vectorised parse against the reference's per-item loop, on
    values that round differently in float32 and float64."""
    x, y = _bosch_like(n=200, f=64, seed=9)
    x[~np.isnan(x)] *= np.float32(1e-3)
    x[5, :4] = [3.4028235e38, 1.17549435e-38, 1e-45, -2.5]
    x[6, :2] = [np.inf, -np.inf]
    p = str(tmp_path / "d.svm")
    jld.write_libsvm(p, x, y)
    indptr, indices, values, labels = ld._parse_libsvm(p)
    jindptr, jindices, jvalues, jlabels = jld._parse_libsvm(p)
    assert np.array_equal(indptr, jindptr)
    assert np.array_equal(indices, jindices)
    assert np.array_equal(values, np.asarray(jvalues, np.float64))
    assert np.array_equal(values.astype(np.float32).view(np.int32),
                          np.asarray(jvalues, np.float32).view(np.int32))
    assert np.array_equal(labels, jlabels)


def test_array_rows_loader_matches_the_reference(tmp_path):
    x, _ = _data("epsilon", 12)
    p = str(tmp_path / "d.arr")
    jld.write_array_rows(p, x)
    got, timing = ld.load_array_rows_external(p, device="cpu")
    want, _ = jld.load_array_rows_external(p)
    assert got.shape == (12, 2000)
    assert np.array_equal(_bits(got), _bits(want))
    assert timing.convert_s >= 0 and timing.transfer_s > 0


# ---------------------------------------------------------------------------
# the reference tests' LoadTiming contracts (tests/test_db.py:284-312,
# tests/test_sparse.py:155-187)
# ---------------------------------------------------------------------------


def test_csv_roundtrip(tmp_path):
    x, _ = _data("fraud")
    p = str(tmp_path / "d.csv")
    ld.write_csv(p, x)
    dev, timing = ld.load_csv_external(p, device="cpu")
    np.testing.assert_allclose(dev.numpy(), x, rtol=1e-4, atol=1e-5)
    assert timing.total_s > 0 and timing.parse_s > 0


def test_libsvm_roundtrip(tmp_path):
    x, y = _data("bosch")
    p = str(tmp_path / "d.svm")
    ld.write_libsvm(p, x, y)
    dev, labels, timing = ld.load_libsvm_external(p, x.shape[1],
                                                  device="cpu")
    got = dev.numpy()
    mask = ~np.isnan(x) & (x != 0.0)
    np.testing.assert_allclose(got[mask], x[mask], rtol=1e-4, atol=1e-5)
    assert np.isnan(got[~mask]).all()
    np.testing.assert_allclose(labels, y)
    assert timing.total_s >= (timing.parse_s + timing.convert_s
                              + timing.transfer_s) * 0.99


def test_array_rows_roundtrip(tmp_path):
    x, _ = _data("epsilon")
    p = str(tmp_path / "d.arr")
    ld.write_array_rows(p, x)
    dev, timing = ld.load_array_rows_external(p, device="cpu")
    np.testing.assert_allclose(dev.numpy(), x, rtol=1e-4, atol=1e-5)
    assert timing.convert_s >= 0


def test_libsvm_csr_loader(tmp_path):
    x, y = _data("bosch")
    p = str(tmp_path / "d.svm")
    ld.write_libsvm(p, x, y)
    pages, labels, timing = ld.load_libsvm_csr_external(
        p, x.shape[1], page_rows=16, device="cpu")
    assert timing.parse_s > 0 and timing.convert_s > 0
    assert timing.transfer_s > 0
    assert timing.total_s >= (timing.parse_s + timing.convert_s
                              + timing.transfer_s) * 0.99
    np.testing.assert_allclose(labels, y)
    dense = densify_csr(*pages.arrays(), x.shape[1])[:40].numpy()
    mask = ~np.isnan(x) & (x != 0.0)      # libsvm files drop zeros
    np.testing.assert_allclose(dense[mask], x[mask], rtol=1e-4, atol=1e-5)
    assert np.isnan(dense[~mask]).all()


def test_libsvm_csr_loader_feeds_store(tmp_path):
    x, y = _data("bosch", 30)
    p = str(tmp_path / "d.svm")
    ld.write_libsvm(p, x, y)
    pages, labels, _ = ld.load_libsvm_csr_external(p, x.shape[1],
                                                   page_rows=16,
                                                   device="cpu")
    store = TensorBlockStore(device="cpu", default_page_rows=16)
    ds = store.put_sparse("ext", pages=pages, num_rows=len(labels),
                          labels=labels)
    assert ds.storage_format == "csr" and ds.num_rows == 30
    assert ds.labels.dtype == torch.float32
    assert np.array_equal(ds.labels.numpy(), y)
    assert ds.pages.indptr is pages.indptr          # zero-copy handoff


def test_loader_refuses_an_unknown_tier(tmp_path):
    x, y = _bosch_like(n=8)
    p = str(tmp_path / "d.svm")
    ld.write_libsvm(p, x, y)
    with pytest.raises(ValueError, match="unknown tier"):
        ld.load_libsvm_csr_external(p, x.shape[1], tier="tape",
                                    device="cpu")


def test_loaders_do_not_fall_back_to_the_cpu(tmp_path):
    """Asked for the card (the default device) without one, every loader
    raises; none returns CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    x, y = _bosch_like(n=8)
    csv, svm, arr = (str(tmp_path / f"d.{e}") for e in ("csv", "svm", "arr"))
    ld.write_csv(csv, np.nan_to_num(x))
    ld.write_libsvm(svm, x, y)
    ld.write_array_rows(arr, np.nan_to_num(x))
    for load in (lambda: ld.load_csv_external(csv),
                 lambda: ld.load_libsvm_external(svm, x.shape[1]),
                 lambda: ld.load_libsvm_csr_external(svm, x.shape[1]),
                 lambda: ld.load_libsvm_csr_external(svm, x.shape[1],
                                                     tier="host"),
                 lambda: ld.load_array_rows_external(arr)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            load()


# ---------------------------------------------------------------------------
# host- and disk-tier ingest (tests/test_disk_tier.py:246-278,
# tests/test_streaming.py:391-420)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def svm_file(tmp_path_factory):
    x, y = _bosch_like(n=384, f=16, seed=7)
    d = tmp_path_factory.mktemp("svm")
    p = str(d / "d.svm")
    ld.write_libsvm(p, x, y)
    return p, x


def test_libsvm_disk_tier_ingest(tmp_path, svm_file):
    p, xs = svm_file
    forest = port_forest(_forest(F=xs.shape[1], seed=4))
    pages, labels, t = ld.load_libsvm_csr_external(
        p, xs.shape[1], page_rows=PAGE, tier="disk",
        spill_dir=str(tmp_path), device="cpu")
    assert t.transfer_s == 0.0, "disk-tier ingest must not transfer"
    assert t.parse_s > 0 and t.convert_s > 0 and t.total_s > 0
    assert pages.tier == "disk"
    for arr in pages.arrays():
        assert isinstance(arr, np.memmap)
    assert {f for f in os.listdir(tmp_path) if f.endswith(".bin")} == \
        {"d.indptr.bin", "d.indices.bin", "d.values.bin"}
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    ds = store.put_sparse("k", pages=pages, num_rows=len(labels),
                          tier="disk")
    assert ds.tier == "disk"
    assert ds.pages.indptr is pages.indptr       # zero-copy handoff
    pages_d, _, t_d = ld.load_libsvm_csr_external(p, xs.shape[1],
                                                  page_rows=PAGE,
                                                  device="cpu")
    assert t_d.transfer_s > 0.0
    store.put_sparse("dev", pages=pages_d, num_rows=len(labels))
    engine = _engine(store)
    rk = engine.infer("k", forest, algorithm=SPARSE_ALGO, plan="udf",
                      batch_pages=2)
    rd = engine.infer("dev", forest, algorithm=SPARSE_ALGO, plan="udf",
                      batch_pages=2)
    assert rk.tier == "disk" and rk.storage_format == "csr"
    assert np.array_equal(_bits(rk.predictions), _bits(rd.predictions))
    store.drop("k")
    assert all(os.path.exists(a.filename) for a in pages.arrays()), \
        "the loader's page files belong to the caller"


def test_libsvm_disk_tier_ingest_makes_its_own_directory(svm_file):
    p, xs = svm_file
    pages, _, _ = ld.load_libsvm_csr_external(p, xs.shape[1],
                                              page_rows=PAGE, tier="disk",
                                              device="cpu")
    d = os.path.dirname(pages.indptr.filename)
    try:
        assert os.path.basename(d).startswith("libsvm-disk-")
        assert sorted(os.listdir(d)) == ["d.indices.bin", "d.indptr.bin",
                                         "d.values.bin"]
    finally:
        for a in pages.arrays():
            os.unlink(a.filename)
        os.rmdir(d)


@pytest.mark.parametrize("algorithm", ["predicated_pallas_fused",
                                       SPARSE_ALGO])
def test_libsvm_host_tier_ingest(svm_file, algorithm):
    p, xs = svm_file
    forest = port_forest(_forest(F=xs.shape[1], seed=4))
    pages_h, labels, t_h = ld.load_libsvm_csr_external(
        p, xs.shape[1], page_rows=PAGE, tier="host", device="cpu")
    assert t_h.transfer_s == 0.0, "host-tier ingest must not transfer"
    assert t_h.parse_s > 0 and t_h.total_s > 0
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in pages_h.arrays())
    assert pages_h.tier == "host"
    pages_d, _, t_d = ld.load_libsvm_csr_external(p, xs.shape[1],
                                                  page_rows=PAGE,
                                                  device="cpu")
    assert t_d.transfer_s > 0.0
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    ds = store.put_sparse("h", pages=pages_h, num_rows=len(labels),
                          tier="host")
    assert all(a is b for a, b in zip(ds.pages.arrays(), pages_h.arrays()))
    store.put_sparse("d", pages=pages_d, num_rows=len(labels))
    assert store.get("h").tier == "host" and store.get("d").tier == "device"
    engine = _engine(store)
    rh = engine.infer("h", forest, algorithm=algorithm, plan="udf",
                      batch_pages=2)
    rd = engine.infer("d", forest, algorithm=algorithm, plan="udf",
                      batch_pages=2)
    assert rh.tier == "host" and rh.storage_format == "csr"
    assert np.array_equal(_bits(rh.predictions), _bits(rd.predictions))


# ---------------------------------------------------------------------------
# load -> put -> infer against the reference engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan,algorithm", [
    ("udf", "predicated_pallas_fused"), ("rel+reuse", "hummingbird_pallas"),
    ("udf", "quickscorer_pallas_fused")])
def test_csv_load_put_infer_matches_the_reference(tmp_path, plan,
                                                  algorithm):
    x, _ = _data("fraud", 300)
    p = str(tmp_path / "d.csv")
    ld.write_csv(p, x)
    jf = _forest(F=x.shape[1], seed=6)
    rows, _ = ld.load_csv_external(p, device="cpu")
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    store.put("t", rows)
    jrows, _ = jld.load_csv_external(p)
    jstore = JStore(default_page_rows=PAGE)
    jstore.put("t", jrows)
    kw = dict(algorithm=algorithm, plan=plan,
              n_parts=None if plan == "udf" else 3)
    got = _engine(store).infer("t", port_forest(jf), **kw)
    want = JEngine(jstore, reuse_cache=JCache(),
                   plan_cache=JCache()).infer("t", jf, **kw)
    assert np.array_equal(got.predictions.numpy(),
                          np.asarray(want.predictions))


@pytest.mark.parametrize("algorithm", ["predicated_pallas_fused",
                                       "hummingbird_pallas_fused"])
def test_libsvm_csr_load_put_infer_matches_the_reference(svm_file,
                                                         algorithm):
    p, xs = svm_file
    jf = _forest(F=xs.shape[1], seed=8)
    pages, labels, _ = ld.load_libsvm_csr_external(p, xs.shape[1],
                                                   page_rows=PAGE,
                                                   device="cpu")
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    store.put_sparse("s", pages=pages, num_rows=len(labels), labels=labels)
    jpages, jlabels, _ = jld.load_libsvm_csr_external(p, xs.shape[1],
                                                      page_rows=PAGE)
    jstore = JStore(default_page_rows=PAGE)
    jstore.put_sparse("s", pages=jpages, num_rows=len(jlabels),
                      labels=jlabels)
    kw = dict(algorithm=algorithm, plan="udf", batch_pages=3)
    got = _engine(store).infer("s", port_forest(jf), **kw)
    want = JEngine(jstore, reuse_cache=JCache(),
                   plan_cache=JCache()).infer("s", jf, **kw)
    assert np.array_equal(got.predictions.numpy(),
                          np.asarray(want.predictions))
    assert np.array_equal(store.get("s").labels.numpy(),
                          np.asarray(jstore.get("s").labels))


def test_array_rows_load_infer_matches_the_reference(tmp_path):
    x, _ = _data("epsilon", 40)
    p = str(tmp_path / "d.arr")
    ld.write_array_rows(p, x)
    jf = _forest(F=x.shape[1], seed=12)
    rows, _ = ld.load_array_rows_external(p, device="cpu")
    store = TensorBlockStore(device="cpu", default_page_rows=16)
    store.put("e", rows)
    jrows, _ = jld.load_array_rows_external(p)
    jstore = JStore(default_page_rows=16)
    jstore.put("e", jrows)
    kw = dict(algorithm="predicated_pallas_fused", plan="udf")
    got = _engine(store).infer("e", port_forest(jf), **kw)
    want = JEngine(jstore, reuse_cache=JCache(),
                   plan_cache=JCache()).infer("e", jf, **kw)
    assert np.array_equal(got.predictions.numpy(),
                          np.asarray(want.predictions))


# ---------------------------------------------------------------------------
# the store's labels; synth_dataset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["device", "host", "disk"])
def test_put_keeps_labels_as_f32_on_the_store_device(tier):
    x, y = _data("fraud")
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    ds = store.put("f", x, labels=y.astype(np.float64), tier=tier)
    assert ds.labels.dtype == torch.float32 and ds.labels.device.type == \
        "cpu"
    assert np.array_equal(ds.labels.numpy(), y)
    assert store.move("f", "device" if tier != "device" else "host").labels \
        is ds.labels
    sp = store.put_sparse("s", x, labels=torch.from_numpy(y), tier=tier)
    assert np.array_equal(sp.labels.numpy(), y)
    assert store.put("u", x).labels is None
    jstore = JStore(default_page_rows=PAGE)
    assert np.array_equal(ds.labels.numpy(), np.asarray(
        jstore.put("f", x, labels=y.astype(np.float64)).labels))
    with pytest.raises(ValueError, match="labels"):
        store.put("bad", x, labels=y[:-1])


def test_synth_dataset_shapes_match_the_reference():
    for name in ("fraud", "bosch", "epsilon", "year"):
        x, y = ld.synth_dataset(name, max_rows=20)
        jx, jy = jld.synth_dataset(name, max_rows=20)
        assert x.shape == jx.shape and x.dtype == jx.dtype
        assert y.shape == jy.shape and y.dtype == jy.dtype
        assert np.isnan(x).any() == np.isnan(jx).any()
    x, y = ld.synth_dataset("criteo", scale=1e-5)
    assert x.shape == (510, 10_000)
    assert 0.95 < np.isnan(x).mean() < 0.97
    assert set(np.unique(y)) <= {0.0, 1.0}


def test_synth_dataset_is_stable_across_processes():
    """Two processes with different string-hash salts make the same
    arrays (the reference's ``hash(name)`` seed does not)."""
    code = ("import hashlib, sys; from repro_torch.db.loader import "
            "synth_dataset; x, y = synth_dataset('bosch', max_rows=50); "
            "print(hashlib.sha256(x.tobytes() + y.tobytes()).hexdigest())")
    digests = set()
    for salt in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=salt)
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, check=True,
                             timeout=120)
        digests.add(out.stdout.strip())
    assert len(digests) == 1
    x, y = ld.synth_dataset("bosch", max_rows=50)
    assert digests == {hashlib.sha256(x.tobytes() + y.tobytes()).hexdigest()}
