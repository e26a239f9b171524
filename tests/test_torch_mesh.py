"""Port parity: multi-device forest inference on a ``(data, model)`` mesh.

The reference runs its mesh only with eight forced host devices
(``tests/test_multidevice.py``), so its half of the comparison runs in ONE
subprocess (this file run as a script, with
``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu``),
which writes its predictions and its trained forest to an ``.npz``; a
failure or a timeout of that process fails the tests that read it.  The
port's mesh is eight explicit ``"cpu"`` positions.

  * against the reference's mesh: udf / rel / rel+reuse x the three fused
    names and one raw name x dense and CSR on a (2, 4) mesh, rel on
    (1, 8) and (8, 1), ``infer_rows``, and one streamed training run --
    bit for bit on the integer-leaf XGBoost regression forest, within
    1e-6 on a float-leaf classification forest;
  * in process: the port's mesh equals its mesh-less run at ``n_parts =
    n_model`` bit for bit for every plan, name, format, tier and mesh
    shape; the stage names and ``StageReport.devices``; launches a batch;
    plan-cache entries by mesh; the CSR compact tile at the local batch;
    ``infer_rows``' divisibility rule; batch rounding; the refusals of
    ``make_local_mesh`` and the store; replicas held once a device, and
    held by the plans alone, so a dropped forest is collected.

Sizes are the reference test's: B 512, F 16, T 24, pages of 64.
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

B, F, T, PAGE = 512, 16, 24, 64
DEPTH = 4
FUSED = ["predicated_pallas_fused", "hummingbird_pallas_fused",
         "quickscorer_pallas_fused"]
RAW = "predicated_pallas"
ALGORITHMS = FUSED + [RAW]
PLANS = ["udf", "rel", "rel+reuse"]
FORMATS = ["dense", "csr"]
MESHES = [(2, 4), (4, 2), (8, 1), (1, 8)]
ROWS = (32, 128)
TRAIN_N = 700
REF_TIMEOUT_S = 300
ROOT = Path(__file__).resolve().parents[1]


def inputs():
    """The seeded inputs both sides build: rows with NaN entries and whole
    NaN rows, forest arrays (integer leaves for the bit-for-bit forest),
    and a labelled training table."""
    r = np.random.default_rng(0)
    x = r.normal(size=(B, F)).astype(np.float32)
    x[r.random(x.shape) < 0.1] = np.nan
    x[::37] = np.nan
    I, L = (1 << DEPTH) - 1, 1 << DEPTH
    arrays = dict(
        feature=r.integers(0, F, (T, I)).astype(np.int32),
        threshold=r.normal(size=(T, I)).astype(np.float32),
        default_left=r.random((T, I)) < 0.5,
        int_leaves=r.integers(-8, 9, (T, L)).astype(np.float32),
        float_leaves=r.normal(size=(T, L)).astype(np.float32))
    tx = r.normal(size=(TRAIN_N, F)).astype(np.float32)
    ty = (np.nan_to_num(tx) @ r.normal(size=F)).astype(np.float32)
    tx[r.random(tx.shape) < 0.1] = np.nan
    return x, arrays, tx, ty


def _forests(make_forest, arrays, **kw):
    """(integer-leaf XGBoost regression, float-leaf classification)."""
    common = dict(default_left=arrays["default_left"], n_features=F, **kw)
    return (make_forest(arrays["feature"], arrays["threshold"],
                        arrays["int_leaves"], model_type="xgboost",
                        task="regression", base_score=0.5, **common),
            make_forest(arrays["feature"], arrays["threshold"],
                        arrays["float_leaves"], model_type="xgboost",
                        **common))


def _reference_main(out_path: str) -> None:
    """The reference's mesh queries (run in the forced-8-device process)."""
    import jax
    from jax.sharding import Mesh

    from repro.core.forest import make_forest
    from repro.core.reuse import ModelReuseCache
    from repro.core.train import TrainConfig, quantile_bin_edges
    from repro.db.query import ForestQueryEngine
    from repro.db.store import TensorBlockStore

    assert len(jax.devices()) >= 8, jax.devices()
    x, arrays, tx, ty = inputs()
    exact, close = _forests(make_forest, arrays)
    out = {}

    def engine(shape):
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape),
                    ("data", "model"))
        store = TensorBlockStore(mesh, default_page_rows=PAGE)
        store.put("dense", x)
        store.put_sparse("csr", x)
        return ForestQueryEngine(store, reuse_cache=ModelReuseCache(),
                                 plan_cache=ModelReuseCache()), store

    e24, _ = engine((2, 4))
    for plan in PLANS:
        for alg in ALGORITHMS:
            for fmt in FORMATS:
                res = e24.infer(fmt, exact, algorithm=alg, plan=plan)
                out[f"q/2x4/{plan}/{alg}/{fmt}"] = np.asarray(
                    res.predictions)
        res = e24.infer("dense", close, algorithm=FUSED[0], plan=plan)
        out[f"close/{plan}"] = np.asarray(res.predictions)
    for shape in ((1, 8), (8, 1)):
        e, _ = engine(shape)
        res = e.infer("dense", exact, algorithm=FUSED[0], plan="rel")
        out[f"q/{shape[0]}x{shape[1]}/rel"] = np.asarray(res.predictions)
    for rows in ROWS:
        for plan in ("udf", "rel+reuse"):
            res = e24.infer_rows(exact, x[:rows], algorithm=FUSED[0],
                                 plan=plan)
            out[f"rows/{rows}/{plan}"] = np.asarray(res.predictions)
    # one streamed training run on the (2, 4) mesh, host tier
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                ("data", "model"))
    store = TensorBlockStore(mesh, default_page_rows=PAGE)
    store.put("t", tx, labels=ty, tier="host")
    cfg = TrainConfig(model_type="xgboost", num_trees=4, max_depth=3,
                      num_bins=16, task="regression")
    edges = quantile_bin_edges(tx, cfg.num_bins)
    res = ForestQueryEngine(store).train("t", cfg, edges=edges,
                                         batch_pages=3)
    out["train/edges"] = np.asarray(edges)
    for name, arr in res.forest.arrays().items():
        out[f"train/{name}"] = np.asarray(arr)
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1])
    sys.exit(0)


# -- the in-process half ------------------------------------------------------

from repro_torch.core.forest import (Forest,  # noqa: E402
                                     make_forest)
from repro_torch.core.reuse import ModelReuseCache, mesh_signature  # noqa: E402
from repro_torch.core.train import TrainConfig  # noqa: E402
from repro_torch.db.query import ForestQueryEngine  # noqa: E402
from repro_torch.db.store import TensorBlockStore  # noqa: E402
from repro_torch.db.shards import RowShards  # noqa: E402
from repro_torch.dist.sharding import Mesh, make_forest_plan  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402

TIERS = ("device", "host", "disk")


def cpu_mesh(n_data: int, n_model: int):
    return make_local_mesh(n_data, n_model, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def data():
    x, arrays, tx, ty = inputs()
    exact, close = _forests(make_forest, arrays, device="cpu")
    return x, exact, close, tx, ty


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's mesh results, or the reason there are none."""
    out = tmp_path_factory.mktemp("mesh-reference") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    try:
        proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                              capture_output=True, text=True,
                              timeout=REF_TIMEOUT_S, cwd=str(ROOT))
    except subprocess.TimeoutExpired:
        return f"the reference process ran past {REF_TIMEOUT_S} s"
    if proc.returncode != 0:
        return f"the reference process failed:\n{proc.stderr[-4000:]}"
    with np.load(out) as z:
        return dict(z)


def _ref(reference) -> dict:
    if isinstance(reference, str):
        pytest.fail(reference)
    return reference


def _engine(mesh, tier="device", x=None, **kw):
    store = TensorBlockStore("cpu", mesh=mesh, default_page_rows=PAGE, **kw)
    if x is not None:
        store.put("dense", x, tier=tier)
        store.put_sparse("csr", x, tier=tier)
    return ForestQueryEngine(store, reuse_cache=ModelReuseCache(),
                             plan_cache=ModelReuseCache())


@pytest.fixture(scope="module")
def engines(data):
    """(mesh shape, tier) -> engine, and the mesh-less engine per tier."""
    x = data[0]
    out = {}
    for tier in TIERS:
        out[None, tier] = _engine(None, tier, x)
        for shape in MESHES:
            out[shape, tier] = _engine(cpu_mesh(*shape), tier, x)
    return out


# -- against the reference's mesh ---------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("plan", PLANS)
def test_mesh_matches_the_reference_mesh(reference, engines, data, plan,
                                         algorithm, fmt):
    want = _ref(reference)[f"q/2x4/{plan}/{algorithm}/{fmt}"]
    got = engines[(2, 4), "device"].infer(fmt, data[1], algorithm=algorithm,
                                          plan=plan)
    assert got.predictions.shape == (B,)
    np.testing.assert_array_equal(got.predictions.numpy(), want)
    assert got.mesh_devices == 8
    assert got.n_parts == (1 if plan == "udf" else 4)


@pytest.mark.parametrize("shape", [(1, 8), (8, 1)])
def test_mesh_shapes_match_the_reference(reference, engines, data, shape):
    want = _ref(reference)[f"q/{shape[0]}x{shape[1]}/rel"]
    got = engines[shape, "device"].infer("dense", data[1],
                                         algorithm=FUSED[0], plan="rel")
    assert got.n_parts == shape[1]
    np.testing.assert_array_equal(got.predictions.numpy(), want)


@pytest.mark.parametrize("plan", PLANS)
def test_float_leaves_within_1e6_of_the_reference(reference, engines, data,
                                                  plan):
    want = _ref(reference)[f"close/{plan}"]
    got = engines[(2, 4), "device"].infer("dense", data[2],
                                          algorithm=FUSED[0], plan=plan)
    np.testing.assert_allclose(got.predictions.numpy(), want, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("plan", ["udf", "rel+reuse"])
@pytest.mark.parametrize("rows", ROWS)
def test_infer_rows_matches_the_reference(reference, engines, data, rows,
                                          plan):
    want = _ref(reference)[f"rows/{rows}/{plan}"]
    got = engines[(2, 4), "device"].infer_rows(
        data[1], data[0][:rows], algorithm=FUSED[0], plan=plan)
    assert got.batch_rows == rows
    np.testing.assert_array_equal(got.predictions.numpy(), want)


def test_streamed_training_matches_the_reference(reference, data):
    ref = _ref(reference)
    tx, ty = data[3], data[4]
    store = TensorBlockStore("cpu", mesh=cpu_mesh(2, 4),
                             default_page_rows=PAGE)
    store.put("t", tx, labels=ty, tier="host")
    cfg = TrainConfig(model_type="xgboost", num_trees=4, max_depth=3,
                      num_bins=16, task="regression")
    res = ForestQueryEngine(store).train("t", cfg, edges=ref["train/edges"],
                                         batch_pages=3)
    for name, arr in res.forest.arrays().items():
        want = ref[f"train/{name}"]
        assert arr.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(arr.numpy(), want, err_msg=name)


# -- in process: mesh == mesh-less, bit for bit --------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("algorithm", ALGORITHMS + ["predicated"])
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_equals_meshless_at_n_model(engines, data, shape, plan,
                                         algorithm, fmt):
    forest = data[2]                       # float leaves: still bitwise
    kw = dict(algorithm=algorithm, plan=plan)
    got = engines[shape, "device"].infer(fmt, forest, **kw)
    want = engines[None, "device"].infer(
        fmt, forest, n_parts=None if plan == "udf" else shape[1], **kw)
    assert torch.equal(got.predictions, want.predictions)
    assert got.n_parts == want.n_parts


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("tier", ["host", "disk"])
@pytest.mark.parametrize("shape", [(2, 4), (4, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_off_device_tiers_equal_the_device_tier(engines, data, shape, tier,
                                                plan, fmt):
    """Streamed in data-unit batches, bit for bit the device tier."""
    kw = dict(algorithm=FUSED[1], plan=plan, batch_pages=3)
    got = engines[shape, tier].infer(fmt, data[1], **kw)
    want = engines[shape, "device"].infer(fmt, data[1], algorithm=FUSED[1],
                                          plan=plan)
    assert got.tier == tier and got.scan.batches > 1
    assert got.scan.batch_pages % shape[0] == 0
    assert 1 <= got.scan.max_in_flight <= 2
    assert torch.equal(got.predictions, want.predictions)


def test_stage_names_and_devices(engines, data):
    e = engines[(2, 4), "device"]
    udf = e.infer("dense", data[1], algorithm=FUSED[0], plan="udf")
    ops = [op for r in udf.stage_reports for op in r.operators]
    assert "transform:forest-udf@shard_map" in ops
    assert all(r.devices == 8 for r in udf.stage_reports)
    rel = e.infer("csr", data[1], algorithm=RAW, plan="rel")
    names = [op for r in rel.stage_reports for op in r.operators]
    assert "cross-product:psum-agg" in names
    assert "aggregate" not in names and "gather:csr-compact" not in names
    assert rel.num_stages == 3
    kernel = [r for r in rel.stage_reports
              if "cross-product:psum-agg" in r.operators]
    part = [r for r in rel.stage_reports if "partition" in r.name]
    assert kernel[0].devices == 8 and part[0].devices == 8
    meshless = engines[None, "device"].infer("dense", data[1],
                                             algorithm=FUSED[0], plan="rel")
    assert {r.devices for r in meshless.stage_reports} == {1}
    assert meshless.mesh_devices == 1


def test_data_only_mesh_runs_the_template_per_shard(data):
    """A mesh with no model axis: rel runs the mesh-less stages on each
    row shard, and an explicit n_parts stands."""
    x = data[0]
    mesh = Mesh(["cpu"] * 8, ("data",))
    e = _engine(mesh, x=x)
    got = e.infer("dense", data[1], algorithm=FUSED[0], plan="rel",
                  n_parts=8)
    want = _engine(None, x=x).infer("dense", data[1], algorithm=FUSED[0],
                                    plan="rel", n_parts=8)
    assert got.n_parts == 8
    assert "aggregate" in [op for r in got.stage_reports
                           for op in r.operators]
    assert torch.equal(got.predictions, want.predictions)


@pytest.mark.parametrize("plan,per_batch", [("udf", 2), ("rel", 8)])
def test_launches_a_batch(monkeypatch, data, plan, per_batch):
    """udf: one launch a data shard; rel: one a position."""
    calls = []
    fn = kops.FUSED_KERNEL_ALGORITHMS[FUSED[0]]

    def counted(forest, x, **kw):
        calls.append(x.shape[0])
        return fn(forest, x, **kw)

    monkeypatch.setitem(kops.FUSED_KERNEL_ALGORITHMS, FUSED[0], counted)
    e = _engine(cpu_mesh(2, 4), x=data[0])
    res = e.infer("dense", data[1], algorithm=FUSED[0], plan=plan,
                  batch_pages=4)
    assert res.scan.batches == 2
    assert len(calls) == per_batch * res.scan.batches
    assert set(calls) == {4 * PAGE // 2}     # the local batch


def test_csr_compact_tile_is_local(monkeypatch, data):
    """The gather runs inside each shard: tiles of B_local rows only."""
    import repro_torch.db.query as q
    shapes = []
    real = q.csr_block_to_dense

    def spy(block, inv, f_used):
        out = real(block, inv, f_used)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(q, "csr_block_to_dense", spy)
    e = _engine(cpu_mesh(2, 4), x=data[0])
    for plan in ("udf", "rel"):
        shapes.clear()
        e.infer("csr", data[1], algorithm=FUSED[1], plan=plan)
        assert shapes and {s[0] for s in shapes} == {B // 2}, plan


def test_plan_cache_entries_by_mesh(data):
    x = data[0]
    plans = ModelReuseCache()
    e1 = _engine(None, x=x)
    e8 = _engine(cpu_mesh(1, 8), x=x)
    e1.plan_cache = e8.plan_cache = plans
    kw = dict(algorithm=FUSED[0], model_id="xmesh")
    r1 = e1.infer("dense", data[1], plan="udf", **kw)
    r8 = e8.infer("dense", data[1], plan="udf", **kw)
    assert not r8.plan_reuse_hit
    e1.infer("dense", data[1], plan="rel+reuse", n_parts=8, **kw)
    assert not e8.infer("dense", data[1], plan="rel+reuse",
                        **kw).plan_reuse_hit
    assert len(plans) == 4
    assert torch.equal(r1.predictions, r8.predictions)
    assert e8.infer("dense", data[1], plan="udf", **kw).plan_reuse_hit
    keys = {k[-1] for k in plans._entries if k[0] == "udf-plan"}
    assert keys == {1, mesh_signature(e8.mesh)}


def test_mesh_signature_is_by_content():
    a, b = cpu_mesh(2, 4), cpu_mesh(2, 4)
    assert mesh_signature(a) == mesh_signature(b) != mesh_signature(
        cpu_mesh(4, 2))
    assert mesh_signature(None) == 1
    assert mesh_signature(a) == (("data", "model"), (2, 4), ("cpu",) * 8)


def test_batch_pages_round_to_the_data_axis(engines, data):
    e = engines[(2, 4), "device"]
    whole = e.infer("dense", data[1], algorithm=FUSED[0])
    odd = e.infer("dense", data[1], algorithm=FUSED[0], batch_pages=3)
    assert odd.scan.batch_pages == 4 and odd.scan.batches == 2
    assert torch.equal(odd.predictions, whole.predictions)


def test_store_pads_to_the_data_axis():
    x = np.ones((3 * PAGE + 5, F), np.float32)
    store = TensorBlockStore("cpu", mesh=cpu_mesh(4, 2),
                             default_page_rows=PAGE)
    assert store.data_axis_size == 4
    assert store.put("d", x).num_pages == 4
    assert store.put_sparse("c", x).num_pages == 4
    assert store.put("h", x, tier="host").num_pages == 4
    res = store.put_result("r", torch.ones(5 * PAGE), 5 * PAGE)
    assert res.num_pages == 8
    shards = store.data_sharding().split(store.get("d").data)
    assert isinstance(shards, RowShards) and len(shards.parts) == 4
    # one device: the shards are views of the stored table, not copies
    assert shards.parts[1].data_ptr() == \
        store.get("d").data[PAGE:].data_ptr()


def test_infer_rows_refuses_a_batch_off_the_data_axis(engines, data):
    with pytest.raises(ValueError, match="data axis"):
        engines[(4, 2), "device"].infer_rows(data[1], data[0][:6],
                                             algorithm=FUSED[0])


def test_replicas_are_held_once_a_device(data):
    """Eight positions on one device: the forest and its tree shards are
    not copied, and the pages are the store's own."""
    fplan = make_forest_plan(cpu_mesh(2, 4))
    forest = data[1]
    reps = fplan.replicas(forest)
    assert list(reps) == [torch.device("cpu")] and reps[
        torch.device("cpu")] is forest
    shards = fplan.shard_forest(forest)
    assert len(shards) == 4 and all(len(s) == 1 for s in shards)
    assert shards[1][torch.device("cpu")].threshold.data_ptr() == \
        forest.threshold[6:].data_ptr()
    assert fplan.forest_shardings(forest) == [
        (m * 6, 6, (torch.device("cpu"),)) for m in range(4)]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("plan", ["udf", "rel+reuse"])
def test_a_dropped_forest_is_collected_after_mesh_queries(data, plan, fmt):
    """The replicas and tree shards live with the plans that use them:
    once the engine's caches are swept, nothing holds the forest or any
    forest made from it (its padded, compacted or sliced forms)."""
    def live_forests() -> int:
        gc.collect()
        return sum(type(o) is Forest for o in gc.get_objects())

    x, arrays = data[0], inputs()[1]
    e = _engine(cpu_mesh(2, 4), x=x)
    before = live_forests()
    forest = _forests(make_forest, arrays, device="cpu")[0]
    want = e.infer(fmt, forest, algorithm=FUSED[0], plan=plan,
                   model_id="dropped")
    e.infer_rows(forest, x[:8], algorithm=FUSED[0], plan=plan)
    assert e.infer(fmt, forest, algorithm=FUSED[0], plan=plan,
                   model_id="dropped").plan_reuse_hit
    assert live_forests() > before
    ref = weakref.ref(forest)
    del forest
    e.invalidate()
    assert ref() is None
    assert live_forests() == before
    assert want.predictions.shape == (B,)


def test_distinct_card_placement_is_planned():
    """A mesh of distinct cards, checked for placement without cards."""
    devs = [torch.device("cuda", i) for i in range(8)]
    fplan = make_forest_plan(Mesh(np.array(devs, object).reshape(2, 4),
                                  ("data", "model")))
    assert fplan.data_devices == (devs[0], devs[4])
    assert fplan.position(1, 2) == devs[6]
    sh = fplan.forest_shardings(type("F", (), {"num_trees": 24})())
    assert sh[3] == (18, 6, (devs[3], devs[7]))


def test_refusals():
    with pytest.raises(ValueError, match="one device type"):
        make_local_mesh(1, 2, devices=["cpu", "meta"])
    if torch.cuda.device_count() < 8:
        with pytest.raises(RuntimeError, match="distinct cards"):
            make_local_mesh(2, 4)
    with pytest.raises(ValueError, match="takes 8 devices"):
        make_local_mesh(2, 4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="cannot take a mesh"):
        TensorBlockStore("meta", mesh=cpu_mesh(2, 4))
    with pytest.raises(ValueError, match="axes"):
        Mesh(["cpu"] * 2, ("rows",))
    # a pod axis is the LM's: the forest plans and the store refuse it
    pods = Mesh(np.array(["cpu"] * 8, object).reshape(2, 2, 2),
                ("pod", "data", "model"))
    with pytest.raises(ValueError, match="pod axis"):
        make_forest_plan(pods)
    with pytest.raises(ValueError, match="pod axis"):
        TensorBlockStore("cpu", mesh=pods)
