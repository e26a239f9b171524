"""Port parity: the eager torch algorithms and phase 2.

Per-tree raw scores [B, T] are single leaf lookups, so every backend of the
port must equal the JAX reference's bit for bit, NaN rows included.  The
+-inf test pins where the reference's one-hot Pallas kernels diverge from
its own ``_go_left`` and which side the port takes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as jalgs
from repro.core import postprocess as jpost
from repro.core.forest import make_forest as jmake_forest
from repro.kernels.ops import FUSED_KERNEL_ALGORITHMS as JFUSED
from repro_torch.core import algorithms as talgs
from repro_torch.core import postprocess as tpost
from repro_torch.core.forest import pad_trees
from repro_torch.kernels.ops import FUSED_KERNEL_ALGORITHMS as TFUSED
from repro_torch.kernels.ref import REFERENCES, ref_naive

from conftest import random_forest_arrays
from test_torch_forest import port_forest, ref_and_port

BACKENDS = ["naive", "predicated", "compiled", "hummingbird", "quickscorer"]


def _raw_pair(jf, tf, x, backend):
    want = np.asarray(jalgs.predict_raw(jf, jnp.asarray(x), backend))
    got = talgs.predict_raw(tf, torch.from_numpy(x), backend).numpy()
    return got, want


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("depth", [1, 2, 4, 6, 8])
def test_raw_scores_bit_exact(rng, backend, depth):
    jf, tf = ref_and_port(rng, T=5, depth=depth, F=9, seed=depth)
    x = np.random.default_rng(depth).normal(size=(17, 9)).astype(np.float32)
    got, want = _raw_pair(jf, tf, x, backend)
    assert got.shape == (17, 5)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_raw_scores_nan_rows_bit_exact(rng, backend):
    jf, tf = ref_and_port(rng, T=6, depth=5, F=9, seed=7)
    r = np.random.default_rng(7)
    x = r.normal(size=(23, 9)).astype(np.float32)
    x[r.random(x.shape) < 0.3] = np.nan
    x[::5] = np.nan                                # whole NaN rows
    got, want = _raw_pair(jf, tf, x, backend)
    assert np.array_equal(got, want)


def test_refs_match_naive(rng):
    jf, tf = ref_and_port(rng, T=4, depth=6, F=9, seed=11)
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(12, 9)).astype(np.float32))
    root = ref_naive(tf, x)
    for ref in REFERENCES.values():
        assert torch.equal(ref(tf, x), root)


def test_inf_features_follow_go_left_not_the_onehot_kernels(rng):
    """A +-inf feature is an ordinary comparison in ``_go_left``; the
    reference's one-hot Pallas contraction turns it into 0 * inf = NaN, so
    those rows go right on every node.  The port follows ``_go_left``."""
    jf, tf = ref_and_port(rng, T=4, depth=3, F=6, seed=21)
    r = np.random.default_rng(21)
    x = r.normal(size=(16, 6)).astype(np.float32)
    inf_rows = np.array([1, 4, 9, 14])
    x[inf_rows, r.integers(0, 6, 4)] = [np.inf, -np.inf, np.inf, -np.inf]
    x[3, 2] = np.nan
    want_raw = np.asarray(jalgs.predict_raw(jf, jnp.asarray(x), "predicated"))
    for backend in BACKENDS:
        got, want = _raw_pair(jf, tf, x, backend)
        assert np.array_equal(got, want), backend
    want_sum = want_raw.sum(-1)
    for name, fused in TFUSED.items():
        got = fused(tf, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want_sum, rtol=1e-6, atol=1e-6)
        ref_kernel = np.asarray(JFUSED[name](jf, jnp.asarray(x),
                                             interpret=True))
        finite = np.setdiff1d(np.arange(16), inf_rows)
        np.testing.assert_allclose(got[finite], ref_kernel[finite],
                                   rtol=1e-6, atol=1e-6)
        # the divergence itself: pinned so a change on either side shows
        assert not np.allclose(got[inf_rows], ref_kernel[inf_rows]), name


@pytest.mark.parametrize("T", [3, 7, 37, 500, 1600])
def test_rf_mean_divides_where_the_jitted_reference_multiplies(T):
    """The RandomForest mean (ROADMAP section 3, item 1).  Jitted inside
    the reference's plan stages, ``summed / num_trees`` becomes
    ``summed * (1/T)``, which misses the correctly rounded quotient by 1
    ulp on some sums; the port divides, as the reference's eager call
    does.  Pinned on integer sums so a change on either side shows."""
    summed = np.arange(-300, 301, dtype=np.float32)
    kw = dict(model_type="randomforest", task="regression", num_trees=T)
    jitted = np.asarray(jax.jit(lambda s: jpost.postprocess(s, **kw))(
        jnp.asarray(summed)))
    assert np.array_equal(jitted,
                          summed * (np.float32(1.0) / np.float32(T)))
    got = tpost.postprocess(torch.from_numpy(summed), **kw).numpy()
    assert np.array_equal(got, summed / np.float32(T))
    assert np.array_equal(got, np.asarray(jpost.postprocess(
        jnp.asarray(summed), **kw)))
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - jitted.view(np.int32).astype(np.int64))
    assert ulps.max() == 1
    assert 0 < int((ulps == 1).sum()) < summed.size


@pytest.mark.parametrize("model_type,task", [
    ("xgboost", "classification"), ("lightgbm", "regression"),
    ("randomforest", "classification"), ("randomforest", "regression")])
def test_postprocess_matches_reference(rng, model_type, task):
    summed = np.random.default_rng(3).normal(size=19).astype(np.float32)
    kw = dict(model_type=model_type, task=task, num_trees=7,
              base_score=0.3)
    want = np.asarray(jpost.postprocess(jnp.asarray(summed), **kw))
    got = tpost.postprocess(torch.from_numpy(summed), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        tpost.postprocess(torch.from_numpy(summed), model_type="nope",
                          num_trees=1)


@pytest.mark.parametrize("model_type,task", [
    ("xgboost", "classification"), ("lightgbm", "regression"),
    ("randomforest", "classification"), ("randomforest", "regression")])
def test_predict_label_matches_reference(rng, model_type, task):
    """Labels equal the reference's: ``p >= 0.5`` as int32 for
    classification, ``p`` for regression (within 1e-6).  RandomForest's
    mean may land 1 ulp off the reference's (ROADMAP queue 3, kept
    divergence 1), which can flip a label only for a probability within
    1 ulp of 0.5: the inputs are held away from it, and the test checks
    that they are.  Leaves in [0, 1) put a RandomForest's mean on both
    sides of 0.5, leaves in [-0.5, 0.5) a boosted sum's sigmoid."""
    fe, th, dl, _ = random_forest_arrays(rng, T=6, depth=4, F=11, seed=32)
    lv = np.random.default_rng(33).random((6, 16)).astype(np.float32)
    if model_type != "randomforest":
        lv -= np.float32(0.5)
    jf = jmake_forest(fe, th, lv, default_left=dl, n_features=11,
                      model_type=model_type, task=task)
    tf = port_forest(jf)
    x = np.random.default_rng(32).normal(size=(64, 11)).astype(np.float32)
    p = np.asarray(jpost.predict_proba(jf, jnp.asarray(x)))
    want = np.asarray(jpost.predict_label(jf, jnp.asarray(x)))
    got = tpost.predict_label(tf, torch.from_numpy(x)).numpy()
    if task == "classification":
        assert np.abs(p - 0.5).min() > 1e-6
        assert got.dtype == np.int32 == want.dtype
        assert np.array_equal(got, want)
        assert 0 < int(got.sum()) < got.size        # both labels occur
    else:
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_predict_proba_matches_reference(rng):
    jf, tf = ref_and_port(rng, T=6, depth=4, F=11, seed=31)
    x = np.random.default_rng(31).normal(size=(10, 11)).astype(np.float32)
    want = np.asarray(jpost.predict_proba(jf, jnp.asarray(x)))
    got = tpost.predict_proba(tf, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_pad_trees_keeps_sum_and_mean(rng):
    fe = rng.integers(0, 7, (5, 7)).astype(np.int32)
    th = rng.normal(size=(5, 7)).astype(np.float32)
    lv = rng.random((5, 8)).astype(np.float32)
    jf = jmake_forest(fe, th, lv, n_features=7, model_type="randomforest")
    tf = port_forest(jf)
    x = torch.from_numpy(rng.normal(size=(9, 7)).astype(np.float32))
    base = talgs.predict_raw(tf, x).sum(-1)
    padded, true_T = pad_trees(tf, 8)
    assert padded.num_trees == 8 and true_T == 5
    # torch.sum's reduction order depends on the length: 1e-6, as the
    # reference's own padding test holds it
    torch.testing.assert_close(talgs.predict_raw(padded, x).sum(-1), base,
                               rtol=1e-6, atol=1e-6)
    mean = tpost.postprocess(talgs.predict_raw(padded, x).sum(-1),
                             model_type="randomforest", num_trees=true_T)
    want = np.asarray(jpost.predict_proba(jf, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(mean.numpy(), want, rtol=1e-6, atol=1e-7)


def test_unknown_algorithm_raises(rng):
    _, tf = ref_and_port(rng, seed=1)
    with pytest.raises(ValueError, match="unknown algorithm"):
        talgs.predict_raw(tf, torch.zeros((1, 11)), "nope")


def test_all_algorithms_registered():
    assert set(talgs.ALGORITHMS) == set(jalgs.ALGORITHMS)


def test_bf16_forest_matches_reference(rng):
    """``astype`` narrows thresholds and leaves exactly like the reference."""
    jf, tf = ref_and_port(rng, T=4, depth=4, F=11, seed=41)
    jq = jf.astype(jnp.bfloat16).astype(jnp.float32)
    tq = tf.astype(torch.bfloat16).astype(torch.float32)
    x = np.random.default_rng(41).normal(size=(8, 11)).astype(np.float32)
    got, want = _raw_pair(jq, tq, x, "predicated")
    assert np.array_equal(got, want)
    assert dataclasses.replace(tq).threshold.dtype == torch.float32
