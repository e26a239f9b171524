"""Port parity: the trainer (``repro_torch.core.train``) and its random
draws (``repro_torch.core.prng``) against ``repro.core.train`` and
``jax.random`` on the CPU.

  * ``prng``: ``split``, ``uniform``, ``permutation`` and
    ``poisson(key, 1.0, (n,))`` equal ``jax.random``'s bit for bit at six
    seeds and n from 1 to 100,000 (a Knuth draw may differ where XLA's
    ``log`` and numpy's land on two sides of -1; none does at these keys);
  * binning, routing and histograms equal the reference's bit for bit,
    ±inf / NaN inputs and all-+inf edges included;
  * ``train_forest`` gives the reference's forests bit for bit for
    REGRESSION in all three families (the same bootstrap, feature subsets,
    GOSS threshold and sample) and for RandomForest classification, whose
    gradients take no sigmoid;
  * XGBoost / LightGBM CLASSIFICATION is held to a tolerance:
    ``torch.sigmoid`` and XLA's logistic differ by one or two ulps on
    ~0.4 % of float32 inputs, so g / h differ by ulps.  The tests assert
    the same split features, thresholds, default directions and terminal
    nodes at the seeds below, and leaves, node values and predictions
    within rtol = atol = 1e-6;
  * the reference's own ``tests/test_forest_train.py`` claims, each run on
    the port.

The same inputs, made with numpy from a seed, go through both packages
(``N, F = 700, 9``, 10 % NaN, as ``tests/test_train_streaming.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import train as jtrain
from repro_torch.core import prng
from repro_torch.core import train as ttrain
from repro_torch.core.postprocess import predict_proba

FAMILIES = ("randomforest", "xgboost", "lightgbm")
N, F = 700, 9
RTOL = ATOL = 1e-6


def _data(seed=0, nan_frac=0.1, regression=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, F)).astype(np.float32)
    w = rng.normal(size=F).astype(np.float32)
    s = np.nan_to_num(x) @ w
    y = (s if regression else (s > 0)).astype(np.float32)
    if nan_frac:
        x[rng.random(x.shape) < nan_frac] = np.nan
    return x, y


def port_cfg(jcfg) -> ttrain.TrainConfig:
    """The reference's TrainConfig as the port's, field for field."""
    return ttrain.TrainConfig(**dataclasses.asdict(jcfg))


def _key_words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key) if jnp.issubdtype(
        key.dtype, jax.dtypes.prng_key) else key, np.uint32)


def assert_forests_bitwise(jf, tf, msg=""):
    """Field by field, dtypes included (``tests/test_train_streaming.py``'s
    rule), plus the static metadata."""
    assert (tf.depth, tf.n_features, tf.model_type, tf.task,
            tf.base_score) == (jf.depth, jf.n_features, jf.model_type,
                               jf.task, jf.base_score), msg
    for name, arr in jf.arrays().items():
        want = np.asarray(arr)
        got = getattr(tf, name).cpu().numpy()
        assert got.dtype == want.dtype, (msg, name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{msg} {name}")


def assert_forests_close(jf, tf, x, msg=""):
    """The classification contract: the same splits; leaves, node values
    and predictions within rtol = atol = 1e-6."""
    for name in ("feature", "threshold", "default_left", "node_is_leaf"):
        np.testing.assert_array_equal(getattr(tf, name).cpu().numpy(),
                                      np.asarray(getattr(jf, name)),
                                      err_msg=f"{msg} {name}")
    for name in ("leaf_value", "node_value"):
        got = getattr(tf, name).cpu().numpy()
        assert got.dtype == np.asarray(getattr(jf, name)).dtype
        np.testing.assert_allclose(got, np.asarray(getattr(jf, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=msg)
    from repro.core.postprocess import predict_proba as jpredict
    want = np.asarray(jpredict(jf, jnp.asarray(x)))
    got = predict_proba(tf, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=msg)


# -- prng: the four draws -----------------------------------------------------

SEEDS = (0, 1, 3, 7, 42, 12345)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    k = prng.prng_key(seed)
    np.testing.assert_array_equal(k, _key_words(key))
    for num in (2, 3, 4, 7):
        np.testing.assert_array_equal(
            prng.split(k, num), _key_words(jax.random.split(key, num)))


@pytest.mark.parametrize("n", [1, 2, 9, 100, 1000, 100_000])
@pytest.mark.parametrize("seed", SEEDS[:5])
def test_draws_equal_jax_bit_for_bit(seed, n):
    key = jax.random.PRNGKey(seed)
    k = prng.prng_key(seed)
    u = prng.uniform(k, n)
    assert u.dtype == np.float32
    np.testing.assert_array_equal(
        u.view(np.uint32),
        np.asarray(jax.random.uniform(key, (n,))).view(np.uint32))
    p = prng.permutation(k, n)
    want = np.asarray(jax.random.permutation(key, n))
    assert p.dtype == want.dtype
    np.testing.assert_array_equal(p, want)
    pois = prng.poisson(k, 1.0, n)
    want = np.asarray(jax.random.poisson(key, 1.0, (n,)))
    assert pois.dtype == want.dtype
    np.testing.assert_array_equal(pois, want)


def test_poisson_edge_rates():
    k = prng.prng_key(5)
    assert not prng.poisson(k, 0.0, 17).any()
    np.testing.assert_array_equal(
        prng.poisson(k, 3.5, 500),
        np.asarray(jax.random.poisson(jax.random.PRNGKey(5), 3.5, (500,))))
    with pytest.raises(ValueError, match="Knuth"):
        prng.poisson(k, 12.0, 4)


def test_goss_quantile_equals_jnp_quantile():
    """The GOSS threshold: ``jnp.quantile``'s linear method in float32,
    its last step fused, over many sizes and fractions."""
    quantile = jax.jit(jnp.quantile)
    for n in (1, 2, 3, 7, 100, 701, 2999):
        for s in range(40):
            r = np.random.default_rng(1000 * n + s)
            ag = np.abs(r.normal(size=n)).astype(np.float32)
            if s % 5 == 0:
                ag[: n // 2] = ag[0]                 # ties
            a = float(r.random())
            want = np.asarray(quantile(jnp.asarray(ag), 1.0 - a))
            got = ttrain._quantile_f32(ag, 1.0 - a)
            assert got.dtype == np.float32
            assert got.view(np.uint32) == want.view(np.uint32), (s, n, a)


# -- binning, routing, histograms ---------------------------------------------


def test_train_config_equals_the_reference():
    assert [f.name for f in dataclasses.fields(ttrain.TrainConfig)] == \
        [f.name for f in dataclasses.fields(jtrain.TrainConfig)]
    assert dataclasses.asdict(ttrain.TrainConfig()) == \
        dataclasses.asdict(jtrain.TrainConfig())


@pytest.mark.parametrize("num_bins", [2, 16, 64, 255])
def test_quantile_bin_edges_equal_the_reference(num_bins):
    x, _ = _data(seed=num_bins)
    x[:, 2] = 1.5                                  # constant column
    x[:, 4] = np.nan                               # all missing
    x[::3, 5] = np.round(x[::3, 5])                # duplicate quantiles
    got = ttrain.quantile_bin_edges(x, num_bins)
    want = jtrain.quantile_bin_edges(x, num_bins)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ttrain.edges_from_sample(x[::7], num_bins),
                                  jtrain.edges_from_sample(x[::7], num_bins))


@pytest.mark.parametrize("num_bins", [2, 16, 64])
def test_bin_features_equal_the_reference(num_bins):
    x, _ = _data(seed=num_bins + 1)
    edges = jtrain.quantile_bin_edges(x, num_bins)
    edges[3] = np.inf                              # an unsplittable feature
    x[0, :] = np.inf
    x[1, :] = -np.inf
    x[2, :] = np.nan
    x[3, 0] = edges[0, 0]                          # exactly on an edge
    x[4, 0] = -0.0
    want = np.asarray(jtrain.bin_features(x, edges))
    got = ttrain.bin_features(torch.from_numpy(x), torch.from_numpy(edges))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("level", range(5))
def test_route_level_equals_the_reference(level):
    r = np.random.default_rng(level)
    num_bins, rows = 16, 500
    bins = r.integers(0, num_bins + 1, (rows, F)).astype(np.int32)
    n = 1 << level
    node_of = r.integers(n - 1, 2 * n - 1, rows).astype(np.int32)
    feat = r.integers(0, F, n).astype(np.int32)
    sbin = r.integers(0, num_bins - 1, n).astype(np.int32)
    dleft = r.random(n) < 0.5
    term = r.random(n) < 0.3
    want = np.asarray(jtrain.route_level(
        jnp.asarray(bins), jnp.asarray(node_of), jnp.asarray(feat),
        jnp.asarray(sbin), jnp.asarray(dleft), jnp.asarray(term),
        level=level, num_bins=num_bins))
    for b in (bins, bins.astype(np.uint8)):       # the bins relation's dtype
        got = ttrain.route_level(torch.from_numpy(b),
                                 torch.from_numpy(node_of), feat, sbin,
                                 dleft, term, level=level,
                                 num_bins=num_bins)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows", [640, 3 * ttrain.HIST_CHUNK_ROWS + 17])
def test_hist_update_equals_the_reference_and_any_slicing(rows):
    """One call, its row chunks included, and any slicing of the rows
    equal the reference's whole-array ``np.add.at`` bit for bit."""
    r = np.random.default_rng(9)
    nb, level = 16, 3
    bins = r.integers(0, nb + 1, (rows, F)).astype(np.uint8)
    node_of = r.integers(7, 15, rows).astype(np.int32)
    g = r.normal(size=rows).astype(np.float32)
    h = r.random(rows).astype(np.float32)
    shape = (1 << level, F, nb + 1)
    want = [np.zeros(shape), np.zeros(shape)]
    jtrain.hist_update(*want, bins, node_of, g, h)
    whole = [np.zeros(shape), np.zeros(shape)]
    ttrain.hist_update(*whole, bins, node_of, g, h)
    sliced = [np.zeros(shape), np.zeros(shape)]
    step = 64 if rows < 1000 else 5000
    for lo in range(0, rows, step):
        ttrain.hist_update(*sliced, bins[lo:lo + step],
                           node_of[lo:lo + step], g[lo:lo + step],
                           h[lo:lo + step])
    for a, b, c in zip(want, whole, sliced):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("model_type", FAMILIES)
def test_tree_gradients_equal_the_reference(model_type):
    """Per-tree g / h from the same keys: bit for bit for regression and
    RandomForest; classification within ulps (the sigmoid)."""
    r = np.random.default_rng(11)
    n = 4000
    margin = r.normal(size=n).astype(np.float32)
    for task in ("regression", "classification"):
        y = (r.random(n) < 0.5).astype(np.float32) if task != \
            "regression" else r.normal(size=n).astype(np.float32)
        jcfg = jtrain.TrainConfig(model_type=model_type, task=task)
        keys = jax.random.split(jax.random.PRNGKey(4), 4)
        for t in (0, 1):
            jg, jh = jtrain._tree_gradients(margin, jnp.asarray(y), jcfg, t,
                                            keys[0], keys[1])
            tg, th = ttrain._tree_gradients(margin, y, port_cfg(jcfg), t,
                                            _key_words(keys[0]),
                                            _key_words(keys[1]))
            assert tg.dtype == th.dtype == np.float32
            if task == "regression" or model_type == "randomforest":
                np.testing.assert_array_equal(tg, jg)
                np.testing.assert_array_equal(th, jh)
            else:
                np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)
                np.testing.assert_allclose(th, jh, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("F_", [1, 5, 9, 28])
def test_feature_mask_equals_the_reference(F_):
    jcfg = jtrain.TrainConfig(model_type="randomforest", colsample=0.5)
    for seed in range(4):
        k = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            ttrain._tree_feature_mask(_key_words(k), F_, port_cfg(jcfg)),
            jtrain._tree_feature_mask(k, F_, jcfg))


# -- train_forest against the reference ---------------------------------------


@pytest.mark.parametrize("seed,depth,trees", [(0, 3, 4), (3, 5, 3),
                                              (8, 1, 6)])
@pytest.mark.parametrize("model_type", FAMILIES)
def test_regression_forests_equal_the_reference(model_type, seed, depth,
                                                trees):
    x, y = _data(seed=seed, regression=True)
    jcfg = jtrain.TrainConfig(model_type=model_type, task="regression",
                              num_trees=trees, max_depth=depth, num_bins=16,
                              colsample=0.6, learning_rate=0.3, seed=seed)
    jf = jtrain.train_forest(x, y, jcfg)
    tf = ttrain.train_forest(x, y, port_cfg(jcfg), device="cpu")
    assert_forests_bitwise(jf, tf, f"{model_type}/{seed}")


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("model_type", FAMILIES)
def test_classification_forests_within_tolerance(model_type, seed):
    x, y = _data(seed=seed)
    jcfg = jtrain.TrainConfig(model_type=model_type, num_trees=5,
                              max_depth=4, num_bins=32, colsample=0.7,
                              learning_rate=0.3, seed=seed)
    jf = jtrain.train_forest(x, y, jcfg)
    tf = ttrain.train_forest(x, y, port_cfg(jcfg), device="cpu")
    if model_type == "randomforest":
        assert_forests_bitwise(jf, tf, "randomforest")
    assert_forests_close(jf, tf, x, f"{model_type}/{seed}")


def test_explicit_edges_equal_internal_binning():
    x, y = _data(seed=21)
    cfg = ttrain.TrainConfig(num_trees=4, max_depth=3)
    f1 = ttrain.train_forest(x, y, cfg, device="cpu")
    f2 = ttrain.train_forest(x, y, cfg, device="cpu",
                             edges=ttrain.quantile_bin_edges(x, 64))
    for k, a in f1.arrays().items():
        assert torch.equal(a, getattr(f2, k)), k


def test_unknown_model_type_refused_and_default_device_is_the_card():
    x, y = _data()
    with pytest.raises(ValueError, match="model_type"):
        ttrain.train_forest(x, y, ttrain.TrainConfig(model_type="catboost"),
                            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrain.train_forest(x, y, ttrain.TrainConfig(num_trees=1))


# -- the reference's tests/test_forest_train.py claims, on the port -----------


def _blobs(n=600, f=6, seed=0, nan_frac=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=f).astype(np.float32)
    y = (x @ w + 0.1 * rng.normal(size=n) > 0).astype(np.float32)
    if nan_frac:
        x[rng.random(x.shape) < nan_frac] = np.nan
    return x, y


def _label(forest, x):
    return (predict_proba(forest, torch.from_numpy(x)).numpy() > 0.5
            ).astype(np.float32)


@pytest.mark.parametrize("model_type", FAMILIES)
def test_classification_learns(model_type):
    x, y = _blobs(seed=1)
    cfg = ttrain.TrainConfig(model_type=model_type, num_trees=20,
                             max_depth=5, learning_rate=0.3, seed=0)
    forest = ttrain.train_forest(x, y, cfg, device="cpu")
    assert (_label(forest, x) == y).mean() > 0.85


@pytest.mark.parametrize("model_type", ["xgboost", "lightgbm"])
def test_regression_learns(model_type):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(500, 5)).astype(np.float32)
    y = (x[:, 0] * 2 - x[:, 1]).astype(np.float32)
    cfg = ttrain.TrainConfig(model_type=model_type, task="regression",
                             num_trees=30, max_depth=4, learning_rate=0.3)
    pred = predict_proba(ttrain.train_forest(x, y, cfg, device="cpu"),
                         torch.from_numpy(x)).numpy()
    assert np.mean((y - pred) ** 2) < 0.5 * np.mean((y - y.mean()) ** 2)


def test_missing_values_route_by_the_learned_default():
    rng = np.random.default_rng(13)
    n = 800
    x = rng.normal(size=(n, 4)).astype(np.float32)
    miss = rng.random(n) < 0.5
    x[miss, 0] = np.nan
    y = miss.astype(np.float32)
    cfg = ttrain.TrainConfig(model_type="xgboost", num_trees=10,
                             max_depth=2, learning_rate=0.5)
    forest = ttrain.train_forest(x, y, cfg, device="cpu")
    assert (_label(forest, x) == y).mean() > 0.97
    x_new = rng.normal(size=(64, 4)).astype(np.float32)
    x_new[:, 0] = np.nan
    assert _label(forest, x_new).mean() > 0.97


def test_goss_keeps_the_top_and_upweights_a_sample_of_the_rest():
    rng = np.random.default_rng(11)
    n, a, b = 4000, 0.2, 0.1
    margin = rng.normal(size=n).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    keys = prng.split(prng.prng_key(0), 4)
    g, _ = ttrain._tree_gradients(
        margin, y, ttrain.TrainConfig(model_type="lightgbm"), 1, keys[0],
        keys[1])
    g0, _ = ttrain._tree_gradients(
        margin, y, ttrain.TrainConfig(model_type="xgboost"), 1, keys[0],
        keys[1])
    w = g / g0
    order = np.argsort(-np.abs(g0))
    top, rest = order[: int(a * n)], order[int(a * n):]
    np.testing.assert_allclose(w[top], 1.0, atol=1e-5)
    kept = np.abs(w[rest]) > 1e-6
    assert abs(kept.mean() - b) < 0.02
    np.testing.assert_allclose(w[rest][kept], (1 - a) / b, rtol=1e-4)
    # tree 0 sees every row
    g_l, h_l = ttrain._tree_gradients(
        margin, y, ttrain.TrainConfig(model_type="lightgbm"), 0, keys[0],
        keys[1])
    np.testing.assert_array_equal(g_l, g0)


@pytest.mark.parametrize("kw", [dict(min_split_gain=1e9),
                                dict(min_child_weight=1e6)])
def test_node_budget_floors_make_every_node_terminal(kw):
    x, y = _blobs(seed=17)
    cfg = ttrain.TrainConfig(model_type="xgboost", num_trees=3, max_depth=3,
                             **kw)
    forest = ttrain.train_forest(x, y, cfg, device="cpu")
    assert forest.node_is_leaf.all()
    assert torch.isinf(forest.threshold).all()
    raw = predict_proba(forest, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(raw, np.full_like(raw, raw[0]))


def test_rf_colsample_and_bagging_vary_the_trees():
    x, y = _blobs(n=800, f=8, seed=19)
    cfg = ttrain.TrainConfig(model_type="randomforest", num_trees=6,
                             max_depth=4, colsample=0.5, seed=2)
    forest = ttrain.train_forest(x, y, cfg, device="cpu")
    feat, leaf = forest.feature.numpy(), forest.node_is_leaf.numpy()
    used = {frozenset(np.unique(feat[t][~leaf[t]]).tolist())
            for t in range(cfg.num_trees)}
    assert all(len(u) <= 4 for u in used) and len(used) > 1
    lv = forest.leaf_value.numpy()
    assert any(not np.array_equal(lv[0], lv[t]) for t in range(1, 6))


def test_reg_lambda_shrinks_leaves_with_the_split_fixed():
    rng = np.random.default_rng(15)
    x = rng.normal(size=(500, 1)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    mags, splits = [], set()
    for lam in (0.0, 1.0, 10.0, 100.0):
        f = ttrain.train_forest(x, y, ttrain.TrainConfig(
            model_type="xgboost", num_trees=1, max_depth=1, reg_lambda=lam,
            learning_rate=1.0), device="cpu")
        splits.add((f.feature.numpy().tobytes(),
                    f.threshold.numpy().tobytes()))
        mags.append(float(f.leaf_value.abs().max()))
    assert len(splits) == 1
    assert all(b <= a for a, b in zip(mags, mags[1:]))
    assert mags[-1] < 0.5 * mags[0]


def test_sigmoid_differs_from_xla_by_at_most_an_ulp():
    """The kept divergence of classification training (ROADMAP queue 3
    item 7): ``torch.sigmoid`` and the reference's XLA logistic differ on
    some float32 inputs, by one or two ulps, never more."""
    x = (np.random.default_rng(0).normal(size=200_000) * 4).astype(
        np.float32)
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(x))).view(np.int32)
    got = torch.sigmoid(torch.from_numpy(x)).numpy().view(np.int32)
    ulps = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert 0 < (ulps > 0).mean() < 0.01
    assert ulps.max() == 2
