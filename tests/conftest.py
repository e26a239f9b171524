"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches must
see 1 device; only launch/dryrun.py forces 512 placeholder devices."""

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def random_forest_arrays(rng, *, T=7, depth=4, F=11, seed=None):
    """Random dense complete forest arrays (valid for every backend)."""
    r = np.random.default_rng(seed) if seed is not None else rng
    I, L = (1 << depth) - 1, 1 << depth
    feature = r.integers(0, F, (T, I)).astype(np.int32)
    threshold = r.normal(size=(T, I)).astype(np.float32)
    default_left = r.random((T, I)) < 0.5
    leaf_value = r.normal(size=(T, L)).astype(np.float32)
    return feature, threshold, default_left, leaf_value


@pytest.fixture
def random_forest(rng):
    from repro.core.forest import make_forest

    feature, threshold, default_left, leaf_value = \
        random_forest_arrays(rng, seed=42)
    return make_forest(feature, threshold, leaf_value,
                       default_left=default_left, n_features=11,
                       model_type="xgboost")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; the test skips without one")
