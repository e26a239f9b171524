"""Port parity: bf16 tree tiles in the three fused kernels.

The reference narrows thresholds and leaves to bf16 after padding
(``repro/kernels/ops.py:_prepared``), compares f32 x against the upcast
threshold and adds upcast leaves in f32.  The port packs the same rounded
values into one 4-byte node record a node (``common.pack_narrow_nodes``)
with bf16 leaves, and its plain versions -- what the wrappers run on the
CPU -- unpack and upcast them.  Held here: the record's round trip and
which record a width gets; each fused algorithm against the reference's
``tree_dtype=jnp.bfloat16`` in interpret mode (bit-identical on integer
leaves, within 1e-6 otherwise: the two add trees in different orders);
against the port's own f32 path over ``forest.astype(bf16).astype(f32)``
bit for bit; and what the entry points refuse.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.forest import make_forest as jmake_forest
from repro.kernels.ops import FUSED_KERNEL_ALGORITHMS as JFUSED
from repro_torch.kernels import common, ops
from repro_torch.kernels.common import (NARROW_MAX_FEATURES, narrow_record,
                                        pack_narrow_nodes, pack_nodes,
                                        unpack_narrow_nodes, unpack_nodes)
from repro_torch.kernels.ops import (FUSED_KERNEL_ALGORITHMS, KERNEL_WRAPPERS,
                                     kernel_trees, predict_sum_pallas,
                                     prepare_inputs)

from conftest import random_forest_arrays
from test_torch_forest import port_forest

BASES = ("predicated", "hummingbird", "quickscorer")
BF16 = torch.bfloat16


def _bits(t) -> np.ndarray:
    return np.asarray(t, np.float32).view(np.int32)


def _case(*, T=5, depth=4, F=11, seed=21, B=16, integer_leaves=False,
          nan_frac=0.0):
    fe, th, dl, lv = random_forest_arrays(None, T=T, depth=depth, F=F,
                                          seed=seed)
    if integer_leaves:
        lv = np.random.default_rng(seed).integers(-8, 9, lv.shape).astype(
            np.float32)
    jf = jmake_forest(fe, th, lv, default_left=dl, n_features=F)
    r = np.random.default_rng(4)
    x = r.normal(size=(B, F)).astype(np.float32)
    if nan_frac:
        x[r.random(x.shape) < nan_frac] = np.nan
    return jf, port_forest(jf), x


# ---------------------------------------------------------------------------
# the narrow record
# ---------------------------------------------------------------------------


def test_narrow_record_round_trip():
    r = np.random.default_rng(0)
    T, I = 9, 31
    feature = torch.from_numpy(
        r.integers(0, NARROW_MAX_FEATURES, (T, I)).astype(np.int32))
    feature[0, :2] = torch.tensor([0, NARROW_MAX_FEATURES - 1])
    threshold = torch.from_numpy(r.normal(size=(T, I)).astype(np.float32))
    threshold[1, :4] = torch.tensor([float("inf"), -float("inf"), -0.0,
                                     3.4028235e38])
    default_left = torch.from_numpy(r.random((T, I)) < 0.5)
    nodes = pack_narrow_nodes(feature, threshold, default_left)
    assert nodes.dtype == torch.int32 and tuple(nodes.shape) == (T, I + 1)
    assert bool((nodes[:, 0] == 0).all())
    f, th, dl = unpack_narrow_nodes(nodes)
    assert torch.equal(f, feature) and torch.equal(dl, default_left)
    want = threshold.to(BF16).float()
    assert np.array_equal(_bits(th), _bits(want))
    assert th[1, 2].item() == 0.0 and np.signbit(th[1, 2].item())
    assert th[1, 3].item() == float("inf")   # f32's max rounds past bf16's
    # unpack_nodes reads either record
    for got, ref in zip(unpack_nodes(nodes), (f, th, dl)):
        assert torch.equal(got, ref)
    assert unpack_nodes(pack_nodes(feature, want, default_left))[1].equal(
        want)


def test_bf16_rounding_matches_the_reference_cast():
    """torch's and XLA's f32 -> bf16 casts: nearest even, ties included."""
    r = np.random.default_rng(1)
    v = r.normal(size=4096).astype(np.float32)
    ties = (np.arange(1, 257, dtype=np.uint32) << 16 | 0x8000).view(
        np.float32)
    v = np.concatenate([v, ties, -ties, [np.inf, -np.inf, -0.0, 0.0]]
                       ).astype(np.float32)
    ours = torch.from_numpy(v).to(BF16).float().numpy()
    theirs = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(
        jnp.float32))
    assert np.array_equal(_bits(ours), _bits(theirs))


def test_narrow_record_refuses_features_it_cannot_name():
    with pytest.raises(ValueError, match="narrow node record"):
        pack_narrow_nodes(torch.tensor([[NARROW_MAX_FEATURES]]),
                          torch.zeros(1, 1), torch.ones(1, 1, dtype=bool))


@pytest.mark.parametrize("F,narrow", [(11, True), (10_000, True),
                                      (NARROW_MAX_FEATURES, True),
                                      (NARROW_MAX_FEATURES + 1, False),
                                      (40_000, False)])
def test_the_record_a_width_gets(F, narrow):
    """bf16 tiles take the 4-byte record while 15 bits name every feature,
    the 8-byte one (f32 leaves of the rounded values) past that."""
    assert narrow_record(F) is narrow
    jf, tf, x = _case(T=3, depth=3, F=F, B=4)
    args, tiles = prepare_inputs("predicated", tf, torch.from_numpy(x),
                                 tree_dtype=BF16)
    nodes, leaves = args[1], args[2]
    assert nodes.dim() == (2 if narrow else 3)
    assert leaves.dtype == (BF16 if narrow else torch.float32)
    assert common.record_bytes(nodes) == (4 if narrow else 8)
    assert ops.tree_record_bytes(tf, BF16) == (4 if narrow else 8)
    got = predict_sum_pallas(tf, torch.from_numpy(x),
                             "predicated_pallas_fused", tree_dtype=BF16)
    q = tf.astype(BF16).astype(torch.float32)
    want = predict_sum_pallas(q, torch.from_numpy(x),
                              "predicated_pallas_fused")
    assert np.array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("integer_leaves", [True, False],
                         ids=["integer", "float"])
@pytest.mark.parametrize("depth", [4, 8])
@pytest.mark.parametrize("base", BASES)
def test_fused_bf16_matches_the_reference(base, depth, integer_leaves):
    """tests/test_sparse.py::test_fused_bf16_tree_tiles's shapes (5 trees,
    11 features, block_b 8, block_t 2) at depth 4 and 8, NaN inputs."""
    jf, tf, x = _case(depth=depth, integer_leaves=integer_leaves,
                      nan_frac=0.1, seed=21 + depth)
    name = base + "_pallas_fused"
    want = np.asarray(JFUSED[name](jf, jnp.asarray(x), block_b=8, block_t=2,
                                   interpret=True, tree_dtype=jnp.bfloat16))
    got = FUSED_KERNEL_ALGORITHMS[name](tf, torch.from_numpy(x),
                                        tree_dtype=BF16)
    assert got.dtype == torch.float32 and tuple(got.shape) == (16,)
    if integer_leaves:
        assert np.array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("depth", [1, 3, 5, 8])
@pytest.mark.parametrize("base", BASES)
def test_bf16_is_f32_over_the_rounded_forest(base, depth):
    """Bit for bit the f32 fused path over forest.astype(bf16).astype(f32),
    with -0.0 leaves, NaN rows and a tree count off the tile."""
    jf, tf, x = _case(T=13, depth=depth, F=9, B=41, seed=depth,
                      nan_frac=0.2)
    lv = tf.leaf_value.clone()
    lv[:, ::3] = -0.0
    tf = dataclasses.replace(tf, leaf_value=lv)
    xt = torch.from_numpy(x)
    name = base + "_pallas_fused"
    got = predict_sum_pallas(tf, xt, name, tree_dtype=BF16)
    q = tf.astype(BF16).astype(torch.float32)
    want = predict_sum_pallas(q, xt, name)
    assert np.array_equal(_bits(got), _bits(want))
    # the wrapper's own plain version over the narrow tiles
    args, tiles = prepare_inputs(base, tf, xt, tree_dtype=BF16)
    assert np.array_equal(_bits(KERNEL_WRAPPERS[base](*args, **tiles)),
                          _bits(want))


# ---------------------------------------------------------------------------
# tiles, caches, refusals
# ---------------------------------------------------------------------------


def test_narrow_tiles_take_more_trees_from_the_same_budget():
    for kind in BASES:
        for F in (28, 2000):
            _, bt8 = common.block_heuristics(kind, 1 << 20, 500, F, 8)
            _, bt4 = common.block_heuristics(kind, 1 << 20, 500, F, 8,
                                             record=4)
            assert bt4 == 2 * bt8, (kind, F)
    assert common.tile_smem_bytes("predicated", 256, 8, 28, 8, record=4) \
        < common.tile_smem_bytes("predicated", 256, 8, 28, 8)


def test_kernel_trees_cache_keeps_f32_and_bf16_apart():
    _, tf, _ = _case(T=6, depth=3)
    f32 = kernel_trees(tf, 4)
    bf = kernel_trees(tf, 4, BF16)
    assert f32[0].dim() == 3 and f32[1].dtype == torch.float32
    assert bf[0].dim() == 2 and bf[1].dtype == BF16
    assert kernel_trees(tf, 4) is f32 and kernel_trees(tf, 4, BF16) is bf
    assert tuple(bf[0].shape) == (8, 8) and tuple(bf[1].shape) == (8, 8)
    # pad trees pass through: +inf thresholds, default left, 0 leaves
    f, th, dl = unpack_narrow_nodes(bf[0][6:])
    assert bool(torch.isinf(th).all()) and bool(dl.all())
    assert bool((bf[1][6:] == 0).all())


def test_fused_entry_points_refuse_other_dtypes():
    _, tf, x = _case()
    xt = torch.from_numpy(x)
    for name in FUSED_KERNEL_ALGORITHMS:
        with pytest.raises(ValueError, match="acc_dtype"):
            predict_sum_pallas(tf, xt, name, acc_dtype=torch.float64)
        with pytest.raises(ValueError, match="tree_dtype"):
            predict_sum_pallas(tf, xt, name, tree_dtype=torch.float16)
    with pytest.raises(ValueError, match="fused kernels only"):
        prepare_inputs("predicated", tf, xt, fused=False, tree_dtype=BF16)
    with pytest.raises(TypeError):
        ops.predicated_pallas(tf, xt, tree_dtype=BF16)
