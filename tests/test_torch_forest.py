"""Port parity: the dense forest encoding (``repro_torch.core.forest``).

The same arrays, made with numpy from a seed, go through the JAX reference
and the port; structure tensors, padding and slicing must agree exactly.
Also pins the port's device contract: with no card and no explicit
``device="cpu"``, entry points raise instead of falling back.
"""

import numpy as np
import pytest
import torch

from repro.core import forest as jforest
from repro_torch import default_device
from repro_torch.core import forest as tforest
from repro_torch.db.store import TensorBlockStore

from conftest import random_forest_arrays


def port_forest(jf, device="cpu"):
    """Carry a reference Forest into the port through numpy."""
    return tforest.forest_from_arrays(
        {k: np.asarray(v) for k, v in jf.arrays().items()},
        depth=jf.depth, n_features=jf.n_features, model_type=jf.model_type,
        task=jf.task, base_score=jf.base_score, device=device)


def ref_and_port(rng, *, T=7, depth=4, F=11, seed=0, **kw):
    fe, th, dl, lv = random_forest_arrays(rng, T=T, depth=depth, F=F,
                                          seed=seed)
    jf = jforest.make_forest(fe, th, lv, default_left=dl, n_features=F, **kw)
    return jf, port_forest(jf)


def assert_same_arrays(jf, tf):
    assert (tf.depth, tf.n_features, tf.model_type, tf.task,
            tf.base_score) == (jf.depth, jf.n_features, jf.model_type,
                               jf.task, jf.base_score)
    for name, arr in jf.arrays().items():
        want = np.asarray(arr)
        got = getattr(tf, name).numpy()
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name


@pytest.mark.parametrize("depth", range(1, 9))
def test_structure_tensors_equal_reference(depth):
    C_t, D_t = tforest.hb_path_matrix(depth)
    C_j, D_j = jforest.hb_path_matrix(depth)
    assert np.array_equal(C_t, C_j) and C_t.dtype == C_j.dtype
    assert np.array_equal(D_t, D_j) and D_t.dtype == D_j.dtype
    bv_t, bv_j = tforest.qs_bitvectors(depth), jforest.qs_bitvectors(depth)
    assert bv_t.dtype == np.uint32 and np.array_equal(bv_t, bv_j)


@pytest.mark.parametrize("depth", [1, 4, 8])
def test_forest_from_arrays_bit_exact(rng, depth):
    jf, tf = ref_and_port(rng, depth=depth, seed=depth,
                          model_type="lightgbm", base_score=0.25)
    assert_same_arrays(jf, tf)
    assert tf.num_trees == jf.num_trees
    assert (tf.num_internal, tf.num_leaves) == (jf.num_internal,
                                                jf.num_leaves)


@pytest.mark.parametrize("multiple", [1, 4, 8])
def test_pad_trees_equals_reference(rng, multiple):
    jf, tf = ref_and_port(rng, T=5, seed=3)
    jp, jT = jforest.pad_trees(jf, multiple)
    tp, tT = tforest.pad_trees(tf, multiple)
    assert tT == jT == 5
    assert_same_arrays(jp, tp)


def test_tree_slice_equals_reference(rng):
    jf, tf = ref_and_port(rng, T=6, seed=5)
    for start, size in ((0, 2), (2, 3), (4, 2)):
        assert_same_arrays(jforest.tree_slice(jf, start, size),
                           tforest.tree_slice(tf, start, size))


def test_complete_from_nodes_equals_reference():
    # root splits f0; left child is a premature leaf, right child splits f2
    tree = dict(children_left=np.array([1, -1, 3, -1, -1]),
                children_right=np.array([2, -1, 4, -1, -1]),
                feature=np.array([0, -2, 2, -2, -2]),
                threshold=np.array([0.5, 0, -1.0, 0, 0], np.float32),
                value=np.array([0, 1.5, 0, -2.0, 3.0], np.float32),
                default_left=np.array([False, True, True, True, True]))
    kw = dict(depth=3, n_features=4, model_type="randomforest",
              task="regression")
    jf = jforest.complete_from_nodes([tree, tree], **kw)
    tf = tforest.complete_from_nodes([tree, tree], device="cpu", **kw)
    assert_same_arrays(jf, tf)
    with pytest.raises(ValueError, match="deeper"):
        tforest.complete_from_nodes([tree], depth=1, n_features=4,
                                    device="cpu")


def test_make_forest_rejects_out_of_range_features(rng):
    fe, th, _, lv = random_forest_arrays(rng, T=2, depth=2, F=5, seed=1)
    with pytest.raises(ValueError, match="feature ids"):
        tforest.make_forest(fe, th, lv, n_features=int(fe.max()),
                            device="cpu")


def test_entry_points_need_a_card_unless_cpu_is_asked(rng):
    """Decided inside the test: with a card the default is the card;
    without one every entry point raises rather than run on the CPU."""
    fe, th, dl, lv = random_forest_arrays(rng, T=2, depth=2, F=5, seed=2)
    cpu = tforest.make_forest(fe, th, lv, default_left=dl, n_features=5,
                              device="cpu")
    assert cpu.device.type == "cpu"
    assert TensorBlockStore(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert default_device().type == "cuda"
        assert cpu.to().device.type == "cuda"
        return
    calls = [default_device, TensorBlockStore, cpu.to,
             lambda: tforest.make_forest(fe, th, lv, n_features=5),
             lambda: tforest.make_forest(fe, th, lv, n_features=5,
                                         device="cuda")]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
