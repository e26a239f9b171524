"""Dense complete-tree tensor encoding of a decision forest (torch).

Mirrors ``repro/core/forest.py``: every tree is embedded in a perfect binary
tree of depth ``depth`` in heap order

    root = 0, children(i) = (2i+1, 2i+2)
    internal nodes: positions [0, 2^depth - 1)
    leaves:         positions [2^depth - 1, 2^(depth+1) - 1)

A premature leaf becomes a pass-through internal node (threshold +inf,
default_left True) whose value is copied to every dense leaf below it, so
traversal is fixed-length and the HummingBird path matrix and QuickScorer
bit-vectors are structure-only (one per depth, shared by every tree).

All per-tree tensors lead with the tree dimension T.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = [
    "Forest",
    "num_internal",
    "num_leaves",
    "make_forest",
    "forest_from_arrays",
    "complete_from_nodes",
    "hb_path_matrix",
    "qs_bitvectors",
    "pad_trees",
    "tree_slice",
    "used_feature_counts",
    "compact_forest",
]

ARRAY_FIELDS = ("feature", "threshold", "default_left", "leaf_value",
                "node_is_leaf", "node_value")


def num_internal(depth: int) -> int:
    return (1 << depth) - 1


def num_leaves(depth: int) -> int:
    return 1 << depth


@dataclasses.dataclass(frozen=True)
class Forest:
    """A forest of T depth-``depth`` complete binary trees.

    feature      int32  [T, I]  feature tested at each internal node
    threshold    f32    [T, I]  split threshold; x < t goes left
    default_left bool   [T, I]  where NaN inputs go
    leaf_value   f32    [T, L]  per-leaf raw score / class-1 probability
    node_is_leaf bool   [T, I]  True where the original tree had a leaf
    node_value   f32    [T, I]  value of that premature leaf (naive early exit)
    """

    feature: torch.Tensor
    threshold: torch.Tensor
    default_left: torch.Tensor
    leaf_value: torch.Tensor
    node_is_leaf: torch.Tensor
    node_value: torch.Tensor
    depth: int = 8
    n_features: int = 0
    model_type: str = "xgboost"
    task: str = "classification"
    base_score: float = 0.0

    @property
    def num_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def num_internal(self) -> int:
        return num_internal(self.depth)

    @property
    def num_leaves(self) -> int:
        return num_leaves(self.depth)

    @property
    def device(self) -> torch.device:
        return self.feature.device

    def astype(self, dtype: torch.dtype) -> "Forest":
        return dataclasses.replace(
            self,
            threshold=self.threshold.to(dtype),
            leaf_value=self.leaf_value.to(dtype),
            node_value=self.node_value.to(dtype),
        )

    def arrays(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in ARRAY_FIELDS}

    def to(self, device: str | torch.device | None = None) -> "Forest":
        """Move every tensor to ``device`` (the card when None)."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{k: v.to(dev) for k, v in self.arrays().items()})


def make_forest(
    feature: np.ndarray,
    threshold: np.ndarray,
    leaf_value: np.ndarray,
    *,
    default_left: np.ndarray | None = None,
    node_is_leaf: np.ndarray | None = None,
    node_value: np.ndarray | None = None,
    n_features: int,
    model_type: str = "xgboost",
    task: str = "classification",
    base_score: float = 0.0,
    device: str | torch.device | None = None,
) -> Forest:
    """Build a Forest from already-dense host arrays."""
    T, I = feature.shape
    depth = int(np.log2(I + 1))
    if (1 << depth) - 1 != I:
        raise ValueError(f"I={I} is not 2^d - 1")
    if leaf_value.shape != (T, 1 << depth):
        raise ValueError(f"leaf_value shape {leaf_value.shape} != "
                         f"({T}, {1 << depth})")
    if feature.size and (feature.min() < 0 or feature.max() >= n_features):
        # the kernels gather x[:, feature] from a [BB, F] tile unchecked
        raise ValueError(f"feature ids must lie in [0, {n_features})")
    if default_left is None:
        default_left = np.ones((T, I), dtype=bool)
    if node_is_leaf is None:
        node_is_leaf = np.zeros((T, I), dtype=bool)
    if node_value is None:
        node_value = np.zeros((T, I), dtype=np.float32)
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, copy=True)).to(dev, dtype)

    return Forest(
        feature=t(feature, torch.int32),
        threshold=t(np.asarray(threshold, np.float32), torch.float32),
        default_left=t(np.asarray(default_left, bool), torch.bool),
        leaf_value=t(np.asarray(leaf_value, np.float32), torch.float32),
        node_is_leaf=t(np.asarray(node_is_leaf, bool), torch.bool),
        node_value=t(np.asarray(node_value, np.float32), torch.float32),
        depth=depth,
        n_features=int(n_features),
        model_type=model_type,
        task=task,
        base_score=float(base_score),
    )


def forest_from_arrays(arrays: dict[str, np.ndarray], *, depth: int,
                       n_features: int, model_type: str = "xgboost",
                       task: str = "classification", base_score: float = 0.0,
                       device: str | torch.device | None = None) -> Forest:
    """Carry a forest's six arrays (as host numpy, keyed like
    ``Forest.arrays()``) into the port, bit for bit."""
    missing = set(ARRAY_FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"missing forest arrays {sorted(missing)}")
    forest = make_forest(
        np.asarray(arrays["feature"]), np.asarray(arrays["threshold"]),
        np.asarray(arrays["leaf_value"]),
        default_left=np.asarray(arrays["default_left"]),
        node_is_leaf=np.asarray(arrays["node_is_leaf"]),
        node_value=np.asarray(arrays["node_value"]),
        n_features=n_features, model_type=model_type, task=task,
        base_score=base_score, device=device)
    if forest.depth != depth:
        raise ValueError(f"arrays encode depth {forest.depth}, not {depth}")
    return forest


# ---------------------------------------------------------------------------
# Conversion from a generic node-list model
# ---------------------------------------------------------------------------


def complete_from_nodes(
    trees: list[dict[str, np.ndarray]],
    *,
    depth: int,
    n_features: int,
    model_type: str = "xgboost",
    task: str = "classification",
    base_score: float = 0.0,
    device: str | torch.device | None = None,
) -> Forest:
    """Convert sklearn-style node lists into the dense complete layout.

    Each tree dict has ``children_left``, ``children_right``, ``feature``,
    ``threshold``, ``value`` and optionally ``default_left``; a -1 child
    marks a leaf.  Trees deeper than ``depth`` are rejected.
    """
    T = len(trees)
    I, L = num_internal(depth), num_leaves(depth)
    feature = np.zeros((T, I), np.int32)
    threshold = np.full((T, I), np.inf, np.float32)
    default_left = np.ones((T, I), bool)
    node_is_leaf = np.zeros((T, I), bool)
    node_value = np.zeros((T, I), np.float32)
    leaf_value = np.zeros((T, L), np.float32)

    for t, tr in enumerate(trees):
        cl, cr = tr["children_left"], tr["children_right"]
        feat, thr, val = tr["feature"], tr["threshold"], tr["value"]
        dl = tr.get("default_left")
        stack = [(0, 0)]                 # (original node, dense position)
        while stack:
            node, pos = stack.pop()
            d = int(np.floor(np.log2(pos + 1)))
            if cl[node] < 0:             # leaf: fill every dense leaf below
                if pos < I:
                    node_is_leaf[t, pos] = True
                    node_value[t, pos] = val[node]
                lo = pos
                for _ in range(depth - d):
                    lo = 2 * lo + 1
                span = 1 << (depth - d)
                leaf_value[t, lo - I: lo - I + span] = val[node]
            else:
                if d >= depth:
                    raise ValueError(f"tree {t} deeper than dense depth "
                                     f"{depth}")
                feature[t, pos] = feat[node]
                threshold[t, pos] = thr[node]
                if dl is not None:
                    default_left[t, pos] = dl[node]
                stack.append((int(cl[node]), 2 * pos + 1))
                stack.append((int(cr[node]), 2 * pos + 2))

    return make_forest(feature, threshold, leaf_value,
                       default_left=default_left, node_is_leaf=node_is_leaf,
                       node_value=node_value, n_features=n_features,
                       model_type=model_type, task=task,
                       base_score=base_score, device=device)


# ---------------------------------------------------------------------------
# Structure-only auxiliary tensors (host numpy, shared by a depth's trees)
# ---------------------------------------------------------------------------


def _leaf_ancestry(depth: int) -> tuple[np.ndarray, np.ndarray]:
    """For each leaf: (ancestor internal positions [L, depth], went-left
    flags [L, depth])."""
    I, L = num_internal(depth), num_leaves(depth)
    anc = np.zeros((L, depth), np.int64)
    left = np.zeros((L, depth), bool)
    for leaf in range(L):
        pos = I + leaf
        for d in range(depth - 1, -1, -1):
            parent = (pos - 1) // 2
            anc[leaf, d] = parent
            left[leaf, d] = pos == 2 * parent + 1
            pos = parent
    return anc, left


def hb_path_matrix(depth: int) -> tuple[np.ndarray, np.ndarray]:
    """HummingBird tensors: (C [I, L] int8 in {-1, 0, 1}, D_count [L]
    int32).  With s the per-node predicate vector (1 = go left), the exit
    leaf is the unique l with (s @ C)[l] == D_count[l]."""
    I, L = num_internal(depth), num_leaves(depth)
    anc, left = _leaf_ancestry(depth)
    C = np.zeros((I, L), np.int8)
    for leaf in range(L):
        for d in range(depth):
            C[anc[leaf, d], leaf] = 1 if left[leaf, d] else -1
    return C, left.sum(axis=1).astype(np.int32)


def qs_bitvectors(depth: int) -> np.ndarray:
    """QuickScorer bit-vectors bv [I, W] uint32, W = ceil(L/32); leaf l is
    word l//32, bit l%32 (LSB first).  bv[i] is zero exactly on the leaves
    of i's left subtree, so AND-ing the vectors of the FALSE nodes leaves
    the exit leaf as the lowest surviving bit."""
    I, L = num_internal(depth), num_leaves(depth)
    W = (L + 31) // 32
    anc, left = _leaf_ancestry(depth)
    bv = np.full((I, W), 0xFFFFFFFF, np.uint32)
    for leaf in range(L):
        for d in range(depth):
            if left[leaf, d]:
                bv[anc[leaf, d], leaf // 32] &= ~np.uint32(1 << (leaf % 32))
    return bv


# ---------------------------------------------------------------------------
# Tree-dimension utilities
# ---------------------------------------------------------------------------

#: fill of each forest array for a padding (pass-through, zero-leaf) tree
PAD_FILLS = dict(feature=0, threshold=float("inf"), default_left=True,
                 leaf_value=0.0, node_is_leaf=True, node_value=0.0)


def _pad_rows(x: torch.Tensor, pad: int, fill) -> torch.Tensor:
    if pad == 0:
        return x
    tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail])


def pad_trees(forest: Forest, multiple: int) -> tuple[Forest, int]:
    """Pad the tree dimension to a multiple with pass-through zero-leaf
    trees.  SUM is unchanged; MEAN must divide by the returned true count."""
    T = forest.num_trees
    pad = (-T) % multiple
    if pad == 0:
        return forest, T
    return dataclasses.replace(
        forest, **{k: _pad_rows(v, pad, PAD_FILLS[k])
                   for k, v in forest.arrays().items()}), T


def tree_slice(forest: Forest, start: int, size: int) -> Forest:
    """A contiguous tree partition."""
    return dataclasses.replace(
        forest, **{k: v[start:start + size]
                   for k, v in forest.arrays().items()})


# ---------------------------------------------------------------------------
# Used-feature compaction (the sparse plane's model half), reference
# ``repro/core/forest.py:used_feature_counts`` / ``compact_forest``:
#
#     predict(forest, x)  ==  predict(compact, x[:, gather_idx])
#
# for every backend, because node n reads x_compact[inv[f_n]] =
# x[gather_idx[inv[f_n]]] = x[f_n].  Invariants: gather_idx is sorted and
# duplicate-free over its first F_used slots, and its padding slots repeat
# gather_idx[0] and are never read by a remapped split; pass-through nodes
# (threshold +inf) are not "used" and keep whatever slot their ignored
# feature maps to.


def used_feature_counts(forest: Forest) -> np.ndarray:
    """[T] int64: the DISTINCT features each tree really tests (pass-
    through nodes, threshold +inf, do not count)."""
    feat = forest.feature.long()
    real = torch.isfinite(forest.threshold)
    keyed = torch.where(real, feat, torch.full_like(feat, -1))
    ordered = torch.sort(keyed, dim=1).values
    new = torch.ones_like(ordered, dtype=torch.bool)
    new[:, 1:] = ordered[:, 1:] != ordered[:, :-1]
    return ((new & (ordered >= 0)).sum(dim=1)).cpu().numpy().astype(np.int64)


def compact_forest(forest: Forest, *, pad_to: int = 8
                   ) -> tuple[Forest, torch.Tensor]:
    """Remap split features into the forest's used-feature union.

    Returns (compact forest with n_features = F_used padded to a multiple
    of ``pad_to``, gather_idx [F_used padded] int32 on the forest's
    device).  Padding slots repeat gather_idx[0], so the table stays valid
    for a plain column gather; no remapped split points at them.
    Thresholds, leaves and tree order are kept, so predictions are the
    forest's bit for bit."""
    feat = forest.feature.long()
    used = torch.unique(feat[torch.isfinite(forest.threshold)])  # sorted
    if used.numel() == 0:
        used = torch.zeros(1, dtype=torch.int64, device=feat.device)
    f_used = used.numel()
    pad = (-f_used) % max(pad_to, 1)
    gather_idx = torch.cat([used, used[:1].expand(pad)]).to(torch.int32)
    inv = torch.zeros(forest.n_features, dtype=torch.int64,
                      device=feat.device)
    inv[used] = torch.arange(f_used, device=feat.device)
    # pass-through nodes keep whatever slot their (ignored) feature maps to
    remapped = inv[feat.clamp(0, forest.n_features - 1)]
    compact = dataclasses.replace(forest, feature=remapped.to(torch.int32),
                                  n_features=int(gather_idx.numel()))
    return compact, gather_idx
