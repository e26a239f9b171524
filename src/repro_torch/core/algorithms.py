"""Decision-forest inference algorithms, eager torch (the port's oracles).

Mirrors ``repro/core/algorithms.py``.  Four backends over the same dense
complete-tree ``Forest``, each [B, F] -> per-tree raw scores [B, T]:

  naive       per (sample, tree) walk with early exit at premature leaves
  predicated  fixed-depth branch-free descent ``idx = 2*idx + 1 + !left``
              ("compiled" is the same descent; eager torch has no separate
              unrolled form)
  hummingbird predicate tensor S, shared path matrix C, exit leaf where
              S @ C == D, leaf one-hot contraction
  quickscorer AND of the FALSE nodes' bit-vectors, exit leaf = lowest
              surviving bit

Every per-tree score is a single leaf lookup, so all four agree with the
reference bit for bit.  Missing values: NaN features follow
``default_left``; +-inf features compare like any other number.
"""

from __future__ import annotations

import torch

from repro_torch.core.forest import Forest, hb_path_matrix, qs_bitvectors

__all__ = [
    "go_left",
    "naive_predict",
    "predicated_predict",
    "hummingbird_predict",
    "quickscorer_predict",
    "predict_raw",
    "ALGORITHMS",
]

ALL_ONES = 0xFFFFFFFF


def go_left(x_f: torch.Tensor, thr: torch.Tensor,
            default_left: torch.Tensor) -> torch.Tensor:
    """Branch direction including NaN handling.  True = left child."""
    return torch.where(torch.isnan(x_f), default_left, x_f < thr)


def _tree_index(forest: Forest) -> torch.Tensor:
    return torch.arange(forest.num_trees, device=forest.device)[None, :]


# ---------------------------------------------------------------------------
# 1. Naive traversal
# ---------------------------------------------------------------------------


def naive_predict(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """[B, F] -> [B, T]; each (sample, tree) walk stops at the first
    premature leaf (``node_is_leaf``) or at a dense leaf."""
    B = x.shape[0]
    I = forest.num_internal
    t_ix = _tree_index(forest)
    pos = torch.zeros((B, forest.num_trees), dtype=torch.long,
                      device=x.device)
    for _ in range(forest.depth):
        at = pos.clamp(max=I - 1)
        active = (pos < I) & ~forest.node_is_leaf[t_ix, at]
        xv = torch.gather(x, 1, forest.feature[t_ix, at].long())
        left = go_left(xv, forest.threshold[t_ix, at],
                       forest.default_left[t_ix, at])
        pos = torch.where(active, 2 * pos + 2 - left.long(), pos)
    return torch.where(pos < I,
                       forest.node_value[t_ix, pos.clamp(max=I - 1)],
                       forest.leaf_value[t_ix, (pos - I).clamp(min=0)])


# ---------------------------------------------------------------------------
# 2. Predicated traversal
# ---------------------------------------------------------------------------


def predicated_predict(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """[B, F] -> [B, T]; fixed-depth branch-free descent.  Pass-through
    completion makes premature leaves behave like the full tree."""
    B = x.shape[0]
    t_ix = _tree_index(forest)
    idx = torch.zeros((B, forest.num_trees), dtype=torch.long,
                      device=x.device)
    for _ in range(forest.depth):
        xv = torch.gather(x, 1, forest.feature[t_ix, idx].long())
        left = go_left(xv, forest.threshold[t_ix, idx],
                       forest.default_left[t_ix, idx])
        idx = 2 * idx + 2 - left.long()
    return forest.leaf_value[t_ix, idx - forest.num_internal]


# ---------------------------------------------------------------------------
# 3. HummingBird (GEMM) formulation
# ---------------------------------------------------------------------------


def hummingbird_predict(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """[B, F] -> [B, T]: S[b,t,i] = predicate (1 = left); P = S @ C; the
    exit leaf is where P == D; prediction = onehot(P == D) @ leaf_value."""
    C_np, D_np = hb_path_matrix(forest.depth)
    C = torch.as_tensor(C_np, dtype=torch.float32, device=x.device)
    D = torch.as_tensor(D_np, dtype=torch.float32, device=x.device)
    xv = x[:, forest.feature.long()]                        # [B, T, I]
    s = go_left(xv, forest.threshold[None], forest.default_left[None])
    P = torch.einsum("bti,il->btl", s.float(), C)           # [B, T, L]
    onehot = (P == D).to(forest.leaf_value.dtype)
    return torch.einsum("btl,tl->bt", onehot, forest.leaf_value)


# ---------------------------------------------------------------------------
# 4. QuickScorer, dense form
# ---------------------------------------------------------------------------


def lowest_set_bit(words: torch.Tensor) -> torch.Tensor:
    """[..., W] int64 holding uint32 words (at least one bit set overall)
    -> [...] index of the lowest set bit, words taken LSB first."""
    first_word = torch.argmax((words != 0).to(torch.uint8), dim=-1)
    word = torch.gather(words, -1, first_word[..., None])[..., 0]
    shifts = torch.arange(32, device=words.device)
    bits = (word[..., None] >> shifts) & 1                  # [..., 32]
    ctz = torch.argmax(bits.to(torch.uint8), dim=-1)        # first set bit
    return first_word * 32 + ctz


def and_reduce(masks: torch.Tensor, dim: int) -> torch.Tensor:
    """AND over ``dim`` of int64 masks, as a halving tree (all-ones pad)."""
    masks = masks.movedim(dim, -1)
    n = masks.shape[-1]
    size = 1
    while size < n:
        size *= 2
    if size != n:
        pad = torch.full(masks.shape[:-1] + (size - n,), ALL_ONES,
                         dtype=masks.dtype, device=masks.device)
        masks = torch.cat([masks, pad], dim=-1)
    while masks.shape[-1] > 1:
        h = masks.shape[-1] // 2
        masks = masks[..., :h] & masks[..., h:]
    return masks[..., 0]


def quickscorer_predict(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """[B, F] -> [B, T] via the AND of FALSE nodes' bit-vectors.

    The uint32 words are held in int64: torch's uint32 support is partial
    and an int32 ``>>`` is arithmetic.  Below depth 5 the bits past L are
    phantoms that never clear; the real exit leaf is lower, so the lowest
    set bit is still the right leaf."""
    bv = torch.as_tensor(qs_bitvectors(forest.depth).astype("int64"),
                         device=x.device)                   # [I, W]
    xv = x[:, forest.feature.long()]                        # [B, T, I]
    is_false = ~go_left(xv, forest.threshold[None], forest.default_left[None])
    masks = torch.where(is_false[..., None], bv,
                        torch.full_like(bv, ALL_ONES))      # [B, T, I, W]
    leaf = lowest_set_bit(and_reduce(masks, dim=2))         # [B, T]
    return forest.leaf_value[_tree_index(forest), leaf]


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

ALGORITHMS = {
    "naive": naive_predict,
    "predicated": predicated_predict,
    "compiled": predicated_predict,
    "hummingbird": hummingbird_predict,
    "quickscorer": quickscorer_predict,
}


def predict_raw(forest: Forest, x: torch.Tensor,
                algorithm: str = "predicated") -> torch.Tensor:
    """Per-tree raw scores [B, T] with the chosen backend."""
    try:
        fn = ALGORITHMS[algorithm]
    except KeyError:
        raise ValueError(f"unknown algorithm {algorithm!r}; "
                         f"options {sorted(ALGORITHMS)}") from None
    return fn(forest, x)
