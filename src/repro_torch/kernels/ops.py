"""Public wrappers for the forest kernels.

Mirrors ``repro/kernels/ops.py``.  Handles what the kernel wrappers
assume away:
  * padding the sample axis (zero rows) to the sample tile, and the tree
    axis with pass-through zero-leaf trees (threshold +inf, default_left
    True, leaves 0) to the tree tile, and cutting the output back;
  * tile selection against the H100's shared memory
    (``common.block_heuristics``, per kernel kind and variant);
  * the structure-only side tensors (HummingBird masks, QuickScorer
    bit-vectors), built once per (depth, device) and cached.

Two backend families, under the reference's names so a query reads the
same in both packages:

  ``KERNEL_ALGORITHMS`` (``*_pallas``) return RAW per-tree scores [B, T]
  like ``core.algorithms``; phase-2 aggregation stays in
  ``core.postprocess``.

  ``FUSED_KERNEL_ALGORITHMS`` (``*_pallas_fused``) return the per-sample
  SUM [B] of raw tree scores; only the sample axis is cut back, since
  padding trees add exactly 0.0 to every sum.  MEAN divides by the TRUE
  tree count downstream.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.forest import PAD_FILLS, Forest
from repro_torch.kernels.common import block_heuristics
from repro_torch.kernels.forest_hummingbird import (hb_masks,
                                                    hummingbird_fused,
                                                    hummingbird_raw)
from repro_torch.kernels.forest_predicated import (predicated_fused,
                                                   predicated_raw)
from repro_torch.kernels.forest_quickscorer import (qs_words,
                                                    quickscorer_fused,
                                                    quickscorer_raw)

__all__ = [
    "predicated_pallas",
    "hummingbird_pallas",
    "quickscorer_pallas",
    "predicated_pallas_fused",
    "hummingbird_pallas_fused",
    "quickscorer_pallas_fused",
    "KERNEL_ALGORITHMS",
    "FUSED_KERNEL_ALGORITHMS",
    "KERNEL_WRAPPERS",
    "RAW_KERNEL_WRAPPERS",
    "predict_raw_pallas",
    "predict_sum_pallas",
    "default_tree_block",
    "prepare_inputs",
]

#: the fused CUDA kernel wrapper behind each kernel kind
KERNEL_WRAPPERS = {
    "predicated": predicated_fused,
    "hummingbird": hummingbird_fused,
    "quickscorer": quickscorer_fused,
}

#: the raw [B, T] CUDA kernel wrapper behind each kernel kind
RAW_KERNEL_WRAPPERS = {
    "predicated": predicated_raw,
    "hummingbird": hummingbird_raw,
    "quickscorer": quickscorer_raw,
}


def _pad_axis0(x: torch.Tensor, multiple: int, fill) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail])


def pad_forest_arrays(forest: Forest, block_t: int):
    """Tree-axis padding with pass-through zero-leaf trees; default_left
    goes to the kernels as uint8."""
    return (
        _pad_axis0(forest.feature, block_t, PAD_FILLS["feature"]),
        _pad_axis0(forest.threshold, block_t, PAD_FILLS["threshold"]),
        _pad_axis0(forest.default_left, block_t,
                   PAD_FILLS["default_left"]).to(torch.uint8),
        _pad_axis0(forest.leaf_value, block_t, PAD_FILLS["leaf_value"]),
    )


@functools.lru_cache(maxsize=16)
def _structure(kind: str, depth: int,
               device: torch.device) -> tuple[torch.Tensor, ...]:
    """The structure-only tensors a kernel kind takes, on ``device``."""
    if kind == "hummingbird":
        return tuple(torch.as_tensor(a, device=device)
                     for a in hb_masks(depth))
    if kind == "quickscorer":
        return (torch.as_tensor(qs_words(depth), device=device),)
    return ()


def _blocks(kind: str, forest: Forest, B: int, F: int, block_b, block_t, *,
            fused: bool):
    if block_b is None or block_t is None:
        hb, ht = block_heuristics(kind, B, forest.num_trees, F, forest.depth,
                                  fused=fused)
        block_b = block_b or hb
        block_t = block_t or ht
    return block_b, block_t


def default_tree_block(forest: Forest, batch_rows: int = 128, *,
                       fused: bool = True) -> int:
    """The tree tile ``block_heuristics`` picks for this forest's fused
    (or, ``fused=False``, raw) predicated kernel: the natural
    tree-partition granularity of the relation-centric plans, one
    partition per tree tile.  A raw kernel also holds its out tile in
    shared memory, so its tree tile can be the smaller."""
    return _blocks("predicated", forest, batch_rows, forest.n_features,
                   None, None, fused=fused)[1]


def prepare_inputs(kind: str, forest: Forest, x: torch.Tensor, *,
                   block_b=None, block_t=None, fused: bool = True):
    """(kernel positional inputs, tile keywords) for one fused (or, with
    ``fused=False``, raw) launch."""
    if x.dim() != 2:
        raise ValueError(f"expected [B, F] samples, got {tuple(x.shape)}")
    if x.shape[1] < forest.n_features:
        raise ValueError(f"samples have {x.shape[1]} features, the forest "
                         f"tests up to {forest.n_features}")
    if x.device != forest.device:
        raise ValueError(f"samples on {x.device}, forest on "
                         f"{forest.device}")
    block_b, block_t = _blocks(kind, forest, x.shape[0], x.shape[1],
                               block_b, block_t, fused=fused)
    xp = _pad_axis0(x, block_b, 0.0)
    args = (xp, *pad_forest_arrays(forest, block_t),
            *_structure(kind, forest.depth, x.device))
    return args, dict(depth=forest.depth, block_b=block_b, block_t=block_t)


def _run(kind: str, forest: Forest, x: torch.Tensor, *, block_b=None,
         block_t=None) -> torch.Tensor:
    """Raw per-tree scores [B, T]: pad, launch, cut back to [:B, :T]."""
    B, T = x.shape[0], forest.num_trees
    if B == 0:
        return torch.zeros((0, T), dtype=torch.float32, device=x.device)
    args, tiles = prepare_inputs(kind, forest, x, block_b=block_b,
                                 block_t=block_t, fused=False)
    return RAW_KERNEL_WRAPPERS[kind](*args, **tiles)[:B, :T]


def _run_fused(kind: str, forest: Forest, x: torch.Tensor, *,
               block_b=None, block_t=None) -> torch.Tensor:
    """Fused predict + SUM: [B] raw-margin sums, no [B, T] matrix."""
    B = x.shape[0]
    if B == 0:
        return torch.zeros(0, dtype=torch.float32, device=x.device)
    args, tiles = prepare_inputs(kind, forest, x, block_b=block_b,
                                 block_t=block_t)
    return KERNEL_WRAPPERS[kind](*args, **tiles)[:B]


predicated_pallas = functools.partial(_run, "predicated")
hummingbird_pallas = functools.partial(_run, "hummingbird")
quickscorer_pallas = functools.partial(_run, "quickscorer")

predicated_pallas_fused = functools.partial(_run_fused, "predicated")
hummingbird_pallas_fused = functools.partial(_run_fused, "hummingbird")
quickscorer_pallas_fused = functools.partial(_run_fused, "quickscorer")

KERNEL_ALGORITHMS = {
    "predicated_pallas": predicated_pallas,
    "hummingbird_pallas": hummingbird_pallas,
    "quickscorer_pallas": quickscorer_pallas,
}

FUSED_KERNEL_ALGORITHMS = {
    "predicated_pallas_fused": predicated_pallas_fused,
    "hummingbird_pallas_fused": hummingbird_pallas_fused,
    "quickscorer_pallas_fused": quickscorer_pallas_fused,
}


def predict_raw_pallas(forest: Forest, x: torch.Tensor,
                       algorithm: str = "hummingbird_pallas",
                       **kw) -> torch.Tensor:
    """[B, T] raw per-tree scores via a raw kernel."""
    try:
        fn = KERNEL_ALGORITHMS[algorithm]
    except KeyError:
        raise ValueError(
            f"unknown kernel algorithm {algorithm!r}; "
            f"options {sorted(KERNEL_ALGORITHMS)}") from None
    return fn(forest, x, **kw)


def predict_sum_pallas(forest: Forest, x: torch.Tensor,
                       algorithm: str = "hummingbird_pallas_fused",
                       **kw) -> torch.Tensor:
    """[B] summed raw margins via a fused kernel."""
    try:
        fn = FUSED_KERNEL_ALGORITHMS[algorithm]
    except KeyError:
        raise ValueError(
            f"unknown fused kernel algorithm {algorithm!r}; "
            f"options {sorted(FUSED_KERNEL_ALGORITHMS)}") from None
    return fn(forest, x, **kw)
