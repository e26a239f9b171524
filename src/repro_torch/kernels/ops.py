"""Public wrappers for the forest kernels.

Mirrors ``repro/kernels/ops.py``.  Handles what the kernel wrappers
assume away:
  * the forest's trees as the kernels read them (``kernel_trees``): one
    8-byte node record per node (``common.pack_nodes``), the tree axis
    padded with pass-through zero-leaf trees (threshold +inf, default_left
    True, leaves 0) to the tree tile.  Built once per (forest, tree tile,
    tree dtype) and kept while the forest lives, so no launch packs or
    pads trees; a plan that already holds a forest's records hands them
    over (``share_packed_nodes``).  The sample axis is not padded: the
    kernels mask their ragged last block;
  * bf16 tree tiles (the fused entry points' ``tree_dtype=
    torch.bfloat16``, reference ``repro/kernels/ops.py:_prepared``):
    thresholds and leaves narrowed to bf16 after padding (the +inf / 0
    fills survive exactly), one 4-byte node record a node
    (``common.pack_narrow_nodes``) and bf16 leaves, upcast in the kernel,
    summed in f32.  So the result is the f32 fused kernel's over
    ``forest.astype(bf16).astype(f32)``.  A forest wider than
    ``common.NARROW_MAX_FEATURES`` keeps the 8-byte record of those same
    rounded values (``common.narrow_record``);
  * tile selection against the H100's shared memory
    (``common.block_heuristics``, per kernel kind and variant) and the x
    mode (``common.x_staged``: staged in shared memory, or wide rows read
    from global memory), so any width F runs;
  * the structure-only side tensors (HummingBird C^T and D, QuickScorer
    bit-vectors), built once per (depth, device) and cached.

Two backend families, under the reference's names so a query reads the
same in both packages:

  ``KERNEL_ALGORITHMS`` (``*_pallas``) return RAW per-tree scores [B, T]
  like ``core.algorithms``; phase-2 aggregation stays in
  ``core.postprocess``.

  ``FUSED_KERNEL_ALGORITHMS`` (``*_pallas_fused``) return the per-sample
  SUM [B] of raw tree scores; padding trees add exactly 0.0 to every
  sum.  MEAN divides by the TRUE tree count downstream.
"""

from __future__ import annotations

import functools
import weakref

import torch

from repro_torch.core.forest import PAD_FILLS, Forest, pad_trees
from repro_torch.kernels.common import (MAX_BLOCK_B, NARROW_RECORD_BYTES,
                                        WIDE_RECORD_BYTES, block_heuristics,
                                        narrow_record, pack_narrow_nodes,
                                        pack_nodes, resolve_staged)
from repro_torch.kernels.forest_hummingbird import (hb_structure,
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
    "kernel_trees",
    "packed_nodes",
    "share_packed_nodes",
    "tree_record_bytes",
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


#: id(forest) -> {0: node records, (block_t, tree_dtype): (padded records,
#: leaves)}; an entry goes when its forest is collected
_TREES: dict[int, dict] = {}


def _forest_entry(forest: Forest) -> dict:
    key = id(forest)
    entry = _TREES.get(key)
    if entry is None:
        entry = _TREES[key] = {}
        weakref.finalize(forest, _TREES.pop, key, None)
    return entry


def packed_nodes(forest: Forest) -> torch.Tensor:
    """The forest's node records [T, L, 2] int32 (``common.pack_nodes``),
    built at the first call and kept while the forest lives."""
    entry = _forest_entry(forest)
    if 0 not in entry:
        entry[0] = pack_nodes(forest.feature, forest.threshold,
                              forest.default_left)
    return entry[0]


def share_packed_nodes(forest: Forest, nodes: torch.Tensor) -> None:
    """Give ``forest`` node records built elsewhere (a tree partition's
    slice of its whole model's records), so none are built for it."""
    if tuple(nodes.shape) != (forest.num_trees, forest.num_leaves, 2):
        raise ValueError(f"node records {tuple(nodes.shape)} do not fit "
                         f"{forest.num_trees} trees of depth {forest.depth}")
    _forest_entry(forest)[0] = nodes


def _check_tree_dtype(tree_dtype) -> None:
    if tree_dtype not in (None, torch.bfloat16):
        raise ValueError(f"tree_dtype must be None or torch.bfloat16, got "
                         f"{tree_dtype}")


def tree_record_bytes(forest: Forest, tree_dtype=None) -> int:
    """Node-record bytes of the forest's kernel trees: 4 for bf16 tiles
    whose features fit the narrow record, else 8."""
    _check_tree_dtype(tree_dtype)
    if tree_dtype is not None and narrow_record(forest.n_features):
        return NARROW_RECORD_BYTES
    return WIDE_RECORD_BYTES


def _bf16_trees(forest: Forest, block_t: int):
    """bf16 tree tiles: the forest padded to ``block_t`` trees, thresholds
    and leaves rounded to bf16 (nearest even), as narrow records and bf16
    leaves, or, for a forest too wide for them, as 8-byte records and f32
    leaves of the same rounded values."""
    padded, _ = pad_trees(forest, block_t)
    leaves = padded.leaf_value.to(torch.bfloat16)
    if narrow_record(forest.n_features):
        return (pack_narrow_nodes(padded.feature, padded.threshold,
                                  padded.default_left), leaves.contiguous())
    threshold = padded.threshold.to(torch.bfloat16).float()
    return (pack_nodes(padded.feature, threshold, padded.default_left),
            leaves.float().contiguous())


def _f32_trees(forest: Forest, block_t: int):
    """f32 tree tiles: the forest's node records (shared with its tree
    partitions) and leaves, padded to ``block_t`` trees."""
    nodes = packed_nodes(forest)
    pad = (-forest.num_trees) % block_t
    leaves = forest.leaf_value
    if pad:
        dev = forest.device
        pad_nodes = pack_nodes(
            torch.full((pad, forest.num_internal), PAD_FILLS["feature"],
                       dtype=torch.int32, device=dev),
            torch.full((pad, forest.num_internal),
                       PAD_FILLS["threshold"], device=dev),
            torch.full((pad, forest.num_internal),
                       PAD_FILLS["default_left"], device=dev))
        nodes = torch.cat([nodes, pad_nodes])
        leaves = _pad_axis0(leaves, block_t, PAD_FILLS["leaf_value"])
    return nodes, leaves.contiguous()


def kernel_trees(forest: Forest, block_t: int, tree_dtype=None):
    """(node records, leaf values) with the tree axis padded to a multiple
    of ``block_t`` by pass-through zero-leaf trees, built once per
    (forest, block_t, tree_dtype), so f32 and bf16 tiles never alias."""
    _check_tree_dtype(tree_dtype)
    entry = _forest_entry(forest)
    key = (block_t, tree_dtype)
    if key not in entry:
        build = _f32_trees if tree_dtype is None else _bf16_trees
        entry[key] = build(forest, block_t)
    return entry[key]


@functools.lru_cache(maxsize=16)
def _structure(kind: str, depth: int,
               device: torch.device) -> tuple[torch.Tensor, ...]:
    """The structure-only tensors a kernel kind takes, on ``device``."""
    if kind == "hummingbird":
        return tuple(torch.as_tensor(a, device=device)
                     for a in hb_structure(depth))
    if kind == "quickscorer":
        return (torch.as_tensor(qs_words(depth), device=device),)
    return ()


def _blocks(kind: str, forest: Forest, B: int, F: int, block_b, block_t, *,
            fused: bool, staged: bool, record: int):
    if block_b is None or block_t is None:
        hb, ht = block_heuristics(kind, B, forest.num_trees, F, forest.depth,
                                  fused=fused, staged=staged, record=record)
        block_b = block_b or hb
        block_t = block_t or ht
    return block_b, block_t


def default_tree_block(forest: Forest, batch_rows: int = MAX_BLOCK_B, *,
                       fused: bool = True) -> int:
    """The tree tile of a one-tile launch of this forest's fused (or,
    ``fused=False``, raw) predicated kernel over a full sample tile: the
    natural tree-partition granularity of the relation-centric plans, one
    partition per launch of one tree tile (one tree buffer).  A raw
    kernel also holds its out tile in shared memory, so its tree tile can
    be the smaller.  Wide rows run the wide-row x mode, whose tile does
    not depend on F."""
    return block_heuristics("predicated", batch_rows, forest.num_trees,
                            forest.n_features, forest.depth, fused=fused,
                            one_tile=True)[1]


def prepare_inputs(kind: str, forest: Forest, x: torch.Tensor, *,
                   block_b=None, block_t=None, fused: bool = True,
                   staged: bool | None = None, tree_dtype=None):
    """(kernel positional inputs, tile keywords) for one fused (or, with
    ``fused=False``, raw) launch.  The keywords carry the x mode:
    ``staged``, or ``common.x_staged``'s choice for x's width.
    ``tree_dtype=torch.bfloat16``: bf16 tree tiles (fused only), whose
    narrow record lets the tiling take more trees a tile."""
    if tree_dtype is not None and not fused:
        raise ValueError("bf16 tree tiles feed the fused kernels only")
    if x.dim() != 2:
        raise ValueError(f"expected [B, F] samples, got {tuple(x.shape)}")
    if x.shape[1] < forest.n_features:
        raise ValueError(f"samples have {x.shape[1]} features, the forest "
                         f"tests up to {forest.n_features}")
    if x.device != forest.device:
        raise ValueError(f"samples on {x.device}, forest on "
                         f"{forest.device}")
    record = tree_record_bytes(forest, tree_dtype)
    staged = resolve_staged(kind, x, forest.depth, fused, staged, record)
    block_b, block_t = _blocks(kind, forest, x.shape[0], x.shape[1],
                               block_b, block_t, fused=fused, staged=staged,
                               record=record)
    args = (x.contiguous(), *kernel_trees(forest, block_t, tree_dtype),
            *_structure(kind, forest.depth, x.device))
    return args, dict(depth=forest.depth, block_b=block_b, block_t=block_t,
                      staged=staged)


def _run(kind: str, forest: Forest, x: torch.Tensor, *, block_b=None,
         block_t=None) -> torch.Tensor:
    """Raw per-tree scores [B, T]: launch, cut the pad trees off."""
    B, T = x.shape[0], forest.num_trees
    if B == 0:
        return torch.zeros((0, T), dtype=torch.float32, device=x.device)
    args, tiles = prepare_inputs(kind, forest, x, block_b=block_b,
                                 block_t=block_t, fused=False)
    return RAW_KERNEL_WRAPPERS[kind](*args, **tiles)[:, :T]


def _run_fused(kind: str, forest: Forest, x: torch.Tensor, *,
               block_b=None, block_t=None, tree_dtype=None,
               acc_dtype=torch.float32) -> torch.Tensor:
    """Fused predict + SUM: [B] raw-margin sums, no [B, T] matrix.
    ``tree_dtype=torch.bfloat16`` stages the tree tiles (thresholds and
    leaves) at half width; sums accumulate in ``acc_dtype``, which must be
    f32 (the reference's callers pass nothing else)."""
    if acc_dtype != torch.float32:
        raise ValueError(f"acc_dtype must be torch.float32, got {acc_dtype}")
    _check_tree_dtype(tree_dtype)
    B = x.shape[0]
    if B == 0:
        return torch.zeros(0, dtype=torch.float32, device=x.device)
    args, tiles = prepare_inputs(kind, forest, x, block_b=block_b,
                                 block_t=block_t, tree_dtype=tree_dtype)
    return KERNEL_WRAPPERS[kind](*args, **tiles)


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
