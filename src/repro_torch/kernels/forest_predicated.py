"""Predicated forest traversal, fused (+ SUM) and raw ([B, T]): CUDA kernel
wrappers and their plain PyTorch versions.

Replaces ``repro/kernels/forest_predicated.py:predicated_fused_kernel_call``
and ``predicated_kernel_call`` (Pallas, TPU).  Both kernels are
``csrc/forest_predicated.cu``; its note says what bounds them and how they
are laid out.

The wrappers take the tree-padded node records and leaves
(``kernels/ops.py:kernel_trees``): ``predicated_fused`` returns the
per-sample sum [B] f32, ``predicated_raw`` each tree's score [B, T] f32.
``predicated_fused`` also takes bf16 tree tiles: narrow node records
[T, L] int32 and bf16 leaves (``common.pack_narrow_nodes``), upcast on
load, summed in f32.  For CPU tensors they run the plain versions; for
CUDA tensors they launch the kernel or raise.  Each wrapper's
``.launches`` counts its kernel launches, ``.wide_launches`` those in the
wide-row x mode, ``predicated_fused.bf16_launches`` those over narrow
records.  Past 400 features the fused kernel runs the wide-tiled layout
(``common.wide_tiled``: 32-row blocks whose warps take different trees,
over feature-major x); the raw one reads row-major x.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import (launch_forest_kernel, record_bytes,
                                        resolve_staged, sum_trees_in_order,
                                        unpack_nodes)

__all__ = ["predicated_fused", "predicated_fused_plain", "predicated_raw",
           "predicated_raw_plain"]


def predicated_raw_plain(x: torch.Tensor, nodes: torch.Tensor,
                         leaf_value: torch.Tensor, *,
                         depth: int) -> torch.Tensor:
    """The raw kernel's arithmetic in plain torch: `depth` branch-free
    descent steps per (sample, tree), then each tree's exit leaf [B, T].
    Takes either node record (bf16 trees upcast to f32)."""
    feature, threshold, default_left = unpack_nodes(nodes)
    leaf_value = leaf_value.float()
    B = x.shape[0]
    T, I = feature.shape
    t_ix = torch.arange(T, device=x.device)[None, :]
    idx = torch.zeros((B, T), dtype=torch.long, device=x.device)
    dl = default_left.bool()
    for _ in range(depth):
        xv = torch.gather(x, 1, feature[t_ix, idx].long())
        left = torch.where(torch.isnan(xv), dl[t_ix, idx],
                           xv < threshold[t_ix, idx])
        idx = 2 * idx + 2 - left.long()
    return leaf_value[t_ix, idx - I]


def predicated_fused_plain(x: torch.Tensor, nodes: torch.Tensor,
                           leaf_value: torch.Tensor, *,
                           depth: int) -> torch.Tensor:
    """The fused kernel's arithmetic: the raw scores added tree by tree."""
    return sum_trees_in_order(predicated_raw_plain(
        x, nodes, leaf_value, depth=depth))


def predicated_fused(x: torch.Tensor, nodes: torch.Tensor,
                     leaf_value: torch.Tensor, *, depth: int, block_b: int,
                     block_t: int,
                     staged: bool | None = None) -> torch.Tensor:
    """[B, F] samples, node records [T, L, 2] int32 and leaves [T, L] f32
    -- or narrow records [T, L] int32 and bf16 leaves -- (T a multiple of
    block_t) -> [B] f32 sums over trees.  ``staged``: the kernel's x mode
    (None: ``common.x_staged`` decides)."""
    trees = (nodes, leaf_value)
    if x.device.type == "cpu":
        return predicated_fused_plain(x, *trees, depth=depth)
    staged = resolve_staged("predicated", x, depth, True, staged,
                            record_bytes(nodes))
    out = launch_forest_kernel("predicated", x, trees, (), depth=depth,
                               block_b=block_b, block_t=block_t, fused=True,
                               staged=staged, counter=predicated_fused)
    return out


def predicated_raw(x: torch.Tensor, nodes: torch.Tensor,
                   leaf_value: torch.Tensor, *, depth: int, block_b: int,
                   block_t: int,
                   staged: bool | None = None) -> torch.Tensor:
    """As ``predicated_fused``, but -> [B, T] f32, each tree's score."""
    trees = (nodes, leaf_value)
    if x.device.type == "cpu":
        return predicated_raw_plain(x, *trees, depth=depth)
    staged = resolve_staged("predicated", x, depth, False, staged)
    out = launch_forest_kernel("predicated", x, trees, (), depth=depth,
                               block_b=block_b, block_t=block_t, fused=False,
                               staged=staged, counter=predicated_raw)
    return out


predicated_fused.launches = predicated_fused.wide_launches = 0
predicated_fused.bf16_launches = 0
predicated_raw.launches = predicated_raw.wide_launches = 0
