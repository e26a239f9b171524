"""Predicated forest traversal, fused (+ SUM) and raw ([B, T]): CUDA kernel
wrappers and their plain PyTorch versions.

Replaces ``repro/kernels/forest_predicated.py:predicated_fused_kernel_call``
and ``predicated_kernel_call`` (Pallas, TPU).  Both kernels are
``csrc/forest_predicated.cu``; its note says what bounds them and how they
are laid out.

The wrappers take tree-padded arrays (``kernels/ops.py`` pads):
``predicated_fused`` returns the per-sample sum [B] f32, ``predicated_raw``
each tree's score [B, T] f32.  For CPU tensors they run the plain versions;
for CUDA tensors they launch the kernel or raise.  Each wrapper's
``.launches`` counts its kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import (launch_forest_kernel,
                                        sum_trees_in_order)

__all__ = ["predicated_fused", "predicated_fused_plain", "predicated_raw",
           "predicated_raw_plain"]


def predicated_raw_plain(x: torch.Tensor, feature: torch.Tensor,
                         threshold: torch.Tensor, default_left: torch.Tensor,
                         leaf_value: torch.Tensor, *,
                         depth: int) -> torch.Tensor:
    """The raw kernel's arithmetic in plain torch: `depth` branch-free
    descent steps per (sample, tree), then each tree's exit leaf [B, T]."""
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


def predicated_fused_plain(x: torch.Tensor, feature: torch.Tensor,
                           threshold: torch.Tensor,
                           default_left: torch.Tensor,
                           leaf_value: torch.Tensor, *,
                           depth: int) -> torch.Tensor:
    """The fused kernel's arithmetic: the raw scores added tree by tree."""
    return sum_trees_in_order(predicated_raw_plain(
        x, feature, threshold, default_left, leaf_value, depth=depth))


def predicated_fused(x: torch.Tensor, feature: torch.Tensor,
                     threshold: torch.Tensor, default_left: torch.Tensor,
                     leaf_value: torch.Tensor, *, depth: int, block_b: int,
                     block_t: int) -> torch.Tensor:
    """[B, F] samples, [T, I]/[T, L] tree arrays (T a multiple of block_t,
    default_left uint8) -> [B] f32 sums over trees."""
    trees = (feature, threshold, default_left, leaf_value)
    if x.device.type == "cpu":
        return predicated_fused_plain(x, *trees, depth=depth)
    out = launch_forest_kernel("predicated", x, trees, (), depth=depth,
                               block_b=block_b, block_t=block_t, fused=True)
    predicated_fused.launches += 1
    return out


def predicated_raw(x: torch.Tensor, feature: torch.Tensor,
                   threshold: torch.Tensor, default_left: torch.Tensor,
                   leaf_value: torch.Tensor, *, depth: int, block_b: int,
                   block_t: int) -> torch.Tensor:
    """As ``predicated_fused``, but -> [B, T] f32, each tree's score."""
    trees = (feature, threshold, default_left, leaf_value)
    if x.device.type == "cpu":
        return predicated_raw_plain(x, *trees, depth=depth)
    out = launch_forest_kernel("predicated", x, trees, (), depth=depth,
                               block_b=block_b, block_t=block_t, fused=False)
    predicated_raw.launches += 1
    return out


predicated_fused.launches = 0
predicated_raw.launches = 0
