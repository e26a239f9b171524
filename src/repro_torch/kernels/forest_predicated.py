"""Fused predicated forest traversal + SUM: CUDA kernel wrapper and its
plain PyTorch version.

Replaces ``repro/kernels/forest_predicated.py:predicated_fused_kernel_call``
(Pallas, TPU).  The kernel is ``csrc/forest_predicated.cu``; its note says
what bounds it and how it is laid out.

``predicated_fused`` takes tree-padded arrays (``kernels/ops.py`` pads) and
returns the per-sample sum [B] f32.  For CPU tensors it runs
``predicated_fused_plain``; for CUDA tensors it launches the kernel or
raises.  ``predicated_fused.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (check_kernel_inputs, stream_handle,
                                        sum_trees_in_order)

__all__ = ["predicated_fused", "predicated_fused_plain"]


def predicated_fused_plain(x: torch.Tensor, feature: torch.Tensor,
                           threshold: torch.Tensor,
                           default_left: torch.Tensor,
                           leaf_value: torch.Tensor, *,
                           depth: int) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: `depth` branch-free descent
    steps per (sample, tree), then the trees' leaves added in order."""
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
    return sum_trees_in_order(leaf_value[t_ix, idx - I])


def predicated_fused(x: torch.Tensor, feature: torch.Tensor,
                     threshold: torch.Tensor, default_left: torch.Tensor,
                     leaf_value: torch.Tensor, *, depth: int, block_b: int,
                     block_t: int) -> torch.Tensor:
    """[B, F] samples, [T, I]/[T, L] tree arrays (T a multiple of block_t,
    default_left uint8) -> [B] f32 sums over trees."""
    if x.device.type == "cpu":
        return predicated_fused_plain(x, feature, threshold, default_left,
                                      leaf_value, depth=depth)
    check_kernel_inputs("predicated", x, feature, threshold, default_left,
                        leaf_value, depth=depth, block_b=block_b,
                        block_t=block_t)
    lib = _build.load("forest_predicated")
    B, F = x.shape
    out = torch.empty(B, dtype=torch.float32, device=x.device)
    err = lib.forest_predicated_fused(
        x.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
        default_left.data_ptr(), leaf_value.data_ptr(), out.data_ptr(),
        B, F, feature.shape[0], depth, block_b, block_t,
        stream_handle(x.device))
    _build.check(lib, err, "forest_predicated_fused")
    predicated_fused.launches += 1
    return out


predicated_fused.launches = 0
