"""QuickScorer (bit-vector) forest inference, fused (+ SUM) and raw
([B, T]): CUDA kernel wrappers and their plain PyTorch versions.

Replaces ``repro/kernels/forest_quickscorer.py:quickscorer_fused_kernel_call``
and ``quickscorer_kernel_call`` (Pallas, TPU).  Both kernels are
``csrc/forest_quickscorer.cu``: uint32 words ANDed over the FALSE nodes,
exit leaf = lowest set bit by ``__ffs`` per word in word order.

Structure tensor: ``bv`` [I, ceil(L/32)] int32 holding the uint32 bit
patterns of ``core.forest.qs_bitvectors``.  The plain version does its bit
operations in int64, since torch's uint32 support is partial and an int32
``>>`` is arithmetic.  ``quickscorer_fused.launches`` /
``quickscorer_raw.launches`` count kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.algorithms import ALL_ONES, lowest_set_bit
from repro_torch.core.forest import qs_bitvectors
from repro_torch.kernels.common import (dense_predicates, launch_forest_kernel,
                                        sum_trees_in_order)

__all__ = ["quickscorer_fused", "quickscorer_fused_plain", "quickscorer_raw",
           "quickscorer_raw_plain", "qs_words"]

#: rows per step of the plain version (its [rows, T, I] predicate gather
#: is 1 GiB f32 for 2048 rows at T=512, I=255)
PLAIN_CHUNK_ROWS = 2048


def qs_words(depth: int) -> np.ndarray:
    """The bit-vectors of a depth as int32 bit patterns [I, W]."""
    return qs_bitvectors(depth).view(np.int32)


def quickscorer_raw_plain(x: torch.Tensor, feature: torch.Tensor,
                          threshold: torch.Tensor, default_left: torch.Tensor,
                          leaf_value: torch.Tensor, bv: torch.Tensor, *,
                          depth: int) -> torch.Tensor:
    """The raw kernel's function in plain torch: per (sample, tree) AND the
    FALSE nodes' words node by node, take the lowest set bit, look up the
    leaf -> [B, T].  Samples go ``PLAIN_CHUNK_ROWS`` rows at a time."""
    chunk = PLAIN_CHUNK_ROWS
    words = bv.long() & 0xFFFFFFFF                          # [I, W]
    T, I = feature.shape
    t_ix = torch.arange(T, device=x.device)[None, :]
    out = [torch.zeros((0, T), dtype=torch.float32, device=x.device)]
    for lo in range(0, x.shape[0], chunk):
        false = ~dense_predicates(x[lo:lo + chunk], feature, threshold,
                                  default_left)             # [b, T, I]
        surv = torch.full(false.shape[:2] + (words.shape[1],), ALL_ONES,
                          dtype=torch.long, device=x.device)
        for i in range(I):
            surv &= torch.where(false[:, :, i, None], words[i],
                                torch.full_like(words[i], ALL_ONES))
        leaf = lowest_set_bit(surv)                         # [b, T]
        out.append(leaf_value[t_ix, leaf])
    return torch.cat(out)


def quickscorer_fused_plain(x: torch.Tensor, feature: torch.Tensor,
                            threshold: torch.Tensor,
                            default_left: torch.Tensor,
                            leaf_value: torch.Tensor, bv: torch.Tensor, *,
                            depth: int) -> torch.Tensor:
    """The fused kernel's function: the raw scores added tree by tree."""
    return sum_trees_in_order(quickscorer_raw_plain(
        x, feature, threshold, default_left, leaf_value, bv, depth=depth))


def _check_words(bv: torch.Tensor, depth: int) -> None:
    I, L = (1 << depth) - 1, 1 << depth
    if tuple(bv.shape) != (I, (L + 31) // 32) or bv.dtype != torch.int32:
        raise ValueError(f"quickscorer: bit-vectors do not match depth "
                         f"{depth} as int32 [{I}, {(L + 31) // 32}]")


def quickscorer_fused(x: torch.Tensor, feature: torch.Tensor,
                      threshold: torch.Tensor, default_left: torch.Tensor,
                      leaf_value: torch.Tensor, bv: torch.Tensor, *,
                      depth: int, block_b: int,
                      block_t: int) -> torch.Tensor:
    """[B, F] samples, tree-padded arrays, bit-vectors -> [B] f32."""
    trees = (feature, threshold, default_left, leaf_value)
    if x.device.type == "cpu":
        return quickscorer_fused_plain(x, *trees, bv, depth=depth)
    _check_words(bv, depth)
    out = launch_forest_kernel("quickscorer", x, trees, (bv,), depth=depth,
                               block_b=block_b, block_t=block_t, fused=True)
    quickscorer_fused.launches += 1
    return out


def quickscorer_raw(x: torch.Tensor, feature: torch.Tensor,
                    threshold: torch.Tensor, default_left: torch.Tensor,
                    leaf_value: torch.Tensor, bv: torch.Tensor, *,
                    depth: int, block_b: int, block_t: int) -> torch.Tensor:
    """As ``quickscorer_fused``, but -> [B, T] f32, each tree's score."""
    trees = (feature, threshold, default_left, leaf_value)
    if x.device.type == "cpu":
        return quickscorer_raw_plain(x, *trees, bv, depth=depth)
    _check_words(bv, depth)
    out = launch_forest_kernel("quickscorer", x, trees, (bv,), depth=depth,
                               block_b=block_b, block_t=block_t, fused=False)
    quickscorer_raw.launches += 1
    return out


quickscorer_fused.launches = 0
quickscorer_raw.launches = 0
