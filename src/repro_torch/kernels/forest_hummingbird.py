"""HummingBird (GEMM formulation) forest inference, fused (+ SUM) and raw
([B, T]): CUDA kernel wrappers and their plain PyTorch versions.

Replaces ``repro/kernels/forest_hummingbird.py:hummingbird_fused_kernel_call``
and ``hummingbird_kernel_call`` (Pallas, TPU).  Both kernels are
``csrc/forest_hummingbird.cu``: it contracts the predicate vector S with
the path matrix C over the node axis by popcounts over bit-packed S and
C's +1 / -1 masks (exact integers).

Structure tensors (``hb_masks``): ``cpos``/``cneg`` [L, ceil(I/32)] int32
holding uint32 bit patterns (bit i%32 of word i/32 is node i), and
``dcount`` [L] int32, the left-turn count of each leaf.
``hummingbird_fused.launches`` / ``hummingbird_raw.launches`` count kernel
launches.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.forest import hb_path_matrix
from repro_torch.kernels.common import (dense_predicates, launch_forest_kernel,
                                        sum_trees_in_order)

__all__ = ["hummingbird_fused", "hummingbird_fused_plain", "hummingbird_raw",
           "hummingbird_raw_plain", "hb_masks"]

#: rows per step of the plain version ([rows, T, L] f32 at T=512, L=256 is
#: 512 MiB for 1024 rows)
PLAIN_CHUNK_ROWS = 1024


def hb_masks(depth: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cpos, cneg, dcount) for a depth, from ``hb_path_matrix``."""
    C, D = hb_path_matrix(depth)
    I, L = C.shape
    IW = (I + 31) // 32
    cpos = np.zeros((L, IW), np.uint32)
    cneg = np.zeros((L, IW), np.uint32)
    for i in range(I):
        bit = np.uint32(1 << (i % 32))
        cpos[C[i] == 1, i // 32] |= bit
        cneg[C[i] == -1, i // 32] |= bit
    return cpos.view(np.int32), cneg.view(np.int32), D.astype(np.int32)


def _path_matrix(cpos: torch.Tensor, cneg: torch.Tensor,
                 depth: int) -> torch.Tensor:
    """Unpack the masks back into C [I, L] f32 in {-1, 0, +1}."""
    I = (1 << depth) - 1
    i = torch.arange(I, device=cpos.device)
    word, shift = i // 32, i % 32

    def bits(masks):
        m = masks.long() & 0xFFFFFFFF                       # [L, IW]
        return ((m[:, word] >> shift) & 1).T                # [I, L]

    return (bits(cpos) - bits(cneg)).float()


def hummingbird_raw_plain(x: torch.Tensor, feature: torch.Tensor,
                          threshold: torch.Tensor, default_left: torch.Tensor,
                          leaf_value: torch.Tensor, cpos: torch.Tensor,
                          cneg: torch.Tensor, dcount: torch.Tensor, *,
                          depth: int) -> torch.Tensor:
    """The raw kernel's function in plain torch: P = S @ C (S, C small
    integers, so exact in f32), exit leaf where P == D, leaf contraction ->
    [B, T].  Samples go ``PLAIN_CHUNK_ROWS`` at a time: the [rows, T, L]
    path tensor is the largest intermediate."""
    chunk = PLAIN_CHUNK_ROWS
    C = _path_matrix(cpos, cneg, depth)
    D = dcount.float()
    out = [torch.zeros((0, feature.shape[0]), dtype=torch.float32,
                       device=x.device)]
    for lo in range(0, x.shape[0], chunk):
        s = dense_predicates(x[lo:lo + chunk], feature, threshold,
                             default_left).float()          # [b, T, I]
        P = torch.matmul(s, C)                              # [b, T, L]
        out.append(((P == D).float() * leaf_value[None]).sum(-1))
    return torch.cat(out)


def hummingbird_fused_plain(x: torch.Tensor, feature: torch.Tensor,
                            threshold: torch.Tensor,
                            default_left: torch.Tensor,
                            leaf_value: torch.Tensor, cpos: torch.Tensor,
                            cneg: torch.Tensor, dcount: torch.Tensor, *,
                            depth: int) -> torch.Tensor:
    """The fused kernel's function: the raw scores added tree by tree."""
    return sum_trees_in_order(hummingbird_raw_plain(
        x, feature, threshold, default_left, leaf_value, cpos, cneg, dcount,
        depth=depth))


def _check_masks(cpos: torch.Tensor, cneg: torch.Tensor,
                 dcount: torch.Tensor, depth: int) -> None:
    I, L = (1 << depth) - 1, 1 << depth
    IW = (I + 31) // 32
    if (tuple(cpos.shape) != (L, IW) or tuple(cneg.shape) != (L, IW)
            or tuple(dcount.shape) != (L,)):
        raise ValueError("hummingbird: structure masks do not match depth "
                         f"{depth}")
    if {cpos.dtype, cneg.dtype, dcount.dtype} != {torch.int32}:
        raise TypeError("hummingbird: structure masks must be int32")


def hummingbird_fused(x: torch.Tensor, feature: torch.Tensor,
                      threshold: torch.Tensor, default_left: torch.Tensor,
                      leaf_value: torch.Tensor, cpos: torch.Tensor,
                      cneg: torch.Tensor, dcount: torch.Tensor, *,
                      depth: int, block_b: int,
                      block_t: int) -> torch.Tensor:
    """[B, F] samples, tree-padded arrays, structure masks -> [B] f32."""
    trees = (feature, threshold, default_left, leaf_value)
    if x.device.type == "cpu":
        return hummingbird_fused_plain(x, *trees, cpos, cneg, dcount,
                                       depth=depth)
    _check_masks(cpos, cneg, dcount, depth)
    out = launch_forest_kernel("hummingbird", x, trees, (cpos, cneg, dcount),
                               depth=depth, block_b=block_b, block_t=block_t,
                               fused=True)
    hummingbird_fused.launches += 1
    return out


def hummingbird_raw(x: torch.Tensor, feature: torch.Tensor,
                    threshold: torch.Tensor, default_left: torch.Tensor,
                    leaf_value: torch.Tensor, cpos: torch.Tensor,
                    cneg: torch.Tensor, dcount: torch.Tensor, *,
                    depth: int, block_b: int, block_t: int) -> torch.Tensor:
    """As ``hummingbird_fused``, but -> [B, T] f32, each tree's score."""
    trees = (feature, threshold, default_left, leaf_value)
    if x.device.type == "cpu":
        return hummingbird_raw_plain(x, *trees, cpos, cneg, dcount,
                                     depth=depth)
    _check_masks(cpos, cneg, dcount, depth)
    out = launch_forest_kernel("hummingbird", x, trees, (cpos, cneg, dcount),
                               depth=depth, block_b=block_b, block_t=block_t,
                               fused=False)
    hummingbird_raw.launches += 1
    return out


hummingbird_fused.launches = 0
hummingbird_raw.launches = 0
