"""Fused HummingBird (GEMM formulation) forest inference + SUM: CUDA kernel
wrapper and its plain PyTorch version.

Replaces ``repro/kernels/forest_hummingbird.py:hummingbird_fused_kernel_call``
(Pallas, TPU).  The kernel is ``csrc/forest_hummingbird.cu``: it contracts
the predicate vector S with the path matrix C over the node axis by
popcounts over bit-packed S and C's +1 / -1 masks (exact integers).

Structure tensors (``hb_masks``): ``cpos``/``cneg`` [L, ceil(I/32)] int32
holding uint32 bit patterns (bit i%32 of word i/32 is node i), and
``dcount`` [L] int32, the left-turn count of each leaf.
``hummingbird_fused.launches`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.forest import hb_path_matrix
from repro_torch.kernels import _build
from repro_torch.kernels.common import (check_kernel_inputs, dense_predicates,
                                        stream_handle, sum_trees_in_order)

__all__ = ["hummingbird_fused", "hummingbird_fused_plain", "hb_masks"]

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


def hummingbird_fused_plain(x: torch.Tensor, feature: torch.Tensor,
                            threshold: torch.Tensor,
                            default_left: torch.Tensor,
                            leaf_value: torch.Tensor, cpos: torch.Tensor,
                            cneg: torch.Tensor, dcount: torch.Tensor, *,
                            depth: int) -> torch.Tensor:
    """The kernel's function in plain torch: P = S @ C (S, C small integers,
    so exact in f32), exit leaf where P == D, leaf contraction, trees added
    in order.  Samples go ``PLAIN_CHUNK_ROWS`` at a time: the [rows, T, L]
    path tensor is the largest intermediate."""
    chunk = PLAIN_CHUNK_ROWS
    C = _path_matrix(cpos, cneg, depth)
    D = dcount.float()
    out = []
    for lo in range(0, x.shape[0], chunk):
        s = dense_predicates(x[lo:lo + chunk], feature, threshold,
                             default_left).float()          # [b, T, I]
        P = torch.matmul(s, C)                              # [b, T, L]
        scores = ((P == D).float() * leaf_value[None]).sum(-1)
        out.append(sum_trees_in_order(scores))
    if not out:
        return torch.zeros(0, dtype=torch.float32, device=x.device)
    return torch.cat(out)


def hummingbird_fused(x: torch.Tensor, feature: torch.Tensor,
                      threshold: torch.Tensor, default_left: torch.Tensor,
                      leaf_value: torch.Tensor, cpos: torch.Tensor,
                      cneg: torch.Tensor, dcount: torch.Tensor, *,
                      depth: int, block_b: int,
                      block_t: int) -> torch.Tensor:
    """[B, F] samples, tree-padded arrays, structure masks -> [B] f32."""
    if x.device.type == "cpu":
        return hummingbird_fused_plain(x, feature, threshold, default_left,
                                       leaf_value, cpos, cneg, dcount,
                                       depth=depth)
    check_kernel_inputs("hummingbird", x, feature, threshold, default_left,
                        leaf_value, depth=depth, block_b=block_b,
                        block_t=block_t, structure=(cpos, cneg, dcount))
    I, L = (1 << depth) - 1, 1 << depth
    IW = (I + 31) // 32
    if (tuple(cpos.shape) != (L, IW) or tuple(cneg.shape) != (L, IW)
            or tuple(dcount.shape) != (L,)):
        raise ValueError("hummingbird: structure masks do not match depth "
                         f"{depth}")
    if {cpos.dtype, cneg.dtype, dcount.dtype} != {torch.int32}:
        raise TypeError("hummingbird: structure masks must be int32")
    lib = _build.load("forest_hummingbird")
    B, F = x.shape
    out = torch.empty(B, dtype=torch.float32, device=x.device)
    err = lib.forest_hummingbird_fused(
        x.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
        default_left.data_ptr(), leaf_value.data_ptr(), cpos.data_ptr(),
        cneg.data_ptr(), dcount.data_ptr(), out.data_ptr(),
        B, F, feature.shape[0], depth, block_b, block_t,
        stream_handle(x.device))
    _build.check(lib, err, "forest_hummingbird_fused")
    hummingbird_fused.launches += 1
    return out


hummingbird_fused.launches = 0
