"""HummingBird (GEMM formulation) forest inference, fused (+ SUM) and raw
([B, T]): CUDA kernel wrappers and their plain PyTorch versions.

Replaces ``repro/kernels/forest_hummingbird.py:hummingbird_fused_kernel_call``
and ``hummingbird_kernel_call`` (Pallas, TPU).  Both kernels are
``csrc/forest_hummingbird.cu``: it contracts the predicate vector S with
the path matrix C over the node axis on the tensor cores (int8 operands,
int32 sums: exact).

Structure tensors (``hb_structure``): ``ct`` [NP, KP] int8, the path
matrix C transposed and zero-padded (KP = max(32, L) nodes, NP = max(8, L)
leaves), and ``dcount`` [NP] int32, the left-turn count of each leaf (-1
on pad leaves, which never match).  ``hummingbird_fused`` also takes bf16
tree tiles (narrow records and bf16 leaves, ``common.pack_narrow_nodes``).
``hummingbird_fused.launches`` / ``hummingbird_raw.launches`` count kernel
launches (``.wide_launches`` those in the wide-row x mode,
``hummingbird_fused.bf16_launches`` those over narrow records).  Past 90
features both run the wide-tiled layout (``common.wide_tiled``): 32-row
blocks whose warps take different trees, over feature-major x.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.forest import hb_path_matrix
from repro_torch.kernels.common import (dense_predicates,
                                        launch_forest_kernel, record_bytes,
                                        resolve_staged, sum_trees_in_order,
                                        unpack_nodes)

__all__ = ["hummingbird_fused", "hummingbird_fused_plain", "hummingbird_raw",
           "hummingbird_raw_plain", "hb_structure"]

#: rows per step of the plain version ([rows, T, L] f32 at T=512, L=256 is
#: 512 MiB for 1024 rows)
PLAIN_CHUNK_ROWS = 1024


def _padded_dims(depth: int) -> tuple[int, int]:
    L = 1 << depth
    return max(32, L), max(8, L)


def hb_structure(depth: int) -> tuple[np.ndarray, np.ndarray]:
    """(ct [NP, KP] int8, dcount [NP] int32) for a depth, from
    ``hb_path_matrix``: ``ct[:L, :I]`` is C transposed, the rest 0, and
    ``dcount[:L]`` is D, the rest -1."""
    C, D = hb_path_matrix(depth)
    I, L = C.shape
    kp, np_ = _padded_dims(depth)
    ct = np.zeros((np_, kp), np.int8)
    ct[:L, :I] = C.T
    dcount = np.full(np_, -1, np.int32)
    dcount[:L] = D
    return ct, dcount


def hummingbird_raw_plain(x: torch.Tensor, nodes: torch.Tensor,
                          leaf_value: torch.Tensor, ct: torch.Tensor,
                          dcount: torch.Tensor, *,
                          depth: int) -> torch.Tensor:
    """The raw kernel's function in plain torch: P = S @ C (S, C small
    integers, so exact in f32), exit leaf where P == D, leaf contraction ->
    [B, T].  Samples go ``PLAIN_CHUNK_ROWS`` at a time: the [rows, T, L]
    path tensor is the largest intermediate.  Takes either node record
    (bf16 trees upcast to f32)."""
    chunk = PLAIN_CHUNK_ROWS
    feature, threshold, default_left = unpack_nodes(nodes)
    leaf_value = leaf_value.float()
    I, L = (1 << depth) - 1, 1 << depth
    C = ct[:L, :I].T.float()
    D = dcount[:L].float()
    out = [torch.zeros((0, feature.shape[0]), dtype=torch.float32,
                       device=x.device)]
    for lo in range(0, x.shape[0], chunk):
        s = dense_predicates(x[lo:lo + chunk], feature, threshold,
                             default_left).float()          # [b, T, I]
        P = torch.matmul(s, C)                              # [b, T, L]
        out.append(((P == D).float() * leaf_value[None]).sum(-1))
    return torch.cat(out)


def hummingbird_fused_plain(x: torch.Tensor, nodes: torch.Tensor,
                            leaf_value: torch.Tensor, ct: torch.Tensor,
                            dcount: torch.Tensor, *,
                            depth: int) -> torch.Tensor:
    """The fused kernel's function: the raw scores added tree by tree."""
    return sum_trees_in_order(hummingbird_raw_plain(
        x, nodes, leaf_value, ct, dcount, depth=depth))


def _check_structure(ct: torch.Tensor, dcount: torch.Tensor,
                     depth: int) -> None:
    kp, np_ = _padded_dims(depth)
    if tuple(ct.shape) != (np_, kp) or tuple(dcount.shape) != (np_,):
        raise ValueError("hummingbird: structure tensors do not match depth "
                         f"{depth}")
    if ct.dtype != torch.int8 or dcount.dtype != torch.int32:
        raise TypeError("hummingbird: structure tensors must be int8 C^T "
                        "and int32 D")


def hummingbird_fused(x: torch.Tensor, nodes: torch.Tensor,
                      leaf_value: torch.Tensor, ct: torch.Tensor,
                      dcount: torch.Tensor, *, depth: int, block_b: int,
                      block_t: int,
                      staged: bool | None = None) -> torch.Tensor:
    """[B, F] samples, tree-padded node records and leaves (f32, or narrow
    records and bf16 leaves), structure tensors -> [B] f32."""
    trees = (nodes, leaf_value)
    if x.device.type == "cpu":
        return hummingbird_fused_plain(x, *trees, ct, dcount, depth=depth)
    _check_structure(ct, dcount, depth)
    staged = resolve_staged("hummingbird", x, depth, True, staged,
                            record_bytes(nodes))
    out = launch_forest_kernel("hummingbird", x, trees, (ct, dcount),
                               depth=depth, block_b=block_b, block_t=block_t,
                               fused=True, staged=staged,
                               counter=hummingbird_fused)
    return out


def hummingbird_raw(x: torch.Tensor, nodes: torch.Tensor,
                    leaf_value: torch.Tensor, ct: torch.Tensor,
                    dcount: torch.Tensor, *, depth: int, block_b: int,
                    block_t: int,
                    staged: bool | None = None) -> torch.Tensor:
    """As ``hummingbird_fused``, but -> [B, T] f32, each tree's score."""
    trees = (nodes, leaf_value)
    if x.device.type == "cpu":
        return hummingbird_raw_plain(x, *trees, ct, dcount, depth=depth)
    _check_structure(ct, dcount, depth)
    staged = resolve_staged("hummingbird", x, depth, False, staged)
    out = launch_forest_kernel("hummingbird", x, trees, (ct, dcount),
                               depth=depth, block_b=block_b, block_t=block_t,
                               fused=False, staged=staged,
                               counter=hummingbird_raw)
    return out


hummingbird_fused.launches = hummingbird_fused.wide_launches = 0
hummingbird_fused.bf16_launches = 0
hummingbird_raw.launches = hummingbird_raw.wide_launches = 0
