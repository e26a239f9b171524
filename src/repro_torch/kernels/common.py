"""Shared pieces of the forest kernels' plain versions and their tiling.

``dense_predicates`` is the direct gather the CUDA kernels do:
``s[b, t, i] = isnan(x_f) ? default_left : x_f < threshold`` with
``x_f = x[b, feature[t, i]]`` (``core.algorithms.go_left``).  The JAX
reference instead contracts a one-hot over features on the TPU's matrix
unit (``repro/kernels/common.py:dense_predicates``); the booleans are the
same on finite and NaN inputs, but a +-inf feature turns into ``0 * inf =
NaN`` there and goes right on every node of that row.  The port follows
``_go_left`` (see ROADMAP section 3).

``block_heuristics`` sizes the kernels' tiles for an H100 block: one
thread per sample (BB threads), and a shared-memory working set of

    x tile    4 * F * BB
    tree tile BT * (9 * I + 4 * L)        feature, threshold, default_left,
                                          leaves
    extra     HummingBird: 8 * L * ceil(I/32) + 4 * L   (C masks, D)
              QuickScorer: 4 * I * ceil(L/32)           (bit-vectors)

each part rounded up to 16 bytes (``csrc/forest_common.cuh:tile_layout``).
The budget is half the 227 KB a block may take, so two blocks (16 warps at
BB = 256) share an SM and one block's tile staging overlaps the other's
compute.  At depth 8 one tree takes 3.3 KB, so the tree tile is 16 trees
(the TPU's 12 MiB VMEM budget and 32-tree cap do not apply).
"""

from __future__ import annotations

import torch

from repro_torch.core.algorithms import go_left

__all__ = ["dense_predicates", "block_heuristics", "tile_smem_bytes",
           "SMEM_BLOCK_MAX", "SMEM_BUDGET", "MAX_KERNEL_DEPTH"]

#: dynamic shared memory one H100 block may use (bytes)
SMEM_BLOCK_MAX = 232_448
#: the tiling budget: two blocks per SM
SMEM_BUDGET = SMEM_BLOCK_MAX // 2
#: deepest forest the CUDA kernels are instantiated for
MAX_KERNEL_DEPTH = 8
#: sample-tile cap (threads per block)
MAX_BLOCK_B = 256
#: tree-tile cap
MAX_BLOCK_T = 64


def dense_predicates(x: torch.Tensor, feature: torch.Tensor,
                     threshold: torch.Tensor,
                     default_left: torch.Tensor) -> torch.Tensor:
    """[B, F] samples, [T, I] nodes -> s [B, T, I] bool (True = left)."""
    xv = x[:, feature.long()]
    return go_left(xv, threshold[None], default_left[None].bool())


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _extra_bytes(kind: str, depth: int) -> int:
    I, L = (1 << depth) - 1, 1 << depth
    if kind == "hummingbird":
        return 4 * 2 * L * ((I + 31) // 32) + 4 * L
    if kind == "quickscorer":
        return 4 * I * ((L + 31) // 32)
    if kind == "predicated":
        return 0
    raise ValueError(f"unknown kernel {kind!r}")


def tile_smem_bytes(kind: str, block_b: int, block_t: int, F: int,
                    depth: int) -> int:
    """Dynamic shared memory of one block, as the CUDA layout lays it out."""
    I, L = (1 << depth) - 1, 1 << depth
    return (_align16(4 * F * block_b) + _align16(4 * block_t * I)
            + _align16(4 * block_t * L) + _align16(4 * block_t * I)
            + _align16(block_t * I) + _align16(_extra_bytes(kind, depth)))


def block_heuristics(kind: str, B: int, T: int, F: int,
                     depth: int) -> tuple[int, int]:
    """(BB, BT) for one kernel launch: BB a multiple of 32 up to 256, BT a
    power of two up to 64, shrunk (tree tile first, then sample tile)
    until the block's shared memory fits ``SMEM_BUDGET``.  Raises when even
    (32, 1) does not fit a block at all (a very wide F)."""
    bb = min(MAX_BLOCK_B, max(32, -(-B // 32) * 32))
    bt = 1
    while bt * 2 <= min(T, MAX_BLOCK_T):
        bt *= 2
    while tile_smem_bytes(kind, bb, bt, F, depth) > SMEM_BUDGET and bt > 1:
        bt //= 2
    while tile_smem_bytes(kind, bb, bt, F, depth) > SMEM_BUDGET and bb > 32:
        bb //= 2
    if tile_smem_bytes(kind, bb, bt, F, depth) > SMEM_BLOCK_MAX:
        raise ValueError(
            f"{kind}: a 32-sample tile of {F} features at depth {depth} "
            f"does not fit one block's shared memory")
    return bb, bt


def sum_trees_in_order(scores: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B], adding tree 0, 1, 2, ... in sequence: the order in
    which every CUDA kernel thread accumulates its sample's sum."""
    acc = torch.zeros(scores.shape[0], dtype=torch.float32,
                      device=scores.device)
    for t in range(scores.shape[1]):
        acc = acc + scores[:, t]
    return acc


def check_kernel_inputs(kind: str, x: torch.Tensor, feature: torch.Tensor,
                        threshold: torch.Tensor, default_left: torch.Tensor,
                        leaf_value: torch.Tensor, *, depth: int,
                        block_b: int, block_t: int,
                        structure: tuple[torch.Tensor, ...] = ()) -> None:
    """Everything a CUDA forest kernel assumes, checked before launch."""
    tensors = (x, feature, threshold, default_left, leaf_value) + structure
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{kind}: every input must be a CUDA tensor, got "
                         f"{[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{kind}: inputs on different devices")
    want = {"x": (x, torch.float32), "feature": (feature, torch.int32),
            "threshold": (threshold, torch.float32),
            "default_left": (default_left, torch.uint8),
            "leaf_value": (leaf_value, torch.float32)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{kind}: {name} must be {dtype}, got {t.dtype}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{kind}: inputs must be contiguous")
    if not 1 <= depth <= MAX_KERNEL_DEPTH:
        raise ValueError(f"{kind}: the CUDA kernels take depth 1.."
                         f"{MAX_KERNEL_DEPTH}, got {depth}")
    I, L = (1 << depth) - 1, 1 << depth
    T = feature.shape[0]
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"{kind}: x must be [B, F], got {tuple(x.shape)}")
    for name, t, cols in (("feature", feature, I), ("threshold", threshold, I),
                          ("default_left", default_left, I),
                          ("leaf_value", leaf_value, L)):
        if tuple(t.shape) != (T, cols):
            raise ValueError(f"{kind}: {name} shape {tuple(t.shape)} != "
                             f"({T}, {cols})")
    if block_b % 32 or not 32 <= block_b <= 1024:
        raise ValueError(f"{kind}: block_b must be a multiple of 32 in "
                         f"[32, 1024], got {block_b}")
    if block_t < 1 or T % block_t:
        raise ValueError(f"{kind}: {T} trees are not a multiple of "
                         f"block_t={block_t}")
    smem = tile_smem_bytes(kind, block_b, block_t, x.shape[1], depth)
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(f"{kind}: tile needs {smem} B of shared memory, "
                         f"a block has {SMEM_BLOCK_MAX}")


def stream_handle(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
