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
    out tile  raw kernels only: 4 * BB * (BT + 1)       (scores, staged so
                                          the [B, T] rows leave coalesced)

each part rounded up to 16 bytes (``csrc/forest_common.cuh:tile_layout``).
A raw kernel's out tile is why ``fused=False`` can get a smaller tree tile
than ``fused=True`` for the same forest.
The budget is half the 227 KB a block may take, so two blocks (16 warps at
BB = 256) share an SM and one block's tile staging overlaps the other's
compute.  At depth 8 one tree takes 3.3 KB, so the tree tile is 16 trees
(the TPU's 12 MiB VMEM budget and 32-tree cap do not apply).
"""

from __future__ import annotations

import torch

from repro_torch.core.algorithms import go_left
from repro_torch.kernels import _build

__all__ = ["dense_predicates", "block_heuristics", "tile_smem_bytes",
           "launch_forest_kernel", "SMEM_BLOCK_MAX", "SMEM_BUDGET",
           "MAX_KERNEL_DEPTH"]

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
                    depth: int, *, fused: bool = True) -> int:
    """Dynamic shared memory of one block, as the CUDA layout lays it out
    (``fused=False``: the raw [B, T] kernel, with its out tile)."""
    I, L = (1 << depth) - 1, 1 << depth
    out_tile = 0 if fused else 4 * block_b * (block_t + 1)
    return (_align16(4 * F * block_b) + _align16(4 * block_t * I)
            + _align16(4 * block_t * L) + _align16(4 * block_t * I)
            + _align16(block_t * I) + _align16(_extra_bytes(kind, depth))
            + _align16(out_tile))


def block_heuristics(kind: str, B: int, T: int, F: int, depth: int, *,
                     fused: bool = True) -> tuple[int, int]:
    """(BB, BT) for one fused (or, ``fused=False``, raw) kernel launch: BB
    a multiple of 32 up to 256, BT a power of two up to 64, shrunk (tree
    tile first, then sample tile) until the block's shared memory fits
    ``SMEM_BUDGET``.  Raises when even (32, 1) does not fit a block at all
    (a very wide F)."""
    def smem(bb, bt):
        return tile_smem_bytes(kind, bb, bt, F, depth, fused=fused)

    bb = min(MAX_BLOCK_B, max(32, -(-B // 32) * 32))
    bt = 1
    while bt * 2 <= min(T, MAX_BLOCK_T):
        bt *= 2
    while smem(bb, bt) > SMEM_BUDGET and bt > 1:
        bt //= 2
    while smem(bb, bt) > SMEM_BUDGET and bb > 32:
        bb //= 2
    if smem(bb, bt) > SMEM_BLOCK_MAX:
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
                        block_b: int, block_t: int, fused: bool,
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
    smem = tile_smem_bytes(kind, block_b, block_t, x.shape[1], depth,
                           fused=fused)
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(f"{kind}: tile needs {smem} B of shared memory, "
                         f"a block has {SMEM_BLOCK_MAX}")


def launch_forest_kernel(kind: str, x: torch.Tensor,
                         trees: tuple[torch.Tensor, ...],
                         structure: tuple[torch.Tensor, ...], *, depth: int,
                         block_b: int, block_t: int,
                         fused: bool) -> torch.Tensor:
    """Check the inputs, then launch ``forest_<kind>_fused`` (-> [B]) or
    ``forest_<kind>_raw`` (-> [B, T]) on PyTorch's current stream.  Every
    C entry point takes (x, feature, threshold, default_left, leaf_value,
    *structure, out, B, F, T, depth, block_b, block_t, stream) and returns
    the launch's CUDA error; a nonzero one raises."""
    check_kernel_inputs(kind, x, *trees, depth=depth, block_b=block_b,
                        block_t=block_t, fused=fused, structure=structure)
    lib = _build.load(f"forest_{kind}")
    name = f"forest_{kind}_{'fused' if fused else 'raw'}"
    B, F = x.shape
    T = trees[0].shape[0]
    out = torch.empty((B,) if fused else (B, T), dtype=torch.float32,
                      device=x.device)
    ptrs = [t.data_ptr() for t in (x, *trees, *structure, out)]
    err = getattr(lib, name)(*ptrs, B, F, T, depth, block_b, block_t,
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, name)
    return out
