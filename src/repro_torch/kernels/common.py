"""Shared pieces of the forest kernels' plain versions and their tiling.

``dense_predicates`` is the direct gather the CUDA kernels do:
``s[b, t, i] = isnan(x_f) ? default_left : x_f < threshold`` with
``x_f = x[b, feature[t, i]]`` (``core.algorithms.go_left``).  The JAX
reference instead contracts a one-hot over features on the TPU's matrix
unit (``repro/kernels/common.py:dense_predicates``); the booleans are the
same on finite and NaN inputs, but a +-inf feature turns into ``0 * inf =
NaN`` there and goes right on every node of that row.  The port follows
``_go_left`` (see ROADMAP section 3).

``pack_nodes`` / ``unpack_nodes`` convert between the forest's node arrays
and the one 8-byte record per node that every CUDA kernel reads:
``nodes[t, i + 1] = (threshold bits, feature << 1 | default_left)`` as
int32 [T, L, 2], heap slot 0 unused (``csrc/forest_common.cuh``).  The
plain versions take the same record and unpack it.

``block_heuristics`` sizes the kernels' tiles for an H100 block: BB
threads, one sample a thread (QuickScorer: ``QS_ROWS_PER_THREAD`` samples
a thread, BB apart, so its tile holds rows = 4 * BB samples; the others
rows = BB), and a shared-memory working set of

    x tile     4 * F * rows                  staged mode only (below)
    tree tiles buffers * BT * 12 * L      node records and leaves; two
                                          buffers when a launch walks more
                                          than one tile (double buffering)
    extra      HummingBird: NP * KP + 4 * NP + BB * KP   (C^T int8, D, one
                                          S tile per warp; KP = max(32, L),
                                          NP = max(8, L))
               QuickScorer: none     (its masks are derived from
                                          the heap, not loaded)
    out tile   raw kernels only: 4 * rows * (BT + 1)     (scores, staged
                                          so the [B, T] rows leave
                                          coalesced)

each part rounded up to 16 bytes (``csrc/forest_common.cuh:tile_layout``).
The budget (``smem_budget``) is half the 227 KB a block may take for the
predicated and QuickScorer kernels, so two blocks share an SM and one
block's staging overlaps the other's walk; HummingBird's C^T (64 KB
at depth 8) and S tiles take one block an SM, with the whole 227 KB.  At
the HIGGS shape (depth 8, 28 features) a one-tile launch -- a rel partition
-- takes 16 trees; a launch over many trees walks 8-tree tiles, two
buffers of them.  QuickScorer's 4 rows a thread shrink its block to 128
threads (512 samples) there, and its 16-tree launches walk 4-tree tiles.

Two x modes (``x_staged``, the one place that decides).  STAGED: the
block's whole x tile sits in shared memory, feature-major, as above.  Up
to ``X_STAGED_MAX_F`` features it is the faster mode (conflict-free
shared loads of a short row).  Past it (predicated), or where even a
32-sample tile does not fit (every kernel), they run the WIDE-ROW mode: x
is not staged, each thread reads its row from global memory through the
read-only path, and the tile is sized from the trees alone, as at a
narrow F: wide rows no longer shrink the block to one warp and one tree
(a 1600-tree rel plan of the predicated kernel at Bosch's 968 features
would otherwise take 1600 one-tree launches), and no width is refused.
"""

from __future__ import annotations

import torch

from repro_torch.core.algorithms import go_left
from repro_torch.kernels import _build

__all__ = ["dense_predicates", "pack_nodes", "unpack_nodes",
           "block_heuristics", "tile_smem_bytes", "tree_buffers",
           "smem_budget", "launch_forest_kernel", "rows_per_thread",
           "x_staged", "resolve_staged", "count_launch", "SMEM_BLOCK_MAX",
           "SMEM_BUDGET", "MAX_KERNEL_DEPTH", "QS_ROWS_PER_THREAD",
           "X_STAGED_MAX_F"]

#: dynamic shared memory one H100 block may use (bytes)
SMEM_BLOCK_MAX = 232_448
#: the tiling budget of the predicated and QuickScorer kernels: two blocks
#: per SM
SMEM_BUDGET = SMEM_BLOCK_MAX // 2
#: deepest forest the CUDA kernels are instantiated for
MAX_KERNEL_DEPTH = 8
#: sample-tile cap (threads per block; the kernels' __launch_bounds__)
MAX_BLOCK_B = 256
#: tree-tile cap
MAX_BLOCK_T = 64
#: samples a QuickScorer thread scores (csrc/forest_quickscorer.cu: kRows)
QS_ROWS_PER_THREAD = 4
#: widest F at which each (kernel, fused) stages x in shared memory, wider
#: rows running the wide-row mode; None: wherever a 32-sample staged tile
#: fits one block.  Each limit is the widest width at which chip_smoke.py
#: phase 9 timed the staged mode faster, at depth 8 on an H100 (PERF.md
#: section 6): predicated fused is staged-faster at 768 features and wide-
#: faster at 968, predicated raw at 400 and 512; HummingBird and
#: QuickScorer stay faster staged for as long as a tile fits
X_STAGED_MAX_F = {("predicated", True): 768, ("predicated", False): 400,
                  ("hummingbird", True): None, ("hummingbird", False): None,
                  ("quickscorer", True): None, ("quickscorer", False): None}


def dense_predicates(x: torch.Tensor, feature: torch.Tensor,
                     threshold: torch.Tensor,
                     default_left: torch.Tensor) -> torch.Tensor:
    """[B, F] samples, [T, I] nodes -> s [B, T, I] bool (True = left)."""
    xv = x[:, feature.long()]
    return go_left(xv, threshold[None], default_left[None].bool())


def pack_nodes(feature: torch.Tensor, threshold: torch.Tensor,
               default_left: torch.Tensor) -> torch.Tensor:
    """[T, I] node arrays -> the kernels' node records, int32 [T, I + 1, 2]:
    ``[t, i + 1] = (threshold bits, feature << 1 | default_left)``, slot 0
    zero."""
    if threshold.dtype != torch.float32:
        raise TypeError(f"node records hold float32 thresholds, got "
                        f"{threshold.dtype}")
    T, I = feature.shape
    nodes = torch.zeros((T, I + 1, 2), dtype=torch.int32,
                        device=feature.device)
    nodes[:, 1:, 0] = threshold.contiguous().view(torch.int32)
    nodes[:, 1:, 1] = (feature.to(torch.int32) << 1) | default_left.to(
        torch.int32)
    return nodes


def unpack_nodes(nodes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """Node records -> (feature int32, threshold f32, default_left bool),
    each [T, I]: the inverse of ``pack_nodes``, bit for bit."""
    body = nodes[:, 1:]
    threshold = body[..., 0].contiguous().view(torch.float32)
    return body[..., 1] >> 1, threshold, (body[..., 1] & 1).bool()


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _extra_bytes(kind: str, depth: int, block_b: int) -> int:
    L = 1 << depth
    if kind == "hummingbird":        # csrc/forest_hummingbird.cu
        kp, np_ = max(32, L), max(8, L)
        return _align16(np_ * kp) + _align16(4 * np_) + block_b * kp
    if kind in ("predicated", "quickscorer"):
        return 0
    raise ValueError(f"unknown kernel {kind!r}")


def rows_per_thread(kind: str) -> int:
    """Samples one thread of this kernel scores: a block of BB threads
    holds BB times as many."""
    return QS_ROWS_PER_THREAD if kind == "quickscorer" else 1


def smem_budget(kind: str) -> int:
    """Shared memory the tiling may give one block of this kernel."""
    return SMEM_BLOCK_MAX if kind == "hummingbird" else SMEM_BUDGET


def tree_buffers(T: int, block_t: int) -> int:
    """Tree tiles a launch over T trees holds: two (double buffering) when
    it walks more than one."""
    return 2 if T > block_t else 1


def tile_smem_bytes(kind: str, block_b: int, block_t: int, F: int,
                    depth: int, *, fused: bool = True, buffers: int = 1,
                    staged: bool = True) -> int:
    """Dynamic shared memory of one block, as the CUDA layout lays it out
    (``fused=False``: the raw [B, T] kernel, with its out tile;
    ``buffers``: tree tiles held, ``tree_buffers``; ``staged=False``: the
    wide-row mode, no x tile).  ``block_b`` counts threads; the tile holds
    ``rows_per_thread(kind)`` samples for each."""
    L = 1 << depth
    rows = block_b * rows_per_thread(kind)
    tree = _align16(8 * block_t * L) + _align16(4 * block_t * L)
    out_tile = 0 if fused else _align16(4 * rows * (block_t + 1))
    x_tile = _align16(4 * F * rows) if staged else 0
    return (x_tile + buffers * tree
            + _align16(_extra_bytes(kind, depth, block_b)) + out_tile)


def x_staged(kind: str, F: int, depth: int, fused: bool = True) -> bool:
    """Whether a kernel launch over F-feature rows stages x in shared
    memory: up to ``X_STAGED_MAX_F[kind, fused]`` features, and only where
    a 32-sample x tile fits one block beside one tree.  Otherwise the
    wide-row mode reads x from global memory."""
    limit = X_STAGED_MAX_F[kind, fused]
    if limit is not None and F > limit:
        return False
    least = tile_smem_bytes(kind, 32 // rows_per_thread(kind), 1, F, depth,
                            fused=fused)
    return least <= SMEM_BLOCK_MAX


def block_heuristics(kind: str, B: int, T: int, F: int, depth: int, *,
                     fused: bool = True, one_tile: bool = False,
                     staged: bool | None = None) -> tuple[int, int]:
    """(BB, BT) for one fused (or, ``fused=False``, raw) kernel launch over
    T trees: BB threads, a multiple of 32 up to 256 (no more than B
    samples need at ``rows_per_thread`` a thread), BT a power of two up to
    64.  The sample tile shrinks (down to 32 samples) until it fits
    ``smem_budget`` beside one tree, then the tree tile until the block's
    shared memory fits.  ``one_tile``: size the tile for launches of
    exactly BT trees (one tree partition each), which hold one tree
    buffer.  ``staged``: the x mode (None: ``x_staged`` decides); the
    wide-row mode holds no x tile, so F does not shrink its tiles.  Raises
    only when a staged x tile of 32 samples and one tree does not fit a
    block at all."""
    if staged is None:
        staged = x_staged(kind, F, depth, fused)

    def smem(bb, bt):
        buffers = 1 if one_tile else tree_buffers(T, bt)
        return tile_smem_bytes(kind, bb, bt, F, depth, fused=fused,
                               buffers=buffers, staged=staged)

    budget = smem_budget(kind)
    per = rows_per_thread(kind)
    bb = min(MAX_BLOCK_B, max(32, -(-B // (32 * per)) * 32))
    bt = 1
    while bt * 2 <= min(T, MAX_BLOCK_T):
        bt *= 2
    while smem(bb, 1) > budget and bb * per > 32:
        bb //= 2
    while smem(bb, bt) > budget and bt > 1:
        bt //= 2
    if smem(bb, bt) > SMEM_BLOCK_MAX:
        raise ValueError(
            f"{kind}: a staged 32-sample tile of {F} features at depth "
            f"{depth} does not fit one block's shared memory")
    return bb, bt


def resolve_staged(kind: str, x: torch.Tensor, depth: int, fused: bool,
                   staged: bool | None) -> bool:
    """A wrapper's x mode: the caller's, or ``x_staged``'s for x's width."""
    return x_staged(kind, x.shape[1], depth, fused) if staged is None \
        else bool(staged)


def count_launch(wrapper, staged: bool) -> None:
    """One launch of ``wrapper``'s kernel: ``.launches`` counts every
    launch, ``.wide_launches`` those in the wide-row mode."""
    wrapper.launches += 1
    wrapper.wide_launches += not staged


def sum_trees_in_order(scores: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B], adding tree 0, 1, 2, ... in sequence: the order in
    which every CUDA kernel thread accumulates its sample's sum."""
    acc = torch.zeros(scores.shape[0], dtype=torch.float32,
                      device=scores.device)
    for t in range(scores.shape[1]):
        acc = acc + scores[:, t]
    return acc


def check_kernel_inputs(kind: str, x: torch.Tensor, nodes: torch.Tensor,
                        leaf_value: torch.Tensor, *, depth: int,
                        block_b: int, block_t: int, fused: bool,
                        staged: bool = True,
                        structure: tuple[torch.Tensor, ...] = ()) -> None:
    """Everything a CUDA forest kernel assumes, checked before launch."""
    tensors = (x, nodes, leaf_value) + structure
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{kind}: every input must be a CUDA tensor, got "
                         f"{[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{kind}: inputs on different devices")
    want = {"x": (x, torch.float32), "nodes": (nodes, torch.int32),
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
    L = 1 << depth
    T = nodes.shape[0]
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"{kind}: x must be [B, F], got {tuple(x.shape)}")
    if tuple(nodes.shape) != (T, L, 2):
        raise ValueError(f"{kind}: nodes shape {tuple(nodes.shape)} != "
                         f"({T}, {L}, 2)")
    if tuple(leaf_value.shape) != (T, L):
        raise ValueError(f"{kind}: leaf_value shape "
                         f"{tuple(leaf_value.shape)} != ({T}, {L})")
    per = rows_per_thread(kind)
    if block_b * per % 32 or not 32 // per <= block_b <= MAX_BLOCK_B:
        raise ValueError(f"{kind}: block_b must be in [{32 // per}, "
                         f"{MAX_BLOCK_B}] threads of {per} samples, a "
                         f"multiple of 32 samples, got {block_b}")
    if block_t < 1 or T % block_t:
        raise ValueError(f"{kind}: {T} trees are not a multiple of "
                         f"block_t={block_t}")
    smem = tile_smem_bytes(kind, block_b, block_t, x.shape[1], depth,
                           fused=fused, buffers=tree_buffers(T, block_t),
                           staged=staged)
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(f"{kind}: tile needs {smem} B of shared memory, "
                         f"a block has {SMEM_BLOCK_MAX}")


def launch_forest_kernel(kind: str, x: torch.Tensor,
                         trees: tuple[torch.Tensor, torch.Tensor],
                         structure: tuple[torch.Tensor, ...], *, depth: int,
                         block_b: int, block_t: int, fused: bool,
                         staged: bool) -> torch.Tensor:
    """Check the inputs, then launch ``forest_<kind>_fused`` (-> [B]) or
    ``forest_<kind>_raw`` (-> [B, T]) on PyTorch's current stream, in the
    x mode ``staged`` (``x_staged``'s choice, or the caller's).  Every C
    entry point takes (x, nodes, leaf_value, *structure, out, B, F, T,
    depth, block_b, block_t, x_staged, stream) and returns the launch's
    CUDA error; a nonzero one raises.  B need not be a multiple of
    block_b: the kernel masks rows past B and writes none of them."""
    check_kernel_inputs(kind, x, *trees, depth=depth, block_b=block_b,
                        block_t=block_t, fused=fused, staged=staged,
                        structure=structure)
    lib = _build.load(f"forest_{kind}")
    name = f"forest_{kind}_{'fused' if fused else 'raw'}"
    B, F = x.shape
    T = trees[0].shape[0]
    out = torch.empty((B,) if fused else (B, T), dtype=torch.float32,
                      device=x.device)
    ptrs = [t.data_ptr() for t in (x, *trees, *structure, out)]
    err = getattr(lib, name)(*ptrs, B, F, T, depth, block_b, block_t,
                             int(staged),
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, name)
    return out
