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

bf16 tree tiles (the reference's ``tree_dtype=jnp.bfloat16``,
``repro/kernels/ops.py:_prepared``) narrow the record to one 4-byte word,
``pack_narrow_nodes``: ``bf16 threshold bits << 16 | feature << 1 |
default_left`` as int32 [T, L], with bf16 leaves [T, L].  The word's high
half IS the f32 bit pattern of the bf16 threshold, so ``word & 0xFFFF0000``
upcasts it exactly; 15 bits hold the feature, so only forests of at most
``NARROW_MAX_FEATURES`` features take it (``narrow_record``).  The fused
kernels read either record; ``unpack_nodes`` unpacks either.

``block_heuristics`` sizes the kernels' tiles for an H100 block: BB
threads, one sample a thread (QuickScorer staged: ``QS_ROWS_PER_THREAD``
samples a thread, BB apart, so its tile holds rows = 4 * BB samples; the
others, and every wide-tiled block, rows = BB), and a shared-memory
working set of

    x tile     4 * F * rows                  staged mode only (below)
    tree tiles buffers * BT * 12 * L      node records and leaves (6 * L
                                          with the narrow record); two
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
shared loads of a short row).  Past it, or where even a 32-sample tile
does not fit (every kernel), they run the WIDE-ROW mode: x is not staged
and the tile is sized from the trees alone, as at a narrow F: wide rows
no longer shrink the block to one warp and one tree (a 1600-tree rel
plan of the predicated kernel at Bosch's 968 features would otherwise
take 1600 one-tree launches), and no width is refused.  The raw
predicated kernel reads each thread's row from row-major global x there.
Every other kernel -- the three fused ones, raw HummingBird and raw
QuickScorer -- runs the WIDE-TILED layout instead (``wide_tiled``): a
block owns ``WIDE_ROWS`` = 32 rows and its BB / 32 warps walk different
trees of each tile, writing their scores to an out tile of 32 rows that
the block then adds in tree order (fused) or writes out (raw), so the
rows in flight are an eighth of 256-row blocks' (34 MB at 2,000 features
for one block an SM, inside the 50 MB L2).  Their x is feature-major,
[F, ldx] with ldx = the rows rounded up to 32 (``wide_ldx``), which
``launch_forest_kernel`` writes with ``forest_transpose_rows`` before the
launch, ``XT_CHUNK_BYTES`` of x at a time at most.
"""

from __future__ import annotations

import torch

from repro_torch.core.algorithms import go_left
from repro_torch.kernels import _build

__all__ = ["dense_predicates", "pack_nodes", "unpack_nodes",
           "pack_narrow_nodes", "unpack_narrow_nodes", "narrow_record",
           "record_bytes", "block_heuristics", "tile_smem_bytes",
           "tree_buffers", "smem_budget", "launch_forest_kernel",
           "rows_per_thread", "tiled_launch", "x_staged", "resolve_staged",
           "SMEM_BLOCK_MAX", "SMEM_BUDGET", "MAX_KERNEL_DEPTH",
           "QS_ROWS_PER_THREAD", "X_STAGED_MAX_F", "NARROW_MAX_FEATURES",
           "WIDE_ROWS", "XT_CHUNK_BYTES", "wide_tiled", "wide_ldx",
           "xt_chunks", "feature_major", "feature_major_plain"]

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
#: samples a QuickScorer thread of the staged mode scores
#: (csrc/forest_quickscorer.cu: kRows)
QS_ROWS_PER_THREAD = 4
#: samples a block of the wide-tiled layout owns, one a lane of every warp
#: (csrc/forest_common.cuh: kWideRows)
WIDE_ROWS = 32
#: most bytes of feature-major x one wide-tiled launch transposes at a
#: time: wider launches run their rows in chunks of at most this much, so
#: the transposed copy adds at most 1 GiB to the launch's memory peak
XT_CHUNK_BYTES = 1 << 30
#: widest forest the narrow node record can name: 15 feature bits
NARROW_MAX_FEATURES = 1 << 15
#: node-record bytes: the f32 record, the narrow (bf16) one; a leaf takes
#: half as many
WIDE_RECORD_BYTES, NARROW_RECORD_BYTES = 8, 4
#: widest F at which each (kernel, fused) stages x in shared memory, wider
#: rows running the wide-row mode.  Each limit is the widest of
#: chip_smoke.py phase 9's widths at which the staged mode timed faster,
#: at depth 8 on an H100
#: (PERF.md section 6; chip_wide_probe.py times the same loop for the
#: wide-tiled kernels): predicated fused and raw are staged-faster at 400
#: features and wide-faster at 640 and 512 (fused at 512 is a tie within
#: 3 %, which way varies by run); HummingBird fused and raw and raw
#: QuickScorer staged-faster at 90 and wide-faster at 200; QuickScorer
#: fused staged-faster at 200 and wide-faster at 400
X_STAGED_MAX_F = {("predicated", True): 400, ("predicated", False): 400,
                  ("hummingbird", True): 90, ("hummingbird", False): 90,
                  ("quickscorer", True): 200, ("quickscorer", False): 90}


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
    each [T, I]: the inverse of ``pack_nodes``, bit for bit, or of
    ``pack_narrow_nodes`` for a narrow record ([T, L], the threshold
    upcast from bf16)."""
    if nodes.dim() == 2:
        return unpack_narrow_nodes(nodes)
    body = nodes[:, 1:]
    threshold = body[..., 0].contiguous().view(torch.float32)
    return body[..., 1] >> 1, threshold, (body[..., 1] & 1).bool()


def narrow_record(n_features: int) -> bool:
    """Whether bf16 tree tiles over a forest of ``n_features`` features
    take the narrow 4-byte record.  A wider forest's feature indices do
    not fit 15 bits: its bf16 tiles keep the 8-byte record, holding the
    bf16-rounded thresholds widened to f32 (exact) and f32 leaves of the
    bf16-rounded values, so the result is the same."""
    return n_features <= NARROW_MAX_FEATURES


def record_bytes(nodes: torch.Tensor) -> int:
    """Bytes of one node record of a packed tree tensor."""
    return NARROW_RECORD_BYTES if nodes.dim() == 2 else WIDE_RECORD_BYTES


def pack_narrow_nodes(feature: torch.Tensor, threshold: torch.Tensor,
                      default_left: torch.Tensor) -> torch.Tensor:
    """[T, I] node arrays -> the narrow node records, int32 [T, I + 1]:
    ``[t, i + 1] = bf16(threshold) bits << 16 | feature << 1 |
    default_left``, slot 0 zero.  The threshold rounds to bf16 to nearest
    even, as XLA's cast does; +-inf and -0.0 survive exactly."""
    T, I = feature.shape
    if feature.numel() and int(feature.max()) >= NARROW_MAX_FEATURES:
        raise ValueError(f"a narrow node record names features below "
                         f"{NARROW_MAX_FEATURES}, got {int(feature.max())}")
    # the f32 pattern of a bf16 value is its bits << 16, low half zero
    high = threshold.to(torch.bfloat16).float().contiguous().view(
        torch.int32)
    nodes = torch.zeros((T, I + 1), dtype=torch.int32, device=feature.device)
    nodes[:, 1:] = high | (feature.to(torch.int32) << 1) | default_left.to(
        torch.int32)
    return nodes


def unpack_narrow_nodes(nodes: torch.Tensor) -> tuple[torch.Tensor,
                                                      torch.Tensor,
                                                      torch.Tensor]:
    """Narrow node records -> (feature int32, threshold f32 upcast from
    bf16, default_left bool), each [T, I]: what the kernels decode."""
    body = nodes[:, 1:]
    threshold = (body & -(1 << 16)).contiguous().view(torch.float32)
    return (body >> 1) & 0x7FFF, threshold, (body & 1).bool()


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


def wide_tiled(kind: str, fused: bool) -> bool:
    """Whether this kernel's wide-row mode runs the wide-tiled layout
    (32-row blocks, warps over trees, feature-major x): every kernel but
    raw predicated, which reads row-major x."""
    return fused or kind != "predicated"


def tiled_launch(kind: str, fused: bool, staged: bool) -> bool:
    """Whether a launch in this x mode runs the wide-tiled layout."""
    return not staged and wide_tiled(kind, fused)


def rows_per_thread(kind: str, fused: bool = True,
                    staged: bool = True) -> int:
    """Samples one thread of this kernel scores in this x mode: a block of
    BB threads holds BB times as many.  In the wide-tiled layout a thread
    of every kernel holds one row, its lane's."""
    if kind == "quickscorer" and not tiled_launch(kind, fused, staged):
        return QS_ROWS_PER_THREAD
    return 1


def wide_ldx(rows: int) -> int:
    """Rows of a feature of the wide-tiled layout's feature-major x: the
    launch's rows rounded up to a whole ``WIDE_ROWS`` (zeros past them)."""
    return -(-rows // WIDE_ROWS) * WIDE_ROWS


def xt_chunks(rows: int, F: int):
    """(first row, rows) of each chunk a wide-tiled launch over ``rows``
    rows of F features transposes and scores in turn: as many whole
    ``WIDE_ROWS`` as ``XT_CHUNK_BYTES`` holds (at least one block's), the
    last chunk the rest."""
    step = max(WIDE_ROWS, XT_CHUNK_BYTES // (4 * F) // WIDE_ROWS * WIDE_ROWS)
    return [(r0, min(step, rows - r0)) for r0 in range(0, rows, step)]


def feature_major_plain(x: torch.Tensor) -> torch.Tensor:
    """The transpose kernel's function: [B, F] -> [F, wide_ldx(B)], x
    transposed and zeros past row B."""
    B, F = x.shape
    xt = torch.zeros((F, wide_ldx(B)), dtype=x.dtype, device=x.device)
    xt[:, :B] = x.t()
    return xt


def _transpose(lib, x: torch.Tensor, r0: int, n: int,
               xt: torch.Tensor) -> torch.Tensor:
    """Rows r0 .. r0 + n of x, feature-major, written by
    ``forest_transpose_rows`` into the front of the scratch ``xt`` on the
    current stream of x's card: [F, wide_ldx(n)]."""
    F = x.shape[1]
    err = lib.forest_transpose_rows(
        x.data_ptr() + r0 * F * x.element_size(), xt.data_ptr(), n, F,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "forest_transpose_rows")
    feature_major.launches += 1
    feature_major.wide_launches += 1
    return xt.view(-1)[:F * wide_ldx(n)].view(F, wide_ldx(n))


def feature_major(x: torch.Tensor) -> torch.Tensor:
    """The wide-tiled kernels' x operand, [F, wide_ldx(B)] f32: for a CPU
    tensor the plain version, for a CUDA tensor the transpose kernel (one
    launch over all B rows; the kernel wrappers transpose chunk by
    chunk).  ``.launches`` counts the transpose's launches, the kernel
    wrappers' included; ``.wide_launches`` the same, as every one feeds a
    wide-row launch."""
    if x.device.type == "cpu":
        return feature_major_plain(x)
    if x.dtype != torch.float32 or not x.is_contiguous() or x.dim() != 2:
        raise ValueError("feature_major: x must be contiguous [B, F] f32")
    with torch.cuda.device(x.device):
        xt = torch.empty((x.shape[1], wide_ldx(x.shape[0])),
                         dtype=torch.float32, device=x.device)
        return _transpose(_build.load("forest_predicated"), x, 0,
                          x.shape[0], xt)


feature_major.launches = feature_major.wide_launches = 0


def smem_budget(kind: str) -> int:
    """Shared memory the tiling may give one block of this kernel."""
    return SMEM_BLOCK_MAX if kind == "hummingbird" else SMEM_BUDGET


def tree_buffers(T: int, block_t: int) -> int:
    """Tree tiles a launch over T trees holds: two (double buffering) when
    it walks more than one."""
    return 2 if T > block_t else 1


def tile_smem_bytes(kind: str, block_b: int, block_t: int, F: int,
                    depth: int, *, fused: bool = True, buffers: int = 1,
                    staged: bool = True,
                    record: int = WIDE_RECORD_BYTES) -> int:
    """Dynamic shared memory of one block, as the CUDA layout lays it out
    (``fused=False``: the raw [B, T] kernel, with its out tile;
    ``buffers``: tree tiles held, ``tree_buffers``; ``staged=False``: the
    wide-row mode, no x tile, and where ``wide_tiled`` an out tile of
    ``WIDE_ROWS`` rows, fused kernels too; ``record``: node-record bytes,
    a leaf half of it).  ``block_b`` counts threads; the tile holds
    ``rows_per_thread(kind)`` samples for each (staged and row-major),
    one in the wide-tiled layout."""
    L = 1 << depth
    tiled = tiled_launch(kind, fused, staged)
    rows = block_b * rows_per_thread(kind, fused, staged)
    tree = (_align16(record * block_t * L)
            + _align16(record // 2 * block_t * L))
    if tiled:
        out_rows = WIDE_ROWS
    else:
        out_rows = 0 if fused else rows
    out_tile = _align16(4 * out_rows * (block_t + 1))
    x_tile = _align16(4 * F * rows) if staged else 0
    return (x_tile + buffers * tree
            + _align16(_extra_bytes(kind, depth, block_b)) + out_tile)


def x_staged(kind: str, F: int, depth: int, fused: bool = True, *,
             record: int = WIDE_RECORD_BYTES) -> bool:
    """Whether a kernel launch over F-feature rows stages x in shared
    memory: up to ``X_STAGED_MAX_F[kind, fused]`` features, and only where
    a 32-sample x tile fits one block beside one tree.  Otherwise the
    wide-row mode reads x from global memory."""
    if F > X_STAGED_MAX_F[kind, fused]:
        return False
    least = tile_smem_bytes(kind, 32 // rows_per_thread(kind), 1, F, depth,
                            fused=fused, record=record)
    return least <= SMEM_BLOCK_MAX


def block_heuristics(kind: str, B: int, T: int, F: int, depth: int, *,
                     fused: bool = True, one_tile: bool = False,
                     staged: bool | None = None,
                     record: int = WIDE_RECORD_BYTES) -> tuple[int, int]:
    """(BB, BT) for one fused (or, ``fused=False``, raw) kernel launch over
    T trees: BB threads, a multiple of 32 up to 256 (no more than B
    samples need at ``rows_per_thread`` a thread; 256 in the wide-tiled
    layout, whose warps share 32 rows), BT a power of two up to 64.  The
    sample tile shrinks (down to 32 samples) until it fits
    ``smem_budget`` beside one tree, then the tree tile until the block's
    shared memory fits.  ``one_tile``: size the tile for launches of
    exactly BT trees (one tree partition each), which hold one tree
    buffer.  ``staged``: the x mode (None: ``x_staged`` decides); the
    wide-row mode holds no x tile, so F does not shrink its tiles.
    ``record``: node-record bytes (the narrow bf16 record halves a tree
    tile, so the same budget takes twice the trees).  Raises only when a
    staged x tile of 32 samples and one tree does not fit a block at
    all."""
    if staged is None:
        staged = x_staged(kind, F, depth, fused, record=record)

    def smem(bb, bt):
        buffers = 1 if one_tile else tree_buffers(T, bt)
        return tile_smem_bytes(kind, bb, bt, F, depth, fused=fused,
                               buffers=buffers, staged=staged,
                               record=record)

    budget = smem_budget(kind)
    per = rows_per_thread(kind, fused, staged)
    if tiled_launch(kind, fused, staged):
        bb = MAX_BLOCK_B        # warps over trees: any B takes them all
    else:
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
                   staged: bool | None,
                   record: int = WIDE_RECORD_BYTES) -> bool:
    """A wrapper's x mode: the caller's, or ``x_staged``'s for x's width."""
    return x_staged(kind, x.shape[1], depth, fused, record=record) \
        if staged is None else bool(staged)


def _count_launch(wrapper, staged: bool, narrow: bool = False) -> None:
    """One launch of ``wrapper``'s kernel: ``.launches`` counts every
    launch, ``.wide_launches`` those in the wide-row x mode,
    ``.bf16_launches`` (fused wrappers) those over narrow bf16 records.
    ``launch_forest_kernel`` calls it at each launch, so a wide-tiled call
    over more than ``XT_CHUNK_BYTES`` of x counts one launch a chunk."""
    wrapper.launches += 1
    wrapper.wide_launches += not staged
    if narrow:
        wrapper.bf16_launches += 1


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
    """Everything a CUDA forest kernel assumes, checked before launch.
    A narrow record ([T, L] int32 with bf16 leaves) only feeds the fused
    kernels."""
    tensors = (x, nodes, leaf_value) + structure
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{kind}: every input must be a CUDA tensor, got "
                         f"{[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{kind}: inputs on different devices")
    narrow = nodes.dim() == 2
    if narrow and not fused:
        raise ValueError(f"{kind}: the raw kernel takes f32 trees only")
    want = {"x": (x, torch.float32), "nodes": (nodes, torch.int32),
            "leaf_value": (leaf_value,
                           torch.bfloat16 if narrow else torch.float32)}
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
    if tuple(nodes.shape) != ((T, L) if narrow else (T, L, 2)):
        raise ValueError(f"{kind}: nodes shape {tuple(nodes.shape)} != "
                         f"({T}, {L}{'' if narrow else ', 2'})")
    if tuple(leaf_value.shape) != (T, L):
        raise ValueError(f"{kind}: leaf_value shape "
                         f"{tuple(leaf_value.shape)} != ({T}, {L})")
    # a wide-tiled block's warps share its 32 rows: whole warps only
    per = rows_per_thread(kind, fused, staged)
    if block_b * per % 32 or not 32 // per <= block_b <= MAX_BLOCK_B:
        raise ValueError(f"{kind}: block_b must be in [{32 // per}, "
                         f"{MAX_BLOCK_B}] threads of {per} samples, a "
                         f"multiple of 32 samples, got {block_b}")
    if block_t < 1 or T % block_t:
        raise ValueError(f"{kind}: {T} trees are not a multiple of "
                         f"block_t={block_t}")
    smem = tile_smem_bytes(kind, block_b, block_t, x.shape[1], depth,
                           fused=fused, buffers=tree_buffers(T, block_t),
                           staged=staged, record=record_bytes(nodes))
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(f"{kind}: tile needs {smem} B of shared memory, "
                         f"a block has {SMEM_BLOCK_MAX}")


def launch_forest_kernel(kind: str, x: torch.Tensor,
                         trees: tuple[torch.Tensor, torch.Tensor],
                         structure: tuple[torch.Tensor, ...], *, depth: int,
                         block_b: int, block_t: int, fused: bool,
                         staged: bool, counter) -> torch.Tensor:
    """Check the inputs, then launch ``forest_<kind>_fused`` (-> [B]; over
    narrow bf16 records ``forest_<kind>_fused_bf16``) or
    ``forest_<kind>_raw`` (-> [B, T]) on the current stream of x's card,
    with that card made current for the launch (a mesh position's kernel
    runs on its own card whichever card the caller has current), in the
    x mode ``staged`` (``x_staged``'s choice, or the caller's).  Every C
    entry point takes (x, nodes, leaf_value, *structure, out, B, F, T,
    depth, block_b, block_t, x_staged, stream) and returns the launch's
    CUDA error; a nonzero one raises.  B need not be a multiple of
    block_b: the kernel masks rows past B and writes none of them.  A
    ``wide_tiled`` kernel in the wide-row mode takes feature-major x:
    ``forest_transpose_rows`` writes it into one scratch tensor on the same
    stream, chunk by chunk (``xt_chunks``), and the entry point runs on
    each chunk (x = its [F, wide_ldx(rows)], B = its rows, out from the
    chunk's first row).  Each launch of the entry point counts on
    ``counter``, the calling wrapper (``_count_launch``), and each transpose
    on ``feature_major``."""
    check_kernel_inputs(kind, x, *trees, depth=depth, block_b=block_b,
                        block_t=block_t, fused=fused, staged=staged,
                        structure=structure)
    lib = _build.load(f"forest_{kind}")
    name = f"forest_{kind}_{'fused' if fused else 'raw'}"
    narrow = trees[0].dim() == 2
    if narrow:
        name += "_bf16"
    B, F = x.shape
    T = trees[0].shape[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        out = torch.empty((B,) if fused else (B, T), dtype=torch.float32,
                          device=x.device)
        tree_ptrs = [t.data_ptr() for t in (*trees, *structure)]
        if not tiled_launch(kind, fused, staged):
            err = getattr(lib, name)(
                x.data_ptr(), *tree_ptrs, out.data_ptr(), B, F, T, depth,
                block_b, block_t, int(staged), stream)
            _build.check(lib, err, name)
            _count_launch(counter, staged, narrow)
            return out
        chunks = xt_chunks(B, F)
        if not chunks:
            return out
        xt = torch.empty(F * wide_ldx(chunks[0][1]), dtype=torch.float32,
                         device=x.device)
        per_row = out.stride(0) * out.element_size()
        for r0, n in chunks:
            xc = _transpose(lib, x, r0, n, xt)
            err = getattr(lib, name)(
                xc.data_ptr(), *tree_ptrs, out.data_ptr() + r0 * per_row, n,
                F, T, depth, block_b, block_t, 0, stream)
            _build.check(lib, err, name)
            _count_launch(counter, False, narrow)
    return out
