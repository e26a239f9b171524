"""QuickScorer (bit-vector) forest inference, fused (+ SUM) and raw
([B, T]): CUDA kernel wrappers and their plain PyTorch versions.

Replaces ``repro/kernels/forest_quickscorer.py:quickscorer_fused_kernel_call``
and ``quickscorer_kernel_call`` (Pallas, TPU).  Both kernels are
``csrc/forest_quickscorer.cu``: uint32 words ANDed over the FALSE nodes,
exit leaf = lowest set bit by ``__ffs`` per word in word order.

Structure tensor: ``bv`` [I, ceil(L/32)] int32 holding the uint32 bit
patterns of ``core.forest.qs_bitvectors``.  The wrappers take it, as the
TPU kernels do, and the plain versions AND it; the CUDA kernel derives the
same masks from the heap instead of loading them (``qs_node_masks`` is its
rule), so on the card the wrappers check once per tensor that ``bv`` is
``qs_words(depth)`` and raise if it is not.  The plain version does its
bit operations in int64, since torch's uint32 support is partial and an
int32 ``>>`` is arithmetic.  ``quickscorer_fused`` also takes bf16 tree
tiles (narrow records and bf16 leaves, ``common.pack_narrow_nodes``).
``quickscorer_fused.launches`` / ``quickscorer_raw.launches`` count kernel
launches (``.wide_launches`` those in the wide-row x mode,
``quickscorer_fused.bf16_launches`` those over narrow records).  Past 200
features (raw: 90) both kernels run the wide-tiled layout
(``common.wide_tiled``: 32-row blocks whose warps take different trees,
one row a lane, over feature-major x).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from repro_torch.core.algorithms import ALL_ONES, lowest_set_bit
from repro_torch.core.forest import qs_bitvectors
from repro_torch.kernels.common import (check_kernel_inputs,
                                        dense_predicates,
                                        launch_forest_kernel, record_bytes,
                                        resolve_staged, sum_trees_in_order,
                                        unpack_nodes)

__all__ = ["quickscorer_fused", "quickscorer_fused_plain", "quickscorer_raw",
           "quickscorer_raw_plain", "qs_words", "qs_word_split",
           "in_word_mask", "dead_words", "qs_node_masks", "check_words"]

#: rows per step of the plain version (its [rows, T, I] predicate gather
#: is 1 GiB f32 for 2048 rows at T=512, I=255)
PLAIN_CHUNK_ROWS = 2048


def qs_words(depth: int) -> np.ndarray:
    """The bit-vectors of a depth as int32 bit patterns [I, W]."""
    return qs_bitvectors(depth).view(np.int32)


# -- the CUDA kernel's mask rule (csrc/forest_quickscorer.cu) ---------------
# A FALSE node at level d, position p of a depth-D heap clears exactly its
# left subtree's leaves, [p 2^(D-d), p 2^(D-d) + 2^(D-d-1)).  With DW =
# min(D, 5) levels to a 32-bit word, the K = D - DW top levels clear whole
# words, and every node below sits in the depth-DW subtree of one word.

def qs_word_split(depth: int) -> tuple[int, int, int]:
    """(DW, K, W): levels inside one word, top levels, words per tree."""
    dw = min(depth, 5)
    return dw, depth - dw, 1 << (depth - dw)


def in_word_mask(dw: int, k: int, q: int) -> int:
    """The word mask of a FALSE node at level k, position q of a depth-dw
    word subtree: 2^(dw-k-1) bits cleared from bit q 2^(dw-k)."""
    return ~(((1 << (1 << (dw - k - 1))) - 1) << (q << (dw - k))) \
        & 0xFFFFFFFF


def dead_words(K: int, d: int, p: int) -> int:
    """The words a FALSE top node (level d < K, position p) clears, as bits
    of a W-bit mask: [p 2^(K-d), p 2^(K-d) + 2^(K-d-1))."""
    return ((1 << (1 << (K - d - 1))) - 1) << (p << (K - d))


def qs_node_masks(depth: int) -> np.ndarray:
    """The bit-vectors [I, W] uint32 rebuilt from the kernel's rule: top
    node (d, p) is heap slot 2^d + p, node (k, q) of word w's subtree is
    slot ((W + w) << k) + q (node index = slot - 1).  Equals
    ``core.forest.qs_bitvectors(depth)``."""
    dw, K, W = qs_word_split(depth)
    bv = np.full(((1 << depth) - 1, W), 0xFFFFFFFF, np.uint32)
    for d in range(K):
        for p in range(1 << d):
            dead = dead_words(K, d, p)
            bv[(1 << d) + p - 1] = [0 if dead >> w & 1 else 0xFFFFFFFF
                                    for w in range(W)]
    for w in range(W):
        for k in range(dw):
            for q in range(1 << k):
                bv[((W + w) << k) + q - 1, w] = in_word_mask(dw, k, q)
    return bv


def quickscorer_raw_plain(x: torch.Tensor, nodes: torch.Tensor,
                          leaf_value: torch.Tensor, bv: torch.Tensor, *,
                          depth: int) -> torch.Tensor:
    """The raw kernel's function in plain torch: per (sample, tree) AND the
    FALSE nodes' words node by node, take the lowest set bit, look up the
    leaf -> [B, T].  Samples go ``PLAIN_CHUNK_ROWS`` rows at a time.
    Takes either node record (bf16 trees upcast to f32)."""
    chunk = PLAIN_CHUNK_ROWS
    feature, threshold, default_left = unpack_nodes(nodes)
    leaf_value = leaf_value.float()
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


def quickscorer_fused_plain(x: torch.Tensor, nodes: torch.Tensor,
                            leaf_value: torch.Tensor, bv: torch.Tensor, *,
                            depth: int) -> torch.Tensor:
    """The fused kernel's function: the raw scores added tree by tree."""
    return sum_trees_in_order(quickscorer_raw_plain(
        x, nodes, leaf_value, bv, depth=depth))


#: id(bv) -> (weak reference, depth, version) of each tensor found equal
#: to ``qs_words(depth)``; an entry goes when its tensor is collected
_CHECKED: dict[int, tuple] = {}


def check_words(bv: torch.Tensor, depth: int) -> None:
    """Raise unless ``bv`` holds ``qs_words(depth)``: the CUDA kernel
    derives these masks and never reads ``bv``, so any other bit-vectors
    must not pass silently.  The contents are compared once per tensor
    (and again after an in-place change)."""
    I, L = (1 << depth) - 1, 1 << depth
    if tuple(bv.shape) != (I, (L + 31) // 32) or bv.dtype != torch.int32:
        raise ValueError(f"quickscorer: bit-vectors do not match depth "
                         f"{depth} as int32 [{I}, {(L + 31) // 32}]")
    key = id(bv)
    seen = _CHECKED.get(key)
    if seen is not None and seen[0]() is bv and seen[1:] == (depth,
                                                             bv._version):
        return
    want = torch.as_tensor(qs_words(depth), device=bv.device)
    if not torch.equal(bv, want):
        raise ValueError(f"quickscorer: bit-vectors are not those of a "
                         f"depth-{depth} heap (qs_words); the CUDA kernel "
                         f"derives the heap's masks and cannot take others")
    if seen is None:
        weakref.finalize(bv, _CHECKED.pop, key, None)
    _CHECKED[key] = (weakref.ref(bv), depth, bv._version)


def _launch(x, nodes, leaf_value, bv, *, depth, block_b, block_t, fused,
            staged, counter):
    """Check every input, ``bv`` included, then launch the kernel, which
    takes no bit-vectors, counting it on ``counter``."""
    check_kernel_inputs("quickscorer", x, nodes, leaf_value, depth=depth,
                        block_b=block_b, block_t=block_t, fused=fused,
                        staged=staged, structure=(bv,))
    check_words(bv, depth)
    return launch_forest_kernel("quickscorer", x, (nodes, leaf_value), (),
                                depth=depth, block_b=block_b,
                                block_t=block_t, fused=fused, staged=staged,
                                counter=counter)


def quickscorer_fused(x: torch.Tensor, nodes: torch.Tensor,
                      leaf_value: torch.Tensor, bv: torch.Tensor, *,
                      depth: int, block_b: int, block_t: int,
                      staged: bool | None = None) -> torch.Tensor:
    """[B, F] samples, tree-padded node records and leaves (f32, or narrow
    records and bf16 leaves), bit-vectors -> [B] f32."""
    if x.device.type == "cpu":
        return quickscorer_fused_plain(x, nodes, leaf_value, bv, depth=depth)
    staged = resolve_staged("quickscorer", x, depth, True, staged,
                            record_bytes(nodes))
    out = _launch(x, nodes, leaf_value, bv, depth=depth, block_b=block_b,
                  block_t=block_t, fused=True, staged=staged,
                  counter=quickscorer_fused)
    return out


def quickscorer_raw(x: torch.Tensor, nodes: torch.Tensor,
                    leaf_value: torch.Tensor, bv: torch.Tensor, *,
                    depth: int, block_b: int, block_t: int,
                    staged: bool | None = None) -> torch.Tensor:
    """As ``quickscorer_fused``, but -> [B, T] f32, each tree's score."""
    if x.device.type == "cpu":
        return quickscorer_raw_plain(x, nodes, leaf_value, bv, depth=depth)
    staged = resolve_staged("quickscorer", x, depth, False, staged)
    out = _launch(x, nodes, leaf_value, bv, depth=depth, block_b=block_b,
                  block_t=block_t, fused=False, staged=staged,
                  counter=quickscorer_raw)
    return out


quickscorer_fused.launches = quickscorer_fused.wide_launches = 0
quickscorer_fused.bf16_launches = 0
quickscorer_raw.launches = quickscorer_raw.wide_launches = 0
