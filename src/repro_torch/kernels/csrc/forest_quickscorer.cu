// QuickScorer (bit-vector) forest inference, for sm_90a: fused (+ SUM) and
// raw ([B, T]) variants of one kernel.
//
// Replaces repro/kernels/forest_quickscorer.py:quickscorer_fused_kernel_call
// (the Pallas kernel at its pl.pallas_call, line 172) and
// quickscorer_kernel_call (line 142).  Per (sample, tree), every one of the
// I node predicates is evaluated, and
//     surv[w] = AND over FALSE nodes i (sample goes right) of bv[i, w]
//     leaf    = lowest set bit of surv, words taken in order, LSB first
//     score   = leaf_value[t, leaf]
// fused: out[b] += score over the trees in order; raw: out[b * T + t].
//
// The masks are derived from the heap, not loaded.  bv [I, W] uint32
// depends on the tree structure only (core/forest.py:qs_bitvectors): the
// FALSE node at level d, position p clears exactly the leaves of its left
// subtree, [p 2^(D-d), p 2^(D-d) + 2^(D-d-1)).  With DW = min(D, 5) levels
// to a 32-bit word, K = D - DW top levels and W = 2^K words:
//   * the W - 1 top nodes (levels < K) clear whole words: a FALSE one sets
//     bits of a W-bit dead-words mask (``dead_words``);
//   * word w holds the leaves of the depth-DW subtree at level K, position
//     w; each of its 2^DW - 1 nodes (level K + k, position (w << k) + q)
//     ANDs one in-word mask (``in_word_mask``) into one register, cur;
//   * surv[w] = dead bit w ? 0 : cur, and the exit leaf is the lowest set
//     bit of the first non-zero word.
// At depth 8 that is 260 mask words that are not all-ones of the 2,040 in
// bv, and no load of bv at all.  Below depth 5, W = 1 and the bits past L
// are phantoms that are never cleared; the real exit leaf always survives
// and is lower, so the lowest bit is right.  kernels/forest_quickscorer.py:
// qs_node_masks is the same rule in Python, held against qs_bitvectors by
// the tests.
//
// What bounds it on this card: operations.  Every node predicate is
// evaluated (I shared-memory gathers and compares per pair); bytes (x read
// once, [B] or [B, T] written once) are small beside that.  Design:
//   * kRows samples a thread, blockDim.x apart: one broadcast node-record
//     load (every thread of a warp is at the same node) serves kRows rows,
//     the kRows AND chains are independent, and each x gather of a warp
//     reads 32 consecutive floats of the feature-major tile (no bank
//     conflicts);
//   * the word loop is not unrolled, its body of at most 31 nodes x kRows
//     rows is: one flat loop of constant trip count over the subtree's
//     heap slots, which unrolls whole (a level loop with a position loop
//     inside does not), so the masks are immediates and a word's records
//     load at fixed offsets from one base per level, ((W + w) << k) + q.
//     All 255 nodes unrolled would be ~100 KB of code and thrash the
//     instruction cache;
//   * per row and node: one gather, two compares (``goes_right``) and one
//     predicated AND; __ffs per word;
//   * x staging, cp.async tree tiles (double-buffered over several tiles)
//     and the raw out tile are the shared ones of forest_common.cuh.
// Wide rows (STAGED false, ``quickscorer_wide_kernel``), fused and raw:
// the wide-tiled layout (forest_common.cuh).  A block of 32 rows, one a
// lane, its 8 warps over trees, two blocks an SM; each warp walks one
// tree at a time with the same mask rule (``qs_exit_leaves``, which the
// staged mode runs over its kRows rows).  Every one of a tree's I nodes
// loads its feature of the warp's 32 rows from feature-major x: one
// aligned 128-byte line, where 32 row-major rows took 32 lines (over
// row-major x the same kernel took 24x the time of the transpose and this
// kernel).  The walk sits at the 128 registers of two blocks an SM, where
// ``col_at``'s 32 x 32 -> 64-bit offset product matters.  Kernel alone
// at 100,352 x 2,000 x 512 trees on an H100 (chip_wide_probe.py, PERF.md
// section 6): 11.40 ms; with a 64 x 64-bit product 14.77 ms; walking two
// trees a warp at once, which spills, 18.28 ms.  Its time hardly grows with F (9.09 ms at 968
// features): what bounds it is instructions and their latency, not lines.
// bf16 tree tiles (NARROW, fused only): each node is a 4-byte record whose
// threshold is masked out of it, each exit leaf a 2-byte load shifted to
// f32; the masks and the word loop are the same.
#include "forest_common.cuh"

namespace forest {

// samples a thread of the staged mode (kernels/common.py:
// QS_ROWS_PER_THREAD mirrors it)
constexpr int kRows = 4;

__host__ __device__ constexpr int ilog2(int v) {
  return v > 1 ? 1 + ilog2(v >> 1) : 0;
}

// The FALSE node at level k, position q of a depth-dw word subtree clears
// 2^(dw-k-1) bits from bit q 2^(dw-k): its left subtree's leaves.
__host__ __device__ constexpr uint32_t in_word_mask(int dw, int k, int q) {
  return ~(((1u << (1 << (dw - k - 1))) - 1u) << (q << (dw - k)));
}

// The FALSE top node at level d, position p of K top levels kills words
// [p 2^(K-d), p 2^(K-d) + 2^(K-d-1)).
__host__ __device__ constexpr uint32_t dead_words(int K, int d, int p) {
  return ((1u << (1 << (K - d - 1))) - 1u) << (p << (K - d));
}

// !go_left (forest_common.cuh): the sample goes right, the node is FALSE.
// One ordered compare, OR a NaN test ANDed with the node's default-right
// bit: bitwise, so it compiles to two compares a row and no branch on the
// node's bit.
__device__ inline bool goes_right(float v, float threshold, bool nan_right) {
  return (v >= threshold) | (nan_right & isnan(v));
}

// The exit leaves of R (row, tree) pairs, in the rule above:
// ``right(slot, r)`` sets r[j] when pair j goes right at heap slot ``slot``
// of its tree (its node is FALSE).  The top nodes set the dead-words bits;
// each word's subtree is one flat loop of constant trip count, so it
// unrolls whole and every mask is an immediate, while the word loop stays
// rolled; the exit leaf is the lowest set bit of the first surviving word.
template <int DEPTH, int R, typename Right>
__device__ __forceinline__ void qs_exit_leaves(Right right, int (&leaf)[R]) {
  constexpr int DW = DEPTH < 5 ? DEPTH : 5;  // levels inside one word
  constexpr int K = DEPTH - DW;              // top levels
  constexpr int W = 1 << K;                  // words of a tree's leaves
  // top nodes, heap slots 1 .. W-1
  uint32_t dead[R] = {};
#pragma unroll
  for (int i = 1; i < W; ++i) {
    bool r[R];
    right(i, r);
    const uint32_t m = dead_words(K, ilog2(i), i - (1 << ilog2(i)));
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (r[j]) dead[j] |= m;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) leaf[j] = -1;
#pragma unroll 1
  for (int w = 0; w < W; ++w) {
    uint32_t cur[R];
#pragma unroll
    for (int j = 0; j < R; ++j) cur[j] = 0xFFFFFFFFu;
    // word w's subtree: its node i (level k = ilog2(i), position
    // q = i - 2^k) is heap slot ((W + w) << k) + q
#pragma unroll
    for (int i = 1; i < (1 << DW); ++i) {
      const int k = ilog2(i), q = i - (1 << k);
      bool r[R];
      right(((W + w) << k) + q, r);
      const uint32_t m = in_word_mask(DW, k, q);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (r[j]) cur[j] &= m;  // a predicated AND, no branch
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const uint32_t surv = (dead[j] >> w) & 1u ? 0u : cur[j];
      leaf[j] = leaf[j] < 0 && surv != 0u ? w * 32 + __ffs(int(surv)) - 1
                                          : leaf[j];
    }
  }
}

// The staged mode: kRows rows a thread, blockDim.x apart, from the
// block's x tile; every thread walks every tree of the tile.
template <int DEPTH, bool FUSED, bool NARROW>
__global__ void __launch_bounds__(kMaxBlock, 2) quickscorer_kernel(
    const float* __restrict__ x,
    const typename Record<NARROW>::Node* __restrict__ nodes,
    const typename Record<NARROW>::Leaf* __restrict__ leaf_value,
    float* __restrict__ out, long long B, int F, int T, int bt) {
  using Node = typename Record<NARROW>::Node;
  using Leaf = typename Record<NARROW>::Leaf;
  constexpr int L = 1 << DEPTH;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bb = blockDim.x, b = threadIdx.x, rows = kRows * bb;
  const auto s = tile_refs<NARROW>(
      smem, tile_layout(rows, bt, F, L, tree_buffers(T, bt), 0,
                        FUSED ? 0 : rows, sizeof(Node)));
  const long long b0 = (long long)blockIdx.x * rows;
  const float* xb = s.x + b;  // row j of this thread: xb[f * rows + j * bb]

  stage_x_async(s.x, x, b0, B, F, rows);
  float acc[kRows] = {};
  run_tiles<FUSED, kRows>(
      s, nodes, leaf_value, out, b0, B, T, bt, L,
      [&](const Node* nd, const Leaf* lv) {
#pragma unroll 1
        for (int t = 0; t < bt; ++t) {
          const Node* tree = nd + t * L;
          int leaf[kRows];
          // right[j]: row j goes right at the node of heap slot ``slot``
          qs_exit_leaves<DEPTH, kRows>(
              [&](int slot, bool (&right)[kRows]) {
                const Node n = tree[slot];
                const float threshold = node_threshold(n);
                const bool nan_right = node_default_right(n);
                const float* xf = xb + node_offset(n, rows);
#pragma unroll
                for (int j = 0; j < kRows; ++j) {
                  right[j] = goes_right(xf[j * bb], threshold, nan_right);
                }
              },
              leaf);
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const float v = leaf_f32(lv[t * L + leaf[j]]);
            if constexpr (FUSED) {
              acc[j] += v;
            } else {
              s.out[(j * bb + b) * (bt + 1) + t] = v;
            }
          }
        }
      });
  if constexpr (FUSED) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long row = b0 + j * bb + b;
      if (row < B) out[row] = acc[j];
    }
  }
}

// The wide-tiled mode (forest_common.cuh) over feature-major x
// [F][wide_ldx(B)]: the block's 32 rows, one a lane of every warp; warp w
// scores trees w, w + W, ... of each tile (W warps), one at a time, into
// the out tile.
template <int DEPTH, bool FUSED, bool NARROW>
__global__ void __launch_bounds__(kMaxBlock, 2) quickscorer_wide_kernel(
    const float* __restrict__ x,
    const typename Record<NARROW>::Node* __restrict__ nodes,
    const typename Record<NARROW>::Leaf* __restrict__ leaf_value,
    float* __restrict__ out, long long B, int F, int T, int bt) {
  using Node = typename Record<NARROW>::Node;
  using Leaf = typename Record<NARROW>::Leaf;
  constexpr int L = 1 << DEPTH;
  extern __shared__ __align__(16) unsigned char smem[];
  const auto s = tile_refs<NARROW>(
      smem, tile_layout(kWideRows, bt, 0, L, tree_buffers(T, bt), 0,
                        kWideRows, sizeof(Node)));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const long long b0 = (long long)blockIdx.x * kWideRows;
  const unsigned ldx = unsigned(wide_ldx(B));  // launch_rows checks
  const float* xb = x + b0 + lane;
  float* out_row = s.out + lane * (bt + 1);

  run_wide_tiles<FUSED>(
      s, nodes, leaf_value, out, b0, B, T, bt, L,
      [&](const Node* nd, const Leaf* lv) {
        for (int t = warp; t < bt; t += nw) {
          const Node* tree = nd + t * L;
          int leaf[1];
          qs_exit_leaves<DEPTH, 1>(
              [&](int slot, bool (&right)[1]) {
                const Node n = tree[slot];
                right[0] = goes_right(col_at(xb, n, ldx),
                                      node_threshold(n),
                                      node_default_right(n));
              },
              leaf);
          out_row[t] = leaf_f32(lv[t * L + leaf[0]]);
        }
      });
}

template <int DEPTH, bool FUSED, bool STAGED, bool NARROW>
int launch_quickscorer(const float* x,
                       const typename Record<NARROW>::Node* nodes,
                       const typename Record<NARROW>::Leaf* leaf_value,
                       float* out, long long B, int F, int T, int block_b,
                       int block_t, cudaStream_t stream) {
  const int record = sizeof(typename Record<NARROW>::Node);
  if constexpr (STAGED) {
    const size_t smem =
        tile_layout(kRows * block_b, block_t, F, 1 << DEPTH,
                    tree_buffers(T, block_t), 0, FUSED ? 0 : kRows * block_b,
                    record)
            .total;
    return launch_kernel<kRows>(quickscorer_kernel<DEPTH, FUSED, NARROW>, B,
                                block_b, smem, stream, x, nodes, leaf_value,
                                out, B, F, T, block_t);
  } else {
    const size_t smem =
        tile_layout(kWideRows, block_t, 0, 1 << DEPTH,
                    tree_buffers(T, block_t), 0, kWideRows, record)
            .total;
    return launch_rows(quickscorer_wide_kernel<DEPTH, FUSED, NARROW>, B,
                       kWideRows, block_b, smem, stream, x, nodes,
                       leaf_value, out, B, F, T, block_t);
  }
}

}  // namespace forest

extern "C" int forest_quickscorer_fused(const float* x, const int2* nodes,
                                        const float* leaf_value, float* out,
                                        long long B, int F, int T, int depth,
                                        int block_b, int block_t,
                                        int x_staged, cudaStream_t stream) {
  FOREST_DISPATCH(depth, x_staged, forest::launch_quickscorer, true, false,
                  x, nodes, leaf_value, out, B, F, T, block_b, block_t,
                  stream)
}

// The fused kernel over bf16 tree tiles: 4-byte node records, bf16 leaves.
extern "C" int forest_quickscorer_fused_bf16(
    const float* x, const uint32_t* nodes, const uint16_t* leaf_value,
    float* out, long long B, int F, int T, int depth, int block_b,
    int block_t, int x_staged, cudaStream_t stream) {
  FOREST_DISPATCH(depth, x_staged, forest::launch_quickscorer, true, true,
                  x, nodes, leaf_value, out, B, F, T, block_b, block_t,
                  stream)
}

extern "C" int forest_quickscorer_raw(const float* x, const int2* nodes,
                                      const float* leaf_value, float* out,
                                      long long B, int F, int T, int depth,
                                      int block_b, int block_t,
                                      int x_staged, cudaStream_t stream) {
  FOREST_DISPATCH(depth, x_staged, forest::launch_quickscorer, false, false,
                  x, nodes, leaf_value, out, B, F, T, block_b, block_t,
                  stream)
}
