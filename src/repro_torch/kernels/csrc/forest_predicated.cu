// Predicated (branch-free) forest traversal, for sm_90a: fused (+ SUM) and
// raw ([B, T]) variants of one kernel.
//
// Replaces repro/kernels/forest_predicated.py:predicated_fused_kernel_call
// (the Pallas kernel at its pl.pallas_call, line 143) and
// predicated_kernel_call (line 110).  For every sample b and tree t, with
// the tree's node records in heap slots 1..I (forest_common.cuh):
//     idx = 1; `depth` times: idx <- 2 * idx + !go_left(x[b, feature], node)
//     score(b, t) = leaf_value[t, idx - L]
// fused: out[b] = sum_t score(b, t), trees added in order;
// raw:   out[b * T + t] = score(b, t).
//
// What bounds it on this card.  Raw: bytes -- the [B, T] write (4 bytes a
// pair, 704 MB at 11M rows x 16 trees) plus x read once per launch.
// Fused: neither HBM bytes nor arithmetic; the time goes to shared-memory
// traffic and latency: each (sample, tree) pair takes `depth` levels of a
// node-record load followed by a dependent x load.  Design:
//   * one 8-byte node record, so a level is two shared loads: the record,
//     then the x value it names;
//   * each thread walks kChains trees of the tile at once, so four
//     independent load chains hide each other's latency (a thread with one
//     chain waits on every load); the fused sum still adds tree 0, 1, 2, ...
//     in order, so kernel and plain version agree bit for bit;
//   * x staging with conflict-free stores, cp.async tree tiles, double
//     buffered when a launch has several tiles (forest_common.cuh);
//   * 256 threads a block, two blocks an SM (kernels/common.py budget).
// Wide rows (STAGED false), raw: each level's x load is a read-only global
// load of the thread's own row, 32 rows a warp on 32 lines; the four chains
// keep four of them in flight, and the block keeps 256 threads at any F.
// Wide rows, fused (``predicated_wide_kernel``): the wide-tiled layout
// (forest_common.cuh).  A block of 32 rows, its warps over trees, four
// chains a thread, two blocks an SM; at depth 8 and 2,000 features the
// resident blocks' rows take ~68 MB, where 256-row blocks held ~540 MB
// and fetched every tree's sectors from HBM again; feature-major x puts
// the lanes that share a node on one line (a level's warp load takes 4
// sectors at the root, at most 32 below level 3, where row-major rows
// took 32 at every level).  At these tiles the same kernel over row-major
// x, with no transpose, took 2.3x the time of the transpose and this
// kernel (chip_wide_probe.py: 10.43 against 4.45 ms at 100,352 x 2,000 on
// an H100; PERF.md section 6).
// bf16 tree tiles (NARROW, fused only): a level loads a 4-byte record and
// masks out its threshold; the exit leaf is a 2-byte load shifted to f32.
#include "forest_common.cuh"

namespace forest {

constexpr int kChains = 4;

template <int DEPTH, bool FUSED, bool STAGED, bool NARROW>
__global__ void __launch_bounds__(kMaxBlock, 2)
    predicated_kernel(const float* __restrict__ x,
                      const typename Record<NARROW>::Node* __restrict__ nodes,
                      const typename Record<NARROW>::Leaf* __restrict__
                          leaf_value,
                      float* __restrict__ out, long long B, int F, int T,
                      int bt) {
  using Node = typename Record<NARROW>::Node;
  using Leaf = typename Record<NARROW>::Leaf;
  constexpr int L = 1 << DEPTH;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bb = blockDim.x, b = threadIdx.x;
  const auto s = tile_refs<NARROW>(
      smem, tile_layout(bb, bt, STAGED ? F : 0, L, tree_buffers(T, bt), 0,
                        FUSED ? 0 : bb, sizeof(Node)));
  const long long b0 = (long long)blockIdx.x * bb;
  const float* xb = STAGED ? s.x + b : global_row(x, b0 + b, B, F);

  if constexpr (STAGED) stage_x_async(s.x, x, b0, B, F, bb);
  float acc = 0.f;
  run_tiles<FUSED>(
      s, nodes, leaf_value, out, b0, B, T, bt, L,
      [&](const Node* nd, const Leaf* lv) {
        for (int t = 0; t < bt; t += kChains) {
          const Node* tree[kChains];
          int idx[kChains];
#pragma unroll
          for (int c = 0; c < kChains; ++c) {
            tree[c] = nd + min(t + c, bt - 1) * L;  // past bt: discarded
            idx[c] = 1;
          }
#pragma unroll
          for (int d = 0; d < DEPTH; ++d) {
#pragma unroll
            for (int c = 0; c < kChains; ++c) {
              const Node n = tree[c][idx[c]];
              idx[c] = 2 * idx[c] +
                       int(!go_left(node_x<STAGED>(xb, n, bb), n));
            }
          }
#pragma unroll
          for (int c = 0; c < kChains; ++c) {
            if (t + c < bt) {
              const float v = leaf_f32(lv[(t + c) * L + idx[c] - L]);
              if constexpr (FUSED) {
                acc += v;
              } else {
                s.out[b * (bt + 1) + t + c] = v;
              }
            }
          }
        }
      });
  if constexpr (FUSED) {
    if (b0 + b < B) out[b0 + b] = acc;
  }
}

// The fused kernel's wide-tiled mode over feature-major x [F][wide_ldx(B)].
// Warp w walks trees w, w + W, ..., w + (kChains - 1) W of each group of
// kChains * W trees of the tile (W warps), so its chains are independent
// trees; chains past the tile load nothing.
template <int DEPTH, bool NARROW>
__global__ void __launch_bounds__(kMaxBlock, 2) predicated_wide_kernel(
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
  const long long ldx = wide_ldx(B);
  const float* xb = x + b0 + lane;
  float* out_row = s.out + lane * (bt + 1);

  run_wide_tiles<true>(
      s, nodes, leaf_value, out, b0, B, T, bt, L,
      [&](const Node* nd, const Leaf* lv) {
        for (int g = 0; g < bt; g += kChains * nw) {
          int idx[kChains], tree[kChains];
#pragma unroll
          for (int c = 0; c < kChains; ++c) {
            tree[c] = g + c * nw + warp;
            idx[c] = 1;
          }
#pragma unroll
          for (int d = 0; d < DEPTH; ++d) {
#pragma unroll
            for (int c = 0; c < kChains; ++c) {
              if (tree[c] < bt) {
                const Node n = nd[tree[c] * L + idx[c]];
                idx[c] = 2 * idx[c] + int(!go_left(col_at(xb, n, ldx), n));
              }
            }
          }
#pragma unroll
          for (int c = 0; c < kChains; ++c) {
            if (tree[c] < bt) {
              out_row[tree[c]] = leaf_f32(lv[tree[c] * L + idx[c] - L]);
            }
          }
        }
      });
}

template <int DEPTH, bool FUSED, bool STAGED, bool NARROW>
int launch_predicated(const float* x,
                      const typename Record<NARROW>::Node* nodes,
                      const typename Record<NARROW>::Leaf* leaf_value,
                      float* out, long long B, int F, int T, int block_b,
                      int block_t, cudaStream_t stream) {
  using Node = typename Record<NARROW>::Node;
  if constexpr (FUSED && !STAGED) {
    const size_t smem =
        tile_layout(kWideRows, block_t, 0, 1 << DEPTH,
                    tree_buffers(T, block_t), 0, kWideRows, sizeof(Node))
            .total;
    return launch_rows(predicated_wide_kernel<DEPTH, NARROW>, B, kWideRows,
                       block_b, smem, stream, x, nodes, leaf_value, out, B,
                       F, T, block_t);
  } else {
    const size_t smem =
        tile_layout(block_b, block_t, STAGED ? F : 0, 1 << DEPTH,
                    tree_buffers(T, block_t), 0, FUSED ? 0 : block_b,
                    sizeof(Node))
            .total;
    return launch_kernel(predicated_kernel<DEPTH, FUSED, STAGED, NARROW>, B,
                         block_b, smem, stream, x, nodes, leaf_value, out, B,
                         F, T, block_t);
  }
}

}  // namespace forest

extern "C" int forest_predicated_fused(const float* x, const int2* nodes,
                                       const float* leaf_value, float* out,
                                       long long B, int F, int T, int depth,
                                       int block_b, int block_t,
                                       int x_staged, cudaStream_t stream) {
  FOREST_DISPATCH(depth, x_staged, forest::launch_predicated, true, false, x,
                  nodes, leaf_value, out, B, F, T, block_b, block_t, stream)
}

// The fused kernel over bf16 tree tiles: 4-byte node records, bf16 leaves.
extern "C" int forest_predicated_fused_bf16(
    const float* x, const uint32_t* nodes, const uint16_t* leaf_value,
    float* out, long long B, int F, int T, int depth, int block_b,
    int block_t, int x_staged, cudaStream_t stream) {
  FOREST_DISPATCH(depth, x_staged, forest::launch_predicated, true, true, x,
                  nodes, leaf_value, out, B, F, T, block_b, block_t, stream)
}

extern "C" int forest_predicated_raw(const float* x, const int2* nodes,
                                     const float* leaf_value, float* out,
                                     long long B, int F, int T, int depth,
                                     int block_b, int block_t,
                                     int x_staged, cudaStream_t stream) {
  FOREST_DISPATCH(depth, x_staged, forest::launch_predicated, false, false,
                  x, nodes, leaf_value, out, B, F, T, block_b, block_t,
                  stream)
}
