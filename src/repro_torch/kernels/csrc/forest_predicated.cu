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
// Wide rows (STAGED false): each level's x load is a read-only global load
// of the thread's own row, 32 rows a warp on 32 lines; the four chains
// keep four of them in flight, and the block keeps 256 threads at any F.
#include "forest_common.cuh"

namespace forest {

constexpr int kChains = 4;

template <int DEPTH, bool FUSED, bool STAGED>
__global__ void __launch_bounds__(kMaxBlock, 2)
    predicated_kernel(const float* __restrict__ x,
                      const int2* __restrict__ nodes,
                      const float* __restrict__ leaf_value,
                      float* __restrict__ out, long long B, int F, int T,
                      int bt) {
  constexpr int L = 1 << DEPTH;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bb = blockDim.x, b = threadIdx.x;
  const TileRefs s = tile_refs(
      smem, tile_layout(bb, bt, STAGED ? F : 0, L, tree_buffers(T, bt), 0,
                        FUSED));
  const long long b0 = (long long)blockIdx.x * bb;
  const float* xb = STAGED ? s.x + b : global_row(x, b0 + b, B, F);

  if constexpr (STAGED) stage_x_async(s.x, x, b0, B, F, bb);
  float acc = 0.f;
  run_tiles<FUSED>(
      s, nodes, leaf_value, out, b0, B, T, bt, L,
      [&](const int2* nd, const float* lv) {
        for (int t = 0; t < bt; t += kChains) {
          const int2* tree[kChains];
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
              const int2 n = tree[c][idx[c]];
              idx[c] = 2 * idx[c] +
                       int(!go_left(x_at<STAGED>(xb, n.y >> 1, bb), n));
            }
          }
#pragma unroll
          for (int c = 0; c < kChains; ++c) {
            if (t + c < bt) {
              const float v = lv[(t + c) * L + idx[c] - L];
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

template <int DEPTH, bool FUSED, bool STAGED>
int launch_predicated(const float* x, const int2* nodes,
                      const float* leaf_value, float* out, long long B,
                      int F, int T, int block_b, int block_t,
                      cudaStream_t stream) {
  const size_t smem = tile_layout(block_b, block_t, STAGED ? F : 0,
                                  1 << DEPTH, tree_buffers(T, block_t), 0,
                                  FUSED)
                          .total;
  return launch_kernel(predicated_kernel<DEPTH, FUSED, STAGED>, B, block_b,
                       smem, stream, x, nodes, leaf_value, out, B, F, T,
                       block_t);
}

}  // namespace forest

extern "C" int forest_predicated_fused(const float* x, const int2* nodes,
                                       const float* leaf_value, float* out,
                                       long long B, int F, int T, int depth,
                                       int block_b, int block_t,
                                       int x_staged, cudaStream_t stream) {
  FOREST_DISPATCH(depth, x_staged, forest::launch_predicated, true, x, nodes,
                  leaf_value, out, B, F, T, block_b, block_t, stream)
}

extern "C" int forest_predicated_raw(const float* x, const int2* nodes,
                                     const float* leaf_value, float* out,
                                     long long B, int F, int T, int depth,
                                     int block_b, int block_t,
                                     int x_staged, cudaStream_t stream) {
  FOREST_DISPATCH(depth, x_staged, forest::launch_predicated, false, x,
                  nodes, leaf_value, out, B, F, T, block_b, block_t, stream)
}
