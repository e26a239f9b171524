// QuickScorer (bit-vector) forest inference, for sm_90a: fused (+ SUM) and
// raw ([B, T]) variants of one kernel.
//
// Replaces repro/kernels/forest_quickscorer.py:quickscorer_fused_kernel_call
// (the Pallas kernel at its pl.pallas_call, line 172) and
// quickscorer_kernel_call (line 142).  Per (sample, tree):
//     surv[w] = AND over FALSE nodes i (sample goes right) of bv[i, w]
//     leaf    = lowest set bit of surv, words taken in order, LSB first
//     score   = leaf_value[t, leaf]
// fused: out[b] += score over the trees in order; raw: out[b * T + t].
// bv [I, W] uint32, W = ceil(L/32), is structure-only (one per depth).
// Below depth 5 the bits past L are phantoms that are never cleared; the
// real exit leaf always survives and is lower, so the lowest bit is right.
//
// What bounds it on this card: operations.  Every node predicate is
// evaluated (I shared-memory gathers per pair) and each selects a W-word
// mask (I * W ANDs per pair); bytes (x read once, [B] or [B, T] written
// once) are small beside that.  Design: surv lives in W registers, the
// node's record and mask are broadcast shared-memory reads (every thread
// of a warp is at the same node), the select is branch-free, and __ffs
// finds the lowest bit in one instruction per word.  Node records, x
// staging and tree tiles are the shared ones of forest_common.cuh.
#include "forest_common.cuh"

namespace forest {

template <int DEPTH, bool FUSED>
__global__ void __launch_bounds__(kMaxBlock, 2) quickscorer_kernel(
    const float* __restrict__ x, const int2* __restrict__ nodes,
    const float* __restrict__ leaf_value, const uint32_t* __restrict__ bv,
    float* __restrict__ out, long long B, int F, int T, int bt) {
  constexpr int I = (1 << DEPTH) - 1, L = 1 << DEPTH;
  constexpr int W = (L + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bb = blockDim.x, b = threadIdx.x;
  const TileRefs s =
      tile_refs(smem, tile_layout(bb, bt, F, L, tree_buffers(T, bt),
                                  sizeof(uint32_t) * I * W, FUSED));
  uint32_t* bv_s = reinterpret_cast<uint32_t*>(s.extra);
  const long long b0 = (long long)blockIdx.x * bb;
  const float* xb = s.x + b;

  for (int k = threadIdx.x; k < I * W; k += blockDim.x) {
    cp_async4(bv_s + k, bv + k, true);
  }
  stage_x_async(s.x, x, b0, B, F, bb);
  float acc = 0.f;
  run_tiles<FUSED>(
      s, nodes, leaf_value, out, b0, B, T, bt, L,
      [&](const int2* nd, const float* lv) {
        for (int t = 0; t < bt; ++t) {
          const int2* tree = nd + t * L;
          uint32_t surv[W];
#pragma unroll
          for (int w = 0; w < W; ++w) surv[w] = 0xFFFFFFFFu;
          for (int i = 0; i < I; ++i) {
            const int2 n = tree[i + 1];
            // all-ones for a TRUE node, the node's bit-vector for a FALSE one
            const uint32_t keep =
                go_left(xb[(n.y >> 1) * bb], n) ? 0xFFFFFFFFu : 0u;
#pragma unroll
            for (int w = 0; w < W; ++w) surv[w] &= bv_s[i * W + w] | keep;
          }
          int leaf = 0;
          bool found = false;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            if (!found && surv[w] != 0u) {
              leaf = w * 32 + __ffs(int(surv[w])) - 1;
              found = true;
            }
          }
          const float v = lv[t * L + leaf];
          if constexpr (FUSED) {
            acc += v;
          } else {
            s.out[b * (bt + 1) + t] = v;
          }
        }
      });
  if constexpr (FUSED) {
    if (b0 + b < B) out[b0 + b] = acc;
  }
}

template <int DEPTH, bool FUSED>
int launch_quickscorer(const float* x, const int2* nodes,
                       const float* leaf_value, const uint32_t* bv,
                       float* out, long long B, int F, int T, int block_b,
                       int block_t, cudaStream_t stream) {
  constexpr int I = (1 << DEPTH) - 1, L = 1 << DEPTH;
  constexpr int W = (L + 31) / 32;
  const size_t smem = tile_layout(block_b, block_t, F, L,
                                  tree_buffers(T, block_t),
                                  sizeof(uint32_t) * I * W, FUSED)
                          .total;
  return launch_kernel(quickscorer_kernel<DEPTH, FUSED>, B, block_b, smem,
                       stream, x, nodes, leaf_value, bv, out, B, F, T,
                       block_t);
}

}  // namespace forest

extern "C" int forest_quickscorer_fused(
    const float* x, const int2* nodes, const float* leaf_value,
    const uint32_t* bv, float* out, long long B, int F, int T, int depth,
    int block_b, int block_t, cudaStream_t stream) {
  FOREST_DISPATCH_DEPTH(depth, forest::launch_quickscorer, true, x, nodes,
                        leaf_value, bv, out, B, F, T, block_b, block_t,
                        stream)
}

extern "C" int forest_quickscorer_raw(
    const float* x, const int2* nodes, const float* leaf_value,
    const uint32_t* bv, float* out, long long B, int F, int T, int depth,
    int block_b, int block_t, cudaStream_t stream) {
  FOREST_DISPATCH_DEPTH(depth, forest::launch_quickscorer, false, x, nodes,
                        leaf_value, bv, out, B, F, T, block_b, block_t,
                        stream)
}
