// Predicated (branch-free) forest traversal, for sm_90a: fused (+ SUM) and
// raw ([B, T]) variants of one kernel.
//
// Replaces repro/kernels/forest_predicated.py:predicated_fused_kernel_call
// (the Pallas kernel at its pl.pallas_call, line 143) and
// predicated_kernel_call (line 110).  For every sample b and tree t
//     score(b, t) = leaf_value[t, idx - I] after `depth` steps of
//                   idx <- 2*idx + 1 + (1 - go_left(x[b, feature[t, idx]]))
// fused: out[b] = sum_t score(b, t), trees added in order;
// raw:   out[b * T + t] = score(b, t).
//
// What bounds it on this card.  Fused: not bytes.  Each (sample, tree)
// pair takes `depth` dependent shared-memory gathers (node record, then
// the sample's feature), so the kernel is bound by shared-memory load
// latency and throughput; the HBM traffic (x read once, [B] written once)
// is far below the card's 3.35 TB/s.  Raw: the [B, T] write (4 bytes per
// pair, 704 MB for 11M rows x 16 trees) puts the bound on bytes, but the
// gathers still set the time.  Design: one thread per sample; the x tile
// is feature-major so the feature gather is bank-conflict free whatever
// features a warp asks for; tree tiles are staged by the whole block and
// reused by all BB samples; the raw out tile leaves through shared memory
// in coalesced rows.  The node-record gathers at divergent idx still
// conflict; packing a node into one 8-byte record is a later change.
#include "forest_common.cuh"

namespace forest {

template <int DEPTH, bool FUSED>
__global__ void predicated_kernel(const float* __restrict__ x,
                                  const int32_t* __restrict__ feature,
                                  const float* __restrict__ threshold,
                                  const uint8_t* __restrict__ default_left,
                                  const float* __restrict__ leaf_value,
                                  float* __restrict__ out, long long B,
                                  int F, int T, int bt) {
  constexpr int I = (1 << DEPTH) - 1, L = 1 << DEPTH;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bb = blockDim.x;
  const TileRefs s =
      tile_refs(smem, tile_layout(bb, bt, F, DEPTH, 0, FUSED));
  const long long b0 = (long long)blockIdx.x * bb;
  const int b = threadIdx.x;

  stage_x(s.x, x, b0, B, F, bb);
  walk_tree_tiles<FUSED>(
      s, feature, threshold, default_left, leaf_value, out, b0, B, T, bt, I,
      L, [&](int t) {
        const int base = t * I;
        int idx = 0;
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
          const int n = base + idx;
          const float v = s.x[s.feat[n] * bb + b];
          idx = 2 * idx + 2 - int(go_left(v, s.thr[n], s.dl[n]));
        }
        return s.leaf[t * L + idx - I];
      });
}

template <int DEPTH, bool FUSED>
int launch_predicated(const float* x, const int32_t* feature,
                      const float* threshold, const uint8_t* default_left,
                      const float* leaf_value, float* out, long long B,
                      int F, int T, int block_b, int block_t,
                      cudaStream_t stream) {
  const size_t smem =
      tile_layout(block_b, block_t, F, DEPTH, 0, FUSED).total;
  return launch_kernel(predicated_kernel<DEPTH, FUSED>, B, block_b, smem,
                       stream, x, feature, threshold, default_left,
                       leaf_value, out, B, F, T, block_t);
}

}  // namespace forest

extern "C" int forest_predicated_fused(
    const float* x, const int32_t* feature, const float* threshold,
    const uint8_t* default_left, const float* leaf_value, float* out,
    long long B, int F, int T, int depth, int block_b, int block_t,
    cudaStream_t stream) {
  FOREST_DISPATCH_DEPTH(depth, forest::launch_predicated, true, x, feature,
                        threshold, default_left, leaf_value, out, B, F, T,
                        block_b, block_t, stream)
}

extern "C" int forest_predicated_raw(
    const float* x, const int32_t* feature, const float* threshold,
    const uint8_t* default_left, const float* leaf_value, float* out,
    long long B, int F, int T, int depth, int block_b, int block_t,
    cudaStream_t stream) {
  FOREST_DISPATCH_DEPTH(depth, forest::launch_predicated, false, x, feature,
                        threshold, default_left, leaf_value, out, B, F, T,
                        block_b, block_t, stream)
}
