// HummingBird (GEMM formulation) forest inference, for sm_90a: fused
// (+ SUM) and raw ([B, T]) variants of one kernel.
//
// Replaces repro/kernels/forest_hummingbird.py:hummingbird_fused_kernel_call
// (the Pallas kernel at its pl.pallas_call, line 139) and
// hummingbird_kernel_call (line 115).  Per (sample, tree):
//     S[i]   = go_left(node i)                    i in [0, I)
//     P[l]   = sum_i S[i] * C[i, l]               C in {-1, 0, +1}, [I, L]
//     score  = sum_l (P[l] == D[l]) * leaf_value[t, l]
// fused: out[b] += score over the trees in order; raw: out[b * T + t].
// C and D are structure-only (one per depth, shared by every tree).
//
// Arithmetic of the S.C contraction: popcounts over bit-packed operands.
// S is packed into IW = ceil(I/32) 32-bit words; column l of C is split
// into its +1 mask Cpos[l] and -1 mask Cneg[l] (each IW words), so
//     P[l] = popc(S & Cpos[l]) - popc(S & Cneg[l])
// summed over all IW words -- the full contraction over the node axis, in
// exact integer arithmetic, so P == D is an exact equality as it must be.
//
// What bounds it on this card: integer operations.  The contraction costs
// 2 * L * IW AND+POPC pairs per (sample, tree) -- 4096 popcounts at depth
// 8 -- against 255 predicate gathers, and __popc issues at a quarter of
// the integer rate.  Bytes (x read once, [B] or [B, T] written once) are
// small beside that.  Design: the masks and D live in shared memory and
// are read as broadcasts (every thread of a warp reads the same leaf's
// masks); S stays in registers (IW words); the fused variant carries its
// sample's sum in a register, the raw one writes through the out tile.
#include "forest_common.cuh"

namespace forest {

template <int DEPTH>
__host__ __device__ constexpr size_t hb_extra_bytes() {
  constexpr int L = 1 << DEPTH, IW = ((1 << DEPTH) - 1 + 31) / 32;
  return sizeof(uint32_t) * 2 * L * IW + sizeof(int32_t) * L;
}

template <int DEPTH, bool FUSED>
__global__ void hummingbird_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ feature,
    const float* __restrict__ threshold,
    const uint8_t* __restrict__ default_left,
    const float* __restrict__ leaf_value, const uint32_t* __restrict__ cpos,
    const uint32_t* __restrict__ cneg, const int32_t* __restrict__ dcount,
    float* __restrict__ out, long long B, int F, int T, int bt) {
  constexpr int I = (1 << DEPTH) - 1, L = 1 << DEPTH;
  constexpr int IW = (I + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bb = blockDim.x;
  const TileRefs s = tile_refs(
      smem, tile_layout(bb, bt, F, DEPTH, hb_extra_bytes<DEPTH>(), FUSED));
  uint32_t* cpos_s = reinterpret_cast<uint32_t*>(s.extra);
  uint32_t* cneg_s = cpos_s + L * IW;
  int32_t* d_s = reinterpret_cast<int32_t*>(cneg_s + L * IW);
  const long long b0 = (long long)blockIdx.x * bb;
  const int b = threadIdx.x;

  for (int k = threadIdx.x; k < L * IW; k += blockDim.x) {
    cpos_s[k] = cpos[k];
    cneg_s[k] = cneg[k];
  }
  for (int k = threadIdx.x; k < L; k += blockDim.x) d_s[k] = dcount[k];
  stage_x(s.x, x, b0, B, F, bb);

  walk_tree_tiles<FUSED>(
      s, feature, threshold, default_left, leaf_value, out, b0, B, T, bt, I,
      L, [&](int t) {
        const int base = t * I;
        uint32_t sw[IW];  // S, bit i%32 of word i/32
#pragma unroll
        for (int w = 0; w < IW; ++w) {
          uint32_t bits = 0;
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const int i = w * 32 + k;
            if (i < I) {
              const int n = base + i;
              const float v = s.x[s.feat[n] * bb + b];
              bits |= uint32_t(go_left(v, s.thr[n], s.dl[n])) << k;
            }
          }
          sw[w] = bits;
        }
        float tree = 0.f;  // leaf contraction: exactly one l matches
        const float* leaves = s.leaf + t * L;
        for (int l = 0; l < L; ++l) {
          int p = 0;
#pragma unroll
          for (int w = 0; w < IW; ++w) {
            p += __popc(sw[w] & cpos_s[l * IW + w]) -
                 __popc(sw[w] & cneg_s[l * IW + w]);
          }
          tree += p == d_s[l] ? leaves[l] : 0.f;
        }
        return tree;
      });
}

template <int DEPTH, bool FUSED>
int launch_hummingbird(const float* x, const int32_t* feature,
                       const float* threshold, const uint8_t* default_left,
                       const float* leaf_value, const uint32_t* cpos,
                       const uint32_t* cneg, const int32_t* dcount,
                       float* out, long long B, int F, int T, int block_b,
                       int block_t, cudaStream_t stream) {
  const size_t smem = tile_layout(block_b, block_t, F, DEPTH,
                                  hb_extra_bytes<DEPTH>(), FUSED)
                          .total;
  return launch_kernel(hummingbird_kernel<DEPTH, FUSED>, B, block_b, smem,
                       stream, x, feature, threshold, default_left,
                       leaf_value, cpos, cneg, dcount, out, B, F, T,
                       block_t);
}

}  // namespace forest

extern "C" int forest_hummingbird_fused(
    const float* x, const int32_t* feature, const float* threshold,
    const uint8_t* default_left, const float* leaf_value,
    const uint32_t* cpos, const uint32_t* cneg, const int32_t* dcount,
    float* out, long long B, int F, int T, int depth, int block_b,
    int block_t, cudaStream_t stream) {
  FOREST_DISPATCH_DEPTH(depth, forest::launch_hummingbird, true, x, feature,
                        threshold, default_left, leaf_value, cpos, cneg,
                        dcount, out, B, F, T, block_b, block_t, stream)
}

extern "C" int forest_hummingbird_raw(
    const float* x, const int32_t* feature, const float* threshold,
    const uint8_t* default_left, const float* leaf_value,
    const uint32_t* cpos, const uint32_t* cneg, const int32_t* dcount,
    float* out, long long B, int F, int T, int depth, int block_b,
    int block_t, cudaStream_t stream) {
  FOREST_DISPATCH_DEPTH(depth, forest::launch_hummingbird, false, x,
                        feature, threshold, default_left, leaf_value, cpos,
                        cneg, dcount, out, B, F, T, block_b, block_t, stream)
}
