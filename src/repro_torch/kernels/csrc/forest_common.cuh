// Shared pieces of the forest kernels (Hopper, sm_90a).
//
// Skeleton common to all six kernels: three algorithms, each FUSED (per
// sample sum of the trees' scores, [B]) or RAW (each tree's score written
// out, [B, T]).  On the TPU the tree axis was a sequential grid axis
// (repro/kernels/forest_*.py): the fused kernels revisited one [BB, 1]
// output block along it (``pl.when(program_id(1) == 0)`` init), the raw
// ones wrote one [BB, BT] block per grid step.  Here that axis becomes a
// loop INSIDE the block (``walk_tree_tiles``):
//   * a block owns BB samples, one thread per sample, and stages its x tile
//     in shared memory once, feature-major (x_s[f * BB + b]) so that a warp
//     reading 32 different features still hits 32 different banks;
//   * it walks every tree tile in order; each tile's feature, threshold,
//     default_left and leaf values are staged in shared memory by all
//     threads together;
//   * FUSED: each thread keeps its sample's sum in a register and writes
//     [B] once.  No atomics, and the summation order (tree 0, 1, 2, ... in
//     sequence) is fixed from run to run;
//   * RAW: each thread puts its tile scores in a shared [BB][BT + 1] out
//     tile (the +1 keeps a warp's column writes on 32 banks), and the block
//     then writes the tile's BB rows of BT floats with consecutive threads
//     on consecutive addresses.  Offsets into x and out are 64-bit: B * T
//     passes 2^31 at the paper's sizes.
// The per-(sample, tree) score is one function shared by both variants, so
// a raw score is exactly the term the fused kernel adds.
//
// Predicates are a direct gather x_s[feature[t, i]] from shared memory,
// ``isnan(v) ? default_left : v < threshold`` -- the reference's
// core/algorithms.py ``_go_left``.  Nothing rounds through a matrix unit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace forest {

constexpr int kMaxDepth = 8;

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Byte offsets of one block's shared memory, each 16-byte aligned:
//   x     float   [F][BB]  sample tile, feature-major
//   thr   float   [BT][I]
//   leaf  float   [BT][L]
//   feat  int32   [BT][I]
//   dl    uint8   [BT][I]
//   extra         kernel-specific structure tensors (shared by all trees)
//   out   float   [BB][BT + 1]  raw kernels only
// kernels/common.py:tile_smem_bytes mirrors this layout.
struct TileLayout {
  size_t x, thr, leaf, feat, dl, extra, out, total;
};

__host__ __device__ inline TileLayout tile_layout(int bb, int bt, int F,
                                                  int depth,
                                                  size_t extra_bytes,
                                                  bool fused) {
  const size_t I = (size_t(1) << depth) - 1, L = size_t(1) << depth;
  TileLayout s;
  s.x = 0;
  s.thr = s.x + align16(sizeof(float) * size_t(F) * bb);
  s.leaf = s.thr + align16(sizeof(float) * bt * I);
  s.feat = s.leaf + align16(sizeof(float) * bt * L);
  s.dl = s.feat + align16(sizeof(int32_t) * bt * I);
  s.extra = s.dl + align16(size_t(bt) * I);
  s.out = s.extra + align16(extra_bytes);
  s.total = s.out + (fused ? 0 : align16(sizeof(float) * bb * (bt + 1)));
  return s;
}

struct TileRefs {
  float* x;
  float* thr;
  float* leaf;
  int32_t* feat;
  uint8_t* dl;
  unsigned char* extra;
  float* out;
};

__device__ inline TileRefs tile_refs(unsigned char* smem,
                                     const TileLayout& lay) {
  return TileRefs{reinterpret_cast<float*>(smem + lay.x),
                  reinterpret_cast<float*>(smem + lay.thr),
                  reinterpret_cast<float*>(smem + lay.leaf),
                  reinterpret_cast<int32_t*>(smem + lay.feat),
                  smem + lay.dl, smem + lay.extra,
                  reinterpret_cast<float*>(smem + lay.out)};
}

// Rows past B read as 0 (the reference pads samples with zeros).
__device__ inline void stage_x(float* x_s, const float* __restrict__ x,
                               long long b0, long long B, int F, int bb) {
  for (int k = threadIdx.x; k < bb * F; k += blockDim.x) {
    const int b = k / F, f = k - b * F;
    const long long row = b0 + b;
    x_s[f * bb + b] = row < B ? x[row * F + f] : 0.f;
  }
}

__device__ inline void stage_trees(const TileRefs& s,
                                   const int32_t* __restrict__ feature,
                                   const float* __restrict__ threshold,
                                   const uint8_t* __restrict__ default_left,
                                   const float* __restrict__ leaf_value,
                                   int t0, int bt, int I, int L) {
  const size_t g0 = size_t(t0) * I;
  for (int k = threadIdx.x; k < bt * I; k += blockDim.x) {
    s.feat[k] = feature[g0 + k];
    s.thr[k] = threshold[g0 + k];
    s.dl[k] = default_left[g0 + k];
  }
  const size_t l0 = size_t(t0) * L;
  for (int k = threadIdx.x; k < bt * L; k += blockDim.x) {
    s.leaf[k] = leaf_value[l0 + k];
  }
}

// True = left child.  +-inf compares like any other number.
__device__ inline bool go_left(float v, float thr, uint8_t dl) {
  return isnan(v) ? dl != 0 : v < thr;
}

// The tree loop of every kernel.  ``score(t)`` is this thread's sample's
// score for tree t of the staged tile.  FUSED: out[b] = sum over all trees
// in order.  RAW: out[b * T + t] = each tree's score.  x must be staged.
template <bool FUSED, typename Score>
__device__ inline void walk_tree_tiles(
    const TileRefs& s, const int32_t* __restrict__ feature,
    const float* __restrict__ threshold,
    const uint8_t* __restrict__ default_left,
    const float* __restrict__ leaf_value, float* __restrict__ out,
    long long b0, long long B, int T, int bt, int I, int L, Score score) {
  const int b = threadIdx.x, bb = blockDim.x;
  float acc = 0.f;
  for (int t0 = 0; t0 < T; t0 += bt) {
    __syncthreads();  // x staged / previous tile consumed and written out
    stage_trees(s, feature, threshold, default_left, leaf_value, t0, bt, I,
                L);
    __syncthreads();
    for (int t = 0; t < bt; ++t) {
      const float v = score(t);
      if constexpr (FUSED) {
        acc += v;
      } else {
        s.out[b * (bt + 1) + t] = v;
      }
    }
    if constexpr (!FUSED) {
      __syncthreads();
      for (int k = threadIdx.x; k < bb * bt; k += bb) {
        const int r = k / bt, c = k - r * bt;
        const long long row = b0 + r;
        if (row < B) out[row * T + t0 + c] = s.out[r * (bt + 1) + c];
      }
    }
  }
  if constexpr (FUSED) {
    if (b0 + b < B) out[b0 + b] = acc;
  }
}

// Ask for the dynamic shared memory, launch, and report the launch error.
template <typename Kernel, typename... Args>
inline int launch_kernel(Kernel kernel, long long B, int block_b,
                         size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const unsigned grid = unsigned((B + block_b - 1) / block_b);
  kernel<<<grid, block_b, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace forest

// FN<depth, FUSED>(...) for a depth known only at run time.
#define FOREST_DISPATCH_DEPTH(depth, FN, FUSED, ...)   \
  switch (depth) {                                     \
    case 1: return FN<1, FUSED>(__VA_ARGS__);          \
    case 2: return FN<2, FUSED>(__VA_ARGS__);          \
    case 3: return FN<3, FUSED>(__VA_ARGS__);          \
    case 4: return FN<4, FUSED>(__VA_ARGS__);          \
    case 5: return FN<5, FUSED>(__VA_ARGS__);          \
    case 6: return FN<6, FUSED>(__VA_ARGS__);          \
    case 7: return FN<7, FUSED>(__VA_ARGS__);          \
    case 8: return FN<8, FUSED>(__VA_ARGS__);          \
    default: return int(cudaErrorInvalidValue);       \
  }

extern "C" const char* forest_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}
