// Shared pieces of the forest kernels (Hopper, sm_90a).
//
// Skeleton common to all six kernels: three algorithms, each FUSED (per
// sample sum of the trees' scores, [B]) or RAW (each tree's score written
// out, [B, T]).  On the TPU the tree axis was a sequential grid axis
// (repro/kernels/forest_*.py): the fused kernels revisited one [BB, 1]
// output block along it (``pl.when(program_id(1) == 0)`` init), the raw
// ones wrote one [BB, BT] block per grid step.  Here that axis becomes a
// loop INSIDE the block (``run_tiles``):
//   * a block owns its samples (BB, one a thread; QuickScorer kRows a
//     thread) and, in the STAGED mode, stages their x tile in shared
//     memory once, feature-major (x_s[f * rows + b]) so that a warp
//     reading 32 different features at its 32 rows hits 32 different
//     banks.  The staging copy runs with lanes over b fastest, so its
//     shared-memory stores are conflict-free too (a store order of lanes
//     over f put a warp's 32 stores on 2-3 banks); its strided global
//     reads hit the x rows' lines in L1 once fetched;
//   * in the WIDE-ROW mode (STAGED false, kernels/common.py:x_staged) x is
//     not staged: each thread reads its row's features from row-major
//     global x through the read-only path (``x_at``), with 64-bit offsets.
//     Shared memory then holds only the tree tiles, the kernel's extra and
//     the raw out tile, so the block is sized as at a narrow F whatever F
//     is.  Every kernel is instantiated for both modes; the STAGED one is
//     the code of the narrow path;
//   * trees arrive as one 8-byte record per node (``kernels/ops.py:
//     pack_nodes``): {threshold bits, feature << 1 | default_left}, heap
//     slots 1..I of a [T][L] array (slot 0 unused, so a tree's records
//     start 16-byte aligned and the descent is idx <- 2 * idx + right from
//     idx = 1, leaf = idx - L).  A level is one LDS.64 and one x load;
//   * tree tiles (records [BT][L] int2 + leaves [BT][L] f32) are copied by
//     cp.async.  A launch over more than one tile double-buffers them:
//     tile j + 1 is in flight while tile j is walked, one barrier per tile.
//     A launch over one tile (a rel partition) has nothing to pipeline
//     across tiles: there the tile's copy and the x tile's are in flight
//     together, and the second block on the SM walks while one stages;
//   * FUSED: each thread keeps its samples' sums in registers and writes
//     [B] once.  No atomics, and the summation order (tree 0, 1, 2, ... in
//     sequence) is fixed from run to run;
//   * RAW: tree scores go to a shared [rows][BT + 1] out tile (the +1
//     keeps a warp's column writes on 32 banks), and the block then writes
//     the tile's rows of BT floats with consecutive threads on consecutive
//     addresses.  Offsets into x and out are 64-bit: B * T passes 2^31 at
//     the paper's sizes.  Rows past B are staged as zeros (wide-row mode:
//     read as row B - 1) and never written, so B need not be a multiple
//     of BB.
// Predicates are ``isnan(v) ? default_left : v < threshold`` -- the
// reference's core/algorithms.py ``_go_left``.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace forest {

constexpr int kMaxBlock = 256;

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Tree tiles in shared memory: two when the launch walks several tiles.
__host__ __device__ inline int tree_buffers(int T, int bt) {
  return T > bt ? 2 : 1;
}

// Byte offsets of one block's shared memory, each 16-byte aligned:
//   x      float  [F][rows]     sample tile, feature-major (the wide-row
//                               mode passes F = 0: no x tile)
//   per tree buffer (1 or 2):
//     nodes  int2   [BT][L]     packed node records
//     leaf   float  [BT][L]
//   extra                       kernel-specific (structure tensors, ...)
//   out    float  [rows][BT+1]  raw kernels only
// kernels/common.py:tile_smem_bytes mirrors this layout.
struct TileLayout {
  size_t x, nodes[2], leaf[2], extra, out, total;
};

__host__ __device__ inline TileLayout tile_layout(int rows, int bt, int F,
                                                  int L, int buffers,
                                                  size_t extra_bytes,
                                                  bool fused) {
  const size_t node_bytes = align16(8 * size_t(bt) * L);
  const size_t leaf_bytes = align16(4 * size_t(bt) * L);
  TileLayout s;
  s.x = 0;
  size_t at = align16(sizeof(float) * size_t(F) * rows);
  for (int k = 0; k < 2; ++k) {
    if (k < buffers) {
      s.nodes[k] = at;
      s.leaf[k] = at + node_bytes;
      at += node_bytes + leaf_bytes;
    } else {
      s.nodes[k] = s.nodes[0];
      s.leaf[k] = s.leaf[0];
    }
  }
  s.extra = at;
  s.out = s.extra + align16(extra_bytes);
  s.total = s.out + (fused ? 0 : align16(sizeof(float) * rows * (bt + 1)));
  return s;
}

struct TileRefs {
  float* x;
  int2* nodes[2];
  float* leaf[2];
  unsigned char* extra;
  float* out;
};

__device__ inline TileRefs tile_refs(unsigned char* smem,
                                     const TileLayout& lay) {
  return TileRefs{
      reinterpret_cast<float*>(smem + lay.x),
      {reinterpret_cast<int2*>(smem + lay.nodes[0]),
       reinterpret_cast<int2*>(smem + lay.nodes[1])},
      {reinterpret_cast<float*>(smem + lay.leaf[0]),
       reinterpret_cast<float*>(smem + lay.leaf[1])},
      smem + lay.extra,
      reinterpret_cast<float*>(smem + lay.out)};
}

// ---- asynchronous copies global -> shared (cp.async, sm_80+) -------------

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes; ``valid`` false writes zeros and reads nothing.
__device__ inline void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The whole block copies ``bytes`` (a multiple of 4): 16-byte pieces when
// both ends and the size allow, else 4-byte ones.
__device__ inline void copy_async(void* dst, const void* src, size_t bytes) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  if (((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(s) |
        bytes) & 15) == 0) {
    for (size_t k = size_t(threadIdx.x) * 16; k < bytes;
         k += size_t(blockDim.x) * 16) {
      cp_async16(d + k, s + k);
    }
  } else {
    for (size_t k = size_t(threadIdx.x) * 4; k < bytes;
         k += size_t(blockDim.x) * 4) {
      cp_async4(d + k, s + k, true);
    }
  }
}

// x_s[f * rows + b] = x[b0 + b, f] for the block's rows, lanes over b
// (conflict-free stores); rows past B read as 0 (the reference pads
// samples with zeros).
__device__ inline void stage_x_async(float* x_s, const float* __restrict__ x,
                                     long long b0, long long B, int F,
                                     int rows) {
  for (int k = threadIdx.x; k < rows * F; k += blockDim.x) {
    const int f = k / rows, b = k - f * rows;
    const long long row = b0 + b;
    const bool in = row < B;
    cp_async4(x_s + k, x + (in ? row * F + f : 0), in);
  }
}

// The wide-row mode's row of a thread: row-major global x, 64-bit
// offsets; a row past B reads row B - 1 (its result is never written).
__device__ inline const float* global_row(const float* __restrict__ x,
                                          long long row, long long B,
                                          int F) {
  return x + (row < B ? row : B - 1) * (long long)F;
}

// Feature f of a thread's row: ``xb`` is its column of the staged tile
// (stride = the tile's rows) or, not STAGED, its global row, read through
// the read-only path (ld.global.nc).
template <bool STAGED>
__device__ inline float x_at(const float* __restrict__ xb, int f,
                             int stride) {
  if constexpr (STAGED) {
    return xb[f * stride];
  } else {
    return __ldg(xb + f);
  }
}

__device__ inline void stage_tree_tile(const TileRefs& s, int buf,
                                       const int2* __restrict__ nodes,
                                       const float* __restrict__ leaf_value,
                                       int t0, int bt, int L) {
  const size_t n = size_t(bt) * L, g0 = size_t(t0) * L;
  // selected, not indexed: a run-time index into s puts s in local memory
  copy_async(buf ? s.nodes[1] : s.nodes[0], nodes + g0, 8 * n);
  copy_async(buf ? s.leaf[1] : s.leaf[0], leaf_value + g0, 4 * n);
}

// True = left child.  +-inf compares like any other number.
__device__ inline bool go_left(float v, int2 node) {
  return isnan(v) ? (node.y & 1) != 0 : v < __int_as_float(node.x);
}

// The tree loop of every kernel.  Issues tile 0 (after whatever the caller
// already issued: x, structure tensors) and walks all T / bt tiles in
// order.  ``walk(nodes_s, leaf_s)`` scores one staged tile: FUSED
// kernels add into their own registers, RAW ones fill s.out[r * (bt + 1) +
// t] for the block's rows = ROWS_PER_THREAD * blockDim.x samples r, which
// this loop then writes to out[(b0 + r) * T + t0 + t].
template <bool FUSED, int ROWS_PER_THREAD = 1, typename Walk>
__device__ inline void run_tiles(const TileRefs& s,
                                 const int2* __restrict__ nodes,
                                 const float* __restrict__ leaf_value,
                                 float* __restrict__ out, long long b0,
                                 long long B, int T, int bt, int L,
                                 Walk walk) {
  const int n_tiles = T / bt, nbuf = tree_buffers(T, bt);
  const int bb = blockDim.x, rows = ROWS_PER_THREAD * bb;
  stage_tree_tile(s, 0, nodes, leaf_value, 0, bt, L);
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j % nbuf;
    cp_async_wait_all();
    // tile j (and x) landed; every thread is done with tile j - 1 and the
    // out tile, so buffer (j + 1) % 2 and s.out are free
    __syncthreads();
    if (nbuf == 2 && j + 1 < n_tiles) {
      stage_tree_tile(s, (j + 1) & 1, nodes, leaf_value, (j + 1) * bt, bt,
                      L);
      cp_async_commit();
    }
    walk(buf ? s.nodes[1] : s.nodes[0], buf ? s.leaf[1] : s.leaf[0]);
    if constexpr (!FUSED) {
      __syncthreads();
      const long long t0 = (long long)j * bt;
      for (int k = threadIdx.x; k < rows * bt; k += bb) {
        const int r = k / bt, c = k - r * bt;
        const long long row = b0 + r;
        if (row < B) out[row * T + t0 + c] = s.out[r * (bt + 1) + c];
      }
    }
    if (nbuf == 1 && j + 1 < n_tiles) {
      __syncthreads();
      stage_tree_tile(s, 0, nodes, leaf_value, (j + 1) * bt, bt, L);
      cp_async_commit();
    }
  }
}

// Ask for the dynamic shared memory, launch block_b threads a block, one
// block per ROWS_PER_THREAD * block_b samples, and report the launch error.
template <int ROWS_PER_THREAD = 1, typename Kernel, typename... Args>
inline int launch_kernel(Kernel kernel, long long B, int block_b,
                         size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long rows = (long long)ROWS_PER_THREAD * block_b;
  const unsigned grid = unsigned((B + rows - 1) / rows);
  kernel<<<grid, block_b, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace forest

// FN<depth, FUSED, STAGED>(...) for a depth known only at run time.
#define FOREST_DISPATCH_DEPTH(depth, FN, FUSED, STAGED, ...) \
  switch (depth) {                                            \
    case 1: return FN<1, FUSED, STAGED>(__VA_ARGS__);         \
    case 2: return FN<2, FUSED, STAGED>(__VA_ARGS__);         \
    case 3: return FN<3, FUSED, STAGED>(__VA_ARGS__);         \
    case 4: return FN<4, FUSED, STAGED>(__VA_ARGS__);         \
    case 5: return FN<5, FUSED, STAGED>(__VA_ARGS__);         \
    case 6: return FN<6, FUSED, STAGED>(__VA_ARGS__);         \
    case 7: return FN<7, FUSED, STAGED>(__VA_ARGS__);         \
    case 8: return FN<8, FUSED, STAGED>(__VA_ARGS__);         \
    default: return int(cudaErrorInvalidValue);               \
  }

// ... and for the x mode, a launch argument (nonzero = staged).
#define FOREST_DISPATCH(depth, staged, FN, FUSED, ...)              \
  if (staged) {                                                     \
    FOREST_DISPATCH_DEPTH(depth, FN, FUSED, true, __VA_ARGS__)      \
  }                                                                 \
  FOREST_DISPATCH_DEPTH(depth, FN, FUSED, false, __VA_ARGS__)

extern "C" const char* forest_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}
