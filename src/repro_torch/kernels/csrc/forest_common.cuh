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
//     not staged.  The raw predicated kernel reads each thread's row from
//     row-major global x through the read-only path (``global_row`` /
//     ``row_at``), with 64-bit offsets, in blocks sized as at a narrow F.
//     The fused kernels, raw HummingBird and raw QuickScorer run the
//     WIDE-TILED layout instead
//     (``run_wide_tiles``): a block owns kWideRows = 32 rows, one a lane,
//     and its warps walk different trees of each tile, so that few rows
//     are in flight on the card while every tree reads them again (132
//     SMs x 32 rows x 4 F bytes a block: 34 MB at 2,000 features, inside
//     the 50 MB L2, where 256-row blocks held 270 MB);
//     and x arrives feature-major, [F][ldx] with ldx = the launch's rows
//     rounded up to 32 (``forest_transpose_rows``, run by the launch
//     wrapper), so that a warp's load of one feature of its 32 rows is one
//     aligned 128-byte line;
//   * trees arrive as one 8-byte record per node (``kernels/common.py:
//     pack_nodes``): {threshold bits, feature << 1 | default_left}, heap
//     slots 1..I of a [T][L] array (slot 0 unused, so a tree's records
//     start 16-byte aligned and the descent is idx <- 2 * idx + right from
//     idx = 1, leaf = idx - L).  A level is one LDS.64 and one x load.
//     The fused kernels also take bf16 tree tiles (NARROW, ``Record``):
//     one 4-byte word a node, bf16 threshold bits << 16 | feature << 1 |
//     default_left (``pack_narrow_nodes``), and bf16 leaves; the threshold
//     upcasts exactly by masking the low half, the leaf by a shift, and
//     sums stay f32.  A node slot then takes 6 bytes of shared memory, not
//     12.  A depth-1 tree's records are 8 bytes and its leaves 4, so tile
//     copies that miss 16-byte alignment go in 4-byte pieces
//     (``copy_async``);
//   * tree tiles (records [BT][L] + leaves [BT][L]) are copied by
//     cp.async.  A launch over more than one tile double-buffers them:
//     tile j + 1 is in flight while tile j is walked, one barrier per tile.
//     A launch over one tile (a rel partition) has nothing to pipeline
//     across tiles: there the tile's copy and the x tile's are in flight
//     together, and the second block on the SM walks while one stages;
//   * FUSED: each thread keeps its samples' sums in registers and writes
//     [B] once.  No atomics, and the summation order (tree 0, 1, 2, ... in
//     sequence) is fixed from run to run.  Wide-tiled, the warps write their
//     trees' scores to the out tile and the block's first warp then adds
//     the tile's columns tree by tree: the same order;
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
// Rows a block of the wide-tiled layout owns: one a lane of every warp.
constexpr int kWideRows = 32;

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Tree tiles in shared memory: two when the launch walks several tiles.
__host__ __device__ inline int tree_buffers(int T, int bt) {
  return T > bt ? 2 : 1;
}

// A node record and a leaf as the tree tiles hold them: f32 trees (an
// 8-byte record, f32 leaves) or, NARROW, bf16 trees (a 4-byte record,
// bf16 leaves kept as their bits).
template <bool NARROW>
struct Record {
  using Node = int2;
  using Leaf = float;
};
template <>
struct Record<true> {
  using Node = uint32_t;
  using Leaf = uint16_t;
};

__device__ inline int node_feature(int2 n) { return n.y >> 1; }
__device__ inline float node_threshold(int2 n) { return __int_as_float(n.x); }
__device__ inline float node_threshold(uint32_t n) {
  return __uint_as_float(n & 0xFFFF0000u);
}
__device__ inline bool node_default_left(int2 n) { return (n.y & 1) != 0; }
__device__ inline bool node_default_left(uint32_t n) { return (n & 1u) != 0; }
__device__ inline bool node_default_right(int2 n) { return (n.y & 1) == 0; }
__device__ inline bool node_default_right(uint32_t n) {
  return (n & 1u) == 0;
}
__device__ inline float leaf_f32(float v) { return v; }
__device__ inline float leaf_f32(uint16_t v) {
  return __uint_as_float(uint32_t(v) << 16);
}

// Byte offsets of one block's shared memory, each 16-byte aligned:
//   x      float  [F][rows]     sample tile, feature-major (the wide-row
//                               mode passes F = 0: no x tile)
//   per tree buffer (1 or 2):
//     nodes  Node   [BT][L]     packed node records (record_bytes each)
//     leaf   Leaf   [BT][L]     (record_bytes / 2 each)
//   extra                       kernel-specific (structure tensors, ...)
//   out    float  [out_rows][BT+1]  raw kernels (out_rows = rows) and the
//                               wide-tiled layout (out_rows = kWideRows);
//                               none (out_rows = 0) in the fused kernels'
//                               staged and row-major modes
// kernels/common.py:tile_smem_bytes mirrors this layout.
struct TileLayout {
  size_t x, nodes[2], leaf[2], extra, out, total;
};

__host__ __device__ inline TileLayout tile_layout(int rows, int bt, int F,
                                                  int L, int buffers,
                                                  size_t extra_bytes,
                                                  int out_rows,
                                                  int record_bytes) {
  const size_t node_bytes = align16(size_t(record_bytes) * bt * L);
  const size_t leaf_bytes = align16(size_t(record_bytes / 2) * bt * L);
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
  s.total = s.out + align16(sizeof(float) * out_rows * (bt + 1));
  return s;
}

template <typename Node, typename Leaf>
struct TileRefs {
  float* x;
  Node* nodes[2];
  Leaf* leaf[2];
  unsigned char* extra;
  float* out;
};

template <bool NARROW>
__device__ inline TileRefs<typename Record<NARROW>::Node,
                           typename Record<NARROW>::Leaf>
tile_refs(unsigned char* smem, const TileLayout& lay) {
  using Node = typename Record<NARROW>::Node;
  using Leaf = typename Record<NARROW>::Leaf;
  return TileRefs<Node, Leaf>{
      reinterpret_cast<float*>(smem + lay.x),
      {reinterpret_cast<Node*>(smem + lay.nodes[0]),
       reinterpret_cast<Node*>(smem + lay.nodes[1])},
      {reinterpret_cast<Leaf*>(smem + lay.leaf[0]),
       reinterpret_cast<Leaf*>(smem + lay.leaf[1])},
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

// Where node n's feature sits.  The narrow record holds the feature in
// bits 1..15, so (n & 0xFFFE) is twice the feature: its offsets take one
// mask and no shift.  node_offset: f * stride, the feature's place in a
// staged column (stride = the tile's rows, a multiple of 32, so even);
// row_at: the feature of a global row, read through the read-only path
// (ld.global.nc).
__device__ inline int node_offset(int2 n, int stride) {
  return node_feature(n) * stride;
}
__device__ inline int node_offset(uint32_t n, int stride) {
  return int(n & 0xFFFEu) * (stride >> 1);
}
__device__ inline float row_at(const float* __restrict__ row, int2 n) {
  return __ldg(row + node_feature(n));
}
__device__ inline float row_at(const float* __restrict__ row, uint32_t n) {
  return __ldg(reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(row) + 2 * (n & 0xFFFEu)));
}

// Node n's feature of a thread's row: ``xb`` is its column of the staged
// tile (stride = the tile's rows) or, not STAGED, its global row.
template <bool STAGED, typename Node>
__device__ inline float node_x(const float* __restrict__ xb, Node n,
                               int stride) {
  if constexpr (STAGED) {
    return xb[node_offset(n, stride)];
  } else {
    return row_at(xb, n);
  }
}

template <typename Node, typename Leaf>
__device__ inline void stage_tree_tile(const TileRefs<Node, Leaf>& s,
                                       int buf,
                                       const Node* __restrict__ nodes,
                                       const Leaf* __restrict__ leaf_value,
                                       int t0, int bt, int L) {
  const size_t n = size_t(bt) * L, g0 = size_t(t0) * L;
  // selected, not indexed: a run-time index into s puts s in local memory
  copy_async(buf ? s.nodes[1] : s.nodes[0], nodes + g0, sizeof(Node) * n);
  copy_async(buf ? s.leaf[1] : s.leaf[0], leaf_value + g0,
             sizeof(Leaf) * n);
}

// True = left child.  +-inf compares like any other number.
template <typename Node>
__device__ inline bool go_left(float v, Node node) {
  return isnan(v) ? node_default_left(node) : v < node_threshold(node);
}

// The tree loop of every kernel.  Issues tile 0 (after whatever the caller
// already issued: x, structure tensors) and walks all T / bt tiles in
// order.  ``walk(nodes_s, leaf_s)`` scores one staged tile: FUSED
// kernels add into their own registers, RAW ones fill s.out[r * (bt + 1) +
// t] for the block's rows = ROWS_PER_THREAD * blockDim.x samples r, which
// this loop then writes to out[(b0 + r) * T + t0 + t].
template <bool FUSED, int ROWS_PER_THREAD = 1, typename Node,
          typename Leaf, typename Walk>
__device__ inline void run_tiles(const TileRefs<Node, Leaf>& s,
                                 const Node* __restrict__ nodes,
                                 const Leaf* __restrict__ leaf_value,
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

// ---- the wide-tiled layout ------------------------------------------------

// Rows of the feature-major x of a launch over B rows: B rounded up to a
// whole number of warps, so that every block's column run is one aligned
// 128-byte line of each feature.
__host__ __device__ inline long long wide_ldx(long long B) {
  return (B + kWideRows - 1) / kWideRows * kWideRows;
}

// Node n's feature of the lane's row, from feature-major x: ``col`` is
// x + (the lane's row), ``ldx`` the rows of a feature, below 2^32
// (launch_rows checks), so the 64-bit offset is one 32 x 32 -> 64-bit
// multiply and ldx takes one register.  The narrow record holds twice the
// feature in (n & 0xFFFE).  Kernel alone at 2,000 features on an H100,
// against a 64 x 64-bit product (chip_wide_probe.py, PERF.md section 6):
// QuickScorer fused 0.77x, HummingBird fused 0.94x and raw 0.97x,
// predicated fused 1.007x (f32; 1.03x at 968 features) and 0.98x (bf16).
__device__ inline float col_at(const float* __restrict__ col, int2 n,
                               unsigned ldx) {
  return __ldg(col + (unsigned long long)unsigned(node_feature(n)) * ldx);
}
__device__ inline float col_at(const float* __restrict__ col, uint32_t n,
                               unsigned ldx) {
  return __ldg(col + (unsigned long long)((n & 0xFFFEu) >> 1) * ldx);
}

// The tree loop of the wide-tiled layout.  The block owns kWideRows rows
// from b0; ``walk(nodes_s, leaf_s)`` has each warp score its own trees of
// the staged tile for all of them, writing s.out[r * (bt + 1) + t].  After
// a barrier, FUSED: the block's first warp adds the tile's scores into its
// lane's row sum, tree 0, 1, 2, ... in sequence (the order of one thread
// that walked every tree), and the sums go to out[b0 + r] at the end; RAW:
// the block writes the tile's rows to out[(b0 + r) * T + t0 + t].  The
// barrier at the top of the next tile frees the out tile again.
template <bool FUSED, typename Node, typename Leaf, typename Walk>
__device__ inline void run_wide_tiles(const TileRefs<Node, Leaf>& s,
                                      const Node* __restrict__ nodes,
                                      const Leaf* __restrict__ leaf_value,
                                      float* __restrict__ out, long long b0,
                                      long long B, int T, int bt, int L,
                                      Walk walk) {
  const int n_tiles = T / bt, nbuf = tree_buffers(T, bt);
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  stage_tree_tile(s, 0, nodes, leaf_value, 0, bt, L);
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j % nbuf;
    cp_async_wait_all();
    __syncthreads();
    if (nbuf == 2 && j + 1 < n_tiles) {
      stage_tree_tile(s, (j + 1) & 1, nodes, leaf_value, (j + 1) * bt, bt,
                      L);
      cp_async_commit();
    }
    walk(buf ? s.nodes[1] : s.nodes[0], buf ? s.leaf[1] : s.leaf[0]);
    __syncthreads();
    if constexpr (FUSED) {
      if (threadIdx.x < kWideRows) {
        const float* row = s.out + lane * (bt + 1);
        for (int t = 0; t < bt; ++t) acc += row[t];
      }
    } else {
      const long long t0 = (long long)j * bt;
      for (int k = threadIdx.x; k < kWideRows * bt; k += blockDim.x) {
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
  if constexpr (FUSED) {
    if (threadIdx.x < kWideRows && b0 + lane < B) out[b0 + lane] = acc;
  }
}

// Rows of x a block of the transpose takes.
constexpr int kTransposeRows = 128;

// xt[f * ldx + b] = x[b * F + f] for the rows b < rows, zeros for rows <=
// b < ldx = wide_ldx(rows): R x 32 (rows x features) tiles through shared
// memory, R = kTransposeRows, so that the reads (along f) and the writes
// (along b) are both coalesced; each thread keeps R / 8 loads in flight.
// Rows go on grid.x, features on grid.y.
__global__ void __launch_bounds__(256) transpose_rows_kernel(
    const float* __restrict__ x, float* __restrict__ xt, long long rows,
    int F, long long ldx) {
  constexpr int R = kTransposeRows;
  __shared__ float tile[R][33];
  const long long b0 = (long long)blockIdx.x * R;
  const int f0 = blockIdx.y * 32;
  const int f = f0 + threadIdx.x;
#pragma unroll
  for (int k = threadIdx.y; k < R; k += 8) {
    const long long b = b0 + k;
    tile[k][threadIdx.x] = b < rows && f < F ? x[b * F + f] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int k = threadIdx.y; k < 32; k += 8) {
#pragma unroll
    for (int c = 0; c < R; c += 32) {
      const long long b = b0 + c + threadIdx.x;
      if (f0 + k < F && b < ldx) {
        xt[(long long)(f0 + k) * ldx + b] = tile[c + threadIdx.x][k];
      }
    }
  }
}

inline int transpose_rows(const float* x, float* xt, long long rows, int F,
                          cudaStream_t stream) {
  const long long ldx = wide_ldx(rows);
  const dim3 grid(unsigned((ldx + kTransposeRows - 1) / kTransposeRows),
                  unsigned((F + 31) / 32));
  transpose_rows_kernel<<<grid, dim3(32, 8), 0, stream>>>(x, xt, rows, F,
                                                          ldx);
  return int(cudaGetLastError());
}

// (launch_rows: one block per ``rows`` samples, whatever block_b is.  B
// rounded up to whole warps stays below 2^32: the wide-tiled kernels'
// ldx, which col_at takes as 32 bits.)
template <typename Kernel, typename... Args>
inline int launch_rows(Kernel kernel, long long B, long long rows,
                       int block_b, size_t smem, cudaStream_t stream,
                       Args... args) {
  if (wide_ldx(B) > 0xFFFFFFFFll) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const unsigned grid = unsigned((B + rows - 1) / rows);
  kernel<<<grid, block_b, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

template <int ROWS_PER_THREAD = 1, typename Kernel, typename... Args>
inline int launch_kernel(Kernel kernel, long long B, int block_b,
                         size_t smem, cudaStream_t stream, Args... args) {
  return launch_rows(kernel, B, (long long)ROWS_PER_THREAD * block_b,
                     block_b, smem, stream, args...);
}

}  // namespace forest

// FN<depth, FUSED, STAGED, NARROW>(...) for a depth known only at run
// time.
#define FOREST_DISPATCH_DEPTH(depth, FN, FUSED, STAGED, NARROW, ...) \
  switch (depth) {                                                    \
    case 1: return FN<1, FUSED, STAGED, NARROW>(__VA_ARGS__);         \
    case 2: return FN<2, FUSED, STAGED, NARROW>(__VA_ARGS__);         \
    case 3: return FN<3, FUSED, STAGED, NARROW>(__VA_ARGS__);         \
    case 4: return FN<4, FUSED, STAGED, NARROW>(__VA_ARGS__);         \
    case 5: return FN<5, FUSED, STAGED, NARROW>(__VA_ARGS__);         \
    case 6: return FN<6, FUSED, STAGED, NARROW>(__VA_ARGS__);         \
    case 7: return FN<7, FUSED, STAGED, NARROW>(__VA_ARGS__);         \
    case 8: return FN<8, FUSED, STAGED, NARROW>(__VA_ARGS__);         \
    default: return int(cudaErrorInvalidValue);                       \
  }

// ... and for the x mode, a launch argument (nonzero = staged).  The
// record (NARROW) is the entry point's: f32 and bf16 trees are two.
#define FOREST_DISPATCH(depth, staged, FN, FUSED, NARROW, ...)            \
  if (staged) {                                                           \
    FOREST_DISPATCH_DEPTH(depth, FN, FUSED, true, NARROW, __VA_ARGS__)    \
  }                                                                       \
  FOREST_DISPATCH_DEPTH(depth, FN, FUSED, false, NARROW, __VA_ARGS__)

// The wide-tiled layout's feature-major x of ``rows`` rows of row-major x
// (the launch wrapper calls it before the kernel, on the same stream).  At
// 128 rows a block it moved 2.61 TB/s of reads and writes at 100,352 x
// 2,000 on an H100, against 2.36 at 32 rows a block (PERF.md section 6).
extern "C" int forest_transpose_rows(const float* x, float* xt,
                                     long long rows, int F,
                                     cudaStream_t stream) {
  return forest::transpose_rows(x, xt, rows, F, stream);
}

extern "C" const char* forest_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}
