// HummingBird (GEMM formulation) forest inference, for sm_90a: fused
// (+ SUM) and raw ([B, T]) variants of one kernel.
//
// Replaces repro/kernels/forest_hummingbird.py:hummingbird_fused_kernel_call
// (the Pallas kernel at its pl.pallas_call, line 139) and
// hummingbird_kernel_call (line 115).  Per (sample, tree):
//     S[i]   = go_left(node i)                    i in [0, I)
//     P[l]   = sum_i S[i] * C[i, l]               C in {-1, 0, +1}, [I, L]
//     score  = leaf_value[t, l] + 0.0 for the one l with P[l] == D[l]
// fused: out[b] += score over the trees in order; raw: out[b * T + t].
// C and D are structure-only (one per depth, shared by every tree).  The
// "+ 0.0" turns a -0.0 leaf into +0.0, as the plain version's one-hot
// contraction (a sum that starts from +0.0) does.
//
// The S.C contraction runs on the tensor cores:
// mma.sync.m16n8k32.s32.s8.s8.s32, S and C as int8, P in int32 -- exact,
// so P == D is an exact equality.  K = the node axis padded to KP =
// max(32, L) (C's pad rows are 0), N = the leaf axis padded to NP =
// max(8, L) (pad leaves have D = -1 and never match).  The structure
// tensor ``ct`` is C transposed, [NP][KP] int8, so that B fragments load
// with ldmatrix like A ones.
//
// What bounds it on this card: operations.  Against the int8 tensor-core
// peak the GEMM is 2 * I * L per pair; the kernel also evaluates all I
// node predicates per pair (a broadcast node-record load and an x load
// each).  A popcount form of the contraction (2 * L * ceil(I/32) __popc
// per pair over bit-packed S and C masks) runs at the popcount pipe's
// rate and leaves the tensor cores idle.  Design, per warp of 32 rows and
// per tree:
//   1. each lane builds its row's S as KP bytes and stores them to the
//      warp's [32][KP] S tile (16-byte chunks XOR-swizzled by row, so the
//      stores and the ldmatrix reads are conflict-free);
//   2. ldmatrix.x4 loads the A fragments (2 m-tiles x KP/32 k-steps) into
//      registers; C^T stays in shared memory for the whole kernel (64 KB
//      at depth 8, same swizzle) and is read by ldmatrix per n-tile;
//   3. per group of four n-tiles of 8 leaves, one mma per (n-tile,
//      m-tile, k-step), the k-step outermost, so that eight independent
//      accumulations hide the mma latency (8 warps an SM leave little
//      else to); each lane checks its P entries against D and keeps the
//      matching leaf;
//   4. two quad shuffles give every lane of a quad the leaves of its rows,
//      and lane t of the quad scores row (t >> 1) * 16 + (t & 1) * 8 + g.
// C^T, the S tiles and the x tile leave room for one 256-thread block an
// SM (kernels/common.py:smem_budget).  Wide rows (STAGED false), fused
// and raw: the wide-tiled layout (forest_common.cuh) -- a block of 32
// rows, its warps over trees, each warp running steps 1-4 for the same 32
// rows against its own trees; step 1 reads feature-major x, so a node's
// feature of the 32 rows is one 128-byte line (1,020 bytes a row-tree at
// depth 8, where row-major rows took ~160 of their 250 sectors, ~5 KB),
// and the rows in flight (~34 MB at 2,000 features) stay in L2 while
// every tree reads them; steps 2-4 are unchanged.  Over row-major x the
// same kernel took 4.3x the time of the transpose and the kernel, raw
// (16 trees) 2.1x (chip_wide_probe.py at 100,352 x 2,000 on an H100).
// bf16 tree tiles (NARROW, fused only): step 1 reads 4-byte records and
// the exit leaf is a 2-byte load shifted to f32; C^T, S and the mma are
// the same.
#include "forest_common.cuh"

namespace forest {

template <int DEPTH>
struct Hb {
  static constexpr int L = 1 << DEPTH, I = L - 1;
  static constexpr int KP = L < 32 ? 32 : L;   // node axis, mma K multiple
  static constexpr int NP = L < 8 ? 8 : L;     // leaf axis, mma N multiple
  static constexpr int KS = KP / 32;           // k-steps
  static constexpr int NT = NP / 8;            // n-tiles
  static constexpr int NG = NT < 4 ? NT : 4;   // n-tiles in flight
  static constexpr int CH = KP / 16;           // 16-byte chunks in a row
  static constexpr int SWZ = CH < 8 ? CH - 1 : 7;
};

// Bytes of the kernel-specific shared memory: C^T, D, one S tile a warp.
// kernels/common.py:_extra_bytes mirrors it.
__host__ __device__ inline size_t hb_extra_bytes(int depth, int bb) {
  const size_t L = size_t(1) << depth;
  const size_t KP = L < 32 ? 32 : L, NP = L < 8 ? 8 : L;
  return align16(NP * KP) + align16(4 * NP) + size_t(bb) * KP;
}

template <int DEPTH>
__device__ inline int swizzled(int row, int chunk) {
  return row * Hb<DEPTH>::KP + ((chunk ^ (row & Hb<DEPTH>::SWZ)) << 4);
}

__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ inline void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a . b, one 16 x 8 x 32 int8 tile, int32 accumulate.
__device__ inline void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                              const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Steps 1-4 for one tree and a warp's 32 rows: ``x_of(n)`` is node n's
// feature of row ``lane`` (step 1); returns the exit leaf of the row this
// lane scores, warp row (tq >> 1) * 16 + (tq & 1) * 8 + g (step 4).
template <int DEPTH, typename Node, typename XOf>
__device__ __forceinline__ int hb_exit_leaf(const Node* tree,
                                            unsigned char* s_tile,
                                            const unsigned char* ct_s,
                                            const int32_t* d_s, int lane,
                                            XOf x_of) {
  using H = Hb<DEPTH>;
  const int g = lane >> 2, tq = lane & 3;
  // 1. S: byte i of the row = go_left(node i), zero past I
#pragma unroll
  for (int c = 0; c < H::CH; ++c) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t bits = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = c * 16 + q * 4 + j;
        if (i < H::I) {
          const Node n = tree[i + 1];
          bits |= uint32_t(go_left(x_of(n), n)) << (8 * j);
        }
      }
      w[q] = bits;
    }
    *reinterpret_cast<uint4*>(s_tile + swizzled<DEPTH>(lane, c)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  __syncwarp();
  // 2. A fragments: matrix lane >> 3 of each x4 is (rows +0 / +8,
  // chunk 2ks / 2ks + 1)
  uint32_t a[2][H::KS][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int ks = 0; ks < H::KS; ++ks) {
      const int r = mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      ldmatrix_x4(a[mt][ks],
                  s_tile + swizzled<DEPTH>(r, 2 * ks + (lane >> 4)));
    }
  }
  __syncwarp();  // the S tile is free for the next tree
  // 3. P = S.C, H::NG n-tiles at a time (2 * H::NG independent
  // accumulators per k-step); keep the leaf where P == D
  int hit[2][2] = {{-1, -1}, {-1, -1}};  // [m-tile][row g / g + 8]
#pragma unroll 1
  for (int n0 = 0; n0 < H::NT; n0 += H::NG) {
    int p[H::NG][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < H::KS; ++ks) {
      uint32_t bf[H::NG][2];
      if constexpr (H::NG == 1) {
        ldmatrix_x2(bf[0], ct_s + swizzled<DEPTH>(n0 * 8 + (lane & 7),
                                                  2 * ks + ((lane >> 3) & 1)));
      } else {
        // matrix lane >> 3 of each x4: (n-tile +0 / +1, chunk 2ks / 2ks + 1)
#pragma unroll
        for (int j = 0; j < H::NG; j += 2) {
          uint32_t r4[4];
          const int nt = n0 + j + (lane >> 4);
          ldmatrix_x4(r4, ct_s + swizzled<DEPTH>(nt * 8 + (lane & 7),
                                                 2 * ks + ((lane >> 3) & 1)));
          bf[j][0] = r4[0];
          bf[j][1] = r4[1];
          bf[j + 1][0] = r4[2];
          bf[j + 1][1] = r4[3];
        }
      }
#pragma unroll
      for (int j = 0; j < H::NG; ++j) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_s8(p[j][mt], a[mt][ks], bf[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < H::NG; ++j) {
      const int l0 = (n0 + j) * 8 + 2 * tq;
      const int2 d = *reinterpret_cast<const int2*>(d_s + l0);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (p[j][mt][0] == d.x) hit[mt][0] = l0;
        if (p[j][mt][1] == d.y) hit[mt][0] = l0 + 1;
        if (p[j][mt][2] == d.x) hit[mt][1] = l0;
        if (p[j][mt][3] == d.y) hit[mt][1] = l0 + 1;
      }
    }
  }
  // 4. the quad's lanes share their hits; lane tq takes its row's
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = hit[mt][h];
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
      hit[mt][h] = v;
    }
  }
  return max(0, tq == 0   ? hit[0][0]
                : tq == 1 ? hit[0][1]
                : tq == 2 ? hit[1][0]
                          : hit[1][1]);
}

// C^T and D into shared memory (cp.async; the caller commits).
template <int DEPTH>
__device__ inline void stage_structure(unsigned char* ct_s, int32_t* d_s,
                                       const int8_t* __restrict__ ct,
                                       const int32_t* __restrict__ dcount) {
  using H = Hb<DEPTH>;
  for (int k = threadIdx.x; k < H::NP * H::CH; k += blockDim.x) {
    const int n = k / H::CH;
    cp_async16(ct_s + swizzled<DEPTH>(n, k - n * H::CH), ct + size_t(k) * 16);
  }
  for (int k = threadIdx.x; k < H::NP; k += blockDim.x) {
    cp_async4(d_s + k, dcount + k, true);
  }
}

// The staged mode: a warp scores its own 32 rows of the block's 256
// against every tree of the tile.
template <int DEPTH, bool FUSED, bool NARROW>
__global__ void __launch_bounds__(kMaxBlock, 1) hummingbird_kernel(
    const float* __restrict__ x,
    const typename Record<NARROW>::Node* __restrict__ nodes,
    const typename Record<NARROW>::Leaf* __restrict__ leaf_value,
    const int8_t* __restrict__ ct, const int32_t* __restrict__ dcount,
    float* __restrict__ out, long long B, int F, int T, int bt) {
  using H = Hb<DEPTH>;
  using Node = typename Record<NARROW>::Node;
  using Leaf = typename Record<NARROW>::Leaf;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bb = blockDim.x;
  const auto s = tile_refs<NARROW>(
      smem, tile_layout(bb, bt, F, H::L, tree_buffers(T, bt),
                        hb_extra_bytes(DEPTH, bb), FUSED ? 0 : bb,
                        sizeof(Node)));
  unsigned char* ct_s = s.extra;
  int32_t* d_s = reinterpret_cast<int32_t*>(ct_s + align16(H::NP * H::KP));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* s_tile = reinterpret_cast<unsigned char*>(d_s) +
                          align16(4 * H::NP) + warp * 32 * H::KP;
  const long long b0 = (long long)blockIdx.x * bb;

  stage_structure<DEPTH>(ct_s, d_s, ct, dcount);
  stage_x_async(s.x, x, b0, B, F, bb);

  const int g = lane >> 2, tq = lane & 3;
  // the row of the block this lane scores (step 4 above)
  const int row = warp * 32 + (tq >> 1) * 16 + (tq & 1) * 8 + g;
  // the row whose predicates this lane builds (step 1)
  const float* xb = s.x + warp * 32 + lane;
  float acc = 0.f;

  run_tiles<FUSED>(
      s, nodes, leaf_value, out, b0, B, T, bt, H::L,
      [&](const Node* nd, const Leaf* lv) {
        for (int t = 0; t < bt; ++t) {
          const int leaf = hb_exit_leaf<DEPTH>(
              nd + t * H::L, s_tile, ct_s, d_s, lane,
              [&](Node n) { return node_x<true>(xb, n, bb); });
          const float v = __fadd_rn(leaf_f32(lv[t * H::L + leaf]), 0.f);
          if constexpr (FUSED) {
            acc += v;
          } else {
            s.out[row * (bt + 1) + t] = v;
          }
        }
      });
  if constexpr (FUSED) {
    if (b0 + row < B) out[b0 + row] = acc;
  }
}

// The wide-tiled mode (forest_common.cuh): the block's 32 rows, one a lane
// of every warp; warp w scores trees w, w + W, ... of each tile, building
// S from feature-major x: one 128-byte line a node.
template <int DEPTH, bool FUSED, bool NARROW>
__global__ void __launch_bounds__(kMaxBlock, 1) hummingbird_wide_kernel(
    const float* __restrict__ x,
    const typename Record<NARROW>::Node* __restrict__ nodes,
    const typename Record<NARROW>::Leaf* __restrict__ leaf_value,
    const int8_t* __restrict__ ct, const int32_t* __restrict__ dcount,
    float* __restrict__ out, long long B, int F, int T, int bt) {
  using H = Hb<DEPTH>;
  using Node = typename Record<NARROW>::Node;
  using Leaf = typename Record<NARROW>::Leaf;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bb = blockDim.x, nw = bb >> 5;
  const auto s = tile_refs<NARROW>(
      smem, tile_layout(kWideRows, bt, 0, H::L, tree_buffers(T, bt),
                        hb_extra_bytes(DEPTH, bb), kWideRows, sizeof(Node)));
  unsigned char* ct_s = s.extra;
  int32_t* d_s = reinterpret_cast<int32_t*>(ct_s + align16(H::NP * H::KP));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* s_tile = reinterpret_cast<unsigned char*>(d_s) +
                          align16(4 * H::NP) + warp * 32 * H::KP;
  const long long b0 = (long long)blockIdx.x * kWideRows;
  const long long ldx = wide_ldx(B);

  stage_structure<DEPTH>(ct_s, d_s, ct, dcount);

  const int g = lane >> 2, tq = lane & 3;
  float* out_row = s.out + ((tq >> 1) * 16 + (tq & 1) * 8 + g) * (bt + 1);
  const float* xb = x + b0 + lane;

  run_wide_tiles<FUSED>(
      s, nodes, leaf_value, out, b0, B, T, bt, H::L,
      [&](const Node* nd, const Leaf* lv) {
        for (int t = warp; t < bt; t += nw) {
          const int leaf = hb_exit_leaf<DEPTH>(
              nd + t * H::L, s_tile, ct_s, d_s, lane,
              [&](Node n) { return col_at(xb, n, ldx); });
          out_row[t] = __fadd_rn(leaf_f32(lv[t * H::L + leaf]), 0.f);
        }
      });
}

template <int DEPTH, bool FUSED, bool STAGED, bool NARROW>
int launch_hummingbird(const float* x,
                       const typename Record<NARROW>::Node* nodes,
                       const typename Record<NARROW>::Leaf* leaf_value,
                       const int8_t* ct, const int32_t* dcount, float* out,
                       long long B, int F, int T, int block_b, int block_t,
                       cudaStream_t stream) {
  const int record = sizeof(typename Record<NARROW>::Node);
  const size_t extra = hb_extra_bytes(DEPTH, block_b);
  if constexpr (STAGED) {
    const size_t smem = tile_layout(block_b, block_t, F, 1 << DEPTH,
                                    tree_buffers(T, block_t), extra,
                                    FUSED ? 0 : block_b, record)
                            .total;
    return launch_kernel(hummingbird_kernel<DEPTH, FUSED, NARROW>, B,
                         block_b, smem, stream, x, nodes, leaf_value, ct,
                         dcount, out, B, F, T, block_t);
  } else {
    const size_t smem = tile_layout(kWideRows, block_t, 0, 1 << DEPTH,
                                    tree_buffers(T, block_t), extra,
                                    kWideRows, record)
                            .total;
    return launch_rows(hummingbird_wide_kernel<DEPTH, FUSED, NARROW>, B,
                       kWideRows, block_b, smem, stream, x, nodes,
                       leaf_value, ct, dcount, out, B, F, T, block_t);
  }
}

}  // namespace forest

extern "C" int forest_hummingbird_fused(
    const float* x, const int2* nodes, const float* leaf_value,
    const int8_t* ct, const int32_t* dcount, float* out, long long B, int F,
    int T, int depth, int block_b, int block_t, int x_staged,
    cudaStream_t stream) {
  FOREST_DISPATCH(depth, x_staged, forest::launch_hummingbird, true, false,
                  x, nodes, leaf_value, ct, dcount, out, B, F, T, block_b,
                  block_t, stream)
}

// The fused kernel over bf16 tree tiles: 4-byte node records, bf16 leaves.
extern "C" int forest_hummingbird_fused_bf16(
    const float* x, const uint32_t* nodes, const uint16_t* leaf_value,
    const int8_t* ct, const int32_t* dcount, float* out, long long B, int F,
    int T, int depth, int block_b, int block_t, int x_staged,
    cudaStream_t stream) {
  FOREST_DISPATCH(depth, x_staged, forest::launch_hummingbird, true, true,
                  x, nodes, leaf_value, ct, dcount, out, B, F, T, block_b,
                  block_t, stream)
}

extern "C" int forest_hummingbird_raw(
    const float* x, const int2* nodes, const float* leaf_value,
    const int8_t* ct, const int32_t* dcount, float* out, long long B, int F,
    int T, int depth, int block_b, int block_t, int x_staged,
    cudaStream_t stream) {
  FOREST_DISPATCH(depth, x_staged, forest::launch_hummingbird, false, false,
                  x, nodes, leaf_value, ct, dcount, out, B, F, T, block_b,
                  block_t, stream)
}
