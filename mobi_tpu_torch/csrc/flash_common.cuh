// Device helpers shared by the flash-attention kernels: the fp32 kernels
// (flash_fwd.cu, flash_fwd_tav.cu, flash_bwd.cu) take mma.sync m16n8k8 on
// tf32 with fp32 accumulators (3xTF32) and cp.async tile loads; all of them,
// flash_fwd_sm90.cu and flash_bwd_sm90.cu too, take the online softmax step
// of the forward, the base-2 exponential, the bf16 packing, the row stores
// and the choice of the padded head dim.
//
// The accumulator layout of m16n8 (g = lane / 4, t2 = 2 * (lane % 4)), also
// each warp's share of a wgmma accumulator:
//   C 16x8:  c0, c1 (row g, cols t2, t2+1), c2, c3 (row g+8, same cols)
// so the C tiles of two neighbouring 8-column tiles, packed to bf16, are the
// A fragment of one 16-deep bf16 k-step.
//
// fp32 operands run as 3xTF32 on mma.m16n8k8.row.col.f32.tf32 (t = lane % 4):
//   A 16x8: a0 (row g, col t), a1 (row g+8, col t), a2 (row g, col t+4),
//           a3 (row g+8, col t+4)
//   B 8x8:  b0 (k row t, col g), b1 (k row t+4, col g)
//   C 16x8: as above, c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// A C tile of scores feeds the next product's k dimension with no shuffle
// when that product's k index t stands for key 2t and t+4 for key 2t+1: the
// contraction runs over the tile's 8 keys in another order, and the other
// operand's fragment is read in the same order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mobi_flash {

constexpr float kLog2e = 1.4426950408889634f;

// Row stride of a shared-memory tile, in elements: +16 bytes keep the 8 rows
// that one fragment read touches in distinct banks (+4 fp32).
template <int DP, typename T>
__host__ __device__ constexpr int tile_ld() { return DP + 16 / static_cast<int>(sizeof(T)); }

// How the flash kernels serve head dim d, the one copy of the rule: dk, the
// contraction width of the instantiation (d zero-padded to the smallest of
// 48, 64, 80, 128, 160, 192 and 256 that holds it), and dv, the output
// columns one block accumulates. A call launches dk / dv blocks along the
// head dim (a grid axis); each computes the logits over the full dk and
// accumulates its own dv columns of the output (dQ; dK and dV). Up to 128 dv
// is dk and there is one slice; above it the slices keep each block's
// accumulators at the width of the 80 or 64 build, which fit the registers
// ptxas gives (the 128 builds spill). dk = 0 where no instantiation serves
// d (d not a multiple of 8, or above 256).
struct HeadDims {
  int dk, dv;
};
__host__ __device__ constexpr HeadDims head_dims(int d) {
  return d <= 0 || d % 8 ? HeadDims{0, 0}
         : d <= 48       ? HeadDims{48, 48}
         : d <= 64       ? HeadDims{64, 64}
         : d <= 80       ? HeadDims{80, 80}
         : d <= 128      ? HeadDims{128, 128}
         : d <= 160      ? HeadDims{160, 80}
         : d <= 192      ? HeadDims{192, 64}
         : d <= 256      ? HeadDims{256, 64}
                         : HeadDims{0, 0};
}

// The largest shared memory a block may have (227 KB).
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false no byte is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Start copying rows [row0, row0 + ROWS) of a row-strided [n, d] matrix into
// a shared tile with THREADS threads; rows >= n and columns in [d, DP) are
// zero-filled. d is a multiple of 8, so each 16-byte chunk (8 bf16 or 4
// fp32) is wholly in or out of range.
template <int DP, int ROWS, int THREADS, typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                long long row_stride, int row0, int n, int d) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = DP / kVec;
  constexpr int LD = tile_ld<DP, T>();
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    const bool valid = row0 + r < n && c < d;
    cp_async_16(dst + r * LD + c, valid ? src + (row0 + r) * row_stride + c : src, valid);
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Write a warp's 16 x DP fp32 accumulator (scaled by inv[r] for rows g, g+8)
// as rows of a row-strided bf16 or fp32 output; rows >= n and columns >= d
// are skipped.
template <int DP, typename T>
__device__ __forceinline__ void store_rows(T* out, long long row_stride,
                                           const float (&acc)[DP / 8][4], const float (&inv)[2],
                                           int row0, int n, int d, int g, int t2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int col = dt * 8 + t2;
      if (col < d)
        store_pair(out + row * row_stride + col, acc[dt][2 * r] * inv[r], acc[dt][2 * r + 1] * inv[r]);
    }
  }
}

// One key tile of the forward's online softmax, over a warp's 16 query rows
// (rows g and g + 8 in this thread): mask the keys >= nk of a ragged tile,
// take the tile's row maxima across the quad, rescale the running max m_i
// and this thread's share of the running sum l_i by alpha = 2^(m_old -
// m_new) (returned, for the accumulator), and replace the scores s by
// p = 2^(s * scale_log2 - m_new). m_i is in log2 units of the scaled logits.
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float (&m_i)[2], float (&l_i)[2],
                                               float (&alpha)[2], int n0, int nk, int t2,
                                               float scale_log2) {
  if (n0 + NT * 8 > nk) {  // the ragged last tile
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (n0 + nt * 8 + t2 + (jj & 1) >= nk) s[nt][jj] = -INFINITY;
  }
  float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    tile_max[0] = fmaxf(tile_max[0], fmaxf(s[nt][0], s[nt][1]));
    tile_max[1] = fmaxf(tile_max[1], fmaxf(s[nt][2], s[nt][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
    const float m_new = fmaxf(m_i[r], tile_max[r] * scale_log2);
    alpha[r] = exp2_approx(m_i[r] - m_new);
    m_i[r] = m_new;
    l_i[r] *= alpha[r];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float p = exp2_approx(fmaf(s[nt][jj], scale_log2, -m_i[jj >> 1]));
      s[nt][jj] = p;
      l_i[jj >> 1] += p;
    }
  }
}

// ------------------------------------------------------------ fp32: 3xTF32
// A float x is split into tf32 values hi = tf32(x) and lo = tf32(x - hi), and
// a product a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b (small terms
// first): about 22 bits of each operand, where plain TF32 keeps 11. The
// dropped lo_a lo_b is below 2^-22 of |a b|: fp32 accuracy for the products.

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_1688_tf32(float (&c)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An fp32 operand fragment split once into its tf32 halves.
template <int N>
struct SplitFrag {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) split_tf32(x[i], hi[i], lo[i]);
  }
};

// c += a b on 16x8x8 fp32 fragments, 3xTF32.
__device__ __forceinline__ void mma_1688_3xtf32(float (&c)[4], const SplitFrag<4>& a,
                                                const SplitFrag<2>& b) {
  mma_1688_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_1688_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_1688_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// The A fragments (split) of a warp's 16-row slab of an fp32 shared tile, for
// every 8-deep k-step of the (padded) head dim.
template <int DP>
__device__ __forceinline__ void load_a_frags_f32(SplitFrag<4> (&a)[DP / 8], const float* tile,
                                                 int row0, int g, int t) {
  constexpr int LD = tile_ld<DP, float>();
#pragma unroll
  for (int ks = 0; ks < DP / 8; ++ks) {
    const float* p = tile + (row0 + g) * LD + ks * 8 + t;
    const float x[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
    a[ks].set(x);
  }
}

// gemm_abt for fp32: C[16 x NT*8] = A[16 x DP] B^T, B's rows the rows of a
// shared fp32 tile (S = Q K^T).
template <int DP, int NT>
__device__ __forceinline__ void gemm_abt_f32(float (&c)[NT][4], const SplitFrag<4> (&a)[DP / 8],
                                             const float* tile, int g, int t) {
  constexpr int LD = tile_ld<DP, float>();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
    const float* row = tile + (nt * 8 + g) * LD + t;
#pragma unroll
    for (int ks = 0; ks < DP / 8; ++ks) {
      SplitFrag<2> b;
      const float x[2] = {row[ks * 8], row[ks * 8 + 4]};
      b.set(x);
      mma_1688_3xtf32(c[nt], a[ks], b);
    }
  }
}

// gemm_abt_f32 with the A fragments read from rows [row0, row0 + 16) of a
// shared fp32 tile and split at each use, for kernels that cannot keep them
// in registers (the backward holds two such operands).
template <int DP, int NT>
__device__ __forceinline__ void gemm_abt_f32_smem(float (&c)[NT][4], const float* a_tile, int row0,
                                                  const float* tile, int g, int t) {
  constexpr int LD = tile_ld<DP, float>();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP / 8; ++ks) {
    SplitFrag<4> a;
    const float* pa = a_tile + (row0 + g) * LD + ks * 8 + t;
    const float x[4] = {pa[0], pa[8 * LD], pa[4], pa[8 * LD + 4]};
    a.set(x);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      SplitFrag<2> b;
      const float* row = tile + (nt * 8 + g) * LD + ks * 8 + t;
      const float y[2] = {row[0], row[4]};
      b.set(y);
      mma_1688_3xtf32(c[nt], a, b);
    }
  }
}

// gemm_pb for fp32: acc[16 x DP] += P[16 x NT*8] V, P given as C tiles of
// scores (not rounded: the plain version keeps them fp32) and V the first
// NT*8 rows of a shared fp32 tile whose rows are LD apart (a wider tile's
// columns from `tile` on: one head-dim slice). k index t stands for key 2t,
// t + 4 for key 2t + 1 (see the top of this file).
template <int DP, int NT, int LD = tile_ld<DP, float>()>
__device__ __forceinline__ void gemm_pb_f32(float (&acc)[DP / 8][4], const float (&p)[NT][4],
                                            const float* tile, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    SplitFrag<4> a;
    const float x[4] = {p[nt][0], p[nt][2], p[nt][1], p[nt][3]};
    a.set(x);
    const float* v0 = tile + (nt * 8 + 2 * t) * LD + g;  // key 2t; key 2t + 1 is v0 + LD
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      SplitFrag<2> b;
      const float y[2] = {v0[dt * 8], v0[LD + dt * 8]};
      b.set(y);
      mma_1688_3xtf32(acc[dt], a, b);
    }
  }
}


// The forward's products in fp32, as 3xTF32 on m16n8k8. Up to DP = 80
// it holds this warp's split Q fragments in registers; from DP = 128 those
// would take 256 registers or more beside the accumulator, so it reads
// them from the block's Q tile and splits them at each use.
template <int DP>
struct FwdMath {
  static constexpr bool kCached = DP <= 80;
  SplitFrag<4> q[kCached ? DP / 8 : 1];
  const float* sq = nullptr;
  int row0 = 0;
  __device__ __forceinline__ void load_q(const float* tile, int row, int lane) {
    if constexpr (kCached) {
      load_a_frags_f32<DP>(q, tile, row, lane >> 2, lane & 3);
    } else {
      sq = tile;
      row0 = row;
    }
  }
  // S = Q K^T
  template <int NT>
  __device__ __forceinline__ void scores(float (&s)[NT][4], const float* tile, int lane) const {
    if constexpr (kCached) gemm_abt_f32<DP, NT>(s, q, tile, lane >> 2, lane & 3);
    else gemm_abt_f32_smem<DP, NT>(s, sq, row0, tile, lane >> 2, lane & 3);
  }
};

}  // namespace mobi_flash
