// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): mma.sync m16n8k16 on bf16 with fp32 accumulators, ldmatrix
// fragment reads, cp.async tile loads and the base-2 exponential.
//
// Fragment layouts of mma.m16n8k16.row.col (g = lane / 4, t2 = 2 * (lane % 4)):
//   A 16x16: a0 (row g, cols t2, t2+1), a1 (row g+8, same cols),
//            a2 (row g, cols t2+8, t2+9), a3 (row g+8, cols t2+8, t2+9)
//   B 16x8:  b0 (k rows t2, t2+1, col g), b1 (k rows t2+8, t2+9, col g)
//   C 16x8:  c0, c1 (row g, cols t2, t2+1), c2, c3 (row g+8, same cols)
// so the C tiles of two neighbouring 8-column tiles, packed to bf16, are the
// A fragment of one 16-deep k-step.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mobi_flash {

constexpr float kLog2e = 1.4426950408889634f;

// Row stride of a shared-memory tile: +8 elements keep the 8 rows that one
// ldmatrix 8x8 matrix (or one fragment read) touches in distinct banks.
template <int DP> __host__ __device__ constexpr int tile_ld() { return DP + 8; }

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l names row (l % 8) of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Start copying rows [row0, row0 + ROWS) of a row-strided [n, d] matrix into
// a shared tile with THREADS threads; rows >= n and columns in [d, DP) are
// zero-filled. d is a multiple of 8, so each 16-byte chunk is wholly in or
// out of range.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long row_stride, int row0, int n, int d) {
  constexpr int kChunks = DP / 8;
  constexpr int LD = tile_ld<DP>();
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool valid = row0 + r < n && c < d;
    cp_async_16(dst + r * LD + c, valid ? src + (row0 + r) * row_stride + c : src, valid);
  }
}

// The A fragments of a warp's 16-row slab of a shared tile, for every
// 16-deep k-step of the (padded) head dim.
template <int DP>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[DP / 16][4], const __nv_bfloat16* tile,
                                             int row0, int g, int t2) {
  constexpr int LD = tile_ld<DP>();
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const __nv_bfloat16* p = tile + (row0 + g) * LD + ks * 16 + t2;
    a[ks][0] = ld_u32(p);
    a[ks][1] = ld_u32(p + 8 * LD);
    a[ks][2] = ld_u32(p + 8);
    a[ks][3] = ld_u32(p + 8 * LD + 8);
  }
}

// C[16 x NT*8] = A[16 x DP] B^T, where B's rows are the 8-row groups of a
// shared tile (rows = columns of C, contiguous in the head dim): S = Q K^T,
// dP = dO V^T and their transposes in the backward.
template <int DP, int NT>
__device__ __forceinline__ void gemm_abt(float (&c)[NT][4], const uint32_t (&a)[DP / 16][4],
                                         const __nv_bfloat16* tile, int lane) {
  constexpr int LD = tile_ld<DP>();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; nt += 2) {
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t b[4];
      ldmatrix_x4(b, tile + ((nt + (lane >> 4)) * 8 + (lane & 7)) * LD + ks * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_16816(c[nt], a[ks], b[0], b[1]);
      mma_16816(c[nt + 1], a[ks], b[2], b[3]);
    }
  }
}

// acc[16 x DP] += P[16 x NT*8] B, P given as C tiles (rounded to bf16 here)
// and B the first NT*8 rows of a shared [rows, DP] tile, read transposed by
// ldmatrix.trans: O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q.
template <int DP, int NT>
__device__ __forceinline__ void gemm_pb(float (&acc)[DP / 8][4], const float (&p)[NT][4],
                                        const __nv_bfloat16* tile, int lane) {
  constexpr int LD = tile_ld<DP>();
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t pa[4] = {pack_bf16x2(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16x2(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dt = 0; dt < DP / 8; dt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                               (dt + (lane >> 4)) * 8);
      mma_16816(acc[dt], pa, b[0], b[1]);
      mma_16816(acc[dt + 1], pa, b[2], b[3]);
    }
  }
}

// Write a warp's 16 x DP fp32 accumulator (scaled by inv[r] for rows g, g+8)
// as bf16 rows of a row-strided output; rows >= n and columns >= d are
// skipped.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long row_stride,
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
        *reinterpret_cast<__nv_bfloat162*>(out + row * row_stride + col) =
            __floats2bfloat162_rn(acc[dt][2 * r] * inv[r], acc[dt][2 * r + 1] * inv[r]);
    }
  }
}

}  // namespace mobi_flash
