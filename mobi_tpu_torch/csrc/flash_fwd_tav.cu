// Flash-attention forward with a transposed output accumulator (K2) in
// fp32, for Hopper (sm_90a) on mma.sync: the same function as K1, non-causal
// softmax(Q K^T * d^-1/2) V over [B, N, H, D] strided views, for the head
// dims below 64 that K2 serves (the UNet's d = 40), padded to DP = 48 or 64.
// bf16 K2 is flash_fwd_sm90.cu's wgmma kernel.
//
// What makes it K2: the second product runs as O^T[D, TQ] += V^T[D, TK] .
// P^T[TK, TQ], with the head dim as the mma's M dimension (DP / 16 m16
// tiles; rows past d are the zero padding and are dropped at the store) and
// each warp's 16 queries as two n8 tiles, as 3xTF32 on m16n8k8. V sits in
// shared memory as [TK, D] rows, so the V^T A fragments come from scalar
// reads; the scores' C fragments of S = Q K^T are P^T's B fragments as they
// stand once the contraction runs over the 8 keys of a tile in the order
// 2t <-> t, 2t + 1 <-> t + 4 (flash_common.cuh).
//
// The per-query rescale alpha and the final 1 / l now scale the
// accumulator's columns, while a query's row statistics live in the quad
// g = query % 8 of S's layout (as alpha[query / 8]); every key tile and the
// end fetch the four values a thread's columns need with __shfl_sync.
// O^T is staged through the warp's own 16 rows of the Q tile's shared
// memory (free once Q is in registers) as O rows, so the global stores stay
// 16-byte and row-contiguous.
//
// Blocks, tiles, double buffering, the base-2 online softmax and the masking
// of ragged N are those of flash_fwd.cu. The design note is in
// mobi_tpu_torch/ops/flash_attention.py, beside the plain PyTorch version.
#include "flash_common.cuh"

namespace {

using namespace mobi_flash;

constexpr int kBlockM = 128;  // query rows per block
constexpr int kBlockN = 64;   // keys per streamed tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
static_assert(kBlockM == kWarps * 16, "one m16 row slab per warp");

using T = float;
template <int DP>
constexpr int smem_bytes() { return (kBlockM + 4 * kBlockN) * tile_ld<DP, T>() * static_cast<int>(sizeof(T)); }

// acc_t[MT][2][4]: O^T tile (d rows mt * 16 .., queries nq * 8 ..) of this
// warp; C layout: c0, c1 (d row g, queries t2, t2 + 1), c2, c3 (d row g + 8).

// fp32: O^T += V^T P^T as 3xTF32 on m16n8k8, P unrounded; k index t is key
// 2t of the 8-key tile and t + 4 is key 2t + 1, for both operands.
template <int DP, int NT>
__device__ __forceinline__ void gemm_vt_pt(float (&acc)[DP / 16][2][4], const float (&p)[NT][4],
                                           const float* tile, int lane) {
  constexpr int LD = tile_ld<DP, float>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {  // 8 keys
    SplitFrag<2> b[2];
    const float x0[2] = {p[nt][0], p[nt][1]}, x1[2] = {p[nt][2], p[nt][3]};
    b[0].set(x0);
    b[1].set(x1);
    const float* v0 = tile + (nt * 8 + 2 * t) * LD + g;  // key 2t; key 2t + 1 is v0 + LD
#pragma unroll
    for (int mt = 0; mt < DP / 16; ++mt) {
      SplitFrag<4> a;
      const float y[4] = {v0[mt * 16], v0[mt * 16 + 8], v0[LD + mt * 16], v0[LD + mt * 16 + 8]};
      a.set(y);
      mma_1688_3xtf32(acc[mt][0], a, b[0]);
      mma_1688_3xtf32(acc[mt][1], a, b[1]);
    }
  }
}

// The values of a per-row statistic (x[0] for rows 0-7, x[1] for rows 8-15
// of the warp's slab, held by the quad g = row % 8) at the accumulator's
// columns: out[nq][e] is the value of query nq * 8 + t2 + e.
__device__ __forceinline__ void stats_at_columns(float (&out)[2][2], const float (&x)[2], int t2) {
#pragma unroll
  for (int nq = 0; nq < 2; ++nq) {
    out[nq][0] = __shfl_sync(0xffffffffu, x[nq], 4 * t2);
    out[nq][1] = __shfl_sync(0xffffffffu, x[nq], 4 * (t2 + 1));
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_tav_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         int heads, int nq, int nk, int d,
                         long long q_sb, long long q_sn, long long q_sh,
                         long long k_sb, long long k_sn, long long k_sh,
                         long long v_sb, long long v_sn, long long v_sh,
                         long long o_sb, long long o_sn, long long o_sh,
                         float scale_log2) {
  static_assert(FwdMath<DP>::kCached, "the O staging reuses the Q tile, so Q must stay in registers");
  constexpr int LD = tile_ld<DP, T>();
  constexpr int TILE = kBlockN * LD;
  constexpr int NT = kBlockN / 8;  // 8-key column tiles of S
  constexpr int MT = DP / 16;      // 16-row d tiles of O^T
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + kBlockM * LD;  // two buffers
  T* sv = sk + 2 * TILE;      // two buffers

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int m0 = blockIdx.x * kBlockM;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int n_tiles = (nk + kBlockN - 1) / kBlockN;

  load_tile_async<DP, kBlockM, kThreads>(sq, qb, q_sn, m0, nq, d);
  load_tile_async<DP, kBlockN, kThreads>(sk, kb, k_sn, 0, nk, d);
  load_tile_async<DP, kBlockN, kThreads>(sv, vb, v_sn, 0, nk, d);
  cp_async_commit();

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nq2 = 0; nq2 < 2; ++nq2) acc[mt][nq2][0] = acc[mt][nq2][1] = acc[mt][nq2][2] = acc[mt][nq2][3] = 0.f;
  float m_i[2] = {-1e30f, -1e30f};  // rows g and g + 8, log2 units
  float l_i[2] = {0.f, 0.f};
  FwdMath<DP> math;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j has landed; every warp is done with tile j - 1
    if (j == 0) math.load_q(sq, warp * 16, lane);  // Q stays in registers
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      load_tile_async<DP, kBlockN, kThreads>(sk + nb * TILE, kb, k_sn, (j + 1) * kBlockN, nk, d);
      load_tile_async<DP, kBlockN, kThreads>(sv + nb * TILE, vb, v_sn, (j + 1) * kBlockN, nk, d);
      cp_async_commit();
    }

    float s[NT][4];  // S = Q K^T
    math.scores(s, sk + (j & 1) * TILE, lane);
    float alpha[2];
    online_softmax<NT>(s, m_i, l_i, alpha, j * kBlockN, nk, t2, scale_log2);
    float col_alpha[2][2];  // alpha at this thread's accumulator columns
    stats_at_columns(col_alpha, alpha, t2);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nq2 = 0; nq2 < 2; ++nq2) {
        acc[mt][nq2][0] *= col_alpha[nq2][0];
        acc[mt][nq2][1] *= col_alpha[nq2][1];
        acc[mt][nq2][2] *= col_alpha[nq2][0];
        acc[mt][nq2][3] *= col_alpha[nq2][1];
      }
    gemm_vt_pt<DP, NT>(acc, s, sv + (j & 1) * TILE, lane);  // O^T += V^T P^T
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
  }
  float col_inv[2][2];
  stats_at_columns(col_inv, inv, t2);

  // O^T -> O rows in this warp's 16 rows of the Q tile, then 16-byte stores
  T* stage = sq + warp * 16 * LD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nq2 = 0; nq2 < 2; ++nq2)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int row = nq2 * 8 + t2 + (jj & 1), col = mt * 16 + g + 8 * (jj >> 1);
        const float val = acc[mt][nq2][jj] * col_inv[nq2][jj & 1];
        stage[row * LD + col] = val;
      }
  __syncwarp();
  T* ob = o + b * o_sb + h * o_sh;
  const int chunks = d / kVec;  // d is a multiple of 8
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks, c = (i % chunks) * kVec;
    const int row = m0 + warp * 16 + r;
    if (row < nq)
      *reinterpret_cast<uint4*>(ob + row * o_sn + c) = *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                   int nq, int nk, int d, const long long* s, float scale_log2, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<DP>();
  // above 48 KB only as opted-in dynamic shared memory
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tav_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kBlockM - 1) / kBlockM, batch * heads);
  flash_fwd_tav_kernel<DP><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), heads, nq, nk, d, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
      s[8], s[9], s[10], s[11], scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [batch, n, heads, d] fp32 with unit stride in d and d a
// multiple of 8 below 64; o's rows 16-byte aligned. Strides in
// elements, (batch, n, head) for each of q, k, v, o in turn. Returns the
// cudaError_t of the launch.
extern "C" int mobi_flash_fwd_tav(const void* q, const void* k, const void* v, void* o,
                                  int batch, int heads, int nq, int nk, int d,
                                  long long q_sb, long long q_sn, long long q_sh,
                                  long long k_sb, long long k_sn, long long k_sh,
                                  long long v_sb, long long v_sn, long long v_sh,
                                  long long o_sb, long long o_sn, long long o_sh,
                                  float scale_log2, void* stream) {
  const int dp = padded_head_dim(d);
  if (dp != 48 && dp != 64) return cudaErrorInvalidValue;
  const long long s[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                           v_sb, v_sn, v_sh, o_sb, o_sn, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dp == 48 ? launch<48>(q, k, v, o, batch, heads, nq, nk, d, s, scale_log2, st)
                  : launch<64>(q, k, v, o, batch, heads, nq, nk, d, s, scale_log2, st);
}
