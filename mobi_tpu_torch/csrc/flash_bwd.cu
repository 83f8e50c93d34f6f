// Flash-attention backward in fp32, as two kernels with no reduction across
// blocks (so the gradients are the same from run to run); the bf16 K4 and K5
// are flash_bwd_sm90.cu's wgmma kernels:
//
//   K4, flash_bwd_dq_kernel:  dQ = dS K, one block per (batch * head, 64
//       query rows), streaming K and V in 64-key tiles;
//   K5, flash_bwd_dkv_kernel: dV = P^T dO and dK = dS^T Q, one block per
//       (batch * head, 64 keys), streaming Q, dO, lse and delta in 64-row
//       tiles;
//
// where, per (batch, head), with scale = d^-1/2 and the forward's lse,
//   P  = exp(Q K^T * scale - lse)            (recomputed, never stored)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale, delta = rowsum(dO * O),
// with dS and P left unrounded, as the plain versions keep them in fp32.
// Every product is 3xTF32 on mma.sync m16n8k8 (flash_common.cuh), accurate
// to fp32; the A fragments are read from the block's own shared tile and
// split at each use, which keeps the split fragments of two 16 x DP slabs
// out of the registers. P takes one ex2.approx per logit, with log2(e)
// folded into the scale and into lse. The streamed tiles are double-buffered
// with cp.async. The head dim is zero-padded in shared memory only to DP,
// the smallest of 48, 64, 80 and 128 that holds it, which leaves every
// product unchanged. Ragged edges: keys >= nk
// get P = 0 in K4, query rows >= nq get lse = +inf (so P = 0) in K5, and
// rows past the end are never stored.
//
// q, k, v, dO are fp32 [B, N, H, D] strided views (unit stride in D); lse
// and delta fp32 [B, H, Nq]; dq, dk, dv fp32 [B, N, H, D]. The design note
// is in mobi_tpu_torch/ops/flash_attention.py.
#include "flash_common.cuh"

namespace {

using namespace mobi_flash;

constexpr int kRows = 64;   // rows a block owns: queries in K4, keys in K5
constexpr int kTile = 64;   // rows of each streamed tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
static_assert(kRows == kWarps * 16, "one m16 row slab per warp");

// Tensor order of the stride table: q, k, v, dO, then the outputs (dq; or
// dk, dv).
struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  float* out0;
  float* out1;
  int heads, nq, nk, d;
  long long s[6][3];  // (batch, n, head) strides in elements
  float scale_log2, scale;
};

// Base pointer of tensor i for (b, h).
template <typename P>
__device__ __forceinline__ P* at(P* p, const BwdArgs& a, int i, int b, int h) {
  return p + b * a.s[i][0] + h * a.s[i][2];
}

template <int DP> constexpr int dq_smem_bytes() {
  return (2 * kRows + 4 * kTile) * tile_ld<DP, float>() * static_cast<int>(sizeof(float));
}
template <int DP> constexpr int dkv_smem_bytes() {
  return dq_smem_bytes<DP>() + 4 * kTile * 4;
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int LD = tile_ld<DP, float>();
  constexpr int TILE = kTile * LD;
  constexpr int NT = kTile / 8;
  constexpr int DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sdo = sq + kRows * LD;
  float* sk = sdo + kRows * LD;  // two buffers
  float* sv = sk + 2 * TILE;     // two buffers

  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int m0 = blockIdx.x * kRows;
  const int nq = a.nq, nk = a.nk, d = a.d;
  const float* kb = at(a.k, a, 1, b, h);
  const float* vb = at(a.v, a, 2, b, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, t2 = t * 2;
  const int n_tiles = (nk + kTile - 1) / kTile;

  load_tile_async<DP, kRows, kThreads>(sq, at(a.q, a, 0, b, h), a.s[0][1], m0, nq, d);
  load_tile_async<DP, kRows, kThreads>(sdo, at(a.dout, a, 3, b, h), a.s[3][1], m0, nq, d);
  load_tile_async<DP, kTile, kThreads>(sk, kb, a.s[1][1], 0, nk, d);
  load_tile_async<DP, kTile, kThreads>(sv, vb, a.s[2][1], 0, nk, d);
  cp_async_commit();

  // rows g and g + 8 of this warp's slab: lse in log2 units, and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    const long long i = static_cast<long long>(blockIdx.y) * nq + row;
    lse2[r] = row < nq ? a.lse[i] * kLog2e : 0.f;
    dlt[r] = row < nq ? a.delta[i] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j has landed; every warp is done with tile j - 1
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      load_tile_async<DP, kTile, kThreads>(sk + nb * TILE, kb, a.s[1][1], (j + 1) * kTile, nk, d);
      load_tile_async<DP, kTile, kThreads>(sv + nb * TILE, vb, a.s[2][1], (j + 1) * kTile, nk, d);
      cp_async_commit();
    }
    const float* kt = sk + (j & 1) * TILE;
    const int n0 = j * kTile;
    float s[NT][4], dp[NT][4];
    gemm_abt_f32_smem<DP, NT>(s, sq, warp * 16, kt, g, t);                     // S = Q K^T
    gemm_abt_f32_smem<DP, NT>(dp, sdo, warp * 16, sv + (j & 1) * TILE, g, t);  // dP = dO V^T
    const bool ragged = n0 + kTile > nk;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float p = exp2_approx(fmaf(s[nt][jj], a.scale_log2, -lse2[jj >> 1]));
        if (ragged && n0 + nt * 8 + t2 + (jj & 1) >= nk) p = 0.f;
        s[nt][jj] = p * (dp[nt][jj] - dlt[jj >> 1]) * a.scale;  // dS
      }
    }
    gemm_pb_f32<DP, NT>(acc, s, kt, g, t);  // dQ += dS K
  }
  const float one[2] = {1.f, 1.f};
  store_rows<DP>(at(a.out0, a, 4, b, h), a.s[4][1], acc, one, m0 + warp * 16, nq, d, g, t2);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int LD = tile_ld<DP, float>();
  constexpr int TILE = kTile * LD;
  constexpr int NT = kTile / 8;
  constexpr int DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);
  float* sv = sk + kRows * LD;
  float* sq = sv + kRows * LD;   // two buffers
  float* sdo = sq + 2 * TILE;    // two buffers
  float* slse = sdo + 2 * TILE;  // two buffers of kTile
  float* sdl = slse + 2 * kTile;  // two buffers of kTile

  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int n0 = blockIdx.x * kRows;
  const int nq = a.nq, nk = a.nk, d = a.d;
  const float* qb = at(a.q, a, 0, b, h);
  const float* dob = at(a.dout, a, 3, b, h);
  const float* lseb = a.lse + static_cast<long long>(blockIdx.y) * nq;
  const float* dlb = a.delta + static_cast<long long>(blockIdx.y) * nq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, t2 = t * 2;
  const int n_tiles = (nq + kTile - 1) / kTile;

  // the query rows of tile i: lse in log2 units (+inf past the end, so P = 0
  // there) and delta, written by plain stores that the next barrier publishes
  auto load_stats = [&](int i, int buf) {
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int row = i * kTile + r;
      slse[buf * kTile + r] = row < nq ? lseb[row] * kLog2e : INFINITY;
      sdl[buf * kTile + r] = row < nq ? dlb[row] : 0.f;
    }
  };
  load_tile_async<DP, kRows, kThreads>(sk, at(a.k, a, 1, b, h), a.s[1][1], n0, nk, d);
  load_tile_async<DP, kRows, kThreads>(sv, at(a.v, a, 2, b, h), a.s[2][1], n0, nk, d);
  load_tile_async<DP, kTile, kThreads>(sq, qb, a.s[0][1], 0, nq, d);
  load_tile_async<DP, kTile, kThreads>(sdo, dob, a.s[3][1], 0, nq, d);
  cp_async_commit();
  load_stats(0, 0);

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[dt][c] = dv[dt][c] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1
    if (i + 1 < n_tiles) {
      const int nb = (i + 1) & 1;
      load_tile_async<DP, kTile, kThreads>(sq + nb * TILE, qb, a.s[0][1], (i + 1) * kTile, nq, d);
      load_tile_async<DP, kTile, kThreads>(sdo + nb * TILE, dob, a.s[3][1], (i + 1) * kTile, nq, d);
      cp_async_commit();
      load_stats(i + 1, nb);
    }
    const int buf = i & 1;
    const float* qt = sq + buf * TILE;
    const float* dot = sdo + buf * TILE;
    const float* tl = slse + buf * kTile;
    const float* td = sdl + buf * kTile;
    float pt[NT][4], dst[NT][4];
    gemm_abt_f32_smem<DP, NT>(pt, sk, warp * 16, qt, g, t);    // S^T = K Q^T
    gemm_abt_f32_smem<DP, NT>(dst, sv, warp * 16, dot, g, t);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = nt * 8 + t2 + (jj & 1);  // query row within the tile
        const float p = exp2_approx(fmaf(pt[nt][jj], a.scale_log2, -tl[c]));
        pt[nt][jj] = p;
        dst[nt][jj] = p * (dst[nt][jj] - td[c]) * a.scale;  // dS^T
      }
    }
    gemm_pb_f32<DP, NT>(dv, pt, dot, g, t);  // dV += P^T dO
    gemm_pb_f32<DP, NT>(dk, dst, qt, g, t);  // dK += dS^T Q
  }
  const float one[2] = {1.f, 1.f};
  store_rows<DP>(at(a.out0, a, 4, b, h), a.s[4][1], dk, one, n0 + warp * 16, nk, d, g, t2);
  store_rows<DP>(at(a.out1, a, 5, b, h), a.s[5][1], dv, one, n0 + warp * 16, nk, d, g, t2);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, dim3 grid, const BwdArgs& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                  const float* delta, void* out0, void* out1, int heads, int nq, int nk, int d,
                  const long long* strides, int n_tensors, float scale) {
  BwdArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.out0 = static_cast<float*>(out0);
  a.out1 = static_cast<float*>(out1);
  a.heads = heads;
  a.nq = nq;
  a.nk = nk;
  a.d = d;
  for (int i = 0; i < n_tensors; ++i)
    for (int j = 0; j < 3; ++j) a.s[i][j] = strides[3 * i + j];
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  return a;
}

}  // namespace

// q, k, v, dout: fp32 [batch, n, heads, d] with unit stride in d, d a
// multiple of 8 up to 128; lse,
// delta: contiguous fp32 [batch, heads, nq]; dq: fp32 [batch, nq, heads, d].
// strides: 15 element strides, (batch, n, head) of q, k, v, dout, dq in turn.
// scale: d^-1/2. Returns the cudaError_t of the launch.
extern "C" int mobi_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 void* dq_out, int batch, int heads, int nq, int nk, int d,
                                 const long long* strides, float scale, void* stream) {
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, dq_out, nullptr, heads, nq, nk, d, strides, 5, scale);
  const dim3 grid((nq + kRows - 1) / kRows, batch * heads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded_head_dim(d)) {
    case 48: return launch(flash_bwd_dq_kernel<48>, dq_smem_bytes<48>(), grid, a, st);
    case 64: return launch(flash_bwd_dq_kernel<64>, dq_smem_bytes<64>(), grid, a, st);
    case 80: return launch(flash_bwd_dq_kernel<80>, dq_smem_bytes<80>(), grid, a, st);
    case 128: return launch(flash_bwd_dq_kernel<128>, dq_smem_bytes<128>(), grid, a, st);
    default: return cudaErrorInvalidValue;
  }
}

// As mobi_flash_bwd_dq, with dk and dv (fp32 [batch, nk, heads, d]) as the
// outputs and 18 strides: q, k, v, dout, dk, dv.
extern "C" int mobi_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  void* dk, void* dv, int batch, int heads, int nq, int nk,
                                  int d, const long long* strides, float scale, void* stream) {
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, dk, dv, heads, nq, nk, d, strides, 6, scale);
  const dim3 grid((nk + kRows - 1) / kRows, batch * heads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded_head_dim(d)) {
    case 48: return launch(flash_bwd_dkv_kernel<48>, dkv_smem_bytes<48>(), grid, a, st);
    case 64: return launch(flash_bwd_dkv_kernel<64>, dkv_smem_bytes<64>(), grid, a, st);
    case 80: return launch(flash_bwd_dkv_kernel<80>, dkv_smem_bytes<80>(), grid, a, st);
    case 128: return launch(flash_bwd_dkv_kernel<128>, dkv_smem_bytes<128>(), grid, a, st);
    default: return cudaErrorInvalidValue;
  }
}
