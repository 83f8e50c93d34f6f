// Flash-attention forward in fp32 for Hopper (sm_90a) on mma.sync: non-causal
// softmax(Q K^T * d^-1/2) V over [B, N, H, D] strided views (K1), and with
// the per-row logsumexp that the backward needs (K3). The bf16 K1 and K3 are
// flash_fwd_sm90.cu's wgmma kernel.
//
// One block of 8 warps owns 128 query rows (16 per warp) of one (batch, head)
// and streams the keys and values through shared memory in tiles of 64,
// double-buffered: cp.async brings tile j + 1 in while the warps compute on
// tile j. Both products run on the tensor cores with fp32 accumulation as
// 3xTF32 on m16n8k8 (flash_common.cuh), which keeps the products accurate to
// fp32, with P left unrounded as the plain version leaves it. The online max,
// the running sum and the output accumulator stay in fp32 registers. The
// softmax works in base 2 with log2(e) folded into the scale, which cancels
// exactly in acc / l; the logsumexp, when asked for, is (m + log2 l) * ln 2
// in natural units, written as fp32 [B, H, Nq].
//
// The head dim is padded with zeros to DK (flash_common.cuh's head_dims:
// 48, 64, 80, 128, 160, 192 or 256) for the contraction; the scale uses the
// true d. From DK = 128 the Q fragments are read from shared memory at each
// use (FwdMath). Above 128 a block accumulates one slice of DV output
// columns (blockIdx.z; 80 or 64 wide) and streams only that slice of V, with
// Q and K at the full DK; every slice recomputes the same logits, and slice
// 0 writes the lse. Where Q, two K tiles and two V slices of 64 keys would
// pass a block's shared memory (DK = 192 and 256), the key tiles are 32.
// Ragged edges in N are masked: out-of-range keys get -inf logits and zero
// values, and out-of-range query rows are never stored.
//
// The design note (what bounds this kernel and why it is shaped so) is in
// mobi_tpu_torch/ops/flash_attention.py, beside the plain PyTorch version.
#include "flash_common.cuh"

namespace {

using namespace mobi_flash;

constexpr int kBlockM = 128;  // query rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
static_assert(kBlockM == kWarps * 16, "one m16 row slab per warp");

using T = float;

// Q, then K and a V slice in two buffers each, at BN keys a tile.
template <int DK, int DV, int BN>
__host__ __device__ constexpr int smem_bytes() {
  return (kBlockM * tile_ld<DK, T>() + 2 * BN * (tile_ld<DK, T>() + tile_ld<DV, T>())) * static_cast<int>(sizeof(T));
}

// Keys per streamed tile: 64, or 32 where that does not fit.
template <int DK, int DV>
__host__ __device__ constexpr int block_n() { return smem_bytes<DK, DV, 64>() <= kMaxSmem ? 64 : 32; }

template <int DK, int DV, bool LSE>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     int heads, int nq, int nk,
                     int d, long long q_sb, long long q_sn, long long q_sh,
                     long long k_sb, long long k_sn, long long k_sh,
                     long long v_sb, long long v_sn, long long v_sh,
                     long long o_sb, long long o_sn, long long o_sh,
                     float scale_log2) {
  constexpr int kBlockN = block_n<DK, DV>();  // keys per streamed tile
  constexpr int LD = tile_ld<DK, T>();
  constexpr int TILE = kBlockN * LD;
  constexpr int VTILE = kBlockN * tile_ld<DV, T>();
  constexpr int NT = kBlockN / 8;  // 8-key column tiles of S
  constexpr int DT = DV / 8;       // 8-wide column tiles of this block's O slice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + kBlockM * LD;  // two buffers
  T* sv = sk + 2 * TILE;  // two buffers of the V slice

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int m0 = blockIdx.x * kBlockM;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const int c0 = blockIdx.z * DV, dv = d - c0;  // this block's output columns
  const T* vb = v + b * v_sb + h * v_sh + c0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int n_tiles = (nk + kBlockN - 1) / kBlockN;

  load_tile_async<DK, kBlockM, kThreads>(sq, qb, q_sn, m0, nq, d);
  load_tile_async<DK, kBlockN, kThreads>(sk, kb, k_sn, 0, nk, d);
  load_tile_async<DV, kBlockN, kThreads>(sv, vb, v_sn, 0, nk, dv);
  cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  // rows g and g + 8 of this warp's slab, in log2 units of the scaled logits
  float m_i[2] = {-1e30f, -1e30f};
  float l_i[2] = {0.f, 0.f};  // this thread's share of the running sum
  FwdMath<DK> math;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j has landed; every warp is done with tile j - 1
    if (j == 0) math.load_q(sq, warp * 16, lane);  // Q's fragments (in registers up to DK = 80)
    if (j + 1 < n_tiles) {  // the next tile streams in under this one's math
      const int nb = (j + 1) & 1;
      load_tile_async<DK, kBlockN, kThreads>(sk + nb * TILE, kb, k_sn, (j + 1) * kBlockN, nk, d);
      load_tile_async<DV, kBlockN, kThreads>(sv + nb * VTILE, vb, v_sn, (j + 1) * kBlockN, nk, dv);
      cp_async_commit();
    }

    float s[NT][4];  // S = Q K^T
    math.scores(s, sk + (j & 1) * TILE, lane);
    float alpha[2];
    online_softmax<NT>(s, m_i, l_i, alpha, j * kBlockN, nk, t2, scale_log2);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    gemm_pb_f32<DV, NT>(acc, s, sv + (j & 1) * VTILE, g, lane & 3);  // O += P V, P unrounded
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
    if (LSE && blockIdx.z == 0) {
      const int row = m0 + warp * 16 + g + 8 * r;
      if (t2 == 0 && row < nq)
        lse[static_cast<long long>(blockIdx.y) * nq + row] = (m_i[r] + log2f(l)) * 0.6931471805599453f;
    }
  }
  store_rows<DV>(o + b * o_sb + h * o_sh + c0, o_sn, acc, inv, m0 + warp * 16, nq, dv, g, t2);
}

template <int DK, int DV, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int batch, int heads, int nq, int nk, int d,
                   const long long* s, float scale_log2, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<DK, DV, block_n<DK, DV>()>();
  static_assert(kSmem <= kMaxSmem, "the tiles fit a block's shared memory");
  // above 48 KB only as opted-in dynamic shared memory
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DK, DV, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kBlockM - 1) / kBlockM, batch * heads, DK / DV);
  flash_fwd_kernel<DK, DV, LSE><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse,
      heads, nq, nk, d, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
      s[9], s[10], s[11], scale_log2);
  return cudaGetLastError();
}

template <bool LSE>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
                     int batch, int heads, int nq, int nk, int d, const long long* s,
                     float scale_log2, cudaStream_t st) {
  switch (head_dims(d).dk) {
    case 48: return launch<48, 48, LSE>(q, k, v, o, lse, batch, heads, nq, nk, d, s, scale_log2, st);
    case 64: return launch<64, 64, LSE>(q, k, v, o, lse, batch, heads, nq, nk, d, s, scale_log2, st);
    case 80: return launch<80, 80, LSE>(q, k, v, o, lse, batch, heads, nq, nk, d, s, scale_log2, st);
    case 128: return launch<128, 128, LSE>(q, k, v, o, lse, batch, heads, nq, nk, d, s, scale_log2, st);
    case 160: return launch<160, 80, LSE>(q, k, v, o, lse, batch, heads, nq, nk, d, s, scale_log2, st);
    case 192: return launch<192, 64, LSE>(q, k, v, o, lse, batch, heads, nq, nk, d, s, scale_log2, st);
    case 256: return launch<256, 64, LSE>(q, k, v, o, lse, batch, heads, nq, nk, d, s, scale_log2, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: [batch, n, heads, d] fp32 with unit stride in d, d a multiple
// of 8 up to 256; strides in elements, (batch, n, head) for each of q, k, v,
// o in turn. lse: a contiguous fp32 [batch, heads, nq] that receives the
// natural-log logsumexp of each query row's scaled logits (K3), or null (K1).
// Returns the cudaError_t of the launch.
extern "C" int mobi_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int batch, int heads, int nq,
                              int nk, int d, long long q_sb, long long q_sn,
                              long long q_sh, long long k_sb, long long k_sn,
                              long long k_sh, long long v_sb, long long v_sn,
                              long long v_sh, long long o_sb, long long o_sn,
                              long long o_sh, float scale_log2, void* stream) {
  const long long s[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                           v_sb, v_sn, v_sh, o_sb, o_sn, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lse == nullptr ? dispatch<false>(q, k, v, o, nullptr, batch, heads, nq, nk, d, s, scale_log2, st)
                        : dispatch<true>(q, k, v, o, lse, batch, heads, nq, nk, d, s, scale_log2, st);
}
