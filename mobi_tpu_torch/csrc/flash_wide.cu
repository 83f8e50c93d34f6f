// Flash attention at head dims above 256, bf16 and fp32, on mma.sync: the
// forward K1 and, with its lse output, K3, and the backward K4 (dq) and K5
// (dk, dv). The kernels of flash_fwd_sm90.cu, flash_fwd.cu, flash_bwd_sm90.cu
// and flash_bwd.cu hold a whole operand (Q; Q and dO; K and V) at the full
// head dim in shared memory, which passes a block's 227 KB above 256; these
// stream every operand through shared memory in chunks of 64 columns, so no
// block holds more than four 64 x 64 tiles whatever the head dim.
//
// The head dim is cut in two ways (flash_common.cuh's head_dims: d above 256
// rounds up to a multiple of 64, in slices of 64):
//   * the contractions over it, S = Q K^T and dP = dO V^T, accumulate in
//     registers chunk by chunk: the block loads chunk c of each operand into
//     its shared tiles, adds its products, and moves to chunk c + 1;
//   * the outputs' columns are a grid axis (blockIdx.z), as in the other
//     kernels above 128: a block accumulates one 64-column slice of O (dQ;
//     dK and dV), streaming only that slice of V (K; Q and dO) for the second
//     product. Every slice recomputes the logits, and slice 0 writes the lse.
//
// Forward: one block of 4 warps owns 64 query rows (16 per warp) and walks
// the keys in tiles of 64 with the online softmax of flash_common.cuh. K4:
// a block owns 64 query rows and walks the keys; K5: a block owns 64 keys
// and walks the queries, with lse (+inf past nq, so P = 0 there) and delta
// of each query tile in shared memory. Both recompute P = exp(S scale - lse)
// and dS = P (dP - delta) scale as flash_bwd.cu does.
//
// Every operand is converted to fp32 as it is loaded into shared memory, and
// every product runs on mma.sync m16n8k8 over tf32 with fp32 accumulation.
// In fp32 the products are 3xTF32 (each operand split into two tf32 halves),
// accurate to fp32, with P and dS unrounded as the plain versions keep them.
// In bf16 one tf32 product is exact, since a bf16 value is a tf32 value: the
// products are those of bf16 operands with fp32 accumulation, and P (before
// P V, and before P^T dO) and dS are rounded to bf16 first, as the JAX
// kernels and the plain versions round them. The loads are plain 16-byte
// loads with a barrier around each chunk: the simplest right design, not a
// fast one (PERF.md has its times).
//
// q, k, v, dO are [B, N, H, D] strided views (unit stride in D, 16-byte rows);
// lse and delta fp32 [B, H, Nq]; the outputs [B, N, H, D] in the input
// dtype. Rows and columns past the ends are zero-filled on load and never
// stored. The design note is in mobi_tpu_torch/ops/flash_attention.py.
#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace mobi_flash;

constexpr int kRows = 64;   // rows a block owns, and rows of every streamed tile
constexpr int kChunk = 64;  // head-dim columns of a chunk, and of an output slice
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
static_assert(kRows == kWarps * 16, "one m16 row slab per warp");
constexpr int LD = tile_ld<kChunk, float>();  // row stride of an fp32 shared tile
constexpr int TILE = kRows * LD;
constexpr int NT = kRows / 8;   // 8-column tiles of S over a tile of 64 rows
constexpr int DT = kChunk / 8;  // 8-column tiles of an output slice
constexpr int kFwdSmem = 3 * TILE * static_cast<int>(sizeof(float));
constexpr int kBwdSmem = 4 * TILE * static_cast<int>(sizeof(float));

__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4], const float*) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[8], const __nv_bfloat16*) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Rows [row0, row0 + 64) and columns [col0, col0 + 64) of a row-strided [n, d]
// matrix of T into an fp32 shared tile; rows >= n and columns >= d are
// zero-filled. d is a multiple of 8, so a 16-byte load is wholly in or out.
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* src, long long row_stride, int row0, int n,
                                           int col0, int d) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = kChunk / kVec;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    float v[kVec];
    if (row0 + r < n && col0 + c < d) {
      unpack(*reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + col0 + c), v,
             static_cast<const T*>(nullptr));
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = 0.f;
    }
    float4* out = reinterpret_cast<float4*>(dst + r * LD + c);
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j) out[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
}

// x as the input dtype would hold it: bf16 rounds (to nearest even), fp32
// keeps it.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, float>::value) return x;
  else return __bfloat162float(__float2bfloat16_rn(x));
}

// An A fragment in tf32: split into halves for 3xTF32 (kSplit), or taken as
// one exact tf32 value (bf16 data).
template <bool kSplit>
__device__ __forceinline__ void a_frag(const float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kSplit) split_tf32(x[i], hi[i], lo[i]);
    else hi[i] = to_tf32(x[i]);
  }
}

// c += a b on a 16x8x8 fragment: 3xTF32 (lo_a hi_b + hi_a lo_b + hi_a hi_b,
// as flash_common.cuh's mma_1688_3xtf32) or one tf32 product.
template <bool kSplit>
__device__ __forceinline__ void mma_frag(float (&c)[4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                         float b0, float b1) {
  if constexpr (kSplit) {
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(b0, bh0, bl0);
    split_tf32(b1, bh1, bl1);
    mma_1688_tf32(c, alo, bh0, bh1);
    mma_1688_tf32(c, ahi, bl0, bl1);
    mma_1688_tf32(c, ahi, bh0, bh1);
  } else {
    mma_1688_tf32(c, ahi, to_tf32(b0), to_tf32(b1));
  }
}

// c[16 x 64] += A B^T over one chunk: A the 16 rows from row0 of shared tile
// a, B the 64 rows of shared tile b (S = Q K^T, dP = dO V^T; K5: S^T = K Q^T).
template <bool kSplit>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const float* a, int row0, const float* b, int g,
                                        int t) {
#pragma unroll
  for (int ks = 0; ks < kChunk / 8; ++ks) {
    const float* pa = a + (row0 + g) * LD + ks * 8 + t;
    const float x[4] = {pa[0], pa[8 * LD], pa[4], pa[8 * LD + 4]};
    uint32_t hi[4], lo[4];
    a_frag<kSplit>(x, hi, lo);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* pb = b + (nt * 8 + g) * LD + ks * 8 + t;
      mma_frag<kSplit>(c[nt], hi, lo, pb[0], pb[4]);
    }
  }
}

// acc[16 x 64] += P B: P a warp's 16 x 64 C tiles (over the tile's rows of
// B), B the shared tile's 64 rows x 64 columns (O += P V, dQ += dS K,
// dV += P^T dO, dK += dS^T Q). k index t stands for row 2t, t + 4 for row
// 2t + 1 (flash_common.cuh).
template <bool kSplit>
__device__ __forceinline__ void mma_pb(float (&acc)[DT][4], const float (&p)[NT][4], const float* tile, int g,
                                       int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float x[4] = {p[nt][0], p[nt][2], p[nt][1], p[nt][3]};
    uint32_t hi[4], lo[4];
    a_frag<kSplit>(x, hi, lo);
    const float* v0 = tile + (nt * 8 + 2 * t) * LD + g;  // row 2t; row 2t + 1 is v0 + LD
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) mma_frag<kSplit>(acc[dt], hi, lo, v0[dt * 8], v0[LD + dt * 8]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

// The pointers, sizes and (batch, n, head) strides of a launch: tensors q, k,
// v, dO, then the outputs (o and lse; dq; or dk and dv).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* out0;
  void* out1;
  int heads, nq, nk, d;
  long long s[6][3];
  float scale_log2, scale;
};

template <typename T>
__device__ __forceinline__ const T* base(const void* p, const Args& a, int i, int b, int h) {
  return static_cast<const T*>(p) + b * a.s[i][0] + h * a.s[i][2];
}

template <typename T, bool LSE>
__global__ void __launch_bounds__(kThreads) flash_fwd_wide_kernel(const Args a) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sk = sq + TILE;
  float* sv = sk + TILE;

  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int m0 = blockIdx.x * kRows, c0 = blockIdx.z * kChunk;
  const int nq = a.nq, nk = a.nk, d = a.d;
  const T* qb = base<T>(a.q, a, 0, b, h);
  const T* kb = base<T>(a.k, a, 1, b, h);
  const T* vb = base<T>(a.v, a, 2, b, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, t2 = t * 2;

  float acc[DT][4];
  zero(acc);
  float m_i[2] = {-1e30f, -1e30f};  // rows g and g + 8, log2 units of the scaled logits
  float l_i[2] = {0.f, 0.f};        // this thread's share of the running sum
  for (int n0 = 0; n0 < nk; n0 += kRows) {
    float s[NT][4];  // S = Q K^T, chunk by chunk over the head dim
    zero(s);
    for (int c = 0; c < d; c += kChunk) {
      __syncthreads();  // every warp is done with the tiles
      load_chunk(sq, qb, a.s[0][1], m0, nq, c, d);
      load_chunk(sk, kb, a.s[1][1], n0, nk, c, d);
      __syncthreads();
      mma_abt<kSplit>(s, sq, warp * 16, sk, g, t);
    }
    float alpha[2];
    online_softmax<NT>(s, m_i, l_i, alpha, n0, nk, t2, a.scale_log2);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = round_to<T>(s[nt][j]);  // P in V's dtype
    __syncthreads();
    load_chunk(sv, vb, a.s[2][1], n0, nk, c0, d);  // this block's slice of V
    __syncthreads();
    mma_pb<kSplit>(acc, s, sv, g, t);  // O += P V
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
      if (t == 0 && row < nq)
        static_cast<float*>(a.out1)[static_cast<long long>(blockIdx.y) * nq + row] =
            (m_i[r] + log2f(l)) * 0.6931471805599453f;
    }
  }
  T* ob = static_cast<T*>(a.out0) + b * a.s[3][0] + h * a.s[3][2] + c0;
  store_rows<kChunk>(ob, a.s[3][1], acc, inv, m0 + warp * 16, nq, d - c0, g, t2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_wide_kernel(const Args a) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sdo = sq + TILE;
  float* sk = sdo + TILE;
  float* sv = sk + TILE;

  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int m0 = blockIdx.x * kRows, c0 = blockIdx.z * kChunk;
  const int nq = a.nq, nk = a.nk, d = a.d;
  const T* qb = base<T>(a.q, a, 0, b, h);
  const T* kb = base<T>(a.k, a, 1, b, h);
  const T* vb = base<T>(a.v, a, 2, b, h);
  const T* dob = base<T>(a.dout, a, 3, b, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, t2 = t * 2;

  float lse2[2], dlt[2];  // rows g and g + 8: lse in log2 units, and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    const long long i = static_cast<long long>(blockIdx.y) * nq + row;
    lse2[r] = row < nq ? a.lse[i] * kLog2e : 0.f;
    dlt[r] = row < nq ? a.delta[i] : 0.f;
  }
  float acc[DT][4];
  zero(acc);
  for (int n0 = 0; n0 < nk; n0 += kRows) {
    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
    for (int c = 0; c < d; c += kChunk) {
      __syncthreads();
      load_chunk(sq, qb, a.s[0][1], m0, nq, c, d);
      load_chunk(sk, kb, a.s[1][1], n0, nk, c, d);
      load_chunk(sdo, dob, a.s[3][1], m0, nq, c, d);
      load_chunk(sv, vb, a.s[2][1], n0, nk, c, d);
      __syncthreads();
      mma_abt<kSplit>(s, sq, warp * 16, sk, g, t);    // S = Q K^T
      mma_abt<kSplit>(dp, sdo, warp * 16, sv, g, t);  // dP = dO V^T
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = exp2_approx(fmaf(s[nt][j], a.scale_log2, -lse2[j >> 1]));
        if (n0 + nt * 8 + t2 + (j & 1) >= nk) p = 0.f;
        s[nt][j] = round_to<T>(p * (dp[nt][j] - dlt[j >> 1]) * a.scale);  // dS in q's dtype
      }
    }
    __syncthreads();
    load_chunk(sk, kb, a.s[1][1], n0, nk, c0, d);  // this block's slice of K
    __syncthreads();
    mma_pb<kSplit>(acc, s, sk, g, t);  // dQ += dS K
  }
  const float one[2] = {1.f, 1.f};
  T* out = static_cast<T*>(a.out0) + b * a.s[4][0] + h * a.s[4][2] + c0;
  store_rows<kChunk>(out, a.s[4][1], acc, one, m0 + warp * 16, nq, d - c0, g, t2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_wide_kernel(const Args a) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);
  float* sv = sk + TILE;
  float* sq = sv + TILE;
  float* sdo = sq + TILE;
  float* slse = sdo + TILE;    // kRows: the query tile's lse, log2 units
  float* sdl = slse + kRows;   // kRows: its delta

  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int n0 = blockIdx.x * kRows, c0 = blockIdx.z * kChunk;
  const int nq = a.nq, nk = a.nk, d = a.d;
  const T* qb = base<T>(a.q, a, 0, b, h);
  const T* kb = base<T>(a.k, a, 1, b, h);
  const T* vb = base<T>(a.v, a, 2, b, h);
  const T* dob = base<T>(a.dout, a, 3, b, h);
  const float* lseb = a.lse + static_cast<long long>(blockIdx.y) * nq;
  const float* dlb = a.delta + static_cast<long long>(blockIdx.y) * nq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, t2 = t * 2;

  float dk[DT][4], dv[DT][4];
  zero(dk);
  zero(dv);
  for (int i0 = 0; i0 < nq; i0 += kRows) {
    float pt[NT][4], dst[NT][4];
    zero(pt);
    zero(dst);
    for (int c = 0; c < d; c += kChunk) {
      __syncthreads();
      if (c == 0) {  // +inf past the end, so P = 0 there
        for (int r = threadIdx.x; r < kRows; r += kThreads) {
          slse[r] = i0 + r < nq ? lseb[i0 + r] * kLog2e : INFINITY;
          sdl[r] = i0 + r < nq ? dlb[i0 + r] : 0.f;
        }
      }
      load_chunk(sk, kb, a.s[1][1], n0, nk, c, d);
      load_chunk(sq, qb, a.s[0][1], i0, nq, c, d);
      load_chunk(sv, vb, a.s[2][1], n0, nk, c, d);
      load_chunk(sdo, dob, a.s[3][1], i0, nq, c, d);
      __syncthreads();
      mma_abt<kSplit>(pt, sk, warp * 16, sq, g, t);    // S^T = K Q^T
      mma_abt<kSplit>(dst, sv, warp * 16, sdo, g, t);  // dP^T = V dO^T
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = nt * 8 + t2 + (j & 1);  // query row within the tile
        const float p = exp2_approx(fmaf(pt[nt][j], a.scale_log2, -slse[col]));
        dst[nt][j] = round_to<T>(p * (dst[nt][j] - sdl[col]) * a.scale);  // dS^T in q's dtype
        pt[nt][j] = round_to<T>(p);                                         // P^T in dO's dtype
      }
    }
    __syncthreads();
    load_chunk(sq, qb, a.s[0][1], i0, nq, c0, d);  // this block's slices of Q and dO
    load_chunk(sdo, dob, a.s[3][1], i0, nq, c0, d);
    __syncthreads();
    mma_pb<kSplit>(dv, pt, sdo, g, t);  // dV += P^T dO
    mma_pb<kSplit>(dk, dst, sq, g, t);  // dK += dS^T Q
  }
  const float one[2] = {1.f, 1.f};
  T* dk_out = static_cast<T*>(a.out0) + b * a.s[4][0] + h * a.s[4][2] + c0;
  T* dv_out = static_cast<T*>(a.out1) + b * a.s[5][0] + h * a.s[5][2] + c0;
  store_rows<kChunk>(dk_out, a.s[4][1], dk, one, n0 + warp * 16, nk, d - c0, g, t2);
  store_rows<kChunk>(dv_out, a.s[5][1], dv, one, n0 + warp * 16, nk, d - c0, g, t2);
}

// The grid: blocks of 64 rows (queries for the forward and K4, keys for K5),
// batch * heads, and the head dim's 64-column slices; 0 slices where
// head_dims serves no wide route for d.
dim3 grid(int rows, int batch, int heads, int d) {
  const HeadDims hd = head_dims(d);
  const int slices = d > 256 && hd.dk ? hd.dk / hd.dv : 0;
  return dim3((rows + kRows - 1) / kRows, batch * heads, slices);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, dim3 g, const Args& a, cudaStream_t stream) {
  if (g.z == 0 || g.z > 65535 || g.y > 65535 || g.x == 0) return cudaErrorInvalidValue;
  // above 48 KB only as opted-in dynamic shared memory
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<g, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* out0, void* out1, int heads, int nq, int nk, int d,
               const long long* strides, int n_tensors, float scale) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.out0 = out0;
  a.out1 = out1;
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

// q, k, v, o: [batch, n, heads, d] bf16 (bf16 != 0) or fp32 with unit
// stride in d, d a multiple of 8 above 256, 16-byte aligned pointers and
// strides; strides in elements, (batch, n, head) for each of q, k, v, o in
// turn. lse: a contiguous fp32 [batch, heads, nq] that receives the
// natural-log logsumexp of each query row's scaled logits (K3), or null (K1).
// Returns the cudaError_t of the launch.
extern "C" int mobi_flash_fwd_wide(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                                   int heads, int nq, int nk, int d, int bf16, long long q_sb, long long q_sn,
                                   long long q_sh, long long k_sb, long long k_sn, long long k_sh,
                                   long long v_sb, long long v_sn, long long v_sh, long long o_sb,
                                   long long o_sn, long long o_sh, float scale_log2, void* stream) {
  if (nk <= 0) return cudaErrorInvalidValue;
  // the forward's stride table: q, k, v, then o in the slot of dO; lse is
  // its second output
  const long long s[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, o_sb, o_sn, o_sh};
  Args a = make_args(q, k, v, nullptr, nullptr, nullptr, o, lse, heads, nq, nk, d, s, 4, 1.f);
  a.scale_log2 = scale_log2;
  const dim3 g = grid(nq, batch, heads, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return lse ? launch(flash_fwd_wide_kernel<__nv_bfloat16, true>, kFwdSmem, g, a, st)
               : launch(flash_fwd_wide_kernel<__nv_bfloat16, false>, kFwdSmem, g, a, st);
  return lse ? launch(flash_fwd_wide_kernel<float, true>, kFwdSmem, g, a, st)
             : launch(flash_fwd_wide_kernel<float, false>, kFwdSmem, g, a, st);
}

// q, k, v, dout: [batch, n, heads, d] bf16 (bf16 != 0) or fp32 with unit
// stride in d, d a multiple of 8 above 256; lse, delta: contiguous fp32
// [batch, heads, nq]; dq: [batch, nq, heads, d] in the inputs' dtype.
// strides: 15 element strides, (batch, n, head) of q, k, v, dout, dq in turn.
// scale: d^-1/2. Returns the cudaError_t of the launch.
extern "C" int mobi_flash_bwd_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                                      const float* lse, const float* delta, void* dq, int batch, int heads,
                                      int nq, int nk, int d, int bf16, const long long* strides, float scale,
                                      void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, heads, nq, nk, d, strides, 5, scale);
  const dim3 g = grid(nq, batch, heads, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch(flash_bwd_dq_wide_kernel<__nv_bfloat16>, kBwdSmem, g, a, st)
              : launch(flash_bwd_dq_wide_kernel<float>, kBwdSmem, g, a, st);
}

// As mobi_flash_bwd_dq_wide, with dk and dv ([batch, nk, heads, d]) as the
// outputs and 18 strides: q, k, v, dout, dk, dv.
extern "C" int mobi_flash_bwd_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                                       const float* lse, const float* delta, void* dk, void* dv, int batch,
                                       int heads, int nq, int nk, int d, int bf16, const long long* strides,
                                       float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dk, dv, heads, nq, nk, d, strides, 6, scale);
  const dim3 g = grid(nk, batch, heads, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kSmem = kBwdSmem + 2 * kRows * static_cast<int>(sizeof(float));
  return bf16 ? launch(flash_bwd_dkv_wide_kernel<__nv_bfloat16>, kSmem, g, a, st)
              : launch(flash_bwd_dkv_wide_kernel<float>, kSmem, g, a, st);
}
