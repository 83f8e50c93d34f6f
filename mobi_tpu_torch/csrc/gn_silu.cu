// Fused GroupNorm + SiLU for Hopper (sm_90a): y = silu(groupnorm(x) * gamma
// + beta) over a contiguous NCHW tensor, bf16 or fp32 in and out, gamma and
// beta fp32. It replaces the TPU kernel `_gn_silu_kernel`
// (mobi_tpu/ops/fused_norm.py:45).
//
// In NCHW the channels of one group of one sample are one contiguous span of
// (C / G) * H * W elements. The statistics are fp32, the variance taken as
// E[x^2] - mean^2 as the TPU kernel takes it, and the affine is folded per
// channel: y = silu(x * sc + off). The kernel moves bytes and does little
// else, so its bound is one read and one write of the activation. The two
// cluster variants read x from device memory once and keep it on chip
// between the statistics and the normalisation:
//
//   cluster_smem  a thread-block cluster of 1 to 8 blocks owns one span,
//            each block one chunk of it. One thread loads the chunk into
//            shared memory with TMA bulk copies of 8 KB, each completing on
//            its own mbarrier, and the block sums x and x^2 over each piece
//            as it lands. Each block's two partial sums go to the others
//            through distributed shared memory (one cluster barrier), and
//            every block normalises its chunk from shared memory and writes
//            it with 16-byte stores. A second cluster barrier, split around
//            the normalisation, keeps each block resident until the others
//            have read its partial sums. A cluster of one block launches
//            without the cluster attribute and skips both barriers.
//   cluster_regs  the same with the chunk in registers, up to 8 16-byte
//            loads a thread, all issued before the first is used: for the
//            small spans (8x8 and 16x16 levels), where a block's barrier
//            and TMA set-up would cost more than the span's bytes.
//   stream   one 512-thread block owns one span and reads it twice from
//            device memory or L2 (statistics, then normalisation): the
//            first port's design, kept verbatim for the spans the others do
//            not take, a span that is not a multiple of 16 bytes (no UNet
//            shape) or larger than 8 blocks' shared memory. Its aligned body
//            takes 16-byte loads, a chunk that crosses into the next channel
//            takes each element's own affine, and the unaligned head and
//            tail of the span (fewer than 8 elements each) scalar loads.
//
// The host-side plan (mobi_tpu_torch/ops/fused_norm.py `gn_plan`) picks the
// variant, the cluster size, the chunk and the block size per launch, and
// the C entry point checks what it was given. The design note is in
// mobi_tpu_torch/ops/fused_norm.py, beside the plain PyTorch version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace mobi_sm90;

constexpr int kStreamThreads = 512;
constexpr int kMaxThreads = 512;       // the cluster variants take 32 to 512 threads a block
constexpr int kPieceBytes = 8192;      // one bulk copy, one mbarrier
constexpr int kMaxPieces = 28;         // a chunk of up to 224 KB
constexpr int kMaxCluster = 8;         // the portable cluster size

// silu(y) = y / (1 + e^-y), as the stream variant takes it.
__device__ __forceinline__ float silu(float y) { return y / (1.f + __expf(-y)); }

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16& y) { y = __float2bfloat16(x); }
__device__ __forceinline__ void from_float(float x, float& y) { y = x; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sum and sum of squares of the 16 bytes `raw`, added to s1 and s2.
template <typename T>
__device__ __forceinline__ void accumulate(const uint4& raw, float& s1, float& s2) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j) {
    const float f = to_float(e[j]);
    s1 += f;
    s2 += f * f;
  }
}

// silu(y) = y sigmoid(y) for the cluster variants: in fp32 y / (1 + e^-y)
// with the fast division (ex2 and rcp, 2 ulp each); for a bf16 output
// h + h tanh(h), h = y / 2, with tanh.approx (one special-function op an
// element in place of two; its ~2^-11 relative error is under bf16's
// rounding).
template <typename T>
__device__ __forceinline__ float silu_fast(float y);
template <>
__device__ __forceinline__ float silu_fast<float>(float y) { return __fdividef(y, 1.f + __expf(-y)); }
template <>
__device__ __forceinline__ float silu_fast<__nv_bfloat16>(float y) {
  const float h = 0.5f * y;
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

// silu(x * sc + off) of the 16 bytes `raw`, elements [i, i + kVec) of a span
// whose channels start at c0.
template <typename T>
__device__ __forceinline__ uint4 normalize(const uint4& raw, int i, int hw, int c0, float mean, float inv,
                                           const float* __restrict__ gamma, const float* __restrict__ beta) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const T* e = reinterpret_cast<const T*>(&raw);
  uint4 out;
  T* oe = reinterpret_cast<T*>(&out);
  const int ci = i / hw;
  if (i - ci * hw + kVec <= hw) {  // the chunk lies in one channel
    const float sc = inv * __ldg(gamma + c0 + ci), off = __ldg(beta + c0 + ci) - mean * sc;
#pragma unroll
    for (int j = 0; j < kVec; ++j) from_float(silu_fast<T>(to_float(e[j]) * sc + off), oe[j]);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c = c0 + (i + j) / hw;
      const float sc = inv * __ldg(gamma + c);
      from_float(silu_fast<T>(to_float(e[j]) * sc + (__ldg(beta + c) - mean * sc)), oe[j]);
    }
  }
  return out;
}

__device__ __forceinline__ float2 mean_inv(float s1, float s2, int span, float eps) {
  const float mean = s1 / static_cast<float>(span);
  const float var = fmaxf(s2 / static_cast<float>(span) - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// V 16-byte entries of a row of n, entry v * stride + t of each, with every
// load issued before the first is used; entries past n are zero, which adds
// nothing to the sums.
template <int V>
__device__ __forceinline__ void load_entries(uint4 (&r)[V], const uint4* __restrict__ src, int n, int t,
                                             int stride) {
#pragma unroll
  for (int v = 0; v < V; ++v) r[v] = __ldg(src + min(v * stride + t, n - 1));
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (v * stride + t >= n) r[v] = make_uint4(0u, 0u, 0u, 0u);
}

// The block's (sum, sum of squares) into `part` (thread 0's view is final
// after the next barrier).
__device__ __forceinline__ void block_part(float s1, float s2, float (&red)[2][kMaxThreads / 32], float2& part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    const bool mine = lane < static_cast<int>(blockDim.x >> 5);
    s1 = warp_sum(mine ? red[0][lane] : 0.f);
    s2 = warp_sum(mine ? red[1][lane] : 0.f);
    if (lane == 0) part = make_float2(s1, s2);
  }
}

// The span's (mean, 1 / std) into `stats` from every block's `part`: read
// through distributed shared memory in a cluster of more than one block.
// A cluster's blocks then arrive on the cluster barrier (done reading), and
// each must wait on it (cluster_wait) before it exits.
__device__ __forceinline__ void span_stats(float2& part, float2& stats, uint32_t blocks, int span, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blocks > 1) {
    cluster_arrive();  // every block's part is written ...
    cluster_wait();    // ... and visible to the cluster
    if (warp == 0) {
      const float2 v = lane < static_cast<int>(blocks) ? load_cluster_f2(&part, lane) : make_float2(0.f, 0.f);
      const float t1 = warp_sum(v.x), t2 = warp_sum(v.y);
      if (lane == 0) stats = mean_inv(t1, t2, span, eps);
    }
    cluster_arrive();  // this block is done reading the others' parts
  } else {
    __syncthreads();
    if (threadIdx.x == 0) stats = mean_inv(part.x, part.y, span, eps);
  }
  __syncthreads();
}

// ----------------------------------------------------------- cluster_smem
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    gn_silu_cluster_smem_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                const float* __restrict__ beta, T* __restrict__ y, int channels, int groups,
                                int hw, int chunk, float eps) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kPieceVecs = kPieceBytes / 16;
  extern __shared__ __align__(128) uint4 buf[];  // this block's chunk, 16 bytes an entry
  __shared__ uint64_t bars[kMaxPieces];
  __shared__ float red[2][kMaxThreads / 32];
  __shared__ float2 part;   // this block's (sum, sum of squares): the cluster reads it
  __shared__ float2 stats;  // the span's (mean, 1 / std)
  const uint32_t rank = cluster_rank(), blocks = cluster_size();
  const int cg = channels / groups, span = cg * hw;
  const long long sid = blockIdx.x / blocks;  // (sample, group)
  const int begin = static_cast<int>(rank) * chunk;
  const int n = min(chunk, span - begin);  // > 0, a multiple of kVec (the plan's)
  const int nv = n / kVec, pieces = (nv + kPieceVecs - 1) / kPieceVecs;
  const T* xs = x + sid * span + begin;
  T* ys = y + sid * span + begin;

  if (threadIdx.x == 0) {
    for (int p = 0; p < pieces; ++p) mbar_init(&bars[p], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int p = 0; p < pieces; ++p) {
      const uint32_t bytes = 16u * static_cast<uint32_t>(min(kPieceVecs, nv - p * kPieceVecs));
      mbar_expect_tx(&bars[p], bytes);
      bulk_load(buf + p * kPieceVecs, xs + p * kPieceVecs * kVec, bytes, &bars[p]);
    }
  }
  float s1 = 0.f, s2 = 0.f;
  for (int p = 0; p < pieces; ++p) {  // each piece's sums as it lands
    mbar_wait(&bars[p], 0);
    const int end = min(nv, (p + 1) * kPieceVecs);
    for (int i = p * kPieceVecs + threadIdx.x; i < end; i += blockDim.x) accumulate<T>(buf[i], s1, s2);
  }
  block_part(s1, s2, red, part);
  span_stats(part, stats, blocks, span, eps);
  const float mean = stats.x, inv = stats.y;
  const int c0 = static_cast<int>(sid % groups) * cg;
  for (int i = threadIdx.x; i < nv; i += blockDim.x)
    *reinterpret_cast<uint4*>(ys + i * kVec) =
        normalize<T>(buf[i], begin + i * kVec, hw, c0, mean, inv, gamma, beta);
  if (blocks > 1) cluster_wait();  // no block leaves while another may still read its part
}

// ----------------------------------------------------------- cluster_regs
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    gn_silu_cluster_regs_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                const float* __restrict__ beta, T* __restrict__ y, int channels, int groups,
                                int hw, int chunk, float eps) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  __shared__ float red[2][kMaxThreads / 32];
  __shared__ float2 part, stats;
  const uint32_t rank = cluster_rank(), blocks = cluster_size();
  const int cg = channels / groups, span = cg * hw;
  const long long sid = blockIdx.x / blocks;
  const int begin = static_cast<int>(rank) * chunk;
  const int nv = min(chunk, span - begin) / kVec;
  const uint4* xs = reinterpret_cast<const uint4*>(x + sid * span + begin);
  uint4* ys = reinterpret_cast<uint4*>(y + sid * span + begin);
  uint4 r[V];
  load_entries<V>(r, xs, nv, threadIdx.x, blockDim.x);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) accumulate<T>(r[v], s1, s2);
  block_part(s1, s2, red, part);
  span_stats(part, stats, blocks, span, eps);
  const float mean = stats.x, inv = stats.y;
  const int c0 = static_cast<int>(sid % groups) * cg;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = v * blockDim.x + threadIdx.x;
    if (i < nv) ys[i] = normalize<T>(r[v], begin + i * kVec, hw, c0, mean, inv, gamma, beta);
  }
  if (blocks > 1) cluster_wait();
}

// ------------------------------------------------------------------- stream
// Sum of a per-thread value over the block; every thread gets the result.
__device__ __forceinline__ float block_sum(float x, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = lane < kStreamThreads / 32 ? scratch[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();  // scratch is reused by the next call
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
    gn_silu_stream_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y,
                   int channels, int groups, int hw, float eps) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte load
  __shared__ float scratch[kStreamThreads / 32];
  const int cg = channels / groups;
  const int span = cg * hw;  // < 2^31: the wrapper checks it
  const long long base = static_cast<long long>(blockIdx.x) * span;  // NCHW: (sample, group) = blockIdx.x
  const T* xs = x + base;
  T* ys = y + base;
  const int c0 = (blockIdx.x % groups) * cg;
  // the span's 16-byte-aligned body [head, head + body); scalar elements around it
  const int head = min(span, static_cast<int>((kVec - base % kVec) % kVec));
  const int body = (span - head) / kVec * kVec;
  const int rest = span - head - body;  // the tail
  auto scalar_index = [&](int i) { return i < head ? i : i + body; };  // head, then tail

  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int i = head + threadIdx.x * kVec; i < head + body; i += kStreamThreads * kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xs + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float f = to_float(e[j]);
      s1 += f;
      s2 += f * f;
    }
  }
  for (int i = threadIdx.x; i < head + rest; i += kStreamThreads) {
    const float f = to_float(xs[scalar_index(i)]);
    s1 += f;
    s2 += f * f;
  }
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  const float mean = s1 / static_cast<float>(span);
  const float var = fmaxf(s2 / static_cast<float>(span) - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);

#pragma unroll 4
  for (int i = head + threadIdx.x * kVec; i < head + body; i += kStreamThreads * kVec) {
    const int ci = i / hw;
    const float sc = inv * gamma[c0 + ci], off = beta[c0 + ci] - mean * sc;
    const uint4 raw = *reinterpret_cast<const uint4*>(xs + i);
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 out;
    T* oe = reinterpret_cast<T*>(&out);
    if (i - ci * hw + kVec <= hw) {  // the chunk lies in one channel
#pragma unroll
      for (int j = 0; j < kVec; ++j) from_float(silu(to_float(e[j]) * sc + off), oe[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int c = c0 + (i + j) / hw;
        const float scj = inv * gamma[c];
        from_float(silu(to_float(e[j]) * scj + (beta[c] - mean * scj)), oe[j]);
      }
    }
    *reinterpret_cast<uint4*>(ys + i) = out;
  }
  for (int i = threadIdx.x; i < head + rest; i += kStreamThreads) {
    const int k = scalar_index(i), c = c0 + k / hw;
    const float sc = inv * gamma[c];
    from_float(silu(to_float(xs[k]) * sc + (beta[c] - mean * sc)), ys[k]);
  }
}

// ------------------------------------------------------------------- launch
enum Variant { kStream = 0, kClusterSmem = 1, kClusterRegs = 2 };

// `kernel` over `blocks` blocks of `threads`, as clusters of `cluster`
// blocks where that is more than one.
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, unsigned blocks, int threads, int cluster, int smem,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y, int batch, int channels, int groups,
           int hw, float eps, int variant, int cluster, int chunk, int threads, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const int span = channels / groups * hw;
  const long long spans = static_cast<long long>(batch) * groups;
  if (variant == kStream) {
    if (threads != kStreamThreads) return cudaErrorInvalidValue;
    gn_silu_stream_kernel<T><<<static_cast<unsigned>(spans), kStreamThreads, 0, stream>>>(xt, g, b, yt, channels,
                                                                                           groups, hw, eps);
    return cudaGetLastError();
  }
  // the cluster variants: 16-byte aligned spans, whole warps
  if (span % kVec || threads % 32 || threads < 32 || threads > kMaxThreads) return cudaErrorInvalidValue;
  // every block of the cluster owns a non-empty chunk of 16-byte entries
  if (cluster < 1 || cluster > kMaxCluster || chunk <= 0 || chunk % kVec ||
      static_cast<long long>(chunk) * cluster < span || static_cast<long long>(chunk) * (cluster - 1) >= span)
    return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(spans * cluster);
  if (variant == kClusterRegs) {
    const int per_thread = (chunk / kVec + threads - 1) / threads;
#define MOBI_GN_REGS(V) \
  launch_clusters(gn_silu_cluster_regs_kernel<T, V>, blocks, threads, cluster, 0, stream, xt, g, b, yt, channels, \
                  groups, hw, chunk, eps)
    if (per_thread <= 4) return MOBI_GN_REGS(4);
    if (per_thread <= 8) return MOBI_GN_REGS(8);
#undef MOBI_GN_REGS
    return cudaErrorInvalidValue;
  }
  const int bytes = chunk * static_cast<int>(sizeof(T));
  if (variant != kClusterSmem || bytes > kMaxPieces * kPieceBytes) return cudaErrorInvalidValue;
  static const cudaError_t opted = cudaFuncSetAttribute(gn_silu_cluster_smem_kernel<T>,
                                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                        kMaxPieces * kPieceBytes);
  if (opted != cudaSuccess) return opted;
  return launch_clusters(gn_silu_cluster_smem_kernel<T>, blocks, threads, cluster, bytes, stream, xt, g, b, yt,
                         channels, groups, hw, chunk, eps);
}

}  // namespace

// x, y: [batch, channels, hw] contiguous and 16-byte aligned, bf16 (fp32 ==
// 0) or fp32 (fp32 == 1), any hw; gamma, beta: [channels] fp32. The plan:
// variant 0 (stream; threads 512), 1 (cluster_smem: `cluster` blocks of
// `threads` a span, `chunk` elements each, up to 224 KB) or 2
// (cluster_regs: the same, up to 8 16-byte entries a thread); 1 to 8
// blocks a cluster, 32 to 512 threads (a multiple of 32), chunks that cover
// the span with none empty. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a plan the kernels do not take).
extern "C" int mobi_gn_silu(const void* x, const void* gamma, const void* beta, void* y, int batch,
                            int channels, int groups, int hw, int fp32, float eps, int variant, int cluster,
                            int chunk, int threads, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp32 ? launch<float>(x, gamma, beta, y, batch, channels, groups, hw, eps, variant, cluster, chunk,
                              threads, st)
              : launch<__nv_bfloat16>(x, gamma, beta, y, batch, channels, groups, hw, eps, variant, cluster,
                                      chunk, threads, st);
}
