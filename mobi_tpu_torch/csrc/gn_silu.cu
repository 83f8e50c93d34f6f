// Fused GroupNorm + SiLU for Hopper (sm_90a): y = silu(groupnorm(x) * gamma
// + beta) over a contiguous NCHW tensor, bf16 or fp32 in and out, gamma and
// beta fp32.
//
// In NCHW the channels of one group of one sample are one contiguous span of
// (C / G) * H * W elements, so one block owns one (sample, group). Pass 1
// reads the span with 16-byte loads and reduces sum and sum of squares in
// fp32 (variance as E[x^2] - mean^2, as the TPU kernel takes it). Pass 2 reads
// the span again and writes silu(x * sc + off), with the affine folded per
// channel. The span is up to 240 KB in bf16 on the main path (64x64x960),
// more than a block's 227 KB of shared memory, so pass 2 re-reads it from
// device memory, where pass 1 has just brought it into the 50 MB L2 (fp32
// doubles the bytes and the span).
//
// Any H * W: where it is a multiple of 8 (every UNet level), every span
// starts 16-byte aligned (the wrapper checks the base pointer) and every
// 16-byte chunk (8 bf16 or 4 fp32) lies inside one channel. Otherwise a
// span's aligned body still takes 16-byte loads, a chunk that crosses into
// the next channel takes each element's own affine, and the unaligned head
// and tail of the span (fewer than 8 elements each) take scalar loads.
//
// The design note is in mobi_tpu_torch/ops/fused_norm.py, beside the plain
// PyTorch version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float silu(float y) { return y / (1.f + __expf(-y)); }

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16& y) { y = __float2bfloat16(x); }
__device__ __forceinline__ void from_float(float x, float& y) { y = x; }

// Sum of a per-thread value over the block; every thread gets the result.
__device__ __forceinline__ float block_sum(float x, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = lane < kThreads / 32 ? scratch[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();  // scratch is reused by the next call
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_silu_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y,
                   int channels, int groups, int hw, float eps) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte load
  __shared__ float scratch[kThreads / 32];
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
  for (int i = head + threadIdx.x * kVec; i < head + body; i += kThreads * kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xs + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float f = to_float(e[j]);
      s1 += f;
      s2 += f * f;
    }
  }
  for (int i = threadIdx.x; i < head + rest; i += kThreads) {
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
  for (int i = head + threadIdx.x * kVec; i < head + body; i += kThreads * kVec) {
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
  for (int i = threadIdx.x; i < head + rest; i += kThreads) {
    const int k = scalar_index(i), c = c0 + k / hw;
    const float sc = inv * gamma[c];
    from_float(silu(to_float(xs[k]) * sc + (beta[c] - mean * sc)), ys[k]);
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y, int batch,
           int channels, int groups, int hw, float eps, void* stream) {
  const unsigned blocks = static_cast<unsigned>(batch) * groups;
  gn_silu_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y), channels, groups, hw, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [batch, channels, hw] contiguous and 16-byte aligned, bf16 (fp32 ==
// 0) or fp32 (fp32 == 1), any hw; gamma, beta: [channels] fp32. Returns the
// cudaError_t of the launch.
extern "C" int mobi_gn_silu(const void* x, const void* gamma, const void* beta,
                            void* y, int batch, int channels, int groups, int hw,
                            int fp32, float eps, void* stream) {
  return fp32 ? launch<float>(x, gamma, beta, y, batch, channels, groups, hw, eps, stream)
              : launch<__nv_bfloat16>(x, gamma, beta, y, batch, channels, groups, hw, eps, stream);
}
