// Flash-attention forward for Hopper (sm_90a) in bf16, built from wgmma, TMA
// and warp specialisation: K1 (`_flash_kernel`), K3 (`_flash_kernel_lse`,
// mobi_tpu/ops/flash_attention.py:228: K1 with an lse output) and, with TAV,
// K2 (`_flash_kernel_tav`, the transposed output accumulator). All compute
// non-causal softmax(Q K^T * d^-1/2) V over [B, N, H, D] strided views: the
// dots in bf16 with fp32 accumulation, the online max and sum in fp32 in
// base 2 (log2 e folded into the scale), P rounded to bf16 before P V, the
// output in bf16. K3 also writes the fp32 logsumexp of each query row's
// scaled logits, (m + log2 l) * ln 2, to [B, H, Nq]: K1 with a non-null
// lse pointer, one instantiation for both. The fp32 K1, K2 and K3 stay on
// flash_fwd.cu and flash_fwd_tav.cu (3xTF32 on mma.sync).
//
// One block owns 128 query rows of one (batch, head) and has three
// warpgroups. The first is the producer: it gives its registers up
// (setmaxnreg) and one thread issues every TMA load, Q once and then K and V
// in 128-key tiles into a ring of three stages (two where three do not fit,
// below), each with full and empty mbarriers. The other two are consumers of 64 query rows each, with 240
// registers a thread:
//
//   S = Q K^T       wgmma m64n128k16, Q and K from shared memory (K-major);
//   online softmax  on the accumulator as it stands (its per-warp layout is
//                   mma.sync's C layout: flash_common.cuh's online_softmax);
//   K1: O += P V    wgmma m64n{DV}k16 with P from registers (the bf16
//                   packing of two S column tiles is an A fragment) and V
//                   from shared memory, MN-major;
//   K2: O^T += V^T P^T  wgmma m64n64k16, V^T (MN-major, the head dim padded
//                   to M = 64, rows past DV dropped) and P^T from shared
//                   memory: each consumer writes its bf16 P tile with
//                   stmatrix (128-byte swizzle), and the per-query alpha and
//                   the final 1 / l, which scale O^T's columns, pass through
//                   shared memory; O^T goes back to rows through shared
//                   memory for 16-byte stores.
//
// Within a consumer the products of two tiles overlap the softmax: S(j) and
// P(j-1) V(j-1) are issued together, the softmax of tile j runs once S(j)
// has landed while P(j-1) V(j-1) is still on the tensor cores, and the
// accumulator is rescaled after that product completes. Between the two
// consumers, named barriers make them take turns to issue their products
// (ping-pong), so one's softmax runs while the other's products run and the
// exponential units stay fed. The third ring stage gives each tile's TMA
// loads two tiles of compute to land in.
//
// Layouts (hopper.cuh): Q, K and V tiles are boxes of 16 head-dim columns
// (32 bytes, the 32-byte swizzle) by 128 rows. The kernel is built for
// contraction widths DK = 48, 64, 80, 128, 160, 192 and 256 (K2: 48 and
// 64), and a call takes the smallest that holds d (flash_common.cuh's
// head_dims): d = 40 runs in the 48 build (three boxes; TMA fills the
// columns past d, and rows past N, with zeros; at d = 16 two of the three
// boxes lie wholly past d and arrive as zeros, with their full byte count
// on the barrier), d = 80 in five boxes, d = 96 in the 128 build. Keys past
// nk get -inf logits. Rows past nq are computed on zeros and never stored.
// At DK = 128 the ring still has three stages: Q and three K/V stages take
// 224 KB of the 227 KB a block may have; the consumer's S, P and O (160
// fp32 values a thread) pass the 168 registers that ptxas allocates under
// the 384-thread launch bound, so that build spills and its wgmmas
// serialise.
//
// Head dims above 128 (DK = 160, 192, 256): the output's head dim is split
// into DK / DV slices of DV = 80 (DK = 160) or 64 columns, a grid axis
// (blockIdx.z). Each block computes S over the full DK, as any block does,
// and accumulates only its slice of O, so its S, P and O take the
// registers of the 80 or 64 build. Its ring holds full-width K tiles and V
// tiles of the slice alone (the same tensor map, boxes from column z DV);
// three stages where they fit (DK = 160: 220 KB of tiles), else two. Every slice
// computes the same S, m and l, so slice 0 alone writes lse; S and the
// exponentials are recomputed once per slice. The tensor maps are encoded
// on the host for each call (hopper.cuh's encode) and passed as
// __grid_constant__ parameters.
//
// The design note (what bounds the kernel on the H100) is in
// mobi_tpu_torch/ops/flash_attention.py.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace mobi_flash;
using namespace mobi_sm90;
using bf16 = __nv_bfloat16;

constexpr int kBlockM = 128;       // query rows per block: two consumers of 64
constexpr int kBlockN = 128;       // keys per streamed tile
constexpr int kThreads = 3 * 128;  // the producer warpgroup, then two consumers
constexpr int kBoxBytes = kBlockN * kBoxCols * 2;  // one box of 128 rows
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// DK: the contraction width (Q and K); DV: the output columns a block
// accumulates (V as loaded); STAGES: the K/V ring depth.
template <int DK, int DV, bool TAV, int STAGES>
struct SharedAt {
  static constexpr int kStages = STAGES;
  static constexpr int kBoxes = DK / kBoxCols;      // of Q and K
  static constexpr int kVLoad = DV / kBoxCols;      // of V as loaded
  static constexpr int kVBoxes = TAV ? 4 : kVLoad;  // K2's V^T is an M = 64 operand
  alignas(1024) bf16 q[kBoxes][kBlockM * kBoxCols];
  bf16 k[kStages][kBoxes][kBlockN * kBoxCols];
  bf16 v[kStages][kVBoxes][kBlockN * kBoxCols];
  alignas(1024) bf16 p[2][TAV ? 64 * kBlockN : 8];  // K2: each consumer's P tile
  float stat[2][64];  // K2: each consumer's per-query alpha, then 1 / l
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
};
// Three ring stages where they fit a block's shared memory (+ 1 KB to
// align), else two.
template <int DK, int DV, bool TAV>
using Shared = SharedAt<DK, DV, TAV, (sizeof(SharedAt<DK, DV, TAV, 3>) + 1024 <= kMaxSmem ? 3 : 2)>;

struct Params {
  bf16* o;
  float* lse;  // K3: [batch * heads, nq]; null for K1 and K2
  long long o_sb, o_sn, o_sh;
  int heads, nq, nk, d;
  int n_first[3];  // per tensor map (q, k, v): N is its second dim, else H is
  float scale_log2;
};

template <int DK, int DV, bool TAV>
__device__ __forceinline__ void produce(Shared<DK, DV, TAV>& sm, const CUtensorMap* mq, const CUtensorMap* mk,
                                        const CUtensorMap* mv, const Params& prm, int b, int h, int m0,
                                        int n_tiles, int c0) {
  using S = Shared<DK, DV, TAV>;
  constexpr int kBoxes = S::kBoxes, kStages = S::kStages;
  prefetch_tensormap(mq);
  prefetch_tensormap(mk);
  prefetch_tensormap(mv);
  mbar_expect_tx(&sm.q_full, kBoxes * kBoxBytes);
  for (int i = 0; i < kBoxes; ++i)
    load_box(sm.q[i], mq, &sm.q_full, prm.n_first[0], i * kBoxCols, m0, h, b);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    if (j >= kStages) mbar_wait(&sm.empty[st], (j / kStages - 1) & 1);  // both consumers are done with it
    mbar_expect_tx(&sm.k_full[st], kBoxes * kBoxBytes);
    for (int i = 0; i < kBoxes; ++i)
      load_box(sm.k[st][i], mk, &sm.k_full[st], prm.n_first[1], i * kBoxCols, j * kBlockN, h, b);
    mbar_expect_tx(&sm.v_full[st], S::kVLoad * kBoxBytes);
    for (int i = 0; i < S::kVLoad; ++i)  // this block's slice of V
      load_box(sm.v[st][i], mv, &sm.v_full[st], prm.n_first[2], c0 + i * kBoxCols, j * kBlockN, h, b);
  }
}

template <int DK, int DV, bool TAV>
__device__ __forceinline__ void consume(Shared<DK, DV, TAV>& sm, const Params& prm, int b, int h, int m0,
                                        int n_tiles, int c0, int wg, int tid) {
  constexpr int NT = kBlockN / 8;  // 8-key column tiles of S
  constexpr int OT = TAV ? 8 : DV / 8;  // 8-column tiles of O (K1) or O^T (K2: 64 queries)
  constexpr int kStages = Shared<DK, DV, TAV>::kStages;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const uint32_t q_addr = smem_u32(sm.q[0]) + wg * 64 * 32;  // this consumer's rows of each box

  float s[NT][4];      // S of the newest tile
  uint32_t p[NT / 2][4];  // K1: the previous tile's P as bf16 A fragments
  float o[OT][4];      // O [64 x DV] (K1) or O^T [64 d x 64 queries] (K2)
#pragma unroll
  for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < OT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_i[2] = {-1e30f, -1e30f};  // rows g and g + 8 of this warp's slab, log2 units
  float l_i[2] = {0.f, 0.f};        // this thread's share of the running sum
  float alpha[2] = {0.f, 0.f};  // the last tile's rescale of the accumulator

  auto issue_s = [&](int j) {  // S = Q K_j^T
    const int st = j % kStages;
    mbar_wait(&sm.k_full[st], (j / kStages) & 1);
    const uint32_t k_addr = smem_u32(sm.k[st][0]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks)
      wgmma_ss_m64n128(s, gmma_desc(q_addr + ks * kBoxBytes, 16, 256, kSwizzle32),
                       gmma_desc(k_addr + ks * kBoxBytes, 16, 256, kSwizzle32), ks);
    wgmma_commit();
  };
  auto issue_pv = [&](int j) {  // O += P_j V_j (K1), O^T += V_j^T P_j^T (K2)
    const int st = j % kStages;
    mbar_wait(&sm.v_full[st], (j / kStages) & 1);
    const uint32_t v_addr = smem_u32(sm.v[st][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {  // 16 keys: 16 rows further into every V box
      const uint64_t dv = gmma_desc(v_addr + kk * 512, kBoxBytes, 256, kSwizzle32);
      if constexpr (TAV) {
        const uint32_t p_addr = smem_u32(sm.p[wg]) + (kk / 4) * 64 * 128 + (kk % 4) * 32;
        wgmma_ss_m64n64_ta(o, dv, gmma_desc(p_addr, 16, 1024, kSwizzle128), 1);
      } else {
        wgmma_rs_n<DV>(o, p[kk], dv);
      }
    }
    wgmma_commit();
  };
  auto release = [&](int j) {  // this warp is done with stage j's K and V
    if (lane == 0) mbar_arrive(&sm.empty[j % kStages]);
  };
  // After the softmax of a tile: rescale the accumulator by alpha, and make
  // the tile's P for the next product.
  auto rescale_and_make_p = [&]() {
    if constexpr (!TAV) {
#pragma unroll
      for (int i = 0; i < OT; ++i) {
        o[i][0] *= alpha[0];
        o[i][1] *= alpha[0];
        o[i][2] *= alpha[1];
        o[i][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        p[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        p[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        p[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        p[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
    } else {
      // alpha is per query, held by the quad of its S row; O^T's columns
      // are queries, spread over the warpgroup: pass alpha through shared
      // memory. The barrier also orders the P writes below after every
      // warp's wait on the product that read the previous P.
      float* stat = sm.stat[wg];
      if ((lane & 3) == 0) {
        stat[warp * 16 + g] = alpha[0];
        stat[warp * 16 + g + 8] = alpha[1];
      }
      named_sync(1 + wg, 128);
#pragma unroll
      for (int i = 0; i < OT; ++i) {
        const float2 a = *reinterpret_cast<const float2*>(stat + i * 8 + t2);
        o[i][0] *= a.x;
        o[i][1] *= a.y;
        o[i][2] *= a.x;
        o[i][3] *= a.y;
      }
      // P [64 queries x 128 keys] as two 128-byte-swizzled blocks of 64
      // keys; stmatrix matrix i = lane / 8 is (rows (i & 1) * 8, keys
      // (i >> 1) * 8) of each 16 x 16 block, lane % 8 its row.
      const int i = lane >> 3, row = warp * 16 + (i & 1) * 8 + (lane & 7);
      const uint32_t p_base = smem_u32(sm.p[wg]) + row * 128;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const int chunk = (kk * 2 + (i >> 1)) & 7;  // 16-byte chunk of the 64-key block
        stmatrix_x4(p_base + (kk / 4) * 64 * 128 + ((chunk ^ (row & 7)) << 4),
                    pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                    pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                    pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]));
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);  // the whole P tile is written before the product reads it
    }
  };

  // ping-pong: the consumers take turns to issue their products, so one's
  // softmax runs while the other's products run (named barriers 3, 4)
  auto my_turn = [&]() { named_sync(3 + wg, 256); };
  auto their_turn = [&]() { named_arrive(3 + (wg ^ 1), 256); };
  if (wg == 1) their_turn();  // consumer 0 goes first

  mbar_wait(&sm.q_full, 0);
  my_turn();
  issue_s(0);
  their_turn();
  wgmma_wait<0>();
  fence_regs(s);
  online_softmax<NT>(s, m_i, l_i, alpha, 0, prm.nk, t2, prm.scale_log2);
  rescale_and_make_p();
  for (int j = 1; j < n_tiles; ++j) {
    my_turn();
    issue_s(j);       // S(j) ...
    issue_pv(j - 1);  // ... and P(j-1) V(j-1) on the tensor cores together
    their_turn();
    wgmma_wait<1>();  // S(j) has landed
    fence_regs(s);
    online_softmax<NT>(s, m_i, l_i, alpha, j * kBlockN, prm.nk, t2, prm.scale_log2);
    wgmma_wait<0>();  // P(j-1) V(j-1) too
    fence_regs(o);
    if constexpr (!TAV) fence_regs(p);
    release(j - 1);
    rescale_and_make_p();
  }
  my_turn();
  issue_pv(n_tiles - 1);
  if (wg == 0) their_turn();  // consumer 1 takes the last turn
  wgmma_wait<0>();
  fence_regs(o);
  if constexpr (!TAV) fence_regs(p);
  release(n_tiles - 1);

  const int row0 = m0 + wg * 64;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
    const int row = row0 + warp * 16 + g + 8 * r;
    if (!TAV && prm.lse != nullptr && c0 == 0 && t2 == 0 && row < prm.nq)  // K3: slice 0's quad's first thread
      prm.lse[static_cast<long long>(b * prm.heads + h) * prm.nq + row] =
          (m_i[r] + log2f(l)) * 0.6931471805599453f;
  }
  bf16* ob = prm.o + b * prm.o_sb + h * prm.o_sh + c0;
  if constexpr (!TAV) {
    store_rows<DV>(ob, prm.o_sn, o, inv, row0 + warp * 16, prm.nq, prm.d - c0, g, t2);
  } else {
    constexpr int kStageLd = DV + 8;  // the O staging row, in bf16
    float* stat = sm.stat[wg];
    named_sync(1 + wg, 128);  // every warp is past its last read of alpha and of P
    if ((lane & 3) == 0) {
      stat[warp * 16 + g] = inv[0];
      stat[warp * 16 + g + 8] = inv[1];
    }
    named_sync(1 + wg, 128);
    // O^T (d rows 16 warp + g, + 8; queries 8 i + t2, + 1) -> O rows in
    // this consumer's P tile (64 x kStageLd fits its 64 x 128), then 16-byte
    // row stores
    bf16* stage = sm.p[wg];
#pragma unroll
    for (int i = 0; i < OT; ++i) {
      const float2 c = *reinterpret_cast<const float2*>(stat + i * 8 + t2);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = warp * 16 + g + 8 * (jj >> 1), q = i * 8 + t2 + (jj & 1);
        if (col < DV) stage[q * kStageLd + col] = __float2bfloat16(o[i][jj] * ((jj & 1) ? c.y : c.x));
      }
    }
    named_sync(1 + wg, 128);
    const int chunks = prm.d / 8;  // d is a multiple of 8
    for (int i = tid; i < 64 * chunks; i += 128) {
      const int r = i / chunks, c = (i % chunks) * 8;
      if (row0 + r < prm.nq)
        *reinterpret_cast<uint4*>(ob + (row0 + r) * prm.o_sn + c) =
            *reinterpret_cast<const uint4*>(stage + r * kStageLd + c);
    }
  }
}

template <int DK, int DV, bool TAV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, const Params prm) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment of the shared address
  auto& sm = *reinterpret_cast<Shared<DK, DV, TAV>*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int b = blockIdx.y / prm.heads, h = blockIdx.y % prm.heads;
  const int m0 = blockIdx.x * kBlockM;
  const int c0 = blockIdx.z * DV;  // this block's output columns
  const int n_tiles = (prm.nk + kBlockN - 1) / kBlockN;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < Shared<DK, DV, TAV>::kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one branch per role for the whole kernel, so setmaxnreg takes effect
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) produce<DK, DV, TAV>(sm, &map_q, &map_k, &map_v, prm, b, h, m0, n_tiles, c0);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<DK, DV, TAV>(sm, prm, b, h, m0, n_tiles, c0, threadIdx.x / 128 - 1, threadIdx.x % 128);
  }
}

template <int DK, int DV, bool TAV>
cudaError_t launch(const CUtensorMap* maps, const Params& prm, int batch, cudaStream_t stream) {
  constexpr int kSmem = sizeof(Shared<DK, DV, TAV>) + 1024;  // + room to align
  static_assert(kSmem <= kMaxSmem, "the build fits a block's shared memory");
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<DK, DV, TAV>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((prm.nq + kBlockM - 1) / kBlockM, batch * prm.heads, DK / DV);
  flash_fwd_sm90_kernel<DK, DV, TAV><<<grid, kThreads, kSmem, stream>>>(maps[0], maps[1], maps[2], prm);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [batch, n, heads, d] bf16 with unit stride in d, d a multiple
// of 8 up to 256 (K2, tav != 0: below 64), 16-byte aligned pointers and
// strides; strides in elements, (batch, n, head) for each of q, k, v, o in
// turn. lse: a contiguous fp32 [batch, heads, nq] that receives the
// natural-log logsumexp of each query row's scaled logits (K3), or null (K1,
// K2). Returns the cudaError_t of the launch, or 10000 + the CUresult of a
// tensor map that could not be encoded.
extern "C" int mobi_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                                   int heads, int nq, int nk, int d, int tav, long long q_sb, long long q_sn,
                                   long long q_sh, long long k_sb, long long k_sn, long long k_sh,
                                   long long v_sb, long long v_sn, long long v_sh, long long o_sb,
                                   long long o_sn, long long o_sh, float scale_log2, void* stream) {
  const int dp = head_dims(d).dk;
  if (dp == 0 || (tav && (dp > 64 || lse != nullptr))) return cudaErrorInvalidValue;
  if (tensor_map_encoder() == nullptr) return cudaErrorSymbolNotFound;
  Params prm{static_cast<bf16*>(o), lse, o_sb, o_sn, o_sh, heads, nq, nk, d, {0, 0, 0}, scale_log2};
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const long long s[3][3] = {{q_sb, q_sn, q_sh}, {k_sb, k_sn, k_sh}, {v_sb, v_sn, v_sh}};
  for (int i = 0; i < 3; ++i) {
    const CUresult res = encode(&maps[i], ptrs[i], batch, i ? nk : nq, heads, d, s[i][0], s[i][1], s[i][2],
                                kBlockN, &prm.n_first[i]);
    if (res != CUDA_SUCCESS) return 10000 + static_cast<int>(res);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tav) return dp == 48 ? launch<48, 48, true>(maps, prm, batch, st) : launch<64, 64, true>(maps, prm, batch, st);
  switch (dp) {
    case 48: return launch<48, 48, false>(maps, prm, batch, st);
    case 64: return launch<64, 64, false>(maps, prm, batch, st);
    case 80: return launch<80, 80, false>(maps, prm, batch, st);
    case 128: return launch<128, 128, false>(maps, prm, batch, st);
    case 160: return launch<160, 80, false>(maps, prm, batch, st);
    case 192: return launch<192, 64, false>(maps, prm, batch, st);
    default: return launch<256, 64, false>(maps, prm, batch, st);
  }
}
