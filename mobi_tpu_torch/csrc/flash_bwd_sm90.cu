// Flash-attention backward for Hopper (sm_90a) in bf16, built from wgmma, TMA
// and warp specialisation. It replaces the TPU kernels K4
// (`_flash_bwd_dq_kernel`, mobi_tpu/ops/flash_attention.py:303) and K5
// (`_flash_bwd_dkv_kernel`, :335) as two kernels with no reduction across
// blocks, as there, so the gradients are the same from run to run. Per
// (batch, head), with scale = d^-1/2 and the forward's lse:
//
//   P  = exp(Q K^T * scale - lse)        (recomputed, never stored)
//   dS = P * (dO V^T - delta) * scale    (rounded to bf16 before its products)
//   K4: dQ = dS K;   K5: dK = dS^T Q and dV = P^T dO, P rounded to bf16.
//
// The dots run in bf16 with fp32 accumulation; P takes one ex2.approx per
// logit, with log2(e) folded into the scale and into lse, and dS is formed as
// P * (dP * scale - delta * scale) with delta * scale taken once per row: two
// fp32 operations a logit beside the exponential. The fp32 K4 and K5 stay on
// flash_bwd.cu (3xTF32 on mma.sync).
//
// What bounds them on the H100: per (batch, head) at N queries and keys, K4
// does 6 N^2 d tensor-core flops and K5 8 N^2 d, each with N^2 exponentials
// on the special-function unit and O(N d) bytes. At the UNet's head dims (40,
// padded to 48, and 80) the exponentials and the products take about the
// same time, and beside each exponential a consumer thread issues the fp32
// operations of dS and the bf16 packing of its A fragments, so a kernel is as
// fast as it keeps the tensor cores and the issue slots of its consumers busy
// at the same time.
//
// The design is flash_fwd_sm90.cu's. A block has three warpgroups. The first
// is the producer: it gives its registers up (setmaxnreg), and one thread
// issues every TMA load, into a ring of stages with full and empty mbarriers.
// The other two are consumers of 64 rows each; the two take turns to issue
// their products (named barriers 3 and 4), so one's exponentials run while
// the other's products are on the tensor cores.
//
//   K4: a block owns 128 query rows. Q and dO are loaded once; K and V
//       stream in 128-key tiles through three stages, which a consumer takes
//       in two steps of 64 keys. Per step it issues S = Q K^T and dP = dO V^T
//       (wgmma m64n64k16, both operands K-major from shared memory) together
//       with the previous step's dQ += dS K (wgmma m64n{48,80}k16, dS from
//       registers, K read MN-major: the same boxes serve both operand
//       orders), forms dS in registers on the accumulator layout while that
//       product runs, and packs it to bf16 A fragments. 64-key steps keep S,
//       dP, dQ and the fragments in flight in ~120 registers; 128-key steps
//       needed ~200, and ptxas spilled and the kernel was much slower.
//   K5: a block owns 128 keys. K and V are loaded once; Q and dO stream in
//       64-row tiles through four stages, which a consumer takes in two
//       steps of 32 queries. Per step it issues S^T = K Q^T and dP^T =
//       V dO^T (wgmma m64n32k16, K-major) together with the previous step's
//       dV += P^T dO and dK += dS^T Q (P^T and dS^T from registers, dO and Q
//       MN-major), and forms P^T and dS^T in registers while those run.
//       32-query steps keep all of it in flight in ~100 registers (d = 80:
//       ~130); 64-query steps needed ~180, ptxas spilled and serialised the
//       wgmmas, and the kernel was much slower (and still a little slower
//       when it waited for dV and dK before each next turn). lse and delta
//       vary along the accumulator's columns (the queries), so the
//       producer's second warp stages each tile's 64 values of both in the
//       ring stage with plain loads (a TMA map of the fp32 [B H, Nq] arrays
//       would need Nq % 4 == 0), lse in log2 units and +inf past Nq, delta
//       times the scale, and its 32 lanes arrive on the stage's full
//       barrier beside the TMA thread.
//
// Head dims: the kernels are built for padded head dims DP = 48, 64, 80 and
// 128, and a call takes the smallest that holds d. At DP = 128 K4's ring has
// two stages, not three: Q, dO and three K/V stages of 128 keys would pass
// the 227 KB a block may have. At DP = 128 both kernels pass the 168
// registers a thread that ptxas allocates under the 384-thread launch
// bound (K5 holds dK and dV, 128 fp32 values a thread): they spill and
// their wgmmas serialise, right but slow.
//
// Ragged edges: TMA zero-fills the rows past N and the head-dim columns past
// d (40 pads to 48; a box wholly past d arrives as zeros). K4 gives the keys
// past nk P = 0 on the ragged step (a zero key row would give exp(-lse),
// which need not be finite); in K5 the query columns past nq have lse =
// +inf, so P = 0 and dS = 0 there. Rows past a block's own N are computed on
// zeros and never stored.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace mobi_flash;
using namespace mobi_sm90;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 3 * 128;  // the producer warpgroup, then two consumers
constexpr int kRows = 128;         // rows a block owns: queries (K4) or keys (K5)
constexpr int kDqTile = 128;       // K4: keys per streamed tile ...
constexpr int kDqStep = 64;        // ... taken in two steps of 64
constexpr int kDkvTile = 64;       // K5: queries per streamed tile ...
constexpr int kDkvStep = 32;       // ... taken in two steps of 32
constexpr int kDkvStages = 4;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr uint32_t kBoxBytes = kRows * kBoxCols * 2;         // a box of 128 rows
constexpr uint32_t kTileBoxBytes = kDkvTile * kBoxCols * 2;  // K5's streamed boxes of 64 rows

struct Params {
  bf16* out[2];            // dq; or dk, dv
  long long out_s[2][3];   // their (batch, n, head) strides in elements
  const float* lse;        // [batch * heads, nq]
  const float* delta;
  int heads, nq, nk, d;
  int n_first[4];          // per tensor map (q, k, v, dout): N is its second dim, else H is
  float scale_log2, scale;
};

template <int DP>
struct DqShared {
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kStages = DP > 80 ? 2 : 3;  // the K/V ring
  alignas(1024) bf16 q[kBoxes][kRows * kBoxCols];
  bf16 dout[kBoxes][kRows * kBoxCols];
  bf16 k[kStages][kBoxes][kDqTile * kBoxCols];
  bf16 v[kStages][kBoxes][kDqTile * kBoxCols];
  uint64_t q_full, full[kStages], empty[kStages];
};

template <int DP>
struct DkvShared {
  static constexpr int kBoxes = DP / kBoxCols;
  alignas(1024) bf16 k[kBoxes][kRows * kBoxCols];
  bf16 v[kBoxes][kRows * kBoxCols];
  bf16 q[kDkvStages][kBoxes][kDkvTile * kBoxCols];
  bf16 dout[kDkvStages][kBoxes][kDkvTile * kBoxCols];
  float lse2[kDkvStages][kDkvTile];  // lse * log2(e), +inf past nq
  float delta[kDkvStages][kDkvTile];  // delta * scale
  uint64_t kv_full, full[kDkvStages], empty[kDkvStages];
};
static_assert(sizeof(DqShared<128>) + 1024 <= 232448 && sizeof(DkvShared<128>) + 1024 <= 232448,
              "the 128 builds fit a block's shared memory");

// The accumulator [64 x 8 NT] as bf16 A fragments, one per 16 columns (the
// m16n8 C layout of two neighbouring 8-column tiles is the A layout).
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NT / 2][4], const float (&c)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// acc [64 x DP] += A B over 16 k-steps of NT / 2: A from registers, B MN-major
// from boxes of `box_bytes` at b_addr.
template <int DP, int KSTEPS>
__device__ __forceinline__ void wgmma_rs(float (&acc)[DP / 8][4], const uint32_t (&a)[KSTEPS][4],
                                         uint32_t b_addr, uint32_t box_bytes) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {  // 16 rows of B: 512 bytes further into every box
    const uint64_t db = gmma_desc(b_addr + kk * 512, box_bytes, 256, kSwizzle32);
    wgmma_rs_n<DP>(acc, a[kk], db);
  }
}

// K-major descriptor of the box at addr (one 16-column k-step).
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) { return gmma_desc(addr, 16, 256, kSwizzle32); }

// D[64 x 8 NT] (+)= A B^T over the head dim, A and B K-major in shared memory:
// DP / 16 k-steps of one box each, the boxes `a_box` and `b_box` bytes apart.
template <int DP, int NT>
__device__ __forceinline__ void wgmma_abt(float (&d)[NT][4], uint32_t a_addr, uint32_t a_box, uint32_t b_addr,
                                          uint32_t b_box) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    if constexpr (NT == 8) wgmma_ss_m64n64(d, kmajor(a_addr + ks * a_box), kmajor(b_addr + ks * b_box), ks);
    else wgmma_ss_m64n32(d, kmajor(a_addr + ks * a_box), kmajor(b_addr + ks * b_box), ks);
  }
}

// ping-pong: the consumers take turns to issue their products (barriers 3, 4)
__device__ __forceinline__ void my_turn(int wg) { named_sync(3 + wg, 256); }
__device__ __forceinline__ void their_turn(int wg) { named_arrive(3 + (wg ^ 1), 256); }

// ------------------------------------------------------------------- K4: dq
template <int DP>
__device__ __forceinline__ void produce_dq(DqShared<DP>& sm, const CUtensorMap* mq, const CUtensorMap* mk,
                                           const CUtensorMap* mv, const CUtensorMap* mdo, const Params& prm,
                                           int b, int h, int m0, int n_tiles) {
  constexpr int kBoxes = DqShared<DP>::kBoxes, kDqStages = DqShared<DP>::kStages;
  prefetch_tensormap(mq);
  prefetch_tensormap(mk);
  prefetch_tensormap(mv);
  prefetch_tensormap(mdo);
  mbar_expect_tx(&sm.q_full, 2 * kBoxes * kBoxBytes);
  for (int i = 0; i < kBoxes; ++i) {
    load_box(sm.q[i], mq, &sm.q_full, prm.n_first[0], i * kBoxCols, m0, h, b);
    load_box(sm.dout[i], mdo, &sm.q_full, prm.n_first[3], i * kBoxCols, m0, h, b);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kDqStages;
    if (j >= kDqStages) mbar_wait(&sm.empty[st], (j / kDqStages - 1) & 1);  // both consumers are done with it
    mbar_expect_tx(&sm.full[st], 2 * kBoxes * kBoxBytes);
    for (int i = 0; i < kBoxes; ++i) {
      load_box(sm.k[st][i], mk, &sm.full[st], prm.n_first[1], i * kBoxCols, j * kDqTile, h, b);
      load_box(sm.v[st][i], mv, &sm.full[st], prm.n_first[2], i * kBoxCols, j * kDqTile, h, b);
    }
  }
}

template <int DP>
__device__ __forceinline__ void consume_dq(DqShared<DP>& sm, const Params& prm, int b, int h, int m0,
                                           int wg, int tid) {
  constexpr int NT = kDqStep / 8;  // 8-key column tiles of S and dP
  constexpr int kSteps = kDqTile / kDqStep, kDqStages = DqShared<DP>::kStages;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const uint32_t q_addr = smem_u32(sm.q[0]) + wg * 64 * 32;  // this consumer's rows of each box
  const uint32_t do_addr = smem_u32(sm.dout[0]) + wg * 64 * 32;
  const int row0 = m0 + wg * 64 + warp * 16;

  // rows g and g + 8 of this warp's slab: lse in log2 units, and delta * scale
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const long long i = static_cast<long long>(b * prm.heads + h) * prm.nq + row;
    lse2[r] = row < prm.nq ? prm.lse[i] * kLog2e : 0.f;
    dlt[r] = row < prm.nq ? prm.delta[i] * prm.scale : 0.f;
  }
  float s[NT][4], dp[NT][4], acc[DP / 8][4];
  uint32_t ds[NT / 2][4];  // the last step's dS as bf16 A fragments
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // Step u takes keys [64 u, 64 u + 64): half u % 2 of the ring's tile u / 2.
  auto key_rows = [&](const auto& boxes, int u) {
    return smem_u32(boxes[(u / kSteps) % kDqStages][0]) + (u % kSteps) * kDqStep * 32;
  };
  auto issue_s_dp = [&](int u) {  // S = Q K_u^T, dP = dO V_u^T
    if (u % kSteps == 0) mbar_wait(&sm.full[(u / kSteps) % kDqStages], (u / kSteps / kDqStages) & 1);
    const uint32_t k_addr = key_rows(sm.k, u), v_addr = key_rows(sm.v, u);
    wgmma_fence();
    wgmma_abt<DP>(s, q_addr, kBoxBytes, k_addr, kBoxBytes);
    wgmma_abt<DP>(dp, do_addr, kBoxBytes, v_addr, kBoxBytes);
    wgmma_commit();
  };
  auto issue_dq = [&](int u) {  // dQ += dS_u K_u
    wgmma_fence();
    wgmma_rs<DP, NT / 2>(acc, ds, key_rows(sm.k, u), kBoxBytes);
    wgmma_commit();
  };
  auto make_ds = [&](int u) {  // S -> dS in place, fp32
    const int n0 = u * kDqStep;
    const bool ragged = n0 + kDqStep > prm.nk;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float p = exp2_approx(fmaf(s[nt][jj], prm.scale_log2, -lse2[jj >> 1]));
        if (ragged && n0 + nt * 8 + t2 + (jj & 1) >= prm.nk) p = 0.f;
        s[nt][jj] = p * fmaf(dp[nt][jj], prm.scale, -dlt[jj >> 1]);
      }
    }
  };
  auto release = [&](int j) {  // this warp is done with tile j's K and V
    if (lane == 0) mbar_arrive(&sm.empty[j % kDqStages]);
  };

  const int n_steps = (prm.nk + kDqStep - 1) / kDqStep;
  if (wg == 1) their_turn(wg);  // consumer 0 goes first
  mbar_wait(&sm.q_full, 0);
  my_turn(wg);
  issue_s_dp(0);
  their_turn(wg);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  make_ds(0);
  pack_a<NT>(ds, s);
  for (int u = 1; u < n_steps; ++u) {
    my_turn(wg);
    issue_s_dp(u);    // S(u), dP(u) ...
    issue_dq(u - 1);  // ... and dS(u-1) K(u-1) on the tensor cores together
    their_turn(wg);
    wgmma_wait<1>();  // S(u) and dP(u) have landed
    fence_regs(s);
    fence_regs(dp);
    make_ds(u);
    wgmma_wait<0>();  // dQ += dS(u-1) K(u-1) too
    fence_regs(acc);
    fence_regs(ds);
    if (u % kSteps == 0) release(u / kSteps - 1);  // every step of the previous tile is done
    pack_a<NT>(ds, s);
  }
  my_turn(wg);
  issue_dq(n_steps - 1);
  if (wg == 0) their_turn(wg);  // consumer 1 takes the last turn
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(ds);

  const float one[2] = {1.f, 1.f};
  store_rows<DP>(prm.out[0] + b * prm.out_s[0][0] + h * prm.out_s[0][2], prm.out_s[0][1], acc, one, row0,
                 prm.nq, prm.d, g, t2);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                             const Params prm) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment of the shared address
  auto& sm = *reinterpret_cast<DqShared<DP>*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int b = blockIdx.y / prm.heads, h = blockIdx.y % prm.heads;
  const int m0 = blockIdx.x * kRows;
  const int n_tiles = (prm.nk + kDqTile - 1) / kDqTile;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < DqShared<DP>::kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one branch per role for the whole kernel, so setmaxnreg takes effect
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) produce_dq(sm, &map_q, &map_k, &map_v, &map_do, prm, b, h, m0, n_tiles);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume_dq(sm, prm, b, h, m0, threadIdx.x / 128 - 1, threadIdx.x % 128);
  }
}

// ------------------------------------------------------------- K5: dk, dv
template <int DP>
__device__ __forceinline__ void produce_dkv(DkvShared<DP>& sm, const CUtensorMap* mq, const CUtensorMap* mk,
                                            const CUtensorMap* mv, const CUtensorMap* mdo, const Params& prm,
                                            int b, int h, int n0, int n_tiles) {
  constexpr int kBoxes = DkvShared<DP>::kBoxes;
  prefetch_tensormap(mq);
  prefetch_tensormap(mk);
  prefetch_tensormap(mv);
  prefetch_tensormap(mdo);
  mbar_expect_tx(&sm.kv_full, 2 * kBoxes * kBoxBytes);
  for (int i = 0; i < kBoxes; ++i) {
    load_box(sm.k[i], mk, &sm.kv_full, prm.n_first[1], i * kBoxCols, n0, h, b);
    load_box(sm.v[i], mv, &sm.kv_full, prm.n_first[2], i * kBoxCols, n0, h, b);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kDkvStages;
    if (j >= kDkvStages) mbar_wait(&sm.empty[st], (j / kDkvStages - 1) & 1);
    mbar_expect_tx(&sm.full[st], 2 * kBoxes * kTileBoxBytes);
    for (int i = 0; i < kBoxes; ++i) {
      load_box(sm.q[st][i], mq, &sm.full[st], prm.n_first[0], i * kBoxCols, j * kDkvTile, h, b);
      load_box(sm.dout[st][i], mdo, &sm.full[st], prm.n_first[3], i * kBoxCols, j * kDkvTile, h, b);
    }
  }
}

// The producer's second warp: each tile's lse (log2 units, +inf past nq) and
// delta * scale into its ring stage; every lane arrives on the stage's full barrier
// after its stores.
template <int DP>
__device__ __forceinline__ void stage_stats(DkvShared<DP>& sm, const Params& prm, int bh, int n_tiles,
                                            int lane) {
  const float* lse = prm.lse + static_cast<long long>(bh) * prm.nq;
  const float* delta = prm.delta + static_cast<long long>(bh) * prm.nq;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kDkvStages;
    if (j >= kDkvStages) mbar_wait(&sm.empty[st], (j / kDkvStages - 1) & 1);
    for (int r = lane; r < kDkvTile; r += 32) {
      const int row = j * kDkvTile + r;
      sm.lse2[st][r] = row < prm.nq ? lse[row] * kLog2e : INFINITY;
      sm.delta[st][r] = row < prm.nq ? delta[row] * prm.scale : 0.f;
    }
    mbar_arrive(&sm.full[st]);
  }
}

template <int DP>
__device__ __forceinline__ void consume_dkv(DkvShared<DP>& sm, const Params& prm, int b, int h, int n0, int wg,
                                            int tid) {
  constexpr int NT = kDkvStep / 8;  // 8-query column tiles of S^T and dP^T
  constexpr int kSteps = kDkvTile / kDkvStep;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const uint32_t k_addr = smem_u32(sm.k[0]) + wg * 64 * 32;  // this consumer's keys of each box
  const uint32_t v_addr = smem_u32(sm.v[0]) + wg * 64 * 32;
  const int row0 = n0 + wg * 64 + warp * 16;

  float s[NT][4], dp[NT][4], dk[DP / 8][4], dv[DP / 8][4];
  uint32_t pf[NT / 2][4], dsf[NT / 2][4];  // the last step's P^T and dS^T as bf16 A fragments
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[i][c] = dv[i][c] = 0.f;

  // Step u takes queries [32 u, 32 u + 32): part u % 2 of the ring's tile u / 2.
  auto query_rows = [&](const auto& boxes, int u) {
    return smem_u32(boxes[(u / kSteps) % kDkvStages][0]) + (u % kSteps) * kDkvStep * 32;
  };
  auto issue_s_dp = [&](int u) {  // S^T = K Q_u^T, dP^T = V dO_u^T
    if (u % kSteps == 0) mbar_wait(&sm.full[(u / kSteps) % kDkvStages], (u / kSteps / kDkvStages) & 1);
    const uint32_t q_addr = query_rows(sm.q, u), do_addr = query_rows(sm.dout, u);
    wgmma_fence();
    wgmma_abt<DP>(s, k_addr, kBoxBytes, q_addr, kTileBoxBytes);
    wgmma_abt<DP>(dp, v_addr, kBoxBytes, do_addr, kTileBoxBytes);
    wgmma_commit();
  };
  auto issue_dkv = [&](int u) {  // dV += P_u^T dO_u, dK += dS_u^T Q_u
    wgmma_fence();
    wgmma_rs<DP, NT / 2>(dv, pf, query_rows(sm.dout, u), kTileBoxBytes);
    wgmma_rs<DP, NT / 2>(dk, dsf, query_rows(sm.q, u), kTileBoxBytes);
    wgmma_commit();
  };
  auto make_p_ds = [&](int u) {  // S^T -> P^T and dP^T -> dS^T in place, fp32
    const int st = (u / kSteps) % kDkvStages, q0 = (u % kSteps) * kDkvStep;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {  // queries 8 nt + t2, + 1 of the step
      const float2 l = *reinterpret_cast<const float2*>(&sm.lse2[st][q0 + nt * 8 + t2]);
      const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[st][q0 + nt * 8 + t2]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = exp2_approx(fmaf(s[nt][jj], prm.scale_log2, -((jj & 1) ? l.y : l.x)));
        s[nt][jj] = p;
        dp[nt][jj] = p * fmaf(dp[nt][jj], prm.scale, -((jj & 1) ? dl.y : dl.x));
      }
    }
  };
  auto pack = [&]() {
    pack_a<NT>(pf, s);
    pack_a<NT>(dsf, dp);
  };
  auto release = [&](int j) {  // this warp is done with tile j's Q, dO, lse and delta
    if (lane == 0) mbar_arrive(&sm.empty[j % kDkvStages]);
  };

  const int n_steps = (prm.nq + kDkvStep - 1) / kDkvStep;
  if (wg == 1) their_turn(wg);  // consumer 0 goes first
  mbar_wait(&sm.kv_full, 0);
  my_turn(wg);
  issue_s_dp(0);
  their_turn(wg);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  make_p_ds(0);
  pack();
  for (int u = 1; u < n_steps; ++u) {
    my_turn(wg);
    issue_s_dp(u);     // S^T(u), dP^T(u) ...
    issue_dkv(u - 1);  // ... and the products of step u-1 on the tensor cores together
    their_turn(wg);
    wgmma_wait<1>();   // S^T(u) and dP^T(u) have landed
    fence_regs(s);
    fence_regs(dp);
    make_p_ds(u);
    wgmma_wait<0>();   // dV and dK of step u-1 too
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pf);
    fence_regs(dsf);
    if (u % kSteps == 0) release(u / kSteps - 1);  // every step of the previous tile is done
    pack();
  }
  my_turn(wg);
  issue_dkv(n_steps - 1);
  if (wg == 0) their_turn(wg);  // consumer 1 takes the last turn
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  fence_regs(pf);
  fence_regs(dsf);

  const float one[2] = {1.f, 1.f};
  store_rows<DP>(prm.out[0] + b * prm.out_s[0][0] + h * prm.out_s[0][2], prm.out_s[0][1], dk, one, row0,
                 prm.nk, prm.d, g, t2);
  store_rows<DP>(prm.out[1] + b * prm.out_s[1][0] + h * prm.out_s[1][2], prm.out_s[1][1], dv, one, row0,
                 prm.nk, prm.d, g, t2);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                              const Params prm) {
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DkvShared<DP>*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int b = blockIdx.y / prm.heads, h = blockIdx.y % prm.heads;
  const int n0 = blockIdx.x * kRows;
  const int n_tiles = (prm.nq + kDkvTile - 1) / kDkvTile;
  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&sm.full[s], 1 + 32);  // the TMA thread's, and each stats lane's
      mbar_init(&sm.empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) produce_dkv(sm, &map_q, &map_k, &map_v, &map_do, prm, b, h, n0, n_tiles);
    else if (threadIdx.x / 32 == 1) stage_stats(sm, prm, blockIdx.y, n_tiles, threadIdx.x % 32);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume_dkv(sm, prm, b, h, n0, threadIdx.x / 128 - 1, threadIdx.x % 128);
  }
}

// ------------------------------------------------------------------- host
template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, int n_rows, int batch, const CUtensorMap* maps, const Params& prm,
                   cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_rows + kRows - 1) / kRows, batch * prm.heads);
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], prm);
  return cudaGetLastError();
}

// The maps of q, k, v, dout (boxes of q_rows rows for q and dout, k_rows
// for k and v) and the parameters; 0, or the error to return.
int setup(CUtensorMap (&maps)[4], Params& prm, const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* delta, int batch, int heads, int nq, int nk, int d,
          const long long* strides, int q_rows, int k_rows, float scale) {
  if (padded_head_dim(d) == 0 || nq <= 0 || nk <= 0) return cudaErrorInvalidValue;
  if (tensor_map_encoder() == nullptr) return cudaErrorSymbolNotFound;
  prm.lse = lse;
  prm.delta = delta;
  prm.heads = heads;
  prm.nq = nq;
  prm.nk = nk;
  prm.d = d;
  prm.scale = scale;
  prm.scale_log2 = scale * kLog2e;
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const long long* s = strides + 3 * i;
    const CUresult res = encode(&maps[i], ptrs[i], batch, (i == 0 || i == 3) ? nq : nk, heads, d, s[0], s[1],
                                s[2], (i == 0 || i == 3) ? q_rows : k_rows, &prm.n_first[i]);
    if (res != CUDA_SUCCESS) return 10000 + static_cast<int>(res);
  }
  return 0;
}

}  // namespace

// q, k, v, dout: [batch, n, heads, d] bf16 with unit stride in d, d a multiple
// of 8 up to 128, 16-byte aligned pointers and strides; lse,
// delta: contiguous fp32 [batch, heads, nq]; dq: [batch, nq, heads, d] bf16.
// strides: 15 element strides, (batch, n, head) of q, k, v, dout, dq in turn.
// scale: d^-1/2. Returns the cudaError_t of the launch, or 10000 + the
// CUresult of a tensor map that could not be encoded.
extern "C" int mobi_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                                      const float* lse, const float* delta, void* dq, int batch, int heads,
                                      int nq, int nk, int d, const long long* strides, float scale,
                                      void* stream) {
  CUtensorMap maps[4];
  Params prm{};
  const int err = setup(maps, prm, q, k, v, dout, lse, delta, batch, heads, nq, nk, d, strides, kRows, kDqTile,
                        scale);
  if (err) return err;
  prm.out[0] = static_cast<bf16*>(dq);
  for (int j = 0; j < 3; ++j) prm.out_s[0][j] = strides[12 + j];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded_head_dim(d)) {
    case 48: return launch(flash_bwd_dq_sm90_kernel<48>, sizeof(DqShared<48>) + 1024, nq, batch, maps, prm, st);
    case 64: return launch(flash_bwd_dq_sm90_kernel<64>, sizeof(DqShared<64>) + 1024, nq, batch, maps, prm, st);
    case 80: return launch(flash_bwd_dq_sm90_kernel<80>, sizeof(DqShared<80>) + 1024, nq, batch, maps, prm, st);
    default: return launch(flash_bwd_dq_sm90_kernel<128>, sizeof(DqShared<128>) + 1024, nq, batch, maps, prm, st);
  }
}

// As mobi_flash_bwd_dq_sm90, with dk and dv ([batch, nk, heads, d] bf16) as
// the outputs and 18 strides: q, k, v, dout, dk, dv.
extern "C" int mobi_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                                       const float* lse, const float* delta, void* dk, void* dv, int batch,
                                       int heads, int nq, int nk, int d, const long long* strides, float scale,
                                       void* stream) {
  CUtensorMap maps[4];
  Params prm{};
  const int err = setup(maps, prm, q, k, v, dout, lse, delta, batch, heads, nq, nk, d, strides, kDkvTile, kRows,
                        scale);
  if (err) return err;
  prm.out[0] = static_cast<bf16*>(dk);
  prm.out[1] = static_cast<bf16*>(dv);
  for (int j = 0; j < 3; ++j) {
    prm.out_s[0][j] = strides[12 + j];
    prm.out_s[1][j] = strides[15 + j];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded_head_dim(d)) {
    case 48: return launch(flash_bwd_dkv_sm90_kernel<48>, sizeof(DkvShared<48>) + 1024, nk, batch, maps, prm, st);
    case 64: return launch(flash_bwd_dkv_sm90_kernel<64>, sizeof(DkvShared<64>) + 1024, nk, batch, maps, prm, st);
    case 80: return launch(flash_bwd_dkv_sm90_kernel<80>, sizeof(DkvShared<80>) + 1024, nk, batch, maps, prm, st);
    default: return launch(flash_bwd_dkv_sm90_kernel<128>, sizeof(DkvShared<128>) + 1024, nk, batch, maps, prm, st);
  }
}
