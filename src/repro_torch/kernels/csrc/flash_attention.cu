// Blocked online-softmax attention, forward, for Hopper (sm_90a):
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, g]) v[b, j, g]
//   lse[b, h, i] = log sum_j exp(scale * q[b, i, h] . k[b, j, g])
//
// with g = h / (H / KV) (GQA, indexed here instead of repeated), i < S the
// queries and j < Skv the keys, key j visible to query i iff j <= i
// (causal) and j > i - window (window).  Skv differs from S only without
// the causal mask and the window (cross-attention: a decoder's queries
// over an encoder's keys; the wrapper checks it).
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention_pallas
// (kernel body _attn_kernel).  Kept from it: the masked scores are the
// finite -1e30, the running statistics (m, l) and the accumulator are
// float32, a (q tile, kv tile) pair that no query of the tile can see is
// skipped (tiles.cuh tile_relevant), and the output divides by
// max(l, 1e-30).  New: the row log-sum-exp m + log(l), which the backward
// kernel (flash_attention_bwd.cu) uses to recompute the probabilities.
//
// Layout: q (B, S, H, D) and k, v (B, Skv, KV, D), the model's own layout, so
// no transpose or repeat runs before the kernel; lse (B, H, S) float32.
//
// Design, bf16.  The TPU grid (b*h, q blocks, kv blocks) runs its kv axis in
// order and carries (m, l, acc) in VMEM; here one block owns (b, h, 128-query
// tile) and walks its kv tiles in a loop, with two warpgroups of 64 query
// rows each (hopper.cuh).  Thread 0 also feeds the TMA loads: the Q tile
// once, then the K and V tiles (128 keys) through a 3-slot ring, each slot
// with full and empty mbarriers.  Per kv tile a warpgroup issues S = Q K^T
// by wgmma from shared memory beside the previous tile's O += P V (P as the
// register A operand, V read MN-major), runs the online softmax of S in
// registers while that product computes (the mask only on tiles that cross
// the diagonal, the window's edge or Skv; exp2 with log2 e folded into the
// scale; a row's max across its quad by shuffles; the O rescale owed to it
// applied before the next product), then packs P to bf16 in registers.  The
// epilogue writes O / l as bf16 over the warpgroup's own Q rows in shared
// memory and stores it by TMA, which clips at S.  The q tiles launch
// heaviest first: under a causal mask the last tile sees the most keys.
// Head dims up to 64 run as 64 columns and up to 128 as 128; TMA fills the
// columns past D with zeros.
//
// Float32 keeps the CUDA-core route (tiles.cuh tile_mma<float>, 32 x 32
// tiles, eight warps), for full float32 precision: the tensor cores would
// round its inputs to TF32.
//
// What bounds it on the card: at the training shape (B 16, S 512, H 16,
// KV 8, D 128, causal, bf16) it moves ~100 MB and does ~1.7e10 FLOPs, so
// its bound is the bytes (~30 us at 3.35 TB/s).  It runs at about three
// times that bound and 1.8 times SDPA (PERF.md); without a profiler of the
// SM's pipes on the card's machine, what holds it there is not measured.
#include "hopper.cuh"
#include "tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

// ------------------------------------------------------------- bf16, Hopper
// Two warpgroups and no producer warpgroup: ptxas budgets the registers of
// wgmma code by the block's launch bound, and three warpgroups would cap a
// thread at 168 (setmaxnreg does not lift that budget), where a consumer
// here holds O, S and the P of a product in flight.  Thread 0 feeds the
// ring instead.
constexpr int BQ = 128, BK = 128, STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int DP>
struct FwdLayout {
  static constexpr int q = 0;
  static constexpr int k = q + BQ * DP * 2;
  static constexpr int v = k + STAGES * BK * DP * 2;
  static constexpr int bars = v + STAGES * BK * DP * 2;  // q_full, k_full[], v_full[], empty[]
  static constexpr int bytes = bars + 8 * (1 + 3 * STAGES) + 1024;  // + alignment slack
};

template <int DP>
__global__ void __launch_bounds__(2 * WG_THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tout,
                      float* __restrict__ lse, int S, int Skv, int H, int KV, int causal, int window,
                      float scale_log2) {
  using L = FwdLayout<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::q);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::v);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest causal tile first
  const int g = h / (H / KV);
  int first, last;
  relevant_kv_tiles(q0, BQ, BK, (Skv + BK - 1) / BK, causal, window, first, last);
  const int cw = warpgroup_index();  // warpgroup cw owns query rows [q0 + 64 cw, q0 + 64 cw + 64)
  const int t = threadIdx.x % WG_THREADS, lane = t & 31;
  const bool feeder = threadIdx.x == 0;
  if (feeder) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // kv tile kt into slot (kt - first) % STAGES once the tile before it in
  // that slot is done
  auto feed = [&](int kt) {
    const int i = kt - first, slot = i % STAGES;
    mbar_wait(&empty[slot], ((i / STAGES) & 1) ^ 1);
    mbar_arrive_expect_tx(&k_full[slot], BK * DP * 2);
    tma_load_tile<DP, BK>(k_s + slot * BK * DP, &tk, &k_full[slot], g, kt * BK, b);
    mbar_arrive_expect_tx(&v_full[slot], BK * DP * 2);
    tma_load_tile<DP, BK>(v_s + slot * BK * DP, &tv, &v_full[slot], g, kt * BK, b);
  };
  if (feeder) {
    mbar_arrive_expect_tx(q_full, BQ * DP * 2);
    tma_load_tile<DP, BQ>(q_s, &tq, q_full, h, q0, b);
    for (int kt = first; kt < last && kt < first + STAGES - 1; ++kt) feed(kt);
  }

  const int qlo = q0 + 64 * cw, qhi = qlo + 63;
  const int qa = qlo + 16 * (t >> 5) + (lane >> 2), qb = qa + 8;  // this thread's two rows
  float o[DP / 2], s[BK / 2];
  uint32_t p[BK / 16][4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;  // m in log2 units; l this thread's share of the row
  float alpha0 = 1.f, alpha1 = 1.f;                     // O's rescale owed to the last softmax
  auto rescale_o = [&]() {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
  };
  // O += P V of tile i (counted from first), issued and committed
  auto issue_pv = [&](int i) {
    mbar_wait(&v_full[i % STAGES], (i / STAGES) & 1);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    const SmemDesc vd = mnmajor_base(v_s + (i % STAGES) * BK * DP, BK);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<DP, 1>(o, p[kk], vd.at(mnmajor_step(kk)), 1);
    wgmma_commit();
  };
  mbar_wait(q_full, 0);
  // Per tile: S = Q K^T, issued beside the previous tile's O += P V; the
  // softmax of S runs while that product computes; then P is packed.
  for (int kt = first; kt < last; ++kt) {
    const int i = kt - first, k0 = kt * BK;
    rescale_o();
    mbar_wait(&k_full[i % STAGES], (i / STAGES) & 1);
    wgmma_fence();
    {
      const SmemDesc qd = kmajor_base(q_s, 64 * cw), kd = kmajor_base(k_s + (i % STAGES) * BK * DP, 0);
      wgmma_ss_init<BK, 0>(s, qd.at(kmajor_step(BQ, 0)), kd.at(kmajor_step(BK, 0)));
#pragma unroll
      for (int kk = 1; kk < DP / 16; ++kk) wgmma_ss<BK, 0>(s, qd.at(kmajor_step(BQ, kk)), kd.at(kmajor_step(BK, kk)), 1);
      wgmma_commit();
    }
    if (i > 0) {
      issue_pv(i - 1);
      wgmma_wait<1>();  // S is ready; the previous tile's P V may still run
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);

    const bool full = k0 + BK <= Skv && (!causal || k0 + BK - 1 <= qlo) && (window <= 0 || k0 > qhi - window);
    float mx0 = MASKED, mx1 = MASKED;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (!full && !key_visible(e < 2 ? qa : qb, k0 + 8 * j + 2 * (lane & 3) + (e & 1), Skv, causal, window))
          x = MASKED;
        s[4 * j + e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    alpha0 = exp2f(m0 - mn0);
    alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[4 * j] = exp2f(s[4 * j] - mn0);
      s[4 * j + 1] = exp2f(s[4 * j + 1] - mn0);
      s[4 * j + 2] = exp2f(s[4 * j + 2] - mn1);
      s[4 * j + 3] = exp2f(s[4 * j + 3] - mn1);
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
    wgmma_wait<0>();  // the previous tile's P V is done: its slot and p are free
    fence_regs(o);
    fence_regs(p);
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
    acc_to_a<BK>(s, p);
    // into the slot this turn freed (once the other warpgroup frees it too)
    if (feeder && kt + STAGES - 1 < last) feed(kt + STAGES - 1);
    __syncwarp();
  }
  if (first < last) {  // the last tile's P V
    rescale_o();
    issue_pv(last - 1 - first);
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&empty[(last - 1 - first) % STAGES]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  // O / l over this warpgroup's own Q rows (no other warpgroup reads them)
  acc_to_tile<DP>(o, 1.f / l0, 1.f / l1, q_s, BQ, 64 * cw);
  fence_proxy_async();
  named_sync(1 + cw, WG_THREADS);
  if (t == 0 && qlo < S) {
    tma_store_rows<DP>(&tout, q_s, BQ, cw, h, qlo, b);
    tma_store_flush();
  }
  if ((lane & 3) == 0) {
    float* row = lse + ((long long)b * H + h) * S;
    if (qa < S) row[qa] = m0 * LN2 + logf(l0);
    if (qb < S) row[qb] = m1 * LN2 + logf(l1);
  }
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S, int Skv, int H,
                int KV, int D, int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tout;
  int err = make_map_4d(&tq, q, D, H, S, B);
  if (!err) err = make_map_4d(&tk, k, D, KV, Skv, B);
  if (!err) err = make_map_4d(&tv, v, D, KV, Skv, B);
  if (!err) err = make_map_4d(&tout, out, D, H, S, B);
  if (err) return err;
  constexpr int bytes = FwdLayout<DP>::bytes;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_fwd_bf16_kernel<DP><<<grid, 2 * WG_THREADS, bytes, stream>>>(tq, tk, tv, tout, lse, S, Skv, H, KV, causal,
                                                                      window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- float32, CUDA cores
struct FwdSmemF32 {
  static constexpr int BQ = Tile<float>::R, BK = Tile<float>::R;
  int D, ldt, lds, ldp, ldo;
  size_t q, k, v, s, p, o, m, l, alpha, bytes;
  __host__ __device__ explicit FwdSmemF32(int d) : D(d) {
    ldt = D + PAD_T;
    lds = BK + PAD_F;
    ldp = BK + PAD_T;
    ldo = D + PAD_F;
    q = 0;
    k = q + align128(sizeof(float) * BQ * ldt);
    v = k + align128(sizeof(float) * BK * ldt);
    s = v + align128(sizeof(float) * BK * ldt);
    p = s + align128(sizeof(float) * BQ * lds);
    o = p + align128(sizeof(float) * BQ * ldp);
    m = o + align128(sizeof(float) * BQ * ldo);
    l = m + align128(sizeof(float) * BQ);
    alpha = l + align128(sizeof(float) * BQ);
    bytes = alpha + align128(sizeof(float) * BQ);
  }
};

__global__ void __launch_bounds__(TILE_THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ out, float* __restrict__ lse, int S, int Skv, int H, int KV, int D,
                     int causal, int window, float scale) {
  constexpr int BQ = FwdSmemF32::BQ, BK = FwdSmemF32::BK;
  static_assert(BK % 32 == 0, "a warp covers a score row in BK / 32 columns per lane");
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmemF32 L(D);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* k_s = reinterpret_cast<float*>(smem + L.k);
  float* v_s = reinterpret_cast<float*>(smem + L.v);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* o_s = reinterpret_cast<float*>(smem + L.o);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* alpha_s = reinterpret_cast<float*>(smem + L.alpha);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int g = h / (H / KV);
  const long long qtok = (long long)H * D, ktok = (long long)KV * D;

  load_rows(q_s, L.ldt, q + ((long long)b * S + q0) * qtok + (long long)h * D, qtok, BQ, min(BQ, S - q0), D);
  for (int i = tid; i < BQ; i += blockDim.x) {
    m_s[i] = MASKED;
    l_s[i] = 0.f;
  }
  for (int e = tid; e < BQ * D; e += blockDim.x) o_s[(e / D) * L.ldo + e % D] = 0.f;
  __syncthreads();

  const int nk = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (!tile_relevant(q0, k0, BQ, BK, causal, window)) continue;
    const long long krow = ((long long)b * Skv + k0) * ktok + (long long)g * D;
    load_rows(k_s, L.ldt, k + krow, ktok, BK, min(BK, Skv - k0), D);
    load_rows(v_s, L.ldt, v + krow, ktok, BK, min(BK, Skv - k0), D);
    __syncthreads();
    tile_mma<true>(s_s, L.lds, q_s, L.ldt, k_s, L.ldt, BQ, BK, D, false);  // S = Q K^T
    __syncthreads();
    for (int r = warp; r < BQ; r += nwarps) {  // online softmax, one warp per row
      const int qi = q0 + r;
      float sv[BK / 32];
      float mx = MASKED;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const int col = lane + 32 * c;
        const float x = s_s[r * L.lds + col] * scale;
        sv[c] = key_visible(qi, k0 + col, Skv, causal, window) ? x : MASKED;
        mx = fmaxf(mx, sv[c]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const float p = expf(sv[c] - m_new);
        p_s[r * L.ldp + lane + 32 * c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < BQ * D; e += blockDim.x) o_s[(e / D) * L.ldo + e % D] *= alpha_s[e / D];
    __syncthreads();
    tile_mma<false>(o_s, L.ldo, p_s, L.ldp, v_s, L.ldt, BQ, D, BK, true);  // O += P V
    __syncthreads();
  }

  for (int e = tid; e < BQ * D; e += blockDim.x) {
    const int i = e / D, j = e % D;
    if (q0 + i < S) {
      out[((long long)b * S + q0 + i) * qtok + (long long)h * D + j] = o_s[i * L.ldo + j] / fmaxf(l_s[i], 1e-30f);
    }
  }
  for (int i = tid; i < BQ; i += blockDim.x) {
    if (q0 + i < S) lse[((long long)b * H + h) * S + q0 + i] = m_s[i] + logf(fmaxf(l_s[i], 1e-30f));
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S, int Skv, int H, int KV,
               int D, int causal, int window, float scale, cudaStream_t stream) {
  const FwdSmemF32 L(D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + FwdSmemF32::BQ - 1) / FwdSmemF32::BQ, H, B);
  flash_fwd_f32_kernel<<<grid, TILE_THREADS, L.bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, S, Skv, H, KV, D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ wgmma probe (tests only)
// C (64 x N, float32, row-major) = A (64 x K) B through one warpgroup's
// wgmma, with the operands loaded by TMA into swizzled tiles: A K-major
// (SS) or as register fragments read from global memory (RS); B given as
// its transpose, N x K row-major (K-major), or as K x N row-major
// (MN-major).  The accumulator goes out through its fragment layout.  It
// holds each form the attention kernels and lora_matmul use against
// torch.matmul.
template <int N, int K, bool RS, bool B_MN>
__global__ void __launch_bounds__(WG_THREADS)
wgmma_probe_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                   const bf16* __restrict__ a, float* __restrict__ c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = a_s + 64 * K;
  uint64_t& bar = *reinterpret_cast<uint64_t*>(b_s + N * K);
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  if (t == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (t == 0) {
    mbar_arrive_expect_tx(&bar, (64 * K + N * K) * 2);
    tma_load_tile<K, 64>(a_s, &ta, &bar, 0, 0, 0);
    if (B_MN) {
      tma_load_tile<N, K>(b_s, &tb, &bar, 0, 0, 0);
    } else {
      tma_load_tile<K, N>(b_s, &tb, &bar, 0, 0, 0);
    }
  }
  uint32_t af[K / 16][4];
  const int r = 16 * w + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bf16* src = a + (r + 8 * (i & 1)) * K + 16 * kk + 8 * (i >> 1) + cq;
      af[kk][i] = pack_bf16(__bfloat162float(src[0]), __bfloat162float(src[1]));
    }
  }
  mbar_wait(&bar, 0);
  float d[N / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = B_MN ? mnmajor_base(b_s, K).at(mnmajor_step(kk)) : kmajor_base(b_s, 0).at(kmajor_step(N, kk));
    if constexpr (RS) {
      wgmma_rs<N, B_MN ? 1 : 0>(d, af[kk], db, kk > 0);
    } else {
      wgmma_ss<N, B_MN ? 1 : 0>(d, kmajor_base(a_s, 0).at(kmajor_step(64, kk)), db, kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[(r + 8 * (e >> 1)) * N + 8 * j + cq + (e & 1)] = d[4 * j + e];
  }
}

template <int N, int K, bool RS, bool B_MN>
int probe(const void* a, const void* b, void* c, cudaStream_t stream) {
  CUtensorMap ta, tb;
  int err = make_map_4d(&ta, a, K, 1, 64, 1);
  if (!err) err = B_MN ? make_map_4d(&tb, b, N, 1, K, 1) : make_map_4d(&tb, b, K, 1, N, 1);
  if (err) return err;
  constexpr int bytes = (64 * K + N * K) * 2 + 8 + 1024;
  cudaError_t e = cudaFuncSetAttribute(wgmma_probe_kernel<N, K, RS, B_MN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgmma_probe_kernel<N, K, RS, B_MN><<<1, WG_THREADS, bytes, stream>>>(ta, tb, static_cast<const bf16*>(a),
                                                                        static_cast<float*>(c));
  return static_cast<int>(cudaGetLastError());
}

template <int N, int K>
int probe_forms(int rs, int b_mn, const void* a, const void* b, void* c, cudaStream_t stream) {
  if (rs) return b_mn ? probe<N, K, true, true>(a, b, c, stream) : probe<N, K, true, false>(a, b, c, stream);
  return b_mn ? probe<N, K, false, true>(a, b, c, stream) : probe<N, K, false, false>(a, b, c, stream);
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused launch, -1 for
// arguments the kernel does not take (among them Skv != S under a causal
// mask or a window), or -2 if CUDA refuses a tensor map.  Shapes, dtypes,
// devices and contiguity are checked by the Python wrapper
// (repro_torch/kernels/ops.py).
extern "C" int flash_attention_fwd_launch(int dtype, const void* q, const void* k, const void* v, void* out,
                                          void* lse, int B, int S, int Skv, int H, int KV, int D, int causal,
                                          int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D % 16 != 0 || D > MAX_D) return -1;
  if (Skv != S && (causal || window > 0)) return -1;
  if (H > 65535 || B > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == kFloat32) return launch_f32(q, k, v, out, l, B, S, Skv, H, KV, D, causal, window, scale, s);
  if (dtype == kBFloat16) {
    if (D <= 64) return launch_bf16<64>(q, k, v, out, l, B, S, Skv, H, KV, D, causal, window, scale, s);
    return launch_bf16<128>(q, k, v, out, l, B, S, Skv, H, KV, D, causal, window, scale, s);
  }
  return -1;
}

// Test entry: one wgmma product of a (64 x k) by b, see wgmma_probe_kernel;
// n and k are 64 or 128, or n 256 and k 64 with A from shared memory (the
// forms of lora_matmul.cu).  a, b bf16 and c float32, contiguous.
extern "C" int hopper_wgmma_probe(int rs, int b_mn, int n, int k, const void* a, const void* b, void* c,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 256 && k == 64 && !rs) return b_mn ? probe<256, 64, false, true>(a, b, c, s) : probe<256, 64, false, false>(a, b, c, s);
  if (n == 64 && k == 64) return probe_forms<64, 64>(rs, b_mn, a, b, c, s);
  if (n == 64 && k == 128) return probe_forms<64, 128>(rs, b_mn, a, b, c, s);
  if (n == 128 && k == 64) return probe_forms<128, 64>(rs, b_mn, a, b, c, s);
  if (n == 128 && k == 128) return probe_forms<128, 128>(rs, b_mn, a, b, c, s);
  return -1;
}

// Dynamic shared memory a launch at head dim D asks for (for reports).
extern "C" int flash_attention_fwd_smem_bytes(int dtype, int D) {
  if (dtype == kFloat32) return static_cast<int>(FwdSmemF32(D).bytes);
  return D <= 64 ? FwdLayout<64>::bytes : FwdLayout<128>::bytes;
}
