// Blocked attention backward for Hopper (sm_90a): dQ, dK and dV of
// flash_attention.cu's forward from q, k, v, out, dout and the forward's row
// log-sum-exp, recomputing the probabilities tile by tile:
//
//   P    = exp(scale * Q K^T - lse)            (masked entries exactly 0)
//   dV   = P^T dO                              summed over the heads of a group
//   dP   = dO V^T
//   dS   = P * (dP - Delta),  Delta = rowsum(dO * O)
//   dQ   = scale * dS K
//   dK   = scale * dS^T Q                      summed over the heads of a group
//
// New: the TPU kernel (src/repro/kernels/flash_attention.py:
// flash_attention_pallas) has no backward, because the JAX package
// differentiates its XLA attention instead.  A plain backward builds the
// (B, H, S, S) probability matrix; this one keeps every (S x S) tile on
// chip, which is what makes attention's activation memory linear in S.
//
// Design.  Deterministic, with no float atomics: two kernels, launched in
// order on one stream.  (1) One block per (b, h, q tile) computes Delta for
// its rows (stored for kernel 2), then walks the visible kv tiles and owns
// dQ of its rows.  (2) One block per (b, kv head, kv tile) walks the query
// heads of its group and their visible q tiles in a fixed order and owns dK
// and dV of its keys, so the GQA sum over heads happens inside the block in
// a fixed order.  Both use the forward's tile-skip predicate.  The keys
// may number Skv != S, as in the forward (no causal mask, no window).
// Without dK and dV (``dkv`` 0: keys and values that take no gradient, as
// a frozen encoder's cross-attention K/V) kernel (2) is not launched.
//
// bf16 (hopper.cuh): each kernel feeds a TMA ring of shared-memory slots
// with mbarriers and runs two consumer warpgroups of 64 rows each, every
// product a wgmma with its accumulator in registers.  (1): a producer
// warpgroup, one thread of which issues the loads, and a 2-slot ring; 128
// query rows; Q, dO, lse and Delta stay resident, K and V (64 keys) flow
// through the ring; S = Q K^T and dP = dO V^T from shared memory, P and dS
// in registers, dQ += dS K with dS as the register A operand and K read
// MN-major.  (2): no producer warpgroup (its comment says why), warp 0
// feeds a 4-slot ring; 128 keys; K and V stay resident, Q and dO (32
// queries) with their lse and Delta flow through the ring; S^T = K Q^T and
// dP^T = V dO^T from shared memory, P^T and dS^T in registers, dV += P^T dO
// and dK += dS^T Q from registers with dO and Q read MN-major.  Both write
// their bf16 results over their own resident rows in shared memory and
// store them by TMA, which clips at S.  Blocks launch heaviest first under
// a causal mask: in (1) the last q tiles, in (2) the first kv tiles.
// Float32 keeps the CUDA-core route (tiles.cuh tile_mma<float>, 32 x 32
// tiles), for full float32 precision.
//
// What bounds it on the card: at the training shape (B 16, S 512, H 16,
// KV 8, D 128, causal, bf16) about 2.5x the forward's FLOPs (~4.3e10) over
// ~170 MB, so its bound is the operations or bytes at ~60 us.  Each kernel
// recomputes Q K^T for its own pass: 7 products where the function needs 5.
#include "hopper.cuh"
#include "tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

// ------------------------------------------------------------- bf16, Hopper
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

// (1) Delta and dQ: 128 query rows, kv tiles of 64 keys.
constexpr int DQ_BQ = 128, DQ_BK = 64;

template <int DP>
struct DqLayout {
  static constexpr int q = 0;
  static constexpr int dout = q + DQ_BQ * DP * 2;
  static constexpr int k = dout + DQ_BQ * DP * 2;
  static constexpr int v = k + STAGES * DQ_BK * DP * 2;
  static constexpr int delta = v + STAGES * DQ_BK * DP * 2;
  static constexpr int bars = delta + DQ_BQ * 4;  // qd_full, kv_full[], empty[]
  static constexpr int bytes = bars + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(3 * WG_THREADS, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tdq, const bf16* __restrict__ out,
                         const bf16* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta,
                         int S, int Skv, int H, int KV, int D, int causal, int window, float scale,
                         float scale_log2) {
  using L = DqLayout<DP>;
  constexpr int BQ = DQ_BQ, BK = DQ_BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::q);
  bf16* do_s = reinterpret_cast<bf16*>(smem + L::dout);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::v);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* kv_full = qd_full + 1;
  uint64_t* empty = kv_full + STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest causal tile first
  const int g = h / (H / KV);
  int first, last;
  relevant_kv_tiles(q0, BQ, BK, (Skv + BK - 1) / BK, causal, window, first, last);
  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(qd_full, 2 * BQ * DP * 2);
      tma_load_tile<DP, BQ>(q_s, &tq, qd_full, h, q0, b);
      tma_load_tile<DP, BQ>(do_s, &tdo, qd_full, h, q0, b);
      Ring<STAGES> ring(1);
      for (int kt = first; kt < last; ++kt, ring.next()) {
        mbar_wait(&empty[ring.slot], ring.parity);
        mbar_arrive_expect_tx(&kv_full[ring.slot], 2 * BK * DP * 2);
        tma_load_tile<DP, BK>(k_s + ring.slot * BK * DP, &tk, &kv_full[ring.slot], g, kt * BK, b);
        tma_load_tile<DP, BK>(v_s + ring.slot * BK * DP, &tv, &kv_full[ring.slot], g, kt * BK, b);
      }
    }
  } else {  // consumers: warpgroup cw owns query rows [q0 + 64 cw, q0 + 64 cw + 64)
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int t = threadIdx.x % WG_THREADS, lane = t & 31;
    const int qlo = q0 + 64 * cw, qhi = qlo + 63;
    const long long srow = ((long long)b * H + h) * S;

    {  // Delta = rowsum(dO * O): two threads a row, D / 2 columns each, 16-byte loads
      const int rr = t >> 1, half = t & 1;
      const int qi = qlo + rr;
      float acc = 0.f;
      if (qi < S) {
        const long long base = ((long long)b * S + qi) * H * D + (long long)h * D + half * (D / 2);
        const uint4* o4 = reinterpret_cast<const uint4*>(out + base);
        const uint4* d4 = reinterpret_cast<const uint4*>(dout + base);
        for (int c = 0; c < D / 16; ++c) {
          const uint4 ov = o4[c], dv = d4[c];
          const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(op[e]), df = __bfloat1622float2(dp[e]);
            acc += of.x * df.x + of.y * df.y;
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        delta_s[64 * cw + rr] = acc;
        if (qi < S) delta[srow + qi] = acc;
      }
      named_sync(1 + cw, WG_THREADS);
    }
    const int ra = 16 * (t >> 5) + (lane >> 2);  // this thread's rows ra and ra + 8 of the warpgroup's 64
    const int qa = qlo + ra, qb = qa + 8;
    const float dl0 = delta_s[64 * cw + ra], dl1 = delta_s[64 * cw + ra + 8];
    const float ls0 = qa < S ? lse[srow + qa] * LOG2E : 0.f, ls1 = qb < S ? lse[srow + qb] * LOG2E : 0.f;

    float dq[DP / 2], s[BK / 2], dp[BK / 2];
    uint32_t ds[BK / 16][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    mbar_wait(qd_full, 0);
    Ring<STAGES> ring(0);
    for (int kt = first; kt < last; ++kt, ring.next()) {
      const int k0 = kt * BK;
      const bf16* ks = k_s + ring.slot * BK * DP;
      const bf16* vs = v_s + ring.slot * BK * DP;
      mbar_wait(&kv_full[ring.slot], ring.parity);
      wgmma_fence();
      {
        const SmemDesc qd = kmajor_base(q_s, 64 * cw), dod = kmajor_base(do_s, 64 * cw);
        const SmemDesc kd = kmajor_base(ks, 0), vd = kmajor_base(vs, 0);
        wgmma_ss_init<BK, 0>(s, qd.at(kmajor_step(BQ, 0)), kd.at(kmajor_step(BK, 0)));
#pragma unroll
        for (int kk = 1; kk < DP / 16; ++kk) wgmma_ss<BK, 0>(s, qd.at(kmajor_step(BQ, kk)), kd.at(kmajor_step(BK, kk)), 1);
        wgmma_ss_init<BK, 0>(dp, dod.at(kmajor_step(BQ, 0)), vd.at(kmajor_step(BK, 0)));
#pragma unroll
        for (int kk = 1; kk < DP / 16; ++kk)
          wgmma_ss<BK, 0>(dp, dod.at(kmajor_step(BQ, kk)), vd.at(kmajor_step(BK, kk)), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      const bool full = k0 + BK <= Skv && (!causal || k0 + BK - 1 <= qlo) && (window <= 0 || k0 > qhi - window);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          float p = exp2f(s[4 * j + e] * scale_log2 - (lo ? ls0 : ls1));
          if (!full && !key_visible(lo ? qa : qb, k0 + 8 * j + 2 * (lane & 3) + (e & 1), Skv, causal, window)) p = 0.f;
          s[4 * j + e] = p * (dp[4 * j + e] - (lo ? dl0 : dl1));  // dS
        }
      }
      acc_to_a<BK>(s, ds);
      fence_regs(dq);
      fence_regs(ds);
      wgmma_fence();
      {
        const SmemDesc kd = mnmajor_base(ks, BK);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<DP, 1>(dq, ds[kk], kd.at(mnmajor_step(kk)), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      if (lane == 0) mbar_arrive(&empty[ring.slot]);
    }

    acc_to_tile<DP>(dq, scale, scale, q_s, BQ, 64 * cw);  // over this warpgroup's own Q rows
    fence_proxy_async();
    named_sync(1 + cw, WG_THREADS);
    if (t == 0 && qlo < S) {
      tma_store_rows<DP>(&tdq, q_s, BQ, cw, h, qlo, b);
      tma_store_flush();
    }
  }
}

// (2) dK and dV: 128 keys, q tiles of 32 queries through a 4-slot ring.
//
// Two warpgroups and no producer warpgroup: ptxas budgets the registers of
// wgmma code by the block's launch bound, and three warpgroups cap a thread
// at 168 (setmaxnreg does not lift that budget), where this kernel's
// consumers hold dK and dV (2 x 64 floats) beside S^T, dP^T and their A
// fragments.  At 256 threads the cap is 255.  Warp 0 feeds the ring instead,
// a few slots ahead of the pair it computes.
constexpr int KV_BK = 128, KV_BQ = 32, KV_STAGES = 4;

template <int DP>
struct DkvLayout {
  static constexpr int k = 0;
  static constexpr int v = k + KV_BK * DP * 2;
  static constexpr int q = v + KV_BK * DP * 2;
  static constexpr int dout = q + KV_STAGES * KV_BQ * DP * 2;
  static constexpr int lse = dout + KV_STAGES * KV_BQ * DP * 2;  // log2 units
  static constexpr int delta = lse + KV_STAGES * KV_BQ * 4;
  static constexpr int bars = delta + KV_STAGES * KV_BQ * 4;  // kv_full, full[], empty[]
  static constexpr int bytes = bars + 8 * (1 + 2 * KV_STAGES) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(2 * WG_THREADS, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
                          const float* __restrict__ lse, const float* __restrict__ delta, int S, int Skv, int H,
                          int KV, int causal, int window, float scale, float scale_log2) {
  using L = DkvLayout<DP>;
  constexpr int BQ = KV_BQ, BK = KV_BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::v);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::q);
  bf16* do_s = reinterpret_cast<bf16*>(smem + L::dout);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + KV_STAGES;

  const int g = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;  // heaviest causal tile (the first keys) first
  const int rep = H / KV;
  int first, last;
  relevant_q_tiles(k0, BQ, BK, (S + BQ - 1) / BQ, causal, window, first, last);
  const int per_head = last - first, pairs = rep * per_head;  // (query head, q tile) pairs, head by head
  const int cw = warpgroup_index();  // warpgroup cw owns keys [k0 + 64 cw, k0 + 64 cw + 64)
  const int t = threadIdx.x % WG_THREADS, lane = t & 31;
  const bool feeder = threadIdx.x < 32;  // warp 0 also feeds the ring
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(&full[s], 32);  // warp 0's lanes
      mbar_init(&empty[s], 8);  // lane 0 of each warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Pair i into slot i % KV_STAGES once the pair before it in that slot is
  // done: lane 0 issues the Q and dO loads, all lanes stage lse and Delta.
  auto feed = [&](int i) {
    const int slot = i % KV_STAGES;
    const int h = g * rep + i / per_head, q0 = (first + i % per_head) * BQ;
    mbar_wait(&empty[slot], ((i / KV_STAGES) & 1) ^ 1);
    const long long srow = ((long long)b * H + h) * S;
    for (int r = lane; r < BQ; r += 32) {
      const bool ok = q0 + r < S;
      lse_s[slot * BQ + r] = ok ? lse[srow + q0 + r] * LOG2E : 0.f;
      delta_s[slot * BQ + r] = ok ? delta[srow + q0 + r] : 0.f;
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[slot], 2 * BQ * DP * 2);
      tma_load_tile<DP, BQ>(q_s + slot * BQ * DP, &tq, &full[slot], h, q0, b);
      tma_load_tile<DP, BQ>(do_s + slot * BQ * DP, &tdo, &full[slot], h, q0, b);
    } else {
      mbar_arrive(&full[slot]);
    }
  };
  if (feeder) {
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * BK * DP * 2);
      tma_load_tile<DP, BK>(k_s, &tk, kv_full, g, k0, b);
      tma_load_tile<DP, BK>(v_s, &tv, kv_full, g, k0, b);
    }
    for (int i = 0; i < KV_STAGES - 1 && i < pairs; ++i) feed(i);
  }

  const int klo = k0 + 64 * cw, khi = klo + 63;
  const int ka = klo + 16 * (t >> 5) + (lane >> 2), kb = ka + 8;  // this thread's two keys
  float dk[DP / 2], dv[DP / 2], s[16], dp[16];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_full, 0);
  Ring<KV_STAGES> ring(0);
  for (int i = 0; i < pairs; ++i, ring.next()) {
    if (feeder && i + KV_STAGES - 1 < pairs) feed(i + KV_STAGES - 1);
    const int q0 = (first + i % per_head) * BQ;
    const uint32_t qs = smem_u32(q_s) + ring.slot * BQ * DP * 2;  // this slot's tiles, shared addresses
    const uint32_t dos = smem_u32(do_s) + ring.slot * BQ * DP * 2;
    const uint32_t ls = smem_u32(lse_s) + ring.slot * BQ * 4;
    const uint32_t dl = smem_u32(delta_s) + ring.slot * BQ * 4;
    const bool all = q0 + BQ <= S && khi < Skv && (!causal || khi <= q0) && (window <= 0 || klo > q0 + BQ - 1 - window);
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];  // P^T and dS^T as A fragments, packed as they are made
    mbar_wait(&full[ring.slot], ring.parity);
#pragma unroll
    for (int half = 0; half < BQ / 32; ++half) {  // 32 queries at a time: S^T and dP^T in 16 registers each
      wgmma_fence();
      const SmemDesc kd = kmajor_base(k_s, 64 * cw), vd = kmajor_base(v_s, 64 * cw);
      const SmemDesc qd = kmajor_base(qs, 32 * half), dod = kmajor_base(dos, 32 * half);
      wgmma_ss_init<32, 0>(s, kd.at(kmajor_step(BK, 0)), qd.at(kmajor_step(BQ, 0)));
#pragma unroll
      for (int kk = 1; kk < DP / 16; ++kk) wgmma_ss<32, 0>(s, kd.at(kmajor_step(BK, kk)), qd.at(kmajor_step(BQ, kk)), 1);
      wgmma_ss_init<32, 0>(dp, vd.at(kmajor_step(BK, 0)), dod.at(kmajor_step(BQ, 0)));
#pragma unroll
      for (int kk = 1; kk < DP / 16; ++kk)
        wgmma_ss<32, 0>(dp, vd.at(kmajor_step(BK, kk)), dod.at(kmajor_step(BQ, kk)), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * half + 8 * j + 2 * (lane & 3);  // this thread's query columns c, c + 1
        const float2 l2 = lds_f2(ls + 4 * c), d2 = lds_f2(dl + 4 * c);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + c + (e & 1);
          p[e] = exp2f(s[4 * j + e] * scale_log2 - ((e & 1) ? l2.y : l2.x));
          if (!all && !(qi < S && key_visible(qi, e < 2 ? ka : kb, Skv, causal, window))) p[e] = 0.f;
          ds[e] = p[e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
        const int n8 = 4 * half + j;  // the 8-column block of the query tile: A fragment layout (acc_to_a)
        pa[n8 >> 1][2 * (n8 & 1)] = pack_bf16(p[0], p[1]);
        pa[n8 >> 1][2 * (n8 & 1) + 1] = pack_bf16(p[2], p[3]);
        dsa[n8 >> 1][2 * (n8 & 1)] = pack_bf16(ds[0], ds[1]);
        dsa[n8 >> 1][2 * (n8 & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }
    }
    // dV += P^T dO and dK += dS^T Q
    fence_regs(pa);
    fence_regs(dsa);
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
    const SmemDesc dod = mnmajor_base(dos, BQ), qd = mnmajor_base(qs, BQ);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<DP, 1>(dv, pa[kk], dod.at(mnmajor_step(kk)), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<DP, 1>(dk, dsa[kk], qd.at(mnmajor_step(kk)), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if (lane == 0) mbar_arrive(&empty[ring.slot]);
  }

  // over this warpgroup's own K and V rows (no other warpgroup reads them)
  acc_to_tile<DP>(dk, scale, scale, k_s, BK, 64 * cw);
  acc_to_tile<DP>(dv, 1.f, 1.f, v_s, BK, 64 * cw);
  fence_proxy_async();
  named_sync(1 + cw, WG_THREADS);
  if (t == 0 && klo < Skv) {
    tma_store_rows<DP>(&tdk, k_s, BK, cw, g, klo, b);
    tma_store_rows<DP>(&tdv, v_s, BK, cw, g, klo, b);
    tma_store_flush();
  }
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, const void* out, const void* dout, const float* lse,
                float* delta, void* dq, void* dk, void* dv, int B, int S, int Skv, int H, int KV, int D, int causal,
                int window, float scale, int dkv, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tdq, tdk, tdv;
  int err = make_map_4d(&tq, q, D, H, S, B);
  if (!err) err = make_map_4d(&tk, k, D, KV, Skv, B);
  if (!err) err = make_map_4d(&tv, v, D, KV, Skv, B);
  if (!err) err = make_map_4d(&tdo, dout, D, H, S, B);
  if (!err) err = make_map_4d(&tdq, dq, D, H, S, B);
  CUtensorMap tq_kv, tdo_kv;  // kernel (2)'s query tiles, KV_BQ rows
  if (dkv) {
    if (!err) err = make_map_4d(&tdk, dk, D, KV, Skv, B);
    if (!err) err = make_map_4d(&tdv, dv, D, KV, Skv, B);
    if (!err) err = make_map_4d(&tq_kv, q, D, H, S, B, KV_BQ);
    if (!err) err = make_map_4d(&tdo_kv, dout, D, H, S, B, KV_BQ);
  }
  if (err) return err;
  constexpr int dq_bytes = DqLayout<DP>::bytes, dkv_bytes = DkvLayout<DP>::bytes;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       dq_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale_log2 = scale * LOG2E;
  const dim3 grid_q(H, B, (S + DQ_BQ - 1) / DQ_BQ);
  flash_bwd_dq_bf16_kernel<DP><<<grid_q, 3 * WG_THREADS, dq_bytes, stream>>>(
      tq, tk, tv, tdo, tdq, static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse, delta, S, Skv, H,
      KV, D, causal, window, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess || !dkv) return static_cast<int>(e);
  const dim3 grid_kv(KV, B, (Skv + KV_BK - 1) / KV_BK);
  flash_bwd_dkv_bf16_kernel<DP><<<grid_kv, 2 * WG_THREADS, dkv_bytes, stream>>>(
      tq_kv, tk, tv, tdo_kv, tdk, tdv, lse, delta, S, Skv, H, KV, causal, window, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- float32, CUDA cores
struct DqSmemF32 {
  static constexpr int BQ = Tile<float>::R, BK = Tile<float>::R;
  int D, ldt, lds, ldp, ldo;
  size_t q, dout, k, v, s, dp, ds, dq, lse, delta, bytes;
  __host__ __device__ explicit DqSmemF32(int d) : D(d) {
    ldt = D + PAD_T;
    lds = BK + PAD_F;
    ldp = BK + PAD_T;
    ldo = D + PAD_F;
    q = 0;
    dout = q + align128(sizeof(float) * BQ * ldt);
    k = dout + align128(sizeof(float) * BQ * ldt);
    v = k + align128(sizeof(float) * BK * ldt);
    s = v + align128(sizeof(float) * BK * ldt);
    dp = s + align128(sizeof(float) * BQ * lds);
    ds = dp + align128(sizeof(float) * BQ * lds);
    dq = ds + align128(sizeof(float) * BQ * ldp);
    lse = dq + align128(sizeof(float) * BQ * ldo);
    delta = lse + align128(sizeof(float) * BQ);
    bytes = delta + align128(sizeof(float) * BQ);
  }
};

struct DkvSmemF32 {
  static constexpr int BQ = Tile<float>::R, BK = Tile<float>::R;
  int D, ldt, lds, ldp, ldo;
  size_t k, v, q, dout, st, dpt, pt, dst, dk, dv, lse, delta, bytes;
  __host__ __device__ explicit DkvSmemF32(int d) : D(d) {
    ldt = D + PAD_T;
    lds = BQ + PAD_F;
    ldp = BQ + PAD_T;
    ldo = D + PAD_F;
    k = 0;
    v = k + align128(sizeof(float) * BK * ldt);
    q = v + align128(sizeof(float) * BK * ldt);
    dout = q + align128(sizeof(float) * BQ * ldt);
    st = dout + align128(sizeof(float) * BQ * ldt);
    dpt = st + align128(sizeof(float) * BK * lds);
    pt = dpt + align128(sizeof(float) * BK * lds);
    dst = pt + align128(sizeof(float) * BK * ldp);
    dk = dst + align128(sizeof(float) * BK * ldp);
    dv = dk + align128(sizeof(float) * BK * ldo);
    lse = dv + align128(sizeof(float) * BK * ldo);
    delta = lse + align128(sizeof(float) * BQ);
    bytes = delta + align128(sizeof(float) * BQ);
  }
};

// (1) Delta and dQ.  One block per (b, h, q tile).
__global__ void __launch_bounds__(TILE_THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ out, const float* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq, int S, int Skv, int H, int KV, int D,
                        int causal, int window, float scale) {
  constexpr int BQ = DqSmemF32::BQ, BK = DqSmemF32::BK;
  static_assert(BQ == BK, "O is staged in the K buffer");
  extern __shared__ __align__(128) unsigned char smem[];
  const DqSmemF32 L(D);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* do_s = reinterpret_cast<float*>(smem + L.dout);
  float* k_s = reinterpret_cast<float*>(smem + L.k);
  float* v_s = reinterpret_cast<float*>(smem + L.v);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* dp_s = reinterpret_cast<float*>(smem + L.dp);
  float* ds_s = reinterpret_cast<float*>(smem + L.ds);
  float* dq_s = reinterpret_cast<float*>(smem + L.dq);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int g = h / (H / KV);
  const int qvalid = min(BQ, S - q0);
  const long long qtok = (long long)H * D, ktok = (long long)KV * D;
  const long long qrow = ((long long)b * S + q0) * qtok + (long long)h * D;
  const long long srow = ((long long)b * H + h) * S + q0;

  load_rows(q_s, L.ldt, q + qrow, qtok, BQ, qvalid, D);
  load_rows(do_s, L.ldt, dout + qrow, qtok, BQ, qvalid, D);
  load_rows(k_s, L.ldt, out + qrow, qtok, BQ, qvalid, D);  // O, staged in the K buffer for Delta
  for (int e = tid; e < BQ * D; e += blockDim.x) dq_s[(e / D) * L.ldo + e % D] = 0.f;
  __syncthreads();
  for (int r = warp; r < BQ; r += nwarps) {  // Delta = rowsum(dO * O), one warp per row
    float acc = 0.f;
    for (int j = lane; j < D; j += 32) acc += do_s[r * L.ldt + j] * k_s[r * L.ldt + j];
    acc = warp_sum(acc);
    if (lane == 0) {
      delta_s[r] = r < qvalid ? acc : 0.f;
      lse_s[r] = r < qvalid ? lse[srow + r] : 0.f;
      if (r < qvalid) delta[srow + r] = acc;
    }
  }
  __syncthreads();

  const int nk = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (!tile_relevant(q0, k0, BQ, BK, causal, window)) continue;
    const long long krow = ((long long)b * Skv + k0) * ktok + (long long)g * D;
    load_rows(k_s, L.ldt, k + krow, ktok, BK, min(BK, Skv - k0), D);
    load_rows(v_s, L.ldt, v + krow, ktok, BK, min(BK, Skv - k0), D);
    __syncthreads();
    tile_mma<true>(s_s, L.lds, q_s, L.ldt, k_s, L.ldt, BQ, BK, D, false);    // S = Q K^T
    tile_mma<true>(dp_s, L.lds, do_s, L.ldt, v_s, L.ldt, BQ, BK, D, false);  // dP = dO V^T
    __syncthreads();
    for (int e = tid; e < BQ * BK; e += blockDim.x) {
      const int i = e / BK, j = e % BK;
      const float p = key_visible(q0 + i, k0 + j, Skv, causal, window)
                          ? expf(s_s[i * L.lds + j] * scale - lse_s[i]) : 0.f;
      ds_s[i * L.ldp + j] = p * (dp_s[i * L.lds + j] - delta_s[i]);
    }
    __syncthreads();
    tile_mma<false>(dq_s, L.ldo, ds_s, L.ldp, k_s, L.ldt, BQ, D, BK, true);  // dQ += dS K
    __syncthreads();
  }
  for (int e = tid; e < BQ * D; e += blockDim.x) {
    const int i = e / D, j = e % D;
    if (i < qvalid) dq[qrow + (long long)i * qtok + j] = dq_s[i * L.ldo + j] * scale;
  }
}

// (2) dK and dV.  One block per (b, kv head, kv tile).
__global__ void __launch_bounds__(TILE_THREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int S,
                         int Skv, int H, int KV, int D, int causal, int window, float scale) {
  constexpr int BQ = DkvSmemF32::BQ, BK = DkvSmemF32::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  const DkvSmemF32 L(D);
  float* k_s = reinterpret_cast<float*>(smem + L.k);
  float* v_s = reinterpret_cast<float*>(smem + L.v);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* do_s = reinterpret_cast<float*>(smem + L.dout);
  float* st_s = reinterpret_cast<float*>(smem + L.st);
  float* dpt_s = reinterpret_cast<float*>(smem + L.dpt);
  float* pt_s = reinterpret_cast<float*>(smem + L.pt);
  float* dst_s = reinterpret_cast<float*>(smem + L.dst);
  float* dk_s = reinterpret_cast<float*>(smem + L.dk);
  float* dv_s = reinterpret_cast<float*>(smem + L.dv);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);

  const int tid = threadIdx.x;
  const int b = blockIdx.z, g = blockIdx.y, k0 = blockIdx.x * BK;
  const int rep = H / KV;
  const int kvalid = min(BK, Skv - k0);
  const long long qtok = (long long)H * D, ktok = (long long)KV * D;
  const long long krow = ((long long)b * Skv + k0) * ktok + (long long)g * D;

  load_rows(k_s, L.ldt, k + krow, ktok, BK, kvalid, D);
  load_rows(v_s, L.ldt, v + krow, ktok, BK, kvalid, D);
  for (int e = tid; e < BK * D; e += blockDim.x) {
    dk_s[(e / D) * L.ldo + e % D] = 0.f;
    dv_s[(e / D) * L.ldo + e % D] = 0.f;
  }
  __syncthreads();

  const int nq = (S + BQ - 1) / BQ;
  for (int hr = 0; hr < rep; ++hr) {
    const int h = g * rep + hr;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      if (!tile_relevant(q0, k0, BQ, BK, causal, window)) continue;
      const int qvalid = min(BQ, S - q0);
      const long long qrow = ((long long)b * S + q0) * qtok + (long long)h * D;
      const long long srow = ((long long)b * H + h) * S + q0;
      load_rows(q_s, L.ldt, q + qrow, qtok, BQ, qvalid, D);
      load_rows(do_s, L.ldt, dout + qrow, qtok, BQ, qvalid, D);
      for (int i = tid; i < BQ; i += blockDim.x) {
        lse_s[i] = i < qvalid ? lse[srow + i] : 0.f;
        delta_s[i] = i < qvalid ? delta[srow + i] : 0.f;
      }
      __syncthreads();
      tile_mma<true>(st_s, L.lds, k_s, L.ldt, q_s, L.ldt, BK, BQ, D, false);    // S^T = K Q^T
      tile_mma<true>(dpt_s, L.lds, v_s, L.ldt, do_s, L.ldt, BK, BQ, D, false);  // dP^T = V dO^T
      __syncthreads();
      for (int e = tid; e < BK * BQ; e += blockDim.x) {
        const int j = e / BQ, i = e % BQ;  // key j, query i
        const float p = (i < qvalid && key_visible(q0 + i, k0 + j, Skv, causal, window))
                            ? expf(st_s[j * L.lds + i] * scale - lse_s[i]) : 0.f;
        pt_s[j * L.ldp + i] = p;
        dst_s[j * L.ldp + i] = p * (dpt_s[j * L.lds + i] - delta_s[i]);
      }
      __syncthreads();
      tile_mma<false>(dv_s, L.ldo, pt_s, L.ldp, do_s, L.ldt, BK, D, BQ, true);  // dV += P^T dO
      tile_mma<false>(dk_s, L.ldo, dst_s, L.ldp, q_s, L.ldt, BK, D, BQ, true);  // dK += dS^T Q
      __syncthreads();
    }
  }
  for (int e = tid; e < BK * D; e += blockDim.x) {
    const int j = e / D, c = e % D;
    if (j < kvalid) {
      dk[krow + (long long)j * ktok + c] = dk_s[j * L.ldo + c] * scale;
      dv[krow + (long long)j * ktok + c] = dv_s[j * L.ldo + c];
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, const void* out, const void* dout, const float* lse,
               float* delta, void* dq, void* dk, void* dv, int B, int S, int Skv, int H, int KV, int D, int causal,
               int window, float scale, int dkv, cudaStream_t stream) {
  const DqSmemF32 Lq(D);
  const DkvSmemF32 Lkv(D);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Lq.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Lkv.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  const dim3 grid_q((S + DqSmemF32::BQ - 1) / DqSmemF32::BQ, H, B);
  flash_bwd_dq_f32_kernel<<<grid_q, TILE_THREADS, Lq.bytes, stream>>>(
      qt, kt, vt, static_cast<const float*>(out), dot, lse, delta, static_cast<float*>(dq), S, Skv, H, KV, D,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !dkv) return static_cast<int>(err);
  const dim3 grid_kv((Skv + DkvSmemF32::BK - 1) / DkvSmemF32::BK, KV, B);
  flash_bwd_dkv_f32_kernel<<<grid_kv, TILE_THREADS, Lkv.bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), S, Skv, H, KV, D, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused launch, -1 for
// arguments the kernels do not take (among them Skv != S under a causal
// mask or a window), or -2 if CUDA refuses a tensor map.  `delta` is (B,
// H, S) float32 scratch; with `dkv` 0 only kernel (1) runs and dk, dv are
// not written (they may be null).  Shapes, dtypes, devices and contiguity
// are checked by the Python wrapper (repro_torch/kernels/ops.py).
extern "C" int flash_attention_bwd_launch(int dtype, const void* q, const void* k, const void* v, const void* out,
                                          const void* dout, const void* lse, void* delta, void* dq, void* dk,
                                          void* dv, int B, int S, int Skv, int H, int KV, int D, int causal,
                                          int window, float scale, int dkv, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D % 16 != 0 || D > MAX_D) return -1;
  if (Skv != S && (causal || window > 0)) return -1;
  if (H > 65535 || B > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == kFloat32)
    return launch_f32(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, Skv, H, KV, D, causal, window, scale, dkv, s);
  if (dtype == kBFloat16) {
    if (D <= 64)
      return launch_bf16<64>(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, Skv, H, KV, D, causal, window, scale, dkv, s);
    return launch_bf16<128>(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, Skv, H, KV, D, causal, window, scale, dkv, s);
  }
  return -1;
}

// Dynamic shared memory a launch at head dim D asks for, kernel 0 (Delta
// and dQ) or 1 (dK and dV) (for reports).
extern "C" int flash_attention_bwd_smem_bytes(int dtype, int D, int kernel) {
  if (dtype == kFloat32) return static_cast<int>(kernel == 0 ? DqSmemF32(D).bytes : DkvSmemF32(D).bytes);
  if (kernel == 0) return D <= 64 ? DqLayout<64>::bytes : DqLayout<128>::bytes;
  return D <= 64 ? DkvLayout<64>::bytes : DkvLayout<128>::bytes;
}
