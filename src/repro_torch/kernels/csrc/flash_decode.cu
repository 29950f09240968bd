// Flash-decode for Hopper (sm_90a): one query token per row against a
// batched ring KV cache, GQA, with a position per row.
//
// Replaces src/repro/kernels/flash_decode.py: flash_decode_pallas (kernel
// body _decode_kernel), generalised from one scalar q_position and
// k_positions (S,) to q_positions (B,) and k_positions (B, S), so that a
// continuous batch whose rows decode at different depths runs in one
// launch.  Slot j of row b is live iff kpos[b, j] <= qpos[b] (and
// kpos[b, j] > qpos[b] - window when a window is set); never-written or
// recycled slots carry INT32_MAX and are never live.  Scores, the running
// max and sum, and the output accumulator are float32; masked scores are
// the finite -1e30 of the TPU kernel, and the output is acc / max(l, 1e-30).
//
// What bounds it: each cache element is used once per query of its GQA
// group (rep = 2 for qwen3-1.7b, 16 for glm4-9b), a few FLOP per byte, so it is bound by
// reading the live slots of the K and V cache once (~2.5 us at the decode
// step's B 8, S 512).  Hiding the memory's latency needs several MB in
// flight, so the cache is split across blocks:
//  * the grid is (kv head, row, split); the number of splits comes from S
//    and the card's SM count alone (about 64 slots a block, at most one
//    split per SM), never from B, so a row's sums do not depend on the
//    batch;
//  * a block reads its slab's slot positions first, then loads the K and V
//    rows of the live slots of each 64-slot chunk in one burst of 16-byte
//    cp.async (dead slots zero-filled, a chunk with no live slot not loaded
//    at all), and runs the group's rep queries over them with an online
//    softmax kept by each warp for its quarter of the slots (scores by 2
//    threads a slot and a fixed shuffle, the max, sum and P V by shuffles),
//    the warps merged once at the end of the slab;
//  * each block writes a float32 partial (m, l, acc[D]) per query, and a
//    second kernel merges a row's splits in order: no atomics.
// Registers: a lane holds DPL = 2, 4 or 8 dims of each query's accumulator
// (the head dim rounded up to 64, 128 or 256, a lane's dims past D masked,
// so any D that is a multiple of 16 runs, h2o-danube's 80 too), and a
// block holds REP queries with REP * DPL <= 64 accumulators a lane.  So a
// group of 16 queries (glm4-9b) runs in one block up to D 128, reading the
// slab once; past D 128 its queries split over two blocks of 8, each
// reading the slab (the second from L2).
// A dead slot of a row that has a live slot adds exactly 0 to l and acc
// (exp(-1e30 - m) is 0 in float32), so skipping it changes no bit.  A row
// whose slots are all dead gets the mean of V over all S slots, what the
// finite mask gives: the merge computes it when no split had a live slot.
// The merge also writes, when asked, each query's float32 log-sum-exp of
// its scaled scores, m + log(l) (-1e30 for a row with no live slot): the
// weight of this decode's output against another over other slots of the
// same sequence (a cache whose sequence is cut over ranks).
//
// The head-dim split (a cache cut over ranks on its head dim, each rank
// holding Dr of every KV head's D dims) runs two more kernels, each a plain
// pass over the cache at one block per 128 slots or per (head, row):
//  * flash_decode_scores: the rank's partial scores q[:, :, Dr] . k[Dr]
//    times the whole head's scale, float32 (B, H, S), to be summed over
//    the ranks;
//  * flash_decode_split_combine: from the summed scores, the masked
//    softmax (the live rule above; a row with no live slot weighs every
//    slot alike) and P V over the rank's Dr dims, with the log-sum-exp.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 16;   // query heads per kv head
constexpr int MAX_D = 256;    // head dim
constexpr int MAX_ACC = 64;   // REP * DPL: accumulators a lane
constexpr int SLAB = 64;      // slots a block aims for
constexpr int ROW_PAD = 32;   // bytes after each staged cache row
constexpr float NEG_INF = -1e30f;

// 16 bytes of shared memory as floats: 8 bf16 or 4 float32
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
}

// Slots of a chunk: 64 bf16 or 32 float32 rows, so that a chunk of K and V
// at D 256 takes 64 KB of shared memory either way.
template <typename TC>
struct Chunk {
  static constexpr int CH = 128 / sizeof(TC);
  static constexpr int VEC = 16 / sizeof(TC);  // elements per 16-byte load
  static constexpr int SEG = THREADS / CH;     // threads per slot for the scores
  static_assert(CH <= THREADS && 32 % SEG == 0, "a slot's score threads share a warp");
  __host__ __device__ static int row_bytes(int D) { return D * static_cast<int>(sizeof(TC)) + ROW_PAD; }
  __host__ __device__ static int smem_bytes(int D) { return 2 * CH * row_bytes(D); }
};

// part: (B, H, splits, D + 2) float32, per query and split (m, l, acc[D]);
// l = 0 marks a split without a live slot (nothing else written).
//
// The grid's x is (kv head, query group): a block runs up to REP of the
// kv head's rep queries.  Inside a block each warp owns CH / 4 slots of
// every chunk and keeps its own online softmax (m, l and acc in registers,
// lane l holding head dims l, l + 32, ... below D): scores by SEG lanes a
// slot and a fixed shuffle, the warp's max and sum by shuffles, P V with
// each slot's probability broadcast by a shuffle.  The four warps' states
// merge once, in warp order, at the end of the slab, through the staging
// buffers.
template <typename TQ, typename TC, int REP, int DPL>
__global__ void __launch_bounds__(THREADS)
flash_decode_split_kernel(const TQ* __restrict__ q,      // (B, H, D)
                          const TC* __restrict__ k,      // (B, S, KV, D)
                          const TC* __restrict__ v,      // (B, S, KV, D)
                          const int* __restrict__ qpos,  // (B,)
                          const int* __restrict__ kpos,  // (B, S)
                          float* __restrict__ part, int H, int KV, int D, int S, int window, int slab,
                          float scale) {
  using C = Chunk<TC>;
  constexpr int CH = C::CH, VEC = C::VEC, SEG = C::SEG, SPW = CH / WARPS;  // slots a warp
  static_assert(SPW * SEG == 32, "a warp's slots fill its lanes");
  static_assert(REP * DPL <= MAX_ACC, "a lane's accumulators");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float q_s[REP][32 * DPL];
  __shared__ int live_s[CH];
  __shared__ float wm_s[WARPS][REP];
  __shared__ float wl_s[WARPS][REP];

  pdl_launch_dependents();  // the merge kernel may start; it waits for this grid before reading
  const int rep = H / KV, groups = (rep + REP - 1) / REP;
  const int kvh = blockIdx.x / groups, h0 = kvh * rep + (blockIdx.x % groups) * REP;  // the block's first query
  const int nq = min(REP, kvh * rep + rep - h0);                                     // and its queries
  const int row = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rowb = C::row_bytes(D), dvecs = D / VEC;
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + CH * rowb;

  const TQ* qg = q + ((size_t)row * H + h0) * D;
  for (int i = tid; i < nq * D; i += THREADS) q_s[i / D][i % D] = to_float(qg[i]);
  const int qp = qpos[row];
  const int* kp = kpos + (size_t)row * S;
  const size_t slot_stride = (size_t)KV * D;
  const TC* kb = k + ((size_t)row * S * KV + kvh) * D;
  const TC* vb = v + ((size_t)row * S * KV + kvh) * D;

  float m[REP], l[REP], acc[REP][DPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int u = 0; u < DPL; ++u) acc[r][u] = 0.f;
  }

  // score roles: slot js of the chunk (this warp's), part seg of the head
  // dim (vectors seg, seg + SEG, ...: with the padded rows the 8 lanes of a
  // quarter warp read 8 distinct 16-byte bank groups for bf16)
  const int js = warp * SPW + lane / SEG, seg = lane % SEG;
  const int j_end = min(S, (split + 1) * slab);
  for (int j0 = split * slab; j0 < j_end; j0 += CH) {
    const int nb = min(CH, j_end - j0);

    // (0) the chunk's slot positions first
    bool live = false;
    if (tid < nb) {
      const int p = kp[j0 + tid];
      live = p <= qp && (window <= 0 || p > qp - window);
    }
    if (tid < CH) live_s[tid] = live;
    if (!__syncthreads_or(live)) continue;  // adds exactly 0 to this row: skip it

    // (1) the live slots' K rows, then their V rows, in one burst (two
    //     groups: the scores need only K); dead slots zero-filled
    for (int e = tid; e < nb * dvecs; e += THREADS) {
      const int j = e / dvecs, c = e % dvecs;
      const size_t off = (size_t)(j0 + j) * slot_stride + (size_t)c * VEC;
      cp_async16(k_s + j * rowb + c * 16, kb + off, live_s[j] ? 16 : 0);
    }
    cp_async_commit();
    for (int e = tid; e < nb * dvecs; e += THREADS) {
      const int j = e / dvecs, c = e % dvecs;
      const size_t off = (size_t)(j0 + j) * slot_stride + (size_t)c * VEC;
      cp_async16(v_s + j * rowb + c * 16, vb + off, live_s[j] ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's K rows
    __syncthreads();

    // (2) scores, then the warp's online-softmax update
    float sc[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) sc[r] = 0.f;
    if (js < nb) {
      const TC* krow = reinterpret_cast<const TC*>(k_s + js * rowb);
      for (int u = seg; u < dvecs; u += SEG) {
        float kv[VEC];
        load_vec(krow + u * VEC, kv);
#pragma unroll
        for (int r = 0; r < REP; ++r)
          if (r < nq) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) sc[r] += q_s[r][u * VEC + e] * kv[e];
          }
      }
    }
    const bool slot_live = js < nb && live_s[js];
    float p[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
#pragma unroll
      for (int off = 1; off < SEG; off <<= 1) sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], off);
      const float s = slot_live ? sc[r] * scale : NEG_INF;
      float mx = s;
#pragma unroll
      for (int off = SEG; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      p[r] = js < nb ? expf(s - m_new) : 0.f;  // past the chunk: no slot
      float sum = seg == 0 ? p[r] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int u = 0; u < DPL; ++u) acc[r][u] *= alpha;
    }
    cp_async_wait<0>();  // this thread's V rows
    __syncthreads();

    // (3) acc += p V over this warp's slots; lane holds dims lane + 32 u
    for (int jj = 0; jj < SPW; ++jj) {
      const int j = warp * SPW + jj;
      float pj[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) pj[r] = __shfl_sync(0xffffffffu, p[r], jj * SEG);
      if (j >= nb) continue;
      const TC* vrow = reinterpret_cast<const TC*>(v_s + j * rowb);
#pragma unroll
      for (int u = 0; u < DPL; ++u) {
        if (lane + 32 * u < D) {
          const float vd = to_float(vrow[lane + 32 * u]);
#pragma unroll
          for (int r = 0; r < REP; ++r) acc[r][u] += pj[r] * vd;
        }
      }
    }
  }

  // (4) the warps' states, merged in warp order, into this split's partial
  __syncthreads();  // the staging buffers are free
  float* wacc_s = reinterpret_cast<float*>(smem);  // [WARPS][REP][D]
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      wm_s[warp][r] = m[r];
      wl_s[warp][r] = l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int u = 0; u < DPL; ++u)
      if (lane + 32 * u < D) wacc_s[(warp * REP + r) * D + lane + 32 * u] = acc[r][u];
  __syncthreads();
  for (int e = tid; e < nq * D; e += THREADS) {
    const int r = e / D, d = e % D;
    float mb = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, wm_s[w][r]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = expf(wm_s[w][r] - mb);
      lb += wt * wl_s[w][r];
      ab += wt * wacc_s[(w * REP + r) * D + d];
    }
    float* pb = part + (((size_t)row * H + h0 + r) * splits + split) * (D + 2);
    if (d == 0) {
      pb[0] = mb;
      pb[1] = lb;
    }
    if (lb > 0.f) pb[2 + d] = ab;
  }
}

// out[b, h] from the row's splits, merged in order; a row without a live
// slot gets the mean of V over its S slots.  One round trip: each thread
// loads every split's (m, l) and its own dims' partials at once, 8 splits
// at a time (a split without a live slot is selected out, never
// multiplied: its acc was not written).
template <typename TQ, typename TC>
__global__ void __launch_bounds__(THREADS)
flash_decode_combine_kernel(const float* __restrict__ part, const TC* __restrict__ v, TQ* __restrict__ out,
                            float* __restrict__ lse, int H, int KV, int D, int S, int splits) {
  pdl_wait();  // the split kernel's partials are written
  const int h = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  const int g = h / (H / KV);
  const float* pp = part + ((size_t)row * H + h) * splits * (D + 2);
  TQ* og = out + ((size_t)row * H + h) * D;
  for (int d = tid; d < D; d += THREADS) {
    float M = NEG_INF, l = 0.f, acc = 0.f;
    for (int s0 = 0; s0 < splits; s0 += 8) {
      float ms[8], ls[8], as[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float* ps = pp + (size_t)min(s0 + i, splits - 1) * (D + 2);
        ms[i] = ps[0];
        ls[i] = s0 + i < splits ? ps[1] : 0.f;
        as[i] = ps[2 + d];
      }
      float mc = M;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (ls[i] > 0.f) mc = fmaxf(mc, ms[i]);
      const float alpha = expf(M - mc);  // the splits before, to this group's max
      l *= alpha;
      acc *= alpha;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (ls[i] > 0.f) {
          const float w = expf(ms[i] - mc);
          l += w * ls[i];
          acc += w * as[i];
        }
      }
      M = mc;
    }
    if (lse != nullptr && d == 0) lse[(size_t)row * H + h] = l > 0.f ? M + logf(l) : NEG_INF;
    if (l > 0.f) {
      og[d] = from_float<TQ>(acc / l);
    } else {  // every slot dead: the finite mask weighs every slot alike
      const TC* vg = v + ((size_t)row * S * KV + g) * D + d;
      float sum = 0.f;
      for (int j = 0; j < S; ++j) sum += to_float(vg[(size_t)j * KV * D]);
      og[d] = from_float<TQ>(sum / static_cast<float>(S));
    }
  }
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (count[dev] == 0 && cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  return count[dev];
}

int splits_for(int S) { return max(1, min((S + SLAB - 1) / SLAB, sm_count())); }

template <typename TQ, typename TC, int REP, int DPL>
int launch_rep(const void* q, const void* k, const void* v, const int* qpos, const int* kpos, void* out, float* part,
               float* lse, int B, int H, int KV, int D, int S, int window, float scale, int splits,
               cudaStream_t stream) {
  const int slab = (S + splits - 1) / splits;
  const int groups = (H / KV + REP - 1) / REP;
  // the chunk's K and V rows, which the warps' states reuse at the end
  const int bytes = max(Chunk<TC>::smem_bytes(D), WARPS * REP * D * static_cast<int>(sizeof(float)));
  auto split_kernel = flash_decode_split_kernel<TQ, TC, REP, DPL>;
  cudaError_t err = cudaFuncSetAttribute(split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  split_kernel<<<dim3(KV * groups, B, splits), THREADS, bytes, stream>>>(static_cast<const TQ*>(q), static_cast<const TC*>(k),
                                                                static_cast<const TC*>(v), qpos, kpos, part, H, KV,
                                                                D, S, window, slab, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the merge as the split kernel's programmatic dependent: its launch
  // overlaps the split kernel's tail
  return static_cast<int>(launch_dependent(flash_decode_combine_kernel<TQ, TC>, dim3(H, B), dim3(THREADS), 0, stream,
                                           static_cast<const float*>(part), static_cast<const TC*>(v),
                                           static_cast<TQ*>(out), lse, H, KV, D, S, splits));
}

// A lane's dims of the head, DPL, rounded up from D / 32 to 2, 4 or 8.
// The group's loops unrolled for 1, 2, 4, 8 or 16 queries a block (a group
// of 3 runs the 4-query code with the fourth masked off), at most
// MAX_ACC / DPL: past it the group's queries split over blocks.
template <typename TQ, typename TC, int DPL>
int launch_dpl(const void* q, const void* k, const void* v, const int* qpos, const int* kpos, void* out, float* part,
               float* lse, int B, int H, int KV, int D, int S, int window, float scale, int splits,
               cudaStream_t stream) {
  constexpr int CAP = MAX_ACC / DPL < MAX_REP ? MAX_ACC / DPL : MAX_REP;
  const int rep = H / KV;
  auto go = rep == 1   ? launch_rep<TQ, TC, 1, DPL>
            : rep == 2 ? launch_rep<TQ, TC, 2, DPL>
            : rep <= 4 ? launch_rep<TQ, TC, 4, DPL>
            : rep <= 8 ? launch_rep<TQ, TC, 8, DPL>
                       : launch_rep<TQ, TC, CAP, DPL>;
  return go(q, k, v, qpos, kpos, out, part, lse, B, H, KV, D, S, window, scale, splits, stream);
}

template <typename TQ, typename TC>
int launch(const void* q, const void* k, const void* v, const int* qpos, const int* kpos, void* out, float* part,
           float* lse, int B, int H, int KV, int D, int S, int window, float scale, int splits, cudaStream_t stream) {
  auto go = D <= 64 ? launch_dpl<TQ, TC, 2> : D <= 128 ? launch_dpl<TQ, TC, 4> : launch_dpl<TQ, TC, 8>;
  return go(q, k, v, qpos, kpos, out, part, lse, B, H, KV, D, S, window, scale, splits, stream);
}

// ---------------------------------------------------------------- head-dim split
// Scores of row blockIdx.y's slots blockIdx.x * THREADS + tid: a thread a
// slot, every query head of each KV head in turn over the Dr dims (the
// queries of the row staged in shared memory as float32, read by every
// thread alike).  A warp's loads of one dim stride over 32 slots' rows,
// which lie in the lines that its next dims read.
template <typename TQ, typename TC>
__global__ void __launch_bounds__(THREADS)
flash_decode_scores_kernel(const TQ* __restrict__ q,  // (B, H, D)
                           const TC* __restrict__ k,  // (B, S, KV, D)
                           float* __restrict__ scores, int H, int KV, int D, int S, float scale) {
  extern __shared__ float qs[];  // (H, D)
  const int row = blockIdx.y, tid = threadIdx.x, j = blockIdx.x * THREADS + tid;
  const TQ* qg = q + (size_t)row * H * D;
  for (int i = tid; i < H * D; i += THREADS) qs[i] = to_float(qg[i]);
  __syncthreads();
  if (j >= S) return;
  const int rep = H / KV;
  const TC* kr = k + ((size_t)row * S + j) * KV * D;
  float* sg = scores + (size_t)row * H * S + j;
  for (int g = 0; g < KV; ++g) {
    float acc[MAX_REP];
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) acc[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = to_float(kr[g * D + d]);
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < rep) acc[r] += qs[(g * rep + r) * D + d] * kd;
    }
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r)
      if (r < rep) sg[(size_t)(g * rep + r) * S] = acc[r] * scale;
  }
}

// The block's max (is_max) or sum of v, on every thread.
__device__ __forceinline__ float block_reduce(float v, float* red_s, bool is_max) {
  v = is_max ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red_s is free
  if (lane == 0) red_s[warp] = v;
  __syncthreads();
  float out = red_s[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) out = is_max ? fmaxf(out, red_s[w]) : out + red_s[w];
  return out;
}

// out[b, h, :Dr] and lse[b, h] from the summed scores of head h, row b: the
// max over the live slots, then chunk by chunk each slot's probability in
// shared memory and P V by THREADS / Dr phases of Dr threads (a thread a dim
// and every phase-th slot of the chunk; past Dr 128 a thread holds dims d
// and d + 128), the phases summed in order at the end.
template <typename TO, typename TC>
__global__ void __launch_bounds__(THREADS)
flash_decode_split_combine_kernel(const float* __restrict__ scores,  // (B, H, S), summed over the ranks
                                  const TC* __restrict__ v,          // (B, S, KV, D)
                                  const int* __restrict__ qpos, const int* __restrict__ kpos,
                                  TO* __restrict__ out, float* __restrict__ lse, int H, int KV, int D, int S,
                                  int window) {
  __shared__ float p_s[THREADS];
  __shared__ float acc_s[THREADS];
  __shared__ float red_s[WARPS];
  const int h = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  const int g = h / (H / KV);
  const float* sg = scores + ((size_t)row * H + h) * S;
  const int* kp = kpos + (size_t)row * S;
  const int qp = qpos[row];

  float mx = NEG_INF;
  int any = 0;
  for (int j = tid; j < S; j += THREADS) {
    const int p = kp[j];
    if (p <= qp && (window <= 0 || p > qp - window)) {
      mx = fmaxf(mx, sg[j]);
      any = 1;
    }
  }
  any = __syncthreads_or(any);
  mx = block_reduce(mx, red_s, true);

  const bool wide = D > THREADS;
  const int nph = wide ? 1 : THREADS / D, ph = wide ? 0 : tid / D, d0 = wide ? tid : tid % D;
  const bool active = wide || tid < nph * D;
  float acc0 = 0.f, acc1 = 0.f, lsum = 0.f;
  for (int j0 = 0; j0 < S; j0 += THREADS) {
    const int j = j0 + tid;
    float p = 0.f;
    if (j < S) {
      const int kpj = kp[j];
      const bool live = kpj <= qp && (window <= 0 || kpj > qp - window);
      p = any ? (live ? expf(sg[j] - mx) : 0.f) : 1.f;  // no live slot: every slot alike
    }
    lsum += p;
    __syncthreads();  // the chunk before is read
    p_s[tid] = p;
    __syncthreads();
    const int nb = min(THREADS, S - j0);
    if (active) {
      for (int jj = ph; jj < nb; jj += nph) {
        const TC* vr = v + (((size_t)row * S + j0 + jj) * KV + g) * D;
        acc0 += p_s[jj] * to_float(vr[d0]);
        if (wide && d0 + THREADS < D) acc1 += p_s[jj] * to_float(vr[d0 + THREADS]);
      }
    }
  }
  const float l = block_reduce(lsum, red_s, false);
  TO* og = out + ((size_t)row * H + h) * D;
  if (wide) {
    og[d0] = from_float<TO>(acc0 / l);
    if (d0 + THREADS < D) og[d0 + THREADS] = from_float<TO>(acc1 / l);
  } else {
    if (active) acc_s[tid] = acc0;
    __syncthreads();
    if (tid < D) {
      float sum = 0.f;
      for (int i = 0; i < nph; ++i) sum += acc_s[i * D + tid];
      og[tid] = from_float<TO>(sum / l);
    }
  }
  if (tid == 0) lse[(size_t)row * H + h] = any ? mx + logf(l) : NEG_INF;
}

int scores_smem_bytes(int H, int D) { return H * D * static_cast<int>(sizeof(float)); }

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused launch, or -1 for
// arguments the kernel does not take (splits must be splits_for(S), which
// ops.flash_decode_splits_for mirrors: the wrapper sizes the partials'
// scratch, (B, H, splits, D + 2) float32, with it).
// Shapes, dtypes and devices are checked by the Python wrapper
// (repro_torch/kernels/ops.py) before this.
// lse, when not null: (B, H) float32, each query's log-sum-exp.
extern "C" int flash_decode_launch(int q_dtype, int cache_dtype, const void* q, const void* k,
                                   const void* v, const int* qpos, const int* kpos, void* out, void* part,
                                   void* lse, int B, int H, int KV, int D, int S, int window, float scale,
                                   int splits, void* stream) {
  if (B <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || H / KV > MAX_REP || D <= 0 || D > MAX_D || D % 16)
    return -1;
  if (B > 65535 || H > 65535 || splits != splits_for(S)) return -1;
  // the cache is read by 16-byte loads
  if (reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* ls = static_cast<float*>(lse);
  if (q_dtype == kBFloat16 && cache_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, qpos, kpos, out, p, ls, B, H, KV, D, S, window, scale,
                                                splits, st);
  if (q_dtype == kFloat32 && cache_dtype == kBFloat16)
    return launch<float, __nv_bfloat16>(q, k, v, qpos, kpos, out, p, ls, B, H, KV, D, S, window, scale, splits,
                                        st);
  if (q_dtype == kFloat32 && cache_dtype == kFloat32)
    return launch<float, float>(q, k, v, qpos, kpos, out, p, ls, B, H, KV, D, S, window, scale, splits, st);
  return -1;
}

// The head-dim split's scores: q (B, H, Dr), k (B, S, KV, Dr), scores (B,
// H, S) float32 = scale * q . k over the Dr dims (scale the whole head's).
// Returns 0, a cudaError_t, or -1 for arguments the kernel does not take.
extern "C" int flash_decode_scores_launch(int q_dtype, int cache_dtype, const void* q, const void* k, void* scores,
                                          int B, int H, int KV, int D, int S, float scale, void* stream) {
  if (B <= 0 || B > 65535 || KV <= 0 || S <= 0 || H % KV != 0 || H / KV > MAX_REP || D <= 0 || D > MAX_D) return -1;
  const int smem = scores_smem_bytes(H, D);
  if (smem > 48 * 1024) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scores);
  const dim3 grid((S + THREADS - 1) / THREADS, B);
  if (q_dtype == kBFloat16 && cache_dtype == kBFloat16)
    flash_decode_scores_kernel<__nv_bfloat16, __nv_bfloat16><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), sc, H, KV, D, S, scale);
  else if (q_dtype == kFloat32 && cache_dtype == kBFloat16)
    flash_decode_scores_kernel<float, __nv_bfloat16><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(k), sc, H, KV, D, S, scale);
  else if (q_dtype == kFloat32 && cache_dtype == kFloat32)
    flash_decode_scores_kernel<float, float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), sc, H, KV, D, S, scale);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

// The head-dim split's softmax and P V: scores (B, H, S) float32 summed
// over the ranks, v (B, S, KV, Dr), positions as flash_decode_launch's;
// out (B, H, Dr) in out_dtype, lse (B, H) float32.
extern "C" int flash_decode_combine_launch(int out_dtype, int cache_dtype, const void* scores, const void* v,
                                           const int* qpos, const int* kpos, void* out, void* lse, int B, int H,
                                           int KV, int D, int S, int window, void* stream) {
  if (B <= 0 || B > 65535 || H > 65535 || KV <= 0 || S <= 0 || H % KV != 0 || D <= 0 || D > MAX_D) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scores);
  float* ls = static_cast<float*>(lse);
  const dim3 grid(H, B);
  if (out_dtype == kBFloat16 && cache_dtype == kBFloat16)
    flash_decode_split_combine_kernel<__nv_bfloat16, __nv_bfloat16><<<grid, THREADS, 0, st>>>(
        sc, static_cast<const __nv_bfloat16*>(v), qpos, kpos, static_cast<__nv_bfloat16*>(out), ls, H, KV, D, S,
        window);
  else if (out_dtype == kFloat32 && cache_dtype == kBFloat16)
    flash_decode_split_combine_kernel<float, __nv_bfloat16><<<grid, THREADS, 0, st>>>(
        sc, static_cast<const __nv_bfloat16*>(v), qpos, kpos, static_cast<float*>(out), ls, H, KV, D, S, window);
  else if (out_dtype == kFloat32 && cache_dtype == kFloat32)
    flash_decode_split_combine_kernel<float, float><<<grid, THREADS, 0, st>>>(
        sc, static_cast<const float*>(v), qpos, kpos, static_cast<float*>(out), ls, H, KV, D, S, window);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}
