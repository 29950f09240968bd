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
// group (rep = 2 for qwen3-1.7b), a few FLOP per byte, so it is bound by
// reading the K and V cache once.  One block per (row, kv head) holds the
// group's rep queries in shared memory and streams the cache in steps of BK
// slots with an online softmax, so the group shares every cache read and
// each cache byte is read from memory once.  Each step's K, V and slot
// positions arrive by 16-byte loads into registers, issued one step ahead
// (while the block computes on the step before), and are staged through
// shared memory.  A slot's scores are computed by SEG threads, each over a
// contiguous part of the head dim, and meet in a fixed shuffle tree; the
// rows of the staged tile are padded by 16 bytes so those reads do not
// collide in shared-memory banks.
//
// Simple first: CUDA-core FMAs, one block per (row, kv head), no split of
// the sequence across blocks.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 8;    // query heads per kv head
constexpr int MAX_D = 256;    // head dim
constexpr int DPT = MAX_D / THREADS;  // output dims per thread
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

template <typename TQ, typename TC>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const TQ* __restrict__ q,      // (B, H, D)
                    const TC* __restrict__ k,      // (B, S, KV, D)
                    const TC* __restrict__ v,      // (B, S, KV, D)
                    const int* __restrict__ qpos,  // (B,)
                    const int* __restrict__ kpos,  // (B, S)
                    TQ* __restrict__ out,          // (B, H, D)
                    int H, int KV, int D, int S, int window, float scale) {
  constexpr int VEC = 16 / sizeof(TC);               // elements per 16-byte load
  constexpr int BK = 64 / sizeof(TC);                // slots per step: 32 bf16, 16 f32
  constexpr int SEG = THREADS / BK;                  // threads per slot for the scores
  constexpr int SPW = 32 / SEG;                      // slots per warp for the scores
  constexpr int ROW = MAX_D + VEC;                   // padded row: 16 bytes more
  constexpr int LOADS = BK * MAX_D / VEC / THREADS;  // 16-byte loads per thread per step
  static_assert(BK <= THREADS && WARPS * SPW == BK, "one score group per slot");
  __shared__ __align__(16) TC k_s[BK][ROW];
  __shared__ __align__(16) TC v_s[BK][ROW];
  __shared__ float q_s[MAX_REP][MAX_D];
  __shared__ float p_s[MAX_REP][BK];  // scores, then probabilities, of one step
  __shared__ int kpos_s[BK];
  __shared__ float m_s[MAX_REP];
  __shared__ float l_s[MAX_REP];
  __shared__ float alpha_s[MAX_REP];

  const int kvh = blockIdx.x;
  const int row = blockIdx.y;
  const int rep = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dvecs = D / VEC;  // 16-byte vectors per slot

  const TQ* qg = q + ((size_t)row * H + (size_t)kvh * rep) * D;
  for (int i = tid; i < rep * D; i += THREADS) q_s[i / D][i % D] = to_float(qg[i]);
  if (tid < rep) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  const int qp = qpos[row];
  const int* kp = kpos + (size_t)row * S;
  const size_t slot_stride = (size_t)KV * D;
  const TC* kb = k + ((size_t)row * S * KV + kvh) * D;
  const TC* vb = v + ((size_t)row * S * KV + kvh) * D;

  uint4 kr[LOADS], vr[LOADS];
  int kpr = 0;
  auto fetch = [&](int j0) {
    const int nb = min(BK, S - j0);
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = tid + u * THREADS;
      if (e < nb * dvecs) {
        const size_t off = (size_t)(j0 + e / dvecs) * slot_stride + (size_t)(e % dvecs) * VEC;
        kr[u] = *reinterpret_cast<const uint4*>(kb + off);
        vr[u] = *reinterpret_cast<const uint4*>(vb + off);
      }
    }
    if (tid < nb) kpr = kp[j0 + tid];
  };

  float acc[MAX_REP][DPT];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[r][i] = 0.f;

  // score-phase roles: slot js of this step, part seg of the head dim
  const int js = warp * SPW + lane % SPW;
  const int seg = lane / SPW;
  const int seg_vecs = dvecs / SEG;

  fetch(0);
  for (int j0 = 0; j0 < S; j0 += BK) {
    const int nb = min(BK, S - j0);

    // (0) stage this step's K, V and slot positions, then start the next step's loads
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = tid + u * THREADS;
      if (e < nb * dvecs) {
        *reinterpret_cast<uint4*>(&k_s[e / dvecs][(e % dvecs) * VEC]) = kr[u];
        *reinterpret_cast<uint4*>(&v_s[e / dvecs][(e % dvecs) * VEC]) = vr[u];
      }
    }
    if (tid < nb) kpos_s[tid] = kpr;
    __syncthreads();
    if (j0 + BK < S) fetch(j0 + BK);

    // (1) scores: SEG threads per slot, each over seg_vecs contiguous
    //     vectors of the head dim, then a fixed shuffle tree across them.
    float sc[MAX_REP];
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) sc[r] = 0.f;
    if (js < nb) {
      for (int u = 0; u < seg_vecs; ++u) {
        const int d0 = (seg * seg_vecs + u) * VEC;
        float kv[VEC];
        load_vec(&k_s[js][d0], kv);
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r)
          if (r < rep) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) sc[r] += q_s[r][d0 + e] * kv[e];
          }
      }
    }
    const int kpj = kpos_s[js < nb ? js : 0];
    const bool live = js < nb && kpj <= qp && (window <= 0 || kpj > qp - window);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r < rep) {
        float s = sc[r];
#pragma unroll
        for (int off = SPW; off < 32; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (seg == 0 && js < nb) p_s[r][js] = live ? s * scale : NEG_INF;
      }
    }
    __syncthreads();

    // (2) online-softmax update, one warp per query of the group.
    for (int r = warp; r < rep; r += WARPS) {
      float mx = NEG_INF;
      for (int j = lane; j < nb; j += 32) mx = fmaxf(mx, p_s[r][j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < nb; j += 32) {
        const float e = expf(p_s[r][j] - m_new);
        p_s[r][j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // (3) acc = acc * alpha + p @ V: each thread owns DPT dims of the output.
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = tid + i * THREADS;
      if (d < D) {
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r)
          if (r < rep) acc[r][i] *= alpha_s[r];
#pragma unroll 8
        for (int j = 0; j < nb; ++j) {
          const float vd = to_float(v_s[j][d]);
#pragma unroll
          for (int r = 0; r < MAX_REP; ++r)
            if (r < rep) acc[r][i] += p_s[r][j] * vd;
        }
      }
    }
    __syncthreads();
  }

  TQ* og = out + ((size_t)row * H + (size_t)kvh * rep) * D;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = tid + i * THREADS;
    if (d < D) {
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < rep) og[(size_t)r * D + d] = from_float<TQ>(acc[r][i] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename TQ, typename TC>
int launch(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
           void* out, int B, int H, int KV, int D, int S, int window, float scale,
           cudaStream_t stream) {
  dim3 grid(KV, B);
  flash_decode_kernel<TQ, TC><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v), qpos,
      kpos, static_cast<TQ*>(out), H, KV, D, S, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused launch, or -1 for
// arguments the kernel does not take.  Shapes, dtypes and devices are
// checked by the Python wrapper (repro_torch/kernels/ops.py) before this.
extern "C" int flash_decode_launch(int q_dtype, int cache_dtype, const void* q, const void* k,
                                   const void* v, const int* qpos, const int* kpos, void* out,
                                   int B, int H, int KV, int D, int S, int window, float scale,
                                   void* stream) {
  if (B <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || H / KV > MAX_REP || D > MAX_D || D % 32)
    return -1;
  // the cache is read by 16-byte loads
  if (reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kBFloat16 && cache_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, qpos, kpos, out, B, H, KV, D, S,
                                                window, scale, st);
  if (q_dtype == kFloat32 && cache_dtype == kBFloat16)
    return launch<float, __nv_bfloat16>(q, k, v, qpos, kpos, out, B, H, KV, D, S, window,
                                        scale, st);
  if (q_dtype == kFloat32 && cache_dtype == kFloat32)
    return launch<float, float>(q, k, v, qpos, kpos, out, B, H, KV, D, S, window, scale, st);
  return -1;
}
