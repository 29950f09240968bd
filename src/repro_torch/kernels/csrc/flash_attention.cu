// Blocked online-softmax attention, forward, for Hopper (sm_90a):
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, g]) v[b, j, g]
//   lse[b, h, i] = log sum_j exp(scale * q[b, i, h] . k[b, j, g])
//
// with g = h / (H / KV) (GQA, indexed here instead of repeated), key j
// visible to query i iff j < S, j <= i (causal) and j > i - window (window).
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention_pallas
// (kernel body _attn_kernel).  Kept from it: the masked scores are the
// finite -1e30, the running statistics (m, l) and the accumulator are
// float32, a (q tile, kv tile) pair that no query of the tile can see is
// skipped (tiles.cuh tile_relevant), and the output divides by
// max(l, 1e-30).  New: the row log-sum-exp m + log(l), which the backward
// kernel (flash_attention_bwd.cu) uses to recompute the probabilities.
//
// Layout: q (B, S, H, D) and k, v (B, S, KV, D), the model's own layout, so
// no transpose or repeat runs before the kernel; lse (B, H, S) float32.
//
// Design.  The TPU grid (b*h, q blocks, kv blocks) runs its kv axis in
// order and carries (m, l, acc) in VMEM; here one block owns (b, h, q
// tile) and walks its kv tiles in a loop.  Per kv tile: S = Q K^T into
// shared memory (tensor cores for bf16), a warp per row applies the mask
// and the online softmax, writes P (rounded to bf16 for the tensor cores)
// and rescales the float32 accumulator rows, then O += P V.  Tiles: 64 x 64
// in bf16, 32 x 32 in float32 (CUDA-core FMAs, full float32).
//
// What bounds it on the card: at the training shape (B 16, S 512, H 16,
// KV 8, D 128, causal, bf16) it moves ~100 MB and does ~1.7e10 FLOPs, so
// its bound is the bytes (~30 us at 3.35 TB/s).  This first kernel is
// simple: WMMA fragments through a shared-memory accumulator, no TMA, no
// wgmma, no overlap of loads with math, so it runs well above that bound.
#include "tiles.cuh"

namespace {

template <typename T>
struct FwdSmem {
  static constexpr int BQ = Tile<T>::R, BK = Tile<T>::R;
  int D, ldt, lds, ldp, ldo;
  size_t q, k, v, s, p, o, m, l, alpha, bytes;
  __host__ __device__ explicit FwdSmem(int d) : D(d) {
    ldt = D + PAD_T;
    lds = BK + PAD_F;
    ldp = BK + PAD_T;
    ldo = D + PAD_F;
    q = 0;
    k = q + align128(sizeof(T) * BQ * ldt);
    v = k + align128(sizeof(T) * BK * ldt);
    s = v + align128(sizeof(T) * BK * ldt);
    p = s + align128(sizeof(float) * BQ * lds);
    o = p + align128(sizeof(T) * BQ * ldp);
    m = o + align128(sizeof(float) * BQ * ldo);
    l = m + align128(sizeof(float) * BQ);
    alpha = l + align128(sizeof(float) * BQ);
    bytes = alpha + align128(sizeof(float) * BQ);
  }
};

template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int S, int H, int KV, int D, int causal,
                 int window, float scale) {
  constexpr int BQ = FwdSmem<T>::BQ, BK = FwdSmem<T>::BK;
  static_assert(BK % 32 == 0, "a warp covers a score row in BK / 32 columns per lane");
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem<T> L(D);
  T* q_s = reinterpret_cast<T*>(smem + L.q);
  T* k_s = reinterpret_cast<T*>(smem + L.k);
  T* v_s = reinterpret_cast<T*>(smem + L.v);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  T* p_s = reinterpret_cast<T*>(smem + L.p);
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

  const int nk = (S + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (!tile_relevant(q0, k0, BQ, BK, causal, window)) continue;
    const long long krow = ((long long)b * S + k0) * ktok + (long long)g * D;
    load_rows(k_s, L.ldt, k + krow, ktok, BK, min(BK, S - k0), D);
    load_rows(v_s, L.ldt, v + krow, ktok, BK, min(BK, S - k0), D);
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
        sv[c] = key_visible(qi, k0 + col, S, causal, window) ? x : MASKED;
        mx = fmaxf(mx, sv[c]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const float p = expf(sv[c] - m_new);
        p_s[r * L.ldp + lane + 32 * c] = from_float<T>(p);
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
      out[((long long)b * S + q0 + i) * qtok + (long long)h * D + j] =
          from_float<T>(o_s[i * L.ldo + j] / fmaxf(l_s[i], 1e-30f));
    }
  }
  for (int i = tid; i < BQ; i += blockDim.x) {
    if (q0 + i < S) lse[((long long)b * H + h) * S + q0 + i] = m_s[i] + logf(fmaxf(l_s[i], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S, int H, int KV,
           int D, int causal, int window, float scale, cudaStream_t stream) {
  const FwdSmem<T> L(D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + FwdSmem<T>::BQ - 1) / FwdSmem<T>::BQ, H, B);
  flash_fwd_kernel<T><<<grid, TILE_THREADS, L.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), lse,
      S, H, KV, D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused launch, or -1 for
// arguments the kernel does not take.  Shapes, dtypes, devices and
// contiguity are checked by the Python wrapper (repro_torch/kernels/ops.py).
extern "C" int flash_attention_fwd_launch(int dtype, const void* q, const void* k, const void* v, void* out,
                                          void* lse, int B, int S, int H, int KV, int D, int causal, int window,
                                          float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D % 16 != 0 || D > MAX_D) return -1;
  if (H > 65535 || B > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == kFloat32) return launch<float>(q, k, v, out, l, B, S, H, KV, D, causal, window, scale, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(q, k, v, out, l, B, S, H, KV, D, causal, window, scale, s);
  return -1;
}
