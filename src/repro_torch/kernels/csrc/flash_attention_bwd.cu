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
// (B, H, S, S) probability matrix; this one keeps every (S x S) tile in
// shared memory, which is what makes attention's activation memory linear
// in S.
//
// Design.  Deterministic, with no float atomics: two kernels, launched in
// order on one stream.  (1) One block per (b, h, q tile) computes Delta for
// its rows (stored for kernel 2), then walks the visible kv tiles and owns
// dQ of its rows.  (2) One block per (b, kv head, kv tile) walks the query
// heads of its group and their visible q tiles in a fixed order and owns dK
// and dV of its keys, so the GQA sum over heads happens inside the block in
// a fixed order.  Both use the forward's tile-skip predicate.  Products run
// on the tensor cores for bf16 (P and dS rounded to bf16 for them, float32
// accumulators in shared memory) and as float32 FMAs for float32.
//
// What bounds it on the card: at the training shape (B 16, S 512, H 16,
// KV 8, D 128, causal, bf16) about 2.5x the forward's FLOPs (~4.3e10) over
// ~170 MB, so its bound is the operations or bytes at ~60 us.  Simple
// first: no TMA, no wgmma, each kernel recomputes Q K^T for its own pass.
#include "tiles.cuh"

namespace {

template <typename T>
struct DqSmem {
  static constexpr int BQ = Tile<T>::R, BK = Tile<T>::R;
  int D, ldt, lds, ldp, ldo;
  size_t q, dout, k, v, s, dp, ds, dq, lse, delta, bytes;
  __host__ __device__ explicit DqSmem(int d) : D(d) {
    ldt = D + PAD_T;
    lds = BK + PAD_F;
    ldp = BK + PAD_T;
    ldo = D + PAD_F;
    q = 0;
    dout = q + align128(sizeof(T) * BQ * ldt);
    k = dout + align128(sizeof(T) * BQ * ldt);
    v = k + align128(sizeof(T) * BK * ldt);
    s = v + align128(sizeof(T) * BK * ldt);
    dp = s + align128(sizeof(float) * BQ * lds);
    ds = dp + align128(sizeof(float) * BQ * lds);
    dq = ds + align128(sizeof(T) * BQ * ldp);
    lse = dq + align128(sizeof(float) * BQ * ldo);
    delta = lse + align128(sizeof(float) * BQ);
    bytes = delta + align128(sizeof(float) * BQ);
  }
};

template <typename T>
struct DkvSmem {
  static constexpr int BQ = Tile<T>::R, BK = Tile<T>::R;
  int D, ldt, lds, ldp, ldo;
  size_t k, v, q, dout, st, dpt, pt, dst, dk, dv, lse, delta, bytes;
  __host__ __device__ explicit DkvSmem(int d) : D(d) {
    ldt = D + PAD_T;
    lds = BQ + PAD_F;
    ldp = BQ + PAD_T;
    ldo = D + PAD_F;
    k = 0;
    v = k + align128(sizeof(T) * BK * ldt);
    q = v + align128(sizeof(T) * BK * ldt);
    dout = q + align128(sizeof(T) * BQ * ldt);
    st = dout + align128(sizeof(T) * BQ * ldt);
    dpt = st + align128(sizeof(float) * BK * lds);
    pt = dpt + align128(sizeof(float) * BK * lds);
    dst = pt + align128(sizeof(T) * BK * ldp);
    dk = dst + align128(sizeof(T) * BK * ldp);
    dv = dk + align128(sizeof(float) * BK * ldo);
    lse = dv + align128(sizeof(float) * BK * ldo);
    delta = lse + align128(sizeof(float) * BQ);
    bytes = delta + align128(sizeof(float) * BQ);
  }
};

// (1) Delta and dQ.  One block per (b, h, q tile).
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ out, const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int S, int H, int KV, int D, int causal,
                    int window, float scale) {
  constexpr int BQ = DqSmem<T>::BQ, BK = DqSmem<T>::BK;
  static_assert(BQ == BK, "O is staged in the K buffer");
  extern __shared__ __align__(128) unsigned char smem[];
  const DqSmem<T> L(D);
  T* q_s = reinterpret_cast<T*>(smem + L.q);
  T* do_s = reinterpret_cast<T*>(smem + L.dout);
  T* k_s = reinterpret_cast<T*>(smem + L.k);
  T* v_s = reinterpret_cast<T*>(smem + L.v);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* dp_s = reinterpret_cast<float*>(smem + L.dp);
  T* ds_s = reinterpret_cast<T*>(smem + L.ds);
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
    for (int j = lane; j < D; j += 32) acc += to_float(do_s[r * L.ldt + j]) * to_float(k_s[r * L.ldt + j]);
    acc = warp_sum(acc);
    if (lane == 0) {
      delta_s[r] = r < qvalid ? acc : 0.f;
      lse_s[r] = r < qvalid ? lse[srow + r] : 0.f;
      if (r < qvalid) delta[srow + r] = acc;
    }
  }
  __syncthreads();

  const int nk = (S + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (!tile_relevant(q0, k0, BQ, BK, causal, window)) continue;
    const long long krow = ((long long)b * S + k0) * ktok + (long long)g * D;
    load_rows(k_s, L.ldt, k + krow, ktok, BK, min(BK, S - k0), D);
    load_rows(v_s, L.ldt, v + krow, ktok, BK, min(BK, S - k0), D);
    __syncthreads();
    tile_mma<true>(s_s, L.lds, q_s, L.ldt, k_s, L.ldt, BQ, BK, D, false);    // S = Q K^T
    tile_mma<true>(dp_s, L.lds, do_s, L.ldt, v_s, L.ldt, BQ, BK, D, false);  // dP = dO V^T
    __syncthreads();
    for (int e = tid; e < BQ * BK; e += blockDim.x) {
      const int i = e / BK, j = e % BK;
      const float p = key_visible(q0 + i, k0 + j, S, causal, window)
                          ? expf(s_s[i * L.lds + j] * scale - lse_s[i]) : 0.f;
      ds_s[i * L.ldp + j] = from_float<T>(p * (dp_s[i * L.lds + j] - delta_s[i]));
    }
    __syncthreads();
    tile_mma<false>(dq_s, L.ldo, ds_s, L.ldp, k_s, L.ldt, BQ, D, BK, true);  // dQ += dS K
    __syncthreads();
  }
  for (int e = tid; e < BQ * D; e += blockDim.x) {
    const int i = e / D, j = e % D;
    if (i < qvalid) dq[qrow + (long long)i * qtok + j] = from_float<T>(dq_s[i * L.ldo + j] * scale);
  }
}

// (2) dK and dV.  One block per (b, kv head, kv tile).
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV, int D, int causal, int window,
                     float scale) {
  constexpr int BQ = DkvSmem<T>::BQ, BK = DkvSmem<T>::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  const DkvSmem<T> L(D);
  T* k_s = reinterpret_cast<T*>(smem + L.k);
  T* v_s = reinterpret_cast<T*>(smem + L.v);
  T* q_s = reinterpret_cast<T*>(smem + L.q);
  T* do_s = reinterpret_cast<T*>(smem + L.dout);
  float* st_s = reinterpret_cast<float*>(smem + L.st);
  float* dpt_s = reinterpret_cast<float*>(smem + L.dpt);
  T* pt_s = reinterpret_cast<T*>(smem + L.pt);
  T* dst_s = reinterpret_cast<T*>(smem + L.dst);
  float* dk_s = reinterpret_cast<float*>(smem + L.dk);
  float* dv_s = reinterpret_cast<float*>(smem + L.dv);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);

  const int tid = threadIdx.x;
  const int b = blockIdx.z, g = blockIdx.y, k0 = blockIdx.x * BK;
  const int rep = H / KV;
  const int kvalid = min(BK, S - k0);
  const long long qtok = (long long)H * D, ktok = (long long)KV * D;
  const long long krow = ((long long)b * S + k0) * ktok + (long long)g * D;

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
        const float p = (i < qvalid && key_visible(q0 + i, k0 + j, S, causal, window))
                            ? expf(st_s[j * L.lds + i] * scale - lse_s[i]) : 0.f;
        pt_s[j * L.ldp + i] = from_float<T>(p);
        dst_s[j * L.ldp + i] = from_float<T>(p * (dpt_s[j * L.lds + i] - delta_s[i]));
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
      dk[krow + (long long)j * ktok + c] = from_float<T>(dk_s[j * L.ldo + c] * scale);
      dv[krow + (long long)j * ktok + c] = from_float<T>(dv_s[j * L.ldo + c]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout, const float* lse,
           float* delta, void* dq, void* dk, void* dv, int B, int S, int H, int KV, int D, int causal, int window,
           float scale, cudaStream_t stream) {
  const DqSmem<T> Lq(D);
  const DkvSmem<T> Lkv(D);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Lq.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Lkv.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const dim3 grid_q((S + DqSmem<T>::BQ - 1) / DqSmem<T>::BQ, H, B);
  flash_bwd_dq_kernel<T><<<grid_q, TILE_THREADS, Lq.bytes, stream>>>(
      qt, kt, vt, static_cast<const T*>(out), dot, lse, delta, static_cast<T*>(dq), S, H, KV, D, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((S + DkvSmem<T>::BK - 1) / DkvSmem<T>::BK, KV, B);
  flash_bwd_dkv_kernel<T><<<grid_kv, TILE_THREADS, Lkv.bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused launch, or -1 for
// arguments the kernels do not take.  `delta` is (B, H, S) float32 scratch;
// shapes, dtypes, devices and contiguity are checked by the Python wrapper
// (repro_torch/kernels/ops.py).
extern "C" int flash_attention_bwd_launch(int dtype, const void* q, const void* k, const void* v, const void* out,
                                          const void* dout, const void* lse, void* delta, void* dq, void* dk,
                                          void* dv, int B, int S, int H, int KV, int D, int causal, int window,
                                          float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D % 16 != 0 || D > MAX_D) return -1;
  if (H > 65535 || B > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, H, KV, D, causal, window, scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, H, KV, D, causal, window, scale, s);
  return -1;
}
