// WKV6 forward for Hopper (sm_90a): the RWKV6 time-mix recurrence
//
//   out_t[v] = sum_k r_t[k] (S[k, v] + u[k] k_t[k] v_t[v])
//   S[k, v] <- exp(logw_t[k]) S[k, v] + k_t[k] v_t[v]
//
// per (batch, head), from an optional initial state s0, returning out in
// float32 and the final state.
//
// Replaces src/repro/kernels/rwkv6_scan.py: wkv6_pallas (kernel body
// _wkv_kernel).  Kept from it: the per-head state never leaves fast memory
// (there VMEM scratch across the sequential chunk grid, here registers), so
// no (B, S, K, V) tensor exists in device memory.  Changed: the TPU kernel
// runs each 16-token chunk as matmuls through the log-decay division trick,
// which is safe only because logw is clamped to [-4, 0) (e^{16*4} inside a
// chunk); this kernel is the sequential form that the TPU kernel adapted,
// with no division and no overflow bound.  Also new: the state in (s0) and
// out (the prefill-with-state branch of repro/nn/rwkv.py), and out in
// float32, which is what the model path reads (_wkv_chunked computes in
// float32 and _group_norm follows).
//
// Design: one block per (b, h) of K * K / (TK * 4) threads (128 at K 64);
// thread (kg, vg) holds a register tile of the state, rows kg * TK ..
// kg * TK + TK - 1 by columns vg * 4 .. vg * 4 + 3 (TK 8 at K 64, 2 at K 16
// and 32).  Each 16-token chunk of r, k, v and logw lands in shared memory
// by cp.async while the chunk before it computes (wkv6_common.cuh's
// layout, each thread's copies counted at compile time); the threads
// convert it to float32 with w = exp(logw) and take each token's bonus
// sum_k r u k there, one shuffle tree per token.  Per token a thread reads
// its TK values of r, k, w and 4 of v (broadcasts across the warp: its 32
// lanes span 32 / (K / 4) row groups), updates its tile (S = w S + k v) and
// writes its share of out, sum over its rows of r S, to shared memory.
// Once a chunk, the shares of the K / TK row groups are summed in order,
// the bonus u-term added, and out leaves as 16-byte rows.  No sum depends
// on timing, so two runs give the same bits.
//
// What bounds it on the card: at the training shape (B 16, S 512, H 40,
// K 64, bf16 r/k/v) it moves ~304 MB (r, k, v bf16; logw and out float32;
// the final state), ~91 us at 3.35 TB/s, and does 6.7e9 float32
// operations, ~100 us at 67 TFLOP/s, so operations bound it: 3 float32
// instructions per state element and token (r S, k v, w S + k v).  Per
// token a thread issues 96 of them against 7 broadcast 16-byte
// shared-memory loads and one 16-byte store of its out share; three blocks
// of 4 warps run on an SM (~68 KB of shared memory each).
#include <cstdint>
#include <initializer_list>

#include "wkv6_common.cuh"

namespace {

// The rows of the state a thread holds at head dim K.
template <int K>
constexpr int FWD_TILE_ROWS = K == 64 ? 8 : 2;

template <typename T, int K>
struct ForwardSmem {
  static constexpr int KG = K / FWD_TILE_ROWS<K>;  // row groups
  WkvChunk<T, K> raw[2];
  WkvStaged<K> s;
  alignas(16) float part[WKV_CHUNK][KG][K];  // each row group's share of out
  float u[K], ruk[WKV_CHUNK];
};

// TK consecutive staged floats from p (8-byte aligned at TK 2, 16 at TK 8).
template <int TK>
__device__ __forceinline__ void load_rows(float* dst, const float* p) {
  if constexpr (TK == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    dst[0] = v.x, dst[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < TK; i += 4) {
      const float4 v = wkv_ld4(p + i);
      dst[i] = v.x, dst[i + 1] = v.y, dst[i + 2] = v.z, dst[i + 3] = v.w;
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(K * K / (4 * FWD_TILE_ROWS<K>)) wkv6_forward_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, const float* __restrict__ s0, float* __restrict__ out, float* __restrict__ sT,
    int S, int H) {
  constexpr int C = WKV_CHUNK, TK = FWD_TILE_ROWS<K>, KG = K / TK, VG = K / 4, NT = KG * VG;
  constexpr int TPT = K / 4;  // threads per token in the convert and the out sums, 4 elements each
  static_assert(C * TPT % NT == 0, "every thread converts and sums the same number of elements");
  extern __shared__ __align__(16) unsigned char smem[];
  ForwardSmem<T, K>& sm = *reinterpret_cast<ForwardSmem<T, K>*>(smem);
  const int bh = blockIdx.x, b = bh / H, h = bh % H, tid = threadIdx.x, kg = tid / VG, vg = tid % VG;
  const int k0 = kg * TK, v0 = vg * 4;
  const size_t row = (size_t)H * K, base = (size_t)b * S * row + (size_t)h * K, sbase = (size_t)bh * K * K;
  if (tid < K) sm.u[tid] = u[h * K + tid];
  float st[TK][4];
#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const float4 x = s0 ? wkv_ld4(s0 + sbase + (size_t)(k0 + i) * K + v0) : make_float4(0.f, 0.f, 0.f, 0.f);
    st[i][0] = x.x, st[i][1] = x.y, st[i][2] = x.z, st[i][3] = x.w;
  }
  const int nc = (S + C - 1) / C;
  wkv_issue_chunk<NT>(sm.raw[0], r, k, v, logw, base, row, 0, min(C, S), tid);
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * C, n = min(C, S - t0);
    cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; the previous chunk is no longer read
    if (c + 1 < nc) {
      wkv_issue_chunk<NT>(sm.raw[(c + 1) & 1], r, k, v, logw, base, row, t0 + C, min(C, S - t0 - C), tid);
      cp_async_commit();
    }
    // to float32, w = exp(logw), and each token's bonus sum_k r u k; rows
    // past n are zeros (w = 1: the tile carries through them unchanged)
    const WkvChunk<T, K>& raw = sm.raw[c & 1];
#pragma unroll
    for (int e0 = 0; e0 < C * TPT; e0 += NT) {
      const int e = e0 + tid, t = e / TPT, x = (e % TPT) * 4;
      float rv[4], kv[4], vv[4], wv[4], ruk = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        rv[j] = to_float(raw.r[t][x + j]);
        kv[j] = to_float(raw.k[t][x + j]);
        vv[j] = to_float(raw.v[t][x + j]);
        wv[j] = expf(raw.lw[t][x + j]);
        ruk = fmaf(rv[j] * sm.u[x + j], kv[j], ruk);
      }
      *reinterpret_cast<float4*>(&sm.s.r[t][x]) = make_float4(rv[0], rv[1], rv[2], rv[3]);
      *reinterpret_cast<float4*>(&sm.s.k[t][x]) = make_float4(kv[0], kv[1], kv[2], kv[3]);
      *reinterpret_cast<float4*>(&sm.s.v[t][x]) = make_float4(vv[0], vv[1], vv[2], vv[3]);
      *reinterpret_cast<float4*>(&sm.s.w[t][x]) = make_float4(wv[0], wv[1], wv[2], wv[3]);
#pragma unroll
      for (int o = TPT / 2; o > 0; o >>= 1) ruk += __shfl_xor_sync(0xffffffffu, ruk, o);
      if (x == 0) sm.ruk[t] = ruk;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < C; ++t) {
      float rr[TK], kk[TK], ww[TK];
      load_rows<TK>(rr, &sm.s.r[t][k0]);
      load_rows<TK>(kk, &sm.s.k[t][k0]);
      load_rows<TK>(ww, &sm.s.w[t][k0]);
      const float4 vv = wkv_ld4(&sm.s.v[t][v0]);
      const float vj[4] = {vv.x, vv.y, vv.z, vv.w};
      float o[4] = {0.f, 0.f, 0.f, 0.f};  // sum over this thread's rows of r S, S before this token
#pragma unroll
      for (int i = 0; i < TK; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[j] = fmaf(rr[i], st[i][j], o[j]);
          st[i][j] = fmaf(ww[i], st[i][j], kk[i] * vj[j]);
        }
      }
      *reinterpret_cast<float4*>(&sm.part[t][kg][v0]) = make_float4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();
    // out: the row groups' shares in order, then the bonus (sum_k r u k) v
#pragma unroll
    for (int e0 = 0; e0 < C * TPT; e0 += NT) {
      const int e = e0 + tid, t = e / TPT, x = (e % TPT) * 4;
      if (t >= n) continue;
      float4 acc = wkv_ld4(&sm.part[t][0][x]);
#pragma unroll
      for (int g = 1; g < KG; ++g) {
        const float4 p = wkv_ld4(&sm.part[t][g][x]);
        acc.x += p.x, acc.y += p.y, acc.z += p.z, acc.w += p.w;
      }
      const float4 vv = wkv_ld4(&sm.s.v[t][x]);
      const float bonus = sm.ruk[t];
      acc = make_float4(fmaf(bonus, vv.x, acc.x), fmaf(bonus, vv.y, acc.y), fmaf(bonus, vv.z, acc.z),
                        fmaf(bonus, vv.w, acc.w));
      *reinterpret_cast<float4*>(out + base + (size_t)(t0 + t) * row + x) = acc;
    }
  }
  if (sT) {
#pragma unroll
    for (int i = 0; i < TK; ++i)
      *reinterpret_cast<float4*>(sT + sbase + (size_t)(k0 + i) * K + v0) =
          make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
  }
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const float* logw, const float* u, const float* s0, float* out,
           float* sT, int B, int S, int H, cudaStream_t stream) {
  constexpr int smem = sizeof(ForwardSmem<T, K>), threads = K * K / (4 * FWD_TILE_ROWS<K>);
  cudaError_t err = cudaFuncSetAttribute(wkv6_forward_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_forward_kernel<T, K><<<B * H, threads, smem, stream>>>(static_cast<const T*>(r), static_cast<const T*>(k),
                                                              static_cast<const T*>(v), logw, u, s0, out, sT, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int K, const void* r, const void* k, const void* v, const float* logw, const float* u, const float* s0,
             float* out, float* sT, int B, int S, int H, cudaStream_t stream) {
  if (K == 16) return launch<T, 16>(r, k, v, logw, u, s0, out, sT, B, S, H, stream);
  if (K == 32) return launch<T, 32>(r, k, v, logw, u, s0, out, sT, B, S, H, stream);
  if (K == 64) return launch<T, 64>(r, k, v, logw, u, s0, out, sT, B, S, H, stream);
  return -1;
}

}  // namespace

// Dynamic shared memory of the forward at head dim K.
extern "C" int wkv6_fwd_smem_bytes(int dtype, int K) {
  if (!wkv_supported_head_dim(K)) return -1;
  if (dtype == kFloat32) return K == 16 ? sizeof(ForwardSmem<float, 16>) : K == 32 ? sizeof(ForwardSmem<float, 32>)
                                                                                   : sizeof(ForwardSmem<float, 64>);
  if (dtype == kBFloat16)
    return K == 16 ? sizeof(ForwardSmem<__nv_bfloat16, 16>)
                   : K == 32 ? sizeof(ForwardSmem<__nv_bfloat16, 32>) : sizeof(ForwardSmem<__nv_bfloat16, 64>);
  return -1;
}

// r, k, v (B, S, H, K) of dtype; logw (B, S, H, K) and u (H, K) float32;
// s0 (B, H, K, K) float32 or null; out (B, S, H, K) and sT (B, H, K, K)
// float32.  r, k, v, logw and s0 16-byte aligned.  Returns 0 or a CUDA
// error code (-1: arguments not supported).
extern "C" int wkv6_fwd_launch(int dtype, const void* r, const void* k, const void* v, const void* logw,
                               const void* u, const void* s0, void* out, void* sT, int B, int S, int H, int K,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || !wkv_supported_head_dim(K)) return -1;
  for (const void* p : {r, k, v, logw, s0})
    if (reinterpret_cast<uintptr_t>(p) % 16) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto lw = static_cast<const float*>(logw);
  auto uu = static_cast<const float*>(u);
  auto s0f = static_cast<const float*>(s0);
  auto o = static_cast<float*>(out);
  auto st = static_cast<float*>(sT);
  if (dtype == kFloat32) return dispatch<float>(K, r, k, v, lw, uu, s0f, o, st, B, S, H, s);
  if (dtype == kBFloat16) return dispatch<__nv_bfloat16>(K, r, k, v, lw, uu, s0f, o, st, B, S, H, s);
  return -1;
}
