// Mamba selective scan, backward, for Hopper (sm_90a): the gradients of
// mamba_scan.cu's recurrence (the final state takes no cotangent).
//
// With a_t = exp(dt_t A), u_t = dt_t x_t, h_t the state after token t
// (h_{-1} = 0) and g_t = dL/dh_t, per batch row and channel d:
//
//   g_t       = a_{t+1} g_{t+1} + dy_t C_t          (g_S = 0)
//   q_t[n]    = g_t[n] a_t[n] h_{t-1}[n]
//   du_t      = sum_n g_t[n] B_t[n]
//   d_dt_t    = sum_n q_t[n] A[d, n] + x_t du_t
//   dx_t      = dt_t du_t + D[d] dy_t
//   dB_t[n]   = sum_d g_t[d, n] u_t[d]          (a sum over channels)
//   dC_t[n]   = sum_d dy_t[d] h_t[d, n]         (a sum over channels)
//   dA[d, n]  = sum_{b, t} q_t[n] dt_t          (a sum over rows and time)
//   dD[d]     = sum_{b, t} dy_t x_t
//
// The TPU kernel (src/repro/kernels/mamba_scan.py: mamba_scan_pallas) has
// no backward, and the JAX training path differentiates its associative
// scan by XLA.  The port needs one: the LoRA on in_proj sits before the
// scan, so every active Mamba layer's LoRA gradient flows through it.
//
// Design.  Saving every per-token state is too large (4.3 GB per layer at
// the training shape), so the forward saves only its inputs and the
// backward recomputes states from a few it keeps:
//   1. mamba_chunk_states_kernel sweeps forward and writes the state
//      entering each chunk of MAMBA_BWD_CHUNK (8) tokens to a scratch
//      buffer (B, n_chunks, D, N) float32 (0.54 GB at the training shape,
//      freed by the caller);
//   2. mamba_bwd_kernel walks the chunks last to first.  Each thread holds
//      MAMBA_LANE_STATES (4) states of each of MAMBA_LANE_CHANNELS (2)
//      neighbouring channels, so a pair of channels spreads over P = N / 4
//      neighbouring lanes (mamba_common.cuh).  For each chunk it takes the
//      entering states, recomputes the chunk's states into registers (no
//      division: h_{t-1} = (h_t - u_t B_t) / a_t fails when a_t
//      underflows), then walks the chunk back carrying g, taking each
//      decay a_t again;
//   3. second passes sum the per-block partials in order: dB, dC over the
//      blocks of channels, dA, dD over the batch rows.
// In the walk, dA stays in the thread's registers until the end.  Per
// token, the dB_t, dC_t terms are summed over the thread's two channels in
// registers, then over the warp's 32 / P channel pairs by a butterfly (a
// reduce-scatter: 8 values a lane in, one out), over the block's warps in
// order through shared memory, and written as per-block partials; d_dt and
// du of the two channels are summed over the P lanes by log2 P levels of
// the same butterfly.  Each chunk's dt, x, dy rows, B, C rows and entering
// states land in shared memory by 16-byte cp.async while the chunk before
// computes, and d_dt, dx leave through shared memory as 16-byte rows.  A
// row's d_dt, dx, dB, dC depend on that row's inputs alone.  No atomics
// anywhere: every sum has one fixed order, so two runs give the same bits.
//
// What bounds it on the card: at the training shape (B 16, S 512, D 8192,
// N 16, bf16 dt/x/dy) the function reads dt, x, dy and writes d_dt, dx
// (~0.67 GB, ~0.20 ms at 3.35 TB/s), needs a_t once per state element and
// token (1.07e9 exp, ~0.26 ms on the special function units) and ~19 other
// float32 operations per state element and token (~2.0e10, ~0.30 ms at 67
// TFLOP/s): the float32 operations bound it.  This design moves ~2.1 GB
// (~0.64 ms: dt and x read twice, the chunk states written and read, the
// dB, dC partials) and takes exp three times per element (in step 1, and
// forward and back in the walk, as ex2.approx of dt * A log2 e), ~0.77 ms
// of the special function units spread over both kernels.  The walk
// issues ~21 instructions per state element and token: ~12 float32
// operations and two exps, the butterflies' shuffles, selects and adds
// (~5), and the per-token loads and conversions shared by a thread's 8
// elements.  Blocks of 256 threads within 128 registers and ~42 KB of
// shared memory run two to an SM (16 warps).  The walk issues at about
// half the SM's rate and no one unit bounds it: taking the decays again
// cost less than keeping them in shared memory (PERF.md).
#include <cstdint>
#include <initializer_list>

#include "mamba_common.cuh"

namespace {

constexpr int NT = MAMBA_BWD_THREADS, TC = MAMBA_BWD_CHUNK, L = MAMBA_LANE_STATES, CL = MAMBA_LANE_CHANNELS;
constexpr int NW = NT / 32;
constexpr float kLn2 = 0.6931471805599453f;

// P lanes per channel pair and CH channels a block at state dim N.
template <int N>
struct Lanes {
  static constexpr int P = N / L, CH = NT / P * CL;
};

// One chunk of CH channels of one batch row as it lands, zero past S and D.
template <typename T, int N, bool WITH_DY>
struct Chunk {
  static constexpr int CH = Lanes<N>::CH;
  alignas(16) T dt[TC][CH];
  alignas(16) T x[TC][CH];
  alignas(16) T dy[WITH_DY ? TC : 1][CH];
  alignas(16) float B[TC][N];
  alignas(16) float C[WITH_DY ? TC : 1][N];
};

template <typename T, int N, bool WITH_DY>
__device__ __forceinline__ void stage_chunk(Chunk<T, N, WITH_DY>& dst, const T* dt, const T* x, const T* dy,
                                            const float* Bm, const float* Cm, int b, int c, int S, int D, int d0,
                                            bool vec, int tid) {
  const int t0 = c * TC, nt = min(TC, S - t0);
  const size_t row0 = ((size_t)b * S + t0) * D, bc0 = ((size_t)b * S + t0) * N;
  stage_rows<NT, TC>(dst.dt, dt, row0, d0, nt, D, vec, tid);
  stage_rows<NT, TC>(dst.x, x, row0, d0, nt, D, vec, tid);
  stage_bc<NT, TC, N>(dst.B, Bm, bc0, nt, vec, tid);
  if constexpr (WITH_DY) {
    stage_rows<NT, TC>(dst.dy, dy, row0, d0, nt, D, vec, tid);
    stage_bc<NT, TC, N>(dst.C, Cm, bc0, nt, vec, tid);
  }
  cp_async_commit();
}

// The decays exp(dt A) of a thread's L states, from a2 = A log2 e.
static_assert(L == 4, "a thread's states of a channel travel as one float4");
__device__ __forceinline__ float4 decays(float dt, const float* a2) {
  return make_float4(exp2_approx(dt * a2[0]), exp2_approx(dt * a2[1]), exp2_approx(dt * a2[2]),
                     exp2_approx(dt * a2[3]));
}

// Step 1: the state entering each chunk, states (B, n_chunks, D, N); the
// threads hold their states as in step 2.
template <typename T, int N>
__global__ void __launch_bounds__(NT) mamba_chunk_states_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                                                                const float* __restrict__ Bm,
                                                                const float* __restrict__ A,
                                                                float* __restrict__ states, int S, int D, bool vec) {
  using G = Lanes<N>;
  using Buf = Chunk<T, N, false>;
  extern __shared__ __align__(16) unsigned char smem[];
  Buf* buf = reinterpret_cast<Buf*>(smem);
  const int tid = threadIdx.x, pair = tid / G::P, p = tid % G::P, b = blockIdx.y, d0 = blockIdx.x * G::CH;
  const int dp = d0 + CL * pair;
  float a2[CL][L], h[CL][L];
#pragma unroll
  for (int k = 0; k < CL; ++k) {
#pragma unroll
    for (int j = 0; j < L; ++j) {  // channels past D run with zeros and store nothing
      a2[k][j] = dp + k < D ? A[(size_t)(dp + k) * N + p * L + j] * kLog2e : 0.f;
      h[k][j] = 0.f;
    }
  }
  const int nc = (S + TC - 1) / TC;
  if (nc > 1) stage_chunk(buf[0], dt, x, (const T*)nullptr, Bm, (const float*)nullptr, b, 0, S, D, d0, vec, tid);
  for (int c = 0;; ++c) {
#pragma unroll
    for (int k = 0; k < CL; ++k)
      if (dp + k < D)
        *reinterpret_cast<float4*>(states + (((size_t)b * nc + c) * D + dp + k) * N + p * L) =
            make_float4(h[k][0], h[k][1], h[k][2], h[k][3]);
    if (c == nc - 1) break;  // the last chunk's own states are recomputed by step 2
    cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; chunk c - 1 is no longer read
    if (c + 1 < nc - 1)
      stage_chunk(buf[(c + 1) & 1], dt, x, (const T*)nullptr, Bm, (const float*)nullptr, b, c + 1, S, D, d0, vec,
                  tid);
    const Buf& ck = buf[c & 1];
#pragma unroll
    for (int i = 0; i < TC; ++i) {  // chunks before the last are whole
      const float2 dtv = ld2(&ck.dt[i][CL * pair]), xv = ld2(&ck.x[i][CL * pair]);
      const float4 bv = ld4(&ck.B[i][p * L]);
#pragma unroll
      for (int k = 0; k < CL; ++k) {
        const float u = at(dtv, k) * at(xv, k);
        const float4 a = decays(at(dtv, k), a2[k]);
#pragma unroll
        for (int j = 0; j < L; ++j) h[k][j] = fmaf(at(a, j), h[k][j], u * at(bv, j));
      }
    }
  }
}

// Butterfly reduce-scatter over the lanes that differ in bits O, O / 2, ..
// OMIN of the lane index: v holds M values per lane; each level halves
// them, and once one is left the levels below sum it whole.  Every
// addition has one fixed pair of operands.
template <int M, int O, int OMIN>
__device__ __forceinline__ void butterfly(float* v, int lane) {
  if constexpr (O >= OMIN) {
    if constexpr (M > 1) {
      constexpr int H = M / 2;
      const bool upper = lane & O;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float send = upper ? v[j] : v[j + H];
        const float keep = upper ? v[j + H] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      butterfly<H, O / 2, OMIN>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      butterfly<1, O / 2, OMIN>(v, lane);
    }
  }
}

template <typename T, int N>
struct BwdSmem {
  static constexpr int CH = Lanes<N>::CH;
  Chunk<T, N, true> buf[2];
  float4 h0[2][NT][CL];      // the states entering the chunk, each thread's own
  float red[NW][TC][2 * N];  // dC in [0, N), dB in [N, 2N): each warp's sums over its channels
  alignas(16) T ddt[TC][CH];
  alignas(16) T dx[TC][CH];
};

// Step 2.  Thread (pair, p) holds states p * L .. p * L + L - 1 of channels
// 2 pair and 2 pair + 1 of its block.  bc_part (B, n_blocks, S, 2N): dC
// terms in [0, N), dB terms in [N, 2N), summed over the block's channels;
// da_part (B, D, N) and dd_part (B, D): each channel's sums over its
// tokens.
template <typename T, int N>
__global__ void __launch_bounds__(NT, 2) mamba_bwd_kernel(
    const T* __restrict__ dt, const T* __restrict__ x, const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ Dv, const T* __restrict__ dy,
    const float* __restrict__ states, T* __restrict__ d_dt, T* __restrict__ dx, float* __restrict__ bc_part,
    float* __restrict__ da_part, float* __restrict__ dd_part, int S, int D, bool vec) {
  using G = Lanes<N>;
  constexpr int P = G::P, CH = G::CH;
  static_assert(CL == 2 && (P == 2 || P == 4), "lanes hold two channels, a channel spreads over 2 or 4 lanes");
  extern __shared__ __align__(16) unsigned char smem[];
  BwdSmem<T, N>& sm = *reinterpret_cast<BwdSmem<T, N>*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, pair = tid / P, p = tid % P;
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x, d0 = blk * CH, dp = d0 + CL * pair;
  bool live[CL];
  float a2[CL][L], g[CL][L], da[CL][L];
#pragma unroll
  for (int c = 0; c < CL; ++c) {
    live[c] = dp + c < D;  // channels past D run with zeros and store nothing
#pragma unroll
    for (int j = 0; j < L; ++j) {
      a2[c][j] = live[c] ? A[(size_t)(dp + c) * N + p * L + j] * kLog2e : 0.f;
      g[c][j] = da[c][j] = 0.f;
    }
  }
  // after the channel sums over the lanes below, lane p holds d_dt or du
  // of channel lc (P 4: d_dt at even p, du at odd p; P 2: both)
  const int lc = P == 4 ? p >> 1 : p;
  const float dd = dp + lc < D ? Dv[dp + lc] : 0.f;
  float dd_acc = 0.f;
  // after the butterfly lane l holds value l / 4 of its group p: the dC
  // (values 0 .. L - 1) or dB (L .. 2L - 1) term of state p * L + (l / 4) % L;
  // with P 2 the lanes that differ in bit 1 hold the same sum and one writes
  const int vi = lane >> 2, slot = (vi < L ? 0 : N - L) + p * L + vi;
  const bool writer = P == 4 || !(lane & 2);
  const int nc = (S + TC - 1) / TC;
  // the states entering chunk c land beside the chunk's rows
  auto stage = [&](int c) {
#pragma unroll
    for (int k = 0; k < CL; ++k)
      cp_async16(&sm.h0[c & 1][tid][k], states + (((size_t)b * nc + c) * D + (live[k] ? dp + k : 0)) * N + p * L,
                 live[k] ? 16 : 0);
    stage_chunk(sm.buf[c & 1], dt, x, dy, Bm, Cm, b, c, S, D, d0, vec, tid);
  };
  stage(nc - 1);
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * TC, nt = min(TC, S - t0);
    cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; chunk c + 1's rows and sums are no longer read
    if (c > 0) stage(c - 1);
    const Chunk<T, N, true>& ck = sm.buf[c & 1];
    const float4* h0 = sm.h0[c & 1][tid];
    // the chunk's states from the ones entering it (rows past S are zeros:
    // a_t = 1, u_t = 0, so a state carries through and adds nothing)
    float hs[TC][CL][L];
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      const float2 dtv = ld2(&ck.dt[i][CL * pair]), xv = ld2(&ck.x[i][CL * pair]);
      const float4 bv = ld4(&ck.B[i][p * L]);
#pragma unroll
      for (int k = 0; k < CL; ++k) {
        const float u = at(dtv, k) * at(xv, k);
        const float4 av = decays(at(dtv, k), a2[k]);
#pragma unroll
        for (int j = 0; j < L; ++j)
          hs[i][k][j] = fmaf(at(av, j), i == 0 ? at(h0[k], j) : hs[i - 1][k][j], u * at(bv, j));
      }
    }
    // back through the chunk
#pragma unroll
    for (int i = TC - 1; i >= 0; --i) {
      const float2 dtv = ld2(&ck.dt[i][CL * pair]), xv = ld2(&ck.x[i][CL * pair]), dyv = ld2(&ck.dy[i][CL * pair]);
      const float4 bv = ld4(&ck.B[i][p * L]), cv = ld4(&ck.C[i][p * L]);
      float v[2 * L], w[2 * CL];  // dC_t, dB_t terms over the two channels; d_dt, du of each
#pragma unroll
      for (int k = 0; k < CL; ++k) {
        const float dtk = at(dtv, k), dyk = at(dyv, k), u = dtk * at(xv, k);
        const float4 av = decays(dtk, a2[k]);
        float du = 0.f, sdt = 0.f;
#pragma unroll
        for (int j = 0; j < L; ++j) {
          v[j] = k == 0 ? dyk * hs[i][k][j] : fmaf(dyk, hs[i][k][j], v[j]);
          g[k][j] = fmaf(dyk, at(cv, j), g[k][j]);  // dL/dh_t
          v[L + j] = k == 0 ? g[k][j] * u : fmaf(g[k][j], u, v[L + j]);
          du = fmaf(g[k][j], at(bv, j), du);
          const float ga = g[k][j] * at(av, j);  // carried to token t - 1
          const float q = ga * (i == 0 ? at(h0[k], j) : hs[i - 1][k][j]);
          sdt = fmaf(q, a2[k][j], sdt);  // sum_n q A, in units of log2 e
          da[k][j] = fmaf(q, dtk, da[k][j]);
          g[k][j] = ga;
        }
        w[2 * k] = fmaf(at(xv, k), du, sdt * kLn2);
        w[2 * k + 1] = du;
      }
      butterfly<2 * L, 16, P>(v, lane);
      if (writer) sm.red[warp][i][slot] = v[0];
      // over the P lanes of the channel pair: lane p ends with value p of
      // w (P 4) or values 2p, 2p + 1 (P 2)
      butterfly<2 * CL, P / 2, 1>(w, lane);
      const float dtl = at(dtv, lc), dyl = at(dyv, lc);
      if (P == 2 || !(p & 1)) sm.ddt[i][CL * pair + lc] = from_float<T>(w[0]);
      if (P == 2 || (p & 1)) sm.dx[i][CL * pair + lc] = from_float<T>(fmaf(dtl, w[P == 2], dd * dyl));
      dd_acc = fmaf(dyl, at(xv, lc), dd_acc);
    }
    __syncthreads();
    for_share<NT, TC * 2 * N>(tid, [&](int j) {
      const int i = j / (2 * N), k = j % (2 * N);
      if (i >= nt) return;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) acc += sm.red[w][i][k];
      bc_part[(((size_t)b * nblk + blk) * S + t0 + i) * 2 * N + k] = acc;
    });
    const size_t row0 = ((size_t)b * S + t0) * D;
    if (vec) {
      constexpr int E = 16 / sizeof(T), U = CH / E;
      for_share<NT, 2 * TC * U>(tid, [&](int e) {
        const int which = e / (TC * U), t = e % (TC * U) / U, k = (e % U) * E;
        if (t < nt && d0 + k < D) {
          const T* src = which ? &sm.dx[t][k] : &sm.ddt[t][k];
          *reinterpret_cast<uint4*>((which ? dx : d_dt) + row0 + (size_t)t * D + d0 + k) =
              *reinterpret_cast<const uint4*>(src);
        }
      });
    } else {
      for_share<NT, TC * CH>(tid, [&](int e) {
        const int t = e / CH, k = e % CH;
        if (t < nt && d0 + k < D) {
          d_dt[row0 + (size_t)t * D + d0 + k] = sm.ddt[t][k];
          dx[row0 + (size_t)t * D + d0 + k] = sm.dx[t][k];
        }
      });
    }
  }
#pragma unroll
  for (int k = 0; k < CL; ++k)
    if (live[k])
      *reinterpret_cast<float4*>(da_part + ((size_t)b * D + dp + k) * N + p * L) =
          make_float4(da[k][0], da[k][1], da[k][2], da[k][3]);
  if ((P == 2 || !(p & 1)) && dp + lc < D) dd_part[(size_t)b * D + dp + lc] = dd_acc;
}

// Step 3.  dC[b, t, n], dB[b, t, n]: the partials of bc_part summed over
// the blocks of channels, in order.
__global__ void mamba_bc_reduce_kernel(const float* __restrict__ bc_part, float* __restrict__ dB,
                                       float* __restrict__ dC, int B, int S, int N, int nblk) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int V = 2 * N;
  if (i >= (size_t)B * S * V) return;
  const int v = i % V;
  const size_t bt = i / V, b = bt / S, t = bt % S;
  float acc = 0.f;
  for (int k = 0; k < nblk; ++k) acc += bc_part[((b * nblk + k) * S + t) * V + v];
  if (v < N)
    dC[bt * N + v] = acc;
  else
    dB[bt * N + v - N] = acc;
}

// dA[d, n] and dD[d]: the per-row partials summed over the batch, in order.
__global__ void mamba_ad_reduce_kernel(const float* __restrict__ da_part, const float* __restrict__ dd_part,
                                       float* __restrict__ dA, float* __restrict__ dD, int B, int D, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t DN = (size_t)D * N;
  if (i < DN) {
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc += da_part[b * DN + i];
    dA[i] = acc;
  } else if (i < DN + D) {
    const size_t d = i - DN;
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc += dd_part[(size_t)b * D + d];
    dD[d] = acc;
  }
}

struct Args {
  const void *dt, *x, *dy;
  const float *Bm, *Cm, *A, *Dv;
  void *d_dt, *dx;
  float *dB, *dC, *dA, *dD, *states, *bc_part, *da_part, *dd_part;
  int B, S, D;
};

template <typename T, int N>
int launch(const Args& a, cudaStream_t stream) {
  const T* dt = static_cast<const T*>(a.dt);
  const T* x = static_cast<const T*>(a.x);
  bool vec = a.D % (16 / sizeof(T)) == 0;
  for (const void* p : {a.dt, a.x, a.dy, (const void*)a.Bm, (const void*)a.Cm, (const void*)a.d_dt, (const void*)a.dx})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  using G = Lanes<N>;
  const int nblk = (a.D + G::CH - 1) / G::CH;
  constexpr int states_smem = 2 * sizeof(Chunk<T, N, false>), bwd_smem = sizeof(BwdSmem<T, N>);
  cudaError_t err = cudaFuncSetAttribute(mamba_chunk_states_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         states_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mamba_bwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nblk, a.B);
  mamba_chunk_states_kernel<T, N><<<grid, NT, states_smem, stream>>>(dt, x, a.Bm, a.A, a.states, a.S, a.D, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba_bwd_kernel<T, N><<<grid, NT, bwd_smem, stream>>>(
      dt, x, a.Bm, a.Cm, a.A, a.Dv, static_cast<const T*>(a.dy), a.states, static_cast<T*>(a.d_dt),
      static_cast<T*>(a.dx), a.bc_part, a.da_part, a.dd_part, a.S, a.D, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_bc = (size_t)a.B * a.S * 2 * N;
  mamba_bc_reduce_kernel<<<(unsigned)((n_bc + 255) / 256), 256, 0, stream>>>(a.bc_part, a.dB, a.dC, a.B, a.S, N, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_ad = (size_t)a.D * N + a.D;
  mamba_ad_reduce_kernel<<<(unsigned)((n_ad + 255) / 256), 256, 0, stream>>>(a.da_part, a.dd_part, a.dA, a.dD, a.B,
                                                                              a.D, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int N, const Args& a, cudaStream_t stream) {
  if (N == 8) return launch<T, 8>(a, stream);
  if (N == 16) return launch<T, 16>(a, stream);
  return -1;
}

// Dynamic shared memory of step 1 (which 0) or step 2 (which 1) at state
// dim N.
template <typename T>
int smem_bytes(int N, int which) {
  if (N == 8) return which ? sizeof(BwdSmem<T, 8>) : 2 * sizeof(Chunk<T, 8, false>);
  return which ? sizeof(BwdSmem<T, 16>) : 2 * sizeof(Chunk<T, 16, false>);
}

}  // namespace

extern "C" int mamba_scan_bwd_smem_bytes(int dtype, int N, int which) {
  if (!mamba_supported_state_dim(N)) return -1;
  if (dtype == kFloat32) return smem_bytes<float>(N, which);
  if (dtype == kBFloat16) return smem_bytes<__nv_bfloat16>(N, which);
  return -1;
}

// dt, x, dy (B, S, D) of dtype; Bm, Cm (B, S, N), A (D, N), Dv (D,)
// float32.  Writes d_dt, dx (B, S, D) of dtype and dB, dC (B, S, N), dA
// (D, N), dD (D,) float32.  Scratch, float32: states (B, ceil(S /
// MAMBA_BWD_CHUNK), D, N), bc_part (B, ceil(D / channels a block), S, 2N)
// with MAMBA_BWD_THREADS * MAMBA_LANE_STATES / N channels a block, da_part
// (B, D, N), dd_part (B, D).  Returns 0 or a CUDA error code (-1:
// arguments not supported).
extern "C" int mamba_scan_bwd_launch(int dtype, const void* dt, const void* x, const void* Bm, const void* Cm,
                                     const void* A, const void* Dv, const void* dy, void* d_dt, void* dx, void* dB,
                                     void* dC, void* dA, void* dD, void* states, void* bc_part, void* da_part,
                                     void* dd_part, int B, int S, int D, int N, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535 || !mamba_supported_state_dim(N)) return -1;
  Args a{dt,
         x,
         dy,
         static_cast<const float*>(Bm),
         static_cast<const float*>(Cm),
         static_cast<const float*>(A),
         static_cast<const float*>(Dv),
         d_dt,
         dx,
         static_cast<float*>(dB),
         static_cast<float*>(dC),
         static_cast<float*>(dA),
         static_cast<float*>(dD),
         static_cast<float*>(states),
         static_cast<float*>(bc_part),
         static_cast<float*>(da_part),
         static_cast<float*>(dd_part),
         B,
         S,
         D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch<float>(N, a, s);
  if (dtype == kBFloat16) return dispatch<__nv_bfloat16>(N, a, s);
  return -1;
}
