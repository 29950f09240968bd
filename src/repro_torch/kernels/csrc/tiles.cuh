// Shared-memory tile helpers for lora_matmul (both dtypes) and the float32
// route of flash_attention forward and backward (whose bf16 route runs on
// hopper.cuh's TMA and wgmma instead).  The attention kernels' mask and
// tile-skip predicates below serve both of their routes.
//
// A kernel stages tiles of its operands in shared memory and multiplies them
// with tile_mma.  For bfloat16 tiles the product runs on the tensor cores
// (WMMA 16x16x16 fragments, float32 accumulation, which the compiler lowers
// to mma.sync); for float32 tiles it runs on the CUDA cores, one thread per
// output element, so float32 inputs keep full float32 precision (the tensor
// cores would round them to TF32).  The accumulator tile lives in shared
// memory as float32, so the kernels can rescale and read it between
// products without knowing the fragments' register layout.
//
// Every shared-memory carve-out is a multiple of 128 bytes and every leading
// dimension below keeps the 32-byte row alignment that WMMA loads require.
#pragma once

#include <mma.h>

#include <cstdint>

#include "common.cuh"

// Tile sizes per element type.  bf16: 64-row tiles, four 16-row fragments
// per tile side; float32: 32-row tiles, so that the backward's float32
// buffers fit in shared memory at head_dim 128.
template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int R = 64;
};
template <>
struct Tile<float> {
  static constexpr int R = 32;
};

constexpr int TILE_THREADS = 256;  // eight warps
constexpr int MAX_D = 128;         // largest attention head dim (ops.MAX_ATTN_HEAD_DIM)
constexpr float MASKED = -1e30f;   // the TPU kernel's finite mask value
constexpr int PAD_T = 8;           // row padding of T tiles (elements)
constexpr int PAD_F = 4;           // row padding of float tiles (elements)

__host__ __device__ constexpr size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// C[M x N] (float, ldc) = (accumulate ? C : 0) + A[M x K] @ B, with A
// row-major (lda) and B row-major K x N (ldb) or, when B_COL, given as its
// transpose stored row-major N x K (ldb), e.g. a K tile for Q @ K^T.  All
// threads of the block call it; M, N and K are multiples of 16.  It ends
// without a barrier.
template <bool B_COL>
__device__ __forceinline__ void tile_mma(float* C, int ldc, const __nv_bfloat16* A, int lda,
                                         const __nv_bfloat16* B, int ldb, int M, int N, int K,
                                         bool accumulate) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int tn = N / 16;
  const int tiles = (M / 16) * tn;
  for (int t = warp; t < tiles; t += nwarps) {
    const int i0 = (t / tn) * 16;
    const int j0 = (t % tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate) {
      wmma::load_matrix_sync(acc, C + i0 * ldc + j0, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc, 0.f);
    }
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + i0 * lda + k0, lda);
      if constexpr (B_COL) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, B + j0 * ldb + k0, ldb);
        wmma::mma_sync(acc, a, b, acc);
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, B + k0 * ldb + j0, ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
    }
    wmma::store_matrix_sync(C + i0 * ldc + j0, acc, ldc, wmma::mem_row_major);
  }
}

template <bool B_COL>
__device__ __forceinline__ void tile_mma(float* C, int ldc, const float* A, int lda, const float* B,
                                         int ldb, int M, int N, int K, bool accumulate) {
  for (int e = threadIdx.x; e < M * N; e += blockDim.x) {
    const int i = e / N;
    const int j = e % N;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += A[i * lda + k] * (B_COL ? B[j * ldb + k] : B[k * ldb + j]);
    C[i * ldc + j] = accumulate ? C[i * ldc + j] + s : s;
  }
}

// Rows [0, rows) of a (rows x D) tile from rows of a global tensor spaced
// `stride` elements apart, in 16-byte vectors; rows at or past `valid` are
// zero.  D * sizeof(T) and stride * sizeof(T) are multiples of 16 and `src`
// is 16-byte aligned (the wrapper checks the shapes).
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ldd, const T* src, long long stride, int rows,
                                          int valid, int D) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = D / V;
  for (int e = threadIdx.x; e < rows * vpr; e += blockDim.x) {
    const int r = e / vpr;
    const int c = (e % vpr) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = val;
  }
}

// A (rows x cols) tile of a strided global matrix, element (i, j) at
// src[i * s0 + j * s1]; zero outside (vrows, vcols).  Neighbouring threads
// walk the source's unit-stride axis, so a transposed view loads coalesced.
template <typename T>
__device__ __forceinline__ void load_strided(T* dst, int ldd, const T* src, long long s0, long long s1,
                                             int rows, int cols, int vrows, int vcols) {
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    int i, j;
    if (s1 == 1) {
      i = e / cols;
      j = e % cols;
    } else {
      j = e / rows;
      i = e % rows;
    }
    dst[i * ldd + j] = (i < vrows && j < vcols) ? src[i * s0 + j * s1] : from_float<T>(0.f);
  }
}

// The block-level skip of the TPU kernel (flash_attention.py:55-64): a
// (q tile, kv tile) pair is computed iff some query of the q tile may see
// some key of the kv tile.  Forward and backward use the same predicate.
__device__ __forceinline__ bool tile_relevant(int q0, int k0, int bq, int bk, int causal, int window) {
  bool ok = true;
  if (causal) ok = ok && k0 <= q0 + bq - 1;
  if (window > 0) ok = ok && k0 + bk > q0 - window + 1;
  return ok;
}

// tile_relevant's kv tiles for the q tile at q0, [first, last) of the nk
// tiles of bk keys (the predicate keeps a contiguous run).
__device__ __forceinline__ void relevant_kv_tiles(int q0, int bq, int bk, int nk, int causal, int window, int& first,
                                                  int& last) {
  first = 0;
  while (first < nk && !tile_relevant(q0, first * bk, bq, bk, causal, window)) ++first;
  last = first;
  while (last < nk && tile_relevant(q0, last * bk, bq, bk, causal, window)) ++last;
}

// The same from the other side: the q tiles of bq queries, of nq, that see
// the kv tile at k0.
__device__ __forceinline__ void relevant_q_tiles(int k0, int bq, int bk, int nq, int causal, int window, int& first,
                                                 int& last) {
  first = 0;
  while (first < nq && !tile_relevant(first * bq, k0, bq, bk, causal, window)) ++first;
  last = first;
  while (last < nq && tile_relevant(last * bq, k0, bq, bk, causal, window)) ++last;
}

// Element mask: key kj is visible to query qi.
__device__ __forceinline__ bool key_visible(int qi, int kj, int S, int causal, int window) {
  bool ok = kj < S;
  if (causal) ok = ok && kj <= qi;
  if (window > 0) ok = ok && kj > qi - window;
  return ok;
}
