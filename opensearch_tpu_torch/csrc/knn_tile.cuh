// Device code shared by the exact-kNN kernels (knn_fused.cu K1, knn_block.cu
// K3, knn_pb.cu K4, knn_sbmax.cu K5): the (score desc, doc id asc) key, the
// staging and scoring of one [kQB queries x kTD docs] tile, and the running
// top-R pool scan with its split merge (K1 and K3).
//
// Scores are the k-NN plugin score space (knn_score.cuh's transforms).
// Dots: fp32 on FFMA (never TF32); bf16 operands (stored as bf16, or stored
// as f32 and rounded to bf16 on load) widened to f32 and summed in f32, where
// every product is exact; int8 through __dp4a into int32 (exact), then one
// multiply by the per-shard dequant scale.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "knn_score.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQB = 16;   // query rows per CTA
constexpr int kTD = 64;   // doc rows per shared-memory tile
constexpr int kQPT = kQB * kTD / kThreads;  // queries per thread (4)
constexpr int kGroups = kThreads / kTD;     // query groups per tile (4)

// operand storage: f32, bf16, int8, or f32 rounded to bf16 as it is loaded
enum { PREC_FP32 = 0, PREC_BF16 = 1, PREC_INT8 = 2, PREC_FP32_AS_BF16 = 3 };

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

template <int PREC>
__device__ __forceinline__ float load_as_float(const void* p, size_t i) {
  if (PREC == PREC_BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  if (PREC == PREC_FP32_AS_BF16) {
    return __bfloat162float(
        __float2bfloat16_rn(static_cast<const float*>(p)[i]));
  }
  return static_cast<const float*>(p)[i];
}

__host__ __device__ inline int row_words(int prec, int d) {
  return prec == PREC_INT8 ? (d + 3) / 4 : d;
}

// Stage query rows [q0, q0 + qb) into qs ([kQB][W] words); rows past qb are
// zero.
template <int PREC>
__device__ void load_query_tile(uint32_t* qs, const void* q, int q0, int qb,
                                int d, int W) {
  const int tid = threadIdx.x;
  if (PREC == PREC_INT8) {
    int8_t* q8 = reinterpret_cast<int8_t*>(qs);
    const int8_t* src = static_cast<const int8_t*>(q);
    for (int e = tid; e < kQB * W * 4; e += kThreads) {
      const int row = e / (W * 4), c = e - row * W * 4;
      q8[e] = (row < qb && c < d) ? src[(size_t)(q0 + row) * d + c] : 0;
    }
  } else {
    float* qf = reinterpret_cast<float*>(qs);
    for (int e = tid; e < kQB * d; e += kThreads) {
      const int row = e / d;
      qf[e] = row < qb ? load_as_float<PREC>(q, (size_t)q0 * d + e) : 0.0f;
    }
  }
}

// Stage doc rows [j0, j0 + rows) of the slab at vbase into vs ([kTD][W + 1]
// words: one word of padding a row, so the per-doc dot loop reads distinct
// banks).
template <int PREC>
__device__ void load_doc_tile(uint32_t* vs, const void* v, size_t vbase,
                              int j0, int rows, int d, int W) {
  const int tid = threadIdx.x;
  const int vstride = W + 1;
  if (PREC == PREC_INT8) {
    int8_t* v8 = reinterpret_cast<int8_t*>(vs);
    const int8_t* src = static_cast<const int8_t*>(v);
    for (int e = tid; e < rows * W * 4; e += kThreads) {
      const int row = e / (W * 4), c = e - row * W * 4;
      v8[row * vstride * 4 + c] =
          c < d ? src[vbase + (size_t)(j0 + row) * d + c] : 0;
    }
  } else {
    float* vf = reinterpret_cast<float*>(vs);
    for (int e = tid; e < rows * d; e += kThreads) {
      const int row = e / d, c = e - row * d;
      vf[row * vstride + c] = load_as_float<PREC>(v, vbase + (size_t)j0 * d + e);
    }
  }
}

// Score the staged tile: sc[qi * stride + j] for qi < kQB, j < kTD, with
// -inf for dead docs, for rows past `rows` and for query rows past qb. Each
// thread reuses one doc value for kQPT queries.
template <int PREC>
__device__ void score_tile(float* sc, int stride, const uint32_t* qs,
                           const uint32_t* vs, const float* nsq,
                           const uint8_t* valid, const float* qsq,
                           size_t nbase, int q0, int qb, int j0, int rows,
                           int d, int W, float sc_s, int sim) {
  const int tid = threadIdx.x;
  const int j = tid & (kTD - 1);
  const int g = tid / kTD;
  const int vstride = W + 1;
  if (j >= rows) {
#pragma unroll
    for (int u = 0; u < kQPT; ++u) sc[(g + u * kGroups) * stride + j] = -INFINITY;
    return;
  }
  float dots[kQPT];
  if (PREC == PREC_INT8) {
    int acc[kQPT];
#pragma unroll
    for (int u = 0; u < kQPT; ++u) acc[u] = 0;
    const int* vrow = reinterpret_cast<const int*>(vs) + j * vstride;
    const int* qrow = reinterpret_cast<const int*>(qs);
    for (int w = 0; w < W; ++w) {
      const int x = vrow[w];
#pragma unroll
      for (int u = 0; u < kQPT; ++u)
        acc[u] = __dp4a(x, qrow[(g + u * kGroups) * W + w], acc[u]);
    }
#pragma unroll
    for (int u = 0; u < kQPT; ++u)
      dots[u] = __fmul_rn(__int2float_rn(acc[u]), sc_s);
  } else {
#pragma unroll
    for (int u = 0; u < kQPT; ++u) dots[u] = 0.0f;
    const float* vrow = reinterpret_cast<const float*>(vs) + j * vstride;
    const float* qrow = reinterpret_cast<const float*>(qs);
    for (int k = 0; k < d; ++k) {
      const float x = vrow[k];
#pragma unroll
      for (int u = 0; u < kQPT; ++u)
        dots[u] = __fmaf_rn(x, qrow[(g + u * kGroups) * d + k], dots[u]);
    }
  }
  const int doc = j0 + j;
  const float ns = nsq[nbase + doc];
  const bool ok = valid[nbase + doc] != 0;
#pragma unroll
  for (int u = 0; u < kQPT; ++u) {
    const int qi = g + u * kGroups;
    sc[qi * stride + j] = (ok && qi < qb)
        ? transform_score(dots[u], qsq[q0 + qi], ns, sim) : -INFINITY;
  }
}

// Insert (cv, ci) into a pool sorted best-first; the caller has checked that
// it beats the last entry. All 32 lanes of the warp call this together.
__device__ void warp_insert(float* pv, int* pi, int r, float cv, int ci,
                            int lane) {
  int cnt = 0;
  for (int i = lane; i < r; i += 32) cnt += better(pv[i], pi[i], cv, ci);
  for (int o = 16; o; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
  const int p = cnt;
  // shift [p, r-2] down one slot, highest chunk first: a chunk reads the
  // slot below its own range, which the next (lower) chunk writes later
  for (int base = ((r - 1) / 32) * 32; base >= (p & ~31); base -= 32) {
    const int i = base + lane;
    const bool mv = i > p && i < r;
    float tv = 0.0f;
    int ti = 0;
    if (mv) {
      tv = pv[i - 1];
      ti = pi[i - 1];
    }
    __syncwarp();
    if (mv) {
      pv[i] = tv;
      pi[i] = ti;
    }
    __syncwarp();
  }
  if (lane == 0) {
    pv[p] = cv;
    pi[p] = ci;
  }
  __syncwarp();
}

// bytes of dynamic shared memory one pool-scan CTA needs
__host__ inline size_t scan_smem_bytes(int prec, int d, int r) {
  const size_t W = (size_t)row_words(prec, d);
  return 4 * (kQB * W + kTD * (W + 1) + (size_t)kQB * kTD + 2 * (size_t)kQB * r);
}

// The pool scan (K1, and K3 at fp32): grid (n_split, S, ceil(B / kQB)). Each
// CTA streams kTD-doc tiles of its split [split * chunk, +chunk) and keeps a
// sorted top-r pool per query in shared memory; a doc enters only if its key
// beats the pool's r-th entry (the kth-best early exit), so once the pool is
// warm almost every tile costs one compare per (query, doc). Insertion is
// warp-parallel. Only the [S, n_split, B, r] partial pools reach device
// memory.
template <int PREC>
__global__ void __launch_bounds__(kThreads) knn_scan_kernel(
    const void* __restrict__ v,          // [S, n, d] f32 / bf16 / int8
    const float* __restrict__ nsq,       // [S, n]
    const uint8_t* __restrict__ valid,   // [S, n] 0 / 1
    const void* __restrict__ q,          // [B, d], dtype of v
    const float* __restrict__ qsq,       // [B] from the original f32 queries
    const float* __restrict__ scale,     // [S] int8 dequant scale
    float* __restrict__ part_v,          // [S, n_split, B, r]
    int* __restrict__ part_i,
    int n, int d, int B, int r, int sim, int chunk, int n_split) {
  const int split = blockIdx.x, s = blockIdx.y;
  const int q0 = blockIdx.z * kQB;
  const int qb = min(kQB, B - q0);
  const int start = split * chunk;
  const int end = min(n, start + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int W = row_words(PREC, d);
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qs = smem;                              // [kQB][W]
  uint32_t* vs = qs + kQB * W;                      // [kTD][W + 1]
  float* sc = reinterpret_cast<float*>(vs + kTD * (W + 1));  // [kQB][kTD]
  float* pv = sc + kQB * kTD;                       // [kQB][r]
  int* pi = reinterpret_cast<int*>(pv + kQB * r);   // [kQB][r]

  load_query_tile<PREC>(qs, q, q0, qb, d, W);
  for (int e = tid; e < kQB * r; e += kThreads) {
    pv[e] = -INFINITY;
    pi[e] = -1;
  }
  const size_t vbase = (size_t)s * n * d;
  const size_t nbase = (size_t)s * n;
  const float sc_s = PREC == PREC_INT8 ? scale[s] : 1.0f;
  __syncthreads();

  for (int j0 = start; j0 < end; j0 += kTD) {
    const int rows = min(kTD, end - j0);
    load_doc_tile<PREC>(vs, v, vbase, j0, rows, d, W);
    __syncthreads();
    score_tile<PREC>(sc, kTD, qs, vs, nsq, valid, qsq, nbase, q0, qb, j0,
                     rows, d, W, sc_s, sim);
    __syncthreads();

    for (int qi = warp; qi < qb; qi += kThreads / 32) {
      float* qpv = pv + qi * r;
      int* qpi = pi + qi * r;
      for (int base = 0; base < rows; base += 32) {
        const int jj = base + lane;
        const float sv = jj < rows ? sc[qi * kTD + jj] : -INFINITY;
        const int id = j0 + jj;
        const bool cand =
            sv > -INFINITY && better(sv, id, qpv[r - 1], qpi[r - 1]);
        unsigned mask = __ballot_sync(kFull, cand);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float cv = __shfl_sync(kFull, sv, src);
          const int ci = __shfl_sync(kFull, id, src);
          // the pool moved since the ballot: re-check (uniform per warp)
          if (better(cv, ci, qpv[r - 1], qpi[r - 1]))
            warp_insert(qpv, qpi, r, cv, ci, lane);
        }
      }
    }
    __syncthreads();
  }

  const size_t obase = (((size_t)s * n_split + split) * B + q0) * r;
  for (int e = tid; e < qb * r; e += kThreads) {
    part_v[obase + e] = pv[e];
    part_i[obase + e] = pi[e];
  }
}

// grid (B, S), one warp: merge the n_split sorted partial pools of one
// (shard, query) into its top r under (score desc, doc id asc)
__global__ void __launch_bounds__(32) knn_merge_kernel(
    const float* __restrict__ part_v, const int* __restrict__ part_i,
    float* __restrict__ out_v, int* __restrict__ out_i,
    int n_split, int B, int r) {
  const int b = blockIdx.x, s = blockIdx.y, lane = threadIdx.x;
  extern __shared__ int heads[];
  for (int p = lane; p < n_split; p += 32) heads[p] = 0;
  __syncwarp();
  const size_t obase = ((size_t)s * B + b) * r;
  for (int t = 0; t < r; ++t) {
    float bv = -INFINITY;
    int bi = -1, bp = -1;
    for (int p = lane; p < n_split; p += 32) {
      const int h = heads[p];
      if (h < r) {
        const size_t off = (((size_t)s * n_split + p) * B + b) * r + h;
        const float v = part_v[off];
        const int id = part_i[off];
        if (bp < 0 || better(v, id, bv, bi)) {
          bv = v;
          bi = id;
          bp = p;
        }
      }
    }
    for (int o = 16; o; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      const int op = __shfl_xor_sync(kFull, bp, o);
      const bool take = op >= 0 && (bp < 0 || better(ov, oi, bv, bi) ||
                                    (!better(bv, bi, ov, oi) && op < bp));
      if (take) {
        bv = ov;
        bi = oi;
        bp = op;
      }
    }
    if (lane == 0) {
      const bool hit = bp >= 0 && bv > -INFINITY;
      out_v[obase + t] = hit ? bv : -INFINITY;
      out_i[obase + t] = hit ? bi : -1;
      if (bp >= 0) heads[bp] += 1;
    }
    __syncwarp();
  }
}

// Pool scan then split merge on `st`; returns the first cudaError_t met.
template <int PREC>
cudaError_t launch_pool_scan(cudaStream_t st, const void* v, const float* nsq,
                             const uint8_t* valid, const void* q,
                             const float* qsq, const float* scale,
                             float* part_v, int* part_i, float* out_v,
                             int* out_i, int S, int n, int d, int B, int r,
                             int sim, int chunk, int n_split) {
  const size_t smem = scan_smem_bytes(PREC, d, r);
  cudaError_t e = cudaFuncSetAttribute(
      knn_scan_kernel<PREC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_split, S, (B + kQB - 1) / kQB);
  knn_scan_kernel<PREC><<<grid, kThreads, smem, st>>>(
      v, nsq, valid, q, qsq, scale, part_v, part_i, n, d, B, r, sim, chunk,
      n_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  knn_merge_kernel<<<dim3(B, S), 32, n_split * sizeof(int), st>>>(
      part_v, part_i, out_v, out_i, n_split, B, r);
  return cudaGetLastError();
}

}  // namespace
