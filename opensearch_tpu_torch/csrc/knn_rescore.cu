// The exact fp32 rescore of a reduced-precision pool, and |q|^2, each dot
// summed in one fixed order, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference rescores a bf16 or int8 pool in
// XLA (opensearch_tpu/ops/pallas_knn.py, knn_fused's gather and einsum), and
// the port did it with a batched torch.einsum (ops/knn_fused._fused_rescore),
// whose cuBLAS summation order depends on the batch. So a query's rescored
// scores could differ in their last bits between a solo search and one the
// dispatch batcher merged, and hits within an ulp swapped places: the
// batcher's contract is results bit-identical to the unbatched path
// (tests/test_knn_batcher.py). Here every dot has one order, whatever B, R
// or the grid: lane l of a warp sums the products of elements l, l + 32,
// l + 64, ... in ascending order (__fmul_rn then __fadd_rn, no fma), then
// the 32 lane sums meet in a fixed butterfly (xor 16, 8, 4, 2, 1). The plain
// PyTorch versions (ops/knn_rescore.py) sum in that order too, so the two
// agree bit for bit on any data.
//
// Two kernels:
// - knn_query_sq_kernel: |q|^2 of each query, one warp a query; the serving
//   step's scan and the rescore both read it, so the fp32 scan's scores do
//   not depend on the batch either (PyTorch's row sum picks its reduction
//   by shape).
// - knn_rescore_kernel: one 256-thread CTA a (32 candidates, query,
//   shard), so even one query's R = 400 spreads over 13 SMs; the query in
//   shared memory, one warp a candidate: the candidate's row gathered from
//   the slab (coalesced: lane l reads elements l, l + 32, ...), the dot, the
//   l2 / cosine / dot transform of knn_score.cuh (the scans' own), and
//   -inf where the candidate id is -1 or its doc is dead. With sim =
//   kRawDots it writes the dot alone (0 for a -1 id): the IVF-PQ route's
//   exact rescore (ops/ivfpq.exact_rescore) keeps the reference's own
//   transform, whose cosine clamps the product of the norms, and takes
//   only its dots from here.
//
// Bound: each candidate row read once (4 R d bytes a (shard, query)), its
// norm and flag, the candidate ids and the scores written: at R = 40 and
// d = 128 about 21 KB a query, well under a microsecond at 3.35 TB/s; the
// launch itself costs more. The gather reads rows in no order, so the rows
// come from device memory in 128-byte lines (d = 128: four a row).

#include <stdint.h>

#include "knn_score.cuh"

namespace {
namespace rescore {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerCta = 32;  // candidates a rescore CTA: four a warp
constexpr int kRawDots = 3;  // the `sim` that writes the dots untransformed

// x summed over the warp's lanes in the fixed butterfly; every lane gets
// the same bits (each step adds a pair in both lanes, and f32 addition
// commutes)
__device__ __forceinline__ float warp_tree(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// grid ceil(B / 8); one warp a query: out[b] = |q_b|^2
__global__ void __launch_bounds__(kThreads) knn_query_sq_kernel(
    const float* __restrict__ q, float* __restrict__ out, int B, int d) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const float* qb = q + (size_t)b * d;
  float acc = 0.0f;
  for (int e = lane; e < d; e += 32) acc = __fadd_rn(acc, __fmul_rn(qb[e], qb[e]));
  acc = warp_tree(acc);
  if (lane == 0) out[b] = acc;
}

// grid (ceil(R / kPerCta), B, S); dynamic shared memory 4d bytes.
// out[s, b, j] = the transformed fp32 score of candidate cand[s, b, j] of
// shard s against query b, -inf where the id is negative or the doc is
// dead; at sim = kRawDots the dot itself, 0 where the id is negative (qsq,
// nsq and valid unread); CTA x takes candidates [x * kPerCta,
// (x + 1) * kPerCta).
__global__ void __launch_bounds__(kThreads) knn_rescore_kernel(
    const float* __restrict__ q,        // [B, d]
    const float* __restrict__ qsq,      // [B]
    const float* __restrict__ v,        // [S, n, d]
    const float* __restrict__ nsq,      // [S, n]
    const uint8_t* __restrict__ valid,  // [S, n] 0 / 1
    const int* __restrict__ cand,       // [S, B, R]
    float* __restrict__ out,            // [S, B, R]
    int n, int d, int B, int R, int sim) {
  const int b = blockIdx.y, s = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kPerCta;
  const int j1 = min(R, j0 + kPerCta);
  extern __shared__ float rescore_q[];  // [d]
  for (int e = threadIdx.x; e < d; e += kThreads)
    rescore_q[e] = q[(size_t)b * d + e];
  __syncthreads();
  const bool raw = sim == kRawDots;
  const float qq = raw ? 0.0f : qsq[b];
  const size_t row = (size_t)s * B + b;
  for (int j = j0 + warp; j < j1; j += kWarps) {
    const int c = cand[row * R + j];  // the same in every lane
    float score = raw ? 0.0f : -INFINITY;
    if (c >= 0 && c < n) {
      const size_t doc = (size_t)s * n + c;
      const float* vr = v + doc * d;
      float acc = 0.0f;
      for (int e = lane; e < d; e += 32)
        acc = __fadd_rn(acc, __fmul_rn(rescore_q[e], vr[e]));
      acc = warp_tree(acc);
      if (raw)
        score = acc;
      else if (valid[doc])
        score = transform_score(acc, qq, nsq[doc], sim);
    }
    if (lane == 0) out[row * R + j] = score;
  }
}

}  // namespace rescore
}  // namespace

extern "C" {

// |q|^2 of B rows of d floats on `stream`. Returns the cudaError_t met.
int knn_query_sq_launch(const void* q, void* out, int B, int d,
                        void* stream) {
  if (B < 1 || d < 1) return (int)cudaErrorInvalidValue;
  rescore::knn_query_sq_kernel<<<(B + rescore::kWarps - 1) / rescore::kWarps,
                                 rescore::kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<float*>(out), B, d);
  return (int)cudaGetLastError();
}

// The rescore of cand [S, B, R] on `stream`. Returns the cudaError_t met.
int knn_rescore_launch(const void* q, const void* qsq, const void* v,
                       const void* nsq, const void* valid, const void* cand,
                       void* out, int S, int n, int d, int B, int R, int sim,
                       void* stream) {
  if (S < 1 || B < 1 || R < 1 || d < 1 || S > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)d;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rescore::knn_rescore_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((R + rescore::kPerCta - 1) / rescore::kPerCta, B, S);
  rescore::knn_rescore_kernel<<<grid, rescore::kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(qsq),
      static_cast<const float*>(v), static_cast<const float*>(nsq),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(cand),
      static_cast<float*>(out), n, d, B, R, sim);
  return (int)cudaGetLastError();
}

}  // extern "C"
