// Sub-block maxima of exact kNN scores, for Hopper (sm_90a): K5, stage 1.
//
// Replaces: opensearch_tpu/ops/pallas_knn.py::_knn_sbmax_kernel (launched by
// pallas_knn_sbmax_topk). Same contract: for every 2048-doc block and query,
// the maximum score of each of its sixteen 128-doc sub-blocks, as
// [nb, B, 16]; dead docs score -inf, so an all-dead sub-block reports -inf.
// The wrapper picks the k sub-blocks with the largest maxima and rescores
// their docs exactly. exact = 1 scores in fp32 (the TPU's HIGHEST); exact = 0
// rounds both operands to bf16 as they are loaded and sums the exact
// products in f32 (the TPU's one bf16 MXU pass), never TF32.
//
// Bound: the slab once (4nd bytes), norms and valid flags (5n), the maxima
// out (4 * n_pad * B / 128) and 2*B*n*d operations: bytes at small B,
// operations from about B = 80 at d = 128.
//
// Design: grid (query tiles, doc blocks) with the query tile fastest, so the
// CTAs reading one doc block run together and share it through L2; a CTA
// scores 16 queries against its block in 64-doc tiles (knn_tile.cuh, as
// K1), and each warp reduces two queries' tile scores to a maximum with
// shuffles, folded into a [16, 16] table in shared memory. Only the maxima
// reach device memory. A maximum is exact, so the kernel and the plain
// version differ only by the order in which each dot sums its d products.
// Rows past n score -inf: the wrapper's padding of n to a 2048-doc block is
// arithmetic only. Not yet used: wgmma, TMA, cp.async pipelining.

#include "knn_tile.cuh"

namespace {

constexpr int kBlock = 2048;  // PB_BLOCK
constexpr int kSub = 128;     // SUB
constexpr int kSubs = kBlock / kSub;
constexpr int kWarps = kThreads / 32;

__host__ inline size_t sbmax_smem_bytes(int d) {
  return 4 * ((size_t)kQB * d + (size_t)kTD * (d + 1) + (size_t)kQB * kTD +
              (size_t)kQB * kSubs);
}

// grid (ceil(B / kQB), nb); dynamic shared memory sbmax_smem_bytes(d)
template <int PREC>
__global__ void __launch_bounds__(kThreads) knn_sbmax_kernel(
    const float* __restrict__ v,         // [n, d] f32
    const float* __restrict__ nsq,       // [n]
    const uint8_t* __restrict__ valid,   // [n] 0 / 1
    const float* __restrict__ q,         // [B, d] f32
    const float* __restrict__ qsq,       // [B]
    float* __restrict__ out,             // [nb, B, kSubs]
    int n, int d, int B, int sim) {
  const int q0 = blockIdx.x * kQB, blk = blockIdx.y;
  const int qb = min(kQB, B - q0);
  const int base = blk * kBlock;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qs = smem;                              // [kQB][d]
  uint32_t* vs = qs + kQB * d;                      // [kTD][d + 1]
  float* sc = reinterpret_cast<float*>(vs + kTD * (d + 1));  // [kQB][kTD]
  float* sbm = sc + kQB * kTD;                      // [kQB][kSubs]

  load_query_tile<PREC>(qs, q, q0, qb, d, d);
  for (int e = tid; e < kQB * kSubs; e += kThreads) sbm[e] = -INFINITY;
  __syncthreads();
  for (int t = 0; t < kBlock; t += kTD) {
    const int j0 = base + t;
    const int rows = max(0, min(kTD, n - j0));
    if (rows > 0) load_doc_tile<PREC>(vs, v, 0, j0, rows, d, d);
    __syncthreads();
    score_tile<PREC>(sc, kTD, qs, vs, nsq, valid, qsq, 0, q0, qb, j0, rows,
                     d, d, 1.0f, sim);
    __syncthreads();
    for (int qi = warp; qi < kQB; qi += kWarps) {
      float m = fmaxf(sc[qi * kTD + lane], sc[qi * kTD + lane + 32]);
      for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
      if (lane == 0) {
        float* cell = sbm + qi * kSubs + t / kSub;
        *cell = fmaxf(*cell, m);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < qb * kSubs; e += kThreads)
    out[((size_t)blk * B + q0) * kSubs + e] = sbm[e];
}

template <int PREC>
cudaError_t launch_sbmax(cudaStream_t st, const float* v, const float* nsq,
                         const uint8_t* valid, const float* q,
                         const float* qsq, float* out, int n, int d, int B,
                         int nb, int sim) {
  const size_t smem = sbmax_smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(
      knn_sbmax_kernel<PREC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + kQB - 1) / kQB, nb);
  knn_sbmax_kernel<PREC><<<grid, kThreads, smem, st>>>(v, nsq, valid, q, qsq,
                                                       out, n, d, B, sim);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory one CTA needs at width d
size_t knn_sbmax_smem_bytes(int d) { return sbmax_smem_bytes(d); }

// Stage 1 on `stream`: maxima [nb, B, 16]. Returns the first cudaError_t met
// (0 = launched).
int knn_sbmax_launch(const void* v, const void* nsq, const void* valid,
                     const void* q, const void* qsq, void* out, int n, int d,
                     int B, int nb, int sim, int exact, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vf = static_cast<const float*>(v);
  const float* nf = static_cast<const float*>(nsq);
  const uint8_t* ok = static_cast<const uint8_t*>(valid);
  const float* qf = static_cast<const float*>(q);
  const float* qsqf = static_cast<const float*>(qsq);
  float* of = static_cast<float*>(out);
  const cudaError_t e =
      exact ? launch_sbmax<PREC_FP32>(st, vf, nf, ok, qf, qsqf, of, n, d, B,
                                      nb, sim)
            : launch_sbmax<PREC_FP32_AS_BF16>(st, vf, nf, ok, qf, qsqf, of, n,
                                              d, B, nb, sim);
  return (int)e;
}

}  // extern "C"
