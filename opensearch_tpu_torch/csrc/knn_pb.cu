// Exact per-block top-k, for Hopper (sm_90a): K4, stage 1.
//
// Replaces: opensearch_tpu/ops/pallas_knn.py::_knn_pb_kernel (launched by
// pallas_knn_blocktopk). Same contract: for every 2048-doc block and query,
// that block's own k best docs, best first, by k extract-max rounds in which
// the first maximum wins (so ties go to the lower doc id), written
// block-major as [nb, B, k]. Once a block has no live doc left a round yields
// -inf and the block's first doc id (the TPU kernel's argmax of an all -inf
// row); the wrapper's stable merge over [B, nb * k] turns those into -1.
// exact = 1 scores in fp32 (the TPU's HIGHEST); exact = 0 rounds both
// operands to bf16 as they are loaded and sums the exact products in f32
// (the TPU's one bf16 MXU pass), never TF32.
//
// Bound: the slab once (4nd bytes), norms and valid flags (5n), the
// [nb, B, k] winners out (8nbBk) and 2*B*n*d operations: bytes at small B,
// operations from about B = 80 at d = 128 (67 TFLOP/s of f32 against
// 3.35 TB/s).
//
// Design: the TPU kernel holds a [128, 2048] f32 score tile (1 MB) in VMEM;
// shared memory holds 227 KB, so a CTA takes a 16-query tile instead and
// keeps its [16, 2048] scores (128 KB) in shared memory. The grid is
// (query tiles, doc blocks) with the query tile fastest, so the CTAs that
// read one doc block run together and share it through L2. Scoring streams
// 64-doc tiles with coalesced loads (knn_tile.cuh, as K1). Selection: each
// warp owns two queries; each lane caches the best of its 64 strided columns,
// a round reduces the 32 cached bests by (score desc, column asc) and only
// the winning lane rescans its columns. Rows past n score -inf: the
// wrapper's padding of n to a 2048-doc block is arithmetic only.
// Not yet used: wgmma, TMA, cp.async pipelining.

#include "knn_tile.cuh"

namespace {

constexpr int kBlock = 2048;  // PB_BLOCK
constexpr int kWarps = kThreads / 32;

__host__ inline size_t pb_smem_bytes(int d) {
  return 4 * ((size_t)kQB * d + (size_t)kTD * (d + 1) + (size_t)kQB * kBlock);
}

// the best (score, column) of this lane's columns lane, lane + 32, ...;
// (-inf, lane) when all are -inf: the first column among equals
__device__ __forceinline__ void lane_best(const float* row, int lane,
                                          float& bv, int& bc) {
  bv = -INFINITY;
  bc = lane;
  for (int c = lane; c < kBlock; c += 32) {
    const float x = row[c];
    if (x > bv) {
      bv = x;
      bc = c;
    }
  }
}

// grid (ceil(B / kQB), nb); dynamic shared memory pb_smem_bytes(d)
template <int PREC>
__global__ void __launch_bounds__(kThreads) knn_pb_kernel(
    const float* __restrict__ v,         // [n, d] f32
    const float* __restrict__ nsq,       // [n]
    const uint8_t* __restrict__ valid,   // [n] 0 / 1
    const float* __restrict__ q,         // [B, d] f32
    const float* __restrict__ qsq,       // [B]
    float* __restrict__ out_v,           // [nb, B, k]
    int* __restrict__ out_i,
    int n, int d, int B, int k, int sim) {
  const int q0 = blockIdx.x * kQB, blk = blockIdx.y;
  const int qb = min(kQB, B - q0);
  const int base = blk * kBlock;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qs = smem;                              // [kQB][d]
  uint32_t* vs = qs + kQB * d;                      // [kTD][d + 1]
  float* sc = reinterpret_cast<float*>(vs + kTD * (d + 1));  // [kQB][kBlock]

  load_query_tile<PREC>(qs, q, q0, qb, d, d);
  __syncthreads();
  for (int t = 0; t < kBlock; t += kTD) {
    const int j0 = base + t;
    const int rows = max(0, min(kTD, n - j0));
    if (rows > 0) load_doc_tile<PREC>(vs, v, 0, j0, rows, d, d);
    __syncthreads();
    score_tile<PREC>(sc + t, kBlock, qs, vs, nsq, valid, qsq, 0, q0, qb, j0,
                     rows, d, d, 1.0f, sim);
    __syncthreads();
  }

  for (int qi = warp; qi < qb; qi += kWarps) {
    float* row = sc + qi * kBlock;
    const size_t obase = ((size_t)blk * B + q0 + qi) * k;
    float bv;
    int bc;
    lane_best(row, lane, bv, bc);
    for (int i = 0; i < k; ++i) {
      float wv = bv;
      int wc = bc;
      for (int o = 16; o; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, wv, o);
        const int oc = __shfl_xor_sync(kFull, wc, o);
        if (better(ov, oc, wv, wc)) {
          wv = ov;
          wc = oc;
        }
      }
      if (lane == 0) {
        out_v[obase + i] = wv;
        out_i[obase + i] = base + wc;
      }
      if ((wc & 31) == lane) {
        row[wc] = -INFINITY;
        lane_best(row, lane, bv, bc);
      }
    }
  }
}

template <int PREC>
cudaError_t launch_pb(cudaStream_t st, const float* v, const float* nsq,
                      const uint8_t* valid, const float* q, const float* qsq,
                      float* out_v, int* out_i, int n, int d, int B, int k,
                      int nb, int sim) {
  const size_t smem = pb_smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(
      knn_pb_kernel<PREC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + kQB - 1) / kQB, nb);
  knn_pb_kernel<PREC><<<grid, kThreads, smem, st>>>(v, nsq, valid, q, qsq,
                                                    out_v, out_i, n, d, B, k,
                                                    sim);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory one CTA needs at width d
size_t knn_pb_smem_bytes(int d) { return pb_smem_bytes(d); }

// Stage 1 on `stream`: (vals, ids) [nb, B, k]. Returns the first cudaError_t
// met (0 = launched).
int knn_pb_launch(const void* v, const void* nsq, const void* valid,
                  const void* q, const void* qsq, void* out_v, void* out_i,
                  int n, int d, int B, int k, int nb, int sim, int exact,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vf = static_cast<const float*>(v);
  const float* nf = static_cast<const float*>(nsq);
  const uint8_t* ok = static_cast<const uint8_t*>(valid);
  const float* qf = static_cast<const float*>(q);
  const float* qsqf = static_cast<const float*>(qsq);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  const cudaError_t e =
      exact ? launch_pb<PREC_FP32>(st, vf, nf, ok, qf, qsqf, ov, oi, n, d, B,
                                   k, nb, sim)
            : launch_pb<PREC_FP32_AS_BF16>(st, vf, nf, ok, qf, qsqf, ov, oi,
                                           n, d, B, k, nb, sim);
  return (int)e;
}

}  // extern "C"
