// The IVF-PQ residual lookup tables, each sum in one fixed order, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference builds the LUTs in XLA
// (opensearch_tpu/ops/ivfpq.py lut_for_probes, reached from
// opensearch_tpu/ops/pallas_adc.py build_luts), and the port did it with a
// batched torch.einsum and row sums whose cuBLAS and reduction orders
// depend on the batch. So a query's LUT, and with it the ADC scan's
// candidates and the rescored scores, could differ in their last bits
// between a solo search and one the dispatch batcher merged: the batcher's
// contract is results bit-identical to the unbatched path. Here every
// entry has one order, whatever B, P or the grid:
//   lut[b, p, j, c] = (|r|^2 - 2 r.cb[j, c]) + |cb[j, c]|^2
// with r = q[b, j-th dsub slice] - coarse[probes[b, p], same slice] (one
// __fsub_rn an element), and each of |r|^2, r.cb and |cb|^2 summed over the
// dsub elements in ascending order from 0 (__fmul_rn then __fadd_rn, no
// fma). The plain PyTorch version (ops/adc_lut.plain_lut) adds in that
// order with elementwise operations, so the two agree bit for bit.
//
// One kernel, adc_lut_kernel: one 256-thread CTA a (probe, query); the
// residual of the probed list (d floats) and its m sub-norms in shared
// memory; each thread then computes entries e = j * ks + c, consecutive
// threads on consecutive entries, so the stores of the [m, ks] table are
// coalesced. |cb|^2 is recomputed a CTA (dsub more multiply-adds an entry)
// rather than kept a second time on the device.
//
// Bound: the queries and each probed list's centroid read once (4 B P d
// bytes at most), the codebooks once (4 m ks dsub = 4 ks d bytes: 100 KB
// at glove-100's d = 100, ks = 256, in L2 for every CTA after the first),
// the LUTs written (4 B P m ks bytes: 164 KB a query at m = 20, P = 8),
// against 2 B P m ks dsub operations: bytes at every serving shape, well
// under a microsecond; the launch costs more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace adc_lut {

constexpr int kThreads = 256;

// grid (P, B); dynamic shared memory 4 (d + m) bytes. Writes the [m, ks]
// table of probe p of query b to lut[b, p].
__global__ void __launch_bounds__(kThreads) adc_lut_kernel(
    const float* __restrict__ q,       // [B, d]
    const float* __restrict__ coarse,  // [nlist, d]
    const float* __restrict__ cb,      // [m, ks, dsub]
    const int* __restrict__ probes,    // [B, P]
    float* __restrict__ lut,           // [B, P, m, ks]
    int P, int d, int m, int ks, int dsub) {
  const int p = blockIdx.x, b = blockIdx.y;
  extern __shared__ float lut_smem[];
  float* res = lut_smem;      // [d] the residual
  float* rsq = lut_smem + d;  // [m] its sub-norms
  const float* cq = coarse + (size_t)probes[(size_t)b * P + p] * d;
  for (int e = threadIdx.x; e < d; e += kThreads)
    res[e] = __fsub_rn(q[(size_t)b * d + e], cq[e]);
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float* r = res + j * dsub;
    float acc = 0.0f;
    for (int s = 0; s < dsub; ++s) acc = __fadd_rn(acc, __fmul_rn(r[s], r[s]));
    rsq[j] = acc;
  }
  __syncthreads();
  float* out = lut + ((size_t)b * P + p) * m * ks;
  for (int e = threadIdx.x; e < m * ks; e += kThreads) {
    const int j = e / ks;
    const float* r = res + j * dsub;
    const float* c = cb + (size_t)e * dsub;
    float dot = 0.0f, csq = 0.0f;
    for (int s = 0; s < dsub; ++s) {
      const float x = c[s];
      dot = __fadd_rn(dot, __fmul_rn(r[s], x));
      csq = __fadd_rn(csq, __fmul_rn(x, x));
    }
    out[e] = __fadd_rn(__fsub_rn(rsq[j], __fmul_rn(2.0f, dot)), csq);
  }
}

}  // namespace adc_lut
}  // namespace

extern "C" {

// The LUTs of B queries x P probes on `stream`: q [B, d], coarse
// [nlist, d], cb [m, ks, dsub] f32 (d = m * dsub), probes [B, P] int32
// (each in [0, nlist): the wrapper checks), lut [B, P, m, ks] f32.
// Returns the first cudaError_t met.
int adc_lut_launch(const void* q, const void* coarse, const void* cb,
                   const void* probes, void* lut, int B, int P, int d, int m,
                   int ks, int dsub, void* stream) {
  if (B < 1 || P < 1 || m < 1 || ks < 1 || dsub < 1 || d != m * dsub ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * ((size_t)d + m);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        adc_lut::adc_lut_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  adc_lut::adc_lut_kernel<<<dim3(P, B), adc_lut::kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(coarse),
      static_cast<const float*>(cb), static_cast<const int*>(probes),
      static_cast<float*>(lut), P, d, m, ks, dsub);
  return (int)cudaGetLastError();
}

}  // extern "C"
