// IVF-PQ ADC scan over host-chosen probes with a top-R pool, for Hopper
// (sm_90a).
//
// Replaces: opensearch_tpu/ops/pallas_adc.py::_adc_scan_kernel (launched by
// pallas_adc_topr). Same contract: for every query b, over its probes
// p = 0..P-1 and the slots l of inverted list probes[b, p],
//   adc = sum_{mi = 0..m-1} lut[b, p, mi, codes[probes[b, p], l, mi]],
// score -adc where mask says the slot is live, else -inf; keep the R best
// under the key (score desc, probe-major position p * L_pad + l asc) and
// write [B, R] scores and doc ids (ids[probes[b, p], l]), with (-inf, -1) in
// the slots past the live-candidate count. The position tie-break matters:
// identical PQ codes give bit-identical sums, and the earlier probe's slot
// must win, as lax.top_k over the flattened [P * L_pad] axis does.
// Accumulation: fp32 LUT in f32, mi in order; bf16 LUT widened to f32 per
// entry, f32 in order; uint8 LUT in int32 (exact), then to float.
//
// Bound: memory. Each launch must read the probed code blocks
// (P * L_pad * m bytes per query), their mask bytes and (for the winners)
// ids, and the LUTs (P * m * ks * w bytes per query, w = 4, 2 or 1); it does
// one add per (slot, subspace), far below any peak rate. At the glove-100
// shape (m = 20, L_pad = 4096, P = 8) a query reads about 0.8 MB of codes and
// 160 KB of fp32 LUT.
//
// Design, against that bound:
//  - One CTA per (list chunk, probe, query): grid (n_chunks, P, B). The CTA
//    first reads its chunk's mask bytes; a chunk with no live slot (the
//    padded tail of a short list) writes an empty pool and stops before
//    touching the LUT or the codes.
//  - The (b, p) LUT goes to shared memory at its native width with 16-byte
//    copies (20 KB at m = 20 fp32, 96 KB at m = 96: dynamic shared memory
//    above 48 KB). Each thread decodes its slots by direct lookup into it
//    (the Pallas kernel's one-hot matmul is a TPU idiom; here a lookup is
//    one shared-memory load). Code rows are read as 4-byte words when m is a
//    multiple of 4 (m = 20 rows are 20 bytes: never assumed 16-byte rows),
//    else as bytes; neighbouring threads read neighbouring rows.
//  - The chunk's (score, position) pairs are sorted in shared memory by a
//    bitonic network under the key above; the best min(R, chunk) go to
//    device memory as the CTA's partial pool.
//  - A second launch merges, per query, the P * n_chunks sorted partial
//    pools by the same key: a CTA stages them in shared memory when they
//    fit in 160 KB, then one warp merges and looks the doc ids up for the
//    R winners only. It has no limit on R.
//  - No atomics and no data-dependent order: results are the same run to
//    run, and at uint8 bit-equal to the plain PyTorch version.
// Not yet used: cp.async / TMA pipelining of the code blocks, a threshold
// pool that skips the sort (a later change).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// partial pools of one query are staged in shared memory up to this size
constexpr size_t kMergeStageBytes = 160 * 1024;

enum { PREC_FP32 = 0, PREC_BF16 = 1, PREC_U8 = 2 };

__host__ __device__ inline int lut_elem_bytes(int prec) {
  return prec == PREC_FP32 ? 4 : (prec == PREC_BF16 ? 2 : 1);
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// (av, ap) ranks before (bv, bp): higher score, then lower position
__device__ __forceinline__ bool before(float av, int ap, float bv, int bp) {
  return av > bv || (av == bv && ap < bp);
}

template <int PREC>
__device__ __forceinline__ float lut_at(const unsigned char* lut, int idx) {
  if constexpr (PREC == PREC_FP32) {
    return reinterpret_cast<const float*>(lut)[idx];
  } else {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(lut)[idx]);
  }
}

// ADC sum of one code row against the shared-memory LUT, subspaces in order
template <int PREC, bool WORDS>
__device__ __forceinline__ float decode_row(const unsigned char* lut,
                                            const uint8_t* __restrict__ row,
                                            int m, int ks) {
  if constexpr (PREC == PREC_U8) {
    int acc = 0;
    if constexpr (WORDS) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
      for (int q = 0; q < (m >> 2); ++q) {
        const uint32_t x = __ldg(w + q);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc += lut[(4 * q + j) * ks + ((x >> (8 * j)) & 0xffu)];
      }
    } else {
      for (int mi = 0; mi < m; ++mi) acc += lut[mi * ks + __ldg(row + mi)];
    }
    return __int2float_rn(acc);
  } else {
    float acc;
    if constexpr (WORDS) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
      uint32_t x = __ldg(w);
      acc = lut_at<PREC>(lut, x & 0xffu);
#pragma unroll
      for (int j = 1; j < 4; ++j)
        acc = __fadd_rn(acc,
                        lut_at<PREC>(lut, j * ks + ((x >> (8 * j)) & 0xffu)));
      for (int q = 1; q < (m >> 2); ++q) {
        x = __ldg(w + q);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc = __fadd_rn(acc, lut_at<PREC>(lut, (4 * q + j) * ks +
                                                     ((x >> (8 * j)) & 0xffu)));
      }
    } else {
      acc = lut_at<PREC>(lut, __ldg(row));
      for (int mi = 1; mi < m; ++mi)
        acc = __fadd_rn(acc, lut_at<PREC>(lut, mi * ks + __ldg(row + mi)));
    }
    return acc;
  }
}

// grid (n_chunks, P, B), kThreads threads; dynamic shared memory from
// adc_scan_smem_bytes. ch is a power of two.
template <int PREC, bool WORDS>
__global__ void __launch_bounds__(kThreads) adc_scan_kernel(
    const unsigned char* __restrict__ lut,  // [B, P, m, ks] native width
    const uint8_t* __restrict__ codes,      // [nlist, l_pad, m]
    const uint8_t* __restrict__ mask,       // [nlist, l_pad] 0 / 1
    const int* __restrict__ probes,         // [B, P]
    float* __restrict__ part_v,             // [B, P * n_chunks, rp]
    int* __restrict__ part_p,
    int P, int nlist, int l_pad, int m, int ks, int ch, int rp,
    int n_chunks) {
  const int c = blockIdx.x, p = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int list = probes[(size_t)b * P + p];
  const bool list_ok = list >= 0 && list < nlist;
  const int l0 = c * ch;
  const size_t slot0 = (size_t)(list_ok ? list : 0) * l_pad;
  const size_t obase = (((size_t)b * P + p) * n_chunks + c) * rp;

  int live = 0;
  if (list_ok) {
    for (int i = tid; i < ch; i += kThreads) {
      const int l = l0 + i;
      if (l < l_pad && mask[slot0 + l]) live = 1;
    }
  }
  if (!__syncthreads_or(live)) {
    for (int i = tid; i < rp; i += kThreads) {
      part_v[obase + i] = -INFINITY;
      part_p[obase + i] = INT_MAX;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t lut_bytes = (size_t)m * ks * lut_elem_bytes(PREC);
  float* sv = reinterpret_cast<float*>(smem + align16(lut_bytes));
  int* sp = reinterpret_cast<int*>(sv + ch);

  const unsigned char* src = lut + ((size_t)b * P + p) * lut_bytes;
  if ((lut_bytes & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(smem);
    for (size_t i = tid; i < lut_bytes / 16; i += kThreads) d4[i] = __ldg(s4 + i);
  } else {
    for (size_t i = tid; i < lut_bytes; i += kThreads) smem[i] = __ldg(src + i);
  }
  __syncthreads();

  for (int i = tid; i < ch; i += kThreads) {
    const int l = l0 + i;
    float s = -INFINITY;
    int pos = INT_MAX;
    if (l < l_pad) {
      pos = p * l_pad + l;
      if (mask[slot0 + l])
        s = -decode_row<PREC, WORDS>(smem, codes + (slot0 + l) * m, m, ks);
    }
    sv[i] = s;
    sp[i] = pos;
  }
  __syncthreads();

  // bitonic sort, best first
  for (int size = 2; size <= ch; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < (ch >> 1); i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const float av = sv[lo], bv = sv[hi];
        const int ap = sp[lo], bp = sp[hi];
        const bool swap = (lo & size) == 0 ? before(bv, bp, av, ap)
                                           : before(av, ap, bv, bp);
        if (swap) {
          sv[lo] = bv;
          sv[hi] = av;
          sp[lo] = bp;
          sp[hi] = ap;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < rp; i += kThreads) {
    part_v[obase + i] = sv[i];
    part_p[obase + i] = sp[i];
  }
}

// grid (B), kThreads threads: all of them stage the `parts` sorted partial
// pools of one query (when they fit), then one warp merges them into the
// query's best r and looks up the winners' doc ids
__global__ void __launch_bounds__(kThreads) adc_merge_kernel(
    const float* __restrict__ part_v, const int* __restrict__ part_p,
    const int* __restrict__ ids,      // [nlist, l_pad]
    const int* __restrict__ probes,   // [B, P]
    float* __restrict__ out_v, int* __restrict__ out_i,
    int parts, int rp, int r, int P, int l_pad, int staged) {
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  extern __shared__ __align__(16) unsigned char msmem[];
  int* heads = reinterpret_cast<int*>(msmem);
  const size_t pbase = (size_t)b * parts * rp;
  const float* pv = part_v + pbase;
  const int* pp = part_p + pbase;
  if (staged) {
    float* sv = reinterpret_cast<float*>(msmem + align16((size_t)parts * 4));
    int* sp = reinterpret_cast<int*>(sv + (size_t)parts * rp);
    for (size_t i = tid; i < (size_t)parts * rp; i += kThreads) {
      sv[i] = pv[i];
      sp[i] = pp[i];
    }
    pv = sv;
    pp = sp;
  }
  for (int q = tid; q < parts; q += kThreads) heads[q] = 0;
  __syncthreads();
  if (tid >= 32) return;
  const size_t obase = (size_t)b * r;
  // the winners' positions go to out_i first; their doc ids are looked up
  // after the merge, so no round waits on a device-memory load
  int count = r;
  for (int t = 0; t < r; ++t) {
    float bv = -INFINITY;
    int bpos = INT_MAX, bq = -1;
    for (int q = lane; q < parts; q += 32) {
      const int h = heads[q];
      if (h < rp) {
        const float v = pv[(size_t)q * rp + h];
        const int pos = pp[(size_t)q * rp + h];
        if (bq < 0 || before(v, pos, bv, bpos)) {
          bv = v;
          bpos = pos;
          bq = q;
        }
      }
    }
    for (int o = 16; o; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int opos = __shfl_xor_sync(kFull, bpos, o);
      const int oq = __shfl_xor_sync(kFull, bq, o);
      const bool take = oq >= 0 && (bq < 0 || before(ov, opos, bv, bpos) ||
                                    (!before(bv, bpos, ov, opos) && oq < bq));
      if (take) {
        bv = ov;
        bpos = opos;
        bq = oq;
      }
    }
    if (bq < 0 || bv == -INFINITY) {  // warp-uniform: nothing live is left
      count = t;
      break;
    }
    if (lane == 0) {
      out_v[obase + t] = bv;
      out_i[obase + t] = bpos;
      heads[bq] += 1;
    }
    __syncwarp();
  }
  __syncwarp();
  for (int u = lane; u < r; u += 32) {
    if (u < count) {
      const int pos = out_i[obase + u];
      const int pr = pos / l_pad;
      const int l = pos - pr * l_pad;
      out_i[obase + u] = ids[(size_t)probes[(size_t)b * P + pr] * l_pad + l];
    } else {
      out_v[obase + u] = -INFINITY;
      out_i[obase + u] = -1;
    }
  }
}

template <int PREC, bool WORDS>
cudaError_t launch_scan(dim3 grid, size_t smem, cudaStream_t st,
                        const unsigned char* lut, const uint8_t* codes,
                        const uint8_t* mask, const int* probes, float* pv,
                        int* pp, int P, int nlist, int l_pad, int m, int ks,
                        int ch, int rp, int n_chunks) {
  cudaError_t e = cudaFuncSetAttribute(
      adc_scan_kernel<PREC, WORDS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  adc_scan_kernel<PREC, WORDS><<<grid, kThreads, smem, st>>>(
      lut, codes, mask, probes, pv, pp, P, nlist, l_pad, m, ks, ch, rp,
      n_chunks);
  return cudaGetLastError();
}

template <int PREC>
cudaError_t launch_scan_prec(bool words, dim3 grid, size_t smem,
                             cudaStream_t st, const unsigned char* lut,
                             const uint8_t* codes, const uint8_t* mask,
                             const int* probes, float* pv, int* pp, int P,
                             int nlist, int l_pad, int m, int ks, int ch,
                             int rp, int n_chunks) {
  if (words)
    return launch_scan<PREC, true>(grid, smem, st, lut, codes, mask, probes,
                                   pv, pp, P, nlist, l_pad, m, ks, ch, rp,
                                   n_chunks);
  return launch_scan<PREC, false>(grid, smem, st, lut, codes, mask, probes,
                                  pv, pp, P, nlist, l_pad, m, ks, ch, rp,
                                  n_chunks);
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory one scan CTA needs
size_t adc_scan_smem_bytes(int prec, int m, int ks, int ch) {
  return align16((size_t)m * ks * lut_elem_bytes(prec)) + (size_t)ch * 8;
}

// bytes of dynamic shared memory the merge needs, and whether it stages the
// partial pools (1) or reads them from device memory (0)
size_t adc_merge_smem_bytes(int parts, int rp, int* staged) {
  const size_t head = align16((size_t)parts * 4);
  const size_t all = head + (size_t)parts * rp * 8;
  *staged = all <= kMergeStageBytes ? 1 : 0;
  return *staged ? all : head;
}

// Scan + merge on `stream`. Returns the first cudaError_t met (0 = launched).
// part_v / part_p hold B * P * ceil(l_pad / ch) * min(r, ch) entries.
int adc_scan_launch(const void* lut, const void* codes, const void* mask,
                    const void* ids, const void* probes, void* part_v,
                    void* part_p, void* out_v, void* out_i, int B, int P,
                    int nlist, int l_pad, int m, int ks, int r, int ch,
                    int prec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (l_pad + ch - 1) / ch;
  const int rp = r < ch ? r : ch;
  const int parts = P * n_chunks;
  const size_t smem = adc_scan_smem_bytes(prec, m, ks, ch);
  const dim3 grid(n_chunks, P, B);
  const bool words = (m & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(codes) & 3) == 0;
  const unsigned char* lut_b = static_cast<const unsigned char*>(lut);
  const uint8_t* codes_b = static_cast<const uint8_t*>(codes);
  const uint8_t* mask_b = static_cast<const uint8_t*>(mask);
  const int* probes_i = static_cast<const int*>(probes);
  float* pv = static_cast<float*>(part_v);
  int* pp = static_cast<int*>(part_p);
  cudaError_t e;
  if (prec == PREC_U8) {
    e = launch_scan_prec<PREC_U8>(words, grid, smem, st, lut_b, codes_b,
                                  mask_b, probes_i, pv, pp, P, nlist, l_pad,
                                  m, ks, ch, rp, n_chunks);
  } else if (prec == PREC_BF16) {
    e = launch_scan_prec<PREC_BF16>(words, grid, smem, st, lut_b, codes_b,
                                    mask_b, probes_i, pv, pp, P, nlist, l_pad,
                                    m, ks, ch, rp, n_chunks);
  } else {
    e = launch_scan_prec<PREC_FP32>(words, grid, smem, st, lut_b, codes_b,
                                    mask_b, probes_i, pv, pp, P, nlist, l_pad,
                                    m, ks, ch, rp, n_chunks);
  }
  if (e != cudaSuccess) return (int)e;
  int staged = 0;
  const size_t msmem = adc_merge_smem_bytes(parts, rp, &staged);
  e = cudaFuncSetAttribute(adc_merge_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)msmem);
  if (e != cudaSuccess) return (int)e;
  adc_merge_kernel<<<B, kThreads, msmem, st>>>(
      pv, pp, static_cast<const int*>(ids), probes_i,
      static_cast<float*>(out_v), static_cast<int*>(out_i), parts, rp, r, P,
      l_pad, staged);
  return (int)cudaGetLastError();
}

}  // extern "C"
