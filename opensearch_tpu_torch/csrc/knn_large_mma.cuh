// The large-r tier's tensor-core scan: K1's pool scan at bf16 and int8 with
// r > 1024 (csrc/knn_fused.cu), for Hopper (sm_90a). Two kernels a call:
// knn_large_mma_scan_kernel (every live doc's score key, one u32 a (shard,
// query, doc), the dots on the tensor cores) and knn_large.cuh's
// knn_large_select_kernel (the r best of a (shard, query) row, sorted),
// unchanged.
//
// Replaces, at these shapes: opensearch_tpu/ops/pallas_knn.py::
// _knn_fused_kernel (:675, launched by pallas_knn_fused at :785) at
// score_precision bf16 and int8 with R > 1024, which the reference's
// stacked serving step asks for at a reduced-precision k above 1024 (R = k
// there; opensearch_tpu/parallel/distributed.py:280, no cap). Contract, the
// same as every K1 design's: for every shard s and query b, the r best
// docs of the shard under (score desc, doc id asc), with (-inf, -1) in the
// slots past the shard's live count; what plain_pool computes.
//
// A doc's score is the same bits here as in the wide tier's tensor-core
// scan (knn_wide_mma.cuh): the same ring, the same ldmatrix fragments and
// mma.sync k-steps in the same order (m16n8k16 bf16 into f32; m16n8k32 s8
// into s32, then __fmul_rn(__int2float_rn(acc), scale[shard])), the same
// quad regroup, and the same transform on the same |q|^2. So the first
// 1024 slots of a pool at r = 1025 are the tensor-core tier's pool at
// r = 1024, bit for bit, and int8 pools equal plain_pool's on any data.
//
// Bound: the slab once (2Snd bytes at bf16, Snd at int8), norms and valid
// flags (5Sn), the queries, the r winners written (8SBr), against
// 2*B*S*n*d operations at 989 (bf16) or 1,979 (int8) tera a second: the
// bytes at every serving batch. The keys (4SBn, written and read back) are
// this design's scratch and left out of the bound, as in knn_large.cuh.
//
// Why the large-r tier's shape and not the tensor-core tier's pools: past
// r = 1024 a range of a 2^18-slot shard holds fewer docs than r, so a pool
// a (range, query) would keep every score it saw; the tile scan, which
// served these shapes before, keeps 16 queries' pools of r in shared
// memory and runs out of it past about r = 1,460 at d = 128 and at every
// r > 1024 from d of about 302. This scan keeps no pool, so its shared
// memory is the ring and the query tile whatever r is, and the select
// holds up to 16,384 winners in shared memory and the rest in device
// scratch rows.
//
// Design: knn_wide_mma_scan_kernel's loop (256 threads, an 8-query tile,
// each warp one 128-doc sub-block of a 1,024-doc step, doc rows of 32-bit
// words through pool::Ring's cp.async ring, A fragments by ldmatrix.x4
// from the swizzled stage, B fragments from the padded query tile), with
// the selection replaced by one store a (doc, query): after a step's last
// d chunk each lane holds 4 docs x 8 queries (regroup), transforms them
// and writes keys[s, b, doc] (the wide tier's score_key; 0 for a dead
// doc). A warp's 32 lanes store four runs of 8 consecutive docs a query:
// whole 32-byte sectors.

#pragma once

#include "knn_large.cuh"
#include "knn_wide_mma.cuh"

namespace {
namespace large_mma {

using wide::kQT;
using wide::kSD;
using wide::kSub;
using wide::kThreads;

// bytes of dynamic shared memory one scan CTA needs for rows of w words:
// the ring and the query tile (no pool)
__host__ inline size_t scan_smem_bytes(int stages, int stage_words, int w) {
  return 4 * ((size_t)stages * stage_words +
              (size_t)kQT * mma::query_words(stage_words, w));
}

// grid (n_split, S, ceil(B / 8)); dynamic shared memory scan_smem_bytes.
// CTA (split, s, z) scores docs [split * chunk, min(n, (split + 1) * chunk))
// of shard s against queries [8z, min(B, 8z + 8)) and writes each (query,
// doc)'s score key to keys[s, b, doc]: 0 for a dead doc. Rows are w 32-bit
// words of PREC operands (w % 4 == 0).
template <int PREC, int STAGES, int STAGE_WORDS>
__global__ void __launch_bounds__(kThreads, 1) knn_large_mma_scan_kernel(
    const uint32_t* __restrict__ v,     // [S, n, w] words
    const float* __restrict__ nsq,      // [S, n]
    const uint8_t* __restrict__ valid,  // [S, n] 0 / 1
    const uint32_t* __restrict__ q,     // [B, w] words
    const float* __restrict__ qsq,      // [B]
    const float* __restrict__ scale,    // [S] dequant scale (int8)
    uint32_t* __restrict__ keys,        // [S, B, n]
    int n, int w, int B, int sim, int chunk) {
  using R = wide::Ring<STAGES, STAGE_WORDS>;
  using Acc = typename mma::Op<PREC>::Acc;
  constexpr int kKS = R::kDC / 8;  // 32-byte k-steps a d chunk
  static_assert(R::kDC % 8 == 0, "a d chunk is whole k-steps");
  const int split = blockIdx.x, shard = blockIdx.y;
  const int NC = (w + R::kDC - 1) / R::kDC;
  const int qw = mma::query_words(STAGE_WORDS, w);
  const int q0 = blockIdx.z * kQT;
  const int qb = min(kQT, B - q0);
  const int start = split * chunk;
  const int end = min(n, start + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* vs = reinterpret_cast<const float*>(v + (size_t)shard * n * w);
  const float* nss = nsq + (size_t)shard * n;
  const uint8_t* oks = valid + (size_t)shard * n;
  const float sc = scale[shard];
  uint32_t* ks_out = keys + ((size_t)shard * B + q0) * n;

  extern __shared__ __align__(16) float large_mma_smem[];
  float* ring = large_mma_smem;                  // [STAGES][kSD][kDC]
  uint32_t* qs = reinterpret_cast<uint32_t*>(ring + STAGES * STAGE_WORDS);
  for (int e = tid; e < kQT * qw; e += kThreads) {
    const int row = e / qw, col = e - row * qw;
    qs[e] = (row < qb && col < w) ? q[(size_t)(q0 + row) * w + col] : 0u;
  }
  float qq[kQT];
#pragma unroll
  for (int u = 0; u < kQT; ++u) qq[u] = u < qb ? qsq[q0 + u] : 0.0f;

  const int n_steps = end > start ? (end - start + kSD - 1) / kSD : 0;
  const int n_tiles = n_steps * NC;

  // copy tile t (chunk t % NC of step t / NC) into ring stage t % STAGES;
  // rows past the range's end and words past w are zero-filled
  int in_c = 0, in_doc = start;
  auto fetch = [&](int t) {
    if (t < n_tiles) {
      pool::fetch_tile<R, kThreads>(ring + (t % STAGES) * STAGE_WORDS, vs,
                                    in_doc, in_c * R::kDC, end, w, tid);
      if (++in_c == NC) {
        in_c = 0;
        in_doc += kSD;
      }
    }
    pool::cp_async_commit();
  };

  // this lane's ldmatrix row and the B fragment's query and word, as in
  // knn_wide_mma_scan_kernel
  const int arow = warp * kSub + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int aoff = arow * R::kDC;
  const int asw = R::swizzle(arow);
  const int ahalf = lane >> 4;
  const int g = lane >> 2, t4 = lane & 3;

  Acc c[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0;
  float ns[4];
  bool ok[4];

  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  int cc = 0, step = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int docb = start + step * kSD + warp * kSub;
    // a sub-block wholly past the range's end: nothing to score
    const bool busy = docb < end;
    if (cc == 0) {  // the step's norms and flags, used after its last chunk
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int doc = docb + mma::doc_of(lane, i);
        ok[i] = doc < end && oks[doc] != 0;
        ns[i] = doc < end ? nss[doc] : 0.0f;
      }
    }
    pool::cp_async_wait<STAGES - 2>();
    __syncthreads();
    fetch(t + STAGES - 1);

    const float* st = ring + (t % STAGES) * STAGE_WORDS;
    if (busy) {
      const uint32_t sa = (uint32_t)__cvta_generic_to_shared(st);
      const uint32_t* qg = qs + g * qw + cc * R::kDC + t4;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        const uint32_t b0 = qg[8 * kk], b1 = qg[8 * kk + 4];
        const int col = ((2 * kk + ahalf) ^ asw) << 2;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t a[4];
          mma::ldsm_x4(a, sa + 4u * (aoff + 16 * j * R::kDC + col));
          mma::Op<PREC>::mma(c[j], a, b0, b1);
        }
      }
    }
    if (++cc < NC) continue;
    cc = 0;
    ++step;

    // ---- the step's keys: one store a (doc, query)
    if (busy) {
      float f[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[j][e] = mma::Op<PREC>::dot(c[j][e], sc);
      float acc[4][8];
      mma::regroup(f, acc, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int doc = docb + mma::doc_of(lane, i);
        if (doc < end) {
#pragma unroll
          for (int u = 0; u < kQT; ++u) {
            if (u < qb)
              ks_out[(size_t)u * n + doc] =
                  ok[i] ? wide::score_key(
                              transform_score(acc[i][u], qq[u], ns[i], sim))
                        : 0u;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] = 0;
  }
  pool::cp_async_wait<0>();
}

// ------------------------------------------------------------------ host

template <int PREC, int STAGES, int STAGE_WORDS>
cudaError_t launch_scan(cudaStream_t st, const void* v, const float* nsq,
                        const uint8_t* valid, const void* q,
                        const float* qsq, const float* scale, uint32_t* keys,
                        int S, int n, int w, int B, int sim, int chunk,
                        int n_split) {
  const size_t smem = scan_smem_bytes(STAGES, STAGE_WORDS, w);
  const auto kernel = knn_large_mma_scan_kernel<PREC, STAGES, STAGE_WORDS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_split, S, (B + kQT - 1) / kQT);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const uint32_t*>(v), nsq, valid,
      static_cast<const uint32_t*>(q), qsq, scale, keys, n, w, B, sim,
      chunk);
  return cudaGetLastError();
}

template <int PREC>
cudaError_t launch_ring(cudaStream_t st, const void* v, const float* nsq,
                        const uint8_t* valid, const void* q,
                        const float* qsq, const float* scale, uint32_t* keys,
                        int S, int n, int w, int B, int sim, int stages,
                        int stage_words, int chunk, int n_split) {
  if (stages == 3)
    return launch_scan<PREC, 3, 16384>(st, v, nsq, valid, q, qsq, scale,
                                       keys, S, n, w, B, sim, chunk, n_split);
  if (stage_words == 16384)
    return launch_scan<PREC, 2, 16384>(st, v, nsq, valid, q, qsq, scale,
                                       keys, S, n, w, B, sim, chunk, n_split);
  return launch_scan<PREC, 2, 8192>(st, v, nsq, valid, q, qsq, scale, keys,
                                    S, n, w, B, sim, chunk, n_split);
}

// The tensor-core scan then the large-r tier's select on `st` over the B
// queries; d elements a row of prec (bf16 or int8) operands in whole
// 16-byte units; (stages, stage_words) is the wrapper's ring, chunk (a
// multiple of 128) and n_split its cut of each shard; keys [S, B, n] and,
// where the winners' power of two exceeds large::kSortSmem, sort_[v|i]
// [S, B, P] are its scratch. Returns the first cudaError_t met.
inline cudaError_t launch_large_mma_pool(
    cudaStream_t st, int prec, const void* v, const float* nsq,
    const uint8_t* valid, const void* q, const float* qsq,
    const float* scale, uint32_t* keys, float* sort_v, int* sort_i,
    float* out_v, int* out_i, int S, int n, int d, int B, int r, int sim,
    int stages, int stage_words, int chunk, int n_split) {
  const int eb = mma::elem_bytes(prec);
  if (eb == 0 || r < 1 || d * eb % 16 != 0 || chunk % kSub != 0 || B < 1 ||
      !wide::known_ring(stages, stage_words) ||
      (large::sort_slots(r) && (!sort_v || !sort_i)))
    return cudaErrorInvalidValue;
  const int w = d * eb / 4;
  const cudaError_t e =
      prec == PREC_BF16
          ? launch_ring<PREC_BF16>(st, v, nsq, valid, q, qsq, scale, keys, S,
                                   n, w, B, sim, stages, stage_words, chunk,
                                   n_split)
          : launch_ring<PREC_INT8>(st, v, nsq, valid, q, qsq, scale, keys, S,
                                   n, w, B, sim, stages, stage_words, chunk,
                                   n_split);
  if (e != cudaSuccess) return e;
  return large::launch_select(st, keys, sort_v, sort_i, out_v, out_i, S, n,
                              B, r);
}

// smem bytes of the scan at a ring for rows of d prec elements; 0 for a
// ring or a precision with no kernel
inline size_t large_mma_smem_bytes(int prec, int stages, int stage_words,
                                   int d) {
  const int eb = mma::elem_bytes(prec);
  return eb && wide::known_ring(stages, stage_words)
             ? scan_smem_bytes(stages, stage_words, (d * eb + 3) / 4)
             : 0;
}

}  // namespace large_mma
}  // namespace
