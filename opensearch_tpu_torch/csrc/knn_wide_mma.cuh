// The wide tier's reduced-precision scan: K1's pool scan at bf16 and int8
// with 32 <= r <= 1024 (csrc/knn_fused.cu), for Hopper (sm_90a), the dots
// on the tensor cores. Two kernels a call: knn_wide_mma_scan_kernel (the
// scan, one pool per (range, query)) and knn_wide.cuh's
// knn_wide_merge_kernel (the split merge, unchanged: it reads only f32
// scores and ids).
//
// Replaces, at these shapes: opensearch_tpu/ops/pallas_knn.py::
// _knn_fused_kernel (:675, launched by pallas_knn_fused at :785) at
// score_precision bf16 and int8. Contract, the same as every K1 design's:
// for every shard s and query b, the r best docs of the shard under (score
// desc, doc id asc), with (-inf, -1) in the slots past the shard's live
// count; what plain_pool computes. Dots:
//   bf16  mma.sync m16n8k16 bf16 x bf16 with f32 accumulation. Every
//         product is exact in f32; the tensor cores add them in their own
//         order and alignment, so the sums equal plain_pool's bit for bit
//         where every partial sum is exact (data on a coarse grid, such as
//         chip_smoke.py's sixteenths) and agree to a few ulps elsewhere.
//   int8  mma.sync m16n8k32 s8 x s8 into s32, exact, then
//         __fmul_rn(__int2float_rn(acc), scale[shard]): plain_pool's
//         dots.to(int32).to(float32) * scale, so int8 pools are bit-equal
//         to it on any data.
// The transform and the filter are the wide tier's, rounding after every
// operation as the plain version does.
//
// Bound: the slab once (2Snd bytes at bf16, Snd at int8), norms and valid
// flags (5Sn), against 2*B*S*n*d operations at 989 (bf16) or 1,979 (int8)
// tera a second: bytes at every serving batch. At B = 128, d = 128 bf16
// needs 0.033 ms of tensor-core time for 1M docs against 0.078 ms of
// bytes; int8 is further under. What the tensor cores buy here is that a
// (doc, query) dot no longer costs d FFMAs and d widenings, as in the tile
// scan (knn_tile.cuh), which served these precisions before: mma.sync
// gives that without wgmma's 64-row warpgroup tiles and their canonical
// shared-memory layouts. If the dots still set the pace at B = 32, wgmma
// m64n8 is the next step.
//
// Design (the wide tier's, knn_wide.cuh, but for the dots):
// - The ring, the range cut and the step are the wide tier's: 256 threads,
//   an 8-query tile, each warp one 128-doc sub-block of a 1,024-doc step,
//   doc rows arriving through pool::Ring's cp.async ring of 16-byte units,
//   XOR-swizzled. The ring holds 32-bit words: a bf16 row is d / 2 of them,
//   an int8 row d / 4, so a stage holds a wider d chunk than at fp32. The
//   wrapper copies rows that are not whole 16-byte units (bf16 at d % 8,
//   int8 at d % 16, or an operand off a 16-byte boundary); a k-step's tail
//   past the row is zero-filled in the ring, and a zero column adds an
//   exact zero to every dot.
// - Docs are the M side, the 8 queries N = 8. Each warp's sub-block is
//   eight m16 tiles; a k-step is 32 bytes (16 bf16 or 32 int8), and both
//   precisions' A fragments come from one ldmatrix.x4 of 16 rows x 32
//   bytes (their register layouts are the same bytes). The swizzle keeps
//   those reads free of bank conflicts: a 64-byte row chunk would put rows
//   0, 2, 4 and 6 in the same banks. The B fragments come from the query
//   tile in shared memory, whose rows are padded by 16 bytes so the eight
//   queries' words fall in distinct banks.
// - The accumulator of an m16n8 tile gives each lane 2 docs x 2 queries in
//   place of the FFMA micro-tile's 4 docs x 8 queries. At the step's end the
//   four lanes of each quad trade values by two butterfly stages of
//   shuffles (xor 2, then xor 1), so each lane holds 4 docs x 8 queries
//   again. Staging each warp's 128 x 8 f32 tile in its own rows of the
//   stage just read timed the same (scripts/mma_variants.py
//   "smem_regroup"), at the cost of shared-memory traffic.
// - Then the wide tier's selection, shared by include (knn_wide.cuh
//   append_passers, flush_when_due, write_pool): the pre-transform filter
//   loose by 2^-12, the ballot-and-atomicAdd appends into each query's
//   buffer, the exact radix-select flush, the bitonic sort of each range's
//   pool, and knn_wide_merge_kernel. r starts at 32: reduced precision
//   carries R = max(k, min(max(4k, 32), 512)).

#pragma once

#include "knn_wide.cuh"

namespace {
namespace mma {

using wide::kQT;
using wide::kSD;
using wide::kSub;
using wide::kThreads;
using wide::kWarps;

template <int PREC>
struct Op;

template <>
struct Op<PREC_BF16> {
  typedef float Acc;
  static constexpr int kElemBytes = 2;
  __device__ __forceinline__ static void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ static float dot(float c, float) { return c; }
};

template <>
struct Op<PREC_INT8> {
  typedef int Acc;
  static constexpr int kElemBytes = 1;
  __device__ __forceinline__ static void mma(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ static float dot(int c, float scale) {
    return __fmul_rn(__int2float_rn(c), scale);
  }
};

// Four 8x8 b16 matrices from shared memory, lane l giving the address of
// row l & 7 of matrix l >> 3.
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// Transpose, across the four lanes of a quad (t = lane & 3), the 4 x 4
// values v[o] of lane s: afterwards lane t holds in v[s] what lane s held
// in v[t]. Two butterfly stages, every index static.
__device__ __forceinline__ void quad_transpose(float (&v)[4], int t) {
#pragma unroll
  for (int o = 0; o < 2; ++o) {  // xor 2: the halves of the columns
    const float send = (t & 2) ? v[o] : v[o + 2];
    const float got = __shfl_xor_sync(kFull, send, 2);
    if (t & 2)
      v[o] = got;
    else
      v[o + 2] = got;
  }
#pragma unroll
  for (int b = 0; b < 2; ++b) {  // xor 1: the columns of each half
    const float send = (t & 1) ? v[2 * b] : v[2 * b + 1];
    const float got = __shfl_xor_sync(kFull, send, 1);
    if (t & 1)
      v[2 * b] = got;
    else
      v[2 * b + 1] = got;
  }
}

// Lane's i-th doc of its warp's 128-doc sub-block after the regroup: row
// g + 8 (i & 1) of m16 tile 4 (i >> 1) + t.
__device__ __forceinline__ int doc_of(int lane, int i) {
  return 16 * ((lane & 3) + 4 * (i >> 1)) + (lane >> 2) + 8 * (i & 1);
}

// The warp's m16n8 dots f[j][e] (tile j: e = 0, 1 row g, queries 2t, 2t + 1;
// e = 2, 3 row g + 8) as acc[i][u], doc doc_of(lane, i) and query u: the
// quad of lanes holding a row's eight queries trades values so that lane t
// holds tiles t and t + 4.
__device__ __forceinline__ void regroup(float (&f)[8][4], float (&acc)[4][8],
                                        int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x[4] = {f[4 * jj][e], f[4 * jj + 1][e], f[4 * jj + 2][e],
                    f[4 * jj + 3][e]};
      quad_transpose(x, t);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        acc[2 * jj + (e >> 1)][2 * s + (e & 1)] = x[s];
    }
}

// the query tile's row in words: whole d chunks of the ring, plus 16 bytes
// so the eight queries' fragment words fall in distinct banks
__host__ __device__ inline int query_words(int stage_words, int w) {
  return wide::chunked_width(stage_words, w) + 4;
}

// bytes of dynamic shared memory one scan CTA needs for rows of w words:
// the ring, the query tile and the wide tier's selection
__host__ inline size_t scan_smem_bytes(int stages, int stage_words, int w,
                                       int r, int rows, int cap) {
  return 4 * ((size_t)stages * stage_words +
              (size_t)kQT * query_words(stage_words, w) +
              wide::sel_words(r, rows, cap));
}

// grid (n_split, S, ceil(B / 8)); dynamic shared memory scan_smem_bytes.
// CTA (split, s, z) scans docs [split * chunk, min(n, (split + 1) * chunk))
// of shard s against queries [8z, min(B, 8z + 8)) and writes each query's
// r best, sorted, to part_[v|i][s, split, b, :]. Rows are w 32-bit words
// of PREC operands (w % 4 == 0).
template <int PREC, int STAGES, int STAGE_WORDS>
__global__ void __launch_bounds__(kThreads, 1) knn_wide_mma_scan_kernel(
    const uint32_t* __restrict__ v,     // [S, n, w] words
    const float* __restrict__ nsq,      // [S, n]
    const uint8_t* __restrict__ valid,  // [S, n] 0 / 1
    const uint32_t* __restrict__ q,     // [B, w] words
    const float* __restrict__ qsq,      // [B]
    const float* __restrict__ scale,    // [S] dequant scale (int8)
    float* __restrict__ part_v,         // [S, n_split, B, r]
    int* __restrict__ part_i,           // [S, n_split, B, r]
    int n, int w, int B, int r, int cap, int sim, int chunk, int n_split) {
  using R = wide::Ring<STAGES, STAGE_WORDS>;
  using Acc = typename Op<PREC>::Acc;
  constexpr int kKS = R::kDC / 8;  // 32-byte k-steps a d chunk
  static_assert(R::kDC % 8 == 0, "a d chunk is whole k-steps");
  const int split = blockIdx.x, shard = blockIdx.y;
  const int NC = (w + R::kDC - 1) / R::kDC;
  const int qw = query_words(STAGE_WORDS, w);
  const int q0 = blockIdx.z * kQT;
  const int qb = min(kQT, B - q0);
  const int rows = min(kQT, B);
  const int start = split * chunk;
  const int end = min(n, start + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* vs = reinterpret_cast<const float*>(v + (size_t)shard * n * w);
  const float* nss = nsq + (size_t)shard * n;
  const uint8_t* oks = valid + (size_t)shard * n;
  const float sc = scale[shard];

  extern __shared__ __align__(16) float mma_smem[];
  float* ring = mma_smem;                        // [STAGES][kSD][kDC]
  uint32_t* qs = reinterpret_cast<uint32_t*>(ring + STAGES * STAGE_WORDS);
  const wide::Sel sel =                          // after the [8][qw] tile
      wide::carve_sel(reinterpret_cast<float*>(qs + kQT * qw), rows, r, cap);

  for (int e = tid; e < kQT * qw; e += kThreads) {
    const int row = e / qw, col = e - row * qw;
    qs[e] = (row < qb && col < w) ? q[(size_t)(q0 + row) * w + col] : 0u;
  }
  wide::init_sel(sel, qsq, q0, qb, tid);

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

  // this lane's ldmatrix row: row (lane & 7) + 8 ((lane >> 3) & 1) of each
  // m16 tile, 16-byte half lane >> 4 of each k-step; the tiles lie 16 rows
  // apart, which moves no swizzle (a multiple of 8 rows)
  const int arow = warp * kSub + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int aoff = arow * R::kDC;
  const int asw = R::swizzle(arow);
  const int ahalf = lane >> 4;
  // the B fragment's query (g) and word (t) of each 16-byte half
  const int g = lane >> 2, t4 = lane & 3;

  Acc c[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0;
  float ns[4];
  bool ok[4];

  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  // the warps [sq * G, (sq + 1) * G) select for query sq
  const int G = wide::group_warps(qb);
  const int sq = warp / G;

  int cc = 0, step = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int docb = start + step * kSD + warp * kSub;
    // a sub-block wholly past the range's end: nothing to score
    const bool busy = docb < end;
    if (cc == 0) {  // the step's norms and flags, used after its last chunk
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int doc = docb + doc_of(lane, i);
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
      for (int ks = 0; ks < kKS; ++ks) {
        const uint32_t b0 = qg[8 * ks], b1 = qg[8 * ks + 4];
        const int col = ((2 * ks + ahalf) ^ asw) << 2;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t a[4];
          ldsm_x4(a, sa + 4u * (aoff + 16 * j * R::kDC + col));
          Op<PREC>::mma(c[j], a, b0, b1);
        }
      }
    }
    if (++cc < NC) continue;
    cc = 0;
    const bool last = ++step == n_steps;

    // ---- the step's passers, appended to their queries' buffers
    if (busy) {
      float f[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[j][e] = Op<PREC>::dot(c[j][e], sc);
      float acc[4][8];
      regroup(f, acc, lane);
      int doc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) doc[i] = docb + doc_of(lane, i);
      wide::append_passers(sel, acc, ok, ns, doc, qb, cap, sim, lane);
    }
    __syncthreads();
    // ---- query sq's group of warps flushes its buffer when due
    wide::flush_when_due(sel, sq, qb, last, r, cap, sim, G, warp, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] = 0;
  }
  pool::cp_async_wait<0>();
  __syncthreads();

  // ---- the range's end: each query's sorted pool, r slots
  const size_t o = (((size_t)shard * n_split + split) * B + q0 + sq) * r;
  wide::write_pool(sel, sq, qb, r, cap, G, warp, lane, part_v + o,
                   part_i + o);
}

// ------------------------------------------------------------------ host

template <int PREC, int STAGES, int STAGE_WORDS>
cudaError_t launch_scan(cudaStream_t st, const void* v, const float* nsq,
                        const uint8_t* valid, const void* q,
                        const float* qsq, const float* scale, float* part_v,
                        int* part_i, int S, int n, int w, int B, int r,
                        int cap, int sim, int chunk, int n_split) {
  const size_t smem = scan_smem_bytes(STAGES, STAGE_WORDS, w, r,
                                      std::min(kQT, B), cap);
  const auto kernel = knn_wide_mma_scan_kernel<PREC, STAGES, STAGE_WORDS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_split, S, (B + kQT - 1) / kQT);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const uint32_t*>(v), nsq, valid,
      static_cast<const uint32_t*>(q), qsq, scale, part_v, part_i, n, w, B, r,
      cap, sim, chunk, n_split);
  return cudaGetLastError();
}

template <int PREC>
cudaError_t launch_ring(cudaStream_t st, const void* v, const float* nsq,
                        const uint8_t* valid, const void* q,
                        const float* qsq, const float* scale, float* part_v,
                        int* part_i, int S, int n, int w, int B, int r,
                        int sim, int stages, int stage_words, int cap,
                        int chunk, int n_split) {
  if (stages == 3)
    return launch_scan<PREC, 3, 16384>(st, v, nsq, valid, q, qsq, scale,
                                       part_v, part_i, S, n, w, B, r, cap,
                                       sim, chunk, n_split);
  if (stage_words == 16384)
    return launch_scan<PREC, 2, 16384>(st, v, nsq, valid, q, qsq, scale,
                                       part_v, part_i, S, n, w, B, r, cap,
                                       sim, chunk, n_split);
  return launch_scan<PREC, 2, 8192>(st, v, nsq, valid, q, qsq, scale, part_v,
                                    part_i, S, n, w, B, r, cap, sim, chunk,
                                    n_split);
}

// the operand's bytes an element, 0 for a precision with no kernel here
inline int elem_bytes(int prec) {
  return prec == PREC_BF16 ? Op<PREC_BF16>::kElemBytes
         : prec == PREC_INT8 ? Op<PREC_INT8>::kElemBytes
                             : 0;
}

// The tensor-core scan then the wide tier's split merge on `st` over the B
// queries; d elements a row of prec (bf16 or int8) operands in whole
// 16-byte units; (stages, stage_words, cap) is the wrapper's plan, chunk
// (a multiple of 128) and n_split its cut of each shard. Returns the first
// cudaError_t met.
inline cudaError_t launch_mma_pool(cudaStream_t st, int prec, const void* v,
                                   const float* nsq, const uint8_t* valid,
                                   const void* q, const float* qsq,
                                   const float* scale, float* part_v,
                                   int* part_i, float* out_v, int* out_i,
                                   int S, int n, int d, int B, int r, int sim,
                                   int stages, int stage_words, int cap,
                                   int chunk, int n_split) {
  const int eb = elem_bytes(prec);
  if (eb == 0 || r < 1 || r > wide::kMaxR || d * eb % 16 != 0 ||
      chunk % kSub != 0 || B < 1 || cap < kSD ||
      !wide::known_ring(stages, stage_words))
    return cudaErrorInvalidValue;
  const int w = d * eb / 4;
  const cudaError_t e =
      prec == PREC_BF16
          ? launch_ring<PREC_BF16>(st, v, nsq, valid, q, qsq, scale, part_v,
                                   part_i, S, n, w, B, r, sim, stages,
                                   stage_words, cap, chunk, n_split)
          : launch_ring<PREC_INT8>(st, v, nsq, valid, q, qsq, scale, part_v,
                                   part_i, S, n, w, B, r, sim, stages,
                                   stage_words, cap, chunk, n_split);
  if (e != cudaSuccess) return e;
  return wide::launch_merge(st, part_v, part_i, out_v, out_i, S, B, r,
                            n_split);
}

// smem bytes of the scan at a plan for rows of d prec elements; 0 for a
// ring or a precision with no kernel
inline size_t mma_smem_bytes(int prec, int stages, int stage_words, int d,
                             int r, int rows, int cap) {
  const int eb = elem_bytes(prec);
  return eb && wide::known_ring(stages, stage_words)
             ? scan_smem_bytes(stages, stage_words, (d * eb + 3) / 4, r,
                               rows, cap)
             : 0;
}

}  // namespace mma
}  // namespace
