// The large-r tier: K1's fp32 pool scan at r > 1024 (csrc/knn_fused.cu),
// for Hopper (sm_90a). Two kernels a call: knn_large_scan_kernel (every
// live doc's score key, one u32 a (shard, query, doc)) and
// knn_large_select_kernel (the r best of a (shard, query) row, sorted).
// At bf16 and int8 knn_large_mma.cuh's tensor-core scan writes the same
// keys and this select follows it unchanged.
//
// Replaces, at these shapes: opensearch_tpu/ops/pallas_knn.py::
// _knn_fused_kernel (:675, launched by pallas_knn_fused at :785), which the
// reference's stacked serving step runs at R = k_shard = min(k, n_flat)
// with no cap (opensearch_tpu/parallel/distributed.py:280). Contract, the
// same as the wide tier's (knn_wide.cuh): for every shard s and query b,
// the r best docs of the shard under (score desc, doc id asc), with
// (-inf, -1) in the slots past the shard's live count. fp32 only: every dot
// sums its d products in ascending order in one f32 accumulator (the wide
// tier's micro-tile, so a doc's score is the same bits in both tiers); the
// transform rounds after every operation.
//
// Bound: the slab once (4Snd bytes), norms and valid flags (5Sn), the
// queries and |q|^2, the r winners written (8SBr), against 2*B*S*n*d FFMA
// operations. The keys this design writes and reads back (8SBn) are its
// own scratch, not the function's bytes, so the bound leaves them out.
//
// Why not the wide tier's pools: a range of a 2^18-slot shard holds about
// 2,000 docs at one query tile a wave, fewer than r. A range pool of r would
// hold every score it saw, and the ranges' pools together at least n of
// them: as many bytes as the keys here, plus the pools' selects and sorts in
// the scan and the merge's over n_split * r slots. Past r of about 20,000
// even one query's pool leaves no room for a ring. So the scan keeps no pool
// at all: each doc's order-preserving score key (the wide tier's
// score_key; 0 for a dead doc) goes to device memory, coalesced, a lane a
// doc. The select then finds the r best by the wide tier's exact radix
// select over 64-bit keys (the score key above ~doc id: distinct in a
// shard), reading the row from device memory (L2 at the serving shapes),
// compacts the winners and sorts them by the wide tier's bitonic network:
// in shared memory up to kSortSmem slots, in a device scratch row above
// (every network stage between two barriers of the CTA).
//
// Design:
// - Scan: the wide tier's (knn_pool.cuh's Ring, fetch_tile, lane_rows and
//   micro_tile at 8-query tiles, 256 threads, one contiguous range of one
//   shard a CTA, about one wave), with the selection replaced by one store
//   a (doc, query): keys[s, b, doc].
// - Select: one 512-thread CTA a (query, shard): the live count; when it is
//   above r, the threshold of the r best keys (wide::group_select: 8-bit
//   passes from the highest differing bit); the winners (keys at or above
//   it) placed in any order by a ballot and one atomicAdd a warp, padded
//   with (-inf, -1) to a power of two, sorted, r slots written.

#pragma once

#include "knn_wide.cuh"

namespace {
namespace large {

using wide::u64;
constexpr int kThreads = wide::kThreads;    // the scan: 256
constexpr int kQT = wide::kQT;              // queries a scan CTA
constexpr int kSD = wide::kSD;              // docs a step (1024)
constexpr int kSelThreads = wide::kMergeThreads;  // the select: 512
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kSortSmem = 16384;  // slots sorted in shared memory (128 KB)

// bytes of dynamic shared memory one scan CTA needs: the ring and the
// query tile
__host__ inline size_t scan_smem_bytes(int stages, int stage_floats, int d) {
  return 4 * ((size_t)stages * stage_floats +
              (size_t)kQT * wide::chunked_width(stage_floats, d));
}

// the slots of the device scratch row a (shard, query) the select sorts
// its winners in: their power of two where it exceeds kSortSmem, else 0
// (they sort in shared memory)
__host__ inline int sort_slots(int r) {
  const int P = wide::pow2_at_least(r);
  return P > kSortSmem ? P : 0;
}

// bytes of dynamic shared memory one select CTA needs: the select's
// scratch (two keys a warp, a 256-bin histogram, eight ints) and, where
// the winners' power of two fits kSortSmem, their (score, id) slots
__host__ inline size_t select_smem_bytes(int r) {
  const int P = wide::pow2_at_least(r);
  return 8 * 2 * (size_t)kSelWarps + 4 * ((size_t)wide::kBins + 8) +
         (sort_slots(r) ? 0 : 8 * (size_t)P);
}

// grid (n_split, S, ceil(B / 8)); dynamic shared memory scan_smem_bytes.
// CTA (split, s, z) scores docs [split * chunk, min(n, (split + 1) * chunk))
// of shard s against queries [8z, min(B, 8z + 8)) and writes each (query,
// doc)'s score key to keys[s, b, doc]: 0 for a dead doc.
template <int STAGES, int STAGE_FLOATS>
__global__ void __launch_bounds__(kThreads, 1) knn_large_scan_kernel(
    const float* __restrict__ v,        // [S, n, d] f32, d % 4 == 0
    const float* __restrict__ nsq,      // [S, n]
    const uint8_t* __restrict__ valid,  // [S, n] 0 / 1
    const float* __restrict__ q,        // [B, d] f32
    const float* __restrict__ qsq,      // [B]
    uint32_t* __restrict__ keys,        // [S, B, n]
    int n, int d, int B, int sim, int chunk) {
  using R = wide::Ring<STAGES, STAGE_FLOATS>;
  const int split = blockIdx.x, shard = blockIdx.y;
  const int NC = (d + R::kDC - 1) / R::kDC;
  const int dp = NC * R::kDC;
  const int q0 = blockIdx.z * kQT;
  const int qb = min(kQT, B - q0);
  const int start = split * chunk;
  const int end = min(n, start + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* vs = v + (size_t)shard * n * d;
  const float* nss = nsq + (size_t)shard * n;
  const uint8_t* oks = valid + (size_t)shard * n;
  uint32_t* ks = keys + ((size_t)shard * B + q0) * n;

  extern __shared__ __align__(16) float large_smem[];
  float* ring = large_smem;                      // [STAGES][kSD][kDC]
  float* qs = ring + STAGES * STAGE_FLOATS;      // [8][dp]
  for (int e = tid; e < kQT * dp; e += kThreads) {
    const int row = e / dp, col = e - row * dp;
    qs[e] = (row < qb && col < d) ? q[(size_t)(q0 + row) * d + col] : 0.0f;
  }
  float qq[kQT];
#pragma unroll
  for (int u = 0; u < kQT; ++u) qq[u] = u < qb ? qsq[q0 + u] : 0.0f;

  const int n_steps = end > start ? (end - start + kSD - 1) / kSD : 0;
  const int n_tiles = n_steps * NC;

  // copy tile t (chunk t % NC of step t / NC) into ring stage t % STAGES;
  // rows past the range's end and columns past d are zero-filled, unread
  int in_c = 0, in_doc = start;
  auto fetch = [&](int t) {
    if (t < n_tiles) {
      pool::fetch_tile<R, kThreads>(ring + (t % STAGES) * STAGE_FLOATS, vs,
                                    in_doc, in_c * R::kDC, end, d, tid);
      if (++in_c == NC) {
        in_c = 0;
        in_doc += kSD;
      }
    }
    pool::cp_async_commit();
  };

  int roff[4], rsw[4];
  pool::lane_rows<R>(warp * pool::kSub, lane, roff, rsw);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.0f;

  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  int c = 0, step = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int docb = start + step * kSD + warp * pool::kSub;
    const bool busy = docb < end;
    pool::cp_async_wait<STAGES - 2>();
    __syncthreads();
    fetch(t + STAGES - 1);

    const float* st = ring + (t % STAGES) * STAGE_FLOATS;
    if (busy) pool::micro_tile<R>(acc, st, roff, rsw, qs + c * R::kDC, dp);
    if (++c < NC) continue;
    c = 0;
    ++step;

    // ---- the step's keys: one coalesced store a doc row and query
    if (busy) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int doc = docb + lane + 32 * i;
        if (doc < end) {
          const bool ok = oks[doc] != 0;
          const float ns = nss[doc];
#pragma unroll
          for (int u = 0; u < kQT; ++u) {
            if (u < qb)
              ks[(size_t)u * n + doc] =
                  ok ? wide::score_key(transform_score(acc[i][u], qq[u], ns,
                                                       sim))
                     : 0u;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[i][u] = 0.0f;
  }
  pool::cp_async_wait<0>();
}

// grid (B, S); dynamic shared memory select_smem_bytes(r). The r best of
// row keys[s, b, :] under (score desc, doc id asc), sorted, with (-inf, -1)
// past the live count, to out_[v|i][s, b, :]. Where the winners' power of
// two P exceeds kSortSmem they are sorted in sort_[v|i][s, b, :P].
__global__ void __launch_bounds__(kSelThreads) knn_large_select_kernel(
    const uint32_t* __restrict__ keys,  // [S, B, n]
    float* sort_v,                      // [S, B, P] (P > kSortSmem only)
    int* sort_i,
    float* __restrict__ out_v,          // [S, B, r]
    int* __restrict__ out_i,
    int n, int B, int r) {
  const int b = blockIdx.x, shard = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = wide::pow2_at_least(r);
  const size_t row = (size_t)shard * B + b;
  extern __shared__ __align__(16) u64 large_sel_smem[];
  u64* wmm = large_sel_smem;                               // [16][2]
  unsigned* hist = reinterpret_cast<unsigned*>(wmm + 2 * kSelWarps);
  int* misc = reinterpret_cast<int*>(hist + wide::kBins);  // pick[3], counts
  const bool in_smem = P <= kSortSmem;
  float* wv = in_smem ? reinterpret_cast<float*>(misc + 8) : sort_v + row * P;
  int* wi = in_smem ? reinterpret_cast<int*>(wv + P) : sort_i + row * P;
  const uint32_t* ks = keys + row * n;
  // the 64-bit key of doc e: its score key above ~e, 0 for a dead doc
  const auto key = [&](int e) {
    const uint32_t s = ks[e];
    return s ? ((u64)s << 32) | (uint32_t)~e : 0ull;
  };
  const wide::Group<false> all = {tid, kSelThreads, 0};

  for (int j = tid; j < wide::kBins; j += kSelThreads) hist[j] = 0u;
  if (tid < 5) misc[3 + tid] = 0;
  __syncthreads();
  // every live key when there are no more than r
  const u64 t = wide::count_live(key, n, misc + 3) > r
                    ? wide::group_select(key, n, r, hist, wmm, misc, all)
                    : 1ull;
  // ---- the winners, in any order (their keys are distinct)
  const unsigned lt = (1u << lane) - 1u;
  for (int base = warp * 32; base < n; base += kSelThreads) {
    const int e = base + lane;
    const u64 k = e < n ? key(e) : 0ull;
    const bool take = k != 0ull && k >= t;
    const unsigned tm = __ballot_sync(kFull, take);
    int slot = 0;
    if (lane == 0 && tm) slot = atomicAdd(&misc[5], __popc(tm));
    slot = __shfl_sync(kFull, slot, 0);
    if (take) {
      const int o = slot + __popc(tm & lt);
      wv[o] = wide::key_score((uint32_t)(k >> 32));
      wi[o] = e;
    }
  }
  __syncthreads();
  for (int j = misc[5] + tid; j < P; j += kSelThreads) {
    wv[j] = -INFINITY;
    wi[j] = -1;
  }
  __syncthreads();
  wide::bitonic_desc(wv, wi, P, all);
  for (int j = tid; j < r; j += kSelThreads) {
    const bool hit = wv[j] > -INFINITY;
    out_v[row * r + j] = hit ? wv[j] : -INFINITY;
    out_i[row * r + j] = hit ? wi[j] : -1;
  }
}

// ------------------------------------------------------------------ host

template <int STAGES, int STAGE_FLOATS>
cudaError_t launch_scan(cudaStream_t st, const float* v, const float* nsq,
                        const uint8_t* valid, const float* q,
                        const float* qsq, uint32_t* keys, int S, int n, int d,
                        int B, int sim, int chunk, int n_split) {
  const size_t smem = scan_smem_bytes(STAGES, STAGE_FLOATS, d);
  const auto kernel = knn_large_scan_kernel<STAGES, STAGE_FLOATS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_split, S, (B + kQT - 1) / kQT);
  kernel<<<grid, kThreads, smem, st>>>(v, nsq, valid, q, qsq, keys, n, d, B,
                                       sim, chunk);
  return cudaGetLastError();
}

// The select on `st`: the r best of every (shard, query) row of keys
// [S, B, n], sorted (in sort_[v|i] [S, B, P] where sort_slots(r) = P > 0).
// Returns the first cudaError_t met.
inline cudaError_t launch_select(cudaStream_t st, const uint32_t* keys,
                                 float* sort_v, int* sort_i, float* out_v,
                                 int* out_i, int S, int n, int B, int r) {
  const size_t smem = select_smem_bytes(r);
  const cudaError_t e = cudaFuncSetAttribute(
      knn_large_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  knn_large_select_kernel<<<dim3(B, S), kSelThreads, smem, st>>>(
      keys, sort_v, sort_i, out_v, out_i, n, B, r);
  return cudaGetLastError();
}

// The scan then the select on `st` over the B queries; (stages,
// stage_floats) is the wrapper's ring, chunk (a multiple of 128) and
// n_split its cut of each shard; keys [S, B, n] and, where the winners'
// power of two exceeds kSortSmem, sort_[v|i] [S, B, P] are its scratch.
// Returns the first cudaError_t met.
inline cudaError_t launch_large_pool(cudaStream_t st, const float* v,
                                     const float* nsq, const uint8_t* valid,
                                     const float* q, const float* qsq,
                                     uint32_t* keys, float* sort_v,
                                     int* sort_i, float* out_v, int* out_i,
                                     int S, int n, int d, int B, int r,
                                     int sim, int stages, int stage_floats,
                                     int chunk, int n_split) {
  if (r < 1 || d % 4 != 0 || chunk % pool::kSub != 0 || B < 1 ||
      !wide::known_ring(stages, stage_floats) ||
      (sort_slots(r) && (!sort_v || !sort_i)))
    return cudaErrorInvalidValue;
  cudaError_t e;
  if (stages == 3)
    e = launch_scan<3, 16384>(st, v, nsq, valid, q, qsq, keys, S, n, d, B,
                              sim, chunk, n_split);
  else if (stage_floats == 16384)
    e = launch_scan<2, 16384>(st, v, nsq, valid, q, qsq, keys, S, n, d, B,
                              sim, chunk, n_split);
  else
    e = launch_scan<2, 8192>(st, v, nsq, valid, q, qsq, keys, S, n, d, B,
                             sim, chunk, n_split);
  if (e != cudaSuccess) return e;
  return launch_select(st, keys, sort_v, sort_i, out_v, out_i, S, n, B, r);
}

// smem bytes of the scan at a ring; 0 for a ring with no kernel
inline size_t large_smem_bytes(int stages, int stage_floats, int d) {
  return wide::known_ring(stages, stage_floats)
             ? scan_smem_bytes(stages, stage_floats, d)
             : 0;
}

}  // namespace large
}  // namespace
