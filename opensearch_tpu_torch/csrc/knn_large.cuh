// The large-r tier: K1's fp32 pool scan at r > 1024 (csrc/knn_fused.cu),
// for Hopper (sm_90a). A scan and a select a call: knn_large_scan_kernel
// (every live doc's score key, one u32 a (shard, query, doc)), then the
// multi-CTA select (the r best of each (shard, query) row, sorted): the
// radix passes knn_large_pass_kernel, knn_large_collect_kernel, and the
// sort (knn_large_tile_kernel and knn_large_merge_kernel, or
// knn_large_rank_kernel and knn_large_place_kernel). At bf16 and int8
// knn_large_mma.cuh's tensor-core scan writes the same keys and this select
// follows it unchanged. The earlier one-CTA select,
// knn_large_select_kernel, is kept as the yardstick timed beside it: no
// shape takes it.
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
// The select alone reads the keys once (4SBn) and writes the r winners.
//
// Why not the wide tier's pools: a range of a 2^18-slot shard holds about
// 2,000 docs at one query tile a wave, fewer than r. A range pool of r would
// hold every score it saw, and the ranges' pools together at least n of
// them: as many bytes as the keys here, plus the pools' selects and sorts in
// the scan and the merge's over n_split * r slots. Past r of about 20,000
// even one query's pool leaves no room for a ring. So the scan keeps no pool
// at all: each doc's order-preserving score key (the wide tier's
// score_key; 0 for a dead doc) goes to device memory, coalesced, a lane a
// doc.
//
// Design:
// - Scan: the wide tier's (knn_pool.cuh's Ring, fetch_tile, lane_rows and
//   micro_tile at 8-query tiles, 256 threads, one contiguous range of one
//   shard a CTA, about one wave), with the selection replaced by one store
//   a (doc, query): keys[s, b, doc].
// - Select, G CTAs a row (grid (G, B, S), G at least 2 and about two waves
//   over the B * S rows), on 64-bit keys (the score key above ~doc id:
//   distinct in a shard, so any exact select and sort gives the same bits):
//   three radix levels of 12, 12 and 8 bits of the score key. At each
//   level every CTA histograms the digit of its slice's live keys that
//   match the digits found so far (4,096 bins in shared memory, one atomic
//   a distinct digit a warp) and adds its bins to the row's histogram in
//   device memory; the last CTA of the row to finish (a ticket counter)
//   finds the bin that holds the need-th key from the top, zeroes the
//   histogram and writes the row's prefix and need. A row is decided when
//   that bin holds exactly the keys still needed (or every live key wins:
//   no more than r); later levels return at once. Past the last level the
//   bin's keys tie on their score, and the need of them with the lowest
//   doc ids win: the compaction takes them in doc order, each CTA offset
//   by the ties in the slices before it (the last level keeps every CTA's
//   bins). Every CTA compacts its winners into a [S, B, r] row in any
//   order (a ballot and one atomicAdd a warp). The sort, chosen by the
//   wrapper's plan: a rank by count (each winner's slot is the number of
//   winners with a larger key, counted by CTAs of 1,024 winners over
//   slices of the winners) and a placement; or tiles of 4,096 keys sorted
//   by a bitonic network (its strides below 8 in registers, the rest in
//   shared memory; one tile: written out directly), then merge rounds,
//   each output cut into 2,048-key chunks a CTA at its merge-path
//   diagonals. No level, compaction or sort of a row runs in one CTA past
//   4,096 winners.

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

// The yardstick (the earlier select; it serves no shape): grid (B, S), one
// CTA a row; dynamic shared memory select_smem_bytes(r). The r best of
// row keys[s, b, :] under (score desc, doc id asc), sorted, with (-inf, -1)
// past the live count, to out_[v|i][s, b, :]: the live count, the
// threshold (wide::group_select), the winners compacted, then sorted by a
// bitonic network; where the winners' power of two P exceeds kSortSmem
// they are sorted in sort_[v|i][s, b, :P].
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

// --------------------------------------------------- the multi-CTA select

constexpr int kPassThreads = 256;  // a pass or compaction CTA
constexpr int kPassWarps = kPassThreads / 32;
constexpr int kLevels = 3;         // 12, 12 and 8 bits of the score key
constexpr int kSelBins = 4096;     // bins of a level's digit (12 bits)
constexpr int kLastBins = 256;     // bins of the last level's digit
// a row's state in device memory (ints, zeroed by the wrapper): the prefix
// (low, high word), the keys still needed, decided (0; 1: the keys at or
// above the prefix win; 2: those above the prefix's score and the first
// `need` that tie on it in doc order), the ticket of the level's CTAs, the
// winners compacted, two unused; then its histogram
constexpr int kStateWords = 8 + kSelBins;
constexpr int kTile = 4096;        // keys a tile sort CTA sorts
constexpr int kTileThreads = 512;
constexpr int kTilePer = kTile / kTileThreads;  // keys a tile thread holds
constexpr int kMergeChunk = 2048;  // outputs a merge CTA
constexpr int kMergeThreads = 256;
constexpr int kRankThreads = 256;  // a rank or placement CTA
constexpr int kRankPer = 4;        // winners a rank thread counts for
constexpr int kRankBlock = kRankThreads * kRankPer;  // winners a rank CTA
constexpr int kRankStage = 2048;   // candidates staged in shared memory
constexpr int kSortMerge = 0, kSortRank = 1;

// level L's digit: bits [level_lo(L), level_lo(L) + level_bits(L)) of the
// 64-bit key: 12, 12 and 8 bits of the score key
__host__ __device__ inline int level_bits(int L) { return L == 2 ? 8 : 12; }
__host__ __device__ inline int level_lo(int L) {
  return L == 0 ? 52 : L == 1 ? 40 : 32;
}

__device__ __forceinline__ u64 row_prefix(const int* st) {
  return ((u64)(uint32_t)st[1] << 32) | (uint32_t)st[0];
}

// the 64-bit key of doc e with score key s: 0 for a dead doc
__device__ __forceinline__ u64 doc_key(uint32_t s, int e) {
  return s ? ((u64)s << 32) | (uint32_t)~e : 0ull;
}

// (score, doc id) of a key: (-inf, -1) for 0
__device__ __forceinline__ void put_key(float* ov, int* oi, int o, u64 k) {
  ov[o] = wide::key_score((uint32_t)(k >> 32));
  oi[o] = k ? (int)~(uint32_t)k : -1;
}

// grid (G, B, S): radix level `level` of every undecided row. CTA g
// histograms the level's digit of the live keys of docs [g * chunk,
// min(n, (g + 1) * chunk)) of row (s, b) that match the row's prefix and
// adds its bins to the row's histogram (at the last level it also keeps
// them, slices[s, b, g, :], for the compaction's ties); the row's last CTA
// picks the bin that holds the need-th key from the top (r at level 0)
// and writes the row's state.
__global__ void __launch_bounds__(kPassThreads) knn_large_pass_kernel(
    const uint32_t* __restrict__ keys,  // [S, B, n]
    int* __restrict__ state,            // [S, B, kStateWords]
    int* __restrict__ slices,           // [S, B, G, kLastBins]
    int n, int B, int r, int level, int chunk) {
  const size_t row = (size_t)blockIdx.z * B + blockIdx.y;
  int* st = state + row * kStateWords;
  if (level > 0 && st[3]) return;  // decided at an earlier level
  __shared__ unsigned hist[kSelBins];
  __shared__ int warp_sum[kPassThreads / 32];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const u64 msk = level ? ~((1ull << level_lo(level - 1)) - 1ull) : 0ull;
  const u64 prefix = level ? row_prefix(st) : 0ull;
  const int lo = level_lo(level);
  const unsigned dmask = (1u << level_bits(level)) - 1u;
  for (int j = tid; j < kSelBins; j += kPassThreads) hist[j] = 0u;
  __syncthreads();
  const int start = blockIdx.x * chunk, end = min(n, start + chunk);
  const uint32_t* ks = keys + row * n;
  for (int base = start + warp * 32; base < end; base += kPassThreads) {
    const int e = base + lane;
    const u64 k = doc_key(e < end ? ks[e] : 0u, e);
    const bool in = k != 0ull && (k & msk) == prefix;
    const unsigned am = __ballot_sync(kFull, in);
    if (in) {
      const unsigned dg = (unsigned)(k >> lo) & dmask;
      const unsigned peers = __match_any_sync(am, dg);
      if (lane == __ffs(peers) - 1) atomicAdd(&hist[dg], __popc(peers));
    }
  }
  __syncthreads();
  if (level == kLevels - 1)
    for (int j = tid; j < kLastBins; j += kPassThreads)
      slices[(row * gridDim.x + blockIdx.x) * kLastBins + j] = hist[j];
  unsigned* gh = reinterpret_cast<unsigned*>(st + 8);
  for (int j = tid; j < kSelBins; j += kPassThreads)
    if (hist[j]) atomicAdd(&gh[j], hist[j]);
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(reinterpret_cast<unsigned*>(st + 4), 1u) ==
              gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // ---- the row's last CTA: the histogram, zeroed behind it for the next
  // level; thread t sums the 16 bins [(255 - t) * 16, (256 - t) * 16)
  for (int j = tid; j < kSelBins; j += kPassThreads) {
    hist[j] = __ldcg(gh + j);
    gh[j] = 0u;
  }
  if (tid == 0) st[4] = 0;
  const int need = level ? st[2] : r;  // read before any thread writes it
  __syncthreads();
  constexpr int kPer = kSelBins / kPassThreads;
  const int top = (kPassThreads - tid) * kPer;
  int mine = 0;
#pragma unroll
  for (int j = 1; j <= kPer; ++j) mine += hist[top - j];
  int incl = wide::warp_incl_sum(mine, lane);
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kPassThreads / 32; ++w) {
    if (w < warp) incl += warp_sum[w];
    total += warp_sum[w];
  }
  if (level == 0 && total <= r) {  // every live key wins
    if (tid == 0) {
      st[0] = 1;
      st[1] = 0;
      st[3] = 1;
    }
    return;
  }
  int acc = incl - mine;
  if (acc < need && need <= incl) {
    for (int j = 1; j <= kPer; ++j) {
      const int c = hist[top - j];
      if (acc + c >= need) {
        const int left = need - acc;
        const u64 p = prefix | ((u64)(top - j) << lo);
        st[0] = (int)(uint32_t)p;
        st[1] = (int)(uint32_t)(p >> 32);
        st[2] = left;
        // past the last level the bin's keys tie on their score
        st[3] = c == left ? 1 : level == kLevels - 1 ? 2 : 0;
        break;
      }
      acc += c;
    }
  }
}

// grid (G, B, S): the winners of every row compacted from CTA g's slice
// into win[s, b, :] in any order, one atomicAdd a warp: its keys at or
// above the prefix the levels left; or, where the levels ended on a bin
// of keys that tie on their score, the keys above that score and the
// first `need` of the tied ones in doc order (each CTA offset by the ties
// in the slices before it, counted by the last level).
__global__ void __launch_bounds__(kPassThreads) knn_large_collect_kernel(
    const uint32_t* __restrict__ keys,  // [S, B, n]
    int* __restrict__ state,            // [S, B, kStateWords]
    const int* __restrict__ slices,     // [S, B, G, kLastBins]
    u64* __restrict__ win,              // [S, B, r]
    int n, int B, int r, int chunk) {
  __shared__ int warp_ties[kPassWarps];
  __shared__ int ties_before;
  const size_t row = (size_t)blockIdx.z * B + blockIdx.y;
  int* st = state + row * kStateWords;
  const u64 t = row_prefix(st);
  const bool ties = st[3] == 2;
  const int need = st[2];
  const uint32_t ts = (uint32_t)(t >> 32);  // the tied score key
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int start = blockIdx.x * chunk, end = min(n, start + chunk);
  const uint32_t* ks = keys + row * n;
  u64* w = win + row * r;
  int before = 0;  // ties in earlier docs of the row
  if (ties) {
    if (warp == 0) {
      int c = 0;
      for (int g = lane; g < (int)blockIdx.x; g += 32)
        c += slices[(row * gridDim.x + g) * kLastBins + (ts & 0xFFu)];
      c = __reduce_add_sync(kFull, c);
      if (lane == 0) ties_before = c;
    }
    __syncthreads();
    before = ties_before;
  }
  // every thread runs every step (the ties' block-wide count needs them)
  for (int base = start; base < end; base += kPassThreads) {
    const int e = base + tid;
    const uint32_t s = e < end ? ks[e] : 0u;
    const u64 k = doc_key(s, e);
    bool take = k != 0ull && k >= t;
    if (ties) {
      const bool tie = s == ts;
      const unsigned tb = __ballot_sync(kFull, tie);
      if (lane == 0) warp_ties[warp] = __popc(tb);
      __syncthreads();
      int rank = before + __popc(tb & lt);
      for (int v = 0; v < kPassWarps; ++v) {
        const int c = warp_ties[v];
        if (v < warp) rank += c;
        before += c;
      }
      __syncthreads();
      take = s > ts || (tie && rank < need);
    }
    const unsigned tm = __ballot_sync(kFull, take);
    if (!tm) continue;
    int slot = 0;
    if (lane == 0) slot = atomicAdd(st + 5, __popc(tm));
    slot = __shfl_sync(kFull, slot, 0) + __popc(tm & lt);
    if (take && slot < r) w[slot] = k;
  }
}

// One compare-exchange of the bitonic network: a at index i, b at
// i + stride, in descending order where desc.
__device__ __forceinline__ void cas(u64& a, u64& b, bool desc) {
  if (desc ? a < b : a > b) {
    const u64 t = a;
    a = b;
    b = t;
  }
}

// The network's stages of strides top, top / 2, ..., 1 (below kTilePer)
// of the merges of `size` on one thread's kTilePer consecutive keys k,
// the first at index base: in registers, no barrier.
__device__ __forceinline__ void reg_stages(u64 (&k)[kTilePer], int base,
                                           int size, int top) {
#pragma unroll
  for (int stride = kTilePer / 2; stride > 0; stride >>= 1) {
    if (stride > top) continue;
#pragma unroll
    for (int u = 0; u < kTilePer; ++u)
      if ((u & stride) == 0) cas(k[u], k[u | stride], ((base + u) & size) == 0);
  }
}

// grid (T, B, S): tile t of row (s, b), keys [t * kTile, (t + 1) * kTile)
// of win (the compacted winners, 0 past them), sorted in descending order
// over P slots (a power of two, 32 <= P <= kTile) by a bitonic network:
// the stages of strides below kTilePer in registers, kTilePer consecutive
// keys a thread, the rest in shared memory between barriers. One tile a
// row (r <= P) writes the row's outputs, more write the sorted tile back
// for the merge rounds.
__global__ void __launch_bounds__(kTileThreads) knn_large_tile_kernel(
    const int* __restrict__ state, u64* __restrict__ win,
    float* __restrict__ out_v, int* __restrict__ out_i, int B, int r,
    int P) {
  __shared__ u64 tile[kTile];
  const size_t row = (size_t)blockIdx.z * B + blockIdx.y;
  const int m = state[row * kStateWords + 5];
  const int t0 = blockIdx.x * kTile, tid = threadIdx.x;
  u64* w = win + row * r;
  for (int j = tid; j < P; j += kTileThreads)
    tile[j] = t0 + j < m ? w[t0 + j] : 0ull;
  __syncthreads();
  const int base = tid * kTilePer;
  const bool mine = base < P;
  u64 k[kTilePer];
  if (mine) {
#pragma unroll
    for (int u = 0; u < kTilePer; ++u) k[u] = tile[base + u];
    for (int size = 2; size <= kTilePer; size <<= 1)
      reg_stages(k, base, size, size >> 1);
#pragma unroll
    for (int u = 0; u < kTilePer; ++u) tile[base + u] = k[u];
  }
  __syncthreads();
  for (int size = 2 * kTilePer; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride >= kTilePer; stride >>= 1) {
      for (int t = tid; t < P / 2; t += kTileThreads) {
        const int i = 2 * t - (t & (stride - 1));
        cas(tile[i], tile[i + stride], (i & size) == 0);
      }
      __syncthreads();
    }
    if (mine) {
#pragma unroll
      for (int u = 0; u < kTilePer; ++u) k[u] = tile[base + u];
      reg_stages(k, base, size, kTilePer / 2);
#pragma unroll
      for (int u = 0; u < kTilePer; ++u) tile[base + u] = k[u];
    }
    __syncthreads();
  }
  if (gridDim.x == 1) {
    for (int j = tid; j < r; j += kTileThreads)
      put_key(out_v + row * r, out_i + row * r, j, tile[j]);
  } else {
    for (int j = tid; j < P && t0 + j < r; j += kTileThreads)
      w[t0 + j] = tile[j];
  }
}

// The keys of a (from the top, a first on ties) among the first d of the
// descending merge of a[0, la) and b[0, lb): one thread, binary search.
__device__ __forceinline__ int merge_path(const u64* a, int la, const u64* b,
                                          int lb, int d) {
  int lo = max(0, d - lb), hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] >= b[d - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The same by one warp over device memory: 32 probes a step, then the
// last 32 candidates at once (the probes that take a are a prefix).
__device__ __forceinline__ int warp_merge_path(const u64* a, int la,
                                               const u64* b, int lb, int d,
                                               int lane) {
  int lo = max(0, d - lb), hi = min(d, la);
  while (hi - lo > 32) {
    const int at = lo + (int)((long long)(hi - lo) * lane / 32);
    const int c = __popc(__ballot_sync(kFull, a[at] >= b[d - 1 - at]));
    const int below = __shfl_sync(kFull, at, c > 0 ? c - 1 : 0);
    const int above = __shfl_sync(kFull, at, c < 32 ? c : 31);
    if (c > 0) lo = below + 1;
    if (c < 32) hi = above;
  }
  const int at = lo + lane;
  const bool take = at < hi && a[at] >= b[d - 1 - at];
  return lo + __popc(__ballot_sync(kFull, take));
}

// grid (ceil(r / kMergeChunk), B, S): one merge round over sorted runs of
// w keys of src [S, B, r]: run pairs (2j, 2j + 1) merged, descending,
// into dst, or, on the last round, into the outputs. CTA c writes outputs
// [c * kMergeChunk, (c + 1) * kMergeChunk) of its pair: its cuts by two
// warps' merge-path searches, its inputs staged in shared memory, then 8
// outputs a thread from its own diagonal.
__global__ void __launch_bounds__(kMergeThreads) knn_large_merge_kernel(
    const u64* __restrict__ src, u64* __restrict__ dst,
    float* __restrict__ out_v, int* __restrict__ out_i, int B, int r, int w,
    int last) {
  __shared__ u64 in[kMergeChunk];
  __shared__ u64 res[kMergeChunk];
  __shared__ int cut[2];
  const size_t row = (size_t)blockIdx.z * B + blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int o0 = blockIdx.x * kMergeChunk;
  const int o1 = min(r, o0 + kMergeChunk);
  const int p0 = o0 / (2 * w) * (2 * w);
  const int a1 = min(r, p0 + w), b1 = min(r, p0 + 2 * w);
  const u64* a = src + row * r + p0;
  const u64* b = src + row * r + a1;
  const int la = a1 - p0, lb = b1 - a1;
  if (warp < 2) {
    const int c = warp_merge_path(a, la, b, lb, (warp ? o1 : o0) - p0, lane);
    if (lane == 0) cut[warp] = c;
  }
  __syncthreads();
  const int ia = cut[0], na = cut[1] - cut[0];
  const int ib = o0 - p0 - ia, m = o1 - o0, nb = m - na;
  for (int j = tid; j < m; j += kMergeThreads)
    in[j] = j < na ? a[ia + j] : b[ib + j - na];
  __syncthreads();
  constexpr int kPer = kMergeChunk / kMergeThreads;
  const int d0 = tid * kPer;
  if (d0 < m) {
    int i = merge_path(in, na, in + na, nb, d0), j = d0 - i;
    const int dend = min(m, d0 + kPer);
    for (int d = d0; d < dend; ++d) {
      const bool take_a = j >= nb || (i < na && in[i] >= in[na + j]);
      res[d] = take_a ? in[i++] : in[na + j++];
    }
  }
  __syncthreads();
  for (int j = tid; j < m; j += kMergeThreads) {
    if (last)
      put_key(out_v + row * r, out_i + row * r, o0 + j, res[j]);
    else
      dst[row * r + o0 + j] = res[j];
  }
}

// grid (wb * C, B, S), wb = ceil(r / kRankBlock): CTA (x, s, b) counts,
// for each of the winners [x / C * kRankBlock, + kRankBlock) of row (s, b)
// (kRankPer a thread, in registers), the winners of slice x % C
// ([c * span, (c + 1) * span)) with a larger key, staged through shared
// memory, and adds the counts to their ranks.
__global__ void __launch_bounds__(kRankThreads) knn_large_rank_kernel(
    const int* __restrict__ state, const u64* __restrict__ win,
    unsigned* __restrict__ rank, int B, int r, int C, int span) {
  __shared__ u64 stage[kRankStage];
  const size_t row = (size_t)blockIdx.z * B + blockIdx.y;
  const int m = state[row * kStateWords + 5];
  const int e0 = blockIdx.x / C * kRankBlock, c0 = blockIdx.x % C * span;
  if (e0 >= m || c0 >= m) return;
  const int c1 = min(m, c0 + span);
  const u64* w = win + row * r;
  u64 x[kRankPer];
  unsigned cnt[kRankPer];
#pragma unroll
  for (int u = 0; u < kRankPer; ++u) {
    const int e = e0 + u * kRankThreads + threadIdx.x;
    x[u] = e < m ? w[e] : ~0ull;  // past m: counts nothing
    cnt[u] = 0;
  }
  for (int base = c0; base < c1; base += kRankStage) {
    const int len = min(kRankStage, c1 - base);
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += kRankThreads)
      stage[j] = w[base + j];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const u64 y = stage[j];
#pragma unroll
      for (int u = 0; u < kRankPer; ++u) cnt[u] += y > x[u];
    }
  }
#pragma unroll
  for (int u = 0; u < kRankPer; ++u) {
    const int e = e0 + u * kRankThreads + threadIdx.x;
    if (e < m && cnt[u]) atomicAdd(rank + row * r + e, cnt[u]);
  }
}

// grid (ceil(r / kRankThreads), B, S): winner e of row (s, b) to output
// slot rank[e]; slots past the winners (-inf, -1).
__global__ void __launch_bounds__(kRankThreads) knn_large_place_kernel(
    const int* __restrict__ state, const u64* __restrict__ win,
    const unsigned* __restrict__ rank, float* __restrict__ out_v,
    int* __restrict__ out_i, int B, int r) {
  const size_t row = (size_t)blockIdx.z * B + blockIdx.y;
  const int m = state[row * kStateWords + 5];
  const int e = blockIdx.x * kRankThreads + threadIdx.x;
  if (e >= r) return;
  if (e < m)
    put_key(out_v + row * r, out_i + row * r, rank[row * r + e],
            win[row * r + e]);
  else
    put_key(out_v + row * r, out_i + row * r, e, 0ull);
}

// ------------------------------------------------------------------ host

// bytes of shared memory (all static) the most demanding kernel of the
// multi-CTA select takes, whatever r: the merge's staged inputs and
// outputs, or a tile
__host__ inline size_t multi_select_smem_bytes() {
  const size_t merge = 8 * 2 * (size_t)kMergeChunk + 8;
  const size_t tile = 8 * (size_t)kTile;
  return merge > tile ? merge : tile;
}

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

// The yardstick select on `st`: the r best of every (shard, query) row of
// keys [S, B, n], sorted, one CTA a row (in sort_[v|i] [S, B, P] where
// sort_slots(r) = P > 0). Returns the first cudaError_t met.
inline cudaError_t launch_select_yardstick(cudaStream_t st,
                                           const uint32_t* keys,
                                           float* sort_v, int* sort_i,
                                           float* out_v, int* out_i, int S,
                                           int n, int B, int r) {
  if (r < 1 || B < 1 || (sort_slots(r) && (!sort_v || !sort_i)))
    return cudaErrorInvalidValue;
  const size_t smem = select_smem_bytes(r);
  const cudaError_t e = cudaFuncSetAttribute(
      knn_large_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  knn_large_select_kernel<<<dim3(B, S), kSelThreads, smem, st>>>(
      keys, sort_v, sort_i, out_v, out_i, n, B, r);
  return cudaGetLastError();
}

// The multi-CTA select on `st`: the r best of every (shard, query) row of
// keys [S, B, n], sorted, to out_[v|i] [S, B, r]. G CTAs a row, each a
// slice of chunk docs (G * chunk >= n); state [S, B, kStateWords] zeroed
// by the caller; slices [S, B, G, kLastBins] the last level's histograms;
// win [S, B, r] the compacted winners; sort kSortMerge
// (tmp [S, B, r] where r > kTile) or kSortRank (rank [S, B, r] zeroed by
// the caller, C slices of the winners a rank CTA). Returns the first
// cudaError_t met.
inline cudaError_t launch_multi_select(cudaStream_t st, const uint32_t* keys,
                                       int* state, int* slices, u64* win,
                                       u64* tmp, unsigned* rank, float* out_v,
                                       int* out_i, int S, int n, int B, int r,
                                       int G, int chunk, int sort, int C) {
  if (r < 1 || B < 1 || G < 1 || chunk < 1 || (long long)G * chunk < n ||
      !state || !slices || !win ||
      (sort == kSortMerge && r > kTile && !tmp) ||
      (sort == kSortRank && (!rank || C < 1)) ||
      (sort != kSortMerge && sort != kSortRank))
    return cudaErrorInvalidValue;
  const dim3 rows(G, B, S);
  for (int level = 0; level < kLevels; ++level) {
    knn_large_pass_kernel<<<rows, kPassThreads, 0, st>>>(
        keys, state, slices, n, B, r, level, chunk);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  knn_large_collect_kernel<<<rows, kPassThreads, 0, st>>>(
      keys, state, slices, win, n, B, r, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (sort == kSortRank) {
    const int wb = (r + kRankBlock - 1) / kRankBlock;
    const int span = (r + C - 1) / C;
    knn_large_rank_kernel<<<dim3(wb * C, B, S), kRankThreads, 0, st>>>(
        state, win, rank, B, r, C, span);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int pb = (r + kRankThreads - 1) / kRankThreads;
    knn_large_place_kernel<<<dim3(pb, B, S), kRankThreads, 0, st>>>(
        state, win, rank, out_v, out_i, B, r);
    return cudaGetLastError();
  }
  const int T = (r + kTile - 1) / kTile;
  const int P = T == 1 ? wide::pow2_at_least(r) : kTile;
  knn_large_tile_kernel<<<dim3(T, B, S), kTileThreads, 0, st>>>(
      state, win, out_v, out_i, B, r, P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const u64* src = win;
  u64* dst = tmp;
  for (int w = kTile; w < r; w *= 2) {
    const int last = w >= r - w;  // this round's runs cover the row
    knn_large_merge_kernel<<<dim3((r + kMergeChunk - 1) / kMergeChunk, B, S),
                             kMergeThreads, 0, st>>>(src, dst, out_v, out_i,
                                                     B, r, w, last);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    u64* done = dst;
    dst = const_cast<u64*>(src);
    src = done;
  }
  return cudaSuccess;
}

// The scan alone on `st` over the B queries: keys [S, B, n]; (stages,
// stage_floats) is the wrapper's ring, chunk (a multiple of 128) and
// n_split its cut of each shard. Returns the first cudaError_t met.
inline cudaError_t launch_large_scan(cudaStream_t st, const float* v,
                                     const float* nsq, const uint8_t* valid,
                                     const float* q, const float* qsq,
                                     uint32_t* keys, int S, int n, int d,
                                     int B, int sim, int stages,
                                     int stage_floats, int chunk,
                                     int n_split) {
  if (d % 4 != 0 || chunk % pool::kSub != 0 || B < 1 ||
      !wide::known_ring(stages, stage_floats))
    return cudaErrorInvalidValue;
  if (stages == 3)
    return launch_scan<3, 16384>(st, v, nsq, valid, q, qsq, keys, S, n, d, B,
                                 sim, chunk, n_split);
  if (stage_floats == 16384)
    return launch_scan<2, 16384>(st, v, nsq, valid, q, qsq, keys, S, n, d, B,
                                 sim, chunk, n_split);
  return launch_scan<2, 8192>(st, v, nsq, valid, q, qsq, keys, S, n, d, B,
                              sim, chunk, n_split);
}

// smem bytes of the scan at a ring; 0 for a ring with no kernel
inline size_t large_smem_bytes(int stages, int stage_floats, int d) {
  return wide::known_ring(stages, stage_floats)
             ? scan_smem_bytes(stages, stage_floats, d)
             : 0;
}

}  // namespace large
}  // namespace
