// The wide tier of the list scan: K1's fp32 pool scan at 32 < r <= 1024
// (csrc/knn_fused.cu) and K3 at 32 < k <= 1024 (csrc/knn_block.cu), for
// Hopper (sm_90a). Two kernels a call: knn_wide_scan_kernel (the scan, one
// pool per (range, query)) and knn_wide_merge_kernel (the split merge).
//
// Replaces, at these shapes: opensearch_tpu/ops/pallas_knn.py::
// _knn_fused_kernel (:675, launched by pallas_knn_fused at :785) and
// ::_knn_block_kernel (:53, launched by pallas_knn_topk at :181). Contract,
// the same as the list scan's (knn_pool.cuh): for every shard s and query
// b, the r best docs of the shard under (score desc, doc id asc), with
// (-inf, -1) in the slots past the shard's live count. fp32 only: every
// dot sums its d products in ascending order in one f32 accumulator, on
// FFMA, never TF32; the transform rounds after every operation (the _rn
// intrinsics under -fmad=false), as the plain PyTorch version does.
//
// Bound: the slab once (4Snd bytes), norms and valid flags (5Sn), against
// 2*B*S*n*d FFMA operations: bytes up to about B = 80 at d = 128,
// operations above.
//
// Design:
// - Scan: the list scan's (its Ring, fetch_tile, lane_rows and micro_tile
//   in knn_pool.cuh), at a query tile of 8 (256 threads): each warp
//   scores one 128-doc sub-block of a 1024-doc step against the tile's 8
//   queries with a 4-doc x 8-query FFMA register micro-tile; doc tiles
//   arrive through a ring of cp.async 16-byte copies, rows XOR-swizzled in
//   16-byte units, d cut into chunks; each CTA takes one contiguous range
//   of one shard (128-doc multiples, about one wave in all). Batches above
//   8 take more query tiles (grid z), whose CTAs walk the same ranges
//   together, so a doc tile comes from device memory about once and from
//   L2 for the others: a wider tile would not fit the pools and buffers.
// - Selection: each query keeps, in shared memory, a pool of the r best
//   (score, doc id) pairs found so far in the range and a buffer of
//   candidates. A doc passes the list scan's conservative pre-transform
//   filter (loose by 2^-12) against the pool's r-th score (-inf until the
//   pool holds r), is transformed and appended: one ballot a warp and one
//   atomicAdd a warp a query. After a step's appends each query's group of
//   warps (all eight for one query, one each from five queries, under a
//   named barrier) flushes its buffer into its pool when the pool can
//   fill, when the next step could overflow the buffer (the wrapper's plan
//   gives it at least one step's 1024 docs), and at the range's end: an
//   exact radix select (8-bit passes from the highest bit in which the
//   largest and least key differ, one warp finding the bin) over 64-bit
//   keys, the score's order-preserving key (-0.0 as +0.0) above ~doc id,
//   keeps exactly the r best, since doc ids are unique in a shard: no tie
//   is left for the position order, so appends may land in any order. The
//   pool's least key then raises the filter's bound. At the range's end
//   the group sorts its pool by the same key (a bitonic network in the
//   emptied buffer) and writes r slots. The selection (Sel, init_sel,
//   append_passers, flush_when_due, write_pool) and the merge serve the
//   tensor-core scan of knn_wide_mma.cuh too (K1 at bf16 and int8).
// - Why not the list scan's per-warp lists of r: at 8 queries a range of
//   about 7,600 docs (SIFT-1M shape) gives each warp some 950, and a list
//   of r = 128 would take about r (1 + ln(950 / r)) = 390 inserts, one at a
//   time, each between two barriers of the ring; one CTA-wide bound lets
//   about r (1 + ln(7600 / r)) = 650 docs a query through, appended in
//   parallel, with a select or two a range.
// - Split merge: one 512-thread CTA a (query, shard) over the ranges'
//   sorted pools. The r-th best key of the pools' first few slots (four
//   times a fair share of r each) bounds the r-th best of all from below;
//   each pool's slots at or above it are a prefix, found in two probes a
//   warp; those candidates, staged in shared memory, go through the same
//   radix select block-wide, the winners are compacted (in any order: their
//   keys are distinct) and sorted by a bitonic network; (-inf, -1) past the
//   live count. At the SIFT-1M shape and r = 1024 that reads about 4,200
//   and then a few thousand of the 134,000 slots; where the prefixes do
//   not fit shared memory every slot is read from device memory instead.

#pragma once

#include "knn_pool.cuh"

namespace {
namespace wide {

using pool::kSub;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 8;                // queries a CTA
constexpr int kSD = kWarps * kSub;    // docs a step (1024)
constexpr int kMaxR = 1024;
constexpr int kBins = 256;

// the ring: STAGES stages of STAGE_FLOATS floats, each one step's docs
// times a d chunk (pool::Ring, as the list scan's)
template <int STAGES, int STAGE_FLOATS>
using Ring = pool::Ring<kSD, STAGES, STAGE_FLOATS>;

// ------------------------------------------------------------- keys

// the order-preserving key of a score: -0.0 as +0.0, -inf as 0
__device__ __forceinline__ uint32_t score_key(float s) {
  if (s == -INFINITY) return 0u;
  const uint32_t u = s == 0.0f ? 0u : __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(uint32_t k) {
  if (k == 0u) return -INFINITY;
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// (score desc, doc id asc) as one key, larger is better; (-inf, -1) is 0
__device__ __forceinline__ u64 pair_key(float v, int id) {
  return ((u64)score_key(v) << 32) | (uint32_t)~id;
}

__device__ __forceinline__ u64 max64(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 min64(u64 a, u64 b) { return a < b ? a : b; }

__device__ __forceinline__ u64 warp_max64(u64 x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = max64(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ u64 warp_min64(u64 x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = min64(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ int warp_incl_sum(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// ------------------------------------------------------- the select

struct Pick {
  int digit, above, in_digit;
};

// One warp over the 256 bins of hist, lane l owning the 8 bins
// [(31 - l) * 8, (32 - l) * 8), from the top down: the bin where the count
// from the top reaches `need`, the keys in higher bins, and the bin's count,
// to every lane.
__device__ __forceinline__ Pick warp_pick(const unsigned* hist, int need,
                                          int lane) {
  const int top = (32 - lane) * 8;
  int mine = 0;
#pragma unroll
  for (int j = 1; j <= 8; ++j) mine += hist[top - j];
  const int incl = warp_incl_sum(mine, lane);
  int acc = incl - mine;
  const int src =
      __ffs(__ballot_sync(kFull, acc < need && need <= incl)) - 1;
  Pick p = {0, 0, 0};
  if (lane == src) {
    for (int j = 1; j <= 8; ++j) {
      const int c = hist[top - j];
      if (acc + c >= need) {
        p = Pick{top - j, acc, c};
        break;
      }
      acc += c;
    }
  }
  p.digit = __shfl_sync(kFull, p.digit, src);
  p.above = __shfl_sync(kFull, p.above, src);
  p.in_digit = __shfl_sync(kFull, p.in_digit, src);
  return p;
}

// The histogram of one radix pass: the digit (k >> shift) & dmask of every
// nonzero key k of key(0..m) whose bits under msk equal prefix, counted into
// hist by the threads [0, nt) of a warp-strided loop (lane, warp, nt), one
// shared atomic a distinct digit a warp.
template <class Key>
__device__ __forceinline__ void radix_pass(Key key, int m, u64 msk,
                                           u64 prefix, int shift,
                                           unsigned dmask, unsigned* hist,
                                           int lane, int warp, int nt) {
  for (int base = warp * 32; base < m; base += nt) {
    const int i = base + lane;
    const u64 k = i < m ? key(i) : 0ull;
    const bool in = k != 0ull && (k & msk) == prefix;
    const unsigned am = __ballot_sync(kFull, in);
    if (in) {
      const unsigned dg = (unsigned)(k >> shift) & dmask;
      const unsigned peers = __match_any_sync(am, dg);
      if (lane == __ffs(peers) - 1) atomicAdd(&hist[dg], __popc(peers));
    }
  }
}

// The first bits of a select: the highest bit in which kmax and kmin
// differ, the mask above it and the prefix every key shares there.
__device__ __forceinline__ int select_start(u64 kmax, u64 kmin, u64* msk,
                                            u64* prefix) {
  const int hi = 63 - __clzll((long long)(kmax ^ kmin));
  *msk = hi == 63 ? 0ull : ~((2ull << hi) - 1ull);
  *prefix = kmax & *msk;
  return hi;
}

// The threads [0, size()) of a group, as gt, and the barrier that orders
// them: one warp (ONE), or a few warps of a CTA under named barrier id, or
// the whole CTA (id 0). A warp's group is its own type, so its loops and
// barriers compile to a warp's.
template <bool ONE>
struct Group {
  int gt, nt, id;
  __device__ __forceinline__ int size() const { return ONE ? 32 : nt; }
  __device__ __forceinline__ int lane() const { return gt & 31; }
  __device__ __forceinline__ int warp() const { return ONE ? 0 : gt >> 5; }
  __device__ __forceinline__ void sync() const {
    if (ONE)
      __syncwarp();
    else if (id == 0)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nt) : "memory");
  }
};

// The threshold t of the `want` largest of the nonzero keys of key(0..m),
// which are distinct and more than `want`: exactly `want` of them are
// >= t. Run by every thread of the group g; hist (256 bins) is zero on
// entry and on return; wmm (two keys a warp) and pick (three ints) are the
// group's scratch. Passes of 8 bits from the highest bit in which the
// largest and the least key differ, until the bin that holds the want-th
// key is kept whole; one warp finds the bin.
template <class Key, bool ONE>
__device__ u64 group_select(Key key, int m, int want, unsigned* hist,
                            u64* wmm, int* pick, const Group<ONE>& g) {
  const int lane = g.lane(), gw = g.warp(), nw = g.size() >> 5;
  u64 kmax = 0ull, kmin = ~0ull;
  for (int i = g.gt; i < m; i += g.size()) {
    const u64 k = key(i);
    if (k != 0ull) {
      kmax = max64(kmax, k);
      kmin = min64(kmin, k);
    }
  }
  kmax = warp_max64(kmax);
  kmin = warp_min64(kmin);
  if (nw > 1) {
    if (lane == 0) {
      wmm[2 * gw] = kmax;
      wmm[2 * gw + 1] = kmin;
    }
    g.sync();
    for (int w = 0; w < nw; ++w) {
      kmax = max64(kmax, wmm[2 * w]);
      kmin = min64(kmin, wmm[2 * w + 1]);
    }
  }
  u64 msk, prefix;
  int hi = select_start(kmax, kmin, &msk, &prefix);
  int need = want;
  for (;;) {
    const int w = hi + 1 < 8 ? hi + 1 : 8;
    const int shift = hi + 1 - w;
    const unsigned dmask = (1u << w) - 1u;
    radix_pass(key, m, msk, prefix, shift, dmask, hist, lane, gw, g.size());
    g.sync();
    if (gw == 0) {
      const Pick p = warp_pick(hist, need, lane);
      if (lane == 0) {
        pick[0] = p.digit;
        pick[1] = p.above;
        pick[2] = p.in_digit;
      }
      __syncwarp();
      for (int j = lane; j < kBins; j += 32) hist[j] = 0u;
    }
    g.sync();
    need -= pick[1];
    prefix |= (u64)pick[0] << shift;
    msk |= (u64)dmask << shift;
    if (pick[2] == need || shift == 0) return prefix;
    hi = shift - 1;
  }
}

// Keep the pairs of pool (pn) then buffer (cn) whose key is >= t, in that
// order, at the front of the pool; returns the least key kept. One warp. A
// pair is read before the ballot and written after it, at a position no
// later than its own, so the pool compacts in place.
__device__ u64 warp_keep(float* pv, int* pi, int pn, const float* bv,
                         const int* bi, int cn, u64 t, int lane) {
  const int m = pn + cn;
  const unsigned lt = (1u << lane) - 1u;
  int out = 0;
  u64 kmin = ~0ull;
  for (int base = 0; base < m; base += 32) {
    const int i = base + lane;
    float v = -INFINITY;
    int id = -1;
    if (i < m) {
      v = i < pn ? pv[i] : bv[i - pn];
      id = i < pn ? pi[i] : bi[i - pn];
    }
    const u64 k = pair_key(v, id);
    const bool keep = i < m && k >= t;
    const unsigned bal = __ballot_sync(kFull, keep);
    if (keep) {
      const int o = out + __popc(bal & lt);
      pv[o] = v;
      pi[o] = id;
      kmin = min64(kmin, k);
    }
    out += __popc(bal);
  }
  __syncwarp();
  return warp_min64(kmin);
}

// Flush one query's buffer (cn pairs) into its pool (pn pairs) with the
// group g: the r best of both stay in the pool (the select by the whole
// group, the compaction by its first warp), the buffer empties, and once
// the pool holds r the filter's bound (*low, ord_int) rises to the least
// goodness that may beat or tie its r-th score.
template <bool ONE>
__device__ void flush(float* pv, int* pi, const float* bv, const int* bi,
                      int pn, int cn, int* pool_n, int* cnt, int* low, int r,
                      float qn, int sim, unsigned* hist, u64* wmm, int* pick,
                      const Group<ONE>& g) {
  const int m = pn + cn;
  u64 t = 0ull;
  if (m > r) {
    const auto key = [&](int i) {
      return i < pn ? pair_key(pv[i], pi[i]) : pair_key(bv[i - pn], bi[i - pn]);
    };
    t = group_select(key, m, r, hist, wmm, pick, g);
  }
  if (g.warp() == 0) {
    const u64 kmin = warp_keep(pv, pi, pn, bv, bi, cn, t, g.lane());
    if (g.lane() == 0) {
      *pool_n = m < r ? m : r;
      *cnt = 0;
      if (m >= r)
        *low = pool::ord_int(pool::threshold_goodness(
            key_score((uint32_t)(kmin >> 32)), qn, sim));
    }
  }
}

// Sort P (a power of two) pairs in shared memory into descending key order
// with the group g (a bitonic network).
template <bool ONE>
__device__ void bitonic_desc(float* sv, int* si, int P, const Group<ONE>& g) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = g.gt; t < P / 2; t += g.size()) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const u64 ki = pair_key(sv[i], si[i]), kj = pair_key(sv[j], si[j]);
        if ((i & size) == 0 ? ki < kj : ki > kj) {
          const float tv = sv[i];
          const int ti = si[i];
          sv[i] = sv[j];
          si[i] = si[j];
          sv[j] = tv;
          si[j] = ti;
        }
      }
      g.sync();
    }
  }
}

__host__ __device__ inline int pow2_at_least(int r) {
  int p = 32;
  while (p < r) p <<= 1;
  return p;
}

// ------------------------------------------------------------- the scan

__host__ __device__ inline int chunked_width(int stage_floats, int d) {
  const int dc = stage_floats / kSD;
  return (d + dc - 1) / dc * dc;
}

// words of shared memory the selection takes (after a scan's ring and
// query tile): a select's scratch a warp (two keys, four ints), |q|^2,
// |q|, the bound, the buffer count and the pool count a query, a 256-bin
// histogram a warp, and rows = min(8, B) queries' pools of r and buffers
// of cap pairs
__host__ __device__ inline size_t sel_words(int r, int rows, int cap) {
  return 8 * kWarps + 5 * kQT + kWarps * kBins +
         2 * (size_t)rows * (r + cap);
}

// bytes of dynamic shared memory one scan CTA needs: the ring, the query
// tile and the selection
__host__ inline size_t scan_smem_bytes(int stages, int stage_floats, int d,
                                       int r, int rows, int cap) {
  return 4 * ((size_t)stages * stage_floats +
              (size_t)kQT * chunked_width(stage_floats, d) +
              sel_words(r, rows, cap));
}

// warps a query's selection takes in a CTA of qb queries: all eight for
// one query, one each from five
__device__ __forceinline__ int group_warps(int qb) {
  return qb == 1 ? 8 : qb == 2 ? 4 : qb <= 4 ? 2 : 1;
}

// The selection of one scan CTA (this tier's and knn_wide_mma.cuh's), in
// shared memory at base: sel_words(r, rows, cap) words.
struct Sel {
  u64* wmm;        // [8][2] select keys
  int* pick;       // [8][4]
  float* qsq;      // [8]
  float* qn;       // [8] |q|
  int* low;        // [8] the filter's bound (ord_int)
  int* cnt;        // [8] buffer counts
  int* pn;         // [8] pool counts
  unsigned* hist;  // [8][256]
  float* pool_v;   // [rows][r]
  int* pool_i;
  float* buf_v;    // [rows][cap]
  int* buf_i;
};

__device__ __forceinline__ Sel carve_sel(float* base, int rows, int r,
                                         int cap) {
  Sel s;
  s.wmm = reinterpret_cast<u64*>(base);
  s.pick = reinterpret_cast<int*>(s.wmm + 2 * kWarps);
  s.qsq = reinterpret_cast<float*>(s.pick + 4 * kWarps);
  s.qn = s.qsq + kQT;
  s.low = reinterpret_cast<int*>(s.qn + kQT);
  s.cnt = s.low + kQT;
  s.pn = s.cnt + kQT;
  s.hist = reinterpret_cast<unsigned*>(s.pn + kQT);
  s.pool_v = reinterpret_cast<float*>(s.hist + kWarps * kBins);
  s.pool_i = reinterpret_cast<int*>(s.pool_v + rows * r);
  s.buf_v = reinterpret_cast<float*>(s.pool_i + rows * r);
  s.buf_i = reinterpret_cast<int*>(s.buf_v + rows * cap);
  return s;
}

// |q|^2 and |q| of the CTA's qb queries from q0 (0 past them), empty pools
// and buffers, the bounds at -inf, the histograms zero; by the CTA's
// threads
__device__ __forceinline__ void init_sel(const Sel& s, const float* qsq,
                                         int q0, int qb, int tid) {
  for (int e = tid; e < kQT; e += kThreads) {
    const float x = e < qb ? qsq[q0 + e] : 0.0f;
    s.qsq[e] = x;
    s.qn[e] = __fsqrt_rn(fmaxf(x, 1e-24f));
    s.low[e] = pool::ord_int(-INFINITY);
    s.cnt[e] = 0;
    s.pn[e] = 0;
  }
  for (int e = tid; e < kWarps * kBins; e += kThreads) s.hist[e] = 0u;
}

// A warp's passers of one step, appended to their queries' buffers: this
// lane's docs doc[i] (live where ok[i]), with norms ns[i] and dots
// acc[i][u] against the CTA's query u < qb. A doc passes the filter
// against query u's bound and is appended with its transformed score: one
// ballot a doc row and one atomicAdd a warp a query.
__device__ __forceinline__ void append_passers(
    const Sel& s, const float (&acc)[4][8], const bool (&ok)[4],
    const float (&ns)[4], const int (&doc)[4], int qb, int cap, int sim,
    int lane) {
  float rvn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (sim == SIM_COSINE) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      rvn[i] = __frcp_rn(__fsqrt_rn(fmaxf(ns[i], 1e-24f)));
  }
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    if (u >= qb) break;
    const float qq = s.qsq[u];
    const float lower = pool::ord_float(s.low[u]);
    bool pass[4];
    unsigned mk[4];
    int total = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pass[i] = ok[i] &&
                pool::goodness(acc[i][u], qq, ns[i], rvn[i], sim) >= lower;
      mk[i] = __ballot_sync(kFull, pass[i]);
      total += __popc(mk[i]);
    }
    if (total == 0) continue;
    int at = 0;
    if (lane == 0) at = atomicAdd(&s.cnt[u], total);
    at = __shfl_sync(kFull, at, 0);
    float* bv = s.buf_v + u * cap;
    int* bi = s.buf_i + u * cap;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (pass[i]) {
        const int o = at + __popc(mk[i] & lt);
        bv[o] = transform_score(acc[i][u], qq, ns[i], sim);
        bi[o] = doc[i];
      }
      at += __popc(mk[i]);
    }
  }
}

// The warps [sq * G, (sq + 1) * G) of the CTA select for query sq, under
// named barrier 1 + sq when G > 1: its group, one warp's or several's.
template <class F>
__device__ __forceinline__ void as_group(int G, int sq, int warp, int lane,
                                         F&& f) {
  if (G == 1) {
    f(Group<true>{lane, 32, 0});
  } else {
    f(Group<false>{(warp - sq * G) * 32 + lane, 32 * G, 1 + sq});
  }
}

// After a step's appends (and a barrier): query sq's group flushes its
// buffer into its pool when the pool can fill, when the next step could
// overflow the buffer, and at the range's end (last).
__device__ __forceinline__ void flush_when_due(const Sel& s, int sq, int qb,
                                               bool last, int r, int cap,
                                               int sim, int G, int warp,
                                               int lane) {
  if (sq >= qb) return;
  const int pn = s.pn[sq], cn = s.cnt[sq];
  if (cn > 0 && (last || cn > cap - kSD || (pn < r && pn + cn >= r))) {
    as_group(G, sq, warp, lane, [&](const auto& g) {
      flush(s.pool_v + sq * r, s.pool_i + sq * r, s.buf_v + sq * cap,
            s.buf_i + sq * cap, pn, cn, s.pn + sq, s.cnt + sq, s.low + sq, r,
            s.qn[sq], sim, s.hist + sq * G * kBins, s.wmm + 2 * sq * G,
            s.pick + 4 * sq * G, g);
    });
  }
}

// The range's end: query sq's group sorts its pool in the emptied buffer
// (padded with (-inf, -1) to a power of two) and writes its r slots to
// out_v / out_i.
__device__ __forceinline__ void write_pool(const Sel& s, int sq, int qb,
                                           int r, int cap, int G, int warp,
                                           int lane, float* out_v,
                                           int* out_i) {
  if (sq >= qb) return;
  const int pn = s.pn[sq], P = pow2_at_least(r);
  float* sv = s.buf_v + sq * cap;
  int* si = s.buf_i + sq * cap;
  as_group(G, sq, warp, lane, [&](const auto& g) {
    for (int j = g.gt; j < P; j += g.size()) {
      sv[j] = j < pn ? s.pool_v[sq * r + j] : -INFINITY;
      si[j] = j < pn ? s.pool_i[sq * r + j] : -1;
    }
    g.sync();
    bitonic_desc(sv, si, P, g);
    for (int j = g.gt; j < r; j += g.size()) {
      out_v[j] = sv[j];
      out_i[j] = si[j];
    }
  });
}

// grid (n_split, S, ceil(B / 8)); dynamic shared memory scan_smem_bytes.
// CTA (split, s, z) scans docs [split * chunk, min(n, (split + 1) * chunk))
// of shard s against queries [8z, min(B, 8z + 8)) and writes each query's
// r best, sorted, to part_[v|i][s, split, b, :].
template <int STAGES, int STAGE_FLOATS>
__global__ void __launch_bounds__(kThreads, 1) knn_wide_scan_kernel(
    const float* __restrict__ v,        // [S, n, d] f32, d % 4 == 0
    const float* __restrict__ nsq,      // [S, n]
    const uint8_t* __restrict__ valid,  // [S, n] 0 / 1
    const float* __restrict__ q,        // [B, d] f32
    const float* __restrict__ qsq,      // [B]
    float* __restrict__ part_v,         // [S, n_split, B, r]
    int* __restrict__ part_i,           // [S, n_split, B, r]
    int n, int d, int B, int r, int cap, int sim, int chunk, int n_split) {
  using R = Ring<STAGES, STAGE_FLOATS>;
  const int split = blockIdx.x, shard = blockIdx.y;
  const int NC = (d + R::kDC - 1) / R::kDC;
  const int dp = NC * R::kDC;
  const int q0 = blockIdx.z * kQT;
  const int qb = min(kQT, B - q0);
  const int rows = min(kQT, B);
  const int start = split * chunk;
  const int end = min(n, start + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* vs = v + (size_t)shard * n * d;
  const float* nss = nsq + (size_t)shard * n;
  const uint8_t* oks = valid + (size_t)shard * n;

  extern __shared__ __align__(16) float wide_smem[];
  float* ring = wide_smem;                       // [STAGES][kSD][kDC]
  float* qs = ring + STAGES * STAGE_FLOATS;      // [8][dp]
  const Sel sel = carve_sel(qs + kQT * dp, rows, r, cap);

  for (int e = tid; e < kQT * dp; e += kThreads) {
    const int row = e / dp, col = e - row * dp;
    qs[e] = (row < qb && col < d) ? q[(size_t)(q0 + row) * d + col] : 0.0f;
  }
  init_sel(sel, qsq, q0, qb, tid);

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
  pool::lane_rows<R>(warp * kSub, lane, roff, rsw);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.0f;
  float ns[4];
  bool ok[4];

  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  // the warps [sq * G, (sq + 1) * G) select for query sq
  const int G = group_warps(qb);
  const int sq = warp / G;

  int c = 0, step = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int docb = start + step * kSD + warp * kSub;
    // a sub-block wholly past the range's end: nothing to score
    const bool busy = docb < end;
    if (c == 0) {  // the step's norms and flags, used after its last chunk
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int doc = docb + lane + 32 * i;
        ok[i] = doc < end && oks[doc] != 0;
        ns[i] = doc < end ? nss[doc] : 0.0f;
      }
    }
    pool::cp_async_wait<STAGES - 2>();
    __syncthreads();
    fetch(t + STAGES - 1);

    const float* st = ring + (t % STAGES) * STAGE_FLOATS;
    const float* qg = qs + c * R::kDC;
    if (busy) pool::micro_tile<R>(acc, st, roff, rsw, qg, dp);
    if (++c < NC) continue;
    c = 0;
    const bool last = ++step == n_steps;

    // ---- the step's passers, appended to their queries' buffers
    if (busy) {
      const int doc[4] = {docb + lane, docb + lane + 32, docb + lane + 64,
                          docb + lane + 96};
      append_passers(sel, acc, ok, ns, doc, qb, cap, sim, lane);
    }
    __syncthreads();
    // ---- query sq's group of warps flushes its buffer when due
    flush_when_due(sel, sq, qb, last, r, cap, sim, G, warp, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[i][u] = 0.0f;
  }
  pool::cp_async_wait<0>();
  __syncthreads();

  // ---- the range's end: each query's sorted pool, r slots
  const size_t o = (((size_t)shard * n_split + split) * B + q0 + sq) * r;
  write_pool(sel, sq, qb, r, cap, G, warp, lane, part_v + o, part_i + o);
}

// ------------------------------------------------------ the split merge

constexpr int kMergeThreads = 512;
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kMergeStage = 16384;  // stage-2 candidates in shared memory

// the first slots of every range's sorted pool that stage 1 of the merge
// reads: four times a fair share of r
__host__ __device__ inline int merge_prefix(int n_split, int r) {
  const int t = 4 * ((r + n_split - 1) / n_split);
  return t < r ? t : r;
}

__host__ __device__ inline int merge_cap(int n_split, int r) {
  return n_split * r < kMergeStage ? n_split * r : kMergeStage;
}

__host__ inline size_t merge_smem_bytes(int n_split, int r) {
  return 8 * 2 * (size_t)kMergeWarps +
         4 * ((size_t)kBins + 8 + n_split + 1) +
         8 * (size_t)pow2_at_least(r) +
         8 * (size_t)n_split * merge_prefix(n_split, r) +
         8 * (size_t)merge_cap(n_split, r);
}

// The live (nonzero) keys of key(0..m), counted by the whole CTA into
// *count (zero on entry); ends on a barrier.
template <class Key>
__device__ int count_live(Key key, int m, int* count) {
  int live = 0;
  for (int e = threadIdx.x; e < m; e += kMergeThreads) live += key(e) != 0ull;
  live = __reduce_add_sync(kFull, live);
  if ((threadIdx.x & 31) == 0) atomicAdd(count, live);
  __syncthreads();
  return *count;
}

// grid (B, S); dynamic shared memory merge_smem_bytes(n_split, r). The r
// best of the n_split sorted pools of one (shard, query) under (score desc,
// doc id asc); (-inf, -1) past the live count. Stage 1: the pools' first
// merge_prefix slots, staged in shared memory, and their r-th best key t0,
// a lower bound of the r-th best of all (the r best of a subset are no
// better). Stage 2: the slots of each pool at or above t0, a prefix of it,
// counted in the staged slots and, for a pool whose staged slots all pass,
// in device memory by two probes of a warp; those candidates staged again
// (from the first stage where it holds them) and the r best of them by the
// same select; where they do not fit, the r best of every slot, read from
// device memory.
__global__ void __launch_bounds__(kMergeThreads) knn_wide_merge_kernel(
    const float* __restrict__ part_v,  // [S, n_split, B, r]
    const int* __restrict__ part_i,
    float* __restrict__ out_v,         // [S, B, r]
    int* __restrict__ out_i,
    int n_split, int B, int r) {
  const int b = blockIdx.x, shard = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = pow2_at_least(r), cap = merge_cap(n_split, r);
  const int pre = merge_prefix(n_split, r), ma = n_split * pre;
  extern __shared__ __align__(16) u64 wide_merge_smem[];
  u64* wmm = wide_merge_smem;                                  // [16][2]
  unsigned* hist = reinterpret_cast<unsigned*>(wmm + 2 * kMergeWarps);
  int* misc = reinterpret_cast<int*>(hist + kBins);  // pick[3], counts
  int* off = misc + 8;                               // [n_split + 1]
  float* wv = reinterpret_cast<float*>(off + n_split + 1);  // [P] winners
  int* wi = reinterpret_cast<int*>(wv + P);
  float* av = reinterpret_cast<float*>(wi + P);             // [ma] stage 1
  int* ai = reinterpret_cast<int*>(av + ma);
  float* sv = reinterpret_cast<float*>(ai + ma);            // [cap] stage 2
  int* si = reinterpret_cast<int*>(sv + cap);
  const Group<false> all = {tid, kMergeThreads, 0};
  const auto at = [&](int p, int j) {
    return (((size_t)shard * n_split + p) * B + b) * r + j;
  };
  const auto first = [&](int e) { return pair_key(av[e], ai[e]); };
  const auto staged = [&](int e) { return pair_key(sv[e], si[e]); };
  // slot e of the range-major row, from device memory
  const auto from_device = [&](int e) {
    const int p = e / r;
    const size_t o = at(p, e - p * r);
    return pair_key(part_v[o], part_i[o]);
  };
  // the threshold of the r best live keys of key(0..m): 1 (every live key)
  // when there are no more than r
  const auto threshold = [&](auto key, int m, int* count) {
    return count_live(key, m, count) > r
               ? group_select(key, m, r, hist, wmm, misc, all)
               : 1ull;
  };

  for (int j = tid; j < kBins; j += kMergeThreads) hist[j] = 0u;
  if (tid < 5) misc[3 + tid] = 0;
  // ---- stage 1: the first `pre` slots of every pool
  for (int e = tid; e < ma; e += kMergeThreads) {
    const int p = e / pre;
    const size_t o = at(p, e - p * pre);
    av[e] = part_v[o];
    ai[e] = part_i[o];
  }
  __syncthreads();
  const u64 t0 = threshold(first, ma, misc + 3);
  // ---- stage 2: each pool's slots at or above t0 (a prefix)
  for (int p = tid; p < n_split; p += kMergeThreads) {
    int len = 0;
    while (len < pre && first(p * pre + len) >= t0) ++len;
    off[p] = len;
  }
  __syncthreads();
  // a pool whose staged slots all pass goes on in device memory: two
  // probes, 32 slots apart then one apart, over slots [pre, r)
  for (int p = warp; p < n_split; p += kMergeWarps) {
    if (off[p] < pre || pre == r) continue;
    const int rest = r - pre, s1 = (rest + 31) / 32;
    int j = pre + lane * s1;
    bool in = j < r && pair_key(part_v[at(p, j)], part_i[at(p, j)]) >= t0;
    const int c1 = __popc(__ballot_sync(kFull, in));
    int len = pre;
    if (c1 > 0) {
      j = pre + (c1 - 1) * s1 + 1 + lane;
      in = lane < s1 - 1 && j < r &&
           pair_key(part_v[at(p, j)], part_i[at(p, j)]) >= t0;
      len = pre + (c1 - 1) * s1 + 1 + __popc(__ballot_sync(kFull, in));
    }
    if (lane == 0) off[p] = len;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix of the lengths
    int carry = 0;
    for (int base = 0; base < n_split; base += 32) {
      const int x = base + lane < n_split ? off[base + lane] : 0;
      const int incl = warp_incl_sum(x, lane);
      if (base + lane < n_split) off[base + lane] = carry + incl - x;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) off[n_split] = carry;
  }
  __syncthreads();
  const int M = off[n_split];
  const bool in_smem = M <= cap;
  u64 t;
  if (in_smem) {
    for (int p = warp; p < n_split; p += kMergeWarps) {
      const int o = off[p], len = off[p + 1] - o;
      for (int j = lane; j < len; j += 32) {
        if (j < pre) {
          sv[o + j] = av[p * pre + j];
          si[o + j] = ai[p * pre + j];
        } else {
          sv[o + j] = part_v[at(p, j)];
          si[o + j] = part_i[at(p, j)];
        }
      }
    }
    __syncthreads();
    t = threshold(staged, M, misc + 4);
  } else {
    t = threshold(from_device, n_split * r, misc + 4);
  }
  // ---- the winners, in any order (their keys are distinct), padded, sorted
  const int m = in_smem ? M : n_split * r;
  const unsigned lt = (1u << lane) - 1u;
  for (int base = warp * 32; base < m; base += kMergeThreads) {
    const int e = base + lane;
    float v = -INFINITY;
    int id = -1;
    if (e < m) {
      if (in_smem) {
        v = sv[e];
        id = si[e];
      } else {
        const int p = e / r;
        const size_t o = at(p, e - p * r);
        v = part_v[o];
        id = part_i[o];
      }
    }
    const u64 k = pair_key(v, id);
    const bool take = k != 0ull && k >= t;
    const unsigned tm = __ballot_sync(kFull, take);
    int slot = 0;
    if (lane == 0 && tm) slot = atomicAdd(&misc[5], __popc(tm));
    slot = __shfl_sync(kFull, slot, 0);
    if (take) {
      const int o = slot + __popc(tm & lt);
      wv[o] = v;
      wi[o] = id;
    }
  }
  __syncthreads();
  for (int j = misc[5] + tid; j < P; j += kMergeThreads) {
    wv[j] = -INFINITY;
    wi[j] = -1;
  }
  __syncthreads();
  bitonic_desc(wv, wi, P, all);
  for (int j = tid; j < r; j += kMergeThreads) {
    const size_t o = ((size_t)shard * B + b) * r + j;
    const bool hit = wv[j] > -INFINITY;
    out_v[o] = hit ? wv[j] : -INFINITY;
    out_i[o] = hit ? wi[j] : -1;
  }
}

// ------------------------------------------------------------------ host

template <int STAGES, int STAGE_FLOATS>
cudaError_t launch_scan(cudaStream_t st, const float* v, const float* nsq,
                        const uint8_t* valid, const float* q,
                        const float* qsq, float* part_v, int* part_i, int S,
                        int n, int d, int B, int r, int cap, int sim,
                        int chunk, int n_split) {
  const size_t smem =
      scan_smem_bytes(STAGES, STAGE_FLOATS, d, r, std::min(kQT, B), cap);
  const auto kernel = knn_wide_scan_kernel<STAGES, STAGE_FLOATS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_split, S, (B + kQT - 1) / kQT);
  kernel<<<grid, kThreads, smem, st>>>(v, nsq, valid, q, qsq, part_v, part_i,
                                       n, d, B, r, cap, sim, chunk, n_split);
  return cudaGetLastError();
}

// The split merge of the ranges' pools part_[v|i] into out_[v|i] on `st`.
inline cudaError_t launch_merge(cudaStream_t st, const float* part_v,
                                const int* part_i, float* out_v, int* out_i,
                                int S, int B, int r, int n_split) {
  const size_t smem = merge_smem_bytes(n_split, r);
  cudaError_t e = cudaFuncSetAttribute(
      knn_wide_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  knn_wide_merge_kernel<<<dim3(B, S), kMergeThreads, smem, st>>>(
      part_v, part_i, out_v, out_i, n_split, B, r);
  return cudaGetLastError();
}

// the plans with a kernel: (ring stages, floats a stage)
inline bool known_ring(int stages, int stage_floats) {
  return (stages == 3 && stage_floats == 16384) ||
         (stages == 2 && stage_floats == 16384) ||
         (stages == 2 && stage_floats == 8192);
}

// The wide scan then the split merge on `st` over the B queries; (stages,
// stage_floats, cap) is the wrapper's plan, chunk (a multiple of 128) and
// n_split its cut of each shard. Returns the first cudaError_t met.
inline cudaError_t launch_wide_pool(cudaStream_t st, const float* v,
                                    const float* nsq, const uint8_t* valid,
                                    const float* q, const float* qsq,
                                    float* part_v, int* part_i, float* out_v,
                                    int* out_i, int S, int n, int d, int B,
                                    int r, int sim, int stages,
                                    int stage_floats, int cap, int chunk,
                                    int n_split) {
  if (r < 1 || r > kMaxR || d % 4 != 0 || chunk % kSub != 0 || B < 1 ||
      cap < kSD || !known_ring(stages, stage_floats))
    return cudaErrorInvalidValue;
  cudaError_t e;
  if (stages == 3)
    e = launch_scan<3, 16384>(st, v, nsq, valid, q, qsq, part_v, part_i, S,
                              n, d, B, r, cap, sim, chunk, n_split);
  else if (stage_floats == 16384)
    e = launch_scan<2, 16384>(st, v, nsq, valid, q, qsq, part_v, part_i, S,
                              n, d, B, r, cap, sim, chunk, n_split);
  else
    e = launch_scan<2, 8192>(st, v, nsq, valid, q, qsq, part_v, part_i, S, n,
                             d, B, r, cap, sim, chunk, n_split);
  if (e != cudaSuccess) return e;
  return launch_merge(st, part_v, part_i, out_v, out_i, S, B, r, n_split);
}

// smem bytes of the scan at a plan; 0 for a ring with no kernel
inline size_t wide_smem_bytes(int stages, int stage_floats, int d, int r,
                              int rows, int cap) {
  return known_ring(stages, stage_floats)
             ? scan_smem_bytes(stages, stage_floats, d, r, rows, cap)
             : 0;
}

}  // namespace wide
}  // namespace
