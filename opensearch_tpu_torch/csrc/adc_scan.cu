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
// shape (m = 20, L_pad = 8192, P = 8) a query reads about 0.9 MB of live
// codes and 160 KB of fp32 LUT. At B = 1 the bound is below one launch, so
// the design aims at few dependent steps per CTA rather than at bytes.
//
// Design, against that bound. Every score becomes a 32-bit key that orders
// like (score desc): a higher score, a higher key; -0.0 and +0.0 share one
// key; -inf and masked slots are key 0, no candidate. Ties on the key go to
// the lower position.
//  - Stage 1, adc_scan_kernel: one CTA of 512 threads per (probe, query,
//    range of `span` list slots), grid (P, B, n_parts): lists fill from
//    their first slot, so the first ranges, which hold the live slots, are
//    launched first and spread over every SM. The wrapper picks span (512
//    to 8192) so the grid holds about two CTAs per SM, and one CTA walks a
//    whole list where that is enough. The CTA copies its
//    range's mask bytes to shared memory and finds its last live slot; a
//    range with none writes a count of 0 and stops before the LUT or the
//    codes. Else the (b, p) LUT goes to shared memory at its native width
//    (16-byte copies), each thread decodes its slots by direct lookup into
//    it (neighbouring threads on neighbouring code rows, 4-byte words when
//    m is a multiple of 4) and writes the slot's key to shared memory. An
//    exact select keeps the range's best min(R, live): radix-histogram
//    passes of 11 bits over the keys (from the highest bit in which the
//    range's keys differ; warp-aggregated shared-memory counters, a
//    block-wide scan of the bins) find the threshold key and how many keys
//    beat it; the keys equal to it are
//    ranked by position with warp ballots and a prefix over the warps; the
//    survivors' keys and doc ids are compacted, unsorted and in slot order,
//    into the part's slice, with its count and a low key (none kept is
//    below it) beside.
//  - Stage 2, adc_merge_kernel: one CTA of 1024 threads per query (its
//    walks are latency-bound, so it takes the most warps a CTA may have).
//    It scans the parts' counts into offsets and gathers only the live
//    survivors (binary search of the offsets, so empty parts cost
//    nothing). Parts in order, each in slot order, concatenate in position
//    order, so a candidate's index breaks its ties and no position is
//    carried. The same select runs over them, in 8-bit passes whose find
//    one warp does alone (two barriers a pass: the merge's cost is its
//    chain of barriers and dependent loads, not its few thousand keys);
//    then the at most R left are put in order: up to 256 by rank (each
//    thread counts the winners before its own), more by a bitonic network
//    of next_pow2(kept) (key desc, index asc). It writes scores and doc
//    ids, (-inf, -1) past the count. Candidates, offsets and the sort
//    buffer live in shared memory where the wrapper's plan fits them, else
//    in device scratch the wrapper allocates: no limit on R.
//  - No atomics on the result path (shared-memory counters, maxima and
//    minima only, whose values do not depend on order): results are the
//    same run to run, and at uint8 bit-equal to the plain PyTorch version.
// Not used: cp.async / TMA or prefetch for the code rows (a prefetch into
// L1 before the decode measured no gain; scripts/adc_variants.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// threads of a stage-1 CTA and of a merge CTA (the merge is one CTA a
// query: its walks over the candidates are latency-bound, so it takes the
// most warps a CTA may have)
constexpr int kScanThreads = 512;
constexpr int kMergeThreads = 1024;
constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;
// bits of the key one histogram pass resolves: stage 1 (up to 8192 keys a
// CTA) and the merge (a few thousand, where one warp finds the bin of a
// pass alone)
constexpr int kScanRadixBits = 11;
constexpr int kMergeRadixBits = 8;
constexpr int kMaxBins = 1 << (kScanRadixBits > kMergeRadixBits
                                   ? kScanRadixBits
                                   : kMergeRadixBits);
// the merge places at most this many winners by rank (one thread each,
// compared with all the others) in place of the bitonic network
constexpr int kRankMax = 256;

enum { PREC_FP32 = 0, PREC_BF16 = 1, PREC_U8 = 2 };

__host__ __device__ inline int lut_elem_bytes(int prec) {
  return prec == PREC_FP32 ? 4 : (prec == PREC_BF16 ? 2 : 1);
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// (ak, ap) ranks before (bk, bp): higher key, then lower position (in the
// merge a candidate's index, which follows position order)
__device__ __forceinline__ bool before(uint32_t ak, int ap, uint32_t bk,
                                       int bp) {
  return ak > bk || (ak == bk && ap < bp);
}

// the key of a score: orders like the score, -0.0 as +0.0, -inf as 0
__device__ __forceinline__ uint32_t score_key(float s) {
  if (s == -INFINITY) return 0u;
  const uint32_t u = s == 0.0f ? 0u : __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(uint32_t k) {
  if (k == 0u) return -INFINITY;
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
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

// the select's shared state (static shared memory of both kernels)
struct SelectShared {
  unsigned hist[kMaxBins];
  int scan[kMaxWarps];
  int warp_gt[kMaxWarps], warp_eq[kMaxWarps];
  unsigned kmax, kmin;
  int count, extent;
  int digit, above, in_digit;
};

// Inclusive prefix sum over the lanes of a warp.
__device__ __forceinline__ int warp_incl_sum(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive prefix sum of v over the block in thread order; *total gets the
// block's sum. Every thread of a T-thread block calls it; it ends on a
// barrier.
template <int T>
__device__ int block_excl_sum(int v, SelectShared& sh, int* total) {
  constexpr int kWarps = T / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = warp_incl_sum(v, lane);
  if (lane == 31) sh.scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_incl_sum(lane < kWarps ? sh.scan[lane] : 0, lane);
    if (lane < kWarps) sh.scan[lane] = w;
  }
  __syncthreads();
  const int out = (warp ? sh.scan[warp - 1] : 0) + x - v;
  *total = sh.scan[kWarps - 1];
  __syncthreads();
  return out;
}

// Folds each thread's maximum and minimum key and the warp's live count
// into sh (set to 0, ~0 and 0 before); the caller syncs.
__device__ __forceinline__ void fold_keys(SelectShared& sh, unsigned kmax,
                                          unsigned kmin, int live) {
  kmax = __reduce_max_sync(kFull, kmax);
  kmin = __reduce_min_sync(kFull, kmin);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&sh.kmax, kmax);
    atomicMin(&sh.kmin, kmin);
    atomicAdd(&sh.count, live);
  }
}

// One warp over the 32 * PER bins, lane l owning the PER bins from the top
// down ([(31 - l) * PER, (32 - l) * PER)): the bin where the count from the
// top reaches `need`. The lane that finds it writes sh.digit, sh.above (the
// keys in higher bins) and sh.in_digit.
template <int PER>
__device__ __forceinline__ void warp_find(SelectShared& sh, int need,
                                          int lane) {
  const int top = (32 - lane) * PER;
  int mine = 0;
#pragma unroll
  for (int j = 1; j <= PER; ++j) mine += sh.hist[top - j];
  int acc = warp_incl_sum(mine, lane) - mine;
  if (acc < need && need <= acc + mine) {
    for (int j = 1; j <= PER; ++j) {
      const int c = sh.hist[top - j];
      if (acc + c >= need) {
        sh.digit = top - j;
        sh.above = acc;
        sh.in_digit = c;
        break;
      }
      acc += c;
    }
  }
}

// The threshold of the best `want` keys of keys[0, n) (0 is no key; more
// than `want` are nonzero, with maximum kmax and minimum kmin): the kept set
// is every key > *t and the first *need_eq keys equal to *t in index order.
// Histogram passes of BITS bits, from the highest bit in which kmax and kmin
// differ, until one bin is kept whole or every bit is resolved; each pass
// counts with warp-aggregated shared-memory counters, then finds the bin
// where the count from the top reaches the keys still wanted. Up to 256
// bins one warp finds it and clears the bins alone (two barriers a pass;
// the bins must be zero on entry); above that every thread clears and sums
// its own bins and a block-wide scan finds it (six).
template <int T, int BITS>
__device__ void radix_select(const uint32_t* keys, int n, int want,
                             uint32_t kmax, uint32_t kmin, SelectShared& sh,
                             uint32_t* t, int* need_eq) {
  constexpr int kBins = 1 << BITS;
  constexpr bool kOneWarp = kBins <= 32 * 8;
  static_assert(kBins <= kMaxBins, "the histogram fits");
  static_assert(kOneWarp || kBins % T == 0, "whole bins a thread");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (kmax == kmin) {
    *t = kmax;
    *need_eq = want;
    return;
  }
  int hi = 31 - __clz(kmax ^ kmin);
  uint32_t msk = hi == 31 ? 0u : ~((2u << hi) - 1u);
  uint32_t prefix = kmax & msk;
  int need = want;
  constexpr int per = kOneWarp ? 1 : kBins / T;
  const int top = kBins - tid * per;  // this thread's bins: [top - per, top)
  for (;;) {
    const int w = hi + 1 < BITS ? hi + 1 : BITS;
    const int shift = hi + 1 - w;
    const unsigned dmask = (1u << w) - 1u;
    if constexpr (!kOneWarp) {
#pragma unroll
      for (int j = 1; j <= per; ++j) sh.hist[top - j] = 0;
      __syncthreads();
    }
    for (int base = warp * 32; base < n; base += T) {
      const int i = base + lane;
      const uint32_t k = i < n ? keys[i] : 0u;
      const bool in = k != 0u && (k & msk) == prefix;
      const unsigned am = __ballot_sync(kFull, in);
      if (in) {
        const unsigned d = (k >> shift) & dmask;
        const unsigned peers = __match_any_sync(am, d);
        if (lane == __ffs(peers) - 1) atomicAdd(&sh.hist[d], __popc(peers));
      }
    }
    __syncthreads();
    if constexpr (kOneWarp) {
      if (warp == 0) {
        warp_find<kBins / 32>(sh, need, lane);
        __syncwarp();
        for (int j = lane; j < kBins; j += 32) sh.hist[j] = 0;
      }
    } else {
      int mine = 0;
#pragma unroll
      for (int j = 1; j <= per; ++j) mine += sh.hist[top - j];
      int total;
      const int above = block_excl_sum<T>(mine, sh, &total);
      if (above < need && need <= above + mine) {
        int acc = above;
        for (int j = 1; j <= per; ++j) {
          const int c = sh.hist[top - j];
          if (acc + c >= need) {
            sh.digit = top - j;
            sh.above = acc;
            sh.in_digit = c;
            break;
          }
          acc += c;
        }
      }
    }
    __syncthreads();
    need -= sh.above;
    prefix |= (unsigned)sh.digit << shift;
    msk |= dmask << shift;
    if (sh.in_digit == need) {  // the whole bin is kept: every key >= prefix
      *t = prefix ? prefix - 1u : 0u;
      *need_eq = 0;
      break;
    }
    if (shift == 0) {
      *t = prefix;
      *need_eq = need;
      break;
    }
    hi = shift - 1;
  }
  __syncthreads();  // sh.digit etc. are read before anyone rewrites them
}

// Writes the kept entries of keys[0, n) (every key > t, and the first
// need_eq keys equal to t in index order) to out_k, and payload(i) beside
// each to out_v, in index order. Each warp walks one contiguous segment;
// ends on a barrier.
template <int T, typename Payload>
__device__ void compact(const uint32_t* keys, int n, uint32_t t, int need_eq,
                        uint32_t* out_k, int* out_v, Payload payload,
                        SelectShared& sh) {
  constexpr int kWarps = T / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = warp * seg, hi = min(n, lo + seg);
  int gt = 0, eq = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const uint32_t k = i < hi ? keys[i] : 0u;
    gt += __popc(__ballot_sync(kFull, k > t));
    eq += __popc(__ballot_sync(kFull, i < hi && k == t));
  }
  if (lane == 0) {
    sh.warp_gt[warp] = gt;
    sh.warp_eq[warp] = eq;
  }
  __syncthreads();
  int out = 0, eq_run = 0;
  for (int v = 0; v < warp; ++v) {
    out += sh.warp_gt[v];
    eq_run += sh.warp_eq[v];
  }
  out += min(eq_run, need_eq);
  const unsigned lt = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const uint32_t k = i < hi ? keys[i] : 0u;
    const bool is_eq = i < hi && k == t;
    const unsigned eqm = __ballot_sync(kFull, is_eq);
    const bool take =
        k > t || (is_eq && eq_run + __popc(eqm & lt) < need_eq);
    const unsigned tm = __ballot_sync(kFull, take);
    if (take) {
      const int o = out + __popc(tm & lt);
      out_k[o] = k;
      out_v[o] = payload(i);
    }
    out += __popc(tm);
    eq_run += __popc(eqm);
  }
  __syncthreads();
}

// grid (P, B, n_parts), kScanThreads threads; dynamic shared memory: the
// LUT (align16(m * ks * w) bytes), span keys, then span mask bytes. Part
// (b, p, c) covers list slots [c * span, (c + 1) * span) and writes at most
// rp = min(R, span) (key, doc id) pairs in slot order to its slice of
// part_k / part_i, their count to part_n.
template <int PREC, bool WORDS>
__global__ void __launch_bounds__(kScanThreads) adc_scan_kernel(
    const unsigned char* __restrict__ lut,  // [B, P, m, ks] native width
    const uint8_t* __restrict__ codes,      // [nlist, l_pad, m]
    const uint8_t* __restrict__ mask,       // [nlist, l_pad] 0 / 1
    const int* __restrict__ ids,            // [nlist, l_pad]
    const int* __restrict__ probes,         // [B, P]
    uint32_t* __restrict__ part_k,          // [B, P * n_parts, rp]
    int* __restrict__ part_i,
    int* __restrict__ part_n,               // [B, P * n_parts]
    int P, int nlist, int l_pad, int m, int ks, int span, int rp,
    int n_parts) {
  constexpr int T = kScanThreads;
  __shared__ SelectShared sh;
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int list = probes[(size_t)b * P + p];
  const bool list_ok = list >= 0 && list < nlist;
  const int l0 = c * span;
  const int len = min(span, l_pad - l0);
  const size_t slot0 = (size_t)(list_ok ? list : 0) * l_pad + l0;
  const size_t part = ((size_t)b * P + p) * n_parts + c;
  const size_t lut_bytes = (size_t)m * ks * lut_elem_bytes(PREC);
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem + align16(lut_bytes));
  uint8_t* live_b = reinterpret_cast<uint8_t*>(keys + span);
  if (tid == 0) {
    sh.extent = 0;
    sh.count = 0;
    sh.kmax = 0u;
    sh.kmin = ~0u;
  }
  for (int i = tid; i < kMaxBins; i += T) sh.hist[i] = 0;
  __syncthreads();

  // the range's mask bytes to shared memory, and 1 + its last live slot:
  // the keys stop there
  int ext = 0;
  if (list_ok) {
    const uint8_t* mrow = mask + slot0;
    if (((reinterpret_cast<uintptr_t>(mrow) | (uintptr_t)len) & 3) == 0) {
      for (int i = 4 * tid; i < len; i += 4 * T) {
        const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(mrow + i));
        *reinterpret_cast<uint32_t*>(live_b + i) = w;
        if (w) ext = i + ((31 - __clz(w)) >> 3) + 1;
      }
    } else {
      for (int i = tid; i < len; i += T) {
        const uint8_t v = __ldg(mrow + i);
        live_b[i] = v;
        if (v) ext = i + 1;
      }
    }
  }
  ext = __reduce_max_sync(kFull, ext);
  if (lane == 0 && ext) atomicMax(&sh.extent, ext);
  __syncthreads();
  const int n = sh.extent;
  if (n == 0) {
    if (tid == 0) part_n[part] = 0;
    return;
  }

  const unsigned char* src = lut + ((size_t)b * P + p) * lut_bytes;
  if ((lut_bytes & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(smem);
    for (size_t i = tid; i < lut_bytes / 16; i += T) d4[i] = __ldg(s4 + i);
  } else {
    for (size_t i = tid; i < lut_bytes; i += T) smem[i] = __ldg(src + i);
  }
  __syncthreads();

  unsigned kmax = 0u, kmin = ~0u;
  int live = 0;
  for (int base = warp * 32; base < n; base += T) {
    const int i = base + lane;
    uint32_t k = 0u;
    if (i < n && live_b[i])
      k = score_key(-decode_row<PREC, WORDS>(smem, codes + (slot0 + i) * m,
                                             m, ks));
    if (i < n) keys[i] = k;
    if (k) {
      kmax = max(kmax, k);
      kmin = min(kmin, k);
    }
    live += __popc(__ballot_sync(kFull, k != 0u));
  }
  fold_keys(sh, kmax, kmin, live);
  __syncthreads();

  const int n_live = sh.count;
  const int want = n_live < rp ? n_live : rp;
  uint32_t t = 0u;
  int need_eq = 0;
  if (want > 0 && want < n_live)
    radix_select<T, kScanRadixBits>(keys, n, want, sh.kmax, sh.kmin, sh, &t,
                                    &need_eq);
  if (want > 0)
    compact<T>(keys, n, t, need_eq, part_k + part * rp, part_i + part * rp,
               [&](int i) { return __ldg(ids + slot0 + i); }, sh);
  if (tid == 0) part_n[part] = want;
}

// grid (B), kMergeThreads threads: the best r of one query's parts. Shared
// memory (dynamic) at the wrapper's byte offsets, each -1 for the device
// scratch instead: the parts' offsets at off_at, cand_cap candidates
// (keys, then doc ids) at cand_at, the sort buffer of next_pow2(r) (keys,
// then candidate indices) at sort_at. Candidates past cand_cap go to the
// device scratch (cand_k_g / cand_i_g, parts * rp a query).
__global__ void __launch_bounds__(kMergeThreads) adc_merge_kernel(
    const uint32_t* __restrict__ part_k, const int* __restrict__ part_i,
    const int* __restrict__ part_n,
    float* __restrict__ out_v, int* __restrict__ out_i, int* off_g,
    uint32_t* cand_k_g, int* cand_i_g, uint32_t* sort_k_g, int* sort_e_g,
    int parts, int rp, int r, int off_at, int cand_at, int cand_cap,
    int sort_at) {
  constexpr int T = kMergeThreads;
  __shared__ SelectShared sh;
  extern __shared__ __align__(16) unsigned char msmem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int* counts = part_n + (size_t)b * parts;
  int* off = off_at >= 0 ? reinterpret_cast<int*>(msmem + off_at)
                         : off_g + (size_t)b * parts;
  if (tid == 0) {
    sh.kmax = 0u;
    sh.kmin = ~0u;
    sh.count = 0;
  }

  for (int i = tid; i < kMaxBins; i += T) sh.hist[i] = 0;

  // the parts' survivors, concatenated in part order, are in position
  // order: a candidate's index ranks its ties
  int carry = 0;
  for (int base = 0; base < parts; base += T) {
    const int q = base + tid;
    const int v = q < parts ? counts[q] : 0;
    int total;
    const int ex = block_excl_sum<T>(v, sh, &total);
    if (q < parts) off[q] = carry + ex;
    carry += total;
  }
  const int n = carry;
  __syncthreads();

  uint32_t* ck;
  int* ci;
  if (n <= cand_cap) {
    ck = reinterpret_cast<uint32_t*>(msmem + cand_at);
    ci = reinterpret_cast<int*>(ck + cand_cap);
  } else {
    ck = cand_k_g + (size_t)b * parts * rp;
    ci = cand_i_g + (size_t)b * parts * rp;
  }
  const size_t pbase = (size_t)b * parts * rp;
  unsigned kmax = 0u, kmin = ~0u;
#pragma unroll 4
  for (int base = warp * 32; base < n; base += T) {
    const int e = base + lane;
    if (e < n) {
      // the last part whose offset is <= e holds entry e (it is not empty)
      int lo = 0, hi = parts - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (off[mid] <= e) lo = mid;
        else hi = mid - 1;
      }
      const size_t src = pbase + (size_t)lo * rp + (e - off[lo]);
      const uint32_t k = __ldg(part_k + src);
      ck[e] = k;
      ci[e] = __ldg(part_i + src);
      kmax = max(kmax, k);
      kmin = min(kmin, k);
    }
  }
  fold_keys(sh, kmax, kmin, 0);
  __syncthreads();

  const int want = n < r ? n : r;
  uint32_t t = 0u;
  int need_eq = 0;
  if (want < n)
    radix_select<T, kMergeRadixBits>(ck, n, want, sh.kmax, sh.kmin, sh, &t,
                                     &need_eq);
  int s_cap = 1;
  while (s_cap < r) s_cap <<= 1;
  uint32_t* sk;
  int* se;
  if (sort_at >= 0) {
    sk = reinterpret_cast<uint32_t*>(msmem + sort_at);
    se = reinterpret_cast<int*>(sk + s_cap);
  } else {
    sk = sort_k_g + (size_t)b * s_cap;
    se = sort_e_g + (size_t)b * s_cap;
  }
  if (want > 0)
    compact<T>(ck, n, t, need_eq, sk, se, [](int i) { return i; }, sh);
  const size_t obase = (size_t)b * r;
  for (int u = want + tid; u < r; u += T) {
    out_v[obase + u] = -INFINITY;
    out_i[obase + u] = -1;
  }
  if (want <= kRankMax) {
    // the (key, index) pairs are distinct: their ranks are the order
    if (tid < want) {
      const uint32_t k = sk[tid];
      const int e = se[tid];
      int rank = 0;
      for (int j = 0; j < want; ++j) rank += before(sk[j], se[j], k, e);
      out_v[obase + rank] = key_score(k);
      out_i[obase + rank] = ci[e];
    }
    return;
  }
  int s = 1;
  while (s < want) s <<= 1;
  for (int i = want + tid; i < s; i += T) {
    sk[i] = 0u;
    se[i] = INT_MAX;
  }
  __syncthreads();

  // bitonic sort of s entries, best first
  for (int size = 2; size <= s; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < (s >> 1); i += T) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const uint32_t ak = sk[lo], bk = sk[hi];
        const int ae = se[lo], be = se[hi];
        const bool swap = (lo & size) == 0 ? before(bk, be, ak, ae)
                                           : before(ak, ae, bk, be);
        if (swap) {
          sk[lo] = bk;
          sk[hi] = ak;
          se[lo] = be;
          se[hi] = ae;
        }
      }
      __syncthreads();
    }
  }
  for (int u = tid; u < want; u += T) {
    out_v[obase + u] = key_score(sk[u]);
    out_i[obase + u] = ci[se[u]];
  }
}

template <int PREC, bool WORDS>
cudaError_t launch_scan(dim3 grid, size_t smem, cudaStream_t st,
                        const unsigned char* lut, const uint8_t* codes,
                        const uint8_t* mask, const int* ids,
                        const int* probes, uint32_t* pk, int* pi, int* pn,
                        int P, int nlist, int l_pad, int m, int ks, int span,
                        int rp, int n_parts) {
  cudaError_t e = cudaFuncSetAttribute(
      adc_scan_kernel<PREC, WORDS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  adc_scan_kernel<PREC, WORDS><<<grid, kScanThreads, smem, st>>>(
      lut, codes, mask, ids, probes, pk, pi, pn, P, nlist, l_pad, m, ks, span,
      rp, n_parts);
  return cudaGetLastError();
}

template <int PREC>
cudaError_t launch_scan_prec(bool words, dim3 grid, size_t smem,
                             cudaStream_t st, const unsigned char* lut,
                             const uint8_t* codes, const uint8_t* mask,
                             const int* ids, const int* probes, uint32_t* pk,
                             int* pi, int* pn, int P, int nlist, int l_pad,
                             int m, int ks, int span, int rp, int n_parts) {
  if (words)
    return launch_scan<PREC, true>(grid, smem, st, lut, codes, mask, ids,
                                   probes, pk, pi, pn, P, nlist, l_pad, m, ks,
                                   span, rp, n_parts);
  return launch_scan<PREC, false>(grid, smem, st, lut, codes, mask, ids,
                                  probes, pk, pi, pn, P, nlist, l_pad, m, ks,
                                  span, rp, n_parts);
}

}  // namespace

extern "C" {

// Stage 1 then stage 2 on `stream`, with the wrapper's plan (ops/adc_scan.py
// scan_plan, merge_plan): span, the scan's dynamic shared memory
// (align16(m * ks * w) + 5 * span), and the merge's layout and shared
// memory. part_k / part_i hold B * P * n_parts * min(r, span) entries,
// part_n B * P * n_parts; the scratch pointers may be null where the plan
// keeps that buffer in shared memory. Returns the first
// cudaError_t met (0 = launched).
int adc_scan_launch(const void* lut, const void* codes, const void* mask,
                    const void* ids, const void* probes, void* part_k,
                    void* part_i, void* part_n, void* out_v,
                    void* out_i, void* off_g, void* cand_k, void* cand_i,
                    void* sort_k, void* sort_e, int B, int P, int nlist,
                    int l_pad, int m, int ks, int r, int span, int prec,
                    int scan_smem, int off_at, int cand_at, int cand_cap,
                    int sort_at, int merge_smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_parts = (l_pad + span - 1) / span;
  const int rp = r < span ? r : span;
  const dim3 grid(P, B, n_parts);
  const bool words = (m & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(codes) & 3) == 0;
  const unsigned char* lut_b = static_cast<const unsigned char*>(lut);
  const uint8_t* codes_b = static_cast<const uint8_t*>(codes);
  const uint8_t* mask_b = static_cast<const uint8_t*>(mask);
  const int* ids_i = static_cast<const int*>(ids);
  const int* probes_i = static_cast<const int*>(probes);
  uint32_t* pk = static_cast<uint32_t*>(part_k);
  int* pi = static_cast<int*>(part_i);
  int* pn = static_cast<int*>(part_n);
  cudaError_t e;
  if (prec == PREC_U8) {
    e = launch_scan_prec<PREC_U8>(words, grid, scan_smem, st, lut_b, codes_b,
                                  mask_b, ids_i, probes_i, pk, pi, pn, P, nlist,
                                  l_pad, m, ks, span, rp, n_parts);
  } else if (prec == PREC_BF16) {
    e = launch_scan_prec<PREC_BF16>(words, grid, scan_smem, st, lut_b,
                                    codes_b, mask_b, ids_i, probes_i, pk, pi,
                                    pn, P, nlist, l_pad, m, ks, span, rp,
                                    n_parts);
  } else {
    e = launch_scan_prec<PREC_FP32>(words, grid, scan_smem, st, lut_b,
                                    codes_b, mask_b, ids_i, probes_i, pk, pi,
                                    pn, P, nlist, l_pad, m, ks, span, rp,
                                    n_parts);
  }
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(adc_merge_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           merge_smem);
  if (e != cudaSuccess) return (int)e;
  adc_merge_kernel<<<B, kMergeThreads, merge_smem, st>>>(
      pk, pi, pn, static_cast<float*>(out_v), static_cast<int*>(out_i),
      static_cast<int*>(off_g), static_cast<uint32_t*>(cand_k),
      static_cast<int*>(cand_i), static_cast<uint32_t*>(sort_k),
      static_cast<int*>(sort_e), P * n_parts, rp, r, off_at, cand_at,
      cand_cap, sort_at);
  return (int)cudaGetLastError();
}

}  // extern "C"
