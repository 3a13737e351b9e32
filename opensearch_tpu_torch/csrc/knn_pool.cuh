// The list scan: K1's fp32 pool scan at r <= 32 (csrc/knn_fused.cu), and K3
// at k <= 32 (csrc/knn_block.cu), for Hopper (sm_90a). Two kernels a call:
// knn_pool_scan_kernel (the scan, one pool per CTA) and knn_pool_merge_kernel
// (the split merge).
//
// Contract, the same as the tile scan's (knn_tile.cuh launch_pool_scan):
// for every shard s and query b, the r best docs of the shard under (score
// desc, doc id asc), with (-inf, -1) in the slots past the shard's live
// count. fp32 only: every dot sums its d products in ascending order in one
// f32 accumulator, on FFMA, never TF32; the transform rounds after every
// operation (the _rn intrinsics under -fmad=false), as the plain PyTorch
// version does one eager operation at a time.
//
// Bound: the slab once (4Snd bytes), norms and valid flags (5Sn), against
// 2*B*S*n*d FFMA operations: bytes up to about B = 80 at d = 128,
// operations above.
//
// Design (the ring and the micro-tile are K4's stage 1, knn_pb.cu, copied
// here so that file stays as it is; fetch_tile, lane_rows and micro_tile
// serve knn_wide.cuh's scan too):
// - Query tile QT in {8, 32, 128}, chosen by the wrapper from B (8 is the
//   serving case: the stacked step runs at B = 1 and the batcher merges up
//   to 8). Each thread holds a 4-doc x 8-query register micro-tile; a warp
//   holds one 128-doc sub-block against one 8-query group. Doc tiles arrive
//   through a ring of cp.async 16-byte copies, rows XOR-swizzled in 16-byte
//   units; d is cut into chunks of kDC floats. Three 64 KB stages up to
//   QT = 32, four of 32 KB at 128, and two of 64 KB at QT = 8 for rows too
//   wide for three (the wrapper's plan).
// - Work split: each CTA takes one contiguous range of one shard's docs,
//   cut at 128-doc multiples, about one persistent wave in all: grid
//   (ranges per shard, S, query tiles). Docs past the range's end (a ragged
//   tail) are masked and never read.
// - Selection: each warp keeps, per query of its group, a sorted list of
//   the r best (score, doc id) pairs it has scored, in shared memory, for
//   the CTA's whole range (never reset), so a list sees about
//   r (1 + ln(N / r)) passers over its N docs. A doc reaches a list only by
//   its transformed score (two pre-transform values can round to one score,
//   and the id then decides); a conservative filter on a pre-transform
//   goodness, loose by 2^-12, lets through only the docs that may beat or
//   tie the list's r-th entry. Its bound is the largest r-th entry of the
//   group's warps, and in the range's first step the r-th largest of the
//   lanes' best goodness. Lists start as (-inf, -1), which -inf never
//   displaces. At the range's end the group's warps merge their lists (a
//   bitonic merge a pair) and write one [r] pool per (range, shard, query).
// - Split merge: one CTA per (query, shard) stages the n_split sorted
//   pools in shared memory, each warp merges a share of them, warp 0 merges
//   the warps' lists and writes non-finite winners as (-inf, -1). The tile
//   scan's one-warp merge (knn_tile.cuh knn_merge_kernel) on these pools
//   takes 12-28% of the call's device time at the serving shapes on an
//   H100, this one 7-14% (scripts/pool_variants.py "tile_merge").
// - What holds it (PERF.md, scripts/pool_variants.py): at B = 1 the scan
//   and its filter, at about half the card's memory rate (the inserts cost
//   little: about 26 passers a list a range); from B = 32 the inserts,
//   which run between two barriers of the ring, so every warp waits for
//   the slowest warp's, as in K4.

#pragma once

#include <algorithm>

#include "knn_tile.cuh"

namespace {
namespace pool {

constexpr int kSub = 128;   // a warp's docs a step
constexpr int kMaxR = 32;   // a list is one entry a lane

__host__ __device__ constexpr int scan_threads(int qt) {
  return qt >= 32 ? 512 : 256;
}
__host__ __device__ constexpr int stage_floats(int qt) {
  return qt <= 32 ? 16384 : 8192;
}
__host__ __device__ constexpr int subs_per_step(int qt) {
  return scan_threads(qt) / 32 / (qt / 8);
}

// The ring of both range scans (this one and knn_wide.cuh's): STAGES
// stages of STAGE_FLOATS floats, each SD docs (one step) times a d chunk of
// kDC floats, rows XOR-swizzled in 16-byte units.
template <int SD, int STAGES, int STAGE_FLOATS>
struct Ring {
  static constexpr int kSD = SD;                     // docs a step
  static constexpr int kStages = STAGES;
  static constexpr int kStageFloats = STAGE_FLOATS;
  static constexpr int kDC = kStageFloats / kSD;     // d chunk (floats)
  static constexpr int kU = kDC / 4;                 // 16-byte units a row
  static constexpr int kRPL = kU >= 8 ? 1 : 8 / kU;  // rows a 128-byte line
  static constexpr int kSwz = (kU >= 8 ? 8 : kU) - 1;
  static_assert(kDC % 4 == 0 && (kU & (kU - 1)) == 0,
                "a row chunk is a power of two of 16-byte units");
  __device__ __forceinline__ static int swizzle(int row) {
    return (row / kRPL) & kSwz;
  }
};

template <int QT, int STAGES>
struct Tile
    : Ring<subs_per_step(QT) * kSub, STAGES, stage_floats(QT)> {
  static constexpr int kThreads = scan_threads(QT);
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kSPS = subs_per_step(QT);
  static_assert(kSPS >= 1 && kSPS * (QT / 8) == kWarps,
                "the warps split the step's (sub-block, group) pairs");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------- the ring and the micro-tile

// Copy docs [doc0, doc0 + kSD) x floats [col0, col0 + kDC) of the [*, d]
// rows vs into the ring stage st, one 16-byte cp.async a unit, by the NT
// threads of the CTA; rows past end and columns past d are zero-filled.
template <class R, int NT>
__device__ __forceinline__ void fetch_tile(float* st, const float* vs,
                                           int doc0, int col0, int end, int d,
                                           int tid) {
  for (int e = tid; e < R::kSD * R::kU; e += NT) {
    const int row = e / R::kU, u = e - row * R::kU;
    const int doc = doc0 + row, col = col0 + u * 4;
    const bool in = doc < end && col < d;
    cp_async16(st + row * R::kDC + ((u ^ R::swizzle(row)) << 2),
               in ? vs + (size_t)doc * d + col : vs, in ? 16 : 0);
  }
}

// A lane's four rows of the 128-doc sub-block at row0 of a stage: their
// offsets and swizzles.
template <class R>
__device__ __forceinline__ void lane_rows(int row0, int lane, int (&roff)[4],
                                          int (&rsw)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + lane + 32 * i;
    roff[i] = row * R::kDC;
    rsw[i] = R::swizzle(row);
  }
}

// The 4-doc x 8-query micro-tile over one stage's d chunk: acc[i][u] +=
// the chunk's products of row i and query u (the queries at qg, dp floats
// apart), in ascending order, one __fmaf_rn each.
template <class R>
__device__ __forceinline__ void micro_tile(float (&acc)[4][8],
                                           const float* st,
                                           const int (&roff)[4],
                                           const int (&rsw)[4],
                                           const float* qg, int dp) {
#pragma unroll 4
  for (int kk = 0; kk < R::kU; ++kk) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(st + roff[i] +
                                              ((kk ^ rsw[i]) << 2));
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float4 y = *reinterpret_cast<const float4*>(qg + u * dp + kk * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = acc[i][u];
        a = __fmaf_rn(x[i].x, y.x, a);
        a = __fmaf_rn(x[i].y, y.y, a);
        a = __fmaf_rn(x[i].z, y.z, a);
        a = __fmaf_rn(x[i].w, y.w, a);
        acc[i][u] = a;
      }
    }
  }
}

// ------------------------------------------------------ list helpers

// Merge the other list's entry 31 - lane (ov, oc) into this lane's entry of
// a list sorted by better(): the better of each pair forms a bitonic
// sequence that holds the 32 best of both, and five half-cleaner stages
// sort it.
__device__ __forceinline__ void merge_lists(float& v, int& c, float ov,
                                            int oc, int lane) {
  if (better(ov, oc, v, c)) {
    v = ov;
    c = oc;
  }
#pragma unroll
  for (int s = 16; s; s >>= 1) {
    const float pv = __shfl_xor_sync(kFull, v, s);
    const int pc = __shfl_xor_sync(kFull, c, s);
    const bool take = (lane & s) ? better(v, c, pv, pc) : better(pv, pc, v, c);
    if (take) {
      v = pv;
      c = pc;
    }
  }
}

// A list of r (score, doc id) pairs in shared memory, sorted by better().
// While a warp works on it lane j < r holds entry j, and the lanes past r a
// pair worse than any.
__device__ __forceinline__ void load_list(const float* lv, const int* lc,
                                          int r, int lane, float& v, int& c) {
  v = lane < r ? lv[lane] : -INFINITY;
  c = lane < r ? lc[lane] : 0x7fffffff;
}

// Sort one (score, doc id) pair a lane into descending better() order
// (a bitonic network, 15 stages).
__device__ __forceinline__ void warp_sort(float& v, int& c, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int s = size / 2; s; s >>= 1) {
      const float pv = __shfl_xor_sync(kFull, v, s);
      const int pc = __shfl_xor_sync(kFull, c, s);
      const bool keep_better = ((lane & size) == 0) == ((lane & s) == 0);
      if (keep_better == better(pv, pc, v, c)) {
        v = pv;
        c = pc;
      }
    }
  }
}

// The r-th largest of one value a lane (r <= 32).
__device__ __forceinline__ float warp_kth_largest(float x, int r, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int s = size / 2; s; s >>= 1) {
      const float y = __shfl_xor_sync(kFull, x, s);
      const bool keep_max = ((lane & size) == 0) == ((lane & s) == 0);
      x = keep_max ? fmaxf(x, y) : fminf(x, y);
    }
  }
  return __shfl_sync(kFull, x, r - 1);
}

// The filter's "goodness", computed before the score transform: l2
// -max(|q|^2 - 2 q.v + |v|^2, 0), cosine q.v / |v| (|q| times the cosine),
// dot q.v. A score is a non-decreasing function of it, and two goodnesses
// further apart than slack() give scores that differ, so a doc whose
// goodness falls more than the slack below another's scores strictly lower
// (2^-12 relative, and 2^-20 absolute, 2^-11 |q| for cosine: far above the
// rounding of either).
constexpr float kRel = 1.0f / 4096.0f;
constexpr float kAbs = 1.0f / 1048576.0f;

__device__ __forceinline__ float goodness(float a, float qq, float ns,
                                          float rvn, int sim) {
  if (sim == SIM_L2)
    return -fmaxf(__fadd_rn(__fsub_rn(qq, __fmul_rn(2.0f, a)), ns), 0.0f);
  return sim == SIM_COSINE ? a * rvn : a;
}

__device__ __forceinline__ float slack(float g, float qn, int sim) {
  return fabsf(g) * kRel + (sim == SIM_COSINE ? 2.0f * kRel * qn : kAbs);
}

// the least goodness of a doc whose score may beat or tie the score thr;
// -inf when thr is not finite (a list not yet holding r docs)
__device__ __forceinline__ float threshold_goodness(float thr, float qn,
                                                    int sim) {
  if (!(fabsf(thr) < INFINITY)) return -INFINITY;
  float g;
  if (sim == SIM_L2)
    g = -(__frcp_rn(thr) - 1.0f);  // score = 1 / (1 + t)
  else if (sim == SIM_COSINE)
    g = (2.0f * thr - 1.0f) * qn;  // score = (1 + cos) / 2
  else
    g = thr >= 1.0f ? thr - 1.0f : 1.0f - __frcp_rn(thr);
  return g - slack(g, qn, sim);
}

// goodness as an int whose order is the float's, for atomicMax
__device__ __forceinline__ int ord_int(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float ord_float(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// Merge a flood of more than 32 passers (ties) into the list held one
// entry a lane (v, c): 32 at a time, sorted and merged. Not inlined: it is
// rare and long.
__device__ __noinline__ void merge_flood(unsigned m0, unsigned m1,
                                         unsigned m2, unsigned m3, float s0,
                                         float s1, float s2, float s3,
                                         int doc0, int lane, float& v,
                                         int& c) {
  const unsigned mk[4] = {m0, m1, m2, m3};
  const float s[4] = {s0, s1, s2, s3};
  const int total = __popc(m0) + __popc(m1) + __popc(m2) + __popc(m3);
  for (int b0 = 0; b0 < total; b0 += 32) {
    // lane j takes passer b0 + j (in (i, lane) order)
    float cv = -INFINITY;
    int cc = 0x7fffffff;
    int before = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ci = __popc(mk[i]);
      const int r = b0 + lane - before;
      const bool mine = r >= 0 && r < ci;
      const int src = mine ? (int)__fns(mk[i], 0, r + 1) : 0;
      const float sv = __shfl_sync(kFull, s[i], src);
      if (mine) {
        cv = sv;
        cc = doc0 + src + 32 * i;
      }
      before += ci;
    }
    warp_sort(cv, cc, lane);
    merge_lists(v, c, __shfl_sync(kFull, cv, 31 - lane),
                __shfl_sync(kFull, cc, 31 - lane), lane);
  }
}

// Add one query's passers to its list (lv, lc) and raise the group's bound
// (*low) to the list's new r-th entry: lane l's docs doc0 + l + 32 i for
// the set bits l of m_i, with dots a_i and norms n_i. Each passing lane
// transforms its own docs; then the warp, holding the list one entry a
// lane, inserts them one at a time (a ballot finds the place, the entries
// below shift down a lane), and stores it back.
__device__ __forceinline__ void add_passers(const unsigned (&mk)[4],
                                            const float (&a)[4],
                                            const float (&ns)[4], float qq,
                                            float qn, int doc0, float* lv,
                                            int* lc, int* low, int r, int sim,
                                            int lane) {
  float s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s[i] = (mk[i] >> lane) & 1 ? transform_score(a[i], qq, ns[i], sim)
                               : -INFINITY;
  float v;
  int c;
  load_list(lv, lc, r, lane, v, c);
  if (__popc(mk[0]) + __popc(mk[1]) + __popc(mk[2]) + __popc(mk[3]) > 32) {
    merge_flood(mk[0], mk[1], mk[2], mk[3], s[0], s[1], s[2], s[3], doc0,
                lane, v, c);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned m = mk[i];
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const float cv = __shfl_sync(kFull, s[i], src);
        const int cc = doc0 + src + 32 * i;
        const unsigned below = __ballot_sync(kFull, better(cv, cc, v, c));
        const int pos = __ffs(below) - 1;
        const float uv = __shfl_up_sync(kFull, v, 1);
        const int uc = __shfl_up_sync(kFull, c, 1);
        if (below != 0 && lane >= pos) {
          v = lane == pos ? cv : uv;
          c = lane == pos ? cc : uc;
        }
      }
    }
  }
  if (lane < r) {
    lv[lane] = v;
    lc[lane] = c;
  }
  const float kth = __shfl_sync(kFull, v, r - 1);
  if (lane == 0) atomicMax(low, ord_int(threshold_goodness(kth, qn, sim)));
  __syncwarp();
}

// ------------------------------------------------------------- the scan

__host__ __device__ inline int chunked_width(int qt, int d) {
  const int dc = stage_floats(qt) / (subs_per_step(qt) * kSub);
  return (d + dc - 1) / dc * dc;
}

// bytes of dynamic shared memory one scan CTA needs: the ring, the query
// tile, |q|^2 and |q| a query, each warp's lists (8 queries x r pairs) and
// each query's least goodness
__host__ inline size_t scan_smem_bytes(int qt, int stages, int d, int r) {
  return 4 * ((size_t)stages * stage_floats(qt) +
              (size_t)qt * chunked_width(qt, d) + 3 * (size_t)qt +
              2 * (size_t)scan_threads(qt) / 32 * 8 * r);
}

// grid (n_split, S, ceil(B / QT)); dynamic shared memory
// scan_smem_bytes(QT, STAGES, d, r). CTA (split, s, z) scans docs
// [split * chunk, min(n, (split + 1) * chunk)) of shard s against queries
// [z * QT, min(B, (z + 1) * QT)) and writes their pools to
// part_[v|i][s, split, b, :].
template <int QT, int STAGES>
__global__ void __launch_bounds__(scan_threads(QT), 1) knn_pool_scan_kernel(
    const float* __restrict__ v,        // [S, n, d] f32, d % 4 == 0
    const float* __restrict__ nsq,      // [S, n]
    const uint8_t* __restrict__ valid,  // [S, n] 0 / 1
    const float* __restrict__ q,        // [B, d] f32
    const float* __restrict__ qsq,      // [B]
    float* __restrict__ part_v,         // [S, n_split, B, r]
    int* __restrict__ part_i,           // [S, n_split, B, r]
    int n, int d, int B, int r, int sim, int chunk, int n_split) {
  using T = Tile<QT, STAGES>;
  constexpr int kThreads = T::kThreads;
  constexpr int kStageFloats = T::kStageFloats;
  const int split = blockIdx.x, shard = blockIdx.y;
  const int NC = (d + T::kDC - 1) / T::kDC;
  const int dp = NC * T::kDC;
  const int q0 = blockIdx.z * QT;
  const int qb = min(QT, B - q0);
  const int start = split * chunk;
  const int end = min(n, start + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sb = warp % T::kSPS, g = warp / T::kSPS;  // sub-block, group
  const float* vs = v + (size_t)shard * n * d;
  const float* nss = nsq + (size_t)shard * n;
  const uint8_t* oks = valid + (size_t)shard * n;

  extern __shared__ __align__(16) float scan_smem[];
  float* ring = scan_smem;                    // [STAGES][kSD][kDC]
  float* qs = ring + STAGES * kStageFloats;   // [QT][dp]
  float* qsq_s = qs + QT * dp;                // [QT]
  float* qn_s = qsq_s + QT;                   // [QT] |q| (cosine)
  // each warp's lists [kWarps][8][r] and, per query, the least goodness
  // (ord_int) a doc must reach to enter a list, raised by every warp of
  // the group as its list fills: a doc below another warp's r-th entry
  // cannot be in the range's top r either
  constexpr int kLists = T::kWarps * 8;
  float* lst_v = qn_s + QT;
  int* lst_c = reinterpret_cast<int*>(lst_v + kLists * r);
  int* low_g = lst_c + kLists * r;

  for (int e = tid; e < QT * dp; e += kThreads) {
    const int row = e / dp, col = e - row * dp;
    qs[e] = (row < qb && col < d) ? q[(size_t)(q0 + row) * d + col] : 0.0f;
  }
  for (int e = tid; e < QT; e += kThreads) {
    const float s = e < qb ? qsq[q0 + e] : 0.0f;
    qsq_s[e] = s;
    qn_s[e] = __fsqrt_rn(fmaxf(s, 1e-24f));
    low_g[e] = ord_int(-INFINITY);
  }
  for (int e = tid; e < kLists * r; e += kThreads) {
    lst_v[e] = -INFINITY;
    lst_c[e] = -1;
  }

  const int n_steps = end > start ? (end - start + T::kSD - 1) / T::kSD : 0;
  const int n_tiles = n_steps * NC;

  // copy tile t (chunk t % NC of step t / NC) into ring stage t % STAGES;
  // rows past the range's end and columns past d are zero-filled, unread
  int in_c = 0, in_doc = start;
  auto fetch = [&](int t) {
    if (t < n_tiles) {
      fetch_tile<T, kThreads>(ring + (t % STAGES) * kStageFloats, vs, in_doc,
                              in_c * T::kDC, end, d, tid);
      if (++in_c == NC) {
        in_c = 0;
        in_doc += T::kSD;
      }
    }
    cp_async_commit();
  };

  int roff[4], rsw[4];
  lane_rows<T>(sb * kSub, lane, roff, rsw);
  // the warp's 8 queries: rows past B leave it idle
  const int gq = g * 8;
  const bool live = gq < qb;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.0f;
  float ns[4];
  bool ok[4];

  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  int c = 0, step = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int docb = start + step * T::kSD + sb * kSub;
    // a sub-block wholly past the range's end: nothing to score
    const bool busy = live && docb < end;
    if (c == 0) {  // the step's norms and flags, used after its last chunk
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int doc = docb + lane + 32 * i;
        ok[i] = doc < end && oks[doc] != 0;
        ns[i] = doc < end ? nss[doc] : 0.0f;
      }
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    fetch(t + STAGES - 1);

    const float* st = ring + (t % STAGES) * kStageFloats;
    const float* qg = qs + gq * dp + c * T::kDC;
    if (busy) micro_tile<T>(acc, st, roff, rsw, qg, dp);
    if (++c < NC) continue;
    c = 0;
    const int this_step = step++;

    // ---- the step's passers
    if (busy) {
      float rvn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (sim == SIM_COSINE) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rvn[i] = __frcp_rn(__fsqrt_rn(fmaxf(ns[i], 1e-24f)));
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (gq + u >= qb) continue;  // a row past B: no list
        const float qq = qsq_s[gq + u], qn = qn_s[gq + u];
        float gd[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          gd[i] = ok[i] ? goodness(acc[i][u], qq, ns[i], rvn[i], sim)
                        : -INFINITY;
        float lower = ord_float(low_g[gq + u]);
        if (this_step == 0) {
          // in the range's first step the r-th largest of the lanes' best
          // goodness bounds the step's r-th best doc from below
          const float m = fmaxf(fmaxf(gd[0], gd[1]), fmaxf(gd[2], gd[3]));
          const float g0 = warp_kth_largest(m, r, lane);
          lower = fmaxf(lower, g0 - slack(g0, qn, sim));
        }
        bool any = false;
#pragma unroll
        for (int i = 0; i < 4; ++i) any |= ok[i] && gd[i] >= lower;
        if (!__any_sync(kFull, any)) continue;
        unsigned mk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mk[i] = __ballot_sync(kFull, ok[i] && gd[i] >= lower);
        const int l = (warp * 8 + u) * r;
        const float au[4] = {acc[0][u], acc[1][u], acc[2][u], acc[3][u]};
        add_passers(mk, au, ns, qq, qn, docb, lst_v + l, lst_c + l,
                    low_g + gq + u, r, sim, lane);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[i][u] = 0.0f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- the range's end: warp sb merges the group's lists of queries sb,
  // sb + kSPS, ... and writes their r slots
  if (live) {
    for (int u = sb; u < 8; u += T::kSPS) {
      if (gq + u >= qb) break;
      float ev;
      int ec;
      const int w0 = g * T::kSPS;
      load_list(lst_v + (w0 * 8 + u) * r, lst_c + (w0 * 8 + u) * r, r, lane,
                ev, ec);
      for (int w = w0 + 1; w < w0 + T::kSPS; ++w) {
        const int o = (w * 8 + u) * r + 31 - lane;
        merge_lists(ev, ec, 31 - lane < r ? lst_v[o] : -INFINITY,
                    31 - lane < r ? lst_c[o] : 0x7fffffff, lane);
      }
      if (lane < r) {
        const size_t o =
            (((size_t)shard * n_split + split) * B + q0 + gq + u) * r + lane;
        part_v[o] = ev;
        part_i[o] = ec;
      }
    }
  }
}

// ------------------------------------------------------ the split merge

constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;

__host__ inline size_t merge_smem_bytes(int n_split, int r) {
  return 8 * (size_t)std::max(n_split * r, kMergeWarps * 32);
}

// grid (B, S); dynamic shared memory merge_smem_bytes(n_split, r). Merges
// the n_split sorted pools of one (shard, query) into its top r under
// (score desc, doc id asc); non-finite winners are written as (-inf, -1).
__global__ void __launch_bounds__(kMergeThreads) knn_pool_merge_kernel(
    const float* __restrict__ part_v,  // [S, n_split, B, r]
    const int* __restrict__ part_i,
    float* __restrict__ out_v,         // [S, B, r]
    int* __restrict__ out_i,
    int n_split, int B, int r) {
  const int b = blockIdx.x, shard = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = n_split * r;
  extern __shared__ __align__(16) float merge_smem[];
  float* sv = merge_smem;
  int* si = reinterpret_cast<int*>(sv + max(m, kMergeWarps * 32));
  // every load of the CTA in flight at once
  for (int e = tid; e < m; e += kMergeThreads) {
    const int p = e / r, j = e - p * r;
    const size_t off = (((size_t)shard * n_split + p) * B + b) * r + j;
    sv[e] = part_v[off];
    si[e] = part_i[off];
  }
  __syncthreads();
  float v = -INFINITY;
  int c = 0x7fffffff;
  const int j = 31 - lane;
  for (int p = warp; p < n_split; p += kMergeWarps)
    merge_lists(v, c, j < r ? sv[p * r + j] : -INFINITY,
                j < r ? si[p * r + j] : 0x7fffffff, lane);
  __syncthreads();
  sv[warp * 32 + lane] = v;
  si[warp * 32 + lane] = c;
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kMergeWarps; ++w)
    merge_lists(v, c, sv[w * 32 + j], si[w * 32 + j], lane);
  if (lane < r) {
    const bool hit = v > -INFINITY;
    const size_t o = ((size_t)shard * B + b) * r + lane;
    out_v[o] = hit ? v : -INFINITY;
    out_i[o] = hit ? c : -1;
  }
}

// ------------------------------------------------------------------ host

template <int QT, int STAGES>
cudaError_t launch_scan(cudaStream_t st, const float* v, const float* nsq,
                        const uint8_t* valid, const float* q,
                        const float* qsq, float* part_v, int* part_i, int S,
                        int n, int d, int B, int r, int sim, int chunk,
                        int n_split) {
  const size_t smem = scan_smem_bytes(QT, STAGES, d, r);
  const auto kernel = knn_pool_scan_kernel<QT, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_split, S, (B + QT - 1) / QT);
  kernel<<<grid, Tile<QT, STAGES>::kThreads, smem, st>>>(
      v, nsq, valid, q, qsq, part_v, part_i, n, d, B, r, sim, chunk, n_split);
  return cudaGetLastError();
}

// The list scan then the split merge on `st` over the B queries; (qt,
// stages) is the wrapper's plan, chunk (a multiple of 128) and n_split its
// cut of each shard. Returns the first cudaError_t met.
inline cudaError_t launch_list_pool(cudaStream_t st, const float* v,
                                    const float* nsq, const uint8_t* valid,
                                    const float* q, const float* qsq,
                                    float* part_v, int* part_i, float* out_v,
                                    int* out_i, int S, int n, int d, int B,
                                    int r, int sim, int qt, int stages,
                                    int chunk, int n_split) {
  if (r < 1 || r > kMaxR || d % 4 != 0 || chunk % kSub != 0 || B < 1)
    return cudaErrorInvalidValue;
  cudaError_t e;
  if (qt == 8 && stages == 3)
    e = launch_scan<8, 3>(st, v, nsq, valid, q, qsq, part_v, part_i, S, n, d,
                          B, r, sim, chunk, n_split);
  else if (qt == 8 && stages == 2)
    e = launch_scan<8, 2>(st, v, nsq, valid, q, qsq, part_v, part_i, S, n, d,
                          B, r, sim, chunk, n_split);
  else if (qt == 32 && stages == 3)
    e = launch_scan<32, 3>(st, v, nsq, valid, q, qsq, part_v, part_i, S, n,
                           d, B, r, sim, chunk, n_split);
  else if (qt == 128 && stages == 4)
    e = launch_scan<128, 4>(st, v, nsq, valid, q, qsq, part_v, part_i, S, n,
                            d, B, r, sim, chunk, n_split);
  else
    return cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  const size_t smem = merge_smem_bytes(n_split, r);
  e = cudaFuncSetAttribute(knn_pool_merge_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  knn_pool_merge_kernel<<<dim3(B, S), kMergeThreads, smem, st>>>(
      part_v, part_i, out_v, out_i, n_split, B, r);
  return cudaGetLastError();
}

// smem bytes of the scan at a plan; 0 for a plan with no kernel
inline size_t list_smem_bytes(int qt, int stages, int d, int r) {
  const bool known = (qt == 8 && (stages == 3 || stages == 2)) ||
                     (qt == 32 && stages == 3) || (qt == 128 && stages == 4);
  return known ? scan_smem_bytes(qt, stages, d, r) : 0;
}

}  // namespace pool
}  // namespace
