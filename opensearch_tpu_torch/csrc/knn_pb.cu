// K4 for Hopper (sm_90a): the exact top-k of every 2048-doc block (stage 1),
// then the stable block-major merge of those pools (stage 2). Two launches a
// call.
//
// Replaces: opensearch_tpu/ops/pallas_knn.py::_knn_pb_kernel (launched by
// pallas_knn_blocktopk) and the XLA merge after it (pallas_knn.py:355-362).
// Same contract. Stage 1 writes, for every 2048-doc block and query, that
// block's own k best docs, best first under (score desc, column asc) (the
// reference's argmax-first rounds), as [nb, B, k] values and int32 ids; a
// slot past the block's live count holds (-inf, the block's first doc id),
// the TPU kernel's argmax of an all -inf row. Stage 2 is a stable top-k over
// the block-major [B, nb * k]: ties to the lower block, then the lower rank;
// non-finite winners get id -1. exact = 1 scores in fp32 (the TPU's
// HIGHEST); exact = 0 rounds both operands to bf16 as they are loaded and
// sums the exact products in f32 (one bf16 MXU pass), on FFMA, never TF32.
// Every dot sums its d products in ascending order in one f32 accumulator.
//
// Bound of stage 1: the slab once (4nd bytes), norms and valid flags (5n),
// the [nb, B, k] winners out (8 nb B k), against 2*B*n*d FFMA operations:
// bytes up to about B = 80 at d = 128, operations above.
//
// Stage 1 design: K5's stage-1 scan (csrc/knn_sbmax.cu) with the selection
// in the kernel.
// - Query tile QT in {8, 32, 128}, chosen by the wrapper from the padded
//   batch; only the first `rows` queries (the caller's, not the pad rows)
//   are selected and written. Each thread holds a 4-doc x 8-query register
//   micro-tile; a warp holds one 128-doc sub-block against one 8-query
//   group. Doc tiles arrive through a ring of cp.async 16-byte copies, rows
//   XOR-swizzled in 16-byte units; d is cut into chunks of kDC floats, so
//   any width whose query tile fits in shared memory scans.
// - List tier (k <= 32): each warp keeps, per query of its group, a sorted
//   list of the k best (score, column) pairs of the docs it has scored in
//   the block, in shared memory (registers would crowd the FMA loop). A
//   doc meets a list only by its transformed score (two pre-transform
//   values can round to one score, and the column then decides), but a
//   conservative filter in a pre-transform goodness (l2's
//   -max(|q|^2 - 2 q.v + |v|^2, 0), cosine's q.v / |v|, dot's q.v), loose by
//   2^-12, lets through only the docs that may beat or tie the k-th entry.
//   Its bound is the largest k-th entry of the group's warps (a doc below
//   any warp's k-th entry cannot be in the block's top-k), and in the
//   block's first step the k-th largest of the lanes' best goodness. The
//   passers' lanes transform them; the warp loads the list one entry a
//   lane and inserts them one at a time (a ballot finds the place, the
//   entries below shift down a lane). Lists start as (-inf, block base) and
//   -inf never displaces one. On data in random order about
//   k (1 + ln(N / k)) docs pass for N docs a list sees: at the SIFT-1M shape
//   44 a (query, block) at QT = 128 (N = 2048), 95 at QT = 32 (four warps
//   of N = 512 each), scripts/pb_variants.py counts them.
// - At the block's end the warps of a group merge their lists (a bitonic
//   merge of two sorted lists, five shuffle stages), one query a warp, and
//   write k slots.
// - Scores-in-shared-memory tier (k > 32, or a row too wide for the list
//   tier): QT = 8 with a 2 x 32 KB ring; the block's [8, 2048] transformed
//   scores stay in shared memory, and each query's k winners are found by a
//   radix select (four 8-bit passes over order-preserving keys) and an
//   ordered compaction in column order, then ranked.
// - Grid: persistent, (CTAs per query tile, query tiles); each CTA walks
//   whole blocks strided by the grid, and the CTAs of all query tiles walk
//   the same blocks together, so a doc tile is read from device memory
//   about once and from L2 for the others. Wave quantisation: 489 blocks
//   over 132 SMs are 3.7 waves (7% lost), left as it is: cutting a block
//   into parts that the last CTA to finish merges filled the waves to 99%
//   but made each part start its lists afresh, and measured slower.
// - What holds it (PERF.md): the selection runs between two barriers of
//   the ring, so every warp waits for the slowest one's inserts; at
//   QT = 32 and 128 the inserts add about half to the scan and its filter.
//
// Stage 2 design: one 512-thread CTA per (padded) query over its nb * k
// candidates in block-major order, staged in shared memory when they fit:
// a radix select of the k-th key (-0.0 folded to +0.0), an ordered
// compaction in position order (every key above it, the first k - above
// equal to it), and each winner's rank counted against the others.

#include <algorithm>

#include "knn_tile.cuh"

namespace {

constexpr int kBlock = 2048;  // PB_BLOCK
constexpr int kSub = 128;     // a warp's docs a step

enum { TIER_LISTS = 0, TIER_SCORES = 1 };

// K5's stage-1 shape at query tile qt (512 threads from qt = 32; three
// 64 KB ring stages up to qt = 32, four of 32 KB at 128); the scores tier
// takes QT = 8 with two 32 KB stages, to leave room for its score tile.
__host__ __device__ constexpr int scan_threads(int qt) {
  return qt >= 32 ? 512 : 256;
}
__host__ __device__ constexpr int ring_stages(int qt, int tier) {
  return tier == TIER_SCORES ? 2 : (qt <= 32 ? 3 : 4);
}
__host__ __device__ constexpr int stage_floats(int qt, int tier) {
  return tier == TIER_SCORES ? 8192 : (qt <= 32 ? 16384 : 8192);
}
__host__ __device__ constexpr int subs_per_step(int qt) {
  return scan_threads(qt) / 32 / (qt / 8);
}

template <int QT, int TIER>
struct Tile {
  static constexpr int kThreads = scan_threads(QT);
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kStages = ring_stages(QT, TIER);
  static constexpr int kStageFloats = stage_floats(QT, TIER);
  static constexpr int kGroups = QT / 8;  // 8-query groups
  static constexpr int kSPS = subs_per_step(QT);
  static constexpr int kSD = kSPS * kSub;            // docs a step
  static constexpr int kSteps = kBlock / kSD;        // steps a block
  static constexpr int kDC = kStageFloats / kSD;     // d chunk (floats)
  static constexpr int kU = kDC / 4;                 // 16-byte units a row
  static constexpr int kRPL = kU >= 8 ? 1 : 8 / kU;  // rows a 128-byte line
  static constexpr int kSwz = (kU >= 8 ? 8 : kU) - 1;
  static_assert(kSPS >= 1 && kSPS * kGroups == kWarps,
                "the warps split the step's (sub-block, group) pairs");
  static_assert(kDC % 4 == 0, "a row chunk is whole 16-byte units");
  static_assert(TIER == TIER_LISTS || QT == 8, "the scores tier is QT = 8");
};

template <int QT, int TIER>
__device__ __forceinline__ int swizzle(int row) {
  return (row / Tile<QT, TIER>::kRPL) & Tile<QT, TIER>::kSwz;
}

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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ------------------------------------------------- selection helpers

// shared header of a selection: a 256-bin histogram, the warp sums (up to
// 16 warps), the radix picks
constexpr int kHeaderInts = 256 + 16 + 8;

// order-preserving key of an f32 (larger float, larger key); -0.0 is +0.0
__device__ __forceinline__ unsigned order_key(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// exclusive prefix sum of v over the NT threads; *total gets the sum
template <int NT>
__device__ int block_excl_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// The key of the k-th largest of get(0..m) and how many elements equal to it
// a stable top-k takes (1 <= need): four 8-bit passes, most significant
// first, each a histogram of the keys that match the digits found so far.
// All NT threads call it.
template <int NT, class Get>
__device__ void radix_select(Get get, int m, int k, int* hdr, unsigned* key,
                             int* need) {
  static_assert(NT >= 256, "one thread a digit");
  int* hist = hdr;
  int* warp_sums = hdr + 256;
  int* pick = warp_sums + 16;
  const int tid = threadIdx.x;
  unsigned prefix = 0, mask = 0;
  int kr = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (tid < 256) hist[tid] = 0;
    __syncthreads();
    for (int i = tid; i < m; i += NT) {
      const unsigned kk = order_key(get(i));
      if ((kk & mask) == prefix) atomicAdd(&hist[(kk >> shift) & 255], 1);
    }
    __syncthreads();
    // thread tid counts digit 255 - tid; the scan gives the larger digits'
    const int cnt = tid < 256 ? hist[255 - tid] : 0;
    int total;
    const int above = block_excl_scan<NT>(cnt, warp_sums, &total);
    if (above < kr && kr <= above + cnt) {
      pick[0] = 255 - tid;
      pick[1] = above;
    }
    __syncthreads();
    prefix |= (unsigned)pick[0] << shift;
    mask |= 255u << shift;
    kr -= pick[1];
    __syncthreads();
  }
  *key = prefix;
  *need = kr;
}

// Write to dst, in ascending index order, the indices i of get(0..m) whose
// key is above thr, and the first `need` whose key equals it: k in all.
// Each thread takes kRun consecutive indices, so one block-wide scan a
// NT * kRun chunk places them.
constexpr int kRun = 8;

template <int NT, class Get>
__device__ void ordered_compact(Get get, int m, unsigned thr, int need,
                                int k, int* dst, int* hdr) {
  int* warp_sums = hdr + 256;
  int base_gt = 0, base_eq = 0;
  for (int i0 = 0; i0 < m && base_gt + min(base_eq, need) < k;
       i0 += NT * kRun) {
    const int first = i0 + threadIdx.x * kRun;
    unsigned kk[kRun];
    int gt = 0, eq = 0;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      kk[j] = first + j < m ? order_key(get(first + j)) : 0u;
      gt += first + j < m && kk[j] > thr;
      eq += first + j < m && kk[j] == thr;
    }
    int total;
    const int ex = block_excl_scan<NT>((gt << 16) | eq, warp_sums, &total);
    int n_gt = base_gt + (ex >> 16), n_eq = base_eq + (ex & 0xffff);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (first + j >= m) break;
      const bool g = kk[j] > thr, e = kk[j] == thr;
      if (g || (e && n_eq < need)) dst[n_gt + min(n_eq, need)] = first + j;
      n_gt += g;
      n_eq += e;
    }
    base_gt += total >> 16;
    base_eq += total & 0xffff;
  }
  __syncthreads();
}

// rank of winner i among the k winners dst[0..k) of get: (key desc,
// position asc); positions are unique, so the ranks are 0..k-1
template <class Get>
__device__ __forceinline__ int winner_rank(Get get, const int* win, int k,
                                           int i) {
  const int pi = win[i];
  const unsigned ki = order_key(get(pi));
  int rank = 0;
  for (int j = 0; j < k; ++j) {
    const int pj = win[j];
    const unsigned kj = order_key(get(pj));
    rank += kj > ki || (kj == ki && pj < pi);
  }
  return rank;
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

// A query's list of its k best (score, column) pairs lives in shared
// memory, sorted by better(). While a warp works on it lane j < k holds
// entry j, and the lanes past k a pair worse than any.
__device__ __forceinline__ void load_list(const float* lv, const int* lc,
                                          int k, int lane, float& v, int& c) {
  v = lane < k ? lv[lane] : -INFINITY;
  c = lane < k ? lc[lane] : 0x7fffffff;
}

// Sort one (score, column) pair a lane into descending better() order
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

// The k-th largest of one value a lane (k <= 32).
__device__ __forceinline__ float warp_kth_largest(float x, int k, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int s = size / 2; s; s >>= 1) {
      const float y = __shfl_xor_sync(kFull, x, s);
      const bool keep_max = ((lane & size) == 0) == ((lane & s) == 0);
      x = keep_max ? fmaxf(x, y) : fminf(x, y);
    }
  }
  return __shfl_sync(kFull, x, k - 1);
}

// The selection filters docs on a "goodness" computed before the score
// transform: l2 -max(|q|^2 - 2 q.v + |v|^2, 0), cosine q.v / |v| (|q| times
// the cosine), dot q.v. A score is a non-decreasing function of it, and two
// goodnesses further apart than slack() give scores that differ, so a doc
// whose goodness falls more than the slack below another's scores strictly
// lower (2^-12 relative, and 2^-20 absolute, 2^-11 |q| for cosine: far above
// the rounding of either).
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
// -inf when thr is not finite (a list not yet holding k docs)
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
                                         int col0, int lane, float& v,
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
        cc = col0 + src + 32 * i;
      }
      before += ci;
    }
    warp_sort(cv, cc, lane);
    merge_lists(v, c, __shfl_sync(kFull, cv, 31 - lane),
                __shfl_sync(kFull, cc, 31 - lane), lane);
  }
}

// Add one query's passers to its list (lv, lc) and raise the group's bound
// (*low) to the list's new k-th entry: lane l's docs col0 + l + 32 i for
// the set bits l of m_i, with dots a_i and norms n_i. Each passing lane
// transforms its own docs; then the warp, holding the list one entry a
// lane, inserts them one at a time (a ballot finds the place, the entries
// below shift down a lane), and stores it back.
__device__ __forceinline__ void add_passers(const unsigned (&mk)[4],
                                            const float (&a)[4],
                                            const float (&ns)[4], float qq,
                                            float qn, int col0, float* lv,
                                            int* lc, int* low, int k, int sim,
                                            int lane) {
  float s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s[i] = (mk[i] >> lane) & 1 ? transform_score(a[i], qq, ns[i], sim)
                               : -INFINITY;
  float v;
  int c;
  load_list(lv, lc, k, lane, v, c);
  if (__popc(mk[0]) + __popc(mk[1]) + __popc(mk[2]) + __popc(mk[3]) > 32) {
    merge_flood(mk[0], mk[1], mk[2], mk[3], s[0], s[1], s[2], s[3], col0,
                lane, v, c);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned m = mk[i];
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const float cv = __shfl_sync(kFull, s[i], src);
        const int cc = col0 + src + 32 * i;
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
  if (lane < k) {
    lv[lane] = v;
    lc[lane] = c;
  }
  const float kth = __shfl_sync(kFull, v, k - 1);
  if (lane == 0) atomicMax(low, ord_int(threshold_goodness(kth, qn, sim)));
  __syncwarp();
}

// ------------------------------------------------------------ stage 1

__host__ __device__ inline int chunked_width(int qt, int tier, int d) {
  const int dc = stage_floats(qt, tier) / (subs_per_step(qt) * kSub);
  return (d + dc - 1) / dc * dc;
}

__host__ inline size_t stage1_smem_bytes(int qt, int tier, int d, int k) {
  size_t words = (size_t)ring_stages(qt, tier) * stage_floats(qt, tier) +
                 (size_t)qt * chunked_width(qt, tier, d) + 2 * (size_t)qt;
  if (tier == TIER_SCORES)  // the block's scores, the header, the winners
    return 4 * (words + (size_t)qt * kBlock + kHeaderInts + kBlock);
  // each warp's lists (8 queries x k pairs), each query's least goodness
  return 4 * (words + 2 * (size_t)scan_threads(qt) / 32 * 8 * k + qt);
}

// grid (CTAs per query tile, ceil(rows / QT)); dynamic shared memory
// stage1_smem_bytes(QT, TIER, d, k). Queries [0, rows) of the B are scored
// and written; each CTA walks the blocks blockIdx.x + j * gridDim.x.
template <int QT, int TIER, int PREC>
__global__ void __launch_bounds__(scan_threads(QT), 1) knn_pb_kernel(
    const float* __restrict__ v,        // [n, d] f32, d % 4 == 0
    const float* __restrict__ nsq,      // [n]
    const uint8_t* __restrict__ valid,  // [n] 0 / 1
    const float* __restrict__ q,        // [B, d] f32
    const float* __restrict__ qsq,      // [B]
    float* __restrict__ out_v,          // [nb, B, k]
    int* __restrict__ out_i,            // [nb, B, k]
    int n, int d, int B, int rows, int nb, int k, int sim) {
  using T = Tile<QT, TIER>;
  constexpr int kThreads = T::kThreads;
  constexpr int kStages = T::kStages, kStageFloats = T::kStageFloats;
  constexpr int kSteps = T::kSteps;
  const int NC = (d + T::kDC - 1) / T::kDC;
  const int dp = NC * T::kDC;
  const int q0 = blockIdx.y * QT;
  const int qb = min(QT, rows - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sb = warp % T::kSPS, g = warp / T::kSPS;  // sub-block, group

  extern __shared__ __align__(16) float scan_smem[];
  float* ring = scan_smem;                    // [kStages][kSD][kDC]
  float* qs = ring + kStages * kStageFloats;  // [QT][dp]
  float* qsq_s = qs + QT * dp;                // [QT]
  float* qn_s = qsq_s + QT;                   // [QT] cosine's |q|
  float* rest = qn_s + QT;
  // list tier: each warp's lists [kWarps][8][k] and, per query, the least
  // goodness (ord_int) a doc of the block must reach to enter a list,
  // raised by every warp of the group as its list fills: a doc below
  // another warp's k-th entry cannot be in the block's top-k either
  constexpr int kLists = T::kWarps * 8;
  float* lst_v = rest;
  int* lst_c = reinterpret_cast<int*>(lst_v + kLists * k);
  int* low_g = lst_c + kLists * k;
  // scores tier: the block's scores, the selection header, the winners
  float* sc = rest;                                   // [QT][kBlock]
  int* hdr = reinterpret_cast<int*>(sc + QT * kBlock);
  int* win = hdr + kHeaderInts;                       // [kBlock]

  for (int e = tid; e < QT * dp; e += kThreads) {
    const int r = e / dp, c = e - r * dp;
    qs[e] = (r < qb && c < d)
                ? load_as_float<PREC>(q, (size_t)(q0 + r) * d + c)
                : 0.0f;
  }
  for (int e = tid; e < QT; e += kThreads) {
    const float s = e < qb ? qsq[q0 + e] : 0.0f;
    qsq_s[e] = s;
    qn_s[e] = __fsqrt_rn(fmaxf(s, 1e-24f));
  }

  const int my_blocks = (int)blockIdx.x < nb
                            ? (nb - 1 - blockIdx.x) / gridDim.x + 1
                            : 0;
  const int n_tiles = my_blocks * kSteps * NC;

  // copy tile t (chunk t % NC of step t / NC % kSteps of the CTA's block
  // t / (NC kSteps)) into ring stage t % kStages; rows past n and columns
  // past d are zero-filled
  int in_c = 0, in_doc = blockIdx.x * kBlock;
  auto issue = [&](int t) {
    if (t < n_tiles) {
      float* st = ring + (t % kStages) * kStageFloats;
      for (int e = tid; e < T::kSD * T::kU; e += kThreads) {
        const int r = e / T::kU, u = e - r * T::kU;
        const int doc = in_doc + r, col = in_c * T::kDC + u * 4;
        const bool in = doc < n && col < d;
        cp_async16(st + r * T::kDC + ((u ^ swizzle<QT, TIER>(r)) << 2),
                   in ? v + (size_t)doc * d + col : v, in ? 16 : 0);
      }
      if (++in_c == NC) {  // the next step, or the next block's first
        in_c = 0;
        in_doc += T::kSD;
        if (in_doc % kBlock == 0) in_doc += (gridDim.x - 1) * kBlock;
      }
    }
    cp_async_commit();
  };

  int roff[4], rsw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = sb * kSub + lane + 32 * i;
    roff[i] = r * T::kDC;
    rsw[i] = swizzle<QT, TIER>(r);
  }
  // the warp's 8 queries: rows past `rows` leave it idle
  const int gq = g * 8;
  const bool live = gq < qb;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.0f;
  float ns[4];
  bool ok[4];

  for (int s = 0; s < kStages - 1; ++s) issue(s);

  int c = 0, step = 0, blk = blockIdx.x;
  for (int t = 0; t < n_tiles; ++t) {
    const int base = blk * kBlock;
    const int docb = base + step * T::kSD + sb * kSub;
    if (TIER == TIER_LISTS && step == 0 && c == 0) {
      for (int e = tid; e < kLists * k; e += kThreads) {
        lst_v[e] = -INFINITY;
        lst_c[e] = base;
      }
      for (int e = tid; e < QT; e += kThreads) low_g[e] = ord_int(-INFINITY);
    }
    if (c == 0) {  // the step's norms and flags, used after its last chunk
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int doc = docb + lane + 32 * i;
        ok[i] = doc < n && valid[doc] != 0;
        ns[i] = doc < n ? nsq[doc] : 0.0f;
      }
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(t + kStages - 1);

    const float* st = ring + (t % kStages) * kStageFloats;
    const float* qg = qs + gq * dp + c * T::kDC;
    if (live) {
#pragma unroll 4
      for (int kk = 0; kk < T::kU; ++kk) {
        float4 x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = *reinterpret_cast<const float4*>(st + roff[i] +
                                                  ((kk ^ rsw[i]) << 2));
          if (PREC == PREC_FP32_AS_BF16) {
            x[i].x = bf16_round(x[i].x);
            x[i].y = bf16_round(x[i].y);
            x[i].z = bf16_round(x[i].z);
            x[i].w = bf16_round(x[i].w);
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 y =
              *reinterpret_cast<const float4*>(qg + u * dp + kk * 4);
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
    if (++c < NC) continue;
    c = 0;
    const int this_step = step;
    if (++step == kSteps) {
      step = 0;
      blk += gridDim.x;
    }

    // ---- the step's scores
    if constexpr (TIER == TIER_SCORES) {
      if (live) {
        const int col0 = docb - base;
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sc[(gq + u) * kBlock + col0 + lane + 32 * i] =
                ok[i] ? transform_score(acc[i][u], qsq_s[gq + u], ns[i], sim)
                      : -INFINITY;
      }
    } else if (live) {
      float rvn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (sim == SIM_COSINE) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rvn[i] = __frcp_rn(__fsqrt_rn(fmaxf(ns[i], 1e-24f)));
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (gq + u >= qb) continue;  // a row past `rows`: no list
        const float qq = qsq_s[gq + u], qn = qn_s[gq + u];
        float gd[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          gd[i] = ok[i] ? goodness(acc[i][u], qq, ns[i], rvn[i], sim)
                        : -INFINITY;
        float lower = ord_float(low_g[gq + u]);
        if (this_step == 0) {
          // in the warp's first step of the block the k-th largest of the
          // lanes' best goodness bounds the step's k-th best doc from below
          const float m = fmaxf(fmaxf(gd[0], gd[1]), fmaxf(gd[2], gd[3]));
          const float g0 = warp_kth_largest(m, k, lane);
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
        const int l = (warp * 8 + u) * k;
        const float au[4] = {acc[0][u], acc[1][u], acc[2][u], acc[3][u]};
        add_passers(mk, au, ns, qq, qn, docb, lst_v + l, lst_c + l,
                    low_g + gq + u, k, sim, lane);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[i][u] = 0.0f;
    if (step != 0) continue;

    // ---- the block's end (uniform over the CTA)
    __syncthreads();
    if constexpr (TIER == TIER_SCORES) {
      for (int u = 0; u < qb; ++u) {
        const float* row = sc + u * kBlock;
        const auto get = [&](int i) { return row[i]; };
        unsigned thr;
        int need;
        radix_select<kThreads>(get, kBlock, k, hdr, &thr, &need);
        ordered_compact<kThreads>(get, kBlock, thr, need, k, win, hdr);
        for (int i = tid; i < k; i += kThreads) {
          const int rank = winner_rank(get, win, k, i);
          const float sv = row[win[i]];
          const size_t o = ((size_t)(base / kBlock) * B + q0 + u) * k + rank;
          out_v[o] = sv;
          out_i[o] = sv > -INFINITY ? base + win[i] : base;
        }
        __syncthreads();
      }
      continue;
    }
    // warp sb merges the group's lists of queries sb, sb + kSPS, ... and
    // writes their k slots
    if (live) {
      for (int u = sb; u < 8; u += T::kSPS) {
        if (gq + u >= qb) break;
        float ev;
        int ec;
        const int w0 = g * T::kSPS;
        load_list(lst_v + (w0 * 8 + u) * k, lst_c + (w0 * 8 + u) * k, k,
                  lane, ev, ec);
        for (int w = w0 + 1; w < w0 + T::kSPS; ++w) {
          const int o = (w * 8 + u) * k + 31 - lane;
          merge_lists(ev, ec, 31 - lane < k ? lst_v[o] : -INFINITY,
                      31 - lane < k ? lst_c[o] : 0x7fffffff, lane);
        }
        if (lane < k) {
          const size_t o = ((size_t)(base / kBlock) * B + q0 + gq + u) * k +
                           lane;
          out_v[o] = ev;
          out_i[o] = ec;
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------ stage 2

constexpr int kMergeThreads = 512;

__host__ inline size_t merge_smem_bytes(int nb, int k, bool row) {
  return 4 * ((size_t)kHeaderInts + k + (row ? (size_t)nb * k : 0));
}

// grid (rows: the queries to merge, of B); dynamic shared memory
// merge_smem_bytes(nb, k, row_in_smem)
__global__ void __launch_bounds__(kMergeThreads) knn_pb_merge_kernel(
    const float* __restrict__ vals,  // [nb, B, k]
    const int* __restrict__ ids,     // [nb, B, k]
    float* __restrict__ out_v,       // [B, k]
    int* __restrict__ out_i,         // [B, k]
    int B, int nb, int k, int row_in_smem) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int m = nb * k;
  extern __shared__ __align__(16) int merge_smem[];
  int* hdr = merge_smem;
  int* win = hdr + kHeaderInts;
  float* row = reinterpret_cast<float*>(win + k);
  // candidate i of the block-major row: block i / k, rank i % k
  const auto at = [&](int i) {
    const int blk = i / k;
    return ((size_t)blk * B + b) * k + (i - blk * k);
  };
  if (row_in_smem) {
    for (int i = tid; i < m; i += kMergeThreads) row[i] = vals[at(i)];
    __syncthreads();
  }
  const auto get = [&](int i) { return row_in_smem ? row[i] : vals[at(i)]; };
  unsigned thr;
  int need;
  radix_select<kMergeThreads>(get, m, k, hdr, &thr, &need);
  ordered_compact<kMergeThreads>(get, m, thr, need, k, win, hdr);
  for (int i = tid; i < k; i += kMergeThreads) {
    const int rank = winner_rank(get, win, k, i);
    const float sv = get(win[i]);
    out_v[(size_t)b * k + rank] = sv;
    out_i[(size_t)b * k + rank] = isfinite(sv) ? ids[at(win[i])] : -1;
  }
}

// ------------------------------------------------------------------ host

template <int QT, int TIER, int PREC>
cudaError_t launch_stage1(cudaStream_t st, const float* v, const float* nsq,
                          const uint8_t* valid, const float* q,
                          const float* qsq, float* out_v, int* out_i, int n,
                          int d, int B, int rows, int nb, int k, int sim) {
  const size_t smem = stage1_smem_bytes(QT, TIER, d, k);
  const auto kernel = knn_pb_kernel<QT, TIER, PREC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, Tile<QT, TIER>::kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int n_qt = (rows + QT - 1) / QT;
  const int gx = std::min(nb, std::max(1, per_sm * sms / n_qt));
  kernel<<<dim3(gx, n_qt), Tile<QT, TIER>::kThreads, smem, st>>>(
      v, nsq, valid, q, qsq, out_v, out_i, n, d, B, rows, nb, k, sim);
  return cudaGetLastError();
}

cudaError_t stage1_launch(int qt, int tier, int exact, cudaStream_t st,
                          const float* v, const float* nsq,
                          const uint8_t* valid, const float* q,
                          const float* qsq, float* out_v, int* out_i, int n,
                          int d, int B, int rows, int nb, int k, int sim) {
#define PB_LAUNCH(QT, TIER)                                                   \
  return exact ? launch_stage1<QT, TIER, PREC_FP32>(                          \
                     st, v, nsq, valid, q, qsq, out_v, out_i, n, d, B, rows,  \
                     nb, k, sim)                                              \
               : launch_stage1<QT, TIER, PREC_FP32_AS_BF16>(                  \
                     st, v, nsq, valid, q, qsq, out_v, out_i, n, d, B, rows,  \
                     nb, k, sim)
  if (tier == TIER_SCORES) {
    if (qt == 8) PB_LAUNCH(8, TIER_SCORES);
  } else if (qt == 8) {
    PB_LAUNCH(8, TIER_LISTS);
  } else if (qt == 32) {
    PB_LAUNCH(32, TIER_LISTS);
  } else if (qt == 128) {
    PB_LAUNCH(128, TIER_LISTS);
  }
#undef PB_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory one stage-1 CTA needs at query tile qt,
// tier (0: lists, 1: scores in shared memory), width d and k
size_t knn_pb_smem_bytes(int qt, int tier, int d, int k) {
  return stage1_smem_bytes(qt, tier, d, k);
}

// Stage 1 on `stream`: (vals, ids) [nb, B, k], rows [0, rows) written.
// Returns the first cudaError_t met (0 = launched).
int knn_pb_launch(const void* v, const void* nsq, const void* valid,
                  const void* q, const void* qsq, void* out_v, void* out_i,
                  int n, int d, int B, int rows, int nb, int k, int qt,
                  int tier, int sim, int exact, void* stream) {
  return (int)stage1_launch(
      qt, tier, exact, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(v), static_cast<const float*>(nsq),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(q),
      static_cast<const float*>(qsq), static_cast<float*>(out_v),
      static_cast<int*>(out_i), n, d, B, rows, nb, k, sim);
}

// bytes of dynamic shared memory one stage-2 CTA needs; row != 0 stages
// the query's nb * k candidates in shared memory
size_t knn_pb_merge_smem_bytes(int nb, int k, int row) {
  return merge_smem_bytes(nb, k, row != 0);
}

// Stage 2 on `stream`: rows [0, rows) of (out_v, out_i) [B, k] from
// (vals, ids) [nb, B, k]. Returns the first cudaError_t met.
int knn_pb_merge_launch(const void* vals, const void* ids, void* out_v,
                        void* out_i, int B, int rows, int nb, int k, int row,
                        void* stream) {
  const size_t smem = merge_smem_bytes(nb, k, row != 0);
  cudaError_t e = cudaFuncSetAttribute(
      knn_pb_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  knn_pb_merge_kernel<<<rows, kMergeThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(ids),
      static_cast<float*>(out_v), static_cast<int*>(out_i), B, nb, k, row);
  return (int)cudaGetLastError();
}

}  // extern "C"
