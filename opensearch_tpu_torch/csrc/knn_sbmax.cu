// K5 for Hopper (sm_90a): sub-block maxima of exact kNN scores (stage 1),
// then the selection of the k best sub-blocks, their exact rescore and the
// top-k cut (stage 2). Two launches a call.
//
// Replaces: opensearch_tpu/ops/pallas_knn.py::_knn_sbmax_kernel (launched by
// pallas_knn_sbmax_topk) and the XLA selection and rescore after it
// (pallas_knn.py:468-498). Same contract: stage 1 writes, for every
// 2048-doc block and query, the maximum score of each of its sixteen
// 128-doc sub-blocks as [nb, B, 16] (dead docs and rows past n score -inf,
// so such a sub-block reports -inf); stage 2 takes the k sub-blocks with
// the largest maxima (ties to the lower one), rescores their k * 128 docs
// and returns the top k under (score desc, doc id asc). exact = 1 scores in
// fp32 (the TPU's HIGHEST); exact = 0 rounds both operands to bf16 as they
// are loaded and sums the exact products in f32 (one bf16 MXU pass), on
// FFMA, never TF32. Every dot sums its d products in ascending order in one
// f32 accumulator.
//
// Bound of stage 1: the slab once (4nd bytes), norms and valid flags (5n),
// the maxima out, against 2*B*n*d FFMA operations: bytes up to about
// B = 80 at d = 128, operations above.
//
// Stage 1 design.
// - Query tile QT in {8, 32, 128}, chosen by the wrapper from the padded
//   batch, so B = 1 (padded to 8) computes 8 rows and B = 128 one tile.
// - Each thread holds a 4-doc x 8-query register micro-tile; a warp holds
//   one 128-doc sub-block against one 8-query group. Operands come from
//   shared memory as float4: per 4 steps of d a thread issues 4 doc loads
//   and 8 query loads (warp-wide broadcasts) for 128 FMAs.
// - Doc tiles arrive through a ring of cp.async 16-byte copies (3 stages of
//   64 KB up to QT = 32, 4 of 32 KB at 128; d is cut into chunks of kDC
//   floats to fit), so two or three tiles are in flight while one is
//   scored. Rows
//   are XOR-swizzled in units of 16 bytes so the eight rows a quarter-warp
//   reads fall in distinct banks.
// - A warp owns whole 128-doc sub-blocks (lane l holds docs l, l+32, l+64,
//   l+96), so a (query, sub-block) maximum is reduced in registers and by
//   warp shuffles and written once; no score goes through shared memory.
//   The score transforms are monotone in their last rounded quantity (l2's
//   |q|^2 - 2 q.v + |v|^2, cosine's q.v / (|q||v|), dot's q.v), so the
//   reduction runs on that quantity and transforms once per maximum, which
//   gives the same bits as the maximum of the transformed scores.
// - Grid: persistent, (CTAs per query tile, query tiles), one CTA per SM at
//   these shared-memory sizes; each CTA walks steps of SPS sub-blocks
//   strided by the grid. The (query tile, 2048-doc block) grid would leave
//   489 CTAs over 132 SMs at QT = 128, 3.7 waves with the last 70% full;
//   walking 128-doc steps splits the 7,824 sub-blocks 59 or 60 a CTA. The
//   CTAs of all query tiles walk the same steps together, so a doc tile is
//   read from device memory about once and from L2 for the other tiles.
//
// Stage 2 design: one 512-thread CTA per (padded) query, its row of maxima
// staged in shared memory. (a) A radix select (four 8-bit passes over
// order-preserving uint32 keys, -0.0 folded to +0.0) finds the k-th largest
// maximum; an ordered compaction (block-wide prefix sums in index order)
// takes every maximum above it and the first k - count_above equal to it:
// the k sub-blocks of a stable top-k, already in ascending order. (b) The
// k * 128 candidates are rescored in fp32 FFMA into shared memory (a global
// scratch from the wrapper past ~200 KB), 16 loads in flight a thread.
// (c) The same select-and-compact over the candidate scores, in doc-id
// order, picks the k winners with ties to the lower id; each winner's rank
// is counted against the others (exact: positions are unique).

#include "knn_tile.cuh"

namespace {

constexpr int kBlock = 2048;  // PB_BLOCK
constexpr int kSub = 128;     // SUB
constexpr int kSubs = kBlock / kSub;

// Stage 1's shape at query tile qt, as measured on one H100 at the SIFT-1M
// shape (scripts/sbmax_variants.py): 512 threads from qt = 32, whose 16
// warps hide shared-memory latency better than 8 warps holding twice the
// queries each; 3 ring stages of 64 KB up to qt = 32, where device memory
// binds (longer row chunks, more bytes in flight), and 4 of 32 KB at
// qt = 128, whose 64 KB query tile leaves no room for more.
__host__ __device__ constexpr int scan_threads(int qt) {
  return qt >= 32 ? 512 : 256;
}
__host__ __device__ constexpr int ring_stages(int qt) {
  return qt <= 32 ? 3 : 4;
}
__host__ __device__ constexpr int stage_floats(int qt) {
  return qt <= 32 ? 16384 : 8192;
}

// 128-doc sub-blocks a CTA step covers at query tile qt: each warp holds
// one (sub-block, 8-query group) pair
__host__ __device__ constexpr int subs_per_step(int qt) {
  return scan_threads(qt) / 32 / (qt / 8);
}

template <int QT>
struct Tile {
  static constexpr int kThreads = scan_threads(QT);
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kStages = ring_stages(QT);
  static constexpr int kStageFloats = stage_floats(QT);
  static constexpr int kGroups = QT / 8;  // 8-query groups
  static constexpr int kSPS = subs_per_step(QT);
  static constexpr int kSD = kSPS * kSub;               // docs a step
  static constexpr int kDC = kStageFloats / kSD;        // d chunk (floats)
  static constexpr int kU = kDC / 4;                    // 16-byte units a row
  static constexpr int kRPL = kU >= 8 ? 1 : 8 / kU;     // rows a 128-byte line
  static constexpr int kSwz = (kU >= 8 ? 8 : kU) - 1;
  static_assert(kSPS >= 1 && kSPS * kGroups == kWarps,
                "the warps split the step's (sub-block, group) pairs");
  static_assert(kDC % 4 == 0, "a row chunk is whole 16-byte units");
};

template <int QT>
__device__ __forceinline__ int swizzle(int row) {
  return (row / Tile<QT>::kRPL) & Tile<QT>::kSwz;
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

__host__ __device__ inline int chunked_width(int qt, int d) {
  const int dc = stage_floats(qt) / (subs_per_step(qt) * kSub);
  return (d + dc - 1) / dc * dc;
}

__host__ inline size_t stage1_smem_bytes(int qt, int d) {
  return 4 * ((size_t)ring_stages(qt) * stage_floats(qt) +
              (size_t)qt * chunked_width(qt, d) + 2 * (size_t)qt);
}

// grid (CTAs per query tile, ceil(B / QT)); dynamic shared memory
// stage1_smem_bytes(QT, d)
template <int QT, int PREC>
__global__ void __launch_bounds__(scan_threads(QT), 1) sbmax_stage1_kernel(
    const float* __restrict__ v,        // [n, d] f32, d % 4 == 0
    const float* __restrict__ nsq,      // [n]
    const uint8_t* __restrict__ valid,  // [n] 0 / 1
    const float* __restrict__ q,        // [B, d] f32
    const float* __restrict__ qsq,      // [B]
    float* __restrict__ out,            // [nb, B, kSubs]
    int n, int d, int B, int n_steps, int sim) {
  using T = Tile<QT>;
  constexpr int kThreads = T::kThreads;
  constexpr int kStages = T::kStages, kStageFloats = T::kStageFloats;
  const int NC = (d + T::kDC - 1) / T::kDC;
  const int dp = NC * T::kDC;
  const int q0 = blockIdx.y * QT;
  const int qb = min(QT, B - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sb = warp % T::kSPS, g = warp / T::kSPS;  // sub-block, group

  extern __shared__ __align__(16) float scan_smem[];
  float* ring = scan_smem;                    // [kStages][kSD][kDC]
  float* qs = ring + kStages * kStageFloats;  // [QT][dp]
  float* qsq_s = qs + QT * dp;                // [QT]
  float* qn_s = qsq_s + QT;                   // [QT] cosine's |q|

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

  const int my_steps = (int)blockIdx.x < n_steps
                           ? (n_steps - 1 - blockIdx.x) / gridDim.x + 1
                           : 0;
  const int n_tiles = my_steps * NC;

  // copy tile t (step t / NC, d chunk t % NC) into ring stage t % kStages;
  // rows past n and columns past d are zero-filled
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int ti = t / NC, c = t - ti * NC;
      const int doc0 = (blockIdx.x + ti * gridDim.x) * T::kSD;
      float* st = ring + (t % kStages) * kStageFloats;
      for (int e = tid; e < T::kSD * T::kU; e += kThreads) {
        const int r = e / T::kU, u = e - r * T::kU;
        const int doc = doc0 + r, col = c * T::kDC + u * 4;
        const bool in = doc < n && col < d;
        cp_async16(st + r * T::kDC + ((u ^ swizzle<QT>(r)) << 2),
                   in ? v + (size_t)doc * d + col : v, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  int roff[4], rsw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = sb * kSub + lane + 32 * i;
    roff[i] = r * T::kDC;
    rsw[i] = swizzle<QT>(r);
  }
  // the warp's 8 queries: rows past B leave it idle
  const int gq = g * 8;
  const bool live = gq < qb;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.0f;
  float ns[4], vn[4];
  bool ok[4];

  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int t = 0; t < n_tiles; ++t) {
    const int ti = t / NC, c = t - ti * NC;
    const int docb = (blockIdx.x + ti * gridDim.x) * T::kSD + sb * kSub;
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

    if (c == NC - 1 && live) {  // the step's sub-block maxima
      const bool any =
          __ballot_sync(kFull, ok[0] || ok[1] || ok[2] || ok[3]) != 0;
      if (sim == SIM_COSINE) {
#pragma unroll
        for (int i = 0; i < 4; ++i) vn[i] = __fsqrt_rn(fmaxf(ns[i], 1e-24f));
      }
      const int sbg = docb / kSub;
      const int blk = sbg / kSubs, sbi = sbg - blk * kSubs;
      float mine = 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        // l2: the least |q|^2 - 2 q.v + |v|^2; cosine: the largest
        // q.v / (|q||v|); dot: the largest q.v (valid docs only)
        float m = sim == SIM_L2 ? INFINITY : -INFINITY;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!ok[i]) continue;
          const float a = acc[i][u];
          if (sim == SIM_L2) {
            const float t2 = __fadd_rn(
                __fsub_rn(qsq_s[gq + u], __fmul_rn(2.0f, a)), ns[i]);
            m = fminf(m, t2);
          } else if (sim == SIM_COSINE) {
            m = fmaxf(m, __fdiv_rn(a, __fmul_rn(qn_s[gq + u], vn[i])));
          } else {
            m = fmaxf(m, a);
          }
        }
        for (int o = 16; o; o >>= 1) {
          const float other = __shfl_xor_sync(kFull, m, o);
          m = sim == SIM_L2 ? fminf(m, other) : fmaxf(m, other);
        }
        if (lane == u) mine = m;
      }
      if (lane < 8 && gq + lane < qb) {
        float score = -INFINITY;
        if (any) {
          if (sim == SIM_L2)
            score = __fdiv_rn(1.0f, __fadd_rn(1.0f, fmaxf(mine, 0.0f)));
          else if (sim == SIM_COSINE)
            score = __fdiv_rn(__fadd_rn(1.0f, mine), 2.0f);
          else
            score = transform_score(mine, 0.0f, 0.0f, SIM_DOT);
        }
        out[((size_t)blk * B + q0 + gq + lane) * kSubs + sbi] = score;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[i][u] = 0.0f;
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- stage 2

constexpr int kSelThreads = 512;
constexpr int kSelWarps = kSelThreads / 32;
// shared header: a 256-bin histogram, the warp sums, the radix picks
constexpr int kHeaderInts = 256 + kSelWarps + 8;

// order-preserving key of an f32 (larger float, larger key); -0.0 is +0.0
__device__ __forceinline__ unsigned order_key(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// exclusive prefix sum of v over the CTA; *total gets the sum
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
  for (int w = 0; w < kSelWarps; ++w) {
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
// All threads of the CTA call it.
template <class Get>
__device__ void radix_select(Get get, int m, int k, int* hdr, unsigned* key,
                             int* need) {
  int* hist = hdr;
  int* warp_sums = hdr + 256;
  int* pick = warp_sums + kSelWarps;
  const int tid = threadIdx.x;
  unsigned prefix = 0, mask = 0;
  int kr = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (tid < 256) hist[tid] = 0;
    __syncthreads();
    for (int i = tid; i < m; i += kSelThreads) {
      const unsigned kk = order_key(get(i));
      if ((kk & mask) == prefix) atomicAdd(&hist[(kk >> shift) & 255], 1);
    }
    __syncthreads();
    // thread tid counts digit 255 - tid; the scan gives the larger digits'
    const int cnt = tid < 256 ? hist[255 - tid] : 0;
    int total;
    const int above = block_excl_scan(cnt, warp_sums, &total);
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
// kSelThreads * kRun chunk places them.
constexpr int kRun = 8;

template <class Get>
__device__ void ordered_compact(Get get, int m, unsigned thr, int need,
                                int k, int* dst, int* hdr) {
  int* warp_sums = hdr + 256;
  int base_gt = 0, base_eq = 0;
  for (int i0 = 0; i0 < m && base_gt + min(base_eq, need) < k;
       i0 += kSelThreads * kRun) {
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
    const int ex = block_excl_scan((gt << 16) | eq, warp_sums, &total);
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

constexpr int kRescoreBatch = 16;  // float4 loads in flight a candidate

// Shared memory of one stage-2 CTA: the query, the header, the row of
// maxima when row != 0, and the selected sub-blocks, candidate scores and
// winners when scratch == 0.
__host__ inline size_t stage2_smem_bytes(int d, int k, int n_sub, bool row,
                                         bool scratch) {
  size_t words = (size_t)(d + 3) / 4 * 4 + kHeaderInts;
  if (row) words += n_sub;
  if (!scratch) words += (size_t)k * (kSub + 2);
  return 4 * words;
}

// grid (B); dynamic shared memory stage2_smem_bytes(d, k, nb * 16,
// row_in_smem, sel_g != null). With sel_g null the selected sub-blocks,
// candidate scores and winners live in shared memory, else in the global
// scratch ([B, k], [B, k * 128], [B, k]).
template <int PREC>
__global__ void __launch_bounds__(kSelThreads) sbmax_stage2_kernel(
    const float* __restrict__ submax,   // [nb, B, kSubs]
    const float* __restrict__ v,        // [n, d] f32, d % 4 == 0
    const float* __restrict__ nsq,      // [n]
    const uint8_t* __restrict__ valid,  // [n]
    const float* __restrict__ q,        // [B, d]
    const float* __restrict__ qsq,      // [B]
    float* __restrict__ out_v,          // [B, k]
    int* __restrict__ out_i,            // [B, k]
    int* sel_g, float* sc_g, int* win_g,
    int n, int d, int B, int nb, int k, int sim, int row_in_smem) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int d4 = (d + 3) / 4 * 4;
  const int n_sub = nb * kSubs;
  extern __shared__ __align__(16) float select_smem[];
  float* qs = select_smem;
  int* hdr = reinterpret_cast<int*>(qs + d4);
  float* row = reinterpret_cast<float*>(hdr + kHeaderInts);
  int* rest = reinterpret_cast<int*>(row + (row_in_smem ? n_sub : 0));
  int *sel, *win;
  float* sc;
  if (sel_g != nullptr) {
    sel = sel_g + (size_t)b * k;
    sc = sc_g + (size_t)b * k * kSub;
    win = win_g + (size_t)b * k;
  } else {
    sel = rest;
    sc = reinterpret_cast<float*>(sel + k);
    win = reinterpret_cast<int*>(sc + (size_t)k * kSub);
  }
  for (int e = tid; e < d4; e += kSelThreads)
    qs[e] = e < d ? load_as_float<PREC>(q, (size_t)b * d + e) : 0.0f;
  if (row_in_smem) {  // the query's maxima, read from device memory once
    for (int i = tid; i < n_sub; i += kSelThreads)
      row[i] = submax[((size_t)(i >> 4) * B + b) * kSubs + (i & 15)];
  }

  // (a) the k sub-blocks with the largest maxima, ascending
  const auto maxima = [&](int i) {
    return row_in_smem ? row[i]
                       : submax[((size_t)(i >> 4) * B + b) * kSubs + (i & 15)];
  };
  unsigned thr;
  int need;
  radix_select(maxima, n_sub, k, hdr, &thr, &need);
  ordered_compact(maxima, n_sub, thr, need, k, sel, hdr);

  // (b) rescore the k * 128 candidates, doc-id-major; each thread keeps
  // kRescoreBatch 16-byte loads of its candidate's row in flight
  const float qq = qsq[b];
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  const int W = d / 4;
  for (int c = tid; c < k * kSub; c += kSelThreads) {
    const int doc = sel[c / kSub] * kSub + (c % kSub);
    float s = -INFINITY;
    if (doc < n && valid[doc] != 0) {
      const float4* vr = reinterpret_cast<const float4*>(v + (size_t)doc * d);
      float a = 0.0f;
      for (int w0 = 0; w0 < W; w0 += kRescoreBatch) {
        float4 x[kRescoreBatch];
#pragma unroll
        for (int j = 0; j < kRescoreBatch; ++j)
          if (w0 + j < W) x[j] = __ldg(vr + w0 + j);
#pragma unroll
        for (int j = 0; j < kRescoreBatch; ++j) {
          if (w0 + j >= W) break;
          if (PREC == PREC_FP32_AS_BF16) {
            x[j].x = bf16_round(x[j].x);
            x[j].y = bf16_round(x[j].y);
            x[j].z = bf16_round(x[j].z);
            x[j].w = bf16_round(x[j].w);
          }
          const float4 y = q4[w0 + j];
          a = __fmaf_rn(x[j].x, y.x, a);
          a = __fmaf_rn(x[j].y, y.y, a);
          a = __fmaf_rn(x[j].z, y.z, a);
          a = __fmaf_rn(x[j].w, y.w, a);
        }
      }
      s = transform_score(a, qq, nsq[doc], sim);
    }
    sc[c] = s;
  }
  __syncthreads();

  // (c) the k best candidates (ties to the lower doc id), then their order
  const auto scores = [&](int i) { return sc[i]; };
  radix_select(scores, k * kSub, k, hdr, &thr, &need);
  ordered_compact(scores, k * kSub, thr, need, k, win, hdr);
  for (int i = tid; i < k; i += kSelThreads) {
    const int pi = win[i];
    const float si = sc[pi];
    const unsigned ki = order_key(si);
    int rank = 0;
    for (int j = 0; j < k; ++j) {
      const int pj = win[j];
      const unsigned kj = order_key(sc[pj]);
      rank += kj > ki || (kj == ki && pj < pi);
    }
    out_v[(size_t)b * k + rank] = si;
    out_i[(size_t)b * k + rank] =
        isfinite(si) ? sel[pi / kSub] * kSub + (pi % kSub) : -1;
  }
}

// ------------------------------------------------------------------ host

template <int QT, int PREC>
cudaError_t launch_stage1(cudaStream_t st, const float* v, const float* nsq,
                          const uint8_t* valid, const float* q,
                          const float* qsq, float* out, int n, int d, int B,
                          int nb, int sim) {
  const size_t smem = stage1_smem_bytes(QT, d);
  const auto kernel = sbmax_stage1_kernel<QT, PREC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    Tile<QT>::kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int n_qt = (B + QT - 1) / QT;
  const int n_steps = nb * kBlock / Tile<QT>::kSD;
  const int gx = min(n_steps, max(1, per_sm * sms / n_qt));
  kernel<<<dim3(gx, n_qt), Tile<QT>::kThreads, smem, st>>>(
      v, nsq, valid, q, qsq, out, n, d, B, n_steps, sim);
  return cudaGetLastError();
}

template <int PREC>
cudaError_t launch_stage1_qt(int qt, cudaStream_t st, const float* v,
                             const float* nsq, const uint8_t* valid,
                             const float* q, const float* qsq, float* out,
                             int n, int d, int B, int nb, int sim) {
  switch (qt) {
    case 8:
      return launch_stage1<8, PREC>(st, v, nsq, valid, q, qsq, out, n, d, B,
                                    nb, sim);
    case 32:
      return launch_stage1<32, PREC>(st, v, nsq, valid, q, qsq, out, n, d, B,
                                     nb, sim);
    case 128:
      return launch_stage1<128, PREC>(st, v, nsq, valid, q, qsq, out, n, d,
                                      B, nb, sim);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int PREC>
cudaError_t launch_stage2(cudaStream_t st, const float* submax,
                          const float* v, const float* nsq,
                          const uint8_t* valid, const float* q,
                          const float* qsq, float* out_v, int* out_i,
                          int* sel_g, float* sc_g, int* win_g, int n, int d,
                          int B, int nb, int k, int sim, int row_in_smem) {
  const size_t smem = stage2_smem_bytes(d, k, nb * kSubs, row_in_smem != 0,
                                        sel_g != nullptr);
  const auto kernel = sbmax_stage2_kernel<PREC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<B, kSelThreads, smem, st>>>(submax, v, nsq, valid, q, qsq, out_v,
                                       out_i, sel_g, sc_g, win_g, n, d, B, nb,
                                       k, sim, row_in_smem);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory one stage-1 CTA needs at query tile qt
size_t knn_sbmax_smem_bytes(int qt, int d) { return stage1_smem_bytes(qt, d); }

// Stage 1 on `stream`: maxima [nb, B, 16] with query tile qt (8, 32 or
// 128). Returns the first cudaError_t met (0 = launched).
int knn_sbmax_launch(const void* v, const void* nsq, const void* valid,
                     const void* q, const void* qsq, void* out, int n, int d,
                     int B, int nb, int qt, int sim, int exact, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vf = static_cast<const float*>(v);
  const float* nf = static_cast<const float*>(nsq);
  const uint8_t* ok = static_cast<const uint8_t*>(valid);
  const float* qf = static_cast<const float*>(q);
  const float* qsqf = static_cast<const float*>(qsq);
  float* of = static_cast<float*>(out);
  return (int)(exact ? launch_stage1_qt<PREC_FP32>(qt, st, vf, nf, ok, qf,
                                                   qsqf, of, n, d, B, nb, sim)
                     : launch_stage1_qt<PREC_FP32_AS_BF16>(
                           qt, st, vf, nf, ok, qf, qsqf, of, n, d, B, nb,
                           sim));
}

// bytes of dynamic shared memory one stage-2 CTA needs over n_sub maxima;
// row != 0 stages the query's maxima in shared memory, scratch != 0 when
// the wrapper passes the global scratch
size_t knn_sbmax_select_smem_bytes(int d, int k, int n_sub, int row,
                                   int scratch) {
  return stage2_smem_bytes(d, k, n_sub, row != 0, scratch != 0);
}

// Stage 2 on `stream`: (out_v, out_i) [B, k] from the maxima [nb, B, 16].
// sel, sc and win are the global scratch ([B, k] int32, [B, k * 128] f32,
// [B, k] int32) or all null; row as for knn_sbmax_select_smem_bytes.
// Returns the first cudaError_t met.
int knn_sbmax_select_launch(const void* submax, const void* v,
                            const void* nsq, const void* valid, const void* q,
                            const void* qsq, void* out_v, void* out_i,
                            void* sel, void* sc, void* win, int n, int d,
                            int B, int nb, int k, int sim, int exact, int row,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sm = static_cast<const float*>(submax);
  const float* vf = static_cast<const float*>(v);
  const float* nf = static_cast<const float*>(nsq);
  const uint8_t* ok = static_cast<const uint8_t*>(valid);
  const float* qf = static_cast<const float*>(q);
  const float* qsqf = static_cast<const float*>(qsq);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  int* sg = static_cast<int*>(sel);
  float* cg = static_cast<float*>(sc);
  int* wg = static_cast<int*>(win);
  return (int)(exact ? launch_stage2<PREC_FP32>(st, sm, vf, nf, ok, qf, qsqf,
                                                ov, oi, sg, cg, wg, n, d, B,
                                                nb, k, sim, row)
                     : launch_stage2<PREC_FP32_AS_BF16>(
                           st, sm, vf, nf, ok, qf, qsqf, ov, oi, sg, cg, wg,
                           n, d, B, nb, k, sim, row));
}

}  // extern "C"
