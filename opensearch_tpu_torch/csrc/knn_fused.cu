// Fused exact-kNN scan with a running top-R pool, for Hopper (sm_90a).
//
// Replaces: opensearch_tpu/ops/pallas_knn.py::_knn_fused_kernel (launched by
// pallas_knn_fused). Same contract: for every shard s and query b, the R best
// docs under the key (score desc, doc id asc), with (-inf, -1) in the slots
// past the shard's valid-doc count. Scores are the k-NN plugin score space:
//   l2      1 / (1 + max(|q|^2 - 2 q.v + |v|^2, 0))
//   cosine  (1 + q.v / (max(|q|^2,1e-24)^.5 * max(|v|^2,1e-24)^.5)) / 2
//   dot     q.v >= 0 ? q.v + 1 : 1 / (1 - q.v)
// Dots: fp32 on FFMA (never TF32: recall 1.0 depends on it); bf16 on the
// tensor cores with f32 accumulation (the tile scan: widened to f32 and
// summed on FFMA); int8 on the tensor cores into int32 (the tile scan:
// __dp4a), exact, then one multiply by the per-shard dequant scale.
//
// Bound: each launch must read the slab once, n*d*w bytes (w = 4, 2 or 1 for
// fp32, bf16, int8), plus 8n bytes of norms and valid flags (4 + 1, rounded
// up in the note to 8), and does 2*B*n*d operations. At serving batch sizes
// (B <= 32) the bytes bound it: 1M x 128 fp32 is 516 MB, 0.154 ms at
// 3.35 TB/s.
//
// Design, against that bound:
//  - The TPU's sequential doc-block grid becomes a loop inside a CTA, and the
//    docs are split over many CTAs (grid.x), so one query still fills the
//    132 SMs; grid.y walks the S shards of the serving step in the same
//    launch, grid.z the 16-query tiles.
//  - Each CTA streams 64-doc tiles of its split through shared memory with
//    coalesced loads (rows padded by one word, so the per-doc dot loop reads
//    distinct banks) and reuses each doc value for 4 queries per thread.
//  - Each CTA keeps a sorted top-R pool per query in shared memory. A doc
//    enters only if its key beats the pool's R-th entry, so once the pool is
//    warm almost every tile costs one compare per (query, doc): the kth-best
//    early exit of the Pallas kernel. Insertion is warp-parallel.
//  - Only the [S, splits, B, R] partial pools reach device memory; a second
//    launch merges the splits per (shard, query) by the same key, so ties go
//    to the lower doc id exactly as the reference's carried-first merge.
//  - The score transform rounds after every operation (__fmul_rn etc., and
//    the library is built with -fmad=false), so it rounds like the plain
//    PyTorch version, which runs one eager operation at a time; at int8 the
//    pools are bit-identical to it.
// The scan and merge kernels live in knn_tile.cuh, which K3 (knn_block.cu)
// instantiates at fp32.
//
// Five designs, chosen by (precision, r) in the wrapper
// (ops/knn_fused.scan_tier), never on failure:
//  - fp32 with r <= 32 (every fp32 serving search at k <= 32): the list
//    scan of knn_pool.cuh (knn_fused_lists_launch): K4's cp.async ring and
//    4 x 8 FFMA micro-tiles, query tiles of 8 / 32 / 128, per-warp sorted
//    lists carried across each CTA's contiguous doc range behind a
//    pre-transform filter, then a CTA-per-query split merge;
//  - fp32 with 32 < r <= 1024 (k = 33-1024 on both serving routes): the
//    wide tier of knn_wide.cuh (knn_fused_wide_launch): the same scan at a
//    query tile of 8, a CTA-wide pool of r per query fed through a
//    candidate buffer and a radix select, then a select-then-sort split
//    merge;
//  - bf16 and int8 with r <= 1024 (every reduced-precision search on both
//    serving routes: R = max(k, min(max(4k, 32), 512))): the wide tier's
//    tensor-core scan of knn_wide_mma.cuh (knn_fused_mma_launch): the same
//    ring, step and selection, the dots by mma.sync (m16n8k16 bf16 into
//    f32, m16n8k32 s8 into s32), then the same split merge;
//  - fp32 with r > 1024 (the stacked serving step asks for r = k_shard =
//    min(k, n_flat), with no cap, as the reference does): the large-r tier
//    of knn_large.cuh (knn_fused_large_launch): the wide tier's scan with
//    each (query, doc)'s score key stored instead of pooled, then a
//    CTA-per-(query, shard) radix select and sort of the r best;
//  - bf16 and int8 with r > 1024 (a reduced-precision k above 1024 on the
//    stacked step): the large-r tier's tensor-core scan of
//    knn_large_mma.cuh (knn_fused_large_mma_launch): the tensor-core
//    tier's dots, each (query, doc)'s score key stored, then the large-r
//    tier's select.
// The tile scan above (knn_fused_launch, any precision, no cp.async
// pipelining, tensor cores or TMA, pools of 16 queries in shared memory)
// serves no shape any more: it is the yardstick timed beside each design.

#include "knn_large_mma.cuh"

extern "C" {

// bytes of dynamic shared memory one scan CTA needs
size_t knn_fused_smem_bytes(int prec, int d, int r) {
  return scan_smem_bytes(prec, d, r);
}

// Scan + merge on `stream`. Returns the first cudaError_t met (0 = launched).
int knn_fused_launch(const void* v, const void* nsq, const void* valid,
                     const void* q, const void* qsq, const void* scale,
                     void* part_v, void* part_i, void* out_v, void* out_i,
                     int S, int n, int d, int B, int r, int prec, int sim,
                     int chunk, int n_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsq_f = static_cast<const float*>(nsq);
  const uint8_t* valid_u8 = static_cast<const uint8_t*>(valid);
  const float* qsq_f = static_cast<const float*>(qsq);
  const float* scale_f = static_cast<const float*>(scale);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  cudaError_t e;
  if (prec == PREC_INT8) {
    e = launch_pool_scan<PREC_INT8>(st, v, nsq_f, valid_u8, q, qsq_f, scale_f,
                                    pv, pi, ov, oi, S, n, d, B, r, sim, chunk,
                                    n_split);
  } else if (prec == PREC_BF16) {
    e = launch_pool_scan<PREC_BF16>(st, v, nsq_f, valid_u8, q, qsq_f, scale_f,
                                    pv, pi, ov, oi, S, n, d, B, r, sim, chunk,
                                    n_split);
  } else {
    e = launch_pool_scan<PREC_FP32>(st, v, nsq_f, valid_u8, q, qsq_f, scale_f,
                                    pv, pi, ov, oi, S, n, d, B, r, sim, chunk,
                                    n_split);
  }
  return (int)e;
}

// bytes of dynamic shared memory the list scan needs at plan (qt, stages);
// 0 for a plan with no kernel
size_t knn_fused_lists_smem_bytes(int qt, int stages, int d, int r) {
  return pool::list_smem_bytes(qt, stages, d, r);
}

// The list scan + merge (fp32, r <= 32, d % 4 == 0, 16-byte aligned rows)
// on `stream`. Returns the first cudaError_t met (0 = launched).
int knn_fused_lists_launch(const void* v, const void* nsq, const void* valid,
                           const void* q, const void* qsq, void* part_v,
                           void* part_i, void* out_v, void* out_i, int S,
                           int n, int d, int B, int r, int sim, int qt,
                           int stages, int chunk, int n_split, void* stream) {
  return (int)pool::launch_list_pool(
      static_cast<cudaStream_t>(stream), static_cast<const float*>(v),
      static_cast<const float*>(nsq), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(q), static_cast<const float*>(qsq),
      static_cast<float*>(part_v), static_cast<int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), S, n, d, B, r,
      sim, qt, stages, chunk, n_split);
}

// bytes of dynamic shared memory the wide tier's scan needs at plan
// (stages, stage_floats, cap) for rows = min(8, B) queries; 0 for a ring
// with no kernel
size_t knn_fused_wide_smem_bytes(int stages, int stage_floats, int d, int r,
                                 int rows, int cap) {
  return wide::wide_smem_bytes(stages, stage_floats, d, r, rows, cap);
}

// The wide tier's scan + merge (fp32, r <= 1024, d % 4 == 0, 16-byte
// aligned rows) on `stream`. Returns the first cudaError_t met.
int knn_fused_wide_launch(const void* v, const void* nsq, const void* valid,
                          const void* q, const void* qsq, void* part_v,
                          void* part_i, void* out_v, void* out_i, int S,
                          int n, int d, int B, int r, int sim, int stages,
                          int stage_floats, int cap, int chunk, int n_split,
                          void* stream) {
  return (int)wide::launch_wide_pool(
      static_cast<cudaStream_t>(stream), static_cast<const float*>(v),
      static_cast<const float*>(nsq), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(q), static_cast<const float*>(qsq),
      static_cast<float*>(part_v), static_cast<int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), S, n, d, B, r,
      sim, stages, stage_floats, cap, chunk, n_split);
}

// bytes of dynamic shared memory the tensor-core scan needs at plan
// (stages, stage_words, cap) for rows = min(8, B) queries of d prec
// elements; 0 for a ring or a precision with no kernel
size_t knn_fused_mma_smem_bytes(int prec, int stages, int stage_words, int d,
                                int r, int rows, int cap) {
  return mma::mma_smem_bytes(prec, stages, stage_words, d, r, rows, cap);
}

// The tensor-core scan + the wide tier's merge (bf16 or int8, r <= 1024,
// rows of whole 16-byte units at 16-byte aligned addresses) on `stream`.
// Returns the first cudaError_t met.
int knn_fused_mma_launch(const void* scale, int prec, const void* v,
                         const void* nsq, const void* valid, const void* q,
                         const void* qsq, void* part_v, void* part_i,
                         void* out_v, void* out_i, int S, int n, int d, int B,
                         int r, int sim, int stages, int stage_words, int cap,
                         int chunk, int n_split, void* stream) {
  return (int)mma::launch_mma_pool(
      static_cast<cudaStream_t>(stream), prec, v,
      static_cast<const float*>(nsq), static_cast<const uint8_t*>(valid), q,
      static_cast<const float*>(qsq), static_cast<const float*>(scale),
      static_cast<float*>(part_v), static_cast<int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), S, n, d, B, r,
      sim, stages, stage_words, cap, chunk, n_split);
}

// bytes of dynamic shared memory the large-r tier's scan needs at ring
// (stages, stage_floats); 0 for a ring with no kernel
size_t knn_fused_large_smem_bytes(int stages, int stage_floats, int d) {
  return large::large_smem_bytes(stages, stage_floats, d);
}

// bytes of dynamic shared memory the large-r tier's select needs at r
size_t knn_fused_large_select_smem_bytes(int r) {
  return large::select_smem_bytes(r);
}

// slots of the large-r tier's device sort row a (shard, query) at r: 0
// where the select sorts its winners in shared memory
int knn_fused_large_sort_slots(int r) { return large::sort_slots(r); }

// The large-r tier's scan + select (fp32, d % 4 == 0, 16-byte aligned
// rows) on `stream`; keys [S, B, n] u32 and, where
// knn_fused_large_sort_slots(r) = P > 0, sort_v / sort_i [S, B, P] are
// scratch. Returns the first cudaError_t met.
int knn_fused_large_launch(const void* v, const void* nsq, const void* valid,
                           const void* q, const void* qsq, void* keys,
                           void* sort_v, void* sort_i, void* out_v,
                           void* out_i, int S, int n, int d, int B, int r,
                           int sim, int stages, int stage_floats, int chunk,
                           int n_split, void* stream) {
  return (int)large::launch_large_pool(
      static_cast<cudaStream_t>(stream), static_cast<const float*>(v),
      static_cast<const float*>(nsq), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(q), static_cast<const float*>(qsq),
      static_cast<uint32_t*>(keys), static_cast<float*>(sort_v),
      static_cast<int*>(sort_i), static_cast<float*>(out_v),
      static_cast<int*>(out_i), S, n, d, B, r, sim, stages, stage_floats,
      chunk, n_split);
}

// bytes of dynamic shared memory the large-r tier's tensor-core scan needs
// at ring (stages, stage_words) for rows of d prec elements; 0 for a ring
// or a precision with no kernel
size_t knn_fused_large_mma_smem_bytes(int prec, int stages, int stage_words,
                                      int d) {
  return large_mma::large_mma_smem_bytes(prec, stages, stage_words, d);
}

// The large-r tier's tensor-core scan + select (bf16 or int8, rows of
// whole 16-byte units at 16-byte aligned addresses) on `stream`; keys
// [S, B, n] u32 and, where knn_fused_large_sort_slots(r) = P > 0, sort_v /
// sort_i [S, B, P] are scratch. Returns the first cudaError_t met.
int knn_fused_large_mma_launch(const void* scale, int prec, const void* v,
                               const void* nsq, const void* valid,
                               const void* q, const void* qsq, void* keys,
                               void* sort_v, void* sort_i, void* out_v,
                               void* out_i, int S, int n, int d, int B, int r,
                               int sim, int stages, int stage_words,
                               int chunk, int n_split, void* stream) {
  return (int)large_mma::launch_large_mma_pool(
      static_cast<cudaStream_t>(stream), prec, v,
      static_cast<const float*>(nsq), static_cast<const uint8_t*>(valid), q,
      static_cast<const float*>(qsq), static_cast<const float*>(scale),
      static_cast<uint32_t*>(keys), static_cast<float*>(sort_v),
      static_cast<int*>(sort_i), static_cast<float*>(out_v),
      static_cast<int*>(out_i), S, n, d, B, r, sim, stages, stage_words,
      chunk, n_split);
}

}  // extern "C"
