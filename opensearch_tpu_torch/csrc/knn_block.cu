// Exact fp32 kNN scan with a running top-k, for Hopper (sm_90a): K3.
//
// Replaces: opensearch_tpu/ops/pallas_knn.py::_knn_block_kernel (launched by
// pallas_knn_topk). Same contract: for every query b, the k best docs of the
// [n, d] f32 slab under the key (score desc, doc id asc), with (-inf, -1) in
// the slots past the valid-doc count. The TPU kernel walks 1024-doc blocks
// one after another over the whole padded batch, keeps a running [B, k] pool
// in VMEM, merges a block only when it beats some row's k-th best, and puts
// the carried entries first so ties go to the lower id.
//
// Bound: one launch must read the slab once (4nd bytes) plus the norms and
// valid flags (5n) and does 2*B*n*d operations: at B <= 32 and d = 128 the
// bytes bound it (1M x 128 is 517 MB, 0.154 ms at 3.35 TB/s).
//
// Design: a grid walks its doc blocks in no order, so nothing carries from
// one block to the next. The docs are split over CTAs instead (the split is
// chosen by the wrapper for about four CTAs per SM); each CTA streams its
// split in 64-doc tiles through shared memory and keeps a sorted top-k pool
// per query, which a doc enters only when it beats the pool's k-th entry
// (the kth-best early exit). A second launch merges the per-split pools by
// the same key, so ties go to the lower doc id exactly as the carried-first
// merge does. That is K1's fp32 pool scan (knn_tile.cuh), bound here to its
// own entry point with r = k. Rows past n are never read: the wrapper's
// padding of n to a 1024-doc block is arithmetic only, pad rows being dead.
//
// Two designs, chosen by k in the wrapper (ops/knn_blocks.block_tier),
// never on failure, each the same scan as K1's at fp32 r = k: at k <= 32
// the list scan of knn_pool.cuh (knn_block_lists_launch: K4's cp.async
// ring and 4 x 8 FFMA micro-tiles, per-warp lists carried across each
// CTA's contiguous doc range, a CTA-per-query split merge); at
// 32 < k <= 1024 the wide tier of knn_wide.cuh (knn_block_wide_launch: the
// same scan at a query tile of 8, a CTA-wide pool of k per query fed
// through a candidate buffer and a radix select, a select-then-sort split
// merge). The tile scan above (knn_block_launch) is no longer chosen: it
// stays as the yardstick the wide tier is timed against.

#include "knn_wide.cuh"

extern "C" {

// bytes of dynamic shared memory one scan CTA needs at width d and depth k
size_t knn_block_smem_bytes(int d, int k) {
  return scan_smem_bytes(PREC_FP32, d, k);
}

// Scan + merge on `stream`: (vals, ids) [B, k]. Returns the first
// cudaError_t met (0 = launched).
int knn_block_launch(const void* v, const void* nsq, const void* valid,
                     const void* q, const void* qsq, void* part_v,
                     void* part_i, void* out_v, void* out_i, int n, int d,
                     int B, int k, int sim, int chunk, int n_split,
                     void* stream) {
  return (int)launch_pool_scan<PREC_FP32>(
      static_cast<cudaStream_t>(stream), v, static_cast<const float*>(nsq),
      static_cast<const uint8_t*>(valid), q, static_cast<const float*>(qsq),
      nullptr, static_cast<float*>(part_v), static_cast<int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), 1, n, d, B, k,
      sim, chunk, n_split);
}

// bytes of dynamic shared memory the list scan needs at plan (qt, stages);
// 0 for a plan with no kernel
size_t knn_block_lists_smem_bytes(int qt, int stages, int d, int k) {
  return pool::list_smem_bytes(qt, stages, d, k);
}

// The list scan + merge (k <= 32, d % 4 == 0, 16-byte aligned rows) on
// `stream`: (vals, ids) [S, B, k], S = 1 from the wrapper, over the caller's
// unpadded queries. Returns the first cudaError_t met.
int knn_block_lists_launch(const void* v, const void* nsq, const void* valid,
                           const void* q, const void* qsq, void* part_v,
                           void* part_i, void* out_v, void* out_i, int S,
                           int n, int d, int B, int k, int sim, int qt,
                           int stages, int chunk, int n_split, void* stream) {
  return (int)pool::launch_list_pool(
      static_cast<cudaStream_t>(stream), static_cast<const float*>(v),
      static_cast<const float*>(nsq), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(q), static_cast<const float*>(qsq),
      static_cast<float*>(part_v), static_cast<int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), S, n, d, B, k,
      sim, qt, stages, chunk, n_split);
}

// bytes of dynamic shared memory the wide tier's scan needs at plan
// (stages, stage_floats, cap) for rows = min(8, B) queries; 0 for a ring
// with no kernel
size_t knn_block_wide_smem_bytes(int stages, int stage_floats, int d, int k,
                                 int rows, int cap) {
  return wide::wide_smem_bytes(stages, stage_floats, d, k, rows, cap);
}

// The wide tier's scan + merge (k <= 1024, d % 4 == 0, 16-byte aligned
// rows) on `stream`: (vals, ids) [S, B, k], S = 1 from the wrapper.
// Returns the first cudaError_t met.
int knn_block_wide_launch(const void* v, const void* nsq, const void* valid,
                          const void* q, const void* qsq, void* part_v,
                          void* part_i, void* out_v, void* out_i, int S,
                          int n, int d, int B, int k, int sim, int stages,
                          int stage_floats, int cap, int chunk, int n_split,
                          void* stream) {
  return (int)wide::launch_wide_pool(
      static_cast<cudaStream_t>(stream), static_cast<const float*>(v),
      static_cast<const float*>(nsq), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(q), static_cast<const float*>(qsq),
      static_cast<float*>(part_v), static_cast<int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), S, n, d, B, k,
      sim, stages, stage_floats, cap, chunk, n_split);
}

}  // extern "C"
