"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N]
                          [--phases kernel,timing,main|filtered|rest,
                                    hybrid,large,lexical,aggs,dsl,mesh,
                                    devices,contexts,ops,admin,backup,
                                    cluster,tcp,soak,lint]
                          [--kernels knn_fused,adc_scan,knn_block,knn_pb,
                                     knn_sbmax,knn_rescore,adc_lut]

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, all started together): K1 (csrc/knn_fused.cu, fused exact
kNN: the list scan of csrc/knn_pool.cuh at fp32 with r <= 32, its wide
tier, csrc/knn_wide.cuh, at fp32 with 32 < r <= 1024, its large-r tier,
csrc/knn_large.cuh, at fp32 past r = 1024, the wide tier's tensor-core
scan, csrc/knn_wide_mma.cuh, at bf16 and int8 with r <= 1024, the large-r
tier's tensor-core scan, csrc/knn_large_mma.cuh, there past r = 1024; the
tile scan of csrc/knn_tile.cuh serves no shape and is timed beside them),
the fixed-order rescore and |q|^2 (csrc/knn_rescore.cu:
knn_rescore_kernel, knn_query_sq_kernel; no Pallas counterpart: they
replace a batched einsum and a row sum, so a batched search gets a solo
one's bits; the IVF-PQ rescore takes their dots alone), the IVF-PQ LUT
build (csrc/adc_lut.cu: adc_lut_kernel, each sum in one order whatever the
batch; no Pallas counterpart), K2
(csrc/adc_scan.cu, the IVF-PQ ADC scan) and the exact-scan family K3
(csrc/knn_block.cu, running top-k: the list scan and its wide tier), K4 (csrc/knn_pb.cu: per-block top-k, then the
block-major merge, two kernels) and K5 (csrc/knn_sbmax.cu: sub-block
maxima, then the selection and rescore, two kernels). ``--kernels`` limits
the kernel and timing phases to
the named kernels (default all seven; the main phase needs K1, K2, the
rescore and the LUT kernel).
Then:

1. kernel: holds each kernel against its plain PyTorch version on the card.
   K1's large-r tier (large_kernel_phase) on clustered floats, bit for bit
   against kernel_order_pool: one shard of 60,000 128-d docs at B = 1, 9
   and 33 x r = 1025, 1400, 2000, 4096, 10,000 and 20,000 (five tiles and
   three merge rounds), 20,000 768-d docs to r = 10,000, four shards (one
   with 5 live docs) at B = 1, 9 and 33, d = 30, r past a shard's live
   count, which returns every live doc, and 20,000 copies of one vector
   (every score equal); at every check the multi-CTA select again on the
   scan's keys by both sorts and the one-CTA yardstick, all bit-equal to
   the pool; the tile scan beside it at r = 1025 and 1400. The select on
   key rows built to stress it (select_stress_check): every live doc one
   score, a first-level bin of exactly the keys needed, r the live count
   and past it, four shards, B = 33 over four shards; bit-equal to
   plain_large_select. The
   large-r tier at bf16 and int8 (large_mma_kernel_phase) on clustered
   floats, one shard of 60,000 128-d docs and one of 20,000 768-d docs at
   B = 1, 9 and 33 x r = 1025, 2000, 4096 and 10,000, l2 and cosine, int8
   bit-equal to plain_pool, bf16 ids equal but at logged summation ties
   (at d = 768 every score within its f32 error bound, f32_bound_check);
   on mma_sixteenths bit-equal at both precisions; four shards; the
   r = 1025 pool's first 1024 slots the tensor-core tier's r = 1024 pool
   bit for bit. The LUT kernel (lut_kernel_phase) bit-equal to its plain
   version at glove-100's and cell C's shapes (B = 1, 8, 32) and 768-d
   m = 96, through build_luts at bf16 and u8 too, each batch row its solo
   LUT; the rescore's dots alone bit-equal to theirs; the host's batched
   probe product against one a row, logged. The
   rescore and |q|^2 (rescore_kernel_phase): bit-equal to their plain
   versions on sixteenths and on floats (a float difference would be
   logged and held to the f32 bound), every batch row its solo call's
   bits, at B = 1, 8 and 33 x R = 40-512, d = 100, 128 and 768.
   K1: fp32, bf16 and int8 x l2, cosine and dot (n = 50,000, d = 128,
   B = 16, k = 10, 3% dead docs, planted duplicate vectors), and at the
   shapes the main path gives it. int8 pools must be bit-equal; fp32 ids
   equal and bf16 ids equal but at summation ties (summation_ties: two
   docs whose f64 scores lie within what an f32 summation of the d
   products can move them, each logged), scores within rtol 1e-5 / atol
   2e-3: the kernel sums the d products in another order than cuBLAS (at
   B = 1 PyTorch's product reduces as a tree; bf16 on the tensor cores),
   and for a near neighbour l2's |q|^2 - 2 q.v + |v|^2 cancels, so each
   ulp of a dot near |q|^2 ~ 2,000 (2.4e-4) reaches the score almost
   whole. K1's tensor-core tier (mma_kernel_phase) at bf16 and int8 on
   sixteenths narrow enough (mma_sixteenths: k^2 d <= 2^18) that the
   tensor cores' f32 sums of bf16 products are exact, bit for bit with
   the planted ties in id order: one shard of 300,001 docs at B = 1, 5,
   8, 9, 32, 33 and 129 x r = 32, 40, 100, 400, 512 and 1024, four shards
   of 200,000 (one with 5 live docs), d = 30, 100 and 768, n = 90 and
   1,000, operands off a 16-byte boundary; on clustered floats int8 still
   bit for bit, bf16 ids equal but at summation ties. K1's list scan
   (lists_kernel_phase) on sixteenths, bit for bit
   with its planted ties in id order: one shard of 300,001 docs at B = 1,
   5, 8, 9, 32, 33, 128 and 129 x r = 1, 10 and 32 (and 33, the wide
   tier), four shards of 200,000 (one with 5 live docs), d = 30 and 768,
   operands off a 16-byte boundary; then on clustered floats, ids equal
   but at near ties (scores within a relative 1e-5, ranked the other way
   by the other summation order) and scores within rtol 1e-5 / atol 2e-3.
   The wide tier of K1 and K3 (wide_kernel_phase) on sixteenths, bit for
   bit, at B = 1, 5, 8, 9, 32, 33 and 129 x r = 33, 64, 100, 128, 256 and
   1024, one and four shards (one with 5 live docs, fewer than r), d = 30,
   128 and 768, unaligned operands, n = 90 and 1,000 (ranges shorter than
   r), planted duplicates across a range edge and within a sub-block, and
   a shard whose near docs fill 24 whole ranges at r = 1024, so the split
   merge's candidates overflow shared memory and it reads every slot from
   device memory (merge_fallback_check); on clustered floats bit for bit
   against kernel_order_pool, a brute force summed in the kernel's order
   (plain_pool's cuBLAS order ranks some neighbours the other way at
   r >= 100: each such slot is logged with both docs' f64 scores). The tile
   scan, which still serves fp32 past r = 1024 and is timed beside the
   list scan and its wide tier: bit-equal at r = 1025 and 1400 on
   sixteenths (lists_kernel_phase), K3's copy at k = 100
   (blocks_kernel_phase), and before each of its timings against
   kernel_order_pool (fp32), plain_pool (int8 bit for bit, bf16 but at
   summation ties) or, on integer data, plain_block_topk.
   K2 (csrc/adc_scan.cu: stage 1 adc_scan_kernel, stage 2
   adc_merge_kernel; adc_kernel_phase): an IVF-PQ build of n = 100,000,
   d = 100 (nlist 64, m 20), P = 8, at B = 1, 8, 16, 33 and 129 x R = 1,
   10, 63, 64, 65, 500 and 4096; random slabs at m = 8 (ragged and empty
   lists), m = 96 (a 96 KB fp32 LUT) and m = 30 (the byte path, live < R);
   600 identical zero-scoring rows a list, so the threshold ties across
   parts and probes; a merge past shared memory (R = 4096 and 20,000); the
   ragged-and-empty synthetic slab and a planted identical-code tie; each
   for fp32, bf16 and uint8 LUTs. int8 pools must be bit-equal; fp32 and
   bf16 ids equal and scores within rtol 1e-6 / atol 1e-6: kernel and
   plain add the m LUT entries in the same order with round-to-nearest f32
   adds, so they should agree to the bit; the tolerance allows a rounding,
   never a reordering of candidates.
   K3: n = 50,000 (ragged past the block), d = 128, 3% dead docs, a
   duplicate planted across the block boundary, B = 1, 5, 16, 40 and 129,
   k = 10 and 32 (the list scan) and 100 (the wide tier), l2, cosine and
   dot. K4
   (pb_kernel_phase): n = 50,000 with a duplicate across a block edge and
   a run of 12 equal vectors inside a block, B = 1, 5, 8, 9, 16, 32, 33,
   40, 128 and 129 (its query tiles 8, 32 and 128, full and partial),
   k = 10, 32, 33, 100 and 2048 (both tiers), at d = 128, 30 (padded) and
   768 (chunked), operands off a 16-byte boundary, and n = 300,000 (CTAs
   walking several blocks). K5 (sbmax_kernel_phase) on the same kind of
   data with one vector planted in 13 sub-blocks and one all-dead
   sub-block, at the same B and k = 10, 100 and n_sub = 400, then at
   d = 30 and off a 16-byte boundary. Each stage is held against its own
   plain version. The data are multiples of 1/16, so every dot is exact in
   f32 in any order: stage 1 (K3's pools, K4's per-block pools, K5's
   maxima), K4's and K5's stage 2 and the whole entry point must equal the
   plain versions bit for bit, and the lower id must win the planted ties.
   exact=False runs on the same data plus 2^-14, which the bf16 rounding
   of the operands must remove.
2. timing: CUDA-event times of each kernel, its plain version and a library
   yardstick where one exists, beside the bound, with the memory clock
   read before and after each window. K1 at the SIFT-1M shape
   (n = 1,000,000, d = 128, f32, l2, k = 10) at B = 1, 32 and 128, and at
   the serving shapes (one shard of 200,000 docs at B = 1 and 8, four of
   5,000 at B = 1): the list scan's time and its two kernels' device ms by
   name, the tile scan's on the same inputs; library is torch.topk over
   the l2-transformed q @ v.T (never called by the port); bound
   max(bytes / 3.35 TB/s, 2*B*n*d / 67 TFLOP/s). Then the wide records
   (wide_timing_phase) at the SIFT-1M shape: K1 at fp32 r = 64, 100 and
   128 at B = 1, 8, 32 and 128 (the wide tier), at bf16 and int8 with
   k = 10 and 100 at B = 1, 8 and 32 (the tensor-core tier), and K3 at
   k = 64, 128, 256 and 1024 at B = 1 and 32, each beside the tile scan on
   the same call. K2 at the
   glove-100 shape (1,200,000 x 100-d, cosine, m = 20, nlist = 512,
   nprobe = 8, R = 64) at B = 1 and 32 and on cell C's index (200,000 such
   docs) at B = 1 and 8, built with the port's ivfpq.build on the card,
   each stage's device ms read by kernel name (stage1_device_ms,
   stage2_device_ms): bound max(bytes / 3.35 TB/s, lookups / 67 T/s), both counted from the
   run's probes (adc_bound: each distinct probed list's live codes and mask
   once, the LUTs, the winners' ids, the pool); no single PyTorch call
   computes an ADC top-R, so K2 has no library time. K3, K4, K5 through
   their entry points at the SIFT-1M shape (SIFT-style integer
   descriptors) at B = 1, 32 and 128 (K3 beside its tile scan): first one
   call per B with the launch counts set to 0 (their path), each answer the
   brute-force top-10 in order with its scores bit for bit, and each
   kernel's stage 1 bit-equal to its own plain version at every B; then
   the call's time, its device time under torch.profiler (K4 and K5: each
   stage's too, by kernel name), the plain pipeline's, the library
   yardstick's and the bound (slab, norms, flags and queries read once,
   what the kernel writes, against 2*B*n*d operations).
3. main: drives TorchNode on the card. Exact (K1): index A (1 shard,
   200,000 clustered 128-d docs, with the k-NN plugin perf-tool filtering
   specs' age, color and taste columns from --seed) and index B (4
   shards, 20,000 docs), 64
   knn searches each; every hit list must equal the brute-force truth in
   the same order, every search must go through the stacked serving path
   and K1's list scan (its counter), whose step is timed (200 steps) and
   profiled by kernel name. Then index A on the per-shard route (distributed_serving off):
   32 searches at k = 256, size = 10 must equal the brute force and each
   take the streaming scan, and 64 searches from 8 threads (K1 through the
   dispatch batcher) must equal the same searches run one at a time; in
   the gated run (each round of 8 released together, a 50 ms batch
   window) with a mean merged batch above 1 and fewer K1 launches than
   searches, every K1 launch on the list scan. Then index A at k = 100,
   size = 100 (wide_main_phase): 64 searches through the stacked step,
   32 on the per-shard route (k_bucket 128) and 8 threads x 8 through the
   batcher, every hit list the brute-force top-100 in order, every K1
   launch of each path (counted from 0) on the wide tier. Then index A at
   search.knn.score_precision bf16 and int8 (reduced_main_phase), k = 10
   and 100: 32 searches through the stacked step, 16 on the per-shard
   route and 8 threads x 8 through the batcher (gated only), every K1
   launch of each path on the tensor-core tier, every solo hit list the
   plain pipeline's on the node's own slab (bf16: but at summation ties
   of the pool), recall@k against the fp32 brute force printed; and one
   stacked step a precision and k split by kernel name (prep, scan,
   merge, rescore).
   Then (stacked_batch_phase) 8 queries in one stacked launch against
   each alone at fp32, bf16 and int8, k = 10 and 100: bit for bit. Then
   filtered kNN (filtered_main_phase): the relaxed (~40%), restrictive
   (~1%) and 50-ids filters at fp32 k = 10 and 100, bf16 and int8 k = 10,
   8 searches each on both routes, every hit list the brute force over the
   filtered docs (fp32, kernel order) or the plain pipeline (bf16, int8),
   one K1 launch a search on the tier scan_tier names, each stacked one
   counted in "filtered"; the mask build's and the filtered step's device
   ms beside the unfiltered step's. Then the stacked step past r = 1024
   (large_main_phase): k = 1025, 2000 and 4096 on a 768-d index of 20,000
   docs, k = 10,000 on index A, k = 5,000 on 1,500 docs (every live doc),
   each hit list the kernel-order brute force, one large-r launch and one
   launch of its multi-CTA select a search, none of the yardstick; then
   at bf16 and int8 (large_reduced_main) k = 1025, 2000 and 4096 on the
   768-d index and 10,000 on index A, each hit list the plain
   pipeline's (bf16: but at logged summation ties of the pool), one
   launch a search on the large-r tier's tensor-core scan, none on the
   tile scan. msearch (msearch_main_phase): one msearch of 32 bare knn
   bodies on index A at fp32 k = 10 and 100 and bf16 k = 10, each body's
   hits its solo search's bit for bit, one K1 launch a run on the tier
   scan_tier names, batched_queries up by 32; a mixed run whose fourth
   body carries a filter goes one body at a time; the msearch p50 beside
   32 solo searches, the B = 32 step's device ms beside 32 B = 1 steps.
   The REST path (rest_main_phase): the port's HTTP server
   (opensearch_tpu_torch/rest/http.py) on 127.0.0.1:0 in a thread over
   the same node: a 4-shard index of 20,000 docs written over HTTP (one
   NDJSON _bulk, _refresh, PUT / GET / _update / DELETE of one doc with
   its versions and seq_nos) and 32 searches on it; kNN _search on index
   A at k = 10 (64) and 100 (16), each response node.search's bits and
   the K1 launches (all, and on the list scan or wide tier) the
   in-process run's, p50 / p99 / QPS beside in process; eight fetch
   options, each response the in-process one field for field; an NDJSON
   _msearch of 32 in one K1 launch; 8 HTTP clients x 8 searches on the
   stacked step and the per-shard route, each its solo search's bits;
   "profile": true of the in-process profile's shape with its K1 launch's
   device_time_in_nanos > 0; a create-index key the port does not serve
   the 500 "not yet ported" envelope, and GET /_cluster/pending_tasks and
   GET /_cat/recovery 200, on a connection that then serves a search;
   and the in-process p50 with the profiler's hooks and without.
   ``--phases rest`` builds index A and runs this phase alone.
   Every concurrent (gated) check, of K1's paths and of index C's IVF-PQ
   route, holds ids and scores bit for bit to the solo search.
   ANN (K2): index C (1 shard, 200,000 clustered 100-d docs, cosine,
   ivf_pq nlist 512, m 20, nprobe 8; cut from 1.2M by host ingest), 64 knn
   searches, k = 10; every hit list must equal the plain pipeline
   (adc_topr_auto impl="xla") on the same index and probes, every search
   must take the per-shard ANN branch and launch K2. Under the relaxed
   filter (it has the same attribute columns) 16 searches on each route
   are exact K1 searches with no K2 launch, equal to the cosine brute force
   over the filtered docs. Recall@10 against
   exact cosine brute force is printed, not gated. Then a second refresh
   adds 300 docs (below min_train, so an exact segment) and 16 searches
   over both segments must equal the plain pipeline and launch K2 and K1
   (the per-shard route's exact branch) each time; 16 more at k = 256 must
   take the materializing scan on the small segment and equal the plain
   pipeline; and the 64 searches from 8 threads must equal the solo ones,
   with fewer K2 and K1 launches than searches in the gated run. Each
   8-thread run is repeated free-running under the default batch window
   (measured, not gated) and with the batcher off; p50, p99 and QPS are
   printed solo, concurrent and concurrent without the batcher. An ANN
   batch of 8 through the fused pipeline (ann_batch_check) equals its 8
   solo calls bit for bit at fp32, bf16 and u8 ADC.
``--phases large`` runs the large-r tier's kernel checks, the select's
stress rows and the large-r records alone (the quick loop for that tier):
each shape of PERF.md's large-r table at fp32, bf16 and int8, the tier,
its select by each sort, the yardstick, the plain versions and the
library calls, logged as `large record` lines.
4. hybrid (also after main): the hybrid BM25 + kNN program at
   BASELINE.md row 4's full width (hybrid_main_phase: 1,000,000 128-d
   docs, 64 terms x 2,000 postings, 8 query terms, window 128, k = 10,
   4 batches of 200), ids the fp64 host hybrid's on a 50,000-doc
   subsample but at logged f32 ties, a batch twice the same bits,
   graft_entry.entry() on the card against its CPU run; the batch p50,
   QPS, device split by stage and the bound.

5. lexical (also after main): the lexical query phase on index L
   (lexical_main_phase: 100,000 docs of MS MARCO passage-shaped text over
   a Zipf vocabulary, a title, a Zipf keyword tag, views, a date and cell
   A's vectors rounded to eighths, one shard by host _bulk), 64 searches
   of each of 18 types: match (or, and), match_phrase, multi_match,
   query_string, bool, term, terms, range on views and on ts, prefix and
   wildcard on the tag, a ts-desc sort paged 3 deep by search_after,
   rescore (window 50, match_phrase), collapse on the tag, bool{should:
   [match, knn]}, knn filtered by a match and by a prefix. Gates: BM25
   ids the fp64 numpy BM25's but at logged pairs within the f32 bound;
   totals the exact numpy counts; sorted pages numpy's order; each query
   twice the same bits; the kNN types' K1 launches on the tier scan_tier
   names and their hits under search.knn.kernel xla (K1's plain version)
   bit for bit; 8 of each type over HTTP the in-process hits; _count the
   total. ``--phases lexical`` runs it alone.

6. telemetry (after main and lexical): the residency ledger on index C's
   and index L's live nodes (ledger_gate: the identity, the resident bytes
   the numel * element_size of the node's registered tensors and at most
   torch.cuda.memory_allocated(), one search span a search, a "profile":
   true search's roofline fields and residency rows, an index delete
   dropping its share; on index C each search one ivfpq_adc_pallas and
   one knn_fused_pallas roofline launch); then telemetry_phase: the peaks
   calibrated on the card (CUDA events, a 4096^3 fp32 product and a 1 GiB
   copy) within 0.3-1.05x of the data sheet's 3.35 TB/s and 67 TFLOP/s,
   and GET /_roofline over the port's HTTP server: the accounting
   identity, rows for mesh_knn_fused, ivfpq_adc_pallas and
   bm25_term_scores, the stacked families' launches equal to the stacked
   launches since the main phase began; each family's unclamped fraction
   printed.

7. mesh (also after main; mesh_phase): graft_entry.dryrun_multichip(8)
   over 8 slots on the card, one K1 launch on each of its search's 4
   slots, then the tensor-parallel hybrid program
   (parallel/distributed.build_distributed_search) at row 4's width:
   hybrid_main_phase's segment in 4 data shards of 262,144 slots, 4
   batches of 200, n_model 1 and 2, each with the all-gather and the
   ring; ids hybrid_score_topk's but at logged f32 ties, the ring the
   all-gather's values bit for bit, each run the same bits twice, and on
   a copy in eighths every run's values hybrid_score_topk's bit for bit;
   the CUDA-event ms of a batch, the device ms by stage and the peak
   memory beside hybrid_score_topk's. ``--phases mesh`` runs it alone.

7b. devices (also after mesh; devices_phase): the shard mesh over device
   slots. 100,000 of cell A's docs (128-d, l2, with the filtering specs'
   color; depth cut from 200,000 by the phase's 60 s) bulked into 4
   shards; the same traffic (64 kNN _search at k = 10, 16 at k = 100, 16
   filtered by a color term, an _msearch of 32) over the serving devices
   (1) [cuda:0], (2) [cuda:0] * 4 and (3), where there are two cards or
   more, every card (the log says when form 3 did not run). Gates: form
   1's k = 10 hits the brute force's; every form's hits, scores and
   totals form 1's bit for bit; one K1 launch a slot a search (the
   _msearch one a slot in all), distributed_searches one a search,
   filtered 16; one ledger allocation a slot, labelled with its card,
   summing to form 1's bytes; each card's memory_allocated() grown by its
   slots' slabs; every card's memory_allocated() back at its start once
   the index is deleted. A `devices record` line: each form's k = 10 p50
   and QPS, the device ms of each slot's K1 scan and of the step's
   gather and merge, seconds. ``--phases devices`` runs it alone.

8. aggs (with main, on index L after the lexical phase and before its
   ledger gate; aggs_main_phase): 16 searches at size 0 of each of six
   scopes (match_all, a 6-term match, a 14-day range on ts, knn at
   k = 100, knn filtered by a tag prefix, bool{should: [match, knn]}),
   each with terms on the tag ordered by a sub-aggregation, histogram,
   month and 1d date_histograms, range, date_range, stats,
   extended_stats, percentiles, cardinality, filters, filter,
   significant_terms, the pipelines avg_bucket, derivative,
   cumulative_sum, bucket_sort and bucket_script, and top_hits under a
   terms on the match and knn scopes; the composite (tag x month) of each
   scope's first search paged to its end. Gates: every key, count and
   metric numpy's over the corpus arrays (match_all, range) or over the
   same search's hits without aggregations (the rest; top_hits' scores
   the hits' own, bit for bit); a second run the same bits; K1 once a
   segment a kNN search on the tier scan_tier names and no stacked
   search; the kNN scopes under K1's plain version bit for bit; over
   HTTP with typed_keys the in-process aggregations. On index C
   (ann_main_phase, before its ledger gate; ann_aggs_check): 8 knn +
   terms(color) + histogram(age) searches, one K2 and one K1 launch each,
   numpy's aggregations over the hits. Recorded: each scope's p50 / p99,
   its profile's aggregation time against the query phase's, the
   top_hits and cardinality times, the mask-and-score copy's bytes and
   ms. ``--phases aggs`` builds index L and runs it alone.

9. dsl (with main, on index L after the aggregations and before its
   ledger gate; dsl_main_phase): index L gains a geo_point ``loc`` (1,000
   city centres with a few km of jitter), a rank_feature ``pop`` (Zipf)
   and a long ``need`` (1-3) from a generator of their own; index J (a
   Q&A forum: 4,000 questions and 16,000 routed answers, a join field,
   nested comments, 128-d eighths) and index P (2,000 stored percolator
   queries over index L's fields) on the same node. 16 searches of each
   type (4 script filters): geo_distance, geo_bounding_box, geo_shape,
   distance_feature on ts and loc, rank_feature (saturation, log,
   sigmoid), terms_set, more_like_this (text and doc), slice, script,
   script_score (knn_score, cosineSimilarity, painless, over a knn),
   script_fields, term and phrase suggesters on typos, a stored mustache
   template, hybrid match + knn (k = 100) under a normalization and an
   RRF pipeline; knn at k = 10 and 100 filtered by geo_distance,
   geo_bounding_box, terms_set, script (1 a k) and more_like_this; on J
   has_child, has_parent, parent_id, nested, has_parent-filtered knn,
   100 scripted updates and a scripted_upsert; on P 8 percolate searches.
   Gates: numpy truths (haversine in float64, the rank and distance
   formulas' float32 bits, terms_set counts, murmur3 partitions, the MLT
   rewrite's tf-idf bool, knn_score bit for bit on eighths, the fused
   hybrid scores of the sub-queries' own results, typo words suggested,
   templates, join and percolate sets, updates read back); one K1 launch
   a kNN-bearing search on its tier and K1's plain version bit for bit;
   HTTP the in-process hits; no percolate bytes left in the ledger.
   ``--phases dsl`` builds index L and runs it alone.

10. contexts (with main, last on the main node, after large_main_phase;
   contexts_main_phase): search contexts, aliases and admission on cell A
   and B. Filtered aliases (a term and a range filter, added in process
   and over HTTP): 16 kNN searches at k = 10 and 16 at k = 100 through
   each, one filtered K1 launch each on its tier, the knn.filter bits and
   the brute force over the filter's docs; a write alias's 100 docs seen
   after a refresh. A point in time across 1,000 deletes of the top hits:
   the pre-delete bits through it, the post-delete brute force live,
   search_after pages on _shard_doc the one-shot hits, the registry's
   rebuilds over PIT / live alternations, device memory beside the ledger.
   A k = 1,000 scroll in 10 pages, one K1 launch a page. The request
   cache: a miss one K1 launch, 15 hits none and the miss's JSON, a write
   (a delete) a miss. Admission: 8 threads x 8 under an enforced workload group (each
   admitted search its solo bits, each rejection a 429), no task left,
   the in-flight breaker at 0 after an HTTP _msearch, a cancelled search
   with no K1 launch. _cluster/settings, _flush and a restart on the same
   path: indices, counts, aliases and the persistent setting back on the
   card, the same kNN bits; a PIT on B across _forcemerge, whose held
   segments leave device memory at close_pit. ``--phases contexts``
   builds cell A and B and runs it alone.

11. ops (with main, on the main node after contexts; ops_main_phase):
   ingest pipelines, index templates, wildcard expressions and the
   node's stats surface. A component and a composable template `vec-*`
   and the pipeline vec-in (json, remove, convert, set, a painless
   script, drop of ~1 % spam) over HTTP; 20,000 of cell A's 128-d docs
   through _bulk into vec-2026.10 (auto-created by the template) and
   without a pipeline into vec-twin: the template's mappings and
   settings, docs.count = _count = the kept docs, the fed slab the
   twin's kept rows bit for bit, 256 _sources _simulate's output. 16 kNN
   searches at k = 10 and 100 through the name and through
   vec-*,-vec-twin: one K1 launch each on its tier, the twin's hits
   under a knn.filter and the brute force in the kernel's order;
   query_total moved by one a search an index. Then the ledger-to-
   allocator gap with no reader context open, and 9 observability routes
   read 16 times each over HTTP (_nodes/stats, its device, knn_batch and
   ingest sections, _stats, _cluster/stats, _prometheus/metrics,
   _cat/indices, shards, segments, health): no launch counter and no
   memory_allocated() move across them, ingest.pipelines.vec-in.count
   20,000, the knn_batch Prometheus series moving as _nodes/stats does.
   At most 45 s. ``--phases ops`` runs it alone on a fresh node.
12. admin (with main, on the main node after ops, whose vec-2026.10 and
   vec-twin it reuses; admin_main_phase): cross-request batching on the
   stacked step, index management and document reads. The concurrent
   checks on the stacked step (cell A at k = 10 and 100, at bf16 and
   int8 gated, int8 on queries of one quantization scale, cell B at
   k = 10): each concurrent hit list its solo one bit for bit, the mean
   merged batch above 1, fewer K1 launches than searches, a cross-shard
   launch on B; int8 queries of 64 scales launch apart. Then over HTTP: PUT _mapping adds
   v2 to vec-twin (2,000 docs carry it; 16 kNN on v2, one launch each,
   the brute force; 16 on v, the hits of before bit for bit); a write
   block refusing a _bulk and lifted by _settings; _split of vec-2026.10
   into 2 shards (32 kNN, one stacked launch each, the source's hits);
   _close (a kNN 400 with no launch, _cat/indices `close`, vec-* skips
   it) and _open (the hits of before bit for bit); _rollover of a write
   alias vec-w over 2 x 2,000 docs (16 kNN over both indices, one launch
   each, the brute force); _explain of 8 kNN top hits (the value the
   _score bit for bit), _mget of 64 ids, _field_caps, and
   _validate/query, _search_shards and _analyze with no launch. At most
   30 s. ``--phases admin`` builds cells A and B and the ops phase's
   indices on a fresh node and runs it alone.
13. backup (with main, on the main node after admin, whose vec-2026.10
   and vec-twin it reuses; backup_main_phase): snapshots and
   repositories, the remote segment store, the reindex family and rank
   evaluation, over HTTP. A snapshot of both indices (_status,
   _cat/snapshots, _cat/repositories; a second one stores no new blob;
   no launch); a restore renamed beside the live index (16 kNN at k = 10
   and 16 at k = 100, one K1 launch each, the live hits bit for bit), a
   restore after DELETE and one over a closed index (the hits of before
   bit for bit; the ledger's resident bytes back at their level before
   the restore, within one stacked bundle); vec-rs through the remote
   store and back (the hits of before); _reindex into vec-copy,
   _update_by_query tagging a range and _delete_by_query of half (16 kNN
   after each, one K1 launch each, the tagged ones one filtered launch,
   vec-twin's hits and the brute force, no deleted id, no scroll context
   left); _rank_eval of 8 exact kNN requests on cell A rated by the
   brute force's top 10 (precision and recall 1.0, 8 K1 launches each).
   At most 30 s. In the ann phase, a _rank_eval under recall of 8 of
   index C's queries: each metric_score the search's recall@10, 8 K2
   launches. ``--phases backup`` builds cell A and the ops phase's
   indices on a fresh node and runs it alone.
14. cluster (with main, after the mesh phase, on nodes of its own;
   cluster_phase):
   the cluster's core in this process. Three ClusterNodes (n0-n2) on one
   deterministic sim (testing/sim.py: virtual time, an in-memory
   transport that can isolate a node and heal), each on the card; index
   vecs of 3 shards and 1 replica holds CLUSTER_DOCS 128-d l2 docs from
   --seed, bulked through n0 in batches of 1,000 and refreshed. 16 kNN at
   k = 10 and 16 at k = 100 through n1: the brute force's ids, scores
   within the f32 bound, _shards.failed 0, K1 up by the node partials of
   each search (one search[node] RPC a node holding a chosen copy, 1-3),
   no per-shard fallback, and each serving node building its stacked
   bundle at most once. The same searches again after the isolation of
   the node holding shard 0's primary and the replica's promotion (a
   search before the promotion logs its _shards), after the heal and the
   rejoined node's peer recovery (green), after n1's drain by
   cluster.routing.allocation.exclude._name (n1 holds no shard, no
   resident bundle holds one of its old engines), and on vecs-restored
   (ClusterSnapshotsService's snapshot and restore, k = 10). Then a
   cross-cluster kNN c2:remote-vecs from a local TorchNode to a remote
   one behind the HTTP server (CLUSTER_REMOTE_DOCS docs): the remote's
   own hits, one K1 launch each; and the 17 control-plane routes over
   HTTP on a small single node: 200, the reference's keys, no launch.
   At most 45 s. ``--phases cluster`` runs it alone.
15. tcp (with main, last of all, on servers of its own; tcp_phase): the
   cluster over sockets. Three ClusterServers of the port (n0-n2: a
   TcpTransport, a ClusterNode on the card and the ClusterFacade behind
   the HTTP server) on 127.0.0.1, driven only through their REST ports;
   each node's disk reading pinned to 50%. Index vecs of 3 shards and 1 replica holds
   TCP_DOCS 128-d l2 docs from --seed, bulked through n0's _bulk in
   batches of 1,000 (every item on both copies). Then, each a gate: 16
   kNN at k = 10 and 16 at k = 100 through each of n0, n1 and n2 (the
   brute force's ids, scores within the f32 bound, K1 up by the node
   partials of each search, no per-shard fallback, each serving node
   building its stacked bundle at most once); 8 HTTP clients x 8 kNN at
   k = 10 through n1 (each its solo hits bit for bit, at least one K1
   launch and at most one a node partial; QPS and the batcher's mean
   merged batch); one _msearch of 32 bare kNN through n2 (each its solo
   hits bit for bit, at most one K1 launch a data node, msearch[node]
   RPCs counted); _nodes/stats, _cat/nodes, _cat/recovery, _recovery and
   _prometheus/metrics?cluster=true answer 200 with no launch and
   memory_allocated() unchanged; the elected leader's server killed: a
   new leader, every primary active on the two left, _count the docs,
   256 of them read back by _mget, 16 kNN at k = 10 the brute
   force's, no stacked bundle holding one of the killed node's engines
   and the ledger down by at least their bytes. No K1 launch and no
   bundle build ran on the transports' event loop. At most 45 s; one
   `tcp` line of its numbers (each stage's p50 / p99, the parts'
   seconds). ``--phases tcp`` runs it alone.
16. soak (with main, after tcp, on sim nodes of its own; soak_phase): the
   chaos soak (testing/soak.run_soak) on the card, seed SOAK_SEED, 2
   cycles of 30 ops with chaos, cycle 1 the topology reshape (a node
   joins, the router rebalances, a disk ramp evacuates a replica-holder,
   a founding node drains and departs), all under
   testing/race_probe.probe_scope. run_soak forces the kernel policy to
   the hand-written kernels: K1 serves the exact kNN of indices vec and
   hyb, K2 the IVF-PQ searches of annvec. Every kNN body (a top-level
   knn clause, or one among a hybrid query's) is counted by its index's
   kind once, where a node runs it: its search over local shards or a
   per-shard query; the launch counters start from 0 just before the
   soak. Gates: every invariant
   holds and every op completes; K1's and K2's launches above 0 and no
   more than the searches of their kind; the probe confirms no unlocked
   cross-role write; once the soak's nodes close, no stacked bundle of
   its indices and no device allocation made during it is left, and
   memory_allocated() is back at its value before the soak with the
   cyclic collector off from the soak's start until that reading (so a
   closed node frees its device tensors at close, not at a collection);
   at most 45 s. One `soak` line (ops, faults, invariants, digest,
   searches and launches, the probe's findings, memory_allocated()'s
   change after close, the bytes one collection then frees and the
   change after it, seconds); K1's and K2's entries gain
   `soak_launches`. ``--phases soak`` runs it alone.
17. lint (with main, or ``--phases lint``; first of all, before the
   build; lint_phase): the port's linter over opensearch_tpu_torch/, as
   ``python -m opensearch_tpu_torch.lint opensearch_tpu_torch --fix
   --dry-run`` runs it, against the port's baseline
   (opensearch_tpu_torch/lint_baseline.json, empty). Gates: its exit
   code 0, no finding, no pending rewrite, all 19 rules run, and neither
   jax nor opensearch_tpu among the modules of the linter's process or
   of this one afterwards. One `lint` line (files checked, findings,
   pending fixes, seconds). The phase is not caught: a failure ends the
   run.

Before each phase, a line names it and the wall seconds so far, so a run
that fails names the phase it died in before the traceback.

Prints the card's name and power limit, one JSON line of kernel numbers,
and last `{"ok": true, "device": {...}}`; logs each phase's wall seconds. Exits non-zero, with no result
line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
FP32_FLOP_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
# H100 SXM peak a second by operand type (dense tensor-core rates for bf16
# and int8), for the bound of a scan at that precision
PEAK_OPS_PER_S = {"fp32": FP32_FLOP_PER_S, "bf16": 989e12, "int8": 1979e12}
DIM = 128
ANN_DIM = 100                 # glove-100
ANN_M = 20
K2_PARITY_DOCS = 100_000      # K2 kernel phase build
GLOVE_DOCS = 1_200_000        # K2 timing phase (the glove-100 corpus size)
SIFT_DOCS = 1_000_000         # K3-K5 timing phase (the SIFT-1M corpus size)
ANN_MAIN_DOCS = 200_000       # index C (cut from 1.2M by host ingest)
KERNELS = ("knn_fused", "adc_scan", "knn_block", "knn_pb", "knn_sbmax",
           "knn_rescore", "adc_lut")
SIMS = ("l2_norm", "cosine", "dot_product")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def clustered(rng, n: int, d: int, n_centers: int = 64) -> np.ndarray:
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 4.0
    return (centers[rng.integers(0, n_centers, n)]
            + rng.standard_normal((n, d)).astype(np.float32))


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, reps: int) -> dict | None:
    """Host wall ms per call under the profiler and the summed device time
    per call of every CUDA kernel it ran (torch.profiler, CUPTI). The
    profiler slows the host, so an idle share divides the device time by
    an unprofiled wall. None, with a log line, if the profiler records no
    device time on this machine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        kernels = {}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            # kernels whose names share the first 60 characters add up
            key = evt.key[:60]
            kernels[key] = kernels.get(key, 0.0) + us / 1e3 / reps
    except Exception as exc:  # measurement only: the checks run elsewhere
        log(f"torch.profiler gave no device times ({exc!r}): not measured")
        return None
    if not kernels:
        log("torch.profiler recorded no CUDA kernel: not measured")
        return None
    busy = sum(kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6])
    return {"wall_ms": wall, "device_ms": busy, "top": top,
            "kernels": kernels}


def mem_clock() -> str:
    """The card's memory clock now, as nvidia-smi reads it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.mem", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def kernel_ms(prof: dict | None, part: str) -> float | None:
    """Device ms per call of the profiled kernels whose name holds `part`."""
    if prof is None:
        return None
    return sum(ms for key, ms in prof["kernels"].items() if part in key)


def scan_inputs(kf, vectors, norms, valid, queries, k, prec):
    """Operands of one pool scan exactly as knn_fused_stacked makes them."""
    n = vectors.shape[1]
    n_pad = -(-n // kf.FK_BLOCK) * kf.FK_BLOCK
    r = min(kf.fused_pool_width(min(k, n_pad), prec), n_pad)
    qsq = (queries * queries).sum(dim=1)
    v_x, q_x, scale = kf._prep_operands(vectors, queries, prec)
    return (v_x.contiguous(), norms.contiguous(), valid.contiguous(),
            q_x.contiguous(), qsq, scale), r


def compare_pools(kf, args, r, sim, prec, what: str,
                  bits: bool = False) -> float:
    """Kernel vs plain pool on the same operands; returns max |dv|. int8
    pools, and any pool when `bits` (data whose dots are exact in f32),
    must be bit-equal."""
    kv, ki = kf.pool_scan(*args, r=r, similarity=sim, score_precision=prec)
    pv, pi = kf.plain_pool(*args, r=r, similarity=sim, score_precision=prec)
    torch.cuda.synchronize()
    if not torch.equal(ki, pi):
        bad = (ki != pi).nonzero()[:5].tolist()
        seen = [(tuple(i), (float(kv[tuple(i)]), int(ki[tuple(i)])),
                 (float(pv[tuple(i)]), int(pi[tuple(i)]))) for i in bad]
        raise AssertionError(f"{what}: ids differ at (slot, kernel (score, "
                             f"id), plain (score, id)) {seen}")
    fin = torch.isfinite(pv)
    if not torch.equal(fin, torch.isfinite(kv)):
        raise AssertionError(f"{what}: finite slots differ")
    if prec == "int8" or bits:
        if not torch.equal(kv, pv):
            raise AssertionError(f"{what}: pool not bit-equal")
    elif not torch.allclose(kv[fin], pv[fin], rtol=1e-5, atol=2e-3):
        raise AssertionError(f"{what}: scores beyond rtol 1e-5 / atol 2e-3")
    return float((kv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0


def kernel_phase(kf, dev, seed: int) -> float:
    rng = np.random.default_rng(seed)
    n, b, k = 50_000, 16, 10
    data = clustered(rng, n, DIM)
    for i in range(50):                       # planted exact duplicates
        data[n - 1 - i] = data[i * 97]
    valid = np.ones(n, bool)
    valid[rng.choice(n, int(0.03 * n), replace=False)] = False
    queries = data[rng.choice(n, b, replace=False)] + 0.01 * rng.standard_normal(
        (b, DIM)).astype(np.float32)
    queries[0] = data[97]                     # hits a planted tie
    v = torch.from_numpy(data)[None].to(dev)
    nrm = torch.from_numpy((data.astype(np.float64) ** 2).sum(1).astype(
        np.float32))[None].to(dev)
    ok = torch.from_numpy(valid)[None].to(dev)
    q = torch.from_numpy(queries).to(dev)
    err = 0.0
    for prec in kf.SCORE_PRECISIONS:
        for sim in SIMS:
            args, r = scan_inputs(kf, v, nrm, ok, q, k, prec)
            if prec == "bf16":
                # the tensor cores sum in another order than cuBLAS
                e = bf16_float_check(kf, args, r, sim, f"{prec}/{sim}")
            else:
                e = compare_pools(kf, args, r, sim, prec, f"{prec}/{sim}")
            err = max(err, e)
            log(f"kernel parity {prec}/{sim}: r={r} ok max_abs_err={e:.3g}")
        # end to end, with the exact rescore at reduced precisions
        ev, ei = kf.knn_fused(v[0], nrm[0], ok[0], q, k=k, score_precision=prec,
                              impl="pallas")
        xv, xi = kf.knn_fused(v[0], nrm[0], ok[0], q, k=k, score_precision=prec,
                              impl="xla")
        if not torch.equal(ei, xi):
            raise AssertionError(f"knn_fused {prec}: ids differ from plain")
    # the shapes the main path gives the kernel: B = 1 over a [1, 2^18, d]
    # and a [4, 2^13, d] slab (fp32, l2, k = 10)
    for s, n_flat in ((1, 1 << 18), (4, 1 << 13)):
        data = clustered(rng, s * n_flat, DIM).reshape(s, n_flat, DIM)
        v = torch.from_numpy(data).to(dev)
        nrm = torch.from_numpy((data.astype(np.float64) ** 2).sum(2).astype(
            np.float32)).to(dev)
        ok = torch.from_numpy(rng.random((s, n_flat)) > 0.1).to(dev)
        q = torch.from_numpy(data[0, :1] + 0.01).to(dev)
        args, r = scan_inputs(kf, v, nrm, ok, q, 10, "fp32")
        err = max(err, compare_pools(kf, args, r, "l2_norm", "fp32",
                                     f"main-path shape S={s}"))
        log(f"kernel parity main-path shape S={s} n={n_flat}: ok")
    return err


LIST_COPIES = (2303, 2304)           # a duplicate across a range edge
LIST_RUN = tuple(range(5000, 5040))  # 40 equal vectors in one sub-block


def lists_case(dev, rng, s: int, n: int, d: int, integer: bool = True,
               grid=None):
    """Operands of K1's list scan and its wide tier: s shards of n docs of
    width d (sixteenths, or `grid`'s coarser ones where given, or
    clustered floats when not `integer`), 3% dead docs, LIST_COPIES and
    LIST_RUN planted in every shard and live (where n holds them); with
    four shards the last keeps 5 live docs, fewer than r. Returns (shard
    0's data, v, norms, valid)."""
    data = ((grid or sixteenths) if integer else clustered)(
        rng, s * n, d).reshape(s, n, d)
    valid = rng.random((s, n)) >= 0.03
    if n > LIST_RUN[-1]:
        data[:, list(LIST_COPIES)] = data[:, LIST_COPIES[:1]]
        data[:, list(LIST_RUN)] = data[:, LIST_RUN[:1]]
        valid[:, [*LIST_COPIES, *LIST_RUN]] = True
    if s == 4:
        valid[3] = False
        valid[3, rng.choice(n, 5, replace=False)] = True
    v = torch.from_numpy(data).to(dev)
    nrm = torch.from_numpy(np.concatenate([
        (data[i].astype(np.float64) ** 2).sum(1).astype(np.float32)[None]
        for i in range(s)])).to(dev)
    return data[0], v, nrm, torch.from_numpy(valid).to(dev)


def exact_scores(kf, v, nrm, q, qsq, sim: str, s: int, b: int,
                 docs: list) -> list:
    """The scores of `docs` of shard s for query b computed in f64: the dot
    in f64 (exact for f32 operands), the transform in f64 on the same
    norms and |q|^2 the kernel was given. A witness independent of both
    f32 summation orders."""
    idx = torch.tensor(docs, device=v.device)
    dots = v[s, idx].double() @ q[b].double()
    return kf._transform_scores(dots, qsq[b].double(), nrm[s, idx].double(),
                                sim).tolist()


def near_tie_swaps(kf, kv, ki, pv, pi, args, sim: str, what: str) -> list:
    """Float data: the slot scores must agree to rtol 1e-5 / atol 2e-3, and
    every slot where the kernel's id differs from plain_pool's must hold a
    live doc of the shard, once in its row, whose f64 score
    (exact_scores) lies within a relative 1e-5 of the f64 score of the doc
    plain put there: a near tie, which two f32 summation orders may rank
    either way. Returns one record per such slot: the kernel's and plain's
    doc, each with its f64 score."""
    v, nrm, ok, q, qsq, _scale = args
    fin = torch.isfinite(pv)
    if not torch.equal(fin, torch.isfinite(kv)) or not torch.allclose(
            kv[fin], pv[fin], rtol=1e-5, atol=2e-3):
        raise AssertionError(f"{what}: scores beyond rtol 1e-5 / atol 2e-3")
    swaps = []
    for s, b, j in (ki != pi).nonzero().tolist():
        row = ki[s, b].tolist()
        doc, other = row[j], int(pi[s, b, j])
        if not (0 <= doc < v.shape[1] and bool(ok[s, doc])) or \
                row.count(doc) != 1 or other < 0:
            raise AssertionError(f"{what}: slot {(s, b, j)} holds doc {doc} "
                                 f"(plain: {other}): not a live doc once")
        a, c = exact_scores(kf, v, nrm, q, qsq, sim, s, b, [doc, other])
        if abs(a - c) > 1e-5 * max(abs(a), abs(c)):
            raise AssertionError(
                f"{what}: slot {(s, b, j)} holds doc {doc}, plain {other} "
                f"(f64 scores {a!r} and {c!r}: not a near tie)")
        swaps.append({"slot": [s, b, j], "kernel": [doc, a],
                      "plain": [other, c]})
    return swaps


def kernel_order_scores(kf, v, nrm, ok, q, qsq, sim: str):
    """The [S, B, n] scores of f32 operands under the range scans' own
    arithmetic, on the card: every dot summed over d in ascending order in
    one f32 accumulator, each step a fused multiply-add (the product exact
    in f64, the sum rounded once to f64 and then to f32: a second rounding
    can differ from the fused one only when the f64 sum lands on an f32
    midpoint, about 2^-28 of the steps, and then by one ulp), then the
    plain version's transform, which rounds as the kernel does; -inf for a
    dead doc."""
    S, n, d = v.shape
    vt = v.transpose(1, 2).contiguous()           # [S, d, n]
    acc = torch.zeros((S, q.shape[0], n), dtype=torch.float32,
                      device=v.device)
    for j in range(d):
        acc = (acc.double() + q[None, :, j, None].double()
               * vt[:, None, j].double()).float()
    scores = kf._transform_scores(acc, qsq[None, :, None], nrm[:, None, :],
                                  sim)
    return torch.where(ok[:, None, :], scores, float("-inf"))


def order_top(kf, scores, r: int):
    """The top r of kernel_order_scores' scores under (score desc, doc id
    asc): (vals [S, B, r], ids [S, B, r] int32), (-inf, -1) past the live
    count."""
    vals, ids = kf.stable_topk(scores, r)
    return vals, torch.where(vals > float("-inf"), ids, -1).to(torch.int32)


def kernel_order_pool(kf, v, nrm, ok, q, qsq, r: int, sim: str):
    """The exact top-r pools of f32 operands under the list scan's own
    arithmetic (kernel_order_scores, order_top). Returns (vals [S, B, r],
    ids [S, B, r] int32), (-inf, -1) past the live count."""
    return order_top(kf, kernel_order_scores(kf, v, nrm, ok, q, qsq, sim), r)


def order_check(kf, kv, ki, args, r: int, sim: str, what: str,
                pv=None, pi=None) -> None:
    """Float data: the kernel's pools must equal kernel_order_pool's bit for
    bit, ids and values. Where a plain version's pools (pv, pi) are given,
    each slot whose id differs from them (a neighbour the other summation
    order ranks the other way) is logged with both docs' f64 scores."""
    v, nrm, ok, q, qsq, _scale = args
    rv, ri = kernel_order_pool(kf, v, nrm, ok, q, qsq, r, sim)
    if not (torch.equal(ki, ri) and torch.equal(kv, rv)):
        bad = (ki != ri).nonzero()[:5].tolist()
        raise AssertionError(f"{what}: differs from the kernel-order "
                             f"reference (ids differ at {bad})")
    if pi is None:
        return
    for s, b, j in (ki != pi).nonzero().tolist():
        doc, other = int(ki[s, b, j]), int(pi[s, b, j])
        a, c = exact_scores(kf, v, nrm, q, qsq, sim, s, b, [doc, other])
        log(f"{what}: plain_pool's order differs at {[s, b, j]}: kernel doc "
            f"{doc} (f64 {a!r}), plain doc {other} (f64 {c!r}), relative "
            f"gap {abs(a - c) / max(abs(a), abs(c)):.3g}")


def tile_check(kf, args, r: int, what: str) -> None:
    """The tile scan (kf._launch_tile), the yardstick timed beside the list
    scan and its wide tier, on the fp32 operands `args` of clustered
    floats: bit-equal to kernel_order_pool (order_check), since it too sums
    each dot in ascending order with one FFMA a product."""
    kv, ki = kf._launch_tile(*args, r=r, similarity="l2_norm",
                             score_precision="fp32")
    order_check(kf, kv, ki, args, r, "l2_norm", f"{what} (tile scan)")


def block_tile_check(kb, kf, v, nrm, ok, q, k: int, what: str) -> None:
    """K3's tile scan (kb._launch_block_tile on the padded batch), the
    yardstick timed beside K3's wide tier, on one shard of clustered f32
    floats: its rows for q bit-equal to kernel_order_pool."""
    tv, ti = kb._launch_block_tile(v, nrm, ok, kb._pad_queries(q, None), k=k,
                                   similarity="l2_norm")
    b = q.shape[0]
    order_check(kf, tv[None, :b], ti[None, :b],
                (v[None], nrm[None], ok[None], q, (q * q).sum(1),
                 torch.ones(1, device=v.device)), k, "l2_norm",
                f"{what} (K3 tile scan)")


def lists_check(kf, v, nrm, ok, q, r: int, sim: str, what: str,
                bits: bool, planted: bool = True) -> float:
    """One pool scan at fp32 against plain_pool: on sixteenths (`bits`) ids
    equal and values bit-equal, the planted copies (where `planted`) first
    in id order for l2 and cosine; on float data scores within rtol 1e-5 /
    atol 2e-3 and ids equal but at near ties (near_tie_swaps; the wide
    tier: equal to kernel_order_pool bit for bit, order_check, since at
    r >= 100 two summation orders swap neighbours further apart than
    near_tie_swaps' 1e-5). The design scan_tier names must have served it,
    one launch of K1: the list scan at r <= 32 (one list_launches), its
    wide tier at r <= 1024 (one wide_launches), else its large-r tier (one
    large_launches)."""
    qsq = (q * q).sum(dim=1)
    one = torch.ones(v.shape[0], device=v.device)
    tier = kf.scan_tier("fp32", r)
    counters = (kf.launches, kf.list_launches, kf.wide_launches,
                kf.large_launches)
    before = [c.count for c in counters]
    args = (v, nrm, ok, q, qsq, one)
    if bits:
        err = compare_pools(kf, args, r, sim, "fp32", what, bits=True)
    else:
        kv, ki = kf.pool_scan(*args, r=r, similarity=sim,
                              score_precision="fp32")
        pv, pi = kf.plain_pool(*args, r=r, similarity=sim,
                               score_precision="fp32")
        torch.cuda.synchronize()
        if tier == "wide":
            fin = torch.isfinite(pv)
            if not torch.equal(fin, torch.isfinite(kv)) or not torch.allclose(
                    kv[fin], pv[fin], rtol=1e-5, atol=2e-3):
                raise AssertionError(f"{what}: scores beyond rtol 1e-5 / "
                                     f"atol 2e-3")
            order_check(kf, kv, ki, args, r, sim, what, pv, pi)
        swaps = [] if tier == "wide" else near_tie_swaps(
            kf, kv, ki, pv, pi, args, sim, what)
        for sw in swaps:
            # which of the two the f64 scores put first (the id on a tie)
            first = max((sw["kernel"][1], -sw["kernel"][0]),
                        (sw["plain"][1], -sw["plain"][0]))
            log(f"{what}: near tie at {sw['slot']}: kernel doc "
                f"{sw['kernel'][0]} (f64 {sw['kernel'][1]!r}), plain doc "
                f"{sw['plain'][0]} (f64 {sw['plain'][1]!r}); f64 puts doc "
                f"{-first[1]} first")
        fin = torch.isfinite(pv)
        err = float((kv[fin] - pv[fin]).abs().max()) if bool(fin.any()) \
            else 0.0
    want = [1, int(tier == "lists"), int(tier == "wide"),
            int(tier == "large")]
    got = [c.count - b for c, b in zip(counters, before)]
    if got != want:
        raise AssertionError(f"{what}: (K1, list scan, wide tier, large-r "
                             f"tier) launched {got} times, want {want} "
                             f"({tier})")
    if bits and planted and sim != "dot_product" and r >= 2:
        kv, ki = kf.pool_scan(v, nrm, ok, q, qsq, one, r=r, similarity=sim,
                              score_precision="fp32")
        if ki[0, 0, :2].tolist() != list(LIST_COPIES):
            raise AssertionError(f"{what}: planted tie gave "
                                 f"{ki[0, 0, :2].tolist()}")
        run = min(r, len(LIST_RUN))
        if q.shape[0] > 1 and ki[0, 1, :run].tolist() != list(LIST_RUN[:run]):
            raise AssertionError(f"{what}: planted run gave "
                                 f"{ki[0, 1, :run].tolist()}")
    return err


def lists_kernel_phase(kf, dev, seed: int) -> float:
    """K1's list scan (fp32, r <= 32) against plain_pool on the card, its
    wide tier at r = 33 and its large-r tier at r = 1025 and 1400 beside
    it. Sixteenths (every dot exact in f32, so values
    and ids bit-equal, the planted ties in id order): one shard of
    n = 300,001 (a ragged tail; LIST_COPIES straddle a range edge at
    B <= 8) at B = 1, 5, 8, 9, 32, 33, 128 and 129 (query tiles 8, 32 and
    128, full and partial, and two 128-query tiles) x r = 1, 10 and 32 in
    l2, cosine and dot at r = 10, and r = 33; the large-r tier on another
    such shard at B = 1, 9 and 33 in l2 and cosine; four shards of 200,000 (the
    last with 5 live docs) at B = 1, 8 and 33 x r = 10 and 32; d = 30 and
    768 (the two-stage ring at r = 32) at B = 1, 9 and 129; operands 4
    bytes off a 16-byte boundary. Then clustered floats: scores within
    rtol 1e-5 / atol 2e-3 and ids equal but at near ties held to their f64
    scores (near_tie_swaps), at B = 1, 8, 32 and 128 in the three
    similarities, and over four shards. Each case checks which design
    launched (lists_check). Returns the max |dv|."""
    rng = np.random.default_rng(seed + 30)
    err = 0.0
    cases = (
        (1, 300_001, DIM, True, (1, 5, 8, 9, 32, 33, 128, 129),
         ((1, "l2_norm"), (10, "l2_norm"), (32, "l2_norm"), (10, "cosine"),
          (10, "dot_product"), (33, "l2_norm"))),
        (1, 300_001, DIM, True, (1, 9, 33),
         ((1025, "l2_norm"), (1400, "l2_norm"), (1025, "cosine"))),
        (4, 200_000, DIM, True, (1, 8, 33),
         ((10, "l2_norm"), (32, "l2_norm"), (10, "cosine"))),
        (1, 200_000, 30, True, (1, 9, 129),
         ((10, "l2_norm"), (32, "cosine"))),
        (1, 200_000, 768, True, (1, 9, 129),
         ((10, "l2_norm"), (32, "l2_norm"))),
        (1, 200_000, DIM, False, (1, 8, 32, 128),
         ((10, "l2_norm"), (10, "cosine"), (10, "dot_product"))),
        (4, 200_000, DIM, False, (1,), ((10, "l2_norm"), (32, "l2_norm"))),
    )
    for s, n, d, integer, bs, rs in cases:
        data, v, nrm, ok = lists_case(dev, rng, s, n, d, integer)
        for b in bs:
            queries = data[rng.choice(n, b, replace=False)].copy()
            queries[0] = data[LIST_COPIES[0]]
            if b > 1:
                queries[1] = data[LIST_RUN[0]]
            if not integer:
                queries = queries + 0.01 * rng.standard_normal(
                    queries.shape).astype(np.float32)
            q = torch.from_numpy(queries).to(dev)
            for r, sim in rs:
                err = max(err, lists_check(
                    kf, v, nrm, ok, q, r, sim,
                    f"K1 lists S={s} n={n} d={d} B={b} r={r} {sim} "
                    f"integer={integer}", integer))
        log(f"K1 list-scan parity S={s} n={n} d={d} integer={integer}: "
            f"{'bit-equal' if integer else 'ids equal'} at B = {bs}, "
            f"(r, sim) = {rs}")
        if s == 1 and d == DIM and integer and n == 300_001 and \
                rs[0][0] <= kf.LIST_MAX_R:
            for sim in ("l2_norm", "cosine"):
                q = torch.from_numpy(data[[LIST_COPIES[0], LIST_RUN[0], 7, 9,
                                           11]].copy()).to(dev)
                err = max(err, lists_check(
                    kf, unaligned(v), nrm, ok, unaligned(q), 10, sim,
                    f"K1 lists unaligned {sim}", True))
            log("K1 list-scan parity, operands off a 16-byte boundary: "
                "bit-equal")
        del v
        torch.cuda.empty_cache()
    return err


def block_wide_check(kb, v, nrm, ok, q, k: int, sim: str, what: str) -> float:
    """K3's entry point (knn_topk_auto) on one shard of sixteenths against
    plain_block_topk: ids equal and values bit-equal, served by the wide
    tier (one block_wide_launches)."""
    before = kb.block_wide_launches.count
    gv, gi = kb.knn_topk_auto(v, nrm, ok, q, k=k, similarity=sim)
    pv, pi = kb.plain_block_topk(v, nrm, ok, q, k=k, similarity=sim)
    torch.cuda.synchronize()
    if not (torch.equal(gi, pi) and torch.equal(gv, pv)):
        bad = (gi != pi).nonzero()[:5].tolist()
        raise AssertionError(f"{what}: K3 differs from plain_block_topk "
                             f"(ids differ at {bad})")
    if kb.block_wide_launches.count - before != 1:
        raise AssertionError(f"{what}: K3's wide tier launched "
                             f"{kb.block_wide_launches.count - before} times")
    fin = torch.isfinite(pv)
    return float((gv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0


# r and similarity of the wide tier's parity cases
WIDE_RS = (33, 64, 100, 128, 256, 1024)
# the wide merge's stage-2 candidates in shared memory (kMergeStage in
# csrc/knn_wide.cuh): past them it reads every slot from device memory
WIDE_MERGE_STAGE = 16384


def wide_merge_candidates(scores, r: int, chunk: int, n_split: int) -> int:
    """The wide merge's stage-2 candidate count for one (shard, query) of
    f32 scores [n] (-inf for dead docs), as knn_wide_merge_kernel counts
    them: each range's pool (its r best under (score desc, doc id asc)),
    t0 the r-th best of the pools' first merge_prefix slots (every live one
    when they are no more than r), and the slots of all pools at or above
    t0."""
    n = scores.shape[0]
    order = torch.sort(-scores, stable=True).indices   # score desc, id asc
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=scores.device)
    live = scores > float("-inf")
    pre = min(r, 4 * -(-r // n_split))                 # merge_prefix
    pools = []
    for p in range(n_split):
        lo, hi = p * chunk, min(n, (p + 1) * chunk)
        pools.append(torch.sort(rank[lo:hi][live[lo:hi]]).values[:r])
    first = torch.cat([pool[:pre] for pool in pools])
    t0 = torch.sort(first).values[r - 1] if first.numel() > r else n
    return sum(int((pool <= t0).sum()) for pool in pools)


def merge_fallback_check(kf, kb, dev, rng, k1: bool, k3: bool) -> float:
    """The wide merge's fallback, which reads every slot from device memory
    where the ranges' prefixes hold more than WIDE_MERGE_STAGE candidates:
    one shard of 300,000 sixteenths whose docs in 24 whole ranges (from the
    third on) lie within 1/16 a coordinate of the query, so each of those
    ranges' pools is r = 1024 near docs above the merge's first bound; B = 1
    (the stacked step's), l2 and cosine. wide_merge_candidates must count
    more candidates than the merge stages (so the fallback ran), and K1 and
    K3 must equal plain_pool and plain_block_topk bit for bit. Returns the
    max |dv|."""
    n, r, near = 300_000, 1024, 24
    chunk, n_split = kf.list_geometry(1, n, 1, kf.sm_count(dev))
    data = sixteenths(rng, n, DIM)
    q0 = data[7].copy()
    lo, hi = 2 * chunk, min(n, (2 + near) * chunk)
    data[lo:hi] = q0 + rng.integers(-1, 2, (hi - lo, DIM)).astype(
        np.float32) / 16
    v = torch.from_numpy(data)[None].to(dev)
    nrm = (v.double() ** 2).sum(2).float()
    ok = torch.ones((1, n), dtype=torch.bool, device=dev)
    q = torch.from_numpy(q0[None]).to(dev)
    qsq = (q * q).sum(1)
    err = 0.0
    for sim in ("l2_norm", "cosine"):
        scores = kf._transform_scores(v[0] @ q[0], qsq[0], nrm[0], sim)
        m = wide_merge_candidates(scores, r, chunk, n_split)
        stage = min(n_split * r, WIDE_MERGE_STAGE)
        if m <= stage:
            raise AssertionError(f"wide merge fallback {sim}: {m} candidates "
                                 f"fit the merge's {stage}")
        what = f"wide merge fallback {sim} ({m} candidates, {n_split} ranges)"
        if k1:
            err = max(err, lists_check(kf, v, nrm, ok, q, r, sim, f"K1 {what}",
                                       True, planted=False))
        if k3:
            err = max(err, block_wide_check(kb, v[0], nrm[0], ok[0], q, r,
                                            sim, f"K3 {what}"))
        log(f"{what}: past the {stage} the merge stages, so read from device "
            f"memory; bit-equal")
    del v
    torch.cuda.empty_cache()
    return err


def wide_kernel_phase(kf, kb, dev, seed: int, k1: bool, k3: bool) -> float:
    """K1's wide tier (fp32, 32 < r <= 1024) against plain_pool and K3's
    against plain_block_topk on the card (lists_check, block_wide_check).
    Sixteenths (every dot exact in f32, so values and ids bit-equal, the
    planted ties in id order: LIST_COPIES across a range edge at B <= 8,
    LIST_RUN's 40 equal vectors within one sub-block): one shard of
    n = 300,001 (a ragged tail) at B = 1, 5, 8, 9, 32, 33 and 129 (one,
    two, five and seventeen 8-query tiles, full and partial) x r = 33, 64,
    100, 128, 256 and 1024 in l2, and r = 100 in cosine and dot, K3 beside
    K1; operands 4 bytes off a 16-byte boundary; four shards of 200,000
    (the last with 5 live docs, fewer than r) at B = 1, 8 and 33; d = 30
    and 768 (the two-stage rings) at B = 1, 9 and 129; n = 90 (fewer docs
    than r, in one range shorter than a sub-block) and n = 1,000 (eight
    ranges of 128 docs, each shorter than r); the merge's fallback from
    device memory (merge_fallback_check). Then clustered floats: K1
    bit-equal to kernel_order_pool, a brute force summed in the kernel's
    order (order_check; each slot where plain_pool's cuBLAS order ranks two
    neighbours the other way is logged with both docs' f64 scores), at
    B = 1, 8, 32 and 129 and over four shards. Returns the max |dv|."""
    rng = np.random.default_rng(seed + 31)
    err = 0.0
    all_b = (1, 5, 8, 9, 32, 33, 129)
    cases = (
        (1, 300_001, DIM, True, all_b,
         tuple((r, "l2_norm") for r in WIDE_RS)
         + ((100, "cosine"), (100, "dot_product"))),
        (4, 200_000, DIM, True, (1, 8, 33),
         ((64, "l2_norm"), (256, "l2_norm"), (1024, "l2_norm"),
          (100, "cosine"))),
        (1, 200_000, 30, True, (1, 9, 129),
         ((100, "l2_norm"), (1024, "cosine"))),
        (1, 200_000, 768, True, (1, 9, 129),
         ((100, "l2_norm"), (1024, "l2_norm"))),
        (1, 90, DIM, True, (1, 9), ((33, "l2_norm"), (100, "cosine"))),
        (1, 1_000, DIM, True, (1, 9), ((256, "l2_norm"), (1024, "l2_norm"))),
        (1, 200_000, DIM, False, (1, 8, 32, 129),
         ((100, "l2_norm"), (100, "cosine"), (100, "dot_product"),
          (1024, "l2_norm"))),
        (4, 200_000, DIM, False, (1,), ((128, "l2_norm"),)),
    )
    for s, n, d, integer, bs, rs in cases:
        data, v, nrm, ok = lists_case(dev, rng, s, n, d, integer)
        planted = n > LIST_RUN[-1]
        for b in bs:
            queries = data[rng.choice(n, b, replace=b > n)].copy()
            if planted:
                queries[0] = data[LIST_COPIES[0]]
                if b > 1:
                    queries[1] = data[LIST_RUN[0]]
            if not integer:
                queries = queries + 0.01 * rng.standard_normal(
                    queries.shape).astype(np.float32)
            q = torch.from_numpy(queries).to(dev)
            for r, sim in rs:
                what = (f"wide S={s} n={n} d={d} B={b} r={r} {sim} "
                        f"integer={integer}")
                if k1:
                    err = max(err, lists_check(kf, v, nrm, ok, q, r, sim,
                                               f"K1 {what}", integer,
                                               planted))
                if k3 and s == 1 and integer:
                    err = max(err, block_wide_check(kb, v[0], nrm[0], ok[0],
                                                    q, r, sim, f"K3 {what}"))
        log(f"wide-tier parity S={s} n={n} d={d} integer={integer}: "
            f"{'bit-equal' if integer else 'ids equal'} at B = {bs}, "
            f"(r, sim) = {rs}" + (" (K1 and K3)" if s == 1 and integer
                                  else " (K1)"))
        if s == 1 and d == DIM and integer and n == 300_001:
            q = torch.from_numpy(data[[LIST_COPIES[0], LIST_RUN[0], 7, 9,
                                       11]].copy()).to(dev)
            for r, sim in ((100, "l2_norm"), (1024, "cosine")):
                what = f"wide unaligned r={r} {sim}"
                if k1:
                    err = max(err, lists_check(kf, unaligned(v), nrm, ok,
                                               unaligned(q), r, sim,
                                               f"K1 {what}", True))
                if k3:
                    err = max(err, block_wide_check(
                        kb, unaligned(v[0]), nrm[0], ok[0], unaligned(q), r,
                        sim, f"K3 {what}"))
            log("wide-tier parity, operands off a 16-byte boundary: "
                "bit-equal")
        del v
        torch.cuda.empty_cache()
    return max(err, merge_fallback_check(kf, kb, dev, rng, k1, k3))


# the wide tier's tensor-core scan (K1 at bf16 and int8): the pool widths
# of its parity cases, its precisions and the profiler's kernel names
MMA_RS = (32, 40, 100, 400, 512, 1024)
REDUCED = ("bf16", "int8")
MMA_KERNELS = ("knn_wide_mma_scan_kernel", "knn_wide_merge_kernel")
F32_UNIT = 2.0 ** -24


def mma_sixteenths(rng, n: int, d: int) -> np.ndarray:
    """sixteenths() on a range narrow enough for the tensor cores' f32
    accumulation of bf16 products to be exact in any order and alignment:
    coordinates k/16 with |k| <= kmax = min(63, floor(sqrt(2^18 / d))) (45
    at d = 128, 18 at 768), each exact in bf16. Every product is then a
    multiple of 2^-8 and every partial sum of a dot at most
    d kmax^2 2^-8 <= 2^10 in magnitude: at most 2^18 units of that grain,
    inside the 2^20 the check allows itself and far inside the 2^24 of an
    f32 significand, so no alignment or rounding drops a bit and the sums
    equal cuBLAS's (plain_pool's) bit for bit."""
    kmax = min(63, math.isqrt((1 << 18) // d))
    x = np.round(clustered(rng, n, d) * 4.0) / 16.0
    return np.clip(x, -kmax / 16, kmax / 16).astype(np.float32)


def reduced_args(kf, v, nrm, ok, q, prec: str) -> tuple:
    """The pool scan's operands at `prec` as knn_fused_stacked preps them."""
    v_x, q_x, scale = kf._prep_operands(v, q, prec)
    return (v_x.contiguous(), nrm, ok, q_x.contiguous(), (q * q).sum(1),
            scale)


def f32_score_bounds(kf, rows, qd, qq, nn, sim: str):
    """(lo, hi) in f64 around the f32 score of each of `rows` ([m, d] f64)
    against query qd ([d] f64) with the f32 |q|^2 qq and norms nn: each dot
    moved by the error bound of one f32 summation of its d exact products
    (gamma_d * sum |q_i v_i|), then the transform's own f32 roundings
    (l2: qq - 2 dot + nn to 2u of qq + 2|dot| + nn, then 1 + d_sq and the
    division, u each; cosine: the norms, their product and the division to
    4u relative, then 1 + c to u; dot: 2u relative), u = 2^-24. l2, cosine
    and dot are increasing in the dot."""
    d = rows.shape[1]
    u = F32_UNIT
    gamma = d * u / (1 - d * u)
    dots = rows @ qd
    slack = gamma * (rows.abs() @ qd.abs())
    lo_dot, hi_dot = dots - slack, dots + slack
    if sim == "l2_norm":
        mag = qq + 2.0 * dots.abs() + nn + 2.0 * slack
        t_lo = torch.clamp(qq - 2.0 * hi_dot + nn - 2 * u * mag, min=0.0)
        t_hi = torch.clamp(qq - 2.0 * lo_dot + nn + 2 * u * mag, min=0.0)
        return (1.0 / (1.0 + t_hi)) * (1 - 3 * u), \
            (1.0 / (1.0 + t_lo)) * (1 + 3 * u)
    if sim == "cosine":
        den = torch.sqrt(torch.clamp(qq, min=1e-24)) * torch.sqrt(
            torch.clamp(nn, min=1e-24))
        c_lo, c_hi = lo_dot / den, hi_dot / den
        c_lo, c_hi = c_lo - 4 * u * c_lo.abs(), c_hi + 4 * u * c_hi.abs()
        return (1.0 + c_lo) / 2.0 - u, (1.0 + c_hi) / 2.0 + u
    lo = kf._transform_scores(lo_dot, qq, nn, sim)
    hi = kf._transform_scores(hi_dot, qq, nn, sim)
    return lo - 2 * u * lo.abs(), hi + 2 * u * hi.abs()


def f32_bound_check(kf, kv, ki, args, sim: str, what: str) -> float:
    """Every finite slot of a pool (vals kv, ids ki over the prepped args)
    holds a score within f32_score_bounds of its doc's exact f64 score.
    Returns the largest |score - f64 score| met."""
    v_x, nrm, _ok, q_x, qsq, _scale = args
    worst = 0.0
    for s in range(kv.shape[0]):
        for b in range(kv.shape[1]):
            fin = torch.isfinite(kv[s, b])
            docs = ki[s, b][fin].long()
            rows, qd = v_x[s, docs].double(), q_x[b].double()
            qq, nn = qsq[b].double(), nrm[s, docs].double()
            lo, hi = f32_score_bounds(kf, rows, qd, qq, nn, sim)
            got = kv[s, b][fin].double()
            out = (got < lo) | (got > hi)
            if bool(out.any()):
                j = int(out.nonzero()[0])
                raise AssertionError(
                    f"{what}: row {(s, b)} doc {int(docs[j])} score "
                    f"{float(got[j])!r} outside its f32 bound "
                    f"[{float(lo[j])!r}, {float(hi[j])!r}]")
            exact = kf._transform_scores(rows @ qd, qq, nn, sim)
            if docs.numel():
                worst = max(worst, float((got - exact).abs().max()))
    return worst


def summation_ties(kf, kv, ki, pv, pi, args, sim: str, what: str,
                   bound: bool = False) -> list:
    """bf16 pools on float data, where the tensor cores and cuBLAS sum each
    dot's d exact products in f32 in two orders: scores within rtol 1e-5 /
    atol 2e-3 slot for slot (with `bound`, where a dot's f32 ulp makes
    that tolerance too narrow, as at d = 768 with |q|^2 near 13,000: each
    pool's every score within f32_score_bounds of its doc's exact score
    instead), and every slot where the kernel's id differs
    from plain_pool's must hold a live doc of the shard, once in its row,
    that the two orders may rank either way against plain's doc: each
    doc's f64 score (the dot in f64, exact, through the plain transform on
    the kernel's norms) moved by up to the error bound of one f32
    summation, gamma_d * sum |q_i v_i| with gamma_d = d u / (1 - d u),
    u = 2^-24, on its dot, gives an interval, and the two docs' intervals
    overlap. Returns one record a slot: both docs, their f64 scores and
    the relative gap."""
    v_x, nrm, ok, q_x, qsq, _scale = args
    fin = torch.isfinite(pv)
    if not torch.equal(fin, torch.isfinite(kv)):
        raise AssertionError(f"{what}: finite slots differ")
    if bound:
        for pool_v, pool_i, name in ((kv, ki, "kernel"), (pv, pi, "plain")):
            f32_bound_check(kf, pool_v, pool_i, args, sim, f"{what} {name}")
    elif not torch.allclose(kv[fin], pv[fin], rtol=1e-5, atol=2e-3):
        raise AssertionError(f"{what}: scores beyond rtol 1e-5 / atol 2e-3")
    d = v_x.shape[2]
    gamma = d * F32_UNIT / (1 - d * F32_UNIT)
    ties = []
    for s, b, j in (ki != pi).nonzero().tolist():
        row = ki[s, b].tolist()
        doc, other = row[j], int(pi[s, b, j])
        if not (0 <= doc < v_x.shape[1] and bool(ok[s, doc])) or \
                row.count(doc) != 1 or other < 0:
            raise AssertionError(f"{what}: slot {(s, b, j)} holds doc {doc} "
                                 f"(plain: {other}): not a live doc once")
        idx = torch.tensor([doc, other], device=v_x.device)
        rows, qd = v_x[s, idx].double(), q_x[b].double()
        dots = rows @ qd
        slack = gamma * (rows.abs() @ qd.abs())
        qq, nn = qsq[b].double(), nrm[s, idx].double()
        lo = kf._transform_scores(dots - slack, qq, nn, sim).tolist()
        hi = kf._transform_scores(dots + slack, qq, nn, sim).tolist()
        a, c = kf._transform_scores(dots, qq, nn, sim).tolist()
        if lo[0] > hi[1] or lo[1] > hi[0]:
            raise AssertionError(
                f"{what}: slot {(s, b, j)} holds doc {doc}, plain {other} "
                f"(f64 scores {a!r} and {c!r}, further apart than f32 "
                f"summation moves them)")
        ties.append({"slot": [s, b, j], "kernel": [doc, a],
                     "plain": [other, c],
                     "gap": abs(a - c) / max(abs(a), abs(c))})
    return ties


def bf16_float_check(kf, args, r: int, sim: str, what: str,
                     bound: bool = False) -> float:
    """K1 at bf16 on float data against plain_pool: summation_ties (with
    `bound`: every score within its f32 error bound), each tie logged.
    Returns the max |dv| over the finite slots."""
    kv, ki = kf.pool_scan(*args, r=r, similarity=sim, score_precision="bf16")
    pv, pi = kf.plain_pool(*args, r=r, similarity=sim,
                           score_precision="bf16")
    torch.cuda.synchronize()
    for tie in summation_ties(kf, kv, ki, pv, pi, args, sim, what, bound):
        log(f"{what}: summation tie at {tie['slot']}: kernel doc "
            f"{tie['kernel'][0]} (f64 {tie['kernel'][1]!r}), plain doc "
            f"{tie['plain'][0]} (f64 {tie['plain'][1]!r}), relative gap "
            f"{tie['gap']:.3g}")
    fin = torch.isfinite(pv)
    return float((kv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0


def mma_check(kf, args, r: int, sim: str, prec: str, what: str,
              integer: bool, planted: bool) -> float:
    """One K1 pool scan at bf16 or int8 (args: the prepped operands) against
    plain_pool, served by the tensor-core tier alone (one launch of K1, on
    mma_launches): int8 pools bit-equal on any data, bf16 pools bit-equal
    on mma_sixteenths (`integer`) and on floats equal but at summation
    ties (bf16_float_check); where `planted`, LIST_COPIES first in id
    order for query 0 and LIST_RUN for query 1 (l2 and cosine). Returns the
    max |dv|."""
    counters = (kf.launches, kf.list_launches, kf.wide_launches,
                kf.mma_launches)
    before = [c.count for c in counters]
    if prec == "bf16" and not integer:
        err = bf16_float_check(kf, args, r, sim, what)
    else:
        err = compare_pools(kf, args, r, sim, prec, what, bits=True)
    got = [c.count - b for c, b in zip(counters, before)]
    if got != [1, 0, 0, 1]:
        raise AssertionError(f"{what}: (K1, list scan, wide tier, tensor-core "
                             f"tier) launched {got} times, want [1, 0, 0, 1]")
    if planted and sim != "dot_product":
        _kv, ki = kf.pool_scan(*args, r=r, similarity=sim,
                               score_precision=prec)
        if ki[0, 0, :2].tolist() != list(LIST_COPIES):
            raise AssertionError(f"{what}: planted tie gave "
                                 f"{ki[0, 0, :2].tolist()}")
        run = min(r, len(LIST_RUN))
        if args[3].shape[0] > 1 and \
                ki[0, 1, :run].tolist() != list(LIST_RUN[:run]):
            raise AssertionError(f"{what}: planted run gave "
                                 f"{ki[0, 1, :run].tolist()}")
    return err


def mma_kernel_phase(kf, dev, seed: int) -> float:
    """K1's tensor-core tier (bf16 and int8, r <= 1024) against plain_pool
    on the card (mma_check), at both precisions. mma_sixteenths, on which
    bf16's f32 accumulation is exact in any order (values and ids
    bit-equal, the planted ties in id order: LIST_COPIES across a range
    edge at B <= 8, LIST_RUN's 40 equal vectors within one sub-block): one
    shard of n = 300,001 (a ragged tail) at B = 1, 5, 8, 9, 32, 33 and 129
    x r = 32, 40, 100, 400, 512 and 1024 in l2, r = 40 in cosine and 400 in
    dot; operands 4 bytes off a 16-byte boundary (copied by the wrapper);
    four shards of 200,000 (the last with 5 live docs, fewer than r) at
    B = 1, 8 and 33; d = 30 (bf16 rows padded to 32 elements, int8 to 32),
    100 (104 and 112) and 768 at B = 1, 9 and 129; n = 90 (fewer docs than
    r, one range shorter than a sub-block) and n = 1,000 (ranges of 128
    docs, each shorter than r). Then clustered floats at B = 1, 8, 32 and
    129 and over four shards: int8 still bit-equal, bf16 ids equal but at
    summation ties, each logged with both docs' f64 scores. Returns the
    max |dv|."""
    rng = np.random.default_rng(seed + 32)
    err = 0.0
    all_b = (1, 5, 8, 9, 32, 33, 129)
    cases = (
        (1, 300_001, DIM, True, all_b,
         tuple((r, "l2_norm") for r in MMA_RS)
         + ((40, "cosine"), (400, "dot_product"))),
        (4, 200_000, DIM, True, (1, 8, 33),
         ((40, "l2_norm"), (400, "l2_norm"), (1024, "cosine"))),
        (1, 200_000, 30, True, (1, 9, 129),
         ((40, "l2_norm"), (1024, "cosine"))),
        (1, 200_000, 100, True, (1, 9, 129),
         ((400, "l2_norm"), (32, "dot_product"))),
        (1, 200_000, 768, True, (1, 9, 129),
         ((40, "l2_norm"), (1024, "l2_norm"))),
        (1, 90, DIM, True, (1, 9), ((32, "l2_norm"), (100, "cosine"))),
        (1, 1_000, DIM, True, (1, 9), ((400, "l2_norm"), (1024, "l2_norm"))),
        (1, 200_000, DIM, False, (1, 8, 32, 129),
         ((40, "l2_norm"), (400, "l2_norm"), (400, "cosine"),
          (512, "dot_product"))),
        (4, 200_000, DIM, False, (1,), ((400, "l2_norm"),)),
    )
    for s, n, d, integer, bs, rs in cases:
        data, v, nrm, ok = lists_case(dev, rng, s, n, d, integer,
                                      grid=mma_sixteenths)
        planted = integer and n > LIST_RUN[-1]
        for b in bs:
            queries = data[rng.choice(n, b, replace=b > n)].copy()
            if n > LIST_RUN[-1]:
                queries[0] = data[LIST_COPIES[0]]
                if b > 1:
                    queries[1] = data[LIST_RUN[0]]
            if not integer:
                queries = queries + 0.01 * rng.standard_normal(
                    queries.shape).astype(np.float32)
            q = torch.from_numpy(queries).to(dev)
            for prec in REDUCED:
                args = reduced_args(kf, v, nrm, ok, q, prec)
                for r, sim in rs:
                    err = max(err, mma_check(
                        kf, args, r, sim, prec,
                        f"K1 mma {prec} S={s} n={n} d={d} B={b} r={r} {sim} "
                        f"integer={integer}", integer, planted))
        log(f"tensor-core tier parity S={s} n={n} d={d} integer={integer}: "
            f"{'bit-equal' if integer else 'int8 bit-equal, bf16 ids equal'}"
            f" at B = {bs}, (r, sim) = {rs}, bf16 and int8")
        if s == 1 and d == DIM and integer and n == 300_001:
            q = torch.from_numpy(data[[LIST_COPIES[0], LIST_RUN[0], 7, 9,
                                       11]].copy()).to(dev)
            for prec in REDUCED:
                v_x, nrm_, ok_, q_x, qsq, scale = reduced_args(
                    kf, v, nrm, ok, q, prec)
                args = (unaligned(v_x), nrm_, ok_, unaligned(q_x), qsq,
                        scale)
                for r, sim in ((40, "l2_norm"), (400, "cosine")):
                    err = max(err, mma_check(
                        kf, args, r, sim, prec,
                        f"K1 mma {prec} unaligned r={r} {sim}", True, True))
            log("tensor-core tier parity, operands off a 16-byte boundary: "
                "bit-equal")
        del v
        torch.cuda.empty_cache()
    return err


# the profiler's kernel names of K1's and K3's list scan
LIST_KERNELS = ("knn_pool_scan_kernel", "knn_pool_merge_kernel")


def pool_bound(s: int, n: int, d: int, b: int, r: int,
               prec: str = "fp32") -> dict:
    """The least time of one pool scan: the slab (4, 2 or 1 bytes an
    element at fp32, bf16, int8), norms and valid flags read once, the
    queries and |q|^2, the [S, B, r] pools written, over 3.35 TB/s; against
    2*B*S*n*d operations over the card's peak for the operands' type (67
    TFLOP/s fp32, 989 bf16, 1,979 int8)."""
    width = {"fp32": 4, "bf16": 2, "int8": 1}[prec]
    nbytes = s * n * (d * width + 4 + 1) + b * (d * width + 4) + s * b * r * 8
    flops = 2 * b * s * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[prec] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def time_pool(kf, args, r: int, q, v, nrm, k: int, label: str,
              plain: bool = True) -> dict:
    """One K1 shape: the list scan's CUDA-event ms and device ms of its two
    kernels by name, the tile scan's beside it in the same window, the
    plain version's and the library yardstick's (torch.topk over the
    l2-transformed q @ v.T, per shard), with the memory clock read before
    and after."""
    clock0 = mem_clock()

    def lists():
        return kf.pool_scan(*args, r=r, similarity="l2_norm",
                            score_precision="fp32")

    def tile():
        return kf._launch_tile(*args, r=r, similarity="l2_norm",
                               score_precision="fp32")

    qsq = args[4]

    def library():
        d_sq = torch.clamp(qsq[None, :, None] - 2.0 * torch.einsum(
            "bd,snd->sbn", q, v) + nrm[:, None, :], min=0.0)
        return torch.topk(1.0 / (1.0 + d_sq), k)

    # 100 calls: at the serving shapes the host, not the card, sets the
    # pace, and its noise needs the longer average
    ms = time_ms(lists, 100)
    tile_ms = time_ms(tile, 100)
    ms_again = time_ms(lists, 100)
    plain_ms = time_ms(lambda: kf.plain_pool(
        *args, r=r, similarity="l2_norm", score_precision="fp32"), 5) \
        if plain else None
    library_ms = time_ms(library, 10)
    prof = device_profile(lists, 5)
    tile_prof = device_profile(tile, 5)
    out = {"ms": ms, "ms_again": ms_again, "tile_ms": tile_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "device_ms": prof and prof["device_ms"],
           "scan_device_ms": kernel_ms(prof, LIST_KERNELS[0]),
           "merge_device_ms": kernel_ms(prof, LIST_KERNELS[1]),
           "tile_device_ms": tile_prof and tile_prof["device_ms"],
           "mem_clock": [clock0, mem_clock()]}
    log(f"K1 {label}: list scan {ms:.4f} / {ms_again:.4f} ms (device "
        f"{out['device_ms']}: scan {out['scan_device_ms']}, merge "
        f"{out['merge_device_ms']}), tile scan {tile_ms:.4f} ms (device "
        f"{out['tile_device_ms']}), plain {plain_ms}, library "
        f"{library_ms:.4f} ms; memory clock {out['mem_clock']}")
    return out


def timing_phase(kf, dev, seed: int) -> dict:
    """K1 (fp32, l2, k = 10: the list scan) at the SIFT-1M shape (1,000,000
    clustered 128-d docs) at B = 1, 32 and 128, then at the serving shapes:
    one shard of 200,000 docs at B = 1 and 8, four of 5,000 at B = 1; each
    checked against plain_pool first, and the tile scan timed beside it
    against kernel_order_pool (tile_check), then timed (time_pool) beside
    its bound (pool_bound)."""
    rng = np.random.default_rng(seed + 1)
    k = 10
    out = {}
    shapes = ((1, 1_000_000, (1, 32, 128)), (1, 200_000, (1, 8)),
              (4, 5_000, (1,)))
    for s, n, bs in shapes:
        v = torch.from_numpy(clustered(rng, s * n, DIM).reshape(s, n, DIM)) \
            .to(dev)
        nrm = (v.double() ** 2).sum(2).float()
        ok = torch.ones((s, n), dtype=torch.bool, device=dev)
        for b in bs:
            q = v[0, torch.from_numpy(rng.choice(n, b, replace=False))
                  .to(dev)] + 0.01
            args, r = scan_inputs(kf, v, nrm, ok, q, k, "fp32")
            label = f"S={s} n={n} B={b}"
            compare_pools(kf, args, r, "l2_norm", "fp32", label)
            tile_check(kf, args, r, label)
            t = time_pool(kf, args, r, q, v, nrm, k, label,
                          plain=n * s * b <= 128_000_000)
            t.update(pool_bound(s, n, DIM, b, r))
            log(f"K1 {label}: bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']})")
            out[b if n == 1_000_000 else label] = t
        del v
        torch.cuda.empty_cache()
    return out


# the profiler's kernel names of the tile scan (K1 at bf16 and int8 past
# r = 1024; the yardstick beside the other designs) and of the wide tier
TILE_KERNELS = ("knn_scan_kernel", "knn_merge_kernel")
WIDE_KERNELS = ("knn_wide_scan_kernel", "knn_wide_merge_kernel")
# the shapes that ran the tile scan before the wide tier: K1 at fp32 with
# r = 64, 100, 128; K3 at k = 64-1024; K1 at bf16 and int8 with k = 10 and
# 100 (pools of R = 40 and 400)
WIDE_K1 = ((64, 100, 128), (1, 8, 32, 128))
WIDE_K3 = ((64, 128, 256, 1024), (1, 32))
WIDE_REDUCED = (("bf16", "int8"), (10, 100), (1, 8, 32))


def check_scan(kf, args, r: int, prec: str, what: str) -> None:
    """A pool scan and the tile scan beside it against their references on
    clustered floats before they are timed: at int8 both bit-equal to
    plain_pool; at bf16 both ids equal to plain_pool but at summation ties
    (summation_ties, each logged); at fp32 both bit-equal to
    kernel_order_pool (order_check, tile_check)."""
    if prec == "fp32":
        kv, ki = kf.pool_scan(*args, r=r, similarity="l2_norm",
                              score_precision=prec)
        order_check(kf, kv, ki, args, r, "l2_norm", what)
        tile_check(kf, args, r, what)
        return
    pv, pi = kf.plain_pool(*args, r=r, similarity="l2_norm",
                           score_precision=prec)
    for design, scan in (("", kf.pool_scan),
                         (" (tile scan)", kf._launch_tile)):
        kv, ki = scan(*args, r=r, similarity="l2_norm", score_precision=prec)
        torch.cuda.synchronize()
        if prec == "int8":
            if not (torch.equal(ki, pi) and torch.equal(kv, pv)):
                raise AssertionError(f"{what}{design}: not bit-equal to "
                                     f"plain_pool")
            continue
        for tie in summation_ties(kf, kv, ki, pv, pi, args, "l2_norm",
                                  what + design):
            log(f"{what}{design}: summation tie {tie}")


def time_design(label: str, design, tile, plain, library, bound: dict,
                iters: int = 20, names=WIDE_KERNELS) -> dict:
    """One shape of the wide tier's record: CUDA-event ms of the design the
    wrapper picks (twice, the tile scan's between when it is not the same
    design), the plain version's and the library call's; device ms of each
    design by kernel name (the design's `names`, scan and merge, and
    TILE_KERNELS); the memory clock before and after."""
    clock0 = mem_clock()
    ms = time_ms(design, iters)
    tile_ms = time_ms(tile, iters) if tile is not None else None
    ms_again = time_ms(design, iters)
    plain_ms = time_ms(plain, 3)
    library_ms = time_ms(library, 10)
    prof = device_profile(design, 5)
    tile_prof = device_profile(tile, 5) if tile is not None else prof
    out = {"ms": ms, "ms_again": ms_again, "tile_ms": tile_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "device_ms": prof and prof["device_ms"],
           "scan_device_ms": kernel_ms(prof, names[0]),
           "merge_device_ms": kernel_ms(prof, names[1]),
           "tile_device_ms": tile_prof and tile_prof["device_ms"],
           "tile_scan_device_ms": kernel_ms(tile_prof, TILE_KERNELS[0]),
           "tile_merge_device_ms": kernel_ms(tile_prof, TILE_KERNELS[1]),
           "mem_clock": [clock0, mem_clock()], **bound}
    log(f"wide record {label}: {json.dumps(out)}")
    return out


def wide_timing_phase(kf, kb, dev, seed: int, k1: bool, k3: bool) -> dict:
    """The tile scan's former shapes at the SIFT-1M shape (1,000,000
    clustered 128-d docs, l2): K1 (pool_scan) at fp32 with r = 64, 100 and
    128 at B = 1, 8, 32 and 128 (the wide tier), and at bf16 and int8 with
    k = 10 and 100 at B = 1, 8 and 32 (the tensor-core tier, pools of
    R = 40 and 400); K3 (knn_topk_auto) at k = 64, 128, 256 and 1024 at
    B = 1 and 32. Each, and the tile scan beside it (`_launch_tile`,
    `_launch_block_tile`), is checked first (check_scan, block_tile_check),
    then timed by time_design beside the tile scan on the same call. The
    library call is torch.topk at the pool's width over the l2-transformed
    q @ v.T (bf16: of bf16 operands; int8: the f32 product of the int8
    values, exact at d = 128, scaled)."""
    rng = np.random.default_rng(seed + 3)
    n = SIFT_DOCS
    v = torch.from_numpy(clustered(rng, n, DIM))[None].to(dev)
    nrm = (v.double() ** 2).sum(2).float()
    ok = torch.ones((1, n), dtype=torch.bool, device=dev)
    q_all = v[0, torch.from_numpy(rng.choice(n, 128, replace=False))
              .to(dev)] + 0.01
    out = {}

    def library_fn(args, r, prec):
        v_x, _nrm, _ok, q_x, qsq, scale = args
        # int8 values held as f32 (a copy made once, outside the timing)
        v8 = v_x[0].float() if prec == "int8" else None

        def library():
            if prec == "bf16":
                dots = (q_x @ v_x[0].T).float()
            elif prec == "int8":
                dots = (q_x.float() @ v8.T) * scale[0]
            else:
                dots = q_x @ v_x[0].T
            d_sq = torch.clamp(qsq[:, None] - 2.0 * dots + nrm[0][None],
                               min=0.0)
            return torch.topk(1.0 / (1.0 + d_sq), r)
        return library

    shapes = []
    if k1:
        shapes += [("fp32", r, b) for r in WIDE_K1[0] for b in WIDE_K1[1]]
        shapes += [(prec, k, b) for prec in WIDE_REDUCED[0]
                   for k in WIDE_REDUCED[1] for b in WIDE_REDUCED[2]]
    for prec, k, b in shapes:
        q = q_all[:b].contiguous()
        args, r = scan_inputs(kf, v, nrm, ok, q, k, prec)
        label = f"K1 {prec} k={k} r={r} B={b}"
        check_scan(kf, args, r, prec, label)
        design = functools.partial(kf.pool_scan, *args, r=r,
                                   similarity="l2_norm",
                                   score_precision=prec)
        tile = functools.partial(kf._launch_tile, *args, r=r,
                                 similarity="l2_norm", score_precision=prec)
        plain = functools.partial(kf.plain_pool, *args, r=r,
                                  similarity="l2_norm", score_precision=prec)
        tier = kf.scan_tier(prec, r)
        out[label] = time_design(label, design, tile, plain,
                                 library_fn(args, r, prec),
                                 pool_bound(1, n, DIM, b, r, prec),
                                 names=MMA_KERNELS if tier == "mma"
                                 else WIDE_KERNELS)
        out[label]["tier"] = tier
    if k3:
        for k in WIDE_K3[0]:
            for b in WIDE_K3[1]:
                q = q_all[:b].contiguous()
                qsq = (q * q).sum(1)
                one = torch.ones(1, device=dev)
                label = f"K3 k={k} B={b}"
                gv, gi = kb.knn_topk_auto(v[0], nrm[0], ok[0], q, k=k)
                order_check(kf, gv[None], gi[None], (v, nrm, ok, q, qsq, one),
                            k, "l2_norm", label)
                block_tile_check(kb, kf, v[0], nrm[0], ok[0], q, k, label)
                qp = kb._pad_queries(q, None)
                design = functools.partial(kb.knn_topk_auto, v[0], nrm[0],
                                           ok[0], q, k=k)
                tile = functools.partial(kb._launch_block_tile, v[0], nrm[0],
                                         ok[0], qp, k=k, similarity="l2_norm")
                plain = functools.partial(family_plain, kb, "knn_block", v[0],
                                          nrm[0], ok[0], q, k)
                out[label] = time_design(
                    label, design, tile, plain,
                    library_fn((v, nrm, ok, q, qsq, one), k, "fp32"),
                    blocks_bound("knn_block", n, DIM, b, k, 0))
                out[label]["tier"] = kb.block_tier(k)
    del v
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# K1 at fp32 past r = 1024: the large-r tier (csrc/knn_large.cuh)
# --------------------------------------------------------------------------

# the r of the large-r tier's checks, and past them one of five tiles and
# three merge rounds
LARGE_RS = (1025, 1400, 2000, 4096, 10_000)
LARGE_MULTI_TILE_R = 20_000
# the tier's kernels by the profiler's names (its keys are cut at 60
# characters): the scans, the multi-CTA select's, the yardstick select
LARGE_SCAN = "scan"
LARGE_SELECT = ("knn_large_pass", "knn_large_collect", "knn_large_tile",
                "knn_large_merge", "knn_large_rank", "knn_large_place")
LARGE_YARDSTICK = "knn_large_select_kernel"


def select_variants_check(kf, args, r: int, sim: str, prec: str,
                          what: str) -> None:
    """The tier's pool (pool_scan) against its select run again on the
    scan's keys by each sort and by the yardstick (the earlier one-CTA
    select): bit for bit."""
    lib = kf._library()
    want_v, want_i = kf.pool_scan(*args, r=r, similarity=sim,
                                  score_precision=prec)
    keys = kf.large_keys(lib, *args, similarity=sim, score_precision=prec)
    runs = {sort: functools.partial(kf.large_select, lib, keys, r, sort)
            for sort in kf.LARGE_SORTS}
    runs["yardstick"] = functools.partial(kf.large_select_yardstick, lib,
                                          keys, r)
    for name, run in runs.items():
        v, i = run()
        torch.cuda.synchronize()
        if not (torch.equal(i, want_i) and torch.equal(v, want_v)):
            bad = (i != want_i).nonzero()[:5].tolist()
            raise AssertionError(f"{what}: the {name} select differs from "
                                 f"the tier's pool (ids differ at {bad})")


def large_check(kf, args, scores, r: int, sim: str, what: str) -> float:
    """One K1 scan at fp32 with r > 1024 on clustered floats: ids and
    values bit-equal to the kernel-order brute force's top r (`scores`:
    kernel_order_scores on the same operands, order_top), and exactly one
    K1 launch, on the large-r tier and its multi-CTA select (none of the
    yardstick); then each sort and the yardstick on the same keys
    (select_variants_check). Returns the max |dv| (0)."""
    counters = (kf.launches, kf.large_launches, kf.large_select_launches,
                kf.yardstick_launches)
    before = [c.count for c in counters]
    kv, ki = kf.pool_scan(*args, r=r, similarity=sim, score_precision="fp32")
    torch.cuda.synchronize()
    got = [c.count - b for c, b in zip(counters, before)]
    if got != [1, 1, 1, 0]:
        raise AssertionError(f"{what}: (K1, large-r tier, its select, the "
                             f"yardstick) launched {got} times, want "
                             f"[1, 1, 1, 0]")
    rv, ri = order_top(kf, scores, r)
    if not (torch.equal(ki, ri) and torch.equal(kv, rv)):
        bad = (ki != ri).nonzero()[:5].tolist()
        raise AssertionError(f"{what}: differs from the kernel-order brute "
                             f"force (ids differ at {bad})")
    select_variants_check(kf, args, r, sim, "fp32", what)
    fin = torch.isfinite(rv)
    return float((kv[fin] - rv[fin]).abs().max()) if bool(fin.any()) else 0.0


def score_keys(scores, valid):
    """The scans' u32 score keys (in int32) of f32 scores [S, B, n] (-0.0
    as +0.0): 0 for -inf and for a dead doc (valid [S, n])."""
    u = torch.where(scores == 0, torch.zeros_like(scores), scores).view(
        torch.int32)
    sk = torch.where(u < 0, ~u, u | -0x80000000)
    live = valid[:, None, :] & (scores > float("-inf"))
    return torch.where(live, sk, torch.zeros_like(sk)).contiguous()


def select_stress_check(kf, dev, seed: int) -> int:
    """The multi-CTA select, by both sorts, and the yardstick on key rows
    built to stress it, bit-equal to plain_large_select: every live doc one
    score (every key ties: the compaction takes them in doc order, across
    slices); a first-level bin
    (exponent and three mantissa bits) holding exactly the keys still
    needed; r equal to the live count and past it; four shards, one with 5
    live docs; and B = 33 over 4 shards (132 rows: two CTAs a row) of
    scores tied in runs. Returns the rows checked."""
    rng = np.random.default_rng(seed + 46)
    lib = kf._library()
    n = 60_000

    def tied(s: int, b: int, m: int) -> np.ndarray:
        return (np.round(rng.uniform(0, 1, (s, b, m)) * 4608) / 4608).astype(
            np.float32)

    exact = rng.uniform(0.0, 0.25, n).astype(np.float32)
    exact[:2000] = rng.uniform(0.75, 1.0, 2000)
    exact[2000:10_000] = rng.uniform(0.5, 0.56, 8000)
    dead = rng.random((1, n)) >= 0.03
    four = rng.random((4, 12_000)) >= 0.03
    four[3] = False
    four[3, :5] = True
    live = int(dead.sum())
    cases = (
        ("every live doc one score", np.full((1, 2, n), 0.5, np.float32),
         np.ones((1, n), bool), (1025, 4096, 10_000, LARGE_MULTI_TILE_R)),
        ("a first-level bin of exactly the keys needed", exact[None, None],
         np.ones((1, n), bool), (10_000,)),
        ("r the live count and past it", tied(1, 2, n), dead,
         (live, live + 777)),
        ("four shards, one with 5 live docs", tied(4, 9, 12_000), four,
         (1025, 10_000)),
        ("B = 33 over four shards", tied(4, 33, 12_000),
         rng.random((4, 12_000)) >= 0.03, (1025, 4096, 10_000)),
    )
    rows = 0
    for what, scores, valid, rs in cases:
        keys = score_keys(torch.from_numpy(scores).to(dev),
                          torch.from_numpy(valid).to(dev))
        for r in rs:
            want_v, want_i = kf.plain_large_select(keys, r)
            runs = {sort: functools.partial(kf.large_select, lib, keys, r,
                                            sort) for sort in kf.LARGE_SORTS}
            runs["yardstick"] = functools.partial(kf.large_select_yardstick,
                                                  lib, keys, r)
            for name, run in runs.items():
                v, i = run()
                torch.cuda.synchronize()
                if not (torch.equal(i, want_i) and torch.equal(v, want_v)):
                    bad = (i != want_i).nonzero()[:5].tolist()
                    raise AssertionError(f"select stress [{what}] r={r}: "
                                         f"the {name} select differs from "
                                         f"plain_large_select at {bad}")
            rows += keys.shape[0] * keys.shape[1]
        log(f"K1 large-r select stress [{what}]: both sorts and the "
            f"yardstick bit-equal to plain_large_select at r = {rs}")
    return rows


def large_kernel_phase(kf, dev, seed: int) -> float:
    """K1's large-r tier (fp32, r > 1024) on clustered floats with 3% dead
    docs, bit for bit against the kernel-order brute force, and each sort of
    its select and the yardstick against its pool (large_check): one shard
    of 60,000 128-d docs at B = 1, 9 and 33 x r = 1025, 1400, 2000, 4096,
    10,000 and 20,000 (five tiles, three merge rounds) in l2 and cosine;
    one of 20,000 768-d docs at the same B and r up to 10,000; four shards
    of 12,000 (the last with 5 live docs, fewer than r) at B = 1, 9 and 33;
    d = 30 (padded to 32); a shard of 1,500 docs at r = 2048 and 5000, past
    its live count, which must return every live doc; and a shard of
    20,000 copies of one vector (every score equal: the select's threshold
    is decided by doc order). Beside it the tile scan, the yardstick
    timed beside every design, at r = 1025 and 1400 (d = 128: its pools fit
    shared memory) against the same brute force (tile_check). Returns the
    max |dv|."""
    rng = np.random.default_rng(seed + 40)
    err = 0.0
    if LARGE_MULTI_TILE_R <= 4 * kf.LARGE_TILE:
        raise AssertionError("the large-r checks do not reach three merge "
                             "rounds of the select's sort")
    cases = (
        (1, 60_000, DIM, (1, 9, 33), ("l2_norm", "cosine"),
         LARGE_RS + (LARGE_MULTI_TILE_R,), False),
        (1, 20_000, 768, (1, 9, 33), ("l2_norm", "cosine"), LARGE_RS, False),
        (4, 12_000, DIM, (1, 9, 33), ("l2_norm",), (1025, 4096, 10_000),
         False),
        (1, 5_000, 30, (1, 9), ("l2_norm",), (1025, 2000), False),
        (1, 1_500, DIM, (1, 9), ("l2_norm",), (2048, 5000), False),
        (1, 20_000, DIM, (1, 9), ("l2_norm",), (1025, 4096, 10_000), True),
    )
    for s, n, d, bs, sims, rs, same in cases:
        data = clustered(rng, s * n, d).reshape(s, n, d)
        if same:
            data[:] = data[0, 0]
        v = torch.from_numpy(data).to(dev)
        nrm = (v.double() ** 2).sum(2).float()
        ok = torch.from_numpy(rng.random((s, n)) >= 0.03).to(dev)
        if s == 4:
            ok[3] = False
            ok[3, :5] = True
        one = torch.ones(s, device=dev)
        for b in bs:
            q = v[0, torch.from_numpy(rng.choice(n, b, replace=False))
                  .to(dev)] + 0.01 * torch.randn((b, d), device=dev)
            qsq = (q * q).sum(1)
            args = (v, nrm, ok, q, qsq, one)
            for sim in sims:
                scores = kernel_order_scores(kf, v, nrm, ok, q, qsq, sim)
                for r in rs:
                    what = (f"K1 large S={s} n={n} d={d} B={b} r={r} {sim}"
                            f"{' one vector' if same else ''}")
                    err = max(err, large_check(kf, args, scores, r, sim,
                                               what))
                    if r > n:
                        kv, _ki = kf.pool_scan(*args, r=r, similarity=sim,
                                               score_precision="fp32")
                        live = ok.sum(1)[:, None].expand(s, b)
                        if not torch.equal(torch.isfinite(kv).sum(2), live):
                            raise AssertionError(f"{what}: not every live "
                                                 f"doc returned")
                del scores
            if s == 1 and d == DIM and n == 60_000:
                for r in (1025, 1400):
                    tile_check(kf, args, r, f"K1 S=1 n={n} B={b} r={r}")
        log(f"K1 large-r tier parity S={s} n={n} d={d}"
            f"{' (one vector)' if same else ''}: bit-equal to the "
            f"kernel-order brute force at B = {bs}, r = {rs}, {sims}; both "
            f"sorts and the yardstick equal")
        del v
        torch.cuda.empty_cache()
    return err


def time_large(kf, label: str, args, r: int, prec: str, plain, library,
               bound: dict) -> dict:
    """One shape of the large-r record: CUDA-event ms of the tier
    (pool_scan, twice, around the rest), of its select alone on the scan's
    keys by each sort and by the yardstick, of the plain versions
    (plain_pool, plain_large_select) and of the library calls (the tier's:
    `library`; the select's: torch.topk over the keys' scores, decoded
    before timing); device ms of each by kernel name (the select's share
    of the tier: its device ms less the scan's, the state's zeroing
    included); the select's bound (the keys read once, the r winners
    written); the memory clock before and after."""
    lib = kf._library()
    clock0 = mem_clock()
    tier = functools.partial(kf.pool_scan, *args, r=r, similarity="l2_norm",
                             score_precision=prec)
    keys = kf.large_keys(lib, *args, similarity="l2_norm",
                         score_precision=prec)
    scores = kf.key_scores(keys)
    sel = {sort: functools.partial(kf.large_select, lib, keys, r, sort)
           for sort in kf.LARGE_SORTS}
    yard = functools.partial(kf.large_select_yardstick, lib, keys, r)
    ms = time_ms(tier, 20)
    sel_ms = {sort: time_ms(fn, 20) for sort, fn in sel.items()}
    yard_ms = time_ms(yard, 10)
    ms_again = time_ms(tier, 20)
    plain_ms = time_ms(plain, 3)
    sel_plain_ms = time_ms(functools.partial(kf.plain_large_select, keys, r),
                           3)
    library_ms = time_ms(library, 10)
    sel_library_ms = time_ms(lambda: torch.topk(scores, r), 10)
    prof = device_profile(tier, 5)
    sel_prof = {sort: device_profile(fn, 5) for sort, fn in sel.items()}
    yard_prof = device_profile(yard, 5)
    scan_ms = kernel_ms(prof, LARGE_SCAN)
    S, B, n = keys.shape
    sel_bytes = 4 * S * B * n + 8 * S * B * r
    out = {"ms": ms, "ms_again": ms_again, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "device_ms": prof and prof["device_ms"],
           "scan_device_ms": scan_ms,
           "select_device_ms": prof and prof["device_ms"] - scan_ms,
           "select_kernels": {part: kernel_ms(prof, part)
                              for part in LARGE_SELECT},
           "sort": kf.large_sort_plan(r),
           "select_ms": sel_ms,
           "select_device": {sort: p and p["device_ms"]
                             for sort, p in sel_prof.items()},
           "select_kernels_by_sort": {
               sort: {part: kernel_ms(p, part) for part in LARGE_SELECT}
               for sort, p in sel_prof.items()},
           "yardstick_ms": yard_ms,
           "yardstick_device_ms": kernel_ms(yard_prof, LARGE_YARDSTICK),
           "select_plain_ms": sel_plain_ms,
           "select_library_ms": sel_library_ms,
           "select_bound_ms": sel_bytes / HBM_BYTES_PER_S * 1e3,
           "select_bound_by": "bytes",
           "mem_clock": [clock0, mem_clock()], **bound}
    log(f"large record {label}: {json.dumps(out)}")
    return out


# (docs, slots, d, r) of the large-r records: the 768-d index's slab and
# cell A's
LARGE_SHAPES = ((20_000, 32_768, 768, (1025, 2000, 4096)),
                (200_000, 262_144, DIM, (10_000, LARGE_MULTI_TILE_R)))
# the shape of the select's line in the kernels record
LARGE_SELECT_HEADLINE = "K1 large n=200000 slots=262144 d=128 r=10000 B=1"


def large_timing(kf, dev, seed: int) -> dict:
    """K1's large-r tier at the stacked step's shapes (one shard, B = 1, l2,
    the serving slab's power-of-two slot count): 20,000 768-d docs in 32,768
    slots at r = 1025, 2000 and 4096, cell A's 200,000 128-d docs in
    262,144 slots at r = 10,000 and 20,000; each checked first
    (large_check), then timed (time_large: the tier, its select by each
    sort, the yardstick, the plain versions and the library calls:
    torch.topk over the l2-transformed q @ v.T for the tier) beside its
    bound (pool_bound: the slab, norms and flags read once, the pool
    written; the keys the design writes and reads back are its scratch and
    are not counted)."""
    rng = np.random.default_rng(seed + 41)
    out = {}
    for n_docs, slots, d, rs in LARGE_SHAPES:
        data = np.zeros((1, slots, d), np.float32)
        data[0, :n_docs] = clustered(rng, n_docs, d)
        v = torch.from_numpy(data).to(dev)
        nrm = (v.double() ** 2).sum(2).float()
        ok = torch.zeros((1, slots), dtype=torch.bool, device=dev)
        ok[0, :n_docs] = True
        q = v[0, int(rng.integers(n_docs))][None] + 0.01
        qsq = (q * q).sum(1)
        args = (v, nrm, ok, q, qsq, torch.ones(1, device=dev))
        scores = kernel_order_scores(kf, v, nrm, ok, q, qsq, "l2_norm")
        for r in rs:
            label = f"K1 large n={n_docs} slots={slots} d={d} r={r} B=1"
            large_check(kf, args, scores, r, "l2_norm", label)
            plain = functools.partial(kf.plain_pool, *args, r=r,
                                      similarity="l2_norm",
                                      score_precision="fp32")

            def library(r=r):
                d_sq = torch.clamp(qsq[:, None] - 2.0 * (q @ v[0].T)
                                   + nrm[0][None], min=0.0)
                return torch.topk(1.0 / (1.0 + d_sq), r)

            out[label] = time_large(kf, label, args, r, "fp32", plain,
                                    library, pool_bound(1, slots, d, 1, r))
        del v, scores
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# K1 at bf16 and int8 past r = 1024: the large-r tier's tensor-core scan
# (csrc/knn_large_mma.cuh)
# --------------------------------------------------------------------------

LARGE_MMA_RS = (1025, 2000, 4096, 10_000)
# the shape of the large-r tensor-core scan's line in the kernels record
LARGE_MMA_HEADLINE = "K1 large bf16 n=20000 slots=32768 d=768 r=1025 B=1"


def large_mma_check(kf, args, r: int, sim: str, prec: str, what: str,
                    integer: bool) -> float:
    """One K1 scan at bf16 or int8 with r > 1024 against plain_pool: int8
    pools bit-equal on any data, bf16 pools bit-equal on mma_sixteenths
    (`integer`) and on floats equal but at summation ties
    (bf16_float_check, each logged; at d = 768, whose dots near 13,000 have
    an f32 ulp of 1e-3, every score held to its f32 error bound in place of
    the fixed tolerance); exactly one K1 launch, on the large-r
    tier's tensor-core scan and its multi-CTA select, and none of the tile
    scan, the tensor-core tier or the yardstick; then each sort and the
    yardstick on the same keys (select_variants_check). Returns the max
    |dv|."""
    counters = (kf.launches, kf.large_launches, kf.large_mma_launches,
                kf.mma_launches, kf.tile_launches, kf.large_select_launches,
                kf.yardstick_launches)
    before = [c.count for c in counters]
    if prec == "bf16" and not integer:
        err = bf16_float_check(kf, args, r, sim, what,
                               bound=args[0].shape[2] >= 512)
    else:
        err = compare_pools(kf, args, r, sim, prec, what, bits=True)
    got = [c.count - b for c, b in zip(counters, before)]
    if got != [1, 1, 1, 0, 0, 1, 0]:
        raise AssertionError(f"{what}: (K1, large-r tier, its tensor-core "
                             f"scan, tensor-core tier, tile scan, select, "
                             f"yardstick) launched {got} times, want "
                             f"[1, 1, 1, 0, 0, 1, 0]")
    select_variants_check(kf, args, r, sim, prec, what)
    return err


def large_mma_kernel_phase(kf, dev, seed: int) -> float:
    """K1's large-r tier at bf16 and int8 (r > 1024, the tensor-core tier's
    dots feeding the large-r select) against plain_pool (large_mma_check):
    clustered floats, one shard of 60,000 128-d docs and one of 20,000
    768-d docs, at B = 1, 9 and 33 x r = 1025, 2000, 4096 and 10,000 in l2
    and cosine (int8 bit-equal, bf16 ids equal but at logged summation
    ties); mma_sixteenths (bf16's f32 sums exact, so bit-equal at both
    precisions) at both widths, B = 1 and 9, r = 1025 and 4096; four shards
    of 12,000 (the last with 5 live docs) at B = 1, 9 and 33; 20,000 copies
    of one mma_sixteenths vector (every score equal) at B = 1 and 9. At
    every (width, B, precision, similarity) the first 1024 slots of the
    r = 1025 pool must be the tensor-core tier's r = 1024 pool bit for bit:
    a doc's score is the same bits in both tiers. Returns the max |dv|."""
    rng = np.random.default_rng(seed + 44)
    err = 0.0
    cases = (
        (1, 60_000, DIM, False, (1, 9, 33), ("l2_norm", "cosine"),
         LARGE_MMA_RS, False),
        (1, 20_000, 768, False, (1, 9, 33), ("l2_norm", "cosine"),
         LARGE_MMA_RS, False),
        (1, 60_000, DIM, True, (1, 9), ("l2_norm",), (1025, 4096), False),
        (1, 20_000, 768, True, (1, 9), ("l2_norm",), (1025, 4096), False),
        (4, 12_000, DIM, False, (1, 9, 33), ("l2_norm",), (1025, 4096),
         False),
        (1, 20_000, DIM, True, (1, 9), ("l2_norm",), (1025, 10_000), True),
    )
    for s, n, d, integer, bs, sims, rs, same in cases:
        data, v, nrm, ok = lists_case(dev, rng, s, n, d, integer,
                                      grid=mma_sixteenths)
        if same:
            data[:] = data[0]
            v[:] = v[0, 0]
            nrm[:] = nrm[0, 0]
        for b in bs:
            queries = data[rng.choice(n, b, replace=False)].copy()
            if not integer:
                queries = queries + 0.01 * rng.standard_normal(
                    queries.shape).astype(np.float32)
            q = torch.from_numpy(queries).to(dev)
            for prec in REDUCED:
                args = reduced_args(kf, v, nrm, ok, q, prec)
                for sim in sims:
                    what = (f"K1 large mma {prec} S={s} n={n} d={d} B={b} "
                            f"{sim} integer={integer}"
                            f"{' one vector' if same else ''}")
                    for r in rs:
                        err = max(err, large_mma_check(
                            kf, args, r, sim, prec, f"{what} r={r}",
                            integer))
                    bv, bi = kf.pool_scan(*args, r=1025, similarity=sim,
                                          score_precision=prec)
                    wv, wi = kf.pool_scan(*args, r=1024, similarity=sim,
                                          score_precision=prec)
                    if not (torch.equal(bi[..., :1024], wi)
                            and torch.equal(bv[..., :1024], wv)):
                        raise AssertionError(f"{what}: the r = 1025 pool's "
                                             f"first 1024 slots are not the "
                                             f"tensor-core tier's r = 1024 "
                                             f"pool")
        log(f"K1 large-r tensor-core scan parity S={s} n={n} d={d} "
            f"integer={integer}{' (one vector)' if same else ''}: "
            f"{'bit-equal' if integer else 'int8 bit-equal, bf16 ids equal'}"
            f" at B = {bs}, r = {rs}, {sims}; r = 1025's first 1024 slots "
            f"the tensor-core tier's pool; both sorts and the yardstick "
            f"equal")
        del v
        torch.cuda.empty_cache()
    return err


def large_mma_timing(kf, dev, seed: int) -> dict:
    """K1's large-r tier at bf16 and int8 at the stacked step's shapes (one
    shard, B = 1, l2; as large_timing: 20,000 768-d docs in 32,768 slots at
    r = 1025, 2000 and 4096, cell A's 200,000 128-d docs in 262,144 slots
    at r = 10,000 and 20,000): each checked first (large_mma_check), then
    timed (time_large; the tier's library call: torch.topk over the
    l2-transformed f32 product of the same bf16 or int8 operands, exact in
    f32, times the int8 scale) beside its bound (pool_bound at the
    operands' width: bf16 2 bytes and int8 1 byte a component, against
    their peaks)."""
    rng = np.random.default_rng(seed + 45)
    out = {}
    for n_docs, slots, d, rs in LARGE_SHAPES:
        data = np.zeros((1, slots, d), np.float32)
        data[0, :n_docs] = clustered(rng, n_docs, d)
        v = torch.from_numpy(data).to(dev)
        nrm = (v.double() ** 2).sum(2).float()
        ok = torch.zeros((1, slots), dtype=torch.bool, device=dev)
        ok[0, :n_docs] = True
        q = v[0, int(rng.integers(n_docs))][None] + 0.01
        for prec in REDUCED:
            args = reduced_args(kf, v, nrm, ok, q, prec)
            v_x, _n, _o, q_x, qsq, scale = args
            for r in rs:
                label = (f"K1 large {prec} n={n_docs} slots={slots} d={d} "
                         f"r={r} B=1")
                large_mma_check(kf, args, r, "l2_norm", prec, label, False)
                plain = functools.partial(kf.plain_pool, *args, r=r,
                                          similarity="l2_norm",
                                          score_precision=prec)

                def library(r=r, v_x=v_x, q_x=q_x, qsq=qsq, scale=scale):
                    dots = (q_x.float() @ v_x[0].float().T) * scale[0]
                    d_sq = torch.clamp(qsq[:, None] - 2.0 * dots + nrm[0][None],
                                       min=0.0)
                    return torch.topk(1.0 / (1.0 + d_sq), r)

                out[label] = time_large(kf, label, args, r, prec, plain,
                                        library,
                                        pool_bound(1, slots, d, 1, r, prec))
        del v
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# the IVF-PQ route in one order whatever the batch: the LUT kernel
# (csrc/adc_lut.cu) and the exact rescore's dots (csrc/knn_rescore.cu)
# --------------------------------------------------------------------------

# (what, nlist, d, m, B): glove-100 and cell C (100-d, m 20, nlist 512),
# and MS-MARCO-class 768-d at m = 96
LUT_SHAPES = (("glove-100 / cell C", 512, ANN_DIM, ANN_M, (1, 8, 32)),
              ("768-d m=96", 512, 768, 96, (1, 8)))


def einsum_lut(queries, coarse, codebooks, probes):
    """The LUT build the kernel replaced (a batched einsum and row sums,
    whose orders the library picks by the shape): the yardstick."""
    m, ks, dsub = codebooks.shape
    resid = queries[:, None, :] - coarse[probes.long()]
    r_sub = resid.reshape(queries.shape[0], probes.shape[1], m, dsub)
    r_dot = torch.einsum("bpms,mks->bpmk", r_sub, codebooks)
    r_sq = (r_sub * r_sub).sum(dim=-1)
    cb_sq = (codebooks * codebooks).sum(dim=-1)
    return r_sq[..., None] - 2.0 * r_dot + cb_sq[None, None]


def einsum_exact_rescore(queries, cand, vectors, norms_sq, valid,
                         similarity: str, k_eff: int):
    """The IVF-PQ rescore before its dots went to the fixed-order kernel
    (a batched einsum and a row sum of |q|^2): the yardstick."""
    from opensearch_tpu_torch.ops.topk import stable_topk

    cand = cand.long()
    safe = torch.clamp(cand, min=0)
    cdots = torch.einsum("bd,brd->br", queries, vectors[safe])
    q_sq = (queries * queries).sum(dim=-1, keepdim=True)
    if similarity == "cosine":
        raw = cdots / torch.clamp(torch.sqrt(q_sq) * torch.sqrt(
            torch.clamp(norms_sq[safe], min=1e-24)), min=1e-12)
        score = (1.0 + raw) / 2.0
    else:
        score = 1.0 / (1.0 + torch.clamp(q_sq - 2.0 * cdots + norms_sq[safe],
                                         min=0.0))
    score = torch.where((cand >= 0) & valid[safe], score, float("-inf"))
    return stable_topk(score, k_eff)


def lut_kernel_phase(dev, seed: int) -> dict:
    """The LUT kernel against its plain version (ops/adc_lut.plain_lut) on
    random coarse centroids and codebooks at glove-100's and cell C's
    shapes (nlist 512, d 100, m 20, ks 256, P = 8) at B = 1, 8 and 32, and
    at 768-d with m = 96 (dsub 8) at B = 1 and 8: the f32 LUTs bit-equal,
    and through adc_scan.build_luts at bf16 and u8 (the downcast and the
    per-query quantization after it) bit-equal to the plain build; each
    batch row bit-equal to its solo call; one launch a call. The rescore's
    dots alone (knn_rescore.rescore_dots) bit-equal to their plain version
    at B = 1 and 8 x R = 64 and 640, d = 100 and 768, -1 ids among them.
    Then the host's probe scores: numpy's product of a batch of 32 rows
    against 32 products of one row each (host_probe_select takes the
    latter), the count of rows whose bits differ logged. Returns
    {"max_abs_err": 0.0, "probe_rows_differ": n}."""
    from opensearch_tpu_torch.ops import adc_lut, adc_scan
    from opensearch_tpu_torch.ops import knn_rescore as kr

    rng = np.random.default_rng(seed + 50)
    for what, nlist, d, m, bs in LUT_SHAPES:
        coarse = torch.from_numpy(rng.standard_normal((nlist, d)).astype(
            np.float32) * 2.0).to(dev)
        cb = torch.from_numpy(rng.standard_normal((m, 256, d // m)).astype(
            np.float32)).to(dev)
        for b in bs:
            q = torch.from_numpy(rng.standard_normal((b, d)).astype(
                np.float32) * 2.0).to(dev)
            probes = torch.from_numpy(np.stack([
                rng.choice(nlist, 8, replace=False) for _ in range(b)])
                .astype(np.int32)).to(dev)
            before = adc_lut.launches.count
            got = adc_lut.lut(q, coarse, cb, probes)
            if adc_lut.launches.count - before != 1:
                raise AssertionError(f"LUT {what} B={b}: not one launch")
            want = adc_lut.plain_lut(q, coarse, cb, probes)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).nonzero()[:3].tolist()
                raise AssertionError(f"LUT {what} B={b}: not bit-equal to "
                                     f"plain_lut (first at {bad})")
            for prec in ("bf16", "int8"):
                k_lut = adc_scan.build_luts(q, coarse, cb, probes,
                                            adc_precision=prec)
                p_lut = adc_scan.build_luts(q, coarse, cb, probes,
                                            adc_precision=prec,
                                            use_kernel=False)
                if not torch.equal(k_lut, p_lut):
                    raise AssertionError(f"LUT {what} B={b} {prec}: not "
                                         f"bit-equal to the plain build")
            for i in range(b):
                solo = adc_lut.lut(q[i:i + 1], coarse, cb, probes[i:i + 1])
                if not torch.equal(got[i:i + 1], solo):
                    raise AssertionError(f"LUT {what} B={b}: row {i} is not "
                                         f"its solo LUT")
        log(f"LUT kernel {what}: bit-equal to plain_lut at B = {bs} (f32, "
            f"and through build_luts at bf16 and u8), each row its solo "
            f"LUT")
    for d in (ANN_DIM, 768):
        v = torch.from_numpy(clustered(rng, 5000, d)).to(dev)[None]
        for b in (1, 8):
            q = torch.from_numpy(rng.standard_normal((b, d)).astype(
                np.float32)).to(dev)
            for r in (64, 640):
                cand = torch.from_numpy(rng.integers(-1, 5000, (1, b, r))
                                        .astype(np.int32)).to(dev)
                got = kr.rescore_dots(q, v, cand)
                want = kr.plain_rescore_dots(q, v, cand)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"rescore dots d={d} B={b} R={r}: "
                                         f"not bit-equal to the plain dots")
    log("rescore dots: bit-equal to plain_rescore_dots at d = 100 and 768, "
        "B = 1 and 8, R = 64 and 640")
    coarse_h = rng.standard_normal((512, ANN_DIM)).astype(np.float32)
    qh = rng.standard_normal((32, ANN_DIM)).astype(np.float32)
    rows = np.stack([coarse_h @ x for x in qh])
    differ = int((~np.all(qh @ coarse_h.T == rows, axis=1)).sum())
    log(f"host probe scores: {differ} of 32 rows of numpy's batched product "
        f"differ in their bits from one product a row (host_probe_select "
        f"takes one a row)")
    return {"max_abs_err": 0.0, "probe_rows_differ": differ}


def lut_timing(dev, seed: int) -> dict:
    """The LUT kernel and the IVF-PQ exact rescore (the fixed-order dots and
    |q|^2 kernels, the reference's transform and the top-k) beside the
    einsum path each replaced, at glove-100's and cell C's shapes (nlist
    512, d 100, m 20, ks 256, P = 8; the rescore: R = 64 candidates, k = 10,
    cosine) at B = 1, 8 and 32: CUDA-event ms, profiler device ms, the
    plain version's ms, and the bound (bytes: the queries, each probe's
    centroid, the codebooks and the LUTs once; operations 2 B P m ks dsub;
    the rescore: each candidate row, its norm and flag, the ids once)."""
    from opensearch_tpu_torch.ops import adc_lut, ivfpq

    rng = np.random.default_rng(seed + 51)
    nlist, d, m, ks, P, R, k = 512, ANN_DIM, ANN_M, 256, 8, 64, 10
    coarse = torch.from_numpy(rng.standard_normal((nlist, d)).astype(
        np.float32)).to(dev)
    cb = torch.from_numpy(rng.standard_normal((m, ks, d // m)).astype(
        np.float32)).to(dev)
    n = ANN_MAIN_DOCS
    vecs = torch.from_numpy(ann_corpus(rng, n, d)).to(dev)
    vecs = vecs / torch.linalg.norm(vecs, dim=1, keepdim=True)
    nrm = (vecs * vecs).sum(1)
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    out = {}
    for b in (1, 8, 32):
        q = torch.from_numpy(rng.standard_normal((b, d)).astype(
            np.float32)).to(dev)
        q = q / torch.linalg.norm(q, dim=1, keepdim=True)
        probes = torch.from_numpy(np.stack([
            rng.choice(nlist, P, replace=False) for _ in range(b)])
            .astype(np.int32)).to(dev)
        cand = torch.from_numpy(rng.integers(0, n, (b, R)).astype(
            np.int32)).to(dev)
        kern = functools.partial(adc_lut.lut, q, coarse, cb, probes)
        plain = functools.partial(adc_lut.plain_lut, q, coarse, cb, probes)
        eins = functools.partial(einsum_lut, q, coarse, cb, probes)
        nbytes = 4 * (b * d + b * P * d + m * ks * (d // m) + b * P * m * ks)
        flops = 2 * b * P * m * ks * (d // m)
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
        ms = time_ms(kern, 50)
        eins_ms = time_ms(eins, 50)
        ms_again = time_ms(kern, 50)
        prof, eprof = device_profile(kern, 10), device_profile(eins, 10)
        out[f"lut B={b}"] = {
            "ms": ms, "ms_again": ms_again, "einsum_ms": eins_ms,
            "plain_ms": time_ms(plain, 10), "library_ms": None,
            "device_ms": prof and prof["device_ms"],
            "einsum_device_ms": eprof and eprof["device_ms"],
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}
        resc = functools.partial(ivfpq.exact_rescore, q, cand, vecs, nrm, ok,
                                 similarity="cosine", k_eff=k,
                                 impl="pallas")
        resc_plain = functools.partial(ivfpq.exact_rescore, q, cand, vecs,
                                       nrm, ok, similarity="cosine",
                                       k_eff=k, impl="xla")
        resc_eins = functools.partial(einsum_exact_rescore, q, cand, vecs,
                                      nrm, ok, "cosine", k)
        nbytes = b * R * (4 * d + 4 + 1 + 4) + 4 * b * d + 8 * b * k
        rms = time_ms(resc, 50)
        reins = time_ms(resc_eins, 50)
        rms_again = time_ms(resc, 50)
        rprof = device_profile(resc, 10)
        reprof = device_profile(resc_eins, 10)
        out[f"rescore B={b}"] = {
            "ms": rms, "ms_again": rms_again, "einsum_ms": reins,
            "plain_ms": time_ms(resc_plain, 10), "library_ms": None,
            "device_ms": rprof and rprof["device_ms"],
            "dots_device_ms": kernel_ms(rprof, "knn_rescore_kernel"),
            "einsum_device_ms": reprof and reprof["device_ms"],
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        log(f"LUT B={b}: {json.dumps(out[f'lut B={b}'])}; ANN rescore B={b}: "
            f"{json.dumps(out[f'rescore B={b}'])}")
    return out


def ann_batch_check(ads, ivfpq, segment, queries: np.ndarray, dev) -> dict:
    """Index C's IVF-PQ segment: 8 queries through the fused pipeline in one
    call (search_index, kernel "pallas": the host probes, one LUT launch,
    one K2 launch, one rescore-dots launch and one |q|^2 launch) against
    each query alone, as stacked_batch_phase holds the stacked step: every
    row's scores and ids its solo call's bits, at fp32, bf16 and u8 ADC."""
    from opensearch_tpu_torch.ops import adc_lut
    from opensearch_tpu_torch.ops import knn_rescore as kr

    _host, dseg = segment
    vf = dseg.vector_fields["v"]
    valid = vf.present & dseg.live
    counters = {"adc_lut": adc_lut.launches, "adc_scan": ads.launches,
                "knn_rescore": kr.launches, "knn_query_sq": kr.sq_launches}
    out = {}
    for prec in ("fp32", "bf16", "int8"):
        def run(qs):
            return ivfpq.search_index(vf.ann, vf.vectors, vf.norms_sq, valid,
                                      qs, k=10, nprobe=8,
                                      similarity="cosine",
                                      adc_precision=prec, kernel="pallas")

        before = {key: c.count for key, c in counters.items()}
        bv, bi = run(queries[:8])
        launches = {key: c.count - before[key] for key, c in counters.items()}
        if set(launches.values()) != {1}:
            raise AssertionError(f"[glove_c] ANN batch {prec}: launches "
                                 f"{launches}, want one each")
        for i in range(8):
            sv, si = run(queries[i:i + 1])
            if not (torch.equal(bv[i:i + 1], sv)
                    and torch.equal(bi[i:i + 1], si)):
                raise AssertionError(f"[glove_c] ANN batch {prec} query {i}: "
                                     f"not its solo search bit for bit")
        out[prec] = {"queries": 8, "launches": launches}
    log(f"[glove_c] ANN batch of 8: every query its solo search bit for bit "
        f"at {sorted(out)}: {out}")
    return out


# --------------------------------------------------------------------------
# the hybrid BM25 + kNN program (ops/fused.hybrid_score_topk) at BASELINE.md
# row 4's width, and batched _msearch kNN through the stacked step
# --------------------------------------------------------------------------

HYBRID_DOCS = 1_000_000
HYBRID_TERMS, HYBRID_PER_TERM, HYBRID_Q_TERMS = 64, 2_000, 8
HYBRID_WINDOW, HYBRID_K, HYBRID_BATCH, HYBRID_BATCHES = 128, 10, 200, 4
HYBRID_SUB, HYBRID_SUB_QUERIES = 50_000, 100
HYBRID_LEX_W, HYBRID_VEC_W = 0.3, 1.0


def hybrid_inputs(rng, n: int, d: int = DIM) -> dict:
    """Row 4's segment (benchmarks/baseline_configs.py row4_hybrid): n
    standard-normal d-dim docs in the next power of two of slots, 64 terms
    of n / 500 postings (tf 1-4, docs uniform), doc lengths 5-79; one term
    set of 8 terms (window 128) for every query."""
    n_pad = 1 << (n - 1).bit_length()
    per_term = max(64, n // 500)
    vectors = np.zeros((n_pad, d), np.float32)
    vectors[:n] = rng.standard_normal((n, d), dtype=np.float32)
    p_pad = 1 << (HYBRID_TERMS * per_term - 1).bit_length()
    docs = rng.integers(0, n, HYBRID_TERMS * per_term).astype(np.int32)
    tfs = rng.integers(1, 5, HYBRID_TERMS * per_term).astype(np.float32)
    postings_docs = np.zeros(p_pad, np.int32)
    postings_tfs = np.zeros(p_pad, np.float32)
    postings_docs[:docs.size] = docs
    postings_tfs[:tfs.size] = tfs
    doc_len = np.zeros(n_pad, np.float32)
    doc_len[:n] = rng.integers(5, 80, n).astype(np.float32)
    term_ids = rng.integers(0, HYBRID_TERMS, HYBRID_Q_TERMS)
    return {"n": n, "n_pad": n_pad, "vectors": vectors,
            "postings_docs": postings_docs, "postings_tfs": postings_tfs,
            "doc_len": doc_len, "avgdl": float(doc_len[:n].mean()),
            "offsets": (term_ids * per_term).astype(np.int32),
            "lengths": np.full(HYBRID_Q_TERMS, min(HYBRID_WINDOW, per_term),
                               np.int32),
            "idfs": rng.uniform(0.5, 3.0, HYBRID_Q_TERMS).astype(np.float32)}


def hybrid_args(inp: dict, dev, queries) -> tuple:
    """hybrid_score_topk's arguments on the card for `inp`."""
    vectors = torch.from_numpy(inp["vectors"]).to(dev)
    return (torch.from_numpy(inp["postings_docs"]).to(dev),
            torch.from_numpy(inp["postings_tfs"]).to(dev),
            torch.from_numpy(inp["doc_len"]).to(dev), vectors,
            (vectors * vectors).sum(1),
            torch.arange(inp["n_pad"], device=dev) < inp["n"],
            torch.from_numpy(inp["offsets"]).to(dev),
            torch.from_numpy(inp["lengths"]).to(dev),
            torch.from_numpy(inp["idfs"]).to(dev),
            torch.tensor(inp["avgdl"], device=dev), queries,
            torch.tensor(HYBRID_LEX_W, device=dev),
            torch.tensor(HYBRID_VEC_W, device=dev))


def hybrid_host_reference(inp: dict, queries: np.ndarray, sub: int):
    """Row 4's fp64 host hybrid over the first `sub` docs: (scores [B, sub]
    f64, the f32 error bound of each score [B, sub]: the dot's f32
    summation bound and |q|^2 - 2 q.v + |v|^2's roundings through l2's
    derivative, and a few ulps of the BM25 sum and the blend)."""
    u = 2.0 ** -24
    sv = inp["vectors"][:sub].astype(np.float64)
    q = queries.astype(np.float64)
    d = sv.shape[1]
    dots = q @ sv.T
    qq, nn = (q ** 2).sum(-1, keepdims=True), (sv ** 2).sum(-1)[None, :]
    d_sq = np.maximum(qq - 2 * dots + nn, 0.0)
    vec = 1.0 / (1.0 + d_sq)
    slack = (d * u / (1 - d * u)) * (np.abs(q) @ np.abs(sv).T)
    vec_err = (2 * slack + 4 * u * (qq + 2 * np.abs(dots) + nn)) * vec ** 2 \
        + 4 * u * vec
    lex = np.zeros(sub)
    k1, b, avgdl = 1.2, 0.75, inp["avgdl"]
    pd, pt, dl = inp["postings_docs"], inp["postings_tfs"], inp["doc_len"]
    for t in range(HYBRID_Q_TERMS):
        lo = int(inp["offsets"][t])
        for p in range(lo, lo + int(inp["lengths"][t])):
            doc, tf = int(pd[p]), float(pt[p])
            if doc < sub:
                lex[doc] += float(inp["idfs"][t]) * tf / (
                    tf + k1 * (1 - b + b * float(dl[doc]) / avgdl))
    host = HYBRID_VEC_W * vec + HYBRID_LEX_W * lex[None, :]
    err = HYBRID_VEC_W * vec_err + HYBRID_LEX_W * (
        (HYBRID_Q_TERMS + 8) * u * lex[None, :]) + 4 * u * np.abs(host)
    return host, err


def f32_tie_gate(label: str, got: np.ndarray, want: np.ndarray,
                 what: str, scores) -> list:
    """Ids `got` [B, k] against `want` [B, k] from `what`: where a rank
    holds another doc, the two docs' f64 scores (scores(i, docs) -> (f64
    scores, f32 error bounds)) must lie within their f32 bounds of each
    other. Each such tie is logged; returns them as (query, rank, got doc,
    wanted doc)."""
    ties = []
    for i in range(got.shape[0]):
        for j in np.nonzero(got[i] != want[i])[0]:
            a, c = int(got[i, j]), int(want[i, j])
            (sa, sc), (ea, ec) = scores(i, [a, c])
            if abs(sa - sc) > ea + ec:
                raise AssertionError(
                    f"[{label}] query {i} rank {j}: doc {a} (f64 {sa!r}) "
                    f"where {what} has {c} (f64 {sc!r}), further apart "
                    f"than f32 moves them")
            ties.append((i, int(j), a, c))
            log(f"[{label}] query {i} rank {j}: doc {a} against {what}'s "
                f"{c}, f64 scores {sa!r} and {sc!r} within their f32 bound")
    return ties


def hybrid_main_phase(dev, seed: int) -> dict:
    """The hybrid BM25 + exact-kNN program (ops/fused.jit_hybrid: the
    lexical gather and ordered segment sum, one fp32 [B, d] x [d, n]
    product, the l2 transform and blend, blockwise_topk) at BASELINE.md
    row 4's full width, all made from --seed: 1,000,000 128-d docs in 2^20
    slots, 64 terms x 2,000 postings (tf 1-4), doc lengths 5-79, 8 query
    terms, window 128, k = 10, lexical weight 0.3, vector weight 1.0, l2;
    4 batches of 200 queries. Gates: (1) on a 50,000-doc subsample and 100
    queries, as row 4 checks, the ids equal the fp64 host hybrid's but at
    pairs whose fp64 scores lie within the f32 error bound of each other
    (each logged); (2) a batch run twice gives the same bits; (3)
    graft_entry.entry() on the card matches the plain CPU run of the same
    function (rtol 1e-5 / atol 1e-6, ids equal where no two scores are
    that close: tests/test_torch_hybrid.py's tolerance). Reports the p50
    of a batch of 200 (CUDA events) and the QPS, the device split by
    stage and kernel name, the bound and the [B, n_pad] score matrix's
    bytes."""
    from opensearch_tpu_torch import graft_entry
    from opensearch_tpu_torch.ops import fused, topk

    rng = np.random.default_rng(seed + 60)
    t0 = time.perf_counter()
    inp = hybrid_inputs(rng, HYBRID_DOCS)
    queries = rng.standard_normal((HYBRID_BATCH * HYBRID_BATCHES, DIM),
                                  dtype=np.float32)
    qdev = torch.from_numpy(queries).to(dev)
    fn = fused.jit_hybrid(HYBRID_K, HYBRID_WINDOW, "l2_norm")
    args = hybrid_args(inp, dev, qdev[:HYBRID_BATCH])
    log(f"[hybrid] {HYBRID_DOCS} docs in {inp['n_pad']} slots, "
        f"{inp['postings_docs'].size} postings: made and uploaded in "
        f"{time.perf_counter() - t0:.1f} s")

    def batch(i: int):
        return fn(*args[:10], qdev[i * HYBRID_BATCH:(i + 1) * HYBRID_BATCH],
                  *args[11:])

    # (2) the same batch twice: the same bits
    v1, i1 = batch(0)
    v2, i2 = batch(0)
    torch.cuda.synchronize()
    if not (torch.equal(v1, v2) and torch.equal(i1, i2)):
        raise AssertionError("[hybrid] a batch run twice gave other bits")
    # timing: CUDA events around each batch of 200, three rounds of the
    # four batches after the warm-up above
    batch_ms = []
    for _round in range(3):
        for i in range(HYBRID_BATCHES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            batch(i)
            end.record()
            torch.cuda.synchronize()
            batch_ms.append(start.elapsed_time(end))
    p50 = float(np.percentile(batch_ms, 50))
    whole = device_profile(lambda: batch(1), 5)
    lex_prof = device_profile(lambda: fused.lexical_scores(
        *args[:3], *args[6:10], n_pad=inp["n_pad"], window=HYBRID_WINDOW), 5)
    q200 = qdev[:HYBRID_BATCH]
    vt = args[3]
    prod_prof = device_profile(lambda: q200 @ vt.T, 5)
    vec_prof = device_profile(lambda: fused._vector_scores(
        q200, vt, args[4], "l2_norm"), 5)
    scores = fused._vector_scores(q200, vt, args[4], "l2_norm")
    topk_prof = device_profile(lambda: topk.blockwise_topk(scores, HYBRID_K),
                               5)
    del scores
    n_pad = inp["n_pad"]
    t_bytes = n_pad * DIM * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * HYBRID_BATCH * n_pad * DIM / FP32_FLOP_PER_S * 1e3
    out = {"batch_ms": batch_ms, "p50_batch_ms": p50,
           "qps": HYBRID_BATCH * len(batch_ms) / (sum(batch_ms) / 1e3),
           "device_ms": whole and whole["device_ms"],
           "device_kernels": whole and whole["top"],
           "lexical_device_ms": lex_prof and lex_prof["device_ms"],
           "lexical_kernels": lex_prof and lex_prof["top"],
           "product_device_ms": prod_prof and prod_prof["device_ms"],
           "vector_scores_device_ms": vec_prof and vec_prof["device_ms"],
           "transform_device_ms": (vec_prof and prod_prof and
                                   vec_prof["device_ms"]
                                   - prod_prof["device_ms"]),
           "topk_device_ms": topk_prof and topk_prof["device_ms"],
           "topk_kernels": topk_prof and topk_prof["top"],
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
           "score_matrix_bytes": HYBRID_BATCH * n_pad * 4}
    log(f"[hybrid] batch of {HYBRID_BATCH}: p50 {p50:.4f} ms, QPS "
        f"{out['qps']:.1f}; {json.dumps(out)}")
    del args, qdev
    torch.cuda.empty_cache()

    # (1) the subsample against the fp64 host hybrid
    sub = HYBRID_SUB
    sub_pad = 1 << (sub - 1).bit_length()
    sinp = dict(inp, n=sub, n_pad=sub_pad,
                vectors=np.pad(inp["vectors"][:sub],
                               ((0, sub_pad - sub), (0, 0))),
                doc_len=np.pad(inp["doc_len"][:sub], (0, sub_pad - sub)),
                postings_docs=np.where(inp["postings_docs"] < sub,
                                       inp["postings_docs"], 0),
                postings_tfs=np.where(inp["postings_docs"] < sub,
                                      inp["postings_tfs"], 0.0).astype(
                                          np.float32))
    q100 = queries[:HYBRID_SUB_QUERIES]
    gv, gi = fn(*hybrid_args(sinp, dev, torch.from_numpy(q100).to(dev)))
    gi = gi.cpu().numpy()
    host, err = hybrid_host_reference(inp, q100, sub)
    exact = np.stack([np.lexsort((np.arange(sub), -host[i]))[:HYBRID_K]
                      for i in range(len(q100))])
    ties = f32_tie_gate("hybrid", gi, exact, "the fp64 host hybrid",
                        lambda i, docs: (host[i, docs], err[i, docs]))
    recall = float(np.mean([len(set(gi[i]) & set(exact[i])) / HYBRID_K
                            for i in range(len(q100))]))
    out.update(subsample_recall=recall, subsample_ties=len(ties))
    log(f"[hybrid] {sub}-doc subsample, {len(q100)} queries: ids the fp64 "
        f"host hybrid's but at {len(ties)} logged f32 ties; recall@10 "
        f"{recall:.4f}")

    # (3) graft_entry on the card against its plain CPU run
    efn, eargs = graft_entry.entry()
    if eargs[3].device.type != "cuda":
        raise AssertionError("graft_entry.entry() did not place its "
                             "arguments on the card")
    ev, ei = efn(*eargs)
    cfn, cargs = graft_entry.entry(device="cpu")
    cv, ci = cfn(*cargs)
    ev, ei = ev.cpu().numpy(), ei.cpu().numpy()
    cv, ci = cv.numpy(), ci.numpy()
    if not np.allclose(ev, cv, rtol=1e-5, atol=1e-6):
        raise AssertionError("[hybrid] graft_entry on the card: scores "
                             "beyond rtol 1e-5 / atol 1e-6 of the CPU run")
    tol = 1e-6 + 1e-5 * np.abs(cv)
    close = np.zeros_like(ev, bool)
    gap = np.abs(np.diff(cv, axis=1)) <= tol[:, 1:]
    close[:, 1:] |= gap
    close[:, :-1] |= gap
    if not np.array_equal(ei[~close], ci[~close]):
        raise AssertionError("[hybrid] graft_entry on the card: ids differ "
                             "from the CPU run")
    out["graft_entry_max_abs_err"] = float(np.abs(ev - cv).max())
    log(f"[hybrid] graft_entry.entry() on the card matches its CPU run "
        f"(max |dv| {out['graft_entry_max_abs_err']:.3g})")
    return out


# --------------------------------------------------------------------------
# the mesh: graft_entry.dryrun_multichip and the tensor-parallel hybrid
# program (parallel/distributed.build_distributed_search) at row 4's width
# --------------------------------------------------------------------------

MESH_SHARDS = 4
MESH_RUNS = tuple((n_model, ring) for n_model in (1, 2)
                  for ring in (False, True))


def hybrid_pair_scores(inp: dict, query: np.ndarray, docs) -> tuple:
    """Row 4's fp64 host hybrid score of one query against `docs`, and the
    f32 error bound of each (hybrid_host_reference's bound, for any
    summation order of the dot)."""
    u = 2.0 ** -24
    docs = np.asarray(docs)
    sv = inp["vectors"][docs].astype(np.float64)
    q = query.astype(np.float64)
    d = sv.shape[1]
    dots = sv @ q
    qq, nn = float(q @ q), (sv ** 2).sum(-1)
    vec = 1.0 / (1.0 + np.maximum(qq - 2 * dots + nn, 0.0))
    slack = (d * u / (1 - d * u)) * (np.abs(sv) @ np.abs(q))
    vec_err = (2 * slack + 4 * u * (qq + 2 * np.abs(dots) + nn)) * vec ** 2 \
        + 4 * u * vec
    k1, b, avgdl = 1.2, 0.75, inp["avgdl"]
    lex = np.zeros(len(docs))
    for t in range(HYBRID_Q_TERMS):
        lo = int(inp["offsets"][t])
        for p in range(lo, lo + int(inp["lengths"][t])):
            tf = float(inp["postings_tfs"][p])
            for j in np.nonzero(docs == inp["postings_docs"][p])[0]:
                dl = float(inp["doc_len"][docs[j]])
                lex[j] += float(inp["idfs"][t]) * tf / (
                    tf + k1 * (1 - b + b * dl / avgdl))
    host = HYBRID_VEC_W * vec + HYBRID_LEX_W * lex
    err = HYBRID_VEC_W * vec_err + HYBRID_LEX_W * (
        (HYBRID_Q_TERMS + 8) * u * lex) + 4 * u * np.abs(host)
    return host, err


def mesh_shard_postings(inp: dict, s: int, n_shard: int) -> tuple:
    """Shard s's postings: of each query term's window (its first
    `lengths[t]` postings), those whose doc falls in the shard's slots, in
    their order, with shard-local doc ids; and the shard's offsets and
    lengths. Returns (docs, tfs, offsets, lengths)."""
    docs, tfs, offsets, lengths = [], [], [], []
    pos = 0
    for t in range(HYBRID_Q_TERMS):
        lo = int(inp["offsets"][t])
        win = slice(lo, lo + int(inp["lengths"][t]))
        wd, wt = inp["postings_docs"][win], inp["postings_tfs"][win]
        mine = (wd >= s * n_shard) & (wd < (s + 1) * n_shard)
        docs.append(wd[mine] - s * n_shard)
        tfs.append(wt[mine])
        offsets.append(pos)
        lengths.append(int(mine.sum()))
        pos += int(mine.sum())
    return (np.concatenate(docs).astype(np.int32),
            np.concatenate(tfs).astype(np.float32),
            np.asarray(offsets, np.int32), np.asarray(lengths, np.int32))


def mesh_segments(inp: dict, vectors, norms, valid, dev):
    """The tensor-parallel program's segments and per-shard term rows for
    `inp` split into MESH_SHARDS data shards: the vectors, norms and valid
    flags are views of the one-shard tensors; each shard's postings are
    its slice of the query terms' windows; every shard gets the one-shard
    IDFs and avgdl, so every doc's BM25 contributions add in the one-shard
    order."""
    from opensearch_tpu_torch.parallel.distributed import ShardedSegments

    s_n = MESH_SHARDS
    n_shard = inp["n_pad"] // s_n
    parts = [mesh_shard_postings(inp, s, n_shard) for s in range(s_n)]
    p_pad = max(1, max(len(p[0]) for p in parts))
    pdocs = np.zeros((s_n, p_pad), np.int32)
    ptfs = np.zeros((s_n, p_pad), np.float32)
    for s, (d_s, t_s, _o, _l) in enumerate(parts):
        pdocs[s, :len(d_s)] = d_s
        ptfs[s, :len(t_s)] = t_s
    segs = ShardedSegments(
        vectors=vectors.view(s_n, n_shard, vectors.shape[1]),
        norms_sq=norms.view(s_n, n_shard),
        valid=valid.view(s_n, n_shard),
        postings_docs=torch.from_numpy(pdocs).to(dev),
        postings_tfs=torch.from_numpy(ptfs).to(dev),
        doc_len=torch.from_numpy(inp["doc_len"]).to(dev).view(s_n, n_shard))
    rows = {"offsets": np.stack([p[2] for p in parts]),
            "lengths": np.stack([p[3] for p in parts])}
    return segs, rows


def mesh_query_args(inp: dict, rows: dict, queries, dev):
    from opensearch_tpu_torch.parallel.distributed import QueryArgs

    s_n = MESH_SHARDS
    return QueryArgs(
        query_vectors=queries,
        term_offsets=torch.from_numpy(rows["offsets"]).to(dev),
        term_lengths=torch.from_numpy(rows["lengths"]).to(dev),
        term_idfs=torch.from_numpy(np.tile(inp["idfs"], (s_n, 1))).to(dev),
        avgdl=torch.full((s_n,), np.float32(inp["avgdl"]), device=dev),
        lexical_weight=torch.tensor(HYBRID_LEX_W, device=dev),
        vector_weight=torch.tensor(HYBRID_VEC_W, device=dev))


def ring_tie_check(label: str, vals, ids, want_vals, want_ids) -> int:
    """The ring's result against another merge's: the same values bit for
    bit, so a rank that holds another doc holds one of equal score (the
    ring's tie order is slot 0's: shard 0, then S - 1, S - 2, ...). Returns
    the number of such ranks, each logged."""
    if not torch.equal(vals, want_vals):
        raise AssertionError(f"[{label}] the ring's values are not the "
                             f"other merge's bits")
    differ = (ids != want_ids).nonzero().tolist()
    for i, j in differ:
        log(f"[{label}] query {i} rank {j}: the ring's doc "
            f"{int(ids[i, j])} against {int(want_ids[i, j])}, both "
            f"scoring {float(vals[i, j])!r} (the ring's tie order)")
    return len(differ)


def mesh_stage_profiles(segs, q, ring: bool) -> dict:
    """The profiler's device ms of one batch by stage over segments laid
    out on the mesh (shard_arrays_to_mesh): the partial products (each
    slice's product, their rank-order sum and |q|^2), the score
    transforms, the lexical sums, the per-shard blend and top-k, and the
    merge."""
    from opensearch_tpu_torch.parallel import distributed as tp

    shards = range(len(segs.vectors))

    def partials():
        return [tp._partial_sums(q.query_vectors, segs.vectors[s],
                                 segs.norms_sq[s].device) for s in shards]

    dots = partials()
    vecs = [tp._vector_scores(d_s, qsq, segs.norms_sq[s], "l2_norm")
            for s, (d_s, qsq) in enumerate(dots)]
    del dots
    lexs = [tp._shard_lexical(segs, q, s, window=HYBRID_WINDOW)
            for s in shards]

    def topk():
        out = []
        for s in shards:
            sc = q.vector_weight * vecs[s] + q.lexical_weight * lexs[s][None]
            sc = torch.where(segs.valid[s][None], sc, float("-inf"))
            out.append(tp.blockwise_topk(sc, HYBRID_K))
        return out

    n_pad = segs.norms_sq[0].shape[-1]
    pools = [(v, i + s * n_pad) for s, (v, i) in enumerate(topk())]
    tv = torch.stack([v for v, _i in pools])
    ti = torch.stack([i for _v, i in pools])
    profs = {
        "partial_products": device_profile(partials, 3),
        "transforms": None,
        "lexical": device_profile(lambda: [
            tp._shard_lexical(segs, q, s, window=HYBRID_WINDOW)
            for s in shards], 3),
        "per_shard_topk": device_profile(topk, 3),
        "merge": device_profile(
            (lambda: tp._ring_merge(pools, HYBRID_K)) if ring else
            (lambda: tp._allgather_merge(tv, ti, HYBRID_K)), 3),
    }
    del vecs
    dots = partials()
    profs["transforms"] = device_profile(lambda: [
        tp._vector_scores(d_s, qsq, segs.norms_sq[s], "l2_norm")
        for s, (d_s, qsq) in enumerate(dots)], 3)
    return {stage: prof and prof["device_ms"]
            for stage, prof in profs.items()}


def mesh_phase(kf, dev, seed: int, n_docs: int = HYBRID_DOCS) -> dict:
    """The mesh (``--phases mesh``; after main by default):

    1. graft_entry.dryrun_multichip(8) on the card's slot form (serving
       devices [cuda:0] * 8): its 4-shard kNN _search must take the
       stacked serving step (distributed_searches up by one, which the dry
       run gates) over 4 slots and launch K1 once a slot (its counter set
       to 0 just before), then the tensor-parallel program on the
       reference's tiny mesh of 4 x 2 slots.
    2. The tensor-parallel hybrid program at BASELINE.md row 4's width:
       hybrid_main_phase's segment (hybrid_inputs, --seed + 60: 1,000,000
       128-d docs in 2^20 slots, 8 query terms of 2,000 postings, window
       128, k = 10, l2) split into 4 data shards of 262,144 slots (views of
       the one-shard tensors; each shard's postings the slice of each
       query term's window that falls in it, in order; every shard the
       one-shard IDFs and avgdl), laid out slot by slot on a mesh of 4 x
       n_model slots, every slot the card (shard_arrays_to_mesh: the
       layout, copies and slot ring a mesh over several cards runs), 4
       batches of 200 queries, run at n_model 1 and 2, each with the
       all-gather and the ring. Gates: each run's
       ids, mapped back to docs, are hybrid_score_topk's over the one-shard
       tensors but at logged f32 ties (f32_tie_gate, the fp64 host hybrid
       of the two docs); the ring gives the all-gather's values bit for bit
       and its ids but at equal scores (logged: the ring's tie order); each
       run gives the same bits twice; on a copy of the inputs in eighths
       (every dot exact in any order) every run's values are
       hybrid_score_topk's bit for bit, the all-gather's ids too, the
       ring's but at logged equal scores. Reports, per run and beside
       hybrid_score_topk: the CUDA-event ms of a batch of 200 (median of
       3 rounds x 4 batches), the profiler's device ms by stage and
       torch.cuda.max_memory_allocated over a batch."""
    from opensearch_tpu_torch import graft_entry
    from opensearch_tpu_torch.ops import fused
    from opensearch_tpu_torch.parallel import distributed as tp
    from opensearch_tpu_torch.parallel.mesh import build_mesh

    from opensearch_tpu_torch import backend

    out: dict = {}
    # (1) the dry run, on its slot form: eight serving devices, every one
    # the card, so the 4-shard search has four slots and the program's
    # 4 x 2 mesh eight
    prev = backend.set_serving_devices([dev] * 8)
    try:
        kf.launches.reset()
        graft_entry.dryrun_multichip(8)
    finally:
        backend.set_serving_devices(prev)
    out["dryrun_k1_launches"] = kf.launches.count
    if kf.launches.count != 4:
        raise AssertionError(f"dryrun_multichip launched K1 "
                             f"{kf.launches.count} times, not once on "
                             f"each of its 4 slots")
    log(f"[mesh] dryrun_multichip(8) over 8 slots on {dev}: both OK "
        f"lines, one K1 launch a slot (4)")

    # (2) the tensor-parallel program at row 4's width
    rng = np.random.default_rng(seed + 60)
    t0 = time.perf_counter()
    inp = hybrid_inputs(rng, n_docs)
    queries = rng.standard_normal((HYBRID_BATCH * HYBRID_BATCHES, DIM),
                                  dtype=np.float32)
    qdev = torch.from_numpy(queries).to(dev)
    args = list(hybrid_args(inp, dev, qdev[:HYBRID_BATCH]))
    segs, rows = mesh_segments(inp, args[3], args[4], args[5], dev)
    n_shard = inp["n_pad"] // MESH_SHARDS
    log(f"[mesh] {n_docs} docs in {MESH_SHARDS} shards of {n_shard} slots, "
        f"shard postings {rows['lengths'].sum(1).tolist()} (of "
        f"{int(inp['lengths'].sum())} in the windows): made in "
        f"{time.perf_counter() - t0:.1f} s")
    hybrid = fused.jit_hybrid(HYBRID_K, HYBRID_WINDOW, "l2_norm")

    def batches(q_all):
        return [q_all[i * HYBRID_BATCH:(i + 1) * HYBRID_BATCH]
                for i in range(HYBRID_BATCHES)]

    def one_shard(qb):
        return hybrid(*args[:10], qb, *args[11:])

    # the query rows are made once; a batch swaps its query vectors in
    base_q = mesh_query_args(inp, rows, qdev[:HYBRID_BATCH], dev)
    # each n_model's mesh of slots on the card, and the segments laid out
    # on it slot by slot (n_model 1: views of the one-shard tensors; 2:
    # each shard's two column slices copied)
    meshes = {n_model: build_mesh(MESH_SHARDS, n_model,
                                  devices=[dev] * (MESH_SHARDS * n_model))
              for n_model in dict.fromkeys(n for n, _ring in MESH_RUNS)}

    def lay_out() -> dict:
        return {n_model: tp.shard_arrays_to_mesh(mesh, segs)
                for n_model, mesh in meshes.items()}

    laid = lay_out()
    programs = {
        (n_model, ring): tp.build_distributed_search(
            meshes[n_model], k=HYBRID_K, window=HYBRID_WINDOW,
            similarity="l2_norm", ring=ring)
        for n_model, ring in MESH_RUNS}

    def run(key, qb):
        return programs[key](laid[key[0]],
                             base_q._replace(query_vectors=qb))

    def measure(fn) -> dict:
        for qb in batches(qdev):
            fn(qb)
        ms = []
        for _round in range(3):
            for qb in batches(qdev):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(qb)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(qdev[:HYBRID_BATCH])
        torch.cuda.synchronize()
        return {"p50_batch_ms": float(np.median(ms)), "batch_ms": ms,
                "qps": HYBRID_BATCH * len(ms) / (sum(ms) / 1e3),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "memory_allocated_before": base}

    def check_runs(label: str, exact: bool) -> dict:
        res = {}
        for b, qb in enumerate(batches(qdev)):
            wv, wi = one_shard(qb)
            ag = {}
            for key in MESH_RUNS:
                n_model, ring = key
                name = f"{label} n_model={n_model} " + (
                    "ring" if ring else "all-gather")
                v1, i1 = run(key, qb)
                v2, i2 = run(key, qb)
                if not (torch.equal(v1, v2) and torch.equal(i1, i2)):
                    raise AssertionError(f"[mesh] {name}: a batch run twice "
                                         f"gave other bits")
                cell = res.setdefault(name, {"f32_ties": 0,
                                             "ring_ties": 0})
                if not ring:
                    ag[n_model] = (v1, i1)
                else:
                    cell["ring_ties"] += ring_tie_check(
                        f"mesh {name} batch {b}", v1, i1, *ag[n_model])
                if exact:
                    if not torch.equal(v1, wv):
                        raise AssertionError(
                            f"[mesh] {name} batch {b}: values are not "
                            f"hybrid_score_topk's bits on eighths")
                    if not ring and not torch.equal(i1, wi):
                        raise AssertionError(
                            f"[mesh] {name} batch {b}: ids are not "
                            f"hybrid_score_topk's on eighths")
                    if ring:
                        cell["ring_ties"] += ring_tie_check(
                            f"mesh {name} batch {b} vs one shard", v1, i1,
                            wv, wi)
                else:
                    qh = queries[b * HYBRID_BATCH:(b + 1) * HYBRID_BATCH]
                    cell["f32_ties"] += len(f32_tie_gate(
                        f"mesh {name} batch {b}", i1.cpu().numpy(),
                        wi.cpu().numpy(), "hybrid_score_topk",
                        lambda i, docs, qh=qh: hybrid_pair_scores(
                            inp, qh[i], docs)))
        return res

    out["floats"] = check_runs("floats", exact=False)
    log(f"[mesh] floats: every run hybrid_score_topk's ids but at logged "
        f"f32 ties, the ring the all-gather's bits but at logged ties, a "
        f"batch twice the same bits: {json.dumps(out['floats'])}")
    runs = {"hybrid_score_topk": measure(one_shard)}
    for key in MESH_RUNS:
        n_model, ring = key
        name = f"n_model={n_model} " + ("ring" if ring else "all-gather")
        runs[name] = measure(lambda qb, key=key: run(key, qb))
        runs[name]["device_ms_by_stage"] = mesh_stage_profiles(
            laid[n_model], base_q, ring)
    whole = device_profile(lambda: one_shard(qdev[:HYBRID_BATCH]), 3)
    runs["hybrid_score_topk"]["device_ms"] = whole and whole["device_ms"]
    out["runs"] = runs
    for name, r in runs.items():
        log(f"[mesh] {name}: batch of {HYBRID_BATCH} p50 "
            f"{r['p50_batch_ms']:.4f} ms, QPS {r['qps']:.1f}, peak "
            f"{r['max_memory_allocated'] / 2**30:.3f} GiB (from "
            f"{r['memory_allocated_before'] / 2**30:.3f}); "
            f"{json.dumps({k: v for k, v in r.items() if k != 'batch_ms'})}")

    # the same inputs in eighths: every dot exact in any order
    vectors = args[3]
    vectors.mul_(8.0).round_().div_(8.0)
    args[4] = (vectors * vectors).sum(1)
    segs = segs._replace(norms_sq=args[4].view(MESH_SHARDS, n_shard))
    laid = lay_out()
    qdev = torch.round(qdev * 8.0) / 8.0
    base_q = base_q._replace(query_vectors=qdev[:HYBRID_BATCH])
    out["eighths"] = check_runs("eighths", exact=True)
    log(f"[mesh] eighths: every run hybrid_score_topk's values bit for bit "
        f"and the all-gather's ids too, the ring's but at logged equal "
        f"scores: {json.dumps(out['eighths'])}")
    del args, segs, laid, qdev, vectors, base_q
    torch.cuda.empty_cache()
    return out


# the devices phase: cell A's vectors (SIFT-1M's width) in 4 shards, over
# one slot, four slots on one card and, where there are several, every
# card. 100,000 docs: depth cut from cell A's 200,000 (and SIFT-1M's 1M)
# by the phase's 60 s, a bulk of 200,000 taking 56-82 s of host ingest
DEVICES_DOCS = 100_000
DEVICES_SHARDS = 4
DEVICES_TRAFFIC = (("k10", 10, 64), ("k100", 100, 16), ("filtered", 10, 16))
DEVICES_MSEARCH = 32
# the caching allocator's block: a tensor's memory_allocated() rounds up
ALLOC_BLOCK = 512


def devices_phase(kf, dev, seed: int, n_docs: int = DEVICES_DOCS) -> dict:
    """The shard mesh over device slots (``--phases devices``; after mesh
    by default, on a TorchNode of its own): cell A's generator (clustered,
    128-d, l2, the filtering specs' color and taste) makes n_docs docs,
    bulked into a 4-shard index. Then the same traffic in each form of
    the node's serving devices (backend.set_serving_devices): (1) one slot
    ([cuda:0]: one K1 launch a search, the yardstick), (2) four slots on
    cuda:0, (3) where torch.cuda.device_count() >= 2, every card (the
    shards over the largest divisor of 4 no greater than the cards). The
    traffic: 64 kNN _search at k = 10, 16 at k = 100, 16 at k = 10
    filtered by a color term, one _msearch of 32 k = 10 bodies. Gates:
    form 1's k = 10 hits are the brute force's (the plain version on the
    card, docs in id order); every form's hits, scores and totals are form
    1's bit for bit; each search makes one K1 launch a slot (counted from
    0 before it) and the _msearch one a slot in all; distributed_searches
    rises by one a search and by one for the _msearch, filtered by 16;
    the bundle holds one ledger allocation a slot, labelled with its
    slot's card, their bytes summing to form 1's; each card's
    memory_allocated() grows by its slots' slabs (up to the allocator's
    512-byte blocks); after the index is deleted and the node closed,
    every card's memory_allocated() is back at its start. Reports per
    form, beside the card's name and power limit: the k = 10 p50 and QPS
    on the host clock, the profiler's device ms of each slot's K1 scan
    and of the whole step (the gather and merge its rest), and the
    phase's seconds. On one card it logs that form 3 did not run."""
    from opensearch_tpu_torch import backend
    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.ops import knn_rescore as kr
    from opensearch_tpu_torch.search import distributed_serving
    from opensearch_tpu_torch.telemetry import roofline
    from opensearch_tpu_torch.telemetry.device_ledger import (
        KIND_MESH_BUNDLE,
        default_ledger,
    )

    t_phase = time.perf_counter()
    name = "vec-devices"
    rng = np.random.default_rng(seed + 80)
    data = clustered(rng, n_docs, DIM)
    attrs = attributes(rng, n_docs)
    n_q = sum(n for _key, _k, n in DEVICES_TRAFFIC) + DEVICES_MSEARCH
    queries = (data[rng.choice(n_docs, n_q, replace=False)]
               + 0.05 * rng.standard_normal((n_q, DIM)).astype(np.float32))
    color = COLORS[0]
    bodies = {}
    at = 0
    for key, k, n in DEVICES_TRAFFIC:
        knn = {"vector": None, "k": k}
        if key == "filtered":
            knn["filter"] = {"term": {"color": color}}
        bodies[key] = [{"query": {"knn": {"v": {**knn, "vector":
                                                qv.tolist()}}}, "size": k}
                       for qv in queries[at:at + n]]
        at += n
    msearch = [({"index": name}, {"query": {"knn": {"v": {
        "vector": qv.tolist(), "k": 10}}}, "size": 10})
        for qv in queries[at:at + DEVICES_MSEARCH]]
    # the brute force of the k = 10 queries, before the memory reading
    v = torch.from_numpy(data)[None].to(dev)
    nrm = torch.from_numpy((data.astype(np.float64) ** 2).sum(1).astype(
        np.float32))[None].to(dev)
    ok = torch.ones((1, n_docs), dtype=torch.bool, device=dev)
    q = torch.from_numpy(queries[:64]).to(dev)
    _tv, ti = kf.plain_pool(v, nrm, ok, q, kr.plain_query_sq(q),
                            torch.ones(1, device=dev), r=10,
                            similarity="l2_norm", score_precision="fp32")
    truth = [[str(int(i)) for i in row] for row in ti[0].cpu()]
    del v, nrm, ok, q, _tv, ti
    n_cards = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    forms = {"one slot": [dev], "four slots on cuda:0": [dev] * 4}
    if n_cards >= 2:
        forms["every card"] = cards
    else:
        log("[devices] 1 card: form 3 not run (torch.cuda.device_count() "
            "is 1); forms 1 and 2 gate")
    # what the phase may make once per process goes before the reading
    roofline.ensure_peaks(dev)
    gc.collect()
    torch.cuda.synchronize()
    mem0 = [torch.cuda.memory_allocated(c) for c in cards]

    def hits(resp) -> tuple:
        return (resp["hits"]["total"]["value"],
                [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]])

    prev = backend.set_serving_devices(None)
    out: dict = {"docs": n_docs, "shards": DEVICES_SHARDS,
                 "card": torch.cuda.get_device_name(0), "forms": {}}
    answers: dict = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            node = TorchNode(tmp, device="cuda")
            try:
                t0 = time.perf_counter()
                _bulk_index(node, name, data, DEVICES_SHARDS, attrs)
                out["ingest_s"] = time.perf_counter() - t0
                log(f"[devices] {n_docs} docs in {DEVICES_SHARDS} shards: "
                    f"bulk + refresh {out['ingest_s']:.1f} s")
                for form, devices in forms.items():
                    out["forms"][form] = devices_form(
                        kf, node, name, form, devices, bodies, msearch,
                        answers, hits, truth if form == "one slot" else None,
                        distributed_serving, default_ledger,
                        KIND_MESH_BUNDLE, backend)
                node.delete_index(name)
            finally:
                node.close()
    finally:
        backend.set_serving_devices(prev)
        distributed_serving.clear_caches()
    torch.cuda.synchronize()
    mem1 = [torch.cuda.memory_allocated(c) for c in cards]
    if mem1 != mem0:
        raise AssertionError(f"[devices] after the index was deleted, "
                             f"memory_allocated() by card is {mem1}, not "
                             f"{mem0}")
    out["memory_allocated_after"] = mem1
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[devices] the index deleted: memory_allocated() back at its "
        f"start on every card ({mem1}); phase {out['wall_s']:.1f} s")
    return out


def devices_form(kf, node, name: str, form: str, devices: list,
                 bodies: dict, msearch: list, answers: dict, hits, truth,
                 distributed_serving, ledger, kind: str, backend) -> dict:
    """One form of devices_phase: the serving devices set to `devices`,
    the index's bundle dropped, then the traffic and its gates. The first
    form's answers are the others' yardstick (`answers`)."""
    backend.set_serving_devices(devices)
    distributed_serving.registry.invalidate_index(name)
    slots = distributed_serving._largest_divisor_at_most(
        DEVICES_SHARDS, len(devices))
    cards = sorted({d.index for d in devices[:slots]})
    torch.cuda.synchronize()
    before = {c: torch.cuda.memory_allocated(c) for c in cards}
    res: dict = {"slots": slots, "cards": [f"cuda:{c}" for c in cards],
                 "launches": {}}
    got: dict = {}
    lat: list = []
    stats = distributed_serving.stats
    filtered0 = stats["filtered"]
    for key, bods in bodies.items():
        got[key] = []
        launches = 0
        for body in bods:
            kf.launches.reset()
            n0 = stats["distributed_searches"]
            t0 = time.perf_counter()
            resp = node.search(name, body)
            if key == "k10":
                lat.append(time.perf_counter() - t0)
            if kf.launches.count != slots or \
                    stats["distributed_searches"] != n0 + 1:
                raise AssertionError(
                    f"[devices] {form} {key}: a search launched K1 "
                    f"{kf.launches.count} times (want {slots}, one a slot) "
                    f"and moved distributed_searches by "
                    f"{stats['distributed_searches'] - n0} (want 1)")
            launches += kf.launches.count
            got[key].append(hits(resp))
        res["launches"][key] = launches
        if key == "k10" and truth is not None:
            ids = [[i for i, _s in h] for _t, h in got[key]]
            if ids != truth:
                bad = next(i for i, (a, b) in enumerate(zip(ids, truth))
                           if a != b)
                raise AssertionError(f"[devices] {form} k=10 query {bad}: "
                                     f"{ids[bad]} != brute force "
                                     f"{truth[bad]}")
    if stats["filtered"] - filtered0 != len(bodies["filtered"]):
        raise AssertionError(f"[devices] {form}: filtered rose by "
                             f"{stats['filtered'] - filtered0}, want "
                             f"{len(bodies['filtered'])}")
    kf.launches.reset()
    n0 = stats["distributed_searches"]
    resp = node.msearch(msearch)
    if kf.launches.count != slots or stats["distributed_searches"] != n0 + 1:
        raise AssertionError(
            f"[devices] {form} _msearch of {len(msearch)}: K1 "
            f"{kf.launches.count} launches (want {slots}), "
            f"distributed_searches +{stats['distributed_searches'] - n0}")
    res["launches"]["msearch"] = kf.launches.count
    got["msearch"] = [hits(r) for r in resp["responses"]]
    want = answers.setdefault("hits", got)
    if got != want:
        key = next(k for k in got if got[k] != want[k])
        i = next(i for i, (a, b) in enumerate(zip(got[key], want[key]))
                 if a != b)
        raise AssertionError(f"[devices] {form} {key} #{i}: {got[key][i]} "
                             f"is not one slot's {want[key][i]}")
    allocs = [a for a in ledger.live_allocations()
              if a.kind == kind and a.index == name]
    (bundle,) = [b for k, b in distributed_serving.registry._bundles.items()
                 if k[0] == name]
    if len(allocs) != slots or \
            sorted(a.device for a in allocs) != \
            sorted(str(d) for d in bundle.devices) or \
            sum(a.bytes for a in allocs) != bundle.nbytes:
        raise AssertionError(f"[devices] {form}: ledger allocations "
                             f"{[a.row() for a in allocs]} are not one a "
                             f"slot of the bundle's {bundle.nbytes} B")
    res["allocations"] = [{"device": a.device, "bytes": a.bytes}
                          for a in allocs]
    res["bundle_bytes"] = bundle.nbytes
    if "bundle_bytes" in answers and answers["bundle_bytes"] != bundle.nbytes:
        raise AssertionError(f"[devices] {form}: the slots' slabs hold "
                             f"{bundle.nbytes} B, one slot's "
                             f"{answers['bundle_bytes']}")
    answers.setdefault("bundle_bytes", bundle.nbytes)
    torch.cuda.synchronize()
    grew = {c: torch.cuda.memory_allocated(c) - before[c] for c in cards}
    for c in cards:
        slab = sum(bundle.slot_nbytes(i) for i, d in enumerate(bundle.devices)
                   if d.index == c)
        if not 0 <= grew[c] - slab < 3 * ALLOC_BLOCK * slots:
            raise AssertionError(f"[devices] {form}: cuda:{c}'s "
                                 f"memory_allocated() grew by {grew[c]} B, "
                                 f"its slots' slabs are {slab} B")
    res["memory_grew"] = {f"cuda:{c}": grew[c] for c in cards}
    lat_ms = np.asarray(lat) * 1e3
    res["k10_p50_ms"] = float(np.percentile(lat_ms, 50))
    res["k10_qps"] = len(lat) / sum(lat)
    # the device step of one k = 10 search by slot: each slot's K1 scan
    # alone, and the whole step (its rest: the copies, gather and merge)
    qv = torch.tensor([bodies["k10"][0]["query"]["knn"]["v"]["vector"]],
                      dtype=torch.float32, device=bundle.devices[0])
    step = distributed_serving.build_knn_serving_step(
        k_shard=10, k_final=10, similarity="l2_norm", kernel="pallas")
    args = (bundle.slot_vectors, bundle.slot_norms_sq, bundle.slot_valid)
    whole = device_profile(lambda: step(*args, qv), 10)
    res["step_device_ms"] = whole and whole["device_ms"]
    res["scan_device_ms"] = whole and kernel_ms(whole, "knn_")
    res["gather_merge_device_ms"] = whole and (
        whole["device_ms"] - kernel_ms(whole, "knn_"))
    res["slot_scan_device_ms"] = []
    for v, nrm, ok in zip(*args):
        prof = device_profile(lambda v=v, nrm=nrm, ok=ok: kf.knn_fused_stacked(
            v, nrm, ok, qv.to(v.device), k=10, similarity="l2_norm"), 10)
        res["slot_scan_device_ms"].append(prof and kernel_ms(prof, "knn_"))
    log(f"[devices] {form}: {slots} slot(s) on {res['cards']}; every "
        f"search {slots} K1 launch(es), hits, scores and totals one slot's "
        f"bits; k = 10 p50 {res['k10_p50_ms']:.3f} ms, QPS "
        f"{res['k10_qps']:.1f}; device ms {json.dumps({k: res[k] for k in ('step_device_ms', 'scan_device_ms', 'gather_merge_device_ms', 'slot_scan_device_ms')})}; "
        f"memory grew {res['memory_grew']} B")
    return res


# --------------------------------------------------------------------------
# telemetry: the residency ledger, the calibrated peaks and the roofline
# --------------------------------------------------------------------------

# H100 SXM data sheet figures the calibration is held to: HBM3 and fp32
# outside the tensor cores
PEAK_GATE = (0.3, 1.05)


def node_tensor_bytes(node) -> int:
    """numel * element_size of every tensor the node's indices keep on the
    device: each published segment's columns and live bitmap and IVF-PQ
    slabs, and the resident serving bundles of its indices."""
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry

    total = 0
    for svc in node.indices.values():
        for shard in svc.shards.values():
            for _host, seg in shard.engine.acquire_searcher().segments:
                total += sum(seg.column_nbytes().values())
                total += sum(vf.ann.nbytes for vf in
                             seg.vector_fields.values()
                             if vf.ann is not None)
    return total + sum(r["bytes"] for r in default_registry.resident()
                       if r["index"] in node.indices)


def roofline_launches() -> dict:
    """The roofline's launches so far, by base family."""
    from opensearch_tpu_torch.telemetry import roofline

    out: dict = {}
    for name, row in roofline.default_recorder.snapshot_stats()[
            "families"].items():
        base = roofline.base_family(name)
        out[base] = out.get(base, 0) + row["launches"]
    return out


def ledger_gate(node, label: str, index: str, bodies: list, base: int,
                per_search: dict | None = None) -> dict:
    """The telemetry gates on a live node, before it closes: the ledger's
    identity holds; its resident bytes (above `base`, what was resident
    before the node's ingest) are the numel * element_size of the node's
    registered tensors and at most torch.cuda.memory_allocated(); each of
    `bodies` searched (one at a time) leaves one search span on
    node.telemetry.tracer and adds `per_search` launches to each named
    roofline family; a "profile": true search of the first body (its
    launches counted too) has roofline fields on a kernel row and
    residency rows; deleting `index` drops the resident bytes by its
    share."""
    from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

    default_ledger.verify_identity()
    resident = default_ledger.resident_bytes()
    walked = node_tensor_bytes(node)
    allocated = torch.cuda.memory_allocated()
    if resident - base != walked:
        raise AssertionError(f"[{label}] the ledger holds {resident - base} "
                             f"bytes for the node, its tensors {walked}")
    if resident > allocated:
        raise AssertionError(f"[{label}] the ledger's {resident} resident "
                             f"bytes exceed memory_allocated {allocated}")
    node.telemetry.tracer.clear()
    launches0 = roofline_launches()
    for body in bodies:
        node.search(index, dict(body))
    spans = [s for s in node.telemetry.tracer.finished_spans()
             if s.name == "search"]
    if len(spans) != len(bodies):
        raise AssertionError(f"[{label}] {len(bodies)} searches left "
                             f"{len(spans)} search spans")
    prof = node.search(index, {**bodies[0], "profile": True})["profile"]
    launches1 = roofline_launches()
    for family, n in (per_search or {}).items():
        got = launches1.get(family, 0) - launches0.get(family, 0)
        if got != n * (len(bodies) + 1):
            raise AssertionError(f"[{label}] {len(bodies) + 1} searches "
                                 f"added {got} {family} launches to the "
                                 f"roofline, not {n} each")
    rows = [k for sh in prof["shards"] for q in sh["searches"][0]["query"]
            for k in q.get("kernels", [])]
    fielded = sorted({k["name"] for k in rows if "roofline_fraction" in k})
    if not fielded or not prof["device"]:
        raise AssertionError(f"[{label}] profile: kernel rows "
                             f"{[k['name'] for k in rows]} with roofline "
                             f"fields {fielded}, {len(prof['device'])} "
                             f"residency rows")
    share = sum(r["bytes"] for r in default_ledger.structures(index=index))
    before = default_ledger.resident_bytes()
    node.delete_index(index)
    dropped = before - default_ledger.resident_bytes()
    default_ledger.verify_identity()
    if dropped != share:
        raise AssertionError(f"[{label}] deleting {index} dropped "
                             f"{dropped} resident bytes, its share is "
                             f"{share}")
    out = {"resident_bytes": resident - base, "tensor_bytes": walked,
           "memory_allocated": allocated, "search_spans": len(spans),
           "profile_roofline_rows": fielded,
           "roofline_launches_a_search": per_search or {},
           "residency_rows": len(prof["device"]),
           "deleted_share_bytes": share}
    log(f"[{label}] ledger: identity holds, resident bytes the node's "
        f"tensors', under memory_allocated; one span a search; profile "
        f"rows; the delete dropped its share: {json.dumps(out)}")
    return out


def telemetry_counters() -> dict:
    """The counter the stacked families' launches are held to: each
    stacked launch counts one distributed search. (The batcher's dispatch
    counters are reset by the concurrency checks, so the ANN families are
    held per search in ledger_gate instead.)"""
    from opensearch_tpu_torch.search import distributed_serving

    return {"stacked": distributed_serving.stats["distributed_searches"]}


def telemetry_phase(dev, since: dict) -> dict:
    """After the main and lexical phases: the calibrated peaks (measured
    on the card at the first TorchNode, CUDA events) beside the data sheet
    figures, each within PEAK_GATE of it; GET /_roofline over the port's
    HTTP server: the accounting identity (accounted_flops the families'
    model FLOPs summed), a mesh_knn_fused row (the stacked kNN searches;
    the stacked families' launches are the stacked launches since
    `since`), an ivfpq_adc_pallas row (the ANN searches; ledger_gate holds
    its launches to the searches one by one) and a bm25_term_scores row
    (a "profile": true match); each family's unclamped roofline fraction
    printed as a finding."""
    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.rest.http import HttpServer
    from opensearch_tpu_torch.telemetry import roofline

    peaks = roofline.current_peaks()
    sheet = {"peak_bytes_per_s": HBM_BYTES_PER_S,
             "peak_flops_per_s": FP32_FLOP_PER_S}
    got = {"peak_bytes_per_s": peaks.bytes_per_s,
           "peak_flops_per_s": peaks.flops_per_s}
    ratios = {key: got[key] / sheet[key] for key in sheet}
    log(f"[telemetry] calibrated peaks {json.dumps(peaks.to_dict())}; data "
        f"sheet {json.dumps(sheet)}; ratio {json.dumps(ratios)}")
    if peaks.source != "measured" or \
            peaks.platform != torch.cuda.get_device_name(dev):
        raise AssertionError(f"[telemetry] the peaks were not measured on "
                             f"the card: {peaks.to_dict()}")
    for key, r in ratios.items():
        if not PEAK_GATE[0] <= r <= PEAK_GATE[1]:
            raise AssertionError(f"[telemetry] {key} is {r:.3f}x the data "
                                 f"sheet's, outside {PEAK_GATE}")
    now = telemetry_counters()
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device=dev)
        server = HttpServer(node, "127.0.0.1", 0)
        server.start_in_thread()
        client = RestClient(server.port)
        try:
            report = client.ok("GET", "/_roofline")
        finally:
            client.close()
            server.stop_thread()
            node.close()
    rows = {r["family"]: r for r in report["families"]}
    flops = sum(r["flops"] for r in report["families"])
    if not report["identity_ok"] or \
            flops != report["counters"]["accounted_flops"]:
        raise AssertionError(f"[telemetry] /_roofline identity: families' "
                             f"flops {flops}, accounted "
                             f"{report['counters']['accounted_flops']}")

    def launches(*bases) -> int:
        return sum(r["launches"] for name, r in rows.items()
                   if roofline.base_family(name) in bases)

    want = {"stacked": now["stacked"] - since["stacked"]}
    have = {"stacked": launches("mesh_knn", "mesh_knn_fused")}
    for base in ("mesh_knn_fused", "ivfpq_adc_pallas", "bm25_term_scores"):
        if not any(roofline.base_family(n) == base for n in rows):
            raise AssertionError(f"[telemetry] /_roofline has no {base} row: "
                                 f"{sorted(rows)}")
    if have != want:
        raise AssertionError(f"[telemetry] roofline launches {have}, the "
                             f"routes' launches {want}")
    fractions = {}
    for name, r in rows.items():
        unclamped = (r["achieved_gflops"] / r["roofline_gflops"]
                     if r["roofline_gflops"] else None)
        fractions[name] = {
            "launches": r["launches"], "bound": r["bound"],
            "intensity": r["intensity"],
            "achieved_gflops": r["achieved_gflops"],
            "roofline_gflops": r["roofline_gflops"],
            "unclamped_fraction": unclamped}
        log(f"[telemetry] finding: roofline {name}: {json.dumps(fractions[name])}")
    out = {"peaks": peaks.to_dict(), "data_sheet": sheet,
           "peak_ratios": ratios, "launches": {
               **have, "ann": launches("ivfpq_search", "ivfpq_adc_pallas")},
           "identity_ok": report["identity_ok"],
           "top_offender": report["top_offender"], "families": fractions}
    log(f"[telemetry] /_roofline over HTTP: identity holds, launches "
        f"{have} equal the routes' {want}; top offender "
        f"{report['top_offender']}")
    return out


MSEARCH_BODIES = 32


def msearch_main_phase(node, kf, queries: np.ndarray) -> dict:
    """Batched _msearch kNN on index A through TorchNode.msearch: one
    msearch of 32 bare knn bodies at fp32 k = 10, at fp32 k = 100 and at
    bf16 k = 10 (size = k). Gates: each batched hit list is its solo
    node.search's bit for bit (ids and scores); the run of 32 makes
    exactly one K1 launch, on the tier scan_tier names (the list scan, the
    wide tier, the tensor-core tier), and distributed_serving's
    batched_queries rises by 32. Then a mixed msearch of 8 bodies whose
    fourth carries a filter inside its knn clause: the run goes one body
    at a time (8 launches, none batched), each its solo search's bits.
    Reports the msearch p50 on the host clock (5 calls) beside 32 solo
    searches in a row, and the device ms of the B = 32 step beside 32
    B = 1 steps."""
    from opensearch_tpu_torch.search import ann, distributed_serving

    def hits(resp) -> list:
        return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]

    qs = queries[:MSEARCH_BODIES]
    out = {}
    try:
        for prec, k, tier in (("fp32", 10, "lists"), ("fp32", 100, "wide"),
                              ("bf16", 10, "mma")):
            ann.default_config.configure(score_precision=prec)
            r = min(kf.fused_pool_width(k, prec), 1 << 18)
            if kf.scan_tier(prec, r) != tier:
                raise AssertionError(f"msearch {prec} k={k}: tier "
                                     f"{kf.scan_tier(prec, r)}, want {tier}")
            counter = {"lists": kf.list_launches, "wide": kf.wide_launches,
                       "mma": kf.mma_launches}[tier]
            searches = [({"index": "sift_a"}, {"query": {"knn": {"v": {
                "vector": qv.tolist(), "k": k}}}, "size": k}) for qv in qs]
            kf.launches.reset()
            counter.reset()
            batched0 = distributed_serving.stats["batched_queries"]
            t0 = time.perf_counter()
            resp = node.msearch(searches)
            first_s = time.perf_counter() - t0
            got = (kf.launches.count, counter.count,
                   distributed_serving.stats["batched_queries"] - batched0)
            if got != (1, 1, MSEARCH_BODIES):
                raise AssertionError(f"[sift_a] msearch {prec} k={k}: (K1 "
                                     f"launches, on {tier}, batched queries)"
                                     f" = {got}, want (1, 1, 32)")
            solo_lat, solo = [], []
            for _h, body in searches:
                t0 = time.perf_counter()
                solo.append(hits(node.search("sift_a", body)))
                solo_lat.append(time.perf_counter() - t0)
            for i, (g, s) in enumerate(zip(resp["responses"], solo)):
                if hits(g) != s:
                    raise AssertionError(f"[sift_a] msearch {prec} k={k} "
                                         f"body {i}: not its solo search bit "
                                         f"for bit")
            lat = []
            for _ in range(5):
                t0 = time.perf_counter()
                node.msearch(searches)
                lat.append(time.perf_counter() - t0)
            slab = bundle_slab("sift_a")
            qt = torch.from_numpy(qs).to(slab[0].device)
            step32 = device_profile(functools.partial(
                kf.knn_fused_stacked, *slab, qt, k=k, similarity="l2_norm",
                score_precision=prec), 5)

            def solo_steps():
                for i in range(MSEARCH_BODIES):
                    kf.knn_fused_stacked(*slab, qt[i:i + 1], k=k,
                                         similarity="l2_norm",
                                         score_precision=prec)

            step1 = device_profile(solo_steps, 3)
            out[f"{prec} k={k}"] = {
                "launches": {"knn_fused": got[0], f"knn_fused_{tier}": got[1]},
                "batched_queries": got[2],
                "first_msearch_ms": first_s * 1e3,
                "msearch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
                "solo_32_ms": sum(solo_lat) * 1e3,
                "solo_p50_ms": float(np.percentile(solo_lat, 50)) * 1e3,
                "step_b32_device_ms": step32 and step32["device_ms"],
                "steps_32x_b1_device_ms": step1 and step1["device_ms"]}
            log(f"[sift_a] msearch of 32 at {prec} k={k}: one K1 launch on "
                f"{tier}, every body its solo search bit for bit; "
                f"{json.dumps(out[f'{prec} k={k}'])}")
    finally:
        ann.default_config.configure(score_precision="fp32")
    # the mixed run: a filter in the fourth body keeps the run serial
    bodies = [{"query": {"knn": {"v": {"vector": qv.tolist(), "k": 10}}},
               "size": 10} for qv in qs[:8]]
    bodies[3] = {"query": {"knn": {"v": {
        "vector": qs[3].tolist(), "k": 10,
        "filter": {"range": {"age": {"gte": 20, "lte": 60}}}}}}, "size": 10}
    kf.launches.reset()
    batched0 = distributed_serving.stats["batched_queries"]
    resp = node.msearch([({"index": "sift_a"}, b) for b in bodies])
    got = (kf.launches.count,
           distributed_serving.stats["batched_queries"] - batched0)
    if got != (8, 0):
        raise AssertionError(f"[sift_a] mixed msearch: (K1 launches, batched "
                             f"queries) = {got}, want (8, 0)")
    for i, (g, body) in enumerate(zip(resp["responses"], bodies)):
        if hits(g) != hits(node.search("sift_a", body)):
            raise AssertionError(f"[sift_a] mixed msearch body {i}: not its "
                                 f"solo search")
    out["mixed"] = {"bodies": 8, "launches": got[0], "batched_queries": got[1]}
    log(f"[sift_a] mixed msearch (a filter in body 3): 8 launches, none "
        f"batched, every body its solo search")
    return out


# --------------------------------------------------------------------------
# the REST path: the port's HTTP server over the same node
# --------------------------------------------------------------------------

REST_FETCH_OPTIONS = (
    {"version": True}, {"seq_no_primary_term": True},
    {"docvalue_fields": ["age"]}, {"fields": ["c*"]},
    {"stored_fields": "_none_"}, {"_source": {"excludes": ["v"]}},
    {"explain": True}, {"min_score": 0.001})


class RestClient:
    """One keep-alive HTTP/1.1 connection to the port's server."""

    def __init__(self, port: int):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def __call__(self, method: str, path: str, body=None, ndjson=None):
        headers = {"Content-Type": "application/json"}
        data = None
        if ndjson is not None:
            data = ("\n".join(json.dumps(x) for x in ndjson) + "\n").encode()
            headers["Content-Type"] = "application/x-ndjson"
        elif body is not None:
            data = json.dumps(body).encode()
        self.conn.request(method, path, body=data, headers=headers)
        resp = self.conn.getresponse()
        raw = resp.read()
        return resp.status, (json.loads(raw) if raw else None)

    def ok(self, method: str, path: str, body=None, ndjson=None,
           status: int | tuple = 200):
        got, payload = self(method, path, body, ndjson)
        want = status if isinstance(status, tuple) else (status,)
        if got not in want:
            raise AssertionError(f"{method} {path}: HTTP {got} (want "
                                 f"{want}): {json.dumps(payload)[:400]}")
        return payload

    def close(self) -> None:
        self.conn.close()


def json_view(resp: dict) -> dict:
    """A response as JSON gives it, `took` removed at every level."""
    def strip(obj):
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in obj.items() if k != "took"}
        if isinstance(obj, list):
            return [strip(v) for v in obj]
        return obj

    return strip(json.loads(json.dumps(resp)))


def profile_shape(obj):
    """Keys, list lengths, strings and leaf types of a profile."""
    if isinstance(obj, dict):
        return {k: profile_shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [profile_shape(v) for v in obj]
    return obj if isinstance(obj, str) else type(obj).__name__


def rest_hits(resp) -> list:
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


def rest_main_phase(node, kf, queries: np.ndarray, data_b: np.ndarray,
                    per_shard: dict | None) -> dict:
    """The port's HTTP server (rest/http.HttpServer on 127.0.0.1:0, in a
    thread) over the node that holds cell A. Every check is against the
    same request made in process, in this run:

    1. writes: PUT /rest_b with cell B's mapping (4 shards), one NDJSON
       _bulk of its 20,000 128-d docs, _refresh, then PUT / GET / _update /
       DELETE of one doc, each version and seq_no as the engine must give
       them, and a stale if_seq_no a 409; 32 kNN searches on rest_b equal
       node.search's bit for bit;
    2. kNN _search on cell A: 64 queries at k = 10 and 16 at k = 100, each
       response's (_id, _score) list node.search's bits, and the K1
       launches (all, and on the list scan or the wide tier) of the HTTP
       run the in-process run's; p50 / p99 / QPS of both;
    3. the fetch options on 8 queries (version, seq_no_primary_term,
       docvalue_fields, fields with a wildcard, stored_fields _none_,
       _source excludes, explain, min_score): each response the in-process
       one field for field, `took` aside;
    4. an NDJSON _msearch of 32 bare kNN bodies: one K1 launch (32
       batched queries), each response the in-process msearch's bits;
    5. 8 HTTP clients x 8 searches over keep-alive connections, on the
       stacked step and on the per-shard route (K1 through the batcher),
       each hit list its solo search's bits; QPS and the batcher's mean
       merged batch beside concurrent_phase's in-process figures;
    6. "profile": true: the operator tree of the in-process profile's
       shape, the K1 launch's device_time_in_nanos > 0;
    7. PUT of an index with a create-index key the port does not serve
       answers the 500 envelope with its "not yet ported" reason, GET
       /_cluster/pending_tasks and GET /_cat/recovery?format=json answer
       200 (the single node's control plane), and after each the next
       search on the same connection succeeds.
    Then DELETE /rest_b, whose stacked slabs must leave the registry. Also
    the in-process p50 at cell A with the profiler's hooks and without
    them (the decorated entry points swapped for the functions they
    wrap), in turns."""
    from opensearch_tpu_torch.cluster import shard_mesh
    from opensearch_tpu_torch.ops import adc_scan as ads
    from opensearch_tpu_torch.ops import knn as knn_ops
    from opensearch_tpu_torch.rest.http import HttpServer
    from opensearch_tpu_torch.search import distributed_serving

    t_phase = time.perf_counter()
    server = HttpServer(node, "127.0.0.1", 0)
    server.start_in_thread()
    client = RestClient(server.port)
    out = {"port": server.port}
    try:
        # 1. writes over HTTP
        mapping = {"properties": {"v": {"type": "knn_vector",
                                        "dimension": DIM,
                                        "similarity": "l2_norm"},
                                  "tag": {"type": "keyword"}}}
        client.ok("PUT", "/rest_b", {"settings": {"number_of_shards": 4},
                                     "mappings": mapping})
        lines = []
        for i in range(data_b.shape[0]):
            lines += [{"index": {"_index": "rest_b", "_id": str(i)}},
                      {"v": data_b[i].tolist(), "tag": f"t{i % 7}"}]
        t0 = time.perf_counter()
        bulk = client.ok("POST", "/_bulk", ndjson=lines)
        if bulk["errors"] or len(bulk["items"]) != data_b.shape[0]:
            raise AssertionError("REST _bulk into rest_b reported errors")
        client.ok("POST", "/rest_b/_refresh")
        out["bulk_refresh_s"] = time.perf_counter() - t0
        doc = {"v": data_b[0].tolist(), "tag": "new"}
        first = client.ok("PUT", "/rest_b/_doc/n1", doc, status=201)
        second = client.ok("PUT", "/rest_b/_doc/n1", doc)
        got = client.ok("GET", "/rest_b/_doc/n1")
        upd = client.ok("POST", "/rest_b/_update/n1",
                        {"doc": {"tag": "newer"}})
        noop = client.ok("POST", "/rest_b/_update/n1",
                         {"doc": {"tag": "newer"}})
        stale = client("PUT", f"/rest_b/_doc/n1?if_seq_no="
                       f"{first['_seq_no']}&if_primary_term=1", doc)
        deleted = client.ok("DELETE", "/rest_b/_doc/n1")
        gone = client("GET", "/rest_b/_doc/n1")
        versions = [first["_version"], second["_version"], got["_version"],
                    upd["_version"], noop["_version"], deleted["_version"]]
        if (versions != [1, 2, 2, 3, 3, 4]
                or first["result"] != "created"
                or second["result"] != "updated"
                or upd["result"] != "updated" or noop["result"] != "noop"
                or deleted["result"] != "deleted"
                or got["_seq_no"] != second["_seq_no"]
                or not first["_seq_no"] < second["_seq_no"] < upd["_seq_no"]
                < deleted["_seq_no"]
                or got["_source"] != doc or stale[0] != 409
                or gone[0] != 404 or gone[1]["found"] is not False):
            raise AssertionError(
                f"rest_b single-doc writes: versions {versions}, seq_nos "
                f"{[first['_seq_no'], second['_seq_no'], upd['_seq_no']]}, "
                f"stale CAS {stale[0]}, GET after delete {gone[0]}")
        qb = data_b[:32] + 0.05
        for i, qv in enumerate(qb):
            body = {"query": {"knn": {"v": {"vector": qv.tolist(), "k": 10}}},
                    "size": 10}
            http_hits = rest_hits(client.ok("POST", "/rest_b/_search", body))
            if http_hits != rest_hits(node.search("rest_b", body)):
                raise AssertionError(f"rest_b query {i}: HTTP hits are not "
                                     f"node.search's bits")
        out["writes"] = {"docs": data_b.shape[0], "shards": 4,
                         "versions": versions, "searches": 32}
        log(f"[rest_b] over HTTP: PUT, one _bulk of {data_b.shape[0]} docs "
            f"and _refresh in {out['bulk_refresh_s']:.1f} s; PUT / GET / "
            f"_update / DELETE versions {versions}; 32 kNN searches equal "
            f"node.search bit for bit")

        # 2. kNN _search over HTTP on cell A, beside the same in process
        def run(k: int, qs: np.ndarray, counter, over_http: bool) -> tuple:
            kf.launches.reset()
            counter.reset()
            lat, hits = [], []
            for qv in qs:
                body = {"query": {"knn": {"v": {"vector": qv.tolist(),
                                                "k": k}}}, "size": k}
                t0 = time.perf_counter()
                resp = (client.ok("POST", "/sift_a/_search", body)
                        if over_http else node.search("sift_a", body))
                lat.append(time.perf_counter() - t0)
                hits.append(rest_hits(resp))
            return hits, lat, (kf.launches.count, counter.count)

        knn = {}
        for k, n, counter, tier in ((10, 64, kf.list_launches, "lists"),
                                    (100, 16, kf.wide_launches, "wide")):
            solo_hits, solo_lat, solo_n = run(k, queries[:n], counter, False)
            http_hits, http_lat, http_n = run(k, queries[:n], counter, True)
            for i, (a, b) in enumerate(zip(http_hits, solo_hits)):
                if a != b:
                    raise AssertionError(f"[sift_a] HTTP k={k} query {i}: "
                                         f"not node.search's bits")
            if http_n != solo_n or solo_n != (n, n):
                raise AssertionError(
                    f"[sift_a] k={k}: (K1 launches, on {tier}) HTTP {http_n}"
                    f", in process {solo_n}, want ({n}, {n})")
            knn[f"k={k}"] = {
                "searches": n,
                "launches": {"knn_fused": http_n[0],
                             f"knn_fused_{tier}": http_n[1]},
                "http": latency_summary(http_lat),
                "in_process": latency_summary(solo_lat)}
            log(f"[sift_a] kNN _search over HTTP at k={k}: {n} responses "
                f"node.search's bits, K1 launches {http_n} as in process; "
                f"{json.dumps(knn[f'k={k}'])}")
        out["knn"] = knn

        # 3. the fetch options
        for i, extra in enumerate(REST_FETCH_OPTIONS):
            body = {"query": {"knn": {"v": {"vector": queries[i].tolist(),
                                            "k": 10}}}, "size": 10, **extra}
            got = json_view(client.ok("POST", "/sift_a/_search", body))
            want = json_view(node.search("sift_a", body))
            if got != want or not got["hits"]["hits"]:
                raise AssertionError(f"[sift_a] fetch option {extra}: the "
                                     f"HTTP response is not node.search's")
        out["fetch_options"] = [sorted(e)[0] for e in REST_FETCH_OPTIONS]
        log(f"[sift_a] fetch options over HTTP equal in process field for "
            f"field: {out['fetch_options']}")

        # 4. _msearch of 32 bare kNN bodies
        bodies = [{"query": {"knn": {"v": {"vector": qv.tolist(), "k": 10}}},
                   "size": 10} for qv in queries[:MSEARCH_BODIES]]
        nd = [x for b in bodies for x in ({"index": "sift_a"}, b)]
        kf.launches.reset()
        batched0 = distributed_serving.stats["batched_queries"]
        t0 = time.perf_counter()
        got = client.ok("POST", "/_msearch", ndjson=nd)
        msearch_ms = (time.perf_counter() - t0) * 1e3
        got_n = (kf.launches.count,
                 distributed_serving.stats["batched_queries"] - batched0)
        want = node.msearch([({"index": "sift_a"}, b) for b in bodies])
        if got_n != (1, MSEARCH_BODIES):
            raise AssertionError(f"[sift_a] HTTP _msearch: (K1 launches, "
                                 f"batched queries) = {got_n}, want (1, 32)")
        for i, (g, w) in enumerate(zip(got["responses"],
                                       want["responses"])):
            if g["status"] != 200 or rest_hits(g) != rest_hits(w):
                raise AssertionError(f"[sift_a] HTTP _msearch body {i}: not "
                                     f"the in-process msearch's bits")
        searches = [({"index": "sift_a"}, b) for b in bodies]
        lat = {"http": [], "in_process": []}
        for _ in range(5):
            t0 = time.perf_counter()
            client.ok("POST", "/_msearch", ndjson=nd)
            lat["http"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            node.msearch(searches)
            lat["in_process"].append(time.perf_counter() - t0)
        out["msearch"] = {
            "bodies": MSEARCH_BODIES, "launches": got_n[0],
            "batched_queries": got_n[1], "first_http_ms": msearch_ms,
            **{f"{key}_p50_ms": float(np.percentile(v, 50)) * 1e3
               for key, v in lat.items()}}
        log(f"[sift_a] HTTP _msearch of 32: one K1 launch, every body the "
            f"in-process msearch's bits; {json.dumps(out['msearch'])}")

        # 5. 8 HTTP clients x 8 searches over keep-alive connections
        def clients(route: str) -> dict:
            qs = queries[:64]
            body = [{"query": {"knn": {"v": {"vector": qv.tolist(),
                                             "k": 10}}}, "size": 10}
                    for qv in qs]
            solo = [rest_hits(node.search("sift_a", b)) for b in body]
            got, lat = [None] * len(qs), [0.0] * len(qs)
            node.knn_batcher.reset()

            def worker(t: int) -> None:
                c = RestClient(server.port)
                try:
                    for i in range(t, len(qs), 8):
                        t0 = time.perf_counter()
                        got[i] = rest_hits(c.ok("POST", "/sift_a/_search",
                                                body[i]))
                        lat[i] = time.perf_counter() - t0
                finally:
                    c.close()

            t0 = time.perf_counter()
            with ThreadPoolExecutor(8) as pool:
                for f in [pool.submit(worker, t) for t in range(8)]:
                    f.result()
            wall = time.perf_counter() - t0
            for i, (g, s) in enumerate(zip(got, solo)):
                concurrent_check(f"sift_a HTTP {route}", i, g, s)
            stats = node.knn_batcher.snapshot_stats()
            return {**latency_summary(lat, wall),
                    "dispatches": stats["dispatches"],
                    "mean_merged_batch": stats["mean_merged_batch"]}

        conc = {"stacked": clients("stacked")}
        distributed_serving.enabled = False
        try:
            conc["per_shard"] = clients("per_shard")
        finally:
            distributed_serving.enabled = True
        if per_shard is not None:
            c = per_shard["concurrent"]
            conc["in_process_per_shard"] = {
                **c["concurrent"], "mean_merged_batch": c["mean_merged_batch"]}
        out["concurrent"] = conc
        log(f"[sift_a] 8 HTTP clients x 8 searches, each its solo search's "
            f"bits: {json.dumps(conc)}")

        # 6. "profile": true
        body = {"query": {"knn": {"v": {"vector": queries[0].tolist(),
                                        "k": 10}}}, "size": 10,
                "profile": True}
        got = client.ok("POST", "/sift_a/_search", body)["profile"]
        want = node.search("sift_a", body)["profile"]
        if profile_shape(got) != profile_shape(want):
            raise AssertionError("[sift_a] the HTTP profile's shape is not "
                                 "the in-process profile's")
        (shard,) = got["shards"]
        (op,) = shard["searches"][0]["query"]
        device_ns = op["device_time_in_nanos"]
        if device_ns <= 0 or op["kernels"][0]["name"] != "shard_mesh_knn":
            raise AssertionError(f"[sift_a] profile: K1 launch "
                                 f"device_time_in_nanos {device_ns}")
        out["profile"] = {"device_time_in_nanos": device_ns,
                          "kernels": op["kernels"],
                          "fetch": shard["fetch"]["time_in_nanos"]}
        log(f"[sift_a] profile over HTTP has the in-process shape; the K1 "
            f"launch: device_time_in_nanos {device_ns}")

        # 7. not yet ported, then the same connection serves a search; the
        # control plane answers 200 on it
        envelopes = {}
        for method, path, req, want in (
                ("PUT", "/rest_x", {"bogus": {}}, 500),
                ("GET", "/_cluster/pending_tasks", None, 200),
                ("GET", "/_cat/recovery?format=json", None, 200)):
            status, payload = client(method, path, req)
            if want == 500:
                reason = (payload or {}).get("error", {}).get("reason", "")
                if status != 500 or payload.get("status") != 500 or \
                        "is not yet ported to opensearch_tpu_torch" \
                        not in reason:
                    raise AssertionError(f"{method} {path}: HTTP {status} "
                                         f"{payload}")
                envelopes[f"{method} {path}"] = reason
            elif status != 200:
                raise AssertionError(f"{method} {path}: HTTP {status} "
                                     f"{payload}")
            after = client.ok("POST", "/sift_a/_search", {"query": {"knn": {
                "v": {"vector": queries[1].tolist(), "k": 10}}}})
            if not after["hits"]["hits"]:
                raise AssertionError(f"no search after {method} {path}")
        out["not_yet_ported"] = envelopes
        log(f"not yet ported over HTTP: {envelopes}; GET /_cluster/"
            f"pending_tasks and /_cat/recovery 200; the connection serves "
            f"the next search after each")

        client.ok("DELETE", "/rest_b")
        if any(key[0] == "rest_b"
               for key in shard_mesh.default_registry._bundles):
            raise AssertionError("DELETE /rest_b left its serving slabs")
    finally:
        client.close()
        server.stop_thread()

    # the profiler's hooks on the unprofiled path: in-process p50 at cell
    # A with the decorated entry points and with the functions they wrap,
    # in turns (hooked, bare, bare, hooked)
    hooked = [(kf, "knn_fused_stacked"), (kf, "knn_fused_auto"),
              (knn_ops, "raw_similarity"), (knn_ops, "exact_knn_scores"),
              (ads, "adc_topr_auto")]
    originals = {(id(m), name): getattr(m, name) for m, name in hooked}

    def p50(bare: bool) -> float:
        for m, name in hooked:
            fn = originals[(id(m), name)]
            setattr(m, name, fn.__wrapped__ if bare else fn)
        try:
            lat = []
            for qv in queries[:64]:
                body = {"query": {"knn": {"v": {"vector": qv.tolist(),
                                                "k": 10}}}, "size": 10}
                t0 = time.perf_counter()
                node.search("sift_a", body)
                lat.append(time.perf_counter() - t0)
            return float(np.percentile(np.asarray(lat) * 1e3, 50))
        finally:
            for m, name in hooked:
                setattr(m, name, originals[(id(m), name)])

    turns = [("hooked", p50(False)), ("bare", p50(True)),
             ("bare", p50(True)), ("hooked", p50(False))]
    out["hooks_p50_ms"] = {
        "hooked": [v for key, v in turns if key == "hooked"],
        "bare": [v for key, v in turns if key == "bare"]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[sift_a] in-process p50 with the profiler's hooks and without, in "
        f"turns: {json.dumps(out['hooks_p50_ms'])}; REST phase "
        f"{out['phase_s']:.1f} s")
    return out


def rest_phase(kf, dev, seed: int) -> dict:
    """Index A alone, built as main_path_phase builds it, one search to
    build its serving bundle, then rest_main_phase with cell B's corpus
    (``--phases rest``)."""
    from opensearch_tpu_torch.node import TorchNode

    rng = np.random.default_rng(seed + 2)
    data = clustered(rng, 200_000, DIM)
    data_b = clustered(rng, 20_000, DIM)
    attrs = attributes(rng, 200_000)
    queries = (data[rng.choice(200_000, 64, replace=False)]
               + 0.05 * rng.standard_normal((64, DIM)).astype(np.float32))
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device="cuda")
        t0 = time.perf_counter()
        _bulk_index(node, "sift_a", data, 1, attrs)
        log(f"[sift_a] 200000 docs with age, color, taste: bulk + refresh "
            f"{time.perf_counter() - t0:.1f} s")
        node.search("sift_a", {"query": {"knn": {"v": {
            "vector": queries[0].tolist(), "k": 10}}}})
        out = rest_main_phase(node, kf, queries, data_b, None)
        node.close()
    return out


# --------------------------------------------------------------------------
# the fixed-order rescore and |q|^2 (csrc/knn_rescore.cu)
# --------------------------------------------------------------------------

RESCORE_KERNELS = ("knn_rescore_kernel", "knn_query_sq_kernel")


def einsum_rescore(kf, queries, vectors, norms_sq, valid, cand, k: int,
                   similarity: str):
    """The rescore the port ran before its kernel: a gather and one batched
    torch.einsum (cuBLAS, which picks its summation order by the batch),
    the transform, the mask and a stable top-k. Kept here only as the
    yardstick the kernel's time stands beside."""
    cand = cand.long()
    safe = torch.clamp(cand, min=0)
    shard = torch.arange(vectors.shape[0], device=vectors.device)[:, None, None]
    dots = torch.einsum("bd,sbrd->sbr", queries, vectors[shard, safe])
    qsq = (queries * queries).sum(dim=1)[None, :, None]
    scores = kf._transform_scores(dots, qsq, norms_sq[shard, safe], similarity)
    scores = torch.where((cand >= 0) & valid[shard, safe], scores,
                         float("-inf"))
    return kf.stable_topk(scores, k)


def rescore_check(kr, v, nrm, ok, q, cand, sim: str, what: str,
                  bits: bool) -> int:
    """The rescore kernel and the |q|^2 kernel against their plain versions
    on the same operands: |q|^2 bit-equal; the scores bit-equal on data
    whose dots are exact (`bits`), and on float data either bit-equal or,
    where not, each differing slot logged with its f64 score and both
    within 1e-6 relative of it (the f32 bound of a d-term sum at these
    magnitudes); a batch's rows bit-equal to each query's solo call (the
    batcher's contract), one rescore launch a call. Returns the slots
    that differ from plain."""
    from opensearch_tpu_torch.ops.knn_fused import _transform_scores

    before = kr.launches.count
    qsq = kr.query_sq(q)
    got = kr.rescore(q, qsq, v, nrm, ok, cand, similarity=sim)
    torch.cuda.synchronize()
    if kr.launches.count - before != 1:
        raise AssertionError(f"{what}: the rescore launched "
                             f"{kr.launches.count - before} times")
    if not torch.equal(qsq, kr.plain_query_sq(q)):
        raise AssertionError(f"{what}: |q|^2 not bit-equal to plain")
    want = kr.plain_rescore(q, kr.plain_query_sq(q), v, nrm, ok, cand,
                            similarity=sim)
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError(f"{what}: -inf slots differ from plain")
    diff = (got != want) & torch.isfinite(want)
    if bits and bool(diff.any()):
        raise AssertionError(f"{what}: not bit-equal on exact dots at "
                             f"{diff.nonzero()[:5].tolist()}")
    for s, b, j in diff.nonzero().tolist():
        c = int(cand[s, b, j])
        exact = float(_transform_scores(
            (v[s, c].double() * q[b].double()).sum(), qsq[b].double(),
            nrm[s, c].double(), sim))
        a, p = float(got[s, b, j]), float(want[s, b, j])
        log(f"{what}: slot {(s, b, j)} doc {c}: kernel {a!r}, plain {p!r}, "
            f"f64 {exact!r}")
        if max(abs(a - exact), abs(p - exact)) > 1e-6 * abs(exact) + 1e-7:
            raise AssertionError(f"{what}: slot {(s, b, j)} beyond the f32 "
                                 f"bound")
    for i in range(q.shape[0]):
        solo_sq = kr.query_sq(q[i:i + 1])
        solo = kr.rescore(q[i:i + 1], solo_sq, v, nrm, ok,
                          cand[:, i:i + 1].contiguous(), similarity=sim)
        if not (torch.equal(solo_sq[0], qsq[i])
                and torch.equal(solo[:, 0], got[:, i])):
            raise AssertionError(f"{what}: query {i} alone differs from its "
                                 f"row of the batch")
    return int(diff.sum())


def rescore_kernel_phase(kr, dev, seed: int) -> int:
    """The rescore kernel (knn_rescore_kernel) and |q|^2
    (knn_query_sq_kernel) on the card (rescore_check): sixteenths (every dot
    exact in f32) and clustered floats; one shard of 200,000 docs at d = 128
    and four of 20,000 at d = 100 (cosine) and 768; B = 1, 8 and 33; R = 40,
    64, 400 and 512 candidates a (shard, query), a tenth of them -1 and 3%
    of the docs dead. Returns the float slots that differ from plain."""
    rng = np.random.default_rng(seed + 50)
    differ = 0
    for s, n, d, sim in ((1, 200_000, DIM, "l2_norm"),
                         (4, 20_000, 100, "cosine"),
                         (4, 20_000, 768, "l2_norm")):
        for bits in (True, False):
            raw = rng.standard_normal((s, n, d)).astype(np.float32)
            data = np.round(raw * 16) / 16 if bits else raw
            v = torch.from_numpy(data.astype(np.float32)).to(dev)
            nrm = (v.double() ** 2).sum(2).float()
            ok = torch.from_numpy(rng.random((s, n)) >= 0.03).to(dev)
            for b in (1, 8, 33):
                q = v[0, torch.from_numpy(rng.choice(n, b)).to(dev)].clone()
                if not bits:
                    q += 0.01 * torch.randn_like(q)
                for r in (40, 64, 400, 512):
                    cand = rng.integers(0, n, (s, b, r)).astype(np.int32)
                    cand[rng.random((s, b, r)) < 0.1] = -1
                    differ += rescore_check(
                        kr, v, nrm, ok, q, torch.from_numpy(cand).to(dev),
                        sim, f"rescore S={s} n={n} d={d} {sim} B={b} R={r} "
                        f"exact={bits}", bits)
            del v
            torch.cuda.empty_cache()
    log(f"rescore and |q|^2 parity: bit-equal on exact dots, {differ} float "
        f"slots differ from plain (each logged), every batch row its solo "
        f"call's bits")
    return differ


def rescore_timing(kf, kr, dev, seed: int) -> dict:
    """The rescore kernel at cell A's serving shapes (one shard of 200,000
    128-d docs in 262,144 slots, l2): B = 1 with R = 40 and 400 (the
    stacked step at bf16 and int8, k = 10 and 100) and B = 8 with R = 64
    and 512 (the per-shard route's merged batches, k_bucket 16 and 128);
    candidates from a bf16 pool. CUDA-event ms and device ms of the kernel
    (with its |q|^2 launch: the rescore as the step runs it), of the plain
    version and of the einsum rescore it replaced (einsum_rescore), beside
    the bound: each candidate's row, norm and flag read once, the ids
    read, the scores written. No single PyTorch call computes it (library
    null). Then |q|^2 alone at B = 1, 8 and 64: its ms, the plain
    version's and one torch.einsum("bd,bd->b") call's."""
    rng = np.random.default_rng(seed + 51)
    n, slots = 200_000, 262_144
    data = np.zeros((1, slots, DIM), np.float32)
    data[0, :n] = clustered(rng, n, DIM)
    v = torch.from_numpy(data).to(dev)
    nrm = (v.double() ** 2).sum(2).float()
    ok = torch.zeros((1, slots), dtype=torch.bool, device=dev)
    ok[0, :n] = True
    out = {}
    for b, r, k in ((1, 40, 10), (1, 400, 100), (8, 64, 16), (8, 512, 128)):
        q = v[0, torch.from_numpy(rng.choice(n, b)).to(dev)] + 0.01
        args = reduced_args(kf, v, nrm, ok, q, "bf16")
        _pv, cand = kf.pool_scan(*args, r=r, similarity="l2_norm",
                                 score_precision="bf16")
        label = f"rescore B={b} R={r}"
        rescore_check(kr, v, nrm, ok, q, cand, "l2_norm", label, False)

        def kernel():
            return kr.rescore(q, kr.query_sq(q), v, nrm, ok, cand,
                              similarity="l2_norm")

        def plain():
            return kr.plain_rescore(q, kr.plain_query_sq(q), v, nrm, ok,
                                    cand, similarity="l2_norm")

        def einsum():
            return einsum_rescore(kf, q, v, nrm, ok, cand, k, "l2_norm")

        nbytes = b * r * (DIM * 4 + 4 + 1 + 4 + 4) + b * (DIM * 4 + 4)
        prof = device_profile(kernel, 10)
        eprof = device_profile(einsum, 10)
        out[label] = {
            "ms": time_ms(kernel, 50), "plain_ms": time_ms(plain, 5),
            "einsum_ms": time_ms(einsum, 50), "library_ms": None,
            "device_ms": prof and prof["device_ms"],
            "rescore_device_ms": kernel_ms(prof, RESCORE_KERNELS[0]),
            "query_sq_device_ms": kernel_ms(prof, RESCORE_KERNELS[1]),
            "einsum_device_ms": eprof and eprof["device_ms"],
            "einsum_kernels": eprof and eprof["top"],
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
        log(f"{label}: {json.dumps(out[label])}")
    for b in (1, 8, 64):
        q = torch.randn((b, DIM), device=dev)
        nbytes = b * (DIM * 4 + 4)
        prof = device_profile(lambda: kr.query_sq(q), 10)
        out[f"query_sq B={b}"] = {
            "ms": time_ms(lambda: kr.query_sq(q), 50),
            "plain_ms": time_ms(lambda: kr.plain_query_sq(q), 10),
            "library_ms": time_ms(lambda: torch.einsum("bd,bd->b", q, q), 50),
            "device_ms": prof and prof["device_ms"],
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
        log(f"query_sq B={b}: {json.dumps(out[f'query_sq B={b}'])}")
    del v
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# K3, K4, K5: the exact-scan family
# --------------------------------------------------------------------------

FAMILY = ("knn_block", "knn_pb", "knn_sbmax")
FAMILY_ENTRY = {"knn_block": "knn_topk_auto", "knn_pb": "knn_blocktopk_auto",
                "knn_sbmax": "knn_sbmax_auto"}
# the profiler's kernel names of the two-kernel entry points' stages (K3 at
# k = 10: the list scan and its split merge)
STAGE_KERNELS = {"knn_block": ("knn_pool_scan_kernel", "knn_pool_merge_kernel"),
                 "knn_pb": ("knn_pb_kernel", "knn_pb_merge_kernel"),
                 "knn_sbmax": ("sbmax_stage1", "sbmax_stage2")}


def sixteenths(rng, n: int, d: int) -> np.ndarray:
    """Clustered vectors whose coordinates are multiples of 1/16 below 4 in
    magnitude: every product and every partial sum of a dot is exact in
    f32, so a dot comes out to the same bits in any summation order and
    the kernels must agree with their plain versions bit for bit, ties
    (there are many) included."""
    x = np.round(clustered(rng, n, d) * 4.0) / 16.0
    return np.clip(x, -63 / 16, 63 / 16).astype(np.float32)


def sift_like(rng, n: int, d: int) -> np.ndarray:
    """SIFT-style descriptors: clustered integer coordinates in [0, 255].
    Dots stay below 2^24, so f32 holds them exactly in any order."""
    centers = rng.integers(0, 120, (64, d)).astype(np.float32)
    out = np.empty((n, d), np.float32)
    for lo in range(0, n, 200_000):
        hi = min(lo + 200_000, n)
        out[lo:hi] = centers[rng.integers(0, 64, hi - lo)] + \
            rng.normal(0.0, 12.0, (hi - lo, d)).astype(np.float32)
    return np.clip(np.round(out), 0, 255).astype(np.float32)


def family_stage1(kb, name: str, args, k: int, sim: str, exact: bool):
    """(kernel, plain) stage-1 outputs of one family kernel on the same
    padded operands."""
    if name == "knn_block":
        return (kb.block_topk(*args, k=k, similarity=sim),
                kb.plain_block_topk(*args, k=k, similarity=sim))
    if name == "knn_pb":
        return (kb.pb_topk(*args, k=k, similarity=sim, exact=exact),
                kb.plain_pb_topk(*args, k=k, similarity=sim, exact=exact))
    return ((kb.sbmax(*args, similarity=sim, exact=exact),),
            (kb.plain_sbmax(*args, similarity=sim, exact=exact),))


def family_plain(kb, name: str, v, nrm, ok, q, k: int, sim: str = "l2_norm",
                 exact: bool = True):
    """The whole entry point with the plain stage 1, on the card."""
    if name == "knn_block":
        qp = kb._pad_queries(q, None)
        return kb.plain_block_topk(v, nrm, ok, qp, k=k, similarity=sim)
    qp = kb._pad_queries(q, kb.PB_QTILE)
    if name == "knn_pb":
        return kb.pb_merge(*kb.plain_pb_topk(v, nrm, ok, qp, k=k,
                                             similarity=sim, exact=exact), k)
    return kb.sbmax_rescore(kb.plain_sbmax(v, nrm, ok, qp, similarity=sim,
                                           exact=exact),
                            v, nrm, ok, qp, k=k, similarity=sim, exact=exact)


def compare_stage1(kb, name, args, k, sim, exact, what: str) -> float:
    """Kernel vs plain stage 1, bit for bit: ids (K4: on finite slots) and
    scores. Returns max |dv| over the finite slots."""
    got, want = family_stage1(kb, name, args, k, sim, exact)
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        bad = (got[0] != want[0]).nonzero()[:5].tolist()
        raise AssertionError(f"{what}: scores differ at {bad}")
    fin = torch.isfinite(want[0])
    if len(got) > 1 and not torch.equal(got[1][fin], want[1][fin]):
        raise AssertionError(f"{what}: ids differ on finite slots")
    return float((got[0][fin] - want[0][fin]).abs().max()) \
        if bool(fin.any()) else 0.0


def blocks_kernel_phase(kb, dev, seed: int) -> float:
    """K3 against its plain version on the card: n = 50,000 (a ragged tail
    past the 1024-doc block), d = 128, 3% dead docs, a duplicate of doc
    2040 planted at 2053 (across the block boundary), B = 1, 5, 16, 40
    and 129 (two of the list scan's 128-query tiles, seventeen of the wide
    tier's 8-query tiles), k = 10 and 32 (the list scan) and 100 (the wide
    tier, and the tile scan beside it, the yardstick it is timed against),
    l2, cosine and dot. The data are sixteenths:
    the pools must match bit for bit, the whole entry point too, and the
    lower id must win the planted tie. Returns the max |dv| against the
    plain version."""
    rng = np.random.default_rng(seed + 20)
    n, d = 50_000, DIM
    data = sixteenths(rng, n, d)
    data[2053] = data[2040]
    valid = np.ones(n, bool)
    valid[rng.choice(n, int(0.03 * n), replace=False)] = False
    valid[[2040, 2053]] = True
    ok = torch.from_numpy(valid).to(dev)
    v = torch.from_numpy(data).to(dev)
    nrm = torch.from_numpy((data.astype(np.float64) ** 2).sum(1).astype(
        np.float32)).to(dev)
    err = 0.0
    for b in (1, 5, 16, 40, 129):
        queries = data[rng.choice(n, b, replace=False)].copy()
        queries[0] = data[2040]
        q = torch.from_numpy(queries).to(dev)
        for k in (10, 32, 100):
            for sim in SIMS:
                args = (v, nrm, ok, kb._pad_queries(q, None))
                what = f"knn_block {sim} B={b} k={k}"
                before = (kb.block_list_launches.count,
                          kb.block_wide_launches.count)
                err = max(err, compare_stage1(kb, "knn_block", args, k, sim,
                                              True, what))
                got = (kb.block_list_launches.count - before[0],
                       kb.block_wide_launches.count - before[1])
                if got != ((1, 0) if k <= kb.LIST_MAX_R else (0, 1)):
                    raise AssertionError(f"{what}: (list scan, wide tier) "
                                         f"launches {got}")
                if k > kb.LIST_MAX_R:
                    # K3's tile scan, the yardstick of the wide tier
                    tv, ti = kb._launch_block_tile(*args, k=k, similarity=sim)
                    pv, pi = kb.plain_block_topk(*args, k=k, similarity=sim)
                    if not (torch.equal(ti, pi) and torch.equal(tv, pv)):
                        raise AssertionError(f"{what}: K3's tile scan differs "
                                             f"from plain_block_topk")
                gv, gi = kb.knn_topk_auto(v, nrm, ok, q, k=k, similarity=sim)
                pv, pi = family_plain(kb, "knn_block", v, nrm, ok, q, k, sim)
                if not (torch.equal(gi, pi[:b]) and torch.equal(gv, pv[:b])):
                    raise AssertionError(f"{what}: entry point differs from "
                                         f"its plain pipeline")
                if sim == "l2_norm" and gi[0, :2].tolist() != [2040, 2053]:
                    raise AssertionError(
                        f"{what}: planted tie gave {gi[0, :2].tolist()}")
        log(f"knn_block parity B={b}: bit-equal over k = 10, 32 (list "
            f"scan), 100 (wide tier, and the tile scan) and l2, cosine, dot")
    return err


def unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose data starts 4 bytes past a 16-byte
    boundary: a view the cp.async kernels cannot read as it is."""
    off = 4 // x.element_size()
    flat = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    out = flat[off:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == 4 and out.is_contiguous()
    return out


PB_COPIES = (2040, 2053)                   # a duplicate across a block edge
PB_RUN = tuple(range(6150, 6162))          # 12 equal vectors in block 3


def pb_case(kb, dev, rng, n: int, d: int, exact: bool):
    """K4's parity operands: n sixteenths of width d, 3% dead docs, the
    duplicate PB_COPIES and the run PB_RUN planted; exact=False adds 2^-14
    to every nonzero coordinate (equal on the planted copies), which the
    bf16 rounding of the operands must remove."""
    data = sixteenths(rng, n, d)
    data[list(PB_COPIES)] = data[PB_COPIES[0]]
    data[list(PB_RUN)] = data[PB_RUN[0]]
    valid = np.ones(n, bool)
    valid[rng.choice(n, int(0.03 * n), replace=False)] = False
    valid[[*PB_COPIES, *PB_RUN]] = True
    if not exact:
        jitter = np.where(data != 0, np.where(rng.random((n, d)) < 0.5, 1, -1)
                          * 2.0 ** -14, 0).astype(np.float32)
        jitter[list(PB_COPIES)] = jitter[PB_COPIES[0]]
        jitter[list(PB_RUN)] = jitter[PB_RUN[0]]
        data = data + jitter
    v = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
    nrm = torch.from_numpy((data.astype(np.float64) ** 2).sum(1).astype(
        np.float32)).to(dev)
    return data, v, nrm, torch.from_numpy(valid).to(dev)


def pb_check(kb, v, nrm, ok, q, k: int, sim: str, exact: bool,
             what: str) -> float:
    """K4 on one case: stage 1 bit-equal to plain_pb_topk (ids on finite
    slots), the merge kernel on plain_pb_topk's pools bit-equal to pb_merge,
    and the entry point to the plain pipeline. Returns max |dv|."""
    b = q.shape[0]
    qp = kb._pad_queries(q, kb.PB_QTILE)
    err = compare_stage1(kb, "knn_pb", (v, nrm, ok, qp), k, sim, exact,
                         f"{what} stage 1")
    pools = kb.plain_pb_topk(v, nrm, ok, qp, k=k, similarity=sim,
                             exact=exact)
    got, want = kb.pb_select(*pools, k), kb.pb_merge(*pools, k)
    torch.cuda.synchronize()
    if not all(torch.equal(a, w) for a, w in zip(got, want)):
        raise AssertionError(f"{what}: the merge kernel differs from pb_merge")
    gv, gi = kb.knn_blocktopk_auto(v, nrm, ok, q, k=k, similarity=sim,
                                   exact=exact)
    pv, pi = kb.pb_merge(*pools, k)
    if not (torch.equal(gi, pi[:b]) and torch.equal(gv, pv[:b])):
        raise AssertionError(f"{what}: entry point differs from its plain "
                             f"pipeline")
    if sim != "dot_product":
        if gi[0, :2].tolist() != list(PB_COPIES):
            raise AssertionError(f"{what}: planted tie gave "
                                 f"{gi[0, :2].tolist()}")
        if b > 1 and gi[1, :min(k, 10)].tolist() != list(PB_RUN[:min(k, 10)]):
            raise AssertionError(f"{what}: planted run gave "
                                 f"{gi[1, :10].tolist()}")
    return err


def pb_kernel_phase(kb, dev, seed: int) -> float:
    """K4's two kernels against their plain versions on the card (pb_check
    on each case): n = 50,000 sixteenths (a ragged tail past the 2048-doc
    block), 3% dead docs, a duplicate across a block edge (PB_COPIES) and a
    run of 12 equal vectors inside one block (PB_RUN), queried by the first
    two queries, so k = 10 cuts through the run. At d = 128: B = 1, 5, 8,
    9, 16, 32, 33, 40, 128 and 129 (each query tile 8, 32 and 128, full
    and partial, and two 128-query tiles) x k = 10, 32 (PB_LIST_K, the
    last of the list tier), 33, 100 and 2048 (PB_MAX_K) x l2, cosine, dot x
    exact and not. At d = 30 (padded to 32 by rows_in_16_bytes) and d = 768
    (chunked d, the query tile stepped down): B = 1, 33 and 129 x k = 10
    and 2048 x the three similarities x exact and not. Then operands 4
    bytes off a 16-byte boundary (copied by rows_in_16_bytes). Last n =
    300,000 (147 blocks, more than the CTAs of a query tile, so some CTAs
    walk two blocks): B = 9, 33 and 129 x k = 10 and 32. Returns the max
    |dv|."""
    rng = np.random.default_rng(seed + 23)
    err = 0.0
    widths = ((50_000, DIM, (1, 5, 8, 9, 16, 32, 33, 40, 128, 129),
               (10, 32, 33, 100, 2048)),
              (50_000, 30, (1, 33, 129), (10, 2048)),
              (50_000, 768, (1, 33, 129), (10, 2048)),
              (300_000, DIM, (9, 33, 129), (10, 32)))
    for n, d, bs, ks in widths:
        for exact in (True, False):
            data, v, nrm, ok = pb_case(kb, dev, rng, n, d, exact)
            for b in bs:
                queries = data[rng.choice(n, b, replace=False)].copy()
                queries[0] = data[PB_COPIES[0]]
                if b > 1:
                    queries[1] = data[PB_RUN[0]]
                q = torch.from_numpy(queries).to(dev)
                for k in ks:
                    for sim in SIMS:
                        err = max(err, pb_check(
                            kb, v, nrm, ok, q, k, sim, exact,
                            f"knn_pb d={d} {sim} B={b} k={k} exact={exact}"))
            log(f"K4 parity n={n} d={d} exact={exact}: both kernels and the "
                f"entry point bit-equal at B = {bs}, k = {ks}, l2, cosine, "
                f"dot")
            if n == 50_000 and d == DIM and exact:
                for sim in SIMS:
                    err = max(err, pb_check(
                        kb, unaligned(v), nrm, ok, unaligned(q[:9]), 10, sim,
                        True, f"knn_pb unaligned {sim}"))
                log("K4 parity, operands off a 16-byte boundary: bit-equal")
            del v
            torch.cuda.empty_cache()
    return err


SBMAX_COPIES = (2040, 2053, *range(6041, 50_000, 4001))  # 13 blocks
SBMAX_DEAD = range(4096, 4224)                          # one whole sub-block


def sbmax_kernel_phase(kb, dev, seed: int) -> float:
    """K5's two kernels against their plain versions on the card: n =
    50,000 sixteenths (as blocks_kernel_phase), 3% dead docs plus the
    all-dead sub-block SBMAX_DEAD, one vector planted at the 13 docs
    SBMAX_COPIES (one sub-block in each of 13 blocks, so the queries that
    are that vector see 13 equal maxima and k = 10 cuts through them),
    B = 1, 5, 8,
    9, 16, 32, 33, 40, 128 and 129 (each query tile 8, 32 and 128, full and
    partial, and two 128-query tiles), k = 10, 100 and n_sub = 400 (every
    sub-block, the dead one and those past n included), l2, cosine and dot,
    exact and not. Stage 1 must equal plain_sbmax bit for bit, stage 2
    sbmax_rescore on the same maxima, and the entry point the plain
    pipeline; for the planted query (l2 and cosine) the 10 lowest copies
    come first, in id order. exact=False runs on the data plus 2^-14 (the
    copies keep equal jitter), which the bf16 rounding must remove. Then
    d = 30 (padded to 32 by rows_in_16_bytes) and operands 4 bytes off a
    16-byte boundary, both stages at B = 9, k = 10. Returns the max |dv| of
    stage 1 and the entry point against the plain ones."""
    rng = np.random.default_rng(seed + 22)
    n, d = 50_000, DIM
    base = sixteenths(rng, n, d)
    base[list(SBMAX_COPIES)] = base[SBMAX_COPIES[0]]
    valid = np.ones(n, bool)
    valid[rng.choice(n, int(0.03 * n), replace=False)] = False
    valid[list(SBMAX_DEAD)] = False
    valid[list(SBMAX_COPIES)] = True
    jitter = np.where(base != 0, np.where(rng.random((n, d)) < 0.5, 1, -1)
                      * 2.0 ** -14, 0).astype(np.float32)
    jitter[list(SBMAX_COPIES)] = jitter[SBMAX_COPIES[0]]
    ok = torch.from_numpy(valid).to(dev)
    n_sub = -(-n // kb.PB_BLOCK) * (kb.PB_BLOCK // kb.SUB)
    err = 0.0
    for exact, data in ((True, base), (False, base + jitter)):
        v = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
        nrm = torch.from_numpy((data.astype(np.float64) ** 2).sum(1).astype(
            np.float32)).to(dev)
        for b in (1, 5, 8, 9, 16, 32, 33, 40, 128, 129):
            queries = data[rng.choice(n, b, replace=False)].copy()
            queries[0] = data[SBMAX_COPIES[0]]
            q = torch.from_numpy(queries).to(dev)
            qp = kb._pad_queries(q, kb.PB_QTILE)
            for sim in SIMS:
                what = f"knn_sbmax {sim} B={b} exact={exact}"
                err = max(err, compare_stage1(kb, "knn_sbmax", (v, nrm, ok, qp),
                                              0, sim, exact, what))
                submax = kb.plain_sbmax(v, nrm, ok, qp, similarity=sim,
                                        exact=exact)
                for k in (10, 100, n_sub):
                    what = f"knn_sbmax {sim} B={b} k={k} exact={exact}"
                    got = kb.sbmax_select(submax, v, nrm, ok, qp, k=k,
                                          similarity=sim, exact=exact)
                    want = kb.sbmax_rescore(submax, v, nrm, ok, qp, k=k,
                                            similarity=sim, exact=exact)
                    torch.cuda.synchronize()
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        raise AssertionError(f"{what}: stage 2 differs from "
                                             f"sbmax_rescore")
                    gv, gi = kb.knn_sbmax_auto(v, nrm, ok, q, k=k,
                                               similarity=sim, exact=exact)
                    pv, pi = family_plain(kb, "knn_sbmax", v, nrm, ok, q, k,
                                          sim, exact)
                    if not (torch.equal(gi, pi[:b]) and torch.equal(gv, pv[:b])):
                        raise AssertionError(f"{what}: entry point differs "
                                             f"from its plain pipeline")
                    fin = torch.isfinite(pv[:b])
                    if bool(fin.any()):
                        err = max(err, float((gv[fin] - pv[:b][fin]).abs().max()))
                    if sim != "dot_product" and \
                            gi[0, :10].tolist() != list(SBMAX_COPIES[:10]):
                        raise AssertionError(
                            f"{what}: planted ties gave {gi[0, :10].tolist()}")
            del submax
        # stage 2 with the maxima read from device memory and its k arrays
        # in the scratch, the layout of a row too long for shared memory
        limit, kb.SBMAX_SELECT_SMEM = kb.SBMAX_SELECT_SMEM, 0
        try:
            for k in (10, n_sub):
                submax = kb.plain_sbmax(v, nrm, ok, qp, similarity="l2_norm",
                                        exact=exact)
                got = kb.sbmax_select(submax, v, nrm, ok, qp, k=k,
                                      exact=exact)
                want = kb.sbmax_rescore(submax, v, nrm, ok, qp, k=k,
                                        similarity="l2_norm", exact=exact)
                torch.cuda.synchronize()
                if not all(torch.equal(a, w) for a, w in zip(got, want)):
                    raise AssertionError(f"knn_sbmax stage 2, maxima in device "
                                         f"memory, k={k} exact={exact}: differs "
                                         f"from sbmax_rescore")
        finally:
            kb.SBMAX_SELECT_SMEM = limit
        log(f"K5 parity exact={exact}: both stages and the entry point "
            f"bit-equal at B = 1..129, k = 10, 100, {n_sub}, l2, cosine, dot "
            f"(stage 2 in both shared-memory layouts)")
        del v
        torch.cuda.empty_cache()
    # rows that are not whole 16-byte units (d = 30, padded to 32 by
    # rows_in_16_bytes) and operands 4 bytes off a 16-byte boundary (copied)
    data30 = sixteenths(rng, n, 30)
    cases = (("d=30", torch.from_numpy(data30).to(dev),
              torch.from_numpy(data30[:9].copy()).to(dev)),
             ("unaligned", unaligned(torch.from_numpy(base).to(dev)),
              unaligned(torch.from_numpy(base[:9].copy()).to(dev))))
    for label, v, q in cases:
        nrm = (v.double() ** 2).sum(1).float()
        qp = kb._pad_queries(q, kb.PB_QTILE)
        for exact in (True, False):
            for sim in SIMS:
                what = f"knn_sbmax {label} {sim} exact={exact}"
                err = max(err, compare_stage1(kb, "knn_sbmax", (v, nrm, ok, qp),
                                              0, sim, exact, what))
                submax = kb.plain_sbmax(v, nrm, ok, qp, similarity=sim,
                                        exact=exact)
                got = kb.sbmax_select(submax, v, nrm, ok, qp, k=10,
                                      similarity=sim, exact=exact)
                want = kb.sbmax_rescore(submax, v, nrm, ok, qp, k=10,
                                        similarity=sim, exact=exact)
                torch.cuda.synchronize()
                if not all(torch.equal(a, w) for a, w in zip(got, want)):
                    raise AssertionError(f"{what}: stage 2 differs from "
                                         f"sbmax_rescore")
        log(f"K5 parity {label}: both stages bit-equal (B = 9, k = 10)")
    return err


def blocks_bound(name: str, n: int, d: int, b: int, k: int, nb: int) -> dict:
    """The least time of one call: the slab, norms and valid flags read
    once, the queries, and what the kernel writes (K3 [B, k], K4 [nb, B, k]
    values and ids, K5 [nb, B, 16] maxima), over 3.35 TB/s; against
    2*B*n*d operations over 67 TFLOP/s."""
    out = {"knn_block": 8 * b * k, "knn_pb": 8 * nb * b * k,
           "knn_sbmax": 4 * nb * b * 16}[name]
    nbytes = n * d * 4 + n * 4 + n + b * d * 4 + out
    flops = 2 * b * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def blocks_timing_phase(kb, dev, seed: int, names) -> dict:
    """K3, K4 and K5 (those of `names`) through their entry points at the
    SIFT-1M shape (1,000,000 SIFT-style 128-d f32 docs, l2, k = 10) at
    B = 1 and 32, and
    B = 128 for K4 and K5 (their design tile). First the path run: the
    launch counts are set to 0, each entry point answers once per B, and
    each answer must be the brute-force top-10 in order, scores bit for bit
    (the plain scores and a stable top-10: the data make every dot exact).
    Then, at each of these B, each kernel's stage 1 (K3's pools, K4's
    per-block pools over all 489 blocks, K5's maxima) and K5's stage 2 on
    the plain maxima, and K4's merge kernel on the plain pools, must equal
    their own plain versions bit for bit. Then the CUDA-event time of each
    call, its device time under torch.profiler, the plain pipeline's time,
    the library yardstick (torch.topk over the l2-transformed q @ v.T) and
    the bound. K4 and K5 launch two kernels a call (stage 1 and stage 2,
    each counted), and each stage's device ms is read from the profiler by
    kernel name (STAGE_KERNELS)."""
    rng = np.random.default_rng(seed + 21)
    n, k = SIFT_DOCS, 10
    v = torch.from_numpy(sift_like(rng, n, DIM)).to(dev)
    nrm = (v.double() ** 2).sum(1).float()
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    q_all = torch.clamp(torch.round(
        v[torch.from_numpy(rng.choice(n, 128, replace=False)).to(dev)]
        + torch.from_numpy(rng.normal(0, 4, (128, DIM)).astype(np.float32))
        .to(dev)), 0, 255)
    sizes = {name: bs for name, bs in (("knn_block", (1, 32, 128)),
                                       ("knn_pb", (1, 32, 128)),
                                       ("knn_sbmax", (1, 32, 128)))
             if name in names}
    second = {"knn_pb": kb.pb_merge_launches,
              "knn_sbmax": kb.sbmax_select_launches}
    for counter in (kb.block_launches, kb.block_list_launches,
                    kb.pb_launches, kb.sbmax_launches, *second.values()):
        counter.reset()
    for name, bs in sizes.items():
        for b in bs:
            q = q_all[:b].contiguous()
            tv, ti = getattr(kb, FAMILY_ENTRY[name])(v, nrm, ok, q, k=k)
            bv, bi = kb.plain_block_topk(v, nrm, ok, q, k=k,
                                         similarity="l2_norm")
            if not (torch.equal(ti, bi) and torch.equal(tv, bv)):
                raise AssertionError(f"{name} B={b}: not the brute-force "
                                     f"top-10 in order")
    launches = {"knn_block": kb.block_launches.count,
                "knn_pb": kb.pb_launches.count,
                "knn_sbmax": kb.sbmax_launches.count}
    stage2_launches = {name: c.count for name, c in second.items()}
    if "knn_block" in sizes and \
            kb.block_list_launches.count != launches["knn_block"]:
        raise AssertionError(f"K3 at k = {k}: {kb.block_list_launches.count} "
                             f"of {launches['knn_block']} launches took the "
                             f"list scan")
    for name, bs in sizes.items():
        if launches[name] != len(bs):
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{len(bs)} calls")
        if name in second and stage2_launches[name] != len(bs):
            raise AssertionError(f"{name} stage 2: {stage2_launches[name]} "
                                 f"launches in {len(bs)} calls")
    log(f"K3/K4/K5 at the SIFT-1M shape: brute-force top-10 in order; "
        f"launches {launches}")
    out = {name: {"launches": launches[name], "stage1_err": 0.0}
           for name in sizes}
    for name in second.keys() & out.keys():
        out[name]["stage2_launches"] = stage2_launches[name]
    for name, bs in sizes.items():
        qtile = None if name == "knn_block" else kb.PB_QTILE
        for b in bs:
            args = (v, nrm, ok, kb._pad_queries(q_all[:b].contiguous(), qtile))
            out[name]["stage1_err"] = max(out[name]["stage1_err"],
                                          compare_stage1(
                kb, name, args, k, "l2_norm", True,
                f"{name} SIFT-1M shape B={b} stage 1"))
            if name == "knn_sbmax":
                submax = kb.plain_sbmax(*args, similarity="l2_norm")
                got = kb.sbmax_select(submax, *args, k=k)
                want = kb.sbmax_rescore(submax, *args, k=k,
                                        similarity="l2_norm")
                torch.cuda.synchronize()
                if not all(torch.equal(a, w) for a, w in zip(got, want)):
                    raise AssertionError(f"knn_sbmax SIFT-1M shape B={b}: "
                                         f"stage 2 differs from sbmax_rescore")
            if name == "knn_pb":
                pools = kb.plain_pb_topk(*args, k=k, similarity="l2_norm")
                got, want = kb.pb_select(*pools, k), kb.pb_merge(*pools, k)
                torch.cuda.synchronize()
                if not all(torch.equal(a, w) for a, w in zip(got, want)):
                    raise AssertionError(f"knn_pb SIFT-1M shape B={b}: the "
                                         f"merge kernel differs from pb_merge")
    log("K3/K4/K5 at the SIFT-1M shape: stage 1 (and K4's and K5's stage 2) "
        "bit-equal to the plain versions at every B")
    nb = -(-n // kb.PB_BLOCK)
    for name, bs in sizes.items():
        entry = getattr(kb, FAMILY_ENTRY[name])
        for b in bs:
            q = q_all[:b].contiguous()
            clock0 = mem_clock()
            ms = time_ms(lambda: entry(v, nrm, ok, q, k=k), 10)
            plain_ms = time_ms(lambda: family_plain(kb, name, v, nrm, ok, q, k),
                               3)
            qsq = (q * q).sum(1)

            def library():
                d_sq = torch.clamp(qsq[:, None] - 2.0 * (q @ v.T) + nrm[None],
                                   min=0.0)
                return torch.topk(1.0 / (1.0 + d_sq), k)

            library_ms = time_ms(library, 10)
            prof = device_profile(lambda: entry(v, nrm, ok, q, k=k), 5)
            bound = blocks_bound(name, n, DIM, b, k, nb)
            out[name][b] = {"ms": ms, "plain_ms": plain_ms,
                            "library_ms": library_ms,
                            "device_ms": prof and prof["device_ms"], **bound}
            if name == "knn_block":
                # the tile scan on the same call, for the two designs side
                # by side
                qp = kb._pad_queries(q, None)
                tv, ti = kb._launch_block_tile(v, nrm, ok, qp, k=k,
                                               similarity="l2_norm")
                pv, pi = kb.plain_block_topk(v, nrm, ok, qp, k=k,
                                             similarity="l2_norm")
                if not (torch.equal(ti, pi) and torch.equal(tv, pv)):
                    raise AssertionError(f"knn_block SIFT-1M shape B={b}: "
                                         f"the tile scan differs from "
                                         f"plain_block_topk")
                tile = time_ms(lambda: kb._launch_block_tile(
                    v, nrm, ok, qp, k=k, similarity="l2_norm"), 10)
                out[name][b]["tile_ms"] = tile
                log(f"knn_block SIFT-1M shape B={b}: tile scan {tile:.4f} "
                    f"ms")
            out[name][b]["mem_clock"] = [clock0, mem_clock()]
            if name in STAGE_KERNELS:
                for key, part in zip(("stage1_device_ms", "stage2_device_ms"),
                                     STAGE_KERNELS[name]):
                    out[name][b][key] = kernel_ms(prof, part)
                log(f"{name} SIFT-1M shape B={b}: stage 1 device "
                    f"{out[name][b]['stage1_device_ms']} ms, stage 2 device "
                    f"{out[name][b]['stage2_device_ms']} ms")
            log(f"{name} SIFT-1M shape B={b}: {ms:.4f} ms (device "
                f"{out[name][b]['device_ms']}), plain {plain_ms:.4f} ms, "
                f"library {library_ms:.4f} ms, bound {bound['bound_ms']:.4f} "
                f"ms ({bound['bound_by']}); top kernels "
                f"{prof and prof['top']}")
    del v
    torch.cuda.empty_cache()
    return out


# the attribute columns of the filtering specs of the k-NN plugin's
# perf-tool (faiss-hnsw/filtering relaxed-filter and restrictive-filter on
# SIFT-128): age integer 0-99, color one of 6 keywords, taste one of 4
COLORS = ("red", "green", "blue", "yellow", "white", "black")
TASTES = ("sweet", "salty", "sour", "bitter")


def attributes(rng, n: int) -> dict:
    """Each doc's age, color and taste indices, uniform, from the seed."""
    return {"age": rng.integers(0, 100, n), "color": rng.integers(0, 6, n),
            "taste": rng.integers(0, 4, n)}


def attribute_mapping() -> dict:
    return {"age": {"type": "integer"}, "color": {"type": "keyword"},
            "taste": {"type": "keyword"}}


def attribute_doc(attrs: dict, i: int) -> dict:
    return {"age": int(attrs["age"][i]),
            "color": COLORS[int(attrs["color"][i])],
            "taste": TASTES[int(attrs["taste"][i])]}


def _bulk_index(node, name: str, data: np.ndarray, shards: int,
                attrs: dict | None = None) -> None:
    props = {"v": {"type": "knn_vector", "dimension": data.shape[1],
                   "similarity": "l2_norm"}}
    if attrs is not None:
        props.update(attribute_mapping())
    node.create_index(name, {
        "settings": {"number_of_shards": shards},
        "mappings": {"properties": props},
    })
    for s in range(0, data.shape[0], 5000):
        resp = node.bulk([
            ("index", {"_index": name, "_id": str(i)},
             {"v": data[i].tolist(),
              **(attribute_doc(attrs, i) if attrs is not None else {})})
            for i in range(s, min(s + 5000, data.shape[0]))
        ], refresh=False)
        if resp["errors"]:
            raise AssertionError(f"bulk into [{name}] reported errors")
    node.refresh(name)


def main_path_phase(kf, dev, seed: int) -> dict:
    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.ops import knn_rescore as kr
    from opensearch_tpu_torch.search import distributed_serving

    rng = np.random.default_rng(seed + 2)
    corpora = {"sift_a": (clustered(rng, 200_000, DIM), 1),
               "sift_b": (clustered(rng, 20_000, DIM), 4)}
    # cell A carries the filtering specs' attribute columns
    attrs_a = attributes(rng, 200_000)
    out = {}
    step_inputs = {}
    truths = {}
    ingest_s = {}
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device="cuda")
        for name, (data, shards) in corpora.items():
            t0 = time.perf_counter()
            _bulk_index(node, name, data, shards,
                        attrs_a if name == "sift_a" else None)
            ingest_s[name] = time.perf_counter() - t0
            log(f"[{name}] {data.shape[0]} docs, {shards} shard(s)"
                f"{' with age, color, taste' if name == 'sift_a' else ''}: "
                f"bulk + refresh {ingest_s[name]:.1f} s")
        # the counts are read for the searches alone
        searches0 = distributed_serving.stats["distributed_searches"]
        kf.launches.reset()
        kf.list_launches.reset()
        kr.sq_launches.reset()
        for name, (data, _shards) in corpora.items():
            queries = (data[rng.choice(data.shape[0], 64, replace=False)]
                       + 0.05 * rng.standard_normal((64, DIM)).astype(np.float32))
            lat = []
            hits = []
            for qv in queries:
                t0 = time.perf_counter()
                resp = node.search(name, {"query": {"knn": {"v": {
                    "vector": qv.tolist(), "k": 10}}}, "size": 10})
                lat.append(time.perf_counter() - t0)
                hits.append([h["_id"] for h in resp["hits"]["hits"]])
            out[name] = lat
            # brute-force truth: the plain version on the card, docs in id order
            v = torch.from_numpy(data)[None].to(dev)
            nrm = torch.from_numpy((data.astype(np.float64) ** 2).sum(1).astype(
                np.float32))[None].to(dev)
            ok = torch.ones((1, data.shape[0]), dtype=torch.bool, device=dev)
            q = torch.from_numpy(queries).to(dev)
            step_inputs[name] = (v, nrm, ok, q[:1])
            _tv, ti = kf.plain_pool(v, nrm, ok, q, kr.plain_query_sq(q),
                                    torch.ones(1, device=dev), r=10,
                                    similarity="l2_norm",
                                    score_precision="fp32")
            truth = [[str(int(i)) for i in row] for row in ti[0].cpu()]
            truths[name] = (queries, truth)
            if hits != truth:
                bad = next(i for i, (h, t) in enumerate(zip(hits, truth)) if h != t)
                raise AssertionError(
                    f"[{name}] query {bad}: hits {hits[bad]} != truth {truth[bad]}")
            lat_ms = np.asarray(lat) * 1e3
            log(f"[{name}] 64 searches: recall@10 = 1.0 (same order), p50 "
                f"{np.percentile(lat_ms, 50):.3f} ms, p99 "
                f"{np.percentile(lat_ms, 99):.3f} ms, QPS {64 / sum(lat):.1f}")
        launches = kf.launches.count
        list_launches = kf.list_launches.count
        sq_launches = kr.sq_launches.count
        searches = distributed_serving.stats["distributed_searches"] - searches0
        per_shard = per_shard_exact_phase(node, kf, *truths["sift_a"])
        wide = wide_main_phase(node, kf, corpora["sift_a"][0],
                               truths["sift_a"][0], step_inputs["sift_a"])
        reduced = reduced_main_phase(node, kf, truths["sift_a"][0],
                                     step_inputs["sift_a"])
        batched = stacked_batch_phase(node, kf, truths["sift_a"][0])
        msearch = msearch_main_phase(node, kf, truths["sift_a"][0])
        rest = rest_main_phase(node, kf, truths["sift_a"][0],
                               corpora["sift_b"][0], per_shard)
        filtered = filtered_main_phase(node, kf, attrs_a,
                                       truths["sift_a"][0],
                                       step_inputs["sift_a"], rng)
        large = large_main_phase(node, kf, corpora["sift_a"][0],
                                 truths["sift_a"][0], step_inputs["sift_a"],
                                 rng)
        cell_a: dict = {}
        contexts, node = contexts_main_phase(
            node, kf, tmp, corpora["sift_a"][0], attrs_a,
            truths["sift_a"][0], corpora["sift_b"][0], rng, keep=cell_a)
        # the brute-force operands this phase keeps on the card for the
        # device-step timing below: device bytes outside the ledger
        held = {"bytes": sum(t.numel() * t.element_size()
                             for inputs in step_inputs.values()
                             for t in inputs),
                "what": [f"{name} (v, norms, valid, query): "
                         f"{sum(t.numel() * t.element_size() for t in ts)} B"
                         for name, ts in step_inputs.items()]}
        kept: dict = {}
        ops = ops_main_phase(node, kf, seed, held, keep=kept)
        admin = admin_main_phase(node, kf, seed, kept, truths["sift_a"][0],
                                 truths["sift_b"][0], drop=False)
        backup = backup_main_phase(node, kf, seed, kept, truths["sift_a"][0],
                                   cell_a)
        node.close()
    # the device step of one search alone (operand prep, scan, top-k), at
    # each index's shape, beside the whole search's latency above: CUDA-event
    # ms over a window of 20 steps (the window of the earlier records) and
    # of 200 (host-bound at these sizes, so the window moves the reading),
    # and the profiler's device ms of the step's kernels, with the tile
    # scan's on the same operands beside the list scan's
    step_ms, step_device = {}, {}
    for name, (v, nrm, ok, q) in step_inputs.items():
        def step():
            return kf.knn_fused_stacked(v, nrm, ok, q, k=10,
                                        similarity="l2_norm")

        args, r = scan_inputs(kf, v, nrm, ok, q, 10, "fp32")
        step_ms[name] = {"window_20": time_ms(step, 20),
                         "window_200": time_ms(step, 200)}
        prof = device_profile(step, 10)
        tile_prof = device_profile(lambda: kf._launch_tile(
            *args, r=r, similarity="l2_norm", score_precision="fp32"), 10)
        step_device[name] = {
            "device_ms": prof and prof["device_ms"],
            "scan_device_ms": kernel_ms(prof, LIST_KERNELS[0]),
            "merge_device_ms": kernel_ms(prof, LIST_KERNELS[1]),
            "tile_scan_device_ms": tile_prof and tile_prof["device_ms"]}
        log(f"[{name}] device step of one search (B=1, n={v.shape[1]}): "
            f"{step_ms[name]} ms; profiler {step_device[name]}")
    if searches != 128:
        raise AssertionError(f"{searches} of 128 searches took the serving path")
    if launches < 128:
        raise AssertionError(f"the kernel launched {launches} times in 128 searches")
    if list_launches != launches:
        raise AssertionError(f"{list_launches} of {launches} K1 launches of "
                             f"the stacked step took the list scan")
    if sq_launches != launches:
        raise AssertionError(f"|q|^2 launched {sq_launches} times in "
                             f"{launches} K1 launches")
    log(f"main path: {searches} served searches, {launches} kernel launches, "
        f"all {list_launches} on K1's list scan (knn_pool.cuh), "
        f"{sq_launches} |q|^2 launches")
    rest["step_device_ms"] = step_device["sift_a"]["device_ms"]
    log(f"[sift_a] the HTTP profile's K1 launch: device_time_in_nanos "
        f"{rest['profile']['device_time_in_nanos']} (the fenced launch, its "
        f"copy to the host included) beside the profiler's device ms of "
        f"the step: {rest['step_device_ms']}")
    return {"launches": launches, "list_launches": list_launches,
            "query_sq_launches": sq_launches, "ingest_s": ingest_s,
            "latency_s": out, "step_ms": step_ms,
            "step_device": step_device, "per_shard": per_shard,
            "wide": wide, "reduced": reduced, "batched": batched,
            "msearch": msearch, "rest": rest, "filtered": filtered,
            "large": large, "contexts": contexts, "ops": ops,
            "admin": admin, "backup": backup}


def filtered_phase(kf, dev, seed: int) -> dict:
    """Index A alone, built as main_path_phase builds it (200,000 clustered
    128-d docs with the age, color and taste columns), one unfiltered
    search to build its serving bundle, then stacked_batch_phase,
    msearch_main_phase, filtered_main_phase and large_main_phase: the
    quick loop for filtered kNN, msearch and the stacked step past
    r = 1024 (``--phases filtered``)."""
    from opensearch_tpu_torch.node import TorchNode

    rng = np.random.default_rng(seed + 2)
    data = clustered(rng, 200_000, DIM)
    attrs = attributes(rng, 200_000)
    queries = (data[rng.choice(200_000, 64, replace=False)]
               + 0.05 * rng.standard_normal((64, DIM)).astype(np.float32))
    v = torch.from_numpy(data)[None].to(dev)
    nrm = (v.double() ** 2).sum(2).float()
    ok = torch.ones((1, 200_000), dtype=torch.bool, device=dev)
    step_input = (v, nrm, ok, torch.from_numpy(queries[:1]).to(dev))
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device="cuda")
        t0 = time.perf_counter()
        _bulk_index(node, "sift_a", data, 1, attrs)
        log(f"[sift_a] 200000 docs with age, color, taste: bulk + refresh "
            f"{time.perf_counter() - t0:.1f} s")
        node.search("sift_a", {"query": {"knn": {"v": {
            "vector": queries[0].tolist(), "k": 10}}}})
        out = {"batched": stacked_batch_phase(node, kf, queries),
               "msearch": msearch_main_phase(node, kf, queries),
               "filtered": filtered_main_phase(node, kf, attrs, queries,
                                               step_input, rng),
               "large": large_main_phase(node, kf, data, queries, step_input,
                                         rng)}
        node.close()
    return out


def wide_main_phase(node, kf, data: np.ndarray, queries: np.ndarray,
                    step_input: tuple) -> dict:
    """Index A at k = 100 on both serving routes, K1 on its wide tier:
    64 searches through the stacked step (k = 100, size = 100: r = 100,
    B = 1), then on the per-shard route (distributed_serving.enabled off)
    32 searches at k = 100 (k_bucket 128: r = 128) and 8 threads x 8
    searches through the batcher (concurrent_phase, gated and
    free-running, size = 100). Every hit list must equal the brute-force
    top-100 in order, summed in the kernel's order (kernel_order_pool:
    plain_pool's cuBLAS order ranks some neighbours the other way at this
    depth, each such slot logged with its f64 scores), the concurrent ones
    their solo ones, and every K1
    launch of these searches must be on the wide tier: the counts are set
    to 0 just before each path and read just after. Logs p50, p99 and QPS,
    and the step's device ms by kernel name beside the tile scan's on the
    same operands (its pools first held to kernel_order_pool, tile_check)."""
    from opensearch_tpu_torch.ops import knn_rescore as kr
    from opensearch_tpu_torch.search import distributed_serving, executor

    k = 100
    v, nrm, ok, _q = step_input
    q = torch.from_numpy(queries).to(v.device)
    # |q|^2 as the serving step computes it: the fixed-order plain version
    # (the kernel's bits, with no launch outside the searches)
    qsq = kr.plain_query_sq(q)
    tv, ti = kernel_order_pool(kf, v, nrm, ok, q, qsq, k, "l2_norm")
    truth = [[str(int(i)) for i in row] for row in ti[0].cpu()]
    # where cuBLAS's summation order (plain_pool) ranks neighbours the
    # other way: logged with both docs' f64 scores, not gated
    _pv, pi = kf.plain_pool(v, nrm, ok, q, qsq, torch.ones(1, device=v.device),
                            r=k, similarity="l2_norm", score_precision="fp32")
    gaps = []
    for s, b, j in (ti != pi).nonzero().tolist():
        a, c = exact_scores(kf, v, nrm, q, qsq, "l2_norm", s, b,
                            [int(ti[s, b, j]), int(pi[s, b, j])])
        gaps.append(abs(a - c) / max(abs(a), abs(c)))
    log(f"[sift_a] k={k}: the kernel-order top-{k} differs from plain_pool's "
        f"at {len(gaps)} of {ti.numel()} slots, f64 relative gaps up to "
        f"{max(gaps, default=0.0):.3g}")
    del data, tv

    def run(n: int, what: str) -> dict:
        lat = []
        for i, qv in enumerate(queries[:n]):
            t0 = time.perf_counter()
            resp = node.search("sift_a", {"query": {"knn": {"v": {
                "vector": qv.tolist(), "k": k}}}, "size": k})
            lat.append(time.perf_counter() - t0)
            hits = [h["_id"] for h in resp["hits"]["hits"]]
            if hits != truth[i]:
                raise AssertionError(f"[sift_a] {what} k={k} query {i}: "
                                     f"hits differ from the brute-force "
                                     f"top-{k}")
        return latency_summary(lat)

    def counts() -> dict:
        return {"knn_fused": kf.launches.count,
                "knn_fused_wide": kf.wide_launches.count}

    out = {}
    searches0 = distributed_serving.stats["distributed_searches"]
    kf.launches.reset()
    kf.wide_launches.reset()
    out["stacked"] = run(64, "stacked")
    out["stacked"]["launches"] = counts()
    served = distributed_serving.stats["distributed_searches"] - searches0
    if served != 64 or out["stacked"]["launches"]["knn_fused"] < 64:
        raise AssertionError(f"[sift_a] k={k}: {served} of 64 searches on "
                             f"the stacked step, launches "
                             f"{out['stacked']['launches']}")
    distributed_serving.enabled = False
    try:
        fused0 = executor.knn_path_stats["fused"]
        kf.launches.reset()
        kf.wide_launches.reset()
        out["per_shard"] = run(32, "per-shard")
        out["per_shard"]["launches"] = counts()
        if executor.knn_path_stats["fused"] - fused0 != 32:
            raise AssertionError(f"[sift_a] per-shard k={k}: not every "
                                 f"search took the fused kernel")
        out["concurrent"] = concurrent_phase(
            node, "sift_a", queries, k,
            {"knn_fused": kf.launches, "knn_fused_wide": kf.wide_launches},
            size=k)
    finally:
        distributed_serving.enabled = True
    for what, run_counts in (
            ("stacked", out["stacked"]["launches"]),
            ("per-shard", out["per_shard"]["launches"]),
            ("concurrent gated", out["concurrent"]["gated"]["launches"]),
            ("concurrent", out["concurrent"]["launches"])):
        if run_counts["knn_fused_wide"] != run_counts["knn_fused"]:
            raise AssertionError(f"[sift_a] {what} k={k}: K1 launches not "
                                 f"all on the wide tier: {run_counts}")
    # the stacked step at k = 100 on the device, by kernel name
    qs = q[:1]
    args, r = scan_inputs(kf, v, nrm, ok, qs, k, "fp32")
    tile_check(kf, args, r, f"[sift_a] step k={k}")
    step = functools.partial(kf.knn_fused_stacked, v, nrm, ok, qs, k=k,
                             similarity="l2_norm")
    prof = device_profile(step, 10)
    tile_prof = device_profile(functools.partial(
        kf._launch_tile, *args, r=r, similarity="l2_norm",
        score_precision="fp32"), 10)
    out["step_ms"] = {"window_20": time_ms(step, 20),
                      "window_200": time_ms(step, 200)}
    out["step_device"] = {
        "device_ms": prof and prof["device_ms"],
        "scan_device_ms": kernel_ms(prof, WIDE_KERNELS[0]),
        "merge_device_ms": kernel_ms(prof, WIDE_KERNELS[1]),
        "tile_device_ms": tile_prof and tile_prof["device_ms"],
        "tile_scan_device_ms": kernel_ms(tile_prof, TILE_KERNELS[0]),
        "tile_merge_device_ms": kernel_ms(tile_prof, TILE_KERNELS[1])}
    log(f"[sift_a] k={k}: stacked {out['stacked']}, per-shard "
        f"{out['per_shard']}: every hit list the brute-force top-{k} in "
        f"order, every K1 launch on the wide tier; step {out['step_ms']} ms, "
        f"device {out['step_device']}")
    return out


# k of the reduced-precision main path, and its searches a route
REDUCED_KS = (10, 100)
REDUCED_STACKED = 32
REDUCED_PER_SHARD = 16


def pool_ties(kf, slab, q, r: int, prec: str, what: str,
              bound: bool = False) -> list:
    """Where a search's hits differ from the plain pipeline's at bf16: the
    kernel's and plain_pool's pools of R for the query on the same slab,
    every doc in one and not the other a summation tie (summation_ties,
    `bound` passed on) at the pool's R-th score. Returns the ties."""
    args = reduced_args(kf, *slab, q, prec)
    kv, ki = kf.pool_scan(*args, r=r, similarity="l2_norm",
                          score_precision=prec)
    pv, pi = kf.plain_pool(*args, r=r, similarity="l2_norm",
                           score_precision=prec)
    torch.cuda.synchronize()
    if set(ki.flatten().tolist()) == set(pi.flatten().tolist()):
        raise AssertionError(f"{what}: the hits differ though the pools hold "
                             f"the same docs")
    return summation_ties(kf, kv, ki, pv, pi, args, "l2_norm", what, bound)


def reduced_main_phase(node, kf, queries: np.ndarray,
                       step_input: tuple) -> dict:
    """Index A at search.knn.score_precision bf16, then int8 (set through
    ann.default_config as the port's tests set it; fp32 restored after),
    on both serving routes, K1 on the wide tier's tensor-core scan: at
    k = 10 and k = 100 (size = k), 32 searches through the stacked step
    (R = 40 / 400), 16 on the per-shard route (k_bucket 16 / 128: R = 64 /
    512) and the 64 searches from 8 threads through the batcher, gated
    only (concurrent_phase: each equal to its solo search bit for bit, the
    exact fp32 rescore of a batch summed in the solo order by the
    fixed-order rescore kernel). Every K1 launch
    of each path, counted from 0, is on the tensor-core tier. Each solo
    hit list equals the plain pipeline's on the node's own slab (the
    stacked step's bundle: knn_fused_stacked with impl="xla" at the same
    precision and k, its exact fp32 rescore, the top k) in order; at bf16
    a differing list is allowed only where the two pools differ by
    summation ties (pool_ties), each logged. Recall@k against the fp32
    brute force is printed, not gated. Then one stacked step a precision
    and k on the device by kernel name: the whole step, and its parts
    alone: the operand prep (cast or quantize), the scan and merge (by
    name), and the exact rescore (the fixed-order rescore kernel with its
    |q|^2 launch, and the top-k: its kernels by name)."""
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry
    from opensearch_tpu_torch.ops import knn_rescore as kr
    from opensearch_tpu_torch.search import ann, distributed_serving, executor

    v, nrm, ok, _q = step_input
    n = v.shape[1]
    bundles = [b for key, b in default_registry._bundles.items()
               if key[0] == "sift_a"]
    if len(bundles) != 1:
        raise AssertionError(f"[sift_a] {len(bundles)} serving bundles")
    bundle = bundles[0]
    # a one-card node's bundle: one slot
    slab = (bundle.slot_vectors[0], bundle.slot_norms_sq[0],
            bundle.slot_valid[0])
    # flat slot i of the one-segment bundle is doc "i"
    if not torch.equal(slab[0][0, :n], v[0]) or \
            int(slab[2][0].sum()) != n:
        raise AssertionError("[sift_a] the bundle is not the docs in id order")
    dev = v.device
    qt = torch.from_numpy(queries).to(dev)
    one = torch.ones(1, device=dev)
    truth = {k: kf.plain_pool(v, nrm, ok, qt, (qt * qt).sum(1), one, r=k,
                              similarity="l2_norm",
                              score_precision="fp32")[1][0].tolist()
             for k in REDUCED_KS}

    def plain_hits(i: int, k: int, prec: str) -> list:
        _vals, ids = kf.knn_fused_stacked(*slab, qt[i:i + 1], k=k,
                                          similarity="l2_norm",
                                          score_precision=prec, impl="xla")
        return [str(int(x)) for x in ids[0, 0].tolist() if x >= 0]

    def counts() -> dict:
        return {"knn_fused": kf.launches.count,
                "knn_fused_mma": kf.mma_launches.count,
                "knn_rescore": kr.launches.count,
                "knn_query_sq": kr.sq_launches.count}

    def run(m: int, k: int, k_route: int, prec: str, what: str) -> dict:
        for counter in (kf.launches, kf.mma_launches, kr.launches,
                        kr.sq_launches):
            counter.reset()
        lat, recall, ties = [], [], 0
        for i, qv in enumerate(queries[:m]):
            t0 = time.perf_counter()
            resp = node.search("sift_a", {"query": {"knn": {"v": {
                "vector": qv.tolist(), "k": k}}}, "size": k})
            lat.append(time.perf_counter() - t0)
            hits = [h["_id"] for h in resp["hits"]["hits"]]
            want = plain_hits(i, k_route, prec)[:k]
            if hits != want:
                label = f"[sift_a] {what} {prec} k={k} query {i}"
                if prec != "bf16":
                    raise AssertionError(f"{label}: hits differ from the "
                                         f"plain pipeline's")
                r = kf.fused_pool_width(k_route, prec)
                for tie in pool_ties(kf, slab, qt[i:i + 1], r, prec, label):
                    ties += 1
                    log(f"{label}: hits differ from the plain pipeline's at "
                        f"a summation tie of the pool {tie}")
            recall.append(len(set(hits) & {str(x) for x in truth[k][i]}) / k)
        out = latency_summary(lat)
        out.update(launches=counts(), recall=float(np.mean(recall)),
                   summation_ties=ties)
        return out

    out = {}
    try:
        for prec in REDUCED:
            ann.default_config.configure(score_precision=prec)
            for k in REDUCED_KS:
                key = f"{prec} k={k}"
                res = out[key] = {}
                searches0 = distributed_serving.stats["distributed_searches"]
                res["stacked"] = run(REDUCED_STACKED, k, k, prec, "stacked")
                served = (distributed_serving.stats["distributed_searches"]
                          - searches0)
                if served != REDUCED_STACKED:
                    raise AssertionError(f"[sift_a] {key}: {served} of "
                                         f"{REDUCED_STACKED} searches on the "
                                         f"stacked step")
                k_bucket = 1 << (k - 1).bit_length()
                distributed_serving.enabled = False
                try:
                    fused0 = executor.knn_path_stats["fused"]
                    res["per_shard"] = run(REDUCED_PER_SHARD, k, k_bucket,
                                           prec, "per-shard")
                    if executor.knn_path_stats["fused"] - fused0 != \
                            REDUCED_PER_SHARD:
                        raise AssertionError(f"[sift_a] per-shard {key}: not "
                                             f"every search took K1")
                    res["concurrent"] = concurrent_phase(
                        node, "sift_a", queries, k,
                        {"knn_fused": kf.launches,
                         "knn_fused_mma": kf.mma_launches,
                         "knn_rescore": kr.launches,
                         "knn_query_sq": kr.sq_launches},
                        size=k, reduced=True)
                finally:
                    distributed_serving.enabled = True
                for what, want, got in (
                        ("stacked", REDUCED_STACKED,
                         res["stacked"]["launches"]),
                        ("per-shard", REDUCED_PER_SHARD,
                         res["per_shard"]["launches"]),
                        ("concurrent gated", None,
                         res["concurrent"]["gated"]["launches"])):
                    if got["knn_fused_mma"] != got["knn_fused"] or (
                            want is not None and got["knn_fused"] != want) \
                            or got["knn_rescore"] != got["knn_fused"] \
                            or got["knn_query_sq"] != got["knn_fused"]:
                        raise AssertionError(
                            f"[sift_a] {what} {key}: K1 launches not one a "
                            f"search, all on the tensor-core tier, each with "
                            f"one |q|^2 and one rescore launch: {got}")
                log(f"[sift_a] {key}: stacked {res['stacked']}, per-shard "
                    f"{res['per_shard']}, gated "
                    f"{res['concurrent']['gated']}: every K1 launch on the "
                    f"tensor-core tier, hits the plain pipeline's")
    finally:
        ann.default_config.configure(score_precision="fp32")
    # one stacked step a precision and k on the device, whole and by parts
    q1 = qt[:1]
    for prec in REDUCED:
        for k in REDUCED_KS:
            r = kf.fused_pool_width(k, prec)
            args = reduced_args(kf, *slab, q1, prec)
            _pv, pi = kf.pool_scan(*args, r=r, similarity="l2_norm",
                                   score_precision=prec)
            step = device_profile(functools.partial(
                kf.knn_fused_stacked, *slab, q1, k=k, similarity="l2_norm",
                score_precision=prec), 10)
            prep = device_profile(functools.partial(
                kf._prep_operands, slab[0], q1, prec), 10)
            scan = device_profile(functools.partial(
                kf.pool_scan, *args, r=r, similarity="l2_norm",
                score_precision=prec), 10)
            rescore = device_profile(functools.partial(
                kf._fused_rescore, q1, *slab, pi, k=k,
                similarity="l2_norm"), 10)
            einsum = device_profile(functools.partial(
                einsum_rescore, kf, q1, *slab, pi, k, "l2_norm"), 10)
            split = {
                "step_ms": time_ms(functools.partial(
                    kf.knn_fused_stacked, *slab, q1, k=k,
                    similarity="l2_norm", score_precision=prec), 20),
                "step_device_ms": step and step["device_ms"],
                "step_kernels": step and step["top"],
                "prep_device_ms": prep and prep["device_ms"],
                "prep_kernels": prep and prep["top"],
                "scan_device_ms": kernel_ms(scan, MMA_KERNELS[0]),
                "merge_device_ms": kernel_ms(scan, MMA_KERNELS[1]),
                "rescore_device_ms": rescore and rescore["device_ms"],
                "rescore_kernels": rescore and rescore["top"],
                "einsum_rescore_device_ms": einsum and einsum["device_ms"]}
            out[f"{prec} k={k}"]["step"] = split
            log(f"[sift_a] stacked step {prec} k={k} (B=1, "
                f"{bundle.n_flat} slots) device split: {json.dumps(split)}")
    return out


def stacked_batch_phase(node, kf, queries: np.ndarray) -> dict:
    """The stacked step's batch against its solo launches (the reference
    batcher's contract on the route with no dispatch batcher): index A,
    distributed_serving.mesh_knn_batch with 8 queries in one launch, then
    each alone, at fp32, bf16 and int8 and k = 10 and 100. Every query's
    device-merged hits (score, shard, segment, doc) must equal its solo
    launch's bit for bit; one K1 launch a batch."""
    from opensearch_tpu_torch.search import ann, distributed_serving
    from opensearch_tpu_torch.search.query_dsl import KnnQuery

    (shard,) = node.indices["sift_a"].shards.values()
    snaps = [shard.acquire_searcher()]
    nodes = [KnnQuery(field="v", vector=qv.tolist(), k=0)
             for qv in queries[:8]]

    def rows(out) -> list:
        return [[(h.score, si, h.segment, h.doc) for si, h in row]
                for row in out.premerged]

    out = {}
    try:
        for prec in ("fp32", *REDUCED):
            ann.default_config.configure(score_precision=prec)
            for k in REDUCED_KS:
                for q in nodes:
                    q.k = k
                kf.launches.reset()
                batch = distributed_serving.mesh_knn_batch(
                    [shard], snaps, nodes, k)
                launches = kf.launches.count
                solo = [rows(distributed_serving.mesh_knn_batch(
                    [shard], snaps, [q], k))[0] for q in nodes]
                got = rows(batch)
                if launches != 1:
                    raise AssertionError(f"[sift_a] stacked batch {prec} "
                                         f"k={k}: {launches} K1 launches")
                for i, (g, w) in enumerate(zip(got, solo)):
                    if g != w:
                        raise AssertionError(
                            f"[sift_a] stacked batch {prec} k={k} query {i}: "
                            f"not its solo hits bit for bit")
                out[f"{prec} k={k}"] = {"queries": len(nodes),
                                        "launches": launches}
    finally:
        ann.default_config.configure(score_precision="fp32")
    log(f"[sift_a] stacked step, 8 queries a launch: every query's hits its "
        f"solo launch's bit for bit at {sorted(out)}")
    return out


# the filters of the filtered main phase: the perf-tool's relaxed (about
# 40% of docs) and restrictive (about 1%) specs, and 50 ids
FILTER_IDS = 50


def filter_bodies(rng, n: int) -> dict:
    """(filter body, its docs as a numpy predicate over the attributes) by
    name; the ids filter's 50 docs drawn from the seed."""
    ids = np.sort(rng.choice(n, FILTER_IDS, replace=False))
    return {
        "relaxed": ({"bool": {"filter": [
            {"range": {"age": {"gte": 20, "lt": 80}}},
            {"terms": {"color": list(COLORS[:4])}}]}},
            lambda a: (a["age"] >= 20) & (a["age"] < 80) & (a["color"] < 4)),
        "restrictive": ({"bool": {"filter": [
            {"range": {"age": {"gte": 30, "lt": 40}}},
            {"term": {"color": COLORS[0]}}],
            "must_not": [{"term": {"taste": TASTES[2]}}]}},
            lambda a: (a["age"] >= 30) & (a["age"] < 40) & (a["color"] == 0)
            & (a["taste"] != 2)),
        "ids": ({"ids": {"values": [str(int(i)) for i in ids]}},
                lambda a: np.isin(np.arange(len(a["age"])), ids)),
    }


FILTERED_QUERIES = 8


def filtered_main_phase(node, kf, attrs: dict, queries: np.ndarray,
                        step_input: tuple, rng) -> dict:
    """Filtered kNN on index A (a filter inside the knn clause), through
    the stacked step and the per-shard route (distributed_serving off):
    the relaxed, restrictive and ids filters (filter_bodies), 8 searches
    each at fp32 k = 10 and 100 (size = k) and at bf16 and int8 k = 10.
    Every hit list must equal, in order, the brute force over the filtered
    docs summed in the kernel's order (fp32: kernel_order_scores on the
    docs the filter admits) or the plain pipeline on the node's slab with
    the filter's docs as valid (bf16, int8: knn_fused_stacked impl="xla";
    bf16 but at logged summation ties of the pool, pool_ties); the ids
    filter at k = 100 returns exactly its 50 docs. Each search launches K1
    exactly once, on the tier scan_tier names (counted from 0 on
    list_launches, wide_launches, mma_launches), and every stacked search
    counts in distributed_serving.stats["filtered"]. Logs the segment's
    device bytes by column kind and each run's p50 on the host clock; then
    the device ms of the stacked mask build
    (_filter_valid_mask) and of the step over the filtered slab beside the
    unfiltered step's, by kernel name."""
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry
    from opensearch_tpu_torch.ops import knn_rescore as kr
    from opensearch_tpu_torch.search import (ann, distributed_serving,
                                             query_dsl)

    v, nrm, ok, _q = step_input
    n, dev = v.shape[1], v.device
    (bundle,) = [b for key, b in default_registry._bundles.items()
                 if key[0] == "sift_a"]
    filters_ = filter_bodies(rng, n)
    (shard,) = node.indices["sift_a"].shards.values()
    out = {"column_nbytes": [dev_seg.column_nbytes() for _host, dev_seg
                             in shard.acquire_searcher().segments]}
    log(f"[sift_a] device bytes by column kind: {out['column_nbytes']}")
    qt = torch.from_numpy(queries[:FILTERED_QUERIES]).to(dev)
    qsq = kr.plain_query_sq(qt)
    tier_counter = {"lists": kf.list_launches, "wide": kf.wide_launches,
                    "mma": kf.mma_launches}
    fkeys = (("fp32", 10), ("fp32", 100), ("bf16", 10), ("int8", 10))
    try:
        for fname, (body, pred) in filters_.items():
            mask = torch.from_numpy(pred(attrs)).to(dev)
            eligible = int(mask.sum())
            eligible_ids = {str(int(x)) for x in mask.nonzero()[:, 0].tolist()}
            valid_f = ok & mask[None]
            slab_valid = bundle.slot_valid[0].clone()
            slab_valid[0, :n] &= mask
            slab = (bundle.slot_vectors[0], bundle.slot_norms_sq[0],
                    slab_valid)
            scores = kernel_order_scores(kf, v, nrm, valid_f, qt, qsq,
                                         "l2_norm")
            for prec, k in fkeys:
                ann.default_config.configure(score_precision=prec)
                truth = [[str(int(i)) for i in row if i >= 0]
                         for row in order_top(kf, scores, k)[1][0].tolist()]
                for route in ("stacked", "per_shard"):
                    distributed_serving.enabled = route == "stacked"
                    k_route = k if route == "stacked" \
                        else 1 << (k - 1).bit_length()
                    r = kf.fused_pool_width(k_route, prec)
                    tier = kf.scan_tier(prec, r)
                    label = f"[sift_a] filtered {fname} {route} {prec} k={k}"
                    for c in (kf.launches, *tier_counter.values()):
                        c.reset()
                    filtered0 = distributed_serving.stats["filtered"]
                    lat, ties = [], 0
                    for i in range(FILTERED_QUERIES):
                        t0 = time.perf_counter()
                        resp = node.search("sift_a", {"query": {"knn": {"v": {
                            "vector": queries[i].tolist(), "k": k,
                            "filter": body}}}, "size": k})
                        lat.append(time.perf_counter() - t0)
                        hits = [h["_id"] for h in resp["hits"]["hits"]]
                        if prec == "fp32":
                            want = truth[i]
                        else:
                            _vals, ids = kf.knn_fused_stacked(
                                *slab, qt[i:i + 1], k=k_route,
                                similarity="l2_norm", score_precision=prec,
                                impl="xla")
                            want = [str(int(x)) for x in ids[0, 0].tolist()
                                    if x >= 0][:k]
                        if hits != want:
                            if prec != "bf16":
                                raise AssertionError(f"{label} query {i}: "
                                                     f"hits differ from the "
                                                     f"brute force")
                            for tie in pool_ties(kf, slab, qt[i:i + 1], r,
                                                 prec, f"{label} query {i}"):
                                ties += 1
                                log(f"{label} query {i}: summation tie {tie}")
                        if not set(hits) <= eligible_ids:
                            raise AssertionError(f"{label} query {i}: a hit "
                                                 f"outside the filter")
                        if fname == "ids" and k >= FILTER_IDS and \
                                len(hits) != FILTER_IDS:
                            raise AssertionError(f"{label} query {i}: "
                                                 f"{len(hits)} hits of the "
                                                 f"{FILTER_IDS} docs")
                    got = {"knn_fused": kf.launches.count,
                           tier: tier_counter[tier].count,
                           "filtered": distributed_serving.stats["filtered"]
                           - filtered0}
                    want_f = FILTERED_QUERIES if route == "stacked" else 0
                    if got["knn_fused"] != FILTERED_QUERIES or \
                            got[tier] != FILTERED_QUERIES or \
                            got["filtered"] != want_f:
                        raise AssertionError(f"{label}: not one K1 launch a "
                                             f"search on the {tier} tier, "
                                             f"{want_f} filtered: {got}")
                    res = latency_summary(lat)
                    res.update(launches=got, tier=tier, eligible=eligible,
                               summation_ties=ties)
                    out[f"{fname} {route} {prec} k={k}"] = res
                    log(f"{label}: hits equal the brute force over the "
                        f"{eligible} filtered docs; {json.dumps(res)}")
            del scores
    finally:
        distributed_serving.enabled = True
        ann.default_config.configure(score_precision="fp32")
    # the device side of one filtered stacked search at k = 10
    snaps = [shard.acquire_searcher()]
    q1 = qt[:1]
    for fname in ("relaxed", "restrictive"):
        flt = query_dsl.parse_query(filters_[fname][0])
        mask_prof = device_profile(functools.partial(
            distributed_serving._filter_valid_mask, [shard], snaps, flt,
            None, bundle.n_flat, [dev]), 10)
        (fmask,) = distributed_serving._filter_valid_mask(
            [shard], snaps, flt, None, bundle.n_flat, [dev])
        fvalid = bundle.slot_valid[0] & fmask
        step_f = device_profile(functools.partial(
            kf.knn_fused_stacked, bundle.slot_vectors[0],
            bundle.slot_norms_sq[0], fvalid, q1, k=10,
            similarity="l2_norm"), 10)
        step_u = device_profile(functools.partial(
            kf.knn_fused_stacked, bundle.slot_vectors[0],
            bundle.slot_norms_sq[0], bundle.slot_valid[0], q1, k=10,
            similarity="l2_norm"), 10)
        out[f"{fname} device"] = {
            "mask_device_ms": mask_prof and mask_prof["device_ms"],
            "mask_wall_ms": mask_prof and mask_prof["wall_ms"],
            "mask_kernels": mask_prof and mask_prof["top"],
            "step_device_ms": step_f and step_f["device_ms"],
            "unfiltered_step_device_ms": step_u and step_u["device_ms"],
            "step_kernels": step_f and step_f["top"]}
        log(f"[sift_a] filtered {fname} stacked k=10 device: "
            f"{json.dumps(out[f'{fname} device'])}")
    return out


# the stacked step past the wide tier: k on the 768-d index, and on cell A
LARGE_MAIN_KS = (1025, 2000, 4096)
LARGE_MAIN_DOCS = 20_000
LARGE_MAIN_CELL_A_K = 10_000


def large_main_phase(node, kf, data_a: np.ndarray, queries_a: np.ndarray,
                     step_input: tuple, rng) -> dict:
    """The stacked step at fp32 past r = 1024, K1 on its large-r tier:
    node.search at k = 1025, 2000 and 4096 (size = k) on a 768-d l2 index of
    20,000 clustered docs (one shard: 32,768 slots), 4 searches each, and at
    k = 10,000 on index A (262,144 slots), 2 searches; then k = 5,000 on an
    index of 1,500 docs with 20 deleted (2,048 slots: r = n_flat), which
    must return every live doc. Every hit list is the brute force summed in
    the kernel's order (kernel_order_scores, order_top) in order, and each
    search launches K1 exactly once, on the large-r tier (counted from 0).
    Logs the p50 of each k on the host clock."""
    from opensearch_tpu_torch.ops import knn_rescore as kr

    dev = step_input[0].device
    data768 = clustered(rng, LARGE_MAIN_DOCS, 768)
    small = clustered(rng, 1500, DIM)
    t0 = time.perf_counter()
    _bulk_index(node, "wide768", data768, 1)
    _bulk_index(node, "small", small, 1)
    deleted = [str(int(i)) for i in rng.choice(1500, 20, replace=False)]
    node.bulk([("delete", {"_index": "small", "_id": d}, None)
               for d in deleted], refresh=True)
    log(f"[wide768] {LARGE_MAIN_DOCS} 768-d docs and [small] 1,500 docs: "
        f"bulk + refresh {time.perf_counter() - t0:.1f} s")

    def brute(data: np.ndarray, qs: np.ndarray, k: int, valid=None):
        v = torch.from_numpy(data)[None].to(dev)
        nrm = (v.double() ** 2).sum(2).float()
        ok = torch.ones((1, data.shape[0]), dtype=torch.bool, device=dev) \
            if valid is None else valid
        q = torch.from_numpy(qs).to(dev)
        scores = kernel_order_scores(kf, v, nrm, ok, q, kr.plain_query_sq(q),
                                     "l2_norm")
        return [[str(int(i)) for i in row if i >= 0]
                for row in order_top(kf, scores, k)[1][0].tolist()]

    def run(name: str, qs: np.ndarray, k: int, truth: list) -> dict:
        counters = (kf.launches, kf.large_launches, kf.large_select_launches,
                    kf.yardstick_launches)
        for c in counters:
            c.reset()
        lat = []
        for i, qv in enumerate(qs):
            t0 = time.perf_counter()
            resp = node.search(name, {"query": {"knn": {"v": {
                "vector": qv.tolist(), "k": k}}}, "size": k,
                "_source": False})
            lat.append(time.perf_counter() - t0)
            hits = [h["_id"] for h in resp["hits"]["hits"]]
            if hits != truth[i]:
                bad = next((j for j, (a, b) in enumerate(zip(hits, truth[i]))
                            if a != b), min(len(hits), len(truth[i])))
                raise AssertionError(f"[{name}] k={k} query {i}: hits differ "
                                     f"from the kernel-order brute force at "
                                     f"rank {bad} ({len(hits)} hits)")
        got = [c.count for c in counters]
        if got != [len(qs), len(qs), len(qs), 0]:
            raise AssertionError(f"[{name}] k={k}: (K1, large-r tier, its "
                                 f"multi-CTA select, the yardstick) launched "
                                 f"{got} times in {len(qs)} searches")
        res = latency_summary(lat)
        res["launches"] = {"knn_fused": got[0], "knn_fused_large": got[1],
                           "knn_large_select": got[2],
                           "knn_large_yardstick": got[3]}
        log(f"[{name}] k={k}: {len(qs)} searches, every hit list the "
            f"kernel-order brute force, one large-r launch each; "
            f"{json.dumps(res)}")
        return res

    out = {}
    q768 = (data768[rng.choice(LARGE_MAIN_DOCS, 4, replace=False)]
            + 0.05 * rng.standard_normal((4, 768)).astype(np.float32))
    for k in LARGE_MAIN_KS:
        out[f"wide768 k={k}"] = run("wide768", q768, k,
                                    brute(data768, q768, k))
    qa = queries_a[:2]
    out[f"sift_a k={LARGE_MAIN_CELL_A_K}"] = run(
        "sift_a", qa, LARGE_MAIN_CELL_A_K,
        brute(data_a, qa, LARGE_MAIN_CELL_A_K))
    live = torch.ones((1, 1500), dtype=torch.bool, device=dev)
    live[0, [int(d) for d in deleted]] = False
    qs = small[:2] + 0.05
    truth = brute(small, qs, 2048, live)
    if any(len(t) != 1480 for t in truth):
        raise AssertionError("[small] the brute force lost a live doc")
    out["small k=5000"] = run("small", qs, 5000, truth)
    out.update(large_reduced_main(node, kf, q768[:2], qa))
    return out


# the search-contexts phase (contexts_main_phase): searches of each gate
CONTEXT_QUERIES = 16
CONTEXT_DELETES = 1_000       # deleted under an open PIT, among the top hits
CONTEXT_WRITES = 100          # docs written through the write alias
CONTEXT_PAGES = 4             # queries paged by search_after on _shard_doc
CONTEXT_SCROLL_K = 1_000
CONTEXT_SCROLL_SIZE = 100
CONTEXT_ALTERNATIONS = 4      # PIT / live kNN pairs
CONTEXT_CACHE_REPEATS = 15
CONTEXT_CACHE_MISSES = 8
CONTEXT_THREADS = 8
CONTEXT_B_DELETES = 200       # deleted in index B before its force merge
CONTEXT_WLM_CPU = 0.05        # the group's share: 3 of wlm's 64 permits


def _ctx_hits(resp: dict) -> list:
    """(_id, _score) of each hit, the scores as the JSON floats they are."""
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


def _ctx_knn(qv, k: int, **extra) -> dict:
    return {"query": {"knn": {"v": {"vector": qv.tolist(), "k": k}}},
            "size": k, "_source": False, **extra}


def contexts_main_phase(node, kf, data_path: str, data_a: np.ndarray,
                        attrs_a: dict, queries: np.ndarray,
                        data_b: np.ndarray, rng,
                        keep: dict | None = None) -> tuple:
    """Search contexts, aliases and admission on cell A and B, after the
    other phases of the main node (its deletes and writes change cell A,
    so every truth is computed after the change it follows):

    1. filtered aliases: ``a_red`` (term color) in process and ``a_age``
       (range age) through POST /_aliases over the port's HTTP server;
       16 kNN searches at k = 10 and 16 at k = 100 through each, every
       search one K1 launch on the tier scan_tier names, counted in
       distributed_serving.stats["filtered"], its hits the same kNN with
       the filter in knn.filter bit for bit and the brute force over the
       filter's docs summed in the kernel's order (kernel_order_scores)
       in order; 4 of each over HTTP equal to in process;
    2. the request cache (while cell A has one segment): size 0, kNN
       k = 100, terms on color and a histogram on age: the miss one K1
       launch, 15 hits none and equal to the miss as JSON, a write (a
       delete) + refresh a miss with one launch, POST /_cache/clear
       empties it; hit and miss p50; then a write alias takes 100 docs
       through _bulk, seen only after a refresh;
    3. point in time: a PIT on A, 1,000 of the current top hits deleted
       and refreshed, 16 kNN searches through the PIT the pre-delete hits
       bit for bit, the live index the post-delete brute force;
       search_after on [_score, _shard_doc] in pages of 10 over a k = 100
       kNN through the PIT concatenating to the one-shot hits; the
       shard-mesh registry's builds and each search's host ms over 4 PIT
       / live alternations; memory_allocated beside the ledger's resident
       bytes before, during and after the PIT;
    4. scroll: a k = 1,000 kNN at size 100 with scroll=1m, its 10 pages
       the one-shot size 1,000 hits bit for bit, one K1 launch a page;
       clear_scroll frees the context;
    5. admission: 8 threads x 8 kNN searches under an enforced workload
       group admitting 3, each admitted search its solo bits, each
       rejection the reference's 429; no task left registered; the
       in-flight breaker at 0 after an HTTP _msearch of 32; a search
       cancelled as its task registers raises task_cancelled_exception
       and launches no K1;
    6. settings and restart: PUT /_cluster/settings (a persistent batcher
       key, a transient cache size) takes effect; _flush both indices,
       close the node, open a new TorchNode on the path with no device
       argument: the indices, doc counts, aliases and the persistent key
       come back on the card, the transient one does not, and 16 kNN
       searches on each index equal the pre-restart bits through K1;
       then a PIT on B held across _forcemerge?max_num_segments=1 (after
       200 deletes): the hits the same bits, the device memory the PIT
       holds above the ledger released by close_pit.

    With `keep` (a dict), `keep` gets cell A's rows (`vecs`, the writes
    appended) and their `live` mask as the phase leaves them.

    Returns (record, the reopened node)."""
    import gc

    from opensearch_tpu_torch.cluster.shard_mesh import default_registry
    from opensearch_tpu_torch.common.errors import OpenSearchTpuException
    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.ops import knn_rescore as kr
    from opensearch_tpu_torch.rest.http import HttpServer
    from opensearch_tpu_torch.search import distributed_serving
    from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

    t_phase = time.perf_counter()
    dev = node.device
    # what a tensor on the node's device names its device (cuda:0)
    dev_name = str(torch.empty(0, device=dev).device)
    out: dict = {}
    # the earlier phases' other indices leave: the restart below reopens
    # cell A and B alone
    extra = sorted(n for n in node.indices if n not in ("sift_a", "sift_b"))
    if extra:
        node.delete_index(",".join(extra))
    out["deleted_before"] = extra
    n_a = data_a.shape[0]
    vecs = data_a.copy()
    attrs = {k: np.asarray(v).copy() for k, v in attrs_a.items()}
    live = np.ones(n_a, bool)
    qs = queries[:CONTEXT_QUERIES]
    qt = torch.from_numpy(qs).to(dev)
    qsq = kr.plain_query_sq(qt)
    tier_counter = {"lists": kf.list_launches, "wide": kf.wide_launches,
                    "mma": kf.mma_launches}

    def brute(valid: np.ndarray, k: int, q=None, q_sq=None) -> list:
        v = torch.from_numpy(vecs)[None].to(dev)
        nrm = (v.double() ** 2).sum(2).float()
        ok = torch.from_numpy(valid)[None].to(dev)
        scores = kernel_order_scores(kf, v, nrm, ok, qt if q is None else q,
                                     qsq if q_sq is None else q_sq, "l2_norm")
        return [[str(int(i)) for i in row if i >= 0]
                for row in order_top(kf, scores, k)[1][0].tolist()]

    def k1_run(label: str, fn, n: int, tier: str | None,
               filtered: int | None = None) -> dict:
        """fn() over n searches, counted from 0: one K1 launch each (on
        `tier` when named), `filtered` of them counted filtered."""
        for c in (kf.launches, *tier_counter.values()):
            c.reset()
        f0 = distributed_serving.stats["filtered"]
        result = fn()
        got = {"knn_fused": kf.launches.count,
               "filtered": distributed_serving.stats["filtered"] - f0}
        if tier is not None:
            got[tier] = tier_counter[tier].count
        if got["knn_fused"] != n or (tier is not None and got[tier] != n) \
                or (filtered is not None and got["filtered"] != filtered):
            raise AssertionError(f"{label}: {got} launches in {n} searches "
                                 f"(want one K1 launch each on {tier}, "
                                 f"{filtered} filtered)")
        return {"launches": got, "result": result}

    server = HttpServer(node, "127.0.0.1", 0)
    server.start_in_thread()
    client = RestClient(server.port)
    try:
        # -- 1. filtered aliases -------------------------------------------
        t0 = time.perf_counter()
        red = {"term": {"color": COLORS[0]}}
        age = {"range": {"age": {"gte": 30, "lt": 60}}}
        node.update_aliases({"actions": [
            {"add": {"index": "sift_a", "alias": "a_red", "filter": red}}]})
        client.ok("POST", "/_aliases", {"actions": [
            {"add": {"index": "sift_a", "alias": "a_age", "filter": age}}]})
        aliases = client.ok("GET", "/sift_a/_alias")
        if set(aliases["sift_a"]["aliases"]) != {"a_red", "a_age"}:
            raise AssertionError(f"GET /sift_a/_alias: {aliases}")
        preds = {"a_red": (red, attrs["color"] == 0),
                 "a_age": (age, (attrs["age"] >= 30) & (attrs["age"] < 60))}
        for alias, (flt, pred) in preds.items():
            for k in (10, 100):
                r = kf.fused_pool_width(k, "fp32")
                tier = kf.scan_tier("fp32", r)
                label = f"[sift_a] alias {alias} k={k}"
                truth = brute(live & pred, k)
                lat = []

                def through_alias():
                    got = []
                    for i in range(CONTEXT_QUERIES):
                        t1 = time.perf_counter()
                        got.append(_ctx_hits(node.search(alias, _ctx_knn(
                            qs[i], k))))
                        lat.append(time.perf_counter() - t1)
                    return got

                def body_filter():
                    return [_ctx_hits(node.search("sift_a", {"query": {
                        "knn": {"v": {"vector": qs[i].tolist(), "k": k,
                                      "filter": flt}}},
                        "size": k, "_source": False}))
                        for i in range(CONTEXT_QUERIES)]

                via = k1_run(label, through_alias, CONTEXT_QUERIES, tier,
                             CONTEXT_QUERIES)
                body = k1_run(f"{label} knn.filter", body_filter,
                              CONTEXT_QUERIES, tier, CONTEXT_QUERIES)
                for i in range(CONTEXT_QUERIES):
                    if via["result"][i] != body["result"][i]:
                        raise AssertionError(f"{label} query {i}: not the "
                                             f"knn.filter search's bits")
                    if [h for h, _s in via["result"][i]] != truth[i]:
                        raise AssertionError(f"{label} query {i}: not the "
                                             f"brute force over the filter: "
                                             f"{via['result'][i]} != "
                                             f"{truth[i]}")
                for i in range(4):
                    got = client.ok("POST", f"/{alias}/_search",
                                    _ctx_knn(qs[i], k))
                    if _ctx_hits(got) != via["result"][i]:
                        raise AssertionError(f"{label} query {i}: HTTP "
                                             f"differs from in process")
                res = latency_summary(lat)
                res.update(launches=via["launches"], tier=tier,
                           eligible=int((live & pred).sum()))
                out[f"alias {alias} k={k}"] = res
                log(f"{label}: 16 searches, one filtered K1 launch each on "
                    f"the {tier} tier, the knn.filter bits and the brute "
                    f"force; 4 over HTTP the same; {json.dumps(res)}")
        # -- 2. request cache ------------------------------------------------
        t0 = time.perf_counter()
        cache_body = {"size": 0, "query": {"knn": {"v": {
            "vector": qs[1].tolist(), "k": 100}}},
            "aggs": {"colors": {"terms": {"field": "color"}},
                     "ages": {"histogram": {"field": "age",
                                            "interval": 10}}}}

        def timed_search() -> tuple:
            t1 = time.perf_counter()
            resp = node.search("sift_a", cache_body)
            return resp, time.perf_counter() - t1

        def launches_of(fn) -> tuple:
            kf.launches.reset()
            res = fn()
            return res, kf.launches.count

        node.request_cache.clear()
        (miss, miss_s), n_miss = launches_of(timed_search)
        miss_launches = [n_miss]
        hit_s, hit_launches = [], 0
        for _ in range(CONTEXT_CACHE_REPEATS):
            (got, dt), n = launches_of(timed_search)
            hit_s.append(dt)
            hit_launches += n
            if json_view(got) != json_view(miss):
                raise AssertionError("request cache: a hit differs from "
                                     "its miss as JSON")
        # a write (a delete: the index keeps one segment, so a miss stays
        # one K1 launch) and a refresh move the generation
        gone = int(rng.choice(np.flatnonzero(live)))
        node.delete_doc("sift_a", str(gone))
        node.refresh("sift_a")
        live[gone] = False
        (_r, dt), n_write = launches_of(timed_search)
        miss_launches.append(n_write)
        miss_lat = [miss_s, dt]
        for _ in range(CONTEXT_CACHE_MISSES - 2):
            node.request_cache.clear()
            (_r, dt), n = launches_of(timed_search)
            miss_lat.append(dt)
            miss_launches.append(n)
        cleared = client.ok("POST", "/_cache/clear")
        stats = node.request_cache.stats()
        if miss_launches != [1] * CONTEXT_CACHE_MISSES or hit_launches != 0 \
                or cleared["cleared"] < 1 or stats["entries"] != 0:
            raise AssertionError(f"request cache: misses {miss_launches}, "
                                 f"hits {hit_launches} launches (the second "
                                 f"miss after a write); cleared {cleared}, "
                                 f"{stats}")
        out["cache"] = {"miss_launches": miss_launches,
                        "hit_launches": hit_launches,
                        "hit": latency_summary(hit_s),
                        "miss": latency_summary(miss_lat),
                        "wall_s": time.perf_counter() - t0}
        log(f"[sift_a] request cache: the miss one K1 launch, "
            f"{CONTEXT_CACHE_REPEATS} hits none and the miss's JSON, a write "
            f"+ refresh a miss; {json.dumps(out['cache'])}")

        # a write alias takes CONTEXT_WRITES docs, visible after a refresh
        node.update_aliases({"actions": [{"add": {
            "index": "sift_a", "alias": "a_write", "is_write_index": True}}]})
        new = (data_a[rng.choice(n_a, CONTEXT_WRITES, replace=False)]
               + 0.01 * rng.standard_normal((CONTEXT_WRITES, DIM))
               .astype(np.float32))
        new_attrs = attributes(rng, CONTEXT_WRITES)
        ids = [str(n_a + j) for j in range(CONTEXT_WRITES)]
        resp = node.bulk([("index", {"_index": "a_write", "_id": ids[j]},
                           {"v": new[j].tolist(),
                            **attribute_doc(new_attrs, j)})
                          for j in range(CONTEXT_WRITES)])
        if resp["errors"] or {it["index"]["_index"] for it in resp["items"]} \
                != {"sift_a"}:
            raise AssertionError("the write alias's _bulk did not land in "
                                 "sift_a")

        def nearest(j: int) -> str:
            return node.search("a_write", _ctx_knn(new[j], 1))["hits"][
                "hits"][0]["_id"]

        before = [nearest(j) for j in range(4)]
        node.refresh("a_write")
        after = [nearest(j) for j in range(4)]
        if any(b == ids[j] for j, b in enumerate(before)) or \
                after != ids[:4]:
            raise AssertionError(f"write alias: before refresh {before}, "
                                 f"after {after}")
        vecs = np.concatenate([vecs, new])
        attrs = {k: np.concatenate([attrs[k], new_attrs[k]]) for k in attrs}
        live = np.concatenate([live, np.ones(CONTEXT_WRITES, bool)])
        out["aliases_s"] = time.perf_counter() - t0
        log(f"[sift_a] write alias: {CONTEXT_WRITES} docs through _bulk, "
            f"unseen before the refresh, the nearest after it; aliases "
            f"{out['aliases_s']:.1f} s")

        # -- 3. point in time ------------------------------------------------
        t0 = time.perf_counter()
        mem0 = (torch.cuda.memory_allocated(), default_ledger.resident_bytes())
        pit = client.ok("POST", "/sift_a/_search/point_in_time?keep_alive=5m")
        pid = pit["pit_id"]
        mem1 = (torch.cuda.memory_allocated(), default_ledger.resident_bytes())
        pre_truth = brute(live, 10)
        pre_100 = brute(live, 100)
        pre = [_ctx_hits(node.search("sift_a", _ctx_knn(qs[i], 10)))
               for i in range(CONTEXT_QUERIES)]
        if [[h for h, _s in p] for p in pre] != pre_truth:
            raise AssertionError("[sift_a] pre-delete hits are not the "
                                 "brute force")
        top = list(dict.fromkeys(h for row in pre_100 for h in row))
        victims = top[:CONTEXT_DELETES]
        if len(victims) < CONTEXT_DELETES:
            pool = np.setdiff1d(np.flatnonzero(live),
                                np.asarray(victims, np.int64))
            victims += [str(int(x)) for x in rng.choice(
                pool, CONTEXT_DELETES - len(victims), replace=False)]
        resp = node.bulk([("delete", {"_index": "sift_a", "_id": d}, None)
                          for d in victims], refresh=True)
        if resp["errors"]:
            raise AssertionError("deleting under the PIT reported errors")
        live[np.asarray(victims, np.int64)] = False
        post_truth = brute(live, 10)

        def pit_search(i: int, k: int = 10, **extra) -> dict:
            return node.search(None, {"pit": {"id": pid},
                                      **_ctx_knn(qs[i], k, **extra)})

        pit_run = k1_run("[sift_a] PIT", lambda: [
            _ctx_hits(pit_search(i)) for i in range(CONTEXT_QUERIES)],
            CONTEXT_QUERIES, "lists")
        live_run = k1_run("[sift_a] live after the deletes", lambda: [
            _ctx_hits(node.search("sift_a", _ctx_knn(qs[i], 10)))
            for i in range(CONTEXT_QUERIES)], CONTEXT_QUERIES, "lists")
        for i in range(CONTEXT_QUERIES):
            if pit_run["result"][i] != pre[i]:
                raise AssertionError(f"[sift_a] PIT query {i}: not the "
                                     f"pre-delete bits")
            if [h for h, _s in live_run["result"][i]] != post_truth[i]:
                raise AssertionError(f"[sift_a] live query {i}: not the "
                                     f"post-delete brute force")
        # search_after on _shard_doc in pages of 10 over a k = 100 kNN
        sort = [{"_score": "desc"}, {"_shard_doc": "asc"}]
        for i in range(CONTEXT_PAGES):
            whole = pit_search(i, 100, sort=sort)
            pages, after_key = [], None
            for _p in range(10):
                extra_ = {"sort": sort}
                if after_key is not None:
                    extra_["search_after"] = after_key
                page = node.search(None, {"pit": {"id": pid}, **_ctx_knn(
                    qs[i], 100, **extra_), "size": 10})
                pages.extend(_ctx_hits(page))
                after_key = page["hits"]["hits"][-1]["sort"]
            if pages != _ctx_hits(whole) or \
                    [h for h, _s in pages] != pre_100[i]:
                raise AssertionError(f"[sift_a] PIT query {i}: search_after "
                                     f"pages are not the one-shot k=100 "
                                     f"hits")
        # PIT / live alternation: each rebuilds its generation's slab
        builds0 = default_registry.stats["builds"]
        alt = []
        for j in range(CONTEXT_ALTERNATIONS):
            for kind in ("pit", "live"):
                t1 = time.perf_counter()
                hits = _ctx_hits(pit_search(j) if kind == "pit" else
                                 node.search("sift_a", _ctx_knn(qs[j], 10)))
                alt.append((kind, (time.perf_counter() - t1) * 1e3))
                want = pre[j] if kind == "pit" else live_run["result"][j]
                if hits != want:
                    raise AssertionError(f"[sift_a] alternation {j} {kind}: "
                                         f"not its generation's bits")
        builds = default_registry.stats["builds"] - builds0
        mem2 = (torch.cuda.memory_allocated(), default_ledger.resident_bytes())
        closed = client.ok("DELETE", "/_search/point_in_time",
                           {"pit_id": [pid]})
        if closed["pits"] != [{"pit_id": pid, "successful": True}] or \
                node.list_all_pits()["pits"]:
            raise AssertionError(f"close PIT: {closed}")
        gc.collect()
        mem3 = (torch.cuda.memory_allocated(), default_ledger.resident_bytes())
        out["pit"] = {
            "deleted": CONTEXT_DELETES, "pit_launches": pit_run["launches"],
            "live_launches": live_run["launches"],
            "alternation_builds": builds,
            "alternation_ms": [round(ms, 3) for _k, ms in alt],
            "memory_allocated": [mem0[0], mem1[0], mem2[0], mem3[0]],
            "ledger_resident": [mem0[1], mem1[1], mem2[1], mem3[1]],
            "wall_s": time.perf_counter() - t0}
        log(f"[sift_a] PIT: 16 searches the pre-delete bits after "
            f"{CONTEXT_DELETES} deletes, the live index the post-delete "
            f"brute force, search_after pages of 10 the one-shot k=100 "
            f"hits; {json.dumps(out['pit'])}")

        # -- 4. scroll -------------------------------------------------------
        t0 = time.perf_counter()
        k, size = CONTEXT_SCROLL_K, CONTEXT_SCROLL_SIZE
        r = kf.fused_pool_width(k, "fp32")
        tier = kf.scan_tier("fp32", r)
        one = k1_run("[sift_a] scroll one-shot", lambda: node.search(
            "sift_a", _ctx_knn(qs[0], k)), 1, tier)["result"]
        per_page = []
        pages = []
        for c in (kf.launches, *tier_counter.values()):
            c.reset()
        resp = client.ok("POST", "/sift_a/_search?scroll=1m",
                         {**_ctx_knn(qs[0], k), "size": size})
        sid = resp["_scroll_id"]
        while resp["hits"]["hits"]:
            per_page.append(kf.launches.count)
            pages.extend(_ctx_hits(resp))
            resp = client.ok("POST", "/_search/scroll",
                             {"scroll_id": sid, "scroll": "1m"})
        launches = np.diff([0] + per_page).tolist()
        if pages != _ctx_hits(one) or len(pages) != k or \
                launches != [1] * (k // size):
            raise AssertionError(f"[sift_a] scroll: {len(pages)} hits, "
                                 f"launches a page {launches}")
        cleared = client.ok("DELETE", "/_search/scroll", {"scroll_id": sid})
        if cleared["num_freed"] != 1 or any(
                c["kind"] == "scroll" for c in node._reader_contexts.values()):
            raise AssertionError(f"clear_scroll: {cleared}")
        out["scroll"] = {"pages": len(launches), "launches_a_page": launches,
                         "tier": tier, "wall_s": time.perf_counter() - t0}
        log(f"[sift_a] scroll k={k} size={size}: {len(launches)} pages the "
            f"one-shot hits, K1 launches a page {launches} ({tier} tier); "
            f"clear_scroll freed it")

        # -- 5. admission ----------------------------------------------------
        t0 = time.perf_counter()
        group = client.ok("PUT", "/_wlm/query_group", {
            "name": "ctx", "resiliency_mode": "enforced",
            "resource_limits": {"cpu": CONTEXT_WLM_CPU}})["query_group"]
        solo = [_ctx_hits(node.search("sift_a", _ctx_knn(qs[i], 10)))
                for i in range(CONTEXT_THREADS)]
        barrier = threading.Barrier(CONTEXT_THREADS)
        results: dict = {}

        def worker(t: int) -> None:
            got = []
            for _round in range(8):
                barrier.wait()
                try:
                    got.append(_ctx_hits(node.search(
                        "sift_a", _ctx_knn(qs[t], 10), query_group="ctx")))
                except OpenSearchTpuException as e:
                    got.append((e.status, e.error_type))
            results[t] = got

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(CONTEXT_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        admitted = rejected = 0
        for t, got in results.items():
            for g in got:
                if isinstance(g, tuple):
                    if g != (429, "rejected_execution_exception"):
                        raise AssertionError(f"admission: thread {t}: {g}")
                    rejected += 1
                elif g != solo[t]:
                    raise AssertionError(f"admission: thread {t}: not its "
                                         f"solo bits")
                else:
                    admitted += 1
        if admitted + rejected != CONTEXT_THREADS * 8 or admitted == 0 or \
                node.task_manager.list_tasks():
            raise AssertionError(f"admission: {admitted} admitted, "
                                 f"{rejected} rejected, tasks "
                                 f"{node.task_manager.list_tasks()}")
        totals = node.query_groups.totals().get(group["_id"], {})
        lines = []
        for i in range(32):
            lines += [{"index": "sift_a"}, _ctx_knn(qs[i % CONTEXT_QUERIES],
                                                    10)]
        ms = client.ok("POST", "/_msearch", ndjson=lines)
        if any(r["status"] != 200 for r in ms["responses"]) or \
                node.breakers.in_flight_requests.used != 0:
            raise AssertionError(f"_msearch of 32: breaker at "
                                 f"{node.breakers.in_flight_requests.used}")
        # a cancellation that lands as the search's task registers
        register = node.task_manager.register

        def register_cancelled(*a, **kw):
            task = register(*a, **kw)
            node.task_manager.cancel(task.id)
            return task

        node.task_manager.register = register_cancelled
        kf.launches.reset()
        try:
            node.search("sift_a", _ctx_knn(qs[0], 10))
            raise AssertionError("a cancelled search returned")
        except OpenSearchTpuException as e:
            if e.error_type != "task_cancelled_exception":
                raise
        finally:
            node.task_manager.register = register
        if kf.launches.count != 0 or node.task_manager.list_tasks() or \
                node.knn_batcher.pressure.current != 0:
            raise AssertionError(f"the cancelled search launched "
                                 f"{kf.launches.count} K1 or left a task "
                                 f"or a batcher slot")
        out["admission"] = {"admitted": admitted, "rejected": rejected,
                            "group_totals": totals,
                            "wall_s": time.perf_counter() - t0}
        log(f"[sift_a] admission: {admitted} admitted (each its solo bits), "
            f"{rejected} rejected with 429 under an enforced group of cpu "
            f"{CONTEXT_WLM_CPU}; no task left; the in-flight breaker at 0 "
            f"after an HTTP _msearch of 32; a cancelled search raised "
            f"task_cancelled_exception with no K1 launch")

        # -- 6. settings and restart -----------------------------------------
        t0 = time.perf_counter()
        put = client.ok("PUT", "/_cluster/settings", {
            "persistent": {"search.knn.batch.max_wait_ms": "3ms"},
            "transient": {"indices.requests.cache.size": "1mb"}})
        if node.knn_batcher.max_wait_ms != 3 or \
                node.request_cache.max_bytes != 1 << 20:
            raise AssertionError(f"_cluster/settings did not apply: {put}")
        qb = (data_b[rng.choice(data_b.shape[0], CONTEXT_QUERIES,
                                replace=False)]
              + 0.05 * rng.standard_normal((CONTEXT_QUERIES, DIM))
              .astype(np.float32))
        before = {name: [_ctx_hits(node.search(name, _ctx_knn(q, 10)))
                         for q in (qs if name == "sift_a" else qb)]
                  for name in ("sift_a", "sift_b")}
        counts = {name: node.count(name)["count"]
                  for name in ("sift_a", "sift_b")}
        alias_view = node.get_alias()
        t1 = time.perf_counter()
        for name in ("sift_a", "sift_b"):
            client.ok("POST", f"/{name}/_flush")
        flush_s = time.perf_counter() - t1
    finally:
        client.close()
        server.stop_thread()
    node.close()
    del node
    gc.collect()
    # the batcher is process-wide: back to its default, so the reopened
    # node's boot must set the persisted value again
    from opensearch_tpu_torch.search import batcher

    batcher.default_batcher.configure(max_wait_ms=2)
    t1 = time.perf_counter()
    node = TorchNode(data_path)
    recover_s = time.perf_counter() - t1
    ledger_after = default_ledger.resident_bytes()
    devices = {str(seg.vector_fields["v"].vectors.device)
               for svc in node.indices.values()
               for shard in svc.shards.values()
               for _h, seg in shard.acquire_searcher().segments}
    got_counts = {name: node.count(name)["count"] for name in counts}
    settings = node.get_cluster_settings(flat=True)
    if sorted(node.indices) != ["sift_a", "sift_b"] or got_counts != counts \
            or node.get_alias() != alias_view or devices != {dev_name} or \
            settings["persistent"] != {
                "search.knn.batch.max_wait_ms": "3ms"} or \
            settings["transient"] != {} or \
            node.knn_batcher.max_wait_ms != 3 or \
            node.request_cache.max_bytes == 1 << 20:
        raise AssertionError(f"restart: indices {sorted(node.indices)}, "
                             f"counts {got_counts} (want {counts}), devices "
                             f"{devices}, settings {settings}")
    for name in ("sift_a", "sift_b"):
        after = k1_run(f"[{name}] after the restart", lambda: [
            _ctx_hits(node.search(name, _ctx_knn(q, 10)))
            for q in (qs if name == "sift_a" else qb)],
            CONTEXT_QUERIES, None)
        if after["result"] != before[name]:
            raise AssertionError(f"[{name}] after the restart: not the "
                                 f"pre-restart bits")
    out["restart"] = {"flush_s": flush_s, "recover_s": recover_s,
                      "ledger_resident_after": ledger_after,
                      "counts": got_counts,
                      "wall_s": time.perf_counter() - t0}
    log(f"restart: flush both indices {flush_s:.1f} s, a new TorchNode "
        f"recovered them on the card in {recover_s:.1f} s (ledger "
        f"{ledger_after} B resident); counts, aliases, the persistent key "
        f"back, the transient one not; 16 kNN searches on each index the "
        f"pre-restart bits")
    # a PIT on B held across _forcemerge: B's merged-away segments stay
    # alive while it is open, above the ledger's published set
    t0 = time.perf_counter()
    node.put_cluster_settings({"persistent": {
        "search.knn.batch.max_wait_ms": None}})
    doomed = [str(int(x)) for x in rng.choice(data_b.shape[0],
                                              CONTEXT_B_DELETES,
                                              replace=False)]
    node.bulk([("delete", {"_index": "sift_b", "_id": d}, None)
               for d in doomed], refresh=True)
    hits_b = [_ctx_hits(node.search("sift_b", _ctx_knn(q, 10))) for q in qb]
    gap0 = torch.cuda.memory_allocated() - default_ledger.resident_bytes()
    pid = node.open_pit("sift_b", "5m")["pit_id"]
    held = sum(sum(seg.column_nbytes().values())
               for ctx in node._reader_contexts.values()
               for snap in ctx["snapshots"] for _h, seg in snap.segments)
    server = HttpServer(node, "127.0.0.1", 0)
    server.start_in_thread()
    client = RestClient(server.port)
    try:
        client.ok("POST", "/sift_b/_forcemerge?max_num_segments=1")
    finally:
        client.close()
        server.stop_thread()
    pit_hits = [_ctx_hits(node.search(None, {"pit": {"id": pid},
                                             **_ctx_knn(q, 10)}))
                for q in qb]
    merged = [_ctx_hits(node.search("sift_b", _ctx_knn(q, 10))) for q in qb]
    if merged != hits_b or pit_hits != hits_b:
        raise AssertionError("[sift_b] force merge: not the same bits")
    gap1 = torch.cuda.memory_allocated() - default_ledger.resident_bytes()
    node.close_pit([pid])
    gap2 = torch.cuda.memory_allocated() - default_ledger.resident_bytes()
    if gap1 - gap0 < 0.9 * held or abs(gap2 - gap0) > 0.1 * held:
        raise AssertionError(f"[sift_b] PIT across a force merge: device "
                             f"bytes above the ledger {gap0} / {gap1} / "
                             f"{gap2} (the PIT's segments {held} B)")
    out["forcemerge"] = {"pit_segment_bytes": held,
                         "allocated_minus_ledger": [gap0, gap1, gap2],
                         "wall_s": time.perf_counter() - t0}
    log(f"[sift_b] force merge to one segment after {CONTEXT_B_DELETES} "
        f"deletes: the same bits live and through a PIT; device bytes above "
        f"the ledger before / PIT open / closed {gap0} / {gap1} / {gap2} "
        f"(the PIT's segments {held} B)")
    if keep is not None:
        keep.update(vecs=vecs, live=live)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"contexts phase: {out['wall_s']:.1f} s")
    return out, node


def contexts_phase(kf, dev, seed: int) -> dict:
    """Cell A and B built as main_path_phase builds them (the same seed
    draws), then contexts_main_phase alone (``--phases contexts``)."""
    from opensearch_tpu_torch.node import TorchNode

    rng = np.random.default_rng(seed + 2)
    data_a = clustered(rng, 200_000, DIM)
    data_b = clustered(rng, 20_000, DIM)
    attrs = attributes(rng, 200_000)
    queries = (data_a[rng.choice(200_000, 64, replace=False)]
               + 0.05 * rng.standard_normal((64, DIM)).astype(np.float32))
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device="cuda")
        t0 = time.perf_counter()
        _bulk_index(node, "sift_a", data_a, 1, attrs)
        _bulk_index(node, "sift_b", data_b, 4)
        log(f"[sift_a] 200000 and [sift_b] 20000 docs: bulk + refresh "
            f"{time.perf_counter() - t0:.1f} s")
        out, node = contexts_main_phase(node, kf, tmp, data_a, attrs,
                                        queries, data_b, rng)
        node.close()
    return out


# --------------------------------------------------------------------------
# ingest pipelines, index templates, wildcard expressions and the stats
# surface (the ops phase)
# --------------------------------------------------------------------------

# the pipeline-fed index and its twin; admin splits the fed one and backup
# reindexes the twin, both from a REST worker thread, so this depth sets
# those phases' seconds as well
OPS_DOCS = 10_000
OPS_SPAM = 0.01              # share of docs tagged spam, dropped by the pipeline
OPS_QUERIES = 16             # kNN searches at each k through each expression
OPS_KS = (10, 100)
OPS_SAMPLES = 256            # _sources held to _simulate's output
OPS_READS = 16               # reads of each observability route
OPS_BATCHED = 4              # per-shard searches through the kNN batcher
OPS_INGESTED_AT = "2026-10-01T00:00:00Z"
OPS_ROUTES = ("/_nodes/stats", "/_nodes/stats/device,knn_batch,ingest",
              "/_stats", "/_cluster/stats", "/_prometheus/metrics",
              "/_cat/indices?format=json", "/_cat/shards", "/_cat/segments",
              "/_cat/health")


def _http_get(client, path: str) -> tuple[int, object]:
    """GET over a RestClient's connection: JSON, or a _cat / Prometheus
    table as text."""
    client.conn.request("GET", path)
    resp = client.conn.getresponse()
    raw = resp.read()
    if (resp.getheader("content-type") or "").startswith("text/plain"):
        return resp.status, raw.decode()
    return resp.status, json.loads(raw)


def _launch_counts() -> dict:
    """Every kernel wrapper's launch counter, by module and name."""
    from opensearch_tpu_torch.ops import adc_lut, adc_scan, knn_blocks
    from opensearch_tpu_torch.ops import knn_fused, knn_rescore
    from opensearch_tpu_torch.ops.cuda_lib import LaunchCounter

    return {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": c.count
            for mod in (knn_fused, knn_rescore, adc_scan, adc_lut, knn_blocks)
            for name, c in vars(mod).items() if isinstance(c, LaunchCounter)}


def _knn_batch_series(text: str) -> dict:
    """The unlabeled opensearch_tpu_knn_batch_* samples of a scrape."""
    out = {}
    for line in text.splitlines():
        if line.startswith("opensearch_tpu_knn_batch_") and "{" not in line:
            name, value = line.rsplit(" ", 1)
            out[name[len("opensearch_tpu_knn_batch_"):]] = float(value)
    return out


def ops_main_phase(node, kf, seed: int, held: dict | None = None,
                   keep: dict | None = None) -> dict:
    """Ingest pipelines, index templates, wildcard expressions and the
    node's stats surface, on the main node after the contexts phase (or
    alone on a fresh node, ``--phases ops``):

    1. over HTTP, a component template (a 128-d l2 knn_vector `v`, a
       keyword `tag`, a long `views`, one shard, index.default_pipeline
       vec-in) and a composable template `vec-*` built from it; the
       pipeline vec-in: json (the vector from the string `v_json`),
       remove, convert (`views` to long), set (`ingested_at`, a fixed
       value), a painless script on one small field and a drop of docs
       tagged spam (about 1 %, drawn from the seed);
    2. _bulk of OPS_DOCS docs of cell A's 128-d distribution with explicit
       ids into vec-2026.10, which the template auto-creates, and of the
       same docs without a pipeline (``pipeline=_none``) into vec-twin;
       each bulk's host seconds a doc; the index's mappings and settings
       the template's; docs.count = _count = the docs less the drops; the
       fed index's device slab holds each kept doc's twin row bit for bit
       and no live slot for a drop; 256 sampled _sources equal
       _simulate's output for the same docs;
    3. OPS_QUERIES kNN searches at k = 10 and at k = 100, each through
       vec-2026.10 and through vec-*,-vec-twin: one K1 launch each (the
       list scan at k = 10, the wide tier at k = 100), the hits (ids and
       scores) the twin's under a knn.filter that drops the spam docs,
       and the brute force over the kept docs in the kernel's order;
       query_total moves by one a search on each index it names;
    4. OPS_BATCHED searches on the per-shard route (the kNN batcher), then
       the ledger-to-allocator gap with no reader context open, and the
       observability routes read OPS_READS times each over the port's
       HTTP server, with no launch counter and no memory_allocated() move
       across them; ingest.pipelines.vec-in.count is OPS_DOCS, and the
       opensearch_tpu_knn_batch_* Prometheus series move as
       _nodes/stats/knn_batch does.

    With `keep` (a dict), the vec-* indices stay for the admin phase and
    `keep` gets the corpus (`data`, `spam`, `views`); else they are
    deleted."""
    from opensearch_tpu_torch.ops import knn_rescore as kr
    from opensearch_tpu_torch.rest.http import HttpServer
    from opensearch_tpu_torch.search import distributed_serving
    from opensearch_tpu_torch.telemetry import device_ledger

    t_phase = time.perf_counter()
    dev = node.device
    rng = np.random.default_rng(seed + 20)
    data = clustered(rng, OPS_DOCS, DIM)
    spam = rng.random(OPS_DOCS) < OPS_SPAM
    views = rng.integers(0, 1_000_000, OPS_DOCS)
    qs = (data[rng.choice(OPS_DOCS, OPS_QUERIES, replace=False)]
          + 0.05 * rng.standard_normal((OPS_QUERIES, DIM)).astype(np.float32))
    kept = np.flatnonzero(~spam)
    tags = np.where(spam, "spam", "ham")
    raw = [{"v_json": json.dumps(data[i].tolist()), "tag": str(tags[i]),
            "views": str(int(views[i]))} for i in range(OPS_DOCS)]
    plain = [{"v": data[i].tolist(), "tag": str(tags[i]),
              "views": int(views[i])} for i in range(OPS_DOCS)]
    pipeline = {"description": "vectors from strings, spam dropped",
                "processors": [
                    {"json": {"field": "v_json", "target_field": "v"}},
                    {"remove": {"field": "v_json"}},
                    {"convert": {"field": "views", "type": "long"}},
                    {"set": {"field": "ingested_at",
                             "value": OPS_INGESTED_AT}},
                    {"script": {"lang": "painless",
                                "source": "ctx.views_k = ctx.views / 1000"}},
                    {"drop": {"if": "ctx.tag == 'spam'"}}]}
    out: dict = {}
    server = HttpServer(node, "127.0.0.1", 0)
    server.start_in_thread()
    client = RestClient(server.port)
    try:
        # -- 1. templates and the pipeline, over HTTP ----------------------
        client.ok("PUT", "/_component_template/vec-base", {"template": {
            "settings": {"number_of_shards": 1, "number_of_replicas": 0,
                         "index": {"default_pipeline": "vec-in"}},
            "mappings": {"properties": {
                "v": {"type": "knn_vector", "dimension": DIM,
                      "similarity": "l2_norm"},
                "tag": {"type": "keyword"}, "views": {"type": "long"}}}}})
        client.ok("PUT", "/_index_template/vec", {
            "index_patterns": ["vec-*"], "composed_of": ["vec-base"],
            "priority": 10})
        client.ok("PUT", "/_ingest/pipeline/vec-in", pipeline)
        # -- 2. the pipeline-fed index and its twin ------------------------
        ops = [("index", {"_index": "vec-2026.10", "_id": str(i)}, raw[i])
               for i in range(OPS_DOCS)]
        t0 = time.perf_counter()
        fed = node.bulk(ops)
        fed_s = time.perf_counter() - t0
        twin_ops = [("index", {"_index": "vec-twin", "_id": str(i)},
                     plain[i]) for i in range(OPS_DOCS)]
        t0 = time.perf_counter()
        twin = node.bulk(twin_ops, pipeline="_none")
        twin_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        node.refresh("vec-*")
        refresh_s = time.perf_counter() - t0
        if fed["errors"] or twin["errors"]:
            raise AssertionError("[ops] a bulk item failed")
        dropped = sum(1 for it in fed["items"]
                      if it["index"]["result"] == "noop")
        if dropped != int(spam.sum()):
            raise AssertionError(f"[ops] {dropped} docs dropped, "
                                 f"{int(spam.sum())} tagged spam")
        out["ingest"] = {
            "docs": OPS_DOCS, "dropped": dropped,
            "fed_us_a_doc": fed_s / OPS_DOCS * 1e6,
            "twin_us_a_doc": twin_s / OPS_DOCS * 1e6,
            "pipeline_us_a_doc": (fed_s - twin_s) / OPS_DOCS * 1e6,
            "refresh_s": refresh_s}
        log(f"[ops] _bulk {OPS_DOCS} docs through vec-in into vec-2026.10 "
            f"(auto-created by the template): {out['ingest']['fed_us_a_doc']:.2f}"
            f" us a doc, the twin without a pipeline "
            f"{out['ingest']['twin_us_a_doc']:.2f} us a doc (the pipeline "
            f"{out['ingest']['pipeline_us_a_doc']:.2f} us a doc); {dropped} "
            f"dropped; refresh {refresh_s:.2f} s")
        mapping = node.get_mapping("vec-2026.10")["vec-2026.10"]["mappings"]
        settings = node.get_settings("vec-2026.10")["vec-2026.10"][
            "settings"]["index"]
        props = mapping["properties"]
        if props["tag"]["type"] != "keyword" or \
                props["views"]["type"] != "long" or \
                props["v"].get("dims", props["v"].get("dimension")) != DIM \
                or settings.get("default_pipeline") != "vec-in" \
                or settings["number_of_shards"] != "1":
            raise AssertionError(f"[ops] vec-2026.10 is not the template's: "
                                 f"{mapping} {settings}")
        n_kept = OPS_DOCS - dropped
        count = node.count("vec-2026.10")["count"]
        docs = node.index_stats("vec-2026.10", metrics=["docs"])[
            "indices"]["vec-2026.10"]["primaries"]["docs"]["count"]
        if not count == docs == n_kept:
            raise AssertionError(f"[ops] _count {count}, docs.count {docs}, "
                                 f"{n_kept} docs kept")
        # the fed slab: each kept doc's twin row, no live slot for a drop
        body = {"query": {"knn": {"v": {"vector": qs[0].tolist(), "k": 1}}}}
        node.search("vec-2026.10", body)
        node.search("vec-twin", body)
        fv, _fn, fok = bundle_slab("vec-2026.10")
        tv, _tn, tok = bundle_slab("vec-twin")
        if int(fok.sum()) != n_kept or int(tok.sum()) != OPS_DOCS:
            raise AssertionError(f"[ops] live slots {int(fok.sum())} / "
                                 f"{int(tok.sum())}")
        kept_t = torch.from_numpy(kept).to(dev)
        if not torch.equal(fv[0, :n_kept], tv[0, kept_t]):
            raise AssertionError("[ops] the fed slab is not the twin's rows")
        sample = np.sort(rng.choice(OPS_DOCS, OPS_SAMPLES, replace=False))
        sim = client.ok("POST", "/_ingest/pipeline/vec-in/_simulate", {
            "docs": [{"_index": "vec-2026.10", "_id": str(i),
                      "_source": raw[i]} for i in sample]})
        for i, res in zip(sample, sim["docs"]):
            got = node.get_doc("vec-2026.10", str(i))
            want = res["doc"]
            if (want is None) != (not got["found"]) or (
                    want is not None and want["_source"] != got["_source"]):
                raise AssertionError(f"[ops] doc {i}: _source "
                                     f"{got.get('_source')} != _simulate's "
                                     f"{want}")
        log(f"[ops] vec-2026.10 has the template's mappings and settings; "
            f"docs.count = _count = {n_kept}; the fed slab is the twin's "
            f"kept rows bit for bit; {OPS_SAMPLES} sampled _sources equal "
            f"_simulate's")
        # -- 3. kNN through the name and the pattern, against the twin ------
        qt = torch.from_numpy(qs).to(dev)
        v = torch.from_numpy(data)[None].to(dev)
        nrm = (v.double() ** 2).sum(2).float()
        ok = torch.from_numpy(~spam)[None].to(dev)
        scores = kernel_order_scores(kf, v, nrm, ok, qt, kr.plain_query_sq(qt),
                                     "l2_norm")
        # this phase's brute-force operands: device bytes outside the ledger
        own_bytes = sum(t.numel() * t.element_size()
                        for t in (v, nrm, ok, qt, scores))
        tier_counter = {"lists": kf.list_launches, "wide": kf.wide_launches}
        no_spam = {"bool": {"must_not": [{"term": {"tag": "spam"}}]}}
        stats0 = {n: node.indices[n].search_stats["query_total"]
                  for n in ("vec-2026.10", "vec-twin")}
        knn = {}
        for k in OPS_KS:
            r = kf.fused_pool_width(k, "fp32")
            tier = kf.scan_tier("fp32", r)
            truth = [[str(int(i)) for i in row if i >= 0]
                     for row in order_top(kf, scores, k)[1][0].tolist()]
            twin_hits = [_ctx_hits(node.search("vec-twin", {
                "query": {"knn": {"v": {"vector": q.tolist(), "k": k,
                                        "filter": no_spam}}},
                "size": k, "_source": False})) for q in qs]
            for expr in ("vec-2026.10", "vec-*,-vec-twin"):
                for c in (kf.launches, *tier_counter.values()):
                    c.reset()
                d0 = distributed_serving.stats["distributed_searches"]
                lat = []
                got = []
                for q in qs:
                    t0 = time.perf_counter()
                    got.append(_ctx_hits(node.search(expr, _ctx_knn(q, k))))
                    lat.append(time.perf_counter() - t0)
                launches = {"knn_fused": kf.launches.count,
                            tier: tier_counter[tier].count,
                            "stacked": distributed_serving.stats[
                                "distributed_searches"] - d0}
                label = f"[ops] {expr} k={k}"
                if set(launches.values()) != {OPS_QUERIES}:
                    raise AssertionError(f"{label}: {launches} in "
                                         f"{OPS_QUERIES} searches (one K1 "
                                         f"launch each on {tier})")
                if got != twin_hits:
                    raise AssertionError(f"{label}: not the twin's hits")
                if [[h for h, _s in row] for row in got] != truth:
                    raise AssertionError(f"{label}: not the brute force")
                lat_ms = np.asarray(lat) * 1e3
                knn[f"{expr} k={k}"] = {
                    "launches": launches,
                    "p50_ms": float(np.percentile(lat_ms, 50)),
                    "p99_ms": float(np.percentile(lat_ms, 99))}
                log(f"{label}: {OPS_QUERIES} searches, one K1 launch each "
                    f"on {tier}; the twin's hits and the brute force in "
                    f"order; p50 {knn[f'{expr} k={k}']['p50_ms']:.3f} ms")
        moved = {n: node.indices[n].search_stats["query_total"] - stats0[n]
                 for n in stats0}
        want_moved = {"vec-2026.10": 2 * len(OPS_KS) * OPS_QUERIES,
                      "vec-twin": len(OPS_KS) * OPS_QUERIES}
        if moved != want_moved:
            raise AssertionError(f"[ops] query_total moved {moved}, want "
                                 f"{want_moved}")
        out["knn"] = knn
        out["query_total_moved"] = moved
        # -- 4. the stats surface --------------------------------------------
        knn_batch0 = node.knn_batcher.snapshot_stats()
        prom0 = _knn_batch_series(_http_get(client,
                                            "/_prometheus/metrics")[1])
        distributed_serving.enabled = False
        try:
            for q in qs[:OPS_BATCHED]:
                node.search("vec-2026.10", _ctx_knn(q, 10))
        finally:
            distributed_serving.enabled = True
        torch.cuda.synchronize()
        resident_b = device_ledger.default_ledger.resident_bytes()
        allocated = torch.cuda.memory_allocated()
        # cuBLAS keeps a workspace a (handle, stream) in the caching
        # allocator: freed here, its bytes are what memory_allocated drops
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        after_clear = torch.cuda.memory_allocated()
        out["ledger_gap"] = {
            "ledger_resident_bytes": resident_b,
            "memory_allocated": allocated,
            "gap_bytes": allocated - resident_b,
            "cublas_workspace_bytes": allocated - after_clear,
            "gap_after_cublas_bytes": after_clear - resident_b,
            "held_by_earlier_phases_bytes": (held or {}).get("bytes", 0),
            "held_by_earlier_phases": (held or {}).get("what", []),
            "brute_force_operands_bytes": own_bytes}
        left = after_clear - resident_b - own_bytes - \
            out["ledger_gap"]["held_by_earlier_phases_bytes"]
        out["ledger_gap"]["unexplained_bytes"] = left
        log(f"[ops] device memory, no reader context open: ledger resident "
            f"{resident_b} B, memory_allocated {allocated} B, gap "
            f"{allocated - resident_b} B; cuBLAS workspaces "
            f"{allocated - after_clear} B; this phase's brute-force "
            f"operands {own_bytes} B; tensors the earlier phases hold "
            f"{out['ledger_gap']['held_by_earlier_phases_bytes']} B; what "
            f"is left {left} B")
        counts0 = _launch_counts()
        mem0 = torch.cuda.memory_allocated()
        reads = {}
        for path in OPS_ROUTES:
            lat = []
            for _ in range(OPS_READS):
                t0 = time.perf_counter()
                status, payload = _http_get(client, path)
                lat.append(time.perf_counter() - t0)
                if status != 200:
                    raise AssertionError(f"[ops] GET {path}: HTTP {status}")
            lat_ms = np.asarray(lat) * 1e3
            reads[path] = {"p50_ms": float(np.percentile(lat_ms, 50)),
                           "p99_ms": float(np.percentile(lat_ms, 99)),
                           "bytes": len(json.dumps(payload) if not
                                        isinstance(payload, str)
                                        else payload)}
            if path == "/_nodes/stats/device,knn_batch,ingest":
                node_stats = payload["nodes"]["node-0"]
            elif path == "/_prometheus/metrics":
                prom1 = _knn_batch_series(payload)
            elif path == "/_cat/indices?format=json":
                cat_rows = {r["index"]: r for r in payload}
        torch.cuda.synchronize()
        counts1 = _launch_counts()
        mem1 = torch.cuda.memory_allocated()
        if counts1 != counts0 or mem1 != mem0:
            moved_c = {k: counts1[k] - counts0[k] for k in counts0
                       if counts1[k] != counts0[k]}
            raise AssertionError(f"[ops] the stats reads launched {moved_c} "
                                 f"and moved memory_allocated by "
                                 f"{mem1 - mem0} B")
        ingest = node_stats["ingest"]["pipelines"]["vec-in"]
        if ingest["count"] != OPS_DOCS or ingest["failed"]:
            raise AssertionError(f"[ops] ingest stats {ingest}")
        if int(cat_rows["vec-2026.10"]["docs.count"]) != n_kept:
            raise AssertionError(f"[ops] _cat/indices {cat_rows}")
        knn_batch1 = node_stats["knn_batch"]
        d_snap = {"dispatches": knn_batch1["dispatches"]
                  - knn_batch0["dispatches"],
                  "merged_queries": knn_batch1["merged_queries"]
                  - knn_batch0["merged_queries"]}
        d_prom = {"dispatches": prom1.get("dispatches", 0)
                  - prom0.get("dispatches", 0),
                  "merged_queries": prom1.get("size_sum", 0)
                  - prom0.get("size_sum", 0),
                  "size_count": prom1.get("size_count", 0)
                  - prom0.get("size_count", 0)}
        if d_snap["dispatches"] < 1 or \
                d_prom["dispatches"] != d_snap["dispatches"] or \
                d_prom["size_count"] != d_snap["dispatches"] or \
                d_prom["merged_queries"] != d_snap["merged_queries"]:
            raise AssertionError(f"[ops] knn_batch series moved {d_prom}, "
                                 f"_nodes/stats/knn_batch {d_snap}")
        out["reads"] = reads
        out["knn_batch_moved"] = d_snap
        out["ingest_stats"] = {"count": ingest["count"],
                               "time_in_millis": ingest["time_in_millis"],
                               "processors": [
                                   {t: p[t]["stats"]["count"]} for p in
                                   ingest["processors"] for t in p]}
        log(f"[ops] {len(OPS_ROUTES)} observability routes x {OPS_READS} "
            f"reads over HTTP: no launch, memory_allocated unchanged; p50 ms "
            f"{json.dumps({p: round(r['p50_ms'], 3) for p, r in reads.items()})}"
            f"; ingest.pipelines.vec-in.count {ingest['count']}; the "
            f"knn_batch series moved as _nodes/stats ({d_snap})")
    finally:
        client.close()
        server.stop_thread()
    if keep is None:
        node.delete_index("vec-*")
    else:
        keep.update(data=data, spam=spam, views=views)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"ops phase: {out['wall_s']:.1f} s")
    if out["wall_s"] > 45:
        raise AssertionError(f"[ops] the phase took {out['wall_s']:.1f} s "
                             f"(at most 45)")
    return out


def ops_phase(kf, dev, seed: int) -> dict:
    """ops_main_phase alone on its own fresh node (``--phases ops``)."""
    from opensearch_tpu_torch.node import TorchNode

    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device="cuda")
        try:
            return ops_main_phase(node, kf, seed)
        finally:
            node.close()


# --------------------------------------------------------------------------
# cross-request batching on the stacked step, index management and document
# reads (the admin phase)
# --------------------------------------------------------------------------

ADMIN_QUERIES = 16           # kNN searches of each check
ADMIN_V2_DOCS = 2_000        # docs carrying only the new field v2
ADMIN_ROLL_DOCS = 2_000      # docs written through vec-w before and after
ADMIN_EXPLAIN = 8            # kNN top hits explained
ADMIN_MGET = 64              # ids of the _mget
ADMIN_READS = 8              # timed reads of each document-read route
ADMIN_WALL_S = 30


def brute_rows(kf, rows: np.ndarray, qs: np.ndarray, k: int, dev,
               valid: np.ndarray | None = None) -> list:
    """The top-k row numbers of each query over `rows` (where `valid`)
    under the range scans' own arithmetic (kernel_order_scores), ties in
    row order."""
    from opensearch_tpu_torch.ops import knn_rescore as kr

    v = torch.from_numpy(rows)[None].to(dev)
    nrm = (v.double() ** 2).sum(2).float()
    ok = (torch.ones(v.shape[:2], dtype=torch.bool, device=dev)
          if valid is None else torch.from_numpy(valid)[None].to(dev))
    qt = torch.from_numpy(qs).to(dev)
    scores = kernel_order_scores(kf, v, nrm, ok, qt, kr.plain_query_sq(qt),
                                 "l2_norm")
    top = order_top(kf, scores, k)[1][0].tolist()
    return [[i for i in row if i >= 0] for row in top]


def brute_ids(kf, rows: np.ndarray, qs: np.ndarray, k: int, ids: list,
              dev) -> list:
    """brute_rows' rows as doc ids."""
    return [[ids[i] for i in row] for row in brute_rows(kf, rows, qs, k, dev)]


def tie_swaps(label: str, got: list, want: list) -> int:
    """(_id, _score) hit lists that must be equal, but where a doc may
    stand in for another of the same score (an exact tie, kept in another
    doc order): the scores must be equal place by place; the lists whose
    ids differ are logged and counted."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} != {len(want)} lists")
    swaps = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        if [sc for _d, sc in g] != [sc for _d, sc in w]:
            raise AssertionError(f"{label} query {i}: {g} != {w}")
        swaps += 1
        log(f"{label} query {i}: ties swapped "
            f"{[(a, b) for a, b in zip(g, w) if a != b]}")
    return swaps


def admin_main_phase(node, kf, seed: int, corpus: dict,
                     queries_a: np.ndarray, queries_b: np.ndarray,
                     drop: bool = True) -> dict:
    """Cross-request batching on the stacked step, index management and
    document reads, on the main node after the ops phase (whose vec-2026.10
    and vec-twin it reuses), or alone on a fresh node (``--phases admin``):

    1. the concurrent checks (concurrent_phase) on the stacked step: cell
       A at k = 10 and 100, at bf16 and int8 (gated only; int8 on queries
       of one quantization scale, and on queries of 64 scales, which must
       launch apart), cell B at k = 10; every concurrent hit list its
       solo one bit for bit, the mean merged batch above 1, fewer K1
       launches than searches, and on B a cross-shard launch; QPS with
       the batcher on and off;
    2. PUT vec-twin/_mapping adds v2 (a 128-d l2 knn_vector), ADMIN_V2_DOCS
       docs carrying only v2 (``pipeline=_none``), refresh; ADMIN_QUERIES
       kNN on v2, one K1 launch each, the kernel-order brute force over
       those docs; ADMIN_QUERIES kNN on v, the hits of before the update
       bit for bit;
    3. PUT vec-twin/_block/write: a _bulk refused with the reference's
       block error, docs.count unmoved, a kNN still one launch; the
       block lifted by _settings;
    4. vec-2026.10 write-blocked and split into vec-split (2 shards);
       ADMIN_QUERIES kNN at k = 10 and at k = 100 through it, one stacked
       launch each over 2 shards, vec-2026.10's hits (an exact tie on a
       score may swap two docs: logged);
    5. _close vec-split: a kNN answers 400 index_closed_exception with no
       launch, _cat/indices says close, vec-* skips it, the ledger's
       resident bytes before and after; _open: the kNN of before the
       close bit for bit, the registry's builds and the first search's
       latency reported;
    6. vec-000001 with write alias vec-w, through the template,
       ADMIN_ROLL_DOCS docs; _rollover under max_docs ADMIN_ROLL_DOCS / 2
       (1,000) to vec-000002,
       ADMIN_ROLL_DOCS more through vec-w; ADMIN_QUERIES kNN through vec-w,
       one stacked launch each over both indices' shards, the brute force
       over all the docs;
    7. _explain of ADMIN_EXPLAIN kNN top hits (matched, value the hit's
       _score bit for bit, the per-shard route's launches), _mget of
       ADMIN_MGET ids against as many GET _doc, _field_caps?fields=v*
       (the reference's dense_vector for v and v2), and _validate/query, _search_shards and _analyze with
       no launch and no memory_allocated() move; each route group once
       over HTTP and the p50 of _explain, _mget and _field_caps.
    At most ADMIN_WALL_S seconds. The vec-* indices are deleted at the
    end, or with `drop` false kept for the backup phase."""
    from opensearch_tpu_torch.rest.http import HttpServer
    from opensearch_tpu_torch.search import ann as ann_mod
    from opensearch_tpu_torch.search import distributed_serving
    from opensearch_tpu_torch.telemetry import device_ledger

    t_phase = time.perf_counter()
    dev = node.device
    rng = np.random.default_rng(seed + 30)
    data, spam = corpus["data"], corpus["spam"]
    qs = (data[rng.choice(len(data), ADMIN_QUERIES, replace=False)]
          + 0.05 * rng.standard_normal((ADMIN_QUERIES, DIM)).astype(
              np.float32))
    registry = distributed_serving.registry
    out: dict = {"phases": {}}

    def lap(name: str, t0: float) -> None:
        out["phases"][name] = time.perf_counter() - t0

    def one_launch_each(label: str, searches, tier: str) -> list:
        """Run the searches one by one: each one stacked K1 launch on
        `tier`; returns the hit lists."""
        counter = {"lists": kf.list_launches, "wide": kf.wide_launches}[tier]
        kf.launches.reset()
        counter.reset()
        d0 = distributed_serving.stats["distributed_searches"]
        got = [_ctx_hits(fn()) for fn in searches]
        launches = {"knn_fused": kf.launches.count, tier: counter.count,
                    "stacked": distributed_serving.stats[
                        "distributed_searches"] - d0}
        if set(launches.values()) != {len(got)}:
            raise AssertionError(f"{label}: {launches} in {len(got)} "
                                 f"searches (one stacked K1 launch each)")
        out.setdefault("launches", {})[label] = launches
        return got

    # -- 1. batching on the stacked step ---------------------------------
    t0 = time.perf_counter()
    lists = {"knn_fused": kf.launches, "lists": kf.list_launches}
    batching = {
        "A k=10": concurrent_phase(node, "sift_a", queries_a, 10, lists),
        # k = 100 on the wide tier, the first 10 hits fetched: the fetch of
        # 100 hits a search would outweigh the launch the batcher merges
        "A k=100": concurrent_phase(
            node, "sift_a", queries_a, 100,
            {"knn_fused": kf.launches, "wide": kf.wide_launches})}
    # an int8 batch is quantized with one scale, max|q| / 127 over the
    # batch, so the stacked key merges int8 queries of one scale only: the
    # merge is gated on queries whose largest component is set to the
    # set's largest (one scale), and queries of other scales must launch
    # apart
    one_scale = queries_a.copy()
    rows = np.arange(len(one_scale))
    peak = np.abs(one_scale).argmax(axis=1)
    one_scale[rows, peak] = np.sign(one_scale[rows, peak]) * \
        np.abs(queries_a).max()
    if len({kf.int8_query_scale(q) for q in queries_a}) != len(queries_a):
        raise AssertionError("[admin] two queries share an int8 scale")
    mma = {"knn_fused": kf.launches, "mma": kf.mma_launches}
    for label, prec, qs_prec, merges in (
            ("bf16", "bf16", queries_a, True),
            ("int8", "int8", one_scale, True),
            ("int8 other scales", "int8", queries_a, False)):
        ann_mod.default_config.configure(score_precision=prec)
        try:
            batching[f"A {label} k=10"] = concurrent_phase(
                node, "sift_a", qs_prec, 10, mma, reduced=True,
                merges=merges)
        finally:
            ann_mod.default_config.configure(score_precision="fp32")
    batching["B k=10"] = concurrent_phase(node, "sift_b", queries_b, 10,
                                          lists)
    if batching["B k=10"]["gated"]["cross_shard_launches"] < 1:
        raise AssertionError(f"[admin] cell B: no cross-shard launch: "
                             f"{batching['B k=10']['gated']}")
    out["batching"] = batching
    lap("batching", t0)

    server = HttpServer(node, "127.0.0.1", 0)
    server.start_in_thread()
    client = RestClient(server.port)
    try:
        # -- 2. a knn_vector added by a mapping update -------------------
        t0 = time.perf_counter()
        before_v = [_ctx_hits(node.search("vec-twin", _ctx_knn(q, 10)))
                    for q in qs]
        client.ok("PUT", "/vec-twin/_mapping", {"properties": {"v2": {
            "type": "knn_vector", "dimension": DIM,
            "similarity": "l2_norm"}}})
        v2 = clustered(rng, ADMIN_V2_DOCS, DIM)
        v2_ids = [f"v2-{i}" for i in range(ADMIN_V2_DOCS)]
        resp = node.bulk([("index", {"_index": "vec-twin", "_id": v2_ids[i]},
                           {"v2": v2[i].tolist()})
                          for i in range(ADMIN_V2_DOCS)], refresh=True,
                         pipeline="_none")
        if resp["errors"]:
            raise AssertionError("[admin] the v2 bulk reported errors")
        q2 = (v2[rng.choice(ADMIN_V2_DOCS, ADMIN_QUERIES, replace=False)]
              + 0.05 * rng.standard_normal((ADMIN_QUERIES, DIM)).astype(
                  np.float32))
        got_v2 = one_launch_each("v2 k=10", [
            lambda q=q: node.search("vec-twin", {"query": {"knn": {"v2": {
                "vector": q.tolist(), "k": 10}}}, "size": 10,
                "_source": False}) for q in q2], "lists")
        if [[h for h, _s in row] for row in got_v2] != \
                brute_ids(kf, v2, q2, 10, v2_ids, dev):
            raise AssertionError("[admin] kNN on v2: not the brute force "
                                 "over the docs written after the update")
        after_v = one_launch_each("v k=10 after the update", [
            lambda q=q: node.search("vec-twin", _ctx_knn(q, 10))
            for q in qs], "lists")
        if after_v != before_v:
            raise AssertionError("[admin] kNN on v moved with the mapping "
                                 "update")
        log(f"[admin] PUT vec-twin/_mapping added v2; {ADMIN_V2_DOCS} docs "
            f"carry it; {ADMIN_QUERIES} kNN on v2, one K1 launch each, the "
            f"brute force over those docs; {ADMIN_QUERIES} kNN on v, the "
            f"hits of before the update bit for bit")
        lap("mapping", t0)

        # -- 3. a write block -------------------------------------------
        t0 = time.perf_counter()
        client.ok("PUT", "/vec-twin/_block/write")
        docs0 = node.count("vec-twin")["count"]
        status, blocked = client("POST", "/_bulk?pipeline=_none", ndjson=[
            {"index": {"_index": "vec-twin", "_id": "blocked"}},
            {"v": data[0].tolist()}])
        item = blocked["items"][0]["index"] if status == 200 else {}
        if status != 200 or not blocked["errors"] or \
                item.get("error", {}).get("type") != \
                "cluster_block_exception":
            raise AssertionError(f"[admin] a _bulk under the write block: "
                                 f"HTTP {status} {json.dumps(blocked)[:300]}")
        node.refresh("vec-twin")
        if node.count("vec-twin")["count"] != docs0:
            raise AssertionError("[admin] docs.count moved under the block")
        blocked_knn = one_launch_each("v under the write block", [
            lambda: node.search("vec-twin", _ctx_knn(qs[0], 10))], "lists")
        if blocked_knn[0] != before_v[0]:
            raise AssertionError("[admin] kNN under the block moved")
        client.ok("PUT", "/vec-twin/_settings", {"index.blocks.write": False})
        client.ok("PUT", "/vec-twin/_doc/unblocked?pipeline=_none",
                  {"v": data[0].tolist()}, status=(200, 201))
        out["block"] = {"status": item.get("status"),
                        "reason": item["error"]["reason"]}
        log(f"[admin] vec-twin write-blocked: _bulk item "
            f"{item.get('status')} {item['error']['reason']}; docs.count "
            f"{docs0} unmoved; a kNN one launch; lifted by _settings")
        lap("block", t0)

        # -- 4. split ----------------------------------------------------
        t0 = time.perf_counter()
        client.ok("PUT", "/vec-2026.10/_block/write")
        t_split = time.perf_counter()
        client.ok("PUT", "/vec-2026.10/_split/vec-split", {"settings": {
            "index.number_of_shards": 2}})
        out["split_s"] = time.perf_counter() - t_split
        if node.count("vec-split")["count"] != \
                node.count("vec-2026.10")["count"]:
            raise AssertionError("[admin] vec-split does not hold "
                                 "vec-2026.10's docs")
        split = {}
        ties = 0
        for k, tier in ((10, "lists"), (100, "wide")):
            src = [_ctx_hits(node.search("vec-2026.10", _ctx_knn(q, k)))
                   for q in qs]
            x0 = node.knn_batcher.snapshot_stats()["cross_shard_launches"]
            got = one_launch_each(f"vec-split k={k}", [
                lambda q=q: node.search("vec-split", _ctx_knn(q, k))
                for q in qs], tier)
            cross = node.knn_batcher.snapshot_stats()[
                "cross_shard_launches"] - x0
            if cross != ADMIN_QUERIES:
                raise AssertionError(f"[admin] vec-split k={k}: {cross} "
                                     f"cross-shard launches")
            ties += tie_swaps(f"[admin] vec-split k={k}", got, src)
            split[k] = got
        out["split_tie_swaps"] = ties
        log(f"[admin] _split vec-2026.10 -> vec-split (2 shards) in "
            f"{out['split_s']:.2f} s; {ADMIN_QUERIES} kNN at k = 10 and at "
            f"k = 100, one stacked launch each over 2 shards, vec-2026.10's "
            f"hits ({ties} tie swaps)")
        lap("split", t0)

        # -- 5. close and open -------------------------------------------
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        resident0 = device_ledger.default_ledger.resident_bytes()
        client.ok("POST", "/vec-split/_close")
        resident1 = device_ledger.default_ledger.resident_bytes()
        kf.launches.reset()
        status, err = client("POST", "/vec-split/_search",
                             _ctx_knn(qs[0], 10))
        if status != 400 or err["error"]["type"] != \
                "index_closed_exception" or kf.launches.count:
            raise AssertionError(f"[admin] a kNN on the closed index: HTTP "
                                 f"{status} {err}, {kf.launches.count} "
                                 f"launches")
        _st, cat = _http_get(client, "/_cat/indices/vec-split?h=status")
        if cat.strip() != "close":
            raise AssertionError(f"[admin] _cat/indices: {cat!r}")
        pattern = client.ok("POST", "/vec-*/_search", _ctx_knn(qs[0], 10))
        if any(h["_index"] == "vec-split" for h in pattern["hits"]["hits"]):
            raise AssertionError("[admin] vec-* reached the closed index")
        builds0 = registry.snapshot_stats()["builds"]
        client.ok("POST", "/vec-split/_open")
        t_first = time.perf_counter()
        first = _ctx_hits(node.search("vec-split", _ctx_knn(qs[0], 10)))
        first_ms = (time.perf_counter() - t_first) * 1e3
        reopened = one_launch_each("vec-split k=10 after _open", [
            lambda q=q: node.search("vec-split", _ctx_knn(q, 10))
            for q in qs], "lists")
        if reopened != split[10] or first != split[10][0]:
            raise AssertionError("[admin] after _open: not the hits of "
                                 "before the close")
        out["close_open"] = {
            "resident_bytes_before_close": resident0,
            "resident_bytes_after_close": resident1,
            "bundle_builds_after_open": registry.snapshot_stats()["builds"]
            - builds0,
            "first_knn_after_open_ms": first_ms}
        log(f"[admin] _close vec-split: ledger resident {resident0} B "
            f"before, {resident1} B after; a kNN 400 index_closed_exception "
            f"with no launch; _cat/indices 'close'; vec-* skips it; _open: "
            f"{out['close_open']['bundle_builds_after_open']} bundle "
            f"build(s), the first kNN {first_ms:.3f} ms, {ADMIN_QUERIES} "
            f"kNN the hits of before the close bit for bit")
        lap("close_open", t0)

        # -- 6. rollover -------------------------------------------------
        t0 = time.perf_counter()
        client.ok("PUT", "/vec-000001", {"aliases": {
            "vec-w": {"is_write_index": True}}})
        rows = clustered(rng, 2 * ADMIN_ROLL_DOCS, DIM)
        row_ids = [f"r-{i}" for i in range(2 * ADMIN_ROLL_DOCS)]

        def write(lo: int, hi: int) -> None:
            resp = node.bulk([("index", {"_index": "vec-w",
                                         "_id": row_ids[i]},
                               {"v": rows[i].tolist()})
                              for i in range(lo, hi)], refresh=True,
                             pipeline="_none")
            if resp["errors"]:
                raise AssertionError("[admin] a vec-w bulk reported errors")

        write(0, ADMIN_ROLL_DOCS)
        rolled = client.ok("POST", "/vec-w/_rollover", {"conditions": {
            "max_docs": ADMIN_ROLL_DOCS // 2}})
        if not rolled["rolled_over"] or rolled["new_index"] != "vec-000002":
            raise AssertionError(f"[admin] _rollover: {rolled}")
        write(ADMIN_ROLL_DOCS, 2 * ADMIN_ROLL_DOCS)
        counts = {n: node.count(n)["count"]
                  for n in ("vec-000001", "vec-000002")}
        if set(counts.values()) != {ADMIN_ROLL_DOCS} or \
                node.get_mapping("vec-000002")["vec-000002"]["mappings"][
                    "properties"]["v"]["type"] not in ("knn_vector",
                                                       "dense_vector"):
            raise AssertionError(f"[admin] after the rollover: {counts}")
        qr = (rows[rng.choice(len(rows), ADMIN_QUERIES, replace=False)]
              + 0.05 * rng.standard_normal((ADMIN_QUERIES, DIM)).astype(
                  np.float32))
        x0 = node.knn_batcher.snapshot_stats()["cross_shard_launches"]
        got = one_launch_each("vec-w k=10", [
            lambda q=q: node.search("vec-w", _ctx_knn(q, 10)) for q in qr],
            "lists")
        if node.knn_batcher.snapshot_stats()["cross_shard_launches"] - x0 \
                != ADMIN_QUERIES:
            raise AssertionError("[admin] vec-w: not one launch over both "
                                 "indices' shards")
        if [[h for h, _s in row] for row in got] != \
                brute_ids(kf, rows, qr, 10, row_ids, dev):
            raise AssertionError("[admin] kNN through vec-w: not the brute "
                                 "force over both indices' docs")
        out["rollover"] = {"counts": counts, "conditions":
                           rolled["conditions"]}
        log(f"[admin] _rollover vec-w under max_docs "
            f"{ADMIN_ROLL_DOCS // 2}: vec-000002 "
            f"through the template; {counts}; {ADMIN_QUERIES} kNN through "
            f"vec-w, one stacked launch each over both indices' shards, the "
            f"brute force over {2 * ADMIN_ROLL_DOCS} docs")
        lap("rollover", t0)

        # -- 7. document reads and query tools ---------------------------
        t0 = time.perf_counter()
        shard = node.indices["vec-twin"].shards[0]
        with_v = sum(1 for _h, d in shard.acquire_searcher().segments
                     if "v" in d.vector_fields)
        explained = []
        for i, q in enumerate(qs[:ADMIN_EXPLAIN]):
            body = _ctx_knn(q, 10)
            hit = node.search("vec-twin", body)["hits"]["hits"][0]
            kf.launches.reset()
            ex = (client.ok("POST", f"/vec-twin/_explain/{hit['_id']}",
                            {"query": body["query"]}) if i == 0 else
                  node.explain("vec-twin", hit["_id"],
                               {"query": body["query"]}))
            if not ex["matched"] or \
                    ex["explanation"]["value"] != hit["_score"] or \
                    kf.launches.count != with_v:
                raise AssertionError(
                    f"[admin] _explain {hit['_id']}: matched "
                    f"{ex['matched']}, value {ex['explanation']['value']} "
                    f"!= _score {hit['_score']}, {kf.launches.count} K1 "
                    f"launches (want {with_v})")
            explained.append(hit["_id"])
        ids = [str(i) for i in rng.choice(len(data), ADMIN_MGET,
                                          replace=False)]
        mget = client.ok("POST", "/vec-twin/_mget", {"ids": ids})["docs"]
        singles = [node.get_doc("vec-twin", i) for i in ids]
        if json.loads(json.dumps(singles)) != mget:
            raise AssertionError("[admin] _mget is not the GET _doc calls")
        # the reference maps a knn_vector to its dense_vector type, and
        # _field_caps reports that type
        caps = client.ok("GET", "/vec-*/_field_caps?fields=v*")["fields"]
        if any(set(caps.get(f, ())) != {"dense_vector"} for f in ("v", "v2")):
            raise AssertionError(f"[admin] _field_caps: {caps}")
        torch.cuda.synchronize()
        counts0 = _launch_counts()
        mem0 = torch.cuda.memory_allocated()
        valid = client.ok("POST", "/vec-twin/_validate/query?explain=true",
                          {"query": _ctx_knn(qs[0], 10)["query"]})
        shards = client.ok("GET", "/vec-split/_search_shards")
        tokens = client.ok("POST", "/vec-twin/_analyze", {
            "analyzer": "standard", "text": "The split Index's vectors"})
        torch.cuda.synchronize()
        if _launch_counts() != counts0 or \
                torch.cuda.memory_allocated() != mem0 or \
                not valid["valid"] or len(shards["shards"]) != 2 or \
                [t["token"] for t in tokens["tokens"]] != [
                    "the", "split", "index's", "vectors"]:
            raise AssertionError(f"[admin] the query tools launched or "
                                 f"moved memory: {valid} {shards} {tokens}")
        reads = {}
        for label, method, path, body in (
                ("_explain", "POST", f"/vec-twin/_explain/{explained[0]}",
                 {"query": _ctx_knn(qs[0], 10)["query"]}),
                ("_mget", "POST", "/vec-twin/_mget", {"ids": ids}),
                ("_field_caps", "GET", "/vec-*/_field_caps?fields=v*",
                 None)):
            lat = []
            for _ in range(ADMIN_READS):
                t1 = time.perf_counter()
                client.ok(method, path, body)
                lat.append(time.perf_counter() - t1)
            reads[label] = float(np.percentile(np.asarray(lat) * 1e3, 50))
        out["reads_p50_ms"] = reads
        log(f"[admin] _explain of {ADMIN_EXPLAIN} kNN top hits: matched, "
            f"the value the _score bit for bit, {with_v} K1 launch(es) "
            f"each; _mget of {ADMIN_MGET} = GET _doc; _field_caps v, v2 "
            f"dense_vector; _validate/query, _search_shards, _analyze: no "
            f"launch, memory_allocated unmoved; p50 ms {json.dumps(reads)}")
        lap("reads", t0)
    finally:
        client.close()
        server.stop_thread()
    if drop:
        node.delete_index("vec-*")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"admin phase: {out['wall_s']:.1f} s ({json.dumps(out['phases'])})")
    if out["wall_s"] > ADMIN_WALL_S:
        raise AssertionError(f"[admin] the phase took {out['wall_s']:.1f} s "
                             f"(at most {ADMIN_WALL_S})")
    return out


def admin_launches(adm: dict) -> dict:
    """K1's launches of each admin check, counted from 0: the gated
    concurrent runs' and the one-a-search checks'."""
    out = {f"concurrent {key}": res["gated"]["launches"]["knn_fused"]
           for key, res in adm["batching"].items()}
    out.update({key: res["knn_fused"] for key, res in adm["launches"].items()})
    return out


def admin_phase(kf, dev, seed: int) -> dict:
    """Cell A and B built as main_path_phase builds them (the same seed
    draws), the ops phase keeping its indices, then admin_main_phase, on
    a fresh node (``--phases admin``)."""
    from opensearch_tpu_torch.node import TorchNode

    rng = np.random.default_rng(seed + 2)
    data_a = clustered(rng, 200_000, DIM)
    data_b = clustered(rng, 20_000, DIM)
    attrs = attributes(rng, 200_000)
    queries = {}
    for name, data in (("sift_a", data_a), ("sift_b", data_b)):
        queries[name] = (data[rng.choice(data.shape[0], 64, replace=False)]
                         + 0.05 * rng.standard_normal((64, DIM)).astype(
                             np.float32))
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device="cuda")
        try:
            t0 = time.perf_counter()
            _bulk_index(node, "sift_a", data_a, 1, attrs)
            _bulk_index(node, "sift_b", data_b, 4)
            log(f"[sift_a] 200000 and [sift_b] 20000 docs: bulk + refresh "
                f"{time.perf_counter() - t0:.1f} s")
            kept: dict = {}
            ops_main_phase(node, kf, seed, keep=kept)
            return admin_main_phase(node, kf, seed, kept, queries["sift_a"],
                                    queries["sift_b"])
        finally:
            node.close()


# --------------------------------------------------------------------------
# snapshots and repositories, the remote segment store, the reindex family
# and rank evaluation (the backup phase)
# --------------------------------------------------------------------------

BACKUP_QUERIES = 16          # kNN searches of each check
BACKUP_RS_DOCS = 2_000       # cell A's docs in the remote-store index
BACKUP_RANK_REQUESTS = 8     # rated kNN requests of each _rank_eval
BACKUP_VIEWS_COPIED = 500_000   # views below this: reindexed (about half)
BACKUP_VIEWS_PICKED = 100_000   # views below this: tagged by _update_by_query
BACKUP_SCAN_BATCH = 5_000    # docs a scroll page of the reindex family
BACKUP_WALL_S = 30


def backup_main_phase(node, kf, seed: int, corpus: dict,
                      queries_a: np.ndarray, cell_a: dict) -> dict:
    """Snapshots, the remote segment store, the reindex family and rank
    evaluation, on the main node after the admin phase (whose
    vec-2026.10 and vec-twin it reuses), or alone on a fresh node after
    the ops phase (``--phases backup``), over the port's HTTP server:

    1. an fs repository under the node's data path; a snapshot of
       vec-2026.10 and vec-twin, its _status, _cat/snapshots and
       _cat/repositories; a second snapshot of the unchanged indices
       stores no new blob; no launch counter moves across these steps;
    2. a restore of vec-2026.10 renamed restored-2026.10 beside it:
       BACKUP_QUERIES kNN at k = 10 (one K1 launch each, the list scan)
       and at k = 100 (the wide tier), each hit list the live index's bit
       for bit, ids and scores (the restored files are the same bytes);
    3. DELETE vec-twin (no stacked bundle left holding its shards) and
       its restore: BACKUP_QUERIES kNN on v2 (v when the admin phase did
       not add it), the hits of before bit for bit;
    4. _close vec-2026.10 and a restore over it (no stacked bundle left
       holding the replaced shards): the kNN of step 2 bit for bit, and
       the ledger's resident bytes after the first of them at their level
       before the restore, within the bytes of the bundles that held the
       replaced shards (the gap logged);
    5. vec-rs, remote-store enabled on a second repository, with
       BACKUP_RS_DOCS of cell A's docs; _remotestore/_sync and stats;
       DELETE vec-rs and _remotestore/_restore: BACKUP_QUERIES kNN the
       hits of before bit for bit;
    6. _reindex of vec-twin's docs with views below BACKUP_VIEWS_COPIED
       (about half) into a pre-created vec-copy (its mapping, no
       pipeline), in scroll pages of BACKUP_SCAN_BATCH: BACKUP_QUERIES
       kNN, one K1 launch each, vec-twin's hits under the same range (an
       exact tie may swap two docs: tie_swaps) and the brute force over
       the copied rows; _update_by_query tags the docs with views below
       BACKUP_VIEWS_PICKED: BACKUP_QUERIES kNN filtered by a term on the
       tag, one filtered K1 launch each, vec-twin's hits under that range
       and the brute force over those docs; _delete_by_query removes the
       half of vec-copy below its median views: BACKUP_QUERIES kNN, no
       deleted id, vec-twin's hits over the survivors and the brute force
       over them; no scroll context open;
    7. _rank_eval on cell A: BACKUP_RANK_REQUESTS exact kNN requests at
       k = 10 rated by the fp32 brute force's top 10 (over cell A's live
       rows), under precision and under recall: every metric_score 1.0,
       one K1 launch a request; the _rank_eval wall beside its searches'
       p50.
    Reports the snapshot and restore seconds, the remote restore's, the
    reindex's host us a doc and the ledger's resident bytes at each step.
    The vec-* and restored indices are deleted at the end. At most
    BACKUP_WALL_S seconds."""
    from opensearch_tpu_torch.rest.http import HttpServer
    from opensearch_tpu_torch.search import distributed_serving
    from opensearch_tpu_torch.telemetry import device_ledger

    t_phase = time.perf_counter()
    dev = node.device
    ledger = device_ledger.default_ledger
    rng = np.random.default_rng(seed + 40)
    data, views = corpus["data"], corpus["views"]
    qs = (data[rng.choice(len(data), BACKUP_QUERIES, replace=False)]
          + 0.05 * rng.standard_normal((BACKUP_QUERIES, DIM)).astype(
              np.float32))
    out: dict = {"phases": {}, "launches": {}, "ledger_bytes": {}}

    def lap(name: str, t0: float) -> None:
        torch.cuda.synchronize()
        out["phases"][name] = time.perf_counter() - t0
        out["ledger_bytes"][name] = ledger.resident_bytes()

    def k1_each(label: str, searches, tier: str,
                filtered: bool = False) -> list:
        """The searches one by one: each one stacked K1 launch on `tier`
        (filtered ones counted filtered); returns the hit lists."""
        counter = {"lists": kf.list_launches, "wide": kf.wide_launches}[tier]
        kf.launches.reset()
        counter.reset()
        d0 = distributed_serving.stats["distributed_searches"]
        f0 = distributed_serving.stats["filtered"]
        got = [_ctx_hits(fn()) for fn in searches]
        launches = {"knn_fused": kf.launches.count, tier: counter.count,
                    "stacked": distributed_serving.stats[
                        "distributed_searches"] - d0}
        if filtered:
            launches["filtered"] = distributed_serving.stats["filtered"] - f0
        if set(launches.values()) != {len(got)}:
            raise AssertionError(f"[backup] {label}: {launches} in "
                                 f"{len(got)} searches (one stacked K1 "
                                 f"launch each)")
        out["launches"][label] = launches
        return got

    def knn_body(q, k: int, field: str = "v", **extra) -> dict:
        return {"query": {"knn": {field: {"vector": q.tolist(), "k": k,
                                          **extra}}},
                "size": k, "_source": False}

    server = HttpServer(node, "127.0.0.1", 0)
    server.start_in_thread()
    client = RestClient(server.port)
    try:
        # -- 1. snapshots ------------------------------------------------
        t0 = time.perf_counter()
        live = {k: [_ctx_hits(node.search("vec-2026.10", knn_body(q, k)))
                    for q in qs] for k in (10, 100)}
        twin_map = node.get_mapping("vec-twin")["vec-twin"]["mappings"]
        twin_field = "v2" if "v2" in twin_map["properties"] else "v"
        twin_before = [_ctx_hits(node.search(
            "vec-twin", knn_body(q, 10, twin_field))) for q in qs]
        torch.cuda.synchronize()
        counts0 = _launch_counts()
        client.ok("PUT", "/_snapshot/bk", {"type": "fs", "settings": {
            "location": "bk"}})
        t1 = time.perf_counter()
        snap = client.ok("PUT", "/_snapshot/bk/s1", {
            "indices": "vec-2026.10,vec-twin"})["snapshot"]
        out["snapshot_s"] = time.perf_counter() - t1
        if snap["state"] != "SUCCESS" or snap["indices"] != [
                "vec-2026.10", "vec-twin"]:
            raise AssertionError(f"[backup] snapshot: {snap}")
        status = client.ok("GET", "/_snapshot/bk/s1/_status")["snapshots"][0]
        if status["shards_stats"]["done"] != snap["shards"]["total"]:
            raise AssertionError(f"[backup] _status: {status['shards_stats']}")
        _st, cat_snaps = _http_get(
            client, "/_cat/snapshots/bk?h=id,status,indices,total_shards")
        _st, cat_repos = _http_get(client, "/_cat/repositories")
        if cat_snaps.split() != ["s1", "SUCCESS", "2",
                                 str(snap["shards"]["total"])] or \
                cat_repos.split() != ["bk", "fs"]:
            raise AssertionError(f"[backup] _cat: {cat_snaps!r} "
                                 f"{cat_repos!r}")
        store = node.snapshots._store("bk")
        blobs1 = len(store.list_blobs())
        t1 = time.perf_counter()
        client.ok("PUT", "/_snapshot/bk/s2", {
            "indices": "vec-2026.10,vec-twin"})
        out["snapshot2_s"] = time.perf_counter() - t1
        blobs2 = len(store.list_blobs())
        torch.cuda.synchronize()
        if blobs2 != blobs1:
            raise AssertionError(f"[backup] the second snapshot stored "
                                 f"{blobs2 - blobs1} new blobs")
        if _launch_counts() != counts0:
            raise AssertionError("[backup] a launch counter moved across "
                                 "the snapshot steps")
        out["snapshot"] = {
            "files": status["stats"]["total"]["file_count"],
            "bytes": status["stats"]["total"]["size_in_bytes"],
            "blobs": blobs1, "shards": snap["shards"]["total"]}
        log(f"[backup] snapshot of vec-2026.10 and vec-twin: "
            f"{out['snapshot']['files']} files, {out['snapshot']['bytes']} "
            f"B, {blobs1} blobs in {out['snapshot_s']:.3f} s; _status, "
            f"_cat/snapshots, _cat/repositories; a second snapshot "
            f"{out['snapshot2_s']:.3f} s, no new blob; no launch")
        lap("snapshot", t0)

        # -- 2. a restore beside the live index ----------------------------
        t0 = time.perf_counter()
        t1 = time.perf_counter()
        client.ok("POST", "/_snapshot/bk/s1/_restore", {
            "indices": "vec-2026.10", "rename_pattern": "vec-(.+)",
            "rename_replacement": "restored-$1"})
        out["restore_s"] = time.perf_counter() - t1
        for k, tier in ((10, "lists"), (100, "wide")):
            got = k1_each(f"restored-2026.10 k={k}", [
                lambda q=q: node.search("restored-2026.10", knn_body(q, k))
                for q in qs], tier)
            if got != live[k]:
                raise AssertionError(f"[backup] restored-2026.10 k={k}: not "
                                     f"the live index's hits")
        log(f"[backup] restore of vec-2026.10 as restored-2026.10 in "
            f"{out['restore_s']:.3f} s; {BACKUP_QUERIES} kNN at k = 10 and "
            f"at k = 100, one K1 launch each, the live index's hits bit "
            f"for bit")
        lap("restore_renamed", t0)

        # -- 3. a restore after DELETE -------------------------------------
        t0 = time.perf_counter()
        registry = distributed_serving.registry

        def engines_of(name: str) -> set:
            return {sh.engine.instance_id
                    for sh in node.indices[name].shards.values()}

        def held_bundles(engines: set) -> list:
            """The stacked bundles still holding one of `engines`' shards
            (an index's own, or a search's over several indices)."""
            return [k for k in registry._bundles if engines & set(k[3])]

        twin_engines = engines_of("vec-twin")
        client.ok("DELETE", "/vec-twin")
        if held_bundles(twin_engines):
            raise AssertionError("[backup] a stacked bundle holds the "
                                 "deleted vec-twin's shards")
        t1 = time.perf_counter()
        client.ok("POST", "/_snapshot/bk/s1/_restore", {
            "indices": "vec-twin"})
        out["restore_after_delete_s"] = time.perf_counter() - t1
        got = k1_each(f"vec-twin {twin_field} after the restore", [
            lambda q=q: node.search("vec-twin", knn_body(q, 10, twin_field))
            for q in qs], "lists")
        if got != twin_before:
            raise AssertionError("[backup] vec-twin after DELETE and the "
                                 "restore: not the hits of before")
        log(f"[backup] DELETE vec-twin (no bundle left holding its "
            f"shards), its restore in "
            f"{out['restore_after_delete_s']:.3f} s; {BACKUP_QUERIES} kNN on "
            f"{twin_field}, the hits of before bit for bit")
        lap("restore_after_delete", t0)

        # -- 4. a restore over a closed index ------------------------------
        t0 = time.perf_counter()
        client.ok("POST", "/vec-2026.10/_close")
        torch.cuda.synchronize()
        resident0 = ledger.resident_bytes()
        closed_engines = engines_of("vec-2026.10")
        bundle = sum(registry._bundles[k].nbytes
                     for k in held_bundles(closed_engines))
        t1 = time.perf_counter()
        client.ok("POST", "/_snapshot/bk/s1/_restore", {
            "indices": "vec-2026.10"})
        out["restore_over_closed_s"] = time.perf_counter() - t1
        if held_bundles(closed_engines):
            raise AssertionError("[backup] a stacked bundle holds the "
                                 "replaced vec-2026.10's shards")
        first = _ctx_hits(node.search("vec-2026.10", knn_body(qs[0], 10)))
        torch.cuda.synchronize()
        resident1 = ledger.resident_bytes()
        got = k1_each("vec-2026.10 restored over the closed index", [
            lambda q=q: node.search("vec-2026.10", knn_body(q, 10))
            for q in qs], "lists")
        if got != live[10] or first != live[10][0]:
            raise AssertionError("[backup] the restore over the closed "
                                 "index: not the hits of before")
        gap = resident1 - resident0
        if bundle == 0 or abs(gap) > bundle:
            raise AssertionError(f"[backup] the ledger after the restore "
                                 f"over the closed index: {resident1} B "
                                 f"against {resident0} B before (the "
                                 f"bundles holding it {bundle} B)")
        out["restore_over_closed"] = {"resident_before": resident0,
                                      "resident_after_first_knn": resident1,
                                      "gap": gap, "bundle_bytes": bundle}
        log(f"[backup] _close vec-2026.10 and a restore over it in "
            f"{out['restore_over_closed_s']:.3f} s, no bundle left holding "
            f"its shards; {BACKUP_QUERIES} kNN the hits of before bit for "
            f"bit; the ledger {resident0} B before the restore, {resident1} "
            f"B after the first kNN: a gap of {gap} B (the bundles that held "
            f"the replaced shards {bundle} B)")
        lap("restore_over_closed", t0)

        # -- 5. the remote segment store -----------------------------------
        t0 = time.perf_counter()
        client.ok("PUT", "/_snapshot/obj", {"type": "fs", "settings": {
            "location": str(node.data_path / "remote-objects")}})
        client.ok("PUT", "/vec-rs", {"settings": {
            "index.remote_store.enabled": True,
            "index.remote_store.segment.repository": "obj",
            "index.default_pipeline": "_none"}})
        rows_rs = cell_a["vecs"][:BACKUP_RS_DOCS]
        resp = node.bulk([("index", {"_index": "vec-rs", "_id": str(i)},
                           {"v": rows_rs[i].tolist()})
                          for i in range(BACKUP_RS_DOCS)], refresh=True)
        if resp["errors"]:
            raise AssertionError("[backup] the vec-rs bulk reported errors")
        qa = queries_a[:BACKUP_QUERIES]
        rs_before = [_ctx_hits(node.search("vec-rs", knn_body(q, 10)))
                     for q in qa]
        synced = client.ok("POST", "/vec-rs/_remotestore/_sync")["shards"]
        stats = client.ok("GET", "/_remotestore/stats/vec-rs")
        if not synced or stats["vec-rs"]["shards"]["0"][
                "segments_uploaded"] < 1:
            raise AssertionError(f"[backup] _remotestore: {synced} {stats}")
        client.ok("DELETE", "/vec-rs")
        t1 = time.perf_counter()
        restored = client.ok("POST", "/_remotestore/_restore", {
            "indices": ["vec-rs"]})
        out["remote_restore_s"] = time.perf_counter() - t1
        if restored["indices"] != ["vec-rs"]:
            raise AssertionError(f"[backup] _remotestore/_restore: "
                                 f"{restored}")
        got = k1_each("vec-rs after the remote restore", [
            lambda q=q: node.search("vec-rs", knn_body(q, 10)) for q in qa],
            "lists")
        if got != rs_before:
            raise AssertionError("[backup] vec-rs after the remote restore: "
                                 "not the hits of before")
        out["remote_store"] = {"docs": BACKUP_RS_DOCS,
                               "segments_uploaded": stats["vec-rs"][
                                   "shards"]["0"]["segments_uploaded"]}
        log(f"[backup] vec-rs ({BACKUP_RS_DOCS} of cell A's docs) synced "
            f"to the remote store ({out['remote_store']['segments_uploaded']}"
            f" segment(s)), deleted and restored from it in "
            f"{out['remote_restore_s']:.3f} s; {BACKUP_QUERIES} kNN the hits "
            f"of before bit for bit")
        lap("remote_store", t0)

        # -- 6. reindex, update by query, delete by query ------------------
        t0 = time.perf_counter()
        client.ok("PUT", "/vec-copy", {
            "settings": {"index.default_pipeline": "_none"},
            "mappings": twin_map})
        copied_range = {"range": {"views": {"lt": BACKUP_VIEWS_COPIED}}}
        # vec-twin's rows of `v`: the ops corpus (the admin phase's
        # "unblocked" doc and v2's docs carry no views, so none is copied)
        rows, ids = data, [str(i) for i in range(len(data))]
        row_views = views.astype(np.int64)
        copied = row_views < BACKUP_VIEWS_COPIED
        n_copied = int(copied.sum())
        t1 = time.perf_counter()
        reindexed = client.ok("POST", "/_reindex?refresh=true", {
            "source": {"index": "vec-twin", "query": copied_range,
                       "size": BACKUP_SCAN_BATCH},
            "dest": {"index": "vec-copy"}})
        reindex_s = time.perf_counter() - t1
        if reindexed["created"] != n_copied or reindexed["failures"] or \
                node.count("vec-copy")["count"] != n_copied:
            raise AssertionError(f"[backup] _reindex: {reindexed['created']}"
                                 f" of {n_copied} docs created")
        out["reindex"] = {"docs": n_copied, "s": reindex_s,
                          "us_a_doc": reindex_s / n_copied * 1e6,
                          "batches": reindexed["batches"]}

        def twin_truth(label: str, got: list, filt, valid) -> int:
            """vec-twin's hits under `filt` are the brute force over the
            `valid` rows; `got` (vec-copy's) are vec-twin's, but for
            exact ties in another doc order. Returns the tie swaps."""
            want = [_ctx_hits(node.search("vec-twin", knn_body(
                q, 10, **({"filter": filt} if filt else {})))) for q in qs]
            brute = brute_rows(kf, rows, qs, 10, dev, valid)
            if [[h for h, _s in row] for row in want] != \
                    [[ids[i] for i in row] for row in brute]:
                raise AssertionError(f"[backup] {label}: vec-twin's hits "
                                     f"are not the brute force")
            return tie_swaps(f"[backup] {label}", got, want)

        got = k1_each("vec-copy", [
            lambda q=q: node.search("vec-copy", knn_body(q, 10))
            for q in qs], "lists")
        ties = {"reindex": twin_truth("vec-copy", got, copied_range,
                                      copied)}
        t1 = time.perf_counter()
        picked = client.ok("POST", "/vec-copy/_update_by_query?refresh=true", {
            "query": {"range": {"views": {"lt": BACKUP_VIEWS_PICKED}}},
            "size": BACKUP_SCAN_BATCH,
            "script": {"source": "ctx._source.tag = 'picked'"}})
        out["update_by_query"] = {"updated": picked["updated"],
                                  "s": time.perf_counter() - t1}
        in_range = row_views < BACKUP_VIEWS_PICKED
        if picked["updated"] != int(in_range.sum()) or picked["failures"]:
            raise AssertionError(f"[backup] _update_by_query updated "
                                 f"{picked['updated']} of "
                                 f"{int(in_range.sum())} docs")
        tagged = k1_each("vec-copy filtered by the tag", [
            lambda q=q: node.search("vec-copy", knn_body(q, 10, filter={
                "term": {"tag": "picked"}})) for q in qs], "lists",
            filtered=True)
        ties["update_by_query"] = twin_truth(
            "vec-copy filtered by the tag", tagged,
            {"range": {"views": {"lt": BACKUP_VIEWS_PICKED}}}, in_range)
        median = int(np.median(row_views[copied]))
        t1 = time.perf_counter()
        dropped = client.ok("POST", "/vec-copy/_delete_by_query?refresh=true",
                            {"query": {"range": {"views": {"lt": median}}},
                             "size": BACKUP_SCAN_BATCH})
        out["delete_by_query"] = {"deleted": dropped["deleted"],
                                  "s": time.perf_counter() - t1}
        gone = copied & (row_views < median)
        if dropped["deleted"] != int(gone.sum()) or dropped["failures"]:
            raise AssertionError(f"[backup] _delete_by_query deleted "
                                 f"{dropped['deleted']} of "
                                 f"{int(gone.sum())} docs")
        after = k1_each("vec-copy after the deletes", [
            lambda q=q: node.search("vec-copy", knn_body(q, 10))
            for q in qs], "lists")
        gone_ids = {ids[i] for i in np.flatnonzero(gone)}
        if any(h in gone_ids for row in after for h, _s in row):
            raise AssertionError("[backup] a deleted doc came back from a "
                                 "kNN on vec-copy")
        ties["delete_by_query"] = twin_truth(
            "vec-copy after the deletes", after,
            {"range": {"views": {"gte": median,
                                 "lt": BACKUP_VIEWS_COPIED}}},
            copied & ~gone)
        if node._reader_contexts:
            raise AssertionError(f"[backup] {len(node._reader_contexts)} "
                                 f"scroll contexts left open")
        out["tie_swaps"] = ties
        log(f"[backup] _reindex vec-twin -> vec-copy: {n_copied} docs in "
            f"{reindex_s:.3f} s ({out['reindex']['us_a_doc']:.2f} us a doc, "
            f"{reindexed['batches']} batches); _update_by_query tagged "
            f"{picked['updated']} docs in "
            f"{out['update_by_query']['s']:.3f} s; _delete_by_query removed "
            f"{dropped['deleted']} in {out['delete_by_query']['s']:.3f} s; "
            f"{BACKUP_QUERIES} kNN after each, one K1 launch each (filtered "
            f"by the tag: one filtered launch), vec-twin's hits and the "
            f"brute force ({ties} tie swaps), no deleted id, no scroll "
            f"context open")
        lap("reindex", t0)

        # -- 7. rank evaluation on cell A ----------------------------------
        t0 = time.perf_counter()
        qr = queries_a[:BACKUP_RANK_REQUESTS]
        truth = brute_rows(kf, cell_a["vecs"], qr, 10, dev, cell_a["live"])
        requests = [{"id": f"q{i}", "request": {"query": {"knn": {"v": {
            "vector": q.tolist(), "k": 10}}}},
            "ratings": [{"_index": "sift_a", "_id": str(j), "rating": 1}
                        for j in truth[i]]} for i, q in enumerate(qr)]
        rank = {}
        for metric in ("precision", "recall"):
            kf.launches.reset()
            t1 = time.perf_counter()
            got = client.ok("POST", "/sift_a/_rank_eval", {
                "requests": requests, "metric": {metric: {"k": 10}}})
            wall = time.perf_counter() - t1
            scores = [got["details"][f"q{i}"]["metric_score"]
                      for i in range(len(qr))]
            if got["failures"] or set(scores) != {1.0} or \
                    got["metric_score"] != 1.0 or \
                    kf.launches.count != len(qr):
                raise AssertionError(f"[backup] _rank_eval {metric}: "
                                     f"{scores} {got['failures']}, "
                                     f"{kf.launches.count} K1 launches")
            rank[metric] = {"wall_ms": wall * 1e3,
                            "launches": kf.launches.count}
        lat = []
        for r in requests:
            t1 = time.perf_counter()
            client.ok("POST", "/sift_a/_search", {**r["request"],
                                                  "size": 10})
            lat.append(time.perf_counter() - t1)
        rank["search_p50_ms"] = float(np.percentile(np.asarray(lat) * 1e3,
                                                    50))
        out["rank_eval"] = rank
        out["launches"]["rank_eval cell A"] = {
            "knn_fused": rank["precision"]["launches"]}
        log(f"[backup] _rank_eval on cell A, {len(qr)} kNN requests rated "
            f"by the brute force's top 10: precision and recall 1.0 each, "
            f"{len(qr)} K1 launches each; wall "
            f"{rank['precision']['wall_ms']:.3f} / "
            f"{rank['recall']['wall_ms']:.3f} ms beside its searches' p50 "
            f"{rank['search_p50_ms']:.3f} ms over HTTP")
        lap("rank_eval", t0)
    finally:
        client.close()
        server.stop_thread()
    node.delete_index("vec-*,restored-*")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"backup phase: {out['wall_s']:.1f} s ({json.dumps(out['phases'])}); "
        f"ledger bytes {json.dumps(out['ledger_bytes'])}")
    if out["wall_s"] > BACKUP_WALL_S:
        raise AssertionError(f"[backup] the phase took {out['wall_s']:.1f} s"
                             f" (at most {BACKUP_WALL_S})")
    return out


def backup_launches(bk: dict) -> dict:
    """K1's launches of each backup check, counted from 0."""
    return {key: res["knn_fused"] for key, res in bk["launches"].items()}


def backup_phase(kf, dev, seed: int) -> dict:
    """Cell A built as main_path_phase builds it (the same seed draws),
    the ops phase keeping its indices, then backup_main_phase, on a fresh
    node (``--phases backup``)."""
    from opensearch_tpu_torch.node import TorchNode

    rng = np.random.default_rng(seed + 2)
    data_a = clustered(rng, 200_000, DIM)
    data_b = clustered(rng, 20_000, DIM)
    attrs = attributes(rng, 200_000)
    queries = {}
    for name, data in (("sift_a", data_a), ("sift_b", data_b)):
        queries[name] = (data[rng.choice(data.shape[0], 64, replace=False)]
                         + 0.05 * rng.standard_normal((64, DIM)).astype(
                             np.float32))
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device="cuda")
        try:
            t0 = time.perf_counter()
            _bulk_index(node, "sift_a", data_a, 1, attrs)
            log(f"[sift_a] 200000 docs: bulk + refresh "
                f"{time.perf_counter() - t0:.1f} s")
            kept: dict = {}
            ops_main_phase(node, kf, seed, keep=kept)
            return backup_main_phase(
                node, kf, seed, kept, queries["sift_a"],
                {"vecs": data_a, "live": np.ones(len(data_a), bool)})
        finally:
            node.close()


def bundle_slab(name: str) -> tuple:
    """(vectors, norms_sq, valid) of index `name`'s one serving bundle."""
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry

    bundles = [b for key, b in default_registry._bundles.items()
               if key[0] == name]
    if len(bundles) != 1:
        raise AssertionError(f"[{name}] {len(bundles)} serving bundles")
    # a one-card node's bundle: one slot
    b = bundles[0]
    return b.slot_vectors[0], b.slot_norms_sq[0], b.slot_valid[0]


def large_reduced_main(node, kf, q768: np.ndarray, qa: np.ndarray) -> dict:
    """The stacked step at bf16 and int8 past r = 1024 (R = k), K1 on the
    large-r tier's tensor-core scan: node.search at k = 1025, 2000 and 4096
    (size = k) on the 768-d index, 2 searches each, and k = 10,000 on index
    A, 2 searches, at each precision. Every hit list is the plain
    pipeline's on the node's own slab (knn_fused_stacked impl="xla" at the
    same precision and k) in order; at bf16 a differing list only where the
    pools differ by summation ties (pool_ties, each logged). Each search
    launches K1 exactly once, on the large-r tier's tensor-core scan, and
    never the tile scan (counted from 0)."""
    from opensearch_tpu_torch.search import ann

    out = {}
    try:
        for prec in REDUCED:
            ann.default_config.configure(score_precision=prec)
            for name, qs, ks in (("wide768", q768, LARGE_MAIN_KS),
                                 ("sift_a", qa, (LARGE_MAIN_CELL_A_K,))):
                for k in ks:
                    counters = (kf.launches, kf.large_launches,
                                kf.large_mma_launches, kf.tile_launches,
                                kf.large_select_launches,
                                kf.yardstick_launches)
                    for c in counters:
                        c.reset()
                    lat, ties = [], 0
                    for i, qv in enumerate(qs):
                        t0 = time.perf_counter()
                        resp = node.search(name, {"query": {"knn": {"v": {
                            "vector": qv.tolist(), "k": k}}}, "size": k,
                            "_source": False})
                        lat.append(time.perf_counter() - t0)
                        slab = bundle_slab(name)
                        q1 = torch.from_numpy(qv[None]).to(slab[0].device)
                        _v, ids = kf.knn_fused_stacked(
                            *slab, q1, k=k, similarity="l2_norm",
                            score_precision=prec, impl="xla")
                        want = [str(int(x)) for x in ids[0, 0].tolist()
                                if x >= 0]
                        hits = [h["_id"] for h in resp["hits"]["hits"]]
                        if hits != want:
                            label = f"[{name}] {prec} k={k} query {i}"
                            if prec != "bf16":
                                raise AssertionError(f"{label}: hits differ "
                                                     f"from the plain "
                                                     f"pipeline's")
                            for tie in pool_ties(kf, slab, q1, k, prec,
                                                 label, bound=qv.size >= 512):
                                ties += 1
                                log(f"{label}: a summation tie of the pool "
                                    f"{tie}")
                    got = [c.count for c in counters]
                    n_q = len(qs)
                    if got != [n_q, n_q, n_q, 0, n_q, 0]:
                        raise AssertionError(
                            f"[{name}] {prec} k={k}: (K1, large-r tier, its "
                            f"tensor-core scan, tile scan, multi-CTA select, "
                            f"yardstick) launched {got} times in {n_q} "
                            f"searches")
                    res = latency_summary(lat)
                    res["launches"] = {"knn_fused": got[0],
                                       "knn_fused_large": got[1],
                                       "knn_fused_large_mma": got[2],
                                       "knn_fused_tile": got[3],
                                       "knn_large_select": got[4],
                                       "knn_large_yardstick": got[5]}
                    res["summation_ties"] = ties
                    out[f"{name} {prec} k={k}"] = res
                    log(f"[{name}] {prec} k={k}: {len(qs)} searches, hits "
                        f"the plain pipeline's, one launch each on the "
                        f"large-r tier's tensor-core scan; {json.dumps(res)}")
    finally:
        ann.default_config.configure(score_precision="fp32")
    return out


def latency_summary(lat_s: list, wall_s: float | None = None) -> dict:
    """p50 and p99 of per-search latencies (ms) and QPS: searches over the
    summed latencies, or over the wall time when searches overlapped."""
    lat_ms = np.asarray(lat_s) * 1e3
    return {"p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "qps": len(lat_s) / (wall_s if wall_s is not None else sum(lat_s))}


def concurrent_check(name: str, i: int, got: list, solo: list) -> None:
    """A concurrent hit list against its solo one: the ids in the same order
    and every score the same float, bit for bit (the reference batcher's
    contract), on every path, K1's at fp32, bf16 and int8 and the IVF-PQ
    route's: each dot, |q|^2, LUT, probe score and exact rescore sums in
    one order whatever the batch."""
    if got != solo:
        bad = next(j for j, (a, b) in enumerate(zip(got, solo)) if a != b) \
            if len(got) == len(solo) else None
        raise AssertionError(f"[{name}] concurrent query {i}: not the "
                             f"solo hits bit for bit (first difference "
                             f"at position {bad}: {got[bad] if bad is not None else got} "
                             f"!= {solo[bad] if bad is not None else solo})")


def concurrent_phase(node, name: str, queries: np.ndarray, k: int,
                     counters: dict, size: int = 10,
                     reduced: bool = False, merges: bool = True) -> dict:
    """The 64 queries one after another, then the same 64 from 8 threads of
    8 searches each, three times, each returning `size` hits. Every
    concurrent hit list must equal its solo one (concurrent_check): ids in
    order and scores bit for bit, since every sum a hit depends on
    (K1's dots, |q|^2, the rescore; the IVF-PQ route's probe scores, LUTs
    and rescore) has one order whatever the batch.

    1. The gated run: each round of 8 searches leaves a barrier together,
       and the batcher waits up to 50 ms with its tuner off, so the merge
       does not hang on how the host schedules the threads. The batcher
       must have merged more than one query a launch on average, and each
       kernel in `counters` must have launched fewer times than there were
       searches.
    2. The measured run: the threads run free under the batcher's default
       settings; p50, p99, QPS and the mean merged batch are reported, not
       gated.
    3. The same with the batcher switched off, to tell its share of the
       concurrent numbers from the threads'.
    At a reduced precision (`reduced`) the gated run alone. Without
    `merges` (queries the batcher must keep apart: int8 queries of other
    quantization scales on the stacked step) the gated run must launch
    each search alone."""
    def search(qv) -> list:
        resp = node.search(name, {"query": {"knn": {"v": {
            "vector": qv.tolist(), "k": k}}}, "size": size})
        return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]

    n = len(queries)
    solo, solo_lat = [], []
    for qv in queries:
        t0 = time.perf_counter()
        solo.append(search(qv))
        solo_lat.append(time.perf_counter() - t0)

    def threaded(together: bool = False) -> tuple[list, float]:
        got, lat = [None] * n, [0.0] * n
        barrier = threading.Barrier(8) if together else None

        def worker(t: int) -> None:
            try:
                for i in range(t, n, 8):
                    if barrier is not None:
                        barrier.wait(timeout=120)
                    t0 = time.perf_counter()
                    got[i] = search(queries[i])
                    lat[i] = time.perf_counter() - t0
            except BaseException:
                if barrier is not None:
                    # release the other threads instead of leaving them
                    # at the barrier
                    barrier.abort()
                raise

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            for f in [pool.submit(worker, t) for t in range(8)]:
                f.result()
        wall = time.perf_counter() - t0
        for i, (g, s) in enumerate(zip(got, solo)):
            concurrent_check(name, i, g, s)
        return lat, wall

    def batched_run(together: bool) -> tuple[dict, dict, tuple]:
        node.knn_batcher.reset()
        for counter in counters.values():
            counter.reset()
        timed = threaded(together)
        stats = node.knn_batcher.snapshot_stats()
        return stats, {key: c.count for key, c in counters.items()}, timed

    batcher = node.knn_batcher
    wait0 = batcher.max_wait_ms
    batcher.configure(max_wait_ms=50, auto_tune=False)
    try:
        gated, gated_launches, _timed = batched_run(together=True)
    finally:
        batcher.configure(max_wait_ms=wait0, auto_tune=True)
    if not merges:
        if gated["mean_merged_batch"] != 1 or \
                set(gated_launches.values()) != {n}:
            raise AssertionError(f"[{name}] searches the batcher must keep "
                                 f"apart shared a launch: {gated} "
                                 f"{gated_launches}")
    elif gated["mean_merged_batch"] <= 1:
        raise AssertionError(f"[{name}] the batcher merged nothing: {gated}")
    for key, count in gated_launches.items():
        if merges and not 0 < count < n:
            raise AssertionError(f"[{name}] {key} launched {count} times in "
                                 f"{n} concurrent searches")
    gated_out = {"dispatches": gated["dispatches"],
                 "mean_merged_batch": gated["mean_merged_batch"],
                 "max_batch": gated["max_batch"],
                 "cross_shard_launches": gated["cross_shard_launches"],
                 "launches": gated_launches}
    if reduced:
        out = {"solo": latency_summary(solo_lat), "gated": gated_out}
        log(f"[{name}] 8 threads x 8 searches, gated, equal the solo ones: "
            f"{out}")
        return out
    stats, launches, (lat, wall) = batched_run(together=False)
    batcher.configure(enabled=False)
    try:
        lat_off, wall_off = threaded()
    finally:
        batcher.configure(enabled=True)
    out = {"solo": latency_summary(solo_lat),
           "concurrent": latency_summary(lat, wall),
           "concurrent_batcher_off": latency_summary(lat_off, wall_off),
           "dispatches": stats["dispatches"],
           "mean_merged_batch": stats["mean_merged_batch"],
           "max_batch": stats["max_batch"], "launches": launches,
           "gated": gated_out}
    log(f"[{name}] 8 threads x 8 searches equal the solo ones: {out}")
    return out


def per_shard_exact_phase(node, kf, queries: np.ndarray, truth: list) -> dict:
    """Index A on the per-shard route (distributed_serving.enabled off).
    32 searches at k = 256, size = 10: one 200,000-doc segment, so each
    takes the streaming scan once, and every hit list must be the
    brute-force top-10 in order. Then 8 threads x 8 searches at k = 10
    (K1 through the batcher) against the same searches one at a time."""
    from opensearch_tpu_torch.search import distributed_serving, executor

    distributed_serving.enabled = False
    try:
        stream0 = executor.knn_path_stats["streaming"]
        lat = []
        for i, qv in enumerate(queries[:32]):
            t0 = time.perf_counter()
            resp = node.search("sift_a", {"query": {"knn": {"v": {
                "vector": qv.tolist(), "k": 256}}}, "size": 10})
            lat.append(time.perf_counter() - t0)
            hits = [h["_id"] for h in resp["hits"]["hits"]]
            if hits != truth[i]:
                raise AssertionError(f"[sift_a] per-shard k=256 query {i}: "
                                     f"{hits} != truth {truth[i]}")
        streamed = executor.knn_path_stats["streaming"] - stream0
        if streamed != 32:
            raise AssertionError(f"[sift_a] {streamed} of 32 k=256 searches "
                                 f"took the streaming scan")
        k256 = latency_summary(lat)
        log(f"[sift_a] per-shard route, k=256 size=10: 32 searches equal the "
            f"brute force, each streamed once; {k256}")
        conc = concurrent_phase(node, "sift_a", queries, 10,
                                {"knn_fused": kf.launches,
                                 "knn_fused_lists": kf.list_launches})
    finally:
        distributed_serving.enabled = True
    for run in (conc["gated"]["launches"], conc["launches"]):
        if run["knn_fused_lists"] != run["knn_fused"]:
            raise AssertionError(f"[sift_a] per-shard K1 launches not all on "
                                 f"the list scan: {run}")
    log("[sift_a] per-shard route: every K1 launch through the batcher took "
        "the list scan (knn_pool.cuh)")
    return {"k256": k256, "concurrent": conc}

# --------------------------------------------------------------------------
# K2: the IVF-PQ ADC scan
# --------------------------------------------------------------------------


def compare_adc_pools(ads, args, r, what: str, scan=None) -> float:
    """K2 (or `scan`, another build's launch) vs its plain version on the
    same operands; returns max |dv|."""
    lut = args[0]
    kv, ki = (scan or ads.adc_pool_scan)(*args, r=r)
    pv, pi = ads.plain_adc_pool(*args, r=r)
    torch.cuda.synchronize()
    if not torch.equal(ki, pi):
        bad = (ki != pi).nonzero()[:5].tolist()
        raise AssertionError(f"{what}: ids differ at {bad}")
    fin = torch.isfinite(pv)
    if not torch.equal(fin, torch.isfinite(kv)):
        raise AssertionError(f"{what}: finite slots differ")
    if lut.dtype == torch.uint8:
        if not torch.equal(kv, pv):
            raise AssertionError(f"{what}: uint8 pool not bit-equal")
    elif not torch.allclose(kv[fin], pv[fin], rtol=1e-6, atol=1e-6):
        raise AssertionError(f"{what}: scores beyond rtol 1e-6 / atol 1e-6")
    return float((kv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0


def ann_corpus(rng, n: int, d: int, n_centers: int = 1024) -> np.ndarray:
    """Clustered vectors whose IVF lists come out of similar length, as in
    a real embedding corpus (the exact phases use 64 tight centres)."""
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 2.0
    out = np.empty((n, d), np.float32)
    for lo in range(0, n, 200_000):
        hi = min(lo + 200_000, n)
        out[lo:hi] = (centers[rng.integers(0, n_centers, hi - lo)]
                      + rng.standard_normal((hi - lo, d)).astype(np.float32))
    return out


def adc_operands(ads, ivfpq, index, queries, nprobe, precision):
    """The scan operands exactly as fused_adc_search makes them."""
    probes = ads.probes_on(ivfpq.host_probe_select(index, queries, nprobe),
                           index.params.nlist, index.codes.device)
    q = torch.from_numpy(queries).to(index.codes.device)
    lut = ads.build_luts(q, index.params.coarse, index.params.codebooks,
                         probes, adc_precision=precision).contiguous()
    return lut, index.codes, index.ids, index.mask, probes


def adc_synthetic(ads, dev, rng, nlist: int, l_pad: int, m: int, fills,
                  b: int, p: int, prec: str, ks: int = 256):
    """K2 operands on a random slab: list li live on its first fills[li]
    slots (ids a permutation, -1 where masked), b queries of p distinct
    probes, a random LUT at `prec`'s width (uint8 direct, not through the
    affine)."""
    codes = rng.integers(0, ks, (nlist, l_pad, m), dtype=np.uint8)
    ids = rng.permutation(nlist * l_pad).astype(np.int32).reshape(nlist,
                                                                  l_pad)
    mask = np.zeros((nlist, l_pad), bool)
    for li, fill in enumerate(fills):
        mask[li, :fill] = True
    ids[~mask] = -1
    probes = np.stack([rng.choice(nlist, p, replace=False)
                       for _ in range(b)]).astype(np.int32)
    return adc_slab_operands(dev, rng, codes, ids, mask, probes, prec, ks)


def adc_slab_operands(dev, rng, codes, ids, mask, probes, prec: str,
                      ks: int = 256, zero_column: bool = False):
    b, p = probes.shape
    m = codes.shape[2]
    if prec == "int8":
        lut = torch.from_numpy(rng.integers(0, 256, (b, p, m, ks))
                               .astype(np.uint8)).to(dev)
    else:
        lut = torch.from_numpy((rng.random((b, p, m, ks)) * 8.0)
                               .astype(np.float32)).to(dev)
        if prec == "bf16":
            lut = lut.to(torch.bfloat16)
    if zero_column:
        lut[..., 0] = 0
    return [lut.contiguous(), *(torch.from_numpy(a).to(dev)
                                for a in (codes, ids, mask, probes))]


def adc_kernel_phase(ads, ivfpq, dev, seed: int) -> float:
    """K2 against plain_adc_pool: an IVF-PQ build (m = 20) at B = 1, 8, 16,
    33 and 129 x R = 1, 10, 63, 64, 65, 500 and 4096; random slabs at
    m = 8 (B = 33, ragged and empty lists, R to 4096), m = 96 (a 96 KB fp32
    LUT), m = 30 (the byte path, live < R at R = 500 and 4096); threshold
    ties across parts and probes (600 identical zero-scoring rows a list,
    more than R of them); a merge past shared memory (every slot of 8 lists
    of 8192 live, R = 4096 and R = 20,000, whose sort buffer is in device
    scratch too); the reference's ragged slab with a planted tie. Each at
    fp32, bf16 and uint8 LUTs."""
    rng = np.random.default_rng(seed + 10)
    n, nprobe = K2_PARITY_DOCS, 8
    data = ann_corpus(rng, n, ANN_DIM)
    t0 = time.perf_counter()
    index = ivfpq.build(data, nlist=64, m=ANN_M, device=dev)
    log(f"K2 parity build: n={n} d={ANN_DIM} nlist=64 m={ANN_M} "
        f"l_pad={index.l_pad} in {time.perf_counter() - t0:.1f} s")
    precs = ("fp32", "bf16", "int8")
    err, cases = 0.0, 0
    for b in (1, 8, 16, 33, 129):
        queries = data[rng.choice(n, b, replace=False)] + 0.1 * \
            rng.standard_normal((b, ANN_DIM)).astype(np.float32)
        for prec in precs:
            args = adc_operands(ads, ivfpq, index, queries, nprobe, prec)
            for r in (1, 10, 63, 64, 65, 500, 4096):
                err = max(err, compare_adc_pools(
                    ads, args, r, f"K2 build B={b} {prec} R={r}"))
                cases += 1
    log(f"K2 parity on the build: B = 1/8/16/33/129 x R = 1-4096 x 3 "
        f"precisions ok ({cases} cases)")
    synthetic = (
        # (what, nlist, l_pad, m, fills, B, P, Rs)
        ("m=8 ragged", 32, 2048, 8,
         [0, 1, 2048, 700] + list(rng.integers(0, 2049, 28)), 33, 8,
         (1, 10, 64, 65, 500, 4096)),
        ("m=96 (96 KB fp32 LUT)", 16, 1024, 96,
         list(rng.integers(300, 1025, 16)), 8, 4, (10, 64, 500)),
        ("m=30 bytes, live < R", 16, 512, 30,
         list(rng.integers(0, 100, 16)), 8, 4, (10, 63, 500, 4096)),
        ("merge past shared memory", 8, 8192, 8, [8192] * 8, 2, 8,
         (4096, 20_000)),
    )
    for what, nlist, l_pad, m, fills, b, p, rs in synthetic:
        for prec in precs:
            args = adc_synthetic(ads, dev, rng, nlist, l_pad, m, fills, b, p,
                                 prec)
            for r in rs:
                e = compare_adc_pools(ads, args, r, f"K2 {what} {prec} R={r}")
                err = max(err, e)
        log(f"K2 parity {what}: B={b} P={p} l_pad={l_pad} R={rs} x 3 "
            f"precisions ok")
    # ties on the threshold across parts and probes: 600 rows a list of
    # code 0 in every subspace, and a zero LUT column, so 600 slots a list
    # share the best key (-0.0); the lower position must win each tie
    nlist, l_pad, m = 16, 4096, ANN_M
    codes = rng.integers(1, 256, (nlist, l_pad, m), dtype=np.uint8)
    for li in range(nlist):
        codes[li, rng.choice(3000, 600, replace=False)] = 0
    ids = rng.permutation(nlist * l_pad).astype(np.int32).reshape(nlist,
                                                                  l_pad)
    mask = np.zeros((nlist, l_pad), bool)
    mask[:, :3000] = True
    ids[~mask] = -1
    probes = np.stack([rng.choice(nlist, 8, replace=False)
                       for _ in range(8)]).astype(np.int32)
    for prec in precs:
        args = adc_slab_operands(dev, rng, codes, ids, mask, probes, prec,
                                 zero_column=True)
        for r in (10, 64, 500, 4096):
            err = max(err, compare_adc_pools(ads, args, r,
                                             f"K2 threshold ties {prec} "
                                             f"R={r}"))
        _kv, ki = ads.adc_pool_scan(*args, r=10)
        first = [int(ids[probes[0, 0], l]) for l in range(3000)
                 if not codes[probes[0, 0], l].any()][:10]
        if ki[0].tolist() != first:
            raise AssertionError(f"K2 threshold ties {prec}: {ki[0].tolist()}"
                                 f", expected the first probe's {first}")
    log("K2 parity threshold ties (600 a list, > R, across parts and "
        "probes) x 3 precisions ok")
    # the reference's ragged slab: one empty list, ragged fills, a full one
    nlist, l_pad, m, ks = 6, 32, 4, 16
    codes = rng.integers(0, ks, (nlist, l_pad, m), dtype=np.uint8)
    ids = np.arange(nlist * l_pad, dtype=np.int32).reshape(nlist, l_pad)
    mask = np.zeros((nlist, l_pad), bool)
    for li, fill in enumerate((0, 1, 3, 32, 7, 20)):
        mask[li, :fill] = True
        ids[li, fill:] = -1
    probes = np.stack([rng.choice(nlist, 4, replace=False)
                       for _ in range(3)]).astype(np.int32)
    probes[0] = [0, 1, 2, 4]                 # 11 live slots < R = 16
    # a planted tie: identical codes in lists 4 and 3, both probed by
    # query 1, list 4 first; a zero LUT column makes them the best
    probes[1] = [4, 3, 5, 0]
    codes[4, 5] = codes[3, 9] = 0
    lut_f = rng.random((3, 4, m, ks)).astype(np.float32) * 40 + 5
    lut_f[..., 0] = 0.0
    slab = [torch.from_numpy(a).to(dev) for a in (codes, ids, mask, probes)]
    for lut in (torch.from_numpy(lut_f).to(dev),
                torch.from_numpy(lut_f).to(dev).to(torch.bfloat16),
                torch.from_numpy(np.round(lut_f).astype(np.uint8)).to(dev)):
        args = (lut.contiguous(), *slab)
        err = max(err, compare_adc_pools(ads, args, 16,
                                         f"K2 ragged {lut.dtype}"))
        kv, ki = ads.adc_pool_scan(*args, r=16)
        if not (bool((ki[0, 11:] == -1).all())
                and bool(torch.isneginf(kv[0, 11:]).all())):
            raise AssertionError("K2 ragged: pool tail is not (-inf, -1)")
        if ki[1, :2].tolist() != [int(ids[4, 5]), int(ids[3, 9])]:
            raise AssertionError(
                f"K2 planted tie: {ki[1, :2].tolist()}, expected the "
                f"earlier probe's doc {int(ids[4, 5])} first")
        log(f"K2 parity ragged/empty lists + planted tie {lut.dtype}: ok")
    # a build made outside a segment: its owner frees its ledger entry
    index.allocation.free(reason="dropped")
    return err


def adc_bound(index, lut, probes, r: int) -> dict:
    """The least time of one K2 call on these operands: the larger of the
    bytes this run's data needs over 3.35 TB/s and one add per lookup over
    67 T/s. Bytes: each distinct probed list once, however many queries
    probe it (its mask up to its last live slot, m code bytes per live
    slot); every (query, probe) LUT and the probe table; the ids of the
    winners only; the [B, R] pool written. Lookups: m per live slot per
    (query, probe)."""
    b, _p, m, _ks = lut.shape
    mask = index.mask
    live = mask.sum(1)                                        # [nlist]
    extent = (mask * torch.arange(1, mask.shape[1] + 1,
                                  device=mask.device)).amax(1)
    lists = torch.unique(probes.long())
    live_q = live[probes.long()].sum(1)                       # [B]
    nbytes = int(extent[lists].sum() + m * live[lists].sum()
                 + 4 * torch.clamp(live_q, max=r).sum()) \
        + lut.numel() * lut.element_size() + probes.numel() * 4 + b * r * 8
    lookups = int(m * live_q.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = lookups / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "lookups": lookups}


def adc_time(ads, ivfpq, index, queries, r: int, label: str) -> dict:
    """One K2 shape: parity, the wrapper's CUDA-event ms, the plain
    version's, the device ms of each stage read by kernel name under the
    profiler (stage 1 adc_scan_kernel, stage 2 adc_merge_kernel), and the
    bound."""
    args = adc_operands(ads, ivfpq, index, queries, 8, "fp32")
    compare_adc_pools(ads, args, r, label)
    ms = time_ms(lambda: ads.adc_pool_scan(*args, r=r), 50)
    plain_ms = time_ms(lambda: ads.plain_adc_pool(*args, r=r), 5)
    prof = device_profile(lambda: ads.adc_pool_scan(*args, r=r), 20)
    stage1 = kernel_ms(prof, "adc_scan_kernel")
    stage2 = kernel_ms(prof, "adc_merge_kernel")
    bound = adc_bound(index, args[0], args[4], r)
    if prof is not None:
        log(f"{label}: K2 under the profiler: wall {prof['wall_ms']:.4f} ms "
            f"a call, device {prof['device_ms']:.4f} ms a call (stage 1 "
            f"{stage1:.4f}, stage 2 {stage2:.4f}) {prof['top']}")
    log(f"{label}: K2 {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}; {bound['bytes']} "
        f"bytes, {bound['lookups']} lookups)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "device_ms": prof and prof["device_ms"],
            "stage1_device_ms": stage1, "stage2_device_ms": stage2, **bound}


def adc_timing_phase(ads, ivfpq, dev, seed: int) -> dict:
    """K2 at the glove-100 shape (1.2M x 100-d cosine, m = 20, nlist = 512,
    nprobe = 8, R = 64, k = 10 at the default multiplier) at B = 1 and 32,
    and on cell C's index (200,000 such docs, nlist 512) at B = 1 and 8, the
    per-shard route's padded batches."""
    rng = np.random.default_rng(seed + 11)
    out = {}
    for key, n, bs in (("glove", GLOVE_DOCS, (1, 32)),
                       ("cell_c", ANN_MAIN_DOCS, (1, 8))):
        data = ann_corpus(rng, n, ANN_DIM)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = ivfpq.build(data, nlist=512, m=ANN_M, normalized=True,
                            device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        log(f"{key} index build (ivfpq.build on the card): n={n} "
            f"d={ANN_DIM} nlist=512 m={ANN_M} l_pad={index.l_pad} in "
            f"{build_s:.1f} s")
        out[key] = {"n": n, "build_s": build_s, "l_pad": index.l_pad}
        for b in bs:
            q = data[rng.choice(n, b, replace=False)]
            q = q / np.linalg.norm(q, axis=1, keepdims=True)
            out[key][b] = adc_time(ads, ivfpq, index, q, 64,
                                   f"{key} shape B={b}")
        # a build made outside a segment: its owner frees its ledger entry
        index.allocation.free(reason="dropped")
        del index
        torch.cuda.empty_cache()
    return out


def plain_shard_hits(ads, ivfpq, kf, segments, qv, k: int, dev) -> list:
    """A shard's best k (doc id, score) by the plain pipeline on the card,
    one query at a time as the per-shard route runs it: per segment the
    IVF-PQ pipeline with the plain scan (adc_topr_auto impl="xla") or the
    plain exact scan (knn_fused impl="xla"; past FUSED_MAX_K the
    materializing scan's scores), then the shard cut by (-score, segment,
    doc)."""
    from opensearch_tpu_torch.ops.knn import exact_knn_scores
    from opensearch_tpu_torch.ops.topk import stable_topk
    from opensearch_tpu_torch.search.executor import _pad_query_batch

    k_bucket = 1 << (k - 1).bit_length()
    cands = []
    for seg_idx, (_host, dseg) in enumerate(segments):
        vf = dseg.vector_fields["v"]
        valid = vf.present & dseg.live
        if vf.ann is not None:
            q1 = qv[None]
            q1 = q1 / np.maximum(np.linalg.norm(q1, axis=-1, keepdims=True),
                                 1e-12)
            index = vf.ann
            pv, pi = ads.adc_topr_auto(
                index.params.coarse, index.params.codebooks, index.codes,
                index.ids, index.mask, vf.vectors, vf.norms_sq, valid,
                torch.from_numpy(q1).to(dev),
                ivfpq.host_probe_select(index, q1, 8), k=k_bucket,
                rerank=ivfpq.default_rerank(k_bucket), similarity="cosine",
                impl="xla")
        elif k_bucket <= kf.FUSED_MAX_K:
            q = torch.from_numpy(_pad_query_batch([qv])).to(dev)
            pv, pi = kf.knn_fused(vf.vectors, vf.norms_sq, valid, q,
                                  k=k_bucket, similarity="cosine", impl="xla")
        else:
            # the materializing scan's scores, and a stable top-k
            q = torch.from_numpy(qv[None]).to(dev)
            pv, pi = stable_topk(exact_knn_scores(
                q, vf.vectors, vf.norms_sq, valid, "cosine"), k_bucket)
        pv, pi = pv[0].cpu().numpy(), pi[0].cpu().numpy()
        cands += [(float(v), seg_idx, int(d)) for v, d in zip(pv, pi)
                  if d >= 0 and np.isfinite(v)][:k]
    cands.sort(key=lambda c: (-c[0], c[1], c[2]))
    return [(segments[s][0].doc_ids[d], v) for v, s, d in cands[:k]]


def check_hits(what: str, got: list, want: list) -> None:
    if [h[0] for h in got] != [w[0] for w in want] or not np.allclose(
            [h[1] for h in got], [w[1] for w in want], rtol=1e-6, atol=1e-6):
        raise AssertionError(f"{what}: hits {got} != plain {want}")


def ann_filtered_check(node, name: str, kf, ads, data: np.ndarray,
                       attrs: dict, queries: np.ndarray, dev, rng) -> dict:
    """Index C (one IVF-PQ segment) under the relaxed filter, k = 10: a
    filtered query never takes ANN, so each search is one exact K1 launch
    (the list scan at fp32) and no K2 launch, through the stacked step
    (which serves the ANN column when filtered, counted in "filtered") and
    the per-shard route. Every hit list is the cosine brute force over the
    filtered docs summed in the kernel's order."""
    from opensearch_tpu_torch.ops import knn_rescore as kr
    from opensearch_tpu_torch.search import distributed_serving, executor

    body, pred = filter_bodies(rng, len(data))["relaxed"]
    mask = torch.from_numpy(pred(attrs)).to(dev)
    v = torch.from_numpy(data)[None].to(dev)
    nrm = (v.double() ** 2).sum(2).float()
    q = torch.from_numpy(queries).to(dev)
    scores = kernel_order_scores(kf, v, nrm, mask[None], q,
                                 kr.plain_query_sq(q), "cosine")
    truth = [[str(int(i)) for i in row if i >= 0]
             for row in order_top(kf, scores, 10)[1][0].tolist()]
    del v, scores
    out = {}
    try:
        for route in ("stacked", "per_shard"):
            distributed_serving.enabled = route == "stacked"
            kf.launches.reset()
            kf.list_launches.reset()
            ads.launches.reset()
            filtered0 = distributed_serving.stats["filtered"]
            ann0 = executor.knn_path_stats["ann"]
            lat = []
            for i, qv in enumerate(queries):
                t0 = time.perf_counter()
                resp = node.search(name, {"query": {"knn": {"v": {
                    "vector": qv.tolist(), "k": 10, "filter": body}}},
                    "size": 10})
                lat.append(time.perf_counter() - t0)
                hits = [h["_id"] for h in resp["hits"]["hits"]]
                if hits != truth[i]:
                    raise AssertionError(f"[{name}] filtered {route} query "
                                         f"{i}: hits differ from the brute "
                                         f"force over the filtered docs")
            got = {"knn_fused": kf.launches.count,
                   "knn_fused_lists": kf.list_launches.count,
                   "adc_scan": ads.launches.count,
                   "ann": executor.knn_path_stats["ann"] - ann0,
                   "filtered": distributed_serving.stats["filtered"]
                   - filtered0}
            m = len(queries)
            want = {"knn_fused": m, "knn_fused_lists": m, "adc_scan": 0,
                    "ann": 0, "filtered": m if route == "stacked" else 0}
            if got != want:
                raise AssertionError(f"[{name}] filtered {route}: launches "
                                     f"{got}, want {want}")
            out[route] = {**latency_summary(lat), "launches": got}
            log(f"[{name}] relaxed filter {route}: {m} exact K1 searches "
                f"equal the brute force, no K2 launch; {json.dumps(out[route])}")
    finally:
        distributed_serving.enabled = True
    return out


ANN_RANK_REQUESTS = 8


def ann_rank_eval_check(node, name: str, ads, queries: np.ndarray,
                        hits: list, truth) -> dict:
    """One _rank_eval under recall of ANN_RANK_REQUESTS of index C's
    queries, each rated by its exact cosine brute force's top 10: each
    request's metric_score is that query's recall@10 of the phase's own
    search (the same body, so the same hits), one K2 launch a request."""
    from opensearch_tpu_torch.search.rank_eval import rank_eval

    n = ANN_RANK_REQUESTS
    body = {"requests": [
        {"id": f"q{i}", "request": {"query": {"knn": {"v": {
            "vector": queries[i].tolist(), "k": 10}}}},
         "ratings": [{"_index": name, "_id": str(int(j)), "rating": 1}
                     for j in truth[i].tolist()]} for i in range(n)],
        "metric": {"recall": {"k": 10}}}
    ads.launches.reset()
    t0 = time.perf_counter()
    got = rank_eval(node, name, body)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = ads.launches.count
    want = [len({h[0] for h in hits[i]} & {str(int(j)) for j in
                                             truth[i].tolist()}) / 10
            for i in range(n)]
    scores = [got["details"][f"q{i}"]["metric_score"] for i in range(n)]
    if got["failures"] or scores != want or launches != n:
        raise AssertionError(f"[{name}] _rank_eval under recall: {scores} "
                             f"against the searches' recall@10 {want}, "
                             f"{launches} K2 launches, {got['failures']}")
    log(f"[{name}] _rank_eval of {n} kNN requests under recall: each "
        f"metric_score the search's recall@10 ({scores}), {launches} K2 "
        f"launches, {wall_ms:.3f} ms")
    return {"metric_scores": scores, "metric_score": got["metric_score"],
            "launches": launches, "wall_ms": wall_ms}


def ann_main_phase(ads, ivfpq, kf, dev, seed: int) -> dict:
    """Index C through TorchNode on the card: 200,000 clustered 100-d docs,
    cosine, ivf_pq (nlist 512, m 20, nprobe 8), 1 shard, 64 searches. Then
    a second refresh of 300 docs (below min_train, so exact) and 16
    searches over the shard's IVF-PQ and exact segments together, and
    ann_aggs_check's kNN + aggs searches over both."""
    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.ops import adc_lut
    from opensearch_tpu_torch.search import executor

    rng = np.random.default_rng(seed + 12)
    n, name = ANN_MAIN_DOCS, "glove_c"
    data = ann_corpus(rng, n, ANN_DIM)
    attrs = attributes(rng, n)
    queries = (data[rng.choice(n, 64, replace=False)]
               + 0.1 * rng.standard_normal((64, ANN_DIM)).astype(np.float32))

    def search(qv, k: int = 10) -> list:
        resp = node.search(name, {"query": {"knn": {"v": {
            "vector": qv.tolist(), "k": k}}}, "size": 10})
        return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]

    from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

    ledger_base = default_ledger.resident_bytes()
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device=dev)
        t0 = time.perf_counter()
        node.create_index(name, {
            "settings": {"number_of_shards": 1},
            "mappings": {"properties": {"v": {
                "type": "knn_vector", "dimension": ANN_DIM,
                "similarity": "cosine",
                "method": {"name": "ivf_pq", "parameters": {
                    "nlist": 512, "m": ANN_M, "nprobe": 8}}},
                **attribute_mapping()}},
        })
        for s in range(0, n, 5000):
            resp = node.bulk([
                ("index", {"_index": name, "_id": str(i)},
                 {"v": data[i].tolist(), **attribute_doc(attrs, i)})
                for i in range(s, min(s + 5000, n))
            ], refresh=False)
            if resp["errors"]:
                raise AssertionError(f"bulk into [{name}] reported errors")
        t1 = time.perf_counter()
        node.refresh(name)
        torch.cuda.synchronize()
        log(f"[{name}] {n} docs, 1 shard: bulk {t1 - t0:.1f} s, refresh "
            f"with the IVF-PQ build {time.perf_counter() - t1:.1f} s")
        # the counts are read for the searches alone
        ann0 = executor.knn_path_stats["ann"]
        ads.launches.reset()
        adc_lut.launches.reset()
        lat, hits = [], []
        for qv in queries:
            t0 = time.perf_counter()
            hits.append(search(qv))
            lat.append(time.perf_counter() - t0)
        launches = ads.launches.count
        lut_launches = adc_lut.launches.count
        ann_searches = executor.knn_path_stats["ann"] - ann0
        # the exact cosine brute force's top 10 of each query (recall@10)
        dn = torch.from_numpy(data).to(dev)
        dn = dn / torch.clamp(torch.linalg.norm(dn, dim=1, keepdim=True),
                              1e-12)
        qn = torch.from_numpy(queries).to(dev)
        qn = qn / torch.clamp(torch.linalg.norm(qn, dim=1, keepdim=True),
                              1e-12)
        truth = torch.topk(qn @ dn.T, 10).indices.cpu()
        del dn, qn
        rank_eval = ann_rank_eval_check(node, name, ads, queries, hits,
                                        truth)
        # where a search's time goes: device kernels under the profiler, on
        # 16 more searches after the counted window
        prof_q = iter(queries)
        prof = device_profile(lambda: search(next(prof_q)), 16)
        (shard,) = node.indices[name].shards.values()
        segments = shard.acquire_searcher().segments
        if len(segments) != 1 or segments[0][1].vector_fields["v"].ann is None:
            raise AssertionError(f"[{name}] is not one IVF-PQ segment")
        for i, got in enumerate(hits):
            check_hits(f"[{name}] query {i}", got, plain_shard_hits(
                ads, ivfpq, kf, segments, queries[i], 10, dev))
        filtered = ann_filtered_check(node, name, kf, ads, data, attrs,
                                      queries[:16], dev, rng)

        # the second refresh: 64 of its docs sit next to the 16 queries, so
        # the exact segment places hits beside the IVF-PQ one
        n_small, mixed_q = 300, queries[:16]
        extra = (data[rng.choice(n, n_small, replace=False)]
                 + 0.1 * rng.standard_normal((n_small, ANN_DIM)).astype(
                     np.float32))
        extra[:64] = np.repeat(mixed_q, 4, axis=0) + 0.05 * \
            rng.standard_normal((64, ANN_DIM)).astype(np.float32)
        resp = node.bulk([
            ("index", {"_index": name, "_id": str(n + i)},
             {"v": extra[i].tolist()}) for i in range(n_small)
        ], refresh=True)
        if resp["errors"]:
            raise AssertionError(f"bulk into [{name}] reported errors")
        segments = shard.acquire_searcher().segments
        if len(segments) != 2 or segments[1][1].vector_fields["v"].ann \
                is not None:
            raise AssertionError(f"[{name}] is not an IVF-PQ segment beside "
                                 f"an exact one")
        paths0 = dict(executor.knn_path_stats)
        ads.launches.reset()
        kf.launches.reset()
        mixed_hits = [search(qv) for qv in mixed_q]
        mixed = {"k1_launches": kf.launches.count,
                 "k2_launches": ads.launches.count,
                 **{key: executor.knn_path_stats[key] - paths0[key]
                    for key in ("ann", "fused")}}
        for i, got in enumerate(mixed_hits):
            check_hits(f"[{name}] two segments, query {i}", got,
                       plain_shard_hits(ads, ivfpq, kf, segments, mixed_q[i],
                                        10, dev))
        mixed["exact_hits"] = sum(int(h[0]) >= n for got in mixed_hits
                                  for h in got)
        # K1 against its plain pool on the exact segment's own operands
        dseg1 = segments[1][1]
        vf1 = dseg1.vector_fields["v"]
        q = torch.from_numpy(executor._pad_query_batch([mixed_q[0]])).to(dev)
        args, r = scan_inputs(kf, vf1.vectors[None], vf1.norms_sq[None],
                              (vf1.present & dseg1.live)[None], q, 16, "fp32")
        compare_pools(kf, args, r, "cosine", "fp32",
                      f"K1 on the exact segment (n_pad={dseg1.n_pad})")
        # k = 256: past FUSED_MAX_K the 300-doc segment materializes
        paths0 = dict(executor.knn_path_stats)
        k256_hits = [search(qv, 256) for qv in mixed_q]
        mixed["k256"] = {key: executor.knn_path_stats[key] - paths0[key]
                         for key in ("ann", "fused", "materializing",
                                     "streaming")}
        if mixed["k256"] != {"ann": 16, "fused": 0, "materializing": 16,
                             "streaming": 0}:
            raise AssertionError(f"two-segment k=256 branches: {mixed}")
        for i, got in enumerate(k256_hits):
            check_hits(f"[{name}] two segments k=256, query {i}", got,
                       plain_shard_hits(ads, ivfpq, kf, segments, mixed_q[i],
                                        256, dev)[:10])
        log(f"[{name}] two segments, k=256: 16 searches equal the plain "
            f"pipeline; the exact segment materialized each time")
        batch = ann_batch_check(ads, ivfpq, segments[0], queries, dev)
        concurrent = concurrent_phase(
            node, name, queries, 10,
            {"adc_scan": ads.launches, "knn_fused": kf.launches})
        ann_aggs = ann_aggs_check(node, name, kf, ads, queries, attrs, n)
        # the residency ledger over index C's exact columns, IVF-PQ slab,
        # exact second segment and filtered searches' serving bundle
        # a search over the IVF-PQ segment and the exact one: one K2
        # launch and one K1 launch, each one roofline launch
        ledger = ledger_gate(node, name, name, [
            {"query": {"knn": {"v": {"vector": qv.tolist(), "k": 10}}},
             "size": 10} for qv in queries[:4]], ledger_base,
            per_search={"ivfpq_adc_pallas": 1, "knn_fused_pallas": 1})
        node.close()
    # recall@10 against exact cosine brute force (reported, not gated)
    recall = float(np.mean([
        len({int(h[0]) for h in got} & set(truth[i].tolist())) / 10
        for i, got in enumerate(hits)]))
    lat_ms = np.asarray(lat) * 1e3
    out = {"launches": launches, "searches": ann_searches, "recall": recall,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "qps": 64 / sum(lat), "mixed": mixed, "concurrent": concurrent,
           "filtered": filtered, "batch": batch,
           "lut_launches": lut_launches, "ledger": ledger,
           "aggs": ann_aggs, "rank_eval": rank_eval}
    log(f"[{name}] 64 searches equal the plain pipeline; recall@10 vs exact "
        f"cosine = {recall:.4f}; p50 {out['p50_ms']:.3f} ms, p99 "
        f"{out['p99_ms']:.3f} ms, QPS {out['qps']:.1f}")
    if prof is not None:
        # idle share against the unprofiled mean wall of a search: the
        # profiler itself slows the host
        out["device_ms"] = prof["device_ms"]
        out["idle_share"] = max(0.0, 1.0 - prof["device_ms"]
                                / float(lat_ms.mean()))
        log(f"[{name}] device time of a search {prof['device_ms']:.4f} ms "
            f"(wall {prof['wall_ms']:.3f} ms under the profiler, "
            f"{lat_ms.mean():.3f} ms without): idle share "
            f"{out['idle_share']:.4f}; top kernels {prof['top']}")
    if ann_searches != 64:
        raise AssertionError(f"{ann_searches} of 64 searches took the ANN "
                             f"branch")
    if launches < 64:
        raise AssertionError(f"K2 launched {launches} times in 64 searches")
    if lut_launches != launches:
        raise AssertionError(f"the LUT kernel launched {lut_launches} times "
                             f"beside {launches} K2 launches")
    log(f"ANN main path: {ann_searches} ANN searches, {launches} K2 launches")
    if (mixed["ann"], mixed["fused"]) != (16, 16) or min(
            mixed["k1_launches"], mixed["k2_launches"]) < 16:
        raise AssertionError(f"two-segment searches: {mixed}")
    if mixed["exact_hits"] == 0:
        raise AssertionError("no hit of the two-segment searches came from "
                             "the exact segment")
    log(f"two-segment shard: 16 searches equal the plain pipeline, "
        f"{mixed}")
    return out


def large_kernels(kf, dev, seed: int, entry: dict, large_mma_entry: dict,
                  select_entry: dict) -> None:
    """K1's large-r checks (both scans, the select's stress rows) into the
    kernels record."""
    entry["max_abs_err"] = max(entry["max_abs_err"] or 0.0,
                               large_kernel_phase(kf, dev, seed))
    large_mma_entry["max_abs_err"] = large_mma_kernel_phase(kf, dev, seed)
    large_mma_entry["parity"] = ("int8 bit-equal; bf16 bit-equal on exact "
                                 "sums, ids equal but at logged summation "
                                 "ties on floats")
    rows = select_stress_check(kf, dev, seed)
    select_entry["max_abs_err"] = 0.0
    select_entry["parity"] = (f"bit-equal, both sorts and the yardstick: to "
                              f"the tier's pool at every large-r check, to "
                              f"plain_large_select on {rows} stress rows")


def large_records(kf, dev, seed: int, entry: dict, large_mma_entry: dict,
                  select_entry: dict) -> None:
    """K1's large-r records (both scans, the select) into the kernels
    record."""
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    large = large_timing(kf, dev, seed)
    entry["large_shapes"] = large
    lm = large_mma_timing(kf, dev, seed)
    large_mma_entry.update({key: lm[LARGE_MMA_HEADLINE][key] for key in
                            (*fields, "device_ms", "scan_device_ms",
                             "select_device_ms")})
    large_mma_entry["shape"] = LARGE_MMA_HEADLINE
    large_mma_entry["serving_shapes"] = lm
    head = large[LARGE_SELECT_HEADLINE]
    sort = head["sort"]
    select_entry.update({
        "ms": head["select_ms"][sort],
        "device_ms": head["select_device"][sort],
        "plain_ms": head["select_plain_ms"],
        "bound_ms": head["select_bound_ms"],
        "bound_by": head["select_bound_by"],
        "library_ms": head["select_library_ms"],
        "yardstick_ms": head["yardstick_ms"],
        "yardstick_device_ms": head["yardstick_device_ms"],
        "sort": sort, "shape": LARGE_SELECT_HEADLINE + " fp32"})
    select_entry["serving_shapes"] = {
        label: {key: rec[key] for key in
                ("sort", "select_ms", "select_device", "select_device_ms",
                 "yardstick_ms", "yardstick_device_ms", "select_plain_ms",
                 "select_library_ms", "select_bound_ms")}
        for label, rec in {**large, **lm}.items()}


# index L: MS MARCO passage-shaped text (BEIR, Thakur et al. 2021, Table 1:
# 55.98 words a passage, 5.96 a query) over a Zipf vocabulary, beside
# cell A's clustered vectors; 100,000 passages, cut from the corpus's 8.8M by
# the default run's time (its host ingest, aggregations and DSL loops move
# with the docs)
LEXICAL_DOCS = 100_000
LEXICAL_VOCAB = 100_000
LEXICAL_ZIPF_S = 1.07
LEXICAL_TAGS = 1_000
LEXICAL_QUERIES = 64         # searches of each type
LEXICAL_TRUTH = 16           # of them held to the fp64 numpy BM25
LEXICAL_HTTP = 8             # of them over HTTP
LEXICAL_PER_SHARD = 16       # filtered kNN searches on the per-shard route
BM25_K1, BM25_B = 1.2, 0.75
LEXICAL_TS0 = 1_672_531_200_000   # 2023-01-01T00:00:00Z, epoch ms


def lexical_word(i: int) -> str:
    """The i-th synthetic word, letters only, so the standard analyzer
    keeps it as one token."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    out = ""
    i += 27
    while i:
        out = letters[i % 26] + out
        i //= 26
    return out


def zipf_probs(n: int, s: float) -> np.ndarray:
    p = np.arange(1, n + 1, dtype=np.float64) ** -s
    return p / p.sum()


class TokenIndex:
    """An inverted index over a flat token CSR (tokens [T] int32 and each
    doc's offsets [n+1]), built with numpy alone: the fp64 truth's view of
    a text field, independent of the port's segment code."""

    def __init__(self, tokens: np.ndarray, offsets: np.ndarray):
        self.tokens, self.offsets = tokens, offsets
        n = len(offsets) - 1
        self.doc_len = np.diff(offsets).astype(np.float64)
        doc_of = np.repeat(np.arange(n, dtype=np.int32), np.diff(offsets))
        order = np.argsort(tokens, kind="stable")
        self.sorted_docs = doc_of[order]
        self.bounds = np.searchsorted(tokens[order],
                                      np.arange(LEXICAL_VOCAB + 1))
        self.n = n
        self.avgdl = float(self.doc_len.sum()) / n

    def postings(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        docs = self.sorted_docs[self.bounds[t]:self.bounds[t + 1]]
        return np.unique(docs, return_counts=True)

    def term_scores(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """(docs, fp64 BM25 term scores) of term t: Lucene's idf and
        idf * tf / (tf + k1 * (1 - b + b * dl / avgdl))."""
        docs, tf = self.postings(t)
        df = len(docs)
        idf = math.log(1.0 + (self.n - df + 0.5) / (df + 0.5))
        dl = self.doc_len[docs]
        tf = tf.astype(np.float64)
        return docs, idf * tf / (tf + BM25_K1 * (1 - BM25_B
                                                 + BM25_B * dl / self.avgdl))

    def match(self, terms: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """(fp64 scores [n], matched-term counts [n]) of an OR of terms."""
        scores = np.zeros(self.n)
        counts = np.zeros(self.n, np.int64)
        for t in terms:
            docs, s = self.term_scores(t)
            scores[docs] += s
            counts[docs] += 1
        return scores, counts

    def phrase(self, terms: list[int]) -> np.ndarray:
        """bool [n]: docs holding the terms at consecutive positions."""
        counts = self.match(terms)[1]
        out = np.zeros(self.n, bool)
        for d in np.nonzero(counts == len(terms))[0]:
            seq = self.tokens[self.offsets[d]:self.offsets[d + 1]]
            hit = np.ones(len(seq) - len(terms) + 1, bool) \
                if len(seq) >= len(terms) else np.zeros(0, bool)
            for j, t in enumerate(terms):
                hit &= seq[j:len(seq) - len(terms) + 1 + j] == t
            out[d] = bool(hit.any())
        return out


def lexical_corpus(rng, n: int) -> dict:
    """Index L's columns from the seed: body token ids (28-84 a doc, mean
    56, Zipf s = 1.07 over 100,000 words), title token ids (5-12), a Zipf
    tag of 1,000 values, views (long, log-normal), ts (a date within a
    year, ms) and cell A's clustered 128-d vectors rounded to eighths, so
    every dot is exact in f32 in any order and K1 and its plain version
    give the same bits."""
    p = zipf_probs(LEXICAL_VOCAB, LEXICAL_ZIPF_S)
    body_len = rng.integers(28, 85, n)
    title_len = rng.integers(5, 13, n)
    body = rng.choice(LEXICAL_VOCAB, int(body_len.sum()), p=p).astype(
        np.int32)
    title = rng.choice(LEXICAL_VOCAB, int(title_len.sum()), p=p).astype(
        np.int32)
    return {
        "body": body, "body_off": np.concatenate(([0], np.cumsum(body_len))),
        "title": title,
        "title_off": np.concatenate(([0], np.cumsum(title_len))),
        "tag": rng.choice(LEXICAL_TAGS, n,
                          p=zipf_probs(LEXICAL_TAGS, LEXICAL_ZIPF_S)),
        "views": np.minimum(rng.lognormal(6.0, 2.0, n), 2**40).astype(
            np.int64),
        "ts": LEXICAL_TS0 + rng.integers(0, 365 * 86_400_000, n),
        "v": np.round(clustered(rng, n, DIM) * 8.0) / 8.0,
    }


def lexical_ingest(node, name: str, corpus: dict, words: list) -> float:
    """Index L into one shard by host _bulk (5,000 docs a request) and one
    refresh, with the dsl phase's fields (dsl_fields); returns the wall
    seconds."""
    node.create_index(name, {
        "settings": {"number_of_shards": 1},
        "mappings": {"properties": {
            "body": {"type": "text"}, "title": {"type": "text"},
            "tag": {"type": "keyword"}, "views": {"type": "long"},
            "ts": {"type": "date"},
            "v": {"type": "knn_vector", "dimension": DIM,
                  "similarity": "l2_norm"},
            "loc": {"type": "geo_point"}, "pop": {"type": "rank_feature"},
            "need": {"type": "long"}}}})
    body, bo = corpus["body"], corpus["body_off"]
    title, to = corpus["title"], corpus["title_off"]
    n = len(bo) - 1
    t0 = time.perf_counter()
    for s in range(0, n, 5000):
        ops = []
        for i in range(s, min(s + 5000, n)):
            ops.append(("index", {"_index": name, "_id": str(i)}, {
                "body": " ".join([words[t] for t in body[bo[i]:bo[i + 1]]]),
                "title": " ".join([words[t]
                                   for t in title[to[i]:to[i + 1]]]),
                "tag": f"g{int(corpus['tag'][i])}",
                "views": int(corpus["views"][i]),
                "ts": int(corpus["ts"][i]),
                "v": corpus["v"][i].tolist(),
                "loc": {"lat": float(corpus["lat"][i]),
                        "lon": float(corpus["lon"][i])},
                "pop": float(corpus["pop"][i]),
                "need": int(corpus["need"][i])}))
        if node.bulk(ops, refresh=False)["errors"]:
            raise AssertionError(f"bulk into [{name}] reported errors")
    node.refresh(name)
    return time.perf_counter() - t0


def f32_bound(a: float, b: float, n_terms: int) -> float:
    """How far f32 arithmetic can move two fp64 BM25 sums of n_terms terms
    apart: each term's score takes about eight roundings (idf, avgdl, the
    quotient, the products), the sum one more a term."""
    return (8 + 2 * n_terms) * 2.0 ** -24 * (abs(a) + abs(b))


def ranked_check(label: str, got: list, scores: np.ndarray, mask: np.ndarray,
                 k: int, n_terms: int) -> list:
    """Hit ids (ints) against the fp64 top-k by (-score, doc) over `mask`:
    equal, apart from pairs whose fp64 scores lie within the f32 bound of
    each other, each returned (and logged by the caller)."""
    cand = np.nonzero(mask)[0]
    want = cand[np.lexsort((cand, -scores[cand]))][:k].tolist()
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} hits, the fp64 BM25 "
                             f"has {len(want)}")
    pairs = []
    for g, w in zip(got, want):
        if g == w:
            continue
        if not mask[g] or abs(scores[g] - scores[w]) > f32_bound(
                scores[g], scores[w], n_terms):
            raise AssertionError(
                f"{label}: hit {g} (fp64 {scores[g]!r}) where the fp64 "
                f"BM25 ranks {w} ({scores[w]!r})")
        pairs.append((g, w, float(scores[g]), float(scores[w])))
    return pairs


def lexical_bodies(rng, corpus: dict, words: list, n: int) -> dict:
    """LEXICAL_QUERIES request bodies of each type, from the seed, each
    with what the checks need: query terms drawn from a random doc (so a
    query matches something), phrases of consecutive tokens whose terms are
    not among the 100 most common, tags and bounds from the columns."""
    bo, body = corpus["body_off"], corpus["body"]
    tag_counts = np.bincount(corpus["tag"], minlength=LEXICAL_TAGS)
    mid_tags = np.nonzero((tag_counts >= 30) & (tag_counts <= 2000))[0]
    src = {"excludes": ["v"]}

    def doc_terms(i: int) -> np.ndarray:
        return body[bo[i]:bo[i + 1]]

    def distinct(seq: np.ndarray, m: int) -> list[int]:
        out = []
        for t in seq[rng.permutation(len(seq))]:
            if int(t) not in out:
                out.append(int(t))
            if len(out) == m:
                break
        return out

    def phrase_terms(i: int, m: int) -> list[int] | None:
        seq = doc_terms(i)
        starts = [s for s in range(len(seq) - m + 1)
                  if seq[s:s + m].min() >= 100
                  and len(set(seq[s:s + m].tolist())) == m]
        if not starts:
            return None
        s = starts[int(rng.integers(len(starts)))]
        return [int(t) for t in seq[s:s + m]]

    def text(terms: list[int]) -> str:
        return " ".join(words[t] for t in terms)

    def qvec(i: int) -> list:
        q = corpus["v"][i] + np.round(
            rng.standard_normal(DIM) * 0.4 * 8) / 8
        return q.astype(np.float32).tolist()

    out = {name: [] for name in (
        "match_or", "match_and", "match_phrase", "multi_match",
        "query_string", "bool", "term", "terms", "range_views", "range_ts",
        "prefix", "wildcard", "sort_search_after", "rescore", "collapse",
        "bool_knn", "knn_match_filter", "knn_prefix_filter")}
    views_q = np.quantile(corpus["views"], [0.2, 0.5, 0.9])
    while min(len(v) for v in out.values()) < LEXICAL_QUERIES:
        i = int(rng.integers(n))
        seq = doc_terms(i)
        tag = f"g{int(corpus['tag'][i])}"
        if len(out["match_or"]) < LEXICAL_QUERIES:
            terms = distinct(seq, 6)
            out["match_or"].append(({"query": {"match": {"body": text(
                terms)}}}, {"terms": terms}))
        if len(out["match_and"]) < LEXICAL_QUERIES:
            terms = distinct(seq, 2)
            out["match_and"].append(({"query": {"match": {"body": {
                "query": text(terms), "operator": "and"}}}},
                {"terms": terms}))
        ph = phrase_terms(i, 2 + int(rng.integers(2)))
        if ph is not None and len(out["match_phrase"]) < LEXICAL_QUERIES:
            out["match_phrase"].append(({"query": {"match_phrase": {
                "body": text(ph)}}}, {"terms": ph}))
        if len(out["multi_match"]) < LEXICAL_QUERIES:
            terms = distinct(seq, 3)
            out["multi_match"].append(({"query": {"multi_match": {
                "query": text(terms), "fields": ["body", "title"]}}},
                {"terms": terms}))
        if len(out["query_string"]) < LEXICAL_QUERIES:
            terms = distinct(seq, 3)
            out["query_string"].append(({"query": {"query_string": {
                "query": f"{words[terms[0]]} AND ({words[terms[1]]} OR "
                         f"{words[terms[2]]})", "fields": ["body"]}}},
                {"terms": terms}))
        if len(out["bool"]) < LEXICAL_QUERIES:
            terms = distinct(seq, 3)
            ts_cut = int(np.quantile(corpus["ts"], 0.1))
            out["bool"].append(({"query": {"bool": {
                "must": [{"match": {"body": text(terms)}}],
                "filter": [{"term": {"tag": tag}},
                           {"range": {"views": {"lte": int(views_q[2])}}}],
                "must_not": [{"range": {"ts": {"lt": ts_cut}}}]}}},
                {"terms": terms, "tag": int(corpus["tag"][i]),
                 "views_lte": int(views_q[2]), "ts_lt": ts_cut}))
        if len(out["term"]) < LEXICAL_QUERIES:
            out["term"].append(({"query": {"term": {"tag": tag}}},
                                {"tags": [int(corpus["tag"][i])]}))
        if len(out["terms"]) < LEXICAL_QUERIES:
            tags = sorted({int(corpus["tag"][i]),
                           int(rng.integers(LEXICAL_TAGS)),
                           int(rng.integers(LEXICAL_TAGS))})
            out["terms"].append(({"query": {"terms": {
                "tag": [f"g{t}" for t in tags]}}}, {"tags": tags}))
        if len(out["range_views"]) < LEXICAL_QUERIES:
            lo = int(corpus["views"][i])
            hi = lo + int(views_q[1])
            out["range_views"].append(({"query": {"range": {"views": {
                "gte": lo, "lt": hi}}}}, {"gte": lo, "lt": hi}))
        if len(out["range_ts"]) < LEXICAL_QUERIES:
            lo = int(corpus["ts"][i])
            hi = lo + 7 * 86_400_000
            out["range_ts"].append(({"query": {"range": {"ts": {
                "gt": lo, "lte": hi}}}}, {"gt": lo, "lte": hi}))
        if len(out["prefix"]) < LEXICAL_QUERIES:
            pre = tag[: 2 + int(rng.integers(2))]
            out["prefix"].append(({"query": {"prefix": {"tag": pre}}},
                                  {"prefix": pre}))
        if len(out["wildcard"]) < LEXICAL_QUERIES and len(tag) >= 3:
            j = 1 + int(rng.integers(len(tag) - 1))
            pat = tag[:j] + "?" + tag[j + 1:] + "*"
            out["wildcard"].append(({"query": {"wildcard": {"tag": pat}}},
                                    {"pattern": pat}))
        if len(out["sort_search_after"]) < LEXICAL_QUERIES:
            t = int(mid_tags[int(rng.integers(len(mid_tags)))])
            out["sort_search_after"].append(({"query": {"term": {
                "tag": f"g{t}"}}, "sort": [{"ts": "desc"}]}, {"tags": [t]}))
        if ph is not None and len(out["rescore"]) < LEXICAL_QUERIES:
            terms = distinct(seq, 3)
            out["rescore"].append(({"query": {"match": {"body": text(
                terms)}}, "rescore": {"window_size": 50, "query": {
                    "rescore_query": {"match_phrase": {"body": text(ph)}}}}},
                {"terms": terms}))
        if len(out["collapse"]) < LEXICAL_QUERIES:
            terms = distinct(seq, 2)
            out["collapse"].append(({"query": {"match": {"body": text(
                terms)}}, "collapse": {"field": "tag"}}, {"terms": terms}))
        if len(out["bool_knn"]) < LEXICAL_QUERIES:
            terms = distinct(seq, 3)
            out["bool_knn"].append(({"query": {"bool": {"should": [
                {"match": {"body": text(terms)}},
                {"knn": {"v": {"vector": qvec(i), "k": 10}}}]}}},
                {"terms": terms}))
        if len(out["knn_match_filter"]) < LEXICAL_QUERIES:
            terms = distinct(seq, 2)
            out["knn_match_filter"].append(({"query": {"knn": {"v": {
                "vector": qvec(i), "k": 10,
                "filter": {"match": {"body": text(terms)}}}}}},
                {"terms": terms}))
        if len(out["knn_prefix_filter"]) < LEXICAL_QUERIES:
            pre = tag[: 2 + int(rng.integers(2))]
            out["knn_prefix_filter"].append(({"query": {"knn": {"v": {
                "vector": qvec(i), "k": 10,
                "filter": {"prefix": {"tag": pre}}}}}}, {"prefix": pre}))
    for runs in out.values():
        for body, _meta in runs:
            body["size"] = 10
            body["_source"] = src
    return out


def lexical_truth_mask(kind: str, meta: dict, corpus: dict,
                       tag_names: np.ndarray, body_idx: TokenIndex):
    """The exact numpy set of docs a query matches (structured types), or
    (fp64 scores, mask, n_terms) of a BM25 type; None where not checked."""
    import fnmatch

    if kind in ("term", "terms", "sort_search_after"):
        return np.isin(corpus["tag"], meta["tags"])
    if kind == "range_views":
        return (corpus["views"] >= meta["gte"]) & (corpus["views"] < meta["lt"])
    if kind == "range_ts":
        return (corpus["ts"] > meta["gt"]) & (corpus["ts"] <= meta["lte"])
    if kind in ("prefix", "knn_prefix_filter"):
        ok = np.asarray([t.startswith(meta["prefix"]) for t in tag_names])
        return ok[corpus["tag"]]
    if kind == "wildcard":
        ok = np.asarray([fnmatch.fnmatchcase(t, meta["pattern"])
                         for t in tag_names])
        return ok[corpus["tag"]]
    if kind in ("collapse", "knn_match_filter"):
        return body_idx.match(meta["terms"])[1] > 0
    return None


def lexical_main_phase(kf, dev, seed: int, n_docs: int = LEXICAL_DOCS,
                       aggs: bool = False, dsl: bool = False) -> dict:
    """The lexical query phase on index L (LEXICAL_DOCS docs: a text body
    shaped like MS MARCO passages, a title, a Zipf keyword tag, views, a
    date ts and cell A's clustered vectors rounded to eighths; all from
    the seed), one shard, written by host _bulk and one refresh. Then
    LEXICAL_QUERIES searches (size 10) of each type of lexical_bodies,
    each run twice (the same bits), with these gates:

    1. BM25 types (match or / and, match_phrase, multi_match over body
       and title, query_string, bool of a must match, a filter term and
       range and a must_not): the first LEXICAL_TRUTH searches' ids equal
       an fp64 numpy BM25 over the generated tokens (TokenIndex), apart
       from pairs within the f32 error bound of their scores, each logged;
       their totals the numpy counts;
    2. structured types (term, terms, range on views and on ts, prefix,
       wildcard, the ts-desc sort): totals the exact numpy counts, the
       sort paged 3 deep by search_after equal to numpy's (-ts, doc)
       order; collapse: the match's total, one hit a tag;
    3. bool{should: [match, knn]} and knn filtered by a match and by a
       prefix: K1 launches (kf.launches and the counter of the tier
       scan_tier names), one a segment a search on the per-shard route
       (the bool) and one a search on the stacked step (the filtered knn;
       LEXICAL_PER_SHARD more on the per-shard route), every filtered hit
       inside the filter's docs; then the same searches under
       search.knn.kernel xla (K1's plain version) give the same hits bit
       for bit;
    4. over the port's HTTP server, LEXICAL_HTTP searches of each type give
       the in-process response's hits, and _count equals hits.total for
       each type, in process and over HTTP.
    Recorded: ingest s, p50 / p99 / QPS of each type, the profiler's
    device ms of bm25_term_scores alone and of one match search with its
    top kernels beside the search's host wall, and K1's launches. With
    `aggs`, aggs_main_phase runs on the node before its ledger gate, and
    with `dsl` dsl_main_phase after it."""
    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.ops import bm25 as bm25_ops
    from opensearch_tpu_torch.search import distributed_serving

    rng = np.random.default_rng(seed + 15)
    words = [lexical_word(i) for i in range(LEXICAL_VOCAB)]
    corpus = lexical_corpus(rng, n_docs)
    corpus.update(dsl_fields(seed, n_docs))
    body_idx = TokenIndex(corpus["body"], corpus["body_off"])
    title_idx = TokenIndex(corpus["title"], corpus["title_off"])
    tag_names = np.asarray([f"g{t}" for t in range(LEXICAL_TAGS)])
    bodies = lexical_bodies(rng, corpus, words, n_docs)
    out = {"docs": n_docs, "types": {}}
    tier_counter = {"lists": kf.list_launches, "wide": kf.wide_launches,
                    "mma": kf.mma_launches}
    from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

    ledger_base = default_ledger.resident_bytes()
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device=dev)
        out["ingest_s"] = lexical_ingest(node, "lex", corpus, words)
        (shard,) = node.indices["lex"].shards.values()
        segments = shard.acquire_searcher().segments
        out["segments"] = len(segments)
        log(f"[lex] {n_docs} docs (body mean "
            f"{body_idx.avgdl:.2f} tokens), {len(segments)} segment(s): "
            f"bulk + refresh {out['ingest_s']:.1f} s")
        responses = {}
        for kind, runs in bodies.items():
            label = f"[lex] {kind}"
            for c in (kf.launches, *tier_counter.values()):
                c.reset()
            filtered0 = distributed_serving.stats["filtered"]
            lat, resps, pairs = [], [], 0
            for j, (body, meta) in enumerate(runs):
                if kind == "sort_search_after":
                    t0 = time.perf_counter()
                    pages = sorted_pages(node, body)
                    lat.append((time.perf_counter() - t0) / 3)
                    resp = pages[0]
                    got = [int(h["_id"]) for p in pages
                           for h in p["hits"]["hits"]]
                    mask = lexical_truth_mask(kind, meta, corpus, tag_names,
                                              body_idx)
                    cand = np.nonzero(mask)[0]
                    want = cand[np.lexsort((cand, -corpus["ts"][cand]))][
                        :30].tolist()
                    if got != want:
                        raise AssertionError(f"{label} query {j}: pages "
                                             f"{got} != numpy {want}")
                    resps.append([p["hits"] for p in pages])
                else:
                    t0 = time.perf_counter()
                    resp = node.search("lex", dict(body))
                    lat.append(time.perf_counter() - t0)
                    resps.append(resp["hits"])
                total = resp["hits"]["total"]["value"]
                ids = [int(h["_id"]) for h in resp["hits"]["hits"]]
                if j < LEXICAL_TRUTH:
                    pairs += lexical_gate(kind, meta, label, j, resp, ids,
                                          total, corpus, tag_names,
                                          body_idx, title_idx)
                if kind in ("knn_match_filter", "knn_prefix_filter"):
                    allowed = lexical_truth_mask(kind, meta, corpus,
                                                 tag_names, body_idx)
                    if not all(allowed[d] for d in ids) or not ids:
                        raise AssertionError(f"{label} query {j}: a hit "
                                             f"outside the filter")
                if kind == "collapse" and len({h["fields"]["tag"][0] for h in
                                               resp["hits"]["hits"]}) \
                        != len(ids):
                    raise AssertionError(f"{label} query {j}: two hits of "
                                         f"one tag")
            got_launches = {"knn_fused": kf.launches.count,
                            **{t: c.count for t, c in tier_counter.items()},
                            "filtered": distributed_serving.stats["filtered"]
                            - filtered0}
            res = latency_summary(lat)
            res.update(launches=got_launches, f32_tie_pairs=pairs)
            if kind in ("bool_knn", "knn_match_filter", "knn_prefix_filter"):
                lexical_k1_gate(kf, label, kind, got_launches,
                                len(segments))
            # the same bits run after run
            for j, (body, _meta) in enumerate(runs):
                again = ([p["hits"] for p in sorted_pages(node, body)]
                         if kind == "sort_search_after"
                         else node.search("lex", dict(body))["hits"])
                if again != resps[j]:
                    raise AssertionError(f"{label} query {j}: a second run "
                                         f"gave other hits or bits")
            # _count equals hits.total
            count = node.count("lex", {"query": runs[0][0]["query"]})
            want_total = (resps[0][0] if kind == "sort_search_after"
                          else resps[0])["total"]["value"]
            if count["count"] != want_total:
                raise AssertionError(f"{label}: _count {count} != "
                                     f"hits.total {want_total}")
            responses[kind] = resps
            out["types"][kind] = res
            log(f"{label}: {json.dumps(res)}")
        out["knn"] = lexical_knn_checks(node, kf, bodies, responses,
                                        tier_counter, len(segments))
        out["http"] = lexical_http_checks(node, bodies, responses)
        out["profile"] = lexical_profile(node, shard, bodies, bm25_ops)
        if aggs:
            out["aggs"] = aggs_main_phase(node, kf, dev, seed, corpus, words,
                                          body_idx, len(segments))
        if dsl:
            out["dsl"] = dsl_main_phase(node, kf, dev, seed, corpus, words,
                                        body_idx, len(segments))
        # the ledger over index L's text, keyword, numeric and vector
        # columns; the profiled match leaves the bm25_term_scores row
        out["ledger"] = ledger_gate(
            node, "lex", "lex", [dict(b) for b, _m in bodies["match_or"][:4]],
            ledger_base)
        node.close()
    return out


def sorted_pages(node, body: dict) -> list:
    """Three pages of a sorted body through search_after, each cursor the
    previous page's last sort values."""
    pages = [node.search("lex", dict(body))]
    for _ in range(2):
        after = pages[-1]["hits"]["hits"][-1]["sort"]
        pages.append(node.search("lex", {**body, "search_after": after}))
    return pages


def lexical_gate(kind: str, meta: dict, label: str, j: int, resp: dict,
                 ids: list, total: int, corpus: dict, tag_names,
                 body_idx: TokenIndex, title_idx: TokenIndex) -> int:
    """Gates 1 and 2 of one search: the fp64 BM25 ranking (pairs within
    the f32 bound logged and counted) and the exact numpy totals."""
    pairs = []
    if kind in ("match_or", "match_and", "match_phrase", "query_string",
                "bool", "multi_match"):
        terms = meta["terms"]
        scores, counts = body_idx.match(terms)
        if kind == "match_or":
            mask = counts > 0
        elif kind == "match_and":
            mask = counts == len(terms)
        elif kind == "match_phrase":
            mask = body_idx.phrase(terms)
        elif kind == "query_string":
            # t0 AND (t1 OR t2): each matched term's score summed
            has = [body_idx.match([t])[1] > 0 for t in terms]
            mask = has[0] & (has[1] | has[2])
        elif kind == "bool":
            mask = ((counts > 0) & (corpus["tag"] == meta["tag"])
                    & (corpus["views"] <= meta["views_lte"])
                    & ~(corpus["ts"] < meta["ts_lt"]))
        else:  # multi_match best_fields: the better field's score
            t_scores, t_counts = title_idx.match(terms)
            mask = (counts > 0) | (t_counts > 0)
            scores = np.maximum(scores, t_scores)
        pairs = ranked_check(f"{label} query {j}", ids, scores, mask, 10,
                             len(terms))
        for g, w, sg, sw in pairs:
            log(f"{label} query {j}: docs {g} and {w} swap within the f32 "
                f"bound (fp64 {sg!r} / {sw!r})")
        if total != int(mask.sum()):
            raise AssertionError(f"{label} query {j}: total {total} != "
                                 f"numpy {int(mask.sum())}")
        return len(pairs)
    mask = lexical_truth_mask(kind, meta, corpus, tag_names, body_idx)
    if mask is not None and kind not in ("knn_match_filter",
                                         "knn_prefix_filter"):
        if total != int(mask.sum()):
            raise AssertionError(f"{label} query {j}: total {total} != "
                                 f"numpy {int(mask.sum())}")
        if kind != "collapse" and not set(ids) <= set(
                np.nonzero(mask)[0].tolist()):
            raise AssertionError(f"{label} query {j}: a hit outside the "
                                 f"numpy set")
    return 0


def lexical_k1_gate(kf, label: str, kind: str, got: dict,
                    n_segments: int) -> None:
    """K1 launched for every search of a kNN type, on the tier scan_tier
    names: one a segment a search on the per-shard route (a knn inside a
    bool, k bucketed to 16), one a search on the stacked step (a filtered
    knn)."""
    if kind == "bool_knn":
        want, r = LEXICAL_QUERIES * n_segments, kf.fused_pool_width(16,
                                                                     "fp32")
        want_filtered = 0
    else:
        want, r = LEXICAL_QUERIES, kf.fused_pool_width(10, "fp32")
        want_filtered = LEXICAL_QUERIES
    tier = kf.scan_tier("fp32", r)
    if got["knn_fused"] != want or got[tier] != want or \
            got["filtered"] != want_filtered:
        raise AssertionError(f"{label}: want {want} K1 launches on the "
                             f"{tier} tier and {want_filtered} filtered "
                             f"stacked searches: {got}")


def lexical_knn_checks(node, kf, bodies: dict, responses: dict,
                       tier_counter: dict, n_segments: int) -> dict:
    """The filtered knn types on the per-shard route too (K1 through the
    batcher, one launch a segment), then every kNN type under
    search.knn.kernel xla, K1's plain version (the stacked step's
    impl="xla" scan, the per-shard route's streaming scan): the same hits
    as the kernel's, bit for bit (index L's vectors are eighths, so every
    dot is exact in any order)."""
    from opensearch_tpu_torch.search import ann, distributed_serving

    out = {}
    try:
        distributed_serving.enabled = False
        for kind in ("knn_match_filter", "knn_prefix_filter"):
            for c in (kf.launches, *tier_counter.values()):
                c.reset()
            lat = []
            for j, (body, _meta) in enumerate(
                    bodies[kind][:LEXICAL_PER_SHARD]):
                t0 = time.perf_counter()
                hits = node.search("lex", dict(body))["hits"]
                lat.append(time.perf_counter() - t0)
                if hits != responses[kind][j]:
                    raise AssertionError(f"[lex] {kind} per-shard query "
                                         f"{j}: not the stacked step's bits")
            tier = kf.scan_tier("fp32", kf.fused_pool_width(16, "fp32"))
            want = LEXICAL_PER_SHARD * n_segments
            if kf.launches.count != want or tier_counter[tier].count != want:
                raise AssertionError(f"[lex] {kind} per-shard: "
                                     f"{kf.launches.count} K1 launches, "
                                     f"want {want} on the {tier} tier")
            res = latency_summary(lat)
            res["launches"] = {"knn_fused": kf.launches.count,
                               tier: tier_counter[tier].count}
            out[f"{kind} per_shard"] = res
            log(f"[lex] {kind} on the per-shard route: the stacked step's "
                f"hits bit for bit; {json.dumps(res)}")
        distributed_serving.enabled = True
        ann.default_config.configure(exact_kernel="xla")
        kf.launches.reset()
        for kind in ("bool_knn", "knn_match_filter", "knn_prefix_filter"):
            for j, (body, _meta) in enumerate(bodies[kind]):
                hits = node.search("lex", dict(body))["hits"]
                if hits != responses[kind][j]:
                    raise AssertionError(f"[lex] {kind} query {j}: K1's "
                                         f"plain version gave other hits")
        if kf.launches.count:
            raise AssertionError(f"[lex] K1 launched {kf.launches.count} "
                                 f"times under search.knn.kernel xla")
        out["xla_equal"] = True
        log("[lex] bool + knn and filtered knn under search.knn.kernel xla "
            "(K1's plain version): the kernel's hits bit for bit")
    finally:
        distributed_serving.enabled = True
        ann.default_config.configure(exact_kernel="auto")
    return out


def lexical_http_checks(node, bodies: dict, responses: dict) -> dict:
    """LEXICAL_HTTP searches of each type over the port's HTTP server: the
    in-process hits as JSON gives them, and _count over HTTP the hits'
    total."""
    from opensearch_tpu_torch.rest.http import HttpServer

    server = HttpServer(node, "127.0.0.1", 0)
    server.start_in_thread()
    client = RestClient(server.port)
    out = {}
    try:
        for kind, runs in bodies.items():
            lat = []
            for j, (body, _meta) in enumerate(runs[:LEXICAL_HTTP]):
                t0 = time.perf_counter()
                payload = client.ok("POST", "/lex/_search", body)
                lat.append(time.perf_counter() - t0)
                want = responses[kind][j]
                if kind == "sort_search_after":
                    want = want[0]
                if payload["hits"] != json_view({"h": want})["h"]:
                    raise AssertionError(f"[lex] {kind} query {j} over HTTP: "
                                         f"not the in-process hits")
            count = client.ok("POST", "/lex/_count",
                              {"query": runs[0][0]["query"]})
            want = responses[kind][0]
            want = (want[0] if kind == "sort_search_after" else want)
            if count["count"] != want["total"]["value"]:
                raise AssertionError(f"[lex] {kind}: _count over HTTP "
                                     f"{count} != {want['total']}")
            out[kind] = latency_summary(lat)
        log(f"[lex] over HTTP: {LEXICAL_HTTP} searches of each type the "
            f"in-process hits, _count the totals; "
            f"{json.dumps({k: round(v['p50_ms'], 3) for k, v in out.items()})}"
            f" p50 ms")
    finally:
        client.close()
        server.stop_thread()
    return out


def lexical_profile(node, shard, bodies: dict, bm25_ops) -> dict:
    """The profiler's device ms of one match search (BEIR-length query,
    six terms) and its top kernels beside the search's host wall, and of
    bm25_term_scores alone on the same term rows."""
    from opensearch_tpu_torch.search import executor

    body = bodies["match_or"][0][0]
    prof = device_profile(lambda: node.search("lex", dict(body)), 10)
    snap = shard.acquire_searcher()
    host, dev_seg = snap.segments[0]
    ctx = executor.ShardContext(snap, shard.mapper_service)
    terms = shard.mapper_service.analyze_query_text(
        "body", body["query"]["match"]["body"])
    htf, dtf = host.text_fields["body"], dev_seg.text_fields["body"]
    doc_count, avgdl = ctx.text_stats("body")
    tids = [htf.term_dict[t] for t in terms if t in htf.term_dict]
    offs = np.asarray([htf.term_offsets[t] for t in tids], np.int32)
    lens = np.asarray([htf.term_offsets[t + 1] - htf.term_offsets[t]
                       for t in tids], np.int32)
    idfs = np.asarray([bm25_ops.idf(ctx.text_df("body", t), doc_count)
                       for t in terms if t in htf.term_dict], np.float32)
    window = int(2 ** math.ceil(math.log2(max(int(lens.max()), 8))))
    bm = device_profile(lambda: bm25_ops.bm25_term_scores(
        dtf.postings_docs, dtf.postings_tfs, dtf.doc_len, offs, lens, idfs,
        np.float32(avgdl), n_pad=dev_seg.n_pad, window=window), 10)
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        node.search("lex", dict(body))
        lat.append(time.perf_counter() - t0)
    out = {"search_device_ms": prof and prof["device_ms"],
           "search_profiled_wall_ms": prof and prof["wall_ms"],
           "search_top_kernels": prof and prof["top"],
           "search_wall_ms": float(np.median(lat) * 1e3),
           "bm25_term_scores_device_ms": bm and bm["device_ms"],
           "bm25_term_scores_wall_ms": bm and bm["wall_ms"],
           "bm25_top_kernels": bm and bm["top"],
           "postings_window": window, "query_terms": len(tids),
           "postings_read": int(lens.sum())}
    log(f"[lex] match search profile: {json.dumps(out)}")
    return out


# -- aggregations (the aggs phase) -------------------------------------------

AGGS_QUERIES = 16          # searches of each scope
AGGS_TWICE = 8             # of them run again (the same bits)
AGGS_XLA = 8               # of each kNN scope's run under K1's plain version
AGGS_HTTP = 4              # of each scope's over HTTP
AGGS_ANN = 8               # kNN + aggs searches on index C
AGGS_K = 100               # k of the kNN scopes
AGGS_COMPOSITE_PAGE = 5000
AGGS_MONTHS_TOP = 6        # bucket_sort's size over the month histogram
AGGS_VIEWS_INTERVAL = 10_000
AGGS_POPULAR = 5_000       # the filter aggregation's views bound
DAY_MS = 86_400_000
AGGS_SCOPES = ("match_all", "match", "range", "knn", "knn_prefix", "bool")
AGGS_KNN_SCOPES = ("knn", "knn_prefix", "bool")
AGGS_TOP_HITS_SCOPES = ("match", "knn")


def aggs_body(scope: str, words: list, filter_words: tuple) -> dict:
    """The aggregations every search of a scope carries: terms on the tag
    ordered by a sub-aggregation (with a bucket_script), histogram, month
    date_histogram with derivative, cumulative_sum and bucket_sort (and an
    avg_bucket over it), a fixed 1d date_histogram with extended_bounds,
    range, date_range, stats, extended_stats, percentiles, cardinality,
    filters of two match bodies with other_bucket, a filter,
    significant_terms; top_hits under a terms on the match and knn
    scopes. The composite runs on its own (aggs_composite_pages)."""
    w1, w2 = filter_words
    body = {
        "tags": {"terms": {"field": "tag", "order": {"avg_views": "desc"}},
                 "aggs": {"avg_views": {"avg": {"field": "views"}},
                          "avg_k": {"bucket_script": {
                              "buckets_path": {"a": "avg_views"},
                              "script": "params.a / 1000"}}}},
        "views_hist": {"histogram": {"field": "views",
                                     "interval": AGGS_VIEWS_INTERVAL}},
        "months": {"date_histogram": {"field": "ts",
                                      "calendar_interval": "month"},
                   "aggs": {"views": {"sum": {"field": "views"}},
                            "deriv": {"derivative": {"buckets_path": "views"}},
                            "cum": {"cumulative_sum": {
                                "buckets_path": "views"}},
                            "top": {"bucket_sort": {
                                "sort": [{"views": {"order": "desc"}}],
                                "size": AGGS_MONTHS_TOP}}}},
        "avg_monthly": {"avg_bucket": {"buckets_path": "months>views"}},
        "days": {"date_histogram": {
            "field": "ts", "fixed_interval": "1d",
            "extended_bounds": {"min": "2023-01-01", "max": "2023-12-31"}}},
        "views_ranges": {"range": {"field": "views", "ranges": [
            {"key": "low", "to": 100}, {"key": "mid", "from": 100, "to": 10_000},
            {"key": "high", "from": 10_000}]}},
        "halves": {"date_range": {"field": "ts", "ranges": [
            {"key": "h1", "to": "2023-07-01"},
            {"key": "q3", "from": "2023-07-01", "to": "2023-10-01"},
            {"key": "q4", "from": "2023-10-01"}]}},
        "views_stats": {"stats": {"field": "views"}},
        "views_ext": {"extended_stats": {"field": "views"}},
        "views_pct": {"percentiles": {"field": "views",
                                      "percents": [1, 25, 50, 75, 99]}},
        "tag_card": {"cardinality": {"field": "tag"}},
        "words": {"filters": {"filters": {
            "a": {"match": {"body": words[w1]}},
            "b": {"match": {"body": words[w2]}}}, "other_bucket": True}},
        "popular": {"filter": {"range": {"views": {"gte": AGGS_POPULAR}}},
                    "aggs": {"max_views": {"max": {"field": "views"}}}},
        "sig_tags": {"significant_terms": {"field": "tag"}},
    }
    if scope in AGGS_TOP_HITS_SCOPES:
        body["top_tags"] = {"terms": {"field": "tag", "size": 5},
                            "aggs": {"top": {"top_hits": {"size": 3}}}}
    return body


def aggs_scopes(rng, corpus: dict, words: list, body_idx) -> dict:
    """AGGS_QUERIES queries of each scope, from the seed: match_all; a
    6-term match of terms in 50-400 docs each; a 14-day range on ts; knn
    (k = AGGS_K) from a doc's vector plus noise in eighths; the same knn
    filtered by a 2-3 letter tag prefix; bool{should: [a 3-term match,
    the knn]}. Each with what its truth needs."""
    n = len(corpus["views"])
    df = np.diff(body_idx.bounds)   # term occurrences, an upper bound on df
    mid = np.nonzero((df >= 50) & (df <= 400))[0]

    def terms(m: int) -> list[int]:
        out = []
        while len(out) < m:
            t = int(mid[int(rng.integers(len(mid)))])
            if t not in out:
                out.append(t)
        return out

    def qvec(i: int) -> list:
        return (corpus["v"][i] + np.round(rng.standard_normal(DIM) * 0.4 * 8)
                / 8).astype(np.float32).tolist()

    out = {s: [] for s in AGGS_SCOPES}
    for _ in range(AGGS_QUERIES):
        i = int(rng.integers(n))
        out["match_all"].append(({"match_all": {}}, {}))
        t6 = terms(6)
        out["match"].append(({"match": {"body": " ".join(
            words[t] for t in t6)}}, {"terms": t6}))
        lo = LEXICAL_TS0 + int(rng.integers(0, 350)) * DAY_MS
        out["range"].append(({"range": {"ts": {"gte": lo,
                                               "lt": lo + 14 * DAY_MS}}},
                             {"gte": lo, "lt": lo + 14 * DAY_MS}))
        q = qvec(i)
        knn = {"knn": {"v": {"vector": q, "k": AGGS_K}}}
        out["knn"].append((knn, {}))
        pre = f"g{int(corpus['tag'][i])}"[: 2 + int(rng.integers(2))]
        out["knn_prefix"].append(({"knn": {"v": {
            "vector": q, "k": AGGS_K,
            "filter": {"prefix": {"tag": pre}}}}}, {"prefix": pre}))
        t3 = terms(3)
        out["bool"].append(({"bool": {"should": [
            {"match": {"body": " ".join(words[t] for t in t3)}}, knn]}},
            {"terms": t3}))
    return out


def month_keys(ts: np.ndarray) -> np.ndarray:
    """Epoch ms of each value's calendar month (UTC)."""
    return ts.astype("datetime64[ms]").astype("datetime64[M]").astype(
        "datetime64[ms]").astype(np.int64)


def aggs_truth(ids: np.ndarray, scores: dict | None, sources: dict | None,
               scope: str, corpus: dict, body_idx, filter_words: tuple,
               bg_tags: np.ndarray) -> dict:
    """The aggregations of aggs_body over the docs `ids`, from the corpus
    arrays with numpy alone, in aggs_projection's form: every bucket key
    and count and every metric, by the formulas the reference states
    (sums and means over f64 values in doc order, ExtendedStats'
    (sum_sq - sum^2 / n) / n, numpy's percentile, JLH significance, the
    reference's tie orders)."""
    ids = np.sort(np.asarray(ids, np.int64))
    tag = corpus["tag"][ids]
    views = corpus["views"][ids]
    ts = corpus["ts"][ids]
    vf = views.astype(np.float64)
    n = len(ids)
    out = {}
    # terms on the tag ordered by avg views desc, then key asc
    keys, inv = np.unique(tag, return_inverse=True)
    rows = []
    for j, t in enumerate(keys):
        sel = vf[inv == j]
        avg = float(sel.sum(dtype=np.float64)) / len(sel)
        rows.append((f"g{int(t)}", len(sel), avg))
    rows.sort(key=lambda r: (-r[2], r[0]))
    out["tags"] = ([(k, c, a, a / 1000) for k, c, a in rows[:10]],
                   sum(c for _k, c, _a in rows[10:]))
    hk = np.floor((vf - 0.0) / AGGS_VIEWS_INTERVAL) * AGGS_VIEWS_INTERVAL \
        + 0.0
    u, c = np.unique(hk, return_counts=True)
    out["views_hist"] = list(zip(u.tolist(), c.tolist()))
    # months: every calendar month from the first to the last, filled
    mk = month_keys(ts)
    months = []
    if n:
        m_lo, m_hi = mk.min().astype("datetime64[ms]").astype(
            "datetime64[M]"), mk.max().astype("datetime64[ms]").astype(
            "datetime64[M]")
        for m in np.arange(m_lo, m_hi + 1):
            key = int(m.astype("datetime64[ms]").astype(np.int64))
            sel = vf[mk == key]
            months.append([key, len(sel), float(sel.sum(dtype=np.float64))
                           if len(sel) else 0.0])
    cum, prev = 0.0, None
    for row in months:
        deriv = None if prev is None else row[2] - prev
        prev = row[2]
        cum += row[2]
        row.extend([deriv, cum])
    months.sort(key=lambda r: -r[2])   # bucket_sort: stable, views desc
    months = months[:AGGS_MONTHS_TOP]
    out["months"] = [tuple(r) for r in months]
    vals = [r[2] for r in months if r[1] > 0]
    out["avg_monthly"] = sum(vals) / len(vals) if vals else None
    dk = np.floor((ts.astype(np.float64) - 0.0) / DAY_MS) * DAY_MS + 0.0
    first, last = LEXICAL_TS0, LEXICAL_TS0 + 364 * DAY_MS
    u, c = np.unique(dk, return_counts=True)
    counts = dict(zip(u.tolist(), c.tolist()))
    lo_d = min([first, *counts]) if counts else first
    hi_d = max([last, *counts]) if counts else last
    out["days"] = [(int(k), counts.get(float(k), 0)) for k in range(
        int(lo_d), int(hi_d) + 1, DAY_MS)]
    out["views_ranges"] = [("low", int((views < 100).sum())),
                           ("mid", int(((views >= 100)
                                        & (views < 10_000)).sum())),
                           ("high", int((views >= 10_000).sum()))]
    h = LEXICAL_TS0 + 181 * DAY_MS
    q4 = LEXICAL_TS0 + 273 * DAY_MS
    out["halves"] = [("h1", int((ts < h).sum())),
                     ("q3", int(((ts >= h) & (ts < q4)).sum())),
                     ("q4", int((ts >= q4).sum()))]
    if n:
        s = float(vf.sum())
        sos = float((vf * vf).sum())
        var_pop = max((sos - s * s / n) / n, 0.0)
        var_samp = (max((sos - s * s / n) / (n - 1), 0.0) if n > 1
                    else None)
        std = math.sqrt(var_pop)
        out["views_stats"] = (n, float(vf.min()), float(vf.max()),
                              float(vf.sum(dtype=np.float64)) / n,
                              float(vf.sum(dtype=np.float64)))
        out["views_ext"] = (n, s, sos, var_pop, var_samp, std,
                            s / n + 2.0 * std, s / n - 2.0 * std)
        pct = np.percentile(vf, [1.0, 25.0, 50.0, 75.0, 99.0])
        out["views_pct"] = {str(p): float(v) for p, v in zip(
            [1.0, 25.0, 50.0, 75.0, 99.0], pct)}
    out["tag_card"] = len(keys)
    ws = {name: np.isin(ids, body_idx.postings(w)[0])
          for name, w in zip(("a", "b"), filter_words)}
    out["words"] = {"a": int(ws["a"].sum()), "b": int(ws["b"].sum()),
                    "_other_": int((~(ws["a"] | ws["b"])).sum())}
    pop = vf[views >= AGGS_POPULAR]
    out["popular"] = (len(pop), float(pop.max()) if len(pop) else None)
    # significant_terms: JLH over the live docs, min_doc_count 3, size 10
    bg_total = len(corpus["views"])
    sig = []
    for j, t in enumerate(keys):
        fg = int((inv == j).sum())
        if fg < 3 or n == 0:
            continue
        bg = int(bg_tags[t])
        fg_pct, bg_pct = fg / n, bg / bg_total
        if fg_pct <= bg_pct or bg_pct == 0:
            continue
        sig.append(((fg_pct - bg_pct) * (fg_pct / bg_pct), f"g{int(t)}",
                    fg, bg))
    sig.sort(key=lambda r: (-r[0], r[1]))
    out["sig_tags"] = (n, bg_total, [(k, fg, sc, bg)
                                     for sc, k, fg, bg in sig[:10]])
    if scope in AGGS_TOP_HITS_SCOPES:
        by_count = sorted(((f"g{int(t)}", int((inv == j).sum()), j)
                           for j, t in enumerate(keys)),
                          key=lambda r: (-r[1], r[0]))[:5]
        top = []
        for k, cnt, j in by_count:
            docs = ids[inv == j].tolist()
            docs.sort(key=lambda d: (-scores[d], d))
            page = docs[:3]
            top.append((k, cnt, [(str(d), scores[d], sources[d])
                                 for d in page],
                        max(scores[d] for d in page)))
        out["top_tags"] = top
    return out


def aggs_projection(aggs: dict, scope: str) -> dict:
    """A response's aggregations in aggs_truth's form."""
    out = {}
    t = aggs["tags"]
    out["tags"] = ([(b["key"], b["doc_count"], b["avg_views"]["value"],
                     b["avg_k"]["value"]) for b in t["buckets"]],
                   t["sum_other_doc_count"])
    out["views_hist"] = [(b["key"], b["doc_count"])
                         for b in aggs["views_hist"]["buckets"]]
    out["months"] = [(b["key"], b["doc_count"], b["views"]["value"],
                      b["deriv"]["value"] if "deriv" in b else None,
                      b["cum"]["value"])
                     for b in aggs["months"]["buckets"]]
    out["avg_monthly"] = aggs["avg_monthly"]["value"]
    out["days"] = [(b["key"], b["doc_count"])
                   for b in aggs["days"]["buckets"]]
    out["views_ranges"] = [(b["key"], b["doc_count"])
                           for b in aggs["views_ranges"]["buckets"]]
    out["halves"] = [(b["key"], b["doc_count"])
                     for b in aggs["halves"]["buckets"]]
    if aggs["views_stats"]["count"]:
        st, ex = aggs["views_stats"], aggs["views_ext"]
        out["views_stats"] = (st["count"], st["min"], st["max"], st["avg"],
                              st["sum"])
        bounds = ex["std_deviation_bounds"]
        out["views_ext"] = (ex["count"], ex["sum"], ex["sum_of_squares"],
                            ex["variance_population"],
                            ex["variance_sampling"], ex["std_deviation"],
                            bounds["upper"], bounds["lower"])
        out["views_pct"] = aggs["views_pct"]["values"]
    out["tag_card"] = aggs["tag_card"]["value"]
    out["words"] = {k: v["doc_count"]
                    for k, v in aggs["words"]["buckets"].items()}
    out["popular"] = (aggs["popular"]["doc_count"],
                      aggs["popular"]["max_views"]["value"])
    sg = aggs["sig_tags"]
    out["sig_tags"] = (sg["doc_count"], sg["bg_count"],
                       [(b["key"], b["doc_count"], b["score"], b["bg_count"])
                        for b in sg["buckets"]])
    if scope in AGGS_TOP_HITS_SCOPES:
        out["top_tags"] = [
            (b["key"], b["doc_count"],
             [(h["_id"], h["_score"], h["_source"])
              for h in b["top"]["hits"]["hits"]],
             b["top"]["hits"]["max_score"])
            for b in aggs["top_tags"]["buckets"]]
    return out


def aggs_diff(got: dict, want: dict) -> str | None:
    """The first aggregation whose projection differs, or None."""
    for name in want:
        if got.get(name) != want[name]:
            return (f"{name}: got {str(got.get(name))[:300]} want "
                    f"{str(want[name])[:300]}")
    extra = set(got) - set(want)
    return f"unexpected {sorted(extra)}" if extra else None


def aggs_composite_pages(node, query: dict) -> tuple[list, int]:
    """The composite (tag x month) over the query's docs, paged to its end
    by after_key: every bucket as (tag, month ms, count), and the pages."""
    comp = {"composite": {"size": AGGS_COMPOSITE_PAGE, "sources": [
        {"tag": {"terms": {"field": "tag"}}},
        {"month": {"date_histogram": {"field": "ts",
                                      "calendar_interval": "month"}}}]}}
    rows, after, pages = [], None, 0
    while True:
        conf = dict(comp["composite"])
        if after is not None:
            conf["after"] = after
        res = node.search("lex", {"size": 0, "query": query, "aggs": {
            "comp": {"composite": conf}}},
            request_cache=False)["aggregations"]["comp"]
        pages += 1
        rows.extend((b["key"]["tag"], b["key"]["month"], b["doc_count"])
                    for b in res["buckets"])
        if res["buckets"] and res["after_key"] != res["buckets"][-1]["key"]:
            raise AssertionError(f"[aggs] composite after_key "
                                 f"{res['after_key']} is not the page's "
                                 f"last key")
        # a short page is the last one
        if len(res["buckets"]) < AGGS_COMPOSITE_PAGE:
            return rows, pages
        after = res["after_key"]


def composite_truth(ids: np.ndarray, corpus: dict) -> list:
    ids = np.sort(np.asarray(ids, np.int64))
    pairs = {}
    for t, m in zip(corpus["tag"][ids].tolist(),
                    month_keys(corpus["ts"][ids]).tolist()):
        pairs[(f"g{t}", m)] = pairs.get((f"g{t}", m), 0) + 1
    return [(t, m, c) for (t, m), c in sorted(pairs.items())]


def aggs_launch_gate(kf, scope: str, got: dict, searches: int,
                     n_segments: int) -> None:
    """Gate 4: K1 launched once a segment a kNN search on the tier
    scan_tier names (k bucketed to 128), and the stacked step not at all:
    a search with aggregations takes the per-shard route."""
    tier = kf.scan_tier("fp32", kf.fused_pool_width(128, "fp32"))
    want = searches * n_segments if scope in AGGS_KNN_SCOPES else 0
    if got["knn_fused"] != want or got[tier] != want or got["stacked"]:
        raise AssertionError(f"[aggs] {scope}: want {want} K1 launches on "
                             f"the {tier} tier and no stacked search: {got}")


def aggs_main_phase(node, kf, dev, seed: int, corpus: dict, words: list,
                    body_idx, n_segments: int) -> dict:
    """Aggregations on index L (the lexical phase's node, before its
    ledger gate deletes the index): AGGS_QUERIES searches at size 0 of each
    scope of aggs_scopes, each with aggs_body. Gates:

    1. match_all and range: every bucket key, count and metric the numpy
       truth (aggs_truth) over the corpus arrays;
    2. match, knn, knn_prefix and bool: the numpy truth over the doc ids of
       the same search run without aggregations at size = its total (the
       k hits for knn) on the same route, top_hits' scores those hits'
       own, bit for bit; match's ids the numpy match set;
    3. AGGS_TWICE searches of each scope again: the same aggregations
       (match_all's 16 are one body, each the first's);
    4. aggs_launch_gate over each scope's searches;
    5. the kNN scopes' first AGGS_XLA searches under search.knn.kernel xla
       (K1's plain version): the same aggregations, no K1 launch;
    6. AGGS_HTTP searches of each scope over the port's HTTP server with
       ?typed_keys=true: the in-process aggregations, typed;
    and the composite (tag x month) of each scope's first search paged to
    its end, every bucket numpy's. Recorded: p50 / p99 of each scope,
    each scope's profile (aggregation time against the query phase's, the
    top_hits and cardinality times), the copy to the host of a segment's
    mask and scores (bytes and CUDA-event ms), the composite's pages."""
    from opensearch_tpu_torch.rest import handlers as port_handlers
    from opensearch_tpu_torch.rest.http import HttpServer
    from opensearch_tpu_torch.search import ann, distributed_serving

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 17)
    (shard,) = node.indices["lex"].shards.values()
    host = shard.acquire_searcher().segments[0][0]
    n = len(corpus["views"])
    for d in (0, n // 2, n - 1):
        if host.doc_ids[d] != str(d):
            raise AssertionError(f"[aggs] segment doc {d} is id "
                                 f"{host.doc_ids[d]}: the truth reads docs "
                                 f"in id order")
    df = np.diff(body_idx.bounds)
    common = np.nonzero((df >= 2000) & (df <= 20_000))[0]
    filter_words = (int(common[0]), int(common[len(common) // 2]))
    bg_tags = np.bincount(corpus["tag"], minlength=LEXICAL_TAGS)
    scopes = aggs_scopes(rng, corpus, words, body_idx)
    tier_counter = {"lists": kf.list_launches, "wide": kf.wide_launches,
                    "mma": kf.mma_launches}
    out = {"scopes": {}, "filter_words": [words[w] for w in filter_words]}
    all_ids = np.arange(n)

    def hits_of(query: dict, size: int) -> list:
        """The query's hits without aggregations, on the per-shard route a
        search with aggregations takes (the stacked step, which a bare knn
        would take, may keep another doc at a tie on the k-th score, as the
        reference's does)."""
        try:
            distributed_serving.enabled = False
            return node.search("lex", {"query": query,
                                       "size": size})["hits"]["hits"]
        finally:
            distributed_serving.enabled = True

    first_aggs = {}
    for scope, runs in scopes.items():
        label = f"[aggs] {scope}"
        aggs = aggs_body(scope, words, filter_words)
        for c in (kf.launches, *tier_counter.values()):
            c.reset()
        stacked0 = distributed_serving.stats["distributed_searches"]
        lat, resps = [], []
        for query, _meta in runs:
            t0 = time.perf_counter()
            # uncached: the phase measures the aggregation path
            resps.append(node.search("lex", {"size": 0, "query": query,
                                             "aggs": aggs},
                                     request_cache=False))
            lat.append(time.perf_counter() - t0)
        launches = {"knn_fused": kf.launches.count,
                    **{t: c.count for t, c in tier_counter.items()},
                    "stacked": distributed_serving.stats[
                        "distributed_searches"] - stacked0}
        aggs_launch_gate(kf, scope, launches, len(runs), n_segments)
        res = latency_summary(lat)
        res["launches"] = launches
        # gates 1 and 2: the numpy truth
        totals, ids0 = [], None
        for j, ((query, meta), resp) in enumerate(zip(runs, resps)):
            total = resp["hits"]["total"]["value"]
            totals.append(total)
            scores = sources = None
            if scope == "match_all":
                ids = all_ids
            elif scope == "range":
                ids = np.nonzero((corpus["ts"] >= meta["gte"])
                                 & (corpus["ts"] < meta["lt"]))[0]
            else:
                hits = hits_of(query, total)
                ids = np.asarray([int(h["_id"]) for h in hits], np.int64)
                scores = {int(h["_id"]): h["_score"] for h in hits}
                sources = {int(h["_id"]): h["_source"] for h in hits}
                if len(ids) != total:
                    raise AssertionError(f"{label} query {j}: {len(ids)} "
                                         f"hits of {total}")
                if scope == "match":
                    want_ids = np.nonzero(body_idx.match(meta["terms"])[1])[0]
                    if not np.array_equal(np.sort(ids), want_ids):
                        raise AssertionError(f"{label} query {j}: not the "
                                             f"numpy match set")
            if total != len(ids):
                raise AssertionError(f"{label} query {j}: total {total}, "
                                     f"numpy {len(ids)}")
            if j == 0:
                ids0 = ids
            want = aggs_truth(ids, scores, sources, scope, corpus, body_idx,
                              filter_words, bg_tags)
            bad = aggs_diff(aggs_projection(resp["aggregations"], scope),
                            want)
            if bad:
                raise AssertionError(f"{label} query {j}: {bad}")
        res["total_p50"] = float(np.median(totals))
        # gate 3: the same bits run after run
        if scope == "match_all":
            if any(r["aggregations"] != resps[0]["aggregations"]
                   for r in resps[1:]):
                raise AssertionError(f"{label}: one body, other "
                                     f"aggregations")
        else:
            for j, (query, _meta) in enumerate(runs[:AGGS_TWICE]):
                again = node.search("lex", {"size": 0, "query": query,
                                            "aggs": aggs},
                                    request_cache=False)
                if again["aggregations"] != resps[j]["aggregations"]:
                    raise AssertionError(f"{label} query {j}: a second run "
                                         f"gave other aggregations")
        # the composite of the first search, paged to its end
        t0 = time.perf_counter()
        q0 = runs[0][0]
        rows, pages = aggs_composite_pages(node, q0)
        comp_s = time.perf_counter() - t0
        if rows != composite_truth(ids0, corpus):
            raise AssertionError(f"{label}: the composite's pages are not "
                                 f"numpy's (tag, month) counts")
        res["composite"] = {"buckets": len(rows), "pages": pages,
                            "wall_s": comp_s}
        # the profile: aggregation time against the query phase's
        prof = node.search("lex", {"size": 0, "query": q0, "aggs": aggs,
                                   "profile": True})["profile"]["shards"][0]
        agg_ns = {e["description"]: e["time_in_nanos"]
                  for e in prof["aggregations"]}
        query_ns = sum(q["time_in_nanos"]
                       for q in prof["searches"][0]["query"]) \
            + prof["searches"][0]["collector"][0]["time_in_nanos"]
        res["profile"] = {"aggregations_ms": sum(agg_ns.values()) / 1e6,
                          "query_phase_ms": query_ns / 1e6,
                          "cardinality_ms": agg_ns["tag_card"] / 1e6,
                          "top_hits_ms": (agg_ns["top_tags"] / 1e6
                                          if "top_tags" in agg_ns else None),
                          "slowest": sorted(agg_ns.items(),
                                            key=lambda kv: -kv[1])[:4]}
        first_aggs[scope] = [r["aggregations"] for r in resps]
        out["scopes"][scope] = res
        log(f"{label}: {json.dumps(res)}")
    # gate 5: the kNN scopes under K1's plain version
    try:
        ann.default_config.configure(exact_kernel="xla")
        kf.launches.reset()
        for scope in AGGS_KNN_SCOPES:
            aggs = aggs_body(scope, words, filter_words)
            for j, (query, _meta) in enumerate(scopes[scope][:AGGS_XLA]):
                got = node.search("lex", {"size": 0, "query": query,
                                          "aggs": aggs},
                                  request_cache=False)["aggregations"]
                if got != first_aggs[scope][j]:
                    raise AssertionError(f"[aggs] {scope} query {j}: K1's "
                                         f"plain version gave other "
                                         f"aggregations")
        if kf.launches.count:
            raise AssertionError(f"[aggs] K1 launched {kf.launches.count} "
                                 f"times under search.knn.kernel xla")
    finally:
        ann.default_config.configure(exact_kernel="auto")
    log(f"[aggs] the kNN scopes under search.knn.kernel xla (K1's plain "
        f"version): the kernel's aggregations bit for bit, "
        f"{AGGS_XLA} a scope")
    # gate 6: over the port's HTTP server, typed_keys
    server = HttpServer(node, "127.0.0.1", 0)
    server.start_in_thread()
    client = RestClient(server.port)
    http = {}
    try:
        for scope, runs in scopes.items():
            aggs = aggs_body(scope, words, filter_words)
            lat = []
            for j, (query, _meta) in enumerate(runs[:AGGS_HTTP]):
                body = {"size": 0, "query": query, "aggs": aggs}
                t0 = time.perf_counter()
                payload = client.ok(
                    "POST", "/lex/_search?typed_keys=true&request_cache=false",
                    body)
                lat.append(time.perf_counter() - t0)
                want = port_handlers._apply_typed_keys(
                    json_view({"aggregations": first_aggs[scope][j]}),
                    {"typed_keys": "true"}, body, node, "lex")
                if payload["aggregations"] != want["aggregations"]:
                    raise AssertionError(f"[aggs] {scope} query {j} over "
                                         f"HTTP: not the in-process "
                                         f"aggregations")
                if "sterms#tags" not in payload["aggregations"]:
                    raise AssertionError(f"[aggs] {scope} over HTTP: no "
                                         f"typed keys")
            http[scope] = latency_summary(lat)
    finally:
        client.close()
        server.stop_thread()
    out["http"] = http
    log(f"[aggs] over HTTP with typed_keys: {AGGS_HTTP} searches of each "
        f"scope the in-process aggregations; "
        f"{json.dumps({k: round(v['p50_ms'], 3) for k, v in http.items()})}"
        f" p50 ms")
    # the query phase's copy of a segment's mask and scores to the host
    dseg = shard.acquire_searcher().segments[0][1]
    mask_d = dseg.live.clone()
    scores_d = torch.rand(dseg.n_pad, device=dev)
    copy_ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mask_d.cpu().numpy()
        scores_d.cpu().numpy()
        copy_ms.append((time.perf_counter() - t0) * 1e3)
    out["copy"] = {"n_pad": dseg.n_pad, "n_docs": host.n_docs,
                   "bytes": dseg.n_pad * (mask_d.element_size()
                                          + scores_d.element_size()),
                   "p50_ms": float(np.median(copy_ms)),
                   "min_ms": float(min(copy_ms)),
                   "scopes": [s for s in AGGS_SCOPES if s not in
                              ("knn", "knn_prefix")]}
    log(f"[aggs] a search's mask-and-score copy: {json.dumps(out['copy'])}")
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def ann_aggs_check(node, name: str, kf, ads, queries: np.ndarray,
                   attrs: dict, n: int) -> dict:
    """AGGS_ANN kNN searches (k = 10) with terms on color and a histogram
    on age over index C's IVF-PQ segment and its exact one: each one K2
    launch and one K1 launch, no stacked search, and the aggregations
    numpy's over the same search's hits without aggregations."""
    from opensearch_tpu_torch.search import distributed_serving

    aggs = {"colors": {"terms": {"field": "color"}},
            "ages": {"histogram": {"field": "age", "interval": 10}}}
    ads.launches.reset()
    kf.launches.reset()
    stacked0 = distributed_serving.stats["distributed_searches"]
    lat, resps = [], []
    for qv in queries[:AGGS_ANN]:
        t0 = time.perf_counter()
        resps.append(node.search(name, {"size": 0, "aggs": aggs, "query": {
            "knn": {"v": {"vector": qv.tolist(), "k": 10}}}},
            request_cache=False))
        lat.append(time.perf_counter() - t0)
    launches = {"adc_scan": ads.launches.count,
                "knn_fused": kf.launches.count,
                "stacked": distributed_serving.stats["distributed_searches"]
                - stacked0}
    if launches != {"adc_scan": AGGS_ANN, "knn_fused": AGGS_ANN,
                    "stacked": 0}:
        raise AssertionError(f"[{name}] kNN + aggs: want one K2 and one K1 "
                             f"launch a search, no stacked one: {launches}")
    for j, (qv, resp) in enumerate(zip(queries, resps)):
        hits = node.search(name, {"size": 10, "query": {"knn": {"v": {
            "vector": qv.tolist(), "k": 10}}}})["hits"]["hits"]
        ids = np.asarray([int(h["_id"]) for h in hits])
        ids = ids[ids < n]      # the second refresh's docs carry no attributes
        colors = {}
        for c in attrs["color"][ids].tolist():
            colors[COLORS[c]] = colors.get(COLORS[c], 0) + 1
        want_colors = sorted(colors.items(), key=lambda kv: (-kv[1], kv[0]))
        ages, counts = np.unique(np.floor(attrs["age"][ids].astype(
            np.float64) / 10) * 10, return_counts=True)
        got = resp["aggregations"]
        if [(b["key"], b["doc_count"]) for b in got["colors"]["buckets"]] \
                != want_colors or [(b["key"], b["doc_count"]) for b in
                                   got["ages"]["buckets"]] != list(
                zip(ages.tolist(), counts.tolist())):
            raise AssertionError(f"[{name}] kNN + aggs query {j}: not numpy's "
                                 f"aggregations over its hits: "
                                 f"{json.dumps(got)[:400]}")
    out = {**latency_summary(lat), "launches": launches}
    log(f"[{name}] kNN + aggs over the IVF-PQ and exact segments: "
        f"{json.dumps(out)}")
    return out


def aggs_phase(kf, dev, seed: int, n_docs: int = LEXICAL_DOCS) -> dict:
    """``--phases aggs``: index L built as lexical_main_phase builds it (the
    same corpus from the seed), then aggs_main_phase alone."""
    from opensearch_tpu_torch.node import TorchNode

    rng = np.random.default_rng(seed + 15)
    words = [lexical_word(i) for i in range(LEXICAL_VOCAB)]
    corpus = lexical_corpus(rng, n_docs)
    corpus.update(dsl_fields(seed, n_docs))
    body_idx = TokenIndex(corpus["body"], corpus["body_off"])
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device=dev)
        ingest_s = lexical_ingest(node, "lex", corpus, words)
        (shard,) = node.indices["lex"].shards.values()
        n_segments = len(shard.acquire_searcher().segments)
        log(f"[aggs] index L: {n_docs} docs, {n_segments} segment(s), bulk "
            f"+ refresh {ingest_s:.1f} s")
        out = aggs_main_phase(node, kf, dev, seed, corpus, words, body_idx,
                              n_segments)
        node.close()
    out["ingest_s"] = ingest_s
    return out


# -- the rest of the query DSL (the dsl phase) --------------------------------

DSL_QUERIES = 16           # searches of each type
DSL_SCRIPT = 4             # script-filter searches (a painless run a doc)
DSL_SCRIPT_KNN = 1         # script-filtered kNN searches at each k
DSL_HTTP = 4               # of each type over HTTP (1 of the script filter)
DSL_PERCOLATE = 8          # percolate searches on index P
DSL_UPDATES = 100          # scripted updates on index J
DSL_CITIES = 1_000
DSL_J_QUESTIONS = 4_000
DSL_J_ANSWERS = 16_000
DSL_P_QUERIES = 2_000
DSL_KS = (10, 100)
EARTH_R_M = 6371008.8      # GeoUtils.EARTH_MEAN_RADIUS


def dsl_fields(seed: int, n: int) -> dict:
    """Index L's three dsl fields from a generator of their own (the
    other columns keep their bits): ``loc``, a geo_point about one of
    DSL_CITIES city centres with a jitter of a few km, as hotel or listing
    search holds; ``pop``, a rank_feature of Zipf page popularity; ``need``,
    terms_set's per-doc count, a long from 1 to 3."""
    rng = np.random.default_rng([seed, 18])
    c_lat = rng.uniform(-55.0, 65.0, DSL_CITIES)
    c_lon = rng.uniform(-170.0, 170.0, DSL_CITIES)
    city = rng.integers(0, DSL_CITIES, n)
    return {"city_lat": c_lat, "city_lon": c_lon,
            "lat": np.round(c_lat[city] + rng.normal(0.0, 0.02, n), 6),
            "lon": np.round(c_lon[city] + rng.normal(0.0, 0.03, n), 6),
            "pop": np.minimum(rng.zipf(1.6, n), 1_000_000).astype(np.float64),
            "need": rng.integers(1, 4, n)}


def haversine_np(lat1: float, lon1: float, lat2, lon2):
    """Great-circle metres in float64 (GeoUtils.arcDistance's haversine)."""
    p1, p2 = np.radians(lat1), np.radians(lat2)
    dp = p2 - p1
    dl = np.radians(lon2) - np.radians(lon1)
    a = np.sin(dp / 2.0) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2.0) ** 2
    return 2.0 * EARTH_R_M * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def murmur3_ids(n: int) -> np.ndarray:
    """uint32 murmur3_x86_32 (seed 0) of the ASCII ids "0" .. str(n - 1),
    vectorized in numpy: slice's partition of _id."""
    mask = np.uint64(0xFFFFFFFF)
    out = np.zeros(n, np.uint64)

    def rotl(x, r):
        return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & mask

    def mix(k):
        k = (k * np.uint64(0xCC9E2D51)) & mask
        k = rotl(k, 15)
        return (k * np.uint64(0x1B873593)) & mask

    ids = np.arange(n)
    for length in range(1, len(str(n - 1)) + 1):
        sel = ids[(ids >= (10 ** (length - 1) if length > 1 else 0))
                  & (ids < 10 ** length)]
        if not len(sel):
            continue
        raw = np.frombuffer("".join(str(i) for i in sel).encode(),
                            np.uint8).reshape(len(sel), length)
        b = raw.astype(np.uint64)
        h = np.zeros(len(sel), np.uint64)
        nblocks = length // 4
        for j in range(nblocks):
            k = (b[:, 4 * j] | (b[:, 4 * j + 1] << np.uint64(8))
                 | (b[:, 4 * j + 2] << np.uint64(16))
                 | (b[:, 4 * j + 3] << np.uint64(24)))
            h ^= mix(k)
            h = rotl(h, 13)
            h = (h * np.uint64(5) + np.uint64(0xE6546B64)) & mask
        tail = length - 4 * nblocks
        if tail:
            k = np.zeros(len(sel), np.uint64)
            for t in range(tail):
                k ^= b[:, 4 * nblocks + t] << np.uint64(8 * t)
            h ^= mix(k)
        h ^= np.uint64(length)
        h ^= h >> np.uint64(16)
        h = (h * np.uint64(0x85EBCA6B)) & mask
        h ^= h >> np.uint64(13)
        h = (h * np.uint64(0xC2B2AE35)) & mask
        h ^= h >> np.uint64(16)
        out[sel] = h
    return out.astype(np.uint32)


def first_ids(mask: np.ndarray, k: int = 10) -> list:
    """The first k docs of a constant-score result: doc order."""
    return np.nonzero(mask)[0][:k].tolist()


def ranked_ids(scores32: np.ndarray, mask: np.ndarray, k: int = 10) -> list:
    """The k best docs by (-float32 score, doc) over `mask`."""
    cand = np.nonzero(mask)[0]
    return cand[np.lexsort((cand, -scores32[cand].astype(np.float64)))][
        :k].tolist()


def dsl_typo(word: str) -> str:
    """A misspelling of a three-letter word from "g" that no corpus word
    has: the last letter doubled (the vocabulary's four-letter words run
    from "baaa" to "fpxx")."""
    return word + word[-1]


def dsl_bodies(rng, corpus: dict, words: list, body_idx) -> dict:
    """DSL_QUERIES request bodies (fewer where noted) of each index-L type,
    each with what its truth needs."""
    n = len(corpus["views"])
    lat, lon = corpus["lat"], corpus["lon"]
    df = np.diff(body_idx.bounds)
    # document frequencies relative to the corpus: 1,000-20,000, 2,000
    # and 100 of index L's 200,000 docs
    mid = np.nonzero((df >= n // 200) & (df <= n // 10))[0]
    common = np.nonzero(df >= n // 100)[0]
    # three-letter words from "g": a typo of one (dsl_typo) is a
    # four-letter string past the vocabulary's last word
    typo_ok = np.nonzero((df >= n // 2000) & np.asarray(
        [len(w) == 3 and w[0] >= "g" for w in words]))[0]
    bo, body = corpus["body_off"], corpus["body"]
    out: dict = {k: [] for k in (
        "geo_distance", "geo_bounding_box", "geo_shape",
        "distance_feature_ts", "distance_feature_loc",
        "rank_feature_saturation", "rank_feature_log",
        "rank_feature_sigmoid", "terms_set", "mlt_text", "mlt_doc",
        "slice", "script", "script_score_knn", "script_score_cosine",
        "script_score_painless", "script_score_over_knn", "script_fields",
        "suggest_term", "suggest_phrase", "template", "hybrid_norm",
        "hybrid_rrf")}

    def city():
        c = int(rng.integers(0, DSL_CITIES))
        return float(corpus["city_lat"][c]), float(corpus["city_lon"][c])

    def qvec():
        return corpus["v"][int(rng.integers(0, n))].tolist()

    for j in range(DSL_QUERIES):
        c_lat, c_lon = city()
        out["geo_distance"].append((
            {"query": {"geo_distance": {"distance": "5km", "loc": {
                "lat": c_lat, "lon": c_lon}}}},
            {"mask": haversine_np(c_lat, c_lon, lat, lon) <= 5000.0}))
        c_lat, c_lon = city()
        top, bottom = c_lat + 0.04, c_lat - 0.04
        left, right = c_lon - 0.06, c_lon + 0.06
        out["geo_bounding_box"].append((
            {"query": {"geo_bounding_box": {"loc": {
                "top_left": {"lat": top, "lon": left},
                "bottom_right": {"lat": bottom, "lon": right}}}}},
            {"mask": (lat <= top) & (lat >= bottom) & (lon >= left)
             & (lon <= right)}))
        c_lat, c_lon = city()
        top, bottom = c_lat + 0.03, c_lat - 0.05
        left, right = c_lon - 0.04, c_lon + 0.05
        out["geo_shape"].append((
            {"query": {"geo_shape": {"loc": {"shape": {
                "type": "envelope",
                "coordinates": [[left, top], [right, bottom]]}}}}},
            {"mask": (lat >= bottom) & (lat <= top) & (lon >= left)
             & (lon <= right)}))
        day = int(rng.integers(0, 365))
        origin_ms = LEXICAL_TS0 + day * DAY_MS
        origin = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                               time.gmtime(origin_ms / 1000))
        pivot = 7 * DAY_MS
        dist = np.abs(corpus["ts"].astype(np.float64) - float(origin_ms))
        out["distance_feature_ts"].append((
            {"query": {"distance_feature": {"field": "ts", "origin": origin,
                                            "pivot": "7d"}}},
            {"scores": (float(pivot) / (float(pivot) + dist)).astype(
                np.float32), "mask": np.ones(n, bool)}))
        c_lat, c_lon = city()
        dist = haversine_np(c_lat, c_lon, lat, lon)
        out["distance_feature_loc"].append((
            {"query": {"distance_feature": {
                "field": "loc", "origin": {"lat": c_lat, "lon": c_lon},
                "pivot": "50km"}}},
            {"scores": (50000.0 / (50000.0 + dist)).astype(np.float32),
             "mask": np.ones(n, bool)}))
        pop = corpus["pop"]
        pivot_sat = max(float(pop.sum()) / n, 1e-9)
        boost = float(1 + j % 3)
        out["rank_feature_saturation"].append((
            {"query": {"rank_feature": {"field": "pop", "boost": boost}}},
            {"scores": ((pop / (pop + pivot_sat)) * boost).astype(
                np.float32), "mask": np.ones(n, bool)}))
        sf = float(1 + j)
        out["rank_feature_log"].append((
            {"query": {"rank_feature": {"field": "pop", "log": {
                "scaling_factor": sf}}}},
            {"scores": np.log(np.maximum(sf + pop, 1e-12)).astype(
                np.float32), "mask": np.ones(n, bool)}))
        piv, ex = float(2 + j), 0.6
        ve = np.power(pop, ex)
        out["rank_feature_sigmoid"].append((
            {"query": {"rank_feature": {"field": "pop", "sigmoid": {
                "pivot": piv, "exponent": ex}}}},
            {"scores": (ve / (ve + piv ** ex)).astype(np.float32),
             "mask": np.ones(n, bool)}))
        terms = [int(t) for t in rng.choice(mid, 4, replace=False)]
        counts = np.zeros(n, np.int64)
        for t in terms:
            counts[body_idx.postings(t)[0]] += 1
        out["terms_set"].append((
            {"query": {"terms_set": {"body": {
                "terms": [words[t] for t in terms],
                "minimum_should_match_field": "need"}}}},
            {"mask": (counts >= corpus["need"]) & (counts > 0)}))
        d = int(rng.integers(0, n))
        like = [int(t) for t in rng.choice(mid, 12)] + \
            body[bo[d]:bo[d + 1]][:6].tolist()
        out["mlt_text"].append((
            {"query": {"more_like_this": {
                "fields": ["body"], "like": " ".join(words[t] for t in like),
                "min_term_freq": 1, "min_doc_freq": 5,
                "max_query_terms": 12}}},
            {"like": like}))
        d = int(rng.integers(0, n))
        out["mlt_doc"].append((
            {"query": {"more_like_this": {
                "fields": ["body"], "like": [{"_id": str(d)}],
                "min_term_freq": 1, "min_doc_freq": 5,
                "max_query_terms": 12}}},
            {"like": body[bo[d]:bo[d + 1]].tolist()}))
        out["slice"].append((
            {"query": {"match_all": {}}, "size": 0,
             "slice": {"id": j % 4, "max": 4}}, {"slice": j % 4}))
        w = int(rng.choice(mid))
        qv = qvec()
        out["script_score_knn"].append((
            {"query": {"script_score": {
                "query": {"match": {"body": words[w]}},
                "script": {"source": "knn_score", "lang": "knn", "params": {
                    "field": "v", "query_value": qv,
                    "space_type": "l2"}}}}},
            {"terms": [w], "qv": qv}))
        w = int(rng.choice(mid))
        qv = qvec()
        out["script_score_cosine"].append((
            {"query": {"script_score": {
                "query": {"match": {"body": words[w]}},
                "script": {"source": "cosineSimilarity(params.query_vector, "
                                     "doc['v']) + 1.0",
                           "params": {"query_vector": qv}}}}},
            {"terms": [w], "qv": qv}))
        w = int(rng.choice(mid))
        out["script_score_painless"].append((
            {"query": {"script_score": {
                "query": {"match": {"body": words[w]}},
                "script": {"source": "doc['views'].value * 0.001 + "
                                     "doc['need'].value"}}}},
            {"terms": [w]}))
        qv = qvec()
        out["script_score_over_knn"].append((
            {"query": {"script_score": {
                "query": {"knn": {"v": {"vector": qv, "k": 100}}},
                "script": {"source": "knn_score", "lang": "knn", "params": {
                    "field": "v", "query_value": qv,
                    "space_type": "l2"}}}}},
            {"qv": qv}))
        w = int(rng.choice(mid))
        out["script_fields"].append((
            {"query": {"match": {"body": words[w]}}, "script_fields": {
                "views2": {"script": {"source": "doc['views'].value * 2"}},
                "need_k": {"script": {"source": "doc['need'].value + "
                                                "params.k",
                                      "params": {"k": 10 + j}}}}},
            {"terms": [w], "k": 10 + j}))
        word = words[int(rng.choice(typo_ok))]
        out["suggest_term"].append((
            {"size": 0, "suggest": {"fix": {"text": dsl_typo(word),
                                            "term": {"field": "body"}}}},
            {"word": word}))
        ws = [words[int(t)] for t in rng.choice(common, 2, replace=False)]
        word = words[int(rng.choice(typo_ok))]
        out["suggest_phrase"].append((
            {"size": 0, "suggest": {"fix": {
                "text": f"{ws[0]} {dsl_typo(word)} {ws[1]}",
                "phrase": {"field": "body"}}}},
            {"phrase": f"{ws[0]} {word} {ws[1]}"}))
        w = int(rng.choice(mid))
        v_gte = int(rng.integers(0, 2_000))
        out["template"].append((
            {"id": "dsl-template", "params": {"q": words[w], "v": v_gte}},
            {"rendered": {"query": {"bool": {
                "must": [{"match": {"body": words[w]}}],
                "filter": [{"range": {"views": {"gte": v_gte}}}]}},
                "size": 10}}))
        for kind, pid in (("hybrid_norm", "dsl-norm"),
                          ("hybrid_rrf", "dsl-rrf")):
            ts = [int(t) for t in rng.choice(mid, 2, replace=False)]
            qv = qvec()
            subs = [{"match": {"body": " ".join(words[t] for t in ts)}},
                    {"knn": {"v": {"vector": qv, "k": 100}}}]
            out[kind].append(({"query": {"hybrid": {"queries": subs}}},
                              {"pipeline": pid, "subs": subs}))
    for j in range(DSL_SCRIPT):
        v_gt = int(rng.integers(100, 2_000))
        need = int(rng.integers(1, 4))
        out["script"].append((
            {"query": {"script": {"script": {
                "source": "doc['views'].value > params.v && "
                          "doc['need'].value == params.n",
                "params": {"v": v_gt, "n": need}}}}},
            {"mask": (corpus["views"] > v_gt) & (corpus["need"] == need)}))
    return out


def dsl_knn_bodies(rng, corpus: dict, words: list, body_idx,
                   bodies: dict) -> dict:
    """knn at k = 10 and 100 filtered by geo_distance, geo_bounding_box,
    terms_set, script (DSL_SCRIPT_KNN a k: a painless run a doc) and
    more_like_this: each filter
    a body of the same type above, widened to hold k docs."""
    n = len(corpus["views"])
    out = {}
    for k in DSL_KS:
        for name, source in (("geo_distance", "geo_distance"),
                             ("geo_bounding_box", "geo_bounding_box"),
                             ("terms_set", "terms_set"),
                             ("script", "script"), ("mlt", "mlt_text")):
            runs = []
            count = DSL_SCRIPT_KNN if name == "script" else DSL_QUERIES
            for j in range(count):
                body, meta = bodies[source][j]
                filt = json.loads(json.dumps(body["query"]))
                if name == "geo_distance":
                    filt["geo_distance"]["distance"] = "40km"
                    g = filt["geo_distance"]["loc"]
                    meta = {"mask": haversine_np(
                        g["lat"], g["lon"], corpus["lat"],
                        corpus["lon"]) <= 40000.0}
                elif name == "mlt":
                    meta = {"mask": dsl_mlt_bool(meta["like"], words,
                                                 body_idx, n)[1]}
                elif name == "geo_bounding_box":
                    box = filt["geo_bounding_box"]["loc"]
                    for corner, sign in (("top_left", 1), ("bottom_right",
                                                           -1)):
                        box[corner]["lat"] += sign * 0.3
                        box[corner]["lon"] -= sign * 0.3
                    t, b = box["top_left"]["lat"], box["bottom_right"]["lat"]
                    le, r = box["top_left"]["lon"], box["bottom_right"]["lon"]
                    meta = {"mask": (corpus["lat"] <= t) & (corpus["lat"] >= b)
                            & (corpus["lon"] >= le) & (corpus["lon"] <= r)}
                qv = corpus["v"][int(rng.integers(0, n))].tolist()
                runs.append(({"query": {"knn": {"v": {
                    "vector": qv, "k": k, "filter": filt}}}}, meta))
            out[f"knn_{name} k={k}"] = runs
    return out


def dsl_mlt_bool(like: list, words: list, body_idx, n: int,
                 min_doc_freq: int = 5, max_terms: int = 12) -> tuple:
    """The more_like_this rewrite by numpy tf-idf: each like term's tf
    times log(1 + n / df) over the shard, the best max_terms by (-score,
    field, term), minimum_should_match 30% (at least 1). Returns the
    explicit bool body and its match set."""
    tf: dict = {}
    for t in like:
        tf[t] = tf.get(t, 0) + 1
    scored = []
    for t, c in tf.items():
        df = len(body_idx.postings(t)[0])
        if df < min_doc_freq or df == 0:
            continue
        scored.append((c * math.log(1.0 + n / df), "body", words[t], t))
    scored.sort(key=lambda s: (-s[0], s[1], s[2]))
    top = scored[:max_terms]
    msm = max(int(len(top) * 30 / 100), 1)
    query = {"bool": {"should": [{"term": {"body": {"value": w, "boost": s}}}
                                 for s, _f, w, _t in top],
                      "minimum_should_match": msm}}
    counts = body_idx.match([t for *_r, t in top])[1]
    return query, counts >= msm


def dsl_hits(resp: dict) -> list:
    return [(int(h["_id"]), h["_score"]) for h in resp["hits"]["hits"]]


def dsl_truth_gate(node, kind: str, j: int, body: dict, meta: dict,
                   resp: dict, corpus: dict, words: list, body_idx,
                   slice_hash: np.ndarray) -> None:
    """One index-L search against its numpy truth."""
    label = f"[dsl] {kind} query {j}"
    n = len(corpus["views"])
    total = resp["hits"]["total"]["value"]
    hits = resp["hits"]["hits"]
    ids = [int(h["_id"]) for h in hits]
    if "scores" in meta:
        want = ranked_ids(meta["scores"], meta["mask"])
        got_scores = np.asarray([h["_score"] for h in hits], np.float32)
        if ids != want or not np.array_equal(
                got_scores, meta["scores"][want]):
            raise AssertionError(f"{label}: {ids} != numpy {want} (or not "
                                 f"its score bits)")
        if total != int(meta["mask"].sum()):
            raise AssertionError(f"{label}: total {total} != numpy "
                                 f"{int(meta['mask'].sum())}")
        return
    if "mask" in meta:
        if ids != first_ids(meta["mask"]) or total != int(meta["mask"].sum()):
            raise AssertionError(f"{label}: {ids} / {total} != numpy "
                                 f"{first_ids(meta['mask'])} / "
                                 f"{int(meta['mask'].sum())}")
        return
    if kind == "slice":
        want = int(((slice_hash % np.uint32(4)) == meta["slice"]).sum())
        if total != want:
            raise AssertionError(f"{label}: total {total} != numpy murmur3 "
                                 f"partition {want}")
        return
    if kind in ("mlt_text", "mlt_doc"):
        query, mask = dsl_mlt_bool(meta["like"], words, body_idx, n)
        want = node.search("lex", {"query": query})
        if resp["hits"] != want["hits"] or total != int(mask.sum()):
            raise AssertionError(f"{label}: not the hits of the explicit "
                                 f"bool of its numpy tf-idf terms, or not "
                                 f"its numpy total {int(mask.sum())}")
        return
    if kind in ("script_score_knn", "script_score_cosine"):
        mask = body_idx.match(meta["terms"])[1] > 0
        q = np.asarray(meta["qv"], np.float32)
        v = corpus["v"].astype(np.float32)
        dots = v @ q
        if kind == "script_score_knn":
            d2 = (np.float32(q @ q) - np.float32(2.0) * dots
                  + (v * v).sum(1, dtype=np.float32))
            scores = np.float32(1.0) / (np.float32(1.0) + d2)
        else:
            qn = np.sqrt(np.float32(q @ q))
            vn = np.sqrt((v * v).sum(1, dtype=np.float32))
            scores = (dots / np.maximum(qn * vn, np.float32(1e-12))
                      + np.float32(1.0))
        want = ranked_ids(scores, mask)
        got = np.asarray([h["_score"] for h in hits], np.float32)
        if kind == "script_score_knn":
            if ids != want or not np.array_equal(got, scores[want]):
                raise AssertionError(f"{label}: not numpy's knn_score "
                                     f"ranking on eighths bit for bit")
        elif not np.allclose(got, scores[ids], rtol=1e-6, atol=0) or \
                not np.allclose(scores[ids], scores[want], rtol=1e-6, atol=0):
            raise AssertionError(f"{label}: cosine scores off numpy's")
        if total != int(mask.sum()):
            raise AssertionError(f"{label}: total {total} != {mask.sum()}")
        return
    if kind == "script_score_painless":
        mask = body_idx.match(meta["terms"])[1] > 0
        scores = (corpus["views"].astype(np.float64) * 0.001
                  + corpus["need"]).astype(np.float32)
        want = ranked_ids(scores, mask)
        got = np.asarray([h["_score"] for h in hits], np.float32)
        if ids != want or not np.array_equal(got, scores[want]) or \
                total != int(mask.sum()):
            raise AssertionError(f"{label}: not numpy's painless scores")
        return
    if kind == "script_score_over_knn":
        plain = node.search("lex", {"query": {"bool": {"must": [
            body["query"]["script_score"]["query"]]}}})
        if dsl_hits(resp) != dsl_hits(plain) or total != 100:
            raise AssertionError(f"{label}: not the knn's own hits and l2 "
                                 f"scores")
        return
    if kind == "script_fields":
        for h in hits:
            d = int(h["_id"])
            want = {"views2": [int(corpus["views"][d]) * 2],
                    "need_k": [int(corpus["need"][d]) + meta["k"]]}
            if h.get("fields") != want:
                raise AssertionError(f"{label}: doc {d} fields "
                                     f"{h.get('fields')} != {want}")
        plain = node.search("lex", {"query": body["query"]})
        if dsl_hits(resp) != dsl_hits(plain):
            raise AssertionError(f"{label}: not the match's hits")
        return
    if kind == "suggest_term":
        opts = [o["text"] for o in resp["suggest"]["fix"][0]["options"]]
        if meta["word"] not in opts:
            raise AssertionError(f"{label}: {opts} lacks {meta['word']}")
        return
    if kind == "suggest_phrase":
        opts = [o["text"] for o in resp["suggest"]["fix"][0]["options"]]
        if meta["phrase"] not in opts:
            raise AssertionError(f"{label}: {opts} lacks {meta['phrase']}")
        return
    if kind == "template":
        want = node.search("lex", meta["rendered"])
        if resp["hits"] != want["hits"] or not hits:
            raise AssertionError(f"{label}: not the rendered body's hits")
        return
    if kind in ("hybrid_norm", "hybrid_rrf"):
        dsl_fusion_gate(node, label, kind, meta, resp)
        return
    raise AssertionError(f"{label}: no truth")


def dsl_fusion_gate(node, label: str, kind: str, meta: dict,
                    resp: dict) -> None:
    """A hybrid search's fused scores against a numpy fusion of its two
    sub-queries' own results (each alone, size 10, on the per-shard route
    the hybrid query phase takes): min_max a sub-query over its hits (a
    0.001 floor), the arithmetic mean under weights [0.3, 0.7]; or RRF,
    1 / (60 + rank) summed; rtol 1e-6."""
    from opensearch_tpu_torch.search import distributed_serving

    subs = []
    try:
        distributed_serving.enabled = False
        for sub in meta["subs"]:
            subs.append(dsl_hits(node.search("lex", {"query": sub})))
    finally:
        distributed_serving.enabled = True
    fused: dict = {}
    if kind == "hybrid_rrf":
        for hits in subs:
            for rank, (d, _s) in enumerate(sorted(
                    hits, key=lambda h: (-h[1], h[0]))):
                fused[d] = fused.get(d, 0.0) + 1.0 / (60 + rank + 1)
    else:
        for w, hits in zip((0.3, 0.7), subs):
            s = np.asarray([h[1] for h in hits], np.float64)
            lo, hi = s.min(), s.max()
            for d, sc in hits:
                norm = max((sc - lo) / (hi - lo), 0.001) if hi > lo else 1.0
                fused[d] = fused.get(d, 0.0) + w * norm
        fused = {d: f / (0.3 + 0.7) for d, f in fused.items()}
    got = dsl_hits(resp)
    want = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:10]
    # the same ranking, hits whose fused scores tie within rtol 1e-6 free
    # to swap
    if len(got) != len(want) or not np.allclose(
            [s for _d, s in got], [s for _d, s in want], rtol=1e-6, atol=0):
        raise AssertionError(f"{label}: {got} not numpy's fusion {want}")
    for d, s in got:
        if abs(s - fused[d]) > 1e-6 * abs(fused[d]):
            raise AssertionError(f"{label}: doc {d} fused {s!r}, numpy "
                                 f"{fused[d]!r}")


def dsl_k1_gate(kf, label: str, got: dict, searches: int, k: int,
                stacked: bool) -> None:
    """One K1 launch a search on the tier scan_tier names: the stacked
    step's pool width for k (a filtered knn), or the per-shard route's for
    k's power-of-two bucket (a knn inside hybrid or script_score; one
    segment)."""
    kb = k if stacked else 1 << (k - 1).bit_length()
    tier = kf.scan_tier("fp32", kf.fused_pool_width(kb, "fp32"))
    route = "stacked, filtered" if stacked else "per-shard"
    if got["knn_fused"] != searches or got[tier] != searches or \
            got["filtered"] != (searches if stacked else 0):
        raise AssertionError(f"{label}: want {searches} K1 launches on the "
                             f"{tier} tier ({route}): {got}")


def dsl_index_j(node, seed: int, words: list) -> dict:
    """Index J, a Q&A forum in one shard: DSL_J_QUESTIONS questions and
    DSL_J_ANSWERS answers (a join field ``qa``, question -> answer, each
    answer routed to its question), body text, a keyword tag, votes, a
    nested ``comments`` (author, stars) on answers and a 128-d ``v`` in
    eighths; by host _bulk and one refresh."""
    rng = np.random.default_rng([seed, 18, 1])
    nq, na = DSL_J_QUESTIONS, DSL_J_ANSWERS
    n = nq + na
    parent = rng.integers(0, nq, na)
    tags = rng.integers(0, 40, n)
    votes = rng.integers(0, 100, n)
    authors = [rng.integers(0, 200, int(rng.integers(1, 4)))
               for _ in range(na)]
    stars = [rng.integers(1, 6, len(a)) for a in authors]
    vecs = np.round(clustered(rng, n, DIM) * 8.0) / 8.0
    bodies = rng.integers(0, 5_000, (n, 12))
    node.create_index("qa", {"settings": {"number_of_shards": 1},
                             "mappings": {"properties": {
        "qa": {"type": "join", "relations": {"question": "answer"}},
        "body": {"type": "text"}, "tag": {"type": "keyword"},
        "votes": {"type": "long"},
        "comments": {"type": "nested", "properties": {
            "author": {"type": "keyword"}, "stars": {"type": "long"}}},
        "v": {"type": "knn_vector", "dimension": DIM,
              "similarity": "l2_norm"}}}})
    t0 = time.perf_counter()
    ops = []
    for i in range(n):
        doc = {"body": " ".join(words[t] for t in bodies[i]),
               "tag": f"t{int(tags[i])}", "votes": int(votes[i]),
               "v": vecs[i].tolist()}
        if i < nq:
            doc["qa"] = "question"
            ops.append(("index", {"_index": "qa", "_id": f"q{i}"}, doc))
        else:
            a = i - nq
            p = f"q{int(parent[a])}"
            doc["qa"] = {"name": "answer", "parent": p}
            doc["comments"] = [{"author": f"u{int(x)}", "stars": int(s)}
                               for x, s in zip(authors[a], stars[a])]
            ops.append(("index", {"_index": "qa", "_id": f"a{a}",
                                  "routing": p}, doc))
        if len(ops) == 5000 or i == n - 1:
            if node.bulk(ops)["errors"]:
                raise AssertionError("bulk into [qa] reported errors")
            ops = []
    node.refresh("qa")
    return {"parent": parent, "tags": tags, "votes": votes,
            "authors": authors, "v": vecs, "ingest_s":
            time.perf_counter() - t0}


def dsl_j_bodies(rng, j: dict) -> dict:
    """DSL_QUERIES bodies of each index-J type with their numpy doc
    masks over J's docs in ingest order (questions, then answers)."""
    nq, na = DSL_J_QUESTIONS, DSL_J_ANSWERS
    n = nq + na
    out = {k: [] for k in ("has_child", "has_parent", "parent_id",
                           "nested", "knn_has_parent")}
    a_votes = j["votes"][nq:]
    for _ in range(DSL_QUERIES):
        x = int(rng.integers(30, 90))
        m = int(rng.integers(1, 4))
        cnt = np.bincount(j["parent"][a_votes >= x], minlength=nq)
        mask = np.zeros(n, bool)
        mask[:nq] = cnt >= m
        out["has_child"].append((
            {"query": {"has_child": {"type": "answer", "min_children": m,
                                     "query": {"range": {
                                         "votes": {"gte": x}}}}}},
            {"mask": mask}))
        t = int(rng.integers(0, 40))
        mask = np.zeros(n, bool)
        mask[nq:] = j["tags"][:nq][j["parent"]] == t
        out["has_parent"].append((
            {"query": {"has_parent": {"parent_type": "question", "query": {
                "term": {"tag": f"t{t}"}}}}}, {"mask": mask}))
        q = int(rng.integers(0, nq))
        mask = np.zeros(n, bool)
        mask[nq:] = j["parent"] == q
        out["parent_id"].append((
            {"query": {"parent_id": {"type": "answer", "id": f"q{q}"}}},
            {"mask": mask}))
        u = int(rng.integers(0, 200))
        mask = np.zeros(n, bool)
        mask[nq:] = [u in a for a in j["authors"]]
        out["nested"].append((
            {"query": {"nested": {"path": "comments", "query": {
                "term": {"comments.author": f"u{u}"}}}}}, {"mask": mask}))
        t = int(rng.integers(0, 40))
        mask = np.zeros(n, bool)
        mask[nq:] = j["tags"][:nq][j["parent"]] == t
        qv = j["v"][int(rng.integers(0, n))].tolist()
        out["knn_has_parent"].append((
            {"query": {"knn": {"v": {"vector": qv, "k": 10, "filter": {
                "has_parent": {"parent_type": "question", "query": {
                    "term": {"tag": f"t{t}"}}}}}}}}, {"mask": mask}))
    return out


def dsl_j_id(i: int) -> str:
    nq = DSL_J_QUESTIONS
    return f"q{i}" if i < nq else f"a{i - nq}"


def dsl_index_p(node, rng, corpus: dict, words: list, body_idx) -> list:
    """Index P, a percolator index of DSL_P_QUERIES stored queries over
    index L's fields and vocabulary: term on tag, range on views, match on
    one body word, and a bool of two of those. Returns each query's
    (kind, args) for the numpy truth."""
    df = np.diff(body_idx.bounds)
    common = np.nonzero(df >= len(corpus["views"]) // 40)[0]
    tag_p = np.bincount(corpus["tag"], minlength=LEXICAL_TAGS).astype(
        np.float64)
    tag_p /= tag_p.sum()
    node.create_index("perc", {"settings": {"number_of_shards": 1},
                               "mappings": {"properties": {
        "q": {"type": "percolator"}, "body": {"type": "text"},
        "tag": {"type": "keyword"}, "views": {"type": "long"}}}})

    def one():
        kind = int(rng.integers(0, 3))
        if kind == 0:
            t = int(rng.choice(LEXICAL_TAGS, p=tag_p))
            return {"term": {"tag": f"g{t}"}}, ("tag", t)
        if kind == 1:
            lo = int(rng.integers(0, 2_000))
            hi = lo + int(rng.integers(100, 5_000))
            return {"range": {"views": {"gte": lo, "lte": hi}}}, \
                ("views", lo, hi)
        w = int(rng.choice(common))
        return {"match": {"body": words[w]}}, ("word", w)

    spec, ops = [], []
    for i in range(DSL_P_QUERIES):
        if i % 4 == 3:
            (q1, s1), (q2, s2) = one(), one()
            query, s = {"bool": {"must": [q1, q2]}}, ("and", s1, s2)
        else:
            query, s = one()
        spec.append(s)
        ops.append(("index", {"_index": "perc", "_id": str(i)}, {"q": query}))
    if node.bulk(ops, refresh=True)["errors"]:
        raise AssertionError("bulk into [perc] reported errors")
    return spec


def dsl_percolate_truth(spec: list, doc: dict) -> set:
    def holds(s) -> bool:
        if s[0] == "and":
            return holds(s[1]) and holds(s[2])
        if s[0] == "tag":
            return doc["tag"] == s[1]
        if s[0] == "views":
            return s[1] <= doc["views"] <= s[2]
        return s[1] in doc["tokens"]

    return {str(i) for i, s in enumerate(spec) if holds(s)}


def dsl_main_phase(node, kf, dev, seed: int, corpus: dict, words: list,
                   body_idx, n_segments: int) -> dict:
    """The rest of the query DSL on index L (the lexical phase's node,
    after the aggregations and before its ledger gate), on index J (a
    Q&A forum) and on index P (a percolator index). Gates, each a
    non-zero exit on a miss:

    1. index L's 23 types (dsl_bodies): hits and totals numpy's
       (dsl_truth_gate): haversine in float64, exact boxes, the rank and
       distance formulas' float32 bits, terms_set's counts, the murmur3
       partitions (summing to the live count), the MLT rewrite's hits
       those of the explicit bool of its numpy tf-idf terms, knn_score on
       eighths bit for bit, cosine within 1e-6, painless scores'
       bits, script fields, each suggester offering the word its typo
       came from, each template's hits the rendered body's, each hybrid's
       fused scores a numpy fusion of its sub-queries' own results
       (rtol 1e-6); script_score over a knn the knn's own hits;
    2. knn at k = 10 and 100 filtered by geo_distance, geo_bounding_box,
       terms_set, script and more_like_this, and on index J by has_parent:
       every hit inside the filter's numpy set, min(k, set) hits;
    3. every kNN-bearing search one K1 launch on the tier scan_tier names
       (dsl_k1_gate), and under search.knn.kernel xla (K1's plain
       version) the same hits bit for bit and no K1 launch;
    4. index J: has_child (min_children), has_parent, parent_id, nested:
       numpy's sets; DSL_UPDATES scripted updates and a scripted_upsert,
       each doc read back with its new value;
    5. index P: DSL_PERCOLATE percolate searches of documents of index L:
       the stored queries numpy's evaluation matches, and the residency
       ledger's bytes unchanged by each (the throwaway segment freed);
    6. DSL_HTTP searches of each type over the port's HTTP server (the
       pipelines and the template made through their routes): the
       in-process hits.
    Recorded: each type's p50 / p99 / QPS, the device ms beside the host
    wall of the K1-filtered types, the host cost a doc of the script and
    join loops, percolate's cost a stored query."""
    from opensearch_tpu_torch.rest.http import HttpServer
    from opensearch_tpu_torch.search import ann, distributed_serving
    from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

    t_phase = time.perf_counter()
    rng = np.random.default_rng([seed, 18, 2])
    n = len(corpus["views"])
    (shard,) = node.indices["lex"].shards.values()
    host = shard.acquire_searcher().segments[0][0]
    if n_segments != 1 or host.doc_ids[n - 1] != str(n - 1):
        raise AssertionError("[dsl] the truth reads index L's one segment "
                             "in id order")
    slice_hash = murmur3_ids(n)
    from opensearch_tpu_torch.common.hashing import murmur3_x86_32

    for d in (0, 9, 10, n // 2, n - 1):
        if murmur3_x86_32(str(d).encode()) & 0xFFFFFFFF != int(
                slice_hash[d]):
            raise AssertionError(f"[dsl] numpy murmur3 of id {d} is not "
                                 f"the hashing module's")
    tier_counter = {"lists": kf.list_launches, "wide": kf.wide_launches,
                    "mma": kf.mma_launches}
    out = {"types": {}, "launches": {}}
    bodies = dsl_bodies(rng, corpus, words, body_idx)
    knn_bodies = dsl_knn_bodies(rng, corpus, words, body_idx, bodies)
    server = HttpServer(node, "127.0.0.1", 0)
    server.start_in_thread()
    client = RestClient(server.port)
    try:
        # the pipelines and the template through their routes
        client.ok("PUT", "/_search/pipeline/dsl-norm", {
            "phase_results_processors": [{"normalization-processor": {
                "normalization": {"technique": "min_max"},
                "combination": {"technique": "arithmetic_mean",
                                "parameters": {"weights": [0.3, 0.7]}}}}]})
        client.ok("PUT", "/_search/pipeline/dsl-rrf", {
            "phase_results_processors": [{"score-ranker-processor": {
                "combination": {"technique": "rrf", "rank_constant": 60}}}]})
        client.ok("PUT", "/_scripts/dsl-template", {"script": {
            "lang": "mustache",
            "source": '{"query": {"bool": {"must": [{"match": {"body": '
                      '"{{q}}"}}], "filter": [{"range": {"views": {"gte": '
                      '{{v}}}}}]}}, "size": 10}'}})

        def run(kind: str, body: dict, meta: dict, index: str = "lex"):
            # uncached: a repeated size 0 body (a slice, a suggester) runs
            # its query phase each time
            if kind == "template":
                return node.search_template(index, dict(body),
                                            request_cache=False)
            return node.search(index, dict(body),
                               search_pipeline=meta.get("pipeline"),
                               request_cache=False)

        responses: dict = {}
        knn_kinds = {"script_score_over_knn": (100, False),
                     "hybrid_norm": (100, False),
                     "hybrid_rrf": (100, False)}
        for kind, runs in list(bodies.items()) + list(knn_bodies.items()):
            label = f"[dsl] {kind}"
            for c in (kf.launches, *tier_counter.values()):
                c.reset()
            filtered0 = distributed_serving.stats["filtered"]
            lat, resps = [], []
            for body, meta in runs:
                t0 = time.perf_counter()
                resps.append(run(kind, body, meta))
                lat.append(time.perf_counter() - t0)
            launches = {"knn_fused": kf.launches.count,
                        **{t: c.count for t, c in tier_counter.items()},
                        "filtered": distributed_serving.stats["filtered"]
                        - filtered0}
            res = latency_summary(lat)
            res["launches"] = launches
            if kind.startswith("knn_"):
                k = int(kind.split("k=")[1])
                dsl_k1_gate(kf, label, launches, len(runs), k, stacked=True)
                for j, ((body, meta), resp) in enumerate(zip(runs, resps)):
                    ids = [int(h["_id"]) for h in resp["hits"]["hits"]]
                    allowed = meta["mask"]
                    want_n = min(10, int(allowed.sum()))
                    if len(ids) != want_n or not all(allowed[d] for d in ids):
                        raise AssertionError(f"{label} query {j}: {len(ids)}"
                                             f" hits (want {want_n}), all "
                                             f"inside the filter's set")
            else:
                if kind in knn_kinds:
                    dsl_k1_gate(kf, label, launches, len(runs),
                                knn_kinds[kind][0], stacked=False)
                elif launches["knn_fused"]:
                    raise AssertionError(f"{label}: {launches} K1 launches "
                                         f"with no knn in the body")
                for j, ((body, meta), resp) in enumerate(zip(runs, resps)):
                    dsl_truth_gate(node, kind, j, body, meta, resp, corpus,
                                   words, body_idx, slice_hash)
            if kind == "script":
                res["host_us_a_doc"] = float(np.median(lat)) / n * 1e6
            responses[kind] = resps
            out["types"][kind] = res
            out["launches"][kind] = launches["knn_fused"]
            log(f"{label}: {json.dumps(res)}")
        slices = [r["hits"]["total"]["value"]
                  for r in responses["slice"][:4]]
        if sum(slices) != n:
            raise AssertionError(f"[dsl] slice totals {slices} do not sum "
                                 f"to the live count {n}")
        # index J and index P
        jout = dsl_j_phase(node, kf, seed, words, tier_counter, rng)
        out["index_j"] = jout.pop("summary")
        responses.update(jout["responses"])
        out["types"].update(jout["types"])
        out["launches"].update(jout["launches"])
        out["index_p"] = dsl_p_phase(node, rng, corpus, words, body_idx,
                                     default_ledger)
        responses["percolate"] = out["index_p"].pop("responses")
        p_bodies = out["index_p"].pop("bodies")
        # gate 3: every kNN-bearing type under K1's plain version
        xla = [k for k in responses if k.startswith("knn_")
               or k in knn_kinds]
        try:
            ann.default_config.configure(exact_kernel="xla")
            kf.launches.reset()
            for kind in xla:
                runs = (knn_bodies.get(kind) or bodies.get(kind)
                        or jout["bodies"][kind])
                index = "qa" if kind == "knn_has_parent" else "lex"
                for j, (body, meta) in enumerate(runs):
                    got = run(kind, body, meta, index)
                    if got["hits"] != responses[kind][j]["hits"]:
                        raise AssertionError(f"[dsl] {kind} query {j}: K1's "
                                             f"plain version gave other "
                                             f"hits")
            if kf.launches.count:
                raise AssertionError(f"[dsl] K1 launched {kf.launches.count}"
                                     f" times under search.knn.kernel xla")
        finally:
            ann.default_config.configure(exact_kernel="auto")
        log(f"[dsl] {len(xla)} kNN-bearing types under search.knn.kernel "
            f"xla (K1's plain version): the kernel's hits bit for bit")
        # gate 6: over HTTP
        out["http"] = dsl_http(client, bodies, knn_bodies, jout["bodies"],
                               p_bodies, responses)
        out["index_j"].update(dsl_j_updates(node, jout["j"], rng))
        # the device time beside the host wall of the K1-filtered types
        out["device"] = {}
        for kind in ("knn_geo_distance k=10", "knn_terms_set k=10",
                     "knn_mlt k=10", "hybrid_norm"):
            body, meta = (knn_bodies.get(kind) or bodies[kind])[0]
            prof = device_profile(lambda: run(kind, body, meta), 5)
            out["device"][kind] = prof and {
                "device_ms": prof["device_ms"], "wall_ms": prof["wall_ms"],
                "top": prof["top"]}
        log(f"[dsl] device ms against host wall: "
            f"{json.dumps(out['device'])}")
    finally:
        client.close()
        server.stop_thread()
    for name in ("qa", "perc"):
        node.delete_index(name)
    default_ledger.verify_identity()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def dsl_j_phase(node, kf, seed: int, words: list, tier_counter: dict,
                rng) -> dict:
    """Index J's searches, its K1-filtered knn, the scripted updates."""
    from opensearch_tpu_torch.search import distributed_serving

    j = dsl_index_j(node, seed, words)
    bodies = dsl_j_bodies(rng, j)
    out = {"types": {}, "launches": {}, "responses": {}, "bodies": bodies}
    nq = DSL_J_QUESTIONS
    for kind, runs in bodies.items():
        label = f"[dsl] J {kind}"
        for c in (kf.launches, *tier_counter.values()):
            c.reset()
        filtered0 = distributed_serving.stats["filtered"]
        lat, resps = [], []
        for body, _meta in runs:
            t0 = time.perf_counter()
            resps.append(node.search("qa", dict(body)))
            lat.append(time.perf_counter() - t0)
        launches = {"knn_fused": kf.launches.count,
                    **{t: c.count for t, c in tier_counter.items()},
                    "filtered": distributed_serving.stats["filtered"]
                    - filtered0}
        if kind == "knn_has_parent":
            dsl_k1_gate(kf, label, launches, len(runs), 10, stacked=True)
        elif launches["knn_fused"]:
            raise AssertionError(f"{label}: K1 launched without a knn")
        for i, ((_body, meta), resp) in enumerate(zip(runs, resps)):
            ids = [h["_id"] for h in resp["hits"]["hits"]]
            total = resp["hits"]["total"]["value"]
            if kind == "knn_has_parent":
                allowed = {dsl_j_id(d) for d in np.nonzero(meta["mask"])[0]}
                if len(ids) != min(10, len(allowed)) or \
                        not set(ids) <= allowed:
                    raise AssertionError(f"{label} query {i}: hits outside "
                                         f"the has_parent set")
                continue
            want = [dsl_j_id(d) for d in first_ids(meta["mask"])]
            if ids != want or total != int(meta["mask"].sum()):
                raise AssertionError(f"{label} query {i}: {ids} / {total} "
                                     f"!= numpy {want} / "
                                     f"{int(meta['mask'].sum())}")
        res = latency_summary(lat)
        res["launches"] = launches
        if kind in ("has_child", "has_parent"):
            res["host_us_a_doc"] = float(np.median(lat)) / (
                nq + DSL_J_ANSWERS) * 1e6
        out["types"][f"J {kind}"] = res
        out["launches"][f"J {kind}"] = launches["knn_fused"]
        out["responses"][kind] = resps
        log(f"{label}: {json.dumps(res)}")
    out["summary"] = {"docs": nq + DSL_J_ANSWERS, "ingest_s": j["ingest_s"]}
    out["j"] = j
    return out


def dsl_j_updates(node, j: dict, rng) -> dict:
    """DSL_UPDATES scripted updates of index J's answers and one
    scripted_upsert, each doc read back with its new value, and the count
    of docs past 100 votes numpy's."""
    nq = DSL_J_QUESTIONS
    picks = rng.choice(DSL_J_ANSWERS, DSL_UPDATES, replace=False)
    deltas = rng.integers(1, 50, DSL_UPDATES)
    t0 = time.perf_counter()
    for a, d in zip(picks.tolist(), deltas.tolist()):
        node.update_doc("qa", f"a{a}", {"script": {
            "source": "ctx._source.votes += params.d", "params": {"d": d}}},
            routing=f"q{int(j['parent'][a])}")
    node.update_doc("qa", "a_new", {
        "scripted_upsert": True, "script": {
            "source": "ctx._source.votes += 100"},
        "upsert": {"votes": 1, "tag": "t0"}}, routing="q0")
    update_s = time.perf_counter() - t0
    node.refresh("qa")
    for a, d in zip(picks.tolist(), deltas.tolist()):
        got = node.get_doc("qa", f"a{a}", routing=f"q{int(j['parent'][a])}")
        if got["_source"]["votes"] != int(j["votes"][nq + a]) + d:
            raise AssertionError(f"[dsl] J update of a{a}: votes "
                                 f"{got['_source']['votes']}")
    if node.get_doc("qa", "a_new", routing="q0")["_source"]["votes"] != 101:
        raise AssertionError("[dsl] J scripted_upsert: not 101 votes")
    total = node.count("qa", {"query": {"range": {"votes": {"gte": 101}}}})
    want = int(((j["votes"][nq:][picks] + deltas) >= 101).sum()) + 1 + int(
        (j["votes"] >= 101).sum())
    if total["count"] != want:
        raise AssertionError(f"[dsl] J after the updates: {total} docs with "
                             f"votes >= 101, numpy {want}")
    out = {"updates": DSL_UPDATES + 1,
           "update_ms_each": update_s / (DSL_UPDATES + 1) * 1e3}
    log(f"[dsl] J scripted updates, read back: {json.dumps(out)}")
    return out


def dsl_p_phase(node, rng, corpus: dict, words: list, body_idx,
                ledger) -> dict:
    """DSL_PERCOLATE percolate searches of index-L documents on index P."""
    t0 = time.perf_counter()
    spec = dsl_index_p(node, rng, corpus, words, body_idx)
    ingest_s = time.perf_counter() - t0
    bo, body = corpus["body_off"], corpus["body"]
    lat, resps, p_bodies = [], [], []
    for i in range(DSL_PERCOLATE):
        d = int(rng.integers(0, len(corpus["views"])))
        tokens = body[bo[d]:bo[d + 1]]
        doc = {"body": " ".join(words[t] for t in tokens),
               "tag": f"g{int(corpus['tag'][d])}",
               "views": int(corpus["views"][d])}
        p_bodies.append({"size": DSL_P_QUERIES, "query": {
            "percolate": {"field": "q", "document": doc}}})
        before = ledger.resident_bytes()
        t1 = time.perf_counter()
        resp = node.search("perc", dict(p_bodies[-1]))
        lat.append(time.perf_counter() - t1)
        ledger.verify_identity()
        if ledger.resident_bytes() != before:
            raise AssertionError(f"[dsl] percolate {i}: the ledger holds "
                                 f"{ledger.resident_bytes() - before} more "
                                 f"bytes (the throwaway segment leaked)")
        want = dsl_percolate_truth(spec, {
            "tag": int(corpus["tag"][d]), "views": int(corpus["views"][d]),
            "tokens": set(tokens.tolist())})
        got = {h["_id"] for h in resp["hits"]["hits"]}
        if got != want or resp["hits"]["total"]["value"] != len(want):
            raise AssertionError(f"[dsl] percolate {i}: {len(got)} stored "
                                 f"queries, numpy {len(want)}")
        resps.append(resp)
    res = latency_summary(lat)
    res.update(stored_queries=DSL_P_QUERIES, ingest_s=ingest_s,
               matched_p50=float(np.median(
                   [r["hits"]["total"]["value"] for r in resps])),
               ms_a_stored_query=float(np.median(lat)) / DSL_P_QUERIES * 1e3)
    log(f"[dsl] P percolate: {json.dumps(res)}")
    res.update(responses=resps, bodies=p_bodies)
    return res


def dsl_http(client, bodies: dict, knn_bodies: dict, j_bodies: dict,
             p_bodies: list, responses: dict) -> dict:
    """DSL_HTTP searches of each type over the port's server: the
    in-process hits (and suggestions)."""
    out = {}
    for kind, runs in (list(bodies.items()) + list(knn_bodies.items())
                       + list(j_bodies.items())
                       + [("percolate", [(b, {}) for b in p_bodies])]):
        index = ("qa" if kind in j_bodies
                 else "perc" if kind == "percolate" else "lex")
        lat = []
        # a script filter costs one painless run a doc of index L
        depth = 1 if kind == "script" else DSL_HTTP
        for j, (body, meta) in enumerate(runs[:depth]):
            path = f"/{index}/_search"
            if kind == "template":
                path = f"/{index}/_search/template"
            elif meta.get("pipeline"):
                path += f"?search_pipeline={meta['pipeline']}"
            t0 = time.perf_counter()
            payload = client.ok("POST", path, body)
            lat.append(time.perf_counter() - t0)
            want = json_view(responses[kind][j])
            for key in ("hits", "suggest"):
                if payload.get(key) != want.get(key):
                    raise AssertionError(f"[dsl] {kind} query {j} over "
                                         f"HTTP: not the in-process {key}")
        out[kind] = latency_summary(lat)
    log(f"[dsl] over HTTP: {DSL_HTTP} searches of each type the in-process "
        f"hits; "
        f"{json.dumps({k: round(v['p50_ms'], 3) for k, v in out.items()})}"
        f" p50 ms")
    return out


def dsl_phase(kf, dev, seed: int, n_docs: int = LEXICAL_DOCS) -> dict:
    """``--phases dsl``: index L built as lexical_main_phase builds it (the
    same corpus and dsl fields from the seed), then dsl_main_phase alone,
    then the ledger gate."""
    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

    rng = np.random.default_rng(seed + 15)
    words = [lexical_word(i) for i in range(LEXICAL_VOCAB)]
    corpus = lexical_corpus(rng, n_docs)
    corpus.update(dsl_fields(seed, n_docs))
    body_idx = TokenIndex(corpus["body"], corpus["body_off"])
    base = default_ledger.resident_bytes()
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device=dev)
        ingest_s = lexical_ingest(node, "lex", corpus, words)
        (shard,) = node.indices["lex"].shards.values()
        n_segments = len(shard.acquire_searcher().segments)
        log(f"[dsl] index L: {n_docs} docs, {n_segments} segment(s), bulk "
            f"+ refresh {ingest_s:.1f} s")
        out = dsl_main_phase(node, kf, dev, seed, corpus, words, body_idx,
                             n_segments)
        # match bodies: the profiled one leaves a bm25_term_scores row
        out["ledger"] = ledger_gate(node, "dsl", "lex", [
            {"query": {"match": {"body": f"{words[w]} {words[w + 40]}"}}}
            for w in (5, 9)], base)
        node.close()
    out["ingest_s"] = ingest_s
    return out


# --------------------------------------------------------------------------
# the cluster's core: three sim nodes in this process (cluster phase)
# --------------------------------------------------------------------------

CLUSTER_DOCS = 5_000          # index vecs (cut from SIFT-1M by the phase's
                              # 45 s: at 20,000 it took 44.6 on the card;
                              # then by the default run's time: 10,000 took
                              # 23.6 s of a 1,093 s run on a slow host)
CLUSTER_BATCH = 1_000         # docs a bulk through n0
CLUSTER_QUERIES = 16          # kNN a k (10 and 100) a stage
CLUSTER_REMOTE_DOCS = 2_000   # the cross-cluster remote's index
CLUSTER_DISK_PCT = 50.0       # each sim node's disk reading (see below)
# (method, path, body, top-level keys of the reference's answer): the 17
# control-plane routes of the single node; a _cat table's str is its first
# line (the pending-task queue of a single node is always empty)
CONTROL_PLANE_CALLS = (
    ("GET", "/_cluster/state", None,
     {"cluster_name", "cluster_uuid", "state_uuid", "version", "master_node",
      "cluster_manager_node", "nodes", "blocks", "metadata",
      "routing_table", "routing_nodes"}),
    ("GET", "/_cluster/state/metadata,routing_table", None,
     {"cluster_name", "cluster_uuid", "state_uuid", "metadata",
      "routing_table"}),
    ("GET", "/_cluster/state/metadata/cp", None,
     {"cluster_name", "cluster_uuid", "state_uuid", "metadata"}),
    ("GET", "/_cluster/pending_tasks", None, {"tasks"}),
    ("POST", "/_cluster/voting_config_exclusions?node_names=node-1", None,
     set()),
    ("DELETE", "/_cluster/voting_config_exclusions", None, set()),
    ("POST", "/_cluster/reroute?explain=true", {"commands": [{"move": {
        "index": "cp", "shard": 0, "from_node": "node-0",
        "to_node": "node-1"}}]}, {"acknowledged", "state", "explanations"}),
    ("GET", "/_cluster/allocation/explain", None,
     {"index", "shard", "primary", "current_state", "unassigned_info",
      "can_allocate", "allocate_explanation", "node_allocation_decisions"}),
    ("POST", "/_cluster/allocation/explain",
     {"index": "cp", "shard": 1, "primary": True},
     {"index", "shard", "primary", "current_state", "current_node",
      "can_remain_on_current_node", "can_rebalance_cluster",
      "can_rebalance_to_other_node", "rebalance_explanation"}),
    ("GET", "/_shard_stores", None, {"indices"}),
    ("GET", "/cp/_shard_stores", None, {"indices"}),
    ("GET", "/_recovery", None, {"cp"}),
    ("GET", "/cp/_recovery", None, {"cp"}),
    ("GET", "/_remote/info", None, set()),
    ("GET", "/_cat/recovery?v=true", None, "index shard time type stage"),
    ("GET", "/_cat/recovery/cp?v=true", None,
     "index shard time type stage"),
    ("GET", "/_cat/pending_tasks?v=true", None, ""),
)


class _Sim:
    """Three ClusterNodes on one deterministic sim queue, on `dev`; every
    message the transport carries counted by action."""

    def __init__(self, path, dev):
        from opensearch_tpu_torch.cluster.cluster_node import ClusterNode
        from opensearch_tpu_torch.testing.sim import (DeterministicTaskQueue,
                                                      MockTransport)

        self.queue = DeterministicTaskQueue(24)
        self.transport = MockTransport(self.queue, timeout_ms=400)
        self.sends: dict[str, int] = {}
        self.partial_targets: list[str] = []   # each search[node]'s node
        send = self.transport.send

        def counted(sender, target, action, *a, **kw):
            self.sends[action] = self.sends.get(action, 0) + 1
            if action == "indices:data/read/search[node]":
                self.partial_targets.append(target)
            return send(sender, target, action, *a, **kw)

        self.transport.send = counted
        self.node_ids = ["n0", "n1", "n2"]
        self.nodes = {}
        for nid in self.node_ids:
            node = ClusterNode(nid, path / nid, self.transport, self.queue,
                               self.node_ids, device=dev)
            # the disk-threshold decider reads this node's disk through its
            # fs probe; the sim's three nodes share one host disk, whose
            # fill is not the cluster's, so each reads a fixed 50%
            node.disk_usage_pct = CLUSTER_DISK_PCT
            self.nodes[nid] = node
        for node in self.nodes.values():
            node.bootstrap(self.node_ids)
        for node in self.nodes.values():
            node.start()

    def run(self, ms: int) -> None:
        self.queue.run_until(self.queue.now_ms + ms)

    def call(self, fn, *args, **kw):
        out = []
        fn(*args, callback=out.append, **kw)
        for _ in range(1_000_000):
            if out:
                return out[0]
            if not self.queue.run_one():
                break
        raise AssertionError(f"{getattr(fn, '__name__', fn)}: no response")

    def leader(self):
        leaders = [n for nid, n in self.nodes.items()
                   if nid not in self.transport.down and n.is_leader]
        if len(leaders) != 1:
            raise AssertionError(f"{len(leaders)} leaders")
        return leaders[0]

    def copies(self, index: str) -> list:
        return sorted((r.shard, r.node_id or "", r.primary, r.state)
                      for r in self.leader().applied_state.shards_for_index(
                          index))

    def green(self, index: str, want: int) -> bool:
        """`want` copies of `index`, all STARTED, as the one leader sees
        them (False while two nodes still lead, as after a heal)."""
        if sum(n.is_leader for nid, n in self.nodes.items()
               if nid not in self.transport.down) != 1:
            return False
        copies = self.copies(index)
        return len(copies) == want and all(
            node and st == "STARTED" for _s, node, _p, st in copies)

    def settle(self, ok, what: str, step_ms: int = 5_000,
               steps: int = 40) -> int:
        """Run the sim until ok() holds; returns the virtual ms it took."""
        for i in range(steps):
            if ok():
                return i * step_ms
            self.run(step_ms)
        if ok():
            return steps * step_ms
        raise AssertionError(f"{what}: not reached in {steps * step_ms} "
                             f"virtual ms")

    def put_transient(self, transient: dict) -> None:
        leader = self.leader()
        out = []
        self.transport.send(
            leader.node_id, leader.node_id, "cluster:admin/settings/update",
            {"transient": transient}, on_response=out.append,
            on_failure=lambda e: out.append({"error": str(e)}))
        for _ in range(10_000):
            if out:
                break
            self.queue.run_one()
        if not out or "error" in out[0]:
            raise AssertionError(f"cluster settings update: {out}")

    def close(self) -> None:
        for node in self.nodes.values():
            node.close()


def knn_hits_check(kf, label: str, resp: dict, q: np.ndarray, want: list,
                   data: np.ndarray, dev, allow_failed: bool = False) -> tuple:
    """A bare l2 kNN's response against the brute force: no error, no
    failed shard (unless allowed), the ids `want` in order, each score
    within the f32 bound of its doc's f64 score. Returns (failed shards,
    worst |score - f64 score|)."""
    from opensearch_tpu_torch.ops import knn_rescore as kr

    if "error" in resp:
        raise AssertionError(f"{label}: {resp}")
    failed = resp["_shards"]["failed"]
    if failed and not allow_failed:
        raise AssertionError(f"{label}: _shards {resp['_shards']}")
    hits = resp["hits"]["hits"]
    got = [h["_id"] for h in hits]
    if got != want:
        raise AssertionError(f"{label}: {got} != brute force {want}")
    rows = torch.from_numpy(data[[int(i) for i in got]]).to(dev)
    qt = torch.from_numpy(q).to(dev)
    lo, hi = f32_score_bounds(
        kf, rows.double(), qt.double(),
        kr.plain_query_sq(qt[None])[0].double(),
        (rows.double() ** 2).sum(1).float().double(), "l2_norm")
    scores = torch.tensor([h["_score"] for h in hits],
                          dtype=torch.float64, device=dev)
    bad = (scores < lo) | (scores > hi)
    if bool(bad.any()):
        j = int(bad.nonzero()[0])
        raise AssertionError(
            f"{label}: hit {got[j]} score {float(scores[j])!r} outside its "
            f"f32 bound [{float(lo[j])!r}, {float(hi[j])!r}]")
    exact = 1.0 / (1.0 + ((rows.double() - qt.double()) ** 2).sum(1))
    return failed, float((scores - exact).abs().max())


def cluster_knn_stage(sim, kf, via: str, label: str, index: str,
                      data: np.ndarray, queries: np.ndarray, truth: dict,
                      dev, ks=(10, 100), allow_failed: bool = False) -> dict:
    """CLUSTER_QUERIES bare kNN at each k through `via`: each one's hits the
    brute force's ids in order, each score within the f32 bound of its
    doc's f64 score, `_shards.failed` 0, and on the card K1's launch
    counter up by the search's node partials (search[node] RPCs, 1-3) and
    no search[shard] fallback. Each node serving partials builds its
    stacked bundle at most once in the stage (a shard leaving a node drops
    every node's bundle of the index, shard_mesh.invalidate_index, so
    after a node loss or a drain each rebuilds once). Returns the stage's
    counts and walls."""
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry

    node = sim.nodes[via]
    out = {"searches": 0, "node_partials": 0, "launches": 0, "failed": 0,
           "builds": 0, "worst_abs_err": 0.0}
    walls = []
    builds0 = default_registry.stats["builds"]
    targets0 = len(sim.partial_targets)
    for k in ks:
        for qi, q in enumerate(queries):
            before = (kf.launches.count,
                      sim.sends.get("indices:data/read/search[node]", 0),
                      sim.sends.get("indices:data/read/search[shard]", 0))
            t0 = time.perf_counter()
            resp = sim.call(node.search, index, {
                "query": {"knn": {"v": {"vector": q.tolist(), "k": k}}},
                "size": k})
            walls.append(time.perf_counter() - t0)
            launches = kf.launches.count - before[0]
            partials = (sim.sends.get("indices:data/read/search[node]", 0)
                        - before[1])
            fallback = (sim.sends.get("indices:data/read/search[shard]", 0)
                        - before[2])
            failed, err = knn_hits_check(kf, f"[{label}] k={k} query {qi}",
                                         resp, q, truth[k][qi], data, dev,
                                         allow_failed)
            out["failed"] += failed
            out["worst_abs_err"] = max(out["worst_abs_err"], err)
            if dev.type == "cuda":
                if fallback or not 1 <= partials <= 3 \
                        or launches != partials:
                    raise AssertionError(
                        f"[{label}] k={k} query {qi}: {launches} K1 "
                        f"launches for {partials} node partials "
                        f"({fallback} per-shard fallbacks)")
            out["searches"] += 1
            out["node_partials"] += partials
            out["launches"] += launches
    out["builds"] = default_registry.stats["builds"] - builds0
    out["serving_nodes"] = sorted(set(sim.partial_targets[targets0:]))
    if not 1 <= out["builds"] <= len(out["serving_nodes"]):
        raise AssertionError(f"[{label}] {out['builds']} bundle builds on "
                             f"{out['serving_nodes']}")
    out["search_ms"] = latency_summary(walls)
    log(f"[cluster {label}] {out['searches']} kNN through {via} equal the "
        f"brute force: {json.dumps(out)}")
    return out


def cluster_phase(kf, dev, seed: int, n_docs: int = CLUSTER_DOCS,
                  remote_docs: int = CLUSTER_REMOTE_DOCS) -> dict:
    """The cluster's core in one process (``--phases cluster``; last of
    all by default, on nodes of its own)."""
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry
    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.rest.http import HttpServer
    from opensearch_tpu_torch.snapshots.service import ClusterSnapshotsService

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 240)
    data = rng.standard_normal((n_docs, DIM)).astype(np.float32)
    queries = rng.standard_normal((CLUSTER_QUERIES, DIM)).astype(np.float32)
    ids = [str(i) for i in range(n_docs)]
    truth = {k: brute_ids(kf, data, queries, k, ids, dev) for k in (10, 100)}
    out: dict = {"docs": n_docs}
    # wall seconds of each part of the phase
    parts = out["parts_s"] = {"truth": time.perf_counter() - t_phase}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        sim = _Sim(tmp / "sim", dev)
        try:
            sim.run(5_000)
            leader = sim.leader()
            log(f"[cluster] 3 sim nodes on {dev}, leader {leader.node_id}")
            resp = sim.call(sim.nodes["n0"].create_index, "vecs", {
                "settings": {"index": {
                    "number_of_shards": 3, "number_of_replicas": 1,
                    # the translog syncs at its interval, not at each
                    # write: an fsync a doc on the primary and on the
                    # replica would be most of the ingest, and no gate
                    # reads the disk
                    "translog": {"durability": "async"}}},
                "mappings": {"properties": {"v": {
                    "type": "knn_vector", "dimension": DIM,
                    "similarity": "l2_norm"}}}})
            if not resp.get("acknowledged"):
                raise AssertionError(f"create [vecs]: {resp}")
            sim.settle(lambda: sim.green("vecs", 6), "[vecs] green")
            parts["sim_boot"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for lo in range(0, n_docs, CLUSTER_BATCH):
                resp = sim.call(sim.nodes["n0"].bulk, [
                    ("index", {"_index": "vecs", "_id": str(i)},
                     {"v": data[i].tolist()})
                    for i in range(lo, min(lo + CLUSTER_BATCH, n_docs))])
                if resp.get("errors") or "error" in resp:
                    raise AssertionError(f"bulk into [vecs]: "
                                         f"{str(resp)[:300]}")
            sim.call(sim.nodes["n0"].refresh, "vecs")
            sim.run(1_000)
            out["ingest_s"] = time.perf_counter() - t0
            out["ingest_us_a_doc"] = out["ingest_s"] / n_docs * 1e6
            counts = {nid: sum(sh.num_docs for (idx, _s), sh
                               in node.local_shards.items() if idx == "vecs")
                      for nid, node in sim.nodes.items()}
            if sum(counts.values()) != 2 * n_docs:
                raise AssertionError(f"[vecs] copies hold {counts} docs, not "
                                     f"2 x {n_docs}")
            log(f"[cluster] ingest of {n_docs} docs (3 shards, 1 replica) "
                f"through n0 in bulks of {CLUSTER_BATCH}: "
                f"{out['ingest_s']:.2f} s, {out['ingest_us_a_doc']:.1f} us a "
                f"doc; docs a node {counts}")
            stage = functools.partial(cluster_knn_stage, sim, kf, data=data,
                                      queries=queries, truth=truth, dev=dev)
            out["green"] = stage("n1", "green", "vecs")

            # node loss: the node holding shard 0's primary is isolated
            lost = sim.leader().applied_state.primary("vecs", 0).node_id
            others = set(sim.node_ids) - {lost}
            via = "n1" if lost != "n1" else "n0"
            sim.transport.isolate(lost, others)
            early = sim.call(sim.nodes[via].search, "vecs", {"query": {"knn": {
                "v": {"vector": queries[0].tolist(), "k": 10}}}, "size": 10})
            out["failed_before_promotion"] = early.get("_shards")
            log(f"[cluster] {lost} isolated; a search through {via} before "
                f"the promotion: _shards {early.get('_shards')}")

            def promoted() -> bool:
                live = [n for nid, n in sim.nodes.items()
                        if nid in others and n.is_leader]
                if len(live) != 1:
                    return False
                p = live[0].applied_state.primary("vecs", 0)
                return p is not None and p.node_id in others \
                    and p.state == "STARTED"

            out["promotion_virtual_ms"] = sim.settle(
                promoted, "shard 0's replica promoted", step_ms=1_000)
            out["promoted"] = stage(via, "promoted", "vecs")

            # heal: the node rejoins and its copies recover from the
            # primaries (ops-based peer recovery)
            sim.transport.heal()
            out["recovery_virtual_ms"] = sim.settle(
                lambda: sim.green("vecs", 6), "[vecs] green after heal")
            stages = sorted({(k, getattr(p, "stage", None))
                             for n in sim.nodes.values()
                             for k, p in n.recoveries.items()
                             if k[0] == "vecs"})
            out["recoveries"] = [f"{k[0]}[{k[1]}] {st}" for k, st in stages]
            log(f"[cluster] healed: green in {out['recovery_virtual_ms']} "
                f"virtual ms; recoveries {out['recoveries']}")
            sim.call(sim.nodes["n0"].refresh, "vecs")
            sim.run(1_000)
            out["healed"] = stage("n1", "healed", "vecs")

            # drain n1 by allocation filter
            old_engines = {sh.engine.instance_id for (idx, _s), sh
                           in sim.nodes["n1"].local_shards.items()
                           if idx == "vecs"}
            sim.put_transient(
                {"cluster.routing.allocation.exclude._name": "n1"})

            def drained() -> bool:
                return sim.green("vecs", 6) and not any(
                    node == "n1" for _s, node, _p, _st in sim.copies("vecs")) \
                    and not any(idx == "vecs" for idx, _s
                                in sim.nodes["n1"].local_shards)

            out["drain_virtual_ms"] = sim.settle(drained, "n1 drained")
            out["drained"] = stage("n1", "drained", "vecs")
            with default_registry._lock:
                stale = [k for k in default_registry._bundles
                         if set(k[3]) & old_engines]
            if stale:
                raise AssertionError(f"bundles still hold n1's old engines: "
                                     f"{stale}")
            log(f"[cluster] n1 drained in {out['drain_virtual_ms']} virtual "
                f"ms: it holds no shard, and no resident bundle holds one of "
                f"its {len(old_engines)} old engines")

            # snapshot and restore under another name
            svc = ClusterSnapshotsService(sim.nodes["n0"], tmp / "snaprepo")
            t0 = time.perf_counter()
            resp = sim.call(svc.create, "snap1", "vecs")
            if resp.get("state") != "SUCCESS" or resp.get("docs") != n_docs:
                raise AssertionError(f"snapshot [vecs]: {resp}")
            resp = sim.call(svc.restore, "snap1", "vecs-restored")
            if resp.get("state") != "SUCCESS" or resp.get("docs") != n_docs:
                raise AssertionError(f"restore [vecs-restored]: {resp}")
            sim.run(2_000)
            sim.call(sim.nodes["n1"].refresh, "vecs-restored")
            sim.run(1_000)
            out["snapshot_restore_s"] = time.perf_counter() - t0
            out["restored"] = stage("n1", "restored", "vecs-restored",
                                    ks=(10,))
        finally:
            t0 = time.perf_counter()
            sim.close()
            parts["sim_close"] = time.perf_counter() - t0
        parts["searches"] = sum(
            out[s]["searches"] / out[s]["search_ms"]["qps"] for s in
            ("green", "promoted", "healed", "drained", "restored"))
        t0 = time.perf_counter()

        # cross-cluster kNN: a remote TorchNode behind the HTTP server
        remote = TorchNode(tmp / "remote", device=dev)
        local = TorchNode(tmp / "local", device=dev)
        srv = HttpServer(remote, "127.0.0.1", 0)
        srv.start_in_thread()
        try:
            _bulk_index(remote, "remote-vecs", data[:remote_docs], 2)
            local.put_cluster_settings({"persistent": {"cluster": {"remote": {
                "c2": {"seeds": f"127.0.0.1:{srv.port}"}}}}})
            fed_launches = []
            for qi, q in enumerate(queries[:8]):
                body = {"query": {"knn": {"v": {"vector": q.tolist(),
                                                "k": 10}}}, "size": 10}
                before = kf.launches.count
                fed = local.search("c2:remote-vecs", body)
                fed_launches.append(kf.launches.count - before)
                own = remote.search("remote-vecs", body)
                got = [(h["_id"], h["_score"]) for h in fed["hits"]["hits"]]
                want = [(h["_id"], h["_score"]) for h in own["hits"]["hits"]]
                if got != want or {h["_index"] for h in fed["hits"]["hits"]} \
                        != {"c2:remote-vecs"}:
                    raise AssertionError(f"[c2:remote-vecs] query {qi}: "
                                         f"{got} != the remote's {want}")
                if dev.type == "cuda" and fed_launches[-1] != 1:
                    raise AssertionError(f"[c2:remote-vecs] query {qi}: "
                                         f"{fed_launches[-1]} K1 launches")
            out["cross_cluster_launches"] = fed_launches
            log(f"[cluster] cross-cluster kNN c2:remote-vecs: 8 searches "
                f"equal the remote's own, K1 launches {fed_launches}")
        finally:
            srv.stop_thread()
            remote.close()
            local.close()
        parts["cross_cluster"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # the 17 control-plane routes over HTTP on a small single node
        single = TorchNode(tmp / "single", device=dev)
        srv = HttpServer(single, "127.0.0.1", 0)
        srv.start_in_thread()
        try:
            single.create_index("cp", {
                "settings": {"number_of_shards": 2, "number_of_replicas": 1},
                "mappings": {"properties": {"v": {
                    "type": "knn_vector", "dimension": DIM}}}})
            single.bulk([("index", {"_index": "cp", "_id": str(i)},
                          {"v": data[i].tolist()}) for i in range(200)])
            single.refresh("cp")
            before = _launch_counts()
            import http.client

            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=60)
            for method, path, body, keys in CONTROL_PLANE_CALLS:
                conn.request(method, path,
                             body=None if body is None else json.dumps(body),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                raw = resp.read()
                if resp.status != 200:
                    raise AssertionError(f"{method} {path}: {resp.status} "
                                         f"{raw[:300]!r}")
                if isinstance(keys, str):
                    first = " ".join(raw.decode().split("\n")[0].split())
                    if not first.startswith(keys):
                        raise AssertionError(f"{method} {path}: {raw[:200]!r}")
                    continue
                got = set(json.loads(raw))
                if got != keys:
                    raise AssertionError(f"{method} {path}: keys "
                                         f"{sorted(got)} != {sorted(keys)}")
            conn.close()
            moved = {key: n - before[key] for key, n in _launch_counts().items()
                     if n != before[key]}
            if moved:
                raise AssertionError(f"the control plane launched {moved}")
            log(f"[cluster] the 17 control-plane routes over HTTP: "
                f"{len(CONTROL_PLANE_CALLS)} calls answer 200 with the "
                f"reference's keys, no kernel launched")
        finally:
            srv.stop_thread()
            single.close()
        parts["control_plane"] = time.perf_counter() - t0
    out["launches"] = sum(out[s]["launches"] for s in
                          ("green", "promoted", "healed", "drained",
                           "restored")) + sum(out["cross_cluster_launches"])
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[cluster] record: {json.dumps(out)}")
    return out


# --------------------------------------------------------------------------
# the cluster over sockets: three ClusterServers on loopback (tcp phase)
# --------------------------------------------------------------------------

TCP_DOCS = 5_000              # index vecs (cut from SIFT-1M by the phase's
                              # 45 s: at 10,000 it took 45.5 on the card,
                              # the ingest over HTTP and TCP 21.7 of it)
TCP_BATCH = 1_000             # docs a _bulk through n0
TCP_QUERIES = 16              # kNN a k a node, and after the leader kill
TCP_CLIENTS = 8               # concurrent HTTP clients through n1
TCP_PER_CLIENT = 8            # kNN a client
TCP_MSEARCH = 32              # bare kNN in the _msearch through n2
TCP_MGET = 256                # acked docs read back by _mget after the kill
TCP_DISK_PCT = 50.0           # each node's disk reading (see _TcpCluster)
TCP_WALL_S = 45
TCP_BOOT_ATTEMPTS = 5
TCP_ROUTES = ("/_nodes/stats", "/_cat/nodes", "/_cat/recovery", "/_recovery",
              "/_prometheus/metrics?cluster=true")
SEARCH_NODE = "indices:data/read/search[node]"
MSEARCH_NODE = "indices:data/read/msearch[node]"
SEARCH_SHARD = "indices:data/read/search[shard]"


class _TcpCluster:
    """Three ClusterServers of the port (n0-n2) on 127.0.0.1, on `dev`,
    their transports' event loop on a thread of its own; every message a
    transport sends counted by action, and each search[node] /
    msearch[node] RPC's target kept.

    Each node reads its disk as TCP_DISK_PCT: the three share one host
    disk, whose fill is not the cluster's, and over the 90% high
    watermark the disk-threshold decider would leave every replica
    unassigned. A boot that meets EADDRINUSE runs again on fresh
    ports."""

    def __init__(self, path, dev):
        import asyncio

        self.asyncio = asyncio
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True, name="tcp-transport")
        self.thread.start()
        self.node_ids = ["n0", "n1", "n2"]
        self.servers: dict = {}
        self.rest: dict = {}
        self.sends: dict[str, int] = {}
        self.partial_targets: list[str] = []
        self._lock = threading.Lock()
        try:
            self.run(self._boot(path, dev))
            self.rest = {nid: RestClient(self.http_ports[nid])
                         for nid in self.node_ids}
        except BaseException:
            self.close()
            raise

    def run(self, coro, timeout: float = 120.0):
        return self.asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def _count(self, transport) -> None:
        send = transport.send

        def counted(sender, target, action, *a, **kw):
            with self._lock:
                self.sends[action] = self.sends.get(action, 0) + 1
                if action in (SEARCH_NODE, MSEARCH_NODE):
                    self.partial_targets.append(target)
            return send(sender, target, action, *a, **kw)

        transport.send = counted

    async def _boot(self, path, dev) -> None:
        import errno

        from opensearch_tpu_torch.server import ClusterServer
        from opensearch_tpu_torch.testing.soak_tcp import free_ports

        for attempt in range(TCP_BOOT_ATTEMPTS):
            ports = free_ports(2 * len(self.node_ids))
            self.seeds = {nid: ("127.0.0.1", ports[i])
                          for i, nid in enumerate(self.node_ids)}
            self.http_ports = {nid: ports[len(self.node_ids) + i]
                               for i, nid in enumerate(self.node_ids)}
            try:
                for nid in self.node_ids:
                    srv = ClusterServer(
                        nid, path / f"boot{attempt}" / nid, "127.0.0.1",
                        self.seeds[nid][1], self.http_ports[nid], self.seeds,
                        loop=self.loop, device=dev)
                    srv.node.disk_usage_pct = TCP_DISK_PCT
                    self._count(srv.transport)
                    self.servers[nid] = srv
                    await srv.start(bootstrap=self.node_ids)
                return
            except OSError as e:
                if e.errno != errno.EADDRINUSE \
                        or attempt == TCP_BOOT_ATTEMPTS - 1:
                    raise
                log(f"[tcp] boot {attempt}: {e}; again on fresh ports")
                await self._close_servers()

    async def _close_servers(self) -> None:
        for srv in self.servers.values():
            await srv.aclose()
        self.servers.clear()

    def count(self, action: str) -> int:
        with self._lock:
            return self.sends.get(action, 0)

    def leader(self, timeout_s: float = 60.0) -> str:
        """The one leader every live node agrees on."""
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            leaders = {nid for nid, srv in self.servers.items()
                       if srv.node.is_leader}
            known = {srv.node.coordinator.leader_id
                     for srv in self.servers.values()}
            if len(leaders) == 1 and known == leaders:
                return next(iter(leaders))
            time.sleep(0.02)
        raise AssertionError(f"[tcp] no stable leader in {timeout_s} s")

    def health(self, via: str, ok, what: str,
               timeout_s: float = 60.0) -> dict:
        """Poll _cluster/health through `via` until ok(health)."""
        deadline = time.perf_counter() + timeout_s
        health = None
        while time.perf_counter() < deadline:
            status, health = self.rest[via]("GET", "/_cluster/health")
            if status == 200 and ok(health):
                return health
            time.sleep(0.05)
        raise AssertionError(f"[tcp] {what}: not reached in {timeout_s} s: "
                             f"{health}")

    def kill(self, nid: str) -> None:
        """The node's process dies: its REST port, its transport and its
        ClusterNode close."""
        self.rest.pop(nid).close()
        srv = self.servers.pop(nid)
        self.run(srv.aclose())

    def close(self) -> None:
        for rest in self.rest.values():
            rest.close()
        self.rest = {}
        try:
            self.run(self._close_servers())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(30)
            self.loop.close()


def tcp_knn_body(q: np.ndarray, k: int) -> dict:
    return {"query": {"knn": {"v": {"vector": q.tolist(), "k": k}}},
            "size": k}


def tcp_phase(kf, dev, seed: int, n_docs: int = TCP_DOCS) -> dict:
    """The cluster over sockets (``--phases tcp``; after the cluster phase
    by default, on servers of its own): three port ClusterServers on
    loopback TCP, driven only through their REST ports."""
    from opensearch_tpu_torch.cluster.shard_mesh import (_bundle_nbytes,
                                                         default_registry)
    from opensearch_tpu_torch.search.batcher import default_batcher
    from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 250)
    data = rng.standard_normal((n_docs, DIM)).astype(np.float32)
    queries = rng.standard_normal((TCP_QUERIES + TCP_MSEARCH, DIM)).astype(
        np.float32)
    ids = [str(i) for i in range(n_docs)]
    truth = {10: brute_ids(kf, data, queries, 10, ids, dev),
             100: brute_ids(kf, data, queries[:TCP_QUERIES], 100, ids, dev)}
    out: dict = {"docs": n_docs}
    parts = out["parts_s"] = {"truth": time.perf_counter() - t_phase}
    cuda = dev.type == "cuda"
    # no K1 launch and no stacked-bundle build may run on the transports'
    # event loop: heartbeats and elections run there
    on_loop: list = []
    put, add = default_registry.put, kf.launches.add
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cl = _TcpCluster(pathlib.Path(tmp), dev)

        def audited_put(*a, **kw):
            if threading.current_thread() is cl.thread:
                on_loop.append("bundle build")
            return put(*a, **kw)

        def audited_add():
            if threading.current_thread() is cl.thread:
                on_loop.append("K1 launch")
            return add()

        default_registry.put = audited_put
        kf.launches.add = audited_add
        try:
            leader = cl.leader()
            out["boot_leader"] = leader
            status, resp = cl.rest["n0"]("PUT", "/vecs", {
                "settings": {"index": {
                    "number_of_shards": 3, "number_of_replicas": 1,
                    # the translog syncs at its interval, as in the
                    # cluster phase: no gate reads the disk
                    "translog": {"durability": "async"}}},
                "mappings": {"properties": {"v": {
                    "type": "knn_vector", "dimension": DIM,
                    "similarity": "l2_norm"}}}})
            if status != 200 or not resp.get("acknowledged"):
                raise AssertionError(f"[tcp] create [vecs]: {status} {resp}")
            cl.health("n0", lambda h: h["status"] == "green"
                      and h["active_shards"] == 6, "[vecs] green")
            parts["boot"] = time.perf_counter() - t0
            log(f"[tcp] 3 ClusterServers on {dev} (leader {leader}): [vecs] "
                f"green in {parts['boot']:.2f} s")

            t0 = time.perf_counter()
            for lo in range(0, n_docs, TCP_BATCH):
                nd = [x for i in range(lo, min(lo + TCP_BATCH, n_docs))
                      for x in ({"index": {"_index": "vecs", "_id": str(i)}},
                                {"v": data[i].tolist()})]
                status, resp = cl.rest["n0"]("POST", "/_bulk", ndjson=nd)
                if status != 200 or resp.get("errors"):
                    raise AssertionError(f"[tcp] _bulk into [vecs]: {status} "
                                         f"{str(resp)[:300]}")
                bad = [it for it in resp["items"]
                       if it["index"]["_shards"]["failed"]
                       or it["index"]["_shards"]["successful"] != 2]
                if bad:
                    raise AssertionError(f"[tcp] _bulk items not on both "
                                         f"copies: {bad[:3]}")
            status, resp = cl.rest["n0"]("POST", "/vecs/_refresh")
            if status != 200:
                raise AssertionError(f"[tcp] _refresh: {status} {resp}")
            out["ingest_s"] = time.perf_counter() - t0
            out["ingest_us_a_doc"] = out["ingest_s"] / n_docs * 1e6
            status, resp = cl.rest["n1"]("POST", "/vecs/_count", {})
            if status != 200 or resp["count"] != n_docs:
                raise AssertionError(f"[tcp] _count: {status} {resp}")
            parts["ingest"] = out["ingest_s"]
            log(f"[tcp] ingest of {n_docs} docs (3 shards, 1 replica) through "
                f"n0's _bulk in batches of {TCP_BATCH}: "
                f"{out['ingest_s']:.2f} s, {out['ingest_us_a_doc']:.1f} us a "
                f"doc")

            def knn(via: str, label: str, qs, want, k: int,
                    solo: dict | None = None) -> dict:
                """Bare kNN through `via`'s REST port one at a time: the
                brute force's hits, and on the card K1 up by the search's
                node partials with no per-shard fallback."""
                st = {"searches": 0, "node_partials": 0, "launches": 0,
                      "worst_abs_err": 0.0}
                walls = []
                for qi, q in enumerate(qs):
                    before = (kf.launches.count, cl.count(SEARCH_NODE),
                              cl.count(SEARCH_SHARD))
                    t1 = time.perf_counter()
                    status, resp = cl.rest[via](
                        "POST", "/vecs/_search", tcp_knn_body(q, k))
                    walls.append(time.perf_counter() - t1)
                    launches = kf.launches.count - before[0]
                    partials = cl.count(SEARCH_NODE) - before[1]
                    fallback = cl.count(SEARCH_SHARD) - before[2]
                    tag = f"[tcp {label}] via {via} k={k} query {qi}"
                    if status != 200:
                        raise AssertionError(f"{tag}: {status} {resp}")
                    _f, err = knn_hits_check(kf, tag, resp, q, want[qi],
                                             data, dev)
                    st["worst_abs_err"] = max(st["worst_abs_err"], err)
                    if cuda and (fallback or not 1 <= partials <= 3
                                 or launches != partials):
                        raise AssertionError(
                            f"{tag}: {launches} K1 launches for {partials} "
                            f"node partials ({fallback} per-shard "
                            f"fallbacks)")
                    st["searches"] += 1
                    st["node_partials"] += partials
                    st["launches"] += launches
                    if solo is not None:
                        solo[(via, k, qi)] = [(h["_id"], h["_score"])
                                              for h in resp["hits"]["hits"]]
                st["search_ms"] = latency_summary(walls)
                return st

            # 1. every node
            t0 = time.perf_counter()
            solo: dict = {}
            builds0 = default_registry.stats["builds"]
            targets0 = len(cl.partial_targets)
            tiers0 = (kf.list_launches.count, kf.wide_launches.count)
            every = {}
            for via in cl.node_ids:
                for k in (10, 100):
                    every[f"{via} k={k}"] = knn(
                        via, "every node", queries[:TCP_QUERIES],
                        truth[k], k, solo)
            stage = out["every_node"] = {
                "searches": sum(r["searches"] for r in every.values()),
                "node_partials": sum(r["node_partials"]
                                     for r in every.values()),
                "launches": sum(r["launches"] for r in every.values()),
                "list_launches": kf.list_launches.count - tiers0[0],
                "wide_launches": kf.wide_launches.count - tiers0[1],
                "builds": default_registry.stats["builds"] - builds0,
                "serving_nodes": sorted(set(
                    cl.partial_targets[targets0:])),
                "worst_abs_err": max(r["worst_abs_err"]
                                     for r in every.values()),
                "search_ms": {key: r["search_ms"]
                              for key, r in every.items()}}
            if not 1 <= stage["builds"] <= len(stage["serving_nodes"]):
                raise AssertionError(f"[tcp every node] {stage['builds']} "
                                     f"bundle builds on "
                                     f"{stage['serving_nodes']}")
            if cuda and stage["list_launches"] + stage["wide_launches"] \
                    != stage["launches"]:
                raise AssertionError(f"[tcp every node] K1 tiers: {stage}")
            parts["every_node"] = time.perf_counter() - t0
            log(f"[tcp every node] {stage['searches']} kNN through n0, n1 "
                f"and n2 equal the brute force: {json.dumps(stage)}")

            # 2. concurrency: TCP_CLIENTS clients through n1
            t0 = time.perf_counter()
            clients = [RestClient(cl.http_ports["n1"])
                       for _ in range(TCP_CLIENTS)]
            gate = threading.Barrier(TCP_CLIENTS)
            got: dict = {}
            lat: list = []
            errors: list = []

            def client(c: int) -> None:
                try:
                    gate.wait()
                    for j in range(TCP_PER_CLIENT):
                        qi = (c * TCP_PER_CLIENT + j) % TCP_QUERIES
                        t1 = time.perf_counter()
                        status, resp = clients[c](
                            "POST", "/vecs/_search",
                            tcp_knn_body(queries[qi], 10))
                        lat.append(time.perf_counter() - t1)
                        if status != 200:
                            raise AssertionError(f"{status} {resp}")
                        got[(c, j)] = (qi, [(h["_id"], h["_score"])
                                            for h in resp["hits"]["hits"]])
                except BaseException as e:  # noqa: BLE001 - reported below
                    errors.append(e)

            batch0 = default_batcher.snapshot_stats()
            before = (kf.launches.count, cl.count(SEARCH_NODE))
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(TCP_CLIENTS)]
            t1 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.perf_counter() - t1
            for c in clients:
                c.close()
            if errors:
                raise AssertionError(f"[tcp concurrent] {errors[0]!r}")
            for (c, j), (qi, hits) in sorted(got.items()):
                concurrent_check("tcp concurrent via n1", c * TCP_PER_CLIENT
                                 + j, hits, solo[("n1", 10, qi)])
            batch1 = default_batcher.snapshot_stats()
            dispatches = batch1["dispatches"] - batch0["dispatches"]
            stage = out["concurrent"] = {
                "searches": len(got),
                "launches": kf.launches.count - before[0],
                "node_partials": cl.count(SEARCH_NODE) - before[1],
                "dispatches": dispatches,
                "mean_merged_batch": (
                    (batch1["merged_queries"] - batch0["merged_queries"])
                    / dispatches if dispatches else 0.0),
                "search_ms": latency_summary(lat, wall)}
            if cuda and not 1 <= stage["launches"] <= stage["node_partials"]:
                raise AssertionError(f"[tcp concurrent] {stage}")
            parts["concurrent"] = time.perf_counter() - t0
            log(f"[tcp concurrent] {TCP_CLIENTS} clients x {TCP_PER_CLIENT} "
                f"kNN through n1, each its solo hits bit for bit: "
                f"{json.dumps(stage)}")

            # 3. one _msearch of TCP_MSEARCH bare kNN through n2
            t0 = time.perf_counter()
            mq = queries[TCP_QUERIES:]
            msolo: dict = {}
            out["msearch_solo"] = knn("n2", "msearch solo", mq,
                                      truth[10][TCP_QUERIES:], 10, msolo)
            nd = [x for q in mq
                  for x in ({"index": "vecs"}, tcp_knn_body(q, 10))]
            before = (kf.launches.count, cl.count(MSEARCH_NODE),
                      cl.count(SEARCH_NODE))
            t1 = time.perf_counter()
            status, resp = cl.rest["n2"]("POST", "/_msearch", ndjson=nd)
            msearch_s = time.perf_counter() - t1
            if status != 200 or len(resp["responses"]) != len(mq):
                raise AssertionError(f"[tcp msearch] {status} "
                                     f"{str(resp)[:300]}")
            for qi, r in enumerate(resp["responses"]):
                if "error" in r:
                    raise AssertionError(f"[tcp msearch] query {qi}: {r}")
                concurrent_check("tcp msearch via n2", qi,
                                 [(h["_id"], h["_score"])
                                  for h in r["hits"]["hits"]],
                                 msolo[("n2", 10, qi)])
            stage = out["msearch"] = {
                "searches": len(mq), "ms": msearch_s * 1e3,
                "launches": kf.launches.count - before[0],
                "msearch_node": cl.count(MSEARCH_NODE) - before[1],
                "search_node": cl.count(SEARCH_NODE) - before[2]}
            if cuda and not 1 <= stage["launches"] <= stage["msearch_node"] \
                    <= 3:
                raise AssertionError(f"[tcp msearch] {stage}: more than one "
                                     f"K1 launch a data node")
            parts["msearch"] = time.perf_counter() - t0
            log(f"[tcp msearch] {len(mq)} bare kNN in one _msearch through "
                f"n2, each its solo hits bit for bit: {json.dumps(stage)}")

            # 4. the facade's own routes: no launch, no device memory
            t0 = time.perf_counter()
            if cuda:
                torch.cuda.synchronize()
            counts0 = _launch_counts()
            mem0 = torch.cuda.memory_allocated() if cuda else 0
            routes = {}
            for path in TCP_ROUTES:
                t1 = time.perf_counter()
                status, resp = _http_get(cl.rest["n0"], path)
                routes[path] = (time.perf_counter() - t1) * 1e3
                if status != 200:
                    raise AssertionError(f"[tcp routes] GET {path}: {status} "
                                         f"{str(resp)[:300]}")
            moved = {key: n - counts0[key]
                     for key, n in _launch_counts().items()
                     if n != counts0[key]}
            mem1 = torch.cuda.memory_allocated() if cuda else 0
            if moved or mem1 != mem0:
                raise AssertionError(f"[tcp routes] launched {moved}, "
                                     f"memory_allocated {mem0} -> {mem1}")
            out["routes_ms"] = routes
            parts["routes"] = time.perf_counter() - t0
            log(f"[tcp routes] {len(TCP_ROUTES)} facade routes answer 200 "
                f"through n0 with no launch and memory_allocated() "
                f"unchanged: {json.dumps(routes)}")

            # 5. leader kill
            t0 = time.perf_counter()
            leader = cl.leader()
            engines = {sh.engine.instance_id for sh
                       in cl.servers[leader].node.local_shards.values()}
            with default_registry._lock:
                held = [key for key in default_registry._bundles
                        if engines & set(key[3])]
                held_bytes = sum(_bundle_nbytes(default_registry._bundles[key])
                                 for key in held)
            ledger0 = sum(default_ledger.device_totals().values())
            cl.kill(leader)
            with default_registry._lock:
                stale = [key for key in default_registry._bundles
                         if engines & set(key[3])]
            fell = ledger0 - sum(default_ledger.device_totals().values())
            if stale or fell < held_bytes:
                raise AssertionError(
                    f"[tcp kill] {leader}'s bundles left: {stale}; the "
                    f"ledger fell {fell} bytes, its bundles held "
                    f"{held_bytes}")
            t1 = time.perf_counter()
            new_leader = cl.leader()
            election_s = time.perf_counter() - t1
            if new_leader == leader:
                raise AssertionError(f"[tcp kill] {leader} still leads")
            via = new_leader
            t1 = time.perf_counter()
            health = cl.health(
                via, lambda h: h["number_of_nodes"] == 2
                and h["active_primary_shards"] == 3
                and h["status"] in ("green", "yellow"),
                f"{leader} gone and every primary active")
            health_s = time.perf_counter() - t1
            status, resp = cl.rest[via]("POST", "/vecs/_count", {})
            if status != 200 or resp["count"] != n_docs:
                raise AssertionError(f"[tcp kill] _count through {via}: "
                                     f"{status} {resp}")
            # every acked doc counted above; TCP_MGET of them read back
            # by _mget (one get a doc on the facade), each source the one
            # written
            t1 = time.perf_counter()
            sample = sorted(rng.choice(n_docs, TCP_MGET, replace=False))
            status, resp = cl.rest[via]("POST", "/vecs/_mget", {
                "ids": [ids[i] for i in sample]})
            if status != 200:
                raise AssertionError(f"[tcp kill] _mget: {status} "
                                     f"{str(resp)[:300]}")
            for i, doc in zip(sample, resp["docs"]):
                if not doc.get("found") or \
                        doc["_source"]["v"] != data[i].tolist():
                    raise AssertionError(f"[tcp kill] acked doc {i} not "
                                         f"read back: {str(doc)[:300]}")
            readback_s = time.perf_counter() - t1
            after = knn(via, "after the kill", queries[:TCP_QUERIES],
                        truth[10], 10)
            stage = out["leader_kill"] = {
                "killed": leader, "new_leader": new_leader,
                "bundles_dropped": len(held), "bundle_bytes": held_bytes,
                "ledger_fell_bytes": fell, "election_s": election_s,
                "health_s": health_s, "status": health["status"],
                "readback_s": readback_s, **after}
            parts["leader_kill"] = time.perf_counter() - t0
            log(f"[tcp kill] {leader} killed, {new_leader} leads; every "
                f"acked doc read back through {via}, its kNN the brute "
                f"force's: {json.dumps(stage)}")
        finally:
            default_registry.put = put
            kf.launches.add = add
            t0 = time.perf_counter()
            cl.close()
            parts["close"] = time.perf_counter() - t0
    if on_loop:
        raise AssertionError(f"[tcp] on the transport loop: {on_loop[:5]}")
    out["launches"] = {key: out[key]["launches"] for key in
                       ("every_node", "concurrent", "msearch", "leader_kill")}
    out["launches"]["msearch_solo"] = out["msearch_solo"]["launches"]
    out["wall_s"] = time.perf_counter() - t_phase
    summary = {
        "wall_s": out["wall_s"], "parts_s": parts,
        "ingest_us_a_doc": out["ingest_us_a_doc"],
        "every_node_ms": {key: {q: v for q, v in r.items() if q != "qps"}
                          for key, r in
                          out["every_node"]["search_ms"].items()},
        "concurrent_ms": out["concurrent"]["search_ms"],
        "mean_merged_batch": out["concurrent"]["mean_merged_batch"],
        "msearch_ms": out["msearch"]["ms"],
        "leader_kill_ms": out["leader_kill"]["search_ms"],
        "election_s": out["leader_kill"]["election_s"],
        "health_s": out["leader_kill"]["health_s"],
        "launches": out["launches"],
        "builds": out["every_node"]["builds"]}
    log(f"tcp {json.dumps(summary)}")
    if out["wall_s"] > TCP_WALL_S:
        raise AssertionError(f"[tcp] the phase took {out['wall_s']:.1f} s, "
                             f"over its {TCP_WALL_S} s")
    return out


SOAK_SEED = 7
SOAK_CYCLES = 2
SOAK_OPS = 30                 # ops a cycle
SOAK_TOPOLOGY_CYCLE = 1       # the reshape: join, rebalance, disk ramp and
                              # evacuation, drain
SOAK_EXACT = ("vec", "hyb")   # the soak's exact kNN indices (K1)
SOAK_ANN = ("annvec",)        # its IVF-PQ index (K2)
SOAK_INDICES = ("logs", *SOAK_EXACT, *SOAK_ANN)
SOAK_WALL_S = 45


def _knn_body(body) -> bool:
    """Whether a search body's query is a kNN clause, or a hybrid query
    with one among its sub-queries (the soak's search_knn, search_ann,
    msearch and search_hybrid bodies)."""
    query = (body or {}).get("query")
    if not isinstance(query, dict):
        return False
    subs = (query.get("hybrid") or {}).get("queries") or []
    return "knn" in query or any(isinstance(q, dict) and "knn" in q
                                 for q in subs)


def soak_phase(kf, ads, dev, seed: int = SOAK_SEED) -> dict:
    """The chaos soak on the card (``--phases soak``; after tcp by default,
    on nodes of its own): testing/soak.run_soak on ``dev`` under
    testing/race_probe.probe_scope, its kNN searches counted by kind once
    each, where a node runs them."""
    from opensearch_tpu_torch.cluster import cluster_node as cn
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry
    from opensearch_tpu_torch.ops import adc_lut, knn_rescore
    from opensearch_tpu_torch.search import service as search_service
    from opensearch_tpu_torch.telemetry import roofline
    from opensearch_tpu_torch.telemetry.device_ledger import default_ledger
    from opensearch_tpu_torch.testing import race_probe, soak

    t_phase = time.perf_counter()
    # what the soak may make once per process comes first: the roofline's
    # peak probe (cuBLAS's workspace at its first product); and what
    # earlier phases' closed nodes left to the collector goes before the
    # reading, so the phase's memory is the soak's own
    roofline.ensure_peaks(dev)
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    kind_of = {**{i: "exact" for i in SOAK_EXACT},
               **{i: "ann" for i in SOAK_ANN}}
    # each kNN body a node executes, by the kind of its index, counted
    # where the kernels run: a node's search over its local shards (a
    # node partial, an msearch body, a pinned context's page) or a
    # per-shard query. A request that fails before it runs counts nothing;
    # a partial the coordinator retries shard by shard counts each run.
    searches = {"exact": 0, "ann": 0, "other": 0}
    saved = {"search": (search_service, search_service.search),
             "_shard_search_local": (cn.ClusterNode,
                                     cn.ClusterNode._shard_search_local)}

    def count(index, body):
        if _knn_body(body):
            searches[kind_of.get(index, "other")] += 1

    def node_search(shards, body, *a, **kw):
        count(shards[0].shard_id.index if shards else None, body)
        return saved["search"][1](shards, body, *a, **kw)

    def shard_search(node, payload):
        count(payload.get("index"), payload.get("body"))
        return saved["_shard_search_local"][1](node, payload)

    start_id = default_ledger.current_id()
    search_service.search = node_search
    cn.ClusterNode._shard_search_local = shard_search
    counters = (kf.launches, kf.list_launches, kf.wide_launches,
                kf.mma_launches, kf.large_launches, kf.large_mma_launches,
                kf.large_select_launches, kf.tile_launches, ads.launches,
                adc_lut.launches, knn_rescore.launches,
                knn_rescore.sq_launches)
    # the collector stays off through the soak and its close: what the
    # closed nodes leave must be freed by their close, not by a collection
    gc.disable()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # every count from 0, just before the soak drives the path
            for c in counters:
                c.reset()
            t0 = time.perf_counter()
            with race_probe.probe_scope() as probe:
                report = soak.run_soak(
                    seed, tmp, cycles=SOAK_CYCLES, ops_per_cycle=SOAK_OPS,
                    topology_cycle=SOAK_TOPOLOGY_CYCLE, device=str(dev))
            soak_s = time.perf_counter() - t0
            launches = {"knn_fused": kf.launches.count,
                        "knn_fused_list": kf.list_launches.count,
                        "knn_fused_wide": kf.wide_launches.count,
                        "adc_scan": ads.launches.count,
                        "adc_lut": adc_lut.launches.count,
                        "knn_rescore": knn_rescore.launches.count,
                        "knn_query_sq": knn_rescore.sq_launches.count}
        torch.cuda.synchronize()
        # read before any collection: the closed nodes' objects hold one
        # another in cycles, and their engines' close drops the device
        # segments those cycles would otherwise keep
        # (scripts/soak_memory_probe.py names what stays)
        mem_closed = torch.cuda.memory_allocated()
    finally:
        gc.enable()
        for name, (owner, fn) in saved.items():
            setattr(owner, name, fn)
    gc.collect()
    freed_by_gc = mem_closed - torch.cuda.memory_allocated()
    probe_report = probe.report()
    # run_soak closed its nodes: none of the soak's stacked bundles and
    # none of its device allocations may stay
    bundles = [r for r in default_registry.resident()
               if r["index"] in SOAK_INDICES]
    left = [a.row() for a in default_ledger.live_allocations()
            if a.alloc_id > start_id]
    out = {
        "seed": seed, "cycles": SOAK_CYCLES, "ops_per_cycle": SOAK_OPS,
        "topology_cycle": SOAK_TOPOLOGY_CYCLE,
        "ops_issued": report.ops_issued,
        "ops_completed": report.ops_completed,
        "ops_degraded": report.ops_degraded, "sheds": report.sheds,
        "faults_injected": report.faults_injected,
        "invariants_checked": report.invariants_checked,
        "topology": [m["event"] for m in report.topology],
        "digest": report.digest,
        "searches": searches, "launches": launches,
        "probe": {"findings": len(probe_report["findings"]),
                  "confirmed": probe_report["confirmed"],
                  "verdicts": sorted({f["verdict"] for f in
                                      probe_report["findings"]})},
        "memory_after_close_delta": mem_closed - mem0,
        "memory_allocated_delta": torch.cuda.memory_allocated() - mem0,
        "memory_freed_by_gc": freed_by_gc,
        "bundles_left": bundles, "allocations_left": left[:5],
        "soak_s": soak_s,
    }
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"soak {json.dumps(out)}")
    if report.ops_completed != report.ops_issued:
        raise AssertionError(f"[soak] {report.ops_completed} of "
                             f"{report.ops_issued} ops completed")
    if report.cycles_completed != SOAK_CYCLES:
        raise AssertionError(f"[soak] {report.cycles_completed} cycles")
    if not report.invariants_checked:
        raise AssertionError("[soak] no invariant was checked")
    for name, kind in (("knn_fused", "exact"), ("adc_scan", "ann")):
        if not 0 < launches[name] <= searches[kind]:
            raise AssertionError(
                f"[soak] {name}: {launches[name]} launches for "
                f"{searches[kind]} {kind} searches")
    if probe_report["confirmed"]:
        raise AssertionError(f"[soak] the race probe confirmed "
                             f"{probe_report['confirmed']}")
    if mem_closed != mem0:
        raise AssertionError(
            f"[soak] {mem_closed - mem0} bytes allocated after the nodes "
            f"closed, before any collection ({freed_by_gc} freed by one)")
    if bundles or left:
        raise AssertionError(f"[soak] left on the card: bundles {bundles}, "
                             f"allocations {left[:5]}")
    if out["wall_s"] > SOAK_WALL_S:
        raise AssertionError(f"[soak] the phase took {out['wall_s']:.1f} s, "
                             f"over its {SOAK_WALL_S} s")
    return out


# the linter's process: its CLI, then the modules it imported
_LINT_RUNNER = """\
import json
import sys

from opensearch_tpu_torch.lint import cli

rc = cli.main(sys.argv[1:])
print(json.dumps({"rc": rc, "refused": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "opensearch_tpu"))}))
"""
_REFUSED = ("jax", "jaxlib", "opensearch_tpu")


def lint_phase() -> dict:
    """The port's linter over its own package (``--phases lint``; first
    of the default run): ``python -m opensearch_tpu_torch.lint
    opensearch_tpu_torch --fix --dry-run --format json`` with the port's
    baseline, in a process of its own (its worker pool then spawns from a
    process that has not imported torch), which reports the modules it
    imported. Host work, first of all: a finding fails the run before the
    build."""
    root = pathlib.Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _LINT_RUNNER, str(root / "opensearch_tpu_torch"),
         "--fix", "--dry-run", "--format", "json"],
        capture_output=True, text=True, cwd=root, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[lint] the linter's process exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    report_text, _, tail = proc.stdout.rstrip().rpartition("\n")
    report, ran = json.loads(report_text), json.loads(tail)
    refused = sorted(set(ran["refused"]) | {
        m for m in sys.modules if m.split(".")[0] in _REFUSED})
    baseline = report["baseline"]
    out = {"files_checked": report["files_checked"],
           "findings": report["total_violations"],
           "regressions": len(report["regressions"]),
           "pending_fixes": len(report["pending_fixes"]),
           "rules": len(report["rules"]),
           "baseline": (str(pathlib.Path(baseline).relative_to(root))
                        if baseline else None),
           "refused_modules": refused, "rc": ran["rc"],
           "lint_s": report["elapsed_seconds"], "seconds": seconds}
    log(f"lint {json.dumps(out)}")
    if ran["rc"] != 0 or out["findings"] or out["regressions"] or \
            out["pending_fixes"]:
        raise AssertionError(
            f"[lint] rc {ran['rc']}: {report['violations'][:5]} "
            f"{report['pending_fixes'][:5]}")
    if out["baseline"] != "opensearch_tpu_torch/lint_baseline.json" or \
            out["rules"] != 19 or out["files_checked"] < 100:
        raise AssertionError(f"[lint] {out}")
    if refused:
        raise AssertionError(f"[lint] imported {refused}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="kernel,timing,main")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="limit the kernel and timing phases to these "
                         f"kernels (default: all of {','.join(KERNELS)})")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    # aggregations run with the main phases, or alone; so does the dsl
    want_aggs = bool(phases & {"main", "aggs"})
    want_dsl = bool(phases & {"main", "dsl"})
    aggs_launches: dict = {}
    chosen = set(args.kernels.split(","))
    if not chosen <= set(KERNELS):
        ap.error(f"unknown kernels {sorted(chosen - set(KERNELS))}")
    family_names = [name for name in FAMILY if name in chosen]
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false")
        return 2
    from opensearch_tpu_torch.ops import adc_scan as ads
    from opensearch_tpu_torch.ops import cuda_lib, ivfpq
    from opensearch_tpu_torch.ops import knn_blocks as kb
    from opensearch_tpu_torch.ops import knn_fused as kf
    from opensearch_tpu_torch.ops import knn_rescore as kr

    t_run = time.perf_counter()
    lint_s = None
    if phases & {"main", "lint"}:
        # first of all: a finding fails the run before the build
        log("phase lint starts at 0.0 s")
        t0 = time.perf_counter()
        lint_phase()
        lint_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    dev = torch.device("cuda", 0)
    # every phase's gates count one K1 launch a stacked search: the node
    # serves from this card alone, whatever else the host holds; the
    # devices phase sets its own serving devices
    from opensearch_tpu_torch import backend

    backend.set_serving_devices([dev])

    def phase_start(name: str) -> None:
        # on its own line before the phase: a run that fails names the
        # phase it died in before the traceback
        log(f"phase {name} starts at {time.perf_counter() - t_run:.1f} s")

    phase_start("build")
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(cuda_lib.build, KERNELS))
    log(f"built {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    # wall seconds of each phase, logged at the end
    phase_s = {"build": time.perf_counter() - t0}
    if lint_s is not None:
        phase_s["lint"] = lint_s

    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    designs = {"lists": "opensearch_tpu_torch/csrc/knn_pool.cuh: the list "
                        "scan (kernels knn_pool_scan_kernel, "
                        "knn_pool_merge_kernel), fp32 with r <= 32",
               "wide": "opensearch_tpu_torch/csrc/knn_wide.cuh: the list "
                       "scan's wide tier (kernels knn_wide_scan_kernel, "
                       "knn_wide_merge_kernel), fp32 with 32 < r <= 1024",
               "mma": "opensearch_tpu_torch/csrc/knn_wide_mma.cuh: the wide "
                      "tier's tensor-core scan (kernels "
                      "knn_wide_mma_scan_kernel, knn_wide_merge_kernel), "
                      "bf16 and int8 with r <= 1024",
               "large": "opensearch_tpu_torch/csrc/knn_large.cuh: the "
                        "large-r tier (kernel knn_large_scan_kernel, then "
                        "the multi-CTA select: knn_large_pass_kernel, "
                        "knn_large_collect_kernel, knn_large_tile_kernel "
                        "and knn_large_merge_kernel or knn_large_rank_kernel "
                        "and knn_large_place_kernel), fp32 with r > 1024",
               "large_mma": "opensearch_tpu_torch/csrc/knn_large_mma.cuh: "
                            "the large-r tier's tensor-core scan (kernel "
                            "knn_large_mma_scan_kernel, then the same "
                            "select), bf16 and int8 with r > 1024",
               "tile": "opensearch_tpu_torch/csrc/knn_tile.cuh: the tile "
                       "scan (knn_scan_kernel, knn_merge_kernel): no shape, "
                       "the yardstick timed beside the designs"}
    entry = {"name": "knn_fused", "route": "cuda",
             "source": "opensearch_tpu_torch/csrc/knn_fused.cu",
             "designs": designs,
             "replaces": "opensearch_tpu/ops/pallas_knn.py:785 "
                         "(pallas_knn_fused -> _knn_fused_kernel :675)",
             "launches": None, "parity": None, "max_abs_err": None,
             "ms": None, "plain_ms": None, "bound_ms": None,
             "bound_by": None, "library_ms": None}
    entry2 = {"name": "adc_scan", "route": "cuda",
              "source": "opensearch_tpu_torch/csrc/adc_scan.cu",
              "replaces": "opensearch_tpu/ops/pallas_adc.py:234 "
                          "(pallas_adc_topr -> _adc_scan_kernel :78)",
              "launches": None, "parity": None, "max_abs_err": None,
              "ms": None, "plain_ms": None, "bound_ms": None,
              "bound_by": None, "library_ms": None,
              "library_note": "none: no single PyTorch call computes an "
                              "ADC top-R over probed inverted lists"}
    family = {
        name: {"name": name, "route": "cuda",
               "source": f"opensearch_tpu_torch/csrc/{name}.cu",
               "replaces": replaces, "launches": None, "parity": None,
               "max_abs_err": None, "ms": None, "plain_ms": None,
               "bound_ms": None, "bound_by": None, "library_ms": None}
        for name, replaces in (
            ("knn_block", "opensearch_tpu/ops/pallas_knn.py:181 "
                          "(pallas_knn_topk -> _knn_block_kernel :53)"),
            ("knn_pb", "opensearch_tpu/ops/pallas_knn.py:325 "
                       "(pallas_knn_blocktopk -> _knn_pb_kernel :236)"),
            ("knn_sbmax", "opensearch_tpu/ops/pallas_knn.py:446 "
                          "(pallas_knn_sbmax_topk -> _knn_sbmax_kernel :383)"))
    }
    rescore_entries = {
        name: {"name": name, "route": "cuda",
               "source": "opensearch_tpu_torch/csrc/knn_rescore.cu",
               "replaces": "none (no Pallas kernel): the batched torch.einsum "
                           "of the exact fp32 rescore, "
                           "opensearch_tpu_torch/ops/knn_fused.py "
                           "_fused_rescore (XLA's gather and einsum in "
                           "opensearch_tpu/ops/pallas_knn.py knn_fused), and "
                           "the row sum of |q|^2",
               "launches": None, "parity": None, "max_abs_err": None,
               "ms": None, "plain_ms": None, "bound_ms": None,
               "bound_by": None, "library_ms": None}
        for name in ("knn_rescore", "knn_query_sq")}
    # the large-r tier's tensor-core scan (a K1 design, listed on its own
    # line too) and the IVF-PQ LUT kernel (no Pallas counterpart)
    large_mma_entry = {
        "name": "knn_large_mma", "route": "cuda",
        "source": "opensearch_tpu_torch/csrc/knn_large_mma.cuh (built in "
                  "knn_fused.cu)",
        "replaces": "opensearch_tpu/ops/pallas_knn.py:785 (pallas_knn_fused "
                    "-> _knn_fused_kernel :675) at bf16 and int8, r > 1024",
        "launches": None, "parity": None, "max_abs_err": None, "ms": None,
        "plain_ms": None, "bound_ms": None, "bound_by": None,
        "library_ms": None}
    # the large-r tier's multi-CTA select (a K1 stage behind both large-r
    # scans, listed on its own line; the earlier one-CTA select, its
    # yardstick, timed beside it)
    select_entry = {
        "name": "knn_large_select", "route": "cuda",
        "source": "opensearch_tpu_torch/csrc/knn_large.cuh (built in "
                  "knn_fused.cu): knn_large_pass_kernel, "
                  "knn_large_collect_kernel, knn_large_tile_kernel, "
                  "knn_large_merge_kernel, knn_large_rank_kernel, "
                  "knn_large_place_kernel",
        "replaces": "opensearch_tpu/ops/pallas_knn.py:785 (pallas_knn_fused "
                    "-> _knn_fused_kernel :675) at r > 1024: the running "
                    "top-R's selection, behind the large-r scans",
        "launches": None, "parity": None, "max_abs_err": None, "ms": None,
        "plain_ms": None, "bound_ms": None, "bound_by": None,
        "library_ms": None,
        "library_note": "torch.topk over the keys' f32 scores (decoded "
                        "before timing)"}
    lut_entry = {
        "name": "adc_lut", "route": "cuda",
        "source": "opensearch_tpu_torch/csrc/adc_lut.cu",
        "replaces": "none (no Pallas kernel): the batched torch.einsum LUT "
                    "build of opensearch_tpu_torch/ops/ivfpq.py "
                    "lut_for_probes (XLA's in opensearch_tpu/ops/ivfpq.py "
                    "lut_for_probes)",
        "launches": None, "parity": None, "max_abs_err": None, "ms": None,
        "plain_ms": None, "bound_ms": None, "bound_by": None,
        "library_ms": None,
        "library_note": "none: no single PyTorch call builds residual PQ "
                        "lookup tables; einsum_ms is the build it replaced"}
    rescore_entries["knn_rescore"]["library_note"] = (
        "none: no single PyTorch call gathers, dots, transforms and masks "
        "the candidates; einsum_ms is the rescore it replaced")
    family["knn_block"]["designs"] = {
        "lists": designs["lists"].replace("r <= 32", "k <= 32"),
        "wide": designs["wide"].replace("32 < r", "32 < k")}
    if "kernel" in phases:
        phase_start("kernel")
        t0 = time.perf_counter()
        if "knn_fused" in chosen:
            entry["max_abs_err"] = max(kernel_phase(kf, dev, args.seed),
                                       lists_kernel_phase(kf, dev, args.seed),
                                       mma_kernel_phase(kf, dev, args.seed))
            entry["parity"] = "ok"
        if chosen & {"knn_fused", "knn_block"}:
            wide_err = wide_kernel_phase(kf, kb, dev, args.seed,
                                         "knn_fused" in chosen,
                                         "knn_block" in chosen)
            if "knn_fused" in chosen:
                entry["max_abs_err"] = max(entry["max_abs_err"], wide_err)
        if "knn_fused" in chosen:
            large_kernels(kf, dev, args.seed, entry, large_mma_entry,
                          select_entry)
        if "adc_lut" in chosen:
            lut_check = lut_kernel_phase(dev, args.seed)
            lut_entry["max_abs_err"] = lut_check["max_abs_err"]
            lut_entry["parity"] = "bit-equal"
            lut_entry["probe_rows_differ"] = lut_check["probe_rows_differ"]
        if "knn_rescore" in chosen:
            differ = rescore_kernel_phase(kr, dev, args.seed)
            for e in rescore_entries.values():
                e["parity"] = ("bit-equal" if differ == 0 else
                               f"bit-equal but {differ} float slots within "
                               f"the f32 bound")
                e["max_abs_err"] = 0.0
        if "adc_scan" in chosen:
            entry2["max_abs_err"] = adc_kernel_phase(ads, ivfpq, dev,
                                                     args.seed)
            entry2["parity"] = "ok"
        errs = {}
        if "knn_block" in chosen:
            errs["knn_block"] = max(blocks_kernel_phase(kb, dev, args.seed),
                                    wide_err)
        if "knn_pb" in chosen:
            errs["knn_pb"] = pb_kernel_phase(kb, dev, args.seed)
        if "knn_sbmax" in chosen:
            errs["knn_sbmax"] = sbmax_kernel_phase(kb, dev, args.seed)
        for name, e in errs.items():
            family[name]["parity"] = "bit-equal"
            family[name]["max_abs_err"] = e
        phase_s["kernel"] = time.perf_counter() - t0
    if "timing" in phases:
        phase_start("timing")
        t0 = time.perf_counter()
        if "knn_fused" in chosen:
            t = timing_phase(kf, dev, args.seed)
            entry.update(t.pop(1))
            entry["shape"] = "n=1000000 d=128 fp32 l2 k=10 B=1"
            entry["b32"], entry["b128"] = t.pop(32), t.pop(128)
            entry["serving_shapes"] = t
        if "adc_scan" in chosen:
            t2 = adc_timing_phase(ads, ivfpq, dev, args.seed)
            glove, cell_c = t2["glove"], t2["cell_c"]
            stages = ("device_ms", "stage1_device_ms", "stage2_device_ms")
            entry2.update({key: glove[1][key] for key in (*fields, *stages)})
            entry2["shape"] = (f"glove-100: n={GLOVE_DOCS} d={ANN_DIM} "
                               f"cosine nlist=512 m={ANN_M} nprobe=8 "
                               f"l_pad={glove['l_pad']} fp32 R=64 B=1")
            entry2["build_s"] = glove["build_s"]
            entry2["b32"] = {key: glove[32][key] for key in (*fields, *stages)}
            entry2["serving_shapes"] = {
                f"cell_c n={ANN_MAIN_DOCS} l_pad={cell_c['l_pad']} B={b}": {
                    key: cell_c[b][key] for key in (*fields, *stages)}
                for b in (1, 8)}
        if "knn_fused" in chosen:
            large_records(kf, dev, args.seed, entry, large_mma_entry,
                          select_entry)
        if "adc_lut" in chosen:
            lt = lut_timing(dev, args.seed)
            lut_entry.update({key: lt["lut B=1"][key] for key in
                              (*fields, "einsum_ms", "device_ms",
                               "einsum_device_ms")})
            lut_entry["shape"] = ("glove-100 / cell C: nlist=512 d=100 m=20 "
                                  "ks=256 P=8 B=1")
            lut_entry["serving_shapes"] = lt
        if "knn_rescore" in chosen:
            rt = rescore_timing(kf, kr, dev, args.seed)
            rescore_entries["knn_rescore"].update(
                {key: rt["rescore B=1 R=40"][key] for key in
                 (*fields, "einsum_ms", "device_ms", "einsum_device_ms")})
            rescore_entries["knn_rescore"]["shape"] = (
                "cell A: n=200000 in 262144 slots d=128 l2 B=1 R=40 (bf16 "
                "k=10)")
            rescore_entries["knn_rescore"]["serving_shapes"] = {
                key: t for key, t in rt.items() if key.startswith("rescore")}
            rescore_entries["knn_query_sq"].update(
                {key: rt["query_sq B=1"][key] for key in
                 (*fields, "device_ms")})
            rescore_entries["knn_query_sq"]["shape"] = "B=1 d=128"
            rescore_entries["knn_query_sq"]["serving_shapes"] = {
                key: t for key, t in rt.items() if key.startswith("query_sq")}
        if chosen & {"knn_fused", "knn_block"}:
            wide = wide_timing_phase(kf, kb, dev, args.seed,
                                     "knn_fused" in chosen,
                                     "knn_block" in chosen)
            entry["wide_shapes"] = {key: t for key, t in wide.items()
                                    if key.startswith("K1")}
            family["knn_block"]["wide_shapes"] = {
                key: t for key, t in wide.items() if key.startswith("K3")}
        t3 = blocks_timing_phase(kb, dev, args.seed, family_names) \
            if family_names else {}
        for name, t3n in t3.items():
            e = family[name]
            e["launches"] = t3n["launches"]
            e["max_abs_err"] = max(e["max_abs_err"] or 0.0, t3n["stage1_err"])
            e.update(t3n[1])
            e["shape"] = "SIFT-1M: n=1000000 d=128 fp32 l2 k=10 B=1"
            if "stage2_launches" in t3n:
                # K4's and K5's stage 2 is a second kernel, counted apart
                e["stage2_launches"] = t3n["stage2_launches"]
            for b in (32, 128):
                if b in t3n:
                    e[f"b{b}"] = t3n[b]
        phase_s["timing"] = time.perf_counter() - t0
    if "large" in phases:
        phase_start("large")
        # the large-r tier's checks and records alone (the quick loop)
        t0 = time.perf_counter()
        large_kernels(kf, dev, args.seed, entry, large_mma_entry,
                      select_entry)
        large_records(kf, dev, args.seed, entry, large_mma_entry,
                      select_entry)
        phase_s["large"] = time.perf_counter() - t0
    if "main" in phases:
        # the roofline's rows are read after the main and lexical phases,
        # against the stacked and ANN launches made from here
        from opensearch_tpu_torch.telemetry import roofline

        roofline.default_recorder.reset()
        telemetry_since = telemetry_counters()
        phase_start("main")
        t0 = time.perf_counter()
        main = main_path_phase(kf, dev, args.seed)
        entry["launches"] = main["launches"]
        entry["list_launches"] = main["list_launches"]
        entry["ingest_s"] = main["ingest_s"]
        # the stacked step past r = 1024: each search's K1 launches,
        # counted from 0, all on the large-r tier
        entry["large_main_path"] = main["large"]
        entry["large_launches"] = sum(
            res["launches"]["knn_fused_large"] for res in main["large"].values())
        large_mma_entry["launches"] = sum(
            res["launches"].get("knn_fused_large_mma", 0)
            for res in main["large"].values())
        select_entry["launches"] = sum(
            res["launches"]["knn_large_select"]
            for res in main["large"].values())
        # filtered kNN on both routes: each run's launches counted from 0
        entry["filtered_main_path"] = main["filtered"]
        entry["stacked_batch"] = main["batched"]
        entry["msearch_main_path"] = main["msearch"]
        # kNN _search over HTTP (rest/http.py) on cell A: each run's K1
        # launches counted from 0
        entry["rest_main_path"] = main["rest"]
        rescore_entries["knn_query_sq"]["launches"] = \
            main["query_sq_launches"]
        rescore_entries["knn_rescore"]["launches"] = sum(
            res[path]["launches"]["knn_rescore"]
            for res in main["reduced"].values()
            for path in ("stacked", "per_shard"))
        entry["main_path_step_ms"] = main["step_ms"]
        entry["main_path_step_device"] = main["step_device"]
        # index A at k = 100: the stacked step and the per-shard route, each
        # path's K1 launches counted from 0 (all on the wide tier)
        entry["wide_main_path"] = main["wide"]
        entry["wide_launches"] = {
            path: main["wide"][path]["launches"]["knn_fused_wide"]
            for path in ("stacked", "per_shard")}
        entry["wide_launches"]["concurrent"] = \
            main["wide"]["concurrent"]["launches"]["knn_fused_wide"]
        # index A at bf16 and int8, k = 10 and 100: each path's K1 launches
        # counted from 0 (all on the tensor-core tier)
        entry["reduced_main_path"] = main["reduced"]
        entry["mma_launches"] = {
            key: {"stacked": res["stacked"]["launches"]["knn_fused_mma"],
                  "per_shard": res["per_shard"]["launches"]["knn_fused_mma"],
                  "gated": res["concurrent"]["gated"]["launches"][
                      "knn_fused_mma"]}
            for key, res in main["reduced"].items()}
        ann = ann_main_phase(ads, ivfpq, kf, dev, args.seed)
        entry2["launches"] = ann["launches"]
        # kNN + aggs on index C: one K2 and one K1 launch a search
        entry2["aggs_launches"] = ann["aggs"]["launches"]["adc_scan"]
        aggs_launches["index C knn"] = ann["aggs"]["launches"]["knn_fused"]
        lut_entry["launches"] = ann["lut_launches"]
        entry2["ann_batch"] = ann["batch"]
        entry2["main_path"] = {key: ann[key] for key in
                               ("searches", "recall", "p50_ms", "p99_ms",
                                "qps", "device_ms", "idle_share")
                               if key in ann}
        # K1 and K2 launches of the 16 searches over an IVF-PQ segment and
        # an exact one (the per-shard route's exact branch)
        entry["launches_two_segment"] = ann["mixed"]["k1_launches"]
        entry2["launches_two_segment"] = ann["mixed"]["k2_launches"]
        # the per-shard route: index A at k = 256 (streaming) and under 8
        # concurrent threads (K1 through the batcher), index C concurrent
        entry["per_shard_route"] = main["per_shard"]
        entry2["concurrent"] = ann["concurrent"]
        entry["filtered_ann_index"] = ann["filtered"]
        # search contexts, aliases and admission: K1's launches of each gate
        entry["contexts_main_path"] = main["contexts"]
        # ingest, templates, wildcards and the stats surface: each
        # expression's K1 launches, counted from 0
        entry["ops_main_path"] = main["ops"]
        entry["ops_launches"] = {
            key: res["launches"]["knn_fused"]
            for key, res in main["ops"]["knn"].items()}
        # batching on the stacked step, index management and document
        # reads: each check's K1 launches, counted from 0
        entry["admin_main_path"] = main["admin"]
        entry["admin_launches"] = admin_launches(main["admin"])
        # snapshots, the remote store, the reindex family and rank
        # evaluation: each check's K1 launches, counted from 0; index C's
        # _rank_eval: its K2 launches
        entry["backup_main_path"] = main["backup"]
        entry["backup_launches"] = backup_launches(main["backup"])
        entry2["rank_eval_launches"] = ann["rank_eval"]["launches"]
        phase_s["main"] = time.perf_counter() - t0
        phase_s["contexts"] = main["contexts"]["wall_s"]
        phase_s["ops"] = main["ops"]["wall_s"]
        phase_s["admin"] = main["admin"]["wall_s"]
        phase_s["backup"] = main["backup"]["wall_s"]
    elif "filtered" in phases:
        phase_start("filtered")
        t0 = time.perf_counter()
        fp = filtered_phase(kf, dev, args.seed)
        entry["filtered_main_path"] = fp["filtered"]
        entry["stacked_batch"] = fp["batched"]
        entry["msearch_main_path"] = fp["msearch"]
        entry["large_main_path"] = fp["large"]
        large_mma_entry["launches"] = sum(
            res["launches"].get("knn_fused_large_mma", 0)
            for res in fp["large"].values())
        select_entry["launches"] = sum(
            res["launches"]["knn_large_select"]
            for res in fp["large"].values())
        phase_s["filtered"] = time.perf_counter() - t0
    elif "rest" in phases:
        phase_start("rest")
        t0 = time.perf_counter()
        entry["rest_main_path"] = rest_phase(kf, dev, args.seed)
        phase_s["rest"] = time.perf_counter() - t0
    elif "ops" in phases:
        phase_start("ops")
        t0 = time.perf_counter()
        ops = ops_phase(kf, dev, args.seed)
        entry["ops_main_path"] = ops
        entry["ops_launches"] = {key: res["launches"]["knn_fused"]
                                 for key, res in ops["knn"].items()}
        entry["launches"] = sum(entry["ops_launches"].values())
        phase_s["ops"] = ops["wall_s"]
        phase_s["ops_node"] = time.perf_counter() - t0 - ops["wall_s"]
    elif "admin" in phases:
        phase_start("admin")
        t0 = time.perf_counter()
        adm = admin_phase(kf, dev, args.seed)
        entry["admin_main_path"] = adm
        entry["admin_launches"] = admin_launches(adm)
        entry["launches"] = sum(entry["admin_launches"].values())
        phase_s["admin"] = adm["wall_s"]
        phase_s["admin_node"] = time.perf_counter() - t0 - adm["wall_s"]
    elif "backup" in phases:
        phase_start("backup")
        t0 = time.perf_counter()
        bk = backup_phase(kf, dev, args.seed)
        entry["backup_main_path"] = bk
        entry["backup_launches"] = backup_launches(bk)
        entry["launches"] = sum(entry["backup_launches"].values())
        phase_s["backup"] = bk["wall_s"]
        phase_s["backup_node"] = time.perf_counter() - t0 - bk["wall_s"]
    elif "contexts" in phases:
        phase_start("contexts")
        t0 = time.perf_counter()
        ctx = contexts_phase(kf, dev, args.seed)
        entry["contexts_main_path"] = ctx
        entry["launches"] = sum(
            res["launches"]["knn_fused"] for res in ctx.values()
            if isinstance(res, dict) and "launches" in res)
        phase_s["contexts"] = ctx["wall_s"]
        phase_s["contexts_build"] = time.perf_counter() - t0 - ctx["wall_s"]
    if phases & {"main", "lexical"}:
        # the lexical query phase on index L: its kNN types' K1 launches,
        # each type's counted from 0
        phase_start("lexical")
        t0 = time.perf_counter()
        lexical = lexical_main_phase(kf, dev, args.seed, aggs=want_aggs,
                                     dsl=want_dsl)
        entry["lexical_main_path"] = lexical
        entry["lexical_launches"] = {
            qtype: lexical["types"][qtype]["launches"]["knn_fused"]
            for qtype in ("bool_knn", "knn_match_filter",
                          "knn_prefix_filter")}
        for qtype in ("knn_match_filter", "knn_prefix_filter"):
            entry["lexical_launches"][f"{qtype} per_shard"] = \
                lexical["knn"][f"{qtype} per_shard"]["launches"]["knn_fused"]
        if entry["launches"] is None:
            entry["launches"] = sum(entry["lexical_launches"].values())
        phase_s["lexical"] = time.perf_counter() - t0
        if want_aggs:
            aggs = lexical.pop("aggs")
            phase_s["aggs"] = aggs["wall_s"]
            phase_s["lexical"] -= aggs["wall_s"]
        if want_dsl:
            dsl = lexical.pop("dsl")
            phase_s["dsl"] = dsl["wall_s"]
            phase_s["lexical"] -= dsl["wall_s"]
    else:
        # each alone builds its own index L
        if "aggs" in phases:
            phase_start("aggs")
            aggs = aggs_phase(kf, dev, args.seed)
            phase_s["aggs"] = aggs["wall_s"]
        if "dsl" in phases:
            phase_start("dsl")
            dsl = dsl_phase(kf, dev, args.seed)
            phase_s["dsl"] = dsl["wall_s"]
    if want_aggs:
        # each scope's K1 launches on index L, counted from 0
        aggs_launches.update({scope: res["launches"]["knn_fused"]
                              for scope, res in aggs["scopes"].items()
                              if scope in AGGS_KNN_SCOPES})
        entry["aggs_launches"] = aggs_launches
        entry["aggs_main_path"] = aggs
        if entry["launches"] is None:
            entry["launches"] = sum(aggs_launches.values())
    if want_dsl:
        # each kNN-bearing dsl type's K1 launches, counted from 0
        entry["dsl_launches"] = {kind: n for kind, n in
                                 dsl["launches"].items() if n}
        entry["dsl_main_path"] = dsl
        if entry["launches"] is None:
            entry["launches"] = sum(entry["dsl_launches"].values())
    if "main" in phases:
        phase_start("telemetry")
        t0 = time.perf_counter()
        telemetry = telemetry_phase(dev, telemetry_since)
        log(f"telemetry record: {json.dumps(telemetry)}")
        phase_s["telemetry"] = time.perf_counter() - t0
    if phases & {"main", "hybrid"}:
        phase_start("hybrid")
        t0 = time.perf_counter()
        hybrid = hybrid_main_phase(dev, args.seed)
        log(f"hybrid program record: {json.dumps(hybrid)}")
        phase_s["hybrid"] = time.perf_counter() - t0
    if phases & {"main", "mesh"}:
        phase_start("mesh")
        t0 = time.perf_counter()
        mesh = mesh_phase(kf, dev, args.seed)
        # the dry run's stacked search: K1's launches, counted from 0
        entry["mesh_dryrun_launches"] = mesh["dryrun_k1_launches"]
        if entry["launches"] is None:
            entry["launches"] = mesh["dryrun_k1_launches"]
        log(f"mesh record: {json.dumps(mesh)}")
        phase_s["mesh"] = time.perf_counter() - t0
    if phases & {"main", "devices"}:
        # after the mesh, on a TorchNode of its own: the 4-shard index over
        # one slot, four slots on one card and, where there are several,
        # every card
        phase_start("devices")
        t0 = time.perf_counter()
        devices = devices_phase(kf, dev, args.seed)
        # K1's launches of each form's traffic, counted from 0 a search
        entry["devices_launches"] = {
            form: res["launches"] for form, res in devices["forms"].items()}
        entry["devices_main_path"] = devices
        if entry["launches"] is None:
            entry["launches"] = sum(
                sum(res["launches"].values())
                for res in devices["forms"].values())
        log(f"devices record ({smi}): {json.dumps(devices)}")
        phase_s["devices"] = time.perf_counter() - t0
    if phases & {"main", "cluster"}:
        # last but the tcp phase, on three sim nodes and two TorchNodes of
        # its own:
        # the ClusterNodes write the process-wide batcher's, recorder's
        # and settings consumers' state, so nothing earlier reads it
        phase_start("cluster")
        t0 = time.perf_counter()
        cluster = cluster_phase(kf, dev, args.seed)
        # K1's launches of the phase: every node partial of its 144 kNN
        # and the cross-cluster remote's 8
        entry["cluster_launches"] = cluster["launches"]
        entry["cluster_main_path"] = cluster
        if entry["launches"] is None:
            entry["launches"] = cluster["launches"]
        phase_s["cluster"] = time.perf_counter() - t0
    if phases & {"main", "tcp"}:
        # after the cluster phase, on three ClusterServers of its own
        phase_start("tcp")
        t0 = time.perf_counter()
        tcp = tcp_phase(kf, dev, args.seed)
        # K1's launches of each stage: a launch a node partial, fewer under
        # the concurrent clients' merges, one a data node for the _msearch
        entry["tcp_launches"] = tcp["launches"]
        entry["tcp_main_path"] = tcp
        if entry["launches"] is None:
            entry["launches"] = sum(tcp["launches"].values())
        phase_s["tcp"] = time.perf_counter() - t0
    if phases & {"main", "soak"}:
        # last of all, on sim nodes of its own: the chaos soak, K1 serving
        # its exact kNN and K2 its IVF-PQ searches
        phase_start("soak")
        t0 = time.perf_counter()
        sk = soak_phase(kf, ads, dev, SOAK_SEED)
        entry["soak_launches"] = sk["launches"]["knn_fused"]
        entry2["soak_launches"] = sk["launches"]["adc_scan"]
        entry["soak_main_path"] = entry2["soak_main_path"] = {
            key: sk[key] for key in ("seed", "searches", "digest",
                                     "wall_s")}
        if entry["launches"] is None:
            entry["launches"] = sk["launches"]["knn_fused"]
        if entry2["launches"] is None:
            entry2["launches"] = sk["launches"]["adc_scan"]
        phase_s["soak"] = time.perf_counter() - t0
    log(f"phase wall seconds: {json.dumps(phase_s)}")
    print(json.dumps({"kernels": [entry, large_mma_entry, select_entry,
                                  entry2, lut_entry,
                                  *family.values(),
                                  *rescore_entries.values()]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
