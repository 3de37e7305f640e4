#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py            # the full run: 1M x 128, 10,000 queries
    python3 chip_smoke.py --n 100000 --queries 2000    # a shorter ANNS run

Phases:
  1. device   — the card's name and power limit (nvidia-smi).
  2. build    — compile the CUDA kernels from `src/repro_torch/csrc` (one
                nvcc per source, in parallel); print the seconds, each
                library's registers and spills; none of the 80 instances
                of the fused search kernels may spill (the ptxas report),
                and the main path's instance prints its registers; from
                `cuobjdump -sass`, the HMMA (tensor-core) instructions of
                every bf16 flash-attention kernel, of the four instances
                of `rabitq_distance` (#6) and of `pairwise_l2` (#7): each
                must have some and no spill stores.
  3. selfcheck — each kernel against its plain PyTorch version on a small
                synthetic index, every template variant, exact arithmetic
                (`fused_hop` hop by hop over whole walks; `topk` on ties,
                all-+inf tails and widths that are not a multiple of 32;
                `rabitq_gather_distance` at 64-, 33- and 2,304-byte rows
                against its plain version and `rabitq_search_step`);
                the flash-attention kernels #10, #11 and the backward #12
                on a grid of small shapes: float32 and bf16, causal and
                bidirectional, window 64, q_offset > 0 with Sq < Skv, rows
                that see no key, GQA groups 1, 2 and 9, Dh 32/64/80/128,
                ragged Sq and Skv at the tiles' edges (63, 65, 127, 129,
                255: 64 keys, 64 rows or 128 at Dh 128).
  4. main path — bigann-shaped synthetic data; `JasperIndex.build` (Vamana
                construction + RaBitQ 4-bit codes); search with the
                megakernel + exact rerank, with the unfused loop over the
                `rabitq_search_step` kernel, and with the plain path; recall@10
                against a brute-force ground truth. Each path's kernel
                launch counters are zeroed just before its search and read
                just after; each path must launch exactly its own kernels.
  5. kernels vs plain at the main path's shapes: exact-arithmetic mode
                (integer-valued operands: bit-equal ids, dists, hops and
                telemetry) and realistic mode (id agreement >= 0.99, hops
                equal on >= 99% of queries, dists rtol 1e-4); times of each
                kernel, its plain version, its bound and, where one PyTorch
                call computes the same function, that call's time;
                `fused_search` and `fused_hop` also as the median, min and
                max of 10 launches (at each sampled hop for `fused_hop`);
                `fused_hop`, `rabitq_search_step` and `topk` also replayed
                from a CUDA graph (`ms_graph`: the kernel without the
                wrapper's host path, which is the longer of the two); the main
                path's instance's registers and resident queries (or
                blocks) per SM (the CUDA occupancy API).
  6. churn round ("built for change") on the same index: delete 1% of the
                rows; search on the megakernel, hop (`fused_hop`) and
                merge-kernel (`rabitq_search_step` + `topk`) lanes with
                tombstones traversed and excluded; consolidate; insert 2%
                new rows (freed slots first, then past the capacity, which
                auto-grows to twice by copy-extension); search again. Checks
                zero tombstoned ids, recall@10, exact per-lane launch counts,
                hop lane == megakernel lane and merge-kernel lane ==
                topk-merge lane bit for bit, slot reuse, the resident prefix
                of every buffer byte-identical across the grow, and that the
                reused rows find themselves.
  7. exact lanes and full scans — runs between phases 5 and 6, on phase 4's
                index before the churn round changes it. Exact-vector search
                (10,000 queries, k=10, beam 64) on five lanes: megakernel,
                hop, unfused with the chunked scorer (`gather_l2` per hop),
                unfused with the tiled scorer (`gather_l2_tiled` per hop) and
                plain; checks recall@10 >= 0.85 and exact launch counts on
                each, tiled == chunked == plain and hop == megakernel bit for
                bit (the bigann stand-in is integer-valued, so f32 is exact),
                and prints whether the exact megakernel equals the unfused
                lane, and its QPS and recall beside the quantized one's;
                the exact-mode `fused_search` kernel time goes into its
                record (`exact_ms`, and the median, min and max of 10).
                Exact full scan (`pairwise_l2`, all queries x all rows in
                chunks of 131,072, the last ragged, a running top-10): every
                chunk bit-equal to `pairwise_l2_plain`, the top-10 distances
                bit-equal to `brute_force`'s and the ids equal below the cut;
                one exact scan profiled (the kernel against the top-k merge).
                Estimated full scan (`rabitq_distance` on the 4-bit codes, a
                running top-64, exact rerank through `gather_l2`): recall@10
                code-only and after the rerank (>= 0.85).
                `rabitq_gather_distance` on the megakernel's final frontier:
                bit-equal to its plain version (integer operands) and to
                `rabitq_search_step` with every row live; timed launched
                and replayed from a CUDA graph (the mean, median, min and
                max of 20), its registers, blocks per SM and spills (none
                allowed at the main path's bits). `rabitq_distance`
                chunks bit-equal to the plain version and to
                `rabitq_gather_distance` at the frontier ids (integer
                operands), and within rtol 1e-4 plus float32 ulps of the
                terms on the real codes. Times of the four kernels beside
                their plain versions, bounds and library calls
                (`gather_l2_tiled` beside `gather_l2` on the same inputs);
                `rabitq_distance` and `pairwise_l2` also as the median, min
                and max of 5, their bounds at the bf16 tensor rate (their
                products are exact on the tensor cores; #7's counts the
                products of parts its votes take on the operands) with the
                float32 one beside it, and their registers and blocks per
                SM; `pairwise_l2` timed and checked on three operand kinds:
                the scan's integer operands (bit-equal), noisy queries
                against the integer rows and real x real (within rtol 1e-4
                plus float32 ulps of |q|^2 + |x|^2); one estimated scan
                profiled (device time by kernel: the kernel against the
                top-k merge).
  8. RAG serving — runs last, after phase 6's index is freed: starcoder2-7b
                at full width (10.12 B parameters, bf16, random weights
                from seed 0, `use_flash_kernel=True`). #10 and #11 against
                their plain versions at the model's attention shape (B=1,
                S=4,096, 36 heads on 4 KV heads, Dh 128, causal; float32
                and bf16) and timed at B=4 beside the plain version, SDPA
                and the bound. Then the serving path through its entry
                points: `RagPipeline.ingest` of 2,048 synthetic 128-token
                documents (24 batches of 64, the first builds the index,
                then two streamed inserts of 256), `evict` of 128,
                `retrieve` for 256 self-queries (32 of them evicted) and
                `generate` of 4 prompts of 4,096 tokens, each opening with
                its top-1 retrieved document, + 32 greedy tokens. Checks:
                32 launches of #10 per forward and no blockwise attention,
                kernel path vs blockwise cosine >= 0.999 on 64 documents,
                no evicted or tombstoned result, self-hit >= 0.9, recall@4
                >= 0.85 against brute force, the prompts unchanged in the
                output; the same index searched through the megakernel
                lane (quantized, D = 4,608) for its recall and launches.
  9. training — after 8: minicpm-2b (40 layers, d_model 2,304, 36
                heads, Dh 64, vocab 122,753, tied embeddings), float32
                master weights, bf16 compute, remat "full". (a) #10/#11
                and #12 against their plain versions at minicpm's attention
                shape (B=2, S=4,096, 36/36, Dh 64), #12 at starcoder2-7b's
                (36/4, Dh 128), float32 and bf16, and #10/#11/#12 at
                stablelm-3b's (B=1, 32/32, Dh 80) in bf16; (b) #11 and #12
                timed at the training microbatch
                (B=2, bf16) beside its plain version, SDPA's backward and
                the bound; (c) 2 layers at full width, B=1: gradients of
                `loss_fn` through the kernels against the blockwise path
                (cosine >= 0.999, loss within 1e-3), a bit-equal checkpoint
                round trip, a resume (2 steps, save, restore, 1 step)
                within 1e-4 of 3 straight steps; (d) the full model through
                `launch/train.py`'s `run`: 4 WSD steps of 4 x 4,096 tokens
                (grad_accum 2) — finite losses and grad norms, the first
                loss within [ln V - 0.5, ln V + 3], exactly 160 #11 and 80
                #12 launches a step, no #10 and no blockwise attention,
                memory under 80 GB — then 3 steps at lr 1e-3 on one fixed
                batch (the loss must fall), one step under the profiler,
                and the loss head and AdamW timed apart.
 10. ANNS serving — runs after phase 6, on its index, before phase 8
                frees it. (a) The main spec's plan (k 10, beam 64, 4-bit,
                megakernel, device rerank, the 10,000 queries) is a
                captured CUDA graph: the first search misses and captures
                once, three more hit; every replay, and a telemetry
                spec's, bit-equal to an eager `core_search`; each counts
                `fused_search` 1 + `gather_l2` 1; host-clock time of an
                eager and a replayed search (mean of 10) and the device
                busy share of one profiled replay beside phase 4's.
                (b) Delete 1,000, insert 1,000, consolidate under the
                main and the exact megakernel specs' plans: replays
                bit-equal to eager, no tombstoned id, no recapture; then a
                grow: one recapture a spec. (c) Submit 4 x 2,500 queries,
                insert 1,000, drain: equal to the searches at the submit
                generation and stamped with it. (d) `AnnsService.serve`
                over lanes default (the main spec) + exact at the bucket
                ladder (1, 8, 32, 128), every (lane, rung) warmed first:
                saturation (Poisson 1e6 QPS, 20,000 arrivals, not real
                time) at buckets (1,) and at the ladder, then real-time
                Poisson and bursty (x8) replays at half the ladder's
                saturation QPS, lanes 0.7 / 0.3, 100 ms SLO: QPS, p50,
                p99, SLO hit rate, flush reasons, batch occupancy; no
                trace or miss after the warm-up, completed + rejected =
                arrivals, the flush reasons add up to the batches, no
                tombstoned id, 256 coalesced results bit-equal to the
                same queries alone in the same bucket. (e) `run` over 20
                ticks (delete 0.1 % of the live rows, insert 0.1 %, search
                1,000): the generation stamps increase, an auto-consolidate
                fires, no plan traces, recall@10 >= 0.85 after; two
                tenants of 10,000 rows see only their own rows. (f) The
                `metrics_snapshot()` keys and the span summary. Prints one
                `{"serving": ...}` JSON line.
 11. the host rows tier — after 10, on its index (1.01M live rows,
                capacity 4M). (a) `evict_rows_to_host`: the rows go to
                pinned host memory; `memory_stats` shows no device rows,
                capacity x (D + 1) x 4 B of host rows and a device
                compression of (rows + codes) / codes;
                `torch.cuda.memory_allocated()` falls by >= 0.95 x the rows.
                (b) 10,000-query host-tier searches (rerank_source="host":
                the traversal plan, the frontier ids to the host, the
                store's gather, the captured rerank plan) on the megakernel,
                hop, merge-kernel, telemetry and filtered lanes, bit-equal
                to the same searches on the device tier (restore, search,
                evict) in ids, dists, hops and telemetry; launches a search
                as eager: megakernel #1 1 + #2 1. (c) One host-tier search
                split (synchronised host clock, mean of 10): traversal
                replay, ids to the host, host gather, host-to-device copy,
                rerank replay, beside phase 10's device-tier replay.
                (d) Delete 1,000, insert 1,000 (staged), consolidate: no
                tombstoned id, no recapture of either stage, host == device
                bit for bit after; the staged insert's seconds beside phase
                10's device-tier insert. (e) `AnnsService.serve` on the host
                tier, saturation at the ladder (20,000 arrivals): no trace
                or miss after the warm-up, completed + rejected = arrivals,
                no tombstoned id, `storage.*` in the snapshot and one
                `storage.fetch_latency_us` entry a batch; QPS, p50, p99.
                (f) Restore. Prints one `{"host_tier": ...}` JSON line.
 12. the PQ baseline — after 11, once phase 4's index is freed:
                `JasperIndex(quantization="pq")` (16 subspaces x 256
                centroids, 8 iterations) over the first 100,000 rows of
                phase 4's data — a second 1M graph for a deprecated baseline
                costs more run time than it tells — with phase 4's build
                parameters; `search_pq` with rerank on 2,000 queries at
                beams 64 and 256 (printed) and 512: recall@10 >= 0.85 at 512
                against `brute_force`, no kernel
                launched (merge="kernel": `topk` only, same ids), no
                tombstoned id after a 1 % delete; Fig 12's comparison at
                2,000 x 64 candidates: `pq_distance` against #2 `gather_l2`
                and #5 `rabitq_gather_distance` (CUDA events).

 13. the row-sharded index — after 12, before 8: `ShardedJasperIndex` on
                a mesh of 4 shards on the card, phase 4's data (1M x 128,
                4 x 262,144 rows, R 64, 4-bit). (a) Build: seconds, live
                rows a shard. (b) The main spec through its captured plan
                (one CUDA graph for the four shard searches and the
                merge): the first search captures once; the replays are
                bit-equal to eager and to the merge of the four
                `shard_core(s)` searches, each launching #1 4 and #2 4
                times; telemetry = the sum of the shards' counters;
                recall@10 >= 0.85 and >= phase 4's - 0.02; eager and
                replay host-clock times (mean of 10). (c) The hop lane ==
                the megakernel lane and merge-kernel == topk-merge, bit for
                bit, with the launches a shard (#4 / #9 = each shard's
                iterations, #3 = iterations + 1 a shard, #2 4). (d) Delete
                1 % of all rows from shard 0, consolidate, insert 2 %
                (shard 0 reuses its slots), rebalance (tolerance 0.01):
                no tombstoned id, no recapture, replays == eager, moved
                rows at their translated ids, recall >= 0.85; then (after
                (e)) a grow: one recapture, the same results. (e) Save;
                load at 4 shards (bit-equal searches) and at 2 (a reshard,
                relink "auto"): translated ids at their rows, the exact
                top-10 kept, no dead id; recall at beam 64 and 128
                printed. (f) Evict: device memory falls >= 0.95 x the rows,
                host tier == device tier bit for bit, #1 4 + #2 4. (g)
                `AnnsService.run`, 10 ticks of deletes from shard 0: the
                rebalance trigger fires, `shards.*` gauges, recall >= 0.85.
                (h) (e)'s checkpoint loaded onto a mesh of four positions
                on the one card (`make_mesh((4,), ("data",),
                device=["cuda:0"] * 4)`: each shard in its own buffers,
                one captured graph a position, the merge gathered home):
                the megakernel lane eager and replayed, and the hop lane,
                bit-equal to the stacked layout's, #1 and #2 launched once
                a position a search, the replay's time beside (b)'s; then
                the checkpoint on a (4, 2) ("data", "model") mesh of eight
                positions (two replicas a shard, the query axis splitting
                the batch): an insert timed on four and on eight positions,
                every replica equal to the shard after it, the searches
                bit-equal. (i)
                With four cards or more, the same four shards on cuda:0..3:
                the same checks, recall@10 equal to the stacked layout's,
                the replay's time and the bytes gathered home a search;
                with fewer, one line saying that (i) did not run and why.
                Prints one `{"sharded": ...}` JSON line.
 14. the other LM families — last, after 9: random bf16 weights from seed
                0 at the published widths and depths, `use_flash_kernel`,
                each model freed before the next. (a) #10 against its plain
                version (B=1, bf16) at the three attention shapes this
                phase adds — hubert-xlarge's (1,024, 16/16, Dh 80,
                bidirectional), zamba2-2.7b's (4,096, 32/32, Dh 80, window
                4,096), olmoe-1b-7b's (1,024, 16/16, Dh 128, causal) — and
                timed at B=4 beside the plain version, SDPA and the bound.
                (b) olmoe-1b-7b, zamba2-2.7b, xlstm-125m: the kernel path
                against the blockwise path on 2 x 512 tokens (the cosine of
                each sequence's logits >= 0.999; not xlstm, which has no
                attention); a forward of 4 x the prompt (1,024; zamba2
                4,096 = its window) launching #10 16 / 9 / 0 times and no
                blockwise attention; `generate` of 4 prompts + 32 greedy
                tokens (the same launches, the prompts unchanged, prefill
                seconds, decode ms a step, tokens/s; zamba2's ring cache
                wraps); olmoe's routes dropped at capacity factor 1.25 in
                one forward, and layer 0's routing on the card against the
                CPU's (positions and keep mask bit-equal); the prefill and
                three decode steps profiled; each decode step's logits
                against one forward over prompt + generated (olmoe at
                capacity factor 8), in bf16 (printed, with the MoE routes
                whose experts differ between the two paths) and in float32
                (the same draws: cosine >= 0.999). (c) hubert-xlarge: the
                kernel path against blockwise, a forward of 4 x 1,024
                frames (48 launches of #10), bidirectional (the last frame
                moves position 0's hidden state), profiled. (d) #10 at the
                shapes a rank of the 16 x 16 prefill_32k cells gives it
                under the serving plan (`models/tensor_parallel.py`;
                TP_PREFILL_FLASH): the heads path's stablelm-1.6b (2,
                32,768, 2/2, 64) causal and hubert-xlarge (2, 32,768, 1/1,
                80) bidirectional, and the context-parallel fallback's
                2,048 queries against 32,768 gathered keys at q_offset
                30,720 and 0, minicpm-2b's 36/36 heads at Dh 64 and
                chameleon-34b's 64/8 at Dh 128; the MoE families':
                olmoe-1b-7b's heads (2, 32,768, 1/1, 128) and
                granite-moe-1b-a400m's fallback, 2,048 queries of 16/8
                heads at Dh 64 at q_offset 30,720 and 0; zamba2-2.7b's
                shared block on its heads (2, 32,768, 2/2, 80) within its
                4,096-token window: each against its plain version at B=1
                in float32 and bf16, then timed at B=2 beside the plain
                version, SDPA (the same mask) and the bound. (e)
                Split-KV decode at full width on the one card
                (NCCL puts no two ranks on a device, so the 16 model ranks
                are simulated): starcoder2-7b, 8 rows, a 32,768-slot cache
                filled from the seed up to pos 20,000 (the slices past it
                empty); one decode step whose attention is computed as 16
                slices' `decode_partials` in turn and merged by
                `tensor_parallel.combine_partials` (the functions the
                sharded path calls) against the unsplit `decode_step`:
                bf16 at full depth (max |err| printed), float32 at 8
                layers (max |err| <= 1e-4 of the largest |logit|, the
                cosine of each row's logits >= 0.99999); layer 0's 16
                combined slices against its unsplit softmax in float32
                (max |err| <= 1e-5 of its largest |value|); then the ms
                of one layer's unsplit decode attention, of a rank's
                partials over its 2,048 slots and of the combine.
                Prints one `{"families": ...}` JSON line.
 15. training the families — last, after 14: float32 masters, bf16
                compute, remat "full", the flash kernels. (a) #11 and #12
                against their plain versions (B=1, bf16) at the attention
                shapes (b) trains — granite-moe-1b-a400m's (2,048, 16/8,
                Dh 64, causal), zamba2-2.7b's (4,096, 32/32, Dh 80, window
                4,096), hubert-xlarge's (1,024, 16/16, Dh 80,
                bidirectional) — and timed at the training microbatch
                beside the plain versions, SDPA's forward and backward and
                the bounds. (b) granite-moe-1b-a400m, zamba2-2.7b,
                hubert-xlarge (frame batches), xlstm-125m and olmoe-1b-7b
                at 4 of its 16 layers (a depth cut: ~111 GB of float32
                state at 16) at full width through `launch/train.py` `run`
                (FAMILY_TRAIN: 2 steps each): finite losses, aux losses and
                grad norms, the first cross-entropy within [ln V - 0.5,
                ln V + 3], #11 / #12 launches a step 2 / 1 x the attention
                applications x the microbatches (remat recomputes the
                forward) and no blockwise attention, memory < 80 GB; then
                3 steps at lr 1e-3 on one fixed batch from a fresh state
                (the loss falls; the MoE aux loss printed); xlstm's sLSTM
                forward and sequential backward timed alone. (c) On a
                one-process NCCL group: `make_dp_train_step_compressed` on
                a 1 x 1 mesh, granite-moe at full width, 12 steps on one
                fixed batch, compressed and exact: both fall, the last
                compressed loss within 10 % of the exact one; the bytes of
                int8 codes against float32 a step. (d) The `--mesh debug`
                step (`make_sharded_train_step`) on `make_debug_mesh(1, 1)`
                for stablelm-1.6b at full width (each unit's parameters
                gathered as the step reaches it, the gradients
                reduce-scattered onto the shards: `models/fsdp.py`):
                parameters and moments bit-equal to the single-device
                step's after 2 steps; each step's seconds and
                `torch.cuda.max_memory_allocated` (above what was allocated
                when the step began) beside the single-device step's. (e)
                The same for granite-moe-1b-a400m at full width in both
                MoE dispatch modes under the mesh (global, and -1: JAX's
                `_moe_shard_map`, a slab a device), 3 steps each, against
                one single-device run (-1 without a mesh is the one-chunk
                dispatch): bit-equal. The group is destroyed after. (d)
                and (e) run no tensor-parallel split: at a model axis of
                size 1 there is none. (f) #11 and #12 at the shapes a rank
                of the 16 x 16 train_4k step gives them under the model
                axis' split (`models/tensor_parallel.py`; TP_FLASH): the
                heads path's stablelm-1.6b (16, 4,096, 2/2, 64) causal and
                hubert-xlarge (16, 4,096, 1/1, 80) bidirectional, and
                chameleon-34b's context-parallel fallback, 256 queries of
                64/8 heads at Dh 128 against 4,096 gathered keys at
                q_offset 3,840 and 0, and the MoE families':
                olmoe-1b-7b's heads (16, 4,096, 1/1, 128) and
                granite-moe-1b-a400m's fallback, 256 queries of 16/8 heads
                at Dh 64 at q_offset 3,840 and 0, and zamba2-2.7b's shared
                block on its heads (16, 4,096, 2/2, 80, window 4,096):
                each against its plain
                version at B=1 in float32 and bf16, then timed at B=16
                beside the plain versions, SDPA (the same mask) and the
                bound. The ranks such a split needs cannot share the one
                card (NCCL puts no two ranks on a device), so the
                cross-rank step is held on the CPU
                (`tests/test_torch_tensor_parallel.py`,
                `tests/test_torch_moe_tp.py`,
                `tests/test_torch_ssm_tp.py`). (g) olmoe-1b-7b's MoE layer
                at its published width (64 experts, top 8, D 2,048, F
                1,024, capacity 1.25, random weights from the seed) on one
                16 x 16 train_4k rank's rows (16 x 4,096 tokens), its 16
                model ranks simulated on the one card with the port's own
                per-rank functions (`models/moe.py`): under global
                dispatch one routing of every token and each rank's 4
                experts (`_experts(..., first=...)`), the 16 partial
                outputs summed against the unsplit layer; under manual
                SPMD each rank's slab of 16 x 256 tokens (`_slabs`)
                against the unsplit layer over the same 16 slabs; float32
                max |err| <= 1e-5 of the largest |out|, bf16 printed; one
                rank's ms beside the unsplit layer's. (h) zamba2-2.7b's
                Mamba2 layer at its published width (D 2,560, d_inner
                5,120, 80 heads of 64, N 64, random weights from the seed)
                on the same rank's 16 x 4,096 tokens, its 16 model ranks
                simulated with the port's per-rank functions
                (`models/ssm.py`), each rank's parameters as `Plan.mode`
                and the shardings give them: each rank's 5 heads
                (`mamba2_gated`: its z, x and dt columns of the fused
                `in_proj`, B and C whole),
                the ranks' sums of squares summed for the gated norm, their
                `out_proj` partials (`mamba2_project`) summed against the
                unsplit layer; float32 max |err| <= 1e-5 of the largest
                |out|, bf16 printed; one rank's ms beside the unsplit
                layer's.
                Prints one `{"training_families": ...}` JSON line.
 16. roofline shares — each run once eagerly under
                `roofline.op_analyzer.OpAnalyzer` (the ops' products and
                bytes, each kernel function's `roofline.kernel_costs`
                formula), turned into the H100's three-term roofline
                (`roofline.analysis`, the data-sheet peaks), and the
                bound's share of the time the same work took where it was
                timed, printed unclipped: (a) right after phase 10 (a), the
                main search (10,000 queries, telemetry on, so #1's formula
                reads the walk's hops and scored candidates; #1 and #2
                each reported once) against (a)'s replay; (b) at the end
                of phase 9, a minicpm-2b train step (#11 / #12 reported
                2 / 1 x layers x microbatches) against the steady step,
                with 6·N·T beside the counted flops; (c) in phase 8, a
                starcoder2-7b decode step (no kernel) against generate's
                mean step. Prints one `{"roofline": ...}` JSON line.
 17. the examples — runs after phase 15, each example of
                `repro_torch.examples` in-process on the card with its own
                assertions: quickstart at its sizes; the seven
                streaming_updates modes (grow, churn, --sharded and
                --reshard on eight positions of the card, serve, tenants,
                tiered) at their full sizes, serve at --quick (its eager
                lanes hold the host ~40 ms a search, so the scheduler
                coalesces nothing and the full sizes take ~4 minutes on
                an H100), then
                churn and serve with --trace, each trace read by
                `scripts/obs_report.py` (exit 0); churn again through the
                main path's spec (megakernel, exact rerank on the card): #1
                and #2 once a search and no other kernel, the plain churn's
                ticks, recall@10 within 0.01 of the plain churn's and of the
                JAX script's each tick (whose first reads 0.845); rag_serve at its
                reduced size, then at stablelm-1.6b's published width in
                float32 through #10 (one launch a layer a forward, no
                blockwise call) and again blockwise on the same weights:
                equal hits; train_lm --full (xlstm-125m, 64 x 1,024) for 2
                steps into a fresh directory and 1 more resumed from its
                checkpoint: the "resumed from step 2" line, finite losses,
                the first cross-entropy in [ln V - 0.5, ln V + 3]. Prints
                each example's seconds and one `{"examples": ...}` JSON
                line.

Prints the serving, host-tier, sharded, families and roofline JSON lines,
the kernel JSON line (with each search kernel's launches a host-tier search
of its lane as `launches_host_tier` and a sharded search as
`launches_sharded`; #10's launches a forward of each family as
`launches_families` and its times at phase 14's shapes as
`at_family_shapes` and at (d)'s as `at_tp_prefill_shapes`; #11's and #12's launches in phase 15 (b) by family as
`launches_families`, added to `launches`, their times at phase 15's
shapes as `at_family_shapes` and at (f)'s as `at_tp_local_shapes`; #1's,
#2's and #10's launches in phase 17 as `launches_examples`, added to
`launches`), the
card's name and
power limit, and last `{"ok": true, "device": {...}}`. Exits non-zero,
printing no result, if there is no CUDA device, a kernel fails to build,
launch or agree, a path skips its kernel, recall misses its floor, or a
churn or serving check fails, a training or family check fails, or an
example's check fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

RECALL_FLOOR = 0.85
RECALL_SLACK = 0.01
SEED = 0                       # data, queries, the RaBitQ rotation
PRUNE_CHUNK = 16384            # RobustPrune rows per batch: memory only
SELF_HIT_FLOOR = 0.9           # reused rows found by their own vector, k=1


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_each(fn, reps: int) -> tuple[float, float, float]:
    """(median, min, max) device time of fn() over `reps` runs, each
    between its own pair of events (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = [start.elapsed_time(end) for start, end in pairs]
    return float(np.median(times)), min(times), max(times)


def graph_of(fn) -> torch.cuda.CUDAGraph:
    """fn() captured in a CUDA graph: its replays time the device alone, with
    no host time between launches (a launch whose kernel is shorter than
    the wrapper's host path otherwise times the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- operands
def int_query(rq, gen, lo=-3, hi=4):
    """Integer-valued query operands: every float sum is exact."""
    from repro_torch.core.rabitq import RaBitQQuery
    q, d = rq.q_rot.shape
    dev = rq.q_rot.device
    return RaBitQQuery(
        q_rot=torch.randint(lo, hi, (q, d), generator=gen).float().to(dev),
        query_add=torch.randint(0, 1000, (q,), generator=gen).float().to(dev),
        query_sumq=torch.randint(-100, 100, (q,),
                                 generator=gen).float().to(dev))


def int_codes(codes, gen, bits=None):
    """Integer-valued metadata (and, for another width, random packed
    bytes) over the same rows."""
    from repro_torch.core.rabitq import RaBitQCodes, packed_dim
    n = codes.packed.shape[0]
    dev = codes.packed.device
    bits = bits or codes.bits
    packed = codes.packed
    if bits != codes.bits:
        packed = torch.randint(0, 256, (n, packed_dim(codes.dims, bits)),
                               generator=gen, dtype=torch.uint8).to(dev)
    scale = torch.tensor([-2.0, -1.0, 1.0, 2.0])
    rescale = scale[torch.randint(0, 4, (n,), generator=gen)].to(dev)
    add = torch.randint(0, 50000, (n,), generator=gen).float().to(dev)
    return RaBitQCodes(packed=packed, data_add=add, data_rescale=rescale,
                       bits=bits, dims=codes.dims)


def random_masks(n, gen, dev):
    from repro_torch.core.mutations import pack_bitmap
    dead = torch.rand(n, generator=gen) < 0.1
    tomb = pack_bitmap(dead).to(dev)
    labels = torch.randint(0, 256, (n, 4), generator=gen,
                           dtype=torch.uint8)
    labels &= torch.tensor([0x0F, 0, 0, 0], dtype=torch.uint8)
    fb = torch.tensor([0x03, 0, 0, 0], dtype=torch.uint8)
    return tomb, labels.to(dev), fb.to(dev)


def fused_cases(core, queries, rq, gen, *, beam, max_iters):
    """(name, fused_operands kwargs) for every template variant, exact
    arithmetic: quantized 4 and 1 bit, exact L2, tombstone exclude, label
    exclude, telemetry, and one case with L > R + 1."""
    from repro_torch.kernels.search_step.ops import fused_operands
    graph = core.graph
    n = core.capacity
    tomb, labels, fb = random_masks(n, gen, core.device)
    iq = int_query(rq, gen)
    c4 = int_codes(core.codes, gen)
    c1 = int_codes(core.codes, gen, bits=1)
    iq1 = int_query(rq, gen, -1, 2)
    quant = dict(codes=c4, rq_query=iq)
    exact = dict(queries=queries, vectors=core.vectors,
                 vec_sqnorm=core.vec_sqnorm)
    wide = core.degree_bound * 2
    specs = [
        ("quant4", beam, quant, {}),
        ("quant1", beam, dict(codes=c1, rq_query=iq1), {}),
        ("exact", beam, exact, {}),
        ("quant4+tomb", beam, quant,
         dict(tombstone_bits=tomb, traverse_deleted=False)),
        ("quant4+labels", beam, quant,
         dict(labels=labels, filter_bytes=fb, filter_exclude=True)),
        ("exact+tomb+labels", beam, exact,
         dict(tombstone_bits=tomb, traverse_deleted=False, labels=labels,
              filter_bytes=fb, filter_exclude=True)),
        (f"quant4+L{wide}", wide, quant, {}),
    ]
    out = []
    for name, width, table, masks in specs:
        ops = fused_operands(graph, beam_width=width, max_iters=max_iters,
                             **table, **masks)
        for tel in (False, True):
            out.append((name + ("+tel" if tel else ""), ops, tel))
    return out


def compare_fused_exact(cases) -> None:
    from repro_torch.kernels.search_step.ops import (fused_search,
                                                     fused_search_plain)
    for name, ops, tel in cases:
        got = fused_search(**ops, telemetry=tel)
        want = fused_search_plain(**ops, telemetry=tel)
        torch.cuda.synchronize()
        labels = ("ids", "dists", "hops", "counters", "occupancy")
        for lab, g, w in zip(labels, got, want):
            same = torch.equal(g, w.to(g.dtype))
            if not same:
                bad = (g != w.to(g.dtype)).reshape(g.shape[0], -1).any(1)
                row = int(bad.nonzero()[0, 0])
                raise SmokeFailure(
                    f"fused_search {name}: {lab} differ on "
                    f"{int(bad.sum())} queries; first q={row}: kernel "
                    f"{g[row][:12].tolist()} plain {w[row][:12].tolist()}")
        log(f"  fused_search {name}: bit-equal on {got[0].shape[0]} queries "
            f"(L={got[0].shape[1]}, mean hops "
            f"{float(got[2].float().mean()):.2f})")


def compare_hop_exact(cases) -> None:
    """fused_hop against fused_hop_plain over every hop of whole walks,
    bit-equal on integer operands; the walk goes on from the kernel's
    output."""
    from repro_torch.kernels.search_step.ops import (
        fused_hop, fused_hop_plain, hop_operands)
    labels = ("ids", "dists", "visited", "increment", "counters")
    for name, ops, tel in cases:
        f, hop_ops = hop_operands(ops)
        sched = ops["schedule"].tolist()
        hops = iters = 0
        for t in range(ops["max_iters"]):
            got = fused_hop(*f, sched[t], **hop_ops, telemetry=tel)
            want = fused_hop_plain(*f, sched[t], **hop_ops, telemetry=tel)
            for lab, g, w in zip(labels, got, want):
                if not torch.equal(g, w):
                    bad = (g != w).reshape(g.shape[0], -1).any(1)
                    raise SmokeFailure(
                        f"fused_hop {name} hop {t}: {lab} differ on "
                        f"{int(bad.sum())} queries")
            n = int(got[3].sum())
            if n == 0:
                break
            hops, iters, f = hops + n, t + 1, got[:3]
        log(f"  fused_hop {name}: bit-equal over {iters} hops "
            f"({hops / f[0].shape[0]:.2f} per query)")


def compare_topk_exact(gen) -> None:
    """topk against topk_plain, bit-equal: integer dists with ties, 30 %
    +inf entries, rows whose second half is all +inf, and widths that are
    not a multiple of 32, on both sides of the warp path's width."""
    from repro_torch.kernels.topk.ops import topk, topk_plain
    for q, c, k in ((512, 6, 4), (10_000, 128, 64), (300, 45, 9),
                    (64, 1000, 100), (300, 33, 20), (1000, 256, 128),
                    (300, 257, 64)):
        d = torch.randint(0, 8, (q, c), generator=gen).float()
        d[torch.rand((q, c), generator=gen) < 0.3] = float("inf")
        d[: q // 4, c // 2:] = float("inf")
        ids = torch.randint(-1, 10**6, (q, c), generator=gen,
                            dtype=torch.int32)
        d, ids = d.cuda(), ids.cuda()
        got, want = topk(d, ids, k), topk_plain(d, ids, k)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"topk ({q}, {c}) k={k}: differs from topk_plain")
    log("  topk: bit-equal on ties and +inf tails, C in {6, 128, 45, 1000, "
        "33, 256, 257}")


def compare_step_exact(core, rq, gen, n_q) -> None:
    """rabitq_search_step and gather_l2, integer operands, bit-equal."""
    from repro_torch.kernels.distance.ops import gather_l2, gather_l2_plain
    from repro_torch.kernels.rabitq_dot.ops import (
        rabitq_search_step, rabitq_search_step_plain)
    dev = core.device
    n, r = core.adjacency.shape
    tomb, labels, fb = random_masks(n, gen, dev)
    # ids span the whole table; n_valid below it, so the range mask bites
    ids = torch.randint(-1, n, (n_q, r), generator=gen,
                        dtype=torch.int32).to(dev)
    n_valid = core.n_valid - 64
    for bits in (4, 1):
        c = int_codes(core.codes, gen, bits=bits)
        iq = int_query(rq, gen, *((-3, 4) if bits == 4 else (-1, 2)))
        for masks in ({}, dict(tombstone_bits=tomb),
                      dict(labels=labels, filter_bytes=fb),
                      dict(tombstone_bits=tomb, labels=labels,
                           filter_bytes=fb)):
            args = (ids, c.packed, c.data_add, c.data_rescale, n_valid,
                    iq.q_rot, iq.query_add, iq.query_sumq)
            got = rabitq_search_step(*args, bits=bits, **masks)
            want = rabitq_search_step_plain(*args, bits=bits, **masks)
            check(torch.equal(got, want),
                  f"rabitq_search_step bits={bits} masks={sorted(masks)}: "
                  f"max |diff| {float((got - want).nan_to_num().abs().max())}")
    log(f"  rabitq_search_step: bit-equal, bits 4/1 x masks, ({n_q}, {r})")
    q = core.vectors[torch.randint(0, core.n_valid, (n_q,),
                                   generator=gen).to(dev)]
    ids = torch.randint(-1, core.n_valid, (n_q, r), generator=gen,
                        dtype=torch.int32).to(dev)
    got = gather_l2(q.contiguous(), core.vectors, core.vec_sqnorm, ids)
    want = gather_l2_plain(q, core.vectors, core.vec_sqnorm, ids)
    check(torch.equal(got, want), "gather_l2: not bit-equal on integer rows")
    log(f"  gather_l2: bit-equal on integer rows, ({n_q}, {r})")


# #5's self-check shapes (K, P, D) at 4 bits: the main path's 64-byte
# rows, 33-byte rows (byte copies and byte units) with D below P * 2, and
# the RAG index's 2,304-byte rows (D = 4,608: rounds of 7 rows, the query
# transposed in shared memory)
GATHER_SELFCHECK = ((64, 64, 128), (40, 33, 60), (64, 2304, 4608))


def compare_gather_exact(gen, dev, n=1024, n_q=256, bits=4) -> None:
    """Phase 3: rabitq_gather_distance at GATHER_SELFCHECK's shapes on
    random codes and integer metadata: bit-equal to its plain version on
    integer queries, and to rabitq_search_step at the same in-range ids
    on integer and real queries."""
    from repro_torch.kernels.rabitq_dot.ops import (
        rabitq_gather_distance, rabitq_gather_distance_plain,
        rabitq_search_step)
    for k, p, d in GATHER_SELFCHECK:
        packed = torch.randint(0, 256, (n, p), generator=gen,
                               dtype=torch.uint8).to(dev)
        add = torch.randint(0, 4000, (n,), generator=gen).float().to(dev)
        rescale = torch.tensor([-2., -1., 1., 2.])[
            torch.randint(0, 4, (n,), generator=gen)].to(dev)
        ids = torch.randint(0, n, (n_q, k), generator=gen,
                            dtype=torch.int32).to(dev)
        qa = torch.randint(0, 500, (n_q,), generator=gen).float().to(dev)
        qs = torch.randint(-50, 50, (n_q,), generator=gen).float().to(dev)
        cand = (packed[ids.long()].contiguous(), add[ids.long()],
                rescale[ids.long()])
        for kind in ("integer", "real"):
            q = (torch.randint(-3, 4, (n_q, d), generator=gen).float()
                 if kind == "integer" else
                 torch.randn((n_q, d), generator=gen)).to(dev)
            got = rabitq_gather_distance(*cand, q, qa, qs, bits=bits)
            step = rabitq_search_step(ids, packed, add, rescale, n, q, qa,
                                      qs, bits=bits)
            check(torch.equal(got, step), f"rabitq_gather_distance (K {k}, "
                  f"P {p}, D {d}) differs from rabitq_search_step on "
                  f"{kind} queries")
            if kind == "integer":
                check(torch.equal(got, rabitq_gather_distance_plain(
                    *cand, q, qa, qs, bits=bits)),
                    f"rabitq_gather_distance (K {k}, P {p}, D {d}) not "
                    "bit-equal to its plain version on integer operands")
    log(f"  rabitq_gather_distance: bit-equal to its plain version (integer"
        f" queries) and to rabitq_search_step (integer and real), (K, P, D)"
        f" {GATHER_SELFCHECK}")


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by name (each counts its
    launches in `.launches`)."""
    from repro_torch.kernels.distance.ops import (gather_l2, gather_l2_tiled,
                                                  pairwise_l2)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd, flash_attention_fwd)
    from repro_torch.kernels.rabitq_dot.ops import (
        rabitq_distance, rabitq_gather_distance, rabitq_search_step)
    from repro_torch.kernels.search_step.ops import fused_hop, fused_search
    from repro_torch.kernels.topk.ops import topk
    return {"fused_search": fused_search, "gather_l2": gather_l2,
            "rabitq_search_step": rabitq_search_step,
            "fused_hop": fused_hop, "topk": topk,
            "gather_l2_tiled": gather_l2_tiled, "pairwise_l2": pairwise_l2,
            "rabitq_distance": rabitq_distance,
            "rabitq_gather_distance": rabitq_gather_distance,
            "flash_attention": flash_attention,
            "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd": flash_attention_bwd}


def counts(**nonzero) -> dict:
    """Expected launch counts of one search: 0 for every kernel not named."""
    return {name: nonzero.get(name, 0) for name in kernel_wrappers()}


def counted(fn):
    """Run fn() between zeroed and read launch counters; returns (its
    result, the seconds to a synchronised finish, {kernel: launches})."""
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, {k: w.launches for k, w in wrappers.items()}


# ------------------------------------------ roofline shares (phase 16)
# each share of phase 16, by what it measures: filled in by phases 10
# (the search), 9 (the train step) and 8 (the decode step)
ROOFLINE: dict = {}


def tensor_bytes(*trees) -> int:
    """Bytes of every tensor in `trees` (a module by its parameters)."""
    from torch.utils._pytree import tree_flatten
    n = 0
    for t in trees:
        leaves = (list(t.parameters()) if isinstance(t, torch.nn.Module)
                  else tree_flatten(t)[0])
        n += sum(x.numel() * x.element_size() for x in leaves
                 if isinstance(x, torch.Tensor))
    return n


def roofline_share(what: str, fn, measured_s: float,
                   want_kernels: dict | None = None,
                   fixed: tuple | None = None) -> dict:
    """Phase 16: fn() run once eagerly under `roofline.op_analyzer`, and
    two bounds on the H100's roofline (`roofline.analysis`), each beside
    `measured_s`, the time the same work took where it was timed (shares
    printed as they are, not clipped):

      * the fixed-formula bound, the share a cell can hold a change to:
        `fixed` = (bytes, flops, note) of the work by formula (flops at
        the bf16 rate), or, when None, the kernel functions' own
        `kernel_costs` formulas summed;
      * the op-level bound, a diagnostic: the analyzer's count, whose
        memory term is the eager ops' own operand and result traffic, so
        it falls with the time when a change fuses or drops an op (above
        1.0 the byte convention overstates the traffic).

    `want_kernels`: the kernel functions the run must report, by calls."""
    from repro_torch.roofline.analysis import H100, roofline_terms
    from repro_torch.roofline.op_analyzer import OpAnalyzer
    t0 = time.perf_counter()
    with OpAnalyzer() as ana:
        fn()
    torch.cuda.synchronize()
    c = ana.analyze()
    rt = roofline_terms(c["flops"], c["bytes_accessed"],
                        c["collectives"]["total"]["bytes"], 1, H100,
                        f32_flops=c["flops_f32"])
    calls = {k: v["calls"] for k, v in c["kernels"].items()}
    if want_kernels is not None:
        check(calls == want_kernels, f"{what}: the analyzer saw kernel "
              f"calls {calls}, expected {want_kernels}")
    if fixed is None:
        kern = c["kernels"].values()
        fb, ff = sum(k["bytes"] for k in kern), sum(k["flops"] for k in kern)
        ff32 = sum(k["flops"] for k in kern if k["rate"] == "f32")
        note = "the kernel formulas"
    else:
        (fb, ff, note), ff32 = fixed, 0.0
    ft = roofline_terms(ff, fb, 0.0, 1, H100, f32_flops=ff32)
    share = rt["bound_s"] / measured_s
    rec = dict(flops=c["flops"], flops_f32=c["flops_f32"],
               bytes=c["bytes_accessed"], compute_s=rt["compute_s"],
               memory_s=rt["memory_s"], dominant=rt["dominant"],
               bound_s=rt["bound_s"], measured_s=measured_s, share=share,
               fixed=dict(formula=note, bytes=fb, flops=ff, flops_f32=ff32,
                          dominant=ft["dominant"], bound_s=ft["bound_s"],
                          share=ft["bound_s"] / measured_s),
               kernels=c["kernels"], top_ops=dict(ana.top_ops(6)),
               analyzer_s=time.perf_counter() - t0)
    log(f"  [16] {what}: fixed-formula bound ({note}: "
        f"{ff / 1e12:.4f} TFLOP, {fb / 1e9:.4f} GB) "
        f"{1e3 * ft['bound_s']:.4f} ms, {ft['dominant']}: share "
        f"{rec['fixed']['share']:.4f} of {1e3 * measured_s:.4f} ms measured. "
        f"Op-level (diagnostic): {c['flops'] / 1e12:.4f} TFLOP counted "
        f"({c['flops_f32'] / 1e12:.4f} at the float32 rate), "
        f"{c['bytes_accessed'] / 1e9:.4f} GB; compute "
        f"{1e3 * rt['compute_s']:.4f} ms, memory "
        f"{1e3 * rt['memory_s']:.4f} ms, dominant {rt['dominant']}; "
        f"bound {1e3 * rt['bound_s']:.4f} ms: share {share:.4f}; "
        f"kernel calls {calls}; analyzed in {rec['analyzer_s']:.1f} s; "
        f"the ops that move the most bytes: " + ", ".join(
            f"{k} {v['count']}x {v['bytes'] / 1e9:.2f} GB"
            for k, v in rec["top_ops"].items()))
    return rec


# --------------------------------------------------------------- phases
def build_index(data, params, seed=0):
    from repro_torch.core.index import JasperIndex
    idx = JasperIndex(data.shape[1], data.shape[0], quantization="rabitq",
                      bits=4, construction=params, seed=seed)
    t0 = time.perf_counter()
    idx.build(data)
    torch.cuda.synchronize()
    return idx, time.perf_counter() - t0


def selfcheck(gen) -> None:
    """Phase 3: every kernel variant on a small bigann-shaped index."""
    from repro_torch.core.construction import ConstructionParams
    from repro_torch.core.rabitq import rabitq_preprocess_query
    from repro_torch.data.synthetic import (ANNS_DATASETS, make_anns_dataset,
                                            make_queries)
    ds = ANNS_DATASETS["bigann"]
    data = make_anns_dataset(ds, n=8192, seed=3)
    queries = torch.as_tensor(make_queries(ds, 512, seed=4)).cuda()
    params = ConstructionParams(degree_bound=64, alpha=1.2, beam_width=64,
                                max_iters=96, rev_cap=64, prune_chunk=4096)
    idx, secs = build_index(data, params)
    log(f"  selfcheck index: 8192 x 128 built in {secs:.2f} s")
    core = idx.core
    rq = rabitq_preprocess_query(core.rq_params, queries)
    cases = fused_cases(core, queries, rq, gen, beam=64, max_iters=140)
    compare_fused_exact(cases)
    compare_hop_exact(cases)
    compare_step_exact(core, rq, gen, 512)
    compare_gather_exact(gen, core.device)
    compare_topk_exact(gen)
    flash_selfcheck(gen)


def recall_at(ids, gt) -> float:
    ids = ids.cpu().numpy()
    gt = gt.cpu().numpy()
    hits = (ids[:, :, None] == gt[:, None, :]) & (ids >= 0)[:, :, None]
    return float(np.mean(hits.any(axis=2).sum(axis=1) / gt.shape[1]))


def profile_device(fn, what: str, top: int = 8, stats: dict | None = None):
    """Run fn() once more under torch.profiler: device time per kernel and
    the device's busy share of the call's wall time. Returns fn()'s
    result; `stats`, when given, receives wall_us, busy_us and share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side activities only: an aten op's row repeats its kernels'
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    if stats is not None:
        stats.update(wall_us=wall_us, busy_us=busy,
                     share=busy / wall_us if rows else None)
    if not rows:
        log(f"  profile ({what}): the profiler recorded no device time")
        return out
    log(f"  profile ({what}): wall {wall_us:.0f} us, device busy "
        f"{busy:.0f} us ({100 * busy / wall_us:.1f}%), "
        f"{sum(r[2] for r in rows)} device activities")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"    {us:10.1f} us  {count:4d}x  {key[:90]}")
    return out


def main_path(args):
    """Phase 4: build + the three search paths, counters around each.
    Returns the index, the queries on the card, each kernel's launches
    from the path that runs it, the brute-force (ids, dists) and the
    megakernel path's numbers."""
    from repro_torch.core.construction import ConstructionParams
    from repro_torch.core.search_spec import SearchSpec
    from repro_torch.data.synthetic import (ANNS_DATASETS, make_anns_dataset,
                                            make_queries)
    wrappers = kernel_wrappers()
    ds = ANNS_DATASETS["bigann"]
    t0 = time.perf_counter()
    data = make_anns_dataset(ds, n=args.n, seed=SEED)
    queries = make_queries(ds, args.queries, seed=SEED + 1)
    log(f"  data: {args.n} x {ds.dims} bigann-shaped, {args.queries} queries"
        f" (generated in {time.perf_counter() - t0:.1f} s)")
    params = ConstructionParams(degree_bound=64, alpha=1.2, beam_width=64,
                                max_iters=96, rev_cap=64,
                                prune_chunk=PRUNE_CHUNK)

    for w in wrappers.values():
        w.launches = 0
    idx, build_s = build_index(data, params, seed=SEED)
    log(f"  build: {build_s:.2f} s ({args.n / build_s:.0f} rows/s), "
        f"device memory in use {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    check(all(w.launches == 0 for w in wrappers.values()),
          "construction launched a search kernel")
    stats = idx.memory_stats()
    log(f"  resident: rows {args.n * 512 / 1e6:.0f} MB, adjacency "
        f"{args.n * 256 / 1e6:.0f} MB, codes+metadata "
        f"{stats['rabitq_resident_bytes'] / 1e6:.0f} MB")

    q_dev = torch.as_tensor(queries).cuda()
    gt, gt_d = idx.brute_force(q_dev, 10)
    torch.cuda.synchronize()
    paths = {
        "megakernel": SearchSpec(k=10, beam_width=64, quantized=True,
                                 use_kernels=True, fusion="megakernel"),
        "unfused+kernel": SearchSpec(k=10, beam_width=64, quantized=True,
                                     use_kernels=True, fusion="none"),
        "plain": SearchSpec(k=10, beam_width=64, quantized=True,
                            use_kernels=False, fusion="none"),
    }
    results = {}
    for name, spec in paths.items():
        searcher = idx.searcher(spec)
        res, secs, launched = counted(lambda: searcher.search(q_dev))
        rec = recall_at(res.ids, gt)
        hops = float(res.n_hops.float().mean())
        results[name] = dict(recall=rec, qps=args.queries / secs, secs=secs,
                             hops=hops, max_hops=int(res.n_hops.max()),
                             launches=launched)
        log(f"  search {name}: {args.queries / secs:.0f} QPS ({secs:.3f} s),"
            f" recall@10 {rec:.4f}, mean hops {hops:.2f}, launches "
            f"{launched}")
    mk_searcher = idx.searcher(paths["megakernel"])
    results["megakernel"]["profile"] = {}
    profile_device(lambda: mk_searcher.search(q_dev),
                   "megakernel path, one search",
                   stats=results["megakernel"]["profile"])

    mk, uk, pl = (results["megakernel"], results["unfused+kernel"],
                  results["plain"])
    # megakernel: one whole-search launch, one rerank. Unfused: the medoid
    # plus one launch per loop iteration (the loop runs until the longest
    # query stops, so max hops iterations), one rerank. Plain: none.
    expected = {
        "megakernel": counts(fused_search=1, gather_l2=1),
        "unfused+kernel": counts(gather_l2=1,
                                 rabitq_search_step=1 + uk["max_hops"]),
        "plain": counts(),
    }
    for name, want in expected.items():
        got = results[name]["launches"]
        check(got == want, f"{name} path launched {got}, expected {want}")
    check(mk["recall"] >= pl["recall"] - RECALL_SLACK,
          f"megakernel recall {mk['recall']:.4f} more than {RECALL_SLACK} "
          f"below the plain path's {pl['recall']:.4f}")
    check(mk["recall"] >= RECALL_FLOOR,
          f"megakernel recall {mk['recall']:.4f} < {RECALL_FLOOR}")
    check(uk["recall"] >= RECALL_FLOOR,
          f"unfused kernel recall {uk['recall']:.4f} < {RECALL_FLOOR}")
    # each kernel's count from the path that runs it: the megakernel path
    # for fused_search and gather_l2, the unfused path for rabitq_search_step
    launches = dict(fused_search=mk["launches"]["fused_search"],
                    gather_l2=mk["launches"]["gather_l2"],
                    rabitq_search_step=uk["launches"]["rabitq_search_step"])
    log(f"  launches per path's search: {launches}")
    return idx, q_dev, launches, (gt, gt_d), mk


def kernels_at_main_shapes(idx, q_dev, launches, gen):
    """Phase 5: each kernel against its plain version at main-path shapes;
    times, bounds; returns the kernel JSON records."""
    from repro_torch.core.rabitq import rabitq_preprocess_query
    from repro_torch.kernels.distance.ops import gather_l2, gather_l2_plain
    from repro_torch.kernels.rabitq_dot.ops import (
        rabitq_search_step, rabitq_search_step_plain)
    from repro_torch.kernels.search_step.ops import (
        fused_operands, fused_search, fused_search_plain, occupancy)
    from repro_torch.roofline import kernel_costs as kc

    core = idx.core
    n_q = q_dev.shape[0]
    beam, max_iters = 64, 140
    r = core.degree_bound
    p = core.codes.packed.shape[1]
    d = core.store_dims
    rq = rabitq_preprocess_query(core.rq_params, q_dev)
    records = []

    # ---- megakernel: exact-arithmetic mode, every variant
    compare_fused_exact(fused_cases(core, q_dev, rq, gen, beam=beam,
                                    max_iters=max_iters))
    # ---- megakernel: realistic mode on the real codes and queries
    ops = fused_operands(core.graph, beam_width=beam, max_iters=max_iters,
                         codes=core.codes, rq_query=rq)
    got = fused_search(**ops, telemetry=True)
    want = fused_search_plain(**ops, telemetry=True)
    torch.cuda.synchronize()
    id_agree = float((got[0] == want[0]).float().mean())
    hop_agree = float((got[2] == want[2]).float().mean())
    same = got[0] == want[0]
    fin = same & torch.isfinite(want[1])
    err = float((got[1][fin] - want[1][fin]).abs().max()) if fin.any() else 0.
    close = torch.allclose(got[1][fin], want[1][fin], rtol=1e-4, atol=1e-3)
    log(f"  fused_search realistic: id agreement {id_agree:.4f}, hops equal "
        f"{hop_agree:.4f}, max |dist err| {err:.3g}")
    check(id_agree >= 0.99, f"fused_search id agreement {id_agree:.4f}")
    check(hop_agree >= 0.99, f"fused_search hop agreement {hop_agree:.4f}")
    check(close, "fused_search dists outside rtol 1e-4")
    hops_total = float(got[2].sum())
    scored_total = float(got[3][:, 0].sum())
    ms = cuda_ms(lambda: fused_search(**ops), 3)
    med, lo, hi = cuda_ms_each(lambda: fused_search(**ops), 10)
    plain_ms = cuda_ms(lambda: fused_search_plain(**ops), 1)
    b_ms, b_by = kc.fused_search(
        n_q, beam, r, p, 8, p * 8 // core.codes.bits, hops=hops_total,
        scored=scored_total, d=d).bound()
    occ = occupancy(hop=False, quantized=True, bits=core.codes.bits,
                    l_width=beam, r=r, dq=ops["q"].shape[1], row_width=p)
    log(f"  fused_search: {ms:.3f} ms (mean of 3); median of 10 {med:.3f} ms"
        f" (min {lo:.3f}, max {hi:.3f}); plain {plain_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / med:.1f} % of it at the "
        f"median; {hops_total / n_q:.2f} hops and "
        f"{scored_total / n_q:.1f} scored candidates per query "
        f"({hops_total:.0f} and {scored_total:.0f} in all)")
    log(f"  fused_search main-path instance: {occ['registers']} registers, "
        f"{occ['queries_per_sm']} resident queries per SM "
        f"({occ['queries_per_block']} a block, {occ['smem_per_block']} B of "
        f"shared memory a block, {occ['local_bytes']} B local)")
    records.append(dict(
        name="fused_search", route="cuda",
        source="src/repro_torch/csrc/search_step.cu",
        replaces="src/repro/kernels/search_step/search_step_kernel.py:352",
        launches=launches["fused_search"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ms_median=med, ms_min=lo, ms_max=hi,
        registers=occ["registers"], queries_per_sm=occ["queries_per_sm"]))

    # ---- rabitq_search_step at a hop's shape: (Q, R) ids of real rows
    compare_step_exact(core, rq, gen, n_q)
    ids = core.adjacency[torch.randint(0, core.n_valid, (n_q,),
                                       generator=gen).to(core.device)]
    args = (ids.contiguous(), core.codes.packed, core.codes.data_add,
            core.codes.data_rescale, core.n_valid, rq.q_rot, rq.query_add,
            rq.query_sumq)
    got = rabitq_search_step(*args, bits=core.codes.bits)
    want = rabitq_search_step_plain(*args, bits=core.codes.bits)
    fin = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), fin),
          "rabitq_search_step masks differ")
    err = float((got[fin] - want[fin]).abs().max())
    check(torch.allclose(got[fin], want[fin], rtol=1e-4, atol=1e-3),
          f"rabitq_search_step realistic: max |err| {err}")
    def step():
        return rabitq_search_step(*args, bits=core.codes.bits)

    ms = cuda_ms(step, 20)
    # the kernel alone, replayed from a CUDA graph (`ms` above is launched
    # from the wrapper, whose host path may be the longer of the two)
    graph = graph_of(step)
    g_ms = cuda_ms(graph.replay, 20)
    g_med, g_lo, g_hi = cuda_ms_each(graph.replay, 20)
    del graph
    plain_ms = cuda_ms(
        lambda: rabitq_search_step_plain(*args, bits=core.codes.bits), 5)
    n_valid_ids = float(fin.sum())
    b_ms, b_by = kc.rabitq_search_step(
        n_q, r, p, p * 8 // core.codes.bits, d, n_valid=n_valid_ids).bound()
    occ = estimator_occupancy("rabitq_search_step", core.codes.bits, p)
    log(f"  rabitq_search_step ({n_q}, {r}): {ms:.4f} ms launched from the "
        f"wrapper (mean of 20); replayed from a CUDA graph (the kernel "
        f"alone) {g_ms:.4f} ms, median of 20 {g_med:.4f} (min {g_lo:.4f}, "
        f"max {g_hi:.4f}); plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}), {100 * b_ms / g_med:.1f} % of it at the graph median, "
        f"max |err| {err:.3g}; {n_valid_ids:.0f} in-range ids; {occ}")
    records.append(dict(
        name="rabitq_search_step", route="cuda",
        source="src/repro_torch/csrc/rabitq_search_step.cu",
        replaces="src/repro/kernels/rabitq_dot/rabitq_kernel.py:131",
        launches=launches["rabitq_search_step"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ms_graph=g_ms, ms_graph_median=g_med, ms_graph_min=g_lo,
        ms_graph_max=g_hi, **occ))

    # ---- gather_l2 at the rerank's shape: the (Q, L) final frontier
    frontier = fused_search(**ops)[0]
    real_q = q_dev.contiguous()
    noisy_q = (q_dev + 0.37 * torch.randn(q_dev.shape, generator=gen)
               .to(q_dev.device)).contiguous()
    got = gather_l2(real_q, core.vectors, core.vec_sqnorm, frontier)
    want = gather_l2_plain(real_q, core.vectors, core.vec_sqnorm, frontier)
    check(torch.equal(got, want), "gather_l2 not bit-equal on integer rows")
    got = gather_l2(noisy_q, core.vectors, core.vec_sqnorm, frontier)
    want = gather_l2_plain(noisy_q, core.vectors, core.vec_sqnorm, frontier)
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max())
    check(torch.equal(torch.isfinite(got), fin), "gather_l2 masks differ")
    # |q|^2 - 2 q.c + |c|^2 cancels terms far larger than the distance:
    # allow rtol 1e-4 of the distance plus a few float32 ulps of the terms
    terms = ((noisy_q * noisy_q).sum(-1, keepdim=True)
             + core.vec_sqnorm[frontier.clamp(min=0).long()])
    tol = 1e-4 * want.abs() + 1e-6 * terms
    check(bool(((got - want).abs()[fin] <= tol[fin]).all()),
          f"gather_l2 realistic: max |err| {err}")
    ms = cuda_ms(lambda: gather_l2(real_q, core.vectors, core.vec_sqnorm,
                                   frontier), 20)
    plain_ms = cuda_ms(lambda: gather_l2_plain(real_q, core.vectors,
                                               core.vec_sqnorm, frontier), 5)
    flat = frontier.clamp(min=0).reshape(-1).long()

    def yardstick():
        cand = core.vectors.index_select(0, flat).view(n_q, beam, d)
        return torch.bmm(cand, real_q[:, :, None])

    lib_ms = cuda_ms(yardstick, 20)
    n_valid_ids = float((frontier >= 0).sum())
    b_ms, b_by = kc.gather_l2(n_q, beam, d, n_valid=n_valid_ids).bound()
    log(f"  gather_l2 ({n_q}, {beam}): {ms:.4f} ms, plain {plain_ms:.4f} ms,"
        f" index_select+bmm {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}),"
        f" max |err| {err:.3g}")
    records.append(dict(
        name="gather_l2", route="cuda",
        source="src/repro_torch/csrc/gather_l2.cu",
        replaces="src/repro/kernels/distance/distance_kernel.py:130",
        launches=launches["gather_l2"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    records += hop_and_topk_at_main_shapes(core, ops, rq)
    return records


def hop_and_topk_at_main_shapes(core, ops, rq) -> list:
    """Phase 5, the churn slice's kernels: `fused_hop` on the real
    frontier of hops 0, 10, 20, ... of a hop-mode walk over the real codes
    (realistic mode: increments and counters equal, id agreement >= 0.99,
    dists rtol 1e-4; times and bounds averaged over those hops), and
    `topk` on the merge operands of hop 10 (frontier ++ the estimates of
    its first slot's neighbours: Q x (L + R), k = L), bit-equal. Their
    `launches` are filled in from the churn round's searches."""
    from repro_torch.kernels.rabitq_dot.ops import rabitq_search_step
    from repro_torch.kernels.search_step.ops import (
        fused_hop, fused_hop_plain, hop_operands)
    from repro_torch.kernels.topk.ops import topk, topk_plain
    from repro_torch.roofline import kernel_costs as kc
    f, hop_ops = hop_operands(ops)
    sched = ops["schedule"].tolist()
    n_q, beam = ops["f_ids"].shape
    r = core.degree_bound
    p = core.codes.packed.shape[1]
    dq = ops["q"].shape[1]
    d = core.store_dims
    ms, plain, bounds, err, agree, f10 = [], [], [], 0.0, [], None
    medians, spread, g_ms, g_medians, g_spread = [], [], [], [], []
    for t in range(ops["max_iters"]):
        if t % 10:
            got = fused_hop(*f, sched[t], **hop_ops)
        else:
            got = fused_hop(*f, sched[t], **hop_ops, telemetry=True)
            want = fused_hop_plain(*f, sched[t], **hop_ops, telemetry=True)
            torch.cuda.synchronize()
            check(torch.equal(got[3], want[3]) and torch.equal(got[4], want[4]),
                  f"fused_hop hop {t}: increments or counters differ")
            same = got[0] == want[0]
            agree.append(float(same.float().mean()))
            check(agree[-1] >= 0.99, f"fused_hop hop {t}: id agreement "
                  f"{agree[-1]:.4f}")
            fin = same & torch.isfinite(want[1])
            if fin.any():
                err = max(err, float((got[1][fin] - want[1][fin]).abs().max()))
                check(torch.allclose(got[1][fin], want[1][fin], rtol=1e-4,
                                     atol=1e-3), f"fused_hop hop {t}: dists")

            def launch(fi=f, width=sched[t]):
                return fused_hop(*fi, width, **hop_ops)

            ms.append(cuda_ms(launch, 5))
            med, lo, hi = cuda_ms_each(launch, 10)
            medians.append(med)
            spread += [lo, hi]
            graph = graph_of(launch)
            g_ms.append(cuda_ms(graph.replay, 5))
            med, lo, hi = cuda_ms_each(graph.replay, 10)
            g_medians.append(med)
            g_spread += [lo, hi]
            del graph
            plain.append(cuda_ms(
                lambda: fused_hop_plain(*f, sched[t], **hop_ops), 1))
            active = float(got[3].sum())
            scored = float(got[4][:, 0].sum())
            bounds.append(kc.fused_hop(n_q, beam, r, p, 8, dq, active=active,
                                       scored=scored, d=d).bound()[0])
            if t == 10:
                f10 = f
        if int(got[3].sum()) == 0:
            break
        f = got[:3]
    check(f10 is not None, "the hop walk ended before hop 10")
    hop_ms, hop_plain = float(np.mean(ms)), float(np.mean(plain))
    hop_bound = float(np.mean(bounds))
    hop_med, g_med = float(np.mean(medians)), float(np.mean(g_medians))
    g_mean = float(np.mean(g_ms))
    log(f"  fused_hop ({n_q}, L={beam}) over hops 0, 10, ..., "
        f"{10 * (len(ms) - 1)}, launched from the wrapper: {hop_ms:.4f} ms "
        f"per launch (mean of 5 a hop); median of 10 a hop {hop_med:.4f} ms "
        f"averaged over the hops (launches min {min(spread):.4f}, max "
        f"{max(spread):.4f}); replayed from a CUDA graph (the kernel alone) "
        f"{g_mean:.4f} ms, median of 10 a hop {g_med:.4f} ms (each hop's "
        f"median: {', '.join(f'{m:.4f}' for m in g_medians)}; launches min "
        f"{min(g_spread):.4f}, max {max(g_spread):.4f}); plain "
        f"{hop_plain:.4f} ms, bound {hop_bound:.4f} ms (bytes), id agreement "
        f"min {min(agree):.4f}, max |err| {err:.3g}")
    records = [dict(
        name="fused_hop", route="cuda",
        source="src/repro_torch/csrc/search_step.cu",
        replaces="src/repro/kernels/search_step/search_step_kernel.py:309",
        launches=None, max_abs_err=err, ms=hop_ms, plain_ms=hop_plain,
        bound_ms=hop_bound, bound_by="bytes", library_ms=None,
        ms_median=hop_med, ms_min=min(spread), ms_max=max(spread),
        ms_graph=g_mean, ms_graph_median=g_med, ms_graph_min=min(g_spread),
        ms_graph_max=max(g_spread))]

    # ---- topk on hop 10's merge operands
    cand = core.adjacency[f10[0][:, 0].long()].contiguous()
    c_d = rabitq_search_step(cand, core.codes.packed, core.codes.data_add,
                             core.codes.data_rescale, core.n_valid, rq.q_rot,
                             rq.query_add, rq.query_sumq, bits=core.codes.bits)
    all_d = torch.cat([f10[1], c_d], dim=1).contiguous()
    c = all_d.shape[1]
    pos = torch.arange(c, dtype=torch.int32, device=all_d.device).expand(
        n_q, c).contiguous()
    got, want = topk(all_d, pos, beam), topk_plain(all_d, pos, beam)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "topk at the merge's shape differs from topk_plain")
    ms = cuda_ms(lambda: topk(all_d, pos, beam), 20)
    graph = graph_of(lambda: topk(all_d, pos, beam))
    g_ms = cuda_ms(graph.replay, 20)
    g_med, g_lo, g_hi = cuda_ms_each(graph.replay, 20)
    del graph
    plain_ms = cuda_ms(lambda: topk_plain(all_d, pos, beam), 20)
    lib_ms = cuda_ms(lambda: torch.topk(all_d, beam, dim=1, largest=False,
                                        sorted=True), 20)
    b_ms, b_by = kc.topk(n_q, c, beam).bound()
    log(f"  topk ({n_q}, {c}) k={beam}: launched from the wrapper "
        f"{ms:.4f} ms (mean of 20); replayed from a CUDA graph (the kernel "
        f"alone) {g_ms:.4f} ms, median of 20 {g_med:.4f} (min {g_lo:.4f}, "
        f"max {g_hi:.4f}); plain {plain_ms:.4f} ms, torch.topk "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"{float(torch.isinf(all_d).float().mean()):.3f} of the entries +inf")
    records.append(dict(
        name="topk", route="cuda", source="src/repro_torch/csrc/topk.cu",
        replaces="src/repro/kernels/topk/topk_kernel.py:49",
        launches=None, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, ms_graph=g_ms,
        ms_graph_median=g_med, ms_graph_min=g_lo, ms_graph_max=g_hi))
    return records


# ------------------------------------- exact lanes and full scans (phase 7)
SCAN_CHUNK = 131_072           # rows per full-scan launch
RERANK_DEPTH = 64              # estimated top-64, reranked exactly
EXACT_LANES = {
    "megakernel": dict(use_kernels=True, fusion="megakernel"),
    "hop": dict(use_kernels=True, fusion="hop"),
    "chunked": dict(use_kernels=True, fusion="none"),
    "tiled": None,   # beam_search over make_kernel_scorer(strategy="tiled")
    "plain": dict(use_kernels=False, fusion="none"),
}


def exact_lanes(idx, q_dev, gt, quant) -> dict:
    """The exact-vector search lanes on phase 4's index: recall, exact
    launch counts, tiled == chunked == plain and hop == megakernel bit for
    bit. Returns each lane's launches."""
    from repro_torch.core.beam_search import beam_search
    from repro_torch.core.search_spec import SearchSpec
    from repro_torch.kernels.distance.ops import make_kernel_scorer
    core = idx.core
    n_q = q_dev.shape[0]
    rs = SearchSpec(k=10, beam_width=64).resolve()
    res, launched = {}, {}
    for lane, kw in EXACT_LANES.items():
        if kw is None:
            def search():
                scorer = make_kernel_scorer(core.vectors, q_dev, core.n_valid,
                                            core.vec_sqnorm, strategy="tiled")
                r = beam_search(core.graph, scorer, n_q,
                                beam_width=rs.beam_width,
                                max_iters=rs.max_iters,
                                expand_per_iter=rs.expand,
                                merge_strategy=rs.merge,
                                beam_schedule=rs.beam_schedule)
                return (r.frontier_ids[:, :10], r.frontier_dists[:, :10],
                        r.n_hops)
        else:
            searcher = idx.searcher(SearchSpec(k=10, beam_width=64,
                                               quantized=False, **kw))

            def search():
                r = searcher.search(q_dev)
                return r.ids, r.dists, r.n_hops
        out, secs, got = counted(search)
        rec = recall_at(out[0], gt)
        hops = out[2]
        iters = int(hops.max())
        want = {"megakernel": counts(fused_search=1),
                "hop": counts(fused_hop=iters),
                "chunked": counts(gather_l2=1 + iters),
                "tiled": counts(gather_l2_tiled=1 + iters),
                "plain": counts()}[lane]
        log(f"  exact {lane:10s}: {n_q / secs:.0f} QPS ({secs:.3f} s), "
            f"recall@10 {rec:.4f}, mean hops {float(hops.float().mean()):.2f}"
            f", launches {got}")
        check(got == want, f"exact {lane} launched {got}, expected {want}")
        check(rec >= RECALL_FLOOR, f"exact {lane} recall {rec:.4f} < "
              f"{RECALL_FLOOR}")
        res[lane] = dict(out=out, secs=secs, recall=rec)
        launched[lane] = got

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(res[a]["out"],
                                                      res[b]["out"]))
    for a, b in (("tiled", "chunked"), ("chunked", "plain"),
                 ("hop", "megakernel")):
        check(same(a, b), f"exact {a} lane differs from the {b} lane (ids "
              f"agree {float((res[a]['out'][0] == res[b]['out'][0]).float().mean()):.4f})")
    log("  exact lanes: tiled == chunked == plain and hop == megakernel, bit "
        "for bit (ids, dists, hops)")
    mk_same = same("megakernel", "chunked")
    agree = float((res["megakernel"]["out"][0]
                   == res["chunked"]["out"][0]).float().mean())
    log(f"  exact megakernel == unfused lane: {mk_same} (id agreement "
        f"{agree:.4f})")
    mk = res["megakernel"]
    log(f"  megakernel exact vs quantized (+ rerank): {n_q / mk['secs']:.0f}"
        f" vs {quant['qps']:.0f} QPS, recall@10 {mk['recall']:.4f} vs "
        f"{quant['recall']:.4f}")
    return launched


def top_merge(best, chunk_d, s, k):
    """Running top-k: the chunk's k smallest (ids offset by s) merged with
    the best so far."""
    cd, ci = torch.topk(chunk_d, k, dim=1, largest=False, sorted=True)
    ci = ci.to(torch.int32) + s
    if best is None:
        return cd, ci
    d = torch.cat([best[0], cd], 1)
    i = torch.cat([best[1], ci], 1)
    d, order = torch.topk(d, k, dim=1, largest=False, sorted=True)
    return d, torch.gather(i, 1, order)


def chunks(n):
    return [(s, min(s + SCAN_CHUNK, n)) for s in range(0, n, SCAN_CHUNK)]


def within(got, want, terms, rtol=1e-4, ulps=1e-6):
    """|got - want| <= rtol |want| + ulps * terms elementwise (terms: the
    magnitude of what the sums cancel), in row blocks. Returns (ok, max
    |err|)."""
    ok, err = True, 0.0
    for r in range(0, got.shape[0], 1024):
        g, w = got[r:r + 1024], want[r:r + 1024]
        t = terms(r, r + g.shape[0])
        e = (g - w).abs()
        ok &= bool((e <= rtol * w.abs() + ulps * t).all())
        err = max(err, float(e.max()))
    return ok, err


def same_topk(d, i, ref_d, ref_i) -> tuple[bool, float]:
    """Top-k distances bit-equal, and the ids below each row's k-th
    distance equal as sets (ids tied at the cut may differ). Returns (ok,
    the share of rows whose ids match position for position)."""
    if not torch.equal(d, ref_d):
        return False, 0.0
    below = d < d[:, -1:]
    big = torch.iinfo(torch.int32).max
    a = torch.sort(torch.where(below, i, big), 1).values
    b = torch.sort(torch.where(below, ref_i, big), 1).values
    return torch.equal(a, b), float((i == ref_i).all(1).float().mean())


def full_scans(idx, q_dev, rq, gt, gt_d, frontier, gen):
    """Exact (pairwise_l2) and estimated (rabitq_distance) full scans of
    phase 4's index, and rabitq_gather_distance on the megakernel's final
    frontier. Returns the launches of each counted step and the max
    errors against the plain versions on the real codes."""
    from repro_torch.kernels.distance.ops import (gather_l2, pairwise_l2,
                                                  pairwise_l2_plain)
    from repro_torch.kernels.rabitq_dot.ops import (
        rabitq_distance, rabitq_distance_plain, rabitq_gather_distance,
        rabitq_gather_distance_plain, rabitq_search_step)
    core = idx.core
    n = core.n_valid
    n_q = q_dev.shape[0]
    spans = chunks(n)
    bits = core.codes.bits
    launched = {}

    # ---- exact full scan: the counted pass, then kernel vs plain
    def exact_scan():
        best = None
        for s, e in spans:
            best = top_merge(best, pairwise_l2(q_dev, core.vectors[s:e]), s,
                             10)
        return best
    (sd, si), secs, launched["pairwise_l2"] = counted(exact_scan)
    check(launched["pairwise_l2"] == counts(pairwise_l2=len(spans)),
          f"exact scan launched {launched['pairwise_l2']}")
    ok, rows_same = same_topk(sd, si, gt_d, gt)
    check(ok, "exact scan top-10 differs from brute_force's (distances, or "
          "ids below the 10th distance)")
    rec = recall_at(si, gt)
    log(f"  exact scan, {len(spans)} chunks of <= {SCAN_CHUNK} rows (last "
        f"{spans[-1][1] - spans[-1][0]}): {secs:.3f} s ({n_q / secs:.0f} "
        f"QPS), recall@10 {rec:.4f}; top-10 distances bit-equal to "
        f"brute_force, ids equal below the cut ({rows_same:.4f} of rows "
        f"equal position for position)")
    for s, e in spans:
        got = pairwise_l2(q_dev, core.vectors[s:e])
        check(torch.equal(got, pairwise_l2_plain(q_dev, core.vectors[s:e])),
              f"pairwise_l2 chunk [{s}, {e}) not bit-equal to its plain "
              "version")
        del got
    log(f"  pairwise_l2: every chunk bit-equal to pairwise_l2_plain "
        f"(integer rows and queries)")
    # where the scan's wall goes: the kernel, or the running top-k merge
    profile_device(exact_scan, "exact scan", top=4)

    # ---- estimated full scan: counted pass (top-64 -> exact rerank)
    c = core.codes

    def est_args(codes, q, s, e):
        return (codes.packed[s:e], codes.data_add[s:e],
                codes.data_rescale[s:e], q.q_rot, q.query_add, q.query_sumq)

    def est_scan():
        best = None
        for s, e in spans:
            best = top_merge(best, rabitq_distance(*est_args(c, rq, s, e),
                                                   bits=bits),
                             s, RERANK_DEPTH)
        exact = gather_l2(q_dev, core.vectors, core.vec_sqnorm, best[1])
        order = torch.sort(exact, dim=1, stable=True).indices[:, :10]
        return best[1][:, :10], torch.gather(best[1], 1, order)
    (code_top, reranked), secs, launched["rabitq_distance"] = counted(
        est_scan)
    check(launched["rabitq_distance"]
          == counts(rabitq_distance=len(spans), gather_l2=1),
          f"estimated scan launched {launched['rabitq_distance']}")
    rec_code = recall_at(code_top, gt)
    rec_rr = recall_at(reranked, gt)
    log(f"  estimated scan ({bits}-bit codes): {secs:.3f} s ({n_q / secs:.0f}"
        f" QPS), recall@10 code-only {rec_code:.4f}, after the exact rerank "
        f"of the top {RERANK_DEPTH} {rec_rr:.4f}")
    check(rec_rr >= RECALL_FLOOR, f"estimate-then-rerank recall {rec_rr:.4f}"
          f" < {RECALL_FLOOR}")
    # where the scan's wall goes: the kernel, or the running top-k merge
    profile_device(est_scan, "estimated scan", top=4)

    # ---- rabitq_gather_distance on the megakernel's final frontier
    check(bool(((frontier >= 0) & (frontier < n)).all()),
          "the megakernel frontier holds ids out of range")
    fl = frontier.long()

    def gathered(codes, q):
        return (codes.packed[fl].contiguous(), codes.data_add[fl],
                codes.data_rescale[fl], q.q_rot, q.query_add, q.query_sumq)

    g_real, _, launched["rabitq_gather_distance"] = counted(
        lambda: rabitq_gather_distance(*gathered(c, rq), bits=bits))
    check(launched["rabitq_gather_distance"]
          == counts(rabitq_gather_distance=1),
          f"frontier re-estimate launched {launched['rabitq_gather_distance']}")
    step = rabitq_search_step(frontier, c.packed, c.data_add, c.data_rescale,
                              n, rq.q_rot, rq.query_add, rq.query_sumq,
                              bits=bits)
    check(torch.equal(g_real, step), "rabitq_gather_distance differs from "
          "rabitq_search_step on the live frontier (real codes)")
    want = rabitq_gather_distance_plain(*gathered(c, rq), bits=bits)
    err5 = float((g_real - want).abs().max())
    check(torch.allclose(g_real, want, rtol=1e-4, atol=1e-3),
          f"rabitq_gather_distance realistic: max |err| {err5}")
    iq = int_query(rq, gen)
    ic = int_codes(c, gen)
    g_int = rabitq_gather_distance(*gathered(ic, iq), bits=bits)
    check(torch.equal(g_int, rabitq_gather_distance_plain(
        *gathered(ic, iq), bits=bits)),
        "rabitq_gather_distance not bit-equal to its plain version on "
        "integer operands")
    check(torch.equal(g_int, rabitq_search_step(
        frontier, ic.packed, ic.data_add, ic.data_rescale, n, iq.q_rot,
        iq.query_add, iq.query_sumq, bits=bits)),
        "rabitq_gather_distance differs from rabitq_search_step on integer "
        "operands")
    log(f"  rabitq_gather_distance ({n_q}, {frontier.shape[1]}): bit-equal "
        f"to its plain version (integer operands) and to rabitq_search_step "
        f"(integer and real operands), real max |err| vs plain {err5:.3g}; "
        "0 launches on every search lane")

    # ---- rabitq_distance vs plain: exact mode (and == #5), realistic mode
    err6 = 0.0
    for s, e in spans:
        got = rabitq_distance(*est_args(ic, iq, s, e), bits=bits)
        check(torch.equal(got, rabitq_distance_plain(*est_args(ic, iq, s, e),
                                                     bits=bits)),
              f"rabitq_distance chunk [{s}, {e}) not bit-equal to its plain "
              "version on integer operands")
        hit = (frontier >= s) & (frontier < e)
        at = torch.gather(got, 1, (frontier - s).clamp(0, e - s - 1).long())
        check(torch.equal(at[hit], g_int[hit]), f"rabitq_distance chunk "
              f"[{s}, {e}) differs from rabitq_gather_distance at the "
              "frontier ids")
        del got, at
        got = rabitq_distance(*est_args(c, rq, s, e), bits=bits)
        want = rabitq_distance_plain(*est_args(c, rq, s, e), bits=bits)
        qmag = rq.q_rot.abs().sum(1) * (2 ** bits - 1) + rq.query_sumq.abs()
        ok, err = within(got, want, lambda a, b: (
            c.data_add[s:e].abs()[None, :] + rq.query_add[a:b, None].abs()
            + c.data_rescale[s:e].abs()[None, :] * qmag[a:b, None]))
        check(ok, f"rabitq_distance chunk [{s}, {e}) realistic: max |err| "
              f"{err}")
        err6 = max(err6, err)
        del got, want
    log(f"  rabitq_distance: every chunk bit-equal to its plain version and "
        f"to rabitq_gather_distance at the frontier ids (integer operands); "
        f"real codes max |err| {err6:.3g}")
    torch.cuda.empty_cache()
    return launched, dict(err5=err5, err6=err6)


def scan_kernels_at_main_shapes(core, q_dev, rq, frontier, launches, errs,
                                gen):
    """Times and bounds of the four kernels of phase 7 (#7 on one full chunk
    with three operand kinds, #6 on one full chunk, #5 on the frontier, #8
    at the rerank's shape beside #2); returns their kernel JSON records."""
    from repro_torch.kernels.distance.ops import (
        gather_l2, gather_l2_plain, gather_l2_tiled, pairwise_l2,
        pairwise_l2_plain, pairwise_occupancy, pairwise_tensor_flops)
    from repro_torch.kernels.rabitq_dot.ops import (
        rabitq_distance, rabitq_distance_plain, rabitq_gather_distance,
        rabitq_gather_distance_plain)
    from repro_torch.roofline import kernel_costs as kc
    n_q, d = q_dev.shape
    c_n = min(SCAN_CHUNK, core.n_valid)
    x = core.vectors[:c_n]
    codes = core.codes
    bits, p = codes.bits, codes.packed.shape[1]
    k = frontier.shape[1]
    records = []

    # ---- pairwise_l2 on three operand kinds: the scan's integer queries
    # and rows (bit-equal in full_scans), noisy queries against the integer
    # rows, and real x real (the rows jittered too); times and bounds of each
    kinds = {"integer": (q_dev, x)}
    kinds["noisy"] = (q_dev + 0.37 * torch.randn(
        q_dev.shape, generator=gen).to(q_dev.device), x)
    kinds["real"] = (kinds["noisy"][0], x + 0.37 * torch.randn(
        x.shape, generator=gen).to(x.device))
    noisy_q = kinds["noisy"][0]
    # the float32 bound beside the tensor-core one: 2·Q·C·D operations
    b32_ms, b32_by = kc.bound(kc.pairwise_l2(n_q, c_n, d, tensor_flops=0).bytes,
                              2.0 * n_q * c_n * d)
    per_kind = {}
    for kind, (qk, xk) in kinds.items():
        got = pairwise_l2(qk, xk)
        want = pairwise_l2_plain(qk, xk)
        if kind == "integer":
            ok, err = torch.equal(got, want), float((got - want).abs().max())
        else:
            qsq = (qk * qk).sum(1)
            xsq = (xk * xk).sum(1)
            ok, err = within(got, want, lambda a, b, qsq=qsq, xsq=xsq: (
                qsq[a:b, None] + xsq[None, :]))
        check(ok, f"pairwise_l2 {kind} operands: max |err| {err}")
        del got, want
        ms = cuda_ms(lambda: pairwise_l2(qk, xk), 5)
        # the products the kernel takes on these operands (pairwise_l2's
        # votes) run at the bf16 tensor rate
        b_ms, b_by = kc.pairwise_l2(
            n_q, c_n, d, tensor_flops=pairwise_tensor_flops(qk, xk)).bound()
        per_kind[kind] = dict(ms=ms, err=err, bound_ms=b_ms, bound_by=b_by)
        log(f"  pairwise_l2 ({n_q}, {c_n}, {d}) {kind} operands: {ms:.3f} ms "
            f"(mean of 5), bound {b_ms:.3f} ms ({b_by}), {100 * b_ms / ms:.1f}"
            f" % of it; max |err| vs plain {err:.3g}")
    med, lo, hi = cuda_ms_each(lambda: pairwise_l2(q_dev, x), 5)
    plain_ms = cuda_ms(lambda: pairwise_l2_plain(q_dev, x), 2)
    lib_ms = cuda_ms(lambda: torch.cdist(
        q_dev, x, compute_mode="use_mm_for_euclid_dist"), 2)
    occ = pairwise_occupancy()
    main = per_kind["integer"]
    log(f"  pairwise_l2 ({n_q}, {c_n}, {d}): {main['ms']:.3f} ms (mean of 5),"
        f" median of 5 {med:.3f} (min {lo:.3f}, max {hi:.3f}); plain "
        f"{plain_ms:.3f} ms, torch.cdist (mm, returns the square root) "
        f"{lib_ms:.3f} ms, bound {main['bound_ms']:.3f} ms "
        f"({main['bound_by']}; float32 bound {b32_ms:.3f} ms, {b32_by}); "
        f"{occ}; {launches['pairwise_l2']['pairwise_l2']} launches per exact "
        "scan")
    records.append(dict(
        name="pairwise_l2", route="cuda",
        source="src/repro_torch/csrc/pairwise_l2.cu",
        replaces="src/repro/kernels/distance/distance_kernel.py:58",
        launches=launches["pairwise_l2"]["pairwise_l2"],
        max_abs_err=per_kind["noisy"]["err"], ms=main["ms"],
        plain_ms=plain_ms, bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=lib_ms, ms_median=med,
        ms_min=lo, ms_max=hi, bound_f32_ms=b32_ms, bound_f32_by=b32_by,
        **{f"{kind}_{key}": val for kind, rec in per_kind.items()
           for key, val in rec.items()}, **occ))
    torch.cuda.empty_cache()

    # ---- rabitq_distance on one chunk of the real codes
    args6 = (codes.packed[:c_n], codes.data_add[:c_n],
             codes.data_rescale[:c_n], rq.q_rot, rq.query_add, rq.query_sumq)
    ms = cuda_ms(lambda: rabitq_distance(*args6, bits=bits), 5)
    med, lo, hi = cuda_ms_each(lambda: rabitq_distance(*args6, bits=bits), 5)
    plain_ms = cuda_ms(lambda: rabitq_distance_plain(*args6, bits=bits), 2)
    # the 2QCD products are exact on the tensor cores (integer codes times
    # a query split into three bf16 parts), so the least time for this work
    # is at the bf16 rate; the float32 bound is kept beside it
    c6 = kc.rabitq_distance(n_q, c_n, p, d)
    b_ms, b_by = c6.bound()
    b32_ms, b32_by = kc.bound(c6.bytes, c6.flops)
    occ = estimator_occupancy("rabitq_distance", bits, p)
    log(f"  rabitq_distance ({n_q}, {c_n}, {bits} bits): {ms:.3f} ms (mean "
        f"of 5), median of 5 {med:.3f} (min {lo:.3f}, max {hi:.3f}); plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
        f"{100 * b_ms / ms:.1f} % of it (float32 bound {b32_ms:.3f} ms, "
        f"{b32_by}); {occ}; {launches['rabitq_distance']['rabitq_distance']}"
        " launches per estimated scan")
    records.append(dict(
        name="rabitq_distance", route="cuda",
        source="src/repro_torch/csrc/rabitq_distance.cu",
        replaces="src/repro/kernels/rabitq_dot/rabitq_kernel.py:172",
        launches=launches["rabitq_distance"]["rabitq_distance"],
        max_abs_err=errs["err6"], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, ms_median=med, ms_min=lo, ms_max=hi,
        bound_f32_ms=b32_ms, bound_f32_by=b32_by, **occ))
    torch.cuda.empty_cache()

    # ---- rabitq_gather_distance on the frontier's gathered codes
    fl = frontier.long()
    args5 = (codes.packed[fl].contiguous(), codes.data_add[fl],
             codes.data_rescale[fl], rq.q_rot, rq.query_add, rq.query_sumq)

    def gather():
        return rabitq_gather_distance(*args5, bits=bits)

    ms = cuda_ms(gather, 20)
    # the kernel alone, replayed from a CUDA graph (`ms` above is launched
    # from the wrapper, whose host path may be the longer of the two)
    graph = graph_of(gather)
    g_ms = cuda_ms(graph.replay, 20)
    g_med, g_lo, g_hi = cuda_ms_each(graph.replay, 20)
    del graph
    plain_ms = cuda_ms(lambda: rabitq_gather_distance_plain(*args5,
                                                            bits=bits), 5)
    b_ms, b_by = kc.rabitq_gather_distance(n_q, k, p, d).bound()
    occ = estimator_occupancy("rabitq_gather_distance", bits, p)
    check(occ["spill_stores"] == 0 and occ["local_bytes"] == 0,
          f"rabitq_gather_distance spills: {occ}")
    log(f"  rabitq_gather_distance ({n_q}, {k}, P={p}): {ms:.4f} ms launched "
        f"from the wrapper (mean of 20); replayed from a CUDA graph (the "
        f"kernel alone) {g_ms:.4f} ms, median of 20 {g_med:.4f} (min "
        f"{g_lo:.4f}, max {g_hi:.4f}); plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / g_med:.1f} % of it at the "
        f"graph median; {occ}; no search lane launches it (1 launch in the "
        "counted frontier re-estimate)")
    records.append(dict(
        name="rabitq_gather_distance", route="cuda",
        source="src/repro_torch/csrc/rabitq_distance.cu",
        replaces="src/repro/kernels/rabitq_dot/rabitq_kernel.py:97",
        launches=launches["rabitq_gather_distance"]["rabitq_gather_distance"],
        max_abs_err=errs["err5"], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, ms_graph=g_ms,
        ms_graph_median=g_med, ms_graph_min=g_lo, ms_graph_max=g_hi,
        bound_share_graph_median=b_ms / g_med, **occ))

    # ---- gather_l2_tiled at the rerank's shape, beside gather_l2
    real_q = q_dev
    got = gather_l2_tiled(real_q, core.vectors, core.vec_sqnorm, frontier)
    check(torch.equal(got, gather_l2_plain(real_q, core.vectors,
                                           core.vec_sqnorm, frontier))
          and torch.equal(got, gather_l2(real_q, core.vectors,
                                         core.vec_sqnorm, frontier)),
          "gather_l2_tiled not bit-equal to gather_l2_plain and gather_l2 "
          "on integer rows")
    got = gather_l2_tiled(noisy_q, core.vectors, core.vec_sqnorm, frontier)
    want = gather_l2_plain(noisy_q, core.vectors, core.vec_sqnorm, frontier)
    terms = ((noisy_q * noisy_q).sum(-1, keepdim=True)
             + core.vec_sqnorm[fl])
    err8 = float((got - want).abs().max())
    check(bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-6 * terms)
               .all()), f"gather_l2_tiled realistic: max |err| {err8}")
    ms = cuda_ms(lambda: gather_l2_tiled(real_q, core.vectors,
                                         core.vec_sqnorm, frontier), 20)
    chunked_ms = cuda_ms(lambda: gather_l2(real_q, core.vectors,
                                           core.vec_sqnorm, frontier), 20)
    plain_ms = cuda_ms(lambda: gather_l2_plain(real_q, core.vectors,
                                               core.vec_sqnorm, frontier), 5)
    flat = fl.reshape(-1)

    def yardstick():
        cand = core.vectors.index_select(0, flat).view(n_q, k, d)
        return torch.bmm(cand, real_q[:, :, None])

    lib_ms = cuda_ms(yardstick, 20)
    b_ms, b_by = kc.gather_l2(n_q, k, d, n_valid=frontier.numel()).bound()
    tiled_launches = launches["tiled"]["gather_l2_tiled"]
    log(f"  gather_l2_tiled ({n_q}, {k}): {ms:.4f} ms, gather_l2 (chunked) "
        f"on the same inputs {chunked_ms:.4f} ms ({ms / chunked_ms:.2f}x), "
        f"plain {plain_ms:.4f} ms, index_select+bmm {lib_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), max |err| {err8:.3g}; {tiled_launches} "
        "launches per tiled-lane search")
    records.append(dict(
        name="gather_l2_tiled", route="cuda",
        source="src/repro_torch/csrc/gather_l2_tiled.cu",
        replaces="src/repro/kernels/distance/distance_kernel.py:90",
        launches=tiled_launches, max_abs_err=err8, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    return records


def exact_and_scans(idx, q_dev, gt, gt_d, quant, gen) -> tuple[list, dict]:
    """Phase 7, on phase 4's index before the churn round: the exact
    lanes, both full scans, #5 on the frontier; the four kernel records,
    and the exact-mode `fused_search` times for its record."""
    from repro_torch.core.rabitq import rabitq_preprocess_query
    from repro_torch.kernels.search_step.ops import fused_operands, fused_search
    core = idx.core
    launches = exact_lanes(idx, q_dev, gt, quant)
    rq = rabitq_preprocess_query(core.rq_params, q_dev)
    ops = fused_operands(core.graph, beam_width=64, max_iters=140,
                         codes=core.codes, rq_query=rq)
    frontier = fused_search(**ops)[0]
    exact_ops = fused_operands(core.graph, beam_width=64, max_iters=140,
                               queries=q_dev, vectors=core.vectors,
                               vec_sqnorm=core.vec_sqnorm)
    exact_ms = cuda_ms(lambda: fused_search(**exact_ops), 3)
    exact = cuda_ms_each(lambda: fused_search(**exact_ops), 10)
    log(f"  fused_search kernel alone: exact {exact_ms:.3f} ms (median of 10 "
        f"{exact[0]:.3f}, min {exact[1]:.3f}, max {exact[2]:.3f}), quantized "
        f"{cuda_ms(lambda: fused_search(**ops), 3):.3f} ms")
    scan_launches, errs = full_scans(idx, q_dev, rq, gt, gt_d, frontier, gen)
    launches.update(scan_launches)
    return scan_kernels_at_main_shapes(core, q_dev, rq, frontier, launches,
                                       errs, gen), dict(
        exact_ms=exact_ms, exact_ms_median=exact[0], exact_ms_min=exact[1],
        exact_ms_max=exact[2])


# ------------------------------------------------------------ churn round
CHURN_LANES = {
    "megakernel": dict(fusion="megakernel"),
    "hop": dict(fusion="hop"),
    "merge-kernel": dict(fusion="none", merge="kernel"),
    # the merge-kernel lane's twin with the stable-sort merge: same scorer,
    # so the two must agree bit for bit
    "topk-merge": dict(fusion="none", merge="topk"),
}


def churn_searches(idx, q_dev, gt, stage: str) -> dict:
    """Every churn lane in both traversal modes, each search between
    zeroed and read launch counters. Checks recall, zero tombstoned ids,
    exact launch counts and the two bit-equalities; returns {lane:
    launches} of the traverse_deleted=True searches."""
    from repro_torch.core.search_spec import SearchSpec
    first = {}
    for traverse in (True, False):
        res = {}
        for lane, kw in CHURN_LANES.items():
            searcher = idx.searcher(SearchSpec(
                k=10, beam_width=64, quantized=True, use_kernels=True,
                traverse_deleted=traverse, **kw))
            out, secs, launched = counted(lambda: searcher.search(q_dev))
            ids = out.ids.cpu().numpy()
            dead = int(idx.tombstoned(ids[ids >= 0]).sum())
            rec = recall_at(out.ids, gt)
            iters = int(out.n_hops.max())
            log(f"    {stage} {lane:12s} traverse_deleted={traverse!s:5}: "
                f"{secs:.3f} s ({q_dev.shape[0] / secs:.0f} QPS), recall@10 "
                f"{rec:.4f}, mean hops {float(out.n_hops.float().mean()):.2f}"
                f", tombstoned ids {dead}, launches {launched}")
            check(dead == 0, f"{lane} returned {dead} tombstoned ids")
            check(rec >= RECALL_FLOOR, f"{lane} recall {rec:.4f} < "
                  f"{RECALL_FLOOR}")
            want = {
                "megakernel": counts(fused_search=1, gather_l2=1),
                "hop": counts(fused_hop=iters, gather_l2=1),
                "merge-kernel": counts(topk=iters, gather_l2=1,
                                       rabitq_search_step=iters + 1),
                "topk-merge": counts(gather_l2=1,
                                     rabitq_search_step=iters + 1),
            }[lane]
            check(launched == want, f"{lane} launched {launched}, expected "
                  f"{want}")
            res[lane] = out
            if traverse:
                first[lane] = launched
        for a, b in (("hop", "megakernel"), ("merge-kernel", "topk-merge")):
            x, y = res[a], res[b]
            same = (torch.equal(x.ids, y.ids) and torch.equal(x.dists, y.dists)
                    and torch.equal(x.n_hops, y.n_hops))
            check(same, f"{stage}: {a} lane differs from the {b} lane (ids "
                  f"agree {float((x.ids == y.ids).float().mean()):.4f})")
        log(f"    {stage}: hop == megakernel and merge-kernel == topk-merge "
            f"bit for bit (traverse_deleted={traverse})")
    return first


def grow_checker(idx) -> dict:
    """Wrap `idx.grow` (the insert's auto-grow calls it) so that it checks
    the resident prefix of every buffer byte-identical and the new tail
    at its fill value, and times the copy. Returns the record it fills."""
    info = {}
    orig = idx.grow

    def grow(new_capacity=None):
        old = idx.core
        t0 = time.perf_counter()
        orig(new_capacity)
        torch.cuda.synchronize()
        info["secs"] = time.perf_counter() - t0
        new = idx.core
        info["capacity"] = (old.capacity, new.capacity)
        for name, a, b, fill in (
                ("vectors", old.vectors, new.vectors, 0),
                ("vec_sqnorm", old.vec_sqnorm, new.vec_sqnorm, 0),
                ("adjacency", old.adjacency, new.adjacency, -1),
                ("packed codes", old.codes.packed, new.codes.packed, 0),
                ("data_add", old.codes.data_add, new.codes.data_add, 0),
                ("data_rescale", old.codes.data_rescale,
                 new.codes.data_rescale, 0),
                ("tombstone bits", old.mut.tombstone_bits,
                 new.mut.tombstone_bits, 0),
                ("labels", old.mut.labels, new.mut.labels, 0),
                ("free ids", old.mut.free_ids, new.mut.free_ids, -1)):
            n = a.shape[0]
            check(torch.equal(b[:n], a), f"grow changed the prefix of {name}")
            check(bool((b[n:] == fill).all()),
                  f"grow's new tail of {name} is not {fill}")
        return idx

    idx.grow = grow
    return info


def churn_round(idx, q_dev, n_rows: int, recall_before: float) -> dict:
    """Phase 6: delete 1 % -> search -> consolidate -> insert 2 % (slot
    reuse + auto-grow) -> search. Returns {lane: launches} of the first
    search of each lane."""
    from repro_torch.core.vamana import validate_graph
    from repro_torch.data.synthetic import ANNS_DATASETS, make_anns_dataset
    gen = torch.Generator().manual_seed(SEED + 3)
    core = idx.core
    n_del = n_rows // 100
    perm = torch.randperm(n_rows, generator=gen)
    dead = torch.sort(perm[:n_del]).values.numpy()
    keep = perm[n_del:n_del + 1000].to(core.device)    # untouched live rows
    kept = (core.codes.packed[keep].clone(), core.codes.data_add[keep].clone(),
            core.vectors[keep].clone())

    t0 = time.perf_counter()
    n = idx.delete(dead)
    torch.cuda.synchronize()
    log(f"  delete {n_del} rows: {time.perf_counter() - t0:.3f} s; size "
        f"{idx.size}, n_deleted {idx.n_deleted}")
    check(n == n_del and idx.n_deleted == n_del
          and idx.size == n_rows - n_del, "delete counts disagree")
    gt, _ = idx.brute_force(q_dev, 10)
    launches = churn_searches(idx, q_dev, gt, "after delete")

    t0 = time.perf_counter()
    stats = idx.consolidate()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"  consolidate (refine=True): {secs:.2f} s, {stats}")
    check(stats["n_freed"] == n_del, f"consolidate freed {stats['n_freed']}")
    live = torch.as_tensor(idx.live_mask()).to(core.device)
    checks = {k: bool(v) for k, v in validate_graph(idx.graph, live).items()}
    check(all(checks.values()), f"validate_graph after consolidate: {checks}")
    rec = idx.recall(q_dev, 10, spec=_mk_spec())
    log(f"  recall@10 (megakernel lane) after consolidate {rec:.4f}, before "
        f"the delete {recall_before:.4f}; validate_graph {checks}")
    check(rec >= RECALL_FLOOR, f"recall after consolidate {rec:.4f}")

    new = make_anns_dataset(ANNS_DATASETS["bigann"], n=2 * n_del,
                            seed=SEED + 2)
    grown = grow_checker(idx)
    t0 = time.perf_counter()
    ids = idx.insert(new)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"  insert {2 * n_del} rows: {secs:.2f} s ({2 * n_del / secs:.0f} "
        f"rows/s), of which the grow {grown.get('secs', 0):.3f} s "
        f"(capacity {grown.get('capacity')}); size {idx.size}")
    want_ids = np.concatenate([dead, np.arange(n_rows, n_rows + n_del)])
    check(np.array_equal(ids, want_ids),
          "insert did not reuse the freed slots in ascending order, then "
          "the fresh tail")
    check(idx.capacity == 2 * n_rows and "capacity" in grown,
          f"capacity {idx.capacity}: the insert did not auto-grow")
    check(idx.size == n_rows + n_del, f"size {idx.size} after insert")
    core = idx.core
    check(torch.equal(core.codes.packed[keep], kept[0])
          and torch.equal(core.codes.data_add[keep], kept[1])
          and torch.equal(core.vectors[keep], kept[2]),
          "codes or rows of untouched live rows changed")
    log("  1,000 untouched live rows: packed codes, metadata and rows "
        "byte-equal across the round; every buffer's resident prefix "
        "byte-identical across the grow")
    self_q = torch.as_tensor(new[:n_del]).to(core.device)
    res = idx.searcher(_mk_spec(k=1)).search(self_q)
    hit = float((res.ids[:, 0].cpu().numpy() == dead).mean())
    log(f"  self-queries of the {n_del} reused-slot rows: {hit:.4f} find "
        "themselves at k=1")
    check(hit >= SELF_HIT_FLOOR, f"reused rows found themselves on {hit:.4f}")
    gt, _ = idx.brute_force(q_dev, 10)
    churn_searches(idx, q_dev, gt, "after insert")
    return launches


def _mk_spec(k: int = 10):
    from repro_torch.core.search_spec import SearchSpec
    return SearchSpec(k=k, beam_width=64, quantized=True, use_kernels=True,
                      fusion="megakernel")


# ------------------------------------------------- ANNS serving (phase 10)
SERVE_ARRIVALS = 20_000        # arrivals a serving trace
SERVE_SLO_S = 0.100            # the realtime replays' per-query budget
SERVE_TICKS = 20               # service ticks of churn + search
TICK_QUERIES = 1_000
TENANT_ROWS = 10_000
SERVE_CHECK_ROWS = 256         # coalesced results checked against solo ones


def _serving_specs():
    from repro_torch.core.search_spec import SearchSpec
    main = _mk_spec()
    exact = SearchSpec(k=10, beam_width=64, fusion="megakernel")
    return main, exact


def _same_as_eager(idx, res, spec, q) -> bool:
    """A session's result equals `core_search` run eagerly on the index's
    core, bit for bit (ids, dists, hops and any telemetry)."""
    from repro_torch.core.index_core import core_search
    want = core_search(idx.core, q, spec=spec.resolve(idx),
                       filter_tombstones=idx._filter_tombstones)
    same = (torch.equal(res.ids, want[0]) and torch.equal(res.dists, want[1])
            and torch.equal(res.n_hops, want[2]))
    if len(want) > 3:
        same = same and all(torch.equal(a, b)
                            for a, b in zip(res.telemetry, want[3]))
    return same


def _host_ms(fn, reps: int = 10) -> float:
    """Mean synchronised host-clock time of fn() (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def plans_on_the_main_spec(idx, q_dev, phase4_profile) -> dict:
    """Phase 10 (a): the main spec's plan is a captured CUDA graph."""
    from repro_torch.core.index_core import core_search
    from repro_torch.core.plans import GraphPlan
    main, _ = _serving_specs()
    tel = main.with_(telemetry="on")
    idx.plans.clear()              # earlier phases' plans; stats stay
    before = idx.plans.stats.snapshot()
    ses = idx.searcher(main)
    res, secs, launched = counted(lambda: ses.search(q_dev))
    delta = idx.plans.stats.delta(before)
    log(f"  first search (captures): {secs:.3f} s, plan cache {delta}, "
        f"launches {launched}")
    check(delta["misses"] == 1 and delta["traces"] == 1,
          f"the first search did not capture once: {delta}")
    want = counts(fused_search=1, gather_l2=1)
    check(launched == want, f"a captured search counted {launched}, "
          f"expected {want}")
    check(_same_as_eager(idx, res, main, q_dev),
          "the captured search differs from an eager search")
    for _ in range(3):
        res, _, launched = counted(lambda: ses.search(q_dev))
        check(launched == want, f"a replay counted {launched}")
        check(_same_as_eager(idx, res, main, q_dev),
              "a replay differs from an eager search")
    delta = idx.plans.stats.delta(before)
    check(delta["hits"] == 3 and delta["misses"] == 1
          and delta["traces"] == 1, f"three more searches: {delta}")
    plan = idx._search_plan(ses.resolved, tuple(q_dev.shape),
                            idx._filter_tombstones)
    check(isinstance(plan, GraphPlan) and plan._graph is not None,
          "the main spec's plan is not a captured CUDA graph")
    tses = idx.searcher(tel)
    for _ in range(2):
        check(_same_as_eager(idx, tses.search(q_dev), tel, q_dev),
              "a telemetry replay differs from an eager search")
    log(f"  3 replays + telemetry spec: ids, dists, hops and counters "
        f"bit-equal to eager core_search; plan cache {delta}")
    rspec = main.resolve(idx)
    eager_ms = _host_ms(lambda: core_search(
        idx.core, q_dev, spec=rspec, filter_tombstones=idx._filter_tombstones))
    replay_ms = _host_ms(lambda: ses.search(q_dev))
    prof = {}
    profile_device(lambda: ses.search(q_dev), "phase 10, one replayed search",
                   stats=prof)
    log(f"  10,000 queries, synchronised host clock, mean of 10: eager "
        f"{eager_ms:.3f} ms, replayed {replay_ms:.3f} ms; device busy "
        f"{_share(prof)} of a replay against {_share(phase4_profile)} of "
        "phase 4's eager search")
    return dict(eager_ms=eager_ms, replay_ms=replay_ms, replay_profile=prof,
                eager_profile=phase4_profile)


def search_roofline(idx, q_dev, replay_ms: float) -> dict:
    """Phase 16 (a), on phase 10 (a)'s index: the main search (10,000
    queries, the main spec with telemetry, so #1's formula reads the
    walk's hops and scored candidates) once eagerly under the analyzer,
    against phase 10's replayed search (mean of 10)."""
    from repro_torch.core.index_core import core_search
    main, _ = _serving_specs()
    tel = main.with_(telemetry="on").resolve(idx)
    return roofline_share(
        f"the main search ({q_dev.shape[0]} queries) against phase 10's "
        "replay", lambda: core_search(
            idx.core, q_dev, spec=tel,
            filter_tombstones=idx._filter_tombstones), replay_ms / 1e3,
        want_kernels={"fused_search": 1, "gather_l2": 1})


def _share(prof: dict) -> str:
    if not prof or prof.get("share") is None:
        return "not measured"
    return (f"{100 * prof['share']:.1f}% ({prof['busy_us']:.0f} of "
            f"{prof['wall_us']:.0f} us)")


def mutations_under_plans(idx, q_dev) -> dict:
    """Phase 10 (b): delete, insert and consolidate under captured plans,
    then a grow."""
    from repro_torch.data.synthetic import ANNS_DATASETS, make_anns_dataset
    specs = _serving_specs()
    gen = torch.Generator().manual_seed(SEED + 10)

    def replays(step: str) -> None:
        for spec in specs:
            res = idx.searcher(spec).search(q_dev)
            ids = res.ids.cpu().numpy()
            dead = int(idx.tombstoned(ids[ids >= 0]).sum())
            check(dead == 0, f"{step}: {dead} tombstoned ids")
            check(_same_as_eager(idx, res, spec, q_dev),
                  f"{step}: a replay differs from an eager search")

    live = np.flatnonzero(idx.live_mask())
    perm = torch.randperm(live.size, generator=gen).numpy()
    # the liveness mode (part of a plan's key, as in the JAX package) is
    # "filter" from here on: ten tombstones before the plans are taken
    idx.delete(np.sort(live[perm[:10]]))
    dead = np.sort(live[perm[10:1010]])
    replays("before")
    base = idx.plans.stats.snapshot()
    rows = make_anns_dataset(ANNS_DATASETS["bigann"], n=1000, seed=SEED + 4)
    steps = (("delete 1,000", lambda: idx.delete(dead)),
             ("insert 1,000", lambda: idx.insert(rows)),
             ("consolidate", lambda: idx.consolidate()))
    out = {}
    for step, fn in steps:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[step] = time.perf_counter() - t0
        replays(step)
        delta = idx.plans.stats.delta(base)
        check(delta["traces"] == 0, f"{step} recaptured a plan: {delta}")
        log(f"  {step}: {out[step]:.3f} s; replays of both specs bit-equal to"
            f" eager, no tombstoned id, no recapture ({delta})")
    cap = idx.capacity
    idx.grow()
    replays("grow")
    delta = idx.plans.stats.delta(base)
    check(delta["traces"] == len(specs) and delta["misses"] == 0,
          f"the grow recaptured {delta['traces']} plans for {len(specs)} "
          f"specs: {delta}")
    log(f"  grow {cap} -> {idx.capacity}: one recapture a spec ({delta}); "
        "replays bit-equal to eager")
    return out


def submit_and_drain(idx, q_dev) -> None:
    """Phase 10 (c): submit 4 x 2,500 queries, insert, drain."""
    from repro_torch.data.synthetic import ANNS_DATASETS, make_anns_dataset
    main, _ = _serving_specs()
    ses = idx.searcher(main)
    parts = q_dev.split(2500)[:4]
    refs = [ses.search(p) for p in parts]
    gen = idx.generation
    for p in parts:
        ses.submit(p)
    idx.insert(make_anns_dataset(ANNS_DATASETS["bigann"], n=1000,
                                 seed=SEED + 5))
    out = ses.drain()
    check(idx.generation > gen, "the insert did not advance the generation")
    for r, ref in zip(out, refs):
        check(r.generation == gen, f"drained generation {r.generation}, "
              f"submitted at {gen}")
        check(np.array_equal(r.ids, ref.ids.cpu().numpy())
              and np.array_equal(r.dists, ref.dists.cpu().numpy())
              and np.array_equal(r.n_hops, ref.n_hops.cpu().numpy()),
              "a drained batch differs from the search at its generation")
    log(f"  submit 4 x 2,500, insert 1,000, drain: equal to the searches at "
        f"generation {gen} and stamped with it (now {idx.generation})")


def _serve_line(what: str, rep: dict) -> str:
    return (f"  {what}: {rep['qps']:.0f} QPS, p50 {rep['p50_ms']:.3f} ms, "
            f"p99 {rep['p99_ms']:.3f} ms, SLO hit {rep['slo_hit_rate']:.4f},"
            f" completed {rep['completed']}, rejected {rep['rejected']}, "
            f"batches {rep['batches']}, flush {rep['flush_reasons']}, "
            f"occupancy {rep['mean_batch_occupancy']}")


def scheduler_serving(idx, pool: np.ndarray) -> tuple[dict, object]:
    """Phase 10 (d): the standing-query scheduler over two lanes."""
    from repro_torch.core.search_spec import BUCKET_LADDER
    from repro_torch.serving.anns_service import AnnsService
    from repro_torch.serving.loadgen import bursty_trace, poisson_trace
    main, exact = _serving_specs()
    lanes = {"exact": exact}
    svc = AnnsService(idx, spec=main, verify=True)
    svc.metrics()
    t0 = time.perf_counter()
    for spec in (main, exact):
        ses = idx.searcher(spec)
        for b in BUCKET_LADDER:
            ses.search(pool[:b])
    torch.cuda.synchronize()
    log(f"  warm-up of 2 lanes x {len(BUCKET_LADDER)} rungs: "
        f"{time.perf_counter() - t0:.2f} s")
    before = idx.plans.stats.snapshot()
    reports = {}

    def serve(name, trace, realtime, **cfg):
        rep, handles = svc.serve(trace, pool, lanes=lanes, realtime=realtime,
                                 **cfg)
        check(rep["completed"] + rep["rejected"] == len(trace),
              f"{name}: completed + rejected != arrivals")
        check(sum(rep["flush_reasons"].values()) == rep["batches"],
              f"{name}: the flush reasons do not add up to the batches")
        done = [h for h in handles if h.status == "done"]
        ids = np.concatenate([h.ids for h in done])
        check(not idx.tombstoned(ids[ids >= 0]).any(),
              f"{name}: a tombstoned id")
        reports[name] = {k: rep[k] for k in (
            "qps", "p50_ms", "p99_ms", "slo_hit_rate", "completed",
            "rejected", "batches", "flush_reasons", "mean_batch_occupancy",
            "wall_s")}
        log(_serve_line(name, rep))
        return rep

    sat = poisson_trace(1e6, SERVE_ARRIVALS, n_queries=pool.shape[0], seed=0,
                        slo_budget_s=10.0)
    for name, buckets in (("saturation buckets=(1,)", (1,)),
                          ("saturation ladder", BUCKET_LADDER)):
        serve(name, sat, False, buckets=buckets,
              max_queue=SERVE_ARRIVALS + 1, slo_budget_s=10.0)
    rate = 0.5 * reports["saturation ladder"]["qps"]
    mix = dict(n_queries=pool.shape[0], slo_budget_s=SERVE_SLO_S,
               lanes=("default", "exact"), lane_weights=(0.7, 0.3))
    serve(f"poisson {rate:.0f} QPS", poisson_trace(
        rate, SERVE_ARRIVALS, seed=1, **mix), True, buckets=BUCKET_LADDER,
        slo_budget_s=SERVE_SLO_S)
    serve(f"bursty {rate:.0f} QPS, burst x8", bursty_trace(
        rate, SERVE_ARRIVALS, burst_factor=8.0, seed=2, **mix), True,
        buckets=BUCKET_LADDER, slo_budget_s=SERVE_SLO_S)
    delta = idx.plans.stats.delta(before)
    check(delta["traces"] == 0 and delta["misses"] == 0,
          f"serving after the warm-up traced or missed: {delta}")
    # coalesced results against the same queries alone, same bucket
    top = BUCKET_LADDER[-1]
    sched = svc.scheduler(buckets=(top,), slo_budget_s=10.0)
    handles = [sched.submit(q) for q in pool[:SERVE_CHECK_ROWS]]
    sched.drain()
    solo = svc.scheduler(buckets=(top,), slo_budget_s=10.0)
    for i, h in enumerate(handles):
        solo.submit(pool[i])
        (s,) = solo.drain()
        check(h.status == "done" and np.array_equal(h.ids, s.ids)
              and np.array_equal(h.dists, s.dists) and h.n_hops == s.n_hops,
              f"coalesced query {i} differs from its solo dispatch")
    log(f"  plan cache over the four replays {delta}; {SERVE_CHECK_ROWS} "
        f"coalesced results bit-equal to solo dispatches in the {top}-bucket")
    reports["plan_cache"] = delta
    return reports, svc


def service_ticks(idx, q_dev, pool: np.ndarray) -> dict:
    """Phase 10 (e): `run` over ticks of churn + search, then tenants."""
    from repro_torch.data.synthetic import ANNS_DATASETS, make_anns_dataset
    from repro_torch.serving.anns_service import AnnsService
    main, _ = _serving_specs()
    svc = AnnsService(idx, spec=main, consolidate_threshold=0.012,
                      verify=True)
    svc.metrics()
    gen = torch.Generator().manual_seed(SEED + 11)
    n_tick = idx.size // 1000
    queries = pool[:TICK_QUERIES]
    new = make_anns_dataset(ANNS_DATASETS["bigann"], n=n_tick * SERVE_TICKS
                            + 2 * TENANT_ROWS, seed=SEED + 6)

    def pick(n):
        live = np.flatnonzero(idx.live_mask())
        return np.sort(live[torch.randperm(live.size, generator=gen)[:n]
                            .numpy()])

    svc.delete(pick(10))           # the liveness mode of the ticks
    svc.search(queries)            # ... and its plan, captured
    before = idx.plans.stats.snapshot()
    t0 = time.perf_counter()
    gens, cons = [], []
    for t in range(SERVE_TICKS):
        n_cons = svc.stats.n_consolidations
        out = svc.run([("delete", pick(n_tick)),
                       ("insert", new[t * n_tick:(t + 1) * n_tick]),
                       ("search", queries)])
        gens.append(out[-1].generation)
        if svc.stats.n_consolidations > n_cons:
            cons.append(t)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    delta = idx.plans.stats.delta(before)
    check(all(b > a for a, b in zip(gens, gens[1:])),
          f"generation stamps do not increase: {gens}")
    check(cons, "no auto-consolidate fired in the ticks")
    check(delta["traces"] == 0, f"the ticks recaptured a plan: {delta}")
    rec = idx.recall(q_dev[:2000], 10, spec=main)
    log(f"  {SERVE_TICKS} ticks of delete {n_tick} / insert {n_tick} / search "
        f"{TICK_QUERIES}: {secs:.2f} s; auto-consolidate at ticks {cons}; "
        f"generations {gens[0]} .. {gens[-1]}; plan cache {delta}; recall@10 "
        f"(2,000 queries, brute force over the live rows) {rec:.4f}")
    check(rec >= RECALL_FLOOR, f"recall after the ticks {rec:.4f}")
    tenants = {}
    for i, name in enumerate(("acme", "beta")):
        svc.register_tenant(name)
        rows = new[SERVE_TICKS * n_tick + i * TENANT_ROWS:][:TENANT_ROWS]
        tenants[name] = svc.tenant_insert(name, rows)
    own = {}
    for name, ids in tenants.items():
        for mode in ("traverse", "exclude"):
            t = svc.tenant_search(name, queries, filter_mode=mode)
            got = t.ids[t.ids >= 0]
            check(np.isin(got, ids).all(),
                  f"tenant {name} ({mode}) got another tenant's rows")
            own[f"{name}/{mode}"] = int(got.size)
    log(f"  two tenants of {TENANT_ROWS} rows: tenant_search returns only "
        f"their own rows (results a {TICK_QUERIES}-query batch: {own})")
    return dict(seconds=secs, consolidated_at=cons, recall=rec,
                generations=(gens[0], gens[-1]), tenant_results=own,
                service=svc)


def anns_serving(idx, q_dev, phase4_profile, smi: str) -> dict:
    """Phase 10 on phase 6's index: plans, mutations under plans,
    submit/drain, the scheduler, service ticks and the metrics."""
    from repro_torch import obs
    t_phase = time.perf_counter()
    pool = q_dev.cpu().numpy()
    tracer = obs.SpanTracer()
    out = {"device": smi}
    with obs.use_tracer(tracer):
        log("  (a) plans on the main spec")
        out["plans"] = plans_on_the_main_spec(idx, q_dev, phase4_profile)
        ROOFLINE["search"] = search_roofline(idx, q_dev,
                                             out["plans"]["replay_ms"])
        log("  (b) mutations under captured plans")
        out["mutations_s"] = mutations_under_plans(idx, q_dev)
        log("  (c) submit and drain")
        submit_and_drain(idx, q_dev)
        log("  (d) the standing-query scheduler: lanes default + exact")
        out["scheduler"], sched_svc = scheduler_serving(idx, pool)
        log("  (e) service ticks")
        ticks = service_ticks(idx, q_dev, pool)
    svc = ticks.pop("service")
    out["ticks"] = ticks
    # (f) the metrics plane: the ticks' service and the scheduler's
    snap = dict(sched_svc.metrics_snapshot())
    snap.update(svc.metrics_snapshot())
    spaces = sorted({k.split(".")[0] for k in snap})
    log(f"  (f) metrics_snapshot namespaces {spaces}; keys "
        f"{sorted(snap)}")
    for ns in ("service", "plan_cache", "scheduler", "search", "tenants"):
        check(ns in spaces, f"metrics_snapshot has no {ns}.* keys")
    summary = tracer.summary()
    log("  span summary: " + ", ".join(
        f"{name} {s['count']}x mean {s['mean_us']:.0f} us"
        for name, s in sorted(summary.items())))
    out["spans"] = {k: v["count"] for k, v in summary.items()}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 10: {out['seconds']:.1f} s")
    print(json.dumps({"serving": out}, default=float), flush=True)
    return out


# ------------------------------------------------ host rows tier (phase 11)
HOST_SPLIT_REPS = 10           # host-tier searches in the time split


def _host_lanes() -> dict:
    """Phase 11's lanes: the device-tier specs; each host-tier spec is the
    same with rerank_source="host"."""
    main = _mk_spec()
    return {"megakernel": main,
            "hop": main.with_(fusion="hop"),
            "merge-kernel": main.with_(fusion="none", merge="kernel"),
            "telemetry": main.with_(telemetry="on"),
            "filtered": main.with_(filter=(0,), filter_mode="exclude")}


def _same_result(a, b) -> bool:
    """Two SearchResults bit-equal in ids, dists, hops and telemetry."""
    same = (torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
            and torch.equal(a.n_hops, b.n_hops))
    if a.telemetry is not None or b.telemetry is not None:
        same = same and all(torch.equal(x, y)
                            for x, y in zip(a.telemetry, b.telemetry))
    return same


def _device_twin(idx, specs: dict, q_dev) -> dict:
    """The same searches on the device tier: restore, search, evict."""
    idx.restore_rows_to_device()
    out = {name: idx.searcher(spec).search(q_dev)
           for name, spec in specs.items()}
    idx.evict_rows_to_host()
    return out


def host_tier_evict(idx) -> dict:
    """Phase 11 (a): evict the rows; device memory and tier statistics."""
    cap, d = idx.capacity, idx.store_dims
    rows_bytes = cap * (d + 1) * 4
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    idx.evict_rows_to_host()
    secs = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    ms = idx.memory_stats()
    codes = ms["device_codes_bytes"]
    log(f"  evict: {secs:.3f} s; device memory in use {before / 1e9:.3f} -> "
        f"{after / 1e9:.3f} GB (fell {(before - after) / 1e9:.3f} GB; the "
        f"rows are {rows_bytes / 1e9:.3f} GB: {cap} x ({d} + 1) x 4 B); "
        f"memory_stats: device rows {ms['device_rows_bytes']:.0f} B, device "
        f"codes {codes:.0f} B, host rows {ms['host_rows_bytes']:.0f} B, "
        f"device compression {ms['device_compression_ratio']:.3f}x")
    check(idx.rows_tier == "host" and idx.vectors is None,
          "the rows are still on the card")
    check(idx.store._vectors.is_pinned(), "the host rows are not pinned")
    check(ms["device_rows_bytes"] == 0.0
          and ms["host_rows_bytes"] == rows_bytes,
          f"tier statistics after the eviction: {ms}")
    check(ms["device_compression_ratio"] == (rows_bytes + codes) / codes,
          "device_compression_ratio is not (rows + codes) / codes")
    check(before - after >= 0.95 * rows_bytes,
          f"eviction freed {before - after} B of device memory, less than "
          f"0.95 x the rows' {rows_bytes} B")
    return dict(evict_s=secs, before_gb=before / 1e9, after_gb=after / 1e9,
                rows_gb=rows_bytes / 1e9,
                compression=ms["device_compression_ratio"])


def host_tier_identity(idx, q_dev) -> dict:
    """Phase 11 (b): every lane's host-tier search bit-equal to the same
    search on the device tier; launches a host-tier search."""
    specs = _host_lanes()
    host, launched = {}, {}
    for name, spec in specs.items():
        ses = idx.searcher(spec.with_(rerank_source="host"))
        ses.search(q_dev)                                # both stages
        host[name], secs, launched[name] = counted(
            lambda: ses.search(q_dev))
        log(f"  host tier, {name}: {secs:.3f} s, launches "
            f"{ {k: v for k, v in launched[name].items() if v} }")
    device = _device_twin(idx, specs, q_dev)
    for name in specs:
        check(_same_result(host[name], device[name]),
              f"host tier {name} differs from the device tier")
        ids = host[name].ids.cpu().numpy()
        check(not idx.tombstoned(ids[ids >= 0]).any(),
              f"host tier {name}: a tombstoned id")
    filt = host["filtered"].ids
    log(f"  host == device bit for bit (ids, dists, hops, telemetry) on "
        f"{', '.join(specs)}; the filtered lane returned "
        f"{int((filt >= 0).sum())} ids")
    iters = {n: int(host[n].n_hops.max()) for n in ("hop", "merge-kernel")}
    want = {"megakernel": counts(fused_search=1, gather_l2=1),
            "telemetry": counts(fused_search=1, gather_l2=1),
            "filtered": counts(fused_search=1, gather_l2=1),
            "hop": counts(fused_hop=iters["hop"], gather_l2=1),
            "merge-kernel": counts(topk=iters["merge-kernel"],
                                   rabitq_search_step=1
                                   + iters["merge-kernel"], gather_l2=1)}
    for name, w in want.items():
        check(launched[name] == w, f"host tier {name} launched "
              f"{launched[name]}, expected {w}")
    return launched


def host_tier_split(idx, q_dev, device_replay_ms: float) -> dict:
    """Phase 11 (c): one 10,000-query host-tier search, split."""
    spec = _mk_spec().with_(rerank_source="host")
    ses = idx.searcher(spec)
    ses.search(q_dev)
    plan = idx._search_plan(ses.resolved, tuple(q_dev.shape),
                            idx._filter_tombstones)
    q = idx._prep_query(q_dev)
    parts = dict(traversal=0.0, ids_to_host=0.0, gather=0.0, upload=0.0,
                 rerank=0.0)
    for _ in range(HOST_SPLIT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plan.traversal(q)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host_ids = plan.rerank.ids_to_host(out[0])
        t2 = time.perf_counter()
        rows, sq = idx.store.gather(host_ids)
        t3 = time.perf_counter()
        plan.rerank.upload(q, out[0], rows, sq)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        plan.rerank.replay()
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                   t5 - t4)):
            parts[key] += dt * 1e3 / HOST_SPLIT_REPS
    total = _host_ms(lambda: ses.search(q_dev), reps=HOST_SPLIT_REPS)
    n_rows = int(host_ids.numel())
    gb = n_rows * (idx.store_dims + 1) * 4 / 1e9
    log(f"  one host-tier search of {q_dev.shape[0]} queries, synchronised "
        f"host clock, mean of {HOST_SPLIT_REPS}: {total:.3f} ms against the "
        f"device tier's replay {device_replay_ms:.3f} ms (phase 10); split: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
        + f" ({n_rows} rows, {gb:.3f} GB: gather {gb / parts['gather'] * 1e3:.1f}"
        f" GB/s, copy {gb / parts['upload'] * 1e3:.1f} GB/s)")
    return dict(total_ms=total, device_replay_ms=device_replay_ms,
                rows=n_rows, gb=gb, **{f"{k}_ms": v for k, v in parts.items()})


def host_tier_churn(idx, q_dev, device_insert_s: float) -> dict:
    """Phase 11 (d): delete, insert (staged), consolidate on the host
    tier: no tombstoned id, no recapture, host == device after."""
    from repro_torch.data.synthetic import ANNS_DATASETS, make_anns_dataset
    spec = _mk_spec()
    ses = idx.searcher(spec.with_(rerank_source="host"))
    ses.search(q_dev)
    base = idx.plans.stats.snapshot()
    gen = torch.Generator().manual_seed(SEED + 12)
    live = np.flatnonzero(idx.live_mask())
    dead = np.sort(live[torch.randperm(live.size, generator=gen)[:1000]
                        .numpy()])
    rows = make_anns_dataset(ANNS_DATASETS["bigann"], n=1000, seed=SEED + 12)
    out = {}
    for step, fn in (("delete 1,000", lambda: idx.delete(dead)),
                     ("insert 1,000", lambda: idx.insert(rows)),
                     ("consolidate", lambda: idx.consolidate())):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[step] = time.perf_counter() - t0
        res = ses.search(q_dev)
        ids = res.ids.cpu().numpy()
        check(not idx.tombstoned(ids[ids >= 0]).any(),
              f"host tier, {step}: a tombstoned id")
        check(idx.rows_tier == "host" and idx.vectors is None,
              f"host tier, {step}: the rows stayed on the card")
        delta = idx.plans.stats.delta(base)
        check(delta["traces"] == 0, f"host tier, {step} recaptured: {delta}")
        log(f"  {step} (staged): {out[step]:.3f} s; no tombstoned id, no "
            f"recapture ({delta})")
    device = _device_twin(idx, {"megakernel": spec}, q_dev)
    check(_same_result(res, device["megakernel"]),
          "after the churn the host tier differs from the device tier")
    log(f"  after the churn host == device bit for bit; a staged insert of "
        f"1,000 {out['insert 1,000']:.3f} s against phase 10's device-tier "
        f"insert {device_insert_s:.3f} s")
    return out


def host_tier_serving(idx, pool: np.ndarray) -> dict:
    """Phase 11 (e): `AnnsService.serve` on the host tier, saturation at
    the ladder."""
    from repro_torch.core.search_spec import BUCKET_LADDER
    from repro_torch.serving.anns_service import AnnsService
    from repro_torch.serving.loadgen import poisson_trace
    spec = _mk_spec().with_(rerank_source="host")
    svc = AnnsService(idx, spec=spec, verify=True)
    svc.metrics()
    ses = idx.searcher(spec)
    for b in BUCKET_LADDER:
        ses.search(pool[:b])
    torch.cuda.synchronize()
    before = idx.plans.stats.snapshot()
    hist0 = svc.metrics_snapshot()["storage.fetch_latency_us"]["count"]
    sat = poisson_trace(1e6, SERVE_ARRIVALS, n_queries=pool.shape[0], seed=3,
                        slo_budget_s=10.0)
    rep, handles = svc.serve(sat, pool, realtime=False,
                             buckets=BUCKET_LADDER,
                             max_queue=SERVE_ARRIVALS + 1, slo_budget_s=10.0)
    delta = idx.plans.stats.delta(before)
    check(delta["traces"] == 0 and delta["misses"] == 0,
          f"host-tier serving traced or missed after the warm-up: {delta}")
    check(rep["completed"] + rep["rejected"] == len(sat),
          "host-tier serving: completed + rejected != arrivals")
    done = [h for h in handles if h.status == "done"]
    ids = np.concatenate([h.ids for h in done])
    check(not idx.tombstoned(ids[ids >= 0]).any(),
          "host-tier serving: a tombstoned id")
    snap = svc.metrics_snapshot()
    storage = sorted(k for k in snap if k.startswith("storage."))
    fetches = snap["storage.fetch_latency_us"]["count"] - hist0
    check({"storage.rows_tier", "storage.device_rows_bytes",
           "storage.fetch_n_fetches", "storage.fetch_latency_us"}
          <= set(storage), f"the snapshot's storage keys: {storage}")
    check(snap["storage.rows_tier"] == "host", "storage.rows_tier")
    check(fetches == rep["batches"], f"storage.fetch_latency_us counted "
          f"{fetches} fetches for {rep['batches']} batches")
    log(_serve_line("host tier, saturation ladder", rep))
    log(f"  plan cache {delta}; storage keys {storage}; "
        f"storage.fetch_latency_us {fetches} entries, one a batch (mean "
        f"{snap['storage.fetch_latency_us']['mean']:.0f} us)")
    return {k: rep[k] for k in ("qps", "p50_ms", "p99_ms", "completed",
                                "rejected", "batches",
                                "mean_batch_occupancy", "wall_s")}


def host_rows_tier(idx, q_dev, phase10: dict) -> dict:
    """Phase 11 on phase 10's index: evict, bit identity, the time split,
    staged churn, host-tier serving, restore."""
    t_phase = time.perf_counter()
    pool = q_dev.cpu().numpy()
    out = {}
    log("  (a) evict the rows to pinned host memory")
    out["evict"] = host_tier_evict(idx)
    log("  (b) host tier == device tier on five lanes")
    out["launches"] = host_tier_identity(idx, q_dev)
    log("  (c) the time of a host-tier search, split")
    out["split"] = host_tier_split(idx, q_dev,
                                   phase10["plans"]["replay_ms"])
    log("  (d) staged churn")
    out["churn_s"] = host_tier_churn(idx, q_dev,
                                     phase10["mutations_s"]["insert 1,000"])
    log("  (e) host-tier serving")
    out["serving"] = host_tier_serving(idx, pool)
    t0 = time.perf_counter()
    idx.restore_rows_to_device()
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    check(idx.rows_tier == "device" and idx.vectors is not None,
          "restore left the rows on the host")
    log(f"  (f) restore: {out['restore_s']:.3f} s; device memory in use "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 11: {out['seconds']:.1f} s")
    print(json.dumps({"host_tier": out}, default=float), flush=True)
    return out


# ------------------------------------------------- the PQ baseline (phase 12)
# A second graph over 1M rows for a deprecated baseline costs more run time
# than it tells: phase 12 indexes the first 100,000 rows of phase 4's data.
PQ_ROWS = 100_000
PQ_QUERIES = 2_000
PQ_CANDIDATES = 64
# search_pq's beam: PQ's 16-byte codes order the candidates too coarsely
# for an exact rerank of a short frontier (recall@10 0.459 at beam 64 and
# 0.808 at 256 on an H100, printed beside); the check is made at beam 512
PQ_BEAMS = (64, 256)
PQ_BEAM = 512


def pq_baseline(args, q_dev) -> dict:
    """Phase 12: `JasperIndex(quantization="pq")` over the first 100,000
    rows of phase 4's data, `search_pq` recall and deletes, and Fig 12's
    per-candidate comparison: `pq_distance` against #2 and #5."""
    import warnings

    from repro_torch.core import pq as tpq
    from repro_torch.core.construction import ConstructionParams
    from repro_torch.core.index import JasperIndex
    from repro_torch.core.rabitq import (rabitq_encode,
                                         rabitq_preprocess_query,
                                         rabitq_train)
    from repro_torch.data.synthetic import ANNS_DATASETS, make_anns_dataset
    from repro_torch.kernels.distance.ops import gather_l2
    from repro_torch.kernels.rabitq_dot.ops import rabitq_gather_distance
    t_phase = time.perf_counter()
    data = make_anns_dataset(ANNS_DATASETS["bigann"], n=args.n,
                             seed=SEED)[:PQ_ROWS]
    q = q_dev[:PQ_QUERIES]
    params = ConstructionParams(degree_bound=64, alpha=1.2, beam_width=64,
                                max_iters=96, rev_cap=64,
                                prune_chunk=PRUNE_CHUNK)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", DeprecationWarning)
        idx = JasperIndex(data.shape[1], data.shape[0], quantization="pq",
                          construction=params, seed=SEED)
        t0 = time.perf_counter()
        idx.build(data)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        gt, _ = idx.brute_force(q, 10)
        shorter = {b: counted(lambda: idx.search_pq(q, 10, beam_width=b)[0])
                   for b in PQ_BEAMS}
        (ids, _), secs, launched = counted(
            lambda: idx.search_pq(q, 10, beam_width=PQ_BEAM))
        (ids_k, _), secs_k, launched_k = counted(
            lambda: idx.search_pq(q, 10, beam_width=PQ_BEAM, merge="kernel"))
    check(any("NEGATIVE result" in str(w.message) for w in caught),
          "quantization='pq' did not warn")
    books = idx.pq_params.codebooks
    check(tuple(books.shape) == (16, 256, 8) and idx.pq_codes.shape
          == (PQ_ROWS, 16), f"PQ codebooks {tuple(books.shape)}")
    rec = recall_at(ids, gt)
    log(f"  build {PQ_ROWS} rows (PQ 16 x 256, 8 iterations): {build_s:.2f} s;"
        f" search_pq with rerank, {PQ_QUERIES} queries: "
        + "".join(f"beam {b}: {t:.3f} s ({PQ_QUERIES / t:.0f} QPS), recall@10"
                  f" {recall_at(i, gt):.4f}; " for b, (i, t, _) in
                  shorter.items())
        + f"beam {PQ_BEAM}: "
        f"{secs:.3f} s ({PQ_QUERIES / secs:.0f} QPS), recall@10 {rec:.4f}; "
        f"launches {({k: v for k, v in launched.items() if v})}; "
        f"merge='kernel': {secs_k:.3f} s, launches "
        f"{({k: v for k, v in launched_k.items() if v})}")
    check(rec >= RECALL_FLOOR, f"PQ recall@10 {rec:.4f} < {RECALL_FLOOR}")
    check(launched == counts(), f"search_pq launched {launched}")
    check(torch.equal(ids, ids_k), "search_pq merge='kernel' differs from "
          "the default merge")
    check(set(k for k, v in launched_k.items() if v) == {"topk"},
          f"search_pq merge='kernel' launched {launched_k}")
    gen = torch.Generator().manual_seed(SEED + 13)
    dead = np.sort(torch.randperm(PQ_ROWS, generator=gen)[:PQ_ROWS // 100]
                   .numpy())
    idx.delete(dead)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ids, _ = idx.search_pq(q, 10, beam_width=PQ_BEAM)
    got = ids.cpu().numpy()
    check(not idx.tombstoned(got[got >= 0]).any(),
          "search_pq returned a tombstoned id")
    log(f"  after deleting {dead.size} rows: no tombstoned id")

    # Fig 12: per-candidate distances of Q x 64 candidates three ways
    cand = torch.randint(0, PQ_ROWS, (PQ_QUERIES, PQ_CANDIDATES),
                         generator=gen).to(q.device, torch.int32)
    rows = idx.vectors[:PQ_ROWS]
    rq = rabitq_train(torch.Generator().manual_seed(SEED), rows, bits=4)
    codes = rabitq_encode(rq, rows)
    qq = rabitq_preprocess_query(rq, q)
    cl = cand.long()
    gathered = (codes.packed[cl].contiguous(), codes.data_add[cl],
                codes.data_rescale[cl], qq.q_rot, qq.query_add,
                qq.query_sumq)
    exact = gather_l2(q, idx.vectors, idx.vec_sqnorm, cand)
    pqd = tpq.pq_distance(idx.pq_params, idx.pq_codes, q, cand)
    check(bool(torch.isfinite(pqd).all()) and pqd.shape == exact.shape,
          "pq_distance is not finite or of the wrong shape")
    ms = {"pq_distance": cuda_ms(lambda: tpq.pq_distance(
              idx.pq_params, idx.pq_codes, q, cand), 20),
          "gather_l2": cuda_ms(lambda: gather_l2(q, idx.vectors,
                                                 idx.vec_sqnorm, cand), 20),
          "rabitq_gather_distance": cuda_ms(
              lambda: rabitq_gather_distance(*gathered, bits=4), 20)}
    rel = float(((pqd - exact).abs() / exact.clamp(min=1.0)).mean())
    log(f"  Fig 12, {PQ_QUERIES} x {PQ_CANDIDATES} candidates, CUDA events, "
        f"mean of 20: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
        + f" (#5 without its gather of the code rows); PQ's mean relative "
        f"error against the exact distance {rel:.4f}")
    out = dict(build_s=build_s, qps=PQ_QUERIES / secs, recall=rec,
               recall_shorter={b: recall_at(i, gt)
                               for b, (i, _, _) in shorter.items()},
               fig12_ms=ms,
               seconds=time.perf_counter() - t_phase)
    del idx
    log(f"  phase 12: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------ the sharded index (phase 13)
SHARDS = 4
SHARD_CAP = 262_144            # rows a shard (4 x 262,144 >= 1M)
SHARD_RECALL_SLACK = 0.02      # tests/test_conformance.py's sharded slack
SHARD_REBALANCE_TOL = 0.01     # the churn round's skew is ~4 %: level it
SHARD_TICKS = 10
SHARD_TICK_QUERIES = 1_000
SHARD_REBALANCE_AT = 0.06      # the service's imbalance trigger
SHARD_CHECK_IDS = 10_000       # translated ids whose rows are compared


def _parts(r) -> tuple:
    """(ids, dists, hops[, telemetry]) of a SearchResult or of a
    core_search tuple."""
    if hasattr(r, "generation"):
        tel = () if r.telemetry is None else (r.telemetry,)
        return (r.ids, r.dists, r.n_hops) + tel
    return tuple(r)


def _same_res(a, b) -> bool:
    """Two search results bit-equal in ids, dists, hops and any
    telemetry."""
    a, b = _parts(a), _parts(b)
    if len(a) != len(b) or not all(torch.equal(x, y)
                                   for x, y in zip(a[:3], b[:3])):
        return False
    return len(a) == 3 or all(torch.equal(x, y) for x, y in zip(a[3], b[3]))


def _sharded_eager(idx, spec, q) -> tuple:
    """The sharded search run eagerly: every shard's core_search, then the
    merge."""
    return idx._plan_search(idx.core, q, spec.resolve(idx),
                            idx._filter_tombstones, spec.filter_bytes(),
                            mirrors=False)


def _per_shard(idx, spec, q) -> list:
    """Each shard's own core_search on `shard_core(s)`."""
    from repro_torch.core.index_core import core_search
    rspec = spec.resolve(idx)
    return [core_search(idx.shard_core(s), q, spec=rspec,
                        filter_tombstones=idx._filter_tombstones,
                        filter_bytes=spec.filter_bytes())
            for s in range(idx.n_shards)]


def _no_dead(idx, res) -> bool:
    ids = res.ids.cpu().numpy()
    return not idx.tombstoned(ids[ids >= 0]).any()


def sharded_search(idx, q_dev, gt, single_recall: float) -> dict:
    """Phase 13 (b): the main spec over four shards through its captured
    plan: replay == eager == the merge of the four shard searches,
    launches, telemetry, recall, host-clock times."""
    from repro_torch.core.distributed import merge_topk
    from repro_torch.core.plans import GraphPlan
    main = _mk_spec()
    s_n = idx.n_shards
    want = counts(fused_search=s_n, gather_l2=s_n)
    before = idx.plans.stats.snapshot()
    ses = idx.searcher(main)
    res, secs, launched = counted(lambda: ses.search(q_dev))
    delta = idx.plans.stats.delta(before)
    check(delta["misses"] == 1 and delta["traces"] == 1,
          f"the first sharded search did not capture once: {delta}")
    check(launched == want, f"a captured sharded search counted {launched}, "
          f"expected {want}")
    plan = idx._search_plan(ses.resolved, tuple(q_dev.shape),
                            idx._filter_tombstones)
    check(isinstance(plan, GraphPlan) and plan._graph is not None,
          "the sharded main spec's plan is not one captured CUDA graph")
    eager = _sharded_eager(idx, main, q_dev)
    check(_same_res(res, eager), "the captured sharded search differs from "
          "the eager one")
    per = _per_shard(idx, main, q_dev)
    row0 = torch.arange(s_n, dtype=torch.int32, device=q_dev.device) \
        * idx.id_stride
    ids = torch.stack([o[0] for o in per])
    gids = torch.where(ids >= 0, ids + row0[:, None, None],
                       torch.full_like(ids, -1))
    m_ids, m_d = merge_topk(gids, torch.stack([o[1] for o in per]),
                            idx.axis_sizes, 10)
    hops = torch.stack([o[2] for o in per]).amax(0)
    check(torch.equal(res.ids, m_ids) and torch.equal(res.dists, m_d)
          and torch.equal(res.n_hops, hops),
          "the sharded search is not the merge of the four shard searches")
    for _ in range(3):
        r, _, launched = counted(lambda: ses.search(q_dev))
        check(launched == want, f"a sharded replay counted {launched}")
        check(_same_res(r, eager), "a sharded replay differs from eager")
    tel = main.with_(telemetry="on")
    t_res = idx.searcher(tel).search(q_dev)
    t_per = _per_shard(idx, tel, q_dev)
    for i, name in enumerate(("scored", "masked", "duplicates", "occupancy")):
        total = t_per[0][3][i].clone()
        for o in t_per[1:]:
            total += o[3][i]
        check(torch.equal(t_res.telemetry[i], total),
              f"sharded telemetry {name} is not the sum over the shards")
    check(torch.equal(t_res.ids, res.ids), "telemetry changed the ids")
    rec = recall_at(res.ids, gt)
    log(f"  first search (captures): {secs:.3f} s, plan cache {delta}, "
        f"launches {({k: v for k, v in launched.items() if v})}; 3 replays "
        "bit-equal to eager and to the merge of the four shard_core "
        "searches; telemetry = the sum of the shards' counters")
    check(rec >= RECALL_FLOOR, f"sharded recall@10 {rec:.4f} < {RECALL_FLOOR}")
    check(rec >= single_recall - SHARD_RECALL_SLACK,
          f"sharded recall@10 {rec:.4f} more than {SHARD_RECALL_SLACK} below "
          f"phase 4's single-device {single_recall:.4f}")
    rspec = main.resolve(idx)
    filt = idx._filter_tombstones
    eager_ms = _host_ms(lambda: idx._plan_search(idx.core, q_dev, rspec, filt,
                                                 None, mirrors=False))
    replay_ms = _host_ms(lambda: ses.search(q_dev))
    prof = {}
    profile_device(lambda: ses.search(q_dev), "phase 13, one replayed "
                   "4-shard search", stats=prof)
    log(f"  recall@10 {rec:.4f} (phase 4's single-device {single_recall:.4f})"
        f"; {q_dev.shape[0]} queries, synchronised host clock, mean of 10: "
        f"eager {eager_ms:.3f} ms, replayed {replay_ms:.3f} ms; device busy "
        f"{_share(prof)} of a replay")
    return dict(recall=rec, single_recall=single_recall, eager_ms=eager_ms,
                replay_ms=replay_ms, launches=launched, capture_s=secs,
                busy=prof.get("share"), mk=res)


def sharded_lanes(idx, q_dev, mk) -> dict:
    """Phase 13 (c): the hop lane == the megakernel lane bit for bit, and
    the merge-kernel lane == its topk-merge twin; launches a shard."""
    from repro_torch.core.search_spec import SearchSpec
    base = dict(k=10, beam_width=64, quantized=True, use_kernels=True)
    lanes = {"hop": SearchSpec(fusion="hop", **base),
             "merge-kernel": SearchSpec(merge="kernel", **base),
             "topk-merge": SearchSpec(merge="topk", **base)}
    out = {}
    for name, spec in lanes.items():
        res, secs, launched = counted(
            lambda: idx.searcher(spec).search(q_dev))
        iters = [int(o[2].max()) for o in _per_shard(idx, spec, q_dev)]
        n = sum(iters)
        want = {"hop": counts(fused_hop=n, gather_l2=SHARDS),
                "merge-kernel": counts(topk=n, gather_l2=SHARDS,
                                       rabitq_search_step=n + SHARDS),
                "topk-merge": counts(gather_l2=SHARDS,
                                     rabitq_search_step=n + SHARDS)}[name]
        log(f"  {name:12s} {secs:.3f} s ({q_dev.shape[0] / secs:.0f} QPS), "
            f"iterations a shard {iters}, launches "
            f"{({k: v for k, v in launched.items() if v})}")
        check(launched == want, f"sharded {name} launched {launched}, "
              f"expected {want}")
        out[name] = dict(res=res, secs=secs, launches=launched, iters=iters)
    check(_same_res(out["hop"]["res"], mk),
          "the sharded hop lane differs from the megakernel lane")
    check(_same_res(out["merge-kernel"]["res"], out["topk-merge"]["res"]),
          "the sharded merge-kernel lane differs from its topk-merge twin")
    log("  hop == megakernel and merge-kernel == topk-merge, bit for bit")
    return {k: dict(secs=v["secs"], launches=v["launches"],
                    iters=v["iters"]) for k, v in out.items()}


def sharded_churn(idx, q_dev, ckpt_dir: Path, replay_b: float) -> dict:
    """Phase 13 (d) and (e): a delete of 1 % of all rows, all from shard
    0; consolidate; insert 2 %; rebalance; the checkpoints (with (h) and
    (i)); then a grow — each followed by a search through the captured
    plan. `replay_b` is (b)'s replay time."""
    from repro_torch.data.synthetic import ANNS_DATASETS, make_anns_dataset
    main = _mk_spec()
    ses = idx.searcher(main)
    gen = torch.Generator().manual_seed(SEED + 17)
    n0 = idx.size
    n_del = n0 // 100
    live0 = np.flatnonzero(~idx.tombstoned(np.arange(idx.cap)))
    dead = np.sort(live0[torch.randperm(live0.size, generator=gen)[:n_del]
                         .numpy()])
    out = {}
    t0 = time.perf_counter()
    n = idx.delete(dead)
    torch.cuda.synchronize()
    out["delete_s"] = time.perf_counter() - t0
    check(n == n_del and idx.size == n0 - n_del, "sharded delete counts")
    res = ses.search(q_dev)          # the liveness mode's plan: one capture
    check(_no_dead(idx, res), "a search after the delete returned a "
          "tombstoned id")
    check(_same_res(res, _sharded_eager(idx, main, q_dev)),
          "the replay after the delete differs from eager")
    base = idx.plans.stats.snapshot()
    live = idx.shard_live_counts().tolist()
    log(f"  delete {n_del} rows of shard 0: {out['delete_s']:.3f} s; live "
        f"a shard {live}, imbalance {idx.shard_imbalance:.4f}; no "
        "tombstoned id")

    def step(what):
        r = ses.search(q_dev)
        check(_no_dead(idx, r), f"a search after {what} returned a "
              "tombstoned id")
        check(_same_res(r, _sharded_eager(idx, main, q_dev)),
              f"the replay after {what} differs from eager")
        d = idx.plans.stats.delta(base)
        check(d["traces"] == 0, f"{what} recaptured the plan: {d}")
        return r

    t0 = time.perf_counter()
    stats = idx.consolidate()
    torch.cuda.synchronize()
    out["consolidate_s"] = time.perf_counter() - t0
    check(stats["n_freed"] == n_del, f"consolidate freed {stats}")
    step("the consolidate")
    new = make_anns_dataset(ANNS_DATASETS["bigann"], n=2 * n_del,
                            seed=SEED + 2)
    new = new[:new.shape[0] - new.shape[0] % SHARDS]
    t0 = time.perf_counter()
    ids = idx.insert(new)
    torch.cuda.synchronize()
    out["insert_s"] = time.perf_counter() - t0
    b = new.shape[0] // SHARDS
    check(np.array_equal(ids[:b], dead[:b]), "shard 0 did not reuse its "
          "freed slots in ascending order")
    step("the insert")
    before = idx.shard_live_counts().tolist()
    vecs = idx.core.vectors.clone()
    t0 = time.perf_counter()
    reb = idx.rebalance(tolerance=SHARD_REBALANCE_TOL)
    torch.cuda.synchronize()
    out["rebalance_s"] = time.perf_counter() - t0
    after = idx.shard_live_counts()
    check(reb["n_moved"] > 0 and reb["translation"] is not None,
          f"rebalance moved nothing: {reb['counts_before']}")
    check(int(after.max() - after.min()) <= max(1.0, SHARD_REBALANCE_TOL
                                                * after.mean()),
          f"rebalance left the shards at {after.tolist()}")
    t = reb["translation"]

    def pos(g, cap):
        g = np.asarray(g, np.int64)
        return torch.as_tensor((g // idx.id_stride) * cap + g % idx.id_stride,
                               device=q_dev.device)

    check(torch.equal(vecs[pos(t.old_ids, idx.cap)],
                      idx.core.vectors[pos(t.apply(t.old_ids), idx.cap)]),
          "a moved row is not at its translated id")
    del vecs
    res = step("the rebalance")
    gt, _ = idx.brute_force(q_dev, 10)
    rec = recall_at(res.ids, gt)
    check(rec >= RECALL_FLOOR, f"recall after the rebalance {rec:.4f}")
    log(f"  consolidate {out['consolidate_s']:.2f} s ({stats}); insert "
        f"{new.shape[0]} {out['insert_s']:.2f} s (shard 0 reuses its freed "
        f"slots); rebalance (tolerance {SHARD_REBALANCE_TOL}) "
        f"{out['rebalance_s']:.2f} s: {before} -> {after.tolist()}, "
        f"{reb['n_moved']} rows moved, their rows at their translated ids; "
        f"no recapture; recall@10 {rec:.4f}")
    out.update(n_moved=reb["n_moved"], live_before=before,
               live_after=after.tolist(), recall=rec)

    out["checkpoints"] = sharded_checkpoints(idx, q_dev, res, ckpt_dir,
                                             replay_b)

    t0 = time.perf_counter()
    idx.grow()
    torch.cuda.synchronize()
    out["grow_s"] = time.perf_counter() - t0
    g = ses.search(q_dev)
    d = idx.plans.stats.delta(base)
    check(d["traces"] == 1, f"the grow recaptured {d['traces']} times")
    check(_same_res(g, res), "the search after the grow differs from the "
          "one before it")
    check(_same_res(g, _sharded_eager(idx, main, q_dev)),
          "the replay after the grow differs from eager")
    log(f"  grow to {idx.cap} rows a shard: {out['grow_s']:.3f} s, one "
        "recapture, the same results")
    return out


def sharded_checkpoints(idx, q_dev, res, ckpt_dir: Path,
                        replay_b: float) -> dict:
    """Phase 13 (e): save; load at 4 shards (bit-equal searches), then (h)
    and (i) on the same checkpoint, and at 2 (a reshard: translated ids at
    their rows, the exact top-10 kept, no dead id; recall measured)."""
    import shutil

    from repro_torch.core.distributed import ShardedJasperIndex
    from repro_torch.launch.mesh import make_mesh
    main = _mk_spec()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    path = str(ckpt_dir / "sharded")
    out = {}
    t0 = time.perf_counter()
    idx.save(path)
    out["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    four = ShardedJasperIndex.load(make_mesh((SHARDS,), ("data",)), path)
    torch.cuda.synchronize()
    out["load4_s"] = time.perf_counter() - t0
    check(four.reshard_translation is None and four.n_shards == SHARDS,
          "a same-count load resharded")
    check(_same_res(four.searcher(main).search(q_dev), res),
          "the index loaded at 4 shards searches differently")
    del four
    gc.collect()
    out["positions"] = sharded_positions(idx, q_dev, path, res, replay_b)
    gc.collect()
    t0 = time.perf_counter()
    two = ShardedJasperIndex.load(make_mesh((2,), ("data",)), path)
    torch.cuda.synchronize()
    out["load2_s"] = time.perf_counter() - t0
    t = two.reshard_translation
    check(two.n_shards == 2 and t is not None and len(t) == idx.size,
          "the 2-shard load did not reshard every live row")
    gen = torch.Generator().manual_seed(SEED + 19)
    old = t.old_ids[torch.randperm(len(t), generator=gen)[:SHARD_CHECK_IDS]
                    .numpy()]
    new = t.apply(old)

    def rows(index, g):
        p = (g // index.id_stride) * index.cap + g % index.id_stride
        return index.core.vectors[torch.as_tensor(p, device=q_dev.device)]

    check(bool((new >= 0).all()) and torch.equal(rows(idx, old),
                                                 rows(two, new)),
          "translated ids do not find their rows after the reshard")
    # the reshard keeps every live row: the same exact top-10 distances,
    # and the same ids through the translation wherever a distance is
    # not tied within its row
    gt4, gd4 = idx.brute_force(q_dev, 10)
    gt2, gd2 = two.brute_force(q_dev, 10)
    check(torch.equal(gd4, gd2), "the reshard changed the exact top-10")
    d = gd4.cpu().numpy()
    untied = np.ones(d.shape, bool)
    untied[:, 1:] &= d[:, 1:] != d[:, :-1]
    untied[:, :-1] &= d[:, :-1] != d[:, 1:]
    untied[:, -1] = False
    check(np.array_equal(t.apply(gt4.cpu().numpy())[untied],
                         gt2.cpu().numpy()[untied]),
          "the exact top-10 ids do not map through the translation")
    res2 = two.searcher(main).search(q_dev)
    check(_no_dead(two, res2), "the resharded index returned a dead id")
    rec = recall_at(res2.ids, gt2)
    wide = main.with_(beam_width=128)
    rec_wide = recall_at(two.searcher(wide).search(q_dev).ids, gt2)
    log(f"  checkpoint: save {out['save_s']:.2f} s; load at 4 shards "
        f"{out['load4_s']:.2f} s, searches bit-equal; load at 2 shards "
        f"(reshard, relink auto) {out['load2_s']:.2f} s, capacity "
        f"{two.cap} a shard, {SHARD_CHECK_IDS} translated ids at their "
        f"rows, the exact top-10 kept; recall@10 {rec:.4f} at beam 64, "
        f"{rec_wide:.4f} at the equal total budget (beam 128) — each "
        "merged shard holds two graphs joined by the medoid's bridge "
        "edges, as in the JAX package")
    out["recall2_wide"] = rec_wide
    out["recall2"] = rec
    del two
    gc.collect()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


# the device of every position in (h): one card, four positions
SHARD_POSITION_DEVICE = "cuda:0"


def _positions_check(idx, pos, q_dev, want: dict, what: str) -> dict:
    """(h)/(i): `pos` (a mesh of four positions, loaded from the checkpoint
    `idx` holds) against the stacked layout's results `want` ({"mk", "hop",
    "eager"}): the megakernel lane through its plan (one captured graph a
    position) and eagerly, and the hop lane, bit-equal; launches a search
    and a position; the replay's host-clock time."""
    from repro_torch.core.plans import GraphPlan, PositionsPlan
    main = _mk_spec()
    hop = main.with_(fusion="hop")
    ses = pos.searcher(main)
    first, cap_s, launched = counted(lambda: ses.search(q_dev))
    plan = pos._search_plan(ses.resolved, tuple(q_dev.shape),
                            pos._filter_tombstones)
    check(isinstance(plan, PositionsPlan) and len(plan.plans) == SHARDS
          and all(isinstance(g, GraphPlan) and g._graph is not None
                  for g in plan.plans),
          f"{what}: the plan is not one captured graph a position")
    per_position = [{k: v for k, v in getattr(g, "_launched", {}).items()
                     if v} for g in plan.plans]
    check(all(p == {"fused_search": 1, "gather_l2": 1}
              for p in per_position),
          f"{what}: a position's graph launched {per_position}")
    want_n = counts(fused_search=SHARDS, gather_l2=SHARDS)
    check(launched == want_n, f"{what}: the first search counted "
          f"{launched}, expected {want_n}")
    check(_same_res(first, want["mk"]), f"{what}: the first (capturing) "
          "search differs from the stacked layout's")
    for _ in range(3):
        r, _, launched = counted(lambda: ses.search(q_dev))
        check(launched == want_n, f"{what}: a replay counted {launched}")
        check(_same_res(r, want["mk"]), f"{what}: a replay differs from the "
              "stacked layout's")
    eager = pos._eager_search(pos._prep_query(q_dev), main.resolve(pos),
                              pos._filter_tombstones, None)
    check(_same_res(eager, want["eager"]), f"{what}: the eager search "
          "differs from the stacked layout's")
    h_res, h_s, h_launched = counted(lambda: pos.searcher(hop).search(q_dev))
    check(_same_res(h_res, want["hop"]), f"{what}: the hop lane differs from "
          "the stacked layout's")
    check(h_launched["gather_l2"] == SHARDS
          and h_launched["fused_hop"] == want["hop_launches"],
          f"{what}: the hop lane launched {h_launched}")
    check(_no_dead(pos, r), f"{what}: a tombstoned id came back")
    replay_ms = _host_ms(lambda: ses.search(q_dev))
    # what comes home a search: each position's (Q, k) ids and dists and
    # (Q,) hops, from the positions on another device than the home's
    outs = plan.local(q_dev)
    home = pos.device
    bytes_home = sum(t.numel() * t.element_size()
                     for p, o in zip(plan.positions, outs) for t in o[:3])
    bytes_peer = sum(t.numel() * t.element_size()
                     for p, o in zip(plan.positions, outs) for t in o[:3]
                     if p.device != home)
    prof = {}
    profile_device(lambda: ses.search(q_dev), f"phase 13 {what}, one "
                   "replayed search on four positions", top=12, stats=prof)
    return dict(capture_s=cap_s, replay_ms=replay_ms, hop_s=h_s,
                launches=launched, per_position=per_position,
                hop_launches=h_launched, bytes_gathered=bytes_home,
                bytes_from_peers=bytes_peer, busy=prof.get("share"),
                profile=prof, devices=[str(d) for d in pos.position_devices()])


# rows a shard of (h)'s insert on four and on eight positions
SHARD_INSERT_ROWS = 1_024


def _replicas_insert(pos, path: str, q_dev) -> dict:
    """(h), continued: the same checkpoint on a (4, 2) ("data", "model")
    mesh of eight positions of the card — two replicas a shard, each
    searching half of the queries. One insert of SHARD_INSERT_ROWS rows a
    shard, timed on it and on `pos` (four positions): each replica runs
    the core op itself, none is copied from another. Afterwards every
    replica equals `pos`'s shard tensor for tensor, and the megakernel
    lane is bit-equal to `pos`'s."""
    from repro_torch.core.distributed import (ShardedJasperIndex, ShardSpec,
                                              _row_tensors)
    from repro_torch.data.synthetic import ANNS_DATASETS, make_anns_dataset
    from repro_torch.launch.mesh import make_mesh
    main = _mk_spec()
    eight = ShardedJasperIndex.load(make_mesh(
        (SHARDS, 2), ("data", "model"),
        device=[SHARD_POSITION_DEVICE] * (2 * SHARDS)), path,
        spec=ShardSpec(("data",), "model"))
    check(eight.n_positions == 2 * SHARDS
          and len(eight.searching_positions()) == 2 * SHARDS,
          "(h): the checkpoint did not load onto eight searching positions")
    check(_same_res(eight.searcher(main).search(q_dev),
                    pos.searcher(main).search(q_dev)),
          "(h): eight positions search differently from four")
    new = make_anns_dataset(ANNS_DATASETS["bigann"],
                            n=SHARDS * SHARD_INSERT_ROWS, seed=SEED + 27)
    out = {}
    for name, ix in (("four", pos), ("eight", eight)):
        ix.insert(new[:SHARDS])          # first-use costs out of the timing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ix.insert(new)
        torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
    for s in range(SHARDS):
        want = _row_tensors(pos.shard_core(s))
        for r, rep in enumerate(eight.shard_replicas(s)):
            check(all(a is None and b is None or torch.equal(a, b)
                      for a, b in zip(_row_tensors(rep), want)),
                  f"(h): replica {r} of shard {s} differs after the insert")
    check(_same_res(eight.searcher(main).search(q_dev),
                    pos.searcher(main).search(q_dev)),
          "(h): after the insert eight positions search differently")
    log(f"  (h) replicas: the checkpoint on a (4, 2) mesh of eight positions "
        f"on {SHARD_POSITION_DEVICE} (two replicas a shard, the query axis "
        f"splitting the batch) searches bit-equal to four; an insert of "
        f"{SHARDS} x {SHARD_INSERT_ROWS} rows (host clock, one run): four "
        f"positions {out['four_ms']:.1f} ms, eight {out['eight_ms']:.1f} ms "
        f"(each replica runs the op); every replica equal to the four "
        f"positions' shard after it, searches bit-equal")
    del eight
    gc.collect()
    return out


def sharded_positions(idx, q_dev, path: str, res, replay_b: float) -> dict:
    """Phase 13 (h) and (i): (e)'s checkpoint on a mesh of four positions —
    on the one card (h), and on four cards where the machine has them
    (i) — against `idx`, the stacked layout of the same checkpoint
    (`res` its main-spec result)."""
    from repro_torch.core.distributed import ShardedJasperIndex
    from repro_torch.launch.mesh import make_mesh
    main = _mk_spec()
    hop = main.with_(fusion="hop")
    # the stacked layout's references, eager (its plan cache untouched)
    iters = [int(o[2].max()) for o in _per_shard(idx, hop, q_dev)]
    want = dict(mk=res, hop=_sharded_eager(idx, hop, q_dev),
                hop_launches=sum(iters),
                eager=_sharded_eager(idx, main, q_dev))
    gt, _ = idx.brute_force(q_dev, 10)
    rec = recall_at(res.ids, gt)
    # the stacked layout's replay of the same checkpoint (its plan is
    # captured: no trace), timed in turns with (h)'s
    stacked = idx.searcher(main)
    stacked_ms = [_host_ms(lambda: stacked.search(q_dev))]
    prof_s = {}
    profile_device(lambda: stacked.search(q_dev), "phase 13 (h), the stacked "
                   "layout of the same checkpoint, one replay", top=12,
                   stats=prof_s)
    out = {}
    t0 = time.perf_counter()
    pos = ShardedJasperIndex.load(make_mesh(
        (SHARDS,), ("data",), device=[SHARD_POSITION_DEVICE] * SHARDS), path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(pos.n_positions == SHARDS and pos.reshard_translation is None,
          "(h): the checkpoint did not load onto four positions")
    h = _positions_check(idx, pos, q_dev, want, "(h)")
    h["load_s"] = load_s
    ses = pos.searcher(main)
    h["replay_ms"] = [h["replay_ms"], _host_ms(lambda: ses.search(q_dev))]
    stacked_ms.append(_host_ms(lambda: stacked.search(q_dev)))
    h["stacked_ms"] = stacked_ms
    h["stacked_busy"] = prof_s.get("share")
    log(f"  (h) four positions on {SHARD_POSITION_DEVICE}: load "
        f"{load_s:.2f} s; the megakernel lane (captured: one graph a "
        f"position, #1 and #2 once each a position; and eager) and the hop "
        f"lane bit-equal to the stacked layout; a {q_dev.shape[0]}-query "
        f"search replayed (host clock, mean of 10, in turns): stacked "
        f"{stacked_ms[0]:.3f}, positions {h['replay_ms'][0]:.3f}, "
        f"{h['replay_ms'][1]:.3f}, stacked {stacked_ms[1]:.3f} ms ((b)'s "
        f"fresh index {replay_b:.3f} ms); {h['bytes_gathered']} B gathered "
        f"home a search; device busy {_share(h.pop('profile'))} of a "
        f"replay (stacked {_share(prof_s)})")
    h["replicas"] = _replicas_insert(pos, path, q_dev)
    out["h"] = h
    del pos
    gc.collect()
    n_cards = torch.cuda.device_count()
    if n_cards < SHARDS:
        log(f"  (i) did not run: this machine has {n_cards} CUDA device(s); "
            f"shards on their own cards need {SHARDS}")
        out["i"] = None
        return out
    t0 = time.perf_counter()
    pos = ShardedJasperIndex.load(make_mesh(
        (SHARDS,), ("data",), device=[f"cuda:{i}" for i in range(SHARDS)]),
        path)
    for i in range(SHARDS):
        torch.cuda.synchronize(i)
    load_s = time.perf_counter() - t0
    i_res = _positions_check(idx, pos, q_dev, want, "(i)")
    i_res["load_s"] = load_s
    rec_i = recall_at(pos.searcher(main).search(q_dev).ids, gt)
    check(rec_i == rec, f"(i): recall@10 {rec_i:.5f} differs from the "
          f"stacked layout's {rec:.5f}")
    log(f"  (i) four cards {i_res['devices']}: load {load_s:.2f} s; bit-equal "
        f"as (h); recall@10 {rec_i:.4f} (stacked {rec:.4f}); replayed "
        f"{i_res['replay_ms']:.3f} ms (host clock, mean of 10); "
        f"{i_res['bytes_from_peers']} B from the three other cards a search "
        f"({i_res['bytes_gathered']} B gathered in all); home card busy "
        f"{_share(i_res.pop('profile'))} of a replay")
    i_res["recall"] = rec_i
    out["i"] = i_res
    del pos
    gc.collect()
    return out


def sharded_host_tier(idx, q_dev) -> dict:
    """Phase 13 (f): evict the stacked rows; host == device on the
    megakernel lane, launches #1 4 + #2 4, no tombstoned id; restore."""
    main = _mk_spec()
    host = main.with_(rerank_source="host")
    device = idx.searcher(main).search(q_dev)
    rows = idx.capacity * (idx.store_dims + 1) * 4
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    idx.evict_rows_to_host()
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    check(before - after >= 0.95 * rows,
          f"eviction freed {before - after} B of device memory, less than "
          f"0.95 x the rows' {rows} B")
    ses = idx.searcher(host)
    ses.search(q_dev)
    res, secs, launched = counted(lambda: ses.search(q_dev))
    want = counts(fused_search=SHARDS, gather_l2=SHARDS)
    check(launched == want, f"a sharded host-tier search counted {launched}")
    check(_same_res(res, device), "the sharded host tier differs from the "
          "device tier")
    check(_no_dead(idx, res), "the host tier returned a tombstoned id")
    ms = _host_ms(lambda: ses.search(q_dev))
    log(f"  evict: device memory fell {(before - after) / 1e9:.3f} GB (rows "
        f"{rows / 1e9:.3f} GB); host tier == device tier bit for bit, "
        f"launches {({k: v for k, v in launched.items() if v})}, "
        f"{ms:.2f} ms a 10,000-query search (host clock, mean of 10)")
    idx.restore_rows_to_device()
    return dict(freed_gb=(before - after) / 1e9, rows_gb=rows / 1e9,
                host_ms=ms, launches=launched)


def sharded_serving(idx, q_dev) -> dict:
    """Phase 13 (g): `AnnsService.run` over ticks of deletes skewed onto
    shard 0: the rebalance trigger fires, the `shards.*` gauges report the
    four shards, recall holds."""
    from repro_torch.data.synthetic import ANNS_DATASETS, make_anns_dataset
    from repro_torch.serving.anns_service import AnnsService
    main = _mk_spec()
    svc = AnnsService(idx, spec=main, consolidate_threshold=0.012,
                      rebalance_threshold=SHARD_REBALANCE_AT, verify=True)
    gen = torch.Generator().manual_seed(SEED + 23)
    n_del = idx.size // 400           # the trigger fires about tick 5
    n_ins = idx.size // 1000 // SHARDS * SHARDS
    new = make_anns_dataset(ANNS_DATASETS["bigann"], n=n_ins * SHARD_TICKS,
                            seed=SEED + 8)
    queries = q_dev[:SHARD_TICK_QUERIES].cpu().numpy()
    fired = []
    t0 = time.perf_counter()
    for tick in range(SHARD_TICKS):
        live0 = np.flatnonzero(~idx.tombstoned(np.arange(idx.cap)))
        dead = np.sort(live0[torch.randperm(live0.size, generator=gen)[:n_del]
                             .numpy()])
        n_reb = svc.stats.n_rebalances
        svc.run([("delete", dead),
                 ("insert", new[tick * n_ins:(tick + 1) * n_ins]),
                 ("search", queries)])
        if svc.stats.n_rebalances > n_reb:
            fired.append(tick)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    snap = svc.metrics_snapshot()
    gauges = {k: v for k, v in snap.items() if k.startswith("shards.")}
    check(fired, "the service's rebalance never fired")
    check(gauges.get("shards.count") == SHARDS
          and gauges.get("shards.live") == idx.shard_live_counts().tolist(),
          f"shards.* gauges {gauges}")
    rec = idx.recall(q_dev, 10, spec=main)
    check(rec >= RECALL_FLOOR, f"recall after the service ticks {rec:.4f}")
    log(f"  {SHARD_TICKS} ticks of delete {n_del} (shard 0) / insert {n_ins}"
        f" / search {SHARD_TICK_QUERIES}: {secs:.2f} s; rebalance fired at "
        f"ticks {fired} ({svc.stats.n_rebalance_rows} rows moved), "
        f"consolidations {svc.stats.n_consolidations}; {gauges}; recall@10 "
        f"{rec:.4f}")
    return dict(seconds=secs, rebalanced_at=fired,
                moved=svc.stats.n_rebalance_rows, gauges=gauges, recall=rec)


def sharded_phase(args, q_dev, single_recall: float) -> dict:
    """Phase 13: the row-sharded index on phase 4's data, four shards on
    the card."""
    from repro_torch.core.construction import ConstructionParams
    from repro_torch.core.distributed import ShardedJasperIndex
    from repro_torch.data.synthetic import ANNS_DATASETS, make_anns_dataset
    from repro_torch.launch.mesh import make_mesh
    t_phase = time.perf_counter()
    n = args.n - args.n % SHARDS
    per = n // SHARDS
    data = make_anns_dataset(ANNS_DATASETS["bigann"], n=args.n, seed=SEED)[:n]
    params = ConstructionParams(degree_bound=64, alpha=1.2, beam_width=64,
                                max_iters=96, rev_cap=64,
                                prune_chunk=PRUNE_CHUNK)
    cap = max(SHARD_CAP, -(-per // 8) * 8)
    idx = ShardedJasperIndex(make_mesh((SHARDS,), ("data",)), data.shape[1],
                             cap, quantization="rabitq", bits=4,
                             construction=params, seed=SEED)
    (_, build_s, launched) = counted(lambda: idx.build(data))
    del data
    check(not any(launched.values()), "construction launched a search kernel")
    live = idx.shard_live_counts().tolist()
    log(f"  build {n} rows in {SHARDS} shards of {cap}: {build_s:.2f} s "
        f"({n / build_s:.0f} rows/s); live a shard {live}; device memory in "
        f"use {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    gt, _ = idx.brute_force(q_dev, 10)
    out = dict(build_s=build_s, live=live, capacity_per_shard=cap)
    search = sharded_search(idx, q_dev, gt, single_recall)
    out["lanes"] = sharded_lanes(idx, q_dev, search.pop("mk"))
    out["search"] = search
    out["churn"] = sharded_churn(
        idx, q_dev, Path(__file__).resolve().parent / "build" / "phase13",
        search["replay_ms"])
    out["host_tier"] = sharded_host_tier(idx, q_dev)
    out["serving"] = sharded_serving(idx, q_dev)
    out["seconds"] = time.perf_counter() - t_phase
    del idx
    log(f"  phase 13: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------ flash attention (#10, #11)
# name, b, sq, skv, h, hk, dh, causal, window, q_offset
FLASH_GRID = [
    ("causal-g1-d64", 2, 130, 130, 4, 4, 64, True, 0, 0),
    ("causal-g2-d128", 1, 200, 200, 8, 4, 128, True, 0, 0),
    ("causal-g9-d128", 1, 257, 257, 36, 4, 128, True, 0, 0),
    ("bidir-g9-d64", 2, 100, 77, 18, 2, 64, False, 0, 0),
    ("window64-g2-d128", 1, 300, 300, 4, 2, 128, True, 64, 0),
    ("window64-g9-d64", 1, 193, 193, 9, 1, 64, True, 64, 0),
    ("qoffset-g9-d128", 2, 70, 333, 9, 1, 128, True, 0, 263),
    ("qoffset-window64-g2-d64", 1, 50, 250, 4, 2, 64, True, 64, 200),
    ("rows-past-the-keys-g2-d64", 1, 64, 100, 4, 2, 64, True, 16, 120),
    ("causal-g2-d32", 1, 65, 65, 4, 2, 32, True, 0, 0),
    # head dim 80 (stablelm-3b, zamba2-2.7b, hubert-xlarge)
    ("causal-g2-d80", 1, 200, 200, 8, 4, 80, True, 0, 0),
    ("window64-g1-d80", 1, 257, 257, 4, 4, 80, True, 64, 0),
    ("qoffset-g2-d80", 2, 70, 333, 4, 2, 80, True, 0, 263),
    ("bidir-g9-d80", 1, 129, 127, 9, 1, 80, False, 0, 0),
    # the edges of the bf16 kernels' tiles: 64 keys; 64 query rows, or 128
    # at Dh 128 (the backward: 64 rows and 64 keys at every Dh)
    ("edge-63-d128", 1, 63, 63, 4, 1, 128, True, 0, 0),
    ("edge-65-d80", 1, 65, 65, 4, 2, 80, True, 0, 0),
    ("edge-127-129-d64", 2, 127, 129, 4, 2, 64, False, 0, 0),
    ("edge-129-d128", 1, 129, 129, 4, 2, 128, True, 0, 0),
    ("edge-129-255-d80", 1, 129, 255, 4, 2, 80, True, 0, 126),
    ("edge-255-d32", 1, 255, 255, 6, 2, 32, True, 0, 0),
    ("edge-255-127-window-d128", 1, 255, 127, 4, 4, 128, True, 64, 0),
]
# float32: the kernel and the plain version differ only in summation order
# and block partition; bf16: p is rounded to bf16 at another running max,
# and the output is rounded to bf16 once more
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
LSE_ATOL = 1e-4


def compare_flash(q, k, v, kw, what) -> float:
    """#10 and #11 against #11's plain version on one input: o within the
    dtype's tolerance, #11's o bit-equal to #10's, lse within 1e-4.
    Returns the max |o err|."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_fwd, flash_attention_fwd_plain)
    o10 = flash_attention(q, k, v, **kw)
    o11, lse = flash_attention_fwd(q, k, v, **kw)
    want, want_lse = flash_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    check(torch.equal(o10, o11), f"{what}: #11's o differs from #10's")
    err = float((o10.float() - want.float()).abs().max())
    check(torch.allclose(o10.float(), want.float(), **FLASH_TOL[q.dtype]),
          f"{what}: o max |err| {err} against the plain version")
    lse_err = float((lse - want_lse).abs().max())
    check(bool(torch.isfinite(lse).all()) and lse_err <= LSE_ATOL,
          f"{what}: lse max |err| {lse_err} against the plain version")
    return err


# #12 vs its plain version: (rtol, atol as a fraction of the plain
# gradient's largest magnitude). float32: the kernel adds up to Sq * G
# terms one after another in a register, the plain version in blocks; the
# difference grows like sqrt(n) * eps * |partial sum|, about 1e-5 of the
# largest gradient at 36,864 terms (on an H100 at starcoder2-7b's shape:
# 7.8e-5 on |dv| up to ~10). bf16: as the forward, plus the rounding of ds
# and p to bf16 before their products.
BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def bwd_close(got, want) -> bool:
    rtol, atol = BWD_TOL[got.dtype]
    want = want.float()
    return torch.allclose(got.float(), want, rtol=rtol,
                          atol=atol * float(want.abs().max()))


def compare_flash_bwd(q, k, v, kw, what, gen) -> float:
    """#12 against its plain version on one input (o and lse from #11's
    plain version, a random cotangent): dq, dk, dv within BWD_TOL, a second
    launch bit-equal. Returns the max |err|."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_fwd_plain)
    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    o, lse = flash_attention_fwd_plain(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        check(torch.equal(g, a), f"{what}: {name} differs between launches")
        err = float((g.float() - w.float()).abs().max())
        check(bool(torch.isfinite(g).all()) and bwd_close(g, w),
              f"{what}: {name} max |err| {err} against the plain version "
              f"(max |plain| {float(w.float().abs().max()):.3g})")
        worst = max(worst, err)
    return worst


def kernel_label(symbol: str) -> str:
    """flash_fwd_bf16_kernel<128, lse> from a mangled kernel name."""
    m = re.search(r"(?<=\d)(flash_\w+?_kernel)I(?:f)?Li(\d+)E(?:Lb(\d)E)?",
                  symbol)
    if not m:
        return symbol
    return f"{m[1]}<{m[2]}{', lse' if m[3] == '1' else ''}>"


def ptxas_report(name: str) -> tuple[dict, dict]:
    """({kernel: registers}, {function: spill-store bytes}) of library
    `name`, from its ptxas report."""
    from repro_torch.kernels import build
    report = (build.BUILD_DIR / f"{name}.log").read_text(errors="replace")
    spills = {fn: int(n) for fn, n in re.findall(
        r"Function properties for (\S+)\n\s*\d+ bytes stack frame, "
        r"(\d+) bytes spill stores", report)}
    regs = {fn: int(n) for fn, n in re.findall(
        r"Compiling entry function '(\S+)' for '\w+'\n(?:.*\n)*?.*?Used "
        r"(\d+) registers", report)}
    return regs, spills


# estimator kernel -> (its library, its kernel's name in the ptxas report)
ESTIMATORS = {"rabitq_search_step": ("rabitq_search_step",
                                     "rabitq_search_step_kernel"),
              "rabitq_distance": ("rabitq_distance", "rabitq_distance_kernel"),
              "rabitq_gather_distance": ("rabitq_distance",
                                         "rabitq_gather_kernel")}


def estimator_occupancy(name: str, bits: int, p: int) -> dict:
    """Registers, resident blocks an SM, shared bytes a block (#3 and #5:
    and queries a block) of #3's, #5's or #6's main-path instance (the
    occupancy API), and the most spill stores of its variants at BITS =
    bits (the ptxas report)."""
    from repro_torch.kernels.rabitq_dot.ops import occupancy
    library, kernel = ESTIMATORS[name]
    _, spills = ptxas_report(library)
    info = occupancy(name, bits=bits, p=p)
    info["spill_stores"] = max(n for fn, n in spills.items()
                               if f"{kernel}ILi{bits}E" in fn)
    return info


def sass_hmma(lib: Path) -> dict:
    """{kernel: HMMA (tensor-core) instructions} in a library's SASS
    (`cuobjdump` from the toolkit of `nvcc`)."""
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return {fn: body.count("HMMA") for fn, body in re.findall(
        r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S)}


def tensor_core_check(libs: dict, name: str, kernel: str) -> dict:
    """Phase 2: every instance of `kernel` in library `name` computes its
    products on the tensor cores (HMMA in its SASS) and spills nothing (its
    ptxas report). Returns {instance: HMMA count}."""
    hmma = {fn: n for fn, n in sass_hmma(libs[name]).items() if kernel in fn}
    _, spills = ptxas_report(name)
    check(len(hmma) > 0, f"{name}: no instance of {kernel} in the SASS")
    for fn, n in hmma.items():
        check(n > 0, f"{name} {fn}: no HMMA instruction")
        check(spills.get(fn) == 0, f"{name} {fn}: spill stores "
              f"{spills.get(fn, 'not reported')}")
    return hmma


def rabitq_distance_sass_check(libs: dict) -> dict:
    """Phase 2: the tensor-core check of #6's four instances (BITS 1, 2, 4,
    8). Returns {bits: HMMA count}."""
    hmma = tensor_core_check(libs, "rabitq_distance", "rabitq_distance_kernel")
    check(len(hmma) == 4, f"rabitq_distance: {len(hmma)} instances of "
          "rabitq_distance_kernel in the SASS, expected 4")
    by_bits = {int(re.search(r"kernelILi(\d+)E", fn)[1]): n
               for fn, n in hmma.items()}
    log(f"    sass rabitq_distance: HMMA per instance (bits: count) "
        f"{dict(sorted(by_bits.items()))}, no spill stores")
    return by_bits


def pairwise_l2_sass_check(libs: dict) -> int:
    """Phase 2: the tensor-core check of #7. Returns its HMMA count."""
    hmma = tensor_core_check(libs, "pairwise_l2", "pairwise_l2_kernel")
    log(f"    sass pairwise_l2: HMMA per instance {sorted(hmma.values())}, "
        "no spill stores")
    return max(hmma.values())


def search_step_ptxas_check() -> None:
    """Phase 2: all 80 instances of the fused search kernels (fused_search
    and fused_hop x exact / 1, 2, 4, 8 bits x tombstone x labels x
    telemetry) spill nothing (the ptxas report); their registers, and the
    main path's instance's (4 bits, no masks, no telemetry)."""
    regs, spills = ptxas_report("search_step")
    kernels = sorted(fn for fn in regs
                     if "fused_search_kernel" in fn or "fused_hop_kernel" in fn)
    check(len(kernels) == 80, f"search_step: {len(kernels)} kernel instances "
          "in the ptxas report, expected 80")
    for fn in kernels:
        check(fn in spills, f"search_step {fn}: no spill report")
    for fn, n in spills.items():   # the kernels and any function not inlined
        check(n == 0, f"search_step {fn}: {n} bytes of spill stores")
    main = {k: regs[fn] for k in ("fused_search_kernel", "fused_hop_kernel")
            for fn in kernels if f"{k}ILb1ELi4ELb0ELb0ELb0E" in fn}
    log(f"    ptxas search_step: 80 instances, no spill stores, registers "
        f"{min(regs[fn] for fn in kernels)}..{max(regs[fn] for fn in kernels)}"
        f"; main path's instance (4 bits, no masks or telemetry): "
        f"fused_search {main.get('fused_search_kernel')}, fused_hop "
        f"{main.get('fused_hop_kernel')}")


def flash_sass_check(libs: dict) -> None:
    """Phase 2: every bf16 flash-attention kernel computes its products on
    the tensor cores (HMMA instructions in its SASS, `cuobjdump` from the
    toolkit of `nvcc`) and spills nothing (its ptxas report)."""
    for name in ("flash_attention", "flash_attention_bwd"):
        hmma = sass_hmma(libs[name])
        _, spills = ptxas_report(name)
        bf16 = sorted((fn for fn in hmma if "bf16_kernel" in fn),
                      key=lambda fn: (len(kernel_label(fn)),
                                      kernel_label(fn)))
        check(len(bf16) > 0, f"{name}: no bf16 kernel in the SASS")
        for fn in bf16:
            check(hmma[fn] > 0, f"{kernel_label(fn)}: no HMMA instruction")
            check(spills.get(fn) == 0, f"{kernel_label(fn)}: spill stores "
                  f"{spills.get(fn, 'not reported')}")
        others = [fn for fn in hmma if fn not in bf16]
        log(f"    sass {name}: HMMA per bf16 kernel "
            + ", ".join(f"{kernel_label(fn)} {hmma[fn]}" for fn in bf16)
            + f" (no spill stores); the {len(others)} float32 SIMT kernels "
            f"{sum(hmma[fn] for fn in others)}")


def flash_selfcheck(gen) -> None:
    """Phase 3, flash attention: the grid of small shapes, both dtypes,
    the forwards (#10, #11) and the backward (#12)."""
    worst, worst_bwd = {}, {}
    dgen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_GRID:
            name, b, sq, skv, h, hk, dh, causal, window, q_offset = case
            q, k, v = (torch.randn(shape, generator=gen).to("cuda", dtype)
                       for shape in ((b, sq, h, dh), (b, skv, hk, dh),
                                     (b, skv, hk, dh)))
            kw = dict(causal=causal, window=window, q_offset=q_offset,
                      block_q=64, block_kv=64)
            err = compare_flash(q, k, v, kw, f"flash {name} {dtype}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            err = compare_flash_bwd(q, k, v, kw, f"flash bwd {name} {dtype}",
                                    dgen)
            worst_bwd[dtype] = max(worst_bwd.get(dtype, 0.0), err)
    log(f"  flash_attention / flash_attention_fwd: {len(FLASH_GRID)} shapes "
        f"x (f32, bf16) within tolerance of the plain version, #11's o "
        f"bit-equal to #10's; max |o err| f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}")
    log(f"  flash_attention_bwd: the same {len(FLASH_GRID)} shapes x (f32, "
        f"bf16) within tolerance of the plain version, launches bit-equal; "
        f"max |dq, dk, dv err| f32 {worst_bwd[torch.float32]:.3g}, bf16 "
        f"{worst_bwd[torch.bfloat16]:.3g}")


def lse_of_scores(q, k, causal: bool) -> torch.Tensor:
    """torch.logsumexp of the plain float32 scores, head by head: (B, H,
    Sq)."""
    b, sq, h, dh = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.tril(keep)
    out = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for hh in range(h):
        s = torch.einsum("bqd,bkd->bqk", q[:, :, hh].float(),
                         k[:, :, hh // g].float()) * dh ** -0.5
        out[:, hh] = torch.logsumexp(s.masked_fill(~keep, -torch.inf), -1)
    return out


def flash_at_model_shapes(cfg) -> dict:
    """Phase 8: #10 and #11 at the model's attention shape against their
    plain versions (f32 and bf16, B=1), #11's lse against logsumexp of the
    plain scores, then times at B=4 in bf16 beside the plain version, SDPA
    and the bound. Returns {kernel: record fields}."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_fwd, flash_attention_plain)
    from repro_torch.roofline import kernel_costs as kc
    h, hk, dh, s = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, RAG_PROMPT
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    kw = dict(causal=True, block_q=min(cfg.attn_chunk_q, 256),
              block_kv=cfg.attn_chunk_kv)

    def qkv(b, dtype):
        return [torch.randn((b, s, n, dh), generator=gen, device="cuda"
                            ).to(dtype) for n in (h, hk, hk)]

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(1, dtype)
        errs[dtype] = compare_flash(q, k, v, kw,
                                    f"flash at (1, {s}, {h}/{hk}, {dh}) "
                                    f"{dtype}")
        _, lse = flash_attention_fwd(q, k, v, **kw)
        lse_err = float((lse - lse_of_scores(q, k, True)).abs().max())
        check(lse_err <= LSE_ATOL, f"flash_attention_fwd {dtype}: lse max "
              f"|err| {lse_err} against logsumexp of the plain scores")
        log(f"  flash at (B=1, S={s}, H={h}, Hk={hk}, Dh={dh}) causal "
            f"{dtype}: o max |err| vs plain {errs[dtype]:.3g}, #11 o "
            f"bit-equal to #10, lse max |err| vs logsumexp {lse_err:.3g}")
        del q, k, v, lse
    b = RAG_GEN_BATCH
    q, k, v = qkv(b, torch.bfloat16)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms10 = cuda_ms(lambda: flash_attention(q, k, v, **kw), 5)
    ms11 = cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw), 5)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True), 5)
    c10 = kc.flash_attention(b, s, s, h, hk, dh, causal=True)
    flops = c10.flops
    b_ms, b_by = c10.bound()
    # #11 also writes the (B, H, S) float32 lse
    b11_ms, b11_by = kc.flash_attention_fwd(b, s, s, h, hk, dh,
                                            causal=True).bound()
    log(f"  flash at (B={b}, S={s}) bf16: #10 {ms10:.3f} ms, #11 "
        f"{ms11:.3f} ms, plain {plain_ms:.3f} ms, SDPA (is_causal, "
        f"enable_gqa) {lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{flops / 1e12:.3f} TFLOP at 989 TFLOP/s); #10 reaches "
        f"{flops / ms10 / 1e9:.1f} TFLOP/s")
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    common = dict(route="cuda",
                  source="src/repro_torch/csrc/flash_attention.cu",
                  max_abs_err=errs[torch.bfloat16], plain_ms=plain_ms,
                  library_ms=lib_ms)
    return {"flash_attention": dict(
                name="flash_attention",
                replaces="src/repro/kernels/flash_attention/flash_kernel.py:83",
                ms=ms10, bound_ms=b_ms, bound_by=b_by, **common),
            "flash_attention_fwd": dict(
                name="flash_attention_fwd",
                replaces="src/repro/kernels/flash_attention/flash_kernel.py:257",
                ms=ms11, bound_ms=b11_ms, bound_by=b11_by, **common)}


# ------------------------------------------------------- RAG serving (phase 8)
RAG_ARCH = "starcoder2-7b"
RAG_DOCS, RAG_DOC_LEN = 2048, 128
RAG_FIRST, RAG_BATCH, RAG_STREAM = 1536, 64, 256
RAG_EVICT = 128
RAG_QUERIES, RAG_QUERIES_EVICTED, RAG_K, RAG_BEAM = 256, 32, 4, 32
RAG_PROMPT, RAG_GEN_BATCH, RAG_NEW_TOKENS = 4096, 4, 32
RAG_COSINE_FLOOR = 0.999


class CountCalls:
    """Count the calls of module.name while the block runs."""

    def __init__(self, module, name: str):
        self.module, self.name, self.n = module, name, 0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(*a, **kw):
            self.n += 1
            return self.orig(*a, **kw)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def rag_serving() -> list:
    """Phase 8; returns the flash kernels' JSON records."""
    import repro_torch.models.attention as attention_mod
    from repro_torch.configs import get_config
    from repro_torch.core.search_spec import SearchSpec
    from repro_torch.models.model import (decode_step, init_params,
                                          param_count, prefill)
    from repro_torch.serving.rag import RagPipeline, embed_texts
    from repro_torch.serving.serve_loop import generate
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(RAG_ARCH), dtype="bfloat16",
                              use_flash_kernel=True)
    n_layers = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, SEED)
    torch.cuda.synchronize()
    n_params = param_count(params)
    log(f"  model: {cfg.name} ({n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads on {cfg.num_kv_heads} KV heads, Dh "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}), {n_params:,} parameters "
        f"({n_params / 1e9:.2f} B) in bf16, initialised in "
        f"{time.perf_counter() - t0:.1f} s; max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    records = flash_at_model_shapes(cfg)

    # ---- ingest: build + streamed inserts, then evict
    rng = np.random.default_rng(SEED)
    corpus = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (RAG_DOCS, RAG_DOC_LEN)).astype(np.int32)).cuda()
    pipe = RagPipeline(params, cfg, capacity=RAG_DOCS)
    spans = ([(a, a + RAG_BATCH) for a in range(0, RAG_FIRST, RAG_BATCH)]
             + [(a, a + RAG_STREAM) for a in range(RAG_FIRST, RAG_DOCS,
                                                     RAG_STREAM)])

    def ingest():
        for a, e in spans:
            ids = pipe.ingest(corpus[a:e], list(range(a, e)))
            check(np.array_equal(ids, np.arange(a, e)),
                  f"ingest [{a}, {e}) got rows {ids[:4]}...")
    path_launches = {}
    with CountCalls(attention_mod, "blockwise_attention") as bw:
        _, secs, launched = counted(ingest)
    log(f"  ingest: {RAG_DOCS} documents of {RAG_DOC_LEN} tokens in "
        f"{len(spans)} calls ({RAG_FIRST // RAG_BATCH} x {RAG_BATCH}, the "
        f"first builds; {(RAG_DOCS - RAG_FIRST) // RAG_STREAM} x "
        f"{RAG_STREAM} streamed): {secs:.2f} s "
        f"({RAG_DOCS * RAG_DOC_LEN / secs:.0f} tokens/s embedded and "
        f"indexed); index size {pipe.index.size}; launches {launched}")
    check(launched == counts(flash_attention=n_layers * len(spans)),
          f"ingest launched {launched}, expected {n_layers} flash_attention "
          f"per forward x {len(spans)} forwards and nothing else")
    check(bw.n == 0, f"ingest ran blockwise_attention {bw.n} times")
    path_launches["ingest"] = launched
    evicted = np.sort(rng.choice(RAG_DOCS, RAG_EVICT, replace=False))
    check(pipe.evict(evicted) == RAG_EVICT, "evict count")
    check(pipe.index.size == RAG_DOCS - RAG_EVICT, "size after evict")

    # ---- the kernel path against the blockwise path
    e_flash = embed_texts(params, cfg, corpus[:RAG_BATCH])
    e_block = embed_texts(params, dataclasses.replace(
        cfg, use_flash_kernel=False), corpus[:RAG_BATCH])
    cos = torch.nn.functional.cosine_similarity(e_flash, e_block, dim=1)
    rel = float(((e_flash - e_block).norm(dim=1) / e_block.norm(dim=1)).max())
    log(f"  kernel vs blockwise embeddings of {RAG_BATCH} documents: cosine "
        f"min {float(cos.min()):.6f}, max relative error {rel:.3g}")
    check(float(cos.min()) >= RAG_COSINE_FLOOR,
          f"kernel vs blockwise cosine {float(cos.min()):.6f}")

    # ---- retrieve: self-queries, some of them evicted
    dead = set(evicted.tolist())
    live = np.array([i for i in range(RAG_DOCS) if i not in dead])
    qdocs = np.concatenate([
        rng.choice(live, RAG_QUERIES - RAG_QUERIES_EVICTED, replace=False),
        rng.choice(evicted, RAG_QUERIES_EVICTED, replace=False)])
    q_tok = corpus[torch.as_tensor(qdocs).cuda()]
    with CountCalls(attention_mod, "blockwise_attention") as bw:
        got, secs, launched = counted(
            lambda: pipe.retrieve(q_tok, k=RAG_K, beam_width=RAG_BEAM))
    check(launched == counts(flash_attention=n_layers) and bw.n == 0,
          f"retrieve launched {launched} (blockwise {bw.n})")
    path_launches["retrieve"] = launched
    leaked = sum(p in dead for row in got for p in row)
    n_live = RAG_QUERIES - RAG_QUERIES_EVICTED
    self_hit = float(np.mean([bool(got[i]) and got[i][0] == qdocs[i]
                              for i in range(n_live)]))
    q_emb = embed_texts(params, cfg, q_tok)
    res = pipe.index.searcher(SearchSpec(k=RAG_K, beam_width=RAG_BEAM)
                              ).search(q_emb)
    ids = res.ids.cpu().numpy()
    tomb = int(pipe.index.tombstoned(ids[ids >= 0]).sum())
    gt, _ = pipe.index.brute_force(q_emb, RAG_K)
    rec = recall_at(res.ids, gt)
    log(f"  retrieve {RAG_QUERIES} self-queries ({RAG_QUERIES_EVICTED} of "
        f"evicted documents), k={RAG_K}, beam {RAG_BEAM}: {secs:.3f} s, "
        f"self-hit@1 on live documents {self_hit:.4f}, recall@{RAG_K} vs "
        f"brute force {rec:.4f}, evicted payloads returned {leaked}, "
        f"tombstoned ids {tomb}")
    check(leaked == 0 and tomb == 0, "retrieve returned evicted documents")
    check(self_hit >= SELF_HIT_FLOOR, f"self-hit {self_hit:.4f}")
    check(rec >= RECALL_FLOOR, f"retrieve recall@{RAG_K} {rec:.4f}")
    mk = pipe.index.searcher(SearchSpec(
        k=RAG_K, beam_width=RAG_BEAM, quantized=True, use_kernels=True,
        fusion="megakernel"))
    res, secs, launched = counted(lambda: mk.search(q_emb))
    ids = res.ids.cpu().numpy()
    check(int(pipe.index.tombstoned(ids[ids >= 0]).sum()) == 0,
          "megakernel lane returned tombstoned ids")
    check(launched == counts(fused_search=1, gather_l2=1),
          f"megakernel lane launched {launched}")
    log(f"  the same index through the megakernel lane (4-bit codes of "
        f"{pipe.index.rabitq_codes.packed.shape[1]} B at D={cfg.d_model}, "
        f"exact rerank): recall@{RAG_K} {recall_at(res.ids, gt):.4f}, "
        f"{secs:.3f} s, launches {launched}")

    # ---- generate: prompts that open with the top-1 retrieved document
    top1 = [got[i][0] for i in range(RAG_GEN_BATCH)]
    filler = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (RAG_GEN_BATCH, RAG_PROMPT - RAG_DOC_LEN)
    ).astype(np.int32)).cuda()
    prompts = torch.cat([corpus[torch.as_tensor(top1).cuda()], filler], 1)
    timings = {}
    with CountCalls(attention_mod, "blockwise_attention") as bw:
        out, secs, launched = counted(lambda: generate(
            params, cfg, prompts, max_new_tokens=RAG_NEW_TOKENS,
            timings=timings))
    check(launched == counts(flash_attention=n_layers) and bw.n == 0,
          f"generate launched {launched} (blockwise {bw.n}), expected "
          f"{n_layers} flash_attention for the prefill")
    path_launches["generate"] = launched
    check(tuple(out.shape) == (RAG_GEN_BATCH, RAG_PROMPT + RAG_NEW_TOKENS),
          f"generate returned {tuple(out.shape)}")
    check(torch.equal(out[:, :RAG_PROMPT], prompts),
          "generate changed the prompts")
    check(bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
          "generated ids out of the vocab")
    n_dec = RAG_GEN_BATCH * (RAG_NEW_TOKENS - 1)
    log(f"  generate {RAG_GEN_BATCH} x {RAG_PROMPT} prompts + "
        f"{RAG_NEW_TOKENS} greedy tokens: {secs:.2f} s; prefill (with the "
        f"first token) {timings['prefill_s']:.3f} s "
        f"({RAG_GEN_BATCH * RAG_PROMPT / timings['prefill_s']:.0f} tokens/s)"
        f", decode {timings['decode_s']:.3f} s for {n_dec} tokens "
        f"({n_dec / timings['decode_s']:.1f} tokens/s, "
        f"{1e3 * timings['decode_s'] / (RAG_NEW_TOKENS - 1):.1f} ms per "
        f"step); flash_attention launches in the prefill "
        f"{launched['flash_attention']}; sample "
        f"{out[0, -8:].tolist()}")
    # where a request's time goes: the prefill and three decode steps
    # again under the profiler (not counted: the path's counts are read)
    with torch.inference_mode():
        _, state = profile_device(lambda: prefill(
            params, cfg, {"tokens": prompts}, max_len=RAG_PROMPT
            + RAG_NEW_TOKENS), f"prefill of {RAG_GEN_BATCH} x {RAG_PROMPT}")

        def three_steps(state=state):
            for t in range(3):
                _, state = decode_step(params, cfg, state, out[:, RAG_PROMPT
                                                             + t, None])
        profile_device(three_steps, "three decode steps")
        # by formula: the weights and the cache's first RAG_PROMPT + 1
        # positions read once, 2·N·B products (attention's left out)
        kv_read = (tensor_bytes(state["k"], state["v"]) * (RAG_PROMPT + 1)
                   // state["k"].shape[2])
        ROOFLINE["decode_step"] = roofline_share(
            f"a {RAG_ARCH} decode step (B={RAG_GEN_BATCH}, cache "
            f"{RAG_PROMPT + RAG_NEW_TOKENS}) against generate's mean step",
            lambda: decode_step(params, cfg, state,
                                out[:, RAG_PROMPT, None]),
            timings["decode_s"] / (RAG_NEW_TOKENS - 1), want_kernels={},
            fixed=(tensor_bytes(params) + kv_read,
                   2.0 * n_params * RAG_GEN_BATCH,
                   "the weights and the cache read once, 2·N·B"))
    total = {name: sum(p[name] for p in path_launches.values())
             for name in ("flash_attention", "flash_attention_fwd")}
    log(f"  phase 8: {time.perf_counter() - t_phase:.1f} s; flash launches "
        f"on the serving path (ingest + retrieve + prefill) {total}; max "
        f"memory allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for name, rec in records.items():
        rec["launches"] = total[name]
    return [records["flash_attention"], records["flash_attention_fwd"]]


# ------------------------------------------------------- training (phase 9)
TRAIN_ARCH = "minicpm-2b"
TRAIN_SEQ = 4096               # the repo's train_4k sequence (SHAPES)
TRAIN_BATCH, TRAIN_ACCUM = 4, 2   # global batch cut from 256 for one card
TRAIN_STEPS, MEMO_STEPS, MEMO_LR = 4, 3, 1e-3
GRAD_COSINE_FLOOR = 0.999
LOSS_REL_TOL, RESUME_REL_TOL = 1e-3, 1e-4
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
GEMM_KERNEL = re.compile(r"gemm|nvjet|xmma|cutlass|wgmma", re.I)


def flash_at_train_shapes(cfg) -> dict:
    """Phase 9 (a) and (b), at the training microbatch (B=2, S=4,096):
    #10/#11 and #12 against their plain versions at minicpm's attention
    shape (36/36, Dh 64) in float32 and bf16, and #12 at starcoder2-7b's
    (36/4, Dh 128: the group of 9 at full width); #10/#11 and #12 at
    stablelm-3b's (B=1, 32/32, Dh 80) in bf16; then #11 and #12 timed
    in bf16 beside their plain versions, SDPA's forward and backward and
    their bounds. Returns {kernel: record fields} for #11 and #12."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)
    from repro_torch.roofline import kernel_costs as kc
    s, b = TRAIN_SEQ, TRAIN_BATCH // TRAIN_ACCUM
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    kw = dict(causal=True, block_q=min(cfg.attn_chunk_q, 256),
              block_kv=cfg.attn_chunk_kv)

    def qkv(h, hk, dh, dtype):
        return [torch.randn((b, s, n, dh), generator=gen, device="cuda"
                            ).to(dtype) for n in (h, hk, hk)]

    fwd_errs, bwd_errs = {}, {}
    other = get_config("starcoder2-7b")
    for arch, c in ((cfg.name, cfg), (other.name, other)):
        h, hk, dh = c.num_heads, c.num_kv_heads, c.head_dim
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(h, hk, dh, dtype)
            shape = f"({b}, {s}, {h}/{hk}, {dh}) {dtype}"
            if arch == cfg.name:
                fwd_errs[dtype] = compare_flash(q, k, v, kw,
                                                f"flash at {shape}")
                log(f"  flash at {arch}'s shape (B={b}, S={s}, H={h}, "
                    f"Hk={hk}, Dh={dh}) causal {dtype}: o max |err| vs "
                    f"plain {fwd_errs[dtype]:.3g}, #11 o bit-equal to #10")
            err = compare_flash_bwd(q, k, v, kw, f"flash bwd at {shape}", gen)
            if arch == cfg.name:
                bwd_errs[dtype] = err
            log(f"  flash_attention_bwd at {arch}'s shape (B={b}, S={s}, "
                f"H={h}, Hk={hk}, Dh={dh}) causal {dtype}: max |dq, dk, dv "
                f"err| vs plain {err:.3g}, launches bit-equal")
            del q, k, v

    # stablelm-3b's attention (32 heads of 80), one sequence, bf16
    c3 = get_config("stablelm-3b")
    h, hk, dh = c3.num_heads, c3.num_kv_heads, c3.head_dim
    q, k, v = [torch.randn((1, s, n, dh), generator=gen, device="cuda"
                           ).to(torch.bfloat16) for n in (h, hk, hk)]
    shape = f"(1, {s}, {h}/{hk}, {dh}) bf16"
    err_f = compare_flash(q, k, v, kw, f"flash at {shape}")
    err_b = compare_flash_bwd(q, k, v, kw, f"flash bwd at {shape}", gen)
    log(f"  flash at {c3.name}'s shape (B=1, S={s}, H={h}, Hk={hk}, "
        f"Dh={dh}) causal bf16: o max |err| vs plain {err_f:.3g}, #11 o "
        f"bit-equal to #10; max |dq, dk, dv err| {err_b:.3g}, launches "
        f"bit-equal")
    del q, k, v

    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = qkv(h, hk, dh, torch.bfloat16)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    ms11 = cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw), 5)
    plain11_ms = cuda_ms(lambda: flash_attention_fwd_plain(q, k, v, **kw), 2)
    ms12 = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw), 5)
    plain12_ms = cuda_ms(lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, **kw), 2)
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    lib11_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True), 5)
    oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    doh = do.transpose(1, 2).contiguous()
    lib12_ms = cuda_ms(lambda: torch.autograd.grad(oh, (qh, kh, vh), doh,
                                                   retain_graph=True), 5)
    # the forward: 2 products of B*H*S^2*Dh/2 multiply-adds; the
    # backward's work 5 (s recomputed, dp, dv, dq, dk; the kernel pair's
    # second s and dp are its own cost, not counted)
    c11 = kc.flash_attention_fwd(b, s, s, h, hk, dh, causal=True)
    c12 = kc.flash_attention_bwd(b, s, s, h, hk, dh, causal=True)
    flops11, flops12 = c11.flops, c12.flops
    b11_ms, b11_by = c11.bound()
    b12_ms, b12_by = c12.bound()
    log(f"  flash at the training microbatch (B={b}, S={s}, H={h}, Hk={hk}, "
        f"Dh={dh}) bf16: #11 {ms11:.3f} ms, plain {plain11_ms:.3f} ms, SDPA "
        f"(is_causal) {lib11_ms:.3f} ms, bound {b11_ms:.4f} ms ({b11_by}: "
        f"{flops11 / 1e12:.3f} TFLOP at 989 TFLOP/s), #11 reaches "
        f"{flops11 / ms11 / 1e9:.1f} TFLOP/s; #12 {ms12:.3f} ms, plain "
        f"{plain12_ms:.3f} ms, SDPA backward (is_causal) {lib12_ms:.3f} ms, "
        f"bound {b12_ms:.4f} ms ({b12_by}: {flops12 / 1e12:.3f} TFLOP), #12 "
        f"reaches {flops12 / ms12 / 1e9:.1f} TFLOP/s")
    del q, k, v, do, o, lse, qh, kh, vh, oh, doh
    torch.cuda.empty_cache()
    src = "src/repro/kernels/flash_attention/flash_kernel.py"
    return {"flash_attention_fwd": dict(
                name="flash_attention_fwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces=f"{src}:257", max_abs_err=fwd_errs[torch.bfloat16],
                ms=ms11, plain_ms=plain11_ms, bound_ms=b11_ms,
                bound_by=b11_by, library_ms=lib11_ms),
            "flash_attention_bwd": dict(
                name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention_bwd.cu",
                replaces=f"{src}:302", max_abs_err=bwd_errs[torch.bfloat16],
                ms=ms12, plain_ms=plain12_ms, bound_ms=b12_ms,
                bound_by=b12_by, library_ms=lib12_ms)}


def grads_of(params, cfg, batch):
    """(loss, every parameter's gradient flattened into one float32
    vector) of loss_fn, the gradients then cleared."""
    from repro_torch.models.model import loss_fn
    loss, _ = loss_fn(params, cfg, batch)
    loss.backward()
    flat = torch.cat([p.grad.flatten() for p in params.parameters()])
    params.zero_grad(set_to_none=True)
    return float(loss.detach()), flat


def two_layer_checks(cfg) -> None:
    """Phase 9 (c), minicpm's widths at 2 layers, B=1, S=4,096, float32
    masters: the kernel path's gradients against the blockwise path's, a
    bit-equal checkpoint round trip, and a resume (2 steps, save, restore
    into another state, 1 step) against 3 straight steps."""
    import shutil
    from repro_torch.data.synthetic import TokenDataset
    from repro_torch.models.model import init_params
    from repro_torch.training import (OptimizerConfig, init_train_state,
                                      make_train_step, restore_checkpoint,
                                      save_checkpoint)
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    data = TokenDataset(cfg2, 1, TRAIN_SEQ, seed=SEED)

    def fresh(seed):
        return init_train_state(cfg2, init_params(cfg2, seed,
                                                  param_dtype=torch.float32))

    state = fresh(SEED)
    loss_k, g_k = grads_of(state.params, cfg2, data(0))
    with CountCalls(__import__("repro_torch.models.attention",
                               fromlist=["x"]), "blockwise_attention") as bw:
        loss_b, g_b = grads_of(state.params, dataclasses.replace(
            cfg2, use_flash_kernel=False), data(0))
    check(bw.n > 0, "the blockwise path did not run blockwise_attention")
    cos = float(torch.nn.functional.cosine_similarity(g_k, g_b, dim=0))
    rel = abs(loss_k - loss_b) / abs(loss_b)
    log(f"  2 layers at minicpm's widths, B=1, S={TRAIN_SEQ}: kernel path "
        f"vs blockwise path: loss {loss_k:.6f} vs {loss_b:.6f} (relative "
        f"{rel:.3g}), gradient cosine over all {g_k.numel():,} parameters "
        f"{cos:.6f}, relative norm of the difference "
        f"{float((g_k - g_b).norm() / g_b.norm()):.3g}")
    check(cos >= GRAD_COSINE_FLOOR, f"gradient cosine {cos:.6f}")
    check(rel <= LOSS_REL_TOL, f"loss relative difference {rel:.3g}")
    del g_k, g_b

    opt = OptimizerConfig(peak_lr=MEMO_LR, schedule="wsd", warmup_steps=1,
                          total_steps=3)
    step = make_train_step(cfg2, opt)
    straight = []
    for t in range(3):
        state, m = step(state, data(t))
        straight.append(float(m["loss"]))
    del state
    state = fresh(SEED)
    for t in range(2):
        state, _ = step(state, data(t))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    path = save_checkpoint(str(CKPT_DIR), 2, state)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = restore_checkpoint(str(CKPT_DIR), 2, fresh(SEED + 1))
    t_restore = time.perf_counter() - t0
    size = Path(path).stat().st_size
    same = all(torch.equal(a, b) for a, b in zip(
        state.params.parameters(), back.params.parameters()))
    same &= all(torch.equal(state.opt_state[key][n], back.opt_state[key][n])
                for key in ("m", "v") for n in state.opt_state[key])
    same &= back.opt_state["step"] == state.opt_state["step"] == 2
    check(same, "checkpoint round trip is not bit-equal")
    del state
    back, m = step(back, data(2))
    resumed = float(m["loss"])
    rel = abs(resumed - straight[2]) / abs(straight[2])
    log(f"  checkpoint of 2 layers (parameters, m, v: {size / 1e9:.2f} GB "
        f"npz) saved in {t_save:.1f} s, restored into another state in "
        f"{t_restore:.1f} s, bit-equal; resume: step 3 loss {resumed:.6f} "
        f"vs {straight[2]:.6f} straight (relative {rel:.3g}; losses "
        f"{[round(x, 6) for x in straight]})")
    check(rel <= RESUME_REL_TOL, f"resumed loss relative difference {rel:.3g}")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)


def step_split(step_fn, state, batch) -> tuple:
    """One more train step under torch.profiler: device time of #11, #12,
    the GEMMs and everything else, the device's busy share. Returns (new
    state, metrics)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    split = {"#11 flash_fwd": 0.0, "#12 flash_bwd": 0.0, "GEMMs": 0.0,
             "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        if "flash_fwd_" in e.key:        # flash_fwd_kernel, flash_fwd_bf16_kernel
            split["#11 flash_fwd"] += ms
        elif "flash_bwd_" in e.key:
            split["#12 flash_bwd"] += ms
        elif GEMM_KERNEL.search(e.key):
            split["GEMMs"] += ms
        else:
            split["other"] += ms
    busy = sum(split.values())
    if busy == 0:
        log("  profile (train step): the profiler recorded no device time")
    else:
        log(f"  profile of one train step: wall {wall_ms:.0f} ms, device busy "
            f"{busy:.0f} ms ({100 * busy / wall_ms:.1f}%): " + ", ".join(
                f"{k} {v:.0f} ms ({100 * v / busy:.1f}%)"
                for k, v in split.items()))
    return state, m


def separate_times(cfg, state) -> None:
    """CUDA-event times of the two parts the profile's kernel names do not
    separate: the loss head (final norm, tied unembed and float32 CE,
    forward + backward, one microbatch) and the AdamW update."""
    from repro_torch.models.model import _logits, cross_entropy
    from repro_torch.training import OptimizerConfig, adamw_update
    params = state.params
    mb = TRAIN_BATCH // TRAIN_ACCUM
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    x = torch.randn((mb, TRAIN_SEQ, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16).requires_grad_()
    labels = torch.randint(0, cfg.vocab_size, (mb, TRAIN_SEQ),
                           generator=gen, device="cuda")

    def head():
        cross_entropy(_logits(params, cfg, x), labels,
                      cfg.vocab_size).backward()
    head_ms = cuda_ms(head, 2)
    params.zero_grad(set_to_none=True)
    del x
    grads = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
    opt_ms = cuda_ms(lambda: adamw_update(OptimizerConfig(), grads,
                                          state.opt_state, params), 2)
    del grads
    log(f"  separately timed: the loss head (final norm, tied unembed, CE; "
        f"forward + backward of one microbatch) {head_ms:.1f} ms, x "
        f"{TRAIN_ACCUM} per step; the AdamW update of "
        f"{sum(p.numel() for p in params.parameters()):,} float32 "
        f"parameters {opt_ms:.1f} ms")


def training() -> tuple[dict, dict]:
    """Phase 9; returns (#11's and #12's JSON records at the training
    microbatch, the training path's launch counts)."""
    import repro_torch.models.attention as attention_mod
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.launch import train
    from repro_torch.models.model import init_params, param_count
    from repro_torch.roofline.analysis import H100
    from repro_torch.training import (OptimizerConfig, init_train_state,
                                      make_train_step)
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), use_flash_kernel=True)
    records = flash_at_train_shapes(cfg)
    two_layer_checks(cfg)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) full width through the launcher's run
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--grad-accum",
            str(TRAIN_ACCUM), "--seed", str(SEED), "--log-every", "1"]
    args = train.parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    with CountCalls(attention_mod, "blockwise_attention") as bw:
        out, secs, launched = counted(lambda: train.run(args))
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    n_layers = cfg.num_layers
    per_step = counts(flash_attention_fwd=2 * n_layers * TRAIN_ACCUM,
                      flash_attention_bwd=n_layers * TRAIN_ACCUM)
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    ln_v = float(np.log(cfg.vocab_size))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = [h["seconds"] for h in hist]
    steady = float(np.mean(step_s[1:]))
    log(f"  {TRAIN_ARCH} at full width through launch/train.py run "
        f"({' '.join(argv)}): {TRAIN_STEPS} steps in {secs:.1f} s (with "
        f"init); losses {[round(x, 4) for x in losses]} (ln V = "
        f"{ln_v:.4f}), grad norms "
        f"{[round(h['grad_norm'], 4) for h in hist]}, lr "
        f"{[round(h['lr'], 8) for h in hist]}; seconds per step "
        f"{[round(x, 3) for x in step_s]}; max memory allocated "
        f"{peak / 1e9:.2f} GB; launches {launched}")
    check(out["steps"] == TRAIN_STEPS and len(hist) == TRAIN_STEPS,
          f"run did {out['steps']} steps")
    check(all(np.isfinite([h["loss"] for h in hist]))
          and all(np.isfinite([h["grad_norm"] for h in hist])),
          "a loss or grad norm is not finite")
    check(ln_v - 0.5 <= losses[0] <= ln_v + 3,
          f"first loss {losses[0]:.4f} outside [ln V - 0.5, ln V + 3]")
    check(launched == want, f"launched {launched}, expected {want} "
          f"({per_step} a step: #11 for the forward and the recompute)")
    check(bw.n == 0, f"training ran blockwise_attention {bw.n} times")
    check(peak < 80e9, f"max memory allocated {peak / 1e9:.2f} GB")

    # ---- memorisation: 3 steps at lr 1e-3 on one fixed batch
    params = init_params(cfg, SEED, param_dtype=torch.float32)
    n_params = param_count(params)
    state = init_train_state(cfg, params)
    step_fn = make_train_step(cfg, OptimizerConfig(
        peak_lr=MEMO_LR, schedule="constant", warmup_steps=0,
        total_steps=MEMO_STEPS), grad_accum=TRAIN_ACCUM)
    batch = make_lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, SEED, 0)
    memo, memo_s = [], []
    for _ in range(MEMO_STEPS):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        memo.append(float(m["loss"]))
        torch.cuda.synchronize()
        memo_s.append(time.perf_counter() - t0)
    log(f"  memorisation, {MEMO_STEPS} steps at lr {MEMO_LR} on one fixed "
        f"batch: losses {[round(x, 4) for x in memo]}, seconds "
        f"{[round(x, 3) for x in memo_s]}")
    check(all(np.isfinite(memo)) and memo[-1] < memo[0],
          f"the loss did not fall on a fixed batch: {memo}")
    step_t = float(np.mean(memo_s + step_s[1:]))
    mfu = 6.0 * n_params * tokens / step_t / H100.peak_flops
    log(f"  {n_params:,} parameters ({n_params / 1e9:.3f} B); steady step "
        f"{step_t:.3f} s (launcher steps 2-{TRAIN_STEPS} {steady:.3f} s), "
        f"{tokens / step_t:.0f} tokens/s, 6*N*T/step time "
        f"{6.0 * n_params * tokens / step_t / 1e12:.1f} TFLOP/s = "
        f"{100 * mfu:.2f} % of 989 TFLOP/s")
    state, _ = step_split(step_fn, state, batch)
    separate_times(cfg, state)
    fwd_calls = 2 * n_layers * TRAIN_ACCUM
    share = roofline_share(
        f"a {TRAIN_ARCH} train step ({TRAIN_BATCH} x {TRAIN_SEQ}, accum "
        f"{TRAIN_ACCUM}) against the steady step",
        lambda: step_fn(state, batch), step_t,
        want_kernels={"flash_attention_fwd": fwd_calls,
                      "flash_attention_bwd": fwd_calls // 2},
        # by formula: 6·N·T, the float32 parameters and both moments read
        # and written once (activations left out)
        fixed=(2 * tensor_bytes(state.params, state.opt_state),
               6.0 * n_params * tokens,
               "6·N·T, the train state read and written once"))
    share["model_flops"] = 6.0 * n_params * tokens
    log(f"  [16] 6*N*T = {share['model_flops'] / 1e12:.4f} TFLOP against "
        f"{share['flops'] / 1e12:.4f} counted (ratio "
        f"{share['model_flops'] / share['flops']:.4f})")
    ROOFLINE["train_step"] = share
    del state, params, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")
    return records, launched


# ---------------------------------------- the other LM families (phase 14)
# arch, prompt length (frames for the encoder), #10 launches a forward,
# the prompt length profiled: xlstm's sLSTM launches ~21 kernels a token a
# layer, so a profiled 4 x 1,024 prefill records 132,187 device
# activities and the profiler's summary of them took over a minute on the
# card; 128 tokens show the same launch-bound step
FAMILY_RUNS = (("olmoe-1b-7b", 1024, 16, 1024),
               ("zamba2-2.7b", 4096, 9, 4096),
               ("xlstm-125m", 1024, 0, 128),
               ("hubert-xlarge", 1024, 48, 1024))
FAMILY_BATCH, FAMILY_NEW_TOKENS = 4, 32
FAMILY_CHECK = (2, 512)        # the kernel path against the blockwise path
FAMILY_COSINE_FLOOR = 0.999
DECODE_CHECK_CF = 8.0          # no MoE route drops: decode == forward
# #10 at the attention shapes phase 14 adds: name, S, H, Hk, Dh, causal,
# window (zamba2's window is its prompt, so SDPA's causal mask is its mask)
FAMILY_FLASH = (("hubert-xlarge", 1024, 16, 16, 80, False, 0),
                ("zamba2-2.7b", 4096, 32, 32, 80, True, 4096),
                ("olmoe-1b-7b", 1024, 16, 16, 128, True, 0))


def flash_at_family_shapes() -> list:
    """#10 against its plain version (B=1, bf16) at the three attention
    shapes phase 14 adds — bidirectional at Dh 80, window 4,096 at Dh 80,
    16/16 heads at Dh 128 — then timed at B=4 beside the plain version,
    SDPA and the bound. Returns one record a shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.roofline import kernel_costs as kc
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    out = []
    for arch, s, h, hk, dh, causal, window in FAMILY_FLASH:
        kw = dict(causal=causal, window=window, block_q=256, block_kv=1024)

        def qkv(b):
            return [torch.randn((b, s, n, dh), generator=gen, device="cuda"
                                ).to(torch.bfloat16) for n in (h, hk, hk)]
        q, k, v = qkv(1)
        err = compare_flash(q, k, v, kw, f"flash at {arch}'s (1, {s}, "
                            f"{h}/{hk}, {dh})")
        b = FAMILY_BATCH
        q, k, v = qkv(b)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), 5)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), 2)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal), 5)
        c10 = kc.flash_attention(b, s, s, h, hk, dh, causal=causal,
                                 window=window)
        flops = c10.flops
        b_ms, b_by = c10.bound()
        log(f"  flash at {arch}'s (B={b}, S={s}, H={h}, Hk={hk}, Dh={dh}, "
            f"{'causal' if causal else 'bidirectional'}"
            f"{f', window {window}' if window else ''}) bf16: #10 "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, SDPA {lib_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); #10 reaches "
            f"{flops / ms / 1e9:.1f} TFLOP/s; max |err| vs plain (B=1) "
            f"{err:.3g}")
        out.append(dict(arch=arch, shape=[b, s, h, hk, dh], causal=causal,
                        window=window, ms=ms, plain_ms=plain_ms,
                        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                        max_abs_err=err))
        del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    return out


class RecordRoutes:
    """Record every `moe_routing` call while the block runs: its routes,
    kept routes and top experts (device tensors, no sync) and the first
    call's logits."""

    def __init__(self, module):
        self.module, self.first = module, None
        self.routes, self.kept, self.top_e = [], [], []

    def __enter__(self):
        self.orig = self.module.moe_routing

        def wrapped(logits, k, cap):
            r = self.orig(logits, k, cap)
            if self.first is None:
                self.first = (logits.clone(), k, cap, r)
            self.routes.append(r["keep"].numel())
            self.kept.append(r["keep"].sum())
            self.top_e.append(r["top_e"])
            return r
        self.module.moe_routing = wrapped
        return self

    def __exit__(self, *exc):
        self.module.moe_routing = self.orig


def _cosines(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine of each leading row of a and b, flattened, in float32."""
    return torch.nn.functional.cosine_similarity(
        a.float().flatten(1), b.float().flatten(1), dim=1)


def _family_inputs(cfg, b: int, s: int, gen) -> dict:
    if cfg.frontend == "frames":
        return {"frames": torch.randn((b, s, cfg.d_model), generator=gen,
                                      device="cuda")}
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                    device="cuda", dtype=torch.int32)}


def moe_routes(params, cfg, batch) -> dict:
    """Routes dropped at the configuration's capacity factor in one
    forward of `batch`, and the card's routing of the first layer's
    router logits against the CPU's (positions and keep mask bit-equal)."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.models.model import forward
    with RecordRoutes(moe_mod) as rec:
        forward(params, cfg, batch)
    kept = [int(n) for n in torch.stack(rec.kept).cpu()]
    dropped = [n - k for n, k in zip(rec.routes, kept)]
    logits, k, cap, card = rec.first
    cpu = moe_mod.moe_routing(logits.cpu(), k, cap)
    same = {key: torch.equal(card[key].cpu(), cpu[key])
            for key in ("pos", "keep", "top_e")}
    log(f"  {cfg.name} routing at capacity factor {cfg.capacity_factor} "
        f"(cap {cap} a expert, {rec.routes[0]} routes a layer): dropped "
        f"{sum(dropped)} of {sum(rec.routes)} routes "
        f"({100 * sum(dropped) / sum(rec.routes):.2f} %), by layer "
        f"{dropped}; layer 0 on the card vs the CPU's plain routing: "
        f"{same}")
    check(same["pos"] and same["keep"], f"{cfg.name}: the card's routing "
          f"positions / keep mask differ from the CPU's ({same})")
    return {"routes": sum(rec.routes), "dropped": sum(dropped),
            "dropped_by_layer": dropped, "layer0_card_equals_cpu": same}


def decode_against_forward(params, cfg, out: torch.Tensor, prompt: int
                           ) -> tuple[list, int | None]:
    """Prefill + each decode step over `out`'s generated tokens against one
    forward over all of them: the cosine of each step's logits (the
    batch's rows flattened), and for MoE the routes whose expert set
    differs between the two paths (layers x steps x rows)."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.models.model import decode_step, forward, prefill
    b, n = out.shape
    new = n - prompt
    with RecordRoutes(moe_mod) as rec:
        logits, state = prefill(params, cfg, {"tokens": out[:, :prompt]},
                                max_len=n, last_only=True)
        steps = [logits[:, 0]]
        for t in range(new - 1):
            logits, state = decode_step(params, cfg, state,
                                        out[:, prompt + t:prompt + t + 1])
            steps.append(logits[:, 0])
        del state
        n_dec = len(rec.top_e)
        full = forward(params, cfg, {"tokens": out})[:, prompt - 1:-1]
    cos = [float(c) for c in _cosines(torch.stack(steps),
                                      full.transpose(0, 1))]
    check(all(bool(torch.isfinite(s).all()) for s in steps),
          f"{cfg.name}: a decode step's logits are not finite")
    if cfg.family != "moe":
        return cos, None
    layers = cfg.num_layers
    # the decode path's experts of positions prompt-1 .. n-2, by layer
    dec = [[rec.top_e[i].reshape(b, prompt, -1)[:, -1]
            for i in range(layers)]]
    dec += [[rec.top_e[layers * (1 + t) + i].reshape(b, -1)
             for i in range(layers)] for t in range(new - 1)]
    fwd = [rec.top_e[n_dec + i].reshape(b, n, -1)[:, prompt - 1:-1]
           for i in range(layers)]
    flips = sum(int((dec[t][i].sort(-1).values
                     != fwd[i][:, t].sort(-1).values).any(-1).sum())
                for t in range(new) for i in range(layers))
    return cos, flips


def decode_check_f32(cfg, out: torch.Tensor, prompt: int) -> dict:
    """The decode check held to FAMILY_COSINE_FLOOR: the model again in
    float32 (the same draws from seed 0), each decode step's logits over
    `out`'s generated tokens against one forward over all of them. bf16
    runs of the same check drift with the depth (54 Mamba2 layers) and
    flip MoE routes between the two paths; they are measured and printed
    beside it."""
    from repro_torch.models.model import init_params
    f32 = dataclasses.replace(cfg, dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(f32, SEED)
    cos, flips = decode_against_forward(params, f32, out, prompt)
    del params
    log(f"  the same in float32: cosine min {min(cos):.6f}, at steps "
        f"{[round(c, 5) for c in cos[::8]]}"
        + ("" if flips is None else f"; routes whose experts differ {flips}")
        + f"; max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(min(cos) >= FAMILY_COSINE_FLOOR, f"{cfg.name}: a decode step's "
          f"cosine {min(cos):.6f} against the forward (float32)")
    return {"decode_vs_forward_cosine_min": min(cos), "route_flips": flips}


def family_model(arch: str, prompt: int, n_flash: int, profiled: int
                 ) -> dict:
    """Phase 14, one model at its published width and depth (random bf16
    weights from seed 0, `use_flash_kernel=True`)."""
    import repro_torch.models.attention as attention_mod
    from repro_torch.configs import get_config
    from repro_torch.models.model import (decode_step, forward, init_params,
                                          param_count, prefill)
    from repro_torch.serving.serve_loop import generate
    t_model = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), dtype="bfloat16",
                              use_flash_kernel=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, SEED)
    torch.cuda.synchronize()
    rec = {"arch": arch, "family": cfg.family,
           "params": param_count(params),
           "init_s": time.perf_counter() - t0}
    log(f"  {arch} ({cfg.family}; {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}): {rec['params']:,} parameters in bf16, initialised "
        f"in {rec['init_s']:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    with torch.inference_mode():
        # ---- the kernel path against the blockwise path, 2 x 512 (the
        # cosine of each sequence's logits: a route the rounding flips
        # moves one position of an MoE model, not the sequence)
        if n_flash:
            small = _family_inputs(cfg, *FAMILY_CHECK, gen)
            a = forward(params, cfg, small)
            b = forward(params, dataclasses.replace(
                cfg, use_flash_kernel=False), small)
            seq_cos = _cosines(a, b)
            pos_cos = _cosines(a.flatten(0, 1), b.flatten(0, 1))
            rec["kernel_vs_blockwise_cosine"] = float(seq_cos.min())
            log(f"  kernel vs blockwise logits at {FAMILY_CHECK}: cosine of "
                f"each sequence {[round(float(c), 6) for c in seq_cos]}, of "
                f"each position min {float(pos_cos.min()):.6f}")
            check(float(seq_cos.min()) >= FAMILY_COSINE_FLOOR,
                  f"{arch}: kernel vs blockwise cosine "
                  f"{float(seq_cos.min())}")
            del a, b

        # ---- one forward at the served shape: #10 launches, no blockwise
        batch = _family_inputs(cfg, FAMILY_BATCH, prompt, gen)
        with CountCalls(attention_mod, "blockwise_attention") as bw:
            logits, secs, launched = counted(
                lambda: forward(params, cfg, batch))
        rec["flash_launches_a_forward"] = launched["flash_attention"]
        rec["forward_s"] = secs
        check(launched == counts(flash_attention=n_flash) and bw.n == 0,
              f"{arch}: a forward launched {launched} (blockwise {bw.n}), "
              f"expected {n_flash} flash_attention and nothing else")
        check(bool(torch.isfinite(logits).all()), f"{arch}: NaN in logits")
        log(f"  forward of {FAMILY_BATCH} x {prompt}: {secs:.3f} s, "
            f"flash_attention launches {launched['flash_attention']}")
        del logits
        if cfg.is_encoder:
            frames = batch["frames"].clone()
            frames[:, -1] += 1.0
            h1 = forward(params, cfg, batch, return_hidden=True)[:, 0]
            h2 = forward(params, cfg, {"frames": frames},
                         return_hidden=True)[:, 0]
            moved = float((h1.float() - h2.float()).abs().max())
            log(f"  bidirectional: the last frame moved position 0's "
                f"hidden state by {moved:.4g}")
            check(moved > 0, f"{arch}: the last frame did not reach "
                  "position 0 (not bidirectional)")
            profile_device(lambda: forward(params, cfg, batch),
                           f"{arch} forward of {FAMILY_BATCH} x {prompt}")
            rec["tokens_per_s"] = FAMILY_BATCH * prompt / secs
        else:
            if cfg.family == "moe":
                rec["routing"] = moe_routes(params, cfg, batch)
            prompts = batch["tokens"]
            timings = {}
            with CountCalls(attention_mod, "blockwise_attention") as bw:
                out, secs, launched = counted(lambda: generate(
                    params, cfg, prompts, max_new_tokens=FAMILY_NEW_TOKENS,
                    timings=timings))
            n_dec = FAMILY_BATCH * (FAMILY_NEW_TOKENS - 1)
            rec.update(prefill_s=timings["prefill_s"],
                       decode_ms_a_step=1e3 * timings["decode_s"]
                       / (FAMILY_NEW_TOKENS - 1),
                       tokens_per_s=n_dec / timings["decode_s"],
                       generate_s=secs,
                       flash_launches_generate=launched["flash_attention"])
            log(f"  generate {FAMILY_BATCH} x {prompt} + "
                f"{FAMILY_NEW_TOKENS} greedy tokens: {secs:.2f} s; prefill "
                f"{rec['prefill_s']:.3f} s "
                f"({FAMILY_BATCH * prompt / rec['prefill_s']:.0f} tokens/s)"
                f", decode {rec['decode_ms_a_step']:.2f} ms a step "
                f"({rec['tokens_per_s']:.1f} tokens/s); launches "
                f"{launched}; sample {out[0, -8:].tolist()}")
            check(launched == counts(flash_attention=n_flash)
                  and bw.n == 0, f"{arch}: generate launched {launched} "
                  f"(blockwise {bw.n})")
            check(tuple(out.shape) == (FAMILY_BATCH,
                                       prompt + FAMILY_NEW_TOKENS),
                  f"{arch}: generate returned {tuple(out.shape)}")
            check(torch.equal(out[:, :prompt], prompts),
                  f"{arch}: generate changed the prompts")
            check(bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
                  f"{arch}: generated ids out of the vocab")
            # where a request's time goes
            _, state = profile_device(lambda: prefill(
                params, cfg, {"tokens": prompts[:, :profiled]},
                max_len=profiled + FAMILY_NEW_TOKENS, last_only=True),
                f"{arch} prefill of {FAMILY_BATCH} x {profiled}")

            def three_steps(state=state):
                for t in range(3):
                    _, state = decode_step(params, cfg, state,
                                           out[:, profiled + t, None])
            profile_device(three_steps, f"{arch} three decode steps")
            del state
            # each decode step against one forward over prompt + generated
            # (MoE: no route drops, as the JAX package's own test)
            dcfg = (dataclasses.replace(cfg, capacity_factor=DECODE_CHECK_CF)
                    if cfg.family == "moe" else cfg)
            cos, flips = decode_against_forward(params, dcfg, out, prompt)
            rec.update(decode_vs_forward_cosine_min_bf16=min(cos),
                       route_flips_bf16=flips)
            n_routes = cfg.num_layers * FAMILY_BATCH * FAMILY_NEW_TOKENS
            log(f"  each decode step vs one forward over prompt + generated"
                f" (capacity factor {dcfg.capacity_factor}), bf16: cosine "
                f"min {min(cos):.6f}, at steps "
                f"{[round(c, 5) for c in cos[::8]]}"
                + ("" if flips is None else f"; routes whose experts differ "
                   f"between the paths {flips} of {n_routes}"))
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if not cfg.is_encoder:
        with torch.inference_mode():
            rec.update(decode_check_f32(dcfg, out, prompt))
        del out
        gc.collect()
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_model
    log(f"  {arch}: {rec['seconds']:.1f} s, max memory allocated "
        f"{rec['peak_memory_gb']:.2f} GB (bf16)")
    return rec


# #10 at the shapes a rank of the 16 x 16 prefill_32k cells gives it under
# the serving plan (`models/tensor_parallel.py`): name, B (32 rows over 16
# data ranks), Sq, Skv, H, Hk, Dh, causal, q_offset, window. On the heads
# path a rank's h/16 q and hk/16 kv heads over the whole prompt; on the
# context-parallel fallback its 32,768/16 queries against the gathered K/V
# from its slice's start (the last rank's, 30,720, and the first's, 0);
# zamba2's shared block within its 4,096-token window
TP_PREFILL_FLASH = (
    ("stablelm-1.6b, heads", 2, 32768, 32768, 2, 2, 64, True, 0, 0),
    ("hubert-xlarge, heads", 2, 32768, 32768, 1, 1, 80, False, 0, 0),
    ("minicpm-2b, fallback, last rank", 2, 2048, 32768, 36, 36, 64, True,
     30720, 0),
    ("minicpm-2b, fallback, first rank", 2, 2048, 32768, 36, 36, 64, True,
     0, 0),
    ("chameleon-34b, fallback, last rank", 2, 2048, 32768, 64, 8, 128, True,
     30720, 0),
    ("chameleon-34b, fallback, first rank", 2, 2048, 32768, 64, 8, 128,
     True, 0, 0),
    ("olmoe-1b-7b, heads", 2, 32768, 32768, 1, 1, 128, True, 0, 0),
    ("granite-moe-1b-a400m, fallback, last rank", 2, 2048, 32768, 16, 8, 64,
     True, 30720, 0),
    ("granite-moe-1b-a400m, fallback, first rank", 2, 2048, 32768, 16, 8,
     64, True, 0, 0),
    ("zamba2-2.7b, heads, window", 2, 32768, 32768, 2, 2, 80, True, 0,
     4096))


def flash_at_tp_prefill_shapes() -> list:
    """Phase 14 (d): #10 at TP_PREFILL_FLASH's shapes, held against its
    plain version at B=1 in float32 and bf16 (`compare_flash`, FLASH_TOL),
    then timed in bf16 at the rank's B beside the plain version, SDPA
    (`enable_gqa`, the same mask) and the `kernel_costs` bound. Returns one
    record a shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.roofline import kernel_costs as kc
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    out = []
    for name, b, sq, skv, h, hk, dh, causal, off, win in TP_PREFILL_FLASH:
        t_row = time.perf_counter()
        kw = dict(causal=causal, window=win, q_offset=off, block_q=256,
                  block_kv=1024)

        def qkv(batch, dtype):
            return [torch.randn((batch, n_s, n, dh), generator=gen,
                                device="cuda").to(dtype)
                    for n_s, n in ((sq, h), (skv, hk), (skv, hk))]
        shape = (f"{name} (B, Sq, Skv, H/Hk, Dh) = (1, {sq}, {skv}, "
                 f"{h}/{hk}, {dh}), q_offset {off}")
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(1, dt)
            tag = str(dt).replace("torch.", "")
            errs[tag] = compare_flash(q, k, v, kw, f"flash at {shape} {tag}")
            del q, k, v
        q, k, v = qkv(b, torch.bfloat16)
        ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), 5)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), 1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = dict(_sdpa_mask(sq, skv, causal, off, win),
                    enable_gqa=h != hk)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, **sdpa), 5)
        del sdpa
        b_ms, b_by = kc.flash_attention(b, sq, skv, h, hk, dh, causal=causal,
                                        q_offset=off, window=win).bound()
        log(f"  (d) #10 at the TP-local prefill_32k shape of {name} (B={b}, "
            f"Sq={sq}, Skv={skv}, H={h}, Hk={hk}, Dh={dh}, "
            f"{'causal' if causal else 'bidirectional'}, q_offset {off}"
            f"{f', window {win}' if win else ''}) "
            f"bf16: {ms:.4f} ms, plain {plain_ms:.3f} ms, SDPA "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); max |err| vs "
            f"plain (B=1) float32 {errs['float32']:.3g}, bf16 "
            f"{errs['bfloat16']:.3g}")
        out.append(dict(arch=name, shape=[b, sq, skv, h, hk, dh],
                        causal=causal, q_offset=off, window=win, ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                        bound_by=b_by, max_abs_err=errs["bfloat16"],
                        max_abs_err_f32=errs["float32"],
                        seconds=time.perf_counter() - t_row))
        del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    return out


# phase 14 (e): split-KV decode of starcoder2-7b (4 kv heads: they do not
# tile a model axis of 16) at a 16 x 16 rank's rows of decode_32k, its 16
# model ranks simulated on the one card; the float32 run cut to
# SPLIT_KV_F32_LAYERS layers (the whole model and cache in float32 would
# take ~75 GB)
SPLIT_KV_ARCH, SPLIT_KV_RANKS = "starcoder2-7b", 16
SPLIT_KV_BATCH, SPLIT_KV_SLOTS, SPLIT_KV_POS = 8, 32768, 20000
SPLIT_KV_F32_LAYERS = 8
# the float32 logits against the unsplit decode step: max |err| over the
# largest |logit| and each row's cosine; one layer's combined softmax
# against the unsplit one (float32 from bf16 caches): max |err| over its
# largest |value|. A combine that drops a slice's exp(m_r - max m) weight
# or mis-masks a slice misses these by orders of magnitude.
SPLIT_KV_F32_REL, SPLIT_KV_F32_COSINE = 1e-4, 0.99999
SPLIT_KV_COMBINE_REL = 1e-5


class SimulatedSplitKV:
    """While the block runs, `decode_attention`'s softmax over the cache
    (`models/attention.py` `_decode_core`) is computed as `ranks` slices,
    each slice's partials by `decode_partials` in turn, merged by
    `tensor_parallel.combine_partials`: the functions each rank of the
    sharded path and its combine call."""

    def __init__(self, ranks: int):
        self.ranks = ranks

    def __enter__(self):
        import repro_torch.models.attention as attention_mod
        from repro_torch.models import tensor_parallel as tpm
        self.module, self.orig = attention_mod, attention_mod._decode_core

        def split(qg, k_cache, v_cache, pos, window):
            n = k_cache.shape[1] // self.ranks
            valid = torch.arange(k_cache.shape[1], device=qg.device) <= pos
            parts = [attention_mod.decode_partials(
                qg, k_cache[:, r * n:(r + 1) * n],
                v_cache[:, r * n:(r + 1) * n], valid[r * n:(r + 1) * n])
                for r in range(self.ranks)]
            m, l, o = (torch.stack(t) for t in zip(*parts))
            return tpm.combine_partials(m, l, o).permute(0, 3, 1, 2, 4)
        attention_mod._decode_core = split
        return self

    def __exit__(self, *exc):
        self.module._decode_core = self.orig


def split_kv_decode() -> dict:
    """Phase 14 (e): starcoder2-7b at full width (random weights from seed
    0), SPLIT_KV_BATCH rows, a SPLIT_KV_SLOTS-slot cache whose first
    SPLIT_KV_POS slots are filled from the seed (the slices past `pos` are
    empty): one decode step with its attention split over SPLIT_KV_RANKS
    simulated ranks (`SimulatedSplitKV`) against the unsplit `decode_step`
    — bf16 at full depth (max |err| and cosine printed) and float32 at
    SPLIT_KV_F32_LAYERS layers (max |err| <= SPLIT_KV_F32_REL of the
    largest |logit|, the cosine of each row's logits >=
    SPLIT_KV_F32_COSINE) — then, on the bf16 caches of layer 0, the 16
    slices' combined softmax against the unsplit one in float32 (max |err|
    <= SPLIT_KV_COMBINE_REL of its largest |value|), and the ms of one
    layer's unsplit decode attention and of its softmax over the whole
    cache, of a rank's `decode_partials` over its slice and of the
    combine."""
    from repro_torch.configs import get_config
    from repro_torch.models import tensor_parallel as tpm
    from repro_torch.models.attention import (_decode_core,
                                              decode_attention,
                                              decode_partials)
    from repro_torch.models.model import (decode_step, init_decode_state,
                                          init_params)
    t0 = time.perf_counter()
    base = dataclasses.replace(get_config(SPLIT_KV_ARCH),
                               use_flash_kernel=True)
    b, pos, r = SPLIT_KV_BATCH, SPLIT_KV_POS, SPLIT_KV_RANKS
    rec = {"arch": SPLIT_KV_ARCH, "batch": b, "slots": SPLIT_KV_SLOTS,
           "pos": pos, "ranks": r}
    for dtype, layers in (("bfloat16", base.num_layers),
                          ("float32", SPLIT_KV_F32_LAYERS)):
        cfg = dataclasses.replace(base, dtype=dtype, num_layers=layers)
        params = init_params(cfg, SEED)
        state = init_decode_state(cfg, b, SPLIT_KV_SLOTS)
        for i in range(layers):
            for key in ("k", "v"):
                g = torch.Generator(device="cuda").manual_seed(
                    SEED + 100 + 2 * i + (key == "v"))
                state[key][i, :, :pos] = torch.randn(
                    (b, pos, cfg.num_kv_heads, cfg.head_dim), generator=g,
                    device="cuda").to(state[key].dtype)
        state["pos"] = pos
        tokens = torch.randint(0, cfg.vocab_size, (b, 1), device="cuda",
                               generator=torch.Generator(device="cuda"
                                                         ).manual_seed(SEED))
        with torch.inference_mode():
            want, _ = decode_step(params, cfg, state, tokens)
            with SimulatedSplitKV(r):
                got, _ = decode_step(params, cfg, state, tokens)
        torch.cuda.synchronize()
        cos = float(_cosines(got[:, 0], want[:, 0]).min())
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all()),
              f"split-KV decode ({dtype}): NaN in logits")
        log(f"  (e) split-KV decode of {SPLIT_KV_ARCH} over {r} simulated "
            f"ranks, {layers} layers in {dtype}, B={b}, {SPLIT_KV_SLOTS} "
            f"slots, pos {pos}: logits against the unsplit decode step, "
            f"cosine min {cos:.7f}, max |err| {err:.4g} (largest |logit| "
            f"{float(want.float().abs().max()):.4g})")
        rec[dtype] = {"layers": layers, "cosine_min": cos, "max_abs_err": err}
        if dtype == "float32":
            rel = err / float(want.float().abs().max())
            check(rel <= SPLIT_KV_F32_REL and cos >= SPLIT_KV_F32_COSINE,
                  f"split-KV decode: max |err| {rel:.3g} of the largest "
                  f"|logit| (limit {SPLIT_KV_F32_REL}), cosine {cos} (floor "
                  f"{SPLIT_KV_F32_COSINE}) against the unsplit decode step "
                  "(float32)")
        else:
            with torch.inference_mode():
                attn = params.blocks[0].attn
                x = torch.randn((b, 1, cfg.d_model), device="cuda").to(
                    torch.bfloat16)
                kc_, vc_ = state["k"][0], state["v"][0]
                qg = torch.randn((b, 1, cfg.num_kv_heads, cfg.num_heads
                                  // cfg.num_kv_heads, cfg.head_dim),
                                 device="cuda")
                valid = torch.arange(SPLIT_KV_SLOTS, device="cuda") <= pos
                n = SPLIT_KV_SLOTS // r
                rec["unsplit_layer_ms"] = cuda_ms(lambda: decode_attention(
                    attn, x, cfg, kc_, vc_, pos), 5)
                rec["unsplit_softmax_ms"] = cuda_ms(
                    lambda: _decode_core(qg, kc_, vc_, pos, 0), 5)
                rec["rank_partials_ms"] = cuda_ms(lambda: decode_partials(
                    qg, kc_[:, :n], vc_[:, :n], valid[:n]), 5)
                parts = [decode_partials(qg, kc_[:, i * n:(i + 1) * n],
                                         vc_[:, i * n:(i + 1) * n],
                                         valid[i * n:(i + 1) * n])
                         for i in range(r)]
                m, l, o = (torch.stack(t) for t in zip(*parts))
                whole = _decode_core(qg, kc_, vc_, pos, 0)
                split = tpm.combine_partials(m, l, o).permute(0, 3, 1, 2, 4)
                rel = float((split - whole).abs().max()) / float(
                    whole.abs().max())
                rec["combine_rel_err"] = rel
                log(f"  (e) layer 0's softmax over the {SPLIT_KV_SLOTS} "
                    f"slots as {r} slices' partials and their combine, "
                    f"float32: max |err| {rel:.3g} of its largest |value|")
                check(rel <= SPLIT_KV_COMBINE_REL, f"split-KV combine: max "
                      f"|err| {rel:.3g} of the largest |value| against the "
                      f"unsplit softmax (limit {SPLIT_KV_COMBINE_REL})")
                rec["combine_ms"] = cuda_ms(
                    lambda: tpm.combine_partials(m, l, o), 5)
            log(f"  (e) bf16 ms, one layer: unsplit decode attention "
                f"{rec['unsplit_layer_ms']:.4f} (its softmax over the "
                f"{SPLIT_KV_SLOTS} slots {rec['unsplit_softmax_ms']:.4f}); "
                f"a rank's partials over its {n} slots "
                f"{rec['rank_partials_ms']:.4f}; the combine of {r} "
                f"{rec['combine_ms']:.4f}")
            del x, qg, parts, m, l, o, whole, split
        del params, state, want, got
        gc.collect()
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def families() -> dict:
    """Phase 14; returns {"flash": #10 at the new shapes, "models": one
    record a model, "launches": #10 on the phase's path, "tp_prefill": (d),
    "split_kv": (e)}."""
    t_phase = time.perf_counter()
    flash = flash_at_family_shapes()
    models = [family_model(*run) for run in FAMILY_RUNS]
    launches = sum(m["flash_launches_a_forward"]
                   + m.get("flash_launches_generate", 0) for m in models)
    out = {"flash": flash, "models": models, "launches": launches,
           "tp_prefill": flash_at_tp_prefill_shapes(),
           "split_kv": split_kv_decode(),
           "seconds": time.perf_counter() - t_phase}
    log(f"  phase 14: {out['seconds']:.1f} s; flash launches on the "
        f"phase's path (a forward and a generate a model) {launches}")
    return out


# ------------------------------------ training the families (phase 15)
# arch, batch, sequence, grad_accum, layers (None: the published depth):
# one card's cut of each family's global batch. olmoe-1b-7b's float32
# masters, gradients and AdamW moments come to ~111 GB at 16 layers, so it
# trains 4 of them (1.85 B parameters, ~30 GB). xlstm-125m's sLSTM is
# 6 x S sequential steps of ~21 launches each way: S = 256 keeps its five
# steps near 10 s.
FAMILY_TRAIN = (("granite-moe-1b-a400m", 4, 2048, 2, None),
                ("zamba2-2.7b", 2, 4096, 2, None),
                ("hubert-xlarge", 4, 1024, 1, None),
                ("xlstm-125m", 4, 256, 1, None),
                ("olmoe-1b-7b", 4, 1024, 2, 4))
FAMILY_TRAIN_STEPS = 2         # through launch/train.py run
# #11 and #12 at the attention shapes of (b): arch, S, H, Hk, Dh, causal,
# window (zamba2's window is its training length: the causal mask)
TRAIN_FLASH = (("granite-moe-1b-a400m", 2048, 16, 8, 64, True, 0),
               ("zamba2-2.7b", 4096, 32, 32, 80, True, 4096),
               ("hubert-xlarge", 1024, 16, 16, 80, False, 0))
# the data-parallel step at world size 1 (tests/test_distributed.py:566's
# run: 12 steps on one fixed batch at peak lr 1e-3, compressed within
# 10 % of exact) and the --mesh debug step on a 1 x 1 mesh
DP_ARCH, DP_BATCH, DP_SEQ, DP_STEPS, DP_REL_TOL = (
    "granite-moe-1b-a400m", 4, 1024, 12, 0.1)
MESH_ARCH, MESH_BATCH, MESH_SEQ, MESH_STEPS = "stablelm-1.6b", 2, 2048, 2
# phase 15 (e): a MoE family's sharded step in both dispatch modes
MOE_MESH_ARCH, MOE_MESH_BATCH, MOE_MESH_SEQ, MOE_MESH_STEPS = (
    "granite-moe-1b-a400m", 2, 2048, 3)
# phase 15 (f): #11 and #12 at the shapes a rank of the 16 x 16 train_4k
# step gives them (`models/tensor_parallel.py`; 16 rows a rank): name, B,
# Sq, Skv, H, Hk, Dh, causal, q_offset, window. On the heads path a rank
# runs h/16 q and hk/16 kv heads over the whole sequence; on
# chameleon-34b's context-parallel fallback its 4,096/16 queries against
# the gathered K/V from its slice's start (the last rank's, 3,840, sees
# the most keys; the first's, 0, the fewest); zamba2's shared block at its
# 4,096-token window
TP_FLASH = (("stablelm-1.6b, heads", 16, 4096, 4096, 2, 2, 64, True, 0, 0),
            ("hubert-xlarge, heads", 16, 4096, 4096, 1, 1, 80, False, 0, 0),
            ("chameleon-34b, fallback, last rank", 16, 256, 4096, 64, 8, 128,
             True, 3840, 0),
            ("chameleon-34b, fallback, first rank", 16, 256, 4096, 64, 8,
             128, True, 0, 0),
            ("olmoe-1b-7b, heads", 16, 4096, 4096, 1, 1, 128, True, 0, 0),
            ("granite-moe-1b-a400m, fallback, last rank", 16, 256, 4096, 16,
             8, 64, True, 3840, 0),
            ("granite-moe-1b-a400m, fallback, first rank", 16, 256, 4096,
             16, 8, 64, True, 0, 0),
            ("zamba2-2.7b, heads, window", 16, 4096, 4096, 2, 2, 80, True, 0,
             4096))
# phase 15 (g): olmoe-1b-7b's MoE layer at its published width, the 16
# model ranks of a 16 x 16 train_4k rank simulated on the one card: the
# rank's 16 rows of 4,096 tokens, uncut (the float32 unsplit layer peaks
# near 30 GB); the float32 limit on max |err| over the largest |out|
MOE_TP_ARCH, MOE_TP_RANKS, MOE_TP_ROWS, MOE_TP_SEQ = (
    "olmoe-1b-7b", 16, 16, 4096)
MOE_TP_F32_REL = 1e-5
# phase 15 (h): zamba2-2.7b's Mamba2 layer at its published width (d 2,560,
# d_inner 5,120, 80 heads, N 64), the 16 model ranks of a 16 x 16
# train_4k rank simulated on the one card on its 16 rows of 4,096 tokens;
# the float32 limit on max |err| over the largest |out|
MAMBA_TP_ARCH, MAMBA_TP_RANKS, MAMBA_TP_ROWS, MAMBA_TP_SEQ = (
    "zamba2-2.7b", 16, 16, 4096)
MAMBA_TP_F32_REL = 1e-5


def flash_at_family_training_shapes() -> tuple[list, list]:
    """Phase 15 (a): #11 and #12 against their plain versions (B=1, bf16)
    at the families' training shapes, then timed at the training
    microbatch beside the plain versions, SDPA's forward and backward and
    the bounds. Returns (#11's records, #12's records), one a shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)
    from repro_torch.roofline import kernel_costs as kc
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    micro = {a: b // acc for a, b, _, acc, _ in FAMILY_TRAIN}
    fwd, bwd = [], []
    for arch, s, h, hk, dh, causal, window in TRAIN_FLASH:
        kw = dict(causal=causal, window=window, block_q=256, block_kv=1024)

        def qkv(b):
            return [torch.randn((b, s, n, dh), generator=gen, device="cuda"
                                ).to(torch.bfloat16) for n in (h, hk, hk)]
        q, k, v = qkv(1)
        shape = f"{arch}'s (1, {s}, {h}/{hk}, {dh})"
        err_f = compare_flash(q, k, v, kw, f"flash at {shape}")
        err_b = compare_flash_bwd(q, k, v, kw, f"flash bwd at {shape}", gen)
        b = micro[arch]
        q, k, v = qkv(b)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        ms11 = cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw), 5)
        plain11 = cuda_ms(lambda: flash_attention_fwd_plain(q, k, v, **kw),
                          2)
        ms12 = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                   **kw), 5)
        plain12 = cuda_ms(lambda: flash_attention_bwd_plain(
            q, k, v, o, lse, do, **kw), 2)
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        sdpa = dict(is_causal=causal, enable_gqa=h != hk)
        lib11 = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, **sdpa), 5)
        oh = F.scaled_dot_product_attention(qh, kh, vh, **sdpa)
        doh = do.transpose(1, 2).contiguous()
        lib12 = cuda_ms(lambda: torch.autograd.grad(
            oh, (qh, kh, vh), doh, retain_graph=True), 5)
        # the forward 2 products, the backward 5 (s recomputed, dp, dv,
        # dq, dk), of B*H*S^2*Dh (halved when causal); q, k, v (and o, dO,
        # dq, dk, dv) once, the lse
        c11 = kc.flash_attention_fwd(b, s, s, h, hk, dh, causal=causal,
                                     window=window)
        c12 = kc.flash_attention_bwd(b, s, s, h, hk, dh, causal=causal,
                                     window=window)
        flops11, flops12 = c11.flops, c12.flops
        b11, by11 = c11.bound()
        b12, by12 = c12.bound()
        log(f"  flash at {arch}'s training shape (B={b}, S={s}, H={h}, "
            f"Hk={hk}, Dh={dh}, {'causal' if causal else 'bidirectional'}"
            f"{f', window {window}' if window else ''}) bf16: #11 "
            f"{ms11:.3f} ms, plain {plain11:.3f} ms, SDPA {lib11:.3f} ms, "
            f"bound {b11:.4f} ms ({by11}), {flops11 / ms11 / 1e9:.1f} "
            f"TFLOP/s; #12 {ms12:.3f} ms, plain {plain12:.3f} ms, SDPA "
            f"backward {lib12:.3f} ms, bound {b12:.4f} ms ({by12}), "
            f"{flops12 / ms12 / 1e9:.1f} TFLOP/s; max |err| vs plain (B=1) "
            f"o {err_f:.3g}, dq/dk/dv {err_b:.3g}")
        common = dict(arch=arch, shape=[b, s, h, hk, dh], causal=causal,
                      window=window)
        fwd.append(dict(common, ms=ms11, plain_ms=plain11, library_ms=lib11,
                        bound_ms=b11, bound_by=by11, max_abs_err=err_f))
        bwd.append(dict(common, ms=ms12, plain_ms=plain12, library_ms=lib12,
                        bound_ms=b12, bound_by=by12, max_abs_err=err_b))
        del q, k, v, do, o, lse, qh, kh, vh, oh, doh
    torch.cuda.empty_cache()
    return fwd, bwd


def _sdpa_mask(sq: int, skv: int, causal: bool, q_offset: int,
               window: int = 0) -> dict:
    """SDPA's arguments for the kernels' mask at `q_offset`: top-left
    causal at 0, bottom-right (`causal_lower_right`) at Skv - Sq, else an
    explicit boolean mask (a window shorter than the keys always: a key
    sees the last `window` positions up to its query's)."""
    if not causal:
        return dict(is_causal=False)
    if window and window < skv:
        rows = torch.arange(sq, device="cuda")[:, None] + q_offset
        keys = torch.arange(skv, device="cuda")[None, :]
        return dict(attn_mask=(keys <= rows) & (keys > rows - window))
    if q_offset == 0:
        return dict(is_causal=True)
    if q_offset == skv - sq:
        from torch.nn.attention.bias import causal_lower_right
        return dict(attn_mask=causal_lower_right(sq, skv))
    rows = torch.arange(sq, device="cuda")[:, None] + q_offset
    return dict(attn_mask=torch.arange(skv, device="cuda")[None, :] <= rows)


def flash_at_tp_local_shapes() -> tuple[list, list]:
    """Phase 15 (f): #11 and #12 at TP_FLASH's shapes, held against their
    plain versions at B=1 in float32 (FLASH_TOL / BWD_TOL)
    and bf16 (phase 15's tolerances), then timed in bf16 at the rank's
    B beside the plain versions, SDPA's forward and backward (`enable_gqa`,
    the same mask) and the `kernel_costs` bounds. Returns (#11's records,
    #12's records), one a shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)
    from repro_torch.roofline import kernel_costs as kc
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    fwd, bwd = [], []
    for name, b, sq, skv, h, hk, dh, causal, off, win in TP_FLASH:
        t_row = time.perf_counter()
        kw = dict(causal=causal, window=win, q_offset=off, block_q=256,
                  block_kv=1024)

        def qkv(batch, dtype):
            return [torch.randn((batch, n_s, n, dh), generator=gen,
                                device="cuda").to(dtype)
                    for n_s, n in ((sq, h), (skv, hk), (skv, hk))]
        shape = (f"{name} (B, Sq, Skv, H/Hk, Dh) = (1, {sq}, {skv}, "
                 f"{h}/{hk}, {dh}), q_offset {off}")
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(1, dt)
            tag = str(dt).replace("torch.", "")
            errs[f"o_{tag}"] = compare_flash(q, k, v, kw,
                                             f"flash at {shape} {tag}")
            errs[f"grad_{tag}"] = compare_flash_bwd(
                q, k, v, kw, f"flash bwd at {shape} {tag}", gen)
        q, k, v = qkv(b, torch.bfloat16)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        ms11 = cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw), 5)
        plain11 = cuda_ms(lambda: flash_attention_fwd_plain(q, k, v, **kw),
                          2)
        ms12 = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                   **kw), 5)
        plain12 = cuda_ms(lambda: flash_attention_bwd_plain(
            q, k, v, o, lse, do, **kw), 2)
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        sdpa = dict(_sdpa_mask(sq, skv, causal, off, win),
                    enable_gqa=h != hk)
        lib11 = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, **sdpa), 5)
        oh = F.scaled_dot_product_attention(qh, kh, vh, **sdpa)
        doh = do.transpose(1, 2).contiguous()
        lib12 = cuda_ms(lambda: torch.autograd.grad(
            oh, (qh, kh, vh), doh, retain_graph=True), 5)
        costs = dict(causal=causal, q_offset=off, window=win)
        b11, by11 = kc.flash_attention_fwd(b, sq, skv, h, hk, dh,
                                           **costs).bound()
        b12, by12 = kc.flash_attention_bwd(b, sq, skv, h, hk, dh,
                                           **costs).bound()
        log(f"  (f) flash at the TP-local shape of {name} (B={b}, "
            f"Sq={sq}, Skv={skv}, H={h}, Hk={hk}, Dh={dh}, "
            f"{'causal' if causal else 'bidirectional'}, q_offset {off}"
            f"{f', window {win}' if win else ''}) bf16: #11 {ms11:.4f} "
            f"ms, plain {plain11:.3f} ms, SDPA "
            f"{lib11:.4f} ms, bound {b11:.4f} ms ({by11}); #12 {ms12:.4f} "
            f"ms, plain {plain12:.3f} ms, SDPA backward {lib12:.4f} ms, "
            f"bound {b12:.4f} ms ({by12}); max |err| vs plain (B=1) "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
        common = dict(arch=name, shape=[b, sq, skv, h, hk, dh],
                      causal=causal, q_offset=off, window=win,
                      seconds=time.perf_counter() - t_row)
        fwd.append(dict(common, ms=ms11, plain_ms=plain11, library_ms=lib11,
                        bound_ms=b11, bound_by=by11,
                        max_abs_err=errs["o_bfloat16"],
                        max_abs_err_f32=errs["o_float32"]))
        bwd.append(dict(common, ms=ms12, plain_ms=plain12, library_ms=lib12,
                        bound_ms=b12, bound_by=by12,
                        max_abs_err=errs["grad_bfloat16"],
                        max_abs_err_f32=errs["grad_float32"]))
        del q, k, v, do, o, lse, qh, kh, vh, oh, doh
    torch.cuda.empty_cache()
    return fwd, bwd


def moe_ranks_simulated() -> dict:
    """Phase 15 (g): olmoe-1b-7b's MoE layer (random weights from the
    seed) on MOE_TP_ROWS x MOE_TP_SEQ tokens, its MOE_TP_RANKS model ranks
    simulated with the per-rank functions the plan path runs after its
    collectives (`models/moe.py`). Global dispatch: one routing of every
    token (each rank routes the same gathered tokens), each rank's E/16
    experts by `_experts(..., first=...)`, the partial outputs summed
    against `_experts` over every expert. Manual SPMD: each rank's slab,
    its slice of the sequence, by `_slabs`, against `_slabs` over the
    whole sequence (every slab a chunk, the unsplit layer). float32 within
    MOE_TP_F32_REL of the largest |out|, bf16 printed; one rank's ms
    beside the unsplit layer's."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    t0 = time.perf_counter()
    cfg = get_config(MOE_TP_ARCH)
    r, b, s = MOE_TP_RANKS, MOE_TP_ROWS, MOE_TP_SEQ
    e, sl = cfg.num_experts // r, s // r
    rec = {"arch": MOE_TP_ARCH, "ranks": r, "rows": b, "seq": s}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        params = moe_mod.moe_init(torch.Generator(device="cuda").manual_seed(
            SEED + 40), cfg, dtype)
        x = torch.randn((b, s, cfg.d_model), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            SEED + 41)).to(dtype)
        ranks = [moe_mod.MoE(params.router, *(w[i * e:(i + 1) * e] for w in (
            params.w_gate, params.w_up, params.w_down))) for i in range(r)]
        xt = x.reshape(1, b * s, cfg.d_model)
        cap = moe_mod.capacity(cfg, b * s)
        with torch.inference_mode():
            routes = moe_mod._route(params, xt, cfg, cap)

            def unsplit():
                return moe_mod._experts(params, xt, routes, routes["pos"],
                                        routes["keep"], cap)

            def rank(i):
                return moe_mod._experts(ranks[i], xt, routes, routes["pos"],
                                        routes["keep"], cap, first=i * e)
            whole = unsplit()
            parts = rank(0)
            for i in range(1, r):
                parts += rank(i)
            top = float(whole.float().abs().max())
            err_g = float((parts.float() - whole.float()).abs().max()) / top
            dropped = int((~routes["keep"]).sum())
            del parts, whole
            whole, _ = moe_mod._slabs(params, x, cfg, b, sl)
            top_m = float(whole.float().abs().max())
            err_m = 0.0
            for i in range(r):
                got, _ = moe_mod._slabs(params, x[:, i * sl:(i + 1) * sl]
                                        .contiguous(), cfg, b, sl)
                err_m = max(err_m, float((got.float() - whole[
                    :, i * sl:(i + 1) * sl].float()).abs().max()) / top_m)
            del whole, got
            gc.collect()
            torch.cuda.empty_cache()
            ms = {"global_unsplit": cuda_ms(
                      lambda: (moe_mod._route(params, xt, cfg, cap),
                               unsplit()), 3),
                  "global_rank": cuda_ms(
                      lambda: (moe_mod._route(params, xt, cfg, cap),
                               rank(0)), 3),
                  "slabs_unsplit": cuda_ms(
                      lambda: moe_mod._slabs(params, x, cfg, b, sl), 3)}
            x0 = x[:, :sl].contiguous()
            ms["slabs_rank"] = cuda_ms(
                lambda: moe_mod._slabs(params, x0, cfg, b, sl), 3)
        log(f"  (g) {MOE_TP_ARCH}'s MoE layer ({cfg.num_experts} experts, "
            f"top {cfg.experts_per_token}, D {cfg.d_model}, F "
            f"{cfg.moe_d_ff}, capacity {cfg.capacity_factor}) on {b} x {s} "
            f"tokens over {r} simulated model ranks, {tag}: global dispatch "
            f"(cap {cap}, {dropped} routes dropped) the ranks' {e}-expert "
            f"partial outputs summed, max |err| {err_g:.3g} of the largest "
            f"|out| {top:.4g}; manual SPMD each rank's {b} x {sl} slab, max "
            f"|err| {err_m:.3g} of {top_m:.4g}; ms: global unsplit "
            f"{ms['global_unsplit']:.3f}, a rank {ms['global_rank']:.3f} "
            f"(routing every token included); slabs unsplit "
            f"{ms['slabs_unsplit']:.3f}, a rank {ms['slabs_rank']:.3f}")
        rec[tag] = {"global_rel_err": err_g, "slabs_rel_err": err_m,
                    "dropped": dropped, "ms": ms}
        if dtype == torch.float32:
            check(err_g <= MOE_TP_F32_REL and err_m <= MOE_TP_F32_REL,
                  f"phase 15 (g): the simulated model ranks' MoE output "
                  f"against the unsplit layer, max |err| {err_g:.3g} "
                  f"(global) / {err_m:.3g} (slabs) of the largest |out| "
                  f"(limit {MOE_TP_F32_REL}, float32)")
        del params, ranks, x, xt, routes, x0
        gc.collect()
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    log(f"  (g) {rec['seconds']:.1f} s")
    return rec


def _rank_mamba2s(params, cfg, size: int) -> list:
    """Each of `size` model ranks' Mamba2 block (zamba2's first) as the
    plan path holds it: a parameter whose mode (`Plan.mode`) is "local"
    its contiguous "model" shard at its sharding
    (`launch/shardings.py`), every other whole."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.shardings import param_shardings
    from repro_torch.models import ssm
    from repro_torch.models import tensor_parallel as tpm
    from repro_torch.models.layers import RMSNorm, linear
    from repro_torch.models.sharding_ctx import sharding_rules
    prefix = "mamba_groups.0.0.mamba."
    with dryrun.fake_world((1, size), ("data", "model")) as mesh:
        with sharding_rules(mesh):
            plan = tpm.make_plan(cfg, mesh)
        specs = param_shardings(mesh, cfg)

    def held(leaf, rank):
        t = params.get_parameter(leaf)
        if plan.mode(prefix + leaf) != "local":
            return t
        spec = specs[prefix + leaf].spec
        dim = next(d for d, v in enumerate(spec)
                   if v == "model" or (isinstance(v, tuple) and "model" in v))
        return t.chunk(size, dim)[rank]

    def block(i):
        got = ssm.Mamba2(
            linear(held("in_proj.weight", i)), held("conv_w", i),
            held("conv_b", i), held("a_log", i), held("d_skip", i),
            held("dt_bias", i), RMSNorm(held("norm.scale", i)),
            linear(held("out_proj.weight", i)))
        assert ({n for n, _ in got.named_parameters()}
                == {n for n, _ in params.named_parameters()})
        return got
    return [block(i) for i in range(size)]


def mamba_ranks_simulated() -> dict:
    """Phase 15 (h): zamba2-2.7b's Mamba2 layer (random weights from the
    seed) on MAMBA_TP_ROWS x MAMBA_TP_SEQ tokens, its MAMBA_TP_RANKS
    model ranks simulated with the functions the plan path runs between
    its collectives (`models/ssm.py`): each rank's block as the plan holds
    it (`_rank_mamba2s`: `Plan.mode` and the shardings on a fake 1 x 16
    mesh), its heads' gated SSD output (`mamba2_gated`: its z, x and dt
    columns of the fused `in_proj`, B and C whole), the ranks' sums of
    squares summed (`layers.sum_of_squares`, the norm's all-reduce), each
    rank's `out_proj` partial sums (`mamba2_project`, the norm's reduce
    returning that sum) summed (the reduce-scatter), against the unsplit
    `mamba2_forward`. float32 within MAMBA_TP_F32_REL of the largest
    |out|, bf16 printed; one rank's ms beside the unsplit layer's."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.layers import sum_of_squares
    t0 = time.perf_counter()
    cfg = get_config(MAMBA_TP_ARCH)
    r, b, s = MAMBA_TP_RANKS, MAMBA_TP_ROWS, MAMBA_TP_SEQ
    rec = {"arch": MAMBA_TP_ARCH, "ranks": r, "rows": b, "seq": s,
           "heads": cfg.n_ssm_heads, "d_inner": cfg.d_inner}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
        params = ssm.mamba2_init(gen, cfg, dtype)
        x = torch.randn((b, s, cfg.d_model), device="cuda",
                        generator=gen).to(dtype)
        ranks = _rank_mamba2s(params, cfg, r)
        with torch.inference_mode():
            whole = ssm.mamba2_forward(params, x, cfg)
            gated = [ssm.mamba2_gated(ranks[i], x, cfg, i, r)[0]
                     for i in range(r)]
            ss = sum_of_squares(gated[0])
            for g in gated[1:]:
                ss += sum_of_squares(g)

            def summed(_):
                return ss
            parts = ssm.mamba2_project(ranks[0], gated[0], cfg,
                                       summed).float()
            for i in range(1, r):
                parts += ssm.mamba2_project(ranks[i], gated[i], cfg, summed)
            top = float(whole.float().abs().max())
            err = float((parts - whole.float()).abs().max()) / top
            del whole, gated, parts
            gc.collect()
            torch.cuda.empty_cache()

            def rank0():
                g, _ = ssm.mamba2_gated(ranks[0], x, cfg, 0, r)
                return ssm.mamba2_project(ranks[0], g, cfg, lambda t: t)
            ms = {"unsplit": cuda_ms(lambda: ssm.mamba2_forward(
                      params, x, cfg), 3),
                  "rank": cuda_ms(rank0, 3)}
        log(f"  (h) {MAMBA_TP_ARCH}'s Mamba2 layer (D {cfg.d_model}, "
            f"d_inner {cfg.d_inner}, {cfg.n_ssm_heads} heads, N "
            f"{cfg.ssm_state_dim}) on {b} x {s} tokens over {r} simulated "
            f"model ranks, {tag}: the ranks' out_proj partials summed (the "
            f"norm's sums of squares summed), max |err| {err:.3g} of the "
            f"largest |out| {top:.4g}; ms: unsplit {ms['unsplit']:.3f}, a "
            f"rank {ms['rank']:.3f} (its {cfg.n_ssm_heads // r} heads, B "
            f"and C whole)")
        rec[tag] = {"rel_err": err, "ms": ms}
        if dtype == torch.float32:
            check(err <= MAMBA_TP_F32_REL,
                  f"phase 15 (h): the simulated model ranks' Mamba2 output "
                  f"against the unsplit layer, max |err| {err:.3g} of the "
                  f"largest |out| (limit {MAMBA_TP_F32_REL}, float32)")
        del params, ranks, x
        gc.collect()
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    log(f"  (h) {rec['seconds']:.1f} s")
    return rec


class DepthCut:
    """`module.get_config` with the depth cut to `layers` (None: as
    published) while the block runs."""

    def __init__(self, module, layers):
        self.module, self.layers = module, layers

    def __enter__(self):
        self.orig = self.module.get_config
        if self.layers:
            self.module.get_config = lambda name: dataclasses.replace(
                self.orig(name), num_layers=self.layers)
        return self

    def __exit__(self, *exc):
        self.module.get_config = self.orig


def slstm_times(params, cfg, batch: int, seq: int) -> dict:
    """The first pair's sLSTM alone at (batch, seq): its forward and its
    sequential backward (the gradients of the input and its parameters),
    CUDA-event ms."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import torch_dtype
    slstm = params.pairs[0].slstm
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device="cuda"
                    ).to(torch_dtype(cfg)).requires_grad_()
    fwd_ms = cuda_ms(lambda: ssm.slstm_forward(slstm, x, cfg), 2)
    y = ssm.slstm_forward(slstm, x, cfg)
    dy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
    inputs = (x, *slstm.parameters())
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(y, inputs, dy,
                                                 retain_graph=True), 2)
    log(f"  the sLSTM alone (one layer, B={batch}, S={seq}: {seq} "
        f"sequential steps): forward {fwd_ms:.1f} ms, backward {bwd_ms:.1f} "
        f"ms ({bwd_ms / seq:.3f} ms a step)")
    return {"slstm_forward_ms": fwd_ms, "slstm_backward_ms": bwd_ms}


def train_family(arch: str, batch: int, seq: int, accum: int, layers
                 ) -> dict:
    """Phase 15 (b), one family at full width: FAMILY_TRAIN_STEPS steps
    through `launch/train.py` `run`, then MEMO_STEPS at lr 1e-3 on one
    fixed batch from a fresh state."""
    import repro_torch.models.attention as attention_mod
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.launch import train
    from repro_torch.models.model import init_params, param_count
    from repro_torch.training import (OptimizerConfig, init_train_state,
                                      make_train_step)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), use_flash_kernel=True)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    argv = ["--arch", arch, "--steps", str(FAMILY_TRAIN_STEPS), "--batch",
            str(batch), "--seq", str(seq), "--grad-accum", str(accum),
            "--seed", str(SEED), "--log-every", "1"]
    args = train.parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    with DepthCut(train, layers), CountCalls(
            attention_mod, "blockwise_attention") as bw:
        out, secs, launched = counted(lambda: train.run(args))
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    hist = out["history"]
    apps = {"ssm": 0, "hybrid": cfg.num_layers // max(cfg.attn_every, 1)
            }.get(cfg.family, cfg.num_layers)
    per_step = counts(flash_attention_fwd=2 * apps * accum,
                      flash_attention_bwd=apps * accum)
    want = {k: v * FAMILY_TRAIN_STEPS for k, v in per_step.items()}
    losses = [h["loss"] for h in hist]
    ce = [h["ce"] for h in hist]
    ln_v = float(np.log(cfg.vocab_size))
    log(f"  {arch} ({cfg.family}; {cfg.num_layers} layers"
        f"{f' of {get_config(arch).num_layers}' if layers else ''}) through "
        f"launch/train.py run ({' '.join(argv)}): {secs:.1f} s with init; "
        f"losses {[round(x, 4) for x in losses]}, cross-entropy "
        f"{[round(x, 4) for x in ce]} (ln V = {ln_v:.4f}), aux "
        f"{[round(h['aux'], 5) for h in hist]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in hist]}, seconds a step "
        f"{[round(h['seconds'], 3) for h in hist]}; max memory allocated "
        f"{peak / 1e9:.2f} GB; launches #11 "
        f"{launched['flash_attention_fwd']}, #12 "
        f"{launched['flash_attention_bwd']} ({apps} attention applications"
        f" x {accum} microbatches a step, #11 twice with remat)")
    check(out["steps"] == FAMILY_TRAIN_STEPS, f"{arch}: run did "
          f"{out['steps']} steps")
    check(all(np.isfinite([h[k] for h in hist for k in ("loss", "grad_norm",
                                                          "aux")])),
          f"{arch}: a loss, aux loss or grad norm is not finite")
    # the cross-entropy: an MoE loss adds AUX_LOSS_WEIGHT x the aux loss
    check(ln_v - 0.5 <= ce[0] <= ln_v + 3, f"{arch}: first cross-entropy "
          f"{ce[0]:.4f} outside [ln V - 0.5, ln V + 3]")
    check(launched == want, f"{arch}: launched {launched}, expected {want}")
    check(bw.n == 0, f"{arch}: training ran blockwise_attention {bw.n} "
          "times")
    check(peak < 80e9, f"{arch}: max memory allocated {peak / 1e9:.2f} GB")

    params = init_params(cfg, SEED, param_dtype=torch.float32)
    n_params = param_count(params)
    state = init_train_state(cfg, params)
    step_fn = make_train_step(cfg, OptimizerConfig(
        peak_lr=MEMO_LR, schedule="constant", warmup_steps=0,
        total_steps=MEMO_STEPS), grad_accum=accum)
    fixed = make_lm_batch(cfg, batch, seq, SEED, 0)
    memo, aux, memo_s = [], [], []
    for _ in range(MEMO_STEPS):
        t_step = time.perf_counter()
        state, m = step_fn(state, fixed)
        memo.append(float(m["loss"]))
        aux.append(float(m["aux"]))
        memo_s.append(time.perf_counter() - t_step)
    tokens = batch * seq
    step_t = float(np.mean(memo_s[1:]))
    log(f"  {arch}: {n_params:,} parameters; {MEMO_STEPS} steps at lr "
        f"{MEMO_LR} on one fixed batch: losses {[round(x, 4) for x in memo]}"
        f", aux {[round(x, 5) for x in aux]}, seconds "
        f"{[round(x, 3) for x in memo_s]} ({tokens / step_t:.0f} tokens/s "
        f"after the first)")
    check(all(np.isfinite(memo)) and memo[-1] < memo[0],
          f"{arch}: the loss did not fall on a fixed batch: {memo}")
    rec = {"arch": arch, "family": cfg.family, "layers": cfg.num_layers,
           "params": n_params, "batch": batch, "seq": seq,
           "grad_accum": accum, "losses": losses, "ce": ce,
           "aux": [h["aux"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_s": [h["seconds"] for h in hist], "memo_losses": memo,
           "memo_aux": aux, "memo_step_s": memo_s,
           "tokens_per_s": tokens / step_t, "peak_memory_gb": peak / 1e9,
           "launches": {k: launched[k] for k in ("flash_attention_fwd",
                                                 "flash_attention_bwd")}}
    if cfg.family == "ssm":
        rec.update(slstm_times(state.params, cfg, batch, seq))
    del state, params, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def nccl_world_of_one() -> None:
    """A one-process NCCL group (a rendezvous on a free local port)."""
    import socket

    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)


def dp_at_world_size_one() -> dict:
    """Phase 15 (c): `make_dp_train_step_compressed` on a 1 x 1 mesh over
    NCCL, DP_STEPS on one fixed batch, compressed and exact."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import init_params, param_count
    from repro_torch.training import OptimizerConfig, init_train_state
    from repro_torch.training.dp_step import make_dp_train_step_compressed
    cfg = dataclasses.replace(get_config(DP_ARCH), use_flash_kernel=True)
    mesh = make_debug_mesh(1, 1)
    opt = OptimizerConfig(peak_lr=MEMO_LR, total_steps=20, warmup_steps=0)
    fixed = make_lm_batch(cfg, DP_BATCH, DP_SEQ, SEED, 0)
    out = {}
    for compress in (True, False):
        state = init_train_state(cfg, init_params(
            cfg, SEED, param_dtype=torch.float32))
        n = param_count(state.params)
        step = make_dp_train_step_compressed(cfg, opt, mesh,
                                             compress=compress)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        losses, secs = [], []
        for _ in range(DP_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, fixed, gen)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
        out["compressed" if compress else "exact"] = {
            "losses": losses, "step_s": secs,
            "grad_norm": float(m["grad_norm"])}
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    lc, le = out["compressed"]["losses"], out["exact"]["losses"]
    rel = abs(lc[-1] - le[-1]) / le[-1]
    out.update(params=n, rel=rel, int8_bytes=n, float32_bytes=4 * n)
    log(f"  DP step at world size 1 (NCCL) on {DP_ARCH} at full width, "
        f"{DP_STEPS} steps of {DP_BATCH} x {DP_SEQ} on one fixed batch: "
        f"compressed losses {[round(x, 4) for x in lc]}, exact "
        f"{[round(x, 4) for x in le]}; last relative difference {rel:.4f}; "
        f"seconds a step {np.mean(out['compressed']['step_s'][1:]):.3f} "
        f"compressed, {np.mean(out['exact']['step_s'][1:]):.3f} exact; int8 "
        f"codes {n:,} B a step against {4 * n:,} B of float32 gradients "
        f"(the codes are summed as int32, as the JAX package's psum: 4 B an "
        f"element on the wire)")
    check(all(np.isfinite(lc + le)), "DP step: a loss is not finite")
    check(lc[-1] < lc[0] and le[-1] < le[0],
          f"DP step: a loss did not fall: {lc}, {le}")
    check(rel < DP_REL_TOL, f"DP step: compressed {lc[-1]:.4f} vs exact "
          f"{le[-1]:.4f} (relative {rel:.4f})")
    return out


def timed_steps(step, state, batches) -> tuple:
    """(state, losses, seconds a step, peak bytes a step above what was
    allocated when it began): each step from a reset of the peak
    statistics, synchronised."""
    losses, secs, peaks = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() - base)
    return state, losses, secs, peaks


def equal_states(sharded, ref) -> tuple:
    """(parameters bit-equal, moments bit-equal, max |parameter diff|) of
    a sharded state on a 1 x 1 mesh against a single-device one."""
    full = dict(sharded.params.named_parameters())
    diff = max(float((full[n].to_local() - p.detach()).abs().max())
               for n, p in ref.params.named_parameters())
    same = all(torch.equal(full[n].to_local(), p)
               for n, p in ref.params.named_parameters())
    same_m = all(torch.equal(sharded.opt_state[k][n].to_local(),
                             ref.opt_state[k][n])
                 for k in ("m", "v") for n in ref.opt_state[k])
    return same, same_m, diff


def mesh_step_at_world_size_one(arch: str, batch: int, seq: int,
                                steps: int, modes=(None,)) -> dict:
    """Phase 15 (d) and (e): `--mesh debug`'s sharded step on
    `make_debug_mesh(1, 1)` for `arch` at full width against the
    single-device step: the parameters and both moments bit-equal after
    `steps`, for each MoE dispatch mode in `modes` (None: the config's),
    with each step's seconds and peak memory beside the single-device
    step's."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import init_params
    from repro_torch.training import (OptimizerConfig, init_train_state,
                                      make_train_step)
    from repro_torch.training.dp_step import make_sharded_train_step
    cfg = dataclasses.replace(get_config(arch), use_flash_kernel=True)
    opt = OptimizerConfig(peak_lr=MEMO_LR, total_steps=10, warmup_steps=0)
    mesh = make_debug_mesh(1, 1)
    batches = [make_lm_batch(cfg, batch, seq, SEED, t) for t in range(steps)]
    ref = init_train_state(cfg, init_params(cfg, SEED,
                                            param_dtype=torch.float32))
    ref, ref_losses, ref_secs, ref_peaks = timed_steps(
        make_train_step(cfg, opt), ref, batches)
    out = {"ref": {"losses": ref_losses, "step_s": ref_secs,
                   "peak_bytes": ref_peaks}}
    for mode in modes:
        mcfg = (cfg if mode is None
                else dataclasses.replace(cfg, moe_dispatch_chunks=mode))
        sharded, _ = train.sharded_state(mcfg, SEED, mesh, torch.device(
            "cuda", torch.cuda.current_device()))
        sharded, losses, secs, peaks = timed_steps(
            make_sharded_train_step(mcfg, opt, mesh), sharded, batches)
        same, same_m, diff = equal_states(sharded, ref)
        tag = "mesh" if mode is None else f"dispatch {mode}"
        log(f"  --mesh debug step on a 1 x 1 mesh (NCCL), {arch} at full "
            f"width ({tag}), {steps} steps of {batch} x {seq}: losses "
            f"{[round(x, 6) for x in losses]} vs single-device "
            f"{[round(x, 6) for x in ref_losses]}; parameters bit-equal "
            f"{same} (max |diff| {diff:.3g}), moments bit-equal {same_m}; "
            f"seconds a step {[round(x, 3) for x in secs]} vs "
            f"{[round(x, 3) for x in ref_secs]}; max_memory_allocated a step "
            f"above what was allocated when it began "
            f"{[round(x / 2**30, 3) for x in peaks]} vs "
            f"{[round(x / 2**30, 3) for x in ref_peaks]} GiB")
        check(same and same_m and losses == ref_losses
              and sharded.opt_state["step"] == ref.opt_state["step"],
              f"--mesh debug step at world size 1 ({arch}, {tag}) differs "
              f"from the single-device step (max |param diff| {diff:.3g})")
        out[tag] = {"losses": losses, "step_s": secs, "peak_bytes": peaks,
                    "bit_equal": same and same_m}
        del sharded
        gc.collect()
        torch.cuda.empty_cache()
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def training_families() -> dict:
    """Phase 15; returns {"flash_fwd", "flash_bwd": #11's and #12's
    records at the training shapes, "models": one record a family, "dp",
    "mesh", "launches": #11 and #12 on (b)'s path, "tp_local": (f),
    "moe_tp": (g), "mamba_tp": (h)}."""
    import torch.distributed as dist
    t_phase = time.perf_counter()
    fwd, bwd = flash_at_family_training_shapes()
    models = [train_family(*run) for run in FAMILY_TRAIN]
    nccl_world_of_one()
    try:
        dp = dp_at_world_size_one()
        mesh = mesh_step_at_world_size_one(MESH_ARCH, MESH_BATCH, MESH_SEQ,
                                           MESH_STEPS)
        moe_mesh = mesh_step_at_world_size_one(
            MOE_MESH_ARCH, MOE_MESH_BATCH, MOE_MESH_SEQ, MOE_MESH_STEPS,
            modes=(0, -1))
    finally:
        dist.destroy_process_group()
    tp_fwd, tp_bwd = flash_at_tp_local_shapes()
    moe_tp = moe_ranks_simulated()
    mamba_tp = mamba_ranks_simulated()
    launches = {k: sum(m["launches"][k] for m in models)
                for k in ("flash_attention_fwd", "flash_attention_bwd")}
    out = {"flash_fwd": fwd, "flash_bwd": bwd, "models": models, "dp": dp,
           "mesh": mesh, "moe_mesh": moe_mesh, "launches": launches,
           "tp_local": {"flash_fwd": tp_fwd, "flash_bwd": tp_bwd},
           "moe_tp": moe_tp, "mamba_tp": mamba_tp,
           "seconds": time.perf_counter() - t_phase}
    log(f"  phase 15: {out['seconds']:.1f} s; launches on (b)'s path: #11 "
        f"{launches['flash_attention_fwd']}, #12 "
        f"{launches['flash_attention_bwd']}")
    return out


# ------------------------------------------------- the examples (phase 17)
# streaming_updates' seven modes by the flags a user gives, at their full
# sizes but serve's; --sharded and --reshard on eight positions of the
# card. serve runs at --quick: its lanes are eager (SERVE_SPEC has no
# kernel), ~40 ms of host time a search on the card, and the scheduler
# coalesces nothing behind a dispatch that holds the host, so every batch
# is one query (25 q/s) and the full sizes' 6,000 arrivals took 238 s
# (NVIDIA H100 80GB HBM3, 700 W)
EXAMPLE_MODES = (("grow", []), ("churn", ["--churn"]),
                 ("sharded", ["--churn", "--sharded"]),
                 ("reshard", ["--reshard"]),
                 ("serve --quick", ["--serve", "--quick"]),
                 ("tenants", ["--tenants"]), ("tiered", ["--tiered"]))
EXAMPLE_TRACED = (("churn", ["--churn"]), ("serve", ["--serve", "--quick"]))
EXAMPLE_DIR = Path(__file__).resolve().parent / "build" / "phase17"
EXAMPLE_CHURN = dict(n0=6000, rounds=6, batch=500, dims=64, quick=False)
# recall@10 a tick of the JAX script's `--churn` (the same scenario; JAX on
# the CPU): the kernel churn stays within RECALL_SLACK of it and of the
# plain lanes' churn. The reference's first tick reads 0.845, under
# RECALL_FLOOR, so the floor itself does not apply to this scenario
JAX_CHURN_RECALL = (0.845, 0.864, 0.850, 0.863, 0.858, 0.865)
EXAMPLE_RAG_ARCH = "stablelm-1.6b"
# the forwards of rag_serve: the first ingest, two retrieves, the streamed
# ingest, and generate's prefill (a decode step launches no #10)
EXAMPLE_RAG_FORWARDS = 5
# the full-width run is float32: its hits are compared with the blockwise
# path's, and the two paths differ by summation order alone there
EXAMPLE_RAG_DTYPE = "float32"
EXAMPLE_TRAIN_STEPS = 2        # train_lm --full, then one step resumed


class Tee:
    """A stdout that prints and keeps what was printed."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s: str) -> int:
        self.parts.append(s)
        return self.out.write(s)

    def flush(self) -> None:
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def timed_example(name: str, fn, seconds: dict):
    """fn() with the card synchronised before and after; its seconds
    under `name`."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds[name] = time.perf_counter() - t0
    log(f"  {name}: {seconds[name]:.2f} s on {torch.cuda.get_device_name(0)}")
    return out


def example_streaming(seconds: dict) -> dict:
    """Every streaming_updates mode, then churn and serve with --trace,
    each trace read by scripts/obs_report.py."""
    from repro_torch.examples import streaming_updates as su
    out = {}
    for name, flags in EXAMPLE_MODES:
        log(f"  streaming_updates {' '.join(flags) or '(grow)'}")
        res = timed_example(name, lambda: su.main(flags), seconds)
        out[name] = {k: v for k, v in res.items() if k in ("rows", "r4",
                                                          "r2", "n_plans")}
    churn = out["churn"]["rows"]
    check(len(churn) == EXAMPLE_CHURN["rounds"] and all(
        r["size"] == EXAMPLE_CHURN["n0"] for r in churn),
        f"churn's sizes {[r['size'] for r in churn]}")
    check(sum(r["reused"] for r in out["sharded"]["rows"]) > 0,
          "sharded churn reused no slot")
    EXAMPLE_DIR.mkdir(parents=True, exist_ok=True)
    report = Path(__file__).resolve().parent / "scripts" / "obs_report.py"
    for mode, flags in EXAMPLE_TRACED:
        path = EXAMPLE_DIR / f"{mode}.json"
        path.unlink(missing_ok=True)
        res = timed_example(f"{' '.join(flags)} --trace", lambda: su.main(
            flags + ["--trace", str(path)]), seconds)
        check(bool(res["metrics"]), f"traced {mode} returned no metrics")
        done = subprocess.run([sys.executable, str(report), str(path)],
                              capture_output=True, text=True, timeout=300)
        log(f"    obs_report.py {path.name}: exit {done.returncode}; "
            + " | ".join(done.stdout.strip().splitlines()[-2:]))
        check(done.returncode == 0, f"obs_report.py on the {mode} trace "
              f"exited {done.returncode}: {done.stderr[-500:]}")
        out[f"{mode}_trace_events"] = len(json.loads(path.read_text())[
            "traceEvents"])
    return out


def example_kernel_churn(seconds: dict, plain: list) -> dict:
    """churn at its full sizes through the main path's spec: #1 and #2
    once a search and no other kernel; the plain lanes' churn (`plain`,
    its tick rows) tick for tick in the book-keeping's integers; recall@10
    within RECALL_SLACK of the plain lanes' and of the JAX script's."""
    from repro_torch.core.search_spec import Searcher
    from repro_torch.examples import streaming_updates as su
    spec = su.SERVE_SPEC.with_(use_kernels=True, fusion="megakernel",
                               rerank_source="device")
    with CountCalls(Searcher, "_dispatch") as searches:
        res, secs, launched = counted(lambda: su.run_churn(
            **EXAMPLE_CHURN, spec=spec))
    seconds["churn, kernels"] = secs
    n = searches.n
    recall = [r["recall"] for r in res["rows"]]
    log(f"  churn through {spec.fusion} + exact rerank: {secs:.2f} s, "
        f"{n} searches, launches {launched}, recall@10 "
        f"{[round(r, 4) for r in recall]}")
    check(n == 2 * EXAMPLE_CHURN["rounds"] + 2, f"{n} searches")
    check(launched == counts(fused_search=n, gather_l2=n),
          f"kernel churn launched {launched} over {n} searches")
    keys = ("size", "deleted", "inserted", "reused", "generation")
    check([[r[k] for k in keys] for r in res["rows"]]
          == [[r[k] for k in keys] for r in plain],
          "kernel churn's ticks differ from the plain lanes' churn")
    for got, lane, ref in zip(recall, plain, JAX_CHURN_RECALL):
        check(got >= lane["recall"] - RECALL_SLACK
              and got >= ref - RECALL_SLACK,
              f"kernel churn recall {recall}: plain lanes "
              f"{[r['recall'] for r in plain]}, JAX {JAX_CHURN_RECALL}")
    return {"rows": res["rows"], "searches": n, "launches": launched}


def example_rag(seconds: dict) -> dict:
    """rag_serve at its reduced size, then at the published width with
    #10 (its launches counted) and again blockwise on the same weights:
    the hits must be equal."""
    import repro_torch.models.attention as attention_mod
    from repro_torch.configs import get_config
    from repro_torch.examples import rag_serve
    from repro_torch.models.model import init_params
    small = timed_example("rag_serve", rag_serve.main, seconds)
    cfg = dataclasses.replace(get_config(EXAMPLE_RAG_ARCH),
                              dtype=EXAMPLE_RAG_DTYPE, use_flash_kernel=True)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED))
    with CountCalls(attention_mod, "blockwise_attention") as bw:
        flash, secs, launched = counted(lambda: rag_serve.serve(params, cfg))
    seconds["rag_serve, full width, #10"] = secs
    want = counts(flash_attention=EXAMPLE_RAG_FORWARDS * cfg.num_layers)
    log(f"  rag_serve at {cfg.name}'s width ({cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.dtype}) through #10: {secs:.2f} s, "
        f"launches {launched}, blockwise calls {bw.n}")
    check(launched == want and bw.n == 0, f"full-width rag_serve launched "
          f"{launched} (blockwise {bw.n}), expected {want}")
    block = timed_example("rag_serve, full width, blockwise",
                          lambda: rag_serve.serve(params, dataclasses.replace(
                              cfg, use_flash_kernel=False)), seconds)
    log(f"    hits #10 {flash['hits']}; blockwise {block['hits']}")
    check(flash["hits"] == block["hits"], "full-width rag_serve: #10's hits "
          "differ from the blockwise path's")
    check(flash["size"] == block["size"] == 768, "rag_serve index size")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"reduced": small, "full": {"hits": flash["hits"],
                                       "generated": flash["generated"],
                                       "cache": flash["cache"]},
            "launches": launched}


def example_train_lm(seconds: dict) -> dict:
    """train_lm --full (xlstm-125m at its width, 64 x 1,024) for
    EXAMPLE_TRAIN_STEPS steps into a fresh directory, then one more
    resumed from its checkpoint."""
    import contextlib
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.examples import train_lm
    ckpt = EXAMPLE_DIR / "train_lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    steps = EXAMPLE_TRAIN_STEPS
    tee = Tee(sys.stdout)
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(tee):
        first, s1, l1 = counted(lambda: train_lm.main(
            ["--full", "--steps", str(steps)], ckpt_dir=str(ckpt)))
        again, s2, l2 = counted(lambda: train_lm.main(
            ["--full", "--steps", str(steps + 1)], ckpt_dir=str(ckpt)))
    seconds["train_lm --full"] = s1
    seconds["train_lm --full, resumed"] = s2
    peak = torch.cuda.max_memory_allocated()
    hist = first["history"] + again["history"]
    ce = [h["ce"] for h in hist]
    ln_v = float(np.log(get_config("xlstm-125m").vocab_size))
    log(f"  train_lm --full: {steps} steps in {s1:.2f} s, one resumed in "
        f"{s2:.2f} s (with init and checkpoints); seconds a step "
        f"{[round(h['seconds'], 3) for h in hist]}; cross-entropy "
        f"{[round(c, 4) for c in ce]} (ln V = {ln_v:.4f}); max memory "
        f"allocated {peak / 1e9:.2f} GB")
    check(f"resumed from step {steps}" in tee.text(),
          "train_lm did not resume from its checkpoint")
    check(first["steps"] == steps and again["steps"] == steps + 1
          and len(hist) == steps + 1, "train_lm's step counts")
    check(all(np.isfinite([h[k] for h in hist for k in ("loss", "ce",
                                                         "grad_norm")])),
          "train_lm: a loss or grad norm is not finite")
    check(ln_v - 0.5 <= ce[0] <= ln_v + 3, f"train_lm: first cross-entropy "
          f"{ce[0]:.4f} outside [ln V - 0.5, ln V + 3]")
    check(l1 == l2 == counts(), f"train_lm launched {l1}, {l2}: xlstm has "
          "no attention")
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"ce": ce, "step_s": [h["seconds"] for h in hist],
            "peak_memory_gb": peak / 1e9}


def run_examples() -> dict:
    """Phase 17: each example in-process on the card, its own assertions
    kept; returns the seconds of each, the kernel churn's and full-width
    rag_serve's launches."""
    from repro_torch.examples import quickstart
    t_phase = time.perf_counter()
    seconds: dict = {}
    out = {"device": torch.cuda.get_device_name(0)}
    qs = timed_example("quickstart", quickstart.main, seconds)
    check(qs["roundtrip"] and qs["size"] == 9000, "quickstart")
    out["quickstart"] = {k: qs[k] for k in ("recall", "cache", "graph",
                                            "session_qps", "mean_hops")}
    out["streaming"] = example_streaming(seconds)
    out["kernel_churn"] = example_kernel_churn(
        seconds, out["streaming"]["churn"]["rows"])
    out["rag"] = example_rag(seconds)
    out["train_lm"] = example_train_lm(seconds)
    out["seconds"] = seconds
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"  phase 17: {out['phase_seconds']:.1f} s on {out['device']}: "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1

    t_all = time.perf_counter()
    smi = nvidia_smi()
    log(f"[1] device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[2] build: {time.perf_counter() - t0:.1f} s for "
        f"{', '.join(p.name for p in libs.values())}")
    for name in build.SOURCES:
        text = (build.BUILD_DIR / f"{name}.log").read_text(errors="replace")
        regs = [int(w.split()[0]) for w in text.split("Used ")[1:]]
        spills = sum(int(m) > 0 for m in
                     re.findall(r"(\d+) bytes spill stores", text))
        if regs:
            log(f"    ptxas {name}: {len(regs)} kernels, registers "
                f"{min(regs)}..{max(regs)}, {spills} with spill stores")
    search_step_ptxas_check()
    flash_sass_check(libs)
    hmma6 = rabitq_distance_sass_check(libs)
    hmma7 = pairwise_l2_sass_check(libs)

    gen = torch.Generator().manual_seed(SEED + 7)
    log("[3] selfcheck (small index, every variant, exact arithmetic)")
    selfcheck(gen)

    log(f"[4] main path: N={args.n}, {args.queries} queries")
    idx, q_dev, launches, (gt, gt_d), quant = main_path(args)

    log("[5] kernels vs plain at main-path shapes")
    records = kernels_at_main_shapes(idx, q_dev, launches, gen)

    log("[7] exact lanes and full scans (phase 4's index, before the churn "
        "round)")
    scan_records, exact_times = exact_and_scans(idx, q_dev, gt, gt_d, quant,
                                                gen)
    next(r for r in records if r["name"] == "fused_search").update(exact_times)
    next(r for r in scan_records if r["name"] == "rabitq_distance")[
        "sass_hmma"] = hmma6[idx.core.codes.bits]
    next(r for r in scan_records if r["name"] == "pairwise_l2")[
        "sass_hmma"] = hmma7
    records += scan_records

    log(f"[6] churn round: delete {args.n // 100}, search, consolidate, "
        f"insert {2 * (args.n // 100)}, search")
    churn = churn_round(idx, q_dev, args.n, quant["recall"])
    for rec in records:
        if rec["name"] == "fused_hop":
            rec["launches"] = churn["hop"]["fused_hop"]
        elif rec["name"] == "topk":
            rec["launches"] = churn["merge-kernel"]["topk"]

    log("[10] ANNS serving on phase 6's index: captured plans, mutations "
        "under them, submit/drain, the scheduler, service ticks")
    phase10 = anns_serving(idx, q_dev, quant.get("profile", {}), smi)

    log("[11] the host rows tier on phase 10's index: evict, host == device,"
        " the time split, staged churn, host-tier serving, restore")
    tier = host_rows_tier(idx, q_dev, phase10)
    # each kernel's launches a host-tier search of its lane
    lane_of = {"fused_search": "megakernel", "gather_l2": "megakernel",
               "fused_hop": "hop", "rabitq_search_step": "merge-kernel",
               "topk": "merge-kernel"}
    for rec in records:
        lane = lane_of.get(rec["name"])
        if lane is not None:
            rec["launches_host_tier"] = tier["launches"][lane][rec["name"]]

    # phase 8 needs the card's memory: free the ANNS index first (the grow
    # checker's closure holds it in a reference cycle)
    del idx, gt, gt_d
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[12] the PQ baseline over the first {PQ_ROWS} rows of phase 4's "
        "data")
    pq_baseline(args, q_dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[13] the row-sharded index: {SHARDS} shards of phase 4's data on "
        "the card — build, the captured 4-shard plan, the hop and "
        "merge-kernel lanes, skewed churn, rebalance, checkpoints and a "
        "4 -> 2 reshard, the host tier, serving")
    sharded = sharded_phase(args, q_dev, quant["recall"])
    # each search kernel's launches in one sharded search of its lane
    lanes = sharded["lanes"]
    launches_sharded = {
        "fused_search": sharded["search"]["launches"]["fused_search"],
        "gather_l2": sharded["search"]["launches"]["gather_l2"],
        "fused_hop": lanes["hop"]["launches"]["fused_hop"],
        "rabitq_search_step":
            lanes["merge-kernel"]["launches"]["rabitq_search_step"],
        "topk": lanes["merge-kernel"]["launches"]["topk"]}
    per_position = sharded["churn"]["checkpoints"]["positions"]["h"][
        "per_position"]
    for rec in records:
        if rec["name"] in launches_sharded:
            rec["launches_sharded"] = launches_sharded[rec["name"]]
        if rec["name"] in ("fused_search", "gather_l2"):
            rec["launches_per_position"] = [p.get(rec["name"], 0)
                                            for p in per_position]
    print(json.dumps({"sharded": sharded}, default=str))
    del q_dev
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[8] RAG serving: {RAG_ARCH} at full width over the port's index "
        f"(device memory in use {torch.cuda.memory_allocated() / 1e9:.2f} "
        "GB)")
    records += rag_serving()

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[9] training: {TRAIN_ARCH} at full width, float32 masters, bf16 "
        f"compute (device memory in use "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    # #11 runs on the training path only: its record's numbers are those
    # at the training microbatch, not phase 8's serving shape
    train_records, train_launches = training()
    fwd = next(r for r in records if r["name"] == "flash_attention_fwd")
    fwd.update(train_records["flash_attention_fwd"],
               launches=fwd["launches"]
               + train_launches["flash_attention_fwd"])
    records.append(dict(train_records["flash_attention_bwd"],
                        launches=train_launches["flash_attention_bwd"]))

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[14] the other LM families at full width: "
        f"{', '.join(r[0] for r in FAMILY_RUNS)} (device memory in use "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    fam = families()
    print(json.dumps({"families": fam}))
    flash = next(r for r in records if r["name"] == "flash_attention")
    flash.update(launches=flash["launches"] + fam["launches"],
                 launches_families={m["arch"]: m["flash_launches_a_forward"]
                                    for m in fam["models"]},
                 at_family_shapes=fam["flash"],
                 at_tp_prefill_shapes=fam["tp_prefill"])

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[15] training the families at full width: "
        f"{', '.join(r[0] for r in FAMILY_TRAIN)}; the DP step and the "
        f"--mesh debug step at world size 1 (device memory in use "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    tf = training_families()
    print(json.dumps({"training_families": tf}))
    for name, key in (("flash_attention_fwd", "flash_fwd"),
                      ("flash_attention_bwd", "flash_bwd")):
        rec = next(r for r in records if r["name"] == name)
        rec.update(launches=rec["launches"] + tf["launches"][name],
                   launches_families={m["arch"]: m["launches"][name]
                                      for m in tf["models"]},
                   at_family_shapes=tf[key],
                   at_tp_local_shapes=tf["tp_local"][key])

    gc.collect()
    torch.cuda.empty_cache()
    log("[17] the examples on the card: quickstart, the seven "
        "streaming_updates modes and two traces, churn through the kernels, "
        f"rag_serve reduced and at {EXAMPLE_RAG_ARCH}'s width, train_lm "
        "--full with a resume")
    ex = run_examples()
    print(json.dumps({"examples": ex}, default=float))
    ex_launches = {"fused_search": ex["kernel_churn"]["launches"],
                   "gather_l2": ex["kernel_churn"]["launches"],
                   "flash_attention": ex["rag"]["launches"]}
    for rec in records:
        got = ex_launches.get(rec["name"])
        if got is not None:
            rec["launches_examples"] = got[rec["name"]]
            rec["launches"] += got[rec["name"]]

    check(set(ROOFLINE) == {"search", "train_step", "decode_step"},
          f"phase 16 measured {sorted(ROOFLINE)}")
    t16 = sum(r["analyzer_s"] for r in ROOFLINE.values())
    log(f"[16] roofline shares on {smi}, fixed-formula (op-level): " +
        ", ".join(f"{k} {r['fixed']['share']:.4f} ({r['share']:.4f})"
                  for k, r in ROOFLINE.items())
        + f"; {t16:.1f} s under the analyzer")
    print(json.dumps({"roofline": ROOFLINE, "device": smi}, default=float))
    log(f"    total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
