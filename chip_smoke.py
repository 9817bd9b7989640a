#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths, its
Poincaré ops, its Poincaré-embedding trainer (in HBM and through a
host-resident table), HGCN node classification, the hyperbolic VAE and
HGCN through its CLI from graphs on disk on one GPU and check them.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises and exits non-zero; nothing is caught; each
prints its seconds):

1. require CUDA; print the card's name and power limit;
2. build every kernel of the paths from ``hyperspace_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
3. hold each serving kernel against its plain PyTorch version on the
   card, at the shapes the serving path gives it and at the full table;
4. the serving path: a Poincaré table of WordNet-noun size (82,115 × 10,
   c = 1, made from ``--seed``) and its hyperboloid lift are exported as
   artifacts, loaded back, and served through the ``serve`` JSONL loop
   (``topk`` at buckets 8 and 1024, ``score`` with ``prob``, ``stats``)
   with both scan modes; the answers are checked against each other and
   against a float64 brute force on the CPU, and every serving kernel's
   launch count must have risen during this phase;
5. the training data: the HGCN link-prediction bench's synthetic
   hierarchy at ogbn-arxiv scale (169,343 nodes), community-reordered,
   split, with its cluster split and the clustered edges' row plan (host
   preparation, timed on its own; the row plan's build again alone);
6. hold each scatter kernel against its plain version on the card at the
   training path's shapes (the real straggler, clustered and decoder
   edge sets), plus an input with empty rows and padding edges, the
   straggler and decoder sets from an unaligned data_ptr, 3,000 edges
   over all 169,343 rows and no edge at all; ``csr_segment_sum`` and
   ``cluster_aggregate`` launched twice must give the same bits, the
   latter with the step's row plan and, built on the card, without;
7. the training path: ``run_hgcn_bench`` (bf16 edge messages and decoder
   pass, hidden (128, 32), Lorentz) for one warm-up and 10 timed steps;
   every loss finite, the last timed loss below the first, and the
   launch counts must rise by steps × 7 (``csr_segment_sum``) and
   steps × 4 (``cluster_aggregate``), with no row plan built in the
   steps; then the device busy time, idle share and top device items of
   a step, the peak device memory, and the test ROC-AUC after the steps;
8. the whole step on the card against the port on the CPU (the plain
   versions), 2 steps each on a 20,000-node split with its cluster
   split, from the same parameters and negatives: losses within rel 2e-2;
9. the attention arm's data: phase 5's split with its cluster split
   rebuilt at the attention threshold (128 edges a pair), its row plan's
   build timed alone; the gate must be open; then
   ``csr_segment_reduce_1d`` (sum and max),
   ``csr_att_bwd_edges``, ``cluster_att_fwd`` and ``cluster_att_bwd``
   against their plain versions on the path's straggler and clustered
   edge sets at F = 128 and 32, bf16 and f32, plus inputs with empty rows
   and padding edges and with F = 8 and 130, ``csr_att_bwd_edges`` also
   on unaligned views of its rows and (d_num | d_den); and
   ``csr_segment_sum`` at the arm's widths (F + 1 = 129 and 33, bf16) on
   both edge sets; each kernel launched twice must give the same bits,
   ``cluster_att_fwd`` and ``cluster_att_bwd`` with the step's row plan
   (the subset's built on the card) and, on the path's set, the same
   bits without it;
10. the attention training path: ``run_hgcn_bench`` with ``use_att`` (lr
   3e-3, clip 1.0) for one warm-up and 10 timed steps; losses finite and
   falling, and the launch counts exactly steps × 2 for each attention
   kernel, × 7 for ``csr_segment_sum`` and 0 for ``cluster_aggregate``,
   with no row plan built in the steps;
   the device busy time, idle share, top device items, peak memory and
   test ROC-AUC;
11. two attention steps on the card against the CPU on phase 8's split,
   its cluster split at 128 with the gate held open on both: losses
   within rel 2e-2;
12. hold the HyboNet kernels (flash attention forward, dq, dk/dv and
   ``hyp_mlr``) against their plain versions at the three HyboNet
   entry points' shapes (the bench leg, the long-context leg, the CLI
   config), with padded sequences (query rows with no valid key) and an
   extra case whose lengths are not a tile multiple: forward output and
   lse; dq, dk, dv and dτ of the whole Function against autograd of the
   dense twin (dτ against its float64 twin), for an output cotangent
   drawn from a generator seeded from ``--seed``, each held norm-wise
   (largest error over the case's largest entry) as the JAX package
   holds its own kernel; MLR logits at those shapes and at HGCN node
   classification's head ([169,343, 40, 32], and 1,003 rows), launched
   twice for the same bits;
13. the HyboNet bench legs (``workloads_bench``: ``hybonet`` and
   ``hybonet_long``): step ms, tokens/s, device busy ms and idle share,
   peak memory, the largest device items, and each kernel's launch count
   (exactly layers, layers, layers and 1 a step);
14. the CLI, ``cli.train hybonet --yaml configs/hybonet_textclf.yaml``
   at 250 of its 500 steps (``HB_CLI_STEPS``): loss and accuracy; the
   last loss finite and below
   the first;
15. two HyboNet steps on the card against the port on the CPU from the
   same parameters and batches: losses within rel 1e-4 (all f32);
16. the approximate serving lanes (run right after phase 4): an
   82,115 × 10 Poincaré table of 512 clusters (bench.py's IVF
   generator, from ``--seed``), its IVF index built on the card with the
   export defaults (``ncells`` auto = 287, 8 iterations, seed 0, balance
   2) and its PQ payload (m = 3), exported and loaded back; the build
   seconds;
17. hold ``scan_topk_cand`` and ``scan_topk_pq`` against their plain
   versions on the card: the candidate lists of nprobe 1 and 8 at
   k = 10 and 256, a 37-wide list with pads in mid-list, a query with no
   candidate and k above the reachable, queries off the table without
   ``exclude_self``, hyperboloid rows, and two ids at one distance with
   the lower id at the later position, in different splits of 8
   queries (the earlier position must come first); the ADC scan at the
   path's m = 3,
   k = 170, at m = 8, k = 256, and with ``col0`` and ``n`` cut; both
   slab scans at the path's shapes on an insertion storm (every row
   nearer than all before it) and on identical rows or codes, whose ids
   must equal the plain version's and be the lowest k columns; each
   launched twice must give the same bits;
18. the lanes through the ``serve`` loop: f32 exact, nprobe 1, 2, 4, 8,
   PQ, and PQ with nprobe 8, each under ``two_stage`` and ``fused``,
   the counts set to 0 before each run and read after: exactly one
   ``scan_topk_cand`` a batch under IVF fused, one ``scan_topk_pq`` a
   batch under PQ fused, none under two-stage; the two modes
   rank-identical; every PQ distance the f32 distance of its id;
   recall@10 of each lane against the f32 exact answers;
19. queries/s and batch latency at bucket 1024, k = 10, for each lane
   but PQ with IVF, both modes, with the card's busy time and idle share;
20. hold the Poincaré ball's seven row-wise ops and ``hyp_linear``
   against their plain versions on the card: the ops at the path shapes
   ([82,115, 10], [169,343, 128], [256, 48], [82,115, 8]) with c 1, 0.5
   and 2.3, at
   d = 7, 130 and 200, leading dims [3, 8, 48], bf16 inputs (within one
   bf16 ulp of the f32 plain version), r ∈ {−1.5, 0, 0.5, 3}, points at
   the proj margin, zero rows, a bias [d] broadcast against [n, d];
   ``hyp_linear`` at [169,343, 128] × [128, 128] and × [128, 32],
   [256, 48] × [48, 32], odd widths, 1000 → 700 (many tiles), Mx = 0
   rows, zero bias, bf16, leading dims; rtol 2e-4, atol 2e-5 (2e-4 for
   ``hyp_linear``); each launched twice must give the same bits, and the
   gradients through each Function must equal autograd of the plain
   version (to a device tensor c and r too);
21. the op path: a Riemannian update through the public ops
   (``logmap``, ``expmap``, ``ptransp``, ``expmap0``,
   ``mobius_scalar_mul``, ``mobius_add``, ``logmap0``) at each path
   shape, the counts set to 0 before and read after (exactly one launch
   of each op a shape); points stay in the ball, and the chain matches
   the plain versions on the CPU on 2,000 rows;
22. the layer path at arxiv width: HypLinear(128) → HypAct(ball c = 1 →
   ball c = 0.5, relu) → HypLinear(32) on 169,343 ball points, loss the
   mean squared distance to targets; card against the port on the CPU
   on 20,000 rows from the same parameters (loss and gradients within
   rel 1e-4, all f32); one warm-up and 10 AdamW steps: losses finite
   and falling, exactly 2 ``hyp_linear`` launches a forward; step ms,
   device busy time, idle share and peak memory;
23. print the kernels line (device times of each kernel and its plain
   version at the main paths' shapes, bounds, launches, the library
   call's time, ``csr_segment_sum`` also at the attention arm's widths:
   for flash dq and dk/dv together, the one backward call
   of ``scaled_dot_product_attention``; their blocks an SM and parts;
   for the two slab scans the scan kernel and the split merge apart),
   the top-k throughput at bucket 1024 (batches of cold ids
   through the batcher, the engine call alone, and the card's busy
   share), the launch floor (``floor_ms``: an empty kernel's device time,
   ``benchmarks/launch_floor.py``), the ``nvidia-smi`` line, and finally
   ``{"ok": true, "device": {...}}``; the times are taken before phases
   24-29, which run last, and the kernels line gains their shapes
   (``*_pe_*`` keys: device ms, plain ms, bound ms, ``index_add_``'s ms
   for the segment sum, launches on the path and a step);
24. Poincaré embeddings (``models/poincare_embed.py``) on the card against
   the CPU: 5 explicit-batch steps of every path (dense, mined, sparse,
   planned, packed) with RSGD and RAdam on a depth-3 tree from one start
   read by ``state_from_jax``: tables within rel 1e-4;
25. the path's kernels at its shapes against their plain versions,
   launched twice for the same bits: ``pdist`` at [1024, 66,430, 10]
   (queries are table rows, as in ``evaluate``: the self column is held
   within 1e-2, apart), ``scan_topk`` on a 64-row mining pool with
   duplicated rows (their lower slot first), ``expmap`` at [66,430, 10]
   and [12,288, 10], ``ptransp`` at [597,871, 10] and [12,288, 10],
   ``csr_segment_sum`` at [12,288, 10] on a planned step's slots; then
   their device times;
26. training on the depth-5, branching-9 tree (66,430 nodes, 323,847
   pairs, 316 steps an epoch), dim 10, batch 1,024, 10 negatives, every
   strategy of ``benchmarks/poincare_bench.py`` with RAdam and with RSGD:
   an epoch (two where graphed, the first capturing), every loss finite,
   the counts exact over the last epoch (1 ``expmap`` a step, 1
   ``ptransp`` a RAdam step, 1 ``scan_topk`` a mined step, 1
   ``csr_segment_sum`` a planned step, no ``pdist``); RAdam's loss falls
   (last 50 steps' mean below the first 50's), RSGD's over 12 graphed
   dense epochs; graphed epochs bitwise equal to the same steps run
   eagerly from the same state and generator;
27. ``evaluate`` before and after RAdam's two graphed epochs: 317
   ``pdist`` launches, MAP rising, the kernel's MAP and mean rank within
   1e-3 of the plain version's on the card;
28. the bench leg (``run_poincare_bench``, 1 timed repeat): epoch seconds
   of every strategy, the headline, step ms at the depth-6 table
   (597,871 rows, RAdam), peak memory, and the device busy time and idle
   share of 20 steps of each strategy;
29. ``cli.train poincare --yaml configs/poincare_wordnet.yaml steps=300``:
   MAP, mean rank and seconds;
30. node classification's data (run after phase 22): phase 5's reordered
   graph whole, with its cluster split, 40 classes and
   ``node_split_masks`` (60 / 20 / 20 %), prepared by
   ``hgcn_bench.arxiv_scale_nc_graph``;
31. the NC path (``models/hgcn.py``: Lorentz, hidden (128, 32), bf16 edge
   messages): one warm-up and 10 timed steps, every loss finite and the
   last below the first; launches exact: 4 ``csr_segment_sum``, 4
   ``cluster_aggregate`` and 1 ``hyp_mlr`` a step, 2, 2 and 1 an
   evaluation, no row plan built (the last loss held below the first
   step's: at lr 1e-2 the first update takes most of the fall); step ms,
   nodes/s, peak memory, val/test accuracy and macro-F1, the device busy
   time, idle share and top items of a step; ``csr_segment_sum`` on the
   graph's own straggler receivers and ``cluster_aggregate`` on its own
   clustered pairs with their row plan, bf16 at F 128 and 32, each held
   against its plain version as in phase 6 and launched twice for the
   same bits; ``hyp_mlr`` on the head's
   own input (the ball image of the encoder's output), launched twice for
   the same bits: at the first step against its plain version at phase
   12's tier, after the steps (every row within f32's resolution of the
   ball's rim) no further from float64 than the plain version;
32. two NC steps on the card against two on the CPU on a 20,000-node
   graph from the same parameters: losses within rel 2e-2 (bf16 lanes);
33. the hyperbolic VAE at ``configs/hvae_mnist.yaml``'s width (hidden
   256, conv (32, 64), latent 8, batch 128, c = 1) on 4,096 synthetic
   MNIST images from ``--seed``, both latent geometries: 3 steps on the
   card and on the CPU from the same parameters, ids and ε: loss, recon,
   kl and every parameter within rel 1e-4 (f32, cuDNN's TF32 off);
34. 50 sampled steps on the card, each geometry: every loss finite, the
   last 10 steps' mean below the first 10's; the IWAE bound (k = 16, 256
   images) finite and at least the ELBO of the same 16 draws;
35. the ``hvae`` bench leg (``workloads_bench``: batch 256, latent 2),
   stepwise: step ms, images/s, device busy time, idle share, top items,
   peak memory;
36. last, after every profiled time: the bench leg's graphed chunks of 32
   steps (per-step ms, images/s), as the path runs them and again under
   cuDNN's determinism; on both geometries, a graphed chunk of 8 sampled
   steps against the same steps run eagerly from the same state and
   generator: bitwise equal under cuDNN's determinism, and within rel
   1e-5 (parameters norm-wise, metrics) without it, as the path runs;
37. ``cli.train hvae --yaml configs/hvae_mnist.yaml scan_chunk=100`` (its
   800 steps in 8 graphed chunks): loss, recon, kl, IWAE and seconds.

38. the disk layouts: ``community_power_law_graph`` at its defaults
   (ogbn-arxiv's statistics: 169,343 nodes, 1,166,243 edges, 128
   features, 40 classes, all used) written by ``write_ogb_csv_layout``
   and a Cora-sized graph (2,708 papers, 5,429 citations, 1,433 binary
   words, 7 classes) by ``write_cora_layout``, both loaded back (edges
   and labels exact, features within ``%.6g``); write and load seconds;
39. host prep on the arxiv layout: the native BFS order and edge layout
   bitwise their Python and numpy versions, each path's seconds; a
   prep-cache miss and then a hit in a cache root of the phase's own:
   identical layouts, the hit faster (every other prep in the smoke
   runs with the cache off);
40. ``cli.train hgcn --yaml configs/hgcn_arxiv_lp.yaml data_root=<arxiv
   layout> steps=12 graph_cache=false`` in this process: ``prep`` is
   ``"native"``, every logged loss finite, the last below the first;
   launches exactly 12 × (4 ``csr_segment_sum``, 4 ``cluster_aggregate``)
   plus an evaluation's 4 and 4, no row plan built; then the CLI's step
   on the identical split: step ms, samples/s, device busy time, idle
   share, top items, peak memory, and the CLI's test ROC-AUC;
41. ``train_step_lp_planned`` on that split: ``graph_edge_sqdist``'s
   [E, 33] bf16 scatter held against its plain version (and from an
   unaligned view), launched twice for the same bits; one warm-up and
   10 steps, losses finite and falling, launches exactly 6 and 4 a step;
   step ms and the device's share;
42. ``learn_c=true`` on the card against the CPU, two steps each of LP
   (pairs and plain) and NC on a 20,000-node graph of the same kind, from
   the same parameters and negatives: losses and the last layer's
   learned curvature within rel 2e-2, that curvature moved; ``hyp_mlr``
   with the learned (device) curvature against its plain version at
   phase 12's tier, ``dc`` included, launched twice for the same bits;
43. ``task=nc`` on the arxiv layout (40 classes) and ``use_att=true`` LP
   on the Cora layout through the CLI, 5 steps each: losses finite,
   launches exact (NC: 4, 4, 1 a step and 2, 2, 1 an evaluation;
   attention without a cluster split: 4 ``csr_segment_sum``, 2
   ``csr_att_bwd_edges``, 2 ``csr_segment_reduce_1d`` a step, 4
   ``csr_segment_sum`` an evaluation, no cluster kernel).

Phases 55-56 (after 16-19) serve the bf16, int8 and int4 lanes:

55. each narrow lane of the three kernels against its plain version on
   the card: bf16 ``pdist`` at phase 3's shapes within one bf16 ulp;
   ``scan_topk`` on the bf16 copy, the int8 codes with their f32 scales
   and the int4 nibbles with their f16 scales (``serve/quant.py``) at
   phase 3's grid (buckets 8 and 1024, k 1, 10 and 256,
   ``exclude_self``, ``col0`` and ``n`` cut), both manifolds;
   ``scan_topk_cand`` on the bf16 and int8 copies of phase 16's table at
   phase 17's lists (nprobe 1 and 8, k 10 and 256); each launched twice
   for the same bits;
56. every lane (f32, bf16, int8, int4) × scan mode × nprobe 0 and 8
   through the ``serve`` loop, on phase 4's random table (its index built
   here) and phase 16's clustered one, the counts set to 0 before each
   run and read after: exactly one scan of the lane's own a batch under
   ``fused`` (the candidate scan under IVF; int4 probes score in
   PyTorch), one bf16 ``pdist`` a chunk under bf16 ``two_stage``; every
   served distance the f32 distance of its id; recall@10 against the f32
   exact answers; queries/s, batch ms and the card's busy ms at bucket
   1024 of each narrow lane on the clustered table.  The kernels
   line gains an entry a lane (``pdist_bf16``, ``scan_topk_bf16``,
   ``scan_topk_int8``, ``scan_topk_int4``, ``scan_topk_cand_bf16``,
   ``scan_topk_cand_int8``: device ms at buckets 1024 and 8, the bound in
   the lane's bytes, launches from phase 56).

Phase 58 (after 44-49) serves the other specs: euclidean and sphere
tables of 82,115 × 10 from ``--seed`` (indexes built on the card) and a
product artifact that ``cli.serve export workload=product index=1
quant=pq`` writes from a ``cli.train product`` checkpoint on phase 46's
66,430-node closure, through the ``serve`` loop on every lane (exact;
f32 and one more lane probed): each served distance the manifold's own
f32 distance of its id, the f32 exact answers against float64 on 16
queries, recall@10, and a scan kernel launched where the spec takes it
(euclidean under ``fused``) and none where it does not.

Phases 59-62 (after 44-49 and 58) run the graphed training steps, the
telemetry spine and the divergence guard:

59. the CLI's HyboNet step at ``configs/hybonet_textclf.yaml``'s width
   (dim 128, 4 layers, 4 heads, batch 64) on the CLI's data: a graphed
   chunk of 8 (``train/loop.py``'s live capture: the module's own tensors
   are the graph's buffers) from one state against 8 eager steps from
   another, at ``accum=1`` and 2, then a chunk of replays alone against
   8 more: parameters, moments, counts, generators and losses bitwise;
   that chunk's launches, the counts set to 0 before it, exactly 8 ×
   (4, 4, 4, 1) of the flash forward, dq, dk/dv and ``hyp_mlr``; eager
   and graphed ms a step (host clock, ending in a sync) and the card's
   busy ms a step; then the kernels one replayed chunk ran on the card,
   counted by name in a ``torch.profiler`` trace, the same 8 × (4, 4, 4,
   1);
60. the CLI's LP step on phase 40's arxiv split (hidden (128, 32), bf16
   lanes) the same way in chunks of 4, beside a second eager run: bitwise,
   or within the two eager runs' gap where those differ; the replay
   chunk's launches 4 × 4 of ``csr_segment_sum`` and of
   ``cluster_aggregate``, at the wrappers and in the trace; ms and busy
   ms as in 59; then ``cli.train
   hgcn`` on a Cora-size layout, ``task=nc`` and ``use_att=true``,
   ``scan_chunk=4`` against ``scan_chunk=1`` twice, the final
   checkpoints held the same way;
61. graphed HyboNet through ``cli.train.main`` with ``telemetry=1
   trace_out= metrics_out= profile_steps=16`` and without: the manifest
   first and the summary last, ``span/*`` and ``ctr/*`` in the records,
   the 2 profiled chunks in ``train/phase/device_step_ms``, the Chrome
   trace and the Prometheus file loaded; ms a step with the spine on and
   off (from the records' clocks: each record reads the loss);
62. graphed HyboNet with ``chaos=train.step_nan:nan:after=2
   rollback=1``: one rollback, to step 16, a finite loss and the
   unfaulted run's final state, bitwise; ``rollback=1`` with no fault
   bitwise the unguarded run; ``chaos=ckpt.save:ioerror:times=2``
   retried twice (``ckpt/save_retries``) and the run complete.

The kernels line gives the replay chunks' launches of 59 and 60 for the
HyboNet kernels and B1 and B2 in a field of their own,
``launches_graphed``; ``launches`` stays the eager main path's count.

Phases 50-54 (after 44-49) serve through the HTTP front door
(``serve/server.py``) on an ephemeral port, in a process of their own
(``--front-door``: a server runs apart from training), every door
started by ``run_front_door`` (the entry ``serve-http`` runs) and
prewarmed on the collator's dispatch thread before its listener opens.
A door's launch counts are set to 0 once its listener is up and read
after its own traffic; the prewarm's launches are reported apart:

50. phase 4's table under ``fused`` and ``two_stage``: every route
   answers (``/v1/upsert``, ``/v1/delete``, ``/admin/rollover`` 400); the
   ``/v1/topk`` and ``/v1/score`` answers equal the ``serve`` loop's
   bit for bit; 64 concurrent single ids collate into fewer flushes and
   answer what each id answers alone; ``kernel_builds``,
   ``kernel_loads`` and ``cold_dispatches`` flat after prewarm (the
   prewarms load the libraries in this fresh process, and a control
   door without prewarm counts a cold dispatch at its first request);
   ``scan_topk`` (fused) and ``pdist`` (two_stage) launched by traffic;
51. open-loop latency, fused, cache off, spans on: for 1, 16 and 64 ids
   a request, the capacity (answered/s of a closed loop over 96
   sockets for 1.5 s), then Poisson arrivals at 0.5 and 0.9 of it for
   3 s (a client process of its own, ``--load-client``, at most 96
   sockets open): e2e p50/p95/p99 from socket accept, the client's
   latency from each scheduled arrival and the arrivals that waited for
   a socket, the stage histograms (``queue_wait``, ``collate_wait``,
   ``dispatch``, ``device_compute``, ``serialize``), the batching factor
   ``cache_miss / collator_flushes``, ``memory_reserved`` before and
   after; every request 200;
52. overload on phase 16's IVF artifact (nprobe 8, ``queue_max=8``):
   single ids offered at 10x phase 51's highest rate for 1 s, every
   request answered once, the excess 429, no 500, no cold dispatch at
   any ladder width; the ladder steps down and, under calm sequential
   traffic, recovers; each answer at a narrowed width equals the
   engine's at that width for the same padded bucket;
53. an armed 300 ms ``serve.dispatch`` latency against a 30 ms deadline
   answers 504 and caches the rows (the same ids then 200, 0 new
   slots); a drain during an in-flight dispatch answers it, refuses new
   connections, reads 503 at ``/healthz`` meanwhile;
54. ``cli.train poincare`` with ``ckpt_dir`` on a 5,461-node tree,
   ``cli.serve export ... index=1 quant=pq c=1.0``, the exported
   fingerprint equal to ``fingerprint_of`` of the restored table, and
   ``serve-http`` over the export answering ``/v1/topk`` at nprobe 4
   and with ``precision=pq``;
57. ``cli.serve export ... quant=int4`` of phase 54's checkpoint (the
   payload JAX's packing of the restored table), then ``serve-http
   precision=int4`` (the shipped codes) and ``precision=int8`` over it
   with ``prewarm=1``: answers 200 and equal to the same lane's engine,
   the lane's scan launched by the traffic, builds, loads and cold
   dispatches flat after the prewarm; then the total seconds and a
   ``front_door`` line with the numbers of 50-54.

Phases 63-66 (the same process, after 57) drive the rest of the
single-process serving plane:

63. ``serve-http live=1 delta_cap=1024 compact_at=0.75`` (two-stage base,
   ``prewarm=1``) over phase 4's table and over phase 16's IVF artifact
   (nprobe 8): a near-duplicate upserted at a new id ranks top-1 at once;
   a re-upsert answers ``inserted`` 0; the deleted id answers 400 as a
   query and is never returned; ``generation`` counts the mutations;
   then 1,000 single-row upserts (updates and inserts) with a query of 8
   ids every 10, past the background compaction (the streamed index
   build on the IVF base: the master is a ``HostEmbedTable``); a
   synchronous compaction folds what came after its snapshot; 64 answers
   then equal a fresh frozen engine's over ``master.to_array()`` bit for
   bit (the deleted id dropped) and, exact, a float64 brute force over the
   live rows; ``pdist`` launched by the traffic, builds and loads flat;
   ``serve/upsert_visible_ms``, each compaction's seconds, and batch ms
   and busy ms of 1,024 queries with an empty and a full delta beside
   the frozen base;
64. ``serve-http`` (fused) over phase 4's table, ``POST /admin/rollover``
   to phase 54's artifact: the door flips and prewarms, answers as a solo
   door on that artifact, ``memory_allocated`` falls by the old engine's
   device bytes less the new one's, first-use counters flat;
65. three tenants behind one door (``EngineRegistry`` with
   ``run_front_door(registry=)``): phase 4's table (fused), its
   hyperboloid lift (two_stage), phase 16's IVF artifact (fused, nprobe
   8): by name, by fingerprint and by default bitwise the solo engines,
   404 for an unknown tenant, ``?tenant=`` stats, per-tenant p50/p99 with
   one tenant offered 10x the other's rate (two client processes); then
   under a budget of one engine, alternating tenants: admissions,
   evictions, ``memory_allocated`` falling by each evicted engine's bytes
   (less the admitted one's), a cold tenant's first-answer ms, answers
   bitwise the unbudgeted ones, first-use counters flat; then
   ``serve-http tenants=<file>`` (one fused scan mode) answers each;
66. the host-streamed IVF build of 1,200,000 × 10 clustered rows (above
   ``HOST_BUILD_ROWS``), then the resident build from the same seeds:
   the same cells (or near ties only), the device rows peak 4,096, each
   build's seconds, recall@10 at nprobe 8 against the exact fused scan.

The kernels line gives rows 1, 2 and 4 ``launches_live`` (63's traffic,
compactions included) and ``launches_tenants`` (65's three-tenant door).

Phases 67-70 (after 59-62, before the front-door process) train
Poincaré embeddings through a host-resident table
(``train/host_embed.py``, ``parallel/host_table.py``):

67. at the JAX bench's big-table train leg (200,000 rows, dim 8, batch
   1,024, 10 negatives, chunks of 8, plan seed 1, 100,000 random pairs),
   RSGD and RAdam: a warm chunk, then 24 timed steps of
   ``HostPlannedTrainer`` (host clock, ``profile`` on: the four phases'
   ms a chunk) and of ``run_planned_inhbm`` from the same start; the two
   bitwise (master, moments, losses); again over a cache of a quarter of
   the auto size (chunks of 2, whose worst case that is), evictions
   counted, bitwise; the card within rel 1e-4 of the CPU after one chunk;
   one graph captured for the chunk length; then one more replay chunk
   in a ``torch.profiler`` trace, whose kernels, counted by their device
   names (``traced_launches``), must be 8 ``expmap`` and 8
   ``csr_segment_sum`` (and 8 ``ptransp`` with RAdam);
   ``host_step_ms``, ``inhbm_step_ms``, ``host_vs_inhbm``, the hit rate
   and the upload bytes a chunk;
68. the 10,000,000 × 8 RSGD master built shard by shard from the seed
   (``HostEmbedTable.build``), through ``HostPlannedTrainer`` alone (a
   warm chunk, 24 timed steps): ``host_step_ms_full``, the hit rate, the
   upload bytes a chunk, and the device memory the run takes (its peak
   over what was allocated at its start) held under a quarter of the
   table's 320 MB;
69. that master saved at 8 shards (``save_sharded``) and restored at 3,
   bitwise, ``io_rows_peak`` within max(⌈N/8⌉, ⌈N/3⌉); the row files of 4
   processes (``save_owned_rows``) and a 1,000,000-row range across two
   of them (``load_rows``), bitwise; the seconds of each;
70. ``cli.train poincare --yaml configs/poincare_wordnet.yaml host_table=1
   scan_chunk=1 steps=64 ckpt_dir=...`` on the closure TSV of the
   66,430-node tree: MAP in (0, 1], the saved master bitwise a trainer
   driven with the CLI's arguments, 317 ``pdist`` launches (the closing
   evaluation, eager); ``host_gather_ahead=1`` (exact here: the cache
   holds the table); ``chaos=data.next_batch:ioerror:after=2:times=1`` in
   a subprocess (on the CLI's default tree) ends non-zero naming the
   injected error; a ``data.next_batch`` spec on a dense run (the default
   tree) never reaches its site and changes nothing.

The kernels line gives ``pdist``, ``csr_segment_sum``, ``expmap`` and
``ptransp`` this path's launches, ``launches_host``: for the row ops and
B1 the traced replay chunks of 67 (one an optimizer), for ``pdist`` 70's
closing evaluation.

The kernels line (phase 23) also gives ``hyp_mlr`` at the NC head's own
input (``*_nc_head`` keys: device ms, plain ms, bound, no library call)
and, for the three kernels of the NC path, their launches there, a step
and an evaluation (``launches_nc``, ``launches_per_step_nc``,
``launches_per_eval_nc``), and for the two scatter kernels their largest
error on the NC graph's edge sets (``max_abs_err_nc``); and, from
phases 38-43, the launches of each CLI path (``launches_hgcn_cli``,
``launches_planned``, ``launches_hgcn_cli_nc``,
``launches_hgcn_cli_att_cora``, each with its per-step and
per-evaluation count), ``csr_segment_sum`` at the arxiv layout's
stragglers and ``cluster_aggregate`` at its clustered pairs (F 128:
``*_hgcn_cli``: shape, ms, bound, the library call's ms, largest error),
``csr_segment_sum`` at ``graph_edge_sqdist``'s [E, 33] bf16 scatter
(``*_graph_edges_hgcn_cli``) and ``hyp_mlr`` at the NC head's shape with
the curvature as a device tensor and as a number (``ms_nc_device_c``,
``ms_nc_number_c``); and, for the four serving kernels, their launches
through the front door over phases 50-54 (``launches_front_door``).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROWS, DIM, C = 82115, 10, 1.0      # BASELINE.json configs[0]: WordNet nouns
BATCH, K = 1024, 10
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM float32 outside tensor cores
TF32_FLOPS_PER_S = 495e12          # H100 SXM dense TF32 on the tensor cores
TF32_PASSES = 3                    # a 3×TF32 product: lo·hi + hi·lo + hi·hi
# kernel vs plain version, both float32: the Gram form
# cancels near d = 0 and the two sum in different orders
RTOL, ATOL = 1e-5, 1e-4
# served float32 answers vs the float64 brute force: the float32 Gram
# form's forward error grows as 1/(1 - c‖x‖²)² toward the boundary
TRUTH_RTOL, TRUTH_ATOL = 1e-3, 1e-3
REPO = os.path.dirname(os.path.abspath(__file__))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def timed_ms(torch, fn, reps: int = 20) -> float:
    """Mean time per call of ``fn`` on the card's clock (CUDA events
    around ``reps`` back-to-back calls, after one warm-up call): device
    work plus any gap the host's launch path leaves between calls."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_items(torch, fn, reps: int) -> dict:
    """Device time per call of ``fn`` by item (kernel, copy, fill) under
    ``torch.profiler`` (``benchmarks/devtime.py``): only the events that
    ran on the card, a dropped launch not read as a faster call, and a
    window whose timestamps disagree with CUDA events (a calibration
    spin timed both ways) profiled again.  ``{}`` when no window
    recorded a device event."""
    return profile_items(torch, fn, reps)[0]


def profile_items(torch, fn, reps: int) -> tuple[dict, list]:
    """(:func:`device_items`, the names of the host operators ``fn``
    ran in the same window).  Each window refused because the profiler's
    timestamps disagree with the card's clock is reported on a line of
    its own."""
    from hyperspace_torch.benchmarks.devtime import profile_window

    items, ops, windows = profile_window(torch, fn, reps)
    for win in windows:
        if items and not win["accepted"]:
            emit({"phase": "profiler_window_refused",
                  "item": max(items, key=items.get)[:80], **win})
    return items, ops


def device_ms(torch, fn, reps: int = 20) -> float:
    """Summed device time of everything ``fn`` runs on the card, per
    call: a kernel's own time, free of the host's launch overhead.  Where
    the profiler recorded nothing, the time comes from CUDA events
    instead (:func:`timed_ms`, which adds the launch path's gaps)."""
    items = device_items(torch, fn, reps)
    if items:
        return sum(items.values())
    emit({"phase": "profiler_fallback", "reps": reps})
    return timed_ms(torch, fn, reps)


def device_share(torch, fn, wall_ms: float, reps: int = 5,
                 top_n: int = 3) -> dict:
    """Device busy time per call of ``fn``, its share of ``wall_ms`` (the
    call's unprofiled wall time) and the ``top_n`` largest device items."""
    items = device_items(torch, fn, reps)
    if not items:                  # the profiler recorded nothing
        return {"device_busy_ms": None, "device_idle_share": None,
                "top_device_ms": "not measured"}
    busy = sum(items.values())
    top = sorted(items.items(), key=lambda r: -r[1])[:top_n]
    named = {}                     # names cut to 60 characters may collide
    for k, ms in top:
        named[k[:60]] = named.get(k[:60], 0.0) + ms
    # the port's own kernels sit in a top-level anonymous namespace
    # (PyTorch's in at::native::(anonymous namespace), but for the
    # backward of an indexed gather, which sits there too)
    hand = sum(ms for k, ms in items.items()
               if k.removeprefix("void ").startswith("(anonymous namespace)")
               and "::indexing_backward_kernel" not in k)
    return {"device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "hand_kernels_ms": hand, "device_items": len(items),
            "top_device_ms": named}


def scan_parts(torch, fn, reps: int = 20) -> dict:
    """Device ms of one slab top-k call (``ms``: every item it runs on
    the card) and of its scan kernel and its split merge apart."""
    items = device_items(torch, fn, reps)
    if not items:
        emit({"phase": "profiler_fallback", "reps": reps})
        return {"ms": timed_ms(torch, fn, reps), "scan_ms": None,
                "merge_ms": None}
    return {"ms": sum(items.values()),
            "scan_ms": sum(v for k, v in items.items() if "scan_" in k),
            "merge_ms": sum(v for k, v in items.items() if "merge" in k)}


def bound_ms(nbytes: float, flops: float,
             tf32_flops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take: the bytes over the memory
    rate or the operations over their peak rates (``flops`` in f32
    outside the tensor cores, ``tf32_flops`` on them), the larger."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = (flops / F32_FLOPS_PER_S + tf32_flops / TF32_FLOPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# float32 operations per distance beyond the 2·D of the Gram product:
# the clamps and products of the closed form, sqrt, log1p and the final
# division
_CLOSED_FORM_FLOPS = 15


def pdist_cost(n: int, m: int, d: int) -> tuple[float, float]:
    """(bytes, operations) of an [n, m] distance matrix: inputs read and
    the output written once; each row's squared norm taken once."""
    return (4.0 * (n * d + m * d + n * m),
            float(n) * m * (2 * d + _CLOSED_FORM_FLOPS) + 2.0 * (n + m) * d)


def scan_cost(b: int, m: int, n: int, d: int, k: int) -> tuple[float, float]:
    """(bytes, operations) of a top-k scan of ``b`` queries over an
    ``m``-row slab of which ``n`` rows are real: the table, queries and
    query ids read once, the [b, k] answer written once; the distances
    to the real rows only."""
    return (4.0 * (m * d + b * d + b) + 8.0 * b * k,
            float(b) * min(n, m) * (2 * d + _CLOSED_FORM_FLOPS)
            + 2.0 * (b + m) * d)


# --- the training path: HGCN link prediction at ogbn-arxiv scale ------------

TRAIN_STEPS = 10
LAUNCHES_PER_STEP = {"csr_segment_sum": 7, "cluster_aggregate": 4}
CARD_CPU_NODES = 20_000
CARD_CPU_RTOL = 2e-2        # bf16 lanes: docs/precision.md's loss budget
F32_EPS = 2.0 ** -24


def bf16_ulp(torch, x):
    """One bf16 ulp of each (float32) entry of ``x``; 0 where x is 0."""
    _, e = torch.frexp(x)
    ulp = torch.ldexp(torch.ones_like(x), (e - 8).to(torch.int32))
    return torch.where(x == 0, torch.zeros_like(x), ulp)


def check_scatter(torch, kernel, label, got, want, order_bound,
                  again=None) -> float:
    """Hold a scatter kernel's output against its plain version's, both
    in the output type: f32 at rtol = atol = 1e-5; bf16 within one bf16
    ulp of the plain result plus ``order_bound`` (both sum the same f32
    terms, in other orders: 2·k·2^-24·Σ|term| per row).  ``again``, a
    second launch on the same input, must give the same bits."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{kernel} {label}: {got.dtype} {got.shape} "
                             f"vs {want.dtype} {want.shape}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if got.dtype == torch.bfloat16:
        tol = bf16_ulp(torch, w) + order_bound
    else:
        tol = 1e-5 + 1e-5 * w.abs()
    over = int((diff > tol).sum())
    worst = float(diff.max()) if diff.numel() else 0.0
    bitwise = again is None or bool(torch.equal(got, again))
    emit({"phase": "check", "kernel": kernel, "case": label,
          "shape": list(got.shape), "dtype": str(got.dtype),
          "max_abs_err": worst, "over_tolerance": over,
          **({} if again is None else {"repeat_bitwise_equal": bitwise})})
    if over or not bitwise:
        raise AssertionError(f"{kernel} {label}: {over} entries beyond "
                             f"tolerance, repeat bitwise equal: {bitwise}")
    return worst


def check_segsum(torch, gen, label, recv, n, f, dtype, n_real=None) -> float:
    """``csr_segment_sum`` on random values over ``recv`` (zero past
    ``n_real``; a negative ``n_real`` the same from a view one element
    into its storage, an unaligned data_ptr) against its plain version,
    launched twice."""
    from hyperspace_torch.kernels.segment import (csr_segment_sum,
                                                  csr_segment_sum_plain)

    e, off = recv.shape[0], int(n_real is not None and n_real < 0)
    flat = torch.randn(e * f + off, generator=gen, device=recv.device)
    vals = flat.to(dtype)[off:].view(e, f)
    if n_real is not None:
        vals[abs(n_real):] = 0         # padding edges carry zero values
    got = csr_segment_sum(vals, recv, None, n)
    again = csr_segment_sum(vals, recv, None, n)
    torch.cuda.synchronize()
    want = csr_segment_sum_plain(vals, recv, n)
    k = torch.bincount(recv.long(), minlength=n).float()[:, None]
    bound = 2.0 * k * F32_EPS * csr_segment_sum_plain(vals.float().abs(),
                                                      recv, n)
    return check_scatter(torch, "csr_segment_sum", label, got, want, bound,
                         again)


def check_cluster(torch, gen, label, agg, n, f, dtype) -> float:
    """``cluster_aggregate`` on random h over the clustered pairs of
    ``agg`` (a device graph's cluster split) as the step calls it, with
    its row plan, launched twice and once with the plan built on the
    card, against its plain version."""
    from hyperspace_torch.kernels.cluster import (cluster_aggregate,
                                                  cluster_aggregate_plain)

    h = torch.randn(n, f, generator=gen, device=agg.c_recv.device).to(dtype)
    got = cluster_aggregate(h, agg.c_wf, agg.c_recv, agg.c_send, None, n,
                            rows=agg.c_rows)
    again = cluster_aggregate(h, agg.c_wf, agg.c_recv, agg.c_send, None, n,
                              rows=agg.c_rows)
    built = cluster_aggregate(h, agg.c_wf, agg.c_recv, agg.c_send, None, n)
    torch.cuda.synchronize()
    if not torch.equal(got, built):
        raise AssertionError(f"cluster_aggregate F={f}: the plan built on "
                             "the card gives other bits")
    want = cluster_aggregate_plain(h, agg.c_wf, agg.c_recv, agg.c_send, n)
    w_used = agg.c_wf.to(dtype).float()     # bf16 h: rounded weights
    k = torch.bincount(agg.c_recv.long(), minlength=n).float()[:, None]
    bound = 2.0 * k * F32_EPS * cluster_aggregate_plain(
        h.float().abs(), w_used.abs(), agg.c_recv, agg.c_send, n)
    return check_scatter(torch, "cluster_aggregate", f"{label} F={f}",
                         got, want, bound, again)


def segment_cost(e: int, f: int, n: int, size: int) -> tuple[float, float]:
    """(bytes, operations) of a sorted segment sum: values and receivers
    read once, the [n, f] output written once; one add per value."""
    return (float(e) * f * size + 4.0 * e + float(n) * f * size,
            float(e) * f)


def cluster_cost(e: int, f: int, n: int, size: int,
                 receiver_ids: bool = False) -> tuple[float, float]:
    """(bytes, operations) of the cluster aggregation: h read once, the
    least input that defines the sum (a sender and a weight an edge, a
    row pointer a row), the output written once; one multiply-add per
    edge and column.  ``receiver_ids``: the count before the row plan,
    12 B an edge (receiver, sender, weight) and no row pointer."""
    ids = 12.0 * e if receiver_ids else 8.0 * e + 4.0 * (n + 1)
    return (2.0 * n * f * size + ids, 2.0 * e * f)


def train_path(torch, args, card: dict) -> dict:
    """Phases 5–8; returns what the kernels line needs."""
    from hyperspace_torch.benchmarks import hgcn_bench as B
    from hyperspace_torch.kernels import cluster as KC
    from hyperspace_torch.kernels.cluster import (build_cluster_rows,
                                                  build_cluster_split,
                                                  cluster_aggregate)
    from hyperspace_torch.kernels.segment import csr_segment_sum
    from hyperspace_torch.models import hgcn

    dev = torch.device("cuda")
    # --- phase 5: the training data ------------------------------------
    # the reordered graph is kept: node classification (phase 30) trains
    # on the whole of it
    t0 = time.perf_counter()
    graph = B.arxiv_scale_reordered(seed=args.seed)
    graph_s = time.perf_counter() - t0
    split, _ = B.arxiv_scale_split(seed=args.seed, graph=graph)
    split_s = time.perf_counter() - t0 - graph_s
    setup = B.setup_lp(device=dev, seed=args.seed, split=split)
    agg, n = setup.ga.cluster, setup.num_nodes
    cs = setup.split.graph.cluster_split
    if cs is None:
        raise AssertionError("no cluster split at arxiv scale")
    n_strag = int(cs.s_mask.sum())
    t1 = time.perf_counter()
    build_cluster_rows(cs.c_recv, cs.c_send, n, with_rev=True)
    # host_prep_s counts what it counted when setup_lp built the split
    # itself: the graph, the split and the pairs; graph_s and split_s are
    # its first two parts
    emit({"phase": "train_setup",
          "host_prep_s": graph_s + split_s + setup.prep_s,
          "graph_s": graph_s, "split_s": split_s,
          "row_plan_s": time.perf_counter() - t1,
          "seconds": time.perf_counter() - t0, "nodes": n,
          "edges_padded": int(setup.split.graph.senders.shape[0]),
          "edges_real": setup.split.graph.num_edges,
          "frac_clustered": cs.frac_clustered,
          "clustered_edges": len(cs.c_recv),
          "straggler_edges": n_strag,
          "straggler_edges_padded": len(cs.s_recv),
          "train_pairs": int(setup.pos.u.shape[0]),
          "max_in_degree": int(setup.split.graph.deg.max())})

    # --- phase 6: the scatter kernels against their plain versions -----
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 1)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    err = {"csr_segment_sum": 0.0, "cluster_aggregate": 0.0}

    def seg_case(label, recv, f, dtype, n_real=None):
        err["csr_segment_sum"] = max(err["csr_segment_sum"], check_segsum(
            torch, gen, label, recv, n, f, dtype, n_real))

    bf16, f32 = torch.bfloat16, torch.float32
    seg_case("stragglers", agg.s_recv, 128, bf16, n_strag)
    seg_case("stragglers", agg.s_recv, 32, bf16, n_strag)
    seg_case("decoder u", setup.pos.u, 33, bf16)
    seg_case("decoder v sorted", setup.pos.v_sorted, 33, f32)
    sparse = np.sort(rng.choice(n // 3, 200_000) * 3)   # 2 rows in 3 empty
    seg_case("empty rows + padding", torch.as_tensor(np.concatenate(
        [sparse, np.full(50_000, n - 1)]).astype(np.int32), device=dev),
        33, bf16, 200_000)
    # the same edge sets from an unaligned data_ptr (a view one element
    # in), a few thousand edges over all the rows, and no edge at all
    seg_case("stragglers, unaligned view", agg.s_recv, 128, bf16, -n_strag)
    seg_case("decoder u, unaligned view", setup.pos.u, 33, bf16, -len(
        setup.pos.u))
    few = np.sort(rng.choice(n, 3_000, replace=False)).astype(np.int32)
    seg_case("3,000 edges over all rows", torch.as_tensor(few, device=dev),
             128, bf16)
    seg_case("no edge", torch.zeros(0, dtype=torch.int32, device=dev), 128,
             bf16)

    def cl_case(f, dtype):
        err["cluster_aggregate"] = max(err["cluster_aggregate"],
                                       check_cluster(torch, gen, "clustered",
                                                     agg, n, f, dtype))

    cl_case(128, bf16)
    cl_case(32, bf16)
    cl_case(128, f32)
    emit({"phase": "scatter_checks", "seconds": time.perf_counter() - t0})

    # --- phase 7: the training path --------------------------------------
    t0 = time.perf_counter()
    csr_segment_sum.launches = cluster_aggregate.launches = 0
    KC.row_plan_builds = 0
    torch.cuda.reset_peak_memory_stats()
    res = B.run_hgcn_bench(steps=TRAIN_STEPS, warmup=1, setup=setup)
    launches = {"csr_segment_sum": csr_segment_sum.launches,
                "cluster_aggregate": cluster_aggregate.launches,
                "row_plan_builds": KC.row_plan_builds}
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    emit({"phase": "train", "steps": TRAIN_STEPS, "warmup": 1,
          "warmup_loss": res["warmup_losses"], "losses": losses,
          "step_ms": res["step_ms"], "samples_per_s": res["value"],
          "launches": launches, "peak_device_memory_bytes": peak,
          "seconds": time.perf_counter() - t0, **card})
    for name, per_step in LAUNCHES_PER_STEP.items():
        if launches[name] != (TRAIN_STEPS + 1) * per_step:
            raise AssertionError(
                f"{name}: {launches[name]} launches over {TRAIN_STEPS + 1} "
                f"steps, want {per_step} a step")
    if launches["row_plan_builds"]:
        raise AssertionError(f"the steps built {launches['row_plan_builds']} "
                             "row plans; the split's should serve them all")
    if not np.all(np.isfinite(losses + res["warmup_losses"])):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    t1 = time.perf_counter()
    share = device_share(torch, setup.step, res["step_ms"], reps=3, top_n=8)
    auc = hgcn.evaluate_lp(setup.model, setup.split, "test", setup.ga)
    emit({"phase": "train_profile", "step_ms": res["step_ms"], **share,
          "test_roc_auc_after_steps": auc["roc_auc"],
          "seconds": time.perf_counter() - t1, **card})

    # --- phase 8: the whole step, card against CPU --------------------
    t0 = time.perf_counter()
    split, _ = B.arxiv_scale_split(CARD_CPU_NODES, seed=args.seed)
    g = split.graph
    g.cluster_split = build_cluster_split(   # prepare(cluster=True)'s split
        g.senders, g.receivers, g.edge_mask, g.deg, CARD_CPU_NODES,
        rev_perm=g.rev_perm)
    if not len(g.cluster_split.c_recv):
        raise AssertionError("the 20,000-node split clusters no edge")
    runs = {}
    for where in ("cuda", "cpu"):
        s = B.setup_lp(device=where, split=split, seed=args.seed)
        gen = torch.Generator().manual_seed(args.seed + 7)
        out = []
        for _ in range(2):
            neg_v = torch.randint(0, CARD_CPU_NODES, s.neg_u.shape,
                                  generator=gen, dtype=torch.int32)
            out.append(float(s.step(neg_v.to(s.device))))
        runs[where] = (out, {k: v.float().cpu() for k, v in
                             s.model.state_dict().items()})
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"][0],
                                                  runs["cpu"][0]))
    pdiff = max(float((runs["cuda"][1][k] - v).abs().max())
                for k, v in runs["cpu"][1].items())
    emit({"phase": "card_vs_cpu", "nodes": CARD_CPU_NODES,
          "frac_clustered": g.cluster_split.frac_clustered,
          "losses_cuda": runs["cuda"][0], "losses_cpu": runs["cpu"][0],
          "max_rel_loss_diff": rel, "max_param_abs_diff": pdiff,
          "seconds": time.perf_counter() - t0})
    if not rel <= CARD_CPU_RTOL:
        raise AssertionError(f"card and CPU losses differ by {rel}")
    return {"setup": setup, "launches": launches, "err": err,
            "cpu_split": split, "graph": graph}


def train_kernel_entries(torch, tr: dict, card: dict) -> list:
    """The scatter kernels' entries of the kernels line, timed at the
    training path's largest shapes on this run's inputs."""
    from hyperspace_torch.kernels.cluster import (cluster_aggregate,
                                                  cluster_aggregate_plain)
    from hyperspace_torch.kernels.segment import (csr_segment_sum,
                                                  csr_segment_sum_plain)

    setup = tr["setup"]
    agg, n, dev = setup.ga.cluster, setup.num_nodes, setup.device
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(11)

    def rand(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    r = agg.s_recv
    vals = {f: rand(r.shape[0], f) for f in (128, 32)}
    u = setup.pos.u
    vals_u = rand(u.shape[0], 33)
    v32, v32_32, vu32 = vals[128].float(), vals[32].float(), vals_u.float()
    r64, u64 = r.long(), u.long()

    def seg(v, rr):
        return lambda: csr_segment_sum(v, rr, None, n)

    sb, sby = bound_ms(*segment_cost(r.shape[0], 128, n, 2))
    seg_entry = {
        "name": "csr_segment_sum", "route": "cuda",
        "source": "hyperspace_torch/kernels/csrc/segment.cu",
        "entry": "hs_csr_segment_sum",
        "replaces": "hyperspace_tpu/kernels/segment.py:132",
        "launches": tr["launches"]["csr_segment_sum"],
        "launches_per_step": LAUNCHES_PER_STEP["csr_segment_sum"],
        "max_abs_err": tr["err"]["csr_segment_sum"],
        "shape": [r.shape[0], 128, n], "dtype": "bfloat16",
        "ms": device_ms(torch, seg(vals[128], r)),
        "plain_ms": device_ms(torch, lambda: csr_segment_sum_plain(
            vals[128], r, n)),
        "bound_ms": sb, "bound_by": sby,
        "library_ms": device_ms(torch, lambda: torch.zeros(
            (n, 128), device=dev).index_add_(0, r64, v32)),
        "library_call": "index_add_ of the f32 values into an f32 [N, F]",
        "call_ms": timed_ms(torch, seg(vals[128], r)),
        "ms_F32": device_ms(torch, seg(vals[32], r)),
        "bound_ms_F32": bound_ms(*segment_cost(r.shape[0], 32, n, 2))[0],
        "library_ms_F32": device_ms(torch, lambda: torch.zeros(
            (n, 32), device=dev).index_add_(0, r64, v32_32)),
        "ms_decoder_F33": device_ms(torch, seg(vals_u, u)),
        "bound_ms_decoder_F33": bound_ms(*segment_cost(u.shape[0], 33, n,
                                                       2))[0],
        "library_ms_decoder_F33": device_ms(torch, lambda: torch.zeros(
            (n, 33), device=dev).index_add_(0, u64, vu32)),
        **card}
    e = agg.c_recv.shape[0]
    h = {f: rand(n, f) for f in (128, 32)}
    h32 = h[128].float()
    w_csr = torch.sparse_coo_tensor(
        torch.stack([agg.c_recv.long(), agg.c_send.long()]), agg.c_wf,
        (n, n)).coalesce().to_sparse_csr()

    def clu(hh):         # as the step calls it, with its row plan
        return lambda: cluster_aggregate(hh, agg.c_wf, agg.c_recv,
                                         agg.c_send, None, n,
                                         rows=agg.c_rows)

    cb, cby = bound_ms(*cluster_cost(e, 128, n, 2))
    cl_entry = {
        "name": "cluster_aggregate", "route": "cuda",
        "source": "hyperspace_torch/kernels/csrc/cluster.cu",
        "entry": "hs_cluster_aggregate",
        "replaces": "hyperspace_tpu/kernels/cluster.py:213",
        "launches": tr["launches"]["cluster_aggregate"],
        "launches_per_step": LAUNCHES_PER_STEP["cluster_aggregate"],
        "max_abs_err": tr["err"]["cluster_aggregate"],
        "shape": [n, 128, e], "dtype": "bfloat16",
        "ms": device_ms(torch, clu(h[128])),
        "plain_ms": device_ms(torch, lambda: cluster_aggregate_plain(
            h[128], agg.c_wf, agg.c_recv, agg.c_send, n), reps=5),
        "bound_ms": cb, "bound_by": cby,
        "bound_ms_receiver_ids": bound_ms(*cluster_cost(e, 128, n, 2,
                                                        True))[0],
        "library_ms": device_ms(torch, lambda: torch.sparse.mm(w_csr, h32)),
        "library_call": "torch.sparse.mm of the f32 CSR weight matrix "
                        "and f32 h",
        "call_ms": timed_ms(torch, clu(h[128])),
        "ms_F32": device_ms(torch, clu(h[32])),
        "bound_ms_F32": bound_ms(*cluster_cost(e, 32, n, 2))[0],
        **card}
    return [seg_entry, cl_entry]


# --- the HGCN attention arm at ogbn-arxiv scale ------------------------------

ATT_LAUNCHES_PER_STEP = {"cluster_att_fwd": 2, "cluster_att_bwd": 2,
                         "csr_att_bwd_edges": 2, "csr_segment_reduce_1d": 2,
                         "csr_segment_sum": 7, "cluster_aggregate": 0}
ATT_BOUND = 30.0
ATT_SLOPE = 0.2


def att_counts() -> dict:
    from hyperspace_torch.kernels import cluster as KC
    from hyperspace_torch.kernels import segment as KS

    return {name: getattr(KC if name.startswith("cluster") else KS,
                          name).launches for name in ATT_LAUNCHES_PER_STEP}


def att_reset() -> None:
    from hyperspace_torch.kernels import cluster as KC
    from hyperspace_torch.kernels import segment as KS

    for name in ATT_LAUNCHES_PER_STEP:
        getattr(KC if name.startswith("cluster") else KS, name).launches = 0


def check_att(torch, kernel, label, got, again, want, scale, terms,
              weight_ulp=2.0 ** -23) -> float:
    """Hold an attention kernel's f32 output against its plain version's:
    within (2·terms·2^-24 + weight_ulp)·scale, where ``scale`` is the
    plain version's result on the absolute inputs (each output's absolute
    term sum) and ``terms`` the terms of each sum (the row's edge count,
    plus F + 1 where a dot product feeds it): both sum the same f32
    terms in other orders, and a weight may sit one ulp apart (one bf16
    ulp, at most 2^-7 of it, where it is rounded to bf16).  A second launch on the same input
    must give the same bits."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{kernel} {label}: {got.dtype} {got.shape} "
                             f"vs {want.dtype} {want.shape}")
    diff = (got - want).abs()
    tol = (2.0 * terms * F32_EPS + weight_ulp) * scale.abs()
    over = int((diff > tol).sum())
    worst = float(diff.max()) if diff.numel() else 0.0
    bitwise = bool(torch.equal(got, again))
    emit({"phase": "check", "kernel": kernel, "case": label,
          "shape": list(got.shape), "max_abs_err": worst,
          "over_tolerance": over, "repeat_bitwise_equal": bitwise})
    if over or not bitwise:
        raise AssertionError(f"{kernel} {label}: {over} entries beyond "
                             f"tolerance, repeat bitwise equal: {bitwise}")
    return worst


def att_path(torch, args, card: dict, tr: dict) -> dict:
    """Phases 9–11; returns what the kernels line needs."""
    from hyperspace_torch.benchmarks import hgcn_bench as B
    from hyperspace_torch.data import graphs as G
    from hyperspace_torch.kernels import cluster as KC
    from hyperspace_torch.kernels import segment as KS
    from hyperspace_torch.models import hgcn

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    # --- phase 9: phase 5's split, its cluster split at the attention
    # threshold; the four kernels against their plain versions ----------
    t0 = time.perf_counter()
    split = tr["setup"].split
    g = split.graph
    g.cluster_split = KC.build_cluster_split(
        g.senders, g.receivers, g.edge_mask, g.deg, g.num_nodes,
        min_pair_edges=G.cluster_min_pair_for(True), rev_perm=g.rev_perm)
    split_s = time.perf_counter() - t0
    setup = B.setup_lp(device=dev, split=split, seed=args.seed, use_att=True)
    agg, n = setup.ga.cluster, setup.num_nodes
    cs = g.cluster_split
    n_strag = int(cs.s_mask.sum())
    t1 = time.perf_counter()
    KC.build_cluster_rows(cs.c_recv, cs.c_send, n, with_rev=True)
    emit({"phase": "att_setup", "cluster_split_s": split_s,
          "row_plan_s": time.perf_counter() - t1,
          "seconds": time.perf_counter() - t0, "nodes": n,
          "min_pair_edges": G.cluster_min_pair_for(True),
          "frac_clustered": cs.frac_clustered, "att_ok": agg.att_ok,
          "clustered_edges": len(cs.c_recv), "straggler_edges": n_strag,
          "straggler_edges_padded": len(cs.s_recv),
          "lr": setup.cfg.lr, "clip_norm": setup.cfg.clip_norm})
    if not agg.att_ok:
        raise AssertionError(f"the attention gate is shut at arxiv scale "
                             f"(frac_clustered {cs.frac_clustered})")

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    err = {name: 0.0 for name in ("csr_segment_reduce_1d",
                                  "csr_att_bwd_edges", "cluster_att_fwd",
                                  "cluster_att_bwd", "csr_segment_sum")}

    def rand(*shape, dtype=f32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    rng = np.random.default_rng(args.seed + 2)
    sparse = np.sort(rng.choice(n // 3, 200_000) * 3)   # 2 rows in 3 empty
    sparse_r = torch.as_tensor(np.concatenate(
        [sparse, np.full(50_000, n - 1)]).astype(np.int32), device=dev)
    csr_sets = {"stragglers": (agg.s_recv, n_strag),
                "empty rows + padding": (sparse_r, 200_000)}

    def twice(fn):
        a = fn()
        b = fn()
        torch.cuda.synchronize()
        return a, b

    for label, (r, n_real) in csr_sets.items():
        k = torch.bincount(r.long(), minlength=n).float()
        v = rand(r.shape[0])
        v[n_real:] = 0                      # padding edges carry zeros
        for op in ("sum", "max"):
            got, again = twice(lambda: KS.csr_segment_reduce_1d(v, r, None,
                                                                n, op))
            want = KS.csr_segment_reduce_1d_plain(v, r, n, op)
            scale = (KS.csr_segment_reduce_1d_plain(v.abs(), r, n)
                     if op == "sum" else torch.zeros_like(want))
            err["csr_segment_reduce_1d"] = max(
                err["csr_segment_reduce_1d"], check_att(
                    torch, "csr_segment_reduce_1d", f"{label} {op}", got,
                    again, want, scale, k, 0.0))
        # B1 at the attention arm's widths: the (num | den) messages of
        # the first layer (F + 1 = 129) and of the second (33)
        for f in (129, 33):
            err["csr_segment_sum"] = max(err["csr_segment_sum"], check_segsum(
                torch, gen, f"attention {label}", r, n, f, bf16, n_real))
        # off: h and dn as views one element into their storage
        for f, dt, off in ((128, bf16, 0), (32, bf16, 0), (128, f32, 0),
                           (8, f32, 0), (130, bf16, 0), (128, bf16, 1),
                           (33, f32, 1)):
            dn = rand(n * (f + 1) + off)[off:].view(n, f + 1)
            h = rand(r.shape[0] * f + off, dtype=dt)[off:].view(-1, f)
            w = torch.rand(r.shape[0], generator=gen, device=dev) * 3
            w[n_real:] = 0
            lm = rand(r.shape[0], scale=8.0).clamp(-29.0, 29.0)
            got, again = twice(lambda: KS.csr_att_bwd_edges(
                dn, h, w, lm, r, None, n, ATT_BOUND, ATT_SLOPE))
            want = KS.csr_att_bwd_edges_plain(dn, h, w, lm, r, n, ATT_BOUND,
                                              ATT_SLOPE)
            sc = KS.csr_att_bwd_edges_plain(dn.abs(), h.abs(), w, lm, r, n,
                                            ATT_BOUND, ATT_SLOPE)
            tag = f"{label} F={f} {str(dt)[6:]}" + (", unaligned views"
                                                     if off else "")
            e0 = check_att(torch, "csr_att_bwd_edges", f"{tag} dpre",
                           got[0], again[0], want[0], sc[0], f + 1)
            e1 = check_att(torch, "csr_att_bwd_edges", f"{tag} d_alpha_r",
                           got[1], again[1], want[1], sc[1], f + 1 + k)
            err["csr_att_bwd_edges"] = max(err["csr_att_bwd_edges"], e0, e1)

    # rows 1, 2 of every 3 empty, and closed under reversal as
    # cluster_att_bwd's involution needs: both ends a multiple of 3
    every3 = ((agg.c_recv % 3) == 0) & ((agg.c_send % 3) == 0)
    # the path's set with the step's row plan; the subset's plan is built
    # on the card at each call
    c_sets = {"clustered": (agg.c_recv, agg.c_send, agg.c_rows),
              "clustered, empty rows": (agg.c_recv[every3].contiguous(),
                                        agg.c_send[every3].contiguous(),
                                        None)}
    a_s, a_r = rand(n, scale=0.7), rand(n, scale=0.7) + 0.3
    for label, (r, s_, rows) in c_sets.items():
        k = torch.bincount(r.long(), minlength=n).float()
        for f, dt in ((128, bf16), (32, bf16), (128, f32), (8, f32),
                      (130, bf16)):
            if label != "clustered" and f not in (128, 130):
                continue
            wulp = 2.0 ** -7 if dt == bf16 else 2.0 ** -23
            h = rand(n, f, dtype=dt)
            gext = rand(n, f + 1)
            tag = f"{label} F={f} {str(dt)[6:]}"
            got, again = twice(lambda: KC.cluster_att_fwd(
                h, a_s, a_r, r, s_, None, n, ATT_SLOPE, ATT_BOUND, rows=rows))
            if rows is not None:
                built = KC.cluster_att_fwd(h, a_s, a_r, r, s_, None, n,
                                           ATT_SLOPE, ATT_BOUND)
                if not torch.equal(got, built):
                    raise AssertionError(f"cluster_att_fwd {tag}: the plan "
                                         "built on the card gives other bits")
            want = KC.cluster_att_fwd_plain(h, a_s, a_r, r, s_, n, ATT_SLOPE,
                                            ATT_BOUND)
            sc = KC.cluster_att_fwd_plain(h.abs(), a_s, a_r, r, s_, n,
                                          ATT_SLOPE, ATT_BOUND)
            err["cluster_att_fwd"] = max(err["cluster_att_fwd"], check_att(
                torch, "cluster_att_fwd", tag, got, again, want, sc,
                k[:, None], wulp))
            got, again = twice(lambda: KC.cluster_att_bwd(
                gext, h, a_s, a_r, r, s_, None, n, ATT_SLOPE, ATT_BOUND,
                rows=rows))
            if rows is not None:
                built = KC.cluster_att_bwd(gext, h, a_s, a_r, r, s_, None, n,
                                           ATT_SLOPE, ATT_BOUND)
                if not all(torch.equal(a, b) for a, b in zip(got, built)):
                    raise AssertionError(f"cluster_att_bwd {tag}: the plan "
                                         "built on the card gives other bits")
            want = KC.cluster_att_bwd_plain(gext, h, a_s, a_r, r, s_, n,
                                            ATT_SLOPE, ATT_BOUND)
            sc = KC.cluster_att_bwd_plain(gext.abs(), h.abs(), a_s, a_r, r,
                                          s_, n, ATT_SLOPE, ATT_BOUND)
            for i, (part, terms, wu) in enumerate((
                    ("dh", k[:, None], wulp), ("d_alpha_s", f + 1 + k, 0.0),
                    ("d_alpha_r", f + 1 + k, 0.0))):
                err["cluster_att_bwd"] = max(err["cluster_att_bwd"],
                                             check_att(
                    torch, "cluster_att_bwd", f"{tag} {part}", got[i],
                    again[i], want[i], sc[i], terms, wu + 2.0 ** -23))
    emit({"phase": "att_checks", "seconds": time.perf_counter() - t0})

    # --- phase 10: the attention training path -------------------------
    t0 = time.perf_counter()
    att_reset()
    KC.row_plan_builds = 0
    torch.cuda.reset_peak_memory_stats()
    res = B.run_hgcn_bench(steps=TRAIN_STEPS, warmup=1, setup=setup)
    launches = {**att_counts(), "row_plan_builds": KC.row_plan_builds}
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    emit({"phase": "att_train", "steps": TRAIN_STEPS, "warmup": 1,
          "warmup_loss": res["warmup_losses"], "losses": losses,
          "step_ms": res["step_ms"], "samples_per_s": res["value"],
          "use_att": res["use_att"], "lr": res["lr"],
          "clip_norm": res["clip_norm"],
          "frac_clustered": res["frac_clustered"], "launches": launches,
          "peak_device_memory_bytes": peak,
          "seconds": time.perf_counter() - t0, **card})
    for name, per_step in ATT_LAUNCHES_PER_STEP.items():
        if launches[name] != (TRAIN_STEPS + 1) * per_step:
            raise AssertionError(
                f"attention: {name} launched {launches[name]} times in "
                f"{TRAIN_STEPS + 1} steps, want {per_step} a step")
    if launches["row_plan_builds"]:
        raise AssertionError(f"the attention steps built "
                             f"{launches['row_plan_builds']} row plans")
    if not np.all(np.isfinite(losses + res["warmup_losses"])):
        raise AssertionError(f"non-finite attention loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the attention loss did not fall: {losses}")
    t1 = time.perf_counter()
    share = device_share(torch, setup.step, res["step_ms"], reps=3, top_n=12)
    auc = hgcn.evaluate_lp(setup.model, setup.split, "test", setup.ga)
    emit({"phase": "att_profile", "step_ms": res["step_ms"], **share,
          "test_roc_auc_after_steps": auc["roc_auc"],
          "peak_device_memory_bytes": peak,
          "seconds": time.perf_counter() - t1, **card})

    # --- phase 11: two attention steps, card against CPU ---------------
    t0 = time.perf_counter()
    split20 = tr["cpu_split"]
    g20 = split20.graph
    g20.cluster_split = KC.build_cluster_split(
        g20.senders, g20.receivers, g20.edge_mask, g20.deg, CARD_CPU_NODES,
        min_pair_edges=G.cluster_min_pair_for(True), rev_perm=g20.rev_perm)
    runs = {}
    for where in ("cuda", "cpu"):
        s20 = B.setup_lp(device=where, split=split20, seed=args.seed,
                         use_att=True)
        s20.ga.cluster.use_att_cluster = True    # all four kernels run
        gen20 = torch.Generator().manual_seed(args.seed + 9)
        out = []
        for _ in range(2):
            neg_v = torch.randint(0, CARD_CPU_NODES, s20.neg_u.shape,
                                  generator=gen20, dtype=torch.int32)
            out.append(float(s20.step(neg_v.to(s20.device))))
        runs[where] = out
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"], runs["cpu"]))
    emit({"phase": "att_card_vs_cpu", "nodes": CARD_CPU_NODES,
          "frac_clustered": g20.cluster_split.frac_clustered,
          "losses_cuda": runs["cuda"], "losses_cpu": runs["cpu"],
          "max_rel_loss_diff": rel, "seconds": time.perf_counter() - t0})
    if not rel <= CARD_CPU_RTOL:
        raise AssertionError(f"attention: card and CPU losses differ by "
                             f"{rel}")
    return {"setup": setup, "launches": launches, "err": err}


def att_segsum_times(torch, at: dict) -> dict:
    """``csr_segment_sum``'s times at the attention arm's two widths: the
    (num | den) messages of the first layer (F + 1 = 129) and the second
    (33), bf16, on the attention split's straggler edges, beside their
    bounds and ``index_add_``'s time."""
    from hyperspace_torch.kernels.segment import csr_segment_sum

    setup = at["setup"]
    r, n, dev = setup.ga.cluster.s_recv, setup.num_nodes, setup.device
    gen = torch.Generator(device=dev).manual_seed(17)
    r64 = r.long()
    out = {"shape_att": [r.shape[0], n]}
    for f in (129, 33):
        v = torch.randn(r.shape[0], f, generator=gen, device=dev).to(
            torch.bfloat16)
        v32 = v.float()
        out[f"ms_att_F{f}"] = device_ms(
            torch, lambda: csr_segment_sum(v, r, None, n))
        out[f"bound_ms_att_F{f}"] = bound_ms(*segment_cost(r.shape[0], f, n,
                                                           2))[0]
        out[f"library_ms_att_F{f}"] = device_ms(torch, lambda: torch.zeros(
            (n, f), device=dev).index_add_(0, r64, v32))
    return out


def att_kernel_entries(torch, at: dict, card: dict) -> list:
    """The attention kernels' entries of the kernels line, timed at the
    attention path's shapes on this run's edge sets: the stragglers (B3,
    B5) and the clustered edges (B6) at F = 128, bf16 rows; bounds from
    the bytes each must move (inputs read once, outputs written once) or
    its f32 operations."""
    from hyperspace_torch.kernels import cluster as KC
    from hyperspace_torch.kernels import segment as KS

    setup = at["setup"]
    agg, n, dev = setup.ga.cluster, setup.num_nodes, setup.device
    gen = torch.Generator(device=dev).manual_seed(13)
    f32, bf16 = torch.float32, torch.bfloat16

    def rand(*shape, dtype=f32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    base = lambda name, entry, line, shape: {
        "name": name, "route": "cuda", "entry": entry,
        "replaces": f"hyperspace_tpu/kernels/{line}",
        "launches": at["launches"][name],
        "launches_per_step": ATT_LAUNCHES_PER_STEP[name],
        "max_abs_err": at["err"][name], "shape": shape}
    seg_src = "hyperspace_torch/kernels/csrc/segment.cu"
    cl_src = "hyperspace_torch/kernels/csrc/cluster.cu"
    r = agg.s_recv
    e = r.shape[0]
    v = rand(e)
    r64 = r.long()
    lengths = torch.bincount(r64, minlength=n)
    b3b, b3y = bound_ms(e * 8.0 + n * 4.0, float(e))
    entries = [{
        **base("csr_segment_reduce_1d", "hs_csr_segment_reduce_1d",
               "segment.py:257", [e, n]),
        "source": seg_src, "dtype": "float32", "op": "sum",
        "ms": device_ms(torch, lambda: KS.csr_segment_reduce_1d(
            v, r, None, n)),
        "plain_ms": device_ms(torch, lambda: KS.csr_segment_reduce_1d_plain(
            v, r, n)),
        "bound_ms": b3b, "bound_by": b3y,
        "library_ms": device_ms(torch, lambda: torch.zeros(
            n, device=dev).index_add_(0, r64, v)),
        "library_call": "index_add_ of the f32 values into an f32 [N]",
        "segment_reduce_ms": device_ms(torch, lambda: torch.segment_reduce(
            v, "sum", lengths=lengths)),
        "ms_max": device_ms(torch, lambda: KS.csr_segment_reduce_1d(
            v, r, None, n, "max")),
        "library_ms_max": device_ms(torch, lambda: torch.full(
            (n,), KS.NEG_FILL, device=dev).scatter_reduce_(0, r64, v,
                                                           "amax")),
        "call_ms": timed_ms(torch, lambda: KS.csr_segment_reduce_1d(
            v, r, None, n)), **card}]

    def b5_cost(f, size):
        return (e * (f * size + 16.0) + n * (4.0 * (f + 1) + 4.0),
                e * (2.0 * f + 8.0))

    dn = {f: rand(n, f + 1) for f in (128, 32)}
    hrow = {f: rand(e, f, dtype=bf16) for f in (128, 32)}
    w = torch.rand(e, generator=gen, device=dev) * 3
    lm = rand(e, scale=8.0).clamp(-29.0, 29.0)

    def b5(f):
        return lambda: KS.csr_att_bwd_edges(dn[f], hrow[f], w, lm, r, None,
                                            n, ATT_BOUND, ATT_SLOPE)

    b5b, b5y = bound_ms(*b5_cost(128, 2))
    entries.append({
        **base("csr_att_bwd_edges", "hs_csr_att_bwd_edges",
               "segment.py:392", [e, 128, n]),
        "source": seg_src, "dtype": "bfloat16 rows, f32 dn",
        "ms": device_ms(torch, b5(128)),
        "plain_ms": device_ms(torch, lambda: KS.csr_att_bwd_edges_plain(
            dn[128], hrow[128], w, lm, r, n, ATT_BOUND, ATT_SLOPE), reps=5),
        "bound_ms": b5b, "bound_by": b5y, "library_ms": None,
        "call_ms": timed_ms(torch, b5(128)),
        "ms_F32": device_ms(torch, b5(32)),
        "bound_ms_F32": bound_ms(*b5_cost(32, 2))[0], **card})

    ce = agg.c_recv.shape[0]
    h = {f: rand(n, f, dtype=bf16) for f in (128, 32)}
    gx = {f: rand(n, f + 1) for f in (128, 32)}
    a_s, a_r = rand(n, scale=0.7), rand(n, scale=0.7) + 0.3
    cr, csn = agg.c_recv, agg.c_send

    def fwd_cost(f, size, receiver_ids=False):
        # the least input: a sender an edge and a row pointer a row (before
        # the row plan: a receiver and a sender an edge); h and the two
        # scores read once, the [n, f + 1] f32 partials written once
        ids = ce * 8.0 if receiver_ids else ce * 4.0 + 4.0 * (n + 1)
        return (ids + n * (f * size + 8.0) + n * 4.0 * (f + 1),
                ce * (2.0 * f + 20.0))

    def bwd_cost(f, size, receiver_ids=False):
        # the least input: a sender an edge and a row pointer a row (before
        # the row plan: a receiver and a sender an edge); g, h and the two
        # scores read once, dh, dα_s and dα_r written once
        ids = ce * 8.0 if receiver_ids else ce * 4.0 + 4.0 * (n + 1)
        return (ids + n * (4.0 * (f + 1) + f * size + 8.0)
                + n * 4.0 * (f + 2), ce * (6.0 * f + 40.0))

    def fwd(f):          # as the step calls it, with its row plan
        return lambda: KC.cluster_att_fwd(h[f], a_s, a_r, cr, csn, None, n,
                                          ATT_SLOPE, ATT_BOUND,
                                          rows=agg.c_rows)

    def bwd(f):          # as the step calls it, with its row plan
        return lambda: KC.cluster_att_bwd(gx[f], h[f], a_s, a_r, cr, csn,
                                          None, n, ATT_SLOPE, ATT_BOUND,
                                          rows=agg.c_rows)

    fb, fby = bound_ms(*fwd_cost(128, 2))
    entries.append({
        **base("cluster_att_fwd", "hs_cluster_att_fwd", "cluster.py:401",
               [n, 128, ce]),
        "source": cl_src, "dtype": "bfloat16",
        "ms": device_ms(torch, fwd(128)),
        "plain_ms": device_ms(torch, lambda: KC.cluster_att_fwd_plain(
            h[128], a_s, a_r, cr, csn, n, ATT_SLOPE, ATT_BOUND), reps=5),
        "bound_ms": fb, "bound_by": fby, "library_ms": None,
        "bound_ms_receiver_ids": bound_ms(*fwd_cost(128, 2, True))[0],
        "call_ms": timed_ms(torch, fwd(128)),
        "ms_F32": device_ms(torch, fwd(32)),
        "bound_ms_F32": bound_ms(*fwd_cost(32, 2))[0], **card})
    bb, bby = bound_ms(*bwd_cost(128, 2))
    entries.append({
        **base("cluster_att_bwd", "hs_cluster_att_bwd", "cluster.py:575",
               [n, 128, ce]),
        "source": cl_src, "dtype": "bfloat16 h, f32 cotangent",
        "ms": device_ms(torch, bwd(128)),
        "plain_ms": device_ms(torch, lambda: KC.cluster_att_bwd_plain(
            gx[128], h[128], a_s, a_r, cr, csn, n, ATT_SLOPE, ATT_BOUND),
            reps=5),
        "bound_ms": bb, "bound_by": bby, "library_ms": None,
        "bound_ms_receiver_ids": bound_ms(*bwd_cost(128, 2, True))[0],
        "call_ms": timed_ms(torch, bwd(128)),
        "ms_F32": device_ms(torch, bwd(32)),
        "bound_ms_F32": bound_ms(*bwd_cost(32, 2))[0], **card})
    return entries


# --- the HyboNet path: text classification with flash attention -------------

# (batch, heads, L, dim) of the three entry points: workloads_bench's hybonet
# and hybonet_long legs and configs/hybonet_textclf.yaml through the CLI
HB_SHAPES = {"bench": (256, 4, 128, 128, 64),
              "long": (2, 2, 4096, 64, 4095),
              "cli": (64, 4, 32, 128, 8)}     # last: shortest sequence
# f32 kernels against their f32 plain versions (other summation orders)
FLASH_RTOL, FLASH_ATOL = 1e-4, 1e-5
LSE_TOL = 1e-5
MLR_RTOL, MLR_ATOL = 1e-4, 1e-5
# HGCN node classification's head (hyperspace_tpu/models/hgcn.py:263): the
# arxiv nodes, ogbn-arxiv's 40 classes (data/graphs.py:549-552), ball d 32
# (hidden (128, 32), configs/hgcn_sampled_nc.yaml)
MLR_NC_SHAPE = (169343, 40, 32)
# the whole Function against autograd of the dense twin: largest error
# over the largest entry, as the JAX package holds its own kernel
# (tests/kernels/test_attention.py, test_flash_backward_matches_twin);
# dτ the same way against the float64 twin, over the case: a head's dτ
# sums every pair's dσ·σ in f32 and may cancel far below its terms
FLASH_GRAD_TOL = 2e-3
HB_CARD_CPU_RTOL = 1e-4
HB_CLI_YAML = os.path.join("configs", "hybonet_textclf.yaml")
HB_CLI_STEPS = 250                 # of the config's 500: the smoke's clock


def hb_counts() -> dict:
    from hyperspace_torch.kernels import attention as A
    from hyperspace_torch.kernels.mlr import hyp_mlr

    return {"flash_fwd": A.flash_fwd.launches,
            "flash_dq": A.flash_dq.launches,
            "flash_dkv": A.flash_dkv.launches, "hyp_mlr": hyp_mlr.launches}


def hb_reset() -> None:
    from hyperspace_torch.kernels import attention as A
    from hyperspace_torch.kernels.mlr import hyp_mlr

    A.flash_fwd.launches = A.flash_dq.launches = 0
    A.flash_dkv.launches = hyp_mlr.launches = 0


def hb_inputs(torch, rng, dev, batch, heads, length, dim, min_len):
    """Attention inputs as an entry point gives them: q, k, v [B·h, L,
    dim/h + 1] on the hyperboloid, per-head β and τ, and the padding mask of
    sequences of min_len..L tokens (uint8 [B, L, L], shared by the
    heads; padded query rows have no valid key)."""
    d = dim // heads + 1
    b = batch * heads

    def rows(n):
        sp = rng.standard_normal((b, n, d - 1)) * 0.5
        t = np.sqrt(1.0 + np.sum(sp * sp, axis=-1, keepdims=True))
        return torch.as_tensor(np.concatenate([t, sp], axis=-1),
                               dtype=torch.float32, device=dev)

    lens = rng.integers(min_len, length + 1, batch)
    lens[0] = min_len
    m = np.arange(length)[None, :] < lens[:, None]
    att = m[:, None, :] & m[:, :, None]
    beta = rng.standard_normal(heads) * 0.3
    tau = 1.0 + rng.random(heads)
    f32 = dict(dtype=torch.float32, device=dev)
    return {"q": rows(length), "k": rows(length), "v": rows(length),
            "beta_h": torch.as_tensor(beta, **f32),
            "tau_h": torch.as_tensor(tau, **f32),
            "beta_b": torch.as_tensor(np.tile(beta, batch), **f32),
            "tau_b": torch.as_tensor(np.tile(tau, batch), **f32),
            "mask": torch.as_tensor(att.astype(np.uint8), device=dev),
            "group": heads, "batch": batch, "heads": heads,
            "valid_pairs": int(att.sum()) * heads}


def check_flash(torch, label, x, gen) -> dict:
    """Forward (out, lse) against the forward kernel's plain version; dq,
    dk, dv and dτ of the whole Function against the dense twin's
    autograd, for an output cotangent drawn from ``gen``.  Returns the
    largest errors."""
    from hyperspace_torch.kernels import attention as A

    q, k, v, mask, g = x["q"], x["k"], x["v"], x["mask"], x["group"]
    out, lse, _ = A.flash_fwd(q, k, v, C, x["beta_b"], x["tau_b"], mask, g)
    torch.cuda.synchronize()
    w_out, w_lse, _ = A.flash_fwd_plain(q, k, v, C, x["beta_b"],
                                        x["tau_b"], mask, g)
    over = int(((out - w_out).abs()
                > FLASH_ATOL + FLASH_RTOL * w_out.abs()).sum())
    over += int(((lse - w_lse).abs() > LSE_TOL * (1 + w_lse.abs())).sum())
    empty = lse == 1e30
    if not torch.equal(empty, w_lse == 1e30) or bool(
            (out[empty] != 0).any()):
        raise AssertionError(f"flash {label}: rows with no valid key differ")
    b4 = (x["batch"], x["heads"])
    shape4 = b4 + tuple(q.shape[1:])
    mask4 = mask.bool()[:, None]
    g_out = torch.randn(shape4, generator=gen, device=q.device)
    grads = {}
    for kind in ("kernel", "twin", "twin64"):
        dt = torch.float64 if kind == "twin64" else torch.float32
        ins = [t.reshape(b4 + tuple(t.shape[1:])).to(dt).clone()
               .requires_grad_() for t in (q, k, v)]
        tau = x["tau_h"].to(dt)[:, None, None].clone().requires_grad_()
        beta = x["beta_h"].to(dt)[:, None, None].clone().requires_grad_()
        if kind == "kernel":
            o = A.flash_attention(*ins, C, beta=beta, tau=tau, mask=mask4)
        else:
            o = A.flash_attention_plain(*ins, C, beta, tau, mask4)
        (o * g_out.to(dt)).sum().backward()
        grads[kind] = [t.grad.double() for t in (*ins, tau, beta)]
    torch.cuda.synchronize()
    errs = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        got, want = grads["kernel"][i], grads["twin"][i]
        errs[name] = float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-3)
    t64 = grads["twin64"][3]
    t_err = float((grads["kernel"][3] - t64).abs().max())
    errs["dtau"] = t_err / max(float(t64.abs().max()), 1e-3)
    dbeta_zero = bool((grads["kernel"][4] == 0).all())
    emit({"phase": "check", "kernel": "flash_attention", "case": label,
          "shape": list(q.shape), "mask_group": g,
          "empty_rows": int(empty.sum()),
          "out_max_abs_err": float((out - w_out).abs().max()),
          "lse_max_abs_err": float((lse - w_lse).abs().max()),
          "over_tolerance": over, **{f"{k}_err": e for k, e in errs.items()},
          "dtau_kernel": grads["kernel"][3].flatten().tolist(),
          "dtau_f64_twin": t64.flatten().tolist(), "dbeta_zero": dbeta_zero})
    if over or max(errs["dq"], errs["dk"], errs["dv"],
                   errs["dtau"]) > FLASH_GRAD_TOL or not dbeta_zero:
        raise AssertionError(f"flash {label}: kernels disagree with their "
                             "plain versions")
    return {"fwd": float((out - w_out).abs().max()),
            "dq": errs["dq"], "dkv": max(errs["dk"], errs["dv"])}


def check_mlr(torch, rng, dev, n, k, d) -> float:
    from hyperspace_torch.kernels.mlr import hyp_mlr, hyp_mlr_plain

    def ball(m, s):
        u = rng.standard_normal((m, d))
        u *= rng.uniform(0.0, s, (m, 1)) / np.linalg.norm(u, axis=1,
                                                          keepdims=True)
        return torch.as_tensor(u, dtype=torch.float32, device=dev)

    x, p = ball(n, 0.9), ball(k, 0.5)
    a = torch.as_tensor(rng.standard_normal((k, d)) * 0.1,
                        dtype=torch.float32, device=dev)
    got = hyp_mlr(x, p, a, C)
    again = hyp_mlr(x, p, a, C)
    torch.cuda.synchronize()
    want = hyp_mlr_plain(x, p, a, C)
    diff = (got - want).abs()
    over = int((diff > MLR_ATOL + MLR_RTOL * want.abs()).sum())
    same = bool(torch.equal(got, again))
    emit({"phase": "check", "kernel": "hyp_mlr", "shape": [n, k, d],
          "max_abs_err": float(diff.max()), "over_tolerance": over,
          "repeat_equal": same})
    if over or not same:
        raise AssertionError(f"hyp_mlr [{n}, {k}, {d}]: {over} entries "
                             f"beyond tolerance, repeat equal {same}")
    return float(diff.max())


def hybonet_path(torch, args, card: dict) -> dict:
    """Phases 12–15; returns what the kernels line needs."""
    import contextlib

    from hyperspace_torch.benchmarks import workloads_bench as WB
    from hyperspace_torch.cli import train as cli_train
    from hyperspace_torch.data.text import synthetic_text
    from hyperspace_torch.models import hybonet

    dev = torch.device("cuda")
    # --- phase 12: the HyboNet kernels against their plain versions ------
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 3)
    inputs = {name: hb_inputs(torch, rng, dev, *shape)
              for name, shape in HB_SHAPES.items()}
    err = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0,
           "hyp_mlr": 0.0}
    tails = hb_inputs(torch, rng, dev, 3, 2, 70, 16, 1)  # 70 = 64 + 6
    tails["k"] = tails["k"][:, :45].contiguous()     # Nk = 45 keys
    tails["v"] = tails["v"][:, :45].contiguous()
    tails["mask"] = tails["mask"][:, :, :45].contiguous()
    g_out = torch.Generator(device=dev).manual_seed(args.seed + 3)
    for label, x in (*inputs.items(), ("tails", tails)):
        e = check_flash(torch, label, x, g_out)
        err["flash_fwd"] = max(err["flash_fwd"], e["fwd"])
        err["flash_dq"] = max(err["flash_dq"], e["dq"])
        err["flash_dkv"] = max(err["flash_dkv"], e["dkv"])
    for n, k, d in ((256, 8, 128), (2, 8, 64), (64, 4, 128), (3, 300, 33),
                    MLR_NC_SHAPE, (1003, 40, 32), (1003, 300, 33)):
        err["hyp_mlr"] = max(err["hyp_mlr"], check_mlr(torch, rng, dev, n,
                                                       k, d))
    emit({"phase": "hybonet_checks", "seconds": time.perf_counter() - t0})

    # --- phase 13: the bench legs ---------------------------------------
    launches = {name: 0 for name in hb_counts()}
    legs = {}
    for name, steps in (("hybonet", 10), ("hybonet_long", 5)):
        t0 = time.perf_counter()
        leg = WB.setup_leg(name, device=dev, seed=args.seed)
        hb_reset()
        torch.cuda.reset_peak_memory_stats()
        res = WB.run_leg(leg, steps=steps, repeats=3)
        counts = hb_counts()
        peak = torch.cuda.max_memory_allocated()
        n_steps = 1 + 3 * steps
        layers = leg.cfg.num_layers
        want = {"flash_fwd": layers, "flash_dq": layers,
                "flash_dkv": layers, "hyp_mlr": 1}
        share = device_share(torch, leg.step, res["step_ms"], reps=3,
                             top_n=8)
        legs[name] = {**res, **share, "launches": counts,
                      "peak_device_memory_bytes": peak}
        emit({"phase": "hybonet_bench", "leg": name,
              **{k: v for k, v in res.items() if k != "losses"},
              "first_loss": res["losses"][0], "last_loss": res["losses"][-1],
              **share, "launches": counts, "steps_run": n_steps,
              "peak_device_memory_bytes": peak,
              "seconds": time.perf_counter() - t0, **card})
        for kname, per in want.items():
            if counts[kname] != n_steps * per:
                raise AssertionError(f"{name}: {kname} launched "
                                     f"{counts[kname]} times in {n_steps} "
                                     f"steps, want {per} a step")
            launches[kname] += counts[kname]
        if not np.all(np.isfinite(res["losses"])):
            raise AssertionError(f"{name}: non-finite loss {res['losses']}")

    # --- phase 14: the CLI with configs/hybonet_textclf.yaml -----------
    t0 = time.perf_counter()
    log = os.path.join(REPO, "build", "chip_smoke", "hybonet_cli.jsonl")
    if os.path.exists(log):
        os.remove(log)
    hb_reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_train.main(["hybonet", "--yaml", os.path.join(REPO, HB_CLI_YAML),
                        f"log={log}", "eval_every=1",
                        f"steps={HB_CLI_STEPS}"])
    counts = hb_counts()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    with open(log) as f:
        losses = [json.loads(s)["loss"] for s in f]
    emit({"phase": "hybonet_cli", "config": HB_CLI_YAML, **res,
          "steps": len(losses), "first_loss": losses[0],
          "launches": counts, "seconds": time.perf_counter() - t0, **card})
    for kname, n in counts.items():
        if n < len(losses):
            raise AssertionError(f"CLI: {kname} launched {n} times in "
                                 f"{len(losses)} steps")
        launches[kname] += n
    if not (np.isfinite(res["loss"]) and res["loss"] < losses[0]):
        raise AssertionError(f"CLI: the loss did not fall: {losses[0]} -> "
                             f"{res['loss']}")

    # --- phase 15: two steps, card against CPU --------------------------
    t0 = time.perf_counter()
    ds = synthetic_text(num_samples=64, vocab_size=512, num_classes=4,
                        max_len=32, seed=args.seed)
    cfg = hybonet.HyboNetConfig(dim=64, num_heads=4, num_layers=2,
                                batch_size=32)
    runs = {}
    for where in ("cuda", "cpu"):
        model, opt, state = hybonet.init_model(cfg, seed=args.seed,
                                               device=where)
        losses_w = []
        for i in range(2):
            t, m, y = (torch.as_tensor(a[32 * i:32 * i + 32], device=where)
                       for a in (ds.tokens, ds.mask, ds.labels))
            state, loss = hybonet.train_step(model, opt, state, t, m, y)
            losses_w.append(float(loss))
        runs[where] = losses_w
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"], runs["cpu"]))
    emit({"phase": "hybonet_card_vs_cpu", "losses_cuda": runs["cuda"],
          "losses_cpu": runs["cpu"], "max_rel_loss_diff": rel,
          "seconds": time.perf_counter() - t0})
    if not rel <= HB_CARD_CPU_RTOL:
        raise AssertionError(f"HyboNet card and CPU losses differ by {rel}")
    return {"inputs": inputs, "err": err, "launches": launches,
            "legs": legs}


def flash_cost(x: dict, kind: str) -> tuple[float, float, float]:
    """(bytes, f32 operations, TF32 operations) of one flash kernel on an
    entry point's inputs: each input read once and each output written
    once, the mask as uint8 (one byte per (sequence, query, key), shared
    by the heads); multiply-adds over the valid (query, key) pairs only:
    2·D forward (Gram, p·v), 3·D in dq (Gram, ⟨dsp, v⟩, dσ·Jk), 4·D in
    dk/dv (Gram, p·dsp, ⟨dsp, v⟩, dσ·Jq), every one a 3×TF32 product on
    the tensor cores."""
    b, nq, d = x["q"].shape
    nk = x["k"].shape[1]
    rows_q, rows_k = 4.0 * b * nq * d, 4.0 * b * nk * d
    mask = float(x["mask"].numel()) + 8.0 * b
    if kind == "fwd":      # q, k, v in; out, lse, nrm out
        nbytes, macs = rows_q + 2 * rows_k + rows_q + 8.0 * b * nq, 2 * d
    elif kind == "dq":     # q, k, v, dsp, lse, di in; dq out
        nbytes, macs = 3 * rows_q + 2 * rows_k + 8.0 * b * nq, 3 * d
    else:                  # q, k, v, dsp, lse, di in; dk, dv out
        nbytes, macs = 2 * rows_q + 4 * rows_k + 8.0 * b * nq, 4 * d
    return nbytes + mask, 0.0, TF32_PASSES * 2.0 * macs * x["valid_pairs"]


def mlr_cost(n: int, k: int, d: int) -> tuple[float, float, float]:
    """(bytes, f32 operations, TF32 operations) of the MLR logits as the
    launch plan takes them: x, p, a read and the [n, k] logits written
    once; the row and class norms and about 30 operations of closed form
    per logit in f32; the two products x·pᵀ, x·aᵀ in f32 on the pair
    plan, as 3×TF32 on the tensor cores on the tile plan."""
    from hyperspace_torch.kernels.mlr import mlr_plan

    products = 4.0 * n * k * d
    f32 = 2.0 * (n + 3 * k) * d + 30.0 * n * k
    nbytes = 4.0 * (n * d + 2 * k * d + n * k)
    if mlr_plan(n, k, d).tile:
        return nbytes, f32, TF32_PASSES * products
    return nbytes, f32 + products, 0.0


def hybonet_kernel_entries(torch, hb: dict, card: dict) -> list:
    """The four HyboNet kernels' entries of the kernels line: device times
    at the bench leg's shape (the largest per launch), and at the long
    leg's and the CLI's."""
    from hyperspace_torch.kernels import attention as A
    from hyperspace_torch.kernels.mlr import hyp_mlr, hyp_mlr_plain

    dev = torch.device("cuda")
    runs = {}
    for name, x in hb["inputs"].items():
        q, k, v, m, g = x["q"], x["k"], x["v"], x["mask"], x["group"]
        bb, tb = x["beta_b"], x["tau_b"]
        out, lse, _ = A.flash_fwd(q, k, v, C, bb, tb, m, g)
        dsp = torch.randn_like(out)
        di = torch.sum(dsp * out, dim=-1)
        fa = (q, k, v, C, bb, tb, m, g)
        ba = fa + (dsp, lse, di)
        runs[name] = {
            "fwd": (lambda fa=fa: A.flash_fwd(*fa),
                    lambda fa=fa: A.flash_fwd_plain(*fa)),
            "dq": (lambda ba=ba: A.flash_dq(*ba),
                   lambda ba=ba: A.flash_dq_plain(*ba)),
            "dkv": (lambda ba=ba: A.flash_dkv(*ba),
                    lambda ba=ba: A.flash_dkv_plain(*ba))}
    # the library yardsticks, on (q·2/τ, Jk, v) with the boolean mask (the
    # score's constant (2/c + β)/τ cancels in the softmax), D zero-padded
    # to 40: one scaled_dot_product_attention call and the elementwise
    # Lorentz epilogue for the forward; for dq and dk/dv together, the one
    # backward call that its autograd makes (its forward and the epilogue
    # outside the timed window)
    def sdpa_inputs(x):
        bsz, h = x["batch"], x["heads"]
        d = x["q"].shape[-1]

        def pad40(t):
            return torch.nn.functional.pad(t, (0, 40 - d)).reshape(
                bsz, h, t.shape[1], 40)

        return (pad40(x["q"] * (2.0 / x["tau_b"])[:, None, None]),
                pad40(torch.cat([-x["k"][..., :1], x["k"][..., 1:]], dim=-1)),
                pad40(x["v"]), x["mask"].bool()[:, None])

    def library(x):
        qs, kf, vs, mb = sdpa_inputs(x)
        d = x["q"].shape[-1]

        def run():
            s = torch.nn.functional.scaled_dot_product_attention(
                qs, kf, vs, attn_mask=mb, scale=1.0)[..., :d]
            return A._epilogue(s, C)
        return run

    def library_bwd(x):
        qs, kf, vs, mb = sdpa_inputs(x)
        leaves = [t.detach().requires_grad_() for t in (qs, kf, vs)]
        o = torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=mb, scale=1.0)
        go = torch.randn_like(o)

        def run():
            return torch.autograd.grad(o, leaves, go, retain_graph=True)
        return run

    library_ms = {src: device_ms(torch, library(x),
                                 reps=5 if src == "long" else 20)
                  for src, x in hb["inputs"].items()}
    library_bwd_ms, bwd_call = {}, "not recorded"
    for src, x in hb["inputs"].items():
        fn = library_bwd(x)
        items, ops = profile_items(torch, fn, 5 if src == "long" else 20)
        library_bwd_ms[src] = (sum(items.values()) if items
                               else timed_ms(torch, fn))
        if src == "bench" and items:
            ops = [o for o in ops if "backward" in o and "aten::" in o]
            bwd_call = (f"{', '.join(ops)}; largest kernel "
                        f"{max(items, key=items.get)[:100]}")
        del fn
    bwd_library = ("one backward of scaled_dot_product_attention on (q·2/τ, "
                   "Jk, v), D padded to 40, bool mask, computing dq, dk and "
                   f"dv together (compare with dq + dk/dv): {bwd_call}")
    names = {"fwd": ("flash_attention_fwd", "hs_flash_fwd", ":199"),
             "dq": ("flash_attention_dq", "hs_flash_dq", ":410"),
             "dkv": ("flash_attention_dkv", "hs_flash_dkv", ":461")}
    per_step = {"fwd": "flash_fwd", "dq": "flash_dq", "dkv": "flash_dkv"}
    entries = []
    for kind, (name, entry, line) in names.items():
        kern, plain = runs["bench"][kind]
        bd, bby = bound_ms(*flash_cost(hb["inputs"]["bench"], kind))
        e = {"name": name, "route": "cuda",
             "source": "hyperspace_torch/kernels/csrc/attention.cu",
             "entry": entry,
             "replaces": f"hyperspace_tpu/kernels/attention.py{line}",
             "launches": hb["launches"][per_step[kind]],
             "launches_per_step": "num_layers",
             "max_abs_err": hb["err"][per_step[kind]],
             "shape": list(hb["inputs"]["bench"]["q"].shape),
             "ms": device_ms(torch, kern),
             "plain_ms": device_ms(torch, plain, reps=5),
             "bound_ms": bd, "bound_by": bby,
             "library_ms": (library_ms if kind == "fwd"
                            else library_bwd_ms)["bench"],
             "library_call": ("scaled_dot_product_attention on (q·2/τ, Jk, "
                              "v), D padded to 40, bool mask, + epilogue"
                              if kind == "fwd" else bwd_library),
             "mask": "uint8 [B, Nq, Nk] shared by the heads",
             "call_ms": timed_ms(torch, kern)}
        if kind != "fwd":        # the parts the wrapper cut each launch into
            which = 0 if kind == "dq" else 1
            qb = hb["inputs"]["bench"]["q"]
            e["blocks_per_sm"] = A._blocks_per_sm(qb.device.index, which,
                                                  qb.shape[2])
            e["blocks_per_sm_from"] = "hs_flash_bwd_blocks_per_sm"
            e["parts"] = {}
            for src, x in hb["inputs"].items():
                b_, nq_, d_ = x["q"].shape
                nk_ = x["k"].shape[1]
                e["parts"][src] = A._splits(
                    x["q"].device, which, b_, nq_ if kind == "dq" else nk_,
                    nk_ if kind == "dq" else nq_, d_)
        for src, reps in (("long", 5), ("cli", 20)):
            k2, _ = runs[src][kind]
            e[f"ms_{src}"] = device_ms(torch, k2, reps=reps)
            e[f"bound_ms_{src}"] = bound_ms(*flash_cost(hb["inputs"][src],
                                                        kind))[0]
            e[f"shape_{src}"] = list(hb["inputs"][src]["q"].shape)
            e[f"library_ms_{src}"] = (library_ms if kind == "fwd"
                                      else library_bwd_ms)[src]
        entries.append({**e, **card})
    gen = torch.Generator(device=dev).manual_seed(12)
    mlr_args = {}
    for src, (n, k, d) in (("bench", (256, 8, 128)), ("long", (2, 8, 64)),
                           ("cli", (64, 4, 128))):
        xb = torch.rand((n, d), generator=gen, device=dev) * 0.05
        p = torch.rand((k, d), generator=gen, device=dev) * 0.05
        a = torch.randn((k, d), generator=gen, device=dev) * 0.1
        mlr_args[src] = (xb, p, a, C)
    n, k, d = MLR_NC_SHAPE
    xn = torch.rand((n, d), generator=gen, device=dev) * (0.9 / np.sqrt(d))
    pn = torch.rand((k, d), generator=gen, device=dev) * (0.5 / np.sqrt(d))
    an = torch.randn((k, d), generator=gen, device=dev) * (1.0 / np.sqrt(d))
    mlr_args["nc"] = (xn, pn, an, C)
    mb_, mby = bound_ms(*mlr_cost(256, 8, 128))
    entries.append({
        "name": "hyp_mlr", "route": "cuda",
        "source": "hyperspace_torch/kernels/csrc/mlr.cu",
        "entry": "hs_hyp_mlr",
        "replaces": "hyperspace_tpu/kernels/mlr.py:125",
        "launches": hb["launches"]["hyp_mlr"], "launches_per_step": 1,
        "max_abs_err": hb["err"]["hyp_mlr"], "shape": [256, 8, 128],
        "ms": device_ms(torch, lambda: hyp_mlr(*mlr_args["bench"])),
        "plain_ms": device_ms(torch, lambda: hyp_mlr_plain(
            *mlr_args["bench"])),
        "bound_ms": mb_, "bound_by": mby, "library_ms": None,
        "call_ms": timed_ms(torch, lambda: hyp_mlr(*mlr_args["bench"])),
        "ms_long": device_ms(torch, lambda: hyp_mlr(*mlr_args["long"])),
        "ms_cli": device_ms(torch, lambda: hyp_mlr(*mlr_args["cli"])),
        "bound_ms_long": bound_ms(*mlr_cost(2, 8, 64))[0],
        "bound_ms_cli": bound_ms(*mlr_cost(64, 4, 128))[0],
        "ms_nc": device_ms(torch, lambda: hyp_mlr(*mlr_args["nc"])),
        "plain_ms_nc": device_ms(torch, lambda: hyp_mlr_plain(
            *mlr_args["nc"]), reps=5),
        "bound_ms_nc": bound_ms(*mlr_cost(*MLR_NC_SHAPE))[0],
        "bound_by_nc": bound_ms(*mlr_cost(*MLR_NC_SHAPE))[1],
        "shape_nc": list(MLR_NC_SHAPE), **card})
    return entries


# --- the approximate serving lanes: IVF probing and PQ codes -----------------

IVF_CLUSTERS = 512                 # bench.py's IVF-leg generator
NPROBES = (1, 2, 4, 8)
# PQ distances served against the f32 distance of the same id, both on
# the card: the same function on the same rows, reduced in another shape
PQ_F32_RTOL = PQ_F32_ATOL = 1e-6
LANE_RUNS = ([("f32", 0)] + [("f32", p) for p in NPROBES]
             + [("pq", 0), ("pq", 8)])


def lane_counts() -> dict:
    """Every serving kernel's launches, and those of each narrow lane
    apart (``pdist_bf16``, ``scan_topk_int8``, ...)."""
    from hyperspace_torch.kernels import scan_topk as S
    from hyperspace_torch.kernels.distmat import pdist

    out = {"pdist": pdist.launches, "scan_topk": S.scan_topk.launches,
           "scan_topk_cand": S.scan_topk_cand.launches,
           "scan_topk_pq": S.scan_topk_pq.launches,
           "pdist_bf16": pdist.launches_by_lane["bf16"]}
    for fn in (S.scan_topk, S.scan_topk_cand):
        out.update({f"{fn.__name__}_{ln}": n
                    for ln, n in fn.launches_by_lane.items() if ln != "f32"})
    return out


def lane_reset() -> None:
    from hyperspace_torch.kernels import scan_topk as S
    from hyperspace_torch.kernels.distmat import pdist

    pdist.launches = S.scan_topk.launches = 0
    S.scan_topk_cand.launches = S.scan_topk_pq.launches = 0
    for fn in (pdist, S.scan_topk, S.scan_topk_cand):
        fn.launches_by_lane = dict.fromkeys(fn.launches_by_lane, 0)


def expected_lane_launches(prec: str, nprobe: int, mode: str,
                           batches: int) -> dict:
    """Exact launches of the new kernels (and of pdist and scan_topk
    where the lane fixes them) for ``batches`` top-k batches."""
    fused = mode == "fused"
    want = {"scan_topk_cand": batches if fused and nprobe and prec == "f32"
            else 0,
            "scan_topk_pq": batches if fused and prec == "pq" and not nprobe
            else 0}
    if nprobe:                     # the centroid pass; no slab scan
        want.update(pdist=batches, scan_topk=0)
    elif prec == "pq":             # the coded scan replaces both
        want.update(pdist=0, scan_topk=0)
    elif fused:
        want.update(scan_topk=batches)
    return want


def clustered_table(torch, rng) -> np.ndarray:
    """82,115 rows in the 10-dim ball (c = 1): 512 clusters at moderate
    radii, as bench.py's IVF leg makes them — an isotropic blob admits
    no sub-linear index."""
    from hyperspace_torch.manifolds import PoincareBall

    centers = rng.standard_normal((IVF_CLUSTERS, DIM)) * 0.25
    vv = (centers[rng.integers(0, IVF_CLUSTERS, size=ROWS)]
          + rng.standard_normal((ROWS, DIM)) * 0.05)
    return PoincareBall(C).expmap0(
        torch.as_tensor(vv, dtype=torch.float32)).numpy()


def cand_cost(b: int, n: int, d: int, cand: int, valid: int,
              k: int) -> tuple[float, float]:
    """(bytes, operations) of a candidate top-k: the table, the candidate
    ids, the queries and their ids read once, the [b, k] answer written
    once; the distances to the ``valid`` candidates (id >= 0) only."""
    return (4.0 * (n * d + b * cand + b * d + b) + 8.0 * b * k,
            float(valid) * (2 * d + _CLOSED_FORM_FLOPS))


def pq_cost(b: int, m_rows: int, n: int, m: int,
            k: int) -> tuple[float, float]:
    """(bytes, operations) of an ADC top-k: the codes, the lookup tables
    and the query ids read once, the answer written once; m adds and the
    closing transform for each real row."""
    return (float(m_rows * m) + 4.0 * (b * m * 256 + b) + 8.0 * b * k,
            float(b) * min(n, m_rows) * (m + _CLOSED_FORM_FLOPS))


def check_topk(torch, kernel, label, got, again, want, *, lorentz_rows=None):
    """Kernel against plain: ids equal outside near-ties (distances within
    rtol/atol; for hyperboloid rows, arcosh arguments within twice the
    Gram form's forward-error bound (D + 2)·2^-24·c·Σ|x_i y_i|, taken at
    the largest Σ|x_i|), and a second launch bitwise equal to the
    first."""
    from hyperspace_torch.kernels import _support

    (gd, gi), (ad, ai), (wd, wi) = got, again, want
    torch.cuda.synchronize()
    fin = torch.isfinite(wd)
    worst = float((gd - wd).abs()[fin].max()) if bool(fin.any()) else 0.0
    if lorentz_rows is None:
        a, b, rt, at = gd, wd, RTOL, ATOL
    else:
        x0 = float(lorentz_rows.abs().sum(dim=1).max())
        # the arcosh arguments u = cosh(√c·d) − 1, in float64 (c = 1)
        a, b = (2.0 * torch.sinh(t.double() / 2.0) ** 2 for t in (gd, wd))
        rt = RTOL
        at = 2.0 * (lorentz_rows.shape[1] + 2) * 2.0 ** -24 * x0 * x0
    bad = _support.topk_disagreements(
        gi.cpu().numpy(), a.cpu().numpy(), wi.cpu().numpy(),
        b.cpu().numpy(), rtol=rt, atol=at)
    same = bool(torch.equal(gd, ad) and torch.equal(gi, ai))
    emit({"phase": "check", "kernel": kernel, "case": label,
          "max_abs_err": worst, "rows_disagreeing": bad,
          "ids_equal": bool(torch.equal(gi, wi)), "repeat_bitwise": same})
    if bad or not same:
        raise AssertionError(f"{kernel} {label}: {bad} rows disagree, "
                             f"repeat bitwise {same}")
    return worst


def storm_and_tie_checks(torch, table, qi, k_scan) -> dict:
    """Phase 17's cases for the two slab scans at the serving path's
    shapes (83,968 slab rows, 82,115 of them real, 1,024 queries; k 10
    dense, k_scan PQ m = 3): an insertion storm, where every row is
    nearer than all before it, and a slab of identical rows, whose
    answer must be exactly the plain version's ids, the lowest k columns
    but the query's own.  Returns the largest distance errors."""
    from hyperspace_torch.kernels import scan_topk as S

    dev = table.device
    padded = -(-ROWS // 2048) * 2048
    spec = ("poincare", C)
    # storm rows along one axis, their radius falling with the index
    storm = torch.zeros((padded, DIM), device=dev)
    storm[:, 0] = torch.tanh(torch.linspace(0.9, 0.01, padded,
                                            device=dev))
    # one point off the table, so no query sits on it (at d = 0 the two
    # versions' Gram forms round apart)
    tied = storm[:1].expand(padded, DIM).contiguous()
    origin = torch.zeros((BATCH, DIM), device=dev)
    # ADC sums −1 − v·2^-12, v = 256·code0 + code1 (exact), v falling
    v = torch.arange(padded - 1, -1, -1, device=dev) % 65536
    pq_storm = torch.stack([v // 256, v % 256, v * 0], 1).to(torch.uint8)
    j = torch.arange(256, dtype=torch.float32, device=dev)
    lut = torch.zeros((BATCH, 768), device=dev)
    lut[:, :256] = -1.0 - j * 256 * 2.0 ** -12
    lut[:, 256:512] = -j * 2.0 ** -12
    pq_tied = torch.full((padded, 3), 77, dtype=torch.uint8, device=dev)
    lut_t = lut.flip(1).contiguous()
    dense = (("dense storm, k 10", storm, origin, K),
             ("dense identical rows, k 10", tied, table[:BATCH], K))
    pq = (("pq storm, k 170", pq_storm, lut, k_scan),
          ("pq identical codes, k 170", pq_tied, lut_t, k_scan))
    err = {"scan_topk": 0.0, "scan_topk_pq": 0.0}
    for name, cases in (("scan_topk", dense), ("scan_topk_pq", pq)):
        for label, slab, x, k in cases:
            kw = dict(k=k, n=ROWS, exclude_self=True)
            if name == "scan_topk":
                run = lambda: S.scan_topk(slab, x, qi, 0,  # noqa: E731
                                          spec=spec, **kw)
                want = S.scan_topk_plain(slab, x, qi, 0, kind="poincare",
                                         c=C, **kw)
            else:
                run = lambda: S.scan_topk_pq(slab, x, qi, 0,  # noqa: E731
                                             spec=spec, **kw)
                want = S.scan_topk_pq_plain(slab, x, qi, 0, kind="poincare",
                                            c=C, **kw)
            got, again = run(), run()
            err[name] = max(err[name], check_topk(torch, name, label, got,
                                                  again, want))
            if "identical" in label:
                cols = torch.arange(k, device=dev)[None, :]
                lowest = cols + (cols >= qi.long()[:, None]).long()
                if not (torch.equal(got[1], want[1])
                        and torch.equal(got[1].long(), lowest)):
                    raise AssertionError(f"{name} {label}: ids are not the "
                                         "lowest k columns")
    return err


def ivf_pq_path(torch, args, card: dict, table_l, fresh) -> dict:
    from hyperspace_torch.cli import serve as cli
    from hyperspace_torch.kernels import _support
    from hyperspace_torch.kernels import scan_topk as S
    from hyperspace_torch.kernels.distmat import pdist
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.serve import (QueryEngine, RequestBatcher,
                                        export_artifact, load_artifact)
    from hyperspace_torch.serve.artifact import build_quant_payload
    from hyperspace_torch.serve.index import (_lift, auto_ncells,
                                              build_index)

    dev = table_l.device
    rng = np.random.default_rng([args.seed, 16])
    spec = ("poincare", C)

    # --- phase 16: the clustered table, its index and PQ payload -----------
    table = clustered_table(torch, rng)
    t0 = time.perf_counter()
    index = build_index(table, spec, auto_ncells(ROWS), iters=8, seed=0,
                        balance=2.0)
    index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    quant = build_quant_payload(table, spec, "pq")
    pq_s = time.perf_counter() - t0
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=work)
    path = os.path.join(tmp, "ivf_pq")
    written = export_artifact(path, table, spec, index=index, quant=quant)
    art = load_artifact(path)
    if art.fingerprint != written.fingerprint:
        raise AssertionError("the IVF/PQ artifact did not load back")
    emit({"phase": "ivf_pq_setup", "rows": ROWS, "dim": DIM,
          "clusters": IVF_CLUSTERS, "ncells": index.ncells,
          "max_cell": index.max_cell, "min_cell": int(index.counts.min()),
          "index_build_s": index_s, "pq_build_s": pq_s,
          "pq_m": quant.params["m"], **card})

    # --- phase 17: both kernels against their plain versions ---------------
    t0 = time.perf_counter()
    err = {"scan_topk_cand": 0.0, "scan_topk_pq": 0.0}
    ids = rng.choice(ROWS, BATCH, replace=False)
    eng = QueryEngine.from_artifact(art, nprobe=8, scan_mode="fused",
                                    precision="pq")
    qi = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    q = eng.table[qi.long()]
    dc = pdist(q, eng._centroids, C, manifold="poincare")
    order = torch.sort(dc, dim=1, stable=True)[1]
    cands = {p: eng._cells[order[:, :p]].reshape(BATCH, -1).contiguous()
             for p in NPROBES}

    def cand_case(label, table_, cand, qq, qid, k, ex, kind="poincare"):
        run = lambda: S.scan_topk_cand(table_, cand, qq, qid,  # noqa: E731
                                       spec=(kind, C), k=k, exclude_self=ex)
        got, again = run(), run()
        want = S.scan_topk_cand_plain(table_, cand, qq, qid, kind=kind, c=C,
                                      k=k, exclude_self=ex)
        err["scan_topk_cand"] = max(err["scan_topk_cand"], check_topk(
            torch, "scan_topk_cand", label, got, again, want,
            lorentz_rows=table_ if kind == "lorentz" else None))
        return got

    for p in (1, 8):
        for k in (10, 256):
            cand_case(f"nprobe {p}, C {cands[p].shape[1]}, k {k}",
                      eng.table, cands[p], q, qi, k, True)
    odd = cands[1][:, :37].clone()               # C not a multiple of 32
    odd[:, 5:9] = -1                             # pads in mid-list
    odd[7] = -1                                  # a query with no candidate
    cand_case("C 37, mid-list pads, an empty query, k 64 > reachable",
              eng.table, odd, q, qi, 64, True)
    # queries off the table: at d = 0 the two sides' Gram noise differs
    cand_case("C 37, k 10, exclude_self off, queries off the table",
              eng.table, odd, fresh, qi, 10, False)
    # two ids at one distance, the lower at the later position, in
    # different splits of a batch of 8: the earlier position comes first
    # (a (distance, id) key would put the lower id first)
    tied = eng.table.clone()
    tied[100] = tied[50000]
    tc = cands[8][:8].clone()
    tc[:, 0], tc[:, -1] = 50000, 100
    tq = (tied[50000] * 0.99)[None].expand(8, DIM).contiguous()
    if S._cand_splits(8, tc.shape[1], K, dev) < 2:
        raise AssertionError("scan_topk_cand: the tie case is not split")
    got = cand_case(f"ids 50000 and 100 tied at positions 0 and "
                    f"{tc.shape[1] - 1}, 8 queries", tied, tc, tq, qi[:8], K,
                    False)
    if not all(row.index(50000) < row.index(100)
               for row in got[1].tolist()):
        raise AssertionError("scan_topk_cand: a tie did not go to the "
                             "earlier position")
    lq = table_l[qi.long()]
    lcand = torch.as_tensor(rng.integers(0, ROWS, (BATCH, 600)),
                            dtype=torch.int32, device=dev)
    cand_case("lorentz, C 600, k 10", table_l, lcand, lq, qi, 10, True,
              kind="lorentz")

    q_lift = _lift(spec, q).float()
    lut3 = S.pq_lut(q_lift, eng.pq_codebooks, kind="poincare")
    k_scan = eng._k_scan(K, ROWS)
    # m = 8 codebooks from lifted table rows (2 lanes a subspace, 5 pad)
    lifted = torch.nn.functional.pad(_lift(spec, eng.table[:ROWS]), (0, 5))
    pick = torch.as_tensor(rng.integers(0, ROWS, (8, 256)), device=dev)
    cb8 = torch.stack([lifted[pick[s], 2 * s:2 * s + 2] for s in range(8)])
    codes8 = torch.as_tensor(rng.integers(0, 256, (ROWS, 8)),
                             dtype=torch.uint8, device=dev)
    lut8 = S.pq_lut(q_lift, cb8, kind="poincare")
    cases = (("m 3, k 170 (the path)", eng.scan_table, lut3, 0, ROWS,
              k_scan),
             ("m 8, k 256", codes8, lut8, 0, ROWS, 256),
             ("m 3, col0 5000, n < M, k 170", eng.scan_table, lut3, 5000,
              5000 + ROWS - 115, k_scan))
    for label, codes, lut, col0, n, k in cases:
        qid = qi + col0 if col0 else qi
        run = lambda: S.scan_topk_pq(codes, lut, qid, col0,  # noqa: E731
                                     spec=spec, k=k, n=n, exclude_self=True)
        got, again = run(), run()
        want = S.scan_topk_pq_plain(codes, lut, qid, col0, kind="poincare",
                                    c=C, k=k, n=n, exclude_self=True)
        err["scan_topk_pq"] = max(err["scan_topk_pq"], check_topk(
            torch, "scan_topk_pq", label, got, again, want))
    err.update(storm_and_tie_checks(torch, eng.table[:ROWS], qi, k_scan))
    emit({"phase": "ivf_pq_checks", "seconds": time.perf_counter() - t0})

    # --- phase 18: the lanes through the serve loop ------------------------
    ids8 = rng.choice(np.setdiff1d(np.arange(ROWS), ids), 8,
                      replace=False).tolist()
    lines = "\n".join(json.dumps(r) for r in (
        {"op": "topk", "ids": ids.tolist(), "k": K},
        {"op": "topk", "ids": ids8, "k": K},
        {"op": "stats"})) + "\n"
    answers, launches = {}, {}
    for prec, npb in LANE_RUNS:
        for mode in ("two_stage", "fused"):
            lane_reset()
            out = io.StringIO()
            closing = cli.run_serve(cli.ServeConfig(
                artifact=path, scan_mode=mode, precision=prec, nprobe=npb),
                stdin=io.StringIO(lines), stdout=out)
            got = lane_counts()
            resp = [json.loads(s) for s in out.getvalue().splitlines()]
            if len(resp) != 3 or any("error" in r for r in resp):
                raise AssertionError(f"{prec}/{npb}/{mode}: {resp}")
            want = expected_lane_launches(prec, npb, mode, 2)
            if any(got[name] != c for name, c in want.items()):
                raise AssertionError(f"{prec}/{npb}/{mode}: launches {got}, "
                                     f"want {want}")
            st = resp[2]
            if (st["scan_strategy"] != ("ivf" if npb else "exact")
                    or st["precision"] != prec):
                raise AssertionError(f"{prec}/{npb}/{mode}: stats {st}")
            answers[prec, npb, mode] = resp[0]
            launches[prec, npb, mode] = got
            emit({"phase": "lane_serve", "precision": prec, "nprobe": npb,
                  "scan_mode": mode, "launches": got,
                  "served": closing["served"]})
    exact_ids = np.asarray(answers["f32", 0, "two_stage"]["neighbors"])
    recall, tab = {}, torch.as_tensor(table, device=dev)
    for prec, npb in LANE_RUNS:
        ts, fu = answers[prec, npb, "two_stage"], answers[prec, npb, "fused"]
        nb = np.asarray(ts["neighbors"])
        ds = np.asarray(ts["dists"], np.float64)
        if nb.shape != (BATCH, K) or not np.all(np.isfinite(ds)) \
                or np.any(np.diff(ds, axis=1) < 0):
            raise AssertionError(f"{prec}/{npb}: bad answers")
        bad = _support.topk_disagreements(
            nb, ds, np.asarray(fu["neighbors"]),
            np.asarray(fu["dists"], np.float64), rtol=RTOL, atol=ATOL)
        if bad:
            raise AssertionError(f"{prec}/{npb}: two_stage and fused "
                                 f"disagree on {bad} rows")
        recall[f"{prec}_nprobe{npb}"] = float(np.mean(
            [len(set(a) & set(b)) / K for a, b in zip(nb, exact_ids)]))
        if prec == "pq":           # served distances are f32 distances
            for ans in (ts, fu):
                nbt = torch.as_tensor(ans["neighbors"], device=dev).long()
                want = PoincareBall(C).dist(tab[torch.as_tensor(
                    ids, device=dev).long()][:, None, :], tab[nbt])
                got = torch.as_tensor(ans["dists"], dtype=torch.float32,
                                      device=dev)
                over = int(((got - want).abs()
                            > PQ_F32_ATOL + PQ_F32_RTOL * want.abs()).sum())
                if over:
                    raise AssertionError(f"pq/{npb}: {over} served distances "
                                         "differ from their f32 distance")
    emit({"phase": "lane_recall", "k": K, "reference": "f32 exact",
          "recall_at_10": recall})

    # --- phase 19: queries/s at bucket 1024 --------------------------------
    cold = rng.permutation(ROWS)[:40 * BATCH].reshape(40, BATCH)
    throughput = {}
    for prec, npb in LANE_RUNS[:-1]:
        for mode in ("two_stage", "fused"):
            e = QueryEngine.from_artifact(art, scan_mode=mode,
                                          precision=prec, nprobe=npb)
            throughput[f"{prec}_nprobe{npb}_{mode}"] = batch_throughput(
                torch, e, RequestBatcher(e), cold)
    emit({"phase": "lane_throughput", "bucket": BATCH, "k": K, "rows": ROWS,
          **throughput, **card})
    shutil.rmtree(tmp, ignore_errors=True)
    fused = {name: sum(launches[prec, npb, "fused"][name]
                       for prec, npb in LANE_RUNS)
             for name in ("scan_topk_cand", "scan_topk_pq")}
    return {"err": err, "launches": fused, "art": art, "table": eng.table,
            "q": q,
            "qi": qi, "cands": cands, "lut3": lut3, "codes": eng.scan_table,
            "k_scan": k_scan, "index_build_s": index_s, "pq_build_s": pq_s}


def batch_throughput(torch, eng, batcher, cold) -> dict:
    """Batches of distinct cold ids through ``batcher`` (a batch a row
    of ``cold``: bucket 1024 unless said), and the engine call alone on
    the same ids, taken in turns; host
    clock, each ending in the copy of the answer to the host; medians
    after one warm-up, then the card's busy time and idle share."""
    from hyperspace_torch.telemetry import registry as telem

    mark = telem.default_registry().mark()     # process-cumulative counters
    walls = {"engine": [], "batcher": []}
    for j, ids in enumerate(cold[:21]):
        t0 = time.perf_counter()
        i, d = eng.topk_neighbors(ids.astype(np.int32), K)
        i.cpu(), d.cpu()
        t1 = time.perf_counter()
        batcher.topk(ids.tolist(), K)
        t2 = time.perf_counter()
        if j:                                          # after a warm-up
            walls["engine"].append(t1 - t0)
            walls["batcher"].append(t2 - t1)
    if telem.default_registry().snapshot(baseline=mark).get("serve/cache_hit"):
        raise AssertionError("a throughput batch hit the cache")
    med = float(np.median(walls["batcher"])) * 1e3
    more = iter(cold[21:])
    return {"batch_ms": med, "batches_per_s": 1e3 / med,
            "queries_per_s": cold.shape[1] * 1e3 / med,
            "engine_ms": float(np.median(walls["engine"])) * 1e3,
            **device_share(torch, lambda: batcher.topk(next(more).tolist(),
                                                       K), med)}


def ivf_pq_kernel_entries(torch, ip: dict, card: dict) -> list:
    """Device times of the two approximate-lane kernels and their plain
    versions at the path's shapes: the candidate scan at nprobe 8 (and
    1), the ADC scan at m = 3, k = 170."""
    from hyperspace_torch.kernels import scan_topk as S

    tab, q, qi = ip["table"], ip["q"], ip["qi"]
    spec = ("poincare", C)

    def cand(p):
        return lambda: S.scan_topk_cand(tab, ip["cands"][p], q, qi,
                                        spec=spec, k=K, exclude_self=True)

    c8 = ip["cands"][8]
    ok = c8 >= 0
    valid = int(ok.sum())
    # the same valid candidate rows, each read once and written out by
    # one PyTorch call: the time a plain gather of these rows takes
    g_ids = c8[ok]
    cb, cby = bound_ms(*cand_cost(BATCH, ROWS, DIM, c8.shape[1], valid, K))
    codes, lut, ks = ip["codes"], ip["lut3"], ip["k_scan"]

    def pq():
        return S.scan_topk_pq(codes, lut, qi, 0, spec=spec, k=ks, n=ROWS,
                              exclude_self=True)

    pb, pby = bound_ms(*pq_cost(BATCH, codes.shape[0], ROWS,
                                codes.shape[1], ks))
    return [
        {"name": "scan_topk_cand", "route": "cuda",
         "source": "hyperspace_torch/kernels/csrc/scan_topk.cu",
         "entry": "hs_scan_topk_cand",
         "replaces": "hyperspace_tpu/kernels/scan_topk.py:1087",
         "launches": ip["launches"]["scan_topk_cand"],
         "launches_per_batch": "1 under IVF fused (f32)",
         "max_abs_err": ip["err"]["scan_topk_cand"],
         "shape": [BATCH, c8.shape[1], DIM, K], "valid_candidates": valid,
         "ms": device_ms(torch, cand(8)),
         "plain_ms": device_ms(torch, lambda: S.scan_topk_cand_plain(
             tab, c8, q, qi, kind="poincare", c=C, k=K, exclude_self=True),
             reps=3),
         "bound_ms": cb, "bound_by": cby, "library_ms": None,
         "splits": S._cand_splits(BATCH, c8.shape[1], K, tab.device),
         "gather_ms": device_ms(torch, lambda: tab.index_select(0, g_ids)),
         "call_ms": timed_ms(torch, cand(8)),
         "ms_nprobe1": device_ms(torch, cand(1)),
         "shape_nprobe1": list(ip["cands"][1].shape),
         "splits_nprobe1": S._cand_splits(BATCH, ip["cands"][1].shape[1], K,
                                          tab.device), **card},
        {"name": "scan_topk_pq", "route": "cuda",
         "source": "hyperspace_torch/kernels/csrc/scan_topk.cu",
         "entry": "hs_scan_topk_pq",
         "replaces": "hyperspace_tpu/kernels/scan_topk.py:872",
         "launches": ip["launches"]["scan_topk_pq"],
         "launches_per_batch": "1 under PQ fused",
         "max_abs_err": ip["err"]["scan_topk_pq"],
         "shape": [BATCH, codes.shape[0], codes.shape[1], ks],
         **scan_parts(torch, pq),
         "plain_ms": device_ms(torch, lambda: S.scan_topk_pq_plain(
             codes, lut, qi, 0, kind="poincare", c=C, k=ks, n=ROWS,
             exclude_self=True), reps=3),
         "bound_ms": pb, "bound_by": pby, "library_ms": None,
         "call_ms": timed_ms(torch, pq), **card},
    ]


# --- phases 55-56: the bf16, int8 and int4 serving lanes ---------------------

QLANES = ("bf16", "int8", "int4")     # the narrow lanes of the slab scan
CAND_QLANES = ("bf16", "int8")        # and of the candidate scan
# the lanes through the serve loop: every lane × nprobe 0 and 8
QLANE_RUNS = [(p, n) for p in ("f32",) + QLANES for n in (0, 8)]
QLANE_BUCKETS = (8, BATCH)
# the entries of the kernels line these phases add: (name, kernel,
# lane, TPU kernel); each named as lane_counts() names its launches
QLANE_ENTRIES = (
    ("pdist_bf16", "pdist", "bf16", "hyperspace_tpu/kernels/distmat.py:119"),
    *((f"scan_topk_{ln}", "scan_topk", ln,
       "hyperspace_tpu/kernels/scan_topk.py:677") for ln in QLANES),
    *((f"scan_topk_cand_{ln}", "scan_topk_cand", ln,
       "hyperspace_tpu/kernels/scan_topk.py:1087") for ln in CAND_QLANES))


def lane_slabs(torch, slab) -> dict:
    """``slab`` (float32, on the card) in each narrow lane: ``{lane:
    (rows, scale, packed)}``, quantized by ``serve/quant.py`` as the
    engine quantizes its table."""
    from hyperspace_torch.serve import quant as Q

    host = slab.cpu().numpy()
    q8, s8 = Q.quantize_rows(host)
    p4, s4 = Q.pack_int4_rows(host)
    dev = slab.device
    return {"bf16": (slab.to(torch.bfloat16), None, False),
            "int8": (torch.as_tensor(q8, device=dev),
                     torch.as_tensor(s8, device=dev), False),
            "int4": (torch.as_tensor(p4, device=dev),
                     torch.as_tensor(s4, device=dev), True)}


def lane_row_bytes(lane: str, d: int) -> float:
    """Bytes of one table row in a lane, its scale included."""
    return {"f32": 4.0 * d, "bf16": 2.0 * d, "int8": d + 4.0,
            "int4": (d + 1) // 2 + 2.0}[lane]


def lane_scan_cost(b: int, m: int, n: int, d: int, k: int,
                   lane: str) -> tuple[float, float]:
    """:func:`scan_cost` with the slab read in ``lane``'s bytes (the
    queries, float32, and their ids read once, the answer written once)
    and one widening multiply an element of the narrow lanes."""
    nbytes, ops = scan_cost(b, m, n, d, k)
    nbytes += m * (lane_row_bytes(lane, d) - 4.0 * d)
    return nbytes, ops + (float(m) * d if lane in ("int8", "int4") else 0.0)


def lane_cand_cost(b: int, n: int, d: int, cand: int, valid: int, k: int,
                   lane: str) -> tuple[float, float]:
    """:func:`cand_cost` with the table read in ``lane``'s bytes."""
    nbytes, ops = cand_cost(b, n, d, cand, valid, k)
    return nbytes + n * (lane_row_bytes(lane, d) - 4.0 * d), ops


def quant_lane_checks(torch, args, card: dict, kinds, chunk: int,
                      padded: int, ip: dict) -> dict:
    """Phase 55: each narrow lane of the three kernels against its plain
    version on the card: bf16 ``pdist`` at phase 3's shapes within one
    bf16 ulp, the slab scan's lanes at phase 3's grid (buckets 8 and
    1024, k 1, 10 and 256, ``exclude_self``, ``col0`` and ``n`` cut),
    the candidate scan's lanes on phase 17's lists (nprobe 1 and 8, k 10
    and 256); each launched twice for the same bits."""
    from hyperspace_torch.kernels import _support
    from hyperspace_torch.kernels import scan_topk as S
    from hyperspace_torch.kernels.distmat import pdist, pdist_plain

    t0 = time.perf_counter()
    rng = np.random.default_rng([args.seed, 55])
    err = {name: 0.0 for name, *_ in QLANE_ENTRIES}
    ulps = 0.0
    for man, table, fresh in kinds:
        spec = (man, C)
        for b in QLANE_BUCKETS:
            x = fresh[:b].to(torch.bfloat16)
            for rows in (table[:chunk], table, table[:287]):
                y = rows.to(torch.bfloat16)
                got = pdist(x, y, C, manifold=man)
                again = pdist(x, y, C, manifold=man)
                torch.cuda.synchronize()
                want = pdist_plain(x, y, C, manifold=man).float()
                diff = (got.float() - want).abs()
                ulp = bf16_ulp(torch, want)
                worst = float(diff.max())
                over = int((diff > ulp).sum())
                same = bool(torch.equal(got, again))
                ratio = float((diff / torch.where(ulp > 0, ulp,
                                                  torch.ones_like(ulp)))
                              .max())
                err["pdist_bf16"] = max(err["pdist_bf16"], worst)
                ulps = max(ulps, ratio)
                emit({"phase": "lane_check", "kernel": "pdist_bf16",
                      "manifold": man, "shape": [b, y.shape[0], y.shape[1]],
                      "max_abs_err": worst, "max_bf16_ulps": ratio,
                      "beyond_one_ulp": over, "repeat_equal": same})
                if over or not same:
                    raise AssertionError(
                        f"pdist bf16 {man}: {over} entries beyond one bf16 "
                        f"ulp, repeat equal {same}")
        slab = torch.zeros((padded, table.shape[1]), device=table.device)
        slab[:ROWS] = table
        for lane, (rows, scale, packed) in lane_slabs(torch, slab).items():
            bad_all = 0
            for b, ex, (col0, n) in itertools.product(
                    QLANE_BUCKETS, (False, True),
                    ((0, ROWS), (5000, 5000 + ROWS - 115))):
                q = fresh[:b]
                qi = torch.as_tensor(rng.integers(col0, col0 + ROWS, b),
                                     dtype=torch.int32, device=q.device)
                kw = dict(n=n, exclude_self=ex, scale=scale, packed=packed)
                # the plain version's stable sort: its first k of 256 are
                # its answer at k
                pd, pi = S.scan_topk_plain(rows, q, qi, col0, kind=man, c=C,
                                           k=256, **kw)
                for k in (1, 10, 256):
                    got = S.scan_topk(rows, q, qi, col0, spec=spec, k=k,
                                      **kw)
                    again = S.scan_topk(rows, q, qi, col0, spec=spec, k=k,
                                        **kw)
                    torch.cuda.synchronize()
                    wd, wi = pd[:, :k], pi[:, :k]
                    fin = torch.isfinite(wd)
                    worst = float((got[0] - wd).abs()[fin].max())
                    err[f"scan_topk_{lane}"] = max(err[f"scan_topk_{lane}"],
                                                   worst)
                    bad = _support.topk_disagreements(
                        got[1].cpu().numpy(), got[0].cpu().numpy(),
                        wi.cpu().numpy(), wd.cpu().numpy(), rtol=RTOL,
                        atol=ATOL)
                    same = bool(torch.equal(got[0], again[0])
                                and torch.equal(got[1], again[1]))
                    if bad or not same:
                        raise AssertionError(
                            f"scan_topk {lane} {man} b={b} k={k} "
                            f"exclude_self={ex} col0={col0}: {bad} rows "
                            f"disagree, repeat bitwise {same}")
                    bad_all += bad
            emit({"phase": "lane_check", "kernel": f"scan_topk_{lane}",
                  "manifold": man, "cases": 24,
                  "max_abs_err": err[f"scan_topk_{lane}"],
                  "rows_disagreeing": bad_all, "repeat_bitwise": True})
    # the candidate scan's lanes on the IVF path's lists (phase 17)
    tab, q, qi = ip["table"], ip["q"], ip["qi"]
    ctabs = lane_slabs(torch, tab)
    for lane in CAND_QLANES:
        rows, scale, _ = ctabs[lane]
        for p in (1, 8):
            for k in (10, 256):
                run = lambda: S.scan_topk_cand(  # noqa: E731
                    rows, ip["cands"][p], q, qi, spec=("poincare", C), k=k,
                    exclude_self=True, scale=scale)
                got, again = run(), run()
                want = S.scan_topk_cand_plain(
                    rows, ip["cands"][p], q, qi, kind="poincare", c=C, k=k,
                    exclude_self=True, scale=scale)
                err[f"scan_topk_cand_{lane}"] = max(
                    err[f"scan_topk_cand_{lane}"], check_topk(
                        torch, f"scan_topk_cand_{lane}",
                        f"nprobe {p}, k {k}", got, again, want))
    emit({"phase": "lane_checks", "max_bf16_ulps_pdist": ulps,
          "max_abs_err": err, "seconds": time.perf_counter() - t0, **card})
    return {"err": err, "ctabs": ctabs}


def expected_quant_launches(prec: str, nprobe: int, mode: str, batches: int,
                            chunks: int) -> dict:
    """Exact launches of every lane's kernels for ``batches`` top-k
    batches of a lane run: the narrow lanes launch their own scan once a
    batch under ``fused`` (the candidate scan under IVF; int4 has none,
    so its probe scores in PyTorch), bf16 ``pdist`` once a chunk under
    ``two_stage``; f32 ``pdist`` takes the centroid pass of every probe
    and the chunks of the f32, int8 and int4 two-stage scans (those
    chunks widen to f32)."""
    fused = mode == "fused"
    want = {f"scan_topk_{ln}": batches if fused and not nprobe and prec == ln
            else 0 for ln in QLANES}
    want.update({f"scan_topk_cand_{ln}": batches
                 if fused and nprobe and prec == ln else 0
                 for ln in CAND_QLANES})
    two_chunks = 0 if fused or nprobe else batches * chunks
    want["pdist_bf16"] = two_chunks if prec == "bf16" else 0
    want["pdist"] = (batches if nprobe else 0) + two_chunks
    want["scan_topk"] = (sum(want[f"scan_topk_{ln}"] for ln in QLANES)
                         + (batches if fused and not nprobe
                            and prec == "f32" else 0))
    want["scan_topk_cand"] = (sum(want[f"scan_topk_cand_{ln}"]
                                  for ln in CAND_QLANES)
                              + (batches if fused and nprobe
                                 and prec == "f32" else 0))
    want["scan_topk_pq"] = 0
    return want


def quant_lane_engines(torch, args, card: dict, table_b, ip: dict) -> dict:
    """Phase 56: every lane × scan mode × nprobe 0 and 8 through the
    ``serve`` loop, on phase 4's random table (its index built here with
    the export defaults) and phase 16's clustered one; the counts set to
    0 before each run and read after: exactly the launches
    :func:`expected_quant_launches` gives; every served distance the f32
    distance of its id; recall@10 against the f32 exact answers of the
    same table; then queries/s and the card's busy ms at bucket 1024 for
    each narrow lane on the clustered table."""
    from hyperspace_torch.cli import serve as cli
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.serve import (QueryEngine, RequestBatcher,
                                        export_artifact, load_artifact)
    from hyperspace_torch.serve.engine import auto_chunk_rows
    from hyperspace_torch.serve.index import auto_ncells, build_index

    t0 = time.perf_counter()
    rng = np.random.default_rng([args.seed, 56])
    spec = ("poincare", C)
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=work)
    try:
        host = table_b.cpu().numpy()
        t1 = time.perf_counter()
        index = build_index(host, spec, auto_ncells(ROWS))
        index_s = time.perf_counter() - t1
        arts = {"random": os.path.join(tmp, "random"),
                "clustered": os.path.join(tmp, "clustered")}
        export_artifact(arts["random"], host, spec, index=index)
        a = ip["art"]
        export_artifact(arts["clustered"], a.table, spec, index=a.index)
        chunks = -(-ROWS // auto_chunk_rows(ROWS))
        ids = rng.choice(ROWS, BATCH, replace=False)
        ids8 = rng.choice(np.setdiff1d(np.arange(ROWS), ids), 8,
                          replace=False).tolist()
        lines = "\n".join(json.dumps(r) for r in (
            {"op": "topk", "ids": ids.tolist(), "k": K},
            {"op": "topk", "ids": ids8, "k": K},
            {"op": "stats"})) + "\n"
        answers, launches, recall, agree = {}, {}, {}, {}
        ball = PoincareBall(C)
        for tname, path in arts.items():
            tab = torch.as_tensor(load_artifact(path).table, device="cuda")
            qrows = tab[torch.as_tensor(ids, device="cuda").long()]
            for prec, npb in QLANE_RUNS:
                for mode in ("two_stage", "fused"):
                    lane_reset()
                    out = io.StringIO()
                    cli.run_serve(cli.ServeConfig(
                        artifact=path, scan_mode=mode, precision=prec,
                        nprobe=npb), stdin=io.StringIO(lines), stdout=out)
                    got = lane_counts()
                    resp = [json.loads(s) for s in
                            out.getvalue().splitlines()]
                    tag = f"{tname}/{prec}/{npb}/{mode}"
                    if len(resp) != 3 or any("error" in r for r in resp):
                        raise AssertionError(f"{tag}: {resp}")
                    want = expected_quant_launches(prec, npb, mode, 2,
                                                   chunks)
                    if any(got[n] != c for n, c in want.items()):
                        raise AssertionError(f"{tag}: launches {got}, want "
                                             f"{want}")
                    if resp[2]["precision"] != prec:
                        raise AssertionError(f"{tag}: stats {resp[2]}")
                    nb = np.asarray(resp[0]["neighbors"])
                    ds = np.asarray(resp[0]["dists"], np.float64)
                    if nb.shape != (BATCH, K) or not np.all(
                            np.isfinite(ds)) or np.any(np.diff(ds, 1) < 0):
                        raise AssertionError(f"{tag}: bad answers")
                    # the lanes' served distances are the f32 distances of
                    # their ids (the rescore); f32's come from the kernels'
                    # Gram form, held at the float64 truth's tier
                    f32 = ball.dist(qrows[:, None, :], tab[torch.as_tensor(
                        nb, device="cuda").long()]).double()
                    rt, at = ((TRUTH_RTOL, TRUTH_ATOL) if prec == "f32"
                              else (PQ_F32_RTOL, PQ_F32_ATOL))
                    over = int(((torch.as_tensor(ds, device="cuda")
                                 - f32).abs() > at + rt * f32.abs()).sum())
                    if over:
                        raise AssertionError(f"{tag}: {over} served "
                                             "distances are not the f32 "
                                             "distance of their id")
                    answers[tname, prec, npb, mode] = nb
                    launches[tname, prec, npb, mode] = got
            exact = answers[tname, "f32", 0, "two_stage"]
            for prec, npb in QLANE_RUNS:
                for mode in ("two_stage", "fused"):
                    nb = answers[tname, prec, npb, mode]
                    recall[f"{tname}_{prec}_nprobe{npb}_{mode}"] = float(
                        np.mean([len(set(x) & set(y)) / K
                                 for x, y in zip(nb, exact)]))
                agree[f"{tname}_{prec}_nprobe{npb}"] = float(np.mean(
                    answers[tname, prec, npb, "two_stage"]
                    == answers[tname, prec, npb, "fused"]))
        emit({"phase": "qlane_serve", "k": K, "reference": "f32 exact",
              "recall_at_10": recall,
              "two_stage_fused_ids_equal_share": agree,
              "index_build_s": index_s,
              "seconds": time.perf_counter() - t0, **card})
        # queries/s and busy ms at bucket 1024, clustered table
        art = load_artifact(arts["clustered"])
        throughput = {}
        cold = rng.permutation(ROWS)[:40 * BATCH].reshape(40, BATCH)
        for prec in QLANES:
            for npb in (0, 8):
                for mode in ("two_stage", "fused"):
                    e = QueryEngine.from_artifact(
                        art, scan_mode=mode, precision=prec, nprobe=npb)
                    throughput[f"{prec}_nprobe{npb}_{mode}_b{BATCH}"] = \
                        batch_throughput(torch, e, RequestBatcher(e), cold)
        emit({"phase": "qlane_throughput", "k": K, "rows": ROWS,
              **throughput, **card})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # each entry's launches over the lane runs on both tables
    totals = {name: sum(launches[key][name] for key in launches)
              for name, *_ in QLANE_ENTRIES}
    emit({"phase": "qlane_done", "launches": totals,
          "seconds": time.perf_counter() - t0, **card})
    return {"launches": totals, "recall": recall, "throughput": throughput}


def quant_lane_entries(torch, ql: dict, qe: dict, ip: dict,
                       card: dict) -> list:
    """The kernels line's entries of the narrow lanes: device ms at the
    main path's shapes (buckets 1024 and 8) against the plain version,
    the bound in the lane's bytes, launches from phase 56."""
    from hyperspace_torch.kernels import scan_topk as S
    from hyperspace_torch.kernels.distmat import pdist, pdist_plain
    from hyperspace_torch.serve.engine import auto_chunk_rows

    spec = ("poincare", C)
    tab = ip["table"]                     # the clustered table, padded
    m = tab.shape[0]
    q, qi = ip["q"], ip["qi"]
    chunk = auto_chunk_rows(ROWS)
    out = []
    for name, kernel, lane, replaces in QLANE_ENTRIES:
        e = {"name": name, "route": "cuda",
             "source": "hyperspace_torch/kernels/csrc/"
                       + ("pdist.cu" if kernel == "pdist" else
                          "scan_topk.cu"),
             "entry": {"pdist": "hs_pdist_bf16",
                       "scan_topk": "hs_scan_topk",
                       "scan_topk_cand": "hs_scan_topk_cand"}[kernel],
             "lane": lane, "replaces": replaces,
             "launches": qe["launches"][name],
             "max_abs_err": ql["err"][name], "library_ms": None}
        if kernel == "pdist":
            y = tab[:chunk].to(torch.bfloat16)
            x = q.to(torch.bfloat16)

            def run(b, x=x, y=y):
                return lambda: pdist(x[:b], y, C, manifold="poincare")

            e.update(shape=[BATCH, chunk, DIM],
                     plain_ms=device_ms(torch, lambda: pdist_plain(
                         x, y, C, manifold="poincare")))
            for b, sfx in ((BATCH, ""), (8, "_bucket8")):
                e["ms" + sfx] = device_ms(torch, run(b))
                nb = 2.0 * (b * DIM + chunk * DIM + b * chunk)
                e["bound_ms" + sfx], e["bound_by" + sfx] = bound_ms(
                    nb, pdist_cost(b, chunk, DIM)[1])
        elif kernel == "scan_topk":
            rows, scale, packed = ql["ctabs"][lane]
            kw = dict(spec=spec, k=K, n=ROWS, exclude_self=True,
                      scale=scale, packed=packed)

            def run(b, rows=rows, kw=kw):
                return lambda: S.scan_topk(rows, q[:b], qi[:b], 0, **kw)

            e.update(shape=[BATCH, rows.shape[0], DIM, K],
                     plain_ms=device_ms(torch, lambda rows=rows,
                                        scale=scale, packed=packed:
                                        S.scan_topk_plain(
                                            rows, q, qi, 0, kind="poincare",
                                            c=C, k=K, n=ROWS,
                                            exclude_self=True, scale=scale,
                                            packed=packed), reps=3))
            for b, sfx in ((BATCH, ""), (8, "_bucket8")):
                e.update({key + sfx: v for key, v in
                          scan_parts(torch, run(b)).items()})
                e["bound_ms" + sfx], e["bound_by" + sfx] = bound_ms(
                    *lane_scan_cost(b, rows.shape[0], ROWS, DIM, K, lane))
        else:
            rows, scale, _ = ql["ctabs"][lane]
            c8 = ip["cands"][8]
            valid = int((c8 >= 0).sum())

            def run(b, rows=rows, scale=scale):
                return lambda: S.scan_topk_cand(
                    rows, c8[:b], q[:b], qi[:b], spec=spec, k=K,
                    exclude_self=True, scale=scale)

            e.update(shape=[BATCH, c8.shape[1], DIM, K],
                     plain_ms=device_ms(torch, lambda rows=rows,
                                        scale=scale:
                                        S.scan_topk_cand_plain(
                                            rows, c8, q, qi, kind="poincare",
                                            c=C, k=K, exclude_self=True,
                                            scale=scale), reps=3))
            for b, sfx in ((BATCH, ""), (8, "_bucket8")):
                e["ms" + sfx] = device_ms(torch, run(b))
                vb = valid if b == BATCH else int((c8[:b] >= 0).sum())
                e["bound_ms" + sfx], e["bound_by" + sfx] = bound_ms(
                    *lane_cand_cost(b, m, DIM, c8.shape[1], vb, K, lane))
        e.update(card)
        out.append(e)
    return out


# --- the Poincaré ball's primitive ops and the gyro-linear layer -----------

# the row-wise ops' path shapes: the WordNet-noun table (BASELINE.json
# configs[0], the RSGD/RAdam update's shape), arxiv nodes at HGCN's
# feature width (configs[1]), the TPU smoke's own (B 256, D 48), and the
# WordNet rows at the HVAE latent's width (configs/hvae_mnist.yaml, d 8)
ROW_SHAPES = {"wordnet": (ROWS, DIM), "arxiv": (169343, 128),
              "smoke": (256, 48), "d8": (ROWS, 8)}
# hyp_linear's: arxiv rows through 128 → 128 and HGCN's hidden 128 → 32,
# and the TPU smoke's 48 → 32
LINEAR_SHAPES = {"arxiv_128": (169343, 128, 128),
                 "arxiv_32": (169343, 128, 32), "smoke": (256, 48, 32)}
ROW_OPS = ("mobius_add", "mobius_scalar_mul", "expmap", "logmap", "expmap0",
           "logmap0", "ptransp")
ROW_ENTRY = {"mobius_add": "hs_mobius_add",
             "mobius_scalar_mul": "hs_mobius_scalar_mul",
             "expmap": "hs_expmap", "logmap": "hs_logmap",
             "expmap0": "hs_expmap0", "logmap0": "hs_logmap0",
             "ptransp": "hs_ptransp"}
# how many [n, d] tensors each op reads (the output adds one write)
ROW_TENSORS = {"mobius_add": 2, "mobius_scalar_mul": 1, "expmap": 2,
               "logmap": 2, "expmap0": 1, "logmap0": 1, "ptransp": 3}
# float32 operations an element: the dot products (2 each) and the
# combinations of each sweep (the transcendentals are per row)
ROW_FLOPS = {"mobius_add": 10, "mobius_scalar_mul": 4, "expmap": 20,
             "logmap": 18, "expmap0": 8, "logmap0": 3, "ptransp": 16}
# kernel against plain version (f32): the JAX package's tier for these
# kernels (tests/kernels/test_pointwise.py:25, test_hyplinear.py:29)
ROW_RTOL, ROW_ATOL, LIN_ATOL = 2e-4, 2e-5, 2e-4
GYRO_STEPS = 10
GYRO_CARD_CPU_ROWS = 20_000
GYRO_CARD_CPU_RTOL = 1e-4          # all f32: loss and gradients


def row_cost(op: str, n: int, d: int) -> tuple[float, float]:
    """(bytes, operations) of a row-wise op on [n, d] float32 rows: each
    input read once, the output written once."""
    return (4.0 * n * d * (ROW_TENSORS[op] + 1),
            float(ROW_FLOPS[op]) * n * d)


def linear_cost(n: int, d_in: int,
                d_out: int) -> tuple[float, float, float]:
    """(bytes, f32 operations, TF32 operations) of hyp_linear on f32 x:
    x, M and b read once, the output written once; ‖x‖² and about 8
    operations an output for the rescale, ⊕ b and proj in f32, and the
    product's 2·n·d_in·d_out as a 3×TF32 product on the tensor cores."""
    return (4.0 * (n * d_in + d_in * d_out + d_out + n * d_out),
            2.0 * n * d_in + 8.0 * n * d_out,
            TF32_PASSES * 2.0 * n * d_in * d_out)


def gyro_counts() -> dict:
    from hyperspace_torch import kernels as K

    return {op: getattr(K, op).launches for op in ROW_OPS + ("hyp_linear",)}


def gyro_reset() -> None:
    from hyperspace_torch import kernels as K

    for op in ROW_OPS + ("hyp_linear",):
        getattr(K, op).launches = 0


def ball_tensor(torch, gen, shape, c, dev, radius=0.5):
    """Ball points from the seed: expmap0 (the port's plain method) of an
    origin tangent of norm about ``radius``/√c."""
    from hyperspace_torch.manifolds import PoincareBall

    v = torch.randn(shape, generator=gen, device=dev) * (
        radius / np.sqrt(shape[-1] * c))
    return PoincareBall(c).expmap0(v).contiguous()


def row_inputs(torch, gen, op, shape, c, dev):
    x = ball_tensor(torch, gen, shape, c, dev, 0.8)
    y = ball_tensor(torch, gen, shape, c, dev, 0.5)
    v = torch.randn(shape, generator=gen, device=dev) * (0.6 / np.sqrt(
        shape[-1]))
    return {"mobius_add": (x, y), "mobius_scalar_mul": (x,),
            "expmap": (x, v), "logmap": (x, y), "expmap0": (v,),
            "logmap0": (y,), "ptransp": (x, y, v)}[op]


def row_call(op, tensors, c, r=0.7, plain=False):
    from hyperspace_torch.kernels import pointwise as PW

    fn = getattr(PW, op + "_plain" if plain else op)
    return fn(r, *tensors, c) if op == "mobius_scalar_mul" else fn(*tensors,
                                                                   c)


def check_gyro(torch, kernel, label, got, again, want, rtol, atol) -> float:
    """Hold a kernel's output against its plain version's: f32 within
    ``atol + rtol·|want|``; a bf16 output within one bf16 ulp of the f32
    plain result on the same inputs plus that (the output rounds once, a
    flip moves it one ulp).  The repeat must give the same bits."""
    if got.shape != want.shape:
        raise AssertionError(f"{kernel} {label}: {got.shape} vs "
                             f"{want.shape}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = atol + rtol * w.abs()
    if got.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(torch, w)
    over = int((diff > tol).sum()) + int(not bool(torch.isfinite(g).all()))
    same = bool(torch.equal(got, again))
    worst = float(diff.max()) if diff.numel() else 0.0
    emit({"phase": "check", "kernel": kernel, "case": label,
          "shape": list(got.shape), "dtype": str(got.dtype),
          "max_abs_err": worst, "over_tolerance": over, "repeat_equal": same})
    if over or not same:
        raise AssertionError(f"{kernel} {label}: {over} entries beyond "
                             f"tolerance, repeat equal {same}")
    return worst


def check_grads(torch, kernel, label, got, want) -> float:
    """Gradients through a Function against autograd of its plain version
    (the backward recomputes the plain version: the same arithmetic, so
    within rtol 1e-6 of the largest entry)."""
    worst = 0.0
    for a, b in zip(got, want):
        if b is None:
            continue
        d = float((a - b).abs().max())
        worst = max(worst, d)
        if not d <= 1e-6 * float(b.abs().max()) + 1e-12:
            raise AssertionError(f"{kernel} {label}: gradient off by {d}")
    emit({"phase": "check", "kernel": kernel, "case": label,
          "grad_max_abs_diff": worst})
    return worst


def gyro_stack(torch, gen, d_in, width, out, dev):
    """The slice's layer stack: HypLinear(width) on the ball c = 1 →
    HypAct(ball c = 1 → ball c = 0.5, relu) → HypLinear(out) on c = 0.5;
    glorot kernels and small origin-tangent biases from ``gen``."""
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.nn import HypAct, HypLinear

    b1, b2 = PoincareBall(1.0), PoincareBall(0.5)
    stack = torch.nn.Sequential(HypLinear(d_in, width, b1, generator=gen),
                                HypAct(b1, b2, torch.relu),
                                HypLinear(width, out, b2, generator=gen))
    with torch.no_grad():
        for layer in (stack[0], stack[2]):
            layer.bias.copy_(torch.randn(layer.bias.shape, generator=gen)
                             * 0.05)
    return stack.to(dev)


def gyro_path(torch, args, card: dict) -> dict:
    """Phases 20–22; returns what the kernels line needs."""
    from hyperspace_torch import kernels as K
    from hyperspace_torch.kernels.hyplinear import hyp_linear_plain
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.optim.adamw import AdamW

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 20)
    err = {op: 0.0 for op in ROW_OPS + ("hyp_linear",)}

    # --- phase 20: the kernels against their plain versions -------------
    t0 = time.perf_counter()
    cases = [(f"{name} c={c}", shape, c) for name, shape in
             ROW_SHAPES.items() for c in (1.0, 0.5, 2.3)]
    cases += [(f"d={d}", (1000, d), 1.0) for d in (7, 130, 200)]
    cases += [("lead [3, 8, 48]", (3, 8, 48), 0.7)]
    for op in ROW_OPS:
        for label, shape, c in cases:
            ts = row_inputs(torch, gen, op, shape, c, dev)
            got, again = row_call(op, ts, c), row_call(op, ts, c)
            err[op] = max(err[op], check_gyro(
                torch, op, label, got, again, row_call(op, ts, c, plain=True),
                ROW_RTOL, ROW_ATOL))
        for name in ("arxiv", "wordnet"):       # the G-lane and packed paths
            ts = [t.to(torch.bfloat16) for t in row_inputs(
                torch, gen, op, ROW_SHAPES[name], 1.0, dev)]
            check_gyro(torch, op, f"bf16 {name}", row_call(op, ts, 1.0),
                       row_call(op, ts, 1.0),
                       row_call(op, [t.float() for t in ts], 1.0, plain=True),
                       ROW_RTOL, ROW_ATOL)
        # gradients to every tensor and to device tensors c and r
        ts = [t.requires_grad_() for t in row_inputs(
            torch, gen, op, ROW_SHAPES["smoke"], 0.8, dev)]
        cc = torch.tensor(0.8, device=dev, requires_grad=True)
        rr = torch.tensor(1.3, device=dev, requires_grad=True)
        w = torch.randn(ROW_SHAPES["smoke"], generator=gen, device=dev)
        wrt = ts + [cc, rr]
        check_grads(torch, op, "grads c=tensor", torch.autograd.grad(
            (row_call(op, ts, cc, rr) * w).sum(), wrt, allow_unused=True),
            torch.autograd.grad((row_call(op, ts, cc, rr, plain=True)
                                 * w).sum(), wrt, allow_unused=True))
    x = ball_tensor(torch, gen, ROW_SHAPES["arxiv"], 1.0, dev, 0.8)
    for r in (-1.5, 0.0, 0.5, 3.0):
        err["mobius_scalar_mul"] = max(err["mobius_scalar_mul"], check_gyro(
            torch, "mobius_scalar_mul", f"r={r}",
            row_call("mobius_scalar_mul", (x,), 1.0, r),
            row_call("mobius_scalar_mul", (x,), 1.0, r),
            row_call("mobius_scalar_mul", (x,), 1.0, r, plain=True),
            ROW_RTOL, ROW_ATOL))
    # the proj margin (tangents of norm about 40), zero rows, a bias [d]
    # broadcast against [n, d]
    big = torch.randn(ROW_SHAPES["arxiv"], generator=gen, device=dev) * (
        40.0 / np.sqrt(128))
    xz = x.clone()
    xz[::7] = 0.0
    big[::11] = 0.0
    bias = ball_tensor(torch, gen, (128,), 1.0, dev, 0.3)
    for op, ts, label in (("expmap", (xz, big), "margin, zero rows"),
                          ("expmap0", (big,), "margin, zero rows"),
                          ("logmap0", (xz,), "zero rows"),
                          ("logmap", (xz, xz), "x = y, zero rows"),
                          ("ptransp", (xz, x, big), "zero rows"),
                          ("mobius_add", (xz, bias), "bias [d], zero rows"),
                          ("mobius_add", (bias, xz), "[d] first"),
                          ("expmap", (xz, bias), "tangent [d]")):
        err[op] = max(err[op], check_gyro(
            torch, op, label, row_call(op, ts, 1.3), row_call(op, ts, 1.3),
            row_call(op, ts, 1.3, plain=True), ROW_RTOL, ROW_ATOL))
    lin_cases = [(f"{name} c={c}", shp, c) for name, shp in
                 LINEAR_SHAPES.items() for c in (1.0, 0.5, 2.3)]
    lin_cases += [("7→130", (1000, 7, 130), 1.0),
                  ("130→200", (1000, 130, 200), 1.0),
                  ("200→7", (1000, 200, 7), 1.0),
                  ("tiles 1000→700", (2000, 1000, 700), 1.0)]
    for label, (n, di, do), c in lin_cases:
        xl = ball_tensor(torch, gen, (n, di), c, dev, 0.8)
        xl[::5] = 0.0                                   # M x = 0 rows
        m = torch.randn((di, do), generator=gen, device=dev) / np.sqrt(di)
        b = ball_tensor(torch, gen, (do,), c, dev, 0.3)
        for bl, bb in (("", b), (" b=0", torch.zeros_like(b))):
            err["hyp_linear"] = max(err["hyp_linear"], check_gyro(
                torch, "hyp_linear", label + bl, K.hyp_linear(xl, m, bb, c),
                K.hyp_linear(xl, m, bb, c), hyp_linear_plain(xl, m, bb, c),
                ROW_RTOL, LIN_ATOL))
    n, di, do = LINEAR_SHAPES["arxiv_128"]
    xl = ball_tensor(torch, gen, (n, di), 1.0, dev, 0.8)
    m = torch.randn((di, do), generator=gen, device=dev) / np.sqrt(di)
    b = ball_tensor(torch, gen, (do,), 1.0, dev, 0.3)
    xb = xl.to(torch.bfloat16)
    check_gyro(torch, "hyp_linear", "bf16 arxiv_128",
               K.hyp_linear(xb, m, b, 1.0), K.hyp_linear(xb, m, b, 1.0),
               hyp_linear_plain(xb.float(), m, b, 1.0), ROW_RTOL, LIN_ATOL)
    for label, mm in (("margin (30·M)", 30.0 * m),
                      ("Mx = 0 everywhere", torch.zeros_like(m))):
        check_gyro(torch, "hyp_linear", label, K.hyp_linear(xl, mm, b, 1.0),
                   K.hyp_linear(xl, mm, b, 1.0),
                   hyp_linear_plain(xl, mm, b, 1.0), ROW_RTOL, LIN_ATOL)
    x3 = xl[:24].reshape(3, 8, di)
    check_gyro(torch, "hyp_linear", "lead [3, 8, 128]",
               K.hyp_linear(x3, m, b, 1.0), K.hyp_linear(x3, m, b, 1.0),
               hyp_linear_plain(x3, m, b, 1.0), ROW_RTOL, LIN_ATOL)
    ins = [xl[:256].clone().requires_grad_(), m.clone().requires_grad_(),
           b.clone().requires_grad_()]
    cc = torch.tensor(0.9, device=dev, requires_grad=True)
    w = torch.randn((256, do), generator=gen, device=dev)
    check_grads(torch, "hyp_linear", "grads c=tensor", torch.autograd.grad(
        (K.hyp_linear(*ins, cc) * w).sum(), ins + [cc]),
        torch.autograd.grad((hyp_linear_plain(*ins, cc) * w).sum(),
                            ins + [cc]))
    emit({"phase": "gyro_checks", "seconds": time.perf_counter() - t0,
          **card})

    # --- phase 21: the op path: a Riemannian update through the public
    # ops at each path shape ----------------------------------------------
    t0 = time.perf_counter()
    inputs = {}
    for name, shape in ROW_SHAPES.items():
        inputs[name] = {
            "x": ball_tensor(torch, gen, shape, 1.0, dev, 0.8),
            "y": ball_tensor(torch, gen, shape, 1.0, dev, 0.5),
            "g": torch.randn(shape, generator=gen, device=dev) * (
                0.3 / np.sqrt(shape[-1]))}
    gyro_reset()
    outs = {}
    for name, z in inputs.items():
        x, y, g = z["x"], z["y"], z["g"]
        u = K.logmap(x, y, 1.0)                 # the direction to y
        x1 = K.expmap(x, 0.5 * u + g, 1.0)      # a step
        m1 = K.ptransp(x, x1, g, 1.0)           # a moment carried along
        h = K.mobius_scalar_mul(0.5, K.expmap0(m1, 1.0), 1.0)
        x2 = K.mobius_add(x1, h, 1.0)
        outs[name] = (x1, m1, x2, K.logmap0(x2, 1.0))
    torch.cuda.synchronize()
    counts = gyro_counts()
    emit({"phase": "gyro_op_path", "shapes": ROW_SHAPES, "launches": counts,
          "seconds": time.perf_counter() - t0, **card})
    for op in ROW_OPS:
        if counts[op] != len(ROW_SHAPES):
            raise AssertionError(f"op path: {op} launched {counts[op]} "
                                 f"times, want {len(ROW_SHAPES)}")
    if counts["hyp_linear"]:
        raise AssertionError("op path: hyp_linear launched")
    ball = PoincareBall(1.0)
    for name, (x1, m1, x2, v2) in outs.items():
        z = inputs[name]
        for t in (x1, m1, x2, v2):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"op path {name}: non-finite values")
        for t in (x1, x2):
            if not float(torch.linalg.norm(t, dim=-1).max()) < 1.0:
                raise AssertionError(f"op path {name}: a point left the "
                                     "ball")
        # the same chain by the plain versions on the CPU, first 2,000 rows
        xs, ys, gs = (z[k][:2000].cpu() for k in ("x", "y", "g"))
        u = ball.logmap(xs, ys)
        p1 = ball.expmap(xs, 0.5 * u + gs)
        q1 = ball.ptransp(xs, p1, gs)
        p2 = ball.mobius_add(p1, ball.mobius_scalar_mul(0.5,
                                                        ball.expmap0(q1)))
        gap = max(float((a[:2000].cpu() - b).abs().max()) for a, b in
                  ((x1, p1), (m1, q1), (x2, p2), (v2, ball.logmap0(p2))))
        emit({"phase": "gyro_op_path_vs_cpu", "shape": list(x1.shape),
              "rows": 2000, "max_abs_diff": gap})
        if not gap <= 1e-4:
            raise AssertionError(f"op path {name}: card and CPU differ by "
                                 f"{gap}")
    row_launches = {op: counts[op] for op in ROW_OPS}

    # --- phase 22: the layer path at arxiv width -------------------------
    t0 = time.perf_counter()
    n, di, _ = LINEAR_SHAPES["arxiv_128"]
    xs = ball_tensor(torch, gen, (n, di), 1.0, dev, 0.8)
    tgt = ball_tensor(torch, gen, (n, 32), 0.5, dev, 0.5)
    stack = gyro_stack(torch, torch.Generator().manual_seed(args.seed),
                       di, 128, 32, dev)
    init = {k: v.detach().clone() for k, v in stack.state_dict().items()}
    b2 = PoincareBall(0.5)

    def loss_of(model, x, t):
        return torch.mean(b2.sqdist(model(x), t))

    # card against the CPU from the same parameters, 20,000 rows
    rows = GYRO_CARD_CPU_ROWS
    res = {}
    for where in ("cuda", "cpu"):
        model = gyro_stack(torch, torch.Generator().manual_seed(0), di, 128,
                           32, where)
        model.load_state_dict({k: v.to(where) for k, v in init.items()})
        loss = loss_of(model, xs[:rows].to(where), tgt[:rows].to(where))
        loss.backward()
        res[where] = (float(loss.detach()), {
            k: p.grad.detach().cpu() for k, p in model.named_parameters()})
    rel_loss = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    rel_grad = max(float((res["cuda"][1][k] - g).abs().max())
                   / float(g.abs().max()) for k, g in res["cpu"][1].items())
    emit({"phase": "gyro_card_vs_cpu", "rows": rows,
          "loss_cuda": res["cuda"][0], "loss_cpu": res["cpu"][0],
          "rel_loss_diff": rel_loss, "max_rel_grad_diff": rel_grad})
    if not (rel_loss <= GYRO_CARD_CPU_RTOL
            and rel_grad <= GYRO_CARD_CPU_RTOL):
        raise AssertionError(f"layer path: card and CPU differ (loss "
                             f"{rel_loss}, gradients {rel_grad})")

    opt = AdamW(dict(stack.named_parameters()), lr=1e-2, weight_decay=1e-4)

    def step():
        for p in stack.parameters():
            p.grad = None
        loss = loss_of(stack, xs, tgt)
        loss.backward()
        opt.step()
        return loss.detach()

    gyro_reset()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step())]                   # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    timed = [step() for _ in range(GYRO_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1e3 / GYRO_STEPS
    losses += [float(v) for v in timed]
    counts = gyro_counts()
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "gyro_layers", "rows": n, "stack": "HypLinear(128) → "
          "HypAct(c 1 → 0.5, relu) → HypLinear(32)", "steps": GYRO_STEPS,
          "warmup": 1, "losses": losses, "step_ms": step_ms,
          "rows_per_s": n / step_ms * 1e3, "launches": counts,
          "peak_device_memory_bytes": peak,
          "seconds": time.perf_counter() - t0, **card})
    if counts["hyp_linear"] != 2 * (GYRO_STEPS + 1):
        raise AssertionError(f"layer path: hyp_linear launched "
                             f"{counts['hyp_linear']} times in "
                             f"{GYRO_STEPS + 1} forwards, want 2 each")
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"layer path: the loss did not fall: {losses}")
    share = device_share(torch, step, step_ms, reps=3, top_n=8)
    emit({"phase": "gyro_layers_profile", "step_ms": step_ms, **share,
          **card})
    return {"err": err, "row_launches": row_launches,
            "lin_launches": counts["hyp_linear"]}


def side_ms(torch, e: dict, key: str, fn) -> None:
    """``e[key]``: the device time of ``fn`` at a path's other shape, or
    None where the profiler recorded nothing; then ``e["call_" + key]``
    holds the time on the card's clock (CUDA events, launch gaps
    included) instead."""
    items = device_items(torch, fn, 20)
    e[key] = sum(items.values()) if items else None
    if not items:
        e["call_" + key] = timed_ms(torch, fn)


def gyro_kernel_entries(torch, gp: dict, card: dict) -> list:
    """The eight launchers' entries of the kernels line: device times at
    each path shape (the arxiv shape first), the plain version's at the
    arxiv shape."""
    from hyperspace_torch import kernels as K
    from hyperspace_torch.kernels.hyplinear import hyp_linear_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    entries = []
    for op in ROW_OPS:
        runs = {}
        for name, shape in ROW_SHAPES.items():
            ts = row_inputs(torch, gen, op, shape, 1.0, dev)
            runs[name] = ((lambda ts=ts: row_call(op, ts, 1.0)),
                          (lambda ts=ts: row_call(op, ts, 1.0, plain=True)))
        n, d = ROW_SHAPES["arxiv"]
        bd, bby = bound_ms(*row_cost(op, n, d))
        e = {"name": op, "route": "cuda",
             "source": "hyperspace_torch/kernels/csrc/pointwise.cu",
             "entry": ROW_ENTRY[op],
             "replaces": "hyperspace_tpu/kernels/pointwise.py:50",
             "launches": gp["row_launches"][op], "launches_per_shape": 1,
             "max_abs_err": gp["err"][op], "shape": [n, d],
             "ms": device_ms(torch, runs["arxiv"][0]),
             "plain_ms": device_ms(torch, runs["arxiv"][1], reps=5),
             "bound_ms": bd, "bound_by": bby, "library_ms": None,
             "call_ms": timed_ms(torch, runs["arxiv"][0])}
        for name in ("wordnet", "smoke", "d8"):
            side_ms(torch, e, f"ms_{name}", runs[name][0])
            e[f"bound_ms_{name}"] = bound_ms(*row_cost(op,
                                                       *ROW_SHAPES[name]))[0]
            e[f"shape_{name}"] = list(ROW_SHAPES[name])
        entries.append({**e, **card})
    runs = {}
    for name, (n, di, do) in LINEAR_SHAPES.items():
        x = ball_tensor(torch, gen, (n, di), 1.0, dev, 0.8)
        m = torch.randn((di, do), generator=gen, device=dev) / np.sqrt(di)
        b = ball_tensor(torch, gen, (do,), 1.0, dev, 0.3)
        runs[name] = ((lambda a=(x, m, b): K.hyp_linear(*a, 1.0)),
                      (lambda a=(x, m, b): hyp_linear_plain(*a, 1.0)),
                      (lambda a=(x, m): torch.matmul(*a)))
    bd, bby = bound_ms(*linear_cost(*LINEAR_SHAPES["arxiv_128"]))
    # the product alone (torch.matmul of x and M in f32; main() keeps TF32
    # off) is a reference, not the same function: no library call computes
    # the layer
    e = {"name": "hyp_linear", "route": "cuda",
         "source": "hyperspace_torch/kernels/csrc/hyplinear.cu",
         "entry": "hs_hyp_linear",
         "replaces": "hyperspace_tpu/kernels/hyplinear.py:69",
         "launches": gp["lin_launches"], "launches_per_step": 2,
         "max_abs_err": gp["err"]["hyp_linear"],
         "shape": list(LINEAR_SHAPES["arxiv_128"]),
         "ms": device_ms(torch, runs["arxiv_128"][0]),
         "plain_ms": device_ms(torch, runs["arxiv_128"][1], reps=5),
         "bound_ms": bd, "bound_by": bby, "library_ms": None,
         "bytes_bound_ms": linear_cost(*LINEAR_SHAPES["arxiv_128"])[0]
         / HBM_BYTES_PER_S * 1e3,
         "product_alone_ms": device_ms(torch, runs["arxiv_128"][2]),
         "product_alone": "torch.matmul(x, M) in f32: the product alone, "
                          "not the same function",
         "product_alone_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
         "call_ms": timed_ms(torch, runs["arxiv_128"][0])}
    for name in ("arxiv_32", "smoke"):
        side_ms(torch, e, f"ms_{name}", runs[name][0])
        side_ms(torch, e, f"plain_ms_{name}", runs[name][1])
        side_ms(torch, e, f"product_alone_ms_{name}", runs[name][2])
        cost = linear_cost(*LINEAR_SHAPES[name])
        e[f"bound_ms_{name}"] = bound_ms(*cost)[0]
        e[f"bytes_bound_ms_{name}"] = cost[0] / HBM_BYTES_PER_S * 1e3
        e[f"shape_{name}"] = list(LINEAR_SHAPES[name])
    entries.append({**e, **card})
    return entries


# --- phases 24-29: Poincaré embeddings with RSGD and RAdam ------------------

PE_DEPTH, PE_BRANCH = 5, 9            # bench.py's WordNet-noun stand-in
PE_ROWS, PE_PAIRS = 66_430, 323_847
PE_BIG_ROWS = 597_871                 # the large table, depth 6
PE_BATCH, PE_NEG, PE_POOL = 1024, 10, 64
PE_SLOTS = PE_BATCH * (2 + PE_NEG)    # 12,288 flat slots of a planned step
PE_EVAL_CHUNKS = -(-PE_PAIRS // 1024)  # 317 pdist launches an evaluation
PE_CLI_YAML = "configs/poincare_wordnet.yaml"
PE_CARD_CPU_RTOL = 1e-4
PE_PROFILE_STEPS = 20
PE_BENCH_REPEATS = 1                  # timed epochs a strategy (the clock)
# kernels launched a step by each strategy (all others 0, pdist included)
PE_PER_STEP = {"dense": ("expmap",), "sparse": ("expmap",),
               "planned": ("expmap", "csr_segment_sum"),
               "dense_scan": ("expmap",),
               "planned_scan": ("expmap", "csr_segment_sum"),
               "mined": ("expmap", "scan_topk"),
               "mined_scan": ("expmap", "scan_topk")}


def pe_counts() -> dict:
    from hyperspace_torch.models import poincare_embed as pe

    return {f.__name__: f.launches for f in pe.path_counters()}


def pe_reset() -> None:
    from hyperspace_torch.models import poincare_embed as pe

    for f in pe.path_counters():
        f.launches = 0


def pe_clone(torch, state):
    """A copy of a trainer state: tensors cloned, the generator a new one
    at the same position."""
    import torch.utils._pytree as pytree

    def one(x):
        if isinstance(x, torch.Generator):
            g = torch.Generator(device=x.device)
            g.set_state(x.get_state())
            return g
        return x.clone() if isinstance(x, torch.Tensor) else x

    return pytree.tree_map(one, state)


def pe_start(torch, pe, cfg, rng, device, radam: bool):
    """A JAX-``TrainState``-shaped start from numpy (table spread over the
    ball, Adam moments mid-run), read by ``state_from_jax``."""
    import collections

    n, d = cfg.num_nodes, cfg.dim
    v = rng.standard_normal((n, d))
    table = (v / np.linalg.norm(v, axis=1, keepdims=True)
             * rng.uniform(0.05, 0.6, (n, 1))).astype(np.float32)
    if radam:
        Opt = collections.namedtuple("RAdamState", "count mu nu")
        opt = Opt(np.int32(7), (rng.standard_normal((n, d)) * 1e-3).astype(
            np.float32), (rng.uniform(0, 1e-4, (n, 1))).astype(np.float32))
    else:
        opt = collections.namedtuple("RSGDState", "count")(np.int32(7))
    js = collections.namedtuple("TrainState", "table opt_state key step")(
        table, opt, None, np.int32(7))
    return pe.state_from_jax(cfg, js, device=device)


def pe_card_vs_cpu(torch, args) -> dict:
    """Phase 24: five explicit-batch steps of every path, both
    optimizers, on the card and on the CPU from one start."""
    from hyperspace_torch.data.wordnet import synthetic_tree
    from hyperspace_torch.models import poincare_embed as pe

    ds = synthetic_tree(3, 3)
    out = {}
    for optimizer in ("rsgd", "radam"):
        for path in ("dense", "mined", "sparse", "planned", "packed"):
            cfg = pe.PoincareEmbedConfig(
                num_nodes=ds.num_nodes, dim=5, batch_size=48, neg_samples=6,
                burnin_steps=3, optimizer=optimizer,
                neg_mode="mined" if path == "mined" else "uniform")
            rng = np.random.default_rng(args.seed + 24)
            u = ds.pairs[rng.integers(0, ds.num_pairs, (5, 48))]
            neg = rng.integers(0, ds.num_nodes, (5, 48, 6))
            pools = rng.integers(0, ds.num_nodes, (5, pe.mine_pool_size(cfg)))
            tables = {}
            for where in ("cuda", "cpu"):
                st = pe_start(torch, pe, cfg, np.random.default_rng(
                    args.seed), where, optimizer == "radam")
                opt = pe.make_optimizer(cfg)
                plan = pe.plan_from_indices(cfg, u[..., 0], u[..., 1], neg,
                                            device=where)
                if path == "packed":
                    st = pe.pack_state(cfg, st)
                for i in range(5):
                    ids = [torch.as_tensor(a, device=where) for a in (
                        u[i, :, 0], u[i, :, 1], neg[i])]
                    if path == "dense":
                        st, _ = pe.step_on_batch(cfg, opt, st, *ids)
                    elif path == "mined":
                        st, _ = pe.step_on_batch(
                            cfg, opt, st, ids[0], ids[1], pool_idx=torch.
                            as_tensor(pools[i], device=where))
                    elif path == "sparse":
                        st, _ = pe.sparse_step_on_batch(cfg, opt, st, *ids)
                    elif path == "planned":
                        st, _ = pe.train_step_sparse_planned(cfg, opt, st,
                                                             plan)
                    else:
                        st, _ = pe.train_step_planned_packed(cfg, opt, st,
                                                             plan)
                tables[where] = (st.packed if path == "packed"
                                 else st.table).cpu().double()
            ref = tables["cpu"]
            rel = float((tables["cuda"] - ref).abs().max()
                        / ref.abs().max())
            out[f"{optimizer}_{path}"] = rel
            if not rel <= PE_CARD_CPU_RTOL:
                raise AssertionError(f"poincare {optimizer} {path}: card and "
                                     f"CPU tables differ by rel {rel}")
    return out


def pe_kernel_checks(torch, args, plan_row) -> dict:
    """Phase 25: the four kernels at this path's shapes against their
    plain versions on the card, each launched twice for the same bits."""
    from hyperspace_torch.kernels.distmat import pdist, pdist_plain
    from hyperspace_torch.kernels.scan_topk import scan_topk, scan_topk_plain
    from hyperspace_torch.kernels import _support

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 25)
    rng = np.random.default_rng(args.seed + 25)
    err = {}
    table = ball_tensor(torch, gen, (PE_ROWS, DIM), C, dev, 0.8)
    u = torch.as_tensor(rng.integers(0, PE_ROWS, PE_BATCH), device=dev)
    q = table[u].contiguous()
    got = pdist(q, table, C, manifold="poincare")
    again = pdist(q, table, C, manifold="poincare")
    want = pdist_plain(q, table, C, manifold="poincare")
    # the queries are table rows, as in evaluate: at d(u, u) = 0 the Gram
    # form's rounding noise differs between the two (evaluate never ranks
    # that column), so it is held apart, within 1e-2
    diff = (got - want).abs()
    self_err = float(diff[torch.arange(PE_BATCH, device=dev), u].max())
    diff[torch.arange(PE_BATCH, device=dev), u] = 0.0
    err["pdist"] = float(diff.max())
    over = int((diff > ATOL + RTOL * want.abs()).sum())
    same = bool(torch.equal(got, again))
    emit({"phase": "check", "kernel": "pdist", "case": "pe_eval",
          "shape": [PE_BATCH, PE_ROWS, DIM], "max_abs_err": err["pdist"],
          "self_column_max_abs_err": self_err, "over_tolerance": over,
          "repeat_equal": same})
    if over or not same or not self_err <= 1e-2:
        raise AssertionError(f"pdist pe_eval: {over} over, repeat {same}")
    # a mining pool drawn with replacement, with forced duplicates: their
    # rows tie exactly, and the lower pool slot must come first
    pool_ids = rng.integers(0, PE_ROWS, PE_POOL)
    pool_ids[40:48] = pool_ids[0:8]
    pool = table[torch.as_tensor(pool_ids, device=dev)].contiguous()
    qi = torch.zeros(PE_BATCH, dtype=torch.int32, device=dev)
    d1, i1 = scan_topk(pool, q, qi, 0, spec=("poincare", C), k=PE_NEG,
                       n=PE_POOL, exclude_self=False)
    d1b, i1b = scan_topk(pool, q, qi, 0, spec=("poincare", C), k=PE_NEG,
                         n=PE_POOL, exclude_self=False)
    d2, i2 = scan_topk_plain(pool, q, qi, 0, kind="poincare", c=C, k=PE_NEG,
                             n=PE_POOL, exclude_self=False)
    bad = _support.topk_disagreements(
        i1.cpu().numpy(), d1.cpu().numpy(), i2.cpu().numpy(),
        d2.cpu().numpy(), rtol=RTOL, atol=ATOL)
    ids = i1.cpu().numpy()
    tie_order_bad = 0
    for a in range(8):                 # slot a and slot 40 + a are one row
        for row in ids:
            pa, pb = np.flatnonzero(row == a), np.flatnonzero(row == 40 + a)
            if len(pb) and (not len(pa) or pa[0] > pb[0]):
                tie_order_bad += 1
    same = bool(torch.equal(d1, d1b) and torch.equal(i1, i1b))
    err["scan_topk"] = float((d1 - d2).abs().max())
    emit({"phase": "check", "kernel": "scan_topk", "case": "pe_mine",
          "shape": [PE_BATCH, PE_POOL, DIM, PE_NEG],
          "max_abs_err": err["scan_topk"], "rows_disagreeing": bad,
          "tie_order_wrong": tie_order_bad, "repeat_equal": same})
    if bad or tie_order_bad or not same:
        raise AssertionError(f"scan_topk pe_mine: {bad} rows disagree, "
                             f"{tie_order_bad} ties out of order, repeat "
                             f"{same}")
    for op, shapes in (("expmap", ((PE_ROWS, DIM), (PE_SLOTS, DIM))),
                       ("ptransp", ((PE_BIG_ROWS, DIM), (PE_SLOTS, DIM)))):
        for shape in shapes:
            ts = row_inputs(torch, gen, op, shape, C, dev)
            got, again = row_call(op, ts, C), row_call(op, ts, C)
            want = row_call(op, ts, C, plain=True)
            err[op] = max(err.get(op, 0.0), check_gyro(
                torch, op, f"pe_{shape[0]}", got, again, want, 2e-4, 2e-5))
    err["csr_segment_sum"] = check_segsum(
        torch, gen, "pe_planned", plan_row.seg_sorted, PE_SLOTS, DIM,
        torch.float32)
    return err, table


def pe_epochs(torch, pe, run, pairs, epochs: int = 2):
    """``epochs`` epochs of a bench runner: the counts set to 0 before
    the last epoch and read after it (the first captures a graph, where
    the strategy has one); returns (losses of all epochs, counts)."""
    losses = []
    for e in range(epochs):
        if e == epochs - 1:
            torch.cuda.synchronize()
            pe_reset()
        losses.append(run.epoch())
    torch.cuda.synchronize()
    return torch.cat(losses).cpu().numpy(), pe_counts()


def pe_bitwise(torch, pe, name, cfg, pairs, plan, steps, seed):
    """A graphed epoch against the same steps run eagerly from the same
    state and generator: tables and losses bitwise equal."""
    from hyperspace_torch.benchmarks import poincare_bench as PB

    run = PB.make_runner(name, cfg, pairs, plan, steps, seed)
    eager = pe_clone(torch, run.state)
    graphed = run.epoch()
    cfg_r = run.cfg
    losses = []
    for _ in range(steps):
        if name == "planned_scan":
            eager, loss = pe.train_step_planned_packed(cfg_r, run.opt, eager,
                                                       plan)
        else:
            eager, loss = pe.train_step(cfg_r, run.opt, eager, pairs)
        losses.append(loss)
    a = run.state[0]
    same_t = bool(torch.equal(a, eager[0]))
    same_l = bool(torch.equal(graphed, torch.stack(losses)))
    return {"table_bitwise": same_t, "losses_bitwise": same_l,
            "max_abs_diff": float((a - eager[0]).abs().max())}


def poincare_path(torch, args, card: dict) -> dict:
    """Phases 24-29; returns what the kernels line needs."""
    import contextlib
    import dataclasses

    from hyperspace_torch.benchmarks import poincare_bench as PB
    from hyperspace_torch.cli import train as cli_train
    from hyperspace_torch.data.wordnet import synthetic_tree
    from hyperspace_torch.kernels.distmat import pdist_plain
    from hyperspace_torch.models import poincare_embed as pe

    dev = torch.device("cuda")
    # --- phase 24: card against CPU ---------------------------------------
    t0 = time.perf_counter()
    rel = pe_card_vs_cpu(torch, args)
    emit({"phase": "pe_card_vs_cpu", "max_rel_table_diff": rel,
          "rtol": PE_CARD_CPU_RTOL, "seconds": time.perf_counter() - t0})

    # --- phase 25: the kernels at this path's shapes ----------------------
    t0 = time.perf_counter()
    ds = synthetic_tree(PE_DEPTH, PE_BRANCH)
    assert (ds.num_nodes, ds.num_pairs) == (PE_ROWS, PE_PAIRS)
    cfg = PB.bench_config(ds.num_nodes)
    steps = ds.num_pairs // cfg.batch_size
    pairs = torch.as_tensor(ds.pairs, dtype=torch.int64, device=dev)
    plan = pe.plan_sparse_steps(cfg, ds.pairs, steps, seed=args.seed,
                                device=dev)
    row0 = pe._plan_row(plan, torch.zeros((), dtype=torch.int64,
                                          device=dev))
    err, table = pe_kernel_checks(torch, args, row0)
    times = pe_kernel_times(torch, table, row0)
    emit({"phase": "pe_checks", "max_abs_err": err,
          "seconds": time.perf_counter() - t0})

    # --- phase 26: every strategy, both optimizers -------------------------
    # one epoch of each stepwise strategy, two of each graphed one (the
    # first captures the graph), the counts read over the last.  RAdam's
    # loss falls within the first
    # epoch at this scale; RSGD's (lr 0.3 on a mean loss, 66,430 rows)
    # rises through burn-in and then falls by ~4e-4 an epoch, so its fall
    # is held over twelve graphed dense epochs
    t0 = time.perf_counter()
    launches = {k: 0 for k in pe_counts()}
    trained = None
    for optimizer in ("radam", "rsgd"):
        cfg_o = dataclasses.replace(cfg, optimizer=optimizer)
        for name in PB.STRATEGIES:
            run = PB.make_runner(name, cfg_o, pairs, plan, steps, args.seed)
            if name == "dense_scan" and optimizer == "radam":
                before = pe.evaluate(run.state.table, ds.pairs, C)
            epochs = 12 if (name, optimizer) == ("dense_scan", "rsgd") \
                else 2 if name.endswith("_scan") else 1
            losses, counts = pe_epochs(torch, pe, run, pairs, epochs)
            per = PE_PER_STEP[name] + (("ptransp",) if optimizer == "radam"
                                       else ())
            want = {k: steps if k in per else 0 for k in counts}
            first, last = float(losses[:50].mean()), float(
                losses[-50:].mean())
            falls = optimizer == "radam" or epochs == 12
            emit({"phase": "pe_train", "strategy": name,
                  "optimizer": optimizer, "steps": len(losses),
                  "launches_last_epoch": counts, "loss_first50": first,
                  "loss_last50": last, "fall_held": falls,
                  "seconds": time.perf_counter() - t0})
            if counts != want:
                raise AssertionError(f"poincare {optimizer} {name}: launches "
                                     f"{counts}, want {want}")
            if not np.all(np.isfinite(losses)) or (falls and not
                                                   last < first):
                raise AssertionError(
                    f"poincare {optimizer} {name}: losses not finite or not "
                    f"falling ({first} -> {last})")
            for k, n in counts.items():
                launches[k] += n
            if name == "dense_scan" and optimizer == "radam":
                trained = run.state.table
    radam = dataclasses.replace(cfg, optimizer="radam")
    bitwise = {}
    for name, c in (("dense_scan", cfg), ("mined_scan_radam", radam),
                    ("planned_scan_radam", radam)):
        base = name.removesuffix("_radam")
        pe_reset()
        bitwise[name] = pe_bitwise(torch, pe, base, c, pairs, plan, steps,
                                   args.seed + 1)
        if c is radam:
            n_pt = pe_counts()["ptransp"]
            bitwise[name]["ptransp_launches"] = n_pt
            if n_pt < steps:
                raise AssertionError(f"{name}: ptransp launched {n_pt} "
                                     f"times in {steps} Adam steps")
        if not (bitwise[name]["table_bitwise"]
                and bitwise[name]["losses_bitwise"]):
            raise AssertionError(f"poincare {name}: the graphed epoch "
                                 f"differs from eager: {bitwise[name]}")
    emit({"phase": "pe_graphed_vs_eager", "steps": steps, **bitwise,
          "seconds": time.perf_counter() - t0})

    # --- phase 27: evaluation ----------------------------------------------
    t0 = time.perf_counter()
    pe_reset()
    after = pe.evaluate(trained, ds.pairs, C)
    n_pdist = pe_counts()["pdist"]
    plain = pe.evaluate(trained, ds.pairs, C, dist_fn=pdist_plain)
    emit({"phase": "pe_eval", "before": before, "after": after,
          "plain_after": plain, "pdist_launches": n_pdist,
          "seconds": time.perf_counter() - t0, **card})
    if n_pdist != PE_EVAL_CHUNKS:
        raise AssertionError(f"evaluate launched pdist {n_pdist} times, "
                             f"want {PE_EVAL_CHUNKS}")
    launches["pdist"] += n_pdist
    if not after["map"] > before["map"]:
        raise AssertionError(f"MAP did not rise: {before} -> {after}")
    if not (abs(after["map"] - plain["map"]) <= 1e-3 and abs(
            after["mean_rank"] - plain["mean_rank"])
            <= 1e-3 * plain["mean_rank"]):
        raise AssertionError(f"kernel and plain evaluations differ: "
                             f"{after} vs {plain}")

    # --- phase 28: the bench leg and the large table ------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    bench = PB.run_poincare_bench(repeats=PE_BENCH_REPEATS, device="cuda",
                                  seed=args.seed)
    peak = torch.cuda.max_memory_allocated()
    # device busy time and idle share of 20 steps of each strategy (a
    # window of an epoch's ~20,000 device events is more than the
    # profiler keeps reliably), against the same 20 steps unprofiled
    busy = {}
    plan20 = pe.SparsePlan(*(a[:PE_PROFILE_STEPS] for a in plan))
    for name in PB.STRATEGIES:
        run = PB.make_runner(name, cfg, pairs, plan20, PE_PROFILE_STEPS,
                             args.seed)
        run.epoch()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run.epoch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
        busy[name] = {"wall_ms_20_steps": wall, **device_share(
            torch, run.epoch, wall, reps=1)}
    emit({"phase": "pe_bench", **{k: v for k, v in bench.items()
                                  if k != "epochs"},
          "epoch_spread": {n: e["spread"] for n, e in
                           bench["epochs"].items()},
          "step_ms": {n: e["s"] / steps * 1e3 for n, e in
                      bench["epochs"].items()},
          "device": busy, "peak_device_memory_bytes": peak,
          "seconds": time.perf_counter() - t0, **card})

    # --- phase 29: the CLI --------------------------------------------------
    t0 = time.perf_counter()
    pe_reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_train.main(["poincare", "--yaml", os.path.join(REPO, PE_CLI_YAML),
                        "steps=300"])
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    counts = pe_counts()
    emit({"phase": "pe_cli", "config": PE_CLI_YAML, **res,
          "launches": counts, "seconds": time.perf_counter() - t0, **card})
    if res["steps"] != 300 or not 0.0 < res["map"] <= 1.0:
        raise AssertionError(f"poincare CLI: {res}")
    return {"err": err, "launches": launches, "times": times}


def pe_kernel_times(torch, table, row) -> dict:
    """Device ms and bounds of the four kernels at this path's shapes
    (taken before the path's CUDA graphs and long profiler windows), keyed
    by kernel, under names ending in ``_pe_<shape>``."""
    from hyperspace_torch.kernels.distmat import pdist, pdist_plain
    from hyperspace_torch.kernels.scan_topk import scan_topk, scan_topk_plain
    from hyperspace_torch.kernels.segment import (csr_segment_sum,
                                                  csr_segment_sum_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    q = table[:PE_BATCH].contiguous()
    pool = table[torch.randint(0, PE_ROWS, (PE_POOL,), generator=gen,
                               device=dev)].contiguous()
    qi = torch.zeros(PE_BATCH, dtype=torch.int32, device=dev)
    vals = torch.randn(PE_SLOTS, DIM, generator=gen, device=dev)
    recv = row.seg_sorted
    r64 = recv.long()

    def lib():
        out = torch.zeros(PE_SLOTS, DIM, device=dev)
        return out.index_add_(0, r64, vals)

    t = {"pdist": {
        "ms_pe_eval": device_ms(torch, lambda: pdist(
            q, table, C, manifold="poincare")),
        "plain_ms_pe_eval": device_ms(torch, lambda: pdist_plain(
            q, table, C, manifold="poincare"), reps=5),
        "bound_ms_pe_eval": bound_ms(*pdist_cost(PE_BATCH, PE_ROWS, DIM))[0],
        "shape_pe_eval": [PE_BATCH, PE_ROWS, DIM]},
        "scan_topk": {
        "ms_pe_mine": device_ms(torch, lambda: scan_topk(
            pool, q, qi, 0, spec=("poincare", C), k=PE_NEG, n=PE_POOL)),
        "plain_ms_pe_mine": device_ms(torch, lambda: scan_topk_plain(
            pool, q, qi, 0, kind="poincare", c=C, k=PE_NEG, n=PE_POOL,
            exclude_self=False)),
        "bound_ms_pe_mine": bound_ms(*scan_cost(
            PE_BATCH, PE_POOL, PE_POOL, DIM, PE_NEG))[0],
        "shape_pe_mine": [PE_BATCH, PE_POOL, DIM, PE_NEG]},
        "csr_segment_sum": {
        "ms_pe_planned": device_ms(torch, lambda: csr_segment_sum(
            vals, recv, None, PE_SLOTS)),
        "plain_ms_pe_planned": device_ms(
            torch, lambda: csr_segment_sum_plain(vals, recv, PE_SLOTS)),
        "library_ms_pe_planned": device_ms(torch, lib),
        "bound_ms_pe_planned": bound_ms(*segment_cost(
            PE_SLOTS, DIM, PE_SLOTS, 4))[0],
        "shape_pe_planned": [PE_SLOTS, DIM]}}
    for op, shapes in (("expmap", {"dense": (PE_ROWS, DIM),
                                   "planned": (PE_SLOTS, DIM)}),
                       ("ptransp", {"large": (PE_BIG_ROWS, DIM),
                                    "planned": (PE_SLOTS, DIM)})):
        t[op] = {}
        for tag, shape in shapes.items():
            ts = row_inputs(torch, gen, op, shape, C, dev)
            t[op][f"ms_pe_{tag}"] = device_ms(
                torch, lambda ts=ts: row_call(op, ts, C))
            t[op][f"plain_ms_pe_{tag}"] = device_ms(
                torch, lambda ts=ts: row_call(op, ts, C, plain=True), reps=5)
            t[op][f"bound_ms_pe_{tag}"] = bound_ms(*row_cost(op, *shape))[0]
            t[op][f"shape_pe_{tag}"] = list(shape)
    return t


def pe_kernel_fields(pp: dict, kernels: list) -> None:
    """Add the Poincaré path's shapes to the kernels line: each kernel's
    times there (:func:`pe_kernel_times`), its launches on the path
    (``launches_pe``) and a step, and its largest error there."""
    per_step = {"pdist": ("launches_per_eval_pe", PE_EVAL_CHUNKS),
                "scan_topk": ("launches_per_mined_step_pe", 1),
                "csr_segment_sum": ("launches_per_planned_step_pe", 1),
                "expmap": ("launches_per_step_pe", 1),
                "ptransp": ("launches_per_radam_step_pe", 1)}
    for e in kernels:
        name = e["name"]
        if name in pp["times"]:
            key, n = per_step[name]
            e.update(pp["times"][name])
            e.update({"launches_pe": pp["launches"][name], key: n,
                      "max_abs_err_pe": pp["err"][name]})


# --- HGCN node classification: the first path to launch hyp_mlr at its head --

NC_STEPS = 10
# a step: 2 layers × (the clustered pairs' aggregation and the straggler
# scatter) forward and again in the backward; the head's forward (its
# gradient is the plain version's VJP, as JAX's)
NC_PER_STEP = {"csr_segment_sum": 4, "cluster_aggregate": 4, "hyp_mlr": 1}
NC_PER_EVAL = {"csr_segment_sum": 2, "cluster_aggregate": 2, "hyp_mlr": 1}
NC_CARD_CPU_NODES = 20_000


def nc_counts() -> dict:
    from hyperspace_torch.kernels import cluster as KC
    from hyperspace_torch.kernels.mlr import hyp_mlr
    from hyperspace_torch.kernels.segment import csr_segment_sum

    return {"csr_segment_sum": csr_segment_sum.launches,
            "cluster_aggregate": KC.cluster_aggregate.launches,
            "hyp_mlr": hyp_mlr.launches,
            "row_plan_builds": KC.row_plan_builds}


def nc_reset() -> None:
    from hyperspace_torch.kernels import cluster as KC
    from hyperspace_torch.kernels.mlr import hyp_mlr
    from hyperspace_torch.kernels.segment import csr_segment_sum

    csr_segment_sum.launches = KC.cluster_aggregate.launches = 0
    hyp_mlr.launches = KC.row_plan_builds = 0


def nc_setup(torch, g, device, seed: int):
    """The NC model on ``device``: Lorentz, hidden (128, 32), the LP
    bench's bf16 edge messages, the graph's 40 classes."""
    from hyperspace_torch.data import graphs as G
    from hyperspace_torch.models import hgcn

    cfg = hgcn.HGCNConfig(feat_dim=g.x.shape[1], hidden_dims=(128, 32),
                          kind="lorentz", num_classes=g.num_classes,
                          agg_dtype=torch.bfloat16)
    model, opt, state = hgcn.init_nc(cfg, g, seed=seed, device=device)
    ga = G.to_device(g, device)
    labels, train = hgcn.nc_targets(g, device)

    def step():
        nonlocal state
        state, loss = hgcn.train_step_nc(model, opt, state, ga, labels, train)
        return loss

    return model, ga, step


def check_counts(got: dict, per: dict, times: int, what: str) -> None:
    for name, n in per.items():
        if got[name] != n * times:
            raise AssertionError(f"{what}: {got[name]} {name} launches, "
                                 f"want {n} × {times}")
    if got.get("row_plan_builds"):
        raise AssertionError(f"{what}: {got['row_plan_builds']} row plans "
                             "built; the split's should serve them all")


def nc_path(torch, args, card: dict, tr: dict) -> dict:
    """Phases 30–32; returns the head's inputs and launches for the
    kernels line."""
    from hyperspace_torch.benchmarks import hgcn_bench as B
    from hyperspace_torch.models import hgcn

    dev = torch.device("cuda")
    # --- phase 30: the whole arxiv-scale graph with its classes ------------
    t0 = time.perf_counter()
    g = B.arxiv_scale_nc_graph(seed=args.seed, graph=tr["graph"])
    prep_s = time.perf_counter() - t0
    cs = g.cluster_split
    if cs is None:
        raise AssertionError("no cluster split on the NC graph")
    model, ga, step = nc_setup(torch, g, dev, args.seed)
    emit({"phase": "nc_setup", "host_prep_s": prep_s,
          "seconds": time.perf_counter() - t0, "nodes": g.num_nodes,
          "edges_real": g.num_edges, "classes": g.num_classes,
          "frac_clustered": cs.frac_clustered,
          "train_val_test": [int(g.train_mask.sum()), int(g.val_mask.sum()),
                             int(g.test_mask.sum())]})

    # --- phase 31: the NC path: a warm-up and 10 timed steps, an evaluation
    t0 = time.perf_counter()
    first_input = nc_head_input(torch, model, ga)      # the first step's
    torch.cuda.synchronize()
    nc_reset()
    torch.cuda.reset_peak_memory_stats()
    warm = float(step())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = [step() for _ in range(NC_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / NC_STEPS * 1e3
    launches = nc_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    check_counts(launches, NC_PER_STEP, NC_STEPS + 1, "NC steps")
    nc_reset()
    ev = hgcn.evaluate_nc(model, g, ga=ga)
    eval_launches = nc_counts()
    check_counts(eval_launches, NC_PER_EVAL, 1, "NC evaluation")
    emit({"phase": "nc_train", "steps": NC_STEPS, "warmup_loss": warm,
          "losses": losses, "step_ms": step_ms,
          "nodes_per_s": g.num_nodes / step_ms * 1e3,
          "launches": launches, "launches_eval": eval_launches,
          "peak_device_memory_bytes": peak, **ev,
          "seconds": time.perf_counter() - t0, **card})
    # held against the first step's loss (the warm-up): at lr 1e-2 the
    # first update takes most of the fall, and the next ten wander
    if not np.all(np.isfinite(losses + [warm])):
        raise AssertionError(f"non-finite NC loss: {losses}")
    if not losses[-1] < warm:
        raise AssertionError(f"the NC loss did not fall: {warm}, {losses}")
    t1 = time.perf_counter()
    share = device_share(torch, step, step_ms, reps=3, top_n=8)
    emit({"phase": "nc_profile", "step_ms": step_ms, **share,
          "seconds": time.perf_counter() - t1, **card})

    # the scatter kernels on this graph's own edge sets, as its steps call
    # them: the straggler receivers and the clustered pairs with their row
    # plan, bf16 at both layers' widths
    t1 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    agg, n, bf16 = ga.cluster, g.num_nodes, torch.bfloat16
    n_strag = int(cs.s_mask.sum())
    scatter_err = {
        "csr_segment_sum": max(check_segsum(
            torch, gen, "NC stragglers", agg.s_recv, n, f, bf16, n_strag)
            for f in (128, 32)),
        "cluster_aggregate": max(check_cluster(
            torch, gen, "NC clustered", agg, n, f, bf16) for f in (128, 32))}
    emit({"phase": "nc_scatter_checks", "straggler_edges": n_strag,
          "clustered_edges": int(agg.c_recv.shape[0]),
          "max_abs_err": scatter_err, "seconds": time.perf_counter() - t1})

    # the head's own inputs: at the first step, against the plain version
    # at the tier of phase 12's head check; after the steps, where the
    # encoder has carried every point to the ball's rim in f32 (ROADMAP
    # §C), against float64 no worse than the plain version
    err = check_nc_head(torch, "first_step", first_input)
    after = nc_head_input(torch, model, ga)
    check_nc_head(torch, "after_steps", after)

    # --- phase 32: two steps on the card against two on the CPU -----------
    t0 = time.perf_counter()
    g20 = B.arxiv_scale_nc_graph(NC_CARD_CPU_NODES, seed=args.seed)
    if g20.cluster_split is None or not len(g20.cluster_split.c_recv):
        raise AssertionError("the 20,000-node NC graph clusters no edge")
    runs = {}
    for where in ("cuda", "cpu"):
        _m20, _g20, step20 = nc_setup(torch, g20, torch.device(where),
                                      args.seed)
        runs[where] = [float(step20()) for _ in range(2)]
    rel = max(abs(a_ - b_) / abs(b_) for a_, b_ in zip(runs["cuda"],
                                                       runs["cpu"]))
    emit({"phase": "nc_card_vs_cpu", "nodes": NC_CARD_CPU_NODES,
          "frac_clustered": g20.cluster_split.frac_clustered,
          "losses_cuda": runs["cuda"], "losses_cpu": runs["cpu"],
          "max_rel_loss_diff": rel, "seconds": time.perf_counter() - t0})
    if not rel <= CARD_CPU_RTOL:
        raise AssertionError(f"NC card and CPU losses differ by {rel}")
    return {"head": after, "launches": launches, "err": err,
            "scatter_err": scatter_err}


def nc_head_input(torch, model, ga):
    """(x, p, a, c) as the NC head hands them to ``hyp_mlr``: the ball
    image of the encoder's output, the hyperplane points and normals."""
    from hyperspace_torch.manifolds.maps import lorentz_to_ball

    with torch.no_grad():
        z, _m = model.encoder(ga)
        head = model.head
        c = head.manifold.c
        return (lorentz_to_ball(z, c).contiguous(),
                head.manifold.expmap0(head.p_tangent).contiguous(),
                head.a.detach().contiguous(), c)


NC_RIM_SLACK = 1.1


def check_nc_head(torch, which: str, head, tag: str = "") -> float:
    """``hyp_mlr`` on an NC head input, launched twice for the same bits.
    Where the rows keep clear of the ball's rim (``first_step``) the
    logits are held against the plain version at phase 12's tier; where
    1 − ‖x‖² is below f32's resolution (``after_steps``) no f32 order of
    operations is within that tier of another, so the kernel's largest
    error against float64 is held to at most ``NC_RIM_SLACK`` times the
    f32 plain version's.  Returns the largest gap to the plain version."""
    from hyperspace_torch.kernels.mlr import hyp_mlr, hyp_mlr_plain

    x, p, a, c = head
    got = hyp_mlr(x, p, a, c)
    again = hyp_mlr(x, p, a, c)
    torch.cuda.synchronize()
    want = hyp_mlr_plain(x, p, a, c)
    f64 = hyp_mlr_plain(x.double(), p.double(), a.double(), c)
    tier = MLR_ATOL + MLR_RTOL * f64.abs()
    err_k = (got.double() - f64).abs()
    err_p = (want.double() - f64).abs()
    rim = 1.0 - torch.sum(x.double() ** 2, dim=-1)
    diff = (got - want).abs()
    over = int((diff > MLR_ATOL + MLR_RTOL * want.abs()).sum())
    same = bool(torch.equal(got, again))
    out = {"phase": "check", "kernel": "hyp_mlr",
           "input": f"nc_head_{which}{tag}",
           "shape": [x.shape[0], p.shape[0], x.shape[1]],
           "max_abs_err": float(diff.max()), "over_tolerance": over,
           "repeat_equal": same, "kernel_f64_over_tier": float(
               (err_k / tier).max()),
           "plain_f64_over_tier": float((err_p / tier).max()),
           "kernel_f64_max": float(err_k.max()),
           "plain_f64_max": float(err_p.max()),
           "rim_gap_min_median_max": [float(rim.min()), float(rim.median()),
                                      float(rim.max())],
           "logit_abs_max": float(f64.abs().max())}
    emit(out)
    if not same:
        raise AssertionError(f"hyp_mlr at the NC head ({which}): repeats "
                             "differ")
    if which == "first_step" and over:
        raise AssertionError(f"hyp_mlr at the NC head ({which}): {over} "
                             "logits beyond tolerance")
    if which != "first_step" and not (out["kernel_f64_max"]
                                      <= NC_RIM_SLACK * out["plain_f64_max"]):
        raise AssertionError(f"hyp_mlr at the NC head ({which}): further "
                             "from float64 than the plain version")
    return float(diff.max())


def nc_kernel_fields(torch, nc: dict, kernels: list) -> None:
    """Add the NC path to the kernels line: ``hyp_mlr`` at the head's own
    input (device ms, plain ms, bound, launches on the path, a step and an
    evaluation; no library call computes the MLR logits), and the scatter
    kernels' launches there."""
    from hyperspace_torch.kernels.mlr import hyp_mlr, hyp_mlr_plain

    xb, p, a, c = nc["head"]
    shape = (xb.shape[0], p.shape[0], xb.shape[1])
    bound, by = bound_ms(*mlr_cost(*shape))
    for e in kernels:
        name = e["name"]
        if name in NC_PER_STEP:
            e.update({"launches_nc": nc["launches"][name],
                      "launches_per_step_nc": NC_PER_STEP[name],
                      "launches_per_eval_nc": NC_PER_EVAL[name]})
        if name in nc["scatter_err"]:
            e["max_abs_err_nc"] = nc["scatter_err"][name]
        if name == "hyp_mlr":
            e.update({
                "ms_nc_head": device_ms(torch, lambda: hyp_mlr(xb, p, a, c)),
                "plain_ms_nc_head": device_ms(
                    torch, lambda: hyp_mlr_plain(xb, p, a, c), reps=5),
                "bound_ms_nc_head": bound, "bound_by_nc_head": by,
                "library_ms_nc_head": None, "shape_nc_head": list(shape),
                "max_abs_err_nc_head_first_step": nc["err"]})


# --- the hyperbolic VAE (BASELINE.json configs[3]) -------------------------

HVAE_KINDS = ("poincare", "lorentz")
HVAE_IMAGES = 4096
HVAE_STEPS = 50
HVAE_CARD_CPU_STEPS = 3
HVAE_CARD_CPU_RTOL = 1e-4       # all f32, cuDNN's TF32 off
HVAE_IWAE_K, HVAE_IWAE_IMAGES = 16, 256
HVAE_CLI_YAML = os.path.join("configs", "hvae_mnist.yaml")
HVAE_CHUNK = 8                  # the graphed chunk held against eager
# graphed against eager without cuDNN's determinism, as the path runs: its
# weight gradients sum in another order each run (with determinism the two
# are bitwise equal, so the graph adds no gap of its own); after 8 steps the
# gap was up to 1.3e-6 (parameters, norm-wise) and 2.6e-6 (metrics) on the
# H100 (PERF.md §6)
HVAE_GRAPH_RTOL = 1e-5
HVAE_CLI_CHUNK = 100            # the CLI's 800 steps in 8 graphed chunks


def hvae_cfg(kind: str):
    """``configs/hvae_mnist.yaml``'s width: hidden 256, conv (32, 64),
    latent 8, batch 128, c = 1."""
    from hyperspace_torch.models import hvae

    return hvae.HVAEConfig(latent_dim=8, batch_size=128, hidden=256,
                           conv_features=(32, 64), kind=kind, c=1.0)


def hvae_card_vs_cpu(torch, args, images) -> dict:
    """3 steps on the card and on the CPU from the same parameters with
    the same injected ids and ε: the largest relative gap of loss, recon
    and kl, and of each parameter norm-wise (‖card − CPU‖ / ‖CPU‖: Adam
    divides each gradient by its own root mean square, so an entry whose
    gradient cancels to rounding noise moves by up to lr·|noise| /
    (|noise| + eps) on either device); the largest entry gap beside."""
    from hyperspace_torch.models import hvae

    out = {}
    for kind in HVAE_KINDS:
        cfg = hvae_cfg(kind)
        gen = torch.Generator().manual_seed(args.seed + 31)
        p0 = hvae.init_params(cfg, gen)
        draws = [(torch.randint(0, len(images), (cfg.batch_size,),
                                generator=gen),
                  torch.randn((cfg.batch_size, cfg.latent_dim),
                              generator=gen))
                 for _ in range(HVAE_CARD_CPU_STEPS)]
        runs = {}
        for where in ("cuda", "cpu"):
            model, opt, st = hvae.init_model(cfg, args.seed, where,
                                             params=p0)
            x = torch.as_tensor(images, device=where)
            metrics = []
            for idx, eps in draws:
                st, *m = hvae.train_step_sampled(
                    model, opt, st, x, idx=idx.to(where), eps=eps.to(where))
                metrics.append([float(v) for v in m])
            runs[where] = (np.asarray(metrics), {
                f"{a}/{b}/{c}": t.cpu() for a, la in st.params.items()
                for b, lb in la.items() for c, t in lb.items()})
        mc, mp = runs["cuda"]
        cc, cp = runs["cpu"]
        rel_m = float(np.max(np.abs(mc - cc) / np.abs(cc)))
        norm = torch.linalg.vector_norm
        rel_p = max(float(norm(mp[k] - v) / norm(v)) for k, v in cp.items())
        out[kind] = {"metrics_cuda": mc.tolist(), "metrics_cpu": cc.tolist(),
                     "max_rel_metric_diff": rel_m,
                     "max_rel_param_diff": rel_p,
                     "max_abs_param_diff": max(float((mp[k] - v).abs().max())
                                               for k, v in cp.items())}
        if not (rel_m <= HVAE_CARD_CPU_RTOL and rel_p <= HVAE_CARD_CPU_RTOL):
            raise AssertionError(f"HVAE {kind}: card and CPU differ "
                                 f"(metrics {rel_m}, parameters {rel_p})")
    return out


def hvae_path(torch, args, card: dict) -> dict:
    """Phases 33–35 (no CUDA graph); returns the bench leg for phase 36."""
    from hyperspace_torch.benchmarks import workloads_bench as W
    from hyperspace_torch.data.mnist import synthetic_mnist
    from hyperspace_torch.models import hvae

    dev = torch.device("cuda")
    # --- phase 33: card against CPU, both latent geometries ---------------
    t0 = time.perf_counter()
    images = synthetic_mnist(num_samples=HVAE_IMAGES, seed=args.seed).images
    data_s = time.perf_counter() - t0
    cvc = hvae_card_vs_cpu(torch, args, images)
    emit({"phase": "hvae_card_vs_cpu", "images": HVAE_IMAGES,
          "data_s": data_s, "steps": HVAE_CARD_CPU_STEPS, **cvc,
          "seconds": time.perf_counter() - t0})

    # --- phase 34: sampled steps on the card, then the IWAE bound ---------
    x_all = torch.as_tensor(images, device=dev)
    for kind in HVAE_KINDS:
        t0 = time.perf_counter()
        cfg = hvae_cfg(kind)
        model, opt, st = hvae.init_model(cfg, args.seed, dev)
        losses = []
        for _ in range(HVAE_STEPS):
            st, loss, recon, kl = hvae.train_step_sampled(model, opt, st,
                                                          x_all)
            losses.append(loss)
        losses = torch.stack(losses).cpu().numpy()
        first, last = float(losses[:10].mean()), float(losses[-10:].mean())
        x = x_all[:HVAE_IWAE_IMAGES]
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        eps = torch.randn((HVAE_IWAE_K, HVAE_IWAE_IMAGES, cfg.latent_dim),
                          generator=gen, device=dev)
        iwae = float(hvae.iwae_bound(model, st.params, x, k=HVAE_IWAE_K,
                                     eps=eps))
        with torch.no_grad(), hvae.f32_convolutions():   # the same K draws
            prior = model.prior(x.dtype, dev)
            elbo = float(torch.stack([torch.mean(torch.sub(*hvae.elbo_terms(
                model(st.params, x, eps=e), prior, x))) for e in eps]).mean())
        emit({"phase": "hvae_train", "kind": kind, "steps": HVAE_STEPS,
              "losses_first_10_mean": first, "losses_last_10_mean": last,
              "last_recon": float(recon), "last_kl": float(kl),
              "iwae_k16_256": iwae, "elbo_same_draws": elbo,
              "seconds": time.perf_counter() - t0, **card})
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"HVAE {kind}: non-finite loss")
        if not last < first:
            raise AssertionError(f"HVAE {kind}: the loss did not fall "
                                 f"({first} -> {last})")
        if not (np.isfinite(iwae) and iwae >= elbo):
            raise AssertionError(f"HVAE {kind}: IWAE {iwae} below the ELBO "
                                 f"{elbo} of the same draws")

    # --- phase 35: the bench leg, stepwise ---------------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    leg = W.setup_hvae_leg(device=dev, seed=args.seed)
    res = W.run_hvae_leg(leg, steps=10, repeats=3, chunk=0)
    share = device_share(torch, leg.step, res["step_ms"], reps=5, top_n=8)
    emit({"phase": "hvae_bench", **{k: v for k, v in res.items()
                                    if k != "losses"},
          "loss_first": res["losses"][0], "loss_last": res["losses"][-1],
          **share,
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t0, **card})
    return {"leg": leg, "images": x_all, "seed": args.seed}


def cudnn_flags(torch, deterministic: bool):
    """cuDNN as the HVAE runs it (TF32 off, no autotuning), its
    deterministic algorithms on or off, for the span of the block."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=deterministic,
                                      allow_tf32=False)


def hvae_graph_vs_eager(torch, hv: dict, kind: str,
                        deterministic: bool) -> dict:
    """A graphed chunk of ``HVAE_CHUNK`` sampled steps against the same
    steps run eagerly from the same state and generator, captured and run
    with cuDNN's determinism on or off: bitwise equality, and the largest
    relative gaps (parameters norm-wise, metrics entry-wise)."""
    from hyperspace_torch.models import hvae
    from hyperspace_torch.train import loop

    with cudnn_flags(torch, deterministic):
        model, opt, st = hvae.init_model(hvae_cfg(kind), 7, "cuda")
        eager = pe_clone(torch, st)
        rows = []
        for _ in range(HVAE_CHUNK):
            eager, *m = hvae.train_step_sampled(model, opt, eager,
                                                hv["images"])
            rows.append(torch.stack(m))
        chunk = loop.make_chunked_stepper(hvae.chunk_step(model, opt),
                                          HVAE_CHUNK)
        st, graphed = chunk(st, hv["images"])
        torch.cuda.synchronize()
    rows = torch.stack(rows)
    leaves = list(zip(torch.utils._pytree.tree_leaves(st.params),
                      torch.utils._pytree.tree_leaves(eager.params)))
    out = {"params_bitwise": all(bool(torch.equal(a, b)) for a, b in leaves),
           "metrics_bitwise": bool(torch.equal(graphed, rows)),
           "max_param_rel": max(float(torch.linalg.vector_norm(a - b)
                                      / torch.linalg.vector_norm(b))
                                for a, b in leaves),
           "max_metric_rel": float(((graphed - rows).abs()
                                    / rows.abs()).max())}
    _st, again = chunk(st, hv["images"])          # a replay, no capture
    out["replay_finite"] = bool(torch.isfinite(again).all())
    return out


def hvae_graphs(torch, hv: dict, card: dict) -> None:
    """Phases 36–37 (after every profiled time): the bench leg's graphed
    chunks with cuDNN's determinism off (the path) and on, a graphed chunk
    against the same steps run eagerly from the same state and generator
    on both geometries (bitwise under determinism, within
    ``HVAE_GRAPH_RTOL`` without), and the CLI's config in graphed
    chunks."""
    from hyperspace_torch.benchmarks import workloads_bench as W
    from hyperspace_torch.cli import train as train_cli

    # --- phase 36: graphed chunks -----------------------------------------
    # the path runs without cuDNN's determinism; with it on, a graphed
    # chunk is the eager steps bit for bit, and the leg is timed both ways
    t0 = time.perf_counter()
    leg = hv["leg"]
    chunks = W.run_hvae_chunks(leg, W.SCAN_CHUNK_K, repeats=3)
    chunk_losses = chunks.pop("losses")
    with cudnn_flags(torch, True):
        det_leg = W.setup_hvae_leg(device="cuda", seed=hv["seed"])
        det = W.run_hvae_chunks(det_leg, W.SCAN_CHUNK_K, repeats=3)
    del det_leg
    agree = {}
    for kind in HVAE_KINDS:
        agree[kind] = {"deterministic": hvae_graph_vs_eager(torch, hv, kind,
                                                            True)}
        agree[kind]["path"] = hvae_graph_vs_eager(torch, hv, kind, False)
    emit({"phase": "hvae_graphs", **chunks,
          "scan_chunk_step_ms_cudnn_deterministic":
              det["scan_chunk_step_ms"],
          "scan_chunk_repeat_ms_cudnn_deterministic":
              det["scan_chunk_repeat_ms"],
          "chunk_loss_first_last": [chunk_losses[0], chunk_losses[-1]],
          "chunk": HVAE_CHUNK, "graphed_vs_eager": agree,
          "path_rtol": HVAE_GRAPH_RTOL,
          "seconds": time.perf_counter() - t0, **card})
    for kind, a in agree.items():
        d, p = a["deterministic"], a["path"]
        if not (d["params_bitwise"] and d["metrics_bitwise"]
                and d["replay_finite"] and p["replay_finite"]):
            raise AssertionError(f"HVAE {kind}: under cuDNN's determinism "
                                 "the graphed chunk is not the eager steps "
                                 f"bit for bit: {a}")
        if not (p["max_param_rel"] <= HVAE_GRAPH_RTOL
                and p["max_metric_rel"] <= HVAE_GRAPH_RTOL):
            raise AssertionError(f"HVAE {kind}: the graphed chunk is beyond "
                                 f"rel {HVAE_GRAPH_RTOL} of the eager steps: "
                                 f"{a}")

    # --- phase 37: the CLI at configs/hvae_mnist.yaml, graphed chunks -----
    # (its 800 steps eagerly are host-bound: 47 ms a step on this path's
    # stepwise bench leg on the H100, PERF.md §6)
    t0 = time.perf_counter()
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        train_cli.main(["hvae", "--yaml", HVAE_CLI_YAML,
                        f"scan_chunk={HVAE_CLI_CHUNK}"])
    finally:
        sys.stdout = old
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    emit({"phase": "hvae_cli", "config": HVAE_CLI_YAML,
          "scan_chunk": HVAE_CLI_CHUNK, **res,
          "seconds": time.perf_counter() - t0, **card})
    if not all(np.isfinite(res[k]) for k in ("loss", "recon", "kl", "iwae")):
        raise AssertionError(f"the HVAE CLI's metrics are not finite: {res}")


# --- phases 38-43: HGCN as its users launch it, through the CLI ------------

# the arxiv layout: community_power_law_graph at its defaults (ogbn-arxiv's
# statistics: 169,343 nodes, 1,166,243 edges, 128 features, 40 classes)
# written by data.graphs.write_ogb_csv_layout; the Cora layout: a graph of
# Cora's size (2,708 papers, 5,429 citations, 1,433 binary words, 7
# classes) in the Planetoid format
CORA_SHAPE = dict(num_nodes=2708, num_edges=5429, num_classes=7,
                  feat_dim=1433)
CLI_LP_YAML = os.path.join("configs", "hgcn_arxiv_lp.yaml")
CLI_STEPS = 12
CLI_NC_STEPS = CLI_ATT_STEPS = 5
PLANNED_STEPS = 10
# launches a step of the CLI's train_step_lp: 2 layers × (the clustered
# pairs' aggregation and the straggler scatter) forward and again in the
# backward; the decoder's pairs are plain gathers (their backward is
# PyTorch's index_put_); an evaluation scores the test positives and the
# test negatives, one encoder forward each
CLI_LP_PER_STEP = {"csr_segment_sum": 4, "cluster_aggregate": 4}
CLI_LP_PER_EVAL = {"csr_segment_sum": 4, "cluster_aggregate": 4}
# train_step_lp_planned: the encoder's, graph_edge_sqdist's one [E, 33]
# scatter for both endpoints, and the negatives' sorted u side
PLANNED_PER_STEP = {"csr_segment_sum": 6, "cluster_aggregate": 4}
# the attention arm on a graph under 200,000 edges (no cluster split): a
# layer's planned partial (csr_segment_sum over [E, F + 1]) forward, its
# dh scatter, edge pass and α_s reduction backward; an evaluation the two
# forwards
CLI_ATT_PER_STEP = {"csr_segment_sum": 4, "csr_att_bwd_edges": 2,
                    "csr_segment_reduce_1d": 2}
CLI_ATT_PER_EVAL = {"csr_segment_sum": 4}
LEARN_C_NODES = 20_000
LEARN_C_STEPS = 2


def run_cli(argv: list) -> dict:
    """``cli.train.main(argv)`` in this process; its JSON line."""
    from contextlib import redirect_stdout

    from hyperspace_torch.cli import train as cli_train

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli_train.main(argv)
    if rc != 0:
        raise AssertionError(f"cli.train {argv[0]} exited {rc}")
    return json.loads(buf.getvalue().splitlines()[-1])


def read_log(path: str) -> list:
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


def check_cli_counts(got: dict, per_step: dict, per_eval: dict, steps: int,
                     what: str) -> None:
    """Launches of a CLI run: ``steps`` steps and one evaluation."""
    for name in set(per_step) | set(per_eval):
        want = steps * per_step.get(name, 0) + per_eval.get(name, 0)
        if got[name] != want:
            raise AssertionError(f"{what}: {got[name]} {name} launches, want "
                                 f"{steps} × {per_step.get(name, 0)} + "
                                 f"{per_eval.get(name, 0)}")
    if got.get("row_plan_builds"):
        raise AssertionError(f"{what}: {got['row_plan_builds']} row plans "
                             "built; the split's should serve them all")


def check_losses(losses: list, what: str, first=None) -> None:
    first = losses[0] if first is None else first
    if not np.all(np.isfinite(losses + [first])):
        raise AssertionError(f"{what}: non-finite loss {losses}")
    if not losses[-1] < first:
        raise AssertionError(f"{what}: the loss did not fall: {losses}")


def layouts_equal(a, b) -> bool:
    """Two prepared graphs' edge layouts, cluster split included, bit
    for bit."""
    def arrays(g):
        out = [g.senders, g.receivers, g.edge_mask, g.rev_perm, g.deg,
               *g.csr_plan]
        cs = g.cluster_split
        if cs is not None:
            out += [v for v in cs if isinstance(v, np.ndarray)]
            out += [v for part in (cs.c_plan, cs.s_plan, cs.c_rows)
                    if part is not None for v in part
                    if isinstance(v, np.ndarray)]
        return out

    xa, xb = arrays(a), arrays(b)
    return len(xa) == len(xb) and all(
        u.dtype == v.dtype and np.array_equal(u, v) for u, v in zip(xa, xb))


def cli_path(torch, args, card: dict) -> dict:
    """Phases 38–43; returns what the kernels line takes from them."""
    from hyperspace_torch.data import graphs as G
    from hyperspace_torch.data import native
    from hyperspace_torch.data import prep_cache
    from hyperspace_torch.models import hgcn

    dev = torch.device("cuda")
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=work)
    try:
        return _cli_phases(torch, args, card, dev, tmp, G, native,
                           prep_cache, hgcn)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _cli_phases(torch, args, card, dev, tmp, G, native, prep_cache, hgcn):
    arxiv_dir, cora_dir = (os.path.join(tmp, d) for d in ("arxiv", "cora"))
    # --- phase 38: the disk layouts --------------------------------------
    t0 = time.perf_counter()
    edges, x, labels, k = G.community_power_law_graph(seed=args.seed)
    gen_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    G.write_ogb_csv_layout(arxiv_dir, edges, x, labels)
    write_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    e_l, x_l, lab_l, k_l = G.load_ogbn_arxiv(arxiv_dir)
    load_s = time.perf_counter() - t1
    if not (np.array_equal(e_l, edges) and np.array_equal(lab_l, labels)
            and k_l == k == len(np.unique(labels)) == 40):
        raise AssertionError("the arxiv layout did not load back")
    x_err = float(np.max(np.abs(x_l - x) / np.maximum(np.abs(x), 1e-30)))
    if not x_err <= 5e-6 + 2.0 ** -23:      # %.6g, then an f32 rounding
        raise AssertionError(f"features loaded {x_err} off")
    size = sum(os.path.getsize(os.path.join(arxiv_dir, "raw", f))
               for f in os.listdir(os.path.join(arxiv_dir, "raw")))
    t1 = time.perf_counter()
    ce, cx, cl, ck = G.community_power_law_graph(seed=args.seed,
                                                 **CORA_SHAPE)
    cx = (cx > 1.5).astype(np.float32)             # binary words
    G.write_cora_layout(cora_dir, ce, cx, cl)
    cora_write_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    cora = G.load_cora(cora_dir)
    cora_load_s = time.perf_counter() - t1
    if not (np.array_equal(cora[0], ce) and np.array_equal(cora[1], cx)):
        raise AssertionError("the Cora layout did not load back")
    emit({"phase": "cli_layouts", "nodes": len(x), "edges": len(edges),
          "classes": k, "feat_dim": x.shape[1], "generate_s": gen_s,
          "write_s": write_s, "load_s": load_s, "bytes": size,
          "feature_max_rel_err": x_err, "cora_nodes": len(cx),
          "cora_edges": len(ce), "cora_write_s": cora_write_s,
          "cora_load_s": cora_load_s,
          "seconds": time.perf_counter() - t0})

    # --- phase 39: host prep, native against numpy; the prep cache -------
    t0 = time.perf_counter()
    n = len(x_l)
    times = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        times[name] = time.perf_counter() - t
        return out

    if not native.available():
        raise AssertionError("the native host prep did not build")
    order_n = timed("bfs_native_s", lambda: native.locality_order(e_l, n))
    order_p = timed("bfs_python_s", lambda: G._locality_order_python(e_l, n))
    if not np.array_equal(order_n, order_p):
        raise AssertionError("native and Python BFS orders differ")
    er, xr, lr, _ = G.apply_locality_order(e_l, x_l, lab_l, cache=False)
    lay_n = timed("layout_native_s", lambda: native.prepare_edges(er, n))
    lay_p = timed("layout_numpy_s", lambda: G._prepare_edges_numpy(er, n))
    if not all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(lay_n, lay_p)):
        raise AssertionError("native and numpy edge layouts differ")
    pc = prep_cache.PrepCache(os.path.join(tmp, "cache"))
    g_miss = timed("cache_miss_s", lambda: G.prepare(er, n, xr, cache=pc))
    g_hit = timed("cache_hit_s", lambda: G.prepare(er, n, xr, cache=pc))
    if (pc.misses, pc.hits) != (1, 1) or not layouts_equal(g_miss, g_hit):
        raise AssertionError(f"prep cache: {pc.misses} misses, {pc.hits} "
                             "hits, or the layouts differ")
    if not times["cache_hit_s"] < times["cache_miss_s"]:
        raise AssertionError(f"the cache hit was not faster: {times}")
    emit({"phase": "cli_host_prep", **times, "edges_real": g_miss.num_edges,
          "frac_clustered": g_miss.cluster_split.frac_clustered,
          "prep": g_miss.prep, "seconds": time.perf_counter() - t0})
    del g_hit, lay_n, lay_p

    # --- phase 40: cli.train hgcn --yaml configs/hgcn_arxiv_lp.yaml -------
    t0 = time.perf_counter()
    log = os.path.join(tmp, "lp.jsonl")
    nc_reset()
    torch.cuda.reset_peak_memory_stats()
    out = run_cli(["hgcn", "--yaml", CLI_LP_YAML, f"data_root={arxiv_dir}",
                   f"steps={CLI_STEPS}", "graph_cache=false", f"log={log}",
                   "eval_every=1"])
    launches = nc_counts()
    cli_peak = torch.cuda.max_memory_allocated()
    losses = read_log(log)
    emit({"phase": "cli_lp", "result": out, "losses": losses,
          "launches": launches, "peak_device_memory_bytes": cli_peak,
          "seconds": time.perf_counter() - t0, **card})
    if out["prep"] != "native" or out["source"] != "disk":
        raise AssertionError(f"cli lp: prep {out['prep']}, {out['source']}")
    check_losses(losses, "cli lp")
    check_cli_counts(launches, CLI_LP_PER_STEP, CLI_LP_PER_EVAL, CLI_STEPS,
                     "cli lp")
    # the CLI's step timed and profiled on the identical split, built as
    # the CLI builds it (the yaml's BFS relabeling, split_edges' defaults)
    t1 = time.perf_counter()
    split = G.split_edges(er, n, xr, seed=0, cache=False,
                          cluster_min_pair=G.cluster_min_pair_for(False))
    split_s = time.perf_counter() - t1
    cfg = hgcn.HGCNConfig(feat_dim=xr.shape[1], hidden_dims=(128, 32),
                          kind="lorentz", agg_dtype=torch.bfloat16,
                          decoder_dtype=torch.bfloat16)
    model, opt, state = hgcn.init_lp(cfg, split.graph, seed=0, device=dev)
    ga = G.to_device(split.graph, dev)
    train_pos = G.index_tensor(split.train_pos, dev)

    def lp_step():
        nonlocal state
        state, loss = hgcn.train_step_lp(model, opt, n, state, ga, train_pos)
        return loss

    torch.cuda.reset_peak_memory_stats()
    float(lp_step())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        lp_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / TRAIN_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    share = device_share(torch, lp_step, step_ms, reps=3, top_n=8)
    cs = split.graph.cluster_split
    clustered_in = np.bincount(cs.c_recv, minlength=n)
    emit({"phase": "cli_lp_profile", "split_s": split_s, "step_ms": step_ms,
          "samples_per_s": n / step_ms * 1e3, "nodes": n,
          "edges_real": split.graph.num_edges,
          "max_in_degree": int(split.graph.deg.max()),
          "rows_with_clustered_edges": int((clustered_in > 0).sum()),
          "max_clustered_in_degree": int(clustered_in.max()),
          "frac_clustered": cs.frac_clustered,
          "train_pairs": len(split.train_pos),
          "peak_device_memory_bytes": peak,
          "test_roc_auc_cli": out["roc_auc"], **share, **card})

    # --- phase 41: train_step_lp_planned on the same split ---------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 41)
    e_real = split.graph.num_edges
    bf16 = torch.bfloat16
    edge_err = max(check_segsum(torch, gen, "graph edges", ga.receivers, n,
                                33, bf16, e_real),
                   check_segsum(torch, gen, "graph edges, unaligned view",
                                ga.receivers, n, 33, bf16, -e_real))
    # the encoder's scatters on this graph's own edge sets, as in phase 31
    n_strag = int(cs.s_mask.sum())
    scatter_err = {
        "csr_segment_sum": max(check_segsum(
            torch, gen, "CLI stragglers", ga.cluster.s_recv, n, f, bf16,
            n_strag) for f in (128, 32)),
        "cluster_aggregate": max(check_cluster(
            torch, gen, "CLI clustered", ga.cluster, n, f, bf16)
            for f in (128, 32))}
    neg_u, neg_plan = hgcn.make_static_negatives(n, len(split.train_pos),
                                                 seed=0, device=dev)
    model_p, opt_p, state_p = hgcn.init_lp(cfg, split.graph, seed=0,
                                           device=dev)

    def planned_step():
        nonlocal state_p
        state_p, loss = hgcn.train_step_lp_planned(
            model_p, opt_p, n, state_p, ga, neg_u, neg_plan)
        return loss

    nc_reset()
    warm = float(planned_step())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    p_losses = [planned_step() for _ in range(PLANNED_STEPS)]
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t1) / PLANNED_STEPS * 1e3
    p_launches = nc_counts()
    p_losses = [float(v) for v in p_losses]
    check_counts(p_launches, PLANNED_PER_STEP, PLANNED_STEPS + 1,
                 "planned steps")
    check_losses(p_losses, "planned steps", first=warm)
    p_share = device_share(torch, planned_step, p_ms, reps=3, top_n=8)
    emit({"phase": "cli_planned", "warmup_loss": warm, "losses": p_losses,
          "step_ms": p_ms, "samples_per_s": n / p_ms * 1e3,
          "launches": p_launches, "edges_padded": int(ga.receivers.shape[0]),
          "graph_edge_scatter_max_abs_err": edge_err,
          "encoder_scatter_max_abs_err": scatter_err, **p_share,
          "seconds": time.perf_counter() - t0, **card})

    # --- phase 42: learn_c on the card against the CPU -------------------
    t0 = time.perf_counter()
    lc = learn_c_card_vs_cpu(torch, args, G, hgcn)
    emit({"phase": "cli_learn_c_card_vs_cpu", **lc["report"],
          "seconds": time.perf_counter() - t0})

    # --- phase 43: task=nc on the arxiv layout, attention on Cora --------
    t0 = time.perf_counter()
    nc_log = os.path.join(tmp, "nc.jsonl")
    nc_reset()
    nc_out = run_cli(["hgcn", "task=nc", "dataset=ogbn-arxiv",
                      f"data_root={arxiv_dir}", "reorder=true",
                      "hidden_dims=[128, 32]", "agg_dtype=bfloat16",
                      f"steps={CLI_NC_STEPS}", "graph_cache=false",
                      f"log={nc_log}", "eval_every=1"])
    nc_launches = nc_counts()
    nc_losses = read_log(nc_log)
    check_cli_counts(nc_launches, NC_PER_STEP, NC_PER_EVAL, CLI_NC_STEPS,
                     "cli nc")
    if not np.all(np.isfinite(nc_losses)) or nc_out["prep"] != "native":
        raise AssertionError(f"cli nc: {nc_losses}, prep {nc_out['prep']}")
    att_log = os.path.join(tmp, "att.jsonl")
    att_reset()
    nc_reset()
    att_out = run_cli(["hgcn", "dataset=cora", f"data_root={cora_dir}",
                       "use_att=true", "agg_dtype=bfloat16",
                       f"steps={CLI_ATT_STEPS}", "graph_cache=false",
                       f"log={att_log}", "eval_every=1"])
    att_launches = {**att_counts(), **nc_counts()}
    att_losses = read_log(att_log)
    check_cli_counts(att_launches, CLI_ATT_PER_STEP, CLI_ATT_PER_EVAL,
                     CLI_ATT_STEPS, "cli attention on Cora")
    for name in ("cluster_att_fwd", "cluster_att_bwd", "cluster_aggregate"):
        if att_launches[name]:
            raise AssertionError(f"cli attention on Cora: {name} launched "
                                 "on a graph without a cluster split")
    if not np.all(np.isfinite(att_losses)):
        raise AssertionError(f"cli attention on Cora: {att_losses}")
    emit({"phase": "cli_nc_and_att", "nc_result": nc_out,
          "nc_losses": nc_losses, "nc_launches": nc_launches,
          "att_result": att_out, "att_losses": att_losses,
          "att_launches": att_launches,
          "seconds": time.perf_counter() - t0, **card})
    return {"launches_lp": launches, "launches_planned": p_launches,
            "launches_nc": nc_launches, "launches_att": att_launches,
            "ga": ga, "n": n, "e_real": e_real, "n_strag": n_strag,
            "edge_err": edge_err, "scatter_err": scatter_err,
            "mlr": lc["mlr"], "split": split, "cfg": cfg,
            "train_pos": train_pos}


def learn_c_card_vs_cpu(torch, args, G, hgcn) -> dict:
    """Phase 42: two steps each of LP (pairs and plain) and NC with
    learned curvature on a 20,000-node graph of the arxiv layout's kind,
    on the card and on the CPU from the same parameters and negatives:
    losses and the last layer's learned curvature within rel 2e-2 (the
    bf16 lanes), that curvature moved off its start.  The first layer's
    curvature has a gradient of rounding noise (the next layer's logmap0
    at c undoes its expmap0 at c), which AdamW turns into steps of about
    ±lr either way: it is reported, not held.  Then ``hyp_mlr`` with the
    NC head's learned (device) curvature against its plain version,
    ``dc`` included, launched twice for the same bits."""
    from hyperspace_torch.benchmarks import hgcn_bench as B
    from hyperspace_torch.kernels.mlr import hyp_mlr, hyp_mlr_plain
    from hyperspace_torch.manifolds.maps import lorentz_to_ball

    m = round(B.ARXIV_EDGES * LEARN_C_NODES / B.ARXIV_NODES)
    edges, x, labels, k = G.community_power_law_graph(
        LEARN_C_NODES, m, seed=args.seed)
    edges, x, labels, _ = G.apply_locality_order(edges, x, labels,
                                                 cache=False)
    split = G.split_edges(edges, LEARN_C_NODES, x, seed=0, cache=False)
    tr, va, te = G.node_split_masks(LEARN_C_NODES, seed=0)
    g_nc = G.prepare(edges, LEARN_C_NODES, x, labels=labels, num_classes=k,
                     train_mask=tr, val_mask=va, test_mask=te, cache=False)
    if split.graph.cluster_split is None or g_nc.cluster_split is None:
        raise AssertionError("the 20,000-node graphs have no cluster split")
    base = dict(feat_dim=x.shape[1], hidden_dims=(128, 32), learn_c=True,
                agg_dtype=torch.bfloat16)
    cfg_lp = hgcn.HGCNConfig(decoder_dtype=torch.bfloat16, **base)
    cfg_nc = hgcn.HGCNConfig(num_classes=k, **base)
    n, p = LEARN_C_NODES, len(split.train_pos)
    gen = torch.Generator().manual_seed(args.seed + 42)
    negs = [torch.randint(0, n, (p, 2), generator=gen, dtype=torch.int32)
            for _ in range(LEARN_C_STEPS)]
    runs, heads = {}, {}
    for where in ("cuda", "cpu"):
        dev = torch.device(where)
        ga = G.to_device(split.graph, dev)
        tp = G.index_tensor(split.train_pos, dev)
        pos = hgcn.make_planned_pairs(split.train_pos, n, dev)
        neg_u, neg_plan = hgcn.make_static_negatives(n, p, seed=0, device=dev)
        out = {}
        for kind in ("pairs", "lp"):
            model, opt, state = hgcn.init_lp(cfg_lp, split.graph, seed=0,
                                             device=dev)
            losses = []
            for neg in negs:
                if kind == "lp":
                    state, loss = hgcn.train_step_lp(model, opt, n, state, ga,
                                                     tp, neg=neg.to(dev))
                else:
                    state, loss = hgcn.train_step_lp_pairs(
                        model, opt, n, state, ga, pos, neg_u, neg_plan,
                        neg_v=neg[:, 1].contiguous().to(dev))
                losses.append(float(loss))
            out[kind] = (losses, curvatures(model))
        model, opt, state = hgcn.init_nc(cfg_nc, g_nc, seed=0, device=dev)
        gn = G.to_device(g_nc, dev)
        lab, trm = hgcn.nc_targets(g_nc, dev)
        if where == "cuda":
            heads["first_step"] = learned_head_input(torch, model, gn)
        losses = []
        for _ in range(LEARN_C_STEPS):
            state, loss = hgcn.train_step_nc(model, opt, state, gn, lab, trm)
            losses.append(float(loss))
        out["nc"] = (losses, curvatures(model))
        runs[where] = out
        if where == "cuda":
            heads["after_steps"] = learned_head_input(torch, model, gn)
    report, worst = {}, 0.0
    for kind in ("pairs", "lp", "nc"):
        (lc, cc), (lp_, cp_) = runs["cuda"][kind], runs["cpu"][kind]
        rel_l = max(abs(a - b) / abs(b) for a, b in zip(lc, lp_))
        rel_c = abs(cc[-1] - cp_[-1]) / abs(cp_[-1])
        worst = max(worst, rel_l, rel_c)
        report[kind] = {"losses_cuda": lc, "losses_cpu": lp_,
                        "c_cuda": cc, "c_cpu": cp_, "max_rel_loss_diff":
                        rel_l, "rel_c_diff_last_layer": rel_c}
        if not abs(cc[-1] - 1.0) > 1e-4:
            raise AssertionError(f"learn_c {kind}: the last layer's "
                                 f"curvature did not move: {cc}")
    if not worst <= CARD_CPU_RTOL:
        raise AssertionError(f"learn_c: card and CPU differ by {worst}")
    # hyp_mlr with the learned curvature, a device tensor: at the first
    # step's input at phase 12's tier, after the steps (rows at the
    # ball's rim) no further from float64 than the plain version, as
    # phase 31 holds it; dc through the kernel against the plain version
    err = max(check_nc_head(torch, which, heads[which], "_learned_c")
              for which in ("first_step", "after_steps"))
    xb, pb, a, c = heads["first_step"]
    c = c.clone().requires_grad_()
    got = hyp_mlr(xb, pb, a, c)
    gout = torch.randn(got.shape, generator=torch.Generator(
        device=got.device).manual_seed(args.seed + 43), device=got.device)
    (dc_k,) = torch.autograd.grad(got, c, gout)
    c2 = c.detach().clone().requires_grad_()
    (dc_p,) = torch.autograd.grad(hyp_mlr_plain(xb, pb, a, c2), c2, gout)
    dc_rel = float((dc_k - dc_p).abs() / dc_p.abs().clamp_min(1e-30))
    mlr = {"shape": list(got.shape) + [xb.shape[1]], "max_abs_err": err,
           "dc_kernel": float(dc_k), "dc_plain": float(dc_p),
           "dc_rel_diff": dc_rel, "c": float(c.detach())}
    emit({"phase": "check", "kernel": "hyp_mlr", "input": "learned_c_dc",
          **mlr})
    if not dc_rel <= MLR_RTOL:
        raise AssertionError(f"hyp_mlr with a device c: {mlr}")
    report["learned_c_first_layer_note"] = (
        "gradient of rounding noise; reported, not held")
    return {"report": report, "mlr": mlr}


def learned_head_input(torch, model, ga):
    """(x, p, a, c) as the NC head hands them to ``hyp_mlr`` with learned
    curvature: c the last layer's, a device tensor."""
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.manifolds.maps import lorentz_to_ball

    with torch.no_grad():
        z, m = model.encoder(ga)
        c = m.c.detach()
        return (lorentz_to_ball(z, c).contiguous(),
                PoincareBall(c).expmap0(model.head.p_tangent).contiguous(),
                model.head.a.detach().contiguous(), c)


def curvatures(model) -> list:
    """Every layer's learned curvature, first to last."""
    enc = model.encoder
    return [float(getattr(enc, f"conv{i}").out_curvature().detach())
            for i in range(len(enc.cfg.hidden_dims))]


def cli_kernel_fields(torch, cp: dict, kernels: list) -> None:
    """Add the CLI paths to the kernels line (``*_hgcn_cli*`` keys): the
    launches of B1 and B2 in the LP run, the planned steps and the NC run
    (per step and per evaluation), the attention kernels' on Cora; B1 at
    the arxiv layout's straggler scatter (F 128) and at graph_edge_sqdist's
    [E, 33] bf16 scatter, B2 at its clustered pairs (F 128), each with its
    bound, the library call's time (``index_add_``, ``torch.sparse.mm``)
    and its largest error on these edge sets; and ``hyp_mlr`` at the NC
    head's shape with the curvature as a device tensor and as a number."""
    from hyperspace_torch.kernels.cluster import cluster_aggregate
    from hyperspace_torch.kernels.mlr import hyp_mlr, hyp_mlr_plain
    from hyperspace_torch.kernels.segment import csr_segment_sum

    ga, n, e_real = cp["ga"], cp["n"], cp["e_real"]
    dev = ga.receivers.device
    gen = torch.Generator(device=dev).manual_seed(38)
    r = ga.receivers
    vals = torch.randn(r.shape[0], 33, generator=gen, device=dev)
    vals[e_real:] = 0
    v16 = vals.to(torch.bfloat16)
    r64 = r.long()
    agg, n_strag = ga.cluster, cp["n_strag"]
    s_vals = torch.randn(agg.s_recv.shape[0], 128, generator=gen, device=dev)
    s_vals[n_strag:] = 0
    s16, s64 = s_vals.to(torch.bfloat16), agg.s_recv.long()
    e_c = agg.c_recv.shape[0]
    h16 = torch.randn(n, 128, generator=gen, device=dev).to(torch.bfloat16)
    h32 = h16.float()
    w_csr = torch.sparse_coo_tensor(
        torch.stack([agg.c_recv.long(), agg.c_send.long()]), agg.c_wf,
        (n, n)).coalesce().to_sparse_csr()
    rng = np.random.default_rng(38)
    nn_, kk, dd = MLR_NC_SHAPE
    xb = torch.as_tensor(rng.standard_normal((nn_, dd)), dtype=torch.float32,
                         device=dev)
    xb *= 0.9 / xb.norm(dim=1, keepdim=True).clamp_min(1.0)
    p = torch.as_tensor(rng.standard_normal((kk, dd)) * 0.05,
                        dtype=torch.float32, device=dev)
    a = torch.as_tensor(rng.standard_normal((kk, dd)) * 0.1,
                        dtype=torch.float32, device=dev)
    c_dev = torch.tensor(C, device=dev)
    for e in kernels:
        name = e["name"]
        for run, per_step, per_eval, key in (
                ("launches_lp", CLI_LP_PER_STEP, CLI_LP_PER_EVAL, "hgcn_cli"),
                ("launches_planned", PLANNED_PER_STEP, {}, "planned"),
                ("launches_nc", NC_PER_STEP, NC_PER_EVAL, "hgcn_cli_nc"),
                ("launches_att", CLI_ATT_PER_STEP, CLI_ATT_PER_EVAL,
                 "hgcn_cli_att_cora")):
            if name in cp[run]:
                e.update({f"launches_{key}": cp[run][name],
                          f"launches_per_step_{key}": per_step.get(name, 0),
                          f"launches_per_eval_{key}": per_eval.get(name, 0)})
        if name == "cluster_aggregate":
            e.update({
                "shape_hgcn_cli": [n, 128, e_c],
                "ms_hgcn_cli": device_ms(torch, lambda: cluster_aggregate(
                    h16, agg.c_wf, agg.c_recv, agg.c_send, None, n,
                    rows=agg.c_rows)),
                "bound_ms_hgcn_cli": bound_ms(*cluster_cost(e_c, 128, n, 2))[0],
                "library_ms_hgcn_cli": device_ms(
                    torch, lambda: torch.sparse.mm(w_csr, h32)),
                "max_abs_err_hgcn_cli": cp["scatter_err"]["cluster_aggregate"]})
        if name == "csr_segment_sum":
            e.update({
                "shape_hgcn_cli": [int(agg.s_recv.shape[0]), 128, n],
                "ms_hgcn_cli": device_ms(
                    torch, lambda: csr_segment_sum(s16, agg.s_recv, None, n)),
                "bound_ms_hgcn_cli": bound_ms(*segment_cost(n_strag, 128, n,
                                                       2))[0],
                "library_ms_hgcn_cli": device_ms(
                    torch, lambda: torch.zeros((n, 128), device=dev
                                               ).index_add_(0, s64, s_vals)),
                "max_abs_err_hgcn_cli": cp["scatter_err"]["csr_segment_sum"],
                "shape_graph_edges_hgcn_cli": [int(r.shape[0]), 33, n],
                "ms_graph_edges_hgcn_cli": device_ms(
                    torch, lambda: csr_segment_sum(v16, r, None, n)),
                "bound_ms_graph_edges_hgcn_cli": bound_ms(*segment_cost(
                    e_real, 33, n, 2))[0],
                "library_ms_graph_edges_hgcn_cli": device_ms(
                    torch, lambda: torch.zeros((n, 33), device=dev
                                               ).index_add_(0, r64, vals)),
                "max_abs_err_graph_edges_hgcn_cli": cp["edge_err"]})
        if name == "hyp_mlr":
            e.update({
                "ms_nc_device_c": device_ms(
                    torch, lambda: hyp_mlr(xb, p, a, c_dev)),
                "ms_nc_number_c": device_ms(
                    torch, lambda: hyp_mlr(xb, p, a, C)),
                "plain_ms_nc_device_c": device_ms(
                    torch, lambda: hyp_mlr_plain(xb, p, a, c_dev), reps=5),
                "bound_ms_nc_device_c": bound_ms(*mlr_cost(
                    nn_, kk, dd))[0],
                "shape_nc_device_c": [nn_, kk, dd],
                "max_abs_err_learned_c": cp["mlr"]["max_abs_err"],
                "dc_rel_diff_learned_c": cp["mlr"]["dc_rel_diff"]})


# --- phases 44-49: product embeddings and the train runtime ----------------

PRODUCT_TREE = (5, 9)              # 66,430 nodes, 323,847 closure pairs
PRODUCT_CHUNK = 32                 # the graphed chunk (workloads_bench)
PRODUCT_CARD_CPU_RTOL = 1e-4       # all float32
PRODUCT_CLI_YAML = os.path.join("configs", "product_multihost.yaml")
PRODUCT_CLI_BIG_STEPS = 1024       # 32 graphed chunks on the big closure
RESUME_STEPS = 16                  # N: straight twice, N/2 + resume to N
RESUME_CHUNK = 8
RESUME_RUNS = {
    "poincare": ["poincare", f"scan_chunk={RESUME_CHUNK}"],
    "hvae": ["hvae", "--yaml", HVAE_CLI_YAML, f"scan_chunk={RESUME_CHUNK}"],
    "product": ["product", f"scan_chunk={RESUME_CHUNK}"],
    "hybonet": ["hybonet", "--yaml", HB_CLI_YAML],
    "hgcn": ["hgcn", "hidden_dims=[32, 16]", "graph_cache=false"],
}
ACCUM_STEPS = 8
ACCUM_CARD_CPU_RTOL = 1e-4


def tree_gap(torch, a, b, path="") -> float:
    """The largest absolute difference between two checkpoint trees'
    float tensors; integer tensors and numbers (step counts, generator
    states) must be equal."""
    if isinstance(a, torch.Tensor):
        if a.is_floating_point():
            return float((a.double() - b.double()).abs().max()) \
                if a.numel() else 0.0
        if not torch.equal(a, b):
            raise AssertionError(f"{path}: integer state differs")
        return 0.0
    if isinstance(a, dict):
        return max([tree_gap(torch, a[k], b[k], f"{path}.{k}") for k in a]
                   or [0.0])
    if isinstance(a, list):
        return max([tree_gap(torch, x, y, f"{path}[{i}]")
                    for i, (x, y) in enumerate(zip(a, b))] or [0.0])
    if a != b:
        raise AssertionError(f"{path}: {a} != {b}")
    return 0.0


def product_bench(torch, card: dict) -> dict:
    """Phase 44: the ``workloads_bench`` product leg at 66,430 nodes,
    the graphed chunk's busy and idle share, and the chunk against the
    same steps run eagerly from the same state and generator."""
    from hyperspace_torch.benchmarks import workloads_bench as W
    from hyperspace_torch.models import product_embed as pme
    from hyperspace_torch.train import loop

    t0 = time.perf_counter()
    leg = W.setup_product_leg(device="cuda", seed=0, tree=PRODUCT_TREE)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    res = W.run_product_leg(leg, steps=20, repeats=3, chunk=PRODUCT_CHUNK)
    peak = torch.cuda.max_memory_allocated()
    losses = res.pop("losses")
    share = device_share(torch, leg.step, res["step_ms"], reps=5, top_n=5)
    cfg, opt, pairs = leg.cfg, leg.opt, leg.pairs
    chunk = loop.make_chunked_stepper(
        lambda st, p: pme.train_step(cfg, opt, st, p), PRODUCT_CHUNK)
    state = {"st": leg.state}

    def run_chunk():
        state["st"], _ = chunk(state["st"], pairs)

    run_chunk()                                     # captures
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(3):
        run_chunk()
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t1) / 3 * 1e3
    chunk_share = device_share(torch, run_chunk, chunk_ms, reps=3, top_n=5)
    # the chunk against its steps run eagerly, from one state
    eager, graphed = pe_clone(torch, state["st"]), pe_clone(torch,
                                                           state["st"])
    eager_losses = []
    for _ in range(PRODUCT_CHUNK):
        eager, loss = pme.train_step(cfg, opt, eager, pairs)
        eager_losses.append(loss)
    graphed, g_losses = chunk(graphed, pairs)
    e_losses = torch.stack(eager_losses)
    te, tg = eager.params.table, graphed.params.table
    agree = {
        "table_bitwise": bool(torch.equal(te, tg)),
        "c_raw_bitwise": bool(torch.equal(eager.params.c_raw,
                                          graphed.params.c_raw)),
        "losses_bitwise": bool(torch.equal(e_losses, g_losses)),
        "table_rel": float(torch.linalg.vector_norm(te - tg)
                           / torch.linalg.vector_norm(te)),
        "c_raw_rel": float(((eager.params.c_raw - graphed.params.c_raw).abs()
                            / eager.params.c_raw.abs()).max()),
        "loss_rel": float(((e_losses - g_losses).abs()
                           / e_losses.abs()).max())}
    out = {**res, **share, "chunk_ms": chunk_ms,
           "chunk_device_busy_ms": chunk_share["device_busy_ms"],
           "chunk_device_idle_share": chunk_share["device_idle_share"],
           "chunk_top_device_ms": chunk_share["top_device_ms"],
           "graphed_vs_eager": agree, "setup_s": setup_s,
           "first_loss": losses[0], "last_loss": losses[-1],
           "peak_device_memory_bytes": peak}
    emit({"phase": "product_bench", **out,
          "seconds": time.perf_counter() - t0, **card})
    if not np.all(np.isfinite(losses)) or not all(
            np.isfinite(v) for k, v in agree.items() if k.endswith("rel")):
        raise AssertionError(f"product bench: non-finite values {agree}")
    if agree["table_rel"] > PRODUCT_CARD_CPU_RTOL:
        raise AssertionError(f"product: the graphed chunk is beyond rel "
                             f"{PRODUCT_CARD_CPU_RTOL} of its eager steps: "
                             f"{agree}")
    return out


def product_card_vs_cpu(torch, args) -> dict:
    """Phase 45: three steps on given ids (collisions included) from one
    state at 66,430 nodes, batch 1,024, on the card and on the CPU."""
    from hyperspace_torch.data.wordnet import synthetic_tree
    from hyperspace_torch.models import product_embed as pme

    t0 = time.perf_counter()
    ds = synthetic_tree(*PRODUCT_TREE)
    cfg = pme.ProductEmbedConfig(num_nodes=ds.num_nodes, batch_size=1024,
                                 burnin_steps=1)
    rng = np.random.default_rng(args.seed + 44)
    ids = []
    for _ in range(3):
        rows = rng.integers(0, len(ds.pairs), cfg.batch_size)
        u, v = ds.pairs[rows, 0], ds.pairs[rows, 1]
        neg = rng.integers(0, cfg.num_nodes, (cfg.batch_size,
                                              cfg.neg_samples))
        neg[:8, 0] = u[:8]                          # collisions with u
        ids.append((u, v, neg))
    runs = {}
    for where in ("cuda", "cpu"):
        st, opt = pme.init_state(cfg, args.seed, device="cpu")
        st = pme.TrainState(
            pme.Params(*(t.to(where) for t in st.params)),
            type(st.curv_opt_state)(*(t.to(where)
                                      for t in st.curv_opt_state)),
            torch.Generator(device=where), st.step.to(where))
        losses = []
        for u, v, neg in ids:
            st, loss = pme.step_on_batch(cfg, opt, st, *(
                torch.as_tensor(a, device=where) for a in (u, v, neg)))
            losses.append(float(loss))
        runs[where] = (st.params.table.cpu(), st.params.c_raw.cpu(), losses)
    (tg, cg, lg), (tc, cc, lc) = runs["cuda"], runs["cpu"]
    rep = {"table_rel": float(torch.linalg.vector_norm(tg - tc)
                              / torch.linalg.vector_norm(tc)),
           "c_raw_rel": float(((cg - cc).abs() / cc.abs()).max()),
           "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(lg, lc)),
           "losses_cuda": lg, "losses_cpu": lc,
           "c_raw_cuda": cg.tolist(), "c_raw_cpu": cc.tolist()}
    emit({"phase": "product_card_vs_cpu", **rep,
          "seconds": time.perf_counter() - t0})
    if not max(rep["table_rel"], rep["c_raw_rel"],
               rep["loss_rel"]) <= PRODUCT_CARD_CPU_RTOL:
        raise AssertionError(f"product: card and CPU differ: {rep}")
    return rep


def product_cli(torch, tmp: str, card: dict) -> dict:
    """Phase 46: ``cli.train product`` at its config, then graphed chunks
    on a 66,430-node closure TSV written here."""
    from hyperspace_torch.data.wordnet import synthetic_tree

    out = {}
    for name, argv in (
            ("config", ["product", "--yaml", PRODUCT_CLI_YAML,
                        "eval_every=100"]),
            ("big", ["product", "scan_chunk=32", "batch_size=1024",
                     f"steps={PRODUCT_CLI_BIG_STEPS}", "eval_every=256"])):
        t0 = time.perf_counter()
        if name == "big":
            ds = synthetic_tree(*PRODUCT_TREE)
            tsv = os.path.join(tmp, "closure.tsv")
            with open(tsv, "w") as f:
                f.writelines(f"n{u}\tn{v}\n" for u, v in ds.pairs)
            argv = argv + [f"data_root={tsv}"]
        log = os.path.join(tmp, f"product_{name}.jsonl")
        res = run_cli(argv + [f"log={log}"])
        losses = read_log(log)
        out[name] = {**res, "logged_losses": losses,
                     "seconds": time.perf_counter() - t0}
        emit({"phase": "product_cli", "run": name, "argv": argv,
              **out[name], **card})
        check_losses(losses, f"product CLI {name}")
        if not max(abs(c - 1.0) for c in res["curvatures"]) > 1e-4:
            raise AssertionError(f"product CLI {name}: the curvatures did "
                                 f"not move: {res['curvatures']}")
        if not 0.0 < res["map"] <= 1.0:
            raise AssertionError(f"product CLI {name}: {res}")
    return out


def resume_runs(torch, tmp: str, card: dict) -> dict:
    """Phase 47: each CLI workload N steps straight twice, and N/2 with
    ``ckpt_dir`` then resumed to N; the resumed run's final checkpoint
    must be as close to the straight one's as the two straight runs are
    to each other (bitwise where they are).  Saves are timed."""
    from hyperspace_torch.train import checkpoint as ck

    saves = []
    real_save = ck.CheckpointManager.save

    def timed_save(self, step, state, *, force=False):
        t = time.perf_counter()
        started = real_save(self, step, state, force=force)
        if started:
            saves.append(time.perf_counter() - t)
        return started

    ck.CheckpointManager.save = timed_save
    out = {}
    try:
        for name, argv in RESUME_RUNS.items():
            t0 = time.perf_counter()
            saves.clear()
            base = argv + ["ckpt_every=4", "eval_every=1"]

            def run(tag, steps, *extra):
                d = os.path.join(tmp, f"resume_{name}_{tag}")
                res = run_cli(base + [f"steps={steps}", f"ckpt_dir={d}",
                                      *extra])
                res.pop("seconds", None)
                return res, d

            flags = cudnn_flags(torch, True) if name == "hvae" else \
                contextlib.nullcontext()
            with flags:
                (r1, d1), (r2, d2) = (run(t, RESUME_STEPS)
                                      for t in ("a1", "a2"))
                run("b", RESUME_STEPS // 2)
                rb, db = run("b", RESUME_STEPS, "resume=true")
            t1, s1 = ck.restore_params_only(d1)
            t2, _ = ck.restore_params_only(d2)
            tb, sb = ck.restore_params_only(db)
            spread, gap = tree_gap(torch, t1, t2), tree_gap(torch, t1, tb)
            out[name] = {
                "straight_gap": spread, "resumed_gap": gap,
                "bitwise": gap == 0.0, "results_equal": rb == r1,
                "result": rb, "step": sb,
                "save_s": sorted(saves), "ckpt_bytes": ck.dir_bytes(
                    os.path.join(db, str(sb))),
                "cudnn_deterministic": name == "hvae",
                "seconds": time.perf_counter() - t0}
            emit({"phase": "resume", "workload": name, **out[name], **card})
            if sb != s1 or not gap <= spread:
                raise AssertionError(
                    f"resume {name}: the resumed run is {gap} from the "
                    f"straight one, two straight runs {spread} apart "
                    f"(steps {s1}, {sb})")
    finally:
        ck.CheckpointManager.save = real_save
    return out


def accum_card_vs_cpu(torch, args) -> dict:
    """Phase 48, second half: four microsteps of accum=2 on given batches
    from one state, HyboNet (AdamW) and the HVAE (Adam), on the card and
    on the CPU."""
    from hyperspace_torch.data.text import synthetic_text
    from hyperspace_torch.models import hvae, hybonet
    from hyperspace_torch.optim.accum import with_grad_accumulation

    ds = synthetic_text(num_samples=64, vocab_size=512, num_classes=4,
                        max_len=32, seed=args.seed)
    hcfg = hybonet.HyboNetConfig(dim=64, num_heads=4, num_layers=2,
                                 batch_size=16)
    vcfg = hvae_cfg("poincare")
    rng = np.random.default_rng(args.seed + 48)
    images = rng.uniform(0, 1, (4, 16, 28, 28)).astype(np.float32)
    eps = rng.standard_normal((4, 16, vcfg.latent_dim)).astype(np.float32)
    runs = {}
    for where in ("cuda", "cpu"):
        model, opt, st = hybonet.init_model(hcfg, seed=args.seed,
                                            device=where)
        opt, _ = with_grad_accumulation(opt, None, 2)
        hl = []
        for i in range(4):
            t, m, y = (torch.as_tensor(a[16 * i:16 * i + 16], device=where)
                       for a in (ds.tokens, ds.mask, ds.labels))
            st, loss = hybonet.train_step(model, opt, st, t, m, y)
            hl.append(float(loss))
        hp = torch.cat([p.detach().reshape(-1).cpu()
                        for p in model.parameters()])
        vmodel, vopt, vst = hvae.init_model(vcfg, args.seed, where)
        vopt, vstate = with_grad_accumulation(vopt, vst.params, 2)
        vst = vst._replace(opt_state=vstate)
        vl = []
        with cudnn_flags(torch, False):
            for i in range(4):
                vst, loss, _r, _k = hvae.train_step(
                    vmodel, vopt, vst, torch.as_tensor(images[i],
                                                       device=where),
                    eps=torch.as_tensor(eps[i], device=where))
                vl.append(float(loss))
        vp = torch.cat([t.reshape(-1).cpu() for t in
                        torch.utils._pytree.tree_leaves(vst.params)])
        runs[where] = (hl, hp, int(opt.inner.count), vl, vp,
                       int(vst.opt_state.inner_opt_state.count))
    g, c = runs["cuda"], runs["cpu"]
    rep = {"hybonet_loss_rel": max(abs(a - b) / abs(b)
                                   for a, b in zip(g[0], c[0])),
           "hybonet_param_rel": float(torch.linalg.vector_norm(g[1] - c[1])
                                      / torch.linalg.vector_norm(c[1])),
           "hvae_loss_rel": max(abs(a - b) / abs(b)
                                for a, b in zip(g[3], c[3])),
           "hvae_param_rel": float(torch.linalg.vector_norm(g[4] - c[4])
                                   / torch.linalg.vector_norm(c[4])),
           "inner_counts": [g[2], g[5], c[2], c[5]]}
    if rep["inner_counts"] != [2, 2, 2, 2] or not max(
            v for k, v in rep.items() if k.endswith("rel")) \
            <= ACCUM_CARD_CPU_RTOL:
        raise AssertionError(f"accum: card and CPU differ: {rep}")
    return rep


def accum_runs(torch, args, tmp: str, card: dict) -> dict:
    """Phase 48: ``accum=2`` through the CLI for HyboNet and the HVAE
    (graphed chunks), the inner optimizer's count read back from the
    final checkpoint; then the card against the CPU."""
    from hyperspace_torch.train.checkpoint import restore_params_only

    t0 = time.perf_counter()
    out = {}
    for name, argv, count in (
            ("hybonet", ["hybonet", "--yaml", HB_CLI_YAML],
             ("opt", "inner", "count")),
            ("hvae", ["hvae", "--yaml", HVAE_CLI_YAML, "scan_chunk=4"],
             ("opt_state", "inner_opt_state", "count"))):
        d = os.path.join(tmp, f"accum_{name}")
        log = os.path.join(tmp, f"accum_{name}.jsonl")
        res = run_cli(argv + ["accum=2", f"steps={ACCUM_STEPS}",
                              f"ckpt_dir={d}", f"log={log}",
                              "eval_every=1"])
        tree, _ = restore_params_only(d)
        node = tree
        for key in count:
            node = node[key]
        losses = read_log(log)
        out[name] = {"result": res, "losses": losses,
                     "inner_count": int(node)}
        if int(node) != ACCUM_STEPS // 2 or not np.all(np.isfinite(losses)):
            raise AssertionError(f"accum {name}: {out[name]}")
    out["card_vs_cpu"] = accum_card_vs_cpu(torch, args)
    emit({"phase": "accum", **out, "seconds": time.perf_counter() - t0,
          **card})
    return out


def health_runs(torch, tmp: str, card: dict) -> dict:
    """Phase 49: ``health_every=1`` on ``product`` and ``poincare``: a
    healthy run logs ``health/*`` records, every one ok; a table pushed
    to the rim (a learning rate of 1,000 without burn-in) flags, and
    with ``health_abort=1`` the run raises."""
    t0 = time.perf_counter()
    out = {}
    for name, argv in (
            ("product", ["product", "scan_chunk=8", "steps=200"]),
            ("poincare", ["poincare", "scan_chunk=8", "steps=200"])):
        rim = [("lr_table" if name == "product" else "lr") + "=1000",
               "burnin_steps=0"]
        for mode, extra in (("healthy", []), ("rim", rim)):
            log = os.path.join(tmp, f"health_{name}_{mode}.jsonl")
            run_cli(argv + ["health_every=1", f"log={log}", *extra])
            with open(log) as f:
                recs = [json.loads(s) for s in f]
            health = [r for r in recs if "health/ok" in r]
            ok = [r["health/ok"] for r in health]
            out[f"{name}_{mode}"] = {
                "records": len(health), "ok": sum(ok),
                "margin_min": min(r["health/boundary_margin_min"]
                                  for r in health)}
            if len(health) != 25 or (mode == "healthy") != all(ok) or (
                    mode == "rim" and any(ok[-5:])):
                raise AssertionError(f"health {name} {mode}: "
                                     f"{out[f'{name}_{mode}']}")
        try:
            run_cli(argv + ["health_every=1", "health_abort=1", *rim])
        except FloatingPointError as e:
            out[f"{name}_abort"] = str(e)
        else:
            raise AssertionError(f"health {name}: health_abort=1 did not "
                                 "raise on the rim")
    emit({"phase": "health", **out, "seconds": time.perf_counter() - t0,
          **card})
    return out


SPEC_KINDS = ("euclidean", "sphere", "product")
# phase 58's runs a spec: every lane exact (PQ on the exported product
# artifact, whose payload it ships), both modes where the fused scan
# takes the spec (euclidean), f32 and one more lane probed
SPEC_RUNS = {
    "euclidean": [(p, 0) for p in ("f32", "bf16", "int8", "int4")]
    + [("f32", 8), ("int8", 8)],
    "sphere": [(p, 0) for p in ("f32", "bf16", "int8", "int4")]
    + [("f32", 8), ("int8", 8)],
    "product": [(p, 0) for p in ("f32", "bf16", "int8", "int4", "pq")]
    + [("f32", 8), ("pq", 8)],
}
PRODUCT_EXPORT_STEPS = 64


def spec_paths(torch, args, tmp: str, card: dict) -> dict:
    """Phase 58: the euclidean and sphere specs on 82,115 × 10 tables
    from the seed (their indexes built on the card with the export
    defaults), and a product artifact exported by ``cli.serve export
    workload=product index=1 quant=pq`` from a ``cli.train product``
    checkpoint on phase 46's 66,430-node closure, served through the
    ``serve`` loop on every lane: each served distance the manifold's
    own f32 distance of its id, the f32 exact answers against a float64
    brute force on 16 queries, recall@10 of each run against them, and
    the launches of the fused scan where the spec takes it (euclidean)
    and of none where it does not."""
    from hyperspace_torch.cli import serve as cli_serve
    from hyperspace_torch.kernels import _support
    from hyperspace_torch.serve import export_artifact, load_artifact
    from hyperspace_torch.serve.artifact import manifold_from_spec
    from hyperspace_torch.serve.index import auto_ncells, build_index

    t0 = time.perf_counter()
    rng = np.random.default_rng([args.seed, 58])
    arts = {}
    for kind in ("euclidean", "sphere"):
        x = rng.standard_normal((ROWS, DIM)).astype(np.float32)
        spec = ("euclidean", 0.0) if kind == "euclidean" else ("sphere", C)
        if kind == "sphere":
            x /= np.linalg.norm(x, axis=1, keepdims=True)
        path = os.path.join(tmp, f"spec_{kind}")
        export_artifact(path, x, spec,
                        index=build_index(x, spec, auto_ncells(ROWS)))
        arts[kind] = path
    ck = os.path.join(tmp, "spec_product_ck")
    run_cli(["product", "scan_chunk=32", "batch_size=1024",
             f"steps={PRODUCT_EXPORT_STEPS}",
             f"data_root={os.path.join(tmp, 'closure.tsv')}",
             f"ckpt_dir={ck}", f"ckpt_every={PRODUCT_EXPORT_STEPS}"])
    arts["product"] = os.path.join(tmp, "spec_product")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_serve.main(["export", "workload=product", f"ckpt={ck}",
                        f"out={arts['product']}", "index=1", "quant=pq"])
    exp = json.loads(buf.getvalue().strip().splitlines()[-1])
    setup_s = time.perf_counter() - t0
    out = {"setup_s": setup_s, "product_export": exp}
    for kind in SPEC_KINDS:
        art = load_artifact(arts[kind])
        n = art.num_nodes
        man = manifold_from_spec(art.manifold_spec)
        tab = torch.as_tensor(art.table, device="cuda")
        ids = rng.choice(n, BATCH, replace=False)
        qrows = tab[torch.as_tensor(ids, device="cuda").long()]
        lines = "\n".join(json.dumps(r) for r in (
            {"op": "topk", "ids": ids.tolist(), "k": K},
            {"op": "stats"})) + "\n"
        modes = ("two_stage", "fused") if kind == "euclidean" else (
            "two_stage",)
        answers, rep = {}, {}
        for prec, npb in SPEC_RUNS[kind]:
            for mode in modes:
                lane_reset()
                buf = io.StringIO()
                cli_serve.run_serve(cli_serve.ServeConfig(
                    artifact=arts[kind], scan_mode=mode, precision=prec,
                    nprobe=npb), stdin=io.StringIO(lines), stdout=buf)
                got = lane_counts()
                resp = [json.loads(s) for s in buf.getvalue().splitlines()]
                tag = f"{kind}/{prec}/{npb}/{mode}"
                if len(resp) != 2 or any("error" in r for r in resp):
                    raise AssertionError(f"{tag}: {resp}")
                nb = np.asarray(resp[0]["neighbors"])
                ds = np.asarray(resp[0]["dists"], np.float64)
                if nb.shape != (BATCH, K) or not np.all(np.isfinite(ds)) \
                        or np.any(np.diff(ds, axis=1) < 0):
                    raise AssertionError(f"{tag}: bad answers")
                # rescored lanes: the f32 distance of the id; f32 served
                # by the fused scan's Gram form: the serving tier
                f32 = man.dist(qrows[:, None, :], tab[torch.as_tensor(
                    nb, device="cuda").long()]).double()
                rt, at = ((RTOL, ATOL) if prec == "f32"
                          else (PQ_F32_RTOL, PQ_F32_ATOL))
                over = int(((torch.as_tensor(ds, device="cuda") - f32).abs()
                            > at + rt * f32.abs()).sum())
                scans = got["scan_topk"] + got["scan_topk_cand"] + got[
                    "scan_topk_pq"]
                takes = kind == "euclidean" and mode == "fused"
                if over or bool(scans) != takes:
                    raise AssertionError(f"{tag}: {over} distances off "
                                         f"their f32 distance, launches "
                                         f"{got}")
                answers[prec, npb, mode] = nb
                rep[f"{prec}_nprobe{npb}_{mode}"] = {
                    "launches": {k: v for k, v in got.items() if v}}
        # the f32 exact answers against float64 on 16 queries
        t64 = tab.double()
        q16 = torch.as_tensor(ids[:16], device="cuda").long()
        d64 = man.dist(t64[q16][:, None, :], t64[None, :, :])
        d64[torch.arange(16, device="cuda"), q16] = float("inf")
        ref_d, ref_i = torch.sort(d64, dim=1, stable=True)
        exact = answers["f32", 0, "two_stage"]
        f32_d = man.dist(qrows[:16, None, :], tab[torch.as_tensor(
            exact[:16], device="cuda").long()]).double()
        bad = _support.topk_disagreements(
            exact[:16], f32_d.cpu().numpy(), ref_i[:, :K].cpu().numpy(),
            ref_d[:, :K].cpu().numpy(), rtol=TRUTH_RTOL, atol=TRUTH_ATOL)
        for key, nb in answers.items():
            rep[f"{key[0]}_nprobe{key[1]}_{key[2]}"]["recall_at_10"] = float(
                np.mean([len(set(x) & set(y)) / K
                         for x, y in zip(nb, exact)]))
        out[kind] = {"rows": n, "dim": int(art.dim),
                     "spec": art.manifold_spec,
                     "rows_disagreeing_with_f64": bad, "runs": rep}
        emit({"phase": "spec_serve", "kind": kind, **out[kind], **card})
        if bad:
            raise AssertionError(f"{kind}: f32 exact answers disagree with "
                                 f"float64 on {bad} rows")
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "spec_paths_done", "seconds": out["seconds"],
          "setup_s": setup_s, **card})
    return out


def runtime_path(torch, args, card: dict) -> dict:
    """Phases 44-49 (after every profiled time of the earlier phases),
    and 58, which serves a product checkpoint trained on phase 46's
    closure."""
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=work)
    try:
        out = {"bench": product_bench(torch, card),
               "card_vs_cpu": product_card_vs_cpu(torch, args),
               "cli": product_cli(torch, tmp, card),
               "resume": resume_runs(torch, tmp, card),
               "accum": accum_runs(torch, args, tmp, card),
               "health": health_runs(torch, tmp, card),
               "specs": spec_paths(torch, args, tmp, card)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# --- phases 59-62: graphed HyboNet and HGCN steps, the spine, the guard ------

GRAPH_CHUNK = 8                    # phase 59: a chunk of HyboNet steps
HGCN_CHUNK = 4                     # phase 60: a chunk of HGCN steps
GRAPHED_TIMED_CHUNKS = 4           # chunks timed after the capture
EAGER_TIMED_STEPS = 16
# the device names (patterns) of the kernels each wrapper launches once a
# call, by which a profiler trace of a replayed chunk counts them; the
# row ops by their op's template argument (pointwise.cu's ``enum Op``)
TRACED_KERNELS = {"flash_fwd": ("flash_fwd_kernel",),
                  "flash_dq": ("flash_dq_kernel",),
                  "flash_dkv": ("flash_dkv_kernel",),
                  "hyp_mlr": ("::mlr_kernel", "::pair_kernel"),
                  "csr_segment_sum": ("segsum_kernel",),
                  "cluster_aggregate": ("agg_rows_kernel",),
                  "expmap": (r"packed_kernel<\s*2\s*,",),
                  "ptransp": (r"packed_kernel<\s*6\s*,",)}
TRACE_TRIES = 3                    # a profiler may drop a launch
SPINE_STEPS, SPINE_CHUNK, SPINE_PROFILE = 128, 8, 16
GUARD_STEPS = 32


def live_gap(torch, a, b) -> float:
    """:func:`tree_gap` of two live states (``checkpoint.to_tree``)."""
    from hyperspace_torch.train.checkpoint import _to_host, to_tree

    return tree_gap(torch, _to_host(to_tree(a)), _to_host(to_tree(b)))


def traced_launches(torch, fn, names) -> dict:
    """``{name: n}``: the kernels of the wrappers ``names`` that one call
    of ``fn`` ran on the card, counted by their device names
    (``TRACED_KERNELS``) in a ``torch.profiler`` trace of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(names, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for n in names:
                if any(re.search(p, e.name) for p in TRACED_KERNELS[n]):
                    counts[n] += 1
    return counts


def graphed_vs_eager(torch, fresh, step, k: int, counters, reset, counts,
                     per_step: dict, what: str) -> dict:
    """A chunk of ``k`` replays of ``step`` captured on one fresh state
    (``loop.ChunkedStepper``, live) against ``k`` eager steps on two
    others, then a second chunk (replays alone, the launch counts set to
    0 before it and read after) against ``k`` more eager steps; then
    eager and graphed ms a step (host clock, ending in a sync) and the
    card's busy ms a step; then the kernels a replayed chunk ran on the
    card, counted by name in a profiler trace (``traced_launches``),
    which must be ``k`` × ``per_step``.  Bitwise equality is asked, or,
    where the two eager runs differ, a gap within theirs."""
    from hyperspace_torch.train import loop

    eager, eager2, graphed = fresh(), fresh(), fresh()
    chunk = loop.ChunkedStepper(step, k, live=True, counters=counters)
    out = {}
    for part in ("capture", "replay"):
        e_losses = torch.stack([step(eager)[1] for _ in range(k)])
        for _ in range(k):
            step(eager2)
        reset()
        _, g_losses = chunk(graphed)
        torch.cuda.synchronize()
        got = counts()
        spread, gap = live_gap(torch, eager, eager2), live_gap(torch, eager,
                                                                graphed)
        out[part] = {"eager_spread": spread, "graphed_gap": gap,
                     "bitwise": gap == 0.0 and bool(torch.equal(e_losses,
                                                                g_losses)),
                     "loss_gap": float((e_losses - g_losses).abs().max()),
                     "launches": got}
        if not (out[part]["bitwise"] or (spread > 0 and gap <= spread)):
            raise AssertionError(f"{what} ({part}): graphed {gap} from the "
                                 f"eager steps, two eager runs {spread}")
        if not torch.isfinite(g_losses).all():
            raise AssertionError(f"{what}: non-finite losses {g_losses}")
    launches = out["replay"]["launches"]
    for name, per in per_step.items():
        if launches[name] != k * per:
            raise AssertionError(f"{what}: {launches[name]} {name} launches "
                                 f"in a chunk of {k} replays, want {k} × "
                                 f"{per}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(EAGER_TIMED_STEPS):
        step(eager)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t) / EAGER_TIMED_STEPS * 1e3
    t = time.perf_counter()
    for _ in range(GRAPHED_TIMED_CHUNKS):
        chunk(graphed)
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t) / GRAPHED_TIMED_CHUNKS * 1e3
    e_share = device_share(torch, lambda: step(eager), eager_ms, reps=3,
                           top_n=3)
    g_share = device_share(torch, lambda: chunk(graphed), chunk_ms, reps=2,
                           top_n=3)
    g_busy = g_share["device_busy_ms"]
    want = {name: k * per for name, per in per_step.items()}
    traced = []
    for _ in range(TRACE_TRIES):
        traced.append(traced_launches(torch, lambda: chunk(graphed),
                                      per_step))
        if traced[-1] == want:
            break
    out["traced_launches"] = traced
    if traced[-1] != want:
        raise AssertionError(f"{what}: a replayed chunk ran {traced} on the "
                             f"card (profiler trace), want {want}")
    out.update({"eager_ms_per_step": eager_ms,
                "graphed_ms_per_step": chunk_ms / k,
                "eager_busy_ms_per_step": e_share["device_busy_ms"],
                "eager_idle_share": e_share["device_idle_share"],
                "graphed_busy_ms_per_step": (None if g_busy is None
                                             else g_busy / k),
                "graphed_idle_share": g_share["device_idle_share"],
                "graphed_top_device_ms": g_share["top_device_ms"]})
    return out


def hybonet_graphed(torch, args, card: dict) -> dict:
    """Phase 59: the CLI's HyboNet step at ``configs/hybonet_textclf.yaml``'s
    width (dim 128, 4 layers, 4 heads, batch 64) on the CLI's data, in a
    graphed chunk of 8 against 8 eager steps, at ``accum=1`` and 2."""
    from hyperspace_torch.cli import train as cli_train
    from hyperspace_torch.data import text as T
    from hyperspace_torch.models import hybonet
    from hyperspace_torch.optim.accum import with_grad_accumulation

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    keys = dict(p.split("=", 1) for p in cli_train.read_flat_yaml(
        os.path.join(REPO, HB_CLI_YAML)))
    ds, _ = T.load_text("text", None)
    tr, _ = ds.split(0.8, seed=args.seed)
    cfg = hybonet.HyboNetConfig(
        vocab_size=ds.vocab_size, num_classes=ds.num_classes,
        max_len=ds.tokens.shape[1], dim=int(keys["dim"]),
        num_layers=int(keys["num_layers"]),
        num_heads=int(keys["num_heads"]),
        batch_size=int(keys["batch_size"]))
    data = [torch.as_tensor(a, device=dev)
            for a in (tr.tokens, tr.mask, tr.labels)]

    def step(s):
        _, loss = hybonet.train_step_sampled(s.model, s.opt, s.train, *data)
        return s, loss

    per_step = {"flash_fwd": cfg.num_layers, "flash_dq": cfg.num_layers,
                "flash_dkv": cfg.num_layers, "hyp_mlr": 1}
    out = {"launches": dict.fromkeys(per_step, 0)}
    for accum in (1, 2):
        def fresh(accum=accum):
            model, opt, st = hybonet.init_model(cfg, args.seed, dev)
            opt, _ = with_grad_accumulation(opt, None, accum)
            return cli_train.ModuleState(model, opt, st)

        res = graphed_vs_eager(torch, fresh, step, GRAPH_CHUNK,
                               hybonet.path_counters(), hb_reset, hb_counts,
                               per_step, f"hybonet accum={accum}")
        for name in per_step:
            out["launches"][name] += res["replay"]["launches"][name]
        out[f"accum{accum}"] = res
        emit({"phase": "hybonet_graphed", "accum": accum,
              "config": HB_CLI_YAML, "chunk": GRAPH_CHUNK, **res,
              "seconds": time.perf_counter() - t0, **card})
    if not all(out[f"accum{a}"][p]["bitwise"] for a in (1, 2)
               for p in ("capture", "replay")):
        raise AssertionError("hybonet: a graphed chunk is not bitwise its "
                             "eager steps")
    out["seconds"] = time.perf_counter() - t0
    return out


def hgcn_graphed(torch, args, card: dict, cp: dict, tmp: str) -> dict:
    """Phase 60: the CLI's LP step on the arxiv layout of
    ``configs/hgcn_arxiv_lp.yaml`` (phase 40's split and graph; hidden
    (128, 32), bf16 lanes) in a graphed chunk of 4 against 4 eager steps;
    then ``cli.train hgcn`` with ``scan_chunk=4`` against ``scan_chunk=1``
    (twice) for NC and for the attention arm on a Cora-size layout (phase
    38's, written again), the final checkpoints compared."""
    from hyperspace_torch.cli import train as cli_train
    from hyperspace_torch.data import graphs as G
    from hyperspace_torch.models import hgcn
    from hyperspace_torch.train.checkpoint import restore_params_only

    t0 = time.perf_counter()
    split, cfg, n, ga = cp["split"], cp["cfg"], cp["n"], cp["ga"]
    train_pos, dev = cp["train_pos"], ga.receivers.device
    cora_dir = os.path.join(tmp, "cora")
    ce, cx, cl, _ = G.community_power_law_graph(seed=args.seed,
                                                **CORA_SHAPE)
    G.write_cora_layout(cora_dir, ce, (cx > 1.5).astype(np.float32), cl)

    def fresh():
        return cli_train.ModuleState(*hgcn.init_lp(cfg, split.graph, seed=0,
                                                   device=dev))

    def step(st):
        _, loss = hgcn.train_step_lp(st.model, st.opt, n, st.train, ga,
                                     train_pos)
        return st, loss

    out = {"lp": graphed_vs_eager(
        torch, fresh, step, HGCN_CHUNK, hgcn.path_counters(), nc_reset,
        nc_counts, CLI_LP_PER_STEP, "hgcn lp (arxiv layout)")}
    emit({"phase": "hgcn_graphed", "task": "lp", "config": CLI_LP_YAML,
          "chunk": HGCN_CHUNK, "nodes": n, **out["lp"],
          "seconds": time.perf_counter() - t0, **card})
    steps = 2 * HGCN_CHUNK
    for name, extra in (("nc", ["task=nc"]), ("att", ["use_att=true"])):
        argv = ["hgcn", "dataset=cora", f"data_root={cora_dir}",
                "agg_dtype=bfloat16", "graph_cache=false", f"steps={steps}",
                "ckpt_every=0", *extra]
        trees, results = {}, {}
        for tag, k in (("eager_a", 1), ("eager_b", 1),
                       ("graphed", HGCN_CHUNK)):
            d = os.path.join(tmp, f"graphed_{name}_{tag}")
            results[tag] = run_cli(argv + [f"scan_chunk={k}",
                                           f"ckpt_dir={d}"])
            trees[tag] = restore_params_only(d)[0]
        spread = tree_gap(torch, trees["eager_a"], trees["eager_b"])
        gap = tree_gap(torch, trees["eager_a"], trees["graphed"])
        out[name] = {"eager_spread": spread, "graphed_gap": gap,
                     "bitwise": gap == 0.0,
                     "losses": [results[t]["loss"] for t in results]}
        emit({"phase": "hgcn_graphed", "task": name, "dataset": "cora",
              "chunk": HGCN_CHUNK, "steps": steps, **out[name],
              "seconds": time.perf_counter() - t0, **card})
        if not (gap == 0.0 or (spread > 0 and gap <= spread)):
            raise AssertionError(f"hgcn {name} on Cora: graphed {gap} from "
                                 f"the eager run, two eager runs {spread}")
    out["seconds"] = time.perf_counter() - t0
    return out


def parse_prometheus(text: str) -> dict:
    """``{series: value}`` of a Prometheus text exposition; a line that
    does not parse raises."""
    vals = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            vals[series] = float(value)
    return vals


def spine_runs(torch, tmp: str, card: dict) -> dict:
    """Phase 61: graphed HyboNet through ``cli.train.main`` with the
    spine on (``telemetry=1 trace_out= metrics_out= profile_steps=16``)
    and off, the same steps: the manifest first, ``span/*`` and ``ctr/*``
    in the records, the profiled chunks' ``train/phase/device_step_ms``
    count, the trace and the Prometheus file loaded; ms a step from the
    log records' clocks after the first record (each record reads the
    loss: a sync)."""
    from hyperspace_torch.telemetry import registry as telem

    t0 = time.perf_counter()
    base = ["hybonet", "--yaml", HB_CLI_YAML, f"steps={SPINE_STEPS}",
            f"scan_chunk={SPINE_CHUNK}", "eval_every=16"]
    trace, prom = os.path.join(tmp, "spine.json"), os.path.join(tmp,
                                                                "spine.prom")
    out = {}
    for tag, extra in (("off", []), ("on", [
            "telemetry=1", f"trace_out={trace}", f"metrics_out={prom}",
            f"profile_steps={SPINE_PROFILE}"])):
        log = os.path.join(tmp, f"spine_{tag}.jsonl")
        mark = telem.default_registry().mark()
        res = run_cli(base + [f"log={log}"] + extra)
        delta = telem.default_registry().snapshot(baseline=mark)
        with open(log) as f:
            recs = [json.loads(line) for line in f]
        rows = [r for r in recs if "event" not in r and "loss" in r]
        ms = ((rows[-1]["ts"] - rows[0]["ts"])
              / (rows[-1]["step"] - rows[0]["step"]) * 1e3)
        hist = delta.get("hist/train/phase/device_step_ms", {})
        out[tag] = {"result": res, "ms_per_step": ms,
                    "records": len(recs),
                    "span_fields": sorted({k for r in rows for k in r
                                           if k.startswith("span/")}),
                    "ctr_fields": len({k for r in rows for k in r
                                       if k.startswith("ctr/")}),
                    "first_event": recs[0].get("event"),
                    "last_event": recs[-1].get("event"),
                    "device_step_ms_count": hist.get("count", 0),
                    "device_step_ms_mean": (hist["sum"] / hist["count"]
                                            if hist.get("count") else None),
                    "dispatches": delta.get("train/dispatches", 0)}
    on = out["on"]
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    with open(prom) as f:
        series = parse_prometheus(f.read())
    on["trace_events"] = len(events)
    on["prometheus_series"] = len(series)
    on["telemetry_cost_ms_per_step"] = on["ms_per_step"] - out["off"][
        "ms_per_step"]
    emit({"phase": "spine", **out, "seconds": time.perf_counter() - t0,
          **card})
    want_prof = -(-SPINE_PROFILE // SPINE_CHUNK)
    if (on["first_event"] != "run_manifest"
            or on["last_event"] != "telemetry_summary"
            or "span/dispatch_s" not in on["span_fields"]
            or not on["ctr_fields"]
            or on["device_step_ms_count"] != want_prof
            or not any(e.get("name") == "dispatch" for e in events)
            or not any(k.startswith("hyperspace_train_dispatches")
                       for k in series)):
        raise AssertionError(f"spine: {on}")
    off = out["off"]
    if off["first_event"] is not None or off["span_fields"] \
            or off["ctr_fields"] or off["device_step_ms_count"]:
        raise AssertionError(f"spine off added telemetry: {off}")
    return out


def guard_runs(torch, tmp: str, card: dict) -> dict:
    """Phase 62: graphed HyboNet (chunks of 8, a save every 8 steps) with
    ``chaos=train.step_nan:nan:after=2 rollback=1``: one rollback, to step
    16 (the last commit before the poisoned chunk's boundary), a finite
    final loss and the unfaulted run's final state; ``rollback=1`` with no
    fault bitwise the unguarded run; ``chaos=ckpt.save:ioerror:times=2``
    retried, counted, the run complete."""
    from hyperspace_torch.telemetry import registry as telem
    from hyperspace_torch.train.checkpoint import restore_params_only

    t0 = time.perf_counter()
    base = ["hybonet", "--yaml", HB_CLI_YAML, f"steps={GUARD_STEPS}",
            "scan_chunk=8", "ckpt_every=8", "eval_every=8"]

    def run(tag, *extra):
        d = os.path.join(tmp, f"guard_{tag}")
        log = os.path.join(tmp, f"guard_{tag}.jsonl")
        mark = telem.default_registry().mark()
        res = run_cli(base + [f"ckpt_dir={d}", f"log={log}", *extra])
        delta = telem.default_registry().snapshot(baseline=mark)
        with open(log) as f:
            recs = [json.loads(line) for line in f]
        tree, step = restore_params_only(d)
        return res, recs, tree, step, delta

    clean = run("clean")
    fault = run("nan", "rollback=1", "chaos=train.step_nan:nan:after=2")
    idle = run("idle", "rollback=1")
    save = run("ioerror", "chaos=ckpt.save:ioerror:times=2")
    rollbacks = [r for r in fault[1] if r.get("event") == "rollback"]
    out = {"rollbacks": rollbacks,
           "fault_final_loss": fault[0]["loss"],
           "fault_vs_clean_gap": tree_gap(torch, clean[2], fault[2]),
           "idle_vs_clean_gap": tree_gap(torch, clean[2], idle[2]),
           "idle_results_equal": idle[0] == clean[0],
           "save_retries": save[4].get("ckpt/save_retries", 0),
           "saves": save[4].get("ckpt/saves", 0),
           "ioerror_chaos": save[0].get("chaos"), "ioerror_step": save[3],
           "seconds": time.perf_counter() - t0}
    emit({"phase": "guard", **out, **card})
    if len(rollbacks) != 1 or rollbacks[0]["restored_step"] != 16 \
            or not np.isfinite(fault[0]["loss"] or np.nan) \
            or out["fault_vs_clean_gap"] != 0.0:
        raise AssertionError(f"guard: the NaN run did not roll back to the "
                             f"clean run's trajectory: {out}")
    if out["idle_vs_clean_gap"] != 0.0 or not out["idle_results_equal"]:
        raise AssertionError(f"guard: an idle guard changed the run: {out}")
    if out["save_retries"] != 2 or save[3] != GUARD_STEPS \
            or save[0]["chaos"]["fired"] != 2:
        raise AssertionError(f"guard: ckpt.save ioerror: {out}")
    return out


def graphed_kernel_fields(g59: dict, g60: dict, kernels: list) -> None:
    """Add the graphed paths' launches to the kernels line in a field of
    their own, ``launches_graphed`` (``launches`` stays the eager main
    path's count): phase 59's replay chunks (both ``accum``) for the
    HyboNet kernels, phase 60's LP replay chunk for B1 and B2."""
    names = {"flash_attention_fwd": "flash_fwd",
             "flash_attention_dq": "flash_dq",
             "flash_attention_dkv": "flash_dkv", "hyp_mlr": "hyp_mlr"}
    lp = g60["lp"]["replay"]["launches"]
    for e in kernels:
        n = None
        if e["name"] in names:
            n = g59["launches"][names[e["name"]]]
        elif e["name"] in CLI_LP_PER_STEP:
            n = lp[e["name"]]
        if n is not None:
            e["launches_graphed"] = n


# --- phases 67-70: training through a host-resident table ---------------------

HOST_ROWS, HOST_DIM = 200_000, 8       # the JAX bench's big-table train leg
HOST_BATCH, HOST_NEG = 1024, 10
HOST_CHUNK, HOST_STEPS, HOST_SEED = 8, 24, 1
HOST_PAIRS = 100_000
HOST_EVICT_CHUNK = 2                   # a chunk's working set fits a quarter
HOST_CARD_CPU_RTOL = 1e-4              # all f32
FULL_ROWS, FULL_PAIRS = 10_000_000, 200_000
CKPT_SAVE_SHARDS, CKPT_LOAD_SHARDS = 8, 3
CKPT_OWNERS = 4                        # processes of the row-file layout
HOST_CLI_STEPS = 64
# kernels launched a planned step, by optimizer
HOST_PER_STEP = {"rsgd": {"expmap": 1, "csr_segment_sum": 1},
                 "radam": {"expmap": 1, "ptransp": 1, "csr_segment_sum": 1}}


def host_cfg(pe, rows: int, optimizer: str):
    return pe.PoincareEmbedConfig(num_nodes=rows, dim=HOST_DIM,
                                  batch_size=HOST_BATCH,
                                  neg_samples=HOST_NEG, optimizer=optimizer)


def host_delta(reg, mark, names) -> dict:
    snap = reg.snapshot(baseline=mark)
    return {n: snap.get(n, 0) for n in names}


def host_timed(torch, tr, pairs, reg) -> dict:
    """One timed ``run`` of ``HOST_STEPS`` steps after the warm chunk: ms a
    step (host clock, ending in the last write-back's sync), the four
    phases' ms a chunk, the hit rate and uploads a chunk (the cache's
    counters; ``run`` restarts its plans at chunk 0, so the first timed
    chunk repeats the warm one, as in the JAX leg), and the graphs
    captured."""
    from hyperspace_torch.models import poincare_embed as pe

    torch.cuda.synchronize()
    mark = reg.mark()
    caps = pe.graph_captures()
    t0 = time.perf_counter()
    losses = tr.run(pairs, HOST_STEPS)
    ms = (time.perf_counter() - t0) / HOST_STEPS * 1e3
    chunks = HOST_STEPS // tr.chunk_steps
    snap = reg.snapshot(baseline=mark)
    c = host_delta(reg, mark, ("host_table/cache_hits",
                               "host_table/cache_misses",
                               "host_table/cache_evictions",
                               "host_table/upload_bytes",
                               "host_table/upload_rows"))
    look = c["host_table/cache_hits"] + c["host_table/cache_misses"]
    return {"step_ms": ms, "losses": losses, "chunks": chunks,
            "phase_ms_a_chunk": {
                k: snap[f"hist/train/phase/{k}_ms"]["sum"]
                / snap[f"hist/train/phase/{k}_ms"]["count"]
                for k in ("data_wait", "host_gather", "device_step",
                          "write_back")},
            "hit_rate": c["host_table/cache_hits"] / max(look, 1),
            "evictions": c["host_table/cache_evictions"],
            "upload_bytes_a_chunk": c["host_table/upload_bytes"] / chunks,
            "upload_rows_a_chunk": c["host_table/upload_rows"] / chunks,
            "captures": pe.graph_captures() - caps}


def host_traced(torch, tr, pairs, optimizer: str) -> list:
    """The kernels one more replay chunk of ``tr`` ran on the card,
    counted by name in a profiler trace (``traced_launches``); raises
    unless they are ``HOST_CHUNK`` × ``HOST_PER_STEP`` or the chunk
    captured a graph.  Returns the traces taken."""
    from hyperspace_torch.models import poincare_embed as pe

    names = tuple(HOST_PER_STEP["radam"])
    want = {n: HOST_CHUNK * HOST_PER_STEP[optimizer].get(n, 0)
            for n in names}
    caps = pe.graph_captures()
    traced = []
    for _ in range(TRACE_TRIES):
        traced.append(traced_launches(
            torch, lambda: tr.run(pairs, HOST_CHUNK), names))
        if traced[-1] == want:
            break
    if traced[-1] != want or pe.graph_captures() != caps:
        raise AssertionError(f"host {optimizer}: a replayed chunk ran "
                             f"{traced} on the card (profiler trace), want "
                             f"{want}; {pe.graph_captures() - caps} "
                             "captures")
    return traced


def host_train(torch, args, card: dict) -> dict:
    """Phase 67: the host-resident trainer against ``run_planned_inhbm``
    at the JAX leg's width, RSGD and RAdam."""
    import torch.utils._pytree as pytree

    from hyperspace_torch.models import poincare_embed as pe
    from hyperspace_torch.telemetry import registry as telem
    from hyperspace_torch.train import host_embed as he

    dev = torch.device("cuda")
    reg = telem.default_registry()
    pairs = np.random.default_rng(args.seed + 67).integers(
        0, HOST_ROWS, (HOST_PAIRS, 2)).astype(np.int32)
    out = {"launches": dict.fromkeys(HOST_PER_STEP["radam"], 0)}
    for optimizer in ("rsgd", "radam"):
        t0 = time.perf_counter()
        cfg = host_cfg(pe, HOST_ROWS, optimizer)
        start, opt = pe.init_state(cfg, 0, dev)
        caps0 = pe.graph_captures()
        tr = he.HostPlannedTrainer.from_state(
            cfg, opt, pe_clone(torch, start), chunk_steps=HOST_CHUNK,
            seed=HOST_SEED, profile=True)
        warm = tr.run(pairs, HOST_CHUNK)
        after_one = tr.master.to_array()      # held against the CPU below
        host = host_timed(torch, tr, pairs, reg)
        captures = pe.graph_captures() - caps0
        if captures != 1 or host["captures"] != 0:
            raise AssertionError(f"host {optimizer}: {captures} captures "
                                 "for one chunk length, want 1")
        # the in-HBM reference: the same plans from the same start, its
        # warm and timed calls on one set of plan buffers (one capture)
        plans = {}
        st, losses_w = he.run_planned_inhbm(cfg, opt, pe_clone(torch, start),
                                            pairs, HOST_CHUNK,
                                            chunk_steps=HOST_CHUNK,
                                            seed=HOST_SEED, plans=plans)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st, losses_t = he.run_planned_inhbm(cfg, opt, st, pairs, HOST_STEPS,
                                            chunk_steps=HOST_CHUNK,
                                            seed=HOST_SEED, plans=plans)
        inhbm_ms = (time.perf_counter() - t1) / HOST_STEPS * 1e3
        ref = pe.pack_state(cfg, st).packed.cpu().numpy()
        bitwise = bool(np.array_equal(tr.master.to_array(), ref)
                       and np.array_equal(warm, losses_w)
                       and np.array_equal(host["losses"], losses_t))
        # then one more replay chunk of the host trainer, traced
        traced = host_traced(torch, tr, pairs, optimizer)
        for k, n in traced[-1].items():
            out["launches"][k] += n
        # evictions: a chunk of 8 touches ~75,000 of the 200,000 rows,
        # more than a quarter of the auto cache, so chunks of 2 run over a
        # cache of their worst-case working set: 24,576 rows, a quarter
        quarter = he.auto_hot_rows(cfg, HOST_EVICT_CHUNK)
        ev = he.HostPlannedTrainer.from_state(
            cfg, opt, pe_clone(torch, start), chunk_steps=HOST_EVICT_CHUNK,
            hot_rows=quarter, seed=HOST_SEED)
        mark = reg.mark()
        ev_losses = ev.run(pairs, HOST_STEPS)
        evictions = host_delta(reg, mark, ("host_table/cache_evictions",))[
            "host_table/cache_evictions"]
        st_e, ref_losses = he.run_planned_inhbm(
            cfg, opt, pe_clone(torch, start), pairs, HOST_STEPS,
            chunk_steps=HOST_EVICT_CHUNK, seed=HOST_SEED)
        ev_bitwise = bool(np.array_equal(
            ev.master.to_array(), pe.pack_state(cfg, st_e).packed.cpu()
            .numpy()) and np.array_equal(ev_losses, ref_losses))
        # the card against the CPU after one chunk
        on_cpu = pytree.tree_map(
            lambda x: x.cpu() if isinstance(x, torch.Tensor) else x,
            start)._replace(generator=torch.Generator())
        cpu = he.HostPlannedTrainer.from_state(
            cfg, opt, on_cpu, chunk_steps=HOST_CHUNK, seed=HOST_SEED,
            device="cpu")
        cpu.run(pairs, HOST_CHUNK)
        b = cpu.master.to_array()
        rel = float(np.abs(after_one - b).max() / np.abs(b).max())
        r = {"rows": HOST_ROWS, "chunk_steps": HOST_CHUNK,
             "hot_rows": tr.cache.capacity,
             "host_step_ms": host["step_ms"], "inhbm_step_ms": inhbm_ms,
             "host_vs_inhbm": host["step_ms"] / inhbm_ms,
             "phase_ms_a_chunk": host["phase_ms_a_chunk"],
             "hit_rate": host["hit_rate"],
             "upload_bytes_a_chunk": host["upload_bytes_a_chunk"],
             "traced_launches_replay_chunk": traced,
             "captures": captures, "bitwise_inhbm": bitwise,
             "evict_hot_rows": quarter, "evict_chunk_steps": HOST_EVICT_CHUNK,
             "evict_of_auto": quarter / tr.cache.capacity,
             "evictions": evictions, "evict_bitwise_inhbm": ev_bitwise,
             "card_vs_cpu_rel": rel, "rtol": HOST_CARD_CPU_RTOL,
             "losses_finite": bool(np.all(np.isfinite(host["losses"]))),
             "seconds": time.perf_counter() - t0}
        emit({"phase": "host_train", "optimizer": optimizer, **r, **card})
        if not (bitwise and ev_bitwise):
            raise AssertionError(f"host {optimizer}: not bitwise the in-HBM "
                                 f"trainer (plain {bitwise}, evicting "
                                 f"{ev_bitwise})")
        if not evictions > 0:
            raise AssertionError(f"host {optimizer}: no eviction at "
                                 f"hot_rows={quarter}")
        if not rel <= HOST_CARD_CPU_RTOL or not r["losses_finite"]:
            raise AssertionError(f"host {optimizer}: card and CPU differ by "
                                 f"rel {rel}, or a loss is not finite")
        out[optimizer] = r
    return out


def full_fill(seed: int):
    """The JAX leg's synthetic master: ball points around 512 clustered
    centres, each block drawn from its own start row."""
    centers = np.random.default_rng(seed).standard_normal(
        (512, HOST_DIM)) * 0.25

    def fill(start, nr):
        r = np.random.default_rng((1234, start))
        v = (centers[r.integers(0, 512, nr)]
             + r.standard_normal((nr, HOST_DIM)) * 0.05)
        nv = np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
        return (np.tanh(nv) * v / nv).astype(np.float32)

    return fill


def host_train_full(torch, args, card: dict) -> dict:
    """Phase 68: the 10,000,000-row RSGD master, built shard by shard,
    through ``HostPlannedTrainer`` alone."""
    from hyperspace_torch.models import poincare_embed as pe
    from hyperspace_torch.parallel.host_table import HostEmbedTable
    from hyperspace_torch.telemetry import registry as telem
    from hyperspace_torch.train import host_embed as he

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    master = HostEmbedTable.build(FULL_ROWS, HOST_DIM, full_fill(args.seed))
    build_s = time.perf_counter() - t0
    cfg = host_cfg(pe, FULL_ROWS, "rsgd")
    opt = pe.make_optimizer(cfg)
    pairs = np.random.default_rng(args.seed + 68).integers(
        0, FULL_ROWS, (FULL_PAIRS, 2)).astype(np.int32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = he.HostPlannedTrainer(cfg, opt, master,
                               opt.init(torch.zeros((1, HOST_DIM),
                                                    device=dev)),
                               chunk_steps=HOST_CHUNK, seed=HOST_SEED,
                               profile=True, device=dev)
    tr.run(pairs, HOST_CHUNK)
    host = host_timed(torch, tr, pairs, telem.default_registry())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    own = peak - base
    r = {"rows": FULL_ROWS, "table_bytes": master.nbytes,
         "build_s": build_s, "hot_rows": tr.cache.capacity,
         "cache_bytes": tr.cache.nbytes,
         "host_step_ms_full": host["step_ms"],
         "phase_ms_a_chunk": host["phase_ms_a_chunk"],
         "hit_rate": host["hit_rate"],
         "upload_bytes_a_chunk": host["upload_bytes_a_chunk"],
         "upload_rows_a_chunk": host["upload_rows_a_chunk"],
         "peak_device_bytes": peak, "device_bytes_at_start": base,
         "peak_device_bytes_over_start": own,
         "limit_bytes": master.nbytes // 4,
         "losses_finite": bool(np.all(np.isfinite(host["losses"]))),
         "seconds": time.perf_counter() - t0}
    emit({"phase": "host_train_full", **r, **card})
    if not own < master.nbytes // 4 or not r["losses_finite"]:
        raise AssertionError(f"host full: the run took {own} device bytes "
                             f"(limit {master.nbytes // 4}), or a loss is "
                             "not finite")
    return {**r, "master": master}


def tables_equal(a, b, block: int = 1 << 20) -> bool:
    """Two host tables equal, compared one bounded block at a time."""
    if (a.num_rows, a.width, a.dtype) != (b.num_rows, b.width, b.dtype):
        return False
    return all(np.array_equal(blk, b._slice_rows(s, s + len(blk)))
               for s, blk in a.iter_chunks(block))


def host_ckpt(torch, master, tmp: str, card: dict) -> dict:
    """Phase 69: phase 68's master saved at 8 shards and restored at 3,
    and the per-process row files, all bitwise."""
    from hyperspace_torch.parallel import host_table as HT

    n = master.num_rows
    d = os.path.join(tmp, "sharded")
    t0 = time.perf_counter()
    HT.reset_io_peak()
    master.save_sharded(d, shards=CKPT_SAVE_SHARDS)
    save_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    back = HT.HostEmbedTable.load_sharded(d, shards=CKPT_LOAD_SHARDS)
    load_s = time.perf_counter() - t1
    peak = HT.io_rows_peak()
    bound = max(-(-n // CKPT_SAVE_SHARDS), -(-n // CKPT_LOAD_SHARDS))
    same = tables_equal(back, master) and back.num_shards == CKPT_LOAD_SHARDS
    del back
    shutil.rmtree(d, ignore_errors=True)
    d = os.path.join(tmp, "owned")
    t2 = time.perf_counter()
    for pi in range(CKPT_OWNERS):
        HT.save_owned_rows(master, d, process_index=pi,
                           process_count=CKPT_OWNERS)
    owned_s = time.perf_counter() - t2
    lo, hi = n // 2 - n // 20, n // 2 + n // 20   # straddles two files
    t3 = time.perf_counter()
    rows = HT.load_rows(d, lo, hi)
    rows_s = time.perf_counter() - t3
    rows_same = bool(np.array_equal(rows, master._slice_rows(lo, hi)))
    shutil.rmtree(d, ignore_errors=True)
    r = {"rows": n, "save_shards": CKPT_SAVE_SHARDS,
         "load_shards": CKPT_LOAD_SHARDS, "bitwise": same,
         "io_rows_peak": peak, "io_rows_bound": bound, "save_s": save_s,
         "load_s": load_s, "owned_processes": CKPT_OWNERS,
         "owned_save_s": owned_s, "load_rows_range": [lo, hi],
         "load_rows_s": rows_s, "load_rows_bitwise": rows_same,
         "seconds": time.perf_counter() - t0}
    emit({"phase": "host_ckpt", **r, **card})
    if not (same and rows_same and peak <= bound):
        raise AssertionError(f"host checkpoint: {r}")
    return r


def host_cli(torch, tmp: str, card: dict) -> dict:
    """Phase 70: ``cli.train poincare host_table=1`` on the 66,430-node
    closure."""
    from hyperspace_torch.data.wordnet import load_closure_tsv, synthetic_tree
    from hyperspace_torch.models import poincare_embed as pe
    from hyperspace_torch.parallel.host_table import HostEmbedTable
    from hyperspace_torch.train import host_embed as he

    t0 = time.perf_counter()
    ds = synthetic_tree(PE_DEPTH, PE_BRANCH)
    tsv = os.path.join(tmp, "closure.tsv")
    with open(tsv, "w") as f:
        f.writelines(f"n{u}\tn{v}\n" for u, v in ds.pairs)
    ck = os.path.join(tmp, "ck")
    base = ["poincare", "--yaml", os.path.join(REPO, PE_CLI_YAML),
            "scan_chunk=1", f"steps={HOST_CLI_STEPS}"]
    host = base + ["host_table=1", f"data_root={tsv}"]
    pe_reset()
    res = run_cli(host + [f"ckpt_dir={ck}"])
    pdist_n = pe_counts()["pdist"]      # eager: counted at its launches
    # the saved master against a trainer driven with the CLI's arguments
    cfg = pe.PoincareEmbedConfig(num_nodes=ds.num_nodes, dim=10, lr=0.3,
                                 neg_samples=10, batch_size=1024,
                                 burnin_steps=100)
    st, opt = pe.init_state(cfg, 0, torch.device("cuda"))
    tr = he.HostPlannedTrainer.from_state(cfg, opt, st)
    tr.run(load_closure_tsv(tsv).pairs, HOST_CLI_STEPS)
    saved = HostEmbedTable.load_sharded(os.path.join(ck, "host_table"))
    reloads = tables_equal(saved, tr.master)
    ahead = run_cli(host + ["host_gather_ahead=1"])
    t1 = time.perf_counter()
    # the fault path in a process of its own, on the CLI's default tree
    proc = subprocess.run(
        [sys.executable, "-m", "hyperspace_torch.cli.train", *base,
         "host_table=1", "chaos=data.next_batch:ioerror:after=2:times=1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    chaos_s = time.perf_counter() - t1
    named = ("InjectedIOError" in proc.stderr
             and "data.next_batch" in proc.stderr)
    dense = run_cli(base)
    dense_chaos = run_cli(base + ["chaos=data.next_batch:ioerror"])
    spec = dense_chaos.pop("chaos")["specs"][0]
    fired = spec["fired"] + spec["calls"]    # the site never reached
    r = {"config": PE_CLI_YAML, "nodes": ds.num_nodes, **res,
         "pdist_launches": pdist_n, "master_reloads_bitwise": reloads,
         "gather_ahead": ahead, "chaos_rc": proc.returncode,
         "chaos_error_named": named, "chaos_s": chaos_s,
         "dense": dense, "dense_with_next_batch_spec": dense_chaos,
         "dense_spec_fired": fired, "seconds": time.perf_counter() - t0}
    emit({"phase": "host_cli", **r, **card})
    if not (res.get("host_table") and res["steps"] == HOST_CLI_STEPS
            and 0.0 < res["map"] <= 1.0 and reloads):
        raise AssertionError(f"host CLI: {res}, reloads {reloads}")
    if not (ahead["steps"] == HOST_CLI_STEPS and 0.0 < ahead["map"] <= 1.0):
        raise AssertionError(f"host CLI gather_ahead: {ahead}")
    if proc.returncode == 0 or not named:
        raise AssertionError(f"host CLI chaos run: rc {proc.returncode}, "
                             f"stderr {proc.stderr[-2000:]}")
    if dense_chaos != dense or fired:
        raise AssertionError(f"a data.next_batch spec changed a dense run: "
                             f"{dense} vs {dense_chaos}")
    if pdist_n != PE_EVAL_CHUNKS:
        raise AssertionError(f"host CLI: {pdist_n} pdist launches, "
                             f"want {PE_EVAL_CHUNKS}")
    return r


def host_path(torch, args, card: dict) -> dict:
    """Phases 67-70; returns what the kernels line needs."""
    ht = host_train(torch, args, card)
    full = host_train_full(torch, args, card)
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=work)
    try:
        ck = host_ckpt(torch, full.pop("master"), tmp, card)
        cl = host_cli(torch, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"train": ht, "full": full, "ckpt": ck, "cli": cl}


def host_kernel_fields(hp: dict, kernels: list) -> None:
    """Add the host-resident path's launches to the kernels line in a
    field of their own, ``launches_host``: for B1 and the row ops the
    kernels of phase 67's traced replay chunks (one an optimizer; a
    profiler trace, not the wrappers' counts, which a graph replay
    cannot add to), for ``pdist`` phase 70's closing evaluation."""
    for e in kernels:
        name = e["name"]
        if name in hp["train"]["launches"]:
            e["launches_host"] = hp["train"]["launches"][name]
        elif name == "pdist":
            e["launches_host"] = hp["cli"]["pdist_launches"]


# --- phases 50-54: serving through the HTTP front door -----------------------

FD_LOADS = (0.5, 0.9)              # phase 51's offered rates, of capacity
FD_SIZES = (1, 16, 64)             # ids a request in phase 51
FD_PROBE_S = 1.5                   # seconds of a closed-loop capacity probe
FD_PASS_S = 3.0                    # seconds a (rate, size) pass
FD_OVERLOAD_S = 1.0                # phase 52: 10x the highest rate for 1 s
FD_CLIENT_CONNS = 96               # open sockets the load client holds at most
# first-use counters, flat across traffic once a door is prewarmed
FD_FIRST_USE = ("kernels/builds", "kernels/loads", "serve/cold_dispatches")
FD_STAGES = ("queue_wait", "collate_wait", "dispatch", "device_compute",
             "serialize")
FD_TREE = (6, 4)                   # phase 54: 5,461 nodes (IVF from 2,048)
FD_TRAIN_STEPS = 300


def open_loop_arrivals(n: int, qps: float, seed: int) -> np.ndarray:
    """Poisson arrival offsets (s) of ``n`` requests at an offered rate
    ``qps``: scheduled by the clock, never by the previous answer
    (bench.py's ``open_loop_arrivals``, kept here)."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / qps, size=n))


async def fd_http(host: str, port: int, method: str, path: str,
                  payload=None) -> tuple:
    """(status, parsed body or None, raw body) of one HTTP/1.1 round
    trip on a fresh connection."""
    import asyncio

    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = b"" if payload is None else json.dumps(payload).encode()
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: smoke\r\n"
                     f"Content-Length: {len(body)}\r\nConnection: close"
                     "\r\n\r\n".encode() + body)
        await writer.drain()
        data = await reader.read()
    finally:
        writer.close()
    head, _, raw = data.partition(b"\r\n\r\n")
    try:
        parsed = json.loads(raw)
    except ValueError:
        parsed = None
    return int(head.split(None, 2)[1]), parsed, raw


class FrontDoorThread:
    """``run_front_door`` (the entry ``serve-http`` runs) on its own
    thread and event loop; the load client runs on the caller's.  The
    door prewarms ``prewarm_ks`` on its dispatch thread before its
    listener opens (``()``: no prewarm).  ``prewarm`` holds what the
    prewarm returned, its launches and the libraries it loaded; the
    launch counts are set to 0 once the listener is up."""

    def __init__(self, batcher, prewarm_ks=(K,), max_wait_us=2000.0,
                 registry=None):
        import asyncio
        import threading

        from hyperspace_torch.serve.server import run_front_door
        from hyperspace_torch.telemetry import registry as telem

        reg = telem.default_registry()
        got: dict = {}
        up = threading.Event()
        lane_reset()
        loads = reg.get("kernels/loads")

        def ready(door):
            got["door"] = door
            up.set()

        def run():
            try:
                got["result"] = asyncio.run(run_front_door(
                    batcher, host="127.0.0.1", port=0,
                    max_wait_us=max_wait_us, ready=ready,
                    prewarm_ks=list(prewarm_ks) or None,
                    registry=registry))
            except BaseException as e:   # reported by the caller
                got["error"] = e
                up.set()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        if not up.wait(300) or "door" not in got:
            raise AssertionError(f"the front door did not start: "
                                 f"{got.get('error')!r}")
        self.door = got["door"]
        self.loop = self.door.loop
        self.prewarm = {**(self.door.prewarm_info or {}),
                        "launches": lane_counts(),
                        "kernel_loads": reg.get("kernels/loads") - loads}
        lane_reset()
        self.addr = (self.door.host, self.door.port)

    def call(self, fn):
        """Run ``fn()`` on the door's loop; its result."""
        import asyncio

        async def wrap():
            return fn()
        return asyncio.run_coroutine_threadsafe(wrap(), self.loop).result(60)

    def drain(self) -> None:
        """Drain the door (unless a phase drained it already); the
        door's ``run_front_door`` then returns and its thread ends."""
        import asyncio

        if not self.door.draining:
            asyncio.run_coroutine_threadsafe(self.door.drain(),
                                             self.loop).result(120)
        self.thread.join(120)
        if self.thread.is_alive():
            raise AssertionError("the front door did not stop")


def fd_requests(addr, reqs: list) -> list:
    """Send ``reqs`` ((method, path, payload)) one after another."""
    import asyncio

    async def go():
        return [await fd_http(*addr, m, p, b) for m, p, b in reqs]
    return asyncio.run(go())


def fd_concurrent(addr, payloads: list) -> list:
    """POST every payload to /v1/topk at once."""
    import asyncio

    async def go():
        return await asyncio.gather(*[fd_http(*addr, "POST", "/v1/topk", b)
                                      for b in payloads])
    return asyncio.run(go())


def load_client(spec: dict) -> dict:
    """The load client (run in a process of its own by
    :func:`fd_load`, so its Python work never takes the server's GIL):
    POST /v1/topk of ``size`` ids drawn from ``seed`` for ``seconds``.
    Open loop at ``qps`` (Poisson), at most ``FD_CLIENT_CONNS`` sockets
    open at once (beyond that an arrival waits in the client, counted in
    ``waited_for_socket``): the statuses, the latencies from each
    scheduled arrival to its answer, the client errors and the offered
    rate it reached.  Without ``qps``, a closed loop over
    ``FD_CLIENT_CONNS`` sockets, each sending its next request when the
    last is answered: the statuses and the answers a second."""
    import asyncio

    if not spec.get("qps"):
        return closed_loop_client(spec)
    n = max(1, int(spec["qps"] * spec["seconds"]))
    offs = open_loop_arrivals(n, spec["qps"], spec["seed"])
    ids = np.random.default_rng(spec["seed"]).integers(
        0, spec["rows"], size=(n, spec["size"]))
    addr = (spec["host"], spec["port"])

    async def go():
        loop = asyncio.get_running_loop()
        sem = asyncio.Semaphore(FD_CLIENT_CONNS)
        t0 = loop.time()
        lat, statuses, errors, waited = [], {}, [], [0]

        async def one(t_sched, payload):
            waited[0] += sem.locked()
            async with sem:
                try:
                    st, _b, _r = await fd_http(*addr, "POST", "/v1/topk",
                                               payload)
                except OSError as e:
                    errors.append(repr(e))
                    return
            statuses[str(st)] = statuses.get(str(st), 0) + 1
            lat.append((loop.time() - t_sched) * 1e3)

        tasks = []
        for i, off in enumerate(offs):
            delay = t0 + float(off) - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            body = {"ids": ids[i].tolist(), "k": spec["k"]}
            if spec.get("tenant"):
                body["tenant"] = spec["tenant"]
            tasks.append(asyncio.ensure_future(one(t0 + float(off), body)))
        sent_s = loop.time() - t0
        await asyncio.gather(*tasks)
        return statuses, lat, errors, n / max(sent_s, 1e-9), \
            loop.time() - t0, waited[0]

    statuses, lat, errors, achieved, wall, waited = asyncio.run(go())
    q = (np.percentile(lat, [50, 95, 99]).tolist() if lat
         else [None] * 3)
    return {"requests": n, "statuses": statuses, "client_errors": errors,
            "offered_qps": spec["qps"], "achieved_offered_qps": achieved,
            "answered_per_s": len(lat) / max(wall, 1e-9),
            "waited_for_socket": waited,
            "client_ms": dict(zip(("p50", "p95", "p99"), q))}


def closed_loop_client(spec: dict) -> dict:
    """:func:`load_client`'s closed loop: the server's capacity at
    ``FD_CLIENT_CONNS`` requests outstanding."""
    import asyncio

    rng = np.random.default_rng(spec["seed"])
    addr = (spec["host"], spec["port"])

    async def go():
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        statuses: dict = {}

        async def worker():
            while loop.time() - t0 < spec["seconds"]:
                ids = rng.integers(0, spec["rows"], spec["size"]).tolist()
                st, _b, _r = await fd_http(*addr, "POST", "/v1/topk",
                                           {"ids": ids, "k": spec["k"]})
                statuses[str(st)] = statuses.get(str(st), 0) + 1

        await asyncio.gather(*[worker() for _ in range(FD_CLIENT_CONNS)])
        return statuses, loop.time() - t0

    statuses, wall = asyncio.run(go())
    return {"statuses": statuses, "seconds": wall,
            "answered_per_s": sum(statuses.values()) / wall}


def fd_load(addr, size: int, qps, seconds: float, seed: int) -> dict:
    """:func:`load_client` in a child process (this script with
    ``--load-client``), waited for; ``qps=None`` for the closed loop."""
    spec = {"host": addr[0], "port": addr[1], "size": size, "qps": qps,
            "seconds": seconds, "seed": seed, "rows": ROWS, "k": K}
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--load-client", json.dumps(spec)],
                         capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    if out.returncode:
        raise AssertionError(f"load client failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def fd_stage_summary(delta: dict) -> dict:
    """The span histograms' stages from a registry delta (ms)."""
    out = {}
    for st in FD_STAGES:
        h = delta.get(f"hist/serve/stage/{st}_ms")
        if h and h["count"]:
            out[st] = {"mean": h["sum"] / h["count"], "p50": h["p50"],
                       "p95": h["p95"], "p99": h["p99"], "n": h["count"]}
    return out


def first_use(reg) -> dict:
    """The first-use counters' values now."""
    return {c.split("/")[1]: reg.get(c) for c in FD_FIRST_USE}


def front_door_checks(torch, art, mode: str, ids8, ids1024, u, v,
                      rng, card: dict) -> dict:
    """Phase 50 for one scan mode: the door's traffic (every route, 64
    concurrent single ids), its launches and first-use counters read
    right after it; then the same requests through the stdin loop and
    each single id alone (launches that are not the door's), and the
    answers compared."""
    from hyperspace_torch.cli import serve as cli
    from hyperspace_torch.kernels._support import topk_disagreements
    from hyperspace_torch.serve import (QueryEngine, RequestBatcher,
                                        load_artifact)
    from hyperspace_torch.telemetry import registry as telem

    reg = telem.default_registry()
    eng = QueryEngine.from_artifact(load_artifact(art), scan_mode=mode)
    bat = RequestBatcher(eng, cache_size=0)
    t0 = time.perf_counter()
    fd = FrontDoorThread(bat)
    warm = first_use(reg)
    try:
        base = reg.mark()
        got = fd_requests(fd.addr, [
            ("POST", "/v1/topk", {"ids": ids8, "k": K}),
            ("POST", "/v1/topk", {"ids": ids1024, "k": K}),
            ("POST", "/v1/score", {"u": u, "v": v, "prob": True}),
            ("GET", "/v1/stats", None), ("POST", "/v1/stats", {}),
            ("GET", "/healthz", None), ("GET", "/metrics", None),
            ("POST", "/v1/upsert", {"ids": [1], "rows": [[0.0] * DIM]}),
            ("POST", "/v1/delete", {"ids": [1]}),
            ("POST", "/admin/rollover", {"target": art})])
        # 64 concurrent single ids, collated
        single = rng.choice(ROWS, 64, replace=False).tolist()
        flush0 = reg.get("serve/collator_flushes")
        conc = fd_concurrent(fd.addr, [{"ids": [i], "k": K} for i in single])
        flushes = reg.get("serve/collator_flushes") - flush0
        launches = lane_counts()
        after = first_use(reg)
        delta = reg.snapshot(baseline=base)
    finally:
        fd.drain()
    traffic_s = time.perf_counter() - t0
    lines = [{"op": "topk", "ids": ids8, "k": K},
             {"op": "topk", "ids": ids1024, "k": K},
             {"op": "score", "u": u, "v": v, "prob": True}]
    out = io.StringIO()
    cli.run_serve(cli.ServeConfig(artifact=art, scan_mode=mode),
                  stdin=io.StringIO("\n".join(json.dumps(x) for x in lines)
                                    + "\n"), stdout=out)
    loop_ans = [json.loads(s) for s in out.getvalue().splitlines()]
    alone = [bat.topk([i], K) for i in single]
    statuses = [g[0] for g in got]
    res = {"scan_mode": mode, "prewarm": fd.prewarm,
           "first_use_after_prewarm": warm,
           "first_use_after_traffic": after,
           "concurrent_singles": 64, "flushes": flushes,
           "launches": launches, "slots": delta.get("serve/slots", 0),
           "statuses": statuses, "traffic_s": traffic_s,
           "seconds": time.perf_counter() - t0, **card}
    if statuses != [200] * 7 + [400] * 3:
        emit({"phase": "front_door", **res})
        raise AssertionError(f"front door {mode}: statuses {statuses}")
    for j in range(3):
        if got[j][1] != {k: loop_ans[j][k] for k in got[j][1]}:
            raise AssertionError(f"front door {mode}: answer {j} differs "
                                 "from the stdin loop's")
    if b"hyperspace_serve_e2e_ms_bucket" not in got[6][2]:
        raise AssertionError("/metrics lacks the e2e histogram")
    if any(c[0] != 200 for c in conc) or not flushes < 64:
        raise AssertionError(f"front door {mode}: 64 singles, "
                             f"{flushes} flushes, statuses "
                             f"{[c[0] for c in conc]}")
    ci = np.asarray([c[1]["neighbors"][0] for c in conc])
    cd = np.asarray([c[1]["dists"][0] for c in conc], np.float64)
    ai = np.stack([a[0][0] for a in alone])
    ad = np.stack([a[1][0] for a in alone]).astype(np.float64)
    bad = topk_disagreements(ci, cd, ai, ad, rtol=RTOL, atol=ATOL)
    res["collated_bitwise_equal_uncollated"] = bool(
        np.array_equal(ci, ai) and np.array_equal(cd, ad))
    emit({"phase": "front_door", **res})
    if bad:
        raise AssertionError(f"front door {mode}: collated answers "
                             f"disagree with uncollated on {bad} rows")
    if after != warm:
        raise AssertionError(f"front door {mode}: first-use counters moved "
                             f"after prewarm: {warm} -> {after}")
    want = "scan_topk" if mode == "fused" else "pdist"
    if launches[want] < 1:
        raise AssertionError(f"front door {mode}: traffic never launched "
                             f"{want}")
    return res


def front_door_control(torch, art, ids8, card: dict) -> dict:
    """Phase 50's control: a door over a fresh batcher without prewarm
    counts a cold dispatch at its first request (so the flat check above
    can fail) and none when the request comes again."""
    from hyperspace_torch.serve import (QueryEngine, RequestBatcher,
                                        load_artifact)
    from hyperspace_torch.telemetry import registry as telem

    reg = telem.default_registry()
    eng = QueryEngine.from_artifact(load_artifact(art), scan_mode="fused")
    fd = FrontDoorThread(RequestBatcher(eng, cache_size=0), prewarm_ks=())
    try:
        runs = []
        for _ in range(2):
            before = first_use(reg)
            t0 = time.perf_counter()
            st = fd_requests(fd.addr, [("POST", "/v1/topk",
                                        {"ids": ids8, "k": K})])[0][0]
            ms = (time.perf_counter() - t0) * 1e3
            runs.append({"status": st, "ms": ms, **{
                c: n - before[c] for c, n in first_use(reg).items()}})
        launches = lane_counts()
    finally:
        fd.drain()
    res = {"requests": runs, "launches": launches, **card}
    emit({"phase": "front_door_control", **res})
    if ([r["status"] for r in runs] != [200, 200]
            or runs[0]["cold_dispatches"] < 1 or runs[1]["cold_dispatches"]):
        raise AssertionError(f"control: a door without prewarm should "
                             f"count a cold dispatch once: {runs}")
    return res


def front_door_latency(torch, art, rng, card: dict) -> dict:
    """Phase 51: for each request size, the capacity (a closed loop),
    then open-loop latency at ``FD_LOADS`` of it; cache off, spans on
    (the per-stage histograms), fused scan."""
    from hyperspace_torch.serve import (QueryEngine, RequestBatcher,
                                        load_artifact)
    from hyperspace_torch.telemetry import registry as telem
    from hyperspace_torch.telemetry import spans

    reg = telem.default_registry()
    eng = QueryEngine.from_artifact(load_artifact(art), scan_mode="fused")
    bat = RequestBatcher(eng, cache_size=0)
    spans.enable()
    mem0 = torch.cuda.memory_reserved()
    fd = FrontDoorThread(bat)
    passes, capacity = [], {}
    try:
        for size in FD_SIZES:
            probe = fd_load(fd.addr, size, None, FD_PROBE_S,
                            seed=int(rng.integers(1 << 30)))
            capacity[size] = probe["answered_per_s"]
            emit({"phase": "front_door_capacity", "ids_per_request": size,
                  **probe, **card})
            if set(probe["statuses"]) != {"200"}:
                raise AssertionError(f"capacity probe × {size}: "
                                     f"{probe['statuses']}")
            for load in FD_LOADS:
                qps = load * capacity[size]
                base = reg.mark()
                cl = fd_load(fd.addr, size, qps, FD_PASS_S,
                             seed=int(rng.integers(1 << 30)))
                d = reg.snapshot(baseline=base)
                e2e = d.get("hist/serve/e2e_ms") or {}
                flushes = d.get("serve/collator_flushes", 0)
                row = {"load": load, "capacity_per_s": capacity[size],
                       "ids_per_request": size, **cl,
                       "e2e_ms": {q: e2e.get(q) for q in
                                  ("p50", "p95", "p99", "count")},
                       "stages_ms": fd_stage_summary(d),
                       "batching_factor": (d.get("serve/cache_miss", 0)
                                           / flushes if flushes else None),
                       "flushes": flushes,
                       "slots": d.get("serve/slots", 0),
                       "padded_waste": d.get("serve/padded_waste", 0)}
                passes.append(row)
                emit({"phase": "front_door_latency", **row, **card})
                if (set(cl["statuses"]) != {"200"} or cl["client_errors"]
                        or e2e.get("count") != cl["requests"]):
                    raise AssertionError(f"open loop {qps:.0f}/s × {size}: "
                                         f"{cl['statuses']} "
                                         f"{cl['client_errors'][:3]}")
        launches = lane_counts()
    finally:
        fd.drain()
        spans.disable()
    return {"passes": passes, "capacity_per_s": capacity,
            "memory_reserved_before": mem0,
            "memory_reserved_after": torch.cuda.memory_reserved(),
            "prewarm": fd.prewarm, "launches": launches}


def front_door_overload(torch, ivf_art, rng, qps: float,
                        card: dict) -> dict:
    """Phase 52: single ids at ``qps`` (10x phase 51's highest rate) for
    1 s into ``queue_max=8`` on the IVF artifact (nprobe 8): every
    request answered once, the excess 429, no 500, no cold dispatch at
    any ladder width, the ladder steps down, then recovers under calm
    traffic; answers at degraded levels equal the engine's at that
    width."""
    from hyperspace_torch.serve import (QueryEngine, RequestBatcher,
                                        load_artifact)
    from hyperspace_torch.telemetry import registry as telem

    reg = telem.default_registry()
    eng = QueryEngine.from_artifact(load_artifact(ivf_art),
                                    scan_mode="fused", nprobe=8)
    bat = RequestBatcher(eng, queue_max=8)
    fd = FrontDoorThread(bat)
    base = reg.mark()
    t0 = time.perf_counter()
    try:
        cl = fd_load(fd.addr, 1, qps, FD_OVERLOAD_S,
                     seed=int(rng.integers(1 << 30)))
        d_load = reg.snapshot(baseline=base)
        level_after_load = bat.degrade_level
        # calm: sequential single ids until the ladder is back at full
        fresh = rng.permutation(ROWS)[:200].tolist()
        calm, checked, cmp_launches = [], 0, {}
        widths = bat._modes
        for qid in fresh:
            st, body, _raw = fd_requests(fd.addr, [
                ("POST", "/v1/topk", {"ids": [qid], "k": K})])[0]
            level = bat.degrade_level
            calm.append((st, level))
            mode = widths[level]
            if st == 200 and isinstance(mode, int):
                # the same padded bucket straight through the engine
                # (its launches are a comparison's, not the path's)
                p = bat._narrowed(mode, K)
                before = lane_counts()
                ei, ed = (x.cpu().numpy() for x in bat.engine.topk_neighbors(
                    np.full(8, qid, np.int32), K, nprobe=p))
                for name, n in lane_counts().items():
                    cmp_launches[name] = (cmp_launches.get(name, 0) + n
                                          - before[name])
                if (body["neighbors"][0] != ei[0].tolist()
                        or body["dists"][0] != ed[0].tolist()):
                    raise AssertionError(
                        f"degraded answer at nprobe {p} differs from the "
                        "engine's")
                checked += 1
            if level == 0 and len(calm) > 8:
                break
        d_all = reg.snapshot(baseline=base)
    finally:
        fd.drain()
    res = {"offered_qps": qps, "seconds": FD_OVERLOAD_S, **cl,
           "shed_rate": cl["statuses"].get("429", 0) / cl["requests"],
           "degraded": d_load.get("serve/degraded", 0),
           "level_after_load": level_after_load,
           "recovered": d_all.get("serve/degrade_recovered", 0),
           "calm_requests": len(calm),
           "calm_statuses": sorted({s for s, _l in calm}),
           "degraded_answers_checked": checked,
           "cold_dispatches": d_all.get("serve/cold_dispatches", 0),
           "prewarm": fd.prewarm,
           "launches": {name: n - cmp_launches.get(name, 0)
                        for name, n in lane_counts().items()},
           "phase_s": time.perf_counter() - t0,
           **card}
    emit({"phase": "front_door_overload", **res})
    answered = sum(cl["statuses"].values())
    if (answered != cl["requests"] or cl["client_errors"]
            or set(cl["statuses"]) - {"200", "429"}
            or not cl["statuses"].get("429")):
        raise AssertionError(f"overload: {cl['statuses']} of "
                             f"{cl['requests']}, errors "
                             f"{cl['client_errors'][:3]}")
    if res["degraded"] < 1 or res["recovered"] < 1 or bat.degrade_level:
        raise AssertionError(f"overload: the ladder did not step down and "
                             f"recover: {res}")
    if not checked or set(res["calm_statuses"]) - {200, 429}:
        raise AssertionError(f"overload: no degraded answer checked: {res}")
    if res["cold_dispatches"]:
        raise AssertionError(f"overload: {res['cold_dispatches']} cold "
                             "dispatches after prewarm")
    return res


def front_door_deadline_drain(torch, art, card: dict) -> dict:
    """Phase 53: an armed 300 ms ``serve.dispatch`` latency against a
    30 ms deadline answers 504 and caches its rows (the same ids then
    answer 200 from the cache, 0 new slots); a drain during an
    in-flight dispatch answers it, refuses new connections and reads
    503 at /healthz meanwhile."""
    import asyncio

    from hyperspace_torch.resilience import faults
    from hyperspace_torch.serve import (QueryEngine, RequestBatcher,
                                        load_artifact)
    from hyperspace_torch.telemetry import registry as telem

    reg = telem.default_registry()
    eng = QueryEngine.from_artifact(load_artifact(art), scan_mode="fused")
    fd = FrontDoorThread(RequestBatcher(eng))
    try:
        faults.install([faults.FaultSpec(site="serve.dispatch",
                                         kind="latency", ms=300.0)])
        late = fd_requests(fd.addr, [("POST", "/v1/topk", {
            "ids": [11, 12], "k": K, "deadline_ms": 30})])[0]
        faults.clear()
        base = reg.mark()
        again = fd_requests(fd.addr, [("POST", "/v1/topk", {
            "ids": [11, 12], "k": K, "deadline_ms": 30})])[0]
        d = reg.snapshot(baseline=base)
        faults.install([faults.FaultSpec(site="serve.dispatch",
                                         kind="latency", ms=300.0)])

        async def drain_mid():
            inflight = asyncio.ensure_future(fd_http(
                *fd.addr, "POST", "/v1/topk", {"ids": [21], "k": K}))
            while fd.call(lambda: fd.door.inflight) == 0:
                await asyncio.sleep(0.002)
            drain = asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                fd.door.drain(), fd.loop))
            await asyncio.sleep(0.05)
            mid = fd.call(lambda: fd.door._healthz()[0])
            try:
                await fd_http(*fd.addr, "GET", "/healthz")
                refused = False
            except OSError:
                refused = True
            answer = await inflight
            await drain
            return answer, refused, mid

        answer, refused, mid = asyncio.run(drain_mid())
    finally:
        faults.clear()
        fd.drain()
    res = {"late_status": late[0], "late_kind": (late[1] or {}).get(
        "error", {}).get("kind"), "again_status": again[0],
        "again_new_slots": d.get("serve/slots", 0),
        "again_cache_hit": d.get("serve/cache_hit", 0),
        "drain_inflight_status": answer[0], "drain_refused_new": refused,
        "healthz_while_draining": mid, **card}
    emit({"phase": "front_door_deadline_drain", **res})
    if (late[0] != 504 or res["late_kind"] != "deadline_exceeded"
            or again[0] != 200 or res["again_new_slots"]
            or res["again_cache_hit"] != 2):
        raise AssertionError(f"deadline: {res}")
    if answer[0] != 200 or not refused or mid != 503:
        raise AssertionError(f"drain: {res}")
    return res


def serve_http_door(art: str, kw: dict, ids: list) -> dict:
    """``serve-http`` over ``art`` through the CLI's ``run_serve_http``
    (``fused``, ``prewarm=1``, an ephemeral port, ``kw`` the lane's
    options), one ``/v1/topk`` of ``ids`` at k = K, then a drain: the
    status and the answer, the traffic's launches and the prewarm's
    apart (the counts set to 0 once the listener is up), and the
    first-use counters after the prewarm and after the traffic."""
    import asyncio
    import http.client
    import threading

    from hyperspace_torch.cli import serve as cli_serve
    from hyperspace_torch.telemetry import registry as telem

    reg = telem.default_registry()
    lane_reset()
    got = {}
    up = threading.Event()

    def ready(door):
        # after prewarm, before any request: the prewarm's launches
        got["door"], got["prewarm_launches"] = door, lane_counts()
        got["first_use_after_prewarm"] = first_use(reg)
        lane_reset()
        up.set()

    cfg = cli_serve.ServeConfig(artifact=art, scan_mode="fused",
                                prewarm="1", port=0, **kw)
    th = threading.Thread(target=lambda: got.update(
        result=cli_serve.run_serve_http(cfg, ready=ready)))
    th.start()
    if not up.wait(120):
        raise AssertionError(f"serve-http {kw} did not start")
    conn = http.client.HTTPConnection("127.0.0.1", got["door"].port,
                                      timeout=60)
    conn.request("POST", "/v1/topk", json.dumps({"ids": ids, "k": K}))
    r = conn.getresponse()
    body = json.loads(r.read())
    conn.close()
    launches, after = lane_counts(), first_use(reg)
    asyncio.run_coroutine_threadsafe(got["door"].drain(),
                                     got["door"].loop).result(120)
    th.join(120)
    nb = np.asarray(body.get("neighbors", []))
    ds = np.asarray(body.get("dists", []), np.float64)
    if (r.status != 200 or nb.shape != (len(ids), K)
            or not np.all(np.isfinite(ds))
            or np.any(np.diff(ds, axis=1) < 0)):
        raise AssertionError(f"serve-http {kw}: {r.status} {body}")
    return {"status": r.status, "launches": launches,
            "prewarm": {"launches": got["prewarm_launches"]},
            "first_use_after_prewarm": got["first_use_after_prewarm"],
            "first_use_after_traffic": after,
            "scan_strategy": got["result"]["scan_strategy"],
            "precision": got["result"]["precision"],
            "neighbors": nb, "dists": ds}


def front_door_export(torch, tmp: str, card: dict) -> dict:
    """Phase 54: ``cli.train poincare`` on the card with ``ckpt_dir``
    (eager steps on a 5,461-node tree), ``cli.serve export`` with an
    index and a PQ payload, ``serve-http`` over the export with nprobe 4
    and with the PQ lane."""
    from hyperspace_torch.cli import serve as cli_serve
    from hyperspace_torch.data.wordnet import synthetic_tree
    from hyperspace_torch.serve import fingerprint_of
    from hyperspace_torch.train.checkpoint import restore_params_only

    t0 = time.perf_counter()
    ds = synthetic_tree(*FD_TREE)
    tsv = os.path.join(tmp, "fd_closure.tsv")
    with open(tsv, "w") as f:
        f.writelines(f"n{a}\tn{b}\n" for a, b in ds.pairs)
    ck, art = os.path.join(tmp, "fd_ck"), os.path.join(tmp, "fd_art")
    trained = run_cli(["poincare", f"steps={FD_TRAIN_STEPS}",
                       "batch_size=1024", f"data_root={tsv}",
                       f"ckpt_dir={ck}", "ckpt_every=100"])
    train_s = time.perf_counter() - t0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_serve.main(["export", f"ckpt={ck}", f"out={art}", "c=1.0",
                        "index=1", "quant=pq"])
    exp = json.loads(buf.getvalue().strip().splitlines()[-1])
    export_s = time.perf_counter() - t0 - train_s
    tree, step = restore_params_only(ck)
    want_fp = fingerprint_of(tree["table"].numpy(), ("poincare", C),
                             exp["index"]["fingerprint"],
                             exp["quant"]["fingerprint"])
    served = {}
    for name, kw in (("nprobe4", {"nprobe": 4}), ("pq", {"precision": "pq"})):
        door = serve_http_door(art, kw, list(range(16)))
        served[name] = {key: door[key] for key in (
            "status", "launches", "prewarm", "scan_strategy", "precision")}
    res = {"train": trained, "export": exp, "step": step,
           "fingerprint_matches": exp["fingerprint"] == want_fp,
           "served": served, "train_s": train_s, "export_s": export_s,
           "seconds": time.perf_counter() - t0, **card}
    emit({"phase": "front_door_export", **res})
    if not res["fingerprint_matches"] or step != FD_TRAIN_STEPS:
        raise AssertionError(f"export: {res}")
    if served["nprobe4"]["scan_strategy"] != "ivf":
        raise AssertionError(f"export: nprobe=4 did not probe: {served}")
    return res


def front_door_lanes(torch, tmp: str, card: dict) -> dict:
    """Phase 57: ``cli.serve export ... quant=int4`` of phase 54's
    checkpoint (its payload the restored table's packing), then
    ``serve-http precision=int4`` (the shipped codes) and
    ``precision=int8`` over it with ``prewarm=1``: every answer 200 and
    equal to the same lane's engine in this process, the lane's own
    kernel launched by the traffic, and builds, loads and cold
    dispatches flat after the prewarm."""
    from hyperspace_torch.cli import serve as cli_serve
    from hyperspace_torch.serve import QueryEngine, load_artifact
    from hyperspace_torch.serve.artifact import build_quant_payload
    from hyperspace_torch.train.checkpoint import restore_params_only

    t0 = time.perf_counter()
    ck, art = os.path.join(tmp, "fd_ck"), os.path.join(tmp, "fd_art4")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_serve.main(["export", f"ckpt={ck}", f"out={art}", "c=1.0",
                        "quant=int4"])
    exp = json.loads(buf.getvalue().strip().splitlines()[-1])
    table = restore_params_only(ck)[0]["table"].numpy()
    want = build_quant_payload(table, ("poincare", C), "int4")
    ids = list(range(0, 5461, 341))
    served = {}
    for lane in ("int4", "int8"):
        door = serve_http_door(art, {"precision": lane}, ids)
        eng = QueryEngine.from_artifact(load_artifact(art), precision=lane,
                                        scan_mode="fused")
        ei, ed = eng.topk_neighbors(np.asarray(ids, np.int32), K)
        served[lane] = {key: door[key] for key in (
            "status", "launches", "prewarm", "scan_strategy", "precision",
            "first_use_after_prewarm", "first_use_after_traffic")}
        served[lane]["equals_engine"] = bool(
            np.array_equal(door["neighbors"], ei.cpu().numpy())
            and np.array_equal(door["dists"],
                               ed.cpu().numpy().astype(np.float64)))
    res = {"export": exp, "payload_matches": exp["quant"] == {
        "lane": "int4", "fingerprint": want.fingerprint},
        "served": served, "seconds": time.perf_counter() - t0, **card}
    emit({"phase": "front_door_lanes", **res})
    if not res["payload_matches"]:
        raise AssertionError(f"export quant=int4: {exp}")
    for lane, d in served.items():
        if d["precision"] != lane or not d["equals_engine"]:
            raise AssertionError(f"serve-http {lane}: {d}")
        if d["first_use_after_traffic"] != d["first_use_after_prewarm"]:
            raise AssertionError(f"serve-http {lane}: first-use counters "
                                 f"moved after prewarm: {d}")
        if d["launches"][f"scan_topk_{lane}"] < 1:
            raise AssertionError(f"serve-http {lane}: traffic never "
                                 f"launched the {lane} scan: {d}")
    return res


# --- phases 63-66: the live index, rollover, tenants, the streamed build -----

LIVE_CAP, LIVE_COMPACT_AT = 1024, 0.75   # phase 63's delta segment
LIVE_UPSERTS = 1000                      # one id an upsert, past compaction
LIVE_QUERY_EVERY = 10                    # a query of 8 ids every 10 upserts
TENANT_QPS = (200.0, 20.0)               # phase 65: hot and cold tenants
TENANT_LOAD_S = 3.0
STREAM_ROWS = 1_200_000                  # phase 66: above HOST_BUILD_ROWS
STREAM_CLUSTERS = 4096
STREAM_QUERIES = 1024
ALLOC_SLACK = 8 * 512                    # the allocator rounds a block to 512 B


class CliDoor:
    """``cli.serve.run_serve_http(ServeConfig(**kw))`` (what ``serve-http``
    runs) on its own thread, on an ephemeral port: the bound door, the
    prewarm's launches and the first-use counters read in ``ready`` (the
    launch counts then set to 0); :meth:`drain` ends it and returns the
    closing stats."""

    def __init__(self, **kw):
        import threading

        from hyperspace_torch.cli import serve as cli_serve
        from hyperspace_torch.telemetry import registry as telem

        reg = telem.default_registry()
        lane_reset()
        got: dict = {}
        up = threading.Event()

        def ready(door):
            got["door"], got["prewarm_launches"] = door, lane_counts()
            got["first_use"] = first_use(reg)
            lane_reset()
            up.set()

        def run():
            try:
                got["result"] = cli_serve.run_serve_http(
                    cli_serve.ServeConfig(port=0, **kw), ready=ready)
            except BaseException as e:   # reported by the caller
                got["error"] = e
                up.set()

        self.got = got
        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        if not up.wait(300) or "door" not in got:
            raise AssertionError(f"serve-http {kw} did not start: "
                                 f"{got.get('error')!r}")
        self.door = got["door"]
        self.addr = (self.door.host, self.door.port)
        self.prewarm_launches = got["prewarm_launches"]
        self.first_use = got["first_use"]

    def drain(self) -> dict:
        import asyncio

        asyncio.run_coroutine_threadsafe(self.door.drain(),
                                         self.door.loop).result(120)
        self.thread.join(120)
        if self.thread.is_alive():
            raise AssertionError("serve-http did not stop")
        return self.got.get("result", {})


def ball_nudge(x: np.ndarray, d: float, rng) -> np.ndarray:
    """A point at geodesic distance ``d`` from ball row ``x`` (c = 1): the
    exponential map along a random unit direction, scaled by 1/λ_x."""
    import torch

    from hyperspace_torch.manifolds import PoincareBall

    v = rng.standard_normal(x.shape)
    lam = 2.0 / (1.0 - float(np.sum(x.astype(np.float64) ** 2)))
    v = v / np.linalg.norm(v) * (d / lam)
    return PoincareBall(C).expmap(
        torch.as_tensor(x, dtype=torch.float64)[None],
        torch.as_tensor(v)[None]).float().numpy()[0]


def hist_summary(delta: dict, name: str):
    h = delta.get(f"hist/{name}")
    if not h or not h["count"]:
        return None
    return {q: h[q] for q in ("count", "p50", "p95", "p99", "max")}


def live_door(torch, name: str, art: str, kw: dict, rng, card: dict) -> dict:
    """Phase 63 on one artifact: ``serve-http live=1`` (two-stage base),
    the planted near-duplicate, a re-upsert, a delete, then
    ``LIVE_UPSERTS`` single-row upserts (half updates, half inserts) with
    a query of 8 live ids every ``LIVE_QUERY_EVERY``, past the background
    compaction; a synchronous compaction folds what came after its
    snapshot.  The answers then equal a fresh frozen engine's over
    ``master.to_array()`` (deleted ids dropped) and, on the exact base, a
    float64 brute force over the live rows."""
    import gc

    from hyperspace_torch.kernels._support import topk_disagreements
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.serve import QueryEngine
    from hyperspace_torch.telemetry import registry as telem

    reg = telem.default_registry()
    t0 = time.perf_counter()
    door = CliDoor(artifact=art, live=True, delta_cap=LIVE_CAP,
                   compact_at=LIVE_COMPACT_AT, scan_mode="two_stage",
                   prewarm="1", k=K, cache_size=0, **kw)
    eng = door.door.batcher.engine
    compactions = []
    inner = eng._compact_inner

    def timed_compaction():
        c0 = time.perf_counter()
        out = inner()
        compactions.append(time.perf_counter() - c0)
        return out

    eng._compact_inner = timed_compaction
    table = eng.master.to_array()
    n0 = table.shape[0]
    addr = door.addr
    base = reg.mark()
    try:
        r = int(rng.integers(0, n0))
        (s0, q0, _), = fd_requests(addr, [("POST", "/v1/topk",
                                           {"ids": [r], "k": K})])
        planted = ball_nudge(table[r], 0.5 * q0["dists"][0][0], rng)
        body = {"ids": [n0], "rows": [planted.tolist()]}
        steps = fd_requests(addr, [
            ("POST", "/v1/upsert", body),
            ("POST", "/v1/topk", {"ids": [r], "k": K}),
            ("POST", "/v1/upsert", body),
            ("POST", "/v1/delete", {"ids": [n0]}),
            ("POST", "/v1/topk", {"ids": [n0], "k": K}),
            ("POST", "/v1/topk", {"ids": [r], "k": K}),
            ("GET", "/v1/stats", None)])
        st = [x[0] for x in steps]
        checks = {
            "statuses": [s0] + st,
            "planted_top1": steps[1][1]["neighbors"][0][0] == n0,
            "reupsert_inserted": steps[2][1].get("inserted"),
            "deleted_query_kind": (steps[4][1] or {}).get(
                "error", {}).get("kind"),
            "deleted_never_returned": n0 not in steps[5][1]["neighbors"][0],
            "generation": steps[6][1]["generation"]}
        # the traffic: updates of random existing rows, inserts at the tail
        upd = rng.choice(n0, LIVE_UPSERTS // 2, replace=False)
        nxt, statuses, qstat, returned_dead = n0 + 1, {}, {}, 0
        gen0 = checks["generation"]
        for j in range(LIVE_UPSERTS):
            if j % 2:
                i, row = int(upd[j // 2]), ball_nudge(
                    table[int(upd[j // 2])], 0.05, rng)
            else:
                src = int(rng.integers(0, n0))
                i, row, nxt = nxt, ball_nudge(table[src], 0.05, rng), nxt + 1
            (s, b, _), = fd_requests(addr, [("POST", "/v1/upsert", {
                "ids": [i], "rows": [row.tolist()]})])
            statuses[str(s)] = statuses.get(str(s), 0) + 1
            if j % LIVE_QUERY_EVERY == LIVE_QUERY_EVERY - 1:
                ids = rng.integers(0, n0, 8).tolist()
                (s, b, _), = fd_requests(addr, [("POST", "/v1/topk",
                                                 {"ids": ids, "k": K})])
                qstat[str(s)] = qstat.get(str(s), 0) + 1
                returned_dead += int(n0 in np.asarray(b["neighbors"]))
        if not eng.join_compaction(600):
            raise AssertionError(f"live {name}: the compaction never ended")
        background = list(compactions)
        traffic_launches = lane_counts()
        after_traffic = first_use(reg)
        delta = reg.snapshot(baseline=base)
        tail = eng.segment_rows
        eng.compact()              # what came after the snapshot, folded
        gen = eng.generation
        master = eng.master.to_array()
        # answers against a fresh frozen engine over the master (the
        # compacted base's index) and, exact, a float64 brute force
        live_ids = np.setdiff1d(np.arange(master.shape[0]), [n0])
        qids = rng.choice(live_ids, 64, replace=False)
        (sq, ans, _), = fd_requests(addr, [("POST", "/v1/topk", {
            "ids": qids.tolist(), "k": K})])
        fresh = QueryEngine(master, ("poincare", C), scan_mode="two_stage",
                            index=eng.base.index, nprobe=kw.get("nprobe", 0))
        fi, fd = (x.cpu().numpy() for x in fresh.topk_neighbors(
            qids.astype(np.int32), K + 1))
        keep = fi != n0
        fi = np.stack([row[m][:K] for row, m in zip(fi, keep)])
        fd = np.stack([row[m][:K] for row, m in zip(fd, keep)])
        ai = np.asarray(ans["neighbors"])
        ad = np.asarray(ans["dists"], np.float32)
        equals_fresh = bool(np.array_equal(ai, fi)
                            and np.array_equal(ad, fd))
        tab64 = torch.as_tensor(master[live_ids], dtype=torch.float64)
        d64 = PoincareBall(C).dist(
            torch.as_tensor(master[qids[:16]], dtype=torch.float64)[:, None],
            tab64[None])
        d64[torch.as_tensor(live_ids)[None, :]
            == torch.as_tensor(qids[:16])[:, None]] = float("inf")
        ref_d, ref_o = torch.sort(d64, dim=1, stable=True)
        ref_i = live_ids[ref_o[:, :K].numpy()]
        truth_bad = topk_disagreements(
            ai[:16], ad[:16].astype(np.float64), ref_i,
            ref_d[:, :K].numpy(), rtol=TRUTH_RTOL, atol=TRUTH_ATOL)
        recall = float(np.mean([len(set(a) & set(b)) / K
                                for a, b in zip(ai[:16], ref_i)]))
        del fresh
        gc.collect()
    finally:
        closing = door.drain()
    res = {"base": name, **kw, "checks": checks,
           "upserts": LIVE_UPSERTS, "upsert_statuses": statuses,
           "query_statuses": qstat, "deleted_returned": returned_dead,
           "generation_after_traffic": closing.get("generation"),
           "generation_before_traffic": gen0,
           "compaction_s_background": background,
           "compaction_s_tail": compactions[len(background):],
           "segment_rows_after_background": tail,
           "generation_after_compaction": gen,
           "upsert_visible_ms": hist_summary(delta,
                                             "serve/upsert_visible_ms"),
           "e2e_ms": hist_summary(delta, "serve/e2e_ms"),
           "launches": traffic_launches,
           "prewarm_launches": door.prewarm_launches,
           "first_use_after_prewarm": door.first_use,
           "first_use_after_traffic": after_traffic,
           "equals_fresh_engine": equals_fresh, "fresh_status": sq,
           "rows_disagreeing_with_f64": truth_bad,
           "recall_vs_f64": recall, "rows": int(master.shape[0]),
           "seconds": time.perf_counter() - t0, **card}
    emit({"phase": "live", **res})
    if (checks["statuses"] != [200] * 5 + [400, 200, 200]
            or not checks["planted_top1"] or checks["reupsert_inserted"]
            or checks["deleted_query_kind"] != "validation"
            or not checks["deleted_never_returned"]
            or checks["generation"] != 3):
        raise AssertionError(f"live {name}: {checks}")
    if (set(statuses) != {"200"} or set(qstat) != {"200"} or returned_dead
            or not background or not equals_fresh or sq != 200):
        raise AssertionError(f"live {name}: traffic or answers: {res}")
    if name == "exact" and truth_bad:
        raise AssertionError(f"live {name}: {truth_bad} rows disagree with "
                             "the float64 brute force over the live rows")
    if traffic_launches["pdist"] < 1:
        raise AssertionError(f"live {name}: the traffic launched no pdist")
    for key in ("builds", "loads"):
        if after_traffic[key] != door.first_use[key]:
            raise AssertionError(f"live {name}: kernel {key} moved: "
                                 f"{door.first_use} -> {after_traffic}")
    return res


def live_batch_times(torch, art: str, kw: dict, rng, card: dict) -> dict:
    """Phase 63's batch of 1024 queries through a ``LiveQueryEngine`` (the
    CLI's construction, compaction off) with an empty and a full delta
    segment, beside its frozen base: host ms (CUDA events around
    back-to-back batches) and busy ms (profiler device time)."""
    from hyperspace_torch.parallel.host_table import HostEmbedTable
    from hyperspace_torch.serve import QueryEngine, load_artifact
    from hyperspace_torch.serve.delta import LiveQueryEngine

    a = load_artifact(art)
    base = QueryEngine.from_artifact(a, scan_mode="two_stage", **kw)
    live = LiveQueryEngine(base, HostEmbedTable.from_array(
        np.array(a.table, np.float32)), capacity=LIVE_CAP,
        auto_compact=False)
    ids = rng.choice(a.num_nodes, BATCH, replace=False)

    def run(eng):
        return lambda: eng.topk_neighbors(ids, K)

    out = {"frozen": {"batch_ms": timed_ms(torch, run(base), 10),
                      "busy_ms": device_ms(torch, run(base), 5)},
           "empty_delta": {"batch_ms": timed_ms(torch, run(live), 10),
                           "busy_ms": device_ms(torch, run(live), 5)}}
    n = a.num_nodes
    src = rng.integers(0, n, LIVE_CAP)
    live.upsert(np.arange(n, n + LIVE_CAP),
                np.stack([ball_nudge(a.table[i], 0.05, rng) for i in src]))
    out["full_delta"] = {"batch_ms": timed_ms(torch, run(live), 10),
                         "busy_ms": device_ms(torch, run(live), 5),
                         "segment_rows": live.segment_rows}
    return {**out, **card}


def live_path(torch, art: str, ivf: str, rng, card: dict) -> dict:
    """Phase 63: the live index on phase 4's table (exact) and phase 16's
    IVF artifact (nprobe 8)."""
    out = {}
    for name, path, kw in (("exact", art, {}), ("ivf", ivf, {"nprobe": 8})):
        out[name] = live_door(torch, name, path, kw, rng, card)
        out[name]["batch"] = live_batch_times(torch, path, kw, rng, card)
        emit({"phase": "live_batch", "base": name, **out[name]["batch"]})
    return out


def rollover_path(torch, art: str, target: str, card: dict) -> dict:
    """Phase 64: ``serve-http`` (fused, prewarmed) over phase 4's table,
    ``POST /admin/rollover`` to phase 54's artifact: the report, the
    answers against a solo door's on that artifact, ``memory_allocated``
    before and after the flip against the two engines' device bytes, and
    the first-use counters."""
    import gc

    from hyperspace_torch.serve.registry import engine_device_bytes
    from hyperspace_torch.telemetry import registry as telem

    reg = telem.default_registry()
    t0 = time.perf_counter()
    ids = list(range(0, 5461, 341))
    door = CliDoor(artifact=art, scan_mode="fused", prewarm="1", k=K)
    try:
        (s0, _b, _), = fd_requests(door.addr, [("POST", "/v1/topk",
                                                {"ids": ids, "k": K})])
        old_bytes = engine_device_bytes(door.door.batcher.engine)
        torch.cuda.synchronize()
        gc.collect()
        m0 = torch.cuda.memory_allocated()
        before = first_use(reg)
        (sr, rep, _), (s1, ans, _), (sh, health, _) = fd_requests(
            door.addr, [("POST", "/admin/rollover", {"target": target}),
                        ("POST", "/v1/topk", {"ids": ids, "k": K}),
                        ("GET", "/healthz", None)])
        new_bytes = engine_device_bytes(door.door.batcher.engine)
        torch.cuda.synchronize()
        gc.collect()
        m1 = torch.cuda.memory_allocated()
        after = first_use(reg)
        launches = lane_counts()
    finally:
        door.drain()
    solo = serve_http_door(target, {}, ids)
    equal = bool(s1 == 200
                 and np.array_equal(ans["neighbors"], solo["neighbors"])
                 and np.array_equal(np.asarray(ans["dists"], np.float64),
                                    solo["dists"]))
    res = {"statuses": [s0, sr, s1, sh], "report": rep,
           "healthz_fingerprint": health.get("fingerprint"),
           "equals_solo_door": equal, "memory_allocated": [m0, m1],
           "old_engine_bytes": old_bytes, "new_engine_bytes": new_bytes,
           "first_use_before": before, "first_use_after": after,
           "launches": launches, "seconds": time.perf_counter() - t0, **card}
    emit({"phase": "rollover", **res})
    if res["statuses"] != [200] * 4 or not rep.get("flipped") or not equal:
        raise AssertionError(f"rollover: {res}")
    if health.get("fingerprint") != rep["new_fingerprint"]:
        raise AssertionError(f"rollover: /healthz still names the old "
                             f"artifact: {res}")
    if m0 - m1 < old_bytes - new_bytes - ALLOC_SLACK:
        raise AssertionError(f"rollover: memory_allocated fell by "
                             f"{m0 - m1} B, the old engine held {old_bytes}")
    if after != before:
        raise AssertionError(f"rollover: first-use counters moved: "
                             f"{before} -> {after}")
    return res


TENANTS = (("ball", "art", {"scan_mode": "fused"}),
           ("hyperboloid", "lorentz", {"scan_mode": "two_stage"}),
           ("ivf", "ivf", {"scan_mode": "fused", "nprobe": 8}))


def tenant_registry(paths: dict, budget_mb: float = 0.0):
    from hyperspace_torch.serve.registry import EngineRegistry

    reg = EngineRegistry(device_budget_mb=budget_mb, prewarm_ks=(K,))
    for name, key, kw in TENANTS:
        reg.add_tenant(name, paths[key], engine_kw=dict(kw),
                       batcher_kw={"cache_size": 0})
    return reg


def tenants_path(torch, paths: dict, rng, card: dict) -> dict:
    """Phase 65: three tenants behind one door (``EngineRegistry`` +
    ``run_front_door(registry=)``): phase 4's table (fused), its
    hyperboloid lift (two_stage), phase 16's IVF artifact (fused, nprobe
    8).  Routing by name and by fingerprint against solo engines, an
    unknown tenant, ``?tenant=`` stats, per-tenant latency with one
    tenant offered 10x another's rate; then under a budget of one engine,
    alternating tenants: admissions, evictions, ``memory_allocated``
    around each switch, a cold tenant's first answer, the answers against
    the unbudgeted ones; then ``serve-http tenants=<file>``."""
    import gc

    from hyperspace_torch.serve import QueryEngine, load_artifact
    from hyperspace_torch.serve.registry import engine_device_bytes
    from hyperspace_torch.telemetry import registry as telem

    treg = telem.default_registry()
    t0 = time.perf_counter()
    ids = rng.choice(ROWS, 8, replace=False).tolist()
    solo, fps, nbytes = {}, {}, {}
    for name, key, kw in TENANTS:
        eng = QueryEngine.from_artifact(load_artifact(paths[key]), **kw)
        i, d = eng.topk_neighbors(np.asarray(ids, np.int32), K)
        solo[name] = (i.cpu().numpy(), d.cpu().numpy())
        fps[name], nbytes[name] = eng.fingerprint, engine_device_bytes(eng)
        del eng
    gc.collect()

    def same(body, name) -> bool:
        return bool(np.array_equal(body["neighbors"], solo[name][0])
                    and np.array_equal(np.asarray(body["dists"], np.float32),
                                       solo[name][1]))

    fd = FrontDoorThread(None, registry=tenant_registry(paths))
    try:
        base = treg.mark()
        reqs = [("POST", "/v1/topk", {"ids": ids, "k": K, "tenant": t})
                for t in [n for n, _, _ in TENANTS] + [fps["hyperboloid"],
                                                        fps["ivf"]]]
        reqs += [("POST", "/v1/topk", {"ids": ids, "k": K}),
                 ("POST", "/v1/topk", {"ids": ids, "k": K,
                                       "tenant": "nobody"}),
                 ("GET", "/v1/stats?tenant=ivf", None),
                 ("GET", "/healthz", None)]
        got = fd_requests(fd.addr, reqs)
        routed = [same(got[j][1], n) for j, n in enumerate(
            ["ball", "hyperboloid", "ivf", "hyperboloid", "ivf", "ball"])]
        spec = [{"host": fd.addr[0], "port": fd.addr[1], "size": 1,
                 "qps": q, "seconds": TENANT_LOAD_S, "seed": 65 + j,
                 "rows": ROWS, "k": K, "tenant": t}
                for j, (t, q) in enumerate(zip(("ball", "hyperboloid"),
                                               TENANT_QPS))]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--load-client", json.dumps(sp)],
                                  stdout=subprocess.PIPE, text=True, cwd=REPO)
                 for sp in spec]
        clients = [json.loads(p.communicate(timeout=300)[0].strip()
                              .splitlines()[-1]) for p in procs]
        delta = treg.snapshot(baseline=base)
        launches = lane_counts()
        stats = json.loads(got[7][2])
    finally:
        fd.drain()
    load = {t: {"offered_qps": c["offered_qps"], "statuses": c["statuses"],
                "client_ms": c["client_ms"],
                "e2e_ms": hist_summary(delta, f"serve/e2e_ms@tenant={t}")}
            for t, c in zip(("ball", "hyperboloid"), clients)}
    first = {"statuses": [g[0] for g in got], "routed_equal_solo": routed,
             "unknown_kind": (got[6][1] or {}).get("error", {}).get("kind"),
             "stats_tenant": stats.get("tenant"), "load": load,
             "launches": launches}
    emit({"phase": "tenants", **first, **card})
    if (first["statuses"] != [200] * 6 + [404, 200, 200] or not all(routed)
            or first["unknown_kind"] != "unknown_tenant"
            or first["stats_tenant"] != "ivf"):
        raise AssertionError(f"tenants: {first}")
    for t, c in load.items():
        if set(c["statuses"]) != {"200"}:
            raise AssertionError(f"tenants: load on {t}: {c}")

    # paging: a budget that holds the largest engine and not two
    budget = max(nbytes.values()) * 1.25 / (1 << 20)
    fd = FrontDoorThread(None, registry=tenant_registry(paths, budget))
    switches = []
    try:
        before = first_use(treg)
        names = [n for n, _, _ in TENANTS]
        for t in names * 2 + ["ball"]:
            stacks = {s.name: s for s in fd.door.registry.tenants()}
            cold = not stacks[t].resident
            out_of = [s.name for s in stacks.values() if s.resident]
            torch.cuda.synchronize()
            gc.collect()
            m0 = torch.cuda.memory_allocated()
            c0 = time.perf_counter()
            (st, body, _), = fd_requests(fd.addr, [("POST", "/v1/topk", {
                "ids": ids, "k": K, "tenant": t})])
            ms = (time.perf_counter() - c0) * 1e3
            torch.cuda.synchronize()
            gc.collect()
            m1 = torch.cuda.memory_allocated()
            evicted = [n for n in out_of if not stacks[n].resident]
            switches.append({
                "tenant": t, "status": st, "cold": cold, "ms": ms,
                "evicted": evicted, "memory_allocated": [m0, m1],
                "freed_enough": m0 - m1 >= sum(nbytes[e] for e in evicted)
                - (nbytes[t] if cold else 0) - ALLOC_SLACK,
                "equals_unbudgeted": same(body, t)})
        after = first_use(treg)
        summary = {s.name: s.summary() for s in fd.door.registry.tenants()}
    finally:
        fd.drain()
    paging = {"budget_mb": budget, "engine_bytes": nbytes,
              "switches": switches,
              "admissions": {n: s["admissions"] for n, s in summary.items()},
              "evictions": {n: s["evictions"] for n, s in summary.items()},
              "cold_first_answer_ms": [w["ms"] for w in switches
                                       if w["cold"]],
              "first_use_before": before, "first_use_after": after}
    emit({"phase": "tenant_paging", **paging, **card})
    if (any(w["status"] != 200 or not w["equals_unbudgeted"]
            or not w["freed_enough"] for w in switches)
            or sum(paging["evictions"].values()) < len(names)
            or after != before):
        raise AssertionError(f"tenant paging: {paging}")

    # the CLI's roster path: one fused scan mode for every tenant
    roster = os.path.join(os.path.dirname(paths["art"]), "tenants.json")
    with open(roster, "w") as f:
        json.dump([{"name": n, "artifact": paths[k],
                    **({"nprobe": 8} if n == "ivf" else {})}
                   for n, k, _ in TENANTS], f)
    door = CliDoor(tenants=roster, scan_mode="fused", prewarm="1", k=K)
    try:
        cli = fd_requests(door.addr, [
            ("POST", "/v1/topk", {"ids": ids, "k": K, "tenant": n})
            for n, _, _ in TENANTS] + [("POST", "/v1/topk", {
                "ids": ids, "k": K, "tenant": "nobody"})])
    finally:
        closing = door.drain()
    res = {**first, "paging": paging,
           "cli_statuses": [c[0] for c in cli],
           "cli_tenants": sorted(closing.get("tenants", {})),
           "seconds": time.perf_counter() - t0, **card}
    emit({"phase": "tenants_cli", "statuses": res["cli_statuses"],
          "tenants": res["cli_tenants"]})
    if res["cli_statuses"] != [200, 200, 200, 404]:
        raise AssertionError(f"serve-http tenants=: {res['cli_statuses']}")
    return res


def stream_table(torch, rng) -> np.ndarray:
    """``STREAM_ROWS`` clustered rows in the 10-dim ball (c = 1), made in
    blocks on the host."""
    from hyperspace_torch.manifolds import PoincareBall

    centers = rng.standard_normal((STREAM_CLUSTERS, DIM)) * 0.25
    out = np.empty((STREAM_ROWS, DIM), np.float32)
    for lo in range(0, STREAM_ROWS, 1 << 18):
        n = min(1 << 18, STREAM_ROWS - lo)
        vv = (centers[rng.integers(0, STREAM_CLUSTERS, size=n)]
              + rng.standard_normal((n, DIM)) * 0.05)
        out[lo:lo + n] = PoincareBall(C).expmap0(
            torch.as_tensor(vv, dtype=torch.float32)).numpy()
    return out


def stream_build_path(torch, rng, card: dict) -> dict:
    """Phase 66: the host-streamed IVF build of ``STREAM_ROWS`` rows (auto:
    above ``HOST_BUILD_ROWS``), then the resident build from the same
    seeds (``host_resident=False``; both seed from a sample of the
    streamed build's default size): the cell layouts, the device rows
    peak, each build's seconds, recall@10 at nprobe 8 against the exact
    fused scan."""
    from hyperspace_torch.serve import QueryEngine
    from hyperspace_torch.serve import index as ix
    from hyperspace_torch.telemetry import registry as telem

    t0 = time.perf_counter()
    table = stream_table(torch, rng)
    spec, ncells = ("poincare", C), ix.auto_ncells(STREAM_ROWS)
    data_s = time.perf_counter() - t0
    telem.set_gauge("index/build_device_rows_peak", 0)
    t1 = time.perf_counter()
    streamed = ix.build_index(table, spec, ncells,
                              seed_sample=ix.SEED_SAMPLE_DEFAULT)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t1
    peak = telem.default_registry().snapshot()[
        "index/build_device_rows_peak"]
    t1 = time.perf_counter()
    resident = ix.build_index(table, spec, ncells, host_resident=False,
                              seed_sample=ix.SEED_SAMPLE_DEFAULT)
    torch.cuda.synchronize()
    resident_s = time.perf_counter() - t1

    def assign(index):
        a = np.empty(STREAM_ROWS, np.int64)
        for c, row in enumerate(index.cells):
            a[row[row >= 0]] = c
        return a

    sa, ra = assign(streamed), assign(resident)
    diff = np.flatnonzero(sa != ra)
    ties = True
    if diff.size:
        # each differing row: its distances to the two cells' centroids
        # equal within the f32 tier
        from hyperspace_torch.manifolds import PoincareBall

        x = torch.as_tensor(table[diff], dtype=torch.float64)
        ds = PoincareBall(C).dist(x, torch.as_tensor(
            streamed.centroids[sa[diff]], dtype=torch.float64))
        dr = PoincareBall(C).dist(x, torch.as_tensor(
            resident.centroids[ra[diff]], dtype=torch.float64))
        ties = bool(torch.all((ds - dr).abs() <= 1e-6 + 1e-5 * dr.abs()))
    qids = rng.choice(STREAM_ROWS, STREAM_QUERIES, replace=False)
    ivf = QueryEngine(table, spec, index=streamed, nprobe=8,
                      scan_mode="fused")
    exact = QueryEngine(table, spec, scan_mode="fused")
    q = qids.astype(np.int32)
    ii = ivf.topk_neighbors(q, K)[0].cpu().numpy()
    ei = exact.topk_neighbors(q, K)[0].cpu().numpy()
    recall = float(np.mean([len(set(a) & set(b)) / K
                            for a, b in zip(ii, ei)]))
    res = {"rows": STREAM_ROWS, "dim": DIM, "ncells": ncells,
           "max_cell": streamed.max_cell, "data_s": data_s,
           "stream_s": stream_s, "resident_s": resident_s,
           "device_rows_peak": peak, "rows_assigned_differently":
           int(diff.size), "differing_rows_near_ties": ties,
           "centroids_max_abs_diff": float(np.max(np.abs(
               streamed.centroids - resident.centroids))),
           "recall_at_10_nprobe8": recall,
           "seconds": time.perf_counter() - t0, **card}
    emit({"phase": "stream_build", **res})
    if peak != ix._BUILD_CHUNK or not ties:
        raise AssertionError(f"stream build: {res}")
    return res


def serving_plane_path(torch, spec: dict, rng) -> dict:
    """Phases 63-66 in the front-door process."""
    from hyperspace_torch.manifolds.maps import ball_to_lorentz
    from hyperspace_torch.serve import export_artifact, load_artifact

    card, tmp = spec["card"], spec["tmp"]
    lor = os.path.join(tmp, "lorentz")
    table = load_artifact(spec["art"]).table
    export_artifact(lor, ball_to_lorentz(torch.as_tensor(
        np.array(table)), C).numpy(), ("lorentz", C))
    paths = {"art": spec["art"], "ivf": spec["ivf"], "lorentz": lor}
    out = {}
    for name, fn in (
            ("live", lambda: live_path(torch, spec["art"], spec["ivf"], rng,
                                       card)),
            ("rollover", lambda: rollover_path(
                torch, spec["art"], os.path.join(tmp, "fd_art"), card)),
            ("tenants", lambda: tenants_path(torch, paths, rng, card)),
            ("stream", lambda: stream_build_path(torch, rng, card))):
        t0 = time.perf_counter()
        out[name] = fn()
        emit({"phase": f"serving_plane_{name}_done",
              "seconds": time.perf_counter() - t0})
    return out


def front_door_path(torch, args, card: dict, table_b, ivf_art) -> dict:
    """Phases 50-54: phase 4's table and phase 16's IVF/PQ artifact are
    exported again here, then served by a process of their own (this
    script with ``--front-door``), as a user's server runs apart from
    training: none of the earlier phases' threads, objects or allocator
    state share its interpreter.  Its phase lines are relayed; its last
    line is the result."""
    from hyperspace_torch.serve import export_artifact

    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=work)
    try:
        spec = {"art": os.path.join(tmp, "poincare"),
                "ivf": os.path.join(tmp, "ivf_pq"), "tmp": tmp,
                "seed": args.seed, "card": card}
        export_artifact(spec["art"], table_b.cpu().numpy(), ("poincare", C))
        export_artifact(spec["ivf"], ivf_art.table, ivf_art.manifold_spec,
                        index=ivf_art.index, quant=ivf_art.quant)
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--front-door", json.dumps(spec)],
                             capture_output=True, text=True, timeout=900,
                             cwd=REPO)
        sys.stderr.write(out.stderr)
        lines = out.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(line, flush=True)
        if out.returncode:
            raise AssertionError(f"the front-door process exited "
                                 f"{out.returncode}: {out.stderr[-3000:]}")
        return json.loads(lines[-1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def front_door_phases(torch, spec: dict) -> dict:
    """The body of phases 50-54 in the front-door process."""
    rng = np.random.default_rng([spec["seed"], 50])
    art, ivf, tmp, card = spec["art"], spec["ivf"], spec["tmp"], spec["card"]
    t_all = time.perf_counter()
    out: dict = {}
    ids8 = rng.choice(ROWS, 8, replace=False).tolist()
    ids1024 = rng.choice(ROWS, BATCH, replace=False).tolist()
    u = rng.integers(0, ROWS, 8).tolist()
    v = rng.integers(0, ROWS, 8).tolist()
    t0 = time.perf_counter()
    out["checks"] = {m: front_door_checks(torch, art, m, ids8, ids1024, u, v,
                                          rng, card)
                     for m in ("fused", "two_stage")}
    loads = sum(c["prewarm"]["kernel_loads"] for c in out["checks"].values())
    if loads < 1:
        raise AssertionError("the prewarms of this fresh process loaded no "
                             "kernel library")
    out["control"] = front_door_control(torch, art, ids8, card)
    emit({"phase": "front_door_checks_done",
          "seconds": time.perf_counter() - t0})
    for name, fn in (
            ("latency", lambda: front_door_latency(torch, art, rng, card)),
            ("overload", lambda: front_door_overload(
                torch, ivf, rng, 10 * max(p["offered_qps"] for p in
                                          out["latency"]["passes"]), card)),
            ("deadline_drain", lambda: front_door_deadline_drain(
                torch, art, card)),
            ("export", lambda: front_door_export(torch, tmp, card)),
            ("lanes", lambda: front_door_lanes(torch, tmp, card))):
        t0 = time.perf_counter()
        out[name] = fn()
        emit({"phase": f"front_door_{name}_done",
              "seconds": time.perf_counter() - t0})
    out["seconds"] = time.perf_counter() - t_all
    # phases 63-66: the live index, rollover, tenants, the streamed build
    out["plane"] = serving_plane_path(torch, spec, rng)
    return out


def front_door_fields(fp: dict, kernels: list) -> None:
    """``launches_front_door`` on the serving kernels' entries: their
    launches by the doors' traffic over phases 50-54 (each door's counts
    set to 0 once its listener is up and read after its traffic), and
    ``launches_front_door_prewarm``: the launches of those doors'
    prewarms; ``launches_live`` and ``launches_tenants`` on rows 1, 2 and
    4: the traffic of phase 63's two live doors (compactions included)
    and of phase 65's three-tenant door, prewarms apart."""
    doors = (list(fp["checks"].values())
             + [fp["control"], fp["latency"], fp["overload"]]
             + list(fp["export"]["served"].values())
             + list(fp["lanes"]["served"].values()))
    for entry in kernels:
        name = entry["name"]
        if name in doors[0]["launches"]:
            entry["launches_front_door"] = sum(d["launches"][name]
                                               for d in doors)
            entry["launches_front_door_prewarm"] = sum(
                d["prewarm"]["launches"][name] for d in doors
                if "prewarm" in d)
    # phases 63 and 65: the traffic's launches, prewarms apart
    live, ten = fp["plane"]["live"], fp["plane"]["tenants"]
    for entry in kernels:
        name = entry["name"]
        if name in ("pdist", "scan_topk", "scan_topk_cand"):
            entry["launches_live"] = sum(d["launches"][name]
                                         for d in live.values())
            entry["launches_tenants"] = ten["launches"][name]


def front_door_line(fp: dict) -> dict:
    """The numbers of phases 50-54 in one object."""
    lat = fp["latency"]
    return {"front_door": {
        "capacity_per_s": lat["capacity_per_s"],
        "latency": [{k: p[k] for k in ("load", "offered_qps",
                                       "ids_per_request", "e2e_ms",
                                       "client_ms", "waited_for_socket",
                                       "stages_ms", "batching_factor",
                                       "statuses", "achieved_offered_qps",
                                       "answered_per_s")}
                    for p in lat["passes"]],
        "memory_reserved": [lat["memory_reserved_before"],
                            lat["memory_reserved_after"]],
        "overload": {k: fp["overload"][k] for k in (
            "offered_qps", "achieved_offered_qps", "answered_per_s",
            "requests", "statuses", "shed_rate", "degraded", "recovered",
            "degraded_answers_checked", "cold_dispatches", "client_ms")},
        "first_use_flat_after_prewarm": all(
            c["first_use_after_traffic"] == c["first_use_after_prewarm"]
            for c in fp["checks"].values()),
        "prewarm_kernel_loads": {m: c["prewarm"]["kernel_loads"]
                                 for m, c in fp["checks"].items()},
        "control_without_prewarm": fp["control"]["requests"],
        "flushes_of_64_singles": {m: c["flushes"]
                                  for m, c in fp["checks"].items()},
        "seconds": fp["seconds"]}, "serving_plane": plane_line(fp["plane"])}


def plane_line(pl: dict) -> dict:
    """The numbers of phases 63-66 in one object."""
    live = {name: {k: d[k] for k in (
        "upsert_visible_ms", "compaction_s_background", "compaction_s_tail",
        "generation_after_traffic", "equals_fresh_engine",
        "rows_disagreeing_with_f64", "recall_vs_f64", "seconds")}
        | {"batch": {k: d["batch"][k] for k in (
            "frozen", "empty_delta", "full_delta")}}
        for name, d in pl["live"].items()}
    ro, te, st = pl["rollover"], pl["tenants"], pl["stream"]
    return {
        "live": live,
        "rollover": {"seconds_report": ro["report"]["seconds"],
                     "memory_allocated": ro["memory_allocated"],
                     "old_engine_bytes": ro["old_engine_bytes"],
                     "new_engine_bytes": ro["new_engine_bytes"]},
        "tenants": {"load": te["load"],
                    "cold_first_answer_ms": te["paging"][
                        "cold_first_answer_ms"],
                    "admissions": te["paging"]["admissions"],
                    "evictions": te["paging"]["evictions"],
                    "engine_bytes": te["paging"]["engine_bytes"]},
        "stream_build": {k: st[k] for k in (
            "rows", "ncells", "stream_s", "resident_s", "device_rows_peak",
            "rows_assigned_differently", "recall_at_10_nprobe8")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--load-client", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--front-door", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.load_client:            # phases 51-52's client process
        emit(load_client(json.loads(args.load_client)))
        return 0
    if args.front_door:             # phases 50-54's serving process
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: CUDA is not available", file=sys.stderr)
            return 1
        emit(front_door_phases(torch, json.loads(args.front_door)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # every host prep here is a build: no "auto" prep-cache entry is read
    # or written (phase 39 times a miss and a hit in a cache of its own)
    os.environ["HYPERSPACE_GRAPH_CACHE"] = "0"
    from hyperspace_torch.cli import serve as cli
    from hyperspace_torch.kernels import _support
    from hyperspace_torch.kernels.distmat import pdist, pdist_plain
    from hyperspace_torch.kernels.scan_topk import scan_topk, scan_topk_plain
    from hyperspace_torch.manifolds import Lorentz, PoincareBall
    from hyperspace_torch.manifolds.maps import ball_to_lorentz
    from hyperspace_torch.serve import (QueryEngine, RequestBatcher,
                                        export_artifact, load_artifact)
    from hyperspace_torch.serve.engine import auto_chunk_rows
    from hyperspace_torch.telemetry import registry as telem

    # --- phase 1: the card -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    card = {"card": smi}
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    dev = torch.device("cuda")
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # --- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    _support.build_all(["pdist", "scan_topk", "segment", "cluster",
                        "attention", "mlr", "pointwise", "hyplinear"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0, **card})

    # --- data from the seed ------------------------------------------------
    rng = np.random.default_rng(args.seed)
    ball = PoincareBall(C)

    def ball_rows(n):
        v = torch.as_tensor(rng.standard_normal((n, DIM)) * 0.5,
                            dtype=torch.float32, device=dev)
        return ball.expmap0(v).contiguous()

    table_b = ball_rows(ROWS)
    table_l = ball_to_lorentz(table_b, C).contiguous()
    fresh_b = ball_rows(BATCH)            # queries that are not table rows
    fresh_l = ball_to_lorentz(fresh_b, C).contiguous()
    chunk = auto_chunk_rows(ROWS)         # the engine's two-stage chunk
    padded = -(-ROWS // chunk) * chunk
    kinds = (("poincare", table_b, fresh_b), ("lorentz", table_l, fresh_l))

    # --- phase 3: kernels vs their plain versions --------------------------
    # the served buckets: 8 and 1024 query rows
    err = {"pdist": 0.0, "scan_topk": 0.0}
    for man, table, fresh in kinds:
        for b in (8, BATCH):
            q = fresh[:b]
            # a served chunk, the table, the IVF export's 287 centroids
            for rows in (table[:chunk], table, table[:287]):
                got = pdist(q, rows, C, manifold=man)
                again = pdist(q, rows, C, manifold=man)
                torch.cuda.synchronize()
                want = pdist_plain(q, rows, C, manifold=man)
                diff = (got - want).abs()
                worst = float(diff.max())
                err["pdist"] = max(err["pdist"], worst)
                over = int((diff > ATOL + RTOL * want.abs()).sum())
                same = bool(torch.equal(got, again))
                emit({"phase": "check", "kernel": "pdist", "manifold": man,
                      "shape": [b, rows.shape[0], rows.shape[1]],
                      "max_abs_err": worst, "over_tolerance": over,
                      "repeat_equal": same})
                if over or not same:
                    raise AssertionError(
                        f"pdist {man}: {over} entries beyond "
                        f"rtol={RTOL} atol={ATOL}, repeat equal {same}")
        slab = torch.zeros((padded, table.shape[1]), device=dev)
        slab[:ROWS] = table
        for b, k, ex, (col0, n) in itertools.product(
                (8, BATCH), (1, 10, 256), (False, True),
                ((0, ROWS), (5000, 5000 + ROWS - 115))):
            q = fresh[:b]
            qi = torch.as_tensor(rng.integers(col0, col0 + ROWS, b),
                                 dtype=torch.int32, device=dev)
            d1, i1 = scan_topk(slab, q, qi, col0, spec=(man, C), k=k, n=n,
                               exclude_self=ex)
            torch.cuda.synchronize()
            d2, i2 = scan_topk_plain(slab, q, qi, col0, kind=man, c=C, k=k,
                                     n=n, exclude_self=ex)
            fin = torch.isfinite(d2)
            worst = float((d1 - d2).abs()[fin].max())
            err["scan_topk"] = max(err["scan_topk"], worst)
            bad = _support.topk_disagreements(
                i1.cpu().numpy(), d1.cpu().numpy(), i2.cpu().numpy(),
                d2.cpu().numpy(), rtol=RTOL, atol=ATOL)
            emit({"phase": "check", "kernel": "scan_topk", "manifold": man,
                  "batch": b, "k": k, "exclude_self": ex, "col0": col0,
                  "n": n, "max_abs_err": worst, "rows_disagreeing": bad})
            if bad:
                raise AssertionError(
                    f"scan_topk {man} b={b} k={k} exclude_self={ex} "
                    f"col0={col0}: {bad} rows disagree")

    # --- phase 4: the main path --------------------------------------------
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=work)
    try:
        arts = {}
        for man, table, _q in kinds:
            path = os.path.join(tmp, man)
            export_artifact(path, table.cpu().numpy(), (man, C))
            arts[man] = load_artifact(path)
        ids8 = rng.choice(ROWS, 8, replace=False).tolist()
        ids1024 = rng.choice(ROWS, 1024, replace=False).tolist()
        u = rng.integers(0, ROWS, 8).tolist()
        v = rng.integers(0, ROWS, 8).tolist()
        lines = "\n".join(json.dumps(r) for r in (
            {"op": "topk", "ids": ids8, "k": K},
            {"op": "topk", "ids": ids1024, "k": K},
            {"op": "score", "u": u, "v": v, "prob": True},
            {"op": "stats"})) + "\n"
        pdist.launches = scan_topk.launches = 0
        answers = {}
        for man, _t, _q in kinds:
            for mode in ("two_stage", "fused"):
                out = io.StringIO()
                # the serve counters are process-cumulative: this run's
                # are the delta over a registry mark
                mark = telem.default_registry().mark()
                closing = cli.run_serve(
                    cli.ServeConfig(artifact=os.path.join(tmp, man),
                                    scan_mode=mode),
                    stdin=io.StringIO(lines), stdout=out)
                run = telem.default_registry().snapshot(baseline=mark)
                resp = [json.loads(s) for s in out.getvalue().splitlines()]
                if len(resp) != 4 or any("error" in r for r in resp):
                    raise AssertionError(f"{man}/{mode}: {resp}")
                answers[man, mode] = resp
                emit({"phase": "serve", "manifold": man, "scan_mode": mode,
                      "served": closing["served"],
                      "slots": run.get("serve/slots", 0),
                      "padded_waste": run.get("serve/padded_waste", 0),
                      "cache_hit": run.get("serve/cache_hit", 0)})
        launches = {"pdist": pdist.launches, "scan_topk": scan_topk.launches}
        emit({"phase": "launches", **launches})
        for name, count in launches.items():
            if count < 1:
                raise AssertionError(f"{name} never launched on the path")

        # the answers: shape, order, two_stage vs fused, float64 truth
        truth_man = {"poincare": PoincareBall(C), "lorentz": Lorentz(C)}
        for man, _t, _q in kinds:
            tab64 = torch.as_tensor(arts[man].table, dtype=torch.float64)
            ts, fu = answers[man, "two_stage"], answers[man, "fused"]
            for j, ids in ((0, ids8), (1, ids1024)):
                nb = np.asarray(ts[j]["neighbors"])
                ds = np.asarray(ts[j]["dists"], np.float64)
                if nb.shape != (len(ids), K) or not np.all(np.isfinite(ds)):
                    raise AssertionError(f"{man}: bad top-k shape/values")
                if np.any(np.diff(ds, axis=1) < 0):
                    raise AssertionError(f"{man}: dists not ascending")
                bad = _support.topk_disagreements(
                    nb, ds, np.asarray(fu[j]["neighbors"]),
                    np.asarray(fu[j]["dists"], np.float64),
                    rtol=RTOL, atol=ATOL)
                if bad:
                    raise AssertionError(
                        f"{man}: two_stage and fused disagree on {bad} rows")
            sample = ids1024[:16]
            d64 = truth_man[man].dist(tab64[sample][:, None, :],
                                      tab64[None, :, :])
            d64[torch.arange(16), torch.as_tensor(sample)] = float("inf")
            ref_d, ref_i = torch.sort(d64, dim=1, stable=True)
            bad = _support.topk_disagreements(
                np.asarray(ts[1]["neighbors"][:16]),
                np.asarray(ts[1]["dists"][:16], np.float64),
                ref_i[:, :K].numpy(), ref_d[:, :K].numpy(),
                rtol=TRUTH_RTOL, atol=TRUTH_ATOL)
            s64 = truth_man[man].dist(tab64[u], tab64[v])
            p64 = 1.0 / (torch.exp(torch.square(s64) - 2.0) + 1.0)
            serr = float(np.max(np.abs(np.asarray(ts[2]["scores"])
                                       - p64.numpy())))
            emit({"phase": "truth", "manifold": man,
                  "rows_disagreeing_with_f64": bad,
                  "score_max_abs_err_vs_f64": serr})
            if bad or serr > TRUTH_ATOL:
                raise AssertionError(f"{man}: served answers disagree with "
                                     "the float64 brute force")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # --- phases 16-19: the IVF and PQ serving lanes -------------------------
    ip = ivf_pq_path(torch, args, card, table_l, fresh_b)
    err["scan_topk"] = max(err["scan_topk"], ip["err"]["scan_topk"])

    # --- phases 55-56: the bf16, int8 and int4 lanes ------------------------
    t_lanes = time.perf_counter()
    ql = quant_lane_checks(torch, args, card, kinds, chunk, padded, ip)
    qe = quant_lane_engines(torch, args, card, table_b, ip)
    emit({"phase": "qlanes_total", "seconds": time.perf_counter() - t_lanes})

    # --- phases 5-8: the training path ----------------------------------
    tr = train_path(torch, args, card)

    # --- phases 9-11: the HGCN attention arm --------------------------------
    at = att_path(torch, args, card, tr)

    # --- phases 12-15: the HyboNet path -----------------------------------
    hb = hybonet_path(torch, args, card)

    # --- phases 20-22: the Poincaré ops and the gyro-linear layer ----------
    gp = gyro_path(torch, args, card)

    # --- phases 30-32: HGCN node classification at arxiv scale -------------
    nc = nc_path(torch, args, card, tr)

    # --- phases 33-35: the hyperbolic VAE (no CUDA graph yet) --------------
    hv = hvae_path(torch, args, card)

    # --- phase 23: times ---------------------------------------------------
    # kernel and plain times are device times from the profiler at the
    # main path's shapes; call_ms adds the host's launch path (CUDA
    # events around back-to-back calls)
    table, q = table_b, fresh_b
    slab = torch.zeros((padded, DIM), device=dev)
    slab[:ROWS] = table
    qi = torch.as_tensor(ids1024, dtype=torch.int32, device=dev)
    rows = table[:chunk]

    def run_pdist(b, y=rows):
        return lambda: pdist(q[:b], y, C, manifold="poincare")

    def run_scan(b):
        return lambda: scan_topk(slab, q[:b], qi[:b], 0, spec=("poincare", C),
                                 k=K, n=ROWS, exclude_self=True)

    pb, pby = bound_ms(*pdist_cost(BATCH, chunk, DIM))
    sb, sby = bound_ms(*scan_cost(BATCH, padded, ROWS, DIM, K))
    kernels = [
        {"name": "pdist", "route": "cuda",
         "source": "hyperspace_torch/kernels/csrc/pdist.cu",
         "entry": "hs_pdist",
         "replaces": "hyperspace_tpu/kernels/distmat.py:119",
         "launches": launches["pdist"], "max_abs_err": err["pdist"],
         "shape": [BATCH, chunk, DIM],
         "ms": device_ms(torch, run_pdist(BATCH)),
         "plain_ms": device_ms(torch, lambda: pdist_plain(
             q, rows, C, manifold="poincare")),
         "bound_ms": pb, "bound_by": pby, "library_ms": None,
         "call_ms": timed_ms(torch, run_pdist(BATCH)),
         "ms_bucket8": device_ms(torch, run_pdist(8)),
         "bound_ms_bucket8": bound_ms(*pdist_cost(8, chunk, DIM))[0],
         "full_table_ms": device_ms(torch, run_pdist(BATCH, table)),
         "bound_ms_full_table": bound_ms(*pdist_cost(BATCH, ROWS, DIM))[0],
         **card},
        {"name": "scan_topk", "route": "cuda",
         "source": "hyperspace_torch/kernels/csrc/scan_topk.cu",
         "entry": "hs_scan_topk",
         "replaces": "hyperspace_tpu/kernels/scan_topk.py:677",
         "launches": launches["scan_topk"],
         "max_abs_err": err["scan_topk"],
         "shape": [BATCH, padded, DIM, K],
         **scan_parts(torch, run_scan(BATCH)),
         "plain_ms": device_ms(torch, lambda: scan_topk_plain(
             slab, q, qi, 0, kind="poincare", c=C, k=K, n=ROWS,
             exclude_self=True), reps=3),
         "bound_ms": sb, "bound_by": sby, "library_ms": None,
         "call_ms": timed_ms(torch, run_scan(BATCH)),
         **{f"{key}_bucket8": v
            for key, v in scan_parts(torch, run_scan(8)).items()}, **card},
    ] + ivf_pq_kernel_entries(torch, ip, card) + quant_lane_entries(
        torch, ql, qe, ip, card) + train_kernel_entries(
        torch, tr, card) + att_kernel_entries(
        torch, at, card) + hybonet_kernel_entries(
        torch, hb, card) + gyro_kernel_entries(torch, gp, card)
    nc_kernel_fields(torch, nc, kernels)
    for entry in kernels:      # the mean path's kernels on the attention arm
        if entry["name"] in ("csr_segment_sum", "cluster_aggregate"):
            entry["launches_attention"] = at["launches"][entry["name"]]
        if entry["name"] == "csr_segment_sum":
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       at["err"]["csr_segment_sum"])
            entry.update(att_segsum_times(torch, at))
    # requests through the batcher at bucket 1024 with its default cache,
    # each batch of distinct ids never seen before (all cold, so every id
    # is computed), and the engine call alone on the same ids, the two
    # taken in turns; host clock, each ending in the copy of the answer
    # to the host
    cold = rng.permutation(ROWS)[:40 * BATCH].reshape(40, BATCH)
    throughput = {}
    for mode in ("two_stage", "fused"):
        eng = QueryEngine(table.cpu().numpy(), ("poincare", C),
                          scan_mode=mode)
        throughput[mode] = batch_throughput(torch, eng, RequestBatcher(eng),
                                            cold)
    emit({"phase": "throughput", "bucket": BATCH, "k": K,
          "manifold": "poincare", "rows": ROWS, **throughput, **card})
    # the launch floor: an empty kernel launched as the kernels are
    # (benchmarks/launch_floor.py), the least any launch here costs
    from hyperspace_torch.benchmarks.launch_floor import floor_ms
    floor = floor_ms()

    # --- phases 24-29: Poincaré embeddings, RSGD and RAdam ----------------
    # last: its CUDA graphs and epoch-long profiler windows come after
    # every other device time is taken (its own kernel times are taken
    # before its graphs)
    pp = poincare_path(torch, args, card)
    pe_kernel_fields(pp, kernels)

    # --- phases 36-37: the HVAE's graphed chunks and its CLI --------------
    hvae_graphs(torch, hv, card)

    # --- phases 38-43: HGCN through the CLI, from graphs on disk ----------
    cp = cli_path(torch, args, card)
    cli_kernel_fields(torch, cp, kernels)

    # --- phases 44-49: product embeddings and the train runtime ----------
    runtime_path(torch, args, card)

    # --- phases 59-62: graphed HyboNet and HGCN, the spine, the guard -----
    g59 = hybonet_graphed(torch, args, card)
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=work)
    try:
        # --- phase 60: graphed HGCN steps --------------------------------
        g60 = hgcn_graphed(torch, args, card, cp, tmp)
        spine_runs(torch, tmp, card)
        guard_runs(torch, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    graphed_kernel_fields(g59, g60, kernels)

    # --- phases 67-70: training through a host-resident table --------------
    t_host = time.perf_counter()
    hp = host_path(torch, args, card)
    host_kernel_fields(hp, kernels)
    emit({"phase": "host_total", "seconds": time.perf_counter() - t_host})

    # --- phases 50-54: serving through the HTTP front door ----------------
    fp = front_door_path(torch, args, card, table_b, ip["art"])
    front_door_fields(fp, kernels)
    emit(front_door_line(fp))
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": kernels, "floor_ms": floor})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
