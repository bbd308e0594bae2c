#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`embiggen_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, one line each (with its seconds), in order; any failure raises and
the exit code is not 0. The quality phases (9, 13, 16, 20, 23, 27, 30 and 38:
host-bound training on the gate fixture, timing no kernel) run in a second
process (`--quality`, on the kernels phase 2 built) beside phases 35 and
10, and their lines follow phase 10's; the host graphs of later phases (the hub
graphs, the weighted twin, the typed slice graph) are built on a worker
thread while the phases before them run:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the kernels from `embiggen_tpu_torch/csrc/` with nvcc;
  3. K1-K4 against their plain PyTorch versions on the card, at the shapes
     the S1 slice gives them, with both times (K1 and K2, like K5 and K6 in
     phase 4, which take under 0.1 ms, also with the kernel's device time
     on CUDA events around each launch queued behind a sleep, as their
     wrappers' host work takes longer than the kernel): K3 and K4's SkipGram combine at the flagship shapes, the
     harness's SkipGram shapes and a D that is
     not a multiple of 4, with and without centre weights (K3's sums rtol
     1e-4 / atol 1e-5: sums in another order; its counts exactly; the
     tables after the combine atol 1e-5: atomics add in no fixed order; the
     sums and counts all zero after the combine); K4's standalone mean
     scatter at the flagship shapes (atol 1e-5);
     K1, K2 and the fused first-order batch (the S1 step's starts, walks
     and negatives in one launch), which are samplers, by arc
     validity and chi-square tests (fail at p < 1e-3): on small weighted
     and unweighted graphs against the exact distributions, and on the
     slice graph at the slice shapes against both the exact distributions
     and their plain versions, with draws binned by node degree and by
     blocks of node ids; K2 also over the slice graph's 20M arc ids (bins
     and the count of repeated arcs); the fused batch's starts tiled over
     3 iterations, and its streams independent (a walker's start, first
     step and negatives by chi-square on their joint bins,
     `tests/walk_batch_laws.py`). Every sampler test uses fixed seeds. K1's
     and the fused batch's chain floors (256 walkers alone), and K2 and the
     fused batch on a fit's workspace (one key, an offset a launch);
  4. K5-K7, P1 and P2 against their plain versions at the shapes of the
     link-prediction slice and the probe: K5 exactly on 2^20 queries over
     the 20M-arc graph, half of them arcs, and over it plus 256 hubs of
     4,096-65,536 random neighbours (the other half pairs of a scale-free
     source and a uniform node); K6 (2^20 slots) on a fit's workspace, as
     the GCN draws it, on both graphs: its first batch equal to the batch
     drawn without one at the same key and offset, its exact label
     layout, positives uniform over arc ids, negative endpoints
     degree-proportional (against the exact distribution and the plain
     version), no more arcs or self-loops among negatives than two redraws
     leave; K7 forward for the three combiners and its backward through
     autograd, on the slice graph at D 128 and on a 20,000-node weighted
     graph at D 30 (rtol 1e-5 / atol 1e-5: sums in another order), and on
     the hub graph at D 128 (its hub rows cut into chunks and combined by a
     second launch) against the plain version in float64 at the same
     tolerance, two calls bit-equal, the launches of a forward and backward
     counted, each direction timed beside its gather floor; P1 and P2
     (rtol 1e-5 / atol 1e-3: sums of 256 and 8192 rows in another order);
     K8 on 2^20 pairs (half arcs, half uniform pairs) of the slice graph
     and of the slice graph plus 256 hubs of 4,096-65,536 random
     neighbours (with hub-hub pairs, truncated at cap 128), at the lanes a
     pair its wrapper picks (other rows held in registers, and the hubs'
     as samples bracketing a search): the common neighbour counts and
     preferential attachment exactly, Jaccard rtol 1e-6, Adamic-Adar and
     resource allocation rtol 1e-5 / atol 1e-6 (sums in another order);
  5. S1: three SkipGram steps on injected batches, kernel path against the
     plain path on the CPU; then `embed_graph` of Node2Vec SkipGram on
     erdos_renyi(1M nodes, 10M edges) at D=128, L=64, w=5, K=10, batch
     32768, 2 epochs, with the fused batch launched once a step, K3 and
     K4's combine, and not K1, K2 or K4's standalone scatter;
  6. S3: three GCN Adam steps on injected batches, card against CPU from
     the same parameters; then the bench configuration: GCNEdgePrediction
     (units 128-128, Symmetric Normalized Laplacian, batch 2^20) for 2
     epochs on the same graph with seeded [1M, 128] features, and
     predict_proba on its 20M arcs, with K6 and K7 launched;
  7. S2: the harness configuration: PerceptronEdgePrediction (Degree +
     CosineSimilarity, 3 of its 15 epochs) on phase 5's embeddings, fitted and
     scoring the 20M arcs, with K5 launched (the negative graph's
     membership test); then the same with the reference's own feature set
     (Degree, AdamicAdar, JaccardCoefficient), with K8 launched;
  8. the probe entry point (`embiggen_tpu_torch.scripts.spmm_probe.run`),
     with P1 and P2 launched, beside K7's gathered rows/s;
  9. quality on the card: the reference's link-prediction gate verbatim
     (SkipGram features, a Perceptron on Jaccard + Adamic-Adar + Hadamard)
     through `edge_prediction_evaluation` on its random geometric fixture,
     with K8 launched: test AUPRC and AUROC at least 0.90, and AUPRC within
     0.03 of the reference's for the same call; and on the same connected
     holdout the GCN fitted with model seeds 0-7 and scored by `_evaluate`:
     mean test AUPRC at least the reference's less 0.03, and 0.80;
 35. (before phase 10) the native host helpers (`embiggen_tpu_torch.native`,
     C++ built with g++) against their plain numpy versions on the card's
     host at the harness's shapes, each with both host times: the panel's
     radix argsort and sweep on 19M float32 scores, `sort_unique_pairs` on
     10M pairs drawn as the negative graph draws them, `build_sym_csr` and
     `sort_pairs` on the slice graph's shuffled edges and arcs, the alias
     tables of the weighted twin (the plain version on its first 100,000
     rows), the forest on a 100,000-node graph and the parser on a
     1M-line file (indices exactly, the tables bitwise, the sweep within
     1e-12 relative);
 10. S4: the flagship harness (`embiggen_tpu_torch.scripts.harness.run`):
     `edge_prediction_evaluation` of a Perceptron and a Kipf GCN over
     SkipGram features on a 1M-node planted-partition graph, with K1-K7
     launched and its host phases on the native helpers (the forest, the
     CSR builds, the negative dedup, the panel's sort and sweep, each
     called, with its calls and host seconds); every phase second, peak
     device memory, test AUPRC at least 0.85 (printed beside the
     reference's 0.8712) and the sha1 of the train and test CSR arrays of
     the holdout that the harness split (`harness.recorded_split`), to
     compare the split with another build's;
 11. K9-K11 against their plain versions on the card: K9 (the ELL p/q walk)
     and K10 (the rejection walk) on small weighted and unweighted graphs,
     every move of whole walks against its exact step law
     (`tests/pq_laws.py`; K9 over whole rows, over rows subsampled at
     cap 8, and at cap 34 on rows that span two 32-slot chunks, on rows of
     exactly 32 and 33 slots, and after hubs whose over-cap rows are
     unsorted; K10 at 8 and 16 tries), and on the slice graph at the slice
     shapes (K9 also on
     the slice graph plus 256 hubs, whose rows exceed the cap of 100)
     against their plain versions: the first p/q step and the last binned
     by node degree and by blocks of node ids, the returns at each
     position, and the row slots picked; K9's chain floor (the time of 256
     walkers' walks, too few to contend for the card); K11 (the CBOW
     update) at the S5 flagship shapes and a D that is not a multiple of 4,
     with and without centre weights (sums rtol 1e-4 / atol 1e-5, counts
     exactly, the tables after K4's combine atol 1e-5), and at its edges
     (fewer walks than its persistent grid and more, not a multiple of it;
     walks of one repeated node; window 1, one centre, one negative);
 12. S5: three CBOW steps on injected batches, card against CPU; then
     `embed_graph` of Node2Vec CBOW (return 2, explore 0.5, cap 100) on the
     slice graph at the S1 widths, 2 epochs, with K2, K9, K11 and K4's
     combine launched and K1, the fused batch, K10 and K3 not; one epoch
     each of p/q SkipGram (K2, K9 and K3) and DeepWalk CBOW (the fused batch
     and K11; not K1 or K2); `random_walks` on
     the graph exported without an ELL table, with K10 launched;
 13. S5 quality: Node2Vec CBOW p/q features (the gate's SkipGram settings)
     on the gate fixture's connected holdout, embedding seeds 0-3, fed to a
     Perceptron on Hadamard alone: mean test AUPRC at least the
     reference's less 0.03;
 14. K14 (the siamese and LINE batch samplers) against its exact laws
     (`tests/batch_laws.py`, chi-square, fail at p < 1e-3, fixed seeds) and
     its plain versions on the slice graph with 2^20 slots: positives
     uniform over bins of arc ids, each an arc, the siamese types the arcs';
     the corrupted nodes and LINE's negatives with avoid_false_negatives
     (one unchecked redraw) by node degree and by blocks of node ids, the
     siamese coin, LINE also on the slice graph plus 256 hubs, and every
     LINE first draw that is not an arc kept as drawn; then K4 standalone
     (scatter and combine) at the S6 shapes against mean_scatter_plain
     (atol 1e-5: atomics add in no fixed order; counts exactly), with
     segment tuples and shared counts (left as passed), and on a workspace
     over three calls (zero after each);
 15. S6: three steps of each of the six minibatch models on injected
     batches, card against CPU (atol 1e-5); then `embed_graph` on the slice
     graph at batch 65536: Second-order LINE (D 128, 2 epochs), TransE (D
     128, 2 epochs, edge types arange(E) % 8 as bench.py types them),
     First-order LINE with avoid_false_negatives and Unstructured (D 128, 1
     epoch each), TransH and Structured Embedding (D 32, 1 epoch each), with
     K14 launched, K4 standalone launched by LINE only, and K1, K3, K9 and
     K11 not;
 16. S6 quality: First-order LINE and Unstructured on the gate fixture,
     their edge AUROC at least the reference's less 0.03;
 17. K12 (the Walklets update) against its plain version in both modes at
     the S7 shapes (walks [32768, 64], K 10, tables [4, 1M, 32]) and at its
     edges (D 12 at P 4, a sub that is not a multiple of 4; P 1; P 3 at sub
     40, over one 32-column chunk; walks of P + 1 nodes, one pair at the
     top power; the default embedding's sub 25 at L 64; walks of one
     repeated node); the S7 shape's 131,072 (walk, power) items are no
     multiple of the persistent grid: its counts exactly, its loss and sums
     rtol 1e-4 / atol 1e-5, the tables after K4's combine atol 1e-5;
 18. K13a (the co-occurrence build) against its plain version at the S7
     GloVe shape (a walk of 16 from each of the slice graph's nodes, w 2),
     on a small weighted graph, on walks that revisit nodes (the diagonal
     dropped), on a star's walks (a hub segment over several windows), on
     the walks of the slice graph with 256 planted hubs (timed too, beside
     torch.unique's inverse with index_add_) and with strides at or past
     the walks' length (no keys): keys exactly, in
     ascending order, sums rtol 1e-6; its time and its launches' split
     beside torch.unique's on the emitted keys (counts, the same function
     as the weight-1 build, also timed) and torch.unique's inverse with
     index_add_ of the weights (the same function as GloVe's 1/d sums);
     K13b (the GloVe step) against its plain version on that build's
     entries at B 65536, D 128 and at D 30: gradient rows rtol 1e-5 / atol
     1e-6, loss rtol 1e-5;
 19. S7: three injected steps of Walklets SkipGram, Walklets CBOW and
     Node2Vec GloVe, card against CPU (atol 1e-5); then `embed_graph` on
     the slice graph: Walklets SkipGram (D 128, power 4, batch 32768, L 64,
     K 10; 2 epochs) and Walklets CBOW (1 epoch) with the fused batch (once
     a step), K12 and K4's combine launched and K1, K2, K3, K11, K9 and K10
     not, in pairs/s; Node2Vec
     GloVe (D 128, batch 65536, L 16, w 2, iterations 1; 1 epoch), with the
     co-occurrence build timed apart, and Walklets GloVe (power 4, L 16),
     with K1, K13a, K2 (once a step, at the fit's key) and K13b launched;
     Role2Vec (D 128, 1 epoch) with K2
     and K1; peak device memory of each;
 20. S7 quality: the reference's Walklets gate verbatim through
     `edge_prediction_evaluation` (test AUROC at least 0.85 and the
     reference's less 0.03), and Node2Vec GloVe features on the gate
     fixture's connected holdout, embedding seeds 0-3, a Perceptron on
     Hadamard alone (mean test AUROC at least the reference's less 0.03);
 21. K15a (the min-plus relaxation) against its plain version exactly: the
     early-stopped `multi_source_distances` against 32 plain relaxations at
     D 100 from the 100 top-degree nodes on the slice graph and on its
     weighted twin, launched the first unchanged relaxation + 1 times, with
     each relaxation's change flag held to whether its output moved; 8 at D
     1 and D 30, 32 at D 30 on a graph of two components and isolated nodes
     and on a directed graph (each also weighted), with the change flags;
     K15a timed with the flag the fit passes; WINE's two K7 hops at unit values
     exactly (K15b); K16a's singletons exactly at precisions 4, 8 and 12,
     and HyperSketching's three hops exactly at each, by the singleton
     route (hops 1 and 2 from the node ids, hop 2 by the route
     `hop2_route` picks and forced onto each route; hop 3 by the hop
     launch) and by the general
     route (the hop launch over the singletons), against the plain hops
     over the plain singletons, on the slice graph and on the slice graph
     plus 256 hubs (hop 2 not forced onto the id route); the general
     route's launches counted alone; on the hub graph also the general
     route's three hops exactly at each precision, the hub rows cut into
     chunks (the hop launch and its merge once a hop, counted), one hop
     timed beside its gather floor, the merge against its plain version;
     K16b at 2^20 pairs (half
     arcs, half uniform pairs) for H 1-3 at each precision, and its
     general route at H 6 (two copies of the three hops of the first
     131,072 nodes), within
     `tests/hll_checks.py`'s tolerance, each case timed; each with its time,
     bound and library call (`torch.sparse.mm` for WINE's hop);
 22. S8 through `embed_graph` on the slice graph: Degree-based and
     Score-based SPINE (D 100, depth 32; seeded scores), WeightedSPINE on
     the weighted twin, Degree-based WINE (D 100, window 2), RUBICONE and
     RUINE (D 100, 2 convolutions), HyperSketching (hops 3, precision 8,
     bits 6) over all 20M arcs, with K15a, K7 or K16 launched (K16a's
     singleton route, never the singletons launch; its sketches equal the
     general route's byte for byte and its K16b features of 2^20 pairs
     bit for bit), and HyperSketching at precision 12, whose hop 2 takes
     the id route; then the
     bench GCN of phase 6 with lazy HyperSketching features for 2 epochs
     (K6, K7, K16a, K16b) and with HyperSketching's edge embeddings as a
     static feature matrix for 1 (K5), each scoring the 20M arcs; seconds,
     peak memory, and Degree-based SPINE's and WeightedSPINE's K15a
     launches, which must be the relaxations that moved in phase 21 + 1;
     K16b's share of 10 steady steps of the GCN with HyperSketching
     features, on CUDA events;
 23. S8 quality: the reference's edge-GCN gate with Degree-based SPINE
     features (seed 0 through `edge_prediction_evaluation`, seeds 1-7 by
     `_evaluate`): mean test AUPRC at least the reference's less 0.03, and
     0.80; the reference's HyperSketching GCN test on the gate fixture:
     AUROC above 0.6;
 24. with `--profile` only: K3's phase split (gather, scores, gradients)
     at the flagship shapes, K11's (gather, hidden rows, logits and
     softmax, output and negative gradients, input gradients) and K9's (row
     load, membership and weights, pick) at the S5 shapes, from clock64()
     stamps in a build with EBT_PHASE_CLOCK; then steady steps of S1, of
     the GCN, of S5 and of S6
     (Second-order LINE, TransE), of S7 (Walklets SkipGram, Node2Vec
     GloVe) and of S8 (the GCN with HyperSketching features), one line per
     kernel name with its device
     ms per step: the port's kernels on CUDA events around each launch,
     PyTorch's own from torch.profiler; then ten NodeSketch fits (S9's
     defaults on the slice graph, 10 rounds each) the same way;
 25. K18 (NodeSketch's min-hash race) against its plain version exactly:
     one round and 10 rounds on the slice graph at D 100, decay 0.01 (Exp(1)
     races and noise), 3 rounds at D 1 and D 30, 10 at D 30 on phase 21's
     graph of two components with isolated nodes and on its directed graph,
     3 rounds at D 100 on the slice graph with 256 planted hubs of
     4,096-65,536 arcs, and exact ties (races and noise on small grids,
     decay 0.5); its candidate pass exactly against `torch.addcmul` at D
     100, 30 and 1, timed beside it; the round's two launches timed on
     CUDA events; RandNE's
     two K7 hops (row scale 1 / max(deg, 1)) at D 100 against
     csr_spmm_plain (rtol 1e-5 / atol 1e-7), with `torch.sparse.mm`'s time;
 26. S9 through `embed_graph`: NodeSketch (D 100, 10 rounds, decay 0.01;
     K18's two launches 10 times each) and RandNE (D 100, alphas (0.5,
     0.5); K7 twice)
     on the slice graph; NetMF (D 100, order 2), GraRep (D 100, order 5),
     BoostNE (embedding_size 102), MNMF (D 128, 200 iterations), NMFADMM (D
     100, 100 iterations) and NNSED (D 32) on erdos_renyi(32,768 nodes,
     327,680 edges), the largest graph the dense rows accept, launching none
     of the port's kernels; seconds and peak device memory of each; then
     each dense row on the card against the CPU from the same state for
     random states 0-2 on a 2,000-node graph (MNMF at 60 iterations), with
     the tolerances of tests/test_torch_factorization.py; K18's share of
     3 NodeSketch fits on CUDA events;
 27. S9 quality: RandNE and NetMF features on the gate fixture's connected
     holdout, embedding seeds 0-3, a Perceptron on Hadamard alone: each mean
     test AUROC at least the reference's less 0.03;
 28. K19 (the exact p/q and typed walk) and typed K9 against their exact
     typed laws (`tests/pq_laws.py`, chi-square, fail at p < 1e-3, fixed
     seeds) on small typed graphs, weighted and not: the reference's (node,
     edge) weights (4, 1), (1, 0.2), (3, 0.5) with neutral p/q and with
     2 / 0.5, K9 over whole and subsampled (cap 8) rows, K19 over whole rows
     and windows of 34 rotated on longer rows, untyped K19 (exact_pq, a
     weight ratio of 20), every first step, and the edge type carried on a
     multigraph; then on the typed slice graph (the slice graph with 8 edge
     and 8 node types) at B 32768, L 64, cap 100, and K19 also with 256
     planted hubs typed at random, against their plain versions (the first
     steps and the last by degree and by blocks of node ids, the returns
     and the type changes at each position); each timed with its bound,
     untyped K9 timed in turns with typed K9 on one ELL table;
 29. S10 through the entry points on the typed slice graph: typed Node2Vec
     SkipGram (node 2, edge 0.5) at the S1 widths, 2 epochs, with K2, typed
     K9, K3 and K4's combine launched and K1 not; typed p/q Node2Vec CBOW
     (return 2, explore 0.5), 1 epoch, with typed K9 and K11; `random_walks`
     without an ELL table, typed, with exact_pq and at a weight ratio of 20,
     each launching K19 and not K9 or K10; the bench GCN of phase 6 with the
     node-type and edge-type embeddings, 2 epochs, scoring the 20M arcs,
     with K6, K7 and K5 launched; seconds and peak memory of each;
 30. S10 quality: the reference's `test_typed_walks_end_to_end` on the card
     through both routes: the type change rate at node weight 5 exceeds the
     rate at 0.1 by more than 0.1;
 31. K17 against the plain versions on the slice graph's Symmetric
     Normalized Laplacian cut in 4 shards at D 128: K17a forward and
     backward on each shard, its halo buffer filled by indexing (the
     exchange in one process), the stacked shards against K7 on the whole
     graph; K17b on each edge shard, the partials summed against K7; K17c
     (its count launch and its scatter by entry counts and by row counts)
     and K17d at S1's batch (32768 walks of 64, 10 negatives each) on the
     S1 tables in 4 row shards (K17d and the counts exactly; rtol / atol
     1e-5 for sums in another order); with comm_rows and H;
 32. S11 on a one-rank NCCL group (a file store, NCCL_SOCKET_IFNAME=lo),
     each path held to its reference on the same batch (rtol 1e-4 / atol
     1e-5), then 3 steps timed, the counts set to 0 after the reference
     and read after the path's own steps, and each path's kernels required
     (and the single-device routes it replaces refused): the dim-sharded,
     row-sharded and data-parallel functional SkipGram steps at S1's widths
     on 4096 walks against the autograd step; the edge-sharded SpMM, the
     GCN encoder over the mesh (`enable_halo`, with dropout) and the halo
     SpMM (forward and backward) at S3's against K7; the sharded GCN edge
     step (units 128, batch 2^20) against K7's autograd; and, built with the
     one-rank mesh against `_step`, the `_make_dp_step` and
     `_make_row_sharded_step` of Node2Vec SkipGram and CBOW, LINE, TransE
     and GloVe, and the `_make_dp_step` of Walklets SkipGram and Role2Vec,
     and Walklets GloVe's `glove_dp_step` against its `_glove_step`;
 33. K20 against its plain versions: `sddmm` (K20a) over the slice graph's
     20M arcs on [1M, 128] tables (rtol / atol 1e-5: sums over D in another
     order), also at an odd storage offset, at D 127 (the scalar route),
     with int64 ids, and its backward (two index_add_ passes) on 2^20 arcs
     against autograd of the plain gathers; `edge_chunk` and `chunk_mask`
     (K20b) exactly at 2^15 and 2^20 slots (chunk 0, a middle one, the last,
     clamped, and one past the end), with the exported sources and with the
     row_ptr search; each timed with its bound, sddmm beside
     `torch.sparse.sampled_addmm`; then every arc scored in chunks of 2^20
     through the three entry points, each launched, the scores equal to the
     whole sddmm's;
 34. S12: the 21 KGE rows through `embed_graph` on the typed slice graph at
     D 128, batch 65536, one epoch cut to S12_STEPS (20) steps,
     NodePiece at 256 anchors and 8 tokens (K15a), ConvE at 8 filters, each
     launching K14 once a step and no walk or K4 kernel: seconds, peak
     memory (the fit's own, and the total), and 5 steady steps' ms on CUDA
     events and busy share; NodePiece's K15a distances at its 256 columns
     and its tokens against the plain ones, exactly; one
     injected step of each at D 128 card against CPU (rtol 1e-4 / atol
     1e-5); tests/test_kge.py's ranking check on the card for every row;
 36. S14 node label on the typed slice graph: `node_label_prediction_evaluation`
     of the Kipf GCN at the reference's defaults (units 128-128, head 128,
     dropout 0.5, 200 epochs, patience 20; a learned node embedding, as the
     graph has no features), one Stratified Monte Carlo holdout, with K7
     launched 4 times an epoch and twice to predict: seconds an epoch, a
     steady step on CUDA events, peak memory and the multiclass panel; then
     GraphConvolution's two hops at D 128 in both transposes against the
     plain hops on the card (rtol / atol 1e-5), 2 K7 launches each, the
     transposed kernel's hop timed beside its plain version and
     `torch.sparse.mm`; then Node-label-based SPINE (8 anchor sets), its
     K15a distances exactly the plain version's;
 37. S14 edge label: `edge_label_prediction_evaluation` of the Kipf GCN at
     its default widths on the typed slice graph's 8 edge types, cut to 2
     epochs (of 16 steps of 2^20 arcs), plain and with `use_edge_metrics`:
     K7 4 times a step and twice to predict, K8 once a step and once a
     prediction chunk with the metrics and never without, never K6 or K5;
     step ms, seconds, peak memory and the panel;
 38. (in the quality process) S14 quality: the reference's node-label gate
     (`tests/test_quality_gates.py:70`) with model seeds 0-7: each test
     accuracy at least 0.85, the mean at least the reference's less 0.03.
 39. S15 edge prediction: K8 at the sklearn adapters' cap, the largest
     degree (no row truncated), on 2^20 pairs of the slice graph and of the
     slice graph plus 256 hubs (256 hub pairs, rows up to 65,536), against
     its plain version at that cap (in chunks) and the host copy of
     `graph/metrics.py` (the first 2^16 pairs and the hub pairs; K8_SUM_TOL);
     then `edge_prediction_evaluation` on planted_partition_edges(100,000,
     1,000,000, 1,000 communities), one connected holdout, Node2Vec
     SkipGram features at the S1 widths (30 epochs, decay 0.99), of two
     SklearnEdgePredictionAdapters whose estimators are
     defined here in numpy: a least-squares classifier (decision_function
     only) on Hadamard with `use_edge_metrics` and a centroid classifier
     (predict_proba) on Concatenate, with the S1 step's kernels, K5 and K8
     (once for the fit, once a prediction chunk) launched, the first's test
     AUROC at least 0.8; on 2^15 pairs
     the card's features against the CPU route's (1e-6) and K8's metric
     columns against the host copy (rtol 1e-6), and the least-squares test
     scores against the same estimator fit on the CPU route's features
     (1e-4);
 40. S15 label tasks: `node_label_prediction_evaluation` of a centroid
     classifier on the typed slice graph's node types (seeded features,
     no kernel), `edge_label_prediction_evaluation` of the least-squares
     classifier with `use_edge_metrics` on erdos_renyi(200,000, 1,000,000,
     8 edge types) (K8 once for the fit and once to predict), and a named
     row ("Decision Tree Classifier") of each task, which must raise
     ModuleNotFoundError naming scikit-learn where sklearn is missing;
 41. S16 the reference-named Graph surface on the typed slice graph, each
     method with the counts set to 0 just before it and read just after,
     each equal to its op launched directly under a generator seeded alike:
     `node2vec` (32768 walkers, L 64, w 5) at p = q = 1 (K1) and at return
     2, explore 0.5 (K10: `Graph._device_graph` exports no ELL table), its
     walks rebuilt from the pairs and every step an arc;
     `get_edge_prediction_mini_batch` at 2^20 slots (K6), its positives arcs
     and its labels ones then zeros; `get_siamese_mini_batch` with and
     without edge types at 65536 (K14); `get_all_edge_metrics_from_node_ids`
     on 2^20 pairs (K8 at the largest degree) against the host copy on the
     first 2^16 (K8_SUM_TOL, and at most 6.1e-4); then every zero-argument
     method on the 120-node typed fixture, the five that run on a device
     (K8) against their CPU route;
 42. S16 the spectral rows on the card's host (scipy ARPACK in float64, no
     kernel): HOPE, Laplacian Eigenmaps, GLEE and SocioDim at embedding_size
     100 on erdos_renyi(10,000, 50,000), each timed, finite, its columns
     orthogonal (orthonormal unscaled) within 1e-4; HOPE at "Resnik" on a
     2,000-node DAG; then HOPE's features through `edge_prediction_evaluation`
     with a Perceptron on Hadamard on the gate fixture, K5 launched, its
     test AUROC at least the reference's less 0.03;
 43. S17 (A12, A16) on the slice graph: Node2Vec SkipGram at S1's widths (3
     epochs), the bench GCN (3 epochs, dropout 0.5) and Second-order LINE at
     S6's settings (2 epochs), each checkpointed every epoch into a
     temporary directory: two uninterrupted fits, then a fit killed after
     its second save (LINE: its first) by wrapping `save_pytree`, whose
     checkpoint reloads byte for byte what the save wrote (tables, Adam's
     moments, generator states, the draws' key and offset), then the
     resumed fit, with the counts set to 0 just before it and read just
     after (`a12_launches`): its first batch equals exactly the batch the
     uninterrupted fits drew at that step, its final tables are within
     max(4 x the two uninterrupted fits' difference, 1e-5) of the nearer of
     them (float atomics make two card fits differ), and it leaves no
     checkpoint; each save's seconds and bytes; `dump_model` of the resumed
     GCN and `EmbeddingResult.dump` of the resumed S1 embedding, both loaded
     on the CPU, the GCN's predictions on 2^16 pairs through the CPU route
     within 1e-5 of the card's; `embed_graph` and `edge_prediction_evaluation`
     with `enable_cache` twice each, the second launching no kernel and
     returning equal results; the visualizer imported, its fit raising the
     ImportError of the package missing on this host.
Then the seconds phases 36-37, 39-40, 41-42 and 43 added, a JSON line of the kernels (with the build seconds; each with its
bound, from this run's inputs at the published HBM and fp32 peaks, and the
time of one PyTorch call computing the same function where there is one,
named by `library`; its launches on the main path, the harness's, the
label tasks', the sklearn-like adapters' and the Graph methods' path,
`compat_launches`, and phase 43's resumed fits', `a12_launches`),
the card's line again, and last `{"ok": true, "device": {...}}`.
"""
import argparse
import concurrent.futures
import dataclasses
import inspect
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N_NODES, N_EDGES = 1_000_000, 10_000_000
DIM, WALK, WINDOW, NEGS, BATCH = 128, 64, 5, 10, 32768
P_MIN = 1e-3
# The harness configuration's Perceptron trains 15 epochs (`bench.py:456-461`);
# phase 7 times 3 of them, the fit's stages and its launches whole.
S2_EPOCHS = 3
ID_BLOCK = 1000   # node ids per bin in the slice-shape sampler tests
ARC_BINS = 1000   # bins of arc ids in the slice-shape K2 and K6 tests
PROFILE_STEPS = 10
GCN_BATCH = 1 << 20
K7_TOL = dict(rtol=1e-5, atol=1e-5)
PROBE_TOL = dict(rtol=1e-5, atol=1e-3)
K8_PAIRS = 1 << 20
N_HUBS = 256
K8_SUM_TOL = dict(rtol=1e-5, atol=1e-6)
# The reference's gate fixture and settings (tests/test_quality_gates.py),
# the reference's test AUPRC of its Perceptron gate call, and its GCN's mean
# test AUPRC over the model seeds GATE_SEEDS, measured with embiggen_tpu
# (tests/test_torch_link_prediction.py says how).
GATE_SKIPGRAM = dict(embedding_size=32, epochs=100, batch_size=256,
                     walk_length=16, window_size=2, number_of_negative_samples=5,
                     learning_rate_decay=0.99, random_state=0,
                     early_stopping_patience=10**6,
                     learning_rate_plateau_patience=10**6)
GATE_PERCEPTRON = dict(edge_embeddings=["Hadamard"],
                       edge_features=["JaccardCoefficient", "AdamicAdar"],
                       number_of_epochs=100, random_state=0)
GATE_REFERENCE_PERCEPTRON_AUPRC = 0.9913790290856157
GATE_GCN = dict(units=[32], tower_units=[16], head_units=[16], epochs=50,
                use_node_embedding=True, node_embedding_size=32,
                dropout_rate=0.2, batch_size=1024, random_state=0)
GATE_REFERENCE_GCN_AUPRC = 0.9511797508504303
GATE_SEEDS = range(8)
# The flagship harness's test AUPRC of the reference (BENCH_r05_local.json)
# and the port's floor.
HARNESS_REFERENCE_AUPRC = 0.8712
HARNESS_FLOOR = 0.85
# S5: p/q walks (p = 0.5, q = 2: return 2, explore 0.5; BASELINE.md
# configuration 2) over the ELL table at the default cap of 100.
PQ = dict(return_weight=2.0, explore_weight=0.5)
ELL_CAP = 100
# K11 at the S5 flagship shapes and at a D that is not a multiple of 4.
K11_SHAPES = (("flagship", N_NODES, DIM, WALK, WINDOW, NEGS, BATCH),
              ("D 30", 100_000, 30, 12, 3, 5, 4096))
# The CBOW p/q gate: the SkipGram gate's settings with return 2, explore 0.5,
# embedding seeds GATE_CBOW_SEEDS, a Perceptron on Hadamard alone; the
# reference's mean test AUPRC, measured with embiggen_tpu on the CPU by
# tests/test_torch_link_prediction.py::test_cbow_pq_reference_mean.
GATE_CBOW = dict({k: v for k, v in GATE_SKIPGRAM.items() if k != "random_state"}, **PQ)
GATE_CBOW_PERCEPTRON = dict(edge_embeddings=["Hadamard"], edge_features=None,
                            number_of_epochs=100, random_state=0)
GATE_REFERENCE_CBOW_AUPRC = 0.9883034355107209
GATE_CBOW_SEEDS = range(4)
# K3 and K4 at the S1 flagship shapes, at the harness's SkipGram shapes (D
# 64, L 16, w 2, K 5; its batch on a 1M-node graph) and at a D that is not
# a multiple of 4: (name, N, D, L, w, K, B).
SKIPGRAM_SHAPES = (("flagship", N_NODES, DIM, WALK, WINDOW, NEGS, BATCH),
                   ("harness", N_NODES, 64, 16, 2, 5, BATCH),
                   ("D 30", 100_000, 30, 12, 3, 5, 4096))
# S6: the minibatch SGD families at bench.py's shapes (`bench.py:261,271-298`:
# batch 65536, D 128, TransE over 8 synthetic edge types arange(E) % 8;
# LINE's default K 5); TransH and Structured Embedding at D 32, whose [B, D,
# D] projections would take 4.3 GB each at D 128. (model, typed, D, epochs,
# options).
S6_BATCH, S6_NEGS, S6_TYPES = 65536, 5, 8
K14_SLOTS = 1 << 20
S6_RUNS = (("Second-order LINE", False, DIM, 2, {}), ("TransE", True, DIM, 2, {}),
           ("First-order LINE", False, DIM, 1, dict(avoid_false_negatives=True)),
           ("Unstructured", False, DIM, 1, {}), ("TransH", True, 32, 1, {}),
           ("Structured Embedding", True, 32, 1, {}))
# The S6 AUROC gate and the reference's AUROCs for the same calls, measured
# with embiggen_tpu on the CPU (tests/test_torch_line_siamese.py says how).
GATE_S6 = dict(embedding_size=32, epochs=30, batch_size=1024, learning_rate_decay=0.99,
               early_stopping_patience=10**6, learning_rate_plateau_patience=10**6,
               random_state=0)
GATE_LINE1 = dict(GATE_S6, learning_rate=0.025)
GATE_UNSTRUCTURED = dict(GATE_S6, learning_rate=1.0)
GATE_REFERENCE_LINE1_AUROC = 0.8843448788028528
GATE_REFERENCE_UNSTRUCTURED_AUROC = 0.9216162440005579
# S7: Walklets at bench.py's shapes (`bench.py:305-311`: D 128, power 4,
# batch 32768, L 64, K 10) and GloVe's (`bench.py:320-329`: D 128, batch
# 65536, L 16, w 2, iterations 1); K12 at those shapes and at its edges (a
# sub not a multiple of 4, P 1, a sub over one 32-column chunk, walks of
# P + 1 nodes, the default embedding size 100's sub 25): (name, N, P, sub,
# B, L, K).
WALKLETS_POWER = 4
WALKLETS_SHAPES = (("S7", N_NODES, WALKLETS_POWER, DIM // WALKLETS_POWER, BATCH, WALK, NEGS),
                   ("D 12, P 4", 100_000, 4, 3, 4096, 12, 5),
                   ("P 1", 100_000, 1, 32, 4096, 12, 5),
                   ("P 3, sub 40", 100_000, 3, 40, 4096, 12, 5),
                   ("one pair", 100_000, 4, 8, 4096, 5, 5),
                   ("D 100, P 4", 100_000, 4, 25, 4096, WALK, NEGS))
GLOVE_WALK, GLOVE_WINDOW, GLOVE_BATCH = 16, 2, 65536
S7_WALKLETS = dict(embedding_size=DIM, power=WALKLETS_POWER, batch_size=BATCH, walk_length=WALK,
                   window_size=4, number_of_negative_samples=NEGS,
                   early_stopping_patience=10**6)
S7_GLOVE = dict(embedding_size=DIM, batch_size=GLOVE_BATCH, walk_length=GLOVE_WALK,
                window_size=GLOVE_WINDOW, iterations=1, early_stopping_patience=10**6)
S7_WALKLETS_GLOVE = dict(embedding_size=DIM, power=WALKLETS_POWER, walk_length=GLOVE_WALK,
                         iterations=1, batch_size=GLOVE_BATCH)
S7_ROLE2VEC = dict(embedding_size=DIM, early_stopping_patience=10**6)
# The reference's Walklets gate (`tests/test_quality_gates.py:113-142`), its
# floor and the reference's test AUROC for the same call (embiggen_tpu on the
# CPU); the GloVe gate and the reference's mean test AUROC over its seeds,
# measured with embiggen_tpu on the CPU (tests/test_torch_glove.py says how).
GATE_WALKLETS = dict(embedding_size=32, power=2, epochs=100, batch_size=256, walk_length=16,
                     window_size=2, number_of_negative_samples=5, learning_rate_decay=0.99,
                     random_state=0, early_stopping_patience=10**6,
                     learning_rate_plateau_patience=10**6)
GATE_WALKLETS_FLOOR = 0.85
GATE_REFERENCE_WALKLETS_AUROC = 0.9963
GATE_GLOVE = dict(embedding_size=32, epochs=30, batch_size=64, learning_rate=2.0,
                  learning_rate_decay=0.99, walk_length=16, window_size=2, iterations=4,
                  early_stopping_patience=10**6, learning_rate_plateau_patience=10**6)
GATE_GLOVE_SEEDS = range(4)
GATE_REFERENCE_GLOVE_AUROC = 0.7017104723535372
# S8: SPINE at its defaults (D 100, depth 32), WINE at D 100 and window 2,
# RUBICONE and RUINE at D 100 and 2 convolutions, HyperSketching at its
# defaults (hops 3, precision 8, bits 6); K16b at 2^20 pairs.
S8_DIM, S8_DEPTH, S8_WINDOW = 100, 32, 2
HLL_HOPS, HLL_PRECISION, HLL_BITS = 3, 8, 6
K16B_PAIRS = 1 << 20
# K16b's general route (H > 3) is held at H 6: two copies of the three hops
# of the first K16B_GENERAL_NODES nodes, the pairs' ids taken modulo it.
K16B_GENERAL_NODES = 1 << 17
# The reference's edge-GCN gate with its own node features, Degree-based
# SPINE: the reference's mean test AUPRC over GATE_SEEDS, measured with
# embiggen_tpu on the CPU (tests/test_torch_spine_gate.py says how). The
# reference's HyperSketching GCN test (tests/test_gcn_edge_features.py) and
# its AUROC floor.
GATE_REFERENCE_SPINE_GCN_AUPRC = 0.9654934446163882
GATE_SKETCH_GCN = dict(units=[8], tower_units=[8], head_units=[8], epochs=60,
                       learning_rate=0.05, batch_size=64, use_node_embedding=True,
                       node_embedding_size=8, dropout_rate=0.1, random_state=0)
GATE_SKETCH = dict(number_of_hops=2, precision=6, random_state=0)
GATE_SKETCH_FLOOR = 0.6
# S9 at the reference's defaults: NodeSketch (D 100, 10 rounds, decay 0.01)
# and RandNE (D 100, alphas (0.5, 0.5)) on the slice graph; the dense rows
# on the largest graph they accept, at their default widths (BoostNE at 102,
# the nearest size its defaults accept: 17 blocks of 6), and card against
# CPU on a 2,000-node graph (MNMF there at 60 iterations, the tests'
# moderate count, as its 200 take tens of seconds on the host).
S9_DIM, S9_ROUNDS, S9_DECAY = 100, 10, 0.01
S9_ALPHAS = (0.5, 0.5)
S9_DENSE_NODES, S9_DENSE_EDGES = 32_768, 327_680
S9_DENSE_ROWS = (("NetMF", {}), ("GraRep", {}), ("BoostNE", dict(embedding_size=102)),
                 ("MNMF", {}), ("NMFADMM", {}), ("NNSED", {}))
S9_CHECK_NODES, S9_CHECK_EDGES, S9_CHECK_RUNS = 2_000, 20_000, 3
S9_CHECK_KW = {"MNMF": dict(iterations=60)}
# The tests' tolerances (tests/test_torch_factorization.py): the iterative
# rows within 5e-5 of the embedding's scale; NetMF's and GraRep's Gram
# matrices, per SVD block up to its last cut between singular values 1%
# apart, within 1e-4, and their column norms rtol 1e-4.
S9_ITERATIVE_RTOL, S9_GRAM_RTOL = 5e-5, 1e-4
S9_HOP_TOL = dict(rtol=1e-5, atol=1e-7)    # K7's sums in another order
# S10: typed walks on the typed slice graph, erdos_renyi(1M, 10M, seed=0) with
# 8 edge types and 8 node types (the same CSR as the slice graph); the typed
# models' weights (node 2, edge 0.5); the reference's (node, edge) weights of
# tests/test_walks.py's typed-walk tests, each with neutral p/q and 2 / 0.5;
# K19's rotated windows at the reference's test cap of 34.
S10_TYPES = 8
S10_TYPED = dict(change_node_type_weight=2.0, change_edge_type_weight=0.5)
S10_FACTORS = ((4.0, 1.0), (1.0, 0.2), (3.0, 0.5))
S10_PQ = ((1.0, 1.0), (2.0, 0.5))
S10_ROTATED_CAP = 34
# The S9 gate: RandNE and NetMF features (seeds 0-3, defaults) and a
# Perceptron on Hadamard alone on the gate fixture; the reference's mean
# test AUROC, measured with embiggen_tpu on the CPU
# (tests/test_torch_factorization_gate.py says how).
GATE_S9_SEEDS = range(4)
GATE_REFERENCE_S9_AUROC = {"RandNE": 0.9939066727236255, "NetMF": 0.9966186807699228}
K3_SUMS_TOL = dict(rtol=1e-4, atol=1e-5)    # sums in another order
K3_UPDATE_ATOL = 1e-5                        # atomics add in no fixed order
# The card's published peaks (H100 SXM data sheet, dense): HBM bytes/s and
# fp32 flop/s outside the tensor cores; every kernel here is fp32 or integer.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card's clock, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# At least 0.2 s of the card's clock (under 2 GHz): longer than the host
# takes to enqueue the calls `queued_ms` times.
SLEEP_CYCLES = 400_000_000


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call with the calls queued ahead of the
    card: a sleep kernel holds the stream while the host enqueues them, so
    the events time the device's work without the host's gaps (`time_ms`
    times what a caller sees, host and device)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    if enqueue_s >= SLEEP_CYCLES / 2e9:
        raise RuntimeError(f"enqueueing the calls took {enqueue_s} s, longer than the sleep")
    return start.elapsed_time(end) / reps


def time_after(setup, fn, reps: int) -> float:
    """Mean milliseconds of `fn` alone on the card's clock, each call after
    its own `setup` (not timed), after one warm-up."""
    setup()
    fn()
    total = 0.0
    for _ in range(reps):
        setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take for work that must move `n_bytes`
    (each input read once, each output written once) and do `flops`: the
    larger of the two times at the published peaks, and which one it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=n_bytes, bound_flops=flops)


def search_reads(degrees) -> torch.Tensor:
    """Reads of a lower-bound search in rows of these lengths."""
    return torch.ceil(torch.log2(degrees.double() + 1)) + 1


def check_close(name, got, want, rtol, atol) -> float:
    err = float((got.double() - want.double()).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel and plain version differ "
                             f"(max abs err {err}, rtol {rtol}, atol {atol})")
    return err


def chi2_p(observed, expected, rows, n_rows) -> float:
    """Pooled chi-square p-value over the rows whose every cell expects at
    least 5 counts; df = sum over rows of (cells - 1)."""
    from scipy.stats import chi2

    ok = np.ones(n_rows, bool)
    np.logical_and.at(ok, rows, expected >= 5)
    cells = ok[rows]
    if cells.sum() < 50:
        raise AssertionError("too few testable cells for the chi-square test")
    stat = (((observed - expected) ** 2) / expected)[cells].sum()
    return float(chi2.sf(stat, cells.sum() - np.unique(rows[cells]).size))


def pooled(expected, *observed, min_expected=5.0):
    """Merge adjacent bins until each expects at least `min_expected`; a
    short tail joins the last full bin. Returns the merged arrays."""
    group = np.zeros(len(expected), np.int64)
    g, acc = 0, 0.0
    for i, e in enumerate(expected):
        group[i] = g
        acc += e
        if acc >= min_expected:
            g, acc = g + 1, 0.0
    if g < 2:
        raise AssertionError("too few draws for a chi-square test")
    group[group == g] = g - 1
    return [np.bincount(group, weights=x) for x in (expected, *observed)]


def exact_p(observed, expected) -> float:
    """Chi-square p-value of binned counts against their expected counts."""
    from scipy.stats import chi2

    e, o = pooled(expected, observed)
    return float(chi2.sf(((o - e) ** 2 / e).sum(), len(e) - 1))


def two_sample_p(a, b) -> float:
    """Chi-square p-value that two binned samples of equal size come from
    one distribution."""
    from scipy.stats import chi2_contingency

    _, a, b = pooled((a + b) / 2, a, b)
    return float(chi2_contingency(np.stack([a, b]))[1])


def repeats_p(draws: torch.Tensor, support: int) -> float:
    """Two-sided p-value of the number of repeated values among uniform
    draws from `support` values (about Poisson: repeats are rare). Draws
    that reach fewer values than `support` repeat more often."""
    from scipy.stats import poisson

    m = draws.numel()
    repeats = m - torch.unique(draws).numel()
    lam = m + support * np.expm1(m * np.log1p(-1.0 / support))
    return float(min(1.0, 2 * min(poisson.cdf(repeats, lam),
                                  poisson.sf(repeats - 1, lam))))


def arc_positions(graph, walks, keys):
    """Assert every step is an arc or a stay on a zero-degree node; return
    (sources, CSR arc positions) of the moves. Runs on the card."""
    n = graph.number_of_nodes
    src = walks[:, :-1].reshape(-1).long()
    dst = walks[:, 1:].reshape(-1).long()
    deg = torch.from_numpy(graph.degrees).to(walks.device)[src]
    if not bool((dst[deg == 0] == src[deg == 0]).all()):
        raise AssertionError("a walk left a zero-degree node")
    src, dst = src[deg > 0], dst[deg > 0]
    q = src * n + dst
    pos = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
    if not bool((keys[pos] == q).all()):
        raise AssertionError("a walk step is not an arc of the graph")
    return src, pos


def arc_keys(graph, device):
    return (torch.from_numpy(graph.sources.astype(np.int64)) * graph.number_of_nodes
            + torch.from_numpy(graph.col_idx.astype(np.int64))).to(device)


def node_bins(tg, per_node):
    """Per-node counts summed by node degree and by blocks of ID_BLOCK ids."""
    per_node = per_node.double()
    block = torch.arange(tg.n_nodes, device=per_node.device) // ID_BLOCK
    return {"degree": torch.bincount(tg.degrees.long(), weights=per_node).cpu().numpy(),
            "id block": torch.bincount(block, weights=per_node).cpu().numpy()}


def node_counts(tg, nodes):
    return node_bins(tg, torch.bincount(nodes.reshape(-1).long(), minlength=tg.n_nodes))


def binned_tests(p, name, observed, against, exact):
    """Chi-square p-values of each binning of `observed` against the
    expected counts (`exact`) or another sample, into the dict `p`."""
    for by in observed:
        p[f"{name} by {by}"] = (exact_p if exact else two_sample_p)(
            observed[by], against[by])


def sampler_checks(erdos_renyi, first_order_walks, nce_negatives, dev):
    """K1 and K2 on small graphs against the exact distributions. Returns
    (K1 max |empirical - exact| arc probability, K2 max |empirical - exact|
    node probability)."""
    k1_err = 0.0
    for weighted in (False, True):
        g = erdos_renyi(200, 800, seed=7, weighted=weighted)
        tg = g.device(dev, with_alias=weighted)
        starts = (torch.arange(20000, device=dev) % g.number_of_nodes).int()
        walks = first_order_walks(tg, starts, 24, torch.Generator().manual_seed(1))
        if not bool((walks[:, 0] == starts).all()):
            raise AssertionError("walks[:, 0] differs from the starts")
        src, pos = arc_positions(g, walks, arc_keys(g, dev))
        observed = np.bincount(pos.cpu().numpy(), minlength=g.number_of_directed_edges)
        n_from = np.bincount(src.cpu().numpy(), minlength=g.number_of_nodes)
        w = np.ones(len(g.col_idx)) if g.weights is None else g.weights.astype(np.float64)
        row_sum = np.bincount(g.sources, weights=w, minlength=g.number_of_nodes)
        p_arc = w / row_sum[g.sources]
        expected = n_from[g.sources] * p_arc
        p = chi2_p(observed, expected, g.sources, g.number_of_nodes)
        if p < P_MIN:
            raise AssertionError(f"K1 transitions (weighted={weighted}): p={p}")
        k1_err = max(k1_err, float(np.abs(
            observed / np.maximum(n_from[g.sources], 1) - p_arc).max()))
    g = erdos_renyi(200, 800, seed=7)
    tg = g.device(dev)
    draws = nce_negatives(tg, torch.Generator().manual_seed(2), (20000, NEGS))
    observed = np.bincount(draws.cpu().numpy().ravel(), minlength=g.number_of_nodes)
    p_node = g.degrees / g.degrees.sum()
    n = g.number_of_nodes
    p = chi2_p(observed, draws.numel() * p_node, np.zeros(n, int), 1)
    if p < P_MIN:
        raise AssertionError(f"K2 scale-free draws: p={p}")
    k2_err = float(np.abs(observed / draws.numel() - p_node).max())
    uniform = nce_negatives(tg, torch.Generator().manual_seed(3), (200000,), False)
    observed = np.bincount(uniform.cpu().numpy(), minlength=n)
    p = chi2_p(observed, np.full(n, uniform.numel() / n), np.zeros(n, int), 1)
    if p < P_MIN:
        raise AssertionError(f"K2 uniform draws: p={p}")
    return k1_err, k2_err


def slice_sampler_checks(graph, tg, first_order_walks, first_order_walks_plain,
                         nce_negatives, nce_negatives_plain):
    """K1 and K2 on the slice graph at the slice shapes. Draws are binned by
    node degree and by blocks of ID_BLOCK node ids, and each binning is
    tested against the exact distribution and against the plain version's
    draws; K2's draws are also tested over arc ids. Returns the p-values by
    test."""
    dev, n = tg.device, tg.n_nodes
    deg = tg.degrees.long()

    def binned(per_node):
        return node_bins(tg, per_node)

    def counts(nodes):
        return node_counts(tg, nodes)

    p = {}

    def test(name, observed, against, exact):
        binned_tests(p, name, observed, against, exact)

    # K2: every draw is a node with arcs; degree-proportional.
    draws = nce_negatives(tg, torch.Generator().manual_seed(11), (BATCH, NEGS))
    plain = nce_negatives_plain(tg, torch.Generator(device=dev).manual_seed(12),
                                (BATCH, NEGS), True)
    if int(draws.min()) < 0 or int(draws.max()) >= n:
        raise AssertionError("K2 drew a node id outside [0, N)")
    if not bool((deg[draws.long()] > 0).all()):
        raise AssertionError("K2 drew a node without arcs")
    observed = counts(draws)
    test("K2 vs exact", observed, binned(deg * (draws.numel() / tg.n_arcs)), True)
    test("K2 vs plain", observed, counts(plain), False)
    del draws, plain
    # K2 over arc ids: on a view of the graph whose col_idx holds each arc's
    # own id, a draw is its arc. Node counts cannot show a draw that misses
    # arcs (the heads of most arc subsets of a symmetric graph are still
    # about degree-proportional); uniformity over bins of arc ids and the
    # number of repeated arcs can.
    arcs = nce_negatives(
        dataclasses.replace(tg, col_idx=torch.arange(
            tg.n_arcs, dtype=torch.int32, device=dev)),
        torch.Generator().manual_seed(16), (BATCH, NEGS)).reshape(-1).long()
    edges = np.linspace(0, tg.n_arcs, ARC_BINS + 1).astype(np.int64)
    observed = torch.bincount(
        torch.bucketize(arcs, torch.from_numpy(edges[1:-1]).to(dev), right=True),
        minlength=ARC_BINS).double().cpu().numpy()
    p["K2 arc ids by bin"] = exact_p(
        observed, np.diff(edges) * (arcs.numel() / tg.n_arcs))
    p["K2 arc ids repeats"] = repeats_p(arcs, tg.n_arcs)
    del arcs

    # K1: every move, given its source, against the exact next-node
    # probabilities; the first step from the same starts against the plain
    # version's.
    starts = nce_negatives(tg, torch.Generator().manual_seed(13), (BATCH,),
                           scale_free=False)
    walks = first_order_walks(tg, starts, WALK, torch.Generator().manual_seed(14))
    plain = first_order_walks_plain(
        tg, starts, WALK, torch.Generator(device=dev).manual_seed(15))
    if not bool((walks[:, 0] == starts).all()):
        raise AssertionError("walks[:, 0] differs from the starts")
    keys = arc_keys(graph, dev)
    src, pos = arc_positions(graph, walks, keys)
    per_source = torch.bincount(src, minlength=n).double() / deg.clamp(min=1)
    expected = torch.bincount(tg.col_idx.long(), weights=per_source[keys // n],
                              minlength=n)
    test("K1 moves vs exact", counts(tg.col_idx[pos]), binned(expected), True)
    test("K1 first step vs plain", counts(walks[:, 1]), counts(plain[:, 1]), False)
    failed = {k: v for k, v in p.items() if v < P_MIN}
    if failed:
        raise AssertionError(f"sampler tests at the slice shapes failed "
                             f"(p < {P_MIN}): {failed}")
    return p


def fused_batch_checks(erdos_renyi, graph, tg, tg_walk, dev):
    """The fused first-order batch (K1's walk and K2's draws in one launch)
    against its exact laws (`tests/walk_batch_laws.py`; chi-square, fail at
    p < P_MIN, fixed seeds): on small weighted and unweighted graphs with
    scale-free and uniform negatives at 3 iterations (starts uniform and
    tiled, every move an arc by the exact transitions, negatives by their
    law; unweighted with scale-free negatives, a walker's start, first
    step and negatives independent), and on the slice graph at the slice
    shapes, binned by node degree and by blocks of node ids: the starts,
    every move given its source and the negatives against the exact laws,
    the starts, the first steps and the negatives against the plain
    version's batch, and the streams' independence. On unweighted graphs
    the batch read from the arcs' records (`tg_walk`: the slice graph
    exported with them, as the walk models export it) must equal the batch
    read from row_ptr (`tg`) draw for draw. Returns (max |empirical -
    exact| arc probability on the small graphs, p-values by test)."""
    from embiggen_tpu_torch.ops.negatives import first_order_batch, first_order_batch_plain

    laws = laws_module("walk_batch_laws")
    p, err = {}, 0.0

    def same_on_records(name, rows_tg, records_tg, seed, *args):
        """The batch on the records equals the batch on row_ptr from the
        same key, draw for draw; returns the latter."""
        got = first_order_batch(rows_tg, torch.Generator().manual_seed(seed), *args)
        on_records = first_order_batch(records_tg, torch.Generator().manual_seed(seed), *args)
        if not all(torch.equal(a, b) for a, b in zip(got, on_records)):
            raise AssertionError(f"{name}: the batch on the arcs' records differs from the "
                                 "batch on row_ptr from the same key")
        return got
    for weighted in (False, True):
        g = erdos_renyi(200, 800, seed=7, weighted=weighted)
        sg = g.device(dev, with_alias=weighted)
        records = g.device(dev, with_walk_arcs=True)
        sources = torch.repeat_interleave(torch.arange(sg.n_nodes, device=dev),
                                          sg.degrees.long())
        for scale_free in (True, False):
            name = (f"small {'weighted' if weighted else 'unweighted'} "
                    f"{'scale-free' if scale_free else 'uniform'}")
            if weighted:
                walks, negs = first_order_batch(sg, torch.Generator().manual_seed(21), 8000, 3,
                                                24, NEGS, scale_free)
            else:
                walks, negs = same_on_records(name, sg, records, 21, 8000, 3, 24, NEGS,
                                              scale_free)
            got = laws.batch_p(sg, walks, negs, 8000, scale_free)
            if not weighted and scale_free:
                got.update(laws.stream_independence_p(sg, walks, negs, 8000, scale_free))
            p.update({f"{name} {k}": v for k, v in got.items()})
            src, arcs = laws.moves(sg, walks)
            n_from = torch.bincount(src, minlength=sg.n_nodes).double()
            seen = torch.bincount(arcs, minlength=sg.n_arcs).double()
            err = max(err, float((seen / n_from[sources].clamp(min=1)
                                  - laws.arc_probabilities(sg)).abs().max()))
    # The slice shapes: one launch's batch against the exact laws and the
    # plain version's batch.
    n, deg = tg.n_nodes, tg.degrees.long()
    keys = arc_keys(graph, dev)
    plain = first_order_batch_plain(tg, torch.Generator(device=dev).manual_seed(23), BATCH, 1,
                                    WALK, NEGS, True)
    arc_positions(graph, plain[0], keys)
    # Against the plain version: the starts, the first steps (independent
    # walker to walker, where later moves follow their walk's path) and the
    # negatives; every move against the exact law given its source. The
    # records' batch is the rows' draw for draw, so the laws are held once.
    walks, negs = same_on_records("slice", tg, tg_walk, 22, BATCH, 1, WALK, NEGS, True)
    src, pos = arc_positions(graph, walks, keys)
    per_source = torch.bincount(src, minlength=n).double() / deg.clamp(min=1)
    moves_exact = torch.bincount(tg.col_idx.long(), weights=per_source[keys // n],
                                 minlength=n)
    uniform = torch.full((n,), BATCH / n, dtype=torch.float64, device=dev)
    for part, got, exact in (("starts", walks[:, 0], uniform),
                             ("moves", tg.col_idx[pos], moves_exact),
                             ("negatives", negs, deg * (negs.numel() / tg.n_arcs))):
        binned_tests(p, f"slice {part} vs exact", node_counts(tg, got),
                     node_bins(tg, exact), True)
    for part, got, want in (("starts", walks[:, 0], plain[0][:, 0]),
                            ("first step", walks[:, 1], plain[0][:, 1]),
                            ("negatives", negs, plain[1])):
        binned_tests(p, f"slice {part} vs plain", node_counts(tg, got),
                     node_counts(tg, want), False)
    p.update({f"slice {k}": v for k, v in laws.stream_independence_p(
        tg, walks, negs, BATCH, True).items()})
    del walks, negs, src, pos
    failed = {k: v for k, v in p.items() if v < P_MIN}
    if failed:
        raise AssertionError(f"fused first-order batch tests failed (p < {P_MIN}): {failed}")
    return err, p


# The CUDA functions each wrapper's count stands for, as torch.profiler names
# them (a prefix where one launch runs several: K12's update and counts pass,
# K13a's six).
KERNEL_NAMES = {
    "first_order_walks": "first_order_walks_kernel", "nce_negatives": "node_draws_kernel",
    "first_order_batch": "first_order_batch_kernel",
    "skipgram_nce_update": "skipgram_nce_kernel",
    "skipgram_mean_combine": "skipgram_combine_kernel", "csr_edge_ids": "csr_edge_ids_kernel",
    "edge_prediction_mini_batch": "edge_minibatch_kernel", "spmm": "csr_spmm_kernel",
    "spmm_combine": "csr_spmm_combine_kernel", "khop_merge": "hop_merge_kernel",
    "edge_metrics": "edge_metrics_kernel", "ell_walks": "ell_walks_kernel",
    "rejection_walks": "rejection_walks_kernel", "exact_walks": "exact_walks_kernel",
    "cbow_update": "cbow_kernel",
    "mean_scatter": "scatter_rows_kernel", "mean_combine": "mean_rows_combine_kernel",
    "siamese_mini_batch": "siamese_batch_kernel", "line_mini_batch": "line_batch_kernel",
    "walklets_update": "walklets_", "cooccurrences": "cooc_",
    "glove_gradients": "glove_gradients_kernel", "glove_node_update": "glove_node_update_kernel",
    "glove_context_update": "glove_context_update_kernel", "min_plus_step": "min_plus_kernel",
    "hll_registers": "singletons_kernel", "khop_sketches": "hop_kernel",
    "sketch_hop1": "hop1_ids_kernel", "sketch_hop2": "hop2_",
    "edge_sketch_features": "edge_features_", "sketch_candidates": "sketch_candidates_kernel",
    "sketch_race_step": "sketch_race_kernel", "sddmm": "sddmm_kernel",
    "edge_chunk": "edge_chunk_kernel",
}


def counter_of(event_name):
    """The wrapper count whose kernel the profiler names `event_name`, or None."""
    return next((k for k, v in KERNEL_NAMES.items() if v in event_name), None)


def profiled(run):
    """(device events, {counter: launches}, {counter: events kept}) of
    torch.profiler around `run()`. The profiler drops some of a session's
    kernel records in long processes (it kept 7 of 10 launches, or 19 of
    20, in runs that launched them all, and in one run none of a session's
    four kernels three sessions in a row), so nothing that must hold reads
    it: it names and times PyTorch's own kernels in `profile`, and `kept`
    says how many of the port's launches it saw."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from embiggen_tpu_torch.ops import _build

    before = _build.launch_counts()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    launched = {k: v - before[k] for k, v in _build.launch_counts().items()
                if v > before[k] and k in KERNEL_NAMES}
    kept = {k: sum(KERNEL_NAMES[k] in e.name for e in events) for k in launched}
    return events, launched, kept


def cuda_ops(run):
    """(the port's launches by counter, the sorted names of the ATen operators
    that ran on CUDA tensors) in `run()`, as PyTorch's dispatcher saw each
    call: every operator that launches a kernel of PyTorch's own passes
    there, where torch.profiler may drop it. The port's kernels are launched
    through ctypes and do not pass there."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from embiggen_tpu_torch.ops import _build

    seen = set()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(t, torch.Tensor) and t.is_cuda
                   for t in tree_leaves((args, kwargs, out))):
                seen.add(func.overloadpacket.__name__)
            return out

    before = _build.launch_counts()
    with Record():
        run()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.launch_counts().items() if v > before[k]}
    return launched, sorted(seen)


def profile(step, n_steps):
    """Device time per kernel over `n_steps` calls of `step` after 3 warm-up
    calls, in three runs of those steps: the whole step on CUDA events; each
    of the port's kernels on the CUDA event pair recorded around each of its
    launches (`_build.timed_launches`; the stream is busy, so a pair times
    the kernel alone); PyTorch's own kernels from torch.profiler, which may
    drop records, so their sum is a lower bound. Returns ({name: (ms per
    step, launches per step, "events" or "profiler")}, ms per step on CUDA
    events, (profiler records kept, launches) of the port's kernels)."""
    from embiggen_tpu_torch.ops import _build

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    start.record()
    for _ in range(n_steps):
        step()
    end.record()
    end.synchronize()
    with _build.timed_launches() as pairs:
        for _ in range(n_steps):
            step()
    torch.cuda.synchronize()
    rows = {KERNEL_NAMES[k]: (sum(s.elapsed_time(e) for s, e in got) / n_steps,
                              len(got) / n_steps, "events") for k, got in pairs.items()}

    def run():
        for _ in range(n_steps):
            step()
    events, launched, kept = profiled(run)
    others = {}
    for e in events:
        if counter_of(e.name) is None:
            us, count = others.get(e.name, (0.0, 0))
            others[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    rows.update({k: (us / 1e3 / n_steps, c / n_steps, "profiler")
                 for k, (us, c) in others.items()})
    return (rows, start.elapsed_time(end) / n_steps,
            (sum(kept.values()), sum(launched.values())))


def embedder_step(model, graph):
    """One steady step of a walk-based embedder (S1's SkipGram, S5's CBOW)
    at its fit's settings, as a closure."""
    tg = model._device_graph(graph)
    gen = torch.Generator().manual_seed(0)
    params = model._init_params(graph, gen)
    sums = model._new_sums(params)

    def step():
        with torch.no_grad():
            model._step(tg, params, gen, 0.025, sums=sums)
    return step


def gcn_step(model, graph):
    """One steady Adam step of the fitted bench GCN (minibatch, forward,
    backward, update), as a closure."""
    from embiggen_tpu_torch.models.gcn.core import map_params, param_leaves

    from embiggen_tpu_torch.ops.negatives import BatchDraws

    params = map_params(lambda t: t.clone().requires_grad_(True), model._params)
    optimizer = torch.optim.Adam(param_leaves(params), lr=model._learning_rate)
    tg = graph.device(model.device, with_sources=True, with_arc_pairs=True)
    gen = torch.Generator().manual_seed(1)
    # K6's block, labels and key, held as the fit holds them.
    draws = BatchDraws.edges(model._run_batch_size, model._negative_samples_rate, tg.device)

    def step():
        optimizer.zero_grad(set_to_none=True)
        model._loss(params, model._csr_kernels, tg, None, gen, None, draws).backward()
        optimizer.step()
    return step


def k3_phase_line(card, dev):
    """K3's phase split at the S1 flagship shapes on seeded random inputs:
    the share of block time per phase from the PHASE_CLOCK build's stamps,
    and each share times the kernel's time."""
    from embiggen_tpu_torch.ops import skipgram
    from embiggen_tpu_torch.ops.scatter import SkipGramSums

    rng = np.random.default_rng(0)
    tables = [torch.from_numpy(0.3 * rng.standard_normal((N_NODES, DIM), dtype=np.float32)).to(dev)
              for _ in range(2)]
    bias = torch.from_numpy(3.0 * rng.standard_normal(N_NODES, dtype=np.float32)).to(dev)
    walks = torch.from_numpy(rng.integers(0, N_NODES, (BATCH, WALK), dtype=np.int32)).to(dev)
    negs = torch.from_numpy(rng.integers(0, N_NODES, (BATCH, NEGS), dtype=np.int32)).to(dev)
    args = (*tables, bias, walks, negs, WINDOW, 6.0)
    sums = SkipGramSums.zeros(N_NODES, DIM, dev)
    shares = skipgram.phase_split(*args, sums)
    ms = time_ms(lambda: skipgram.skipgram_nce_update(*args, sums), 10)
    print(f"phase 24 K3 phase split on {card}: kernel {ms:.3f} ms; "
          + "; ".join(f"{k} {v:.4f} of block time = {v * ms:.3f} ms"
                      for k, v in shares.items()), flush=True)
    return dict(ms=ms, **shares)


def s5_phase_lines(card, graph, dev):
    """K11's and K9's phase splits at the S5 shapes: K11 on seeded random
    tables and walks at the flagship widths (as `cbow_checks` times it), K9
    on the slice graph's ELL table at cap 100 from uniform starts (as
    `pq_walk_entries` times it); each share of block (K11) or walker (K9)
    time from the PHASE_CLOCK build's stamps, and each share times the
    kernel's time."""
    from embiggen_tpu_torch.ops import cbow, walks
    from embiggen_tpu_torch.ops.negatives import nce_negatives
    from embiggen_tpu_torch.ops.scatter import SkipGramSums

    rng = np.random.default_rng(1)
    tables = [torch.from_numpy(rng.standard_normal((N_NODES, DIM), dtype=np.float32)).to(dev)
              for _ in range(2)]
    bias = torch.from_numpy(3.0 * rng.standard_normal(N_NODES, dtype=np.float32)).to(dev)
    walk_ids = torch.from_numpy(rng.integers(0, N_NODES, (BATCH, WALK), dtype=np.int32)).to(dev)
    negs = torch.from_numpy(rng.integers(0, N_NODES, (BATCH, NEGS), dtype=np.int32)).to(dev)
    args = (*tables, bias, walk_ids, negs, WINDOW, 6.0)
    sums = SkipGramSums.zeros(N_NODES, DIM, dev)
    out = {}
    shares = cbow.phase_split(*args, sums)
    ms = time_ms(lambda: cbow.cbow_update(*args, sums), 10)
    out["cbow_update"] = dict(ms=ms, **shares)
    del tables, bias, walk_ids, negs, sums, args
    torch.cuda.empty_cache()
    tg = graph.device(dev, ell_cap=ELL_CAP)
    gen = torch.Generator().manual_seed(38)
    starts = nce_negatives(tg, gen, (BATCH,), scale_free=False)
    pq = (tg, starts, WALK, *PQ.values(), ELL_CAP, gen)
    shares = walks.ell_phase_split(*pq)
    ms = time_ms(lambda: walks.ell_walks(*pq), 10)
    out["ell_walks"] = dict(ms=ms, **shares)
    del tg, starts, pq
    torch.cuda.empty_cache()
    for name, split in out.items():
        ms = split["ms"]
        print(f"phase 24 {'K11' if name == 'cbow_update' else 'K9'} phase split on {card}: "
              f"kernel {ms:.4f} ms; " + "; ".join(
                  f"{k} {v:.4f} of {'block' if name == 'cbow_update' else 'walker'} time "
                  f"= {v * ms:.4f} ms" for k, v in split.items() if k != "ms"), flush=True)
    return out


def print_profile(name, card, rows, step_ms, kept):
    busy = sum(ms for ms, _, _ in rows.values())
    port = sum(ms for ms, _, how in rows.values() if how == "events")
    print(f"phase 24 profile {name} on {card}: {PROFILE_STEPS} steady steps, "
          f"{step_ms:.3f} ms per step (CUDA events), kernels {busy:.3f} ms "
          f"per step ({port:.3f} of the port's on their launches' events, the rest "
          f"from torch.profiler), device busy share {busy / step_ms:.3f}; the "
          f"profiler kept {kept[0]} of the port's {kept[1]} launches", flush=True)
    for kernel, (ms, count, how) in sorted(rows.items(), key=lambda r: -r[1][0]):
        print(f"  profile {name} {ms:9.4f} ms/step {ms / busy:7.2%} "
              f"{count:5.2f} launches/step {how:8s}  {kernel[:100]}", flush=True)


def skipgram_checks(dev):
    """K3 and K4's SkipGram combine against their plain versions at
    SKIPGRAM_SHAPES, with and without centre weights, on seeded random
    tables and walks: K3's counts exactly and its sums to K3_SUMS_TOL, the
    tables after the combine to K3_UPDATE_ATOL; the sums and counts all zero
    after the combine. Then K4's standalone mean_scatter at the flagship
    shapes (timed at the S6 shapes, `k4_line_checks`). Returns (kernels
    entries timed at the flagship shapes, {shape: (sums err, combined tables
    err)})."""
    from embiggen_tpu_torch.ops.scatter import (
        SkipGramSums, mean_scatter, mean_scatter_plain, skipgram_mean_combine,
        skipgram_mean_combine_plain,
    )
    from embiggen_tpu_torch.ops.skipgram import skipgram_nce_update, skipgram_nce_update_plain

    entries, errs = {}, {}
    for name, n, d, length, w, k, b in SKIPGRAM_SHAPES:
        rng = np.random.default_rng(0)
        tables = [torch.from_numpy(0.3 * rng.standard_normal((n, d), dtype=np.float32)).to(dev)
                  for _ in range(2)]
        tables.append(torch.from_numpy(3.0 * rng.standard_normal(n, dtype=np.float32)).to(dev))
        walks = torch.from_numpy(rng.integers(0, n, (b, length), dtype=np.int32)).to(dev)
        negs = torch.from_numpy(rng.integers(0, n, (b, k), dtype=np.int32)).to(dev)
        center_w = torch.from_numpy(rng.uniform(0, 2, (b, length)).astype(np.float32)).to(dev)
        args = (*tables, walks, negs, w, 6.0)
        sums_err = combine_err = 0.0
        for cw in (None, center_w):
            sums, want_sums = SkipGramSums.zeros(n, d, dev), SkipGramSums.zeros(n, d, dev)
            loss = skipgram_nce_update(*args, sums, cw)
            want_loss = skipgram_nce_update_plain(*args, want_sums, cw)
            check_close(f"K3 {name} loss", loss, want_loss, **K3_SUMS_TOL)
            for field in ("counts_w", "counts_c"):
                check_close(f"K3 {name} {field}", getattr(sums, field),
                            getattr(want_sums, field), 0.0, 0.0)
            # Sums of gradients (a negative's bias takes one per centre).
            for field in ("sums_w", "sums_c", "sums_b"):
                sums_err = max(sums_err, check_close(
                    f"K3 {name} {field}", getattr(sums, field),
                    getattr(want_sums, field), **K3_SUMS_TOL))
            got_t = [t.clone() for t in tables]
            want_t = [t.clone() for t in tables]
            skipgram_mean_combine(*got_t, sums, 0.025)
            skipgram_mean_combine_plain(*want_t, want_sums, 0.025)
            for i, (x, y) in enumerate(zip(got_t, want_t)):
                combine_err = max(combine_err, check_close(
                    f"K4 combine {name} table {i}", x, y, 0.0, K3_UPDATE_ATOL))
            if any(bool(t.any()) for t in sums.buffers()):
                raise AssertionError(f"K4 combine {name}: sums or counts not zero after it")
            del got_t, want_t, want_sums, sums
        errs[name] = (sums_err, combine_err)
        if name != "flagship":
            continue
        # Times and bounds at the flagship shapes. Rows each table must read
        # (and the sums write): the walk's nodes, and with the negatives.
        u_w = int(torch.unique(walks).numel())
        u_c = int(torch.unique(torch.cat([walks.reshape(-1), negs.reshape(-1)])).numel())
        pairs = b * (length - 2 * w) * (2 * w + k)
        gathered = 4 * ((u_w + u_c) * d + u_c + b * (length + k))
        sums = SkipGramSums.zeros(n, d, dev)
        entries["skipgram_nce_update"] = dict(
            source="embiggen_tpu_torch/csrc/skipgram.cu",
            replaces="embiggen_tpu/models/embedders/walk_based.py:895",
            max_abs_err=sums_err,
            ms=time_ms(lambda: skipgram_nce_update(*args, sums), 10),
            plain_ms=time_ms(lambda: skipgram_nce_update_plain(*args, sums), 3),
            library_ms=None,
            # the sums' touched rows and counts read and written once
            **bound(gathered + 8 * ((u_w + u_c) * d + 3 * u_c + u_w) + 4 * b,
                    6 * d * pairs + b * (2 * length + k) * d))
        work = [t.clone() for t in tables]
        entries["skipgram_mean_combine"] = dict(
            source="embiggen_tpu_torch/csrc/scatter.cu",
            replaces="embiggen_tpu/models/embedders/walk_based.py:817",
            max_abs_err=combine_err,
            ms=time_after(lambda: skipgram_nce_update(*args, sums),
                          lambda: skipgram_mean_combine(*work, sums, 0.025), 10),
            plain_ms=time_after(lambda: skipgram_nce_update(*args, sums),
                                lambda: skipgram_mean_combine_plain(*work, sums, 0.025), 3),
            library_ms=None,
            # both counts read; touched rows of tables and sums read and
            # written once, the counts of those rows zeroed
            **bound(8 * n + 16 * (u_w * d + u_c * d + u_c) + 4 * (u_w + u_c),
                    3 * (u_w + u_c) * d))
        del work, sums
        # K4's standalone mean_scatter: the context table from the walk rows
        # and the negatives, with random gradients.
        segs = (walks.reshape(-1), negs.reshape(-1))
        gsegs = tuple(torch.from_numpy(rng.standard_normal((s.numel(), d), dtype=np.float32)).to(dev)
                      for s in segs)
        got, counts = mean_scatter(tables[1].clone(), segs, gsegs, 0.025)
        want, want_counts = mean_scatter_plain(tables[1].clone(), segs, gsegs, 0.025)
        scatter_err = check_close("K4 table", got, want, 0.0, 1e-5)
        check_close("K4 counts", counts, want_counts, 0.0, 0.0)
        gb = tuple(torch.from_numpy(rng.standard_normal(s.numel(), dtype=np.float32)).to(dev)
                   for s in segs)
        got_b, _ = mean_scatter(tables[2].clone(), segs, gb, 0.025, counts)
        want_b, _ = mean_scatter_plain(tables[2].clone(), segs, gb, 0.025, counts)
        scatter_err = max(scatter_err, check_close("K4 bias", got_b, want_b, 0.0, 1e-5))
        del got, want, got_b, want_b, gb, gsegs
        errs["K4 standalone"] = (scatter_err, scatter_err)
    return entries, errs


def edge_queries(tg, hubs: bool):
    """K5's queries: half arcs (the ends of uniform arc ids), half pairs of
    a uniform node (on the hub graph a scale-free one, the head of a
    uniform arc, so hubs are sources at the rate scale-free draws give
    them) and a uniform node. Returns (src, dst, the arc ids of the first
    half)."""
    dev, n, n_arcs = tg.device, tg.n_nodes, tg.n_arcs
    rng = np.random.default_rng(21)
    q = 1 << 20
    arc = torch.from_numpy(rng.integers(0, n_arcs, q // 2)).to(dev)
    if hubs:
        other = tg.col_idx[torch.from_numpy(rng.integers(0, n_arcs, q - q // 2)).to(dev)]
    else:
        other = torch.from_numpy(rng.integers(0, n, q - q // 2, dtype=np.int32)).to(dev)
    dst = torch.from_numpy(rng.integers(0, n, q - q // 2, dtype=np.int32)).to(dev)
    return (torch.cat([tg.sources[arc], other]).contiguous(),
            torch.cat([tg.col_idx[arc], dst]).contiguous(), arc)


def k5_check(tg, hubs: bool) -> dict:
    """K5 on 2^20 `edge_queries` of `tg`, exactly against its plain version;
    every arc found at its id. Returns its numbers."""
    from embiggen_tpu_torch.ops.walks import csr_edge_ids, csr_edge_ids_plain

    src, dst, arc = edge_queries(tg, hubs)
    q = src.shape[0]
    ids, found = csr_edge_ids(tg.row_ptr, tg.col_idx, src, dst)
    want_ids, want_found = csr_edge_ids_plain(tg.row_ptr, tg.col_idx, src, dst)
    if not (torch.equal(ids, want_ids) and torch.equal(found, want_found)):
        raise AssertionError(f"K5 and its plain version differ ({'hub' if hubs else 'slice'} "
                             "graph)")
    if not (bool(found[:q // 2].all()) and torch.equal(ids[:q // 2], arc.int())):
        raise AssertionError("K5 missed an arc")
    return dict(
        max_abs_err=float((ids - want_ids).abs().max()),
        ms=time_ms(lambda: csr_edge_ids(tg.row_ptr, tg.col_idx, src, dst), 20),
        plain_ms=time_ms(lambda: csr_edge_ids_plain(tg.row_ptr, tg.col_idx, src, dst), 3),
        # pairs in, ids and flags out, two row_ptr reads and a search each
        **bound(q * (8 + 5 + 8) + 4 * float(search_reads(tg.degrees[src.long()]).sum()), 0),
        call=lambda: csr_edge_ids(tg.row_ptr, tg.col_idx, src, dst), src=src, dst=dst)


def k6_check(tg, p, name, ws_seed):
    """K6 on `tg` at the GCN's batch through a fit's workspace (its first
    batch, which must equal the batch drawn without one from the same
    generator state), held to its exact laws and to its plain version's
    draws; the p-values go into `p` under `name`. Returns (the workspace,
    its generator, the label layout's error)."""
    from scipy.stats import poisson

    from embiggen_tpu_torch.ops.negatives import (
        BatchDraws, edge_prediction_mini_batch, edge_prediction_mini_batch_plain,
    )
    from embiggen_tpu_torch.ops.walks import csr_edge_ids_plain

    dev, n_arcs = tg.device, tg.n_arcs
    ws = BatchDraws.edges(GCN_BATCH, 0.5, dev)
    gen = torch.Generator().manual_seed(ws_seed)
    s, d, labels = (t.clone() for t in edge_prediction_mini_batch(tg, gen, GCN_BATCH,
                                                                   workspace=ws))
    fresh = edge_prediction_mini_batch(tg, torch.Generator().manual_seed(ws_seed), GCN_BATCH)
    if not all(torch.equal(a, b) for a, b in zip((s, d, labels), fresh)):
        raise AssertionError(f"{name}: the workspace's first batch differs from the batch "
                             "drawn without one at the same key and offset")
    del fresh
    ps, pd, _ = edge_prediction_mini_batch_plain(
        tg, torch.Generator(device=dev).manual_seed(ws_seed + 1), GCN_BATCH)
    n_neg = int(round(GCN_BATCH * 0.5))
    n_pos = GCN_BATCH - n_neg
    want_labels = torch.cat([torch.ones(n_pos, device=dev), torch.zeros(n_neg, device=dev)])
    layout_err = float((labels - want_labels).abs().max())
    if layout_err != 0.0:
        raise AssertionError(f"{name} label layout differs")
    pos_ids, pos_found = csr_edge_ids_plain(tg.row_ptr, tg.col_idx, s[:n_pos], d[:n_pos])
    if not bool(pos_found.all()):
        raise AssertionError(f"a {name} positive is not an arc")
    edges = np.linspace(0, n_arcs, ARC_BINS + 1).astype(np.int64)
    observed = torch.bincount(
        torch.bucketize(pos_ids.long(), torch.from_numpy(edges[1:-1]).to(dev), right=True),
        minlength=ARC_BINS).double().cpu().numpy()
    p[f"{name} positives by arc-id bin"] = exact_p(observed,
                                                   np.diff(edges) * (n_pos / n_arcs))
    p[f"{name} positives repeats"] = repeats_p(pos_ids, n_arcs)
    # The exact law of a negative: a pair drawn from p x p (p the degree
    # share) is redrawn while it is an arc or a loop, twice at most, so
    # P(s) = p_s ((1 + beta + beta^2) - (1 + beta) b_s), b_s the chance that
    # a pair drawn with source s is bad and beta the chance that any is
    # (destinations alike with the arcs reversed). Hubs' pairs are arcs
    # often enough (about 2%) for this to show on the hub graph.
    prob = tg.degrees.double() / n_arcs
    heads, tails = tg.col_idx.long(), tg.sources.long()
    loops = heads == tails
    bad_by = {}
    for side, at, other in (("sources", tails, heads), ("destinations", heads, tails)):
        b = prob.clone()
        b.index_add_(0, at[~loops], prob[other[~loops]])
        bad_by[side] = b
    beta = float((prob * bad_by["sources"]).sum())
    for side, got, plain in (("sources", s, ps), ("destinations", d, pd)):
        law = prob * ((1 + beta + beta ** 2) - (1 + beta) * bad_by[side])
        observed = node_counts(tg, got[n_pos:])
        binned_tests(p, f"{name} negative {side} vs exact", observed,
                     node_bins(tg, law * n_neg), True)
        binned_tests(p, f"{name} negative {side} vs plain", observed,
                     node_counts(tg, plain[n_pos:]), False)
    del heads, tails, loops, bad_by
    # A drawn pair is an arc or a self-loop with probability beta; after two
    # redraws, beta^3 of the negatives stay so.
    _, neg_arcs = csr_edge_ids_plain(tg.row_ptr, tg.col_idx, s[n_pos:], d[n_pos:])
    bad = int((neg_arcs | (s[n_pos:] == d[n_pos:])).sum())
    p[f"{name} negatives that are arcs or loops"] = float(poisson.sf(bad - 1,
                                                                     n_neg * beta ** 3))
    # Pairs out (labels only on a workspace's first batch); a positive reads
    # its arc's two ends, a negative two arc heads, its source's row bounds
    # and its search's reads.
    n_bytes = (GCN_BATCH * 8 + n_pos * 8 + n_neg * 16
               + 4 * float(search_reads(tg.degrees[s[n_pos:].long()]).sum()))
    return ws, gen, layout_err, n_bytes


def edge_kernel_checks(graph, tg):
    """K5 and K6 on the 20M-arc graph at the slice shapes, and on it plus
    N_HUBS hubs. Returns (their kernels entries, the K6 p-values)."""
    from embiggen_tpu_torch.ops.negatives import (
        edge_prediction_mini_batch, edge_prediction_mini_batch_plain,
    )

    dev, n = tg.device, tg.n_nodes
    htg = hub_graph(graph).device(dev, with_sources=True, with_arc_pairs=True)
    k5, k5_hub = k5_check(tg, False), k5_check(htg, True)
    # K6 reads its positives from the arcs' (source, head) records, as the
    # GCN exports its graph.
    paired = dataclasses.replace(tg, arc_pairs=torch.stack([tg.sources, tg.col_idx], 1))
    # The same lookup as one call: a search over the sorted src * N + dst
    # keys of the arcs.
    keys = tg.sources.long() * n + tg.col_idx.long()
    q_keys = k5["src"].long() * n + k5["dst"].long()
    entries = {"csr_edge_ids": dict(
        source="embiggen_tpu_torch/csrc/edges.cu",
        replaces="embiggen_tpu/ops/walks.py:66",
        library_ms=time_ms(lambda: torch.searchsorted(keys, q_keys), 20),
        library="torch.searchsorted",
        **{k: v for k, v in k5.items() if k not in ("call", "src", "dst")},
        hub_graph_arcs=htg.n_arcs, hub_ms=k5_hub["ms"], hub_plain_ms=k5_hub["plain_ms"],
        hub_bound_ms=k5_hub["bound_ms"],
        hub_max_abs_err=k5_hub["max_abs_err"],
    )}
    del keys, q_keys

    p = {}
    ws, gen, layout_err, n_bytes = k6_check(paired, p, "K6", 22)
    hub_ws, hub_gen, hub_err, hub_bytes = k6_check(htg, p, "K6 hubs", 24)
    failed = {k: v for k, v in p.items() if v < P_MIN}
    if failed:
        raise AssertionError(f"K6 tests failed (p < {P_MIN}): {failed}")
    cuda_gen = torch.Generator(device=dev).manual_seed(23)
    on_ws = lambda: edge_prediction_mini_batch(  # noqa: E731
        paired, gen, GCN_BATCH, workspace=ws)
    on_hub_ws = lambda: edge_prediction_mini_batch(  # noqa: E731
        htg, hub_gen, GCN_BATCH, workspace=hub_ws)
    entries["edge_prediction_mini_batch"] = dict(
        source="embiggen_tpu_torch/csrc/edges.cu",
        replaces="embiggen_tpu/ops/negatives.py:60", max_abs_err=max(layout_err, hub_err),
        # on the fit's workspace and the arcs' records, as the GCN draws;
        # fresh_ms without the workspace, sources_ms without the records
        ms=time_ms(on_ws, 20),
        fresh_ms=time_ms(lambda: edge_prediction_mini_batch(paired, gen, GCN_BATCH), 20),
        sources_ms=time_ms(lambda: edge_prediction_mini_batch(tg, gen, GCN_BATCH,
                                                              workspace=ws), 20),
        plain_ms=time_ms(lambda: edge_prediction_mini_batch_plain(tg, cuda_gen, GCN_BATCH), 5),
        library_ms=None,
        **bound(n_bytes, 0),
        # the bound with the labels written every launch, as before the workspace
        labels_bound_ms=bound(n_bytes + 4 * GCN_BATCH, 0)["bound_ms"],
        hub_graph_arcs=htg.n_arcs, hub_ms=time_ms(on_hub_ws, 20),
        hub_bound_ms=bound(hub_bytes, 0)["bound_ms"],
    )
    for name, ms in device_ms({
        "csr_edge_ids": k5["call"], "edge_prediction_mini_batch": on_ws,
    }).items():
        entries[name]["device_ms"] = ms
    hub_device = device_ms({"csr_edge_ids": k5_hub["call"],
                            "edge_prediction_mini_batch": on_hub_ws})
    for name, ms in hub_device.items():
        entries[name]["hub_device_ms"] = ms
    del htg, k5, k5_hub, ws, hub_ws, paired
    return entries, p


def spmm_check(k, x, g, name, exact=False) -> float:
    """K7 forward for every combiner and its backward through autograd
    against the plain version, over `k` with input `x` and output gradient
    `g`; with `exact`, the plain version runs in float64 (on a hub's row of
    65,536 terms the float32 plain version's atomic order is itself off by
    more than K7_TOL). Returns the largest abs error."""
    from embiggen_tpu_torch.ops.spmm import COMBINERS, csr_spmm_plain, spmm

    def plain(kk, v, rs, cs):
        return csr_spmm_plain(kk, v.double(), rs, cs).float() if exact else \
            csr_spmm_plain(kk, v, rs, cs)
    err = 0.0
    for combiner in COMBINERS:
        inv = k.inverse_denominator(combiner)
        xg = x.clone().requires_grad_(True)
        y = spmm(k, xg, combiner)
        (dx,) = torch.autograd.grad(y, xg, g)
        err = max(err, check_close(f"K7 forward {combiner} {name}", y.detach(),
                                   plain(k, x, inv, None), **K7_TOL))
        err = max(err, check_close(f"K7 backward {combiner} {name}", dx,
                                   plain(k.transpose, g, None, inv), **K7_TOL))
        del xg, y, dx
    return err


def queue_hub_kernel(graph) -> None:
    """Queue the layout of the hub graph's Symmetric Normalized Laplacian as
    a host CSRKernel (with its transpose and row plans) on the worker
    thread, after the hub graph: built once, for phase 4."""
    def build():
        from embiggen_tpu_torch.graph.laplacians import kernel_coo
        from embiggen_tpu_torch.ops.spmm import csr_kernel

        hub = hub_graph(graph)
        t0 = time.perf_counter()
        k = csr_kernel(*kernel_coo(hub, "Symmetric Normalized Laplacian"),
                       hub.number_of_nodes, device="cpu")
        return k, time.perf_counter() - t0
    _HUB_KERNELS[id(graph)] = _GRAPHS_WORKER.submit(build)


def kernel_on(k, dev):
    """A host CSRKernel, with its transpose and row plan, on `dev`."""
    return dataclasses.replace(
        k, **{f: getattr(k, f).to(dev) for f in (
            "row_ptr", "rows", "cols", "vals", "abs_weight_sum", "sq_weight_sum")},
        plan=k.plan.to(dev),
        transpose=None if k.transpose is None else kernel_on(k.transpose, dev))


def spmm_hub_checks(graph, dev) -> dict:
    """K7 over the hub graph's Symmetric Normalized Laplacian at D 128, its
    CSRKernel laid out once on the worker thread: the row plan (the hub
    rows cut into chunks of SPLIT arcs), forward for every combiner and
    backward through autograd against the plain version in float64 at
    K7_TOL, two calls bit-equal, the launches of one forward and backward
    (counts set to 0 just before, read just after), each direction's time
    beside its gather floor, and the combine launch's time against its
    plain version."""
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.ops.spmm import csr_spmm, spmm, spmm_combine_plain
    from embiggen_tpu_torch.scripts.redesign_times import k7_floor_ms

    t0 = time.perf_counter()
    host, layout_s = _HUB_KERNELS.pop(id(graph)).result()
    wait_s = time.perf_counter() - t0
    k = kernel_on(host, dev)
    del host
    n = k.n_out
    rng = np.random.default_rng(26)
    x = torch.from_numpy(rng.standard_normal((n, DIM), dtype=np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((n, DIM), dtype=np.float32)).to(dev)
    err = spmm_check(k, x, g, "hub graph D 128", exact=True)
    inv = k.inverse_denominator("sqrtn")
    if not (torch.equal(spmm(k, x, "sqrtn"), spmm(k, x, "sqrtn"))
            and torch.equal(csr_spmm(k.transpose, g, None, inv),
                            csr_spmm(k.transpose, g, None, inv))):
        raise AssertionError("K7 on the hub graph: two calls differ")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    xg = x.clone().requires_grad_(True)
    torch.autograd.grad(spmm(k, xg, "sqrtn"), xg, g)
    torch.cuda.synchronize()
    launches = {c: _build.launch_counts()[c] for c in ("spmm", "spmm_combine")}
    if launches != {"spmm": 2, "spmm_combine": 2}:
        raise AssertionError(f"K7 on the hub graph launched {launches}")
    del xg
    partials = torch.randn((k.plan.n_chunks, DIM), device=dev)
    return dict(
        arcs=k.n_arcs, split=k.plan.split, long_rows=k.plan.n_rows, chunks=k.plan.n_chunks,
        transpose_chunks=k.transpose.plan.n_chunks, layout_s=layout_s, wait_s=wait_s,
        max_abs_err=err,
        launches=launches, floor_ms=k7_floor_ms(k, DIM),
        ms=time_ms(lambda: spmm(k, x, "sqrtn"), 20),
        backward_ms=time_ms(lambda: csr_spmm(k.transpose, g, None, inv), 20),
        combine_ms=launch_event_ms(lambda: spmm(k, x, "sqrtn"), "spmm_combine", 10),
        combine_plain_ms=time_ms(lambda: spmm_combine_plain(k.plan, partials, inv), 10),
        # the partials read once, the long rows written
        combine_bound=bound(4 * DIM * (k.plan.n_chunks + k.plan.n_rows), 0))


def spmm_checks(graph, dev):
    """K7 over the slice graph's Symmetric Normalized Laplacian at D = 128
    and over a small weighted graph's at D = 30 (the scalar path): forward
    for every combiner and backward through autograd, against the plain
    version. Returns its kernels entry, timed at the slice shape, with two
    one-call yardsticks: `embedding_bag` and cuSPARSE's CSR product."""
    import torch.nn.functional as F

    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.graph.laplacians import kernel_coo
    from embiggen_tpu_torch.ops.spmm import csr_kernel, csr_spmm, csr_spmm_plain
    from embiggen_tpu_torch.scripts.redesign_times import k7_floor_ms

    small = erdos_renyi(20_000, 100_000, seed=3, weighted=True)
    rng = np.random.default_rng(24)
    k = csr_kernel(*kernel_coo(small, "Symmetric Normalized Laplacian"),
                   small.number_of_nodes, device=dev)
    x = torch.from_numpy(rng.standard_normal((small.number_of_nodes, 30), dtype=np.float32)).to(dev)
    small_err = spmm_check(k, x, torch.randn_like(x), "D 30")
    t0 = time.perf_counter()
    k = csr_kernel(*kernel_coo(graph, "Symmetric Normalized Laplacian"),
                   graph.number_of_nodes, device=dev)
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    x = torch.from_numpy(rng.standard_normal((N_NODES, DIM), dtype=np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((N_NODES, DIM), dtype=np.float32)).to(dev)
    err = max(small_err, spmm_check(k, x, g, "D 128"))
    # The forward with the sum combiner as one call: a bag sum, and the CSR
    # product of cuSPARSE.
    cols, offsets = k.cols.long(), k.row_ptr[:-1].long()
    a = torch.sparse_csr_tensor(k.row_ptr, k.cols, k.vals, size=(N_NODES, N_NODES))
    cusparse_err = float((torch.sparse.mm(a, x) - csr_spmm_plain(k, x)).abs().max())
    yardsticks = {
        "F.embedding_bag": time_ms(lambda: F.embedding_bag(
            cols, x, offsets, mode="sum", per_sample_weights=k.vals), 20),
        "torch.sparse.mm (cuSPARSE)": time_ms(lambda: torch.sparse.mm(a, x), 20),
    }
    library = min(yardsticks, key=yardsticks.get)
    entry = dict(
        source="embiggen_tpu_torch/csrc/spmm.cu",
        replaces="embiggen_tpu/ops/spmm.py:337", max_abs_err=err,
        ms=time_ms(lambda: csr_spmm(k, x), 20),
        plain_ms=time_ms(lambda: csr_spmm_plain(k, x), 3),
        library_ms=yardsticks[library], library=library,
        embedding_bag_ms=yardsticks["F.embedding_bag"],
        cusparse_ms=yardsticks["torch.sparse.mm (cuSPARSE)"], cusparse_max_abs_err=cusparse_err,
        **bound(4 * (k.row_ptr.numel() + 2 * k.n_arcs)
                + 4 * DIM * (int(torch.unique(k.cols).numel()) + N_NODES),
                2 * k.n_arcs * DIM),
        backward_ms=time_ms(lambda: csr_spmm(k.transpose, g), 20),
        backward_plain_ms=time_ms(lambda: csr_spmm_plain(k.transpose, g), 3),
        layout_s=layout_s,
    )
    entry["gathered_rows_per_s"] = k.n_arcs / (entry["ms"] / 1e3)
    entry["floor_ms"] = k7_floor_ms(k, DIM)
    entry["plan_chunks"] = k.plan.n_chunks
    del cols, offsets, a, k, x, g
    torch.cuda.empty_cache()
    entry["hub"] = spmm_hub_checks(graph, dev)
    entry["max_abs_err"] = max(entry["max_abs_err"], entry["hub"]["max_abs_err"])
    return entry


def probe_checks(dev):
    """P1 and P2 against their plain versions at the probe's shapes.
    Returns their kernels entries (with gathered rows/s and GB/s)."""
    import torch.nn.functional as F

    from embiggen_tpu_torch.ops.gather_probe import (
        P1_TILE, P2_BLOCK, table_gather_sums, tile_gather_sums, tile_gather_sums_plain,
    )
    from embiggen_tpu_torch.scripts.spmm_probe import E_SMALL, TABLE

    gen = torch.Generator(device=dev).manual_seed(25)
    x = torch.randn((N_NODES, DIM), generator=gen, device=dev)
    idx = torch.randint(0, N_NODES, (E_SMALL,), generator=gen, device=dev, dtype=torch.int32)
    tbl = torch.randn((TABLE, DIM), generator=gen, device=dev)
    idx_tbl = torch.randint(0, TABLE, (E_SMALL,), generator=gen, device=dev, dtype=torch.int32)
    entries = {}
    for name, fn, table, ix, tile, shape, replaces in (
        ("tile_gather_sums", tile_gather_sums, x, idx, P1_TILE, (7812, DIM),
         "scripts/spmm_probe.py:134"),
        ("table_gather_sums", table_gather_sums, tbl, idx_tbl, P2_BLOCK, (244, DIM),
         "scripts/spmm_probe.py:206"),
    ):
        got = fn(table, ix)
        if tuple(got.shape) != shape:
            raise AssertionError(f"{name} has shape {tuple(got.shape)}, expected {shape}")
        err = check_close(name, got, tile_gather_sums_plain(table, ix, tile), **PROBE_TOL)
        ms = time_ms(lambda: fn(table, ix), 20)
        rows = shape[0] * tile
        used = ix[:rows].long()
        offsets = torch.arange(0, rows, tile, device=dev)
        entries[name] = dict(
            source="embiggen_tpu_torch/csrc/gather_probe.cu", replaces=replaces,
            max_abs_err=err, ms=ms,
            plain_ms=time_ms(lambda: tile_gather_sums_plain(table, ix, tile), 5),
            library_ms=time_ms(lambda: F.embedding_bag(used, table, offsets, mode="sum"), 20),
            library="F.embedding_bag",
            # indices and the distinct rows they name read once, sums out
            **bound(4 * rows + 4 * DIM * (int(torch.unique(used).numel()) + shape[0]),
                    rows * DIM),
            rows_per_s=rows / (ms / 1e3), gbytes_per_s=rows * DIM * 4 / (ms / 1e3) / 1e9,
        )
    return entries


# The host graphs later phases take are built on one worker thread while
# the phases before them run (numpy's sorts release the GIL).
_GRAPHS_WORKER = concurrent.futures.ThreadPoolExecutor(max_workers=1)
# hub_graph's graphs by (the graph it extends, typed): built once a run, as
# every phase that checks a kernel on hubs takes the same seeded graph.
_HUB_GRAPHS = {}
# queue_hub_kernel's host CSRKernel of the hub graph by id(graph), taken by
# phase 4.
_HUB_KERNELS = {}


def hub_graph(graph, typed=False, wait=True):
    """`graph` plus N_HUBS new nodes, each joined to 4,096-65,536 random
    nodes (hubs included). With `typed`, `graph`'s node and edge types are
    kept, and the hubs and their edges are typed at random among as many
    types. Built once for `graph` on the worker thread; with `wait` False
    only queued."""
    key = (id(graph), typed)
    if key not in _HUB_GRAPHS or _HUB_GRAPHS[key][0] is not graph:
        _HUB_GRAPHS[key] = (graph, _GRAPHS_WORKER.submit(_planted_hubs, graph, typed))
    return _HUB_GRAPHS[key][1].result() if wait else None


def _planted_hubs(graph, typed):
    from embiggen_tpu_torch.graph import Graph

    rng = np.random.default_rng(27)
    n = graph.number_of_nodes
    sizes = rng.integers(4096, 65536, N_HUBS, endpoint=True)
    hubs = np.repeat(np.arange(n, n + N_HUBS), sizes)
    one = graph.sources < graph.col_idx
    dst = rng.integers(0, n + N_HUBS, len(hubs))
    types = {}
    if typed:
        types = dict(
            edge_types=np.concatenate([graph.edge_types[one], rng.integers(
                0, graph.number_of_edge_types, len(hubs)).astype(np.int32)]),
            node_type_ptr=np.arange(n + N_HUBS + 1, dtype=np.int64),
            node_type_ids=np.concatenate([graph.node_type_ids, rng.integers(
                0, graph.number_of_node_types, N_HUBS).astype(np.int32)]))
    return Graph.from_edge_arrays(
        np.concatenate([graph.sources[one], hubs]), np.concatenate([graph.col_idx[one], dst]),
        n_nodes=n + N_HUBS, directed=False, name="ER+hubs", **types)


def edge_metrics_check(graph, tg, hub_pairs):
    """K8 against its plain version on K8_PAIRS pairs of `graph` (half arcs,
    half uniform pairs, the last `hub_pairs` of them between two of the
    N_HUBS highest-degree nodes). Returns (max abs err, ms, plain ms, number
    of pairs truncated at cap)."""
    from embiggen_tpu_torch.ops.edge_metrics import edge_metrics, edge_metrics_plain

    dev, n = tg.device, graph.number_of_nodes
    rng = np.random.default_rng(28)
    arc = rng.integers(0, graph.number_of_directed_edges, K8_PAIRS // 2)
    rest = K8_PAIRS - K8_PAIRS // 2
    hubs = np.argsort(-graph.degrees, kind="stable")[:N_HUBS]
    pick = [np.concatenate([rng.integers(0, n, rest - hub_pairs),
                            rng.choice(hubs, hub_pairs)]) for _ in range(2)]
    src = torch.from_numpy(np.concatenate([graph.sources[arc], pick[0]]).astype(np.int32)).to(dev)
    dst = torch.from_numpy(np.concatenate([graph.col_idx[arc], pick[1]]).astype(np.int32)).to(dev)
    got = edge_metrics(tg, src, dst)
    want = edge_metrics_plain(tg, src, dst)
    deg = tg.degrees.long()
    if not torch.equal(got[:, 3], want[:, 3]):
        raise AssertionError("K8 preferential attachment differs from the plain version")
    # The common-neighbour count, recovered from Jaccard and the degree sum.
    total = (deg[src.long()] + deg[dst.long()]).double()

    def inter(m):
        jac = m[:, 1].double()
        return torch.round(jac * total / (1.0 + jac))
    if not torch.equal(inter(got), inter(want)):
        raise AssertionError("K8 common-neighbour counts differ from the plain version")
    err = check_close("K8 Jaccard", got[:, 1], want[:, 1], 1e-6, 0.0)
    err = max(err, check_close("K8 Adamic-Adar and RA", got[:, [0, 2]],
                               want[:, [0, 2]], **K8_SUM_TOL))
    small = torch.minimum(deg[src.long()], deg[dst.long()])
    truncated = int((small > 128).sum())
    # Bytes by the read-once rule, each distinct row once: pairs in and four
    # floats out; the two row_ptr entries of each distinct endpoint; of each
    # CSR row, the most entries any pair needs of it: an expanded row's first
    # min(deg, 128), and of the other row the fewer of its whole length (a
    # merge) and the candidates' lower-bound searches; the two row_ptr
    # entries of each common neighbour, at most once per node.
    s_l, d_l = src.long(), dst.long()
    swap = deg[d_l] < deg[s_l]
    a, b = torch.where(swap, d_l, s_l), torch.where(swap, s_l, d_l)
    cand = deg[a].clamp(max=128).double()
    need = torch.zeros(n, dtype=torch.float64, device=dev).scatter_reduce_(
        0, torch.cat([a, b]),
        torch.cat([cand, torch.minimum(cand * search_reads(deg[b]), deg[b].double())]),
        "amax")
    n_bytes = (K8_PAIRS * (8 + 16) + 8 * torch.unique(torch.cat([s_l, d_l])).numel()
               + 4 * float(need.sum()) + 8 * min(float(inter(want).sum()), n))
    del got, want, need
    return (err, time_ms(lambda: edge_metrics(tg, src, dst), 20),
            time_ms(lambda: edge_metrics_plain(tg, src, dst), 2), truncated,
            bound(n_bytes, 0))


def edge_metrics_checks(graph, tg):
    """K8 on the slice graph and on it plus hubs. Returns its kernels entry
    (with the hub graph's numbers beside)."""
    err, ms, plain_ms, _, k8_bound = edge_metrics_check(graph, tg, 0)
    hg = hub_graph(graph)
    htg = hg.device(tg.device)
    hub_err, hub_ms, hub_plain_ms, truncated, hub_bound = edge_metrics_check(hg, htg, 4096)
    if truncated == 0:
        raise AssertionError("no K8 pair of the hub graph reached the cap")
    entry = dict(
        source="embiggen_tpu_torch/csrc/edge_metrics.cu",
        replaces="embiggen_tpu/ops/edge_metrics.py:34",
        max_abs_err=max(err, hub_err), ms=ms, plain_ms=plain_ms,
        library_ms=None, **k8_bound, hub_bound_ms=hub_bound["bound_ms"],
        hub_graph_arcs=hg.number_of_directed_edges, hub_ms=hub_ms,
        hub_plain_ms=hub_plain_ms, hub_pairs_truncated=truncated,
    )
    del htg
    torch.cuda.empty_cache()
    return entry


def gcn_injected_steps(dev):
    """Three Adam steps of a small GCN on injected batches, on `dev` and
    on the CPU from the same initial parameters. Returns the largest
    parameter difference."""
    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.models.gcn import GCNEdgePrediction, TrainLoop
    from embiggen_tpu_torch.models.gcn.core import param_leaves

    small = erdos_renyi(300, 1500, seed=5)
    rng = np.random.default_rng(26)
    feats = rng.standard_normal((300, 16), dtype=np.float32)
    batches = [(rng.integers(0, 300, 512, dtype=np.int32),
                rng.integers(0, 300, 512, dtype=np.int32),
                (rng.random(512) < 0.5).astype(np.float32)) for _ in range(3)]
    out = {}
    for d in (dev, "cpu"):
        model = GCNEdgePrediction(units=[16, 16], tower_units=[8], head_units=[8],
                                  dropout_rate=0.0, random_state=0, device=d)
        model._n_outputs = 1
        params, kernels = model._build_common(small, small, [feats],
                                              torch.Generator().manual_seed(0))
        tg = small.device(d, with_sources=True)
        feed = iter(batches)
        TrainLoop(epochs=3, learning_rate=0.01, steps_per_epoch=1,
                  early_stopping_patience=10**6).run(
            params, lambda p: model._loss(
                p, kernels, tg, tuple(torch.from_numpy(a).to(d) for a in next(feed)),
                None, None))
        out[str(d)] = param_leaves(params)
    return max(check_close(f"GCN step parameter {i}", a.detach().cpu(), b.detach(), 1e-4, 1e-5)
               for i, (a, b) in enumerate(zip(out[str(dev)], out["cpu"])))


def quality_on_card(card, dev):
    """The gate fixture on `dev`. The reference's Perceptron gate through
    `edge_prediction_evaluation` (its test row, and the launch counts of
    that call); then on the same connected holdout the GCN with each seed
    of GATE_SEEDS (test AUROC and AUPRC per seed). Raises unless the
    Perceptron's test AUPRC and AUROC reach 0.90 and its AUPRC is within
    0.03 of the reference's, and unless the GCN's mean test AUPRC reaches
    the reference's less 0.03, and 0.80."""
    from embiggen_tpu_torch.graph import connected_holdout, random_geometric
    from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
    from embiggen_tpu_torch.models.embedders import SkipGram
    from embiggen_tpu_torch.models.gcn import GCNEdgePrediction
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.pipelines import edge_prediction_evaluation

    rgg = random_geometric(1000, radius=0.07, seed=42)
    _build.reset_launch_counts()
    rows = edge_prediction_evaluation(
        holdouts_number=1,
        models=PerceptronEdgePrediction(device=dev, **GATE_PERCEPTRON),
        graphs=rgg, node_features=SkipGram(device=dev, **GATE_SKIPGRAM),
        evaluation_schema="Connected Monte Carlo", random_state=3)
    launches = _build.launch_counts()
    perceptron = next(r for r in rows if r["evaluation_mode"] == "test")
    if not (perceptron["auprc"] >= 0.90 and perceptron["auroc"] >= 0.90
            and abs(perceptron["auprc"] - GATE_REFERENCE_PERCEPTRON_AUPRC) <= 0.03):
        raise AssertionError(f"Perceptron gate on {card}: test AUPRC "
                             f"{perceptron['auprc']}, AUROC {perceptron['auroc']}")
    train, test = connected_holdout(rgg, random_state=3)
    gcn = []
    for seed in GATE_SEEDS:
        model = GCNEdgePrediction(device=dev, **GATE_GCN)
        model.set_random_state(seed)
        model.fit(train, support=train)
        got = {r["evaluation_mode"]: r for r in
               model._evaluate(rgg, train, test, support=train, random_state=3)}
        gcn.append((got["test"]["auroc"], got["test"]["auprc"]))
    mean = float(np.mean([p for _, p in gcn]))
    floor = max(0.80, GATE_REFERENCE_GCN_AUPRC - 0.03)
    if not mean >= floor:
        raise AssertionError(f"GCN mean test AUPRC {mean} on {card} is below "
                             f"{floor}: {gcn}")
    return perceptron, launches, gcn


def device_ms(calls, reps: int = 20) -> dict:
    """{counter: device milliseconds per launch} of each wrapper in `calls`
    ({counter: fn}, each fn one launch of that wrapper's kernel; one fn may
    stand for several counters), from the CUDA event pair around each launch
    (`_build.timed_launches`) over `reps` calls of each distinct fn after a
    warm-up, queued behind a sleep kernel so that each pair times the kernel
    alone, where `time_ms` also times the wrapper's host work."""
    from embiggen_tpu_torch.ops import _build

    fns = list({id(fn): fn for fn in calls.values()}.values())
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    with _build.timed_launches() as pairs:
        for fn in fns:
            for _ in range(reps):
                fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if enqueue_s >= SLEEP_CYCLES / 2e9:
        raise RuntimeError(f"enqueueing the calls took {enqueue_s} s, longer than the sleep")
    missing = [k for k in calls if not pairs.get(k)]
    if missing:
        raise AssertionError(f"no launch of {missing} in {reps} calls")
    return {k: sum(s.elapsed_time(e) for s, e in pairs[k]) / len(pairs[k]) for k in calls}


def laws_module(name):
    """A module of exact sampler laws under `tests/` (shared with the tests,
    which import it the same way): `pq_laws`, the step laws of the p/q
    samplers in numpy; `batch_laws`, the laws of K14's batches in torch;
    `walk_batch_laws`, the laws of the first-order walk batch in torch."""
    import importlib

    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    return importlib.import_module(name)


def pq_sampler_checks(erdos_renyi, dev):
    """K9 and K10 on small graphs (weighted and not): whole walks, every
    move against its exact step law given the walk so far
    (`tests/pq_laws.py`, pooled chi-square): K9 over whole rows (cap 100),
    over rows subsampled at cap 8, and on a 60-node graph (degrees up to 36)
    at cap 34, whose rows span two of K9's 32-slot chunks; K10 at weight
    ratios 4 (8 tries) and 16 (16 tries). Returns ({test: p}, {kernel: max
    |empirical - exact| step probability})."""
    from embiggen_tpu_torch.ops.walks import ell_walks, rejection_walks

    laws = laws_module("pq_laws")
    p, err = {}, {"ell_walks": 0.0, "rejection_walks": 0.0}
    starts = (torch.arange(40000, device=dev) % 200).int()
    for weighted in (False, True):
        for n, m, cap in ((200, 800, ELL_CAP), (200, 800, 8), (60, 1100, 34)):
            g = erdos_renyi(n, m, seed=7, weighted=weighted)
            tg = g.device(dev, ell_cap=cap, ell_seed=1)
            w = ell_walks(tg, (torch.arange(200000 if n == 60 else 40000, device=dev) % n).int(),
                          16, *PQ.values(), cap, torch.Generator().manual_seed(cap))
            ell = (tg.ell_cols.cpu().numpy(),
                   None if tg.ell_w is None else tg.ell_w.cpu().numpy(), min(cap, tg.ell_cap))
            p[f"K9 {n} nodes cap {cap} weighted={weighted}"], e = laws.walks_chi2_p(
                w.cpu().numpy(), laws.Laws(g.row_ptr, g.col_idx, g.weights, *PQ.values(),
                                           ell=ell), n)
            err["ell_walks"] = max(err["ell_walks"], e)
        g = erdos_renyi(200, 800, seed=7, weighted=weighted)
        tg = g.device(dev, with_alias=weighted)
        for rw, ew in ((2.0, 0.5), (0.25, 4.0)):
            t = laws.n_tries_for(rw, ew)
            w = rejection_walks(tg, starts, 16, rw, ew, t, torch.Generator().manual_seed(t))
            p[f"K10 {t} tries weighted={weighted}"], e = laws.walks_chi2_p(
                w.cpu().numpy(), laws.Laws(g.row_ptr, g.col_idx, g.weights, rw, ew, n_tries=t),
                200)
            err["rejection_walks"] = max(err["rejection_walks"], e)
    # K9's edges: rows that end exactly at, and one slot past, its first
    # round of 32-slot loads (cap 40); hub rows over the cap of 100, in
    # random order, as the prev row of the move after a hub. Half the
    # walkers start at the two long rows.
    from embiggen_tpu_torch.graph import Graph

    for weighted in (False, True):
        for name, (src, dst, n), cap in (("rows of 32 and 33 slots", laws.rows_of_32_and_33(), 40),
                                         ("over-cap prev rows", laws.two_hubs(), 100)):
            g = Graph.from_edge_arrays(src, dst, n_nodes=n, directed=False)
            if weighted:
                g = dataclasses.replace(g, weights=laws.arc_weights(g.number_of_directed_edges))
            tg = g.device(dev, ell_cap=cap, ell_seed=2)
            starts = (torch.arange(200000, device=dev) % n).int()
            starts[::2] = (torch.arange(100000, device=dev) % 2).int()
            w = ell_walks(tg, starts, 8, *PQ.values(), cap, torch.Generator().manual_seed(cap))
            ell = (tg.ell_cols.cpu().numpy(),
                   None if tg.ell_w is None else tg.ell_w.cpu().numpy(), min(cap, tg.ell_cap))
            p[f"K9 {name} weighted={weighted}"], e = laws.walks_chi2_p(
                w.cpu().numpy(), laws.Laws(g.row_ptr, g.col_idx, g.weights, *PQ.values(),
                                           ell=ell), n)
            err["ell_walks"] = max(err["ell_walks"], e)
    failed = {k: v for k, v in p.items() if v < P_MIN}
    if failed:
        raise AssertionError(f"p/q sampler tests failed (p < {P_MIN}): {failed}")
    return p, err


def return_counts(walks):
    """Per p/q walk position t (2..L-1): the walks that returned there
    (walks[:, t] == walks[:, t - 2])."""
    return (walks[:, 2:] == walks[:, :-2]).sum(0).double().cpu().numpy()


def returns_p(walks_a, walks_b) -> float:
    """Chi-square p-value that two sets of as many walks return at the same
    rate at every position: the sum over positions of each 2x2 table's
    statistic (returned or not, by set), one df each."""
    from scipy.stats import chi2

    n = walks_a.shape[0]
    a, b = return_counts(walks_a), return_counts(walks_b)
    ok = (a + b > 0) & (a + b < 2 * n)
    a, b = a[ok], b[ok]
    stat = (2 * n * (a - b) ** 2 / ((a + b) * (2 * n - a - b))).sum()
    return float(chi2.sf(stat, ok.sum()))


def type_change_counts(walks, node_type_of):
    """Per walk position t (1..L-1): the walks whose node type changed there
    (node_type_of[walks[:, t]] != node_type_of[walks[:, t - 1]])."""
    t = node_type_of[walks.long()]
    return (t[:, 1:] != t[:, :-1]).sum(0).double().cpu().numpy()


def type_changes_p(walks_a, walks_b, node_type_of) -> float:
    """Chi-square p-value that two sets of as many walks change node type at
    the same rate at every position (one 2x2 table per position, one df
    each)."""
    from scipy.stats import chi2

    n = walks_a.shape[0]
    a, b = (type_change_counts(w, node_type_of) for w in (walks_a, walks_b))
    ok = (a + b > 0) & (a + b < 2 * n)
    a, b = a[ok], b[ok]
    stat = (2 * n * (a - b) ** 2 / ((a + b) * (2 * n - a - b))).sum()
    return float(chi2.sf(stat, ok.sum()))


def slot_counts(tg, keys, walks, chunk=1 << 20):
    """Histogram of the row slot every p/q move picked that left its node:
    the next node's slot in curr's ELL row when `tg` has one, else its
    offset in curr's CSR row (`keys`: the arcs' src * N + dst, sorted)."""
    curr = walks[:, 1:-1].reshape(-1).long()
    nxt = walks[:, 2:].reshape(-1).long()
    moved = curr != nxt
    curr, nxt = curr[moved], nxt[moved]
    if tg.ell_cols is not None:
        width = tg.ell_cols.shape[1]
        slots = torch.cat([(tg.ell_cols[curr[s:s + chunk]] == nxt[s:s + chunk, None])
                           .int().argmax(1) for s in range(0, curr.numel(), chunk)])
    else:
        width = int(tg.degrees.max())
        pos = torch.searchsorted(keys, curr * tg.n_nodes + nxt)
        slots = pos - tg.row_ptr.long()[curr]
    return torch.bincount(slots, minlength=width).double().cpu().numpy()


def slice_pq_checks(graph, hub, dev):
    """K9 and K10 on the slice graph at the slice shapes, and K9 on `hub`
    (the slice graph plus N_HUBS hubs, whose rows exceed the cap; half the
    walkers start at a hub): every move an arc; against the plain versions'
    walks from the same starts (two-sample chi-square): the first p/q step
    (walk position 2) and the last, binned by node degree and by blocks of
    ID_BLOCK ids; the returns at each position; and the row slots the p/q
    moves picked (a wrong weight, class or CDF carry across K9's 32-slot
    chunks moves these where node bins barely change). Returns the p-values
    by test."""
    from embiggen_tpu_torch.ops.negatives import nce_negatives
    from embiggen_tpu_torch.ops.walks import (
        ell_walks, ell_walks_plain, rejection_walks, rejection_walks_plain,
    )

    p = {}
    # The last argument: K9's cap, K10's tries.
    for name, g, kernel, plain, last in (
        ("K9", graph, ell_walks, ell_walks_plain, ELL_CAP),
        ("K9 hubs", hub, ell_walks, ell_walks_plain, ELL_CAP),
        ("K10", graph, rejection_walks, rejection_walks_plain, 8),
    ):
        tg = g.device(dev, ell_cap=ELL_CAP if kernel is ell_walks else None)
        starts = nce_negatives(tg, torch.Generator().manual_seed(31), (BATCH,),
                               scale_free=False)
        if name == "K9 hubs":
            hubs = torch.arange(g.number_of_nodes - N_HUBS, g.number_of_nodes, device=dev)
            starts[::2] = hubs[torch.arange(BATCH // 2, device=dev) % N_HUBS].int()
        w = kernel(tg, starts, WALK, *PQ.values(), last, torch.Generator().manual_seed(32))
        w_plain = plain(tg, starts, WALK, *PQ.values(), last,
                        torch.Generator(device=dev).manual_seed(33))
        if not (torch.equal(w[:, 0], starts) and torch.equal(w_plain[:, 0], starts)):
            raise AssertionError(f"{name}: walks[:, 0] differs from the starts")
        keys = arc_keys(g, dev)
        for walks in (w, w_plain):
            arc_positions(g, walks, keys)
        for pos in (2, WALK - 1):
            binned_tests(p, f"{name} position {pos} vs plain", node_counts(tg, w[:, pos]),
                         node_counts(tg, w_plain[:, pos]), False)
        p[f"{name} returns by position vs plain"] = returns_p(w, w_plain)
        p[f"{name} picked slots vs plain"] = two_sample_p(
            slot_counts(tg, keys, w), slot_counts(tg, keys, w_plain))
        del tg, w, w_plain, keys
        torch.cuda.empty_cache()
    failed = {k: v for k, v in p.items() if v < P_MIN}
    if failed:
        raise AssertionError(f"p/q sampler tests at the slice shapes failed "
                             f"(p < {P_MIN}): {failed}")
    return p


def pq_walk_entries(graph, errs, dev):
    """K9 and K10 timed at the slice shapes (2.0 / 0.5, cap 100; K10 with 8
    tries), with their bounds from this run's walks."""
    from embiggen_tpu_torch.ops.negatives import nce_negatives
    from embiggen_tpu_torch.ops.walks import (
        ell_walks, ell_walks_plain, rejection_walks, rejection_walks_plain,
    )

    entries = {}
    gen, cuda_gen = torch.Generator().manual_seed(34), torch.Generator(device=dev).manual_seed(35)
    deg_all = torch.from_numpy(graph.degrees).to(dev).long()
    for name, kernel, plain, last, source_line in (
        ("ell_walks", ell_walks, ell_walks_plain, ELL_CAP, "embiggen_tpu/ops/walks.py:245"),
        ("rejection_walks", rejection_walks, rejection_walks_plain, 8,
         "embiggen_tpu/ops/walks.py:145"),
    ):
        tg = graph.device(dev, ell_cap=ELL_CAP if name == "ell_walks" else None)
        starts = nce_negatives(tg, gen, (BATCH,), scale_free=False)
        w = kernel(tg, starts, WALK, *PQ.values(), last, gen)
        prev, curr = w[:, :-2].reshape(-1).long(), w[:, 1:-1].reshape(-1).long()
        # Every row a step reads is the row of a node the walks stand on
        # before their last position (a step's prev row is the row the
        # step before read as curr's), so the function must read each such
        # row once: at most the whole table.
        rows = torch.unique(w[:, :-1]).long()
        io = 4 * BATCH + 4 * BATCH * WALK   # starts in, walks out
        if name == "ell_walks":
            # Each distinct row's real slots (ids, and weights when
            # weighted); membership needs at least a search of prev's row
            # per candidate (integer compares, counted at the fp32 rate).
            cap_eff = min(ELL_CAP, tg.ell_cap)
            deg_ell = deg_all.clamp(max=tg.ell_cap).double()
            per_slot = 4 if tg.ell_w is None else 8
            b = bound(io + per_slot * float(deg_ell[rows].sum()),
                      float((deg_ell[curr].clamp(max=cap_eff)
                             * search_reads(deg_ell[prev])).sum()))
        else:
            # Each distinct row's two row_ptr entries and its arcs (the T
            # proposals and prev's searches read within them), plus its
            # alias table when weighted.
            per_arc = 4 if tg.alias_prob is None else 12
            b = bound(io + 8 * rows.numel() + per_arc * float(deg_all[rows].sum()), 0)
        entries[name] = dict(
            source="embiggen_tpu_torch/csrc/walks2.cu", replaces=source_line,
            max_abs_err=errs[name],
            ms=time_ms(lambda: kernel(tg, starts, WALK, *PQ.values(), last, gen), 10),
            plain_ms=time_ms(lambda: plain(tg, starts, WALK, *PQ.values(), last, cuda_gen), 2),
            library_ms=None, **b)
        entries[name]["walk_steps_per_s"] = BATCH * (WALK - 1) / (entries[name]["ms"] / 1e3)
        if name == "ell_walks":
            # The floor of K9's dependent chain: 256 walkers, too few to
            # contend for the card, each still takes its WALK - 1 steps one
            # after another (each step's row load waits on the step before).
            few = starts[:256].contiguous()
            entries[name]["chain_ms"] = time_ms(
                lambda: kernel(tg, few, WALK, *PQ.values(), last, gen), 10)
        del tg, w, prev, curr
        torch.cuda.empty_cache()
    return entries


def cbow_checks(dev):
    """K11 and K4's combine on CBOW's tables against their plain versions at
    K11_SHAPES, with and without centre weights, on seeded random tables and
    walks (rows large enough that the +-6 clip binds for some logits):
    K11's counts exactly, its loss and sums to K3_SUMS_TOL, the tables after
    the combine to K3_UPDATE_ATOL. Returns (its kernels entry, timed at the
    flagship shapes; {shape: (sums err, combined tables err)})."""
    from embiggen_tpu_torch.ops.cbow import cbow_update, cbow_update_plain
    from embiggen_tpu_torch.ops.scatter import (
        SkipGramSums, skipgram_mean_combine, skipgram_mean_combine_plain,
    )

    entry, errs = None, {}
    for name, n, d, length, w, k, b in K11_SHAPES:
        rng = np.random.default_rng(1)
        tables = [torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
                  for _ in range(2)]
        tables.append(torch.from_numpy(3.0 * rng.standard_normal(n, dtype=np.float32)).to(dev))
        walks = torch.from_numpy(rng.integers(0, n, (b, length), dtype=np.int32)).to(dev)
        negs = torch.from_numpy(rng.integers(0, n, (b, k), dtype=np.int32)).to(dev)
        center_w = torch.from_numpy(rng.uniform(0, 2, (b, length)).astype(np.float32)).to(dev)
        args = (*tables, walks, negs, w, 6.0)
        sums_err = combine_err = 0.0
        for cw in (None, center_w):
            sums, want_sums = SkipGramSums.zeros(n, d, dev), SkipGramSums.zeros(n, d, dev)
            loss = cbow_update(*args, sums, cw)
            want_loss = cbow_update_plain(*args, want_sums, cw)
            check_close(f"K11 {name} loss", loss, want_loss, **K3_SUMS_TOL)
            for field in ("counts_w", "counts_c"):
                check_close(f"K11 {name} {field}", getattr(sums, field),
                            getattr(want_sums, field), 0.0, 0.0)
            for field in ("sums_w", "sums_c", "sums_b"):
                sums_err = max(sums_err, check_close(
                    f"K11 {name} {field}", getattr(sums, field),
                    getattr(want_sums, field), **K3_SUMS_TOL))
            got_t = [t.clone() for t in tables]
            want_t = [t.clone() for t in tables]
            skipgram_mean_combine(*got_t, sums, 0.025)
            skipgram_mean_combine_plain(*want_t, want_sums, 0.025)
            for i, (x, y) in enumerate(zip(got_t, want_t)):
                combine_err = max(combine_err, check_close(
                    f"K4 combine after K11 {name} table {i}", x, y, 0.0, K3_UPDATE_ATOL))
            del got_t, want_t, want_sums, sums
        errs[name] = (sums_err, combine_err)
        if name != "flagship":
            continue
        # Rows each table must read (and the sums write), as K3's bound
        # counts them: the walk's nodes (input rows), the centres' and
        # negatives' nodes (output rows and biases). Operations: the window
        # sums, C (K + 1) dot products, and their gradients.
        c = length - 2 * w
        u_w = int(torch.unique(walks).numel())
        u_c = int(torch.unique(torch.cat([walks[:, w:length - w].reshape(-1),
                                          negs.reshape(-1)])).numel())
        flops = b * d * (c * (2 * w + 4 * (k + 1) + 2 * k + 1) + 2 * w * length)
        sums = SkipGramSums.zeros(n, d, dev)
        entry = dict(
            source="embiggen_tpu_torch/csrc/cbow.cu",
            replaces="embiggen_tpu/models/embedders/walk_based.py:1065",
            max_abs_err=sums_err,
            ms=time_ms(lambda: cbow_update(*args, sums), 10),
            plain_ms=time_ms(lambda: cbow_update_plain(*args, sums), 3),
            library_ms=None,
            **bound(4 * ((u_w + u_c) * d + u_c + b * (length + k))
                    + 8 * ((u_w + u_c) * d + 3 * u_c + u_w) + 4 * b, flops))
        del sums
    return entry, errs


def term_sums(walks, negs, grads, n, d):
    """The plain version's gradient terms `grads` ((g_in, g_out, g_ob),
    (g_neg, g_nb)) scattered as K11 scatters them (walk rows, then
    negatives), in float64: ({field: sum of the terms}, {field: sum of
    their absolute values})."""
    (g_in, g_out, g_ob), (g_neg, g_nb) = grads
    flat, negs_flat = walks.reshape(-1).long(), negs.reshape(-1).long()
    parts = {"sums_w": ((flat, g_in.reshape(-1, d)),),
             "sums_c": ((flat, g_out.reshape(-1, d)), (negs_flat, g_neg.reshape(-1, d))),
             "sums_b": ((flat, g_ob.reshape(-1)), (negs_flat, g_nb.reshape(-1)))}
    exact, absolute = {}, {}
    for field, segs in parts.items():
        total = torch.zeros((n, d) if field != "sums_b" else (n,), dtype=torch.float64,
                            device=walks.device)
        size = total.clone()
        for idx, g in segs:
            total.index_add_(0, idx, g.double())
            size.index_add_(0, idx, g.double().abs())
        exact[field], absolute[field] = total, size
    return exact, absolute


def cbow_edge_checks(dev):
    """K11 at its edges against its plain version, with and without centre
    weights: fewer walks than the persistent grid's blocks, and more, not a
    multiple of them; walks that repeat one node id at every position;
    window 1, one centre a walk (L = 2w + 1), one negative, and all three.
    The loss to K3_SUMS_TOL, the counts exactly, and the sums against
    float64 sums of the plain version's gradient terms, within K3_SUMS_TOL
    of the sum of the terms' absolute values: the sums are taken in another
    order, and at 3001 walks over 300 nodes a node's sums gather hundreds of
    terms of either sign whose float32 partial sums round, in both versions,
    by more than 1e-4 of a total that cancels. Returns the largest sums
    error by case."""
    from embiggen_tpu_torch.ops.cbow import cbow_grads_plain, cbow_update, cbow_update_plain
    from embiggen_tpu_torch.ops.scatter import SkipGramSums

    errs = {}
    # (case, N, D, L, w, K, B)
    cases = (("B 5", 300, 48, 20, 4, 7, 5), ("B 3001", 300, 48, 20, 4, 7, 3001),
             ("repeated node", 300, 48, 20, 4, 7, 64), ("window 1", 300, 32, 12, 1, 5, 64),
             ("one centre", 300, 30, 7, 3, 5, 64), ("K 1", 300, 32, 12, 3, 1, 64),
             ("w 1, C 1, K 1", 300, 30, 3, 1, 1, 64))
    for name, n, d, length, w, k, b in cases:
        rng = np.random.default_rng(b + length)
        tables = [torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
                  for _ in range(2)]
        tables.append(torch.from_numpy(3.0 * rng.standard_normal(n, dtype=np.float32)).to(dev))
        walks = torch.from_numpy(rng.integers(0, n, (b, length), dtype=np.int32)).to(dev)
        if name == "repeated node":
            walks = (torch.arange(b, device=dev, dtype=torch.int32) % 7)[:, None].expand(
                b, length).contiguous()
        negs = torch.from_numpy(rng.integers(0, n, (b, k), dtype=np.int32)).to(dev)
        center_w = torch.from_numpy(rng.uniform(0, 2, (b, length)).astype(np.float32)).to(dev)
        errs[name] = 0.0
        for cw in (None, center_w):
            sums, want_sums = SkipGramSums.zeros(n, d, dev), SkipGramSums.zeros(n, d, dev)
            args = (*tables, walks, negs, w, 6.0)
            check_close(f"K11 {name} loss", cbow_update(*args, sums, cw),
                        cbow_update_plain(*args, want_sums, cw), **K3_SUMS_TOL)
            for field in ("counts_w", "counts_c"):
                check_close(f"K11 {name} {field}", getattr(sums, field),
                            getattr(want_sums, field), 0.0, 0.0)
            exact, absolute = term_sums(walks, negs, cbow_grads_plain(*args, cw)[1:], n, d)
            for field in ("sums_w", "sums_c", "sums_b"):
                err = (getattr(sums, field).double() - exact[field]).abs()
                if bool((err > K3_SUMS_TOL["atol"]
                         + K3_SUMS_TOL["rtol"] * absolute[field]).any()):
                    raise AssertionError(
                        f"K11 {name} {field}: kernel and the plain version's terms differ "
                        f"(max abs err {float(err.max())}, {K3_SUMS_TOL} of the terms' "
                        "absolute sums)")
                errs[name] = max(errs[name], float(err.max()))
    return errs


def cbow_injected_steps(small, dev):
    """Three CBOW steps on injected batches, on the card and on the CPU from
    the same tables. Returns the largest table difference."""
    from embiggen_tpu_torch.models.embedders import CBOW

    kw = dict(embedding_size=32, walk_length=16, window_size=3,
              number_of_negative_samples=5, random_state=0)
    models = {d: CBOW(device=d, **kw) for d in (dev, "cpu")}
    init = models["cpu"]._init_params(small, torch.Generator().manual_seed(0))
    params = {d: {k: v.to(d).clone() for k, v in init.items()} for d in models}
    graphs = {d: small.device(d) for d in models}
    step_rng = np.random.default_rng(5)
    with torch.no_grad():
        for lr in (0.05, 0.04, 0.03):
            batch = (step_rng.integers(0, 300, (256, 16), dtype=np.int32),
                     step_rng.integers(0, 300, (256, 5), dtype=np.int32))
            for d, m in models.items():
                m._step(graphs[d], params[d], torch.Generator(), lr,
                        batch=tuple(torch.from_numpy(x).to(d) for x in batch))
    return max(check_close(f"3 CBOW steps, {k}", params[dev][k].cpu(),
                           params["cpu"][k], 0.0, 1e-5) for k in init)


def embed_run(graph, dev, name, epochs, **kw):
    """`embed_graph` of the model `name` at the S1 widths on `dev`, with
    the counts set to 0 just before and read just after. Returns (model,
    launches, seconds, peak bytes, centres/s per epoch, walk steps/s per
    epoch)."""
    from embiggen_tpu_torch.models import get_model_from_library
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.pipelines import embed_graph

    model = get_model_from_library(name)(
        device=dev, embedding_size=DIM, walk_length=WALK, window_size=WINDOW,
        number_of_negative_samples=NEGS, epochs=epochs, random_state=0,
        early_stopping_patience=10**6, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    result = embed_graph(graph, model)
    seconds = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for i, emb in enumerate(result.node_embeddings):
        if emb.shape != (N_NODES, DIM) or not np.isfinite(emb).all():
            raise AssertionError(f"{name} embedding {i}: shape {emb.shape} or non-finite values")
    if len(model._epoch_losses) != epochs or not np.isfinite(model._epoch_losses).all():
        raise AssertionError(f"{name} epoch losses {model._epoch_losses}")
    steps = max(1, N_NODES // model._run_batch_size)
    walkers = steps * model._run_batch_size
    return (model, launches, seconds, peak,
            [walkers * (WALK - 2 * WINDOW) / s for s in model._epoch_seconds],
            [walkers * (WALK - 1) / s for s in model._epoch_seconds])


def cbow_quality_on_card(card, dev):
    """Node2Vec CBOW over p/q walks on the gate fixture's connected holdout,
    with each embedding seed of GATE_CBOW_SEEDS, feeding a Perceptron on
    Hadamard alone scored by `_evaluate`. Raises unless the mean test AUPRC
    reaches the reference's less 0.03. Returns the per-seed test AUPRCs."""
    from embiggen_tpu_torch.graph import connected_holdout, random_geometric
    from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
    from embiggen_tpu_torch.models.embedders import CBOW

    rgg = random_geometric(1000, radius=0.07, seed=42)
    train, test = connected_holdout(rgg, random_state=3)
    auprc = []
    for seed in GATE_CBOW_SEEDS:
        emb = CBOW(device=dev, random_state=seed, **GATE_CBOW).fit_transform(
            train).node_embeddings[0]
        model = PerceptronEdgePrediction(device=dev, **GATE_CBOW_PERCEPTRON)
        model.fit(train, node_features=emb)
        rows = {r["evaluation_mode"]: r for r in
                model._evaluate(rgg, train, test, random_state=3)}
        auprc.append(rows["test"]["auprc"])
    if not np.mean(auprc) >= GATE_REFERENCE_CBOW_AUPRC - 0.03:
        raise AssertionError(f"CBOW p/q mean test AUPRC {np.mean(auprc)} on {card} is "
                             f"below the reference's {GATE_REFERENCE_CBOW_AUPRC} less 0.03: "
                             f"{auprc}")
    return auprc


def arc_bin_counts(ids, n_arcs):
    """(observed, expected) counts of arc ids in ARC_BINS bins of arc ids,
    for ids uniform over the arcs."""
    edges = np.linspace(0, n_arcs, ARC_BINS + 1).astype(np.int64)
    observed = torch.bincount(
        torch.bucketize(ids, torch.from_numpy(edges[1:-1]).to(ids.device), right=True),
        minlength=ARC_BINS).double().cpu().numpy()
    return observed, np.diff(edges) * (ids.numel() / n_arcs)


def corrupted_nodes(batch):
    """The drawn node of every siamese slot where it differs from the side
    it replaced."""
    src, dst, csrc, cdst = batch[:4]
    return torch.cat([csrc[csrc != src], cdst[cdst != dst]])


def bins_err(observed, expected) -> float:
    """Largest |empirical - exact| share over the degree bins."""
    o, e = observed["degree"], expected["degree"]
    return float(np.abs(o / o.sum() - e / e.sum()).max())


def workspace_batches(draw, n_batches):
    """`n_batches` successive batches of `draw()` (on one K14 workspace, so
    each overwrites the last), each copied out: a tuple of the batches'
    parts concatenated along their slots."""
    parts = [tuple(t.clone() for t in draw()) for _ in range(n_batches)]
    return tuple(torch.cat(ts, dim=-1 if ts[0].ndim == 1 else 0) for ts in zip(*parts))


def k14_checks(graph, tg, hub, dev):
    """K14 against its exact laws (`tests/batch_laws.py`) and its plain
    versions on the slice graph, K14_SLOTS slots drawn as the fits draw
    them: successive batches of S6_BATCH on one workspace (`BatchDraws`: one
    key, a new counter offset a batch). The siamese batch (scale-free, with
    types arange(E) % S6_TYPES): positives uniform over ARC_BINS bins of arc
    ids and their repeats (a batch drawn twice would show there), each
    positive an arc, its type the arc's; the corrupted nodes by node degree
    and by blocks of ID_BLOCK ids against their exact law and the plain
    version's; the coin (the sides replaced). LINE's batch with
    avoid_false_negatives (K = S6_NEGS, scale-free), on the slice graph and
    on `hub` (the slice graph plus N_HUBS hubs, where first draws often are
    arcs of their source): the positives as above, the negatives against
    the law of one unchecked redraw and the plain version's, and every
    first draw that is not an arc of its source kept as drawn (the same
    seed without the check). Returns ({test: p}, {counter: max |empirical -
    exact| degree-bin share}, {test: p of the hub negatives against the law
    without a redraw}), the last a measure of the test's power, not
    checked."""
    from embiggen_tpu_torch.ops.negatives import (
        BatchDraws, line_mini_batch, line_mini_batch_plain, siamese_mini_batch,
        siamese_mini_batch_plain,
    )
    from embiggen_tpu_torch.ops.walks import csr_edge_ids_plain

    laws = laws_module("batch_laws")
    p, err, power = {}, {}, {}
    n_batches = K14_SLOTS // S6_BATCH
    typed = dataclasses.replace(
        tg, edge_types=(torch.arange(tg.n_arcs, device=dev) % S6_TYPES).int())
    gen, ws = torch.Generator().manual_seed(51), BatchDraws.siamese(S6_BATCH, True, dev)
    batch = torch.stack(workspace_batches(
        lambda: siamese_mini_batch(typed, gen, S6_BATCH, True, True, workspace=ws), n_batches))
    plain = siamese_mini_batch_plain(typed, torch.Generator(device=dev).manual_seed(52),
                                     K14_SLOTS, True, True)
    ids = laws.arc_ids(typed, batch[0], batch[1])
    p["K14 siamese positives by arc-id bin"] = exact_p(*arc_bin_counts(ids, tg.n_arcs))
    p["K14 siamese positives repeats"] = repeats_p(ids, tg.n_arcs)
    if not torch.equal(batch[4], typed.edge_types[ids]):
        raise AssertionError("K14 siamese types differ from the arcs' types")
    counts = laws.siamese_counts(typed, batch, True)
    observed, expected = (node_bins(tg, torch.from_numpy(x[:-1]).to(dev))
                          for x in counts["corrupted nodes"])
    binned_tests(p, "K14 siamese corrupted nodes vs exact", observed, expected, True)
    binned_tests(p, "K14 siamese corrupted nodes vs plain", observed,
                 node_counts(tg, corrupted_nodes(plain)), False)
    p["K14 siamese sides replaced"] = exact_p(*counts["sides"])
    err["siamese_mini_batch"] = bins_err(observed, expected)
    del batch, plain, ids, typed, ws
    err["line_mini_batch"] = 0.0
    for name, tgx in (("slice", tg), ("hubs", hub.device(dev, with_sources=True))):
        def draws(avoid):
            gen, ws = (torch.Generator().manual_seed(53),
                       BatchDraws.line(S6_BATCH, S6_NEGS, dev))
            return workspace_batches(lambda: line_mini_batch(
                tgx, gen, S6_BATCH, S6_NEGS, True, avoid, workspace=ws), n_batches)
        src, dst, neg = draws(True)
        _, _, first = draws(False)
        _, _, plain = line_mini_batch_plain(tgx, torch.Generator(device=dev).manual_seed(54),
                                            K14_SLOTS, S6_NEGS, True, True)
        ids = laws.arc_ids(tgx, src, dst)
        p[f"K14 LINE {name} positives by arc-id bin"] = exact_p(*arc_bin_counts(ids, tgx.n_arcs))
        p[f"K14 LINE {name} positives repeats"] = repeats_p(ids, tgx.n_arcs)
        clean = ~csr_edge_ids_plain(tgx.row_ptr, tgx.col_idx, src.repeat_interleave(S6_NEGS),
                                    first.reshape(-1))[1]
        if not torch.equal(neg.reshape(-1)[clean], first.reshape(-1)[clean]):
            raise AssertionError(f"K14 LINE {name}: a first draw that is no arc was redrawn")
        observed = node_counts(tgx, neg)
        expected = node_bins(tgx, laws.line_negative_law(tgx, src, True, True) * neg.numel())
        binned_tests(p, f"K14 LINE {name} negatives vs exact", observed, expected, True)
        binned_tests(p, f"K14 LINE {name} negatives vs plain", observed, node_counts(tgx, plain),
                     False)
        err["line_mini_batch"] = max(err["line_mini_batch"], bins_err(observed, expected))
        if name == "hubs":
            power["redrawn first draws"] = float((~clean).double().mean())
            binned_tests(power, "K14 LINE hubs negatives vs the law without a redraw", observed,
                         node_bins(tgx, laws.draw_law(tgx, True) * neg.numel()), True)
        del src, dst, neg, first, plain, ids, clean, tgx
        torch.cuda.empty_cache()
    failed = {k: v for k, v in p.items() if v < P_MIN}
    if failed:
        raise AssertionError(f"K14 tests failed (p < {P_MIN}): {failed}")
    return p, err, power


def k14_entries(tg, errs, dev):
    """K14 timed at the S6 shapes (S6_BATCH slots, K S6_NEGS, scale-free;
    the siamese batch with types) as the fits call it, on a workspace
    (`BatchDraws`), and fresh (`fresh_ms`), with its bounds: the outputs
    written, and per slot its arc's source, head (and type) and each drawn
    arc's head read once (B << E, so distinct); LINE with
    avoid_false_negatives beside it, whose bound adds each negative's search
    of its source's row and the redraws this run's data needed."""
    from embiggen_tpu_torch.ops.negatives import (
        BatchDraws, line_mini_batch, line_mini_batch_plain, siamese_mini_batch,
        siamese_mini_batch_plain,
    )
    from embiggen_tpu_torch.ops.walks import csr_edge_ids_plain

    gen, cuda_gen = torch.Generator().manual_seed(55), torch.Generator(device=dev).manual_seed(56)
    typed = dataclasses.replace(
        tg, edge_types=(torch.arange(tg.n_arcs, device=dev) % S6_TYPES).int())
    b, k = S6_BATCH, S6_NEGS
    line_ws, siamese_ws = BatchDraws.line(b, k, dev), BatchDraws.siamese(b, True, dev)
    src, _, first = line_mini_batch(tg, torch.Generator().manual_seed(57), b, k, True, False)
    rows = src.repeat_interleave(k)
    redraws = int(csr_edge_ids_plain(tg.row_ptr, tg.col_idx, rows, first.reshape(-1))[1].sum())
    avoid_bytes = (8 * int(torch.unique(src).numel()) + 4 * redraws
                   + 4 * float(search_reads(tg.degrees[rows.long()]).sum()))

    def line():
        return line_mini_batch(tg, gen, b, k, workspace=line_ws)

    def siamese():
        return siamese_mini_batch(typed, gen, b, True, True, workspace=siamese_ws)
    entries = {
        "line_mini_batch": dict(
            source="embiggen_tpu_torch/csrc/batches.cu",
            replaces="embiggen_tpu/models/embedders/line.py:74", max_abs_err=errs["line_mini_batch"],
            ms=time_ms(line, 20), fresh_ms=time_ms(lambda: line_mini_batch(tg, gen, b, k), 20),
            plain_ms=time_ms(lambda: line_mini_batch_plain(tg, cuda_gen, b, k), 20),
            library_ms=None,
            **bound(4 * (2 * b + b * k) + 4 * (2 * b + b * k), 0),
            avoid_ms=time_ms(lambda: line_mini_batch(tg, gen, b, k, True, True,
                                                     workspace=line_ws), 20),
            avoid_plain_ms=time_ms(lambda: line_mini_batch_plain(tg, cuda_gen, b, k, True, True), 5),
            avoid_bound_ms=bound(8 * (2 * b + b * k) + avoid_bytes, 0)["bound_ms"],
        ),
        "siamese_mini_batch": dict(
            source="embiggen_tpu_torch/csrc/batches.cu",
            replaces="embiggen_tpu/ops/negatives.py:131", max_abs_err=errs["siamese_mini_batch"],
            ms=time_ms(siamese, 20),
            fresh_ms=time_ms(lambda: siamese_mini_batch(typed, gen, b, True, True), 20),
            plain_ms=time_ms(lambda: siamese_mini_batch_plain(typed, cuda_gen, b, True, True), 20),
            library_ms=None,
            **bound(4 * 5 * b + 4 * 4 * b, 0),
        ),
    }
    for name, ms in device_ms({"line_mini_batch": line, "siamese_mini_batch": siamese}).items():
        entries[name]["device_ms"] = ms
    return entries


def k4_line_checks(tg, dev):
    """K4 standalone at the S6 shapes: Second-order LINE's two updates on a
    batch that K14 draws (B S6_BATCH, K S6_NEGS) with random gradients: the
    context table from the segments (dst, negatives), the node table from
    src, and a third table from the segments with the context's counts (left
    as passed), against mean_scatter_plain (atol 1e-5: atomics add in no
    fixed order; counts exactly); then three calls on one workspace (the
    context, node and context updates of a step and a half), the workspace
    zero after each. Then its two kernels timed apart on the context update:
    the scatter (each segment's rows added into the workspace) and the
    combine (the touched rows), and the whole wrapper call with and without
    a workspace. Returns its two kernels entries."""
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.ops.negatives import line_mini_batch
    from embiggen_tpu_torch.ops.scatter import MeanScatterSums, mean_scatter, mean_scatter_plain

    rng = np.random.default_rng(41)
    n, d = tg.n_nodes, DIM
    src, dst, neg = line_mini_batch(tg, torch.Generator().manual_seed(42), S6_BATCH, S6_NEGS)
    segs = (dst, neg.reshape(-1))

    def normal(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).to(dev)
    tables = [normal(n, d, scale=0.1) for _ in range(2)]
    gsegs = tuple(normal(s.numel(), d) for s in segs)
    g_src = normal(S6_BATCH, d)
    got, counts = mean_scatter(tables[1].clone(), segs, gsegs, 0.025)
    want, want_counts = mean_scatter_plain(tables[1].clone(), segs, gsegs, 0.025)
    check_close("K4 S6 counts", counts, want_counts, 0.0, 0.0)
    err = check_close("K4 S6 context table", got, want, 0.0, 1e-5)
    got, _ = mean_scatter(tables[0].clone(), src, g_src, 0.025)
    want, _ = mean_scatter_plain(tables[0].clone(), src, g_src, 0.025)
    err = max(err, check_close("K4 S6 node table", got, want, 0.0, 1e-5))
    shared = counts.clone()
    got, _ = mean_scatter(tables[0].clone(), segs, gsegs, 0.025, counts)
    want, _ = mean_scatter_plain(tables[0].clone(), segs, gsegs, 0.025, counts)
    err = max(err, check_close("K4 S6 shared counts", got, want, 0.0, 1e-5))
    check_close("K4 S6 shared counts kept", counts, shared, 0.0, 0.0)
    ws = MeanScatterSums.zeros((n, d), dev)
    got, want = [t.clone() for t in tables], [t.clone() for t in tables]
    for i, (t, ids, g) in enumerate(((1, segs, gsegs), (0, src, g_src), (1, segs, gsegs))):
        _, none = mean_scatter(got[t], ids, g, 0.025, workspace=ws)
        mean_scatter_plain(want[t], ids, g, 0.025)
        err = max(err, check_close(f"K4 S6 workspace call {i}", got[t], want[t], 0.0, 1e-5))
        if none is not None or bool(ws.sums.any()) or bool(ws.counts.any()):
            raise AssertionError(f"K4 S6 workspace call {i}: not zero after the combine")
    del got, want, shared
    idx_all, g_all = torch.cat(segs).long(), torch.cat(gsegs)
    m, u = idx_all.numel(), int(torch.unique(idx_all).numel())
    cnt = ws.counts
    ones = torch.ones(m, device=dev)

    def scatter():
        for seg, g in zip(segs, gsegs):
            _build.launch(None, "ebt_scatter_add_rows", dev, ws.sums.data_ptr(), cnt.data_ptr(),
                          seg.data_ptr(), g.data_ptr(), seg.numel(), d)
    work = tables[1].clone()

    def combine():
        _build.launch(None, "ebt_mean_combine", dev, work.data_ptr(), ws.sums.data_ptr(),
                      cnt.data_ptr(), 1e-6, n, d, 1)

    def scatter_plain():
        cnt.index_add_(0, idx_all, ones)
        ws.sums.index_add_(0, idx_all, g_all)

    def combine_plain():
        work.sub_(1e-6 * (ws.sums / cnt.clamp(min=1.0)[:, None]))
        ws.sums.zero_()
        cnt.zero_()
    # Each timed half after the other, so the workspace is zero between.
    scatter_ms = time_after(combine, scatter, 10)
    scatter_plain_ms = time_after(combine, scatter_plain, 10)
    index_add_ms = time_after(combine_plain, lambda: ws.sums.index_add_(0, idx_all, g_all), 10)
    combine_ms = time_after(scatter, combine, 10)
    combine_plain_ms = time_after(scatter, combine_plain, 10)
    entries = {
        "mean_scatter": dict(
            source="embiggen_tpu_torch/csrc/scatter.cu",
            replaces="embiggen_tpu/models/embedders/walk_based.py:817", max_abs_err=err,
            ms=scatter_ms, plain_ms=scatter_plain_ms,
            # No one call computes the sums and the counts; index_add_ of
            # the sums alone beside it.
            library_ms=None, library=None, scatter_half_ms=index_add_ms,
            # ids and gradients read; touched rows of the sums and counts written
            **bound(4 * m * (d + 1) + 4 * u * (d + 1), m * d),
            wrapper_ms=time_ms(lambda: mean_scatter(work, segs, gsegs, 1e-6, workspace=ws), 10),
            wrapper_fresh_ms=time_ms(lambda: mean_scatter(work, segs, gsegs, 1e-6), 10),
            wrapper_plain_ms=time_ms(
                lambda: mean_scatter_plain(work, segs, gsegs, 1e-6, workspace=ws), 10),
            rows=m, touched_rows=u,
        ),
        "mean_combine": dict(
            source="embiggen_tpu_torch/csrc/scatter.cu",
            replaces="embiggen_tpu/models/embedders/walk_based.py:817", max_abs_err=err,
            ms=combine_ms, plain_ms=combine_plain_ms, library_ms=None,
            # The mean step's bytes: all counts read (to find the touched
            # rows), the touched rows of the table read and written and of
            # the sums read. Zeroing the workspace is the design's own cost,
            # beside the bound.
            **bound(4 * n + 12 * u * d, 3 * u * d),
            workspace_zero_bytes=4 * u * d + 4 * u,
        ),
    }
    del tables, work, ws, g_all, gsegs
    torch.cuda.empty_cache()
    return entries


def minibatch_graph(graph, n_types):
    """`graph` with edge types arange(E) % n_types, as bench.py types it."""
    return dataclasses.replace(graph, edge_types=(
        np.arange(graph.number_of_directed_edges) % n_types).astype(np.int32))


def minibatch_batch(rng, name, n, b=256, k=5):
    """A random injected batch of model `name` over n nodes (3 edge types)."""
    if name.endswith("LINE"):
        return (rng.integers(0, n, b, dtype=np.int32), rng.integers(0, n, b, dtype=np.int32),
                rng.integers(0, n, (b, k), dtype=np.int32))
    return tuple(rng.integers(0, n, b, dtype=np.int32) for _ in range(4)) + (
        (rng.integers(0, 3, b, dtype=np.int32),) if name != "Unstructured" else ())


def minibatch_injected_steps(small, dev):
    """Three steps of each S6 model on injected batches, on the card and on
    the CPU from the same tables. Returns {model: largest table difference}."""
    from embiggen_tpu_torch.models import get_model_from_library

    typed = minibatch_graph(small, 3)
    errs = {}
    for name, *_ in S6_RUNS:
        cls = get_model_from_library(name)
        models = {d: cls(device=d, embedding_size=32, random_state=0) for d in (dev, "cpu")}
        init = models["cpu"]._init_params(typed, torch.Generator().manual_seed(0))
        params = {d: {k: v.to(d).clone() for k, v in init.items()} for d in models}
        graphs = {d: m._prepare_data(typed) for d, m in models.items()}
        rng = np.random.default_rng(7)
        with torch.no_grad():
            for lr in (0.05, 0.04, 0.03):
                sl = minibatch_batch(rng, name, small.number_of_nodes)
                for d, m in models.items():
                    m._run_batch_size = 256
                    # LINE takes (src, dst, neg); the siamese models K14's
                    # block of rows.
                    batch = (tuple(torch.from_numpy(x).to(d) for x in sl)
                             if name.endswith("LINE") else torch.from_numpy(np.stack(sl)).to(d))
                    m._step(graphs[d], params[d], torch.Generator(), lr, batch=(batch, ()))
        errs[name] = max(check_close(f"3 {name} steps, {k}", params[dev][k].cpu(),
                                     params["cpu"][k], 0.0, 1e-5) for k in init)
    return errs


def minibatch_run(graph, dev, name, dim, epochs, **kw):
    """`embed_graph` of the S6 model `name` at width `dim` and batch
    S6_BATCH on `dev`, with the counts set to 0 just before and read just
    after. Returns (model, launches, seconds, peak bytes, samples/s per
    epoch)."""
    from embiggen_tpu_torch.models import get_model_from_library
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.pipelines import embed_graph

    model = get_model_from_library(name)(
        device=dev, embedding_size=dim, epochs=epochs, batch_size=S6_BATCH, random_state=0,
        early_stopping_patience=10**6, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    result = embed_graph(graph, model)
    seconds = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for i, emb in enumerate(result.node_embeddings):
        if emb.shape != (graph.number_of_nodes, dim) or not np.isfinite(emb).all():
            raise AssertionError(f"{name} embedding {i}: shape {emb.shape} or non-finite values")
    if len(model._epoch_losses) != epochs or not np.isfinite(model._epoch_losses).all():
        raise AssertionError(f"{name} epoch losses {model._epoch_losses}")
    samples = model._steps_per_epoch(graph, None, S6_BATCH) * S6_BATCH
    return model, launches, seconds, peak, [samples / s for s in model._epoch_seconds]


def s6_quality_on_card(card, dev):
    """The S6 AUROC gate (`tests/test_torch_line_siamese.py`): First-order
    LINE and Unstructured fitted on the whole gate fixture, scored by dot
    products and negative squared distances of its edges against as many
    negatives. Raises unless each reaches the reference's less 0.03.
    Returns {model: test AUROC}."""
    from embiggen_tpu_torch.graph import random_geometric, sample_negative_graph
    from embiggen_tpu_torch.models.embedders import FirstOrderLINE, Unstructured
    from embiggen_tpu_torch.ops.metrics import binary_auroc

    rgg = random_geometric(1000, radius=0.07, seed=42)
    out = {}
    for cls, kw, dist, want in ((FirstOrderLINE, GATE_LINE1, False, GATE_REFERENCE_LINE1_AUROC),
                                (Unstructured, GATE_UNSTRUCTURED, True,
                                 GATE_REFERENCE_UNSTRUCTURED_AUROC)):
        emb = np.asarray(cls(device=dev, **kw).fit_transform(rgg).node_embeddings[0], float)
        neg = sample_negative_graph(rgg, rgg.number_of_edges, random_state=3 if dist else 0,
                                    device=dev)

        def score(a, b):
            return -((a - b) ** 2).sum(1) if dist else (a * b).sum(1)
        pos_s = score(emb[rgg.sources], emb[rgg.col_idx])
        neg_s = score(emb[neg.sources], emb[neg.col_idx])
        auroc = binary_auroc(np.concatenate([np.ones(len(pos_s)), np.zeros(len(neg_s))]),
                             np.concatenate([pos_s, neg_s]))
        if not auroc >= want - 0.03:
            raise AssertionError(f"{cls.model_name()} edge AUROC {auroc} on {card} is below "
                                 f"the reference's {want} less 0.03")
        out[cls.model_name()] = auroc
    return out


def minibatch_step(model, graph):
    """One steady step of a fitted S6 model at its fit's batch, as a
    closure."""
    tg = model._prepare_data(graph)
    gen = torch.Generator().manual_seed(0)
    params = model._init_params(graph, gen)

    def step():
        with torch.no_grad():
            model._step(tg, params, gen, 0.025)
    return step



# ------------------------------------------------------------------- S7
def walklets_inputs(rng, n, power, sub, b, length, k, dev):
    """Seeded stacked tables [P, n, sub], bias [P, n], walks [b, L] and
    negatives [b, K] on `dev`."""
    def put(a):
        return torch.from_numpy(a).to(dev)
    return (put(0.3 * rng.standard_normal((power, n, sub), dtype=np.float32)),
            put(0.3 * rng.standard_normal((power, n, sub), dtype=np.float32)),
            put(rng.standard_normal((power, n), dtype=np.float32)),
            put(rng.integers(0, n, (b, length), dtype=np.int32)),
            put(rng.integers(0, n, (b, k), dtype=np.int32)))


def walklets_check(name, x, power, mode, dev):
    """K12 and K4's combine over the flat views against their plain
    versions on inputs `x`: counts exactly, loss and sums to K3_SUMS_TOL,
    the tables after the combine to K3_UPDATE_ATOL. Returns (sums err,
    tables err)."""
    from embiggen_tpu_torch.ops.scatter import (
        SkipGramSums, skipgram_mean_combine, skipgram_mean_combine_plain,
    )
    from embiggen_tpu_torch.ops.walklets import walklets_update, walklets_update_plain

    tables, walks, negs = x[:3], x[3], x[4]
    p, n, sub = tables[0].shape
    sums, want = SkipGramSums.zeros(p * n, sub, dev), SkipGramSums.zeros(p * n, sub, dev)
    check_close(f"K12 {name} {mode} loss", walklets_update(*tables, walks, negs, power, sums, mode),
                walklets_update_plain(*tables, walks, negs, power, want, mode), **K3_SUMS_TOL)
    for field in ("counts_w", "counts_c"):
        check_close(f"K12 {name} {mode} {field}", getattr(sums, field), getattr(want, field),
                    0.0, 0.0)
    sums_err = max(check_close(f"K12 {name} {mode} {field}", getattr(sums, field),
                               getattr(want, field), **K3_SUMS_TOL)
                   for field in ("sums_w", "sums_c", "sums_b"))

    def flat(ts):
        return ts[0].view(p * n, sub), ts[1].view(p * n, sub), ts[2].view(p * n)
    got_t, want_t = [t.clone() for t in tables], [t.clone() for t in tables]
    skipgram_mean_combine(*flat(got_t), sums, 0.025)
    skipgram_mean_combine_plain(*flat(want_t), want, 0.025)
    tables_err = max(check_close(f"K4 combine after K12 {name} {mode} table {i}", a, w, 0.0,
                                 K3_UPDATE_ATOL) for i, (a, w) in enumerate(zip(got_t, want_t)))
    return sums_err, tables_err


def walklets_checks(dev):
    """K12 against its plain version in both modes at WALKLETS_SHAPES (the
    S7 shapes first, then its edges) and on walks of one repeated node.
    Returns (its kernels entry, timed at the S7 shapes in SkipGram's mode,
    with CBOW's time beside it; {case: (sums err, tables err)})."""
    from embiggen_tpu_torch.ops.scatter import SkipGramSums
    from embiggen_tpu_torch.ops.walklets import walklets_update, walklets_update_plain

    entry, errs = None, {}
    for name, n, power, sub, b, length, k in WALKLETS_SHAPES:
        rng = np.random.default_rng(power * 100 + sub)
        x = walklets_inputs(rng, n, power, sub, b, length, k, dev)
        cases = [(name, x)]
        if name == "D 12, P 4":
            # 64 walks, as K11's repeated-node case: every pair of a walk
            # adds the same float32 term to one row, so at thousands of
            # walks both versions' sums drift apart by systematic rounding.
            walks = (torch.arange(64, device=dev, dtype=torch.int32) % 7)[:, None].expand(
                64, length).contiguous()
            cases.append(("repeated node", x[:3] + (walks, x[4][:64].contiguous())))
        for case, xs in cases:
            for mode in ("skipgram", "cbow"):
                errs[f"{case} {mode}"] = walklets_check(case, xs, power, mode, dev)
        if name != "S7":
            continue
        tables, walks, negs = x[:3], x[3], x[4]
        sums = SkipGramSums.zeros(power * n, sub, dev)
        ms = {mode: time_ms(lambda mode=mode: walklets_update(
            *tables, walks, negs, power, sums, mode), 10) for mode in ("skipgram", "cbow")}
        plain_ms = time_ms(lambda: walklets_update_plain(
            *tables, walks, negs, power, sums, "skipgram"), 2)
        # Rows each power's tables must read (and the sums write, read and
        # written as they accumulate): the walks' nodes as inputs, the walks'
        # nodes and negatives as targets with their biases. Operations: the
        # 2m (K + 1) logits of each (walk, power) and their gradient rows.
        u_w = int(torch.unique(walks).numel())
        u_c = int(torch.unique(torch.cat([walks.reshape(-1), negs.reshape(-1)])).numel())
        flops = sum(b * 4 * (length - p - 1) * sub * (3 * k + 3) for p in range(power))
        entry = dict(
            source="embiggen_tpu_torch/csrc/walklets.cu",
            replaces="embiggen_tpu/models/embedders/walklets.py:124",
            max_abs_err=max(e for e, _ in errs.values()),
            ms=ms["skipgram"], cbow_ms=ms["cbow"], plain_ms=plain_ms, library_ms=None,
            **bound(power * (4 * ((u_w + u_c) * sub + u_c) + 8 * ((u_w + u_c) * sub + 2 * u_c + u_w))
                    + 4 * b * (length + k + power), flops))
        del x, tables, walks, negs, sums
        torch.cuda.empty_cache()
    return entry, errs


def glove_walks(graph, dev, length, seed):
    """One walk of `length` from every node of `graph` on `dev` (K1)."""
    from embiggen_tpu_torch.ops.walks import first_order_walks

    tg = graph.device(dev, with_alias=graph.has_edge_weights)
    return first_order_walks(tg, torch.arange(graph.number_of_nodes, dtype=torch.int32,
                                              device=dev), length,
                             torch.Generator().manual_seed(seed))


def cooc_check(name, walks, n, strides):
    """K13a against its plain version: keys exactly and ascending, sums
    rtol 1e-6 (float64 sums in another order, compared after the cast).
    Returns (sums err, entries)."""
    from embiggen_tpu_torch.ops.glove import cooccurrences, cooccurrences_plain

    got, want = cooccurrences(walks, n, strides), cooccurrences_plain(walks, n, strides)
    for i, part in enumerate(("centers", "contexts")):
        check_close(f"K13a {name} {part}", got[i], want[i], 0.0, 0.0)
    keys = got[0].long() * n + got[1].long()
    if not bool((keys[1:] > keys[:-1]).all()):
        raise AssertionError(f"K13a {name}: keys not in ascending order")
    return check_close(f"K13a {name} sums", got[2], want[2], 1e-6, 0.0), got[0].numel()


def cooc_split(walks, strides) -> dict:
    """K13a's split: its six launches on their CUDA events (count, scan,
    scatter, sort, scan, write) and the rest of the call (allocations, the
    host read of the output's size) on the wrapper's time, each the mean of
    5 calls."""
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.ops.glove import cooccurrences

    total = time_ms(lambda: cooccurrences(walks, N_NODES, strides), 5)
    with _build.timed_launches() as pairs:
        for _ in range(5):
            cooccurrences(walks, N_NODES, strides)
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) for s, e in pairs["cooccurrences"]]
    split = dict(zip(("count_ms", "scan_ms", "scatter_ms", "sort_ms", "scan2_ms", "write_ms"),
                     (sum(times[i::6]) / 5 for i in range(6))))
    return dict(split, rest_ms=total - sum(split.values()))


def planted_hub_build(graph, dev, strides, errs) -> dict:
    """K13a against its plain version on a skewed build (a walk of 16 from
    each node of the slice graph with N_HUBS planted hubs), whose hubs'
    segments take the hub route; its time beside torch.unique's inverse
    with index_add_ (the same function), and the hubs' share of the
    entries."""
    from embiggen_tpu_torch.ops.glove import cooccurrences

    hg = hub_graph(graph)
    n = hg.number_of_nodes
    walks = glove_walks(hg, dev, GLOVE_WALK, 0)
    errs["planted hubs"], entries = cooc_check("planted hubs", walks, n, strides)
    seg = torch.zeros(n, dtype=torch.int64, device=dev)
    keys, weights = [], []
    for d, w in strides:
        a, b = walks[:, :-d].reshape(-1).long(), walks[:, d:].reshape(-1).long()
        keys += [a * n + b, b * n + a]
        weights.append(torch.full((2 * a.numel(),), w, dtype=torch.float64, device=dev))
        keep = a != b
        seg += torch.bincount(a[keep], minlength=n) + torch.bincount(b[keep], minlength=n)
    keys, weights = torch.cat(keys), torch.cat(weights)
    hubs = seg > 8192

    def unique_sums():
        uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
        torch.zeros(uniq.numel(), dtype=torch.float64, device=dev).index_add_(0, inverse, weights)
    out = dict(hubs_ms=time_ms(lambda: cooccurrences(walks, n, strides), 5),
               hubs_unique_index_add_ms=time_ms(unique_sums, 3), hubs_entries=entries,
               hubs_count=int(hubs.sum()),
               hubs_entry_share=float(seg[hubs].sum()) / float(seg.sum()))
    del walks, keys, weights, seg
    torch.cuda.empty_cache()
    return out


def glove_checks(graph, dev):
    """K13a against its plain version at the S7 GloVe shape (a walk of 16
    from each of the slice graph's nodes, w 2: strides 1 and 2 at weights 1
    and 1/2), on a small weighted graph, on walks that revisit nodes, and
    with a stride at or past the walks' length (no keys); then K13b
    (`k13b_checks`) on the S7 build's entries. Returns ({counter: kernels
    entry}, {case: err})."""
    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.ops.glove import (
        cooccurrences, cooccurrences_plain, glove_entries, glove_strides,
    )

    errs, out = {}, {}
    small = erdos_renyi(20_000, 80_000, seed=3, weighted=True)
    errs["weighted, w 3"], _ = cooc_check("weighted", glove_walks(small, dev, 12, 1),
                                          20_000, glove_strides(3))
    rng = np.random.default_rng(2)
    revisits = rng.integers(0, 500, (3000, 16), dtype=np.int32)
    revisits[:1000, ::2] = revisits[:1000, 1:2]
    revisits[1000:1010] = 7
    revisits = torch.from_numpy(revisits).to(dev)
    errs["revisits, w 5"], _ = cooc_check("revisits", revisits, 500, glove_strides(5))
    errs["stride 16 and 1"], _ = cooc_check("stride 16 and 1", revisits, 500,
                                            ((16, 1.0), (1, 0.5)))
    # A star's walks: the hub (node 0) at every other position, 40,000
    # leaves; its segment far past a block's shared memory, its contexts
    # over three windows.
    star = rng.integers(1, 40_001, (4000, 16), dtype=np.int32)
    star[:2000, ::2] = 0
    star[2000:, 1::2] = 0
    errs["star, w 2"], _ = cooc_check("star", torch.from_numpy(star).to(dev), 40_001,
                                      glove_strides(2))
    if any(t.numel() for t in cooccurrences(revisits, 500, ((16, 1.0), (20, 1.0)))):
        raise AssertionError("K13a: strides at or past the walks' length gave keys")

    walks = glove_walks(graph, dev, GLOVE_WALK, 0)
    strides = glove_strides(GLOVE_WINDOW)
    errs["S7"], entries = cooc_check("S7", walks, N_NODES, strides)
    emitted = torch.cat([torch.cat([walks[:, :-d].reshape(-1).long() * N_NODES
                                    + walks[:, d:].reshape(-1),
                                    walks[:, d:].reshape(-1).long() * N_NODES
                                    + walks[:, :-d].reshape(-1)]) for d, _ in strides])
    weights = torch.cat([torch.full((2 * N_NODES * (GLOVE_WALK - d),), w, dtype=torch.float64,
                                    device=dev) for d, w in strides])

    def unique_sums():
        uniq, inverse = torch.unique(emitted, sorted=True, return_inverse=True)
        torch.zeros(uniq.numel(), dtype=torch.float64, device=dev).index_add_(0, inverse, weights)
    stride1 = ((1, 1.0),)
    out["cooccurrences"] = dict(
        source="embiggen_tpu_torch/csrc/glove.cu",
        replaces="embiggen_tpu/models/embedders/glove.py:95",
        max_abs_err=max(errs.values()),
        ms=time_ms(lambda: cooccurrences(walks, N_NODES, strides), 5),
        plain_ms=time_ms(lambda: cooccurrences_plain(walks, N_NODES, strides), 2),
        # Counts where K13a sums weights 1/d, and keeps the diagonal.
        library_ms=time_ms(lambda: torch.unique(emitted, sorted=True, return_counts=True), 3),
        library="torch.unique(keys, sorted=True, return_counts=True) on the emitted keys",
        # The same function as the 1/d build: unique's inverse, index_add_.
        unique_index_add_ms=time_ms(unique_sums, 3),
        emitted_keys=int(emitted.numel()), entries=entries,
        **cooc_split(walks, strides),
        # The walks read, the entries (two int32 ids, a float32 sum) written.
        **bound(4 * walks.numel() + 12 * entries, 0))
    del emitted, weights
    # Walklets GloVe's build at stride 1, weight 1: there torch.unique's
    # counts are the same function.
    keys1 = torch.cat([walks[:, :-1].reshape(-1).long() * N_NODES + walks[:, 1:].reshape(-1),
                       walks[:, 1:].reshape(-1).long() * N_NODES + walks[:, :-1].reshape(-1)])
    out["cooccurrences"].update(
        stride1_ms=time_ms(lambda: cooccurrences(walks, N_NODES, stride1), 5),
        stride1_library_ms=time_ms(
            lambda: torch.unique(keys1, sorted=True, return_counts=True), 3))
    del keys1
    ci, cj, sums = cooccurrences(walks, N_NODES, strides)
    del walks
    out["cooccurrences"].update(planted_hub_build(graph, dev, strides, errs))
    out["cooccurrences"]["max_abs_err"] = max(errs.values())
    e = glove_entries(ci, cj, sums, 100.0, 0.75)
    del ci, cj, sums
    torch.cuda.empty_cache()
    out.update(k13b_checks(e, rng, errs, dev))
    del e
    torch.cuda.empty_cache()
    return out, errs


def k13b_checks(entries, rng, errs, dev):
    """K13b at the S7 GloVe shape (B GLOVE_BATCH on the S7 build's
    entries): its three launches and its plain version on copies of the same
    tables, each table's change held to the float64 step's
    (`tests/glove_checks.py`: within float32's error bound for the step's
    sums in any order; `errs` takes the kernel's largest share of it) at D
    128, 30 and 5, with one entry B times (its rows take B terms), on
    Walklets GloVe's slices (D 32 of [4, N, 32]) and at an odd storage
    offset. In each case the check must refuse the tables before the step,
    the step with its node or its context side left out, and the step with
    its signs flipped. Then each launch timed at D 128 on a workspace: its
    device time on CUDA events (`device_ms`), its plain version's time, and
    its bound. Returns {counter: kernels entry}."""
    from embiggen_tpu_torch.ops.glove import (
        GloVeStepWorkspace, glove_context_update_plain, glove_gradients_plain,
        glove_node_update_plain, glove_step, glove_step_plain,
    )

    checks = laws_module("glove_checks")
    # At a training rate (0.05) a step moves a row of about 0.1 by about
    # 1e-8, under float32's rounding of the row itself, so no check could
    # tell a step from none. At lr 100 the changes are many times the
    # tolerance (`signal`), in every case.
    b, lr = GLOVE_BATCH, 100.0

    def inputs(d, same_entry=False):
        values = [(0.1 * rng.standard_normal(s, dtype=np.float32))
                  for s in ((N_NODES, d), (N_NODES, d))]
        values += [rng.standard_normal(N_NODES, dtype=np.float32) for _ in range(2)]
        ids = rng.integers(0, entries.n_entries, b, dtype=np.int32)
        if same_entry:
            ids[:] = ids[0]
        return values, torch.from_numpy(ids).to(dev)
    controls, signals = {}, {}
    for name, d, layout, same in (("D 128", DIM, "", False), ("D 30", 30, "", False),
                                  ("D 5", 5, "", False), ("one entry B times", DIM, "", True),
                                  ("walklets slice", DIM // WALKLETS_POWER, "walklets slice",
                                   False), ("odd offset", DIM, "odd offset", False)):
        values, ids = inputs(d, same)
        got, want = (checks.table_copies(values, layout, dev, WALKLETS_POWER) for _ in range(2))
        before = [t.clone() for t in got]
        exact = checks.step_exact(entries, ids, got, lr)
        loss, want_loss = glove_step(entries, ids, *got, lr), glove_step_plain(entries, ids,
                                                                               *want, lr)
        for who, tables, value in (("K13b", got, loss), ("plain", want, want_loss)):
            share = checks.worst_share(tables, exact[0])
            loss_off = abs(float(value) - exact[1][0])
            if not (share <= 1.0 and loss_off <= exact[1][1]):
                raise AssertionError(f"K13b {name}: the {who} step's change is {share} of its "
                                     f"tolerance off the float64 step's, its loss {loss_off} "
                                     f"(tolerance {exact[1][1]})")
        for control, wrong in checks.controls(before, got).items():
            share = checks.worst_share(wrong, exact[0])
            if not share > 1.0:
                raise AssertionError(f"K13b {name}: the check passes the step with {control} "
                                     f"({share} of its tolerance)")
            controls[f"{name}: {control}"] = share
        errs[f"K13b {name}"] = checks.worst_share(got, exact[0])
        errs[f"K13b {name} abs"] = max(float(((t.double() - t0) - x).abs().max())
                                       for t, (t0, x, _) in zip(got, exact[0]))
        signals[name] = checks.signal(exact[0])
        del got, want, before, exact
    torch.cuda.empty_cache()
    values, ids = inputs(DIM)
    tables = [torch.from_numpy(v).to(dev) for v in values]
    ws = GloVeStepWorkspace.empty(b, DIM, dev)

    def step():
        glove_step(entries, ids, *tables, 1e-4, ws)
    i, j, g, rows, _ = glove_gradients_plain(entries, ids, *tables)
    device = device_ms({k: step for k in S7_K13B})
    u_i, u_j = int(torch.unique(i).numel()), int(torch.unique(j).numel())
    n_tables = (u_i + u_j) * (DIM + 1) * 4
    share = max(v for k, v in errs.items() if k.startswith("K13b") and not k.endswith("abs"))
    abs_err = max(v for k, v in errs.items() if k.startswith("K13b") and k.endswith("abs"))
    # How far the nearest wrong result (`checks.controls`) lay past the
    # tolerance, and the median change in tolerances, case by case.
    common = dict(source="embiggen_tpu_torch/csrc/glove.cu", max_abs_err=abs_err,
                  tolerance_share=share, check_lr=lr, control_share_min=min(controls.values()),
                  signal=signals, distinct_centers=u_i, distinct_contexts=u_j)
    out = {
        "glove_gradients": dict(
            common, replaces="embiggen_tpu/models/embedders/glove.py:207",
            ms=device["glove_gradients"],
            plain_ms=time_ms(lambda: glove_gradients_plain(entries, ids, *tables), 20),
            library_ms=None,
            # The whole step, K13b's three launches on CUDA events, against the
            # plain step and the step's bound: ids and drawn entries read, the
            # distinct rows and biases read once and written once.
            step_ms=time_ms(step, 20),
            step_plain_ms=time_ms(lambda: glove_step_plain(entries, ids, *tables, 1e-4), 20),
            step_bound_ms=bound(20 * b + 2 * n_tables, 6 * b * DIM)["bound_ms"],
            # ids and entries read, the distinct rows and biases gathered; i,
            # j, g and the rows g w_i written; the dot product and the scaling.
            **bound(20 * b + n_tables + 4 * b * (DIM + 3), 3 * b * DIM)),
        "glove_node_update": dict(
            common, replaces="embiggen_tpu/models/embedders/minibatch.py:87",
            ms=device["glove_node_update"],
            plain_ms=time_ms(lambda: glove_node_update_plain(*tables, i, j, g, 1e-4), 20),
            library_ms=None,
            # i, j, g read, the distinct context rows read, the distinct
            # center rows and both biases read and written; two products
            # and an add an element.
            **bound(12 * b + 4 * u_j * DIM + 8 * u_i * (DIM + 1) + 8 * u_j, 3 * b * DIM)),
        "glove_context_update": dict(
            common, replaces="embiggen_tpu/models/embedders/minibatch.py:87",
            ms=device["glove_context_update"],
            plain_ms=time_ms(lambda: glove_context_update_plain(tables[1], rows, j, 1e-4), 20),
            library="index_add_(0, j, rows, alpha=-lr)",
            library_ms=time_ms(lambda: tables[1].index_add_(0, j, rows, alpha=-1e-4), 20),
            # j and the rows read, the distinct context rows read and written.
            **bound(4 * b + 4 * b * DIM + 8 * u_j * DIM, 2 * b * DIM)),
    }
    del tables, ws, i, j, g, rows
    return out


def s7_injected_steps(small, dev):
    """Three steps of Walklets SkipGram and CBOW on injected (walks,
    negatives), and of Node2Vec GloVe on injected entry ids over the small
    graph's entries, on the card and on the CPU from the same tables.
    Returns {model: largest table difference}."""
    from embiggen_tpu_torch.models.embedders import GloVe, WalkletsCBOW, WalkletsSkipGram

    errs = {}
    n = small.number_of_nodes
    for cls in (WalkletsSkipGram, WalkletsCBOW):
        kw = dict(embedding_size=32, power=4, walk_length=16, window_size=4,
                  number_of_negative_samples=5, random_state=0)
        models = {d: cls(device=d, **kw) for d in (dev, "cpu")}
        init = models["cpu"]._init_params(small, torch.Generator().manual_seed(0))
        params = {d: {k: v.to(d).clone() for k, v in init.items()} for d in models}
        graphs = {d: small.device(d) for d in models}
        rng = np.random.default_rng(6)
        with torch.no_grad():
            for lr in (0.05, 0.04, 0.03):
                batch = (rng.integers(0, n, (256, 16), dtype=np.int32),
                         rng.integers(0, n, (256, 5), dtype=np.int32))
                for d, m in models.items():
                    m._step(graphs[d], params[d], torch.Generator(), lr,
                            batch=tuple(torch.from_numpy(x).to(d) for x in batch))
        errs[cls.model_name()] = max(check_close(
            f"3 {cls.model_name()} steps, {k}", params[dev][k].cpu(), params["cpu"][k], 0.0,
            1e-5) for k in init)
    models = {d: GloVe(device=d, embedding_size=32, walk_length=16, window_size=2,
                       iterations=1, random_state=0) for d in (dev, "cpu")}
    entries = models["cpu"]._prepare_data(small)
    data = {"cpu": entries, dev: type(entries)(*(t.to(dev) for t in entries))}
    init = models["cpu"]._init_params(small, torch.Generator().manual_seed(0))
    params = {d: {k: v.to(d).clone() for k, v in init.items()} for d in models}
    rng = np.random.default_rng(8)
    with torch.no_grad():
        for lr in (0.5, 0.4, 0.3):
            ids = rng.integers(0, entries.n_entries, 1024, dtype=np.int32)
            for d, m in models.items():
                m._run_batch_size = 1024
                m._step(data[d], params[d], torch.Generator(), lr,
                        batch=((torch.from_numpy(ids).to(d),), data[d]))
    errs["Node2Vec GloVe"] = max(check_close(
        f"3 Node2Vec GloVe steps, {k}", params[dev][k].cpu(), params["cpu"][k], 0.0, 1e-5)
        for k in init)
    return errs


def glove_step_launches(graph, dev):
    """One steady step of Node2Vec GloVe (`_step`, its own draws) and one of
    Walklets GloVe (`_glove_step` on power 0's slices, ids drawn by K2) at
    the S7 settings, each under `cuda_ops`: {model: (the port's launches,
    the ATen operators it ran on the card)}. Raises unless a step launched
    K2 once and each of K13b's launches once, or if it ran an operator whose
    name holds "index" (`index_add_`, `index_select`, `index`, `index_put_`)."""
    from embiggen_tpu_torch.models.embedders import GloVe, WalkletsGloVe
    from embiggen_tpu_torch.ops.glove import (
        GloVeStepWorkspace, cooccurrences, draw_entries, glove_entries,
    )
    from embiggen_tpu_torch.ops.negatives import BatchDraws

    gen = torch.Generator().manual_seed(0)
    glove = GloVe(device=dev, random_state=0, **S7_GLOVE)
    entries = glove._prepare_data(graph)
    glove._run_batch_size = glove._resolve_batch_size(graph, entries)
    params = glove._init_params(graph, gen)
    walklets = WalkletsGloVe(device=dev, random_state=0, **S7_WALKLETS_GLOVE)
    stacked = walklets._init_params(graph, gen)
    state = {"emb": stacked["node_embedding"][0], "ctx": stacked["context_embedding"][0],
             "bw": stacked["context_bias"][0],
             "bc": torch.zeros_like(stacked["context_bias"][0])}
    walks = glove_walks(graph, dev, GLOVE_WALK, 0)
    stride1 = glove_entries(*cooccurrences(walks, N_NODES, [(1, 1.0)]), 100.0, 0.75)
    del walks
    batch = min(S7_WALKLETS_GLOVE["batch_size"], stride1.n_entries)
    ws = GloVeStepWorkspace.empty(batch, DIM // WALKLETS_POWER, dev)
    # The ids at one key and an offset a step, as the Walklets GloVe fit draws them.
    draws = BatchDraws(torch.empty((batch,), dtype=torch.int32, device=dev))
    steps = {"Node2Vec GloVe": lambda: glove._step(entries, params, gen, 0.05),
             "Walklets GloVe": lambda: walklets._glove_step(
                 state, stride1, draw_entries(stride1, batch, gen, draws), 0.05, ws)}
    want = {"nce_negatives": 1, **dict.fromkeys(S7_K13B, 1)}
    out = {}
    with torch.no_grad():
        for name, step in steps.items():
            step()
            torch.cuda.synchronize()
            launched, others = cuda_ops(step)
            if launched != want or any("index" in o.lower() for o in others):
                raise AssertionError(f"a {name} step launched {launched} (expected {want}) "
                                     f"and ran {others}")
            out[name] = (launched, others)
    del params, stacked, state, entries, stride1, ws, draws
    torch.cuda.empty_cache()
    return out


def s7_run(graph, dev, name, epochs, **kw):
    """`embed_graph` of the S7 model `name` on `dev` with the counts set to
    0 just before and read just after. Returns (model, launches, seconds,
    peak bytes)."""
    from embiggen_tpu_torch.models import get_model_from_library
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.pipelines import embed_graph

    model = get_model_from_library(name)(device=dev, epochs=epochs, random_state=0, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    result = embed_graph(graph, model)
    seconds = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for i, emb in enumerate(result.node_embeddings):
        if emb.shape != (N_NODES, DIM) or not np.isfinite(emb).all():
            raise AssertionError(f"{name} embedding {i}: shape {emb.shape} or non-finite values")
    if not (len(model._epoch_losses) >= epochs and np.isfinite(model._epoch_losses).all()):
        raise AssertionError(f"{name} epoch losses {model._epoch_losses}")
    return model, launches, seconds, peak


def s7_quality_on_card(card, dev):
    """The reference's Walklets gate verbatim (`tests/test_quality_gates.py:
    113-142`) through `edge_prediction_evaluation`, and the GloVe gate
    (`tests/test_torch_glove.py`): Node2Vec GloVe at GATE_GLOVE on the gate
    fixture's connected holdout, embedding seeds 0-3, a Perceptron on
    Hadamard alone scored by `_evaluate`. Raises unless the Walklets test
    AUROC reaches 0.85 and the reference's less 0.03, and the GloVe mean
    test AUROC the reference's less 0.03. Returns (Walklets test AUROC,
    GloVe test AUROC per seed)."""
    from embiggen_tpu_torch.graph import connected_holdout, random_geometric
    from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
    from embiggen_tpu_torch.models.embedders import GloVe, WalkletsSkipGram
    from embiggen_tpu_torch.pipelines import edge_prediction_evaluation

    rgg = random_geometric(1000, radius=0.07, seed=42)
    rows = edge_prediction_evaluation(
        holdouts_number=1,
        models=PerceptronEdgePrediction(device=dev, edge_embeddings=["Hadamard"],
                                        number_of_epochs=100, random_state=0),
        graphs=rgg, node_features=WalkletsSkipGram(device=dev, **GATE_WALKLETS),
        evaluation_schema="Connected Monte Carlo", random_state=3)
    walklets = next(r["auroc"] for r in rows if r["evaluation_mode"] == "test")
    if not walklets >= max(GATE_WALKLETS_FLOOR, GATE_REFERENCE_WALKLETS_AUROC - 0.03):
        raise AssertionError(f"Walklets gate on {card}: test AUROC {walklets}")
    train, test = connected_holdout(rgg, random_state=3)
    glove = []
    for seed in GATE_GLOVE_SEEDS:
        emb = GloVe(device=dev, random_state=seed, **GATE_GLOVE).fit_transform(
            train).node_embeddings[0]
        model = PerceptronEdgePrediction(device=dev, **GATE_CBOW_PERCEPTRON)
        model.fit(train, node_features=emb)
        got = {r["evaluation_mode"]: r for r in model._evaluate(rgg, train, test, random_state=3)}
        glove.append(got["test"]["auroc"])
    if not np.mean(glove) >= GATE_REFERENCE_GLOVE_AUROC - 0.03:
        raise AssertionError(f"GloVe mean test AUROC {np.mean(glove)} on {card} is below the "
                             f"reference's {GATE_REFERENCE_GLOVE_AUROC} less 0.03: {glove}")
    return walklets, glove


# ------------------------------------------------------------------- S8
def s8_graphs(dev):
    """Graphs for K15a's edge cases: two components with 10,000 isolated
    nodes, and a directed graph; both weighted."""
    from embiggen_tpu_torch.graph import Graph

    rng = np.random.default_rng(30)
    a = rng.integers(0, 40_000, (2, 200_000))
    b = rng.integers(40_000, 90_000, (2, 250_000))
    components = Graph.from_edge_arrays(
        np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]]), n_nodes=100_000,
        weights=rng.uniform(0.1, 3.0, 450_000).astype(np.float32))
    src, dst = rng.integers(0, 100_000, (2, 500_000))
    directed = Graph.from_edge_arrays(src, dst, n_nodes=100_000, directed=True,
                                      weights=rng.uniform(0.1, 3.0, 500_000).astype(np.float32))
    return {"components": components, "directed": directed}


def degree_anchors(graph, d):
    """SPINE's anchor sets: the d nodes of highest degree, one a set."""
    return [[v] for v in np.argsort(-graph.degrees, kind="stable")[:d]]


def plain_distances(tg, init, depth, weighted):
    from embiggen_tpu_torch.ops.bfs import min_plus_step_plain

    dist = init
    for _ in range(depth):
        dist = min_plus_step_plain(tg, dist, weighted)
    return dist


def exact_err(name, got, want) -> float:
    """0.0 when `got` equals `want` exactly; raises otherwise."""
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: max abs err "
                             f"{float((got.double() - want.double()).abs().max())}, not exact")
    return 0.0


def k15_flag_checks(name, tg, init, weighted) -> int:
    """K15a relaxation by relaxation from `init` until one moves nothing:
    its change flag must be 1 exactly when its output differs from its
    input. Returns the number of relaxations that moved a distance."""
    from embiggen_tpu_torch.ops.bfs import min_plus_step

    dist = init
    for i in range(S8_DEPTH):
        flag = torch.zeros(1, dtype=torch.int32, device=init.device)
        out = min_plus_step(tg, dist, weighted, flag)
        moved = bool((out != dist).any())
        if int(flag) != int(moved):
            raise AssertionError(f"K15a {name} relaxation {i}: flag {int(flag)}, "
                                 f"distances moved: {moved}")
        if not moved:
            return i
        dist = out
    return S8_DEPTH


def k15_checks(graph, weighted, dev):
    """K15a against its plain version, exactly: the early-stopped
    `multi_source_distances` against 32 plain relaxations at D 100 on the
    slice graph and on its weighted twin, with its launches (the first
    unchanged relaxation + 1) and the change flag of each relaxation against
    its output; 8 relaxations at D 1 and D 30 (not a multiple of 4), 32 at D
    30 on s8_graphs' graphs (each also weighted), with the change flags;
    WINE's two K7 hops at unit values exactly. Returns their kernels
    entries, timed at the slice shapes (K15a with the change flag the fit
    passes), and per slice graph the number of relaxations that moved a
    distance."""
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.ops.bfs import (
        anchor_init_from_sets, min_plus_step, min_plus_step_plain, multi_source_distances,
        unit_kernel, window_cooccurrence_counts,
    )
    from embiggen_tpu_torch.ops.spmm import csr_spmm, csr_spmm_plain

    errs, settled = {}, {}
    init = anchor_init_from_sets(N_NODES, degree_anchors(graph, S8_DIM), dev)
    for name, g, w in (("slice", graph, False), ("weighted twin", weighted, True)):
        tg = g.device(dev)
        changes = torch.zeros(S8_DEPTH, dtype=torch.int32, device=dev)
        before = _build.launch_counts()["min_plus_step"]
        got = multi_source_distances(tg, init, S8_DEPTH, w, changes)
        launches = _build.launch_counts()["min_plus_step"] - before
        errs[f"D {S8_DIM} {name}"] = exact_err(f"K15a {name}", got,
                                               plain_distances(tg, init, S8_DEPTH, w))
        moved = torch.nonzero(changes).flatten()
        settled[name] = int(moved[-1]) + 1 if len(moved) else 0
        if launches != min(settled[name] + 1, S8_DEPTH):
            raise AssertionError(f"K15a {name}: {launches} launches for distances that "
                                 f"settle after {settled[name]} relaxations")
        if k15_flag_checks(name, tg, init, w) != settled[name]:
            raise AssertionError(f"K15a {name}: the relaxation-by-relaxation flags disagree "
                                 f"with multi_source_distances' changes {changes.tolist()}")
        del got
    tg = graph.device(dev)
    for d in (1, 30):
        small_init = anchor_init_from_sets(N_NODES, degree_anchors(graph, d), dev)
        errs[f"D {d}"] = exact_err(f"K15a D {d}", multi_source_distances(tg, small_init, 8),
                                   plain_distances(tg, small_init, 8, False))
    for name, g in s8_graphs(dev).items():
        g_init = anchor_init_from_sets(g.number_of_nodes, degree_anchors(g, 30), dev)
        gt = g.device(dev)
        for w in (False, True):
            changes = torch.zeros(S8_DEPTH, dtype=torch.int32, device=dev)
            want_changes = torch.zeros(S8_DEPTH, dtype=torch.int32, device=dev)
            got = multi_source_distances(gt, g_init, S8_DEPTH, w, changes)
            want = g_init
            for i in range(S8_DEPTH):
                want = min_plus_step_plain(gt, want, w, want_changes[i:i + 1])
            errs[f"{name}{' weighted' if w else ''}"] = exact_err(f"K15a {name}", got, want)
            exact_err(f"K15a change flags {name}", changes, want_changes)
    # Timed on the distances after three relaxations, mid-run, with the
    # change flag that multi_source_distances passes.
    dist = multi_source_distances(tg, init, 3)
    out = torch.empty_like(dist)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    wtg = weighted.device(dev)
    e, n, d = tg.n_arcs, N_NODES, S8_DIM
    entries = {"min_plus_step": dict(
        source="embiggen_tpu_torch/csrc/bfs.cu", replaces="embiggen_tpu/ops/bfs.py:25",
        max_abs_err=max(errs.values()),
        ms=time_ms(lambda: min_plus_step(tg, dist, False, flag, out), 20),
        plain_ms=time_ms(lambda: min_plus_step_plain(tg, dist, False), 3),
        weighted_ms=time_ms(lambda: min_plus_step(wtg, dist, True, flag, out), 20),
        library_ms=None,
        # dist in and out, the CSR; an add and a min per gathered float.
        **bound(4 * (2 * n * d + n + 1 + e), 2 * e * d))}
    membership = (init == 0).float()
    k = unit_kernel(tg)
    reach, want = membership, torch.zeros_like(membership)
    for _ in range(S8_WINDOW):
        reach = csr_spmm_plain(k, reach)
        want = want + reach
    window_err = exact_err("K15b window counts",
                           window_cooccurrence_counts(tg, membership, S8_WINDOW), want)
    a = torch.sparse_csr_tensor(k.row_ptr, k.cols, k.vals, size=(n, n))
    entries["window_cooccurrence_counts"] = dict(
        source="embiggen_tpu_torch/csrc/spmm.cu", replaces="embiggen_tpu/ops/bfs.py:68",
        max_abs_err=window_err,
        ms=time_ms(lambda: csr_spmm(k, membership), 20),
        plain_ms=time_ms(lambda: csr_spmm_plain(k, membership), 3),
        library_ms=time_ms(lambda: torch.sparse.mm(a, membership), 20),
        library="torch.sparse.mm (cuSPARSE)",
        # one hop: x in, the sums out, the CSR (unit weights need no values).
        **bound(4 * (2 * n * d + n + 1 + e), 2 * e * d))
    del dist, out, membership, reach, want, a, k, init
    return entries, errs, settled


def launch_event_ms(fn, counter: str, reps: int) -> float:
    """Mean device ms of the `counter` launches in a call of `fn`, each on
    the CUDA event pair around it, after one warm-up."""
    from embiggen_tpu_torch.ops import _build

    fn()
    torch.cuda.synchronize()
    with _build.timed_launches() as events:
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events[counter]) / reps


def singleton_route_bytes(tg, p):
    """Bytes K16a's singleton route must move by the read-once rule at hop 1
    or at hop 2 by the id route: the CSR and the [N, M] registers
    written."""
    return 4 * (tg.n_nodes + 1 + tg.n_arcs) + tg.n_nodes * (1 << p)


def k16_checks(graph, dev):
    """K16a against its plain version exactly on the slice graph at
    precisions 4, 8 and 12 (bits 6): the singletons; HyperSketching's
    three hops by the singleton route (hop 1 and hop 2 from the node ids,
    hop 3 by the hop launch) and by the general route (the hop launch over
    the singletons), both against the plain hops over the plain
    singletons, whole; hop 2 forced onto each route (the id route on the
    slice graph only); then the same on the hub graph. K16b at K16B_PAIRS
    pairs (half arcs, half uniform
    pairs) for H 1-3 at each precision, and its general route at H 6
    (K16B_GENERAL_NODES), within tests/hll_checks.py's tolerance, each
    timed. Returns their kernels entries, timed at HyperSketching's
    defaults, the errors by case, the seconds of the plain hops at each
    precision, the singleton route's numbers by graph and precision, and
    the general route's launches (counts set to 0 just before it)."""
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.ops.hll import (
        HOP_SPLIT, edge_sketch_features, edge_sketch_features_plain, hop2_route,
        hop_merge_plain, khop_sketches, khop_sketches_of_singletons,
        khop_sketches_of_singletons_plain, khop_sketches_plain, singleton_registers,
        singleton_registers_plain,
    )
    from embiggen_tpu_torch.scripts.redesign_times import hop_floor_ms

    checks = laws_module("hll_checks")
    tg = graph.device(dev)
    rng = np.random.default_rng(31)
    arcs = rng.integers(0, graph.number_of_directed_edges, K16B_PAIRS // 2)
    src = torch.from_numpy(np.concatenate([graph.sources[arcs], rng.integers(
        0, N_NODES, K16B_PAIRS // 2)]).astype(np.int32)).to(dev)
    dst = torch.from_numpy(np.concatenate([graph.col_idx[arcs], rng.integers(
        0, N_NODES, K16B_PAIRS // 2)]).astype(np.int32)).to(dev)
    distinct = int(torch.unique(torch.cat([src, dst])).numel())
    errs, entries, plain_s, k16b_ms, routes = {}, {}, {}, {}, {}

    def hold(name, skh, src, dst, p):
        got = edge_sketch_features(skh, src, dst, p)
        want = edge_sketch_features_plain(skh, src, dst, p)
        worst, ties = checks.feature_errors(skh, src, dst, p, got, want)
        if not worst <= 1.0 or ties > checks.MAX_TIE_SHARE * len(src):
            raise AssertionError(f"K16b {name}: error {worst} of its tolerance, "
                                 f"{ties} near ties")
        errs[f"features {name} (share of tolerance; ties {ties})"] = worst
        k16b_ms[name] = time_ms(lambda: edge_sketch_features(skh, src, dst, p), 10)

    def singleton_route(label, g_tg, p, want):
        """The singleton route on `g_tg` against `want` (the plain hops
        over the plain singletons): hop 2 as `hop2_route` picks it, then
        forced onto each route (the id route only where every row's
        neighbours are few); the route picked and each launch's time."""
        forced = ("ids", "hop") if label == "slice" else ("hop",)
        for route in (None,) + forced:
            got = khop_sketches_of_singletons(g_tg, HLL_HOPS, p, HLL_BITS, 42, route)
            errs[f"singleton route {label} p {p} {route or 'picked'}"] = exact_err(
                f"K16a singleton route {label} p {p} hop 2 {route or 'picked'}", got, want)
            del got
        # Launch times in the three hops' layout; "hop" runs hops 2 and 3
        # by the hop launch, so its time is their mean.
        case = dict(route=hop2_route(g_tg, p),
                    hop1_ms=launch_event_ms(lambda: khop_sketches_of_singletons(
                        g_tg, HLL_HOPS, p, HLL_BITS, 42), "sketch_hop1", 10))
        for route in forced:
            case[f"hop2_{route}_ms"] = launch_event_ms(
                lambda: khop_sketches_of_singletons(g_tg, HLL_HOPS, p, HLL_BITS, 42, route),
                "khop_sketches" if route == "hop" else "sketch_hop2", 5) / (
                    HLL_HOPS - 1 if route == "hop" else 1)
        routes[f"{label} p {p}"] = case
        return case

    for p in (HLL_PRECISION, 4, 12):
        base = singleton_registers(N_NODES, p, HLL_BITS, 42, dev)
        errs[f"registers p {p}"] = exact_err(
            f"K16a singletons p {p}", base,
            singleton_registers_plain(N_NODES, p, HLL_BITS, 42, dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = khop_sketches_plain(tg, base, HLL_HOPS)
        torch.cuda.synchronize()
        plain_s[p] = time.perf_counter() - t0
        errs[f"hops p {p}"] = exact_err(f"K16a hops p {p}", khop_sketches(tg, base, HLL_HOPS),
                                        want)
        case = singleton_route("slice", tg, p, want)
        sk = want
        del want
        for h in (1, 2, 3):
            hold(f"p {p} H {h}", sk if h == HLL_HOPS else sk[:, :h].contiguous(), src, dst, p)
        few = sk[:K16B_GENERAL_NODES]
        hold(f"p {p} H 6 (general route)", torch.cat([few, few], 1).contiguous(),
             src % K16B_GENERAL_NODES, dst % K16B_GENERAL_NODES, p)
        del few
        if p == HLL_PRECISION:
            m = 1 << p
            n_feat = HLL_HOPS ** 2 + 2 * HLL_HOPS
            entries["hll_registers"] = dict(
                source="embiggen_tpu_torch/csrc/hll.cu", replaces="embiggen_tpu/ops/hll.py:32",
                max_abs_err=0.0,
                launches_from="khop_sketches over singleton_registers (the general route; "
                              "HyperSketching's fit no longer launches it), phase 21",
                ms=time_ms(lambda: singleton_registers(N_NODES, p, HLL_BITS, 42, dev), 20),
                plain_ms=time_ms(lambda: singleton_registers_plain(
                    N_NODES, p, HLL_BITS, 42, dev), 3),
                library_ms=None,
                **bound(N_NODES * m, 0))   # the registers written
            entries["khop_sketches"] = dict(
                source="embiggen_tpu_torch/csrc/hll.cu", replaces="embiggen_tpu/ops/hll.py:53",
                max_abs_err=0.0,
                ms=time_ms(lambda: khop_sketches(tg, base, 1), 20),
                plain_ms=time_ms(lambda: khop_sketches_plain(tg, base, 1), 3),
                library_ms=None,
                # a hop: registers in and out, the CSR; a byte max per
                # gathered register.
                **bound(2 * N_NODES * m + 4 * (N_NODES + 1 + tg.n_arcs), tg.n_arcs * m),
                floor_ms=hop_floor_ms(tg, m), plan_chunks=tg.row_plan(HOP_SPLIT).n_chunks)
            n_bytes = singleton_route_bytes(tg, p)
            entries["sketch_hop1"] = dict(
                source="embiggen_tpu_torch/csrc/hll.cu", replaces="embiggen_tpu/ops/hll.py:53",
                max_abs_err=0.0, ms=case["hop1_ms"],
                plain_ms=time_ms(lambda: khop_sketches_of_singletons_plain(
                    tg, 1, p, HLL_BITS, 42), 2),
                library_ms=None, **bound(n_bytes, 0))
            entries["edge_sketch_features"] = dict(
                source="embiggen_tpu_torch/csrc/hll.cu", replaces="embiggen_tpu/ops/hll.py:90",
                max_abs_err=None,   # set below, over every precision
                max_err_unit="share of tests/hll_checks.py's tolerance",
                distinct_nodes=distinct,
                ms=k16b_ms[f"p {p} H {HLL_HOPS}"],
                plain_ms=time_ms(lambda: edge_sketch_features_plain(sk, src, dst, p), 3),
                library_ms=None,
                # the registers of each distinct node the pairs name, the
                # ids, the features out; a term of 2^-r per register of each
                # of the 2H + H^2 sets.
                **bound(distinct * HLL_HOPS * m + K16B_PAIRS * (8 + 4 * n_feat),
                        K16B_PAIRS * (2 * HLL_HOPS + HLL_HOPS ** 2) * m))
        if p == 12:
            # Hop 2 by the id route, which `hop2_route` picks at precision
            # 12 on this graph; its plain time is the plain route's two hops
            # less its first.
            if case["route"] != "ids":
                raise AssertionError(f"K16a hop 2 at precision 12 took {case['route']}")
            plain_hops = [time_ms(lambda: khop_sketches_of_singletons_plain(
                tg, h, p, HLL_BITS, 42), 2) for h in (1, 2)]
            entries["sketch_hop2"] = dict(
                source="embiggen_tpu_torch/csrc/hll.cu", replaces="embiggen_tpu/ops/hll.py:53",
                max_abs_err=0.0, precision=p, hop2_route="ids", ms=case["hop2_ids_ms"],
                plain_ms=plain_hops[1] - plain_hops[0], library_ms=None,
                **bound(singleton_route_bytes(tg, p), 0))
        del base, sk
        torch.cuda.empty_cache()
    # The general route, which any caller with its own base takes: the
    # singletons launch, then the hop launch each hop.
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    khop_sketches(tg, singleton_registers(N_NODES, HLL_PRECISION, HLL_BITS, 42, dev), HLL_HOPS)
    torch.cuda.synchronize()
    general = {k: _build.launch_counts()[k] for k in ("hll_registers", "khop_sketches")}
    del tg
    torch.cuda.empty_cache()
    hg = hub_graph(graph)
    htg = hg.device(dev)
    hub_hops = {}
    for p in (HLL_PRECISION, 4, 12):
        want = khop_sketches_plain(htg, singleton_registers_plain(
            hg.number_of_nodes, p, HLL_BITS, 42, dev), HLL_HOPS)
        singleton_route("hub graph", htg, p, want)
        # The hop launch alone over the singletons: the hub rows in chunks of
        # HOP_SPLIT arcs, then the merge, a launch each a hop.
        base = singleton_registers(hg.number_of_nodes, p, HLL_BITS, 42, dev)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        got = khop_sketches(htg, base, HLL_HOPS)
        torch.cuda.synchronize()
        counts = {c: _build.launch_counts()[c] for c in ("khop_sketches", "khop_merge")}
        errs[f"hops hub graph p {p}"] = exact_err(f"K16a hops hub graph p {p}", got, want)
        if counts != {"khop_sketches": HLL_HOPS, "khop_merge": HLL_HOPS}:
            raise AssertionError(f"K16a's hops on the hub graph launched {counts}")
        del got, want
        one = lambda: khop_sketches(htg, base, 1)  # noqa: E731
        hub_hops[p] = dict(launches=counts, chunks=htg.row_plan(HOP_SPLIT).n_chunks,
                           ms=time_ms(one, 10), hop_ms=launch_event_ms(one, "khop_sketches", 5),
                           merge_ms=launch_event_ms(one, "khop_merge", 5),
                           floor_ms=hop_floor_ms(htg, 1 << p))
        if p == HLL_PRECISION:
            plan = htg.row_plan(HOP_SPLIT)
            partials = torch.randint(0, 64, (plan.n_chunks, 1 << p), dtype=torch.uint8,
                                     device=dev)
            own = base[plan.rows.long()]
            owners = plan.owners()
            entries["khop_merge"] = dict(
                source="embiggen_tpu_torch/csrc/hll.cu", replaces="embiggen_tpu/ops/hll.py:53",
                max_abs_err=0.0, launches_from="K16a's three hops on the hub graph, phase 21",
                launch_counts=counts, ms=hub_hops[p]["merge_ms"],
                plain_ms=time_ms(lambda: hop_merge_plain(plan, own, partials), 10),
                library_ms=time_ms(lambda: own.index_reduce(
                    0, owners, partials, "amax", include_self=True), 10),
                library="Tensor.index_reduce (amax)",
                # the chunks' partials and the long rows' own registers read,
                # the long rows written
                **bound((plan.n_chunks + 2 * plan.n_rows) * (1 << p), 0))
            del partials, own, owners
        del base
        torch.cuda.empty_cache()
    entries["khop_sketches"]["hub"] = hub_hops
    entries["sketch_hop1"].update(
        hub_ms=routes[f"hub graph p {HLL_PRECISION}"]["hop1_ms"],
        hub_bound_ms=bound(singleton_route_bytes(htg, HLL_PRECISION), 0)["bound_ms"])
    del htg
    torch.cuda.empty_cache()
    entries["edge_sketch_features"]["max_abs_err"] = max(
        v for k, v in errs.items() if k.startswith("features"))
    entries["edge_sketch_features"]["ms_by_case"] = k16b_ms
    return entries, errs, plain_s, routes, general


def sketch_fit_against_general_route(model, graph, dev) -> int:
    """HyperSketching's fitted sketches (the singleton route) against the
    route its fit took before: the singletons launch, then the hop launch
    each hop, byte for byte; and its K16b features of K16B_PAIRS pairs (half
    arcs, half uniform pairs) against K16b's over those sketches, bit for
    bit. Returns the number of pairs compared."""
    from embiggen_tpu_torch.ops.hll import edge_sketch_features, khop_sketches, singleton_registers

    if model._sketches is None:
        raise AssertionError("HyperSketching kept no sketches after embed_graph")
    tg = graph.device(dev)
    before = khop_sketches(tg, singleton_registers(N_NODES, model._precision, model._bits,
                                                   model.random_state, dev),
                           model._number_of_hops)
    exact_err("HyperSketching's sketches against the general route", model._sketches, before)
    rng = np.random.default_rng(32)
    arcs = rng.integers(0, graph.number_of_directed_edges, K16B_PAIRS // 2)
    src = torch.from_numpy(np.concatenate([graph.sources[arcs], rng.integers(
        0, N_NODES, K16B_PAIRS // 2)]).astype(np.int32)).to(dev)
    dst = torch.from_numpy(np.concatenate([graph.col_idx[arcs], rng.integers(
        0, N_NODES, K16B_PAIRS // 2)]).astype(np.int32)).to(dev)
    if not torch.equal(model.device_feature_fn()(src, dst),
                       edge_sketch_features(before, src, dst, model._precision)):
        raise AssertionError("HyperSketching's K16b features differ from those over the "
                             "general route's sketches")
    return len(src)


def s8_run(run):
    """(result, launch counts, seconds, peak device bytes) of `run()` with the
    counts set to 0 just before it."""
    from embiggen_tpu_torch.ops import _build

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, _build.launch_counts(), time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def s8_quality_on_card(card, dev):
    """The reference's edge-GCN gate with its own node features, Degree-based
    SPINE (`tests/test_quality_gates.py:92-111`): model seed 0 verbatim
    through `edge_prediction_evaluation`, seeds 1-7 on the same connected
    holdout's SPINE features by `_evaluate` (`tests/test_torch_spine_gate.py`);
    the mean test AUPRC must reach the reference's less 0.03, and 0.80. Then
    the reference's HyperSketching GCN test (`tests/test_gcn_edge_features.py`)
    on the gate fixture (its karate fixture waits for node types): AUROC of
    the test edges against as many sampled negatives above 0.6. Returns
    (per-seed AUPRC, the gate's launch counts, the sketch GCN's AUROC)."""
    from embiggen_tpu_torch.graph import (
        connected_holdout, random_geometric, sample_negative_graph,
    )
    from embiggen_tpu_torch.models.edge_features import HyperSketching
    from embiggen_tpu_torch.models.embedders import DegreeSPINE
    from embiggen_tpu_torch.models.gcn import GCNEdgePrediction, KipfGCNEdgePrediction
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.ops.metrics import binary_auroc
    from embiggen_tpu_torch.pipelines import edge_prediction_evaluation

    rgg = random_geometric(1000, radius=0.07, seed=42)
    _build.reset_launch_counts()
    rows = edge_prediction_evaluation(
        holdouts_number=1, models=GCNEdgePrediction(device=dev, **GATE_GCN), graphs=rgg,
        node_features="Degree-based SPINE", evaluation_schema="Connected Monte Carlo",
        random_state=3)
    launches = _build.launch_counts()
    auprc = [next(r["auprc"] for r in rows if r["evaluation_mode"] == "test")]
    train, test = connected_holdout(rgg, random_state=3)
    spine = DegreeSPINE(device=dev).fit_transform(train).node_embeddings[0]
    for seed in GATE_SEEDS[1:]:
        model = GCNEdgePrediction(device=dev, **GATE_GCN)
        model.set_random_state(seed)
        model.fit(train, support=train, node_features=spine)
        got = {r["evaluation_mode"]: r for r in
               model._evaluate(rgg, train, test, support=train, random_state=3)}
        auprc.append(got["test"]["auprc"])
    floor = max(0.80, GATE_REFERENCE_SPINE_GCN_AUPRC - 0.03)
    if not np.mean(auprc) >= floor:
        raise AssertionError(f"SPINE GCN gate mean test AUPRC {np.mean(auprc)} on {card} is "
                             f"below {floor}: {auprc}")
    train, test = connected_holdout(rgg, train_size=0.8, random_state=0)
    model = KipfGCNEdgePrediction(
        device=dev, edge_feature_models=[HyperSketching(device=dev, **GATE_SKETCH)],
        **GATE_SKETCH_GCN)
    model.fit(train, support=train)
    neg = sample_negative_graph(rgg, test.number_of_edges, random_state=1, device=dev)
    pos_scores, neg_scores = model.predict_proba(test), model.predict_proba(neg)
    labels = np.concatenate([np.ones(len(pos_scores)), np.zeros(len(neg_scores))])
    auroc = binary_auroc(labels, np.concatenate([pos_scores, neg_scores]))
    if not (np.isfinite(pos_scores).all() and auroc > GATE_SKETCH_FLOOR):
        raise AssertionError(f"HyperSketching GCN on {card}: AUROC {auroc}")
    return auprc, launches, auroc


def s8_runs(graph, weighted_graph, dev):
    """S8 through the user's entry points on the slice graph and its
    weighted twin: Degree- and Score-based SPINE (seeded scores),
    WeightedSPINE, Degree-based WINE, RUBICONE, RUINE and HyperSketching
    through `embed_graph` at their defaults (D 100), each with its launches
    checked; then the bench GCN (phase 6's seeded features) with lazy
    HyperSketching features for 2 epochs, and with HyperSketching's edge
    embeddings as a static feature matrix for 1, each fitted and scoring
    the graph's arcs. Returns ({name: (model, launches, seconds, peak
    bytes)}, {label: (model, launches, fit seconds, predict seconds, peak
    bytes)})."""
    from embiggen_tpu_torch.models import get_model_from_library
    from embiggen_tpu_torch.models.edge_features import HyperSketching
    from embiggen_tpu_torch.models.gcn import GCNEdgePrediction
    from embiggen_tpu_torch.pipelines import embed_graph

    scores = np.random.default_rng(0).random(N_NODES)
    s8 = {}
    for name, g, kw, names, unused in (
        ("Degree-based SPINE", graph, {}, S8_SPINE_KERNELS, S8_SPINE_UNUSED),
        ("Score-based SPINE", graph, dict(scores=scores), S8_SPINE_KERNELS, S8_SPINE_UNUSED),
        ("WeightedSPINE", weighted_graph, {}, S8_SPINE_KERNELS, S8_SPINE_UNUSED),
        ("Degree-based WINE", graph, dict(window_size=S8_WINDOW), S8_CONV_KERNELS,
         S8_CONV_UNUSED),
        ("RUBICONE", graph, dict(number_of_convolutions=2, random_state=0), S8_CONV_KERNELS,
         S8_CONV_UNUSED),
        ("RUINE", graph, dict(number_of_convolutions=2, random_state=0), S8_CONV_KERNELS,
         S8_CONV_UNUSED),
        ("HyperSketching", graph, dict(number_of_hops=HLL_HOPS, precision=HLL_PRECISION,
                                       bits=HLL_BITS), S8_SKETCH_KERNELS, S8_SKETCH_UNUSED),
    ):
        sketch = name == "HyperSketching"
        if not sketch:
            kw = dict(kw, embedding_size=S8_DIM)
        model = get_model_from_library(name, task_name="Node Embedding")(device=dev, **kw)
        result, counts, secs, peak = s8_run(lambda: embed_graph(g, model))
        emb = result.edge_embeddings[0] if sketch else result.node_embeddings[0]
        shape = ((g.number_of_directed_edges, HLL_HOPS ** 2 + 2 * HLL_HOPS) if sketch
                 else (N_NODES, S8_DIM))
        if emb.shape != shape or not np.isfinite(emb.astype(np.float32)).all():
            raise AssertionError(f"{name}: shape {emb.shape} or non-finite values")
        s8[name] = (model, check_launches(name, counts, names, unused), secs, peak)
        if sketch:
            hs_edges = emb
        del result, emb
    # HyperSketching at precision 12, where hop 2 takes the id route.
    model = HyperSketching(device=dev, number_of_hops=HLL_HOPS, precision=12, bits=HLL_BITS)
    result, counts, secs, peak = s8_run(lambda: embed_graph(graph, model))
    emb = result.edge_embeddings[0]
    if (emb.shape != (graph.number_of_directed_edges, HLL_HOPS ** 2 + 2 * HLL_HOPS)
            or not np.isfinite(emb).all()):
        raise AssertionError(f"HyperSketching p12: shape {emb.shape} or non-finite values")
    s8["HyperSketching p12"] = (model, check_launches(
        "HyperSketching p12", counts, S8_SKETCH_HOP2_KERNELS, S8_SKETCH_HOP2_UNUSED), secs, peak)
    model._sketches = None   # 12 GB on the card
    del result, emb
    torch.cuda.empty_cache()
    feats = np.random.default_rng(0).standard_normal((N_NODES, DIM), dtype=np.float32)
    s8_gcn = {}
    for label, kw, fit_kw, epochs, names, unused in (
        ("GCN + HyperSketching", dict(edge_feature_models=[HyperSketching(device=dev)]), {}, 2,
         S8_GCN_KERNELS, S8_GCN_UNUSED),
        ("GCN + static edge features", {}, dict(edge_features=[hs_edges]), 1,
         S8_GCN_STATIC_KERNELS, S8_SKETCH_HOP2_KERNELS + ("hll_registers",)),
    ):
        model = GCNEdgePrediction(epochs=epochs, batch_size=GCN_BATCH, dropout_rate=0.0,
                                  early_stopping_patience=10**6, random_state=0,
                                  device=dev, **kw)

        def fit_predict(model=model, fit_kw=fit_kw):
            t0 = time.perf_counter()
            model.fit(graph, node_features=feats, **fit_kw)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            return fit_s, model.predict_proba(graph)

        (fit_s, proba), counts, secs, peak = s8_run(fit_predict)
        if len(model._history) != epochs or not np.isfinite(model._history).all():
            raise AssertionError(f"{label} epoch losses {model._history}")
        if proba.shape != (graph.number_of_directed_edges,) or not np.isfinite(proba).all():
            raise AssertionError(f"{label} scores: wrong shape or non-finite values")
        s8_gcn[label] = (model, check_launches(label, counts, names, unused), fit_s,
                         secs - fit_s, peak)
        del proba
        torch.cuda.empty_cache()
    return s8, s8_gcn


# ------------------------------------------------------------------- S9
def k18_checks(graph, dev):
    """K18 against its plain version, exactly: one round and S9_ROUNDS on the
    slice graph at D 100 (Exp(1) races and noise, sketch ids arange(N)), 3
    rounds at D 1 and D 30 (not a multiple of 4), S9_ROUNDS at D 30 on
    s8_graphs' graphs (two components with isolated nodes; directed), 3
    rounds at D 100 on the slice graph with N_HUBS planted hubs (rows of
    4,096-65,536 arcs), and exact ties (races on a grid of four values,
    noise on a grid of two, at decay 0.5, so many candidates are +0.0) on
    the slice graph; and its candidate pass against its plain version,
    exactly, at D 100, 30 and 1. Returns the kernels entries of the round
    and of the candidate pass, timed at the slice shape, and the errors by
    case."""
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.ops.nodesketch import (
        candidate_pitch, inverse_decay, sketch_candidates, sketch_candidates_plain, sketch_race,
        sketch_race_step, sketch_race_step_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(5)

    def exp(n, d):
        return torch.empty((n, d), device=dev).exponential_(generator=gen)

    def ids(n, d):
        return torch.arange(n, dtype=torch.int32, device=dev)[:, None].repeat(1, d)

    def grid(n, d, values):
        v = torch.tensor(values, device=dev)
        return v[torch.randint(0, len(values), (n, d), generator=gen, device=dev)]

    errs = {}

    def check(name, tg, race, sketch, noises, inv):
        got = sketch_race(tg, race, sketch, iter(noises), inv)
        want = (race, sketch)
        for noise in noises:
            want = sketch_race_step_plain(tg, *want, noise, inv)
        errs[name] = max(exact_err(f"K18 races {name}", got[0], want[0]),
                         exact_err(f"K18 sketches {name}", got[1], want[1]))

    inv = inverse_decay(S9_DECAY)
    tg = graph.device(dev)
    race, sketch = exp(N_NODES, S9_DIM), ids(N_NODES, S9_DIM)
    noises = [exp(N_NODES, S9_DIM) for _ in range(S9_ROUNDS)]
    for d in (S9_DIM, 30, 1):
        r, e = (race, noises[0]) if d == S9_DIM else (exp(N_NODES, d), exp(N_NODES, d))
        errs[f"candidates D {d}"] = exact_err(f"K18 candidates D {d}", sketch_candidates(
            r, e, inv), sketch_candidates_plain(r, e, inv))
    check(f"D {S9_DIM} one round", tg, race, sketch, noises[:1], inv)
    check(f"D {S9_DIM} {S9_ROUNDS} rounds", tg, race, sketch, noises, inv)
    for d in (1, 30):
        check(f"D {d}", tg, exp(N_NODES, d), ids(N_NODES, d),
              [exp(N_NODES, d) for _ in range(3)], inv)
    for name, g in s8_graphs(dev).items():
        n = g.number_of_nodes
        check(name, g.device(dev), exp(n, 30), ids(n, 30),
              [exp(n, 30) for _ in range(S9_ROUNDS)], inv)
    hubs = hub_graph(graph)
    n = hubs.number_of_nodes
    check(f"planted hubs D {S9_DIM}", hubs.device(dev), exp(n, S9_DIM), ids(n, S9_DIM),
          [exp(n, S9_DIM) for _ in range(3)], inv)
    del hubs
    check("exact ties", tg, grid(N_NODES, S9_DIM, [0.0, 0.25, 0.5, 1.0]), sketch,
          [grid(N_NODES, S9_DIM, [0.0, 0.5]) for _ in range(3)], inverse_decay(0.5))
    out = (torch.empty_like(race), torch.empty_like(sketch))
    ws = torch.empty((N_NODES, candidate_pitch(S9_DIM)), device=dev)
    n, d, e = N_NODES, S9_DIM, tg.n_arcs
    heads = int(torch.unique(tg.col_idx).numel())

    def round_():
        sketch_race_step(tg, race, sketch, noises[0], inv, out, ws)
    round_()
    torch.cuda.synchronize()
    with _build.timed_launches() as events:
        for _ in range(10):
            round_()
    torch.cuda.synchronize()
    launch_ms = {k: sum(s.elapsed_time(t) for s, t in v) / 10 for k, v in events.items()}
    inv_t = torch.tensor(inv, device=dev)
    entries = {
        "sketch_candidates": dict(
            source="embiggen_tpu_torch/csrc/nodesketch.cu",
            replaces="embiggen_tpu/models/embedders/factorization.py:421",
            max_abs_err=max(v for k, v in errs.items() if k.startswith("candidates")),
            ms=time_ms(lambda: sketch_candidates(race, noises[0], inv, ws), 20),
            plain_ms=time_ms(lambda: sketch_candidates_plain(race, noises[0], inv), 20),
            library="torch.addcmul",
            library_ms=time_ms(lambda: torch.addcmul(noises[0], race, inv_t), 20),
            # race and noise read, the candidates written; an fma (2) each.
            **bound(12 * n * d, 2 * n * d)),
        "sketch_race_step": dict(
            source="embiggen_tpu_torch/csrc/nodesketch.cu",
            replaces="embiggen_tpu/models/embedders/factorization.py:415",
            max_abs_err=max(v for k, v in errs.items() if not k.startswith("candidates")),
            ms=time_ms(round_, 10),
            launch_ms=launch_ms,
            plain_ms=time_ms(lambda: sketch_race_step_plain(tg, race, sketch, noises[0], inv),
                             2),
            library_ms=None,
            distinct_heads=heads,
            # every row's race and sketch, the noise of each distinct arc
            # head, the new race and sketch, the CSR; an fma (2) and two
            # compares per gathered element.
            **bound((8 * n + 4 * heads) * d + 8 * n * d + 4 * (n + 1 + e), 4 * e * d)),
    }
    del race, sketch, noises, out, ws
    return entries, errs


def randne_hop_checks(graph, dev):
    """RandNE's two K7 hops (unit values, row scale 1 / max(deg, 1)) at D 100
    from a seeded N(0, 1/D) base on the slice graph, each against
    csr_spmm_plain on the kernel's previous hop (rtol 1e-5 / atol 1e-7:
    sums in another order). Returns the hop's timings, bound and error."""
    from embiggen_tpu_torch.ops.bfs import arc_rows, unit_kernel
    from embiggen_tpu_torch.ops.spmm import csr_spmm, csr_spmm_plain

    tg = graph.device(dev)
    k = unit_kernel(tg)
    inv_deg = torch.from_numpy(
        1.0 / np.maximum(graph.degrees, 1).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    cur = torch.randn((N_NODES, S9_DIM), generator=gen, device=dev) / np.sqrt(S9_DIM)
    base, errs = cur, []
    for hop in range(len(S9_ALPHAS)):
        nxt = csr_spmm(k, cur, row_scale=inv_deg)
        errs.append(check_close(f"RandNE hop {hop + 1}", nxt,
                                csr_spmm_plain(k, cur, row_scale=inv_deg), **S9_HOP_TOL))
        cur = nxt
    a = torch.sparse_csr_tensor(k.row_ptr, k.cols, inv_deg[arc_rows(tg).long()],
                                size=(N_NODES, N_NODES))
    n, d, e = N_NODES, S9_DIM, tg.n_arcs
    hop = dict(
        max_abs_err=max(errs),
        ms=time_ms(lambda: csr_spmm(k, base, row_scale=inv_deg), 20),
        plain_ms=time_ms(lambda: csr_spmm_plain(k, base, row_scale=inv_deg), 3),
        library_ms=time_ms(lambda: torch.sparse.mm(a, base), 20),
        library="torch.sparse.mm (cuSPARSE)",
        # x in, the sums out, the CSR and the row scales; a multiply-add per
        # gathered float.
        **bound(4 * (2 * n * d + 2 * n + 1 + e), 2 * e * d))
    del a, k, base, cur, nxt
    return hop


def svd_embedding_share(got, want, blocks):
    """The largest error, as a share of its tolerance, of an SVD row's
    embedding against another: each block's column norms (rtol
    S9_GRAM_RTOL) and the Gram matrix of its leading columns up to its last
    cut between singular values 1% apart (S9_GRAM_RTOL of its scale), as
    tests/test_torch_factorization.py holds them."""
    worst = 0.0
    per_block = want.shape[1] // blocks
    for b in range(blocks):
        g, w = (x[:, b * per_block:(b + 1) * per_block].double() for x in (got, want))
        norms, want_norms = g.norm(dim=0), w.norm(dim=0)
        worst = max(worst, float(((norms - want_norms).abs()
                                  / (S9_GRAM_RTOL * want_norms + 1e-6)).max()))
        s = want_norms ** 2
        cuts = torch.nonzero(s[:-1] > 1.01 * s[1:]).flatten()
        if len(cuts):
            c = int(cuts[-1]) + 1
            gram, want_gram = g[:, :c] @ g[:, :c].T, w[:, :c] @ w[:, :c].T
            worst = max(worst, float((gram - want_gram).abs().max()
                                     / (S9_GRAM_RTOL * want_gram.abs().max())))
    return worst


def s9_dense_checks(dev):
    """Each dense row on the card against the CPU from the same state, for
    random states 0-2 on erdos_renyi(2,000 nodes): the SVD rows by
    svd_embedding_share, the others within S9_ITERATIVE_RTOL of the scale.
    Returns {row: the largest error as a share of its tolerance}."""
    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.models import get_model_from_library

    g = erdos_renyi(S9_CHECK_NODES, S9_CHECK_EDGES, seed=1)
    shares = {}
    for name, kw in S9_DENSE_ROWS:
        cls = get_model_from_library(name, task_name="Node Embedding")
        kw = dict(kw, **S9_CHECK_KW.get(name, {}))
        worst = 0.0
        for seed in range(S9_CHECK_RUNS):
            card = cls(device=dev, random_state=seed, **kw)
            state = card.initial_state(g)
            got = card.run(g, state).cpu()
            want = cls(device="cpu", random_state=seed, **kw).run(g, {
                k: [x.cpu() for x in v] if isinstance(v, list) else v.cpu()
                for k, v in state.items()})
            if name in ("NetMF", "GraRep"):
                share = svd_embedding_share(got, want, card._order if name == "GraRep" else 1)
            else:
                share = float((got - want).abs().max()
                              / (S9_ITERATIVE_RTOL * want.abs().max()))
            if not (torch.isfinite(got).all() and share <= 1.0):
                raise AssertionError(f"{name} seed {seed}: card against CPU at {share} of "
                                     "the tolerance, or non-finite values")
            worst = max(worst, share)
        shares[name] = worst
    return shares


def s9_runs(graph, dev):
    """S9 through `embed_graph`: NodeSketch and RandNE on the slice graph at
    the reference's defaults, with K18 launched S9_ROUNDS times and K7
    twice; the six dense rows at their default widths on
    erdos_renyi(32,768 nodes, 327,680 edges), launching none of the port's
    kernels. Returns {name: (launches, seconds, peak bytes, the fit's own
    peak: the peak less what was allocated before it)}."""
    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.models import get_model_from_library
    from embiggen_tpu_torch.pipelines import embed_graph

    dense = erdos_renyi(S9_DENSE_NODES, S9_DENSE_EDGES, seed=0)
    out = {}
    for name, g, kw, names, launches in (
        ("NodeSketch", graph, {}, S9_SKETCH_KERNELS, S9_ROUNDS),
        ("RandNE", graph, {}, S9_RANDNE_KERNELS, len(S9_ALPHAS)),
        *((name, dense, kw, (), 0) for name, kw in S9_DENSE_ROWS),
    ):
        model = get_model_from_library(name, task_name="Node Embedding")(device=dev, **kw)
        held = torch.cuda.memory_allocated()
        result, counts, secs, peak = s8_run(lambda: embed_graph(g, model))
        emb = result.node_embeddings[0]
        if emb.shape != (g.number_of_nodes, model.embedding_size) or not np.isfinite(emb).all():
            raise AssertionError(f"{name}: shape {emb.shape} or non-finite values")
        got = {k: counts[k] for k in names}
        if got != dict.fromkeys(names, launches) or sum(counts.values()) != launches * len(names):
            raise AssertionError(f"{name} launched {counts}, expected {launches} of each of "
                                 f"{names} and nothing else")
        out[name] = (got, secs, peak, peak - held)
        del result, emb
        torch.cuda.empty_cache()
    return out


def s9_quality_on_card(card, dev):
    """RandNE and NetMF features on the gate fixture's connected holdout,
    embedding seeds GATE_S9_SEEDS at the rows' defaults, each feeding a
    Perceptron on Hadamard alone scored by `_evaluate`. Raises unless each
    mean test AUROC reaches the reference's less 0.03. Returns {row: per-seed
    test AUROC}."""
    from embiggen_tpu_torch.graph import connected_holdout, random_geometric
    from embiggen_tpu_torch.models import get_model_from_library
    from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction

    rgg = random_geometric(1000, radius=0.07, seed=42)
    train, test = connected_holdout(rgg, random_state=3)
    auroc = {}
    for name, reference in GATE_REFERENCE_S9_AUROC.items():
        auroc[name] = []
        for seed in GATE_S9_SEEDS:
            emb = get_model_from_library(name, task_name="Node Embedding")(
                device=dev, random_state=seed).fit_transform(train).node_embeddings[0]
            model = PerceptronEdgePrediction(device=dev, **GATE_CBOW_PERCEPTRON)
            model.fit(train, node_features=emb)
            rows = {r["evaluation_mode"]: r for r in
                    model._evaluate(rgg, train, test, random_state=3)}
            auroc[name].append(rows["test"]["auroc"])
        if not np.mean(auroc[name]) >= reference - 0.03:
            raise AssertionError(f"{name} gate mean test AUROC {np.mean(auroc[name])} on "
                                 f"{card} is below the reference's {reference} less 0.03: "
                                 f"{auroc[name]}")
    return auroc


# ------------------------------------------------------------------- S10
def typed_laws(laws, g, tg, rw, ew, node_w, edge_w, cap, ell):
    """The typed step laws (`tests/pq_laws.py`) of K9 over `tg`'s ELL rows
    (`ell`), or of K19 over windows of `cap` CSR slots."""
    return laws.Laws(
        g.row_ptr, g.col_idx, g.weights, rw, ew,
        ell=None if not ell else (tg.ell_cols.cpu().numpy(),
                                  None if tg.ell_w is None else tg.ell_w.cpu().numpy(),
                                  min(cap, tg.ell_cap)),
        node_types=g.get_single_label_node_type_ids(), edge_types=g.edge_types,
        node_w=node_w, edge_w=edge_w, window=None if ell else cap)


def multigraph_carry_p(kernel, dev) -> dict:
    """The edge type a typed kernel carries is the picked arc's: node 0 has
    two arcs to node 1, of types 0 and 2, and the move after 1 depends on
    which (tests/test_torch_cuda.py::test_typed_kernels_carry_the_picked_
    arcs_type_on_a_multigraph derives the law: 1 -> 0 with probability
    0.32, where a lookup of the pair would give 0.8 or 0.2). Returns the
    p-values of the move from 0 and of the move from 1."""
    from scipy.stats import chi2

    from embiggen_tpu_torch.graph import Graph

    g = Graph(row_ptr=np.array([0, 4, 6, 7, 8]),
              col_idx=np.array([1, 1, 2, 3, 0, 2, 0, 0], np.int32),
              edge_types=np.array([0, 2, 1, 2, 0, 2, 1, 2], np.int32),
              node_type_ptr=np.arange(5), node_type_ids=np.array([0, 1, 0, 1], np.int32))
    tg = g.device(dev, ell_cap=8, with_walk_types=True)
    starts = torch.full((400000,), 3, dtype=torch.int32, device=dev)
    w = kernel(tg, starts, 4, 1.0, 1.0, 8, torch.Generator().manual_seed(5), 2.0, 0.25)
    w = w.cpu().numpy()

    def p_value(observed, law):
        e = observed.sum() * law
        return float(chi2.sf(((observed - e) ** 2 / e).sum(), len(law) - 1))

    at_1 = w[w[:, 2] == 1, 3]
    if not ((w[:, 1] == 0).all() and (w[:, 2] != 0).all() and np.isin(at_1, [0, 2]).all()):
        raise AssertionError("a multigraph walk left the arcs")
    return {"from 0": p_value(np.bincount(w[:, 2], minlength=4)[1:],
                              np.array([2.5, 0.25, 2.0]) / 4.75),
            "from 1 (the carried type)": p_value(
                np.array([(at_1 == 0).sum(), (at_1 == 2).sum()]), np.array([0.32, 0.68]))}


def typed_law_checks(dev):
    """K19 and typed K9 on small typed graphs, weighted and not
    (`erdos_renyi(200, 800, seed=7, n_edge_types=3, n_node_types=4)`), every
    move, the first ones included, against its exact typed law
    (`tests/pq_laws.py`, pooled chi-square): for each of the reference's
    (node, edge) weights S10_FACTORS with neutral p/q and with 2 / 0.5,
    typed K9 over whole rows (cap 100) and K19 over whole rows; on
    `erdos_renyi(60, 1100)` (degrees above 34) typed K9 over rows subsampled
    at cap 8 and K19 over windows of 34 rotated on the longer rows; untyped
    K19 (exact_pq at 2 / 0.5, and a weight ratio of 20); and the carried
    edge type on a multigraph. Returns ({test: p}, {kernel: max |empirical
    - exact| step probability})."""
    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.ops.walks import ell_walks, exact_walks

    laws = laws_module("pq_laws")
    p, err = {}, {"ell_walks_typed": 0.0, "exact_walks": 0.0}
    kernels = {"ell_walks_typed": ell_walks, "exact_walks": exact_walks}

    def run(label, name, g, tg, rw, ew, node_w, edge_w, cap, walkers, seed):
        n = g.number_of_nodes
        starts = (torch.arange(walkers, device=dev) % n).int()
        w = kernels[name](tg, starts, 12, rw, ew, cap, torch.Generator().manual_seed(seed),
                          node_w, edge_w)
        p[label], e = laws.walks_chi2_p(w.cpu().numpy(), typed_laws(
            laws, g, tg, rw, ew, node_w, edge_w, cap, name == "ell_walks_typed"), n)
        err[name] = max(err[name], e)

    for weighted in (False, True):
        g = erdos_renyi(200, 800, seed=7, weighted=weighted, n_edge_types=3, n_node_types=4)
        tg_ell = g.device(dev, ell_cap=ELL_CAP, ell_seed=1, with_walk_types=True)
        tg = g.device(dev, with_alias=weighted, with_walk_types=True)
        for i, ((node_w, edge_w), (rw, ew)) in enumerate(
                (f, q) for f in S10_FACTORS for q in S10_PQ):
            tag = f"{node_w}/{edge_w} p/q {rw}/{ew} weighted={weighted}"
            run(f"K9 {tag}", "ell_walks_typed", g, tg_ell, rw, ew, node_w, edge_w, ELL_CAP,
                40000, i)
            run(f"K19 {tag}", "exact_walks", g, tg, rw, ew, node_w, edge_w, ELL_CAP, 40000, i)
        for rw, ew in ((2.0, 0.5), (0.05, 1.0)):
            run(f"K19 untyped p/q {rw}/{ew} weighted={weighted}", "exact_walks", g, tg, rw, ew,
                1.0, 1.0, ELL_CAP, 40000, 7)
        dense = erdos_renyi(60, 1100, seed=7, weighted=weighted, n_edge_types=3, n_node_types=4)
        if not int(dense.degrees.max()) > S10_ROTATED_CAP:
            raise AssertionError("the dense graph's rows do not exceed the window")
        run(f"K9 over cap 8 weighted={weighted}", "ell_walks_typed", dense,
            dense.device(dev, ell_cap=8, ell_seed=1, with_walk_types=True), 2.0, 0.5, 3.0, 0.5,
            8, 200000, 8)
        run(f"K19 rotated windows of {S10_ROTATED_CAP} weighted={weighted}", "exact_walks",
            dense, dense.device(dev, with_alias=weighted, with_walk_types=True), 2.0, 0.5, 3.0,
            0.5, S10_ROTATED_CAP, 200000, 9)
    for name, kernel in kernels.items():
        for k, v in multigraph_carry_p(kernel, dev).items():
            p[f"{name} multigraph {k}"] = v
    failed = {k: v for k, v in p.items() if v < P_MIN}
    if failed:
        raise AssertionError(f"typed walk law tests failed (p < {P_MIN}): {failed}")
    return p, err


def slice_typed_checks(typed, typed_hub, dev):
    """Typed K9 and K19 on the typed slice graph at the slice shapes
    (S10_TYPED factors, p/q 2 / 0.5, cap 100), and K19 on `typed_hub` (the
    typed slice graph plus N_HUBS hubs typed at random, whose rows exceed
    the cap; half the walkers start at a hub), against their plain versions
    from the same starts (two-sample chi-square): every move an arc; the
    first step, the first p/q step and the last binned by node degree and
    by blocks of ID_BLOCK ids; the returns and the node-type changes at each
    position. Returns the p-values by test."""
    from embiggen_tpu_torch.ops.negatives import nce_negatives
    from embiggen_tpu_torch.ops.walks import (
        ell_walks, ell_walks_plain, exact_walks, exact_walks_plain,
    )

    p = {}
    for name, g, kernel, plain, ell in (
        ("K9 typed", typed, ell_walks, ell_walks_plain, True),
        ("K19", typed, exact_walks, exact_walks_plain, False),
        ("K19 hubs", typed_hub, exact_walks, exact_walks_plain, False),
    ):
        tg = g.device(dev, ell_cap=ELL_CAP if ell else None, with_walk_types=True)
        starts = nce_negatives(tg, torch.Generator().manual_seed(41), (BATCH,),
                               scale_free=False)
        if name == "K19 hubs":
            hubs = torch.arange(g.number_of_nodes - N_HUBS, g.number_of_nodes, device=dev)
            starts[::2] = hubs[torch.arange(BATCH // 2, device=dev) % N_HUBS].int()
        args = (WALK, *PQ.values(), ELL_CAP)
        w = kernel(tg, starts, *args, torch.Generator().manual_seed(42), *S10_TYPED.values())
        w_plain = plain(tg, starts, *args, torch.Generator(device=dev).manual_seed(43),
                        *S10_TYPED.values())
        if not (torch.equal(w[:, 0], starts) and torch.equal(w_plain[:, 0], starts)):
            raise AssertionError(f"{name}: walks[:, 0] differs from the starts")
        keys = arc_keys(g, dev)
        for walks in (w, w_plain):
            arc_positions(g, walks, keys)
        for pos in (1, 2, WALK - 1):
            binned_tests(p, f"{name} position {pos} vs plain", node_counts(tg, w[:, pos]),
                         node_counts(tg, w_plain[:, pos]), False)
        p[f"{name} returns by position vs plain"] = returns_p(w, w_plain)
        p[f"{name} type changes by position vs plain"] = type_changes_p(
            w, w_plain, tg.node_type_of)
        del tg, w, w_plain, keys
        torch.cuda.empty_cache()
    failed = {k: v for k, v in p.items() if v < P_MIN}
    if failed:
        raise AssertionError(f"typed walk tests at the slice shapes failed "
                             f"(p < {P_MIN}): {failed}")
    return p


def typed_walk_entries(typed, errs, dev):
    """Typed K9 and K19 timed at the slice shapes on the typed slice graph
    (S10_TYPED factors, p/q 2 / 0.5, cap 100), with their bounds from this
    run's walks; typed K9 also with p = q = 1 (the typed SkipGram's walks);
    untyped K9 on the same ELL table timed in turns with typed K9 (the
    table's CSR is the slice graph's); K19 also untyped (exact_pq)."""
    from embiggen_tpu_torch.ops.negatives import nce_negatives
    from embiggen_tpu_torch.ops.walks import (
        ell_walks, ell_walks_plain, exact_walks, exact_walks_plain,
    )

    entries = {}
    gen, cuda_gen = torch.Generator().manual_seed(44), torch.Generator(device=dev).manual_seed(45)
    deg_all = torch.from_numpy(typed.degrees).to(dev).long()
    io = 4 * BATCH + 4 * BATCH * WALK   # starts in, walks out
    typed_w = tuple(S10_TYPED.values())
    # K9: the ELL table with its type tables.
    tg = typed.device(dev, ell_cap=ELL_CAP, with_walk_types=True)
    starts = nce_negatives(tg, gen, (BATCH,), scale_free=False)
    args = (starts, WALK, *PQ.values(), ELL_CAP)
    w = ell_walks(tg, *args, gen, *typed_w)
    prev, curr = w[:, :-2].reshape(-1).long(), w[:, 1:-1].reshape(-1).long()
    rows = torch.unique(w[:, :-1]).long()
    deg_ell = deg_all.clamp(max=tg.ell_cap).double()
    # Each distinct row's real slots: ids, slot node types, slot edge types;
    # each row's node's type; membership as untyped K9's.
    k9_bytes = io + 12 * float(deg_ell[rows].sum()) + 4 * rows.numel()
    k9_ops = float((deg_ell[curr] * search_reads(deg_ell[prev])).sum())
    turns = [time_ms(lambda: ell_walks(tg, *args, gen, *f), 10)
             for f in ((1.0, 1.0), typed_w, typed_w, (1.0, 1.0))]
    entries["ell_walks_typed"] = dict(
        source="embiggen_tpu_torch/csrc/walks2.cu", replaces="embiggen_tpu/ops/walks.py:245",
        max_abs_err=errs["ell_walks_typed"], ms=(turns[1] + turns[2]) / 2,
        plain_ms=time_ms(lambda: ell_walks_plain(tg, *args, cuda_gen, *typed_w), 2),
        library_ms=None, untyped_ms_in_turns=[turns[0], turns[3]],
        typed_ms_in_turns=turns[1:3],
        typed_only_ms=time_ms(lambda: ell_walks(tg, starts, WALK, 1.0, 1.0, ELL_CAP, gen,
                                                *typed_w), 10),
        **bound(k9_bytes, k9_ops))
    del tg, w, prev, curr, rows
    torch.cuda.empty_cache()
    # K19: the CSR, the arcs' edge types, node_type_of.
    tg = typed.device(dev, with_walk_types=True)
    w = exact_walks(tg, *args, gen, *typed_w)
    prev, curr = w[:, :-2].reshape(-1).long(), w[:, 1:-1].reshape(-1).long()
    rows = torch.unique(w[:, :-1]).long()
    window = deg_all.clamp(max=ELL_CAP).double()
    # Each distinct row's two row_ptr entries and its arcs' ids and edge
    # types (its whole row: no row here exceeds the cap), each candidate's
    # node type (at most every node's); a search of prev's row per
    # candidate.
    k19_bytes = io + 8 * rows.numel() + 8 * float(deg_all[rows].sum()) + 4 * typed.number_of_nodes
    k19_ops = float((window[curr] * search_reads(deg_all[prev])).sum())
    entries["exact_walks"] = dict(
        source="embiggen_tpu_torch/csrc/walks2.cu", replaces="embiggen_tpu/ops/walks.py:348",
        max_abs_err=errs["exact_walks"],
        ms=time_ms(lambda: exact_walks(tg, *args, gen, *typed_w), 10),
        plain_ms=time_ms(lambda: exact_walks_plain(tg, *args, cuda_gen, *typed_w), 1),
        library_ms=None,
        untyped_ms=time_ms(lambda: exact_walks(tg, *args, gen), 10),
        **bound(k19_bytes, k19_ops))
    for name in ("ell_walks_typed", "exact_walks"):
        entries[name]["walk_steps_per_s"] = BATCH * (WALK - 1) / (entries[name]["ms"] / 1e3)
    del tg, w, prev, curr, rows
    torch.cuda.empty_cache()
    return entries


def s10_runs(typed, dev):
    """S10 through the entry points on the typed slice graph, each with the
    counts set to 0 just before and read just after: `embed_graph` of typed
    Node2Vec SkipGram (S10_TYPED, p = q = 1) at the S1 widths for 2 epochs
    and of typed p/q Node2Vec CBOW (return 2, explore 0.5, S10_TYPED) for 1,
    both on typed K9; `random_walks` on the graph exported without an ELL
    table, typed, untyped with exact_pq and at a weight ratio of 20, on
    K19; the bench GCN of phase 6 with the node-type and edge-type
    embeddings for 2 epochs, scoring the 20M arcs (K6, K7, K5). Returns
    {run: (launches, seconds, peak bytes, extra)}."""
    from embiggen_tpu_torch.models.gcn import GCNEdgePrediction
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.ops.negatives import nce_negatives
    from embiggen_tpu_torch.ops.walks import random_walks

    out = {}
    walk_kernels = ("first_order_walks", "first_order_batch", "ell_walks", "ell_walks_typed",
                    "rejection_walks", "exact_walks")
    for label, name, epochs, kw, names, extra_unused in (
        ("typed SkipGram", "Node2Vec SkipGram", 2, S10_TYPED, S10_SKIPGRAM_KERNELS, ()),
        ("typed p/q CBOW", "Node2Vec CBOW", 1, dict(PQ, **S10_TYPED), S10_CBOW_KERNELS,
         ("skipgram_nce_update",)),
    ):
        model, counts, secs, peak, centres, steps = embed_run(typed, dev, name, epochs, **kw)
        unused = tuple(k for k in walk_kernels if k not in names) + extra_unused
        out[label] = (check_launches(label, counts, names, unused), secs, peak,
                      dict(s_per_epoch=model._epoch_seconds, centres_per_s=centres,
                           walk_steps_per_s=steps, losses=model._epoch_losses))
        del model
        torch.cuda.empty_cache()
    tg = typed.device(dev, with_walk_types=True)
    starts = nce_negatives(tg, torch.Generator().manual_seed(46), (BATCH,), scale_free=False)
    keys = arc_keys(typed, dev)
    for label, kw in (("random_walks typed", dict(PQ, **S10_TYPED)),
                      ("random_walks exact_pq", dict(PQ, exact_pq=True)),
                      ("random_walks ratio 20", dict(return_weight=0.05))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        w = random_walks(tg, starts, WALK, torch.Generator().manual_seed(47), **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = check_launches(label, _build.launch_counts(), ("exact_walks",),
                                  tuple(k for k in walk_kernels if k != "exact_walks"))
        arc_positions(typed, w, keys)
        out[label] = (launches, secs, torch.cuda.max_memory_allocated(), {})
        del w
    del tg, starts, keys
    torch.cuda.empty_cache()
    feats = np.random.default_rng(0).standard_normal((N_NODES, DIM), dtype=np.float32)
    gcn = GCNEdgePrediction(epochs=2, batch_size=GCN_BATCH, dropout_rate=0.0,
                            early_stopping_patience=10**6, random_state=0, device=dev,
                            use_node_type_embedding=True, use_edge_type_embedding=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    gcn.fit(typed, node_features=feats)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    proba = gcn.predict_proba(typed)
    secs = time.perf_counter() - t0
    if len(gcn._history) != 2 or not np.isfinite(gcn._history).all():
        raise AssertionError(f"typed GCN epoch losses {gcn._history}")
    if proba.shape != (typed.number_of_directed_edges,) or not np.isfinite(proba).all():
        raise AssertionError("typed GCN scores: wrong shape or non-finite values")
    out["typed GCN"] = (check_launches("typed GCN", _build.launch_counts(), S10_GCN_KERNELS,
                                       walk_kernels), secs, torch.cuda.max_memory_allocated(),
                        dict(fit_s=fit_s, predict_s=secs - fit_s, losses=gcn._history))
    del gcn, proba
    torch.cuda.empty_cache()
    return out


def s10_quality_on_card(card, dev):
    """The reference's `test_typed_walks_end_to_end` (tests/test_walks.py) on
    the card: on its typed fixture, 30 walks of 10 from every node, the
    node-type change rate at change_node_type_weight 5 must exceed the rate
    at 0.1 by more than 0.1, through typed K9 (cap 64) and through K19 (no
    ELL table). Returns {route: (rate at 5, rate at 0.1)}."""
    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.ops.walks import random_walks

    g = erdos_renyi(60, 400, seed=3, weighted=True, n_edge_types=3, n_node_types=4)
    ntypes = torch.from_numpy(g.get_single_label_node_type_ids()).to(dev)
    starts = torch.arange(60, dtype=torch.int32, device=dev).repeat(30)
    rates = {}
    for route, tg, kernel in (
        ("K9", g.device(dev, ell_cap=64, with_walk_types=True), "ell_walks_typed"),
        ("K19", g.device(dev, with_walk_types=True), "exact_walks"),
    ):
        got = []
        for node_w in (5.0, 0.1):
            _build.reset_launch_counts()
            w = random_walks(tg, starts, 10, torch.Generator().manual_seed(2),
                             change_node_type_weight=node_w).long()
            check_launches(f"S10 quality {route}", _build.launch_counts(), (kernel,))
            t = ntypes[w]
            got.append(float((t[:, 1:] != t[:, :-1]).double().mean()))
        rates[route] = tuple(got)
        if not got[0] > got[1] + 0.1:
            raise AssertionError(f"S10 quality through {route} on {card}: the type change rate "
                                 f"at weight 5 ({got[0]}) does not exceed the rate at 0.1 "
                                 f"({got[1]}) by more than 0.1")
    return rates


def launch_share(fn, counters, reps):
    """{ms: one call of `fn` on CUDA events, kernel_ms: the port's launches
    of `counters` in it, each on its own event pair, share: their ratio},
    means over `reps` calls after one warm-up."""
    from embiggen_tpu_torch.ops import _build

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with _build.timed_launches() as events:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    torch.cuda.synchronize()
    total = start.elapsed_time(end) / reps
    part = sum(s.elapsed_time(e) for c in counters for s, e in events.get(c, [])) / reps
    return dict(ms=total, kernel_ms=part, share=part / total)


def nodesketch_fit(graph, dev):
    """One NodeSketch fit at the S9 defaults (draws, export, S9_ROUNDS K18
    launches), as a closure."""
    from embiggen_tpu_torch.models.embedders import NodeSketch

    model = NodeSketch(device=dev)

    def fit():
        model.run(graph, model.initial_state(graph))
    return fit


# The kernels each path must launch; each path runs with the counts set to
# 0 just before it and read just after.
S1_KERNELS = ("first_order_batch", "skipgram_nce_update", "skipgram_mean_combine")
# The S1 step draws its batch in the fused launch, never through K1 or K2;
# K4 standalone serves the minibatch families (S6).
S1_UNUSED = ("first_order_walks", "nce_negatives", "mean_scatter", "mean_combine")
S2_KERNELS = ("csr_edge_ids",)
S3_KERNELS = ("edge_prediction_mini_batch", "spmm")
K8_KERNELS = ("edge_metrics",)
S4_KERNELS = S1_KERNELS + S2_KERNELS + S3_KERNELS
PROBE_KERNELS = ("tile_gather_sums", "table_gather_sums")
# S5: Node2Vec CBOW over p/q walks; a wrong route launches one of the others.
S5_KERNELS = ("nce_negatives", "ell_walks", "cbow_update", "skipgram_mean_combine")
S5_UNUSED = ("first_order_walks", "first_order_batch", "rejection_walks",
             "skipgram_nce_update", "mean_scatter", "mean_combine")
PQ_SKIPGRAM_KERNELS = ("nce_negatives", "ell_walks", "skipgram_nce_update",
                       "skipgram_mean_combine")
DEEPWALK_CBOW_KERNELS = ("first_order_batch", "cbow_update", "skipgram_mean_combine")
REJECTION_KERNELS = ("rejection_walks",)
# S6: LINE draws its batch with K14 and updates through K4 standalone; the
# siamese models draw theirs with K14 and scatter-add with index_add_. None
# launches a walk or K3, K11.
S6_LINE_KERNELS = ("line_mini_batch", "mean_scatter", "mean_combine")
S6_SIAMESE_KERNELS = ("siamese_mini_batch",)
S6_UNUSED = ("first_order_walks", "first_order_batch", "skipgram_nce_update", "ell_walks",
             "cbow_update")
# S7: Walklets SkipGram and CBOW step through the fused batch, K12 and K4's
# SkipGram combine; the GloVe models build their entries with K1 and K13a and step
# through K2's uniform draws and K13b's three launches, which update the
# tables in place; Role2Vec walks with K2 and K1 and updates through
# index_add_.
S7_K13B = ("glove_gradients", "glove_node_update", "glove_context_update")
S7_WALKLETS_KERNELS = ("first_order_batch", "walklets_update", "skipgram_mean_combine")
S7_WALKLETS_UNUSED = ("first_order_walks", "nce_negatives", "skipgram_nce_update",
                      "cbow_update", "ell_walks", "rejection_walks", "mean_scatter",
                      "mean_combine", "cooccurrences") + S7_K13B
S7_GLOVE_KERNELS = ("first_order_walks", "cooccurrences", "nce_negatives") + S7_K13B
S7_GLOVE_UNUSED = ("first_order_batch", "walklets_update", "skipgram_nce_update",
                   "skipgram_mean_combine", "mean_scatter", "mean_combine", "ell_walks",
                   "rejection_walks")
S7_ROLE2VEC_KERNELS = ("nce_negatives", "first_order_walks")
S7_ROLE2VEC_UNUSED = ("first_order_batch", "walklets_update", "skipgram_nce_update",
                      "cbow_update", "cooccurrences", "skipgram_mean_combine",
                      "ell_walks") + S7_K13B
# S8: SPINE relaxes with K15a; WINE hops, and RUBICONE and RUINE convolve,
# with K7; HyperSketching sketches with K16a and queries K16b; the GCN with
# lazy HyperSketching features adds K16 to its own kernels, and with a static
# edge-feature matrix K5's arc lookup.
# HyperSketching's fit takes K16a's singleton route and never the
# singletons launch: hop 1 from the node ids, then at its default precision
# 8 on the slice graph hop 2 by the hop launch (`hop2_route`), and by the
# id route at precision 12; hop 3 by the hop launch.
S8_SKETCH_KERNELS = ("sketch_hop1", "khop_sketches", "edge_sketch_features")
S8_SKETCH_HOP2_KERNELS = S8_SKETCH_KERNELS + ("sketch_hop2",)
S8_SPINE_KERNELS = ("min_plus_step",)
S8_SPINE_UNUSED = ("spmm", "hll_registers") + S8_SKETCH_HOP2_KERNELS
S8_CONV_KERNELS = ("spmm",)
S8_CONV_UNUSED = ("min_plus_step", "hll_registers") + S8_SKETCH_HOP2_KERNELS
S8_SKETCH_HOP2_UNUSED = ("min_plus_step", "spmm", "hll_registers")
S8_SKETCH_UNUSED = S8_SKETCH_HOP2_UNUSED + ("sketch_hop2",)
S8_GCN_KERNELS = S3_KERNELS + S8_SKETCH_KERNELS
S8_GCN_UNUSED = ("csr_edge_ids", "min_plus_step", "hll_registers", "sketch_hop2")
S8_GCN_STATIC_KERNELS = S3_KERNELS + ("csr_edge_ids",)
# S9: NodeSketch races with K18 (its candidate pass, then its race launch,
# each round) and RandNE hops with K7, each launching
# nothing else; the dense rows launch none of the port's kernels.
S9_SKETCH_KERNELS = ("sketch_candidates", "sketch_race_step")
S10_SKIPGRAM_KERNELS = ("nce_negatives", "ell_walks_typed", "skipgram_nce_update",
                        "skipgram_mean_combine")
S10_CBOW_KERNELS = ("nce_negatives", "ell_walks_typed", "cbow_update", "skipgram_mean_combine")
S10_GCN_KERNELS = ("edge_prediction_mini_batch", "spmm", "csr_edge_ids")
S9_RANDNE_KERNELS = ("spmm",)


S11_SHARDS = 4
S11_PAIR_WALKS = BATCH // 8
K17_TOL = dict(rtol=1e-5, atol=1e-5)   # sums over arcs in another order
S11_STEP_TOL = dict(rtol=1e-4, atol=1e-5)
S11_KERNELS = ("halo_spmm", "halo_spmm_backward", "sharded_spmm", "owned_gather",
               "owned_count", "owned_scatter")


def csr_bytes(k, d, n_rows_read) -> float:
    """Bytes a CSR product must move: the CSR once, each distinct input row
    it reads and each output row once."""
    return 4 * (k.row_ptr.numel() + 2 * k.n_arcs) + 4 * d * (n_rows_read + k.n_out)


def k17_checks(graph, tg, dev):
    """K17a-K17d against their plain versions on the slice graph's
    Symmetric Normalized Laplacian cut in 4 shards at D 128 (the halo
    buffers filled by indexing: the exchange in one process), the stacked
    shards and the summed edge-shard partials against K7 on the whole
    graph, and K17c / K17d at S1's batch on the S1 tables cut in 4 row
    shards. Returns (kernels entries, the partition's comm_rows and H,
    errors by check)."""
    from embiggen_tpu_torch.graph.laplacians import kernel_coo
    from embiggen_tpu_torch.ops.sharded import (
        owned_count, owned_count_plain, owned_gather, owned_gather_plain, owned_scatter,
        owned_scatter_plain,
    )
    from embiggen_tpu_torch.ops.spmm import csr_kernel, csr_spmm, csr_spmm_plain
    from embiggen_tpu_torch.ops.walks import first_order_walks
    from embiggen_tpu_torch.ops.negatives import nce_negatives
    from embiggen_tpu_torch.parallel import build_halo_partition, edge_shard_kernel
    from embiggen_tpu_torch.parallel.halo import (
        halo_spmm_local, halo_spmm_local_backward, halo_spmm_local_backward_plain,
        halo_spmm_local_plain,
    )

    p, n = S11_SHARDS, graph.number_of_nodes
    rows, cols, vals = kernel_coo(graph, "Symmetric Normalized Laplacian")
    t0 = time.perf_counter()
    part = build_halo_partition(rows, cols, vals, n, p, device=dev)
    build_s = time.perf_counter() - t0
    s, h = part.shard_size, part.halo_width
    rng = np.random.default_rng(31)
    x = torch.zeros((p * s, DIM), device=dev)
    x[:n] = torch.from_numpy(rng.standard_normal((n, DIM), dtype=np.float32)).to(dev)
    whole = csr_kernel(rows, cols, vals, n, device=dev, with_transpose=False)
    errs, outs = {}, []
    fwd = bwd = None
    for shard in range(p):
        halo = torch.cat([x[q * s + torch.from_numpy(part.send_idx[q, shard]).to(dev).long()]
                          for q in range(p)])
        x_local = x[shard * s:(shard + 1) * s]
        y = halo_spmm_local(part, shard, x_local, halo, "mean")
        g = torch.randn_like(y)
        back = halo_spmm_local_backward(part, shard, g, "mean")
        errs[f"K17a forward shard {shard}"] = check_close(
            f"K17a forward, shard {shard}", y,
            halo_spmm_local_plain(part, shard, x_local, halo, "mean"), **K17_TOL)
        errs[f"K17a backward shard {shard}"] = check_close(
            f"K17a backward, shard {shard}", back,
            halo_spmm_local_backward_plain(part, shard, g, "mean"), **K17_TOL)
        outs.append(y)
        if shard == 0:
            fwd, bwd = (x_local, halo, y), (g, back)
    errs["K17a shards against K7"] = check_close(
        "K17a's 4 shards against K7 whole", torch.cat(outs)[:n],
        csr_spmm(whole, x[:n], row_scale=1.0 / whole.abs_weight_sum.clamp(min=1e-9)),
        **K17_TOL)
    del outs
    # Shard 0's times; the library call is cuSPARSE on its CSR over the
    # two tables concatenated (what the one launch reads by column range).
    x_local, halo, _ = fwd
    g, _ = bwd
    sh = part.shards[0]
    xcat = torch.cat([x_local, halo])
    a = torch.sparse_csr_tensor(sh.kernel.row_ptr, sh.kernel.cols, sh.kernel.vals,
                                size=(s, s + p * h))
    at = sh.kernel.transpose
    a_t = torch.sparse_csr_tensor(at.row_ptr, at.cols, at.vals, size=(s + p * h, s))
    read = int(torch.unique(sh.kernel.cols).numel())
    entries = {
        "halo_spmm": dict(
            source="embiggen_tpu_torch/csrc/halo.cu",
            replaces="embiggen_tpu/parallel/halo.py:266",
            max_abs_err=max(v for k, v in errs.items() if "forward" in k or "K7" in k),
            ms=time_ms(lambda: halo_spmm_local(part, 0, x_local, halo, "mean"), 20),
            plain_ms=time_ms(lambda: halo_spmm_local_plain(part, 0, x_local, halo, "mean"), 3),
            library_ms=time_ms(lambda: torch.sparse.mm(a, xcat), 20),
            library="torch.sparse.mm (cuSPARSE) on the shard's CSR",
            **bound(csr_bytes(sh.kernel, DIM, read), 2 * sh.kernel.n_arcs * DIM)),
        "halo_spmm_backward": dict(
            source="embiggen_tpu_torch/csrc/halo.cu",
            replaces="embiggen_tpu/parallel/halo.py:321",
            max_abs_err=max(v for k, v in errs.items() if "backward" in k),
            ms=time_ms(lambda: halo_spmm_local_backward(part, 0, g, "mean"), 20),
            plain_ms=time_ms(lambda: halo_spmm_local_backward_plain(part, 0, g, "mean"), 3),
            library_ms=time_ms(lambda: torch.sparse.mm(a_t, g), 20),
            library="torch.sparse.mm (cuSPARSE) on the shard's transposed CSR",
            **bound(csr_bytes(at, DIM, int(torch.unique(at.cols).numel())),
                    2 * at.n_arcs * DIM)),
    }
    del xcat, a, a_t, fwd, bwd
    info = dict(comm_rows=part.comm_rows, halo_width=h, shard_rows=s,
                shard_arcs=[part.shards[q].kernel.n_arcs for q in range(p)],
                partition_s=build_s)
    del part
    torch.cuda.empty_cache()

    # K17b: each edge shard's partial product; their sum is K7's.
    total = torch.zeros((n, DIM), device=dev)
    xn = x[:n].contiguous()
    for shard in range(p):
        k = edge_shard_kernel(rows, cols, vals, n, p, shard, device=dev)
        part_out = csr_spmm(k, xn, counter="sharded_spmm")
        errs[f"K17b shard {shard}"] = check_close(
            f"K17b, edge shard {shard}", part_out, csr_spmm_plain(k, xn), **K17_TOL)
        total += part_out
        if shard == 0:
            k0 = k
    errs["K17b sum against K7"] = check_close("K17b's 4 partials summed against K7 whole",
                                              total, csr_spmm(whole, xn), **K17_TOL)
    a0 = torch.sparse_csr_tensor(k0.row_ptr, k0.cols, k0.vals, size=(n, n))
    entries["sharded_spmm"] = dict(
        source="embiggen_tpu_torch/csrc/spmm.cu",
        replaces="embiggen_tpu/parallel/spmm.py:38",
        max_abs_err=max(v for k, v in errs.items() if "K17b" in k),
        ms=time_ms(lambda: csr_spmm(k0, xn, counter=None), 20),
        plain_ms=time_ms(lambda: csr_spmm_plain(k0, xn), 3),
        library_ms=time_ms(lambda: torch.sparse.mm(a0, xn), 20),
        library="torch.sparse.mm (cuSPARSE) on the edge shard's CSR",
        **bound(csr_bytes(k0, DIM, int(torch.unique(k0.cols).numel())),
                2 * k0.n_arcs * DIM))
    del total, xn, x, whole, a0, k0
    torch.cuda.empty_cache()

    # K17c and K17d at S1's batch: the distinct ids of 32768 walks of 64
    # and their 10 negatives each, on [1M, 128] tables in 4 row shards.
    gen = torch.Generator().manual_seed(31)
    starts = nce_negatives(tg, gen, (BATCH,), scale_free=False)
    walks = first_order_walks(tg, starts, WALK, gen)
    negs = nce_negatives(tg, gen, (BATCH, NEGS))
    uniq, counts = torch.unique(torch.cat([walks.reshape(-1), negs.reshape(-1)]),
                                return_counts=True)
    uniq, counts = uniq.int(), counts.float()
    u = uniq.shape[0]
    s = -(-n // p)
    table = torch.from_numpy(rng.standard_normal((p * s, DIM), dtype=np.float32)).to(dev)
    grads = torch.from_numpy(rng.standard_normal((u, DIM), dtype=np.float32)).to(dev)
    gathered = torch.zeros((u, DIM), device=dev)
    for shard in range(p):
        rows_p = owned_gather(table[shard * s:(shard + 1) * s], shard * s, uniq)
        errs[f"K17d shard {shard}"] = check_close(
            f"K17d, shard {shard}", rows_p,
            owned_gather_plain(table[shard * s:(shard + 1) * s], shard * s, uniq), 0.0, 0.0)
        gathered += rows_p
        got = owned_scatter(table[shard * s:(shard + 1) * s].clone(), shard * s, uniq, grads,
                            -0.025, entry_den=counts)
        want = owned_scatter_plain(table[shard * s:(shard + 1) * s].clone(), shard * s, uniq,
                                   grads, -0.025, entry_den=counts)
        errs[f"K17c shard {shard}"] = check_close(f"K17c, shard {shard}", got, want, 0.0, 1e-6)
    errs["K17d shards summed"] = check_close("K17d's shards summed against table[ids]",
                                             gathered, table[uniq.long()], 0.0, 0.0)
    # K17c's count launch (the row-sharded mean scatter's denominators) on
    # the batch's ids with their repeats, then the scatter by those counts.
    ids = torch.cat([walks.reshape(-1), negs.reshape(-1)]).int().contiguous()
    row_grads = torch.randn((ids.shape[0], DIM), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(31))
    for shard in range(p):
        got_c = owned_count(torch.zeros(s, device=dev), shard * s, ids)
        want_c = owned_count_plain(torch.zeros(s, device=dev), shard * s, ids)
        errs[f"K17c count shard {shard}"] = check_close(f"K17c's count, shard {shard}", got_c,
                                                        want_c, 0.0, 0.0)
        got = owned_scatter(table[shard * s:(shard + 1) * s].clone(), shard * s, ids,
                            row_grads, -0.025, row_den=got_c)
        want = owned_scatter_plain(table[shard * s:(shard + 1) * s].clone(), shard * s, ids,
                                   row_grads, -0.025, row_den=want_c)
        # Repeated ids add in no fixed order.
        errs[f"K17c by row counts shard {shard}"] = check_close(
            f"K17c by row counts, shard {shard}", got, want, 1e-5, 1e-5)
    del got, want, got_c, want_c, row_grads
    shard0 = table[:s].contiguous()
    owned = int(((uniq >= 0) & (uniq < s)).sum())
    local = uniq[:owned].long()   # uniq is sorted: shard 0's ids come first
    scaled = -0.025 * (grads[:owned] / counts[:owned, None])
    entries["owned_gather"] = dict(
        source="embiggen_tpu_torch/csrc/sharded.cu",
        replaces="embiggen_tpu/parallel/sharded_table.py:68",
        max_abs_err=max(v for k, v in errs.items() if "K17d" in k),
        ms=time_ms(lambda: owned_gather(shard0, 0, uniq), 20),
        plain_ms=time_ms(lambda: owned_gather_plain(shard0, 0, uniq), 20),
        library_ms=None,
        # the ids read, the owned rows read, [U, D] written
        **bound(4 * u + 4 * DIM * (owned + u), 0))
    entries["owned_scatter"] = dict(
        source="embiggen_tpu_torch/csrc/sharded.cu",
        replaces="embiggen_tpu/parallel/sharded_table.py:84",
        max_abs_err=max(v for k, v in errs.items() if "K17c" in k),
        ms=time_ms(lambda: owned_scatter(shard0, 0, uniq, grads, -0.025, entry_den=counts),
                   20),
        plain_ms=time_ms(lambda: owned_scatter_plain(shard0, 0, uniq, grads, -0.025,
                                                     entry_den=counts), 20),
        library_ms=time_ms(lambda: shard0.index_add_(0, local, scaled), 20),
        library="index_add_ of the owned rows' scaled gradients",
        # the ids read; per owned entry its gradient row and count read and
        # its table row read and written
        **bound(4 * u + owned * (4 * DIM + 4 + 8 * DIM), 2 * DIM * owned))
    in_shard0 = ids < s
    owned_m = int(in_shard0.sum())
    counts0 = torch.zeros(s, device=dev)
    local_m, ones = ids[in_shard0].long(), torch.ones(owned_m, device=dev)
    entries["owned_count"] = dict(
        source="embiggen_tpu_torch/csrc/sharded.cu",
        replaces="embiggen_tpu/parallel/sharded_table.py:97",
        max_abs_err=max(v for k, v in errs.items() if "count" in k),
        ms=time_ms(lambda: owned_count(counts0, 0, ids), 20),
        plain_ms=time_ms(lambda: owned_count_plain(counts0, 0, ids), 20),
        # No one PyTorch call tests ownership and counts; index_add_ of
        # ones, handed the owned ids already picked, does less.
        library_ms=None,
        library="none: no one call tests ownership and counts",
        picked_index_add_ms=time_ms(lambda: counts0.index_add_(0, local_m, ones), 20),
        # the ids read; each distinct owned row's count read and written;
        # one add an owned entry
        **bound(4 * ids.shape[0] + 8 * owned, owned_m))
    info.update(batch_ids=u, shard0_owned=owned, batch_entries=int(ids.shape[0]))
    del table, grads, gathered, shard0, scaled, ids, counts0, local_m, ones
    torch.cuda.empty_cache()
    return entries, info, errs


def pair_step_autograd(params, contexts, words, negs, lr):
    """The functional SkipGram steps' update by autograd on the whole
    tables, in place: the NCE pair loss's dense gradients, independent of
    `nce_pair_grads`' adjoints and of K17c. Returns the loss."""
    import torch.nn.functional as F

    leaves = [params[k].clone().requires_grad_()
              for k in ("node_embedding", "context_embedding", "context_bias")]
    emb, ctx, bias = leaves
    c, w, ng = contexts.long(), words.long(), negs.long()
    rows = emb[w]
    pos = (rows[:, None, :] * ctx[c]).sum(-1) + bias[c]
    neg = rows @ ctx[ng].T + bias[ng][None, :]
    loss = (F.softplus(-pos).sum() + F.softplus(neg).sum()) / w.shape[0]
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        for k, g in zip(("node_embedding", "context_embedding", "context_bias"), grads):
            params[k].sub_(lr * g)
    return loss.detach()


def s11_runs(graph, tg, dev, backend="nccl"):
    """S11 on a one-rank process group (NCCL on the card): each
    distributed path built with the one-rank Mesh, held to a reference on
    the same batch (the single-device step, K7's encoder, or the autograd
    step), then 3 steps timed. The counts are set to 0 after the
    reference and read after the path's own held and timed steps; each
    path must launch the kernels it names and none of those it must not.
    Returns ({path: ms a step}, {path: largest error}, {path: its launches})."""
    import tempfile

    import torch.distributed as dist
    import torch.nn.functional as F

    from embiggen_tpu_torch.graph.laplacians import kernel_coo
    from embiggen_tpu_torch.models import get_model_from_library
    from embiggen_tpu_torch.models.embedders import GloVe, WalkletsGloVe
    from embiggen_tpu_torch.models.embedders.glove import glove_dp_step
    from embiggen_tpu_torch.models.gcn.core import GCNEncoder
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.ops.glove import (
        GloVeStepWorkspace, cooccurrences, draw_entries, glove_entries,
    )
    from embiggen_tpu_torch.ops.negatives import edge_prediction_mini_batch
    from embiggen_tpu_torch.ops.spmm import csr_kernel, csr_spmm, spmm
    from embiggen_tpu_torch.parallel import (
        edge_shard_kernel, halo_spmm, make_dp_skipgram_step, make_mesh,
        make_row_sharded_skipgram_step, make_sharded_gcn_edge_step,
        make_sharded_skipgram_step, shard_features, sharded_spmm,
    )
    from embiggen_tpu_torch.parallel.sharded_table import draw_pair_batch

    import os

    store = tempfile.mkdtemp()
    # The one-rank group needs no network; NCCL's bootstrap may still look
    # for an interface, and the loopback one is always there.
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"file://{store}/store", rank=0,
                            world_size=1)
    ms, errs, launches = {}, {}, {}
    try:
        mesh = make_mesh(device=dev)
        n = graph.number_of_nodes
        rng = np.random.default_rng(32)

        def tables():
            scale = np.float32(1.0 / np.sqrt(DIM))
            return {"node_embedding": torch.from_numpy(rng.standard_normal(
                        (n, DIM), dtype=np.float32) * scale).to(dev),
                    "context_embedding": torch.from_numpy(rng.standard_normal(
                        (n, DIM), dtype=np.float32) * scale).to(dev),
                    "context_bias": torch.zeros(n, device=dev)}

        def own_runs(name, held, check, again, needs, unused=()):
            """The path's own runs, its reference having run: the counts
            set to 0, `held()` (the step held to the reference), `check()`
            (no launches; returns the largest error), 3 timed `again()`
            steps, then the counts read and checked."""
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            held()
            errs[name] = check()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                again()
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) / 3 * 1e3
            counts = _build.launch_counts()
            check_launches(name, counts, needs, unused)
            launches[name] = {k: v for k, v in counts.items() if v}

        def tables_close(name, got, want, keys=None):
            return max(check_close(f"{name}, {k}", got[k], want[k], **S11_STEP_TOL)
                       for k in (keys or want))

        # The functional SkipGram steps at S1's widths and a batch of
        # S11_PAIR_WALKS walks, each against the autograd step on the same
        # batch.
        kw = dict(batch_size=S11_PAIR_WALKS, walk_length=WALK, window_size=WINDOW,
                  number_of_negative_samples=NEGS)
        gen = torch.Generator().manual_seed(32)
        batch = draw_pair_batch(tg, gen, S11_PAIR_WALKS, WALK, WINDOW,
                                number_of_negative_samples=NEGS)
        for name, make, needs in (
                ("make_dp_skipgram_step", make_dp_skipgram_step, ("owned_scatter",)),
                ("make_row_sharded_skipgram_step", make_row_sharded_skipgram_step,
                 ("owned_gather", "owned_scatter")),
                ("make_sharded_skipgram_step", make_sharded_skipgram_step, ("owned_scatter",))):
            params = tables()
            want = {k: v.clone() for k, v in params.items()}
            want_loss = pair_step_autograd(want, *batch, 0.025)
            step = make(mesh, tg, **kw)
            got = {}

            def held():
                with torch.no_grad():
                    got["loss"] = step(params, None, 0.025, batch=batch)

            def check():
                check_close(f"{name}, loss", got["loss"].reshape(1), want_loss.reshape(1),
                            **S11_STEP_TOL)
                return tables_close(name, params, want)

            def again():
                with torch.no_grad():
                    step(params, gen, 0.025)

            own_runs(name, held, check, again, needs)
            del params, want
        del batch
        torch.cuda.empty_cache()

        # The SpMMs at S3's: the edge-sharded one (one shard: the whole
        # graph) and the halo SpMM forward and backward against K7.
        rows, cols, vals = kernel_coo(graph, "Symmetric Normalized Laplacian")
        whole = csr_kernel(rows, cols, vals, n, device=dev)
        x = torch.from_numpy(rng.standard_normal((n, DIM), dtype=np.float32)).to(dev)
        want = csr_spmm(whole, x)
        k = edge_shard_kernel(rows, cols, vals, n, 1, 0, device=dev)
        got = {}

        def held():
            got["y"] = sharded_spmm(mesh, k, x)

        own_runs("sharded_spmm", held,
                 lambda: check_close("sharded_spmm against K7", got["y"], want, **K17_TOL),
                 lambda: sharded_spmm(mesh, k, x), ("sharded_spmm",), ("spmm",))
        del k, want, got
        # The GCN encoder over the mesh (GCNEncoder.enable_halo: the edge
        # GCN's convolutions, with dropout) against the same encoder
        # through K7, forward and gradients; its HaloPartition (built by
        # build_kernels) also serves the functional halo paths below.
        encoders = [GCNEncoder(["Symmetric Normalized Laplacian"], [DIM], dropout_rate=0.5)
                    for _ in range(2)]
        encoders[1].enable_halo(mesh)
        k7_kernels = encoders[0].build_kernels(graph, dev)
        halo_kernels = encoders[1].build_kernels(graph, dev)
        part = halo_kernels[0]
        layer = encoders[0].init(torch.Generator().manual_seed(3), DIM)["kernels"][0][0]
        w0, b0 = layer["w"].to(dev), layer["b"].to(dev)
        g = torch.randn((n, DIM), device=dev)

        def encode(enc, kernels):
            w, b, xx = (t.clone().requires_grad_() for t in (w0, b0, x))
            y = enc.apply({"kernels": [[{"w": w, "b": b}]]}, kernels, xx, n, training=True,
                          generator=torch.Generator(device=dev).manual_seed(5))
            return (y.detach(),) + torch.autograd.grad(y, (w, b, xx), g)

        want, got = encode(encoders[0], k7_kernels), {}

        def held():
            got["enc"] = encode(encoders[1], halo_kernels)

        own_runs("GCNEncoder.enable_halo", held, lambda: max(
                     check_close(f"halo GCN encoder against K7's, {what}", a, b,
                                 **S11_STEP_TOL)
                     for what, a, b in zip(("output", "dw", "db", "dx"), got["enc"], want)),
                 lambda: encode(encoders[1], halo_kernels),
                 ("halo_spmm", "halo_spmm_backward", "owned_gather", "owned_scatter"),
                 ("spmm",))
        del want, got, encoders, k7_kernels, halo_kernels
        x_local = shard_features(x, part, mesh).requires_grad_()
        xw = x.clone().requires_grad_()
        yw = spmm(whole, xw, "mean")
        (dxw,) = torch.autograd.grad(yw, xw, g)
        got = {}

        def held():
            y = halo_spmm(mesh, part, x_local, "mean")
            got["y"] = y.detach()
            (got["dx"],) = torch.autograd.grad(y, x_local, g)

        own_runs("halo_spmm forward and backward", held, lambda: max(
                     check_close("halo_spmm against K7", got["y"], yw.detach(), **K17_TOL),
                     check_close("halo_spmm's backward against K7's", got["dx"], dxw,
                                 **K17_TOL)),
                 lambda: torch.autograd.grad(halo_spmm(mesh, part, x_local, "mean"), x_local, g),
                 ("halo_spmm", "halo_spmm_backward", "owned_gather", "owned_scatter"),
                 ("spmm",))
        del yw, dxw, xw, got

        # The sharded GCN edge step (units 128, batch 2^20) against the
        # same model through K7 with autograd on one device.
        lr = 0.01
        init, gcn_step = make_sharded_gcn_edge_step(mesh, part, x_local.detach(), tg,
                                                    units=[DIM], batch_size=GCN_BATCH,
                                                    learning_rate=lr)
        gcn_params = init(torch.Generator().manual_seed(0))
        leaves = [gcn_params["conv"][0]["w"], gcn_params["conv"][0]["b"],
                  gcn_params["head"]["w"], gcn_params["head"]["b"]]
        before = [t.clone().requires_grad_() for t in leaves]
        src, dst, labels = edge_prediction_mini_batch(tg, torch.Generator().manual_seed(1),
                                                      GCN_BATCH, 0.5, True)
        hh = torch.relu(spmm(whole, x) @ before[0] + before[1])
        logits = (hh[src.long()] * hh[dst.long()]) @ before[2] + before[3]
        want = torch.autograd.grad((F.softplus(logits) - labels * logits).mean(), before)
        del hh, logits, src, dst, labels
        gen = torch.Generator().manual_seed(2)
        own_runs("make_sharded_gcn_edge_step",
                 lambda: gcn_step(gcn_params, torch.Generator().manual_seed(1)),
                 lambda: max(check_close("sharded GCN step against K7's autograd",
                                         (b.detach() - a) / lr, w, **S11_STEP_TOL)
                             for b, a, w in zip(before, leaves, want)),
                 lambda: gcn_step(gcn_params, gen),
                 # One layer on fixed features: nothing asks for A x's
                 # gradient, so the halo SpMM's backward never runs.
                 ("edge_prediction_mini_batch", "halo_spmm", "owned_gather"),
                 ("spmm", "halo_spmm_backward"))
        del before, want, part, x_local, g, x, whole, gcn_params, leaves
        torch.cuda.empty_cache()

        # The models' distributed steps, built with the one-rank mesh (one
        # rank owns every row: its shards are the whole tables), each
        # against `_step` on the same batch.
        def model_paths(label, model, ctx, tables_of, batch, paths, lr=0.025):
            for kind, make, needs, unused in paths:
                params = tables_of()
                want = {k: t.clone() for k, t in params.items()}
                with torch.no_grad():
                    model._step(ctx, want, gen, lr, batch=batch)
                step = make(params)
                name = f"{label} _make_{kind}_step"

                def held():
                    with torch.no_grad():
                        step(ctx, params, gen, lr, batch=batch)

                def again():
                    with torch.no_grad():
                        step(ctx, params, gen, lr)

                own_runs(name, held, lambda: tables_close(name, params, want), again,
                         needs, unused)
                del params, want

        gen = torch.Generator().manual_seed(33)
        compact = ("owned_gather", "owned_scatter")
        walk_unused = ("skipgram_mean_combine", "mean_scatter", "mean_combine")
        for name, update, kwargs, kinds in (
                ("Node2Vec SkipGram", "skipgram_nce_update", {}, ("dp", "row_sharded")),
                ("Node2Vec CBOW", "cbow_update", {}, ("dp", "row_sharded")),
                ("Walklets SkipGram", "walklets_update", S7_WALKLETS, ("dp",))):
            model = get_model_from_library(name, task_name="Node Embedding")(
                **(kwargs or dict(embedding_size=DIM, walk_length=WALK, window_size=WINDOW,
                                  number_of_negative_samples=NEGS)),
                random_state=0, device=dev)
            model._run_batch_size = BATCH
            makers = {"dp": lambda p, m=model: m._make_dp_step(mesh, BATCH),
                      "row_sharded": lambda p, m=model: m._make_row_sharded_step(mesh, BATCH)}
            model_paths(name, model, tg,
                        lambda m=model: m._initial_tables(graph, torch.Generator().manual_seed(0)),
                        # The draws live in a block the next draw overwrites.
                        tuple(t.clone() for t in model._sample_batch(tg, gen, BATCH)),
                        [(kind, makers[kind], ("owned_gather", update, "owned_scatter"),
                          walk_unused) for kind in kinds])
            del model
        role2vec = get_model_from_library("Role2Vec", task_name="Node Embedding")(
            random_state=0, device=dev, **S7_ROLE2VEC)
        role2vec._run_batch_size = role2vec._resolve_batch(graph)
        role_tables = role2vec._initial_tables(graph, torch.Generator().manual_seed(0))
        model_paths("Role2Vec", role2vec, tg, lambda: {k: t.clone() for k, t in
                                                       role_tables.items()},
                    role2vec._sample_role_pairs(tg, gen),
                    [("dp", lambda p: role2vec._make_dp_step(mesh, role2vec._run_batch_size),
                      ("first_order_walks",), walk_unused)])
        del role2vec, role_tables
        torch.cuda.empty_cache()

        # LINE and TransE (the siamese rows) at S6's batch.
        typed = minibatch_graph(graph, S6_TYPES)
        for name, g_ in (("Second-order LINE", graph), ("TransE", typed)):
            model = get_model_from_library(name, task_name="Node Embedding")(
                embedding_size=DIM, batch_size=S6_BATCH, random_state=0, device=dev)
            model._run_batch_size = S6_BATCH
            ctx = model._prepare_data(g_)
            sliceable, shared = model._sample_batch(ctx, gen, S6_BATCH)
            # The draws live in a block the next draw overwrites.
            batch = (sliceable.clone() if torch.is_tensor(sliceable)
                     else tuple(t.clone() for t in sliceable), shared)
            tables_of = lambda m=model, g_=g_: m._initial_tables(  # noqa: E731
                g_, torch.Generator().manual_seed(0))
            row_keys = model._row_sharded_keys(g_, tables_of())
            line = name.endswith("LINE")
            sampler = "line_mini_batch" if line else "siamese_mini_batch"
            model_paths(name, model, ctx, tables_of, batch, [
                ("dp", lambda p, m=model: m._make_dp_step(mesh, S6_BATCH),
                 (sampler, "mean_scatter", "mean_combine") if line else (sampler,), ()),
                ("row_sharded",
                 lambda p, m=model, keys=row_keys: m._make_row_sharded_step(mesh, S6_BATCH,
                                                                            keys),
                 (sampler, "owned_count") + compact if line else (sampler,) + compact,
                 ("mean_scatter", "mean_combine") if line else ())])
            model._free_fit_buffers()
            del model, ctx, batch, sliceable, shared
        del typed
        torch.cuda.empty_cache()

        # GloVe (data-parallel and row-sharded) and Walklets GloVe's
        # data-parallel step (`glove_dp_step` on a power's tables) at S7's.
        glove = GloVe(device=dev, random_state=0, **S7_GLOVE)
        entries = glove._prepare_data(graph)
        size = glove._run_batch_size = glove._resolve_batch_size(graph, entries)
        glove_tables = glove._initial_tables(graph, torch.Generator().manual_seed(0))
        keys = glove._row_sharded_keys(graph, glove_tables)
        model_paths("Node2Vec GloVe", glove, entries,
                    lambda: {k: t.clone() for k, t in glove_tables.items()},
                    glove._sample_batch(entries, gen, size), [
                        ("dp", lambda p: glove._make_dp_step(mesh, size), S7_K13B, ()),
                        ("row_sharded", lambda p: glove._make_row_sharded_step(mesh, size, keys),
                         ("owned_gather", "glove_gradients", "owned_scatter"),
                         ("glove_node_update", "glove_context_update"))], lr=0.05)
        glove._free_fit_buffers()
        del glove, entries, glove_tables
        walklets = WalkletsGloVe(device=dev, random_state=0, **S7_WALKLETS_GLOVE)
        stacked = walklets._init_params(graph, torch.Generator().manual_seed(0))
        walks = glove_walks(graph, dev, GLOVE_WALK, 0)
        stride1 = glove_entries(*cooccurrences(walks, N_NODES, [(1, 1.0)]), 100.0, 0.75)
        del walks
        size = min(S7_WALKLETS_GLOVE["batch_size"], stride1.n_entries)
        ids = draw_entries(stride1, size, gen)
        power0 = lambda t: [t["node_embedding"][0], t["context_embedding"][0],  # noqa: E731
                            t["context_bias"][0], torch.zeros_like(t["context_bias"][0])]
        want_tables = power0({k: t.clone() for k, t in stacked.items()})
        walklets._glove_step(dict(zip(("emb", "ctx", "bw", "bc"), want_tables)), stride1, ids,
                             0.05, GloVeStepWorkspace.empty(size, DIM // WALKLETS_POWER, dev))
        got_tables = power0(stacked)
        ws = GloVeStepWorkspace.empty(size // mesh.size, DIM // WALKLETS_POWER, dev)
        own_runs("Walklets GloVe glove_dp_step",
                 lambda: glove_dp_step(mesh, stride1, ids, got_tables, 0.05, ws),
                 lambda: max(check_close(f"Walklets GloVe glove_dp_step, table {i}", a, b,
                                         **S11_STEP_TOL)
                             for i, (a, b) in enumerate(zip(got_tables, want_tables))),
                 lambda: glove_dp_step(mesh, stride1, draw_entries(stride1, size, gen),
                                       got_tables, 0.05, ws), S7_K13B)
        del walklets, stacked, stride1, ids, want_tables, got_tables, ws
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return ms, errs, launches


# ------------------------------------------------------------ K20 and S12
K20_TOL = dict(rtol=1e-5, atol=1e-5)   # K20a: sums over D in another order
K20_SLOTS = (1 << 15, 1 << 20)
K20_KERNELS = ("sddmm", "edge_chunk", "chunk_mask")
# S12: the 21 KGE rows on the typed slice graph (types arange(E) % 8, as
# bench.py types them) at D 128 and batch 65536, one epoch (305 steps)
# cut to S12_STEPS steps (the 5 steady steps timed after it need no
# more; a whole epoch of the 21 rows took most of phase 34's 127 s);
# NodePiece at its defaults (256 anchors, 8 tokens), ConvE at its 8
# filters. The injected steps run at D 128 on a small typed graph; the
# ranking check is tests/test_kge.py's at its own smoke sizes and step
# sizes.
S12_STEPS = 20
S12_STEP_TOL = dict(rtol=1e-4, atol=1e-5)
S12_PROFILE_STEPS = 5
S12_RANK_STEPS = 300
S12_RANK_LR = {"ERMLP": 0.3, "ERMLPE": 0.2, "ConvE": 0.2}
S12_KERNELS = ("siamese_mini_batch",)
S12_UNUSED = ("first_order_walks", "first_order_batch", "skipgram_nce_update", "ell_walks",
              "cbow_update", "mean_scatter", "line_mini_batch", "walklets_update")


def k20_checks(graph, tg, dev):
    """Phase 33: K20a (`sddmm`) against its plain version over the slice
    graph's 20M arcs on S1-shaped tables [1M, 128] (rtol / atol 1e-5), also
    at an odd storage offset, at D 127, with int64 ids, and its backward on
    the first 2^20 arcs against autograd of the plain gathers; K20b
    (`edge_chunk`, `chunk_mask`) exactly at 2^15 and 2^20 slots, chunk 0, a
    middle chunk, the last (clamped) and one past the end, with the exported
    sources and with the row_ptr search. Then the path K20 serves, scoring
    every arc in chunks of 2^20 (`edge_chunk`, `chunk_mask`, `sddmm`), with
    the counts set to 0 before and read after, its scores equal to the
    whole sddmm's. Returns ({kernel: entry}, {check: error}, launches)."""
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.ops.negatives import (
        chunk_mask, chunk_mask_plain, edge_chunk, edge_chunk_plain,
    )
    from embiggen_tpu_torch.ops.spmm import sddmm, sddmm_plain

    gen = torch.Generator(device=dev).manual_seed(33)
    n, e = tg.n_nodes, tg.n_arcs
    a = torch.randn(n, DIM, generator=gen, device=dev).mul_(DIM ** -0.5)
    b = torch.randn(n, DIM, generator=gen, device=dev).mul_(DIM ** -0.5)
    rows, cols = tg.sources, tg.col_idx
    errs = {}
    got = sddmm(rows, cols, a, b)
    want = sddmm_plain(rows, cols, a, b)
    errs["sddmm D 128"] = check_close("K20a at D 128", got, want, **K20_TOL)
    odd = torch.cat([a.new_zeros(1), a.reshape(-1)])[1:].view(a.shape)
    assert odd.data_ptr() % 16
    errs["sddmm odd offset"] = check_close("K20a at an odd offset", sddmm(rows, cols, odd, b),
                                           want, **K20_TOL)
    del odd
    a127, b127 = a[:, :127].contiguous(), b[:, :127].contiguous()
    errs["sddmm D 127"] = check_close("K20a at D 127", sddmm(rows, cols, a127, b127),
                                      sddmm_plain(rows, cols, a127, b127), **K20_TOL)
    del a127, b127
    errs["sddmm int64 ids"] = check_close("K20a with int64 ids",
                                          sddmm(rows.long(), cols.long(), a, b), want, **K20_TOL)
    sub = slice(0, min(1 << 20, e))
    w = torch.randn(sub.stop, generator=gen, device=dev)
    grads = {}
    for route in ("kernel", "plain"):
        xa, xb = a.clone().requires_grad_(), b.clone().requires_grad_()
        with torch.enable_grad():
            s = (sddmm(rows[sub], cols[sub], xa, xb) if route == "kernel"
                 else (xa[rows[sub].long()] * xb[cols[sub].long()]).sum(-1))
            grads[route] = torch.autograd.grad((s * w).sum(), (xa, xb))
    for side, g, gw in zip("ab", grads["kernel"], grads["plain"]):
        errs[f"sddmm backward d{side}"] = check_close(f"K20a's backward d{side}", g, gw,
                                                      **K20_TOL)
    del grads, xa, xb, s
    torch.cuda.synchronize()
    ms = time_ms(lambda: sddmm(rows, cols, a, b), 20)
    plain_ms = time_ms(lambda: sddmm_plain(rows, cols, a, b), 3)
    distinct = [int((torch.bincount(x, minlength=n) > 0).sum()) for x in (rows, cols)]
    library, library_ms = "torch.sparse.sampled_addmm (cuSPARSE SDDMM)", None
    csr = torch.sparse_csr_tensor(tg.row_ptr, cols, torch.zeros(e, device=dev), size=(n, n))
    try:
        lib = torch.sparse.sampled_addmm(csr, a, b.t(), beta=0.0).values()
    except RuntimeError as err:  # the yardstick only; the port never calls it
        library = f"torch.sparse.sampled_addmm refused: {str(err)[:120]}"
    else:
        errs["sampled_addmm"] = check_close("sampled_addmm against K20a", lib, got, **K20_TOL)
        del lib
        library_ms = time_ms(lambda: torch.sparse.sampled_addmm(csr, a, b.t(), beta=0.0), 5)
    entries = {"sddmm": dict(
        source="embiggen_tpu_torch/csrc/sddmm.cu",
        replaces="embiggen_tpu/ops/spmm.py:108 (sddmm)",
        max_abs_err=max(v for k, v in errs.items() if k.startswith("sddmm")), ms=ms,
        plain_ms=plain_ms, library_ms=library_ms, library=library,
        distinct_rows=distinct,
        **bound(4 * 3 * e + 4 * DIM * sum(distinct), 2 * DIM * e))}
    del csr
    # K20b exactly, with and without the exported sources.
    routes = {"sources": tg, "search": graph.device(dev)}
    for route, g in routes.items():
        for size in K20_SLOTS:
            last = (e - 1) // size
            for i in (0, last // 2, last, last + 1):
                src, dst = edge_chunk(g, i, size)
                ws, wd = edge_chunk_plain(g, i, size)
                if not (torch.equal(src, ws) and torch.equal(dst, wd)
                        and torch.equal(chunk_mask(g, i, size), chunk_mask_plain(g, i, size))):
                    raise AssertionError(f"K20b differs from its plain version ({route}, "
                                         f"{size} slots, chunk {i})")
    errs["edge_chunk, chunk_mask"] = 0.0
    size, mid = K20_SLOTS[-1], (e // K20_SLOTS[-1]) // 2
    for name, fn, plain, nbytes in (
            ("edge_chunk", edge_chunk, edge_chunk_plain, 16 * size),
            ("chunk_mask", chunk_mask, chunk_mask_plain, size)):
        entries[name] = dict(
            source="embiggen_tpu_torch/csrc/edges.cu",
            replaces=("embiggen_tpu/ops/negatives.py:198 (edge_chunk)" if name == "edge_chunk"
                      else "embiggen_tpu/ops/negatives.py:210 (chunk_mask)"),
            max_abs_err=0.0, ms=time_ms(lambda: fn(tg, mid, size), 50),
            plain_ms=time_ms(lambda: plain(tg, mid, size), 20),
            search_ms=time_ms(lambda: fn(routes["search"], mid, size), 50),
            library_ms=None, library=None, slots=size, **bound(nbytes, 0))
    del routes
    # The path: every arc scored in chunks.
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    scores = []
    for i in range(-(-e // size)):
        src, dst = edge_chunk(tg, i, size)
        scores.append(sddmm(src, dst, a, b)[chunk_mask(tg, i, size)])
    torch.cuda.synchronize()
    launches = check_launches("K20", _build.launch_counts(), K20_KERNELS)
    if not torch.equal(torch.cat(scores), got):
        raise AssertionError("the chunked scores differ from the whole sddmm's")
    del a, b, got, want, scores
    torch.cuda.empty_cache()
    return entries, errs, launches


def s12_injected_steps(dev):
    """One injected step of every KGE row at D 128 (NodePiece with its
    K15a tokens from its default 256 anchors) on the card and on the CPU
    from the same tables, on a small typed graph with batch 256. Returns
    {row: largest difference}."""
    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.models.embedders import KGE_MODELS

    small = minibatch_graph(erdos_renyi(2000, 10_000, seed=5), 3)
    rng = np.random.default_rng(12)
    block = np.stack([rng.integers(0, small.number_of_nodes, 256) for _ in range(4)]
                     + [rng.integers(0, 3, 256)]).astype(np.int32)
    errs = {}
    for cls in KGE_MODELS:
        name = cls.model_name()
        models = {d: cls(device=d, embedding_size=DIM, random_state=0) for d in (dev, "cpu")}
        init = models["cpu"]._init_params(small, torch.Generator().manual_seed(0))
        params = {d: {k: v.to(d).clone() for k, v in init.items()} for d in models}
        ctx = {d: m._prepare_data(small) for d, m in models.items()}
        if name == "NodePiece" and not torch.equal(ctx[dev]["tokens"].cpu(),
                                                   ctx["cpu"]["tokens"]):
            raise AssertionError("NodePiece's tokens from K15a differ from the CPU's")
        with torch.no_grad():
            for d, m in models.items():
                m._run_batch_size = 256
                shared = (ctx[d]["tokens"],) if name == "NodePiece" else ()
                m._step(ctx[d], params[d], torch.Generator(), 0.05,
                        batch=(torch.from_numpy(block).to(d), shared))
        errs[name] = max(check_close(f"an injected {name} step, {k}", params[dev][k].cpu(),
                                     params["cpu"][k], **S12_STEP_TOL) for k in init)
    return errs


def s12_ranking_on_card(dev):
    """tests/test_kge.py's `test_kge_ranks_positive_triples` on the card
    for every row: smoke sizes on typed karate, 300 steps at its step
    sizes, the mean distance of the graph's triples below that of the same
    heads with random tails. Returns {row: (positive, corrupted)}."""
    from embiggen_tpu_torch.graph import karate_club
    from embiggen_tpu_torch.models.embedders import KGE_MODELS

    g = karate_club()
    labels = g.get_single_label_node_type_ids()
    g = dataclasses.replace(g, edge_types=(labels[g.sources] != labels[g.col_idx]).astype(
        np.int32))
    src = torch.from_numpy(g.sources.astype(np.int32)).to(dev)
    dst = torch.from_numpy(g.col_idx.astype(np.int32)).to(dev)
    et = torch.from_numpy(g.edge_types.astype(np.int64)).to(dev)
    cdst = torch.from_numpy(np.random.default_rng(3).integers(
        0, g.number_of_nodes, len(src), dtype=np.int32)).to(dev)
    out = {}
    for cls in KGE_MODELS:
        model = cls(device=dev, random_state=7, **cls.smoke_test_parameters())
        emb = model.fit_transform(g).node_embeddings[0]
        if not np.isfinite(emb).all():
            raise AssertionError(f"{cls.model_name()}'s embedding is not finite")
        ctx = model._prepare_data(g)
        gen = torch.Generator().manual_seed(7)
        params = model._init_params(g, gen)
        with torch.no_grad():
            for _ in range(S12_RANK_STEPS):
                model._step(ctx, params, gen, S12_RANK_LR.get(cls.model_name(), 0.1))
            pos = model._triple_scores(params, src, dst, et)
            neg = model._triple_scores(params, src, cdst, et)
        pos, neg = float(pos.mean()), float(neg.mean())
        if not (np.isfinite(pos) and np.isfinite(neg) and pos < neg):
            raise AssertionError(f"{cls.model_name()} does not rank positive triples on the "
                                 f"card: {pos} against {neg}")
        out[cls.model_name()] = (round(pos, 4), round(neg, 4))
    return out


def s12_nodepiece_distances(model, typed):
    """K15a at NodePiece's width on the slice graph, after its fit: the
    early-stopped distances from the fit's 256 anchors (two column passes
    of the kernel's float4 route) against plain relaxations until one
    moves nothing, exactly, and the fit's tokens against those of the
    plain distances. Returns the relaxations that moved a distance."""
    from embiggen_tpu_torch.ops.bfs import min_plus_step_plain, multi_source_distances

    tg, want = model._anchor_problem(typed)
    if want.shape[1] != 256:
        raise AssertionError(f"NodePiece has {want.shape[1]} anchors, not 256")
    got = multi_source_distances(tg, want, max_depth=typed.number_of_nodes - 1)
    changed = torch.zeros(1, dtype=torch.int32, device=want.device)
    moved = 0
    while True:
        changed.zero_()
        want = min_plus_step_plain(tg, want, False, changed)
        if not int(changed):
            break
        moved += 1
    exact_err("K15a at NodePiece's 256 anchors", got, want)
    del got
    exact_err("NodePiece's tokens from K15a", model._tokens, model._nearest_anchors(want))
    return {"k15a_256_relaxations_moved": moved}


def s12_runs(graph, dev):
    """Phase 34: every KGE row through `embed_graph` on the typed slice
    graph at D 128 and batch 65536, one epoch of S12_STEPS steps, with the
    counts set to 0 just before and read just after: K14 once a step,
    NodePiece's K15a, no walk or K4 kernel; NodePiece's K15a distances
    and tokens against the plain ones; then S12_PROFILE_STEPS steady
    steps of the row on CUDA events and under the profiler (busy share:
    the kernels' device time over the step's). Peak memory is the fit's
    own, above what was allocated before it (the total beside it).
    Returns {row: dict}."""
    from embiggen_tpu_torch.models import get_model_from_library
    from embiggen_tpu_torch.models.embedders import KGE_MODELS
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.pipelines import embed_graph

    typed = minibatch_graph(graph, S6_TYPES)
    out = {}
    for cls in KGE_MODELS:
        name = cls.model_name()
        model = get_model_from_library(name)(
            device=dev, embedding_size=DIM, epochs=1, batch_size=S6_BATCH, random_state=0,
            early_stopping_patience=10**6)
        steps = min(S12_STEPS, model._steps_per_epoch(typed, None, S6_BATCH))
        model._steps_per_epoch = lambda graph, ctx, batch, steps=steps: steps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        result = embed_graph(typed, model)
        seconds = time.perf_counter() - t0
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        got = check_launches(name, counts, S12_KERNELS + (
            ("min_plus_step",) if name == "NodePiece" else ()), S12_UNUSED)
        if got["siamese_mini_batch"] != steps:
            raise AssertionError(f"{name}: K14 launched {got['siamese_mini_batch']} times in "
                                 f"{steps} steps")
        for i, emb in enumerate(result.node_embeddings):
            if emb.shape != (N_NODES, DIM) or not np.isfinite(emb).all():
                raise AssertionError(f"{name} embedding {i}: shape {emb.shape} or not finite")
        if not np.isfinite(model._epoch_losses).all():
            raise AssertionError(f"{name} epoch losses {model._epoch_losses}")
        extra = {}
        if name == "NodePiece":
            extra = s12_nodepiece_distances(model, typed)
            if got["min_plus_step"] != extra["k15a_256_relaxations_moved"] + 1:
                raise AssertionError(f"NodePiece: {got['min_plus_step']} K15a launches for "
                                     f"distances that settle after {extra}")
        rows, step_ms, _ = profile(minibatch_step(model, typed), S12_PROFILE_STEPS)
        busy = sum(ms for ms, _, _ in rows.values()) / step_ms
        top = max(rows, key=lambda k: rows[k][0])
        out[name] = dict(seconds=round(seconds, 3), steps=steps,
                         epoch_s=round(model._epoch_seconds[0], 3), step_ms=round(step_ms, 4),
                         busy=round(busy, 3), peak_gb=round((peak - base) / 1e9, 3),
                         peak_total_gb=round(peak / 1e9, 3),
                         loss=round(model._epoch_losses[0], 5), launches=got,
                         top_kernel=(top[:60], round(rows[top][0], 4)), **extra)
        del model, result
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------- S14
# S14: node-label and edge-label prediction on the typed slice graph (8 node
# and 8 edge types) through their evaluation facades, one Stratified Monte
# Carlo holdout at random state 0: the node-label Kipf GCN at the
# reference's defaults (units 128-128, head 128, dropout 0.5, 200 epochs,
# patience 20; no node features, so a learned [1M, 50] embedding), the
# edge-label Kipf GCN at its default widths (units 128-128, towers 64, head
# 32, batch one arc a node) cut to S14_EDGE_EPOCHS epochs, plain and with
# `use_edge_metrics`; GraphConvolution's two hops at D S14_CONV_DIM in both
# transposes; Node-label-based SPINE at its defaults (depth 32).
S14_EDGE_EPOCHS = 2
S14_CONV_DIM = 128
S14_STEP_REPS = 10
S14_NODE_KERNELS = ("spmm",)
S14_EDGE_KERNELS = ("spmm",)
S14_EDGE_UNUSED = ("edge_prediction_mini_batch", "edge_metrics", "csr_edge_ids")
S14_METRICS_KERNELS = ("spmm", "edge_metrics")
S14_SPINE_KERNELS = ("min_plus_step",)
# The reference's node-label gate (tests/test_quality_gates.py:70-89) and
# its mean test accuracy over model seeds 0-7, measured with embiggen_tpu on
# the CPU (tests/test_torch_label_gate.py says how).
GATE_NODE_LABEL = dict(units=[32], head_units=[32], epochs=100, use_node_embedding=True,
                       node_embedding_size=32, dropout_rate=0.2, random_state=0)
GATE_NODE_LABEL_FLOOR = 0.85
GATE_REFERENCE_NODE_LABEL_ACCURACY = 1.0


def recorded(cls):
    """A subclass of the model class `cls` (same names and parameters) that
    keeps each instance it fits in its `fitted` list, so that a phase reads
    the fits an evaluation made of its clones."""

    class Recorded(cls):
        fitted = []

        def _fit(self, *args, **kwargs):
            super()._fit(*args, **kwargs)
            type(self).fitted.append(self)

    return Recorded


def node_label_step_ms(model, graph, reps=S14_STEP_REPS) -> float:
    """ms of one full-graph Adam step of the fitted node-label GCN on CUDA
    events (its loss with dropout, the backward and Adam, on a copy of its
    parameters), after two warm-up steps."""
    from embiggen_tpu_torch.models.gcn.core import map_params, param_leaves

    params = map_params(lambda t: t.detach().clone().requires_grad_(True), model._params)
    optimizer = torch.optim.Adam(param_leaves(params), lr=model._learning_rate)
    targets = model._targets(graph)
    drop = torch.Generator(device=model.device).manual_seed(0)

    def step():
        optimizer.zero_grad(set_to_none=True)
        model._loss(params, model._csr_kernels, targets, graph.number_of_nodes,
                    drop).backward()
        optimizer.step()

    step()
    return time_ms(step, reps)


def label_spmm_check(model, name, seed) -> float:
    """K7 at the fitted label GCN's own first convolution: over its kernel
    (`_csr_kernels[0]`) with its learned input features ([n, 50] at the
    defaults: D not a multiple of 4, so K7's scalar route), forward for
    every combiner and the transposed backward through autograd against a
    seeded output gradient, each against the plain version at K7_TOL.
    Returns the largest abs error."""
    k = model._csr_kernels[0]
    with torch.no_grad():
        x = model._spec.materialize(model._params["embed"]).detach().float().contiguous()
    gen = torch.Generator(device=x.device).manual_seed(seed)
    g = torch.randn(x.shape, generator=gen, device=x.device)
    err = spmm_check(k, x, g, f"{name} D {x.shape[1]}")
    del x, g
    return err


def graph_convolution_checks(typed, dev):
    """GraphConvolution(number_of_convolutions=2) at D S14_CONV_DIM on the
    card in both transposes, each against the plain version's two hops on
    the card over the same kernel's CSR (rtol / atol 1e-5: sums in another
    order), with 2 K7 launches; the transposed kernel's hop timed beside its
    plain version and `torch.sparse.mm`. Returns ({transpose: (seconds,
    largest error)}, the hop's entry, the transforms' K7 launches)."""
    from embiggen_tpu_torch.graph.laplacians import kernel_coo
    from embiggen_tpu_torch.models.feature_preprocessors import GraphConvolution
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.ops.spmm import csr_kernel, csr_spmm, csr_spmm_plain

    x = np.random.default_rng(36).standard_normal((N_NODES, S14_CONV_DIM), dtype=np.float32)
    out, hop, launches = {}, None, 0
    for transpose in (False, True):
        name = ("Transposed Left Normalized Laplacian" if transpose
                else "Left Normalized Laplacian")
        model = GraphConvolution(number_of_convolutions=2, transpose=transpose, device=dev)
        got, counts, secs, _ = s8_run(lambda: model.transform(typed, x).node_embeddings[0])
        if counts["spmm"] != 2:
            raise AssertionError(f"GraphConvolution launched K7 {counts['spmm']} times, not 2")
        launches += counts["spmm"]
        k = csr_kernel(*kernel_coo(typed, name), N_NODES, device=dev, with_transpose=False)
        h = torch.from_numpy(x).to(dev)
        want = csr_spmm_plain(k, csr_spmm_plain(k, h))
        out[transpose] = (secs, check_close(f"GraphConvolution transpose={transpose}",
                                            torch.from_numpy(got).to(dev), want, 1e-5, 1e-5))
        if transpose:
            a = torch.sparse_csr_tensor(k.row_ptr, k.cols, k.vals, size=(N_NODES, N_NODES))
            n, d, e = N_NODES, S14_CONV_DIM, k.n_arcs
            hop = dict(
                max_abs_err=out[transpose][1],
                ms=time_ms(lambda: csr_spmm(k, h), 20),
                plain_ms=time_ms(lambda: csr_spmm_plain(k, h), 3),
                library_ms=time_ms(lambda: torch.sparse.mm(a, h), 20),
                library="torch.sparse.mm (cuSPARSE)",
                # x in, the sums out, the CSR; a multiply-add per gathered float.
                **bound(4 * (2 * n * d + n + 1 + 2 * e), 2 * e * d))
            del a
        del got, want, k, h
        torch.cuda.empty_cache()
    return out, hop, launches


def node_label_spine_check(typed, dev):
    """Node-label-based SPINE through `embed_graph` on the typed slice graph
    (an anchor set a node type: 8 columns), launching K15a, its distances
    exactly the plain version's 32 relaxations (clamped as the model
    clamps). Returns (launches, seconds, peak bytes)."""
    from embiggen_tpu_torch.models.embedders import NodeLabelSPINE
    from embiggen_tpu_torch.ops.bfs import UNREACHED, anchor_init_from_sets
    from embiggen_tpu_torch.pipelines import embed_graph

    model = NodeLabelSPINE(device=dev)
    result, counts, secs, peak = s8_run(lambda: embed_graph(typed, model))
    got = result.node_embeddings[0]
    sets = model._anchor_sets(typed)
    if got.shape != (N_NODES, len(sets)) or len(sets) != S10_TYPES:
        raise AssertionError(f"Node-label-based SPINE: shape {got.shape}, {len(sets)} sets")
    init = anchor_init_from_sets(N_NODES, sets, dev)
    want = plain_distances(typed.device(dev), init, S8_DEPTH, False)
    want = torch.where(want >= UNREACHED, float(S8_DEPTH + 1), want)
    exact_err("Node-label-based SPINE", torch.from_numpy(got).to(dev),
              torch.clamp(want, max=255).to(torch.uint8))
    return check_launches("Node-label-based SPINE", counts, S14_SPINE_KERNELS), secs, peak


def s14_node_label_runs(typed, dev):
    """Phase 36: the node-label Kipf GCN through
    `node_label_prediction_evaluation` (the counts set to 0 just before and
    read just after; K7 4 times an epoch, the learned embedding taking a
    gradient, and twice to predict), its steady step on CUDA events, K7 at
    its first convolution's shape against the plain version, then
    GraphConvolution and Node-label-based SPINE. Returns a dict of what the
    phase's line prints."""
    from embiggen_tpu_torch.models.gcn import KipfGCNNodeLabelPrediction
    from embiggen_tpu_torch.pipelines import node_label_prediction_evaluation

    cls = recorded(KipfGCNNodeLabelPrediction)
    rows, counts, secs, peak = s8_run(lambda: node_label_prediction_evaluation(
        holdouts_number=1, models=cls(device=dev), graphs=typed, random_state=0))
    model = cls.fitted[-1]
    epochs = len(model._history)
    launches = check_launches("node label", counts, S14_NODE_KERNELS)
    if counts["spmm"] != 4 * epochs + 2:
        raise AssertionError(f"the node-label GCN launched K7 {counts['spmm']} times in "
                             f"{epochs} epochs, not 4 an epoch and 2 to predict")
    if [r["evaluation_mode"] for r in rows] != ["train", "test"] or not all(
            np.isfinite(r["accuracy"]) and np.isfinite(r["auroc_macro_ovr"]) for r in rows):
        raise AssertionError(f"node-label rows: {rows}")
    if not np.isfinite(model._history).all():
        raise AssertionError(f"node-label losses {model._history}")
    out = dict(
        seconds=secs, peak_bytes=peak, fit_s=rows[0]["fit_time"],
        epochs=epochs, s_per_epoch=float(np.median(model._epoch_seconds)),
        k7_per_epoch=(counts["spmm"] - 2) / epochs, launches=launches,
        step_ms=node_label_step_ms(model, typed),
        panel={r["evaluation_mode"]: {k: round(float(r[k]), 4) for k in (
            "accuracy", "balanced_accuracy", "f1_score_macro", "auroc_macro_ovr")}
            for r in rows},
        first_loss=model._history[0], last_loss=model._history[-1],
        k7_err=label_spmm_check(model, "node label", 360))
    del model, cls.fitted[:]
    torch.cuda.empty_cache()
    (out["graph_convolution"], out["graph_convolution_hop"],
     out["graph_convolution_spmm"]) = graph_convolution_checks(typed, dev)
    out["spine"] = node_label_spine_check(typed, dev)
    return out


def s14_edge_label_runs(typed, dev):
    """Phase 37: the edge-label Kipf GCN through
    `edge_label_prediction_evaluation`, plain and with `use_edge_metrics`,
    each with the counts set to 0 just before and read just after: K7 4
    times a step (the learned embedding takes a gradient) and twice to
    predict, never K6 (the batch is `torch.randint` over the known arcs) nor
    K5; K8 once a step and once a 2^22-arc chunk of the prediction with the
    metrics, never without; then K7 at each fit's first convolution's shape
    against the plain version. Returns {label: dict}."""
    from embiggen_tpu_torch.models.gcn import KipfGCNEdgeLabelPrediction
    from embiggen_tpu_torch.pipelines import edge_label_prediction_evaluation

    out = {}
    chunks = -(-typed.number_of_directed_edges // (1 << 22))
    for label, kw, names, unused in (
        ("plain", {}, S14_EDGE_KERNELS, S14_EDGE_UNUSED),
        ("use_edge_metrics", dict(use_edge_metrics=True), S14_METRICS_KERNELS,
         ("edge_prediction_mini_batch", "csr_edge_ids")),
    ):
        cls = recorded(KipfGCNEdgeLabelPrediction)
        rows, counts, secs, peak = s8_run(lambda: edge_label_prediction_evaluation(
            holdouts_number=1, graphs=typed, random_state=0, models=cls(
                device=dev, epochs=S14_EDGE_EPOCHS, early_stopping_patience=10**6, **kw)))
        model = cls.fitted[-1]
        steps = model._steps_per_epoch * len(model._history)
        launches = check_launches(f"edge label {label}", counts, names, unused)
        if counts["spmm"] != 4 * steps + 2:
            raise AssertionError(f"the edge-label GCN ({label}) launched K7 {counts['spmm']} "
                                 f"times in {steps} steps, not 4 a step and 2 to predict")
        if "edge_metrics" in names and counts["edge_metrics"] != steps + chunks:
            raise AssertionError(f"the edge-label GCN launched K8 {counts['edge_metrics']} "
                                 f"times in {steps} steps and {chunks} chunks")
        if len(model._history) != S14_EDGE_EPOCHS or not np.isfinite(model._history).all():
            raise AssertionError(f"edge-label ({label}) losses {model._history}")
        if [r["evaluation_mode"] for r in rows] != ["train", "test"] or not all(
                np.isfinite(r["accuracy"]) for r in rows):
            raise AssertionError(f"edge-label rows ({label}): {rows}")
        out[label] = dict(
            seconds=secs, peak_bytes=peak, fit_s=rows[0]["fit_time"],
            batch=model._run_batch_size, steps_per_epoch=model._steps_per_epoch,
            s_per_epoch=model._epoch_seconds,
            step_ms=[s / model._steps_per_epoch * 1e3 for s in model._epoch_seconds],
            losses=model._history, launches=launches,
            k7_err=label_spmm_check(model, f"edge label {label}", 370),
            panel={r["evaluation_mode"]: {k: round(float(r[k]), 4) for k in (
                "accuracy", "balanced_accuracy", "f1_score_macro", "auroc_macro_ovr")}
                for r in rows})
        del model, cls.fitted[:]
        torch.cuda.empty_cache()
    return out


def s14_quality_on_card(card, dev):
    """The reference's node-label gate (`tests/test_quality_gates.py:70-89`)
    on the card: its call verbatim through `node_label_prediction_evaluation`
    on planted_partition(1000, 4, p_in=0.05, p_out=0.002, seed=42), then
    model seeds 1-7 on the same holdout's Degree-based SPINE features by
    `_evaluate` (tests/test_torch_label_gate.py): each test accuracy at least
    GATE_NODE_LABEL_FLOOR, the mean at least the reference's less 0.03.
    Returns the per-seed accuracies."""
    from embiggen_tpu_torch.graph import planted_partition
    from embiggen_tpu_torch.models.embedders import DegreeSPINE
    from embiggen_tpu_torch.models.gcn import KipfGCNNodeLabelPrediction
    from embiggen_tpu_torch.pipelines import node_label_prediction_evaluation

    sbm = planted_partition(1000, 4, p_in=0.05, p_out=0.002, seed=42)
    rows = node_label_prediction_evaluation(
        holdouts_number=1, models=KipfGCNNodeLabelPrediction(device=dev, **GATE_NODE_LABEL),
        graphs=sbm, node_features="Degree-based SPINE",
        evaluation_schema="Stratified Monte Carlo", random_state=3)
    accuracy = [next(r["accuracy"] for r in rows if r["evaluation_mode"] == "test")]
    train, test = KipfGCNNodeLabelPrediction.split_graph_following_evaluation_schema(
        sbm, "Stratified Monte Carlo", 0, random_state=3)
    spine = DegreeSPINE(device=dev).fit_transform(train).node_embeddings[0]
    for seed in GATE_SEEDS[1:]:
        model = KipfGCNNodeLabelPrediction(device=dev, **GATE_NODE_LABEL)
        model.set_random_state(seed)
        model.fit(train, support=train, node_features=spine)
        got = {r["evaluation_mode"]: r for r in
               model._evaluate(sbm, train, test, support=train, random_state=3)}
        accuracy.append(got["test"]["accuracy"])
    if not (min(accuracy) >= GATE_NODE_LABEL_FLOOR
            and np.mean(accuracy) >= GATE_REFERENCE_NODE_LABEL_ACCURACY - 0.03):
        raise AssertionError(f"node-label gate on {card}: test accuracy {accuracy}")
    return accuracy


# ------------------------------------------- S15: the sklearn-like adapters
# Phase 39's graph: 100,000 nodes, about 1,000,000 edges in communities of
# about 100 nodes, where common neighbours (the metric columns) separate
# edges from negatives (at the default 10 communities of 10,000 they are
# nearly all 0, and the classifiers score at chance); its SkipGram features
# at the S1 widths (two tables of D 128: the train and negative arcs'
# "Concatenate" features are 3.2M rows of 512 floats, 6.6 GB of host
# memory), trained at the harness's learning-rate decay; the linear
# classifier's test AUROC floor; and the pairs whose features and metric
# columns are held to the CPU route's.
S15_NODES, S15_EDGES, S15_COMMUNITIES = 100_000, 1_000_000, 1_000
S15_EPOCHS, S15_DECAY = 30, 0.99
S15_LINEAR_AUROC_FLOOR = 0.8
S15_PAIRS = 1 << 15
S15_FEATURE_TOL = dict(rtol=1e-6, atol=1e-6)
S15_METRICS_RTOL = 1e-6
S15_SCORE_TOL = 1e-4
# Phase 40's edge-label graph: 2M arcs, whose "Concatenate" features at D
# 128 with the four metric columns take 2.1 GB of host memory.
S15_LABEL_NODES, S15_LABEL_EDGES = 200_000, 1_000_000
S15_KERNELS = S1_KERNELS + S2_KERNELS + K8_KERNELS
# K8 at the adapters' cap (the largest degree) against the host copy: the
# first S15_HOST_PAIRS pairs of the check, and its hub pairs.
S15_HUB_PAIRS = 256
S15_HOST_PAIRS = 1 << 16


def _row_chunks(n, rows=1 << 18):
    return (slice(i, min(n, i + rows)) for i in range(0, n, rows))


class LeastSquaresClassifier:
    """A linear classifier in numpy: least squares of the standardized
    features (and a bias) to +-1 targets, one-vs-rest for more than two
    classes, by its normal equations in float64, one pass over chunks of
    rows (the centering done on the Gram matrix). It exposes
    `decision_function` only, so the adapters squash its margins
    (`predict_proba_compat`)."""

    def fit(self, x, y):
        n, d = x.shape
        self.classes_ = np.unique(y)
        targets = (np.asarray(y)[:, None] == self.classes_[None, :]) * 2.0 - 1.0
        gram, total = np.zeros((d, d)), np.zeros(d)
        moments = np.zeros((d, targets.shape[1]))
        for rows in _row_chunks(n):
            chunk = x[rows].astype(np.float64)
            gram += chunk.T @ chunk
            total += chunk.sum(axis=0)
            moments += chunk.T @ targets[rows]
        mean = total / n
        scale = np.sqrt(np.maximum(np.diag(gram) / n - mean * mean, 0.0))
        scale[scale == 0] = 1.0
        # Z = (X - mean) / scale has zero column sums, so the bias solves
        # apart: Z'Z w = Z't and b = mean(t).
        zz = (gram - n * np.outer(mean, mean)) / np.outer(scale, scale)
        zt = (moments - np.outer(mean, targets.sum(axis=0))) / scale[:, None]
        coef = np.linalg.lstsq(zz, zt, rcond=None)[0]
        bias = targets.mean(axis=0)
        if len(self.classes_) == 2:
            coef, bias = coef[:, 1], bias[1]
        # The standardization folded into the weights and the bias.
        self.coef_ = coef / (scale[:, None] if coef.ndim == 2 else scale)
        self.intercept_ = bias - mean @ self.coef_
        return self

    def decision_function(self, x):
        return x.astype(np.float64) @ self.coef_ + self.intercept_


class CentroidClassifier:
    """A class-centroid classifier in numpy: a softmax over minus the
    squared distances to the class means (scaled by the width; a row's own
    squared norm cancels), with `predict_proba` and `classes_`."""

    def fit(self, x, y):
        self.classes_ = np.unique(y)
        sums = np.zeros((len(self.classes_), x.shape[1]))
        for rows in _row_chunks(len(x)):
            onehot = (np.asarray(y[rows])[:, None] == self.classes_[None, :]).astype(np.float64)
            sums += onehot.T @ x[rows].astype(np.float64)
        counts = (np.asarray(y)[:, None] == self.classes_[None, :]).sum(axis=0)
        self.centroids_ = sums / counts[:, None]
        return self

    def predict_proba(self, x):
        logits = (2.0 * x.astype(np.float64) @ self.centroids_.T
                  - (self.centroids_ ** 2).sum(axis=1)[None, :]) / x.shape[1]
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)


def s15_adapter(base, estimator):
    """A subclass of the adapter class `base` whose estimator is a new
    `estimator()` (so an evaluation's clones build their own) and which
    keeps, a list for the class, each instance it fits with its fit's
    inputs and its evaluation's graphs, and the arcs of each graph it
    scored."""

    class Adapter(base):
        fitted = []
        scored = []

        def _default_model_instance(self, random_state, **kwargs):
            return estimator()

        def _fit(self, graph, support, node_features, **kwargs):
            super()._fit(graph, support, node_features, **kwargs)
            self.fit_inputs = (graph, support, node_features)
            type(self).fitted.append(self)

        def _evaluate(self, graph, train, test, *args, **kwargs):
            self.evaluated = (graph, train, test)
            return super()._evaluate(graph, train, test, *args, **kwargs)

        def _predict_proba(self, graph, *args, **kwargs):
            type(self).scored.append(graph.number_of_directed_edges)
            return super()._predict_proba(graph, *args, **kwargs)

    Adapter.__name__ = f"{estimator.__name__}{base.__name__}"
    return Adapter


def plain_edge_metrics_in_chunks(tg, src, dst, cap, budget=1 << 26):
    """K8's plain version at `cap` over the pairs, in chunks of pairs
    ordered by the expanded row's length, each chunk's [pairs, width]
    block at most `budget` entries (a hub pair alone is tens of thousands
    of candidates wide)."""
    from embiggen_tpu_torch.ops.edge_metrics import edge_metrics_plain

    deg = tg.degrees.long()
    da = torch.minimum(deg[src.long()], deg[dst.long()]).clamp(min=1, max=cap)
    order = torch.argsort(da)
    widths = da[order].cpu().numpy()
    out = torch.empty((len(src), 4), dtype=torch.float32, device=src.device)
    i, n = 0, len(src)
    while i < n:
        width = int(widths[min(n, i + max(1, budget // int(widths[i]))) - 1])
        j = min(n, i + max(1, budget // width))
        idx = order[i:j]
        out[idx] = edge_metrics_plain(tg, src[idx], dst[idx], cap=cap)
        i = j
    return out


def k8_against(name, got, want, deg, src, dst):
    """K8's output against another computation of the same exact function:
    preferential attachment and the common-neighbour counts exactly,
    Jaccard rtol 1e-6, Adamic-Adar and resource allocation at K8_SUM_TOL
    (sums in another order). Returns the largest abs error."""
    if not torch.equal(got[:, 3], want[:, 3]):
        raise AssertionError(f"K8 {name}: preferential attachment differs")
    total = (deg[src.long()] + deg[dst.long()]).double()

    def inter(m):
        jac = m[:, 1].double()
        return torch.round(jac * total / (1.0 + jac))
    if not torch.equal(inter(got), inter(want)):
        raise AssertionError(f"K8 {name}: common-neighbour counts differ")
    err = check_close(f"K8 {name} Jaccard", got[:, 1], want[:, 1], 1e-6, 0.0)
    return max(err, check_close(f"K8 {name} Adamic-Adar and RA", got[:, [0, 2]],
                                want[:, [0, 2]], **K8_SUM_TOL))


def edge_metrics_exact_cap_check(graph, tg, hub_pairs):
    """K8 at the sklearn adapters' cap, the graph's largest degree (where
    it truncates no row), on K8_PAIRS pairs of `graph` (half arcs, half
    uniform pairs, the last `hub_pairs` of them between two of the N_HUBS
    highest-degree nodes): against its plain version at that cap (in
    chunks) on every pair, and against the host copy of `graph/metrics.py`
    on the first S15_HOST_PAIRS pairs and the hub pairs. Returns a dict of
    the cap, the errors, the kernel's ms, the plain version's and the host
    copy's seconds, and the longest expanded row."""
    from embiggen_tpu_torch.graph.metrics import edge_metrics as host_edge_metrics
    from embiggen_tpu_torch.ops.edge_metrics import edge_metrics

    dev, n, cap = tg.device, graph.number_of_nodes, tg.max_degree
    rng = np.random.default_rng(39)
    arc = rng.integers(0, graph.number_of_directed_edges, K8_PAIRS // 2)
    rest = K8_PAIRS - K8_PAIRS // 2
    hubs = np.argsort(-graph.degrees, kind="stable")[:N_HUBS]
    pick = [np.concatenate([rng.integers(0, n, rest - hub_pairs), rng.choice(hubs, hub_pairs)])
            for _ in range(2)]
    src_np = np.concatenate([graph.sources[arc], pick[0]])
    dst_np = np.concatenate([graph.col_idx[arc], pick[1]])
    src = torch.from_numpy(src_np.astype(np.int32)).to(dev)
    dst = torch.from_numpy(dst_np.astype(np.int32)).to(dev)
    deg = tg.degrees.long()
    got = edge_metrics(tg, src, dst, cap=cap)
    t0 = time.perf_counter()
    want = plain_edge_metrics_in_chunks(tg, src, dst, cap)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = k8_against("at the exact cap against the plain version", got, want, deg, src, dst)
    keep = np.concatenate([np.arange(S15_HOST_PAIRS), np.arange(K8_PAIRS - hub_pairs, K8_PAIRS)])
    t0 = time.perf_counter()
    host = torch.from_numpy(host_edge_metrics(graph, src_np[keep], dst_np[keep])).to(dev)
    host_s = time.perf_counter() - t0
    keep_t = torch.from_numpy(keep).to(dev)
    host_err = k8_against("at the exact cap against the host copy", got[keep_t], host, deg,
                          src[keep_t], dst[keep_t])
    longest = int(torch.minimum(deg[src.long()], deg[dst.long()]).max())
    del got, want, host
    return dict(cap=cap, max_abs_err=err, host_max_abs_err=host_err,
                ms=time_ms(lambda: edge_metrics(tg, src, dst, cap=cap), 5), plain_s=plain_s,
                host_s=host_s, host_pairs=len(keep), longest_expanded_row=longest)


def edge_metrics_exact_cap_checks(graph, tg):
    """K8 at the exact cap on the slice graph and on it plus 256 hubs of
    4,096-65,536 neighbours (S15_HUB_PAIRS hub pairs, whose expanded rows
    run past HELD and past the default cap of 128). Returns {graph: dict}."""
    out = {"slice": edge_metrics_exact_cap_check(graph, tg, 0)}
    hg = hub_graph(graph)
    htg = hg.device(tg.device)
    out["hub"] = edge_metrics_exact_cap_check(hg, htg, S15_HUB_PAIRS)
    if out["hub"]["longest_expanded_row"] <= 128:
        raise AssertionError("no K8 pair of the hub graph reached past the default cap")
    del htg
    torch.cuda.empty_cache()
    return out


def s15_edge_prediction_runs(dev):
    """Phase 39: `edge_prediction_evaluation` on the card of two
    SklearnEdgePredictionAdapters over planted_partition_edges(S15_NODES,
    S15_EDGES, S15_COMMUNITIES) with one connected holdout and Node2Vec
    SkipGram features at the S1 widths: the least-squares classifier
    (decision_function only, test AUROC at least S15_LINEAR_AUROC_FLOOR)
    on "Hadamard" with `use_edge_metrics`, and the centroid classifier
    (predict_proba) on "Concatenate". The counts are set to 0 just before
    and read just after: the SkipGram step's kernels, K5 and K8, K8 once for
    the fit and once a prediction chunk. Then on S15_PAIRS pairs, the
    card's features of both fits against the CPU route's (S15_FEATURE_TOL)
    and the first's metric columns (K8 at the exact cap) against the host
    copy (S15_METRICS_RTOL); and the first's test scores against the same
    estimator fitted on the CPU route's features (S15_SCORE_TOL). Returns
    a dict of what the phase's line prints."""
    from embiggen_tpu_torch import edge_prediction_evaluation
    from embiggen_tpu_torch.graph import planted_partition_edges
    from embiggen_tpu_torch.models.edge_prediction import SklearnEdgePredictionAdapter
    from embiggen_tpu_torch.models.embedders import SkipGram
    from embiggen_tpu_torch.models.sklearn_backend import edge_metric_columns
    from embiggen_tpu_torch.models.edge_prediction.sklearn_like import PREDICTION_BATCH_SIZE
    from embiggen_tpu_torch.transformers import EdgeTransformer

    t0 = time.perf_counter()
    pp = planted_partition_edges(S15_NODES, S15_EDGES, n_communities=S15_COMMUNITIES, seed=0)
    graph_s = time.perf_counter() - t0
    linear = s15_adapter(SklearnEdgePredictionAdapter, LeastSquaresClassifier)
    centroid = s15_adapter(SklearnEdgePredictionAdapter, CentroidClassifier)
    rows, counts, secs, peak = s8_run(lambda: edge_prediction_evaluation(
        holdouts_number=1, graphs=pp, random_state=0,
        models=[linear(edge_embedding_methods="Hadamard", use_edge_metrics=True, device=dev),
                centroid(edge_embedding_methods="Concatenate", device=dev)],
        node_features=SkipGram(
            embedding_size=DIM, walk_length=WALK, window_size=WINDOW,
            number_of_negative_samples=NEGS, epochs=S15_EPOCHS, learning_rate_decay=S15_DECAY,
            random_state=0, early_stopping_patience=10**6, device=dev)))
    launches = check_launches("S15 edge prediction", counts, S15_KERNELS)
    chunks = sum(-(-n // PREDICTION_BATCH_SIZE) for n in linear.scored)
    if counts["edge_metrics"] != 1 + chunks:
        raise AssertionError(f"the adapters launched K8 {counts['edge_metrics']} times, not "
                             f"once for the fit and once in each of {chunks} chunks")
    if [r["evaluation_mode"] for r in rows] != ["train", "test"] * 2 or not all(
            np.isfinite(r["auroc"]) and np.isfinite(r["auprc"]) for r in rows):
        raise AssertionError(f"S15 edge prediction rows: {rows}")
    if not rows[1]["auroc"] >= S15_LINEAR_AUROC_FLOOR:
        raise AssertionError(f"the least-squares adapter's test AUROC {rows[1]['auroc']} is "
                             f"below {S15_LINEAR_AUROC_FLOOR}")
    (lin,), (cen,) = linear.fitted, centroid.fitted
    graph, train, test = lin.evaluated
    _, support, features = lin.fit_inputs
    rng = np.random.default_rng(390)
    arcs = rng.integers(0, test.number_of_directed_edges, S15_PAIRS // 2)
    src = np.concatenate([test.sources[arcs], rng.integers(0, S15_NODES, S15_PAIRS // 2)])
    dst = np.concatenate([test.col_idx[arcs], rng.integers(0, S15_NODES, S15_PAIRS // 2)])
    feature_err = {}
    for name, model in (("Hadamard", lin), ("Concatenate", cen)):
        card_tr = model._transformer._graph_transformer._edge_transformer
        cpu_tr = EdgeTransformer(name, aligned_mapping=True, device="cpu").fit(
            model.concatenate_features(model.fit_inputs[2]))
        feature_err[name] = check_close(
            f"S15 {name} features, card against CPU",
            torch.from_numpy(card_tr.transform(src, dst)),
            torch.from_numpy(cpu_tr.transform(src, dst)), **S15_FEATURE_TOL)
    got = lin._metric_columns(src, dst).cpu()
    want = torch.from_numpy(edge_metric_columns(support, "cpu")(src, dst))
    metrics_err = check_close("S15 K8 metric columns at the exact cap against the host copy",
                              got, want, S15_METRICS_RTOL, 0.0)
    t0 = time.perf_counter()
    cpu_model = linear(edge_embedding_methods="Hadamard", use_edge_metrics=True,
                       random_state=lin.random_state, device="cpu")
    cpu_model.fit(train, support=support, node_features=features)
    cpu_scores = cpu_model.predict_proba(test)
    cpu_s = time.perf_counter() - t0
    card_scores = lin.predict_proba(test)
    score_err = check_close("S15 least-squares test scores, card against the CPU route's fit",
                            torch.from_numpy(card_scores), torch.from_numpy(cpu_scores),
                            0.0, S15_SCORE_TOL)
    out = dict(
        seconds=secs, graph_s=graph_s, peak_bytes=peak, launches=launches,
        arcs=pp.number_of_directed_edges, train_arcs=train.number_of_directed_edges,
        test_arcs=test.number_of_directed_edges, k8_cap=int(support.degrees.max()),
        k8_chunks=chunks,
        rows={f"{label} {r['evaluation_mode']}": dict(
            auroc=round(float(r["auroc"]), 4), auprc=round(float(r["auprc"]), 4),
            fit_s=round(float(r["fit_time"]), 2))
            for label, r in zip(("linear", "linear", "centroid", "centroid"), rows)},
        feature_err=feature_err, metrics_err=metrics_err, score_err=score_err, cpu_s=cpu_s)
    del lin, cen, linear.fitted[:], centroid.fitted[:]
    torch.cuda.empty_cache()
    return out


def s15_label_runs(typed, dev):
    """Phase 40: `node_label_prediction_evaluation` of a
    SklearnNodeLabelPredictionAdapter with the centroid classifier on the
    typed slice graph's node types (seeded [N, D] features), then
    `edge_label_prediction_evaluation` of a SklearnEdgeLabelPredictionAdapter
    with the least-squares classifier and `use_edge_metrics` on
    erdos_renyi(S15_LABEL_NODES, S15_LABEL_EDGES, 8 edge types) (seeded
    features), each with the counts set to 0 just before and read just
    after (K8 once for the fit and once to predict, no other kernel); then
    a named row ("Decision Tree Classifier") of each classification task,
    which raises ModuleNotFoundError naming scikit-learn on a host without
    it. Returns a dict of what the phase's line prints."""
    import importlib.util

    from embiggen_tpu_torch import (
        edge_label_prediction_evaluation, node_label_prediction_evaluation,
    )
    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.models import get_model_from_library
    from embiggen_tpu_torch.models.edge_label_prediction import (
        SklearnEdgeLabelPredictionAdapter,
    )
    from embiggen_tpu_torch.models.node_label_prediction import (
        SklearnNodeLabelPredictionAdapter,
    )

    out = {}
    rng = np.random.default_rng(40)
    node_x = rng.standard_normal((typed.number_of_nodes, DIM), dtype=np.float32)
    cls = s15_adapter(SklearnNodeLabelPredictionAdapter, CentroidClassifier)
    rows, counts, secs, peak = s8_run(lambda: node_label_prediction_evaluation(
        holdouts_number=1, models=cls(device=dev), graphs=typed, node_features=node_x,
        random_state=0))
    if any(counts.values()):
        raise AssertionError(f"the node-label adapter launched a kernel: {counts}")
    out["node label"] = dict(seconds=secs, peak_bytes=peak, rows=rows)
    del node_x, cls.fitted[:]
    labelled = erdos_renyi(S15_LABEL_NODES, S15_LABEL_EDGES, seed=0, n_edge_types=S10_TYPES)
    edge_x = rng.standard_normal((S15_LABEL_NODES, DIM), dtype=np.float32)
    cls = s15_adapter(SklearnEdgeLabelPredictionAdapter, LeastSquaresClassifier)
    rows, counts, secs, peak = s8_run(lambda: edge_label_prediction_evaluation(
        holdouts_number=1, models=cls(use_edge_metrics=True, device=dev), graphs=labelled,
        node_features=edge_x, random_state=0))
    launches = check_launches("S15 edge label", counts, K8_KERNELS)
    if counts["edge_metrics"] != 2 or sum(counts.values()) != 2:
        raise AssertionError(f"the edge-label adapter's launches: {counts}, not K8 twice")
    (model,) = cls.fitted
    out["edge label"] = dict(seconds=secs, peak_bytes=peak, rows=rows, launches=launches,
                             arcs=labelled.number_of_directed_edges,
                             k8_cap=int(model.fit_inputs[1].degrees.max()),
                             features=model._model_instance.coef_.shape[0])
    del edge_x, model, cls.fitted[:]
    for r in out["node label"]["rows"] + out["edge label"]["rows"]:
        if not (np.isfinite(r["accuracy"]) and np.isfinite(r["auroc_macro_ovr"])):
            raise AssertionError(f"S15 label rows: {out}")
    has_sklearn = importlib.util.find_spec("sklearn") is not None
    named = {}
    for task in ("Edge Prediction", "Node Label Prediction", "Edge Label Prediction"):
        try:
            get_model_from_library("Decision Tree Classifier", task)(device=dev)
            named[task] = "built (scikit-learn is installed)"
        except ModuleNotFoundError as exc:
            if has_sklearn or "scikit-learn" not in str(exc):
                raise
            named[task] = "ModuleNotFoundError naming scikit-learn"
    if has_sklearn != all(v.startswith("built") for v in named.values()):
        raise AssertionError(f"named rows with scikit-learn installed {has_sklearn}: {named}")
    out["named"] = named
    torch.cuda.empty_cache()
    return out

# -------------------------------------------------------------------- S16
# Phase 41: the reference-named Graph surface's batch methods on the typed
# slice graph (node2vec at K1's and K10's weights, the S1 batch, walk and
# window; K6 at 2^20 slots; K14 at the S6 batch), K8 at 2^20 pairs held to
# the host copy on its first S15_HOST_PAIRS (the largest error phase 39
# measured there, 6.1e-4, as the bound), and every zero-argument method on
# tests/test_graph_compat.py's 120-node typed fixture.
S16_PQ = dict(return_weight=2.0, explore_weight=0.5)
S16_EDGE_SLOTS = 1 << 20
S16_K8_HOST_ATOL = 6.1e-4
S16_COMPAT_KERNELS = ("first_order_walks", "rejection_walks", "edge_prediction_mini_batch",
                      "siamese_mini_batch", "edge_metrics")
S16_WALK_KERNELS = ("first_order_walks", "rejection_walks", "ell_walks", "exact_walks")
# Phase 42: the spectral rows on the card's host at their default
# embedding_size (100) on erdos_renyi(S16_SPECTRAL_NODES,
# S16_SPECTRAL_EDGES), which the four fit in about 20 s on 4 CPU threads;
# HOPE at "Resnik" on a random DAG of S16_DAG_NODES nodes (each node but 0
# with up to 3 parents of smaller id); then the link-prediction gate with
# HOPE's embeddings. The reference's test AUROC for the same call
# (edge_prediction_evaluation, one Connected Monte Carlo holdout at
# random_state 3 of random_geometric(1000, 0.07, seed=42), a Perceptron on
# Hadamard alone, GATE_CBOW_PERCEPTRON, with HOPE's defaults as the node
# features), measured with embiggen_tpu on the CPU; the port on the CPU gave
# 0.9748492141377689.
S16_SPECTRAL_NODES, S16_SPECTRAL_EDGES = 10_000, 50_000
S16_DAG_NODES = 2_000
S16_SPECTRAL_ROWS = ("HOPE", "Laplacian Eigenmaps", "GLEE", "SocioDim")
S16_ORTHO_TOL = 1e-4
GATE_REFERENCE_HOPE_AUROC = 0.9747947202986262


def _through_graph(fn, totals):
    """Run one Graph method with the counts set to 0 just before it and read
    just after; add them to `totals`. Returns (result, counts)."""
    from embiggen_tpu_torch.ops import _build

    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    for name in S16_COMPAT_KERNELS:
        totals[name] = totals.get(name, 0) + counts[name]
    return out, counts


def s16_graph_runs(typed, dev):
    """Phase 41: the reference-named `Graph` methods on the card, each
    through `Graph._device_graph` (no alias tables, no ELL table), each
    with the counts set to 0 just before it and read just after (summed
    into the kernels line's `compat_launches`), each equal to its op
    launched directly under a generator seeded alike (those launches
    counted nowhere): `node2vec` at p = q = 1 (K1) and at S16_PQ (K10),
    its walks rebuilt from the pairs' layout and every step held to be an
    arc; `get_edge_prediction_mini_batch` at S16_EDGE_SLOTS (K6), its
    positives arcs and its labels ones then zeros; both siamese batches at
    S6_BATCH (K14), their positives arcs, one side kept, the types the
    arcs'; `get_all_edge_metrics_from_node_ids` on K8_PAIRS pairs (K8 at the
    largest degree) against the host copy; then the zero-argument sweep on
    the 120-node typed fixture, each method that runs on a device against
    its CPU route. Returns a dict of what the phase's line prints."""
    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.graph.metrics import edge_metrics as host_edge_metrics
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.ops.negatives import (
        edge_prediction_mini_batch, siamese_mini_batch,
    )
    from embiggen_tpu_torch.ops.walks import node2vec_batch

    out, totals, launches = {}, {}, {}
    t0 = time.perf_counter()
    tg = typed._device_graph(dev)
    keys = arc_keys(typed, dev)
    out["export_s"] = time.perf_counter() - t0
    n = typed.number_of_nodes

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    per_walk = WALK - 2 * WINDOW
    for label, weights, kernel in (("K1", {}, "first_order_walks"),
                                   ("K10", S16_PQ, "rejection_walks")):
        t0 = time.perf_counter()
        (contexts, words), counts = _through_graph(
            lambda: typed.node2vec(41, BATCH, WALK, window_size=WINDOW, device=dev,
                                   **weights), totals)
        secs = time.perf_counter() - t0
        launches[f"node2vec {label}"] = check_launches(
            f"Graph.node2vec {label}", counts, (kernel,),
            tuple(k for k in S16_WALK_KERNELS if k != kernel))
        g = gen(41)
        starts = torch.randint(0, n, (BATCH,), generator=g, device=dev, dtype=torch.int32)
        want = node2vec_batch(tg, starts, WALK, WINDOW, g, max_neighbours=100, **weights)
        if not (torch.equal(on_card(contexts), want[0]) and torch.equal(on_card(words), want[1])):
            raise AssertionError(f"Graph.node2vec {label} differs from node2vec_batch")
        c, w = want
        walks = torch.cat([c[::per_walk, :WINDOW], w.reshape(-1, per_walk),
                           c[per_walk - 1::per_walk, WINDOW:]], dim=1)
        if not torch.equal(walks[:, 0], starts):
            raise AssertionError(f"Graph.node2vec {label}: the walks do not start at the starts")
        arc_positions(typed, walks, keys)
        out[f"node2vec {label}"] = dict(seconds=secs, pairs=int(w.numel()))
        del contexts, words, want, c, w, walks

    t0 = time.perf_counter()
    (src, dst, labels), counts = _through_graph(
        lambda: typed.get_edge_prediction_mini_batch(42, S16_EDGE_SLOTS, device=dev), totals)
    secs = time.perf_counter() - t0
    launches["edge batch"] = check_launches("Graph.get_edge_prediction_mini_batch", counts,
                                            ("edge_prediction_mini_batch",))
    want = edge_prediction_mini_batch(tg, gen(42), S16_EDGE_SLOTS)
    if not all(torch.equal(on_card(a), b) for a, b in zip((src, dst, labels), want)):
        raise AssertionError("Graph.get_edge_prediction_mini_batch differs from its op")
    n_pos = S16_EDGE_SLOTS // 2
    if not (np.array_equal(labels, np.r_[np.ones(n_pos), np.zeros(n_pos)])
            and typed.has_edges(src[:n_pos], dst[:n_pos]).all()):
        raise AssertionError("Graph.get_edge_prediction_mini_batch: labels or positives")
    out["edge batch"] = dict(seconds=secs, slots=S16_EDGE_SLOTS)

    for with_types in (False, True):
        label = "siamese typed" if with_types else "siamese"
        method = (typed.get_siamese_mini_batch_with_edge_types if with_types
                  else typed.get_siamese_mini_batch)
        t0 = time.perf_counter()
        batch, counts = _through_graph(lambda: method(43, S6_BATCH, device=dev), totals)
        secs = time.perf_counter() - t0
        launches[label] = check_launches(f"Graph {label} batch", counts, ("siamese_mini_batch",))
        want = siamese_mini_batch(tg, gen(43), S6_BATCH, with_edge_types=with_types)
        if len(batch) != 4 + with_types or not torch.equal(on_card(np.stack(batch)), want):
            raise AssertionError(f"Graph {label} batch differs from siamese_mini_batch")
        s, d, cs, cd = batch[:4]
        arcs = typed.get_edge_ids(s, d)
        if not ((arcs >= 0).all() and ((cs == s) | (cd == d)).all()
                and (not with_types or np.array_equal(batch[4], typed.edge_types[arcs]))):
            raise AssertionError(f"Graph {label} batch: positives, corruption or types")
        out[label] = dict(seconds=secs, batch=S6_BATCH)

    rng = np.random.default_rng(41)
    arc = rng.integers(0, typed.number_of_directed_edges, K8_PAIRS // 2)
    src = np.concatenate([typed.sources[arc], rng.integers(0, n, K8_PAIRS - len(arc))])
    dst = np.concatenate([typed.col_idx[arc], rng.integers(0, n, K8_PAIRS - len(arc))])
    t0 = time.perf_counter()
    got, counts = _through_graph(
        lambda: typed.get_all_edge_metrics_from_node_ids(src, dst, device=dev), totals)
    secs = time.perf_counter() - t0
    launches["edge metrics"] = check_launches("Graph.get_all_edge_metrics_from_node_ids",
                                              counts, ("edge_metrics",))
    host = host_edge_metrics(typed, src[:S15_HOST_PAIRS], dst[:S15_HOST_PAIRS])
    k8_err = float(np.abs(got[:S15_HOST_PAIRS].astype(np.float64) - host).max())
    k8_against("through Graph.get_all_edge_metrics_from_node_ids against the host copy",
               on_card(got[:S15_HOST_PAIRS]), on_card(host), tg.degrees.long(),
               on_card(src[:S15_HOST_PAIRS].astype(np.int32)),
               on_card(dst[:S15_HOST_PAIRS].astype(np.int32)))
    if not k8_err <= S16_K8_HOST_ATOL:
        raise AssertionError(f"Graph edge metrics against the host copy: {k8_err}")
    out["edge metrics"] = dict(seconds=secs, pairs=K8_PAIRS, host_max_abs_err=k8_err,
                               cap=tg.max_degree)

    t0 = time.perf_counter()
    small = erdos_renyi(120, 400, seed=3, weighted=True, n_edge_types=3, n_node_types=2,
                        name="TypedER")
    swept, raised, on_device = 0, {}, 0
    for name, fn in inspect.getmembers(type(small), inspect.isfunction):
        if name.startswith("_") or name in ("device", "from_edge_arrays"):
            continue
        params = inspect.signature(fn).parameters.values()
        if any(p.name != "self" and p.default is inspect.Parameter.empty
               and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD) for p in params):
            continue
        swept += 1
        kwargs = {"device": dev} if "device" in inspect.signature(fn).parameters else {}
        try:
            got, counts = _through_graph(lambda: getattr(small, name)(**kwargs), totals)
        except (ValueError, ModuleNotFoundError) as exc:
            raised[name] = type(exc).__name__
            continue
        if kwargs:
            on_device += 1
            check_launches(f"Graph.{name}", counts, ("edge_metrics",))
            check_close(f"Graph.{name} card against CPU", torch.from_numpy(got),
                        torch.from_numpy(getattr(small, name)(device="cpu")), **K8_SUM_TOL)
    expected = {"must_have_node_ontologies": "ValueError",
                "get_shared_ancestors_size_adjacency_matrix": "ValueError",
                "get_shared_ancestors_jaccard_adjacency_matrix": "ValueError"}
    try:
        import pandas  # noqa: F401
    except ModuleNotFoundError:
        expected["get_edge_data"] = "ModuleNotFoundError"
    if raised != expected:
        raise AssertionError(f"the zero-argument sweep raised {raised}, expected {expected}")
    out["sweep"] = dict(seconds=time.perf_counter() - t0, methods=swept, on_device=on_device,
                        raised=raised)
    out["launches"] = launches
    out["compat_launches"] = totals
    del tg, keys
    typed.__dict__.pop("_device_graphs", None)
    torch.cuda.empty_cache()
    return out


def _random_dag(n, seed):
    """Each node but 0 with up to 3 parents of smaller id, arcs child ->
    parent."""
    from embiggen_tpu_torch.graph import Graph

    rng = np.random.default_rng(seed)
    child = np.repeat(np.arange(1, n), 3)
    parent = (rng.random(len(child)) * child).astype(np.int64)
    return Graph.from_edge_arrays(child, parent, n_nodes=n, directed=True, name="dag")


def _orthogonality_err(name, emb):
    """The largest off-diagonal entry of EᵀE over its largest diagonal one
    (each embedding's columns are eigenvectors or singular vectors, scaled
    or not), and for the unscaled rows the largest |diagonal - 1|."""
    e = emb.astype(np.float64)
    gram = e.T @ e
    diag = np.diag(gram)
    off = np.abs(gram - np.diag(diag)).max() / max(float(diag.max()), 1e-300)
    if name in ("Laplacian Eigenmaps", "SocioDim"):
        off = max(off, float(np.abs(diag - 1).max()))
    return float(off)


def s16_spectral_runs(dev):
    """Phase 42: the four spectral rows on the card's host (scipy ARPACK,
    float64; no kernel, so every count stays 0) at the default
    embedding_size on erdos_renyi(S16_SPECTRAL_NODES, S16_SPECTRAL_EDGES):
    fit seconds, each embedding finite, of its shape, its columns
    orthogonal (orthonormal for the unscaled rows) within S16_ORTHO_TOL;
    HOPE at "Resnik" on a random DAG; then the gate: edge_prediction_
    evaluation of a Perceptron on Hadamard with HOPE as the node features
    on the gate fixture, K5 launched, test AUROC at least the reference's
    less 0.03. Returns a dict of what the phase's line prints."""
    from embiggen_tpu_torch.graph import erdos_renyi, random_geometric
    from embiggen_tpu_torch.models import get_model_from_library
    from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
    from embiggen_tpu_torch.models.embedders import HOPE
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.pipelines import edge_prediction_evaluation

    out = {}
    g = erdos_renyi(S16_SPECTRAL_NODES, S16_SPECTRAL_EDGES, seed=0)
    _build.reset_launch_counts()
    for name in S16_SPECTRAL_ROWS:
        t0 = time.perf_counter()
        result = get_model_from_library(name, task_name="Node Embedding")(
            device=dev).fit_transform(g)
        secs = time.perf_counter() - t0
        embs = [np.asarray(e) for e in result.node_embeddings]
        if len(embs) != (2 if name == "HOPE" else 1) or any(
                e.shape != (S16_SPECTRAL_NODES, 100) or not np.isfinite(e).all() for e in embs):
            raise AssertionError(f"{name}: {[e.shape for e in embs]}")
        err = max(_orthogonality_err(name, e) for e in embs)
        if not err <= S16_ORTHO_TOL:
            raise AssertionError(f"{name}: columns not orthogonal ({err})")
        out[name] = dict(seconds=secs, orthogonality_err=err)
    dag = _random_dag(S16_DAG_NODES, 42)
    t0 = time.perf_counter()
    embs = HOPE(metric="Resnik", device=dev).fit_transform(dag).node_embeddings
    out["HOPE Resnik"] = dict(seconds=time.perf_counter() - t0, arcs=dag.number_of_directed_edges)
    if not all(np.isfinite(e).all() and e.shape == (S16_DAG_NODES, 100) for e in embs):
        raise AssertionError("HOPE at Resnik on the DAG")
    if any(_build.launch_counts().values()):
        raise AssertionError(f"a spectral row launched a kernel: {_build.launch_counts()}")
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    rows = edge_prediction_evaluation(
        holdouts_number=1, models=PerceptronEdgePrediction(device=dev, **GATE_CBOW_PERCEPTRON),
        graphs=random_geometric(1000, radius=0.07, seed=42), node_features=HOPE(device=dev),
        evaluation_schema="Connected Monte Carlo", random_state=3)
    out["gate launches"] = check_launches("HOPE gate", _build.launch_counts(), S2_KERNELS)
    auroc = next(r for r in rows if r["evaluation_mode"] == "test")["auroc"]
    if not auroc >= GATE_REFERENCE_HOPE_AUROC - 0.03:
        raise AssertionError(f"HOPE gate test AUROC {auroc} is below the reference's "
                             f"{GATE_REFERENCE_HOPE_AUROC} less 0.03")
    out["gate"] = dict(seconds=time.perf_counter() - t0, auroc=float(auroc))
    return out


# ------------------------------------------------------- native host helpers
# The harness's shapes for the native host helpers (phase 35): the binary
# panel's scores, the negative graph's pairs, the forest's graph (the Python
# forest at 1M nodes takes most of a minute), the alias tables' rows held to
# the plain version (its pairing loop is Python), and the parser's lines.
NATIVE_SCORES = 19_000_000
NATIVE_PAIRS = 10_000_000
NATIVE_FOREST = (100_000, 1_000_000)
NATIVE_ALIAS_ROWS = 100_000
NATIVE_LINES = 1_000_000
# The wrappers of `embiggen_tpu_torch.native`, counted in phase 10.
NATIVE_HELPERS = ("alias_tables", "spanning_forest", "radix_argsort",
                  "ranking_metrics_sorted", "sort_pairs", "sort_unique_pairs",
                  "build_sym_csr", "parse_edge_list")


def native_checks(graph, weighted_graph):
    """Phase 35: each native host helper against its plain numpy version on
    the card's host at the harness's shapes, both timed (host seconds):
    the panel's radix argsort (`ops.metrics._stable_argsort` against
    `np.argsort(kind="stable")`) and sweep on NATIVE_SCORES float32 scores,
    `sort_unique_pairs` on NATIVE_PAIRS pairs drawn as the negative graph
    draws them, `build_sym_csr` and `sort_pairs` on the slice graph's
    shuffled edges and arcs, the alias tables of the weighted twin (the
    plain version on its first NATIVE_ALIAS_ROWS rows), the forest on
    erdos_renyi(NATIVE_FOREST) and the parser on a NATIVE_LINES-line file.
    Indices and integers exactly, the alias tables bitwise, the sweep within
    1e-12 relative; raises on the first that differs. Returns {helper:
    {native_s, plain_s, err, shape}}."""
    from embiggen_tpu_torch import native
    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.ops.metrics import _stable_argsort

    out = {}

    def row(name, shape, run_native, run_plain, compare):
        t0 = time.perf_counter()
        got = run_native()
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = run_plain()
        plain_s = time.perf_counter() - t0
        err = compare(got, want)
        if err is None:
            raise AssertionError(f"native {name} differs from its plain version at {shape}")
        out[name] = {"native_s": native_s, "plain_s": plain_s, "err": err, "shape": shape}
        return got

    def exact(got, want):
        pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
        return 0.0 if all(np.array_equal(a, b) for a, b in pairs) else None

    def bitwise(got, want):
        return exact(tuple(a.view(np.uint32) if a.dtype == np.float32 else a for a in got),
                     tuple(a.view(np.uint32) if a.dtype == np.float32 else a for a in want))

    rng = np.random.default_rng(35)
    n = graph.number_of_nodes
    # The panel: a positive's score lifted, float32 probabilities (ties).
    labels = rng.random(NATIVE_SCORES) < 0.5
    scores = (1 / (1 + np.exp(-(rng.standard_normal(NATIVE_SCORES) + 1.5 * labels)))
              ).astype(np.float32)
    order = row("radix_argsort", f"{NATIVE_SCORES} float32 scores",
                lambda: _stable_argsort(scores), lambda: np.argsort(scores, kind="stable"),
                exact)
    s_sorted, l_sorted = scores[order].astype(np.float64), labels[order]
    del order

    def rel(got, want):
        e = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        return e if e <= 1e-12 else None

    row("ranking_metrics_sorted", f"{NATIVE_SCORES} sorted scores",
        lambda: native.ranking_metrics_sorted(s_sorted, l_sorted),
        lambda: native.ranking_metrics_sorted_plain(s_sorted, l_sorted), rel)
    del labels, scores, s_sorted, l_sorted
    # The negative graph's round: degree-distributed ends, canonical pairs.
    heads = graph.sources
    a = heads[rng.integers(0, len(heads), NATIVE_PAIRS)].astype(np.int64)
    b = heads[rng.integers(0, len(heads), NATIVE_PAIRS)].astype(np.int64)
    src, dst = np.minimum(a, b), np.maximum(a, b)
    del a, b
    row("sort_unique_pairs", f"{NATIVE_PAIRS} pairs over {n} nodes",
        lambda: native.sort_unique_pairs(src, dst, n),
        lambda: native.sort_unique_pairs_plain(src, dst, n), exact)
    # The slice graph's edges, shuffled, built again; and its arcs sorted.
    canon = np.flatnonzero(graph.sources <= graph.col_idx)
    perm = rng.permutation(canon)
    src, dst = graph.sources[perm], graph.col_idx[perm]
    built = row("build_sym_csr", f"{len(perm)} edges over {n} nodes",
                lambda: native.build_sym_csr(src, dst, n),
                lambda: native.build_sym_csr_plain(src, dst, n), exact)
    if exact(built, (graph.row_ptr, graph.col_idx)) is None:
        raise AssertionError("build_sym_csr did not rebuild the slice graph")
    perm = rng.permutation(graph.number_of_directed_edges)
    src, dst = graph.sources[perm], graph.col_idx[perm]
    row("sort_pairs", f"{len(perm)} arcs over {n} nodes",
        lambda: native.sort_pairs(src, dst, n), lambda: native.sort_pairs_plain(src, dst, n),
        exact)
    del canon, perm, src, dst, built
    # The weighted twin's alias tables: whole natively, the plain version's
    # rows against the same rows of the whole tables.
    w_ptr, w = weighted_graph.row_ptr, weighted_graph.weights
    t0 = time.perf_counter()
    prob, alias = native.alias_tables(w_ptr, w)
    whole_s = time.perf_counter() - t0
    cut = int(w_ptr[NATIVE_ALIAS_ROWS])
    row("alias_tables", f"{NATIVE_ALIAS_ROWS} rows, {cut} arcs of the weighted twin",
        lambda: native.alias_tables(w_ptr[:NATIVE_ALIAS_ROWS + 1], w[:cut]),
        lambda: native.alias_tables_plain(w_ptr[:NATIVE_ALIAS_ROWS + 1], w[:cut]), bitwise)
    if bitwise((prob[:cut], alias[:cut]),
               native.alias_tables_plain(w_ptr[:NATIVE_ALIAS_ROWS + 1], w[:cut])) is None:
        raise AssertionError("the whole graph's alias tables differ on its first rows")
    out["alias_tables"]["native_whole_s"] = whole_s
    out["alias_tables"]["whole_arcs"] = int(len(w))
    del prob, alias
    # The forest of connected_holdout on a 100,000-node graph.
    fg = erdos_renyi(*NATIVE_FOREST, seed=1)
    keep = fg.sources <= fg.col_idx
    f_src, f_dst = fg.sources[keep], fg.col_idx[keep]
    f_order = np.random.default_rng(0).permutation(len(f_src))
    row("spanning_forest", f"{len(f_src)} edges over {NATIVE_FOREST[0]} nodes",
        lambda: native.spanning_forest(f_src, f_dst, f_order, NATIVE_FOREST[0]),
        lambda: native.spanning_forest_plain(f_src, f_dst, f_order, NATIVE_FOREST[0]), exact)
    # The parser: the slice graph's first edges as named, weighted, typed rows.
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "edges.tsv")
        ids = rng.permutation(NATIVE_LINES)
        with open(path, "w") as f:
            f.write("subject\tobject\tweight\tedge_label\n")
            f.write("".join(f"v{s}\tv{d}\t{x:.3f}\tt{k}\n" for s, d, x, k in zip(
                graph.sources[ids].tolist(), graph.col_idx[ids].tolist(),
                rng.uniform(0.5, 2.0, NATIVE_LINES).tolist(),
                rng.integers(0, 8, NATIVE_LINES).tolist())))
        kw = dict(weight_col=2, type_col=3)
        row("parse_edge_list", f"{NATIVE_LINES} lines",
            lambda: native.parse_edge_list(path, **kw),
            lambda: native.parse_edge_list_plain(path, **kw), exact)
    return out


class native_calls:
    """Within the block, every wrapper of `embiggen_tpu_torch.native` counts
    its calls and host seconds; read `.counts` after it."""

    def __init__(self):
        from embiggen_tpu_torch import native

        self.native = native
        self.counts = {name: {"calls": 0, "s": 0.0} for name in NATIVE_HELPERS}

    def __enter__(self):
        self.saved = {name: getattr(self.native, name) for name in NATIVE_HELPERS}
        for name, fn in self.saved.items():
            def counted(*args, _fn=fn, _entry=self.counts[name], **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    _entry["calls"] += 1
                    _entry["s"] += time.perf_counter() - t0
            setattr(self.native, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.native, name, fn)


# Phase 43 (A12): the fits resumed after a kill, at the slice's widths.
A12_S1_EPOCHS, A12_GCN_EPOCHS, A12_LINE_EPOCHS = 3, 3, 2
A12_S1_KILL, A12_GCN_KILL, A12_LINE_KILL = 2, 2, 1   # saves before the kill
A12_PAIRS = 1 << 16
A12_KERNELS = {"S1": S1_KERNELS, "GCN": S3_KERNELS, "LINE": S6_LINE_KERNELS}


class _Saves:
    """`save_pytree` wrapped: each save's seconds and bytes, the last saved
    tree (its structure) and its leaves copied to the host, and a simulated
    kill (KeyboardInterrupt) after `kill_after` saves, each completed first."""

    def __init__(self, real, kill_after=None):
        self.real, self.kill_after = real, kill_after
        self.seconds, self.bytes = [], []
        self.path = self.tree = self.leaves = None

    def __call__(self, path, tree, **kw):
        from embiggen_tpu_torch.utils.checkpoint import _flatten, _host

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.real(path, tree, **kw)
        self.seconds.append(time.perf_counter() - t0)
        self.bytes.append(Path(path + ".npz").stat().st_size)
        self.path, self.tree = path, tree
        self.leaves = [np.array(_host(leaf), copy=True) for leaf in _flatten(tree)]
        if self.kill_after is not None and len(self.seconds) >= self.kill_after:
            raise KeyboardInterrupt("simulated kill")


class _FirstBatch:
    """A batch draw wrapped: a copy of the batch it returns at call `index`
    (0-based)."""

    def __init__(self, draw, index):
        self.draw, self.index, self.calls, self.batch = draw, index, 0, None

    def __call__(self, *args, **kwargs):
        out = self.draw(*args, **kwargs)
        if self.calls == self.index:
            self.batch = [t.clone() for t in _model_tensors(out)]
        self.calls += 1
        return out


def _reloads_bit_for_bit(name, saves):
    """Load the checkpoint the killed fit left, in the structure of the last
    save, and hold every leaf (tables, Adam's moments and steps, generator
    states, the draws' key and offset) to what that save wrote, byte for
    byte. Returns the draws' rows of the checkpoint."""
    from embiggen_tpu_torch.utils.checkpoint import _flatten, _host, load_pytree

    state = load_pytree(saves.path, like=saves.tree)
    loaded = [_host(leaf) for leaf in _flatten(state)]
    if len(loaded) != len(saves.leaves):
        raise AssertionError(f"{name}: the checkpoint holds {len(loaded)} leaves, the save "
                             f"wrote {len(saves.leaves)}")
    for i, (a, b) in enumerate(zip(loaded, saves.leaves)):
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            raise AssertionError(f"{name}: leaf {i} of the checkpoint differs from what "
                                 "the save wrote")
    rows = np.asarray(state["rng"]["draws"]).tolist()
    if not rows or min(min(r) for r in rows) < 0:
        raise AssertionError(f"{name}: the checkpoint's draws {rows} hold no key and offset")
    return rows


def _resumed_against(name, full, resumed, batch_full, batch_resumed):
    """The first batch after the resume against the uninterrupted fit's at
    that step (exactly), and the resumed fit's final tables against the two
    uninterrupted fits': the difference to the nearer within max(4 x the
    difference between the two, 1e-5). Returns the three numbers."""
    if batch_full is None or batch_resumed is None:
        raise AssertionError(f"{name}: a first batch was not drawn")
    if not all(torch.equal(a, b) for a, b in zip(batch_full, batch_resumed)):
        raise AssertionError(f"{name}: the first batch after the resume differs from the "
                             "uninterrupted fit's at that step")
    between = max(float(np.abs(a - b).max()) for a, b in zip(full[0], full[1]))
    resumed_err = min(max(float(np.abs(a - b).max()) for a, b in zip(f, resumed))
                      for f in full)
    limit = max(4 * between, 1e-5)
    if not resumed_err <= limit:
        raise AssertionError(f"{name}: the resumed fit differs from the uninterrupted ones by "
                             f"{resumed_err:.3g}, over {limit:.3g} (they differ by "
                             f"{between:.3g})")
    return dict(uninterrupted_diff=between, resumed_diff=resumed_err, limit=limit)


def _kill_resume(name, make, fit, patch_batch, resume_step, kill_after, totals):
    """Two uninterrupted fits of `make(None)`; a fit of `make(directory)`
    killed after `kill_after` saves, whose checkpoint must reload bit for
    bit; and the resumed fit, with the launch counts set to 0 just before it
    and read just after (added to `totals`). `fit(model)` returns the
    result's arrays; `patch_batch(index)` wraps the fits' batch draw, keeping
    the batch of call `index` (`resume_step`, the first step after the save
    the resume starts from, in the uninterrupted fits; 0 in the resumed one),
    and returns (the wrapper, an undo). Returns (the resumed model, its
    result, the numbers the phase prints)."""
    import embiggen_tpu_torch.utils.checkpoint as ck
    from embiggen_tpu_torch.ops import _build

    out = {"save_s": [], "save_bytes": []}
    with tempfile.TemporaryDirectory(prefix="a12_") as directory:
        full, batch_full = [], None
        for _ in range(2):
            first, undo = patch_batch(resume_step)
            try:
                t0 = time.perf_counter()
                full.append(fit(make(None)))
                out.setdefault("uninterrupted_s", []).append(time.perf_counter() - t0)
            finally:
                undo()
            batch_full = batch_full or first.batch
        saves = _Saves(ck.save_pytree, kill_after)
        ck.save_pytree = saves
        try:
            t0 = time.perf_counter()
            fit(make(directory))
            raise AssertionError(f"{name}: the fit was not killed")
        except KeyboardInterrupt:
            out["killed_s"] = time.perf_counter() - t0
        finally:
            ck.save_pytree = saves.real
        out["save_s"] += saves.seconds
        out["save_bytes"] += saves.bytes
        out["draws"] = _reloads_bit_for_bit(name, saves)
        del saves
        resumed_saves = _Saves(ck.save_pytree)
        ck.save_pytree = resumed_saves
        first, undo = patch_batch(0)
        try:
            model = make(directory)
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            resumed = fit(model)
            torch.cuda.synchronize()
            out["resumed_s"] = time.perf_counter() - t0
            counts = _build.launch_counts()
        finally:
            ck.save_pytree = resumed_saves.real
            undo()
        out["save_s"] += resumed_saves.seconds
        out["save_bytes"] += resumed_saves.bytes
        left = [p.name for p in Path(directory).iterdir()]
        if left:
            raise AssertionError(f"{name}: the completed fit left {left}")
    out["launches"] = check_launches(f"{name} resumed", counts, A12_KERNELS[name])
    for k, v in out["launches"].items():
        totals[k] = totals.get(k, 0) + v
    out.update(_resumed_against(name, full, resumed, batch_full, first.batch))
    return model, resumed, out


def _patch_method(model_cls, attr, index):
    """Wrap the method `model_cls.attr` (a batch draw) with `_FirstBatch`;
    returns (the wrapper, an undo)."""
    own, real = vars(model_cls).get(attr), getattr(model_cls, attr)
    first = _FirstBatch(real, index)
    setattr(model_cls, attr, lambda self, *a, **k: first(self, *a, **k))
    return first, lambda: (setattr(model_cls, attr, own) if own is not None
                           else delattr(model_cls, attr))


def a12_resume_runs(graph, dev):
    """Phase 43's resumed fits on the slice graph at full width: S1
    (Node2Vec SkipGram at S1's widths, batch BATCH), the bench GCN
    (GCNEdgePrediction, batch GCN_BATCH, units 128-128, seeded [N, 128]
    features) and Second-order LINE at S6's settings, each killed after its
    A12_*_KILL-th save and resumed (`_kill_resume`). Returns (the numbers by
    fit, the resumed GCN, the resumed S1 result, the launch totals)."""
    from embiggen_tpu_torch.models.embedders import SecondOrderLINE, SkipGram
    from embiggen_tpu_torch.models.gcn import GCNEdgePrediction
    from embiggen_tpu_torch.models.gcn import edge as gcn_edge
    from embiggen_tpu_torch.pipelines import embed_graph

    totals, out = {}, {}
    s1_steps = N_NODES // BATCH
    s1_result = {}

    def s1_make(directory):
        return SkipGram(device=dev, embedding_size=DIM, walk_length=WALK, window_size=WINDOW,
                        number_of_negative_samples=NEGS, batch_size=BATCH,
                        epochs=A12_S1_EPOCHS, random_state=0, early_stopping_patience=10**6,
                        checkpoint_dir=directory, checkpoint_interval=1)

    def s1_fit(model):
        result = embed_graph(graph, model)
        s1_result["last"] = result
        return [np.asarray(e) for e in result.node_embeddings]

    _, _, out["S1"] = _kill_resume(
        "S1", s1_make, s1_fit, lambda i: _patch_method(SkipGram, "_sample_batch", i),
        A12_S1_KILL * s1_steps, A12_S1_KILL, totals)

    feats = np.random.default_rng(0).standard_normal((N_NODES, DIM), dtype=np.float32)
    gcn_steps = graph.number_of_directed_edges // GCN_BATCH

    def gcn_make(directory):
        return GCNEdgePrediction(epochs=A12_GCN_EPOCHS, batch_size=GCN_BATCH,
                                 early_stopping_patience=10**6, random_state=0, device=dev,
                                 checkpoint_dir=directory, checkpoint_interval=1)

    def gcn_fit(model):
        from embiggen_tpu_torch.models.gcn.core import param_leaves

        model.fit(graph, node_features=feats)
        return [t.detach().cpu().numpy() for t in param_leaves(model._params)]

    def gcn_patch(index):
        real = gcn_edge.edge_prediction_mini_batch
        first = gcn_edge.edge_prediction_mini_batch = _FirstBatch(real, index)
        return first, lambda: setattr(gcn_edge, "edge_prediction_mini_batch", real)

    gcn, _, out["GCN"] = _kill_resume("GCN", gcn_make, gcn_fit, gcn_patch,
                                      A12_GCN_KILL * gcn_steps, A12_GCN_KILL, totals)
    del feats
    line_steps = graph.number_of_directed_edges // S6_BATCH

    def line_make(directory):
        return SecondOrderLINE(device=dev, embedding_size=DIM, batch_size=S6_BATCH,
                               epochs=A12_LINE_EPOCHS, random_state=0,
                               early_stopping_patience=10**6, checkpoint_dir=directory,
                               checkpoint_interval=1)

    def line_fit(model):
        return [np.asarray(e) for e in embed_graph(graph, model).node_embeddings]

    _, _, out["LINE"] = _kill_resume(
        "LINE", line_make, line_fit,
        lambda i: _patch_method(SecondOrderLINE, "_sample_batch", i),
        A12_LINE_KILL * line_steps, A12_LINE_KILL, totals)
    torch.cuda.empty_cache()
    return out, gcn, s1_result["last"], totals


def a12_persistence_and_cache_runs(graph, gcn, s1_result, dev):
    """Phase 43's persistence and caches: `dump_model` of the resumed GCN and
    `EmbeddingResult.dump` of the resumed S1 embedding, both loaded on the
    CPU (every tensor there), the GCN's `predict_proba` on A12_PAIRS pairs
    through the CPU route against the card's within 1e-5; `embed_graph(...,
    enable_cache=True)` twice on the slice graph (one S1 epoch) and
    `edge_prediction_evaluation(..., enable_cache=True)` twice on the gate
    fixture, the second call of each launching no kernel and returning what
    the first did; and the visualizer imported on this host, its fit
    raising the ImportError of the package missing here. Returns the
    numbers the phase prints."""
    import embiggen_tpu_torch.utils.cache as cache_mod
    from embiggen_tpu_torch.graph import random_geometric
    from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
    from embiggen_tpu_torch.models.embedding_result import EmbeddingResult
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.pipelines import edge_prediction_evaluation, embed_graph
    from embiggen_tpu_torch.utils import dump_model, load_model

    out = {}
    rng = np.random.default_rng(43)
    src = rng.integers(0, N_NODES, A12_PAIRS)
    dst = rng.integers(0, N_NODES, A12_PAIRS)
    with tempfile.TemporaryDirectory(prefix="a12_") as directory:
        path = str(Path(directory) / "gcn.pkl.gz")
        t0 = time.perf_counter()
        dump_model(gcn, path)
        out["dump_s"], out["dump_bytes"] = time.perf_counter() - t0, Path(path).stat().st_size
        t0 = time.perf_counter()
        loaded = load_model(path, device="cpu")
        out["load_s"] = time.perf_counter() - t0
        devices = {t.device.type for t in _model_tensors(loaded)}
        if devices != {"cpu"} or loaded.device.type != "cpu":
            raise AssertionError(f"the loaded GCN holds tensors on {devices}")
        t0 = time.perf_counter()
        on_card = gcn.predict_proba_from_edge_node_ids(src, dst)
        on_cpu = loaded.predict_proba_from_edge_node_ids(src, dst)
        out["predict_s"] = time.perf_counter() - t0
        out["predict_err"] = float(np.abs(on_card - on_cpu).max())
        if not out["predict_err"] <= 1e-5:
            raise AssertionError(f"the loaded GCN's CPU predictions differ from the card's by "
                                 f"{out['predict_err']:.3g}")
        del loaded
        path = str(Path(directory) / "embedding.pkl")
        t0 = time.perf_counter()
        s1_result.dump(path)
        back = EmbeddingResult.load(path)
        out["embedding_dump_load_s"] = time.perf_counter() - t0
        out["embedding_bytes"] = Path(path).stat().st_size
        if not all(isinstance(b, np.ndarray) and np.array_equal(a, b) for a, b in zip(
                s1_result.node_embeddings, back.node_embeddings)):
            raise AssertionError("the S1 embedding did not round-trip")
        del back

        cache_dir = str(Path(directory) / "cache")
        default_dir, cache_mod.DEFAULT_CACHE_DIR = cache_mod.DEFAULT_CACHE_DIR, cache_dir
        calls = []
        for _ in range(2):
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            calls.append(embed_graph(
                graph, "Node2Vec SkipGram", device=dev, embedding_size=DIM, walk_length=WALK,
                window_size=WINDOW, number_of_negative_samples=NEGS, batch_size=BATCH,
                epochs=1, random_state=0, enable_cache=True))
            torch.cuda.synchronize()
            out.setdefault("embedding_cache_s", []).append(time.perf_counter() - t0)
            out.setdefault("embedding_cache_launches", []).append(
                sum(_build.launch_counts().values()))
        cache_mod.DEFAULT_CACHE_DIR = default_dir
        if (out["embedding_cache_launches"][0] == 0 or out["embedding_cache_launches"][1]
                or not all(np.array_equal(a, b) for a, b in zip(
                    calls[0].node_embeddings, calls[1].node_embeddings))):
            raise AssertionError(f"the embedding cache: launches "
                                 f"{out['embedding_cache_launches']}, or unequal results")
        out["embedding_cache_bytes"] = sum(p.stat().st_size for p in Path(cache_dir).rglob("*")
                                           if p.is_file())
        del calls
        rgg = random_geometric(1000, radius=0.07, seed=42)
        rows = []
        for _ in range(2):
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            rows.append(edge_prediction_evaluation(
                holdouts_number=1, models=PerceptronEdgePrediction(
                    edge_features=GATE_PERCEPTRON["edge_features"], number_of_epochs=100,
                    random_state=0, device=dev),
                graphs=rgg, evaluation_schema="Connected Monte Carlo", random_state=3,
                enable_cache=True, cache_dir=cache_dir))
            torch.cuda.synchronize()
            out.setdefault("experiment_cache_s", []).append(time.perf_counter() - t0)
            out.setdefault("experiment_cache_launches", []).append(
                sum(_build.launch_counts().values()))
        if (out["experiment_cache_launches"][0] == 0 or out["experiment_cache_launches"][1]
                or rows[0] != rows[1]):
            raise AssertionError(f"the experiment cache: launches "
                                 f"{out['experiment_cache_launches']}, or unequal rows")
        out["experiment_auprc"] = [r["auprc"] for r in rows[1]]
    out["visualizer"] = a12_visualizer_check(rgg)
    return out


def _model_tensors(obj, seen=None):
    """Every tensor reachable from `obj` through containers and instance
    attributes."""
    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, type):
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    items = (obj.values() if isinstance(obj, dict) else obj if isinstance(obj, (list, tuple))
             else vars(obj).values() if hasattr(obj, "__dict__") else ())
    return [t for v in items for t in _model_tensors(v, seen)]


def a12_visualizer_check(graph):
    """Import the visualizer on this host; fit it by PCA on D-wide features
    of `graph` and plot: where scikit-learn is missing the fit raises its
    ImportError, else where matplotlib is missing the plot raises that one.
    Returns what was missing and raised."""
    import importlib.util

    from embiggen_tpu_torch.visualizations import GraphVisualizer

    missing = [m for m in ("sklearn", "matplotlib") if importlib.util.find_spec(m) is None]
    viz = GraphVisualizer(graph, decomposition_method="PCA")
    x = np.random.default_rng(0).standard_normal((graph.number_of_nodes, DIM),
                                                 dtype=np.float32)
    raised = None
    try:
        viz.fit_nodes(x)
        viz.plot_nodes()
    except ImportError as e:
        raised = e.name.split(".")[0]
    if raised != (missing[0] if missing else None):
        raise AssertionError(f"the visualizer raised for {raised}; missing here: {missing}")
    return dict(missing=missing, raised=raised)


def check_launches(path, counts, names, unused=()):
    """The counts of `names` after a path's run; raises if one is 0, or if
    one of `unused` launched."""
    got = {name: counts[name] for name in names}
    if min(got.values()) <= 0:
        raise AssertionError(f"a kernel of the {path} path never launched: {got}")
    if any(counts[name] for name in unused):
        raise AssertionError(f"the {path} path launched one of {unused}: {counts}")
    return got


def quality_phases(card, dev) -> None:
    """Phases 9, 13, 16, 20, 23, 27, 30 and 38: the quality gates, each printing
    its line; the first that fails raises. They train small models on the
    gate fixture (S10's on a small typed graph), host-bound work that times
    no kernel, so `main` runs them in a process of their own
    (`--quality`) beside the host helpers of phase 35 and the flagship
    harness of phase 10."""
    # ----------------------------------------------------------- 9. quality
    t_phase = time.perf_counter()
    gate, gate_launches, gcn_quality = quality_on_card(card, dev)
    gate_launches = check_launches("gate", gate_launches,
                                   S1_KERNELS + S2_KERNELS + K8_KERNELS)
    print(f"phase 9 quality on {card} ({time.perf_counter() - t_phase:.1f} s): "
          "random_geometric(1000, 0.07), connected holdout 3: Perceptron gate "
          f"through edge_prediction_evaluation test AUROC {gate['auroc']:.4f} "
          f"AUPRC {gate['auprc']:.4f} (reference AUPRC "
          f"{GATE_REFERENCE_PERCEPTRON_AUPRC:.4f}), launches {gate_launches}; GCN "
          f"mean test AUROC / AUPRC over seeds 0-7 "
          f"{np.mean([a for a, _ in gcn_quality]):.4f} / "
          f"{np.mean([p for _, p in gcn_quality]):.4f} (reference mean AUPRC "
          f"{GATE_REFERENCE_GCN_AUPRC:.4f}; per seed AUPRC "
          f"{[round(p, 4) for _, p in gcn_quality]})", flush=True)

    # --------------------------------------------------- 13. S5 quality
    t_phase = time.perf_counter()
    cbow_auprc = cbow_quality_on_card(card, dev)
    print(f"phase 13 S5 quality on {card} ({time.perf_counter() - t_phase:.1f} s): "
          "random_geometric(1000, 0.07), connected holdout 3: Node2Vec CBOW return 2 "
          "explore 0.5 features, a Perceptron on Hadamard, mean test AUPRC over "
          f"seeds 0-3 {np.mean(cbow_auprc):.4f} (reference {GATE_REFERENCE_CBOW_AUPRC:.4f}; "
          f"per seed {[round(a, 4) for a in cbow_auprc]})", flush=True)

    # --------------------------------------------------- 16. S6 quality
    t_phase = time.perf_counter()
    s6_auroc = s6_quality_on_card(card, dev)
    print(f"phase 16 S6 quality on {card} ({time.perf_counter() - t_phase:.1f} s): "
          "random_geometric(1000, 0.07), fitted whole, edges against as many negatives: "
          f"First-order LINE dot-product AUROC {s6_auroc['First-order LINE']:.4f} (reference "
          f"{GATE_REFERENCE_LINE1_AUROC:.4f}); Unstructured distance AUROC "
          f"{s6_auroc['Unstructured']:.4f} (reference {GATE_REFERENCE_UNSTRUCTURED_AUROC:.4f})",
          flush=True)

    # --------------------------------------------------- 20. S7 quality
    t_phase = time.perf_counter()
    walklets_auroc, glove_auroc = s7_quality_on_card(card, dev)
    print(f"phase 20 S7 quality on {card} ({time.perf_counter() - t_phase:.1f} s): "
          "random_geometric(1000, 0.07), connected holdout 3: Walklets SkipGram gate through "
          f"edge_prediction_evaluation test AUROC {walklets_auroc:.4f} (thresholds "
          f"{GATE_WALKLETS_FLOOR} and the reference's {GATE_REFERENCE_WALKLETS_AUROC} less 0.03 = "
          f"{GATE_REFERENCE_WALKLETS_AUROC - 0.03:.4f}); Node2Vec GloVe features, a Perceptron "
          f"on Hadamard, mean test AUROC over seeds 0-3 {np.mean(glove_auroc):.4f} (threshold "
          f"the reference's {GATE_REFERENCE_GLOVE_AUROC:.4f} less 0.03 = "
          f"{GATE_REFERENCE_GLOVE_AUROC - 0.03:.4f}; per seed "
          f"{[round(a, 4) for a in glove_auroc]})", flush=True)

    # --------------------------------------------------- 23. S8 quality
    t_phase = time.perf_counter()
    spine_auprc, spine_launches, sketch_auroc = s8_quality_on_card(card, dev)
    spine_launches = check_launches("SPINE gate", spine_launches,
                                    S3_KERNELS + S8_SPINE_KERNELS)
    print(f"phase 23 S8 quality on {card} ({time.perf_counter() - t_phase:.1f} s): "
          "random_geometric(1000, 0.07), connected holdout 3: the GCN gate with "
          "Degree-based SPINE features, seed 0 through edge_prediction_evaluation, mean test "
          f"AUPRC over seeds 0-7 {np.mean(spine_auprc):.4f} (threshold the reference's "
          f"{GATE_REFERENCE_SPINE_GCN_AUPRC:.4f} less 0.03 = "
          f"{GATE_REFERENCE_SPINE_GCN_AUPRC - 0.03:.4f}, and 0.80; per seed "
          f"{[round(a, 4) for a in spine_auprc]}), launches {spine_launches}; Kipf GCN with "
          f"HyperSketching features (hops 2, precision 6) on its connected holdout 0: AUROC "
          f"{sketch_auroc:.4f} (floor {GATE_SKETCH_FLOOR})", flush=True)

    # --------------------------------------------------- 27. S9 quality
    t_phase = time.perf_counter()
    s9_auroc = s9_quality_on_card(card, dev)
    print(f"phase 27 S9 quality on {card} ({time.perf_counter() - t_phase:.1f} s): "
          "random_geometric(1000, 0.07), connected holdout 3, a Perceptron on Hadamard, "
          "mean test AUROC over embedding seeds 0-3: " + "; ".join(
              f"{name} {np.mean(a):.4f} (threshold the reference's "
              f"{GATE_REFERENCE_S9_AUROC[name]:.4f} less 0.03 = "
              f"{GATE_REFERENCE_S9_AUROC[name] - 0.03:.4f}; per seed "
              f"{[round(x, 4) for x in a]})" for name, a in s9_auroc.items()), flush=True)

    # -------------------------------------------------- 30. S10 quality
    t_phase = time.perf_counter()
    rates = s10_quality_on_card(card, dev)
    print(f"phase 30 S10 quality on {card} ({time.perf_counter() - t_phase:.1f} s): "
          "erdos_renyi(60, 400, seed=3, weighted, 3 edge types, 4 node types), 30 walks of 10 "
          "from each node, type change rate at node weight 5 against 0.1 (must exceed by 0.1): "
          + "; ".join(f"{route} {a:.4f} against {b:.4f}" for route, (a, b) in rates.items()),
          flush=True)

    # -------------------------------------------------- 38. S14 quality
    t_phase = time.perf_counter()
    accuracy = s14_quality_on_card(card, dev)
    print(f"phase 38 S14 quality on {card} ({time.perf_counter() - t_phase:.1f} s): "
          "planted_partition(1000, 4, p_in 0.05, p_out 0.002, seed 42), Stratified Monte Carlo "
          "holdout 0 at random state 3: the Kipf GCN node-label gate with Degree-based SPINE "
          f"features, test accuracy over model seeds 0-7 {[round(a, 4) for a in accuracy]}, "
          f"mean {np.mean(accuracy):.4f} (each at least {GATE_NODE_LABEL_FLOOR}, the mean at "
          f"least the reference's {GATE_REFERENCE_NODE_LABEL_ACCURACY:.4f} less 0.03)",
          flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also K3's, K11's and K9's phase splits, and profiles of "
                             "steady S1, GCN, S5, S6, S7 and S8 steps and of S9's "
                             "NodeSketch fit")
    parser.add_argument("--quality", action="store_true",
                        help="run only the quality phases (9, 13, 16, 20, 23, 27, 30, 38) on "
                             "the kernels built before; the run without it starts them so")
    args = parser.parse_args()
    t_start = time.perf_counter()
    # ---------------------------------------------------------------- 1. card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on an NVIDIA GPU.")
    from embiggen_tpu_torch.scripts.harness import card_line

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.quality:
        quality_phases(card, torch.device("cuda"))
        return
    print(f"phase 1 card: {card} | torch {torch.__version__} | "
          f"CUDA {torch.version.cuda} | devices {torch.cuda.device_count()}",
          flush=True)

    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.models import get_model_from_library
    from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
    from embiggen_tpu_torch.models.gcn import GCNEdgePrediction, GCNEncoder
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.ops.negatives import (
        BatchDraws, first_order_batch, first_order_batch_plain, nce_negatives,
        nce_negatives_plain,
    )
    from embiggen_tpu_torch.ops.walks import (
        first_order_walks, first_order_walks_plain, random_walks,
    )
    from embiggen_tpu_torch.pipelines import embed_graph
    from embiggen_tpu_torch.scripts import harness, spmm_probe

    # --------------------------------------------------------------- 2. build
    build_s = _build.build(force=True)
    log = (_build.BUILD_DIR / "build.log").read_text()
    regs = [line.split("info    : ")[-1] for line in log.splitlines()
            if "registers" in line]
    print(f"phase 2 build: {build_s:.2f} s with nvcc for sm_90a | ptxas: "
          + "; ".join(regs), flush=True)

    # ------------------------------------------------- 3. K1-K4 vs plain
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    graph = erdos_renyi(N_NODES, N_EDGES, seed=0)
    tg = graph.device(dev, with_sources=True)
    graph_s = time.perf_counter() - t0
    # The other host graphs, built on the worker thread in the order the
    # phases take them: the hub graph and its K7 kernel (phase 4), the
    # weighted twin (21), the typed slice graph (28).
    hub_graph(graph, wait=False)
    queue_hub_kernel(graph)
    later = {"weighted": _GRAPHS_WORKER.submit(erdos_renyi, N_NODES, N_EDGES, seed=0,
                                               weighted=True),
             "typed": _GRAPHS_WORKER.submit(erdos_renyi, N_NODES, N_EDGES, seed=0,
                                            n_edge_types=S10_TYPES, n_node_types=S10_TYPES)}
    kernels = {}

    k1_err, k2_err = sampler_checks(erdos_renyi, first_order_walks,
                                    nce_negatives, dev)
    slice_p = slice_sampler_checks(graph, tg, first_order_walks,
                                   first_order_walks_plain, nce_negatives,
                                   nce_negatives_plain)
    # The slice graph as the walk models export it on the card: with the
    # arcs' records, which K1 and the fused batch read in place of row_ptr.
    tg_walk = graph.device(dev, with_walk_arcs=True)
    fused_err, fused_p = fused_batch_checks(erdos_renyi, graph, tg, tg_walk, dev)
    slice_p.update(fused_p)
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(0)
    cuda_gen = torch.Generator(device=dev).manual_seed(0)
    starts = nce_negatives(tg, gen, (BATCH,), scale_free=False)
    # K1 on the arcs' records walks as K1 on row_ptr from the same key.
    if not torch.equal(*(first_order_walks(t, starts, WALK, torch.Generator().manual_seed(14))
                         for t in (tg, tg_walk))):
        raise AssertionError("K1 on the arcs' records differs from K1 on row_ptr from the "
                             "same key")
    # The walk step's workspace, as a fit holds it (one key, an offset a
    # launch), and 256 walkers' for the chain floors: too few walkers to
    # contend for the card, each still takes its WALK - 1 steps one after
    # another (each step's load waits on the step before's); device time,
    # as the wrapper's host work outlasts so short a launch.
    draws = BatchDraws.walks(BATCH, 1, WALK, NEGS, dev)
    few = BatchDraws.walks(256, 1, WALK, NEGS, dev)
    # ms and the chain floors on the records (the walk models' route),
    # rows_ms on row_ptr (every other caller's).
    kernels["first_order_walks"] = dict(
        source="embiggen_tpu_torch/csrc/sampling.cu",
        replaces="embiggen_tpu/ops/walks.py:115", max_abs_err=k1_err,
        ms=time_ms(lambda: first_order_walks(tg_walk, starts, WALK, gen), 20),
        rows_ms=time_ms(lambda: first_order_walks(tg, starts, WALK, gen), 20),
        plain_ms=time_ms(
            lambda: first_order_walks_plain(tg, starts, WALK, cuda_gen), 2),
        chain_ms=queued_ms(lambda: first_order_walks(tg_walk, starts[:256], WALK, gen), 20),
        rows_chain_ms=queued_ms(lambda: first_order_walks(tg, starts[:256], WALK, gen), 20),
        library_ms=None,
        # starts in, walks out; each move reads two row_ptr entries and an arc.
        **bound(4 * BATCH + 4 * BATCH * WALK + 12 * BATCH * (WALK - 1), 0),
    )
    kernels["first_order_batch"] = dict(
        source="embiggen_tpu_torch/csrc/sampling.cu",
        replaces="embiggen_tpu/models/embedders/walk_based.py:353 (_sample_batch: K2, K1, K2)",
        max_abs_err=fused_err,
        ms=time_ms(lambda: first_order_batch(tg_walk, gen, BATCH, 1, WALK, NEGS, True, draws),
                   20),
        rows_ms=time_ms(lambda: first_order_batch(tg, gen, BATCH, 1, WALK, NEGS, True, draws),
                        20),
        plain_ms=time_ms(lambda: first_order_batch_plain(tg, cuda_gen, BATCH, 1, WALK, NEGS,
                                                         True), 2),
        chain_ms=queued_ms(lambda: first_order_batch(tg_walk, gen, 256, 1, WALK, NEGS, True,
                                                     few), 20),
        library_ms=None,
        # walks and negatives out; each move reads two row_ptr entries and
        # an arc, each negative an arc's head.
        **bound(4 * BATCH * (WALK + NEGS) + 12 * BATCH * (WALK - 1) + 4 * BATCH * NEGS, 0),
    )
    weights = tg.degrees.float()
    negs_out = draws.views[1]
    kernels["nce_negatives"] = dict(
        source="embiggen_tpu_torch/csrc/sampling.cu",
        replaces="embiggen_tpu/ops/negatives.py:24", max_abs_err=k2_err,
        ms=time_ms(lambda: nce_negatives(tg, gen, (BATCH, NEGS)), 20),
        # at a fit's key and offset into its block, as the steps call it
        workspace_ms=time_ms(lambda: nce_negatives(tg, gen, (BATCH, NEGS), True, draws,
                                                   negs_out), 20),
        plain_ms=time_ms(
            lambda: nce_negatives_plain(tg, cuda_gen, (BATCH, NEGS), True), 20),
        # the same degree-proportional draws as one call
        library_ms=time_ms(lambda: torch.multinomial(
            weights, BATCH * NEGS, replacement=True, generator=cuda_gen), 20),
        library="torch.multinomial",
        **bound(8 * BATCH * NEGS, 0),   # an arc's head read, a node id written
    )
    for name, ms in device_ms({
        "first_order_walks": lambda: first_order_walks(tg_walk, starts, WALK, gen),
        "first_order_batch": lambda: first_order_batch(tg_walk, gen, BATCH, 1, WALK, NEGS, True,
                                                       draws),
        "nce_negatives": lambda: nce_negatives(tg, gen, (BATCH, NEGS), True, draws, negs_out),
    }).items():
        kernels[name]["device_ms"] = ms
    del starts, weights, draws, few, negs_out, tg_walk

    new, skipgram_errs = skipgram_checks(dev)
    kernels.update(new)
    torch.cuda.empty_cache()
    print(f"phase 3 kernels vs plain on {card} ({time.perf_counter() - t_phase:.1f} s; "
          f"ms per call, at the slice shapes; graph build {graph_s:.1f} s): " + "; ".join(
              f"{k} err {v['max_abs_err']:.3g} ms {v['ms']:.4f}"
              + (f" device {v['device_ms']:.4f}" if "device_ms" in v else "")
              + (f" on row_ptr {v['rows_ms']:.4f}" if "rows_ms" in v else "")
              + (f" chain floor (256 walkers) {v['chain_ms']:.4f}" if "chain_ms" in v else "")
              + (f" on row_ptr {v['rows_chain_ms']:.4f}" if "rows_chain_ms" in v else "")
              + (f" on a workspace {v['workspace_ms']:.4f}" if "workspace_ms" in v else "")
              + f" plain {v['plain_ms']:.3f}" for k, v in kernels.items())
          + " | K3 sums / tables after the combine, max abs err by shape: "
          + "; ".join(f"{k} {u:.3g} / {c:.3g}" for k, (u, c) in skipgram_errs.items())
          + " | sampler p-values at the slice shapes: " + "; ".join(
              f"{k} {v:.3g}" for k, v in slice_p.items()), flush=True)

    # ------------------------------------------ 4. K5-K7, P1, P2 vs plain
    t_phase = time.perf_counter()
    new, k6_p = edge_kernel_checks(graph, tg)
    new["spmm"] = spmm_checks(graph, dev)
    hub7 = new["spmm"]["hub"]
    new["spmm_combine"] = dict(
        source="embiggen_tpu_torch/csrc/spmm.cu", replaces="embiggen_tpu/ops/spmm.py:337",
        max_abs_err=hub7["max_abs_err"], ms=hub7["combine_ms"],
        plain_ms=hub7["combine_plain_ms"], library_ms=None,
        launches_from="K7's forward and backward on the hub graph, phase 4",
        **hub7["combine_bound"])
    torch.cuda.empty_cache()
    new.update(probe_checks(dev))
    torch.cuda.empty_cache()
    new["edge_metrics"] = edge_metrics_checks(graph, tg)
    kernels.update(new)
    print(f"phase 4 kernels vs plain on {card} ({time.perf_counter() - t_phase:.1f} s; "
          "ms per call): " + "; ".join(
              f"{k} err {v['max_abs_err']:.3g} ms {v['ms']:.4f}"
              + (f" device {v['device_ms']:.4f}" if "device_ms" in v else "")
              + f" plain {v['plain_ms']:.4f}" for k, v in new.items())
          + f" | K7 backward ms {new['spmm']['backward_ms']:.4f} plain "
          f"{new['spmm']['backward_plain_ms']:.4f}, yardsticks embedding_bag "
          f"{new['spmm']['embedding_bag_ms']:.4f} cuSPARSE {new['spmm']['cusparse_ms']:.4f}, "
          "plan: one pass over x in place, CSR layout "
          f"{new['spmm']['layout_s']:.2f} s, gathered rows/s "
          f"{new['spmm']['gathered_rows_per_s']:.4g}, gather floor "
          f"{new['spmm']['floor_ms']:.4f}, chunks {new['spmm']['plan_chunks']} | K7 on the hub "
          f"graph ({hub7['arcs']} arcs; {hub7['long_rows']} rows of more than {hub7['split']} "
          f"arcs in {hub7['chunks']} chunks, transpose {hub7['transpose_chunks']}; CSR layout "
          f"{hub7['layout_s']:.2f} s on the worker thread, waited {hub7['wait_s']:.2f} s): err "
          "against the float64 plain version "
          f"{hub7['max_abs_err']:.3g}, two calls bit-equal, forward sqrtn ms {hub7['ms']:.4f} "
          f"backward {hub7['backward_ms']:.4f}, gather floor {hub7['floor_ms']:.4f}, combine "
          f"{hub7['combine_ms']:.4f} plain {hub7['combine_plain_ms']:.4f}, launches "
          f"{hub7['launches']} | P1 rows/s "
          f"{new['tile_gather_sums']['rows_per_s']:.4g} GB/s "
          f"{new['tile_gather_sums']['gbytes_per_s']:.4g}; P2 rows/s "
          f"{new['table_gather_sums']['rows_per_s']:.4g} GB/s "
          f"{new['table_gather_sums']['gbytes_per_s']:.4g} | K8 on the hub graph "
          f"({new['edge_metrics']['hub_graph_arcs']} arcs, "
          f"{new['edge_metrics']['hub_pairs_truncated']} pairs at the cap) ms "
          f"{new['edge_metrics']['hub_ms']:.4f} plain "
          f"{new['edge_metrics']['hub_plain_ms']:.4f} | K5 and K6 on the hub graph ms "
          f"{new['csr_edge_ids']['hub_ms']:.4f} and {new['edge_prediction_mini_batch']['hub_ms']:.4f}"
          f" device {new['csr_edge_ids']['hub_device_ms']:.4f} and "
          f"{new['edge_prediction_mini_batch']['hub_device_ms']:.4f}, K5 plain "
          f"{new['csr_edge_ids']['hub_plain_ms']:.4f}; K6 without a workspace ms "
          f"{new['edge_prediction_mini_batch']['fresh_ms']:.4f} | K6 p-values: "
          + "; ".join(f"{k} {v:.3g}" for k, v in k6_p.items()), flush=True)

    # ---------------------------------------------------------------- 5. S1
    t_phase = time.perf_counter()
    SkipGram = get_model_from_library("Node2Vec SkipGram",
                                      task_name="Node Embedding")
    small = erdos_renyi(300, 1500, seed=5)
    kw = dict(embedding_size=32, walk_length=16, window_size=3,
              number_of_negative_samples=5, random_state=0)
    models = {d: SkipGram(device=d, **kw) for d in ("cuda", "cpu")}
    init = models["cpu"]._init_params(small, torch.Generator().manual_seed(0))
    params = {d: {k: v.to(d).clone() for k, v in init.items()} for d in models}
    graphs = {d: small.device(d) for d in models}
    step_rng = np.random.default_rng(4)
    with torch.no_grad():
        for lr in (0.05, 0.04, 0.03):
            batch = (step_rng.integers(0, 300, (256, 16), dtype=np.int32),
                     step_rng.integers(0, 300, (256, 5), dtype=np.int32))
            for d, m in models.items():
                m._step(graphs[d], params[d], torch.Generator(), lr,
                        batch=tuple(torch.from_numpy(x).to(d) for x in batch))
    step_err = max(check_close(f"3 steps, {k}", params["cuda"][k].cpu(),
                               params["cpu"][k], 0.0, 1e-5) for k in init)

    model = SkipGram(device="cuda", embedding_size=DIM, walk_length=WALK,
                     window_size=WINDOW, number_of_negative_samples=NEGS,
                     epochs=2, random_state=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    result = embed_graph(graph, model)
    slice_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for i, emb in enumerate(result.node_embeddings):
        if emb.shape != (N_NODES, DIM) or not np.isfinite(emb).all():
            raise AssertionError(f"embedding {i}: shape {emb.shape} or "
                                 "non-finite values")
    if len(model._epoch_losses) != 2 or not np.isfinite(model._epoch_losses).all():
        raise AssertionError(f"epoch losses {model._epoch_losses}")
    path_launches = check_launches("S1", launches, S1_KERNELS, S1_UNUSED)
    s1_steps = len(model._epoch_losses) * max(1, N_NODES // model._run_batch_size)
    if launches["first_order_batch"] != s1_steps:
        raise AssertionError(f"S1: the fused batch launched {launches['first_order_batch']} "
                             f"times in {s1_steps} steps")
    path_launches.update({name: launches[name] for name in S1_UNUSED})
    steps = max(1, N_NODES // model._run_batch_size)
    centres = steps * model._run_batch_size * (WALK - 2 * WINDOW)
    print(f"phase 5 S1 on {card} ({time.perf_counter() - t_phase:.1f} s): 3 injected "
          f"steps cuda vs cpu max err {step_err:.3g}; embed_graph {slice_s:.2f} s, "
          f"{steps} steps/epoch of {model._run_batch_size} walks, s/epoch "
          f"{model._epoch_seconds}, centres/s "
          f"{[centres / s for s in model._epoch_seconds]}, losses "
          f"{model._epoch_losses}, peak {peak} bytes, launches {path_launches}",
          flush=True)

    # ------------------------------------------------------- 6. S3: the GCN
    t_phase = time.perf_counter()
    gcn_step_err = gcn_injected_steps(dev)
    feats = np.random.default_rng(0).standard_normal((N_NODES, DIM), dtype=np.float32)
    gcn = GCNEdgePrediction(epochs=2, batch_size=GCN_BATCH, dropout_rate=0.0,
                            early_stopping_patience=10**6, random_state=0,
                            device="cuda")
    t0 = time.perf_counter()
    GCNEncoder(gcn._kernels, gcn._units).build_kernels(graph, dev)
    torch.cuda.synchronize()
    gcn_kernel_s = time.perf_counter() - t0   # the fit finds them cached
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    gcn.fit(graph, node_features=feats)
    gcn_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gcn_proba = gcn.predict_proba(graph)
    gcn_predict_s = time.perf_counter() - t0
    gcn_launches = check_launches("S3", _build.launch_counts(), S3_KERNELS)
    gcn_peak = torch.cuda.max_memory_allocated()
    if len(gcn._history) != 2 or not np.isfinite(gcn._history).all():
        raise AssertionError(f"GCN epoch losses {gcn._history}")
    if gcn_proba.shape != (graph.number_of_directed_edges,) or not np.isfinite(gcn_proba).all():
        raise AssertionError("GCN scores: wrong shape or non-finite values")
    gcn_steps = gcn._steps_per_epoch
    print(f"phase 6 S3 GCN on {card} ({time.perf_counter() - t_phase:.1f} s): 3 injected "
          f"Adam steps cuda vs cpu max err {gcn_step_err:.3g}; bench config "
          f"batch {gcn._run_batch_size}, {gcn_steps} steps/epoch, host kernel "
          f"build {gcn_kernel_s:.2f} s, fit {gcn_fit_s:.2f} s, s/epoch "
          f"{gcn._epoch_seconds}, step ms "
          f"{[s / gcn_steps * 1e3 for s in gcn._epoch_seconds]}, edges/s "
          f"{[gcn_steps * gcn._run_batch_size / s for s in gcn._epoch_seconds]}, "
          f"losses {gcn._history}, peak {gcn_peak} bytes; predict_proba on "
          f"{len(gcn_proba)} arcs {gcn_predict_s:.2f} s; launches {gcn_launches}",
          flush=True)
    del feats, gcn_proba

    # ------------------------------------------------- 7. S2: the Perceptron
    t_phase = time.perf_counter()
    perceptron = PerceptronEdgePrediction(
        edge_features=["Degree"], edge_embeddings=["CosineSimilarity"],
        number_of_epochs=S2_EPOCHS, random_state=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    perceptron.fit(graph, node_features=result.node_embeddings[0])
    perceptron_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    perceptron_proba = perceptron.predict_proba(graph)
    perceptron_predict_s = time.perf_counter() - t0
    perceptron_launches = check_launches("S2", _build.launch_counts(), S2_KERNELS)
    perceptron_peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(perceptron._last_loss):
        raise AssertionError(f"Perceptron loss {perceptron._last_loss}")
    if (perceptron_proba.shape != (graph.number_of_directed_edges,)
            or not np.isfinite(perceptron_proba).all()):
        raise AssertionError("Perceptron scores: wrong shape or non-finite values")
    n_train = 2 * graph.number_of_directed_edges
    print(f"phase 7 S2 Perceptron on {card} ({time.perf_counter() - t_phase:.1f} s): "
          f"fit {perceptron_fit_s:.2f} s (stages {perceptron._fit_seconds}; "
          f"{n_train} examples, {S2_EPOCHS} epochs of "
          f"{n_train // 4096} steps of 4096), last epoch loss "
          f"{perceptron._last_loss:.6g}, predict_proba on {len(perceptron_proba)} "
          f"arcs {perceptron_predict_s:.2f} s, peak {perceptron_peak} bytes; "
          f"launches {perceptron_launches}", flush=True)
    del perceptron_proba, perceptron
    torch.cuda.empty_cache()

    t_phase = time.perf_counter()
    # The negative graph of the fit above is memoized and this fit takes it
    # (its `negative_graph` stage is the lookup; the first fit times the
    # sampling).
    perceptron = PerceptronEdgePrediction(
        edge_features=["Degree", "AdamicAdar", "JaccardCoefficient"],
        edge_embeddings=["CosineSimilarity"], number_of_epochs=S2_EPOCHS,
        random_state=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    perceptron.fit(graph, node_features=result.node_embeddings[0])
    k8_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    perceptron_proba = perceptron.predict_proba(graph)
    k8_predict_s = time.perf_counter() - t0
    # K5 ran in the first fit's negative graph, which this fit takes.
    k8_launches = check_launches("K8 Perceptron", _build.launch_counts(), K8_KERNELS)
    k8_peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(perceptron._last_loss):
        raise AssertionError(f"Perceptron loss {perceptron._last_loss}")
    if (perceptron_proba.shape != (graph.number_of_directed_edges,)
            or not np.isfinite(perceptron_proba).all()):
        raise AssertionError("K8 Perceptron scores: wrong shape or non-finite values")
    print(f"phase 7 S2 Perceptron with Degree + AdamicAdar + JaccardCoefficient on "
          f"{card} ({time.perf_counter() - t_phase:.1f} s): fit {k8_fit_s:.2f} s "
          f"(stages {perceptron._fit_seconds}), last epoch loss "
          f"{perceptron._last_loss:.6g}, predict_proba on {len(perceptron_proba)} "
          f"arcs {k8_predict_s:.2f} s, peak {k8_peak} bytes; launches {k8_launches}",
          flush=True)
    del perceptron_proba, perceptron
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 8. probes
    t_phase = time.perf_counter()
    _build.reset_launch_counts()
    probes = spmm_probe.run(dev)
    probe_launches = check_launches("probe", _build.launch_counts(), PROBE_KERNELS)
    torch.cuda.empty_cache()
    p1_rate = next(r["rows_per_s"] for r in probes if r["probe"] == "cuda_tile_gather")
    k7_rate = kernels["spmm"]["gathered_rows_per_s"]
    print(f"phase 8 probes on {card} ({time.perf_counter() - t_phase:.1f} s): " + "; ".join(
        f"{r['probe']} rows/s {r['rows_per_s']:.4g} GB/s {r['gbytes_per_s']:.4g} "
        f"ms {r['ms']:.4f}" for r in probes)
        + f" | K7 gathered rows/s {k7_rate:.4g} = {k7_rate / p1_rate:.3f} of P1's; "
        f"launches {probe_launches}", flush=True)

    # The quality phases (9, 13, 16, 20, 23, 27, 30, 38) run in a process of
    # their own beside the native host helpers (phase 35) and the harness
    # (phase 10): all are host-bound and none times a kernel. Their lines
    # follow phase 10's.
    quality_log = tempfile.TemporaryFile(mode="w+")
    quality = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--quality"],
                               stdout=quality_log, stderr=subprocess.STDOUT, text=True)
    try:
        # --------------------------------------- 35. native host helpers
        t_phase = time.perf_counter()
        native_rows = native_checks(graph, later["weighted"].result())
        print(f"phase 35 native host helpers vs plain on the host of {card} "
              f"({time.perf_counter() - t_phase:.1f} s, the quality phases beside it; host "
              "seconds, native / plain): " + "; ".join(
                  f"{k} at {v['shape']}: {v['native_s']:.4f} / {v['plain_s']:.4f} "
                  f"(x{v['plain_s'] / v['native_s']:.1f}) err {v['err']:.3g}"
                  for k, v in native_rows.items())
              + f" | alias tables of all {native_rows['alias_tables']['whole_arcs']} arcs "
              f"{native_rows['alias_tables']['native_whole_s']:.4f}", flush=True)

        # ------------------------------------------------------ 10. S4 harness
        t_phase = time.perf_counter()
        del result
        torch.cuda.empty_cache()
        _build.reset_launch_counts()
        with native_calls() as harness_native:
            harness_out = harness.run(dev, er_graph=graph)
        harness_launches = check_launches("S4", _build.launch_counts(), S4_KERNELS)
        for name in ("spanning_forest", "build_sym_csr", "sort_unique_pairs",
                     "radix_argsort", "ranking_metrics_sorted"):
            if not harness_native.counts[name]["calls"]:
                raise AssertionError(f"the harness never called native.{name}: "
                                     f"{harness_native.counts}")
        auprc = harness_out["eval_test_auprc"]
        if not auprc >= HARNESS_FLOOR:
            raise AssertionError(f"flagship harness test AUPRC {auprc} on {card} is "
                                 f"below {HARNESS_FLOOR}: {harness_out}")
        print(f"phase 10 S4 harness on {card} ({time.perf_counter() - t_phase:.1f} s, the "
              f"quality phases beside it): test AUPRC {auprc:.4f}, "
              f"{auprc - HARNESS_REFERENCE_AUPRC:+.4f} from the reference's "
              f"{HARNESS_REFERENCE_AUPRC}; {json.dumps(harness_out)}; "
              f"launches {harness_launches}; split sha1 {harness_out['eval_split_sha1']}; "
              f"native host helpers (calls, host s) {json.dumps(harness_native.counts)}",
              flush=True)
        t0 = time.perf_counter()
        quality.wait()
        quality_wait_s = time.perf_counter() - t0
    finally:
        if quality.poll() is None:
            quality.kill()
            quality.wait()
    quality_log.seek(0)
    print(quality_log.read(), end="", flush=True)
    if quality.returncode != 0:
        raise AssertionError(f"the quality phases failed (exit {quality.returncode})")
    print(f"chip_smoke: the quality phases ended {quality_wait_s:.1f} s after phase 10",
          flush=True)
    # The typed slice graph's hub graph (phase 28), queued now that the typed
    # graph is built.
    hub_graph(later["typed"].result(), typed=True, wait=False)

    # ------------------------------------------- 11. K9-K11 vs plain (S5)
    t_phase = time.perf_counter()
    pq_p, pq_err = pq_sampler_checks(erdos_renyi, dev)
    hub = hub_graph(graph)
    pq_p.update(slice_pq_checks(graph, hub, dev))
    del hub
    new = pq_walk_entries(graph, pq_err, dev)
    new["cbow_update"], cbow_errs = cbow_checks(dev)
    cbow_edge_errs = cbow_edge_checks(dev)
    torch.cuda.empty_cache()
    kernels.update(new)
    print(f"phase 11 K9-K11 vs plain on {card} ({time.perf_counter() - t_phase:.1f} s; "
          "ms per call at the S5 shapes): " + "; ".join(
              f"{k} err {v['max_abs_err']:.3g} ms {v['ms']:.4f} "
              f"plain {v['plain_ms']:.4f} bound {v['bound_ms']:.4f} ({v['bound_by']})"
              for k, v in new.items())
          + " | walk steps/s: " + "; ".join(
              f"{k} {new[k]['walk_steps_per_s']:.4g}" for k in ("ell_walks", "rejection_walks"))
          + f" | K9's chain floor (256 walkers) {new['ell_walks']['chain_ms']:.4f} ms"
          + " | K11 sums / tables after the combine, max abs err by shape: "
          + "; ".join(f"{k} {u:.3g} / {c:.3g}" for k, (u, c) in cbow_errs.items())
          + " | K11 edges, sums max abs err: "
          + "; ".join(f"{k} {v:.3g}" for k, v in cbow_edge_errs.items())
          + " | p/q sampler p-values: " + "; ".join(f"{k} {v:.3g}" for k, v in pq_p.items()),
          flush=True)

    # ------------------------------------------------------------ 12. S5
    t_phase = time.perf_counter()
    cbow_step_err = cbow_injected_steps(small, dev)
    s5_model, counts, s5_s, s5_peak, s5_centres, s5_steps = embed_run(
        graph, dev, "Node2Vec CBOW", 2, **PQ)
    s5_launches = check_launches("S5", counts, S5_KERNELS, S5_UNUSED)
    s5_launches.update({name: counts[name] for name in S5_UNUSED})
    runs = {}
    for label, name, kw, names in (
        ("p/q SkipGram", "Node2Vec SkipGram", PQ, PQ_SKIPGRAM_KERNELS),
        ("DeepWalk CBOW", "DeepWalk CBOW", {}, DEEPWALK_CBOW_KERNELS),
    ):
        m, counts, secs, peak, centres, steps = embed_run(graph, dev, name, 1, **kw)
        unused = (("first_order_walks", "first_order_batch") if kw else
                  ("ell_walks", "rejection_walks", "first_order_walks", "nce_negatives"))
        runs[label] = (m, check_launches(label, counts, names, unused), secs, peak,
                       centres, steps)
    torch.cuda.empty_cache()
    # K10's path: random_walks on a graph exported without an ELL table.
    tg_plain = graph.device(dev)
    starts = nce_negatives(tg_plain, torch.Generator().manual_seed(36), (BATCH,),
                           scale_free=False)
    _build.reset_launch_counts()
    rejection_path = random_walks(tg_plain, starts, WALK, torch.Generator().manual_seed(37),
                                  **PQ)
    torch.cuda.synchronize()
    k10_launches = check_launches("K10 random_walks", _build.launch_counts(),
                                  REJECTION_KERNELS, ("ell_walks", "first_order_walks"))
    arc_positions(graph, rejection_path, arc_keys(graph, dev))
    del tg_plain, starts, rejection_path
    torch.cuda.empty_cache()
    print(f"phase 12 S5 on {card} ({time.perf_counter() - t_phase:.1f} s): 3 injected "
          f"CBOW steps cuda vs cpu max err {cbow_step_err:.3g}; embed_graph Node2Vec CBOW "
          f"return 2 explore 0.5 {s5_s:.2f} s, s/epoch {s5_model._epoch_seconds}, "
          f"centres/s {s5_centres}, walk steps/s {s5_steps}, losses "
          f"{s5_model._epoch_losses}, peak {s5_peak} bytes, launches {s5_launches} | "
          + " | ".join(f"{label}: 1 epoch {secs:.2f} s, s/epoch {m._epoch_seconds}, "
                       f"centres/s {centres}, walk steps/s {steps}, losses "
                       f"{m._epoch_losses}, peak {peak} bytes, launches {got}"
                       for label, (m, got, secs, peak, centres, steps) in runs.items())
          + f" | random_walks without ELL launches {k10_launches}", flush=True)

    # ----------------------------------------- 14. K14 and K4 vs plain (S6)
    t_phase = time.perf_counter()
    hub = hub_graph(graph)
    k14_p, k14_err, k14_power = k14_checks(graph, tg, hub, dev)
    del hub
    torch.cuda.empty_cache()
    new = k14_entries(tg, k14_err, dev)
    new.update(k4_line_checks(tg, dev))
    kernels.update(new)
    print(f"phase 14 K14 and K4 vs plain on {card} ({time.perf_counter() - t_phase:.1f} s; "
          f"ms per call at the S6 shapes, B {S6_BATCH}, K {S6_NEGS}, K14 on a workspace as "
          "the fits call it): " + "; ".join(
              f"{k} err {v['max_abs_err']:.3g} ms {v['ms']:.4f}"
              + (f" device {v['device_ms']:.4f}" if "device_ms" in v else "")
              + f" plain {v['plain_ms']:.4f} bound {v['bound_ms']:.4f} ({v['bound_by']})"
              for k, v in new.items())
          + " | K14 without a workspace ms " + ", ".join(
              f"{k} {new[k]['fresh_ms']:.4f}" for k in ("line_mini_batch", "siamese_mini_batch"))
          + f" | LINE with avoid_false_negatives ms {new['line_mini_batch']['avoid_ms']:.4f} "
          f"plain {new['line_mini_batch']['avoid_plain_ms']:.4f} bound "
          f"{new['line_mini_batch']['avoid_bound_ms']:.4f} | K4 standalone wrapper ms "
          f"{new['mean_scatter']['wrapper_ms']:.4f} (on a fresh sums and counts "
          f"{new['mean_scatter']['wrapper_fresh_ms']:.4f}) plain "
          f"{new['mean_scatter']['wrapper_plain_ms']:.4f}, index_add_ of the sums "
          f"{new['mean_scatter']['scatter_half_ms']:.4f} ({new['mean_scatter']['rows']} rows, "
          f"{new['mean_scatter']['touched_rows']} touched) | K14 p-values (slots "
          f"{K14_SLOTS}): " + "; ".join(f"{k} {v:.3g}" for k, v in k14_p.items())
          + " | power on the hub graph (not checked): " + "; ".join(
              f"{k} {v:.3g}" for k, v in k14_power.items()), flush=True)

    # ------------------------------------------------------------ 15. S6
    t_phase = time.perf_counter()
    s6_step_errs = minibatch_injected_steps(small, dev)
    typed_graph = minibatch_graph(graph, S6_TYPES)
    s6 = {}
    for name, typed, dim, epochs, kw in S6_RUNS:
        m, counts, secs, peak, rates = minibatch_run(
            typed_graph if typed else graph, dev, name, dim, epochs, **kw)
        line = name.endswith("LINE")
        s6[name] = (m, check_launches(
            name, counts, S6_LINE_KERNELS if line else S6_SIAMESE_KERNELS,
            S6_UNUSED + (S6_SIAMESE_KERNELS if line else S6_LINE_KERNELS)), secs, peak, rates)
        torch.cuda.empty_cache()
    del typed_graph
    print(f"phase 15 S6 on {card} ({time.perf_counter() - t_phase:.1f} s): 3 injected steps "
          "cuda vs cpu max err " + "; ".join(f"{k} {v:.3g}" for k, v in s6_step_errs.items())
          + " | " + " | ".join(
              f"{name} D {m.embedding_size} batch {m._run_batch_size}{' ' + str(kw) if kw else ''}"
              f": {epochs} epochs {secs:.2f} s, {m._steps_per_epoch(graph, None, S6_BATCH)} "
              f"steps/epoch, s/epoch {m._epoch_seconds}, "
              f"{'triples' if typed or name == 'Unstructured' else 'edges'}/s {rates}, losses "
              f"{m._epoch_losses}, peak {peak} bytes, launches {got}"
              for (name, typed, _, epochs, kw), (m, got, secs, peak, rates)
              in zip(S6_RUNS, s6.values())), flush=True)

    # -------------------------------------------------- 17. K12 vs plain (S7)
    t_phase = time.perf_counter()
    kernels["walklets_update"], k12_errs = walklets_checks(dev)
    torch.cuda.empty_cache()
    k12 = kernels["walklets_update"]
    print(f"phase 17 K12 vs plain on {card} ({time.perf_counter() - t_phase:.1f} s; at the S7 "
          f"shapes, walks [{BATCH}, {WALK}], negatives K {NEGS}, tables [{WALKLETS_POWER}, "
          f"{N_NODES}, {DIM // WALKLETS_POWER}]): skipgram ms {k12['ms']:.4f}, cbow ms "
          f"{k12['cbow_ms']:.4f}, plain {k12['plain_ms']:.4f}, bound {k12['bound_ms']:.4f} "
          f"({k12['bound_by']}) | sums / tables after the combine, max abs err by case: "
          + "; ".join(f"{k} {u:.3g} / {c:.3g}" for k, (u, c) in k12_errs.items()), flush=True)

    # ---------------------------------------------- 18. K13a, K13b vs plain
    t_phase = time.perf_counter()
    new, k13_errs = glove_checks(graph, dev)
    kernels.update(new)
    torch.cuda.empty_cache()
    k13a = new["cooccurrences"]
    print(f"phase 18 K13 vs plain on {card} ({time.perf_counter() - t_phase:.1f} s): K13a at "
          f"the S7 GloVe shape (walks [{N_NODES}, {GLOVE_WALK}], w {GLOVE_WINDOW}: "
          f"{k13a['emitted_keys']} keys emitted, {k13a['entries']} entries) ms "
          f"{k13a['ms']:.4f} plain {k13a['plain_ms']:.4f} torch.unique counts "
          f"{k13a['library_ms']:.4f}, unique's inverse and index_add_ "
          f"{k13a['unique_index_add_ms']:.4f}, bound {k13a['bound_ms']:.4f} (split: "
          + ", ".join(f"{k[:-3]} {k13a[k]:.4f}" for k in (
              "count_ms", "scan_ms", "scatter_ms", "sort_ms", "scan2_ms", "write_ms", "rest_ms"))
          + f"); at one stride of weight 1 ms {k13a['stride1_ms']:.4f}, torch.unique counts "
          f"{k13a['stride1_library_ms']:.4f}; K13b (B {GLOVE_BATCH}, D {DIM}) step ms "
          f"{new['glove_gradients']['step_ms']:.4f} plain {new['glove_gradients']['step_plain_ms']:.4f}"
          f" bound {new['glove_gradients']['step_bound_ms']:.4f}, by launch (device ms, plain, "
          "bound, index_add_ where it is the same function): " + "; ".join(
              f"{k} {new[k]['ms']:.4f} {new[k]['plain_ms']:.4f} {new[k]['bound_ms']:.4f}"
              + (f" {new[k]['library_ms']:.4f}" if new[k]["library_ms"] is not None else "")
              for k in S7_K13B) + " | "
          "max err by case: " + "; ".join(f"{k} {v:.3g}" for k, v in k13_errs.items())
          + f" | K13b's check at lr {new['glove_gradients']['check_lr']}: nearest wrong result "
          f"{new['glove_gradients']['control_share_min']:.4g} tolerances off, median change in "
          "tolerances " + "; ".join(f"{k} {v:.4g}" for k, v in
                                    new["glove_gradients"]["signal"].items()),
          flush=True)

    # ------------------------------------------------------------ 19. S7
    t_phase = time.perf_counter()
    s7_step_errs = s7_injected_steps(small, dev)
    s7 = {}
    for label, name, epochs, kw, names, unused in (
        ("Walklets SkipGram", "Walklets SkipGram", 2, S7_WALKLETS, S7_WALKLETS_KERNELS,
         S7_WALKLETS_UNUSED),
        ("Walklets CBOW", "Walklets CBOW", 1, S7_WALKLETS, S7_WALKLETS_KERNELS,
         S7_WALKLETS_UNUSED),
        ("Node2Vec GloVe", "Node2Vec GloVe", 1, S7_GLOVE, S7_GLOVE_KERNELS, S7_GLOVE_UNUSED),
        ("Walklets GloVe", "Walklets GloVe", 1, S7_WALKLETS_GLOVE, S7_GLOVE_KERNELS,
         S7_GLOVE_UNUSED),
        ("Role2Vec", "Role2Vec", 1, S7_ROLE2VEC, S7_ROLE2VEC_KERNELS, S7_ROLE2VEC_UNUSED),
    ):
        m, counts, secs, peak = s7_run(graph, dev, name, epochs, **kw)
        s7[label] = (m, check_launches(label, counts, names, unused), secs, peak)
        torch.cuda.empty_cache()
    # One fused batch a Walklets step; one K2 draw a GloVe step.
    for label, counter in (("Walklets SkipGram", "first_order_batch"),
                           ("Walklets CBOW", "first_order_batch"),
                           ("Node2Vec GloVe", "nce_negatives")):
        m = s7[label][0]
        steps = len(m._epoch_losses) * (
            m._steps_per_epoch(graph, None, m._run_batch_size) if "GloVe" in label
            else max(1, N_NODES // m._run_batch_size))
        if s7[label][1][counter] != steps:
            raise AssertionError(f"{label}: {counter} launched {s7[label][1][counter]} times "
                                 f"in {steps} steps")
    glove_launches = glove_step_launches(graph, dev)
    pairs = BATCH * sum(2 * (WALK - p) for p in range(1, WALKLETS_POWER + 1))
    glove = s7["Node2Vec GloVe"][0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    glove_entries_s7 = glove._prepare_data(graph)
    torch.cuda.synchronize()
    cooc_s = time.perf_counter() - t0
    del glove_entries_s7
    torch.cuda.empty_cache()
    glove_steps = glove._steps_per_epoch(graph, None, glove._run_batch_size)
    role = s7["Role2Vec"][0]
    role_centres = (max(1, N_NODES // role._run_batch_size) * role._run_batch_size
                    * (role._walk_length - 2 * role._window_size))
    print(f"phase 19 S7 on {card} ({time.perf_counter() - t_phase:.1f} s): 3 injected steps "
          "cuda vs cpu max err " + "; ".join(f"{k} {v:.3g}" for k, v in s7_step_errs.items())
          + " | " + " | ".join(
              f"{label}: {secs:.2f} s, s/epoch {m._epoch_seconds}, losses {m._epoch_losses}, "
              f"peak {peak} bytes, launches {got}"
              + (f", pairs/s {[pairs * (N_NODES // BATCH) / s for s in m._epoch_seconds]}"
                 if label.startswith("Walklets") and "GloVe" not in label else "")
              for label, (m, got, secs, peak) in s7.items())
          + f" | Node2Vec GloVe: co-occurrence build {cooc_s:.3f} s for {glove._n_entries} "
          f"entries ({glove._n_entries / cooc_s:.4g} entries/s), training "
          f"{glove_steps} steps of {glove._run_batch_size}, entries/s "
          f"{[glove_steps * glove._run_batch_size / s for s in glove._epoch_seconds]}"
          f" | Role2Vec batch {role._run_batch_size}, centres/s "
          f"{[role_centres / s for s in role._epoch_seconds]} | one steady step's launches "
          "(no index_add_; the ATen operators it ran on the card): " + "; ".join(
              f"{name} {launched}, others {others}"
              for name, (launched, others) in glove_launches.items()), flush=True)

    # ------------------------------- 21. K15a, K15b, K16a, K16b vs plain (S8)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    weighted_graph = later.pop("weighted").result()
    twin_s = time.perf_counter() - t0
    new, k15_errs, settled = k15_checks(graph, weighted_graph, dev)
    torch.cuda.empty_cache()
    k16, k16_errs, k16_plain_s, k16_routes, k16_general = k16_checks(graph, dev)
    k16_hub_launches = k16["khop_merge"]["launch_counts"]
    new.update(k16)
    kernels.update(new)
    torch.cuda.empty_cache()
    print(f"phase 21 K15a, K15b, K16a, K16b vs plain on {card} "
          f"({time.perf_counter() - t_phase:.1f} s; weighted twin waited for {twin_s:.1f} s; ms "
          f"per call: K15a one relaxation at D {S8_DIM}, K15b one hop at D {S8_DIM}, K16a "
          f"the singletons and one hop at precision {HLL_PRECISION}, K16b {K16B_PAIRS} pairs "
          f"at H {HLL_HOPS}): " + "; ".join(
              f"{k} err {v['max_abs_err']:.3g} ms {v['ms']:.4f} plain {v['plain_ms']:.4f} "
              f"bound {v['bound_ms']:.4f} ({v['bound_by']})"
              + (f" {v['library']} {v['library_ms']:.4f}" if v["library_ms"] is not None else "")
              for k, v in new.items())
          + f" | K15a weighted ms {new['min_plus_step']['weighted_ms']:.4f} | K15a and K15b "
          f"exact by case: {k15_errs} | SPINE's distances stop changing after {settled} "
          f"relaxations of {S8_DEPTH} | K16 by case (K16b: largest error as a share of "
          f"its tolerance): {k16_errs} | K16a's {HLL_HOPS} plain hops took "
          + ", ".join(f"{t:.2f} s at precision {p}" for p, t in k16_plain_s.items())
          + f" | K16b's pairs name {k16['edge_sketch_features']['distinct_nodes']} distinct "
          f"nodes | K16b ms by case: {k16['edge_sketch_features']['ms_by_case']} | K16a's "
          f"singleton route by graph and precision (hop 2's route; launch ms on CUDA "
          f"events, hop 2 also forced onto each route): {k16_routes} | the general route's "
          f"launches (singletons, then the hop launch): {k16_general} | the hop launch on the "
          f"hub graph ({HLL_HOPS} hops exact; one hop's ms, hop and merge launches' ms, "
          f"gather floor, chunks, launches of {HLL_HOPS} hops) by precision: "
          + "; ".join(f"{p}: {v['ms']:.4f} ({v['hop_ms']:.4f} + {v['merge_ms']:.4f}) floor "
                      f"{v['floor_ms']:.4f}, {v['chunks']} chunks, {v['launches']}"
                      for p, v in k16["khop_sketches"]["hub"].items())
          + f" | slice graph p {HLL_PRECISION} floor {k16['khop_sketches']['floor_ms']:.4f}",
          flush=True)

    # ------------------------------------------------------------ 22. S8
    t_phase = time.perf_counter()
    s8, s8_gcn = s8_runs(graph, weighted_graph, dev)
    sketch_pairs_equal = sketch_fit_against_general_route(s8["HyperSketching"][0], graph, dev)
    torch.cuda.empty_cache()
    gcn_hs = s8_gcn["GCN + HyperSketching"][0]
    k16b_share = launch_share(gcn_step(gcn_hs, graph), ("edge_sketch_features",), 10)
    k15a_fit_launches = {name: s8[name][1]["min_plus_step"]
                      for name in ("Degree-based SPINE", "WeightedSPINE")}
    for (name, got), twin in zip(k15a_fit_launches.items(), ("slice", "weighted twin")):
        if got != min(settled[twin] + 1, S8_DEPTH):
            raise AssertionError(f"{name} launched K15a {got} times; its distances settle "
                                 f"after {settled[twin]} relaxations")
    print(f"phase 22 S8 on {card} ({time.perf_counter() - t_phase:.1f} s): K15a launches a "
          f"fit (the relaxations that moved, from phase 21, + 1): "
          + ", ".join(f"{name} {got} (settled after {settled[twin]})" for (name, got), twin
                      in zip(k15a_fit_launches.items(), ("slice", "weighted twin")))
          + " | " + " | ".join(
        f"{name}: {secs:.2f} s, peak {peak} bytes, launches {got}"
        for name, (_, got, secs, peak) in s8.items())
        + " | " + " | ".join(
            f"{label} (units 128-128, batch {m._run_batch_size}, {m._steps_per_epoch} "
            f"steps/epoch): fit {fit_s:.2f} s, s/epoch {m._epoch_seconds}, step ms "
            f"{[s / m._steps_per_epoch * 1e3 for s in m._epoch_seconds]}, losses "
            f"{m._history}, predict_proba on {graph.number_of_directed_edges} arcs "
            f"{pred_s:.2f} s, peak {peak} bytes, launches {got}"
            for label, (m, got, fit_s, pred_s, peak) in s8_gcn.items())
        + f" | K16b in 10 steady steps of the GCN with HyperSketching features (ms a step on "
        f"CUDA events): {k16b_share} | HyperSketching's sketches equal the general route's "
        f"(singletons, then the hop launch) byte for byte, and its features of "
        f"{sketch_pairs_equal} pairs K16b's over them bit for bit", flush=True)

    # -------------------------------------------------- 24. profile (option)
    if args.profile:
        k3_phase_line(card, dev)
        torch.cuda.empty_cache()
        s5_phase_lines(card, graph, dev)
        print_profile("S1", card, *profile(embedder_step(model, graph), PROFILE_STEPS))
        print_profile("GCN", card, *profile(gcn_step(gcn, graph), PROFILE_STEPS))
        print_profile("S5", card, *profile(embedder_step(s5_model, graph), PROFILE_STEPS))
        print_profile("S6 Second-order LINE", card, *profile(
            minibatch_step(s6["Second-order LINE"][0], graph), PROFILE_STEPS))
        print_profile("S6 TransE", card, *profile(
            minibatch_step(s6["TransE"][0], minibatch_graph(graph, S6_TYPES)), PROFILE_STEPS))
        print_profile("S7 Walklets SkipGram", card, *profile(
            embedder_step(s7["Walklets SkipGram"][0], graph), PROFILE_STEPS))
        print_profile("S7 Node2Vec GloVe", card, *profile(
            minibatch_step(s7["Node2Vec GloVe"][0], graph), PROFILE_STEPS))
        print_profile("S8 GCN + HyperSketching", card, *profile(gcn_step(gcn_hs, graph),
                                                                PROFILE_STEPS))
        print_profile("S9 NodeSketch fit", card, *profile(nodesketch_fit(graph, dev),
                                                            PROFILE_STEPS))

    # ------------------------------------------ 25. K18 and RandNE's K7 hops
    t_phase = time.perf_counter()
    k18_entries, k18_errs = k18_checks(graph, dev)
    kernels.update(k18_entries)
    k18 = k18_entries["sketch_race_step"]
    torch.cuda.empty_cache()
    kernels["spmm"]["randne_hop"] = randne_hop = randne_hop_checks(graph, dev)
    torch.cuda.empty_cache()
    print(f"phase 25 K18 and RandNE's K7 hops vs plain on {card} "
          f"({time.perf_counter() - t_phase:.1f} s; ms per call at D {S9_DIM} on the slice "
          "graph: K18's candidate pass, K18 one round (both launches), K7 one hop): " + "; ".join(
              f"{k} err {v['max_abs_err']:.3g} ms {v['ms']:.4f} plain {v['plain_ms']:.4f} "
              f"bound {v['bound_ms']:.4f} ({v['bound_by']})"
              + (f" {v['library']} {v['library_ms']:.4f}" if v["library_ms"] is not None else "")
              for k, v in (*k18_entries.items(), ("RandNE hop", randne_hop)))
          + f" | K18's round by launch (ms, CUDA events): {k18['launch_ms']}"
          + f" | K18 exact by case: {k18_errs} | K18's arcs name {k18['distinct_heads']} "
          f"distinct heads", flush=True)

    # ------------------------------------------------------------ 26. S9
    t_phase = time.perf_counter()
    s9 = s9_runs(graph, dev)
    k18_share = launch_share(nodesketch_fit(graph, dev), S9_SKETCH_KERNELS, 3)
    s9_shares = s9_dense_checks(dev)
    print(f"phase 26 S9 on {card} ({time.perf_counter() - t_phase:.1f} s): " + " | ".join(
        f"{name}: {secs:.2f} s, peak {peak} bytes (its own {own}), launches {got}"
        for name, (got, secs, peak, own) in s9.items())
        + f" | dense rows on the card against the CPU, random states 0-{S9_CHECK_RUNS - 1} "
        f"on {S9_CHECK_NODES} nodes, largest error as a share of the tests' tolerance: "
        f"{s9_shares} | K18's two launches in 3 NodeSketch fits (ms a fit on CUDA events): "
        f"{k18_share}", flush=True)

    # ---------------------------------------- 28. K19 and typed K9 (S10)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    typed = later.pop("typed").result()
    typed_s = time.perf_counter() - t0
    if not (np.array_equal(typed.row_ptr, graph.row_ptr)
            and np.array_equal(typed.col_idx, graph.col_idx)):
        raise AssertionError("the typed slice graph's CSR is not the slice graph's")
    s10_p, s10_err = typed_law_checks(dev)
    typed_hub = hub_graph(typed, typed=True)
    s10_p.update(slice_typed_checks(typed, typed_hub, dev))
    del typed_hub
    new = typed_walk_entries(typed, s10_err, dev)
    kernels.update(new)
    k9t, k19 = new["ell_walks_typed"], new["exact_walks"]
    print(f"phase 28 K19 and typed K9 vs plain on {card} ({time.perf_counter() - t_phase:.1f} s; "
          f"typed graph waited for {typed_s:.1f} s; ms per call at the S10 shapes, B {BATCH}, "
          f"L {WALK}, "
          f"cap {ELL_CAP}, p/q 2 / 0.5, node 2, edge 0.5): " + "; ".join(
              f"{k} err {v['max_abs_err']:.3g} ms {v['ms']:.4f} plain {v['plain_ms']:.4f} "
              f"bound {v['bound_ms']:.4f} ({v['bound_by']}) walk steps/s "
              f"{v['walk_steps_per_s']:.4g}" for k, v in new.items())
          + f" | K9 in turns on one ELL table: untyped {k9t['untyped_ms_in_turns']}, typed "
          f"{k9t['typed_ms_in_turns']} (untyped in phase 11 {kernels['ell_walks']['ms']:.4f}; "
          f"PERF.md's K9 row: 0.5895); typed with p = q = 1 {k9t['typed_only_ms']:.4f}"
          + f" | K19 untyped (exact_pq) {k19['untyped_ms']:.4f}"
          + " | typed walk p-values: " + "; ".join(f"{k} {v:.3g}" for k, v in s10_p.items()),
          flush=True)

    # ------------------------------------------------------------ 29. S10
    t_phase = time.perf_counter()
    s10 = s10_runs(typed, dev)
    print(f"phase 29 S10 on {card} ({time.perf_counter() - t_phase:.1f} s): " + " | ".join(
        f"{label}: {secs:.2f} s, peak {peak} bytes, launches {got}"
        + (f", {json.dumps(extra)}" if extra else "")
        for label, (got, secs, peak, extra) in s10.items()), flush=True)

    # ------------------------------------------------- 31. K17 (S11) vs plain
    t_phase = time.perf_counter()
    new, k17_info, k17_errs = k17_checks(graph, tg, dev)
    kernels.update(new)
    print(f"phase 31 K17 vs plain on {card} ({time.perf_counter() - t_phase:.1f} s; the slice "
          f"graph's Symmetric Normalized Laplacian in {S11_SHARDS} shards at D {DIM}, the "
          "halo buffers filled by indexing; ms per call on shard 0; K17c and K17d at S1's "
          "batch on the S1 tables in 4 row shards): " + "; ".join(
              f"{k} err {v['max_abs_err']:.3g} ms {v['ms']:.4f} plain {v['plain_ms']:.4f} "
              f"bound {v['bound_ms']:.4f} ({v['bound_by']})"
              + (f" {v['library']} {v['library_ms']:.4f}" if v["library_ms"] is not None
                 else f" library {v['library']}" if "library" in v else "")
              for k, v in new.items())
          + f" | K17c count beside index_add_ of the owned ids already picked "
          f"{new['owned_count']['picked_index_add_ms']:.4f} ms"
          + f" | partition: comm_rows {k17_info['comm_rows']}, H {k17_info['halo_width']}, "
          f"S {k17_info['shard_rows']}, arcs a shard {k17_info['shard_arcs']}, host build "
          f"{k17_info['partition_s']:.1f} s | S1 batch: {k17_info['batch_ids']} distinct ids, "
          f"{k17_info['shard0_owned']} on shard 0 | errors by check: {k17_errs}", flush=True)

    # ----------------------------------- 32. S11 on a one-rank NCCL group
    t_phase = time.perf_counter()
    s11_ms, s11_errs, s11_paths = s11_runs(graph, tg, dev)
    # The kernels line's K17 launches: the sums over the paths' own runs.
    s11_launches = check_launches("S11", {k: sum(c.get(k, 0) for c in s11_paths.values())
                                          for k in S11_KERNELS}, S11_KERNELS)
    print(f"phase 32 S11 on a one-rank NCCL group on {card} ({time.perf_counter() - t_phase:.1f} "
          "s; each path's step held to its reference on the same batch, then 3 steps, ms a "
          f"step on the host clock): {s11_ms} | largest error by path: {s11_errs} | launches "
          f"by path (held and timed steps): {s11_paths} | K17 launches summed {s11_launches}",
          flush=True)

    # ----------------------------------------- 33. K20 (sddmm, arc chunks)
    t_phase = time.perf_counter()
    new, k20_errs, k20_launches = k20_checks(graph, tg, dev)
    kernels.update(new)
    print(f"phase 33 K20 vs plain on {card} ({time.perf_counter() - t_phase:.1f} s; sddmm over "
          f"the slice graph's {tg.n_arcs} arcs on [{N_NODES}, {DIM}] tables, the chunks at "
          f"{K20_SLOTS[-1]} slots): " + "; ".join(
              f"{k} err {v['max_abs_err']:.3g} ms {v['ms']:.4f} plain {v['plain_ms']:.4f} "
              f"bound {v['bound_ms']:.4f} ({v['bound_by']})"
              + (f" {v['library']} {v['library_ms']:.4f}" if v["library_ms"] is not None
                 else f" library {v['library']}")
              + (f" row_ptr search {v['search_ms']:.4f}" if "search_ms" in v else "")
              for k, v in new.items())
          + f" | errors by check: {k20_errs} | every arc scored in chunks, launches "
          f"{k20_launches}", flush=True)

    # ------------------------------------------------------------ 34. S12
    t_phase = time.perf_counter()
    s12 = s12_runs(graph, dev)
    s12_errs = s12_injected_steps(dev)
    s12_ranks = s12_ranking_on_card(dev)
    print(f"phase 34 S12 on {card} ({time.perf_counter() - t_phase:.1f} s; the 21 KGE rows "
          f"through embed_graph on the typed slice graph at D {DIM}, batch {S6_BATCH}, one "
          f"epoch cut to {S12_STEPS} steps; step ms on CUDA events over "
          f"{S12_PROFILE_STEPS} steady steps, busy share from their kernels' device time): "
          + " | ".join(f"{name}: {json.dumps(v)}" for name, v in s12.items())
          + f" | one injected step at D {DIM}, card against CPU, largest difference: "
          f"{s12_errs} | tests/test_kge.py's ranking on the card (positive, corrupted mean "
          f"distance): {s12_ranks}", flush=True)

    # ------------------------------------------- 36. S14 node label (A10)
    t_s14 = t_phase = time.perf_counter()
    s14 = s14_node_label_runs(typed, dev)
    kernels["spmm"]["graph_convolution_hop"] = s14["graph_convolution_hop"]
    # K7 against its plain version at the label GCNs' first convolution
    # ([n, 50]: the scalar route), forward and backward.
    kernels["spmm"]["label_max_abs_err"] = s14["k7_err"]
    spine_launches, spine_s, spine_peak = s14["spine"]
    print(f"phase 36 S14 node label on {card} ({time.perf_counter() - t_phase:.1f} s; the "
          f"typed slice graph, {S10_TYPES} node types, no node features): "
          "node_label_prediction_evaluation of the Kipf GCN at the reference's defaults "
          "(units 128-128, head 128, dropout 0.5, 200 epochs, patience 20), one Stratified "
          f"Monte Carlo holdout: {s14['seconds']:.2f} s (fit {s14['fit_s']:.2f} s), "
          f"{s14['epochs']} epochs, {s14['s_per_epoch']:.4f} s an epoch (median), step "
          f"{s14['step_ms']:.3f} ms on CUDA events, K7 {s14['k7_per_epoch']:.0f} launches an "
          f"epoch, launches {s14['launches']}, peak {s14['peak_bytes']} bytes, loss "
          f"{s14['first_loss']:.4f} -> {s14['last_loss']:.4f}, panel {json.dumps(s14['panel'])}, "
          f"K7 at the first convolution's shape against the plain version, every combiner, "
          f"forward and backward: largest error {s14['k7_err']:.3g}"
          " | GraphConvolution(2 hops, D " + str(S14_CONV_DIM) + "), seconds and largest error "
          "against the plain hops on the card: " + "; ".join(
              f"transpose={t} {secs:.2f} s, err {err:.3g}"
              for t, (secs, err) in s14["graph_convolution"].items())
          + " | the transposed kernel's hop: " + ", ".join(
              f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
              for k, v in s14["graph_convolution_hop"].items())
          + f" | Node-label-based SPINE: {spine_s:.2f} s, peak {spine_peak} bytes, launches "
          f"{spine_launches}, distances exactly the plain version's", flush=True)

    # ------------------------------------------- 37. S14 edge label (A10)
    t_phase = time.perf_counter()
    s14_edges = s14_edge_label_runs(typed, dev)
    print(f"phase 37 S14 edge label on {card} ({time.perf_counter() - t_phase:.1f} s; the "
          f"typed slice graph, {S10_TYPES} edge types, no node features): "
          "edge_label_prediction_evaluation of the Kipf GCN at its default widths (units "
          "128-128, towers 64, head 32, batch one arc a node), one Stratified Monte Carlo "
          f"holdout, cut to {S14_EDGE_EPOCHS} epochs of its 200: " + " | ".join(
              f"{label}: {v['seconds']:.2f} s (fit {v['fit_s']:.2f} s), batch {v['batch']}, "
              f"{v['steps_per_epoch']} steps an epoch, s an epoch {v['s_per_epoch']}, step ms "
              f"{v['step_ms']} (host clock, an epoch over its steps), losses {v['losses']}, "
              f"launches {v['launches']}, peak {v['peak_bytes']} bytes, panel "
              f"{json.dumps(v['panel'])}, K7 at the first convolution's shape against the "
              f"plain version: largest error {v['k7_err']:.3g}"
              for label, v in s14_edges.items()), flush=True)
    kernels["spmm"]["label_max_abs_err"] = max(
        kernels["spmm"]["label_max_abs_err"], *(v["k7_err"] for v in s14_edges.values()))
    label_launches = {
        "spmm": s14["launches"]["spmm"] + s14["graph_convolution_spmm"] + sum(
            v["launches"]["spmm"] for v in s14_edges.values()),
        "edge_metrics": s14_edges["use_edge_metrics"]["launches"]["edge_metrics"],
        "min_plus_step": spine_launches["min_plus_step"]}
    print(f"chip_smoke: phases 36-37 added {time.perf_counter() - t_s14:.1f} s", flush=True)

    # ------------------------------ 39. S15 edge prediction (sklearn-like)
    t_s15 = t_phase = time.perf_counter()
    exact_cap = edge_metrics_exact_cap_checks(graph, tg)
    kernels["edge_metrics"]["exact_cap"] = exact_cap
    kernels["edge_metrics"]["max_abs_err"] = max(
        kernels["edge_metrics"]["max_abs_err"],
        *(v[k] for v in exact_cap.values() for k in ("max_abs_err", "host_max_abs_err")))
    s15 = s15_edge_prediction_runs(dev)
    print(f"phase 39 S15 edge prediction on {card} ({time.perf_counter() - t_phase:.1f} s): "
          "K8 at the adapters' cap (the largest degree) on "
          f"{K8_PAIRS} pairs, against its plain version at that cap and the host copy of "
          "graph/metrics.py: " + "; ".join(
              f"{g} graph cap {v['cap']} (longest expanded row {v['longest_expanded_row']}): "
              f"err {v['max_abs_err']:.3g}, against the host copy on {v['host_pairs']} pairs "
              f"{v['host_max_abs_err']:.3g}, ms {v['ms']:.4f}, plain {v['plain_s']:.2f} s, "
              f"host copy {v['host_s']:.2f} s" for g, v in exact_cap.items())
          + f" | edge_prediction_evaluation on planted_partition_edges({S15_NODES}, "
          f"{S15_EDGES}, {S15_COMMUNITIES} communities) ({s15['arcs']} arcs, graph "
          f"{s15['graph_s']:.1f} s; train "
          f"{s15['train_arcs']}, test {s15['test_arcs']} arcs), one connected holdout, "
          f"Node2Vec SkipGram features (D {DIM}, L {WALK}, w {WINDOW}, K {NEGS}, "
          f"{S15_EPOCHS} epochs, decay {S15_DECAY}), a least-squares classifier on Hadamard with "
          f"use_edge_metrics (K8 at cap {s15['k8_cap']}, once for the fit and once in each of "
          f"{s15['k8_chunks']} chunks) and a centroid classifier on Concatenate: "
          f"{s15['seconds']:.2f} s, peak {s15['peak_bytes']} bytes, rows "
          f"{json.dumps(s15['rows'])}, launches {s15['launches']} | on {S15_PAIRS} pairs, the "
          f"card's features against the CPU route's, largest error {s15['feature_err']}, K8's "
          f"metric columns against the host copy {s15['metrics_err']:.3g} (rtol "
          f"{S15_METRICS_RTOL}) | the least-squares test scores against the same estimator fit "
          f"on the CPU route's features ({s15['cpu_s']:.2f} s): largest difference "
          f"{s15['score_err']:.3g}", flush=True)

    # --------------------------------- 40. S15 label tasks (sklearn-like)
    t_phase = time.perf_counter()
    s15_labels = s15_label_runs(typed, dev)

    def label_rows(rows):
        return {r["evaluation_mode"]: {k: round(float(r[k]), 4) for k in (
            "accuracy", "f1_score_macro", "auroc_macro_ovr")} for r in rows}
    node_l, edge_l = s15_labels["node label"], s15_labels["edge label"]
    print(f"phase 40 S15 label tasks on {card} ({time.perf_counter() - t_phase:.1f} s): "
          "node_label_prediction_evaluation of a centroid classifier on the typed slice "
          f"graph's {S10_TYPES} node types (seeded [{N_NODES}, {DIM}] features), one "
          f"Stratified Monte Carlo holdout: {node_l['seconds']:.2f} s, peak "
          f"{node_l['peak_bytes']} bytes, no kernel launched, panel "
          f"{json.dumps(label_rows(node_l['rows']))} | edge_label_prediction_evaluation of a "
          f"least-squares classifier on Concatenate with use_edge_metrics on erdos_renyi("
          f"{S15_LABEL_NODES}, {S15_LABEL_EDGES}, {S10_TYPES} edge types) ({edge_l['arcs']} "
          f"arcs, {edge_l['features']} features, K8 at cap {edge_l['k8_cap']}): "
          f"{edge_l['seconds']:.2f} s, peak {edge_l['peak_bytes']} bytes, launches "
          f"{edge_l['launches']}, panel {json.dumps(label_rows(edge_l['rows']))} | named rows: "
          f"{json.dumps(s15_labels['named'])}", flush=True)
    adapter_launches = {name: s15["launches"].get(name, 0) + edge_l["launches"].get(name, 0)
                        for name in S15_KERNELS}
    print(f"chip_smoke: phases 39-40 added {time.perf_counter() - t_s15:.1f} s", flush=True)

    # ------------------------------------ 41. S16 the Graph surface (A15)
    t_s16 = t_phase = time.perf_counter()
    s16 = s16_graph_runs(typed, dev)
    compat_launches = s16["compat_launches"]
    print(f"phase 41 S16 Graph surface on {card} ({time.perf_counter() - t_phase:.1f} s; the "
          f"typed slice graph exported by Graph._device_graph in {s16['export_s']:.2f} s): "
          + "; ".join(f"{k} {json.dumps(s16[k])}" for k in (
              "node2vec K1", "node2vec K10", "edge batch", "siamese", "siamese typed",
              "edge metrics"))
          + " | each equal to its op launched directly at the same seed; walk steps, "
          "positives and siamese pairs arcs; K8 against the host copy on the first "
          f"{S15_HOST_PAIRS} pairs | launches by method {s16['launches']} | zero-argument "
          f"sweep on erdos_renyi(120, 400, seed=3, typed, weighted): {json.dumps(s16['sweep'])}"
          f" | compat_launches {compat_launches}", flush=True)

    # ------------------------------ 42. S16 the spectral rows (A15), host
    t_phase = time.perf_counter()
    s16_rows = s16_spectral_runs(dev)
    print(f"phase 42 S16 spectral rows on the host of {card} ({time.perf_counter() - t_phase:.1f}"
          f" s; scipy ARPACK in float64, no kernel): erdos_renyi({S16_SPECTRAL_NODES}, "
          f"{S16_SPECTRAL_EDGES}) at embedding_size 100: " + "; ".join(
              f"{k} fit {v['seconds']:.2f} s, orthogonality err {v['orthogonality_err']:.3g}"
              for k, v in s16_rows.items() if k in S16_SPECTRAL_ROWS)
          + f" | HOPE Resnik on a {S16_DAG_NODES}-node DAG ({s16_rows['HOPE Resnik']['arcs']} "
          f"arcs) {s16_rows['HOPE Resnik']['seconds']:.2f} s | the gate: HOPE features, a "
          "Perceptron on Hadamard through edge_prediction_evaluation on random_geometric(1000, "
          f"0.07), connected holdout 3: test AUROC {s16_rows['gate']['auroc']:.4f} (threshold "
          f"the reference's {GATE_REFERENCE_HOPE_AUROC:.4f} less 0.03 = "
          f"{GATE_REFERENCE_HOPE_AUROC - 0.03:.4f}), {s16_rows['gate']['seconds']:.2f} s, "
          f"launches {s16_rows['gate launches']}", flush=True)
    print(f"chip_smoke: phases 41-42 added {time.perf_counter() - t_s16:.1f} s", flush=True)

    # ------------- 43. S17 resume, persistence, caches, visualizer (A12, A16)
    t_phase = time.perf_counter()
    a12, a12_gcn, a12_s1, a12_launches = a12_resume_runs(graph, dev)
    a12_rest = a12_persistence_and_cache_runs(graph, a12_gcn, a12_s1, dev)
    del a12_gcn, a12_s1
    torch.cuda.empty_cache()
    print(f"phase 43 S17 on {card} ({time.perf_counter() - t_phase:.1f} s; the slice graph, "
          "checkpoints every epoch in a temporary directory): " + " | ".join(
              f"{name} ({what}): uninterrupted fits {[round(x, 2) for x in v['uninterrupted_s']]}"
              f" s, killed after save {kill} in {v['killed_s']:.2f} s, resumed "
              f"{v['resumed_s']:.2f} s; saves s {[round(x, 3) for x in v['save_s']]}, bytes "
              f"{v['save_bytes']}; the checkpoint reloads bit for bit (draws' key and offset "
              f"{v['draws']}); the first batch after the resume equals the uninterrupted "
              f"fit's; final tables: two uninterrupted fits differ by "
              f"{v['uninterrupted_diff']:.3g}, the resumed fit from the nearer by "
              f"{v['resumed_diff']:.3g} (limit {v['limit']:.3g}); resumed launches "
              f"{v['launches']}"
              for name, what, kill, v in (
                  ("S1", f"Node2Vec SkipGram, D {DIM}, L {WALK}, w {WINDOW}, K {NEGS}, batch "
                         f"{BATCH}, {A12_S1_EPOCHS} epochs", A12_S1_KILL, a12["S1"]),
                  ("GCN", f"GCNEdgePrediction, batch {GCN_BATCH}, units 128-128, dropout 0.5, "
                          f"{A12_GCN_EPOCHS} epochs", A12_GCN_KILL, a12["GCN"]),
                  ("LINE", f"Second-order LINE, D {DIM}, batch {S6_BATCH}, "
                           f"{A12_LINE_EPOCHS} epochs", A12_LINE_KILL, a12["LINE"])))
          + f" | dump_model of the resumed GCN {a12_rest['dump_s']:.2f} s, "
          f"{a12_rest['dump_bytes']} bytes, load_model on the CPU {a12_rest['load_s']:.2f} s "
          f"(every tensor on the CPU); predict_proba on {A12_PAIRS} pairs, the CPU route "
          f"against the card's: largest difference {a12_rest['predict_err']:.3g} (both "
          f"{a12_rest['predict_s']:.2f} s) | EmbeddingResult.dump and load of the resumed S1 "
          f"embedding {a12_rest['embedding_dump_load_s']:.2f} s, "
          f"{a12_rest['embedding_bytes']} bytes | embed_graph(enable_cache=True) twice (one "
          f"S1 epoch): s {[round(x, 2) for x in a12_rest['embedding_cache_s']]}, launches "
          f"{a12_rest['embedding_cache_launches']}, file {a12_rest['embedding_cache_bytes']} "
          f"bytes, equal | edge_prediction_evaluation(enable_cache=True) twice on the gate "
          f"fixture: s {[round(x, 2) for x in a12_rest['experiment_cache_s']]}, launches "
          f"{a12_rest['experiment_cache_launches']}, equal rows, test AUPRC "
          f"{a12_rest['experiment_auprc']} | visualizer imported; missing here "
          f"{a12_rest['visualizer']['missing']}, its fit raised the ImportError of "
          f"{a12_rest['visualizer']['raised']}", flush=True)
    print(f"chip_smoke: phase 43 added {time.perf_counter() - t_phase:.1f} s", flush=True)

    keys = {"source", "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms"}
    missing = {name: keys - set(v) for name, v in kernels.items() if keys - set(v)}
    if missing:
        raise AssertionError(f"kernels entries without {missing}")
    launches = {**path_launches, **gcn_launches, **perceptron_launches,
                **{"edge_metrics": k8_launches["edge_metrics"]}, **probe_launches,
                "spmm_combine": kernels["spmm"]["hub"]["launches"]["spmm_combine"],
                "khop_merge": k16_hub_launches["khop_merge"],
                **{k: s5_launches[k] for k in ("ell_walks", "cbow_update")},
                **k10_launches, **s6["Second-order LINE"][1], **s6["TransE"][1],
                "walklets_update": s7["Walklets SkipGram"][1]["walklets_update"],
                # Since the S1 step draws in one launch, K1's path is the GloVe
                # corpus and K2's the p/q steps.
                "first_order_walks": s7["Node2Vec GloVe"][1]["first_order_walks"],
                "nce_negatives": s5_launches["nce_negatives"],
                **{k: s7["Node2Vec GloVe"][1][k] for k in ("cooccurrences",) + S7_K13B},
                "min_plus_step": s8["Degree-based SPINE"][1]["min_plus_step"],
                "window_cooccurrence_counts": s8["Degree-based WINE"][1]["spmm"],
                **{k: s8_gcn["GCN + HyperSketching"][1][k] for k in S8_SKETCH_KERNELS},
                "hll_registers": k16_general["hll_registers"],
                "sketch_hop2": s8["HyperSketching p12"][1]["sketch_hop2"],
                **{k: s9["NodeSketch"][0][k] for k in S9_SKETCH_KERNELS},
                "ell_walks_typed": s10["typed SkipGram"][0]["ell_walks_typed"],
                "exact_walks": s10["random_walks typed"][0]["exact_walks"],
                **s11_launches, **k20_launches}
    randne_hop["launches"] = s9["RandNE"][0]["spmm"]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"build_s": build_s, "kernels": [
        {"name": name, "route": "cuda", "launches": launches[name],
         "harness_launches": harness_launches.get(name, 0),
         "label_launches": label_launches.get(name, 0),
         "adapter_launches": adapter_launches.get(name, 0),
         "compat_launches": compat_launches.get(name, 0),
         "a12_launches": a12_launches.get(name, 0), **v}
        for name, v in kernels.items()
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
