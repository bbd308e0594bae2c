#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`embiggen_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, one line each (with its seconds), in order; any failure raises and
the exit code is not 0:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the kernels from `embiggen_tpu_torch/csrc/` with nvcc;
  3. K1-K4 against their plain PyTorch versions on the card, at the shapes
     the S1 slice gives them, with both times (K1 and K2, like K5 and K6 in
     phase 4, which take under 0.1 ms, also with the kernel's device time
     from torch.profiler, as their wrappers' host work takes longer than
     the kernel): K3 and K4's SkipGram combine at the flagship shapes, the
     harness's SkipGram shapes and a D that is
     not a multiple of 4, with and without centre weights (K3's sums rtol
     1e-4 / atol 1e-5: sums in another order; its counts exactly; the
     tables after the combine atol 1e-5: atomics add in no fixed order; the
     sums and counts all zero after the combine); K4's standalone mean
     scatter at the flagship shapes (atol 1e-5);
     K1 and K2, which are samplers, by arc
     validity and chi-square tests (fail at p < 1e-3): on small weighted
     and unweighted graphs against the exact distributions, and on the
     slice graph at the slice shapes against both the exact distributions
     and their plain versions, with draws binned by node degree and by
     blocks of node ids; K2 also over the slice graph's 20M arc ids (bins
     and the count of repeated arcs). Every sampler test uses fixed seeds;
  4. K5-K7, P1 and P2 against their plain versions at the shapes of the
     link-prediction slice and the probe: K5 exactly on 2^20 queries over
     the 20M-arc graph, half of them arcs; K6 (2^20 slots) by its exact
     label layout, positives uniform over arc ids, negative endpoints
     degree-proportional (against the exact distribution and the plain
     version), no more arcs or self-loops among negatives than two redraws
     leave; K7 forward for the three combiners and its backward through
     autograd, on the slice graph at D 128 and on a 20,000-node weighted
     graph at D 30 (rtol 1e-5 / atol 1e-5: sums in another order); P1 and P2
     (rtol 1e-5 / atol 1e-3: sums of 256 and 8192 rows in another order);
     K8 on 2^20 pairs (half arcs, half uniform pairs) of the slice graph
     and of the slice graph plus 256 hubs of 4,096-65,536 random
     neighbours (with hub-hub pairs, truncated at cap 128): the common
     neighbour counts and preferential attachment exactly, Jaccard rtol
     1e-6, Adamic-Adar and resource allocation rtol 1e-5 / atol 1e-6 (sums
     in another order);
  5. S1: three SkipGram steps on injected batches, kernel path against the
     plain path on the CPU; then `embed_graph` of Node2Vec SkipGram on
     erdos_renyi(1M nodes, 10M edges) at D=128, L=64, w=5, K=10, batch
     32768, 2 epochs, with K1, K2, K3 and K4's combine launched, and not
     K4's standalone scatter;
  6. S3: three GCN Adam steps on injected batches, card against CPU from
     the same parameters; then the bench configuration: GCNEdgePrediction
     (units 128-128, Symmetric Normalized Laplacian, batch 2^20) for 2
     epochs on the same graph with seeded [1M, 128] features, and
     predict_proba on its 20M arcs, with K6 and K7 launched;
  7. S2: the harness configuration: PerceptronEdgePrediction (Degree +
     CosineSimilarity, 15 epochs) on phase 5's embeddings, fitted and
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
 10. S4: the flagship harness (`embiggen_tpu_torch.scripts.harness.run`):
     `edge_prediction_evaluation` of a Perceptron and a Kipf GCN over
     SkipGram features on a 1M-node planted-partition graph, with K1-K7
     launched; every phase second, peak device memory, and test AUPRC at
     least 0.85 (printed beside the reference's 0.8712);
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
     combine launched and K1, K10 and K3 not; one epoch each of p/q
     SkipGram (K9 and K3) and DeepWalk CBOW (K1 and K11); `random_walks` on
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
     K 10; 2 epochs) and Walklets CBOW (1 epoch) with K1, K2, K12 and K4's
     combine launched and K3, K11, K9 and K10 not, in pairs/s; Node2Vec
     GloVe (D 128, batch 65536, L 16, w 2, iterations 1; 1 epoch), with the
     co-occurrence build timed apart, and Walklets GloVe (power 4, L 16),
     with K1, K13a, K2 and K13b launched; Role2Vec (D 128, 1 epoch) with K2
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
     its three hops exactly at 4 and 8 and, at 12, each hop from the one
     before on a tenth of the rows; K16b at 2^20 pairs (half arcs, half
     uniform pairs) for H 1-3 at each precision, and its general route at
     H 6 (two copies of the three hops of the first 131,072 nodes), within
     `tests/hll_checks.py`'s tolerance, each case timed; each with its time,
     bound and library call (`torch.sparse.mm` for WINE's hop);
 22. S8 through `embed_graph` on the slice graph: Degree-based and
     Score-based SPINE (D 100, depth 32; seeded scores), WeightedSPINE on
     the weighted twin, Degree-based WINE (D 100, window 2), RUBICONE and
     RUINE (D 100, 2 convolutions), HyperSketching (hops 3, precision 8,
     bits 6) over all 20M arcs, with K15a, K7 or K16 launched; then the
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
     test AUROC at least the reference's less 0.03.
Then a JSON line of the kernels (with the build seconds; each with its
bound, from this run's inputs at the published HBM and fp32 peaks, and the
time of one PyTorch call computing the same function where there is one,
named by `library`),
the card's line again, and last `{"ok": true, "device": {...}}`.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_NODES, N_EDGES = 1_000_000, 10_000_000
DIM, WALK, WINDOW, NEGS, BATCH = 128, 64, 5, 10, 32768
P_MIN = 1e-3
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


# The CUDA functions each wrapper's count stands for, as torch.profiler names
# them (a prefix where one launch runs several: K12's update and counts pass,
# K13a's six).
KERNEL_NAMES = {
    "first_order_walks": "first_order_walks_kernel", "nce_negatives": "node_draws_kernel",
    "skipgram_nce_update": "skipgram_nce_kernel",
    "skipgram_mean_combine": "skipgram_combine_kernel", "csr_edge_ids": "csr_edge_ids_kernel",
    "edge_prediction_mini_batch": "edge_minibatch_kernel", "spmm": "csr_spmm_kernel",
    "edge_metrics": "edge_metrics_kernel", "ell_walks": "ell_walks_kernel",
    "rejection_walks": "rejection_walks_kernel", "cbow_update": "cbow_kernel",
    "mean_scatter": "scatter_rows_kernel", "mean_combine": "mean_rows_combine_kernel",
    "siamese_mini_batch": "siamese_batch_kernel", "line_mini_batch": "line_batch_kernel",
    "walklets_update": "walklets_", "cooccurrences": "cooc_",
    "glove_gradients": "glove_gradients_kernel", "glove_node_update": "glove_node_update_kernel",
    "glove_context_update": "glove_context_update_kernel", "min_plus_step": "min_plus_kernel",
    "hll_registers": "singletons_kernel", "khop_sketches": "hop_kernel",
    "edge_sketch_features": "edge_features_", "sketch_candidates": "sketch_candidates_kernel",
    "sketch_race_step": "sketch_race_kernel",
}


def counter_of(event_name):
    """The wrapper count whose kernel the profiler names `event_name`, or None."""
    return next((k for k, v in KERNEL_NAMES.items() if v in event_name), None)


def profiled(run, require_all=True):
    """(device events, {counter: launches}, {counter: events kept}) of
    torch.profiler around `run()`. The profiler drops some of a session's
    kernel records in long processes (it kept 7 of 10 launches, or 19 of
    20, in runs that launched them all), so `device_ms` takes each kernel's
    mean time over the events kept. It has also kept none of the last 20
    launches of a session (a run of K14's LINE sampler at the end of
    `device_ms`'s session), so with `require_all` each session ends with
    padding work of PyTorch's own, and a session that kept no event of a
    kernel it launched is run again, at most three times in all."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from embiggen_tpu_torch.ops import _build

    pad = torch.zeros(1 << 16, device="cuda")
    for _ in range(3):
        before = _build.launch_counts()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
            for _ in range(32 if require_all else 0):
                pad.add_(1.0)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        launched = {k: v - before[k] for k, v in _build.launch_counts().items()
                    if v > before[k] and k in KERNEL_NAMES}
        kept = {k: sum(KERNEL_NAMES[k] in e.name for e in events) for k in launched}
        if all(kept.values()) or not require_all:
            return events, launched, kept
    raise AssertionError(f"torch.profiler kept no event of a launched kernel three "
                         f"times: {kept} of {launched}")


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
    events, launched, kept = profiled(run, require_all=False)
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

    params = map_params(lambda t: t.clone().requires_grad_(True), model._params)
    optimizer = torch.optim.Adam(param_leaves(params), lr=model._learning_rate)
    tg = graph.device(model.device, with_sources=True)
    gen = torch.Generator().manual_seed(1)

    def step():
        optimizer.zero_grad(set_to_none=True)
        model._loss(params, model._csr_kernels, tg, None, gen, None).backward()
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


def edge_kernel_checks(tg):
    """K5 and K6 on the 20M-arc graph at the slice shapes. Returns (their
    kernels entries, the K6 p-values)."""
    from scipy.stats import poisson

    from embiggen_tpu_torch.ops.negatives import (
        edge_prediction_mini_batch, edge_prediction_mini_batch_plain,
    )
    from embiggen_tpu_torch.ops.walks import csr_edge_ids, csr_edge_ids_plain

    dev, n, n_arcs = tg.device, tg.n_nodes, tg.n_arcs
    rng = np.random.default_rng(21)
    q = 1 << 20
    arc = torch.from_numpy(rng.integers(0, n_arcs, q // 2)).to(dev)
    other = torch.from_numpy(rng.integers(0, n, (2, q - q // 2), dtype=np.int32)).to(dev)
    src = torch.cat([tg.sources[arc], other[0]])
    dst = torch.cat([tg.col_idx[arc], other[1]])
    ids, found = csr_edge_ids(tg.row_ptr, tg.col_idx, src, dst)
    want_ids, want_found = csr_edge_ids_plain(tg.row_ptr, tg.col_idx, src, dst)
    if not (torch.equal(ids, want_ids) and torch.equal(found, want_found)):
        raise AssertionError("K5 and its plain version differ")
    if not (bool(found[:q // 2].all()) and torch.equal(ids[:q // 2], arc.int())):
        raise AssertionError("K5 missed an arc")
    # The same lookup as one call: a search over the sorted src * N + dst
    # keys of the arcs.
    keys = tg.sources.long() * n + tg.col_idx.long()
    q_keys = src.long() * n + dst.long()
    entries = {"csr_edge_ids": dict(
        source="embiggen_tpu_torch/csrc/edges.cu",
        replaces="embiggen_tpu/ops/walks.py:66",
        max_abs_err=float((ids - want_ids).abs().max()),
        ms=time_ms(lambda: csr_edge_ids(tg.row_ptr, tg.col_idx, src, dst), 20),
        plain_ms=time_ms(
            lambda: csr_edge_ids_plain(tg.row_ptr, tg.col_idx, src, dst), 3),
        library_ms=time_ms(lambda: torch.searchsorted(keys, q_keys), 20),
        library="torch.searchsorted",
        # pairs in, ids and flags out, two row_ptr reads and a search each
        **bound(q * (8 + 5 + 8) + 4 * float(search_reads(tg.degrees[src.long()]).sum()), 0),
    )}
    del keys, q_keys

    gen, cuda_gen = torch.Generator().manual_seed(22), torch.Generator(device=dev).manual_seed(23)
    s, d, labels = edge_prediction_mini_batch(tg, gen, GCN_BATCH)
    ps, pd, _ = edge_prediction_mini_batch_plain(tg, cuda_gen, GCN_BATCH)
    n_neg = int(round(GCN_BATCH * 0.5))
    n_pos = GCN_BATCH - n_neg
    want_labels = torch.cat([torch.ones(n_pos, device=dev), torch.zeros(n_neg, device=dev)])
    layout_err = float((labels - want_labels).abs().max())
    if layout_err != 0.0:
        raise AssertionError("K6 label layout differs")
    p = {}
    pos_ids, pos_found = csr_edge_ids_plain(tg.row_ptr, tg.col_idx, s[:n_pos], d[:n_pos])
    if not bool(pos_found.all()):
        raise AssertionError("a K6 positive is not an arc")
    edges = np.linspace(0, n_arcs, ARC_BINS + 1).astype(np.int64)
    observed = torch.bincount(
        torch.bucketize(pos_ids.long(), torch.from_numpy(edges[1:-1]).to(dev), right=True),
        minlength=ARC_BINS).double().cpu().numpy()
    p["K6 positives by arc-id bin"] = exact_p(observed, np.diff(edges) * (n_pos / n_arcs))
    p["K6 positives repeats"] = repeats_p(pos_ids, n_arcs)
    deg = tg.degrees.double()
    for side, got, plain in (("sources", s, ps), ("destinations", d, pd)):
        observed = node_counts(tg, got[n_pos:])
        binned_tests(p, f"K6 negative {side} vs exact", observed,
                     node_bins(tg, deg * (n_neg / n_arcs)), True)
        binned_tests(p, f"K6 negative {side} vs plain", observed,
                     node_counts(tg, plain[n_pos:]), False)
    # A drawn pair is an arc or a self-loop with probability beta; after two
    # redraws, beta^3 of the negatives stay so.
    prob = deg / n_arcs
    beta = float((prob ** 2).sum() + (prob[tg.sources.long()] * prob[tg.col_idx.long()]).sum())
    _, neg_arcs = csr_edge_ids_plain(tg.row_ptr, tg.col_idx, s[n_pos:], d[n_pos:])
    bad = int((neg_arcs | (s[n_pos:] == d[n_pos:])).sum())
    p["K6 negatives that are arcs or loops"] = float(poisson.sf(bad - 1, n_neg * beta ** 3))
    failed = {k: v for k, v in p.items() if v < P_MIN}
    if failed:
        raise AssertionError(f"K6 tests failed (p < {P_MIN}): {failed}")
    entries["edge_prediction_mini_batch"] = dict(
        source="embiggen_tpu_torch/csrc/edges.cu",
        replaces="embiggen_tpu/ops/negatives.py:60", max_abs_err=layout_err,
        ms=time_ms(lambda: edge_prediction_mini_batch(tg, gen, GCN_BATCH), 20),
        plain_ms=time_ms(lambda: edge_prediction_mini_batch_plain(tg, cuda_gen, GCN_BATCH), 5),
        library_ms=None,
        # pairs and labels out; a positive reads its arc's two ends; a
        # negative draws two arc heads and searches its pair once
        **bound(GCN_BATCH * 12 + n_pos * 8 + n_neg * 16
                + 4 * float(search_reads(tg.degrees[s[n_pos:].long()]).sum()), 0),
    )
    for name, ms in device_ms({
        "csr_edge_ids": lambda: csr_edge_ids(tg.row_ptr, tg.col_idx, src, dst),
        "edge_prediction_mini_batch": lambda: edge_prediction_mini_batch(tg, gen, GCN_BATCH),
    }).items():
        entries[name]["device_ms"] = ms
    return entries, p


def spmm_check(k, x, g, name) -> float:
    """K7 forward for every combiner and its backward through autograd
    against the plain version, over `k` with input `x` and output gradient
    `g`. Returns the largest abs error."""
    from embiggen_tpu_torch.ops.spmm import COMBINERS, csr_spmm_plain, spmm

    err = 0.0
    for combiner in COMBINERS:
        inv = k.inverse_denominator(combiner)
        xg = x.clone().requires_grad_(True)
        y = spmm(k, xg, combiner)
        (dx,) = torch.autograd.grad(y, xg, g)
        err = max(err, check_close(f"K7 forward {combiner} {name}", y.detach(),
                                   csr_spmm_plain(k, x, inv), **K7_TOL))
        err = max(err, check_close(f"K7 backward {combiner} {name}", dx,
                                   csr_spmm_plain(k.transpose, g, None, inv), **K7_TOL))
        del xg, y, dx
    return err


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
    del cols, offsets, a
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


def hub_graph(graph):
    """`graph` plus N_HUBS new nodes, each joined to 4,096-65,536 random
    nodes (hubs included)."""
    from embiggen_tpu_torch.graph import Graph

    rng = np.random.default_rng(27)
    n = graph.number_of_nodes
    sizes = rng.integers(4096, 65536, N_HUBS, endpoint=True)
    hubs = np.repeat(np.arange(n, n + N_HUBS), sizes)
    one = graph.sources < graph.col_idx
    return Graph.from_edge_arrays(
        np.concatenate([graph.sources[one], hubs]),
        np.concatenate([graph.col_idx[one], rng.integers(0, n + N_HUBS, len(hubs))]),
        n_nodes=n + N_HUBS, directed=False, name="ER+hubs")


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
    del htg
    torch.cuda.empty_cache()
    return dict(
        source="embiggen_tpu_torch/csrc/edge_metrics.cu",
        replaces="embiggen_tpu/ops/edge_metrics.py:34",
        max_abs_err=max(err, hub_err), ms=ms, plain_ms=plain_ms,
        library_ms=None, **k8_bound, hub_bound_ms=hub_bound["bound_ms"],
        hub_graph_arcs=hg.number_of_directed_edges, hub_ms=hub_ms,
        hub_plain_ms=hub_plain_ms, hub_pairs_truncated=truncated,
    )


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
    """{counter: device milliseconds per call} of each wrapper in `calls`
    ({counter: fn}, each fn one launch of that wrapper's kernel), from a
    torch.profiler session per wrapper over `reps` calls after a warm-up:
    the kernel alone, where `time_ms` also times the wrapper's host work."""
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    out = {}
    for k, fn in calls.items():
        def run(fn=fn):
            for _ in range(reps):
                fn()
        events, _, kept = profiled(run)
        out[k] = sum(e.time_range.elapsed_us() for e in events
                     if KERNEL_NAMES[k] in e.name) / 1e3 / kept[k]
    return out


def laws_module(name):
    """A module of exact sampler laws under `tests/` (shared with the tests,
    which import it the same way): `pq_laws`, the step laws of the p/q
    samplers in numpy; `batch_laws`, the laws of K14's batches in torch."""
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
        neg = sample_negative_graph(rgg, rgg.number_of_edges, random_state=3 if dist else 0)

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
    device time from torch.profiler, its plain version's time, and its
    bound. Returns {counter: kernels entry}."""
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
    the S7 settings, each under torch.profiler: {model: (the port's launches,
    the names of the other kernels the profiler kept)}. Raises unless a step
    launched K2 once and each of K13b's launches once, or if it ran a kernel
    whose name holds "index" (`index_add_`'s and `index_select`'s do)."""
    from embiggen_tpu_torch.models.embedders import GloVe, WalkletsGloVe
    from embiggen_tpu_torch.ops.glove import (
        GloVeStepWorkspace, cooccurrences, draw_entries, glove_entries,
    )

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
    steps = {"Node2Vec GloVe": lambda: glove._step(entries, params, gen, 0.05),
             "Walklets GloVe": lambda: walklets._glove_step(
                 state, stride1, draw_entries(stride1, batch, gen), 0.05, ws)}
    want = {"nce_negatives": 1, **dict.fromkeys(S7_K13B, 1)}
    out = {}
    with torch.no_grad():
        for name, step in steps.items():
            step()
            torch.cuda.synchronize()
            events, launched, _ = profiled(step)
            others = sorted({e.name[:90] for e in events if counter_of(e.name) is None})
            if launched != want or any("index" in o.lower() for o in others):
                raise AssertionError(f"a {name} step launched {launched} (expected {want}) "
                                     f"and ran {others}")
            out[name] = (launched, others)
    del params, stacked, state, entries, stride1, ws
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


def k16_checks(graph, dev):
    """K16a against its plain version exactly on the slice graph: the
    singletons and the three hops at precisions 4, 8 and 12 (bits 6),
    whole; K16b at K16B_PAIRS pairs (half arcs, half uniform pairs) for H
    1-3 at each precision, and its general route at H 6 (K16B_GENERAL_NODES),
    within tests/hll_checks.py's tolerance, each timed. Returns their
    kernels entries, timed at HyperSketching's defaults, the errors by case,
    and the seconds of the plain hops at each precision."""
    from embiggen_tpu_torch.ops.hll import (
        edge_sketch_features, edge_sketch_features_plain, khop_sketches, khop_sketches_plain,
        singleton_registers, singleton_registers_plain,
    )

    checks = laws_module("hll_checks")
    tg = graph.device(dev)
    rng = np.random.default_rng(31)
    arcs = rng.integers(0, graph.number_of_directed_edges, K16B_PAIRS // 2)
    src = torch.from_numpy(np.concatenate([graph.sources[arcs], rng.integers(
        0, N_NODES, K16B_PAIRS // 2)]).astype(np.int32)).to(dev)
    dst = torch.from_numpy(np.concatenate([graph.col_idx[arcs], rng.integers(
        0, N_NODES, K16B_PAIRS // 2)]).astype(np.int32)).to(dev)
    distinct = int(torch.unique(torch.cat([src, dst])).numel())
    errs, entries, plain_s, k16b_ms = {}, {}, {}, {}

    def hold(name, skh, src, dst, p):
        got = edge_sketch_features(skh, src, dst, p)
        want = edge_sketch_features_plain(skh, src, dst, p)
        worst, ties = checks.feature_errors(skh, src, dst, p, got, want)
        if not worst <= 1.0 or ties > checks.MAX_TIE_SHARE * len(src):
            raise AssertionError(f"K16b {name}: error {worst} of its tolerance, "
                                 f"{ties} near ties")
        errs[f"features {name} (share of tolerance; ties {ties})"] = worst
        k16b_ms[name] = time_ms(lambda: edge_sketch_features(skh, src, dst, p), 10)

    for p in (HLL_PRECISION, 4, 12):
        base = singleton_registers(N_NODES, p, HLL_BITS, 42, dev)
        errs[f"registers p {p}"] = exact_err(
            f"K16a singletons p {p}", base,
            singleton_registers_plain(N_NODES, p, HLL_BITS, 42, dev))
        sk = khop_sketches(tg, base, HLL_HOPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = khop_sketches_plain(tg, base, HLL_HOPS)
        torch.cuda.synchronize()
        plain_s[p] = time.perf_counter() - t0
        errs[f"hops p {p}"] = exact_err(f"K16a hops p {p}", sk, want)
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
                **bound(2 * N_NODES * m + 4 * (N_NODES + 1 + tg.n_arcs), tg.n_arcs * m))
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
        del base, sk
        torch.cuda.empty_cache()
    entries["edge_sketch_features"]["max_abs_err"] = max(
        v for k, v in errs.items() if k.startswith("features"))
    entries["edge_sketch_features"]["ms_by_case"] = k16b_ms
    return entries, errs, plain_s


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
    neg = sample_negative_graph(rgg, test.number_of_edges, random_state=1)
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
    feats = np.random.default_rng(0).standard_normal((N_NODES, DIM), dtype=np.float32)
    s8_gcn = {}
    for label, kw, fit_kw, epochs, names, unused in (
        ("GCN + HyperSketching", dict(edge_feature_models=[HyperSketching(device=dev)]), {}, 2,
         S8_GCN_KERNELS, S8_GCN_UNUSED),
        ("GCN + static edge features", {}, dict(edge_features=[hs_edges]), 1,
         S8_GCN_STATIC_KERNELS, S8_SKETCH_KERNELS),
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
S1_KERNELS = ("first_order_walks", "nce_negatives", "skipgram_nce_update",
              "skipgram_mean_combine")
# K4 standalone serves the minibatch families (S6); the S1 step does not
# launch it.
S1_UNUSED = ("mean_scatter", "mean_combine")
S2_KERNELS = ("csr_edge_ids",)
S3_KERNELS = ("edge_prediction_mini_batch", "spmm")
K8_KERNELS = ("edge_metrics",)
S4_KERNELS = S1_KERNELS + S2_KERNELS + S3_KERNELS
PROBE_KERNELS = ("tile_gather_sums", "table_gather_sums")
# S5: Node2Vec CBOW over p/q walks; a wrong route launches one of the others.
S5_KERNELS = ("nce_negatives", "ell_walks", "cbow_update", "skipgram_mean_combine")
S5_UNUSED = ("first_order_walks", "rejection_walks", "skipgram_nce_update", "mean_scatter",
             "mean_combine")
PQ_SKIPGRAM_KERNELS = ("nce_negatives", "ell_walks", "skipgram_nce_update",
                       "skipgram_mean_combine")
DEEPWALK_CBOW_KERNELS = ("nce_negatives", "first_order_walks", "cbow_update",
                         "skipgram_mean_combine")
REJECTION_KERNELS = ("rejection_walks",)
# S6: LINE draws its batch with K14 and updates through K4 standalone; the
# siamese models draw theirs with K14 and scatter-add with index_add_. None
# launches a walk or K3, K11.
S6_LINE_KERNELS = ("line_mini_batch", "mean_scatter", "mean_combine")
S6_SIAMESE_KERNELS = ("siamese_mini_batch",)
S6_UNUSED = ("first_order_walks", "skipgram_nce_update", "ell_walks", "cbow_update")
# S7: Walklets SkipGram and CBOW step through K1, K2, K12 and K4's SkipGram
# combine; the GloVe models build their entries with K1 and K13a and step
# through K2's uniform draws and K13b's three launches, which update the
# tables in place; Role2Vec walks with K2 and K1 and updates through
# index_add_.
S7_K13B = ("glove_gradients", "glove_node_update", "glove_context_update")
S7_WALKLETS_KERNELS = ("first_order_walks", "nce_negatives", "walklets_update",
                       "skipgram_mean_combine")
S7_WALKLETS_UNUSED = ("skipgram_nce_update", "cbow_update", "ell_walks", "rejection_walks",
                      "mean_scatter", "mean_combine", "cooccurrences") + S7_K13B
S7_GLOVE_KERNELS = ("first_order_walks", "cooccurrences", "nce_negatives") + S7_K13B
S7_GLOVE_UNUSED = ("walklets_update", "skipgram_nce_update", "skipgram_mean_combine",
                   "mean_scatter", "mean_combine", "ell_walks", "rejection_walks")
S7_ROLE2VEC_KERNELS = ("nce_negatives", "first_order_walks")
S7_ROLE2VEC_UNUSED = ("walklets_update", "skipgram_nce_update", "cbow_update", "cooccurrences",
                      "skipgram_mean_combine", "ell_walks") + S7_K13B
# S8: SPINE relaxes with K15a; WINE hops, and RUBICONE and RUINE convolve,
# with K7; HyperSketching sketches with K16a and queries K16b; the GCN with
# lazy HyperSketching features adds K16 to its own kernels, and with a static
# edge-feature matrix K5's arc lookup.
S8_SKETCH_KERNELS = ("hll_registers", "khop_sketches", "edge_sketch_features")
S8_SPINE_KERNELS = ("min_plus_step",)
S8_SPINE_UNUSED = ("spmm",) + S8_SKETCH_KERNELS
S8_CONV_KERNELS = ("spmm",)
S8_CONV_UNUSED = ("min_plus_step",) + S8_SKETCH_KERNELS
S8_SKETCH_UNUSED = ("min_plus_step", "spmm")
S8_GCN_KERNELS = S3_KERNELS + S8_SKETCH_KERNELS
S8_GCN_UNUSED = ("csr_edge_ids", "min_plus_step")
S8_GCN_STATIC_KERNELS = S3_KERNELS + ("csr_edge_ids",)
# S9: NodeSketch races with K18 (its candidate pass, then its race launch,
# each round) and RandNE hops with K7, each launching
# nothing else; the dense rows launch none of the port's kernels.
S9_SKETCH_KERNELS = ("sketch_candidates", "sketch_race_step")
S9_RANDNE_KERNELS = ("spmm",)


def check_launches(path, counts, names, unused=()):
    """The counts of `names` after a path's run; raises if one is 0, or if
    one of `unused` launched."""
    got = {name: counts[name] for name in names}
    if min(got.values()) <= 0:
        raise AssertionError(f"a kernel of the {path} path never launched: {got}")
    if any(counts[name] for name in unused):
        raise AssertionError(f"the {path} path launched one of {unused}: {counts}")
    return got


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also K3's, K11's and K9's phase splits, and profiles of "
                             "steady S1, GCN, S5, S6, S7 and S8 steps and of S9's "
                             "NodeSketch fit")
    args = parser.parse_args()
    t_start = time.perf_counter()
    # ---------------------------------------------------------------- 1. card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on an NVIDIA GPU.")
    from embiggen_tpu_torch.scripts.harness import card_line

    card = card_line()
    print(f"phase 1 card: {card} | torch {torch.__version__} | "
          f"CUDA {torch.version.cuda} | devices {torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.graph.sampling import _NEG_CACHE
    from embiggen_tpu_torch.models import get_model_from_library
    from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction
    from embiggen_tpu_torch.models.gcn import GCNEdgePrediction, GCNEncoder
    from embiggen_tpu_torch.ops import _build
    from embiggen_tpu_torch.ops.negatives import nce_negatives, nce_negatives_plain
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
    kernels = {}

    k1_err, k2_err = sampler_checks(erdos_renyi, first_order_walks,
                                    nce_negatives, dev)
    slice_p = slice_sampler_checks(graph, tg, first_order_walks,
                                   first_order_walks_plain, nce_negatives,
                                   nce_negatives_plain)
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(0)
    cuda_gen = torch.Generator(device=dev).manual_seed(0)
    starts = nce_negatives(tg, gen, (BATCH,), scale_free=False)
    kernels["first_order_walks"] = dict(
        source="embiggen_tpu_torch/csrc/sampling.cu",
        replaces="embiggen_tpu/ops/walks.py:115", max_abs_err=k1_err,
        ms=time_ms(lambda: first_order_walks(tg, starts, WALK, gen), 20),
        plain_ms=time_ms(
            lambda: first_order_walks_plain(tg, starts, WALK, cuda_gen), 5),
        library_ms=None,
        # starts in, walks out; each move reads two row_ptr entries and an arc.
        **bound(4 * BATCH + 4 * BATCH * WALK + 12 * BATCH * (WALK - 1), 0),
    )
    weights = tg.degrees.float()
    kernels["nce_negatives"] = dict(
        source="embiggen_tpu_torch/csrc/sampling.cu",
        replaces="embiggen_tpu/ops/negatives.py:24", max_abs_err=k2_err,
        ms=time_ms(lambda: nce_negatives(tg, gen, (BATCH, NEGS)), 20),
        plain_ms=time_ms(
            lambda: nce_negatives_plain(tg, cuda_gen, (BATCH, NEGS), True), 20),
        # the same degree-proportional draws as one call
        library_ms=time_ms(lambda: torch.multinomial(
            weights, BATCH * NEGS, replacement=True, generator=cuda_gen), 20),
        library="torch.multinomial",
        **bound(8 * BATCH * NEGS, 0),   # an arc's head read, a node id written
    )
    for name, ms in device_ms({
        "first_order_walks": lambda: first_order_walks(tg, starts, WALK, gen),
        "nce_negatives": lambda: nce_negatives(tg, gen, (BATCH, NEGS)),
    }).items():
        kernels[name]["device_ms"] = ms
    del starts, weights

    new, skipgram_errs = skipgram_checks(dev)
    kernels.update(new)
    torch.cuda.empty_cache()
    print(f"phase 3 kernels vs plain on {card} ({time.perf_counter() - t_phase:.1f} s; "
          f"ms per call, at the slice shapes; graph build {graph_s:.1f} s): " + "; ".join(
              f"{k} err {v['max_abs_err']:.3g} ms {v['ms']:.3f}"
              + (f" device {v['device_ms']:.4f}" if "device_ms" in v else "")
              + f" plain {v['plain_ms']:.3f}" for k, v in kernels.items())
          + " | K3 sums / tables after the combine, max abs err by shape: "
          + "; ".join(f"{k} {u:.3g} / {c:.3g}" for k, (u, c) in skipgram_errs.items())
          + " | sampler p-values at the slice shapes: " + "; ".join(
              f"{k} {v:.3g}" for k, v in slice_p.items()), flush=True)

    # ------------------------------------------ 4. K5-K7, P1, P2 vs plain
    t_phase = time.perf_counter()
    new, k6_p = edge_kernel_checks(tg)
    new["spmm"] = spmm_checks(graph, dev)
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
          f"{new['spmm']['gathered_rows_per_s']:.4g} | P1 rows/s "
          f"{new['tile_gather_sums']['rows_per_s']:.4g} GB/s "
          f"{new['tile_gather_sums']['gbytes_per_s']:.4g}; P2 rows/s "
          f"{new['table_gather_sums']['rows_per_s']:.4g} GB/s "
          f"{new['table_gather_sums']['gbytes_per_s']:.4g} | K8 on the hub graph "
          f"({new['edge_metrics']['hub_graph_arcs']} arcs, "
          f"{new['edge_metrics']['hub_pairs_truncated']} pairs at the cap) ms "
          f"{new['edge_metrics']['hub_ms']:.4f} plain "
          f"{new['edge_metrics']['hub_plain_ms']:.4f} | K6 p-values: "
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
    path_launches = check_launches("S1", launches, S1_KERNELS)
    if any(launches[name] for name in S1_UNUSED):
        raise AssertionError(f"the S1 step launched one of {S1_UNUSED}: {launches}")
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
        number_of_epochs=15, random_state=0, device="cuda")
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
          f"{n_train} examples, 15 epochs of "
          f"{n_train // 4096} steps of 4096), last epoch loss "
          f"{perceptron._last_loss:.6g}, predict_proba on {len(perceptron_proba)} "
          f"arcs {perceptron_predict_s:.2f} s, peak {perceptron_peak} bytes; "
          f"launches {perceptron_launches}", flush=True)
    del perceptron_proba, perceptron
    torch.cuda.empty_cache()

    t_phase = time.perf_counter()
    # The negative graph of the fit above is memoized; drop it, so this fit
    # is timed whole.
    _NEG_CACHE.clear()
    perceptron = PerceptronEdgePrediction(
        edge_features=["Degree", "AdamicAdar", "JaccardCoefficient"],
        edge_embeddings=["CosineSimilarity"], number_of_epochs=15,
        random_state=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    perceptron.fit(graph, node_features=result.node_embeddings[0])
    k8_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    perceptron_proba = perceptron.predict_proba(graph)
    k8_predict_s = time.perf_counter() - t0
    k8_launches = check_launches("K8 Perceptron", _build.launch_counts(),
                                 S2_KERNELS + K8_KERNELS)
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

    # ---------------------------------------------------------- 10. S4 harness
    t_phase = time.perf_counter()
    del result
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    harness_out = harness.run(dev, er_graph=graph)
    harness_launches = check_launches("S4", _build.launch_counts(), S4_KERNELS)
    auprc = harness_out["eval_test_auprc"]
    if not auprc >= HARNESS_FLOOR:
        raise AssertionError(f"flagship harness test AUPRC {auprc} on {card} is "
                             f"below {HARNESS_FLOOR}: {harness_out}")
    print(f"phase 10 S4 harness on {card} ({time.perf_counter() - t_phase:.1f} s): "
          f"test AUPRC {auprc:.4f}, {auprc - HARNESS_REFERENCE_AUPRC:+.4f} from the "
          f"reference's {HARNESS_REFERENCE_AUPRC}; {json.dumps(harness_out)}; "
          f"launches {harness_launches}", flush=True)

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
        unused = ("first_order_walks",) if kw else ("ell_walks", "rejection_walks")
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

    # --------------------------------------------------- 13. S5 quality
    t_phase = time.perf_counter()
    cbow_auprc = cbow_quality_on_card(card, dev)
    print(f"phase 13 S5 quality on {card} ({time.perf_counter() - t_phase:.1f} s): "
          "random_geometric(1000, 0.07), connected holdout 3: Node2Vec CBOW return 2 "
          "explore 0.5 features, a Perceptron on Hadamard, mean test AUPRC over "
          f"seeds 0-3 {np.mean(cbow_auprc):.4f} (reference {GATE_REFERENCE_CBOW_AUPRC:.4f}; "
          f"per seed {[round(a, 4) for a in cbow_auprc]})", flush=True)

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

    # --------------------------------------------------- 16. S6 quality
    t_phase = time.perf_counter()
    s6_auroc = s6_quality_on_card(card, dev)
    print(f"phase 16 S6 quality on {card} ({time.perf_counter() - t_phase:.1f} s): "
          "random_geometric(1000, 0.07), fitted whole, edges against as many negatives: "
          f"First-order LINE dot-product AUROC {s6_auroc['First-order LINE']:.4f} (reference "
          f"{GATE_REFERENCE_LINE1_AUROC:.4f}); Unstructured distance AUROC "
          f"{s6_auroc['Unstructured']:.4f} (reference {GATE_REFERENCE_UNSTRUCTURED_AUROC:.4f})",
          flush=True)

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
          "(no index_add_; the other kernels torch.profiler kept, padding included): " + "; ".join(
              f"{name} {launched}, others {others}"
              for name, (launched, others) in glove_launches.items()), flush=True)

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

    # ------------------------------- 21. K15a, K15b, K16a, K16b vs plain (S8)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    weighted_graph = erdos_renyi(N_NODES, N_EDGES, seed=0, weighted=True)
    twin_s = time.perf_counter() - t0
    new, k15_errs, settled = k15_checks(graph, weighted_graph, dev)
    torch.cuda.empty_cache()
    k16, k16_errs, k16_plain_s = k16_checks(graph, dev)
    new.update(k16)
    kernels.update(new)
    torch.cuda.empty_cache()
    print(f"phase 21 K15a, K15b, K16a, K16b vs plain on {card} "
          f"({time.perf_counter() - t_phase:.1f} s; weighted twin built in {twin_s:.1f} s; ms "
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
          f"nodes | K16b ms by case: {k16['edge_sketch_features']['ms_by_case']}", flush=True)

    # ------------------------------------------------------------ 22. S8
    t_phase = time.perf_counter()
    s8, s8_gcn = s8_runs(graph, weighted_graph, dev)
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
        f"CUDA events): {k16b_share}", flush=True)

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

    keys = {"source", "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms"}
    missing = {name: keys - set(v) for name, v in kernels.items() if keys - set(v)}
    if missing:
        raise AssertionError(f"kernels entries without {missing}")
    launches = {**path_launches, **gcn_launches, **perceptron_launches,
                **{"edge_metrics": k8_launches["edge_metrics"]}, **probe_launches,
                **{k: s5_launches[k] for k in ("ell_walks", "cbow_update")},
                **k10_launches, **s6["Second-order LINE"][1], **s6["TransE"][1],
                "walklets_update": s7["Walklets SkipGram"][1]["walklets_update"],
                **{k: s7["Node2Vec GloVe"][1][k] for k in ("cooccurrences",) + S7_K13B},
                "min_plus_step": s8["Degree-based SPINE"][1]["min_plus_step"],
                "window_cooccurrence_counts": s8["Degree-based WINE"][1]["spmm"],
                **{k: s8_gcn["GCN + HyperSketching"][1][k] for k in S8_SKETCH_KERNELS},
                **{k: s9["NodeSketch"][0][k] for k in S9_SKETCH_KERNELS}}
    randne_hop["launches"] = s9["RandNE"][0]["spmm"]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"build_s": build_s, "kernels": [
        {"name": name, "route": "cuda", "launches": launches[name],
         "harness_launches": harness_launches.get(name, 0), **v}
        for name, v in kernels.items()
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
