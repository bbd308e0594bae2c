#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`embiggen_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, one line each (with its seconds), in order; any failure raises and
the exit code is not 0:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the kernels from `embiggen_tpu_torch/csrc/` with nvcc;
  3. K1-K4 against their plain PyTorch versions on the card, at the shapes
     the S1 slice gives them, with both times: K3 and K4 on the same
     inputs (K3 rtol 1e-4 / atol 1e-5: sums in another order; K4 atol 1e-5:
     atomics add in no fixed order); K1 and K2, which are samplers, by arc
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
     autograd (rtol 1e-5 / atol 1e-5: sums in another order); P1 and P2
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
     32768, 2 epochs, with K1-K4 launched;
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
 11. with `--profile` only: torch.profiler over steady steps of S1 and of
     the GCN, one line per kernel name with its device ms per step.
Then a JSON line of the kernels (with the build seconds), the card's line
again, and last `{"ok": true, "device": {...}}`.
"""
import argparse
import dataclasses
import json
import sys
import time

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


def profile(step, n_steps):
    """Device time per kernel name over `n_steps` calls of `step` after 3
    warm-up calls, from torch.profiler. Returns ({name: (ms per step,
    launches per step)}, ms per step on CUDA events)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(n_steps):
            step()
        end.record()
        end.synchronize()
    rows = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, count = rows.get(e.name, (0.0, 0))
            rows[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    if not rows:
        raise AssertionError("torch.profiler recorded no device time")
    return ({k: (us / 1e3 / n_steps, c / n_steps) for k, (us, c) in rows.items()},
            start.elapsed_time(end) / n_steps)


def skipgram_step(model, graph):
    """One steady SkipGram step of the S1 slice, as a closure."""
    tg = model._device_graph(graph)
    gen = torch.Generator().manual_seed(0)
    params = model._init_params(graph, gen)

    def step():
        with torch.no_grad():
            model._step(tg, params, gen, 0.025)
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


def print_profile(name, card, rows, step_ms):
    busy = sum(ms for ms, _ in rows.values())
    print(f"phase 11 profile {name} on {card}: {PROFILE_STEPS} steady steps, "
          f"{step_ms:.3f} ms per step (CUDA events), kernels {busy:.3f} ms "
          f"per step, device busy share {busy / step_ms:.3f}", flush=True)
    for kernel, (ms, count) in sorted(rows.items(), key=lambda r: -r[1][0]):
        print(f"  profile {name} {ms:9.4f} ms/step {ms / busy:7.2%} "
              f"{count:5.2f} launches/step  {kernel[:100]}", flush=True)


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
    entries = {"csr_edge_ids": dict(
        source="embiggen_tpu_torch/csrc/edges.cu",
        replaces="embiggen_tpu/ops/walks.py:66",
        max_abs_err=float((ids - want_ids).abs().max()),
        ms=time_ms(lambda: csr_edge_ids(tg.row_ptr, tg.col_idx, src, dst), 20),
        plain_ms=time_ms(
            lambda: csr_edge_ids_plain(tg.row_ptr, tg.col_idx, src, dst), 3),
    )}

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
    )
    return entries, p


def spmm_checks(graph, dev):
    """K7 over the slice graph's Symmetric Normalized Laplacian at D = 128:
    forward for every combiner and backward through autograd, against the
    plain version. Returns its kernels entry."""
    from embiggen_tpu_torch.graph.laplacians import kernel_coo
    from embiggen_tpu_torch.ops.spmm import COMBINERS, csr_kernel, csr_spmm, csr_spmm_plain, spmm

    t0 = time.perf_counter()
    k = csr_kernel(*kernel_coo(graph, "Symmetric Normalized Laplacian"),
                   graph.number_of_nodes, device=dev)
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    rng = np.random.default_rng(24)
    x = torch.from_numpy(rng.standard_normal((N_NODES, DIM), dtype=np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((N_NODES, DIM), dtype=np.float32)).to(dev)
    err = 0.0
    for combiner in COMBINERS:
        inv = k.inverse_denominator(combiner)
        xg = x.clone().requires_grad_(True)
        y = spmm(k, xg, combiner)
        (dx,) = torch.autograd.grad(y, xg, g)
        err = max(err, check_close(f"K7 forward {combiner}", y.detach(),
                                   csr_spmm_plain(k, x, inv), **K7_TOL))
        err = max(err, check_close(f"K7 backward {combiner}", dx,
                                   csr_spmm_plain(k.transpose, g, None, inv), **K7_TOL))
        del xg, y, dx
    entry = dict(
        source="embiggen_tpu_torch/csrc/spmm.cu",
        replaces="embiggen_tpu/ops/spmm.py:337", max_abs_err=err,
        ms=time_ms(lambda: csr_spmm(k, x), 20),
        plain_ms=time_ms(lambda: csr_spmm_plain(k, x), 3),
        backward_ms=time_ms(lambda: csr_spmm(k.transpose, g), 20),
        backward_plain_ms=time_ms(lambda: csr_spmm_plain(k.transpose, g), 3),
        layout_s=layout_s,
    )
    entry["gathered_rows_per_s"] = k.n_arcs / (entry["ms"] / 1e3)
    return entry


def probe_checks(dev):
    """P1 and P2 against their plain versions at the probe's shapes.
    Returns their kernels entries (with gathered rows/s and GB/s)."""
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
        entries[name] = dict(
            source="embiggen_tpu_torch/csrc/gather_probe.cu", replaces=replaces,
            max_abs_err=err, ms=ms,
            plain_ms=time_ms(lambda: tile_gather_sums_plain(table, ix, tile), 5),
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
    truncated = int((torch.minimum(deg[src.long()], deg[dst.long()]) > 128).sum())
    del got, want
    return (err, time_ms(lambda: edge_metrics(tg, src, dst), 20),
            time_ms(lambda: edge_metrics_plain(tg, src, dst), 2), truncated)


def edge_metrics_checks(graph, tg):
    """K8 on the slice graph and on it plus hubs. Returns its kernels entry
    (with the hub graph's numbers beside)."""
    err, ms, plain_ms, _ = edge_metrics_check(graph, tg, 0)
    hg = hub_graph(graph)
    htg = hg.device(tg.device)
    hub_err, hub_ms, hub_plain_ms, truncated = edge_metrics_check(hg, htg, 4096)
    if truncated == 0:
        raise AssertionError("no K8 pair of the hub graph reached the cap")
    del htg
    torch.cuda.empty_cache()
    return dict(
        source="embiggen_tpu_torch/csrc/edge_metrics.cu",
        replaces="embiggen_tpu/ops/edge_metrics.py:34",
        max_abs_err=max(err, hub_err), ms=ms, plain_ms=plain_ms,
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


# The kernels each path must launch; each path runs with the counts set to
# 0 just before it and read just after.
S1_KERNELS = ("first_order_walks", "nce_negatives", "skipgram_nce_grads", "mean_scatter")
S2_KERNELS = ("csr_edge_ids",)
S3_KERNELS = ("edge_prediction_mini_batch", "spmm")
K8_KERNELS = ("edge_metrics",)
S4_KERNELS = S1_KERNELS + S2_KERNELS + S3_KERNELS
PROBE_KERNELS = ("tile_gather_sums", "table_gather_sums")


def check_launches(path, counts, names):
    """The counts of `names` after a path's run; raises if one is 0."""
    got = {name: counts[name] for name in names}
    if min(got.values()) <= 0:
        raise AssertionError(f"a kernel of the {path} path never launched: {got}")
    return got


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile steady steps of S1 and of the GCN")
    args = parser.parse_args()
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
    from embiggen_tpu_torch.ops.scatter import mean_scatter, mean_scatter_plain
    from embiggen_tpu_torch.ops.skipgram import (
        skipgram_nce_grads, skipgram_nce_grads_plain,
    )
    from embiggen_tpu_torch.ops.walks import first_order_walks, first_order_walks_plain
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
    )
    kernels["nce_negatives"] = dict(
        source="embiggen_tpu_torch/csrc/sampling.cu",
        replaces="embiggen_tpu/ops/negatives.py:24", max_abs_err=k2_err,
        ms=time_ms(lambda: nce_negatives(tg, gen, (BATCH, NEGS)), 20),
        plain_ms=time_ms(
            lambda: nce_negatives_plain(tg, cuda_gen, (BATCH, NEGS), True), 20),
    )
    del starts

    rng = np.random.default_rng(0)
    tables = [torch.from_numpy(
        (0.3 * rng.standard_normal((N_NODES, DIM), dtype=np.float32))).to(dev)
        for _ in range(2)]
    bias = torch.from_numpy(
        3.0 * rng.standard_normal(N_NODES, dtype=np.float32)).to(dev)
    walks = torch.from_numpy(
        rng.integers(0, N_NODES, (BATCH, WALK), dtype=np.int32)).to(dev)
    negs = torch.from_numpy(
        rng.integers(0, N_NODES, (BATCH, NEGS), dtype=np.int32)).to(dev)
    center_w = torch.from_numpy(
        rng.uniform(0, 2, (BATCH, WALK)).astype(np.float32)).to(dev)
    k3_err = 0.0
    for cw in (None, center_w):
        got = skipgram_nce_grads(*tables, bias, walks, negs, WINDOW, 6.0, cw)
        want = skipgram_nce_grads_plain(*tables, bias, walks, negs, WINDOW, 6.0, cw)
        for i, (a, b) in enumerate(zip((got[0],) + got[1] + got[2],
                                       (want[0],) + want[1] + want[2])):
            err = check_close(f"K3 output {i}", a, b, 1e-4, 1e-5)
            if i > 0:
                k3_err = max(k3_err, err)
        del got, want
    kernels["skipgram_nce_grads"] = dict(
        source="embiggen_tpu_torch/csrc/skipgram.cu",
        replaces="embiggen_tpu/models/embedders/walk_based.py:895",
        max_abs_err=k3_err,
        ms=time_ms(lambda: skipgram_nce_grads(
            *tables, bias, walks, negs, WINDOW, 6.0), 10),
        plain_ms=time_ms(lambda: skipgram_nce_grads_plain(
            *tables, bias, walks, negs, WINDOW, 6.0), 3),
    )
    del center_w
    torch.cuda.empty_cache()

    flat, negs_flat = walks.reshape(-1), negs.reshape(-1)
    g_rows = torch.from_numpy(
        rng.standard_normal((flat.numel(), DIM), dtype=np.float32)).to(dev)
    g_negs = torch.from_numpy(
        rng.standard_normal((negs_flat.numel(), DIM), dtype=np.float32)).to(dev)
    g_b = torch.from_numpy(
        rng.standard_normal(flat.numel(), dtype=np.float32)).to(dev)
    g_nb = torch.from_numpy(
        rng.standard_normal(negs_flat.numel(), dtype=np.float32)).to(dev)
    segs = (flat, negs_flat)
    got, counts = mean_scatter(tables[1].clone(), segs, (g_rows, g_negs), 0.025)
    want, want_counts = mean_scatter_plain(
        tables[1].clone(), segs, (g_rows, g_negs), 0.025)
    k4_err = check_close("K4 table", got, want, 0.0, 1e-5)
    check_close("K4 counts", counts, want_counts, 0.0, 0.0)
    got_b, _ = mean_scatter(bias.clone(), segs, (g_b, g_nb), 0.025, counts)
    want_b, _ = mean_scatter_plain(bias.clone(), segs, (g_b, g_nb), 0.025, counts)
    k4_err = max(k4_err, check_close("K4 bias", got_b, want_b, 0.0, 1e-5))
    del got, want, got_b, want_b
    kernels["mean_scatter"] = dict(
        source="embiggen_tpu_torch/csrc/scatter.cu",
        replaces="embiggen_tpu/models/embedders/walk_based.py:817",
        max_abs_err=k4_err,
        ms=time_ms(lambda: mean_scatter(
            tables[1], segs, (g_rows, g_negs), 0.025), 10),
        plain_ms=time_ms(lambda: mean_scatter_plain(
            tables[1], segs, (g_rows, g_negs), 0.025), 10),
    )
    del tables, bias, walks, negs, flat, negs_flat, g_rows, g_negs, g_b, g_nb
    del segs, counts, want_counts
    torch.cuda.empty_cache()
    print(f"phase 3 kernels vs plain on {card} ({time.perf_counter() - t_phase:.1f} s; "
          f"ms per call, at the slice shapes; graph build {graph_s:.1f} s): " + "; ".join(
              f"{k} err {v['max_abs_err']:.3g} ms {v['ms']:.3f} plain "
              f"{v['plain_ms']:.3f}" for k, v in kernels.items())
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
              f"{k} err {v['max_abs_err']:.3g} ms {v['ms']:.4f} plain "
              f"{v['plain_ms']:.4f}" for k, v in new.items())
          + f" | K7 backward ms {new['spmm']['backward_ms']:.4f} plain "
          f"{new['spmm']['backward_plain_ms']:.4f}, CSR layout "
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

    # -------------------------------------------------- 11. profile (option)
    if args.profile:
        print_profile("S1", card, *profile(skipgram_step(model, graph), PROFILE_STEPS))
        print_profile("GCN", card, *profile(gcn_step(gcn, graph), PROFILE_STEPS))

    launches = {**path_launches, **gcn_launches, **perceptron_launches,
                **{"edge_metrics": k8_launches["edge_metrics"]}, **probe_launches}
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
