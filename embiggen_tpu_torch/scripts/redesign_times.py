"""Times of the kernels redesigned for Hopper at the slice shapes, and of the
steps and fits that run them, on one NVIDIA GPU; one JSON line.

    python embiggen_tpu_torch/scripts/redesign_times.py [--parts k13a k4 line k12 walklets k15a spine
                                                         k18 nodesketch k16b gcn_hll k13b glove
                                                         k14]

It imports whichever `embiggen_tpu_torch` comes first on the path, and calls
only the kernels' wrappers and the models' steps and fits, whose signatures
every design of these kernels shares, so one command can time two checkouts
in turn: `PYTHONPATH=<checkout> python <this file>` times that checkout's
package. Each kernel runs on `erdos_renyi(1M nodes, 10M edges, seed=0)`:

- K13a on one walk of 16 from every node (K1, seed 0) at GloVe's window 2
  (strides 1 and 2 at weights 1 and 1/2) and at one Walklets stride (1, at
  weight 1): the build's mean time over 5 calls on CUDA events, each of its
  launches' mean time (`_build.timed_launches`), and the library calls on
  the emitted keys: `torch.unique(return_counts=True)` (the same function
  for the weight-1 build only) and `torch.unique(return_inverse=True)`
  followed by `index_add_` of the weights (the same function for both).
  Then the same at window 2 on two skewed builds, whose hubs (segments
  longer than a block's shared memory) take their own route: walks of the
  slice graph with 256 planted hubs of 4,096-65,536 neighbours, and a
  star's walks (1M leaves, one walk of 16 from each, the hub at every
  other position), with the hubs' count and share of the entries and the
  device time of the hub route's kernels from torch.profiler;
- K4 standalone on one LINE batch (K14: B 65536, K 5) with seeded normal
  gradients at D 128 on a workspace: the context update (segments dst and
  negatives) and the node update (src), each as the wrapper's mean time and
  its scatter and combine launches' (events around each launch);
- Second- and First-order LINE and TransE (D 128, batch 65536; TransE's
  edge types arange(E) % 8): the mean step time over 30 steady steps on
  CUDA events, K4 standalone's launches' share of 10 of them, and the
  seconds of one epoch through `fit_transform`;
- K12 at the S7 Walklets shapes (P 4, sub 32, B 32768, L 64, K 10) on
  seeded tables, walks and negatives: its mean time over 10 calls in each
  mode; and the Walklets SkipGram and CBOW steps at those settings (D 128):
  the mean step time over 20 steady steps on CUDA events and K12's launch
  time in 10 of them;
- K15a at SPINE's D 100 (the 100 highest-degree nodes as anchors) on the
  distances after three relaxations, with the change flag the fit passes:
  one relaxation's mean time over 20 calls, unweighted and on the weighted
  twin (`erdos_renyi(..., weighted=True)`); and a Degree-based SPINE fit
  and a WeightedSPINE fit at their defaults (D 100, depth 32): seconds
  through `fit_transform`, K15a's launches and their summed time on CUDA
  events, best of 3 fits, and beside them the seconds of each part of
  the fit, run alone;
- K18 at NodeSketch's D 100 and decay 0.01 (Exp(1) races and noise,
  sketch ids arange(N)): one round's mean time over 10 calls of
  `sketch_race_step` into preallocated outputs, on the slice graph, on
  exact ties (races on a grid of four values, noise on a grid of two, at
  decay 0.5) and on the slice graph with 256 planted hubs; and a
  NodeSketch fit at its defaults through `fit_transform`: seconds, K18's
  launches and their summed time on CUDA events, best of 3;
- K16b at 2^20 pairs (half arcs, half uniform pairs) over HyperSketching's
  three hops: the mean time over 20 calls at precision 8, then 4 and 12;
  and the S3 GCN step (batch 2^20, seeded node features of width 128) with
  lazy HyperSketching features at its defaults: the mean step time over
  20 steady steps on CUDA events and K16b's launch time in 10 of them;
- K13b on the S7 GloVe build's entries (a walk of 16 from every node, window
  2) at B 65536, D 128, on seeded tables: the step's update, the mean over
  20 calls on CUDA events (a checkout whose K13b returns gradients: K13b,
  then the step's four `index_add_`s and its loss division; else K13b's
  launches on a workspace), and each launch's time;
- Node2Vec GloVe at the S7 settings (D 128, batch 65536, L 16, w 2): the mean
  `_step` time over 30 steady steps on injected ids, on CUDA events, and
  with its own draws (K2), the port's launches a step, and the seconds of
  one epoch through `fit_transform`;
- K14 at the S6 shapes (B 65536, K 5, scale-free; the siamese batch with
  edge types arange(E) % 8), fresh and on a workspace where the checkout has
  one: the mean time a call over 200 calls on CUDA events, the kernel's
  device time from torch.profiler, the wrapper's host time a call
  (`time.perf_counter` over 500 calls), and the host time of each part of
  the wrapper alone: an output's `torch.empty`, `_build.draw_seed`, the
  device context with the stream lookup, the ctypes call (which launches the
  kernel) and `_build.launch` whole.

Every number is the card's; the line carries the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import subprocess
import time

import numpy as np
import torch

N_NODES, N_EDGES = 1_000_000, 10_000_000
DIM, LINE_BATCH, LINE_NEGS, GLOVE_WALK = 128, 65536, 5, 16
# At least 0.2 s of the card's clock (under 2 GHz): longer than the host
# takes to enqueue the calls `queued_ms` times.
SLEEP_CYCLES = 400_000_000


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card's clock, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def kernel_table(fn, reps: int = 10) -> dict:
    """{kernel name (its first 60 characters): [device ms per call,
    launches per call]} of every kernel in `reps` calls of `fn`, from
    torch.profiler (which may drop records)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = out.setdefault(e.name[:60], [0.0, 0.0])
            row[0] += e.time_range.elapsed_us() / 1e3 / reps
            row[1] += 1 / reps
    return out


def launch_ms(fn, reps: int) -> dict:
    """{counter: mean ms per call of `fn`} of the port's launches in it,
    each on the CUDA event pair around it, and the list of each launch's
    mean in call order."""
    from embiggen_tpu_torch.ops import _build

    fn()
    torch.cuda.synchronize()
    with _build.timed_launches() as events:
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    out = {}
    for counter, pairs in events.items():
        times = [s.elapsed_time(e) for s, e in pairs]
        per = len(times) // reps
        out[counter] = sum(times) / reps
        out[counter + "_each"] = [sum(times[i::per]) / reps for i in range(per)]
    return out


def planted_hubs(graph, n_hubs: int = 256):
    """`graph` plus `n_hubs` new nodes, each joined to 4,096-65,536 random
    nodes (hubs included): chip_smoke.py's hub graph."""
    from embiggen_tpu_torch.graph import Graph

    rng = np.random.default_rng(27)
    n = graph.number_of_nodes
    sizes = rng.integers(4096, 65536, n_hubs, endpoint=True)
    hubs = np.repeat(np.arange(n, n + n_hubs), sizes)
    one = graph.sources < graph.col_idx
    return Graph.from_edge_arrays(
        np.concatenate([graph.sources[one], hubs]),
        np.concatenate([graph.col_idx[one], rng.integers(0, n + n_hubs, len(hubs))]),
        n_nodes=n + n_hubs, directed=False, name="ER+hubs")


def star_walks(leaves: int, length: int, dev) -> torch.Tensor:
    """One walk of `length` from every leaf of a star: the hub (node 0) at
    every other position, uniform leaves between."""
    gen = torch.Generator(device=dev).manual_seed(5)
    walks = torch.randint(1, leaves + 1, (leaves, length), generator=gen, device=dev,
                          dtype=torch.int32)
    walks[: leaves // 2, ::2] = 0
    walks[leaves // 2:, 1::2] = 0
    return walks


def hub_stats(walks, n: int, strides, block_segment: int = 8192) -> dict:
    """The centers whose segment is longer than a block's shared memory
    (hubs), and their share of the entries."""
    seg = torch.zeros(n, dtype=torch.int64, device=walks.device)
    for d, _ in strides:
        a, b = walks[:, :-d].reshape(-1).long(), walks[:, d:].reshape(-1).long()
        keep = a != b
        for x in (a[keep], b[keep]):
            seg += torch.bincount(x, minlength=n)
    hubs = seg > block_segment
    return dict(hubs=int(hubs.sum()), hub_entries=int(seg[hubs].sum()),
                entries_emitted=int(seg.sum()), largest_segment=int(seg.max()))


def hub_route_ms(build, reps: int = 3) -> dict:
    """Device ms per build of K13a's hub kernels and of all its kernels,
    from torch.profiler's records of `reps` builds."""
    from torch.profiler import ProfilerActivity, profile

    build()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            build()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and "cooc_" in e.name]
    us = lambda pick: sum(e.time_range.elapsed_us() for e in events if pick(e.name))  # noqa
    return dict(hub_kernels_ms=us(lambda name: "cooc_hub" in name) / 1e3 / reps,
                cooc_kernels_ms=us(lambda name: True) / 1e3 / reps,
                profiler_events=len(events))


def k13a_build_times(walks, n: int, strides, dev, skewed: bool) -> dict:
    from embiggen_tpu_torch.ops.glove import cooccurrences

    keys, weights = [], []
    for d, w in strides:
        a, b = walks[:, :-d].reshape(-1).long(), walks[:, d:].reshape(-1).long()
        keys += [a * n + b, b * n + a]
        weights.append(torch.full((2 * a.numel(),), w, dtype=torch.float64, device=dev))
    keys, weights = torch.cat(keys), torch.cat(weights)

    def unique_sums():
        uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
        torch.zeros(uniq.numel(), dtype=torch.float64, device=dev).index_add_(
            0, inverse, weights)

    def build():
        cooccurrences(walks, n, strides)
    ci, _, _ = cooccurrences(walks, n, strides)
    out = dict(
        emitted_keys=int(keys.numel()), entries=int(ci.numel()), ms=time_ms(build, 5),
        launches=launch_ms(build, 5),
        unique_counts_ms=time_ms(lambda: torch.unique(keys, sorted=True, return_counts=True), 3),
        unique_index_add_ms=time_ms(unique_sums, 3))
    if skewed:
        out.update(hub_stats(walks, n, strides), **hub_route_ms(build))
    del keys, weights, ci
    torch.cuda.empty_cache()
    return out


def k13a_times(graph, dev) -> dict:
    """K13a on the slice graph's walks at GloVe's window 2 and at one
    Walklets stride, and on two skewed builds at window 2: the slice graph
    with planted hubs, and a star of 1M leaves."""
    from embiggen_tpu_torch.ops.glove import glove_strides
    from embiggen_tpu_torch.ops.walks import first_order_walks

    def walks_of(g):
        return first_order_walks(
            g.device(dev), torch.arange(g.number_of_nodes, dtype=torch.int32, device=dev),
            GLOVE_WALK, torch.Generator().manual_seed(0))
    walks, w2 = walks_of(graph), glove_strides(2)
    out = {name: k13a_build_times(walks, N_NODES, strides, dev, False)
           for name, strides in (("glove_w2", w2), ("walklets_stride1", ((1, 1.0),)))}
    del walks
    hubbed = planted_hubs(graph)
    walks = walks_of(hubbed)
    out["planted_hubs_w2"] = k13a_build_times(walks, hubbed.number_of_nodes, w2, dev, True)
    del walks
    out["star_w2"] = k13a_build_times(star_walks(N_NODES, GLOVE_WALK, dev), N_NODES + 1, w2,
                                      dev, True)
    return out


def k4_times(graph, dev) -> dict:
    from embiggen_tpu_torch.ops import scatter
    from embiggen_tpu_torch.ops.negatives import line_mini_batch

    tg = graph.device(dev, with_sources=True)
    src, dst, neg = line_mini_batch(tg, torch.Generator().manual_seed(42), LINE_BATCH,
                                    LINE_NEGS)
    rng = np.random.default_rng(41)

    def normal(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).to(dev)
    table = normal(N_NODES, DIM, scale=0.1)
    workspace = scatter.MeanScatterSums.zeros((N_NODES, DIM), dev)
    out = {}
    for name, segs in (("context", (dst, neg.reshape(-1))), ("node", (src,))):
        gsegs = tuple(normal(s.numel(), DIM) for s in segs)

        def call():
            scatter.mean_scatter(table, segs, gsegs, 1e-6, workspace=workspace)
        out[name] = dict(rows=int(sum(s.numel() for s in segs)),
                         touched_rows=int(torch.unique(torch.cat(segs)).numel()),
                         wrapper_ms=time_ms(call, 20), launches=launch_ms(call, 20))
    return out


def typed_graph(graph, n_types: int = 8):
    """`graph` with edge types arange(E) % n_types, as bench.py types it."""
    return dataclasses.replace(graph, edge_types=(
        np.arange(graph.number_of_directed_edges) % n_types).astype(np.int32))


def line_times(graph, dev) -> dict:
    from embiggen_tpu_torch.models.embedders import FirstOrderLINE, SecondOrderLINE, TransE
    from embiggen_tpu_torch.ops import _build

    out = {}
    for cls, g in ((SecondOrderLINE, graph), (FirstOrderLINE, graph),
                   (TransE, typed_graph(graph))):
        model = cls(device=dev, embedding_size=DIM, batch_size=LINE_BATCH, epochs=1,
                    random_state=0)
        model._run_batch_size = LINE_BATCH
        tg = model._prepare_data(g)
        gen = torch.Generator().manual_seed(0)
        params = model._init_params(g, gen)

        def step():
            with torch.no_grad():
                model._step(tg, params, gen, 0.025)
        for _ in range(5):
            step()
        step_ms = time_ms(step, 30)
        kernels = launch_ms(step, 10)
        k4 = kernels.get("mean_scatter", 0.0) + kernels.get("mean_combine", 0.0)
        del params, tg
        model._mean_sums.clear()
        torch.cuda.empty_cache()
        fit = cls(device=dev, embedding_size=DIM, batch_size=LINE_BATCH, epochs=1,
                  random_state=0, early_stopping_patience=10**6)
        t0 = time.perf_counter()
        fit.fit_transform(g)
        out[cls.model_name()] = dict(
            step_ms=step_ms, k4_ms_per_step=k4,
            kernels_ms_per_step={k: v for k, v in kernels.items() if not k.endswith("_each")},
            epoch_s=fit._epoch_seconds[0], fit_s=time.perf_counter() - t0,
            steps_per_epoch=fit._steps_per_epoch(g, None, LINE_BATCH))
        _build.reset_launch_counts()
    return out


WALKLETS = dict(embedding_size=DIM, power=4, batch_size=32768, walk_length=64, window_size=4,
                number_of_negative_samples=10)
SPINE_DIM = 100


def k12_times(graph, dev) -> dict:
    from embiggen_tpu_torch.ops.scatter import SkipGramSums
    from embiggen_tpu_torch.ops.walklets import walklets_update

    p, b, length, k = WALKLETS["power"], WALKLETS["batch_size"], WALKLETS["walk_length"], \
        WALKLETS["number_of_negative_samples"]
    sub = DIM // p
    rng = np.random.default_rng(404)

    def put(a):
        return torch.from_numpy(a).to(dev)
    tables = (put(0.3 * rng.standard_normal((p, N_NODES, sub), dtype=np.float32)),
              put(0.3 * rng.standard_normal((p, N_NODES, sub), dtype=np.float32)),
              put(rng.standard_normal((p, N_NODES), dtype=np.float32)))
    walks = put(rng.integers(0, N_NODES, (b, length), dtype=np.int32))
    negs = put(rng.integers(0, N_NODES, (b, k), dtype=np.int32))
    sums = SkipGramSums.zeros(p * N_NODES, sub, dev)
    out = {mode: time_ms(lambda mode=mode: walklets_update(*tables, walks, negs, p, sums, mode),
                         10) for mode in ("skipgram", "cbow")}
    del tables, walks, negs, sums
    torch.cuda.empty_cache()
    return out


def walklets_times(graph, dev) -> dict:
    from embiggen_tpu_torch.models.embedders import WalkletsCBOW, WalkletsSkipGram

    out = {}
    for cls in (WalkletsSkipGram, WalkletsCBOW):
        model = cls(device=dev, epochs=1, random_state=0, **WALKLETS)
        model._run_batch_size = WALKLETS["batch_size"]
        tg = model._device_graph(graph)
        gen = torch.Generator().manual_seed(0)
        params = model._init_params(graph, gen)
        sums = model._new_sums(params)

        def step():
            with torch.no_grad():
                model._step(tg, params, gen, 0.025, sums=sums)
        for _ in range(3):
            step()
        out[cls.model_name()] = dict(step_ms=time_ms(step, 20),
                                     k12_ms_per_step=launch_ms(step, 10)["walklets_update"])
        del params, sums, tg
        torch.cuda.empty_cache()
    return out


def k15a_times(graph, dev) -> dict:
    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.ops.bfs import (
        anchor_init_from_sets, min_plus_step, multi_source_distances,
    )

    order = np.argsort(-graph.degrees, kind="stable")[:SPINE_DIM]
    init = anchor_init_from_sets(N_NODES, [[v] for v in order], dev)
    out = {}
    for name, g, weighted in (("unweighted", graph, False),
                              ("weighted", erdos_renyi(N_NODES, N_EDGES, seed=0, weighted=True),
                               True)):
        tg = g.device(dev)
        dist = multi_source_distances(tg, init, 3, weighted)
        buf = torch.empty_like(dist)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        out[name] = time_ms(lambda: min_plus_step(tg, dist, weighted, flag, buf), 20)
        del tg, dist, buf
        torch.cuda.empty_cache()
    return out


def spine_fit_parts(cls, g, dev) -> dict:
    """Seconds of each part of a SPINE fit's `fit_transform`, run one after
    another as the fit runs them, each ending in a synchronize."""
    from embiggen_tpu_torch.models.embedders import spine
    from embiggen_tpu_torch.ops.bfs import UNREACHED, anchor_init_from_sets, multi_source_distances

    model = cls(device=dev, embedding_size=SPINE_DIM)
    parts, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
    model._validate_graph(g)
    lap("validate")
    sets = model._anchor_sets(g)
    lap("anchor_sets")
    init = anchor_init_from_sets(g.number_of_nodes, sets, dev)
    lap("anchor_init")
    tg = g.device(dev)
    lap("graph_export")
    dist = multi_source_distances(tg, init, 32, cls.WEIGHTED)
    lap("relaxations")
    spine._clamp_to_dtype(torch.where(dist >= UNREACHED, 33.0, dist), "u8")
    lap("result_to_host")
    g.get_node_names()
    lap("node_names")
    return parts


def spine_times(graph, dev) -> dict:
    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.models.embedders import DegreeSPINE, WeightedSPINE
    from embiggen_tpu_torch.ops import _build

    out = {}
    for cls, g in ((DegreeSPINE, graph),
                   (WeightedSPINE, erdos_renyi(N_NODES, N_EDGES, seed=0, weighted=True))):
        fits = []
        for _ in range(3):
            _build.reset_launch_counts()
            torch.cuda.synchronize()
            with _build.timed_launches() as events:
                t0 = time.perf_counter()
                cls(device=dev, embedding_size=SPINE_DIM).fit_transform(g)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            fits.append(dict(fit_s=secs, launches=_build.launch_counts()["min_plus_step"],
                             k15a_ms=sum(s.elapsed_time(e)
                                         for s, e in events.get("min_plus_step", []))))
        out[cls.model_name()] = dict(min(fits, key=lambda f: f["fit_s"]),
                                     parts_s=spine_fit_parts(cls, g, dev))
        torch.cuda.empty_cache()
    return out


NODESKETCH_DIM, NODESKETCH_DECAY = 100, 0.01
K16B_PAIRS, HLL_HOPS, GCN_BATCH = 1 << 20, 3, 1 << 20


def k18_times(graph, dev) -> dict:
    from embiggen_tpu_torch.ops.nodesketch import inverse_decay, sketch_race_step

    gen = torch.Generator(device=dev).manual_seed(5)

    def exp(n):
        return torch.empty((n, NODESKETCH_DIM), device=dev).exponential_(generator=gen)

    def grid(n, values):
        v = torch.tensor(values, device=dev)
        return v[torch.randint(0, len(values), (n, NODESKETCH_DIM), generator=gen, device=dev)]

    out = {}
    hubbed = planted_hubs(graph)
    for name, g, draw, decay in (
        ("slice", graph, exp, NODESKETCH_DECAY),
        ("exact_ties", graph, None, 0.5),
        ("planted_hubs", hubbed, exp, NODESKETCH_DECAY),
    ):
        n = g.number_of_nodes
        tg = g.device(dev)
        sketch = torch.arange(n, dtype=torch.int32, device=dev)[:, None].repeat(
            1, NODESKETCH_DIM)
        if draw is None:
            race, noise = grid(n, [0.0, 0.25, 0.5, 1.0]), grid(n, [0.0, 0.5])
        else:
            race, noise = draw(n), draw(n)
        bufs = (torch.empty_like(race), torch.empty_like(sketch))
        inv = inverse_decay(decay)
        out[name] = time_ms(lambda: sketch_race_step(tg, race, sketch, noise, inv, bufs), 10)
        del tg, race, noise, sketch, bufs
        torch.cuda.empty_cache()
    return out


def nodesketch_times(graph, dev) -> dict:
    from embiggen_tpu_torch.models.embedders import NodeSketch
    from embiggen_tpu_torch.ops import _build

    # A checkout from before K18's candidate pass counts one launch a round.
    counters = [c for c in ("sketch_candidates", "sketch_race_step") if c in _build.LAUNCHES]
    fits = []
    for _ in range(3):
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        with _build.timed_launches() as events:
            t0 = time.perf_counter()
            NodeSketch(device=dev).fit_transform(graph)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        counts = _build.launch_counts()
        fits.append(dict(fit_s=secs, launches={c: counts[c] for c in counters},
                         k18_ms=sum(s.elapsed_time(e) for c in counters
                                    for s, e in events.get(c, []))))
        torch.cuda.empty_cache()
    return min(fits, key=lambda f: f["fit_s"])


def sketch_pairs(graph, dev):
    rng = np.random.default_rng(31)
    arcs = rng.integers(0, graph.number_of_directed_edges, K16B_PAIRS // 2)
    src = np.concatenate([graph.sources[arcs], rng.integers(0, N_NODES, K16B_PAIRS // 2)])
    dst = np.concatenate([graph.col_idx[arcs], rng.integers(0, N_NODES, K16B_PAIRS // 2)])
    return (torch.from_numpy(src.astype(np.int32)).to(dev),
            torch.from_numpy(dst.astype(np.int32)).to(dev))


def k16b_times(graph, dev) -> dict:
    from embiggen_tpu_torch.ops.hll import edge_sketch_features, khop_sketches, singleton_registers

    tg = graph.device(dev)
    src, dst = sketch_pairs(graph, dev)
    out = {}
    for p in (8, 4, 12):
        sk = khop_sketches(tg, singleton_registers(N_NODES, p, 6, 42, dev), HLL_HOPS)
        out[f"precision_{p}"] = time_ms(lambda: edge_sketch_features(sk, src, dst, p), 20)
        del sk
        torch.cuda.empty_cache()
    return out


def gcn_hll_times(graph, dev) -> dict:
    from embiggen_tpu_torch.models.edge_features import HyperSketching
    from embiggen_tpu_torch.models.gcn import GCNEdgePrediction
    from embiggen_tpu_torch.models.gcn.core import map_params, param_leaves

    feats = np.random.default_rng(0).standard_normal((N_NODES, DIM), dtype=np.float32)
    model = GCNEdgePrediction(epochs=1, batch_size=GCN_BATCH, dropout_rate=0.0,
                              early_stopping_patience=10**6, random_state=0, device=dev,
                              edge_feature_models=[HyperSketching(device=dev)])
    model.fit(graph, node_features=feats)
    params = map_params(lambda t: t.clone().requires_grad_(True), model._params)
    optimizer = torch.optim.Adam(param_leaves(params), lr=model._learning_rate)
    tg = graph.device(dev, with_sources=True)
    gen = torch.Generator().manual_seed(1)

    def step():
        optimizer.zero_grad(set_to_none=True)
        model._loss(params, model._csr_kernels, tg, None, gen, None).backward()
        optimizer.step()
    for _ in range(3):
        step()
    out = dict(step_ms=time_ms(step, 20),
               k16b_ms_per_step=launch_ms(step, 10)["edge_sketch_features"])
    del model, params, optimizer, tg
    torch.cuda.empty_cache()
    return out


GLOVE = dict(embedding_size=DIM, batch_size=65536, walk_length=GLOVE_WALK, window_size=2,
             iterations=1, early_stopping_patience=10**6)
GLOVE_TABLES = ("node_embedding", "context_embedding", "center_bias", "context_bias")


def glove_setup(graph, dev):
    """Node2Vec GloVe at the S7 settings: the model, its entries on `graph`
    and its seeded initial tables."""
    from embiggen_tpu_torch.models.embedders import GloVe

    model = GloVe(device=dev, epochs=1, random_state=0, **GLOVE)
    entries = model._prepare_data(graph)
    model._run_batch_size = model._resolve_batch_size(graph, entries)
    params = model._init_params(graph, torch.Generator().manual_seed(0))
    return model, entries, params


def k13b_times(graph, dev) -> dict:
    from embiggen_tpu_torch.ops import glove as ops

    model, entries, params = glove_setup(graph, dev)
    b, lr = model._run_batch_size, 1e-4
    ids = torch.from_numpy(np.random.default_rng(13).integers(
        0, entries.n_entries, b, dtype=np.int32)).to(dev)
    tables = [params[k] for k in GLOVE_TABLES]
    in_place = "lr" in inspect.signature(ops.glove_step).parameters
    if in_place:
        ws = ops.GloVeStepWorkspace.empty(b, DIM, dev)

        def update():
            ops.glove_step(entries, ids, *tables, lr, ws) / b
    else:
        def update():
            i, j, gw, gc, g, loss = ops.glove_step(entries, ids, *tables)
            for t, rows, grad in zip(tables, (i, j, i, j), (gw, gc, g, g)):
                t.index_add_(0, rows, grad, alpha=-lr)
            loss / b
    out = dict(batch=b, entries=entries.n_entries, in_place=in_place, ms=time_ms(update, 20),
               device_ms=queued_ms(update, 20), kernels=kernel_table(update))
    del model, entries, params, tables
    torch.cuda.empty_cache()
    return out


def glove_times(graph, dev) -> dict:
    from embiggen_tpu_torch.models.embedders import GloVe
    from embiggen_tpu_torch.ops import _build

    model, entries, params = glove_setup(graph, dev)
    b = model._run_batch_size
    gen = torch.Generator().manual_seed(0)
    cuda_gen = torch.Generator(device=dev).manual_seed(1)
    ids = [torch.randint(0, entries.n_entries, (b,), generator=cuda_gen, device=dev,
                         dtype=torch.int32) for _ in range(8)]
    calls = iter(range(10**9))

    def injected():
        with torch.no_grad():
            model._step(entries, params, gen, 0.05,
                        batch=((ids[next(calls) % len(ids)],), entries))

    def drawn():
        with torch.no_grad():
            model._step(entries, params, gen, 0.05)
    for _ in range(3):
        injected()
    out = dict(step_ms=time_ms(injected, 30), step_device_ms=queued_ms(injected, 30),
               kernels=kernel_table(injected), step_with_draw_ms=time_ms(drawn, 30),
               step_with_draw_device_ms=queued_ms(drawn, 30))
    _build.reset_launch_counts()
    drawn()
    torch.cuda.synchronize()
    out["port_launches_per_step"] = {k: v for k, v in _build.launch_counts().items() if v}
    del model, entries, params, ids
    torch.cuda.empty_cache()
    fit = GloVe(device=dev, epochs=1, random_state=0, **GLOVE)
    t0 = time.perf_counter()
    fit.fit_transform(graph)
    out.update(epoch_s=fit._epoch_seconds[0], fit_s=time.perf_counter() - t0,
               steps_per_epoch=fit._steps_per_epoch(graph, None, fit._run_batch_size))
    del fit
    torch.cuda.empty_cache()
    return out


def host_us(fn, reps: int) -> float:
    """Mean host microseconds a call of `fn` (what it enqueues is not
    waited for, but the card keeps up with these calls)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e6


def k14_times(graph, dev) -> dict:
    from embiggen_tpu_torch.ops import _build, negatives

    tg = graph.device(dev, with_sources=True)
    typed = dataclasses.replace(
        tg, edge_types=(torch.arange(tg.n_arcs, device=dev) % 8).int())
    b, k = LINE_BATCH, LINE_NEGS
    gen = torch.Generator().manual_seed(55)
    calls = {"line": (lambda: negatives.line_mini_batch(tg, gen, b, k), "line_batch_kernel"),
             "siamese": (lambda: negatives.siamese_mini_batch(typed, gen, b, True, True),
                         "siamese_batch_kernel")}
    if "workspace" in inspect.signature(negatives.line_mini_batch).parameters:
        line_ws = negatives.BatchDraws.line(b, k, dev)
        siamese_ws = negatives.BatchDraws.siamese(b, True, dev)
        calls["line_workspace"] = (
            lambda: negatives.line_mini_batch(tg, gen, b, k, workspace=line_ws),
            "line_batch_kernel")
        calls["siamese_workspace"] = (
            lambda: negatives.siamese_mini_batch(typed, gen, b, True, True,
                                                 workspace=siamese_ws),
            "siamese_batch_kernel")
    out = {}
    for name, (fn, kernel) in calls.items():
        device_ms, per_call = next(v for k, v in kernel_table(fn, 20).items() if kernel in k)
        out[name] = dict(events_ms=time_ms(fn, 200), queued_ms=queued_ms(fn, 200),
                         device_ms=device_ms, profiler_records_per_call=per_call,
                         host_us=host_us(fn, 500))
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    src, dst, neg = (torch.empty((b,), dtype=torch.int32, device=dev),
                     torch.empty((b,), dtype=torch.int32, device=dev),
                     torch.empty((b, k), dtype=torch.int32, device=dev))
    args = (tg.row_ptr.data_ptr(), tg.col_idx.data_ptr(), tg.sources.data_ptr(), tg.n_nodes,
            tg.n_arcs, b, k, 1, 0, src.data_ptr(), dst.data_ptr(), neg.data_ptr(), 7, 0)

    def device_and_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream
    out["line_parts_us"] = dict(
        empty=host_us(lambda: torch.empty((b,), dtype=torch.int32, device=dev), 1000),
        draw_seed=host_us(lambda: _build.draw_seed(gen), 1000),
        device_and_stream=host_us(device_and_stream, 1000),
        ctypes_call=host_us(lambda: lib.ebt_line_batch(*args, stream), 500),
        launch=host_us(lambda: _build.launch(None, "ebt_line_batch", dev, *args), 500))
    return out


PARTS = ("k13a", "k4", "line", "k12", "walklets", "k15a", "spine", "k18", "nodesketch", "k16b",
         "gcn_hll", "k13b", "glove", "k14")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS),
                        help="what to time (all by default)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import embiggen_tpu_torch
    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    graph = erdos_renyi(N_NODES, N_EDGES, seed=0)
    timers = dict(k13a=k13a_times, k4=k4_times, line=line_times, k12=k12_times,
                  walklets=walklets_times, k15a=k15a_times, spine=spine_times, k18=k18_times,
                  nodesketch=nodesketch_times, k16b=k16b_times, gcn_hll=gcn_hll_times,
                  k13b=k13b_times, glove=glove_times, k14=k14_times)
    out = dict(card=smi.strip().splitlines()[0], package=embiggen_tpu_torch.__file__,
               **{part: timers[part](graph, dev) for part in args.parts})
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
