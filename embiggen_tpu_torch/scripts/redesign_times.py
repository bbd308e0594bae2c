"""Times of K13a (the GloVe co-occurrence build) and K4 standalone (LINE's
per-row mean update) at the slice shapes, and of the LINE steps that run
K4 standalone, on one NVIDIA GPU; one JSON line.

    python embiggen_tpu_torch/scripts/redesign_times.py [--parts k13a k4 line]

It imports whichever `embiggen_tpu_torch` comes first on the path, and calls
only what every design of the two kernels takes (a workspace for
`mean_scatter` where it accepts one), so one command can time two checkouts
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
  gradients at D 128: the context update (segments dst and negatives) and
  the node update (src), each as the wrapper's mean time and its scatter and
  combine launches' (events around each launch);
- Second- and First-order LINE (D 128, batch 65536): the mean step time
  over 30 steady steps on CUDA events, K4 standalone's launches' share of
  10 of them, and the seconds of one epoch through `fit_transform`.

Every number is the card's; the line carries the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import time

import numpy as np
import torch

N_NODES, N_EDGES = 1_000_000, 10_000_000
DIM, LINE_BATCH, LINE_NEGS, GLOVE_WALK = 128, 65536, 5, 16


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
    kw = {}
    if "workspace" in inspect.signature(scatter.mean_scatter).parameters:
        kw["workspace"] = scatter.MeanScatterSums.zeros((N_NODES, DIM), dev)
    out = {"workspace": bool(kw)}
    for name, segs in (("context", (dst, neg.reshape(-1))), ("node", (src,))):
        gsegs = tuple(normal(s.numel(), DIM) for s in segs)

        def call():
            scatter.mean_scatter(table, segs, gsegs, 1e-6, **kw)
        out[name] = dict(rows=int(sum(s.numel() for s in segs)),
                         touched_rows=int(torch.unique(torch.cat(segs)).numel()),
                         wrapper_ms=time_ms(call, 20), launches=launch_ms(call, 20))
    return out


def line_times(graph, dev) -> dict:
    from embiggen_tpu_torch.models.embedders import FirstOrderLINE, SecondOrderLINE
    from embiggen_tpu_torch.ops import _build

    out = {}
    for cls in (SecondOrderLINE, FirstOrderLINE):
        model = cls(device=dev, embedding_size=DIM, batch_size=LINE_BATCH, epochs=1,
                    random_state=0)
        model._run_batch_size = LINE_BATCH
        tg = model._prepare_data(graph)
        gen = torch.Generator().manual_seed(0)
        params = model._init_params(graph, gen)

        def step():
            with torch.no_grad():
                model._step(tg, params, gen, 0.025)
        for _ in range(5):
            step()
        step_ms = time_ms(step, 30)
        kernels = launch_ms(step, 10)
        k4 = kernels.get("mean_scatter", 0.0) + kernels.get("mean_combine", 0.0)
        del params, tg
        getattr(model, "_mean_sums", {}).clear()
        torch.cuda.empty_cache()
        fit = cls(device=dev, embedding_size=DIM, batch_size=LINE_BATCH, epochs=1,
                  random_state=0, early_stopping_patience=10**6)
        t0 = time.perf_counter()
        fit.fit_transform(graph)
        out[cls.model_name()] = dict(
            step_ms=step_ms, k4_ms_per_step=k4,
            kernels_ms_per_step={k: v for k, v in kernels.items() if not k.endswith("_each")},
            epoch_s=fit._epoch_seconds[0], fit_s=time.perf_counter() - t0,
            steps_per_epoch=fit._steps_per_epoch(graph, None, LINE_BATCH))
        _build.reset_launch_counts()
    return out


PARTS = ("k13a", "k4", "line")


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
    timers = dict(k13a=k13a_times, k4=k4_times, line=line_times)
    out = dict(card=smi.strip().splitlines()[0], package=embiggen_tpu_torch.__file__,
               **{part: timers[part](graph, dev) for part in args.parts})
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
