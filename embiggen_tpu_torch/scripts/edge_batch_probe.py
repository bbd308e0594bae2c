"""Designs of K5 and K6 timed side by side on one NVIDIA GPU, with the card's
rate of random gathers and the fetch floors it gives them; one JSON line.

    python -m embiggen_tpu_torch.scripts.edge_batch_probe

Builds `edge_batch_probe.cu` (the designs, among them the group
membership search, the redraw-free "guided" search and the arc records; its
header says what each is)
with nvcc into the package's `_build/` directory and runs on
`erdos_renyi(1M nodes, 10M edges, seed=0)` and on it plus 256 planted hubs
of 4,096-65,536 neighbours (`redesign_times.planted_hubs`):

- the gather rate: 2^20 and 2^21 independent 4-byte loads (one a thread)
  from hashed places of the slice graph's col_idx (20M ids, 80 MB);
- K5 at 2^20 queries: on the slice graph half arcs and half uniform pairs
  (chip_smoke.py's), on the hub graph half arcs and half pairs of a
  scale-free source (the head of a uniform arc) and a uniform node, so hubs
  are sources at the rate scale-free draws give them;
- K6 at the GCN's 2^20 slots, scale-free, two redraws: the whole batch, its
  positives alone (rate 0), its negatives alone (rate 1) and its negatives
  without the search (rate 1, no redraw), every design at one key and
  offset.

Five timings of 20 launches a design in turns, the median of each in ms a
launch on CUDA events. Every design's output is compared with the thread
design's (K5's ids and flags, K6's batch draw for draw). The fetch floor of
a call is its random fetches from col_idx-sized arrays over the measured
rate at 2^21 loads: a K5 query at least the sector of its row that holds
the answer (none for an empty row); a K6 positive its arc's source and head
(two; one from an 8-byte record), a negative its two heads and, unless a
loop, that sector of its source's row (the redraws, under one in 10^4, left
out). The rows' bounds come from row_ptr, 4 MB, which L2 holds; they are
not counted. The line carries the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from embiggen_tpu_torch.ops import _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "edge_batch_probe.cu")
K5_DESIGNS = ("thread", "group 4x4", "group 8x4", "guided1", "guided16", "guided")
K6_DESIGNS = ("thread", "group 4x2", "group 8x4", "guided1", "guided", "mixed", "pairs",
              "arc16")
QUERIES = BATCH = 1 << 20
REPS, ROUNDS = 20, 5


def _library() -> ctypes.CDLL:
    paths = [Path(SOURCE)] + [_build.CSRC / name for name in ("edges.cu", "csr.cuh",
                                                              "philox.cuh")]
    so = _build.BUILD_DIR / f"edge_batch_probe_{_build.digest(_build.NVCC_FLAGS, paths)}.so"
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return _build.compile_shared(
        so,
        lambda tmp: subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                                    str(tmp), SOURCE], check=True, capture_output=True),
        {"probe_gather": ((p, i64, i64, ctypes.c_uint, p, p), i32),
         "probe_edge_ids": ((i32, p, p, p, p, i64, i32, i32, p, p, p), i32),
         "probe_edge_batch": ((i32, p, p, p, p, p, i32, i64, i64, i64, i32, p, p, p,
                               ctypes.c_ulonglong, ctypes.c_uint, p), i32)})


def _time_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _searched(tg, src: torch.Tensor) -> float:
    """Searches that must read their row: those of a source with arcs."""
    return float((tg.degrees[src.long()] > 0).sum())


def _queries(tg, hubs: bool, dev):
    rng = np.random.default_rng(21)
    n, n_arcs = tg.n_nodes, tg.n_arcs
    half = QUERIES // 2
    arc = torch.from_numpy(rng.integers(0, n_arcs, half)).to(dev)
    if hubs:
        other_src = tg.col_idx[torch.from_numpy(rng.integers(0, n_arcs, QUERIES - half)).to(dev)]
    else:
        other_src = torch.from_numpy(rng.integers(0, n, QUERIES - half, dtype=np.int32)).to(dev)
    other_dst = torch.from_numpy(rng.integers(0, n, QUERIES - half, dtype=np.int32)).to(dev)
    return (torch.cat([tg.sources[arc], other_src]).contiguous(),
            torch.cat([tg.col_idx[arc], other_dst]).contiguous())


def _k5(lib, tg, src, dst, stream) -> dict:
    n = src.shape[0]
    outs = {d: (torch.empty(n, dtype=torch.int32, device=src.device),
                torch.empty(n, dtype=torch.uint8, device=src.device)) for d in K5_DESIGNS}

    def launch(design):
        ids, found = outs[design]
        _check(lib.probe_edge_ids(K5_DESIGNS.index(design), tg.row_ptr.data_ptr(),
                                  tg.col_idx.data_ptr(), src.data_ptr(), dst.data_ptr(), n,
                                  tg.n_arcs, tg.n_nodes, ids.data_ptr(), found.data_ptr(),
                                  stream), design)
    for d in K5_DESIGNS:
        launch(d)
    torch.cuda.synchronize()
    equal = {d: bool(torch.equal(outs[d][0], outs["thread"][0])
                     and torch.equal(outs[d][1], outs["thread"][1])) for d in K5_DESIGNS}
    runs = {d: [] for d in K5_DESIGNS}
    for _ in range(ROUNDS):
        for d in K5_DESIGNS:
            runs[d].append(_time_ms(lambda: launch(d)))
    fetches = _searched(tg, src)
    return dict(equal_to_thread=equal, runs_ms=runs, fetches=fetches,
                median_ms={d: float(np.median(v)) for d, v in runs.items()})


def _k6(lib, tg, stream) -> dict:
    dev = tg.col_idx.device
    pairs = torch.stack([tg.sources, tg.col_idx], 1).contiguous()
    col = tg.col_idx.long()
    arcs16 = torch.stack([tg.col_idx, tg.row_ptr[:-1][col], tg.degrees[col],
                          torch.zeros_like(tg.col_idx)], 1).contiguous()
    del col
    src = torch.empty(BATCH, dtype=torch.int32, device=dev)
    dst = torch.empty_like(src)
    labels = torch.empty(BATCH, dtype=torch.float32, device=dev)
    cases = {"batch": (BATCH // 2, 2), "positives": (BATCH, 2), "negatives": (0, 2),
             "negatives_without_search": (0, 0)}
    out = {}
    for case, (n_pos, attempts) in cases.items():
        def launch(design):
            _check(lib.probe_edge_batch(
                K6_DESIGNS.index(design), tg.row_ptr.data_ptr(), tg.col_idx.data_ptr(),
                tg.sources.data_ptr(), pairs.data_ptr(), arcs16.data_ptr(), tg.n_nodes,
                tg.n_arcs, n_pos, BATCH, attempts,
                src.data_ptr(), dst.data_ptr(), labels.data_ptr(), 0x1234_5678_9ABC, 7,
                stream), design)
        batches = {}
        for d in K6_DESIGNS:
            launch(d)
            batches[d] = (src.clone(), dst.clone(), labels.clone())
        torch.cuda.synchronize()
        equal = {d: all(torch.equal(a, b) for a, b in zip(batches[d], batches["thread"]))
                 for d in K6_DESIGNS}
        runs = {d: [] for d in K6_DESIGNS}
        for _ in range(ROUNDS):
            for d in K6_DESIGNS:
                runs[d].append(_time_ms(lambda: launch(d)))
        neg = batches["thread"][0][n_pos:], batches["thread"][1][n_pos:]
        fetches = 2.0 * n_pos + (BATCH - n_pos) * 2.0
        if attempts:
            fetches += _searched(tg, neg[0][neg[0] != neg[1]])
        out[case] = dict(equal_to_thread=equal, runs_ms=runs, fetches=fetches,
                         fetches_with_pairs=fetches - n_pos,
                         median_ms={d: float(np.median(v)) for d, v in runs.items()})
        del batches
    return out


def run(dev: torch.device) -> dict:
    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.scripts.redesign_times import planted_hubs

    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    graph = erdos_renyi(1_000_000, 10_000_000, seed=0)
    tg = graph.device(dev, with_sources=True)
    gathered = torch.empty(1 << 21, dtype=torch.int32, device=dev)
    rate = {}
    for loads in (1 << 20, 1 << 21):
        runs = [_time_ms(lambda: _check(lib.probe_gather(
            tg.col_idx.data_ptr(), tg.n_arcs, loads, 99, gathered.data_ptr(), stream), "gather"))
            for _ in range(ROUNDS)]
        ms = float(np.median(runs))
        rate[str(loads)] = dict(runs_ms=runs, median_ms=ms, fetches_per_s=loads / (ms / 1e3))
    per_s = rate[str(1 << 21)]["fetches_per_s"]
    out = dict(gather=rate, array_bytes=tg.n_arcs * 4)
    for name, g in (("slice", graph), ("hub_graph", planted_hubs(graph))):
        t = tg if name == "slice" else g.device(dev, with_sources=True)
        src, dst = _queries(t, name == "hub_graph", dev)
        k5 = _k5(lib, t, src, dst, stream)
        k5["fetch_floor_ms"] = k5["fetches"] / per_s * 1e3
        k6 = _k6(lib, t, stream)
        for case in k6.values():
            case["fetch_floor_ms"] = case["fetches"] / per_s * 1e3
            case["fetch_floor_pairs_ms"] = case["fetches_with_pairs"] / per_s * 1e3
        out[name] = dict(arcs=t.n_arcs, k5=k5, k6=k6)
        del t, src, dst
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout
    print(json.dumps(dict(card=smi.strip().splitlines()[0], **run(torch.device("cuda")))),
          flush=True)


if __name__ == "__main__":
    main()
