"""Designs of K1's walk loop timed side by side on one NVIDIA GPU; one JSON
line.

    python -m embiggen_tpu_torch.scripts.walk_chain_probe

Builds `walk_chain_probe.cu` (the designs, each a kernel; its header says
what each changes) with nvcc into the package's `_build/` directory and
runs every design on `erdos_renyi(1M nodes, 10M edges, seed=0)` at the S1
shapes (32,768 walkers, walks of 64) and with 256 walkers alone (the chain
floor: too few walkers to contend for the card), 20 launches a timing, five
timings a design in turns; the median of each, in ms a launch on CUDA
events. The hoisted design also at blocks of 64, 128 and 512, the staged one
at 64; the fused batch's designs (10 negatives a walker) at blocks of 64,
beside arc16's walks alone at 64. Every design's walks are checked: each
move an arc of the graph; the batches' negatives heads of arcs. The line
carries the card's name and power limit.
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

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "walk_chain_probe.cu")
DESIGNS = ("chain", "hoisted", "ldg", "row16", "arc16", "arc8", "staged", "persist",
           "batch_burst", "batch_spread", "batch_after")
BATCH, WALK, FEW, NEGS = 32768, 64, 256, 10


def _library() -> ctypes.CDLL:
    paths = (Path(SOURCE), _build.CSRC / "philox.cuh")
    so = _build.BUILD_DIR / f"walk_chain_probe_{_build.digest(_build.NVCC_FLAGS, paths)}.so"
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return _build.compile_shared(
        so,
        lambda tmp: subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                                    str(tmp), SOURCE], check=True, capture_output=True),
        {"probe_walks": ((i32, p, p, p, p, p, i64, i32, i32, ctypes.c_ulonglong,
                          ctypes.c_uint, i64, p, i32, i64, i64, p), i32),
         "probe_persisting_l2": ((i64,), i32)})


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(dev: torch.device) -> dict:
    from embiggen_tpu_torch.graph import erdos_renyi

    lib = _library()
    tg = erdos_renyi(1_000_000, 10_000_000, seed=0).device(dev)
    col = tg.col_idx.long()
    head_base, head_deg = tg.row_ptr[:-1][col], tg.degrees[col]
    rows = {"arc16": torch.stack([tg.col_idx, head_base, head_deg, torch.zeros_like(head_deg)],
                                 1).contiguous(),
            "arc8": torch.stack([head_base, head_deg], 1).contiguous()}
    del col, head_base, head_deg
    starts = torch.randint(0, tg.n_nodes, (BATCH,), device=dev, dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(0))
    few = starts[:FEW].contiguous()
    walks = torch.empty((BATCH, WALK), dtype=torch.int32, device=dev)
    negs = torch.empty((BATCH, NEGS), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    row_ptr_bytes = tg.row_ptr.numel() * 4

    def launch(design, s, threads):
        table = rows.get("arc16" if design.startswith("batch") else design)
        err = lib.probe_walks(DESIGNS.index(design), tg.row_ptr.data_ptr(),
                              tg.col_idx.data_ptr(), None if table is None else table.data_ptr(),
                              s.data_ptr(), walks.data_ptr(), s.shape[0], WALK, threads, 12345,
                              7, row_ptr_bytes, negs.data_ptr(), NEGS, tg.n_nodes, tg.n_arcs,
                              stream)
        if err:
            raise RuntimeError(f"{design}: CUDA error {err}")

    cases = [(d, 256) for d in DESIGNS[:8]] + [("hoisted", t) for t in (64, 128, 512)] + [
        ("staged", 64), ("arc16", 64)] + [(d, 64) for d in DESIGNS[8:]]
    src = torch.repeat_interleave(torch.arange(tg.n_nodes, device=dev), tg.degrees.long())
    keys = src * tg.n_nodes + tg.col_idx.long()
    persisting = lib.probe_persisting_l2(row_ptr_bytes)
    checked = {}
    for design, threads in cases:
        launch(design, starts, threads)
        torch.cuda.synchronize()
        a, b = walks[:, :-1].reshape(-1).long(), walks[:, 1:].reshape(-1).long()
        q = a * tg.n_nodes + b
        pos = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
        ok = bool((keys[pos] == q).all())
        if design.startswith("batch"):
            ok = ok and bool((tg.degrees[negs.long()] > 0).all())
        else:
            ok = ok and bool((walks[:, 0] == starts).all())
        checked[f"{design} {threads}"] = ok
    times = {f"{d} {t}": {"batch": [], "chain": []} for d, t in cases}
    for _ in range(5):
        for design, threads in cases:
            row = times[f"{design} {threads}"]
            row["batch"].append(_time_ms(lambda: launch(design, starts, threads)))
            row["chain"].append(_time_ms(lambda: launch(design, few, threads)))
    lib.probe_persisting_l2(0)
    return dict(
        walkers=BATCH, walk_length=WALK, chain_walkers=FEW, persisting_limit_err=persisting,
        walks_are_arcs=checked,
        median_ms={k: {part: float(np.median(v[part])) for part in v} for k, v in times.items()},
        runs_ms=times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout
    print(json.dumps(dict(card=smi.strip().splitlines()[0], **run(torch.device("cuda")))),
          flush=True)


if __name__ == "__main__":
    main()
