"""The flagship harness of two checkouts in turns on one card, for a
before-and-after table of its phases.

    python -m embiggen_tpu_torch.scripts.harness_turns --parent <checkout> \\
        [--out <file.json>]

Each run is a process of its own, with its working directory and PYTHONPATH
set to one checkout (this one or `--parent`), that builds
erdos_renyi(1M, 10M, seed=0) and runs that checkout's
`embiggen_tpu_torch.scripts.harness.run` on it, in the order parent, change,
change, parent, parent, change (RUNS of each). Every run also gives the sha1
of the holdout's train and test CSR arrays that its evaluation split
(`harness.recorded_split`, whose source this checkout runs in a checkout
whose harness lacks it), so the splits can be compared. Both checkouts'
kernels, and their native host helpers where they have them, are built
before the first run. Prints one JSON line (every run's phases, each numeric
phase's median by checkout, the sha1s and the card's line), and writes it to
`--out` when given.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List

from . import harness

RUNS = 3

CHILD = r'''
import json, sys, time
mode = sys.argv[1]
if mode == "build":
    from embiggen_tpu_torch.ops import _build
    print("RESULT " + json.dumps({"kernels_s": _build.build()}))
    try:
        from embiggen_tpu_torch import native
    except ImportError:
        sys.exit(0)
    print("RESULT " + json.dumps({"native_s": native.build()}))
    sys.exit(0)
t0 = time.perf_counter()
from embiggen_tpu_torch.graph import erdos_renyi
from embiggen_tpu_torch.scripts import harness
er = erdos_renyi(harness.N_NODES, harness.N_EDGES, seed=0)
setup_s = time.perf_counter() - t0
if hasattr(harness, "recorded_split"):
    out = harness.run("cuda", er_graph=er)
else:
    ns = {}
    exec(sys.argv[2], ns)
    with ns["recorded_split"]() as split:
        out = harness.run("cuda", er_graph=er)
    out["eval_split_sha1"] = split["sha1"]
out["setup_s"] = setup_s
print("RESULT " + json.dumps(out))
'''


def recorder_source() -> str:
    """The source of the harness's split recorder, to run in a checkout
    whose harness lacks it."""
    return ("from __future__ import annotations\nimport contextlib, hashlib\n"
            "import numpy as np\n" + "".join(
                inspect.getsource(f) for f in (harness.split_sha1, harness.recorded_split)))


def _child(checkout: Path, *args: str) -> List[Dict[str, Any]]:
    env = dict(os.environ, PYTHONPATH=str(checkout))
    proc = subprocess.run([sys.executable, "-c", CHILD, *args], cwd=checkout, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the run in {checkout} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    return [json.loads(line[len("RESULT "):]) for line in proc.stdout.splitlines()
            if line.startswith("RESULT ")]


def _numbers(out: Dict[str, Any], prefix: str = "") -> Dict[str, float]:
    """The numeric entries of a run's output, nested keys joined by '.'."""
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update(_numbers(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            flat[prefix + k] = float(v)
    return flat


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True, help="the checkout to compare with")
    parser.add_argument("--out", help="also write the JSON to this file")
    args = parser.parse_args()
    trees = {"parent": Path(args.parent).resolve(),
             "change": Path(__file__).resolve().parents[2]}
    recorder = recorder_source()
    result: Dict[str, Any] = {"card": harness.card_line(), "builds": {}, "runs": []}
    for name, tree in trees.items():
        result["builds"][name] = _child(tree, "build")
    order = [("parent", "change"), ("change", "parent")] * RUNS
    for name in [name for pair in order for name in pair][:2 * RUNS]:
        out = _child(trees[name], "run", recorder)[0]
        result["runs"].append({"checkout": name, **out})
        print(f"{name}: eval_total_s {out['eval_total_s']:.2f} split {out['eval_split_s']:.2f} "
              f"panels {out['eval_metric_panels_s']:.2f}", file=sys.stderr, flush=True)
    result["median"] = {}
    for name in trees:
        runs = [_numbers(r) for r in result["runs"] if r["checkout"] == name]
        result["median"][name] = {k: statistics.median(r[k] for r in runs)
                                  for k in runs[0] if all(k in r for r in runs)}
    result["sha1"] = {name: sorted({r["eval_split_sha1"] for r in result["runs"]
                                    if r["checkout"] == name}) for name in trees}
    result["same_split"] = len({r["eval_split_sha1"] for r in result["runs"]}) == 1
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
