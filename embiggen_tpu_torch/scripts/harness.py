"""The flagship evaluation harness at bench scale — the port's counterpart of
`bench.py`'s harness phase (`bench.py:411-530`).

    python -m embiggen_tpu_torch.scripts.harness [--device cuda]

prints one JSON line of the phase seconds and test AUPRC of
`edge_prediction_evaluation` (one connected holdout, unbalance 1.0,
random_state 0) of a Perceptron (Degree + CosineSimilarity) and a Kipf GCN
over SkipGram features fitted on the holdout's train graph, on
`planted_partition_edges(N, E / 2, seed=0)`, where E is the arc count of
`erdos_renyi(N, 10M, seed=0)` and N is one million. It also times one
`sample_negative_graph` of E / 2 negatives on that ER graph, and gives the
sha1 of the holdout's train and test CSR arrays (`eval_split_sha1`), so that
two builds' splits can be compared.

Phase keys are bench.py's; `eval_split_s` and `eval_feature_s` are summed
over distinct holdouts (bench.py takes a max over rows, which is right only
for one holdout), `eval_fit_s` and `eval_predict_metrics_s` over distinct
(model, holdout) pairs, the four inner phases over all rows. Times are host
seconds of runs that end in a host read of their results.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import subprocess
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..graph import erdos_renyi, planted_partition_edges, sample_negative_graph
from ..graph.graph import Graph
from ..models.edge_prediction import PerceptronEdgePrediction
from ..models.embedders import SkipGram
from ..models.gcn import KipfGCNEdgePrediction
from ..pipelines import edge_prediction_evaluation

N_NODES, N_EDGES = 1_000_000, 10_000_000


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _sum_once(rows, keys, column) -> float:
    """Sum of `column` over the first row of each distinct value of `keys`."""
    seen = {}
    for r in rows:
        seen.setdefault(tuple(r[k] for k in keys), r[column])
    return float(sum(seen.values()))


def summarize(rows) -> Dict[str, Any]:
    """bench.py's harness keys of an evaluation's rows (without the totals
    measured around it)."""
    models = sorted({r["model_name"] for r in rows})
    test = [r for r in rows if r["evaluation_mode"] == "test"]
    return {
        "eval_split_s": _sum_once(rows, ("holdout_number",), "split_time"),
        "eval_feature_s": _sum_once(rows, ("holdout_number",), "feature_time"),
        "eval_fit_s": _sum_once(rows, ("model_name", "holdout_number"), "fit_time"),
        "eval_predict_metrics_s": _sum_once(
            rows, ("model_name", "holdout_number"), "evaluation_time"),
        "eval_predict_positive_s": float(sum(r["predict_positive_seconds"] for r in rows)),
        "eval_predict_negative_s": float(sum(r["predict_negative_seconds"] for r in rows)),
        "eval_neg_sampling_inner_s": float(sum(r["negative_sampling_seconds"] for r in rows)),
        "eval_metric_panels_s": float(sum(r["metrics_seconds"] for r in rows)),
        "eval_fit_by_model": {
            m: _sum_once([r for r in rows if r["model_name"] == m],
                         ("holdout_number",), "fit_time")
            for m in models
        },
        "eval_predict_by_model": {
            m: float(sum(r["predict_positive_seconds"] + r["predict_negative_seconds"]
                         for r in rows if r["model_name"] == m))
            for m in models
        },
        "eval_test_auprc": float(np.mean([r["auprc"] for r in test])),
        "eval_test_auprc_by_model": {
            m: float(np.mean([r["auprc"] for r in test if r["model_name"] == m]))
            for m in models
        },
    }


def split_sha1(train: Graph, test: Graph) -> str:
    """sha1 of the row_ptr and col_idx arrays of a train and a test graph."""
    h = hashlib.sha1()
    for part in (train, test):
        for a in (part.row_ptr, part.col_idx):
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def recorded_split():
    """Records the train and test graphs of the first holdout that the
    evaluation pipeline splits inside the block; the yielded dict holds
    their `split_sha1` under "sha1" once the block has ended."""
    # Imported here: `harness_turns.py` runs this function's source in a
    # checkout whose harness lacks it.
    from embiggen_tpu_torch.pipelines import evaluation

    get = evaluation._HoldoutMemo.get
    splits = []

    def recording_get(memo, split_cls, holdout_number):
        out = get(memo, split_cls, holdout_number)
        if not splits:
            splits.append(out[:2])
        return out

    result = {}
    evaluation._HoldoutMemo.get = recording_get
    try:
        yield result
    finally:
        evaluation._HoldoutMemo.get = get
    result["sha1"] = split_sha1(*splits[0])


def run(device: Union[str, torch.device] = "cuda",
        er_graph: Optional[Graph] = None) -> Dict[str, Any]:
    """The harness on `device`; `er_graph` is erdos_renyi(N, 10M, seed=0),
    built here when not given. Returns bench.py's harness keys, the test
    AUPRC of each model, and on a CUDA device the card's line and peak
    device memory."""
    device = torch.device(device)
    if er_graph is None:
        er_graph = erdos_renyi(N_NODES, N_EDGES, seed=0)
    half = er_graph.number_of_directed_edges // 2
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    sample_negative_graph(er_graph, half, random_state=0, device=device)
    neg_sample_s = time.perf_counter() - t0

    eval_graph = planted_partition_edges(er_graph.number_of_nodes, half, seed=0)
    with recorded_split() as split:
        t0 = time.perf_counter()
        rows = edge_prediction_evaluation(
            holdouts_number=1,
            models=[
                PerceptronEdgePrediction(
                    edge_features=["Degree"], edge_embeddings=["CosineSimilarity"],
                    number_of_epochs=15, random_state=0, device=device),
                KipfGCNEdgePrediction(
                    epochs=4, batch_size=1 << 20, dropout_rate=0.0,
                    early_stopping_patience=10**6, random_state=0, device=device),
            ],
            graphs=eval_graph,
            node_features=SkipGram(
                embedding_size=64, epochs=60, walk_length=16, window_size=2,
                number_of_negative_samples=5, learning_rate_decay=0.99,
                random_state=0, early_stopping_patience=10**6,
                learning_rate_plateau_patience=10**6, device=device),
            unbalance_rates=(1.0,),
            random_state=0,
            verbose=False,
        )
        eval_total_s = time.perf_counter() - t0
    out = {"eval_total_s": eval_total_s,
           "eval_negative_sampling_s": neg_sample_s, **summarize(rows),
           "eval_split_sha1": split["sha1"],
           "eval_graph": {"nodes": eval_graph.number_of_nodes,
                          "arcs": eval_graph.number_of_directed_edges}}
    if device.type == "cuda":
        out["eval_peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
        out["device"] = torch.cuda.get_device_name(device)
        out["card"] = card_line()
    else:
        out["device"] = "cpu"
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device of the models (default cuda)")
    args = parser.parse_args()
    print(json.dumps(run(args.device)), flush=True)


if __name__ == "__main__":
    main()
