"""Holdout evaluation pipelines — counterpart of
`embiggen_tpu/pipelines/evaluation.py`: for every graph and model, split
the graph by the evaluation schema, fit the holdout-biased feature models
(stochastic or topological embeddings) on the train graph, fit the model,
and score train and test, one row of metrics per split and unbalance rate,
tagged with the holdout, the model and the seconds of each phase.

The pipelines return a list of row dicts, with the reference's column names
in the reference's row order; `rows_to_dataframe` makes a pandas DataFrame
of them, importing pandas only when it is called. Names of models resolve
through the port's registry; models built from names (or classes) run on
`device`, model instances on their own. With `profile_dir`, each holdout's
fit runs under a torch.profiler trace written to
`<profile_dir>/holdout_<n>`. The facades are the edge-prediction,
node-label and edge-label ones.

With `enable_cache`, each (model, graph) experiment is stored at the
reference's `experiments/{task}/{graph}/{hash}.csv.gz` under `cache_dir`
(default `utils.cache.DEFAULT_CACHE_DIR`) and read back on a later call with
the same key: the model's hash and device type, the graph's, the schema, the
holdouts, the seed, the features and the evaluation's keyword arguments. The
file is written and read with `csv` and `gzip`; each cell holds its value's
Python literal, so the rows read back have the types the facade returned.
The cache is off with `number_of_workers` (workers would race on one file)
and under `smoke_test`.
"""
from __future__ import annotations

import ast
import contextlib
import csv
import gzip
import hashlib
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..graph.graph import Graph
from ..graph.loaders import get_dataset
from ..models.classifier import AbstractClassifierModel
from ..models.registry import get_model_from_library
from ..parallel.distributed import holdout_belongs_to_this_worker
from ..utils import profiling
from ..utils.cache import DEFAULT_CACHE_DIR

Rows = List[Dict[str, Any]]


def rows_to_dataframe(rows: Rows):
    """The rows of an evaluation as a pandas DataFrame."""
    import pandas as pd

    return pd.DataFrame(rows)


def _resolve_models(
    models, task_name: str, library_name: Optional[str], smoke_test: bool,
    device: Optional[Union[str, torch.device]],
) -> List[AbstractClassifierModel]:
    if not isinstance(models, (list, tuple)):
        models = [models]
    kwargs = {} if device is None else {"device": device}
    out = []
    for m in models:
        if isinstance(m, str):
            m = get_model_from_library(
                m, task_name=task_name, library_name=library_name)
        if isinstance(m, type):
            m = m.into_smoke_test(**kwargs) if smoke_test else m(**kwargs)
        out.append(m)
    return out


def _describe_features(features) -> str:
    """Stable content descriptor of a feature spec for the experiment-cache
    key: strings and models by their parameters, arrays, tensors and
    DataFrames by their contents."""
    if features is None:
        return "none"
    if not isinstance(features, (list, tuple)):
        features = [features]
    h = hashlib.sha256()
    for f in features:
        if isinstance(f, str):
            h.update(f.encode())
        elif hasattr(f, "consistent_hash"):
            h.update(f.consistent_hash().encode())
        elif isinstance(f, torch.Tensor):
            h.update(np.ascontiguousarray(f.detach().cpu().numpy()).tobytes())
        elif hasattr(f, "to_numpy"):
            h.update(np.ascontiguousarray(f.to_numpy()).tobytes())
        else:
            h.update(np.ascontiguousarray(np.asarray(f)).tobytes())
    return h.hexdigest()[:32]


def experiment_cache_path(
    model: AbstractClassifierModel,
    graph: Graph,
    evaluation_schema: str,
    holdouts_number: int,
    random_state: int,
    features_key: str,
    evaluation_kwargs: Dict[str, Any],
    cache_dir: Optional[str] = None,
) -> str:
    """`experiments/{task}/{graph}/{hash}.csv.gz` (the reference's layout);
    the hash also holds the model's device type, which its hash does not."""
    h = hashlib.sha256()
    device = getattr(model, "device", None)
    for part in (
        model.consistent_hash(), graph.consistent_hash(), evaluation_schema,
        holdouts_number, random_state, features_key,
        repr(sorted(evaluation_kwargs.items())),
        "cpu" if device is None else torch.device(device).type,
    ):
        h.update(str(part).encode())
    return os.path.join(
        cache_dir or DEFAULT_CACHE_DIR,
        "experiments",
        model.task_name().replace(" ", "_"),
        graph.name.replace(" ", "_"),
        f"{h.hexdigest()[:32]}.csv.gz",
    )


def _cell(value) -> str:
    """A row value as the Python literal `_value` reads back."""
    if isinstance(value, np.generic):
        value = value.item()
    if isinstance(value, float) and not math.isfinite(value):
        return repr(value)   # 'nan', 'inf', '-inf'
    if value is None or isinstance(value, (bool, int, float, str)):
        return repr(value)
    raise TypeError(f"The experiment cache stores scalars; got {type(value).__name__}.")


def _value(cell: str):
    if cell in ("nan", "inf", "-inf"):
        return float(cell)
    return ast.literal_eval(cell)


def write_experiment_rows(rows: Rows, path: str) -> None:
    """`rows` as a gzip CSV at `path` (every row's columns, in first-seen
    order; a missing cell is None), written to a temporary file and renamed
    into place."""
    columns: Dict[str, None] = {}
    for row in rows:
        columns.update(dict.fromkeys(row))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with gzip.open(tmp, "wt", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(columns)
        for row in rows:
            writer.writerow([_cell(row.get(c)) for c in columns])
    os.replace(tmp, path)


def read_experiment_rows(path: str) -> Rows:
    """The rows `write_experiment_rows` stored at `path`."""
    with gzip.open(path, "rt", newline="") as f:
        reader = csv.reader(f)
        columns = next(reader, [])
        return [dict(zip(columns, map(_value, cells))) for cells in reader]


class _HoldoutMemo:
    """Shares each holdout's split and re-fitted features across the models
    evaluated on one graph."""

    def __init__(self, graph, evaluation_schema, random_state,
                 holdouts_kwargs, node_features):
        self.graph = graph
        self.schema = evaluation_schema
        self.random_state = random_state
        self.holdouts_kwargs = holdouts_kwargs
        self.node_features = node_features
        self._memo: Dict[int, Any] = {}

    def get(self, split_cls, holdout_number: int):
        """(train, test, features, split seconds, feature seconds)."""
        if holdout_number not in self._memo:
            t_split = time.perf_counter()
            train, test = split_cls.split_graph_following_evaluation_schema(
                self.graph,
                self.schema,
                holdout_number,
                random_state=self.random_state,
                holdouts_kwargs=self.holdouts_kwargs,
            )
            split_time = time.perf_counter() - t_split
            t_feat = time.perf_counter()
            normalized = split_cls.normalize_node_features(
                train, self.node_features, skip_evaluation_biased_feature=True)
            features = AbstractClassifierModel.fit_deferred_features(
                normalized, train)
            feature_time = time.perf_counter() - t_feat
            self._memo[holdout_number] = (
                train, test, features, split_time, feature_time)
        return self._memo[holdout_number]


def _align_subgraph(graph: Graph, subgraph: Graph) -> Graph:
    """A subgraph of interest in `graph`'s node ids: returned as it is when
    the node names agree, else its arcs are renumbered by name (an unknown
    name raises KeyError)."""
    g_names = graph.get_node_names()
    s_names = subgraph.get_node_names()
    if len(g_names) == len(s_names) and bool(
        np.all(np.asarray(g_names) == np.asarray(s_names))
    ):
        return subgraph
    ids = graph.get_node_ids_from_names(list(s_names)).astype(np.int64)
    return Graph.from_edge_arrays(
        ids[subgraph.sources],
        ids[subgraph.col_idx],
        n_nodes=graph.number_of_nodes,
        weights=subgraph.weights,
        edge_types=subgraph.edge_types,
        directed=True,
        directed_flag=subgraph.directed,
        name=subgraph.name,
        node_names=g_names,
        edge_type_names=subgraph.edge_type_names,
    )


def evaluate_model_on_graph(
    model: AbstractClassifierModel,
    graph: Graph,
    evaluation_schema: str,
    holdouts_number: int,
    memo: Optional[_HoldoutMemo] = None,
    node_features=None,
    node_type_features=None,
    edge_type_features=None,
    edge_features=None,
    random_state: int = 42,
    holdouts_kwargs: Optional[Dict[str, Any]] = None,
    number_of_workers: Optional[int] = None,
    worker_id: Optional[int] = None,
    enable_cache: bool = False,
    cache_dir: Optional[str] = None,
    profile_dir: Optional[str] = None,
    subgraph_of_interest: Optional[Graph] = None,
    use_subgraph_as_support: bool = False,
    **evaluation_kwargs,
) -> Rows:
    """The rows of ONE model on ONE graph: holdouts x {train, test} x
    unbalance rates, for the holdouts that belong to this worker. Each
    holdout fits a clone of `model` (seeded random_state + holdout number
    when stochastic) under the profiler range "fit:<model name>", traced
    into `<profile_dir>/holdout_<n>` when `profile_dir` is given.

    With `subgraph_of_interest`, each holdout's train and test are cut to
    the subgraph's edges; the model fits on the cut train with the whole
    train as its support (or the cut train, with `use_subgraph_as_support`),
    and the evaluation negatives are drawn from the subgraph's degrees.

    With `enable_cache` and no `number_of_workers`, the rows are stored at
    `experiment_cache_path` and read back from there on a later call."""
    sub_aligned = (
        _align_subgraph(graph, subgraph_of_interest)
        if subgraph_of_interest is not None else None
    )
    # Off across workers: they would race writing the same file.
    use_cache = enable_cache and number_of_workers is None
    path = None
    if use_cache:
        feat_key = "|".join(
            _describe_features(f)
            for f in (node_features, node_type_features, edge_type_features, edge_features))
        key_kwargs = dict(evaluation_kwargs)
        if sub_aligned is not None:
            key_kwargs["subgraph_of_interest"] = sub_aligned.consistent_hash()
            key_kwargs["use_subgraph_as_support"] = use_subgraph_as_support
        path = experiment_cache_path(model, graph, evaluation_schema, holdouts_number,
                                     random_state, feat_key, key_kwargs, cache_dir)
        if os.path.exists(path):
            return read_experiment_rows(path)
    if memo is None:
        memo = _HoldoutMemo(graph, evaluation_schema, random_state,
                            holdouts_kwargs, node_features)
    meta = AbstractClassifierModel.run_metadata()
    all_rows: Rows = []
    for holdout_number in range(holdouts_number):
        if not holdout_belongs_to_this_worker(
            holdout_number, number_of_workers, worker_id
        ):
            continue
        train, test, features, split_time, feature_time = memo.get(
            model, holdout_number)
        if sub_aligned is not None:
            train_oi = train & sub_aligned
            test_oi = test & sub_aligned
            if model.task_name() in ("Edge Prediction", "Edge Label Prediction"):
                for part, part_name in ((train_oi, "train"), (test_oi, "test")):
                    if part.number_of_directed_edges == 0:
                        raise ValueError(
                            f"The {part_name} graph of holdout {holdout_number}, "
                            "once restricted to the subgraph of interest "
                            f"{sub_aligned.name!r}, has no edges left, and a "
                            f"{model.task_name()} task needs them.")
        else:
            train_oi, test_oi = train, test
        fit_support = (
            train_oi if (sub_aligned is not None and use_subgraph_as_support)
            else train
        )
        m = model.clone()
        if m.is_stochastic():
            m.set_random_state(random_state + holdout_number)
        t_fit = time.perf_counter()
        fit_ctx = (
            profiling.trace(os.path.join(profile_dir, f"holdout_{holdout_number}"))
            if profile_dir else contextlib.nullcontext()
        )
        with fit_ctx, profiling.annotate(f"fit:{m.model_name()}"):
            m.fit(
                train_oi, support=fit_support, node_features=features,
                node_type_features=node_type_features,
                edge_type_features=edge_type_features,
                edge_features=edge_features,
            )
        fit_time = time.perf_counter() - t_fit
        t_eval = time.perf_counter()
        rows = m._evaluate(
            graph,
            train_oi,
            test_oi,
            support=fit_support,
            random_state=random_state + holdout_number,
            subgraph_of_interest=sub_aligned,
            **evaluation_kwargs,
        )
        eval_time = time.perf_counter() - t_eval
        for row in rows:
            row.update({
                "task_name": m.task_name(),
                "model_name": m.model_name(),
                "library_name": m.library_name(),
                "graph_name": graph.name,
                "holdout_number": holdout_number,
                "evaluation_schema": evaluation_schema,
                "split_time": split_time,
                "feature_time": feature_time,
                "fit_time": fit_time,
                "evaluation_time": eval_time,
                **meta,
            })
        all_rows.extend(rows)
    if use_cache:
        write_experiment_rows(all_rows, path)
    return all_rows


def classification_evaluation_pipeline(
    evaluation_schema: str,
    holdouts_number: int,
    graphs: Union[Graph, str, Sequence[Union[Graph, str]]],
    models,
    task_name: str,
    library_names: Optional[str] = None,
    node_features=None,
    node_type_features=None,
    edge_type_features=None,
    edge_features=None,
    smoke_test: bool = False,
    random_state: int = 42,
    holdouts_kwargs: Optional[Dict[str, Any]] = None,
    number_of_workers: Optional[int] = None,
    worker_id: Optional[int] = None,
    enable_cache: bool = False,
    cache_dir: Optional[str] = None,
    verbose: bool = True,
    device: Optional[Union[str, torch.device]] = None,
    **evaluation_kwargs,
) -> Rows:
    """The rows of every model on every graph (graph names resolve through
    `get_dataset`) over `holdouts_number` holdouts; with
    `number_of_workers`, holdouts are shared round-robin among workers.
    Models given by name or class are built on `device` (their default when
    None)."""
    if not isinstance(graphs, (list, tuple)):
        graphs = [graphs]
    rows: Rows = []
    for graph in graphs:
        if isinstance(graph, str):
            graph = get_dataset(graph)
        memo = _HoldoutMemo(graph, evaluation_schema, random_state,
                            holdouts_kwargs, node_features)
        for model in _resolve_models(models, task_name, library_names,
                                     smoke_test, device):
            rows.extend(evaluate_model_on_graph(
                model,
                graph,
                evaluation_schema,
                holdouts_number,
                memo=memo,
                node_features=node_features,
                node_type_features=node_type_features,
                edge_type_features=edge_type_features,
                edge_features=edge_features,
                random_state=random_state,
                holdouts_kwargs=holdouts_kwargs,
                number_of_workers=number_of_workers,
                worker_id=worker_id,
                enable_cache=enable_cache and not smoke_test,
                cache_dir=cache_dir,
                **evaluation_kwargs,
            ))
    return rows


def edge_prediction_evaluation(
    holdouts_number: int,
    models,
    graphs,
    evaluation_schema: str = "Connected Monte Carlo",
    node_features=None,
    library_names: Optional[str] = None,
    smoke_test: bool = False,
    random_state: int = 42,
    holdouts_kwargs: Optional[Dict[str, Any]] = None,
    unbalance_rates: Sequence[float] = (1.0,),
    use_scale_free_distribution: bool = True,
    **kwargs,
) -> Rows:
    """Holdout evaluation of edge-prediction models: the rows of
    `classification_evaluation_pipeline` for the "Edge Prediction" task."""
    return classification_evaluation_pipeline(
        evaluation_schema,
        holdouts_number,
        graphs,
        models,
        task_name="Edge Prediction",
        library_names=library_names,
        node_features=node_features,
        smoke_test=smoke_test,
        random_state=random_state,
        holdouts_kwargs=holdouts_kwargs,
        unbalance_rates=unbalance_rates,
        use_scale_free_distribution=use_scale_free_distribution,
        **kwargs,
    )


def node_label_prediction_evaluation(
    holdouts_number: int,
    models,
    graphs,
    evaluation_schema: str = "Stratified Monte Carlo",
    node_features=None,
    library_names: Optional[str] = None,
    smoke_test: bool = False,
    random_state: int = 42,
    holdouts_kwargs: Optional[Dict[str, Any]] = None,
    **kwargs,
) -> Rows:
    """Holdout evaluation of node-label models: the rows of
    `classification_evaluation_pipeline` for the "Node Label Prediction"
    task, one per split with labelled nodes."""
    return classification_evaluation_pipeline(
        evaluation_schema,
        holdouts_number,
        graphs,
        models,
        task_name="Node Label Prediction",
        library_names=library_names,
        node_features=node_features,
        smoke_test=smoke_test,
        random_state=random_state,
        holdouts_kwargs=holdouts_kwargs,
        **kwargs,
    )


def edge_label_prediction_evaluation(
    holdouts_number: int,
    models,
    graphs,
    evaluation_schema: str = "Stratified Monte Carlo",
    node_features=None,
    library_names: Optional[str] = None,
    smoke_test: bool = False,
    random_state: int = 42,
    holdouts_kwargs: Optional[Dict[str, Any]] = None,
    **kwargs,
) -> Rows:
    """Holdout evaluation of edge-label models: the rows of
    `classification_evaluation_pipeline` for the "Edge Label Prediction"
    task, one per split with typed arcs."""
    return classification_evaluation_pipeline(
        evaluation_schema,
        holdouts_number,
        graphs,
        models,
        task_name="Edge Label Prediction",
        library_names=library_names,
        node_features=node_features,
        smoke_test=smoke_test,
        random_state=random_state,
        holdouts_kwargs=holdouts_kwargs,
        **kwargs,
    )
