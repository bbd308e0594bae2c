"""The port's S1 slice end to end on the CPU: `embed_graph(graph,
"Node2Vec SkipGram", device="cpu")`, with the quality gate, reproducibility,
smoke-test, registry and plateau checks of tests/test_embedders.py, graphs
by name, and runs on a host where jax (or pandas) cannot be imported."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from embiggen_tpu.models.embedders import SkipGram as RefSkipGram
from embiggen_tpu_torch import embed_graph
from embiggen_tpu_torch.graph import Graph, erdos_renyi
from embiggen_tpu_torch.models import get_model_from_library
from embiggen_tpu_torch.models.embedders import SkipGram

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _community_separation(emb, labels):
    """Mean cosine similarity within communities minus across communities."""
    emb = np.asarray(emb, dtype=np.float64)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    sim = emb @ emb.T
    same = labels[:, None] == labels[None, :]
    off_diag = ~np.eye(len(labels), dtype=bool)
    return sim[same & off_diag].mean() - sim[~same].mean()


@pytest.fixture(scope="module")
def graph(karate):
    return Graph(row_ptr=karate.row_ptr, col_idx=karate.col_idx,
                 directed=karate.directed, name=karate.name)


def test_skipgram_trains_and_separates(graph, karate):
    result = embed_graph(
        graph, "Node2Vec SkipGram", device="cpu",
        embedding_size=16, epochs=120, batch_size=8, walk_length=20,
        window_size=4, iterations=4, learning_rate=0.05,
        learning_rate_decay=0.99, random_state=42,
        early_stopping_patience=10**6, learning_rate_plateau_patience=10**6,
    )
    emb = result.get_node_embedding_from_index(0)
    assert emb.shape == (34, 16) and emb.dtype == np.float32
    assert np.isfinite(emb).all()
    assert result.get_node_embedding_from_index(1).shape == (34, 16)
    np.testing.assert_array_equal(result._node_names, karate.get_node_names())
    sep = _community_separation(emb, karate.get_single_label_node_type_ids())
    assert sep > 0.1, f"community separation too weak: {sep}"


def test_smoke_test_params(graph):
    result = embed_graph(graph, "Node2Vec SkipGram", smoke_test=True,
                         device="cpu", random_state=3)
    assert result.get_node_embedding_from_index(0).shape == (34, 5)
    model = SkipGram.into_smoke_test(random_state=3, device="cpu")
    assert embed_graph(graph, model, smoke_test=True).node_embeddings[0].shape == (34, 5)


def test_reproducibility(graph):
    kwargs = dict(embedding_size=8, epochs=2, batch_size=16, walk_length=12,
                  window_size=2, random_state=7, device="cpu")
    e1 = SkipGram(**kwargs).fit_transform(graph).get_node_embedding_from_index(0)
    e2 = SkipGram(**kwargs).fit_transform(graph).get_node_embedding_from_index(0)
    np.testing.assert_array_equal(e1, e2)
    e3 = SkipGram(**{**kwargs, "random_state": 8}).fit_transform(
        graph).get_node_embedding_from_index(0)
    assert not np.allclose(e1, e3)


def test_return_dataframe(graph):
    model = SkipGram.into_smoke_test(random_state=3, device="cpu")
    df = model.fit_transform(graph, return_dataframe=True).get_node_embedding_from_index(0)
    assert hasattr(df, "loc") and df.shape == (34, 5)


def test_parameters_match_reference():
    kwargs = dict(embedding_size=8, epochs=2, random_state=5, walk_length=12)
    port = SkipGram(device="cpu", **kwargs)
    assert port.parameters() == RefSkipGram(**kwargs).parameters()
    clone = SkipGram(**port.parameters(), device="cpu")
    assert clone.consistent_hash() == port.consistent_hash()
    assert port.clone().device == torch.device("cpu")
    assert "device" not in port.parameters()


def test_registry_resolution():
    assert get_model_from_library("Node2Vec SkipGram") is SkipGram
    assert get_model_from_library("node2vec skipgram",
                                  task_name="Node Embedding") is SkipGram
    assert SkipGram.library_name() == "Torch"
    with pytest.raises(ValueError):
        get_model_from_library("No Such Model")


def test_early_stopping_and_plateau_lr(graph):
    kwargs = dict(embedding_size=8, epochs=300, batch_size=34, walk_length=20,
                  window_size=4, iterations=8, learning_rate=0.05,
                  learning_rate_decay=0.99, random_state=42, device="cpu")
    m = SkipGram(**kwargs)
    m.fit_transform(graph)
    assert m._stopped_epoch is not None and m._stopped_epoch < 299
    assert np.isfinite(m._last_loss)
    assert len(m._epoch_losses) == m._stopped_epoch + 1
    m_off = SkipGram(**kwargs, early_stopping_patience=10**6,
                     learning_rate_plateau_patience=10**6)
    m_off.fit_transform(graph)
    assert m_off._stopped_epoch is None
    assert len(m_off._epoch_losses) == 300
    assert m.parameters()["early_stopping_patience"] == 1


def test_degree_conditioned_sgd_knobs(graph):
    kwargs = dict(embedding_size=8, epochs=3, batch_size=16, walk_length=12,
                  window_size=2, random_state=3, device="cpu")
    base = SkipGram(**kwargs).fit_transform(graph).node_embeddings[0]
    knobs = dict(stochastic_downsample_by_degree=True,
                 normalize_learning_rate_by_degree=True)
    emb = SkipGram(**kwargs, **knobs, normalize_by_degree=True).fit_transform(
        graph).node_embeddings[0]
    assert np.isfinite(emb).all()
    assert not np.allclose(emb, base)
    raw = SkipGram(**kwargs, **knobs).fit_transform(graph).node_embeddings[0]
    deg = np.maximum(graph.degrees.astype(np.float32), 1.0)
    np.testing.assert_allclose(emb, raw / deg[:, None], rtol=1e-6)


def test_initial_params_are_used(graph):
    n, d = 34, 4
    tables = {"node_embedding": torch.full((n, d), 0.5),
              "context_embedding": torch.full((n, d), -0.5),
              "context_bias": torch.zeros(n)}
    kwargs = dict(embedding_size=d, epochs=1, batch_size=8, walk_length=10,
                  window_size=2, learning_rate=0.0, random_state=1,
                  device="cpu", early_stopping_patience=10**6)
    emb = SkipGram(**kwargs, initial_params=tables).fit_transform(graph)
    np.testing.assert_array_equal(emb.node_embeddings[0], 0.5)
    np.testing.assert_array_equal(emb.node_embeddings[1], -0.5)
    with pytest.raises(ValueError, match="shape"):
        SkipGram(**{**kwargs, "embedding_size": 3},
                 initial_params=tables).fit_transform(graph)


@pytest.mark.parametrize("kwargs", [dict(return_weight=2.0), dict(explore_weight=0.5)])
def test_pq_weights_are_accepted(graph, kwargs):
    """p/q walks are ported: the weights reach the model and the walks."""
    model = SkipGram(device="cpu", random_state=0, **kwargs)
    for name, value in kwargs.items():
        assert model.parameters()[name] == value
    emb = embed_graph(graph, "Node2Vec SkipGram", smoke_test=True, device="cpu",
                      random_state=0, **kwargs).node_embeddings[0]
    assert emb.shape == (34, 5) and np.isfinite(emb).all()


@pytest.mark.parametrize("kwargs", [dict(change_node_type_weight=4.0),
                                    dict(change_edge_type_weight=0.25)])
def test_typed_walk_options_reach_the_model(kwargs):
    """Typed walks are ported: the weights reach the model's parameters and
    its use of types, and it embeds a graph with node and edge types."""
    model = SkipGram(device="cpu", random_state=0, **kwargs)
    for name, value in kwargs.items():
        assert model.parameters()[name] == value
    assert model.is_using_node_types() == ("change_node_type_weight" in kwargs)
    assert model.is_using_edge_types() == ("change_edge_type_weight" in kwargs)
    graph = erdos_renyi(60, 240, seed=1, n_edge_types=3, n_node_types=4)
    emb = embed_graph(graph, "Node2Vec SkipGram", smoke_test=True, device="cpu",
                      random_state=0, **kwargs).node_embeddings[0]
    assert emb.shape == (60, 5) and np.isfinite(emb).all()


@pytest.mark.parametrize("kwargs, item", [
    (dict(checkpoint_dir="ckpt"), "A12"),
    (dict(enable_cache=True), "A12"),
])
def test_unported_options_raise(kwargs, item):
    """The options of ROADMAP `item` are ported since: the model takes and
    keeps them (their fits: tests/test_torch_checkpoint.py,
    tests/test_torch_cache.py)."""
    model = SkipGram(device="cpu", random_state=0, **kwargs)
    ((name, value),) = kwargs.items()
    assert item == "A12" and getattr(model, f"_{name}") == value


def test_embed_graph_rejects_graph_names(tmp_path, monkeypatch):
    """Names it cannot load: unknown ones and corpora with no local file;
    the bundled typed dataset, KarateClub, loads."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("EMBIGGEN_DATA_DIR", raising=False)
    with pytest.raises(KeyError, match="Unknown dataset"):
        SkipGram(device="cpu", random_state=0).fit_transform("NoSuchGraph")
    for name in ("Usair97", "Cora"):
        with pytest.raises(FileNotFoundError, match="synthetic_fallback"):
            embed_graph(name, "Node2Vec SkipGram", device="cpu")
    karate = embed_graph("KarateClub", "Node2Vec SkipGram", device="cpu", smoke_test=True,
                         random_state=0)
    assert karate.node_embeddings[0].shape == (34, 5)


def test_embed_graph_resolves_graph_names(tmp_path, monkeypatch):
    rows = ["subject\tobject"] + [f"v{i}\tv{(i * 7 + 3) % 40}" for i in range(40)]
    (tmp_path / "Usair97.tsv").write_text("\n".join(rows) + "\n")
    monkeypatch.setenv("EMBIGGEN_DATA_DIR", str(tmp_path))
    result = embed_graph("Usair97", "Node2Vec SkipGram", device="cpu",
                         smoke_test=True, random_state=4)
    assert result.node_embeddings[0].shape == (40, 5)


def test_runs_where_jax_cannot_be_imported():
    """The port must run on a host without jax: block jax and embiggen_tpu
    from being imported, fit every ported embedder (the factorization rows,
    K18's and the randomized SVD's modules among them, the 21 KGE rows with
    NodePiece's K15a tokens, and typed walks
    through K9's and K19's plain versions) on a tiny graph on the CPU, run
    K20's plain versions, load
    the bundled typed graphs, split a graph and draw its negatives on the
    native host helpers, fit the spectral rows (HOPE also at two DAG
    metrics), fit DAGResnik, draw a batch through the reference-named
    Graph surface, import every module of the port (`similarities` and
    `graph.compat` among them) and fit both edge predictors, the GCN also
    with type embeddings."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['embiggen_tpu'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from embiggen_tpu_torch import embed_graph\n"
        "from embiggen_tpu_torch.graph import erdos_renyi\n"
        "r = embed_graph(erdos_renyi(50, 200, seed=1), 'Node2Vec SkipGram',\n"
        "                device='cpu', embedding_size=4, epochs=1,\n"
        "                walk_length=8, window_size=2, batch_size=16,\n"
        "                random_state=0)\n"
        "assert r.node_embeddings[0].shape == (50, 4)\n"
        "import dataclasses, numpy as np\n"
        "g = erdos_renyi(50, 200, seed=1)\n"
        "typed = dataclasses.replace(g, edge_types=(\n"
        "    np.arange(g.number_of_directed_edges) % 3).astype(np.int32))\n"
        "for name in ('Second-order LINE', 'First-order LINE', 'Unstructured',\n"
        "             'TransE', 'TransH', 'Structured Embedding'):\n"
        "    graph = g if 'LINE' in name or name == 'Unstructured' else typed\n"
        "    r = embed_graph(graph, name, device='cpu', smoke_test=True,\n"
        "                    random_state=0)\n"
        "    assert r.node_embeddings[0].shape == (50, 5), name\n"
        "from embiggen_tpu_torch.models.embedders import KGE_MODELS\n"
        "for cls in KGE_MODELS:\n"
        "    e = embed_graph(typed, cls.model_name(), device='cpu', smoke_test=True,\n"
        "                    random_state=0)\n"
        "    assert np.isfinite(e.node_embeddings[0]).all(), cls\n"
        "from embiggen_tpu_torch.ops.negatives import chunk_mask, edge_chunk\n"
        "from embiggen_tpu_torch.ops.spmm import sddmm\n"
        "tg = g.device('cpu')\n"
        "s = sddmm(tg.col_idx, tg.col_idx, torch.ones(50, 3), torch.ones(50, 3))\n"
        "assert s.shape == (tg.n_arcs,) and bool((s == 3).all())\n"
        "assert edge_chunk(tg, 1, 64)[1].shape == (64,) and bool(chunk_mask(tg, 1, 64).all())\n"
        "for name, d in (('Walklets SkipGram', 4), ('Walklets CBOW', 4),\n"
        "                ('Walklets GloVe', 4), ('Node2Vec GloVe', 5),\n"
        "                ('DeepWalk GloVe', 5), ('Role2Vec', 5)):\n"
        "    r = embed_graph(g, name, device='cpu', smoke_test=True, random_state=0)\n"
        "    assert r.node_embeddings[0].shape == (50, d), name\n"
        "t = erdos_renyi(50, 200, seed=1, n_edge_types=3, n_node_types=4)\n"
        "for name, kw in (('Node2Vec SkipGram', dict(change_node_type_weight=2.0,\n"
        "                                            change_edge_type_weight=0.5)),\n"
        "                 ('Node2Vec CBOW', dict(return_weight=2.0, explore_weight=0.5,\n"
        "                                        change_node_type_weight=2.0)),\n"
        "                 ('Node2Vec GloVe', dict(change_edge_type_weight=0.5))):\n"
        "    e = embed_graph(t, name, device='cpu', smoke_test=True, random_state=0, **kw)\n"
        "    assert e.node_embeddings[0].shape == (50, 5), name\n"
        "from embiggen_tpu_torch.ops.walks import random_walks\n"
        "tw = random_walks(t.device('cpu', with_walk_types=True),\n"
        "                  torch.arange(50, dtype=torch.int32), 6,\n"
        "                  torch.Generator().manual_seed(0), change_node_type_weight=2.0)\n"
        "assert tw.shape == (50, 6)\n"
        "from embiggen_tpu_torch.graph import karate_club, small_ppi\n"
        "assert karate_club().has_node_types and small_ppi().has_edge_types\n"
        "from embiggen_tpu_torch import native\n"
        "from embiggen_tpu_torch.graph import connected_holdout, sample_negative_graph\n"
        "tr, te = connected_holdout(g, random_state=0)\n"
        "neg = sample_negative_graph(tr, 20, random_state=0, device='cpu')\n"
        "assert neg.number_of_edges == 20\n"
        "assert native.build_sym_csr([0], [1], 2)[1].tolist() == [1, 0]\n"
        "w = erdos_renyi(50, 200, seed=1, weighted=True)\n"
        "for name in ('Degree-based SPINE', 'Degree-based WINE', 'Score-based SPINE',\n"
        "             'Score-based WINE', 'WeightedSPINE', 'RUBICONE', 'RUINE'):\n"
        "    kw = {'scores': np.arange(50.0)} if name.startswith('Score') else {}\n"
        "    if name in ('RUBICONE', 'RUINE'):\n"
        "        kw['random_state'] = 0\n"
        "    e = embed_graph(w, name, device='cpu', smoke_test=True, **kw)\n"
        "    assert e.node_embeddings[0].shape == (50, 5), name\n"
        "for name in ('Node-label-based SPINE', 'Node-label-based WINE'):\n"
        "    try:\n"
        "        embed_graph(w, name, device='cpu', smoke_test=True)\n"
        "        raise AssertionError(name)\n"
        "    except RuntimeError as e:\n"
        "        assert 'requires node types' in str(e), e\n"
        "e = embed_graph(w, 'HyperSketching', device='cpu', smoke_test=True, random_state=0)\n"
        "assert e.edge_embeddings[0].shape == (w.number_of_directed_edges, 8)\n"
        "for name in ('NetMF', 'GraRep', 'BoostNE', 'RandNE', 'NodeSketch', 'MNMF',\n"
        "             'NMFADMM', 'NNSED'):\n"
        "    e = embed_graph(w, name, device='cpu', smoke_test=True)\n"
        "    assert e.embedding.shape == (50, 4), name\n"
        "from embiggen_tpu_torch import similarities\n"
        "from embiggen_tpu_torch.graph import compat\n"
        "for name in ('HOPE', 'Laplacian Eigenmaps', 'GLEE', 'SocioDim'):\n"
        "    e = embed_graph(w, name, device='cpu', smoke_test=True)\n"
        "    assert e.node_embeddings[0].shape == (50, 5), name\n"
        "from embiggen_tpu_torch.graph import Graph\n"
        "dag = Graph.from_edge_arrays(np.arange(1, 40), np.arange(40)[:39] // 2,\n"
        "                             n_nodes=40, directed=True)\n"
        "for metric in ('Resnik', 'Ancestors Jaccard'):\n"
        "    e = embed_graph(dag, 'HOPE', device='cpu', embedding_size=3, metric=metric)\n"
        "    assert np.isfinite(e.node_embeddings[1]).all(), metric\n"
        "assert similarities.DAGResnik().fit(dag).get_similarity_from_node_ids(1, 3) > 0\n"
        "assert issubclass(Graph, compat.ReferenceGraphAPI)\n"
        "assert len(w.node2vec(0, 8, 6, window_size=2, device='cpu')[1]) == 8 * 2\n"
        "import importlib, pkgutil, embiggen_tpu_torch\n"
        "for m in pkgutil.walk_packages(embiggen_tpu_torch.__path__,\n"
        "                               'embiggen_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction\n"
        "from embiggen_tpu_torch.models.gcn import KipfGCNEdgePrediction\n"
        "g = erdos_renyi(50, 200, seed=2)\n"
        "x = r.node_embeddings[0]\n"
        "for m in (PerceptronEdgePrediction(edge_embeddings=['CosineSimilarity'],\n"
        "                                   number_of_epochs=1, device='cpu'),\n"
        "          KipfGCNEdgePrediction(units=[4], epochs=1, device='cpu')):\n"
        "    p = m.fit(g, node_features=x).predict_proba(g)\n"
        "    assert p.shape == (g.number_of_directed_edges,)\n"
        "m = KipfGCNEdgePrediction(units=[4], epochs=1, use_node_type_embedding=True,\n"
        "                          use_edge_type_embedding=True, device='cpu')\n"
        "p = m.fit(t, edge_type_features=np.ones((3, 2))).predict_proba(t)\n"
        "assert p.shape == (t.number_of_directed_edges,)\n"
        "from embiggen_tpu_torch import edge_prediction_evaluation\n"
        "rows = edge_prediction_evaluation(\n"
        "    1, PerceptronEdgePrediction(edge_features=['Degree', 'AdamicAdar'],\n"
        "                                number_of_epochs=1, device='cpu'),\n"
        "    g, random_state=3)\n"
        "assert [r['evaluation_mode'] for r in rows] == ['train', 'test']\n"
        "assert sys.modules['jax'] is None\n"
        "assert not any(m.startswith('embiggen_tpu.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_evaluation_runs_where_pandas_cannot_be_imported():
    """No path of `edge_prediction_evaluation` imports pandas: block it and
    evaluate both edge predictors over a deferred SkipGram feature, with a
    K8 feature and the k-fold schema."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from embiggen_tpu_torch import edge_prediction_evaluation\n"
        "from embiggen_tpu_torch.graph import erdos_renyi\n"
        "from embiggen_tpu_torch.models.edge_prediction import PerceptronEdgePrediction\n"
        "from embiggen_tpu_torch.models.embedders import SkipGram\n"
        "rows = edge_prediction_evaluation(\n"
        "    2, [PerceptronEdgePrediction(edge_features=['JaccardCoefficient'],\n"
        "                                 edge_embeddings=['Hadamard'],\n"
        "                                 number_of_epochs=1, device='cpu'),\n"
        "        'Kipf GCN'],\n"
        "    erdos_renyi(60, 240, seed=1), evaluation_schema='Kfold',\n"
        "    node_features=SkipGram(embedding_size=4, epochs=1, walk_length=8,\n"
        "                           window_size=2, random_state=0, device='cpu'),\n"
        "    smoke_test=True, device='cpu', random_state=3)\n"
        "assert len(rows) == 2 * 2 * 2, len(rows)\n"
        "assert sys.modules['pandas'] is None\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_adapters_run_where_sklearn_and_pandas_cannot_be_imported():
    """A host like the card's: jax, embiggen_tpu, sklearn, pandas and
    matplotlib blocked. The package, its utils, the evaluation pipelines,
    the visualizer and the transformers import; a visualizer's PCA raises
    the ImportError of sklearn and its plot that of matplotlib; an adapter
    of each task with a numpy
    `model_instance` fits and predicts on the CPU (the edge ones with
    `use_edge_metrics`, the edge-prediction one also through
    `edge_prediction_evaluation` as a subclass that builds it); a named
    row raises ModuleNotFoundError naming scikit-learn, and so does the
    multilabel wrap; the catalogue lists the rows. HOPE fits, and
    DAGResnik's DataFrame raises ModuleNotFoundError naming pandas."""
    code = (
        "import sys\n"
        "for name in ('jax', 'embiggen_tpu', 'sklearn', 'pandas', 'matplotlib'):\n"
        "    sys.modules[name] = None\n"
        "sys.path.insert(0, 'tests')\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import embiggen_tpu_torch, embiggen_tpu_torch.utils\n"
        "import embiggen_tpu_torch.pipelines.evaluation, embiggen_tpu_torch.visualizations\n"
        "import embiggen_tpu_torch.transformers\n"
        "from numpy_estimators import CentroidClassifier, LeastSquaresClassifier\n"
        "from embiggen_tpu_torch import edge_prediction_evaluation\n"
        "from embiggen_tpu_torch.graph import erdos_renyi\n"
        "from embiggen_tpu_torch.models import get_model_from_library\n"
        "from embiggen_tpu_torch.models.registry import find_available_models\n"
        "from embiggen_tpu_torch.models.edge_prediction import SklearnEdgePredictionAdapter\n"
        "from embiggen_tpu_torch.models.edge_label_prediction import (\n"
        "    SklearnEdgeLabelPredictionAdapter)\n"
        "from embiggen_tpu_torch.models.node_label_prediction import (\n"
        "    SklearnNodeLabelPredictionAdapter)\n"
        "g = erdos_renyi(80, 320, seed=3, n_edge_types=3, n_node_types=4)\n"
        "x = np.random.default_rng(0).standard_normal((80, 6)).astype(np.float32)\n"
        "m = SklearnEdgePredictionAdapter(LeastSquaresClassifier(), 'Hadamard',\n"
        "                                 use_edge_metrics=True, device='cpu')\n"
        "p = m.fit(g, node_features=x).predict_proba(g)\n"
        "assert p.shape == (g.number_of_directed_edges,) and np.isfinite(p).all()\n"
        "p = SklearnEdgeLabelPredictionAdapter(CentroidClassifier(), use_edge_metrics=True,\n"
        "    device='cpu').fit(g, node_features=x).predict_proba(g)\n"
        "assert p.shape == (g.number_of_directed_edges, 3)\n"
        "p = SklearnNodeLabelPredictionAdapter(LeastSquaresClassifier(), device='cpu').fit(\n"
        "    g, node_features=x).predict_proba(g)\n"
        "assert p.shape == (80, 4) and np.allclose(p.sum(axis=1), 1.0)\n"
        "class Centroids(SklearnEdgePredictionAdapter):\n"
        "    def _default_model_instance(self, random_state, **kwargs):\n"
        "        return CentroidClassifier()\n"
        "rows = edge_prediction_evaluation(1, Centroids(device='cpu'), g,\n"
        "                                  node_features=x, random_state=3)\n"
        "assert [r['evaluation_mode'] for r in rows] == ['train', 'test']\n"
        "for task in ('Edge Prediction', 'Node Label Prediction', 'Edge Label Prediction'):\n"
        "    try:\n"
        "        get_model_from_library('Decision Tree Classifier', task)(device='cpu')\n"
        "        raise AssertionError(task)\n"
        "    except ModuleNotFoundError as e:\n"
        "        assert 'scikit-learn' in str(e) and e.name.startswith('sklearn'), e\n"
        "multi = SklearnNodeLabelPredictionAdapter(CentroidClassifier(), device='cpu')\n"
        "ptr = np.arange(0, 161, 2)\n"
        "import dataclasses\n"
        "ml = dataclasses.replace(g, node_type_ptr=ptr, node_type_ids=(np.arange(160) % 4)\n"
        "                         .astype(np.int32))\n"
        "try:\n"
        "    multi.fit(ml, node_features=x)\n"
        "    raise AssertionError('multilabel')\n"
        "except RuntimeError as e:\n"
        "    assert isinstance(e.__cause__, ModuleNotFoundError), e\n"
        "assert len(find_available_models('Edge Prediction')) == 27\n"
        "from embiggen_tpu_torch.models.embedders import HOPE\n"
        "from embiggen_tpu_torch.similarities import DAGResnik\n"
        "assert HOPE(embedding_size=3, device='cpu').fit_transform(g).node_embeddings[0]"
        ".shape == (80, 3)\n"
        "from embiggen_tpu_torch.graph import Graph\n"
        "dag = Graph.from_edge_arrays([1, 2, 3], [0, 0, 1], n_nodes=4, directed=True)\n"
        "try:\n"
        "    DAGResnik().fit(dag).get_similarities_from_clique_graph_node_ids(\n"
        "        [0, 1], return_similarities_dataframe=True)\n"
        "    raise AssertionError('dataframe')\n"
        "except ModuleNotFoundError as e:\n"
        "    assert e.name == 'pandas', e\n"
        "from embiggen_tpu_torch.visualizations import GraphVisualizer\n"
        "viz = GraphVisualizer(g, decomposition_method='PCA')\n"
        "try:\n"
        "    viz.fit_nodes(x)\n"
        "    raise AssertionError('PCA')\n"
        "except ImportError as e:\n"
        "    assert e.name.split('.')[0] == 'sklearn', e\n"
        "viz.fit_nodes(x[:, :2])   # no wider than the plot: no decomposition\n"
        "try:\n"
        "    viz.plot_nodes()\n"
        "    raise AssertionError('plot')\n"
        "except ImportError as e:\n"
        "    assert e.name.split('.')[0] == 'matplotlib', e\n"
        "assert all(sys.modules[n] is None\n"
        "           for n in ('jax', 'sklearn', 'pandas', 'matplotlib'))\n"
        "assert not any(m.startswith('embiggen_tpu.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
