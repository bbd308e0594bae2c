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
from embiggen_tpu_torch.graph import Graph
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


@pytest.mark.parametrize("kwargs, item", [
    (dict(change_node_type_weight=4.0), "A6"),
    (dict(change_edge_type_weight=0.25), "A6"),
    (dict(mesh=4), "A13"),
    (dict(checkpoint_dir="ckpt"), "A12"),
    (dict(enable_cache=True), "A12"),
])
def test_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        SkipGram(device="cpu", random_state=0, **kwargs)


def test_embed_graph_rejects_graph_names(tmp_path, monkeypatch):
    """Names it cannot load: unknown ones, corpora with no local file, and
    the typed datasets (node and edge types come with ROADMAP A6)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("EMBIGGEN_DATA_DIR", raising=False)
    with pytest.raises(KeyError, match="Unknown dataset"):
        SkipGram(device="cpu", random_state=0).fit_transform("NoSuchGraph")
    for name in ("Usair97", "Cora"):
        with pytest.raises(FileNotFoundError, match="synthetic_fallback"):
            embed_graph(name, "Node2Vec SkipGram", device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        embed_graph("KarateClub", "Node2Vec SkipGram", device="cpu")


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
    K18's and the randomized SVD's modules among them) on a tiny graph on
    the CPU, import every module of the port and fit both edge
    predictors."""
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
        "for name, d in (('Walklets SkipGram', 4), ('Walklets CBOW', 4),\n"
        "                ('Walklets GloVe', 4), ('Node2Vec GloVe', 5),\n"
        "                ('DeepWalk GloVe', 5), ('Role2Vec', 5)):\n"
        "    r = embed_graph(g, name, device='cpu', smoke_test=True, random_state=0)\n"
        "    assert r.node_embeddings[0].shape == (50, d), name\n"
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
