"""Mid-training checkpoints of the port (`embiggen_tpu_torch.utils.checkpoint`)
against the JAX package's, on the CPU.

Each resume test runs the JAX package's scenario (`tests/test_utils_extras.py`:
kill a checkpointed fit after N saves by wrapping `save_pytree`, then resume
it) through both packages: the resumed fit's tables (the GCNs' parameters and
loss history) equal the uninterrupted fit's bit for bit, and the completed
fit leaves no checkpoint behind. The stale-checkpoint test, the pytree round
trip and the mesh resume (SkipGram on 2 gloo ranks, row-sharded, as
`tests/test_torch_mesh_models.py` runs its ranks) complete the file."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import dist_ranks

WALK_KW = dict(embedding_size=8, epochs=4, batch_size=16, walk_length=8, window_size=2,
               number_of_negative_samples=4, random_state=7, early_stopping_patience=100)
LINE_KW = dict(embedding_size=8, epochs=4, batch_size=32, random_state=7,
               early_stopping_patience=100)
GLOVE_KW = dict(embedding_size=8, epochs=4, walk_length=8, window_size=2, iterations=1,
                batch_size=64, random_state=7, early_stopping_patience=100)
GCN_KW = dict(units=[8], tower_units=[8], head_units=[8], epochs=6, batch_size=64,
              random_state=3, checkpoint_interval=1, early_stopping_patience=100)
NODE_GCN_KW = dict(units=[8], head_units=[8], epochs=6, random_state=3,
                   checkpoint_interval=1, early_stopping_patience=100)

# (module, class name, keyword arguments, graph, saves before the kill)
CASES = {
    "SkipGram": ("embedders", "SkipGram", WALK_KW, "karate", 2),
    "CBOW p/q": ("embedders", "CBOW", dict(WALK_KW, return_weight=2.0, explore_weight=0.5),
                 "karate", 2),
    "FirstOrderLINE": ("embedders", "FirstOrderLINE", LINE_KW, "karate", 2),
    "TransE": ("embedders", "TransE", LINE_KW, "typed", 2),
    "GloVe": ("embedders", "GloVe", GLOVE_KW, "karate", 2),
    "GCNEdgePrediction": ("gcn", "GCNEdgePrediction", GCN_KW, "karate", 3),
    "GCNEdgeLabelPrediction": ("gcn", "GCNEdgeLabelPrediction", GCN_KW, "typed", 3),
    "KipfGCNNodeLabelPrediction": ("gcn", "KipfGCNNodeLabelPrediction", NODE_GCN_KW,
                                   "karate", 3),
}


class _KillAfter:
    """`save_pytree` that raises after `n_saves` saves, each completed
    first: a kill between epochs."""

    def __init__(self, real, n_saves):
        self.real = real
        self.left = n_saves

    def __call__(self, path, tree, **kw):
        self.real(path, tree, **kw)
        self.left -= 1
        if self.left <= 0:
            raise KeyboardInterrupt("simulated kill")


def _graph(package, name):
    g = package.graph.karate_club()
    if name == "typed":
        clubs = g.get_single_label_node_type_ids()
        g = dataclasses.replace(
            g, edge_types=(clubs[g.sources] != clubs[g.col_idx]).astype(np.int32))
    return g


def _port():
    import embiggen_tpu_torch
    import embiggen_tpu_torch.models.embedders
    import embiggen_tpu_torch.models.gcn
    import embiggen_tpu_torch.utils.checkpoint as ck

    return embiggen_tpu_torch, ck, {"device": "cpu"}


def _reference():
    import embiggen_tpu
    import embiggen_tpu.models.embedders
    import embiggen_tpu.models.gcn
    import embiggen_tpu.utils.checkpoint as ck

    return embiggen_tpu, ck, {}


def _leaves(tree):
    """A parameter tree's leaves as numpy, in one order for both packages
    (dict keys sorted, as jax flattens them)."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for item in tree for a in _leaves(item)]
    return [np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)]


def _fit(package, device_kw, module, cls_name, kw, graph, **extra):
    """The fit's result as a list of arrays: the node embeddings, or the
    GCN's parameters and loss history."""
    cls = getattr(getattr(package.models, module), cls_name)
    model = cls(**kw, **device_kw, **extra)
    if module == "embedders":
        return [np.asarray(e) for e in model.fit_transform(graph).node_embeddings]
    model.fit(graph)
    return _leaves(model._params) + [np.asarray(model._history)]


def _kill_and_resume(monkeypatch, tmp_path, which, case):
    """(uninterrupted, resumed, files after the kill, files after the
    resumed fit) of one case through `which` package."""
    module, cls_name, kw, graph_name, saves = CASES[case]
    package, ck, device_kw = which()
    graph = _graph(package, graph_name)
    full = _fit(package, device_kw, module, cls_name, kw, graph)
    directory = str(tmp_path / "ck")
    monkeypatch.setattr(ck, "save_pytree", _KillAfter(ck.save_pytree, saves))
    with pytest.raises(KeyboardInterrupt):
        _fit(package, device_kw, module, cls_name, kw, graph, checkpoint_dir=directory)
    monkeypatch.undo()
    after_kill = sorted(os.listdir(directory))
    resumed = _fit(package, device_kw, module, cls_name, kw, graph, checkpoint_dir=directory)
    return full, resumed, after_kill, sorted(os.listdir(directory))


@pytest.mark.parametrize("case", list(CASES))
def test_kill_and_resume_bit_identical(case, monkeypatch, tmp_path):
    for label, which in (("port", _port), ("reference", _reference)):
        full, resumed, after_kill, after = _kill_and_resume(
            monkeypatch, tmp_path / label, which, case)
        assert len(after_kill) == 1 and after_kill[0].endswith(".npz"), (label, after_kill)
        assert after == [], (label, after)
        assert len(full) == len(resumed)
        for a, b in zip(full, resumed):
            np.testing.assert_array_equal(a, b, err_msg=label)


def test_trainloop_kill_and_resume_bit_identical(monkeypatch, tmp_path):
    """`TrainLoop` alone on a toy MLP, as the reference's test runs it."""
    import jax
    import jax.numpy as jnp

    import embiggen_tpu.utils.checkpoint as ref_ck
    import embiggen_tpu_torch.utils.checkpoint as ck
    from embiggen_tpu.models.gcn.core import TrainLoop as RefTrainLoop
    from embiggen_tpu.models.gcn.core import init_mlp as ref_init_mlp
    from embiggen_tpu_torch.models.gcn.core import TrainLoop, init_mlp, map_params

    x = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(32, 1)).astype(np.float32)

    def ref_loss(params, key):
        h = jnp.asarray(x)
        for layer in params:
            h = h @ layer["w"] + layer["b"]
        return ((h - jnp.asarray(y)) ** 2).mean()

    ref_params = ref_init_mlp(jax.random.PRNGKey(0), [4, 8, 1])
    port_params = init_mlp([4, 8, 1], torch.Generator().manual_seed(0))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def port_loss(params):
        h = xt
        for layer in params:
            h = h @ layer["w"] + layer["b"]
        return ((h - yt) ** 2).mean()

    def ref_run(**kw):
        return RefTrainLoop(epochs=8, steps_per_epoch=2, **kw).run(
            ref_params, jax.value_and_grad(ref_loss), jax.random.PRNGKey(42))

    def port_run(**kw):
        # `run` trains its tree in place: each run starts from a copy.
        return TrainLoop(epochs=8, steps_per_epoch=2, **kw).run(
            map_params(lambda t: t.clone(), port_params), port_loss)

    for label, run, module, path in (
            ("reference", ref_run, ref_ck, "train_state"), ("port", port_run, ck, "train_state")):
        full, hist_full = run()
        directory = str(tmp_path / label)
        monkeypatch.setattr(module, "save_pytree", _KillAfter(module.save_pytree, 4))
        with pytest.raises(KeyboardInterrupt):
            run(checkpoint_dir=directory, checkpoint_interval=1)
        monkeypatch.undo()
        resumed, hist_res = run(checkpoint_dir=directory, checkpoint_interval=1)
        for a, b in zip(_leaves(full), _leaves(resumed)):
            np.testing.assert_array_equal(a, b, err_msg=label)
        np.testing.assert_array_equal(hist_full, hist_res, err_msg=label)
        assert not module.checkpoint_exists(os.path.join(directory, path)), label


def test_stale_checkpoint_from_other_graph_is_ignored(monkeypatch, tmp_path):
    """A checkpoint left by a killed fit of one graph is ignored, with the
    reference's warning, by a fit of another graph, which returns its own
    graph's embedding."""
    kw = dict(embedding_size=8, epochs=2, batch_size=16, walk_length=8, window_size=2,
              number_of_negative_samples=4, random_state=7)
    for label, which in (("port", _port), ("reference", _reference)):
        package, ck, device_kw = which()
        directory = str(tmp_path / label)
        monkeypatch.setattr(ck, "save_pytree", _KillAfter(ck.save_pytree, 1))
        with pytest.raises(KeyboardInterrupt):
            package.models.embedders.SkipGram(
                **kw, **device_kw, checkpoint_dir=directory).fit_transform(
                    package.graph.karate_club())
        monkeypatch.undo()
        other = package.graph.erdos_renyi(100, 400, seed=3)
        with pytest.warns(UserWarning, match="different model"):
            res = package.models.embedders.SkipGram(
                **kw, **device_kw, checkpoint_dir=directory).fit_transform(other)
        assert res.node_embeddings[0].shape[0] == 100, label


def test_pytree_round_trip(tmp_path):
    """The reference's pytree test through both packages, then the port's
    own leaves: tensors come back with their dtype and bits on the
    template's device, numpy arrays and scalars as arrays; a template of
    another leaf count raises; the orbax backend is refused by name."""
    import jax.numpy as jnp

    from embiggen_tpu.utils import load_pytree as ref_load, save_pytree as ref_save
    from embiggen_tpu_torch.utils import load_pytree, save_pytree

    ref_save(str(tmp_path / "ref"), {"a": jnp.arange(5.0), "b": {"c": jnp.ones((2, 3))}})
    got = ref_load(str(tmp_path / "ref"), like={"a": jnp.zeros(5), "b": {"c": jnp.zeros((2, 3))}})
    save_pytree(str(tmp_path / "port"), {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 3))}})
    mine = load_pytree(str(tmp_path / "port"),
                       like={"a": torch.zeros(5), "b": {"c": torch.zeros((2, 3))}})
    for a, b in ((got["a"], mine["a"]), (got["b"]["c"], mine["b"]["c"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    rng = np.random.default_rng(0)
    tree = {"f": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
            "i": torch.arange(6, dtype=torch.int32), "g": torch.Generator().manual_seed(5).get_state(),
            "list": [np.float64(np.nan), np.int64(7), np.arange(3)], "none": None}
    save_pytree(str(tmp_path / "t"), tree, fingerprint="run")
    back = load_pytree(str(tmp_path / "t"), like=tree)
    tree["step"] = torch.tensor(3.0)   # a 0-d leaf, as Adam's step counts
    save_pytree(str(tmp_path / "t"), tree, fingerprint="run")
    back = load_pytree(str(tmp_path / "t"), like=tree)
    for key in ("f", "i", "g", "step"):
        assert back[key].dtype == tree[key].dtype and back[key].shape == tree[key].shape
        assert torch.equal(back[key], tree[key])
    assert np.isnan(back["list"][0]) and int(back["list"][1]) == 7 and back["none"] is None
    from embiggen_tpu_torch.utils.checkpoint import checkpoint_matches

    assert checkpoint_matches(str(tmp_path / "t"), "run")
    assert not checkpoint_matches(str(tmp_path / "t"), "another run")
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(str(tmp_path / "t"), like={"f": tree["f"]})
    with pytest.raises(ValueError, match="orbax"):
        save_pytree(str(tmp_path / "o"), tree, backend="orbax")


def test_random_state_round_trip():
    """The generators' states and each draws' key and offset (None as -1)
    come back exactly, through `load` for draws made by then and through
    `set_draws` for draws made later."""
    from embiggen_tpu_torch.ops.negatives import BatchDraws
    from embiggen_tpu_torch.utils.checkpoint import RandomState

    g = torch.Generator().manual_seed(3)
    torch.rand(5, generator=g)
    drawn = BatchDraws.line(8, 2, "cpu")
    drawn.key, drawn.offset = 2**61 + 5, 17
    fresh = BatchDraws.edges(8, 0.5, "cpu")      # offset None: not drawn yet
    state = RandomState([g], lambda: [drawn, fresh, None]).state()
    want = torch.rand(5, generator=g)
    g2 = torch.Generator().manual_seed(99)
    d2, f2 = BatchDraws.line(8, 2, "cpu"), BatchDraws.edges(8, 0.5, "cpu")
    RandomState([g2], lambda: [d2, f2, None]).load(state)
    assert torch.equal(torch.rand(5, generator=g2), want)
    assert (d2.key, d2.offset) == (2**61 + 5, 17) and (f2.key, f2.offset) == (None, None)
    later = BatchDraws.line(8, 2, "cpu")
    RandomState.set_draws(later, state["draws"][0])
    assert (later.key, later.offset) == (2**61 + 5, 17)


def test_plateau_state_round_trips_exactly():
    """`state_array` / `load_state_array` carry the controller exactly: a
    copy loaded mid-run decides as the original from there on."""
    from embiggen_tpu_torch.utils.plateau import PlateauController

    losses = [1.0, 0.9995, 0.7, 0.7, 0.69999, 0.5, 0.5, 0.5]
    a = PlateauController(early_stopping_patience=3, learning_rate_plateau_patience=1)
    for loss in losses[:4]:
        a.update(loss)
    b = PlateauController(early_stopping_patience=3, learning_rate_plateau_patience=1)
    b.load_state_array(a.state_array())
    np.testing.assert_array_equal(a.state_array(), b.state_array())
    for loss in losses[4:]:
        assert a.update(loss) == b.update(loss)
        np.testing.assert_array_equal(a.state_array(), b.state_array())


@pytest.mark.parametrize("distribution", ["rows"])
def test_mesh_kill_and_resume_bit_identical(distribution, tmp_path):
    """SkipGram on 2 gloo ranks: every rank saves the full tables' checkpoint
    through rank 0, is killed after the second save, and resumes to the
    uninterrupted mesh fit bit for bit, leaving no checkpoint behind."""
    directory = tmp_path / "ck"
    directory.mkdir()
    ranks = dist_ranks.spawn("resume", 2, tmp_path, payload=dict(
        distribution=distribution, dir=str(directory), saves=2))
    for rank, out in enumerate(ranks):
        assert out["killed"] and out["after_kill"] == ["embed_state.npz"], rank
        assert out["after_resume"] == [], rank
        for a, b in zip(out["full"], out["resumed"]):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {rank}")
