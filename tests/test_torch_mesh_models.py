"""Multi-device training through the port's entry points on gloo ranks
(P = 2 and 4 CPU processes, `tests/dist_ranks.py`), the mirror of
tests/test_mesh_models.py: every row that accepts `mesh` matches the port's
own single-device fit with the same seed (torch and jax draw different
streams, so the JAX fits are no reference here), within the reference
test's tolerances; the fallback warning; the edge GCN with and without
dropout; and `supports_distribution` on every registered row.

RotatE trains data-parallel and row-sharded, NodePiece data-parallel, and
asked for rows NodePiece warns and trains data-parallel, as the reference's
`test_nodepiece_rows_falls_back_to_data`. The node-label GCN's mesh fit is
held to one device in tests/test_torch_label_gcn.py."""
import inspect

import numpy as np
import pytest

from embiggen_tpu.models import registry as ref_registry
from embiggen_tpu_torch.models import MODELS_LIBRARY

import dist_ranks

WORLDS = (2, 4)
# tests/test_mesh_models.py's data-parallel tolerance: sums in another order.
DATA_TOL = dict(rtol=2e-5, atol=2e-6)
# The row-sharded walk models apply the same float operations in the same
# order as one device: bit-equal. Row-sharded GloVe multiplies its
# gradients by -lr before the scatter where one device's index_add_ scales
# inside it: the reference's row tolerance. LINE's and TransE's owned mean
# scatter scales each gradient by 1 / count before adding where one device
# sums first (as the reference's owned scatter does): the data-parallel
# tolerance.
EXACT_ROWS = {"SkipGram rows", "CBOW rows"}
ROWS_TOL = dict(rtol=1e-5, atol=1e-7)
FIT_LABELS = [label for label, *_ in dist_ranks.MESH_FITS]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"P{w}")
def fits(request, tmp_path_factory):
    world = request.param
    return world, dist_ranks.spawn("models", world, tmp_path_factory.mktemp("models"))


_SINGLE = {}


def _single_device(label):
    if label not in _SINGLE:
        fit = next(f for f in dist_ranks.MESH_FITS if f[0] == label)
        _SINGLE[label] = dist_ranks.mesh_fit(*fit)
    return _SINGLE[label]


@pytest.mark.parametrize("label", FIT_LABELS)
def test_mesh_fit_matches_single_device(fits, label):
    world, ranks = fits
    want = _single_device(label)
    got = ranks[0][label]
    if label in EXACT_ROWS:
        np.testing.assert_array_equal(got, want)
    elif label == "GloVe rows":
        np.testing.assert_allclose(got, want, **ROWS_TOL)
    else:
        np.testing.assert_allclose(got, want, **DATA_TOL)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[label], got)


def test_unsupported_model_falls_back_with_warning(fits):
    world, ranks = fits
    messages, emb = ranks[0]["fallback"]
    assert any("falling back to single-device" in m for m in messages), messages
    assert np.isfinite(emb).all()


def test_nodepiece_rows_falls_back_to_data(fits):
    """NodePiece stores no [N] table: asked for rows it warns and trains
    data-parallel, the same fit as its data-parallel one."""
    world, ranks = fits
    messages, emb = ranks[0]["NodePiece rows"]
    assert any("no node-row tables" in m for m in messages), messages
    np.testing.assert_allclose(emb, ranks[0]["NodePiece data"], **DATA_TOL)


@pytest.mark.parametrize("dropout_rate", [0.0, 0.5])
def test_gcn_edge_prediction_mesh_matches_single_device(fits, dropout_rate):
    """Every rank draws the same batches and dropout masks, so with or
    without dropout the halo-exchange fit is the single-device fit up to
    the order of float sums."""
    world, ranks = fits
    want, model = dist_ranks.gcn_fit(dropout_rate)
    got, got_history = ranks[0][f"gcn dropout {dropout_rate}"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_history, model._history, rtol=1e-5)
    assert np.isfinite(got_history).all() and got_history[-1] < got_history[0]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"gcn dropout {dropout_rate}"][0], got)


def test_every_registered_sgd_embedder_supports_mesh():
    """Every registered port embedder that takes `mesh` supports
    distribution, as in the reference."""
    for name, libs in MODELS_LIBRARY["Node Embedding"].items():
        if "Torch" not in libs:   # the "Non Existent Model" stub
            continue
        cls = libs["Torch"]
        sig = inspect.signature(cls.__init__)
        takes_mesh = "mesh" in sig.parameters or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values())
        if hasattr(cls, "supports_distribution") and takes_mesh:
            ref = next(iter(ref_registry.MODELS_LIBRARY["Node Embedding"][name].values()))
            assert cls.supports_distribution() == ref.supports_distribution(), name
