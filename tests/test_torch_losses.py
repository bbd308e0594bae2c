"""`ops/losses.py` and `utils/normalize_kwargs.py` against embiggen_tpu's:
each loss and distance, and its gradients, within 1e-6 of the JAX
function's on the same seeded inputs; the keyword coercion equal to the
reference's, errors included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.ops import losses as ref_losses
from embiggen_tpu.utils import normalize_kwargs as ref_kwargs
from embiggen_tpu_torch.ops import losses
from embiggen_tpu_torch.utils import normalize_kwargs

TOL = dict(rtol=1e-6, atol=1e-6)
N, P, K, D = 7, 3, 5, 4


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    # The l2 distance's last pair is one point twice, at the 1e-12 floor:
    # there the reference's gradient is 0.
    a = r(N, D)
    return {
        "nce_loss": (r(N, D), r(N, P, D), r(N, P), r(K, D), r(K)),
        "sampled_softmax_loss": (r(N, D), r(N, D), r(N), r(K, D), r(K)),
        "bce_logits_loss": (r(N), (rng.random(N) < 0.5).astype(np.float32)),
        "bce_logits_loss_weighted": (r(N), (rng.random(N) < 0.5).astype(np.float32),
                                     rng.random(N).astype(np.float32)),
        "l1_distance": (r(N, D), r(N, D)),
        "l2_distance": (a, np.concatenate([r(N - 1, D), a[-1:]])),
        "squared_l2_distance": (r(N, D), r(N, D)),
        "margin_loss": (r(N), r(N)),
    }[name]


NAMES = ["nce_loss", "nce_loss_per_sample", "sampled_softmax_loss",
         "sampled_softmax_loss_per_sample", "bce_logits_loss", "bce_logits_loss_weighted",
         "l1_distance", "l2_distance", "squared_l2_distance", "margin_loss"]


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_reference(name):
    fn_name = name.removesuffix("_weighted")
    args = _inputs(fn_name.removesuffix("_per_sample") if "per_sample" in name else name)
    want = getattr(ref_losses, fn_name)(*map(jnp.asarray, args))
    tensors = [torch.tensor(a, requires_grad=True) for a in args]
    got = getattr(losses, fn_name)(*tensors)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    grads = jax.grad(lambda *a: getattr(ref_losses, fn_name)(*a).sum(),
                     argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    got.sum().backward()
    for t, g in zip(tensors, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


CASES = [
    {"embedding_size": 8.0, "epochs": "3", "learning_rate": 1, "normalize": "yes",
     "verbose": 0, "max_neighbours": None, "random_state": 4, "unknown": [1]},
    {"return_weight": "0.5", "use_scale_free_distribution": "False", "window_size": 3},
    {"batch_size": "many"},
    {"learning_rate": "fast"},
    {"enable_cache": 2.5},
]


@pytest.mark.parametrize("kwargs", CASES)
def test_normalize_kwargs_matches_reference(kwargs):
    try:
        want = ref_kwargs.normalize_kwargs(dict(kwargs))
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            normalize_kwargs.normalize_kwargs(dict(kwargs))
        assert str(err.value) == str(e)
        return
    got = normalize_kwargs.normalize_kwargs(dict(kwargs))
    assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]


def test_schema_matches_reference():
    assert normalize_kwargs.NORMALIZATION_SCHEMA == ref_kwargs.NORMALIZATION_SCHEMA


@pytest.mark.parametrize("value, layers, kind", [
    (3, 2, int), (0.5, 3, float), ([1, 2.0], 2, int), ((4, 5, 6), 3, float), ([1], 2, int)])
def test_normalize_model_list_parameter_matches_reference(value, layers, kind):
    try:
        want = ref_kwargs.normalize_model_list_parameter(value, layers, kind)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            normalize_kwargs.normalize_model_list_parameter(value, layers, kind)
        return
    got = normalize_kwargs.normalize_model_list_parameter(value, layers, kind)
    assert got == want and [type(v) for v in got] == [type(v) for v in want]
