"""The port's `Update` protocol on the CPU against embiggen_tpu's
`apply_updates`: add, mean (one index set and segment tuples sharing one
count multiset), dense, and the stacked `(prefix, rows)` form of both
sparse modes, each with repeated rows, from the same numpy tables and
gradients."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.models.embedders.minibatch import Update as RefUpdate
from embiggen_tpu.models.embedders.minibatch import apply_updates as ref_apply_updates
from embiggen_tpu_torch.models.embedders.minibatch import Update, apply_updates, value_and_grad

torch.set_num_threads(1)
N, D = 20, 6


def _case(name, rng):
    """(table name, idx, grad, mode) for one update, as numpy arrays."""
    rows = lambda m: rng.integers(0, N, m).astype(np.int32)  # noqa: E731
    grad = lambda m, *w: rng.normal(size=(m,) + w).astype(np.float32)  # noqa: E731
    if name == "add":
        return "table", rows(50), grad(50, D), "add"
    if name == "mean":
        return "table", rows(50), grad(50, D), "mean"
    if name == "mean 1-d":
        return "bias", rows(50), grad(50), "mean"
    if name == "mean segments":
        return "table", (rows(40), rows(15)), (grad(40, D), grad(15, D)), "mean"
    if name == "dense":
        return "dense", None, grad(4, 5), "dense"
    if name == "stacked mean":
        return "stack", (1, rows(50)), grad(50, D), "mean"
    if name == "stacked add":
        return "stack", (2, rows(50)), grad(50, D), "add"
    if name == "stacked mean segments":
        return "stack", (0, (rows(30), rows(30))), (grad(30, D), grad(30, D)), "mean"
    raise KeyError(name)


def _map(x, fn):
    if x is None or isinstance(x, int):
        return x
    if isinstance(x, tuple):
        return tuple(_map(v, fn) for v in x)
    return fn(x)


CASES = ["add", "mean", "mean 1-d", "mean segments", "dense", "stacked mean",
         "stacked add", "stacked mean segments"]


@pytest.mark.parametrize("case", CASES)
def test_apply_updates_matches_reference(case):
    rng = np.random.default_rng(CASES.index(case))
    tables = {"table": rng.normal(size=(N, D)).astype(np.float32),
              "bias": rng.normal(size=N).astype(np.float32),
              "stack": rng.normal(size=(3, N, D)).astype(np.float32),
              "dense": rng.normal(size=(4, 5)).astype(np.float32)}
    name, idx, grad, mode = _case(case, rng)
    want = ref_apply_updates(
        {k: jnp.asarray(v) for k, v in tables.items()},
        [RefUpdate(name, _map(idx, jnp.asarray), _map(grad, jnp.asarray), mode)],
        jnp.float32(0.05))
    params = {k: torch.from_numpy(v.copy()) for k, v in tables.items()}
    before = {k: v for k, v in params.items()}
    got = apply_updates(
        params, [Update(name, _map(idx, torch.from_numpy), _map(grad, torch.from_numpy), mode)],
        0.05)
    assert got is params
    for k in tables:
        # In place: the same tensors hold the new tables.
        assert got[k] is before[k]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{case}: {k}")
    changed = [k for k in tables if not np.array_equal(got[k].numpy(), tables[k])]
    assert changed == [name]


def test_updates_apply_in_order():
    """Two updates of one table in one list: the second sees the first."""
    rng = np.random.default_rng(9)
    table = rng.normal(size=(N, D)).astype(np.float32)
    ups = [("table", rng.integers(0, N, 30).astype(np.int32),
            rng.normal(size=(30, D)).astype(np.float32), mode) for mode in ("mean", "add")]
    want = ref_apply_updates({"table": jnp.asarray(table)},
                             [RefUpdate(n, jnp.asarray(i), jnp.asarray(g), m) for n, i, g, m in ups],
                             jnp.float32(0.1))
    got = apply_updates({"table": torch.from_numpy(table.copy())},
                        [Update(n, torch.from_numpy(i), torch.from_numpy(g), m)
                         for n, i, g, m in ups], 0.1)
    np.testing.assert_allclose(got["table"].numpy(), np.asarray(want["table"]),
                               rtol=1e-5, atol=1e-6)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        apply_updates({"t": torch.zeros(3, 2)},
                      [Update("t", torch.zeros(1, dtype=torch.int32), torch.ones(1, 2), "max")],
                      0.1)


def test_value_and_grad_leaves_the_inputs_alone():
    x = torch.arange(3.0)
    loss, (g,) = value_and_grad(lambda a: (a ** 2).sum(), [x])
    assert float(loss) == 5.0 and torch.equal(g, 2 * x)
    assert not x.requires_grad and not loss.requires_grad
