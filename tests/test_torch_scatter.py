"""K4 standalone's plain version with a workspace (`MeanScatterSums`), on
the CPU, against embiggen_tpu's `_mean_scatter` on the same numpy tables,
ids and gradients: three consecutive steps on one workspace, for one index
set, segment tuples and a 1-d table, with the counts shared from the first
table; and `apply_updates` with workspaces over three steps against the
reference's `apply_updates`; and given counts that miss a named row, refused."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.models.embedders.minibatch import Update as RefUpdate
from embiggen_tpu.models.embedders.minibatch import apply_updates as ref_apply_updates
from embiggen_tpu.models.embedders.walk_based import _mean_scatter
from embiggen_tpu_torch.models.embedders.minibatch import Update, apply_updates
from embiggen_tpu_torch.ops.scatter import MeanScatterSums, mean_scatter

torch.set_num_threads(1)
N, D = 40, 6


def _segments(rng, shape, segmented):
    """(ids, gradients) as numpy: two segments (rows [0, 25) and [15, N)),
    so some rows are touched by one segment only, or one id set."""
    ranges = ((0, 25, 60), (15, N, 30)) if segmented else ((0, N, 70),)
    idx = tuple(rng.integers(lo, hi, m).astype(np.int32) for lo, hi, m in ranges)
    grads = tuple(rng.normal(size=(i.size,) + shape[1:]).astype(np.float32) for i in idx)
    return (idx, grads) if segmented else (idx[0], grads[0])


def _map(x, fn):
    return tuple(fn(v) for v in x) if isinstance(x, tuple) else fn(x)


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("width", [None, D])
def test_workspace_steps_match_reference(segmented, width):
    """Three steps on one workspace: each table after each step equals the
    reference's, the workspace is zero after each call, the call that counts
    into the workspace returns None for its counts, and counts passed in are
    used and left as they were."""
    rng = np.random.default_rng(2 * segmented + (width is None))
    shape = (N,) if width is None else (N, width)
    first = rng.normal(size=shape).astype(np.float32)
    second = rng.normal(size=shape).astype(np.float32)
    ws = MeanScatterSums.zeros(shape, "cpu")
    got_first, got_second = torch.from_numpy(first.copy()), torch.from_numpy(second.copy())
    for lr in (0.05, 0.04, 0.03):
        idx, grads = _segments(rng, shape, segmented)
        first, counts = _mean_scatter(jnp.asarray(first), _map(idx, jnp.asarray),
                                      _map(grads, jnp.asarray), lr)
        second, _ = _mean_scatter(jnp.asarray(second), _map(idx, jnp.asarray),
                                  _map(grads, jnp.asarray), lr, counts)
        t_idx, t_grads = _map(idx, torch.from_numpy), _map(grads, torch.from_numpy)
        table, none = mean_scatter(got_first, t_idx, t_grads, lr, workspace=ws)
        assert table is got_first and none is None
        assert not ws.sums.any() and not ws.counts.any()
        shared = torch.from_numpy(np.asarray(counts).copy())
        _, kept = mean_scatter(got_second, t_idx, t_grads, lr, shared, workspace=ws)
        assert kept is shared
        np.testing.assert_array_equal(shared.numpy(), np.asarray(counts))
        assert not ws.sums.any() and not ws.counts.any()
        for got, want in ((got_first, first), (got_second, second)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_apply_updates_with_workspaces_match_reference():
    """Three steps of two "mean" updates on tables of one shape (one
    workspace serves both) and one of another, against the reference."""
    rng = np.random.default_rng(7)
    tables = {"a": rng.normal(size=(N, D)).astype(np.float32),
              "b": rng.normal(size=(N, D)).astype(np.float32),
              "bias": rng.normal(size=N).astype(np.float32)}
    want = {k: jnp.asarray(v) for k, v in tables.items()}
    params = {k: torch.from_numpy(v.copy()) for k, v in tables.items()}
    workspaces = {}
    for lr in (0.05, 0.04, 0.03):
        ups = [("a", *_segments(rng, (N, D), True)), ("b", *_segments(rng, (N, D), False)),
               ("bias", *_segments(rng, (N,), True))]
        want = ref_apply_updates(
            want, [RefUpdate(k, _map(i, jnp.asarray), _map(g, jnp.asarray), "mean")
                   for k, i, g in ups], jnp.float32(lr))
        apply_updates(params, [Update(k, _map(i, torch.from_numpy), _map(g, torch.from_numpy),
                                      "mean") for k, i, g in ups], lr, workspaces)
        assert sorted(workspaces) == [(N,), (N, D)]
        assert all(not w.sums.any() and not w.counts.any() for w in workspaces.values())
        for k in tables:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("workspace", [False, True])
def test_given_counts_must_cover_the_multiset(workspace):
    """Counts that leave a named row at 0 are refused, and the table and
    the workspace are left untouched."""
    rng = np.random.default_rng(9)
    idx, grads = _segments(rng, (N, D), True)
    table = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    before = table.clone()
    counts = torch.zeros(N)
    for i in idx:
        counts.index_add_(0, torch.from_numpy(i).long(), torch.ones(i.size))
    counts[int(idx[1][0])] = 0.0
    ws = MeanScatterSums.zeros((N, D), "cpu") if workspace else None
    with pytest.raises(ValueError, match="every row"):
        mean_scatter(table, _map(idx, torch.from_numpy), _map(grads, torch.from_numpy), 0.05,
                     counts, workspace=ws)
    assert torch.equal(table, before)
    assert ws is None or not ws.sums.any()
