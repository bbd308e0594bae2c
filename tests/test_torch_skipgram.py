"""The port's SkipGram step on the CPU against embiggen_tpu: the plain
versions of K3 (banded NCE gradients, and their update into per-node sums)
and K4 (per-row mean scatter, and SkipGram's combine), and three whole
steps on injected batches from the same starting tables. Inputs are made
with numpy and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embiggen_tpu.models.embedders.walk_based import SkipGram as RefSkipGram
from embiggen_tpu.models.embedders.walk_based import _mean_scatter
from embiggen_tpu.ops.walks import random_walks as ref_random_walks
from embiggen_tpu_torch.graph import Graph
from embiggen_tpu_torch.models.embedders import SkipGram
from embiggen_tpu_torch.ops.scatter import SkipGramSums, mean_scatter, skipgram_mean_combine
from embiggen_tpu_torch.ops.skipgram import skipgram_nce_grads_plain, skipgram_nce_update
from embiggen_tpu_torch.utils.convert import skipgram_params_from_jax

torch.set_num_threads(1)


def _inputs(seed, n=60, d=16, b=12, length=16, k=5, bias_scale=1.0):
    rng = np.random.default_rng(seed)
    return dict(
        node_embedding=(0.3 * rng.normal(size=(n, d))).astype(np.float32),
        context_embedding=(0.3 * rng.normal(size=(n, d))).astype(np.float32),
        context_bias=(bias_scale * rng.normal(size=n)).astype(np.float32),
        walks=rng.integers(0, n, (b, length)).astype(np.int32),
        negs=rng.integers(0, n, (b, k)).astype(np.int32),
        center_w=rng.uniform(0, 2, (b, length)).astype(np.float32),
    )


@pytest.mark.parametrize("with_center_w", [False, True])
@pytest.mark.parametrize("window, bias_scale", [(3, 1.0), (2, 8.0)])
def test_nce_grads_match_reference(with_center_w, window, bias_scale):
    """bias_scale 8 drives about half the scores past the +-6 clip."""
    x = _inputs(0, bias_scale=bias_scale)
    length = x["walks"].shape[1]
    ref = RefSkipGram(embedding_size=16, walk_length=length,
                      window_size=window, random_state=0)
    params = {k: jnp.asarray(x[k]) for k in
              ("node_embedding", "context_embedding", "context_bias")}
    cw = x["center_w"] if with_center_w else None
    want_loss, want_rows, want_negs = ref._gathered_grads(
        lambda name, i: params[name][i], jnp.asarray(x["walks"]),
        jnp.asarray(x["negs"]), None if cw is None else jnp.asarray(cw),
    )
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    loss, rows, negs = skipgram_nce_grads_plain(
        t["node_embedding"], t["context_embedding"], t["context_bias"],
        t["walks"], t["negs"], window, 6.0,
        None if cw is None else t["center_w"],
    )
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), rtol=1e-5)
    for got, want in zip(rows + negs, want_rows + want_negs):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def _ref_scatter(table, idx, grads, lr, counts=None):
    out, c = _mean_scatter(
        jnp.asarray(table),
        tuple(jnp.asarray(i) for i in idx) if isinstance(idx, tuple) else jnp.asarray(idx),
        tuple(jnp.asarray(g) for g in grads) if isinstance(grads, tuple) else jnp.asarray(grads),
        jnp.float32(lr),
        counts=None if counts is None else jnp.asarray(counts),
    )
    return np.asarray(out), np.asarray(c)


def _port_scatter(table, idx, grads, lr, counts=None):
    conv = (lambda v: tuple(torch.from_numpy(a) for a in v)
            if isinstance(v, tuple) else torch.from_numpy(v))
    t = torch.from_numpy(table.copy())
    out, c = mean_scatter(t, conv(idx), conv(grads), lr,
                          counts=None if counts is None else torch.from_numpy(counts))
    assert out is t   # the port updates in place
    return out.numpy(), c.numpy()


@pytest.mark.parametrize("n_rows", [1000, 40])   # small / large multiset branch
@pytest.mark.parametrize("width", [None, 8])     # bias [N] / table [N, D]
def test_mean_scatter_matches_reference(n_rows, width):
    rng = np.random.default_rng(n_rows)
    shape = (n_rows,) if width is None else (n_rows, width)
    table = rng.normal(size=shape).astype(np.float32)
    idx = (rng.integers(0, n_rows, 50).astype(np.int32),
           rng.integers(0, n_rows, 30).astype(np.int32))
    grads = tuple(rng.normal(size=(len(i),) + shape[1:]).astype(np.float32)
                  for i in idx)
    want, want_counts = _ref_scatter(table, idx, grads, 0.05)
    got, counts = _port_scatter(table, idx, grads, 0.05)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(counts, want_counts)
    # Shared counts (as context_bias reuses context_embedding's) and a single
    # segment.
    want, _ = _ref_scatter(table, idx[0], grads[0], 0.1, counts=want_counts)
    got, again = _port_scatter(table, idx[0], grads[0], 0.1, counts=counts)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(again, counts)


def _batch(case, rng, step, karate, dg):
    """(walks [20, 12], negs [20, 5], center_w or None) for one step."""
    if case == "karate walks":
        walks = np.array(ref_random_walks(
            dg, jnp.asarray(rng.integers(0, 34, 20), jnp.int32), 12,
            jnp.asarray([0, step], jnp.uint32)))
        return walks, rng.integers(0, 34, (20, 5)).astype(np.int32), None
    walks = rng.integers(0, 33, (20, 12)).astype(np.int32)
    negs = rng.integers(0, 33, (20, 5)).astype(np.int32)
    if case == "context and negative":
        # Each walk's first negatives are nodes of its own band.
        negs[:, 0] = walks[:, 4]
        negs[:, 1] = walks[:, 7]
    elif case == "node only before w":
        # Node 33 sits only at positions 0 .. w - 1: never a centre, a
        # context of the first centres only, never a negative.
        walks[::3, 0] = 33
        walks[1::4, 2] = 33
    cw = (rng.uniform(0, 2, (20, 12)).astype(np.float32)
          if case == "center_w" else None)
    return walks, negs, cw


@pytest.mark.parametrize("case", ["karate walks", "context and negative",
                                  "node only before w", "center_w"])
def test_injected_steps_match_reference(karate, case):
    """Three SkipGram steps on the same (walks, negatives) batches, from the
    same tables carried across with skipgram_params_from_jax, through one
    set of sums (zero again after each step)."""
    kw = dict(embedding_size=16, walk_length=12, window_size=3,
              number_of_negative_samples=5, random_state=0)
    ref = RefSkipGram(**kw)
    params = ref._init_params(karate, jnp.zeros(2, jnp.uint32))
    port = SkipGram(device="cpu", **kw)
    ours = skipgram_params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}, "cpu")
    sums = port._new_sums(ours)
    tg = Graph(row_ptr=karate.row_ptr, col_idx=karate.col_idx).device("cpu")
    rng = np.random.default_rng(1)
    dg = karate.device()
    for step, lr in enumerate((0.05, 0.04, 0.03)):
        walks, negs, cw = _batch(case, rng, step, karate, dg)
        loss, row_g, neg_g = ref._gathered_grads(
            lambda name, i: params[name][i], jnp.asarray(walks),
            jnp.asarray(negs), None if cw is None else jnp.asarray(cw))
        params = ref._apply_table_grads(
            dict(params), jnp.asarray(walks).reshape(-1),
            tuple(g.reshape((-1,) + g.shape[2:]) for g in row_g),
            jnp.asarray(negs).reshape(-1),
            tuple(g.reshape((-1,) + g.shape[2:]) for g in neg_g),
            jnp.float32(lr), mean_scatter=_mean_scatter,
        )
        port._center_weights = lambda tg, walks, gen, cw=cw: (
            None if cw is None else torch.from_numpy(cw))
        got_loss = port._step(
            tg, ours, torch.Generator(), lr,
            batch=(torch.from_numpy(walks), torch.from_numpy(negs)), sums=sums)
        np.testing.assert_allclose(float(got_loss), float(loss) / (20 * 6),
                                   rtol=1e-5)
        for name, table in ours.items():
            np.testing.assert_allclose(table.numpy(), np.asarray(params[name]),
                                       atol=1e-5, err_msg=f"{name} step {step}")
        assert all(not bool(t.any()) for t in sums.buffers())


def test_params_from_jax():
    params = {"node_embedding": np.ones((3, 2), np.float64),
              "context_embedding": np.zeros((3, 2), np.float32),
              "context_bias": np.arange(3, dtype=np.float32)}
    got = skipgram_params_from_jax(params, "cpu")
    assert all(t.dtype == torch.float32 for t in got.values())
    np.testing.assert_array_equal(got["context_bias"].numpy(), [0, 1, 2])
    with pytest.raises(KeyError):
        skipgram_params_from_jax({"node_embedding": params["node_embedding"]},
                                 "cpu")


@pytest.mark.parametrize("wrapper", ["update_weighted", "update", "combine", "mean_scatter"])
def test_kernel_wrappers_raise_off_cpu_and_cuda(wrapper):
    x = {k: torch.from_numpy(v).to("meta") for k, v in _inputs(2).items()}
    tables = (x["node_embedding"], x["context_embedding"], x["context_bias"])
    sums = SkipGramSums.zeros(60, 16, "meta")
    call = {
        "update_weighted": lambda: skipgram_nce_update(
            *tables, x["walks"], x["negs"], 3, 6.0, sums, x["center_w"]),
        "update": lambda: skipgram_nce_update(*tables, x["walks"], x["negs"], 3, 6.0, sums),
        "combine": lambda: skipgram_mean_combine(*tables, sums, 0.1),
        "mean_scatter": lambda: mean_scatter(x["context_bias"], x["walks"].reshape(-1),
                                             x["center_w"].reshape(-1), 0.1),
    }[wrapper]
    with pytest.raises(ValueError, match="meta"):
        call()


def test_update_and_combine_are_the_plain_mean_scatter():
    """On the CPU, the step's two calls take the same float operations as
    the gradients followed by mean_scatter on each table, so they agree
    exactly."""
    x = _inputs(3)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    tables = [t[k].clone() for k in ("node_embedding", "context_embedding", "context_bias")]
    sums = SkipGramSums.zeros(60, 16, "cpu")
    loss = skipgram_nce_update(*tables, t["walks"], t["negs"], 3, 6.0, sums, t["center_w"])
    skipgram_mean_combine(*tables, sums, 0.05)
    want_loss, (g_w, g_c, g_b), (g_neg, g_nb) = skipgram_nce_grads_plain(
        t["node_embedding"], t["context_embedding"], t["context_bias"], t["walks"],
        t["negs"], 3, 6.0, t["center_w"])
    flat, negs = t["walks"].reshape(-1), t["negs"].reshape(-1)
    want = [t[k].clone() for k in ("node_embedding", "context_embedding", "context_bias")]
    mean_scatter(want[0], flat, g_w.reshape(-1, 16), 0.05)
    _, counts = mean_scatter(want[1], (flat, negs), (g_c.reshape(-1, 16), g_neg.reshape(-1, 16)), 0.05)
    mean_scatter(want[2], (flat, negs), (g_b.reshape(-1), g_nb.reshape(-1)), 0.05, counts=counts)
    assert float(loss) == float(want_loss)
    for got, w in zip(tables, want):
        assert torch.equal(got, w)
    assert all(not bool(b.any()) for b in sums.buffers())


def test_sums_check_shapes():
    sums = SkipGramSums.zeros(60, 16, "cpu")
    sums.check(60, 16, torch.device("cpu"))
    with pytest.raises(ValueError, match="sums_w"):
        sums.check(60, 8, torch.device("cpu"))
    with pytest.raises(ValueError, match="counts_w"):
        SkipGramSums(sums.sums_w, sums.sums_c, sums.sums_b, sums.counts_w[:5],
                     sums.counts_c).check(60, 16, torch.device("cpu"))


@pytest.mark.parametrize("kernel", ["K3", "K11", "K9"])
def test_phase_clock_build_is_its_own_library(monkeypatch, kernel):
    """The clock-stamped build of the kernels never replaces the default one:
    each kernel's `phase_split` launches from the PHASE_CLOCK library, counted
    nowhere, with a clocks buffer; its wrapper from the default library."""
    from embiggen_tpu_torch.graph import erdos_renyi
    from embiggen_tpu_torch.ops import _build, cbow, skipgram, walks

    assert _build.library_path() != _build.library_path(_build.PHASE_CLOCK)
    assert _build.library_path() == _build.library_path(())
    calls = []
    monkeypatch.setattr(_build, "is_cuda", lambda t: True)
    monkeypatch.setattr(_build, "launch", lambda counter, fn, dev, *args, defines=():
                        calls.append((counter, fn, args, defines)))
    x = {k: torch.from_numpy(v) for k, v in _inputs(4).items()}
    tables = (x["node_embedding"], x["context_embedding"], x["context_bias"])
    sums = SkipGramSums.zeros(60, 16, "cpu")
    if kernel == "K9":
        tg = erdos_renyi(60, 300, seed=1).device("cpu", ell_cap=8)
        pq = (tg, x["walks"][:, 0].contiguous(), 8, 2.0, 0.5, 8, torch.Generator())
        split, run = walks.ell_phase_split, walks.ell_walks
        args, phases, fn = pq, walks.ELL_PHASES, "ebt_ell_walks"
    else:
        module = skipgram if kernel == "K3" else cbow
        split = module.phase_split
        run = skipgram_nce_update if kernel == "K3" else cbow.cbow_update
        args = (*tables, x["walks"], x["negs"], 3, 6.0, sums)
        phases = module.PHASES
        fn = "ebt_skipgram_nce" if kernel == "K3" else "ebt_cbow_update"
    # Launches are not run here, so the clocks stay 0 and the shares NaN.
    assert set(split(*args)) == set(phases)
    run(*args)
    (c_split, fn_split, a_split, d_split), (c_run, fn_run, a_run, d_run) = calls
    assert fn_split == fn_run == fn
    assert (c_split, d_split) == (None, _build.PHASE_CLOCK)
    assert c_run is not None and d_run == ()
    # The clocks buffer is the one pointer that differs: None for the wrapper.
    assert sum(a is None for a in a_split) < sum(a is None for a in a_run)
