"""K14's plain versions, the siamese and LINE batch samplers
(`ops.negatives.siamese_mini_batch_plain`, `line_mini_batch_plain`), on the
CPU against their exact laws (`tests/batch_laws.py`) by chi-square (fail at
p < 1e-3, fixed seeds), on small weighted and unweighted graphs: positives
uniform over the arcs, the corrupted nodes and the coin, the edge types,
and LINE's negatives with and without the one unchecked redraw of
`avoid_false_negatives`. Weights play no part in either law. Then a fit's
workspace (`BatchDraws`): one block for every batch, one key and a new
counter offset a batch."""
import dataclasses

import numpy as np
import pytest
import torch

from batch_laws import (
    arc_ids, draw_law, exact_p, line_negative_law, line_negative_law_by_source, rows_p,
    siamese_counts,
)
from embiggen_tpu_torch.graph import erdos_renyi
from embiggen_tpu_torch.ops.negatives import (
    BatchDraws, line_mini_batch, line_mini_batch_plain, siamese_mini_batch,
    siamese_mini_batch_plain,
)

torch.set_num_threads(1)
P_MIN = 1e-3


def _graph(weighted, typed=False, n=200, m=800, with_sources=True):
    g = erdos_renyi(n, m, seed=7, weighted=weighted)
    if typed:
        g = dataclasses.replace(g, edge_types=(np.arange(g.number_of_directed_edges) % 5)
                                .astype(np.int32))
    return g, g.device("cpu", with_sources=with_sources)


def _arc_uniform_p(tg, src, dst):
    ids = arc_ids(tg, src, dst)
    observed = torch.bincount(ids, minlength=tg.n_arcs).numpy()
    return exact_p(observed, np.full(tg.n_arcs, src.numel() / tg.n_arcs))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("scale_free", [True, False])
@pytest.mark.parametrize("with_sources", [True, False])
def test_siamese_batch_law(weighted, scale_free, with_sources):
    g, tg = _graph(weighted, with_sources=with_sources)
    batch = siamese_mini_batch_plain(tg, torch.Generator().manual_seed(1), 100_000,
                                     scale_free, with_edge_types=False)
    assert len(batch) == 4 and all(t.dtype == torch.int32 for t in batch)
    assert _arc_uniform_p(tg, batch[0], batch[1]) >= P_MIN
    for name, (observed, expected) in siamese_counts(tg, batch, scale_free).items():
        assert exact_p(observed, expected) >= P_MIN, name


def test_siamese_coin_is_fair():
    """On a 6-node graph the drawn node often equals the side it replaces,
    so the 'neither' cell is large and tested too."""
    g = erdos_renyi(6, 10, seed=1)
    tg = g.device("cpu", with_sources=True)
    batch = siamese_mini_batch_plain(tg, torch.Generator().manual_seed(2), 50_000, True)
    observed, expected = siamese_counts(tg, batch, True)["sides"]
    assert expected[2] > 1000
    assert exact_p(observed, expected) >= P_MIN


@pytest.mark.parametrize("typed", [True, False])
def test_siamese_edge_types(typed):
    g, tg = _graph(False, typed=typed)
    src, dst, csrc, cdst, etype = siamese_mini_batch_plain(
        tg, torch.Generator().manual_seed(3), 20_000, True, with_edge_types=True)
    want = (torch.from_numpy(g.edge_types)[arc_ids(tg, src, dst)] if typed
            else torch.zeros_like(etype))
    assert torch.equal(etype, want)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("scale_free", [True, False])
@pytest.mark.parametrize("avoid", [False, True])
def test_line_batch_law_by_source(weighted, scale_free, avoid):
    """On a dense 60-node graph (degrees near 36) most first draws are arcs
    of their source, so the redraw law is far from the draw law: every
    (source, negative) cell against P(v | s)."""
    g, tg = _graph(weighted, n=60, m=1100)
    k = 5
    src, dst, neg = line_mini_batch_plain(tg, torch.Generator().manual_seed(4), 60_000, k,
                                          scale_free, avoid)
    assert neg.shape == (60_000, k) and neg.dtype == torch.int32
    assert _arc_uniform_p(tg, src, dst) >= P_MIN
    n = tg.n_nodes
    cells = torch.zeros((n, n), dtype=torch.float64)
    cells.index_put_((src.long()[:, None].expand(-1, k).reshape(-1), neg.long().reshape(-1)),
                     torch.ones(neg.numel(), dtype=torch.float64), accumulate=True)
    m = torch.bincount(src.long(), minlength=n).double()
    law = line_negative_law_by_source(tg, scale_free, avoid)
    assert rows_p(cells.numpy(), (k * m[:, None] * law).numpy()) >= P_MIN
    # The marginal law is the same law summed over the slots.
    torch.testing.assert_close((m[:, None] * law).sum(0) / src.numel(),
                               line_negative_law(tg, src, scale_free, avoid))
    if avoid:
        # The redraw law differs from the draw law by far more than the noise.
        plain = (k * m[:, None] * draw_law(tg, scale_free)[None, :]).numpy()
        assert rows_p(cells.numpy(), plain) < 1e-12


def test_line_batch_avoid_removes_arcs():
    """On a sparse graph a negative that is an arc of its source survives
    only if its unchecked redraw is one too: far fewer than without."""
    g, tg = _graph(False)
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    counts = []
    for avoid in (False, True):
        src, _, neg = line_mini_batch_plain(tg, gen(), 50_000, 5, True, avoid)
        pairs = g.has_edges(src.numpy().repeat(5), neg.numpy().reshape(-1))
        counts.append(int(pairs.sum()))
    assert counts[0] > 1000 and counts[1] < counts[0] / 10


@pytest.mark.parametrize("sampler", ["line", "siamese"])
def test_workspace_steps_draw_new_batches_that_a_seed_repeats(sampler):
    """Successive batches on one workspace (`BatchDraws`) differ, each is
    written into the workspace's block (LINE's src, dst and neg [B, K] as
    views of it in that order, the siamese rows as the block itself), the
    same seed repeats the batches, and another seed does not."""
    _, tg = _graph(False, typed=True)
    b, k = 500, 3

    def batches(seed):
        gen = torch.Generator().manual_seed(seed)
        ws = BatchDraws.line(b, k, "cpu") if sampler == "line" else BatchDraws.siamese(
            b, True, "cpu")
        out = []
        for _ in range(3):
            if sampler == "line":
                src, dst, neg = line_mini_batch(tg, gen, b, k, True, True, workspace=ws)
                assert torch.equal(torch.cat([src, dst, neg.reshape(-1)]), ws.block)
                assert src.data_ptr() == ws.block.data_ptr() and neg.shape == (b, k)
            else:
                block = siamese_mini_batch(tg, gen, b, True, True, workspace=ws)
                assert block.data_ptr() == ws.block.data_ptr() and block.shape == (5, b)
            out.append(ws.block.clone())
        return out

    first = batches(9)
    assert all(torch.equal(x, y) for x, y in zip(first, batches(9)))
    assert not torch.equal(first[0], first[1]) and not torch.equal(first[1], first[2])
    assert not torch.equal(batches(10)[0], first[0])


def test_workspace_draws_one_key_and_a_new_offset_a_batch():
    """The card's draws on a workspace: the Philox key is drawn from the
    fit's generator once, at the first batch, so it follows the seed; each
    batch takes the next counter offset."""
    def seeds(seed):
        ws, gen = BatchDraws.line(8, 2, "cpu"), torch.Generator().manual_seed(seed)
        return [ws.seed(gen) for _ in range(4)]

    first = seeds(4)
    assert first == seeds(4)
    assert [offset for _, offset in first] == [0, 1, 2, 3]
    assert len({key for key, _ in first}) == 1
    assert seeds(5)[0][0] != first[0][0]


def test_wrappers_take_the_plain_version_on_the_cpu():
    _, tg = _graph(False, typed=True)
    a = siamese_mini_batch(tg, torch.Generator().manual_seed(6), 500, True, True)
    b = siamese_mini_batch_plain(tg, torch.Generator().manual_seed(6), 500, True, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = line_mini_batch(tg, torch.Generator().manual_seed(7), 500, 3, False, True)
    b = line_mini_batch_plain(tg, torch.Generator().manual_seed(7), 500, 3, False, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_wrappers_raise_off_cpu_and_cuda():
    _, tg = _graph(False)
    meta = dataclasses.replace(tg, col_idx=tg.col_idx.to("meta"))
    with pytest.raises(ValueError, match="meta"):
        siamese_mini_batch(meta, torch.Generator(), 10)
    with pytest.raises(ValueError, match="meta"):
        line_mini_batch(meta, torch.Generator(), 10, 2)


def test_chip_smoke_k14_statistics():
    """The helpers `chip_smoke.py` holds K14 to on the card, run here on the
    plain versions: the script finds `batch_laws` as the tests do, its
    corrupted nodes are the ones the law counts, and its arc-id bins hold
    every positive."""
    import sys
    from pathlib import Path

    import batch_laws

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    assert chip_smoke.laws_module("batch_laws") is batch_laws
    _, tg = _graph(False)
    batch = siamese_mini_batch_plain(tg, torch.Generator().manual_seed(8), 20_000, True)
    observed, _ = siamese_counts(tg, batch, True)["corrupted nodes"]
    np.testing.assert_array_equal(
        torch.bincount(chip_smoke.corrupted_nodes(batch).long(), minlength=tg.n_nodes).numpy(),
        observed[:-1])
    counts, expected = chip_smoke.arc_bin_counts(arc_ids(tg, batch[0], batch[1]), tg.n_arcs)
    assert counts.sum() == 20_000 and np.isclose(expected.sum(), 20_000)
    assert exact_p(counts, expected) >= P_MIN
