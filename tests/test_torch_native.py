"""The port's native host helpers (`embiggen_tpu_torch.native`): each C++
function against its plain numpy version and against the JAX package's public
Python function on the same inputs — exactly for index and integer outputs,
bitwise for the alias tables, within 1e-12 relative for the AUROC and AUPRC
sweep — and the library's build: a missing compiler raises, and processes
that build it at once each load a whole library."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from embiggen_tpu.graph import Graph as RefGraph
from embiggen_tpu.graph import build_alias_tables as ref_build_alias_tables
from embiggen_tpu.graph.holdouts import spanning_forest_arcs as ref_spanning_forest_arcs
from embiggen_tpu.graph.loaders import from_csv as ref_from_csv
from embiggen_tpu.ops.metrics import all_binary_metrics as ref_all_binary_metrics
from embiggen_tpu_torch import native
from embiggen_tpu_torch.graph import Graph, erdos_renyi, from_csv
from embiggen_tpu_torch.graph.holdouts import spanning_forest_arcs
from embiggen_tpu_torch.ops.metrics import _stable_argsort, all_binary_metrics

REPO = Path(__file__).resolve().parent.parent
SMALL_PPI = REPO / "tests" / "data" / "small_ppi.tsv"


def _pairs(kind, seed=0):
    """(src, dst, n_nodes) of an edge list with the named feature."""
    rng = np.random.default_rng(seed)
    if kind == "components":        # three blocks of ids, no edge between them
        parts = [rng.integers(lo, hi, (2, 300)) for lo, hi in ((0, 40), (40, 90), (90, 100))]
        src, dst = np.concatenate(parts, axis=1)
        return src, dst, 100
    if kind == "self_loops":
        src, dst = rng.integers(0, 60, (2, 400))
        dst[::5] = src[::5]
        return src, dst, 60
    if kind == "isolated":          # ids 70-99 never appear, nor 0-9
        src, dst = rng.integers(10, 70, (2, 300))
        return src, dst, 100
    if kind == "duplicates":        # every pair several times, both directions
        src, dst = rng.integers(0, 30, (2, 120))
        src, dst = np.concatenate([src, dst, src, src]), np.concatenate([dst, src, dst, dst])
        perm = rng.permutation(len(src))
        return src[perm], dst[perm], 35
    if kind == "empty":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 7
    raise ValueError(kind)


KINDS = ["components", "self_loops", "isolated", "duplicates", "empty"]


# ---------------------------------------------------------------- the forest
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_spanning_forest_matches_plain(kind, seed):
    src, dst, n = _pairs(kind, seed)
    order = np.random.default_rng(seed + 10).permutation(len(src))
    got = native.spanning_forest(src, dst, order, n)
    assert got.dtype == bool and got.shape == src.shape
    np.testing.assert_array_equal(got, native.spanning_forest_plain(src, dst, order, n))
    assert not got[src == dst].any()


@pytest.mark.parametrize("kind", ["components", "self_loops", "isolated", "duplicates"])
@pytest.mark.parametrize("random_state", [3, 42])
def test_spanning_forest_arcs_match_reference(kind, random_state):
    src, dst, n = _pairs(kind)
    port = Graph.from_edge_arrays(src, dst, n_nodes=n)
    ref = RefGraph.from_edge_arrays(src, dst, n_nodes=n)
    got = spanning_forest_arcs(port, random_state)
    np.testing.assert_array_equal(got, np.asarray(ref_spanning_forest_arcs(ref, random_state)))
    # A forest over the components: one edge fewer than the nodes it spans.
    touched = np.union1d(src, dst)
    n_components = len(np.unique(_components(port)[touched]))
    assert got.sum() == len(touched) - n_components


def _components(graph):
    label = np.arange(graph.number_of_nodes)
    while True:
        new = label.copy()
        np.minimum.at(new, graph.sources, label[graph.col_idx])
        if np.array_equal(new, label):
            return label
        label = new


# ----------------------------------------------------------- the radix sort
def _scores(case, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(5000)
    if case == "ties":
        x = np.round(x * 4) / 4
    elif case == "signed_zeros":
        x = np.where(rng.random(5000) < 0.5, np.where(rng.random(5000) < 0.5, -0.0, 0.0), x)
    elif case == "negatives":
        x = -np.abs(x) - rng.integers(0, 3, 5000)
    elif case == "extremes":
        x[:6] = [np.inf, -np.inf, np.finfo(dtype).max, -np.finfo(dtype).max,
                 np.finfo(dtype).tiny, -np.finfo(dtype).tiny]
        x[6:20] = np.finfo(dtype).smallest_subnormal * rng.integers(-3, 4, 14)
    return rng.permutation(x).astype(dtype)


@pytest.mark.parametrize("case", ["random", "ties", "signed_zeros", "negatives", "extremes"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stable_argsort_is_numpys(case, dtype):
    x = _scores(case, dtype)
    np.testing.assert_array_equal(_stable_argsort(x), np.argsort(x, kind="stable"))


@pytest.mark.parametrize("bits", [8, 32, 40, 64])
def test_radix_argsort_matches_plain(bits):
    rng = np.random.default_rng(bits)
    keys = rng.integers(0, 2**63, 4000, dtype=np.uint64) >> np.uint64(64 - bits)
    keys[::7] = keys[3]                               # ties
    got = native.radix_argsort(keys)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, native.radix_argsort_plain(keys))


# ----------------------------------------------------------------- the sweep
def _panel_inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    scores = rng.random(3000).astype(np.float32)
    labels = rng.random(3000) < 0.3
    if case == "all_positive":
        labels[:] = True
    elif case == "all_negative":
        labels[:] = False
    elif case == "ties":
        scores = (np.round(scores * 10) / 10).astype(np.float32)
    elif case == "one_score":
        scores[:] = 0.5
    return labels, scores


PANEL_CASES = ["random", "all_positive", "all_negative", "ties", "one_score"]


@pytest.mark.parametrize("case", PANEL_CASES)
def test_sweep_matches_plain(case):
    labels, scores = _panel_inputs(case)
    order = np.argsort(scores, kind="stable")
    got = native.ranking_metrics_sorted(scores[order], labels[order])
    want = native.ranking_metrics_sorted_plain(scores[order], labels[order])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)   # NaN where NaN


@pytest.mark.parametrize("case", PANEL_CASES)
def test_binary_panel_matches_reference(case):
    labels, scores = _panel_inputs(case, seed=1)
    got, want = all_binary_metrics(labels, scores), ref_all_binary_metrics(labels, scores)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)


# -------------------------------------------------------- pairs and CSRs
@pytest.mark.parametrize("kind", KINDS)
def test_sort_pairs_and_unique_match_plain(kind):
    src, dst, n = _pairs(kind)
    order = native.sort_pairs(src, dst, n)
    np.testing.assert_array_equal(order, native.sort_pairs_plain(src, dst, n))
    first = native.sort_unique_pairs(src, dst, n)
    np.testing.assert_array_equal(first, native.sort_unique_pairs_plain(src, dst, n))
    # First occurrences: no earlier index holds the same pair.
    keys = src.astype(np.int64) * n + dst
    assert len(first) == len(np.unique(keys))
    assert all(np.flatnonzero(keys == keys[i])[0] == i for i in first)


@pytest.mark.parametrize("kind", KINDS)
def test_build_sym_csr_matches_plain_and_reference(kind):
    src, dst, n = _pairs(kind)
    row_ptr, col_idx = native.build_sym_csr(src, dst, n)
    want_ptr, want_idx = native.build_sym_csr_plain(src, dst, n)
    assert row_ptr.dtype == np.int64 and col_idx.dtype == np.int32
    np.testing.assert_array_equal(row_ptr, want_ptr)
    np.testing.assert_array_equal(col_idx, want_idx)
    ref = RefGraph.from_edge_arrays(src, dst, n_nodes=n)
    np.testing.assert_array_equal(row_ptr, ref.row_ptr)
    np.testing.assert_array_equal(col_idx, ref.col_idx)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("directed", [False, True])
def test_weighted_typed_build_keeps_first_attributes(kind, directed):
    src, dst, n = _pairs(kind)
    rng = np.random.default_rng(5)
    weights = rng.random(len(src)).astype(np.float32)
    types = rng.integers(0, 4, len(src)).astype(np.int32)
    port = Graph.from_edge_arrays(src, dst, n_nodes=n, weights=weights, edge_types=types,
                                  directed=directed)
    ref = RefGraph.from_edge_arrays(src, dst, n_nodes=n, weights=weights, edge_types=types,
                                    directed=directed)
    for name in ("row_ptr", "col_idx", "weights", "edge_types"):
        np.testing.assert_array_equal(getattr(port, name), np.asarray(getattr(ref, name)))
    # Each arc carries the attributes of its first occurrence in the input.
    a_src = np.concatenate([src, [] if directed else dst[src != dst]]).astype(np.int64)
    a_dst = np.concatenate([dst, [] if directed else src[src != dst]]).astype(np.int64)
    a_w = np.concatenate([weights, [] if directed else weights[src != dst]])
    keys = a_src * n + a_dst
    _, first = np.unique(keys, return_index=True)
    np.testing.assert_array_equal(port.weights, a_w[first].astype(np.float32))


# --------------------------------------------------------------- alias tables
def _alias_rows():
    """A row_ptr and weights with uniform, near-uniform, zero, single and
    skewed rows, and empty rows between them."""
    rows = [np.ones(5), 1 + 1e-10 * np.arange(4), np.zeros(3), [2.5], [], [1, 1000, 3, 3],
            np.arange(1, 40), [], [0, 0, 7]]
    row_ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    return row_ptr, np.concatenate([np.asarray(r, np.float32) for r in rows])


@pytest.mark.parametrize("which", ["rows", "weighted_er"])
def test_alias_tables_bitwise(which):
    if which == "rows":
        row_ptr, weights = _alias_rows()
    else:
        g = erdos_renyi(2000, 12000, seed=4, weighted=True)
        row_ptr, weights = g.row_ptr, g.weights
    prob, alias = native.alias_tables(row_ptr, weights)
    want_prob, want_alias = native.alias_tables_plain(row_ptr, weights)
    assert prob.dtype == np.float32 and alias.dtype == np.int32
    np.testing.assert_array_equal(prob.view(np.uint32), want_prob.view(np.uint32))
    np.testing.assert_array_equal(alias, want_alias)
    ref_prob, ref_alias = ref_build_alias_tables(row_ptr, weights)
    np.testing.assert_array_equal(prob.view(np.uint32), np.asarray(ref_prob).view(np.uint32))
    np.testing.assert_array_equal(alias, np.asarray(ref_alias))


# ------------------------------------------------------------------ the parser
def _write_edge_file(path, crlf):
    rng = np.random.default_rng(9)
    names = [f"n{i:03d}" for i in rng.permutation(80)]
    kinds = ["binds", "inhibits", "activates"]
    lines = ["left,weight,type,right"]
    for i in range(400):
        s, d = names[rng.integers(80)], names[rng.integers(80)]
        lines.append(f"{s},{rng.integers(1, 10**6) / 1000},{kinds[rng.integers(3)]},{d}")
    lines.insert(40, "short,row")                      # fewer columns: skipped
    lines.insert(90, ",1.0,binds,n001")                # empty source: skipped
    lines.insert(120, "")
    text = ("\r\n" if crlf else "\n").join(lines) + "\n"
    path.write_bytes(text.encode())
    return path


def _same_parse(got, want):
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("crlf", [False, True])
def test_parser_matches_plain_on_generated_file(tmp_path, crlf):
    path = str(_write_edge_file(tmp_path / "edges.csv", crlf))
    kw = dict(sep=",", src_col=0, dst_col=3, weight_col=1, type_col=2)
    got = native.parse_edge_list(path, **kw)
    _same_parse(got, native.parse_edge_list_plain(path, **kw))
    assert len(got[0]) == 400 and len(got[5]) == 3
    _same_parse(native.parse_edge_list(path, sep=",", dst_col=3),
                native.parse_edge_list_plain(path, sep=",", dst_col=3))


@pytest.mark.parametrize("columns", [dict(weight_col=2, type_col=3), dict()])
def test_parser_matches_plain_on_small_ppi(columns):
    got = native.parse_edge_list(str(SMALL_PPI), **columns)
    _same_parse(got, native.parse_edge_list_plain(str(SMALL_PPI), **columns))
    assert len(got[0]) == 3000


@pytest.mark.parametrize("first_seen_ids", [True, False])
def test_from_csv_matches_reference(tmp_path, first_seen_ids):
    """`first_seen_ids` is the reference's native parser, sorted ids its
    pandas path."""
    path = str(_write_edge_file(tmp_path / "edges.csv", crlf=False))
    kw = dict(source_column="left", destination_column="right", weight_column="weight",
              edge_type_column="type", sep=",")
    port = from_csv(path, first_seen_ids=first_seen_ids, **kw)
    ref = ref_from_csv(path, use_native_parser=first_seen_ids, **kw) if first_seen_ids else None
    if ref is None:     # the reference's pandas path reads the short rows too
        good = str(tmp_path / "good.csv")
        Path(good).write_text("\n".join(line for line in Path(path).read_text().split("\n")
                                        if line.count(",") == 3 and not line.startswith(",")))
        ref = ref_from_csv(good, use_native_parser=False, **kw)
    for name in ("row_ptr", "col_idx", "weights", "edge_types"):
        np.testing.assert_array_equal(getattr(port, name), np.asarray(getattr(ref, name)))
    assert list(port.get_node_names()) == list(ref.get_node_names())
    assert list(port.get_edge_type_names()) == list(ref.get_edge_type_names())


# ------------------------------------------------------------------- the build
def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build()
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.sort_pairs([1, 0], [0, 1], 2)
    assert not list((tmp_path / "build").glob("*.so"))


def test_compile_error_raises_with_the_compilers_output(tmp_path, monkeypatch):
    fake = tmp_path / "cxx"
    fake.write_text("#!/bin/sh\necho 'error: no such thing' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(RuntimeError, match="error: no such thing"):
        native.build()


def test_two_processes_build_at_once(tmp_path):
    build_dir = tmp_path / "build"
    code = ("import sys\n"
            "from embiggen_tpu_torch import native\n"
            "native.BUILD_DIR = sys.argv[1]\n"
            "native.build()\n"
            "print(native.sort_pairs([2, 0, 1], [0, 1, 0], 3).tolist())\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("CXX", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build_dir)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "[1, 2, 0]"
    assert len(list(build_dir.glob("*.so"))) == 1
    assert not list(build_dir.glob("*.tmp"))


def test_ids_outside_the_graph_raise():
    with pytest.raises(ValueError, match="outside"):
        native.build_sym_csr([0, 5], [1, 2], 5)
    with pytest.raises(ValueError, match="outside"):
        native.sort_unique_pairs([0, -1], [1, 2], 5)
    with pytest.raises(ValueError, match="outside"):
        native.spanning_forest([0, 1], [1, 2], [0, 2], 5)
