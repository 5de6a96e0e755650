"""The port's circuit schedulers without networkx, on the CPU against the
reference:

* ``repro_torch.core.matching``: the blossom matching against
  ``networkx.max_weight_matching`` and the Hopcroft-Karp matching against
  networkx's on the same integer-labelled graphs, as mate arrays;
* ``edmonds`` (1 and 4 uplinks), ``jupiter`` and ``sorn`` against
  ``repro.core.topology``'s, bit for bit, on seeded traffic matrices and on
  fig8's;
* ``bvn`` against the reference's with the reference's bipartite matching
  pinned to integer labels (rows in ascending order): the reference's own
  labels make its result depend on ``PYTHONHASHSEED``, which one test
  records.
"""
import os
import subprocess
import sys
from pathlib import Path

import networkx as nx
import numpy as np
import pytest

import repro.core.topology as R_topo
from repro_torch.core import matching
import repro_torch.core.topology as Q_topo

ROOT = Path(__file__).resolve().parents[1]


def _nx_mate(n, match):
    mate = np.full(n, -1, dtype=np.int64)
    for i, j in match:
        mate[i], mate[j] = j, i
    return mate


def _random_graph(seed):
    """A seeded graph on 1-24 nodes (some isolated), its edges in a
    shuffled insertion order; integer weights from a small range (many
    ties), float weights, or a mix of both."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 25))
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)
             if rng.random() < rng.uniform(0.1, 0.9)]
    rng.shuffle(pairs)
    kind = ("int", "float", "mixed")[seed % 3]
    edges = []
    for i, j in pairs:
        if rng.random() < 0.5:
            i, j = j, i
        if kind == "int" or (kind == "mixed" and rng.random() < 0.5):
            w = int(rng.integers(1, 4))
        else:
            w = float(rng.choice([0.5, 1.0, 1.5, rng.random() * 3]))
        edges.append((i, j, w))
    return n, edges


@pytest.mark.parametrize("maxcard", [False, True], ids=["maxweight", "maxcard"])
@pytest.mark.parametrize("seed", range(40))
def test_max_weight_matching_matches_networkx(seed, maxcard):
    n, edges = _random_graph(seed)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_weighted_edges_from(edges)
    want = _nx_mate(n, nx.max_weight_matching(g, maxcardinality=maxcard))
    got = matching.max_weight_matching(n, edges, maxcardinality=maxcard)
    np.testing.assert_array_equal(got, want)


def test_max_weight_matching_edge_cases():
    """No nodes, no edges, a repeated edge (the last weight counts, the
    first place stays) and a self-loop, as networkx has them."""
    assert matching.max_weight_matching(0, []).shape == (0,)
    np.testing.assert_array_equal(matching.max_weight_matching(3, []),
                                  [-1, -1, -1])
    edges = [(0, 1, 5), (1, 2, 1), (2, 3, 5), (1, 2, 20), (3, 3, 9)]
    g = nx.Graph()
    g.add_nodes_from(range(4))
    g.add_weighted_edges_from(edges)
    for maxcard in (False, True):
        np.testing.assert_array_equal(
            matching.max_weight_matching(4, edges, maxcard),
            _nx_mate(4, nx.max_weight_matching(g, maxcardinality=maxcard)))


def _nx_bipartite(support):
    """networkx's Hopcroft-Karp on the integer-labelled graph: rows
    ``0..n-1``, columns ``n..2n-1``, edges in row-major order."""
    n = support.shape[0]
    g = nx.Graph()
    g.add_nodes_from(range(2 * n))
    rows, cols = np.nonzero(support)
    g.add_edges_from((int(i), n + int(j)) for i, j in zip(rows, cols))
    return nx.bipartite.maximum_matching(g, top_nodes=range(n))


@pytest.mark.parametrize("seed", range(12))
def test_hopcroft_karp_matches_networkx(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 30))
    support = rng.random((n, n)) < rng.uniform(0.05, 0.6)
    match = _nx_bipartite(support)
    want = np.array([match[i] - n if i in match else -1 for i in range(n)])
    np.testing.assert_array_equal(matching.hopcroft_karp(support), want)


def _nx_perfect_matching(support):
    """The reference's ``_perfect_matching`` on integer labels."""
    n = support.shape[0]
    match = _nx_bipartite(support)
    if sum(1 for k in match if k < n) < n:
        return None
    return np.array([match[i] - n for i in range(n)], dtype=np.int32)


def _fig8_tm():
    from benchmarks.common import traffic_tm
    from benchmarks.fig8_fct import N, _workload
    return traffic_tm(_workload()[0], N)


def _tms():
    """Seeded TMs of 5-16 nodes (integer and float, sparse and dense) and
    fig8's."""
    out = []
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        n = int(rng.integers(5, 17))
        tm = rng.integers(0, 4, (n, n)).astype(float) if seed % 2 else \
            rng.random((n, n)) * (rng.random((n, n)) < 0.4)
        out.append(tm)
    return out + [_fig8_tm()]


TM_IDS = [f"tm{i}" for i in range(8)] + ["fig8"]


@pytest.mark.parametrize("tm", _tms(), ids=TM_IDS)
def test_edmonds_jupiter_sorn_match_reference(tm):
    n = tm.shape[0]
    for U in (1, 4):
        np.testing.assert_array_equal(Q_topo.edmonds(tm, n_uplinks=U).conn,
                                      R_topo.edmonds(tm, n_uplinks=U).conn)
    for kw in (dict(n_uplinks=4, max_moves=16), dict(n_uplinks=2)):
        np.testing.assert_array_equal(
            Q_topo.jupiter(tm, n_nodes=n, **kw).conn,
            R_topo.jupiter(tm, n_nodes=n, **kw).conn)
    prev = R_topo.jupiter(tm, n_nodes=n, n_uplinks=2)
    np.testing.assert_array_equal(
        Q_topo.jupiter(tm, prev=Q_topo.Schedule(prev.conn.copy())).conn,
        R_topo.jupiter(tm, prev=prev).conn)
    for frac in (0.25, 0.5):
        got = Q_topo.sorn(tm, Q_topo.round_robin(n, 1), hot_frac=frac)
        want = R_topo.sorn(tm, R_topo.round_robin(n, 1), hot_frac=frac)
        np.testing.assert_array_equal(got.conn, want.conn)
        assert (got.slice_us, got.reconf_us) == (want.slice_us,
                                                  want.reconf_us)
    assert Q_topo.jupiter(np.zeros_like(tm), n_nodes=n).conn.shape == (1, n, 1)


@pytest.mark.parametrize("tm", _tms(), ids=TM_IDS)
def test_bvn_matches_reference_with_pinned_matching(tm, monkeypatch):
    """With the reference's matching on integer labels, ``bvn`` agrees bit
    for bit: the Sinkhorn, the peel, the padding branch, the slice
    counts."""
    monkeypatch.setattr(R_topo, "_perfect_matching", _nx_perfect_matching)
    n = tm.shape[0]
    for kw in (dict(max_perms=16), dict(max_perms=2 * n), dict(max_perms=3)):
        got, want = Q_topo.bvn(tm, **kw), R_topo.bvn(tm, **kw)
        np.testing.assert_array_equal(got.conn, want.conn)
        assert (got.slice_us, got.reconf_us) == (want.slice_us,
                                                  want.reconf_us)


def test_bvn_padding_branch_and_empty_tm(monkeypatch):
    """A TM whose positive support admits no perfect matching takes the
    padding branch; an all-zero TM falls back to the uniform matrix."""
    monkeypatch.setattr(R_topo, "_perfect_matching", _nx_perfect_matching)
    tm = np.zeros((6, 6))
    tm[0, 1] = tm[1, 0] = 5.0
    tm[2, 3] = 1.0
    assert Q_topo._perfect_matching(tm > 1e-9) is None
    for m in (tm, np.zeros((5, 5))):
        np.testing.assert_array_equal(Q_topo.bvn(m, max_perms=8).conn,
                                      R_topo.bvn(m, max_perms=8).conn)


HASH_SEED_PROBE = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from {module} import _perfect_matching
print(_perfect_matching(np.ones((6, 6), bool)).tolist())
"""


def _matching_under(seed, module):
    env = dict(os.environ, PYTHONHASHSEED=str(seed), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", HASH_SEED_PROBE.format(module=module),
         str(ROOT / "src")], env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_reference_bvn_depends_on_hash_seed_the_port_does_not():
    """The reference's ``_perfect_matching`` labels nodes ``("r", i)`` /
    ``("c", j)``; networkx iterates a set of them, whose order follows
    ``PYTHONHASHSEED``, so the same support matches differently from one
    process to the next. The port's rows go in index order."""
    ref = {s: _matching_under(s, "repro.core.topology") for s in (1, 3)}
    port = {s: _matching_under(s, "repro_torch.core.topology")
            for s in (1, 3)}
    assert ref[1] != ref[3]
    assert port[1] == port[3]
