"""The port's demand schedulers (``repro_torch.core.topology_jnp``) on the
CPU against ``repro.core.topology_jnp`` on the same traffic matrices, made
from seeds with numpy: the greedy matching and ``edmonds_conn`` exact (an
all-zero matrix among the inputs), the greedy assignment exact, the
float32 Sinkhorn within 1e-6 relative (torch sums in another order than
XLA), and ``bvn_conn`` exact on the reference's own test inputs
(``tests/test_topology_jnp.py``) and on random dense matrices.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import topology_jnp as RT  # noqa: E402
from repro_torch.core import topology_jnp as QT  # noqa: E402
from torch_parity import (one_torch_thread,  # noqa: E402, F401
                          release_compiled_programs)

_ref_edmonds = jax.jit(RT.edmonds_conn, static_argnums=(1,))
_ref_bvn = jax.jit(RT.bvn_conn, static_argnums=(1, 2, 3, 4, 5))
_ref_assign = jax.jit(RT.greedy_assignment)


@pytest.fixture(autouse=True, scope="module")
def _one_thread(one_torch_thread):
    pass


def _eq(got, want, what=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _matching_tm(rng, n):
    """Demand whose symmetrised support is a perfect matching."""
    pairs = rng.permutation(n).reshape(-1, 2)
    tm = np.zeros((n, n), np.float32)
    for a, b in pairs:
        tm[a, b] = rng.random() * 90 + 10
    return tm


def _random_tm(rng, n, scale=100.0):
    tm = (rng.random((n, n)) * scale).astype(np.float32)
    np.fill_diagonal(tm, 0)
    return tm


def _derangement(rng, n):
    while True:
        p = rng.permutation(n)
        if not np.any(p == np.arange(n)):
            return p


def _tms():
    rng = np.random.default_rng(21)
    out = {"zero": np.zeros((8, 8), np.float32)}
    for n in (6, 8, 12):
        out[f"matching{n}"] = _matching_tm(rng, n)
        out[f"random{n}"] = _random_tm(rng, n)
    # integer byte counts with ties, as the reconfigure loop measures them
    out["bytes8"] = (rng.integers(0, 3, (8, 8)) * 1500).astype(np.float32)
    np.fill_diagonal(out["bytes8"], 0)
    out["one-pair"] = np.zeros((8, 8), np.float32)
    out["one-pair"][2, 5] = 30_000
    return out


TMS = _tms()


@pytest.mark.parametrize("uplinks", [1, 2, 3])
@pytest.mark.parametrize("name", list(TMS))
def test_edmonds_conn_matches_reference(name, uplinks):
    tm = TMS[name]
    _eq(QT.edmonds_conn(torch.tensor(tm), n_uplinks=uplinks),
        _ref_edmonds(jnp.asarray(tm), uplinks), name)


@pytest.mark.parametrize("name", list(TMS))
def test_greedy_matching_matches_reference(name):
    sym = TMS[name] + TMS[name].T
    _eq(QT.greedy_matching(torch.tensor(sym)),
        RT.greedy_matching(jnp.asarray(sym)), name)


def test_greedy_matching_all_zero_is_unmatched():
    """The loop ends before its first round on an all-zero matrix: no node
    is matched (an unguarded round would match node 0 with itself)."""
    peer = QT.greedy_matching(torch.zeros((6, 6)))
    assert (peer == -1).all()


@pytest.mark.parametrize("name", list(TMS))
def test_greedy_assignment_matches_reference(name):
    w = TMS[name] / max(float(TMS[name].max()), 1.0)
    _eq(QT.greedy_assignment(torch.tensor(w)), _ref_assign(jnp.asarray(w)),
        name)


@pytest.mark.parametrize("iters", [1, 50, 200])
@pytest.mark.parametrize("name", list(TMS))
def test_sinkhorn_within_rounding(name, iters):
    tm = TMS[name]
    got = QT.sinkhorn(torch.tensor(tm), iters=iters).numpy()
    want = np.asarray(RT.sinkhorn(jnp.asarray(tm), iters=iters))
    assert got.dtype == want.dtype == np.float32
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-6, (name, iters, rel)


def _bvn_both(tm, num_slices, max_perms, iters=200):
    got = QT.bvn_conn(torch.tensor(tm), num_slices=num_slices,
                      max_perms=max_perms, sinkhorn_iters=iters,
                      with_info=True)
    want = _ref_bvn(jnp.asarray(tm), num_slices, max_perms, iters, 1e-9,
                    True)
    return got, want


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n", [6, 8, 10])
def test_bvn_exact_on_permutation_tms(seed, n):
    """The reference's ``test_bvn_exact_on_permutation_tms`` inputs."""
    rng = np.random.default_rng(seed + 10)
    perm = _derangement(rng, n)
    tm = np.zeros((n, n))
    tm[np.arange(n), perm] = rng.random(n) * 9 + 1
    (conn, found), (r_conn, r_found) = _bvn_both(tm, 16, 8)
    _eq(conn, r_conn)
    _eq(found, r_found)


def test_bvn_exact_on_reference_perm_found_inputs():
    """The inputs of the reference's ``test_bvn_perm_found_counts_effective
    _depth`` (a permutation matrix) and ``..._dense_tm_uses_budget`` (a
    dense random matrix that uses several peels)."""
    rng = np.random.default_rng(2)
    perm = _derangement(rng, 8)
    tm = np.zeros((8, 8))
    tm[np.arange(8), perm] = rng.random(8) * 9 + 1
    (conn, found), (r_conn, r_found) = _bvn_both(tm, 8, 6)
    _eq(conn, r_conn)
    _eq(found, r_found)
    rng = np.random.default_rng(4)
    tm = rng.random((8, 8)) * 50
    np.fill_diagonal(tm, 0)
    (conn, found), (r_conn, r_found) = _bvn_both(tm, 12, 8)
    _eq(conn, r_conn)
    _eq(found, r_found)
    assert int(found.sum()) >= 2


@pytest.mark.parametrize("seed", range(5))
def test_bvn_exact_on_random_tms(seed):
    """The inputs of the reference's ``test_bvn_slices_are_feasible_partial
    _permutations``: random dense matrices of 5 to 11 nodes."""
    rng = np.random.default_rng(seed + 30)
    n = int(rng.integers(5, 12))
    tm = rng.random((n, n)) * 50
    np.fill_diagonal(tm, 0)
    (conn, found), (r_conn, r_found) = _bvn_both(tm.astype(np.float32), 12, 6)
    _eq(conn, r_conn)
    _eq(found, r_found)


@pytest.mark.parametrize("name", ["zero", "bytes8", "one-pair", "random12"])
def test_bvn_exact_on_loop_shaped_tms(name):
    """The loop's shapes: 8 slices over 8 peels, 50 Sinkhorn rounds; an
    all-zero matrix falls back to uniform demand."""
    (conn, found), (r_conn, r_found) = _bvn_both(TMS[name], 8, 8, iters=50)
    _eq(conn, r_conn, name)
    _eq(found, r_found, name)
    assert conn.shape == (8, TMS[name].shape[0], 1)


def test_schedulers_list():
    assert QT.SCHEDULERS == RT.SCHEDULERS
