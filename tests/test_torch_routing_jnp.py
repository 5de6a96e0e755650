"""The port's device routing compiler (``repro_torch.core.routing_jnp``)
on the CPU, against ``repro.core.routing_jnp`` and against the port's own
host compiler (``repro_torch.core.routing``), on the same schedules:
round-robin, random and partly dark, at N of 8 to 16. Every table is
integer, so every comparison is exact, dtypes included. Also the
``compile_impl="jnp"`` knob of the scheme functions and
``repair(impl="jnp")``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import routing_jnp as RJ  # noqa: E402
import repro_torch.core as Q  # noqa: E402
from repro_torch.core import routing_jnp as QJ  # noqa: E402
from torch_parity import (one_torch_thread,  # noqa: E402, F401
                          release_compiled_programs)


@pytest.fixture(autouse=True, scope="module")
def _one_thread(one_torch_thread):
    pass


def _random_conn(rng, n, T, U, fill):
    """Random directed circuits without self-circuits, dark at 1 - fill."""
    conn = rng.integers(0, n, size=(T, n, U)).astype(np.int32)
    conn = np.where(conn == np.arange(n, dtype=np.int32)[None, :, None],
                    (conn + 1) % n, conn)
    return np.where(rng.random(conn.shape) > fill, -1, conn).astype(np.int32)


def _partly_dark(conn, rng, share):
    """A schedule with ``share`` of its circuits gone dark."""
    return np.where(rng.random(conn.shape) < share, -1, conn).astype(np.int32)


def _schedules():
    rng = np.random.default_rng(11)
    return {
        "rr8": R.round_robin(8, 1).conn,
        "rr16": R.round_robin(16, 1).conn,
        "random10x2": _random_conn(rng, 10, 6, 2, 0.7),
        "random12x3": _random_conn(rng, 12, 5, 3, 0.8),
        "dark8": _partly_dark(R.round_robin(8, 1).conn, rng, 0.3),
        "dark13x2": _partly_dark(R.round_robin(13, 2).conn, rng, 0.4),
    }


# the reference's compiler as one program per (shape, scheme): its eager
# dispatch compiles every op of the DP on its own
_ref_compile = jax.jit(RJ.compile_tables, static_argnums=(1, 2, 3))
_ref_dp = jax.jit(RJ.time_dp_all)


SCHEDULES = _schedules()
HOST = {"direct": Q.direct, "vlb": Q.vlb, "opera": Q.opera, "ucmp": Q.ucmp,
        "hoho": Q.hoho}
FIELDS = ("tf_next", "tf_dep", "inj_next", "inj_dep")


def _eq(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.int32, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("scheme", QJ.SCHEMES)
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_compile_tables_match_reference_and_host(name, scheme):
    conn = SCHEDULES[name]
    got = QJ.compile_tables(torch.tensor(conn), scheme, max_hop=4, kpaths=3)
    want = _ref_compile(jnp.asarray(conn), scheme, 4, 3)
    host = HOST[scheme](Q.Schedule(conn), max_hop=4, kpaths=3)
    for f, g, w in zip(FIELDS, got, want):
        _eq(g, w, f"{name} {scheme} {f} vs repro")
        _eq(g, getattr(host, f), f"{name} {scheme} {f} vs host")


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_time_dp_and_first_direct_match_reference(name):
    conn = SCHEDULES[name]
    _eq(QJ.time_dp_all(torch.tensor(conn)),
        _ref_dp(jnp.asarray(conn)), f"{name} time_dp_all")
    _eq(QJ.first_direct_offsets(torch.tensor(conn)),
        Q.first_direct_offsets(Q.Schedule(conn)), f"{name} first_direct")
    assert QJ.JINF == int(RJ.JINF)


@pytest.mark.parametrize("kpaths", [1, 5])
def test_dp_tables_slot_counts(kpaths):
    """The slot axis takes ``kpaths`` (more than the uplinks too), as the
    reference's does."""
    conn = SCHEDULES["random12x3"]
    got = QJ.compile_tables(torch.tensor(conn), "ucmp", 4, kpaths)
    want = _ref_compile(jnp.asarray(conn), "ucmp", 4, kpaths)
    for f, g, w in zip(FIELDS, got, want):
        _eq(g, w, f"ucmp kpaths={kpaths} {f}")


@pytest.mark.parametrize("scheme", QJ.SCHEMES)
def test_compile_impl_jnp_is_the_host_compiler(scheme):
    """``compile_impl="jnp"`` (on the CPU here) gives the host tables, and
    the routing's multipath mode."""
    sched = Q.Schedule(SCHEDULES["dark13x2"])
    got = HOST[scheme](sched, compile_impl="jnp", device="cpu")
    want = HOST[scheme](sched)
    for f in FIELDS:
        _eq(getattr(got, f), getattr(want, f), f"{scheme} {f}")
    assert got.multipath == want.multipath
    with pytest.raises(ValueError, match="compile_impl"):
        HOST[scheme](sched, compile_impl="cuda")


def test_repair_jnp_is_the_host_repair():
    """``repair(impl="jnp")`` (``tests/test_torch_repair.py`` holds it
    against the reference's) equals the host repair of every TO scheme."""
    sched = Q.round_robin(12, 1)
    failed = np.zeros((12, 12), bool)
    failed[3, 7] = failed[7, 3] = failed[0, 5] = True
    for scheme in QJ.SCHEMES:
        got = Q.repair(sched, scheme, failed, impl="jnp", device="cpu")
        want = Q.repair(sched, scheme, failed)
        for f in FIELDS:
            _eq(getattr(got, f), getattr(want, f), f"repair {scheme} {f}")


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="unknown TO scheme"):
        QJ.compile_tables(torch.tensor(SCHEDULES["rr8"]), "ecmp")
