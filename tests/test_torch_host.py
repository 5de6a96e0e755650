"""Parity of the PyTorch port's host control plane with ``repro``:
schedules (``topology``), the 8 routing compilers (``routing``), the
synthetic traces (``traces``) and the state carried between the packages
(``tables_from_arrays`` / ``workload_from_arrays``). Everything here is
numpy in both packages and must be equal array for array, dtypes included.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as Q  # noqa: E402
from repro.core import topology as R_topology  # noqa: E402
from repro_torch.core import fabric as Q_fabric  # noqa: E402

from invariant_cases import random_schedule, scheduler_schedule  # noqa: E402

SCHEMES = ["direct", "vlb", "opera", "ucmp", "hoho", "ecmp", "wcmp", "ksp"]


def _port_schedule(sched):
    """The reference schedule carried over to the port by its ``conn``."""
    return Q.Schedule(np.array(sched.conn), sched.slice_us, sched.reconf_us)


def _random_sched(rng, n, T, U, fill=0.7):
    """The seeded random schedule of the routing golden tests."""
    conn = rng.integers(0, n, size=(T, n, U)).astype(np.int32)
    self_loop = conn == np.arange(n, dtype=np.int32)[None, :, None]
    conn = np.where(self_loop, (conn + 1) % n, conn)
    dark = rng.random(size=conn.shape) > fill
    return R.Schedule(np.where(dark, np.int32(-1), conn))


def _golden_schedules():
    """The schedules of ``tests/test_routing_golden.py``: its seed and
    shapes, built with ``repro``."""
    rng = np.random.default_rng(7)
    scheds = [R.round_robin(6, 1), R.round_robin(8, 2), R.round_robin(9, 3)]
    for n, T, U in [(5, 3, 1), (6, 4, 2), (7, 5, 3), (9, 6, 2), (4, 2, 2)]:
        scheds.append(_random_sched(rng, n, T, U))
    return scheds


def _invariant_schedule(kind, seed):
    """The schedules of ``tests/test_invariants.py``."""
    if kind == "to":
        rng = np.random.default_rng(seed + 100)
        n, T, U = (int(rng.integers(4, 9)), int(rng.integers(1, 6)),
                   int(rng.integers(1, 4)))
        return random_schedule(seed, n, T, U)
    rng = np.random.default_rng(seed + 200)
    n, U = int(rng.integers(4, 10)), int(rng.integers(1, 4))
    return random_schedule(seed, n, T=1, U=U)


SCHEDULES = (
    [(f"golden{i}", lambda i=i: _golden_schedules()[i]) for i in range(8)]
    + [(f"random-to{s}", lambda s=s: _invariant_schedule("to", s))
       for s in range(4)]
    + [(f"random-ta{s}", lambda s=s: _invariant_schedule("ta", s))
       for s in range(4)]
    + [(k, lambda k=k: scheduler_schedule(k, seed=5, n=8))
       for k in ("edmonds", "bvn")]
)


def _assert_routing_equal(a, b):
    for f in ("tf_next", "tf_dep", "inj_next", "inj_dep"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.multipath == b.multipath and a.lookup == b.lookup
    if a.weights is None:
        assert b.weights is None
    else:
        assert a.weights.dtype == b.weights.dtype
        np.testing.assert_array_equal(a.weights, b.weights)


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,u,d", [(6, 1, 1), (8, 2, 1), (9, 3, 1),
                                   (108, 1, 1), (16, 4, 2), (12, 2, 2),
                                   (27, 3, 3)])
def test_round_robin_equal(n, u, d):
    a = R.round_robin(n, u, dimension=d, slice_us=7.0, reconf_us=1.0)
    b = Q.round_robin(n, u, dimension=d, slice_us=7.0, reconf_us=1.0)
    assert a.conn.dtype == b.conn.dtype
    np.testing.assert_array_equal(a.conn, b.conn)
    assert (a.slice_us, a.reconf_us, a.duty_cycle) == \
        (b.slice_us, b.reconf_us, b.duty_cycle)


def test_near_equal_factors_equal():
    from repro_torch.core.topology import _near_equal_factors
    for n, d in [(12, 2), (27, 3), (16, 4), (30, 2), (7, 1), (7, 2)]:
        assert _near_equal_factors(n, d) == R_topology._near_equal_factors(n, d)


@pytest.mark.parametrize("n,u", [(5, 1), (8, 3), (16, 4)])
def test_uniform_mesh_equal(n, u):
    a, b = R.uniform_mesh(n, u), Q.uniform_mesh(n, u)
    np.testing.assert_array_equal(a.conn, b.conn)
    assert a.conn.dtype == b.conn.dtype and a.slice_us == b.slice_us


def test_deploy_topo_check_and_circuits_equal():
    rng = np.random.default_rng(0)
    conns = [R.round_robin(8, 2).conn,
             np.where(rng.random((3, 6, 2)) < 0.3, -1,
                      rng.integers(0, 6, (3, 6, 2))).astype(np.int32),
             np.full((2, 4, 3), 1, np.int32)]          # rx overload
    conns.append(conns[0].copy())
    conns[-1][0, 2, 0] = 2                                # self-circuit
    for conn in conns:
        assert Q.deploy_topo_check(conn) == R.deploy_topo_check(conn)
        ca, cb = R.conn_to_circuits(conn), Q.conn_to_circuits(conn)
        assert [dataclasses.astuple(c) for c in ca] == \
            [dataclasses.astuple(c) for c in cb]
        T, N, U = conn.shape
        np.testing.assert_array_equal(Q.circuits_to_conn(cb, N, U, T),
                                      R.circuits_to_conn(ca, N, U, T))
    circ_a, circ_b = [], []
    for args in [(0, 0, 1, 0, 0), (0, 0, 2, 0, 0), (1, 0, 0, 0, None),
                 (1, 0, 2, 0, 1)]:
        assert Q.connect(circ_b, *args) == R.connect(circ_a, *args)
    assert [dataclasses.astuple(c) for c in circ_a] == \
        [dataclasses.astuple(c) for c in circ_b]


# ---------------------------------------------------------------------------
# routing: all 8 compilers on the schedules of the routing and invariant
# suites, plus the paper's 108-ToR rotor cycle for the TO schemes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", [c for c, _ in SCHEDULES])
def test_routing_equal(case, scheme):
    sched = dict(SCHEDULES)[case]()
    _assert_routing_equal(getattr(R, scheme)(sched),
                          getattr(Q, scheme)(_port_schedule(sched)))


@pytest.mark.parametrize("scheme", ["direct", "vlb", "hoho", "ucmp"])
def test_routing_equal_108_tor(scheme):
    sched = R.round_robin(108, 1)
    _assert_routing_equal(getattr(R, scheme)(sched),
                          getattr(Q, scheme)(_port_schedule(sched)))


@pytest.mark.parametrize("kw", [dict(kpaths=2), dict(kpaths=1),
                                dict(max_hop=2)], ids=str)
def test_routing_options_equal(kw):
    sched = R.round_robin(9, 3)
    qs = _port_schedule(sched)
    for scheme in ("vlb", "ucmp", "ecmp", "opera", "hoho"):
        _assert_routing_equal(getattr(R, scheme)(sched, **kw),
                              getattr(Q, scheme)(qs, **kw))
    _assert_routing_equal(R.ksp(sched, k=2, max_hop=3),
                          Q.ksp(qs, k=2, max_hop=3))


def test_routing_helpers_equal():
    sched = _golden_schedules()[5]
    qs = _port_schedule(sched)
    np.testing.assert_array_equal(Q.first_direct_offsets(qs),
                                  R.routing.first_direct_offsets(sched))
    for node in range(sched.num_nodes):
        for ts in (None, 0, 3):
            np.testing.assert_array_equal(Q.neighbors(qs, node, ts),
                                          R.neighbors(sched, node, ts))
        for dst in range(sched.num_nodes):
            assert Q.earliest_path(qs, node, dst, 2) == \
                R.earliest_path(sched, node, dst, 2)
    a, b = R.ucmp(sched), Q.ucmp(qs)
    for args in [(0, 1, 2), (2, 3, 1, 1, 4, 1), (1, 0, 3, None, None, 0)]:
        R.add_entry(a, *args)
        Q.add_entry(b, *args)
    R.add_entry(a, 0, 2, 1, injection=True)
    Q.add_entry(b, 0, 2, 1, injection=True)
    _assert_routing_equal(a, b)
    assert a.is_flow_table() == b.is_flow_table()


def test_compile_impl_jnp_not_ported(monkeypatch):
    """The name is older than the port of ``compile_impl="jnp"``: the
    device compiler now runs (on the device the caller names) and gives
    the reference's ``compile_impl="jnp"`` tables; without a card,
    ``device=None`` raises rather than running on the CPU."""
    qs, rs = Q.round_robin(6, 1), R.round_robin(6, 1)
    for scheme in ("direct", "vlb", "opera", "ucmp", "hoho"):
        got = getattr(Q, scheme)(qs, compile_impl="jnp", device="cpu")
        want = getattr(R, scheme)(rs, compile_impl="jnp")
        for f in ("tf_next", "tf_dep", "inj_next", "inj_dep"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.multipath == want.multipath
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Q.hoho(qs, compile_impl="jnp")
    with pytest.raises(ValueError, match="compile_impl"):
        Q.vlb(qs, compile_impl="cuda")


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trace", ["rpc", "hadoop", "kvstore"])
@pytest.mark.parametrize("seed,skew", [(0, 0.0), (5, 0.0), (3, 0.6)])
def test_synthesize_equal(trace, seed, skew):
    kw = dict(slice_bytes=4_000, load=0.7, max_packets=3000, seed=seed,
              skew=skew)
    a = R.synthesize(trace, 12, 30, **kw)
    b = Q.synthesize(trace, 12, 30, **kw)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)
    assert Q.TRACES == R.TRACES


def test_flow_fcts_equal():
    wl = R.synthesize("kvstore", 8, 40, slice_bytes=4_000, load=0.5,
                      max_packets=2000, seed=2)
    qwl = Q_fabric.workload_from_arrays(dataclasses.asdict(wl))
    rng = np.random.default_rng(0)
    t_del = np.where(rng.random(wl.num_packets) < 0.8,
                     wl.t_inject + rng.integers(0, 9, wl.num_packets), -1)
    only = rng.random(wl.num_flows) < 0.5
    for mask in (None, only):
        a = R.flow_fcts(wl, t_del, 10.0, only=mask)
        b = Q.flow_fcts(qwl, t_del, 10.0, only=mask)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# state carried between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["vlb", "ecmp"])
def test_tables_from_arrays_round_trip(scheme):
    sched = R.round_robin(8, 1)
    ref = R.FabricTables.build(sched, getattr(R, scheme)(sched))
    carried = Q_fabric.tables_from_arrays(dataclasses.asdict(ref),
                                          ref.multipath)
    own = Q.FabricTables.build(_port_schedule(sched),
                               getattr(Q, scheme)(_port_schedule(sched)))
    for tables in (carried, own):
        for f in dataclasses.fields(ref):
            x, y = getattr(ref, f.name), getattr(tables, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name


def test_workload_from_arrays_round_trip():
    wl = R.synthesize("hadoop", 8, 20, slice_bytes=4_000, load=0.5,
                      max_packets=500, seed=4)
    q = Q_fabric.workload_from_arrays(dataclasses.asdict(wl))
    for f in dataclasses.fields(wl):
        x, y = getattr(wl, f.name), getattr(q, f.name)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (q.num_packets, q.num_flows) == (wl.num_packets, wl.num_flows)
