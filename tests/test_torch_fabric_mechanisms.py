"""The PyTorch port's ``simulate`` and ``OpenOpticsNet`` (on the CPU)
against ``repro``, beyond the golden cases of ``test_torch_fabric.py``:
the electrical Clos, per-flow multipath, all 8 routing schemes, and the
user API (``run``, ``run_ta``, ``add``, ``collect``, ``buffer_usage``,
``bw_usage``). Bit-identical, values and dtypes.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as Q  # noqa: E402

from torch_parity import (  # noqa: E402, F401
    assert_sim_equal, simulate_both, release_compiled_programs)

N = 8
SLICES = 48


def _workload(**kw):
    args = dict(slice_bytes=4_000, load=0.9, max_packets=420, seed=11)
    args.update(kw)
    return R.synthesize("rpc", N, 24, **args)


def _tables(alg):
    sched = R.round_robin(N, 1)
    return R.FabricTables.build(sched, alg(sched))


@pytest.mark.parametrize("over", [
    dict(elec_bytes=6_000),
    dict(elec_bytes=2_000, pushback=True, switch_buffer=10_000),
], ids=["clos", "clos-pushback-overload"])
def test_electrical_clos(over):
    wl = R.synthesize("rpc", N, 18, slice_bytes=4_000, load=3.0,
                      max_packets=900, seed=9)
    sched = R.round_robin(N, 1)
    tables = R.FabricTables.build(sched, R.clos_routing(N))
    qr = Q.clos_routing(N)
    np.testing.assert_array_equal(qr.tf_next, tables.tf_next)
    assert qr.multipath == tables.multipath == "flow"
    assert_sim_equal(*simulate_both(tables, wl, 24, slice_bytes=4_000,
                                    **over))


@pytest.mark.parametrize("alg", [R.vlb, R.ucmp], ids=["vlb", "ucmp"])
def test_per_flow_multipath(alg):
    tables = _tables(alg)
    tables.multipath = "flow"
    assert_sim_equal(*simulate_both(tables, _workload(), SLICES,
                                    slice_bytes=4_000, pushback=True))


@pytest.mark.parametrize("scheme", ["direct", "vlb", "opera", "ucmp", "hoho",
                                    "ecmp", "wcmp", "ksp"])
def test_all_schemes(scheme):
    sched = R.round_robin(N, 1)
    tables = R.FabricTables.build(sched, getattr(R, scheme)(sched))
    wl = R.synthesize("rpc", N, 18, slice_bytes=4_000, load=0.9,
                      max_packets=300, seed=11)
    assert_sim_equal(*simulate_both(tables, wl, 24, slice_bytes=4_000))


# ---------------------------------------------------------------------------
# the user API
# ---------------------------------------------------------------------------

def _nets(n, fabric):
    cfg = dict(node="rack", node_num=n, uplink=1, slice_us=10.0,
               fabric=fabric)
    return R.OpenOpticsNet(cfg), Q.OpenOpticsNet(cfg, device="cpu")


def test_net_run_and_monitoring_match_reference():
    """The quickstart program (16 ToRs, kvstore) through both nets."""
    n = 16
    ref, port = _nets(n, dict(slice_bytes=12_500))
    for net, pkg in ((ref, R), (port, Q)):
        sched = pkg.round_robin(n, n_uplinks=1, slice_us=10.0)
        assert net.deploy_topo(sched)
        assert net.deploy_routing(pkg.vlb(sched), LOOKUP="hop",
                                  MULTIPATH="packet")
    wl = R.synthesize("kvstore", n, 60, slice_bytes=12_500, load=0.3,
                      max_packets=2000, seed=0)
    a = ref.run(wl, 120)
    b = port.run(Q.fabric.workload_from_arrays(wl.__dict__), 120)
    assert_sim_equal(a, b)
    np.testing.assert_array_equal(ref.collect(), port.collect())
    assert port.collect().dtype == ref.collect().dtype
    for node in range(n):
        assert port.buffer_usage(node) == ref.buffer_usage(node)
        assert port.bw_usage(node) == ref.bw_usage(node)
    fa = R.flow_fcts(wl, a.t_deliver, 10.0)
    fb = Q.flow_fcts(Q.fabric.workload_from_arrays(wl.__dict__),
                     b.t_deliver, 10.0)
    np.testing.assert_array_equal(fa, fb)


def test_net_add_entry_and_errors_match_reference():
    ref, port = _nets(N, dict(slice_bytes=4_000))
    assert port.buffer_usage(0) == ref.buffer_usage(0) == 0
    assert port.bw_usage(0) == ref.bw_usage(0) == 0
    with pytest.raises(RuntimeError):
        port.run(Q.fabric.workload_from_arrays(_workload().__dict__), 4)
    bad = Q.Schedule(np.full((1, N, 1), 3, np.int32))
    assert port.deploy_topo(bad) is ref.deploy_topo(R.Schedule(bad.conn)) \
        is False
    with pytest.raises(ValueError):
        port.deploy_topo(Q.round_robin(N + 1, 1))
    for net, pkg in ((ref, R), (port, Q)):
        sched = pkg.round_robin(N, 1)
        net.deploy_topo(sched)
        net.deploy_routing(pkg.hoho(sched))
        assert net.add(0, 3, 5, arr_ts=2, dep_ts=4)
        assert net.add(1, 2, 2)
    wl = _workload()
    assert_sim_equal(ref.run(wl, 24),
                     port.run(Q.fabric.workload_from_arrays(wl.__dict__), 24))


def test_net_run_ta_matches_reference():
    """The TA loop over two windows on static meshes (the networkx
    schedulers are not ported, so the topology function is a mesh)."""
    ref, port = _nets(N, dict(slice_bytes=4_000))
    wins = [R.synthesize("kvstore", N, 10, slice_bytes=4_000, load=0.8,
                         max_packets=400, seed=s) for s in (1, 2)]
    ra = ref.run_ta(wins, 12, lambda tm: R.uniform_mesh(N, 2),
                    lambda s: R.ecmp(s))
    rb = port.run_ta([Q.fabric.workload_from_arrays(w.__dict__)
                      for w in wins], 12, lambda tm: Q.uniform_mesh(N, 2),
                     lambda s: Q.ecmp(s))
    assert len(ra) == len(rb) == 2
    for a, b in zip(ra, rb):
        assert_sim_equal(a, b)
    np.testing.assert_array_equal(ref.collect(), port.collect())
