"""Paper §6 Case I on the port: the seven architectures of fig8 (8 ToRs,
10 us slices, its two-class workload) built by
``examples/architecture_comparison_torch.py`` against the reference's
``benchmarks.common.build_arch`` on the CPU: the deployed schedule, the
compiled tables, the fabric config and the workload equal, and
``net.run`` equal in every ``SimResult`` field over the first 100 slices
(the run cut from fig8's 700: the reference compiles each architecture's
program for 12-17 s, whatever the length). Mordia's ``bvn`` runs with the
reference's bipartite matching pinned to integer labels (its own labels
make it depend on ``PYTHONHASHSEED``; ``test_torch_schedulers.py``).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.topology as R_topo  # noqa: E402
from benchmarks.common import build_arch as ref_build_arch  # noqa: E402
from benchmarks.common import traffic_tm  # noqa: E402
from benchmarks.fig8_fct import ARCHS, N, SLICE_US, _workload  # noqa: E402
from test_torch_schedulers import _nx_perfect_matching  # noqa: E402
from torch_parity import (assert_sim_equal, one_torch_thread,  # noqa: E402, F401
                          release_compiled_programs)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
import architecture_comparison_torch as arch  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RUN_SLICES = 100


def test_example_copies_fig8():
    """The example's architecture list, sizes and workload are fig8's."""
    assert arch.ARCHS == ARCHS
    assert (arch.N, arch.SLICE_US) == (N, SLICE_US)
    ref, n_mice = _workload()
    got, q_mice = arch.fig8_workload()
    assert n_mice == q_mice
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(ref, f.name), err_msg=f.name)
    np.testing.assert_array_equal(arch.traffic_tm(got, N), traffic_tm(ref, N))


def _both(name):
    wl, _ = _workload()
    ref = ref_build_arch(name, N, SLICE_US, tm=traffic_tm(wl, N)).net
    qwl, _ = arch.fig8_workload()
    net = arch.build_arch(name, N, SLICE_US, tm=arch.traffic_tm(qwl, N),
                          device="cpu")
    _check_deployed(ref, net)
    return wl, ref, qwl, net


def _check_deployed(ref, net):
    """The same config, schedule and tables."""
    assert dataclasses.asdict(net.fabric_cfg) == {
        k: v for k, v in dataclasses.asdict(ref.fabric_cfg).items()
        if k not in ("lookup_impl", "admit_impl")}
    assert (net.n_uplinks, net.slice_us) == (ref.n_uplinks, ref.slice_us)
    np.testing.assert_array_equal(net.schedule.conn, ref.schedule.conn)
    assert (net.schedule.slice_us, net.schedule.reconf_us) == \
        (ref.schedule.slice_us, ref.schedule.reconf_us)
    for k in ("tf_next", "tf_dep", "inj_next", "inj_dep"):
        np.testing.assert_array_equal(getattr(net.routing, k),
                                      getattr(ref.routing, k), err_msg=k)
    assert net.routing.multipath == ref.routing.multipath


@pytest.mark.parametrize("name", ARCHS)
def test_architecture_matches_reference(name, monkeypatch):
    monkeypatch.setattr(R_topo, "_perfect_matching", _nx_perfect_matching)
    wl, ref, qwl, net = _both(name)
    assert_sim_equal(ref.run(wl, RUN_SLICES), net.run(qwl, RUN_SLICES))


def test_chip_smoke_digests_are_the_references(monkeypatch):
    """``chip_smoke.py`` phase 21 holds what the card's machine deploys
    against digests: each architecture's schedule and tables at fig8's
    size, and the schedules of ``edmonds``, ``jupiter`` (4 uplinks) and
    ``bvn`` (216 peels) on phase 4's 108-ToR traffic matrix. They are the
    reference's."""
    import chip_smoke as cs
    monkeypatch.setattr(R_topo, "_perfect_matching", _nx_perfect_matching)
    wl, _ = _workload()
    tm = traffic_tm(wl, N)
    for name in ARCHS:
        ref = ref_build_arch(name, N, SLICE_US, tm=tm).net
        assert cs.arch_digest(ref) == cs.ARCH_DIGESTS[name], name
    import repro.core as R
    ref_wl = R.synthesize("rpc", cs.N_TORS, 64, slice_bytes=75_000, load=0.4,
                          max_packets=cs.P_MAIN, seed=0)
    tm = traffic_tm(ref_wl, cs.N_TORS)
    np.testing.assert_array_equal(
        tm, arch.traffic_tm(cs.main_workload(), cs.N_TORS))
    us = cs.SLICE_US
    scheds = dict(
        edmonds=R_topo.edmonds(tm, slice_us=us),
        jupiter=R_topo.jupiter(tm, n_nodes=cs.N_TORS, n_uplinks=4,
                               max_moves=16, slice_us=us),
        bvn=R_topo.bvn(tm, max_perms=2 * cs.N_TORS, slice_us=us))
    for name, sched in scheds.items():
        assert cs.digest(sched.conn) == cs.SCHED_DIGESTS_108[name], name
