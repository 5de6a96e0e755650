"""The port's scenario sweep (``repro_torch.core.simulate_fleet``) on the
CPU against the reference's vmapped ``repro.simulate_fleet`` and against
the port's own solo ``simulate`` of each scenario: every ``SimResult``
field and telemetry counter equal, values and dtypes, for traffic-seed,
failure-trace, per-scenario-table and telemetry sweeps (the port's
counterparts of ``tests/test_scenario_vmap.py``'s ``simulate_fleet``
tests), for per-packet multipath over several paths (each scenario's
packets must hash their index within their scenario, or scenarios 1 and
up go astray), for per-flow multipath, and for the mask and shape checks.
All at N = 8, 48 slices.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as Q  # noqa: E402
from torch_parity import (assert_sim_equal, carry, carry_masks,  # noqa: E402, F401
                          one_torch_thread, release_compiled_programs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 8
SLICES = 48


def _wl(seed, max_packets=420):
    return R.synthesize("rpc", N, 24, slice_bytes=4_000, load=0.9,
                        max_packets=max_packets, seed=seed)


def _check_fleet(tables, wls, cfg, failures=None, control=None,
                 telemetry=None):
    """The port's sweep against the reference's and against the port's
    solo runs, scenario by scenario; returns the port's results."""
    ref_tele = None if telemetry is None else R.TelemetryConfig()
    refs = R.simulate_fleet(tables, wls, R.FabricConfig(**cfg), SLICES,
                            failures=failures, control=control,
                            telemetry=ref_tele)
    tabs = tables if isinstance(tables, list) else [tables]
    qtabs = [carry(t, wls[0])[0] for t in tabs]
    qwls = [carry(tabs[0], w)[1] for w in wls]
    masks = [carry_masks(f, c) for f, c in zip(
        failures or [None] * len(wls), control or [None] * len(wls))]
    qf = None if failures is None else [m[0] for m in masks]
    qc = None if control is None else [m[1] for m in masks]
    qcfg = Q.FabricConfig(**cfg)
    got = Q.simulate_fleet(qtabs if isinstance(tables, list) else qtabs[0],
                           qwls, qcfg, SLICES, failures=qf, control=qc,
                           telemetry=telemetry, device="cpu")
    assert len(got) == len(wls)
    for i, g in enumerate(got):
        assert_sim_equal(refs[i], g)
        solo = Q.simulate(qtabs[i % len(qtabs)], qwls[i], qcfg, SLICES,
                          failures=None if qf is None else qf[i],
                          control=None if qc is None else qc[i],
                          telemetry=telemetry, device="cpu")
        assert_sim_equal(solo, g)
    return got


def test_fleet_seed_sweep_bit_identical():
    """Six traffic seeds on one table set with push-back: each member
    equals the reference's member and the port's solo run."""
    sched = R.round_robin(N, 1)
    tables = R.FabricTables.build(sched, R.ucmp(sched))
    _check_fleet(tables, [_wl(s) for s in range(6)],
                 dict(slice_bytes=4_000, switch_buffer=30_000,
                      cc_detect=True, pushback=True))


@pytest.mark.parametrize("alg,cfg", [
    (R.vlb, dict(slice_bytes=4_000)),
    (R.vlb, dict(slice_bytes=4_000, switch_buffer=30_000, pushback=True,
                 offload=True)),
    (R.ucmp, dict(slice_bytes=4_000))],
    ids=["vlb-default", "vlb-pushback-offload", "ucmp-default"])
def test_fleet_per_packet_multipath_sweep(alg, cfg):
    """Several paths over two uplinks, picked by a hash of each packet's
    index salted with the slice: a lookup that hashed the global packet
    index (``b·P + p``) would send scenarios 1 and up down other paths.
    Every member is checked, and the members' results differ, so a mix-up
    between scenarios shows. (Over one uplink ``vlb`` keeps one valid slot
    an entry, so its hash picks nothing.)"""
    sched = R.round_robin(N, 2)
    tables = R.FabricTables.build(sched, alg(sched, kpaths=3))
    assert tables.multipath == "packet"
    assert ((tables.inj_next >= 0).sum(-1) > 1).any()
    got = _check_fleet(tables, [_wl(s) for s in range(4)], cfg)
    assert any((g.t_deliver != got[0].t_deliver).any() for g in got[1:])


def test_fleet_per_flow_multipath_sweep():
    """``wcmp`` on a 2-uplink mesh hashes the flow id: each scenario
    hashes its own flow ids, and its in-order tracking keeps its own
    flows. The scenarios carry different flow counts."""
    sched = R.uniform_mesh(N, 2)
    tables = R.FabricTables.build(sched, R.wcmp(sched))
    assert tables.multipath == "flow"
    wls = [_wl(s, max_packets=300) for s in range(3)]
    assert len({w.num_flows for w in wls}) > 1
    _check_fleet(tables, wls, dict(slice_bytes=4_000, cc_detect=True))


def test_fleet_failure_trace_sweep_bit_identical():
    """One workload under four seeded failure traces and control traces,
    with flow pausing (the per-scenario direct-circuit offsets at each
    ToR's local slice)."""
    sched = R.round_robin(N, 1)
    tables = R.FabricTables.build(sched, R.ucmp(sched))
    wl = _wl(0)
    fms = [R.compile_masks(R.random_trace(s, sched, SLICES, n_events=4),
                           sched, SLICES) for s in range(4)]
    cms = [R.compile_control(R.random_control_trace(s, N, SLICES,
                                                    n_events=3), SLICES, N)
           for s in range(4)]
    _check_fleet(tables, [wl] * 4, dict(slice_bytes=4_000, cc_detect=True,
                                        flow_pausing=True),
                 failures=fms, control=cms)


def test_fleet_batched_tables_bit_identical():
    """Per-scenario tables of one shape (the same scheme over a relabelled
    schedule) ride the node axis."""
    base = R.round_robin(N, 1)
    perm = np.roll(np.arange(N), 3)
    relabeled = dataclasses.replace(base, conn=np.where(
        base.conn >= 0, perm[base.conn], base.conn)[:, np.argsort(perm), :])
    tables = [R.FabricTables.build(s, R.ucmp(s)) for s in (base, relabeled)]
    wl = _wl(3)
    _check_fleet(tables, [wl, wl], dict(slice_bytes=4_000))


def test_fleet_telemetry_parity():
    """Telemetry counters come per scenario: each member's counter rows
    equal the reference's member and the port's solo run, and
    conservation holds per scenario."""
    sched = R.round_robin(N, 1)
    tables = R.FabricTables.build(sched, R.ucmp(sched))
    wls = [_wl(s) for s in range(4)]
    fms = [R.compile_masks(R.random_trace(s, sched, SLICES, n_events=3),
                           sched, SLICES) for s in range(4)]
    got = _check_fleet(tables, wls, dict(slice_bytes=4_000, cc_detect=True,
                                         pushback=True),
                       failures=fms, telemetry=Q.TelemetryConfig())
    for g, wl in zip(got, wls):
        assert Q.toolkit.check_telemetry(g, carry(tables, wl)[1],
                                         SLICES) == []


def test_fleet_of_one_is_simulate():
    """A sweep of one scenario is the solo program: the same result."""
    sched = Q.round_robin(N, 1)
    tables = Q.FabricTables.build(sched, Q.vlb(sched, kpaths=2))
    wl = carry(R.FabricTables.build(R.round_robin(N, 1), R.vlb(
        R.round_robin(N, 1), kpaths=2)), _wl(5))[1]
    cfg = Q.FabricConfig(slice_bytes=4_000)
    (got,) = Q.simulate_fleet(tables, [wl], cfg, SLICES, device="cpu")
    assert_sim_equal(Q.simulate(tables, wl, cfg, SLICES, device="cpu"), got)
    assert Q.simulate_fleet(tables, [], cfg, SLICES, device="cpu") == []


def test_fleet_rejects_mixed_mask_presence_and_shapes():
    """Mask presence adds branches to the one step, so it must agree
    across the sweep; tables must share shapes and multipath mode,
    workloads a packet count, and there is one table set or one per
    scenario."""
    sched = Q.round_robin(N, 1)
    tables = Q.FabricTables.build(sched, Q.ucmp(sched))
    rsched = R.round_robin(N, 1)
    wl = carry(R.FabricTables.build(rsched, R.ucmp(rsched)), _wl(0))[1]
    cfg = Q.FabricConfig(slice_bytes=4_000)
    fm = Q.compile_masks(Q.random_trace(0, sched, SLICES), sched, SLICES)
    cm = Q.ControlMasks.perfect(SLICES, N)
    run = lambda *a, **kw: Q.simulate_fleet(*a, device="cpu", **kw)
    with pytest.raises(ValueError, match="one mask set per scenario"):
        run(tables, [wl] * 2, cfg, SLICES, failures=[fm, None])
    with pytest.raises(ValueError, match="one mask set per scenario"):
        run(tables, [wl] * 2, cfg, SLICES, control=[cm])
    with pytest.raises(ValueError, match="do not cover"):
        run(tables, [wl] * 2, cfg, SLICES + 1, failures=[fm, fm])
    with pytest.raises(ValueError, match="packet count"):
        run(tables, [wl, carry(R.FabricTables.build(
            rsched, R.ucmp(rsched)), _wl(1, max_packets=300))[1]], cfg,
            SLICES)
    with pytest.raises(ValueError, match="tables for"):
        run([tables] * 3, [wl] * 2, cfg, SLICES)
    with pytest.raises(ValueError, match="multipath"):
        run([tables, dataclasses.replace(tables, multipath="flow")],
            [wl] * 2, cfg, SLICES)
    other = Q.FabricTables.build(sched, Q.vlb(sched, kpaths=2))
    with pytest.raises(ValueError, match="share shapes"):
        run([tables, other], [wl] * 2, cfg, SLICES)
