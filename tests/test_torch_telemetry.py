"""The PyTorch port's telemetry counters (on the CPU) against
``repro.core.simulate``'s, every ``TelemetryCounters`` field and every
``SimResult`` field bit for bit, at the default histogram edges and at
custom ones, with failures, control and telemetry together, and the
``OpenOpticsNet`` fault APIs (``inject_failure``, ``heal``,
``inject_control``, ``heal_control``) window by window against
``repro.OpenOpticsNet``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as Q  # noqa: E402
from repro_torch.core.fabric import workload_from_arrays  # noqa: E402

from torch_parity import (  # noqa: E402, F401
    assert_sim_equal, carry, carry_masks, release_compiled_programs)

N = 8
SLICES = 48


def _workload(seed=11, load=0.9, t=24, packets=420):
    return R.synthesize("rpc", N, t, slice_bytes=4_000, load=load,
                        max_packets=packets, seed=seed)


def _tables(alg=R.ucmp):
    sched = R.round_robin(N, 1)
    return sched, R.FabricTables.build(sched, alg(sched))


def _both(tables, wl, cfg, edges=None, failures=None, control=None):
    rt = R.TelemetryConfig() if edges is None else R.TelemetryConfig(edges)
    qt_ = Q.TelemetryConfig() if edges is None else Q.TelemetryConfig(edges)
    ref = R.simulate(tables, wl, R.FabricConfig(**cfg), SLICES,
                     failures=failures, control=control, telemetry=rt)
    qt, qw = carry(tables, wl)
    qf, qc = carry_masks(failures, control)
    port = Q.simulate(qt, qw, Q.FabricConfig(**cfg), SLICES, device="cpu",
                      telemetry=qt_, failures=qf, control=qc)
    assert_sim_equal(ref, port)
    assert isinstance(port.telemetry, Q.TelemetryCounters)
    return ref, port


@pytest.mark.parametrize("cfg", [
    dict(slice_bytes=4_000),
    # a small switch buffer: drops on arrival, push-back, offloading
    dict(slice_bytes=4_000, pushback=True, offload=True, offload_horizon=1,
         switch_buffer=12_000),
    # vlb's two-hop paths overflow a small buffer in transit
    dict(slice_bytes=4_000, switch_buffer=9_000, elec_bytes=1_000),
], ids=["default", "pushback-offload", "drops-electrical"])
def test_telemetry_matches_reference(cfg):
    alg = R.vlb if cfg.get("switch_buffer") == 9_000 else R.ucmp
    _, port = _both(_tables(alg)[1], _workload(), cfg)
    tele = port.telemetry
    assert tele.injected_bytes.sum() > 0 and tele.deferred_bytes.sum() > 0
    assert tele.util_used.sum() > 0 and tele.lat_hist.sum() > 0
    assert tele.num_slices == SLICES and tele.num_nodes == N
    if cfg.get("switch_buffer", 1 << 26) < 10_000:
        assert tele.dropped_bytes.sum() > 0
    # the other fields are the run without telemetry
    qt, qw = carry(_tables(alg)[1], _workload())
    plain = Q.simulate(qt, qw, Q.FabricConfig(**cfg), SLICES, device="cpu")
    port.telemetry = None
    assert_sim_equal(plain, port)


def test_telemetry_custom_edges_match_reference():
    _, port = _both(_tables()[1], _workload(load=1.4, packets=600),
                    dict(slice_bytes=4_000), edges=(0, 3, 5, 40))
    assert port.telemetry.lat_edges == (0, 3, 5, 40)
    assert port.telemetry.lat_hist.shape == (SLICES, 5)
    assert (port.telemetry.lat_hist[:, 1:].sum(0) > 0).sum() >= 3


def test_telemetry_zero_slices():
    qt, qw = carry(_tables()[1], _workload())
    res = Q.simulate(qt, qw, Q.FabricConfig(slice_bytes=4_000), 0,
                     device="cpu", telemetry=Q.TelemetryConfig())
    ref = R.simulate(_tables()[1], _workload(),
                     R.FabricConfig(slice_bytes=4_000), 0,
                     telemetry=R.TelemetryConfig())
    assert_sim_equal(ref, res)


def test_telemetry_config_checks():
    for bad in ((), (3, 2), (-1, 4), (2, 2)):
        with pytest.raises(ValueError, match="lat_edges"):
            Q.TelemetryConfig(bad)
    assert Q.TelemetryConfig([1, 4]).lat_edges == (1, 4)


@pytest.mark.parametrize("alg", ["ucmp", "vlb"])
def test_failures_control_and_telemetry_together(alg):
    sched, tables = _tables(getattr(R, alg))
    fail = R.compile_masks(
        R.FailureTrace().tor_outage(3, 4, 20).degrade(0, 5, 0.45, 0)
        .link_flap(6, 1, 10).stuck_port(2, 0, 0, 30), sched, SLICES)
    ctrl = R.compile_control(
        R.ControlTrace().skew(1, -2000.0, 0).skew(4, 2600.0, 6)
        .skew(7, 2000.0 * 8, 3, 40).drift(5, 130.0, 0), SLICES, N)
    cfg = dict(slice_bytes=4_000, pushback=True, switch_buffer=20_000,
               flow_pausing=alg == "vlb")
    _both(tables, _workload(), cfg, failures=fail, control=ctrl)


# ---------------------------------------------------------------------------
# the net's fault APIs, window by window
# ---------------------------------------------------------------------------

def test_net_fault_apis_match_reference_window_by_window():
    cfg = dict(node="rack", node_num=N, uplink=1, slice_us=2.0,
               fabric=dict(slice_bytes=4_000), telemetry=dict(lat_edges=(2, 8)))
    ref, port = R.OpenOpticsNet(cfg), Q.OpenOpticsNet(cfg, device="cpu")
    assert port.telemetry == Q.TelemetryConfig((2, 8))
    for net, pkg in ((ref, R), (port, Q)):
        sched = pkg.round_robin(N, 1)
        net.deploy_topo(sched)
        net.deploy_routing(pkg.ucmp(sched))
    win = 12
    steps = [
        [],                                             # a healthy window
        [("inject_failure", "tor", dict(node=3)),       # at the clock: 12
         ("inject_failure", "degrade", dict(node=1, dst=2, scale=0.4)),
         ("inject_failure", "link", dict(node=5, dst=6, t_start=15,
                                         t_end=40)),
         ("inject_control", "skew", dict(node=4, skew_ns=-2000.0)),
         ("inject_control", "skew", dict(node=0, skew_ns=2650.0,
                                         t_start=16, t_end=21))],
        [("heal", None, dict()),                        # failures end at 24
         ("inject_failure", "port", dict(node=2, uplink=0, t_start=29,
                                         t_end=33)),
         ("inject_control", "drift", dict(node=6, drift_ns=250.0))],
        [("heal_control", None, dict(t=38))],           # mid-window
        [("heal", None, dict()), ("heal_control", None, dict())],
    ]
    for i, acts in enumerate(steps):
        for name, kind, kw in acts:
            for net in (ref, port):
                assert getattr(net, name)(*(() if kind is None else (kind,)),
                                          **kw)
        wl = _workload(seed=20 + i, t=8, packets=150)
        a = ref.run(wl, win)
        b = port.run(workload_from_arrays(dataclasses.asdict(wl)), win)
        assert_sim_equal(a, b)
        assert b.telemetry is None          # run() does not count
        assert port._clock == ref._clock == win * (i + 1)
    assert [dataclasses.astuple(e) for e in port.failure_trace.events] == \
        [dataclasses.astuple(e) for e in ref.failure_trace.events]
    assert [dataclasses.astuple(e) for e in port.control_trace.events] == \
        [dataclasses.astuple(e) for e in ref.control_trace.events]


def test_net_fault_api_errors():
    port = Q.OpenOpticsNet(dict(node_num=N), device="cpu")
    with pytest.raises(ValueError, match="failure kind"):
        port.inject_failure("meteor", node=1)
    with pytest.raises(ValueError, match="control fault kind"):
        port.inject_control("solar-flare", node=1)
    assert port.telemetry is None
    assert port.inject_control("stall", t_start=3, t_end=9)
    assert port.inject_control("install_delay", delay=2)
    assert port.inject_control("install_loss", loss=0.5, node=2)
