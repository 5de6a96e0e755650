"""The PyTorch port's incremental API and clocked service (on the CPU,
through the kernels' plain versions) against ``repro``: every
``SimResult`` field and telemetry counter bit for bit, values and dtypes.

* ``simulate_incremental`` at windows of 1, 5, 7 slices and one window,
  without optional inputs and with failure masks, control masks and
  telemetry together, against the reference's one-shot ``simulate`` (the
  reference's own suites hold its incremental runs to its one-shot run);
* packets ingested mid-run equal the one-shot run of their union;
  ``finalize`` as a checkpoint; an empty start; the argument checks;
* ``OpenOpticsNet``'s service (``ingest``, ``advance``, ``snapshot``,
  ``service_result``) against the reference's service after every window,
  with faults injected between windows, and its shift of flow ids and
  inject slices.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as Q  # noqa: E402
from repro_torch.core.fabric import workload_from_arrays  # noqa: E402

from torch_parity import (  # noqa: E402, F401
    assert_sim_equal, carry, carry_masks, release_compiled_programs)

N = 8
SLICES = 48
SLICE_NS = 2000.0      # compile_control's default slice
CFGS = {
    "plain": dict(slice_bytes=4_000),
    "control": dict(slice_bytes=4_000, flow_pausing=True),
    "all": dict(slice_bytes=4_000, pushback=True, switch_buffer=40_000),
}


def _workload(seed=5, packets=400):
    return R.synthesize("rpc", N, 40, slice_bytes=4_000, load=0.5,
                        max_packets=packets, seed=seed)


def _tables(alg=R.ucmp):
    sched = R.round_robin(N, 1)
    return sched, R.FabricTables.build(sched, alg(sched))


def _masks(sched):
    """Faults that start and heal inside windows: a link flap, a ToR
    outage, a stuck port, a degraded link; a ToR a slice behind, one a
    slice and 650 ns ahead for a while, one that drifts."""
    fail = R.compile_masks(
        R.FailureTrace().link_flap(0, 1, 0, 30).tor_outage(7, 12, 26)
        .stuck_port(3, 0, 6, 33).degrade(4, 5, 0.37, 3), sched, SLICES)
    ctrl = R.compile_control(
        R.ControlTrace().skew(1, -SLICE_NS, 0).skew(2, SLICE_NS + 650.0, 5, 20)
        .drift(6, 130.0, 3), SLICES, N)
    return fail, ctrl


def _inputs(name, sched):
    """(reference kwargs, port kwargs) of one input set: none; control
    masks alone (the step's cycle capacities with re-based mask rows);
    failure and control masks with telemetry."""
    if name == "plain":
        return {}, {}
    fail, ctrl = _masks(sched)
    qf, qc = carry_masks(fail, ctrl)
    if name == "control":
        return dict(control=ctrl), dict(control=qc)
    return (dict(failures=fail, control=ctrl, telemetry=R.TelemetryConfig()),
            dict(failures=qf, control=qc, telemetry=Q.TelemetryConfig()))


@pytest.fixture(scope="module")
def one_shot():
    """The reference's one-shot run of each input set, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            sched, tables = _tables()
            kw, _ = _inputs(name, sched)
            cache[name] = R.simulate(tables, _workload(),
                                     R.FabricConfig(**CFGS[name]), SLICES,
                                     **kw)
        return cache[name]
    return get


@pytest.mark.parametrize("window", [1, 5, 7, None])
@pytest.mark.parametrize("name", list(CFGS))
def test_windows_match_reference(one_shot, name, window):
    sched, tables = _tables()
    _, qkw = _inputs(name, sched)
    qt, qw = carry(tables, _workload())
    port = Q.simulate_incremental(qt, qw, Q.FabricConfig(**CFGS[name]),
                                  SLICES, window=window, device="cpu", **qkw)
    ref = one_shot(name)
    assert_sim_equal(ref, port)
    if name != "plain":
        assert ref.slice_miss.sum() > 0


def _subset(wl, mask):
    return Q.Workload(**{f.name: getattr(wl, f.name)[mask]
                         for f in dataclasses.fields(wl)})


def _window_masks(qf, qc, t0, t1):
    """Rows [t0, t1) of the port's run-long masks (None stays None)."""
    if qf is not None:
        qf = dataclasses.replace(qf, link_cap=qf.link_cap[t0:t1],
                                 node_ok=qf.node_ok[t0:t1])
    if qc is not None:
        qc = dataclasses.replace(qc, **{k: getattr(qc, k)[t0:t1] for k in (
            "skew_ns", "phase_off", "skew_miss", "ctrl_delay", "ctrl_ok")})
    return qf, qc


@pytest.mark.parametrize("name", list(CFGS))
def test_mid_run_ingest_equals_union(name):
    """Packets ingested in three batches, each before its first inject
    slice, in windows that cross the batches and the faults: the one-shot
    run of the workload in the same packet order. Flows continue across
    batches, so the reorder tracking carries over."""
    sched, tables = _tables()
    rkw, qkw = _inputs(name, sched)
    qt, qw = carry(tables, _workload())
    bounds = [0, 10, 23, SLICES + 100]
    batches = [_subset(qw, (qw.t_inject >= a) & (qw.t_inject < b))
               for a, b in zip(bounds, bounds[1:])]
    order = np.concatenate([np.flatnonzero((qw.t_inject >= a) &
                                           (qw.t_inject < b))
                            for a, b in zip(bounds, bounds[1:])])
    ref_wl = R.Workload(**{f.name: getattr(_workload(), f.name)[order]
                           for f in dataclasses.fields(R.Workload)})
    assert all(b.num_packets for b in batches)
    ref = R.simulate(tables, ref_wl, R.FabricConfig(**CFGS[name]), SLICES,
                     **rkw)
    fs = Q.init_state(qt, batches[0], Q.FabricConfig(**CFGS[name]),
                      qkw.get("telemetry"), device="cpu")
    for t1 in (4, 10, 11, 23, 30, SLICES):
        if fs.clock in bounds[1:3]:
            Q.ingest(fs, batches[bounds.index(fs.clock)])
        t0 = fs.clock
        masks = _window_masks(qkw.get("failures"), qkw.get("control"), t0,
                              t1)
        Q.step_slices(fs, t1 - t0, *masks)
    assert fs.num_packets == qw.num_packets
    assert_sim_equal(ref, Q.finalize(fs))
    assert fs.num_flows == ref_wl.num_flows


def test_finalize_is_a_checkpoint(one_shot):
    """``finalize`` between windows returns the run so far (the one-shot
    run of that many slices) and leaves the run live: a second call gives
    the same, and the run goes on to the one-shot result."""
    sched, tables = _tables()
    cfg = CFGS["plain"]
    ref20 = R.simulate(tables, _workload(), R.FabricConfig(**cfg), 20)
    qt, qw = carry(tables, _workload())
    fs = Q.init_state(qt, qw, Q.FabricConfig(**cfg), device="cpu")
    Q.step_slices(Q.step_slices(fs, 13), 7)
    assert_sim_equal(ref20, Q.finalize(fs))
    assert_sim_equal(ref20, Q.finalize(fs))
    Q.step_slices(fs, SLICES - 20)
    assert_sim_equal(one_shot("plain"), Q.finalize(fs))


def test_empty_start_and_argument_checks(one_shot):
    """An empty fabric advanced for a while equals the reference's empty
    fabric; an empty start with the workload ingested at slice 0 equals
    the one-shot run; a zero-slice window adds no rows; ``window`` must be
    positive, and a negative window raises."""
    sched, tables = _tables()
    cfg = CFGS["all"]
    tele = dict(telemetry=R.TelemetryConfig((2, 8)))
    ref = R.finalize(R.step_slices(R.init_state(
        tables, None, R.FabricConfig(**cfg), **tele), 5))
    qt, qw = carry(tables, _workload())
    fs = Q.init_state(qt, None, Q.FabricConfig(**cfg),
                      Q.TelemetryConfig((2, 8)), device="cpu")
    assert_sim_equal(R.finalize(R.init_state(
        tables, None, R.FabricConfig(**cfg), **tele)), Q.finalize(fs))
    Q.step_slices(fs, 0)
    port = Q.finalize(Q.step_slices(fs, 5))
    assert_sim_equal(ref, port)
    assert port.buf_bytes.shape == (5, N) and port.t_deliver.shape == (0,)

    fs = Q.init_state(qt, None, Q.FabricConfig(**CFGS["plain"]), device="cpu")
    Q.ingest(fs, qw)
    Q.step_slices(fs, SLICES)
    assert_sim_equal(one_shot("plain"), Q.finalize(fs))

    for window in (0, -3):
        with pytest.raises(ValueError, match="window must be positive"):
            R.simulate_incremental(tables, _workload(), R.FabricConfig(),
                                   SLICES, window=window)
        with pytest.raises(ValueError, match="window must be positive"):
            Q.simulate_incremental(qt, qw, Q.FabricConfig(), SLICES,
                                   window=window, device="cpu")
    with pytest.raises(ValueError, match="num_slices"):
        Q.step_slices(fs, -1)
    fail, _ = _masks(sched)
    with pytest.raises(ValueError, match="do not cover"):
        Q.step_slices(fs, 4, failures=carry_masks(fail)[0])


# ---------------------------------------------------------------------------
# the net's clocked service
# ---------------------------------------------------------------------------

def _nets(telemetry=True):
    cfg = dict(node="rack", node_num=N, uplink=1, slice_us=2.0,
               fabric=dict(slice_bytes=4_000))
    if telemetry:
        cfg["telemetry"] = dict(lat_edges=(2, 8))
    ref, port = R.OpenOpticsNet(cfg), Q.OpenOpticsNet(cfg, device="cpu")
    for net, pkg in ((ref, R), (port, Q)):
        sched = pkg.round_robin(N, 1)
        net.deploy_topo(sched)
        net.deploy_routing(pkg.ucmp(sched))
    return ref, port


def _assert_frames_equal(a, b):
    assert a.keys() == b.keys()
    assert (a["clock"], a["packets"], a["bytes"]) == \
        (b["clock"], b["packets"], b["bytes"])
    assert (a["counters"] is None) == (b["counters"] is None)
    if a["counters"] is not None:
        assert a["counters"].keys() == b["counters"].keys()
        for k, v in a["counters"].items():
            w = b["counters"][k]
            if k == "lat_edges":
                assert v == w
            else:
                assert v.dtype == w.dtype, k
                np.testing.assert_array_equal(v, w, err_msg=k)


def test_service_matches_reference_window_by_window():
    """Three demand batches, advances of 12 slices, and faults injected
    and healed between windows through the user API: after every advance
    the snapshot and the ``service_result`` equal the reference's, and
    the counters of the snapshot are the result's counters summed."""
    ref, port = _nets()
    _assert_frames_equal(ref.snapshot(), port.snapshot())
    plan = [
        ("ingest", 0),
        ("advance", 12),
        ("fault", [("inject_failure", "tor", dict(node=3)),
                   ("inject_failure", "link", dict(node=5, dst=6,
                                                   t_start=15, t_end=40)),
                   ("inject_control", "skew", dict(node=4,
                                                   skew_ns=-SLICE_NS))]),
        ("ingest", 1),
        ("advance", 12),
        ("fault", [("heal", None, dict()),
                   ("inject_control", "drift", dict(node=6, drift_ns=250.0))]),
        ("ingest", 2),
        ("advance", 19),
        ("fault", [("heal_control", None, dict())]),
        ("advance", 5),
    ]
    for what, arg in plan:
        if what == "ingest":
            wl = _workload(seed=20 + arg, packets=150)
            assert ref.ingest(wl)
            assert port.ingest(workload_from_arrays(dataclasses.asdict(wl)))
            continue
        if what == "fault":
            for name, kind, kw in arg:
                for net in (ref, port):
                    assert getattr(net, name)(
                        *(() if kind is None else (kind,)), **kw)
            continue
        assert ref.advance(arg) and port.advance(arg)
        frame = port.snapshot()
        _assert_frames_equal(ref.snapshot(), frame)
        res = port.service_result()
        assert_sim_equal(ref.service_result(), res)
        tele = res.telemetry
        assert frame["packets"]["total"] == sum(
            frame["packets"][k] for k in ("pending", "in_flight",
                                          "delivered", "dropped"))
        assert frame["bytes"]["total"] == sum(
            frame["bytes"][k] for k in ("pending", "in_flight", "delivered",
                                        "dropped"))
        np.testing.assert_array_equal(frame["counters"]["injected_bytes"],
                                      tele.injected_bytes.sum(0))
        np.testing.assert_array_equal(frame["counters"]["lat_hist"],
                                      tele.lat_hist.sum(0))
        assert port._clock == ref._clock
    assert port._clock == 48 and res.t_deliver.shape == (450,)
    assert frame["packets"]["delivered"] > 0


def test_service_shifts_flow_ids_and_inject_slices():
    """The service's ``ingest`` takes ``t_inject`` relative to its clock
    and offsets flow ids past every flow ingested so far, as the
    reference's; without a telemetry config the snapshot has no counters,
    and ``advance`` wants a positive count."""
    ref, port = _nets(telemetry=False)
    with pytest.raises(ValueError, match="positive"):
        port.advance(0)
    with pytest.raises(RuntimeError, match="deploy_topo"):
        Q.OpenOpticsNet(dict(node_num=N), device="cpu").advance(1)
    batches = [_workload(seed=30 + i, packets=60) for i in range(2)]
    for i, wl in enumerate(batches):
        assert ref.ingest(wl)
        assert port.ingest(workload_from_arrays(dataclasses.asdict(wl)))
        assert ref.advance(9) and port.advance(9)
    fs = port._service
    for k in ("t_inject", "flow", "src", "dst", "size", "seq", "is_eleph"):
        np.testing.assert_array_equal(fs.j[k].numpy(),
                                      np.asarray(ref._service.j[k]), k)
    # an empty service starts with one flow slot, so the first batch's
    # flows are offset by 1 and the second's past the first's too
    P0 = batches[0].num_packets
    np.testing.assert_array_equal(fs.j["t_inject"].numpy(), np.concatenate(
        [batches[0].t_inject, batches[1].t_inject + 9]))
    np.testing.assert_array_equal(fs.j["flow"].numpy(), np.concatenate(
        [batches[0].flow + 1, batches[1].flow + 1 + batches[0].num_flows]))
    assert fs.num_packets == P0 + batches[1].num_packets
    assert fs.num_flows == ref._service.num_flows
    _assert_frames_equal(ref.snapshot(), port.snapshot())
    assert port.snapshot()["counters"] is None
    assert_sim_equal(ref.service_result(), port.service_result())
