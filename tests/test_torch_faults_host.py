"""The PyTorch port's host fault layers against ``repro``'s: failure traces
and their masks (``repro_torch.core.failures``), control-plane traces and
their masks (``repro_torch.core.controlplane``) and the §7 guard-band
derivation (``repro_torch.core.guardband``). All numpy: every array equal
in value, shape and dtype, for several seeds and hand-built traces.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.core.guardband as R_gb  # noqa: E402
import repro_torch.core as Q  # noqa: E402
import repro_torch.core.controlplane as Q_cp  # noqa: E402
import repro_torch.core.guardband as Q_gb  # noqa: E402

from torch_parity import release_compiled_programs  # noqa: E402, F401

N = 8
S = 48


def _equal(a, b, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


def _masks_equal(ref, port):
    assert type(port).__name__ == type(ref).__name__
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(a, np.ndarray):
            _equal(a, b, f.name)
        else:
            assert a == b, f.name


def _events(trace):
    return [dataclasses.astuple(e) for e in trace.events]


def _same_failure_trace(ref):
    """The reference's trace rebuilt from the port's event class."""
    return Q.FailureTrace([Q.FailureEvent(*dataclasses.astuple(e))
                           for e in ref.events])


def _same_control_trace(ref):
    return Q.ControlTrace([Q.ControlEvent(*dataclasses.astuple(e))
                           for e in ref.events])


# ---------------------------------------------------------------------------
# failures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("uplinks", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_trace_and_masks_equal(seed, uplinks):
    rs, qs = R.round_robin(N, uplinks), Q.round_robin(N, uplinks)
    ref = R.random_trace(seed, rs, S, n_events=8)
    port = Q.random_trace(seed, qs, S, n_events=8)
    assert _events(port) == _events(ref)
    for t0 in (0, 17):
        _masks_equal(R.compile_masks(ref, rs, S, t0=t0),
                     Q.compile_masks(port, qs, S, t0=t0))


def test_hand_trace_masks_equal():
    """Windows clipped by t0, degradations that compose, a dead source
    over a degradation, and stuck ports across windows of the schedule."""
    rs, qs = R.round_robin(N, 2), Q.round_robin(N, 2)
    ref = (R.FailureTrace()
           .degrade(1, 2, 0.5, 0, 40).degrade(1, 2, 0.3, 10, 30)
           .degrade(3, 4, 0.7, 5).link_flap(3, 4, 20, 25)
           .stuck_port(0, 1, 3, 29).stuck_port(5, 0, 40)
           .tor_outage(6, 12, 20).link_flap(7, 0, 45, 80))
    port = _same_failure_trace(ref)
    for t0, n in ((0, S), (9, 30), (35, S), (100, 4)):
        _masks_equal(R.compile_masks(ref, rs, n, t0=t0),
                     Q.compile_masks(port, qs, n, t0=t0))
    assert port.active_in(44, 46) == ref.active_in(44, 46)
    assert port.active_in(80, 90) == ref.active_in(80, 90)
    assert not Q.FailureTrace().link_flap(0, 1, 5, 6).active_in(6, 9)
    port.heal_all(21)
    ref.heal_all(21)
    assert _events(port) == _events(ref)
    _masks_equal(R.compile_masks(ref, rs, S), Q.compile_masks(port, qs, S))


def test_failure_masks_api():
    qs = Q.round_robin(N, 1)
    m = Q.compile_masks(Q.FailureTrace().tor_outage(2, 0, 5), qs, 6)
    rm = R.compile_masks(R.FailureTrace().tor_outage(2, 0, 5),
                         R.round_robin(N, 1), 6)
    _equal(rm.failed_links(3), m.failed_links(3))
    _masks_equal(R.FailureMasks.healthy(6, N), Q.FailureMasks.healthy(6, N))
    m.validate(6, N)
    for bad in ((7, N), (6, N + 1)):
        with pytest.raises(ValueError, match="do not cover"):
            m.validate(*bad)
    host = m.link_cap
    assert m.on_device("cpu") is m
    assert isinstance(m.link_cap, torch.Tensor)
    assert m.link_cap.dtype == torch.float32 and m.node_ok.dtype == torch.bool
    np.testing.assert_array_equal(m.link_cap.numpy(), host)
    moved = m.link_cap
    m.on_device("cpu")                   # idempotent: the same tensors
    assert m.link_cap is moved
    _equal(rm.failed_links(3), m.failed_links(3))
    m.validate(6, N)


@pytest.mark.parametrize("kw", [
    dict(kind="bogus", t_start=0),
    dict(kind="link", t_start=5, t_end=5, node=0, dst=1),
    dict(kind="link", t_start=0, node=0),
    dict(kind="port", t_start=0, node=1),
    dict(kind="tor", t_start=0),
])
def test_failure_event_validation_equal(kw):
    with pytest.raises(ValueError) as ref:
        R.FailureEvent(**kw)
    with pytest.raises(ValueError) as port:
        Q.FailureEvent(**kw)
    assert str(port.value) == str(ref.value)


def test_failure_index_checks_equal():
    for trace in (Q.FailureTrace().link_flap(0, N, 0),
                  Q.FailureTrace().stuck_port(0, 1, 0)):
        with pytest.raises(ValueError, match="outside the schedule"):
            Q.compile_masks(trace, Q.round_robin(N, 1), 4)
    with pytest.raises(ValueError, match="outside"):
        Q.FailureTrace().degrade(0, 1, 1.5, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_surviving_conn_equal(seed):
    rng = np.random.default_rng(seed)
    conn = R.round_robin(N, 2).conn.copy()
    conn[rng.random(conn.shape) < 0.1] = -1          # dark uplinks
    failed = rng.random((N, N)) < 0.3
    ref = R.surviving_conn(conn, failed)
    _equal(ref, Q.surviving_conn(conn, failed))
    port = Q.surviving_conn(torch.from_numpy(conn), torch.from_numpy(failed))
    assert isinstance(port, torch.Tensor)
    _equal(ref, port.numpy())


# ---------------------------------------------------------------------------
# control plane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_random_control_trace_and_masks_equal(seed):
    ref = R.random_control_trace(seed, N, S, n_events=8)
    port = Q.random_control_trace(seed, N, S, n_events=8)
    assert _events(port) == _events(ref)
    for kw in (dict(), dict(slice_ns=900.0, guardband_ns=150.0, t0=11,
                            seed=seed)):
        _masks_equal(R.compile_control(ref, S, N, **kw),
                     Q.compile_control(port, S, N, **kw))


def test_hand_control_masks_equal():
    """Negative and positive skews of whole slices and beyond the cycle,
    residuals inside and past the guard band, drift entered mid-window,
    stalls, and losses that compose."""
    ref = (R.ControlTrace()
           .skew(0, -2000.0, 0).skew(1, 2100.0, 3, 30)
           .skew(2, 2000.0 * 9 + 350.0, 5).skew(2, -150.0, 20, 40)
           .drift(3, 120.0, 4).drift(4, -75.0, 10, 35)
           .install_delay(2, 0, 20).install_delay(3, 5, node=6)
           .install_loss(0.3, 0, 30).install_loss(0.5, 10, node=7)
           .stall(12, 18).stall(15, 25))
    port = _same_control_trace(ref)
    for kw in (dict(), dict(t0=13), dict(slice_ns=2000.0, guardband_ns=300.0,
                                         seed=5), dict(t0=50)):
        _masks_equal(R.compile_control(ref, S, N, **kw),
                     Q.compile_control(port, S, N, **kw))
    m = Q.compile_control(port, S, N)
    assert (m.phase_off < 0).any() and (m.phase_off > 1).any()
    assert m.skew_miss.any() and not m.skew_miss.all()
    port.heal_all(22)
    ref.heal_all(22)
    assert _events(port) == _events(ref)
    assert port.active_in(22, 30) == ref.active_in(22, 30)
    _masks_equal(R.compile_control(ref, S, N), Q.compile_control(port, S, N))


@pytest.mark.parametrize("kw", [
    dict(kind="skew", t_start=0),
    dict(kind="nope", t_start=0),
    dict(kind="drift", t_start=3, t_end=2, node=0),
    dict(kind="install_delay", t_start=0, delay=-1),
    dict(kind="install_loss", t_start=0, loss=1.5),
])
def test_control_event_validation_equal(kw):
    with pytest.raises(ValueError) as ref:
        R.ControlEvent(**kw)
    with pytest.raises(ValueError) as port:
        Q.ControlEvent(**kw)
    assert str(port.value) == str(ref.value)


def test_control_checks_equal():
    with pytest.raises(ValueError, match="finite t_end"):
        Q.ControlTrace().stall(3, Q_cp.OPEN_END)
    with pytest.raises(ValueError, match="outside the fabric"):
        Q.compile_control(Q.ControlTrace().skew(N, 10.0, 0), 4, N)
    with pytest.raises(ValueError, match="slice_ns"):
        Q.compile_control(Q.ControlTrace(), 4, N, slice_ns=0.0)
    m = Q.ControlMasks.perfect(4, N)
    _masks_equal(R.ControlMasks.perfect(4, N), m)
    m.validate(4, N)
    with pytest.raises(ValueError, match="do not cover"):
        m.validate(5, N)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_install_schedule_equal(seed):
    ref_tr = R.random_control_trace(seed, N, S, n_events=6,
                                    kinds=("install_delay", "install_loss",
                                           "stall"))
    rm = R.compile_control(ref_tr, S, N, seed=seed)
    qm = Q.compile_control(_same_control_trace(ref_tr), S, N, seed=seed)
    for kw in (dict(t0=0), dict(t0=5, retries=3, backoff=2),
               dict(t0=S - 2, retries=4, timeout=3), dict(t0=9, timeout=1)):
        a, b = R.install_schedule(rm, **kw), Q.install_schedule(qm, **kw)
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k], k)
    for bad in (dict(t0=0, backoff=0), dict(t0=0, retries=-1)):
        with pytest.raises(ValueError):
            Q.install_schedule(qm, **bad)


# ---------------------------------------------------------------------------
# guard band
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(sync_error_ns=80.0), dict(headroom_to_ns=0.0, link_gbps=400.0),
    dict(delay_max_ns=2000.0, duty_cycle_factor=20.0),
])
def test_guardband_equal(kw):
    ref = R.derive_guardband(R.GuardbandInputs(**kw))
    port = Q.derive_guardband(Q.GuardbandInputs(**kw))
    assert isinstance(port, Q_gb.GuardbandResult)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(Q_gb.derive()) == dataclasses.asdict(R_gb.derive())
