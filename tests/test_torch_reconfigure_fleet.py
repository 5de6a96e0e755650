"""The port's sweep of the reconfigure loop (``repro_torch.core
.reconfigure_fleet``) on the CPU: against the reference's vmapped
``repro.core.reconfigure_fleet`` for a traffic-seed sweep and a failover
sweep (heal, 2PC with a timeout, failure and control traces), the
counterparts of ``tests/test_scenario_vmap.py``'s reconfigure tests; and
against the port's own solo ``reconfigure`` of each member for the
``edmonds`` and ``bvn`` schedulers, hotswap installs under install loss
and 2PC with degrade. Every ``ReconfigResult`` field, history array and
telemetry counter equal, values and dtypes. And the reference's
validation errors. All at N = 8.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as Q  # noqa: E402
from test_torch_reconfigure import assert_reconfig_equal  # noqa: E402
from torch_parity import (carry, carry_masks, one_torch_thread,  # noqa: E402, F401
                          release_compiled_programs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 8


def _wl(seed, load=0.9, max_packets=420):
    return R.synthesize("rpc", N, 24, slice_bytes=4_000, load=load,
                        max_packets=max_packets, seed=seed)


def _port_inputs(sched, wls, failures=None, control=None):
    qwls = [carry(R.FabricTables.build(sched, R.direct(sched)), w)[1]
            for w in wls]
    masks = [carry_masks(f, c) for f, c in zip(
        failures or [None] * len(wls), control or [None] * len(wls))]
    qf = None if failures is None else [m[0] for m in masks]
    qc = None if control is None else [m[1] for m in masks]
    return Q.Schedule(sched.conn), qwls, qf, qc


def _check_reference(sched, wls, cfg, rcfg, failures=None, control=None):
    """The port's sweep against the reference's, member by member."""
    refs = R.reconfigure_fleet(sched, wls, R.FabricConfig(**cfg),
                               R.ReconfigConfig(**rcfg), failures=failures,
                               control=control)
    qs, qwls, qf, qc = _port_inputs(sched, wls, failures, control)
    got = Q.reconfigure_fleet(qs, qwls, Q.FabricConfig(**cfg),
                              Q.ReconfigConfig(**rcfg), failures=qf,
                              control=qc, device="cpu")
    assert len(got) == len(refs) == len(wls)
    for ref, port in zip(refs, got):
        assert_reconfig_equal(ref, port)
    return got


def test_seed_sweep_matches_reference():
    """``hot_slices`` with ``hoho`` over four traffic seeds."""
    got = _check_reference(
        R.round_robin(N, 1), [_wl(s) for s in range(4)],
        dict(slice_bytes=4_000, cc_detect=True),
        dict(epoch_slices=16, num_epochs=3, k_hot=2, scheme="hoho"))
    assert any((g.hot_src != got[0].hot_src).any() for g in got[1:])


def test_failover_sweep_matches_reference():
    """Heal and 2PC installs with a timeout over three seeded failure and
    control traces of one workload."""
    sched = R.round_robin(N, 1)
    S = 48
    fms = [R.compile_masks(R.random_trace(s, sched, S, n_events=3), sched, S)
           for s in range(3)]
    cms = [R.compile_control(R.random_control_trace(s, N, S, n_events=3), S,
                             N) for s in range(3)]
    got = _check_reference(
        sched, [_wl(0)] * 3, dict(slice_bytes=4_000, cc_detect=True),
        dict(epoch_slices=16, num_epochs=3, k_hot=2, scheme="hoho",
             heal=True, install="2pc", install_timeout=8),
        failures=fms, control=cms)
    assert any((g.failed_links != got[0].failed_links).any()
               or (g.install_lat != got[0].install_lat).any()
               for g in got[1:])


LOSSY = (R.ControlTrace().install_loss(0.6, 0, 30)
         .install_delay(2, 10, 26, node=3).stall(24, 28))

# name: (reconfigure config, workload seeds, failures, control traces,
# telemetry); the sweep against each member's solo run
SOLO = {
    "edmonds-heal": (dict(epoch_slices=12, num_epochs=3, scheme="ucmp",
                          scheduler="edmonds", heal=True), (7, 8), True,
                     None, False),
    "bvn": (dict(epoch_slices=12, num_epochs=3, scheme="hoho",
                 scheduler="bvn", bvn_slices=5, bvn_perms=5), (7, 8),
            False, None, False),
    "hotswap-install-loss": (dict(epoch_slices=12, num_epochs=3,
                                  scheme="hoho", k_hot=2, install="hotswap"),
                             (3, 4, 5), False, (11, 12, 13), True),
    "2pc-degrade": (dict(epoch_slices=12, num_epochs=3, scheme="hoho",
                         k_hot=2, install="2pc", degrade=True), (3, 3),
                    False, (11, 14), False),
}


@pytest.mark.parametrize("name", list(SOLO))
def test_sweep_equals_solo_runs(name):
    rcfg, seeds, fail, ctrl, tele = SOLO[name]
    sched = R.round_robin(N, 1)
    rk = Q.ReconfigConfig(**rcfg)
    S = rk.num_epochs * rk.epoch_slices
    wls = [_wl(s, load=0.8, max_packets=1200) for s in seeds]
    fms = [R.compile_masks(
        R.FailureTrace().link_flap(2 + b, 5, 10).tor_outage(6 - b, 14, 30),
        sched, S) for b in range(len(seeds))] if fail else None
    cms = [R.compile_control(LOSSY if name != "2pc-degrade" else
                             R.ControlTrace().install_loss(1.0, 0, 12 * b + 6),
                             S, N, seed=c) for b, c in enumerate(ctrl)] \
        if ctrl else None
    qs, qwls, qf, qc = _port_inputs(sched, wls, fms, cms)
    cfg = Q.FabricConfig(slice_bytes=4_000, cc_detect=True)
    telemetry = Q.TelemetryConfig() if tele else None
    got = Q.reconfigure_fleet(qs, qwls, cfg, rk, failures=qf, control=qc,
                              telemetry=telemetry, device="cpu")
    for b, port in enumerate(got):
        solo = Q.reconfigure(qs, qwls[b], cfg, rk,
                             failures=None if qf is None else qf[b],
                             control=None if qc is None else qc[b],
                             telemetry=telemetry, device="cpu")
        assert_reconfig_equal(solo, port)
    # the members differ, so a mix-up between scenarios shows
    assert any((g.t_deliver != got[0].t_deliver).any() for g in got[1:])
    if name == "hotswap-install-loss":
        assert all((g.install_ver != g.install_ver[:, :1]).any() for g in got)
    if name == "2pc-degrade":
        assert [g.degraded.sum() for g in got] != [got[0].degraded.sum()] * 2


def test_rejects_what_the_reference_rejects():
    sched = Q.round_robin(N, 1)
    _, wls, _, _ = _port_inputs(R.round_robin(N, 1), [_wl(0), _wl(1)])
    cfg = Q.FabricConfig(slice_bytes=4_000)
    rk = Q.ReconfigConfig(epoch_slices=4, num_epochs=2, k_hot=1)
    assert Q.reconfigure_fleet(sched, [], cfg, rk, device="cpu") == []
    short = Q.Workload(**{k: getattr(wls[1], k)[:-1] for k in (
        "src", "dst", "size", "t_inject", "flow", "seq", "is_eleph")})
    with pytest.raises(ValueError, match="packet count"):
        Q.reconfigure_fleet(sched, [wls[0], short], cfg, rk, device="cpu")
    healthy = Q.FailureMasks.healthy(8, N)
    with pytest.raises(ValueError, match="mask"):
        Q.reconfigure_fleet(sched, wls, cfg, rk, failures=[healthy],
                            device="cpu")
    with pytest.raises(ValueError, match="presence"):
        Q.reconfigure_fleet(sched, wls, cfg, rk, failures=[healthy, None],
                            device="cpu")
    perfect = Q.ControlMasks.perfect(8, N)
    with pytest.raises(ValueError, match="presence"):
        Q.reconfigure_fleet(sched, wls, cfg, rk, control=[None, perfect],
                            device="cpu")
    with pytest.raises(ValueError, match="scheduler"):
        Q.reconfigure_fleet(sched, wls, cfg, Q.ReconfigConfig(
            scheduler="sorn"), device="cpu")
    # all-None mask lists are no masks, as in the reference
    runs = Q.reconfigure_fleet(sched, wls, cfg, rk, failures=[None, None],
                               device="cpu")
    assert_reconfig_equal(Q.reconfigure(sched, wls[1], cfg, rk,
                                        device="cpu"), runs[1])
    np.testing.assert_array_equal(runs[0].failed_links, 0)


def test_runs_on_cuda_unless_told(monkeypatch):
    """Without a card and without ``device="cpu"`` the sweep raises, as
    every entry point of the port does, and never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sched = Q.round_robin(N, 1)
    _, wls, _, _ = _port_inputs(R.round_robin(N, 1), [_wl(0), _wl(1)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Q.reconfigure_fleet(sched, wls, Q.FabricConfig(slice_bytes=4_000),
                            Q.ReconfigConfig(epoch_slices=4, num_epochs=2))
