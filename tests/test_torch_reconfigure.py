"""The port's traffic-aware reconfigure loop (``repro_torch.core
.reconfigure``) on the CPU against ``repro.core.reconfigure`` on the same
schedules, workloads and masks (made from seeds with numpy), every
``ReconfigResult`` field equal in value, shape and dtype, telemetry
counters included:

* the three schedulers (``hot_slices``, ``edmonds``, ``bvn``);
* ``k_hot`` 0 and 2 with ``hoho``, ``ucmp`` and ``vlb`` under the base,
  push-back and push-back + offload fabrics;
* failure masks with ``heal`` (and without it, beside control masks);
* control masks with hotswap and 2PC installs, and 2PC with degrade (by
  install loss and by skew past the guard band);
* telemetry counters.

And the loop's own properties, on the port alone: with ``k_hot=0`` it
equals the port's ``simulate`` of the same length; for every scheduler the
recorded ``epoch_conn`` replayed through the port's host compiler and the
incremental API gives the same run. The reference results are shared
through a module-scoped cache, at N = 8.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as Q  # noqa: E402
from repro_torch.core import fabric as Q_fabric  # noqa: E402
from torch_parity import (assert_sim_equal, carry,  # noqa: E402, F401
                          carry_masks, one_torch_thread,
                          release_compiled_programs)

N = 8
SB = 10_000
CFGS = {"base": dict(slice_bytes=SB),
        "pushback": dict(slice_bytes=SB, pushback=True),
        "pushback-offload": dict(slice_bytes=SB, pushback=True,
                                 offload=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread(one_torch_thread):
    pass


def _workload(load=0.5, seed=3, n=N):
    return R.synthesize("rpc", n, 40, slice_bytes=SB, load=load,
                        max_packets=2000, seed=seed)


def _failures(slices):
    return R.compile_masks(
        R.FailureTrace().link_flap(2, 5, 10).tor_outage(6, 20, 40),
        R.round_robin(N, 1), slices)


def _control(trace, slices, seed=0):
    return R.compile_control(trace, slices, N, seed=seed)


LOSSY = (R.ControlTrace().install_loss(0.6, 0, 30)
         .install_delay(2, 10, 26, node=3).stall(24, 28))


def _cases():
    out = {}
    for scheme in ("hoho", "ucmp", "vlb"):
        for k_hot in (0, 2):
            for cfg in CFGS:
                out[f"{scheme}-k{k_hot}-{cfg}"] = dict(
                    rcfg=dict(epoch_slices=16, num_epochs=3, scheme=scheme,
                              k_hot=k_hot), cfg=cfg)
    out["edmonds-ucmp"] = dict(rcfg=dict(
        epoch_slices=12, num_epochs=3, scheme="ucmp", scheduler="edmonds"),
        load=0.8, seed=7)
    out["bvn-hoho"] = dict(rcfg=dict(
        epoch_slices=12, num_epochs=3, scheme="hoho", scheduler="bvn",
        bvn_slices=5, bvn_perms=5), load=0.8, seed=7)
    out["bvn-opera-2-uplinks"] = dict(rcfg=dict(
        epoch_slices=12, num_epochs=3, scheme="opera", scheduler="bvn",
        bvn_slices=6, bvn_perms=4), n=9, uplinks=2, load=0.8, seed=7)
    out["failures-heal"] = dict(rcfg=dict(
        epoch_slices=12, num_epochs=4, scheme="hoho", k_hot=2, heal=True),
        load=0.8, seed=9, failures=True)
    out["failures-heal-edmonds"] = dict(rcfg=dict(
        epoch_slices=12, num_epochs=4, scheme="vlb", scheduler="edmonds",
        heal=True), load=0.8, seed=9, failures=True)
    for install in ("hotswap", "2pc"):
        out[f"control-{install}"] = dict(rcfg=dict(
            epoch_slices=12, num_epochs=4, scheme="hoho", k_hot=2,
            install=install), control=LOSSY)
    out["control-2pc-degrade-loss"] = dict(rcfg=dict(
        epoch_slices=12, num_epochs=4, scheme="hoho", k_hot=2,
        install="2pc", degrade=True),
        control=R.ControlTrace().install_loss(1.0, 0, 24))
    out["control-2pc-degrade-skew-vlb"] = dict(rcfg=dict(
        epoch_slices=12, num_epochs=4, scheme="vlb", k_hot=2,
        install="2pc", degrade=True),
        control=R.ControlTrace().skew(1, 900.0, 12, 24).skew(4, -2000.0, 0))
    out["telemetry"] = dict(rcfg=dict(
        epoch_slices=16, num_epochs=3, scheme="ucmp", k_hot=2),
        cfg="pushback", telemetry=True)
    out["telemetry-control-failures"] = dict(rcfg=dict(
        epoch_slices=12, num_epochs=4, scheme="hoho", k_hot=2,
        install="hotswap"), control=LOSSY, failures=True,
        telemetry=True, load=0.8, seed=9)
    return out


CASES = _cases()


def _inputs(case):
    n = case.get("n", N)
    sched = R.round_robin(n, case.get("uplinks", 1))
    wl = _workload(case.get("load", 0.5), case.get("seed", 3), n)
    rk = R.ReconfigConfig(**case["rcfg"])
    S = rk.num_epochs * rk.epoch_slices
    fail = _failures(S) if case.get("failures") else None
    ctrl = _control(case["control"], S, seed=11) if "control" in case \
        else None
    return sched, wl, rk, fail, ctrl


def _run_port(case, device="cpu"):
    sched, wl, rk, fail, ctrl = _inputs(case)
    _, qw = carry(R.FabricTables.build(sched, R.direct(sched)), wl)
    f, c = carry_masks(fail, ctrl)
    return Q.reconfigure(
        Q.Schedule(sched.conn), qw, Q.FabricConfig(**CFGS[case.get(
            "cfg", "base")]), Q.ReconfigConfig(**case["rcfg"]),
        failures=f, control=c,
        telemetry=Q.TelemetryConfig() if case.get("telemetry") else None,
        device=device)


def _run_ref(case):
    sched, wl, rk, fail, ctrl = _inputs(case)
    return R.reconfigure(
        sched, wl, R.FabricConfig(**CFGS[case.get("cfg", "base")]), rk,
        failures=fail, control=ctrl,
        telemetry=R.TelemetryConfig() if case.get("telemetry") else None)


@pytest.fixture(scope="module")
def runs():
    """Each case's (reference, port) results, computed once a module."""
    cache = {}

    def get(name, which):
        key = (name, which)
        if key not in cache:
            cache[key] = (_run_ref if which == "ref" else _run_port)(
                CASES[name])
        return cache[key]
    return get


def assert_reconfig_equal(ref, port):
    """Every field of the port's ``ReconfigResult`` equals the
    reference's, in value, shape and dtype, and so does every telemetry
    counter."""
    names = [f.name for f in dataclasses.fields(port)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    as_sim = lambda r: Q.SimResult(**{f.name: getattr(r, f.name)
                                      for f in dataclasses.fields(Q.SimResult)})
    assert_sim_equal(as_sim(ref), as_sim(port))
    for name in names[len(dataclasses.fields(Q.SimResult)) - 1:]:
        if name == "telemetry":
            continue
        a, b = np.asarray(getattr(ref, name)), np.asarray(getattr(port, name))
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (name, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_reconfigure_matches_reference(runs, name):
    ref, port = runs(name, "ref"), runs(name, "port")
    assert_reconfig_equal(ref, port)
    if "control" in CASES[name]:
        # the cases are chosen so that the version select has work to do
        assert (port.install_ver != port.install_ver[:, :1]).any() \
            or port.degraded.any() or (port.install_ver == -1).any(), name


@pytest.mark.parametrize("name", [n for n in CASES if "-k0-" in n])
def test_k_hot_zero_equals_simulate(runs, name):
    """With ``k_hot=0`` the schedule never changes: the loop equals the
    port's ``simulate`` of the base tables over the same slices."""
    case = CASES[name]
    sched, wl, rk, _, _ = _inputs(case)
    alg = getattr(Q, rk.scheme)
    qs = Q.Schedule(sched.conn)
    kw = dict(kpaths=rk.kpaths) if rk.scheme == "vlb" else {}
    _, qw = carry(R.FabricTables.build(sched, R.direct(sched)), wl)
    sim = Q.simulate(Q.FabricTables.build(qs, alg(qs, **kw)), qw,
                     Q.FabricConfig(**CFGS[case["cfg"]]),
                     rk.num_epochs * rk.epoch_slices, device="cpu")
    port = runs(name, "port")
    assert_sim_equal(sim, Q.SimResult(**{
        f.name: getattr(port, f.name) for f in dataclasses.fields(sim)}))


HOST = {"direct": Q.direct, "vlb": Q.vlb, "opera": Q.opera, "ucmp": Q.ucmp,
        "hoho": Q.hoho}


def host_replay(case, res):
    """The run again with each epoch's recorded schedule compiled by the
    port's host compiler and swapped into an incremental run: the
    measurement, the schedule, the heal and the device recompile are all
    pinned when it equals the loop's."""
    sched, wl, rk, fail, _ = _inputs(case)
    f, _ = carry_masks(fail, None)
    _, qw = carry(R.FabricTables.build(sched, R.direct(sched)), wl)
    E = rk.epoch_slices
    fs = None
    for e in range(rk.num_epochs):
        qs = Q.Schedule(res.epoch_conn[e])
        kw = dict(kpaths=rk.kpaths) if rk.scheme in ("vlb", "ucmp") else {}
        tables = Q.FabricTables.build(qs, HOST[rk.scheme](qs, **kw))
        if fs is None:
            fs = Q.init_state(tables, qw, Q.FabricConfig(**CFGS[case.get(
                "cfg", "base")]), device="cpu")
        else:
            fs.j.update(Q_fabric._table_arrays(tables, fs.device))
        fw, _ = Q_fabric._mask_window(f, None, e * E, (e + 1) * E)
        Q.step_slices(fs, E, failures=fw)
    return Q.finalize(fs)


@pytest.mark.parametrize("name", [
    "hoho-k2-base", "ucmp-k2-pushback", "vlb-k2-pushback-offload",
    "edmonds-ucmp", "bvn-hoho",
    "bvn-opera-2-uplinks", "failures-heal", "failures-heal-edmonds"])
def test_host_replay(runs, name):
    port = runs(name, "port")
    replay = host_replay(CASES[name], port)
    assert_sim_equal(replay, Q.SimResult(**{
        f.name: getattr(port, f.name) for f in dataclasses.fields(replay)}))


def test_versioned_install_hand_case():
    """One deaf ToR: under 2PC the whole fabric stays on the boot tables
    (version -1); under hotswap every other ToR installs each epoch, so
    the version select runs with unequal versions (the hotswap run also
    equals the reference's)."""
    base = dict(epoch_slices=12, num_epochs=3, scheme="hoho", k_hot=2,
                install_timeout=8)
    trace = R.ControlTrace().install_loss(1.0, 0, node=5)
    for install in ("2pc", "hotswap"):
        case = dict(rcfg=dict(base, install=install), control=trace)
        port = _run_port(case)
        if install == "2pc":
            assert (port.install_ver == -1).all()
            assert (port.install_lat == -1).all()
        else:
            assert_reconfig_equal(_run_ref(case), port)
            assert (port.install_ver[:, 5] == -1).all()
            assert (np.delete(port.install_ver, 5, axis=1)
                    == np.arange(3)[:, None]).all()


def test_rejects_bad_config():
    sched = Q.round_robin(N, 1)
    _, wl = carry(R.FabricTables.build(R.round_robin(N, 1),
                                       R.direct(R.round_robin(N, 1))),
                  _workload())
    cfg = Q.FabricConfig(slice_bytes=SB)
    bad = [(dict(scheme="ecmp"), "scheme"), (dict(scheduler="sorn"),
                                             "scheduler"),
           (dict(install="paxos"), "install"),
           (dict(install="hotswap", degrade=True), "degrade"),
           (dict(install="2pc", degrade=True, scheduler="edmonds"),
            "degrade"), (dict(install_backoff=0), "install_backoff")]
    for kw, match in bad:
        with pytest.raises(ValueError, match=match):
            Q.reconfigure(sched, wl, cfg, Q.ReconfigConfig(
                epoch_slices=12, num_epochs=2, **kw), device="cpu")
    ctrl = carry_masks(None, _control(R.ControlTrace(), 24))[1]
    with pytest.raises(ValueError, match="install_timeout"):
        Q.reconfigure(sched, wl, cfg, Q.ReconfigConfig(
            epoch_slices=12, num_epochs=2, install="2pc",
            install_timeout=13), control=ctrl, device="cpu")
    with pytest.raises(ValueError, match="do not cover"):
        Q.reconfigure(sched, wl, cfg, Q.ReconfigConfig(
            epoch_slices=12, num_epochs=3), control=ctrl, device="cpu")


def test_step_slices_versions_validated():
    """``step_slices(..., versions=)`` refuses misshaped tables or
    version selects."""
    qs = Q.round_robin(N, 1)
    _, wl = carry(R.FabricTables.build(R.round_robin(N, 1),
                                       R.direct(R.round_robin(N, 1))),
                  _workload())
    fs = Q.init_state(Q.FabricTables.build(qs, Q.hoho(qs)), wl,
                      Q.FabricConfig(slice_bytes=SB), device="cpu")
    tn = torch.full((2, 7, N, N, 1), -1, dtype=torch.int32)
    good = dict(tf_next_v=tn, tf_dep_v=tn * 0, inj_next_v=tn,
                inj_dep_v=tn * 0, vsel=torch.zeros((4, N), dtype=torch.int32))
    for bad in (dict(good, vsel=good["vsel"][:3]),
                dict(good, vsel=good["vsel"].long()),
                dict(good, tf_dep_v=tn[:, :, :4]),
                {k: v for k, v in good.items() if k != "inj_dep_v"}):
        with pytest.raises(ValueError, match="versions"):
            Q.step_slices(fs, 4, versions=bad)
    Q.step_slices(fs, 4, versions=good)
    assert fs.clock == 4
