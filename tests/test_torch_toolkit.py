"""The PyTorch port's toolkit (``repro_torch.core.toolkit``, host numpy)
against ``repro.core.toolkit``: every function's output equal on the same
inputs, messages included — packet traces, schedule views, the table
checker on sound and broken tables (static invariants, failed links,
walks, hashes, start slices), the mixed-version sweep, the telemetry
checker on the port's own results, and the sharding checker on the
reference's sharded output.

It also records a fault of the reference (ROADMAP Queue 3): ``ucmp``
tables loop packets under a mixed-version install. On the draw of seed
435709 the port's checker, on the port's own ``ucmp`` tables, finds the
same 65 violations as the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as Q  # noqa: E402
from repro.core import toolkit as RT  # noqa: E402
from repro.core.topology import Schedule as RSchedule  # noqa: E402
from repro_torch.core import toolkit as QT  # noqa: E402
from repro_torch.core.topology import Schedule as QSchedule  # noqa: E402

from torch_parity import (  # noqa: E402, F401
    carry, release_compiled_programs)

N = 8
SCHEMES = ("direct", "vlb", "opera", "ucmp", "hoho", "ecmp", "wcmp", "ksp")


def _both(scheme, n=N, uplinks=1):
    """(reference schedule, routing), (port schedule, routing)."""
    rs, qs = R.round_robin(n, uplinks), Q.round_robin(n, uplinks)
    if scheme == "clos":
        return (rs, R.clos_routing(n)), (qs, Q.clos_routing(n))
    return (rs, getattr(R, scheme)(rs)), (qs, getattr(Q, scheme)(qs))


def _break(r, seed):
    """A copy of the routing's arrays with planted violations: slot gaps,
    an egress past the electrical port, negative departures, and entries
    moved to other slices (dark circuits)."""
    rng = np.random.default_rng(seed)
    out = {k: getattr(r, k).copy() for k in ("tf_next", "tf_dep",
                                              "inj_next", "inj_dep")}
    Tr, n, _, K = out["tf_next"].shape
    for name in ("tf", "inj"):
        nxt, dep = out[f"{name}_next"], out[f"{name}_dep"]
        for _ in range(6):
            t, a, d = rng.integers(Tr), rng.integers(n), rng.integers(n)
            nxt[t, a, d, 0] = rng.integers(0, n)             # maybe dark
            dep[t, a, d, 0] = rng.integers(0, 3)
        if K > 1:
            nxt[0, 1, 2, 0] = -1                             # slot gap
            nxt[0, 1, 2, 1] = 3
        dep[Tr - 1, 2, 3, 0] = -2
    out["tf_next"][0, 3, 4, 0] = n + 1                       # beyond elec
    return out


def _routing(pkg, r, arrays):
    return pkg.CompiledRouting(arrays["tf_next"], arrays["tf_dep"],
                               arrays["inj_next"], arrays["inj_dep"],
                               multipath=r.multipath, lookup=r.lookup,
                               weights=r.weights)


@pytest.mark.parametrize("scheme", SCHEMES + ("clos",))
def test_trace_packet_and_format_schedule_equal(scheme):
    """Traces of every pair from a few start slices and hashes: delivered
    walks, calendar-queue buffering, the electrical egress, stuck walks on
    an emptied table, dark circuits and truncation."""
    (rs, rr), (qs, qr) = _both(scheme)
    cases = [(s, d, t0, h) for s in range(N) for d in range(N)
             for t0, h in ((0, 0), (3, 1), (9, 5))]
    for s, d, t0, h in cases:
        assert QT.trace_packet(qs, qr, s, d, t0, h) == \
            RT.trace_packet(rs, rr, s, d, t0, h)
    broken = _break(qr, 1)
    for s, d, t0 in ((0, 5, 0), (3, 1, 2), (6, 2, 4), (2, 4, 1)):
        assert QT.trace_packet(qs, _routing(Q, qr, broken), s, d, t0,
                               max_steps=3) == \
            RT.trace_packet(rs, _routing(R, rr, broken), s, d, t0,
                            max_steps=3)
    empty = {k: np.full_like(v, -1) if k.endswith("next") else v
             for k, v in broken.items()}
    assert QT.trace_packet(qs, _routing(Q, qr, empty), 0, 5) == \
        RT.trace_packet(rs, _routing(R, rr, empty), 0, 5)
    for k in (2, 8, 20):
        assert QT.format_schedule(qs, k) == RT.format_schedule(rs, k)
    assert QT.format_schedule(Q.round_robin(5, 2)) == \
        RT.format_schedule(R.round_robin(5, 2))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_check_tables_equal(scheme, seed):
    """Sound tables (both empty lists), then broken tables, with and
    without failed links, walks, delivery, hashes and start slices: the
    same messages in the same order."""
    (rs, rr), (qs, qr) = _both(scheme, uplinks=1 + seed)
    rng = np.random.default_rng(seed)
    fail = rng.random((N, N)) < 0.15
    np.fill_diagonal(fail, False)
    variants = [
        dict(),
        dict(require_delivery=True, max_hops=6),
        dict(hashes=(0, 1, 3), t0s=(0, 2, 5)),
        dict(link_fail=fail),
        dict(link_fail=fail, check_walks=False),
        dict(max_steps=4, require_delivery=True),
    ]
    broken = _break(qr, seed)
    for kw in variants:
        assert QT.check_tables(qs, qr, **kw) == RT.check_tables(rs, rr, **kw)
        got = QT.check_tables(qs, _routing(Q, qr, broken), **kw)
        assert got == RT.check_tables(rs, _routing(R, rr, broken), **kw)
        assert got, kw
    # the vectorized walks and the scalar walk that narrates them
    args = ((0,), 16, True, 64, fail, range(rs.num_slices))
    viol = QT._check_walks_vec(qs, _routing(Q, qr, broken), *args)
    assert viol == RT._check_walks_vec(rs, _routing(R, rr, broken), *args)
    for s, d, t0, h in viol[:10]:
        assert QT._check_walk(qs, _routing(Q, qr, broken), s, d, t0, h, 16,
                              True, 64, fail) == \
            RT._check_walk(rs, _routing(R, rr, broken), s, d, t0, h, 16,
                           True, 64, fail)


def _install_pair(pkg, schedule, seed, n=N):
    """Two consecutive reconfigure epochs: the same base cycle, hot-circuit
    tails drawn independently (``tests/test_controlplane_prop.py``'s
    ``_random_install_pair``, built with each package's own types)."""
    rng = np.random.default_rng(seed)
    base = pkg.round_robin(n, 1).conn
    K = int(rng.integers(1, 4))
    tails = []
    for _ in range(2):
        hot = np.full((K, n, 1), -1, np.int32)
        for s in range(K):
            a, b = rng.choice(n, 2, replace=False)
            hot[s, a, 0], hot[s, b, 0] = b, a
        tails.append(hot)
    return (schedule(np.concatenate([base, tails[0]])),
            schedule(np.concatenate([base, tails[1]])))


@pytest.mark.parametrize("seed", [1, 7, 23])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_check_tables_mixed_equal(scheme, seed):
    r_old, r_new = _install_pair(R, RSchedule, seed)
    q_old, q_new = _install_pair(Q, QSchedule, seed)
    alg_r, alg_q = getattr(R, scheme), getattr(Q, scheme)
    kw = dict(max_hops=32, n_random=2, seed=seed)
    got = QT.check_tables_mixed(q_new, alg_q(q_old), alg_q(q_new), **kw)
    assert got == RT.check_tables_mixed(r_new, alg_r(r_old), alg_r(r_new),
                                        **kw)
    up = np.arange(N) % 2 == 0
    assert QT.check_tables(q_new, alg_q(q_new), old_routing=alg_q(q_old),
                           upgraded=up, hashes=(0, 2)) == \
        RT.check_tables(r_new, alg_r(r_new), old_routing=alg_r(r_old),
                        upgraded=up, hashes=(0, 2))


def test_mixed_mode_argument_errors_equal():
    """Old tables without a subset, a subset without old tables, another
    table cycle, another slot width, a misshaped subset: the same
    ``ValueError`` messages."""
    (rs, rr), (qs, qr) = _both("ucmp")
    (_, r_ecmp), (_, q_ecmp) = _both("ecmp")
    (_, r_direct), (_, q_direct) = _both("direct")
    up = np.ones(N, bool)
    cases = [((rr, None), (qr, None)), ((None, up), (None, up)),
             ((r_ecmp, up), (q_ecmp, up)), ((r_direct, up), (q_direct, up)),
             ((rr, up[1:]), (qr, up[1:]))]
    for (r_old, r_up), (q_old, q_up) in cases:
        with pytest.raises(ValueError) as ref_err:
            RT.check_tables(rs, rr, old_routing=r_old, upgraded=r_up)
        with pytest.raises(ValueError) as port_err:
            QT.check_tables(qs, qr, old_routing=q_old, upgraded=q_up)
        assert str(port_err.value) == str(ref_err.value)


def test_reference_ucmp_mixed_install_fault_replays_in_the_port():
    """ROADMAP Queue 3: the draw of seed 435709 that fails the reference's
    ``test_mixed_version_soundness_random_installs`` for ``ucmp``. The
    port's checker on the port's own tables records the reference's 65
    violations, message for message. A record of the reference's fault:
    the assertion is the reference's answer."""
    seed = 435709
    r_old, r_new = _install_pair(R, RSchedule, seed)
    q_old, q_new = _install_pair(Q, QSchedule, seed)
    kw = dict(max_hops=32, n_random=2, seed=seed)
    ref = RT.check_tables_mixed(r_new, R.ucmp(r_old), R.ucmp(r_new), **kw)
    got = QT.check_tables_mixed(q_new, Q.ucmp(q_old), Q.ucmp(q_new), **kw)
    assert len(ref) == 65
    assert got == ref
    assert got[0] == ("[upgraded=only[2]] mixed walk 2->0 @t0=7 h=0: "
                      "exceeds max_hops=32 without delivery")


# ---------------------------------------------------------------------------
# result checkers
# ---------------------------------------------------------------------------

def _run(telemetry=True, slices=40):
    sched = R.round_robin(N, 1)
    tables = R.FabricTables.build(sched, R.vlb(sched))
    wl = R.synthesize("rpc", N, 24, slice_bytes=4_000, load=0.8,
                      max_packets=300, seed=2)
    qt, qw = carry(tables, wl)
    res = Q.simulate(qt, qw, Q.FabricConfig(slice_bytes=4_000,
                                            pushback=True,
                                            switch_buffer=20_000),
                     slices, device="cpu",
                     telemetry=Q.TelemetryConfig() if telemetry else None)
    return tables, wl, qw, res


def test_check_telemetry_equal():
    """The port's result passes both checkers; tampered counters and
    results fail them with the same messages."""
    _, wl, qw, res = _run()
    S = res.delivered_bytes.shape[0]
    assert QT.check_telemetry(res, qw, S) == [] == \
        RT.check_telemetry(res, wl, S)
    assert QT.check_telemetry(res, None, S) == \
        RT.check_telemetry(res, None, S) == []
    tele = res.telemetry
    bad = dataclasses.replace(
        res, delivered_bytes=res.delivered_bytes + 1,
        loc_final=np.where(np.arange(res.loc_final.size) % 7 == 0, -2,
                           res.loc_final).astype(np.int32),
        telemetry=dataclasses.replace(
            tele, util_used=tele.util_cap + 1,
            dropped_bytes=tele.dropped_bytes + 3,
            queue_hwm=tele.queue_hwm * 0,
            lat_hist=tele.lat_hist[:, ::-1].copy()))
    for w, qw_ in ((wl, qw), (None, None)):
        got = QT.check_telemetry(bad, qw_, S)
        assert got and got == RT.check_telemetry(bad, w, S)
    shapes = dataclasses.replace(res, telemetry=dataclasses.replace(
        tele, injected_bytes=tele.injected_bytes[:-1],
        deferred_bytes=-tele.deferred_bytes - 1))
    assert QT.check_telemetry(shapes, qw, S) == \
        RT.check_telemetry(shapes, wl, S) != []
    _, _, qw, plain = _run(telemetry=False)
    assert QT.check_telemetry(plain, qw, S) == \
        RT.check_telemetry(plain, wl, S) == [
            "res.telemetry is None (simulate with telemetry=...)"]


def test_check_sharding_on_reference_sharded_output(eight_devices):
    """The port's sharding checker, on the reference's sharded run and its
    debug arrays: sound, and with planted ownership and conservation
    faults the reference's messages."""
    tables, wl, qw, _ = _run(telemetry=False)
    S = 40
    res, dbg = R.simulate_sharded(tables, wl, R.FabricConfig(
        slice_bytes=4_000, pushback=True, switch_buffer=20_000), S,
        num_shards=3, with_debug=True)
    dbg = {k: np.asarray(v) if k != "num_shards" else v
           for k, v in dbg.items()}
    assert QT.check_sharding(res, dbg, qw, S) == \
        RT.check_sharding(res, dbg, wl, S) == []
    adm = dbg["adm_shard"].copy()
    adm[:5] = (dbg["owner"][:5] + 1) % 3
    adm[5] = 7
    loc = res.loc_final.copy()
    loc[10] = -9
    t_del = res.t_deliver.copy()
    t_del[np.flatnonzero(loc == -1)[:2]] = 3
    bad_res = dataclasses.replace(res, loc_final=loc, t_deliver=t_del,
                                  dropped=res.dropped + 1)
    for d, r in ((dict(dbg, adm_shard=adm), res),
                 (dbg, bad_res),
                 (dict(dbg, owner=dbg["owner"][:-1]), res)):
        got = QT.check_sharding(r, d, qw, S)
        assert got and got == RT.check_sharding(r, d, wl, S)
