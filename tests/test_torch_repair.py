"""The PyTorch port's repair, fast-reroute and phased-swap layer against
``repro.core.failures``: ``backup_tables``, ``backup_tables_dp``,
``fast_reroute`` (both backup forms) and ``repair(impl="numpy")`` equal
array for array over schemes, schedules, seeds and failure sets;
``simulate_phased`` (on the CPU, through the kernels' plain versions)
equal in every ``SimResult`` field for one phase and for three; and the
errors: a table cycle that is not the schedule's, an unknown scheme or
impl; and ``repair(impl="jnp")``, the device compiler, against the
reference's, with its refusal of the host-only schemes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as Q  # noqa: E402

from torch_parity import (  # noqa: E402, F401
    assert_sim_equal, carry, carry_masks, release_compiled_programs)

N = 8
SLICES = 48
TO_SCHEMES = ("direct", "vlb", "opera", "ucmp", "hoho")


def _failed(seed, n=N, p=0.2, symmetric=False):
    rng = np.random.default_rng(seed)
    f = rng.random((n, n)) < p
    np.fill_diagonal(f, False)
    return f | f.T if symmetric else f


def _assert_routing_equal(a, b):
    for k in ("tf_next", "tf_dep", "inj_next", "inj_dep"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert (a.multipath, a.lookup) == (b.multipath, b.lookup)
    assert (a.weights is None) == (b.weights is None)
    if a.weights is not None:
        np.testing.assert_array_equal(a.weights, b.weights)


def _assert_pair_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("uplinks", [1, 2])
@pytest.mark.parametrize("max_cands", [3, 8])
def test_backup_tables_equal(uplinks, max_cands):
    rs, qs = R.round_robin(N, uplinks), Q.round_robin(N, uplinks)
    _assert_pair_equal(R.backup_tables(rs, max_cands=max_cands),
                       Q.backup_tables(qs, max_cands=max_cands))
    got = Q.backup_tables_dp(qs, max_cands=max_cands)
    _assert_pair_equal(R.backup_tables_dp(rs, max_cands=max_cands), got)
    assert got[0].shape == (rs.num_slices, N, N, min(max_cands, N - 1))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scheme", TO_SCHEMES)
def test_fast_reroute_equal(scheme, seed):
    """Both backup forms, on a random failure set (one-way links for even
    seeds, both ways for odd); the patched tables also pass the port's
    static checker with the failure set."""
    rs, qs = R.round_robin(N, 1), Q.round_robin(N, 1)
    rr, qr = getattr(R, scheme)(rs), getattr(Q, scheme)(qs)
    failed = _failed(seed, symmetric=seed % 2 == 1)
    plain = Q.fast_reroute(qr, qs, failed)
    _assert_routing_equal(R.fast_reroute(rr, rs, failed), plain)
    dp = Q.fast_reroute(qr, qs, failed, backups=Q.backup_tables_dp(qs))
    _assert_routing_equal(
        R.fast_reroute(rr, rs, failed, backups=R.backup_tables_dp(rs)), dp)
    for patched in (plain, dp):
        assert Q.toolkit.check_tables(qs, patched, link_fail=failed,
                                      check_walks=False) == []


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("scheme", list(R.failures.REPAIR_SCHEMES))
def test_repair_equal(scheme, seed):
    rs, qs = R.round_robin(N, 1), Q.round_robin(N, 1)
    failed = _failed(seed, p=0.15, symmetric=True)
    got = Q.repair(qs, scheme, failed)
    _assert_routing_equal(R.repair(rs, scheme, failed), got)
    if got.num_slices == qs.num_slices:
        assert Q.toolkit.check_tables(qs, got, link_fail=failed,
                                      check_walks=False) == []
    assert tuple(Q.failures.REPAIR_SCHEMES) == \
        tuple(R.failures.REPAIR_SCHEMES)


def test_repair_forwards_compiler_arguments():
    rs, qs = R.round_robin(N, 2), Q.round_robin(N, 2)
    failed = _failed(9, symmetric=True)
    for scheme, kw in (("ucmp", dict(max_hop=3, kpaths=2)),
                       ("vlb", dict(kpaths=2)), ("ksp", dict(k=2))):
        _assert_routing_equal(R.repair(rs, scheme, failed, **kw),
                              Q.repair(qs, scheme, failed, **kw))


def test_repair_and_reroute_errors():
    qs = Q.round_robin(N, 1)
    none = np.zeros((N, N), bool)
    # the device compiler repairs the TO schemes as the reference's does,
    # and refuses the host-only ones
    failed = none.copy()
    failed[2, 5] = failed[6, 1] = True
    got = Q.repair(qs, "vlb", failed, impl="jnp", device="cpu")
    want = R.repair(R.round_robin(N, 1), "vlb", failed, impl="jnp")
    for name in ("tf_next", "tf_dep", "inj_next", "inj_dep"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.multipath == want.multipath
    with pytest.raises(ValueError, match="host-only"):
        Q.repair(qs, "ecmp", none, impl="jnp", device="cpu")
    with pytest.raises(ValueError, match="unknown scheme"):
        Q.repair(qs, "teleport", none)
    with pytest.raises(ValueError, match="unknown impl"):
        Q.repair(qs, "vlb", none, impl="cuda")
    # an ecmp table has a cycle of 1 slice, the schedule 7
    for pkg, sched in ((R, R.round_robin(N, 1)), (Q, qs)):
        with pytest.raises(ValueError, match="cycle"):
            pkg.fast_reroute(pkg.ecmp(sched), sched, none)


# ---------------------------------------------------------------------------
# phased table swaps
# ---------------------------------------------------------------------------

def _workload():
    return R.synthesize("rpc", N, 40, slice_bytes=4_000, load=0.6,
                        max_packets=360, seed=4)


def _phases(pkg, sched, failed, one):
    """One phase of the deployed ucmp tables; or three: those up to the
    outage, a fast-reroute patch with destination-aware backups, and a
    repair over the links still failed after the heal."""
    r = pkg.ucmp(sched)
    if one:
        return [(r, SLICES)]
    patched = pkg.fast_reroute(r, sched, failed[0],
                               backups=pkg.backup_tables_dp(sched))
    return [(r, 10), (patched, 20), (pkg.repair(sched, "vlb", failed[1]),
                                     SLICES - 30)]


@pytest.mark.parametrize("one", [True, False], ids=["one-phase",
                                                    "three-phases"])
def test_simulate_phased_matches_reference(one):
    rs, qs = R.round_robin(N, 1), Q.round_robin(N, 1)
    fail = R.compile_masks(R.FailureTrace().tor_outage(5, 10, 30)
                           .link_flap(1, 2, 10).degrade(3, 4, 0.5, 0),
                           rs, SLICES)
    failed = (fail.failed_links(10), fail.failed_links(30))
    cfg = dict(slice_bytes=4_000)
    ref = R.simulate_phased(rs, _phases(R, rs, failed, one), _workload(),
                            R.FabricConfig(**cfg), failures=fail)
    qf, _ = carry_masks(fail)
    _, qw = carry(R.FabricTables.build(rs, R.ucmp(rs)), _workload())
    port = Q.simulate_phased(qs, _phases(Q, qs, failed, one), qw,
                             Q.FabricConfig(**cfg), failures=qf,
                             device="cpu")
    assert_sim_equal(ref, port)
    if one:
        qt, _ = carry(R.FabricTables.build(rs, R.ucmp(rs)), _workload())
        assert_sim_equal(port, Q.simulate(qt, qw, Q.FabricConfig(**cfg),
                                          SLICES, failures=qf, device="cpu"))
    else:
        assert int(port.slice_miss.sum()) > 0
    with pytest.raises(ValueError, match="do not cover"):
        Q.simulate_phased(qs, [(Q.ucmp(qs), SLICES - 1)], qw,
                          Q.FabricConfig(**cfg), failures=qf, device="cpu")
