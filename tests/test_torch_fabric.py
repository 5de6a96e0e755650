"""The PyTorch port's ``simulate`` (on the CPU, through the kernels' plain
versions) against ``repro.core.simulate`` on every case of
``tests/test_fabric_golden.py``: the §5.2 mechanism matrix, flow pausing,
the single-hop rotor, both large populations and the mixed rx/capacity
pressure case. Bit-identical ``SimResult``s, values and dtypes. One case is
also held against the seed data plane ``tests/fabric_ref.py::simulate_ref``.
The electrical Clos, per-flow multipath, all 8 schemes and the
``OpenOpticsNet`` API are in ``test_torch_fabric_mechanisms.py``.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as Q  # noqa: E402

from fabric_ref import simulate_ref  # noqa: E402
from torch_parity import (  # noqa: E402, F401
    assert_sim_equal, carry, simulate_both, release_compiled_programs)

N = 8
SLICES = 48


def _workload():
    return R.synthesize("rpc", N, 24, slice_bytes=4_000, load=0.9,
                        max_packets=420, seed=11)


def _tables(alg=R.ucmp):
    sched = R.round_robin(N, 1)
    return R.FabricTables.build(sched, alg(sched))


CFG_MATRIX = [
    dict(cc_detect=cc, pushback=pb, offload=off)
    for cc in (False, True) for pb in (False, True) for off in (False, True)
    # push-back builds on congestion detection (paper §5.2)
    if not (pb and not cc)
]


@pytest.mark.parametrize("over", CFG_MATRIX,
                         ids=lambda o: "-".join(f"{k}={int(v)}" for k, v in o.items()))
def test_simulate_matches_reference(over):
    ref, port = simulate_both(_tables(), _workload(), SLICES,
                              slice_bytes=4_000, offload_horizon=1,
                              switch_buffer=30_000, **over)
    assert_sim_equal(ref, port)


def test_simulate_matches_seed_reference():
    """The one case also held against the seed data plane."""
    tables, wl = _tables(), _workload()
    cfg = dict(slice_bytes=4_000, pushback=True, offload=True,
               offload_horizon=1, switch_buffer=30_000)
    qt, qw = carry(tables, wl)
    assert_sim_equal(simulate_ref(tables, wl, R.FabricConfig(**cfg), SLICES),
                     Q.simulate(qt, qw, Q.FabricConfig(**cfg), SLICES,
                                device="cpu"))


def test_simulate_deterministic_and_port_tables():
    """Two port runs agree, and the port's own compilers give the same
    run as tables carried over from the reference."""
    tables, wl = _tables(), _workload()
    qt, qw = carry(tables, wl)
    sched = Q.round_robin(N, 1)
    own = Q.FabricTables.build(sched, Q.ucmp(sched))
    cfg = Q.FabricConfig(slice_bytes=4_000, pushback=True, offload=True,
                         offload_horizon=1)
    a = Q.simulate(qt, qw, cfg, SLICES, device="cpu")
    b = Q.simulate(own, qw, cfg, SLICES, device="cpu")
    for f in a.__dataclass_fields__:
        assert np.all(getattr(a, f) == getattr(b, f)), f


def test_simulate_zero_slices_and_shapes():
    tables, wl = _tables(), _workload()
    ref, port = simulate_both(tables, wl, 0, slice_bytes=4_000)
    assert_sim_equal(ref, port)
    assert port.buf_bytes.shape == (0, N)


def test_flow_pausing():
    assert_sim_equal(*simulate_both(_tables(R.vlb), _workload(), SLICES,
                                    slice_bytes=4_000, flow_pausing=True))


def test_rotor_single_hop():
    assert_sim_equal(*simulate_both(_tables(R.hoho), _workload(), SLICES,
                                    slice_bytes=4_000, hops_per_slice=1))


@pytest.mark.parametrize("over", [
    dict(),
    dict(pushback=True, offload=True, offload_horizon=1,
         switch_buffer=200_000),
], ids=["plain", "pushback-offload"])
def test_large_population(over):
    """The golden large-population cases: P = 9000 packets, more than the
    reference's compact-view tiers hold."""
    wl = R.synthesize("rpc", N, 12, slice_bytes=40_000, load=4.0,
                      max_packets=9000, seed=13)
    assert wl.num_packets > 8192
    assert_sim_equal(*simulate_both(_tables(), wl, 20, slice_bytes=40_000,
                                    **over))


def test_mixed_rx_capacity_pressure():
    """Push-back's backlog filters under mixed admission groups: a small
    switch buffer makes the rx cut bind where a hybrid electrical share and
    2x load make the capacity cut bind."""
    wl = R.synthesize("rpc", N, 24, slice_bytes=3_000, load=2.0,
                      max_packets=1200, seed=7)
    ref, port = simulate_both(_tables(), wl, SLICES, slice_bytes=3_000,
                              elec_bytes=1_500, cc_detect=True,
                              pushback=True, switch_buffer=9_000)
    assert int(ref.slice_miss.sum()) > 0
    assert_sim_equal(ref, port)
