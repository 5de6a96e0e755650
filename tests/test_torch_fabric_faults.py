"""The PyTorch port's ``simulate`` with failure masks and with control-plane
masks (on the CPU, through the kernels' plain versions) against
``repro.core.simulate``: every ``SimResult`` field bit for bit, values and
dtypes. Failures: random traces and hand traces (dead links, a degraded
link, a ToR outage, a stuck port, an electrical destination that is down)
under the default fabric, push-back with offloading, and flow pausing.
Control: skews of whole slices back and forward and beyond the table
cycle, residuals past the guard band, drift, the electrical fabric's
exemption, flow pausing; a skew inside the guard band equals the run
without control. Also the lookup's plain version with per-node slice
offsets against the reference's gather form, and the step's ops without
optional inputs, pinned.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as Q  # noqa: E402
from repro.core import fabric as R_fabric  # noqa: E402
from repro_torch.core import fabric as Q_fabric  # noqa: E402
from repro_torch.kernels import time_flow_lookup as Q_tfl  # noqa: E402

from torch_parity import (  # noqa: E402, F401
    assert_sim_equal, carry, carry_masks, release_compiled_programs)

N = 8
SLICES = 48
SLICE_NS = 2000.0      # the §7 minimum slice, compile_control's default
BASE = dict(slice_bytes=4_000)
CFGS = {
    "default": dict(BASE),
    "pushback-offload": dict(BASE, pushback=True, offload=True,
                             offload_horizon=1, switch_buffer=30_000),
    "flow-pausing": dict(BASE, flow_pausing=True),
}


def _workload():
    return R.synthesize("rpc", N, 24, slice_bytes=4_000, load=0.9,
                        max_packets=420, seed=11)


def _tables(alg=R.ucmp):
    sched = R.round_robin(N, 1)
    if alg == "clos":
        return sched, R.FabricTables.build(sched, R.clos_routing(N))
    return sched, R.FabricTables.build(sched, alg(sched))


def _run_both(tables, wl, cfg, failures=None, control=None):
    ref = R.simulate(tables, wl, R.FabricConfig(**cfg), SLICES,
                     failures=failures, control=control)
    qt, qw = carry(tables, wl)
    qf, qc = carry_masks(failures, control)
    port = Q.simulate(qt, qw, Q.FabricConfig(**cfg), SLICES, device="cpu",
                      failures=qf, control=qc)
    assert_sim_equal(ref, port)
    return ref, port


def _hand_failures(sched):
    return (R.FailureTrace()
            .link_flap(0, 1, 0, 30).link_flap(2, 3, 10)
            .degrade(4, 5, 0.37, 0).degrade(1, 6, 0.5, 5, 40)
            .degrade(1, 6, 0.61, 20)
            .tor_outage(7, 12, 26).stuck_port(3, 0, 6, 33))


# ---------------------------------------------------------------------------
# failures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_failures_match_reference(seed):
    sched, tables = _tables()
    masks = R.compile_masks(R.random_trace(seed, sched, SLICES, n_events=6),
                            sched, SLICES)
    ref, _ = _run_both(tables, _workload(), CFGS["default"], failures=masks)
    assert int(ref.slice_miss.sum()) > 0


@pytest.mark.parametrize("name", list(CFGS))
def test_hand_failures_match_reference(name):
    """Dead links, composed and partial degradations (the float32 product
    truncated toward zero), a ToR outage and a stuck port, under each
    configuration."""
    sched, tables = _tables(R.vlb if name == "flow-pausing" else R.ucmp)
    masks = R.compile_masks(_hand_failures(sched), sched, SLICES)
    cap = masks.link_cap
    assert ((cap > 0) & (cap < 1)).any() and (cap == 0).any()
    assert not masks.node_ok.all()
    ref, port = _run_both(tables, _workload(), CFGS[name], failures=masks)
    healthy = Q.simulate(*carry(tables, _workload()),
                         Q.FabricConfig(**CFGS[name]), SLICES, device="cpu")
    assert not np.array_equal(port.t_deliver, healthy.t_deliver)


def test_electrical_destination_down_matches_reference():
    """The electrical Clos: a down ToR terminates no electrical transfer
    and injects nothing, and the capacity of its electrical egress goes."""
    sched, tables = _tables("clos")
    masks = R.compile_masks(R.FailureTrace().tor_outage(2, 5, 30)
                            .tor_outage(6, 0, 12), sched, SLICES)
    wl = _workload()
    ref, port = _run_both(tables, wl, dict(BASE, elec_bytes=3_000),
                          failures=masks)
    to_down = (wl.dst == 2) & (port.t_deliver >= 5) & (port.t_deliver < 30)
    assert not to_down.any() and (wl.dst == 2).any()
    assert (port.t_deliver[wl.dst == 2] >= 30).any()


def test_healthy_masks_equal_no_masks():
    """All-healthy masks change nothing against the failure-free run."""
    sched, tables = _tables()
    qt, qw = carry(tables, _workload())
    cfg = Q.FabricConfig(**CFGS["pushback-offload"])
    plain = Q.simulate(qt, qw, cfg, SLICES, device="cpu")
    masked = Q.simulate(qt, qw, cfg, SLICES, device="cpu",
                        failures=Q.FailureMasks.healthy(SLICES, N))
    assert_sim_equal(plain, masked)


class _CountOps(TorchDispatchMode):
    """The names of the aten ops run under it, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _step_ops(cfg, slices=4, failures=None, control=None, telemetry=None):
    """The op names of each of the first ``slices`` steps on the CPU."""
    sched, tables = _tables(R.vlb if cfg.get("flow_pausing") else R.ucmp)
    qt, qw = carry(tables, _workload())
    j = Q_fabric._device_arrays(qt, qw, torch.device("cpu"))
    qf, qc = carry_masks(failures, control)
    Q_fabric._add_masks(j, qf, qc, SLICES)
    step = Q_fabric._make_step(j, Q.FabricConfig(**cfg),
                               qt.multipath == "packet", telemetry)
    state = Q_fabric._init_state(j, int(qw.flow.max()) + 1)
    seqs = []
    for t in range(slices):
        with _CountOps() as c:
            step(state, t)
        seqs.append(c.ops)
    return seqs


# aten ops a slice of the step without optional inputs: the program a run
# without failures, control or telemetry has always had
NO_INPUT_OPS = {"default": 941, "pushback-offload": 1394, "flow-pausing": 950}


@pytest.mark.parametrize("name", list(CFGS))
def test_no_input_step_ops_are_pinned(name):
    """Without optional inputs the step runs none of their branches: the
    same ops every slice, as many as before the branches existed; each
    input adds its own."""
    seqs = _step_ops(CFGS[name])
    assert all(s == seqs[0] for s in seqs)
    assert len(seqs[0]) == NO_INPUT_OPS[name]
    sched, _ = _tables()
    inputs = dict(
        failures=R.compile_masks(_hand_failures(sched), sched, SLICES),
        control=_control(SKEWS["behind-one"]),
        telemetry=Q.TelemetryConfig())
    for key, value in inputs.items():
        assert len(_step_ops(CFGS[name], 1, **{key: value})[0]) > \
            NO_INPUT_OPS[name], key


# ---------------------------------------------------------------------------
# control plane
# ---------------------------------------------------------------------------

def _control(trace):
    return R.compile_control(trace, SLICES, N)


# whole-slice skews (phase_off -1, +1, beyond the 7-slice cycle both ways,
# with residuals inside the 200 ns band), residuals past the band, drift
SKEWS = {
    "behind-one": R.ControlTrace().skew(1, -SLICE_NS, 0)
                   .skew(4, -SLICE_NS - 120.0, 6, 40),
    "ahead-one": R.ControlTrace().skew(2, SLICE_NS, 0).skew(6, SLICE_NS, 3),
    "beyond-cycle": R.ControlTrace().skew(0, 9 * SLICE_NS, 0)
                     .skew(3, -10 * SLICE_NS + 50.0, 4)
                     .skew(5, -15 * SLICE_NS, 0, 30),
    "past-guard-band": R.ControlTrace().skew(1, SLICE_NS + 500.0, 2)
                        .skew(5, -700.0, 0, 35).skew(7, 250.0, 10),
    "drift": R.ControlTrace().drift(2, 160.0, 0).drift(6, -95.0, 5, 44),
}


@pytest.mark.parametrize("name", list(SKEWS))
def test_control_matches_reference(name):
    sched, tables = _tables()
    masks = _control(SKEWS[name])
    if name != "past-guard-band":
        assert (masks.phase_off != 0).any()
    if name in ("past-guard-band", "drift"):
        assert masks.skew_miss.any()
    if name == "beyond-cycle":
        assert masks.phase_off.min() < -7 and masks.phase_off.max() > 7
    ref, port = _run_both(tables, _workload(), CFGS["default"],
                          control=masks)
    plain = Q.simulate(*carry(tables, _workload()),
                       Q.FabricConfig(**CFGS["default"]), SLICES,
                       device="cpu")
    assert not np.array_equal(port.t_deliver, plain.t_deliver)


def test_control_flow_pausing_matches_reference():
    """Elephants wait for the direct circuit their source ToR's own clock
    expects."""
    sched, tables = _tables(R.vlb)
    trace = (R.ControlTrace().skew(0, -SLICE_NS, 0).skew(1, 3 * SLICE_NS, 0)
             .skew(5, SLICE_NS + 400.0, 8).drift(3, 110.0, 0))
    _run_both(tables, _workload(), CFGS["flow-pausing"],
              control=_control(trace))


def test_control_exempts_the_electrical_fabric():
    """Past the guard band a ToR loses its optical slots, not its
    electrical egress: on the electrical Clos the run is the one without
    control."""
    sched, tables = _tables("clos")
    masks = _control(R.ControlTrace().skew(1, 700.0, 0).skew(3, -900.0, 4)
                     .skew(6, SLICE_NS + 300.0, 0))
    assert masks.skew_miss.any()
    cfg = dict(BASE, elec_bytes=3_000)
    _, port = _run_both(tables, _workload(), cfg, control=masks)
    plain = Q.simulate(*carry(tables, _workload()), Q.FabricConfig(**cfg),
                       SLICES, device="cpu")
    assert_sim_equal(plain, port)


def test_skew_inside_guard_band_equals_no_control():
    sched, tables = _tables()
    masks = _control(R.ControlTrace().skew(1, 150.0, 0).skew(4, -199.0, 3)
                     .drift(6, 1.5, 0))
    assert not masks.skew_miss.any() and not masks.phase_off.any()
    _, port = _run_both(tables, _workload(), CFGS["default"], control=masks)
    plain = Q.simulate(*carry(tables, _workload()),
                       Q.FabricConfig(**CFGS["default"]), SLICES,
                       device="cpu")
    assert_sim_equal(plain, port)


# ---------------------------------------------------------------------------
# the lookup with per-node slice offsets
# ---------------------------------------------------------------------------

def _random_tables(rng, Tr, n, k):
    """[2, Tr, n, n, k] (next, dep) stacks with contiguous valid slots,
    empty rows included."""
    nv = rng.integers(0, k + 1, size=(2, Tr, n, n))
    tn = np.where(np.arange(k) < nv[..., None],
                  rng.integers(0, n + 1, (2, Tr, n, n, k)), -1)
    td = np.where(tn >= 0, rng.integers(0, 9, (2, Tr, n, n, k)), 0)
    return tn.astype(np.int32), td.astype(np.int32)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_lookup_offsets_match_reference_gather(k):
    """``stk[sel, (t + phase_off[node]) % Tr, node, dst]`` and the slot
    pick of the reference, for offsets of both signs and beyond the cycle;
    with a hash vector, with the in-kernel hash of slice t and a mask."""
    rng = np.random.default_rng(k)
    Tr, n, P = 5, 7, 3000
    tn, td = _random_tables(rng, Tr, n, k)
    packed = torch.from_numpy(np.ascontiguousarray(np.stack([tn, td], 4)))
    sel = rng.integers(0, 2, P).astype(np.int32)
    node = rng.integers(0, n, P).astype(np.int32)
    dst = rng.integers(0, n, P).astype(np.int32)
    po = rng.integers(-2 * Tr, 2 * Tr + 1, n).astype(np.int32)
    po[:3] = (0, -1, -Tr)
    mask = rng.random(P) < 0.6
    for t in (0, 3, 11, 212):
        tl = t + jnp.asarray(po)[node]
        hv = R_fabric._hash32(jnp.arange(P, dtype=jnp.uint32)
                              + jnp.uint32(t) * jnp.uint32(0x9E3779B9))
        want = R_fabric._select_slot(
            jnp.asarray(tn)[sel, tl % Tr, node, dst],
            jnp.asarray(td)[sel, tl % Tr, node, dst], hv)
        want = [np.asarray(w) for w in want]
        args = (packed, None, t % Tr, torch.from_numpy(sel),
                torch.from_numpy(node), torch.from_numpy(dst))
        bits = torch.from_numpy(np.array(hv).view(np.int32))
        for h in (bits, t):
            nxt, off = Q_tfl.time_flow_lookup_plain(
                *args, h, phase_off=torch.from_numpy(po))
            np.testing.assert_array_equal(nxt.numpy(), want[0])
            np.testing.assert_array_equal(off.numpy(), want[1])
        nxt, off = Q_tfl.time_flow_lookup(
            *args, t, mask=torch.from_numpy(mask),
            phase_off=torch.from_numpy(po))
        np.testing.assert_array_equal(nxt.numpy(),
                                      np.where(mask, want[0], -1))
        np.testing.assert_array_equal(off.numpy(), np.where(mask, want[1], 0))
        # a constant selector (the hop site) reads the same slices
        one = Q_tfl.time_flow_lookup_plain(
            packed, None, t % Tr, 1, *args[4:], t,
            phase_off=torch.from_numpy(po))
        ones = np.ones(P, np.int32)
        want1 = R_fabric._select_slot(
            jnp.asarray(tn)[ones, tl % Tr, node, dst],
            jnp.asarray(td)[ones, tl % Tr, node, dst], hv)
        for a, b in zip(one, want1):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_lookup_checks_phase_off():
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    args = (z(2, 3, 4, 4, 2, 2), None, 1, z(5), z(5), z(5), z(5))
    Q_tfl._check(*args, phase_off=z(4))
    for bad in (z(5), z(4).long(), z(8)[::2], z(1, 4)):
        with pytest.raises(ValueError, match="phase_off"):
            Q_tfl._check(*args, phase_off=bad)
