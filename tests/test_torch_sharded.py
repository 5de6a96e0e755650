"""The port's sharded fabric (``repro_torch.core.simulate_sharded``, its
body ``simulate_shard`` and ``repro_torch.distributed``) on the CPU, over
gloo ranks spawned from the test: the counterparts of
``tests/test_fabric_sharded.py``.

* Against the reference's ``simulate_sharded`` on its forced 8-device CPU
  mesh at the same shard count, field for field, the ownership trace
  (``adm_shard``) included.
* Against the port's own ``simulate`` at 2, 3 and 5 shards (5 divides
  neither N = 8 nor the packet count): per-packet multipath over several
  valid slots (``ucmp``, ``vlb`` over two uplinks: a lookup that hashed
  the shard-local index would pick other slots), per-flow multipath
  (``wcmp``), failure and control masks with telemetry, push-back with
  offloading. ``toolkit.check_sharding`` finds nothing on every run.
* The collectives, the backend choice (ranks sharing a card need
  ``backend="gloo"`` named), a failing rank failing the call, versioned
  tables refused, and the layout helpers against the reference's,
  footprint numbers included.
"""
import dataclasses
import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as Q  # noqa: E402
import torch_shard_body  # noqa: E402
from repro.distributed import sharding as R_shard  # noqa: E402
from repro_torch.core import fabric as Q_fabric  # noqa: E402
from repro_torch.distributed import sharding as Q_shard  # noqa: E402
from repro_torch.distributed import spawn  # noqa: E402
from torch_parity import (assert_sim_equal, carry, carry_masks,  # noqa: E402, F401
                          one_torch_thread, release_compiled_programs)

N = 8
SLICES = 32


def _wl(seed=11, max_packets=419):
    return R.synthesize("rpc", N, 24, slice_bytes=4_000, load=0.9,
                        max_packets=max_packets, seed=seed)


def _case(name):
    """(reference tables, workload, config kwargs, failures, control,
    telemetry) of a case."""
    if name == "ucmp-masks-telemetry":
        sched = R.round_robin(N, 2)
        fm = R.compile_masks(R.random_trace(3, sched, SLICES), sched, SLICES)
        cm = R.compile_control(R.random_control_trace(4, N, SLICES), SLICES,
                               N)
        return (R.FabricTables.build(sched, R.ucmp(sched, kpaths=3)), _wl(),
                dict(slice_bytes=4_000), fm, cm, True)
    if name == "wcmp-per-flow":
        sched = R.uniform_mesh(N, 2)
        return (R.FabricTables.build(sched, R.wcmp(sched)), _wl(5, 363),
                dict(slice_bytes=4_000, cc_detect=True), None, None, False)
    assert name == "vlb-pushback-offload"
    sched = R.round_robin(N, 2)
    return (R.FabricTables.build(sched, R.vlb(sched, kpaths=3)),
            _wl(7, 421),
            dict(slice_bytes=4_000, pushback=True, offload=True,
                 offload_horizon=1, switch_buffer=30_000, elec_bytes=2_000),
            None, None, False)


def _port_case(name):
    """The case as ``simulate_shard``'s positional arguments."""
    tables, wl, cfg, fm, cm, tele = _case(name)
    qt, qw = carry(tables, wl)
    qf, qc = carry_masks(fm, cm)
    return (qt, qw, Q.FabricConfig(**cfg), SLICES, qf, qc,
            Q.TelemetryConfig() if tele else None)


NAMES = ("ucmp-masks-telemetry", "wcmp-per-flow", "vlb-pushback-offload")
# 3 shards: test_sharded_matches_reference
SHARDS = {2: NAMES[::2], 5: NAMES[:2]}


@pytest.fixture(scope="module")
def runs(one_torch_thread):
    """Each shard count's cases, one spawned process group a count, and
    each case's single-device run; the collectives' probe of the 5-rank
    group."""
    out, probe = {}, None
    for D, names in SHARDS.items():
        got, pr = spawn.run_ranks(
            torch_shard_body.run_cases,
            ([_port_case(n) for n in names], D == 5), D, "gloo", "cpu", 300)
        out.update({(D, n): g for n, g in zip(names, got)})
        probe = pr if pr is not None else probe
    solo = {n: Q.simulate(*_port_case(n), device="cpu") for n in NAMES}
    return out, solo, probe


@pytest.mark.parametrize("D,name", [(D, n) for D, ns in SHARDS.items()
                                    for n in ns])
def test_sharded_equals_simulate(runs, D, name):
    out, solo, _ = runs
    res, dbg = out[(D, name)]
    assert_sim_equal(solo[name], res)
    qw = _port_case(name)[1]
    assert Q.toolkit.check_sharding(res, dbg, qw, SLICES) == []
    assert dbg["num_shards"] == D
    assert dbg["packet_block"] == Q_shard.block_len(qw.num_packets, D)
    hopped = res.nhops > 0
    np.testing.assert_array_equal(dbg["adm_shard"][hopped],
                                  dbg["owner"][hopped])
    assert (dbg["adm_shard"][~hopped] == -1).all()
    if D == 5:
        assert qw.num_packets % D and N % D


def test_sharded_matches_reference(eight_devices, runs):
    """The entry point (3 spawned ranks) against the reference's sharded
    run on 3 of its 8 devices and against the port's ``simulate``: every
    field, every counter, and the ownership trace; ``check_sharding``
    finds nothing."""
    name = "ucmp-masks-telemetry"
    tables, wl, cfg, fm, cm, _ = _case(name)
    ref, ref_dbg = R.simulate_sharded(
        tables, wl, R.FabricConfig(**cfg), SLICES, num_shards=3, failures=fm,
        control=cm, telemetry=R.TelemetryConfig(), with_debug=True)
    qt, qw, qcfg, _, qf, qc, tele = _port_case(name)
    got, dbg = Q.simulate_sharded(qt, qw, qcfg, SLICES, num_shards=3,
                                  failures=qf, control=qc, telemetry=tele,
                                  with_debug=True, device="cpu")
    assert_sim_equal(ref, got)
    assert_sim_equal(runs[1][name], got)
    assert Q.toolkit.check_sharding(got, dbg, qw, SLICES) == []
    assert qw.num_packets % 3 and N % 3
    assert set(ref_dbg) <= set(dbg)
    # the plain versions on the CPU launch no kernel; the ranks exchanged
    np.testing.assert_array_equal(dbg["launches"], np.zeros((3, 2)))
    assert dbg["exchanges"] > SLICES and dbg["exchanged_bytes"] > 0
    for k in ("adm_shard", "owner"):
        np.testing.assert_array_equal(np.asarray(ref_dbg[k]), dbg[k],
                                      err_msg=k)
    assert (dbg["num_shards"], dbg["packet_block"]) == \
        (ref_dbg["num_shards"], ref_dbg["packet_block"])
    assert len(set(dbg["adm_shard"].tolist()) - {-1}) >= 2


def test_collectives(runs):
    """Each collective over 5 gloo ranks: the offsets are each rank's sum
    of the earlier ranks' rows, the gathers join the owned blocks and drop
    the padding, min and max reduce (rank 0's view)."""
    probe, D = runs[2], 5
    local = [np.arange(5) * (r + 1) + r for r in range(D)]
    np.testing.assert_array_equal(probe["sum"], sum(local))
    np.testing.assert_array_equal(probe["offsets"], 0)
    np.testing.assert_array_equal(
        probe["all_offsets"], [sum(local[:r], 0 * local[0])
                               for r in range(D)])
    np.testing.assert_array_equal(
        probe["min"], np.min([v - 3 * r for r, v in enumerate(local)], 0))
    np.testing.assert_array_equal(
        probe["max"], np.max([v - 3 * r for r, v in enumerate(local)], 0))
    np.testing.assert_array_equal(
        probe["row"], [10 * r + i for r in range(D) for i in (0, 1)][:-1])
    assert probe["rows"].shape == (3, 2 * D - 1)
    assert probe["rows"].dtype == bool
    np.testing.assert_array_equal(
        probe["rows"][0], [r % 2 == 0 or i for r in range(D)
                           for i in (0, 1)][:-1])


def test_backend_is_never_switched_silently(monkeypatch):
    """Ranks sharing a card need ``backend="gloo"`` named: the default
    (NCCL, a card a rank) raises, and so does NCCL named; the CPU runs
    gloo."""
    ch = spawn.choose_backend
    assert ch(1, "cuda", num_cards=1) == "nccl"
    assert ch(4, "cuda", num_cards=4) == "nccl"
    for backend in (None, "nccl"):
        with pytest.raises(ValueError, match="backend='gloo'"):
            ch(4, "cuda", backend, num_cards=1)
    assert ch(4, "cuda", "gloo", num_cards=1) == "gloo"
    assert ch(5, "cpu") == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        ch(2, "cpu", "nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        ch(2, "cpu", "mpi")
    # the entry point asks before it spawns anything, and runs on CUDA
    # unless told otherwise
    qt, qw, qcfg = _port_case("wcmp-per-flow")[:3]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="backend='gloo'"):
        Q.simulate_sharded(qt, qw, qcfg, 4, num_shards=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Q.simulate_sharded(qt, qw, qcfg, 4, num_shards=2, backend="gloo")


def test_failed_rank_fails_the_call():
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        spawn.run_ranks(torch_shard_body.fail_on_rank, (1, 2), 2, "gloo",
                        "cpu", 120)


def test_versioned_tables_refused():
    """Versioned tables come from the reconfigure loop; a sharded step
    refuses them, as the reference's does."""
    with pytest.raises(ValueError, match="versioned"):
        Q_fabric._make_step({"tf_next_v": None,
                             "shard": Q_fabric._Shard(0, 2)},
                            Q.FabricConfig(), True)


def test_fabric_group_checks_the_size(tmp_path):
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="no process group"):
        Q_shard.fabric_group()
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        assert Q_shard.fabric_group()[1] == 1
        assert Q_shard.fabric_group(1)[1] == 1
        with pytest.raises(ValueError, match="num_shards=2"):
            Q_shard.fabric_group(2)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n,D", [(420, 8), (420, 5), (8, 3), (108, 4),
                                 (108, 8), (1, 3), (0, 2), (131_072, 5)])
def test_layout_helpers_match_reference(n, D):
    assert Q_shard.block_len(n, D) == R_shard.block_len(n, D)
    idx = np.arange(n)
    np.testing.assert_array_equal(Q_shard.shard_owner(idx, n, D),
                                  R_shard.shard_owner(idx, n, D))
    a = np.arange(n, dtype=np.int32)
    np.testing.assert_array_equal(Q_shard.pad_packet_axis(a, D, -7),
                                  R_shard.pad_packet_axis(a, D, -7))
    m = np.ones((3, n, 2), np.float32)
    np.testing.assert_array_equal(Q_shard.pad_node_rows(m, D, 0.5),
                                  R_shard.pad_node_rows(m, D, 0.5))
    assert Q_shard.node_rows_bytes_per_device(11, n, D) == \
        R_shard.node_rows_bytes_per_device(11, n, D)
    with pytest.raises(ValueError):
        Q_shard.block_len(n, 0)


@pytest.mark.parametrize("num_shards,rows", [(4, 27), (8, 14)])
def test_mask_rows_footprint_paper_scale(num_shards, rows):
    """At 108 ToRs x 10^3 slices a rank holds ``ceil(N / D)`` rows of the
    f32 ``link_cap``: 11,664,000 bytes at D = 4, 6,048,000 at D = 8."""
    assert Q_shard.block_len(108, num_shards) == rows
    assert Q_shard.node_rows_bytes_per_device(1000, 108, num_shards) == \
        {4: 11_664_000, 8: 6_048_000}[num_shards]
    padded = Q_shard.pad_node_rows(np.ones((4, 108, 108), np.float32),
                                   num_shards, 1.0)
    assert padded.shape == (4, rows * num_shards, 108)
    assert np.all(padded[:, 108:] == 1.0)


def test_results_are_the_references_types(runs):
    """A sharded result is a ``SimResult`` of int32 arrays, the padding
    dropped."""
    out, solo, _ = runs
    res, _ = out[(5, "ucmp-masks-telemetry")]
    assert isinstance(res, Q.SimResult)
    for f in dataclasses.fields(res):
        if f.name != "telemetry":
            assert getattr(res, f.name).dtype == np.int32, f.name
    assert res.t_deliver.shape == solo["ucmp-masks-telemetry"].t_deliver.shape
