"""The traffic-aware reconfigure loop in PyTorch: the port of
``repro.core.reconfigure``.

The paper's headline case study (§4.2, Fig. 4/5): measure the demand,
re-derive the schedule, recompile the time-flow tables, swap them into the
running fabric, and go on. :func:`reconfigure` runs ``num_epochs`` epochs
of ``epoch_slices`` slices, as a Python loop over epochs on one device
(CUDA unless the caller names another). Each epoch:

1. **measures** the pending bytes per (src, dst) pair from the live packet
   state (an int32 ``index_add_``);
2. **re-derives the schedule** with the configured scheduler:
   ``"hot_slices"`` appends ``k_hot`` slices to the base cycle, each a
   dedicated bidirectional circuit for one of the top-demand pairs (a
   stable descending sort, so ties go to the lower pair index, as
   ``lax.top_k``'s do); ``"edmonds"`` holds one greedy max-weight matching
   topology and ``"bvn"`` cycles a Birkhoff-von-Neumann decomposition
   (:mod:`.topology_jnp`, both from the demand cast to float32);
3. **detects and heals**: with failure masks, the dead circuits at the
   epoch's first slice are counted, and under ``heal`` the schedule is
   masked down to the surviving circuits;
4. **recompiles** the tables on the device (:mod:`.routing_jnp`);
5. **swaps them in**: without control masks atomically, with them as a
   *versioned install* against the install delay and loss trace: the
   controller sends the new tables at the epoch's first slice (2PC
   re-sends on its backoff), each ToR runs, slice by slice, its old, new
   or safe tables as its install state selects (``vsel``), and a ToR
   whose install was lost keeps its old ones. The install arithmetic is
   :func:`repro_torch.core.controlplane.install_schedule` (host numpy over
   the trace's rows, a few values an epoch); the tables stay on the
   device;
6. **runs** the epoch's slices through
   :func:`repro_torch.core.fabric.step_slices`, with the masks re-based
   to the epoch's window (so the masked capacities follow the epoch's
   schedule) and, under control, the versioned tables and ``vsel``: both
   lookup sites pass each ToR's version to the lookup kernel.

:func:`reconfigure_fleet` runs the same loop over a sweep of B scenarios
(traffic seeds, failure and control traces) on the layout of
:func:`repro_torch.core.fabric.simulate_fleet`: one demand measure and one
fabric window an epoch for all of them, a schedule, heal, recompile and
install per scenario (versioned tables ``[V, Tr, B·N, N, K]``, a version
select ``[E, B·N]``). :func:`reconfigure` is the sweep of one, so the
loop has one copy.

Telemetry counters come back concatenated over the epochs, as the windows
of the incremental API join them. With ``scheduler="hot_slices"`` and
``k_hot=0`` the schedule never changes and the loop equals a plain
:func:`repro_torch.core.fabric.simulate` of the same length.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import fabric as fabric_mod
from . import routing_jnp, topology_jnp
from .controlplane import NEVER as INT_INF
from .controlplane import install_schedule
from .failures import surviving_conn
from .telemetry import TelemetryConfig, TelemetryCounters, counters_from_out
from .topology import Schedule

__all__ = ["ReconfigConfig", "ReconfigResult", "reconfigure",
           "reconfigure_fleet"]

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ReconfigConfig:
    """Parameters of the reconfigure loop (the reference's fields and
    defaults).

    epoch_slices: fabric slices per epoch between recompiles.
    num_epochs: epochs; the run is ``num_epochs * epoch_slices`` slices.
    scheme: the TO routing scheme recompiled each epoch, one of
        :data:`repro_torch.core.routing_jnp.SCHEMES`.
    scheduler: one of :data:`repro_torch.core.topology_jnp.SCHEDULERS`:
        "hot_slices" (``k_hot`` top-demand pairs get extra slices on the
        base cycle), "edmonds" (one greedy matching topology), "bvn" (a
        ``bvn_slices``-slice cycle over ``bvn_perms`` permutations). The
        last two ignore the base cycle but for N and U.
    k_hot: hot-pair slices appended each epoch (0: the schedule never
        changes; only the recompile loop runs).
    bvn_slices / bvn_perms / sinkhorn_iters: the BvN cycle length,
        decomposition depth and Sinkhorn rounds.
    max_hop / kpaths: forwarded to the routing compiler.
    heal: with failure masks, recompile each epoch over the circuits
        alive at its first slice.
    install: with control masks, ``"hotswap"`` (each ToR flips when its
        install message lands) or ``"2pc"`` (prepare re-sent up to
        ``install_retries`` times every ``install_backoff`` slices; the
        fabric flips atomically once every ToR acked, if that is within
        ``install_timeout`` slices of the epoch's start, else not at all).
    degrade: with ``"2pc"`` and ``"hot_slices"``, an install that times
        out or a skew past the guard band in the epoch sends every ToR to
        the safe tables (direct routing over the base cycle) from then to
        the epoch's end.
    """

    epoch_slices: int = 32
    num_epochs: int = 8
    scheme: str = "hoho"
    scheduler: str = "hot_slices"
    k_hot: int = 4
    bvn_slices: int = 8
    bvn_perms: int = 8
    sinkhorn_iters: int = 50
    max_hop: int = 4
    kpaths: int = 4
    heal: bool = False
    install: str = "hotswap"
    install_retries: int = 2
    install_backoff: int = 2
    install_timeout: int = 8
    degrade: bool = False


@dataclasses.dataclass
class ReconfigResult:
    """The reference's ``ReconfigResult``: per-packet outcomes, per-slice
    stats over all epochs (aligned with a plain ``simulate`` run), and the
    per-epoch trace; host numpy of the reference's shapes and dtypes."""

    t_deliver: np.ndarray        # [P] slice of delivery (-1 undelivered)
    loc_final: np.ndarray        # [P]
    nhops: np.ndarray            # [P]
    delivered_bytes: np.ndarray  # [S] per slice, S = num_epochs*epoch_slices
    dropped: np.ndarray          # [S] cumulative dropped packets
    buf_bytes: np.ndarray        # [S, N]
    offl_bytes: np.ndarray       # [S, N]
    blocked_inj: np.ndarray      # [S]
    slice_miss: np.ndarray       # [S]
    reorder_cnt: np.ndarray      # scalar
    hot_src: np.ndarray          # [num_epochs, k_hot] chosen pairs (-1 none)
    hot_dst: np.ndarray          # [num_epochs, k_hot]
    demand_total: np.ndarray     # [num_epochs] pending bytes at epoch start
    epoch_conn: np.ndarray       # [num_epochs, T_e, N, U] schedule per epoch
    failed_links: np.ndarray     # [num_epochs] dead circuits at epoch start
    install_ver: np.ndarray      # [num_epochs, N] each ToR's table version at
                                 # epoch end (epoch index; -1 boot tables)
    install_lat: np.ndarray      # [num_epochs] slices to the last ack (-1 never)
    install_retries: np.ndarray  # [num_epochs] 2PC re-sends used
    degraded: np.ndarray         # [num_epochs] bool: safe tables this epoch
    telemetry: TelemetryCounters | None = None


def _validate(rcfg: ReconfigConfig) -> None:
    if rcfg.scheme not in routing_jnp.SCHEMES:
        raise ValueError(f"unknown TO scheme {rcfg.scheme!r}: expected one "
                         f"of {routing_jnp.SCHEMES}")
    if rcfg.scheduler not in topology_jnp.SCHEDULERS:
        raise ValueError(f"unknown scheduler {rcfg.scheduler!r}: expected "
                         f"one of {topology_jnp.SCHEDULERS}")
    if rcfg.install not in ("hotswap", "2pc"):
        raise ValueError(f"unknown install protocol {rcfg.install!r}: "
                         "expected 'hotswap' or '2pc'")
    if rcfg.install_retries < 0 or rcfg.install_backoff < 1 \
            or rcfg.install_timeout < 1:
        raise ValueError(
            "install_retries must be >= 0, install_backoff >= 1 and "
            f"install_timeout >= 1 (got {rcfg.install_retries}, "
            f"{rcfg.install_backoff}, {rcfg.install_timeout})")
    if rcfg.degrade and (rcfg.install != "2pc"
                         or rcfg.scheduler != "hot_slices"):
        raise ValueError(
            "degrade needs install='2pc' (a timeout to detect) and "
            "scheduler='hot_slices' (safe tables are the direct tables "
            "over the base cycle; edmonds/bvn have no base cycle)")


def _placeholder_conn(sched: Schedule, rcfg: ReconfigConfig) -> np.ndarray:
    """The epoch-0 placeholder cycle (dark where demand-derived): it fixes
    the epochs' cycle length and carries the boot and safe tables."""
    _, N, U = sched.conn.shape
    if rcfg.scheduler == "hot_slices":
        return np.concatenate(
            [sched.conn, np.full((rcfg.k_hot, N, U), -1, dtype=np.int32)])
    if rcfg.scheduler == "edmonds":
        return np.full((1, N, U), -1, dtype=np.int32)
    return np.full((rcfg.bvn_slices, N, U), -1, dtype=np.int32)


def _open_run(conn0: np.ndarray, wls, cfg, telemetry, dev):
    """The incremental run the epochs advance: the packets of the B
    scenarios (laid out as :func:`repro_torch.core.fabric.simulate_fleet`
    lays them out) and the placeholder cycle; each epoch swaps its own
    schedules and tables in."""
    _, N, _ = conn0.shape
    empty = np.full((1, N, N, 1), -1, dtype=np.int32)
    zeros = np.zeros((1, N, N, 1), dtype=np.int32)
    tables = fabric_mod.FabricTables(
        conn=conn0, tf_next=empty, tf_dep=zeros, inj_next=empty,
        inj_dep=zeros, first_direct=np.zeros(conn0.shape[:1] + (N, N),
                                              np.int32))
    B = len(wls)
    num_flows = max(fabric_mod._num_flows(w) for w in wls)
    j = fabric_mod._fleet_arrays([tables] * B, wls, None, None, num_flows,
                                 0, dev)
    return fabric_mod.FabricState(
        j=j, state=fabric_mod._init_state(j, B * num_flows), cfg=cfg,
        telemetry=telemetry, per_packet_mp=True, num_flows=B * num_flows)


def _per_node(x, B: int):
    """A table of one scenario ``[T, N, ...]`` on a sweep's node axis,
    ``[T, B·N, ...]``: the same tables for every scenario."""
    return x if B == 1 else x.repeat(1, B, *([1] * (x.dim() - 2)))


def _reconfig_loop(sched: Schedule, wls, cfg, rcfg: ReconfigConfig,
                   failures, control, telemetry, dev) -> list:
    """The epoch loop of :func:`reconfigure` for a sweep of B scenarios
    (``failures`` / ``control``: ``None`` or one mask set per scenario),
    on the sweep layout of :func:`repro_torch.core.fabric.simulate_fleet`:
    one demand measure over ``B·N²`` keys, a schedule, heal, recompile
    and install per scenario, then one ``step_slices`` window for all of
    them. :func:`reconfigure` is the sweep of one."""
    B = len(wls)
    _, N, U = sched.conn.shape
    E, K = rcfg.epoch_slices, rcfg.k_hot
    S_total = rcfg.num_epochs * E
    for f in failures or ():
        f.validate(S_total, N)
    for c in control or ():
        c.validate(S_total, N)
    if control is not None and rcfg.install_timeout > E:
        raise ValueError(
            f"install_timeout ({rcfg.install_timeout}) exceeds "
            f"epoch_slices ({E}): the controller abandons an install at "
            "the epoch boundary")
    conn0 = _placeholder_conn(sched, rcfg)
    fs = _open_run(conn0, wls, cfg, telemetry, dev)
    base_conn = fabric_mod._i32(sched.conn, dev)
    # each packet's (scenario, src, dst) key of the sweep's demand
    pair_key = (fs.j["scen"].to(torch.int64) * N + fs.j["src"]) * N \
        + fs.j["dst"]
    keys = torch.arange(N * N, device=dev)
    offdiag = (keys // N) != (keys % N)
    compile_ = lambda c: routing_jnp.compile_tables(
        c, rcfg.scheme, max_hop=rcfg.max_hop, kpaths=rcfg.kpaths)
    if control is not None:
        # boot tables: until its first install lands, every ToR runs tables
        # compiled over the placeholder cycle (version -1), in every
        # scenario
        conn0_d = fabric_mod._i32(conn0, dev)
        boot = compile_(conn0_d)
        cur = [_per_node(x, B) for x in boot]   # [Tr, B·N, N, K] each
        ver = np.full(B * N, -1, np.int64)
        if rcfg.degrade:
            # safe mode: direct tables over the placeholder cycle, padded
            # to the scheme's slot counts
            sn, sd = routing_jnp.direct_tables(conn0_d)
            safe = [_per_node(fabric_mod._pad_k(a, c.shape[-1], fill), B)
                    for a, c, fill in zip((sn, sd, sn, sd), boot,
                                          (-1, 0, -1, 0))]

    hist = {k: [] for k in ("hot_src", "hot_dst", "demand_total",
                            "epoch_conn", "failed_links", "install_ver",
                            "install_lat", "install_retries", "degraded")}
    for e in range(rcfg.num_epochs):
        t0 = e * E
        s = fs.state
        # 1. measure: pending bytes per (scenario, src, dst) from the live
        # state
        rem = (s["t_del"] < 0) & (s["loc"] != fabric_mod.DROPPED)
        pend = torch.where(rem, fs.j["size"], 0)
        demand = torch.zeros(B * N * N, dtype=_I32, device=dev).index_add_(
            0, pair_key, pend).view(B, N * N)

        # 2. re-derive each scenario's schedule from its measured demand
        hot_src = torch.full((B, K), -1, dtype=_I32, device=dev)
        hot_dst = hot_src.clone()
        if rcfg.scheduler == "edmonds":
            conn_e = torch.stack([topology_jnp.edmonds_conn(
                d.reshape(N, N).to(torch.float32), n_uplinks=U)
                for d in demand])
        elif rcfg.scheduler == "bvn":
            # uplink 0 carries the permutations, extra uplinks stay dark
            conn_e = torch.stack([topology_jnp.bvn_conn(
                d.reshape(N, N).to(torch.float32),
                num_slices=rcfg.bvn_slices, max_perms=rcfg.bvn_perms,
                sinkhorn_iters=rcfg.sinkhorn_iters) for d in demand])
            if U > 1:
                conn_e = torch.cat([conn_e, torch.full(
                    (B, rcfg.bvn_slices, N, U - 1), -1, dtype=_I32,
                    device=dev)], dim=3)
        elif K > 0:
            # the top-K pairs of each scenario (ties to the lower index, as
            # lax.top_k) get dedicated bidirectional circuits in the
            # appended slices: one stable sort per row
            order = torch.sort(torch.where(offdiag, demand, -1), dim=1,
                               descending=True, stable=True)
            vals, idx = order.values[:, :K], order.indices[:, :K]
            hs, hd = (idx // N).to(_I32), (idx % N).to(_I32)
            ok = vals > 0
            hot_src = torch.where(ok, hs, -1)
            hot_dst = torch.where(ok, hd, -1)
            bi = torch.arange(B, device=dev)[:, None]
            srows = torch.arange(K, device=dev)[None, :]
            extra = torch.full((B, K, N, U), -1, dtype=_I32, device=dev)
            extra[bi, srows, hs.clamp(0, N - 1).long(), 0] = hot_dst
            extra[bi, srows, hd.clamp(0, N - 1).long(), 0] = hot_src
            conn_e = torch.cat([base_conn.expand(B, -1, -1, -1), extra],
                               dim=1)
        else:
            conn_e = base_conn.expand(B, -1, -1, -1)

        # 2b. detect -> repair: each scenario's failure state at the
        # epoch's first slice
        n_failed = torch.zeros((B,), dtype=_I32, device=dev)
        if failures is not None:
            alive = torch.stack([torch.as_tensor(f.link_cap[t0], device=dev)
                                 for f in failures]) > 0.0
            n_failed = (~alive & offdiag.view(N, N)).sum((1, 2)).to(_I32)
            if rcfg.heal:
                conn_e = torch.stack([surviving_conn(c, ~a)
                                      for c, a in zip(conn_e, alive)])

        # 3. recompile each scenario's time-flow tables on the device, and
        # lay them on the sweep's node axis
        per = [compile_(c) for c in conn_e]
        new = [fabric_mod._stack_nodes([p[i] for p in per])
               for i in range(4)]
        fs.j.update(
            conn=fabric_mod._stack_nodes(list(conn_e)), tf_next=new[0],
            tf_dep=new[1], inj_next=new[2], inj_dep=new[3],
            first_direct=fabric_mod._stack_nodes(
                [routing_jnp.first_direct_offsets(c) for c in conn_e]))
        win = [fabric_mod._mask_window(
            None if failures is None else failures[b],
            None if control is None else control[b], t0, t0 + E)
            for b in range(B)]
        fw = None if failures is None else [w[0] for w in win]
        cw = None if control is None else [w[1] for w in win]

        # 4. swap the tables in and run the epoch
        if control is None:
            # atomic swap: this epoch's tables are live from its first slice
            fabric_mod.step_slices(fs, E, fw, None)
            install_ver = np.full((B, N), e, np.int64)
            lat, retries, degraded = [0] * B, [0] * B, [False] * B
        else:
            # 4a. each scenario's versioned install against its trace (host
            # numpy, a few values an epoch): attempt k is sent at t0 + k *
            # backoff; 2PC flips every ToR at the last ack if all acked in
            # time, hotswap each ToR at its own ack
            tis = t0 + np.arange(E, dtype=np.int64)
            switch, vsels, lat, retries, degraded = [], [], [], [], []
            for c in control:
                if rcfg.install == "2pc":
                    info = install_schedule(c, t0, rcfg.install_retries,
                                            rcfg.install_backoff,
                                            rcfg.install_timeout)
                    success = info["success"]
                    retries.append(info["retries_used"])
                    switch_t = np.full(N, info["act"] if success
                                       else INT_INF)
                else:
                    info = install_schedule(c, t0,
                                            backoff=rcfg.install_backoff)
                    success = info["act"] < INT_INF
                    retries.append(0)
                    switch_t = info["arr"]
                lat.append(info["act"] - t0 if success else -1)
                # 4b. the version each ToR reads each slice: 0 = old, 1 =
                # new, 2 = safe
                vs = (tis[:, None] >= switch_t[None, :]).astype(np.int32)
                degr = False
                if rcfg.degrade:
                    skew_any = bool(np.asarray(c.skew_miss)[t0:t0 + E].any())
                    t_degr = t0 if skew_any else INT_INF
                    t_degr = min(t_degr, INT_INF if success
                                 else t0 + rcfg.install_timeout)
                    vs = np.where(tis[:, None] >= t_degr, 2, vs).astype(
                        np.int32)
                    degr = t_degr < INT_INF
                degraded.append(degr)
                switch.append(switch_t)
                vsels.append(vs)
            switch_t = np.concatenate(switch)              # [B·N]
            vsel = np.concatenate(vsels, axis=1)           # [E, B·N]
            vers = [cur, new] + ([safe] if rcfg.degrade else [])
            versions = {k: torch.stack([v[i] for v in vers])
                        for i, k in enumerate(("tf_next_v", "tf_dep_v",
                                               "inj_next_v", "inj_dep_v"))}
            versions["vsel"] = fabric_mod._i32(vsel, dev)
            fabric_mod.step_slices(fs, E, fw, cw, versions=versions)
            # 4c. ToRs that switched inside the epoch now own this epoch's
            # tables: a merge on the node axis (1) of [Tr, B·N, D, K]
            sw = switch_t <= t0 + E - 1
            swt = torch.as_tensor(sw, device=dev)[None, :, None, None]
            cur = [torch.where(swt, n, c) for c, n in zip(cur, new)]
            ver = np.where(sw, e, ver)
            install_ver = ver.reshape(B, N)

        for k, v in (("hot_src", hot_src), ("hot_dst", hot_dst),
                     ("demand_total", pend.view(B, -1).sum(1).to(_I32)),
                     ("epoch_conn", conn_e), ("failed_links", n_failed)):
            hist[k].append(v)
        hist["install_ver"].append(install_ver.astype(np.int32))
        hist["install_lat"].append(lat)
        hist["install_retries"].append(retries)
        hist["degraded"].append(degraded)

    out = fabric_mod._final_out(fs)
    epochs = {k: torch.stack(hist[k], dim=1).cpu().numpy()
              for k in ("hot_src", "hot_dst", "demand_total", "epoch_conn",
                        "failed_links")}
    epochs["install_ver"] = np.stack(hist["install_ver"], axis=1)
    for k, dt in (("install_lat", np.int32), ("install_retries", np.int32),
                  ("degraded", bool)):
        epochs[k] = np.asarray(hist[k], dt).T                 # [B, epochs]
    results = []
    for b in range(B):
        ob = fabric_mod._scenario_out(out, b, B)
        tele = counters_from_out(ob, telemetry)
        results.append(ReconfigResult(
            **ob, **{k: v[b] for k, v in epochs.items()}, telemetry=tele))
    return results


def reconfigure(sched: Schedule, wl, cfg, rcfg: ReconfigConfig,
                failures=None, control=None,
                telemetry: TelemetryConfig | None = None,
                device=None) -> ReconfigResult:
    """Run the traffic-aware reconfigure loop (see the module docstring).

    ``sched`` is the *base* cycle ``[T0, N, U]``. ``failures`` (a
    :class:`repro_torch.core.failures.FailureMasks`) and ``control`` (a
    :class:`repro_torch.core.controlplane.ControlMasks`) cover all
    ``num_epochs * epoch_slices`` slices; ``telemetry`` adds the per-ToR
    counters (``ReconfigResult.telemetry``). Runs on ``device``: CUDA by
    default, through the port's kernels; ``"cpu"`` runs their plain
    versions. Returns a :class:`ReconfigResult` of host numpy arrays,
    equal to the reference's field for field.
    """
    _validate(rcfg)
    dev = fabric_mod.resolve_device(device)
    return _reconfig_loop(sched, [wl], cfg, rcfg,
                          None if failures is None else [failures],
                          None if control is None else [control],
                          telemetry, dev)[0]


def reconfigure_fleet(sched: Schedule, wls, cfg, rcfg: ReconfigConfig,
                      failures=None, control=None,
                      telemetry: TelemetryConfig | None = None,
                      device=None) -> list[ReconfigResult]:
    """Run a sweep of reconfigure scenarios (traffic seeds, failure
    traces, control traces) through one loop, the reference's vmapped
    ``reconfigure_fleet``: each epoch measures every scenario's demand at
    once, derives, heals, recompiles and installs each scenario's tables,
    and runs one window of the fabric for all of them (the layout of
    :func:`repro_torch.core.fabric.simulate_fleet`, with versioned tables
    ``[V, Tr, B·N, N, K]`` and a version select ``[E, B·N]``). Each result
    equals :func:`reconfigure` of its scenario in every field, history
    array and counter.

    ``wls`` is a list of workloads sharing a packet count; ``failures`` /
    ``control`` are ``None`` or one mask set per scenario (presence is a
    static branch, so it must agree across the sweep: use
    ``FailureMasks.healthy`` / ``ControlMasks.perfect`` for clean
    scenarios). The base ``sched``, ``cfg``, ``rcfg``, ``telemetry`` and
    ``device`` are shared, as in :func:`reconfigure`.
    """
    _validate(rcfg)
    dev = fabric_mod.resolve_device(device)
    B = len(wls)
    if B == 0:
        return []
    if {w.num_packets for w in wls} != {wls[0].num_packets}:
        raise ValueError("fleet workloads must share a packet count, got "
                         f"{sorted({w.num_packets for w in wls})}")
    fails = list(failures) if failures is not None else [None] * B
    ctrls = list(control) if control is not None else [None] * B
    if len(fails) != B or len(ctrls) != B:
        raise ValueError(f"{len(fails)} failure / {len(ctrls)} control mask "
                         f"sets for {B} workloads")
    for name, masks in (("failures", fails), ("control", ctrls)):
        if any((m is None) != (masks[0] is None) for m in masks):
            raise ValueError(
                f"{name} presence must agree across the fleet (it is a "
                "static branch; use FailureMasks.healthy / "
                "ControlMasks.perfect for clean scenarios)")
    return _reconfig_loop(sched, wls, cfg, rcfg,
                          None if fails[0] is None else fails,
                          None if ctrls[0] is None else ctrls, telemetry,
                          dev)
