"""The traffic-aware reconfigure loop in PyTorch: the port of
``repro.core.reconfigure`` (``reconfigure_fleet`` is not ported yet:
ROADMAP Queue 1 item 9).

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
from .telemetry import TelemetryConfig, TelemetryCounters
from .topology import Schedule

__all__ = ["ReconfigConfig", "ReconfigResult", "reconfigure"]

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


def _open_run(conn0: np.ndarray, wl, cfg, telemetry, dev):
    """The incremental run the epochs advance: the packets and the
    placeholder cycle; each epoch swaps its own schedule and tables in."""
    _, N, _ = conn0.shape
    empty = np.full((1, N, N, 1), -1, dtype=np.int32)
    zeros = np.zeros((1, N, N, 1), dtype=np.int32)
    tables = fabric_mod.FabricTables(
        conn=conn0, tf_next=empty, tf_dep=zeros, inj_next=empty,
        inj_dep=zeros, first_direct=np.zeros(conn0.shape[:1] + (N, N),
                                              np.int32))
    return fabric_mod.init_state(tables, wl, cfg, telemetry, device=dev)


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
    _, N, U = sched.conn.shape
    E, K = rcfg.epoch_slices, rcfg.k_hot
    S_total = rcfg.num_epochs * E
    if failures is not None:
        failures.validate(S_total, N)
    if control is not None:
        control.validate(S_total, N)
        if rcfg.install_timeout > E:
            raise ValueError(
                f"install_timeout ({rcfg.install_timeout}) exceeds "
                f"epoch_slices ({E}): the controller abandons an install at "
                "the epoch boundary")
    conn0 = _placeholder_conn(sched, rcfg)
    fs = _open_run(conn0, wl, cfg, telemetry, dev)
    base_conn = fabric_mod._i32(sched.conn, dev)
    pair_key = (fs.j["src"].to(torch.int64) * N + fs.j["dst"])
    keys = torch.arange(N * N, device=dev)
    offdiag = (keys // N) != (keys % N)
    compile_ = lambda c: routing_jnp.compile_tables(
        c, rcfg.scheme, max_hop=rcfg.max_hop, kpaths=rcfg.kpaths)
    if control is not None:
        # boot tables: until its first install lands, every ToR runs tables
        # compiled over the placeholder cycle (version -1)
        conn0_d = fabric_mod._i32(conn0, dev)
        cur = list(compile_(conn0_d))          # tf_next, tf_dep, inj_*
        ver = np.full(N, -1, np.int64)
        if rcfg.degrade:
            # safe mode: direct tables over the placeholder cycle, padded
            # to the scheme's slot counts
            sn, sd = routing_jnp.direct_tables(conn0_d)
            safe = [fabric_mod._pad_k(a, c.shape[-1], fill)
                    for a, c, fill in zip((sn, sd, sn, sd), cur,
                                          (-1, 0, -1, 0))]

    hist = {k: [] for k in ("hot_src", "hot_dst", "demand_total",
                            "epoch_conn", "failed_links", "install_ver",
                            "install_lat", "install_retries", "degraded")}
    for e in range(rcfg.num_epochs):
        t0 = e * E
        s = fs.state
        # 1. measure: pending bytes per (src, dst) from the live state
        rem = (s["t_del"] < 0) & (s["loc"] != fabric_mod.DROPPED)
        pend = torch.where(rem, fs.j["size"], 0)
        demand = torch.zeros(N * N, dtype=_I32, device=dev).index_add_(
            0, pair_key, pend)

        # 2. re-derive the schedule from the measured demand
        hot_src = torch.full((K,), -1, dtype=_I32, device=dev)
        hot_dst = hot_src.clone()
        if rcfg.scheduler == "edmonds":
            conn_e = topology_jnp.edmonds_conn(
                demand.reshape(N, N).to(torch.float32), n_uplinks=U)
        elif rcfg.scheduler == "bvn":
            # uplink 0 carries the permutations, extra uplinks stay dark
            conn_e = topology_jnp.bvn_conn(
                demand.reshape(N, N).to(torch.float32),
                num_slices=rcfg.bvn_slices, max_perms=rcfg.bvn_perms,
                sinkhorn_iters=rcfg.sinkhorn_iters)
            if U > 1:
                conn_e = torch.cat([conn_e, torch.full(
                    (rcfg.bvn_slices, N, U - 1), -1, dtype=_I32,
                    device=dev)], dim=2)
        elif K > 0:
            # the top-K pairs (ties to the lower index, as lax.top_k) get
            # dedicated bidirectional circuits in the appended slices
            order = torch.sort(torch.where(offdiag, demand, -1),
                               descending=True, stable=True)
            vals, idx = order.values[:K], order.indices[:K]
            hs, hd = (idx // N).to(_I32), (idx % N).to(_I32)
            ok = vals > 0
            hot_src = torch.where(ok, hs, -1)
            hot_dst = torch.where(ok, hd, -1)
            srows = torch.arange(K, device=dev)
            extra = torch.full((K, N, U), -1, dtype=_I32, device=dev)
            extra[srows, hs.clamp(0, N - 1).long(), 0] = hot_dst
            extra[srows, hd.clamp(0, N - 1).long(), 0] = hot_src
            conn_e = torch.cat([base_conn, extra])
        else:
            conn_e = base_conn

        # 2b. detect -> repair: the failure state at the epoch's first slice
        n_failed = torch.zeros((), dtype=_I32, device=dev)
        if failures is not None:
            alive = torch.as_tensor(failures.link_cap[t0], device=dev) > 0.0
            n_failed = (~alive & offdiag.view(N, N)).sum().to(_I32)
            if rcfg.heal:
                conn_e = surviving_conn(conn_e, ~alive)

        # 3. recompile the time-flow tables on the device
        new = compile_(conn_e)
        fs.j.update(conn=conn_e, tf_next=new[0], tf_dep=new[1],
                    inj_next=new[2], inj_dep=new[3],
                    first_direct=routing_jnp.first_direct_offsets(conn_e))
        fw, cw = fabric_mod._mask_window(failures, control, t0, t0 + E)

        # 4. swap the tables in and run the epoch
        if control is None:
            # atomic swap: this epoch's tables are live from its first slice
            fabric_mod.step_slices(fs, E, fw, None)
            install_ver = np.full(N, e, np.int64)
            lat, retries, degraded = 0, 0, False
        else:
            # 4a. the versioned install against the trace (host numpy, a
            # few values an epoch): attempt k is sent at t0 + k * backoff;
            # 2PC flips every ToR at the last ack if all acked in time,
            # hotswap each ToR at its own ack
            if rcfg.install == "2pc":
                info = install_schedule(control, t0, rcfg.install_retries,
                                        rcfg.install_backoff,
                                        rcfg.install_timeout)
                success, retries = info["success"], info["retries_used"]
                switch_t = np.full(N, info["act"] if success else INT_INF)
            else:
                info = install_schedule(control, t0,
                                        backoff=rcfg.install_backoff)
                success, retries = info["act"] < INT_INF, 0
                switch_t = info["arr"]
            lat = info["act"] - t0 if success else -1
            # 4b. the version each ToR reads each slice: 0 = old, 1 = new,
            # 2 = safe
            tis = t0 + np.arange(E, dtype=np.int64)
            vsel = (tis[:, None] >= switch_t[None, :]).astype(np.int32)
            degraded = False
            if rcfg.degrade:
                skew_any = bool(np.asarray(control.skew_miss)[t0:t0 + E].any())
                t_degr = t0 if skew_any else INT_INF
                t_degr = min(t_degr, INT_INF if success
                             else t0 + rcfg.install_timeout)
                vsel = np.where(tis[:, None] >= t_degr, 2, vsel).astype(
                    np.int32)
                degraded = t_degr < INT_INF
            vers = [cur, new] + ([safe] if rcfg.degrade else [])
            versions = {k: torch.stack([v[i] for v in vers])
                        for i, k in enumerate(("tf_next_v", "tf_dep_v",
                                               "inj_next_v", "inj_dep_v"))}
            versions["vsel"] = fabric_mod._i32(vsel, dev)
            fabric_mod.step_slices(fs, E, fw, cw, versions=versions)
            # 4c. ToRs that switched inside the epoch now own this epoch's
            # tables: a merge on the node axis (1) of [Tr, N, D, K]
            sw = switch_t <= t0 + E - 1
            swt = torch.as_tensor(sw, device=dev)[None, :, None, None]
            cur = [torch.where(swt, n, c) for c, n in zip(cur, new)]
            ver = np.where(sw, e, ver)
            install_ver = ver

        for k, v in (("hot_src", hot_src), ("hot_dst", hot_dst),
                     ("demand_total", pend.sum().to(_I32)),
                     ("epoch_conn", conn_e), ("failed_links", n_failed)):
            hist[k].append(v)
        hist["install_ver"].append(install_ver.astype(np.int32))
        hist["install_lat"].append(lat)
        hist["install_retries"].append(retries)
        hist["degraded"].append(degraded)

    res = fabric_mod.finalize(fs)
    out = {f.name: getattr(res, f.name)
           for f in dataclasses.fields(res) if f.name != "telemetry"}
    for k in ("hot_src", "hot_dst", "demand_total", "epoch_conn",
              "failed_links"):
        out[k] = torch.stack(hist[k]).cpu().numpy()
    out["install_ver"] = np.stack(hist["install_ver"])
    out["install_lat"] = np.asarray(hist["install_lat"], np.int32)
    out["install_retries"] = np.asarray(hist["install_retries"], np.int32)
    out["degraded"] = np.asarray(hist["degraded"], bool)
    return ReconfigResult(**out, telemetry=res.telemetry)
