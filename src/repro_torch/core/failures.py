"""Failure fault models and their data-plane masks, PyTorch port of the
first layer of ``repro.core.failures`` (host numpy, identical masks per
trace and seed).

**Fault models** (:class:`FailureTrace` / :func:`random_trace`) — seeded,
reproducible fault event lists: link flaps, stuck OCS ports, ToR outages,
transceiver degradation. :func:`compile_masks` lowers a trace against a
schedule into dense per-slice masks (:class:`FailureMasks`):
``link_cap[S, N, N]`` — the capacity fraction of circuit ``n -> d`` at
absolute slice ``s`` (0 = dead, 1 = healthy, in between = degraded
transceiver) — and ``node_ok[S, N]`` for ToR liveness. A ToR outage lowers
into its link row *and* column plus ``node_ok``; a stuck port lowers into
the links its uplink would carry under the schedule. The masks are plain
data-plane inputs: :func:`repro_torch.core.fabric.simulate` takes them
through its ``failures=`` argument (dead links admit nothing, so packets on
them miss their slice and re-enqueue — congestion detection then re-looks
them up, the paper's §5.2 machinery). With no masks the step is exactly
the failure-free one. :func:`surviving_conn` masks failed circuits out of
a schedule, on numpy arrays or torch tensors.

**Repair** (:func:`repair`) recompiles any scheme's tables over the
surviving adjacency, with the host compiler or, for the TO schemes, the
device compiler (``impl="jnp"``). **Fast reroute** (:func:`fast_reroute`)
patches compiled tables around a failure set without a recompile, from backup
candidates computed once per deploy (:func:`backup_tables`, or the
destination-aware :func:`backup_tables_dp`). These are host numpy, a copy
of the reference's, and give its arrays exactly. :func:`simulate_phased`
runs the fabric through consecutive tables (say, the deployed ones, a
fast-reroute patch, then a repair), carrying the packet state across each
swap on the incremental API's windows (:func:`repro_torch.core.fabric
.step_slices`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import fabric as fabric_mod
from . import routing_jnp
from .routing import (INF, CompiledRouting, _time_dp_all, direct, ecmp,
                      first_direct_offsets, hoho, ksp, opera, ucmp, vlb,
                      wcmp)
from .topology import Schedule

__all__ = [
    "OPEN_END",
    "KINDS",
    "FailureEvent",
    "FailureTrace",
    "FailureMasks",
    "random_trace",
    "compile_masks",
    "surviving_conn",
    "repair",
    "backup_tables",
    "backup_tables_dp",
    "fast_reroute",
    "simulate_phased",
    "REPAIR_SCHEMES",
]

# open-ended failures (no heal scheduled yet) end "never"
OPEN_END = 1 << 30

KINDS = ("link", "port", "tor", "degrade")

REPAIR_SCHEMES = {
    "direct": direct, "vlb": vlb, "opera": opera, "ucmp": ucmp, "hoho": hoho,
    "ecmp": ecmp, "wcmp": wcmp, "ksp": ksp,
}


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One fault: ``kind`` in ``("link", "port", "tor", "degrade")`` active
    over absolute slices ``[t_start, t_end)`` (``t_end == OPEN_END`` means
    "until healed").

    link: circuit ``node -> dst`` is dark (a link flap is two events or a
        finite window).
    port: ``node``'s OCS uplink ``uplink`` is stuck dark — the circuits it
        would carry under the schedule never come up.
    tor: ``node`` is down — all its circuits (both directions) are dark and
        its hosts can neither inject nor receive.
    degrade: transceiver degradation — circuit ``node -> dst`` keeps only a
        ``scale`` fraction of its slice capacity.
    """

    kind: str
    t_start: int
    t_end: int = OPEN_END
    node: int = -1
    dst: int = -1
    uplink: int = -1
    scale: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown failure kind {self.kind!r}: "
                             f"expected one of {KINDS}")
        if self.t_end <= self.t_start:
            raise ValueError(f"empty failure window [{self.t_start}, "
                             f"{self.t_end})")
        need = {"link": ("node", "dst"), "degrade": ("node", "dst"),
                "tor": ("node",), "port": ("node", "uplink")}[self.kind]
        for f in need:
            if getattr(self, f) < 0:
                raise ValueError(
                    f"{self.kind} failure needs {f} >= 0 "
                    f"(got {getattr(self, f)}) — a negative index would "
                    "silently darken the wrong circuit")


@dataclasses.dataclass
class FailureTrace:
    """An ordered, reproducible list of :class:`FailureEvent`\\ s with
    builder helpers (each returns ``self`` for chaining)."""

    events: list[FailureEvent] = dataclasses.field(default_factory=list)

    def link_flap(self, src: int, dst: int, t_start: int,
                  t_end: int = OPEN_END) -> "FailureTrace":
        self.events.append(FailureEvent("link", t_start, t_end,
                                        node=src, dst=dst))
        return self

    def stuck_port(self, node: int, uplink: int, t_start: int,
                   t_end: int = OPEN_END) -> "FailureTrace":
        self.events.append(FailureEvent("port", t_start, t_end,
                                        node=node, uplink=uplink))
        return self

    def tor_outage(self, node: int, t_start: int,
                   t_end: int = OPEN_END) -> "FailureTrace":
        self.events.append(FailureEvent("tor", t_start, t_end, node=node))
        return self

    def degrade(self, src: int, dst: int, scale: float, t_start: int,
                t_end: int = OPEN_END) -> "FailureTrace":
        if not 0.0 <= scale <= 1.0:
            raise ValueError(f"degrade scale {scale} outside [0, 1]")
        self.events.append(FailureEvent("degrade", t_start, t_end,
                                        node=src, dst=dst, scale=scale))
        return self

    def heal_all(self, t: int) -> "FailureTrace":
        """End every failure active at slice ``t`` and drop events that
        were scheduled to start later."""
        self.events = [dataclasses.replace(e, t_end=min(e.t_end, t))
                       for e in self.events if e.t_start < t]
        return self

    def active_in(self, t0: int, t1: int) -> bool:
        """Whether any event overlaps the window ``[t0, t1)`` — lets
        callers skip mask compilation (and the fabric's failure branch)
        for windows the trace cannot affect."""
        return any(e.t_start < t1 and e.t_end > t0 for e in self.events)


def random_trace(seed: int, sched: Schedule, num_slices: int,
                 n_events: int = 4, kinds: tuple[str, ...] = KINDS,
                 ) -> FailureTrace:
    """A seeded, reproducible random fault trace against ``sched``:
    ``n_events`` events of the given ``kinds`` with windows inside
    ``[0, num_slices)`` (~half open-ended until the run's end)."""
    rng = np.random.default_rng(seed)
    N, U = sched.num_nodes, sched.num_uplinks
    tr = FailureTrace()
    for _ in range(n_events):
        kind = kinds[int(rng.integers(len(kinds)))]
        t0 = int(rng.integers(0, max(num_slices - 1, 1)))
        t1 = OPEN_END if rng.random() < 0.5 else \
            int(rng.integers(t0 + 1, num_slices + 1))
        if kind == "tor":
            tr.tor_outage(int(rng.integers(N)), t0, t1)
        elif kind == "port":
            tr.stuck_port(int(rng.integers(N)), int(rng.integers(U)), t0, t1)
        else:
            s = int(rng.integers(N))
            d = int(rng.integers(N - 1))
            d = d + 1 if d >= s else d  # never a self-link
            if kind == "link":
                tr.link_flap(s, d, t0, t1)
            else:
                tr.degrade(s, d, float(rng.uniform(0.1, 0.9)), t0, t1)
    return tr


@dataclasses.dataclass
class FailureMasks:
    """Dense per-slice failure state, the data-plane lowering of a
    :class:`FailureTrace` (see :func:`compile_masks`).

    link_cap[s, n, d]: capacity fraction of circuit ``n -> d`` at absolute
        slice ``s`` (float32; 0 = dead, 1 = healthy).
    node_ok[s, n]: ToR ``n`` is up at slice ``s`` (gates host injection and
        the electrical egress; a down ToR's links are also zeroed in
        ``link_cap``).
    """

    link_cap: np.ndarray   # [S, N, N] float32
    node_ok: np.ndarray    # [S, N] bool

    @property
    def num_slices(self) -> int:
        return int(self.link_cap.shape[0])

    @property
    def num_nodes(self) -> int:
        return int(self.link_cap.shape[1])

    @classmethod
    def healthy(cls, num_slices: int, n_nodes: int) -> "FailureMasks":
        return cls(np.ones((num_slices, n_nodes, n_nodes), np.float32),
                   np.ones((num_slices, n_nodes), bool))

    def validate(self, num_slices: int, n_nodes: int) -> None:
        if self.link_cap.shape != (num_slices, n_nodes, n_nodes) or \
                self.node_ok.shape != (num_slices, n_nodes):
            raise ValueError(
                f"failure masks shaped {self.link_cap.shape}/"
                f"{self.node_ok.shape} do not cover the run "
                f"([{num_slices}, {n_nodes}, {n_nodes}] / "
                f"[{num_slices}, {n_nodes}])")

    def failed_links(self, t: int) -> np.ndarray:
        """``[N, N]`` numpy bool: circuits dead at slice ``t`` of the masks
        — the snapshot :func:`surviving_conn` (and the reference's repair,
        fast reroute and table checker) consume."""
        dead = self.link_cap[t] <= 0.0
        return dead.cpu().numpy() if isinstance(dead, torch.Tensor) else \
            np.asarray(dead)

    def on_device(self, device) -> "FailureMasks":
        """Move the masks to ``device`` as torch tensors once, in place, and
        return ``self``: ``link_cap`` float32, ``node_ok`` bool. Idempotent
        — tensors already on ``device`` are kept, so a caller that runs the
        same masks through several simulations pays the ~``S*N*N`` float32
        transfer a single time."""
        dev = torch.device(device)
        self.link_cap = torch.as_tensor(self.link_cap, dtype=torch.float32,
                                        device=dev)
        self.node_ok = torch.as_tensor(self.node_ok, dtype=torch.bool,
                                       device=dev)
        return self


def compile_masks(trace: FailureTrace, sched: Schedule, num_slices: int,
                  t0: int = 0) -> FailureMasks:
    """Lower a fault trace into :class:`FailureMasks` covering absolute
    slices ``[t0, t0 + num_slices)`` of ``sched`` (``t0`` lets
    :meth:`repro_torch.core.net.OpenOpticsNet.run` compile the window that starts
    at its running clock).

    Events compose: overlapping degradations multiply, any dead source
    (link / port / ToR) wins over degradation. Stuck ports are resolved
    against the schedule as the fabric will run it — the fabric's scan
    index restarts at 0 every :func:`repro_torch.core.fabric.simulate` call, so
    the circuit darkened at window slice ``s`` is ``n -> conn[s % T, n,
    u]`` regardless of ``t0`` (``t0`` only shifts which *events* fall in
    the window).
    """
    T, N, U = sched.conn.shape
    S = num_slices
    m = FailureMasks.healthy(S, N)
    for e in trace.events:
        if e.node >= N or e.dst >= N or (e.kind == "port" and e.uplink >= U):
            raise ValueError(
                f"{e.kind} failure indexes outside the schedule "
                f"(node={e.node}, dst={e.dst}, uplink={e.uplink}; "
                f"N={N}, U={U})")
        a = max(e.t_start - t0, 0)
        b = min(e.t_end - t0, S)
        if b <= a:
            continue
        w = slice(a, b)
        if e.kind == "link":
            m.link_cap[w, e.node, e.dst] = 0.0
        elif e.kind == "degrade":
            m.link_cap[w, e.node, e.dst] *= e.scale
        elif e.kind == "tor":
            m.link_cap[w, e.node, :] = 0.0
            m.link_cap[w, :, e.node] = 0.0
            m.node_ok[w, e.node] = False
        else:  # port: darken the links the stuck uplink would carry
            ts = np.arange(a, b)
            peer = sched.conn[ts % T, e.node, e.uplink]
            ok = peer >= 0
            m.link_cap[ts[ok], e.node, peer[ok]] = 0.0
    return m


def surviving_conn(conn: np.ndarray, failed: np.ndarray) -> np.ndarray:
    """Mask the failed circuits out of a schedule tensor: ``conn[t, n, u]``
    goes dark wherever ``failed[n, peer]``. Works on numpy arrays and on
    torch tensors (``conn`` decides; the result has its type, dtype and
    device)."""
    N = conn.shape[1]
    if isinstance(conn, torch.Tensor):
        failed = torch.as_tensor(failed, dtype=torch.bool, device=conn.device)
        rows = torch.arange(N, device=conn.device)[None, :, None]
        peer = conn.clamp(0, N - 1).long()
        dead = (conn >= 0) & failed[rows, peer]
        return torch.where(dead, -1, conn)
    rows = np.arange(N)[None, :, None]
    peer = np.clip(conn, 0, N - 1)
    dead = (conn >= 0) & np.asarray(failed)[rows, peer]
    return np.where(dead, -1, conn)


# ---------------------------------------------------------------------------
# Repair: scheme-agnostic recompilation over the surviving adjacency
# ---------------------------------------------------------------------------

def repair(sched: Schedule, scheme: str, failed: np.ndarray,
           impl: str = "numpy", device=None, **kw) -> CompiledRouting:
    """Recompile ``scheme``'s time-flow tables over the surviving adjacency
    — the scheme-agnostic repair primitive. ``failed[n, d]`` marks dead
    circuits (e.g. :meth:`FailureMasks.failed_links`); ``kw`` is forwarded
    to the scheme compiler (``max_hop``, ``kpaths``, ...). The repaired
    tables never reference a failed link, which
    :func:`repro_torch.core.toolkit.check_tables` proves with its
    ``link_fail=`` argument.

    ``impl="numpy"`` runs the host compiler (every TO and TA scheme);
    ``impl="jnp"`` the device compiler of :mod:`.routing_jnp` (the TO
    schemes) on ``device``, CUDA unless the caller names another,
    bit-identical to the host path.
    """
    if scheme not in REPAIR_SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}: expected one of "
                         f"{tuple(REPAIR_SCHEMES)}")
    alive_sched = Schedule(np.asarray(surviving_conn(sched.conn, failed)),
                           slice_us=sched.slice_us, reconf_us=sched.reconf_us)
    if impl == "numpy":
        return REPAIR_SCHEMES[scheme](alive_sched, **kw)
    if impl != "jnp":
        raise ValueError(f"unknown impl {impl!r}: expected 'numpy' or 'jnp'")
    if scheme not in routing_jnp.SCHEMES:
        raise ValueError(f"impl='jnp' supports the TO schemes "
                         f"{routing_jnp.SCHEMES}; {scheme!r} is host-only")
    return REPAIR_SCHEMES[scheme](alive_sched, compile_impl="jnp",
                                  device=device, **kw)


# ---------------------------------------------------------------------------
# Local fast reroute: precomputed backups, patched without a recompile
# ---------------------------------------------------------------------------

def backup_tables(sched: Schedule, max_cands: int = 8):
    """Precompute backup next-hop candidates: for every (slice, node) the
    earliest upcoming circuits to up to ``max_cands`` distinct peers,
    ordered by wait offset. Returns ``(bk_next[T, N, C], bk_off[T, N, C])``
    int32 (-1 padding). Computed once per deploy so a failure can be
    patched with :func:`fast_reroute` without a recompile.
    """
    fd = first_direct_offsets(sched).astype(np.int64)    # [T, N, N]
    T, N, _ = fd.shape
    C = min(max_cands, N - 1)
    NEVER = np.int64(1) << 30
    diag = np.arange(N)
    key = np.where(fd >= 0, fd, NEVER)
    key[:, diag, diag] = NEVER                           # never detour to self
    order = np.argsort(key, axis=2, kind="stable")[:, :, :C]   # peers by wait
    off = np.take_along_axis(key, order, axis=2)
    found = off < NEVER
    bk_next = np.where(found, order, -1).astype(np.int32)
    bk_off = np.where(found, off, 0).astype(np.int32)
    return bk_next, bk_off


def backup_tables_dp(sched: Schedule, max_hop: int = 4,
                     max_cands: int = 8):
    """Destination-aware backup candidates from the time-expanded DP: for
    every (slice, node, dst) up to ``max_cands`` detour peers ranked by
    completion cost toward *that destination* (the same arrival-then-hops
    metric the DP-compiled schemes optimize, over a doubled cycle so any
    wait offset in ``[0, 2T)`` prices correctly). Returns
    ``(bk_next[T, N, D, C], bk_off[T, N, D, C])`` int32 (-1 padding).

    Costs ~``T * N^3`` host work once per deploy; :func:`fast_reroute`
    detects the extra destination axis and applies its loop-free patching
    rule (see there). Candidates unreachable toward ``d`` (the DP finds no
    continuation within the horizon) are not listed at all — a detour that
    cannot complete is worse than sticking, which the fabric handles.
    """
    conn = np.asarray(sched.conn)
    T, N, U = conn.shape
    # doubled cycle: a candidate landing as late as t + 2T - 1 still needs
    # a priced continuation, so the DP horizon must cover 4T slices
    sched2 = Schedule(np.concatenate([conn, conn], axis=0),
                      slice_us=sched.slice_us, reconf_us=sched.reconf_us)
    cost, H = _time_dp_all(sched2, max_hop)              # [H + 1, N, D]
    B = np.int64((max_hop + H) * (H + 2) + 1)            # _dp_B(sched2, ...)
    fd = first_direct_offsets(sched).astype(np.int64)    # [T, N, M]
    C = min(max_cands, N - 1)
    diag = np.arange(N)
    eye = np.eye(N, dtype=bool)
    bk_next = np.full((T, N, N, C), -1, np.int32)
    bk_off = np.zeros((T, N, N, C), np.int32)
    for t in range(T):                                   # [N, M, D] per slice
        offt = fd[t]                                     # [N, M]
        okm = offt >= 0
        okm[diag, diag] = False                          # never via self
        land = t + np.where(okm, offt, 0)                # departure slice
        # continuing from peer m after landing, toward every destination;
        # detouring straight to d delivers at the landing slice
        cont = cost[np.minimum(land + 1, H), diag[None, :], :]   # [N, M, D]
        val = np.where(eye[None, :, :], (land * B)[:, :, None], cont) + 1
        val = np.where(okm[:, :, None], val, INF)
        order = np.argsort(val, axis=1, kind="stable")[:, :C, :]  # [N, C, D]
        found = np.take_along_axis(val, order, axis=1) < INF
        offs = np.take_along_axis(
            np.broadcast_to(np.where(okm, offt, 0)[:, :, None],
                            val.shape), order, axis=1)
        bk_next[t] = np.where(found, order, -1).transpose(0, 2, 1)
        bk_off[t] = np.where(found, offs, 0).transpose(0, 2, 1)
    return bk_next, bk_off


def _clean_cells(tf_n, tf_d, N: int) -> np.ndarray:
    """``clean[t, n, d]``: walking the post-drop (pre-detour) transit
    tables from this cell delivers on every slot — the greatest fixpoint
    of "non-empty and every slot delivers or lands clean". Detours go only
    into clean landing cells, so no walk chains detours (a detour cell is
    empty before the detour, hence not clean)."""
    Tr = tf_n.shape[0]
    validk = tf_n >= 0
    d_ax = np.arange(N)[None, None, :, None]
    delivers = validk & ((tf_n == d_ax) | (tf_n >= N))
    land_t = (np.arange(Tr)[:, None, None, None] + tf_d) % Tr
    land_n = np.clip(tf_n, 0, N - 1)
    clean = validk.any(-1)
    while True:
        ok_slot = ~validk | delivers | clean[land_t, land_n, d_ax]
        nxt_clean = validk.any(-1) & ok_slot.all(-1)
        if (nxt_clean == clean).all():
            return clean
        clean = nxt_clean


def fast_reroute(routing: CompiledRouting, sched: Schedule,
                 failed: np.ndarray, backups=None) -> CompiledRouting:
    """Patch compiled tables around a failure set without recompiling.

    Per table cell (slice, node, dst): slots whose egress rides a failed
    link are dropped and the survivors compacted to the front (slot
    contiguity, which the fabric's hash-over-valid-count requires, is
    preserved). A cell that loses *all* its slots gets a one-hop detour
    from ``backups``, after which the transit tables take over:

    * destination-agnostic ``[T, N, C]`` backups (default,
      :func:`backup_tables`): the earliest surviving circuit from the
      node. Instant and always applicable, but best-effort — the detour
      can lengthen paths or loop under further failures.
    * destination-aware ``[T, N, D, C]`` backups
      (:func:`backup_tables_dp`): candidates are tried in DP cost order
      and installed only when the immediate link survives *and* the
      landing transit cell is **clean** — transitively delivering over
      surviving (post-drop, pre-detour) table entries, a greatest
      fixpoint — or the destination itself. A patched walk is then a
      surviving-entry prefix, at most one detour hop, and a clean suffix;
      for the DP-compiled schemes every walk delivers within
      ``2 * max_hop + 1`` hops or sticks — it never loops. Cells with no
      clean candidate stay empty: the fabric defers those packets (§5.2).

    Either way the patched tables never cross a failed link at any hop
    (``toolkit.check_tables(..., link_fail=failed, check_walks=False)``
    proves it). :func:`repair` is the full recompile; fast reroute is the
    instant first response.
    """
    T = sched.num_slices
    N = sched.num_nodes
    if routing.num_slices != T:
        raise ValueError(
            f"fast_reroute needs the table cycle ({routing.num_slices}) to "
            f"match the schedule cycle ({T}) so detour offsets are "
            "expressible per arrival slice")
    if backups is None:
        backups = backup_tables(sched)
    bk_next, bk_off = backups
    dest_aware = bk_next.ndim == 4
    node_idx = np.arange(N)[None, :, None, None]
    dropped = []
    for nxt, dep in ((routing.tf_next, routing.tf_dep),
                     (routing.inj_next, routing.inj_dep)):
        valid = nxt >= 0
        optical = valid & (nxt < N)
        dead = optical & failed[node_idx, np.clip(nxt, 0, N - 1)]
        ok = valid & ~dead
        # compact surviving slots to the front, preserving slot order
        order = np.argsort(~ok, axis=-1, kind="stable")
        new_n = np.take_along_axis(nxt, order, axis=-1)
        new_d = np.take_along_axis(dep, order, axis=-1)
        ok_s = np.take_along_axis(ok, order, axis=-1)
        new_n = np.where(ok_s, new_n, -1)
        new_d = np.where(ok_s, new_d, 0)
        # cells that had entries but lost every slot need a detour
        need = valid.any(-1) & ~ok.any(-1)               # [Tr, N, D]
        dropped.append((new_n, new_d, need))

    clean = _clean_cells(*dropped[0][:2], N) if dest_aware else None
    out_n, out_d = [], []
    for new_n, new_d, need in dropped:
        if need.any():
            t_i, n_i, d_i = np.nonzero(need)
            if dest_aware:
                cn = bk_next[t_i % T, n_i, d_i]          # [M, C]
                co = bk_off[t_i % T, n_i, d_i]
                cnc = np.clip(cn, 0, N - 1)
                alive = (cn >= 0) & ~failed[n_i[:, None], cnc]
                # loop-free rule: detour straight to the destination, or
                # into a clean landing cell
                good = alive & ((cn == d_i[:, None]) | clean[
                    (t_i[:, None] + co) % T, cnc, d_i[:, None]])
            else:
                cn = bk_next[t_i % T, n_i]               # [M, C]
                co = bk_off[t_i % T, n_i]
                good = (cn >= 0) & ~failed[n_i[:, None],
                                           np.clip(cn, 0, N - 1)]
            pick = np.argmax(good, axis=1)
            has = good.any(axis=1)
            mrow = np.arange(t_i.size)
            new_n[t_i, n_i, d_i, 0] = np.where(has, cn[mrow, pick], -1)
            new_d[t_i, n_i, d_i, 0] = np.where(has, co[mrow, pick], 0)
        out_n.append(new_n.astype(np.int32))
        out_d.append(new_d.astype(np.int32))
    return CompiledRouting(out_n[0], out_d[0], out_n[1], out_d[1],
                           multipath=routing.multipath, lookup=routing.lookup,
                           weights=routing.weights)


def simulate_phased(sched: Schedule, phases, wl, cfg, failures=None,
                    device=None):
    """Run the fabric through consecutive phases with different deployed
    tables, carrying the packet state across each swap — for table changes
    computed on the host (a :func:`fast_reroute` patch at failure
    detection, then a :func:`repair` recompile). Each phase is one window
    of :func:`repro_torch.core.fabric.step_slices`, with the phase's
    tables swapped into the run before it.

    ``phases`` is a list of ``(routing, num_slices)``; slices are absolute
    and consecutive, so ``failures`` (masks covering the total, indexed at
    absolute slices) line up. Runs on ``device`` (CUDA by default). With a
    single phase the result equals :func:`repro_torch.core.fabric
    .simulate`'s.
    """
    total = sum(n for _, n in phases)
    if failures is not None:
        failures.validate(total, sched.num_nodes)
    fs = None
    for routing, n in phases:
        tables = fabric_mod.FabricTables.build(sched, routing)
        if fs is None:
            fs = fabric_mod.init_state(tables, wl, cfg, device=device)
        else:
            fs.j.update(fabric_mod._table_arrays(tables, fs.device))
            fs.per_packet_mp = tables.multipath == "packet"
        fw, _ = fabric_mod._mask_window(failures, None, fs.clock,
                                        fs.clock + n)
        fabric_mod.step_slices(fs, n, failures=fw)
    return fabric_mod.finalize(fs)
