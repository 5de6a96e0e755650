"""Routing APIs (paper §4.2, Table 1 "Routing" rows) and the compiler from
paths to time-flow tables (``deploy_routing``), PyTorch port.

TA algorithms (``direct``, ``ecmp``, ``wcmp``, ``ksp``) operate on a single
topology instance (``Schedule.num_slices == 1``); TO algorithms (``vlb``,
``opera``, ``ucmp``, ``hoho``) operate across time slices on the cyclic
optical schedule. All of them compile to the same :class:`CompiledRouting`
per-hop time-flow tables (paper §3), the dense lowering of Fig. 3:

    match  (arrival slice mod T, dst)                      [+ hash for multipath]
    action (egress peer = next hop, departure-slice offset)

``inj_*`` tables are the *injection* (host/source) tables and ``tf_*`` the
transit (switch) tables — the host/ToR split of the paper's testbed; VLB
sprays at injection and runs direct-circuit at transit.

Compile pipeline (hot path, vectorized for 108-ToR-and-beyond scale)
--------------------------------------------------------------------
The TO compilers never iterate per (slice, node, destination) in Python:

1. ``_time_dp_all`` runs the backward time-expanded DP for *all* destinations
   at once — the cost tensor is ``[H+1, N, D]`` (horizon H = 2T so waits may
   wrap the cyclic schedule) and each DP sweep step is one batched gather +
   minimum over the uplink axis.
2. ``_dp_tables`` collects the equal-cost departure options (UCMP slots)
   without per-entry while-walks: because waiting is free, ``cost`` is
   non-decreasing in t, so the wait-chain from any start slice is exactly the
   *run* of equal cost values along the time axis. Every (slice, uplink)
   "match" event is enumerated once with ``np.nonzero``, ranked inside its
   run by cumulative-sum arithmetic, and scattered into the k-slot tables for
   every start slice it serves.
3. ``direct``/``first_direct_offsets`` reduce "wait for the next circuit" to
   a reversed ``minimum.accumulate`` (suffix-min) over a doubled schedule
   cycle; ``opera`` runs a batched all-destination Bellman/BFS over ``conn``
   instead of per-slice networkx searches.
4. The TA compilers (``ecmp``/``wcmp``/``ksp``) are batched the same way:
   all-pairs Bellman-round distance tensors over the ``[N, N]`` instance
   adjacency replace the per-pair networkx searches (this module no longer
   imports networkx at all).

Host compilation only
---------------------
This is the PyTorch port's copy of ``repro.core.routing``. Only the numpy
path is carried over: the tables stay host numpy arrays, as in the
reference, and ``compile_impl="jnp"`` raises ``NotImplementedError``.

Parity with ``repro.core.routing``, array for array, is held by
``tests/test_torch_host.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .topology import Schedule

__all__ = [
    "CompiledRouting",
    "direct",
    "vlb",
    "opera",
    "ucmp",
    "hoho",
    "ecmp",
    "wcmp",
    "ksp",
    "neighbors",
    "earliest_path",
    "add_entry",
    "first_direct_offsets",
]

INF = np.int64(1 << 40)


@dataclasses.dataclass
class CompiledRouting:
    """Dense time-flow tables — the common compile target of every routing
    scheme (paper §3) and the exact format :func:`repro_torch.core.fabric.simulate`
    executes.

    All four tables share the shape ``[T, N, D, k]``: schedule slice ``T``
    (``T == 1`` for TA schemes, where the time match is wildcarded), node
    ``N``, destination ``D == N``, multipath slot ``k``. Valid slots are
    contiguous from slot 0; the fabric picks one by hashing the packet (or
    flow) id over the valid count.

    tf_next[t, n, d, k]: egress peer for a packet at node n, arrival slice t,
        destination d, multipath slot k (-1 = invalid slot; peer id ``N``
        means the electrical egress of hybrid fabrics).
    tf_dep[t, n, d, k]: departure-slice *offset* (0 = leave in this slice,
        matching Fig. 3 where dep==arr; >0 = buffer in the calendar queue for
        that many slices).
    inj_next / inj_dep: same, consulted only for the packet's first hop
        (the host/ToR split of the paper's testbed — e.g. VLB sprays at
        injection and runs direct-circuit at transit).
    multipath: "packet" (hash per packet) or "flow" (hash per flow id).
    lookup: "hop" (per-hop tables) or "source" (documented alias; see
        :meth:`repro_torch.core.net.OpenOpticsNet.deploy_routing`).
    weights: optional WCMP weights aligned with the k axis (else uniform).
    """

    tf_next: np.ndarray
    tf_dep: np.ndarray
    inj_next: np.ndarray
    inj_dep: np.ndarray
    multipath: str = "packet"
    lookup: str = "hop"
    weights: np.ndarray | None = None

    @property
    def num_slices(self) -> int:
        return int(self.tf_next.shape[0])

    @property
    def k(self) -> int:
        return int(self.tf_next.shape[3])

    def is_flow_table(self) -> bool:
        """Backward compatibility (paper §3): with T == 1 and all departure
        offsets 0, the time-flow table *is* a classical flow table."""
        return self.num_slices == 1 and bool(np.all(self.tf_dep[self.tf_next >= 0] == 0))


def add_entry(r: CompiledRouting, node: int, dst: int, egress: int,
              arr_ts: int | None = None, dep_ts: int | None = None,
              slot: int = 0, injection: bool = False) -> bool:
    """Paper API ``add(Entry<arr_ts,src,dst,dep_ts>, node)`` — direct table
    manipulation, e.g. for debugging. ``arr_ts=None``/``dep_ts=None`` are
    wildcards (flow-table behaviour)."""
    nxt, dep = (r.inj_next, r.inj_dep) if injection else (r.tf_next, r.tf_dep)
    ts_range = range(r.num_slices) if arr_ts is None else [arr_ts % r.num_slices]
    for t in ts_range:
        off = 0 if dep_ts is None else (dep_ts - t) % max(r.num_slices, 1)
        nxt[t, node, dst, slot] = egress
        dep[t, node, dst, slot] = off
    return True


# ---------------------------------------------------------------------------
# Helpers (paper Table 1)
# ---------------------------------------------------------------------------

def neighbors(sched: Schedule, node: int, ts: int | None) -> np.ndarray:
    """All nodes having a direct circuit from ``node`` in slice ``ts``
    (``ts=None``: in any slice — the TA single-instance case)."""
    if ts is None:
        row = sched.conn[:, node, :]
    else:
        row = sched.conn[ts % sched.num_slices, node]
    return np.unique(row[row >= 0])


def earliest_path(sched: Schedule, src: int, dst: int, ts: int,
                  max_hop: int = 4) -> list[tuple[int, int]]:
    """Earliest-arrival path from ``src`` (at slice ``ts``) to ``dst``: a list
    of (next_node, departure_slice) hops. Shortest-path routing on one
    topology is the special case ``num_slices == 1``."""
    cost, _ = _time_dp(sched, dst, max_hop)
    B = _dp_B(sched, max_hop)
    T = sched.num_slices
    path, node, t = [], src, ts % T
    guard = 0
    while node != dst and guard < 4 * T * max_hop:
        guard += 1
        step = _best_step(sched, cost, B, dst, node, t)
        if step is None:
            return []
        nxt, dep_abs = step
        path.append((int(nxt), int(dep_abs)))
        # the hop lands at the peer within dep_abs; next action is from dep_abs+1
        node, t = nxt, dep_abs + 1
    return path if node == dst else []


# ---------------------------------------------------------------------------
# Time-expanded dynamic program (shared by direct/ucmp/hoho/earliest_path)
# ---------------------------------------------------------------------------

def _time_dp(sched: Schedule, dst: int, max_hop: int):
    """Backward DP over the time-expanded graph for one destination.

    One circuit hop per slice (RotorNet/UCMP/HOHO semantics — a transmission
    occupies its slice; in-slice multi-hop is Opera's separate regime):

        cost[t, n] = min( cost[t+1, n],                      -- wait
                          1 + t*B            if peer == dst  -- deliver now
                          1 + cost[t+1, m]   otherwise )     -- hop, continue

    with the lexicographic metric arrival_slice * B + hops (earliest arrival
    first, fewest hops second). Horizon covers two schedule cycles so waits
    may wrap the cyclic schedule. ``max_hop`` only sizes B (hop counts stay
    below it for any sane schedule; the fabric enforces its own max).
    """
    T, N, U = sched.conn.shape
    H = 2 * T
    B = np.int64((max_hop + H) * (H + 2) + 1)
    cost = np.full((H + 1, N), INF, dtype=np.int64)
    cost[H, dst] = H * B
    for t in range(H - 1, -1, -1):
        c = cost[t + 1].copy()  # waiting one slice is free in hops
        conn_t = sched.conn[t % T]  # [N, U]
        for k in range(U):
            peer = conn_t[:, k]
            ok = peer >= 0
            pc = np.where(peer == dst, t * B,
                          cost[t + 1][np.clip(peer, 0, N - 1)])
            cand = np.where(ok, pc + 1, INF)
            c = np.minimum(c, cand)
        cost[t] = c
        cost[t, dst] = t * B
    return cost, H


def _dp_B(sched: Schedule, max_hop: int) -> np.int64:
    H = 2 * sched.num_slices
    return np.int64((max_hop + H) * (H + 2) + 1)


def _time_dp_all(sched: Schedule, max_hop: int):
    """Backward DP over the time-expanded graph, batched over *all*
    destinations: ``cost[t, n, d]`` with the same recurrence and metric as
    :func:`_time_dp`. Each sweep step is one gather + minimum per uplink."""
    T, N, U = sched.conn.shape
    H = 2 * T
    B = _dp_B(sched, max_hop)
    diag = np.arange(N)
    cost = np.full((H + 1, N, N), INF, dtype=np.int64)
    cost[H, diag, diag] = H * B
    for t in range(H - 1, -1, -1):
        c = cost[t + 1].copy()  # waiting one slice is free in hops
        nxt = cost[t + 1]
        conn_t = sched.conn[t % T]  # [N, U]
        for k in range(U):
            peer = conn_t[:, k]
            ok = peer >= 0
            pc = nxt[np.clip(peer, 0, N - 1)]            # [N, D]
            pc = np.where(peer[:, None] == diag[None, :], t * B, pc)
            cand = np.where(ok[:, None], pc + 1, INF)
            np.minimum(c, cand, out=c)
        cost[t] = c
        cost[t, diag, diag] = t * B
    return cost, H


def _hop_matches(sched: Schedule, cost, B, dst: int, n: int, tt: int,
                 target_cost) -> list[int]:
    """Peers m such that departing n -> m in slice tt achieves target_cost."""
    T = sched.num_slices
    out = []
    for k in range(sched.num_uplinks):
        m = sched.conn[tt % T, n, k]
        if m < 0:
            continue
        val = (tt * B if m == dst else cost[tt + 1, m]) + 1
        if val == target_cost and m not in out:
            out.append(int(m))
    return out


def _best_step(sched: Schedule, cost, B, dst: int, node: int, t: int):
    """Walk wait-links from (node, t) to the first slice where hopping attains
    the optimal cost. Returns (next_node, departure_slice) or None."""
    H = cost.shape[0] - 1
    c_opt = cost[t, node]
    if c_opt >= INF:
        return None
    tt = t
    while tt < H:
        ms = _hop_matches(sched, cost, B, dst, node, tt, c_opt)
        if ms:
            return ms[0], tt
        if cost[tt + 1, node] == c_opt:
            tt += 1
            continue
        return None
    return None


def _dp_tables(sched: Schedule, max_hop: int, kpaths: int):
    """Compile earliest-arrival per-hop time-flow tables for every destination.

    For each (t, n, d) we fill up to ``kpaths`` (egress, dep-offset) actions
    achieving the optimal (arrival slice, hops) cost — UCMP's uniform-cost
    set; slot 0 alone is the HOHO single earliest path.

    Vectorized equal-cost slot collection: since waiting is free, ``cost`` is
    non-decreasing along t, so the wait-chain reachable from start slice t is
    the maximal *run* of equal cost values containing t. A "match event" is a
    (slice tt, uplink u) pair whose hop attains the run's optimal cost; the
    event ranked r within its run (counting (tt, u) lexicographically) fills
    slot ``r - Pex[t]`` for every start t in the run with ``Pex[t]`` events
    before it, where Pex is the run-local exclusive event count. All events
    are enumerated with one ``np.nonzero`` and scattered at once.
    """
    T, N, U = sched.conn.shape
    B = _dp_B(sched, max_hop)
    cost, H = _time_dp_all(sched, max_hop)              # [H+1, N, D]
    diag = np.arange(N)
    tts = np.arange(H)
    tf_next = np.full((T, N, N, kpaths), -1, dtype=np.int32)
    tf_dep = np.zeros((T, N, N, kpaths), dtype=np.int32)

    peer = sched.conn[tts % T]                          # [H, N, U]
    ok = peer >= 0
    dup = np.zeros_like(ok)                             # same peer, earlier uplink
    for u in range(1, U):
        for u2 in range(u):
            dup[:, :, u] |= ok[:, :, u] & (peer[:, :, u2] == peer[:, :, u])
    pclip = np.clip(peer, 0, N - 1)
    # val[tt, n, u, d] = metric of hopping n -> peer at tt, bound for dst d
    val = cost[1:][tts[:, None, None], pclip]           # cost[tt+1, peer, d]
    val = np.where(peer[..., None] == diag, (tts * B)[:, None, None, None], val)
    match = (ok & ~dup)[..., None] & (val + 1 == cost[:H, :, None, :])
    del val

    # runs of equal cost along the time axis, per (n, d) column
    c0 = cost[:H]
    newrun = np.ones((H, N, N), dtype=bool)
    newrun[1:] = c0[1:] != c0[:-1]
    run_start = np.where(newrun, tts[:, None, None], 0)
    np.maximum.accumulate(run_start, axis=0, out=run_start)

    M = match.sum(axis=2, dtype=np.int64)               # events per slice [H, N, D]
    Gex = np.cumsum(M, axis=0) - M                      # exclusive, per column
    Gex_start = np.take_along_axis(Gex, run_start, axis=0)

    # events sorted by (n, d, tt, u): nonzero on the transposed tensor
    n_e, d_e, tt_e, u_e = np.nonzero(match.transpose(1, 3, 0, 2))
    if n_e.size == 0:
        return tf_next, tf_dep
    peer_e = peer[tt_e, n_e, u_e]
    tot = match.sum(axis=(0, 2), dtype=np.int64)        # [N, D] events per column
    colstart = (np.cumsum(tot.ravel()) - tot.ravel()).reshape(N, N)
    cs_e = colstart[n_e, d_e]
    j_e = np.arange(n_e.size) - cs_e                    # event index in column
    gst_e = Gex_start[tt_e, n_e, d_e]
    r_e = j_e - gst_e                                   # run-local event rank
    rs_e = run_start[tt_e, n_e, d_e]

    # earliest start slice this event serves with slot < kpaths: one past the
    # (r - kpaths)-th run-local event (tt_e doubles as the per-column event
    # position list, so that event's slice is a single gather away)
    thresh = r_e - kpaths + 1
    prev_idx = np.clip(cs_e + gst_e + r_e - kpaths, 0, n_e.size - 1)
    ta = np.where(thresh <= 0, rs_e, tt_e[prev_idx] + 1)
    tb = np.minimum(tt_e, T - 1)
    cnt = np.maximum(tb - ta + 1, 0)

    cum = np.cumsum(cnt)
    total = int(cum[-1])
    if total == 0:
        return tf_next, tf_dep
    eidx = np.repeat(np.arange(n_e.size), cnt)
    offs = np.arange(total) - np.repeat(cum - cnt, cnt)
    t_w = (ta[eidx] + offs).astype(np.int64)
    n_w, d_w = n_e[eidx], d_e[eidx]
    s_w = r_e[eidx] - (Gex[t_w, n_w, d_w] - gst_e[eidx])
    tf_next[t_w, n_w, d_w, s_w] = peer_e[eidx]
    tf_dep[t_w, n_w, d_w, s_w] = tt_e[eidx] - t_w
    return tf_next, tf_dep


# ---------------------------------------------------------------------------
# TO routing algorithms
# ---------------------------------------------------------------------------

def _check_compile_impl(compile_impl: str) -> None:
    """Validate the knob. The device compiler of the reference
    (``compile_impl="jnp"``, ``repro.core.routing_jnp``) is not ported yet:
    it waits for ROADMAP Queue 1 item 6."""
    if compile_impl == "jnp":
        raise NotImplementedError(
            "compile_impl='jnp' (the device-resident compiler) is not ported "
            "to repro_torch yet: ROADMAP Queue 1 item 6")
    if compile_impl != "numpy":
        raise ValueError(f"unknown compile_impl {compile_impl!r}: expected "
                         "'numpy' or 'jnp'")


def _has_circuit_grid(sched: Schedule) -> np.ndarray:
    """has[t, n, d]: a circuit n -> d is up in slice t."""
    T, N, U = sched.conn.shape
    has = np.zeros((T, N, N), dtype=bool)
    t_i, n_i, u_i = np.nonzero(sched.conn >= 0)
    has[t_i, n_i, sched.conn[t_i, n_i, u_i]] = True
    return has


def first_direct_offsets(sched: Schedule) -> np.ndarray:
    """first[t, n, d]: slices to wait at node n (from slice t) until the next
    direct circuit n -> d; -1 if the schedule never provides one. Computed as
    a suffix-minimum over a doubled schedule cycle (no per-offset search)."""
    has = _has_circuit_grid(sched)
    T = has.shape[0]
    NEVER = np.int64(1) << 30
    has2 = np.concatenate([has, has], axis=0)            # [2T, N, N]
    nxt = np.where(has2, np.arange(2 * T, dtype=np.int64)[:, None, None], NEVER)
    nxt = np.minimum.accumulate(nxt[::-1], axis=0)[::-1]
    off = nxt[:T] - np.arange(T, dtype=np.int64)[:, None, None]
    return np.where(nxt[:T] >= NEVER, -1, off).astype(np.int32)


def direct(sched: Schedule, compile_impl: str = "numpy", **_) -> CompiledRouting:
    """Direct-circuit routing: hold every packet at its source until the
    one-hop circuit to its destination appears (paper Fig. 3a).

    Args:
        sched: the optical schedule to compile against.
        compile_impl: "numpy", the host compiler ("jnp" is not
            ported yet and raises).

    Returns single-slot (k = 1) tables ``[T, N, D, 1]``; injection and
    transit tables are identical.
    """
    _check_compile_impl(compile_impl)
    T, N, U = sched.conn.shape
    fd = first_direct_offsets(sched)                     # [T, N, N]
    found = fd >= 0
    tf_next = np.where(found, np.arange(N, dtype=np.int32)[None, None, :],
                       np.int32(-1))[..., None]
    tf_dep = np.where(found, fd, 0).astype(np.int32)[..., None]
    return CompiledRouting(tf_next, tf_dep, tf_next.copy(), tf_dep.copy())


def vlb(sched: Schedule, kpaths: int = 4, compile_impl: str = "numpy",
        **_) -> CompiledRouting:
    """Valiant load balancing (RotorNet): injection sprays packets over the
    currently connected neighbours (packet-level multipath); transit nodes run
    direct-circuit routing, holding the packet for the rotor circuit to the
    destination. Direct shortcut taken when the source already sees dst.

    Args:
        sched: the optical schedule to compile against.
        kpaths: spray width — injection slots per (slice, src, dst).
        compile_impl: "numpy", the host compiler ("jnp" is not
            ported yet and raises).

    Returns ``inj_*`` spray tables ``[T, N, D, kpaths]`` over k = 1 transit
    direct-circuit tables, with per-packet multipath hashing.
    """
    _check_compile_impl(compile_impl)
    base = direct(sched)
    T, N, U = sched.conn.shape
    diag = np.arange(N)
    inj_next = np.full((T, N, N, kpaths), -1, dtype=np.int32)
    inj_dep = np.zeros((T, N, N, kpaths), dtype=np.int32)
    peer = sched.conn                                    # [T, N, U]
    ok = peer >= 0
    is_peer = _has_circuit_grid(sched)                   # [T, N, D]
    nd_ok = diag[:, None] != diag[None, :]               # n != d
    # spray slots: current peers != d in uplink order (duplicates kept, as in
    # the packet-spraying list); exclusive cumsum ranks them per (t, n, d)
    validu = ok[:, :, :, None] & (peer[:, :, :, None] != diag) \
        & nd_ok[None, :, None, :]
    rank = np.cumsum(validu, axis=2) - validu
    sel = validu & (rank < kpaths) & ~is_peer[:, :, None, :]
    t_i, n_i, u_i, d_i = np.nonzero(sel)
    inj_next[t_i, n_i, d_i, rank[t_i, n_i, u_i, d_i]] = peer[t_i, n_i, u_i]
    # direct shortcut: d is a current peer -> single slot straight to d
    t_i, n_i, d_i = np.nonzero(is_peer & nd_ok[None])
    inj_next[t_i, n_i, d_i, 0] = d_i
    return CompiledRouting(base.tf_next, base.tf_dep, inj_next, inj_dep,
                           multipath="packet")


def opera(sched: Schedule, max_hop: int = 4, compile_impl: str = "numpy",
          **_) -> CompiledRouting:
    """Opera: within each slice the (expander) topology is treated as static
    and packets ride multi-hop shortest paths that complete in-slice
    (departure offset 0 on every hop).

    Args:
        sched: the optical schedule to compile against.
        max_hop: in-slice path-length bound for the batched BFS; pairs
            farther apart fall back to waiting for a direct circuit.
        compile_impl: "numpy", the host compiler ("jnp" is not
            ported yet and raises).

    Returns single-slot (k = 1) tables ``[T, N, D, 1]``.
    """
    _check_compile_impl(compile_impl)
    T, N, U = sched.conn.shape
    tf_next = np.full((T, N, N, 1), -1, dtype=np.int32)
    tf_dep = np.zeros((T, N, N, 1), dtype=np.int32)
    diag = np.arange(N)
    rows = diag[:, None]
    BIG = np.int32(1 << 20)
    for t in range(T):
        peer = sched.conn[t]                             # [N, U]
        ok = peer >= 0
        pclip = np.clip(peer, 0, N - 1)
        # batched multi-destination BFS: max_hop synchronous Bellman rounds
        # give exact distances <= max_hop (farther pairs stay at BIG)
        dist = np.full((N, N), BIG, np.int32)            # dist[n, d]
        dist[diag, diag] = 0
        for _ in range(max_hop):
            nd = np.where(ok[:, :, None], dist[pclip], BIG)   # [N, U, D]
            np.minimum(dist, 1 + nd.min(axis=1), out=dist)
        # next hop: first uplink whose peer is one step closer to d
        nd = np.where(ok[:, :, None], dist[pclip], BIG)
        good = nd == (dist[:, None, :] - 1)
        usable = (dist > 0) & (dist <= max_hop) & good.any(axis=1)
        first_u = np.argmax(good, axis=1)                # [N, D]
        tf_next[t, :, :, 0] = np.where(usable, peer[rows, first_u], -1)
    # Unreachable-in-slice pairs fall back to waiting for a direct circuit.
    fallback = direct(sched)
    missing = tf_next[:, :, :, 0] < 0
    tf_next[:, :, :, 0] = np.where(missing, fallback.tf_next[:, :, :, 0], tf_next[:, :, :, 0])
    tf_dep[:, :, :, 0] = np.where(missing, fallback.tf_dep[:, :, :, 0], tf_dep[:, :, :, 0])
    return CompiledRouting(tf_next, tf_dep, tf_next.copy(), tf_dep.copy())


def ucmp(sched: Schedule, max_hop: int = 4, kpaths: int = 4,
         compile_impl: str = "numpy", **_) -> CompiledRouting:
    """UCMP: uniform-cost multi-path across time — all departure options whose
    arrival slice equals the earliest achievable are load-balanced per packet.

    Args:
        sched: the optical schedule to compile against.
        max_hop: sizes the DP's lexicographic metric base (hop counts stay
            below it for any sane schedule; the fabric enforces its own max).
        kpaths: equal-cost slots kept per (slice, node, dst).
        compile_impl: "numpy", the host compiler ("jnp" is not
            ported yet and raises).

    Returns ``[T, N, D, kpaths]`` tables with per-packet multipath hashing;
    injection and transit tables are identical.
    """
    _check_compile_impl(compile_impl)
    tf_next, tf_dep = _dp_tables(sched, max_hop, kpaths)
    return CompiledRouting(tf_next, tf_dep, tf_next.copy(), tf_dep.copy(),
                           multipath="packet")


def hoho(sched: Schedule, max_hop: int = 4, compile_impl: str = "numpy",
         **_) -> CompiledRouting:
    """Hop-On Hop-Off: the single earliest-arrival (then fewest-hop) path —
    slot 0 of the UCMP table.

    Args:
        sched: the optical schedule to compile against.
        max_hop: sizes the DP's lexicographic metric base.
        compile_impl: "numpy", the host compiler ("jnp" is not
            ported yet and raises).

    Returns single-slot (k = 1) tables ``[T, N, D, 1]``.
    """
    _check_compile_impl(compile_impl)
    tf_next, tf_dep = _dp_tables(sched, max_hop, kpaths=1)
    return CompiledRouting(tf_next, tf_dep, tf_next.copy(), tf_dep.copy())


# ---------------------------------------------------------------------------
# TA routing algorithms (single topology instance)
#
# Batched all-pairs formulation (no per-pair graph searches): all three
# compilers derive next hops from Bellman-round distance tensors over the
# [N, N] instance adjacency. ``ecmp``/``wcmp`` are bit-identical to the
# previous per-destination networkx BFS (the slot order is the uplink
# first-occurrence order, which is exactly ``DiGraph.successors``'s edge
# insertion order); ``ksp`` ranks first hops by the canonical key
# (shortest simple-path length through the hop, then uplink order). Both
# selections take the k smallest path lengths, so the selected length
# multiset always equals Yen's; the hop *sets* are identical whenever the
# k cut does not fall inside a group of equal-length hops (always true for
# U <= k), and within the selection only the order of equal-length hops is
# canonicalized — Yen's emission order there depended on networkx's
# internal BFS accidents.
# ---------------------------------------------------------------------------


def _uplink_first_occurrence(peer: np.ndarray) -> np.ndarray:
    """keep[n, u]: uplink u is the first occurrence of its (live) peer in
    node n's uplink list — the dedup rule shared by every slot collector."""
    N, U = peer.shape
    ok = peer >= 0
    dup = np.zeros((N, U), dtype=bool)
    for u in range(1, U):
        for u2 in range(u):
            dup[:, u] |= ok[:, u] & (peer[:, u2] == peer[:, u])
    return ok & ~dup


_DIST_BIG = np.int64(1 << 20)


def _all_pairs_dist(peer: np.ndarray, drop: int | None = None) -> np.ndarray:
    """dist[n, d]: BFS hop count over the instance adjacency (``_DIST_BIG``
    when unreachable), via synchronous Bellman rounds — one batched gather +
    min per round, exact after at most N-1 rounds. ``drop`` removes a node
    (no edges in or out), for simple-path lengths that must avoid a source.
    """
    N, U = peer.shape
    ok = peer >= 0
    if drop is not None:
        ok = ok & (np.arange(N)[:, None] != drop) & (peer != drop)
    pclip = np.clip(peer, 0, N - 1)
    diag = np.arange(N)
    dist = np.full((N, N), _DIST_BIG, np.int64)
    dist[diag, diag] = 0
    for _ in range(max(N - 1, 1)):
        nd = np.where(ok[:, :, None], dist[pclip], _DIST_BIG)   # [N, U, D]
        new = np.minimum(dist, 1 + nd.min(axis=1))
        if np.array_equal(new, dist):
            break
        dist = new
    if drop is not None:
        dist[drop, :] = _DIST_BIG
        dist[drop, drop] = 0
    return dist


def _scatter_slots(sel: np.ndarray, rank: np.ndarray, peer: np.ndarray,
                   kpaths: int) -> np.ndarray:
    """Scatter selected (n, u, d) hop events into contiguous multipath slots:
    the event ranked r in its (n, d) column fills ``tf_next[0, n, d, r]``."""
    N = sel.shape[0]
    tf_next = np.full((1, N, N, kpaths), -1, dtype=np.int32)
    n_i, u_i, d_i = np.nonzero(sel)
    tf_next[0, n_i, d_i, rank[n_i, u_i, d_i]] = peer[n_i, u_i]
    return tf_next


def ecmp(sched: Schedule, kpaths: int = 4, **_) -> CompiledRouting:
    """Equal-cost multi-path on one topology instance; time fields wildcarded
    (the flow-table reduction of Fig. 3c).

    Batched compile: one all-destination distance tensor, then every
    (node, uplink, dst) triple whose peer is one hop closer to dst becomes a
    slot, ranked in uplink (first-occurrence) order — bit-identical to the
    per-destination BFS + ``successors`` walk it replaces.
    """
    N = sched.num_nodes
    peer = sched.conn[0]                                    # [N, U]
    keep = _uplink_first_occurrence(peer)
    dist = _all_pairs_dist(peer)
    pclip = np.clip(peer, 0, N - 1)
    closer = dist[pclip] == dist[:, None, :] - 1            # [N, U, D]
    good = keep[:, :, None] & closer & (dist[:, None, :] < _DIST_BIG)
    rank = np.cumsum(good, axis=1) - good
    tf_next = _scatter_slots(good & (rank < kpaths), rank, peer, kpaths)
    tf_dep = np.zeros_like(tf_next)
    return CompiledRouting(tf_next, tf_dep, tf_next.copy(), tf_dep.copy(),
                           multipath="flow")


def wcmp(sched: Schedule, tm: np.ndarray | None = None, kpaths: int = 4, **_) -> CompiledRouting:
    """Weighted-cost multi-path (Jupiter): ECMP next hops weighted by the
    downstream capacity (uplink multiplicity) toward the destination."""
    r = ecmp(sched, kpaths=kpaths)
    N = sched.num_nodes
    conn0 = sched.conn[0]
    # cnt[n, m]: parallel uplinks node n points at peer m
    cnt = np.zeros((N, N), dtype=np.int64)
    n_i, u_i = np.nonzero(conn0 >= 0)
    np.add.at(cnt, (n_i, conn0[n_i, u_i]), 1)
    nxt = r.tf_next[0]                                      # [N, D, k]
    valid = nxt >= 0
    mult = cnt[np.arange(N)[:, None, None], np.clip(nxt, 0, N - 1)]
    r.weights = np.where(valid, np.maximum(mult, 1), 0)[None].astype(np.float32)
    r.multipath = "flow"
    return r


def ksp(sched: Schedule, k: int = 4, max_hop: int = 6, **_) -> CompiledRouting:
    """k-shortest-path routing (Flat-tree style): merge the first hops of the
    k shortest simple paths per pair into the multipath slots, admitting
    paths longer than the shortest when they add first-hop diversity.

    Batched compile: the shortest *simple* path from ``s`` through first hop
    ``m`` has length ``L(m) = 1 + dist(m -> d in G minus s)`` (a simple path
    never revisits its source), so the Yen enumeration's distinct first hops
    are exactly the ``m`` with ``L(m) <= max_hop``, ranked by ``L(m)``. One
    dropped-source distance tensor per source replaces the per-pair
    ``shortest_simple_paths`` generators; equal-``L`` hops rank in uplink
    order (a canonical order — Yen's emission order among equal-length
    paths followed networkx's internal BFS iteration order). Both rankings
    keep the ``k`` shortest, so the selected path-length multiset always
    equals Yen's; the hop *sets* coincide whenever the ``k`` cut does not
    split a group of equal-length hops (always true for ``U <= k``) — both
    properties asserted by the golden tests against the networkx loop.
    """
    N = sched.num_nodes
    peer = sched.conn[0]                                    # [N, U]
    U = peer.shape[1]
    keep = _uplink_first_occurrence(peer)
    pclip = np.clip(peer, 0, N - 1)
    # L[s, u, d] = 1 + dist(peer(s, u) -> d) in the graph without s
    L = np.empty((N, U, N), np.int64)
    for s_node in range(N):
        L[s_node] = 1 + _all_pairs_dist(peer, drop=s_node)[pclip[s_node]]
    diag = np.arange(N)
    good = keep[:, :, None] & (L <= max_hop)
    good[diag, :, diag] = False                             # n == d
    # rank events per (s, d) by (L, uplink): stable argsort on a fused key
    NEVER = np.int64(1) << 40
    key = np.where(good, L * U + np.arange(U, dtype=np.int64)[None, :, None],
                   NEVER)
    key_sd = key.transpose(0, 2, 1)                         # [S, D, U]
    order = np.argsort(key_sd, axis=2, kind="stable")
    sortedkey = np.take_along_axis(key_sd, order, axis=2)
    rank_sorted = np.where(sortedkey < NEVER,
                           np.arange(U, dtype=np.int64)[None, None, :], 0)
    rank_sd = np.zeros((N, N, U), dtype=np.int64)
    np.put_along_axis(rank_sd, order, rank_sorted, axis=2)
    rank = rank_sd.transpose(0, 2, 1)                       # [S, U, D]
    tf_next = _scatter_slots(good & (rank < k), rank, peer, k)
    tf_dep = np.zeros_like(tf_next)
    return CompiledRouting(tf_next, tf_dep, tf_next.copy(), tf_dep.copy(),
                           multipath="flow")
