"""Educational toolkit and table checkers (paper §5.3 Mininet-analogue),
PyTorch port of ``repro.core.toolkit``: a copy in host numpy, with the same
messages, so the port's tables and results can be checked without the
reference. :func:`trace_packet` narrates a single packet's journey through
the time-flow tables, slice by slice; :func:`check_tables` and
:func:`check_tables_mixed` prove invariants of compiled tables (also after
a repair or fast reroute, and across a mixed-version install);
:func:`check_telemetry` and :func:`check_sharding` prove results.

    >>> from repro_torch.core import round_robin, hoho, toolkit
    >>> sched = round_robin(8, 1)
    >>> print(toolkit.trace_packet(sched, hoho(sched), src=0, dst=5, t0=0))
"""
from __future__ import annotations

import math

import numpy as np

from .fabric import DELIVERED, DROPPED, NOT_INJECTED
from .routing import CompiledRouting, _has_circuit_grid
from .topology import Schedule

__all__ = ["trace_packet", "format_schedule", "check_tables",
           "check_tables_mixed", "check_sharding", "check_telemetry"]


def trace_packet(sched: Schedule, routing: CompiledRouting, src: int,
                 dst: int, t0: int = 0, hashv: int = 0,
                 max_steps: int = 64) -> str:
    """Narrated per-hop walk: at each node, look up the time-flow table entry
    (arrival slice, dst) and follow its (egress, departure slice) action.

    Args:
        sched: the deployed optical schedule (used to check circuit liveness).
        routing: compiled tables; the walk starts on ``inj_*`` and switches
            to ``tf_*`` after the first hop, like the fabric.
        src / dst / t0: the packet's source, destination, injection slice.
        hashv: multipath selector — slot ``hashv % nvalid`` is followed.
        max_steps: truncation bound for tables that loop.

    The narration covers delivery, missing entries (stuck), dark circuits,
    calendar-queue buffering, and the electrical egress (peer id == N: always
    live, delivers with one-slice transit delay — fabric §5 semantics).
    """
    T = routing.num_slices
    lines = [f"packet {src} -> {dst}, injected at slice {t0}"]
    node, t, tbl_next, tbl_dep = src, t0, routing.inj_next, routing.inj_dep
    for step in range(max_steps):
        if node == dst:
            lines.append(f"  [t={t}] DELIVERED at node {dst} "
                         f"({step} hops, {t - t0} slices in fabric)")
            return "\n".join(lines)
        row_n = tbl_next[t % T, node, dst]
        row_d = tbl_dep[t % T, node, dst]
        nvalid = int((row_n >= 0).sum())
        if nvalid == 0:
            lines.append(f"  [t={t}] node {node}: NO ENTRY for dst {dst} "
                         f"at arrival slice {t % T} — packet stuck")
            return "\n".join(lines)
        slot = hashv % nvalid
        nxt, off = int(row_n[slot]), int(row_d[slot])
        entry = f"match(arr={t % T}, dst={dst}) -> (egress={nxt}, dep={t % T}+{off})"
        if off > 0:
            lines.append(f"  [t={t}] node {node}: {entry}; buffered in the "
                         f"calendar queue for slice {(t + off) % T}")
        wire_t = t + off
        live = sched.has_circuit(node, nxt, wire_t) if nxt < sched.num_nodes \
            else True
        fabric = "electrical egress" if nxt >= sched.num_nodes else \
            f"circuit {node}->{nxt}"
        lines.append(f"  [t={wire_t}] node {node}: {entry}; transmits over "
                     f"{fabric} ({'live' if live else 'DARK — would drop'})")
        if not live:
            return "\n".join(lines)
        if nxt >= sched.num_nodes:
            # electrical fabric (hybrid/Clos): always live, delivers to the
            # destination with one-slice transit delay (fabric §5 semantics)
            node, t = dst, wire_t + 1
        else:
            node, t = nxt, wire_t
        tbl_next, tbl_dep = routing.tf_next, routing.tf_dep
    lines.append("  ... trace truncated (max_steps)")
    return "\n".join(lines)


def check_tables(sched: Schedule, routing: CompiledRouting,
                 max_hops: int = 16, require_delivery: bool = False,
                 hashes: tuple[int, ...] = (0,),
                 max_steps: int = 64, link_fail: np.ndarray | None = None,
                 check_walks: bool = True,
                 t0s: "tuple[int, ...] | range | None" = None,
                 old_routing: CompiledRouting | None = None,
                 upgraded: np.ndarray | None = None) -> list[str]:
    """Time-flow invariant checker: verify a compiled routing against the
    schedule it was compiled for. Returns a list of human-readable violation
    messages (empty = all invariants hold) so tests can assert
    ``check_tables(...) == []`` and property-based sweeps get a narrated
    counterexample for free.

    Static invariants, over every table cell:

    * **slot contiguity** — valid multipath slots are contiguous from slot 0
      (the fabric hashes over the valid count);
    * **sane actions** — egress ids are in ``[0, N]`` (``N`` = electrical)
      and departure offsets are non-negative;
    * **liveness** — every entry's departure slice actually connects the hop
      under the schedule: for arrival slice ``t`` (mod the table cycle
      ``Tr``) the circuit ``n -> egress`` must be up in schedule slice
      ``(t_abs + dep) % T`` for *every* absolute slice ``t_abs ≡ t (mod
      Tr)``, i.e. for each residue of the combined ``lcm(T, Tr)`` cycle;
    * **failure avoidance** (only with ``link_fail``) — no live entry's
      egress crosses a circuit marked failed in the ``[N, N]`` bool mask
      (e.g. :meth:`repro_torch.core.failures.FailureMasks.failed_links`). This is
      the post-repair soundness proof for
      :func:`repro_torch.core.failures.repair` /
      :func:`repro_torch.core.failures.fast_reroute` output.

    Walk invariants (skipped when ``check_walks=False`` — fast-reroute
    detours are statically sound but deliberately best-effort on walks),
    for every (src, dst, t0, hash in ``hashes``) — the same walk
    :func:`trace_packet` narrates, so a violation here is reproducible with
    a one-line trace. ``t0s`` restricts the start slices swept (default:
    the full combined ``lcm(T, Tr)`` cycle); walks also never ride a
    ``link_fail``-failed circuit:

    * **time monotonicity** — delivery/departure slots never move backwards
      along a path (each hop departs at or after the packet's arrival);
    * **hop bound** — a delivered packet takes at most ``max_hops`` hops;
    * **no silent loops** — a walk that neither delivers nor sticks within
      ``max_steps`` steps is reported;
    * **delivery** (only when ``require_delivery``) — every pair's walk must
      reach its destination (schedules without full reachability should
      leave this off).

    ``hashes`` picks the multipath slot at every hop, like the fabric's
    flow-level hashing. Note that ``ksp``'s slots beyond 0 deliberately
    admit longer-than-shortest paths, and a fixed non-zero hash at every hop
    is not loop-free (true of the networkx implementation it replaced, too)
    — sweep such schemes with ``hashes=(0,)``.

    The walk sweep is vectorized over all (src, dst, t0) simultaneously
    (one batched table gather per step instead of a Python walk per pair —
    ~100x, which is what makes paper-scale 108-ToR sweeps feasible); the
    scalar reference walk is kept as :func:`_check_walk` and re-run only on
    violating walks to produce the narrated message.

    **Mixed-version mode** (``old_routing`` + ``upgraded``): model a
    versioned table install caught mid-window — ToRs with
    ``upgraded[node]`` True answer lookups from ``routing`` (the new
    tables), the rest from ``old_routing`` — and check that the blend is
    still sound. This is the soundness statement behind the reference's
    reconfigure loop's two-phase install (:mod:`.reconfigure`): any
    activation order must be safe, not just the all-at-once swap. Static
    invariants are skipped (each version passes them against its own
    schedule; the mixed hazard is *walks* crossing version boundaries),
    and a dark circuit ends the walk OK rather than violating — the
    fabric defers such packets to the next live slice (§5.2), so a stale
    entry pointing at a torn-down circuit costs latency, not correctness.
    Loops, negative departures and hop-bound breaches across the version
    boundary remain violations. Both routings must share the table cycle
    and slot width; :func:`check_tables_mixed` sweeps a canonical family
    of ``upgraded`` subsets so callers don't pick them by hand.
    """
    bad: list[str] = []
    T, N, _U = sched.conn.shape
    tf_n, tf_d = routing.tf_next, routing.tf_dep
    inj_n, inj_d = routing.inj_next, routing.inj_dep
    Tr = routing.num_slices
    if (old_routing is None) != (upgraded is None):
        raise ValueError("old_routing and upgraded must be passed together")
    if old_routing is not None:
        if old_routing.num_slices != Tr:
            raise ValueError("mixed-version check needs matching table "
                             f"cycles (old {old_routing.num_slices}, "
                             f"new {Tr})")
        if old_routing.tf_next.shape[-1] != tf_n.shape[-1]:
            raise ValueError("mixed-version check needs matching slot "
                             "widths")
        upgraded = np.asarray(upgraded, dtype=bool)
        if upgraded.shape != (N,):
            raise ValueError(f"upgraded must be a [{N}] bool mask")
        viol = _check_walks_vec(sched, routing, hashes, max_hops,
                                require_delivery, max_steps, link_fail,
                                range(math.lcm(T, Tr)) if t0s is None else t0s,
                                old_routing, upgraded)
        for src, dst, t0, hashv in viol:
            msg = _check_walk(sched, routing, src, dst, t0, hashv, max_hops,
                              require_delivery, max_steps, link_fail,
                              old_routing, upgraded)
            assert msg is not None, "vectorized walk flagged a clean scalar walk"
            bad.append("mixed " + msg)
            if len(bad) > 64:
                return bad
        return bad

    for name, nxt, dep in (("tf", tf_n, tf_d), ("inj", inj_n, inj_d)):
        valid = nxt >= 0
        # slot contiguity: once invalid, all later slots invalid
        gap = valid[..., 1:] & ~valid[..., :-1]
        for t, n, d, s in zip(*np.nonzero(gap)):
            bad.append(f"{name}: non-contiguous slot {s + 1} at "
                       f"(t={t}, node={n}, dst={d})")
        if np.any(nxt > N):
            bad.append(f"{name}: egress id beyond electrical ({N})")
        if np.any(dep[valid] < 0):
            bad.append(f"{name}: negative departure offset")
        # liveness of optical entries across the combined schedule cycle
        reps = math.lcm(T, Tr) // Tr
        t_i, n_i, d_i, s_i = np.nonzero(valid & (nxt < N))
        for rep in range(reps):
            t_abs = t_i + rep * Tr
            live = sched.conn[(t_abs + dep[t_i, n_i, d_i, s_i]) % T, n_i, :] \
                == nxt[t_i, n_i, d_i, s_i][:, None]
            for j in np.nonzero(~live.any(axis=1))[0][:8]:
                bad.append(
                    f"{name}: dark circuit {n_i[j]}->{nxt[t_i[j], n_i[j], d_i[j], s_i[j]]} "
                    f"for (arr={t_i[j]}, dst={d_i[j]}, slot={s_i[j]}) at "
                    f"abs slice {t_abs[j]} dep +{dep[t_i[j], n_i[j], d_i[j], s_i[j]]}")
        if link_fail is not None and t_i.size:
            e_i = nxt[t_i, n_i, d_i, s_i]
            hit = link_fail[n_i, e_i]
            for j in np.nonzero(hit)[0][:8]:
                bad.append(
                    f"{name}: entry rides failed link {n_i[j]}->{e_i[j]} "
                    f"for (arr={t_i[j]}, dst={d_i[j]}, slot={s_i[j]})")
        if len(bad) > 64:
            return bad

    if not check_walks:
        return bad

    cycle = math.lcm(T, Tr)
    t0s = range(cycle) if t0s is None else t0s
    viol = _check_walks_vec(sched, routing, hashes, max_hops,
                            require_delivery, max_steps, link_fail, t0s)
    for src, dst, t0, hashv in viol:
        msg = _check_walk(sched, routing, src, dst, t0, hashv, max_hops,
                          require_delivery, max_steps, link_fail)
        assert msg is not None, "vectorized walk flagged a clean scalar walk"
        bad.append(msg)
        if len(bad) > 64:
            return bad
    return bad


def check_tables_mixed(sched: Schedule, old_routing: CompiledRouting,
                       new_routing: CompiledRouting, max_hops: int = 16,
                       hashes: tuple[int, ...] = (0,), max_steps: int = 64,
                       t0s: "tuple[int, ...] | range | None" = None,
                       seed: int = 0, n_random: int = 4) -> list[str]:
    """Sweep :func:`check_tables` mixed-version mode over a canonical family
    of ``upgraded`` subsets: the two pure endpoints, every single-ToR
    upgrade, the two prefix halves, and ``n_random`` seeded random subsets.
    A two-phase install can activate ToRs in any order, so soundness must
    hold for *every* subset; this family covers the endpoints, all
    boundaries a lone straggler/early adopter creates, and a handful of
    arbitrary blends. ``sched`` is the schedule being installed (the new
    one). Returns violation messages tagged with the subset that produced
    them (empty = sound across the install window)."""
    N = sched.num_nodes
    subsets: list[tuple[str, np.ndarray]] = [
        ("none", np.zeros(N, bool)), ("all", np.ones(N, bool))]
    for n in range(N):
        one = np.zeros(N, bool)
        one[n] = True
        subsets.append((f"only[{n}]", one))
        subsets.append((f"all-but[{n}]", ~one))
    half = np.arange(N) < N // 2
    subsets.append(("first-half", half))
    subsets.append(("second-half", ~half))
    rng = np.random.default_rng(seed)
    for i in range(n_random):
        subsets.append((f"random[{i}]", rng.random(N) < 0.5))
    bad: list[str] = []
    for tag, up in subsets:
        for msg in check_tables(sched, new_routing, max_hops=max_hops,
                                require_delivery=False, hashes=hashes,
                                max_steps=max_steps, t0s=t0s,
                                old_routing=old_routing, upgraded=up):
            bad.append(f"[upgraded={tag}] {msg}")
            if len(bad) > 64:
                return bad
    return bad


def check_sharding(res, debug: dict, wl, num_slices: int) -> list[str]:
    """Sharding soundness checker for a sharded run's result
    (``check_tables``-style: returns human-readable violation messages,
    empty = sound), of :func:`repro_torch.core.fabric.simulate_sharded`
    (``with_debug=True``; the reference's output as numpy checks the
    same).

    Args:
        res: the ``SimResult``.
        debug: the debug dict from ``simulate_sharded(..., with_debug=True)``
            (``adm_shard`` — the rank that admitted each packet in the hop
            phase, -1 = never hop-admitted; ``owner`` — the rank owning
            each packet's contiguous block; ``num_shards``).
        wl: the ``Workload`` that was simulated.
        num_slices: slices simulated.

    Ownership invariants — the partition is real, not cosmetic:

    * every recorded admitting shard is a valid shard id;
    * **no packet is admitted by a non-owning shard** (``adm_shard`` is
      either -1 or exactly ``owner``);
    * a packet that took hops was admitted by its owner, and a packet that
      was never injected was never admitted.

    Conservation invariants — nothing is lost to the cross-shard exchange
    (the per-key aggregate buffers are static-shape by construction, so
    there is no overflow class to account: every packet must land in
    exactly one of delivered / dropped / queued / not-injected):

    * every ``loc_final`` is a known terminal state or an in-fabric
      location in ``[0, N]`` (``N`` = electrical);
    * delivered ⟺ ``t_deliver`` within the run; undelivered ⟺ -1;
    * ``sum(delivered_bytes)`` equals the byte sum of delivered packets;
    * the final cumulative drop count equals the dropped-packet count.
    """
    bad: list[str] = []
    P = int(np.asarray(wl.src).size)
    D = int(debug["num_shards"])
    adm = np.asarray(debug["adm_shard"])
    owner = np.asarray(debug["owner"])
    loc = np.asarray(res.loc_final)
    t_del = np.asarray(res.t_deliver)
    nhops = np.asarray(res.nhops)
    size = np.asarray(wl.size)
    if adm.shape != (P,) or owner.shape != (P,):
        return [f"debug arrays shaped {adm.shape}/{owner.shape}, "
                f"expected ({P},)"]

    # --- ownership -------------------------------------------------------
    for p in np.nonzero((adm < -1) | (adm >= D))[0][:8]:
        bad.append(f"packet {p}: adm_shard={adm[p]} outside [-1, {D})")
    foreign = (adm >= 0) & (adm != owner)
    for p in np.nonzero(foreign)[0][:8]:
        bad.append(f"packet {p}: admitted by shard {adm[p]} but owned by "
                   f"shard {owner[p]}")
    for p in np.nonzero((nhops > 0) & (adm < 0))[0][:8]:
        bad.append(f"packet {p}: took {nhops[p]} hops but no shard "
                   "recorded admitting it")
    for p in np.nonzero((loc == NOT_INJECTED) & (adm >= 0))[0][:8]:
        bad.append(f"packet {p}: never injected yet admitted by shard "
                   f"{adm[p]}")

    # --- conservation ----------------------------------------------------
    # in-fabric locations are validated loosely (any non-negative id is a
    # node or the electrical port); the real classes are the sentinels
    known = np.isin(loc, (NOT_INJECTED, DELIVERED, DROPPED)) | (loc >= 0)
    for p in np.nonzero(~known)[0][:8]:
        bad.append(f"packet {p}: loc_final={loc[p]} is no known terminal "
                   "state or fabric location")
    delivered = loc == DELIVERED
    in_run = (t_del >= 0) & (t_del < num_slices)
    for p in np.nonzero(delivered & ~in_run)[0][:8]:
        bad.append(f"packet {p}: delivered but t_deliver={t_del[p]} "
                   f"outside [0, {num_slices})")
    for p in np.nonzero(~delivered & (t_del != -1))[0][:8]:
        bad.append(f"packet {p}: loc_final={loc[p]} (undelivered) but "
                   f"t_deliver={t_del[p]} != -1")
    got = int(np.asarray(res.delivered_bytes).sum())
    want = int(size[delivered].sum())
    if got != want:
        bad.append(f"delivered_bytes sums to {got}, delivered packets "
                   f"carry {want} bytes")
    n_drop = int(np.asarray(res.dropped)[-1]) if num_slices else 0
    if n_drop != int(np.sum(loc == DROPPED)):
        bad.append(f"final drop counter {n_drop} != "
                   f"{int(np.sum(loc == DROPPED))} packets at DROPPED")
    return bad


def check_telemetry(res, wl, num_slices: int) -> list[str]:
    """Telemetry conservation checker for the ``telemetry=`` counter layer
    (``check_tables``-style: returns human-readable violation messages,
    empty = sound). Proves the device-accumulated counters against a host
    replay of the terminal packet state, per ToR and globally.

    Args:
        res: a :class:`~repro_torch.core.fabric.SimResult` (or the
            reference's ``ReconfigResult``) with
            ``res.telemetry`` set.
        wl: the simulated :class:`~repro_torch.core.fabric.Workload`, or ``None``
            for the workload-free subset (delivered-row cross-check against
            ``res.delivered_bytes``, utilization and high-water bounds).
        num_slices: slices simulated (``S``; counter rows per slice).

    Checks (counter semantics in :mod:`repro_torch.core.telemetry`):

    * shapes ``[S, N]`` / ``[S, B]`` and non-negativity everywhere;
    * per slice, ``delivered_bytes`` rows sum to ``res.delivered_bytes``;
    * ``util_used <= util_cap`` (a circuit never carries beyond its grant)
      and ``queue_hwm >= res.buf_bytes`` (end-of-slice residency never
      exceeds the intra-slice high-water mark);
    * with ``wl``: exact host replay of ``delivered_bytes[t, d]`` from
      ``(dst, size, t_deliver)``, of the latency histogram from
      ``t_deliver - t_inject``, of total injected bytes per source ToR,
      of total dropped bytes, and byte conservation per source ToR —
      injected == delivered + in-flight + dropped, where in-flight covers
      packets on a switch and electrical deliveries landing past the run.
    """
    bad: list[str] = []
    tele = res.telemetry
    if tele is None:
        return ["res.telemetry is None (simulate with telemetry=...)"]
    S = int(num_slices)
    N = tele.num_nodes
    B = len(tele.lat_edges) + 1
    fields = ("injected_bytes", "delivered_bytes", "deferred_bytes",
              "dropped_bytes", "queue_hwm", "util_used", "util_cap")
    for f in fields:
        a = np.asarray(getattr(tele, f))
        if a.shape != (S, N):
            bad.append(f"telemetry.{f} shaped {a.shape}, expected ({S}, {N})")
        elif (a < 0).any():
            t, n = [int(x[0]) for x in np.nonzero(a < 0)]
            bad.append(f"telemetry.{f}[{t}, {n}] = {a[t, n]} negative")
    hist = np.asarray(tele.lat_hist)
    if hist.shape != (S, B):
        bad.append(f"telemetry.lat_hist shaped {hist.shape}, "
                   f"expected ({S}, {B})")
    if bad:
        return bad

    dlv = np.asarray(tele.delivered_bytes)
    rows = dlv.sum(axis=1)
    ref = np.asarray(res.delivered_bytes)
    for t in np.nonzero(rows != ref)[0][:8]:
        bad.append(f"slice {t}: delivered_bytes row sums to {rows[t]}, "
                   f"SimResult.delivered_bytes says {ref[t]}")
    over = np.asarray(tele.util_used) > np.asarray(tele.util_cap)
    for t, n in zip(*[x[:8] for x in np.nonzero(over)]):
        bad.append(f"slice {t} ToR {n}: util_used "
                   f"{tele.util_used[t, n]} > granted {tele.util_cap[t, n]}")
    buf = np.asarray(res.buf_bytes)
    low = np.asarray(tele.queue_hwm) < buf
    for t, n in zip(*[x[:8] for x in np.nonzero(low)]):
        bad.append(f"slice {t} switch {n}: queue_hwm {tele.queue_hwm[t, n]} "
                   f"below end-of-slice residency {buf[t, n]}")
    if wl is None:
        return bad

    src = np.asarray(wl.src)
    dst = np.asarray(wl.dst)
    size = np.asarray(wl.size).astype(np.int64)
    t_inj = np.asarray(wl.t_inject)
    loc = np.asarray(res.loc_final)
    t_del = np.asarray(res.t_deliver)
    # delivered rows, exact replay: bytes land at their delivery slice
    in_run = (t_del >= 0) & (t_del < S)
    want_dlv = np.zeros((S, N), np.int64)
    np.add.at(want_dlv, (t_del[in_run], dst[in_run]), size[in_run])
    for t, d in zip(*[x[:8] for x in np.nonzero(want_dlv != dlv)]):
        bad.append(f"slice {t} dst {d}: delivered_bytes {dlv[t, d]}, host "
                   f"replay says {want_dlv[t, d]}")
    # latency histogram, exact replay (bucket i: lat in (edges[i-1], edges[i]])
    lat = np.maximum(t_del[in_run] - t_inj[in_run], 0)
    bidx = np.searchsorted(np.asarray(tele.lat_edges), lat, side="left")
    want_hist = np.zeros((S, B), np.int64)
    np.add.at(want_hist, (t_del[in_run], bidx), 1)
    for t, b in zip(*[x[:8] for x in np.nonzero(want_hist != hist)]):
        bad.append(f"slice {t} bucket {b}: lat_hist {hist[t, b]}, host "
                   f"replay says {want_hist[t, b]}")
    # totals and conservation per source ToR: every injected byte is
    # delivered, dropped, or still in flight (incl. electrical deliveries
    # landing past the run)
    injected = loc != NOT_INJECTED
    dropped = loc == DROPPED
    flight = injected & ~dropped & ~(in_run & (loc == DELIVERED))
    inj_tot = np.asarray(tele.injected_bytes).sum(axis=0, dtype=np.int64)
    want_inj = np.bincount(src[injected], weights=size[injected],
                           minlength=N).astype(np.int64)
    for n in np.nonzero(inj_tot != want_inj)[0][:8]:
        bad.append(f"ToR {n}: injected_bytes total {inj_tot[n]}, terminal "
                   f"state says {want_inj[n]} bytes entered")
    got_drop = int(np.asarray(tele.dropped_bytes).sum())
    want_drop = int(size[dropped].sum())
    if got_drop != want_drop:
        bad.append(f"dropped_bytes total {got_drop}, dropped packets carry "
                   f"{want_drop} bytes")
    per_src = np.zeros((3, N), np.int64)
    for i, m in enumerate((in_run & (loc == DELIVERED), dropped, flight)):
        per_src[i] = np.bincount(src[m], weights=size[m], minlength=N)
    gap = want_inj - per_src.sum(axis=0)
    for n in np.nonzero(gap)[0][:8]:
        bad.append(f"ToR {n}: conservation gap {gap[n]} bytes (injected "
                   f"{want_inj[n]} != delivered {per_src[0, n]} + dropped "
                   f"{per_src[1, n]} + in-flight {per_src[2, n]})")
    return bad


def _check_walks_vec(sched: Schedule, routing: CompiledRouting, hashes,
                     max_hops: int, require_delivery: bool, max_steps: int,
                     link_fail: np.ndarray | None, t0s,
                     old_routing: CompiledRouting | None = None,
                     upgraded: np.ndarray | None = None) -> list[tuple]:
    """Vectorized table walks: advance *all* (src, dst, t0) walks of each
    hash in lock-step (same semantics as :func:`_check_walk`, one batched
    gather per step). Returns the violating (src, dst, t0, hash) tuples in
    the scalar sweep's (src, dst, t0, hash) iteration order. With
    ``old_routing``/``upgraded``, non-upgraded nodes answer from the old
    tables and dark circuits end walks OK (mixed-version semantics)."""
    Tr = routing.num_slices
    Ts, N = sched.num_slices, sched.num_nodes
    has = _has_circuit_grid(sched)                       # [Ts, N, N]
    if link_fail is not None:
        has = has & ~link_fail[None]
    t0_arr = np.asarray(list(t0s), dtype=np.int64)
    src0, dst0, t00 = [a.ravel() for a in np.meshgrid(
        np.arange(N), np.arange(N), t0_arr, indexing="ij")]
    keep = src0 != dst0
    src0, dst0, t00 = src0[keep], dst0[keep], t00[keep]
    W = src0.size
    ACTIVE, OK, VIOL = 0, 1, 2
    found: list[tuple] = []
    for hi, hashv in enumerate(hashes):
        node = src0.copy()
        t = t00.copy()
        hops = np.zeros(W, np.int64)
        code = np.full(W, ACTIVE, np.int8)
        widx = np.arange(W)
        for step in range(max_steps):
            act = code == ACTIVE
            if not act.any():
                break
            code[act & (node == dst0)] = OK              # delivered
            act = code == ACTIVE
            tbl_n = routing.inj_next if step == 0 else routing.tf_next
            tbl_d = routing.inj_dep if step == 0 else routing.tf_dep
            row_n = tbl_n[t % Tr, node, dst0]            # [W, K]
            row_d = tbl_d[t % Tr, node, dst0]
            if old_routing is not None:
                otbl_n = old_routing.inj_next if step == 0 else old_routing.tf_next
                otbl_d = old_routing.inj_dep if step == 0 else old_routing.tf_dep
                un = upgraded[node][:, None]             # each hop answers
                row_n = np.where(un, row_n, otbl_n[t % Tr, node, dst0])
                row_d = np.where(un, row_d, otbl_d[t % Tr, node, dst0])
            nvalid = (row_n >= 0).sum(axis=-1)
            stuck = act & (nvalid == 0)
            code[stuck] = VIOL if require_delivery else OK
            act = code == ACTIVE
            slot = hashv % np.maximum(nvalid, 1)
            nxt = row_n[widx, slot].astype(np.int64)
            off = row_d[widx, slot].astype(np.int64)
            code[act & (off < 0)] = VIOL                 # time backwards
            act = code == ACTIVE
            wire = t + off
            opt = nxt < N
            dark = act & opt & ~has[wire % Ts, node, np.clip(nxt, 0, N - 1)]
            # mixed mode: the fabric defers a stale entry's dark tx, so the
            # walk ends OK; single-version tables must never go dark
            code[dark] = OK if old_routing is not None else VIOL
            act = code == ACTIVE
            node = np.where(act, np.where(opt, nxt, dst0), node)
            t = np.where(act, np.where(opt, wire, wire + 1), t)
            hops = hops + act
            code[act & (hops > max_hops)] = VIOL         # hop bound
        code[code == ACTIVE] = VIOL                      # never resolved: loop
        # walks are meshgrid-ordered, i.e. (src, dst, t0)-lexicographic, so
        # the first 65 per hash already cover everything the caller's
        # 64-message truncation can emit — badly broken tables don't build
        # millions of violation tuples just to discard them
        for j in np.nonzero(code == VIOL)[0][:65]:
            found.append((int(src0[j]), int(dst0[j]), int(t00[j]), hi))
    # scalar sweep order is src -> dst -> t0 -> hash
    found.sort()
    return [(s, d, t0, hashes[hi]) for s, d, t0, hi in found]


def _check_walk(sched: Schedule, routing: CompiledRouting, src: int,
                dst: int, t0: int, hashv: int, max_hops: int,
                require_delivery: bool, max_steps: int,
                link_fail: np.ndarray | None = None,
                old_routing: CompiledRouting | None = None,
                upgraded: np.ndarray | None = None) -> str | None:
    """One table walk (same semantics as :func:`trace_packet`); returns a
    violation message or None. This is the scalar reference for
    :func:`_check_walks_vec`, kept to narrate the violations it finds."""
    T = routing.num_slices
    node, t, hops = src, t0, 0
    step0 = True
    where = f"walk {src}->{dst} @t0={t0} h={hashv}"
    for _ in range(max_steps):
        if node == dst:
            if hops > max_hops:
                return f"{where}: delivered in {hops} hops > max_hops={max_hops}"
            return None
        rt = routing if old_routing is None or upgraded[node] else old_routing
        tbl_next = rt.inj_next if step0 else rt.tf_next
        tbl_dep = rt.inj_dep if step0 else rt.tf_dep
        row_n = tbl_next[t % T, node, dst]
        row_d = tbl_dep[t % T, node, dst]
        nvalid = int((row_n >= 0).sum())
        if nvalid == 0:
            if require_delivery:
                return f"{where}: stuck at node {node} slice {t} (no entry)"
            return None
        nxt = int(row_n[hashv % nvalid])
        off = int(row_d[hashv % nvalid])
        if off < 0:
            return f"{where}: time moves backwards at node {node} (dep {off})"
        wire_t = t + off
        if nxt < sched.num_nodes:
            dead = (link_fail is not None and link_fail[node, nxt]) \
                or not sched.has_circuit(node, nxt, wire_t)
            if dead:
                if old_routing is not None:
                    return None          # mixed mode: fabric defers, walk OK
                if link_fail is not None and link_fail[node, nxt]:
                    return (f"{where}: rides failed link {node}->{nxt} "
                            f"at slice {wire_t}")
                return (f"{where}: rides dark circuit {node}->{nxt} "
                        f"at slice {wire_t}")
            node, t = nxt, wire_t
        else:
            node, t = dst, wire_t + 1    # electrical egress: 1-slice transit
        step0 = False
        hops += 1
        if hops > max_hops:
            return f"{where}: exceeds max_hops={max_hops} without delivery"
    return f"{where}: no delivery or stick within {max_steps} steps (loop?)"


def format_schedule(sched: Schedule, max_slices: int = 8) -> str:
    """ASCII view of the optical schedule's first slices (Fig. 1 analogue)."""
    out = [f"optical schedule: {sched.num_nodes} nodes x {sched.num_uplinks} "
           f"uplinks, cycle {sched.num_slices} slices, "
           f"{sched.slice_us:.1f} us/slice (duty {sched.duty_cycle:.0%})"]
    for t in range(min(sched.num_slices, max_slices)):
        pairs = ", ".join(
            f"{i}->{sched.conn[t, i, k]}"
            for i in range(sched.num_nodes)
            for k in range(sched.num_uplinks) if sched.conn[t, i, k] >= 0)
        out.append(f"  slice {t}: {pairs}")
    if sched.num_slices > max_slices:
        out.append(f"  ... ({sched.num_slices - max_slices} more slices)")
    return "\n".join(out)
