"""The OpenOptics data plane in PyTorch: the port of ``repro.core.fabric``.

The reference runs the fabric as one ``lax.scan`` of a per-slice step over
structure-of-arrays packet state (see its module docstring for the
semantics of a slice: injection, calendar-queue transmission with
cut-through chaining, congestion detection, push-back, offloading). This
port runs the same step as a Python ``for`` over slices, on tensors on one
device, and is bit-identical to it: same layouts, same int32 dtypes, same
results field for field.

* It ports the reference's *full-width* program. The reference's compact
  population tiers and ``lax.cond`` phase skips are semantic identities
  (the reference drops them itself when sharded or batched), so every phase
  here runs over all P packets with static shapes and no host sync in the
  slice loop.
* The two kernels of the step are the port's hand-written CUDA kernels
  (:mod:`repro_torch.kernels`): the time-flow lookup at the fused
  injection / re-lookup site and at the transit lookup, and FIFO admission
  at the per-hop capacity cut and (under push-back) the receiver cut. On a
  CUDA device the step always goes through them; on the CPU it runs their
  plain versions. The lookup reads one packed table, looks up only the
  packets whose result the step uses (every other packet gets (-1, 0),
  which no consumer reads), and forms the per-packet multipath hash itself.
* Aggregates (occupancy map, ``block_until``, ``max_seq``, backlog minima)
  are updated in place with ``index_add_`` / ``scatter_reduce_``; the
  per-packet fields are replaced as in the reference.
* The uint32 hashes run in int64 masked to 32 bits
  (:func:`repro_torch.kernels.time_flow_lookup.hash32`).
* The optional inputs follow the reference's presence rule: failure masks
  (:mod:`.failures`), control-plane masks (:mod:`.controlplane`) and
  telemetry counters (:mod:`.telemetry`) each add their branches to the
  step only when given, so a run without them is the same program. The
  masks go to the device once per window; a skewed ToR's lookups read its
  local slice through the lookup kernel's per-node offset.
* The incremental API (:func:`init_state`, :func:`ingest`,
  :func:`step_slices`, :func:`finalize`) splits the run into windows and
  carries the packet state across them; :func:`simulate` is one window.
  A window's masks cover only that window (row 0 its first slice), and a
  step is built per window, since an ingest grows the packet population
  the step captures.
* Versioned tables (the reconfigure loop's installs,
  :mod:`.reconfigure`): a window may carry ``V`` table versions and a
  per-slice, per-ToR version select; both lookup sites then read each
  ToR's version through the lookup kernel's ``[N]`` ``vsel`` (``[B·N]``
  in a sweep of the loop, :func:`.reconfigure.reconfigure_fleet`).
* Scenario sweeps (:func:`simulate_fleet`, the reference's vmapped
  ``simulate_fleet``): B scenarios run through one step a slice, every
  launch carrying all of them. The layout is scenario-major: packet ``p``
  of scenario ``b`` is packet ``b·P + p``, its ToRs are rows ``b·N + n``
  of the node axis (schedule, tables, masks, queues, counters), its
  circuits keys ``b·N(N+1) + key``; destinations, next hops and the
  electrical peer ``N`` stay per scenario. Per-slice stats are reduced
  per scenario, and the lookup hashes each packet's index within its
  scenario.
* Sharded runs (:func:`simulate_sharded`, the reference's
  ``simulate_sharded``): the packets split over ``torch.distributed``
  ranks in contiguous global-index blocks, the failure and control masks
  by owned ToR rows (:mod:`repro_torch.distributed.sharding`). Every rank
  runs the step over its block and keeps the per-ToR aggregates
  replicated, each update reconciled by an all-reduce
  (:mod:`repro_torch.distributed.collectives`); admission takes the
  earlier ranks' bytes off the capacities, backlog minima compare global
  packet ids, and the lookup hashes each packet's global index. Equal to
  :func:`simulate` in every field and counter.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from ..distributed import collectives, sharding
from ..distributed.spawn import choose_backend, run_ranks
from ..distributed.collectives import (earlier_offsets, exchange_min,
                                       exchange_sum, gather_node_row,
                                       offsets_buffer)
from ..kernels import _build
from ..kernels import admission as admission_mod
from ..kernels import time_flow_lookup as lookup_mod
from ..kernels.admission import admission_admit
from ..kernels.time_flow_lookup import salted_hash, time_flow_lookup
from .routing import CompiledRouting, first_direct_offsets
from .telemetry import TelemetryConfig, TelemetryCounters, counters_from_out
from .topology import Schedule

__all__ = ["FabricConfig", "Workload", "FabricTables", "SimResult",
           "FabricState", "simulate", "simulate_fleet", "simulate_sharded",
           "simulate_shard",
           "simulate_incremental", "init_state",
           "ingest", "step_slices", "finalize", "tables_from_arrays",
           "workload_from_arrays", "resolve_device"]

NOT_INJECTED = -1
DELIVERED = -2
DROPPED = -3

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Static fabric parameters; the fields and defaults of the reference's
    ``FabricConfig`` except ``lookup_impl`` / ``admit_impl``: here the
    backend follows the device (kernels on CUDA, plain versions on CPU).

    slice_bytes: admissible bytes per circuit per slice (100 Gbps x 6 us).
    elec_bytes: per-node electrical egress capacity per slice (peer id N).
    switch_buffer: per-switch buffer bound; arrivals beyond it drop.
    hops_per_slice: cut-through chaining bound within one slice (Opera).
    max_hops: lifetime hop bound per packet.
    cc_detect: congestion detection (§5.2): defer and re-look-up.
    pushback: traffic push-back (§5.2).
    offload / offload_horizon: buffer offloading (§5.2).
    flow_pausing: hold elephants for a direct circuit (§5.2).
    congestion_threshold: classic CC byte threshold per calendar queue.
    """

    slice_bytes: int = 75_000
    elec_bytes: int = 0
    switch_buffer: int = 64 << 20
    hops_per_slice: int = 4
    max_hops: int = 16
    cc_detect: bool = True
    pushback: bool = False
    offload: bool = False
    offload_horizon: int = 2
    flow_pausing: bool = False
    congestion_threshold: int = 1 << 30


@dataclasses.dataclass
class Workload:
    """Packets (cells) to simulate, structure-of-arrays (host numpy)."""

    src: np.ndarray       # [P] i32
    dst: np.ndarray       # [P] i32
    size: np.ndarray      # [P] i32 bytes
    t_inject: np.ndarray  # [P] i32 slice index
    flow: np.ndarray      # [P] i32 flow id (dense, < F)
    seq: np.ndarray       # [P] i32 sequence within flow
    is_eleph: np.ndarray  # [P] bool

    @property
    def num_packets(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_flows(self) -> int:
        return int(self.flow.max()) + 1 if self.num_packets else 0


@dataclasses.dataclass
class FabricTables:
    """Dense deployed state: the optical schedule + compiled time-flow
    tables (host numpy, the reference's layouts)."""

    conn: np.ndarray          # [T, N, U]
    tf_next: np.ndarray       # [Tr, N, D, K]
    tf_dep: np.ndarray
    inj_next: np.ndarray
    inj_dep: np.ndarray
    first_direct: np.ndarray  # [T, N, D] offset to next direct circuit (-1 none)
    multipath: str = "packet"

    @classmethod
    def build(cls, sched: Schedule, routing: CompiledRouting) -> "FabricTables":
        return cls(
            conn=sched.conn,
            tf_next=routing.tf_next, tf_dep=routing.tf_dep,
            inj_next=routing.inj_next, inj_dep=routing.inj_dep,
            first_direct=first_direct_offsets(sched),
            multipath=routing.multipath,
        )


_TABLE_FIELDS = ("conn", "tf_next", "tf_dep", "inj_next", "inj_dep",
                 "first_direct")


def tables_from_arrays(arrays: dict, multipath: str = "packet") -> FabricTables:
    """A :class:`FabricTables` from the fields of the reference's
    ``FabricTables`` as numpy arrays (``dataclasses.asdict`` of it; any
    ``multipath`` entry there is ignored in favour of the argument)."""
    return FabricTables(
        **{k: np.asarray(arrays[k], np.int32) for k in _TABLE_FIELDS},
        multipath=multipath)


def workload_from_arrays(arrays: dict) -> Workload:
    """A :class:`Workload` from the reference's ``Workload`` fields as
    numpy arrays (``dataclasses.asdict`` of it)."""
    return Workload(**{
        f.name: np.asarray(arrays[f.name],
                           bool if f.name == "is_eleph" else np.int32)
        for f in dataclasses.fields(Workload)})


@dataclasses.dataclass
class SimResult:
    """The reference's ``SimResult``: numpy arrays of the same shapes and
    dtypes, all int32, and the telemetry counters when asked for."""

    t_deliver: np.ndarray        # [P] slice of delivery (-1 undelivered)
    loc_final: np.ndarray        # [P]
    nhops: np.ndarray            # [P]
    delivered_bytes: np.ndarray  # [S] per slice
    dropped: np.ndarray          # [S] cumulative dropped-packet count
    buf_bytes: np.ndarray        # [S, N] switch-resident buffer per node
    offl_bytes: np.ndarray       # [S, N] host-offloaded buffer per node
    blocked_inj: np.ndarray      # [S] injections deferred by push-back
    slice_miss: np.ndarray       # [S] packets that missed their slice
    reorder_cnt: np.ndarray      # scalar: out-of-order deliveries
    # per-ToR per-slice counter frames when simulate ran with telemetry=
    # (None otherwise; see repro_torch.core.telemetry)
    telemetry: TelemetryCounters | None = None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Without CUDA, ``device=None`` raises rather than quietly
    running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU by default; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


# ---------------------------------------------------------------------------
# the per-slice machinery
# ---------------------------------------------------------------------------

def _build_caps(conn, cfg: FabricConfig, N: int, link_cap=None,
                node_ok=None, t0: int = 0, row0: int | None = None,
                reduce=None):
    """Per-circuit capacity ``[R, M*(N+1)]``, keyed loc*(N+1)+peer; key
    loc*(N+1)+N is the electrical egress. ``conn`` is ``[T, M, U]``: M = N
    ToRs, or a scenario sweep's B·N (each scenario's ToRs a block of rows
    whose peers lie in ``[0, N)``; its masks ``[W, B·N, N]`` and ``[W,
    B·N]``). Without failure masks the R rows
    are the T slices of the cycle: a circuit admits ``slice_bytes``, an
    egress ``elec_bytes``. With them (``link_cap`` ``[W, N, N]``,
    ``node_ok`` ``[W, N]``) the rows are the W slices of the window that
    starts at absolute slice ``t0``, the reference's per-slice ``caps_at``
    for all of them at once: a circuit keeps ``link_cap`` of
    ``slice_bytes``, the degraded product in float32 truncated toward
    zero, a healthy (>= 1) or dead (<= 0) link exact; a down ToR's
    electrical egress gets nothing. The result takes 4·R·M·(N+1) bytes:
    with masks, about as much again as the window's ``link_cap``.

    A rank of a sharded run holds only its own rows of ``link_cap``
    (``[W, ceil(N/D), N]``, the first at global row ``row0``; padded rows
    past N scatter nothing): it builds the partial key map of its rows,
    ``reduce`` (the sum over the ranks) joins the partial maps, and the
    electrical row is added after it, from the whole ``node_ok``."""
    T, M, U = conn.shape
    dev = conn.device
    R = T if link_cap is None else link_cap.shape[0]
    NKEY = M * (N + 1)
    caps = torch.zeros((R, NKEY), dtype=_I32, device=dev)
    rows = torch.arange(M, dtype=torch.int64, device=dev)[None, :]
    rrows = torch.arange(R, dtype=torch.int64, device=dev)[:, None]
    conn_r = conn[(torch.arange(R, device=dev) + t0) % T]      # [R, M, U]
    own = None
    if row0 is not None:
        # this rank's rows, with their global row keys
        g = row0 + torch.arange(link_cap.shape[1], dtype=torch.int64,
                                device=dev)
        own = (g < M)[None, :]
        rows = g.clamp(max=M - 1)[None, :]
        conn_r = conn_r[:, rows[0]]
    flat = caps.view(-1)
    for k in range(U):
        peer = conn_r[:, :, k].to(torch.int64)                # [R, M]
        keyk = rows * (N + 1) + torch.where(peer >= 0, peer, N)
        scaled = torch.full(peer.shape, cfg.slice_bytes, dtype=_I32,
                            device=dev)
        if link_cap is not None:
            lck = link_cap.gather(2, peer.clamp(0, N - 1)[:, :, None])[:, :, 0]
            scaled = torch.where(
                lck >= 1.0, scaled,
                torch.where(lck <= 0.0, 0, (lck * cfg.slice_bytes).to(_I32)))
        okp = peer >= 0 if own is None else (peer >= 0) & own
        flat.index_add_(0, (rrows * NKEY + keyk).reshape(-1),
                        torch.where(okp, scaled, 0).reshape(-1))
    if reduce is not None:
        caps = reduce(caps)
    elec = torch.arange(M, device=dev) * (N + 1) + N
    caps[:, elec] += (cfg.elec_bytes if node_ok is None else
                      torch.where(node_ok, cfg.elec_bytes, 0).to(_I32))
    return caps


def _pad_k(a, K: int, fill: int):
    """Pad the slot axis of ``[..., k]`` tables to K with ``fill``."""
    if a.shape[-1] == K:
        return a
    pad = a.new_full(a.shape[:-1] + (K - a.shape[-1],), fill)
    return torch.cat([a, pad], dim=-1)


def stack_tables(inj_next, inj_dep, tf_next, tf_dep):
    """The packed ``[2, Tr, N, D, 2, K]`` table the lookup kernel takes:
    selector 0 the injection tables, 1 the transit tables, and for each
    entry its next-hop row (``[..., 0, :]``) beside its departure row
    (``[..., 1, :]``). K is padded to the larger of the two with invalid
    slots (-1 / 0), which leaves the valid count, so the slot pick,
    unchanged. Versioned tables (``[V, Tr, N, D, K]`` each) give the
    versioned table ``[2, V, Tr, N, D, 2, K]``, every version padded to
    the common K."""
    K = max(inj_next.shape[-1], tf_next.shape[-1])
    nxt = torch.stack([_pad_k(inj_next, K, -1), _pad_k(tf_next, K, -1)])
    dep = torch.stack([_pad_k(inj_dep, K, 0), _pad_k(tf_dep, K, 0)])
    return torch.stack([nxt, dep], dim=-2).contiguous()


def _spread_offsets(off, looked_up, pid):
    """The lookup's departure offsets, each packet outside ``looked_up``
    (offset 0) given its own index in their place. No consumer uses those
    offsets but as calendar-bucket indices, in adds of zero and in gathers:
    spread over the buckets, the adds no longer queue on one address
    (atomics on one address serialise)."""
    return torch.where(looked_up, off, pid)


def _init_state(j, num_flows: int):
    """Fresh per-packet state: all packets un-injected, queues empty. In a
    scenario sweep ``N`` is the node axis's B·N rows, ``num_flows`` the
    B·F flow rows, and ``reorder`` a ``[B]`` count."""
    T, N, _ = j["conn"].shape
    B = j.get("num_scenarios", 1)
    P = j["src"].shape[0]
    dev = j["src"].device
    full = lambda shape, v: torch.full(shape, v, dtype=_I32, device=dev)
    return dict(
        loc=full((P,), NOT_INJECTED),
        nxt=full((P,), -1),
        dep=full((P,), 0),
        relook=torch.zeros((P,), dtype=torch.bool, device=dev),
        nhops=full((P,), 0),
        t_del=full((P,), -1),
        block_until=full((N, T), 0),        # [dst, slice bucket]
        max_seq=full((num_flows,), -1),
        reorder=full(() if B == 1 else (B,), 0),
        occ=full((N * 2 * T,), 0),          # calendar-queue occupancy [N * 2T]
    )


def _make_step(j, cfg: FabricConfig, per_packet_mp: bool,
               telemetry: TelemetryConfig | None = None):
    """Build ``step(state, t) -> stats`` over the tensors in ``j``; the
    step updates ``state`` (a dict of tensors) for absolute slice ``t``.
    The reference's single-device ``_make_step`` at full width, with its
    failure (``j["link_cap"]``, ``j["node_ok"]``), control
    (``j["phase_off"]``, ``j["skew_miss"]``) and telemetry branches, each
    present only when its input is. The masks' row 0 is absolute slice
    ``j["mask_t0"]`` (0 when absent): a window's masks cover only that
    window. With versioned tables (``j["tf_next_v"]`` and the other three,
    ``[V, Tr, N, D, K]``) both lookup sites read, at each node, the
    version ``j["vsel"][t - j["vsel_t0"]]`` selects for it: the version
    select of *fabric* slice ``t``, not of the ToR's local slice. The step
    captures the packet count, so it serves one window.

    A scenario sweep (``j["num_scenarios"]`` B > 1, built by
    :func:`simulate_fleet`) stacks B scenarios on the packet and node axes
    (``j["scen"]`` each packet's scenario): the node-indexed tensors have
    ``NB = B·N`` rows, a packet's ToR ids are offset by ``b·N`` where they
    index them, its flow id by ``b·F`` where it indexes ``max_seq``, and
    the stats come per scenario (``[B]``, ``[B·N]``). With B = 1 none of
    that adds an op: the solo step is the same program.

    A rank of a sharded run (``j["shard"]``, a :class:`_Shard`; built by
    :func:`simulate_shard`) holds its block of the packets, whose global
    ids are ``rank·P + i``, and the replicated per-ToR aggregates: each
    update of one is reconciled by an all-reduce before its next read
    (the reference's ``upd_add``, ``gsum``, ``gmin`` and ``gmax`` points);
    the counts and counters of a slice go in one exchange at its end, the
    reorder count at the run's. Admission is fed capacities less the
    earlier ranks' wanted bytes; the backlog minima hold global ids; the
    lookup hashes each packet's global index. Unsharded, none of that adds
    an op."""
    sh = j.get("shard")
    if sh is not None and "tf_next_v" in j:
        raise ValueError("versioned tables come from the reconfigure loop, "
                         "which sweeps scenarios, not shards: a sharded "
                         "run refuses them")
    T, NB, _ = j["conn"].shape
    B = j.get("num_scenarios", 1)
    N = NB // B
    P = j["src"].shape[0]
    dev = j["src"].device
    lid = torch.arange(P, dtype=_I32, device=dev)
    if sh is None:
        pid, PG, hbase = lid, P, None
    else:
        # global packet ids: rank d holds [d·P, (d+1)·P) of the padded PG
        pid, PG = lid + sh.rank * P, P * sh.size
        hbase = sh.rank * P if per_packet_mp else None
    NKEY = NB * (N + 1)
    T2 = 2 * T                       # calendar-queue ring: dep in (t, t + 2T)
    limit = min(cfg.slice_bytes, cfg.congestion_threshold)
    has_vers = "tf_next_v" in j
    Tr = j["tf_next_v"].shape[1] if has_vers else j["tf_next"].shape[0]
    has_fail = "link_cap" in j
    has_ctrl = "phase_off" in j
    has_tele = telemetry is not None
    mt0 = j.get("mask_t0", 0)        # the masks' first absolute slice
    spill = lid + NB if has_tele else None  # counters' spill slots (count_)
    # [W, NKEY] for the window's W slices with failure masks, else [T, NKEY]
    # for the cycle; a rank builds its own rows' map and the ranks sum them
    shard_rows = {} if sh is None or not has_fail else dict(
        row0=sh.rank * j["link_cap"].shape[1],
        reduce=lambda x: exchange_sum(x, sh.group))
    caps_rows = _build_caps(j["conn"], cfg, N, j.get("link_cap"),
                            j.get("node_ok"), mt0 if has_fail else 0,
                            **shard_rows)

    # packed (injection, transit) tables for the fused first-phase lookup,
    # with a version axis when the window carries versioned tables
    sfx = "_v" if has_vers else ""
    table = stack_tables(*(j[k + sfx] for k in ("inj_next", "inj_dep",
                                                "tf_next", "tf_dep")))

    size, dst, src = j["size"], j["dst"], j["src"]
    flow, seq, is_eleph = j["flow"], j["seq"], j["is_eleph"]
    if B > 1:
        # a packet's rows of the node axis and of max_seq; dst and the next
        # hops compared with it stay its scenario's own
        noff = j["scen"] * N
        src_g, dst_g = src + noff, dst + noff
        flow_g = flow + j["scen"] * j["scen_flows"]
        # per-packet multipath: the lookup hashes i mod P / B (per-flow
        # passes the flow hash, of the scenario's own flow ids)
        hash_period = max(P // B, 1) if per_packet_mp else None
    else:
        noff, src_g, dst_g, flow_g, hash_period = None, src, dst, flow, None
    hor = max(0, min(cfg.offload_horizon, T2 - 1))
    hor_cols = torch.arange(hor, dtype=torch.int64, device=dev)
    # per-flow multipath hashes the flow id unsalted: one hash for the run;
    # per-packet multipath passes the slice, and the lookup hashes each
    # packet's index salted with it
    flow_hash = None if per_packet_mp else salted_hash(flow.to(torch.int64), 0)

    def cl(x):
        """A node id's row of the node axis, clamped into its scenario."""
        return x.clamp(0, N - 1) if noff is None else x.clamp(0, N - 1) + noff

    def total(x):
        """``x.sum()`` over the packets as int32, per scenario in a
        sweep."""
        return (x.sum() if B == 1 else x.view(B, -1).sum(1)).to(_I32)

    def vbucket(loc, dep_abs):
        return cl(loc) * T2 + dep_abs % T2

    # Sharded, each replicated aggregate is reconciled before its next
    # read, and the exchanges due by a read go in one all-reduce: the
    # ranks' adds to an aggregate wait as a delta (pend_sum), the
    # aggregates a rank min- or max-reduced locally (pend_min, a max as the
    # min of the negation) ride the same sum as every rank's copy, each in
    # its own row of a zero buffer (sync_). Every minimum but push-back's
    # resc_min is updated before a sum that precedes its next read (the
    # backlog cuts and max_seq before the hop's buffer sum, block_until
    # before the next sum); resc_min, read right after its update, takes a
    # min-reduce of its own (sync_min_).
    pend_sum: list = []            # (aggregate, delta) pairs
    pend_min: dict = {}            # id -> (aggregate, negated)

    def defer_(target, delta=None):
        """The pending delta of ``target`` (a new zero one, or ``delta``
        added to it)."""
        for tg, d in pend_sum:
            if tg is target:
                return d if delta is None else d.add_(delta)
        d = torch.zeros_like(target) if delta is None else delta.clone()
        pend_sum.append((target, d))
        return d

    def sync_(*extra):
        """Sharded: add every pending delta, summed over the ranks, to its
        aggregate, reduce every pending minimum (maximum) over the ranks'
        copies, and sum the int32 ``extra`` tensors over the ranks, all in
        one all-reduce; returns the summed extras."""
        mins = list(pend_min.values())
        rows = []
        for tg, neg in mins:
            row = tg.new_zeros((sh.size,) + tuple(tg.shape))
            row[sh.rank] = -tg if neg else tg
            rows.append(row)
        bufs = [d for _, d in pend_sum] + rows + list(extra)
        if not bufs:
            return []
        red = exchange_sum(torch.cat([b.reshape(-1) for b in bufs]),
                           sh.group)
        parts = torch.split(red, [b.numel() for b in bufs])
        for (tg, _), part in zip(pend_sum, parts):
            tg += part.view_as(tg)
        for (tg, neg), part in zip(mins, parts[len(pend_sum):]):
            m = part.view((sh.size,) + tuple(tg.shape)).amin(0)
            tg.copy_(-m if neg else m)
        pend_sum.clear()
        pend_min.clear()
        return [part.view_as(b) for part, b in
                zip(parts[len(bufs) - len(extra):], extra)]

    def sync_min_():
        """Sharded: min-reduce (max-reduce) every pending aggregate over
        the ranks, in one all-reduce."""
        if not pend_min:
            return
        ts = list(pend_min.values())
        red = exchange_min(torch.cat([(-tg if neg else tg).reshape(-1)
                                      for tg, neg in ts]), sh.group)
        for (tg, neg), part in zip(ts, torch.split(
                red, [tg.numel() for tg, _ in ts])):
            tg.copy_((-part if neg else part).view_as(tg))
        pend_min.clear()

    def add_(target, *updates):
        """``target.at[idx].add(where(mask, vals, 0))`` for each ``(idx,
        vals, mask)`` of ``updates``, in place. Sharded (the target is a
        replicated aggregate) the adds go into its pending delta."""
        if sh is not None:
            target = defer_(target)
        for idx, vals, mask in updates:
            target.index_add_(0, idx, torch.where(mask, vals, 0))

    def admit(key, want, cap_left, num_keys):
        """FIFO admission of ``want`` under the capacities ``cap_left()``
        (the admission kernel). Sharded, a packet's global byte prefix in
        its group is its local one plus the earlier ranks' wanted bytes of
        the group: the capacities are fed less those (the offsets of
        ``shard_group_offsets``, exchanged with the pending deltas), and
        the admitted bytes are this rank's."""
        if sh is None:
            return admission_admit(key, size, want, cap_left(),
                                   num_keys=num_keys)
        local = torch.zeros((num_keys + 1,), dtype=_I32, device=dev)
        local.index_add_(0, torch.where(want, key, num_keys),
                         torch.where(want, size, 0))
        buf, = sync_(offsets_buffer(local[:num_keys], sh.rank, sh.size))
        return admission_admit(key, size, want,
                               cap_left() - earlier_offsets(buf, sh.rank),
                               num_keys=num_keys)

    def count_(counter, node, vals, mask):
        """``counter[node] += where(mask, vals, 0)``, in place, for a
        telemetry counter of N slots and P spill slots: a packet outside
        ``mask`` adds its 0 to a spill slot of its own, as P-wide adds of 0
        to a few addresses serialise on the card."""
        counter.index_add_(0, torch.where(mask, node, spill),
                           torch.where(mask, vals, 0))

    def max_at_(target2d, row, col, vals):
        """``target2d.at[row, col].max(vals)``, in place (sharded, to be
        max-reduced)."""
        ncol = target2d.shape[1]
        target2d.view(-1).scatter_reduce_(
            0, row.to(torch.int64) * ncol + col, vals, "amax",
            include_self=True)
        if sh is not None:
            pend_min[id(target2d)] = (target2d, True)

    def min_at_(target, idx, vals):
        """``target.at[idx].min(vals)``, in place (sharded, to be
        min-reduced)."""
        target.scatter_reduce_(0, idx.to(torch.int64), vals, "amin",
                               include_self=True)
        if sh is not None:
            pend_min[id(target)] = (target, False)

    def on_switch_bytes(occ, t):
        """Per-node switch-resident bytes: the occupancy columns within the
        offload horizon (all columns without offloading)."""
        occ2 = occ.view(NB, T2)
        if not cfg.offload:
            return occ2.sum(1).to(_I32)
        return occ2[:, (hor_cols + (t + 1)) % T2].sum(1).to(_I32)

    def enqueue_checks(s, arrived, off, t):
        """Congestion detection at enqueue (§5.2) against the carried
        occupancy map: a full calendar queue defers the packet to the next
        slice (and, with push-back, blocks its source bucket). Only the
        offsets of ``arrived`` packets count."""
        if not cfg.cc_detect:
            return
        dep_abs = t + off
        qb = vbucket(s["loc"], dep_abs)
        if sh is not None:
            sync_()                  # the occupancy read below
        full = arrived & (off > 0) & (s["occ"][qb] > limit)
        add_(s["occ"], (qb, -size, full),
             (vbucket(s["loc"], t + 1), size, full))
        if has_tele:
            count_(s["_tdef"], cl(s["loc"]), size, full)
        s["relook"] = s["relook"] | full
        s["dep"] = torch.where(full, t + 1, s["dep"])
        if cfg.pushback:
            max_at_(s["block_until"], torch.where(full, dst_g, 0),
                    dep_abs % T, full.to(_I32) * (t + T))

    def step(s, t: int):
        h = t if per_packet_mp else flow_hash
        caps = caps_rows[t - mt0 if has_fail else t % T]
        # this slice's rows of the masks: node liveness, each ToR's whole
        # slices of clock skew and its guard-band misses
        no_t = j["node_ok"][t - mt0] if has_fail else None
        po_t = j["phase_off"][t - mt0] if has_ctrl else None
        sm_t = j["skew_miss"][t - mt0] if has_ctrl else None
        # each ToR's table version this slice (old, new or safe tables)
        vs_t = j["vsel"][t - j["vsel_t0"]] if has_vers else None
        if has_tele:
            # per-slice counters, emitted with the stats at the end; each
            # has P spill slots past its N counters (count_)
            for k in ("_tin", "_tdef", "_tdrop"):
                s[k] = torch.zeros((NB + P,), dtype=_I32, device=dev)

        # -- 0. calendar queues activating this slice leave the occupancy map
        act = (s["loc"] >= 0) & (s["dep"] == t)
        add_(s["occ"], (cl(s["loc"]) * T2 + t % T2, -size, act))

        # -- 1+2. injection & re-lookup of deferred packets (fused lookup) --
        ready = (j["t_inject"] <= t) & (s["loc"] == NOT_INJECTED)
        if has_fail:
            # a down ToR's hosts cannot inject; the packets retry next slice
            ready &= no_t[src_g]
        redo = s["relook"] & (s["loc"] >= 0) & (s["dep"] == t)
        # one lookup serves both phases: injection reads the inj table at
        # src, deferred packets read the transit table at loc; no other
        # packet's result is used. A skewed ToR reads its local slice.
        sel = (~ready).to(_I32)
        node = torch.where(ready, src_g, cl(s["loc"]))
        looked_up = ready | redo
        nxt_i, off_i = time_flow_lookup(table, None, t % Tr, sel, node, dst,
                                        h, mask=looked_up, phase_off=po_t,
                                        vsel=vs_t, hash_period=hash_period,
                                        hash_base=hbase)
        off_i = _spread_offsets(off_i, looked_up, lid)
        nxt_r, off_r = nxt_i, off_i
        if cfg.flow_pausing:
            # elephants wait for the direct circuit their source ToR
            # believes is coming (its local clock)
            if has_ctrl:
                tsrc = torch.remainder(t + po_t[src_g].to(torch.int64), T)
                fd = j["first_direct"].reshape(-1)[(tsrc * NB + src_g) * N
                                                   + dst]
            else:
                fd = j["first_direct"][t % T].reshape(-1)[src_g * N + dst]
            use_direct = is_eleph & (fd >= 0)
            nxt_i = torch.where(use_direct, dst, nxt_i)
            off_i = torch.where(use_direct, fd, off_i)
        if cfg.pushback:
            # hosts hold traffic whose target slice bucket was pushed back
            bu = s["block_until"].view(-1)
            blocked = bu[dst_g * T + (t + off_i) % T] > t
        else:
            blocked = torch.zeros_like(ready)
        inject = ready & ~blocked
        if has_tele:
            count_(s["_tin"], src_g, size, inject)
        s["loc"] = torch.where(inject, src, s["loc"])
        s["nxt"] = torch.where(inject, nxt_i, s["nxt"])
        s["dep"] = torch.where(inject, t + off_i, s["dep"])
        add_(s["occ"], (vbucket(s["loc"], t + off_i), size,
                        inject & (off_i > 0)))
        enqueue_checks(s, inject, off_i, t)
        n_blocked = total(ready & blocked)
        # deferred packets re-enter the pipeline with a fresh action
        s["nxt"] = torch.where(redo, nxt_r, s["nxt"])
        s["dep"] = torch.where(redo, t + off_r, s["dep"])
        s["relook"] = s["relook"] & ~redo
        add_(s["occ"], (vbucket(s["loc"], t + off_r), size,
                        redo & (off_r > 0)))

        # -- 3. transmission with cut-through chaining ----------------------
        used = torch.zeros((NKEY,), dtype=_I32, device=dev)
        if sh is not None:
            sync_()
        buf_now = on_switch_bytes(s["occ"], t)
        backlog_min = torch.full((NKEY,), PG, dtype=_I32, device=dev)
        rx_backlog_min = torch.full((NB,), PG, dtype=_I32, device=dev)
        resc_min = torch.full((NKEY,), PG, dtype=_I32, device=dev)
        if has_tele:
            s["_thwm"] = buf_now.clone()   # high water, maxed per hop
        for _hop in range(cfg.hops_per_slice):
            loc, nxt = s["loc"], s["nxt"]
            want = (loc >= 0) & (s["dep"] == t) & (nxt >= 0) & \
                (s["nhops"] < cfg.max_hops)
            key = cl(loc) * (N + 1) + nxt.clamp(0, N)
            if not cfg.pushback:
                # provably-rejected backlog: at or after a group's first
                # rejected index
                want &= pid < backlog_min[key]
            else:
                # push-back-aware filter: rx-subject candidates at or after
                # their receiver's first rx rejection; rx-exempt ones
                # strictly after their group's first marked rejection
                rx_subject = (nxt >= 0) & (nxt < N) & (nxt != dst)
                want &= ~(rx_subject & (pid >= rx_backlog_min[cl(nxt)]))
                want &= ~(~rx_subject & (pid > backlog_min[key]))
            # the masks' cuts come after the backlog filter: only wanted
            # rejections mark a group's backlog, so a packet cut here never
            # filters its healthy group-mates
            if has_fail:
                # the electrical fabric cannot terminate at a down ToR;
                # dead optical circuits are already capacity-zero
                want &= ~((nxt == N) & ~no_t[dst_g])
            if has_ctrl:
                # a ToR whose residual skew exceeds the guard band misses
                # its optical transmit windows this slice (§7); the
                # asynchronous electrical fabric is exempt
                want &= ~(sm_t[cl(loc)] & (nxt < N))
            if cfg.pushback:
                # FIFO admission against the receiver's remaining buffer
                need_buf = want & (nxt < N) & (nxt != dst)
                adm_rx, _ = admit(
                    cl(nxt), need_buf, lambda: (cfg.switch_buffer - buf_now)
                    .clamp(min=0).to(_I32), NB)
                rej_rx = need_buf & ~adm_rx
                min_at_(rx_backlog_min, torch.where(rej_rx, cl(nxt), 0),
                        torch.where(rej_rx, pid, PG))
                want &= adm_rx | ~need_buf
            admitted, consumed = admit(key, want, lambda: caps - used, NKEY)
            if sh is None:
                used = used + consumed
            else:
                defer_(used, consumed)

                # ownership trace: the rank that admitted each packet
                s["adm_shard"] = torch.where(admitted, sh.rank,
                                             s["adm_shard"])
            if not cfg.pushback:
                rejected = want & ~admitted
                min_at_(backlog_min, torch.where(rejected, key, 0),
                        torch.where(rejected, pid, PG))
            else:
                resc = need_buf & adm_rx & ~admitted
                min_at_(resc_min, torch.where(resc, key, 0),
                        torch.where(resc, pid, PG))
                if sh is not None:
                    sync_min_()      # markable reads the group's resc_min
                markable = want & ~admitted & ~need_buf & \
                    (pid < resc_min[key])
                min_at_(backlog_min, torch.where(markable, key, 0),
                        torch.where(markable, pid, PG))
            is_elec = admitted & (nxt == N)
            moved = admitted & ~is_elec
            newloc = torch.where(moved, nxt, loc)
            at_dst = (moved & (nxt == dst)) | is_elec
            # the electrical fabric delivers with a one-slice transit delay
            s["t_del"] = torch.where(at_dst, is_elec.to(_I32) + t, s["t_del"])
            # reorder accounting against the flows' delivered high water
            prev = s["max_seq"][flow_g]
            s["reorder"] = s["reorder"] + total(at_dst & (seq < prev))
            s["max_seq"].scatter_reduce_(
                0, torch.where(at_dst, flow_g, 0).to(torch.int64),
                torch.where(at_dst, seq, -1), "amax", include_self=True)
            if sh is not None:
                # max-reduced at the next read; reorder stays a partial
                # count a rank, summed at the run's end
                pend_min[id(s["max_seq"])] = (s["max_seq"], True)
            s["loc"] = torch.where(at_dst, DELIVERED, newloc)
            s["nhops"] = s["nhops"] + admitted.to(_I32)
            # transit lookup at the new node
            in_transit = moved & ~at_dst
            node_t = cl(s["loc"])
            nxt_t, off_t = time_flow_lookup(table, None, t % Tr, 1, node_t,
                                            dst, h, mask=in_transit,
                                            phase_off=po_t, vsel=vs_t,
                                            hash_period=hash_period,
                                            hash_base=hbase)
            off_t = _spread_offsets(off_t, in_transit, lid)
            s["nxt"] = torch.where(in_transit, nxt_t, s["nxt"])
            s["dep"] = torch.where(in_transit, t + off_t, s["dep"])
            # buffer-overflow drops on arrival; a rejection also pushes the
            # sender back (§5.2)
            add_(buf_now, (node_t, size, in_transit))
            if sh is not None:
                sync_()
            overflow = in_transit & (buf_now[node_t] > cfg.switch_buffer)
            if cfg.pushback:
                max_at_(s["block_until"], torch.where(overflow, dst_g, 0),
                        s["dep"] % T, overflow.to(_I32) * (t + T))
            if has_tele:
                torch.maximum(s["_thwm"], buf_now, out=s["_thwm"])
                count_(s["_tdrop"], node_t, size, overflow)
            s["loc"] = torch.where(overflow, DROPPED, s["loc"])
            arrived = in_transit & ~overflow
            add_(s["occ"], (vbucket(s["loc"], t + off_t), size,
                            arrived & (off_t > 0)))
            enqueue_checks(s, arrived, off_t, t)

        # -- 4. packets that missed their slice ------------------------------
        missed = (s["loc"] >= 0) & (s["dep"] == t)
        miss_cnt = total(missed)
        bump = t + 1 if cfg.cc_detect else t + T  # paused a cycle (§5.2)
        if cfg.cc_detect:
            s["relook"] = s["relook"] | missed
        add_(s["occ"], (cl(s["loc"]) * T2 + bump % T2, size, missed))
        if has_tele:
            count_(s["_tdef"], cl(s["loc"]), size, missed)
        s["dep"] = torch.where(missed, bump, s["dep"])
        if cfg.pushback:
            max_at_(s["block_until"], dst_g, torch.full_like(dst, t % T),
                    missed.to(_I32) * (t + T))

        # -- 5. per-slice stats (row sums of the occupancy map) --------------
        delivered = total(torch.where(s["t_del"] == t, size, 0))
        dropped = total(s["loc"] == DROPPED)
        if sh is not None:
            # the slice's counts and counters, summed with the occupancy's
            # last deltas and the minima read at the next slice
            # (block_until); this slice's backlog cuts dropped
            for m in (backlog_min, rx_backlog_min, resc_min):
                pend_min.pop(id(m), None)
            counts = [torch.stack([n_blocked, miss_cnt, delivered, dropped])]
            if has_tele:
                counts += [s[k][:NB] for k in ("_tin", "_tdef", "_tdrop")]
            red = torch.cat(sync_(*counts))
            n_blocked, miss_cnt, delivered, dropped = red[:4]
            if has_tele:
                for i, k in enumerate(("_tin", "_tdef", "_tdrop")):
                    s[k][:NB] = red[4 + i * NB:4 + (i + 1) * NB]
        on_sw = on_switch_bytes(s["occ"], t)
        if cfg.offload:
            off_sw = s["occ"].view(NB, T2).sum(1).to(_I32) - on_sw
        else:
            off_sw = torch.zeros_like(on_sw)
        stats = dict(
            delivered_bytes=delivered, dropped=dropped,
            buf_bytes=on_sw, offl_bytes=off_sw,
            blocked_inj=n_blocked, slice_miss=miss_cnt,
        )
        if has_tele:
            # circuit utilization: optical bytes moved vs granted per
            # source switch (the electrical column N left out); delivered
            # rows and the latency histogram come from the final state
            # (_tele_delivery_rows)
            stats.update(
                tele_injected=s["_tin"][:NB], tele_deferred=s["_tdef"][:NB],
                tele_dropped=s["_tdrop"][:NB],
                tele_qhwm=torch.maximum(s["_thwm"], on_sw),
                tele_util_used=used.view(NB, N + 1)[:, :N].sum(1).to(_I32),
                tele_util_cap=caps.view(NB, N + 1)[:, :N].sum(1).to(_I32))
        return stats

    return step


_STAT_SHAPES = dict(delivered_bytes=(), dropped=(), buf_bytes=None,
                    offl_bytes=None, blocked_inj=(), slice_miss=())
# the per-slice telemetry rows the step emits ([N] each)
_TELE_STEP_KEYS = ("tele_injected", "tele_deferred", "tele_dropped",
                   "tele_qhwm", "tele_util_used", "tele_util_cap")


def _tele_delivery_rows(final, j, telemetry: TelemetryConfig,
                        num_slices: int, t0: int = 0):
    """Per-slice delivered rows ``[S, N]`` and latency histogram ``[S, B]``
    of the window of ``num_slices`` slices from absolute slice ``t0``, from
    the packet state at its end (the reference's ``_tele_delivery_rows``):
    ``t_del`` is written once, so one scatter over the packets equals
    accumulating ``t_del == t`` rows slice by slice. A delivery outside
    ``[t0, t0 + num_slices)`` (in an earlier window, or an electrical one
    landing after the window) scatters nothing. In a scenario sweep the
    rows are ``[S, B·N]`` and the histogram ``[S, B·buckets]``, scenario
    by scenario."""
    NB = j["conn"].shape[1]
    B = j.get("num_scenarios", 1)
    N = NB // B
    nbk = telemetry.num_buckets
    dev = final["t_del"].device
    rows = torch.zeros((num_slices, NB), dtype=_I32, device=dev)
    hist = torch.zeros((num_slices, B * nbk), dtype=_I32, device=dev)
    if num_slices == 0:
        return rows, hist
    t_del = final["t_del"]
    rel = t_del - t0
    ok = (rel >= 0) & (rel < num_slices)
    relc = rel.clamp(0, num_slices - 1).to(torch.int64)
    dst = j["dst"].clamp(0, N - 1).to(torch.int64)
    if B > 1:
        dst = dst + j["scen"] * N
    rows.view(-1).index_add_(0, relc * NB + dst,
                             torch.where(ok, j["size"], 0))
    # bucket i counts latencies in (edges[i-1], edges[i]]; the last is
    # overflow
    edges = torch.tensor(telemetry.lat_edges, dtype=_I32, device=dev)
    lat = (t_del - j["t_inject"]).clamp(min=0)
    bucket = torch.searchsorted(edges, lat, right=False)
    if B > 1:
        bucket = bucket + j["scen"] * nbk
    hist.view(-1).index_add_(0, relc * (B * nbk) + bucket, ok.to(_I32))
    if "shard" in j:
        # each rank scattered its own block of the packets
        exchange_sum(rows, j["shard"].group)
        exchange_sum(hist, j["shard"].group)
    return rows, hist


def _window_out(final, ys: list, j, telemetry: TelemetryConfig | None,
                num_slices: int, t0: int) -> dict:
    """A window's per-slice rows as host numpy (``[num_slices, ...]``
    each): the step's stats, stacked on the device and copied to the host
    once per key; with telemetry also the ``tele_*`` rows, the delivered
    rows and latency histogram from the packet state at the window's
    end."""
    N = j["conn"].shape[1]
    B = j.get("num_scenarios", 1)
    dev = final["loc"].device
    out = {}
    shapes = {k: (B,) if v == () and B > 1 else v
              for k, v in _STAT_SHAPES.items()}
    if telemetry is not None:
        shapes.update(dict.fromkeys(_TELE_STEP_KEYS))
        out["tele_delivered"], out["tele_lat_hist"] = _tele_delivery_rows(
            final, j, telemetry, num_slices, t0)
    for k, shape in shapes.items():
        if ys:
            out[k] = torch.stack([y[k] for y in ys])
        else:
            out[k] = torch.zeros((0,) + ((N,) if shape is None else shape),
                                 dtype=_I32, device=dev)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _i32(a, dev):
    return torch.tensor(np.asarray(a, np.int32), device=dev)


def _table_arrays(tables: FabricTables, dev) -> dict:
    """The schedule and tables as tensors on ``dev``."""
    return {k: _i32(getattr(tables, k), dev) for k in _TABLE_FIELDS}


def _packet_arrays(wl: Workload, dev) -> dict:
    """The workload's fields as tensors on ``dev`` (copies: the step never
    writes to the caller's arrays)."""
    return {f.name: (torch.tensor(np.asarray(wl.is_eleph, bool), device=dev)
                     if f.name == "is_eleph" else
                     _i32(getattr(wl, f.name), dev))
            for f in dataclasses.fields(Workload)}


def _device_arrays(tables: FabricTables, wl: Workload, dev) -> dict:
    """The schedule, tables and workload as tensors on ``dev``."""
    return _table_arrays(tables, dev) | _packet_arrays(wl, dev)


def _stack_nodes(xs):
    """Per-scenario ``[R, N, ...]`` tensors as one ``[R, B·N, ...]``,
    scenario-major on the node axis (one tensor stays as it is)."""
    if len(xs) == 1:
        return xs[0]
    x = torch.stack(xs, dim=1)
    return x.reshape(x.shape[0], -1, *x.shape[3:]).contiguous()


def _add_masks(j, failures, control, num_slices: int) -> None:
    """Check that the masks cover the window and add them to ``j`` as
    tensors on its device (``None`` adds nothing). In a scenario sweep
    (``j["num_scenarios"]`` B > 1) each is a list of B mask sets, checked
    against one scenario's N and stacked on the node axis."""
    B = j.get("num_scenarios", 1)
    N = j["conn"].shape[1] // B
    dev = j["conn"].device
    each = lambda m: list(m) if isinstance(m, (list, tuple)) else [m]

    def stack(ms, field, dtype):
        return _stack_nodes([torch.as_tensor(getattr(m, field), dtype=dtype,
                                             device=dev) for m in ms])
    if failures is not None:
        fl = each(failures)
        for m in fl:
            m.validate(num_slices, N)
        j["link_cap"] = stack(fl, "link_cap", torch.float32)
        j["node_ok"] = stack(fl, "node_ok", torch.bool)
    if control is not None:
        cl = each(control)
        for m in cl:
            m.validate(num_slices, N)
        j["phase_off"] = stack(cl, "phase_off", _I32).contiguous()
        j["skew_miss"] = stack(cl, "skew_miss", torch.bool)


def _mask_window(failures, control, t0: int, t1: int):
    """Rows ``[t0, t1)`` of masks that cover a whole run, as that window's
    own masks (``None`` stays ``None``)."""
    if failures is not None:
        failures = dataclasses.replace(
            failures, link_cap=failures.link_cap[t0:t1],
            node_ok=failures.node_ok[t0:t1])
    if control is not None:
        control = dataclasses.replace(control, **{
            k: getattr(control, k)[t0:t1] for k in (
                "skew_ns", "phase_off", "skew_miss", "ctrl_delay",
                "ctrl_ok")})
    return failures, control


# ---------------------------------------------------------------------------
# incremental runs: the run split into windows, the state carried across
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FabricState:
    """A run between windows (the reference's ``FabricState``).

    ``j`` holds the deployed tables and the packets ingested so far, as
    tensors on one device and without masks (a window's masks are its
    own); ``state`` is the packet and queue state the step leaves;
    ``clock`` is the absolute slice the next window starts at; ``chunks``
    holds each window's per-slice rows as host numpy, which
    :func:`finalize` joins."""

    j: dict
    state: dict
    cfg: FabricConfig
    telemetry: TelemetryConfig | None
    per_packet_mp: bool
    num_flows: int
    clock: int = 0
    chunks: list = dataclasses.field(default_factory=list)

    @property
    def num_nodes(self) -> int:
        return int(self.j["conn"].shape[1])

    @property
    def num_packets(self) -> int:
        return int(self.j["src"].shape[0])

    @property
    def device(self) -> torch.device:
        return self.j["src"].device


def _num_flows(wl: Workload) -> int:
    return int(max(wl.flow.max() + 1, 1)) if wl.num_packets else 1


def init_state(tables: FabricTables, wl: Workload | None, cfg: FabricConfig,
               telemetry: TelemetryConfig | None = None,
               device=None) -> FabricState:
    """Open an incremental run: the deployed tables and the first packets
    (``None`` for an empty fabric; :func:`ingest` adds packets later), on
    ``device`` (CUDA by default; ``"cpu"`` for the plain versions)."""
    dev = resolve_device(device)
    if wl is None:
        wl = Workload(**{f.name: np.zeros((0,), bool if f.name == "is_eleph"
                                          else np.int32)
                         for f in dataclasses.fields(Workload)})
    j = _device_arrays(tables, wl, dev)
    num_flows = _num_flows(wl)
    return FabricState(j=j, state=_init_state(j, num_flows), cfg=cfg,
                       telemetry=telemetry,
                       per_packet_mp=tables.multipath == "packet",
                       num_flows=num_flows)


def ingest(fs: FabricState, wl: Workload) -> FabricState:
    """Join new packets to a live run. ``wl.t_inject`` and ``wl.flow`` are
    absolute: inject slices already past fire at the next slice, and a
    flow id in use continues that flow's in-order tracking
    (:meth:`repro_torch.core.net.OpenOpticsNet.ingest` shifts both)."""
    P = wl.num_packets
    if P == 0:
        return fs
    dev = fs.device
    for k, v in _packet_arrays(wl, dev).items():
        fs.j[k] = torch.cat([fs.j[k], v])
    s = fs.state
    for k, fill in (("loc", NOT_INJECTED), ("nxt", -1), ("dep", 0),
                    ("nhops", 0), ("t_del", -1)):
        s[k] = torch.cat([s[k], torch.full((P,), fill, dtype=_I32,
                                           device=dev)])
    s["relook"] = torch.cat([s["relook"], torch.zeros((P,), dtype=torch.bool,
                                                      device=dev)])
    nf = _num_flows(wl)
    if nf > fs.num_flows:
        s["max_seq"] = torch.cat([s["max_seq"], torch.full(
            (nf - fs.num_flows,), -1, dtype=_I32, device=dev)])
        fs.num_flows = nf
    return fs


_VERSION_KEYS = ("tf_next_v", "tf_dep_v", "inj_next_v", "inj_dep_v")


def _add_versions(j, versions: dict, num_slices: int) -> None:
    """Check a window's versioned tables and version select and add them
    to ``j`` (see :func:`step_slices`). In a scenario sweep the node rows
    are the B·N rows of ``j["conn"]`` and the destinations a scenario's
    N."""
    if set(versions) != set(_VERSION_KEYS) | {"vsel"}:
        raise ValueError(f"versions must hold {_VERSION_KEYS} and 'vsel', "
                         f"got {sorted(versions)}")
    NB = j["conn"].shape[1]
    N = NB // j.get("num_scenarios", 1)
    V, Tr = versions["tf_next_v"].shape[:2]
    for k in _VERSION_KEYS:
        x = versions[k]
        if x.dim() != 5 or tuple(x.shape[:3]) != (V, Tr, NB) \
                or x.shape[3] != N or x.dtype != _I32:
            raise ValueError(f"versions[{k!r}] must be int32 [V, Tr, {NB}, "
                             f"{N}, K] with V={V}, Tr={Tr}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    vsel = versions["vsel"]
    if vsel.dtype != _I32 or tuple(vsel.shape) != (num_slices, NB):
        raise ValueError(f"versions['vsel'] must be int32 [{num_slices}, "
                         f"{NB}], got {vsel.dtype} {tuple(vsel.shape)}")
    j.update(versions)
    j["vsel"] = vsel.contiguous()


def step_slices(fs: FabricState, num_slices: int, failures=None,
                control=None, versions: dict | None = None) -> FabricState:
    """Advance the run ``num_slices`` slices from its clock.

    ``failures`` / ``control`` cover this window only (``[num_slices,
    ...]`` rows, row 0 the clock's slice; in a scenario sweep a list, one
    per scenario); each adds its branches to this window's step only when
    given, as in :func:`simulate`. ``versions``
    gives the window versioned tables in place of the deployed ones (the
    reconfigure loop's installs): ``tf_next_v``, ``tf_dep_v``,
    ``inj_next_v``, ``inj_dep_v`` (``[V, Tr, N, N, K]`` int32 tensors on
    the run's device) and ``vsel`` (``[num_slices, N]`` int32: the version
    each ToR reads in each slice of the window). The state
    carries on from the last window, so a run split into any windows
    equals the one-shot run. The step is built anew for each window: the
    packet count it captures grows with :func:`ingest`."""
    n = int(num_slices)
    if n < 0:
        raise ValueError(f"num_slices must be >= 0, got {num_slices}")
    t0 = fs.clock
    jw = dict(fs.j)
    _add_masks(jw, failures, control, n)
    if failures is not None or control is not None:
        jw["mask_t0"] = t0
    if versions is not None:
        _add_versions(jw, versions, n)
        jw["vsel_t0"] = t0
    step = _make_step(jw, fs.cfg, fs.per_packet_mp, fs.telemetry)
    ys = [step(fs.state, t) for t in range(t0, t0 + n)]
    fs.chunks.append(_window_out(fs.state, ys, jw, fs.telemetry, n, t0))
    fs.clock += n
    return fs


def _final_out(fs: FabricState) -> dict:
    """The result fields of the windows run so far, host numpy. A rank of a
    sharded run gathers every rank's block of the packet fields (and
    ``adm_shard``, the ownership trace) and sums the partial reorder
    counts."""
    chunks = fs.chunks or [_window_out(fs.state, [], fs.j, fs.telemetry, 0,
                                       fs.clock)]
    s = fs.state
    per = dict(t_deliver=s["t_del"], loc_final=s["loc"], nhops=s["nhops"],
               reorder_cnt=s["reorder"])
    sh = fs.j.get("shard")
    if sh is not None:
        per["adm_shard"] = s["adm_shard"]
        per = {k: exchange_sum(v.reshape(1).clone(), sh.group).reshape(())
               if k == "reorder_cnt" else
               gather_node_row(v, v.shape[0] * sh.size, sh.group, sh.rank,
                               sh.size)
               for k, v in per.items()}
    out = {k: v.cpu().numpy() for k, v in per.items()}
    out.update({k: np.concatenate([c[k] for c in chunks])
                for k in chunks[0]})
    return out


def finalize(fs: FabricState) -> SimResult:
    """The :class:`SimResult` of the windows run so far, as the one-shot
    :func:`simulate` would return it. The run stays live, so this may be
    called as a checkpoint between windows."""
    out = _final_out(fs)
    tele = counters_from_out(out, fs.telemetry)
    return SimResult(**out, telemetry=tele)


def simulate(tables: FabricTables, wl: Workload, cfg: FabricConfig,
             num_slices: int, failures=None, control=None, telemetry=None,
             device=None) -> SimResult:
    """Run the fabric for ``num_slices`` slices (the reference's
    ``simulate``): one window of the incremental API.

    Args:
        tables: deployed state (host numpy; see :class:`FabricTables`).
        wl: the packet workload (host numpy; see :class:`Workload`).
        cfg: static fabric parameters.
        num_slices: slices to run (the schedule cycle wraps as needed).
        failures: optional :class:`repro_torch.core.failures.FailureMasks`
            covering the run (``[num_slices, N, N]`` link capacities,
            ``[num_slices, N]`` ToR liveness; numpy or torch). Dead and
            degraded circuits admit less (nothing, when dead), so their
            packets miss the slice and re-enqueue through the §5.2
            machinery; a down ToR neither injects nor terminates
            electrical transfers.
        control: optional :class:`repro_torch.core.controlplane.ControlMasks`
            covering the run. A ToR skewed by whole slices (``phase_off``)
            reads its time-flow tables at its *local* slice; a ToR whose
            residual offset exceeds the guard band (``skew_miss``) misses
            its optical transmit windows that slice (the electrical
            fabric is exempt).
        telemetry: optional :class:`repro_torch.core.telemetry
            .TelemetryConfig`: per-ToR per-slice counters come back as
            ``SimResult.telemetry``; every other field is unchanged.
        device: where to run: CUDA by default, through the hand-written
            kernels; ``"cpu"`` runs their plain versions.

    Mask shapes that do not cover the run raise ``ValueError``. Each
    optional input that is ``None`` leaves its branches out of the step.
    Returns a :class:`SimResult` of host numpy arrays.
    """
    fs = init_state(tables, wl, cfg, telemetry, device)
    return finalize(step_slices(fs, num_slices, failures, control))


def simulate_incremental(tables: FabricTables, wl: Workload,
                         cfg: FabricConfig, num_slices: int,
                         window: int | None = None, failures=None,
                         control=None,
                         telemetry: TelemetryConfig | None = None,
                         device=None) -> SimResult:
    """:func:`simulate` replayed through the incremental API in windows of
    ``window`` slices (default: one window), each window given its rows of
    the run's masks. Equal to the one-shot run in every field and
    counter."""
    window = num_slices if window is None else int(window)
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    N = tables.conn.shape[1]
    if failures is not None:
        failures.validate(num_slices, N)
    if control is not None:
        control.validate(num_slices, N)
    fs = init_state(tables, wl, cfg, telemetry, device)
    while fs.clock < num_slices:
        t0 = fs.clock
        t1 = min(t0 + window, num_slices)
        step_slices(fs, t1 - t0, *_mask_window(failures, control, t0, t1))
    return finalize(fs)


# ---------------------------------------------------------------------------
# scenario sweeps: B scenarios through one step a slice
# ---------------------------------------------------------------------------

def _fleet_arrays(tabs, wls, failures, control, num_flows: int,
                  num_slices: int, dev) -> dict:
    """The step's inputs for a scenario sweep, scenario-major (see
    :func:`_make_step`): each scenario's tensors as :func:`simulate` builds
    them (masks checked against ``num_slices``), its packets a block of the
    packet axis and its rows a block of every node axis."""
    B, P = len(wls), wls[0].num_packets
    tab = {}            # a table set shared by scenarios is converted once
    for t in tabs:
        if id(t) not in tab:
            tab[id(t)] = _table_arrays(t, dev)
    j = {k: _stack_nodes([tab[id(t)][k] for t in tabs])
         for k in _TABLE_FIELDS}
    per = [_packet_arrays(w, dev) for w in wls]
    j.update({k: torch.cat([pw[k] for pw in per]) for k in per[0]})
    j["num_scenarios"], j["scen_flows"] = B, num_flows
    j["scen"] = torch.arange(B, dtype=_I32, device=dev).repeat_interleave(P)
    _add_masks(j, failures, control, num_slices)
    return j


def _scenario_out(out: dict, b: int, B: int) -> dict:
    """Scenario ``b``'s fields of a sweep's result fields: its block of
    every packet, node and histogram axis, its column of every per-slice
    count."""
    res = {}
    for k, v in out.items():
        if k == "reorder_cnt":                    # [B]
            res[k] = np.array(v.reshape(-1)[b], dtype=v.dtype)
        elif k in ("t_deliver", "loc_final", "nhops"):    # [B·P]
            res[k] = v.reshape(B, -1)[b].copy()
        elif _STAT_SHAPES.get(k) == ():           # [S, B] counts
            res[k] = v.reshape(-1, B)[:, b].copy()
        else:                                     # [S, B·X] rows
            res[k] = v.reshape(v.shape[0], B, -1)[:, b].copy()
    return res


def simulate_fleet(tables, wls, cfg: FabricConfig, num_slices: int,
                   failures=None, control=None,
                   telemetry: TelemetryConfig | None = None,
                   device=None) -> list[SimResult]:
    """Run a scenario sweep through one step a slice (the reference's
    ``simulate_fleet``): every launch of a slice carries all B scenarios,
    so a slice costs about the launches of one scenario. Each result equals
    :func:`simulate` of its scenario in every field and counter.

    Args:
        tables: one :class:`FabricTables` shared by every scenario, or a
            list (one per scenario) whose tables share shapes and
            multipath mode.
        wls: list of :class:`Workload`, all with the same packet count
            (``num_flows`` is the largest over the scenarios).
        cfg, num_slices, telemetry, device: as :func:`simulate`.
        failures / control: ``None``, or one mask set per scenario (no
            ``None`` entries: presence adds branches to the one step, so it
            must agree across the sweep; pass ``FailureMasks.healthy`` /
            ``ControlMasks.perfect`` for clean scenarios).

    Returns one :class:`SimResult` per scenario, in order.
    """
    dev = resolve_device(device)
    B = len(wls)
    if B == 0:
        return []
    tabs = list(tables) if isinstance(tables, (list, tuple)) else [tables] * B
    if len(tabs) != B:
        raise ValueError(f"{len(tabs)} tables for {B} workloads")
    if any(t.multipath != tabs[0].multipath for t in tabs):
        raise ValueError("fleet tables must share a multipath mode (it is a "
                         "static branch)")
    for k in _TABLE_FIELDS:
        shapes = sorted({np.shape(getattr(t, k)) for t in tabs})
        if len(shapes) != 1:
            raise ValueError(f"fleet tables must share shapes, got {shapes} "
                             f"for {k}")
    counts = {w.num_packets for w in wls}
    if len(counts) != 1:
        raise ValueError(f"fleet workloads must share a packet count, got "
                         f"{sorted(counts)}")
    for name, masks in (("failures", failures), ("control", control)):
        if masks is not None and (len(masks) != B
                                  or any(m is None for m in masks)):
            raise ValueError(
                f"{name} must be one mask set per scenario (mask presence "
                "is a static branch; use FailureMasks.healthy / "
                "ControlMasks.perfect for clean scenarios)")
    num_flows = max(_num_flows(w) for w in wls)
    j = _fleet_arrays(tabs, wls, failures, control, num_flows, num_slices,
                      dev)
    fs = FabricState(j=j, state=_init_state(j, B * num_flows), cfg=cfg,
                     telemetry=telemetry,
                     per_packet_mp=tabs[0].multipath == "packet",
                     num_flows=B * num_flows)
    out = _final_out(step_slices(fs, num_slices))
    results = []
    for b in range(B):
        ob = _scenario_out(out, b, B)
        tele = counters_from_out(ob, telemetry)
        results.append(SimResult(**ob, telemetry=tele))
    return results


# ---------------------------------------------------------------------------
# sharded runs: the packets split over torch.distributed ranks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Shard:
    """A rank of a sharded run, as the step reads it from ``j["shard"]``:
    its rank and the shard count in ``group`` (``None``: the default
    process group)."""

    rank: int
    size: int
    group: object = None


def _host(a, dtype):
    """Host numpy of a mask field (numpy, or a torch tensor anywhere)."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, dtype)


# the padding of a packet block: packets that inject after the run ends
_PACKET_FILL = dict(src=0, dst=0, size=0, flow=0, seq=0, is_eleph=False)
# seconds a sharded run, and each of its collectives, may take
SHARD_TIMEOUT_S = 1800.0


def simulate_shard(tables: FabricTables, wl: Workload, cfg: FabricConfig,
                   num_slices: int, failures=None, control=None,
                   telemetry: TelemetryConfig | None = None,
                   with_debug: bool = False, device=None, group=None):
    """The body of :func:`simulate_sharded`, for a caller already in a
    process group (``torch.distributed.init_process_group``; for example
    one process a card under ``torchrun``): every rank of ``group`` (the
    default group when ``None``) calls it with the whole inputs and runs
    the step over its own block. Every rank returns the whole result
    (and with ``with_debug`` the debug dict), as :func:`simulate_sharded`
    describes. Rank ``r`` runs on ``cuda:(r % device_count)`` unless
    ``device`` names another device (``"cpu"``: the plain versions)."""
    group, D = sharding.fabric_group(None, group)
    r = dist.get_rank(group)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    N = tables.conn.shape[1]
    P = wl.num_packets
    Pl = sharding.block_len(P, D)
    NL = sharding.block_len(N, D)
    if failures is not None:
        failures.validate(num_slices, N)
    if control is not None:
        control.validate(num_slices, N)
    # this rank's block of the packets, padded with packets that never act
    fill = dict(_PACKET_FILL, t_inject=num_slices)
    block = Workload(**{
        f.name: sharding.pad_packet_axis(
            np.asarray(getattr(wl, f.name),
                       bool if f.name == "is_eleph" else np.int32),
            D, fill[f.name])[r * Pl:(r + 1) * Pl]
        for f in dataclasses.fields(Workload)})
    j = _device_arrays(tables, block, dev)
    j["shard"] = _Shard(r, D, group)

    def own_rows(a, fill, dtype):
        """This rank's rows of a mask field, on the device."""
        rows = sharding.pad_node_rows(_host(a, dtype), D, fill)
        return torch.as_tensor(rows[:, r * NL:(r + 1) * NL], device=dev)

    def whole_rows(a, fill, dtype):
        """A mask field's whole rows gathered from the ranks' own rows,
        once a run."""
        return gather_node_row(own_rows(a, fill, dtype), N, group, r, D,
                               axis=1).contiguous()
    if failures is not None:
        j["link_cap"] = own_rows(failures.link_cap, 1.0, np.float32)
        j["node_ok"] = whole_rows(failures.node_ok, True, bool)
    if control is not None:
        j["phase_off"] = whole_rows(control.phase_off, 0, np.int32)
        j["skew_miss"] = whole_rows(control.skew_miss, False, bool)
    num_flows = _num_flows(wl)
    state = _init_state(j, num_flows)
    state["adm_shard"] = torch.full_like(state["loc"], -1)
    fs = FabricState(j=j, state=state, cfg=cfg, telemetry=telemetry,
                     per_packet_mp=tables.multipath == "packet",
                     num_flows=num_flows)

    def counts():
        return (lookup_mod.launches, admission_mod.launches,
                collectives.exchanges, collectives.exchanged_bytes)
    counts0 = counts()
    t0 = time.perf_counter()
    step_slices(fs, num_slices)
    used = [a - b for a, b in zip(counts(), counts0)]
    out = _final_out(fs)
    run_s = time.perf_counter() - t0
    adm_shard = out.pop("adm_shard")[:P]
    for k in ("t_deliver", "loc_final", "nhops"):
        out[k] = out[k][:P]            # the block padding dropped
    tele = counters_from_out(out, telemetry)
    res = SimResult(**out, telemetry=tele)
    if with_debug:
        # every rank's kernel launches in the run
        launches = gather_node_row(torch.tensor([used[:2]], device=dev), D,
                                   group, r, D).cpu().numpy()
        return res, dict(adm_shard=adm_shard,
                         owner=sharding.shard_owner(np.arange(P), P, D),
                         num_shards=D, packet_block=Pl, launches=launches,
                         exchanges=used[2], exchanged_bytes=used[3],
                         run_s=run_s)
    return res


def simulate_sharded(tables: FabricTables, wl: Workload, cfg: FabricConfig,
                     num_slices: int, num_shards: int | None = None,
                     failures=None, control=None,
                     telemetry: TelemetryConfig | None = None,
                     with_debug: bool = False, device=None, backend=None):
    """Run :func:`simulate` sharded over ``num_shards`` ranks of a new
    ``torch.distributed`` process group (the reference's
    ``simulate_sharded``), called from one process. Equal to
    :func:`simulate` in every field and counter.

    The packets are split in contiguous global-index blocks (padded with
    packets that never inject when the count does not divide), the
    failure and control masks by owned ToR rows (a rank holds
    ``ceil(N / D)`` rows of ``link_cap``); every per-ToR aggregate stays
    replicated, each update exchanged by an all-reduce
    (:mod:`repro_torch.distributed.collectives`).

    Args:
        tables, wl, cfg, num_slices, failures, control, telemetry: as
            :func:`simulate`.
        num_shards: ranks (default: the visible CUDA cards; 1 on the CPU).
            Any count works, including counts that divide neither the ToR
            nor the packet count.
        with_debug: also return the debug dict of
            :func:`repro_torch.core.toolkit.check_sharding`: ``adm_shard``
            (the rank that admitted each packet in the hop phase, -1
            never), ``owner`` (the rank owning each packet's block),
            ``num_shards``, ``packet_block``; and what the run cost:
            ``launches`` (``[D, 2]``: each rank's lookup and admission
            kernel launches), ``exchanges`` and ``exchanged_bytes`` (rank
            0's all-reduces and their bytes), ``run_s`` (rank 0's seconds
            from the first slice to the gathered result).
        device: CUDA by default (rank ``r`` on card ``r % device_count``;
            the kernels are built here, once, before the ranks start);
            ``"cpu"`` runs the plain versions over gloo.
        backend: ``None`` picks ``"nccl"`` when every rank has a card of
            its own and raises when ranks would share one: name
            ``"gloo"`` for that (NCCL refuses it). Never switched
            silently.

    The ranks are spawned (:func:`repro_torch.distributed.spawn.run_ranks`)
    and rank 0's result is returned; a rank that fails, or a run or a
    collective that outlives ``SHARD_TIMEOUT_S`` seconds, fails the call.
    Callers already in a process group call :func:`simulate_shard` on
    every rank instead.
    """
    dev = resolve_device(device)
    if num_shards is None:
        num_shards = torch.cuda.device_count() if dev.type == "cuda" else 1
    D = int(num_shards)
    if D < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    backend = choose_backend(D, dev.type, backend)
    N = tables.conn.shape[1]
    if failures is not None:
        failures.validate(num_slices, N)
    if control is not None:
        control.validate(num_slices, N)
    if dev.type == "cuda":
        _build.build(["time_flow_lookup", "admission"])
    return run_ranks(simulate_shard,
                     (tables, wl, cfg, num_slices, failures, control,
                      telemetry, with_debug, "cpu" if dev.type == "cpu"
                      else None), D, backend, dev.type, SHARD_TIMEOUT_S)
