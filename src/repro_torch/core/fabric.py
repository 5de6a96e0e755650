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
  plain versions.
* Aggregates (occupancy map, ``block_until``, ``max_seq``, backlog minima)
  are updated in place with ``index_add_`` / ``scatter_reduce_``; the
  per-packet fields are replaced as in the reference.
* The uint32 hashes run in int64 masked to 32 bits (this torch has no
  ``>>``, ``%`` or ``+`` on uint32), with the multiplies split into 16-bit
  halves so no product leaves int64's range.
* The reference's ``failures``, ``control`` and ``telemetry`` inputs, its
  versioned tables, and its sharded, batched and incremental entry points
  are not ported yet (ROADMAP Queue 1 items 4, 5 and 9).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.admission import admission_admit
from ..kernels.time_flow_lookup import time_flow_lookup
from .routing import CompiledRouting, first_direct_offsets
from .topology import Schedule

__all__ = ["FabricConfig", "Workload", "FabricTables", "SimResult",
           "simulate", "tables_from_arrays", "workload_from_arrays",
           "resolve_device"]

NOT_INJECTED = -1
DELIVERED = -2
DROPPED = -3

MASK32 = 0xFFFFFFFF
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
    """The reference's ``SimResult`` (without telemetry): numpy arrays of
    the same shapes and dtypes, all int32."""

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

def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32): the constant is
    split into 16-bit halves so no product exceeds 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _hash32(x):
    """The reference's ``_hash32`` on int64 tensors: the low 32 bits of
    ``x`` in, an int64 in [0, 2**32) out."""
    x = x & MASK32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _as_bits(x):
    """An int64 in [0, 2**32) as the int32 with the same 32-bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(_I32)


def _salted_hash(base, t: int):
    """The multipath hash of slice ``t``, ``hash32(base + t * 0x9E3779B9)``
    in uint32 arithmetic, as int32 bits; ``base`` is an int64 tensor."""
    return _as_bits(_hash32(base + ((t * 0x9E3779B9) & MASK32)))


def _build_caps_all(conn, cfg: FabricConfig, N: int):
    """Per-circuit capacity for every slice of the cycle ``[T, N*(N+1)]``,
    keyed loc*(N+1)+peer; key loc*(N+1)+N is the electrical egress."""
    T, _, U = conn.shape
    caps = torch.zeros((T, N * (N + 1)), dtype=_I32, device=conn.device)
    rows = torch.arange(N, dtype=torch.int64, device=conn.device)[None, :]
    trows = torch.arange(T, dtype=torch.int64, device=conn.device)[:, None]
    flat = caps.view(-1)
    for k in range(U):
        peer = conn[:, :, k].to(torch.int64)                   # [T, N]
        keyk = rows * (N + 1) + torch.where(peer >= 0, peer, N)
        add = (peer >= 0).to(_I32) * cfg.slice_bytes
        flat.index_add_(0, (trows * (N * (N + 1)) + keyk).reshape(-1),
                        add.reshape(-1))
    caps[:, torch.arange(N, device=conn.device) * (N + 1) + N] += cfg.elec_bytes
    return caps


def _pad_k(a, K: int, fill: int):
    """Pad the slot axis of ``[Tr, N, D, k]`` tables to K with ``fill``."""
    if a.shape[-1] == K:
        return a
    pad = a.new_full(a.shape[:-1] + (K - a.shape[-1],), fill)
    return torch.cat([a, pad], dim=-1)


def stack_tables(inj_next, inj_dep, tf_next, tf_dep):
    """The stacked ``[2, Tr, N, D, K]`` (injection, transit) tables the
    lookup kernel takes, K padded to the larger of the two with invalid
    slots (-1 / 0), which leaves the valid count, so the slot pick,
    unchanged."""
    K = max(inj_next.shape[-1], tf_next.shape[-1])
    stk_n = torch.stack([_pad_k(inj_next, K, -1), _pad_k(tf_next, K, -1)])
    stk_d = torch.stack([_pad_k(inj_dep, K, 0), _pad_k(tf_dep, K, 0)])
    return stk_n.contiguous(), stk_d.contiguous()


def _init_state(j, num_flows: int):
    """Fresh per-packet state: all packets un-injected, queues empty."""
    T, N, _ = j["conn"].shape
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
        reorder=full((), 0),
        occ=full((N * 2 * T,), 0),          # calendar-queue occupancy [N * 2T]
    )


def _make_step(j, cfg: FabricConfig, per_packet_mp: bool):
    """Build ``step(state, t) -> stats`` over the tensors in ``j``; the
    step updates ``state`` (a dict of tensors) for slice ``t``. The
    reference's ``_make_step`` with every optional input absent, at full
    width."""
    T, N, _ = j["conn"].shape
    P = j["src"].shape[0]
    dev = j["src"].device
    pid = torch.arange(P, dtype=_I32, device=dev)
    PG = P
    NKEY = N * (N + 1)
    T2 = 2 * T                       # calendar-queue ring: dep in (t, t + 2T)
    limit = min(cfg.slice_bytes, cfg.congestion_threshold)
    Tr = j["tf_next"].shape[0]
    caps_all = _build_caps_all(j["conn"], cfg, N)          # [T, NKEY]

    # stacked (injection, transit) tables for the fused first-phase lookup
    stk_n, stk_d = stack_tables(j["inj_next"], j["inj_dep"], j["tf_next"],
                                j["tf_dep"])

    size, dst, src = j["size"], j["dst"], j["src"]
    flow, seq, is_eleph = j["flow"], j["seq"], j["is_eleph"]
    hor = max(0, min(cfg.offload_horizon, T2 - 1))
    hor_cols = torch.arange(hor, dtype=torch.int64, device=dev)
    pid64 = pid.to(torch.int64)
    # per-flow multipath hashes the flow id unsalted: one hash for the run
    flow_hash = None if per_packet_mp else _salted_hash(flow.to(torch.int64), 0)

    def mp_hash(t):
        return _salted_hash(pid64, t) if per_packet_mp else flow_hash

    def cl(x):
        return x.clamp(0, N - 1)

    def vbucket(loc, dep_abs):
        return cl(loc) * T2 + dep_abs % T2

    def add_(target, idx, vals, mask):
        """``target.at[idx].add(where(mask, vals, 0))``, in place."""
        target.index_add_(0, idx, torch.where(mask, vals, 0))

    def max_at_(target2d, row, col, vals):
        """``target2d.at[row, col].max(vals)``, in place."""
        ncol = target2d.shape[1]
        target2d.view(-1).scatter_reduce_(
            0, row.to(torch.int64) * ncol + col, vals, "amax",
            include_self=True)

    def min_at_(target, idx, vals):
        """``target.at[idx].min(vals)``, in place."""
        target.scatter_reduce_(0, idx.to(torch.int64), vals, "amin",
                               include_self=True)

    def on_switch_bytes(occ, t):
        """Per-node switch-resident bytes: the occupancy columns within the
        offload horizon (all columns without offloading)."""
        occ2 = occ.view(N, T2)
        if not cfg.offload:
            return occ2.sum(1).to(_I32)
        return occ2[:, (hor_cols + (t + 1)) % T2].sum(1).to(_I32)

    def enqueue_checks(s, arrived, off, t):
        """Congestion detection at enqueue (§5.2) against the carried
        occupancy map: a full calendar queue defers the packet to the next
        slice (and, with push-back, blocks its source bucket)."""
        if not cfg.cc_detect:
            return
        dep_abs = t + off
        qb = vbucket(s["loc"], dep_abs)
        full = arrived & (off > 0) & (s["occ"][qb] > limit)
        add_(s["occ"], qb, -size, full)
        add_(s["occ"], vbucket(s["loc"], t + 1), size, full)
        s["relook"] = s["relook"] | full
        s["dep"] = torch.where(full, t + 1, s["dep"])
        if cfg.pushback:
            max_at_(s["block_until"], torch.where(full, dst, 0), dep_abs % T,
                    full.to(_I32) * (t + T))

    def step(s, t: int):
        h = mp_hash(t)
        caps = caps_all[t % T]

        # -- 0. calendar queues activating this slice leave the occupancy map
        act = (s["loc"] >= 0) & (s["dep"] == t)
        add_(s["occ"], cl(s["loc"]) * T2 + t % T2, -size, act)

        # -- 1+2. injection & re-lookup of deferred packets (fused lookup) --
        ready = (j["t_inject"] <= t) & (s["loc"] == NOT_INJECTED)
        redo = s["relook"] & (s["loc"] >= 0) & (s["dep"] == t)
        # one lookup serves both phases: injection reads the inj table at
        # src, deferred packets read the transit table at loc
        sel = (~ready).to(_I32)
        node = torch.where(ready, src, cl(s["loc"]))
        nxt_i, off_i = time_flow_lookup(stk_n, stk_d, t % Tr, sel, node, dst,
                                        h)
        nxt_r, off_r = nxt_i, off_i
        if cfg.flow_pausing:
            # elephants wait for the direct circuit of their source ToR
            fd = j["first_direct"][t % T].reshape(-1)[src * N + dst]
            use_direct = is_eleph & (fd >= 0)
            nxt_i = torch.where(use_direct, dst, nxt_i)
            off_i = torch.where(use_direct, fd, off_i)
        if cfg.pushback:
            # hosts hold traffic whose target slice bucket was pushed back
            bu = s["block_until"].view(-1)
            blocked = bu[dst * T + (t + off_i) % T] > t
        else:
            blocked = torch.zeros_like(ready)
        inject = ready & ~blocked
        s["loc"] = torch.where(inject, src, s["loc"])
        s["nxt"] = torch.where(inject, nxt_i, s["nxt"])
        s["dep"] = torch.where(inject, t + off_i, s["dep"])
        add_(s["occ"], vbucket(s["loc"], t + off_i), size,
             inject & (off_i > 0))
        enqueue_checks(s, inject, torch.where(inject, off_i, 0), t)
        n_blocked = (ready & blocked).sum().to(_I32)
        # deferred packets re-enter the pipeline with a fresh action
        s["nxt"] = torch.where(redo, nxt_r, s["nxt"])
        s["dep"] = torch.where(redo, t + off_r, s["dep"])
        s["relook"] = s["relook"] & ~redo
        add_(s["occ"], vbucket(s["loc"], t + off_r), size,
             redo & (off_r > 0))

        # -- 3. transmission with cut-through chaining ----------------------
        used = torch.zeros((NKEY,), dtype=_I32, device=dev)
        buf_now = on_switch_bytes(s["occ"], t)
        backlog_min = torch.full((NKEY,), PG, dtype=_I32, device=dev)
        rx_backlog_min = torch.full((N,), PG, dtype=_I32, device=dev)
        resc_min = torch.full((NKEY,), PG, dtype=_I32, device=dev)
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
                # FIFO admission against the receiver's remaining buffer
                need_buf = want & (nxt < N) & (nxt != dst)
                room = (cfg.switch_buffer - buf_now).clamp(min=0).to(_I32)
                adm_rx, _ = admission_admit(cl(nxt), size, need_buf, room,
                                            num_keys=N)
                rej_rx = need_buf & ~adm_rx
                min_at_(rx_backlog_min, torch.where(rej_rx, cl(nxt), 0),
                        torch.where(rej_rx, pid, PG))
                want &= adm_rx | ~need_buf
            admitted, consumed = admission_admit(key, size, want, caps - used,
                                                 num_keys=NKEY)
            used = used + consumed
            if not cfg.pushback:
                rejected = want & ~admitted
                min_at_(backlog_min, torch.where(rejected, key, 0),
                        torch.where(rejected, pid, PG))
            else:
                resc = need_buf & adm_rx & ~admitted
                min_at_(resc_min, torch.where(resc, key, 0),
                        torch.where(resc, pid, PG))
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
            prev = s["max_seq"][flow]
            s["reorder"] = s["reorder"] + (at_dst & (seq < prev)).sum().to(_I32)
            s["max_seq"].scatter_reduce_(
                0, torch.where(at_dst, flow, 0).to(torch.int64),
                torch.where(at_dst, seq, -1), "amax", include_self=True)
            s["loc"] = torch.where(at_dst, DELIVERED, newloc)
            s["nhops"] = s["nhops"] + admitted.to(_I32)
            # transit lookup at the new node
            in_transit = moved & ~at_dst
            node_t = cl(s["loc"])
            nxt_t, off_t = time_flow_lookup(stk_n, stk_d, t % Tr, 1, node_t,
                                            dst, h)
            s["nxt"] = torch.where(in_transit, nxt_t, s["nxt"])
            s["dep"] = torch.where(in_transit, t + off_t, s["dep"])
            # buffer-overflow drops on arrival; a rejection also pushes the
            # sender back (§5.2)
            add_(buf_now, node_t, size, in_transit)
            overflow = in_transit & (buf_now[node_t] > cfg.switch_buffer)
            if cfg.pushback:
                max_at_(s["block_until"], torch.where(overflow, dst, 0),
                        s["dep"] % T, overflow.to(_I32) * (t + T))
            s["loc"] = torch.where(overflow, DROPPED, s["loc"])
            arrived = in_transit & ~overflow
            add_(s["occ"], vbucket(s["loc"], t + off_t), size,
                 arrived & (off_t > 0))
            enqueue_checks(s, arrived, torch.where(in_transit, off_t, 0), t)

        # -- 4. packets that missed their slice ------------------------------
        missed = (s["loc"] >= 0) & (s["dep"] == t)
        miss_cnt = missed.sum().to(_I32)
        bump = t + 1 if cfg.cc_detect else t + T  # paused a cycle (§5.2)
        if cfg.cc_detect:
            s["relook"] = s["relook"] | missed
        add_(s["occ"], cl(s["loc"]) * T2 + bump % T2, size, missed)
        s["dep"] = torch.where(missed, bump, s["dep"])
        if cfg.pushback:
            max_at_(s["block_until"], dst, torch.full_like(dst, t % T),
                    missed.to(_I32) * (t + T))

        # -- 5. per-slice stats (row sums of the occupancy map) --------------
        on_sw = on_switch_bytes(s["occ"], t)
        if cfg.offload:
            off_sw = s["occ"].view(N, T2).sum(1).to(_I32) - on_sw
        else:
            off_sw = torch.zeros_like(on_sw)
        return dict(
            delivered_bytes=torch.where(s["t_del"] == t, size, 0).sum().to(_I32),
            dropped=(s["loc"] == DROPPED).sum().to(_I32),
            buf_bytes=on_sw, offl_bytes=off_sw,
            blocked_inj=n_blocked, slice_miss=miss_cnt,
        )

    return step


_STAT_SHAPES = dict(delivered_bytes=(), dropped=(), buf_bytes=None,
                    offl_bytes=None, blocked_inj=(), slice_miss=())


def _sim_out(final, ys: list, N: int) -> dict:
    """The result dict from the final state and the per-slice stats,
    stacked on the device and copied to the host once per field."""
    out = dict(t_deliver=final["t_del"], loc_final=final["loc"],
               nhops=final["nhops"], reorder_cnt=final["reorder"])
    dev = final["loc"].device
    for k, shape in _STAT_SHAPES.items():
        if ys:
            out[k] = torch.stack([y[k] for y in ys])
        else:
            out[k] = torch.zeros((0,) + ((N,) if shape is None else shape),
                                 dtype=_I32, device=dev)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _device_arrays(tables: FabricTables, wl: Workload, dev) -> dict:
    """The schedule, tables and workload as tensors on ``dev`` (copies:
    the step never writes to the caller's arrays)."""
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    return dict(
        conn=i32(tables.conn), tf_next=i32(tables.tf_next),
        tf_dep=i32(tables.tf_dep), inj_next=i32(tables.inj_next),
        inj_dep=i32(tables.inj_dep), first_direct=i32(tables.first_direct),
        src=i32(wl.src), dst=i32(wl.dst), size=i32(wl.size),
        t_inject=i32(wl.t_inject), flow=i32(wl.flow), seq=i32(wl.seq),
        is_eleph=torch.tensor(np.asarray(wl.is_eleph, bool), device=dev),
    )


def simulate(tables: FabricTables, wl: Workload, cfg: FabricConfig,
             num_slices: int, failures=None, control=None, telemetry=None,
             device=None) -> SimResult:
    """Run the fabric for ``num_slices`` slices (the reference's
    ``simulate``).

    Args:
        tables: deployed state (host numpy; see :class:`FabricTables`).
        wl: the packet workload (host numpy; see :class:`Workload`).
        cfg: static fabric parameters.
        num_slices: slices to run (the schedule cycle wraps as needed).
        failures, control, telemetry: not ported yet; anything but
            ``None`` raises ``NotImplementedError``.
        device: where to run: CUDA by default, through the hand-written
            kernels; ``"cpu"`` runs their plain versions.

    Returns a :class:`SimResult` of host numpy arrays.
    """
    if failures is not None or control is not None or telemetry is not None:
        raise NotImplementedError(
            "failure masks, control masks and telemetry are not ported to "
            "repro_torch yet (ROADMAP Queue 1 item 4)")
    dev = resolve_device(device)
    j = _device_arrays(tables, wl, dev)
    num_flows = int(max(wl.flow.max() + 1, 1)) if wl.num_packets else 1
    step = _make_step(j, cfg, tables.multipath == "packet")
    state = _init_state(j, num_flows)
    ys = [step(state, t) for t in range(num_slices)]
    return SimResult(**_sim_out(state, ys, tables.conn.shape[1]))
