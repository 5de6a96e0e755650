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

The reference's repair and reroute layers (``repair``, ``backup_tables``,
``backup_tables_dp``, ``fast_reroute``, ``simulate_phased``) are not
ported yet (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
]

# open-ended failures (no heal scheduled yet) end "never"
OPEN_END = 1 << 30

KINDS = ("link", "port", "tor", "degrade")


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
