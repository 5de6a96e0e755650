"""Topology APIs (paper §4.2, Table 1 "Topology" rows), PyTorch port.

A copy of ``repro.core.topology``. Its traffic-matrix schedulers
(``edmonds``, ``bvn``, ``jupiter``, ``sorn``) take their matchings from
:mod:`.matching` in place of networkx; ``bvn`` takes the rows of its
bipartite matchings in ascending order, so its schedule does not depend on
the interpreter's hash seed. The control plane is deliberately host-side
Python/numpy (the paper's optical controller is a Python program); only
the data plane (``fabric.py``) runs on the device.

Canonical schedule representation
---------------------------------
``conn[num_slices, n_nodes, n_uplinks] -> int32 peer id (or -1)``

Circuits are *directed* (a rotor uplink transmits to exactly one downlink
peer per slice), matching rotor-switch semantics in RotorNet/Opera/Shale.
TA architectures that hold a single topology use ``num_slices == 1``.

Feasibility (paper: "The optical controller verifies the feasibility of the
physical circuits"): per slice, every node's uplink k connects to at most one
peer and every node is the rx endpoint of at most ``n_uplinks`` circuits.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .matching import hopcroft_karp, max_weight_matching

__all__ = [
    "Circuit",
    "Schedule",
    "connect",
    "round_robin",
    "edmonds",
    "bvn",
    "jupiter",
    "sorn",
    "uniform_mesh",
    "deploy_topo_check",
    "circuits_to_conn",
    "conn_to_circuits",
]


@dataclasses.dataclass(frozen=True)
class Circuit:
    """A single optical circuit: node ``n1`` port ``p1`` -> node ``n2`` port ``p2``
    during time slice ``ts`` (``ts=None`` means "all slices" / static)."""

    n1: int
    p1: int
    n2: int
    p2: int
    ts: int | None = None


@dataclasses.dataclass
class Schedule:
    """A compiled optical schedule.

    conn[t, i, k] = peer node receiving from node i's uplink k in slice t
    (-1 = dark). ``slice_us`` is the circuit duration in microseconds.
    """

    conn: np.ndarray  # int32 [T, N, U]
    slice_us: float = 100.0
    reconf_us: float = 0.0  # guardband / reconfiguration dead time per slice

    @property
    def num_slices(self) -> int:
        return int(self.conn.shape[0])

    @property
    def num_nodes(self) -> int:
        return int(self.conn.shape[1])

    @property
    def num_uplinks(self) -> int:
        return int(self.conn.shape[2])

    @property
    def duty_cycle(self) -> float:
        return self.slice_us / (self.slice_us + self.reconf_us)

    def has_circuit(self, src: int, dst: int, ts: int) -> bool:
        return bool(np.any(self.conn[ts % self.num_slices, src] == dst))

    def neighbors(self, node: int, ts: int) -> np.ndarray:
        """Paper helper ``neighbors([Circuit], node, ts)``: nodes with a direct
        circuit *from* ``node`` in slice ``ts``."""
        row = self.conn[ts % self.num_slices, node]
        return np.unique(row[row >= 0])


def connect(circuits: list[Circuit], n1: int, p1: int, n2: int, p2: int,
            ts: int | None = None) -> bool:
    """Primitive ``connect()`` (Table 1): append a circuit if the (node, port,
    slice) pair is free. Returns False on conflict, mirroring the controller's
    sanity check."""
    for c in circuits:
        same_slice = c.ts is None or ts is None or c.ts == ts
        if same_slice and ((c.n1 == n1 and c.p1 == p1) or (c.n2 == n2 and c.p2 == p2)):
            return False
    circuits.append(Circuit(n1, p1, n2, p2, ts))
    return True


def circuits_to_conn(circuits: Sequence[Circuit], n_nodes: int, n_uplinks: int,
                     num_slices: int | None = None) -> np.ndarray:
    """Compile node-level circuits into the dense ``conn`` tensor
    (``deploy_topo`` lowering step)."""
    if num_slices is None:
        tss = [c.ts for c in circuits if c.ts is not None]
        num_slices = (max(tss) + 1) if tss else 1
    conn = np.full((num_slices, n_nodes, n_uplinks), -1, dtype=np.int32)
    for c in circuits:
        slices = range(num_slices) if c.ts is None else [c.ts]
        for t in slices:
            if conn[t, c.n1, c.p1] != -1:
                raise ValueError(f"port conflict: node {c.n1} port {c.p1} slice {t}")
            conn[t, c.n1, c.p1] = c.n2
    return conn


def conn_to_circuits(conn: np.ndarray) -> list[Circuit]:
    out = []
    T, N, U = conn.shape
    for t in range(T):
        for i in range(N):
            for k in range(U):
                j = int(conn[t, i, k])
                if j >= 0:
                    out.append(Circuit(i, k, j, k, t))
    return out


def deploy_topo_check(conn: np.ndarray) -> bool:
    """Controller feasibility check: in every slice each node receives on at
    most ``n_uplinks`` circuits and never twice on the same (peer, port)."""
    T, N, U = conn.shape
    for t in range(T):
        rx_count = np.zeros(N, dtype=np.int64)
        for i in range(N):
            for k in range(U):
                j = conn[t, i, k]
                if j == i:
                    return False  # self-circuit is meaningless
                if j >= 0:
                    rx_count[j] += 1
        if np.any(rx_count > U):
            return False
    return True


# ---------------------------------------------------------------------------
# TO optical-schedule generators (paper: round_robin(dimension, uplink))
# ---------------------------------------------------------------------------

def round_robin(n_nodes: int, n_uplinks: int = 1, dimension: int = 1,
                slice_us: float = 100.0, reconf_us: float = 0.0) -> Schedule:
    """Round-robin optical schedule generation (Table 1).

    dimension=1, n_uplinks=1  -> RotorNet: slice t applies the directed
        permutation i -> (i + t + 1) mod N; the cycle has N-1 slices and every
        src/dst pair gets a direct circuit exactly once per cycle.
    dimension=1, n_uplinks=U  -> Opera-style: uplink k is a rotor offset by
        k * (N-1)//U slices, so each slice's union graph is U-regular (an
        expander for suitable N, U).
    dimension=d               -> Shale-style: nodes on a d-dim grid; uplink k
        rotates within grid dimension (k % d).
    """
    if dimension == 1:
        T = n_nodes - 1
        conn = np.full((T, n_nodes, n_uplinks), -1, dtype=np.int32)
        ids = np.arange(n_nodes, dtype=np.int32)
        for k in range(n_uplinks):
            phase = (k * T) // n_uplinks
            for t in range(T):
                off = 1 + (t + phase) % T
                conn[t, :, k] = (ids + off) % n_nodes
        return Schedule(conn, slice_us, reconf_us)

    # Shale: factor n into `dimension` near-equal factors.
    dims = _near_equal_factors(n_nodes, dimension)
    coords = np.array(np.unravel_index(np.arange(n_nodes), dims)).T  # [N, d]
    T = int(np.lcm.reduce([d - 1 for d in dims if d > 1])) or 1
    conn = np.full((T, n_nodes, n_uplinks), -1, dtype=np.int32)
    for k in range(n_uplinks):
        axis = k % dimension
        if dims[axis] <= 1:
            continue
        for t in range(T):
            off = 1 + t % (dims[axis] - 1)
            nxt = coords.copy()
            nxt[:, axis] = (coords[:, axis] + off) % dims[axis]
            conn[t, :, k] = np.ravel_multi_index(nxt.T, dims)
    return Schedule(conn, slice_us, reconf_us)


def _near_equal_factors(n: int, d: int) -> tuple[int, ...]:
    dims = [1] * d
    rem = n
    for i in range(d):
        f = int(round(rem ** (1.0 / (d - i))))
        while f > 1 and rem % f != 0:
            f -= 1
        f = max(f, 1)
        dims[i] = f
        rem //= f
    if int(np.prod(dims)) != n:
        raise ValueError(f"cannot factor {n} nodes into {d} dimensions")
    return tuple(dims)


# ---------------------------------------------------------------------------
# TA circuit-scheduling algorithms (paper: edmonds(TM), BvN(TM), jupiter(TM))
# ---------------------------------------------------------------------------

def edmonds(tm: np.ndarray, n_uplinks: int = 1, slice_us: float = 1e5) -> Schedule:
    """c-Through-style max-weight matching on the traffic matrix (Edmonds'
    blossom algorithm, :func:`.matching.max_weight_matching`). Produces one
    topology (num_slices=1). Each matched pair gets a bidirectional circuit
    (both directions)."""
    n = tm.shape[0]
    conn = np.full((1, n, n_uplinks), -1, dtype=np.int32)
    sym = tm + tm.T
    for k in range(n_uplinks):
        edges = [(i, j, float(sym[i, j])) for i in range(n)
                 for j in range(i + 1, n) if sym[i, j] > 0]
        mate = max_weight_matching(n, edges, maxcardinality=True)
        for i in range(n):
            j = int(mate[i])
            if j > i:
                conn[0, i, k] = j
                conn[0, j, k] = i
                sym[i, j] = sym[j, i] = 0  # next uplink serves remaining demand
    return Schedule(conn, slice_us=slice_us)


def bvn(tm: np.ndarray, max_perms: int = 32, slice_us: float = 100.0,
        reconf_us: float = 10.0, eps: float = 1e-9) -> Schedule:
    """Birkhoff-von-Neumann decomposition (Mordia): scale TM towards doubly
    stochastic, peel off perfect matchings (Hopcroft-Karp on the positive
    support), and emit each matching for a number of slices proportional to
    its weight."""
    n = tm.shape[0]
    m = tm.astype(np.float64).copy()
    np.fill_diagonal(m, 0.0)
    if m.sum() <= 0:
        m = np.ones((n, n)) - np.eye(n)
    # Sinkhorn to (approximately) doubly stochastic.
    for _ in range(200):
        m /= np.maximum(m.sum(axis=1, keepdims=True), eps)
        m /= np.maximum(m.sum(axis=0, keepdims=True), eps)
    perms, weights = [], []
    residual = m.copy()
    for _ in range(max_perms):
        support = residual > eps
        if not support.any():
            break
        perm = _perfect_matching(support)
        if perm is None:
            # pad support with smallest-residual edges to restore Hall's cond.
            residual = residual + eps * (~np.eye(n, dtype=bool))
            perm = _perfect_matching(residual > 0)
            if perm is None:
                break
        w = float(residual[np.arange(n), perm].min())
        perms.append(perm)
        weights.append(max(w, eps))
        residual[np.arange(n), perm] -= w
    weights = np.asarray(weights)
    n_slices = np.maximum(1, np.round(weights / weights.sum() * max_perms)).astype(int)
    conn = np.full((int(n_slices.sum()), n, 1), -1, dtype=np.int32)
    t = 0
    for perm, reps in zip(perms, n_slices):
        for _ in range(reps):
            conn[t, :, 0] = perm
            t += 1
    return Schedule(conn[:t], slice_us=slice_us, reconf_us=reconf_us)


def _perfect_matching(support: np.ndarray) -> np.ndarray | None:
    """Perfect matching on a bipartite support matrix (rows->cols), or None."""
    match = hopcroft_karp(support)
    if (match < 0).any():
        return None
    return match.astype(np.int32)



def uniform_mesh(n_nodes: int, n_uplinks: int = 1, slice_us: float = 1e5) -> Schedule:
    """Jupiter's default topology: a uniform (round-robin offset) mesh held
    statically — every node connects its uplinks to evenly spread peers."""
    conn = np.full((1, n_nodes, n_uplinks), -1, dtype=np.int32)
    ids = np.arange(n_nodes, dtype=np.int32)
    for k in range(n_uplinks):
        off = 1 + k * max(1, (n_nodes - 1) // max(1, n_uplinks))
        conn[0, :, k] = (ids + off) % n_nodes
    return Schedule(conn, slice_us=slice_us)


def jupiter(tm: np.ndarray | None, prev: Schedule | None = None,
            n_nodes: int | None = None, n_uplinks: int = 1,
            max_moves: int = 8, slice_us: float = 1e5) -> Schedule:
    """Jupiter-style gradual topology evolution: start from the uniform mesh;
    each reconfiguration moves at most ``max_moves`` circuits toward the
    demand-optimal matching (computed greedily from the TM), keeping the
    fabric usable throughout (paper §4.2 / Fig 5b)."""
    if prev is None:
        assert n_nodes is not None
        prev = uniform_mesh(n_nodes, n_uplinks, slice_us)
    if tm is None or np.all(tm == 0):
        return prev
    n = prev.num_nodes
    U = prev.num_uplinks
    want = edmonds(tm, n_uplinks=U, slice_us=slice_us)
    conn = prev.conn.copy()
    rx = np.zeros(n, dtype=np.int64)
    for i in range(n):
        for k in range(U):
            if conn[0, i, k] >= 0:
                rx[conn[0, i, k]] += 1
    moves = 0
    for k in range(U):
        for i in range(n):
            if moves >= max_moves:
                break
            tgt = want.conn[0, i, k]
            cur = conn[0, i, k]
            # keep the fabric feasible throughout: respect rx-degree <= U
            if tgt >= 0 and tgt != i and cur != tgt and rx[tgt] < U:
                if cur >= 0:
                    rx[cur] -= 1
                conn[0, i, k] = tgt
                rx[tgt] += 1
                moves += 1
    return Schedule(conn, slice_us=slice_us)


def sorn(tm: np.ndarray, base: Schedule, hot_frac: float = 0.25) -> Schedule:
    """Semi-oblivious round-robin (paper §4.3, Fig 5c): skew the round-robin
    schedule so hotspot node pairs get extra slices (denser connections)
    while cold pairs are thinned."""
    T, N, U = base.conn.shape
    conn = base.conn.copy()
    flat = tm.flatten()
    k = max(1, int(hot_frac * N))
    hot_pairs = np.argsort(flat)[::-1][: k]
    extra = np.full((k, N, U), -1, dtype=np.int32)
    for s, p in enumerate(hot_pairs):
        i, j = divmod(int(p), N)
        if i == j:
            continue
        extra[s, i, 0] = j
        extra[s, j, 0] = i
    return Schedule(np.concatenate([conn, extra], axis=0),
                    slice_us=base.slice_us, reconf_us=base.reconf_us)
