"""Topology APIs (paper §4.2, Table 1 "Topology" rows), PyTorch port.

A copy of ``repro.core.topology`` without its networkx schedulers
(``edmonds``, ``bvn``, ``jupiter``, ``sorn``). The control plane is
deliberately host-side Python/numpy (the paper's optical controller is a
Python program); only the data plane (``fabric.py``) runs on the device.

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

__all__ = [
    "Circuit",
    "Schedule",
    "connect",
    "round_robin",
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
# TA topologies. The traffic-matrix schedulers of the reference (edmonds,
# bvn, jupiter, sorn) need networkx and are not ported yet.
# ---------------------------------------------------------------------------

def uniform_mesh(n_nodes: int, n_uplinks: int = 1, slice_us: float = 1e5) -> Schedule:
    """Jupiter's default topology: a uniform (round-robin offset) mesh held
    statically — every node connects its uplinks to evenly spread peers."""
    conn = np.full((1, n_nodes, n_uplinks), -1, dtype=np.int32)
    ids = np.arange(n_nodes, dtype=np.int32)
    for k in range(n_uplinks):
        off = 1 + k * max(1, (n_nodes - 1) // max(1, n_uplinks))
        conn[0, :, k] = (ids + off) % n_nodes
    return Schedule(conn, slice_us=slice_us)

