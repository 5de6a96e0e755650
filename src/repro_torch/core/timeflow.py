"""The time-flow table abstraction (paper §3), PyTorch port: a copy of
``repro.core.timeflow`` (host numpy).

An entry matches (arrival time slice, dst) and acts (egress, departure time
slice); wildcarding both time fields reduces it to a classical flow table
(Fig. 3c). This module holds the *entry-level* representation used by the
user API (`add()`, debugging, source routing); the dense compiled form the
data plane executes lives in :class:`repro_torch.core.routing.CompiledRouting`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Entry", "TimeFlowTable", "WILDCARD"]

WILDCARD = None


@dataclasses.dataclass(frozen=True)
class Entry:
    """One time-flow table entry (paper Fig. 3).

    ``arr_ts``/``dep_ts`` of ``None`` are wildcards. ``hops`` holds a source
    routing action — a sequence of (egress, departure slice) tuples written to
    the packet (Fig. 3d) — in which case ``egress``/``dep_ts`` are ignored.
    """

    arr_ts: int | None
    dst: int
    egress: int | None = None
    dep_ts: int | None = None
    hops: tuple[tuple[int, int], ...] | None = None

    def is_flow_entry(self) -> bool:
        return self.arr_ts is None and self.dep_ts is None


@dataclasses.dataclass
class TimeFlowTable:
    """Per-node entry list + compilation to dense (T, D, K) lookup tensors."""

    node: int
    num_slices: int
    num_nodes: int
    entries: list[Entry] = dataclasses.field(default_factory=list)

    def add(self, e: Entry) -> bool:
        """Paper API ``add(Entry<arr_ts,src,dst,dep_ts>, node)``."""
        self.entries.append(e)
        return True

    def lookup(self, arr_ts: int, dst: int) -> list[Entry]:
        """All entries matching (arrival slice, dst); wildcard matches any."""
        t = arr_ts % self.num_slices
        return [e for e in self.entries
                if e.dst == dst and (e.arr_ts is None or e.arr_ts % self.num_slices == t)]

    def compile(self, k: int = 4) -> tuple[np.ndarray, np.ndarray]:
        """Lower to dense next/dep-offset tensors [T, D, k]; valid multipath
        slots are contiguous from 0 (the fabric's slot-hash invariant)."""
        nxt = np.full((self.num_slices, self.num_nodes, k), -1, dtype=np.int32)
        dep = np.zeros((self.num_slices, self.num_nodes, k), dtype=np.int32)
        fill = np.zeros((self.num_slices, self.num_nodes), dtype=np.int32)
        for e in self.entries:
            if e.hops is not None:
                egress, dep_ts = e.hops[0]
            else:
                egress, dep_ts = e.egress, e.dep_ts
            ts_range = range(self.num_slices) if e.arr_ts is None \
                else [e.arr_ts % self.num_slices]
            for t in ts_range:
                s = fill[t, e.dst]
                if s >= k:
                    continue
                off = 0 if dep_ts is None else (dep_ts - t) % max(self.num_slices, 1)
                nxt[t, e.dst, s] = egress
                dep[t, e.dst, s] = off
                fill[t, e.dst] += 1
        return nxt, dep

    def is_flow_table(self) -> bool:
        """Backward compatibility (paper §3): all-wildcard tables behave as
        classical flow tables."""
        return all(e.is_flow_entry() for e in self.entries)
