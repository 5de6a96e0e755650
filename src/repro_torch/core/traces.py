"""Synthetic stand-ins for the paper's DCN traces (§7: RPC [Homa], Hadoop
[Facebook], KV-store [Memcached/SIGMETRICS'12]), PyTorch port: a copy of
``repro.core.traces`` (host numpy, identical output per seed).

The real traces are not redistributable; these generators match their
qualitative shape (flow-size distribution + Poisson arrivals) which is what
the paper's benchmarks exercise: RPC = mostly sub-MTU messages, KV = tiny
keys/values with occasional larger values, Hadoop = heavy-tailed shuffle
flows. Loads are scaled to a target core-link utilisation (40% in §7).
"""
from __future__ import annotations

import numpy as np

from .fabric import Workload

__all__ = ["synthesize", "TRACES", "flow_fcts"]

TRACES = ("rpc", "hadoop", "kvstore")


def _flow_sizes(rng: np.random.Generator, trace: str, n: int) -> np.ndarray:
    if trace == "rpc":
        # Homa-style: bimodal, dominated by small RPCs with some 100KB+ tails
        small = rng.lognormal(mean=np.log(500), sigma=1.0, size=n)
        big = rng.lognormal(mean=np.log(200_000), sigma=1.2, size=n)
        pick = rng.random(n) < 0.85
        return np.where(pick, small, big)
    if trace == "kvstore":
        small = rng.lognormal(mean=np.log(300), sigma=0.8, size=n)
        big = rng.lognormal(mean=np.log(50_000), sigma=1.0, size=n)
        pick = rng.random(n) < 0.95
        return np.where(pick, small, big)
    if trace == "hadoop":
        # heavy-tailed shuffle: Pareto body up to tens of MB
        s = (rng.pareto(a=1.3, size=n) + 1.0) * 10_000
        return np.clip(s, 1_000, 30e6)
    raise ValueError(f"unknown trace {trace}")


def synthesize(trace: str, n_nodes: int, num_slices: int, *,
               slice_bytes: int, n_uplinks: int = 1, load: float = 0.4,
               cell_bytes: int = 1500, max_packets: int = 200_000,
               elephant_bytes: int = 1 << 20, seed: int = 0,
               skew: float = 0.0) -> Workload:
    """Poisson flow arrivals with per-trace size distributions, scaled so the
    offered load is ``load`` x the fabric's aggregate circuit capacity.

    ``skew`` in [0, 1) concentrates traffic on a subset of hot node pairs
    (used by the semi-oblivious case study).
    """
    rng = np.random.default_rng(seed)
    capacity_per_slice = n_nodes * n_uplinks * slice_bytes  # bytes/slice
    target_bytes = load * capacity_per_slice * num_slices
    # draw flows until the byte budget is exhausted
    sizes = []
    total = 0.0
    while total < target_bytes:
        batch = _flow_sizes(rng, trace, 256)
        sizes.extend(batch.tolist())
        total += float(batch.sum())
    sizes = np.maximum(np.asarray(sizes), 64).astype(np.int64)
    F = len(sizes)
    t_start = rng.integers(0, max(1, int(num_slices * 0.8)), size=F)
    if skew > 0:
        hot = max(2, int(n_nodes * 0.2))
        use_hot = rng.random(F) < skew
        src = np.where(use_hot, rng.integers(0, hot, F), rng.integers(0, n_nodes, F))
        dst = np.where(use_hot, rng.integers(0, hot, F), rng.integers(0, n_nodes, F))
    else:
        src = rng.integers(0, n_nodes, size=F)
        dst = rng.integers(0, n_nodes, size=F)
    bump = dst == src
    dst = np.where(bump, (dst + 1) % n_nodes, dst)

    # chop flows into cells, paced at host line rate (~1 circuit's worth of
    # cells per slice) so a flow does not burst into a single slice
    cells_per_slice = max(1, slice_bytes // cell_bytes)
    p_src, p_dst, p_size, p_t, p_flow, p_seq, p_el = [], [], [], [], [], [], []
    for f in range(F):
        rem = int(sizes[f])
        seq = 0
        while rem > 0 and len(p_src) < max_packets:
            c = min(rem, cell_bytes)
            p_src.append(src[f]); p_dst.append(dst[f]); p_size.append(c)
            p_t.append(t_start[f] + seq // cells_per_slice)
            p_flow.append(f); p_seq.append(seq)
            p_el.append(sizes[f] >= elephant_bytes)
            rem -= c
            seq += 1
        if len(p_src) >= max_packets:
            break
    i32 = lambda a: np.asarray(a, dtype=np.int32)
    return Workload(src=i32(p_src), dst=i32(p_dst), size=i32(p_size),
                    t_inject=i32(p_t), flow=i32(p_flow), seq=i32(p_seq),
                    is_eleph=np.asarray(p_el, dtype=bool))


def flow_fcts(wl: Workload, t_deliver: np.ndarray, slice_us: float,
              only: np.ndarray | None = None) -> np.ndarray:
    """Flow completion times in microseconds for fully delivered flows.
    ``only``: optional boolean mask over flows (e.g. mice vs elephants)."""
    F = wl.num_flows
    done = t_deliver >= 0
    last = np.full(F, -1, dtype=np.int64)
    cnt = np.zeros(F, dtype=np.int64)
    tot = np.zeros(F, dtype=np.int64)
    np.maximum.at(last, wl.flow, np.where(done, t_deliver, -1))
    np.add.at(cnt, wl.flow, done.astype(np.int64))
    np.add.at(tot, wl.flow, 1)
    start = np.full(F, np.iinfo(np.int64).max)
    np.minimum.at(start, wl.flow, wl.t_inject.astype(np.int64))
    complete = (cnt == tot) & (tot > 0)
    if only is not None:
        complete &= only
    fct = (last[complete] - start[complete] + 1) * slice_us
    return fct
