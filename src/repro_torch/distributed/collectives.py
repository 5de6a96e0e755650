"""The sharded fabric's exchange primitives over ``torch.distributed``, and
the pod fabric's collective planner: the port of
``repro.distributed.collectives``.

The planner (:class:`PodFabric`, :func:`ring_schedule`,
:func:`plan_ring_allreduce`, :func:`allreduce_time_s`) is the reference's
host arithmetic on the port's :mod:`repro_torch.core.topology`: the
trainer's inter-pod gradient all-reduce planned against an OpenOptics
schedule, either a ring the controller deploys for the collective
(``aligned``) or an oblivious rotor, whose ring circuit is live 1 / (P - 1)
of the slices.

The sharded fabric (:func:`repro_torch.core.fabric.simulate_sharded`)
keeps every per-ToR aggregate (occupancy map, backlog cuts, ``max_seq``,
``block_until``, counters) replicated on every rank and reconciles each
update through one of these. Cross-shard traffic is never exchanged packet
by packet, which would be ragged, but as fixed-shape per-key aggregates.

Every primitive is one ``all_reduce`` (SUM, MIN or MAX): a gather is the
sum of zero-padded blocks, the offsets the sum of a ``[D, num_keys]``
buffer in which each rank fills its own row. NCCL refuses two ranks on one
card, and on CUDA tensors gloo takes only ``broadcast`` and ``all_reduce``;
with ``all_reduce`` alone one code path runs over NCCL (a card a rank),
over gloo with ranks sharing a card, and over gloo on the CPU. Every
exchanged tensor holds integers (int32 in the fabric), so the order of the
reduction cannot change a bit.

Each takes the process ``group`` (``None``: the default group); the
fabric passes its rank and shard count, read once a run, to spare the
lookups a call. ``exchanges`` and ``exchanged_bytes`` count this
process's all-reduces and the bytes of the tensors they reduced.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.topology import Schedule, round_robin
from ..optim.compression import CompressionConfig, compressed_bytes

__all__ = ["PodFabric", "CollectivePlan", "plan_ring_allreduce",
           "allreduce_time_s", "ring_schedule", "shard_group_offsets", "offsets_buffer", "earlier_offsets",
           "gather_node_row", "exchange_sum", "exchange_min", "exchange_max"]


exchanges = 0
exchanged_bytes = 0


def _dist():
    import torch.distributed as dist
    return dist


def _all_reduce(x, op, group):
    global exchanges, exchanged_bytes
    _dist().all_reduce(x, op=op, group=group)
    exchanges += 1
    exchanged_bytes += x.numel() * x.element_size()
    return x


def _rank_size(group, rank, num_shards):
    dist = _dist()
    return (dist.get_rank(group) if rank is None else rank,
            dist.get_world_size(group) if num_shards is None else num_shards)


def exchange_sum(x, group=None):
    """Sum ``x`` over the ranks, in place (occupancy deltas, counters,
    per-slice counts); returns ``x``."""
    return _all_reduce(x, _dist().ReduceOp.SUM, group)


def exchange_min(x, group=None):
    """Minimum of ``x`` over the ranks, in place (the backlog cuts: the
    first rejected global packet index per admission group or receiver);
    returns ``x``."""
    return _all_reduce(x, _dist().ReduceOp.MIN, group)


def exchange_max(x, group=None):
    """Maximum of ``x`` over the ranks, in place (high-water state: the
    per-flow ``max_seq``, push-back's ``block_until``); returns ``x``."""
    return _all_reduce(x, _dist().ReduceOp.MAX, group)


def shard_group_offsets(local_bytes, group=None, rank=None, num_shards=None):
    """Exclusive per-key byte offsets of all *earlier* ranks.

    ``local_bytes`` is this rank's per-key wanted-byte total
    (``[num_keys]`` int32). Packets are sharded in contiguous global-index
    blocks, so a local packet's global FIFO byte prefix within its
    admission group is its local prefix plus the wanted bytes of every
    lower rank: the value returned here. Shifting the per-key capacities
    down by it turns the local FIFO admission (the admission kernel,
    unchanged) into the global one. One all-reduce of a ``[D, num_keys]``
    buffer in which each rank fills its own row."""
    r, d = _rank_size(group, rank, num_shards)
    buf = offsets_buffer(local_bytes, r, d)
    return earlier_offsets(exchange_sum(buf, group), r)


def offsets_buffer(local_bytes, rank: int, num_shards: int):
    """The ``[D, num_keys]`` buffer of :func:`shard_group_offsets` before
    its exchange: zeros, this rank's row ``local_bytes``. A caller that
    merges the exchange with others sums it over the ranks itself and
    reads the offsets with :func:`earlier_offsets`."""
    buf = local_bytes.new_zeros((num_shards,) + tuple(local_bytes.shape))
    buf[rank] = local_bytes
    return buf


def earlier_offsets(summed_buf, rank: int):
    """The offsets of :func:`shard_group_offsets` from its buffer summed
    over the ranks: the rows of the ranks before ``rank``, summed."""
    return summed_buf[:rank].sum(0, dtype=summed_buf.dtype)


def gather_node_row(local, n: int, group=None, rank=None, num_shards=None,
                    axis: int = 0):
    """A full per-node row (``[n]`` along ``axis``) from the ranks' owned
    blocks of ToR rows (padded to ``num_shards·ceil(n / num_shards)``): the
    sum of zero-padded blocks, one all-reduce. Bool blocks go through
    int32 and come back bool. Any tensor split in contiguous blocks of
    one width along ``axis`` joins the same way: the fabric gathers a
    window's rows of ``node_ok``, ``phase_off`` and ``skew_miss`` at once
    (``axis=1`` of ``[W, ceil(n / D)]``), and at a run's end the ranks'
    blocks of the packet fields."""
    r, d = _rank_size(group, rank, num_shards)
    is_bool = local.dtype == torch.bool
    x = local.to(torch.int32) if is_bool else local
    L = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = d * L
    full = x.new_zeros(shape)
    full.narrow(axis, r * L, L).copy_(x)
    exchange_sum(full, group)
    full = full.narrow(axis, 0, n)
    return full != 0 if is_bool else full


# ---------------------------------------------------------------------------
# the pod fabric's collective planner
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PodFabric:
    """Inter-pod optical fabric model (the reference's defaults)."""
    n_pods: int = 2
    link_gbps: float = 400.0      # per pod-pair optical circuit
    n_uplinks: int = 1
    slice_us: float = 100.0
    reconf_us: float = 10.0       # OCS guardband per slice

    @property
    def duty_cycle(self) -> float:
        return self.slice_us / (self.slice_us + self.reconf_us)

    @property
    def slice_bytes(self) -> int:
        return int(self.link_gbps / 8 * 1e3 * self.slice_us * self.duty_cycle)


def ring_schedule(n_pods: int, fabric: PodFabric) -> Schedule:
    """The schedule the controller deploys for a collective phase: a
    static bidirectional ring p -> p +- 1 held for the phase."""
    conn = np.full((1, n_pods, 2), -1, dtype=np.int32)
    ids = np.arange(n_pods, dtype=np.int32)
    conn[0, :, 0] = (ids + 1) % n_pods
    conn[0, :, 1] = (ids - 1) % n_pods
    return Schedule(conn, slice_us=fabric.slice_us, reconf_us=fabric.reconf_us)


@dataclasses.dataclass
class CollectivePlan:
    """Slice-aligned transfer plan: rows (step, src_pod, dst_pod, slice,
    bytes)."""
    transfers: list[tuple[int, int, int, int, int]]
    total_slices: int
    total_bytes_per_link: int
    schedule: Schedule

    def time_s(self, fabric: PodFabric) -> float:
        return self.total_slices * (fabric.slice_us + fabric.reconf_us) * 1e-6


def plan_ring_allreduce(total_bytes: int, fabric: PodFabric,
                        aligned: bool = True,
                        compression: CompressionConfig | None = None
                        ) -> CollectivePlan:
    """Ring all-reduce = reduce-scatter + all-gather: 2 (P - 1) steps, each
    moving total_bytes / P per link, every step mapped onto slices of the
    deployed schedule in which its (p -> p + 1) circuit is live."""
    P = fabric.n_pods
    if compression is not None:
        total_bytes = compressed_bytes(total_bytes // 4, compression)
    if P == 1:
        return CollectivePlan([], 0, 0, ring_schedule(1, fabric))
    chunk = math.ceil(total_bytes / P)
    sched = ring_schedule(P, fabric) if aligned \
        else round_robin(P, fabric.n_uplinks, slice_us=fabric.slice_us,
                         reconf_us=fabric.reconf_us)
    T = sched.num_slices
    slice_cap = fabric.slice_bytes
    transfers = []
    t = 0
    for step in range(2 * (P - 1)):
        # every pod p sends its chunk to p + 1 at once; slices in series
        remaining = chunk
        while remaining > 0:
            guard = 0
            while not sched.has_circuit(0, 1 % P, t) and guard <= T:
                t += 1
                guard += 1
            if guard > T:
                raise RuntimeError("schedule never provides ring circuits")
            sent = min(remaining, slice_cap)
            for p in range(P):
                transfers.append((step, p, (p + 1) % P, t, sent))
            remaining -= sent
            t += 1
    return CollectivePlan(transfers, t, 2 * (P - 1) * chunk, sched)


def allreduce_time_s(total_bytes: int, fabric: PodFabric, aligned: bool,
                     compression: CompressionConfig | None = None) -> float:
    """Closed-form time (the plan's slice count up to rounding): a ring
    all-reduce moves 2 (P - 1) / P x B per link, at duty_cycle x rate when
    aligned and duty_cycle / (P - 1) x rate on an oblivious rotor."""
    P = fabric.n_pods
    if P == 1:
        return 0.0
    if compression is not None:
        total_bytes = compressed_bytes(total_bytes // 4, compression)
    bytes_per_link = 2 * (P - 1) / P * total_bytes
    rate = fabric.link_gbps / 8 * 1e9 * fabric.duty_cycle
    if not aligned:
        rate /= max(P - 1, 1)
    return bytes_per_link / rate
