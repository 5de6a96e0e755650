"""The sharded fabric's exchange primitives over ``torch.distributed``: the
port of the fabric half of ``repro.distributed.collectives``.

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

import torch

__all__ = ["shard_group_offsets", "offsets_buffer", "earlier_offsets",
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
