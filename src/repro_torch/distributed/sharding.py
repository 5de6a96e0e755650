"""The sharded fabric's layout over ``torch.distributed`` ranks: the port
of the fabric half of ``repro.distributed.sharding``.

:func:`repro_torch.core.fabric.simulate_sharded` splits the packet vector
in contiguous global-index blocks (rank ``d`` owns global indices ``[d·L,
(d+1)·L)``, ``L = block_len(P, D)``) and the per-slice node tensors of the
failure and control masks by owned ToR rows, with the same block rule. A
count that does not divide is padded up to the next multiple of the shard
count with inert fill (packets that never inject, healthy rows); the
fabric's global-index bookkeeping makes the padding invisible.
"""
from __future__ import annotations

import numpy as np

__all__ = ["fabric_group", "block_len", "shard_owner", "pad_packet_axis",
           "pad_node_rows", "node_rows_bytes_per_device"]


def fabric_group(num_shards: int | None = None, group=None):
    """The ranks of ``group`` (the default process group when ``None``) as
    the fabric's shards: returns ``(group, num_shards)``. ``num_shards``
    must equal the group's size (``None`` takes it), as the reference's
    ``fabric_mesh`` takes the first ``num_shards`` devices and refuses
    more than there are."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("fabric_group: no process group; call "
                           "torch.distributed.init_process_group first")
    size = dist.get_world_size(group)
    d = size if num_shards is None else int(num_shards)
    if d != size:
        raise ValueError(f"num_shards={num_shards} needs a process group of "
                         f"{num_shards} ranks ({size} in the group)")
    return group, d


def block_len(n: int, num_shards: int) -> int:
    """Contiguous-block width per shard: ``ceil(n / num_shards)`` (the last
    shard's block is padded when ``num_shards`` does not divide ``n``)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return -(-max(n, 1) // num_shards)


def shard_owner(idx, n: int, num_shards: int):
    """Owning shard of global index ``idx`` under the contiguous-block
    partition (host-side helper for the toolkit's sharding checker)."""
    return np.asarray(idx) // block_len(n, num_shards)


def pad_packet_axis(arr: np.ndarray, num_shards: int, fill) -> np.ndarray:
    """Pad axis 0 (the packet axis) up to a multiple of ``num_shards`` with
    ``fill`` (callers pick a fill that can never act, e.g. ``t_inject =
    num_slices``)."""
    p = arr.shape[0]
    pad = block_len(p, num_shards) * num_shards - p
    if pad == 0:
        return arr
    return np.concatenate([arr, np.full((pad,) + arr.shape[1:], fill,
                                        arr.dtype)])


def pad_node_rows(arr: np.ndarray, num_shards: int, fill) -> np.ndarray:
    """Pad axis 1 (the node-row axis of ``[S, N, ...]`` masks) up to a
    multiple of ``num_shards`` with inert ``fill`` (healthy / no-op rows);
    the fabric's owned-row bookkeeping never reads the padding."""
    n = arr.shape[1]
    pad = block_len(n, num_shards) * num_shards - n
    if pad == 0:
        return arr
    shape = (arr.shape[0], pad) + arr.shape[2:]
    return np.concatenate([arr, np.full(shape, fill, arr.dtype)], axis=1)


def node_rows_bytes_per_device(num_slices: int, n: int, num_shards: int,
                               itemsize: int = 4) -> int:
    """Per-device bytes of a row-sharded ``[S, N, N]`` mask tensor: each
    device holds only its owned ``ceil(N / D)`` rows, not the full ``N``."""
    return num_slices * block_len(n, num_shards) * n * itemsize
