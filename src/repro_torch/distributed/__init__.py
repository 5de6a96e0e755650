"""The fabric over ``torch.distributed`` ranks: the fabric half of
``repro.distributed`` (the sharded layout in :mod:`.sharding`, the exchange
primitives in :mod:`.collectives`, spawning a run's ranks in
:mod:`.spawn`). The model half (pod fabric, ring all-reduce plans,
parameter and cache shardings) is not ported yet."""
from . import collectives, sharding, spawn
from .collectives import (exchange_max, exchange_min, exchange_sum,
                          gather_node_row, shard_group_offsets)
from .sharding import (block_len, fabric_group, node_rows_bytes_per_device,
                       pad_node_rows, pad_packet_axis, shard_owner)
from .spawn import choose_backend, run_ranks

__all__ = ["collectives", "sharding", "spawn", "exchange_max",
           "exchange_min", "exchange_sum", "gather_node_row",
           "shard_group_offsets", "block_len", "fabric_group",
           "node_rows_bytes_per_device", "pad_node_rows", "pad_packet_axis",
           "shard_owner", "choose_backend", "run_ranks"]
