"""``repro.distributed`` over ``torch.distributed`` ranks: the fabric's
sharded layout, the model's sharding rules and the layers' regions on a
mesh (:mod:`.sharding`), a mesh's axes without devices (:mod:`.mesh`), the
exchange primitives (:mod:`.collectives`), spawning a run's ranks
(:mod:`.spawn`), and the trainer's collective planner (pod fabric, ring
all-reduce plans and their times, in :mod:`.collectives`)."""
from . import collectives, mesh, sharding, spawn
from .collectives import (CollectivePlan, PodFabric, allreduce_time_s,
                          plan_ring_allreduce, ring_schedule, exchange_max, exchange_min, exchange_sum,
                          gather_node_row, shard_group_offsets)
from .mesh import MeshShape, mesh_axes
from .sharding import (batch_shardings, block_len, cache_shardings,
                       data_axes, fabric_group, frontend_sharding,
                       node_rows_bytes_per_device, opt_state_shardings,
                       pad_node_rows, pad_packet_axis, param_shardings,
                       placements, replicated, shard_owner)
from .spawn import choose_backend, run_ranks

__all__ = ["collectives", "mesh", "sharding", "spawn", "MeshShape",
           "mesh_axes", "CollectivePlan",
           "PodFabric", "allreduce_time_s", "plan_ring_allreduce",
           "ring_schedule", "exchange_max",
           "exchange_min", "exchange_sum", "gather_node_row",
           "shard_group_offsets", "block_len", "fabric_group",
           "node_rows_bytes_per_device", "pad_node_rows", "pad_packet_axis",
           "shard_owner", "choose_backend", "run_ranks", "batch_shardings",
           "cache_shardings", "data_axes", "frontend_sharding",
           "opt_state_shardings", "param_shardings", "placements",
           "replicated"]
