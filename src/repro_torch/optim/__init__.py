"""The optimizer of the port (the counterpart of ``repro.optim``): AdamW
with schedules, clipping and micro-batch accumulation, and gradient
compression with error feedback, as plain functions on trees of tensors."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, cosine_schedule,
                    linear_schedule, clip_by_global_norm, global_norm,
                    accum_init, accum_add, accum_finalize)
from .compression import (CompressionConfig, ef_init, compress, decompress,
                          compressed_bytes, ef_roundtrip)
from .tree import tree_items, tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "linear_schedule", "clip_by_global_norm", "global_norm",
           "accum_init", "accum_add", "accum_finalize",
           "CompressionConfig", "ef_init", "compress", "decompress",
           "compressed_bytes", "ef_roundtrip", "tree_items", "tree_leaves",
           "tree_map"]
