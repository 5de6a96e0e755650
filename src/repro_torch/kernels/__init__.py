"""Hand-written Hopper kernels of the port, with their plain versions.

Each kernel has a CUDA source under ``repro_torch/csrc/``, built at first
use by :mod:`._build`, and a module here holding its wrapper (which counts
its launches in ``launches``) and its plain PyTorch version. The wrappers
dispatch by the device of their inputs: the plain version on the CPU, the
kernel on CUDA.

The fabric's main path runs ``time_flow_lookup`` and ``admission``; the
language-model serving path runs ``flash_attention`` (prefill),
``decode_attention`` (decode), ``rg_lru`` (the RG-LRU scan at prefill) and
``grouped_matmul`` (the MoE expert products).
"""
from . import (admission, decode_attention, flash_attention, grouped_matmul,
               rg_lru, time_flow_lookup)

__all__ = ["admission", "decode_attention", "flash_attention",
           "grouped_matmul", "rg_lru", "time_flow_lookup"]
