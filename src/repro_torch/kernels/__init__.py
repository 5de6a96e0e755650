"""Hand-written Hopper kernels of the port, with their plain versions.

Each kernel has a CUDA source under ``repro_torch/csrc/``, built at first
use by :mod:`._build`, and a module here holding its wrapper (which counts
its launches in ``launches``) and its plain PyTorch version. The wrappers
dispatch by the device of their inputs: the plain version on the CPU, the
kernel on CUDA.
"""
from . import admission, time_flow_lookup

__all__ = ["admission", "time_flow_lookup"]
