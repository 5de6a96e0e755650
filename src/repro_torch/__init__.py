"""OpenOptics in PyTorch for one NVIDIA H100: the port of ``repro``.

It imports ``torch`` and ``numpy`` only, never ``jax``, ``repro`` or
``networkx``; ``repro`` stays the reference the port is held against.
:mod:`repro_torch.core` carries the main path (schedule -> routing ->
``OpenOpticsNet.run`` -> ``fabric.simulate``), and
:mod:`repro_torch.kernels` its hand-written CUDA kernels with their plain
PyTorch versions. Entry points run on CUDA unless given ``device="cpu"``.
"""
from . import core, kernels

__all__ = ["core", "kernels"]
