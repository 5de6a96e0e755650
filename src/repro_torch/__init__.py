"""OpenOptics in PyTorch for one NVIDIA H100: the port of ``repro``.

It imports ``torch`` and ``numpy`` only, never ``jax``, ``repro`` or
``networkx``; ``repro`` stays the reference the port is held against.
:mod:`repro_torch.core` carries the main path (schedule -> routing ->
``OpenOpticsNet.run`` -> ``fabric.simulate``), and
:mod:`repro_torch.kernels` its hand-written CUDA kernels with their plain
PyTorch versions. :mod:`repro_torch.models`, :mod:`repro_torch.configs` and
:mod:`repro_torch.launch` carry the language-model serving path
(``launch.serve``). Entry points run on CUDA unless given ``device="cpu"``.
"""
from . import configs, core, kernels, launch, models

__all__ = ["configs", "core", "kernels", "launch", "models"]
