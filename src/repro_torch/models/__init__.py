"""The language-model stack of the port: configuration, layers, stacks and
the ``Model`` facade (the counterpart of ``repro.models``).

The port has the serving path (``prefill`` and ``decode_step``) for the
layer kinds ``dense``, ``local``, ``global``, ``attn``, ``rec`` and ``moe``;
the other kinds raise ``NotImplementedError`` in :func:`build_model`.
"""
from .config import ArchConfig, MoEConfig, ShapeConfig, SHAPES
from .model import (Model, build_model, count_params, model_flops,
                    params_from_numpy)
from . import layers, stacks

__all__ = ["ArchConfig", "MoEConfig", "ShapeConfig", "SHAPES", "Model",
           "build_model", "count_params", "model_flops", "params_from_numpy",
           "layers", "stacks"]
