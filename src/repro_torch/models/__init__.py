"""The language-model stack of the port: configuration, layers, stacks and
the ``Model`` facade (the counterpart of ``repro.models``).

The port has the serving path (``prefill`` and ``decode_step``) for every
layer kind of the reference (``dense``, ``local``, ``global``, ``attn``,
``rec``, ``moe``, ``mlstm``, ``slstm``, ``enc`` and ``dec``) and both stub
frontends (audio frames into an encoder, vision patches before the
prompt); training is not ported yet.
"""
from .config import ArchConfig, MoEConfig, ShapeConfig, SHAPES
from .model import (Model, build_model, count_params, model_flops,
                    params_from_numpy)
from . import layers, stacks

__all__ = ["ArchConfig", "MoEConfig", "ShapeConfig", "SHAPES", "Model",
           "build_model", "count_params", "model_flops", "params_from_numpy",
           "layers", "stacks"]
