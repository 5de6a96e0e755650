"""The language-model stack of the port: configuration, layers, stacks and
the ``Model`` facade (the counterpart of ``repro.models``).

The port has the serving path (``prefill`` and ``decode_step``) and the
training forward (``train_logits``, ``loss``; gradients through the
kernels' ``autograd.Function``s) for every layer kind of the reference
(``dense``, ``local``, ``global``, ``attn``, ``rec``, ``moe``, ``mlstm``,
``slstm``, ``enc`` and ``dec``) and both stub frontends (audio frames into
an encoder, vision patches before the prompt).
"""
from .config import ArchConfig, MoEConfig, ShapeConfig, SHAPES
from .model import (Model, build_model, count_params, decay_mask,
                    from_reference_tree, model_flops, params_from_numpy,
                    params_to_numpy, to_reference_tree)
from . import chunked_attention, layers, stacks

__all__ = ["ArchConfig", "MoEConfig", "ShapeConfig", "SHAPES", "Model",
           "build_model", "count_params", "decay_mask",
           "from_reference_tree", "model_flops", "params_from_numpy",
           "params_to_numpy", "to_reference_tree",
           "chunked_attention", "layers", "stacks"]
