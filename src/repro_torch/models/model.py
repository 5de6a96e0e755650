"""Model facade, the weight carrier, and analytic parameter accounting
(the counterpart of ``repro.models.model``).

:class:`Model` mirrors the reference's facade: ``init`` draws the
parameters, ``train_logits`` and ``loss`` run the training forward,
``init_cache``, ``prefill`` and ``decode_step`` the serving path;
``trainable`` makes the parameters require gradients.
:func:`params_from_numpy` carries a parameter tree of the reference
(nested dicts of float32 numpy arrays) over to the port and
:func:`params_to_numpy` back. The reference's tree maps onto the port's
parameter names, so that trees keyed by those names
(gradients, optimizer state) can be written in the reference's layout
(:func:`to_reference_tree`, for checkpoints) and read back
(:func:`from_reference_tree`). :func:`count_params` and
:func:`model_flops` are the reference's numpy arithmetic, copied.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..core.fabric import resolve_device
from . import stacks
from .config import ArchConfig

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def init(self, seed: int = 0, device=None) -> stacks.Stack:
        """Parameters drawn from a ``torch.Generator`` seeded with ``seed``
        on the target device, with the reference's distributions (the
        numbers differ from JAX's). CUDA unless ``device`` says otherwise."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = stacks.Stack(self.cfg, dev)
        with torch.no_grad():
            params.reset_parameters(gen)
        return params

    def trainable(self, params: stacks.Stack) -> stacks.Stack:
        """Make every parameter require gradients (they are frozen as
        built); returns ``params``."""
        return params.requires_grad_(True)

    def train_logits(self, params, tokens, frontend_embeds=None):
        return stacks.train_logits(params, self.cfg, tokens, frontend_embeds)

    def loss(self, params, tokens, labels, frontend_embeds=None):
        return stacks.loss_fn(params, self.cfg, tokens, labels,
                              frontend_embeds)

    def init_cache(self, batch: int, seq_len: int, device=None,
                   enc_len: int | None = None):
        return stacks.init_cache(self.cfg, batch, seq_len,
                                 resolve_device(device), enc_len)

    def prefill(self, params, tokens, cache, frontend_embeds=None):
        return stacks.prefill(params, self.cfg, tokens, cache,
                              frontend_embeds)

    def decode_step(self, params, token, cache, index: int,
                    frontend_embeds=None):
        """``frontend_embeds`` is taken for the reference's signature and
        not read: a vision prefix lives in the cache, and an enc-dec
        model's encoder memory too (as its cross K/V)."""
        return stacks.decode_step(params, self.cfg, token, cache, index)


def build_model(cfg: ArchConfig) -> Model:
    cfg.check()
    return Model(cfg)


# ---------------------------------------------------------------------------
# the weight carrier
# ---------------------------------------------------------------------------

def _copy_tree(module: nn.Module, tree: dict, where: str, done: set) -> None:
    for name, val in tree.items():
        path = f"{where}.{name}" if where else name
        if isinstance(val, dict):
            _copy_tree(getattr(module, name), val, path, done)
            continue
        dst = getattr(module, name, None)
        if not isinstance(dst, torch.Tensor):
            raise KeyError(f"params_from_numpy: no parameter {path}")
        src = torch.tensor(np.asarray(val, np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"params_from_numpy: {path} has shape "
                             f"{tuple(src.shape)}, the port wants "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)
        done.add(id(dst))


def params_from_numpy(cfg: ArchConfig, tree: dict, device=None) -> stacks.Stack:
    """The port's parameters from a reference parameter tree.

    ``tree`` is ``repro.models.Model(cfg).init(...)`` with every leaf made a
    float32 numpy array (exact for bfloat16 values). The stacked
    ``[n_groups, ...]`` leaves of ``tree["groups"]`` (and of an enc-dec
    model's ``tree["enc_groups"]["enc0"]``, ``[n_enc_layers, ...]``) are
    unstacked into one module per layer; each leaf is cast to the dtype of
    its parameter.
    Raises if a leaf has no parameter, a shape differs, or a parameter is
    left without a leaf. CUDA unless ``device`` says otherwise.
    """
    dev = resolve_device(device)
    build_model(cfg)
    params = stacks.Stack(cfg, dev)
    done: set = set()
    with torch.no_grad():
        stacked = ("groups", "tail", "enc_groups")
        top = {k: v for k, v in tree.items() if k not in stacked}
        _copy_tree(params, top, "", done)
        for g in range(cfg.n_enc_layers if cfg.enc_dec else 0):
            _copy_tree(params.enc_layers[g],
                       _index_tree(tree["enc_groups"]["enc0"], g),
                       f"enc_groups.enc0[{g}]", done)
        n_pat = len(cfg.pattern)
        for i, kind in enumerate(cfg.pattern):
            sub = tree["groups"][f"{kind}{i}"]
            for g in range(cfg.n_groups):
                one = _index_tree(sub, g)
                _copy_tree(params.layers[g * n_pat + i], one,
                           f"groups.{kind}{i}[{g}]", done)
        base = cfg.n_groups * n_pat
        for i, kind in enumerate(cfg.tail):
            _copy_tree(params.layers[base + i], tree["tail"][f"tail_{kind}{i}"],
                       f"tail.tail_{kind}{i}", done)
    missing = [n for n, p in params.named_parameters() if id(p) not in done]
    if missing:
        raise KeyError(f"params_from_numpy: no leaf for {missing}")
    return params


def _index_tree(tree: dict, g: int) -> dict:
    return {k: _index_tree(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A leaf of the reference's parameter tree in the port: the names of
    the port's parameters it holds, one per layer of a pattern position
    stacked on a leading ``[n_groups]`` axis when ``stacked``."""
    names: tuple[str, ...]
    stacked: bool


def _module_layout(m: nn.Module, prefix: str) -> dict:
    # a module's parameters and sub-modules under the reference's names (a
    # norm without a scale is the reference's empty dict)
    out = {n: Leaf((prefix + n,), False) for n, p in m._parameters.items()
           if p is not None}
    for n, c in m.named_children():
        if n not in ("layers", "enc_layers"):
            out[n] = _module_layout(c, f"{prefix}{n}.")
    return out


def _stacked(trees: list[dict]) -> dict:
    return {k: (_stacked([t[k] for t in trees]) if isinstance(v, dict)
                else Leaf(tuple(t[k].names[0] for t in trees), True))
            for k, v in trees[0].items()}


def _layout(cfg: ArchConfig, params: stacks.Stack) -> dict:
    """The reference's parameter tree (``groups`` stacked over the pattern
    groups, ``tail``, an enc-dec model's ``enc_groups``) with each leaf a
    :class:`Leaf` of the port's parameter names."""
    tree = _module_layout(params, "")
    n_pat = len(cfg.pattern)
    tree["groups"] = {
        f"{kind}{i}": _stacked([
            _module_layout(params.layers[g * n_pat + i],
                           f"layers.{g * n_pat + i}.")
            for g in range(cfg.n_groups)])
        for i, kind in enumerate(cfg.pattern)}
    base = cfg.n_groups * n_pat
    tree["tail"] = {f"tail_{kind}{i}": _module_layout(
        params.layers[base + i], f"layers.{base + i}.")
        for i, kind in enumerate(cfg.tail)}
    if cfg.enc_dec:
        tree["enc_groups"] = {"enc0": _stacked([
            _module_layout(layer, f"enc_layers.{i}.")
            for i, layer in enumerate(params.enc_layers)])}
    return tree


def _layout_map(fn, layout):
    return {k: _layout_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in layout.items()}


def to_reference_tree(cfg: ArchConfig, params: stacks.Stack,
                      values: dict | None = None) -> dict:
    """The reference's tree of ``values`` (a dict keyed by the port's
    parameter names, such as ``mu`` of the optimizer; default the
    parameters themselves, detached), stacked leaves ``torch.stack``ed."""
    if values is None:
        values = {n: p.detach() for n, p in params.named_parameters()}
    return _layout_map(
        lambda lf: (torch.stack([values[n] for n in lf.names]) if lf.stacked
                    else values[lf.names[0]]),
        _layout(cfg, params))


def from_reference_tree(cfg: ArchConfig, params: stacks.Stack,
                        tree: dict) -> dict:
    """The inverse of :func:`to_reference_tree`: a dict keyed by the port's
    parameter names, stacked leaves split into their layers."""
    out = {}

    def walk(layout, sub, path):
        for k, lf in layout.items():
            if k not in sub:
                raise KeyError(f"reference tree has no leaf {path}{k}")
            if isinstance(lf, dict):
                walk(lf, sub[k], f"{path}{k}.")
            elif lf.stacked:
                out.update(zip(lf.names, sub[k]))
            else:
                out[lf.names[0]] = sub[k]

    walk(_layout(cfg, params), tree, "")
    return out


def params_to_numpy(cfg: ArchConfig, params: stacks.Stack) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's parameter
    tree, groups restacked to ``[n_groups, ...]``, every leaf a float32
    numpy array."""
    return _layout_map(lambda x: x.float().cpu().numpy(),
                       {"": to_reference_tree(cfg, params)})[""]


def decay_mask(cfg: ArchConfig, params: stacks.Stack) -> dict:
    """Which parameters AdamW's weight decay reaches, by the port's names:
    those whose reference leaf has two or more dims. The reference decays
    "matrices only" by leaf rank, so a vector stacked over the pattern
    groups (a norm scale, ``lam``) is decayed and the same vector in the
    tail or at the top is not; the port keeps that."""
    out = {}
    for lf in _leaves_of(_layout(cfg, params)):
        p = params.get_parameter(lf.names[0])
        for n in lf.names:
            out[n] = p.dim() + int(lf.stacked) >= 2
    return out


def _leaves_of(layout):
    for v in layout.values():
        if isinstance(v, dict):
            yield from _leaves_of(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# analytic parameter counts
# ---------------------------------------------------------------------------

def _layer_params(kind: str, cfg: ArchConfig, active: bool) -> int:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    attn = d * (hq + 2 * hkv) * hd + hq * hd * d
    mlp = 3 * d * ff
    if kind in ("dense", "local", "global", "enc", "attn"):
        return attn + mlp
    if kind == "dec":
        return 2 * attn + mlp
    if kind == "moe":
        m = cfg.moe
        n_active = m.top_k if active else m.num_experts
        experts = n_active * 3 * d * m.expert_d_ff
        shared = 3 * d * m.shared_d_ff
        return attn + d * m.num_experts + experts + shared
    if kind == "rec":
        w = cfg.lru_width or d
        rg = 2 * d * w + cfg.conv_width * w + 2 * w * w + w + w * d
        return rg + mlp
    if kind == "mlstm":
        dp = int(d * cfg.proj_factor)
        return 2 * d * dp + 3 * dp * dp + dp * 2 * cfg.n_heads + dp * d
    if kind == "slstm":
        return 8 * d * d + 3 * d * int(d * 4 / 3)
    raise ValueError(kind)


def count_params(cfg: ArchConfig, active: bool = False) -> int:
    """Analytic N (``active=True`` -> N_active for MoE 6*N_active*D FLOPs)."""
    kinds = list(cfg.pattern) * cfg.n_groups + list(cfg.tail)
    n = sum(_layer_params(k, cfg, active) for k in kinds)
    n += cfg.vocab * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        n += cfg.vocab * cfg.d_model
    if cfg.enc_dec:
        n += cfg.n_enc_layers * _layer_params("enc", cfg, active)
    if cfg.frontend is not None:
        n += stacks.frontend_dim(cfg) * cfg.d_model
    return int(n)


def model_flops(cfg: ArchConfig, kind: str, seq_len: int, batch: int) -> float:
    """MODEL_FLOPS per step: 6*N*D for training (fwd+bwd), 2*N*D for
    prefill, 2*N_active*batch for one decode token (D = processed tokens)."""
    n_active = count_params(cfg, active=True)
    if kind == "train":
        return 6.0 * n_active * seq_len * batch
    if kind == "prefill":
        return 2.0 * n_active * seq_len * batch
    if kind == "decode":
        return 2.0 * n_active * batch
    raise ValueError(kind)
