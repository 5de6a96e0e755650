"""Model stack of the port: the layer sequence ``pattern x n_groups + tail``
as a Python loop over layers (the reference scans over pattern groups with
stacked parameters and rematerialisation; the port keeps one module per
layer and no autograd state).

Two entry points share the layer code, as in ``repro.models.stacks``:

  ``prefill``      full-sequence forward that also fills the caches
  ``decode_step``  one token against the caches / recurrent states

A cache is a list with one entry per layer, in layer order: an
``AttnCache`` for an attention or ``moe`` layer, ``(state, conv_state)``
for a ``rec`` layer. Every tensor of it has the batch on axis 0.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import layers as ly
from .config import ArchConfig

ATTN_KINDS = {"dense", "local", "global", "attn", "moe"}
PORTED_KINDS = ATTN_KINDS | {"rec"}


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """The kind of every layer, in order: the pattern repeated over the
    groups, then the tail."""
    return list(cfg.pattern) * cfg.n_groups + list(cfg.tail)


class Layer(nn.Module):
    def __init__(self, kind: str, cfg: ArchConfig, device=None):
        super().__init__()
        if kind not in PORTED_KINDS:
            raise ValueError(kind)
        self.kind = kind
        self.norm1 = ly.Norm(cfg, cfg.d_model, device)
        if kind == "rec":
            self.rglru = ly.RGLRU(cfg, device)
        else:
            self.attn = ly.Attention(cfg, device)
        self.norm2 = ly.Norm(cfg, cfg.d_model, device)
        if kind == "moe":
            self.moe = ly.MoE(cfg, device)
        else:
            self.mlp = ly.MLP(cfg, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        # the reference's order: the mixer, then the MLP or the experts
        mixer = self.rglru if self.kind == "rec" else self.attn
        ffn = self.moe if self.kind == "moe" else self.mlp
        for m in (self.norm1, mixer, self.norm2, ffn):
            m.reset_parameters(gen)


class Stack(nn.Module):
    """All parameters of a model: ``embed`` (bfloat16 [vocab, d]),
    ``final_norm``, ``lm_head`` (untied models only) and ``layers``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        bf = torch.bfloat16
        self.embed = ly._param((cfg.vocab, cfg.d_model), bf, device)
        self.final_norm = ly.Norm(cfg, cfg.d_model, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else ly._param((cfg.d_model, cfg.vocab), bf, device))
        self.layers = nn.ModuleList(Layer(kind, cfg, device)
                                    for kind in layer_kinds(cfg))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's distributions: embeddings at 0.02, dense weights
        at 1/sqrt(fan_in), conv at 0.1, norm scales 1, lam 2."""
        ly._normal_(self.embed, gen, 0.02)
        self.final_norm.reset_parameters(gen)
        if self.lm_head is not None:
            ly._dense_init_(self.lm_head, gen)
        for layer in self.layers:
            layer.reset_parameters(gen)


def _layer_apply(layer: Layer, x, cfg: ArchConfig, positions, cache,
                 write_index):
    """Returns (x, new_cache)."""
    if layer.kind == "rec":
        y, nc = ly.rglru_apply(
            layer.rglru, layer.norm1(x), cfg,
            state=None if cache is None else cache[0],
            conv_state=None if cache is None else cache[1])
    else:
        window = cfg.window if layer.kind in ("local", "attn") else 0
        y, nc = ly.attn_apply(layer.attn, layer.norm1(x), cfg,
                              positions=positions, window=window,
                              cache=cache, write_index=write_index)
    x = x + y
    h = layer.norm2(x)
    x = x + (ly.moe_apply(layer.moe, h, cfg) if layer.kind == "moe"
             else ly.mlp_apply(layer.mlp, h, cfg))
    return x, nc


def _layer_cache(kind: str, cfg: ArchConfig, batch: int, seq_len: int,
                 device):
    if kind in ("dense", "global", "moe"):
        return ly.make_cache(cfg, batch, seq_len, device=device)
    if kind in ("local", "attn"):
        return ly.make_cache(cfg, batch, seq_len, window=cfg.window,
                             device=device)
    if kind == "rec":
        return ly.rglru_state(cfg, batch, device)
    raise ValueError(kind)


def _scale_embed(cfg: ArchConfig, x):
    # gemma-family models scale the embedding by sqrt(d), in bfloat16
    if cfg.name.startswith(("gemma2", "recurrentgemma")):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _logits(p: Stack, cfg: ArchConfig, x):
    head = p.embed.T if cfg.tie_embeddings else p.lm_head
    logits = (x @ head).float()
    if cfg.final_softcap > 0:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _run(p: Stack, cfg: ArchConfig, x, positions, caches, write_index):
    new_caches = []
    for i, layer in enumerate(p.layers):
        x, nc = _layer_apply(layer, x, cfg, positions, caches[i], write_index)
        new_caches.append(nc)
    return p.final_norm(x), new_caches


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None):
    """Decode caches, one entry per layer: attention layers get a cache of
    ``seq_len`` slots (``min(seq_len, window)`` for local layers), ``rec``
    layers a zero state."""
    return [_layer_cache(kind, cfg, batch, seq_len, device)
            for kind in layer_kinds(cfg)]


@torch.no_grad()
def prefill(p: Stack, cfg: ArchConfig, tokens, cache):
    """Full-sequence forward filling the caches; tokens: [B, L] on the
    parameters' device. Returns (last-token logits [B, 1, V] float32, new
    cache)."""
    B, L = tokens.shape
    x = _scale_embed(cfg, p.embed[tokens])
    positions = torch.arange(L, dtype=torch.int32,
                             device=x.device).expand(B, L).contiguous()
    x, new_cache = _run(p, cfg, x, positions, cache, 0)
    return _logits(p, cfg, x[:, -1:]), new_cache


@torch.no_grad()
def decode_step(p: Stack, cfg: ArchConfig, token, cache, index: int):
    """One decode step: token [B, 1] at absolute position ``index`` (an
    int, the same for the whole batch). Returns (logits [B, 1, V] float32,
    cache); attention caches are updated in place."""
    B = token.shape[0]
    x = _scale_embed(cfg, p.embed[token])
    positions = torch.full((B, 1), int(index), dtype=torch.int32,
                           device=x.device)
    x, new_cache = _run(p, cfg, x, positions, cache, int(index))
    return _logits(p, cfg, x), new_cache
