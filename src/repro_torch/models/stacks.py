"""Model stack of the port: the layer sequence ``pattern x n_groups + tail``
as a Python loop over layers (the reference scans over pattern groups with
stacked parameters and rematerialisation; the port keeps one module per
layer and no autograd state).

Two entry points share the layer code, as in ``repro.models.stacks``:

  ``prefill``      full-sequence forward that also fills the caches
  ``decode_step``  one token against the caches / recurrent states

Frontends, as in the reference: a vision model (a frontend, not enc-dec)
projects its patch embeddings with ``frontend_proj`` and puts them before
the prompt's tokens, so its first decode step is at ``frontend_tokens +
prompt_len``; an encoder-decoder model projects its audio frames, runs
them through the ``enc`` layers (bidirectional) and ``enc_final_norm``,
and each ``dec`` layer attends to that memory after its causal
self-attention.

A cache is a list with one entry per layer, in layer order: an
``AttnCache`` for an attention or ``moe`` layer; ``(self, cross)``, two
``AttnCache``s, for a ``dec`` layer, ``cross`` holding K and V of the
encoder memory (projected once, at prefill, where the reference keeps the
memory itself and projects it again at every decode step); ``(state,
conv_state)`` for a ``rec`` layer; ``(C, n, m)`` for an ``mlstm`` layer and
``(c, n, h, m)`` for an ``slstm`` layer. Every tensor of it has the batch
on axis 0.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import layers as ly
from .config import ArchConfig

KINDS = {"dense", "local", "global", "attn", "moe", "enc", "dec", "rec",
         "mlstm", "slstm"}


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """The kind of every layer, in order: the pattern repeated over the
    groups, then the tail."""
    return list(cfg.pattern) * cfg.n_groups + list(cfg.tail)


class Layer(nn.Module):
    def __init__(self, kind: str, cfg: ArchConfig, device=None):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(kind)
        self.kind = kind
        self.norm1 = ly.Norm(cfg, cfg.d_model, device)
        if kind == "rec":
            self.rglru = ly.RGLRU(cfg, device)
        elif kind == "mlstm":
            self.mlstm = ly.MLSTM(cfg, device)
        elif kind == "slstm":
            self.slstm = ly.SLSTM(cfg, device)
        else:
            self.attn = ly.Attention(cfg, device)
        if kind == "dec":
            self.norm_x = ly.Norm(cfg, cfg.d_model, device)
            self.xattn = ly.Attention(cfg, device)
        if kind in ("mlstm", "slstm"):      # the blocks carry their own FFN
            return
        self.norm2 = ly.Norm(cfg, cfg.d_model, device)
        if kind == "moe":
            self.moe = ly.MoE(cfg, device)
        else:
            self.mlp = ly.MLP(cfg, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        # the reference's order: the mixer (and the cross-attention), then
        # the MLP or the experts
        for m in self.children():
            m.reset_parameters(gen)


class Stack(nn.Module):
    """All parameters of a model: ``embed`` (bfloat16 [vocab, d]),
    ``final_norm``, ``lm_head`` (untied models only) and ``layers``; an
    encoder-decoder model also ``enc_layers`` and ``enc_final_norm``, a
    model with a frontend ``frontend_proj`` (bfloat16 [frontend_dim, d])."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        bf = torch.bfloat16
        self.embed = ly._param((cfg.vocab, cfg.d_model), bf, device)
        self.final_norm = ly.Norm(cfg, cfg.d_model, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else ly._param((cfg.d_model, cfg.vocab), bf, device))
        self.layers = nn.ModuleList(Layer(kind, cfg, device)
                                    for kind in layer_kinds(cfg))
        self.enc_layers = self.enc_final_norm = self.frontend_proj = None
        if cfg.enc_dec:
            self.enc_layers = nn.ModuleList(
                Layer("enc", cfg, device) for _ in range(cfg.n_enc_layers))
            self.enc_final_norm = ly.Norm(cfg, cfg.d_model, device)
        if cfg.frontend is not None:
            self.frontend_proj = ly._param((frontend_dim(cfg), cfg.d_model),
                                           bf, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's distributions: embeddings at 0.02, dense weights
        at 1/sqrt(fan_in), conv at 0.1, norm scales 1, lam 2."""
        ly._normal_(self.embed, gen, 0.02)
        self.final_norm.reset_parameters(gen)
        if self.lm_head is not None:
            ly._dense_init_(self.lm_head, gen)
        for layer in self.layers:
            layer.reset_parameters(gen)
        if self.enc_layers is not None:
            for layer in self.enc_layers:
                layer.reset_parameters(gen)
            self.enc_final_norm.reset_parameters(gen)
        if self.frontend_proj is not None:
            ly._dense_init_(self.frontend_proj, gen)


def frontend_dim(cfg: ArchConfig) -> int:
    """Width of the stub frontend's embeddings: audio frames 512, vision
    patches 1,024."""
    return 512 if cfg.frontend == "audio" else 1024


def prefix_len(cfg: ArchConfig) -> int:
    """Tokens a vision model's prefill puts before the prompt (its patch
    embeddings); 0 for every other model."""
    return cfg.frontend_tokens if cfg.frontend and not cfg.enc_dec else 0


def _layer_apply(layer: Layer, x, cfg: ArchConfig, positions, cache,
                 write_index, memory=None):
    """Returns (x, new_cache). ``memory``: the encoder's output and its
    positions at an enc-dec prefill (``dec`` layers project their cross
    K/V from it), else None (they read the cached K/V)."""
    kind = layer.kind
    if kind in ("mlstm", "slstm"):
        apply = ly.mlstm_apply if kind == "mlstm" else ly.slstm_apply
        y, nc = apply(getattr(layer, kind), layer.norm1(x), cfg, state=cache)
        return x + y, nc
    if kind == "rec":
        y, nc = ly.rglru_apply(
            layer.rglru, layer.norm1(x), cfg,
            state=None if cache is None else cache[0],
            conv_state=None if cache is None else cache[1])
    else:
        window = cfg.window if kind in ("local", "attn") else 0
        y, nc = ly.attn_apply(layer.attn, layer.norm1(x), cfg,
                              positions=positions, causal=kind != "enc",
                              window=window,
                              cache=cache[0] if kind == "dec" else cache,
                              write_index=write_index)
    x = x + y
    if kind == "dec":
        kv = cache[1] if memory is None else ly.cross_kv(
            layer.xattn, memory[0], cfg, memory[1])
        x = x + ly.cross_attend(layer.xattn, layer.norm_x(x), cfg, kv)
        nc = (nc, kv)
    h = layer.norm2(x)
    x = x + (ly.moe_apply(layer.moe, h, cfg) if kind == "moe"
             else ly.mlp_apply(layer.mlp, h, cfg))
    return x, nc


def _layer_cache(kind: str, cfg: ArchConfig, batch: int, seq_len: int,
                 enc_len: int, device):
    if kind in ("dense", "global", "moe", "enc"):
        return ly.make_cache(cfg, batch, seq_len, device=device)
    if kind in ("local", "attn"):
        return ly.make_cache(cfg, batch, seq_len, window=cfg.window,
                             device=device)
    if kind == "dec":
        # the cross part holds the K/V of a zero memory (zero), at the
        # memory's positions, as the reference's zero ``enc_out`` gives
        cross = ly.make_cache(cfg, batch, enc_len, device=device)
        cross.pos.copy_(torch.arange(enc_len, dtype=torch.int32,
                                     device=device))
        return ly.make_cache(cfg, batch, seq_len, device=device), cross
    if kind == "rec":
        return ly.rglru_state(cfg, batch, device)
    if kind == "mlstm":
        return ly.mlstm_state(cfg, batch, device)
    if kind == "slstm":
        return ly.slstm_state(cfg, batch, device)
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


def _positions(B: int, L: int, device):
    return torch.arange(L, dtype=torch.int32, device=device).expand(
        B, L).contiguous()


def _run(p: Stack, cfg: ArchConfig, x, positions, caches, write_index,
         memory=None):
    new_caches = []
    for i, layer in enumerate(p.layers):
        x, nc = _layer_apply(layer, x, cfg, positions, caches[i], write_index,
                             memory)
        new_caches.append(nc)
    return p.final_norm(x), new_caches


def _encoder(p: Stack, cfg: ArchConfig, frontend_embeds):
    """The encoder of an enc-dec model: the frontend's embeddings (rounded
    to bfloat16, as the reference does whatever the weights' dtype) through
    ``frontend_proj``, the ``enc`` layers and ``enc_final_norm``. Returns
    (memory [B, Le, d], positions [B, Le])."""
    fx = frontend_embeds.to(torch.bfloat16).to(p.frontend_proj.dtype) \
        @ p.frontend_proj
    B, Le, _ = fx.shape
    pos = _positions(B, Le, fx.device)
    for layer in p.enc_layers:
        fx, _ = _layer_apply(layer, fx, cfg, pos, None, None)
    return p.enc_final_norm(fx), pos


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None,
               enc_len: int | None = None):
    """Decode caches, one entry per layer: attention layers get a cache of
    ``seq_len`` slots (``min(seq_len, window)`` for local layers), ``dec``
    layers also a cross part of ``enc_len`` slots (default
    ``frontend_tokens``), the recurrent layers a zero state (the xLSTM
    stabilisers at -inf)."""
    enc_len = enc_len or cfg.frontend_tokens
    return [_layer_cache(kind, cfg, batch, seq_len, enc_len, device)
            for kind in layer_kinds(cfg)]


@torch.no_grad()
def prefill(p: Stack, cfg: ArchConfig, tokens, cache, frontend_embeds=None):
    """Full-sequence forward filling the caches; tokens: [B, L] on the
    parameters' device. A vision model's ``frontend_embeds`` [B, F,
    frontend_dim] are projected and put before the tokens (positions 0 ..
    F + L - 1); an enc-dec model's are encoded, and its ``dec`` layers
    project their cross K/V from the memory into the cache. Returns
    (last-token logits [B, 1, V] float32, new cache)."""
    B, L = tokens.shape
    x = p.embed[tokens]
    if cfg.frontend is not None and not cfg.enc_dec and \
            frontend_embeds is not None:
        fx = frontend_embeds.to(x.dtype) @ p.frontend_proj
        x = torch.cat([fx, x], 1)
    x = _scale_embed(cfg, x)
    memory = None
    if cfg.enc_dec:
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder prefill needs "
                             "frontend_embeds")
        memory = _encoder(p, cfg, frontend_embeds)
    x, new_cache = _run(p, cfg, x, _positions(B, x.shape[1], x.device), cache,
                        0, memory)
    return _logits(p, cfg, x[:, -1:]), new_cache


@torch.no_grad()
def decode_step(p: Stack, cfg: ArchConfig, token, cache, index: int):
    """One decode step: token [B, 1] at absolute position ``index`` (an
    int, the same for the whole batch; after a vision prefix of F tokens
    and a prompt of L, the first step is at F + L). An enc-dec model reads
    the encoder memory's K/V from the cache. Returns (logits [B, 1, V]
    float32, cache); attention caches are updated in place, recurrent
    states replaced."""
    B = token.shape[0]
    x = _scale_embed(cfg, p.embed[token])
    positions = torch.full((B, 1), int(index), dtype=torch.int32,
                           device=x.device)
    x, new_cache = _run(p, cfg, x, positions, cache, int(index))
    return _logits(p, cfg, x), new_cache
