"""Gradient compression with error feedback: the port of
``repro.optim.compression``.

Two compressors, as in the reference, plus the byte accounting that the
collective planner (:mod:`repro_torch.distributed.collectives`) reads:

  int8    per-tensor symmetric quantisation (4x over float32)
  topk    magnitude top-k sparsification (values and int32 indices)

Error feedback keeps the residual ``x - decompress(compress(x))`` and adds
it to the next step's gradient. ``torch.round`` rounds half to even, as
``jnp.round`` does. ``torch.topk`` and ``jax.lax.top_k`` may pick other
elements among equal magnitudes at the k-th place (JAX takes the lower
index); on inputs without such ties the two select the same set.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .tree import tree_map

__all__ = ["CompressionConfig", "ef_init", "compress", "decompress",
           "compressed_bytes", "ef_roundtrip"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"            # none | int8 | topk
    topk_frac: float = 0.01


def ef_init(params):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params)


def _q_int8(x):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq_int8(q, scale):
    return q.float() * scale


def _q_topk(x, frac):
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx.to(torch.int32), tuple(x.shape)


def _dq_topk(payload):
    sel, idx, shape = payload
    flat = torch.zeros(math.prod(shape), dtype=torch.float32,
                       device=sel.device)
    flat[idx.long()] = sel
    return flat.reshape(shape)


def compress(g, err, cfg: CompressionConfig):
    """Returns (payload, new_err). ``payload`` decompresses to ~(g + err)."""
    x = g.float() + err
    if cfg.kind == "int8":
        q, scale = _q_int8(x)
        return (q, scale), x - _dq_int8(q, scale)
    if cfg.kind == "topk":
        payload = _q_topk(x, cfg.topk_frac)
        return payload, x - _dq_topk(payload)
    return x, torch.zeros_like(x)


def decompress(payload, cfg: CompressionConfig):
    if cfg.kind == "int8":
        return _dq_int8(*payload)
    if cfg.kind == "topk":
        return _dq_topk(payload)
    return payload


def ef_roundtrip(g, err, cfg: CompressionConfig):
    """compress + decompress in one step (what the pod all-reduce applies)."""
    payload, new_err = compress(g, err, cfg)
    return decompress(payload, cfg), new_err


def compressed_bytes(n_elems: int, cfg: CompressionConfig,
                     raw_dtype_bytes: int = 4) -> int:
    """Bytes on the wire per tensor of ``n_elems`` (cost-model input)."""
    if cfg.kind == "int8":
        return n_elems + 4
    if cfg.kind == "topk":
        k = max(1, int(n_elems * cfg.topk_frac))
        return k * (4 + 4)
    return n_elems * raw_dtype_bytes
