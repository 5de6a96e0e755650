"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain PyTorch version.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py ::
flash_attention`` and of its oracle ``repro/kernels/ref.py ::
flash_attention_ref``: GQA attention of ``q [B*Hq, Lq, hd]`` against
``k, v [B*Hkv, S, hd]`` with an optional causal mask, local window and tanh
logit softcap; the query at row ``i`` sits at absolute position ``q_offset
+ i`` and key ``j`` at ``j``. The reference model computes the same math at
prefill with ``repro/models/chunked_attention.py``; the port's attention
layer calls :func:`flash_attention` there.

The plain version keeps the softmax weights in float32, as the Pallas
kernel does. The CUDA kernel takes bfloat16 only and rounds the weights to
bfloat16 before multiplying them with V (as ``chunked_attention`` does), so
on bfloat16 inputs the two agree to the bfloat16 tolerance of
``tests/test_kernels.py`` (relative error 2e-2). Unlike the Pallas kernel,
neither needs ``Lq`` or ``S`` to be a multiple of a tile. The kernel skips
the key tiles that no query of its tile can see, so a query row that sees
no key at all (a window or ``q_offset`` that puts every key out of reach,
which the model never asks for) gets another meaningless average than the
plain version's.

:func:`flash_attention` dispatches by the device of its inputs: the plain
version for CPU tensors, the kernel for CUDA tensors (or an error, never a
fallback). ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)   # the head dims csrc/flash_attention.cu is built for

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, out, BH, Lq, S, Hq, Hkv, hd, causal, window, softcap, scale,
    # q_offset, stream
    "flash_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                      _I, _P], ctypes.c_int),
}


def attention_mask(Lq: int, S: int, *, causal: bool, window: int,
                   q_offset: int = 0, device=None):
    """``[Lq, S]`` bool: key ``j`` is visible to the query at row ``i``."""
    qpos = q_offset + torch.arange(Lq, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = torch.ones(Lq, S, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q, k, v, *, n_q_heads: int, n_kv_heads: int,
                          causal: bool = True, window: int = 0,
                          softcap: float = 0.0, scale: float | None = None,
                          q_offset: int = 0):
    """The plain PyTorch version: the whole score matrix in float32, masked,
    softmaxed and multiplied with V in float32. Same arguments as
    :func:`flash_attention`; runs on any device."""
    BH, Lq, hd = q.shape
    B, S = BH // n_q_heads, k.shape[1]
    group = n_q_heads // n_kv_heads
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qh = q.float().reshape(B, n_kv_heads, group, Lq, hd)
    kh = k.float().reshape(B, n_kv_heads, 1, S, hd)
    vh = v.float().reshape(B, n_kv_heads, 1, S, hd)
    s = (qh @ kh.transpose(-1, -2)) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    mask = attention_mask(Lq, S, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    out = torch.softmax(s, dim=-1) @ vh
    return out.reshape(BH, Lq, hd).to(q.dtype)


def _require_cuda(q, k, v):
    for x in (q, k, v):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError("flash_attention: the kernel takes CUDA tensors "
                             f"on one device, got {x.device}")


def _check(q, k, v, n_q_heads, n_kv_heads):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError("flash_attention: expects q [B*Hq, Lq, hd] and k, v "
                         f"[B*Hkv, S, hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, Lq, hd = q.shape
    if n_kv_heads <= 0 or n_q_heads % n_kv_heads or BH % n_q_heads or \
            k.shape[0] != BH // n_q_heads * n_kv_heads or k.shape[2] != hd:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} do "
            f"not fit Hq={n_q_heads}, Hkv={n_kv_heads}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    for x in (q, k, v):
        if x.dtype != torch.bfloat16 or not x.is_contiguous() or \
                x.data_ptr() % 16:
            raise ValueError("flash_attention: the kernel takes contiguous, "
                             f"16-byte aligned bfloat16 tensors, got {x.dtype}")
    if BH >= 65536 or k.shape[1] < 1 or max(Lq, k.shape[1]) >= 2 ** 31 // hd:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)} out of range")


def flash_attention(q, k, v, *, n_q_heads: int, n_kv_heads: int,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None,
                    q_offset: int = 0):
    """GQA attention with online softmax.

    q: ``[B*Hq, Lq, hd]``; k, v: ``[B*Hkv, S, hd]``. ``window > 0`` keeps
    keys with ``kpos > qpos - window``; ``softcap > 0`` applies ``tanh(s /
    softcap) * softcap`` to the scaled scores; ``scale`` defaults to
    ``1 / sqrt(hd)``. Returns ``[B*Hq, Lq, hd]`` in q's dtype.
    """
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, n_q_heads=n_q_heads, n_kv_heads=n_kv_heads,
            causal=causal, window=window, softcap=softcap, scale=scale,
            q_offset=q_offset)
    _require_cuda(q, k, v)
    _check(q, k, v, n_q_heads, n_kv_heads)
    BH, Lq, hd = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    lib = _build.load("flash_attention", _SIGNATURES)
    _build.launch(
        lib.flash_launch, "flash_attention", q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), BH, Lq, k.shape[1], n_q_heads,
        n_kv_heads, hd, int(causal), int(window), float(softcap),
        float(scale), int(q_offset),
        torch.cuda.current_stream(q.device).cuda_stream)
    launches += 1
    return out
