"""Flash-decode: the CUDA kernel ``csrc/decode_attention.cu`` and its plain
PyTorch version.

Port of the Pallas TPU kernel ``repro/kernels/decode_attention.py ::
decode_attention`` and of its oracle ``repro/kernels/ref.py ::
decode_attention_ref``: one query token per sequence, ``q [B, Hq, hd]``,
against a ring-buffer KV cache ``k, v [B, S, Kv, hd]`` whose slots carry
their absolute positions in ``pos [B, S]`` (int32, -1 = empty). Slot ``j``
is visible when ``0 <= pos <= cur_index`` and, with a window, ``pos >
cur_index - window``. The reference model computes the same math at decode
with an einsum (``repro/models/layers.py :: attn_apply``); the port's
attention layer calls :func:`decode_attention` there.

Both versions keep the softmax weights in float32 for the product with V;
the reference model's einsum path rounds them to bfloat16 first, so the
port's decode agrees with it to the bfloat16 tolerance.

:func:`decode_attention` dispatches by the device of its inputs: the plain
version for CPU tensors, the kernel for CUDA tensors (or an error, never a
fallback). ``launches`` counts calls of the kernel, one per call: the
kernel runs in two passes (the splits of the cache, then their merge),
whose split count :func:`split_plan` picks from the shapes.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

NEG_INF = -1e30

launches = 0

TILE = 32          # cache slots a split is a multiple of
MAX_SPAN = 4096    # cache slots per split at most (kMaxSpan)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k_cache, v_cache, pos, ws, out, B, S, Kv, G, hd, cur_index, window,
    # softcap, scale, n_split, span, stream
    "decode_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _F, _F, _I, _I, _P], ctypes.c_int),
}


def valid_slots(pos, cur_index: int, window: int):
    """``[B, S]`` bool: the cache slots a query at ``cur_index`` sees."""
    valid = (pos >= 0) & (pos <= cur_index)
    if window > 0:
        valid &= pos > cur_index - window
    return valid


def decode_attention_plain(q, k_cache, v_cache, pos, cur_index: int, *,
                           n_q_heads: int, n_kv_heads: int, window: int = 0,
                           softcap: float = 0.0, scale: float | None = None):
    """The plain PyTorch version: scores over the whole cache in float32,
    masked by :func:`valid_slots`, softmaxed and multiplied with V in
    float32. Same arguments as :func:`decode_attention`; runs on any
    device."""
    B, Hq, hd = q.shape
    S = k_cache.shape[1]
    group = n_q_heads // n_kv_heads
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qh = q.float().reshape(B, n_kv_heads, group, 1, hd)
    kh = k_cache.float().permute(0, 2, 1, 3)[:, :, None]   # [B, Kv, 1, S, hd]
    vh = v_cache.float().permute(0, 2, 1, 3)[:, :, None]
    s = (qh @ kh.transpose(-1, -2)) * scale                 # [B, Kv, G, 1, S]
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    valid = valid_slots(pos, int(cur_index), window)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    out = torch.softmax(s, dim=-1) @ vh                     # [B, Kv, G, 1, hd]
    return out.reshape(B, Hq, hd).to(q.dtype)


def split_plan(batch_kv: int, S: int, sms: int) -> tuple[int, int]:
    """``(n_split, span)``: the kernel's cache of ``S`` slots in ``n_split``
    runs of ``span`` slots, each a whole number of ``TILE``-slot tiles, so
    that ``batch_kv * n_split`` blocks come to about two per SM where S
    allows it, and no split exceeds ``MAX_SPAN`` slots."""
    tiles = -(-S // TILE)
    want = max(-(-2 * sms // batch_kv), -(-S // MAX_SPAN))
    per = -(-tiles // min(tiles, want))
    return -(-tiles // per), per * TILE


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _require_cuda(q, k_cache, v_cache, pos):
    for x in (q, k_cache, v_cache, pos):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError("decode_attention: the kernel takes CUDA tensors "
                             f"on one device, got {x.device}")


def _check(q, k_cache, v_cache, pos, n_q_heads, n_kv_heads):
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("decode_attention: expects q [B, Hq, hd] and k, v "
                         f"[B, S, Kv, hd], got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Hq, hd = q.shape
    _, S, Kv, _ = k_cache.shape
    if Hq != n_q_heads or Kv != n_kv_heads or Hq % Kv or \
            k_cache.shape[0] != B or k_cache.shape[3] != hd:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} and cache "
            f"{tuple(k_cache.shape)} do not fit Hq={n_q_heads}, "
            f"Kv={n_kv_heads}")
    G = Hq // Kv
    if hd % 16 or hd > 512 or G > 64 or -(-G // 4) * hd > 2048:
        raise ValueError("decode_attention: the kernel takes hd a multiple "
                         "of 16 up to 512, G <= 64 and ceil(G / 4) * hd <= "
                         f"2048, got hd={hd}, G={G}")
    for x in (q, k_cache, v_cache):
        if x.dtype != torch.bfloat16 or not x.is_contiguous() or \
                x.data_ptr() % 16:
            raise ValueError("decode_attention: the kernel takes contiguous, "
                             f"16-byte aligned bfloat16 tensors, got {x.dtype}")
    if pos.dtype != torch.int32 or pos.shape != (B, S) or \
            not pos.is_contiguous():
        raise ValueError("decode_attention: pos must be a contiguous [B, S] "
                         f"int32 tensor, got {pos.dtype} {tuple(pos.shape)}")
    if S < 1 or B * S * Kv * hd >= 2 ** 62 or B * Kv >= 2 ** 31:
        raise ValueError(f"decode_attention: cache {tuple(k_cache.shape)} "
                         "out of range")


def decode_attention(q, k_cache, v_cache, pos, cur_index: int, *,
                     n_q_heads: int, n_kv_heads: int, window: int = 0,
                     softcap: float = 0.0, scale: float | None = None):
    """One query token per sequence against a ring-buffer KV cache.

    q: ``[B, Hq, hd]``; k_cache, v_cache: ``[B, S, Kv, hd]``; pos: ``[B,
    S]`` int32 absolute slot positions (-1 = empty); cur_index: the query's
    absolute position (an int). Returns ``[B, Hq, hd]`` in q's dtype.
    """
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, pos, cur_index, n_q_heads=n_q_heads,
            n_kv_heads=n_kv_heads, window=window, softcap=softcap,
            scale=scale)
    _require_cuda(q, k_cache, v_cache, pos)
    _check(q, k_cache, v_cache, pos, n_q_heads, n_kv_heads)
    B, Hq, hd = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    G = Hq // Kv
    lib = _build.load("decode_attention", _SIGNATURES)
    n_split, span = split_plan(B * Kv, S, _sm_count(q.device.index))
    # each split's softmax state: acc [G, hd], then (m, l) per head
    ws = torch.empty(B * Kv * n_split * G * (hd + 2), dtype=torch.float32,
                     device=q.device)
    _build.launch(
        lib.decode_launch, "decode_attention", q.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(), ws.data_ptr(),
        out.data_ptr(), B, S, Kv, G, hd, int(cur_index), int(window),
        float(softcap), float(scale), n_split, span,
        torch.cuda.current_stream(q.device).cuda_stream)
    launches += 1
    return out
