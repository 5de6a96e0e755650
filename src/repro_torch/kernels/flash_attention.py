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
neither needs ``Lq`` or ``S`` to be a multiple of a tile. The kernel walks
only the key tiles its query rows can see and masks the rest with -inf, so
a query row that sees no key at all (a window or ``q_offset`` that puts
every key out of reach, which the model never asks for) comes out zero
where the plain version averages V.

The kernel works on 128-row query tiles split between two 64-row
consumers and walks key tiles of ``key_tile(hd)`` keys; :func:`tile_plan`
computes its walk (which key tiles each consumer visits and which of those
it masks), and ``tests/test_torch_lm_kernels.py`` emulates the walk in
torch and holds it against the plain version and the Pallas kernel.

:func:`flash_attention` dispatches by the device of its inputs: the plain
version for CPU tensors, the kernel for CUDA tensors (or an error, never a
fallback). ``launches`` counts kernel launches.

With ``lse=True`` both also return the log-sum-exp of each query row's
masked, soft-capped and scaled scores, ``[B*Hq, Lq]`` float32: the kernel
writes it from its online softmax's running max and sum at the end of
each row, the plain version takes ``torch.logsumexp``. The gradient
(``repro_torch.models.chunked_attention``) reads it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)   # the head dims csrc/flash_attention.cu is built for
BLOCK_Q = 128                # query rows per work item of the kernel
CONSUMER_ROWS = 64           # ... per consumer warpgroup

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, out, lse (or null), next, BH, Lq, S, Hq, Hkv, hd, causal,
    # window, softcap, scale, q_offset, stream
    "flash_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _F, _F, _I, _P], ctypes.c_int),
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


def key_tile(hd: int) -> int:
    """Keys per tile of the kernel's walk at head dim ``hd``."""
    return 64 if hd == 256 else 128


def key_tiles(r0: int, r1: int, *, Lq: int, S: int, bk: int, causal: bool,
              window: int, q_offset: int) -> tuple[int, int]:
    """The key tiles ``[lo, hi)`` of ``bk`` keys that some query row in
    ``[r0, min(r1, Lq))`` sees (``key_tiles`` in the kernel)."""
    r1 = min(r1, Lq)
    if r1 <= r0:
        return 0, 0
    a, b = r0 + q_offset, r1 - 1 + q_offset
    k_lo = max(0, a - window + 1) if window > 0 else 0
    k_hi = min(S, b + 1) if causal else S
    if k_hi <= k_lo:
        return 0, 0
    return k_lo // bk, -(-k_hi // bk)


def tile_masked(r0: int, r1: int, kt: int, *, Lq: int, S: int, bk: int,
                causal: bool, window: int, q_offset: int) -> bool:
    """Whether key tile ``kt`` holds a pair of a query row in ``[r0,
    min(r1, Lq))`` and a key (past ``S`` included) that the row does not
    see: only such tiles evaluate the mask (``tile_masked`` in the
    kernel)."""
    r1 = min(r1, Lq)
    a, b = r0 + q_offset, r1 - 1 + q_offset
    k0 = kt * bk
    return (k0 + bk > S or (causal and k0 + bk - 1 > a)
            or (window > 0 and k0 <= b - window))


def tile_plan(Lq: int, S: int, hd: int, *, causal: bool = True,
              window: int = 0, q_offset: int = 0):
    """The kernel's walk, one entry per (query tile, consumer): ``(r0, r1,
    tiles, masked, walk)`` with the consumer's rows ``[r0, r1)`` (clipped
    to ``Lq``), the key tiles it visits, the subset it masks, and its pass
    over the item's walk in order: ``(tile, visited)`` for every tile the
    producer loads for the item (the union of both consumers' ranges),
    tiles outside the consumer's own range passed on unvisited. A consumer
    must hand back every tile of the item exactly once, or the barriers of
    the load ring fall out of step."""
    bk = key_tile(hd)
    kw = dict(Lq=Lq, S=S, bk=bk, causal=causal, window=window,
              q_offset=q_offset)
    plan = []
    for q0 in range(0, Lq, BLOCK_Q):
        blk_lo, blk_hi = key_tiles(q0, q0 + BLOCK_Q, **kw)
        for r0 in (q0, q0 + CONSUMER_ROWS):
            lo, hi = key_tiles(r0, r0 + CONSUMER_ROWS, **kw)
            if hi <= lo:          # rows that see nothing pass every tile
                lo = hi = blk_hi
            tiles = list(range(lo, hi))
            walk = ([(t, False) for t in range(blk_lo, lo)]
                    + [(t, True) for t in tiles]
                    + [(t, False) for t in range(hi, blk_hi)])
            plan.append((r0, min(r0 + CONSUMER_ROWS, Lq), tiles,
                         [t for t in tiles
                          if tile_masked(r0, r0 + CONSUMER_ROWS, t, **kw)],
                         walk))
    return plan


def flash_attention_plain(q, k, v, *, n_q_heads: int, n_kv_heads: int,
                          causal: bool = True, window: int = 0,
                          softcap: float = 0.0, scale: float | None = None,
                          q_offset: int = 0, lse: bool = False):
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
    out = (torch.softmax(s, dim=-1) @ vh).reshape(BH, Lq, hd).to(q.dtype)
    if lse:
        return out, torch.logsumexp(s, dim=-1).reshape(BH, Lq)
    return out


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
                    q_offset: int = 0, lse: bool = False):
    """GQA attention with online softmax.

    q: ``[B*Hq, Lq, hd]``; k, v: ``[B*Hkv, S, hd]``. ``window > 0`` keeps
    keys with ``kpos > qpos - window``; ``softcap > 0`` applies ``tanh(s /
    softcap) * softcap`` to the scaled scores; ``scale`` defaults to
    ``1 / sqrt(hd)``. Returns ``[B*Hq, Lq, hd]`` in q's dtype, and with
    ``lse=True`` also each row's log-sum-exp ``[B*Hq, Lq]`` float32.
    """
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, n_q_heads=n_q_heads, n_kv_heads=n_kv_heads,
            causal=causal, window=window, softcap=softcap, scale=scale,
            q_offset=q_offset, lse=lse)
    _require_cuda(q, k, v)
    _check(q, k, v, n_q_heads, n_kv_heads)
    BH, Lq, hd = q.shape
    out = torch.empty_like(q)
    row_lse = (torch.empty((BH, Lq), dtype=torch.float32, device=q.device)
               if lse else None)
    if q.numel() == 0:
        return (out, row_lse) if lse else out
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    lib = _build.load("flash_attention", _SIGNATURES)
    # the persistent blocks take their work items from this counter
    next_item = torch.zeros(1, dtype=torch.int32, device=q.device)
    _build.launch(
        lib.flash_launch, "flash_attention", q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(),
        None if row_lse is None else row_lse.data_ptr(),
        next_item.data_ptr(), BH, Lq,
        k.shape[1], n_q_heads,
        n_kv_heads, hd, int(causal), int(window), float(softcap),
        float(scale), int(q_offset),
        torch.cuda.current_stream(q.device).cuda_stream)
    launches += 1
    return (out, row_lse) if lse else out
