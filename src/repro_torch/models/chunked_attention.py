"""Attention's gradient: the port of ``repro/models/chunked_attention.py``.

The reference trains through ``chunked_attention``, a ``jax.custom_vjp``
whose forward is an online softmax over key blocks and whose backward
(``_ca_bwd``) recomputes the score blocks from the saved log-sum-exp. The
port's forward is the flash kernel (``kernels.flash_attention`` with
``lse=True``: the CUDA kernel on the card, the plain version on the CPU);
:class:`FlashAttentionFn` wraps it for autograd and saves ``q, k, v, out,
lse``. Its backward, :func:`attention_bwd`, is ``_ca_bwd`` in torch ops,
the same code on the CPU and on the card: block by block over ``bq x bk``
query and key blocks it recomputes the scores in float32, ``p = exp(s -
lse)`` under the mask, ``ds = p (dp - delta)`` with ``delta = sum(dout
out)``, times the softcap's factor ``1 - (s / cap)^2``, and accumulates
``dq``, ``dk`` and ``dv`` in float32; it never holds an ``[L, S]``
matrix. Blocks that no query of the block can see (above the causal
diagonal, below the window) are skipped: their ``p`` is zero.

Layout, as the kernel's: q ``[B*Hq, L, hd]``, k and v ``[B*Hkv, S, hd]``
(GQA: q head ``h`` reads kv head ``h // (Hq / Hkv)``; ``dk`` and ``dv``
sum over the query heads of a group). The query at row ``i`` sits at
position ``q_offset + i``, key ``j`` at ``j``. Products whose operands the
reference rounds to the inputs' dtype (``p`` for ``dv``, ``ds`` for ``dq``
and ``dk``) run in that dtype; the scores and ``dp`` run in float32, as the
reference's do.
"""
from __future__ import annotations

import torch

from ..kernels import flash_attention as _flash

__all__ = ["FlashAttentionFn", "attention_bwd", "block_sizes"]


def block_sizes(L: int, S: int, bq: int, bk: int) -> tuple[int, int]:
    """The reference's blocks: ``bq`` and ``bk`` halved until they divide
    ``L`` and ``S`` (``models/layers.py::attn_apply``), capped at them."""
    while L % min(bq, L):
        bq //= 2
    while S % min(bk, S):
        bk //= 2
    return min(bq, L), min(bk, S)


def _visible(q0, q1, k0, k1, *, causal, window, q_offset, device):
    """[q1 - q0, k1 - k0] bool mask, or None when no pair is visible."""
    a, b = q0 + q_offset, q1 - 1 + q_offset
    if causal and k0 > b:
        return None
    if window > 0 and k1 - 1 <= a - window:
        return None
    return _flash.attention_mask(q1 - q0, k1 - k0, causal=causal,
                                 window=window, q_offset=q_offset + q0 - k0,
                                 device=device)


def attention_bwd(q, k, v, out, lse, dout, *, n_q_heads: int,
                  n_kv_heads: int, causal: bool, window: int, softcap: float,
                  scale: float, q_offset: int, bq: int, bk: int):
    """(dq, dk, dv) of ``out = flash_attention(q, k, v, ...)`` for the output
    gradient ``dout``, from the forward's ``out`` and ``lse``."""
    BH, L, hd = q.shape
    S = k.shape[1]
    B, G = BH // n_q_heads, n_q_heads // n_kv_heads
    bq, bk = block_sizes(L, S, bq, bk)
    dt = q.dtype
    f32 = torch.float32
    # [B, Hkv, G, L, hd] for the queries, [B, Hkv, 1, S, hd] for the keys
    qg = q.reshape(B, n_kv_heads, G, L, hd)
    kg = k.reshape(B, n_kv_heads, 1, S, hd)
    vg = v.reshape(B, n_kv_heads, 1, S, hd)
    dog = dout.to(dt).reshape(B, n_kv_heads, G, L, hd)
    lseg = lse.reshape(B, n_kv_heads, G, L)
    delta = (dout.float() * out.float()).sum(-1).reshape(B, n_kv_heads, G, L)
    dq = torch.zeros(qg.shape, dtype=f32, device=q.device)
    dk = torch.zeros(kg.shape[:2] + kg.shape[3:], dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)

    def fold(x):
        # [B, Hkv, G, n, m] -> [B, Hkv, m, G * n]: a product over the group
        # and the rows at once sums dk / dv over the group's q heads
        return x.permute(0, 1, 4, 2, 3).reshape(B, n_kv_heads, x.shape[-1],
                                                G * x.shape[3])

    for q0 in range(0, L, bq):
        qs = slice(q0, q0 + bq)
        qb, dob = qg[:, :, :, qs], dog[:, :, :, qs]
        qbf = qb.float()
        lb, db = lseg[..., qs, None], delta[..., qs, None]
        for k0 in range(0, S, bk):
            mask = _visible(q0, q0 + bq, k0, k0 + bk, causal=causal,
                            window=window, q_offset=q_offset,
                            device=q.device)
            if mask is None:
                continue
            ks = slice(k0, k0 + bk)
            kb, vb = kg[:, :, :, ks], vg[:, :, :, ks]
            s = (qbf @ kb.float().transpose(-1, -2)) * scale
            if softcap > 0:
                s = torch.tanh(s / softcap) * softcap
            p = torch.where(mask, torch.exp(s - lb), 0.0)
            dv[:, :, ks] += (fold(p.to(dt))
                             @ dob.reshape(B, n_kv_heads, G * bq, hd)).float()
            dp = dob.float() @ vb.float().transpose(-1, -2)
            ds = p * (dp - db)
            if softcap > 0:
                # s = cap tanh(raw / cap): d raw = ds (1 - (s / cap)^2)
                ds = ds * (1.0 - torch.square(s / softcap))
            ds = (ds * scale).to(dt)
            dq[:, :, :, qs] += (ds @ kb).float()
            dk[:, :, ks] += (fold(ds)
                             @ qb.reshape(B, n_kv_heads, G * bq, hd)).float()
    return (dq.reshape(BH, L, hd).to(q.dtype),
            dk.reshape(k.shape).to(k.dtype), dv.reshape(v.shape).to(v.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient. Forward: the flash kernel with
    ``lse=True`` (the CUDA kernel on the card, the plain version on the
    CPU); backward: :func:`attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, n_q_heads, n_kv_heads, causal, window, softcap,
                scale, q_offset, bq, bk):
        out, lse = _flash.flash_attention(
            q, k, v, n_q_heads=n_q_heads, n_kv_heads=n_kv_heads,
            causal=causal, window=window, softcap=softcap, scale=scale,
            q_offset=q_offset, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(n_q_heads=n_q_heads, n_kv_heads=n_kv_heads,
                        causal=causal, window=window, softcap=softcap,
                        scale=scale, q_offset=q_offset, bq=bq, bk=bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, lse, dout, **ctx.args)
        return (dq, dk, dv) + (None,) * 9

