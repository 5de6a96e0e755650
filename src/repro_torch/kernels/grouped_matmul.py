"""Grouped matmul, the MoE expert products: the CUDA kernel
``csrc/grouped_matmul.cu`` and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro/kernels/grouped_matmul.py ::
grouped_matmul`` and of its oracle ``repro/kernels/ref.py ::
grouped_matmul_ref``: ``out[g] = x[g] @ w[g]`` for ``x [G, M, K]`` and ``w
[G, K, N]``, summed in float32 and returned in ``x.dtype``. The reference
model computes the same products as einsums over the expert axis
(``repro/models/layers.py :: _moe_dispatch_batched`` and ``_moe_dispatch``);
the port's MoE layer calls :func:`grouped_matmul` there, three times per
layer.

The CUDA kernel takes bfloat16 or float32 (x and w of one dtype), as the
Pallas kernel takes any dtype and accumulates in float32; the plain version
takes any. Unlike the Pallas kernel, neither needs M, N or K to be a
multiple of a tile: the MoE path gives M = 960 at prefill and M = 1 at
decode. Float32 inputs take a route of their own, plain FMA tiles with no
TF32 (``grouped_matmul_f32_launch``). For bfloat16 the kernel picks one of
three routes from the shapes (``csrc/grouped_matmul.cu``): TMA
and ``wgmma`` for large M, a streaming route for M <= 16 that reads no
weights of a group whose rows are all zero (the dispatch zero-fills the
capacity rows of experts without a token), and an element-by-element route
where K or N is not a multiple of 8. The one difference that skip makes:
a non-finite weight of a group whose x is all zero gives 0, where the plain
version gives NaN.

:func:`grouped_matmul` dispatches by the device of its inputs: the plain
version for CPU tensors, the kernel for CUDA tensors (or an error, never a
fallback). ``launches`` counts kernel launches.

:class:`GroupedMatmulFn` is the product with its gradient: two more
grouped matmuls, ``dx = dy @ w^T`` and ``dw = x^T @ dy`` group by group, on
contiguous transposes.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, w, out, G, M, K, N, stream
    "grouped_matmul_launch": ([_P, _P, _P, _I, _I, _I, _I, _P], ctypes.c_int),
    "grouped_matmul_f32_launch": ([_P, _P, _P, _I, _I, _I, _I, _P],
                                  ctypes.c_int),
}
DTYPES = (torch.bfloat16, torch.float32)


def grouped_matmul_plain(x, w):
    """The plain PyTorch version: one float32 batched product, rounded to
    ``x.dtype``. Runs on any device."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _require_cuda(x, w):
    for t in (x, w):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("grouped_matmul: the kernel takes CUDA tensors "
                             f"on one device, got {t.device}")


def _check(x, w):
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or \
            x.shape[2] != w.shape[1]:
        raise ValueError("grouped_matmul: expects x [G, M, K] and w [G, K, N], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError("grouped_matmul: the kernel takes x and w both "
                         f"bfloat16 or both float32, got {x.dtype} and "
                         f"{w.dtype}")
    for t in (x, w):
        if not t.is_contiguous():
            raise ValueError("grouped_matmul: the kernel takes contiguous "
                             "tensors")
    G, M, K = x.shape
    if G >= 65536 or (M + 63) // 64 >= 65536 or \
            max(M, K, w.shape[2]) >= 2 ** 31:
        raise ValueError(f"grouped_matmul: shapes {tuple(x.shape)}, "
                         f"{tuple(w.shape)} out of range")


def grouped_matmul(x, w):
    """``x[g] @ w[g]`` for every group g.

    x: ``[G, M, K]``; w: ``[G, K, N]``. Returns ``[G, M, N]`` in x's dtype,
    summed in float32.
    """
    global launches
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w)
    _require_cuda(x, w)
    _check(x, w)
    G, M, K = x.shape
    N = w.shape[2]
    out = torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("grouped_matmul", _SIGNATURES)
    fn = lib.grouped_matmul_f32_launch if x.dtype == torch.float32 else \
        lib.grouped_matmul_launch
    _build.launch(fn, "grouped_matmul", x.data_ptr(),
                  w.data_ptr(), out.data_ptr(), G, M, K, N,
                  torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    return out


class GroupedMatmulFn(torch.autograd.Function):
    """:func:`grouped_matmul` with its gradient, each product the kernel on
    CUDA tensors and the plain version on the CPU."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return grouped_matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_matmul(dy, w.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul(x.transpose(1, 2).contiguous(),
                                dy).to(w.dtype)
        return dx, dw
