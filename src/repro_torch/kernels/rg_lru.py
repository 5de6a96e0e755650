"""RG-LRU linear recurrence: the CUDA kernel ``csrc/rg_lru.cu`` and its
plain PyTorch version.

Port of the Pallas TPU kernel ``repro/kernels/rg_lru.py :: rg_lru`` and of
its oracle ``repro/kernels/ref.py :: rg_lru_ref``: ``h_t = a_t * h_{t-1} +
b_t`` along axis 1 with ``h_0 = 0``, for ``a, b: [B, L, W]`` float32. The
reference model computes the same scan with ``jax.lax.associative_scan``
(``repro/models/layers.py :: rglru_apply``); the port's RG-LRU block calls
:func:`rg_lru` there.

The kernel is a single-pass scan tiled over time: each tile of
:func:`scan_plan` scans its steps locally, and the carries pass between
time tiles by decoupled look-back. The plain version walks time in order
and the reference scans associatively, so the three round in other orders
and agree to a relative error of about 1e-6 (the tests hold them to 1e-4,
the tolerance of ``tests/test_kernels.py``).

:func:`rg_lru` dispatches by the device of its inputs: the plain version
for CPU tensors, the kernel for CUDA tensors (or an error, never a
fallback). ``launches`` counts calls of the kernel, one per call.

:class:`RGLRUFn` is the scan's gradient. The adjoint ``g_t = dh_t +
a_{t+1} g_{t+1}`` is the same recurrence run backwards, so its backward is
one more :func:`rg_lru` call on reversed inputs (the kernel on the card):
the coefficients are ``a`` shifted one step earlier with a zero at the
end, then reversed; ``db = g`` and ``da = g * h_{t-1}`` with ``h_{-1} =
0``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..launch.cost import passes
from . import _build

launches = 0

# time steps and channels of the kernel's tile (one thread a channel), as
# csrc/rg_lru.cu's kT and kC
TILE_T, TILE_C = 64, 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # a, b, h, scratch, partials, B, L, W, T, C, stream
    "rg_lru_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                      ctypes.c_int),
}


@dataclass(frozen=True)
class ScanPlan:
    """The kernel's tiling of ``[B, L, W]``: tiles of ``T`` steps by ``C``
    channels, ``n_time`` along time and ``n_stripes`` along channels."""
    B: int
    L: int
    W: int
    T: int
    C: int
    n_time: int
    n_stripes: int

    @property
    def n_tiles(self) -> int:
        return self.B * self.n_time * self.n_stripes

    def order(self) -> np.ndarray:
        """``[n_tiles, 3]`` int64: (batch, time tile, stripe) by ticket,
        as the kernel maps its tickets: time-major, so a tile's time
        predecessors hold lower tickets."""
        k = np.arange(self.n_tiles, dtype=np.int64)
        chains = self.B * self.n_stripes
        r = k % chains
        return np.stack([r // self.n_stripes, k // chains,
                         r % self.n_stripes], axis=1)


def scan_plan(B: int, L: int, W: int) -> ScanPlan:
    """The tiling :func:`rg_lru` hands the kernel."""
    return ScanPlan(B, L, W, TILE_T, TILE_C, -(-L // TILE_T),
                    -(-W // TILE_C))


def rg_lru_plain(a, b):
    """The plain PyTorch version: the recurrence as a loop over time, in
    the kernel's order. Runs on any device; on fake tensors (the dry run)
    three steps stand for all (``launch.cost.passes``)."""
    h = torch.empty_like(b)
    state = torch.zeros_like(b[:, 0])
    for t in passes(b.shape[1], b):
        state = a[:, t] * state + b[:, t]
        h[:, t] = state
    return h


def _require_cuda(a, b):
    for x in (a, b):
        if x.device.type != "cuda" or x.device != a.device:
            raise ValueError("rg_lru: the kernel takes CUDA tensors on one "
                             f"device, got {x.device}")


def _check(a, b):
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError("rg_lru: expects a and b of one shape [B, L, W], "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    for x in (a, b):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("rg_lru: a and b must be contiguous float32, "
                             f"got {x.dtype}")
    if max(a.shape) >= 2 ** 31:
        raise ValueError(f"rg_lru: shape {tuple(a.shape)} out of range")


def rg_lru(a, b):
    """h_t = a_t * h_{t-1} + b_t over axis 1, h_0 = 0.

    a, b: ``[B, L, W]`` float32. Returns h: ``[B, L, W]`` float32.
    """
    global launches
    if a.device.type == "cpu":
        return rg_lru_plain(a, b)
    _require_cuda(a, b)
    _check(a, b)
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    plan = scan_plan(*a.shape)
    if plan.n_tiles >= 2 ** 31:
        raise ValueError(f"rg_lru: {plan.n_tiles} tiles out of range")
    # the ticket counter and the flags, zeroed on every call: in a captured
    # CUDA graph the zeroing is a node, so each replay starts from clean
    # flags; then each tile's per-channel partials
    n = plan.n_tiles * plan.C
    scratch = torch.zeros(1 + n, dtype=torch.int32, device=a.device)
    partials = torch.empty(3 * n, dtype=torch.float32, device=a.device)
    lib = _build.load("rg_lru", _SIGNATURES)
    _build.launch(lib.rg_lru_launch, "rg_lru", a.data_ptr(), b.data_ptr(),
                  h.data_ptr(), scratch.data_ptr(), partials.data_ptr(),
                  plan.B, plan.L, plan.W, plan.T, plan.C,
                  torch.cuda.current_stream(a.device).cuda_stream)
    launches += 1
    return h


def rg_lru_grads(a, h, dh):
    """(da, db) of ``h = rg_lru(a, b)`` for the output gradient ``dh``,
    from ``a`` and ``h``: one reversed :func:`rg_lru` call."""
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)
    g = rg_lru(torch.flip(a_next, [1]).contiguous(),
               torch.flip(dh.float(), [1]).contiguous())
    g = torch.flip(g, [1])
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    return g * h_prev, g


class RGLRUFn(torch.autograd.Function):
    """:func:`rg_lru` with its gradient (:func:`rg_lru_grads`): both passes
    are the kernel on CUDA tensors and the plain version on the CPU."""

    @staticmethod
    def forward(ctx, a, b):
        h = rg_lru(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return rg_lru_grads(a, h, dh)
