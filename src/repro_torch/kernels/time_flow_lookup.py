"""Time-flow table lookup: the CUDA kernel ``csrc/time_flow_lookup.cu`` and
its plain PyTorch version.

Port of the Pallas TPU kernel ``repro/kernels/time_flow_lookup.py ::
time_flow_lookup`` and of its oracle ``repro/kernels/ref.py ::
time_flow_lookup_ref``. For each packet it gathers the K-slot row at
(node, dst) of one slice's tables, counts the valid slots (``>= 0``; the
compilers keep them contiguous from slot 0), picks slot
``hash % max(nvalid, 1)`` with the hash read as an unsigned 32-bit value,
and returns (next hop, departure offset).

Unlike the TPU kernel, this one takes the stacked ``[2, Tr, N, D, K]``
(injection, transit) tables that the fabric step builds, the slice ``tm``
and a per-packet (or constant) table selector, so the fabric's fused
injection / re-lookup site is one launch. Out-of-range selectors, nodes and
destinations are clamped into the table, as JAX clamps a gather.

:func:`time_flow_lookup` dispatches by the device of its inputs: the plain
version for CPU tensors, the kernel for CUDA tensors (or an error, never a
fallback). ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MASK32 = 0xFFFFFFFF

launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # tbl_next, tbl_dep, Tr, N, D, K, tm, sel (nullable), sel_const,
    # node, dst, hash, out_next, out_dep, P, stream
    "tfl_launch": ([_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P,
                    _L, _P], ctypes.c_int),
}


def select_slot(row_n, row_d, hashv):
    """Choose a multipath slot by hash over the valid slots of each row
    (the reference's ``fabric._select_slot``). row_*: [P, K] int32;
    hashv: [P] int32 holding the 32-bit hash pattern."""
    nvalid = (row_n >= 0).sum(-1)
    slot = (hashv.to(torch.int64) & MASK32) % nvalid.clamp(min=1)
    nxt = row_n.gather(-1, slot[:, None])[:, 0]
    off = row_d.gather(-1, slot[:, None])[:, 0]
    return nxt, off


def time_flow_lookup_plain(tbl_next, tbl_dep, tm: int, sel, node, dst,
                           hashv):
    """The plain PyTorch version: gather + :func:`select_slot`. Same
    arguments as :func:`time_flow_lookup`; runs on any device."""
    _, Tr, N, D, K = tbl_next.shape
    if isinstance(sel, torch.Tensor):
        s = sel.to(torch.int64).clamp(0, 1)
    else:
        s = min(max(int(sel), 0), 1)
    n = node.to(torch.int64).clamp(0, N - 1)
    d = dst.to(torch.int64).clamp(0, D - 1)
    row = ((s * Tr + tm) * N + n) * D + d
    return select_slot(tbl_next.reshape(-1, K)[row],
                       tbl_dep.reshape(-1, K)[row], hashv)


def _require_cuda(tbl_next, tbl_dep, sel, node, dst, hashv):
    tensors = [tbl_next, tbl_dep, node, dst, hashv]
    if isinstance(sel, torch.Tensor):
        tensors.append(sel)
    dev = node.device
    for x in tensors:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError("time_flow_lookup: the kernel takes CUDA "
                             f"tensors on one device, got {x.device}")


def _check(tbl_next, tbl_dep, tm, sel, node, dst, hashv):
    if tbl_next.dim() != 5 or tbl_next.shape[0] != 2 \
            or tbl_dep.shape != tbl_next.shape:
        raise ValueError("time_flow_lookup: tables must be two equal "
                         "[2, Tr, N, D, K] stacks, got "
                         f"{tuple(tbl_next.shape)} / {tuple(tbl_dep.shape)}")
    _, Tr, N, D, K = tbl_next.shape
    if min(Tr, N, D, K) < 1:
        raise ValueError(f"time_flow_lookup: empty tables {tuple(tbl_next.shape)}")
    if not 0 <= tm < Tr:
        raise ValueError(f"time_flow_lookup: slice {tm} outside [0, {Tr})")
    P = node.shape[0]
    vecs = [node, dst, hashv] + ([sel] if isinstance(sel, torch.Tensor) else [])
    for x in [tbl_next, tbl_dep] + vecs:
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("time_flow_lookup: every tensor must be "
                             "contiguous int32")
    for x in vecs:
        if x.shape != (P,):
            raise ValueError("time_flow_lookup: node, dst, hash and sel must "
                             f"be [P] vectors, got {tuple(x.shape)} for P={P}")


def time_flow_lookup(tbl_next, tbl_dep, tm: int, sel, node, dst, hashv):
    """Per-packet time-flow table lookup.

    tbl_next / tbl_dep: ``[2, Tr, N, D, K]`` int32 stacks (selector 0 is
    the injection table, 1 the transit table; invalid slots -1 / 0);
    tm: the slice, ``0 <= tm < Tr``; sel: ``[P]`` int32 selectors or one
    int for every packet; node / dst: ``[P]`` int32; hashv: ``[P]`` int32
    carrying the 32-bit hash pattern. Returns ``(next_hop, dep_offset)``,
    two ``[P]`` int32 tensors.
    """
    global launches
    if node.device.type == "cpu":
        return time_flow_lookup_plain(tbl_next, tbl_dep, tm, sel, node, dst,
                                      hashv)
    _require_cuda(tbl_next, tbl_dep, sel, node, dst, hashv)
    _check(tbl_next, tbl_dep, tm, sel, node, dst, hashv)
    _, Tr, N, D, K = tbl_next.shape
    P = node.shape[0]
    out_next = torch.empty(P, dtype=torch.int32, device=node.device)
    out_dep = torch.empty(P, dtype=torch.int32, device=node.device)
    if P == 0:
        return out_next, out_dep
    lib = _build.load("time_flow_lookup", _SIGNATURES)
    per_packet = isinstance(sel, torch.Tensor)
    _build.launch(
        lib.tfl_launch, "time_flow_lookup",
        tbl_next.data_ptr(), tbl_dep.data_ptr(), Tr, N, D, K, tm,
        sel.data_ptr() if per_packet else None,
        0 if per_packet else int(sel),
        node.data_ptr(), dst.data_ptr(), hashv.data_ptr(),
        out_next.data_ptr(), out_dep.data_ptr(), P,
        torch.cuda.current_stream(node.device).cuda_stream)
    launches += 1
    return out_next, out_dep
