"""Time-flow table lookup: the CUDA kernel ``csrc/time_flow_lookup.cu`` and
its plain PyTorch version.

Port of the Pallas TPU kernel ``repro/kernels/time_flow_lookup.py ::
time_flow_lookup`` and of its oracle ``repro/kernels/ref.py ::
time_flow_lookup_ref``. For each packet it gathers the K-slot row at
(node, dst) of one slice's tables, counts the valid slots (``>= 0``; the
compilers keep them contiguous from slot 0), picks slot
``hash % max(nvalid, 1)`` with the hash read as an unsigned 32-bit value,
and returns (next hop, departure offset).

Unlike the TPU kernel, this one takes both (injection, transit) tables of
every slice, the slice ``tm`` and a per-packet (or constant) table
selector, so the fabric's fused injection / re-lookup site is one launch.
The tables come either as the packed ``[2, Tr, N, D, 2, K]`` table that
``core.fabric.stack_tables`` builds, where an entry's next-hop and
departure rows are adjacent (32 bytes at K = 4, one load), or as the two
``[2, Tr, N, D, K]`` stacks of the TPU's form; either may carry a version
axis after the selector (``[2, V, Tr, N, D, 2, K]``, ``[2, V, Tr, N, D,
K]``: the reconfigure loop's old, new and safe tables). Five inputs are
optional:

* ``mask``: only the packets in it are looked up; the others read nothing
  from the table and get (-1, 0), the pair of an empty slot.
* ``hashv`` as an int ``t`` in place of a hash vector: the per-packet
  multipath hash of slice ``t``, ``hash32(i + t * 0x9E3779B9)`` of each
  packet's index ``i`` (the reference's ``mp_hash``), formed in the kernel.
  With ``hash_period`` the index is taken modulo it: a scenario sweep
  (``core.fabric.simulate_fleet``) lays its scenarios' packets end to end,
  and each packet hashes its index within its own scenario. With
  ``hash_base`` the base is added to the index: a sharded run
  (``core.fabric.simulate_sharded``) gives each rank a block of the
  packets, and each packet hashes its global index.
* ``phase_off``: an ``[N]`` int32 slice offset per node (control-plane
  clock skew, ``ControlMasks.phase_off`` of the slice simulated). A packet
  at node ``n`` then reads slice ``(tm + phase_off[n]) mod Tr``, a floor
  modulo (negative offsets are a clock behind), where ``n`` is its node
  clamped into the table: the reference's ``tl = t + po_t[node]``. The
  hash keeps ``t``.
* ``vsel``: an ``[N]`` int32 table version per node (the version each
  ToR's install state selects in the slice simulated). A packet at node
  ``n`` reads version ``vsel[n]``; without it every node reads version 0,
  so a table of one version is the unversioned table.

Out-of-range selectors, versions, nodes and destinations are clamped into
the table, as JAX clamps a gather.

:func:`time_flow_lookup` dispatches by the device of its inputs: the plain
version for CPU tensors, the kernel for CUDA tensors (or an error, never a
fallback). ``launches`` counts kernel launches.

The 32-bit hashes run in int64 masked to 32 bits (this torch has no
``>>``, ``%`` or ``+`` on uint32), with the multiplies split into 16-bit
halves so no product leaves int64's range.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MASK32 = 0xFFFFFFFF
SALT = 0x9E3779B9

launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # rows_next, rows_dep, stride, V, Tr, N, D, K, tm, phase_off
    # (nullable), vsel (nullable), sel (nullable), sel_const, node, dst,
    # hash (nullable), t, hash_period, hash_base, mask (nullable),
    # out_next, out_dep, P, vec, stream
    "tfl_launch": ([_P, _P, _L, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P,
                    _P, _P, ctypes.c_uint, _L, _L, _P, _P, _P, _L, _I, _P],
                   ctypes.c_int),
}


# ---------------------------------------------------------------------------
# the multipath hash
# ---------------------------------------------------------------------------

def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32): the constant is
    split into 16-bit halves so no product exceeds 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def hash32(x):
    """The reference's ``fabric._hash32`` on int64 tensors: the low 32 bits
    of ``x`` in, an int64 in [0, 2**32) out."""
    x = x & MASK32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def as_bits(x):
    """An int64 in [0, 2**32) as the int32 with the same 32-bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def salted_hash(base, t: int):
    """The multipath hash of slice ``t``, ``hash32(base + t * 0x9E3779B9)``
    in uint32 arithmetic, as int32 bits; ``base`` is an int64 tensor."""
    return as_bits(hash32(base + ((t * SALT) & MASK32)))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def select_slot(row_n, row_d, hashv):
    """Choose a multipath slot by hash over the valid slots of each row
    (the reference's ``fabric._select_slot``). row_*: [P, K] int32;
    hashv: [P] int32 holding the 32-bit hash pattern."""
    nvalid = (row_n >= 0).sum(-1)
    slot = (hashv.to(torch.int64) & MASK32) % nvalid.clamp(min=1)
    nxt = row_n.gather(-1, slot[:, None])[:, 0]
    off = row_d.gather(-1, slot[:, None])[:, 0]
    return nxt, off


def _rows(tbl_next, tbl_dep):
    """The next-hop and departure rows of every entry, two ``[E, K]``
    views, from the packed table or the two stacks."""
    K = tbl_next.shape[-1]
    if tbl_dep is None:
        rows = tbl_next.reshape(-1, 2, K)
        return rows[:, 0], rows[:, 1]
    return tbl_next.reshape(-1, K), tbl_dep.reshape(-1, K)


def table_dims(tbl_next, tbl_dep):
    """``(V, Tr, N, D, K)`` of the packed table (``tbl_dep`` None) or of
    the two stacks, with or without the version axis (V = 1 without)."""
    lead = tbl_next.shape[:-2] if tbl_dep is None else tbl_next.shape[:-1]
    V = lead[1] if len(lead) == 5 else 1
    return (V, *lead[-3:], tbl_next.shape[-1])


def time_flow_lookup_plain(tbl_next, tbl_dep, tm: int, sel, node, dst,
                           hashv, mask=None, phase_off=None, vsel=None,
                           hash_period=None, hash_base=None):
    """The plain PyTorch version: gather + :func:`select_slot`, then
    ``where(mask, lookup, (-1, 0))``. Same arguments as
    :func:`time_flow_lookup`; runs on any device."""
    _check_hash_index(hashv, hash_period, hash_base)
    V, Tr, N, D, _ = table_dims(tbl_next, tbl_dep)
    rows_n, rows_d = _rows(tbl_next, tbl_dep)
    if isinstance(sel, torch.Tensor):
        s = sel.to(torch.int64).clamp(0, 1)
    else:
        s = min(max(int(sel), 0), 1)
    n = node.to(torch.int64).clamp(0, N - 1)
    d = dst.to(torch.int64).clamp(0, D - 1)
    if not isinstance(hashv, torch.Tensor):
        pid = torch.arange(node.shape[0], dtype=torch.int64,
                           device=node.device)
        if hash_period is not None and hash_period < node.shape[0]:
            pid = pid % hash_period     # the index within its scenario
        if hash_base:
            pid = pid + int(hash_base)  # the global index of a shard's packet
        hashv = salted_hash(pid, int(hashv))
    if phase_off is not None:
        # the node's local slice; torch.remainder is a floor modulo
        tm = torch.remainder(tm + phase_off.to(torch.int64)[n], Tr)
    if vsel is not None:
        s = s * V + vsel.to(torch.int64)[n].clamp(0, V - 1)
    elif V > 1:
        s = s * V                       # every node reads version 0
    row = ((s * Tr + tm) * N + n) * D + d
    nxt, off = select_slot(rows_n[row], rows_d[row], hashv)
    if mask is not None:
        nxt = torch.where(mask, nxt, -1)
        off = torch.where(mask, off, 0)
    return nxt, off


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def vector_width(K: int, stride: int, ptrs) -> int:
    """int32 per row load in the kernel: 4 (16-byte loads) or 2 where K,
    the row stride and every row pointer allow it, else 1. Rows wider
    than the kernel's 8 registers take its wide route, which loads
    scalars."""
    if K > 8:
        return 1
    for v in (4, 2):
        if K % v == 0 and stride % v == 0 and all(p % (4 * v) == 0
                                                   for p in ptrs):
            return v
    return 1


def _require_cuda(tensors):
    dev = tensors[0].device
    for x in tensors:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError("time_flow_lookup: the kernel takes CUDA "
                             f"tensors on one device, got {x.device}")


def _check_hash_index(hashv, hash_period, hash_base) -> None:
    """A hash period and a hash base go with the in-kernel hash (an int
    ``hashv``); the period is positive, the base at least 0. The kernel
    and its plain version refuse them otherwise."""
    if hash_period is not None and (isinstance(hashv, torch.Tensor)
                                    or int(hash_period) < 1):
        raise ValueError("time_flow_lookup: hash_period must be a positive "
                         "int and goes with the in-kernel hash (an int "
                         f"hashv), got {hash_period!r}")
    if hash_base is not None and (isinstance(hashv, torch.Tensor)
                                  or int(hash_base) < 0):
        raise ValueError("time_flow_lookup: hash_base must be an int >= 0 "
                         "and goes with the in-kernel hash (an int hashv), "
                         f"got {hash_base!r}")


def _check(tbl_next, tbl_dep, tm, sel, node, dst, hashv, mask=None,
           phase_off=None, vsel=None, hash_period=None, hash_base=None):
    if tbl_dep is None:
        if tbl_next.dim() not in (6, 7) or tbl_next.shape[0] != 2 \
                or tbl_next.shape[-2] != 2:
            raise ValueError("time_flow_lookup: a packed table must be "
                             "[2, Tr, N, D, 2, K] or [2, V, Tr, N, D, 2, K],"
                             f" got {tuple(tbl_next.shape)}")
        tables = [tbl_next]
    else:
        if tbl_next.dim() not in (5, 6) or tbl_next.shape[0] != 2 \
                or tbl_dep.shape != tbl_next.shape:
            raise ValueError("time_flow_lookup: tables must be two equal "
                             "[2, Tr, N, D, K] or [2, V, Tr, N, D, K] "
                             f"stacks, got {tuple(tbl_next.shape)} / "
                             f"{tuple(tbl_dep.shape)}")
        tables = [tbl_next, tbl_dep]
    V, Tr, N, D, K = table_dims(tbl_next, tbl_dep)
    if min(V, Tr, N, D, K) < 1:
        raise ValueError(f"time_flow_lookup: empty tables {tuple(tbl_next.shape)}")
    if not 0 <= tm < Tr:
        raise ValueError(f"time_flow_lookup: slice {tm} outside [0, {Tr})")
    P = node.shape[0]
    vecs = [x for x in (node, dst, sel, hashv) if isinstance(x, torch.Tensor)]
    for x in tables + vecs:
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("time_flow_lookup: every tensor must be "
                             "contiguous int32")
    if mask is not None:
        if mask.dtype != torch.bool or not mask.is_contiguous():
            raise ValueError("time_flow_lookup: the mask must be a "
                             "contiguous bool vector")
        vecs.append(mask)
    for x in vecs:
        if x.shape != (P,):
            raise ValueError("time_flow_lookup: node, dst, hash, sel and "
                             "mask must be [P] vectors, got "
                             f"{tuple(x.shape)} for P={P}")
    _check_hash_index(hashv, hash_period, hash_base)
    for name, x in (("phase_off", phase_off), ("vsel", vsel)):
        if x is not None and (x.dtype != torch.int32 or not x.is_contiguous()
                              or x.shape != (N,)):
            raise ValueError(f"time_flow_lookup: {name} must be a contiguous "
                             f"int32 [N] vector for N={N}, got "
                             f"{x.dtype} {tuple(x.shape)}")


def time_flow_lookup(tbl_next, tbl_dep, tm: int, sel, node, dst, hashv,
                     mask=None, phase_off=None, vsel=None, hash_period=None,
                     hash_base=None):
    """Per-packet time-flow table lookup.

    tbl_next / tbl_dep: the packed ``[2, Tr, N, D, 2, K]`` int32 table and
    ``None``, or two ``[2, Tr, N, D, K]`` int32 stacks (selector 0 is the
    injection table, 1 the transit table; invalid slots -1 / 0), either
    with a version axis after the selector (``[2, V, ...]``);
    tm: the slice, ``0 <= tm < Tr``; sel: ``[P]`` int32 selectors or one
    int for every packet; node / dst: ``[P]`` int32; hashv: ``[P]`` int32
    carrying the 32-bit hash pattern, or an int ``t`` for the per-packet
    multipath hash of slice ``t``; mask: ``None`` or a ``[P]`` bool, the
    packets to look up; phase_off: ``None`` or an ``[N]`` int32 slice
    offset per node, so that a packet at node ``n`` reads slice
    ``(tm + phase_off[n]) mod Tr``; vsel: ``None`` or an ``[N]`` int32
    table version per node, so that a packet at node ``n`` reads version
    ``vsel[n]`` (``None``: version 0); hash_period: ``None`` or a positive
    int, with an int ``hashv`` only: packet ``i`` hashes ``i mod
    hash_period`` in place of ``i``; hash_base: ``None`` or an int >= 0,
    with an int ``hashv`` only: added to the hashed index (a shard's
    packets hash their global index). Returns ``(next_hop, dep_offset)``,
    two ``[P]`` int32 tensors, (-1, 0) outside the mask.
    """
    global launches
    if node.device.type == "cpu":
        return time_flow_lookup_plain(tbl_next, tbl_dep, tm, sel, node, dst,
                                      hashv, mask, phase_off, vsel,
                                      hash_period, hash_base)
    _require_cuda([x for x in (tbl_next, tbl_dep, sel, node, dst, hashv,
                               mask, phase_off, vsel)
                   if isinstance(x, torch.Tensor)])
    _check(tbl_next, tbl_dep, tm, sel, node, dst, hashv, mask, phase_off,
           vsel, hash_period, hash_base)
    V, Tr, N, D, K = table_dims(tbl_next, tbl_dep)
    P = node.shape[0]
    out_next = torch.empty(P, dtype=torch.int32, device=node.device)
    out_dep = torch.empty(P, dtype=torch.int32, device=node.device)
    if P == 0:
        return out_next, out_dep
    lib = _build.load("time_flow_lookup", _SIGNATURES)
    if tbl_dep is None:
        rows_next, stride = tbl_next.data_ptr(), 2 * K
        rows_dep = rows_next + 4 * K
    else:
        rows_next, rows_dep, stride = tbl_next.data_ptr(), tbl_dep.data_ptr(), K
    ptr = lambda x: x.data_ptr() if isinstance(x, torch.Tensor) else None
    _build.launch(
        lib.tfl_launch, "time_flow_lookup",
        rows_next, rows_dep, stride, V, Tr, N, D, K, tm, ptr(phase_off),
        ptr(vsel), ptr(sel), 0 if isinstance(sel, torch.Tensor) else int(sel),
        node.data_ptr(), dst.data_ptr(), ptr(hashv),
        0 if isinstance(hashv, torch.Tensor) else int(hashv) & MASK32,
        P if hash_period is None else int(hash_period),
        0 if hash_base is None else int(hash_base), ptr(mask),
        out_next.data_ptr(), out_dep.data_ptr(), P,
        vector_width(K, stride, (rows_next, rows_dep)),
        torch.cuda.current_stream(node.device).cuda_stream)
    launches += 1
    return out_next, out_dep
