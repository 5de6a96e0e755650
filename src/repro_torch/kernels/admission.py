"""FIFO queue admission: the CUDA kernel ``csrc/admission.cu`` and its
plain PyTorch version.

Port of the Pallas TPU kernel ``repro/kernels/admission.py ::
admission_admit``, of its oracle ``repro/kernels/ref.py ::
admission_admit_ref`` and of the fabric's sort formulation
``repro.core.fabric._group_admit``. Packet ``i`` is admitted iff it is
wanted and the wanted bytes of its key at indices ``< i`` plus its own size
fit ``cap_left[key]``; rejected packets' bytes still count against their
successors. Also returns the admitted bytes per key. Not-wanted packets,
and keys outside ``[0, num_keys)``, are parked on the sentinel key
``num_keys`` with size 0 and never admitted.

The Pallas kernel walks packet tiles in order and carries a per-key byte
accumulator from tile to tile. Hopper runs blocks in no order, so the CUDA
kernel splits that carry into three passes (see the source): per-tile
per-key totals, an exclusive scan of them across tiles, then the in-tile
prefix and the decision. ``tests/test_torch_kernels.py`` emulates those
passes in plain torch ops and holds them against the plain version.

All sums are of int32 bytes, as in the reference: the total of wanted bytes
must stay below 2**31.

:func:`admission_admit` dispatches by the device of its inputs: the plain
version for CPU tensors, the kernel for CUDA tensors (or an error, never a
fallback). ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "adm_tile_size": ([], ctypes.c_int),
    # key, size, want, cap, num_keys, P, scratch, admitted, used, stream
    "adm_launch": ([_P, _P, _P, _P, _I, _L, _P, _P, _P, _P], ctypes.c_int),
}


def admission_admit_plain(key, size, want, cap_left, *, num_keys: int):
    """The plain PyTorch version: stable sort by key + segmented prefix sum
    over the sorted order (``fabric._group_admit``). Runs on any device."""
    P = key.shape[0]
    ok = want & (key >= 0) & (key < num_keys)
    key_eff = torch.where(ok, key, num_keys).to(torch.int64)
    if P == 0:
        return (torch.zeros(0, dtype=torch.bool, device=key.device),
                torch.zeros(num_keys, dtype=torch.int32, device=key.device))
    k_s, order = torch.sort(key_eff, stable=True)
    sz_s = torch.where(ok, size, 0)[order].to(torch.int64)
    cs_excl = sz_s.cumsum(0) - sz_s
    is_start = torch.ones(P, dtype=torch.bool, device=key.device)
    is_start[1:] = k_s[1:] != k_s[:-1]
    base = torch.cummax(torch.where(is_start, cs_excl, -1), 0).values
    prefix = cs_excl - base
    cap_s = torch.cat([cap_left, cap_left.new_zeros(1)])[k_s]
    adm_s = (prefix + sz_s <= cap_s) & (k_s < num_keys)
    admitted = torch.empty_like(adm_s).scatter_(0, order, adm_s)
    used = torch.zeros(num_keys + 1, dtype=torch.int32, device=key.device)
    used.index_add_(0, key_eff, torch.where(admitted, size, 0))
    return admitted, used[:num_keys]


def _require_cuda(key, size, want, cap_left):
    for x in (key, size, want, cap_left):
        if x.device.type != "cuda" or x.device != key.device:
            raise ValueError("admission_admit: the kernel takes CUDA tensors "
                             f"on one device, got {x.device}")


def _check(key, size, want, cap_left, num_keys):
    P = key.shape[0]
    for x, dt, n in ((key, torch.int32, P), (size, torch.int32, P),
                     (want, torch.bool, P), (cap_left, torch.int32, num_keys)):
        if x.dtype != dt or x.shape != (n,) or not x.is_contiguous():
            raise ValueError(
                "admission_admit: expects contiguous key/size [P] int32, "
                "want [P] bool and cap_left [num_keys] int32; got "
                f"{x.dtype} {tuple(x.shape)} where {dt} ({n},) was due")
    if not 0 < num_keys < 2 ** 31:
        raise ValueError(f"admission_admit: num_keys {num_keys} out of range")


def admission_admit(key, size, want, cap_left, *, num_keys: int):
    """FIFO group admission under per-key byte capacity.

    key / size: ``[P]`` int32; want: ``[P]`` bool; cap_left:
    ``[num_keys]`` int32. Returns ``(admitted [P] bool, used [num_keys]
    int32)``.
    """
    global launches
    if key.device.type == "cpu":
        return admission_admit_plain(key, size, want, cap_left,
                                     num_keys=num_keys)
    _require_cuda(key, size, want, cap_left)
    _check(key, size, want, cap_left, num_keys)
    P = key.shape[0]
    admitted = torch.empty(P, dtype=torch.bool, device=key.device)
    if P == 0:
        return admitted, torch.zeros(num_keys, dtype=torch.int32,
                                     device=key.device)
    used = torch.empty(num_keys, dtype=torch.int32, device=key.device)
    lib = _build.load("admission", _SIGNATURES)
    tiles = -(-P // lib.adm_tile_size())
    # per-tile per-key wanted bytes, scanned in place into tile offsets
    scratch = torch.empty(tiles * num_keys, dtype=torch.int32,
                          device=key.device)
    _build.launch(
        lib.adm_launch, "admission_admit",
        key.data_ptr(), size.data_ptr(), want.data_ptr(), cap_left.data_ptr(),
        num_keys, P, scratch.data_ptr(), admitted.data_ptr(), used.data_ptr(),
        torch.cuda.current_stream(key.device).cuda_stream)
    launches += 1
    return admitted, used
