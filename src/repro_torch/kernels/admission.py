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
per-key totals, an exclusive scan of them across tiles, then a walk of
each tile in steps of 32 packets that carries the tile's running per-key
totals and decides. :func:`admission_tile` picks the tile size;
``tests/test_torch_kernels.py`` emulates the passes in plain torch ops and
holds them against the plain version.

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

# the largest num_keys whose running totals the kernel keeps in shared
# memory (adm_smem_keys in csrc/admission.cu, which chip_smoke.py holds
# equal); above it they stay in the scratch in device memory
SMEM_KEYS = 47104
TILE_MIN, TILE_MAX = 256, 2048   # packets per tile
SCRATCH_ENTRIES = 1 << 20        # tiles x num_keys the tile size aims at
TILES = 128                      # tiles the tile size aims at (~1 per SM)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "adm_smem_keys": ([], ctypes.c_int),
    # key, size, want, cap, num_keys, P, tile, scratch, admitted, used,
    # stream
    "adm_launch": ([_P, _P, _P, _P, _I, _L, _I, _P, _P, _P, _P],
                   ctypes.c_int),
}


def admission_tile(P: int, num_keys: int) -> int:
    """Packets per tile of the kernel: the smallest power of two from 256
    to 2,048 that holds all ``P`` packets in one tile (which needs no carry
    across tiles: one launch) or else keeps the tiles within 128 (about one
    block per SM) and the per-tile per-key scratch (``ceil(P / tile) x
    num_keys`` int32) within 2^20 entries. Short tiles shorten the serial
    walk of pass 3; long ones shrink the scratch that passes 1 and 2
    write."""
    tile = TILE_MIN
    while tile < TILE_MAX and (P <= TILE_MAX and tile < P
                               or -(-P // tile) > TILES
                               or -(-P // tile) * num_keys > SCRATCH_ENTRIES):
        tile *= 2
    return tile


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
    tile = admission_tile(P, num_keys)
    # per-tile per-key wanted bytes, scanned in place into tile offsets
    scratch = torch.empty(-(-P // tile) * num_keys, dtype=torch.int32,
                          device=key.device)
    _build.launch(
        lib.adm_launch, "admission_admit",
        key.data_ptr(), size.data_ptr(), want.data_ptr(), cap_left.data_ptr(),
        num_keys, P, tile, scratch.data_ptr(), admitted.data_ptr(),
        used.data_ptr(), torch.cuda.current_stream(key.device).cuda_stream)
    launches += 1
    return admitted, used
