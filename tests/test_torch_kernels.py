"""The port's kernels on the CPU: the plain versions of ``time_flow_lookup``
and ``admission_admit`` against the Pallas kernels (interpret mode) and the
``repro.kernels.ref`` oracles, a plain-torch emulation of the CUDA
admission kernel's three-pass tiling against the plain version, and the
32-bit hash edge cases. All integer: equal bit for bit, dtypes included.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.fabric import _group_admit, _hash32 as ref_hash32  # noqa: E402
from repro.kernels import ops as R_ops  # noqa: E402
from repro_torch.core import fabric as Q_fabric  # noqa: E402
from repro_torch.kernels import admission as Q_adm  # noqa: E402
from repro_torch.kernels import time_flow_lookup as Q_tfl  # noqa: E402


def _t32(a):
    return torch.tensor(np.asarray(a, np.int32))


def _bits(h_uint32):
    """A uint32 numpy hash as the int32 tensor with the same bits."""
    return torch.tensor(np.asarray(h_uint32, np.uint32).view(np.int32))


def _lookup_one(tn, td, node, dst, h):
    """One slice's ``[N, D, K]`` tables through the port's wrapper, which
    takes ``[2, Tr, N, D, K]`` stacks: the table under both selectors, as
    slice 0."""
    def stack(t):
        return torch.stack([_t32(t), _t32(t)])[:, None].contiguous()
    return Q_tfl.time_flow_lookup(stack(tn), stack(td), 0, 0, _t32(node),
                                  _t32(dst), _bits(h))


def _random_tables(rng, lead, n, k, dep_hi=8):
    """Tables with valid slots contiguous from 0 (some rows empty)."""
    nv = rng.integers(0, k + 1, size=lead + (n, n))
    tn = np.where(np.arange(k) < nv[..., None],
                  rng.integers(0, n, lead + (n, n, k)), -1).astype(np.int32)
    td = np.where(tn >= 0, rng.integers(0, dep_hi, tn.shape), 0)
    return tn, td.astype(np.int32)


def _assert_equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# time_flow_lookup
# ---------------------------------------------------------------------------

# (n, k, log2 P, seed): the ranges of test_kernels.py's property test
LOOKUP_CASES = [(2, 1, 6, 0), (5, 4, 8, 1), (24, 4, 10, 2), (13, 3, 7, 3),
                (8, 2, 9, 4), (17, 1, 6, 5), (3, 4, 10, 6), (24, 2, 8, 7)]


@pytest.mark.parametrize("n,k,p_log,seed", LOOKUP_CASES)
def test_lookup_plain_matches_pallas_and_ref(n, k, p_log, seed):
    rng = np.random.default_rng(seed)
    P = 2 ** p_log
    tn, td = _random_tables(rng, (), n, k)
    node = rng.integers(0, n, P).astype(np.int32)
    dst = rng.integers(0, n, P).astype(np.int32)
    h = rng.integers(0, 2 ** 32, P, dtype=np.uint64).astype(np.uint32)
    args = [jnp.asarray(x) for x in (tn, td, node, dst, h)]
    pn, pd = R_ops.time_flow_lookup(*args, bp=min(P, 256))
    rn, rd = R_ops.time_flow_lookup(*args, impl="ref")
    qn, qd = _lookup_one(tn, td, node, dst, h)
    assert qn.dtype == qd.dtype == torch.int32
    for got, want in ((qn, pn), (qd, pd), (qn, rn), (qd, rd)):
        _assert_equal(got, want)


@pytest.mark.parametrize("P", [1, 7, 255, 1000, 1025])
def test_lookup_plain_matches_pallas_odd_counts(P):
    """The distribution of test_fabric_golden's padding test."""
    rng = np.random.default_rng(3)
    n, k = 10, 4
    tn = np.full((n, n, k), -1, np.int32)
    nv = rng.integers(0, k + 1, size=(n, n))
    for i in range(n):
        for jj in range(n):
            tn[i, jj, :nv[i, jj]] = rng.integers(0, n, nv[i, jj])
    td = (rng.integers(0, 6, size=(n, n, k)) * (tn >= 0)).astype(np.int32)
    node = rng.integers(0, n, P).astype(np.int32)
    dst = rng.integers(0, n, P).astype(np.int32)
    h = rng.integers(0, 2 ** 31, P).astype(np.uint32)
    pn, pd = R_ops.time_flow_lookup(*[jnp.asarray(x) for x in
                                      (tn, td, node, dst, h)], bp=256)
    qn, qd = _lookup_one(tn, td, node, dst, h)
    _assert_equal(qn, pn)
    _assert_equal(qd, pd)


@pytest.mark.parametrize("seed", range(4))
def test_lookup_stacked_tables_select_and_slice(seed):
    """The port's kernel form: [2, Tr, N, D, K] stacks, a slice and a
    per-packet or constant selector, equal to the reference oracle on the
    selected table of that slice."""
    rng = np.random.default_rng(seed)
    Tr, n, k, P = 3, 9, 4, 700
    tn, td = _random_tables(rng, (2, Tr), n, k)
    node = rng.integers(0, n, P).astype(np.int32)
    dst = rng.integers(0, n, P).astype(np.int32)
    h = rng.integers(0, 2 ** 32, P, dtype=np.uint64).astype(np.uint32)
    sel = rng.integers(0, 2, P).astype(np.int32)
    tm = int(rng.integers(0, Tr))
    refs = [R_ops.time_flow_lookup(jnp.asarray(tn[s, tm]),
                                   jnp.asarray(td[s, tm]), jnp.asarray(node),
                                   jnp.asarray(dst), jnp.asarray(h),
                                   impl="ref") for s in (0, 1)]
    qn, qd = Q_tfl.time_flow_lookup(_t32(tn), _t32(td), tm, _t32(sel),
                                    _t32(node), _t32(dst), _bits(h))
    _assert_equal(qn, np.where(sel == 0, refs[0][0], refs[1][0]))
    _assert_equal(qd, np.where(sel == 0, refs[0][1], refs[1][1]))
    cn, cd = Q_tfl.time_flow_lookup(_t32(tn), _t32(td), tm, 1, _t32(node),
                                    _t32(dst), _bits(h))
    _assert_equal(cn, refs[1][0])
    _assert_equal(cd, refs[1][1])


def test_lookup_hash_is_unsigned():
    """Hash patterns with the top bit set pick ``h mod nvalid`` of the
    unsigned value (3000000000 % 3 == 0, as int32 it would be -1294967296)."""
    tn = np.array([[[4, 5, 6, -1]]], np.int32)
    td = np.array([[[1, 2, 3, 0]]], np.int32)
    h = np.array([3_000_000_000, 0xFFFFFFFF, 0x80000000, 7], np.uint32)
    z = np.zeros(4, np.int32)
    qn, _ = _lookup_one(tn, td, z, z, h)
    _assert_equal(qn, 4 + h.astype(np.int64) % 3)
    rn, _ = R_ops.time_flow_lookup(*[jnp.asarray(x) for x in
                                     (tn, td, z, z, h)], impl="ref")
    _assert_equal(qn, rn)


# ---------------------------------------------------------------------------
# hashes
# ---------------------------------------------------------------------------

def test_hash32_matches_reference():
    rng = np.random.default_rng(0)
    xs = np.concatenate([
        np.array([0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                  0xFFFFFFFE, 0xFFFFFFFF], np.uint64),
        rng.integers(0, 2 ** 32, 4000, dtype=np.uint64)])
    want = np.asarray(ref_hash32(jnp.asarray(xs.astype(np.uint32))))
    got = Q_fabric._hash32(torch.tensor(xs.astype(np.int64)))
    assert got.dtype == torch.int64
    _assert_equal(got, want.astype(np.int64))
    bits = Q_fabric._as_bits(got)
    assert bits.dtype == torch.int32
    _assert_equal(bits, want.view(np.int32))


@pytest.mark.parametrize("t", [0, 1, 2, 107, 213, 1 << 16, 10 ** 6,
                               2 ** 31 - 1])
def test_salted_hash_matches_reference(t):
    """The per-packet multipath hash of slice t, with t large enough that
    t * 0x9E3779B9 wraps 32 bits, and packet ids up to 0xFFFFFFFF."""
    base = np.concatenate([np.arange(0, 5000), [0x7FFFFFFF, 0xFFFFFFFE,
                                                0xFFFFFFFF]]).astype(np.int64)
    want = ref_hash32(jnp.asarray(base.astype(np.uint32))
                      + jnp.uint32(t) * jnp.uint32(0x9E3779B9))
    got = Q_fabric._salted_hash(torch.tensor(base), t)
    assert got.dtype == torch.int32
    _assert_equal(got, np.asarray(want).view(np.int32))


# ---------------------------------------------------------------------------
# admission_admit
# ---------------------------------------------------------------------------

def _admission_inputs(P, nk, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, nk, P).astype(np.int32),
            rng.integers(0, 2000, P).astype(np.int32),
            rng.random(P) < 0.7, rng.integers(0, 6000, nk).astype(np.int32))


def _torch_args(key, size, want, cap):
    return _t32(key), _t32(size), torch.tensor(want), _t32(cap)


@pytest.mark.parametrize("P", [1, 7, 255, 1000, 4097])
@pytest.mark.parametrize("nk", [5, 129, 300])
def test_admission_plain_matches_pallas_ref_and_sort(P, nk):
    key, size, want, cap = _admission_inputs(P, nk, P * 1000 + nk)
    j = [jnp.asarray(x) for x in (key, size, want, cap)]
    a_k, u_k = R_ops.admission_admit(*j, num_keys=nk)           # Pallas
    a_r, u_r = R_ops.admission_admit(*j, num_keys=nk, impl="ref")
    a_x, u_x = _group_admit(*j, nk)
    a_q, u_q = Q_adm.admission_admit(*_torch_args(key, size, want, cap),
                                     num_keys=nk)
    assert a_q.dtype == torch.bool and u_q.dtype == torch.int32
    for got, want_ in ((a_q, a_k), (a_q, a_r), (a_q, a_x)):
        _assert_equal(got, want_)
    for got, want_ in ((u_q, u_k), (u_q, u_r), (u_q, u_x)):
        _assert_equal(got, want_)


def test_admission_fifo_semantics():
    """FIFO within a group: the first packets that fit win, a rejected
    packet's bytes still count against its successors."""
    adm, used = Q_adm.admission_admit(
        _t32([0, 1, 0, 0, 1]), _t32([60, 50, 30, 10, 60]),
        torch.ones(5, dtype=torch.bool), _t32([100, 100]), num_keys=2)
    _assert_equal(adm, [True, True, True, True, False])
    _assert_equal(used, [100, 50])
    adm, _ = Q_adm.admission_admit(
        _t32([0, 0, 0]), _t32([80, 30, 10]), torch.ones(3, dtype=torch.bool),
        _t32([100]), num_keys=1)
    _assert_equal(adm, [True, False, False])   # 80+30 > 100 and 80+30+10 > 100


def test_admission_parks_unwanted_and_out_of_range_keys():
    key = _t32([0, 7, -1, 0, 1])
    adm, used = Q_adm.admission_admit(
        key, _t32([10, 10, 10, 10, 10]),
        torch.tensor([True, True, True, False, True]), _t32([15, 100]),
        num_keys=2)
    _assert_equal(adm, [True, False, False, False, True])
    _assert_equal(used, [10, 10])


def test_admission_cap_offset_matches_reference():
    """The reference's ``cap_offset`` (a sharded fabric's lower-shard
    bytes) is admission against the shifted capacities."""
    key, size, want, cap = _admission_inputs(600, 40, 9)
    off = np.random.default_rng(1).integers(0, 3000, 40).astype(np.int32)
    a_r, u_r = R_ops.admission_admit(*[jnp.asarray(x) for x in
                                       (key, size, want, cap)],
                                     num_keys=40, cap_offset=jnp.asarray(off),
                                     impl="ref")
    a_q, u_q = Q_adm.admission_admit(*_torch_args(key, size, want, cap - off),
                                     num_keys=40)
    _assert_equal(a_q, a_r)
    _assert_equal(u_q, u_r)


def _tiled_admission(key, size, want, cap, num_keys, tile, groups=32):
    """csrc/admission.cu's three passes in plain torch ops: (1) per-tile
    per-key wanted bytes, (2) an exclusive scan of those across tiles done
    as the kernel does it (tiles split into ``groups`` chunks, chunk sums
    scanned, then each chunk rewritten with running offsets), (3) the
    in-tile same-key-earlier prefix plus the tile offset decides."""
    P = key.shape[0]
    ok = want & (key >= 0) & (key < num_keys)
    k = torch.where(ok, key, -1).to(torch.int64)
    s = torch.where(ok, size, 0)
    tiles = -(-P // tile)
    tile_of = torch.arange(P) // tile
    tot = torch.zeros(tiles, num_keys, dtype=torch.int32)
    tot.index_put_((tile_of[ok], k[ok]), s[ok], accumulate=True)
    per = -(-tiles // groups)
    chunk_sum = torch.stack([tot[g * per:(g + 1) * per].sum(0, dtype=torch.int32)
                             for g in range(groups)])
    run = torch.cumsum(chunk_sum, 0, dtype=torch.int32) - chunk_sum
    off = torch.empty_like(tot)
    for g in range(groups):
        r = run[g].clone()
        for t in range(g * per, min((g + 1) * per, tiles)):
            off[t] = r
            r += tot[t]
    pad = tiles * tile - P
    kt = torch.cat([k, k.new_full((pad,), -1)]).view(tiles, tile)
    st = torch.cat([s, s.new_zeros(pad)]).view(tiles, tile)
    lane = torch.arange(tile)
    same_earlier = (kt[:, :, None] == kt[:, None, :]) & \
        (lane[None, None, :] < lane[None, :, None])
    pre = (same_earlier * st[:, None, :]).sum(-1).view(-1)[:P]
    kc = k.clamp(min=0)
    prefix = off[tile_of, kc].to(torch.int64) + pre
    adm = ok & (prefix + s <= cap[kc])
    used = torch.zeros(num_keys, dtype=torch.int32)
    used.index_add_(0, kc, torch.where(adm, s, 0))
    return adm, used


@pytest.mark.parametrize("P", [1, 7, 255, 1000, 4097])
@pytest.mark.parametrize("tile", [1, 3, 64, 256])
@pytest.mark.parametrize("nk", [5, 300])
def test_admission_tiling_emulation_matches_plain(P, tile, nk):
    """Small key counts put every group in many tiles; 3-packet tiles give
    more tiles than scan groups, so the chunked scan is exercised."""
    args = _torch_args(*_admission_inputs(P, nk, P + tile + nk))
    a_e, u_e = _tiled_admission(*args, nk, tile)
    a_p, u_p = Q_adm.admission_admit_plain(*args, num_keys=nk)
    assert torch.equal(a_e, a_p) and torch.equal(u_e, u_p)


def test_admission_tiling_emulation_one_hot_key():
    P = 3000
    rng = np.random.default_rng(4)
    args = (_t32(np.full(P, 2)), _t32(rng.integers(64, 1501, P)),
            torch.tensor(rng.random(P) < 0.9), _t32([0, 0, 400_000, 0]))
    a_e, u_e = _tiled_admission(*args, 4, 256)
    a_p, u_p = Q_adm.admission_admit_plain(*args, num_keys=4)
    assert torch.equal(a_e, a_p) and torch.equal(u_e, u_p)
    assert 0 < int(a_p.sum()) < P
