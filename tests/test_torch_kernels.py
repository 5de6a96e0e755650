"""The port's kernels on the CPU: the plain versions of ``time_flow_lookup``
(the TPU's form, and the packed table, the mask, the in-kernel hash and the
version axis of the port's) and ``admission_admit`` against the Pallas kernels (interpret
mode) and the ``repro.kernels.ref`` oracles, the lookup kernel's choice of
row loads, a plain-torch emulation of the CUDA
admission kernel's three passes (tiles, the scan across them, the walk of
each tile in 32-packet steps) against the plain version, and the
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
from torch_parity import release_compiled_programs  # noqa: E402, F401


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


def _pad_slots(a, K, fill):
    pad = np.full(a.shape[:-1] + (K - a.shape[-1],), fill, np.int32)
    return np.concatenate([a, pad], -1)


@pytest.mark.parametrize("k_inj,k_tf", [(1, 1), (3, 3), (4, 4), (8, 8),
                                        (2, 4), (3, 1)])
def test_packed_table_round_trip(k_inj, k_tf):
    """``stack_tables`` packs both tables into ``[2, Tr, N, D, 2, K]``:
    unpacking gives the two stacks, K padded to the larger with (-1, 0)
    slots; the packed table and the two stacks look up the same pairs, and
    both equal the Pallas kernel (interpret mode) on the unpadded table of
    each selector."""
    rng = np.random.default_rng(10 * k_inj + k_tf)
    Tr, n, P, tm = 3, 7, 500, 1
    in_n, in_d = _random_tables(rng, (Tr,), n, k_inj)
    tf_n, tf_d = _random_tables(rng, (Tr,), n, k_tf)
    table = Q_fabric.stack_tables(*map(_t32, (in_n, in_d, tf_n, tf_d)))
    K = max(k_inj, k_tf)
    assert table.shape == (2, Tr, n, n, 2, K) and table.is_contiguous()
    stk_n = np.stack([_pad_slots(in_n, K, -1), _pad_slots(tf_n, K, -1)])
    stk_d = np.stack([_pad_slots(in_d, K, 0), _pad_slots(tf_d, K, 0)])
    _assert_equal(table[..., 0, :], stk_n)
    _assert_equal(table[..., 1, :], stk_d)
    node = rng.integers(0, n, P).astype(np.int32)
    dst = rng.integers(0, n, P).astype(np.int32)
    sel = rng.integers(0, 2, P).astype(np.int32)
    h = rng.integers(0, 2 ** 32, P, dtype=np.uint64).astype(np.uint32)
    args = (tm, _t32(sel), _t32(node), _t32(dst), _bits(h))
    packed = Q_tfl.time_flow_lookup(table, None, *args)
    stacks = Q_tfl.time_flow_lookup(_t32(stk_n), _t32(stk_d), *args)
    refs = [R_ops.time_flow_lookup(*[jnp.asarray(x) for x in
                                     (tn[tm], td[tm], node, dst, h)], bp=256)
            for tn, td in ((in_n, in_d), (tf_n, tf_d))]
    for i in (0, 1):
        want = np.where(sel == 0, refs[0][i], refs[1][i])
        _assert_equal(packed[i], want)
        _assert_equal(stacks[i], want)


@pytest.mark.parametrize("kind", ["all", "none", "random"])
@pytest.mark.parametrize("P", [0, 1, 7, 4097])
def test_lookup_mask(kind, P):
    """Inside the mask the masked lookup equals the unmasked one; outside
    it every packet gets (-1, 0), for the packed table and the two stacks,
    with a hash vector and with the in-kernel hash."""
    rng = np.random.default_rng(P)
    Tr, n, k, tm = 2, 9, 4, 1
    tn, td = _random_tables(rng, (2, Tr), n, k)
    table = torch.stack([_t32(tn), _t32(td)], dim=4).contiguous()
    node = _t32(rng.integers(0, n, P))
    dst = _t32(rng.integers(0, n, P))
    sel = _t32(rng.integers(0, 2, P))
    mask = {"all": np.ones(P, bool), "none": np.zeros(P, bool),
            "random": rng.random(P) < 0.5}[kind]
    tmask = torch.tensor(mask)
    for tables in ((table, None), (_t32(tn), _t32(td))):
        for h in (_bits(rng.integers(0, 2 ** 32, P, dtype=np.uint64)
                        .astype(np.uint32)), 213):
            full = Q_tfl.time_flow_lookup(*tables, tm, sel, node, dst, h)
            got = Q_tfl.time_flow_lookup(*tables, tm, sel, node, dst, h,
                                         mask=tmask)
            assert got[0].dtype == got[1].dtype == torch.int32
            _assert_equal(got[0], np.where(mask, full[0].numpy(), -1))
            _assert_equal(got[1], np.where(mask, full[1].numpy(), 0))


@pytest.mark.parametrize("t", [0, 1, 107, 213, 1 << 16, 2 ** 31 - 1])
def test_lookup_in_kernel_hash(t):
    """``hashv=t`` hashes each packet's index salted with slice t: the
    reference's ``_hash32(pid + t * 0x9E3779B9)``, and the lookup equals
    the Pallas kernel (interpret mode) fed that hash."""
    rng = np.random.default_rng(t % 1000)
    n, k, P = 11, 4, 1000
    tn, td = _random_tables(rng, (), n, k)
    node = rng.integers(0, n, P).astype(np.int32)
    dst = rng.integers(0, n, P).astype(np.int32)
    h = np.asarray(ref_hash32(jnp.arange(P, dtype=jnp.uint32)
                              + jnp.uint32(t) * jnp.uint32(0x9E3779B9)))
    pid = torch.arange(P, dtype=torch.int64)
    _assert_equal(Q_tfl.salted_hash(pid, t), h.view(np.int32))
    pn, pd = R_ops.time_flow_lookup(*[jnp.asarray(x) for x in
                                      (tn, td, node, dst, h)], bp=256)

    def stack(a):
        return torch.stack([_t32(a), _t32(a)])[:, None].contiguous()
    qn, qd = Q_tfl.time_flow_lookup(stack(tn), stack(td), 0, 0, _t32(node),
                                    _t32(dst), t)
    _assert_equal(qn, pn)
    _assert_equal(qd, pd)


@pytest.mark.parametrize("B,Ps,t", [(1, 1000, 213), (2, 501, 5),
                                    (8, 129, 1 << 16), (3, 1, 7)])
def test_lookup_per_scenario_hash_index(B, Ps, t):
    """``hash_period=Ps`` with the in-kernel hash: packet ``b·Ps + p`` of
    a scenario sweep hashes ``p``, its index within its scenario. Over the
    B·N rows of stacked per-scenario tables (offsets drawn per row, a
    mask), the lookup equals the Pallas kernel (interpret mode) fed the
    reference's hash of each scenario's own indices, scenario by scenario,
    and equals B solo calls, one a scenario."""
    rng = np.random.default_rng(B * 1000 + Ps)
    n, k, Tr, tm = 9, 4, 3, 1
    tn, td = _random_tables(rng, (2, Tr, B), n, k)     # [2, Tr, B, N, N, K]
    table = torch.stack([_t32(tn), _t32(td)], dim=-2)  # [.., B, N, N, 2, K]
    table = table.reshape(2, Tr, B * n, n, 2, k).contiguous()
    P = B * Ps
    scen = np.repeat(np.arange(B), Ps)
    node = rng.integers(0, n, P).astype(np.int32)
    dst = rng.integers(0, n, P).astype(np.int32)
    sel = rng.integers(0, 2, P).astype(np.int32)
    po = rng.integers(-2 * Tr, 2 * Tr + 1, B * n).astype(np.int32)
    mask = rng.random(P) < 0.7
    got = Q_tfl.time_flow_lookup(table, None, tm, _t32(sel),
                                 _t32(node + scen * n), _t32(dst), t,
                                 mask=torch.tensor(mask),
                                 phase_off=_t32(po), hash_period=Ps)
    h = np.asarray(ref_hash32(jnp.arange(Ps, dtype=jnp.uint32)
                              + jnp.uint32(t) * jnp.uint32(0x9E3779B9)))
    for b in range(B):
        rows = slice(b * Ps, (b + 1) * Ps)
        local = (tm + po[b * n:(b + 1) * n]) % Tr          # floor modulo
        s, nd = sel[rows], node[rows]
        want_n = np.empty(Ps, np.int32)
        want_d = np.empty(Ps, np.int32)
        for sv in (0, 1):
            for tl in range(Tr):
                pick = (s == sv) & (local[nd] == tl)
                if pick.any():
                    pn, pd = R_ops.time_flow_lookup(*[jnp.asarray(x) for x in (
                        tn[sv, tl, b], td[sv, tl, b], nd[pick], dst[rows][pick],
                        h[pick])], bp=256)
                    want_n[pick], want_d[pick] = pn, pd
        m = mask[rows]
        _assert_equal(got[0][rows], np.where(m, want_n, -1))
        _assert_equal(got[1][rows], np.where(m, want_d, 0))
        solo = Q_tfl.time_flow_lookup(
            table[:, :, b * n:(b + 1) * n].contiguous(), None, tm,
            _t32(s), _t32(nd), _t32(dst[rows]), t, mask=torch.tensor(m),
            phase_off=_t32(po[b * n:(b + 1) * n]))
        _assert_equal(got[0][rows], solo[0])
        _assert_equal(got[1][rows], solo[1])


def test_lookup_validates_hash_period():
    """A hash period goes with the in-kernel hash and is positive: the
    kernel's checks and the plain version (the CPU path) refuse the same
    arguments."""
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    args = (z(2, 3, 4, 4, 2, 2), None, 1, z(5), z(5), z(5))
    for h, hp in ((z(5), 5), (7, 0)):
        for fn in (Q_tfl._check, Q_tfl.time_flow_lookup_plain,
                   Q_tfl.time_flow_lookup):
            with pytest.raises(ValueError, match="hash_period"):
                fn(*args, h, hash_period=hp)
    Q_tfl._check(*args, 7, hash_period=2)
    Q_tfl.time_flow_lookup(*args, 7, hash_period=2)


@pytest.mark.parametrize("base,hp,V", [
    (1000, None, None), (3 * 65_537, None, None), (0, None, None),
    (2 ** 31 - 600, None, 3), (4097, 129, None), (250, 333, 2)])
def test_lookup_global_hash_index(base, hp, V):
    """``hash_base`` with the in-kernel hash: packet ``i`` of a shard's
    block hashes ``base + i`` (``base + i mod hp`` with a period), its
    global index, alone, with ``hash_period`` and with a version axis and
    ``vsel``. The lookup equals the Pallas kernel (interpret mode) fed the
    reference's hash of those indices, on a table whose rows are the
    entries each packet reads."""
    rng = np.random.default_rng(base % 997 + (hp or 0) + (V or 0))
    n, k, Tr, P, t, tm = 9, 4, 3, 1000, 213, 2
    VV = V or 1
    tn, td = _random_tables(rng, (2, VV, Tr), n, k)
    node = rng.integers(0, n, P).astype(np.int32)
    dst = rng.integers(0, n, P).astype(np.int32)
    sel = rng.integers(0, 2, P).astype(np.int32)
    vsel = rng.integers(0, VV, n).astype(np.int32)
    mask = rng.random(P) < 0.8
    tables = torch.stack([_t32(tn), _t32(td)], dim=-2)   # [2, V, Tr, ..]
    if V is None:
        tables = tables[:, 0]
    got = Q_tfl.time_flow_lookup(
        tables.contiguous(), None, tm, _t32(sel), _t32(node), _t32(dst), t,
        mask=torch.tensor(mask), vsel=None if V is None else _t32(vsel),
        hash_period=hp, hash_base=base)
    idx = np.arange(P) % (hp or P) + base
    h = np.asarray(ref_hash32(jnp.asarray(idx.astype(np.uint32))
                              + jnp.uint32(t) * jnp.uint32(0x9E3779B9)))
    v = vsel[node] if V is not None else np.zeros(P, np.int64)
    row = ((sel * VV + v) * Tr + tm) * n + node
    pn, pd = R_ops.time_flow_lookup(
        *[jnp.asarray(x) for x in (tn.reshape(-1, n, k),
                                   td.reshape(-1, n, k),
                                   row.astype(np.int32), dst, h)], bp=256)
    _assert_equal(got[0], np.where(mask, np.asarray(pn), -1))
    _assert_equal(got[1], np.where(mask, np.asarray(pd), 0))
    # a base of 0 is no base
    if base == 0:
        plain = Q_tfl.time_flow_lookup(
            tables.contiguous(), None, tm, _t32(sel), _t32(node), _t32(dst),
            t, mask=torch.tensor(mask))
        _assert_equal(got[0], plain[0].numpy())
        _assert_equal(got[1], plain[1].numpy())


def test_lookup_validates_hash_base():
    """A hash base goes with the in-kernel hash and is at least 0: the
    kernel's checks and the plain version (the CPU path) refuse the same
    arguments."""
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    args = (z(2, 3, 4, 4, 2, 2), None, 1, z(5), z(5), z(5))
    for h, hb in ((z(5), 5), (7, -1), (z(5), 0)):
        for fn in (Q_tfl._check, Q_tfl.time_flow_lookup_plain,
                   Q_tfl.time_flow_lookup):
            with pytest.raises(ValueError, match="hash_base"):
                fn(*args, h, hash_base=hb)
    Q_tfl._check(*args, 7, hash_base=3, hash_period=2)
    Q_tfl.time_flow_lookup(*args, 7, hash_base=3, hash_period=2)


@pytest.mark.parametrize("K,packed,want", [
    (1, True, 1), (2, True, 2), (3, True, 1), (4, True, 4), (6, True, 2),
    (8, True, 4), (12, True, 1), (1, False, 1), (2, False, 2),
    (4, False, 4), (8, False, 4)])
def test_lookup_vector_width(K, packed, want):
    """The kernel's row loads: 16 bytes where K, the stride and the
    pointers allow it, 8 where only that fits, else scalars; rows wider
    than 8 slots take the wide route's scalar loads."""
    base = 1 << 20
    stride = 2 * K if packed else K
    ptrs = (base, base + 4 * K) if packed else (base, base + (1 << 16))
    assert Q_tfl.vector_width(K, stride, ptrs) == want
    # a row pointer that is only 4- or 8-byte aligned narrows the loads
    assert Q_tfl.vector_width(K, stride, (base + 4, base)) == 1
    assert Q_tfl.vector_width(K, stride, (base + 8, base)) == min(want, 2)


def test_lookup_validates_packed_table_and_mask():
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    table, v = z(2, 3, 4, 4, 2, 2), z(5)
    mask = torch.ones(5, dtype=torch.bool)
    Q_tfl._check(table, None, 1, v, v, v, v, mask)
    Q_tfl._check(table, None, 1, 1, v, v, 7, None)
    bad = [
        (z(2, 3, 4, 4, 3, 2), None, 1, v, v, v, v, mask),   # not 2 rows
        (z(2, 3, 4, 4, 2), None, 1, v, v, v, v, mask),      # stack, no dep
        (table, None, 3, v, v, v, v, mask),                 # slice >= Tr
        (table, None, 1, v, v, v, v, mask.int()),           # mask dtype
        (table, None, 1, v, v, v, v, mask[:4]),             # mask length
        (table, None, 1, v, v, v, v[:4], mask),             # hash length
    ]
    for args in bad:
        with pytest.raises(ValueError):
            Q_tfl._check(*args)


# ---------------------------------------------------------------------------
# time_flow_lookup: the version axis (the reconfigure loop's installs)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offsets", [False, True], ids=["slice", "offsets"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "stacks"])
@pytest.mark.parametrize("V", [1, 2, 3])
def test_lookup_versioned_matches_gather(V, packed, offsets):
    """With a version axis and a per-node ``vsel`` (some entries outside
    [0, V), which clamp), the lookup equals a direct gather of entry
    ``[sel, vsel[n], tm', n, d]`` (``tm'`` the node's local slice) and the
    reference's oracle on that version's slice, packet by packet."""
    rng = np.random.default_rng(10 * V + 2 * packed + offsets)
    Tr, n, k, P = 3, 9, 4, 900
    tn, td = _random_tables(rng, (2, V, Tr), n, k)
    node = rng.integers(0, n, P).astype(np.int32)
    dst = rng.integers(0, n, P).astype(np.int32)
    sel = rng.integers(0, 2, P).astype(np.int32)
    h = rng.integers(0, 2 ** 32, P, dtype=np.uint64).astype(np.uint32)
    vsel = rng.integers(-1, V + 1, n).astype(np.int32)
    po = rng.integers(-2 * Tr, 2 * Tr + 1, n).astype(np.int32) if offsets \
        else np.zeros(n, np.int32)
    tm = int(rng.integers(0, Tr))
    tables = ((torch.stack([_t32(tn), _t32(td)], dim=-2).contiguous(), None)
              if packed else (_t32(tn), _t32(td)))
    qn, qd = Q_tfl.time_flow_lookup(
        *tables, tm, _t32(sel), _t32(node), _t32(dst), _bits(h),
        phase_off=_t32(po) if offsets else None, vsel=_t32(vsel))
    v = np.clip(vsel[node], 0, V - 1)
    tl = (tm + po[node]) % Tr
    rows_n, rows_d = tn[sel, v, tl, node, dst], td[sel, v, tl, node, dst]
    nvalid = np.maximum((rows_n >= 0).sum(-1), 1)
    slot = h.astype(np.int64) % nvalid
    _assert_equal(qn, rows_n[np.arange(P), slot])
    _assert_equal(qd, rows_d[np.arange(P), slot])
    # the oracle on one [2 V Tr n, D, K] table whose rows are the entries
    # (sel, version, slice, node)
    row = ((sel * V + v) * Tr + tl) * n + node
    rn, rd = R_ops.time_flow_lookup(
        *[jnp.asarray(x) for x in (tn.reshape(-1, n, k), td.reshape(-1, n, k),
                                   row.astype(np.int32), dst, h)], impl="ref")
    _assert_equal(qn, rn)
    _assert_equal(qd, rd)


def test_lookup_one_version_is_the_unversioned_table():
    """A table of one version, without ``vsel``, is the unversioned call,
    bit for bit; a table of several versions without ``vsel`` reads
    version 0; ``vsel`` on a table of one version reads it."""
    rng = np.random.default_rng(5)
    Tr, n, k, P = 2, 7, 3, 600
    tn, td = _random_tables(rng, (2, 3, Tr), n, k)
    args = (1, _t32(rng.integers(0, 2, P)), _t32(rng.integers(0, n, P)),
            _t32(rng.integers(0, n, P)), 9)
    one = Q_tfl.time_flow_lookup(_t32(tn[:, :1]), _t32(td[:, :1]), *args)
    flat = Q_tfl.time_flow_lookup(_t32(tn[:, 0]), _t32(td[:, 0]), *args)
    many = Q_tfl.time_flow_lookup(_t32(tn), _t32(td), *args)
    sel_one = Q_tfl.time_flow_lookup(_t32(tn[:, :1]), _t32(td[:, :1]), *args,
                                     vsel=_t32(rng.integers(0, 3, n)))
    for got in (one, many, sel_one):
        _assert_equal(got[0], flat[0].numpy())
        _assert_equal(got[1], flat[1].numpy())


def test_stack_tables_versioned():
    """``stack_tables`` on ``[V, Tr, N, D, K]`` tables gives ``[2, V, Tr,
    N, D, 2, K]``, each version the unversioned packing of its tables."""
    rng = np.random.default_rng(6)
    V, Tr, n = 3, 2, 5
    parts = [*_random_tables(rng, (V, Tr), n, 4),
             *_random_tables(rng, (V, Tr), n, 1)]
    table = Q_fabric.stack_tables(*map(_t32, parts))
    assert table.shape == (2, V, Tr, n, n, 2, 4) and table.is_contiguous()
    for v in range(V):
        _assert_equal(table[:, v], Q_fabric.stack_tables(
            *(_t32(p[v]) for p in parts)).numpy())


def test_lookup_validates_versions():
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    vec = z(5)
    for table, dep in ((z(2, 3, 2, 4, 4, 2, 2), None),
                       (z(2, 3, 2, 4, 4, 2), z(2, 3, 2, 4, 4, 2))):
        Q_tfl._check(table, dep, 1, vec, vec, vec, vec, vsel=z(4))
        assert Q_tfl.table_dims(table, dep) == (3, 2, 4, 4, 2)
        for bad in (z(5), z(4).long(), z(8)[::2], z(1, 4)):
            with pytest.raises(ValueError, match="vsel"):
                Q_tfl._check(table, dep, 1, vec, vec, vec, vec, vsel=bad)
    with pytest.raises(ValueError):
        Q_tfl._check(z(2, 3, 2, 2, 4, 4, 2, 2), None, 1, vec, vec, vec, vec)


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
    got = Q_tfl.hash32(torch.tensor(xs.astype(np.int64)))
    assert got.dtype == torch.int64
    _assert_equal(got, want.astype(np.int64))
    bits = Q_tfl.as_bits(got)
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
    got = Q_tfl.salted_hash(torch.tensor(base), t)
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


def _step_inclusive(v, k):
    """The inclusive sum of ``v`` over each lane's key group of a 32-lane
    step, in lane order, by the kernel's pointer jumping: each lane starts
    at its nearest lower lane of the same key and doubles the span five
    times, reading the other lanes' values of the previous round."""
    lanes = torch.arange(32)
    same_lower = (k[None, :] == k[:, None]) & (lanes[None, :] < lanes[:, None])
    prev = torch.where(same_lower, lanes[None, :], -1).amax(-1)
    for _ in range(5):
        src = torch.where(prev >= 0, prev, lanes)
        v = torch.where(prev >= 0, v + v[src], v)
        prev = torch.where(prev >= 0, prev[src], prev)
    return v


def _scan_groups(tiles):
    """The scan kernel's tile groups: a power of two up to 64, doubled
    while each group would keep eight tiles or more."""
    g = 1
    while g < 64 and tiles >= 8 * g:
        g *= 2
    return g


def _tiled_admission(key, size, want, cap, num_keys, tile):
    """csrc/admission.cu's three passes in plain torch ops: (1) per-tile
    per-key wanted bytes, (2) an exclusive scan of those across tiles done
    as the kernel does it (tiles split into up to 64 chunks, chunk sums
    scanned, each chunk rewritten with running offsets), (3) per tile, the
    steps of 32 packets: each packet's in-step prefix and each key's step
    total by pointer jumping, the walk that adds the tile's running per-key
    total and then the step totals, the decision, and the admitted bytes
    per key gathered per tile and added to ``used``. All int32."""
    P = key.shape[0]
    ok = want & (key >= 0) & (key < num_keys)
    k = torch.where(ok, key, -1).to(torch.int64)
    s = torch.where(ok, size, 0)
    tiles = -(-P // tile)
    tile_of = torch.arange(P) // tile
    tot = torch.zeros(tiles, num_keys, dtype=torch.int32)
    tot.index_put_((tile_of[ok], k[ok]), s[ok], accumulate=True)
    groups = _scan_groups(tiles)
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
    adm = torch.zeros(P, dtype=torch.bool)
    used = torch.zeros(num_keys, dtype=torch.int32)
    lanes = torch.arange(32)
    for t in range(tiles):
        running = off[t].clone()
        got = torch.zeros(num_keys, dtype=torch.int32)
        for i0 in range(t * tile, min(P, (t + 1) * tile), 32):
            idx = i0 + lanes
            live = idx < P
            kk = torch.where(live, k[idx.clamp(max=P - 1)], -1)
            ss = torch.where(live & (kk >= 0), s[idx.clamp(max=P - 1)], 0)
            incl = _step_inclusive(ss, kk)
            last = ~((kk[None, :] == kk[:, None]) &
                     (lanes[None, :] > lanes[:, None])).any(-1)
            parked = kk < 0
            kc = kk.clamp(min=0)
            prefix = torch.where(parked, 0, running[kc]) + incl - ss
            upd = last & ~parked
            running[kc[upd]] = running[kc[upd]] + incl[upd]
            a = ~parked & (prefix.to(torch.int64) + ss
                           <= cap[kc].to(torch.int64))
            adm[idx[live]] = a[live]
            gsum = _step_inclusive(torch.where(a, ss, 0), kk)
            got.index_add_(0, kc[upd], gsum[upd])
        used += got
    return adm, used


@pytest.mark.parametrize("P", [1, 7, 2047, 2049, 4097])
@pytest.mark.parametrize("tile", [32, 64, 256, 2048, "plan"])
@pytest.mark.parametrize("nk", [5, 300, 11772])
def test_admission_tiling_emulation_matches_plain(P, tile, nk):
    """Small key counts put every key in many steps and tiles; 32-packet
    tiles give 129 tiles of 4,097 packets, more than 8 a scan group; 2,049
    and 4,097 packets leave a ragged last tile and step; ``plan`` is the
    wrapper's own tile size."""
    args = _torch_args(*_admission_inputs(P, nk, P + nk))
    tile = Q_adm.admission_tile(P, nk) if tile == "plan" else tile
    a_e, u_e = _tiled_admission(*args, nk, tile)
    a_p, u_p = Q_adm.admission_admit_plain(*args, num_keys=nk)
    assert torch.equal(a_e, a_p) and torch.equal(u_e, u_p)


def test_admission_tiling_emulation_above_shared_memory_keys():
    """More keys than the shared-memory route holds: the kernel keeps the
    running totals in device memory, the arithmetic is the same."""
    nk = Q_adm.SMEM_KEYS + 1
    args = _torch_args(*_admission_inputs(3000, nk, 8))
    tile = Q_adm.admission_tile(3000, nk)
    a_e, u_e = _tiled_admission(*args, nk, tile)
    a_p, u_p = Q_adm.admission_admit_plain(*args, num_keys=nk)
    assert torch.equal(a_e, a_p) and torch.equal(u_e, u_p)


@pytest.mark.parametrize("P,nk,want", [
    (131072, 11772, 2048), (131072, 108, 1024), (131073, 108, 2048),
    (1, 11772, 256), (257, 300, 512), (2047, 11772, 2048), (4097, 300, 256),
    (100_000, 49153, 2048)])
def test_admission_tile(P, nk, want):
    """The wrapper's tile size: one tile up to 2,048 packets, else at most
    128 tiles and 2^20 scratch entries where 2,048 packets a tile allow
    it."""
    tile = Q_adm.admission_tile(P, nk)
    assert tile == want and tile % 32 == 0 and tile <= 2048
    if P <= 2048:
        assert tile >= P
    elif tile < 2048:
        assert -(-P // tile) <= 128 and -(-P // tile) * nk <= 1 << 20


def test_admission_tiling_emulation_one_hot_key():
    P = 3000
    rng = np.random.default_rng(4)
    args = (_t32(np.full(P, 2)), _t32(rng.integers(64, 1501, P)),
            torch.tensor(rng.random(P) < 0.9), _t32([0, 0, 400_000, 0]))
    for tile in (256, 2048):
        a_e, u_e = _tiled_admission(*args, 4, tile)
        a_p, u_p = Q_adm.admission_admit_plain(*args, num_keys=4)
        assert torch.equal(a_e, a_p) and torch.equal(u_e, u_p)
    assert 0 < int(a_p.sum()) < P


def test_admission_tiling_emulation_long_scan_groups():
    """More than 512 tiles: the scan's groups hold more tiles than its
    threads keep in registers, and read them twice."""
    args = _torch_args(*_admission_inputs(20_000, 7, 11))
    assert -(-20_000 // 32) > 512 and _scan_groups(-(-20_000 // 32)) == 64
    a_e, u_e = _tiled_admission(*args, 7, 32)
    a_p, u_p = Q_adm.admission_admit_plain(*args, num_keys=7)
    assert torch.equal(a_e, a_p) and torch.equal(u_e, u_p)
