"""The port's language-model kernels on the CPU: the plain versions of
``flash_attention``, ``decode_attention``, ``rg_lru`` and ``grouped_matmul``
against the Pallas kernels (interpret mode, through ``repro.kernels.ops``
as ``tests/test_kernels.py`` calls them) and the ``repro.kernels.ref``
oracles, over the sweeps of ``test_kernels.py`` plus ragged lengths, a
wrapped ring buffer, empty cache slots and the MoE path's M = 1.

Tolerances are those of ``test_kernels.py``: relative error (max |a - b| /
max |b|) 2e-5 in float32 and 2e-2 in bfloat16, 1e-4 for the RG-LRU scan
(the plain version walks time in order, the reference scans
associatively); the grouped matmul is held to 2e-5 / 2e-2 without the
``sqrt(K)`` factor ``test_kernels.py`` allows it. The CUDA kernels are held
against these plain versions on the card by ``chip_smoke.py``, which also
runs their tile edges (skipped key tiles, ragged tails, ``q_offset``, empty
caches, ragged M, N and K).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as R_ops  # noqa: E402
from repro_torch.kernels import decode_attention as Q_da  # noqa: E402
from repro_torch.kernels import flash_attention as Q_fa  # noqa: E402
from repro_torch.kernels import grouped_matmul as Q_gmm  # noqa: E402
from repro_torch.kernels import rg_lru as Q_rl  # noqa: E402
from torch_parity import release_compiled_programs  # noqa: E402, F401

TOL = {"f32": 2e-5, "bf16": 2e-2}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def relerr(a, b):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    return np.max(np.abs(a - b)) / (np.abs(b).max() + 1e-6)


def both(x, dt):
    """The same values as a jnp array and a torch tensor of dtype ``dt``
    (rounded once, by JAX, then carried exactly)."""
    j = jnp.asarray(x, JNP[dt])
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(TORCH[dt])


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

FLASH_SHAPES = [            # B, Hq, Hkv, L, S, hd (test_kernels.py's sweep)
    (1, 2, 1, 128, 128, 64),
    (2, 4, 2, 256, 256, 64),
    (1, 8, 8, 128, 384, 128),   # MHA, rectangular
    (2, 4, 1, 128, 128, 128),   # MQA
]
FLASH_KWARGS = [dict(causal=True), dict(causal=True, window=64),
                dict(causal=True, softcap=30.0), dict(causal=False)]


def _flash_case(dt, B, Hq, Hkv, L, S, hd, kwargs, seed, **pallas_kw):
    rng = np.random.default_rng(seed)
    qj, qt = both(rng.normal(size=(B * Hq, L, hd)), dt)
    kj, kt = both(rng.normal(size=(B * Hkv, S, hd)), dt)
    vj, vt = both(rng.normal(size=(B * Hkv, S, hd)), dt)
    heads = dict(n_q_heads=Hq, n_kv_heads=Hkv)
    pallas = R_ops.flash_attention(qj, kj, vj, **heads, **pallas_kw, **kwargs)
    ref = R_ops.flash_attention(qj, kj, vj, **heads, impl="ref", **kwargs)
    port = Q_fa.flash_attention(qt, kt, vt, **heads, **kwargs)
    assert port.dtype == TORCH[dt] and port.shape == qt.shape
    assert relerr(port, pallas) < TOL[dt], kwargs
    assert relerr(port, ref) < TOL[dt], kwargs


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,L,S,hd", FLASH_SHAPES)
@pytest.mark.parametrize("kwargs", FLASH_KWARGS, ids=["causal", "window",
                                                      "softcap", "full"])
def test_flash_plain_matches_pallas_and_ref(dt, B, Hq, Hkv, L, S, hd, kwargs):
    _flash_case(dt, B, Hq, Hkv, L, S, hd, kwargs, seed=L + S + hd,
                bq=128, bk=128)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,L,hd,kwargs,blk", [
    # lengths no 64-row tile of the CUDA kernel divides; the Pallas kernel
    # needs L % bq == 0, so it runs one block of the whole length
    (1, 4, 2, 100, 64, dict(causal=True, window=24), 100),
    (2, 4, 1, 200, 128, dict(causal=True, softcap=50.0), 100),
    (1, 2, 2, 1, 64, dict(causal=True), 1),
])
def test_flash_plain_ragged_lengths(dt, B, Hq, Hkv, L, hd, kwargs, blk):
    _flash_case(dt, B, Hq, Hkv, L, L, hd, kwargs, seed=L, bq=blk, bk=blk)


def test_flash_plain_q_offset():
    _flash_case("f32", 1, 2, 2, 128, 256, 64, dict(q_offset=128), seed=7)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kwargs", [
    dict(q_offset=128, window=64),            # key tiles wholly out of reach
    dict(q_offset=100, window=300, softcap=30.0),
], ids=["window", "softcap"])
def test_flash_plain_q_offset_window(dt, kwargs):
    # a query tile past the start of the keys: the lower window edge and
    # the causal edge both cut through key tiles
    _flash_case(dt, 2, 4, 1, 128, 256, 64, kwargs, seed=11, bq=128, bk=128)


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

def _decode_case(dt, B, Hq, Hkv, S, hd, pos, cur, seed, **kwargs):
    rng = np.random.default_rng(seed)
    qj, qt = both(rng.normal(size=(B, Hq, hd)), dt)
    kj, kt = both(rng.normal(size=(B, S, Hkv, hd)), dt)
    vj, vt = both(rng.normal(size=(B, S, Hkv, hd)), dt)
    pj, pt = jnp.asarray(pos, jnp.int32), torch.tensor(pos, dtype=torch.int32)
    heads = dict(n_q_heads=Hq, n_kv_heads=Hkv)
    pallas = R_ops.decode_attention(qj, kj, vj, pj, jnp.int32(cur), **heads,
                                    bs=128, **kwargs)
    ref = R_ops.decode_attention(qj, kj, vj, pj, jnp.int32(cur), **heads,
                                 impl="ref", **kwargs)
    port = Q_da.decode_attention(qt, kt, vt, pt, cur, **heads, **kwargs)
    assert port.dtype == TORCH[dt] and port.shape == qt.shape
    assert relerr(port, pallas) < TOL[dt]
    assert relerr(port, ref) < TOL[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,hd,window", [
    (2, 4, 2, 256, 64, 0),
    (1, 8, 1, 128, 128, 0),
    (2, 4, 4, 256, 64, 64),
    (3, 2, 2, 384, 128, 128),
    (1, 16, 1, 256, 256, 128),  # RecurrentGemma's MQA group at hd 256
])
def test_decode_plain_matches_pallas_and_ref(dt, B, Hq, Hkv, S, hd, window):
    # test_kernels.py's cache: slots in order, the last 40 empty
    pos = np.broadcast_to(np.arange(S), (B, S))
    pos = np.where(pos < S - 40, pos, -1)
    _decode_case(dt, B, Hq, Hkv, S, hd, pos, S - 41, seed=S + hd,
                 window=window)


def ring_positions(B, S, cur):
    """Positions 0..cur written into an S-slot ring: slot j holds the latest
    p <= cur with p % S == j, or -1."""
    j = np.arange(S)
    pos = cur - (cur - j) % S
    return np.broadcast_to(np.where(pos >= 0, pos, -1), (B, S)).copy()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["wrapped", "wrapped-window", "one-valid",
                                  "softcap", "mha", "all-empty"])
def test_decode_plain_ring_buffer(dt, case):
    B, Hq, Hkv, S, hd, cur, kw = 2, 8, 1, 256, 64, 700, {}
    pos = ring_positions(B, S, cur)          # wrapped: not sorted by slot
    if case == "wrapped-window":
        kw = dict(window=100)
    elif case == "one-valid":
        keep = pos[:, 37].copy()
        pos[:] = -1
        pos[:, 37] = keep
    elif case == "softcap":
        kw = dict(softcap=30.0, window=200)
    elif case == "mha":
        Hkv = Hq
    elif case == "all-empty":               # no valid slot: V is averaged
        pos[:] = -1
    _decode_case(dt, B, Hq, Hkv, S, hd, pos, cur, seed=len(case), **kw)


# ---------------------------------------------------------------------------
# rg_lru
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,L,W,bl,bw", [
    (1, 256, 256, 128, 128),
    (2, 512, 512, 256, 512),
    (3, 128, 384, 128, 128),
    (2, 100, 100, 100, 100),    # ragged
    (1, 1, 8, 1, 8),
    (3, 384, 200, 128, 200),    # odd batch, ragged width
])
def test_rg_lru_plain_matches_pallas_and_ref(B, L, W, bl, bw):
    rng = np.random.default_rng(L + W)
    a = rng.uniform(0.2, 0.999, size=(B, L, W)).astype(np.float32)
    b = rng.normal(size=(B, L, W)).astype(np.float32)
    pallas = R_ops.rg_lru(jnp.asarray(a), jnp.asarray(b), bl=bl, bw=bw)
    ref = R_ops.rg_lru(jnp.asarray(a), jnp.asarray(b), impl="ref")
    port = Q_rl.rg_lru(torch.tensor(a), torch.tensor(b))
    assert port.dtype == torch.float32 and port.shape == (B, L, W)
    assert relerr(port, pallas) < 1e-4
    assert relerr(port, ref) < 1e-4


# ---------------------------------------------------------------------------
# rg_lru: the CUDA kernel's tiles and look-back
# ---------------------------------------------------------------------------

def scan_emulate(a, b, plan, lag, drop_nearest=False):
    """``csrc/rg_lru.cu``'s scan in float32 torch, tile by tile in ticket
    order: each tile's local scan with a zero carry and the running product
    A_t of a, its published aggregate, the look-back over its time
    predecessors, and h_t = h_local,t + A_t * carry. ``lag[k]`` is how many
    of tile k's nearest predecessors had published only their aggregate
    when it looked back (the next one had its inclusive prefix; the first
    time tile publishes its prefix at once), so that every interleaving of
    the look-back is reached. ``drop_nearest`` leaves the nearest
    predecessor's h aggregate out of the fold, a planted fault."""
    h = torch.empty_like(a)
    chains = plan.B * plan.n_stripes
    agg, incl = {}, {}
    for k, (bb, tt, ss) in enumerate(plan.order().tolist()):
        t0, t1 = tt * plan.T, min(plan.L, (tt + 1) * plan.T)
        c0, c1 = ss * plan.C, min(plan.W, (ss + 1) * plan.C)
        at, bt = a[bb, t0:t1, c0:c1], b[bb, t0:t1, c0:c1]
        hl, prod = torch.zeros(c1 - c0), torch.ones(c1 - c0)
        local, cum = torch.empty_like(at), torch.empty_like(at)
        for t in range(t1 - t0):
            hl = at[t] * hl + bt[t]
            prod = prod * at[t]
            local[t], cum[t] = hl, prod
        agg[k] = (prod, hl)
        carry = torch.zeros(c1 - c0)
        acc_a, acc_h = torch.ones(c1 - c0), torch.zeros(c1 - c0)
        j = k - chains
        for step in range(tt):
            if step == lag[k] or j < chains:
                carry = acc_a * incl[j] + acc_h
                break
            if not (drop_nearest and j == k - chains):
                acc_h = acc_a * agg[j][1] + acc_h
            acc_a = acc_a * agg[j][0]
            j -= chains
        incl[k] = prod * carry + hl
        h[bb, t0:t1, c0:c1] = local + cum * carry
    return h


def slow_decay_inputs(rng, B, L, W):
    """a in [0.2, 0.999) on even channels and in [0.999, 1) on odd ones,
    where a carry outlives many tiles (as RG-LRU's slowest channels do), so
    that a carry dropped or folded wrongly shows; b standard normal."""
    a = rng.uniform(0.2, 0.999, size=(B, L, W))
    a[..., 1::2] = rng.uniform(0.999, 1.0, size=a[..., 1::2].shape)
    return (a.astype(np.float32),
            rng.normal(size=(B, L, W)).astype(np.float32))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("W", [1, 100, 200, 4 * Q_rl.TILE_C + 3])
@pytest.mark.parametrize("L", [1, Q_rl.TILE_T - 1, Q_rl.TILE_T,
                               Q_rl.TILE_T + 1, 3 * Q_rl.TILE_T - 1])
def test_rg_lru_scan_emulation_matches_plain_pallas_and_ref(B, L, W):
    """The kernel's tiles and look-back, with a random look-back depth per
    tile, against the plain version, the reference oracle and the Pallas
    kernel (interpret mode, one block), at the scan tolerance 1e-4."""
    rng = np.random.default_rng(B * 10_000 + L * 1_000 + W)
    a, b = slow_decay_inputs(rng, B, L, W)
    plan = Q_rl.scan_plan(B, L, W)
    lag = [int(rng.integers(0, t + 1)) for _, t, _ in plan.order().tolist()]
    got = scan_emulate(torch.tensor(a), torch.tensor(b), plan, lag)
    assert got.dtype == torch.float32 and got.shape == (B, L, W)
    assert relerr(got, Q_rl.rg_lru_plain(torch.tensor(a),
                                         torch.tensor(b))) < 1e-4
    ref = R_ops.rg_lru(jnp.asarray(a), jnp.asarray(b), impl="ref")
    assert relerr(got, ref) < 1e-4
    pallas = R_ops.rg_lru(jnp.asarray(a), jnp.asarray(b), bl=L, bw=W)
    assert relerr(got, pallas) < 1e-4


def test_rg_lru_scan_emulation_sees_a_dropped_aggregate():
    """The inputs show a look-back that skips one aggregate (a fault that
    chip_fault_probe.py plants in the kernel): with every tile folding all
    its predecessors' aggregates, the sound walk holds 1e-4, and the walk
    that leaves out the nearest predecessor's h aggregate does not."""
    rng = np.random.default_rng(7)
    B, L, W = 1, 3 * Q_rl.TILE_T - 1, 200
    a, b = (torch.tensor(x) for x in slow_decay_inputs(rng, B, L, W))
    plan = Q_rl.scan_plan(B, L, W)
    want = Q_rl.rg_lru_plain(a, b)
    lag = [t for _, t, _ in plan.order().tolist()]    # aggregates only
    assert relerr(scan_emulate(a, b, plan, lag), want) < 1e-4
    assert relerr(scan_emulate(a, b, plan, lag, drop_nearest=True),
                  want) > 1e-2


@pytest.mark.parametrize("B,L,W", [
    (4, 3072, 4096),         # RecurrentGemma-9B's prefill
    (1, 1, 1), (1, 9, 1), (3, 63, 100), (2, 65, 4097), (1, 191, 515),
    (2, 3072, 100), (5, 200, 129),
])
def test_rg_lru_scan_plan(B, L, W):
    """Every (b, t, w) lies in exactly one tile, and every time predecessor
    of a tile holds a lower ticket."""
    plan = Q_rl.scan_plan(B, L, W)
    assert (plan.T, plan.C) == (Q_rl.TILE_T, Q_rl.TILE_C)
    order = plan.order()
    assert order.shape == (plan.n_tiles, 3)
    # tiles are distinct and their spans partition time and channels
    assert len({tuple(x) for x in order.tolist()}) == plan.n_tiles
    assert set(order[:, 0].tolist()) == set(range(B))
    assert (plan.n_time - 1) * plan.T < L <= plan.n_time * plan.T
    assert (plan.n_stripes - 1) * plan.C < W <= plan.n_stripes * plan.C
    if B * L * W <= 200_000:
        cover = np.zeros((B, L, W), np.int32)
        for bb, tt, ss in order.tolist():
            cover[bb, tt * plan.T:(tt + 1) * plan.T,
                  ss * plan.C:(ss + 1) * plan.C] += 1
        assert (cover == 1).all()
    ticket = {tuple(x): k for k, x in enumerate(order.tolist())}
    for k, (bb, tt, ss) in enumerate(order.tolist()):
        if tt > 0:
            assert ticket[(bb, tt - 1, ss)] < k


# ---------------------------------------------------------------------------
# grouped_matmul
# ---------------------------------------------------------------------------

def _gmm_case(dt, G, M, K, N, pallas_kw=None):
    rng = np.random.default_rng(G + M + K + N)
    xj, xt = both(rng.normal(size=(G, M, K)), dt)
    wj, wt = both(rng.normal(size=(G, K, N)), dt)
    port = Q_gmm.grouped_matmul(xt, wt)
    assert port.dtype == TORCH[dt] and port.shape == (G, M, N)
    assert relerr(port, R_ops.grouped_matmul(xj, wj, impl="ref")) < TOL[dt]
    if pallas_kw is not None:
        assert relerr(port, R_ops.grouped_matmul(xj, wj, **pallas_kw)) < TOL[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("G,M,K,N", [
    (2, 128, 512, 128),
    (4, 256, 256, 256),
    (8, 128, 1024, 128),
])
def test_grouped_matmul_plain_matches_pallas_and_ref(dt, G, M, K, N):
    _gmm_case(dt, G, M, K, N, pallas_kw=dict(bm=128, bn=128, bk=256))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("G,M,K,N", [
    (16, 1, 256, 96),       # decode: one capacity row per expert
    (1, 96, 128, 64),       # one group
    (3, 33, 100, 72),       # M, K, N no tile divides
], ids=["M1", "G1", "ragged"])
def test_grouped_matmul_plain_matches_ref(dt, G, M, K, N):
    # the Pallas kernel needs M divisible by its tile, so only the oracle
    _gmm_case(dt, G, M, K, N)


# ---------------------------------------------------------------------------
# decode_attention: the CUDA kernel's split-S decomposition
# ---------------------------------------------------------------------------

def split_decode(q, k, v, pos, cur, *, n_q_heads, n_kv_heads, n_split, span,
                 window=0, softcap=0.0):
    """``csrc/decode_attention.cu``'s two passes in float32 torch. Pass 1:
    each run of ``span`` slots is walked in tiles (64 slots where the run
    holds two or more, else 32, as the kernel picks) with an online softmax
    (invalid slots score -1e30), giving (m, l, acc) per head; a run with no
    visible slot reports l = 0. Pass 2: the runs with l > 0 are rescaled by
    exp(m - max m) and summed; where there is none, V is averaged over the
    S slots."""
    B, Hq, hd = q.shape
    S, Kv = k.shape[1], n_kv_heads
    G = Hq // Kv
    scale = 1.0 / np.sqrt(hd)
    valid = Q_da.valid_slots(pos, cur, window)                 # [B, S]
    qh = q.float().reshape(B, Kv, G, hd)
    kh, vh = (t.float().permute(0, 2, 1, 3) for t in (k, v))   # [B, Kv, S, hd]
    tile = 64 if span % 64 == 0 and span >= 128 else 32
    parts = []
    for sp in range(n_split):
        s0, s1 = sp * span, min(S, sp * span + span)
        m = torch.full((B, Kv, G), Q_da.NEG_INF)
        l = torch.zeros(B, Kv, G)
        acc = torch.zeros(B, Kv, G, hd)
        for j0 in range(s0, s1, tile):
            j1 = min(s1, j0 + tile)
            s = torch.einsum("bkgd,bksd->bkgs", qh, kh[:, :, j0:j1]) * scale
            if softcap > 0:
                s = torch.tanh(s / softcap) * softcap
            s = torch.where(valid[:, None, None, j0:j1], s, Q_da.NEG_INF)
            mx = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - mx[..., None])
            c = torch.exp(m - mx)
            l = l * c + p.sum(-1)
            acc = acc * c[..., None] + torch.einsum("bkgs,bksd->bkgd", p,
                                                    vh[:, :, j0:j1])
            m = mx
        seen = valid[:, s0:s1].any(-1)[:, None, None]           # [B, 1, 1]
        parts.append((m, torch.where(seen, l, 0.0), acc))
    m = torch.stack([p[0] for p in parts])
    l = torch.stack([p[1] for p in parts])
    acc = torch.stack([p[2] for p in parts])
    top = torch.where(l > 0, m, -torch.inf).amax(0)
    wts = torch.where(l > 0, torch.exp(m - top), 0.0)
    den = (wts * l).sum(0)
    num = (wts[..., None] * torch.where(l[..., None] > 0, acc, 0.0)).sum(0)
    mean = vh.mean(2)[:, :, None, :].expand_as(num)
    out = torch.where(den[..., None] > 0,
                      num / den.clamp(min=1e-30)[..., None], mean)
    return out.reshape(B, Hq, hd)


def _plan(S, n_split):
    """(n_split, span) for about ``n_split`` runs of whole tiles."""
    tiles = -(-S // Q_da.TILE)
    per = -(-tiles // n_split)
    return -(-tiles // per), per * Q_da.TILE


# name: (B, Hq, Kv, S, hd, cur, kwargs, which slots stay visible)
SPLIT_CASES = {
    "all-empty": (2, 8, 1, 256, 64, 700, {}, "none"),
    "last-split-only": (2, 8, 2, 384, 64, 1000, {}, "last"),
    "ragged-1001-window-300": (2, 8, 1, 1001, 64, 2500, dict(window=300),
                               "ring"),
    "softcap-50": (1, 8, 2, 256, 64, 900, dict(softcap=50.0), "ring"),
    "G8-hd128": (2, 32, 4, 256, 128, 3100, {}, "ring"),
}


@pytest.mark.parametrize("n_split", [1, 3, 7])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_decode_matches_plain_and_pallas(case, n_split):
    """The split-S decomposition against the plain version and, where the
    Pallas kernel's ``S % bs == 0`` holds, the Pallas kernel (interpret
    mode) and its oracle, in float32: 2e-5. The run counts 3 and 7 divide
    none of the cache lengths."""
    B, Hq, Kv, S, hd, cur, kw, keep = SPLIT_CASES[case]
    pos = ring_positions(B, S, cur)
    if keep == "none":
        pos[:] = -1
    elif keep == "last":                  # one slot, in the last run only
        pos[:] = -1
        pos[:, S - 1] = cur
    n, span = _plan(S, n_split)
    assert (n - 1) * span < S <= n * span
    rng = np.random.default_rng(S + n_split)
    qj, qt = both(rng.normal(size=(B, Hq, hd)), "f32")
    kj, kt = both(rng.normal(size=(B, S, Kv, hd)), "f32")
    vj, vt = both(rng.normal(size=(B, S, Kv, hd)), "f32")
    heads = dict(n_q_heads=Hq, n_kv_heads=Kv)
    pt = torch.tensor(pos, dtype=torch.int32)
    got = split_decode(qt, kt, vt, pt, cur, **heads, n_split=n, span=span,
                       **kw)
    assert relerr(got, Q_da.decode_attention_plain(qt, kt, vt, pt, cur,
                                                   **heads, **kw)) < TOL["f32"]
    pj = jnp.asarray(pos, jnp.int32)
    ref = R_ops.decode_attention(qj, kj, vj, pj, jnp.int32(cur), **heads,
                                 impl="ref", **kw)
    assert relerr(got, ref) < TOL["f32"]
    if S % 128 == 0:
        pallas = R_ops.decode_attention(qj, kj, vj, pj, jnp.int32(cur),
                                        **heads, bs=128, **kw)
        assert relerr(got, pallas) < TOL["f32"]


@pytest.mark.parametrize("B,Kv,S,want", [
    (4, 1, 2048, (64, 32)),       # RecurrentGemma-9B's decode: 256 blocks
    (4, 4, 4096, (16, 256)),      # Qwen3-30B-A3B's decode: 256 blocks
    (1, 1, 1, (1, 32)),
    (2, 1, 300, (10, 32)),
    (64, 8, 4096, (1, 4096)),
    (1, 1, 100_000, None),
])
def test_split_plan(B, Kv, S, want):
    """The wrapper's choice of runs on a 132-SM card: whole tiles that
    cover S exactly once, at most ``MAX_SPAN`` slots a run, and at least
    one block per SM where the cache has that many tiles."""
    n, span = Q_da.split_plan(B * Kv, S, 132)
    if want is not None:
        assert (n, span) == want
    assert span % Q_da.TILE == 0 and span <= Q_da.MAX_SPAN
    assert (n - 1) * span < S <= n * span
    assert B * Kv * n >= min(132, B * Kv * -(-S // Q_da.TILE))


# ---------------------------------------------------------------------------
# flash_attention: the CUDA kernel's tile walk
# ---------------------------------------------------------------------------

def flash_walk(q, k, v, *, n_q_heads, n_kv_heads, causal=True, window=0,
               softcap=0.0, q_offset=0):
    """``csrc/flash_attention.cu``'s walk in float32 torch: for each 64-row
    consumer of each 128-row query tile, the key tiles of ``tile_plan`` in
    order. S = q k^T in float32; on the tiles the plan masks, keys a row
    does not see score -inf; the running max starts at -1e30 and lives in
    log2 units, the scale (or the softcap) folded into the exponent as the
    kernel's FMA does; P is rounded to bfloat16 before P V; the output is O
    over max(l, 1e-30). Rows that see no key come out zero."""
    BH, Lq, hd = q.shape
    S = k.shape[1]
    G = n_q_heads // n_kv_heads
    scale = 1.0 / np.sqrt(hd)
    log2e = 1.4426950408889634
    bk = Q_fa.key_tile(hd)
    kv_row = [(b // n_q_heads) * n_kv_heads + (b % n_q_heads) // G
              for b in range(BH)]
    qf = q.float()
    kf, vf = k.float()[kv_row], v.float()[kv_row]        # [BH, S, hd]
    vis = Q_fa.attention_mask(Lq, S, causal=causal, window=window,
                              q_offset=q_offset)
    out = torch.zeros(BH, Lq, hd)
    for r0, r1, tiles, masked, _ in Q_fa.tile_plan(
            Lq, S, hd, causal=causal, window=window, q_offset=q_offset):
        if r1 <= r0:
            continue
        m = torch.full((BH, r1 - r0), -1e30)
        l = torch.zeros(BH, r1 - r0)
        o = torch.zeros(BH, r1 - r0, hd)
        for t in tiles:
            k0, k1 = t * bk, min(S, t * bk + bk)
            s = qf[:, r0:r1] @ kf[:, k0:k1].transpose(1, 2)
            if softcap > 0:
                x, to_log2 = torch.tanh(s * scale / softcap) * softcap * log2e, 1.0
            else:
                x, to_log2 = s, scale * log2e
            if t in masked:
                x = torch.where(vis[r0:r1, k0:k1], x, -torch.inf)
            mx = torch.maximum(m, x.amax(-1) * to_log2)
            corr = torch.exp2(m - mx)
            p = torch.exp2(x * to_log2 - mx[..., None])
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + p.to(torch.bfloat16).float() @ vf[:, k0:k1]
            m = mx
        out[:, r0:r1] = o / l.clamp(min=1e-30)[..., None]
    return out.to(q.dtype)


# name: (B, Hq, Hkv, Lq, S, hd, kwargs, Pallas blocks or None)
WALK_CASES = {
    "causal-hd64-two-tiles": (1, 4, 2, 256, 256, 64, dict(causal=True), 128),
    "causal-hd128-mqa": (2, 4, 1, 256, 256, 128, dict(causal=True), 128),
    "window-hd128-gqa": (1, 8, 2, 384, 384, 128,
                         dict(causal=True, window=100), 128),
    "softcap-hd64": (1, 2, 2, 256, 256, 64,
                     dict(causal=True, softcap=30.0), 128),
    "noncausal-rect-hd128": (1, 4, 4, 128, 384, 128, dict(causal=False), 128),
    "ragged-129-hd64": (1, 2, 1, 129, 129, 64, dict(causal=True, window=40),
                        None),
    "ragged-300x200-hd128": (1, 4, 2, 300, 200, 128, dict(causal=False),
                             None),
    "q-offset-window-hd128": (1, 4, 1, 100, 400, 128,
                              dict(causal=True, q_offset=300, window=150),
                              None),
    "q-offset-softcap-hd64": (2, 4, 2, 130, 290, 64,
                              dict(causal=True, q_offset=160, softcap=20.0),
                              None),
    "hd256-window": (1, 2, 1, 200, 200, 256, dict(causal=True, window=70),
                     None),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_flash_walk_matches_plain_and_pallas(case):
    """The kernel's walk on bfloat16 inputs against the plain version and
    the reference oracle (and the Pallas kernel in interpret mode where its
    blocks divide the lengths), at the bfloat16 tolerance 2e-2."""
    B, Hq, Hkv, L, S, hd, kw, blk = WALK_CASES[case]
    rng = np.random.default_rng(L * 7 + S + hd)
    qj, qt = both(rng.normal(size=(B * Hq, L, hd)), "bf16")
    kj, kt = both(rng.normal(size=(B * Hkv, S, hd)), "bf16")
    vj, vt = both(rng.normal(size=(B * Hkv, S, hd)), "bf16")
    heads = dict(n_q_heads=Hq, n_kv_heads=Hkv)
    got = flash_walk(qt, kt, vt, **heads, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    assert relerr(got, Q_fa.flash_attention_plain(qt, kt, vt, **heads,
                                                  **kw)) < TOL["bf16"]
    ref = R_ops.flash_attention(qj, kj, vj, **heads, impl="ref", **kw)
    assert relerr(got, ref) < TOL["bf16"]
    if blk is not None:
        pallas = R_ops.flash_attention(qj, kj, vj, **heads, bq=blk, bk=blk,
                                       **kw)
        assert relerr(got, pallas) < TOL["bf16"]


def test_flash_walk_zeroes_rows_that_see_no_key():
    """A window and q_offset that put every key out of reach of the first
    rows: the kernel's walk gives them zeros (the plain version averages V,
    a documented difference the model never meets); the other rows agree."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.normal(size=s), dtype=torch.float32)
               for s in ((2, 64, 64), (2, 100, 64), (2, 100, 64)))
    kw = dict(n_q_heads=1, n_kv_heads=1, causal=True, window=10,
              q_offset=105)      # rows 0-3 see keys 96-99, the rest none
    got = flash_walk(q, k, v, **kw)
    want = Q_fa.flash_attention_plain(q, k, v, **kw)
    sees = Q_fa.attention_mask(64, 100, causal=True, window=10,
                               q_offset=105).any(-1)
    assert 0 < int(sees.sum()) < 64
    assert torch.equal(got[:, ~sees], torch.zeros_like(got[:, ~sees]))
    assert relerr(got[:, sees], want[:, sees]) < TOL["bf16"]


PLAN_CASES = [   # Lq, S, hd, causal, window, q_offset
    (3072, 3072, 256, True, 2048, 0),     # RecurrentGemma-9B's prefill
    (3072, 3072, 128, True, 0, 0),        # Qwen3-30B-A3B's prefill
    (129, 129, 256, True, 2048, 0),
    (2049, 2049, 128, True, 0, 0),
    (1000, 1000, 128, True, 300, 0),
    (300, 1000, 128, True, 500, 700),
    (67, 257, 128, True, 0, 190),
    (130, 70, 64, False, 0, 0),
    (1, 1, 256, True, 2048, 0),
    (64, 100, 64, True, 10, 105),
    (300, 1000, 64, True, 500, 700),      # the last item's second consumer
    (200, 200, 128, True, 0, 0),          #   has no rows
]


@pytest.mark.parametrize("Lq,S,hd,causal,window,q_offset", PLAN_CASES)
def test_flash_tile_plan(Lq, S, hd, causal, window, q_offset):
    """Every visible (query, key) pair lies in a key tile its consumer
    visits; every visited tile holds a visible pair; and a visited tile is
    masked exactly when it holds a pair of the consumer's rows and a key
    (past S included) that the row does not see."""
    bk = Q_fa.key_tile(hd)
    vis = Q_fa.attention_mask(Lq, S, causal=causal, window=window,
                              q_offset=q_offset)
    n_tiles = -(-S // bk)
    pad = torch.zeros(Lq, n_tiles * bk, dtype=torch.bool)
    pad[:, :S] = vis
    per_tile = pad.view(Lq, n_tiles, bk)
    seen_rows = 0
    plan = Q_fa.tile_plan(Lq, S, hd, causal=causal, window=window,
                          q_offset=q_offset)
    for i, (r0, r1, tiles, masked, walk) in enumerate(plan):
        # both consumers of an item hand back the same tiles, once each, in
        # order, and visit their own tiles among them
        item = [t for t, _ in plan[i - i % 2][4]]
        assert [t for t, _ in walk] == item == sorted(set(item))
        assert [t for t, v in walk if v] == tiles
        rows = per_tile[r0:r1]                        # [rows, tiles, bk]
        any_vis = rows.any(-1).any(0)                 # [tiles]
        all_vis = rows.all(-1).all(0)
        want_tiles = torch.nonzero(any_vis).flatten().tolist()
        assert tiles == list(range(want_tiles[0], want_tiles[-1] + 1)) \
            if want_tiles else tiles == []
        assert all(bool(any_vis[t]) for t in tiles)
        assert masked == [t for t in tiles if not bool(all_vis[t])]
        seen_rows += max(0, r1 - r0)
    assert seen_rows == Lq
