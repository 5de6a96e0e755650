"""The device routing compiler in PyTorch: the port of
``repro.core.routing_jnp``.

The backward time-expanded DP and every TO scheme compiler (``direct``,
``vlb``, ``opera``, ``ucmp``, ``hoho``) as torch programs on the device
of the schedule tensor they are given, so the reconfigure loop
(:mod:`.reconfigure`) recompiles its tables each epoch without leaving the
card. The host compilers of :mod:`.routing` stay the reference: every
function here gives their tables exactly (``tests/test_torch_routing_jnp
.py`` holds both, and ``repro.core.routing_jnp``, on the same schedules).
The scheme compilers reach it through ``compile_impl="jnp"``.

The formulation is the reference's (see its module docstring):

* the DP carries the lexicographic ``(arrival, hops)`` metric as two int32
  components with the unreachable sentinel ``(JINF, 0)``, one step per
  slice of the horizon ``H = 2T`` (a Python loop here, as the reference's
  ``lax.scan``);
* the equal-cost slot of start slice ``t`` is the event with column-global
  index ``C[t] + s``, found with one batched ``torch.searchsorted(...,
  right=True)`` over the event-count cumsum of every (node, destination)
  column, and kept only inside ``t``'s run of equal cost.

Everything is integer, so the tables are exact. Where the reference takes
an ``argmax`` of a boolean (Opera's first uplink one step closer), the port
takes the first true index explicitly, so no device's tie rule enters.
"""
from __future__ import annotations

import torch

__all__ = [
    "JINF",
    "time_dp_all",
    "dp_tables",
    "first_direct_offsets",
    "direct_tables",
    "vlb_tables",
    "opera_tables",
    "compile_tables",
    "SCHEMES",
]

# int32 unreachable sentinel for the arrival component; an unreachable cell
# is ``(JINF, 0)``
JINF = 1 << 30

SCHEMES = ("direct", "vlb", "opera", "ucmp", "hoho")

_I32 = torch.int32


def _ar(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=dev)


def time_dp_all(conn: torch.Tensor, max_hop: int = 4) -> torch.Tensor:
    """Backward DP over the time-expanded graph, batched over all
    destinations: ``cost[t, n, d, :] = (arrival, hops)``, ``[H + 1, N, N,
    2]`` int32 with ``H = 2T``. ``max_hop`` is kept for the reference's
    signature (it only sized the host's fused encoding)."""
    del max_hop
    T, N, U = conn.shape
    dev = conn.device
    H = 2 * T
    diag = _ar(N, dev)
    arr_H = torch.full((N, N), JINF, dtype=_I32, device=dev)
    arr_H[diag, diag] = H
    hop_H = torch.zeros((N, N), dtype=_I32, device=dev)
    at_dst = [conn[:, :, k].to(torch.int64)[:, :, None] == diag
              for k in range(U)]                     # [T, N, D] per uplink
    rows_a, rows_h = [None] * H, [None] * H
    arr_next, hop_next = arr_H, hop_H
    for t in range(H - 1, -1, -1):
        ca, ch = arr_next, hop_next
        for k in range(U):
            peer = conn[t % T, :, k]
            ok = (peer >= 0)[:, None]
            pclip = peer.clamp(0, N - 1).to(torch.int64)
            hit = at_dst[k][t % T]
            pa = torch.where(hit, t, arr_next[pclip])
            ph = torch.where(hit, 0, hop_next[pclip])
            cand_a = torch.where(ok, pa, JINF)
            cand_h = torch.where(ok, ph + 1, 0)
            # lexicographic minimum; an unreachable candidate never beats
            # the (JINF, 0) sentinel
            take = (cand_a < ca) | ((cand_a == ca) & (cand_h < ch))
            ca = torch.where(take, cand_a, ca)
            ch = torch.where(take, cand_h, ch)
        # ca, ch are the uplink loop's fresh tensors (a schedule has an
        # uplink), so the carry stays untouched
        ca[diag, diag] = t
        ch[diag, diag] = 0
        rows_a[t], rows_h[t] = ca, ch
        arr_next, hop_next = ca, ch
    arr = torch.stack(rows_a + [arr_H])
    hop = torch.stack(rows_h + [hop_H])
    return torch.stack([arr, hop], dim=-1)             # [H+1, N, D, 2]


def dp_tables(conn: torch.Tensor, max_hop: int = 4, kpaths: int = 4):
    """Earliest-arrival per-hop time-flow tables ``(tf_next, tf_dep)``,
    ``[T, N, D, kpaths]`` int32 (UCMP for ``kpaths > 1``, HOHO slot 0
    alone): the slot-``s`` action of start slice ``t`` is the event with
    column-global index ``C[t] + s``, located with a batched
    ``searchsorted`` and kept only inside ``t``'s cost run."""
    T, N, U = conn.shape
    dev = conn.device
    H = 2 * T
    cost = time_dp_all(conn, max_hop)                 # [H+1, N, D, 2]
    costH_a = cost[:H, :, :, 0]
    costH_h = cost[:H, :, :, 1]
    diag = _ar(N, dev)
    tts = _ar(H, dev)
    peer = conn[tts % T]                              # [H, N, U]
    ok = peer >= 0

    # same peer on an earlier uplink: counted once, earlier uplink wins
    dup_cols = [torch.zeros((H, N), dtype=torch.bool, device=dev)]
    for u in range(1, U):
        d_u = torch.zeros((H, N), dtype=torch.bool, device=dev)
        for u2 in range(u):
            d_u = d_u | (peer[:, :, u2] == peer[:, :, u])
        dup_cols.append(d_u & ok[:, :, u])

    # match[tt, n, u, d]: hopping n -> peer(tt, u) attains cost[tt, n, d]
    match_cols = []
    for u in range(U):
        p_u = peer[:, :, u]
        pc = p_u.clamp(0, N - 1).to(torch.int64)
        val = cost[1:][tts[:, None], pc]              # cost[tt+1, peer, d, :]
        at_dst = p_u.to(torch.int64)[..., None] == diag
        va = torch.where(at_dst, tts.to(_I32)[:, None, None], val[..., 0])
        vh = torch.where(at_dst, 0, val[..., 1])
        match_cols.append(
            (ok[:, :, u] & ~dup_cols[u])[..., None] & (va == costH_a)
            & (vh + 1 == costH_h) & (costH_a < JINF))
    match = torch.stack(match_cols, dim=2)            # [H, N, U, D] bool

    evcount = match.sum(dim=2, dtype=_I32)            # [H, N, D]
    C = torch.cat([torch.zeros((1, N, N), dtype=_I32, device=dev),
                   torch.cumsum(evcount, dim=0, dtype=_I32)])
    total = C[H]                                      # [N, D]

    S = kpaths
    g = C[:T][:, :, :, None] + torch.arange(S, dtype=_I32, device=dev)
    # slice holding the g-th event: #slices tt with C[tt+1] <= g
    Ccols = C[1:].permute(1, 2, 0).reshape(N * N, H).contiguous()
    gcols = g.permute(1, 2, 0, 3).reshape(N * N, T * S).contiguous()
    tt_g = torch.searchsorted(Ccols, gcols, right=True)
    tt_g = tt_g.reshape(N, N, T, S).permute(2, 0, 1, 3)
    tt_c = tt_g.clamp(0, H - 1)                       # [T, N, D, S] int64

    nn = diag[None, :, None, None]
    dd = diag[None, None, :, None]
    cost_ta = costH_a[:T][:, :, :, None]
    cost_th = costH_h[:T][:, :, :, None]
    valid = (g < total[None, :, :, None]) \
        & (costH_a[tt_c, nn, dd] == cost_ta) \
        & (costH_h[tt_c, nn, dd] == cost_th) & (cost_ta < JINF)
    r_w = g - C[tt_c, nn, dd]                         # within-slice rank

    matchi = match.to(_I32)
    urank = torch.cumsum(matchi, dim=2, dtype=_I32) - matchi
    tf_next = torch.full((T, N, N, S), -1, dtype=_I32, device=dev)
    for u in range(U):
        m_g = match[:, :, u, :][tt_c, nn, dd]
        r_g = urank[:, :, u, :][tt_c, nn, dd]
        p_g = peer[:, :, u][tt_c, nn]
        hit = valid & m_g & (r_g == r_w)
        tf_next = torch.where(hit, p_g, tf_next)
    t_col = torch.arange(T, dtype=torch.int64, device=dev)[:, None, None,
                                                           None]
    tf_dep = torch.where(valid, tt_c - t_col, 0).to(_I32)
    return tf_next, tf_dep


def _has_circuit_grid(conn: torch.Tensor) -> torch.Tensor:
    """has[t, n, d]: a circuit n -> d is up in slice t."""
    T, N, U = conn.shape
    dev = conn.device
    has = torch.zeros((T, N, N), dtype=torch.bool, device=dev)
    tgrid = _ar(T, dev)[:, None]
    ngrid = _ar(N, dev)[None, :]
    for u in range(U):
        p = conn[:, :, u]
        pc = p.clamp(0, N - 1).to(torch.int64)
        # (t, n) is unique within one uplink, so this is a plain scatter
        has[tgrid, ngrid, pc] = has[tgrid, ngrid, pc] | (p >= 0)
    return has


def first_direct_offsets(conn: torch.Tensor) -> torch.Tensor:
    """first[t, n, d]: slices to wait at node n (from slice t) until the
    next direct circuit n -> d; -1 if the schedule never provides one
    (suffix minimum over a doubled cycle)."""
    T, N, U = conn.shape
    dev = conn.device
    NEVER = 1 << 30
    has2 = torch.cat([_has_circuit_grid(conn)] * 2, dim=0)   # [2T, N, N]
    idx = torch.arange(2 * T, dtype=_I32, device=dev)[:, None, None]
    nxt = torch.where(has2, idx, NEVER)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, (0,)), dim=0).values, (0,))
    off = nxt[:T] - torch.arange(T, dtype=_I32, device=dev)[:, None, None]
    return torch.where(nxt[:T] >= NEVER, -1, off).to(_I32)


def direct_tables(conn: torch.Tensor):
    """Direct-circuit ``(tf_next, tf_dep)`` with k = 1."""
    T, N, U = conn.shape
    fd = first_direct_offsets(conn)
    found = fd >= 0
    tf_next = torch.where(found, torch.arange(N, dtype=_I32,
                                              device=conn.device), -1)
    tf_dep = torch.where(found, fd, 0).to(_I32)
    return tf_next[..., None], tf_dep[..., None]


def vlb_tables(conn: torch.Tensor, kpaths: int = 4):
    """VLB ``(tf_next, tf_dep, inj_next, inj_dep)``: spray at injection over
    the currently connected neighbours, direct-circuit at transit."""
    T, N, U = conn.shape
    dev = conn.device
    diag = torch.arange(N, dtype=_I32, device=dev)
    tf_next, tf_dep = direct_tables(conn)
    is_peer = _has_circuit_grid(conn)                 # [T, N, D]
    nd_ok = diag[:, None] != diag[None, :]
    peer = conn
    ok = peer >= 0
    validu = ok[:, :, :, None] & (peer[:, :, :, None] != diag) \
        & nd_ok[None, :, None, :]
    vi = validu.to(_I32)
    rank = torch.cumsum(vi, dim=2, dtype=_I32) - vi
    sel = validu & (rank < kpaths) & ~is_peer[:, :, None, :]
    slots = []
    for s in range(kpaths):
        acc = torch.full((T, N, N), -1, dtype=_I32, device=dev)
        for u in range(U):
            hit = sel[:, :, u, :] & (rank[:, :, u, :] == s)
            acc = torch.where(hit, peer[:, :, u][:, :, None], acc)
        slots.append(acc)
    inj_next = torch.stack(slots, dim=-1)             # [T, N, D, kpaths]
    short = is_peer & nd_ok[None]
    inj_next[:, :, :, 0] = torch.where(short, diag, inj_next[:, :, :, 0])
    inj_dep = torch.zeros((T, N, N, kpaths), dtype=_I32, device=dev)
    return tf_next, tf_dep, inj_next, inj_dep


def opera_tables(conn: torch.Tensor, max_hop: int = 4):
    """Opera ``(tf_next, tf_dep)``: in-slice multi-hop shortest paths with
    a direct-circuit fallback, all slices at once."""
    T, N, U = conn.shape
    dev = conn.device
    diag = _ar(N, dev)
    BIG = 1 << 20
    ok = (conn >= 0)[..., None]                       # [T, N, U, 1]
    pclip = conn.clamp(0, N - 1).to(torch.int64)
    tix = _ar(T, dev)[:, None, None]
    dist = torch.full((T, N, N), BIG, dtype=_I32, device=dev)
    dist[:, diag, diag] = 0
    for _ in range(max_hop):
        nd = torch.where(ok, dist[tix, pclip], BIG)   # [T, N, U, D]
        dist = torch.minimum(dist, 1 + nd.min(dim=2).values)
    nd = torch.where(ok, dist[tix, pclip], BIG)
    good = nd == dist[:, :, None, :] - 1              # [T, N, U, D]
    usable = (dist > 0) & (dist <= max_hop) & good.any(dim=2)
    # the first uplink one step closer (argmax of a boolean: 0 if none)
    first_u = torch.zeros((T, N, N), dtype=torch.int64, device=dev)
    for u in range(U - 1, -1, -1):
        first_u = torch.where(good[:, :, u, :], u, first_u)
    nxt = torch.where(usable, conn.gather(2, first_u), -1)
    fb_next, fb_dep = direct_tables(conn)
    missing = nxt < 0
    tf_next = torch.where(missing, fb_next[..., 0], nxt)[..., None]
    tf_dep = torch.where(missing, fb_dep[..., 0], 0).to(_I32)[..., None]
    return tf_next.to(_I32), tf_dep


def compile_tables(conn: torch.Tensor, scheme: str, max_hop: int = 4,
                   kpaths: int = 4):
    """``(tf_next, tf_dep, inj_next, inj_dep)`` for any TO ``scheme`` in
    :data:`SCHEMES`, on the device of ``conn`` (``[T, N, U]`` int32): the
    entry point :mod:`.reconfigure` calls every epoch."""
    if scheme == "ucmp":
        n, d = dp_tables(conn, max_hop, kpaths)
        return n, d, n, d
    if scheme == "hoho":
        n, d = dp_tables(conn, max_hop, kpaths=1)
        return n, d, n, d
    if scheme == "direct":
        n, d = direct_tables(conn)
        return n, d, n, d
    if scheme == "opera":
        n, d = opera_tables(conn, max_hop)
        return n, d, n, d
    if scheme == "vlb":
        return vlb_tables(conn, kpaths)
    raise ValueError(f"unknown TO scheme {scheme!r}: expected one of {SCHEMES}")
