"""The demand schedulers of the reconfigure loop in PyTorch: the port of
``repro.core.topology_jnp``.

Each epoch of :func:`repro_torch.core.reconfigure.reconfigure` re-derives
its schedule from the measured traffic matrix with one of these, on the
device the matrix lies on:

* :func:`edmonds_conn` (c-Through): one topology from a greedy max-weight
  matching per uplink (:func:`greedy_matching`, the reference's 1/2
  approximation of blossom);
* :func:`bvn_conn` (Mordia): a Sinkhorn normalisation (:func:`sinkhorn`),
  ``max_perms`` permutations peeled off the residual with
  :func:`greedy_assignment`, and the epoch's slices given to them in
  weight-proportional runs.

Both give the reference's tensors (``[1, N, U]`` and ``[S, N, 1]`` int32).
Two rules make the greedy steps the reference's:

* every ``argmax`` takes the *first* maximum in row-major order, as
  ``jnp.argmax`` does (:func:`_first_argmax` forms it from a maximum and a
  minimum index, so no device's tie rule enters);
* :func:`greedy_matching`'s loop ends once no positive weight is left, as
  the reference's ``while_loop`` does: the test runs on the host, one
  synchronisation a round (an unguarded round on an all-zero matrix would
  match node 0 with itself).

The Sinkhorn is float32 and sums its rows and columns in torch's order,
not XLA's: its result agrees with the reference's to rounding (held to
1e-6 relative in ``tests/test_torch_topology_jnp.py``), and a peel whose
minimum residual sits at a rounding tie may go another way. The loop's
``bvn`` epochs are therefore held by host replay of their recorded
schedules, as the reference's own tests hold them.
"""
from __future__ import annotations

import torch

__all__ = [
    "greedy_matching",
    "greedy_assignment",
    "sinkhorn",
    "edmonds_conn",
    "bvn_conn",
    "SCHEDULERS",
]

# schedulers reconfigure() runs each epoch
SCHEDULERS = ("hot_slices", "edmonds", "bvn")

_I32 = torch.int32
_F32 = torch.float32


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """The flat index of the first maximum of ``x`` (a 0-d int64 tensor):
    ``jnp.argmax``'s tie rule on any device."""
    flat = x.reshape(-1)
    idx = torch.arange(flat.numel(), dtype=torch.int64, device=x.device)
    return torch.where(flat == flat.max(), idx, flat.numel()).min()


def greedy_matching(sym: torch.Tensor) -> torch.Tensor:
    """Greedy max-weight matching on a symmetric weight matrix: at most
    ``N // 2`` rounds, each matching the endpoints of the heaviest
    remaining edge, until no positive edge is left. Returns ``peer[N]``
    int32 (-1 unmatched) with ``peer[peer[i]] == i`` for matched ``i``."""
    N = sym.shape[0]
    dev = sym.device
    diag = torch.arange(N, dtype=_I32, device=dev)
    eye = diag[:, None] == diag[None, :]
    w = torch.where(eye, 0.0, sym.to(_F32))
    peer = torch.full((N,), -1, dtype=_I32, device=dev)
    for _ in range(N // 2):
        if not bool(w.max() > 0):
            break
        e = _first_argmax(w)
        a, b = (e // N).to(_I32), (e % N).to(_I32)
        peer[a] = b
        peer[b] = a
        hit = (diag == a) | (diag == b)
        w = torch.where(hit[:, None] | hit[None, :], 0.0, w)
    return peer


def edmonds_conn(tm: torch.Tensor, n_uplinks: int = 1) -> torch.Tensor:
    """One topology from the symmetrised traffic matrix: per uplink a
    :func:`greedy_matching` of the demand the earlier uplinks left,
    ``conn[1, N, n_uplinks]`` int32 (-1 dark)."""
    N = tm.shape[0]
    dev = tm.device
    diag = torch.arange(N, dtype=torch.int64, device=dev)
    sym = (tm + tm.T).to(_F32)
    cols = []
    for _ in range(n_uplinks):
        peer = greedy_matching(sym)
        cols.append(peer)
        matched = peer >= 0
        pc = peer.clamp(0, N - 1).to(torch.int64)
        hit = torch.zeros((N, N), dtype=torch.bool, device=dev)
        hit[diag, pc] = matched
        sym = torch.where(hit | hit.T, 0.0, sym)
    return torch.stack(cols, dim=-1)[None]            # [1, N, U]


def sinkhorn(tm: torch.Tensor, iters: int = 200,
             eps: float = 1e-9) -> torch.Tensor:
    """Scale ``tm`` towards doubly stochastic (diagonal zeroed; an all-zero
    matrix falls back to uniform off-diagonal demand), in float32."""
    N = tm.shape[0]
    eye = torch.eye(N, dtype=torch.bool, device=tm.device)
    m = torch.where(eye, 0.0, tm.to(_F32))
    m = torch.where(m.sum() > 0, m, torch.where(eye, 0.0, 1.0))
    for _ in range(iters):
        m = m / torch.clamp(m.sum(dim=1, keepdim=True), min=eps)
        m = m / torch.clamp(m.sum(dim=0, keepdim=True), min=eps)
    return m


def greedy_assignment(w: torch.Tensor) -> torch.Tensor:
    """Greedy row -> column assignment: N rounds of the first maximum over
    the remaining (row, column) grid, its row and column masked after each
    round. Returns a full permutation ``perm[N]`` int32; the diagonal is
    taken only when it is a row's last column."""
    N = w.shape[0]
    dev = w.device
    diag = torch.arange(N, dtype=_I32, device=dev)
    NEG, DIAG_PEN = -1.0, -0.5             # masked; a self-circuit if forced
    w = torch.where(diag[:, None] == diag[None, :], DIAG_PEN,
                    torch.clamp(w.to(_F32), min=0.0))
    perm = torch.full((N,), -1, dtype=_I32, device=dev)
    for _ in range(N):
        e = _first_argmax(w)
        a, b = (e // N).to(_I32), (e % N).to(_I32)
        perm[a] = b
        w = torch.where((diag == a)[:, None] | (diag == b)[None, :], NEG, w)
    return perm


def bvn_conn(tm: torch.Tensor, num_slices: int = 32, max_perms: int = 8,
             sinkhorn_iters: int = 200, eps: float = 1e-9,
             with_info: bool = False):
    """A ``[num_slices, N, 1]`` schedule from a Birkhoff-von-Neumann
    decomposition: Sinkhorn-normalise, peel ``max_perms`` permutations off
    the residual, give slice ``t`` the permutation that covers quantile
    ``(t + 1/2) / num_slices`` of the decomposed weight. A self pair of a
    forced assignment goes dark. With ``with_info`` also returns
    ``perm_found[max_perms]`` (bool): whether peel ``i`` still covered
    positive residual support."""
    N = tm.shape[0]
    dev = tm.device
    rows = torch.arange(N, dtype=torch.int64, device=dev)
    residual = sinkhorn(tm, iters=sinkhorn_iters, eps=eps)
    perms, weights, found = [], [], []
    for _ in range(max_perms):
        perm = greedy_assignment(torch.where(residual > eps, residual, 0.0))
        pl = perm.to(torch.int64)
        got = residual[rows, pl]
        # weight: the smallest residual a support edge covered; an
        # assignment wholly off the support weighs ~eps
        found.append(got.min() > eps)
        wgt = torch.clamp(got.min(), min=eps)
        residual = residual.index_put((rows, pl), -wgt, accumulate=True)
        perms.append(perm)
        weights.append(wgt)
    perms = torch.stack(perms)                        # [max_perms, N]
    weights = torch.clamp(torch.stack(weights), min=0.0)
    cdf = torch.cumsum(weights, dim=0)
    total = torch.clamp(cdf[-1], min=eps)
    q = (torch.arange(num_slices, dtype=_F32, device=dev) + 0.5) \
        / num_slices * total
    pidx = torch.searchsorted(cdf, q, right=False).clamp(0, max_perms - 1)
    sel = perms[pidx]                                 # [num_slices, N]
    sel = torch.where(sel == rows.to(_I32)[None, :], -1, sel)
    conn = sel[:, :, None].to(_I32)
    if with_info:
        return conn, torch.stack(found)
    return conn
