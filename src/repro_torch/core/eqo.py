"""Queue-occupancy estimation (EQO) model (paper §5.2 + Appendix A,
Fig. 12), the counterpart of ``repro.core.eqo``.

Registers in the ingress pipeline can only be updated by ingress packets,
so the dataplane increments the occupancy exactly on enqueue but can only
*estimate* dequeues: a generated packet every ``update_interval`` ns
subtracts ``link_bw x update_interval`` (clamped at zero). The true queue
drains at line rate every ns. Arrivals are an on/off process over 256-ns
phases drawn with the reference's ``jax.random.bernoulli`` bits
(``core.prng``): 2x line rate when on, 0.25x when off.

The reference steps a ``lax.scan`` once a ns. Both queues are Lindley
recursions ``x_t = max(x_{t-1} + d_t, 0)`` from ``x = 0``, whose closed form
is ``x_t = S_t - min(0, min_{s<=t} S_s)`` with ``S = cumsum(d)``: the true
queue has ``d = arrive - bytes_per_ns``, the estimate ``d = arrive - dec``
(``dec`` the update's decrement on its ticks). So the port takes a
cumulative sum and a cumulative minimum over all ticks at once, in
float64. Every term is a multiple of 1/8 byte, so the sums are exact and
``err_max_bytes`` equals the reference's; the reference accumulates the
error's sum in float32, so its ``err_mean_bytes`` drifts from the exact
mean by ~1e-5 to 1e-3 relative.
"""
from __future__ import annotations

import torch

from . import prng
from .fabric import resolve_device

__all__ = ["simulate_eqo"]

PHASE_NS = 256      # length of one on/off phase of the arrival process


def _lindley(d):
    """``x_t = max(x_{t-1} + d_t, 0)`` from ``x = 0``, for every t."""
    s = torch.cumsum(d, 0)
    return s - torch.cummin(s, 0).values.clamp(max=0.0)


def simulate_eqo(update_interval_ns: int, total_ns: int = 200_000,
                 link_gbps: int = 100, seed: int = 0, device=None) -> dict:
    """The estimator against ground truth over ``total_ns`` ticks of 1 ns;
    the reference's dict of the largest and the mean absolute error in
    bytes. CUDA unless ``device`` says otherwise."""
    dev = resolve_device(device)
    bytes_per_ns = link_gbps / 8.0          # 100 Gbps = 12.5 B/ns
    phase = prng.bernoulli(prng.prng_key(seed), 0.5,
                           (total_ns // PHASE_NS + 1,), dev)
    tick = torch.arange(total_ns, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    arrive = torch.where(phase[tick // PHASE_NS],
                         torch.tensor(2.0 * bytes_per_ns, **f64),
                         torch.tensor(0.25 * bytes_per_ns, **f64))
    is_update = tick % update_interval_ns == update_interval_ns - 1
    dec = is_update.to(torch.float64) * (bytes_per_ns * update_interval_ns)
    err = (_lindley(arrive - dec) - _lindley(arrive - bytes_per_ns)).abs()
    return {"update_interval_ns": update_interval_ns,
            "err_max_bytes": float(err.max()),
            "err_mean_bytes": float(err.sum()) / total_ns}
