"""The fabric step's lookup masks: no result of a packet outside a mask is
used. The step asks the time-flow lookup only for the packets whose
result it reads (injected or re-looked-up at the fused site, in transit at
the hop site), and the kernel gives every other packet (-1, 0); the step
then replaces those packets' offsets by their own indices
(``fabric._spread_offsets``). Here the lookup gives those packets random
next hops in place of -1, the spread gives them random offsets in place of
their indices, and the port's ``simulate`` must still equal ``repro``'s
bit for bit, on every configuration of the mechanism matrix, with flow
pausing, and with per-flow multipath.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as Q  # noqa: E402
from repro_torch.core import fabric as Q_fabric  # noqa: E402

from torch_parity import (  # noqa: E402, F401
    assert_sim_equal, carry, release_compiled_programs)

N = 8
SLICES = 40

CONFIGS = [
    dict(cc_detect=False), dict(), dict(pushback=True),
    dict(pushback=True, offload=True), dict(offload=True),
    dict(flow_pausing=True), dict(pushback=True, flow_pausing=True),
]


def _noisy_lookup(real, gen):
    """``real`` with every packet outside the mask given a random next hop
    in [-1, N]."""
    def lookup(*args, mask=None, **kw):
        nxt, off = real(*args, mask=mask, **kw)
        assert mask is not None, "every lookup of the step passes a mask"
        noise = torch.randint(-1, N + 1, nxt.shape, generator=gen,
                              dtype=torch.int32)
        return torch.where(mask, nxt, noise), off
    return lookup


def _noisy_spread(gen):
    """The step's offsets with every packet outside ``looked_up`` given a
    random offset in [0, 2**20)."""
    def spread(off, looked_up, pid):
        noise = torch.randint(0, 1 << 20, off.shape, generator=gen,
                              dtype=torch.int32)
        return torch.where(looked_up, off, noise)
    return spread


@pytest.mark.parametrize("over", CONFIGS + ["per-flow"],
                         ids=lambda o: o if isinstance(o, str) else
                         "-".join(f"{k}={int(v)}" for k, v in o.items())
                         or "default")
def test_results_outside_the_masks_are_never_used(over, monkeypatch):
    cfg = dict(slice_bytes=4_000,
               **(dict(pushback=True) if over == "per-flow" else over))
    sched = R.round_robin(N, 1)
    tables = R.FabricTables.build(sched, R.vlb(sched))
    if over == "per-flow":
        tables.multipath = "flow"
    wl = R.synthesize("rpc", N, 24, slice_bytes=4_000, load=0.9,
                      max_packets=420, seed=5)
    ref = R.simulate(tables, wl, R.FabricConfig(**cfg), SLICES)
    gen = torch.Generator().manual_seed(7)
    monkeypatch.setattr(Q_fabric, "time_flow_lookup",
                        _noisy_lookup(Q_fabric.time_flow_lookup, gen))
    monkeypatch.setattr(Q_fabric, "_spread_offsets", _noisy_spread(gen))
    qt, qw = carry(tables, wl)
    port = Q.simulate(qt, qw, Q.FabricConfig(**cfg), SLICES, device="cpu")
    assert_sim_equal(ref, port)
    assert np.any(port.t_deliver >= 0)
