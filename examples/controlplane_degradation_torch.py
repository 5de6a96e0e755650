"""Control-plane faults and graceful degradation on the PyTorch port.

The program of ``examples/controlplane_degradation.py`` (the demand-aware
reconfigure loop, one table install per epoch, three ToRs skewed 800 ns
from mid-run on and install messages lost with probability 0.3; hot-swap,
2PC and 2PC with degrade on the same trace, each ToR's lookups reading the
table version its install state selects), through ``repro_torch`` on a
CUDA card, or on the CPU with ``--device cpu``. It prints what the
reference prints.

    python examples/controlplane_degradation_torch.py [--device cuda|cpu]
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (ControlTrace, FabricConfig,  # noqa: E402
                              ReconfigConfig, compile_control, reconfigure,
                              round_robin, synthesize)

N_TORS, SLICE_US = 8, 10.0
SLICE_BYTES = int(100 / 8 * 1e3 * SLICE_US)     # 100 Gbps circuits
EPOCHS, EPOCH_SLICES = 6, 12
S = EPOCHS * EPOCH_SLICES

SKEWED = (1, 2, 4)
SKEW_NS = 800.0          # residual far outside the 200 ns guard band
SKEW_AT = 2 * EPOCH_SLICES
HEAL_AT = 5 * EPOCH_SLICES

sched = round_robin(N_TORS, 1, slice_us=SLICE_US)
cfg = FabricConfig(slice_bytes=SLICE_BYTES)
ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="torch device of the loop (default: cuda)")
device = ap.parse_args().device
wl = synthesize("rpc", N_TORS, int(S * 0.8), slice_bytes=SLICE_BYTES,
                load=0.9, max_packets=4000, seed=5)

trace = ControlTrace().install_loss(0.3, 0)
for node in SKEWED:
    trace.skew(node, SKEW_NS, SKEW_AT)
trace.heal_all(HEAL_AT)
masks = compile_control(trace, S, N_TORS, slice_ns=SLICE_US * 1000.0)

hot = dict(epoch_slices=EPOCH_SLICES, num_epochs=EPOCHS, scheme="hoho",
           k_hot=2, install_timeout=8)
configs = {
    "hot-swap": ReconfigConfig(**hot, install="hotswap"),
    "2PC": ReconfigConfig(**hot, install="2pc"),
    "2PC+degrade": ReconfigConfig(**hot, install="2pc", degrade=True),
}


def per_epoch(delivered_bytes):
    return delivered_bytes.reshape(EPOCHS, EPOCH_SLICES).sum(axis=1) // 1000


print(f"{N_TORS} ToRs, {EPOCHS} epochs x {EPOCH_SLICES} slices; install "
      f"loss 30%; ToRs {SKEWED} skewed {SKEW_NS:.0f} ns @[{SKEW_AT},"
      f"{HEAL_AT})\n")
print(f"{'fabric':12} {'by heal':>8} {'by end':>8}  per-epoch delivered KB")
runs = {}
for label, rcfg in configs.items():
    res = reconfigure(sched, wl, cfg, rcfg, control=masks, device=device)
    runs[label] = res
    total = wl.size.sum()
    by_heal = res.delivered_bytes[:HEAL_AT].sum() / total
    by_end = res.delivered_bytes.sum() / total
    print(f"{label:12} {by_heal:>7.1%} {by_end:>7.1%}  "
          f"{per_epoch(res.delivered_bytes)}")

print("\ninstall history (2PC+degrade):")
res = runs["2PC+degrade"]
for e in range(EPOCHS):
    vers = res.install_ver[e]
    state = ("SAFE MODE" if res.degraded[e] else
             "mixed" if len(np.unique(vers)) > 1 else f"v{vers[0]}")
    print(f"  epoch {e}: ver={vers} ({state}), "
          f"retries={res.install_retries[e]}, "
          f"lat={res.install_lat[e]:+d} slices")

print("""
Reading the table: under 30% install loss the hot-swap fabric runs mixed
table versions (stale ToRs beside upgraded ones, visible as staggered
install latencies) and 2PC retries until every ToR acked. Both are fine —
until the skew window, where every optical send from a skewed ToR misses
its circuit. Only the degraded fabric notices (skew_miss > guard band),
drops to the safe base-cycle tables, keeps delivering on the slices the
skewed ToRs still hit (the "by heal" column — real-time delivery while
the fault is live), and re-promotes to versioned hot-slice tables the
epoch after the heal; the others sit on their backlog until the trace
heals and only then drain it.""")
