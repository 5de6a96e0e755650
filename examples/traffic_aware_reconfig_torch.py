"""Traffic-aware reconfiguration at paper scale on the PyTorch port.

The program of ``examples/traffic_aware_reconfig.py`` (a 108-ToR rotor
fabric under RotorNet-style direct routing, four elephant pairs over a
uniform mouse floor; every epoch the loop measures the pending demand from
the live fabric state, grants the hottest pairs extra circuit slices,
recompiles the time-flow tables on the device and swaps them into the
running data plane; ``k_hot=0`` is the oblivious baseline on the same
code path), through ``repro_torch`` on a CUDA card, or on the CPU with
``--device cpu``. It prints what the reference prints.

    python examples/traffic_aware_reconfig_torch.py [--device cuda|cpu]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (FabricConfig, ReconfigConfig,  # noqa: E402
                              Workload, reconfigure, round_robin)

N_TORS, SLICE_US = 108, 10.0
SLICE_BYTES = int(100 / 8 * 1e3 * SLICE_US)  # 100 Gbps circuits
EPOCHS, EPOCH_SLICES = 8, 16

# -- skewed workload: 4 elephant pairs on top of uniform mice ---------------
rng = np.random.default_rng(0)
P_mice, P_eleph = 4000, 16000
hot = [(3, 77), (41, 12), (88, 9), (55, 100)]
src = np.concatenate([rng.integers(0, N_TORS, P_mice),
                      np.repeat([s for s, _ in hot], P_eleph // len(hot))])
dst = np.concatenate([rng.integers(0, N_TORS, P_mice),
                      np.repeat([d for _, d in hot], P_eleph // len(hot))])
dst = np.where(dst == src, (src + 1) % N_TORS, dst)
P = src.size
is_eleph = np.zeros(P, bool)
is_eleph[P_mice:] = True
wl = Workload(
    src=src.astype(np.int32), dst=dst.astype(np.int32),
    size=np.full(P, 1000, np.int32),
    t_inject=rng.integers(0, 2 * EPOCH_SLICES, P).astype(np.int32),
    flow=(np.arange(P, dtype=np.int32) % 256),
    seq=np.arange(P, dtype=np.int32) // 256,
    is_eleph=is_eleph,
)

sched = round_robin(N_TORS, 1, slice_us=SLICE_US)
cfg = FabricConfig(slice_bytes=SLICE_BYTES)
ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="torch device of the loop (default: cuda)")
device = ap.parse_args().device

for k_hot, label in [(0, "oblivious (k_hot=0)"), (4, "traffic-aware (k_hot=4)")]:
    rcfg = ReconfigConfig(epoch_slices=EPOCH_SLICES, num_epochs=EPOCHS,
                          scheme="direct", k_hot=k_hot)
    reconfigure(sched, wl, cfg, rcfg, device=device)   # warm: kernel builds
    t0 = time.time()
    res = reconfigure(sched, wl, cfg, rcfg, device=device)
    dt = time.time() - t0
    S = EPOCHS * EPOCH_SLICES
    done = res.t_deliver >= 0
    print(f"\n== {label} ==")
    print(f"delivered        : {done.mean():.1%} of packets "
          f"({res.delivered_bytes.sum() / 1e6:.1f} MB), elephants "
          f"{done[is_eleph].mean():.1%}")
    print(f"loop rate (warm) : {S / dt:.0f} slices/s, "
          f"{EPOCHS / dt:.1f} on-device recompiles/s")
    if k_hot:
        print("epoch | pending MB | hot pairs granted circuit slices")
        for e in range(EPOCHS):
            pairs = [f"{s}->{d}" for s, d in
                     zip(res.hot_src[e], res.hot_dst[e]) if s >= 0]
            print(f"  {e}   |   {res.demand_total[e] / 1e6:6.1f}   | "
                  + ", ".join(pairs))
