"""Demand-aware vs. rotor scheduling, head to head, on the PyTorch port.

The program of ``examples/demand_aware_vs_rotor.py``: one skewed workload
(a few elephant pairs over a uniform mouse floor), four ways to schedule
the optics through the same reconfigure loop (the oblivious rotor, rotor
plus hot slices, a greedy matching per epoch, a Birkhoff-von-Neumann cycle
per epoch), each epoch's schedule re-derived and its tables recompiled on
the device; through ``repro_torch`` on a CUDA card, or on the CPU with
``--device cpu``. It prints what the reference prints.

    python examples/demand_aware_vs_rotor_torch.py [--device cuda|cpu]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import (FabricConfig, ReconfigConfig,  # noqa: E402
                              Workload, reconfigure, round_robin,
                              topology_jnp)
from repro_torch.core.fabric import resolve_device  # noqa: E402

N_TORS, SLICE_US = 32, 10.0
SLICE_BYTES = int(100 / 8 * 1e3 * SLICE_US)     # 100 Gbps circuits
EPOCHS, EPOCH_SLICES = 6, 16

# -- skewed workload: 3 elephant pairs over a uniform mouse floor -----------
rng = np.random.default_rng(0)
P_mice, P_eleph = 2000, 9000
hot = [(3, 17), (21, 8), (28, 11)]
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

VARIANTS = [
    ("rotor (oblivious)", dict(scheduler="hot_slices", k_hot=0)),
    ("hot-slices (sorn)", dict(scheduler="hot_slices", k_hot=4)),
    ("edmonds (c-Through)", dict(scheduler="edmonds")),
    ("bvn (Mordia)", dict(scheduler="bvn", bvn_slices=8, bvn_perms=8)),
]

print(f"{N_TORS} ToRs, {P} packets ({is_eleph.mean():.0%} elephant), "
      f"{EPOCHS} epochs x {EPOCH_SLICES} slices\n")
print(f"{'variant':22} {'delivered':>10} {'elephants':>10} {'mice':>8} "
      f"{'slices/s':>9}")
for label, kw in VARIANTS:
    rcfg = ReconfigConfig(epoch_slices=EPOCH_SLICES, num_epochs=EPOCHS,
                          scheme="direct", **kw)
    reconfigure(sched, wl, cfg, rcfg, device=device)   # warm: kernel builds
    t0 = time.time()
    res = reconfigure(sched, wl, cfg, rcfg, device=device)
    dt = time.time() - t0
    done = res.t_deliver >= 0
    print(f"{label:22} {done.mean():>9.1%} {done[is_eleph].mean():>9.1%} "
          f"{done[~is_eleph].mean():>7.1%} "
          f"{EPOCHS * EPOCH_SLICES / dt:>8.0f}")

print("""
Reading the table: the oblivious rotor gives every pair exactly one slice
per cycle, so the elephant pairs crawl. Demand-aware scheduling trades
mouse latency for elephant bandwidth — the matching dedicates the whole
epoch to the hottest pairs (mice starve unless matched), while the BvN
cycle splits slices in proportion to demand and the sorn-style hot slices
keep the rotor floor and add capacity on top.""")

# -- how much of the BvN budget did this TM actually use? -------------------
# perm_found marks the peels whose permutation stayed fully on the
# residual's support (the host analogue: Hopcroft-Karp still found a
# perfect matching). Peels past the effective depth are dead ends: they
# carry ~zero weight and the slice assignment skips them. The mask makes
# the greedy peeler's depth measurable — on this 32-ToR skewed TM greedy
# dead-ends after very few peels (the greedy-vs-Hungarian gap flagged in
# the ROADMAP), while a dense 8-ToR TM sustains several.
tm = np.zeros((N_TORS, N_TORS))
np.add.at(tm, (src, dst), 1000.0)
for label, t in [("32-ToR skewed workload TM", tm),
                 ("dense uniform 8-ToR TM",
                  np.asarray(1.0 - np.eye(8)) * 100)]:
    _, perm_found = topology_jnp.bvn_conn(
        torch.as_tensor(t, dtype=torch.float32,
                        device=resolve_device(device)),
        num_slices=8, max_perms=8, with_info=True)
    depth = int(perm_found.sum())
    print(f"BvN effective decomposition depth [{label}]: {depth}/8 "
          "support-complete peels (perm_found)")
