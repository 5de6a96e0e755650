#!/usr/bin/env python3
"""Before-and-after timing of the port's kernels on one CUDA card.

    python3 chip_ab.py --base DIR [--profile]

``DIR`` is another checkout of this repository (the parent commit, say,
unpacked with ``git archive``). The two trees take turns, base, this,
this, base, each in its own process that builds that tree's kernels and
times, with that tree's ``chip_smoke.graph_ms`` on the same seeded inputs:
the RG-LRU scan at RecurrentGemma-9B's prefill shape (B 4, L 3,072, W
4,096), flash attention at RecurrentGemma-9B's and Qwen3-30B-A3B's prefill
shapes, admission at the fabric's 131,072 packets with 11,772 and 108
keys and on one packet (its launch floor), and the time-flow lookup in the
TPU's form (a hash vector, no mask, over the tables that tree's
``stack_tables`` builds) at 131,072 packets and on one packet, and in the
port's form (the packed table, the in-kernel hash of slice 213, masks of
density 100% and 10%), where the tree has it also with an 8-scenario
sweep's per-scenario hash index (``hash_period``). Each turn
also runs ``chip_smoke.py``'s phase-6 window (slices 24-39 of the default
108-ToR fabric, after slices 0-23) and reports its wall ms per slice
without the profiler (three runs), and its device ms, wall ms, CUDA
kernels launched and the twelve costliest kernels per slice under the
profiler. With ``--profile`` each turn
also runs ``chip_smoke.profile_serve`` on RecurrentGemma-9B (phase 11's
profile of a full-depth prefill and 8 decode steps). Prints one JSON line
per turn and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

TURN = r"""
import json, sys, time
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile as torch_profile
root, profile = sys.argv[1], sys.argv[2] == "1"
sys.path.insert(0, root)
sys.path.insert(0, root + "/src")
import chip_smoke as cs
from repro_torch.kernels import admission as adm, flash_attention as fa
from repro_torch.kernels import rg_lru as rl
dev = torch.device("cuda")
t = {}
a, b = cs.rglru_inputs(dev, 4, 3072, 4096, 64)
t["rg_lru_ms"] = cs.graph_ms(lambda: rl.rg_lru(a, b))
del a, b
for tag, (B, Hq, Hkv, L, S, hd, kw) in (
        ("flash_rg", (4, 16, 1, 3072, 3072, 256, dict(causal=True, window=2048))),
        ("flash_qwen", (4, 32, 4, 3072, 3072, 128, dict(causal=True)))):
    q, k, v = cs.flash_inputs(dev, B, Hq, Hkv, L, S, hd, seed=60)
    t[tag + "_ms"] = cs.graph_ms(lambda: fa.flash_attention(
        q, k, v, n_q_heads=Hq, n_kv_heads=Hkv, **kw))
rng = np.random.default_rng(3)
P, N = cs.P_MAIN, cs.N_TORS
NK = N * (N + 1)
t32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
size = t32(rng.integers(64, 1501, P))
want = torch.tensor(rng.random(P) < 0.6, device=dev)
key = t32(rng.integers(0, N, P) * (N + 1) + rng.integers(0, N + 1, P))
cap = t32(rng.integers(0, 75_000, NK))
rx_key, room = t32(rng.integers(0, N, P)), t32(rng.integers(0, 2_000_000, N))
t["adm_ms"] = cs.graph_ms(lambda: adm.admission_admit(key, size, want, cap,
                                                      num_keys=NK))
t["adm_rx_ms"] = cs.graph_ms(lambda: adm.admission_admit(
    rx_key, size, want, room, num_keys=N))
t["adm_floor_ms"] = cs.graph_ms(lambda: adm.admission_admit(
    key[:1], size[:1], want[:1], cap, num_keys=NK))
from repro_torch.core import FabricConfig, FabricTables, round_robin, synthesize, vlb
from repro_torch.core.fabric import (_device_arrays, _init_state, _make_step,
                                     stack_tables)
from repro_torch.kernels import time_flow_lookup as tfl
sched = round_robin(N, 1)
routing = vlb(sched, kpaths=4)
i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
tables = stack_tables(i32(routing.inj_next), i32(routing.inj_dep),
                      i32(routing.tf_next), i32(routing.tf_dep))
tn, td = tables if isinstance(tables, tuple) else (tables, None)
rng = np.random.default_rng(5)
node, dst = t32(rng.integers(0, N, P)), t32(rng.integers(0, N, P))
hv, sel = t32(rng.integers(-2 ** 31, 2 ** 31, P)), t32(rng.integers(0, 2, P))
t["tfl_ms"] = cs.graph_ms(lambda: tfl.time_flow_lookup(
    tn, td, 5, sel, node, dst, hv))
t["tfl_floor_ms"] = cs.graph_ms(lambda: tfl.time_flow_lookup(
    tn, td, 5, sel[:1], node[:1], dst[:1], hv[:1]))
import inspect
fleet_hash = "hash_period" in inspect.signature(tfl.time_flow_lookup).parameters
for d, tag in ((1.0, "full"), (0.1, "10")):
    m = torch.tensor(rng.random(P) < d, device=dev)
    t[f"tfl_port_{tag}_ms"] = cs.graph_ms(lambda: tfl.time_flow_lookup(
        tn, td, 5, sel, node, dst, 213, mask=m))
    if fleet_hash:
        t[f"tfl_port_{tag}_fleet_ms"] = cs.graph_ms(
            lambda: tfl.time_flow_lookup(tn, td, 5, sel, node, dst, 213,
                                         mask=m, hash_period=P // 8))
del tables, tn, td
wl = synthesize("rpc", N, 64, slice_bytes=75_000, load=0.4,
                max_packets=1 << 17, seed=0)
j = _device_arrays(FabricTables.build(sched, routing), wl, dev)
step = _make_step(j, FabricConfig(), per_packet_mp=True)


def window(prof=None):
    state = _init_state(j, wl.num_flows)
    for s in range(24):
        step(state, s)
    torch.cuda.synchronize()
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    for s in range(24, 40):
        step(state, s)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 16
    if prof is not None:
        prof.stop()
    return wall


t["window_wall_ms"] = [window() for _ in range(3)]
prof = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
t["window_profiled_wall_ms"] = window(prof)
ev = [e for e in prof.key_averages()
      if e.device_type == DeviceType.CUDA and cs.self_device_ms(e) > 0]
ev.sort(key=lambda e: -cs.self_device_ms(e))
t["window_top_kernels"] = [(e.key[:90], e.count / 16,
                            cs.self_device_ms(e) * 1e3 / 16) for e in ev[:12]]
t["window_device_ms"] = sum(cs.self_device_ms(e) for e in ev) / 16
t["window_idle"] = 1 - t["window_device_ms"] / t["window_profiled_wall_ms"]
t["window_kernels"] = sum(e.count for e in ev if not e.key.startswith(
    ("Memcpy", "Memset"))) / 16
print("TIMES " + json.dumps(t), flush=True)
if profile:
    prof = cs.profile_serve(dev, "recurrentgemma-9b", 11)
    print("PROFILE " + json.dumps(prof), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    ok = True
    for name, tree in (("base", args.base), ("this", ROOT), ("this", ROOT),
                       ("base", args.base)):
        out = subprocess.run(
            [sys.executable, "-c", TURN, str(tree.resolve()),
             "1" if args.profile else "0"],
            capture_output=True, text=True, timeout=1200)
        for line in out.stdout.splitlines():
            if line.startswith(("TIMES ", "PROFILE ")):
                kind, _, body = line.partition(" ")
                print(json.dumps({"tree": name, kind.lower(): json.loads(body)}),
                      flush=True)
            elif line.startswith("phase") or line.startswith("  "):
                print(f"[{name}] {line}", flush=True)
        if out.returncode != 0:
            print(f"[{name}] exit {out.returncode}: {out.stderr[-2000:]}",
                  flush=True)
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
