#!/usr/bin/env python3
"""Before-and-after timing of the port's kernels on one CUDA card.

    python3 chip_ab.py --base DIR [--profile]

``DIR`` is another checkout of this repository (the parent commit, say,
unpacked with ``git archive``). The two trees take turns, base, this,
this, base, each in its own process that builds that tree's kernels and
times, with that tree's ``chip_smoke.graph_ms`` on the same seeded inputs:
the RG-LRU scan at RecurrentGemma-9B's prefill shape (B 4, L 3,072, W
4,096), flash attention at RecurrentGemma-9B's and Qwen3-30B-A3B's prefill
shapes, and admission at the fabric's 131,072 packets with 11,772 and 108
keys and on one packet (its launch floor). With ``--profile`` each turn
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
import json, sys
import numpy as np, torch
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
