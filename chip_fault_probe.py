#!/usr/bin/env python3
"""Fault probe of ``chip_smoke.py``'s kernel checks, on one CUDA card.

    python3 chip_fault_probe.py

Shows whether the checks of phase 2 (admission and the time-flow lookup
against their plain versions, bit for bit), phase 7 (flash attention and flash-decode against
their plain versions, per output row; the RG-LRU scan against its plain
version, whole and per channel, and replayed from a CUDA graph), phase 12
(the grouped matmul against its plain version, per output row), phase
15 (a 4-layer full-width Qwen3-30B-A3B through the kernels against the
plain versions), phase 17 (the 108-ToR main path with failure and
control masks and telemetry: its deferred-bytes counter against the packet
state, and its first 48 slices against the CPU's), phase 18 (the same
path in unequal windows against the one-shot run), phase 19 (phased
table swaps: they must change the run), phase 20 (the reconfigure
loop: its versioned installs against the host replay of their versions
and against the CPU) and phase 21 (the seven architectures' deployments
against the reference's digests and their runs against the CPU: "phase
21a"; the scenario sweep's members against their solo runs: "phase 21c")
and phase 22 (the reconfigure loop's sweep against its solo runs: "phase
22a"; the sharded runs against the one-device run: "phase 22b") catch a
wrong kernel or a wrong step; and whether the checks of phases B (the
mLSTM's three forms against each other and the card against the CPU), C
(Seamless through the kernels against the plain versions; its
cross-attention against a plain computation) and D (LLaVA's serve, its
first decode step against the prefill of the prompt and token) catch a
wrong model layer or serve loop. For the unchanged tree and for each
planted fault, ``src/`` and ``chip_smoke.py`` are copied into a temporary
directory, the fault is planted by an exact text substitution in one
source (a CUDA kernel, or a kernel's wrapper), and the checks run there in
a subprocess (every phase for the unchanged tree, the phases named for the
fault otherwise); their output is printed, tagged with the fault. Exits
non-zero when a sound check fails, or when a faulty kernel passes every
phase named for it.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = Path("src/repro_torch/csrc")
GMM, DECODE = CSRC / "grouped_matmul.cu", CSRC / "decode_attention.cu"
FLASH, ADM = CSRC / "flash_attention.cu", CSRC / "admission.cu"
RG, RG_WRAPPER = CSRC / "rg_lru.cu", Path("src/repro_torch/kernels/rg_lru.py")
TFL = CSRC / "time_flow_lookup.cu"
FABRIC = Path("src/repro_torch/core/fabric.py")
FAILURES = Path("src/repro_torch/core/failures.py")
RECONF = Path("src/repro_torch/core/reconfigure.py")
MATCHING = Path("src/repro_torch/core/matching.py")
LAYERS = Path("src/repro_torch/models/layers.py")
SERVE = Path("src/repro_torch/launch/serve.py")
PHASES = ("phase 2", "phase 7", "phase 12", "phase 15", "phase 17",
          "phase 18", "phase 19", "phase 20", "phase 21a", "phase 21c",
          "phase 22a", "phase 22b", "phase B", "phase C", "phase D")
# name: (source, text, replacement, phases of which at least one must fail)
FAULTS = {
    "sound": None,
    # the wgmma route's K loop stops one 64-deep stage early
    "skip the last K step": (
        GMM, "const int n_kb = (K + kWK - 1) / kWK;",
        "const int n_kb = (K + kWK - 1) / kWK - 1;", ("phase 12",)),
    # the streaming route never stores the last row (M = 1 at decode)
    "drop the last row of a ragged M": (
        GMM,
        "og[static_cast<int64_t>(m) * N + n0 + tid] = __float2bfloat16(s);",
        "if (m + 1 < M) "
        "og[static_cast<int64_t>(m) * N + n0 + tid] = __float2bfloat16(s);",
        ("phase 12",)),
    # the streaming route's zero test reads only the first 8 elements of
    # x[g], so a group whose first 8 are zero skips its product
    "zero test reads only x[g][:8]": (
        GMM, "const int n_test = M * K;", "const int n_test = min(M * K, 8);",
        ("phase 12", "phase 15")),
    # the merge of flash-decode's splits leaves out the last one's values
    "merge drops the last split": (
        DECODE, "for (int s = part; s < n_split; s += kMergeParts)",
        "for (int s = part; s < n_split - 1; s += kMergeParts)",
        ("phase 7",)),
    # flash attention's causal edge one key late: a row sees the next key
    "causal edge off by one": (
        FLASH, "khi[h] = sh.causal ? min(qpos, sh.S - 1) : sh.S - 1;",
        "khi[h] = sh.causal ? min(qpos + 1, sh.S - 1) : sh.S - 1;",
        ("phase 7",)),
    # the second consumer warpgroup never rescales its output by the new
    # running max
    "one consumer skips the rescale of O": (
        FLASH, "o[i] *= corr[(i >> 1) & 1];",
        "o[i] *= c == 1 ? 1.0f : corr[(i >> 1) & 1];", ("phase 7",)),
    # admission's walk drops the running totals' update of its second step
    "walk drops one step's update": (
        ADM, "if (k >= 0 && last[u]) run[k] = r + grp[u];",
        "if (k >= 0 && last[u] && s0 + u != 1) run[k] = r + grp[u];",
        ("phase 2",)),
    # the scan's look-back leaves the nearest predecessor's h aggregate out
    # of its fold, whenever that predecessor had not yet published its
    # inclusive prefix
    "look-back skips one aggregate": (
        RG, "acc_h = fmaf(acc_a, load_relaxed(agg_h + pj), acc_h);",
        "if (j != ticket - chains) "
        "acc_h = fmaf(acc_a, load_relaxed(agg_h + pj), acc_h);",
        ("phase 7",)),
    # the wrapper zeroes the scan's flags and ticket counter only when it
    # first makes them for a shape, and reuses them after: a graph replay
    # then starts from the previous call's flags
    "flags and ticket not zeroed per call": (
        RG_WRAPPER,
        "scratch = torch.zeros(1 + n, dtype=torch.int32, device=a.device)",
        "scratch = globals().setdefault(f\"_stale_{n}\", torch.zeros("
        "1 + n, dtype=torch.int32, device=a.device))", ("phase 7",)),
    # the last time tile of a length no tile divides is one step short
    "last partial tile one step short": (
        RG, "const int32_t t0 = tt * kT, nt = min(kT, L - t0);",
        "const int32_t t0 = tt * kT, nt = min(kT, L - t0) - (L - t0 < kT);",
        ("phase 7",)),
    # the lookup's store skips the packets outside the mask, which keep
    # whatever their output held instead of (-1, 0)
    "lookup store skips packets outside the mask": (
        TFL, "  a.out_next[i] = r.x;\n  a.out_dep[i] = r.y;",
        "  if (!a.mask || a.mask[i]) a.out_next[i] = r.x, a.out_dep[i] = r.y;",
        ("phase 2",)),
    # the in-kernel multipath hash leaves out the salt of the slice, which
    # shows for every t > 0
    "lookup hash drops the slice's salt": (
        TFL, "hash32(static_cast<uint32_t>(ih) + a.t * 0x9E3779B9u)",
        "hash32(static_cast<uint32_t>(ih))", ("phase 2",)),
    # the scalar row loads (K of 1 or 3) read the departure row one slot
    # late for odd K
    "lookup scalar route reads the departure row off by one for odd K": (
        TFL, "rd[k] = __ldg(a.rows_dep + e + k);",
        "rd[k] = __ldg(a.rows_dep + e + k + (a.K & 1));", ("phase 2",)),
    # a skewed ToR's local slice with C's truncating %: a negative
    # remainder (a clock behind) stays negative, here clamped to slice 0
    # so that the fault reads inside the table
    "lookup offset with C's truncating %": (
        TFL, "tm = r < 0 ? r + a.Tr : r;", "tm = r < 0 ? 0 : r;",
        ("phase 2", "phase 17")),
    # the per-node offset read only where there is a selector vector: the
    # fused site; the hop site (constant selector) reads slice tm
    "lookup offset ignored at the hop site": (
        TFL, "  if (a.phase_off) {", "  if (a.phase_off && a.sel) {",
        ("phase 2", "phase 17")),
    # the telemetry's deferred bytes leave out the packets that missed
    # their slice
    "telemetry drops the deferred bytes of missed packets": (
        FABRIC, "        if has_tele:\n"
        "            count_(s[\"_tdef\"], cl(s[\"loc\"]), size, missed)\n",
        "", ("phase 17",)),
    # a window's masked capacities built from the schedule's slice 0, not
    # from the window's first slice
    "window capacities unshifted": (
        FABRIC, 'j.get("node_ok"), mt0 if has_fail else 0,',
        'j.get("node_ok"), 0,', ("phase 18",)),
    # a phased run that never swaps its tables in
    "phased swap skipped": (
        FAILURES, "            fs.j.update(fabric_mod._table_arrays(tables, "
        "fs.device))\n", "", ("phase 19",)),
    # the lookup reads version 0 whatever the node's vsel says
    "lookup ignores vsel": (
        TFL, "  if (a.vsel) v = min(max(__ldg(a.vsel + n), 0), a.V - 1);\n",
        "", ("phase 2", "phase 20")),
    # the end-of-epoch merge of each ToR's current tables on the
    # destination axis (2) of [Tr, N, D, K] instead of the node axis (1)
    "epoch merge of the current tables on the wrong axis": (
        RECONF, "swt = torch.as_tensor(sw, device=dev)[None, :, None, None]",
        "swt = torch.as_tensor(sw, device=dev)[None, None, :, None]",
        ("phase 20",)),
    # the end-of-epoch merge skipped: every ToR keeps its boot tables as
    # its old version
    "epoch merge of the current tables skipped": (
        RECONF, "            cur = [torch.where(swt, n, c) for c, n in "
        "zip(cur, new)]\n", "", ("phase 20",)),
    # the in-kernel hash of a scenario sweep takes each packet's index in
    # the launch, not in its scenario: scenario 0 still matches
    "lookup hashes the sweep's global packet index": (
        TFL, "const int64_t ih = a.hb + (a.hp < a.P ? i % a.hp : i);",
        "const int64_t ih = a.hb + i;", ("phase 21c",)),
    # a sharded run's lookup hashes each packet's index in its rank's
    # block, not its global index: rank 0 still matches
    "lookup hashes the shard-local packet index": (
        TFL, "const int64_t ih = a.hb + (a.hp < a.P ? i % a.hp : i);",
        "const int64_t ih = (a.hp < a.P ? i % a.hp : i);",
        ("phase 2", "phase 22b")),
    # a sharded run's admission is fed the capacities without the earlier
    # ranks' wanted bytes taken off: every rank admits as if it were first
    "sharded admission without the earlier ranks' offsets": (
        FABRIC, "cap_left() - earlier_offsets(buf, sh.rank)", "cap_left()",
        ("phase 22b",)),
    # the sweep of the reconfigure loop gives every scenario scenario 0's
    # version select
    "reconfigure sweep gives scenario 0's vsel to every scenario": (
        RECONF, "vsel = np.concatenate(vsels, axis=1)",
        "vsel = np.concatenate([vsels[0]] * len(vsels), axis=1)",
        ("phase 22a",)),
    # bvn's bipartite matching takes the rows in reverse order, so its
    # perfect matchings, and Mordia's schedule, are not the reference's
    "bvn's Hopcroft-Karp iterates rows in reverse": (
        MATCHING, "    left, right = range(n), range(n, 2 * n)",
        "    left, right = range(n - 1, -1, -1), range(n, 2 * n)",
        ("phase 21a",)),
    # the cross-attention's keys rotated by the memory's positions, as
    # self-attention's are (the reference rotates neither side)
    "RoPE on the cross-attention's keys": (
        LAYERS, "    return AttnCache(k, v, positions.to(torch.int32).contiguous())",
        "    return AttnCache(rope(k, positions, cfg.rope_theta), v, "
        "positions.to(torch.int32).contiguous())", ("phase C",)),
    # the chunkwise mLSTM's row stabiliser leaves out the carried state's
    # exponent, so a row whose state outweighs its chunk is scaled wrong
    "mLSTM chunkwise stabiliser without the carried state": (
        LAYERS, "m_row = torch.maximum(D.amax(2), b)", "m_row = D.amax(2)",
        ("phase B",)),
    # a vision model decodes from the prompt's length, as the reference's
    # serve does, not past its patches
    "vision prefix left out of the decode index": (
        SERVE, "    pos = prefix_len(cfg) + prompt_len",
        "    pos = prompt_len", ("phase D",)),
}
CHECKS = """
import sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
import numpy as np
from repro_torch.core import FabricConfig, round_robin, vlb
from repro_torch.core.fabric import _build_caps, stack_tables
dev = torch.device("cuda")
phases = sys.argv[2].split(",")
failed = []
if "phase 2" in phases:
    sched = round_robin(cs.N_TORS, 1)
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    caps = _build_caps(i32(sched.conn), FabricConfig(), cs.N_TORS)
    r = vlb(sched, kpaths=4)
    table = stack_tables(i32(r.inj_next), i32(r.inj_dep), i32(r.tf_next),
                         i32(r.tf_dep))
    for name, check, arg in (("admission", cs.check_admission,
                              caps[0].cpu().numpy()),
                             ("lookup", cs.check_lookup, table)):
        try:
            mis, _ = check(dev, arg)
            print(f"phase 2 {name} mismatches {mis}")
        except SystemExit as e:
            print(f"phase 2 {name}: {e}")
            mis = 1
        if mis and "phase 2" not in failed:
            failed.append("phase 2")
for phase, check, tol in (("phase 7", cs.check_flash, cs.FLASH_TOL),
                          ("phase 7", cs.check_decode, cs.DECODE_TOL),
                          ("phase 7", cs.check_rg_lru, cs.RGLRU_TOL),
                          ("phase 12", cs.check_gmm, cs.GMM_TOL)):
    if phase not in phases:
        continue
    try:
        err, _ = check(dev)
        print(f"{phase} {check.__name__} largest relerr {err:.3e} "
              f"(limit {tol:.1e})")
        if err > tol and phase not in failed:
            failed.append(phase)
    except SystemExit as e:
        print(f"{phase}: {e}")
        if phase not in failed:
            failed.append(phase)
if "phase 15" in phases:
    try:
        cs.check_qwen_vs_plain(dev)
    except SystemExit:
        failed.append("phase 15")
if "phase 17" in phases:
    try:
        print("phase 17", cs.check_masked_path(dev, profile=False))
    except SystemExit as e:
        print(f"phase 17: {e}")
        failed.append("phase 17")
for phase, check in (("phase 18", lambda: cs.check_service(
                          dev, dict(wall_s=float("nan")))),
                     ("phase 19", lambda: cs.check_phased(dev)),
                     ("phase 20", lambda: cs.check_reconfigure(
                         dev, profile=False)),
                     ("phase 21a", lambda: cs.check_architectures(dev)),
                     ("phase 21c", lambda: cs.check_fleet(
                         dev, profile=False)),
                     ("phase 22a", lambda: cs.check_reconfigure_fleet(dev)),
                     ("phase 22b", lambda: cs.check_sharded(dev)),
                     ("phase B", lambda: cs.check_xlstm_vs_cpu(dev)),
                     ("phase C", lambda: cs.check_seamless_vs_plain(dev)),
                     ("phase D", lambda: cs.check_llava(dev))):
    if phase in phases:
        try:
            print(phase, check())
        except SystemExit as e:
            print(f"{phase}: {e}")
            failed.append(phase)
print("FAILED:", ", ".join(failed) or "none", flush=True)
"""
LAST_SPLIT = "one valid slot, in the last split"


def probe(name: str, fault, tmp: Path) -> tuple[str, str]:
    """(the checks' ``FAILED:`` line, their whole output) for one tree."""
    copy = tmp / re.sub(r"\W+", "_", name)
    shutil.copytree(ROOT / "src", copy / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", copy / "chip_smoke.py")
    shutil.copytree(ROOT / "examples", copy / "examples",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if fault is not None:
        path = copy / fault[0]
        text = path.read_text()
        if text.count(fault[1]) != 1:
            raise SystemExit(f"{name}: the text to replace is not in "
                             f"{fault[0]} exactly once")
        path.write_text(text.replace(fault[1], fault[2]))
    phases = PHASES if fault is None else fault[3]
    out = subprocess.run([sys.executable, "-c", CHECKS, str(copy),
                          ",".join(phases)],
                         capture_output=True, text=True, timeout=1500)
    text = out.stdout + out.stderr[-2000:]
    for line in text.splitlines():
        print(f"[{name}] {line}", flush=True)
    lines = [ln for ln in text.splitlines() if ln.startswith("FAILED:")]
    return (lines[-1] if lines else f"FAILED: exit {out.returncode}"), text


def last_split_caught(text: str) -> bool:
    """Whether phase 7's cases with the only visible slot in the last split
    read above the limit."""
    import chip_smoke as cs
    errs = [float(m.group(1)) for m in re.finditer(
        re.escape(LAST_SPLIT) + r": row relerr ([0-9.e+-]+)", text)]
    return bool(errs) and all(e > cs.DECODE_TOL for e in errs)


def graph_replay_caught(text: str) -> bool:
    """Whether both of phase 7's graph replays of the scan read above the
    limit, whole or per channel."""
    import chip_smoke as cs
    reads = [max(float(m.group(1)), float(m.group(2))) for m in re.finditer(
        re.escape(cs.RGLRU_GRAPH) + r" \d: relerr ([0-9.e+-]+|inf), per "
        r"channel ([0-9.e+-]+|inf)", text)]
    return len(reads) == 2 and all(e > cs.RGLRU_TOL for e in reads)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_fault_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name, fault in FAULTS.items():
            verdict, text = probe(name, fault, Path(tmp))
            if fault is None:
                caught = verdict == "FAILED: none"
            else:
                failed = verdict.removeprefix("FAILED: ").split(", ")
                caught = any(p in failed for p in fault[3])
                if fault[0] == DECODE:
                    caught &= last_split_caught(text)
                if fault[0] == RG_WRAPPER:
                    caught &= graph_replay_caught(text)
            print(f"{name}: {verdict} -> "
                  f"{'as required' if caught else 'NOT as required'}",
                  flush=True)
            ok &= caught
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
