#!/usr/bin/env python3
"""Fault probe of ``chip_smoke.py``'s grouped matmul checks, on one CUDA card.

    python3 chip_fault_probe.py

Shows whether the limits of phase 12 (the grouped matmul kernel against its
plain version, per output row) and of phase 15 (a 4-layer full-width
Qwen3-30B-A3B through the kernels against the plain versions) catch a wrong
kernel. For the unchanged tree and for each planted fault, ``src/`` and
``chip_smoke.py`` are copied into a temporary directory, the fault is
planted by an exact text substitution in
``src/repro_torch/csrc/grouped_matmul.cu``, and the two checks run there in
a subprocess; their output is printed, tagged with the fault. Exits
non-zero when a sound check fails, or when a faulty kernel passes phase 12.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = Path("src/repro_torch/csrc/grouped_matmul.cu")
FAULTS = {
    "sound": None,
    # the K loop stops one 32-deep step early
    "skip the last K step": ("for (int kt = 0; kt < nk; ++kt) {",
                             "for (int kt = 0; kt < nk - 1; ++kt) {"),
    # the last row of a ragged M is never stored (M = 1 at decode)
    "drop the last row of a ragged M": (
        "if (row >= M || col >= N) continue;",
        "if (row >= M - (M % kBM != 0) || col >= N) continue;"),
}
CHECKS = """
import sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
dev = torch.device("cuda")
failed = []
try:
    err, _ = cs.check_gmm(dev)
    print(f"phase 12 largest row relerr {err:.3e} (limit {cs.GMM_TOL:.1e})")
    if err > cs.GMM_TOL:
        failed.append("phase 12")
except SystemExit as e:
    print(f"phase 12: {e}")
    failed.append("phase 12")
try:
    cs.check_qwen_vs_plain(dev)
except SystemExit:
    failed.append("phase 15")
print("FAILED:", ", ".join(failed) or "none", flush=True)
"""


def probe(name: str, fault, tmp: Path) -> str:
    copy = tmp / name.replace(" ", "_")
    shutil.copytree(ROOT / "src", copy / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", copy / "chip_smoke.py")
    if fault is not None:
        path = copy / SOURCE
        text = path.read_text()
        if text.count(fault[0]) != 1:
            raise SystemExit(f"{name}: the text to replace is not in "
                             f"{SOURCE} exactly once")
        path.write_text(text.replace(fault[0], fault[1]))
    out = subprocess.run([sys.executable, "-c", CHECKS, str(copy)],
                         capture_output=True, text=True, timeout=900)
    text = out.stdout + out.stderr[-2000:]
    for line in text.splitlines():
        print(f"[{name}] {line}", flush=True)
    lines = [ln for ln in text.splitlines() if ln.startswith("FAILED:")]
    return lines[-1] if lines else f"FAILED: exit {out.returncode}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_fault_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name, fault in FAULTS.items():
            verdict = probe(name, fault, Path(tmp))
            print(f"{name}: {verdict}", flush=True)
            if fault is None:
                ok &= verdict == "FAILED: none"
            else:
                ok &= "phase 12" in verdict
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
