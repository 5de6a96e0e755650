"""The port's paper-scale invariant sweep (the counterpart of
``scripts/full_cycle_sweep.py``): compile every routing scheme of
``repro_torch.core`` at 108 ToRs and run
:func:`repro_torch.core.toolkit.check_tables` over the full schedule
cycle, walks included.

TO schemes sweep the 108-ToR round-robin rotor cycle (T = 107); TA schemes
wildcard time and sweep a single-slice 108-node instance that
:func:`repro_torch.core.topology_jnp.edmonds_conn` matches on the device
from a seeded random traffic matrix (the reference sweep's instance).
Prints one line a scheme with its compile and check seconds, the
violations on stderr, and exits non-zero on any violation. Usage::

    python3 scripts/full_cycle_sweep_torch.py [--n 108] [--device cpu]

The device defaults to CUDA and the script fails without it; ``--device
cpu`` runs the matching on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def schemes():
    """(TO schemes, TA schemes): each (name, compiler, the multipath hashes
    that must be loop-free). ``ksp``'s slots past 0 admit longer paths and
    are not loop-free under a fixed per-flow hash."""
    from repro_torch.core import (direct, ecmp, hoho, ksp, opera, ucmp, vlb,
                                  wcmp)
    to = [("direct", direct, (0, 1)), ("vlb", vlb, (0, 1, 2)),
          ("opera", opera, (0, 1)), ("ucmp", ucmp, (0, 1, 2)),
          ("hoho", hoho, (0, 1))]
    ta = [("ecmp", ecmp, (0, 1, 2)), ("wcmp", wcmp, (0, 1, 2)),
          ("ksp", ksp, (0,))]
    return to, ta


def ta_instance(n: int, device):
    """The TA schedule: ``edmonds_conn`` on ``device`` of a random traffic
    matrix from seed 0 (uniform in [0, 100), zero diagonal), drawn in
    float64 and matched in float32."""
    import torch
    from repro_torch.core import Schedule, topology_jnp
    rng = np.random.default_rng(0)
    tm = rng.random((n, n)) * 100
    np.fill_diagonal(tm, 0)
    conn = topology_jnp.edmonds_conn(torch.as_tensor(tm, dtype=torch.float32,
                                                     device=device))
    return Schedule(conn.cpu().numpy())


def sweep(n: int, device):
    """Yield (name, schedule, compile s, check s, violations) for every
    scheme, TO schemes first, in the reference's order."""
    from repro_torch.core import round_robin, toolkit
    to, ta = schemes()
    rotor = round_robin(n, 1)
    ta_sched = ta_instance(n, device)
    for (name, alg, hashes), sched in [(s, rotor) for s in to] + \
            [(s, ta_sched) for s in ta]:
        t0 = time.time()
        routing = alg(sched)
        t_compile = time.time() - t0
        t0 = time.time()
        bad = toolkit.check_tables(sched, routing, max_hops=32,
                                   hashes=hashes)
        yield name, sched, t_compile, time.time() - t0, bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=108, help="ToR count")
    ap.add_argument("--device", default="cuda",
                    help="where the TA instance is matched (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.core.fabric import resolve_device
    device = resolve_device(args.device)
    n = args.n
    failures = 0
    for name, sched, t_compile, t_check, bad in sweep(n, device):
        status = "ok" if not bad else f"{len(bad)} VIOLATIONS"
        print(f"{name:8s} n={n} T={sched.num_slices:4d} "
              f"compile={t_compile:6.1f}s check={t_check:6.1f}s {status}",
              flush=True)
        for msg in bad[:10]:
            print(f"  {msg}", file=sys.stderr)
        failures += bool(bad)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
