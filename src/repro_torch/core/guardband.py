"""Minimum time-slice duration derivation (paper §7), PyTorch port: a copy
of ``repro.core.guardband`` (host Python, identical results).

The container has no Tofino2/OCS hardware, so the paper's *measured*
constants are kept as parameters and the published derivation is reproduced
exactly:

    guardband >= rotation variance (34 ns, Fig. 11: 1324 - 1287)
              +  EQO error as time (725 B / 100 Gbps = 58 ns, Fig. 12)
              +  2 x sync error (2 x 28 ns, the separate sync paper)
              = 148 ns -> 200 ns with headroom
    min slice = 10 x guardband (>= 90% duty cycle) = 2 us
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["GuardbandInputs", "GuardbandResult", "derive"]


@dataclasses.dataclass(frozen=True)
class GuardbandInputs:
    delay_min_ns: float = 1287.0       # Fig. 11 minimum ToR-to-ToR delay
    delay_max_ns: float = 1324.0       # Fig. 11 maximum
    eqo_error_bytes: float = 725.0     # Fig. 12 @ 50 ns update interval
    link_gbps: float = 100.0
    sync_error_ns: float = 28.0        # 192-ToR sync accuracy
    headroom_to_ns: float = 200.0      # runtime-variation rounding target
    duty_cycle_factor: float = 10.0    # slice >= 10 x guardband -> >=90% duty


@dataclasses.dataclass(frozen=True)
class GuardbandResult:
    rotation_variance_ns: float
    eqo_error_ns: float
    sync_guard_ns: float
    total_ns: float
    guardband_ns: float
    min_slice_us: float
    duty_cycle: float
    wasted_fraction: float  # rotation variance / min slice (paper: 1.7%)


def derive(inp: GuardbandInputs = GuardbandInputs()) -> GuardbandResult:
    rot = inp.delay_max_ns - inp.delay_min_ns
    eqo_ns = inp.eqo_error_bytes * 8.0 / inp.link_gbps  # bytes -> ns at link rate
    sync = 2.0 * inp.sync_error_ns
    total = rot + eqo_ns + sync
    guard = max(total, inp.headroom_to_ns)
    # round guardband up to a clean 100 ns grid (the paper picks 200 ns)
    guard = math.ceil(guard / 100.0) * 100.0
    min_slice_ns = guard * inp.duty_cycle_factor
    return GuardbandResult(
        rotation_variance_ns=rot,
        eqo_error_ns=eqo_ns,
        sync_guard_ns=sync,
        total_ns=total,
        guardband_ns=guard,
        min_slice_us=min_slice_ns / 1000.0,
        duty_cycle=1.0 - 1.0 / inp.duty_cycle_factor,
        wasted_fraction=rot / min_slice_ns,
    )
