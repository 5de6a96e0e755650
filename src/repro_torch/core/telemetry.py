"""Fabric telemetry: per-ToR per-slice counters of the data plane, PyTorch
port of ``repro.core.telemetry`` (the same keys, fields and semantics).

A :class:`TelemetryConfig` passed to :func:`repro_torch.core.fabric.simulate`
switches the step into counting mode; the per-slice rows are stacked on the
device with the other per-slice stats, and :class:`TelemetryCounters` is
what ``SimResult.telemetry`` carries. ``telemetry=None`` (the default) runs
exactly the step without counters.

Counter semantics (shapes ``[S, N]`` unless noted; all int32):

* ``injected_bytes``   — bytes entering the fabric per *source* ToR.
* ``delivered_bytes``  — bytes delivered per *destination* ToR (electrical
  deliveries land in their arrival slice ``t + 1``, the convention of
  ``SimResult.delivered_bytes``; an electrical delivery in the final slice
  arrives after the run and is counted in no row).
* ``deferred_bytes``   — bytes deferred by congestion detection (full
  calendar queue at enqueue, or a missed slice) per holding switch; a
  packet deferred repeatedly counts once per deferral.
* ``dropped_bytes``    — bytes dropped by buffer overflow per dropping
  switch.
* ``queue_hwm``        — per-switch high-water mark of switch-resident
  calendar-queue bytes within the slice (max over the hop chain).
* ``util_used`` / ``util_cap`` — optical bytes transmitted vs. optical
  capacity granted per source ToR per slice (the electrical egress column
  is excluded).
* ``lat_hist`` ``[S, B]`` — histogram of delivery latency in slices
  (``t_deliver - t_inject``) for the packets delivered each slice, bucketed
  by the static ``TelemetryConfig.lat_edges`` (``B = len(lat_edges) + 1``;
  bucket ``i`` counts latencies in ``(edges[i-1], edges[i]]``, the last
  bucket is overflow).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TelemetryConfig", "TelemetryCounters", "TELE_KEYS",
           "counters_from_out"]

# the tele_* keys the fabric step emits per slice, in container field order
TELE_KEYS = ("tele_injected", "tele_delivered", "tele_deferred",
             "tele_dropped", "tele_qhwm", "tele_util_used", "tele_util_cap",
             "tele_lat_hist")


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Static telemetry parameters.

    lat_edges: latency-histogram bucket edges, in slices. The histogram has
        ``len(lat_edges) + 1`` buckets; the last is overflow.
    """

    lat_edges: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)

    def __post_init__(self):
        edges = tuple(int(e) for e in self.lat_edges)
        if not edges or list(edges) != sorted(set(edges)) or edges[0] < 0:
            raise ValueError(
                f"lat_edges must be non-empty, strictly increasing and "
                f"non-negative, got {self.lat_edges!r}")
        object.__setattr__(self, "lat_edges", edges)

    @property
    def num_buckets(self) -> int:
        return len(self.lat_edges) + 1


@dataclasses.dataclass
class TelemetryCounters:
    """Host-side per-slice counter frames (see the module docstring for the
    field semantics). ``S`` is the simulated slice count, ``N`` the ToR
    count, ``B = len(lat_edges) + 1``."""

    injected_bytes: np.ndarray   # [S, N] per source ToR
    delivered_bytes: np.ndarray  # [S, N] per destination ToR
    deferred_bytes: np.ndarray   # [S, N] per holding switch
    dropped_bytes: np.ndarray    # [S, N] per dropping switch
    queue_hwm: np.ndarray        # [S, N] switch-resident high-water, bytes
    util_used: np.ndarray        # [S, N] optical bytes sent per source ToR
    util_cap: np.ndarray         # [S, N] optical capacity granted
    lat_hist: np.ndarray         # [S, B] delivery-latency histogram
    lat_edges: tuple[int, ...]

    @property
    def num_slices(self) -> int:
        return int(self.injected_bytes.shape[0])

    @property
    def num_nodes(self) -> int:
        return int(self.injected_bytes.shape[1])


def counters_from_out(out: dict, telemetry: TelemetryConfig | None
                      ) -> TelemetryCounters | None:
    """Build the host container from a result dict of numpy arrays, popping
    the ``tele_*`` rows (callers then build their result dataclass from the
    remaining keys); ``None`` without a config."""
    if telemetry is None:
        return None
    rows = [np.asarray(out.pop(k)) for k in TELE_KEYS]
    return TelemetryCounters(*rows, lat_edges=telemetry.lat_edges)
