"""The OpenOptics programming model (paper §4), PyTorch port of
``repro.core.net``: ``OpenOpticsNet`` exposes the Table-1 API surface over
the host control plane (topology + routing) and the PyTorch data plane
(:func:`repro_torch.core.fabric.simulate`).

Typical user program (paper Fig. 5)::

    net = OpenOpticsNet(dict(node="rack", node_num=108, uplink=1))
    sched = round_robin(108, 1)                 # TO optical schedule
    net.deploy_topo(sched)
    net.deploy_routing(vlb(sched))              # paths -> time-flow tables
    res = net.run(workload, num_slices=1000)    # on the GPU

The net runs on CUDA unless built with ``device="cpu"``. Faults injected
with :meth:`OpenOpticsNet.inject_failure` / :meth:`~OpenOpticsNet.inject_control`
apply to the :meth:`~OpenOpticsNet.run` windows they touch. The reference's
clocked-service API (``ingest``, ``advance``, ``snapshot``), the one reader
of the net's telemetry config, is not ported yet (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import routing as routing_mod
from .controlplane import ControlTrace, compile_control
from .fabric import (FabricConfig, FabricTables, SimResult, Workload,
                     resolve_device, simulate)
from .failures import FailureTrace, compile_masks
from .routing import CompiledRouting
from .telemetry import TelemetryConfig
from .topology import Schedule, deploy_topo_check

__all__ = ["OpenOpticsNet", "clos_routing"]


def clos_routing(n_nodes: int, kpaths: int = 1) -> CompiledRouting:
    """Baseline electrical Clos: every packet takes the electrical egress
    (peer id == n_nodes), a plain flow table (all time fields wildcarded)."""
    nxt = np.full((1, n_nodes, n_nodes, kpaths), -1, dtype=np.int32)
    nxt[0, :, :, 0] = n_nodes
    dep = np.zeros_like(nxt)
    return CompiledRouting(nxt, dep, nxt.copy(), dep.copy(), multipath="flow")


class OpenOpticsNet:
    """An OpenOptics network object (paper §4.2) whose data plane runs on
    ``device`` (CUDA by default; ``"cpu"`` for the plain PyTorch
    versions of the kernels)."""

    def __init__(self, config: dict, device=None):
        self.device = resolve_device(device)
        self.config = dict(config)
        self.n_nodes = int(config["node_num"])
        self.n_uplinks = int(config.get("uplink", 1))
        self.slice_us = float(config.get("slice_us", 100.0))
        self.schedule: Schedule | None = None
        self.routing: CompiledRouting | None = None
        self.fabric_cfg = FabricConfig(**config.get("fabric", {}))
        self._last_tm = np.zeros((self.n_nodes, self.n_nodes), dtype=np.float64)
        self._last_result: SimResult | None = None
        self._last_workload: Workload | None = None
        self._clock = 0  # slices elapsed across run() windows
        self.failure_trace = FailureTrace()
        self.control_trace = ControlTrace()
        tele = config.get("telemetry", None)
        if isinstance(tele, dict):
            tele = TelemetryConfig(**tele)
        # stored for the clocked service (not ported yet); run() does not
        # count, as in the reference
        self.telemetry: TelemetryConfig | None = tele

    # -- Topology APIs ------------------------------------------------------
    def deploy_topo(self, sched: Schedule) -> bool:
        """Feasibility-check and deploy a topology/schedule (Table 1)."""
        if sched.num_nodes != self.n_nodes:
            raise ValueError("schedule node count mismatch")
        if not deploy_topo_check(sched.conn):
            return False
        self.schedule = sched
        return True

    # -- Routing APIs --------------------------------------------------------
    def deploy_routing(self, routing: CompiledRouting, LOOKUP: str = "hop",
                       MULTIPATH: str | None = None) -> bool:
        """Attach time-flow tables (Table 1). LOOKUP="hop" uses per-hop
        tables; "source" is a documented alias (per-hop tables here are
        derived from full paths)."""
        routing.lookup = LOOKUP
        if MULTIPATH is not None:
            routing.multipath = MULTIPATH
        self.routing = routing
        return True

    def add(self, node: int, dst: int, egress: int, arr_ts=None, dep_ts=None) -> bool:
        if self.routing is None:
            raise RuntimeError("deploy_routing first")
        return routing_mod.add_entry(self.routing, node, dst, egress, arr_ts, dep_ts)

    # -- Failure APIs (repro_torch.core.failures) ----------------------------
    def inject_failure(self, kind: str, *, node: int = -1, dst: int = -1,
                       uplink: int = 0, t_start: int | None = None,
                       t_end: int | None = None, scale: float = 0.5) -> bool:
        """Inject a fault into the fabric (Table-1 API style). ``kind`` is
        one of ``"link"`` (circuit ``node -> dst`` dark), ``"port"``
        (``node``'s OCS ``uplink`` stuck), ``"tor"`` (``node`` down), or
        ``"degrade"`` (circuit ``node -> dst`` keeps a ``scale`` capacity
        fraction). ``t_start`` defaults to the net's current clock and
        ``t_end`` to open-ended (until :meth:`heal`). Subsequent
        :meth:`run` windows simulate under the accumulated fault trace.
        """
        from .failures import OPEN_END
        t0 = self._clock if t_start is None else t_start
        t1 = OPEN_END if t_end is None else t_end
        if kind == "link":
            self.failure_trace.link_flap(node, dst, t0, t1)
        elif kind == "port":
            self.failure_trace.stuck_port(node, uplink, t0, t1)
        elif kind == "tor":
            self.failure_trace.tor_outage(node, t0, t1)
        elif kind == "degrade":
            self.failure_trace.degrade(node, dst, scale, t0, t1)
        else:
            raise ValueError(f"unknown failure kind {kind!r}")
        return True

    def heal(self, t: int | None = None) -> bool:
        """End every active fault at slice ``t`` (default: the net's
        current clock) and drop faults scheduled to start later."""
        self.failure_trace.heal_all(self._clock if t is None else t)
        return True

    # -- Control-plane fault APIs (repro_torch.core.controlplane) ------------
    def inject_control(self, kind: str, *, node: int = -1,
                       skew_ns: float = 0.0, drift_ns: float = 0.0,
                       delay: int = 0, loss: float = 0.0,
                       t_start: int | None = None,
                       t_end: int | None = None) -> bool:
        """Inject a control-plane fault (Table-1 API style). ``kind`` is
        one of ``"skew"`` (ToR ``node``'s clock runs ``skew_ns`` off
        fabric time), ``"drift"`` (``drift_ns`` more per slice),
        ``"install_delay"`` / ``"install_loss"`` (table-install messages
        to ``node``, or every ToR when -1, are delayed/lost), or
        ``"stall"`` (the controller stalls). ``t_start`` defaults to the
        net's current clock, ``t_end`` to open-ended (until
        :meth:`heal_control`). Subsequent :meth:`run` windows simulate
        under the accumulated trace.
        """
        from .controlplane import OPEN_END
        t0 = self._clock if t_start is None else t_start
        t1 = OPEN_END if t_end is None else t_end
        if kind == "skew":
            self.control_trace.skew(node, skew_ns, t0, t1)
        elif kind == "drift":
            self.control_trace.drift(node, drift_ns, t0, t1)
        elif kind == "install_delay":
            self.control_trace.install_delay(delay, t0, t1, node=node)
        elif kind == "install_loss":
            self.control_trace.install_loss(loss, t0, t1, node=node)
        elif kind == "stall":
            self.control_trace.stall(t0, t1)
        else:
            raise ValueError(f"unknown control fault kind {kind!r}")
        return True

    def heal_control(self, t: int | None = None) -> bool:
        """End every active control-plane fault at slice ``t`` (default:
        the net's current clock; the control-plane mirror of
        :meth:`heal`)."""
        self.control_trace.heal_all(self._clock if t is None else t)
        return True

    # -- Monitoring APIs ------------------------------------------------------
    def collect(self, interval: str | None = None) -> np.ndarray:
        """Global traffic matrix observed in the last run window (bytes)."""
        return self._last_tm.copy()

    def buffer_usage(self, node: int, port: int | None = None,
                     interval: str | None = None) -> int:
        if self._last_result is None:
            return 0
        return int(self._last_result.buf_bytes[:, node].max())

    def bw_usage(self, node: int, port: int | None = None,
                 interval: str | None = None) -> int:
        if self._last_result is None:
            return 0
        per_slice = self._last_result.delivered_bytes / max(self.n_nodes, 1)
        return int(per_slice.mean())

    # -- Execution -------------------------------------------------------------
    def run(self, wl: Workload, num_slices: int) -> SimResult:
        if self.schedule is None or self.routing is None:
            raise RuntimeError("deploy_topo and deploy_routing first")
        tables = FabricTables.build(self.schedule, self.routing)
        masks = ctrl = None
        # only windows a fault can touch pay the mask branches; their masks
        # are compiled at the net's clock
        if self.failure_trace.active_in(self._clock,
                                        self._clock + num_slices):
            masks = compile_masks(self.failure_trace, self.schedule,
                                  num_slices, t0=self._clock)
        if self.control_trace.active_in(self._clock,
                                        self._clock + num_slices):
            ctrl = compile_control(
                self.control_trace, num_slices, self.n_nodes,
                slice_ns=self.slice_us * 1000.0, t0=self._clock)
        res = simulate(tables, wl, self.fabric_cfg, num_slices,
                       failures=masks, control=ctrl, device=self.device)
        self._last_result = res
        self._last_workload = wl
        tm = np.zeros((self.n_nodes, self.n_nodes), dtype=np.float64)
        np.add.at(tm, (wl.src, wl.dst), wl.size.astype(np.float64))
        self._last_tm = tm
        self._clock += num_slices
        return res

    def run_ta(self, windows: list[Workload], window_slices: int,
               topo_fn, routing_fn) -> list[SimResult]:
        """The TA workflow loop (paper Fig. 4): per window, collect the TM,
        compute routes for the optimised topology, deploy routes *then*
        topology, and run. Undelivered packets re-enter the next window at
        their source (documented simplification; TA windows are long)."""
        results = []
        carry: Workload | None = None
        for wl in windows:
            if carry is not None:
                wl = _merge(carry, wl)
            tm = self.collect()
            sched = topo_fn(tm)
            self.deploy_routing(routing_fn(sched))
            self.deploy_topo(sched)
            res = self.run(wl, window_slices)
            results.append(res)
            undone = res.t_deliver < 0
            carry = _subset(wl, undone) if undone.any() else None
        return results


def _subset(wl: Workload, mask: np.ndarray) -> Workload:
    return Workload(**{f.name: getattr(wl, f.name)[mask]
                       for f in dataclasses.fields(Workload)})


def _merge(a: Workload, b: Workload) -> Workload:
    a = dataclasses.replace(a, t_inject=np.zeros_like(a.t_inject))
    return Workload(**{f.name: np.concatenate([getattr(a, f.name), getattr(b, f.name)])
                       for f in dataclasses.fields(Workload)})
