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

    net.ingest(batch)                           # or as a clocked service:
    net.advance(16)                             # 16 slices, state carried
    frame = net.snapshot()                      # packets, bytes, counters

The net runs on CUDA unless built with ``device="cpu"``. Faults injected
with :meth:`OpenOpticsNet.inject_failure` / :meth:`~OpenOpticsNet.inject_control`
apply to the :meth:`~OpenOpticsNet.run` and :meth:`~OpenOpticsNet.advance`
windows they touch. The clocked service (:meth:`~OpenOpticsNet.ingest`,
:meth:`~OpenOpticsNet.advance`, :meth:`~OpenOpticsNet.snapshot`,
:meth:`~OpenOpticsNet.service_result`) runs on
:func:`repro_torch.core.fabric.step_slices` and counts with the net's
telemetry config; :meth:`~OpenOpticsNet.run` does not count, as in the
reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import fabric as fabric_mod
from . import routing as routing_mod
from .controlplane import ControlTrace, compile_control
from .fabric import (FabricConfig, FabricState, FabricTables, SimResult,
                     Workload, resolve_device, simulate)
from .failures import FailureTrace, compile_masks
from .routing import CompiledRouting
from .telemetry import TELE_KEYS, TelemetryConfig
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
        self._clock = 0  # slices elapsed across run() / advance() windows
        self.failure_trace = FailureTrace()
        self.control_trace = ControlTrace()
        tele = config.get("telemetry", None)
        if isinstance(tele, dict):
            tele = TelemetryConfig(**tele)
        # the clocked service counts with it; run() does not, as in the
        # reference
        self.telemetry: TelemetryConfig | None = tele
        self._service: FabricState | None = None

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
    def _window_masks(self, num_slices: int):
        """The failure and control masks of the window of ``num_slices``
        slices from the net's clock; ``None`` for a trace that does not
        touch it, so only windows a fault can touch pay the mask
        branches."""
        t0, t1 = self._clock, self._clock + num_slices
        masks = ctrl = None
        if self.failure_trace.active_in(t0, t1):
            masks = compile_masks(self.failure_trace, self.schedule,
                                  num_slices, t0=t0)
        if self.control_trace.active_in(t0, t1):
            ctrl = compile_control(
                self.control_trace, num_slices, self.n_nodes,
                slice_ns=self.slice_us * 1000.0, t0=t0)
        return masks, ctrl

    def run(self, wl: Workload, num_slices: int) -> SimResult:
        if self.schedule is None or self.routing is None:
            raise RuntimeError("deploy_topo and deploy_routing first")
        tables = FabricTables.build(self.schedule, self.routing)
        masks, ctrl = self._window_masks(num_slices)
        res = simulate(tables, wl, self.fabric_cfg, num_slices,
                       failures=masks, control=ctrl, device=self.device)
        self._last_result = res
        self._last_workload = wl
        tm = np.zeros((self.n_nodes, self.n_nodes), dtype=np.float64)
        np.add.at(tm, (wl.src, wl.dst), wl.size.astype(np.float64))
        self._last_tm = tm
        self._clock += num_slices
        return res

    # -- Clocked service: a long-lived fabric, advanced window by window ------
    def _service_state(self) -> FabricState:
        if self._service is None:
            if self.schedule is None or self.routing is None:
                raise RuntimeError("deploy_topo and deploy_routing first")
            tables = FabricTables.build(self.schedule, self.routing)
            self._service = fabric_mod.init_state(
                tables, None, self.fabric_cfg, self.telemetry,
                device=self.device)
            self._service.clock = self._clock
        return self._service

    def ingest(self, wl: Workload) -> bool:
        """Join demand to the live fabric (Table-1 service style).

        ``wl.t_inject`` is relative to the net's clock: slice 0 is the
        first slice of the next :meth:`advance`. Flow ids are offset past
        every flow ingested so far, so each batch tracks its own in-order
        sequences. Each ingest copies the packet arrays once, so batches
        beat single packets."""
        fs = self._service_state()
        if wl.num_packets == 0:
            return True
        wl = dataclasses.replace(
            wl, t_inject=wl.t_inject + np.int32(self._clock),
            flow=wl.flow + np.int32(fs.num_flows))
        fabric_mod.ingest(fs, wl)
        return True

    def advance(self, num_slices: int) -> bool:
        """Advance the live fabric ``num_slices`` slices. Faults injected
        with :meth:`inject_failure` / :meth:`inject_control` apply as in
        :meth:`run`; packets in flight, queue occupancy and counters carry
        across calls, and :meth:`snapshot` reads them without stopping the
        fabric."""
        fs = self._service_state()
        n = int(num_slices)
        if n <= 0:
            raise ValueError(f"num_slices must be positive, got {num_slices}")
        masks, ctrl = self._window_masks(n)
        fabric_mod.step_slices(fs, n, failures=masks, control=ctrl)
        self._clock = fs.clock
        return True

    def snapshot(self) -> dict:
        """A host-side frame of the live fabric, without stopping it: the
        service clock, packets and bytes by stage of their life, and (when
        the net was built with a ``telemetry`` config) the per-ToR counters
        summed over the windows run and the delivery-latency histogram.
        ``in_flight`` includes electrical deliveries landing past the
        clock; ``pending`` packets have not injected yet."""
        fs = self._service
        frame = {"clock": self._clock,
                 "packets": {}, "bytes": {}, "counters": None}
        if fs is None:
            zero = dict(total=0, pending=0, in_flight=0, delivered=0,
                        dropped=0)
            frame["packets"] = dict(zero)
            frame["bytes"] = dict(zero)
            return frame
        loc = fs.state["loc"].cpu().numpy()
        t_del = fs.state["t_del"].cpu().numpy()
        size = fs.j["size"].cpu().numpy().astype(np.int64)
        NI, DL, DR = (fabric_mod.NOT_INJECTED, fabric_mod.DELIVERED,
                      fabric_mod.DROPPED)
        groups = dict(
            pending=loc == NI,
            in_flight=(loc >= 0) | ((loc == DL) & (t_del >= fs.clock)),
            delivered=(loc == DL) & (t_del < fs.clock),
            dropped=loc == DR)
        frame["packets"] = {"total": int(loc.size)} | {
            k: int(m.sum()) for k, m in groups.items()}
        frame["bytes"] = {"total": int(size.sum())} | {
            k: int(size[m].sum()) for k, m in groups.items()}
        if fs.telemetry is not None and fs.chunks:
            rows = {k: np.concatenate([c[k] for c in fs.chunks])
                    for k in TELE_KEYS}
            frame["counters"] = {
                "injected_bytes": rows["tele_injected"].sum(0),
                "delivered_bytes": rows["tele_delivered"].sum(0),
                "deferred_bytes": rows["tele_deferred"].sum(0),
                "dropped_bytes": rows["tele_dropped"].sum(0),
                "queue_hwm": rows["tele_qhwm"].max(0),
                "util_used": rows["tele_util_used"].sum(0),
                "util_cap": rows["tele_util_cap"].sum(0),
                "lat_hist": rows["tele_lat_hist"].sum(0),
                "lat_edges": fs.telemetry.lat_edges,
            }
        return frame

    def service_result(self) -> SimResult:
        """The live fabric as a :class:`SimResult` so far; the service
        keeps running (:func:`repro_torch.core.fabric.finalize`)."""
        return fabric_mod.finalize(self._service_state())

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
