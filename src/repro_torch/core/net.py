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

The net runs on CUDA unless built with ``device="cpu"``. The reference's
failure, control-plane, telemetry and clocked-service APIs are not ported
yet (ROADMAP Queue 1 items 4 and 5).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import routing as routing_mod
from .fabric import (FabricConfig, FabricTables, SimResult, Workload,
                     resolve_device, simulate)
from .routing import CompiledRouting
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
        if config.get("telemetry") is not None:
            raise NotImplementedError(
                "telemetry is not ported to repro_torch yet "
                "(ROADMAP Queue 1 item 4)")
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
        res = simulate(tables, wl, self.fabric_cfg, num_slices,
                       device=self.device)
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
