"""OpenOptics core in PyTorch: the port of ``repro.core``'s main path.

Control plane (host numpy, copied from the reference): topology
(schedules), routing (time-flow table compilation), traces (synthetic
workloads). Data plane (PyTorch on one device): fabric (calendar queues,
congestion detection, push-back, offloading) and net (the user API).
"""
from .topology import (Circuit, Schedule, connect, round_robin, uniform_mesh,
                       circuits_to_conn, conn_to_circuits, deploy_topo_check)
from .routing import (CompiledRouting, direct, vlb, opera, ucmp, hoho, ecmp,
                      wcmp, ksp, neighbors, earliest_path, add_entry,
                      first_direct_offsets)
from .fabric import (FabricConfig, FabricTables, Workload, SimResult,
                     simulate, tables_from_arrays, workload_from_arrays)
from .net import OpenOpticsNet, clos_routing
from .traces import synthesize, flow_fcts, TRACES

__all__ = [
    "Circuit", "Schedule", "connect", "round_robin", "uniform_mesh",
    "circuits_to_conn", "conn_to_circuits", "deploy_topo_check",
    "CompiledRouting", "direct", "vlb", "opera", "ucmp", "hoho", "ecmp",
    "wcmp", "ksp", "neighbors", "earliest_path", "add_entry",
    "first_direct_offsets",
    "FabricConfig", "FabricTables", "Workload", "SimResult", "simulate",
    "tables_from_arrays", "workload_from_arrays",
    "OpenOpticsNet", "clos_routing",
    "synthesize", "flow_fcts", "TRACES",
]
