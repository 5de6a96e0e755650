"""OpenOptics core in PyTorch: the port of ``repro.core``'s main path.

Control plane (host numpy, copied from the reference): topology
(schedules, with the traffic-matrix schedulers' matchings in matching),
routing (time-flow table compilation), timeflow (entry-level time-flow
tables), traces (synthetic workloads), failures (fault traces and their
masks, table repair, fast reroute), controlplane (clock skew, install
delay and loss, controller stalls), guardband (the §7 minimum-slice
derivation), eqo (the queue-occupancy estimator of Fig. 12, on
the device, with its own JAX-compatible threefry in prng), toolkit (packet traces and table, telemetry and sharding
checkers). Data plane (PyTorch on one device): fabric (calendar queues,
congestion detection, push-back, offloading, failure and control masks,
telemetry counters, one-shot and incremental runs, scenario sweeps,
runs sharded over ``torch.distributed`` ranks, phased table swaps,
versioned tables), net (the user API, run or as a clocked service), and
the traffic-aware reconfigure loop (reconfigure, and reconfigure_fleet
over a sweep of scenarios) with its device-side routing compiler
(routing_jnp) and demand schedulers (topology_jnp).
"""
from .topology import (Circuit, Schedule, connect, round_robin, edmonds, bvn,
                       jupiter, sorn, uniform_mesh, circuits_to_conn,
                       conn_to_circuits, deploy_topo_check)
from .routing import (CompiledRouting, direct, vlb, opera, ucmp, hoho, ecmp,
                      wcmp, ksp, neighbors, earliest_path, add_entry,
                      first_direct_offsets)
from .timeflow import Entry, TimeFlowTable
from .fabric import (FabricConfig, FabricState, FabricTables, Workload,
                     SimResult, simulate, simulate_fleet,
                     simulate_sharded, simulate_shard, simulate_incremental, init_state,
                     ingest, step_slices, finalize, tables_from_arrays,
                     workload_from_arrays)
from .telemetry import TelemetryConfig, TelemetryCounters
from .net import OpenOpticsNet, clos_routing
from .reconfigure import (ReconfigConfig, ReconfigResult, reconfigure,
                          reconfigure_fleet)
from .failures import (FailureEvent, FailureTrace, FailureMasks,
                       compile_masks, random_trace, repair, surviving_conn,
                       backup_tables, backup_tables_dp, fast_reroute,
                       simulate_phased)
from .controlplane import (ControlEvent, ControlTrace, ControlMasks,
                           compile_control, random_control_trace,
                           install_schedule)
from .traces import synthesize, flow_fcts, TRACES
from .guardband import GuardbandInputs, derive as derive_guardband
from .eqo import simulate_eqo
from . import routing_jnp, toolkit, topology_jnp

__all__ = [
    "Circuit", "Schedule", "connect", "round_robin", "edmonds", "bvn",
    "jupiter", "sorn", "uniform_mesh",
    "circuits_to_conn", "conn_to_circuits", "deploy_topo_check",
    "CompiledRouting", "direct", "vlb", "opera", "ucmp", "hoho", "ecmp",
    "wcmp", "ksp", "neighbors", "earliest_path", "add_entry",
    "first_direct_offsets", "Entry", "TimeFlowTable",
    "FabricConfig", "FabricState", "FabricTables", "Workload", "SimResult",
    "simulate", "simulate_fleet", "simulate_sharded", "simulate_shard",
    "simulate_incremental", "init_state",
    "ingest",
    "step_slices", "finalize", "tables_from_arrays", "workload_from_arrays",
    "TelemetryConfig", "TelemetryCounters",
    "OpenOpticsNet", "clos_routing",
    "ReconfigConfig", "ReconfigResult", "reconfigure", "reconfigure_fleet",
    "FailureEvent", "FailureTrace", "FailureMasks", "compile_masks",
    "random_trace", "repair", "surviving_conn", "backup_tables",
    "backup_tables_dp", "fast_reroute", "simulate_phased",
    "ControlEvent", "ControlTrace", "ControlMasks", "compile_control",
    "random_control_trace", "install_schedule",
    "synthesize", "flow_fcts", "TRACES",
    "GuardbandInputs", "derive_guardband", "simulate_eqo", "toolkit", "routing_jnp",
    "topology_jnp",
]
