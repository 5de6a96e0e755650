"""Paper §6 Case I on the PyTorch port: six optical DCN architectures (+
UCMP on RotorNet) side by side on identical traffic, the study OpenOptics
exists to enable.

The program of ``examples/architecture_comparison.py`` (fig8's testbed
analogue: 8 ToRs, 10 us slices, 700 slices, Memcached-like mice beside
bulk elephants; each architecture built through the user API as paper
Fig. 5 does), through ``repro_torch`` on a CUDA card, or on the CPU with
``--device cpu``. It prints the reference's table: mice FCT p50 and p99,
elephant FCT p50. ``build_arch`` and the workload are this
file's own copies of ``benchmarks/common.py`` and ``benchmarks/
fig8_fct.py`` (which import the JAX package).

    python examples/architecture_comparison_torch.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (OpenOpticsNet, Workload, bvn,  # noqa: E402
                              clos_routing, direct, edmonds, flow_fcts,
                              jupiter, opera, round_robin, synthesize, ucmp,
                              vlb, wcmp)

ARCHS = ["clos", "c-through", "jupiter", "mordia", "rotornet", "opera",
         "rotornet-ucmp"]
N, SLICE_US, SLICES = 8, 10.0, 700
LINK_GBPS = 100.0


def slice_bytes(slice_us: float, gbps: float = LINK_GBPS) -> int:
    return int(gbps / 8 * 1e3 * slice_us)


def build_arch(name: str, n_nodes: int, slice_us: float = 10.0,
               tm: np.ndarray | None = None, device=None) -> OpenOpticsNet:
    """One of the paper's six architectures (+ RotorNet-UCMP) as a net on
    ``device`` (CUDA by default)."""
    sb = slice_bytes(slice_us)
    fab = dict(slice_bytes=sb, cc_detect=True)
    if tm is None:
        tm = np.ones((n_nodes, n_nodes)) - np.eye(n_nodes)

    def net_of(uplink):
        return OpenOpticsNet(dict(node="rack", node_num=n_nodes,
                                  uplink=uplink, slice_us=slice_us,
                                  fabric=fab), device=device)

    if name == "clos":
        fab.update(slice_bytes=0, elec_bytes=sb)
        net = net_of(1)
        net.deploy_topo(round_robin(n_nodes, 1, slice_us=slice_us))
        net.deploy_routing(clos_routing(n_nodes))
    elif name == "c-through":
        # hybrid: elephants over Edmonds-matched circuits (flow pausing),
        # mice over the rate-limited electrical fabric (paper: 10 Gbps)
        fab.update(elec_bytes=slice_bytes(slice_us, 10.0), flow_pausing=True)
        net = net_of(1)
        net.deploy_topo(edmonds(tm, slice_us=slice_us))
        net.deploy_routing(clos_routing(n_nodes))
    elif name == "jupiter":
        net = net_of(4)
        sched = jupiter(tm, n_nodes=n_nodes, n_uplinks=4, max_moves=16,
                        slice_us=slice_us)
        net.deploy_topo(sched)
        net.deploy_routing(wcmp(sched))
    elif name == "mordia":
        net = net_of(1)
        sched = bvn(tm, max_perms=2 * n_nodes, slice_us=slice_us)
        net.deploy_topo(sched)
        net.deploy_routing(direct(sched))
    elif name in ("rotornet", "rotornet-ucmp"):
        net = net_of(1)
        sched = round_robin(n_nodes, 1, slice_us=slice_us)
        net.deploy_topo(sched)
        net.deploy_routing((vlb if name == "rotornet" else ucmp)(sched))
    elif name == "opera":
        net = net_of(2)
        sched = round_robin(n_nodes, 2, slice_us=slice_us)
        net.deploy_topo(sched)
        net.deploy_routing(opera(sched))
    else:
        raise ValueError(name)
    return net


def traffic_tm(wl: Workload, n_nodes: int) -> np.ndarray:
    tm = np.zeros((n_nodes, n_nodes))
    np.add.at(tm, (wl.src, wl.dst), wl.size.astype(np.float64))
    return tm


def fig8_workload(seed: int = 0) -> tuple[Workload, int]:
    """fig8's two traffic classes: KV-store mice and Hadoop elephants,
    merged with distinct flow-id spaces. Returns the workload and the
    number of mice flows (flow ids below it are mice)."""
    sb = slice_bytes(SLICE_US)
    mice = synthesize("kvstore", N, 400, slice_bytes=sb, load=0.1,
                      max_packets=4000, elephant_bytes=1 << 30, seed=seed)
    eleph = synthesize("hadoop", N, 400, slice_bytes=sb, load=0.25,
                       max_packets=6000, elephant_bytes=0, seed=seed + 1)
    off = mice.num_flows
    return Workload(
        src=np.concatenate([mice.src, eleph.src]),
        dst=np.concatenate([mice.dst, eleph.dst]),
        size=np.concatenate([mice.size, eleph.size]),
        t_inject=np.concatenate([mice.t_inject, eleph.t_inject]),
        flow=np.concatenate([mice.flow, eleph.flow + off]),
        seq=np.concatenate([mice.seq, eleph.seq]),
        is_eleph=np.concatenate([np.zeros(mice.num_packets, bool),
                                 np.ones(eleph.num_packets, bool)]),
    ), off


def fct_row(wl: Workload, t_deliver: np.ndarray, n_mice: int,
            slice_us: float = SLICE_US) -> tuple[float, float, float]:
    """(mice FCT p50, mice FCT p99, elephant FCT p50) in microseconds."""
    mice = np.zeros(wl.num_flows, bool)
    mice[:n_mice] = True
    fm = flow_fcts(wl, t_deliver, slice_us, only=mice)
    fe = flow_fcts(wl, t_deliver, slice_us, only=~mice)
    return (float(np.median(fm)), float(np.percentile(fm, 99)),
            float(np.median(fe)))


def main(device: str) -> None:
    wl, n_mice = fig8_workload()
    tm = traffic_tm(wl, N)
    print(f"{'architecture':16s} {'mice p50':>9s} {'mice p99':>9s} "
          f"{'eleph p50':>10s}")
    for name in ARCHS:
        res = build_arch(name, N, SLICE_US, tm=tm, device=device).run(
            wl, SLICES)
        m50, m99, e50 = fct_row(wl, res.t_deliver, n_mice)
        print(f"{name:16s} {m50:8.0f}us {m99:8.0f}us {e50:9.0f}us")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the data plane (default: cuda)")
    main(ap.parse_args().device)
