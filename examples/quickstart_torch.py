"""OpenOptics quickstart on the PyTorch port — paper Fig. 5a in ~20 lines.

The same program as ``examples/quickstart.py`` (a RotorNet-style round-robin
schedule + VLB routing, a KV-store-like workload, flow-completion
statistics), with the data plane running through ``repro_torch`` on a CUDA
card, or on the CPU with ``--device cpu``. It prints the same five lines.

    python examples/quickstart_torch.py [--device cuda|cpu]
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (OpenOpticsNet, flow_fcts, round_robin,  # noqa: E402
                              synthesize, vlb)

N_TORS, SLICE_US = 16, 10.0
SLICE_BYTES = int(100 / 8 * 1e3 * SLICE_US)  # 100 Gbps circuits


def main(device: str) -> None:
    net = OpenOpticsNet(dict(node="rack", node_num=N_TORS, uplink=1,
                             slice_us=SLICE_US,
                             fabric=dict(slice_bytes=SLICE_BYTES)),
                        device=device)

    sched = round_robin(N_TORS, n_uplinks=1, slice_us=SLICE_US)   # TO schedule
    net.deploy_topo(sched)                                        # Table-1 API
    net.deploy_routing(vlb(sched), LOOKUP="hop", MULTIPATH="packet")

    wl = synthesize("kvstore", N_TORS, num_slices=300, slice_bytes=SLICE_BYTES,
                    load=0.3, max_packets=8000, seed=0)
    res = net.run(wl, num_slices=600)

    fct = flow_fcts(wl, res.t_deliver, SLICE_US)
    print(f"packets delivered : {(res.t_deliver >= 0).mean():.1%}")
    print(f"flow FCT p50/p99  : {np.percentile(fct, 50):.0f} / "
          f"{np.percentile(fct, 99):.0f} us")
    print(f"reorder events    : {int(res.reorder_cnt)}")
    print(f"max switch buffer : {res.buf_bytes.max() / 1e6:.2f} MB")
    print(f"traffic matrix sum: {net.collect().sum() / 1e6:.1f} MB")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the data plane (default: cuda)")
    main(ap.parse_args().device)
