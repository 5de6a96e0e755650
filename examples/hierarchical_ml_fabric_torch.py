"""Paper §4.3 Fig. 5d on the PyTorch port: the hierarchical TA + TO design
for ML workloads (the counterpart of ``examples/hierarchical_ml_fabric.py``,
on the port's collective planner).

Scale-up (intra-pod): a traffic-oblivious rotor fabric. Scale-out
(inter-pod): the gradient all-reduce planned against the optical
schedule, an oblivious rotor against a controller-deployed ring, with and
without int8 gradient compression. Host arithmetic only: no card needed.

    python examples/hierarchical_ml_fabric_torch.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import (PodFabric, allreduce_time_s,  # noqa: E402
                                     plan_ring_allreduce)
from repro_torch.models import count_params  # noqa: E402
from repro_torch.optim import CompressionConfig  # noqa: E402

fabric = PodFabric(n_pods=8, link_gbps=400.0, slice_us=100.0, reconf_us=10.0)

print(f"{'arch':26s} {'grads':>8s} {'rotor':>9s} {'aligned':>9s} {'+int8':>9s}")
for arch in ("olmo-1b", "gemma2-9b", "qwen3-moe-30b-a3b"):
    n = count_params(get_config(arch))
    gbytes = n * 4  # f32 wire gradients
    t_rotor = allreduce_time_s(gbytes, fabric, aligned=False)
    t_ring = allreduce_time_s(gbytes, fabric, aligned=True)
    t_int8 = allreduce_time_s(gbytes, fabric, aligned=True,
                              compression=CompressionConfig("int8"))
    print(f"{arch:26s} {gbytes/2**30:6.1f}GB {t_rotor*1e3:7.1f}ms "
          f"{t_ring*1e3:7.1f}ms {t_int8*1e3:7.1f}ms")

plan = plan_ring_allreduce(1 << 30, fabric, aligned=True)
print(f"\nring all-reduce plan for 1 GiB: {len(plan.transfers)} transfers over "
      f"{plan.total_slices} slices "
      f"({plan.time_s(fabric)*1e3:.1f} ms; every transfer rides a live circuit)")
