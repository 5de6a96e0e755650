"""What the ranks of ``tests/test_torch_sharded.py`` run: several sharded
cases in one process group (a group costs seconds to spawn), the
collectives on their own, and a rank that fails. Imports only the port
(the ranks never import JAX)."""
import numpy as np
import torch

import repro_torch.core as Q
from repro_torch.distributed import collectives as C


def run_cases(cases, probe_collectives=False):
    """``simulate_shard`` of each ``(tables, wl, cfg, slices, failures,
    control, telemetry)`` on this rank, with the debug dict; with
    ``probe_collectives`` also the collectives' results on fixed inputs
    (see ``collectives_probe``)."""
    out = [Q.simulate_shard(*case, with_debug=True, device="cpu")
           for case in cases]
    return out, collectives_probe() if probe_collectives else None


def collectives_probe():
    """Each collective on inputs that depend on the rank, gathered into
    one dict (every rank returns the same)."""
    import torch.distributed as dist
    r, d = dist.get_rank(), dist.get_world_size()
    local = torch.arange(5, dtype=torch.int32) * (r + 1) + r
    got = dict(
        offsets=C.shard_group_offsets(local),
        sum=C.exchange_sum(local.clone()),
        min=C.exchange_min(local.clone() - 3 * r),
        max=C.exchange_max(local.clone() - 3 * r),
        row=C.gather_node_row(torch.tensor([r * 10, r * 10 + 1],
                                           dtype=torch.int32), 2 * d - 1),
        rows=C.gather_node_row(torch.tensor([[r % 2 == 0, True]] * 3),
                               2 * d - 1, axis=1))
    # every rank's offsets, to show each is its own prefix
    got["all_offsets"] = C.gather_node_row(got["offsets"][None], d)
    return {k: v.numpy() for k, v in got.items()}


def fail_on_rank(rank, shards):
    """Raise on ``rank``; the other ranks wait in a collective."""
    import torch.distributed as dist
    if dist.get_rank() == rank:
        raise RuntimeError(f"planted failure on rank {rank}")
    C.exchange_sum(torch.zeros(1, dtype=torch.int32))
    return np.zeros(1)
