"""What the ranks of ``tests/test_torch_moe_ep.py`` run: the port's MoE
layer on a ``DeviceMesh`` of the spawned process group, its inputs and
weights DTensors placed by the port's sharding rules, forward and
gradient. Imports only the port (the ranks never import JAX)."""
import numpy as np
import torch


def ep_cases(cfg, mesh_shape, cases):
    """Each case ``(weights, x, r, dtype)``: the MoE of ``cfg`` with the
    numpy ``weights`` (router, w_gate, w_up, w_down) in ``dtype`` (the
    router in float32), on x [B, L, d] sharded over the data axes, its
    experts placed by ``param_shardings``; returns per case the output and
    the gradients of ``sum(out * r)`` with respect to x and the three
    expert weights, each gathered whole, as float32 numpy, and the group
    counts of the grouped matmuls this rank ran."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as ly
    from repro_torch.models import stacks

    mesh = make_mesh(mesh_shape, ("data", "model"))
    params = stacks.Stack(cfg, torch.device("meta"))
    specs = sharding.param_shardings(params, mesh, cfg)
    name = next(n for n in specs if n.endswith("moe.w_gate"))[:-len("w_gate")]
    dp = sharding.data_axes(mesh)
    out, groups = [], []
    gmm = ly._gmm_apply

    def counted(x, w):
        groups.append(int(x.shape[0]))
        return gmm(x, w)

    ly._gmm_apply = counted
    for weights, x, r, dtype in cases:
        moe = ly.MoE(cfg, torch.device("cpu"))
        for k, v in weights.items():
            full = torch.tensor(v, dtype=torch.float32 if k == "router"
                                else dtype)
            pl = sharding.placements(specs[name + k], mesh)
            t = _distribute(full, mesh, pl).requires_grad_(True)
            setattr(moe, k, torch.nn.Parameter(t))
        xt = _distribute(torch.tensor(x, dtype=dtype), mesh,
                         sharding.placements((dp, None, None), mesh))
        xt.requires_grad_(True)
        y = ly.moe_apply(moe, xt, cfg)
        assert isinstance(y, DTensor)
        loss = (y.float() * _distribute(torch.tensor(r), mesh,
                                        [Replicate()] * 2)).sum()
        gx, gg, gu, gd = torch.autograd.grad(
            loss, [xt, moe.w_gate, moe.w_up, moe.w_down])
        out.append([t.detach().full_tensor().float().numpy()
                    for t in (y, gx, gg, gu, gd)])
        assert isinstance(moe.w_gate, DTensor) and \
            moe.w_gate.placements[1] == Shard(0)
    ly._gmm_apply = gmm
    return out, groups


def _distribute(full, mesh, placements):
    """A DTensor of ``full`` (the same on every rank) placed by
    ``placements``: each rank keeps its own chunk, nothing is sent."""
    from torch.distributed.tensor import DTensor, Replicate
    t = DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim,
                           run_check=False)
    return t.redistribute(mesh, placements).detach()
