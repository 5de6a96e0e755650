"""The expert-parallel branch of the port's MoE layer
(``repro_torch.models.layers.moe_apply`` under a ``DeviceMesh``) against
the reference's (``repro.models.layers.moe_apply`` under
``jax.sharding.set_mesh``, its ``_moe_shard_map``), on the CPU.

The port runs on 2 and 4 gloo ranks spawned from the test (meshes (1, 2)
and (2, 2)), its inputs and weights DTensors placed by the port's
``param_shardings``; the reference on the same mesh shapes of its forced
CPU devices. ``qwen3-moe-30b-a3b`` reduced (4 experts top-2, d 64), the
same numpy weights and inputs on both sides: the output and the gradients
of ``sum(out * r)`` with respect to x and the three expert weights, in
float32 (within 1e-5 of the largest value) and bfloat16 (2e-2). Each
rank's grouped matmuls run over its own E / model experts. A float32
decode step (L = 1, outside the expert-parallel branch) on the same meshes
keeps float32 throughout, as the reference's does (1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as R_config  # noqa: E402
from repro.models import layers as R_layers  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import spawn  # noqa: E402
import torch_moe_ep_body  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
SHAPES = ((1, 2), (2, 2))
B, L = 4, 16
# case: (the port's dtype, the reference's, tolerance, tokens a row)
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5, L),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2, L),
          "float32-decode": (torch.float32, jnp.float32, 1e-5, 1)}


def _inputs(cfg, seed=0):
    """Weights (router, expert stacks) and x, r of one case: a router at a
    scale that spreads the tokens over the experts, so that some rows pass
    an expert's capacity and drop assignments."""
    rng = np.random.default_rng(seed)
    E, d, ff = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff
    w = dict(router=rng.normal(0, 0.5, (d, E)),
             w_gate=rng.normal(0, d ** -0.5, (E, d, ff)),
             w_up=rng.normal(0, d ** -0.5, (E, d, ff)),
             w_down=rng.normal(0, ff ** -0.5, (E, ff, d)))
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.normal(0, 1, (B, L, d)).astype(np.float32)
    r = rng.normal(0, 1, (B, L, d)).astype(np.float32)
    return w, x, r


def _reference(shape, dtype_name):
    """The reference's output and gradients on a mesh of ``shape``."""
    cfg = R_config(ARCH).reduced()
    w, x, r = _inputs(cfg)
    _, jdt, _, length = DTYPES[dtype_name]
    x, r = x[:, :length], r[:, :length]
    p = {k: jnp.asarray(v, jnp.float32 if k == "router" else jdt)
         for k, v in w.items()}
    # at decode the reference's global dispatch (``jnp.repeat``) runs only
    # on a mesh whose axes its partitioner shards (Auto)
    kinds = {} if length > 1 else dict(
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    mesh = jax.make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:shape[0] * shape[1]], **kinds)

    def loss(p, x):
        y = R_layers.moe_apply(p, x, cfg)
        return (y.astype(jnp.float32) * r).sum(), y

    with jax.sharding.set_mesh(mesh):
        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x, jdt))
    return [np.asarray(t, np.float32)
            for t in (y, gx, gp["w_gate"], gp["w_up"], gp["w_down"])]


@pytest.fixture(scope="module")
def port_runs():
    """Every case on each mesh shape: one spawned process group a shape."""
    cfg = get_config(ARCH).reduced()
    w, x, r = _inputs(cfg)
    cases = [(w, x[:, :n], r[:, :n], dt) for dt, _, _, n in DTYPES.values()]
    return {shape: spawn.run_ranks(torch_moe_ep_body.ep_cases,
                                   (cfg, shape, cases), shape[0] * shape[1],
                                   "gloo", "cpu", timeout=600)
            for shape in SHAPES}


@pytest.mark.multidevice
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_expert_parallel_matches_reference(port_runs, shape, dtype_name):
    if len(jax.devices()) < shape[0] * shape[1]:
        pytest.skip("needs the forced 8-device CPU mesh")
    got_all, groups = port_runs[shape]
    got = got_all[list(DTYPES).index(dtype_name)]
    want = _reference(shape, dtype_name)
    tol = DTYPES[dtype_name][2]
    for name, g, w in zip(("out", "dx", "dw_gate", "dw_up", "dw_down"), got,
                          want):
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        err = float(np.abs(g - w).max() / np.abs(w).max())
        assert err <= tol, (name, err)
    # rank 0 ran every grouped matmul over its E / model experts
    E = get_config(ARCH).reduced().moe.num_experts
    assert groups and set(groups) == {E // shape[1]}, groups

