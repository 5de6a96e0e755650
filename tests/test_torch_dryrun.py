"""The port's dry run (``repro_torch.launch.dryrun``) and its cost model
(``repro_torch.launch.cost``) against the reference's
(``repro.launch.dryrun``, ``repro.launch.hlo.analyze_hlo``), on the CPU.

* ``CostMode`` on ``tests/test_hlo.py``'s programs: a plain matmul's
  FLOPs exactly the reference's; a loop of G matmuls (run G times, or once
  ``weighted(G)``) the reference's trip-count-weighted scan; bytes grow
  with size; ``roofline_terms`` picks the dominant term at the H100's
  rates.
* One smoke cell, ``olmo-1b`` reduced (with olmo's one KV head a query
  head kept: ``n_kv_heads=4``), as train and as prefill, on a (2, 4) fake
  mesh in a process of its own: per-device FLOPs within 20% of the
  reference's ``analyze_hlo`` of the same cell lowered on the (2, 4) mesh
  of its forced CPU devices; collective bytes are printed beside the
  reference's, not held (DTensor and GSPMD choose other collectives).
  The same process runs the CLI on a cell the reference skips and holds
  the collectives' byte rule on the fake group.
* The recurrent smoke cells, ``recurrentgemma-9b`` and ``xlstm-350m``
  reduced, as train and as prefill, the same way: the reference weights
  its scans' bodies by their trip counts, the port counts one pass of
  each loop weighted (``cost.passes``).
* ``cost.passes`` itself: the RG-LRU scan, the sLSTM's step loop and the
  mLSTM's chunk loop at a tiny L, counted on fake tensors (three passes,
  one weighted) and pass by pass on real tensors.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch.hlo import analyze_hlo  # noqa: E402
from repro_torch.launch import cost  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMOKE = dict(L=64, B=16, mesh=(2, 4))
FLOPS_TOL = 0.20


def test_plain_matmul_flops_equal_reference():
    M, K, N = 256, 512, 128
    a, b = torch.zeros(M, K), torch.zeros(K, N)
    _, st = cost.analyze(lambda: a @ b)
    ref = analyze_hlo(jax.jit(lambda x, y: x @ y).lower(
        jnp.zeros((M, K)), jnp.zeros((K, N))).compile().as_text())
    assert st.flops == 2 * M * K * N == ref.flops


def test_loop_of_matmuls_equals_trip_count_weighted_scan():
    G, M, K, N = 8, 64, 128, 32
    w = torch.zeros(G, K, N)
    x = torch.zeros(M, K)

    def loop():
        return sum((x @ w[i]).sum() for i in range(G))

    _, st = cost.analyze(loop)
    with cost.CostMode() as mode, mode.weighted(G):
        (x @ w[0]).sum()

    def f(x, w):
        _, ys = jax.lax.scan(lambda c, wi: (c, c @ wi), x, w)
        return ys.sum()

    ref = analyze_hlo(jax.jit(f).lower(jnp.zeros((M, K)), jnp.zeros(
        (G, K, N))).compile().as_text())
    assert st.flops == mode.stats().flops == 2.0 * G * M * K * N
    assert abs(st.flops - ref.flops) / ref.flops < 0.05, (st.flops, ref.flops)


def test_bytes_nonzero_and_scale_with_size():
    def run(n):
        a = torch.zeros(n)
        return cost.analyze(lambda: (a * 2).sum())[1].bytes

    s1, s2 = run(1 << 14), run(1 << 18)
    assert s1 > 0 and s2 > 4 * s1
    # a view moves nothing; a gather twice its result
    a = torch.zeros(64, 64)
    assert cost.analyze(lambda: a.t().unsqueeze(0)[:, 3:])[1].bytes == 0
    idx = torch.arange(8)
    assert cost.analyze(lambda: a[idx])[1].bytes == 2 * 8 * 64 * 4


def test_roofline_terms_pick_dominant_at_h100_rates():
    hw = cost.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_gb) == \
        (989e12, 3.35e12, 450e9, 80.0)
    t = cost.roofline_terms(989e12, 100e9, 0.0)     # 1 s compute
    assert t["dominant"] == "compute_s" and t["bound_s"] == 1.0
    t = cost.roofline_terms(1e12, 3.35e12 * 2, 0.0)
    assert t["dominant"] == "memory_s"
    t = cost.roofline_terms(1e10, 1e9, 450e9 * 3)
    assert t["dominant"] == "collective_s"
    assert set(t) == {"compute_s", "memory_s", "collective_s", "dominant",
                      "bound_s"}


_PORT = r"""
import json, sys, tempfile, os
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, cost
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.config import ShapeConfig
L, B, mesh = json.loads(sys.argv[1])
cfg = get_config("olmo-1b").reduced(n_kv_heads=4)
out = {}
for kind in ("train", "prefill"):
    out[kind] = dryrun.lower_cell(
        cfg, f"{kind}_smoke", False, shape=ShapeConfig(f"{kind}_smoke", L, B,
        kind), mesh_shape=MeshShape(("data", "model"), tuple(mesh)))
# the collectives' operand rule, on the live fake group
import torch
import torch.distributed._functional_collectives as fc
from torch._subclasses.fake_tensor import FakeTensorMode
with FakeTensorMode(), cost.CostMode() as m:
    x = torch.empty(8, 4)
    fc.wait_tensor(fc.all_gather_tensor(x, 0, list(range(8))))
    fc.wait_tensor(fc.reduce_scatter_tensor(x, "sum", 0, list(range(8))))
    fc.wait_tensor(fc.all_reduce(x, "sum", list(range(8))))
out["rule"] = m.stats().collectives_by_kind
with tempfile.TemporaryDirectory() as d:
    dryrun.main(["--arch", "olmo-1b", "--shape", "long_500k", "--out-dir", d])
    out["cli"] = json.load(open(os.path.join(d,
                                             "olmo-1b__long_500k__single.json")))
print("RESULT " + json.dumps(out))
"""


def _reference_cell(kind, arch=None):
    """The reference's ``lower_cell`` of a smoke cell (``olmo-1b`` with 4
    KV heads, or ``arch`` reduced) on a (2, 4) mesh of its forced CPU
    devices (its own ``lower_cell`` takes the production mesh and
    ``SHAPES`` only)."""
    from repro.configs import get_config
    from repro.distributed import sharding as R_S
    from repro.launch import steps as R_steps
    from repro.models.config import ShapeConfig
    cfg = get_config("olmo-1b").reduced(n_kv_heads=4) if arch is None \
        else get_config(arch).reduced()
    shape = ShapeConfig(f"{kind}_smoke", SMOKE["L"], SMOKE["B"], kind)
    n = int(np.prod(SMOKE["mesh"]))
    mesh = jax.make_mesh(SMOKE["mesh"], ("data", "model"),
                         devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    specs = R_steps.input_specs(cfg, shape)
    params_s, opt_s = R_steps.state_specs(cfg)
    p_sh = R_S.param_shardings(params_s, mesh, cfg)
    b_sh = R_S.batch_shardings(mesh, shape.global_batch)
    with jax.sharding.set_mesh(mesh):
        if kind == "train":
            step = R_steps.make_train_step(cfg, dp_axes=R_S.data_axes(mesh))
            o_sh = R_S.opt_state_shardings(p_sh, params_s)
            batch = {k: specs[k] for k in ("tokens", "labels")}
            low = jax.jit(step, in_shardings=(p_sh, o_sh, {
                k: b_sh[k] for k in batch}), out_shardings=(
                    p_sh, o_sh, None)).lower(params_s, opt_s, batch)
        else:
            step = R_steps.make_prefill_step(cfg)
            c_sh = R_S.cache_shardings(specs["cache"], mesh, cfg,
                                       shape.global_batch)
            low = jax.jit(step, in_shardings=(p_sh, {
                "tokens": b_sh["tokens"], "cache": c_sh}),
                out_shardings=(None, c_sh)).lower(params_s, dict(specs))
    return analyze_hlo(low.compile().as_text())


@pytest.fixture(scope="module")
def port_cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PORT,
         json.dumps([SMOKE["L"], SMOKE["B"], list(SMOKE["mesh"])])],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    assert out.returncode == 0 and lines, out.stderr[-3000:]
    return json.loads(lines[-1][len("RESULT "):])


@pytest.mark.multidevice
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_smoke_cell_flops_match_reference(port_cells, kind):
    if len(jax.devices()) < 8:
        pytest.skip("needs the forced 8-device CPU mesh")
    got = port_cells[kind]
    ref = _reference_cell(kind)
    flops = got["cost"]["flops_per_device"]
    ratio = flops / ref.flops
    print(f"{kind}: port FLOPs/device {flops:.6g}, reference {ref.flops:.6g}"
          f" (ratio {ratio:.4f}); bytes {got['cost']['bytes_per_device']:.6g}"
          f" vs {ref.bytes:.6g}; collectives "
          f"{got['cost']['collectives_by_kind']} vs "
          f"{ref.collectives_by_kind}")
    assert abs(ratio - 1.0) <= FLOPS_TOL, ratio
    assert got["n_devices"] == 8 and got["variant"] == "opt"
    assert got["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert got["cost"]["collective_bytes_per_device"] > 0


def test_collective_rule_and_cli_skip(port_cells):
    """All-gather counts its input (result / 8), reduce-scatter its input
    (result x 8), all-reduce its input: 4 x 8 float32 each. The CLI writes
    the reference's ``skipped`` for a full-attention model at long_500k."""
    assert port_cells["rule"] == {"all-gather": 128.0,
                                  "reduce-scatter": 128.0,
                                  "all-reduce": 128.0}
    cli = port_cells["cli"]
    assert cli["skipped"].startswith("full-attention arch")
    assert (cli["arch"], cli["shape"], cli["mesh"]) == \
        ("olmo-1b", "long_500k", "single")


_PORT_CELL = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.config import ShapeConfig
arch, kind, L, B, mesh = json.loads(sys.argv[1])
got = dryrun.lower_cell(
    get_config(arch).reduced(), f"{kind}_smoke", False,
    shape=ShapeConfig(f"{kind}_smoke", L, B, kind),
    mesh_shape=MeshShape(("data", "model"), tuple(mesh)))
print("RESULT " + json.dumps(got))
"""


@pytest.mark.multidevice
@pytest.mark.parametrize("arch,kind", [
    ("recurrentgemma-9b", "train"), ("recurrentgemma-9b", "prefill"),
    ("xlstm-350m", "train"), ("xlstm-350m", "prefill")])
def test_recurrent_smoke_cell_flops_match_reference(arch, kind):
    if len(jax.devices()) < 8:
        pytest.skip("needs the forced 8-device CPU mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PORT_CELL, json.dumps(
            [arch, kind, SMOKE["L"], SMOKE["B"], list(SMOKE["mesh"])])],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    assert out.returncode == 0 and lines, out.stderr[-3000:]
    got = json.loads(lines[-1][len("RESULT "):])
    ref = _reference_cell(kind, arch)
    ratio = got["cost"]["flops_per_device"] / ref.flops
    print(f"{arch} {kind}: port FLOPs/device "
          f"{got['cost']['flops_per_device']:.6g}, reference {ref.flops:.6g}"
          f" (ratio {ratio:.4f}); collectives "
          f"{got['cost']['collectives_by_kind']} vs {ref.collectives_by_kind}")
    assert abs(ratio - 1.0) <= FLOPS_TOL, ratio
    assert got["replicated_fallbacks"] == {}


def _loop_cost(kind: str, fake: bool, grad: bool):
    """The cost of one recurrent loop at B = 2, L = 12 (the mLSTM in
    chunks of 4): the scan, an sLSTM block or an mLSTM block of
    ``xlstm-350m`` reduced, forward only or with the gradients of its
    input and weights; on fake tensors or on real ones from seed 0."""
    import contextlib
    import dataclasses
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.kernels import rg_lru
    from repro_torch.models import layers as ly
    cfg = dataclasses.replace(get_config("xlstm-350m").reduced(),
                              mlstm_chunk=4)
    B, L = 2, 12
    with FakeTensorMode() if fake else contextlib.nullcontext():
        gen = torch.Generator().manual_seed(0)
        if kind == "scan":
            a, b = (torch.rand(B, L, 16, generator=gen).requires_grad_(grad)
                    for _ in range(2))
            leaves = [a, b]

            def fn():
                return rg_lru.RGLRUFn.apply(a, b) if grad else \
                    rg_lru.rg_lru(a, b)
        else:
            p = (ly.SLSTM if kind == "slstm" else ly.MLSTM)(cfg)
            for w in p.parameters():
                w.requires_grad_(False).copy_(torch.randn(
                    w.shape, generator=gen)).requires_grad_(grad)
            x = torch.randn(B, L, cfg.d_model, generator=gen) \
                .bfloat16().requires_grad_(grad)
            leaves = [x, *p.parameters()]
            apply = ly.slstm_apply if kind == "slstm" else ly.mlstm_apply

            def fn():
                return apply(p, x, cfg)[0]
        with cost.CostMode() as mode:
            out = fn()
            if grad:
                torch.autograd.grad(out.float().sum(), leaves)
    return mode.stats()


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "train"])
@pytest.mark.parametrize("kind", ["scan", "slstm", "mlstm"])
def test_weighted_loop_counts_equal_pass_by_pass(kind, grad):
    """On fakes a loop runs its first, second and last passes, the second
    weighted for the rest; pass by pass on real tensors it counts the same
    FLOPs and bytes. One exception: in the sLSTM's backward the engine adds
    up the gradient of the repeated middle output once for each of its
    uses where a pass-by-pass run adds each step's two parts (0.3% of the
    bytes here), so there the bytes are held within 1%."""
    fake = _loop_cost(kind, True, grad)
    real = _loop_cost(kind, False, grad)
    assert fake.flops == real.flops
    if kind == "slstm" and grad:
        assert abs(fake.bytes / real.bytes - 1.0) < 0.01
    else:
        assert fake.bytes == real.bytes
    assert (real.flops > 0) == (kind != "scan") and real.bytes > 0
