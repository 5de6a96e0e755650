"""The port's optimizer, compression, data pipeline, collective planner and
elastic policies on the CPU, held against ``repro.optim``, ``repro.data``,
``repro.distributed.collectives`` and ``repro.elastic``.

The counterparts of ``tests/test_optim.py`` and of the planner and elastic
tests of ``tests/test_distributed.py`` run on the port; beside them the
same inputs (made with numpy) go through both packages: AdamW's state
within 1e-6 (float32 arithmetic in the same order up to the sum of the
global norm), schedules, compression payloads, plans, times, remesh and
straggler decisions and the synthetic batches equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import data as R_data  # noqa: E402
from repro import distributed as R_dist  # noqa: E402
from repro import elastic as R_el  # noqa: E402
from repro import optim as R_opt  # noqa: E402
from repro_torch import data as Q_data  # noqa: E402
from repro_torch import distributed as Q_dist  # noqa: E402
from repro_torch import elastic as Q_el  # noqa: E402
from repro_torch import optim as Q_opt  # noqa: E402
from repro_torch.core import deploy_topo_check  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402, F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ---------------------------------------------------------------------------
# the counterparts of tests/test_optim.py
# ---------------------------------------------------------------------------

def test_adamw_decreases_quadratic():
    cfg = Q_opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                            total_steps=100)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = Q_opt.adamw_init(params)
    l0 = float((params["w"] ** 2).sum())
    for _ in range(50):
        params, state, _ = Q_opt.adamw_update({"w": 2 * params["w"]}, state,
                                              params, cfg)
    assert float((params["w"] ** 2).sum()) < 0.1 * l0


def test_clip_by_global_norm():
    clipped, n = Q_opt.clip_by_global_norm({"a": torch.ones(4) * 10.0}, 1.0)
    assert float(Q_opt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    assert float(n) == pytest.approx(20.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clip_idempotent_under_limit(seed):
    x = torch.tensor(np.random.default_rng(seed).normal(size=6) * 0.01,
                     dtype=torch.float32)
    clipped, _ = Q_opt.clip_by_global_norm({"x": x}, 10.0)
    torch.testing.assert_close(clipped["x"], x, rtol=1e-6, atol=0)


def test_cosine_schedule_shape():
    cfg = Q_opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(Q_opt.cosine_schedule(cfg, 0)) == 0.0
    assert float(Q_opt.cosine_schedule(cfg, 10)) == pytest.approx(1.0, rel=1e-3)
    assert float(Q_opt.cosine_schedule(cfg, 100)) == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("kind", ["cosine", "linear"])
def test_schedules_match_reference(kind):
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=50)
    rf = getattr(R_opt, f"{kind}_schedule")
    qf = getattr(Q_opt, f"{kind}_schedule")
    for step in (0, 1, 6, 7, 8, 30, 49, 50, 60):
        want = float(rf(R_opt.AdamWConfig(**cfg), jnp.int32(step)))
        got = float(qf(Q_opt.AdamWConfig(**cfg),
                       torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_accumulation_equals_full_batch():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(8, 4)), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=8), dtype=torch.float32)
    w = torch.zeros(4, requires_grad=True)
    loss = lambda xx, yy: ((xx @ w - yy) ** 2).mean()
    full = torch.autograd.grad(loss(x, y), w)[0]
    acc = Q_opt.accum_init({"w": w.detach()})
    for i in range(4):
        g = torch.autograd.grad(loss(x[2 * i:2 * i + 2], y[2 * i:2 * i + 2]),
                                w)[0]
        acc = Q_opt.accum_add(acc, {"w": g})
    acc = Q_opt.accum_finalize(acc, 4)
    torch.testing.assert_close(acc["w"], full, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_error_feedback_converges(kind):
    """With error feedback the mean applied update converges to the true
    gradient (EF-SGD)."""
    cfg = Q_opt.CompressionConfig(kind=kind, topk_frac=0.25)
    g_true = torch.tensor(np.random.default_rng(0).normal(size=64),
                          dtype=torch.float32)
    err, applied = torch.zeros(64), torch.zeros(64)
    for _ in range(50):
        out, err = Q_opt.ef_roundtrip(g_true, err, cfg)
        applied = applied + out
    rel = float(torch.linalg.norm(applied / 50 - g_true)
                / torch.linalg.norm(g_true))
    assert rel < 0.05, rel


def test_int8_quantization_error_bounded():
    x = torch.tensor(np.random.default_rng(1).normal(size=128) * 5,
                     dtype=torch.float32)
    out, _ = Q_opt.ef_roundtrip(x, torch.zeros_like(x),
                                Q_opt.CompressionConfig(kind="int8"))
    scale = float(x.abs().max()) / 127
    assert float((out - x).abs().max()) <= scale * 0.5 + 1e-6


def test_compressed_bytes_accounting():
    C = Q_opt.CompressionConfig
    assert Q_opt.compressed_bytes(1000, C("none")) == 4000
    assert Q_opt.compressed_bytes(1000, C("int8")) == 1004
    assert Q_opt.compressed_bytes(1000, C("topk", topk_frac=0.01)) == 80


# ---------------------------------------------------------------------------
# against the reference on the same inputs
# ---------------------------------------------------------------------------

def _tree(rng):
    """Matrices in bfloat16 and vectors in float32, as a model's are."""
    return {"w": rng.normal(size=(6, 5)) * 0.3, "b": rng.normal(size=5),
            "blk": {"k": rng.normal(size=(3, 4, 2)) * 0.1,
                    "s": 1 + rng.normal(size=4) * 0.1}}


def _both(tree):
    bf = lambda k: k in ("w", "k")
    r = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(x, jnp.bfloat16 if bf(p[-1].key)
                                 else jnp.float32), tree)
    q = jax.tree_util.tree_map_with_path(
        lambda p, x: torch.tensor(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16 if bf(p[-1].key) else torch.float32), r)
    return r, q


def _close(got, want, tol):
    for (path, g), w in zip(Q_opt.tree_items(got), jax.tree.leaves(want)):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w.astype(jnp.float32))
        assert np.max(np.abs(g - w)) <= tol * (np.abs(w).max() + 1e-12), path


@pytest.mark.parametrize("schedule", ["cosine", "const"])
def test_adamw_update_matches_reference(schedule):
    rng = np.random.default_rng(5)
    rp, qp = _both(_tree(rng))
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, schedule=schedule)
    rs, qs = R_opt.adamw_init(rp), Q_opt.adamw_init(qp)
    for _ in range(3):
        g = _tree(rng)
        rg, qg = _both(g)
        rp, rs, rm = R_opt.adamw_update(rg, rs, rp, R_opt.AdamWConfig(**cfg))
        qp, qs, qm = Q_opt.adamw_update(qg, qs, qp, Q_opt.AdamWConfig(**cfg))
    assert int(qs["step"]) == int(rs["step"]) == 3
    assert qs["step"].dtype == torch.int32
    _close(qs["mu"], rs["mu"], 1e-6)
    _close(qs["nu"], rs["nu"], 1e-6)
    # the parameters in their own dtype: a bfloat16 leaf may round one ulp
    # apart where the float32 updates differ in their last bit
    for (_, g), w in zip(Q_opt.tree_items(qp), jax.tree.leaves(rp)):
        assert g.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                           else torch.float32)
    _close(qp, rp, 1e-3)
    assert float(qm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                   rel=1e-6)
    assert float(qm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)


@pytest.mark.parametrize("kind", ["none", "int8", "topk"])
def test_compression_matches_reference(kind):
    """The same payloads and residuals; top-k on magnitudes without ties."""
    rng = np.random.default_rng(11)
    g = (rng.permutation(np.linspace(0.01, 3, 200))
         * rng.choice([-1, 1], 200)).reshape(20, 10)
    e = rng.normal(size=(20, 10)) * 1e-3
    rcfg = R_opt.CompressionConfig(kind=kind, topk_frac=0.1)
    qcfg = Q_opt.CompressionConfig(kind=kind, topk_frac=0.1)
    r_out, r_err = R_opt.ef_roundtrip(jnp.asarray(g, jnp.float32),
                                      jnp.asarray(e, jnp.float32), rcfg)
    q_out, q_err = Q_opt.ef_roundtrip(torch.tensor(g, dtype=torch.float32),
                                      torch.tensor(e, dtype=torch.float32),
                                      qcfg)
    np.testing.assert_array_equal(q_out.numpy(), np.asarray(r_out))
    np.testing.assert_array_equal(q_err.numpy(), np.asarray(r_err))
    if kind != "none":
        rp, _ = R_opt.compress(jnp.asarray(g, jnp.float32),
                               jnp.zeros((20, 10)), rcfg)
        qp, _ = Q_opt.compress(torch.tensor(g, dtype=torch.float32),
                               torch.zeros(20, 10), qcfg)
        for a, b in zip(qp[:2], rp[:2]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert Q_opt.compressed_bytes(12345, qcfg) == \
        R_opt.compressed_bytes(12345, rcfg)


def test_synthetic_batches_match_reference():
    for cfg in (dict(vocab=512, seq_len=64, global_batch=8, seed=0),
                dict(vocab=50, seq_len=33, global_batch=3, seed=4,
                     mean_doc_len=20)):
        r = R_data.SyntheticLM(R_data.DataConfig(**cfg))
        q = Q_data.SyntheticLM(Q_data.DataConfig(**cfg))
        for step in (0, 7):
            want, got = r.batch(step), q.batch(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
        dev = q.device_batch(7, "cpu")
        np.testing.assert_array_equal(dev["tokens"].numpy(), want["tokens"])
        assert dev["labels"].dtype == torch.int32
    docs = [np.arange(1, 6), np.arange(10, 30), np.arange(40, 43)]
    np.testing.assert_array_equal(Q_data.pack_documents(docs, 7, 0),
                                  R_data.pack_documents(docs, 7, 0))


# ---------------------------------------------------------------------------
# the collective planner and the elastic policies (tests/test_distributed.py)
# ---------------------------------------------------------------------------

def test_ring_schedule_feasible():
    s = Q_dist.ring_schedule(8, Q_dist.PodFabric(n_pods=8))
    assert deploy_topo_check(s.conn)
    np.testing.assert_array_equal(
        s.conn, R_dist.ring_schedule(8, R_dist.PodFabric(n_pods=8)).conn)


@pytest.mark.parametrize("p,mb,aligned,comp", [
    (2, 1, True, None), (3, 7, True, None), (5, 64, True, None),
    (8, 3, True, "int8"), (4, 5, False, None), (3, 2, False, "topk"),
    (1, 4, True, None)])
def test_collective_plan_matches_reference(p, mb, aligned, comp):
    """Equal plans and times, every transfer on a live circuit."""
    qf, rf = Q_dist.PodFabric(n_pods=p), R_dist.PodFabric(n_pods=p)
    qc = comp and Q_opt.CompressionConfig(comp)
    rc = comp and R_opt.CompressionConfig(comp)
    B = mb << 20
    got = Q_dist.plan_ring_allreduce(B, qf, aligned=aligned, compression=qc)
    want = R_dist.plan_ring_allreduce(B, rf, aligned=aligned, compression=rc)
    assert got.transfers == want.transfers
    assert (got.total_slices, got.total_bytes_per_link) == \
        (want.total_slices, want.total_bytes_per_link)
    np.testing.assert_array_equal(got.schedule.conn, want.schedule.conn)
    assert got.time_s(qf) == want.time_s(rf)
    for _, src, dst, t, nbytes in got.transfers:
        assert got.schedule.has_circuit(src, dst, t)
        assert nbytes <= qf.slice_bytes
    assert Q_dist.allreduce_time_s(B, qf, aligned, qc) == \
        R_dist.allreduce_time_s(B, rf, aligned, rc)


def test_plan_time_matches_closed_form():
    fabric = Q_dist.PodFabric(n_pods=4)
    B = 64 << 20
    plan = Q_dist.plan_ring_allreduce(B, fabric, aligned=True)
    assert plan.time_s(fabric) == pytest.approx(
        Q_dist.allreduce_time_s(B, fabric, aligned=True), rel=0.2)


def test_alignment_and_compression_win():
    fabric = Q_dist.PodFabric(n_pods=8)
    B = 256 << 20
    t_aligned = Q_dist.allreduce_time_s(B, fabric, aligned=True)
    assert Q_dist.allreduce_time_s(B, fabric, aligned=False) > 3 * t_aligned
    t_int8 = Q_dist.allreduce_time_s(
        B, Q_dist.PodFabric(n_pods=4), aligned=True,
        compression=Q_opt.CompressionConfig("int8"))
    assert t_int8 < 0.3 * Q_dist.allreduce_time_s(
        B, Q_dist.PodFabric(n_pods=4), aligned=True)


@pytest.mark.parametrize("shape,axes,failed", [
    ((2, 16, 16), ("pod", "data", "model"), 40),
    ((16, 16), ("data", "model"), 64), ((8, 4), ("data", "model"), 5)])
def test_elastic_plans_match_reference(shape, axes, failed):
    got = Q_el.plan_remesh(Q_el.MeshPlan(shape, axes), failed, 120,
                           param_bytes=2 << 30, global_batch=256)
    want = R_el.plan_remesh(R_el.MeshPlan(shape, axes), failed, 120,
                            param_bytes=2 << 30, global_batch=256)
    assert (got.new.shape, got.grad_accum_factor, got.reshard_bytes,
            got.devices_lost) == (want.new.shape, want.grad_accum_factor,
                                  want.reshard_bytes, want.devices_lost)
    assert dict(zip(got.new.axes, got.new.shape))["model"] == \
        dict(zip(axes, shape))["model"]
    new_data = dict(zip(got.new.axes, got.new.shape))["data"]
    assert new_data * got.grad_accum_factor >= dict(zip(axes, shape))["data"]


def test_shrink_mesh_raises_when_model_axis_would_break():
    with pytest.raises(RuntimeError):
        Q_el.shrink_mesh(Q_el.MeshPlan((1, 16), ("data", "model")), 15)


@pytest.mark.parametrize("times,policy", [
    ([1.0] * 15 + [10.0], {}),
    ([1.0] * 8 + [10.0] * 8, dict(deadline_factor=1.5, min_quorum=0.75)),
    (list(np.random.default_rng(3).lognormal(0, 0.6, 16)), {})])
def test_straggler_policy_matches_reference(times, policy):
    times = np.asarray(times)
    ok, dl, renorm = Q_el.apply_straggler_policy(
        times, Q_el.StragglerPolicy(**policy))
    rok, rdl, rrenorm = R_el.apply_straggler_policy(
        times, R_el.StragglerPolicy(**policy))
    np.testing.assert_array_equal(ok, rok)
    assert (dl, renorm) == (rdl, rrenorm)
    g = {"a": torch.ones(3, dtype=torch.bfloat16) * 6}
    out = Q_el.renormalize_grads(g, 3, 4)
    assert out["a"].dtype == torch.bfloat16 and float(out["a"][0]) == 2.0
