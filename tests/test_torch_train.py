"""The port's training path on the CPU, held against the reference.

* Attention's gradient: ``FlashAttentionFn`` (the flash kernel's plain
  version forward, the blockwise torch-op backward) against ``jax.vjp`` of
  ``repro.models.chunked_attention.chunked_attention``, and the plain
  version's LSE against its ``_fwd_scan``: causal, window 8, softcap 30,
  GQA 4:2, cross-attention with Lq != S, a query offset, each over more
  than one block each way.
* The scan's gradient (``RGLRUFn``) against ``jax.vjp`` of the
  reference's ``associative_scan``; the expert products' gradient
  (``GroupedMatmulFn``) against ``jax.vjp`` of the einsum.
* ``Model.loss`` and its gradient, leaf by leaf in the reference's tree,
  against ``jax.value_and_grad`` of the reference's ``Model.loss`` on the
  ``reduced()`` configs of seven families, with the reference's
  parameters carried over; one ``make_train_step`` step of two
  micro-batches against the reference's.
* The driver: the loss falls, also with int8 compression.

Tolerances (relative error, max |a - b| / max |b|): the kernels'
gradients 2e-5 in float32 and 2e-2 in bfloat16 (``tests/test_kernels.py``'s
tolerances; the scan's 1e-4); a model with float32 weights 1e-4 on the
loss and 1e-3 on every gradient leaf (the two packages sum in other
orders; measured up to ~5e-6), in bfloat16 2e-2 and 6e-2 (the model
tolerance of ``tests/torch_lm_parity.py``).
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch.steps import make_train_step as R_make_train_step  # noqa: E402
from repro.models import build_model as R_build  # noqa: E402
from repro.models.chunked_attention import _fwd_scan  # noqa: E402
from repro.models.chunked_attention import chunked_attention as R_ca  # noqa: E402
from repro.optim import AdamWConfig as R_AdamWConfig  # noqa: E402
from repro.optim import adamw_init as R_adamw_init  # noqa: E402
from repro_torch.checkpoint import keystr  # noqa: E402
from repro_torch.configs import get_config as Q_get_config  # noqa: E402
from repro_torch.kernels import flash_attention as Q_fa  # noqa: E402
from repro_torch.kernels import grouped_matmul as Q_gmm  # noqa: E402
from repro_torch.kernels import rg_lru as Q_rl  # noqa: E402
from repro_torch.launch.steps import make_train_step, opt_init  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import build_model as Q_build  # noqa: E402
from repro_torch.models import params_to_numpy, to_reference_tree  # noqa: E402
from repro_torch.models.chunked_attention import FlashAttentionFn  # noqa: E402
from repro_torch.optim import AdamWConfig as Q_AdamWConfig  # noqa: E402
from repro_torch.optim import tree_items  # noqa: E402
from repro.configs import get_config as R_get_config  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from torch_lm_parity import TORCH, both, frontend_inputs, to_numpy  # noqa: E402
from torch_lm_parity import relerr as _relerr  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402, F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KERNEL_TOL = {"f32": 2e-5, "bf16": 2e-2}
LOSS_TOL = {"f32": 1e-4, "bf16": 2e-2}
LEAF_TOL = {"f32": 1e-3, "bf16": 6e-2}


def relerr(a, b):
    return _relerr(a.detach() if isinstance(a, torch.Tensor) else a, b)


@functools.cache
def _reference_params(arch, over):
    # one jitted init a config (the op-by-op init compiles every op)
    cfg = R_get_config(arch).reduced(**dict(over))
    return jax.jit(R_build(cfg).init)(jax.random.PRNGKey(0))


def carried(arch, dt, **over):
    """(cfg, reference params, port params) at ``reduced(**over)``, both
    float32 with ``dt="f32"``."""
    cfg = R_get_config(arch).reduced(**over)
    rp = _reference_params(arch, tuple(sorted(over.items())))
    qp = params_from_numpy(Q_get_config(arch).reduced(**over), to_numpy(rp),
                           device="cpu")
    if dt == "f32":
        rp = jax.tree.map(lambda x: x.astype(jnp.float32), rp)
        qp = qp.float()
    return cfg, rp, qp


# ---------------------------------------------------------------------------
# the kernels' gradients
# ---------------------------------------------------------------------------

ATTN_CASES = {
    "causal": dict(),
    "window8": dict(window=8),
    "softcap30": dict(softcap=30.0),
    "gqa4to2": dict(Hq=4, Hkv=2),
    "cross": dict(L=24, S=40, causal=False),
    "q_offset": dict(L=16, q_offset=16, window=12),
}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_grads_match_reference(case, dt):
    c = dict(B=2, Hq=2, Hkv=2, L=32, S=32, hd=16, causal=True, window=0,
             softcap=0.0, q_offset=0, bq=8, bk=8)
    c.update(ATTN_CASES[case])
    B, Hq, Hkv, L, S, hd = (c[k] for k in ("B", "Hq", "Hkv", "L", "S", "hd"))
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    rng = np.random.default_rng(21)
    (qj, qt), (kj, kt), (vj, vt), (dj, dtt) = (
        both(rng.normal(size=s), dt) for s in
        ((B, Hq, L, hd), (B, Hkv, S, hd), (B, Hkv, S, hd), (B, Hq, L, hd)))
    qpos = jnp.broadcast_to(c["q_offset"] + jnp.arange(L, dtype=jnp.int32),
                            (B, L))
    kpos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    args = (c["causal"], c["window"], c["softcap"], scale, c["bq"], c["bk"])

    @jax.jit
    def ref(q, k, v, d):
        out, vjp = jax.vjp(lambda q, k, v: R_ca(
            q, jnp.repeat(k, G, 1), jnp.repeat(v, G, 1), qpos, kpos, *args),
            q, k, v)
        lse = _fwd_scan(q.astype(jnp.float32),
                        jnp.repeat(k, G, 1).astype(jnp.float32),
                        jnp.repeat(v, G, 1).astype(jnp.float32), qpos, kpos,
                        *args)[1]
        return out, vjp(d), lse

    want, (wq, wk, wv), lse_want = ref(qj, kj, vj, dj)
    leaves = [x.reshape(-1, x.shape[2], hd).requires_grad_(True)
              for x in (qt, kt, vt)]
    got = FlashAttentionFn.apply(*leaves, Hq, Hkv, c["causal"], c["window"],
                                 c["softcap"], scale, c["q_offset"], c["bq"],
                                 c["bk"])
    gq, gk, gv = torch.autograd.grad(got, leaves, dtt.reshape(got.shape))
    tol = KERNEL_TOL[dt]
    assert got.dtype == TORCH[dt]
    assert relerr(got.reshape(want.shape), want) < tol
    for g, w in ((gq, wq), (gk, wk), (gv, wv)):
        assert g.dtype == TORCH[dt]
        assert relerr(g.reshape(w.shape), w) < tol
    _, lse = Q_fa.flash_attention_plain(
        *(x.detach().float() for x in leaves), n_q_heads=Hq, n_kv_heads=Hkv,
        causal=c["causal"], window=c["window"], softcap=c["softcap"],
        scale=scale, q_offset=c["q_offset"], lse=True)
    assert relerr(lse.reshape(lse_want.shape), lse_want) < 2e-5


def test_flash_attention_backward_skips_only_invisible_blocks():
    """The backward with blocks of 8 equals the one with a single block, so
    the blocks it skips (above the diagonal, below the window) held
    nothing."""
    rng = np.random.default_rng(3)
    q, k, v, d = (torch.tensor(rng.normal(size=(n, 40, 16)),
                               dtype=torch.float32) for n in (4, 2, 2, 4))
    grads = []
    for blk in (8, 40):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = FlashAttentionFn.apply(*leaves, 2, 1, True, 12, 0.0, 0.25, 0,
                                     blk, blk)
        grads.append(torch.autograd.grad(out, leaves, d))
    for a, b in zip(*grads):
        assert relerr(a, b) < 1e-6


def _ref_scan(a, b):
    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, a2 * b1 + b2
    return jax.lax.associative_scan(combine, (a, b), axis=1)[1]


def test_rg_lru_grads_match_reference():
    rng = np.random.default_rng(4)
    a = rng.uniform(0.2, 1.0, size=(2, 50, 8))
    a[..., 1::2] = 1 - rng.uniform(0, 1e-3, size=(2, 50, 4))   # slow channels
    b, dh = rng.normal(size=(2, 50, 8)), rng.normal(size=(2, 50, 8))
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    want, (wa, wb) = jax.jit(lambda a, b, d: (
        _ref_scan(a, b), jax.vjp(_ref_scan, a, b)[1](d)))(f32(a), f32(b),
                                                          f32(dh))
    leaves = [torch.tensor(x, dtype=torch.float32).requires_grad_(True)
              for x in (a, b)]
    got = Q_rl.RGLRUFn.apply(*leaves)
    ga, gb = torch.autograd.grad(got, leaves,
                                 torch.tensor(dh, dtype=torch.float32))
    assert relerr(got, want) < 1e-4
    assert relerr(ga, wa) < 1e-4 and relerr(gb, wb) < 1e-4


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_grouped_matmul_grads_match_reference(dt):
    rng = np.random.default_rng(6)
    (xj, xt), (wj, wt), (dj, dtt) = (both(rng.normal(size=s), dt) for s in
                                     ((3, 10, 24), (3, 24, 16), (3, 10, 16)))
    want, vjp = jax.vjp(lambda x, w: jnp.einsum("gmk,gkn->gmn", x, w), xj, wj)
    wx, ww = vjp(dj)
    leaves = [x.requires_grad_(True) for x in (xt, wt)]
    got = Q_gmm.GroupedMatmulFn.apply(*leaves)
    gx, gw = torch.autograd.grad(got, leaves, dtt)
    tol = KERNEL_TOL[dt]
    assert relerr(got, want) < tol
    assert gx.dtype == gw.dtype == TORCH[dt]
    assert relerr(gx, wx) < tol and relerr(gw, ww) < tol


# ---------------------------------------------------------------------------
# the model's loss and gradients
# ---------------------------------------------------------------------------

def _batch(cfg, B, L, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    labs[0, :3] = -100                                   # ignored positions
    return toks, labs


def _leaf_errs(qtree, rtree) -> dict:
    q = {keystr(p): v for p, v in tree_items(qtree)}
    return {jax.tree_util.keystr(p): relerr(q[jax.tree_util.keystr(p)], w)
            for p, w in jax.tree_util.tree_flatten_with_path(rtree)[0]}


@pytest.mark.parametrize("arch,dt", [
    ("olmo-1b", "f32"), ("olmo-1b", "bf16"), ("gemma2-9b", "f32"),
    ("recurrentgemma-9b", "f32"), ("qwen3-moe-30b-a3b", "f32"),
    ("xlstm-350m", "f32"), ("seamless-m4t-large-v2", "f32"),
    ("llava-next-34b", "f32")])
def test_loss_and_grads_match_reference(arch, dt):
    cfg, rp, qp = carried(arch, dt)
    qm = Q_build(Q_get_config(arch).reduced())
    toks, labs = _batch(cfg, 2, 24, 3)
    fe, qfe = frontend_inputs(cfg, 2, 8)
    loss, grads = jax.jit(jax.value_and_grad(R_build(cfg).loss))(
        rp, jnp.asarray(toks), jnp.asarray(labs), fe)
    qm.trainable(qp)
    qloss = qm.loss(qp, torch.tensor(toks), torch.tensor(labs), qfe)
    lq = float(qloss.detach())
    named = dict(qp.named_parameters())
    qgrads = torch.autograd.grad(qloss, list(named.values()),
                                 allow_unused=True)
    qg = {n: torch.zeros_like(p) if g is None else g
          for (n, p), g in zip(named.items(), qgrads)}
    assert abs(lq - float(loss)) < LOSS_TOL[dt] * abs(float(loss))
    errs = _leaf_errs(to_reference_tree(qm.cfg, qp, qg), grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] < LEAF_TOL[dt], (worst, errs[worst])


def test_train_step_matches_reference():
    """One step of two micro-batches with float32 weights: parameters,
    ``mu`` and ``nu`` within 1e-4 of the reference's."""
    cfg, rp, qp = carried("olmo-1b", "f32")
    cfg = dataclasses.replace(cfg, train_microbatches=2)
    toks, labs = _batch(cfg, 4, 16, 5)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    r_step = jax.jit(R_make_train_step(cfg, R_AdamWConfig(**opt)))
    rp2, ropt, rm = r_step(rp, R_adamw_init(rp),
                           {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labs)})
    qcfg = Q_get_config("olmo-1b").reduced(train_microbatches=2)
    qm = Q_build(qcfg)
    qm.trainable(qp)
    q_step = make_train_step(qcfg, Q_AdamWConfig(**opt), device="cpu")
    qp, qopt, qmet = q_step(qp, opt_init(qp), {"tokens": toks,
                                               "labels": labs})
    assert float(qmet["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert int(qopt["step"]) == 1
    for name, got, want in (
            ("params", params_to_numpy(qcfg, qp), rp2),
            ("mu", to_reference_tree(qcfg, qp, qopt["mu"]), ropt["mu"]),
            ("nu", to_reference_tree(qcfg, qp, qopt["nu"]), ropt["nu"])):
        errs = _leaf_errs(got, want)
        worst = max(errs, key=errs.get)
        assert errs[worst] < 1e-4, (name, worst, errs[worst])


# ---------------------------------------------------------------------------
# the driver (tests/test_system.py's counterparts)
# ---------------------------------------------------------------------------

def test_train_driver_loss_decreases():
    out = train(arch="olmo-1b", preset="tiny", steps=25, global_batch=8,
                seq=64, micro_batches=2, seed=0, device="cpu", log_every=100)
    assert out["final_loss"] < out["first_loss"]
    assert out["interpod_ar_rotor_s"] >= out["interpod_ar_aligned_s"] > 0


def test_train_driver_gradient_compression_still_learns():
    out = train(arch="olmo-1b", preset="tiny", steps=20, global_batch=8,
                seq=64, micro_batches=1, compression="int8", seed=0,
                device="cpu", log_every=100, straggler_sim=True)
    assert out["final_loss"] < out["first_loss"]
