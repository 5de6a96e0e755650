"""The port's language-model serving path on the CPU, held against
``repro.models`` and ``repro.launch.serve``.

Every comparison runs the reference's parameters, carried over by
``params_from_numpy``, through both packages on the same numpy inputs:

* each layer (norms, rope, attention at prefill for each cache branch and
  at decode over a ring buffer, the GLU MLP, the RG-LRU block at prefill and
  decode, the MoE layer at prefill with dropped assignments, with
  ``moe_chunk``, at decode and with a shared expert) against
  ``repro.models.layers``;
* ``prefill`` + 8 ``decode_step``s of ``recurrentgemma-9b``, ``gemma2-9b``
  (softcap, local/global), ``olmo-1b`` (``layernorm_np``; GQA as
  ``reduced()`` makes it, and MHA), ``qwen3-moe-30b-a3b`` and
  ``llama4-scout-17b-a16e`` (MoE) at ``cfg.reduced()`` against
  ``repro.models.Model``;
* ``serve`` with ``requests <= batch`` against the reference's counts, and
  the port's slot refill (which the reference gets wrong, see
  ``test_reference_refill_merge_misses_per_slot_leaves``).

Tolerances (relative error, max |a - b| / max |b|): 2e-5 for a layer and
1e-4 for a whole model with float32 weights and caches, where the two
packages differ only in the order of float32 sums (measured: ~1e-6); 2e-2
for a layer in bfloat16 (``tests/test_kernels.py``'s bfloat16 tolerance);
6e-2 for a whole bfloat16 model, because bfloat16 rounds at other places in
the two frameworks: the reference itself differs from itself by 3.5e-2
between its jitted and its eager prefill of ``recurrentgemma-9b-smoke``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as R_get_config, list_archs  # noqa: E402
from repro.launch.serve import serve as R_serve  # noqa: E402
from repro.models import build_model as R_build  # noqa: E402
from repro.models import count_params as R_count  # noqa: E402
from repro.models import layers as R_ly  # noqa: E402
from repro.models import model_flops as R_flops  # noqa: E402
from repro_torch.configs import get_config as Q_get_config  # noqa: E402
from repro_torch.kernels import grouped_matmul as Q_gmm  # noqa: E402
from repro_torch.launch import serve as Q_serve  # noqa: E402
from repro_torch.models import Model as Q_Model  # noqa: E402
from repro_torch.models import build_model as Q_build  # noqa: E402
from repro_torch.models import count_params as Q_count  # noqa: E402
from repro_torch.models import layers as Q_ly  # noqa: E402
from repro_torch.models import model_flops as Q_flops  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from torch_lm_parity import (JNP, LAYER_TOL, MODEL_TOL, TORCH, both,  # noqa: E402
                             carried, float_cache, group_layer, relerr,
                             to_numpy)
from torch_parity import release_compiled_programs  # noqa: E402, F401


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "layernorm_np"])
def test_norm_matches_reference(kind, dt):
    cfg = dataclasses.replace(R_get_config("olmo-1b").reduced(), norm=kind)
    rng = np.random.default_rng(0)
    xj, xt = both(rng.normal(size=(2, 5, 64)) * 3 + 1, dt)
    scale = rng.normal(size=64).astype(np.float32)
    p = {} if kind == "layernorm_np" else {"scale": jnp.asarray(scale)}
    want = R_ly.norm_apply(cfg, p, xj)
    got = Q_ly.norm_apply(kind, None if kind == "layernorm_np"
                          else torch.tensor(scale), xt)
    assert got.dtype == TORCH[dt]
    assert relerr(got, want) < LAYER_TOL[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rope_matches_reference(dt):
    rng = np.random.default_rng(1)
    xj, xt = both(rng.normal(size=(2, 7, 4, 16)), dt)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    want = R_ly.rope(xj, jnp.asarray(pos), 10_000.0)
    got = Q_ly.rope(xt, torch.tensor(pos), 10_000.0)
    assert got.dtype == TORCH[dt]
    assert relerr(got, want) < LAYER_TOL[dt]


def _caches_close(rc, qc, dt):
    assert relerr(qc.k, rc.k) < LAYER_TOL[dt]
    assert relerr(qc.v, rc.v) < LAYER_TOL[dt]
    np.testing.assert_array_equal(qc.pos.numpy(), np.asarray(rc.pos))


def _old_cache(cfg, B, S, seed, dt):
    """A cache that already holds keys of an earlier sequence: every slot
    is filled, at positions 100..100+S-1."""
    rng = np.random.default_rng(seed)
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    kj, kt = both(rng.normal(size=(B, S, hkv, hd)), dt)
    vj, vt = both(rng.normal(size=(B, S, hkv, hd)), dt)
    pos = np.broadcast_to(100 + np.arange(S), (B, S)).astype(np.int32)
    return (R_ly.AttnCache(kj, vj, jnp.asarray(pos)),
            Q_ly.AttnCache(kt, vt, torch.tensor(pos)))


# (name, cache slots S or None, window) at L = 24 prompt tokens
PREFILL_CASES = [("no-cache-window", None, 16), ("S==L", 24, 0),
                 ("S<L-ring", 16, 16), ("S>L-scatter", 40, 0)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["gemma2-9b", "recurrentgemma-9b"])
@pytest.mark.parametrize("name,S,window", PREFILL_CASES,
                         ids=[c[0] for c in PREFILL_CASES])
def test_attention_prefill_matches_reference(arch, dt, name, S, window):
    cfg, rp, qp = carried(arch, dt)
    i = cfg.pattern.index("attn") if "attn" in cfg.pattern else 0
    rl, ql = group_layer(cfg, rp, qp, i)
    B, L = 2, 24
    xj, xt = both(np.random.default_rng(2).normal(size=(B, L, 64)), dt)
    pos = np.broadcast_to(np.arange(L), (B, L)).astype(np.int32)
    rc = qc = None
    if S is not None:
        rc, qc = _old_cache(cfg, B, S, 3, dt)
    want, rnc = R_ly.attn_apply(rl["attn"], xj, cfg, positions=jnp.asarray(pos),
                                window=window, cache=rc,
                                write_index=jnp.int32(0))
    got, qnc = Q_ly.attn_apply(ql.attn, xt, cfg, positions=torch.tensor(pos),
                               window=window, cache=qc, write_index=0)
    assert got.dtype == TORCH[dt] and got.shape == (B, L, 64)
    assert relerr(got, want) < LAYER_TOL[dt]
    if S is not None:
        _caches_close(rnc, qnc, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["gemma2-9b", "recurrentgemma-9b"])
@pytest.mark.parametrize("S,window", [(16, 16), (40, 0)],
                         ids=["ring-wrapped-window", "global"])
def test_attention_decode_matches_reference(arch, dt, S, window):
    """Prefill 24 tokens into the cache, then 5 decode steps: with 16 ring
    slots the writes wrap around (slot order != position order)."""
    cfg, rp, qp = carried(arch, dt)
    i = cfg.pattern.index("attn") if "attn" in cfg.pattern else 0
    rl, ql = group_layer(cfg, rp, qp, i)
    B, L = 2, 24
    rng = np.random.default_rng(4)
    xj, xt = both(rng.normal(size=(B, L, 64)), dt)
    pos = np.broadcast_to(np.arange(L), (B, L)).astype(np.int32)
    rc = R_ly.make_cache(cfg, B, S, dtype=JNP[dt])
    qc = Q_ly.make_cache(cfg, B, S, dtype=TORCH[dt])
    _, rc = R_ly.attn_apply(rl["attn"], xj, cfg, positions=jnp.asarray(pos),
                            window=window, cache=rc, write_index=jnp.int32(0))
    _, qc = Q_ly.attn_apply(ql.attn, xt, cfg, positions=torch.tensor(pos),
                            window=window, cache=qc, write_index=0)
    for t in range(L, L + 5):
        xj, xt = both(rng.normal(size=(B, 1, 64)), dt)
        p = np.full((B, 1), t, np.int32)
        want, rc = R_ly.attn_apply(rl["attn"], xj, cfg,
                                   positions=jnp.asarray(p), window=window,
                                   cache=rc, write_index=jnp.int32(t))
        got, qc = Q_ly.attn_apply(ql.attn, xt, cfg, positions=torch.tensor(p),
                                  window=window, cache=qc, write_index=t)
        assert relerr(got, want) < LAYER_TOL[dt], t
        _caches_close(rc, qc, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["olmo-1b", "gemma2-9b"], ids=["silu", "gelu"])
def test_mlp_matches_reference(arch, dt):
    cfg, rp, qp = carried(arch, dt)
    rl, ql = group_layer(cfg, rp, qp, 0)
    xj, xt = both(np.random.default_rng(5).normal(size=(2, 6, 64)), dt)
    want = R_ly.mlp_apply(rl["mlp"], xj, cfg)
    got = Q_ly.mlp_apply(ql.mlp, xt, cfg)
    assert got.dtype == TORCH[dt]
    assert relerr(got, want) < LAYER_TOL[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("L", [12, 2], ids=["L12", "L2-shorter-than-conv"])
def test_rglru_prefill_and_decode_match_reference(dt, L):
    cfg, rp, qp = carried("recurrentgemma-9b", dt)
    rl, ql = group_layer(cfg, rp, qp, 0)
    rng = np.random.default_rng(6)
    xj, xt = both(rng.normal(size=(2, L, 64)), dt)
    want, (rs, rcs) = R_ly.rglru_apply(rl["rglru"], xj, cfg)
    got, (qs, qcs) = Q_ly.rglru_apply(ql.rglru, xt, cfg)
    for g, w in ((got, want), (qs, rs), (qcs, rcs)):
        assert tuple(g.shape) == w.shape
        assert relerr(g, w) < LAYER_TOL[dt]
    for _ in range(3):
        xj, xt = both(rng.normal(size=(2, 1, 64)), dt)
        want, (rs, rcs) = R_ly.rglru_apply(rl["rglru"], xj, cfg, state=rs,
                                           conv_state=rcs)
        got, (qs, qcs) = Q_ly.rglru_apply(ql.rglru, xt, cfg, state=qs,
                                          conv_state=qcs)
        for g, w in ((got, want), (qs, rs), (qcs, rcs)):
            assert relerr(g, w) < LAYER_TOL[dt]
    assert qs.dtype == torch.float32 and qcs.dtype == TORCH[dt]


def _dropped(qm, x, cfg):
    """Assignments the capacity drops when the rows of x [R, T, d] are
    dispatched (computed from the port's router)."""
    R, T, _ = x.shape
    m = cfg.moe
    C = max(1, int(np.ceil(T * m.top_k / m.num_experts * m.capacity_factor)))
    _, idx = Q_ly.moe_route(qm, x, cfg)
    counts = torch.nn.functional.one_hot(idx.reshape(R, -1),
                                         m.num_experts).sum(1)
    return int((counts - C).clamp(min=0).sum())


# (arch, overrides of reduced(), B, L, rows as dispatched)
MOE_CASES = {
    "prefill-drops": ("qwen3-moe-30b-a3b", {}, 2, 24, lambda B, L: (B, L)),
    "moe-chunk": ("qwen3-moe-30b-a3b", dict(moe_chunk=8), 2, 24,
                  lambda B, L: (B * L // 8, 8)),
    "decode": ("qwen3-moe-30b-a3b", {}, 6, 1, lambda B, L: (1, B)),
    "shared": ("llama4-scout-17b-a16e", {}, 2, 24, lambda B, L: (B, L)),
}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_reference(case, dt):
    """The MoE layer against the reference's ``moe_apply``. The tokens
    share a component, so the router favours some experts and the capacity
    drops assignments in every case (asserted)."""
    arch, over, B, L, rows = MOE_CASES[case]
    cfg, rp, qp = carried(arch, dt, **over)
    rl, ql = group_layer(cfg, rp, qp, 0)
    rng = np.random.default_rng(10)
    xj, xt = both(rng.normal(size=(B, L, 64)) + 2 * rng.normal(size=64), dt)
    assert _dropped(ql.moe, xt.reshape(*rows(B, L), 64), cfg) > 0
    want = R_ly.moe_apply(rl["moe"], xj, cfg)
    got = Q_ly.moe_apply(ql.moe, xt, cfg)
    assert got.dtype == TORCH[dt] and tuple(got.shape) == (B, L, 64)
    assert relerr(got, want) < LAYER_TOL[dt]


def test_moe_route_orders_experts_by_logit():
    """``torch.topk`` gives the experts in descending order of logit, as
    ``jax.lax.top_k`` does: the order feeds the stable sort of the
    dispatch."""
    cfg, rp, qp = carried("qwen3-moe-30b-a3b", "f32")
    rl, ql = group_layer(cfg, rp, qp, 0)
    x = np.random.default_rng(11).normal(size=(3, 7, 64)).astype(np.float32)
    gates, idx = Q_ly.moe_route(ql.moe, torch.tensor(x), cfg)
    logits = jnp.asarray(x) @ rl["moe"]["router"]
    vals, want = jax.lax.top_k(logits, cfg.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_allclose(gates.numpy(),
                               np.asarray(jax.nn.softmax(vals, -1)), rtol=1e-6)
    assert (gates[..., :-1] >= gates[..., 1:]).all()


@pytest.mark.parametrize("B", [1, 4, 6])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"])
def test_decode_dispatch_leaves_groups_without_a_token_zero(arch, B,
                                                             monkeypatch):
    """At decode (L = 1) each of the three buffers the MoE layer hands to
    ``grouped_matmul`` has at most B * k groups with a nonzero row, all of
    them experts the router picked, and every other group exactly zero.
    The CUDA kernel's streaming route reads no weights of such a group
    (``csrc/grouped_matmul.cu``), relying on this."""
    cfg = Q_get_config(arch).reduced()
    moe = Q_ly.MoE(cfg, "cpu")
    with torch.no_grad():
        moe.reset_parameters(torch.Generator().manual_seed(B))
    seen = []
    real = Q_gmm.grouped_matmul

    def spy(x, w):
        seen.append(x.clone())
        return real(x, w)

    monkeypatch.setattr(Q_gmm, "grouped_matmul", spy)
    x = torch.tensor(np.random.default_rng(B).normal(size=(B, 1, cfg.d_model)),
                     dtype=torch.bfloat16)
    with torch.no_grad():
        Q_ly.moe_apply(moe, x, cfg)
        _, idx = Q_ly.moe_route(moe, x.reshape(1, B, -1), cfg)
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    routed = set(idx.reshape(-1).tolist())
    assert len(seen) == 3
    for xe in seen:
        assert xe.shape[0] == E
        live = xe.reshape(E, -1).ne(0).any(-1)
        assert 0 < int(live.sum()) <= B * k
        assert set(torch.nonzero(live).reshape(-1).tolist()) <= routed
        assert not xe[~live].any()


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

MODEL_CASES = [("recurrentgemma-9b", {}), ("gemma2-9b", {}), ("olmo-1b", {}),
               ("olmo-1b", dict(n_kv_heads=4)), ("qwen3-moe-30b-a3b", {}),
               ("llama4-scout-17b-a16e", {})]


class _Routes:
    """Records, per model step, the expert set each MoE layer picks for
    each token, in the reference (through a debug callback, so it stays
    jitted) and in the port."""

    def __init__(self, monkeypatch):
        self.ref, self.port, self.steps = [], [], []
        r_apply, q_route = R_ly.moe_apply, Q_ly.moe_route

        def ref_apply(p, x, cfg):
            idx = jax.lax.top_k(x.astype(jnp.float32) @ p["router"],
                                cfg.moe.top_k)[1]
            jax.debug.callback(lambda i: self.ref.append(np.asarray(i)), idx,
                               ordered=True)
            return r_apply(p, x, cfg)

        def port_route(p, x, cfg):
            gates, idx = q_route(p, x, cfg)
            self.port.append(idx.numpy())
            return gates, idx

        monkeypatch.setattr(R_ly, "moe_apply", ref_apply)
        monkeypatch.setattr(Q_ly, "moe_route", port_route)

    def mark(self):
        """Close a step: the records since the last mark belong to it."""
        jax.effects_barrier()
        self.steps.append((len(self.ref), len(self.port)))

    def first_flip(self) -> int:
        """The first step at which some token's expert set differs between
        the two packages (the number of steps if none does)."""
        sets = lambda a: np.sort(np.concatenate(
            [x.reshape(-1, x.shape[-1]) for x in a] or [np.zeros((0, 1))]), -1)
        lo = (0, 0)
        for i, hi in enumerate(self.steps):
            r, q = sets(self.ref[lo[0]:hi[0]]), sets(self.port[lo[1]:hi[1]])
            if r.shape != q.shape or not np.array_equal(r, q):
                return i
            lo = hi
        return len(self.steps)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch,over", MODEL_CASES,
                         ids=["recurrentgemma", "gemma2", "olmo", "olmo-mha",
                              "qwen3-moe", "llama4-moe"])
def test_prefill_and_decode_match_reference(arch, over, dt, monkeypatch):
    """A 20-token prefill into a 32-slot cache (local layers: a 16-slot
    ring, rolled; global layers: scattered), then 8 decode steps on given
    tokens. Logits agree within the tolerance, and so do the greedy tokens
    wherever the reference's top-2 margin exceeds it.

    MoE models: a token's experts are a discrete choice, and in bfloat16 the
    two packages' hidden states differ by rounding, so a near-tie of the
    router can pick another expert in one of them (at decode, with a
    capacity of 1, that also changes which token is dropped). From the
    first step where the expert sets differ on, the logits may differ by
    more than rounding: they are held up to that step, and in float32 no
    expert set may differ at all."""
    routes = _Routes(monkeypatch)
    cfg, rp, qp = carried(arch, dt, **over)
    rm, qm = R_build(cfg), Q_build(Q_get_config(arch).reduced(**over))
    B, L, S = 2, 20, 32
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, L + 8))
    toks = toks.astype(np.int32)
    rc, qc = rm.init_cache(B, S), qm.init_cache(B, S, device="cpu")
    if dt == "f32":
        rc = jax.tree.map(lambda a: a.astype(jnp.float32)
                          if a.dtype == jnp.bfloat16 else a, rc)
        qc = float_cache(qc)
    rl, rc = jax.jit(rm.prefill)(rp, jnp.asarray(toks[:, :L]), rc)
    ql, qc = qm.prefill(qp, torch.tensor(toks[:, :L]), qc)
    routes.mark()
    want, got = [np.asarray(rl)], [ql.numpy()]
    step = jax.jit(rm.decode_step)
    for t in range(L, L + 8):
        rl, rc = step(rp, jnp.asarray(toks[:, t:t + 1]), rc, jnp.int32(t))
        ql, qc = qm.decode_step(qp, torch.tensor(toks[:, t:t + 1]), qc, t)
        routes.mark()
        want.append(np.asarray(rl))
        got.append(ql.numpy())
    want, got = np.stack(want), np.stack(got)          # [9, B, 1, V]
    assert got.dtype == np.float32 and got.shape == want.shape
    n = routes.first_flip()
    assert n == 9 or (dt == "bf16" and n > 0), n
    want, got = want[:n], got[:n]
    tol = MODEL_TOL[dt]
    for w, g in zip(want, got):
        assert relerr(g, w) < tol
    top2 = np.sort(want, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol * np.abs(want).max(-1)
    same = want.argmax(-1) == got.argmax(-1)
    assert clear.any() and same[clear].all()


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

SERVE_KW = dict(arch="recurrentgemma-9b", preset="tiny", requests=3, batch=4,
                prompt_len=24, max_new=8, cache_len=64)


def _serve_both(monkeypatch, **kw):
    """(reference's serve dict, port's) with the reference's weights (from
    the same seed, carried over)."""
    want = R_serve(**kw)
    cfg = R_get_config(kw["arch"]).reduced(vocab=512)
    tree = to_numpy(R_build(cfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(Q_Model, "init", lambda self, seed=0, device=None:
                        params_from_numpy(self.cfg, tree, device))
    return want, Q_serve.serve(**kw, device="cpu")


def test_serve_matches_reference_counts(monkeypatch):
    """``requests <= batch``: no refill. Both serve the same requests and
    decode the same number of tokens, in the same dict. Both count the slot
    padded with a zero prompt as a served request: 4 for 3 requests
    (ROADMAP Queue 3 records this quirk of the reference's scheduler, which
    the port keeps)."""
    want, got = _serve_both(monkeypatch, **SERVE_KW)
    assert got.keys() == want.keys()
    assert got["requests_done"] == want["requests_done"] == 4
    assert got["decode_tokens"] == want["decode_tokens"] > 0


def test_serve_moe_matches_reference_counts(monkeypatch):
    """The same for the MoE model, whose decode steps dispatch the batch's
    tokens together."""
    want, got = _serve_both(monkeypatch, **dict(SERVE_KW,
                                                arch="qwen3-moe-30b-a3b"))
    assert got.keys() == want.keys()
    assert got["requests_done"] == want["requests_done"] == 4
    assert got["decode_tokens"] == want["decode_tokens"] > 0


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "gemma2-9b"])
def test_refill_slot_is_a_fresh_prefill(arch):
    """After a refill, every per-slot tensor of the refilled slot (k, v,
    pos, the RG-LRU state, the conv state) equals a fresh prefill of its
    prompt, and the other slots are unchanged. gemma2's global layers have
    more cache slots than the prompt, so a merge that kept the old slot's
    cache would leave stale keys behind."""
    cfg = Q_get_config(arch).reduced(vocab=512)
    model = Q_build(cfg)
    params = model.init(0, device="cpu")
    B, L, S, s = 4, 24, 64, 2
    rng = np.random.default_rng(8)
    cache = model.init_cache(B, S, device="cpu")
    logits, cache = model.prefill(
        params, torch.tensor(rng.integers(2, 512, (B, L))), cache)
    tok = logits[:, -1].argmax(-1)[:, None]
    for t in range(L, L + 3):
        logits, cache = model.decode_step(params, tok, cache, t)
        tok = logits[:, -1].argmax(-1)[:, None]
    before = [x.clone() for x in Q_serve.cache_leaves(cache)]
    prompt = rng.integers(2, 512, L).astype(np.int32)
    first = Q_serve.refill_slot(model, params, cache, s, prompt, B, S)
    fresh_logits, fresh = model.prefill(
        params, torch.tensor(np.tile(prompt, (B, 1))),
        model.init_cache(B, S, device="cpu"))
    torch.testing.assert_close(first, fresh_logits[s], rtol=0, atol=0)
    others = [j for j in range(B) if j != s]
    for old, now, new in zip(before, Q_serve.cache_leaves(cache),
                             Q_serve.cache_leaves(fresh)):
        assert torch.equal(now[s], new[s])
        assert torch.equal(now[others], old[others])


def test_reference_refill_merge_misses_per_slot_leaves():
    """The reference's refill (``repro/launch/serve.py`` ``fill_slots``)
    merges only leaves with ndim >= 4, along axis -4. On the stacked group
    caches of recurrentgemma that leaves ``pos`` [n_groups, B, S] and the
    RG-LRU state [n_groups, B, w] of the refilled slot as they were, and
    merges the conv state [n_groups, B, cw, w] along the group axis: the
    fault the port's ``merge_slot`` does not copy (ROADMAP Queue 3)."""
    cfg = R_get_config("recurrentgemma-9b").reduced(vocab=512)
    m = R_build(cfg)
    rp = m.init(jax.random.PRNGKey(0))
    B, L, S, s = 4, 24, 64, 1
    rng = np.random.default_rng(9)
    _, cache = m.prefill(rp, jnp.asarray(rng.integers(2, 512, (B, L))),
                         m.init_cache(B, S))
    _, new = m.prefill(rp, jnp.asarray(rng.integers(2, 512, (B, L // 2))),
                       m.init_cache(B, S))
    merged = jax.tree.map(       # the reference's merge expression
        lambda old, nw: old.at[..., s:s + 1, :, :, :].set(
            nw[..., s:s + 1, :, :, :]) if old.ndim >= 4 else old, cache, new)
    g = merged["groups"]
    attn, rec = g["attn2"], g["rec0"]
    np.testing.assert_array_equal(attn.k[:, s], new["groups"]["attn2"].k[:, s])
    # pos is not merged: the slot keeps the old prompt's positions 8..23
    np.testing.assert_array_equal(attn.pos[:, s],
                                  cache["groups"]["attn2"].pos[:, s])
    assert not np.array_equal(attn.pos[:, s], new["groups"]["attn2"].pos[:, s])
    # the RG-LRU state is not reset to the new prompt's
    np.testing.assert_array_equal(rec[0][:, s], cache["groups"]["rec0"][0][:, s])
    # the conv state is merged along the group axis, for every slot
    np.testing.assert_array_equal(rec[1][s], new["groups"]["rec0"][1][s])
    assert not np.array_equal(rec[1][s - 1][s], new["groups"]["rec0"][1][s - 1][s])


# ---------------------------------------------------------------------------
# entry points, configurations, parameter accounting
# ---------------------------------------------------------------------------

def test_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Q_get_config("recurrentgemma-9b").reduced()
    model = Q_build(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(cfg, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Q_serve.serve(arch="recurrentgemma-9b", requests=1, batch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Q_serve.serve(arch="recurrentgemma-9b", requests=1, batch=1,
                      device="cuda")
    assert model.init(0, device="cpu").embed.device.type == "cpu"


@pytest.mark.parametrize("arch", ["xlstm-350m", "seamless-m4t-large-v2",
                                  "llava-next-34b"])
def test_unported_kinds_raise(arch):
    """The xLSTM, encoder-decoder and vision models were the last unported
    ones: they build now, and only a layer kind that neither package has
    raises, when its parameters are made (``ValueError``, as the
    reference's ``_layer_init`` does)."""
    cfg = Q_get_config(arch)
    assert Q_build(cfg).cfg is cfg
    bogus = dataclasses.replace(cfg.reduced(), pattern=("bogus",), n_layers=2)
    with pytest.raises(ValueError, match="bogus"):
        Q_build(bogus).init(0, device="cpu")


@pytest.mark.parametrize("arch", list_archs())
def test_configs_and_counts_equal_reference(arch):
    r, q = R_get_config(arch), Q_get_config(arch)
    assert dataclasses.asdict(q) == dataclasses.asdict(r)
    assert dataclasses.asdict(q.reduced()) == dataclasses.asdict(r.reduced())
    for active in (False, True):
        assert Q_count(q, active) == R_count(r, active)
    for kind in ("train", "prefill", "decode"):
        assert Q_flops(q, kind, 4096, 8) == R_flops(r, kind, 4096, 8)


def test_recurrentgemma_9b_size():
    assert Q_count(Q_get_config("recurrentgemma-9b")) == 9_395_773_440


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "gemma2-9b", "olmo-1b",
                                  "granite-3-2b", "phi4-mini-3.8b"])
def test_init_matches_count_and_distributions(arch):
    cfg = Q_get_config(arch).reduced(d_model=256, head_dim=64, vocab=2048)
    params = Q_build(cfg).init(0, device="cpu")
    # the analytic count leaves out the norm scales
    n = {name: p.numel() for name, p in params.named_parameters()}
    norms = sum(v for k, v in n.items() if k.endswith(("scale", "_norm")))
    assert sum(n.values()) - norms == Q_count(cfg)
    assert params.embed.dtype == torch.bfloat16
    assert abs(params.embed.float().std().item() - 0.02) < 1e-3
    for layer in params.layers:
        w = layer.mlp.w_gate.float()
        assert abs(w.std().item() - 256 ** -0.5) < 0.05 * 256 ** -0.5
        if layer.kind == "rec":
            assert torch.equal(layer.rglru.lam, torch.full_like(layer.rglru.lam, 2.0))
            assert abs(layer.rglru.conv.float().std().item() - 0.1) < 0.02
    again = Q_build(cfg).init(0, device="cpu")
    assert torch.equal(params.layers[-1].mlp.w_down, again.layers[-1].mlp.w_down)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"])
def test_moe_builds_at_full_size_without_weights(arch):
    model = Q_build(Q_get_config(arch))
    assert model.cfg.pattern == ("moe",)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"])
def test_moe_init_matches_count_and_distributions(arch):
    """Router at 0.02, drawn in bfloat16 and kept in float32; expert weights
    at 1/sqrt(E), the reference's leading-axis fan-in; a shared expert (and
    the attention) at 1/sqrt(d)."""
    cfg = Q_get_config(arch).reduced(d_model=256, head_dim=64, vocab=2048)
    params = Q_build(cfg).init(0, device="cpu")
    n = {name: p.numel() for name, p in params.named_parameters()}
    norms = sum(v for k, v in n.items() if k.endswith(("scale", "_norm")))
    assert sum(n.values()) - norms == Q_count(cfg)
    E = cfg.moe.num_experts
    for layer in params.layers:
        moe = layer.moe
        assert moe.router.dtype == torch.float32
        assert torch.equal(moe.router, moe.router.bfloat16().float())
        assert abs(moe.router.std().item() - 0.02) < 0.05 * 0.02
        for w in (moe.w_gate, moe.w_up, moe.w_down):
            assert w.dtype == torch.bfloat16
            assert abs(w.float().std().item() - E ** -0.5) < 0.05 * E ** -0.5
        assert (moe.shared is not None) == bool(cfg.moe.shared_d_ff)
        if moe.shared is not None:
            w = moe.shared.w_gate.float()
            assert tuple(w.shape) == (256, cfg.moe.shared_d_ff)
            assert abs(w.std().item() - 256 ** -0.5) < 0.05 * 256 ** -0.5
    again = Q_build(cfg).init(0, device="cpu")
    assert torch.equal(params.layers[-1].moe.w_down,
                       again.layers[-1].moe.w_down)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"])
def test_params_from_numpy_carries_moe_tree(arch):
    """``groups.moe0.moe.{router, w_gate, w_up, w_down[, shared.*]}`` land
    in each layer's ``moe`` module, unstacked by group; a leaf of the wrong
    shape is refused."""
    cfg = R_get_config(arch).reduced()
    tree = to_numpy(R_build(cfg).init(jax.random.PRNGKey(0)))
    qcfg = Q_get_config(arch).reduced()
    params = params_from_numpy(qcfg, tree, device="cpu")
    sub = tree["groups"]["moe0"]["moe"]
    names = {"router", "w_gate", "w_up", "w_down"} | (
        {"shared"} if cfg.moe.shared_d_ff else set())
    assert set(sub) == names
    for g in range(cfg.n_groups):
        moe = params.layers[g].moe
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(getattr(moe, name).float().numpy(),
                                          sub[name][g])
        if moe.shared is not None:
            np.testing.assert_array_equal(moe.shared.w_down.float().numpy(),
                                          sub["shared"]["w_down"][g])
    bad = jax.tree.map(lambda a: a, tree)
    bad["groups"]["moe0"]["moe"]["w_up"] = sub["w_up"][:, :, :, :32]
    with pytest.raises(ValueError, match="w_up"):
        params_from_numpy(qcfg, bad, device="cpu")


def test_params_from_numpy_rejects_a_mismatched_tree():
    cfg = R_get_config("olmo-1b").reduced()
    tree = to_numpy(R_build(cfg).init(jax.random.PRNGKey(0)))
    qcfg = Q_get_config("olmo-1b").reduced()
    params_from_numpy(qcfg, tree, device="cpu")
    bad = dict(tree, embed=tree["embed"][:, :32])
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(qcfg, bad, device="cpu")
    short = {k: v for k, v in tree.items() if k != "embed"}
    with pytest.raises(KeyError, match="embed"):
        params_from_numpy(qcfg, short, device="cpu")
    extra = dict(tree, bogus=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="bogus"):
        params_from_numpy(qcfg, extra, device="cpu")
