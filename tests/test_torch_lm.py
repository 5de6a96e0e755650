"""The port's language-model serving path on the CPU, held against
``repro.models`` and ``repro.launch.serve``.

Every comparison runs the reference's parameters, carried over by
``params_from_numpy``, through both packages on the same numpy inputs:

* each layer (norms, rope, attention at prefill for each cache branch and
  at decode over a ring buffer, the GLU MLP, the RG-LRU block at prefill and
  decode) against ``repro.models.layers``;
* ``prefill`` + 8 ``decode_step``s of ``recurrentgemma-9b``, ``gemma2-9b``
  (softcap, local/global) and ``olmo-1b`` (``layernorm_np``; GQA as
  ``reduced()`` makes it, and MHA) at ``cfg.reduced()`` against
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
from repro_torch.launch import serve as Q_serve  # noqa: E402
from repro_torch.models import Model as Q_Model  # noqa: E402
from repro_torch.models import build_model as Q_build  # noqa: E402
from repro_torch.models import count_params as Q_count  # noqa: E402
from repro_torch.models import layers as Q_ly  # noqa: E402
from repro_torch.models import model_flops as Q_flops  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

LAYER_TOL = {"f32": 2e-5, "bf16": 2e-2}
MODEL_TOL = {"f32": 1e-4, "bf16": 6e-2}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def relerr(a, b):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    return np.max(np.abs(a - b)) / (np.abs(b).max() + 1e-6)


def both(x, dt):
    """The same values as a jnp array and a torch tensor of dtype ``dt``."""
    j = jnp.asarray(x, JNP[dt])
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(TORCH[dt])


def to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def carried(arch, dt="bf16", **over):
    """(cfg, reference params, port params) for ``arch`` at ``reduced()``;
    with ``dt="f32"`` both sets of weights are float32."""
    cfg = R_get_config(arch).reduced(**over)
    rp = R_build(cfg).init(jax.random.PRNGKey(0))
    qp = params_from_numpy(Q_get_config(arch).reduced(**over), to_numpy(rp),
                           device="cpu")
    if dt == "f32":
        rp = jax.tree.map(lambda x: x.astype(jnp.float32), rp)
        qp = qp.float()
    return cfg, rp, qp


def group_layer(cfg, rp, qp, i):
    """The reference's and the port's parameters of layer ``i`` of the
    first pattern group."""
    kp = f"{cfg.pattern[i]}{i}"
    return jax.tree.map(lambda a: a[0], rp["groups"][kp]), qp.layers[i]


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


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _float_cache(cache):
    return [Q_ly.AttnCache(c.k.float(), c.v.float(), c.pos)
            if isinstance(c, Q_ly.AttnCache) else (c[0], c[1].float())
            for c in cache]


MODEL_CASES = [("recurrentgemma-9b", {}), ("gemma2-9b", {}), ("olmo-1b", {}),
               ("olmo-1b", dict(n_kv_heads=4))]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch,over", MODEL_CASES,
                         ids=["recurrentgemma", "gemma2", "olmo", "olmo-mha"])
def test_prefill_and_decode_match_reference(arch, over, dt):
    """A 20-token prefill into a 32-slot cache (local layers: a 16-slot
    ring, rolled; global layers: scattered), then 8 decode steps on given
    tokens. Logits agree within the tolerance, and so do the greedy tokens
    wherever the reference's top-2 margin exceeds it."""
    cfg, rp, qp = carried(arch, dt, **over)
    rm, qm = R_build(cfg), Q_build(Q_get_config(arch).reduced(**over))
    B, L, S = 2, 20, 32
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, L + 8))
    toks = toks.astype(np.int32)
    rc, qc = rm.init_cache(B, S), qm.init_cache(B, S, device="cpu")
    if dt == "f32":
        rc = jax.tree.map(lambda a: a.astype(jnp.float32)
                          if a.dtype == jnp.bfloat16 else a, rc)
        qc = _float_cache(qc)
    rl, rc = jax.jit(rm.prefill)(rp, jnp.asarray(toks[:, :L]), rc)
    ql, qc = qm.prefill(qp, torch.tensor(toks[:, :L]), qc)
    want, got = [np.asarray(rl)], [ql.numpy()]
    step = jax.jit(rm.decode_step)
    for t in range(L, L + 8):
        rl, rc = step(rp, jnp.asarray(toks[:, t:t + 1]), rc, jnp.int32(t))
        ql, qc = qm.decode_step(qp, torch.tensor(toks[:, t:t + 1]), qc, t)
        want.append(np.asarray(rl))
        got.append(ql.numpy())
    want, got = np.stack(want), np.stack(got)          # [9, B, 1, V]
    assert got.dtype == np.float32 and got.shape == want.shape
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


def test_serve_matches_reference_counts(monkeypatch):
    """``requests <= batch``: no refill. With the reference's weights (from
    the same seed, carried over) both serve the same requests and decode
    the same number of tokens, in the same dict. Both count the slot padded
    with a zero prompt as a served request: 4 for 3 requests (ROADMAP
    Queue 3 records this quirk of the reference's scheduler, which the port
    keeps)."""
    want = R_serve(**SERVE_KW)
    cfg = R_get_config(SERVE_KW["arch"]).reduced(vocab=512)
    tree = to_numpy(R_build(cfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(Q_Model, "init", lambda self, seed=0, device=None:
                        params_from_numpy(self.cfg, tree, device))
    got = Q_serve.serve(**SERVE_KW, device="cpu")
    assert got.keys() == want.keys()
    assert got["requests_done"] == want["requests_done"] == 4
    assert got["decode_tokens"] == want["decode_tokens"] > 0


def _leaves(cache):
    out = []
    for c in cache:
        out += [c.k, c.v, c.pos] if isinstance(c, Q_ly.AttnCache) else list(c)
    return out


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
    before = [x.clone() for x in _leaves(cache)]
    prompt = rng.integers(2, 512, L).astype(np.int32)
    first = Q_serve.refill_slot(model, params, cache, s, prompt, B, S)
    fresh_logits, fresh = model.prefill(
        params, torch.tensor(np.tile(prompt, (B, 1))),
        model.init_cache(B, S, device="cpu"))
    torch.testing.assert_close(first, fresh_logits[s], rtol=0, atol=0)
    others = [j for j in range(B) if j != s]
    for old, now, new in zip(before, _leaves(cache), _leaves(fresh)):
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


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e",
                                  "xlstm-350m", "seamless-m4t-large-v2",
                                  "llava-next-34b"])
def test_unported_kinds_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Q_build(Q_get_config(arch))


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
