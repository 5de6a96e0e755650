"""The port's encoder-decoder and vision models on the CPU, held against
``repro.models`` and ``repro.launch.serve`` with the reference's parameters
(``params_from_numpy``) and the same numpy inputs:

* cross-attention (``kv_src``: K and V from the encoder memory, no RoPE,
  every key visible) at prefill and at decode, with the layer's own
  projection and with K/V projected once (``cross_kv``) as the stack keeps
  them, on Seamless's decoder layer and on a GQA layer with ``qk_norm``;
* the ``seamless-m4t-large-v2`` (audio frames through the encoder, then
  the decoder's cross-attention) and ``llava-next-34b`` (patch embeddings
  before the prompt) smoke models' prefill and 8 decode steps;
* ``serve`` of Seamless against the reference's counts;
* the vision model's decode index: the reference decodes from
  ``prompt_len`` (recorded here), which takes a prompt token's position;
  the port decodes from ``frontend_tokens + prompt_len``;
* the refill of a slot and the weight carrier for every new per-slot
  tensor and leaf (xLSTM states, cross K/V, encoder, frontend).

Tolerances as ``test_torch_lm.py`` holds them (``torch_lm_parity``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.serve as R_serve_mod  # noqa: E402
from repro.configs import get_config as R_get_config  # noqa: E402
from repro.models import build_model as R_build  # noqa: E402
from repro.models import layers as R_ly  # noqa: E402
from repro_torch.configs import get_config as Q_get_config  # noqa: E402
from repro_torch.launch import serve as Q_serve  # noqa: E402
from repro_torch.models import Model as Q_Model  # noqa: E402
from repro_torch.models import build_model as Q_build  # noqa: E402
from repro_torch.models import layers as Q_ly  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from torch_lm_parity import (LAYER_TOL, MODEL_TOL, TORCH,  # noqa: E402
                             assert_logits_close, both, carried,
                             frontend_inputs, group_layer, prefill_and_decode,
                             relerr, to_numpy)
from torch_parity import release_compiled_programs  # noqa: E402, F401

SEAMLESS, LLAVA = "seamless-m4t-large-v2", "llava-next-34b"
R_attn = jax.jit(R_ly.attn_apply, static_argnames=("cfg", "causal"))


# (arch, the layer's attention parameters to use as the cross-attention)
CROSS_CASES = [(SEAMLESS, "xattn"), ("qwen3-moe-30b-a3b", "attn")]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch,which", CROSS_CASES,
                         ids=["seamless-xattn", "qk-norm-gqa"])
def test_cross_attention_matches_reference(arch, which, dt):
    """12 queries (prefill) and 1 (decode) against a 10-position memory."""
    cfg, rp, qp = carried(arch, dt)
    rl, ql = group_layer(cfg, rp, qp, 0)
    rng = np.random.default_rng(1)
    mj, mt = both(rng.normal(size=(2, 10, 64)), dt)
    mpos = np.broadcast_to(np.arange(10), (2, 10)).astype(np.int32)
    kv = Q_ly.cross_kv(getattr(ql, which), mt, cfg, torch.tensor(mpos))
    for L in (12, 1):
        xj, xt = both(rng.normal(size=(2, L, 64)), dt)
        pos = np.full((2, L), 30, np.int32)       # must not matter
        want, none = R_attn(rl[which], xj, cfg=cfg,
                            positions=jnp.asarray(pos), causal=False,
                            kv_src=mj, kv_positions=jnp.asarray(mpos))
        got, qnone = Q_ly.attn_apply(getattr(ql, which), xt, cfg,
                                     positions=torch.tensor(pos),
                                     causal=False, kv_src=mt,
                                     kv_positions=torch.tensor(mpos))
        assert none is None and qnone is None
        assert got.dtype == TORCH[dt] and tuple(got.shape) == (2, L, 64)
        assert relerr(got, want) < LAYER_TOL[dt]
        cached = Q_ly.cross_attend(getattr(ql, which), xt, cfg, kv)
        assert relerr(cached, want) < LAYER_TOL[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", [SEAMLESS, LLAVA])
def test_frontend_model_matches_reference(arch, dt):
    """Prefill (Seamless: 8 frames through 2 encoder layers; LLaVA: 8
    patches before the prompt) + 8 decode steps."""
    want, got = prefill_and_decode(arch, dt)
    assert_logits_close(want, got, dt)


def _serve_both(monkeypatch, **kw):
    want = R_serve_mod.serve(**kw)
    cfg = R_get_config(kw["arch"]).reduced(vocab=512)
    tree = to_numpy(R_build(cfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(Q_Model, "init", lambda self, seed=0, device=None:
                        params_from_numpy(self.cfg, tree, device))
    return want, Q_serve.serve(**kw, device="cpu")


def test_serve_encdec_matches_reference_counts(monkeypatch):
    """``requests <= batch``: no refill. Both serve the same requests (the
    slot padded with a zero prompt counted, as in ``test_torch_lm.py``)
    and decode the same number of tokens, with the same frames."""
    want, got = _serve_both(monkeypatch, arch=SEAMLESS, preset="tiny",
                            requests=3, batch=4, prompt_len=24, max_new=8,
                            cache_len=64)
    assert got.keys() == want.keys()
    assert got["requests_done"] == want["requests_done"] == 4
    assert got["decode_tokens"] == want["decode_tokens"] > 0


class _RecordedJax:
    """``jax`` for ``repro.launch.serve``, recording the index of every
    decode step its ``serve`` runs."""

    def __init__(self, indices):
        self.indices = indices

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        compiled = jax.jit(fn)
        if getattr(fn, "__name__", "") != "decode_step":
            return compiled

        def recorded(*a):
            self.indices.append(int(a[3]))
            return compiled(*a)
        return recorded


def test_vision_decode_index_reference_fault(monkeypatch):
    """A vision model's prefill puts F patch tokens at positions 0 .. F-1
    and the L prompt tokens at F .. F+L-1. The reference's ``serve``
    decodes its first token at index L (recorded), so the step takes the
    RoPE position of prompt token L - F, writes its K/V over that token's
    cache slot, and sees none of the last F prompt tokens: its logits are
    not the model's next-token logits (the prefill of the prompt and the
    token), which decoding at F + L gives, in the reference and in the
    port, and which the port's ``serve`` does (ROADMAP Queue 3)."""
    ref_idx, port_idx = [], []
    monkeypatch.setattr(R_serve_mod, "jax", _RecordedJax(ref_idx))
    kw = dict(arch=LLAVA, preset="tiny", requests=2, batch=2, prompt_len=12,
              max_new=2, cache_len=48)
    R_serve_mod.serve(**kw)
    real = Q_Model.decode_step

    def port_step(self, params, token, cache, index, frontend_embeds=None):
        port_idx.append(int(index))
        return real(self, params, token, cache, index, frontend_embeds)
    monkeypatch.setattr(Q_Model, "decode_step", port_step)
    Q_serve.serve(**kw, device="cpu")
    F = R_get_config(LLAVA).reduced().frontend_tokens
    assert ref_idx[0] == 12 and port_idx[0] == F + 12

    cfg, rp, qp = carried(LLAVA, "f32")
    rm, qm = R_build(cfg), Q_build(Q_get_config(LLAVA).reduced())
    B, L, S = 2, 12, 48
    toks = np.random.default_rng(4).integers(2, cfg.vocab, (B, L + 1))
    toks = toks.astype(np.int32)
    fe, qfe = frontend_inputs(cfg, B, 5)
    f32 = lambda c: jax.tree.map(lambda a: a.astype(jnp.float32)
                                 if a.dtype == jnp.bfloat16 else a, c)
    prefill, step = jax.jit(rm.prefill), jax.jit(rm.decode_step)
    _, rc = prefill(rp, jnp.asarray(toks[:, :L]), f32(rm.init_cache(B, S)), fe)
    # the model's next-token logits: the prefill of prompt + token
    right, _ = prefill(rp, jnp.asarray(toks), f32(rm.init_cache(B, S)), fe)
    tok = jnp.asarray(toks[:, L:])
    at_l, rc_l = step(rp, tok, rc, jnp.int32(L), fe)
    at_fl, _ = step(rp, tok, rc, jnp.int32(F + L), fe)
    assert relerr(at_fl, right) < MODEL_TOL["f32"]
    assert relerr(at_l, right) > 0.1
    # slot L held prompt token L - F at position L; the step overwrote it
    old, new = rc["groups"]["dense0"], rc_l["groups"]["dense0"]
    np.testing.assert_array_equal(np.asarray(old.pos[:, :, L]), L)
    np.testing.assert_array_equal(np.asarray(new.pos[:, :, L]), L)
    assert not np.allclose(np.asarray(old.k[:, :, L]), np.asarray(new.k[:, :, L]))
    # the port's decode at F + L is the model's next-token logits
    qc = qm.init_cache(B, S, "cpu")
    qc = [Q_ly.AttnCache(c.k.float(), c.v.float(), c.pos) for c in qc]
    _, qc = qm.prefill(qp, torch.tensor(toks[:, :L]), qc, qfe)
    got, _ = qm.decode_step(qp, torch.tensor(toks[:, L:]), qc, F + L)
    assert relerr(got, right) < MODEL_TOL["f32"]


@pytest.mark.parametrize("arch", ["xlstm-350m", SEAMLESS, LLAVA])
def test_refill_slot_is_a_fresh_prefill(arch):
    """After a refill, every per-slot tensor of the refilled slot (the
    xLSTM states; the self and cross K/V of a ``dec`` layer; a vision
    model's cache with its prefix) equals a fresh prefill of its prompt,
    and the other slots are unchanged."""
    cfg = Q_get_config(arch).reduced(vocab=512)
    model = Q_build(cfg)
    params = model.init(0, device="cpu")
    B, L, S, s = 3, 16, 48, 1
    rng = np.random.default_rng(8)
    _, fe = frontend_inputs(cfg, B, 9)
    enc = cfg.frontend_tokens or None
    logits, cache = model.prefill(
        params, torch.tensor(rng.integers(2, 512, (B, L))),
        model.init_cache(B, S, "cpu", enc_len=enc), fe)
    tok = logits[:, -1].argmax(-1)[:, None]
    off = Q_serve.prefix_len(cfg) + L
    for t in range(off, off + 3):
        logits, cache = model.decode_step(params, tok, cache, t)
        tok = logits[:, -1].argmax(-1)[:, None]
    before = [x.clone() for x in Q_serve.cache_leaves(cache)]
    prompt = rng.integers(2, 512, L).astype(np.int32)
    first = Q_serve.refill_slot(model, params, cache, s, prompt, B, S, fe)
    fresh_logits, fresh = model.prefill(
        params, torch.tensor(np.tile(prompt, (B, 1))),
        model.init_cache(B, S, "cpu", enc_len=enc), fe)
    torch.testing.assert_close(first, fresh_logits[s], rtol=0, atol=0)
    others = [j for j in range(B) if j != s]
    now = Q_serve.cache_leaves(cache)
    assert len(now) == len(before) == len(Q_serve.cache_leaves(fresh))
    for old, cur, new in zip(before, now, Q_serve.cache_leaves(fresh)):
        assert torch.equal(cur[s], new[s])
        assert torch.equal(cur[others], old[others])


@pytest.mark.parametrize("arch", ["xlstm-350m", SEAMLESS, LLAVA])
def test_params_from_numpy_carries_new_leaves(arch):
    """``mlstm.*``, ``slstm.*`` (with ``w_ffn``), a ``dec`` layer's
    ``attn`` / ``norm_x`` / ``xattn``, ``enc_groups.enc0.*`` (unstacked per
    encoder layer), ``enc_final_norm`` and ``frontend_proj`` land where
    they belong; a misshaped leaf is refused."""
    cfg, rp, params = carried(arch)
    tree = to_numpy(rp)
    qcfg = Q_get_config(arch).reduced()
    g = cfg.n_groups - 1
    last = params.layers[g * len(cfg.pattern)]
    if arch == "xlstm-350m":
        sub = tree["groups"]["mlstm0"]["mlstm"]
        np.testing.assert_array_equal(last.mlstm.w_if.numpy(), sub["w_if"][g])
        ffn = tree["groups"]["slstm1"]["slstm"]["w_ffn"]["w_down"][g]
        np.testing.assert_array_equal(
            params.layers[-1].slstm.w_ffn.w_down.float().numpy(), ffn)
        bad = ("groups", "mlstm0", "mlstm", "wq")
    else:
        np.testing.assert_array_equal(params.frontend_proj.float().numpy(),
                                      tree["frontend_proj"])
        bad = ("frontend_proj",)
    if arch == SEAMLESS:
        np.testing.assert_array_equal(
            last.xattn.wk.float().numpy(), tree["groups"]["dec0"]["xattn"]["wk"][g])
        np.testing.assert_array_equal(
            last.norm_x.scale.numpy(), tree["groups"]["dec0"]["norm_x"]["scale"][g])
        enc = tree["enc_groups"]["enc0"]
        for e in range(cfg.n_enc_layers):
            np.testing.assert_array_equal(
                params.enc_layers[e].mlp.w_up.float().numpy(),
                enc["mlp"]["w_up"][e])
        np.testing.assert_array_equal(params.enc_final_norm.scale.numpy(),
                                      tree["enc_final_norm"]["scale"])
    node = tree
    for k in bad[:-1]:
        node = node[k]
    node[bad[-1]] = node[bad[-1]][..., :-1]
    with pytest.raises(ValueError, match=bad[-1]):
        params_from_numpy(qcfg, tree, device="cpu")
