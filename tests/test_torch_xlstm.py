"""The port's xLSTM blocks on the CPU, held against
``repro.models.layers`` and ``repro.models.Model`` with the reference's
parameters (``params_from_numpy``) and the same numpy inputs:

* the mLSTM block in each of its three forms: the quadratic parallel form
  (L = 12, without and with a state to materialise), the chunkwise form
  (``mlstm_chunk=8``, L = 32, without and with a state), and the recurrent
  step, after a prefill of each form and from a fresh state (whose
  stabiliser is -inf); and the three forms against each other in the port;
* the sLSTM block's prefill (from no state and from a fresh one) and its
  decode steps;
* the ``xlstm-350m`` smoke model's prefill and 8 decode steps, through the
  parallel and through the chunkwise form.

Tolerances as ``test_torch_lm.py`` holds them (``torch_lm_parity``).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as R_ly  # noqa: E402
from repro_torch.models import layers as Q_ly  # noqa: E402
from torch_lm_parity import (LAYER_TOL, TORCH, assert_logits_close,  # noqa: E402
                             both, carried, group_layer, prefill_and_decode,
                             relerr)
from torch_parity import release_compiled_programs  # noqa: E402, F401

ARCH = "xlstm-350m"
# the reference's blocks, each compiled once per shape (op-by-op eager
# dispatch compiles every primitive on its own, several times slower)
R_mlstm = jax.jit(R_ly.mlstm_apply, static_argnames="cfg")
R_slstm = jax.jit(R_ly.slstm_apply, static_argnames="cfg")


def _states_close(rs, qs, dt):
    assert len(rs) == len(qs)
    for r, q in zip(rs, qs):
        assert q.dtype == torch.float32 and tuple(q.shape) == r.shape
        np.testing.assert_array_equal(np.isneginf(q.numpy()),
                                      np.isneginf(np.asarray(r)))
        fin = np.isfinite(np.asarray(r))
        if fin.any():
            assert relerr(q[torch.tensor(fin)],
                          np.asarray(r)[fin]) < LAYER_TOL[dt]


def _decode_steps(rl, ql, cfg, rs, qs, rng, dt, steps=3):
    for _ in range(steps):
        xj, xt = both(rng.normal(size=(2, 1, 64)), dt)
        want, rs = R_mlstm(rl["mlstm"], xj, cfg=cfg, state=rs)
        got, qs = Q_ly.mlstm_apply(ql.mlstm, xt, cfg, state=qs)
        assert got.dtype == TORCH[dt]
        assert np.isfinite(got.float().numpy()).all()
        assert relerr(got, want) < LAYER_TOL[dt]
        _states_close(rs, qs, dt)


# (form, overrides of reduced(), prompt length; 0: decode from a fresh state)
MLSTM_FORMS = [("parallel", {}, 12), ("chunkwise", dict(mlstm_chunk=8), 32),
               ("recurrent", {}, 0)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form,over,L", MLSTM_FORMS,
                         ids=[f[0] for f in MLSTM_FORMS])
def test_mlstm_forms_match_reference(form, over, L, dt):
    cfg, rp, qp = carried(ARCH, dt, **over)
    rl, ql = group_layer(cfg, rp, qp, 0)
    rng = np.random.default_rng(1)
    rs = R_ly.mlstm_state(cfg, 2)
    qs = Q_ly.mlstm_state(cfg, 2)
    _states_close(rs, qs, "f32")
    if L:
        xj, xt = both(rng.normal(size=(2, L, 64)), dt)
        want, none = R_mlstm(rl["mlstm"], xj, cfg=cfg)
        got, qnone = Q_ly.mlstm_apply(ql.mlstm, xt, cfg)
        assert none is None and qnone is None
        assert got.dtype == TORCH[dt] and tuple(got.shape) == (2, L, 64)
        assert relerr(got, want) < LAYER_TOL[dt]
        want, rs = R_mlstm(rl["mlstm"], xj, cfg=cfg, state=rs)
        got, qs = Q_ly.mlstm_apply(ql.mlstm, xt, cfg, state=qs)
        assert relerr(got, want) < LAYER_TOL[dt]
        _states_close(rs, qs, dt)
    _decode_steps(rl, ql, cfg, rs, qs, rng, dt)


def test_mlstm_forms_agree_in_the_port():
    """The chunkwise form's output and state equal the parallel form's and
    the recurrent steps' on the same float32 input (the stabilisers make
    the three forms the same function)."""
    cfg, _, qp = carried(ARCH, "f32", mlstm_chunk=8)
    ql = qp.layers[0].mlstm
    x = torch.tensor(np.random.default_rng(2).normal(size=(2, 24, 64)),
                     dtype=torch.float32)
    st = lambda: Q_ly.mlstm_state(cfg, 2)
    h_chunk, s_chunk = Q_ly.mlstm_apply(ql, x, cfg, state=st())
    par = dataclasses.replace(cfg, mlstm_chunk=0)
    h_par, s_par = Q_ly.mlstm_apply(ql, x, par, state=st())
    s = st()
    steps = []
    for t in range(24):
        h, s = Q_ly.mlstm_apply(ql, x[:, t:t + 1], cfg, state=s)
        steps.append(h)
    h_rec = torch.cat(steps, 1)
    for h in (h_par, h_rec):
        assert relerr(h_chunk, h) < 1e-5
    # the states agree once each is scaled by its own stabiliser
    for s_other in (s_par, s):
        for a, b in zip(s_chunk[:2], s_other[:2]):
            scale = torch.exp(s_chunk[2] - s_other[2])
            while scale.dim() < a.dim():
                scale = scale[..., None]
            assert relerr(a * scale, b) < 1e-5


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_slstm_prefill_and_decode_match_reference(dt):
    cfg, rp, qp = carried(ARCH, dt)
    rl, ql = group_layer(cfg, rp, qp, 1)
    rng = np.random.default_rng(3)
    xj, xt = both(rng.normal(size=(2, 12, 64)), dt)
    want, rs = R_slstm(rl["slstm"], xj, cfg=cfg)
    got, qs = Q_ly.slstm_apply(ql.slstm, xt, cfg)
    assert got.dtype == TORCH[dt] and tuple(got.shape) == (2, 12, 64)
    assert relerr(got, want) < LAYER_TOL[dt]
    _states_close(rs, qs, dt)
    want, rs = R_slstm(rl["slstm"], xj, cfg=cfg,
                                state=R_ly.slstm_state(cfg, 2))
    got, qs = Q_ly.slstm_apply(ql.slstm, xt, cfg,
                               state=Q_ly.slstm_state(cfg, 2))
    assert relerr(got, want) < LAYER_TOL[dt]
    for _ in range(3):
        xj, xt = both(rng.normal(size=(2, 1, 64)), dt)
        want, rs = R_slstm(rl["slstm"], xj, cfg=cfg, state=rs)
        got, qs = Q_ly.slstm_apply(ql.slstm, xt, cfg, state=qs)
        assert relerr(got, want) < LAYER_TOL[dt]
        _states_close(rs, qs, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form,over,L", [("parallel", {}, 20),
                                         ("chunkwise", dict(mlstm_chunk=8),
                                          24)], ids=["parallel", "chunkwise"])
def test_xlstm_model_matches_reference(form, over, L, dt):
    """Prefill + 8 decode steps of the ``xlstm-350m`` smoke model (mLSTM
    and sLSTM blocks alternating)."""
    want, got = prefill_and_decode(ARCH, dt, L=L, **over)
    assert_logits_close(want, got, dt)


def test_xlstm_cache_is_per_slot_state():
    """The model's cache holds ``(C, n, m)`` for each mLSTM layer and ``(c,
    n, h, m)`` for each sLSTM layer, float32 with the batch on axis 0, the
    stabilisers at -inf."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(ARCH).reduced()
    cache = build_model(cfg).init_cache(3, 16, device="cpu")
    assert [len(c) for c in cache] == [3, 4] * cfg.n_groups
    for entry in cache:
        for t in entry:
            assert t.dtype == torch.float32 and t.shape[0] == 3
        assert torch.isneginf(entry[-1]).all()
