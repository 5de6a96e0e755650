"""Shared helpers of the PyTorch port's language-model parity suites
(``test_torch_xlstm.py``, ``test_torch_encdec.py``): the reference's
parameters carried over to the port, inputs made once and given to both
packages, float32 copies of both packages' caches, and a prefill + decode
run of both models on the same tokens (and frontend embeddings).

Tolerances, as ``test_torch_lm.py`` holds them (relative error, max |a - b|
/ max |b|): 2e-5 for a layer and 1e-4 for a model with float32 weights and
caches; 2e-2 for a layer and 6e-2 for a model in bfloat16, where the two
frameworks round at other places.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as R_get_config
from repro.models import build_model as R_build
from repro_torch.configs import get_config as Q_get_config
from repro_torch.models import build_model as Q_build
from repro_torch.models import params_from_numpy
from repro_torch.models.layers import AttnCache
from repro_torch.models.stacks import frontend_dim, prefix_len

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


@functools.cache
def _reference_params(arch, over):
    # the reference's init runs op by op, compiling each op at first use
    # (seconds a model); the arrays are immutable, so every suite of the
    # process shares them
    return R_build(R_get_config(arch).reduced(**dict(over))).init(
        jax.random.PRNGKey(0))


def carried(arch, dt="bf16", **over):
    """(cfg, reference params, port params) for ``arch`` at ``reduced()``;
    with ``dt="f32"`` both sets of weights are float32."""
    cfg = R_get_config(arch).reduced(**over)
    rp = _reference_params(arch, tuple(sorted(over.items())))
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


def float_cache(entry):
    """A port cache (or a part of it) with every bfloat16 tensor made
    float32."""
    if isinstance(entry, AttnCache):
        return AttnCache(entry.k.float(), entry.v.float(), entry.pos)
    if isinstance(entry, (list, tuple)):
        return type(entry)(float_cache(e) for e in entry)
    return entry.float() if entry.dtype == torch.bfloat16 else entry


def frontend_inputs(cfg, B, seed):
    """Frontend embeddings [B, frontend_tokens, frontend_dim] in bfloat16,
    as a jnp array and a torch tensor (``(None, None)`` without a
    frontend)."""
    if cfg.frontend is None:
        return None, None
    x = np.random.default_rng(seed).normal(
        size=(B, cfg.frontend_tokens, frontend_dim(cfg)))
    return both(x, "bf16")


def prefill_and_decode(arch, dt, *, B=2, L=20, S=48, steps=8, **over):
    """A prefill of L tokens into an S-slot cache, then ``steps`` decode
    steps on given tokens, through both packages with the reference's
    weights (a vision model's patches before the prompt, so its steps start
    at ``frontend_tokens + L``). Returns (reference logits, port logits),
    each [steps + 1, B, 1, V] float32."""
    cfg, rp, qp = carried(arch, dt, **over)
    rm, qm = R_build(cfg), Q_build(Q_get_config(arch).reduced(**over))
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, L + steps))
    toks = toks.astype(np.int32)
    fe, qfe = frontend_inputs(cfg, B, 8)
    enc = cfg.frontend_tokens or None
    rc, qc = rm.init_cache(B, S, enc), qm.init_cache(B, S, "cpu", enc_len=enc)
    if dt == "f32":
        rc = jax.tree.map(lambda a: a.astype(jnp.float32)
                          if a.dtype == jnp.bfloat16 else a, rc)
        qc = float_cache(qc)
    rl, rc = jax.jit(rm.prefill)(rp, jnp.asarray(toks[:, :L]), rc, fe)
    ql, qc = qm.prefill(qp, torch.tensor(toks[:, :L]), qc, qfe)
    want, got = [np.asarray(rl)], [ql.numpy()]
    step = jax.jit(rm.decode_step)
    off = prefix_len(cfg)
    for t in range(L, L + steps):
        rl, rc = step(rp, jnp.asarray(toks[:, t:t + 1]), rc,
                      jnp.int32(off + t), fe)
        ql, qc = qm.decode_step(qp, torch.tensor(toks[:, t:t + 1]), qc,
                                off + t)
        want.append(np.asarray(rl))
        got.append(ql.numpy())
    return np.stack(want), np.stack(got)


def assert_logits_close(want, got, dt):
    """Each step's logits within the model tolerance, and the greedy
    tokens equal wherever the reference's top-2 margin exceeds it."""
    assert got.dtype == np.float32 and got.shape == want.shape
    tol = MODEL_TOL[dt]
    for i, (w, g) in enumerate(zip(want, got)):
        assert relerr(g, w) < tol, i
    top2 = np.sort(want, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol * np.abs(want).max(-1)
    same = want.argmax(-1) == got.argmax(-1)
    assert clear.any() and same[clear].all()
