"""Model layers of the port: ``nn.Module``s holding the parameters, and
plain functions on tensors that mirror ``repro.models.layers``.

The reference's layers compute attention and the RG-LRU scan in jnp
(``chunked_attention`` at prefill, an einsum at decode,
``jax.lax.associative_scan`` for the recurrence); its Pallas kernels
implement the same math. The port's layers call the hand-written kernels at
those places: :func:`attn_apply` runs ``kernels.flash_attention`` at
prefill and ``kernels.decode_attention`` at decode, :func:`rglru_apply`
runs ``kernels.rg_lru`` at prefill, and :func:`moe_apply` runs the three
expert products through ``kernels.grouped_matmul`` (the reference's
einsums). On CPU tensors the kernels' plain versions run instead. The
large projections (``x @ w``) are ``torch.matmul``, as the reference leaves
them to XLA; a bfloat16 product returns bfloat16, as in JAX.

Parameters keep the reference's names and dtypes (bfloat16 weights, float32
norm scales and ``lam``), so :func:`repro_torch.models.params_from_numpy`
can carry a reference parameter tree over leaf by leaf.

Where the port differs from the reference:

* decode (:func:`attn_apply` with a cache and one token) writes the new key
  and value into the cache in place and returns that cache; the reference
  returns an updated copy. Prefill returns new tensors and leaves the cache
  it is given untouched.
* the decode softmax weights stay in float32 for the product with V; the
  reference's einsum path rounds them to bfloat16 first.
* the MoE layer has no expert-parallel (``shard_map``) branch: the port
  runs on one card.
* cross-attention splits into :func:`cross_kv` (K and V of the encoder
  memory, no RoPE) and :func:`cross_attend` (the queries against them), so
  the stack projects the memory once at prefill and keeps its K and V in
  the cache; the reference re-projects the memory at every decode step.
  :func:`attn_apply` with ``kv_src`` runs both, as the reference does.
* the xLSTM blocks (:func:`mlstm_apply`, :func:`slstm_apply`) have no TPU
  kernel: they are torch ops, the sLSTM a Python loop over the sequence.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import decode_attention as _decode
from ..kernels import flash_attention as _flash
from ..kernels import grouped_matmul as _gmm
from ..kernels import rg_lru as _rg_lru
from .config import ArchConfig


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _normal_(p: nn.Parameter, gen: torch.Generator, scale: float) -> None:
    """bfloat16 (or float32) normals at ``scale``, drawn in float32 as the
    reference's ``_dense_init`` draws them."""
    p.copy_(torch.randn(p.shape, generator=gen, device=p.device,
                        dtype=torch.float32) * scale)


def _dense_init_(p: nn.Parameter, gen: torch.Generator, scale=None) -> None:
    _normal_(p, gen, scale if scale is not None else 1.0 / math.sqrt(p.shape[0]))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """RMSNorm / LayerNorm with a float32 scale, or the non-parametric
    LayerNorm (``layernorm_np``, olmo) with none."""

    def __init__(self, cfg: ArchConfig, d: int, device=None):
        super().__init__()
        self.kind = cfg.norm
        self.scale = (None if cfg.norm == "layernorm_np"
                      else _param((d,), torch.float32, device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        if self.scale is not None:
            self.scale.fill_(1.0)

    def forward(self, x):
        return norm_apply(self.kind, self.scale, x)


def norm_apply(kind: str, scale, x):
    """The reference's ``norm_apply``: computed in float32, cast back."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
        y = y * scale
    else:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        if kind == "layernorm":
            y = y * scale
    return y.to(x.dtype)


def _rms(x):
    xf = x.float()
    return xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: [B, L, H, hd]; positions: [B, L] absolute token positions."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                 # [B, L, half]
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional local window / softcap / cache)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AttnCache:
    """KV cache. ``k``/``v``: [B, S_cache, Kv, hd]; ``pos``: [B, S_cache]
    int32 absolute positions (-1 = empty), a ring buffer for local layers."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        bf = torch.bfloat16
        self.wq = _param((d, hq * hd), bf, device)
        self.wk = _param((d, hkv * hd), bf, device)
        self.wv = _param((d, hkv * hd), bf, device)
        self.wo = _param((hq * hd, d), bf, device)
        self.q_norm = _param((hd,), torch.float32, device) if cfg.qk_norm else None
        self.k_norm = _param((hd,), torch.float32, device) if cfg.qk_norm else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            _dense_init_(w, gen)
        for s in (self.q_norm, self.k_norm):
            if s is not None:
                s.fill_(1.0)


def attn_apply(p: Attention, x, cfg: ArchConfig, *, positions,
               causal: bool = True, window: int = 0,
               cache: AttnCache | None = None, write_index: int | None = None,
               kv_src=None, kv_positions=None):
    """Self-attention (GQA), or cross-attention over ``kv_src``. Returns
    (out, new_cache).

    x: [B, L, d]; positions: [B, L] absolute positions, consecutive along L
    (the stack's are ``0 .. L-1`` at prefill and the decode index at
    decode; the masks depend only on their differences). With a cache and
    one token (decode), the new K/V go into slot ``write_index % S`` in
    place and ``decode_attention`` attends over the cache for a query at
    position ``write_index`` (the reference's ``decode_step`` passes the
    same index as the position). Otherwise ``flash_attention`` attends over
    the sequence, and with a cache the last S positions land in a new one.

    With ``kv_src`` [B, S, d] (the encoder memory, at ``kv_positions``), K
    and V are projected from it and every query sees every key, with no
    RoPE on either side and no cache, as in the reference.
    """
    if kv_src is not None:
        return cross_attend(p, x, cfg, cross_kv(p, kv_src, cfg,
                                                kv_positions)), None
    B, L, _ = x.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p.wq).reshape(B, L, hq, hd)
    k = (x @ p.wk).reshape(B, L, hkv, hd)
    v = (x @ p.wv).reshape(B, L, hkv, hd)
    if cfg.qk_norm:
        q = (_rms(q) * p.q_norm).to(x.dtype)
        k = (_rms(k) * p.k_norm).to(x.dtype)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    scale = cfg.attn_scale_override or (1.0 / math.sqrt(hd))

    if cache is not None and L == 1:
        # decode: ring-write the new KV at index % S, attend over the cache
        idx = int(write_index) % cache.k.shape[1]
        cache.k[:, idx] = k[:, 0]
        cache.v[:, idx] = v[:, 0]
        cache.pos[:, idx] = positions[:, 0].to(torch.int32)
        out = _decode.decode_attention(
            q[:, 0], cache.k, cache.v, cache.pos, int(write_index),
            n_q_heads=hq, n_kv_heads=hkv, window=window,
            softcap=cfg.attn_softcap, scale=scale)
        return out.reshape(B, 1, hq * hd) @ p.wo, cache

    new_cache = None
    if cache is not None:
        # prefill: the last S positions land in the cache
        S = cache.k.shape[1]
        pos32 = positions.to(torch.int32)
        if S == L:
            new_cache = AttnCache(k, v, pos32)
        elif S < L:
            # a ring smaller than the sequence: position p lives in slot
            # p % S, a roll of the tail
            shift = (L - S) % S
            new_cache = AttnCache(torch.roll(k[:, -S:], shift, 1),
                                  torch.roll(v[:, -S:], shift, 1),
                                  torch.roll(pos32[:, -S:], shift, 1))
        else:
            new_cache = AttnCache(cache.k.clone(), cache.v.clone(),
                                  cache.pos.clone())
            new_cache.k[:, :L] = k
            new_cache.v[:, :L] = v
            new_cache.pos[:, :L] = pos32
    qf = q.permute(0, 2, 1, 3).reshape(B * hq, L, hd)
    kf = k.permute(0, 2, 1, 3).reshape(B * hkv, L, hd)
    vf = v.permute(0, 2, 1, 3).reshape(B * hkv, L, hd)
    of = _flash.flash_attention(qf, kf, vf, n_q_heads=hq, n_kv_heads=hkv,
                                causal=causal, window=window,
                                softcap=cfg.attn_softcap, scale=scale)
    out = of.reshape(B, hq, L, hd).permute(0, 2, 1, 3).reshape(B, L, hq * hd)
    return out @ p.wo, new_cache


# a query index at or past every position: decode_attention then sees every
# slot that holds a position (the encoder memory's 0 .. S-1)
ALL_POSITIONS = 2 ** 31 - 1


def cross_kv(p: Attention, src, cfg: ArchConfig, positions) -> AttnCache:
    """K and V of the encoder memory ``src`` [B, S, d] (no RoPE: the
    reference rotates only self-attention) with its ``positions`` [B, S],
    in the cache layout that :func:`cross_attend` reads."""
    B, S, _ = src.shape
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    k = (src @ p.wk).reshape(B, S, hkv, hd)
    v = (src @ p.wv).reshape(B, S, hkv, hd)
    if cfg.qk_norm:
        k = (_rms(k) * p.k_norm).to(src.dtype)
    return AttnCache(k, v, positions.to(torch.int32).contiguous())


def cross_attend(p: Attention, x, cfg: ArchConfig, kv: AttnCache):
    """Queries of ``x`` [B, L, d] against every key of ``kv`` (non-causal,
    no window, no RoPE). One token goes through ``decode_attention`` over
    ``kv`` (every slot holding a position is visible), a sequence through
    ``flash_attention`` with ``causal=False`` (Lq = L, S = the memory's
    length)."""
    B, L, _ = x.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p.wq).reshape(B, L, hq, hd)
    if cfg.qk_norm:
        q = (_rms(q) * p.q_norm).to(x.dtype)
    scale = cfg.attn_scale_override or (1.0 / math.sqrt(hd))
    kw = dict(n_q_heads=hq, n_kv_heads=hkv, softcap=cfg.attn_softcap,
              scale=scale)
    if L == 1:
        out = _decode.decode_attention(q[:, 0], kv.k, kv.v, kv.pos,
                                       ALL_POSITIONS, **kw)
        return out.reshape(B, 1, hq * hd) @ p.wo
    S = kv.k.shape[1]
    qf = q.permute(0, 2, 1, 3).reshape(B * hq, L, hd)
    kf = kv.k.permute(0, 2, 1, 3).reshape(B * hkv, S, hd)
    vf = kv.v.permute(0, 2, 1, 3).reshape(B * hkv, S, hd)
    of = _flash.flash_attention(qf, kf, vf, causal=False, **kw)
    out = of.reshape(B, hq, L, hd).permute(0, 2, 1, 3).reshape(B, L, hq * hd)
    return out @ p.wo


def make_cache(cfg: ArchConfig, batch: int, seq_len: int, window: int = 0,
               device=None, dtype=torch.bfloat16) -> AttnCache:
    S = min(seq_len, window) if window > 0 else seq_len
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    return AttnCache(
        k=torch.zeros((batch, S, hkv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, S, hkv, hd), dtype=dtype, device=device),
        pos=torch.full((batch, S), -1, dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# GLU MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None, d_ff: int | None = None):
        super().__init__()
        d, ff, bf = cfg.d_model, d_ff or cfg.d_ff, torch.bfloat16
        self.w_gate = _param((d, ff), bf, device)
        self.w_up = _param((d, ff), bf, device)
        self.w_down = _param((ff, d), bf, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            _dense_init_(w, gen)


def _act(cfg: ArchConfig, x):
    # jax.nn.gelu is the tanh approximation by default
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def mlp_apply(p: MLP, x, cfg: ArchConfig):
    return (_act(cfg, x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


# ---------------------------------------------------------------------------
# Mixture of Experts (sorted capacity dispatch)
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        m, bf = cfg.moe, torch.bfloat16
        d, ff, E = cfg.d_model, m.expert_d_ff, m.num_experts
        self.router = _param((d, E), torch.float32, device)
        self.w_gate = _param((E, d, ff), bf, device)
        self.w_up = _param((E, d, ff), bf, device)
        self.w_down = _param((E, ff, d), bf, device)
        self.shared = MLP(cfg, device, d_ff=m.shared_d_ff) if m.shared_d_ff \
            else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        # the reference's router is drawn at 0.02 in bfloat16 and kept in
        # float32; its expert weights take the leading (expert) axis as the
        # fan-in, 1/sqrt(E), a quirk the port keeps (ROADMAP Queue 3)
        _normal_(self.router, gen, 0.02)
        self.router.copy_(self.router.to(torch.bfloat16))
        for w in (self.w_gate, self.w_up, self.w_down):
            _dense_init_(w, gen)
        if self.shared is not None:
            self.shared.reset_parameters(gen)


def moe_route(p: MoE, x, cfg: ArchConfig):
    """The router: float32 logits, top-k experts in descending order of
    logit, and a softmax over the k values. x: [..., d] -> (gates [..., k]
    float32, expert ids [..., k] int64)."""
    vals, idx = torch.topk(x.float() @ p.router, cfg.moe.top_k, dim=-1)
    return torch.softmax(vals, dim=-1), idx


def moe_apply(p: MoE, x, cfg: ArchConfig):
    """Token-sorted capacity dispatch, as ``repro.models.layers.moe_apply``
    without its expert-parallel branch. x: [B, L, d] -> [B, L, d].

    With L > 1 each row of the batch (or each ``moe_chunk`` of a row)
    dispatches on its own, with a capacity of ``ceil(L k / E * factor)``
    per expert; at decode (L == 1) the batch's tokens dispatch together.
    """
    B, L, d = x.shape
    if L == 1:
        out = _moe_dispatch(p, x.reshape(1, B, d), cfg)
    else:
        xr = x
        if cfg.moe_chunk and L > cfg.moe_chunk and L % cfg.moe_chunk == 0:
            xr = x.reshape(B * (L // cfg.moe_chunk), cfg.moe_chunk, d)
        out = _moe_dispatch(p, xr, cfg)
    out = out.reshape(B, L, d)
    if p.shared is not None:
        out = out + mlp_apply(p.shared, x, cfg)
    return out


def _moe_dispatch(p: MoE, x, cfg: ArchConfig):
    """Sorted capacity dispatch of each of the R rows of x: [R, T, d].

    The reference's ``_moe_dispatch_batched`` (rows of the batch) and its
    ``_moe_dispatch`` (the decode batch as one row) in one: assignments are
    sorted stably by expert, the first C of each expert in a row are kept,
    the rest dropped. Kept tokens are scattered into an [E, R, C, d] buffer
    (one trash row takes the dropped ones), so the expert GLU is three
    grouped matmuls of G = E groups and M = R * C rows; rows of the batch
    never mix, as in the reference's [R, E, C, d] einsums. The combine adds
    each slot's output, times its gate in the working dtype, into its
    token's row in slot order, which for a token is ascending expert order
    as in the reference. Everything stays on the device.
    """
    R, T, d = x.shape
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    C = int(max(1, math.ceil(T * K / E * m.capacity_factor)))
    gates, idx = moe_route(p, x, cfg)                     # [R, T, K]
    ids = idx.reshape(R, T * K)
    order = torch.argsort(ids, dim=1, stable=True)
    ids_s = torch.gather(ids, 1, order)
    gate_s = torch.gather(gates.reshape(R, T * K), 1, order)
    pos = (torch.arange(T * K, device=x.device)
           - torch.searchsorted(ids_s, ids_s))            # place in expert
    keep = pos < C
    row = torch.arange(R, device=x.device)[:, None]
    n_slots = E * R * C                                   # + 1 trash slot
    slot = torch.where(keep, (ids_s * R + row) * C + pos, n_slots).reshape(-1)
    src = (row * T + order // K).reshape(-1)              # token of x's rows

    xe = x.new_zeros(n_slots + 1, d)
    xe[slot] = x.reshape(R * T, d)[src]
    xe = xe[:-1].view(E, R * C, d)
    h = _act(cfg, _gmm.grouped_matmul(xe, p.w_gate)) * \
        _gmm.grouped_matmul(xe, p.w_up)
    ye = _gmm.grouped_matmul(h, p.w_down).view(n_slots, d)

    # slot -> token row (R * T, the trash row, for empty slots) and gate
    tok = torch.full((n_slots + 1,), R * T, dtype=torch.int64, device=x.device)
    tok[slot] = src
    gate = torch.zeros(n_slots + 1, dtype=torch.float32, device=x.device)
    gate[slot] = gate_s.reshape(-1)
    out = ye.new_zeros(R * T + 1, d)
    out.index_add_(0, tok[:-1], ye * gate[:-1, None].to(ye.dtype))
    return out[:-1].view(R, T, d)


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------

class RGLRU(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, bf = cfg.d_model, torch.bfloat16
        w = cfg.lru_width or d
        self.w_in = _param((d, w), bf, device)
        self.w_gate_branch = _param((d, w), bf, device)
        self.conv = _param((cfg.conv_width, w), bf, device)
        self.w_a = _param((w, w), bf, device)
        self.w_x = _param((w, w), bf, device)
        self.lam = _param((w,), torch.float32, device)
        self.w_out = _param((w, d), bf, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        # the reference's draw order: w_in, w_gate_branch, conv, w_a, w_x,
        # w_out; lam = 2 (softplus(2) ~ a healthy decay)
        _dense_init_(self.w_in, gen)
        _dense_init_(self.w_gate_branch, gen)
        _dense_init_(self.conv, gen, scale=0.1)
        _dense_init_(self.w_a, gen)
        _dense_init_(self.w_x, gen)
        _dense_init_(self.w_out, gen)
        self.lam.fill_(2.0)


def _rglru_coeffs(p: RGLRU, u):
    """u: [..., w] post-conv activations -> (a, gated input), both float32."""
    c = 8.0
    uf = u.float()
    r = torch.sigmoid(uf @ p.w_a.float())
    i = torch.sigmoid(uf @ p.w_x.float())
    a = torch.exp(-c * F.softplus(p.lam) * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-8)) * (i * uf)
    return a, gated


def rglru_apply(p: RGLRU, x, cfg: ArchConfig, *, state=None,
                conv_state=None):
    """x: [B, L, d]. Full-sequence mode (prefill, zero initial state) runs
    the recurrence ``h_t = a_t h_{t-1} + b_t`` through ``kernels.rg_lru``;
    single-step mode (L == 1 with a state) does the O(1) decode update.
    Returns (out, (state [B, w] float32, conv_state [B, cw, w]))."""
    B, L, _ = x.shape
    u = x @ p.w_in                                          # [B, L, w]
    gate = F.gelu(x @ p.w_gate_branch, approximate="tanh")
    cw = cfg.conv_width
    if state is None or L > 1:
        # causal temporal conv via shifted adds, in the working dtype
        conv = torch.zeros_like(u)
        for i in range(cw):
            shifted = F.pad(u, (0, 0, i, 0))[:, :L]
            conv = conv + shifted * p.conv[cw - 1 - i]
        a, b = _rglru_coeffs(p, conv)
        hh = _rg_lru.rg_lru(a, b)
        new_state = hh[:, -1]
        # the last conv_width inputs become the decode-time conv state
        new_conv = F.pad(u, (0, 0, cw - 1, 0))[:, L - 1:L - 1 + cw]
    else:
        # decode: roll the conv state, apply the conv (float32 sums, as an
        # XLA dot of bfloat16), one recurrence step
        conv_state = torch.cat([conv_state[:, 1:], u], dim=1)   # [B, cw, w]
        conv = (conv_state.float() * p.conv.float()).sum(1)[:, None]
        a, b = _rglru_coeffs(p, conv.to(u.dtype))
        hh = a * state[:, None] + b
        new_state = hh[:, -1]
        new_conv = conv_state
    out = (hh.to(x.dtype) * gate) @ p.w_out
    return out, (new_state, new_conv)


def rglru_state(cfg: ArchConfig, batch: int, device=None):
    w = cfg.lru_width or cfg.d_model
    return (torch.zeros((batch, w), dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.conv_width, w), dtype=torch.bfloat16,
                        device=device))


# ---------------------------------------------------------------------------
# xLSTM blocks
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """Matrix-memory LSTM block: up-projection to ``dp = d * proj_factor``,
    q/k/v over ``n_heads`` heads of ``dp / n_heads``, float32 input and
    forget gates (``w_if``), down-projection."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, bf = cfg.d_model, torch.bfloat16
        dp = int(d * cfg.proj_factor)
        self.w_up = _param((d, dp), bf, device)
        self.w_gate = _param((d, dp), bf, device)
        self.wq = _param((dp, dp), bf, device)
        self.wk = _param((dp, dp), bf, device)
        self.wv = _param((dp, dp), bf, device)
        self.w_if = _param((dp, 2 * cfg.n_heads), torch.float32, device)
        self.w_down = _param((dp, d), bf, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        # the gates at 0.02, drawn in bfloat16 and kept in float32
        for w in (self.w_up, self.w_gate, self.wq, self.wk, self.wv):
            _dense_init_(w, gen)
        _normal_(self.w_if, gen, 0.02)
        self.w_if.copy_(self.w_if.to(torch.bfloat16))
        _dense_init_(self.w_down, gen)


def _causal_log_weights(F, i_pre):
    """``D[b, t, s, h] = F_t - F_s + i_s`` for s <= t, -inf above the
    diagonal: the log weight of step s's input in step t's memory.
    F, i_pre: [B, L, H] float32 -> [B, L, L, H]."""
    L = F.shape[1]
    D = F[:, :, None, :] - F[:, None, :, :] + i_pre[:, None, :, :]
    causal = torch.ones(L, L, dtype=torch.bool, device=F.device).tril()
    return D.masked_fill(~causal[None, :, :, None], -math.inf)


def mlstm_apply(p: MLSTM, x, cfg: ArchConfig, *, state=None):
    """The reference's ``mlstm_apply``: x [B, L, d] -> (out, new_state),
    the state ``(C [B, H, hd, hd], n [B, H, hd], m [B, H])`` float32.

    Three forms, which agree as the reference's do: the chunkwise form
    (L > 1, ``mlstm_chunk`` nonzero, L a multiple of it and longer), which
    carries the state over chunks (from ``state`` when given); the
    quadratic parallel form (otherwise, L > 1 or no state), which assumes a
    zero initial state and, given a state, materialises the one after the
    last token; and the recurrent step (L == 1 with a state). Projections
    stay in x's dtype, gates and state in float32; the stabiliser ``m``
    starts at -inf, and the parallel form's state maxes over a row with
    -inf read as -1e30, as the reference does.
    """
    B, L, _ = x.shape
    H = cfg.n_heads
    up = x @ p.w_up
    gate = F.silu(x @ p.w_gate)
    dp = up.shape[-1]
    hd = dp // H
    q = (up @ p.wq).reshape(B, L, H, hd)
    k = (up @ p.wk).reshape(B, L, H, hd) / math.sqrt(hd)
    v = (up @ p.wv).reshape(B, L, H, hd)
    gifs = (up.float() @ p.w_if).reshape(B, L, H, 2)
    i_pre, f_pre = gifs[..., 0], gifs[..., 1]
    log_f = -F.softplus(-f_pre)                          # log sigmoid

    chunk = cfg.mlstm_chunk
    if L > 1 and chunk and L > chunk and L % chunk == 0:
        h, new_state = _mlstm_chunkwise(
            q, k, v, i_pre, log_f,
            state if state is not None else mlstm_state_like(B, H, hd,
                                                             x.device),
            chunk)
        if state is None:
            new_state = None
    elif state is None or L > 1:
        # parallel (quadratic) form, from a zero state
        D = _causal_log_weights(torch.cumsum(log_f, 1), i_pre)
        m = D.amax(2, keepdim=True)                      # stabiliser
        W = torch.exp(D - m)                             # [B, L, L, H]
        scores = torch.einsum("blhd,bshd->blsh", q, k).float()
        Wqk = W * scores
        num = torch.einsum("blsh,bshd->blhd", Wqk.to(x.dtype), v)
        den = Wqk.sum(2).abs()                           # [B, L, H]
        h = num / den.clamp(min=1.0)[..., None].to(x.dtype)
        new_state = None
        if state is not None:
            # the recurrent state after the last token
            D_last = D[:, -1]                            # [B, L(s), H]
            m_last = torch.where(torch.isneginf(D_last),
                                 torch.full_like(D_last, -1e30),
                                 D_last).amax(1)         # [B, H]
            W_last = torch.exp(D_last - m_last[:, None, :])
            kf, vf = k.float(), v.float()
            C_last = torch.einsum("bshd,bshe->bhde", W_last[..., None] * vf,
                                  kf)
            n_last = torch.einsum("bsh,bshd->bhd", W_last, kf)
            new_state = (C_last, n_last, m_last)
    else:
        C, n, m_prev = state
        i1, f1 = i_pre[:, 0], log_f[:, 0]                # [B, H]
        m_new = torch.maximum(f1 + m_prev, i1)
        fw = torch.exp(f1 + m_prev - m_new)[..., None]
        iw = torch.exp(i1 - m_new)[..., None]
        kh, vh, qh = k[:, 0].float(), v[:, 0].float(), q[:, 0].float()
        C = fw[..., None] * C + iw[..., None] * (vh[..., :, None]
                                                 * kh[..., None, :])
        n = fw * n + iw * kh
        num = (C @ qh[..., None])[..., 0]                # [B, H, hd]
        den = (n * qh).sum(-1).abs()
        h = (num / den.clamp(min=1.0)[..., None]).to(x.dtype)
        h = h.reshape(B, 1, H, hd)
        new_state = (C, n, m_new)
    out = (h.reshape(B, L, dp) * gate) @ p.w_down
    return out, new_state


def mlstm_state(cfg: ArchConfig, batch: int, device=None):
    dp = int(cfg.d_model * cfg.proj_factor)
    return mlstm_state_like(batch, cfg.n_heads, dp // cfg.n_heads, device)


def mlstm_state_like(batch: int, H: int, hd: int, device=None):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, H, hd, hd), **f32),
            torch.zeros((batch, H, hd), **f32),
            torch.full((batch, H), -math.inf, **f32))


def _mlstm_chunkwise(q, k, v, i_pre, log_f, state, chunk: int):
    """The reference's ``_mlstm_chunkwise``: a loop over chunks of
    ``chunk`` steps carrying the stabilised state (C, n, m). Within a chunk
    (F the within-chunk cumulative log forget) the weights are the
    parallel form's; the carried state enters each row with exponent
    ``F_t + m_prev``; a row's stabiliser is the larger of the two. Returns
    (h [B, L, H, hd], (C, n, m))."""
    B, L, H, hd = q.shape
    C, n, m_prev = state
    hs = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, c0 + chunk)
        qc, kc, vc, ic = q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl]
        Fc = torch.cumsum(log_f[:, sl], 1)               # [B, c, H]
        D = _causal_log_weights(Fc, ic)
        b = Fc + m_prev[:, None, :]                      # [B, c, H]
        m_row = torch.maximum(D.amax(2), b)
        W = torch.exp(D - m_row[:, :, None, :])
        qf, kf, vf = qc.float(), kc.float(), vc.float()
        scores = torch.einsum("blhd,bshd->blsh", qf, kf)
        Wqk = W * scores
        winter = torch.exp(b - m_row)                    # [B, c, H]
        Cq = torch.einsum("bhde,blhe->blhd", C, qf)
        num = torch.einsum("blsh,bshd->blhd", Wqk.to(vc.dtype), vc) + \
            (winter[..., None] * Cq).to(vc.dtype)
        den = (Wqk.sum(2) + winter * torch.einsum("bhd,blhd->blh", n,
                                                  qf)).abs()
        hs.append(num / den.clamp(min=1.0)[..., None].to(vc.dtype))
        # carry the state past this chunk
        Ftot = Fc[:, -1]                                 # [B, H]
        decay = Ftot[:, None, :] - Fc + ic               # [B, c, H]
        m_new = torch.maximum(Ftot + m_prev, decay.amax(1))
        wstate = torch.exp(decay - m_new[:, None, :])
        carry = torch.exp(Ftot + m_prev - m_new)         # [B, H]
        C = carry[..., None, None] * C + torch.einsum(
            "bshd,bshe->bhde", wstate[..., None] * vf, kf)
        n = carry[..., None] * n + torch.einsum("bsh,bshd->bhd", wstate, kf)
        m_prev = m_new
    return torch.cat(hs, 1), (C, n, m_prev)


class SLSTM(nn.Module):
    """Scalar-memory LSTM block: input and recurrent projections of the
    (i, f, z, o) gates, then a GLU MLP of width ``int(d * 4 / 3)``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, bf = cfg.d_model, torch.bfloat16
        self.w_x = _param((d, 4 * d), bf, device)
        self.w_h = _param((d, 4 * d), bf, device)
        self.w_ffn = MLP(cfg, device, d_ff=max(1, int(d * 4 / 3)))

    def reset_parameters(self, gen: torch.Generator) -> None:
        _dense_init_(self.w_x, gen)
        _dense_init_(self.w_h, gen, scale=0.02)
        self.w_ffn.reset_parameters(gen)


def slstm_apply(p: SLSTM, x, cfg: ArchConfig, *, state=None):
    """The reference's ``slstm_apply``: exponential gating with
    hidden-state feedback, a step at a time over the sequence (a Python
    loop: each step needs the last step's h). The recurrent product is
    ``h`` rounded to x's dtype times ``w_h``; the cell runs in float32.
    x [B, L, d] -> (out, state ``(c, n, h, m)`` [B, d] float32 each)."""
    B, L, d = x.shape
    wx = x @ p.w_x                                       # [B, L, 4d]
    c, n, h, m = state if state is not None else slstm_state(cfg, B,
                                                             x.device)
    hs = []
    for t in range(L):
        g = (wx[:, t] + h.to(x.dtype) @ p.w_h).float()
        i_pre, f_pre, z, o = g.chunk(4, dim=-1)
        log_f = -F.softplus(-f_pre)
        m_new = torch.maximum(log_f + m, i_pre)
        iw = torch.exp(i_pre - m_new)
        fw = torch.exp(log_f + m - m_new)
        c = fw * c + iw * torch.tanh(z)
        n = fw * n + iw
        h = torch.sigmoid(o) * c / n.clamp(min=1.0)
        m = m_new
        hs.append(h)
    hx = torch.stack(hs, 1).to(x.dtype)                  # [B, L, d]
    return hx + mlp_apply(p.w_ffn, hx, cfg), (c, n, h, m)


def slstm_state(cfg: ArchConfig, batch: int, device=None):
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.zeros((batch, cfg.d_model), **f32)
    return (z, z.clone(), z.clone(),
            torch.full((batch, cfg.d_model), -math.inf, **f32))
