"""Step builders of the port: the train step with micro-batch accumulation,
the prefill step and the serve step; and the stand-ins of every (arch x
shape) cell that the dry run runs against (``input_specs``,
``cache_specs``, ``state_specs``): the counterpart of
``repro.launch.steps``.

The port's parameters are a ``Stack`` module, trainable once
``Model.trainable`` has run; the train step computes the gradients with
``torch.autograd.grad`` and writes the AdamW update into the parameters in
place. Its optimizer state is keyed by the port's parameter names
(``Stack.named_parameters()``).

The stand-ins are fake tensors (``torch._subclasses.FakeTensorMode``):
shapes and dtypes with no storage, the counterpart of JAX's
``ShapeDtypeStruct`` and ``eval_shape``. Each function takes the mode to
build them under (a new one by default); a fake tensor can only be used
under the mode that made it.
"""
from __future__ import annotations

import torch

from ..core.fabric import resolve_device
from ..models import build_model, decay_mask
from ..models.config import ArchConfig, ShapeConfig
from ..optim import AdamWConfig, adamw_init, adamw_update

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step",
           "shape_supported", "loss_and_grads", "apply_update", "opt_init",
           "input_specs", "cache_specs", "state_specs", "fake_mode"]


def shape_supported(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 524k-token decode is quadratic"
    return True, ""


def fake_mode():
    """A new ``FakeTensorMode`` that also takes real tensors made outside
    it (such as a constant a layer builds) as fakes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def _frontend_spec(cfg: ArchConfig, batch: int):
    if cfg.frontend is None:
        return None
    from ..models import stacks
    return torch.empty((batch, cfg.frontend_tokens, stacks.frontend_dim(cfg)),
                       dtype=torch.bfloat16)


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mode=None) -> dict:
    """Model inputs of this cell as fake CPU tensors (no allocation).

    train: {tokens, labels, frontend_embeds?}; prefill: {tokens, cache,
    frontend_embeds?}; decode: {token, cache, index}: one new token against
    a cache of ``shape.seq_len`` (decode cells run the serve step). A
    vision model's token count leaves room for its patches, as the
    reference's does."""
    mode = mode or fake_mode()
    B, L = shape.global_batch, shape.seq_len
    i32 = torch.int32
    with mode:
        if shape.kind in ("train", "prefill"):
            Lt = L - (cfg.frontend_tokens
                      if (cfg.frontend and not cfg.enc_dec) else 0)
            out = {"tokens": torch.empty((B, Lt), dtype=i32)}
            if shape.kind == "train":
                out["labels"] = torch.empty((B, Lt), dtype=i32)
            else:
                out["cache"] = cache_specs(cfg, B, L, mode)
            fe = _frontend_spec(cfg, B)
            if fe is not None:
                out["frontend_embeds"] = fe
            return out
        if shape.kind == "decode":
            return {"token": torch.empty((B, 1), dtype=i32),
                    "cache": cache_specs(cfg, B, L, mode),
                    "index": torch.empty((), dtype=i32)}
    raise ValueError(shape.kind)


def cache_specs(cfg: ArchConfig, batch: int, seq_len: int, mode=None):
    """The port's cache (``stacks.init_cache``) as fake tensors."""
    from ..models import stacks
    with mode or fake_mode():
        return stacks.init_cache(cfg, batch, seq_len, torch.device("cpu"),
                                 enc_len=cfg.frontend_tokens or None)


def state_specs(cfg: ArchConfig, mode=None):
    """(parameters, AdamW state) as fake tensors: a ``Stack`` module, and
    ``opt_init``'s ``mu`` / ``nu`` (float32, keyed by parameter name) and
    ``step``. No parameter is drawn and nothing is allocated."""
    from ..models import stacks
    build_model(cfg)
    with mode or fake_mode():
        params = stacks.Stack(cfg, torch.device("cpu"))
        return params, opt_init(params)


def opt_init(params) -> dict:
    """AdamW's state for a ``Stack``: ``mu``, ``nu`` keyed by parameter
    name, and ``step``."""
    return adamw_init({n: p.detach() for n, p in params.named_parameters()})


def loss_and_grads(model, params, batch: dict):
    """(loss, gradients by parameter name) of one batch; the gradients in
    each parameter's dtype, zeros for a parameter the loss does not reach."""
    named = dict(params.named_parameters())
    loss = model.loss(params, batch["tokens"], batch["labels"],
                      batch.get("frontend_embeds"))
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(named.items(), grads)}


def apply_update(cfg: ArchConfig, params, opt_state, grads,
                 opt_cfg: AdamWConfig):
    """AdamW on the parameters in place (``torch.no_grad``); returns (new
    optimizer state, metrics). Weight decay follows the reference's rule
    (``models.decay_mask``)."""
    named = dict(params.named_parameters())
    values = {n: p.detach() for n, p in named.items()}
    new, new_opt, metrics = adamw_update(grads, opt_state, values, opt_cfg,
                                         decay=decay_mask(cfg, params))
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(new[n])
    return new_opt, metrics


def _on(batch: dict, dev) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig | None = None,
                    device=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, as the reference's. With ``cfg.train_microbatches`` n > 1
    the batch splits into n micro-batches along its rows, whose gradients
    accumulate in float32 (``acc + g / n``) and whose losses average; with
    n = 1 the gradients stay in the parameters' dtype. The update is
    written into ``params``, which is returned. CUDA unless ``device``
    says otherwise; the batch is moved there."""
    dev = resolve_device(device)
    model = build_model(cfg)
    opt_cfg = opt_cfg or AdamWConfig()
    n_micro = max(1, cfg.train_microbatches)

    def train_step(params, opt_state, batch):
        batch = _on(batch, dev)
        if n_micro == 1:
            loss, grads = loss_and_grads(model, params, batch)
        else:
            mb = batch["tokens"].shape[0] // n_micro
            grads, loss = None, 0.0
            for i in range(n_micro):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, g = loss_and_grads(model, params, part)
                if grads is None:
                    grads = {n: torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device)
                             for n, x in g.items()}
                for n in g:     # acc + g / n, in place
                    grads[n].add_(g[n].float() / n_micro)
                del g
                loss = loss + l / n_micro
        opt_state, metrics = apply_update(cfg, params, opt_state, grads,
                                          opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig):
    model = build_model(cfg)

    def prefill_step(params, batch):
        logits, cache = model.prefill(params, batch["tokens"], batch["cache"],
                                      batch.get("frontend_embeds"))
        return torch.argmax(logits[:, -1], dim=-1), cache

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    model = build_model(cfg)

    def serve_step(params, token, cache, index):
        logits, cache = model.decode_step(params, token, cache, int(index))
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        return nxt, cache

    return serve_step
