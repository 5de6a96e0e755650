"""Step builders of the port: the train step with micro-batch accumulation,
the prefill step and the serve step (the step half of
``repro.launch.steps``; its ``input_specs`` / ``state_specs`` feed the
reference's dry run, which the port does not have).

The port's parameters are a ``Stack`` module, trainable once
``Model.trainable`` has run; the train step computes the gradients with
``torch.autograd.grad`` and writes the AdamW update into the parameters in
place. Its optimizer state is keyed by the port's parameter names
(``Stack.named_parameters()``).
"""
from __future__ import annotations

import torch

from ..core.fabric import resolve_device
from ..models import build_model, decay_mask
from ..models.config import ArchConfig, ShapeConfig
from ..optim import AdamWConfig, adamw_init, adamw_update

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step",
           "shape_supported", "loss_and_grads", "apply_update", "opt_init"]


def shape_supported(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 524k-token decode is quadratic"
    return True, ""


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
