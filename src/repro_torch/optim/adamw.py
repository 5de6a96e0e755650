"""AdamW, learning-rate schedules, global-norm clipping and micro-batch
accumulation: the port of ``repro.optim.adamw``.

Plain functions on trees of tensors (nested dicts, see :mod:`.tree`),
state in, state out, with the reference's arithmetic: parameters keep
their dtype (bfloat16 for the model's weights), ``mu`` and ``nu`` are
float32, the update is computed in float32 and rounded to the parameter's
dtype, ``step`` is an int32 scalar tensor. The learning rate and the bias
corrections are float32 scalar tensors on the state's device, so a step
never reads a value back to the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "linear_schedule", "clip_by_global_norm", "global_norm",
           "accum_init", "accum_add", "accum_finalize"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"    # cosine | linear | const


def _f32(step):
    return (step.float() if isinstance(step, torch.Tensor)
            else torch.tensor(float(step), dtype=torch.float32))


def _warm_prog(cfg: AdamWConfig, step):
    s = _f32(step)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    return warm, prog


def cosine_schedule(cfg: AdamWConfig, step):
    warm, prog = _warm_prog(cfg, step)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * prog))


def linear_schedule(cfg: AdamWConfig, step):
    warm, prog = _warm_prog(cfg, step)
    return cfg.lr * warm * (1 - prog)


def _lr(cfg: AdamWConfig, step):
    if cfg.schedule == "cosine":
        return cosine_schedule(cfg, step)
    if cfg.schedule == "linear":
        return linear_schedule(cfg, step)
    return torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree, max_norm: float):
    """Each leaf times ``min(1, max_norm / norm)`` (the product in float32,
    as JAX promotes a bfloat16 leaf by the float32 scale), in its dtype;
    returns (clipped tree, norm)."""
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), n


def adamw_init(params) -> dict:
    zeros = lambda p: tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        p)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(grads, state, params, cfg: AdamWConfig, decay=None):
    """Returns (new_params, new_state, metrics). Weight decay reaches the
    leaves with two or more dims, or, given ``decay`` (a tree of bools of
    the parameters' structure), those it marks."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = _lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["mu"],
                  grads)
    nu = tree_map(lambda n, g: b2 * n + (1 - b2) * torch.square(g.float()),
                  state["nu"], grads)
    stepf = step.float()
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    def upd(p, m, n, wd):
        u = (m / bc1) / (torch.sqrt(n / bc2) + cfg.eps)
        if wd:  # decoupled weight decay on matrices only
            u = u + cfg.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype)

    if decay is None:
        decay = tree_map(lambda p: p.dim() >= 2, params)
    new_params = tree_map(upd, params, mu, nu, decay)
    return new_params, {"mu": mu, "nu": nu, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


# -- microbatch gradient accumulation ---------------------------------------

def accum_init(params):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params)


def accum_add(acc, grads):
    return tree_map(lambda a, g: a + g.float(), acc, grads)


def accum_finalize(acc, n_micro: int):
    return tree_map(lambda a: a / n_micro, acc)
