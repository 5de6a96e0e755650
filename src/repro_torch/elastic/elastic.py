"""Elastic scaling and straggler mitigation: the port of
``repro.elastic.elastic`` (planning logic as pure functions, testable
without a cluster).

Elastic contract: on a host failure the job (1) falls back to the last
committed checkpoint, (2) shrinks the data axis to the largest feasible
size, (3) re-seeds the deterministic data pipeline at the resume step, and
(4) keeps the global batch through more gradient accumulation.

Straggler contract: a deadline of ``deadline_factor`` x the median step
time; hosts that miss it contribute nothing this step and the gradient
mean is renormalised by the surviving fraction.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..optim.tree import tree_map

__all__ = ["MeshPlan", "shrink_mesh", "ElasticPlan", "plan_remesh",
           "StragglerPolicy", "apply_straggler_policy", "renormalize_grads"]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))


def shrink_mesh(plan: MeshPlan, n_failed_devices: int) -> MeshPlan:
    """Shrink the data axis to the largest size whose mesh fits the surviving
    devices, keeping the model and pod axes."""
    alive = plan.n_devices - n_failed_devices
    ax = dict(zip(plan.axes, plan.shape))
    other = plan.n_devices // ax["data"]
    new_data = alive // other
    if new_data < 1:
        raise RuntimeError("not enough devices to keep the model axis intact")
    new_shape = tuple(new_data if a == "data" else s
                      for a, s in zip(plan.axes, plan.shape))
    return MeshPlan(new_shape, plan.axes)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old: MeshPlan
    new: MeshPlan
    resume_step: int
    grad_accum_factor: int     # extra accumulation to keep the global batch
    reshard_bytes: int         # params + opt bytes each surviving device reloads

    @property
    def devices_lost(self) -> int:
        return self.old.n_devices - self.new.n_devices


def plan_remesh(old: MeshPlan, n_failed_devices: int, resume_step: int,
                param_bytes: int, global_batch: int) -> ElasticPlan:
    new = shrink_mesh(old, n_failed_devices)
    old_data = dict(zip(old.axes, old.shape))["data"]
    new_data = dict(zip(new.axes, new.shape))["data"]
    # keep the global batch: each surviving data shard takes more microbatches
    factor = int(np.ceil(old_data / new_data))
    opt_bytes = param_bytes * 3          # f32 mu / nu and the rest
    return ElasticPlan(old, new, resume_step, factor,
                       reshard_bytes=(param_bytes + opt_bytes) // new.n_devices)


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    deadline_factor: float = 2.0
    min_quorum: float = 0.75    # below this fraction, wait instead of skip


def apply_straggler_policy(step_times_s: np.ndarray, policy: StragglerPolicy):
    """Given per-host step durations, decide the contributors. Returns
    (contributor mask, deadline_s, renorm factor)."""
    med = float(np.median(step_times_s))
    deadline = policy.deadline_factor * med
    ok = step_times_s <= deadline
    frac = ok.mean()
    if frac < policy.min_quorum:      # too many stragglers: wait for all
        ok = np.ones_like(ok)
        frac = 1.0
    return ok, deadline, 1.0 / frac


def renormalize_grads(grads, contributed: int, total: int):
    """Rescale a gradient sum over ``contributed`` of ``total`` expected
    microbatch contributions to an unbiased mean (in each leaf's dtype)."""
    scale = 1.0 / max(contributed, 1)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)
