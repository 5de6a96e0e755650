"""End-to-end training driver of the port (the counterpart of
``repro.launch.train``).

The full stack: deterministic data pipeline -> model -> AdamW ->
checkpoint / resume, with micro-batch gradient accumulation in float32,
optional gradient compression with error feedback (the inter-pod wire
format), injected failures (restart testing), straggler accounting, and
the OpenOptics-modelled inter-pod all-reduce time of each step (aligned
ring schedule against an oblivious rotor). The reference's arguments and
return keys; the parameters are drawn by ``Model.init(seed)`` (a
``torch.Generator``, other numbers than JAX's), and the run is on CUDA
unless ``device`` says otherwise. On the card the attention layers' flash
kernel takes head dims 64, 128 and 256 only, so the ``tiny`` preset (head
dim 16) runs on the CPU; ``small`` and ``full`` run on the card.

Presets: ``tiny`` (``reduced(vocab=512)``), ``small`` (~100M-class of the
same family) and ``full`` (the published config).

Example (OLMo-1B at full width on the card):
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --preset full --steps 10 --global-batch 8 --seq 4096 \\
        --micro-batches 2
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import checkpoint as ckpt
from ..configs import get_config
from ..core.fabric import resolve_device
from ..data import DataConfig, SyntheticLM
from ..distributed import PodFabric, allreduce_time_s
from ..elastic import StragglerPolicy, apply_straggler_policy
from ..models import (build_model, count_params, from_reference_tree,
                      to_reference_tree)
from ..optim import AdamWConfig, CompressionConfig, ef_roundtrip
from .steps import apply_update, loss_and_grads, opt_init

__all__ = ["train", "main", "preset_config", "train_state", "load_state"]


def preset_config(arch: str, preset: str, seq: int):
    """The reference's ``_preset_cfg``."""
    cfg = get_config(arch)
    if preset == "tiny":
        return cfg.reduced(vocab=512)
    if preset == "small":  # ~100M-class of the same family
        return cfg.reduced(
            n_layers=len(cfg.pattern) * 4 + len(cfg.tail),
            d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
            d_ff=2048 if cfg.d_ff else 0, vocab=8192, window=min(cfg.window, seq))
    if preset == "full":
        return cfg
    raise ValueError(preset)


def train_state(cfg, params, opt_state) -> dict:
    """``{"params", "opt": {"mu", "nu", "step"}}`` in the reference's
    parameter tree: what the checkpoint writes."""
    return {"params": to_reference_tree(cfg, params),
            "opt": {"mu": to_reference_tree(cfg, params, opt_state["mu"]),
                    "nu": to_reference_tree(cfg, params, opt_state["nu"]),
                    "step": opt_state["step"]}}


def load_state(cfg, params, tree) -> dict:
    """Write a :func:`train_state` tree into ``params``; returns the
    optimizer state it holds."""
    values = from_reference_tree(cfg, params, tree["params"])
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(values[n])
    return {"mu": from_reference_tree(cfg, params, tree["opt"]["mu"]),
            "nu": from_reference_tree(cfg, params, tree["opt"]["nu"]),
            "step": tree["opt"]["step"]}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(arch: str = "olmo-1b", preset: str = "tiny", steps: int = 60,
          global_batch: int = 8, seq: int = 128, micro_batches: int = 2,
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          resume: bool = False, compression: str = "none",
          fail_at_step: int = -1, seed: int = 0,
          pod_fabric: PodFabric | None = None, log_every: int = 10,
          straggler_sim: bool = False, device=None) -> dict:
    dev = resolve_device(device)
    cfg = preset_config(arch, preset, seq)
    model = build_model(cfg)
    opt_cfg = AdamWConfig(total_steps=steps, warmup_steps=max(2, steps // 20))
    comp_cfg = CompressionConfig(kind=compression)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=global_batch, seed=seed))
    fabric = pod_fabric or PodFabric()

    params = model.trainable(model.init(seed, device=dev))
    opt_state = opt_init(params)
    err = None
    if compression != "none":
        err = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for n, p in params.named_parameters()}
    start_step = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        start_step, tree, _ = ckpt.restore(
            ckpt_dir, train_state(cfg, params, opt_state))
        opt_state = load_state(cfg, params, tree)
        print(f"[train] resumed from step {start_step}")

    if global_batch % micro_batches:
        raise ValueError(f"global batch {global_batch} does not split into "
                         f"{micro_batches} micro-batches")
    mb = global_batch // micro_batches

    def microstep(batch, err):
        """Accumulate the micro-batches' gradients in float32, compress
        them with error feedback when asked (the inter-pod wire format),
        then update."""
        grads, loss = None, 0.0
        for i in range(micro_batches):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            l, g = loss_and_grads(model, params, part)
            if grads is None:
                grads = {n: torch.zeros(x.shape, dtype=torch.float32,
                                        device=dev) for n, x in g.items()}
            for n in g:                  # acc + g / micro_batches, in place
                grads[n].add_(g[n].float() / micro_batches)
            del g
            loss = loss + l / micro_batches
        if err is not None:
            for n in list(grads):
                grads[n], err[n] = ef_roundtrip(grads[n], err[n], comp_cfg)
        new_opt, metrics = apply_update(cfg, params, opt_state, grads,
                                        opt_cfg)
        metrics["loss"] = loss
        return new_opt, err, metrics

    n_params = count_params(cfg)
    grad_bytes = n_params * 4
    comp = comp_cfg if compression != "none" else None
    t_coll_aligned = allreduce_time_s(grad_bytes, fabric, aligned=True,
                                      compression=comp)
    t_coll_rotor = allreduce_time_s(grad_bytes, fabric, aligned=False,
                                    compression=comp)

    history = []
    t_start = time.time()
    rng = np.random.default_rng(seed + 1)
    for step in range(start_step, steps):
        if step == fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        batch = data.device_batch(step, dev)
        _sync(dev)
        t0 = time.time()
        opt_state, err, metrics = microstep(batch, err)
        loss = float(metrics["loss"])     # waits for the step
        dt = time.time() - t0
        if straggler_sim:
            # simulated per-host durations: log-normal with an occasional
            # 5x host
            times = rng.lognormal(np.log(dt), 0.1, size=16)
            if rng.random() < 0.2:
                times[rng.integers(16)] *= 5
            apply_straggler_policy(times, StragglerPolicy())
        history.append({"step": step, "loss": loss, "dt_s": dt})
        if step % log_every == 0 or step == steps - 1:
            tok_s = global_batch * seq / dt
            print(f"[train] step {step:5d} loss {loss:8.4f} {dt*1e3:7.1f} ms "
                  f"{tok_s:9.0f} tok/s  interpod-AR aligned "
                  f"{t_coll_aligned*1e3:.2f} ms vs rotor "
                  f"{t_coll_rotor*1e3:.2f} ms", flush=True)
        if ckpt_dir and ckpt_every > 0 and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, train_state(cfg, params, opt_state),
                      extra={"arch": arch, "preset": preset})
    wall = time.time() - t_start
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, train_state(cfg, params, opt_state),
                  extra={"arch": arch, "preset": preset})
    return {"history": history, "wall_s": wall,
            "final_loss": history[-1]["loss"] if history else None,
            "first_loss": history[0]["loss"] if history else None,
            "params": params, "interpod_ar_aligned_s": t_coll_aligned,
            "interpod_ar_rotor_s": t_coll_rotor, "n_params": n_params,
            "device": str(dev)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "small", "full"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro-batches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compression", default="none", choices=["none", "int8", "topk"])
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--straggler-sim", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    out = train(arch=args.arch, preset=args.preset, steps=args.steps,
                global_batch=args.global_batch, seq=args.seq,
                micro_batches=args.micro_batches, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume,
                compression=args.compression, fail_at_step=args.fail_at_step,
                straggler_sim=args.straggler_sim, seed=args.seed,
                device=args.device)
    print(json.dumps({k: v for k, v in out.items()
                      if k in ("wall_s", "first_loss", "final_loss",
                               "interpod_ar_aligned_s", "interpod_ar_rotor_s",
                               "n_params", "device")}, indent=1))


if __name__ == "__main__":
    main()
