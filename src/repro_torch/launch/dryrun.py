"""The multi-pod dry run of the port (the counterpart of
``repro.launch.dryrun``): every (arch x shape x mesh) cell run on the
production mesh without a device, its per-device cost counted.

    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes

A cell runs in this process on a fake process group (``torch``'s "fake"
backend, no network, no peers) of 256 ranks (16 x 16, "data" x "model")
or 512 (2 x 16 x 16 with "pod"). Its parameters are DTensors of fake CPU
tensors (``FakeTensorMode``: shapes, no storage) placed by
``param_shardings``, the AdamW state by ``opt_state_shardings``, the batch
by ``batch_shardings`` / ``frontend_sharding`` and the caches by
``cache_shardings``. Train cells run ``loss_and_grads`` on one micro-batch
(counted once per micro-batch) and the AdamW update; prefill cells
``prefill``, decode cells ``decode_step`` on a full cache; everything
under ``implicit_replication()`` (the model's own constants are plain
tensors), :class:`repro_torch.launch.cost.CostMode` counting the
per-device work and ``CommDebugMode`` the collectives. The kernel
wrappers see CPU tensors and take their plain versions: the reference's
dry run likewise lowers its jnp path and no Pallas kernel. The numbers
are counts over the H100 SXM's spec-sheet rates, not measurements.

Each cell writes one JSON under ``--out-dir`` (``artifacts/dryrun_torch``
by default) with the reference's fields, ``run_s`` (the cell's wall
seconds on the CPU) in place of ``lower_s`` / ``compile_s``, and
``cost`` in place of ``hlo``.

``--variant naive`` maps the reference's first-cut baseline to the
port's knobs: ``attn_impl="naive"``, ``remat="none"``, ``moe_chunk=0``,
one micro-batch, no ``fsdp``. ``attn_impl`` changes nothing in the port,
whose attention at prefill and in training is one path (the flash
kernel, here its plain version).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import signal
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import get_config, list_archs
from ..models import build_model, count_params, model_flops
from ..models.config import SHAPES, ShapeConfig
from .mesh import MeshShape, make_mesh, production_shape
from .steps import (fake_mode, input_specs, loss_and_grads, shape_supported,
                    state_specs)

__all__ = ["lower_cell", "main", "fake_group"]


def fake_group(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks
    (this process is rank 0), replacing an earlier fake group of another
    size. Refuses to replace a real group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs its own process: a real "
                               "process group is live")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _place(t, mesh, spec, requires_grad=False):
    """A DTensor of the fake tensor ``t`` (its global value) placed by
    ``spec``: each rank's chunk, nothing sent."""
    from torch.distributed.tensor import DTensor, Replicate
    from ..distributed.sharding import placements
    d = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                           run_check=False)
    return d.redistribute(mesh, placements(spec, mesh)).detach() \
        .requires_grad_(requires_grad)


def _place_params(params, mesh, specs, train: bool) -> None:
    for name, p in list(params.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = params.get_submodule(mod_name) if mod_name else params
        mod._parameters[leaf] = torch.nn.Parameter(
            _place(p.detach(), mesh, specs[name]), requires_grad=train)


def _place_tree(tree, specs, mesh):
    """The cache's tensors placed by their specs (same structure)."""
    if isinstance(tree, torch.Tensor):
        return _place(tree, mesh, specs)
    if dataclasses.is_dataclass(tree):
        return type(tree)(*(_place_tree(getattr(tree, f.name),
                                        getattr(specs, f.name), mesh)
                            for f in dataclasses.fields(tree)))
    return type(tree)(_place_tree(t, s, mesh) for t, s in zip(tree, specs))


class _Reshard(TorchDispatchMode):
    """Where DTensor has no sharding for an op on its inputs as placed
    (a reshape that splits a sharded dim unevenly, such as 4 KV heads
    sharded 16 ways; an op without a sharding rule), replicate the op's
    DTensor inputs over the non-data mesh axes, then if need be over all,
    and run it again, as GSPMD reshards what it cannot partition; the
    gathers are counted as any other. In-place ops are not retried.
    ``fallbacks`` counts the ops so run, by name."""

    def __init__(self):
        super().__init__()
        self.fallbacks: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for keep_data in (None, True, False):
            if keep_data is not None:
                args, kwargs = _replicate((args, kwargs), keep_data)
            try:
                out = func(*args, **kwargs)
            except (RuntimeError, NotImplementedError) as e:
                if keep_data is False or func._schema.is_mutable or \
                        "sharding" not in str(e).lower():
                    raise
                continue
            if keep_data is not None:
                name = func._schema.name.split("::")[-1]
                self.fallbacks[name] = self.fallbacks.get(name, 0) + 1
            return out


def _replicate(tree, keep_data: bool = False):
    """DTensors of ``tree`` replicated over every mesh axis, or over all
    but the data axes (``keep_data``)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(tree, DTensor):
        mesh = tree.device_mesh
        pl = [p if keep_data and n in ("pod", "data") else Replicate()
              for n, p in zip(mesh.mesh_dim_names, tree.placements)]
        return tree.redistribute(mesh, pl)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replicate(t, keep_data) for t in tree)
    if isinstance(tree, dict):
        return {k: _replicate(v, keep_data) for k, v in tree.items()}
    return tree


def _naive(cfg):
    return dataclasses.replace(cfg, remat="none", attn_impl="naive",
                               moe_chunk=0, train_microbatches=1, fsdp=False)


def lower_cell(arch, shape_name: str, multi_pod: bool,
               variant: str = "opt", overrides: dict | None = None, *,
               shape: ShapeConfig | None = None,
               mesh_shape: MeshShape | None = None) -> dict:
    """Run one (arch x shape x mesh) cell on fakes; returns its result dict.

    variant "naive" is the reference's first-cut baseline (see the module
    docstring); "opt" the shipped configuration. ``overrides`` replaces
    ``ArchConfig`` fields on top. ``shape`` (a ``ShapeConfig``) and
    ``mesh_shape`` replace ``SHAPES[shape_name]`` and the production mesh,
    and ``arch`` may be an ``ArchConfig`` (the smoke cells of the
    tests)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    from ..distributed import sharding as S
    from ..models import stacks
    from ..optim import AdamWConfig
    from .cost import CostMode, roofline_terms
    from .steps import apply_update

    base = get_config(arch) if isinstance(arch, str) else arch
    arch, cfg = base.name, base
    if variant == "naive":
        cfg = _naive(cfg)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape or SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, why = shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": why}
    ms = mesh_shape or production_shape(multi_pod)
    fake_group(ms.size)
    mesh = make_mesh(ms.sizes, ms.axis_names, "cpu")
    t0 = time.time()
    mode = fake_mode()
    specs = input_specs(cfg, shape, mode)
    params, _ = state_specs(cfg, mode)
    p_sh = S.param_shardings(params, mesh, cfg)
    train = shape.kind == "train"
    B = shape.global_batch
    b_sh = S.batch_shardings(mesh, B)
    cost, reshard = CostMode(), _Reshard()
    with mode:
        _place_params(params, mesh, p_sh, train)
        batch = {k: _place(specs[k], mesh, b_sh["tokens"])
                 for k in ("tokens", "labels", "token") if k in specs}
        if "frontend_embeds" in specs:
            batch["frontend_embeds"] = _place(specs["frontend_embeds"], mesh,
                                              S.frontend_sharding(mesh))
        if "cache" in specs:
            cache = _place_tree(specs["cache"], S.cache_shardings(
                specs["cache"], mesh, cfg, B), mesh)
        if train:
            o_sh = S.opt_state_shardings(params, mesh, cfg)
            opt = {k: {n: _place(torch.zeros(p.shape, dtype=torch.float32),
                                 mesh, o_sh[k][n])
                       for n, p in params.named_parameters()}
                   for k in ("mu", "nu")}
            opt["step"] = _place(torch.zeros((), dtype=torch.int32), mesh, ())
            n_micro = max(1, cfg.train_microbatches)
            mb = B // n_micro
            if mb == 0:
                raise ValueError(f"a batch of {B} in {n_micro} micro-batches")
            part = {k: v[:mb] for k, v in batch.items()}
        with implicit_replication(), CommDebugMode() as comm, cost, reshard:
            if train:
                with cost.weighted(n_micro):
                    _, grads = loss_and_grads(build_model(cfg), params, part)
                    if n_micro > 1:     # acc + g / n in float32
                        grads = {n: g.float() / n_micro
                                 for n, g in grads.items()}
                apply_update(cfg, params, opt, grads, AdamWConfig())
            elif shape.kind == "prefill":
                logits, _ = stacks.prefill(params, cfg, batch["tokens"], cache,
                                           batch.get("frontend_embeds"))
                torch.argmax(_replicate(logits[:, -1]), dim=-1)
            else:
                logits, _ = stacks.decode_step(params, cfg, batch["token"],
                                               cache, shape.seq_len - 1)
                torch.argmax(_replicate(logits[:, -1]), dim=-1)
    run_s = time.time() - t0
    st = cost.stats()
    n_dev = ms.size
    mf = model_flops(cfg, shape.kind, shape.seq_len, B)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_devices": n_dev, "run_s": round(run_s, 1),
        "cost": {"flops_per_device": st.flops,
                 "bytes_per_device": st.bytes,
                 "collective_bytes_per_device": st.collective_bytes,
                 "collectives_by_kind": st.collectives_by_kind,
                 "collective_ops": st.collective_ops},
        "comm_counts": {str(k): v for k, v in comm.get_comm_counts().items()},
        "replicated_fallbacks": reshard.fallbacks,
        "params": count_params(base),
        "params_active": count_params(cfg, active=True),
        "model_flops": mf,
        "model_flops_per_device": mf / n_dev,
        "roofline": roofline_terms(st.flops, st.bytes, st.collective_bytes),
        "useful_flops_ratio": (mf / n_dev) / st.flops if st.flops else None,
        "variant": variant,
    }


@contextlib.contextmanager
def _time_limit(seconds: float):
    """Raise ``TimeoutError`` in this (main) thread after ``seconds``."""
    def expire(*_):
        raise TimeoutError(f"the cell ran past {seconds:g} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry run of the port")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell")
    ap.add_argument("--out-dir", default="artifacts/dryrun_torch")
    ap.add_argument("--variant", default="opt", choices=["opt", "naive"])
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--cell-timeout", type=float, default=900.0,
                    help="seconds a cell may run before it is recorded as "
                    "an error")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out_dir, exist_ok=True)
    failures = []
    for mp in meshes:               # one fake group per mesh size
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                path = os.path.join(args.out_dir, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip existing] {tag}")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    with _time_limit(args.cell_timeout):
                        res = lower_cell(arch, shape, mp,
                                         variant=args.variant)
                except Exception as e:
                    traceback.print_exc()
                    failures.append(tag)
                    res = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "error": f"{type(e).__name__}: {e}"}
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                if "skipped" in res:
                    print(f"  skipped: {res['skipped']}")
                elif "error" in res:
                    print(f"  ERROR: {res['error']}")
                else:
                    r, c = res["roofline"], res["cost"]
                    print(f"  run={res['run_s']}s "
                          f"flops/dev={c['flops_per_device']:.3e} "
                          f"coll/dev={c['collective_bytes_per_device']:.3e}B "
                          f"dominant={r['dominant']} bound={r['bound_s']:.2e}s",
                          flush=True)
    if failures:
        raise SystemExit(f"dry-run failures: {failures}")


if __name__ == "__main__":
    main()
