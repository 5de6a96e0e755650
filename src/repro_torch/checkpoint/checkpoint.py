"""Sharded msgpack checkpoints with atomic commit and resume: the port of
``repro.checkpoint.checkpoint``, in the reference's layout, so that a
checkpoint written by either package restores in the other bit for bit.

Layout: ``<dir>/step_<N>/shard_<i>.msgpack`` + a ``COMMITTED`` marker (and
``extra.msgpack`` when given). A tree is nested dicts (or lists) of
tensors, numpy arrays or scalars; each leaf is keyed by its path written as
JAX's ``keystr`` writes it (``['opt']['mu']['embed']``), in JAX's
flattening order (dict keys sorted), and goes to shard ``crc32(key) %
n_shards``. A leaf is ``{"dtype", "shape", "data"}`` with the raw bytes;
bfloat16 travels as its uint16 bits. A save is write-to-temp + fsync +
atomic rename, and :func:`latest_step` reports committed checkpoints only,
so a crash mid-save is harmless.

The trainer writes ``{"params": ..., "opt": {"mu", "nu", "step"}}`` in the
reference's parameter tree (``models.to_reference_tree``).
"""
from __future__ import annotations

import os
import shutil
import zlib

import msgpack
import numpy as np
import torch

from ..optim.tree import tree_items

__all__ = ["save", "restore", "latest_step", "cleanup", "keystr"]


def keystr(path) -> str:
    """A leaf's path as JAX's ``jax.tree_util.keystr`` writes it."""
    return "".join(f"[{k!r}]" for k in path)


def _pack_leaf(x) -> dict:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return {"dtype": "bfloat16", "shape": list(x.shape),
                    "data": x.contiguous().view(torch.int16).numpy().tobytes()}
        x = x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":     # an ml_dtypes array
        return {"dtype": "bfloat16", "shape": list(a.shape),
                "data": a.view(np.uint16).tobytes()}
    return {"dtype": a.dtype.name, "shape": list(a.shape),
            "data": a.tobytes()}


def _unpack_leaf(d, like=None):
    """A stored leaf as a numpy array (bfloat16 as ``ml_dtypes.bfloat16``),
    or, when ``like`` is a tensor, as a tensor on its device."""
    if d["dtype"] == "bfloat16":
        raw = np.frombuffer(d["data"], np.int16).reshape(d["shape"])
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(raw.copy()).view(torch.bfloat16).to(
                like.device)
        import ml_dtypes
        return raw.view(np.uint16).view(ml_dtypes.bfloat16)
    a = np.frombuffer(d["data"], np.dtype(d["dtype"])).reshape(d["shape"])
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(a.copy()).to(like.device)
    return a


def _write(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())


def save(ckpt_dir: str, step: int, tree, *, n_shards: int = 4,
         keep_last: int = 3, extra: dict | None = None) -> str:
    """Atomically save ``tree`` (parameters, optimizer state) as step
    ``step``; keeps the last ``keep_last`` steps."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    shards: list[dict] = [{} for _ in range(n_shards)]
    for path, leaf in tree_items(tree):
        key = keystr(path)
        shards[zlib.crc32(key.encode()) % n_shards][key] = _pack_leaf(leaf)
    for i, shard in enumerate(shards):
        _write(os.path.join(tmp, f"shard_{i}.msgpack"),
               msgpack.packb({"step": step, "leaves": shard},
                             use_bin_type=True))
    if extra:
        _write(os.path.join(tmp, "extra.msgpack"),
               msgpack.packb(extra, use_bin_type=True))
    _write(os.path.join(tmp, "COMMITTED"), str(step).encode())
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    cleanup(ckpt_dir, keep_last)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, name, "COMMITTED")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, template, step: int | None = None):
    """Restore into the structure of ``template``; returns (step, tree,
    extra). A leaf whose template is a tensor comes back as a tensor of the
    stored dtype on the template's device, any other as a numpy array.
    Raises ``KeyError`` for a leaf the checkpoint lacks."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    leaves: dict = {}
    for name in sorted(os.listdir(d)):
        if name.startswith("shard_"):
            with open(os.path.join(d, name), "rb") as f:
                leaves.update(msgpack.unpackb(f.read(), raw=False)["leaves"])
    extra = None
    if os.path.exists(os.path.join(d, "extra.msgpack")):
        with open(os.path.join(d, "extra.msgpack"), "rb") as f:
            extra = msgpack.unpackb(f.read(), raw=False)

    def fill(tmpl, path):
        if isinstance(tmpl, dict):
            return {k: fill(v, path + (k,)) for k, v in tmpl.items()}
        if isinstance(tmpl, (list, tuple)):
            return type(tmpl)(fill(v, path + (i,)) for i, v in enumerate(tmpl))
        key = keystr(path)
        if key not in leaves:
            raise KeyError(f"checkpoint missing leaf {key}")
        return _unpack_leaf(leaves[key], tmpl)

    return step, fill(template, ()), extra


def cleanup(ckpt_dir: str, keep_last: int) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
