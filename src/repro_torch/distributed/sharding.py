"""Sharding rules over ``torch.distributed`` ranks: the port of
``repro.distributed.sharding``, the fabric's layout and the model's.

**The fabric.**
:func:`repro_torch.core.fabric.simulate_sharded` splits the packet vector
in contiguous global-index blocks (rank ``d`` owns global indices ``[d·L,
(d+1)·L)``, ``L = block_len(P, D)``) and the per-slice node tensors of the
failure and control masks by owned ToR rows, with the same block rule. A
count that does not divide is padded up to the next multiple of the shard
count with inert fill (packets that never inject, healthy rows); the
fabric's global-index bookkeeping makes the padding invisible.

**The model** (``param_shardings``, ``opt_state_shardings``,
``batch_shardings``, ``frontend_sharding``, ``cache_shardings``,
``data_axes``, ``replicated``). Mesh axes: ("data", "model") single-pod,
("pod", "data", "model") multi-pod. The pod axis is pure data parallelism
across the optically-switched inter-pod fabric; "model" carries TP
(attention / MLP), EP (MoE experts) and SP (decode KV-cache sequence),
whichever divides evenly:

  attention/MLP in-projections  [d, X]        -> shard X on model
  out-projections               [X, d]        -> shard X on model
  MoE expert stacks             [E, d, ff]    -> shard E on model (EP)
  embedding                     [V, d]        -> shard V on model
  decode KV caches                            -> heads if Kv % model == 0,
                                                 else sequence (SP decode)

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
tensor dim, each ``None``, an axis name, or a tuple of axis names (a dim
sharded over ``("pod", "data")``). :func:`placements` turns it into
DTensor placements on a ``DeviceMesh``. The functions take a
``DeviceMesh`` or a :class:`repro_torch.distributed.mesh.MeshShape`.

The reference stacks each pattern position's layers on a leading
``[n_groups]`` axis and scans over it; the port keeps one module per layer
(``models.model._layout`` maps its names to the reference's leaves). The
rules run on the reference's leaf, the stacked axis included, and each of
the port's tensors takes the leaf's spec without the stacked entry
(:func:`leaf_specs` gives the leaves' own). Where ``fsdp`` or ``zero``
puts "data" on the stacked axis itself (``n_groups`` divisible by the data
size and at least four times it: not at the production meshes' 16), the
port's per-layer tensor has no such axis and stays replicated over data.
Anything that does not divide evenly is replicated, not padded, except the
vocabulary of an embedding or head.
"""
from __future__ import annotations

import dataclasses
import math
import re

import numpy as np

from .mesh import mesh_axes

__all__ = ["fabric_group", "block_len", "shard_owner", "pad_packet_axis",
           "pad_node_rows", "node_rows_bytes_per_device", "data_axes",
           "replicated", "param_shardings", "opt_state_shardings",
           "batch_shardings", "frontend_sharding", "cache_shardings",
           "leaf_specs", "placements", "Region", "mesh_of", "on_ranks",
           "stream", "attention_region", "mlp_region", "column_region",
           "scan_region", "mlstm_region", "moe_region"]


def fabric_group(num_shards: int | None = None, group=None):
    """The ranks of ``group`` (the default process group when ``None``) as
    the fabric's shards: returns ``(group, num_shards)``. ``num_shards``
    must equal the group's size (``None`` takes it), as the reference's
    ``fabric_mesh`` takes the first ``num_shards`` devices and refuses
    more than there are."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("fabric_group: no process group; call "
                           "torch.distributed.init_process_group first")
    size = dist.get_world_size(group)
    d = size if num_shards is None else int(num_shards)
    if d != size:
        raise ValueError(f"num_shards={num_shards} needs a process group of "
                         f"{num_shards} ranks ({size} in the group)")
    return group, d


def block_len(n: int, num_shards: int) -> int:
    """Contiguous-block width per shard: ``ceil(n / num_shards)`` (the last
    shard's block is padded when ``num_shards`` does not divide ``n``)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return -(-max(n, 1) // num_shards)


def shard_owner(idx, n: int, num_shards: int):
    """Owning shard of global index ``idx`` under the contiguous-block
    partition (host-side helper for the toolkit's sharding checker)."""
    return np.asarray(idx) // block_len(n, num_shards)


def pad_packet_axis(arr: np.ndarray, num_shards: int, fill) -> np.ndarray:
    """Pad axis 0 (the packet axis) up to a multiple of ``num_shards`` with
    ``fill`` (callers pick a fill that can never act, e.g. ``t_inject =
    num_slices``)."""
    p = arr.shape[0]
    pad = block_len(p, num_shards) * num_shards - p
    if pad == 0:
        return arr
    return np.concatenate([arr, np.full((pad,) + arr.shape[1:], fill,
                                        arr.dtype)])


def pad_node_rows(arr: np.ndarray, num_shards: int, fill) -> np.ndarray:
    """Pad axis 1 (the node-row axis of ``[S, N, ...]`` masks) up to a
    multiple of ``num_shards`` with inert ``fill`` (healthy / no-op rows);
    the fabric's owned-row bookkeeping never reads the padding."""
    n = arr.shape[1]
    pad = block_len(n, num_shards) * num_shards - n
    if pad == 0:
        return arr
    shape = (arr.shape[0], pad) + arr.shape[2:]
    return np.concatenate([arr, np.full(shape, fill, arr.dtype)], axis=1)


def node_rows_bytes_per_device(num_slices: int, n: int, num_shards: int,
                               itemsize: int = 4) -> int:
    """Per-device bytes of a row-sharded ``[S, N, N]`` mask tensor: each
    device holds only its owned ``ceil(N / D)`` rows, not the full ``N``."""
    return num_slices * block_len(n, num_shards) * n * itemsize


# ---------------------------------------------------------------------------
# the model's shardings
# ---------------------------------------------------------------------------

def data_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def replicated(mesh) -> tuple:
    """The spec of a replicated value (``P()``)."""
    mesh_axes(mesh)
    return ()


def _dp_size(mesh) -> int:
    ax = mesh_axes(mesh)
    return int(np.prod([ax[a] for a in data_axes(mesh)]))


# suffix-pattern -> candidate dims to shard on "model" (first that divides
# wins), counted on the base (unstacked) shape; no match -> replicate.
_RULES: list[tuple[str, tuple[int, ...]]] = [
    (r"\['moe'\]\['w_(gate|up)'\]$", (0, 2)),   # [E, d, ff] -> EP, else ff
    (r"\['moe'\]\['w_down'\]$", (0, 1)),        # [E, ff, d]
    (r"\['(wq|wk|wv)'\]$", (1,)),
    (r"\['wo'\]$", (0,)),
    (r"\['w_(gate|up|in|gate_branch)'\]$", (1,)),
    (r"\['w_(down|out)'\]$", (0,)),
    (r"\['w_[ax]'\]$", (1,)),                   # rg-lru square mats
    (r"\['w_x'\]$", (1,)),                      # slstm input proj [d, 4d]
    (r"\['w_h'\]$", (1,)),
    (r"\['embed'\]$", (0, 1)),                  # [V, d] -> vocab, else d
    (r"\['lm_head'\]$", (1, 0)),                # [d, V]
    (r"\['frontend_proj'\]$", (1,)),
]

_PAD_OK = re.compile(r"\['(embed|lm_head)'\]$")


def _base_spec(key: str, shape: tuple[int, ...], msize: int,
               stacked: bool) -> tuple:
    """The "model" rule of one leaf of the reference's tree (``key`` its
    ``keystr``, ``shape`` its shape, stacked axis included)."""
    base = shape[1:] if stacked else shape
    for pat, dims in _RULES:
        if re.search(pat, key):
            for dim in dims:
                if dim < len(base) and base[dim] % msize == 0:
                    spec = [None] * len(base)
                    spec[dim] = "model"
                    return tuple([None] + spec) if stacked else tuple(spec)
            # embeddings/heads with non-divisible vocab (granite 49155,
            # seamless 256206): shard padded rather than replicate
            if _PAD_OK.search(key):
                dim = dims[0]
                if dim < len(base) and base[dim] > 8 * msize:
                    spec = [None] * len(base)
                    spec[dim] = "model"
                    return tuple([None] + spec) if stacked else tuple(spec)
            break  # matched but nothing divides -> replicate
    return (None,) * len(shape)


def _widen(spec: tuple, shape: tuple[int, ...], dsize: int) -> tuple:
    """Put "data" on the first dim the spec leaves unsharded that divides
    by the data size and is at least four times it (fsdp, zero)."""
    lst = list(spec) + [None] * (len(shape) - len(spec))
    for dim, ax in enumerate(lst):
        if ax is None and shape[dim] % dsize == 0 and shape[dim] >= 4 * dsize:
            lst[dim] = "data"
            break
    return tuple(lst)


def _leaves(params, cfg):
    """(keystr, Leaf, leaf shape) of every leaf of the reference's tree."""
    from ..models.model import _layout

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, path + f"['{k}']")
            else:
                base = tuple(params.get_parameter(v.names[0]).shape)
                shape = (len(v.names),) + base if v.stacked else base
                yield path + f"['{k}']", v, shape

    return list(walk(_layout(cfg, params), ""))


def leaf_specs(params, mesh, cfg, which: str = "params",
               zero: bool = True) -> dict[str, tuple]:
    """The specs of the reference's leaves, keyed by ``keystr``:
    ``param_shardings`` (``which="params"``) or the ``mu`` / ``nu`` of
    ``opt_state_shardings`` (``which="opt"``). ``params``: the port's
    ``Stack`` (its tensors' shapes are read, nothing else)."""
    ax = mesh_axes(mesh)
    msize, dsize = ax["model"], ax["data"]
    out = {}
    for key, lf, shape in _leaves(params, cfg):
        stacked = "['groups']" in key or "['enc_groups']" in key
        spec = _base_spec(key, shape, msize, stacked)
        if cfg.fsdp:
            spec = _widen(spec, shape, dsize)
        if which == "opt" and zero and "data" not in spec:
            spec = _widen(spec, shape, dsize)
        elif which not in ("params", "opt"):
            raise ValueError(f"leaf_specs: which={which!r}")
        out[key] = spec
    return out


def _per_tensor(params, cfg, specs: dict) -> dict[str, tuple]:
    out = {}
    for key, lf, _ in _leaves(params, cfg):
        spec = specs[key]
        for name in lf.names:
            out[name] = spec[1:] if lf.stacked else spec
    return out


def param_shardings(params, mesh, cfg) -> dict[str, tuple]:
    """The spec of each parameter, keyed by the port's parameter names
    (``Stack.named_parameters()``). With ``cfg.fsdp`` parameters also
    shard over the data axis on a spare dim (gathered at use: ZeRO-3)."""
    return _per_tensor(params, cfg, leaf_specs(params, mesh, cfg))


def opt_state_shardings(params, mesh, cfg, zero: bool = True) -> dict:
    """AdamW's state: ``mu`` / ``nu`` mirror the parameter specs; with
    ``zero`` they also shard over the data axis on the first divisible dim
    that the parameter's spec leaves unsharded. ``step`` is replicated."""
    mu = _per_tensor(params, cfg, leaf_specs(params, mesh, cfg, "opt", zero))
    return {"mu": mu, "nu": dict(mu), "step": ()}


def batch_shardings(mesh, batch: int | None = None) -> dict[str, tuple]:
    """tokens/labels [B, L] sharded over the data(+pod) axes on batch;
    replicated when the batch does not divide (e.g. long_500k batch=1)."""
    dp = data_axes(mesh)
    spec = (dp, None) if (batch is None or batch % _dp_size(mesh) == 0) \
        else (None, None)
    return {"tokens": spec, "labels": spec}


def frontend_sharding(mesh) -> tuple:
    return (data_axes(mesh), None, None)


def _cache_spec(kind: str, shape: tuple[int, ...], msize: int, dp_size: int,
                bax, kv_heads_ok: bool) -> tuple:
    """The reference's rule for one cache tensor of one layer: ``kind``
    "kv" (k, v [B, S, Kv, hd]; an encoder memory [B, Le, d]), "pos"
    ([B, S]) or "state" (a recurrent state)."""
    spec: list = [None] * len(shape)
    if kind == "kv":
        if len(shape) >= 1 and bax and shape[0] % dp_size == 0:
            spec[0] = bax
        if len(shape) == 4:
            if shape[2] % msize == 0:
                spec[2] = "model"
            elif shape[1] % msize == 0:
                spec[1] = "model"
        elif len(shape) == 3 and shape[2] % msize == 0:
            spec[2] = "model"
    elif kind == "pos":
        if bax and shape[0] % dp_size == 0:
            spec[0] = bax
        # pos [B, S] co-shards with k/v's S dim
        if not kv_heads_ok and len(shape) == 2 and shape[1] % msize == 0:
            spec[1] = "model"
    else:
        if bax and len(shape) >= 1 and shape[0] % dp_size == 0:
            spec[0] = bax
        if len(shape) == 2 and shape[-1] % msize == 0:
            spec[-1] = "model"
    return tuple(spec)


def cache_shardings(cache, mesh, cfg, batch: int):
    """Decode caches: batch on data axes when it divides; KV heads on
    model when they divide, else the cache's sequence (sequence-parallel
    decode), ``pos`` with it; recurrent states [B, w] shard their width on
    model when it divides. ``cache``: the port's cache (one entry a layer,
    ``stacks.init_cache``); returns the same structure with a spec in
    place of each tensor. A ``dec`` layer's cross part (K/V of the encoder
    memory, which the reference keeps as ``enc_out`` [B, Le, d]) takes the
    k/v and pos rules."""
    from ..models.layers import AttnCache
    ax = mesh_axes(mesh)
    msize, dp_size = ax["model"], _dp_size(mesh)
    bax = data_axes(mesh) if batch % dp_size == 0 else None
    kv_ok = cfg.n_kv_heads % msize == 0

    def one(entry):
        if isinstance(entry, AttnCache):
            return AttnCache(*(_cache_spec(kind, tuple(t.shape), msize,
                                           dp_size, bax, kv_ok)
                               for kind, t in (("kv", entry.k),
                                               ("kv", entry.v),
                                               ("pos", entry.pos))))
        if isinstance(entry, tuple) and entry and \
                isinstance(entry[0], AttnCache):
            return tuple(one(e) for e in entry)
        return tuple(_cache_spec("state", tuple(t.shape), msize, dp_size,
                                 bax, kv_ok) for t in entry)

    return [one(e) for e in cache]


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): per
    mesh dimension ``Shard(dim)`` for the tensor dim whose entry names it,
    else ``Replicate()``. A dim sharded over ``("pod", "data")`` is
    ``Shard(dim)`` on both mesh dimensions, split in mesh order, as
    ``PartitionSpec`` splits it."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out = [Replicate() for _ in names]
    seen = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"placements: {spec} splits dim {dim} over "
                             f"{axes}, not in the mesh's order {names}")
        for a, i in zip(axes, order):
            if a in seen:
                raise ValueError(f"placements: axis {a!r} twice in {spec}")
            seen.add(a)
            out[i] = Shard(dim)
    return out


# -- the model's layers on a mesh ---------------------------------------------
#
# A model under a mesh holds DTensors (its parameters placed by
# ``param_shardings``). Where DTensor's own rules would replicate work that
# the reference's partitioner splits (attention over its heads, the MLP over
# its hidden width, the scan over its channels) or have no rule at all (the
# MoE's sort), a layer runs a region of plain code on each rank's shards:
# the ``*_region`` functions below decide how each operand is placed, and
# ``on_ranks`` runs the region.

try:
    from torch.distributed.tensor import DTensor as _DTensor
except ImportError:                 # a torch built without torch.distributed
    class _DTensor:
        pass


def mesh_of(*ts):
    """The ``DeviceMesh`` of the first DTensor among ``ts``, else None."""
    for t in ts:
        if isinstance(t, _DTensor):
            return t.device_mesh
    return None


@dataclasses.dataclass(frozen=True)
class Region:
    """A region of plain code on each rank's shards: the placements of its
    operands (``ins``), those their gradients are taken in (``grads``:
    ``Partial()`` over an axis whose ranks each compute a part of a value
    they share, as ``shard_map``'s transpose sums it), its output's
    (``out``; a tuple of them for a region with several outputs), and
    those the output is laid out in after (``then``, None to keep
    ``out``)."""
    ins: tuple
    grads: tuple
    out: list | tuple
    then: list | None = None


def on_ranks(mesh, region: Region, fn, *args, shape=None, stride=None):
    """``fn`` on this rank's shards of ``args`` (DTensors, or plain tensors
    that are the same on every rank) laid out by ``region.ins``; its result
    is this rank's shard of a DTensor placed by ``region.out`` (of global
    ``shape`` and ``stride``, where the placements do not tell them), then
    laid out by ``region.then``."""
    from torch.distributed.tensor import DTensor, Replicate
    local = []
    for t, pl, grad in zip(args, region.ins, region.grads, strict=True):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        local.append(t.redistribute(mesh, pl).to_local(grad_placements=grad))
    if isinstance(region.out, tuple):
        # several outputs, each placed by its own entry (even shards)
        return tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                     for o, pl in zip(fn(*local), region.out, strict=True))
    out = DTensor.from_local(fn(*local), mesh, region.out, run_check=False,
                             shape=shape, stride=stride)
    return out if region.then is None else out.redistribute(mesh,
                                                            region.then)


def _split(mesh, B: int):
    """(the mesh's axis names, its data axes, whether their size divides
    the batch B, the size of "model", 1 without one)."""
    names = tuple(mesh.mesh_dim_names or ())
    dp = tuple(n for n in names if n in ("pod", "data"))
    rows = B % math.prod(mesh.size(names.index(n)) for n in dp) == 0
    msz = mesh.size(names.index("model")) if "model" in names else 1
    return names, dp, rows, msz


def _lay(names, dp, rows: bool, model=None) -> list:
    """``Shard(0)`` over the data axes (when ``rows``), ``model`` (a
    placement, or None) over "model", ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if rows and n in dp else
            model if model is not None and n == "model" else Replicate()
            for n in names]


def _summed(names, pl: list, axes) -> list:
    """``pl`` with ``Partial()`` where it replicates over one of ``axes``."""
    from torch.distributed.tensor import Partial, Replicate
    return [Partial() if n in axes and isinstance(p, Replicate) else p
            for n, p in zip(names, pl)]


def stream(x):
    """``x`` laid out as the residual stream: on a DTensor the batch over
    the data axes when it divides, replicated over the rest (a partial sum
    from a row-parallel product is summed), as the reference's partitioner
    keeps its activations; a plain tensor as it is."""
    mesh = mesh_of(x)
    if mesh is None:
        return x
    names, dp, rows, _ = _split(mesh, x.shape[0])
    return x.redistribute(mesh, _lay(names, dp, rows))


def attention_region(mesh, B: int, L: int, hq: int, hkv: int,
                     decode: bool = False):
    """How a partitioner splits attention of q [B, L, Hq, hd] over k, v [B,
    S, Hkv, hd] (``decode``: q [B, Hq, hd] over a cache with its positions
    [B, S]): the batch over the data axes (when it divides), and over
    "model" the query heads (when they divide and each rank's heads fall in
    one KV group, or span whole groups), each rank attending its own rows
    and heads against the KV heads they read; at a prefill where the heads
    do not divide, the queries' positions (each rank a block of L / model
    queries against every key, the blocks gathered after); otherwise
    replicated. A cache sharded on its sequence is gathered whole.

    Returns (the :class:`Region` over (q, k, v), and pos at decode; the KV
    heads this rank reads, a ``slice`` or None for all; the position of
    its first query past the sequence's)."""
    from torch.distributed.tensor import Shard
    names, dp, rows, msz = _split(mesh, B)
    group, hl = hq // hkv, hq // msz
    by_heads = "model" in names and hq % msz == 0 and \
        (group % hl == 0 if hl < group else hl % group == 0)
    by_pos = not decode and not by_heads and "model" in names and \
        L % msz == 0 and L > 1
    q_pl = _lay(names, dp, rows, Shard(1 if decode else 2) if by_heads else
                Shard(1) if by_pos else None)
    kv_pl = _lay(names, dp, rows)
    heads, offset = None, 0
    if by_heads:
        h0 = mesh.get_local_rank("model") * hl // group
        heads = slice(h0, h0 + max(1, hl // group))
    elif by_pos:
        offset = mesh.get_local_rank("model") * (L // msz)
    if decode:
        return Region((q_pl, kv_pl, kv_pl, kv_pl), (q_pl, kv_pl, kv_pl,
                                                    kv_pl), q_pl), heads, 0
    kv_grad = _summed(names, kv_pl, ("model",) if by_heads or by_pos else ())
    return Region((q_pl, kv_pl, kv_pl), (q_pl, kv_grad, kv_grad), q_pl,
                  kv_pl if by_pos else None), heads, offset


def mlp_region(mesh, B: int, L: int, ff: int) -> Region:
    """How a partitioner splits the GLU MLP of x [B, L, d] and its weights
    (``w_gate``, ``w_up`` [d, ff], ``w_down`` [ff, d]): each rank takes its
    rows (the batch over the data axes, when it divides) and its slice of
    the hidden width (over "model", when it divides); the down product's
    partial sums add over "model". Where the width does not divide and L
    does (an sLSTM block's MLP of ``int(d * 4 / 3)``), each rank takes its
    block of the L positions against the whole weights instead, the blocks
    gathered after, as the reference's partitioner splits that product
    four ways rather than run it whole on every rank."""
    from torch.distributed.tensor import Shard
    names, dp, rows, msz = _split(mesh, B)
    by_ff = "model" in names and ff % msz == 0
    by_pos = not by_ff and "model" in names and L % msz == 0 and L > 1
    row = _lay(names, dp, rows)
    rows_axes = dp if rows else ()
    if by_pos:
        own = _lay(names, dp, rows, Shard(1))
        w = _lay(names, (), False)
        w_grad = _summed(names, w, rows_axes + ("model",))
        return Region((own, w, w, w), (own, w_grad, w_grad, w_grad), own,
                      row)
    x_grad = _summed(names, row, ("model",) if by_ff else ())
    w_in, w_out = (_lay(names, (), False, Shard(dim) if by_ff else None)
                   for dim in (1, 0))
    return Region((row, w_in, w_in, w_out),
                  (x_grad, _summed(names, w_in, rows_axes),
                   _summed(names, w_in, rows_axes),
                   _summed(names, w_out, rows_axes)), x_grad)


def column_region(mesh, B: int, N: int, ndim: int) -> Region:
    """How a partitioner splits a product ``x @ w`` of x [B, ..., d]
    (``ndim`` dims) and w [d, N]: each rank takes its rows (the batch over
    the data axes, when it divides) against its block of w's columns (over
    "model", when it divides N), its output those columns. Each rank's x
    gradient is a part of the sum over "model"; w's sums over the data
    axes. (DTensor's own rule computes w's gradient whole on every rank
    when the output's gradient comes back replicated.)"""
    from torch.distributed.tensor import Shard
    names, dp, rows, msz = _split(mesh, B)
    by_cols = "model" in names and N % msz == 0
    row = _lay(names, dp, rows)
    w = _lay(names, (), False, Shard(1) if by_cols else None)
    out = _lay(names, dp, rows, Shard(ndim - 1) if by_cols else None)
    return Region((row, w), (_summed(names, row, ("model",) if by_cols
                                     else ()),
                             _summed(names, w, dp if rows else ())), out)


def scan_region(mesh, B: int, W: int) -> Region:
    """How a partitioner splits the recurrence over a, b [B, L, W]: the
    batch over the data axes and the width over "model", where they
    divide."""
    from torch.distributed.tensor import Shard
    names, dp, rows, msz = _split(mesh, B)
    pl = _lay(names, dp, rows,
              Shard(2) if "model" in names and W % msz == 0 else None)
    return Region((pl, pl), (pl, pl), pl)


def mlstm_region(mesh, B: int, H: int, with_state: bool):
    """How a partitioner splits the mLSTM's gates and recurrence over q, k,
    v [B, L, H, hd], the up-projection ``up`` [B, L, dp] and the gate
    weights ``w_if`` [dp, 2 H] (the gates are computed inside), and with
    ``with_state`` the state C [B, H, hd, hd], n [B, H, hd], m [B, H] (the
    cache at a prefill or a decode step): the batch over the data axes and
    the heads over "model", where they divide; otherwise each rank runs
    every head of its rows. ``up`` and ``w_if`` come whole over "model",
    each rank taking its heads' gate columns, so their gradients sum over
    the ranks that each compute a part; q, k, v and the state keep their
    placements for their gradients. Outputs h [B, L, H, hd] and, with a
    state, the new state, placed as the inputs.

    Returns (the :class:`Region` over (q, k, v, up, w_if[, C, n, m]), the
    heads of this rank, a ``slice`` or None for all)."""
    from torch.distributed.tensor import Shard
    names, dp, rows, msz = _split(mesh, B)
    by_heads = "model" in names and H % msz == 0
    seq = _lay(names, dp, rows, Shard(2) if by_heads else None)
    up = _lay(names, dp, rows)
    w = _lay(names, (), False)
    split = ("model",) if by_heads else ()
    heads = None
    if by_heads:
        h0 = mesh.get_local_rank("model") * (H // msz)
        heads = slice(h0, h0 + H // msz)
    ins = (seq,) * 3 + (up, w)
    grads = (seq,) * 3 + (_summed(names, up, split),
                          _summed(names, w, (dp if rows else ()) + split))
    if not with_state:
        return Region(ins, grads, seq), heads
    st = _lay(names, dp, rows, Shard(1) if by_heads else None)
    return Region(ins + (st,) * 3, grads + (st,) * 3, (seq, st, st, st)), \
        heads


def moe_region(mesh, B: int, L: int, E: int):
    """The expert-parallel MoE's split over a mesh with a "model" axis, as
    the reference's ``_moe_shard_map`` splits it: operands (x, router,
    w_gate, w_up, w_down). Each rank holds its block of the E experts
    (over "model", when it divides E) and, under expert parallelism
    (``ep``: E divides, the data axes divide B, and L > 1), the tokens of
    its data shard; otherwise (decode, or a batch the data axes do not
    divide) every rank takes the whole batch. The partial outputs sum over
    "model". A value replicated over an axis whose ranks each compute a
    part (the tokens over "model", the router over every such axis, the
    experts over the data axes under ``ep``) takes the sum of the ranks'
    gradients.

    Returns (the :class:`Region`, ``ep``, the first expert of this rank's
    block)."""
    from torch.distributed.tensor import Partial, Shard
    names, dp, rows, msz = _split(mesh, B)
    sharded = E % msz == 0
    ep = sharded and rows and L > 1
    x_pl = _lay(names, dp, ep)
    rep = _lay(names, (), False)
    w_pl = _lay(names, (), False, Shard(0) if sharded else None)
    split = tuple(n for n in names if (ep and n in dp) or
                  (sharded and n == "model"))
    out = [Partial() if sharded and n == "model" else p
           for n, p in zip(names, x_pl)]
    e0 = mesh.get_local_rank("model") * (E // msz) if sharded else 0
    return Region((x_pl, rep, w_pl, w_pl, w_pl),
                  (_summed(names, x_pl, split), _summed(names, rep, split),
                   *[_summed(names, w_pl, split)] * 3), out, x_pl), ep, e0
