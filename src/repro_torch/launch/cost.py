"""Per-device cost of a torch program run on DTensors: FLOPs, memory
traffic and collective bytes, and the roofline terms they give on an H100
(the counterpart of ``repro.launch.hlo``).

The reference reads the optimized per-device HLO of its SPMD program and
weights each ``while`` body by its trip count. The port has no compiled
program to read: :class:`CostMode`, a ``TorchDispatchMode``, watches the
aten ops of a run. It gives way to DTensor (returns ``NotImplemented``
for an op on DTensors, as ``CommDebugMode`` does), so that DTensor runs
first and the mode then sees the local ops it issues on each rank's
shard, and the collectives of its redistributions, at local shapes: the
per-device program, as the reference's HLO module is. The ops that
DTensor's sharding propagation runs on fake tensors of the global shapes
are not counted. A Python loop is counted as it runs, once per pass;
:meth:`CostMode.weighted` multiplies what runs under it (the train step
counts one micro-batch weighted by their number, as the reference weights
its scan's body). A loop whose passes do alike work goes through
:func:`passes`: on real tensors every pass runs; on fake tensors the first
pass, the second and the last run, and :meth:`CostMode.weighted_pass`
counts the second as all the passes between, its forward and its backward
(the autograd nodes it records), as the reference weights a ``while`` body
by its trip count.

  flops            matmul-family ops (mm, bmm, addmm, baddbmm, mv, dot):
                   2 * numel(result) * the contracted size, the HLO rule
                   for dot ops (elementwise FLOPs are left out, as there)
  bytes            operands + result of each aten op, the traffic model of
                   ``analyze_hlo``: views and metadata ops move nothing
                   (its bitcasts, parameters, constants, iota), a gather or
                   index moves 2 x its result, a scatter, index_put or
                   index_add 2 x its updates + its result, a copy into a
                   slice 2 x what it copies (its dynamic-update-slice)
  collective bytes operand sizes of all-gather / all-reduce /
                   reduce-scatter / all-to-all, by kind: the input of each
                   functional collective, which is the result / g of an
                   all-gather and the result x g of a reduce-scatter (the
                   reference's rule from result shapes)

Every count is per device. :class:`HW` holds the H100 SXM's spec-sheet
rates; :func:`roofline_terms` has the reference's keys.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CostMode", "CostStats", "HW", "roofline_terms", "analyze",
           "passes", "all_passes"]

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot", "addmv"}
_GATHER = {"index", "index_select", "gather", "embedding", "take_along_dim"}
_SCATTER = {"index_put", "index_put_", "_index_put_impl_", "scatter",
            "scatter_", "scatter_add", "scatter_add_", "index_add",
            "index_add_", "index_copy", "index_copy_", "scatter_reduce",
            "scatter_reduce_"}
_COPY_INTO = {"copy_", "slice_scatter", "select_scatter"}
_SKIP = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_local_scalar_dense", "arange", "scalar_tensor", "wait_tensor",
         "sym_size", "sym_numel", "sym_stride", "sym_storage_offset",
         "set_", "resize_", "_to_copy_meta", "device"}
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "all_reduce_coalesced_": "all-reduce",
                "all_to_all_single": "all-to-all"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


@dataclasses.dataclass
class CostStats:
    flops: float
    bytes: float
    collective_bytes: float
    collectives_by_kind: dict
    collective_ops: int


class CostMode(TorchDispatchMode):
    """Counts the per-device cost of the ops run under it (see the module
    docstring). Enter it after (inside) any ``FakeTensorMode``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_kind: dict[str, float] = defaultdict(float)
        self.collective_ops = 0
        self._weight = 1.0
        # the autograd nodes of each weighted pass: [first, end) of their
        # sequence numbers and the pass's weight
        self._passes: list[tuple[int, int, float]] = []
        self._propagating = 0
        self._patched = None

    @contextlib.contextmanager
    def weighted(self, n: float):
        """Count what runs inside ``n`` times over (a loop whose passes are
        alike, run once)."""
        old, self._weight = self._weight, self._weight * n
        try:
            yield
        finally:
            self._weight = old

    @contextlib.contextmanager
    def weighted_pass(self, n: float):
        """Count what runs inside ``n`` times over, and the backward of the
        autograd nodes it records ``n`` times over too (one pass of a loop
        standing for ``n``). Refuses to run inside the backward of such a
        pass (a recomputation there would be counted twice over)."""
        if self._node_weight() != 1.0:
            raise RuntimeError("a weighted pass run inside the backward of "
                               "another: its count would be wrong")
        first = torch._C._autograd._get_sequence_nr()
        with self.weighted(n):
            yield
        end = torch._C._autograd._get_sequence_nr()
        if end > first:
            self._passes.append((first, end, n))

    def _node_weight(self) -> float:
        """The weight of the autograd node whose backward runs now: the
        product of the weighted passes that recorded it (1 outside them)."""
        if not self._passes:
            return 1.0
        node = torch._C._current_autograd_node()
        if node is None:
            return 1.0
        seq, w = node._sequence_nr(), 1.0
        for first, end, n in self._passes:
            if first <= seq < end:
                w *= n
        return w

    def __enter__(self):
        # DTensor's sharding propagation runs each new op once on fakes of
        # the global shapes: those ops are not the program's
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        mode = self

        def propagate(*a, **k):
            mode._propagating += 1
            try:
                return orig(*a, **k)
            finally:
                mode._propagating -= 1

        self._patched = (ShardingPropagator, orig)
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        cls, orig = self._patched
        cls._propagate_tensor_meta_non_cached = orig
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._propagating and isinstance(func, torch._ops.OpOverload):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        w = self._weight * self._node_weight()
        if name in _COLLECTIVES:
            ob = _nbytes(args[0])
            self.by_kind[_COLLECTIVES[name]] += w * ob
            self.collective_ops += 1
        if name in _MATMUL:
            a = args[1] if name in ("addmm", "baddbmm", "addmv") else args[0]
            k = a.shape[-1] if a.dim() else 1
            self.flops += w * 2.0 * out.numel() * k
        if name in _SKIP or func.is_view or name.endswith("_view"):
            return
        if name in _GATHER:
            b = 2 * _nbytes(out)
        elif name in _SCATTER:
            upd = kwargs.get("values", kwargs.get("src", kwargs.get("source")))
            if upd is None:
                upd = args[-1] if isinstance(args[-1], torch.Tensor) else \
                    args[2]
            b = 2 * _nbytes(upd) + _nbytes(out)
        elif name in _COPY_INTO:
            b = 2 * _nbytes(args[1])
        else:
            b = _nbytes(out) + sum(_nbytes(a) for a in args) + \
                sum(_nbytes(v) for v in kwargs.values())
        self.bytes += w * b

    def stats(self) -> CostStats:
        return CostStats(flops=self.flops, bytes=self.bytes,
                         collective_bytes=float(sum(self.by_kind.values())),
                         collectives_by_kind=dict(self.by_kind),
                         collective_ops=self.collective_ops)


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return isinstance(t, torch.Tensor) and is_fake(t)


def passes(n: int, *tensors):
    """The passes to run of a loop of ``n`` passes that do alike work, by
    index: all ``n`` when ``tensors`` hold values; on fake tensors (the dry
    run, where no pass computes a value) the first, the second and the
    last, the second counted ``n - 2`` times over by the active
    :class:`CostMode`, forward and backward. The first and the last run on
    their own because their backward differs: the first pass's carried
    state starts as a constant without a gradient, and nothing reads the
    last pass's carried state. Collect the passes' outputs with
    :func:`all_passes`."""
    if n <= 3 or not any(_is_fake(t) for t in tensors):
        yield from range(n)
        return
    yield 0
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    modes = [m for m in _get_current_dispatch_mode_stack()
             if isinstance(m, CostMode)]
    with (modes[-1].weighted_pass(n - 2) if modes
          else contextlib.nullcontext()):
        yield 1
    yield n - 1


def all_passes(outs: list, n: int) -> list:
    """The ``n`` per-pass outputs of a loop run by :func:`passes`: ``outs``
    as they are, or after a weighted run of three passes the second's
    repeated in place of the passes not run."""
    if len(outs) == n:
        return outs
    return outs[:1] + outs[1:2] * (n - 2) + outs[2:]


def analyze(fn, *args, **kwargs) -> tuple[object, CostStats]:
    """``fn(*args, **kwargs)`` under a new :class:`CostMode`: (its value,
    its cost)."""
    with CostMode() as mode:
        out = fn(*args, **kwargs)
    return out, mode.stats()


@dataclasses.dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM (data sheet, dense rates at its 700 W limit)."""
    peak_flops: float = 989e12       # bf16 FLOP/s per card
    hbm_bw: float = 3.35e12          # bytes/s per card
    link_bw: float = 450e9           # NVLink bytes/s per direction
    hbm_gb: float = 80.0


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float, hw: HW = HW()) -> dict:
    """The three roofline terms in seconds (per device): counts over the
    spec-sheet rates of ``hw``, not measurements."""
    terms = {"compute_s": flops_per_device / hw.peak_flops,
             "memory_s": bytes_per_device / hw.hbm_bw,
             "collective_s": collective_bytes_per_device / hw.link_bw}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    return terms
