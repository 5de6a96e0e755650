"""Run one function on ``D`` ranks of a fresh process group, from one
process: what :func:`repro_torch.core.fabric.simulate_sharded` does with
its shard body.

:func:`run_ranks` starts the ranks from a fork server (the
``forkserver`` start method: one clean interpreter, started at the first
call, imports ``torch`` and the port once and forks each rank from
there, so a rank does not pay those imports again; no rank is forked
from a process that holds a CUDA context;
:func:`stop_fork_server` ends it), joins them through a
``FileStore`` in a temporary
directory (no network), calls the function on every rank and returns rank
0's value. A rank that raises fails the call with its traceback; a run
that outlives its timeout is killed and fails the call. The process
group's own timeout is the same, so a rank blocked in a collective whose
peer died gives up too. :func:`choose_backend` picks the backend and
refuses what NCCL cannot run, never switching it silently.
:func:`setup_seconds` tells a rank where its start-up went.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback

import torch

__all__ = ["choose_backend", "run_ranks", "setup_seconds", "stop_fork_server"]

# this rank's start-up marks (wall clock), set once by ``_rank_main`` in a
# rank; empty in any other process
_SETUP_MARKS: dict = {}
# the package directory that holds ``repro_torch``
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def choose_backend(num_shards: int, device_type: str, backend=None,
                   num_cards: int | None = None) -> str:
    """The process group's backend for ``num_shards`` ranks on
    ``device_type``: ``"gloo"`` on the CPU; on CUDA ``"nccl"`` when every
    rank has a card of its own (rank ``r`` on card ``r % num_cards``).
    Ranks that would share a card need ``backend="gloo"`` named: NCCL
    refuses two ranks on one card, and the choice is never made
    silently."""
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}: expected 'nccl' or "
                         "'gloo'")
    if device_type != "cuda":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices")
        return "gloo"
    n = torch.cuda.device_count() if num_cards is None else num_cards
    if num_shards > n and backend != "gloo":
        raise ValueError(
            f"{num_shards} ranks on {n} CUDA card(s) would share a card, "
            "which NCCL refuses; pass backend='gloo' to run them over gloo")
    return "nccl" if backend is None else backend


def setup_seconds() -> dict:
    """Where this spawned rank's start-up went, in wall seconds:
    ``imports`` (from the parent's start of the rank to ``_rank_main``:
    the fork, the parent's main module run again, which the fork server
    does not import),
    ``unpickle`` (the call's function and arguments), ``device`` (the CUDA
    context; 0 on the CPU), ``group`` (``init_process_group``, which
    waits for every rank). Empty outside a rank of :func:`run_ranks`."""
    m = _SETUP_MARKS
    if not m:
        return {}
    keys = ("start", "imports", "unpickle", "device", "group")
    return {k: m[k] - m[p] for p, k in zip(keys, keys[1:])}


def _fork_server():
    """The ``forkserver`` context, its server started (once a process)
    with ``torch`` and the port imported. The server finds the port through
    ``PYTHONPATH``, set for its start only: some Python 3.12 releases do not
    hand it the caller's ``sys.path``, and its preload then fails
    silently."""
    import multiprocessing as mp
    from multiprocessing import forkserver
    ctx = mp.get_context("forkserver")
    forkserver.set_forkserver_preload(["repro_torch.distributed.spawn"])
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join([_SRC] + ([old] if old
                                                         else []))
    try:
        forkserver.ensure_running()
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old
    return ctx


def stop_fork_server() -> None:
    """End the fork server of :func:`run_ranks`, if one runs (it also ends
    by itself when this process exits)."""
    from multiprocessing import forkserver
    if forkserver._forkserver._forkserver_pid is not None:
        forkserver._forkserver._stop()


def _rank_main(rank: int, world: int, backend: str, device_type: str,
               tmp: str, timeout: float, t_start: float) -> None:
    import torch.distributed as dist
    _SETUP_MARKS.update(start=t_start, imports=time.time())
    try:
        torch.set_num_threads(1)
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        _SETUP_MARKS["unpickle"] = time.time()
        # one host: the transports' bootstrap on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            torch.zeros((), device="cuda")      # the context, made here
        _SETUP_MARKS["device"] = time.time()
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "store"),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        _SETUP_MARKS["group"] = time.time()
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            path = os.path.join(tmp, "result.pkl")
            with open(path + ".part", "wb") as f:
                pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(path + ".part", path)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def run_ranks(fn, args: tuple, num_shards: int, backend: str,
              device_type: str = "cuda", timeout: float = 1800.0):
    """Call ``fn(*args)`` on ``num_shards`` spawned ranks of a new process
    group over ``backend`` and return rank 0's value. ``fn`` and ``args``
    must pickle (``fn`` a module-level function); they are pickled once,
    to a file the ranks read (handing them to each rank's start would
    serialise the ranks' start-up). On CUDA rank ``r`` runs on card ``r %
    device_count``. Raises ``RuntimeError`` with the
    tracebacks if a rank fails, or if the ranks have not all finished
    after ``timeout`` seconds (they are killed then)."""
    ctx = _fork_server()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, num_shards, backend, device_type, tmp,
                                   timeout, time.time()))
                 for r in range(num_shards)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while failed is None:
                codes = [p.exitcode for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = f"rank(s) {bad} failed"
                elif all(c == 0 for c in codes):
                    break
                elif time.monotonic() > deadline:
                    failed = f"the ranks did not finish within {timeout} s"
                else:
                    procs[codes.index(None)].join(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        if failed is not None:
            errs = ""
            for r in range(num_shards):
                path = os.path.join(tmp, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errs += f"\n--- rank {r} ---\n{f.read()}"
            raise RuntimeError(f"run_ranks: {failed} ({backend}, "
                               f"{num_shards} ranks){errs}")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
