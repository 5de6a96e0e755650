"""Control-plane fault layer: clock skew, table-install loss, stalls.
PyTorch port: a copy of ``repro.core.controlplane`` (host numpy, identical
masks per trace and seed).

1. **Fault models** (:class:`ControlTrace` / :func:`random_control_trace`)
   — seeded, reproducible control-fault event lists: constant per-ToR
   clock skew, per-slice clock drift, table-install message delay and
   loss, controller stalls. :func:`compile_control` lowers a trace into
   dense per-slice arrays (:class:`ControlMasks`):

   * ``skew_ns[S, N]`` — each ToR's clock offset from fabric time, built
     from skew/drift events;
   * ``phase_off[S, N]`` — whole *slices* of that offset
     (``round(skew_ns / slice_ns)``): a ToR one slice behind consults its
     time-flow tables at the wrong slice, so it injects into the wrong
     slice's circuit (live only if the schedule happens to provide it —
     otherwise the packet misses and re-enqueues via §5.2 deferral);
   * ``skew_miss[S, N]`` — the *residual* offset exceeds ``guardband_ns``
     (§7): the ToR's optical transmissions miss the guard band entirely
     that slice and are cut at admission (the electrical fabric is
     asynchronous and unaffected). A residual inside the guard band is
     absorbed — exactly what the band is budgeted for;
   * ``ctrl_delay[S, N]`` / ``ctrl_ok[S, N]`` — slices of delay (and
     seeded survival) for a table-install message sent at slice ``s`` to
     ToR ``n``. Read by the versioned installs of
     :func:`repro_torch.core.reconfigure.reconfigure`, not by the fabric
     itself.

2. **Fabric threading** — :func:`repro_torch.core.fabric.simulate` accepts
   the masks via its ``control=`` argument; the step branches only on
   their *presence*, so ``control=None`` runs exactly the zero-skew step.

3. **Versioned installs** (:func:`install_schedule`) — the host-side
   arithmetic of retries, backoff and acks: attempt ``k`` is sent at
   ``t0 + k * backoff``, arrives at ToR ``n`` at ``send + ctrl_delay[send,
   n]`` iff ``ctrl_ok[send, n]``, and a two-phase install activates at the
   first slice boundary where every ToR has acked — or times out.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "OPEN_END",
    "CTRL_KINDS",
    "ControlEvent",
    "ControlTrace",
    "ControlMasks",
    "random_control_trace",
    "compile_control",
    "install_schedule",
]

# open-ended control faults (no heal scheduled yet) end "never"
OPEN_END = 1 << 30

# arrival sentinel for install messages lost on every attempt
NEVER = 1 << 30

CTRL_KINDS = ("skew", "drift", "install_delay", "install_loss", "stall")


@dataclasses.dataclass(frozen=True)
class ControlEvent:
    """One control-plane fault, active over absolute slices
    ``[t_start, t_end)`` (``t_end == OPEN_END`` means "until healed").

    skew: ToR ``node``'s clock runs ``skew_ns`` ahead (< 0 behind) of
        fabric time for the window (it re-syncs at ``t_end``).
    drift: ToR ``node``'s clock drifts ``drift_ns`` per slice over the
        window, accumulating from zero (re-sync at ``t_end``).
    install_delay: table-install messages *sent* during the window to
        ``node`` (-1 = every ToR) take ``delay`` extra slices.
    install_loss: such messages are lost with probability ``loss``
        (drawn reproducibly at compile time from the compile seed).
    stall: the controller is stalled — messages sent during the window
        (to every ToR) only get out when the stall ends.
    """

    kind: str
    t_start: int
    t_end: int = OPEN_END
    node: int = -1
    skew_ns: float = 0.0
    drift_ns: float = 0.0
    delay: int = 0
    loss: float = 0.0

    def __post_init__(self):
        if self.kind not in CTRL_KINDS:
            raise ValueError(f"unknown control fault kind {self.kind!r}: "
                             f"expected one of {CTRL_KINDS}")
        if self.t_end <= self.t_start:
            raise ValueError(f"empty control fault window [{self.t_start}, "
                             f"{self.t_end})")
        if self.kind in ("skew", "drift") and self.node < 0:
            raise ValueError(f"{self.kind} needs node >= 0 (got {self.node})"
                             " — clock faults are per-ToR")
        if self.kind == "install_delay" and self.delay < 0:
            raise ValueError(f"install_delay needs delay >= 0 "
                             f"(got {self.delay})")
        if self.kind == "install_loss" and not 0.0 <= self.loss <= 1.0:
            raise ValueError(f"install_loss probability {self.loss} "
                             "outside [0, 1]")


@dataclasses.dataclass
class ControlTrace:
    """An ordered, reproducible list of :class:`ControlEvent`\\ s with
    builder helpers (each returns ``self`` for chaining)."""

    events: list[ControlEvent] = dataclasses.field(default_factory=list)

    def skew(self, node: int, skew_ns: float, t_start: int,
             t_end: int = OPEN_END) -> "ControlTrace":
        self.events.append(ControlEvent("skew", t_start, t_end, node=node,
                                        skew_ns=skew_ns))
        return self

    def drift(self, node: int, drift_ns: float, t_start: int,
              t_end: int = OPEN_END) -> "ControlTrace":
        self.events.append(ControlEvent("drift", t_start, t_end, node=node,
                                        drift_ns=drift_ns))
        return self

    def install_delay(self, delay: int, t_start: int,
                      t_end: int = OPEN_END, node: int = -1) -> "ControlTrace":
        self.events.append(ControlEvent("install_delay", t_start, t_end,
                                        node=node, delay=delay))
        return self

    def install_loss(self, loss: float, t_start: int,
                     t_end: int = OPEN_END, node: int = -1) -> "ControlTrace":
        self.events.append(ControlEvent("install_loss", t_start, t_end,
                                        node=node, loss=loss))
        return self

    def stall(self, t_start: int, t_end: int) -> "ControlTrace":
        if t_end >= OPEN_END:
            raise ValueError("a controller stall needs a finite t_end — "
                             "messages queued behind it leave when it ends")
        self.events.append(ControlEvent("stall", t_start, t_end))
        return self

    def heal_all(self, t: int) -> "ControlTrace":
        """End every fault active at slice ``t`` and drop events that were
        scheduled to start later."""
        self.events = [dataclasses.replace(e, t_end=min(e.t_end, t))
                       for e in self.events if e.t_start < t]
        return self

    def active_in(self, t0: int, t1: int) -> bool:
        """Whether any event overlaps ``[t0, t1)`` — lets callers skip mask
        compilation (and the fabric's control branch) for clean windows."""
        return any(e.t_start < t1 and e.t_end > t0 for e in self.events)


def random_control_trace(seed: int, n_nodes: int, num_slices: int,
                         n_events: int = 4,
                         kinds: tuple[str, ...] = CTRL_KINDS,
                         max_skew_ns: float = 3000.0,
                         max_delay: int = 4) -> ControlTrace:
    """A seeded, reproducible random control-fault trace: ``n_events``
    events of the given ``kinds`` with windows inside ``[0, num_slices)``
    (~half open-ended until the run's end)."""
    rng = np.random.default_rng(seed)
    tr = ControlTrace()
    for _ in range(n_events):
        kind = kinds[int(rng.integers(len(kinds)))]
        t0 = int(rng.integers(0, max(num_slices - 1, 1)))
        t1 = OPEN_END if kind != "stall" and rng.random() < 0.5 else \
            int(rng.integers(t0 + 1, num_slices + 1))
        node = int(rng.integers(n_nodes))
        if kind == "skew":
            tr.skew(node, float(rng.uniform(-max_skew_ns, max_skew_ns)),
                    t0, t1)
        elif kind == "drift":
            tr.drift(node, float(rng.uniform(-max_skew_ns, max_skew_ns))
                     / max(num_slices, 1), t0, t1)
        elif kind == "install_delay":
            tr.install_delay(int(rng.integers(1, max_delay + 1)), t0, t1,
                             node=node if rng.random() < 0.5 else -1)
        elif kind == "install_loss":
            tr.install_loss(float(rng.uniform(0.2, 0.9)), t0, t1,
                            node=node if rng.random() < 0.5 else -1)
        else:
            tr.stall(t0, t1)
    return tr


@dataclasses.dataclass
class ControlMasks:
    """Dense per-slice control-plane state, the lowering of a
    :class:`ControlTrace` (see :func:`compile_control` and the module
    docstring for the field semantics)."""

    skew_ns: np.ndarray     # [S, N] float32: ToR clock offset from fabric time
    phase_off: np.ndarray   # [S, N] int32: whole slices of that offset
    skew_miss: np.ndarray   # [S, N] bool: residual offset > guard band
    ctrl_delay: np.ndarray  # [S, N] int32: install-message delay in slices
    ctrl_ok: np.ndarray     # [S, N] bool: install message survives
    slice_ns: float = 2000.0
    guardband_ns: float = 200.0

    @property
    def num_slices(self) -> int:
        return int(self.skew_ns.shape[0])

    @property
    def num_nodes(self) -> int:
        return int(self.skew_ns.shape[1])

    @classmethod
    def perfect(cls, num_slices: int, n_nodes: int, slice_ns: float = 2000.0,
                guardband_ns: float = 200.0) -> "ControlMasks":
        return cls(np.zeros((num_slices, n_nodes), np.float32),
                   np.zeros((num_slices, n_nodes), np.int32),
                   np.zeros((num_slices, n_nodes), bool),
                   np.zeros((num_slices, n_nodes), np.int32),
                   np.ones((num_slices, n_nodes), bool),
                   slice_ns=slice_ns, guardband_ns=guardband_ns)

    def validate(self, num_slices: int, n_nodes: int) -> None:
        shp = (num_slices, n_nodes)
        for f in ("skew_ns", "phase_off", "skew_miss", "ctrl_delay",
                  "ctrl_ok"):
            if getattr(self, f).shape != shp:
                raise ValueError(
                    f"control masks {f} shaped {getattr(self, f).shape} "
                    f"do not cover the run ({shp})")


def compile_control(trace: ControlTrace, num_slices: int, n_nodes: int,
                    slice_ns: float | None = None,
                    guardband_ns: float | None = None,
                    t0: int = 0, seed: int = 0) -> ControlMasks:
    """Lower a control-fault trace into :class:`ControlMasks` covering
    absolute slices ``[t0, t0 + num_slices)``.

    ``slice_ns`` and ``guardband_ns`` default to the paper-§7 derivation
    (:func:`repro.core.guardband.derive`): the minimum slice duration
    (2 us) and the 200 ns guard band. A skew residual inside the guard
    band is absorbed; beyond it the ToR misses its optical slices; a
    skew of whole slices shifts its table lookups instead
    (``phase_off``). Skew events on the same ToR add; drift accumulates
    per slice from its window start. Install-loss survival is drawn once
    per (slice, ToR) from ``seed``, so a trace compiles to the same
    masks every time.
    """
    if slice_ns is None or guardband_ns is None:
        from .guardband import derive
        gb = derive()
        slice_ns = gb.min_slice_us * 1000.0 if slice_ns is None else slice_ns
        guardband_ns = gb.guardband_ns if guardband_ns is None else \
            guardband_ns
    if slice_ns <= 0:
        raise ValueError(f"slice_ns must be positive (got {slice_ns})")
    S, N = num_slices, n_nodes
    m = ControlMasks.perfect(S, N, slice_ns=slice_ns,
                             guardband_ns=guardband_ns)
    skew = np.zeros((S, N), np.float64)
    loss = np.zeros((S, N), np.float64)
    for e in trace.events:
        if e.node >= N:
            raise ValueError(f"{e.kind} fault indexes outside the fabric "
                             f"(node={e.node}, N={N})")
        a = max(e.t_start - t0, 0)
        b = min(e.t_end - t0, S)
        if b <= a:
            continue
        w = slice(a, b)
        nodes = slice(None) if e.node < 0 else e.node
        if e.kind == "skew":
            skew[w, e.node] += e.skew_ns
        elif e.kind == "drift":
            # accumulate from the event's absolute start, so a window
            # clipped by t0 enters mid-drift rather than restarting
            steps = np.arange(a, b) - (e.t_start - t0) + 1
            skew[w, e.node] += e.drift_ns * steps
        elif e.kind == "install_delay":
            m.ctrl_delay[w, nodes] += e.delay
        elif e.kind == "install_loss":
            # independent loss sources compose
            loss[w, nodes] = 1.0 - (1.0 - loss[w, nodes]) * (1.0 - e.loss)
        else:  # stall: sends queue behind the stall until it ends
            ts = np.arange(a, b)
            m.ctrl_delay[ts, :] = np.maximum(m.ctrl_delay[ts, :],
                                             (b - ts)[:, None])
    m.skew_ns = skew.astype(np.float32)
    m.phase_off = np.rint(skew / slice_ns).astype(np.int32)
    resid = skew - m.phase_off.astype(np.float64) * slice_ns
    m.skew_miss = np.abs(resid) > guardband_ns
    rng = np.random.default_rng(seed)
    m.ctrl_ok = rng.random((S, N)) >= loss
    return m


def install_schedule(masks: ControlMasks, t0: int, retries: int = 0,
                     backoff: int = 1, timeout: int = NEVER) -> dict:
    """Host-side reference of the versioned-install arithmetic
    :func:`repro.core.reconfigure.reconfigure` runs inside its epoch scan
    (``ReconfigConfig.install``); kept in numpy so tests can replay the
    device's install decisions exactly.

    Attempt ``k`` (``0 <= k <= retries``) is sent at ``t0 + k * backoff``
    and reaches ToR ``n`` at ``send + ctrl_delay[send, n]`` iff
    ``ctrl_ok[send, n]`` (send slices beyond the trace clamp to its last
    slice). Returns a dict with:

    * ``arr[N]`` — each ToR's earliest arrival over all attempts
      (:data:`NEVER` if every attempt is lost);
    * ``act`` — the activation boundary ``max(arr)``;
    * ``success`` — ``act - t0 <= timeout``: every ToR acked in time;
    * ``retries_used`` — first attempt index after which all ToRs had
      acked within the timeout (``retries`` if none);
    * ``latency`` — ``act - t0`` when successful, else -1.
    """
    if backoff < 1:
        raise ValueError(f"install backoff must be >= 1 slice (got {backoff})")
    if retries < 0 or timeout < 1:
        raise ValueError(f"install retries must be >= 0 and timeout >= 1 "
                         f"(got {retries}, {timeout})")
    S = masks.num_slices
    sends = t0 + np.arange(retries + 1, dtype=np.int64) * backoff
    sidx = np.minimum(sends, S - 1)
    a_k = np.where(masks.ctrl_ok[sidx],
                   sends[:, None] + masks.ctrl_delay[sidx], NEVER)  # [A, N]
    arr = a_k.min(axis=0)
    cum = np.minimum.accumulate(a_k, axis=0)
    act_k = cum.max(axis=1)
    ok_k = act_k <= t0 + timeout
    act = int(arr.max())
    success = bool(ok_k[-1])
    retries_used = int(np.argmax(ok_k)) if ok_k.any() else retries
    return dict(arr=arr.astype(np.int64), act=act, success=success,
                retries_used=retries_used,
                latency=act - t0 if success else -1)
