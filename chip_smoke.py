#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel); print the build time, ptxas's resource report and
   the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, bit for
   bit: at the main path's shapes (108 ToRs, K = 4, 131,072 packets;
   admission with 11,772 and 108 keys) and at edge shapes.
3. Time each kernel and its plain version with CUDA events (median of
   repeats, each repeat a CUDA graph of back-to-back calls), and each
   kernel's launch floor (the same call on one packet).
4. Run the main path at the paper's 108-ToR scale through
   ``OpenOpticsNet(..., device="cuda")``: ``round_robin(108, 1)`` + ``vlb``,
   an RPC workload of ~131k packets, 214 slices (two schedule cycles), once
   with the default fabric and once with push-back + offloading. The kernel
   launch counters are zeroed before these runs and read after them.
5. Re-run the first 48 slices of both configurations on the CPU (the plain
   versions) and require every ``SimResult`` field equal to the card's run.
6. Profile 16 steady-state slices of the main path: device time by
   kernel, and the device's idle share against the wall time of the same
   profiled run. The same slices run once more without the profiler, to
   show what the profiler adds to the wall time.

Prints one JSON line of per-kernel numbers and, last, the ``{"ok": true,
"device": ...}`` line. Exits non-zero, with no result, when CUDA is absent
or any phase fails.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_TORS = 108
SLICE_US = 6.0          # 100 Gbps x 6 us = 75,000 B per circuit per slice
SLICES = 214            # two cycles of the 107-slice rotor schedule
CPU_SLICES = 48
P_MAIN = 1 << 17        # packets of the main path, and of the kernel inputs
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
CORE_OPS_PER_S = 67e12      # H100 SXM rate outside the tensor cores
MAIN_CONFIGS = [("default", {}), ("pushback+offload",
                                  dict(pushback=True, offload=True))]


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def graph_ms(fn, calls: int = 10, repeats: int = 7) -> float:
    """Median device time of one ``fn()`` call: ``calls`` calls captured
    back to back in a CUDA graph, the graph replayed ``repeats`` times
    between CUDA events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()                                   # warm: allocator, caches
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def mismatch(a, b) -> tuple[int, int]:
    """(count of differing elements, max |a - b|) over int/bool tensors."""
    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    return int((d != 0).sum()), int(d.max()) if d.numel() else 0


def check_lookup(dev, stk_n, stk_d):
    """Kernel vs plain version for the lookup over the main-path shape and
    the edge shapes; returns (mismatches, max error)."""
    from repro_torch.kernels import time_flow_lookup as tfl

    def case(tn, td, P, seed, per_packet=True):
        rng = np.random.default_rng(seed)
        _, Tr, N, D, _ = tn.shape
        node = torch.tensor(rng.integers(0, N, P), dtype=torch.int32, device=dev)
        dst = torch.tensor(rng.integers(0, D, P), dtype=torch.int32, device=dev)
        hv = torch.tensor(rng.integers(-2 ** 31, 2 ** 31, P), dtype=torch.int32,
                          device=dev)
        sel = (torch.tensor(rng.integers(0, 2, P), dtype=torch.int32,
                            device=dev) if per_packet else 1)
        tm = int(rng.integers(0, Tr))
        got = tfl.time_flow_lookup(tn, td, tm, sel, node, dst, hv)
        want = tfl.time_flow_lookup_plain(tn, td, tm, sel, node, dst, hv)
        torch.cuda.synchronize()
        res = [mismatch(g, w) for g, w in zip(got, want)]
        return sum(r[0] for r in res), max(r[1] for r in res)

    # small random tables with contiguous valid slots, including empty rows
    rng = np.random.default_rng(1)
    n, k = 10, 4
    nv = rng.integers(0, k + 1, size=(2, 3, n, n))
    slot = np.arange(k)
    small_n = np.where(slot < nv[..., None], rng.integers(0, n, (2, 3, n, n, k)), -1)
    small_d = np.where(small_n >= 0, rng.integers(0, 8, (2, 3, n, n, k)), 0)
    sn = torch.tensor(small_n, dtype=torch.int32, device=dev)
    sd = torch.tensor(small_d, dtype=torch.int32, device=dev)
    cases = [("main P=131072 fused", stk_n, stk_d, 1 << 17, True),
             ("main P=131072 transit", stk_n, stk_d, 1 << 17, False)]
    for P in (1, 7, 255, 4097):
        cases.append((f"edge P={P}", sn, sd, P, True))
        cases.append((f"edge P={P} main tables", stk_n, stk_d, P, False))
    total, worst = 0, 0
    for i, (name, tn, td, P, per_packet) in enumerate(cases):
        m, e = case(tn, td, P, seed=100 + i, per_packet=per_packet)
        log(f"  lookup {name}: mismatches={m}")
        total, worst = total + m, max(worst, e)
    return total, worst


def check_admission(dev, caps_row):
    """Kernel vs plain version for admission over the main-path shapes and
    the edge cases; returns (mismatches, max error)."""
    from repro_torch.kernels import admission as adm

    def case(key, size, want, cap, nk):
        t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)
        args = (t(key, torch.int32), t(size, torch.int32), t(want, torch.bool),
                t(cap, torch.int32))
        got = adm.admission_admit(*args, num_keys=nk)
        ref = adm.admission_admit_plain(*args, num_keys=nk)
        torch.cuda.synchronize()
        res = [mismatch(g, w) for g, w in zip(got, ref)]
        return sum(r[0] for r in res), max(r[1] for r in res), int(got[0].sum())

    rng = np.random.default_rng(2)
    N = N_TORS
    NK = N * (N + 1)
    P = P_MAIN
    sz = lambda p: rng.integers(64, 1501, p)
    live = np.flatnonzero(caps_row > 0)
    cases = [
        # capacity cut as the main path sees it: the live circuit keys,
        # 75,000 B each, ~1,200 packets per key
        ("main cap-cut NK=11772 live keys", rng.choice(live, P), sz(P),
         rng.random(P) < 0.6, caps_row, NK),
        ("main cap-cut NK=11772 uniform", rng.integers(0, NK, P), sz(P),
         rng.random(P) < 0.6, rng.integers(0, 20_000, NK), NK),
        ("main rx-cut NK=108", rng.integers(0, N, P), sz(P),
         rng.random(P) < 0.5, rng.integers(0, 2_000_000, N), N),
        ("all unwanted", rng.integers(0, NK, 4097), sz(4097),
         np.zeros(4097, bool), rng.integers(0, 75_000, NK), NK),
        ("zero capacity", rng.integers(0, NK, 4097), sz(4097),
         np.ones(4097, bool), np.zeros(NK, np.int64), NK),
        ("one hot key", np.full(P, 5), sz(P), rng.random(P) < 0.9,
         np.full(NK, 3_000_000), NK),
    ]
    for p in (1, 7, 255, 4097):
        cases.append((f"edge P={p}", rng.integers(0, 300, p), sz(p),
                      rng.random(p) < 0.7, rng.integers(0, 6000, 300), 300))
    total, worst = 0, 0
    for name, key, size, want, cap, nk in cases:
        m, e, n_adm = case(key, size, want, cap, nk)
        log(f"  admission {name}: mismatches={m} admitted={n_adm}/{len(key)}")
        total, worst = total + m, max(worst, e)
    return total, worst


def self_device_ms(e) -> float:
    """Self device time of a profiler row in ms (the attribute was named
    ``self_cuda_time_total`` before torch 2.4)."""
    us = getattr(e, "self_device_time_total", None)
    return (e.self_cuda_time_total if us is None else us) / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core import (FabricConfig, FabricTables, OpenOpticsNet,
                                  flow_fcts, round_robin, simulate,
                                  synthesize, vlb)
    from repro_torch.core.fabric import _build_caps_all, stack_tables
    from repro_torch.kernels import _build, admission as adm
    from repro_torch.kernels import time_flow_lookup as tfl

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build(["time_flow_lookup", "admission"])
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s  "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    for name, out in _build.build_logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"nvidia-smi: {smi}")
    log(f"device: {kind}, count {torch.cuda.device_count()}")

    # -- 2. kernels vs plain versions ----------------------------------------
    sched = round_robin(N_TORS, 1)
    routing = vlb(sched, kpaths=4)
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    stk_n, stk_d = stack_tables(i32(routing.inj_next), i32(routing.inj_dep),
                                i32(routing.tf_next), i32(routing.tf_dep))
    caps = _build_caps_all(i32(sched.conn), FabricConfig(), N_TORS)
    log("phase 2 kernels vs plain versions")
    tfl_mis, tfl_err = check_lookup(dev, stk_n, stk_d)
    adm_mis, adm_err = check_admission(dev, caps[0].cpu().numpy())
    if tfl_mis or adm_mis:
        raise SystemExit(f"kernel mismatches: lookup {tfl_mis}, "
                         f"admission {adm_mis}")

    # -- 3. timing at the main path's shapes -----------------------------------
    rng = np.random.default_rng(3)
    P = P_MAIN
    t32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    node, dstv = t32(rng.integers(0, N_TORS, P)), t32(rng.integers(0, N_TORS, P))
    hv = t32(rng.integers(-2 ** 31, 2 ** 31, P))
    sel = t32(rng.integers(0, 2, P))
    NK = N_TORS * (N_TORS + 1)
    live = np.flatnonzero(caps[0].cpu().numpy() > 0)
    key = t32(rng.choice(live, P))
    size = t32(rng.integers(64, 1501, P))
    want = torch.tensor(rng.random(P) < 0.6, device=dev)
    cap = caps[0].contiguous()
    timings = dict(
        tfl_ms=graph_ms(lambda: tfl.time_flow_lookup(
            stk_n, stk_d, 5, sel, node, dstv, hv)),
        tfl_plain_ms=graph_ms(lambda: tfl.time_flow_lookup_plain(
            stk_n, stk_d, 5, sel, node, dstv, hv)),
        adm_ms=graph_ms(lambda: adm.admission_admit(key, size, want, cap,
                                                    num_keys=NK)),
        adm_plain_ms=graph_ms(lambda: adm.admission_admit_plain(
            key, size, want, cap, num_keys=NK)),
    )
    rx_key = t32(rng.integers(0, N_TORS, P))
    room = t32(rng.integers(0, 2_000_000, N_TORS))
    timings["adm_rx_ms"] = graph_ms(lambda: adm.admission_admit(
        rx_key, size, want, room, num_keys=N_TORS))
    # launch floors: the same calls on one packet
    timings["tfl_floor_ms"] = graph_ms(lambda: tfl.time_flow_lookup(
        stk_n, stk_d, 5, sel[:1], node[:1], dstv[:1], hv[:1]))
    timings["adm_floor_ms"] = graph_ms(lambda: adm.admission_admit(
        key[:1], size[:1], want[:1], cap, num_keys=NK))
    log("phase 3 timing (ms per call, median): "
        + " ".join(f"{k}={v:.5f}" for k, v in timings.items()))

    # -- 4. main path at 108 ToRs ----------------------------------------------
    wl = synthesize("rpc", N_TORS, 64, slice_bytes=75_000, load=0.4,
                    max_packets=1 << 17, seed=0)
    P = wl.num_packets
    if P != P_MAIN:
        raise SystemExit(f"workload has {P} packets, not {P_MAIN}")
    log(f"phase 4 main path: {N_TORS} ToRs, T={sched.num_slices}, "
        f"{P} packets, {wl.num_flows} flows, {SLICES} slices")

    def make_net(fab):
        net = OpenOpticsNet(dict(node="rack", node_num=N_TORS, uplink=1,
                                 slice_us=SLICE_US, fabric=fab), device="cuda")
        assert net.deploy_topo(sched)
        net.deploy_routing(vlb(sched, kpaths=4), LOOKUP="hop",
                           MULTIPATH="packet")
        return net

    make_net({}).run(wl, 2)                 # warm: allocator and kernels
    torch.cuda.synchronize()
    tfl.launches = adm.launches = 0
    runs = {}
    for name, fab in MAIN_CONFIGS:
        net = make_net(fab)
        l0, a0 = tfl.launches, adm.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = net.run(wl, SLICES)           # ends in a copy to the host
        wall = time.perf_counter() - t0
        dl, da = tfl.launches - l0, adm.launches - a0
        cfg = net.fabric_cfg
        want_l = SLICES * (1 + cfg.hops_per_slice)
        want_a = SLICES * cfg.hops_per_slice * (2 if cfg.pushback else 1)
        if dl != want_l or da != want_a:
            raise SystemExit(f"{name}: launches lookup {dl} (want {want_l}), "
                             f"admission {da} (want {want_a})")
        done = res.t_deliver >= 0
        in_win = done & (res.t_deliver < SLICES)
        if res.t_deliver.shape != (P,) or res.buf_bytes.shape != (SLICES, N_TORS):
            raise SystemExit(f"{name}: unexpected result shapes")
        if int(res.delivered_bytes.astype(np.int64).sum()) != \
                int(wl.size[in_win].astype(np.int64).sum()):
            raise SystemExit(f"{name}: delivered bytes do not add up")
        if done.mean() < 0.5:
            raise SystemExit(f"{name}: only {done.mean():.3f} delivered")
        fct = flow_fcts(wl, res.t_deliver, SLICE_US)
        runs[name] = dict(
            delivered=float(done.mean()),
            fct_p50_us=float(np.percentile(fct, 50)),
            fct_p99_us=float(np.percentile(fct, 99)),
            reorder=int(res.reorder_cnt), dropped=int(res.dropped[-1]),
            slice_miss=int(res.slice_miss.sum()),
            max_buf_bytes=int(res.buf_bytes.max()),
            wall_s=wall, slices_per_s=SLICES / wall,
            packet_slices_per_s=P * SLICES / wall,
            lookup_launches=dl, admission_launches=da)
        log(f"  {name}: " + json.dumps(runs[name]))
    main_launches = dict(tfl=tfl.launches, adm=adm.launches)

    # -- 5. the CPU's plain versions agree on the first slices -----------------
    tables = FabricTables.build(sched, vlb(sched, kpaths=4))
    for name, fab in MAIN_CONFIGS:
        cfg = FabricConfig(**fab)
        t0 = time.perf_counter()
        a = simulate(tables, wl, cfg, CPU_SLICES, device="cuda")
        b = simulate(tables, wl, cfg, CPU_SLICES, device="cpu")
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if x.dtype != y.dtype or x.shape != y.shape or \
                    not np.array_equal(x, y):
                raise SystemExit(f"{name}: CUDA and CPU differ in {f.name}")
        log(f"phase 5 {name}: {CPU_SLICES} slices equal on CUDA and CPU "
            f"({time.perf_counter() - t0:.1f} s)")

    # -- 6. where the device time goes -----------------------------------------
    # 16 steady-state slices (24-39, while hosts still inject) of the
    # default configuration: once timed on the host clock, once under the
    # profiler for device time by kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.fabric import _device_arrays, _init_state, _make_step
    j = _device_arrays(tables, wl, dev)
    step = _make_step(j, FabricConfig(), per_packet_mp=True)

    def run_window(prof=None) -> float:
        """Wall ms of slices 24-39, after slices 0-23 set the state up."""
        state = _init_state(j, wl.num_flows)
        for t in range(24):
            step(state, t)
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        for t in range(24, 40):
            step(state, t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if prof is not None:
            prof.stop()
        return wall

    bare_ms = run_window()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    wall_ms = run_window(prof)
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and self_device_ms(e) > 0]
    ev.sort(key=lambda e: -self_device_ms(e))
    tot = sum(self_device_ms(e) for e in ev)
    log(f"phase 6 profile, default config, slices 24-39: device time "
        f"{tot / 16:.4f} ms per slice in {len(ev)} kernels, wall time "
        f"{wall_ms / 16:.4f} ms per slice in the same profiled run "
        f"(device idle share {1 - tot / wall_ms:.3f}); wall time "
        f"{bare_ms / 16:.4f} ms per slice in a run without the profiler")
    for e in ev[:14]:
        log(f"  {self_device_ms(e) / 16:8.4f} ms/slice "
            f"{self_device_ms(e) / tot:6.1%} x{e.count // 16:<4d}/slice "
            f"{e.key[:100]}")

    # -- results ----------------------------------------------------------------
    K = stk_n.shape[-1]
    # bytes each function must move: per packet its inputs and outputs,
    # plus the two slices (injection, transit) of both tables / the
    # capacities and admitted bytes per key
    tfl_bytes = P_MAIN * (4 * 4 + 2 * 4) + 2 * 2 * N_TORS * N_TORS * K * 4
    adm_bytes = P_MAIN * (4 + 4 + 1 + 1) + NK * 4 * 2
    # integer operations the function needs per packet: the lookup's row
    # index, K slot tests, a modulo and two gathers; admission's key
    # check, one step of a per-key running sum, a compare and an add
    tfl_ops, adm_ops = P_MAIN * (6 + K + 3), P_MAIN * 6

    def bound(nbytes, ops):
        b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / CORE_OPS_PER_S * 1e3
        return dict(bound_ms=max(b, o),
                    bound_by="bytes" if b >= o else "operations")
    kernels = [
        dict(name="time_flow_lookup", route="cuda",
             source="src/repro_torch/csrc/time_flow_lookup.cu",
             replaces="src/repro/kernels/time_flow_lookup.py:43",
             launches=main_launches["tfl"], mismatches=tfl_mis,
             max_abs_err=tfl_err, ms=timings["tfl_ms"],
             plain_ms=timings["tfl_plain_ms"],
             **bound(tfl_bytes, tfl_ops),
             library_ms=None, launch_floor_ms=timings["tfl_floor_ms"]),
        dict(name="admission_admit", route="cuda",
             source="src/repro_torch/csrc/admission.cu",
             replaces="src/repro/kernels/admission.py:76",
             launches=main_launches["adm"], mismatches=adm_mis,
             max_abs_err=adm_err, ms=timings["adm_ms"],
             plain_ms=timings["adm_plain_ms"],
             **bound(adm_bytes, adm_ops),
             library_ms=None, launch_floor_ms=timings["adm_floor_ms"],
             rx_cut_ms=timings["adm_rx_ms"]),
    ]
    log(smi)                                # card name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
