#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel); print the build time, ptxas's resource report and
   the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, bit for
   bit: at the main path's shapes (108 ToRs, K = 4, 131,072 packets;
   admission with 11,772 and 108 keys), at edge shapes, at the edges of
   admission's tiles and steps, and above its shared-memory key limit.
   The lookup also in the port's form, each call replayed from a CUDA
   graph whose outputs are poisoned first: the packed table with masks of
   density 0, 1%, 50% and 100% and all-false masks at odd sizes, the
   in-kernel hash at six slices, and small tables of every row-load route
   (K of 1 to 12, the two stacks, unequal injection and transit K); and
   with per-node slice offsets drawn from [-2 Tr, 2 Tr] (0 and -1 among
   them) at both lookup sites, at the main path's shape with masks of
   100%, 10% and 1% and on small tables of every route; and with the
   version axis of the reconfigure loop's installs: V of 1 to 3, each
   version a different table, ``vsel`` the same at every node or drawn per
   node (some out of range, which clamp), alone and with the offsets, at
   both sites, at the main path's shape with the three masks and on small
   tables of every route; and with a scenario sweep's per-scenario hash
   index: B of 1, 2 and 8 scenarios' tables on the node axis, 16,411
   packets a scenario (not a multiple of the block), both sites, two
   masks, offsets at B = 8; on random tables of the main path's width
   with 0 to 4 valid slots an entry (so that a wrong hash index picks
   other slots), the same index beside the version axis (4 scenarios'
   versioned tables, a version and an offset a node row) and a sharded
   run's global hash index (the last rank's block of 5 and of 2 ranks).
3. Time each kernel and its plain version with CUDA events (median of
   repeats, each repeat a CUDA graph of back-to-back calls), and each
   kernel's launch floor (the same call on one packet); split admission's
   device time by pass with the profiler. The lookup in the TPU's form
   (two stacks, a hash vector, no mask) and in the port's (the packed
   table, the in-kernel hash, masks of density 100%, 10% and 1%), and the
   port's form with per-node slice offsets beside the same calls without
   them, in turns; and with offsets and a table version a node, at V = 2
   and 3, beside the same calls on the unversioned table, in turns; and
   with an 8-scenario sweep's per-scenario hash index beside the same
   calls without it, in turns; and with the last of 5 ranks' global hash
   index beside the same calls without it, in turns.
4. Run the main path at the paper's 108-ToR scale through
   ``OpenOpticsNet(..., device="cuda")``: ``round_robin(108, 1)`` + ``vlb``,
   an RPC workload of ~131k packets, 214 slices (two schedule cycles), once
   with the default fabric and once with push-back + offloading. The kernel
   launch counters are zeroed before these runs and read after them.
5. Re-run the first 48 slices of both configurations on the CPU (the plain
   versions) and require every ``SimResult`` field equal to the card's run.
6. Profile 16 steady-state slices of the main path: device time by
   kernel, the kernels launched per slice, the lookup's device time per
   call, and the device's idle share against the wall time of the same
   profiled run. The same slices run once more without the profiler, to
   show what the profiler adds to the wall time, and once more to read
   the lookups' mask densities.
7. Hold the language-model kernels (flash attention, flash-decode, the
   RG-LRU scan) against their plain versions on the card, within the
   tolerances of ``tests/test_kernels.py`` (per output row for the
   attention kernels): at the full width of
   RecurrentGemma-9B's serving path (prefill B = 4, L = S = 3,072, 16 q
   heads, 1 kv head, hd 256, window 2,048; decode over a wrapped 2,048-slot
   ring; the scan at B = 4, L = 3,072, W = 4,096), at Qwen3-30B-A3B's
   decode shape and at edge shapes (among them a cache whose only visible
   slot lies in flash-decode's last split, and query and key lengths one
   past flash attention's tiles). The scan also at the edges of its time
   tiles and channel stripes, with channels whose carry outlives many
   tiles, per channel as well as whole, and for one call captured in a
   CUDA graph and replayed twice on new inputs. The attention kernels also
   at the shapes of phases C and D: Seamless's (hd 64, one kv head a q
   head) bidirectional encoder, causal decoder and cross-attention (3,072
   queries over 1,024 frames), LLaVA's prefill (G = 7 at hd 128, 4,096
   positions), and their decode (the cross-attention's with every slot
   visible). A NaN fails every limit.
8. Time them as phase 3 does, beside their bounds, their plain versions
   and ``scaled_dot_product_attention`` on the same inputs (the scan beside
   one elementwise kernel that moves the same bytes); flash attention
   at both models' prefill shapes (Qwen3-30B-A3B's beside SDPA's own causal
   mask), flash-decode at both models' decode shapes; both kernels at the
   shapes of phases C and D.
9. Serve RecurrentGemma-9B at full width and depth (38 layers, random
   weights from a seed) through ``repro_torch.launch.serve.serve``: batch
   4, 8 requests (so slots are refilled), prompts of 3,072 tokens, 32 new
   tokens each. The kernel launch counters are zeroed before and read
   after, and must be 12 flash and 26 scan launches per prefill and 12
   flash-decode launches per decode step.
10. Run a full-width, 5-layer RecurrentGemma (one group plus the tail):
   prefill + 8 greedy decode steps through the kernels against the same
   weights and tokens through the plain versions, holding each step's
   logits by their largest and by their RMS error.
11. Profile one full-width prefill and 8 decode steps of RecurrentGemma-9B:
   device time by kernel and by layer (the scan's own line: its ms a
   prefill), and the device's idle share against the wall time of the same
   work without the profiler.
12. Hold the grouped matmul kernel (the MoE expert products) against its
   plain version on the card, per output row: at the four shapes of
   Qwen3-30B-A3B's MoE path (128 experts; M = 960 at prefill, 1 at decode;
   K x N = 2,048 x 768 and 768 x 2,048), at the decode's sparsity (32 of
   128 groups with a row, the rest exactly zero, which must come out
   exactly zero) and at edge shapes of the kernel's three routes (G = 1,
   M = 1, ragged M, N and K, an all-zero group); its float32 route at the
   path's shapes and ragged ones, within 1e-5 per row.
13. Time it as phase 3 does, beside its bound, its launch floor, its plain
   version and ``torch.bmm`` on the same tensors; the sparse decode input
   beside its dense bound and its bound over the groups with a row; the
   float32 route beside ``torch.bmm`` in float32.
14. Serve Qwen3-30B-A3B at full width and depth (48 layers, 128 experts,
   30.5B parameters, random weights from a seed) as phase 9 serves
   RecurrentGemma-9B. The counts must be 144 grouped matmul and 48 flash
   launches per prefill, 144 grouped matmul and 48 flash-decode launches
   per decode step.
15. Run a full-width, 4-layer Qwen3-30B-A3B: prefill (B = 4, L = 3,072) + 8
   greedy decode steps through the kernels against the same weights and
   tokens through the plain versions, as phase 10 does, and count the
   tokens whose top-8 expert set differs between the two runs.
16. Profile one full-width, full-depth Qwen3-30B-A3B prefill and 8 decode
   steps, as phase 11 does.
17. Run phase 4's default main path (214 slices) with the three optional
   inputs: faults injected through ``OpenOpticsNet.inject_failure`` (a ToR
   outage healed mid-run, a dead link, a degraded link, a stuck port) and
   ``inject_control`` (a ToR one slice behind, one a slice ahead, one whose
   residual skew passes the guard band, one that drifts), through
   ``run`` (launch counters zeroed before, read after) and through
   ``simulate(..., telemetry=TelemetryConfig())``. Hold the deferred-bytes
   counter of every slice against the packet state after it; profile
   slices 24-39 as phase 6 does; re-run the first 48 slices on the CPU and
   require every ``SimResult`` field and every telemetry counter equal.
   Print slices/s, device time and kernels launched per slice beside
   phases 4 and 6.
18. Run the clocked service at phase 17's size, faults and telemetry. The
   fabric's incremental API (``init_state`` with the packets injected
   before slice 72, the rest ingested in two batches at slices 72 and
   96, ``step_slices`` in 15 windows of unequal length, some of one
   slice, some crossing a fault's start or heal, each given its rows of
   the masks) against the one-shot ``simulate`` of the union on the card,
   every field and counter. Then ``OpenOpticsNet``'s service (``ingest``
   three batches, ``advance`` in windows of 16): every window's
   ``snapshot`` groups sum to its totals and its counters are the
   ``service_result``'s summed; the first 48 slices against the CPU's,
   every field and counter; ten more 214-slice windows of fresh demand,
   with the peak device memory of the first and the last. Launch counts
   of both runs zeroed before and read after; the wall time a slice of
   ``advance`` beside phase 17's ``run``, the kernels a slice of one
   profiled window, and a window's set-up (the packed table, the masked
   capacities, the whole step).
19. Run phased table swaps at the same size: ``vlb`` with 4 paths under
   phase 17's failure trace, the deployed tables up to ToR 17's outage,
   ``fast_reroute`` with ``backup_tables_dp`` at its failed links until
   the heal, ``repair("vlb", ...)`` over the links still failed after it.
   One phase equals ``simulate`` on the card; the three phases' first 48
   slices equal the CPU's; the patched and repaired tables pass
   ``toolkit.check_tables`` with the failed links. Print the share
   delivered per phase beside the oblivious run, and the host seconds of
   ``backup_tables``, ``backup_tables_dp``, ``fast_reroute`` and
   ``repair``.

20. Run the traffic-aware reconfigure loop at the same size, 12 epochs of
   16 slices (192), each epoch measuring the demand, re-deriving the
   schedule, recompiling the tables on the card and swapping them in:
   (a) ``k_hot=0`` with ``vlb`` (4 paths), which must equal ``simulate``
   in every field; (b) ``hot_slices`` (``k_hot=4``) with ``hoho`` under
   phase 17's control trace plus install loss, delay and a controller
   stall, once by hotswap and once by 2PC with degrade (and ``edmonds`` by
   hotswap, whose versions differ in most entries): the epochs with
   mixed versions and the degraded ones counted (at least one each), each
   run against a host replay of its versions (each ToR's old tables taken
   whole from the version it last installed, the installs from the host's
   ``install_schedule``), and its first 3 epochs against the CPU's, every
   ``ReconfigResult`` field; (c) ``edmonds`` and ``bvn`` with ``heal``
   under phase 17's failure masks, each against the host replay of its
   recorded schedules. Launch counts zeroed before each run and read after;
   slices/s, an epoch's wall split into measure + schedule, recompile and
   its slices, the kernels a slice and the lookup's device time of one
   profiled epoch, peak device memory.

21. The seven architectures of paper §6 Case I (clos, c-through,
   jupiter, mordia, rotornet, opera, rotornet-ucmp) through
   ``build_arch`` of ``examples/architecture_comparison_torch.py``, and the
   scenario sweep. (a) At fig8's size (8 ToRs, 10 us slices, 700 slices,
   its two traffic classes): each deployment's schedule and tables equal
   to the reference's (digests the CPU tests pin), each run on the card
   equal to the CPU's in every field, the FCT table printed. (b) At 108
   ToRs (phase 4's workload, 214 slices, 6 us slices): the host seconds of
   ``edmonds``, ``jupiter`` (4 uplinks) and ``bvn`` (216 peels) and their
   schedules' digests, slices/s and the lookup and admission launches a
   slice of each architecture, its first 16 slices equal to the CPU's. The
   CPU runs of (a) and (b) go to six worker processes while the card runs.
   (c) ``simulate_fleet`` at 108 ToRs: eight seeds of phase 4's workload on
   phase 4's fabric, and four failure and control traces of one workload
   with telemetry on ``ucmp`` (whose entries hold several paths); every
   member equal to its solo ``simulate`` on the card in every field and
   counter, each sweep's launches one scenario's; scenario-slices/s beside
   the solo runs', kernels and device time a slice of a profiled window of
   the eight-seed sweep (within 10% of phase 6's kernels at one scenario),
   peak device memory.

22. (a) ``reconfigure_fleet`` at 108 ToRs on phase 20's net, 12 epochs of
   16 slices, 131,072 packets a scenario: four seeds of 4 hot slices of
   ``hoho`` by hotswap under phase 20's control trace (each scenario's
   install loss from its own seed), and three random failure and control
   traces of one workload with ``heal`` and 2PC; every member equal to its
   solo ``reconfigure`` on the card in every field and counter, each
   sweep's launches one run's; scenario-slices/s beside the solo runs, an
   epoch's wall split (measure and schedule, the B recompiles, the
   slices), peak device memory. (b) ``simulate_sharded`` at 108 ToRs on
   phase 4's workload (214 slices) with phase 17's masks and telemetry, on
   ``vlb`` and on ``ucmp`` (several slots an entry): 1 rank over NCCL, 2,
   4 and 5 ranks sharing the card over gloo (4 and 5 over the first 64
   slices; each gloo rank count one spawned group for both schemes),
   each equal to the one-device run of its length in every field
   and counter, ``check_sharding`` clean, both fabric
   kernels launched one run's count on every rank; slices/s per rank
   count, exchanges and bytes exchanged a slice, rank 0's start-up by part
   (imports, unpickling, CUDA context, process group, the shard's set-up).

A. ``simulate_eqo`` at fig12's six update intervals (25 to 800 ns, 200,000
   ns, seed 0) on the card against the port's CPU run: the largest errors
   equal, the means within 1e-12 relative; fig12's two properties; the
   wall ms of each.
B. Serve xLSTM-350M at full width and depth (24 mLSTM / sLSTM blocks,
   random weights) as phase 9 serves RecurrentGemma-9B, but with 5
   requests on the 4 slots (one refill, each refill a full sLSTM prefill):
   no kernel of the port is on this path (every count 0). The sLSTM blocks' share of a
   prefill (each block synchronised) and the kernels one block launches
   (profiler). One mLSTM and one sLSTM block at full width: the mLSTM's
   chunkwise form against its parallel form and its recurrent steps on the
   card; a prefill (B = 2, L = 512) and 4 decode steps on the card against
   the same weights and tokens on the CPU.
C. Serve Seamless-M4T-large-v2 at full width and depth (24 encoder and 24
   decoder layers, 1,024 audio frames): 72 flash launches a prefill (24
   encoder, 24 decoder, 24 cross) and 48 flash-decode launches a step; the
   encoder's share of a prefill; 2 + 2 layers through the kernels against
   the plain versions (prefill B = 4, L = 3,072, 8 decode steps); one
   decoder layer's cross-attention against a plain computation.
D. Serve LLaVA-NeXT-34B at full width, 4 of its 60 layers (1,024 vision
   patches before each 3,072-token prompt, a 4,224-slot cache): 4 flash
   launches a prefill, 4 flash-decode a step; the serve's first decode
   step against the prefill of the prompt and its token; 4 layers through
   the kernels against the plain versions (B = 2).
E. Training. (a) Each kernel's gradient through its autograd Function
   against autograd through its plain version: flash attention (forward,
   the kernel with its log-sum-exp; the torch-op backward) at OLMo-1B's
   training shape, a windowed soft-capped GQA shape and Seamless's
   cross-attention, its LSE against ``torch.logsumexp``; the RG-LRU scan
   at RecurrentGemma's [4, 3,072, 4,096]; the grouped matmul at
   Qwen3-30B-A3B's prefill shapes; each backward timed beside the plain
   autograd's (and SDPA's forward + backward, the two ``torch.bmm``).
   (b) ``reduced(head_dim=64)`` RecurrentGemma and Qwen3-MoE: one
   micro-batch's gradients through the kernels against the plain versions
   (the plain run held to the kernel run's experts), the forward's and the
   backward's launches exact, 8 steps of ``make_train_step`` after which
   a held-out batch's loss is lower. (c) ``launch.train.train`` on
   OLMo-1B at full width and depth, 10 steps of 8 x 4,096 tokens in two
   micro-batches: losses, step time, tokens/s, share of 6ND at 989
   TFLOP/s, peak memory, exactly 2 flash launches a layer a micro-batch;
   one more step profiled. (d) The small preset crashed at step 5 and
   resumed from its checkpoint, bit-identical to the uninterrupted run.
   ``python3 chip_smoke.py --phase E`` runs phases 1 and E alone and
   prints no result line.
F. The expert-parallel MoE on ranks of the card, and the dry run. (a)
   Qwen3-30B-A3B at full width, 4 of its 48 layers, a prefill of B = 4 x
   L = 3,072 on one NCCL rank of a (1, 1) mesh, all 128 experts on the
   rank (each MoE layer's expert weights DTensors, so ``moe_apply`` takes
   its expert-parallel branch), against the same model's one-device run
   through the plain versions held to its experts, within phase 15's
   limits on the last token's logits. (b) Two gloo ranks sharing the card
   on a (1, 2) mesh, 64 experts a rank, held to (a)'s experts, against (a)
   on the logits and on every 16th token of each MoE layer's output
   (``EP_TOL``, ``EP_RMS_TOL``). (c) Each rank's grouped-matmul launches
   of a prefill, exactly 3 a layer. (d) Prefill seconds at 1 and 2 ranks,
   the all-reduce bytes a layer, peak memory a rank. (e) The dry run's
   olmo-1b x train_4k cell on the 16 x 16 fake mesh, in a process of its
   own on the host (started beside phase E), its roofline terms printed. ``python3 chip_smoke.py --phase F``
   runs phases 1 and F alone and prints no result line.

Prints one JSON line of per-kernel numbers and, last, the ``{"ok": true,
"device": ...}`` line. Exits non-zero, with no result, when CUDA is absent
or any phase fails.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
FLEET_HASH_PS = 16_411  # phase 2's packets per scenario of a sweep (odd)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
CORE_OPS_PER_S = 67e12      # H100 SXM rate outside the tensor cores
TC_BF16_FLOPS_PER_S = 989e12    # H100 SXM bf16 dense tensor-core peak
KERNELS = ["time_flow_lookup", "admission", "flash_attention",
           "decode_attention", "rg_lru", "grouped_matmul"]
MAIN_CONFIGS = [("default", {}), ("pushback+offload",
                                  dict(pushback=True, offload=True))]


def log(*a):
    print(*a, flush=True)


PHASE_T: list = []      # (phase, host clock at its start)


def phase_start(tag: str) -> None:
    PHASE_T.append((tag, time.perf_counter()))


def phase_seconds() -> dict:
    """Wall seconds of each phase so far (to the next one's start, the
    last to now)."""
    ends = [t for _, t in PHASE_T[1:]] + [time.perf_counter()]
    return {tag: round(e - t, 1) for (tag, t), e in zip(PHASE_T, ends)}


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


def poisoned(fn):
    """``fn()``'s outputs from one replay of a CUDA graph of the call, its
    output tensors filled with a sentinel before the replay: an output the
    kernel leaves unwritten keeps the sentinel."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    for o in out:
        o.fill_(0x5A5A5A5A)
    g.replay()
    return out


def lookup_tables(n, k, lead=(2, 3), seed=1):
    """Small random tables with contiguous valid slots, empty rows
    included: (next-hop, departure) numpy arrays of ``lead + (n, n, k)``."""
    rng = np.random.default_rng(seed)
    nv = rng.integers(0, k + 1, size=lead + (n, n))
    tn = np.where(np.arange(k) < nv[..., None],
                  rng.integers(0, n, lead + (n, n, k)), -1)
    td = np.where(tn >= 0, rng.integers(0, 8, lead + (n, n, k)), 0)
    return tn.astype(np.int32), td.astype(np.int32)


def versioned_tables(table, V: int = 3):
    """``[2, V, Tr, N, D, 2, K]`` from the packed ``table``: version 0 the
    table, version ``v`` its slices rolled by ``v`` and its nodes by
    ``5 v``, so that a lookup that reads the wrong version reads another
    entry."""
    return torch.stack([table.roll((v, 5 * v), dims=(1, 2))
                        for v in range(V)], dim=1).contiguous()


def check_lookup(dev, table):
    """Kernel vs plain version for the lookup: the TPU's form (two stacks,
    a hash vector, no mask) over the main-path shape and the edge shapes,
    then the packed table with masks, the in-kernel hash, per-node slice
    offsets at both sites and every row-load route (K of 1 to 12, unequal
    injection and transit K), each of these run from a CUDA graph whose
    outputs are poisoned first; returns (mismatches, max error)."""
    from repro_torch.core.fabric import stack_tables
    from repro_torch.kernels import time_flow_lookup as tfl

    t32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)

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

    def new_case(tbl, P, seed, density=None, t=None, offsets=False,
                 per_packet=True, vsel=None, hp=None, hb=None):
        """The port's form on ``tbl`` (packed, or a (next, dep) pair):
        a mask of the given density (None: no mask), the in-kernel hash of
        slice t (None: a hash vector), per-node slice offsets drawn from
        [-2 Tr, 2 Tr] with 0 and -1 among them (offsets), a selector per
        packet or the hop site's constant 1 (per_packet), a table version
        per node (vsel: None, "uniform" the last version at every node,
        "mixed" drawn per node, "clamped" drawn from [-1, V] so some
        clamp), a scenario sweep's hash period (hp: packet i hashes i mod
        hp), a shard's hash base (hb: packet i hashes hb + i, its global
        index); the plain version gets the hash vector ``salted_hash``
        makes for t (of each index mod hp, plus hb)."""
        rng = np.random.default_rng(seed)
        tn, td = (tbl, None) if isinstance(tbl, torch.Tensor) else tbl
        V, Tr, N, D, _ = tfl.table_dims(tn, td)
        node, dst = t32(rng.integers(0, N, P)), t32(rng.integers(0, D, P))
        sel = t32(rng.integers(0, 2, P)) if per_packet else 1
        mask = None if density is None else torch.tensor(
            rng.random(P) < density, device=dev)
        po = None
        if offsets:
            po = rng.integers(-2 * Tr, 2 * Tr + 1, N)
            po[:2] = (0, -1)
            po = t32(po)
        vs = None
        if vsel == "uniform":
            vs = t32(np.full(N, V - 1))
        elif vsel is not None:
            lo, hi = (-1, V + 1) if vsel == "clamped" else (0, V)
            vs = rng.integers(lo, hi, N)
            vs[:V] = np.arange(V)           # every version read somewhere
            vs = t32(vs)
        tm = int(rng.integers(0, Tr))
        if t is None:
            hv = t32(rng.integers(-2 ** 31, 2 ** 31, P))
            hv_plain = hv
        else:
            hv = t
            pid = torch.arange(P, dtype=torch.int64, device=dev)
            pid = pid if hp is None else pid % hp
            hv_plain = tfl.salted_hash(pid if hb is None else pid + hb, t)
        got = poisoned(lambda: tfl.time_flow_lookup(
            tn, td, tm, sel, node, dst, hv, mask=mask, phase_off=po,
            vsel=vs, hash_period=hp, hash_base=hb))
        want = tfl.time_flow_lookup_plain(tn, td, tm, sel, node, dst,
                                          hv_plain, mask, phase_off=po,
                                          vsel=vs)
        torch.cuda.synchronize()
        res = [mismatch(g, w) for g, w in zip(got, want)]
        return sum(r[0] for r in res), max(r[1] for r in res)

    stk_n = table[..., 0, :].contiguous()
    stk_d = table[..., 1, :].contiguous()
    # small random tables with contiguous valid slots, including empty rows
    sn, sd = (t32(a) for a in lookup_tables(10, 4))
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

    new_cases = []
    for d in (0.0, 0.01, 0.5, 1.0):
        new_cases.append((f"packed P=131072 mask density {d}", table,
                          1 << 17, dict(density=d)))
    for P in (1, 7, 255, 4097):
        new_cases.append((f"packed P={P} all-false mask", table, P,
                          dict(density=0.0)))
    for t in (0, 1, 107, 213, 65_536, 2 ** 31 - 1):
        new_cases.append((f"packed P=131072 in-kernel hash t={t}", table,
                          1 << 17, dict(t=t)))
    new_cases.append(("packed P=131072 in-kernel hash t=213, mask 0.5",
                      table, 1 << 17, dict(t=213, density=0.5)))
    for k in (1, 2, 3, 4, 6, 8, 12):
        tn, td = lookup_tables(10, k, seed=k)
        packed = t32(np.stack([tn, td], axis=4))
        new_cases.append((f"small K={k} packed", packed, 4097,
                          dict(density=0.5, t=7)))
        new_cases.append((f"small K={k} stacks", (t32(tn), t32(td)), 4097,
                          dict(density=0.5)))
    # per-node slice offsets (a skewed ToR's local slice), at both sites:
    # the main path's shape at its three densities, then every row-load
    # route
    for d in (1.0, 0.1, 0.01):
        for site, per_packet in (("fused", True), ("hop", False)):
            new_cases.append((f"packed P=131072 offsets, {site} site, mask "
                              f"{d}", table, 1 << 17,
                              dict(density=d, t=213, offsets=True,
                                   per_packet=per_packet)))
    for k in (1, 2, 3, 4, 6, 8, 12):
        tn, td = lookup_tables(10, k, lead=(2, 5), seed=30 + k)
        packed = t32(np.stack([tn, td], axis=4))
        new_cases.append((f"small K={k} packed offsets", packed, 4097,
                          dict(density=0.5, t=7, offsets=True)))
        new_cases.append((f"small K={k} stacks offsets, hop site",
                          (t32(tn), t32(td)), 4097,
                          dict(density=0.5, offsets=True, per_packet=False)))
    for k_inj, k_tf in ((3, 1), (2, 4)):
        inj, tf = lookup_tables(10, k_inj, (3,), 20), lookup_tables(10, k_tf,
                                                                    (3,), 21)
        padded = stack_tables(*(t32(a) for a in inj + tf))
        new_cases.append((f"small K inj {k_inj} transit {k_tf} padded",
                          padded, 4097, dict(density=0.5, t=9)))
    # the version axis (the reconfigure loop's installs): V of 1 to 3 at
    # the main path's shape, every version a different table (the slices
    # and the nodes rolled), vsel the same at every node or drawn per node,
    # alone and with offsets, at both sites and three densities; then small
    # tables of every row-load route
    vtab = versioned_tables(table)
    vtabs = {V: vtab[:, :V].contiguous() for V in (1, 2, 3)}
    for V in (1, 2, 3):
        for d in (1.0, 0.1, 0.01):
            for mode in ("uniform", "mixed"):
                for offs in (False, True):
                    for site, per_packet in (("fused", True), ("hop",
                                                               False)):
                        new_cases.append((
                            f"versioned V={V} P=131072 vsel {mode}"
                            f"{', offsets' if offs else ''}, {site} site, "
                            f"mask {d}", vtabs[V], 1 << 17,
                            dict(density=d, t=213, offsets=offs,
                                 per_packet=per_packet, vsel=mode)))
    for k in (1, 2, 3, 4, 6, 8, 12):
        tn, td = lookup_tables(10, k, lead=(2, 3, 4), seed=50 + k)
        packed = t32(np.stack([tn, td], axis=-2))
        new_cases.append((f"small K={k} packed V=3 vsel clamped, offsets",
                          packed, 4097, dict(density=0.5, t=7, offsets=True,
                                             vsel="clamped")))
        new_cases.append((f"small K={k} stacks V=3 vsel mixed, hop site",
                          (t32(tn), t32(td)), 4097,
                          dict(density=0.5, per_packet=False, vsel="mixed")))
    # a scenario sweep's per-scenario hash index (simulate_fleet): B
    # scenarios' tables stacked on the node axis (each its own: slices
    # rolled by b), packets per scenario not a multiple of the 256-thread
    # block, both sites, masks, offsets per node row at B = 8
    for B in (1, 2, 8):
        ftab = torch.cat([table.roll(b, dims=1) for b in range(B)],
                         dim=2).contiguous()
        for site, per_packet in (("fused", True), ("hop", False)):
            for d in (0.5, 0.03):
                new_cases.append((
                    f"sweep B={B} P={B * FLEET_HASH_PS} per-scenario hash, "
                    f"{site} site, mask {d}", ftab, B * FLEET_HASH_PS,
                    dict(density=d, t=213, per_packet=per_packet,
                         hp=FLEET_HASH_PS, offsets=B == 8)))
        del ftab
    # the new hash indices below run on random tables of the main path's
    # width whose entries hold 0 to 4 valid slots: over vlb's one uplink an
    # entry keeps one valid slot, and a wrong hash index picks nothing else
    multi = t32(np.stack(lookup_tables(N_TORS, 4, lead=(2, 3), seed=77),
                         axis=4))
    # the sweep of the reconfigure loop (reconfigure_fleet): the
    # per-scenario hash index beside the version axis, 4 scenarios'
    # versioned tables on the node axis, a version and an offset a row
    vtab = versioned_tables(multi)
    ftab = torch.cat([vtab.roll(b, dims=2) for b in range(4)],
                     dim=3).contiguous()
    del vtab
    for site, per_packet in (("fused", True), ("hop", False)):
        for d in (0.5, 0.03):
            new_cases.append((
                f"sweep B=4 P={4 * FLEET_HASH_PS} per-scenario hash, V=3 "
                f"vsel mixed, offsets, {site} site, mask {d}", ftab,
                4 * FLEET_HASH_PS, dict(density=d, t=213,
                                        per_packet=per_packet,
                                        hp=FLEET_HASH_PS, vsel="mixed",
                                        offsets=True)))
    # a sharded run's global hash index (simulate_sharded): the last rank
    # of 5 and of 2 over the main path's packets hashes r·L + i
    for D in (5, 2):
        L = -(-P_MAIN // D)
        for site, per_packet in (("fused", True), ("hop", False)):
            for d in (1.0, 0.03):
                new_cases.append((
                    f"shard {D - 1} of {D} P={L} global hash index, {site} "
                    f"site, mask {d}", multi, L,
                    dict(density=d, t=213, per_packet=per_packet,
                         hb=(D - 1) * L, offsets=D == 5)))
    for i, (name, tbl, P, kw) in enumerate(new_cases):
        m, e = new_case(tbl, P, seed=200 + i, **kw)
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
    # the edges of the kernel's tiles (admission_tile: 2,048 packets at
    # 11,772 keys and ~129k packets; 1,024 at 108 keys and 131,072; 256 at
    # a few thousand) and of its 32-packet steps
    for p in (63 * 2048 - 1, 63 * 2048, 63 * 2048 + 1):
        assert adm.admission_tile(p, NK) == 2048
        cases.append((f"tile edge P={p} NK=11772", rng.integers(0, NK, p),
                      sz(p), rng.random(p) < 0.8,
                      rng.integers(0, 3000, NK), NK))
    # 1,025 tiles of 2,048: the scan's groups hold more tiles than its
    # threads keep in registers
    p = (1 << 21) + 1
    cases.append((f"scan of 1025 tiles P={p} NK=108", rng.integers(0, N, p),
                  sz(p), rng.random(p) < 0.5,
                  rng.integers(0, 20_000_000, N), N))
    for p in (P - 1, P + 1):    # 128 tiles of 1,024, and 65 of 2,048
        cases.append((f"tile edge P={p} NK=108", rng.integers(0, N, p),
                      sz(p), rng.random(p) < 0.5,
                      rng.integers(0, 2_000_000, N), N))
    for p in (31, 33, 256, 257, 2047, 2049):
        cases.append((f"tile edge P={p} NK=108 few keys",
                      rng.integers(0, 5, p), sz(p), rng.random(p) < 0.9,
                      rng.integers(0, 40_000, N), N))
    # above the shared-memory route's key limit: the running totals stay in
    # device memory
    big = adm.SMEM_KEYS + 1
    for p in (1, 2049, P):
        cases.append((f"global route NK={big} P={p}",
                      rng.integers(0, big, p), sz(p), rng.random(p) < 0.7,
                      rng.integers(0, 20_000, big), big))
    cases.append((f"global route NK={big}, one hot key", np.full(P, big - 1),
                  sz(P), rng.random(P) < 0.9, np.full(big, 3_000_000), big))
    total, worst = 0, 0
    for name, key, size, want, cap, nk in cases:
        m, e, n_adm = case(key, size, want, cap, nk)
        log(f"  admission {name}: mismatches={m} admitted={n_adm}/{len(key)}")
        total, worst = total + m, max(worst, e)
    return total, worst


# -- the language-model serving path (phases 7-11) ------------------------------

def finite_or_inf(x: float) -> float:
    """A NaN reading becomes +inf, so that it fails every limit (a NaN
    compares false against a limit and would pass it)."""
    return math.inf if math.isnan(x) else x


def relerr(a, b) -> float:
    """max |a - b| / max |b|, in float32 (the metric of tests/test_kernels.py)."""
    a, b = a.float(), b.float()
    return finite_or_inf(float((a - b).abs().max() / (b.abs().max() + 1e-6)))


def row_relerr(a, b) -> float:
    """The largest over rows (the last axis) of max |a - b| / max |b|
    within the row. A row of attention output is one query head's average
    of V; rows that attend thousands of keys have values ~30x smaller than
    rows that attend a few, so a whole-tensor max |b| would hide an error
    in them."""
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    return finite_or_inf(float(((a - b).abs().amax(-1)
                                / (b.abs().amax(-1) + 1e-6)).max()))


def abserr(a, b) -> float:
    return finite_or_inf(float((a.float() - b.float()).abs().max()))


def flash_inputs(dev, B, Hq, Hkv, L, S, hd, seed, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    return mk(B * Hq, L, hd), mk(B * Hkv, S, hd), mk(B * Hkv, S, hd)


def ring_cache(dev, B, S, Kv, hd, cur, seed, empty_all_but=None):
    """A decode cache after positions 0..cur were written into an S-slot
    ring: slot j holds the latest position p <= cur with p % S == j (or -1
    when none was written). ``empty_all_but`` empties every slot but that
    one (which holds ``cur`` if it was never written), or every slot when it
    is -1 (both kernels then average V)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    j = torch.arange(S, device=dev)
    pos = cur - ((cur - j) % S)
    pos = torch.where(pos >= 0, pos, -1).to(torch.int32).repeat(B, 1)
    if empty_all_but is not None:
        keep = pos[:, empty_all_but].clone()
        keep = torch.where(keep >= 0, keep, cur)
        pos.fill_(-1)
        if empty_all_but >= 0:
            pos[:, empty_all_but] = keep
    return mk(B, S, Kv, hd), mk(B, S, Kv, hd), pos.contiguous()


FLASH_FULL = dict(B=4, Hq=16, Hkv=1, L=3072, S=3072, hd=256,
                  kw=dict(causal=True, window=2048))
DECODE_FULL = dict(B=4, Hq=16, Kv=1, S=2048, hd=256, cur=3100,
                   kw=dict(window=2048))
# Qwen3-30B-A3B's decode: G = 8 at hd 128 over a 4,096-slot cache with no
# window, its last 995 slots still empty
DECODE_QWEN = dict(B=4, Hq=32, Kv=4, S=4096, hd=128, cur=3100, kw=dict())
RGLRU_FULL = dict(B=4, L=3072, W=4096)
# the attention shapes of phases C and D at B = 4: Seamless-M4T-large-v2
# (16 heads of 64, no GQA) at its encoder (1,024 audio frames,
# bidirectional), its decoder's prefill (3,072 tokens, causal) and its
# cross-attention (3,072 queries over the 1,024-frame memory);
# LLaVA-NeXT-34B's prefill (1,024 patches + 3,072 tokens, causal, 56 q / 8
# kv heads of 128)
FLASH_NEW = {
    "seamless_enc": dict(B=4, Hq=16, Hkv=16, L=1024, S=1024, hd=64,
                         causal=False),
    "seamless_dec": dict(B=4, Hq=16, Hkv=16, L=3072, S=3072, hd=64,
                         causal=True),
    "seamless_cross": dict(B=4, Hq=16, Hkv=16, L=3072, S=1024, hd=64,
                           causal=False),
    "llava": dict(B=4, Hq=56, Hkv=8, L=4096, S=4096, hd=128, causal=True),
}
# a query index at or past every position: the cross-attention's decode
# sees every slot of the memory (repro_torch.models.layers.ALL_POSITIONS)
ALL_POSITIONS = 2 ** 31 - 1
# their decode: Seamless's self-attention over a 4,096-slot cache at
# position 3,100 and its cross-attention over the 1,024-frame memory (slot
# j at position j, every slot visible); LLaVA's over phase D's 4,224-slot
# cache at 4,120 (past the prefix and the prompt)
DECODE_NEW = {
    "seamless_dec": dict(B=4, Hq=16, Kv=16, S=4096, hd=64, cur=3100,
                         index=3100),
    "seamless_cross": dict(B=4, Hq=16, Kv=16, S=1024, hd=64, cur=1023,
                           index=ALL_POSITIONS),
    "llava": dict(B=4, Hq=56, Kv=8, S=4224, hd=128, cur=4120, index=4120),
}
# bf16 tolerance of tests/test_kernels.py, held per row (row_relerr)
FLASH_TOL = DECODE_TOL = 2e-2
RGLRU_TOL = 1e-4                # f32 scan tolerance of tests/test_kernels.py


def flash_plain_by_batch(q, k, v, B, **kw):
    """The plain version, one batch row at a time (the whole score matrix
    of LLaVA's prefill at B = 4 would take 15 GB in float32)."""
    from repro_torch.kernels import flash_attention as fa
    return torch.cat([fa.flash_attention_plain(*(x.chunk(B)[b] for x in
                                                 (q, k, v)), **kw)
                      for b in range(B)])


def check_flash(dev):
    """Kernel vs plain version at the prefill's full width and at edge
    shapes (skipped key tiles, ragged tails, q_offset); returns the largest
    per-row relative error and the largest absolute error."""
    from repro_torch.kernels import flash_attention as fa
    F = FLASH_FULL
    cases = [("full B=4 L=S=3072 Hq16 Hkv1 hd256 w2048", F["B"], F["Hq"],
              F["Hkv"], F["L"], F["S"], F["hd"], F["kw"])]
    cases += [
        ("L=S=1", 2, 16, 1, 1, 1, 256, dict(causal=True, window=2048)),
        ("ragged L=S=1001", 1, 16, 1, 1001, 1001, 256,
         dict(causal=True, window=300)),
        ("softcap 50", 2, 4, 2, 300, 300, 256,
         dict(causal=True, softcap=50.0)),
        ("Hq=Hkv=4", 2, 4, 4, 200, 200, 256, dict(causal=True, window=64)),
        ("q_offset 190 S=257", 1, 4, 1, 67, 257, 128,
         dict(causal=True, q_offset=190)),
        ("non-causal hd64", 2, 8, 2, 130, 70, 64, dict(causal=False)),
        # Qwen3-30B-A3B's prefill: GQA G = 8 at hd 128, causal, no window
        ("qwen B=4 L=S=3072 Hq32 Hkv4 hd128", 4, 32, 4, 3072, 3072, 128,
         dict(causal=True)),
        # one row past a 128-row query tile and a 64- or 128-key tile
        ("L=S=129 hd256 w2048", 2, 16, 1, 129, 129, 256,
         dict(causal=True, window=2048)),
        ("L=S=2049 hd128 G=4", 1, 8, 2, 2049, 2049, 128, dict(causal=True)),
        ("hd128 window 300 L=S=1000", 2, 8, 2, 1000, 1000, 128,
         dict(causal=True, window=300)),
        ("L=300 S=1000 q_offset 700 hd128 window 500", 2, 8, 1, 300, 1000,
         128, dict(causal=True, window=500, q_offset=700)),
    ]
    # phases C and D's shapes (the hd-64 tiles with one kv head a q head)
    cases += [(f"{tag} B={c['B']} L={c['L']} S={c['S']} Hq{c['Hq']} "
               f"Hkv{c['Hkv']} hd{c['hd']} "
               + ("causal" if c["causal"] else "non-causal"), c["B"], c["Hq"],
               c["Hkv"], c["L"], c["S"], c["hd"], dict(causal=c["causal"]))
              for tag, c in FLASH_NEW.items()]
    worst = worst_abs = 0.0
    for i, (name, B, Hq, Hkv, L, S, hd, kw) in enumerate(cases):
        q, k, v = flash_inputs(dev, B, Hq, Hkv, L, S, hd, seed=10 + i)
        got = fa.flash_attention(q, k, v, n_q_heads=Hq, n_kv_heads=Hkv, **kw)
        want = flash_plain_by_batch(q, k, v, B, n_q_heads=Hq, n_kv_heads=Hkv,
                                    **kw)
        torch.cuda.synchronize()
        e, ea = row_relerr(got, want), abserr(got, want)
        log(f"  flash_attention {name}: row relerr {e:.2e}, max abs err {ea:.2e}")
        worst, worst_abs = max(worst, e), max(worst_abs, ea)
    return worst, worst_abs


def check_decode(dev):
    from repro_torch.kernels import decode_attention as da
    D, Q = DECODE_FULL, DECODE_QWEN
    cases = [("full B=4 S=2048 Hq16 Kv1 hd256 wrapped", D["B"], D["Hq"],
              D["Kv"], D["S"], D["hd"], D["cur"], D["kw"], None)]
    cases += [
        ("all empty but one", 4, 16, 1, 2048, 256, 3100,
         dict(window=2048), 777),
        ("all empty", 2, 16, 1, 300, 256, 900, dict(), -1),
        ("S=1", 2, 16, 1, 1, 256, 0, dict(), None),
        ("ragged S=1001 window 300", 2, 16, 1, 1001, 256, 2500,
         dict(window=300), None),
        ("softcap 50, not yet wrapped", 2, 16, 1, 2048, 256, 999,
         dict(softcap=50.0), None),
        ("Hq=Kv=4", 3, 4, 4, 512, 256, 700, dict(), None),
        ("G=2 hd128", 2, 16, 8, 640, 128, 1000, dict(window=256), None),
        ("qwen B=4 S=4096 Hq32 Kv4 hd128", Q["B"], Q["Hq"], Q["Kv"], Q["S"],
         Q["hd"], Q["cur"], Q["kw"], None),
        # the kernel splits the cache into runs of slots: a merge that drops
        # a split, or skips one it should not, shows here
        ("one valid slot, in the last split", D["B"], D["Hq"], D["Kv"],
         D["S"], D["hd"], D["cur"], D["kw"], D["S"] - 1),
        ("qwen, one valid slot, in the last split", Q["B"], Q["Hq"], Q["Kv"],
         Q["S"], Q["hd"], Q["cur"], Q["kw"], Q["S"] - 1),
        # 64-slot tiles with a ragged last tile and a short last split
        ("ragged S=4000 window 3000 softcap 30, Hq32 Kv4 hd128", 4, 32, 4,
         4000, 128, 5000, dict(window=3000, softcap=30.0), None),
        # hd 512: splits of four 64-slot tiles in a one-tile ring, the
        # deepest ring a block's shared memory holds at that width
        ("hd512, 64-slot tiles, one-tile ring", 16, 8, 8, 768, 512, 900,
         dict(), None),
    ]
    cases = [c + (c[6],) for c in cases]      # the query at the last write
    # phases C and D's shapes; the cross-attention's query index past
    # every position
    cases += [(f"{tag} B={c['B']} S={c['S']} Hq{c['Hq']} Kv{c['Kv']} "
               f"hd{c['hd']} index {c['index']}", c["B"], c["Hq"], c["Kv"],
               c["S"], c["hd"], c["cur"], dict(), None, c["index"])
              for tag, c in DECODE_NEW.items()]
    worst = worst_abs = 0.0
    for i, (name, B, Hq, Kv, S, hd, cur, kw, one, index) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(30 + i)
        q = torch.randn(B, Hq, hd, generator=g, device=dev).to(torch.bfloat16)
        kc, vc, pos = ring_cache(dev, B, S, Kv, hd, cur, 40 + i, one)
        got = da.decode_attention(q, kc, vc, pos, index, n_q_heads=Hq,
                                  n_kv_heads=Kv, **kw)
        want = da.decode_attention_plain(q, kc, vc, pos, index, n_q_heads=Hq,
                                         n_kv_heads=Kv, **kw)
        torch.cuda.synchronize()
        e, ea = row_relerr(got, want), abserr(got, want)
        log(f"  decode_attention {name}: row relerr {e:.2e}, max abs err {ea:.2e}")
        worst, worst_abs = max(worst, e), max(worst_abs, ea)
    return worst, worst_abs


def rglru_inputs(dev, B, L, W, seed, slow=False):
    """a in [0.2, 0.999), b standard normal. ``slow``: a in [0.999, 1) on
    the odd channels, where a carry outlives dozens of the kernel's time
    tiles (as RG-LRU's slowest channels do), so that a carry the look-back
    drops or folds wrongly shows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand(B, L, W, generator=g, device=dev) * 0.799 + 0.2
    b = torch.randn(B, L, W, generator=g, device=dev)
    if slow:
        a[..., 1::2] = 1 - torch.rand(B, L, W // 2, generator=g,
                                      device=dev) * 1e-3
    return a, b


def chan_relerr(a, b) -> float:
    """The largest over channels (b, w) of max_t |a - b| / max_t |b|: the
    scan's per-channel error. A whole-tensor max |b| would hide a dropped
    carry in a quiet channel."""
    a, b = a.float(), b.float()
    return finite_or_inf(float(((a - b).abs().amax(1)
                                / (b.abs().amax(1) + 1e-6)).max()))


RGLRU_GRAPH = "graph replay"


def check_rg_lru(dev):
    """Kernel vs plain version, whole tensor and per channel: at the full
    width, at the edges of the kernel's time tiles and channel stripes, and
    for one call captured in a CUDA graph and replayed on new inputs.
    Returns the largest of both errors and the largest absolute error."""
    from repro_torch.kernels import rg_lru as rl
    R, T = RGLRU_FULL, rl.TILE_T
    cases = [("full B=4 L=3072 W=4096", R["B"], R["L"], R["W"], False),
             ("L=1", 2, 1, 4096, False),
             ("ragged L=1001 W=100", 3, 1001, 100, False),
             ("B=1 L=9 W=1", 1, 9, 1, False)]
    # slow channels: a tile's carry reaches far past its successor
    cases += [("full B=4 L=3072 W=4096 slow", R["B"], R["L"], R["W"], True)]
    cases += [(f"L={L} (T={T}) W=4096 slow", 2, L, 4096, True)
              for L in (T - 1, T, T + 1, 3 * T - 1)]
    cases += [(f"L=3072 W={W} slow", 2, 3072, W, True) for W in (100, 4097)]
    # W % 4 == 0 but the bases 4 bytes off 16-byte alignment: the kernel's
    # 4-byte loads and stores
    cases += [("L=200 W=256 slow, unaligned bases", 2, 200, 256, True)]
    worst = worst_abs = 0.0
    for i, (name, B, L, W, slow) in enumerate(cases):
        a, b = rglru_inputs(dev, B, L, W, 50 + i, slow)
        if "unaligned" in name:
            a, b = (torch.empty(x.numel() + 1, device=dev)[1:].view_as(x)
                    .copy_(x) for x in (a, b))
        got, want = rl.rg_lru(a, b), rl.rg_lru_plain(a, b)
        torch.cuda.synchronize()
        e, ec, ea = relerr(got, want), chan_relerr(got, want), abserr(got, want)
        log(f"  rg_lru {name}: relerr {e:.2e}, per channel {ec:.2e}, "
            f"max abs err {ea:.2e}")
        worst, worst_abs = max(worst, e, ec), max(worst_abs, ea)
    # one call captured on fixed buffers after an eager call of the same
    # shape; each replay must start from zeroed flags and ticket
    a, b = rglru_inputs(dev, R["B"], R["L"], R["W"], 70, True)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        rl.rg_lru(a, b)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = rl.rg_lru(a, b)
    for r in range(2):
        a_r, b_r = rglru_inputs(dev, R["B"], R["L"], R["W"], 71 + r, True)
        a.copy_(a_r)
        b.copy_(b_r)
        g.replay()
        torch.cuda.synchronize()
        want = rl.rg_lru_plain(a_r, b_r)
        e, ec, ea = relerr(out, want), chan_relerr(out, want), abserr(out, want)
        log(f"  rg_lru {RGLRU_GRAPH} {r + 1}: relerr {e:.2e}, per channel "
            f"{ec:.2e}, max abs err {ea:.2e}")
        worst, worst_abs = max(worst, e, ec), max(worst_abs, ea)
    del g, out, a, b, a_r, b_r, want
    return worst, worst_abs


def time_lm_kernels(dev):
    """Graph-timed ms per call of each LM kernel, its plain version, SDPA
    where it computes the same function, and the launch floor (the same
    call on the smallest input); plus each kernel's bound."""
    import torch.nn.functional as Fn
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rg_lru as rl
    t = {}
    F = FLASH_FULL
    B, Hq, Hkv, L, S, hd = (F[x] for x in ("B", "Hq", "Hkv", "L", "S", "hd"))
    q, k, v = flash_inputs(dev, B, Hq, Hkv, L, S, hd, seed=60)
    fkw = dict(n_q_heads=Hq, n_kv_heads=Hkv, **F["kw"])
    mask = fa.attention_mask(L, S, device=dev, **F["kw"])
    t["flash_ms"] = graph_ms(lambda: fa.flash_attention(q, k, v, **fkw))
    t["flash_plain_ms"] = graph_ms(
        lambda: fa.flash_attention_plain(q, k, v, **fkw), calls=2, repeats=3)
    q4, k4, v4 = (x.view(B, -1, x.shape[1], hd) for x in (q, k, v))
    t["flash_sdpa_ms"] = graph_ms(lambda: Fn.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, enable_gqa=True), calls=3, repeats=5)
    q1, k1, v1 = flash_inputs(dev, 1, 1, 1, 1, 1, hd, seed=61)
    t["flash_floor_ms"] = graph_ms(lambda: fa.flash_attention(
        q1, k1, v1, n_q_heads=1, n_kv_heads=1))
    pairs = int(mask.sum())
    flash_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    flash_flops = 4 * hd * pairs * B * Hq

    decode_bounds = {}
    for tag, D in (("decode", DECODE_FULL), ("decode_qwen", DECODE_QWEN)):
        B, Hq, Kv, S, hd, cur = (D[x] for x in ("B", "Hq", "Kv", "S", "hd",
                                                 "cur"))
        g = torch.Generator(device=dev).manual_seed(62)
        qd = torch.randn(B, Hq, hd, generator=g, device=dev).to(torch.bfloat16)
        kc, vc, pos = ring_cache(dev, B, S, Kv, hd, cur, 63)
        dkw = dict(n_q_heads=Hq, n_kv_heads=Kv, **D["kw"])
        t[f"{tag}_ms"] = graph_ms(
            lambda: da.decode_attention(qd, kc, vc, pos, cur, **dkw))
        t[f"{tag}_plain_ms"] = graph_ms(
            lambda: da.decode_attention_plain(qd, kc, vc, pos, cur, **dkw))
        valid = da.valid_slots(pos, cur, D["kw"].get("window", 0))
        qd4 = qd[:, :, None, :]
        kd4, vd4 = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
        t[f"{tag}_sdpa_ms"] = graph_ms(
            lambda: Fn.scaled_dot_product_attention(
                qd4, kd4, vd4, attn_mask=valid[:, None, None, :],
                enable_gqa=True))
        # the bytes the function needs: q and out, pos, and K and V of the
        # visible slots only
        n_valid = int(valid.sum())
        dbytes = 2 * 2 * qd.numel() + 4 * pos.numel() + 2 * 2 * n_valid * Kv * hd
        decode_bounds[tag] = bound(dbytes, 4 * hd * n_valid * Hq,
                                   TC_BF16_FLOPS_PER_S)
        decode_bounds[tag]["valid_slots"] = n_valid
        if tag == "decode":   # the launch floor: one head, one slot
            q1 = qd[:1, :1].contiguous()
            k1, v1 = kc[:1, :1].contiguous(), vc[:1, :1].contiguous()
            p1 = pos[:1, :1].contiguous()
            t["decode_floor_ms"] = graph_ms(lambda: da.decode_attention(
                q1, k1, v1, p1, cur, n_q_heads=1, n_kv_heads=1))

    R = RGLRU_FULL
    a, b = rglru_inputs(dev, R["B"], R["L"], R["W"], 64)
    t["rg_lru_ms"] = graph_ms(lambda: rl.rg_lru(a, b))
    t["rg_lru_plain_ms"] = graph_ms(lambda: rl.rg_lru_plain(a, b), calls=2,
                                    repeats=3)
    a1, b1 = a[:1, :1, :1].contiguous(), b[:1, :1, :1].contiguous()
    t["rg_lru_floor_ms"] = graph_ms(lambda: rl.rg_lru(a1, b1))
    # the scan's bytes (a and b read, one output written) through one
    # elementwise PyTorch kernel: what streaming them takes on this card.
    # Another function, so not the scan's library call
    t["rg_lru_same_bytes_ms"] = graph_ms(lambda: torch.add(a, b))
    rg_bytes, rg_ops = 12 * a.numel(), 2 * a.numel()
    # Qwen3-30B-A3B's prefill shape, beside SDPA's own causal mask (its
    # flash backend, no mask tensor)
    B, Hq, Hkv, L, S, hd = 4, 32, 4, 3072, 3072, 128
    q, k, v = flash_inputs(dev, B, Hq, Hkv, L, S, hd, seed=65)
    qkw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=True)
    t["flash_qwen_ms"] = graph_ms(lambda: fa.flash_attention(q, k, v, **qkw))
    t["flash_qwen_plain_ms"] = graph_ms(
        lambda: fa.flash_attention_plain(q, k, v, **qkw), calls=2, repeats=3)
    q4, k4, v4 = (x.view(B, -1, x.shape[1], hd) for x in (q, k, v))
    t["flash_qwen_sdpa_ms"] = graph_ms(lambda: Fn.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True))
    qwen_pairs = L * (L + 1) // 2
    qwen_bound = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                       4 * hd * qwen_pairs * B * Hq, TC_BF16_FLOPS_PER_S)
    del q, k, v, q4, k4, v4
    new_bounds = {}
    # phases C and D's shapes beside SDPA (its own causal mask, none for
    # the bidirectional ones)
    for tag, c in FLASH_NEW.items():
        B, Hq, Hkv, L, S, hd = (c[x] for x in ("B", "Hq", "Hkv", "L", "S",
                                               "hd"))
        q, k, v = flash_inputs(dev, B, Hq, Hkv, L, S, hd, seed=66)
        fkw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=c["causal"])
        t[f"flash_{tag}_ms"] = graph_ms(lambda: fa.flash_attention(q, k, v,
                                                                   **fkw))
        t[f"flash_{tag}_plain_ms"] = graph_ms(
            lambda: flash_plain_by_batch(q, k, v, B, **fkw), calls=1,
            repeats=3)
        q4, k4, v4 = (x.view(B, -1, x.shape[1], hd) for x in (q, k, v))
        t[f"flash_{tag}_sdpa_ms"] = graph_ms(
            lambda: Fn.scaled_dot_product_attention(
                q4, k4, v4, is_causal=c["causal"], enable_gqa=True))
        pairs_new = L * (L + 1) // 2 if c["causal"] else L * S
        new_bounds[f"flash_{tag}"] = bound(
            2 * (2 * q.numel() + k.numel() + v.numel()),
            4 * hd * pairs_new * B * Hq, TC_BF16_FLOPS_PER_S)
        del q, k, v, q4, k4, v4
    for tag, c in DECODE_NEW.items():
        B, Hq, Kv, S, hd, cur, idx = (c[x] for x in ("B", "Hq", "Kv", "S",
                                                      "hd", "cur", "index"))
        g = torch.Generator(device=dev).manual_seed(67)
        qd = torch.randn(B, Hq, hd, generator=g, device=dev).to(torch.bfloat16)
        kc, vc, pos = ring_cache(dev, B, S, Kv, hd, cur, 68)
        dkw = dict(n_q_heads=Hq, n_kv_heads=Kv)
        t[f"decode_{tag}_ms"] = graph_ms(
            lambda: da.decode_attention(qd, kc, vc, pos, idx, **dkw))
        t[f"decode_{tag}_plain_ms"] = graph_ms(
            lambda: da.decode_attention_plain(qd, kc, vc, pos, idx, **dkw))
        valid = da.valid_slots(pos, idx, 0)
        kd4, vd4 = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
        t[f"decode_{tag}_sdpa_ms"] = graph_ms(
            lambda: Fn.scaled_dot_product_attention(
                qd[:, :, None, :], kd4, vd4,
                attn_mask=valid[:, None, None, :], enable_gqa=True))
        n_valid = int(valid.sum())
        new_bounds[f"decode_{tag}"] = bound(
            2 * 2 * qd.numel() + 4 * pos.numel() + 2 * 2 * n_valid * Kv * hd,
            4 * hd * n_valid * Hq, TC_BF16_FLOPS_PER_S)
        new_bounds[f"decode_{tag}"]["valid_slots"] = n_valid
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 8 LM kernel timing (ms per call, median): "
        + " ".join(f"{k}={v:.5f}" for k, v in t.items()))
    bounds = dict(
        flash=bound(flash_bytes, flash_flops, TC_BF16_FLOPS_PER_S),
        flash_qwen=qwen_bound,
        rg_lru=bound(rg_bytes, rg_ops, CORE_OPS_PER_S), **decode_bounds,
        **new_bounds)
    log(f"  bounds: {json.dumps(bounds)} (flash pairs {pairs})")
    return t, bounds


# the grouped matmul's shapes on Qwen3-30B-A3B's MoE path: G = 128 experts;
# M = 4 rows x capacity 240 at prefill (B = 4, L = 3,072), capacity 1 at
# decode; gate/up products d 2,048 -> ff 768, the down product ff -> d
GMM_PATH = [("prefill_up", 128, 960, 2048, 768),
            ("prefill_down", 128, 960, 768, 2048),
            ("decode_up", 128, 1, 2048, 768),
            ("decode_down", 128, 1, 768, 2048)]
GMM_TOL = 2e-2                  # bf16 tolerance, held per output row
# experts with a token at a decode step: at most batch 4 x top-8 of 128
GMM_ACTIVE = 32


def gmm_inputs(dev, G, M, K, N, seed):
    """x ~ N(0, 1), w ~ N(0, 1/K) in bf16, so outputs are ~N(0, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(G, M, K, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(G, K, N, generator=g, device=dev) * K ** -0.5)
    return x, w.to(torch.bfloat16)


def sparse_gmm_inputs(dev, G, M, K, N, seed, active=GMM_ACTIVE):
    """The decode's dispatch buffer: ``active`` random groups hold rows, the
    rest are exactly zero, as the MoE dispatch leaves the experts that
    received no token. Four of the active groups are zero in their first
    K/2 columns, so a zero test has to read all of x[g]. Returns (x, w,
    bool mask of the zero groups)."""
    x, w = gmm_inputs(dev, G, M, K, N, seed)
    g = torch.Generator().manual_seed(seed)
    keep = torch.randperm(G, generator=g)[:active]
    zero = torch.ones(G, dtype=torch.bool)
    zero[keep] = False
    x[zero.to(dev)] = 0
    x[keep[:4].to(dev), :, :K // 2] = 0
    return x, w, zero.to(dev)


def check_gmm(dev):
    """Kernel vs plain version per output row at the path's shapes and at
    edge shapes of each of the kernel's three routes; returns the largest
    per-row relative error and the largest absolute error. Groups whose x
    is all zero must come out exactly zero."""
    from repro_torch.kernels import grouped_matmul as gm
    cases = [(f"path {n} G={G} M={M} K={K} N={N}", G, M, K, N, None)
             for n, G, M, K, N in GMM_PATH]
    cases += [(f"path {n} G={G} M={M} K={K} N={N}, {GMM_ACTIVE} groups with "
               "a row", G, M, K, N, "sparse")
              for n, G, M, K, N in GMM_PATH if M == 1]
    cases += [
        ("G=1 M=1", 1, 1, 2048, 768, None),
        ("ragged, TMA: M=100 K=200 N=136", 5, 100, 200, 136, None),
        ("TMA, M=16 past the streaming route's x: K=2048 N=256", 3, 16, 2048,
         256, None),
        ("streaming: M=16 K=1024 N=136", 3, 16, 1024, 136, None),
        ("streaming: M=3 K=200 N=72", 5, 3, 200, 72, "sparse"),
        ("ragged, element loads: M=33 K=100 N=70", 3, 33, 100, 70, None),
        ("element loads: M=65 K=8 N=129", 2, 65, 8, 129, None),
        ("N=1 K=37", 1, 64, 37, 1, None),
        ("all-zero group 2 of 4", 4, 70, 256, 192, 2),
    ]
    worst = worst_abs = 0.0
    for i, (name, G, M, K, N, zero) in enumerate(cases):
        if zero == "sparse":
            x, w, zero = sparse_gmm_inputs(dev, G, M, K, N, seed=80 + i,
                                           active=min(GMM_ACTIVE, G - 2))
        else:
            x, w = gmm_inputs(dev, G, M, K, N, seed=80 + i)
            if zero is not None:
                x[zero] = 0
        got, want = gm.grouped_matmul(x, w), gm.grouped_matmul_plain(x, w)
        torch.cuda.synchronize()
        if zero is not None and bool(got[zero].any()):
            raise SystemExit(f"grouped_matmul {name}: an all-zero group gave "
                             "non-zeros")
        e, ea = row_relerr(got, want), abserr(got, want)
        log(f"  grouped_matmul {name}: row relerr {e:.2e}, max abs err {ea:.2e}")
        worst, worst_abs = max(worst, e), max(worst_abs, ea)
    return worst, worst_abs


GMM_F32_TOL = 1e-5              # float32 route, per output row


def check_gmm_f32(dev):
    """The float32 route against the plain version (a float32 ``torch``
    product, TF32 off) per output row, at the path's shapes and a ragged
    one; returns the largest per-row relative and absolute errors."""
    from repro_torch.kernels import grouped_matmul as gm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [(f"path {n} G={G} M={M} K={K} N={N}", G, M, K, N)
             for n, G, M, K, N in GMM_PATH]
    cases += [("ragged M=33 K=100 N=70", 3, 33, 100, 70),
              ("M=1 K=37 N=1", 2, 1, 37, 1)]
    worst = worst_abs = 0.0
    for i, (name, G, M, K, N) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(120 + i)
        x = torch.randn(G, M, K, generator=g, device=dev)
        w = torch.randn(G, K, N, generator=g, device=dev) * K ** -0.5
        got, want = gm.grouped_matmul(x, w), gm.grouped_matmul_plain(x, w)
        torch.cuda.synchronize()
        if got.dtype != torch.float32:
            raise SystemExit(f"grouped_matmul f32 {name}: got {got.dtype}")
        e, ea = row_relerr(got, want), abserr(got, want)
        log(f"  grouped_matmul f32 {name}: row relerr {e:.2e}, max abs err "
            f"{ea:.2e}")
        worst, worst_abs = max(worst, e), max(worst_abs, ea)
    return worst, worst_abs


def time_gmm_f32(dev) -> dict:
    """The float32 route at the prefill's gate/up shape, graph-timed beside
    its plain version and ``torch.bmm`` in float32 (TF32 off), with its
    bound at the card's float32 rate outside the tensor cores."""
    from repro_torch.kernels import grouped_matmul as gm
    _, G, M, K, N = GMM_PATH[0]
    g = torch.Generator(device=dev).manual_seed(130)
    x = torch.randn(G, M, K, generator=g, device=dev)
    w = torch.randn(G, K, N, generator=g, device=dev) * K ** -0.5
    t = dict(ms=graph_ms(lambda: gm.grouped_matmul(x, w), calls=3, repeats=5),
             plain_ms=graph_ms(lambda: gm.grouped_matmul_plain(x, w),
                               calls=3, repeats=5),
             library_ms=graph_ms(lambda: torch.bmm(x, w), calls=3, repeats=5))
    t.update(bound(4 * (G * M * K + G * K * N + G * M * N),
                   2 * G * M * K * N, CORE_OPS_PER_S))
    log(f"phase 13 grouped matmul f32 [{G}, {M}, {K}] x [{G}, {K}, {N}] "
        f"(ms per call, median): {json.dumps(t)}")
    return t


def time_gmm(dev):
    """Graph-timed ms per call of the kernel, its plain version and
    ``torch.bmm`` at each of the path's shapes, the launch floor (one
    8 x 8 product), and each shape's bound."""
    from repro_torch.kernels import grouped_matmul as gm
    t, bounds = {}, {}
    for key, G, M, K, N in GMM_PATH:
        x, w = gmm_inputs(dev, G, M, K, N, seed=90)
        t[f"{key}_ms"] = graph_ms(lambda: gm.grouped_matmul(x, w))
        t[f"{key}_plain_ms"] = graph_ms(lambda: gm.grouped_matmul_plain(x, w),
                                        calls=2, repeats=3)
        t[f"{key}_bmm_ms"] = graph_ms(lambda: torch.bmm(x, w))
        bounds[key] = bound(2 * (G * M * K + G * K * N + G * M * N),
                            2 * G * M * K * N, TC_BF16_FLOPS_PER_S)
        if M != 1:
            continue
        x, w, zero = sparse_gmm_inputs(dev, G, M, K, N, seed=92)
        dense, key = bounds[key], f"{key}_sparse"
        t[f"{key}_ms"] = graph_ms(lambda: gm.grouped_matmul(x, w))
        t[f"{key}_plain_ms"] = graph_ms(lambda: gm.grouped_matmul_plain(x, w),
                                        calls=2, repeats=3)
        t[f"{key}_bmm_ms"] = graph_ms(lambda: torch.bmm(x, w))
        # the dense bound reads every group's w; the sparse one only the
        # groups that have a row (x and out are read and written whole)
        act = G - int(zero.sum())
        bounds[key] = bound(2 * (G * M * K + act * K * N + G * M * N),
                            2 * act * M * K * N, TC_BF16_FLOPS_PER_S)
        bounds[key].update(dense_bound_ms=dense["bound_ms"],
                           groups_with_a_row=act)
    x1, w1 = gmm_inputs(dev, 1, 1, 8, 8, seed=91)
    t["floor_ms"] = graph_ms(lambda: gm.grouped_matmul(x1, w1))
    log("phase 13 grouped matmul timing (ms per call, median): "
        + " ".join(f"{k}={v:.5f}" for k, v in t.items()))
    step = lambda up, down: 48 * (2 * up + down)     # 48 layers x 3 products
    log(f"  bounds: {json.dumps(bounds)}; per decode step: kernel "
        f"{step(t['decode_up_sparse_ms'], t['decode_down_sparse_ms']):.2f} ms "
        f"at {GMM_ACTIVE} groups with a row, bound "
        f"{step(bounds['decode_up_sparse']['bound_ms'], bounds['decode_down_sparse']['bound_ms']):.2f} ms "
        f"(dense inputs: kernel "
        f"{step(t['decode_up_ms'], t['decode_down_ms']):.2f} ms, bound "
        f"{step(bounds['decode_up']['bound_ms'], bounds['decode_down']['bound_ms']):.2f} ms)")
    return t, bounds


def bound(nbytes, ops, ops_per_s=CORE_OPS_PER_S):
    """The least time of a call: the larger of its bytes over the memory
    rate and its operations over the peak rate for their type."""
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = ops / ops_per_s * 1e3
    return dict(bound_ms=max(b, o), bound_by="bytes" if b >= o else "operations")


def lm_kernel_modules():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import rg_lru as rl
    return fa, da, rl, gm


def run_serve(dev, arch, n_layers=None, **over):
    """Serve ``arch`` at full width (and depth, unless ``n_layers`` cuts
    it) on the card with ``SERVE_ARGS`` (``over`` replaces some); the
    kernel counts are zeroed just before and read just after. Returns
    (serve result, launch counts, prefills, decode steps, peak GiB, wall s,
    the decode steps' indices)."""
    from repro_torch.kernels import admission as adm
    from repro_torch.kernels import time_flow_lookup as tfl
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import Model
    fa, da, rl, gm = lm_kernel_modules()
    calls = dict(prefill=0, decode=0, indices=[])
    orig = Model.prefill, Model.decode_step, serve_mod.get_config

    def prefill(self, *a):
        calls["prefill"] += 1
        return orig[0](self, *a)

    def decode_step(self, *a):
        calls["decode"] += 1
        calls["indices"].append(int(a[3]))
        return orig[1](self, *a)

    Model.prefill, Model.decode_step = prefill, decode_step
    if n_layers is not None:
        serve_mod.get_config = lambda name: dataclasses.replace(
            orig[2](name), n_layers=n_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tfl.launches = adm.launches = 0
    fa.launches = da.launches = rl.launches = gm.launches = 0
    t0 = time.perf_counter()
    try:
        res = serve_mod.serve(arch=arch, preset="full",
                              **dict(SERVE_ARGS, **over), device="cuda")
    finally:
        Model.prefill, Model.decode_step, serve_mod.get_config = orig
    wall = time.perf_counter() - t0
    counts = dict(flash=fa.launches, decode=da.launches, rg_lru=rl.launches,
                  gmm=gm.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return (res, counts, calls["prefill"], calls["decode"], peak, wall,
            calls["indices"])


SERVE_ARGS = dict(requests=8, batch=4, prompt_len=3072, max_new=32,
                  cache_len=4096, seed=0)
# phase 10 limits, kernels vs plain versions on the bf16 model. MODEL_TOL:
# the largest logit error over the largest |logit| of a step, 2.2x the
# largest sound reading (4.50e-3, one logit's rounding flip); it guards
# against gross faults only. MODEL_RMS_TOL: the RMS of the logit error over
# the RMS of the logits. Sound runs read 3.5e-3 to 5.29e-3 per step; a flash
# kernel that skips the lower-edge key tile of the window reads 6.97e-3 at
# the prefill step, a decode kernel that skips its last 64-slot tile
# 8.26e-3 to 9.07e-3 at every decode step (PERF.md, fault probe 2)
MODEL_TOL = 1e-2
MODEL_RMS_TOL = 6.5e-3
# phase 15 limits, the same metrics on the 4-layer Qwen3-30B-A3B with the
# plain run held to the kernel run's experts. Sound runs read 1.41e-2 to
# 2.46e-2 (RMS) and 1.48e-2 to 2.80e-2 (max) per step; a grouped matmul that
# skips its last K step reads 0.53 to 0.69 (RMS) and 0.53 to 0.76 (max) at
# every step (PERF.md, PR 13)
QWEN_TOL = 4e-2
QWEN_RMS_TOL = 3.5e-2


class plain_versions:
    """Within the block the model layers call the kernels' plain versions
    (the wrappers' module attributes are swapped and restored), so one set
    of CUDA weights runs both ways."""

    def __enter__(self):
        fa, da, rl, gm = lm_kernel_modules()
        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (fa, "flash_attention"), (da, "decode_attention"), (rl, "rg_lru"),
            (gm, "grouped_matmul"))]
        for m, n, _ in self.saved:
            setattr(m, n, getattr(m, n + "_plain"))

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def model_vs_plain(dev, cfg, B, L, *, init_seed, prompt_seed, steps=8,
                   cache_len=4096, frontend_embeds=None):
    """Prefill of a B x L prompt + ``steps`` greedy decode steps through
    the kernels, then the same tokens through the plain versions, on one set
    of weights (with ``frontend_embeds`` for a model with a frontend; a
    vision prefix moves the decode steps past it).

    MoE layers: the plain run takes the experts the kernel run's router
    picked (with gates from its own logits at those experts), so both runs
    dispatch the same tokens to the same experts and differ only by
    rounding. A token's experts are a discrete choice, and bf16 rounding
    can flip a near-tie of the router; the flips are counted instead (the
    tokens whose own top-k set in the plain run differs from the kernel
    run's). Returns (logits per step through the kernels, through the plain
    versions [steps + 1, B, V], flips per step summed over the MoE
    layers)."""
    from repro_torch.models import build_model
    from repro_torch.models import layers as ly
    from repro_torch.models.stacks import prefix_len
    model = build_model(cfg)
    params = model.init(init_seed, dev)
    rng = np.random.default_rng(prompt_seed)
    prompt = torch.tensor(rng.integers(2, cfg.vocab, (B, L)), device=dev)
    route = ly.moe_route
    start = prefix_len(cfg) + L

    def run(tokens=None, forced=None):
        picks, marks, flips = [], [], []

        def recorded(p, x, c):
            gates, idx = route(p, x, c)
            if forced is not None:
                own = idx.sort(-1).values
                idx = forced[len(picks)]
                flips.append(int((own != idx.sort(-1).values).any(-1).sum()))
                gates = torch.softmax((x.float() @ p.router).gather(-1, idx),
                                      dim=-1)
            picks.append(idx)
            return gates, idx

        ly.moe_route = recorded
        try:
            logits, cache = model.prefill(
                params, prompt, model.init_cache(
                    B, cache_len, dev, enc_len=cfg.frontend_tokens or None),
                frontend_embeds)
            marks.append(len(picks))
            out, toks = [logits[:, -1]], []
            for i in range(steps):
                tok = (logits[:, -1].argmax(-1) if tokens is None
                       else tokens[i])[:, None]
                toks.append(tok[:, 0])
                logits, cache = model.decode_step(params, tok, cache,
                                                  start + i)
                marks.append(len(picks))
                out.append(logits[:, -1])
        finally:
            ly.moe_route = route
        per_step = [sum(flips[lo:hi]) for lo, hi in zip([0] + marks, marks)]
        return torch.stack(out), toks, picks, per_step

    got, toks, picks, _ = run()
    with plain_versions():
        want, _, _, flips = run(toks, forced=picks)
    torch.cuda.synchronize()
    return got, want, flips


def hold_model(tag, got, want, flips, max_tol, rms_tol):
    """Log each step's logit errors and fail when a limit is passed."""
    errs = [relerr(g, w) for g, w in zip(got, want)]
    rms = [float((g - w).float().square().mean().sqrt()
                 / w.float().square().mean().sqrt()) for g, w in zip(got, want)]
    top2 = want.topk(2, -1).values
    margin = (top2[..., 0] - top2[..., 1]) > max_tol * want.abs().amax(-1)
    agree = (got.argmax(-1) == want.argmax(-1)) | ~margin
    finite = bool(torch.isfinite(got).all())
    log(f"{tag}: logits relerr per step "
        + " ".join(f"{e:.2e}" for e in errs)
        + "; RMS relerr per step " + " ".join(f"{e:.2e}" for e in rms)
        + f"; tokens whose own expert set differs per step {flips}"
        + f"; greedy tokens agree where the top-2 margin exceeds the "
        f"tolerance: {bool(agree.all())} ({int(margin.sum())}/{margin.numel()} "
        f"such); finite {finite}")
    if max(errs) > max_tol or max(rms) > rms_tol or not agree.all() or \
            not finite:
        raise SystemExit(f"{tag}: kernels and plain versions disagree")
    return dict(relerr=errs, rms_relerr=rms, flips=flips)


def check_model_vs_plain(dev):
    """RecurrentGemma-9B at full width, one group plus the tail (5 layers:
    rec rec attn rec rec): prefill of a 2,600-token prompt (past the 2,048
    window, so the ring cache is rolled) + 8 greedy decode steps through
    the kernels, then the same tokens through the plain versions."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=5)
    B, L = 2, 2600
    got, want, flips = model_vs_plain(dev, cfg, B, L, init_seed=1,
                                      prompt_seed=5)
    return hold_model(f"phase 10 model vs plain (5 layers, d 4096, B={B}, "
                      f"L={L}, 8 decode steps)", got, want, flips, MODEL_TOL,
                      MODEL_RMS_TOL)


def check_qwen_vs_plain(dev):
    """Qwen3-30B-A3B at full width, 4 layers: prefill at the serve path's
    B = 4, L = 3,072 (expert capacity 240, so M = 960) + 8 greedy decode
    steps (capacity 1) through the kernels, then through the plain
    versions."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), n_layers=4)
    B, L = SERVE_ARGS["batch"], SERVE_ARGS["prompt_len"]
    got, want, flips = model_vs_plain(dev, cfg, B, L, init_seed=1,
                                      prompt_seed=7)
    return hold_model(f"phase 15 qwen3-moe-30b-a3b vs plain (4 layers, d "
                      f"2048, B={B}, L={L}, 8 decode steps)", got, want, flips,
                      QWEN_TOL, QWEN_RMS_TOL)


def kernel_group(name: str) -> str:
    """The layer a device kernel belongs to, by its name."""
    low = name.lower()
    for key, group in (("flash_kernel", "flash_attention"),
                       ("decode_kernel", "decode_attention"),
                       ("rg_lru_kernel", "rg_lru"),
                       ("gmm_kernel", "grouped_matmul")):
        if key in low:
            return group
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "gemv")):
        return "matmul"
    if any(k in low for k in ("sort", "topk", "index", "scatter", "gather")):
        return "indexing, sorts, top-k (MoE dispatch, embedding)"
    return "other (elementwise, norms, copies, reductions)"


def profile_serve(dev, arch, phase):
    """Where the serve path's time goes at full width and depth: one
    prefill (B = 4, L = 3,072) and 8 decode steps (at positions 3,072 on),
    each timed once on the host clock without the profiler and once under
    it for device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    model = build_model(get_config(arch))
    params = model.init(0, dev)
    B, L, steps = SERVE_ARGS["batch"], SERVE_ARGS["prompt_len"], 8
    prompt = torch.tensor(np.random.default_rng(6).integers(2, model.cfg.vocab,
                                                            (B, L)),
                          device=dev)
    state = {}

    def prefill():
        state["logits"], state["cache"] = model.prefill(
            params, prompt, model.init_cache(B, SERVE_ARGS["cache_len"], dev))

    def decode(start):
        for i in range(steps):
            tok = state["logits"][:, -1].argmax(-1)[:, None]
            state["logits"], state["cache"] = model.decode_step(
                params, tok, state["cache"], start + i)

    def timed(fn, *a, prof=None):
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        fn(*a)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if prof is not None:
            prof.stop()
        return wall

    prefill()                                       # warm
    out = {}
    for name, fn, a1, a2, per in (("prefill", prefill, (), (), 1),
                                  ("decode", decode, (L,), (L + steps,), steps)):
        bare = timed(fn, *a1)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        wall = timed(fn, *a2, prof=prof)
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and self_device_ms(e) > 0]
        tot = sum(self_device_ms(e) for e in ev)
        groups = {}
        for e in ev:
            g = kernel_group(e.key)
            groups[g] = groups.get(g, 0.0) + self_device_ms(e)
        log(f"phase {phase} profile serve {arch} {name} "
            f"(per {'step' if per > 1 else 'call'}): "
            f"device {tot / per:.3f} ms, wall {bare / per:.3f} ms without the "
            f"profiler, {wall / per:.3f} ms under it; device idle share "
            f"{1 - tot / bare:.3f} (profiled device time over the unprofiled "
            f"wall)")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            log(f"  {ms / per:9.3f} ms {ms / tot:6.1%}  {g}")
        ev.sort(key=lambda e: -self_device_ms(e))
        for e in ev[:8]:
            log(f"    {self_device_ms(e) / per:9.3f} ms {self_device_ms(e) / tot:6.1%} "
                f"x{e.count // per:<4d} {e.key[:90]}")
        out[name] = dict(device_ms=tot / per, wall_ms=bare / per,
                         idle=1 - tot / bare, groups={g: ms / per for g, ms in
                                                      groups.items()})
    return out


def device_breakdown(fn, calls: int = 20) -> dict:
    """Device microseconds per ``fn()`` call of each kernel it launches,
    from the profiler over ``calls`` calls (after three unprofiled ones)."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and self_device_ms(e) > 0:
            m = re.search(r"(\w+)\(", e.key)
            name = m.group(1) if m else e.key[:40]
            out[name] = out.get(name, 0.0) + self_device_ms(e) * 1e3 / calls
    return out


def window_wall_ms(step, j, num_flows, prof=None) -> float:
    """Wall ms of the fabric's slices 24-39 (16 steady-state slices, while
    hosts still inject), after slices 0-23 set the state up."""
    from repro_torch.core.fabric import _init_state
    state = _init_state(j, num_flows)
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


def profile_window(step, j, num_flows):
    """Slices 24-39 once without the profiler and once under it: (wall ms
    without, wall ms profiled, the device events by time, their device ms,
    kernels launched per slice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    bare_ms = window_wall_ms(step, j, num_flows)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    wall_ms = window_wall_ms(step, j, num_flows, prof)
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and self_device_ms(e) > 0]
    ev.sort(key=lambda e: -self_device_ms(e))
    tot = sum(self_device_ms(e) for e in ev)
    kernels_per_slice = sum(e.count for e in ev if not e.key.startswith(
        ("Memcpy", "Memset"))) / 16
    return bare_ms, wall_ms, ev, tot, kernels_per_slice


def main_workload():
    """Phase 4's workload: RPC at load 0.4 over 108 ToRs, 2^17 packets."""
    from repro_torch.core import synthesize
    wl = synthesize("rpc", N_TORS, 64, slice_bytes=75_000, load=0.4,
                    max_packets=1 << 17, seed=0)
    if wl.num_packets != P_MAIN:
        raise SystemExit(f"workload has {wl.num_packets} packets, not {P_MAIN}")
    return wl


def faulty_net(sched, device="cuda", telemetry=None):
    """The 108-ToR net of phase 4 (default fabric, ``vlb`` with 4 paths)
    with phase 17's faults injected through the user API: a ToR outage
    healed at slice 120, a dead link, a degraded link and a stuck port; a
    ToR one slice behind, one a slice ahead, one whose residual skew
    passes the 200 ns guard band, and one that drifts. ``telemetry``: the
    net's counter config (read by its clocked service only)."""
    from repro_torch.core import OpenOpticsNet, vlb
    cfg = dict(node="rack", node_num=N_TORS, uplink=1, slice_us=SLICE_US)
    if telemetry is not None:
        cfg["telemetry"] = telemetry
    net = OpenOpticsNet(cfg, device=device)
    assert net.deploy_topo(sched)
    net.deploy_routing(vlb(sched, kpaths=4), LOOKUP="hop", MULTIPATH="packet")
    slice_ns = SLICE_US * 1000.0
    net.inject_failure("tor", node=17, t_start=20, t_end=120)
    net.inject_failure("link", node=3, dst=4)
    net.inject_failure("degrade", node=40, dst=41, scale=0.37, t_start=10)
    net.inject_failure("port", node=60, uplink=0, t_start=40, t_end=180)
    net.inject_control("skew", node=7, skew_ns=-slice_ns)
    net.inject_control("skew", node=8, skew_ns=slice_ns, t_start=30)
    net.inject_control("skew", node=90, skew_ns=slice_ns + 700.0, t_start=5,
                       t_end=150)
    net.inject_control("drift", node=100, drift_ns=85.0)
    return net


def check_masked_path(dev, profile: bool = True) -> dict:
    """Phase 17: the 108-ToR main path with failure masks, control masks
    and telemetry counters, through ``OpenOpticsNet.run`` and ``simulate``
    on the card; its deferred-bytes counter against the packet state of
    every slice; and its first 48 slices against the CPU's plain versions,
    every ``SimResult`` and telemetry field. Raises ``SystemExit`` on a
    mismatch; returns the run's numbers."""
    from repro_torch.core import (FabricConfig, FabricTables, TelemetryConfig,
                                  compile_control, compile_masks, round_robin,
                                  simulate)
    from repro_torch.core.fabric import (_add_masks, _device_arrays,
                                         _init_state, _make_step)
    from repro_torch.kernels import admission as adm
    from repro_torch.kernels import time_flow_lookup as tfl
    sched = round_robin(N_TORS, 1)
    wl = main_workload()
    net = faulty_net(sched)
    cfg = net.fabric_cfg
    slice_ns = SLICE_US * 1000.0

    def masks(n):
        return (compile_masks(net.failure_trace, sched, n),
                compile_control(net.control_trace, n, N_TORS,
                                slice_ns=slice_ns))
    fail, ctrl = masks(SLICES)
    if not (fail.link_cap < 1).any() or not ctrl.skew_miss.any() or \
            not (ctrl.phase_off < 0).any() or not (ctrl.phase_off > 0).any():
        raise SystemExit("phase 17: the masks do not hold every fault")
    # 1. the user API, the launch counters zeroed just before and read after
    faulty_net(sched).run(wl, 2)            # warm, on a net of its own
    torch.cuda.synchronize()
    tfl.launches = adm.launches = 0
    t0 = time.perf_counter()
    res = net.run(wl, SLICES)               # ends in a copy to the host
    wall = time.perf_counter() - t0
    launches = dict(tfl=tfl.launches, adm=adm.launches)
    want = dict(tfl=SLICES * (1 + cfg.hops_per_slice),
                adm=SLICES * cfg.hops_per_slice)
    if launches != want:
        raise SystemExit(f"phase 17: launches {launches} (want {want})")
    # 2. the same run with telemetry, through simulate
    tables = FabricTables.build(sched, net.routing)
    fail.on_device(dev)
    tres = simulate(tables, wl, cfg, SLICES, failures=fail, control=ctrl,
                    telemetry=TelemetryConfig(), device="cuda")
    tele = tres.telemetry
    bad = sim_diff(res, dataclasses.replace(tres, telemetry=None))
    if bad is not None:
        raise SystemExit(f"phase 17: run and simulate differ in {bad}")
    if not np.array_equal(tele.delivered_bytes.sum(1), res.delivered_bytes) \
            or (tele.util_used > tele.util_cap).any() \
            or (tele.queue_hwm < res.buf_bytes).any():
        raise SystemExit("phase 17: telemetry counters inconsistent")
    done = res.t_deliver >= 0
    if done.mean() < 0.5:
        raise SystemExit(f"phase 17: only {done.mean():.3f} delivered")
    # 3. deferred bytes, slice by slice: with congestion detection every
    # packet deferred in slice t (a full queue at enqueue, or a missed
    # slice) ends it re-looking-up, on a switch, departing at t + 1
    j = _device_arrays(tables, wl, dev)
    _add_masks(j, fail, ctrl, SLICES)
    step = _make_step(j, cfg, True, TelemetryConfig())
    state = _init_state(j, wl.num_flows)
    wrong = torch.zeros((), dtype=torch.int64, device=dev)
    rows = []
    for t in range(SLICES):
        rows.append(step(state, t)["tele_deferred"])
        held = state["relook"] & (state["loc"] >= 0) & (state["dep"] == t + 1)
        want_row = torch.zeros_like(rows[-1]).index_add_(
            0, state["loc"].clamp(0, N_TORS - 1),
            torch.where(held, j["size"], 0))
        wrong += (rows[-1] != want_row).sum()
    if int(wrong) or not np.array_equal(torch.stack(rows).cpu().numpy(),
                                        tele.deferred_bytes):
        raise SystemExit(f"phase 17: deferred bytes differ from the packet "
                         f"state in {int(wrong)} (slice, switch) cells")
    out = dict(
        wall_s=wall, slices_per_s=SLICES / wall,
        delivered=float(done.mean()), dropped=int(res.dropped[-1]),
        slice_miss=int(res.slice_miss.sum()),
        deferred_bytes=int(tele.deferred_bytes.sum()),
        dead_link_slices=int((fail.link_cap <= 0).sum()),
        skew_miss_cells=int(ctrl.skew_miss.sum()), launches=launches)
    # 4. where the device time goes, slices 24-39 with all three inputs
    if profile:
        bare_ms, wall_ms, ev, tot, kps = profile_window(step, j, wl.num_flows)
        out.update(device_ms_per_slice=tot / 16,
                   kernels_per_slice=kps, wall_ms_per_slice=bare_ms / 16,
                   profiled_wall_ms_per_slice=wall_ms / 16,
                   idle_share=1 - tot / wall_ms)
        for e in ev[:10]:
            log(f"  {self_device_ms(e) / 16:8.4f} ms/slice "
                f"{self_device_ms(e) / tot:6.1%} x{e.count // 16:<4d}/slice "
                f"{e.key[:100]}")
    # 5. the first 48 slices on the card and on the CPU
    t0 = time.perf_counter()
    f48, c48 = masks(CPU_SLICES)
    runs = [simulate(tables, wl, cfg, CPU_SLICES, failures=f48, control=c48,
                     telemetry=TelemetryConfig(), device=d)
            for d in ("cuda", "cpu")]
    bad = sim_diff(*runs)
    if bad is not None:
        raise SystemExit(f"phase 17: CUDA and CPU differ in {bad}")
    out["cpu_check_s"] = time.perf_counter() - t0
    return out


# phase 18's windows: unequal, some of one slice, some crossing a fault's
# start or heal (20, 30, 40, 120, 150, 180); the demand batches join at 72
# and 96 (the main workload injects up to slice 110)
SERVICE_CUTS = (0, 1, 10, 11, 25, 45, 72, 73, 96, 121, 144, 145, 151, 179,
                181, SLICES)
BATCH_STARTS = (72, 96)
NET_WINDOW = 16
NET_BATCH_CLOCKS = (0, 64, 96)      # the net ingests each batch then
EXTRA_WINDOWS = 10


def demand_batches(wl):
    """Phase 18's three batches of the main workload, by inject slice:
    before 72, [72, 96) and from 96; and their union, the batches one
    after the other."""
    from repro_torch.core import Workload
    edges = (0,) + BATCH_STARTS + (1 << 30,)
    picks = [np.flatnonzero((wl.t_inject >= a) & (wl.t_inject < b))
             for a, b in zip(edges, edges[1:])]
    sub = lambda idx: Workload(**{f.name: getattr(wl, f.name)[idx]
                                  for f in dataclasses.fields(Workload)})
    return [sub(i) for i in picks], sub(np.concatenate(picks))


def counters_summed(tele) -> dict:
    """A ``SimResult``'s telemetry as the service's snapshot sums it."""
    return dict(
        injected_bytes=tele.injected_bytes.sum(0),
        delivered_bytes=tele.delivered_bytes.sum(0),
        deferred_bytes=tele.deferred_bytes.sum(0),
        dropped_bytes=tele.dropped_bytes.sum(0),
        queue_hwm=tele.queue_hwm.max(0), util_used=tele.util_used.sum(0),
        util_cap=tele.util_cap.sum(0), lat_hist=tele.lat_hist.sum(0))


def check_frame(frame, res, tag):
    """The snapshot's packet and byte groups sum to its totals, and its
    counters are the ``service_result``'s telemetry summed."""
    for unit in ("packets", "bytes"):
        g = frame[unit]
        if g["total"] != g["pending"] + g["in_flight"] + g["delivered"] + \
                g["dropped"]:
            raise SystemExit(f"phase 18 {tag}: {unit} groups {g} do not "
                             "sum to the total")
    if frame["packets"]["total"] != res.t_deliver.shape[0]:
        raise SystemExit(f"phase 18 {tag}: snapshot and result disagree on "
                         "the packet count")
    for k, v in counters_summed(res.telemetry).items():
        if not np.array_equal(frame["counters"][k], v):
            raise SystemExit(f"phase 18 {tag}: snapshot counter {k} is not "
                             "the result's summed")


def run_service(net, batches, upto, on_window=None):
    """Drive ``net``'s clocked service from its clock to ``upto`` in
    windows of 16 slices, ingesting each demand batch at its clock (its
    inject slices made relative to the clock); ``on_window(net)`` after
    each advance. Returns the wall seconds spent in ``advance``."""
    wall = 0.0
    while net._clock < upto:
        if net._clock in NET_BATCH_CLOCKS:
            wl = batches[NET_BATCH_CLOCKS.index(net._clock)]
            net.ingest(dataclasses.replace(
                wl, t_inject=wl.t_inject - np.int32(net._clock)))
        n = min(NET_WINDOW, upto - net._clock)
        t0 = time.perf_counter()
        net.advance(n)                  # ends in a copy to the host
        wall += time.perf_counter() - t0
        if on_window is not None:
            on_window(net)
    return wall


def check_service(dev, masked) -> dict:
    """Phase 18: the clocked service at the main path's size. The fabric's
    incremental API in unequal windows with three demand batches against
    the one-shot run of their union; ``OpenOpticsNet``'s service in
    windows of 16, its frames against its results, its first 48 slices
    against the CPU's; ten more windows of fresh demand for the peak
    memory; the set-up a window costs. Raises ``SystemExit`` on a
    mismatch; returns the numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import (FabricTables, TelemetryConfig,
                                  compile_control, compile_masks, finalize,
                                  ingest, init_state, round_robin, simulate,
                                  step_slices, synthesize)
    from repro_torch.core.fabric import (_add_masks, _build_caps,
                                         _make_step, _mask_window,
                                         stack_tables)
    from repro_torch.kernels import admission as adm
    from repro_torch.kernels import time_flow_lookup as tfl
    sched = round_robin(N_TORS, 1)
    wl = main_workload()
    batches, union = demand_batches(wl)
    tele = TelemetryConfig()
    ref_net = faulty_net(sched)
    cfg = ref_net.fabric_cfg
    tables = FabricTables.build(sched, ref_net.routing)
    fail = compile_masks(ref_net.failure_trace, sched, SLICES)
    ctrl = compile_control(ref_net.control_trace, SLICES, N_TORS,
                           slice_ns=SLICE_US * 1000.0)
    want = dict(tfl=SLICES * (1 + cfg.hops_per_slice),
                adm=SLICES * cfg.hops_per_slice)
    out = dict(windows=[b - a for a, b in zip(SERVICE_CUTS,
                                               SERVICE_CUTS[1:])],
               batches=[b.num_packets for b in batches])
    if not all(out["batches"]):
        raise SystemExit(f"phase 18: an empty demand batch {out['batches']}")

    # 1. the fabric's incremental API, the counts zeroed just before and
    # read just after; the one-shot run of the union on the card
    torch.cuda.synchronize()
    tfl.launches = adm.launches = 0
    t0 = time.perf_counter()
    fs = init_state(tables, batches[0], cfg, tele, device="cuda")
    for a, b in zip(SERVICE_CUTS, SERVICE_CUTS[1:]):
        if a in BATCH_STARTS:
            ingest(fs, batches[1 + BATCH_STARTS.index(a)])
        step_slices(fs, b - a, *_mask_window(fail, ctrl, a, b))
    windowed = finalize(fs)
    out["fabric_windows_wall_s"] = time.perf_counter() - t0
    launches = dict(tfl=tfl.launches, adm=adm.launches)
    if launches != want:
        raise SystemExit(f"phase 18: windowed launches {launches} (want "
                         f"{want})")
    one = simulate(tables, union, cfg, SLICES, failures=fail, control=ctrl,
                   telemetry=tele, device="cuda")
    bad = sim_diff(windowed, one)
    if bad is not None:
        raise SystemExit(f"phase 18: windowed and one-shot runs differ in "
                         f"{bad}")
    out["fabric_launches"] = launches
    out["delivered"] = float((one.t_deliver >= 0).mean())

    # 2. the net's service in windows of 16: frames against results, one
    # window profiled, the counts zeroed just before and read just after
    net = faulty_net(sched, telemetry={})
    at48 = {}
    prof_window = (32, 48)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_window(n):
        if n._clock == prof_window[1]:
            prof.stop()
        res = n.service_result()
        check_frame(n.snapshot(), res, f"clock {n._clock}")
        if n._clock == CPU_SLICES:
            at48["res"] = res
        if n._clock == prof_window[0]:
            torch.cuda.synchronize()
            prof.start()
    torch.cuda.synchronize()
    tfl.launches = adm.launches = 0
    wall = run_service(net, batches, SLICES, on_window)
    launches = dict(tfl=tfl.launches, adm=adm.launches)
    if launches != want:
        raise SystemExit(f"phase 18: service launches {launches} (want "
                         f"{want})")
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and self_device_ms(e) > 0]
    nsl = prof_window[1] - prof_window[0]
    out.update(
        service_launches=launches,
        advance_wall_ms_per_slice=wall * 1e3 / SLICES,
        run_wall_ms_per_slice=masked["wall_s"] * 1e3 / SLICES,
        service_kernels_per_slice=sum(e.count for e in ev if not e.key
                                      .startswith(("Memcpy", "Memset")))
        / nsl,
        service_device_ms_per_slice=sum(self_device_ms(e) for e in ev) / nsl,
        service_delivered=float((net.service_result().t_deliver >= 0)
                                .mean()))

    # 3. the set-up a window pays: the packed table, the capacities of
    # the window's masks, the whole step (which builds both)
    fs = net._service
    jw = dict(fs.j)
    _add_masks(jw, *net._window_masks(NET_WINDOW), NET_WINDOW)
    jw["mask_t0"] = fs.clock

    def setup_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    out["setup_ms"] = dict(
        packed_table=setup_ms(lambda: stack_tables(
            jw["inj_next"], jw["inj_dep"], jw["tf_next"], jw["tf_dep"])),
        caps=setup_ms(lambda: _build_caps(jw["conn"], cfg, N_TORS,
                                          jw["link_cap"], jw["node_ok"],
                                          fs.clock)),
        step=setup_ms(lambda: _make_step(jw, cfg, True, tele)))

    # 4. the first 48 slices of the service on the CPU
    t0 = time.perf_counter()
    cpu_net = faulty_net(sched, device="cpu", telemetry={})
    run_service(cpu_net, batches, CPU_SLICES)
    bad = sim_diff(at48["res"], cpu_net.service_result())
    if bad is not None:
        raise SystemExit(f"phase 18: service on CUDA and CPU differ in {bad}")
    out["cpu_check_s"] = time.perf_counter() - t0

    # 5. ten more windows of fresh demand: the peak device memory of each
    NKEY = N_TORS * (N_TORS + 1)
    peaks, packets = [], []
    t0 = time.perf_counter()
    for i in range(EXTRA_WINDOWS):
        net.ingest(synthesize("rpc", N_TORS, 64, slice_bytes=75_000,
                              load=0.4, max_packets=1 << 14, seed=100 + i))
        torch.cuda.reset_peak_memory_stats()
        net.advance(SLICES)
        peaks.append(torch.cuda.max_memory_allocated())
        packets.append(net._service.num_packets)
    out["extra_windows_wall_s"] = time.perf_counter() - t0
    res = net.service_result()
    check_frame(net.snapshot(), res, f"clock {net._clock}")
    out.update(
        peak_mib_first=peaks[0] / 2 ** 20, peak_mib_last=peaks[-1] / 2 ** 20,
        packets_first=packets[0], packets_last=packets[-1],
        clock_last=net._clock,
        window_caps_mib=SLICES * NKEY * 4 / 2 ** 20,
        whole_run_caps_mib=net._clock * NKEY * 4 / 2 ** 20)
    return out


def check_phased(dev) -> dict:
    """Phase 19: phased table swaps at the main path's size. ``vlb`` with
    4 paths under phase 17's failure trace: the deployed tables up to the
    ToR outage, a fast reroute with destination-aware backups at its
    failed links, a repair over the links still failed after the heal.
    Raises ``SystemExit`` on a mismatch; returns the numbers."""
    from repro_torch.core import (FabricTables, backup_tables,
                                  backup_tables_dp, compile_masks,
                                  fast_reroute, repair, round_robin,
                                  simulate, simulate_phased, toolkit)
    from repro_torch.kernels import admission as adm
    from repro_torch.kernels import time_flow_lookup as tfl
    sched = round_robin(N_TORS, 1)
    wl = main_workload()
    net = faulty_net(sched)
    cfg, routing = net.fabric_cfg, net.routing
    out_t, heal_t = 20, 120             # ToR 17's outage
    fail = compile_masks(net.failure_trace, sched, SLICES)
    f_out, f_heal = fail.failed_links(out_t), fail.failed_links(heal_t)

    host = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        host[name] = time.perf_counter() - t0
        return r
    timed("backup_tables_s", lambda: backup_tables(sched))
    bk = timed("backup_tables_dp_s", lambda: backup_tables_dp(sched))
    patched = timed("fast_reroute_s",
                    lambda: fast_reroute(routing, sched, f_out, backups=bk))
    repaired = timed("repair_s",
                     lambda: repair(sched, "vlb", f_heal, kpaths=4))
    for tag, r, f in (("patched", patched, f_out),
                      ("repaired", repaired, f_heal)):
        bad = toolkit.check_tables(sched, r, link_fail=f, check_walks=False)
        if bad:
            raise SystemExit(f"phase 19: {tag} tables fail check_tables: "
                             f"{bad[:3]}")
    phases = [(routing, out_t), (patched, heal_t - out_t),
              (repaired, SLICES - heal_t)]

    # 1. one phase equals the one-shot run (the oblivious run: the
    # deployed tables throughout)
    tables = FabricTables.build(sched, routing)
    obl = simulate(tables, wl, cfg, SLICES, failures=fail, device="cuda")
    one = simulate_phased(sched, [(routing, SLICES)], wl, cfg,
                          failures=fail, device="cuda")
    bad = sim_diff(obl, one)
    if bad is not None:
        raise SystemExit(f"phase 19: one phase and simulate differ in {bad}")
    # 2. three phases, the counts zeroed just before and read just after
    torch.cuda.synchronize()
    tfl.launches = adm.launches = 0
    t0 = time.perf_counter()
    res = simulate_phased(sched, phases, wl, cfg, failures=fail,
                          device="cuda")
    wall = time.perf_counter() - t0
    launches = dict(tfl=tfl.launches, adm=adm.launches)
    want = dict(tfl=SLICES * (1 + cfg.hops_per_slice),
                adm=SLICES * cfg.hops_per_slice)
    if launches != want:
        raise SystemExit(f"phase 19: launches {launches} (want {want})")
    if np.array_equal(res.t_deliver, obl.t_deliver):
        raise SystemExit("phase 19: the swapped tables changed no delivery")
    # 3. the first 48 slices of the three phases on the card and the CPU
    t0 = time.perf_counter()
    f48 = compile_masks(net.failure_trace, sched, CPU_SLICES)
    p48 = [(routing, out_t), (patched, CPU_SLICES - out_t)]
    runs = [simulate_phased(sched, p48, wl, cfg, failures=f48, device=d)
            for d in ("cuda", "cpu")]
    bad = sim_diff(*runs)
    if bad is not None:
        raise SystemExit(f"phase 19: CUDA and CPU differ in {bad}")
    cpu_s = time.perf_counter() - t0
    offered = float(wl.size.astype(np.int64).sum())
    share = {}
    for tag, r in (("oblivious", obl), ("phased", res)):
        d = r.delivered_bytes.astype(np.int64)
        share[tag] = [float(d[a:b].sum()) / offered for a, b in
                      ((0, out_t), (out_t, heal_t), (heal_t, SLICES))]
        share[tag + "_total"] = float((r.t_deliver >= 0).mean())
    return dict(host_s=host, launches=launches, wall_s=wall,
                failed_links=dict(outage=int(f_out.sum()),
                                  after_heal=int(f_heal.sum())),
                share_delivered=share, cpu_check_s=cpu_s)


# phase 20: the traffic-aware reconfigure loop at the main path's width
RECONF_E, RECONF_EPOCHS = 16, 12
RECONF_SLICES = RECONF_E * RECONF_EPOCHS       # 192
RECONF_CPU_EPOCHS = 3                          # 48 slices again on the CPU
RECONF_PROFILED_EPOCH = 5


def reconf_net(sched):
    """Phase 17's net (its faults and its four skewed ToRs) with
    table-install faults injected too: every install message lost with
    probability 0.1, ToR 33's delayed 3 slices over 64-127, and the
    controller stalled over slices 100-103."""
    net = faulty_net(sched)
    net.inject_control("install_loss", loss=0.1, t_start=0)
    net.inject_control("install_delay", node=33, delay=3, t_start=64,
                       t_end=128)
    net.inject_control("stall", t_start=100, t_end=104)
    return net


def as_sim(res):
    """The ``SimResult`` fields of a ``ReconfigResult``."""
    from repro_torch.core import SimResult
    return SimResult(**{f.name: getattr(res, f.name)
                        for f in dataclasses.fields(SimResult)})


def reconfig_diff(a, b):
    """The first field in which two ``ReconfigResult``s differ (value,
    shape or dtype), telemetry included; None when they are equal."""
    bad = sim_diff(as_sim(a), as_sim(b))
    if bad is not None:
        return bad
    for name in ("hot_src", "hot_dst", "demand_total", "epoch_conn",
                 "failed_links", "install_ver", "install_lat",
                 "install_retries", "degraded"):
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y):
            return name
    return None


class EpochClock:
    """Host clocks around the loop's recompiles and windows, each
    synchronised with the card, and the profiler around one epoch's
    window: patched into the modules the loop calls them through, for one
    run."""

    def __init__(self, profile_epoch=None):
        self.compile_s, self.window_s = [], []
        self.profile_epoch = profile_epoch
        self.prof = None
        self.prof_s = 0.0            # the profiler's own start and stop

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core import fabric as fabric_mod, routing_jnp
        self._mods = (routing_jnp, fabric_mod)
        self._real = (routing_jnp.compile_tables, fabric_mod.step_slices)
        real_compile, real_window = self._real

        def compile_tables(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_compile(*a, **k)
            torch.cuda.synchronize()
            self.compile_s.append(time.perf_counter() - t0)
            return out

        def step_slices(*a, **k):
            prof = None
            if len(self.window_s) == self.profile_epoch:
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if prof is not None:
                prof.start()
            t1 = time.perf_counter()
            out = real_window(*a, **k)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            self.window_s.append(t2 - t1)
            if prof is not None:
                prof.stop()
                self.prof = prof
                self.prof_s += time.perf_counter() - t2 + t1 - t0
            return out
        routing_jnp.compile_tables = compile_tables
        fabric_mod.step_slices = step_slices
        return self

    def __exit__(self, *exc):
        self._mods[0].compile_tables, self._mods[1].step_slices = self._real


def replay_versions(sched, wl, cfg, rcfg, ctrl, res, dev):
    """Phase 20(b)'s independent check of the versioned installs: each
    epoch's recorded schedule compiled by the host ``hoho``; each ToR's old
    tables taken whole from the version it last installed (the boot tables
    for -1); the install decisions from the host's ``install_schedule``
    and the degrade rule; the epoch run through ``step_slices`` with those
    versions. Returns the replayed ``SimResult`` and the first per-epoch
    field (``install_ver``, ``install_lat``, ``install_retries``,
    ``degraded``) that differs from ``res``, or None."""
    from repro_torch.core import (FabricTables, Schedule, direct, finalize,
                                  hoho, init_state, install_schedule,
                                  step_slices)
    from repro_torch.core.fabric import _mask_window, _table_arrays
    NEVER = 1 << 30
    E, N = rcfg.epoch_slices, N_TORS
    U = sched.conn.shape[2]
    conn0 = (np.concatenate([sched.conn, np.full((rcfg.k_hot, N, U), -1,
                                                 np.int32)])
             if rcfg.scheduler == "hot_slices"
             else np.full((1, N, U), -1, np.int32))     # edmonds
    fields = ("tf_next", "tf_dep", "inj_next", "inj_dep")
    host = lambda r: [getattr(r, f) for f in fields]
    r0 = hoho(Schedule(conn0))
    per_ver = {-1: host(r0)}
    sr = direct(Schedule(conn0))
    safe = [np.concatenate([a, np.full(a.shape[:-1] + (b.shape[-1] -
                                                       a.shape[-1],), fill,
                                       np.int32)], -1)
            for a, b, fill in zip(host(sr), per_ver[-1], (-1, 0, -1, 0))]
    fs = init_state(FabricTables.build(Schedule(conn0), r0), wl, cfg,
                    device=dev)
    ver = np.full(N, -1, np.int64)
    bad = None
    for e in range(rcfg.num_epochs):
        t0 = e * E
        sched_e = Schedule(res.epoch_conn[e])
        r_e = hoho(sched_e)
        per_ver[e] = host(r_e)
        # each ToR's current tables: whole, from its last installed version
        old = [np.stack([per_ver[int(ver[n])][i][:, n] for n in range(N)],
                        axis=1) for i in range(4)]
        if rcfg.install == "2pc":
            info = install_schedule(ctrl, t0, retries=rcfg.install_retries,
                                    backoff=rcfg.install_backoff,
                                    timeout=rcfg.install_timeout)
            switch = np.full(N, info["act"] if info["success"] else NEVER)
            lat, ret = info["latency"], info["retries_used"]
            success = info["success"]
        else:
            info = install_schedule(ctrl, t0, backoff=rcfg.install_backoff)
            switch, ret = info["arr"], 0
            success = info["act"] < NEVER
            lat = info["act"] - t0 if success else -1
        tis = t0 + np.arange(E)
        vsel = (tis[:, None] >= switch[None, :]).astype(np.int32)
        degraded = False
        if rcfg.degrade:
            t_degr = t0 if ctrl.skew_miss[t0:t0 + E].any() else NEVER
            if not success:
                t_degr = min(t_degr, t0 + rcfg.install_timeout)
            vsel = np.where(tis[:, None] >= t_degr, 2, vsel).astype(np.int32)
            degraded = t_degr < NEVER
        vers = [old, per_ver[e]] + ([safe] if rcfg.degrade else [])
        versions = {f + "_v": torch.tensor(np.stack([v[i] for v in vers]),
                                           device=dev)
                    for i, f in enumerate(fields)}
        versions["vsel"] = torch.tensor(vsel, device=dev)
        fs.j.update(_table_arrays(FabricTables.build(sched_e, r_e), dev))
        _, cw = _mask_window(None, ctrl, t0, t0 + E)
        step_slices(fs, E, control=cw, versions=versions)
        ver = np.where(switch <= t0 + E - 1, e, ver)
        for name, got, want in (("install_ver", ver, res.install_ver[e]),
                                ("install_lat", lat, res.install_lat[e]),
                                ("install_retries", ret,
                                 res.install_retries[e]),
                                ("degraded", degraded, res.degraded[e])):
            if bad is None and not np.array_equal(got, want):
                bad = f"{name} of epoch {e}"
    return finalize(fs), bad


def check_reconfigure(dev, profile: bool = True) -> dict:
    """Phase 20: the reconfigure loop at the main path's width, 12 epochs
    of 16 slices. (a) ``k_hot=0`` with ``vlb`` equals ``simulate``; (b)
    ``hot_slices`` with ``hoho`` under phase 17's control trace with
    install faults, by hotswap and by 2PC with degrade: mixed versions
    and degraded epochs counted, each run against the host replay of its
    versions, and its first 3 epochs against the CPU's; (c) ``edmonds``
    and ``bvn`` with ``heal`` under phase 17's failure masks, each against
    the host replay of its recorded schedules. Raises ``SystemExit`` on a
    mismatch; returns the numbers."""
    from repro_torch.core import (FabricTables, ReconfigConfig, Schedule,
                                  compile_control, compile_masks, finalize,
                                  hoho, init_state, reconfigure, round_robin,
                                  simulate, step_slices, vlb)
    from repro_torch.core.fabric import _mask_window, _table_arrays
    from repro_torch.kernels import admission as adm
    from repro_torch.kernels import time_flow_lookup as tfl
    sched = round_robin(N_TORS, 1)
    wl = main_workload()
    net = reconf_net(sched)
    cfg = net.fabric_cfg
    slice_ns = SLICE_US * 1000.0
    fail = compile_masks(net.failure_trace, sched, RECONF_SLICES)
    ctrl = compile_control(net.control_trace, RECONF_SLICES, N_TORS,
                           slice_ns=slice_ns)
    fail.on_device(dev)
    E = RECONF_E
    base = dict(epoch_slices=E, num_epochs=RECONF_EPOCHS)
    want_l = dict(tfl=RECONF_SLICES * (1 + cfg.hops_per_slice),
                  adm=RECONF_SLICES * cfg.hops_per_slice)
    out = {}

    def run(tag, rcfg, **kw):
        torch.cuda.synchronize()
        tfl.launches = adm.launches = 0
        t0 = time.perf_counter()
        res = reconfigure(sched, wl, cfg, rcfg, device="cuda", **kw)
        wall = time.perf_counter() - t0
        launches = dict(tfl=tfl.launches, adm=adm.launches)
        if launches != want_l:
            raise SystemExit(f"phase 20 {tag}: launches {launches} (want "
                             f"{want_l})")
        done = res.t_deliver >= 0
        out[tag] = dict(wall_s=wall, slices_per_s=RECONF_SLICES / wall,
                        delivered=float(done.mean()), launches=launches)
        return res

    # (a) k_hot = 0: the recompile loop alone, equal to simulate
    rc_a = ReconfigConfig(**base, scheme="vlb", k_hot=0, kpaths=4)
    res_a = run("a_vlb_k0", rc_a)
    sim_a = simulate(FabricTables.build(sched, vlb(sched, kpaths=4)), wl,
                     cfg, RECONF_SLICES, device="cuda")
    bad = sim_diff(sim_a, as_sim(res_a))
    if bad is not None:
        raise SystemExit(f"phase 20(a): reconfigure and simulate differ in "
                         f"{bad}")

    # (b) versioned installs under the control trace; a hotswap run of
    # edmonds too, whose matchings change from epoch to epoch, so that a
    # stale ToR's old tables differ from its peers' in most entries
    for tag, kw in (("b_hotswap", dict(install="hotswap")),
                    ("b_2pc_degrade", dict(install="2pc", degrade=True)),
                    ("b_hotswap_edmonds", dict(install="hotswap",
                                               scheduler="edmonds"))):
        rcfg = ReconfigConfig(**base, scheme="hoho", k_hot=4, **kw)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        res = run(tag, rcfg, control=ctrl)
        peak = torch.cuda.max_memory_allocated()
        out[tag].update(peak_mib=peak / 2 ** 20,
                        loop_peak_mib=(peak - held) / 2 ** 20)
        iv = res.install_ver
        out[tag].update(
            mixed_epochs=int((iv != iv[:, :1]).any(axis=1).sum()),
            degraded_epochs=int(res.degraded.sum()),
            install_lat=res.install_lat.tolist(),
            install_retries=res.install_retries.tolist(),
            stale_tor_epochs=int((iv != np.arange(RECONF_EPOCHS)[:, None])
                                 .sum()))
        if tag.startswith("b_hotswap") and not out[tag]["mixed_epochs"]:
            raise SystemExit("phase 20(b): no hotswap epoch ended with mixed "
                             "versions")
        if tag == "b_2pc_degrade" and not out[tag]["degraded_epochs"]:
            raise SystemExit("phase 20(b): no 2PC epoch degraded")
        t0 = time.perf_counter()
        replay, bad_ep = replay_versions(sched, wl, cfg, rcfg, ctrl, res,
                                         dev)
        bad = bad_ep or sim_diff(replay, as_sim(res))
        if bad is not None:
            raise SystemExit(f"phase 20(b) {tag}: the run and the host replay "
                             f"of its versions differ in {bad}")
        out[tag]["replay_s"] = time.perf_counter() - t0
        # the first 3 epochs on the card and on the CPU, every field
        t0 = time.perf_counter()
        r3 = dataclasses.replace(rcfg, num_epochs=RECONF_CPU_EPOCHS)
        _, c3 = _mask_window(None, ctrl, 0, RECONF_CPU_EPOCHS * E)
        runs3 = [reconfigure(sched, wl, cfg, r3, control=c3, device=d)
                 for d in ("cuda", "cpu")]
        bad = reconfig_diff(*runs3)
        if bad is not None:
            raise SystemExit(f"phase 20(b) {tag}: CUDA and CPU differ in "
                             f"{bad}")
        bad = sim_diff(as_sim(runs3[0]), dataclasses.replace(
            as_sim(runs3[0]), **{k: getattr(res, k)[:E * RECONF_CPU_EPOCHS]
                                 for k in ("delivered_bytes", "dropped",
                                           "buf_bytes", "offl_bytes",
                                           "blocked_inj", "slice_miss")}))
        if bad is not None:
            raise SystemExit(f"phase 20(b) {tag}: the 3-epoch run is not the "
                             f"12-epoch run's start ({bad})")
        out[tag]["cpu_check_s"] = time.perf_counter() - t0

    # where an epoch's time goes: the hotswap run once more, its recompiles
    # and windows on synchronised clocks, one epoch's window profiled
    if profile:
        from torch.autograd import DeviceType
        rcfg = ReconfigConfig(**base, scheme="hoho", k_hot=4)
        with EpochClock(profile_epoch=RECONF_PROFILED_EPOCH) as clk:
            t0 = time.perf_counter()
            reconfigure(sched, wl, cfg, rcfg, control=ctrl, device="cuda")
            wall = time.perf_counter() - t0 - clk.prof_s
        comp = sum(clk.compile_s[-RECONF_EPOCHS:])
        win = sum(clk.window_s)
        ev = [e for e in clk.prof.key_averages()
              if e.device_type == DeviceType.CUDA and self_device_ms(e) > 0]
        dev_ms = sum(self_device_ms(e) for e in ev)
        kernels = sum(e.count for e in ev if not e.key.startswith(
            ("Memcpy", "Memset")))
        tfl_ev = [e for e in ev if "tfl_kernel" in e.key]
        out["epoch"] = dict(
            wall_ms=wall * 1e3 / RECONF_EPOCHS,
            measure_schedule_ms=(wall - comp - win - clk.compile_s[0])
            * 1e3 / RECONF_EPOCHS,
            boot_compile_ms=clk.compile_s[0] * 1e3,
            recompile_ms=comp * 1e3 / RECONF_EPOCHS,
            slices_ms=win * 1e3 / RECONF_EPOCHS,
            profiled_kernels_per_slice=kernels / E,
            profiled_device_ms_per_slice=dev_ms / E,
            lookup_us_per_call=(sum(self_device_ms(e) for e in tfl_ev) * 1e3
                                / max(sum(e.count for e in tfl_ev), 1)))
        for e in sorted(ev, key=lambda e: -self_device_ms(e))[:8]:
            log(f"  {self_device_ms(e) / E:8.4f} ms/slice "
                f"{self_device_ms(e) / dev_ms:6.1%} x{e.count // E:<4d}/slice "
                f"{e.key[:100]}")

    # (c) demand schedulers with heal under the failure masks, against the
    # host replay of their recorded schedules
    for scheduler in ("edmonds", "bvn"):
        tag = f"c_{scheduler}_heal"
        rcfg = ReconfigConfig(**base, scheme="hoho", scheduler=scheduler,
                              heal=True)
        res = run(tag, rcfg, failures=fail)
        if not (res.failed_links > 0).any():
            raise SystemExit(f"phase 20(c) {tag}: no failed link detected")
        t0 = time.perf_counter()
        fs = None
        for e in range(RECONF_EPOCHS):
            sched_e = Schedule(res.epoch_conn[e])
            tables = FabricTables.build(sched_e, hoho(sched_e))
            if fs is None:
                fs = init_state(tables, wl, cfg, device="cuda")
            else:
                fs.j.update(_table_arrays(tables, fs.device))
            fw, _ = _mask_window(fail, None, e * E, (e + 1) * E)
            step_slices(fs, E, failures=fw)
        bad = sim_diff(finalize(fs), as_sim(res))
        if bad is not None:
            raise SystemExit(f"phase 20(c) {tag}: the run and its host replay "
                             f"differ in {bad}")
        out[tag].update(replay_s=time.perf_counter() - t0,
                        failed_links=res.failed_links.tolist(),
                        dark_circuits=int((res.epoch_conn < 0).sum()))
    return out


# -- phase 21: the seven architectures and the scenario sweep -----------------

ARCH_CPU_SLICES = 16            # (b): the first slices held against the CPU
FLEET_SEEDS = 8                 # (c): seeds 0-7 of phase 4's workload
FLEET_TRACES = 4                # (c): failure / control trace seeds 0-3
FLEET_FLOW_SEEDS = 4            # (c): seeds 0-3 of per-flow multipath (wcmp)
FLEET_KERNEL_RATIO = 1.1        # (c): kernels a slice at B = 8 over phase 6's
CPU_WORKERS = 6                 # processes for the CPU runs of (a) and (b)
# digests (sha256 of the int32 bytes, first 16 hex digits) of what the
# reference deploys: at fig8's size each architecture's schedule and its
# four tables; at 108 ToRs the schedules of edmonds, jupiter (4 uplinks, 16
# moves) and bvn (216 peels) on phase 4's traffic matrix
# (tests/test_torch_architectures.py holds them against the reference)
ARCH_DIGESTS = {
    "clos": "b56e66f6ed18806d", "c-through": "42545a262ba80f88",
    "jupiter": "76f5411a3add1e22", "mordia": "988c6dc1fcfb8b83",
    "rotornet": "a9c88be78135128b", "opera": "7d25b3e4ae819034",
    "rotornet-ucmp": "2d47c6c1a811f41b"}
SCHED_DIGESTS_108 = {"edmonds": "e7b904f66fa169df",
                     "jupiter": "8600f728220949f2", "bvn": "7b5829bf974364ea"}


def digest(*arrays) -> str:
    """sha256 of the arrays' int32 bytes, its first 16 hex digits."""
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a, dtype=np.int32).tobytes())
    return h.hexdigest()[:16]


def arch_digest(net) -> str:
    r = net.routing
    return digest(net.schedule.conn, r.tf_next, r.tf_dep, r.inj_next,
                  r.inj_dep)


def arch_module():
    """``examples/architecture_comparison_torch.py``: ``build_arch`` for
    the seven architectures, and fig8's workload."""
    path = str(ROOT / "examples")
    if path not in sys.path:
        sys.path.insert(0, path)
    import architecture_comparison_torch as arch
    return arch


def cpu_arch_run(name: str, n_tors: int, slice_us: float, slices: int, wl,
                 tm):
    """A worker's job: one architecture's run on the CPU's plain versions,
    on one thread."""
    torch.set_num_threads(1)
    net = arch_module().build_arch(name, n_tors, slice_us, tm=tm,
                                   device="cpu")
    return net.run(wl, slices)


def check_architectures(dev) -> dict:
    """Phase 21 (a) and (b): the seven architectures of paper §6 Case I
    through ``build_arch`` of ``examples/architecture_comparison_torch.py``
    on the card. (a) at fig8's size, 8 ToRs and 700 slices: each deployment's
    digest the reference's, each run equal to the CPU's in every field,
    the FCT table. (b) at 108 ToRs (phase 4's workload, 214 slices, 6 us
    slices): the host seconds of the three TA schedulers and their
    schedules' digests, slices/s and the hand-written kernels' launches a
    slice of each run, its first 16 slices equal to the CPU's. The CPU
    runs go to worker processes while the card runs. Raises
    ``SystemExit`` on a mismatch; returns the numbers."""
    import multiprocessing as mp
    from repro_torch.core import bvn, edmonds, jupiter
    from repro_torch.kernels import admission as adm
    from repro_torch.kernels import time_flow_lookup as tfl
    arch = arch_module()
    out = dict(fct={}, arch_108={})
    n8, us8, s8, us108 = arch.N, arch.SLICE_US, arch.SLICES, SLICE_US
    wl8, n_mice = arch.fig8_workload()
    wl108 = main_workload()
    tm8, tm108 = arch.traffic_tm(wl8, n8), arch.traffic_tm(wl108, N_TORS)
    # the TA schedulers at 108 ToRs, timed on the host, against the
    # reference's schedules
    sched_s = {}
    for name, fn in (("edmonds", lambda: edmonds(tm108, slice_us=us108)),
                     ("jupiter", lambda: jupiter(
                         tm108, n_nodes=N_TORS, n_uplinks=4, max_moves=16,
                         slice_us=us108)),
                     ("bvn", lambda: bvn(tm108, max_perms=2 * N_TORS,
                                         slice_us=us108))):
        t0 = time.perf_counter()
        sched = fn()
        sched_s[name] = time.perf_counter() - t0
        if digest(sched.conn) != SCHED_DIGESTS_108[name]:
            raise SystemExit(f"phase 21(b): {name}'s schedule at {N_TORS} "
                             "ToRs is not the reference's")
    out["scheduler_host_s"] = sched_s
    nets8 = {}
    for name in arch.ARCHS:
        nets8[name] = arch.build_arch(name, n8, us8, tm=tm8, device=dev)
        if arch_digest(nets8[name]) != ARCH_DIGESTS[name]:
            raise SystemExit(f"phase 21(a): {name}'s schedule or tables are "
                             "not the reference's")
    ctx = mp.get_context("spawn")
    pool = ctx.Pool(CPU_WORKERS)
    try:
        cpu8 = {n: pool.apply_async(cpu_arch_run, (n, n8, us8, s8, wl8, tm8))
                for n in arch.ARCHS}
        cpu108 = {n: pool.apply_async(cpu_arch_run, (
            n, N_TORS, us108, ARCH_CPU_SLICES, wl108, tm108))
            for n in arch.ARCHS}
        pool.close()
        # (a) on the card while the CPU runs
        log(f"phase 21(a) fig8, {n8} ToRs, {s8} slices, {wl8.num_packets} "
            f"packets: {'architecture':16s} {'mice p50':>9s} "
            f"{'mice p99':>9s} {'eleph p50':>10s}")
        res8 = {}
        for name in arch.ARCHS:
            res8[name] = nets8[name].run(wl8, s8)
            m50, m99, e50 = arch.fct_row(wl8, res8[name].t_deliver, n_mice)
            out["fct"][name] = dict(mice_p50_us=m50, mice_p99_us=m99,
                                    eleph_p50_us=e50)
            log(f"  {name:16s} {m50:8.0f}us {m99:8.0f}us {e50:9.0f}us")
        # (b) the first 16 slices on the card
        nets108 = {name: arch.build_arch(name, N_TORS, us108, tm=tm108,
                                         device=dev)
                   for name in arch.ARCHS}
        first108 = {name: net.run(wl108, ARCH_CPU_SLICES)
                    for name, net in nets108.items()}
        t0 = time.perf_counter()
        for name in arch.ARCHS:
            for tag, got, job in (("a", res8[name], cpu8[name]),
                                  ("b", first108[name], cpu108[name])):
                bad = sim_diff(got, job.get(timeout=600))
                if bad is not None:
                    raise SystemExit(f"phase 21({tag}): {name} differs from "
                                     f"the CPU in {bad}")
        out["cpu_wait_s"] = time.perf_counter() - t0
        pool.join()
    finally:
        pool.terminate()
        pool.join()
    log(f"phase 21(a) the seven runs equal the CPU's in every field; (b) "
        f"their first {ARCH_CPU_SLICES} slices at {N_TORS} ToRs too")
    # (b) the whole runs on the card, timed, the launch counters zeroed
    # just before each
    for name, net in nets108.items():
        net.run(wl108, 2)                    # warm: the step's tables
        torch.cuda.synchronize()
        tfl.launches = adm.launches = 0
        t0 = time.perf_counter()
        res = net.run(wl108, SLICES)
        wall = time.perf_counter() - t0
        done = res.t_deliver >= 0
        out["arch_108"][name] = dict(
            slices_per_s=SLICES / wall, delivered=float(done.mean()),
            uplinks=net.n_uplinks, schedule_slices=net.schedule.num_slices,
            table_k=int(net.routing.tf_next.shape[-1]),
            lookup_launches_per_slice=tfl.launches / SLICES,
            admission_launches_per_slice=adm.launches / SLICES)
        if not done.any():
            raise SystemExit(f"phase 21(b): {name} delivered nothing")
        log(f"  21(b) {name}: " + json.dumps(out["arch_108"][name]))
    return out


def fleet_window(dev, tables, wls, cfg):
    """The step and inputs of a sweep, as ``simulate_fleet`` builds them,
    for a profiled window: (step, j, the flow rows of its state)."""
    from repro_torch.core import fabric as fabric_mod
    B = len(wls)
    F = max(fabric_mod._num_flows(w) for w in wls)
    j = fabric_mod._fleet_arrays([tables] * B, wls, None, None, F, 0,
                                 dev)
    step = fabric_mod._make_step(j, cfg, tables.multipath == "packet")
    return step, j, B * F


def check_fleet(dev, phase6=None, profile: bool = True) -> dict:
    """Phase 21(c): ``simulate_fleet`` at 108 ToRs. Eight seeds of phase 4's
    workload on phase 4's fabric (``vlb``), four failure and control
    trace seeds on one workload with telemetry (``ucmp``, whose entries
    hold several paths, so that the per-packet hash matters), and four
    seeds on per-flow multipath (Jupiter's ``wcmp`` on a 4-uplink mesh:
    each scenario hashes its own flow ids, and the lookup takes the flow
    hash with no hash period): every member equal to its solo
    ``simulate`` on the card in every field and counter.
    Scenario-slices/s of the sweep beside the solo runs' total, kernels and
    device time a slice of a profiled sweep window beside phase 6's
    (``phase6``: its kernels and device ms a slice), peak device memory.
    Raises ``SystemExit`` on a mismatch; returns the numbers."""
    from repro_torch.core import (FabricConfig, FabricTables, TelemetryConfig,
                                  compile_control, compile_masks,
                                  random_control_trace, random_trace,
                                  round_robin, simulate, simulate_fleet,
                                  synthesize, ucmp, uniform_mesh, vlb, wcmp)
    from repro_torch.kernels import admission as adm
    from repro_torch.kernels import time_flow_lookup as tfl
    sched = round_robin(N_TORS, 1)
    cfg = FabricConfig()
    out = {}

    def sweep(tag, tables, wls, **kw):
        """The sweep and its solo runs, timed; every member checked."""
        B = len(wls)
        simulate_fleet(tables, wls, cfg, 2, device=dev)   # warm
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tfl.launches = adm.launches = 0
        t0 = time.perf_counter()
        fleet = simulate_fleet(tables, wls, cfg, SLICES, device=dev, **kw)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = dict(tfl=tfl.launches, adm=adm.launches)
        want = dict(tfl=SLICES * (1 + cfg.hops_per_slice),
                    adm=SLICES * cfg.hops_per_slice)
        if launches != want:
            raise SystemExit(f"phase 21(c) {tag}: launches {launches} (want "
                             f"{want}): a slice's launches must carry every "
                             "scenario")
        solo_wall = 0.0
        for b in range(B):
            skw = {k: (v if k == "telemetry" or v is None else v[b])
                   for k, v in kw.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solo = simulate(tables, wls[b], cfg, SLICES, device=dev, **skw)
            solo_wall += time.perf_counter() - t0
            bad = sim_diff(fleet[b], solo)
            if bad is not None:
                raise SystemExit(f"phase 21(c) {tag}: scenario {b} differs "
                                 f"from its solo run in {bad}")
        done = [float((r.t_deliver >= 0).mean()) for r in fleet]
        out[tag] = dict(
            scenarios=B, packets_per_scenario=wls[0].num_packets,
            fleet_wall_s=wall, solo_wall_s=solo_wall,
            fleet_scenario_slices_per_s=B * SLICES / wall,
            solo_scenario_slices_per_s=B * SLICES / solo_wall,
            peak_mib=peak / 2 ** 20, held_mib=held / 2 ** 20,
            launches=launches, delivered=done)
        log(f"  21(c) {tag}: " + json.dumps(out[tag]))

    # 1. eight seeds of phase 4's workload on phase 4's fabric
    tables = FabricTables.build(sched, vlb(sched, kpaths=4))
    wls = [synthesize("rpc", N_TORS, 64, slice_bytes=75_000, load=0.4,
                      max_packets=P_MAIN, seed=s) for s in range(FLEET_SEEDS)]
    if {w.num_packets for w in wls} != {P_MAIN}:
        raise SystemExit("phase 21(c): a seed's workload is not "
                         f"{P_MAIN} packets")
    sweep("seeds", tables, wls)
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile
        from torch.autograd import DeviceType
        step, j, nf = fleet_window(dev, tables, wls, cfg)
        bare_ms = window_wall_ms(step, j, nf)
        prof = tprofile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
        wall_ms = window_wall_ms(step, j, nf, prof)
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and self_device_ms(e) > 0]
        ev.sort(key=lambda e: -self_device_ms(e))
        tot = sum(self_device_ms(e) for e in ev)
        kps = sum(e.count for e in ev if not e.key.startswith(
            ("Memcpy", "Memset"))) / 16
        out["seeds"].update(kernels_per_slice=kps,
                            device_ms_per_slice=tot / 16,
                            wall_ms_per_slice=bare_ms / 16,
                            profiled_wall_ms_per_slice=wall_ms / 16,
                            idle_share=1 - tot / wall_ms)
        for e in ev[:10]:
            log(f"  {self_device_ms(e) / 16:8.4f} ms/slice "
                f"{self_device_ms(e) / tot:6.1%} x{e.count // 16:<4d}/slice "
                f"{e.key[:100]}")
        del step, j
        if phase6 is not None and kps > FLEET_KERNEL_RATIO * phase6[0]:
            raise SystemExit(f"phase 21(c): {kps:.2f} kernels a slice at B = "
                             f"{FLEET_SEEDS}, more than {FLEET_KERNEL_RATIO}x "
                             f"phase 6's {phase6[0]:.2f} at B = 1")
    del wls
    # 2. four failure and control traces on one workload, with telemetry
    tables = FabricTables.build(sched, ucmp(sched))
    wl = main_workload()
    fails = [compile_masks(random_trace(s, sched, SLICES, n_events=6), sched,
                           SLICES) for s in range(FLEET_TRACES)]
    ctrls = [compile_control(random_control_trace(s, N_TORS, SLICES,
                                                  n_events=4), SLICES, N_TORS)
             for s in range(FLEET_TRACES)]
    sweep("traces", tables, [wl] * FLEET_TRACES, failures=fails,
          control=ctrls, telemetry=TelemetryConfig())
    del fails, ctrls
    # 3. per-flow multipath: seeds of phase 4's workload on wcmp tables
    mesh = uniform_mesh(N_TORS, 4)
    tables = FabricTables.build(mesh, wcmp(mesh))
    if tables.multipath != "flow" or not (
            (tables.inj_next >= 0).sum(-1) > 1).any():
        raise SystemExit("phase 21(c): the wcmp tables are not per-flow "
                         "multipath over several slots")
    wls = [synthesize("rpc", N_TORS, 64, slice_bytes=75_000, load=0.4,
                      max_packets=P_MAIN, seed=s)
           for s in range(FLEET_FLOW_SEEDS)]
    sweep("flows", tables, wls)
    out["flows"]["num_flows"] = [w.num_flows for w in wls]
    return out


# -- phase 22: reconfigure_fleet and simulate_sharded ---------------------------
RFLEET_SEEDS = 4          # (a) sweep 1: traffic seeds of phase 4's workload
RFLEET_TRACES = 3         # (a) sweep 2: failure and control traces
# (b) rank counts, backends and slices: one rank over NCCL, then ranks
# sharing the card over gloo (5 divides neither 108 ToRs nor 131,072
# packets); 4 and 5 ranks over the first 64 slices, for time (every fault
# of phase 17 has started by slice 40)
SHARD_RUNS = ((1, None, SLICES), (2, "gloo", SLICES), (4, "gloo", 64),
              (5, "gloo", 64))


def check_reconfigure_fleet(dev) -> dict:
    """Phase 22(a): ``reconfigure_fleet`` at 108 ToRs on phase 20's net, 12
    epochs of 16 slices, 131,072 packets a scenario. Sweep 1: four seeds of
    phase 4's workload, 4 hot slices of ``hoho`` by hotswap under phase
    20's control trace with install faults, each scenario's install loss
    drawn from its own seed; sweep 2: one workload under three random
    failure and control traces, with heal and 2PC. Every member equal to
    its solo ``reconfigure`` on the card in every field, history array and
    counter; each sweep's launches one run's; scenario-slices/s beside the
    solo runs, an epoch's wall split (measure and schedule, the B
    recompiles, the slices), peak device memory. Raises ``SystemExit`` on
    a mismatch; returns the numbers."""
    from repro_torch.core import (ReconfigConfig, compile_control,
                                  compile_masks, random_control_trace,
                                  random_trace, reconfigure,
                                  reconfigure_fleet, round_robin, synthesize)
    from repro_torch.kernels import admission as adm
    from repro_torch.kernels import time_flow_lookup as tfl
    sched = round_robin(N_TORS, 1)
    net = reconf_net(sched)
    cfg = net.fabric_cfg
    slice_ns = SLICE_US * 1000.0
    base = dict(epoch_slices=RECONF_E, num_epochs=RECONF_EPOCHS)
    want = dict(tfl=RECONF_SLICES * (1 + cfg.hops_per_slice),
                adm=RECONF_SLICES * cfg.hops_per_slice)
    out = {}

    def sweep(tag, rcfg, wls, failures=None, control=None):
        B = len(wls)
        solo, solo_wall = [], 0.0
        for b, wl in enumerate(wls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solo.append(reconfigure(
                sched, wl, cfg, rcfg, device=dev,
                failures=None if failures is None else failures[b],
                control=None if control is None else control[b]))
            solo_wall += time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tfl.launches = adm.launches = 0
        with EpochClock() as clk:
            t0 = time.perf_counter()
            got = reconfigure_fleet(sched, wls, cfg, rcfg, failures=failures,
                                    control=control, device=dev)
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = dict(tfl=tfl.launches, adm=adm.launches)
        if launches != want:
            raise SystemExit(f"phase 22(a) {tag}: launches {launches} (want "
                             f"{want}: every launch all scenarios)")
        for b in range(B):
            bad = reconfig_diff(solo[b], got[b])
            if bad is not None:
                raise SystemExit(f"phase 22(a) {tag}: scenario {b} and its "
                                 f"solo run differ in {bad}")
        if all(np.array_equal(g.t_deliver, got[0].t_deliver)
               for g in got[1:]):
            raise SystemExit(f"phase 22(a) {tag}: the scenarios do not "
                             "differ, so a mix-up between them cannot show")
        n_comp = B * RECONF_EPOCHS
        comp = sum(clk.compile_s[-n_comp:])
        win = sum(clk.window_s)
        boot = sum(clk.compile_s[:-n_comp])
        out[tag] = dict(
            scenarios=B, fleet_wall_s=wall, solo_wall_s=solo_wall,
            fleet_scenario_slices_per_s=B * RECONF_SLICES / wall,
            solo_scenario_slices_per_s=B * RECONF_SLICES / solo_wall,
            epoch=dict(wall_ms=wall * 1e3 / RECONF_EPOCHS,
                       measure_schedule_ms=(wall - comp - win - boot) * 1e3
                       / RECONF_EPOCHS,
                       recompiles_ms=comp * 1e3 / RECONF_EPOCHS,
                       slices_ms=win * 1e3 / RECONF_EPOCHS),
            boot_compile_ms=boot * 1e3,
            peak_mib=peak / 2 ** 20, loop_peak_mib=(peak - held) / 2 ** 20,
            launches=launches,
            mixed_epochs=[int((g.install_ver != g.install_ver[:, :1])
                              .any(axis=1).sum()) for g in got],
            failed_links=[int(g.failed_links.sum()) for g in got],
            install_lat=[g.install_lat.tolist() for g in got],
            delivered=[float((g.t_deliver >= 0).mean()) for g in got])
        return got

    # 1. traffic seeds by hotswap under the control trace, each scenario's
    # install loss from its own seed
    wls = [synthesize("rpc", N_TORS, 64, slice_bytes=75_000, load=0.4,
                      max_packets=P_MAIN, seed=s) for s in range(RFLEET_SEEDS)]
    if {w.num_packets for w in wls} != {P_MAIN}:
        raise SystemExit(f"phase 22(a): a seed's workload is not {P_MAIN} "
                         "packets")
    ctrls = [compile_control(net.control_trace, RECONF_SLICES, N_TORS,
                             slice_ns=slice_ns, seed=s)
             for s in range(RFLEET_SEEDS)]
    sweep("seeds_hotswap", ReconfigConfig(**base, scheme="hoho", k_hot=4,
                                          install="hotswap"), wls,
          control=ctrls)
    if not all(out["seeds_hotswap"]["mixed_epochs"]):
        raise SystemExit("phase 22(a): a hotswap scenario never ended an "
                         "epoch with mixed versions")
    del wls, ctrls
    # 2. failure and control traces with heal and 2PC
    wl = main_workload()
    fails = [compile_masks(random_trace(s, sched, RECONF_SLICES, n_events=6),
                           sched, RECONF_SLICES) for s in range(RFLEET_TRACES)]
    ctrls = [compile_control(random_control_trace(s, N_TORS, RECONF_SLICES,
                                                  n_events=4),
                             RECONF_SLICES, N_TORS, slice_ns=slice_ns, seed=s)
             for s in range(RFLEET_TRACES)]
    sweep("traces_heal_2pc", ReconfigConfig(**base, scheme="hoho", k_hot=4,
                                            heal=True, install="2pc"),
          [wl] * RFLEET_TRACES, failures=fails, control=ctrls)
    if not any(out["traces_heal_2pc"]["failed_links"]):
        raise SystemExit("phase 22(a): no trace failed a link")
    return out


def shard_group(cases):
    """What every rank of one of phase 22(b)'s gloo groups runs:
    ``simulate_shard`` of each case (both schemes) in the one group, with
    the debug dict."""
    from repro_torch.core import simulate_shard
    return [simulate_shard(*case, with_debug=True) for case in cases]


def check_sharded(dev) -> dict:
    """Phase 22(b): ``simulate_sharded`` at 108 ToRs on phase 4's workload
    (131,072 packets, 214 slices) with phase 17's failure and control
    masks and telemetry on, on phase 4's ``vlb`` and on ``ucmp`` (several
    valid slots an entry, so that a lookup hashing a rank's local index
    picks other paths): 1 rank over NCCL, 2, 4 and 5 ranks sharing the card
    over gloo (4 and 5 over the first 64 slices). The one-rank runs are
    ``simulate_sharded`` calls, one a scheme; each gloo rank count runs
    both schemes in one group (``shard_group``: one start-up for both).
    Every run equal to the single-device
    ``simulate`` of its length in every field and counter,
    ``check_sharding`` clean, every rank's lookup and admission launches
    one run's. Slices/s per rank count (rank 0's run time), exchanges and
    bytes exchanged a slice, rank 0's start-up by part. Raises
    ``SystemExit`` on a mismatch; returns the numbers."""
    from repro_torch.core import (FabricTables, TelemetryConfig,
                                  compile_control, compile_masks, round_robin,
                                  simulate, simulate_sharded, toolkit, ucmp,
                                  vlb)
    from repro_torch.core.fabric import SHARD_TIMEOUT_S
    from repro_torch.distributed import run_ranks
    sched = round_robin(N_TORS, 1)
    wl = main_workload()
    net = faulty_net(sched)
    cfg = net.fabric_cfg
    masks = {S: (compile_masks(net.failure_trace, sched, S),
                 compile_control(net.control_trace, S, N_TORS,
                                 slice_ns=SLICE_US * 1000.0))
             for S in {S for _, _, S in SHARD_RUNS}}
    tele = TelemetryConfig()
    out = dict(launches=dict(tfl=0, adm=0), groups={})
    tables, one = {}, {}
    for fab, routing in (("vlb", vlb(sched, kpaths=4)), ("ucmp", ucmp(sched))):
        tables[fab] = FabricTables.build(sched, routing)
        valid = (tables[fab].inj_next >= 0).sum(-1)
        rate = {}
        for S, (fail, ctrl) in masks.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one[fab, S] = simulate(tables[fab], wl, cfg, S, failures=fail,
                                   control=ctrl, telemetry=tele, device=dev)
            rate[S] = S / (time.perf_counter() - t0)
        out[fab] = dict(paths_per_entry=float(valid[valid > 0].mean()),
                        one_device_slices_per_s=rate[SLICES])
    for D, backend, S in SHARD_RUNS:
        fail, ctrl = masks[S]
        want = [S * (1 + cfg.hops_per_slice), S * cfg.hops_per_slice]
        t0 = time.perf_counter()
        if backend is None:
            # one NCCL rank: the user's entry point, a call a scheme
            got, walls = [], []
            for fab in tables:
                t1 = time.perf_counter()
                got.append(simulate_sharded(
                    tables[fab], wl, cfg, S, num_shards=D, failures=fail,
                    control=ctrl, telemetry=tele, with_debug=True))
                walls.append(time.perf_counter() - t1)
        else:
            cases = [(tables[fab], wl, cfg, S, fail, ctrl, tele)
                     for fab in tables]
            got = run_ranks(shard_group, (cases,), D, backend, "cuda",
                            SHARD_TIMEOUT_S)
            walls = [time.perf_counter() - t0] * len(cases)
        wall = time.perf_counter() - t0
        runs = sum(dbg["run_s"] for _, dbg in got)
        # rank 0's start-up, once a spawn; the rest of the wall is the
        # shard set-up of a group's later runs, the result's way back and
        # the ranks' exit
        setup = [dbg["setup_s"] for _, dbg in (got[:1] if backend else got)]
        out["groups"][f"D{D}"] = dict(
            backend=backend or "nccl", spawns=len(setup), wall_s=wall,
            run_s=runs, setup_s=setup,
            other_s=wall - runs - sum(sum(x.values()) for x in setup))
        log(f"phase 22(b) {D} ranks ({backend or 'nccl'}): "
            f"{json.dumps(out['groups'][f'D{D}'])}")
        for fab, (res, dbg), w in zip(tables, got, walls):
            bad = sim_diff(one[fab, S], res)
            if bad is not None:
                raise SystemExit(f"phase 22(b) {fab} on {D} ranks: the "
                                 f"sharded and one-device runs differ in "
                                 f"{bad}")
            viol = toolkit.check_sharding(res, dbg, wl, S)
            if viol:
                raise SystemExit(f"phase 22(b) {fab} on {D} ranks: "
                                 f"check_sharding: {viol[:3]}")
            if dbg["launches"].tolist() != [want] * D:
                raise SystemExit(f"phase 22(b) {fab} on {D} ranks: launches "
                                 f"{dbg['launches'].tolist()} (want {want} "
                                 "on every rank)")
            out["launches"]["tfl"] += int(dbg["launches"][:, 0].sum())
            out["launches"]["adm"] += int(dbg["launches"][:, 1].sum())
            out[fab][f"D{D}"] = dict(
                backend=backend or "nccl", slices=S, wall_s=w,
                run_s=dbg["run_s"], slices_per_s=S / dbg["run_s"],
                exchanges_per_slice=dbg["exchanges"] / S,
                exchanged_bytes_per_slice=dbg["exchanged_bytes"] / S,
                admitting_ranks=len(set(dbg["adm_shard"].tolist()) - {-1}))
            log(f"phase 22(b) {fab} on {D} ranks ({backend or 'nccl'}): "
                f"{json.dumps(out[fab][f'D{D}'])}")
    return out


# -- phases A-D: EQO and the last model families ---------------------------------

EQO_INTERVALS = (25, 50, 100, 200, 400, 800)    # fig12's update intervals, ns
EQO_TOTAL_NS = 200_000


def check_eqo(dev) -> dict:
    """Phase A: ``simulate_eqo`` at fig12's intervals on the card against
    the port's CPU run (both exact in float64: the maxima equal, the means
    within 1e-12 relative), and fig12's two properties."""
    from repro_torch.core import simulate_eqo
    rows = {}
    for iv in EQO_INTERVALS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = simulate_eqo(iv, EQO_TOTAL_NS, device=dev)   # ends on the host
        wall = (time.perf_counter() - t0) * 1e3
        want = simulate_eqo(iv, EQO_TOTAL_NS, device="cpu")
        rel = abs(got["err_mean_bytes"] - want["err_mean_bytes"]) / \
            want["err_mean_bytes"]
        rows[iv] = dict(err_max_bytes=got["err_max_bytes"],
                        err_mean_bytes=got["err_mean_bytes"], wall_ms=wall,
                        mean_relerr_vs_cpu=rel)
        log(f"phase A eqo {iv} ns: err_max {got['err_max_bytes']} B "
            f"(CPU {want['err_max_bytes']}), err_mean "
            f"{got['err_mean_bytes']!r} B (relerr vs CPU {rel:.1e}), "
            f"{wall:.2f} ms")
        if got["err_max_bytes"] != want["err_max_bytes"] or not rel <= 1e-12:
            raise SystemExit(f"eqo {iv} ns: the card's run is not the CPU's")
    if not (rows[50]["err_max_bytes"] <= 750 and
            rows[50]["err_max_bytes"] < rows[800]["err_max_bytes"]):
        raise SystemExit(f"eqo: fig12's properties fail: {rows}")
    return rows


# phase B limits. XLSTM_FORMS_TOL: the largest error of the mLSTM block's
# chunkwise output (L = 512, chunks of 256) against its parallel form and
# its recurrent steps, over the largest |output|: sound 4.26e-3 to 7.63e-3;
# the chunkwise row stabiliser without the carried state reads 1.01.
# XLSTM_CPU_*: the 2-block model's logits on the card against the CPU's,
# as phase 10 reads them: sound 4.67e-3 to 5.92e-3 (max) and 3.92e-3 to
# 5.15e-3 (RMS) per step; the mLSTM's recurrent step without its
# stabiliser's carry, on the card only, 0.106 to 0.331 and 7.82e-2 to
# 0.224 at every decode step (PERF.md §2)
XLSTM_FORMS_TOL = 3e-2
XLSTM_CPU_TOL = 2.5e-2
XLSTM_CPU_RMS_TOL = 2e-2
# phase C limits, 2 + 2 layers through the kernels against the plain
# versions: sound 1.13e-2 to 1.48e-2 (max) and 1.18e-2 to 1.28e-2 (RMS) per
# step; flash-decode missing the last 64 positions reads 0.109 to 0.207 and
# 0.112 to 0.147 at every decode step, flash causal on every call 0.89 to
# 1.04. CROSS_TOL, the cross-attention against plain_cross: sound 5.78e-3
# (3,072 queries) and 1.98e-3 (one); RoPE on its keys 0.97 and 0.88
SEAMLESS_TOL = 4e-2
SEAMLESS_RMS_TOL = 3.5e-2
CROSS_TOL = 5e-2
# phase D limits, 4 layers through the kernels against the plain versions:
# sound 9.29e-3 to 1.44e-2 (max) and 9.52e-3 to 1.41e-2 (RMS); flash-decode
# missing the last 64 positions 0.171 to 0.232 and 0.190 to 0.206 at every
# decode step, flash with a 3,072-key window 6.69e-2 to 0.914 and 7.65e-2
# to 0.819. INDEX_TOL, the first decode step against the prefill of the
# prompt and its token: sound 1.23e-2 at 4,096; at the reference's 3,072,
# 1.04 (PERF.md §2)
LLAVA_TOL = 3e-2
LLAVA_RMS_TOL = 3e-2
INDEX_TOL = 5e-2
LLAVA_SERVE = dict(cache_len=4224)     # 1,024 patches + 3,072 + 2 x 32
LLAVA_LAYERS = 4


def part_of_prefill(dev, arch, module, name, frontend=True, n_layers=None):
    """One full-width prefill (B = 4, L = 3,072) of ``arch`` timed bare,
    then again with every call of ``module.name`` synchronised and timed.
    Returns (bare prefill ms, instrumented prefill ms, the calls' ms, the
    number of calls)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg)
    params = model.init(0, dev)
    B, L = SERVE_ARGS["batch"], SERVE_ARGS["prompt_len"]
    rng = np.random.default_rng(6)
    prompt = torch.tensor(rng.integers(2, cfg.vocab, (B, L)), device=dev)
    fe = frontend_embeds(dev, cfg, B, 7) if frontend else None

    def prefill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, prompt, model.init_cache(
            B, SERVE_ARGS["cache_len"], dev,
            enc_len=cfg.frontend_tokens or None), fe)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    prefill()                                       # warm
    bare = prefill()
    real, spent = getattr(module, name), []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return out
    setattr(module, name, timed)
    try:
        inst = prefill()
    finally:
        setattr(module, name, real)
    del params
    return bare, inst, sum(spent), len(spent)


def frontend_embeds(dev, cfg, B, seed):
    """The stub frontend's embeddings, as ``serve`` draws them: standard
    normals [B, frontend_tokens, frontend_dim] in bfloat16."""
    from repro_torch.models.stacks import frontend_dim
    x = np.random.default_rng(seed).normal(
        size=(B, cfg.frontend_tokens, frontend_dim(cfg)))
    return torch.tensor(x, dtype=torch.float32, device=dev).to(torch.bfloat16)


def serve_line(tag, arch, res, n_prefill, n_decode, peak, wall, counts):
    log(f"phase {tag} serve {arch}: {json.dumps(res)}; {n_prefill} prefills "
        f"({res['prefill_s'] / n_prefill:.3f} s each), {n_decode} decode "
        f"steps ({1e3 * res['decode_s'] / n_decode:.2f} ms each, "
        f"{res['decode_tok_s']:.1f} tokens/s), wall {wall:.1f} s incl. "
        f"init, peak {peak:.2f} GiB; launches {json.dumps(counts)}")


def check_served(tag, res, counts, want, requests=SERVE_ARGS["requests"]):
    if counts != want or res["requests_done"] != requests or \
            res["decode_tokens"] <= 0:
        raise SystemExit(f"phase {tag}: launches {counts} (want {want}), "
                         f"result {res}")


def check_mlstm_forms(dev, cfg, params) -> dict:
    """The mLSTM block of ``params``' first layer at full width (B = 2, L
    = 512): its chunkwise form (two chunks of 256, the serve path's)
    against its parallel form and its recurrent steps on the card."""
    from repro_torch.models import layers as ly
    blk = params.layers[0].mlstm
    g = torch.Generator(device=dev).manual_seed(12)
    x = params.layers[0].norm1(torch.randn(2, 512, cfg.d_model, generator=g,
                                           device=dev).to(torch.bfloat16))
    with torch.no_grad():
        chunk, _ = ly.mlstm_apply(blk, x, cfg, state=ly.mlstm_state(
            cfg, 2, dev))
        par, _ = ly.mlstm_apply(blk, x, dataclasses.replace(
            cfg, mlstm_chunk=0), state=ly.mlstm_state(cfg, 2, dev))
        s, steps = ly.mlstm_state(cfg, 2, dev), []
        for t in range(x.shape[1]):
            h, s = ly.mlstm_apply(blk, x[:, t:t + 1], cfg, state=s)
            steps.append(h)
    errs = dict(parallel=relerr(chunk, par),
                recurrent=relerr(chunk, torch.cat(steps, 1)),
                parallel_vs_recurrent=relerr(par, torch.cat(steps, 1)))
    log(f"phase B mLSTM forms at full width (B=2, L=512, chunks of "
        f"{cfg.mlstm_chunk}): chunkwise vs parallel {errs['parallel']:.2e}, "
        f"vs recurrent {errs['recurrent']:.2e}, parallel vs recurrent "
        f"{errs['parallel_vs_recurrent']:.2e} (limit {XLSTM_FORMS_TOL:.0e})")
    if max(errs.values()) > XLSTM_FORMS_TOL:
        raise SystemExit("phase B: the mLSTM's three forms disagree")
    return errs


def check_xlstm_vs_cpu(dev) -> dict:
    """One mLSTM and one sLSTM block at xLSTM-350M's width (random weights
    from a seed, ``mlstm_chunk`` 256): the mLSTM's three forms on the card;
    then a prefill (B = 2, L = 512: the chunkwise form) and 4 greedy decode
    steps on the card, and the same weights and tokens on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, stacks
    cfg = dataclasses.replace(get_config("xlstm-350m"), n_layers=2)
    model = build_model(cfg)
    params = model.init(1, dev)
    forms = check_mlstm_forms(dev, cfg, params)
    cpu = stacks.Stack(cfg, "cpu")
    cpu.load_state_dict(params.state_dict())
    B, L, steps = 2, 512, 4
    prompt = np.random.default_rng(13).integers(2, cfg.vocab, (B, L))

    def run(p, d, tokens=None):
        logits, cache = model.prefill(p, torch.tensor(prompt, device=d),
                                      model.init_cache(B, L + steps, d))
        out, toks = [logits[:, -1]], []
        for i in range(steps):
            tok = (logits[:, -1].argmax(-1) if tokens is None
                   else tokens[i].to(d))[:, None]
            toks.append(tok[:, 0].cpu())
            logits, cache = model.decode_step(p, tok, cache, L + i)
            out.append(logits[:, -1])
        return torch.stack(out).cpu(), toks

    t0 = time.perf_counter()
    got, toks = run(params, dev)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, _ = run(cpu, torch.device("cpu"), toks)
    t_cpu = time.perf_counter() - t0
    log(f"phase B card vs CPU: prefill + {steps} steps {t_card:.2f} s on the "
        f"card, {t_cpu:.2f} s on the CPU")
    held = hold_model(f"phase B xlstm-350m card vs CPU (2 blocks, d 1024, "
                      f"B={B}, L={L}, {steps} decode steps)", got, want,
                      [0] * (steps + 1), XLSTM_CPU_TOL, XLSTM_CPU_RMS_TOL)
    return dict(forms=forms, **held)


def check_xlstm(dev) -> dict:
    """Phase B: serve xLSTM-350M at full width and depth; the sLSTM
    layers' share of a prefill and their launches; the card against the
    CPU (``check_xlstm_vs_cpu``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import layers as ly
    arch = "xlstm-350m"
    # one request past the slots: one refill (a refill is a whole prefill,
    # ~12-16 s of sLSTM steps here)
    requests = SERVE_ARGS["batch"] + 1
    res, counts, n_prefill, n_decode, peak, wall, _ = run_serve(
        dev, arch, requests=requests)
    serve_line("B", arch, res, n_prefill, n_decode, peak, wall, counts)
    check_served("B", res, counts, dict(flash=0, decode=0, rg_lru=0, gmm=0),
                 requests)
    if n_prefill != 2:
        raise SystemExit(f"phase B: {n_prefill} prefills (want 2: the batch "
                         "and one refill)")
    gc.collect()
    torch.cuda.empty_cache()
    bare, inst, sl_ms, sl_calls = part_of_prefill(dev, arch, ly,
                                                  "slstm_apply", False)
    # the kernels one sLSTM block launches over a 3,072-token prompt
    cfg = get_config(arch)
    params = build_model(cfg).init(0, dev)
    blk = params.layers[1].slstm
    x = torch.randn(SERVE_ARGS["batch"], SERVE_ARGS["prompt_len"],
                    cfg.d_model, device=dev).to(torch.bfloat16)
    ly.slstm_apply(blk, x, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ly.slstm_apply(blk, x, cfg)
        torch.cuda.synchronize()
    per_block = sum(e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and
                    self_device_ms(e) > 0 and not e.key.startswith(
                        ("Memcpy", "Memset")))
    del params, blk, x
    loops = dict(prefill_ms=bare, instrumented_prefill_ms=inst,
                 slstm_ms=sl_ms, slstm_calls=sl_calls,
                 slstm_share=sl_ms / inst, kernels_per_block=per_block,
                 kernels_per_prefill=per_block * sl_calls,
                 kernels_per_step=per_block / SERVE_ARGS["prompt_len"])
    log(f"phase B sLSTM loops: a prefill {bare:.1f} ms ({inst:.1f} ms with "
        f"each block synchronised), its {sl_calls} sLSTM blocks {sl_ms:.1f} "
        f"ms ({sl_ms / inst:.1%}); {per_block} kernels a block "
        f"({per_block / SERVE_ARGS['prompt_len']:.2f} a step), "
        f"{per_block * sl_calls} a prefill")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(serve=res, launches=counts, prefills=n_prefill,
                decode_steps=n_decode, peak_gib=peak, loops=loops,
                vs_cpu=check_xlstm_vs_cpu(dev))


def plain_cross(p, x, mem, cfg):
    """Cross-attention written out in float32, as the reference defines
    it: queries of x, keys and values of the memory, no rotation, every
    key visible, one softmax; then the output projection."""
    B, L, _ = x.shape
    S, H, Kv = mem.shape[1], cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    q = (x @ p.wq).float().view(B, L, H, hd).transpose(1, 2)
    k = (mem @ p.wk).float().view(B, S, Kv, hd).transpose(1, 2)
    v = (mem @ p.wv).float().view(B, S, Kv, hd).transpose(1, 2)
    k, v = (t.repeat_interleave(H // Kv, 1) for t in (k, v))
    w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), -1)
    out = (w @ v).transpose(1, 2).reshape(B, L, H * hd).to(x.dtype)
    return out @ p.wo


def check_seamless_vs_plain(dev) -> dict:
    """Seamless-M4T-large-v2 at full width, 2 encoder and 2 decoder
    layers: prefill (B = 4, L = 3,072, 1,024 audio frames) + 8 greedy
    decode steps through the kernels against the plain versions; and one
    decoder layer's cross-attention (as the stack runs it: K/V of the
    memory, then the queries through flash attention, or flash-decode for
    one token) against ``plain_cross``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import layers as ly
    cfg = dataclasses.replace(get_config("seamless-m4t-large-v2"),
                              n_layers=2, n_enc_layers=2)
    B, L = SERVE_ARGS["batch"], SERVE_ARGS["prompt_len"]
    fe = frontend_embeds(dev, cfg, B, 14)
    got, want, flips = model_vs_plain(dev, cfg, B, L, init_seed=1,
                                      prompt_seed=8, frontend_embeds=fe)
    held = hold_model(f"phase C seamless-m4t-large-v2 vs plain (2 + 2 "
                      f"layers, d 1024, B={B}, L={L}, 8 decode steps)", got,
                      want, flips, SEAMLESS_TOL, SEAMLESS_RMS_TOL)
    layer = build_model(cfg).init(2, dev).layers[0]
    g = torch.Generator(device=dev).manual_seed(15)
    mem = torch.randn(B, cfg.frontend_tokens, cfg.d_model, generator=g,
                      device=dev).to(torch.bfloat16)
    pos = torch.arange(cfg.frontend_tokens, device=dev).expand(B, -1)
    kv = ly.cross_kv(layer.xattn, mem, cfg, pos)
    cross = {}
    for Lq in (L, 1):
        x = torch.randn(B, Lq, cfg.d_model, generator=g,
                        device=dev).to(torch.bfloat16)
        cross[f"Lq{Lq}"] = relerr(ly.cross_attend(layer.xattn, x, cfg, kv),
                                  plain_cross(layer.xattn, x, mem, cfg))
    log(f"phase C cross-attention against plain_cross: " + ", ".join(
        f"{k} relerr {v:.2e}" for k, v in cross.items())
        + f" (limit {CROSS_TOL:.0e})")
    if max(cross.values()) > CROSS_TOL:
        raise SystemExit("phase C: the cross-attention is not the plain one")
    return dict(cross=cross, **held)


def check_seamless(dev) -> dict:
    """Phase C: serve Seamless-M4T-large-v2 at full width and depth (72
    flash launches a prefill: 24 encoder, 24 decoder, 24 cross; 48
    flash-decode a step: 24 self, 24 cross), the encoder's share of a
    prefill, ``check_seamless_vs_plain``."""
    from repro_torch.models import stacks
    arch = "seamless-m4t-large-v2"
    res, counts, n_prefill, n_decode, peak, wall, _ = run_serve(dev, arch)
    serve_line("C", arch, res, n_prefill, n_decode, peak, wall, counts)
    check_served("C", res, counts, dict(flash=72 * n_prefill,
                                        decode=48 * n_decode, rg_lru=0,
                                        gmm=0))
    gc.collect()
    torch.cuda.empty_cache()
    bare, inst, enc_ms, _ = part_of_prefill(dev, arch, stacks, "_encoder")
    log(f"phase C encoder: a prefill {bare:.1f} ms ({inst:.1f} ms with the "
        f"encoder synchronised), the encoder {enc_ms:.1f} ms "
        f"({enc_ms / inst:.1%})")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(serve=res, launches=counts, prefills=n_prefill,
                decode_steps=n_decode, peak_gib=peak,
                encoder=dict(prefill_ms=bare, instrumented_prefill_ms=inst,
                             encoder_ms=enc_ms, share=enc_ms / inst),
                vs_plain=check_seamless_vs_plain(dev))


def check_decode_index(dev, index: int) -> float:
    """LLaVA-NeXT-34B at full width, 4 layers (B = 2): a decode step at
    ``index`` after the prefill of 1,024 patches and a 3,072-token prompt,
    against the prefill of the prompt and that token (the model's
    next-token logits). Returns the relative error."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("llava-next-34b"),
                              n_layers=LLAVA_LAYERS)
    model = build_model(cfg)
    params = model.init(3, dev)
    B, L, S = 2, SERVE_ARGS["prompt_len"], LLAVA_SERVE["cache_len"]
    fe = frontend_embeds(dev, cfg, B, 16)
    toks = torch.tensor(np.random.default_rng(17).integers(
        2, cfg.vocab, (B, L + 1)), device=dev)
    _, cache = model.prefill(params, toks[:, :L],
                             model.init_cache(B, S, dev), fe)
    step, _ = model.decode_step(params, toks[:, L:], cache, index)
    right, _ = model.prefill(params, toks, model.init_cache(B, S, dev), fe)
    err = relerr(step[:, -1], right[:, -1])
    log(f"phase D the serve's first decode step, at index {index} (prefix "
        f"{cfg.frontend_tokens} + prompt {L}), against the prefill of the "
        f"prompt and its token: relerr {err:.2e} (limit {INDEX_TOL:.0e})")
    if err > INDEX_TOL:
        raise SystemExit("phase D: the serve's decode index does not give "
                         "the next-token logits")
    return err


def check_llava_vs_plain(dev) -> dict:
    """LLaVA-NeXT-34B at full width, 4 layers: prefill (B = 2, 1,024
    patches + 3,072 tokens) + 8 greedy decode steps through the kernels
    against the plain versions."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("llava-next-34b"),
                              n_layers=LLAVA_LAYERS)
    B, L = 2, SERVE_ARGS["prompt_len"]
    got, want, flips = model_vs_plain(
        dev, cfg, B, L, init_seed=1, prompt_seed=9,
        frontend_embeds=frontend_embeds(dev, cfg, B, 18),
        cache_len=LLAVA_SERVE["cache_len"])
    return hold_model(f"phase D llava-next-34b vs plain ({LLAVA_LAYERS} "
                      f"layers, d 7168, B={B}, L={cfg.frontend_tokens} + {L},"
                      f" 8 decode steps)", got, want, flips, LLAVA_TOL,
                      LLAVA_RMS_TOL)


def check_llava(dev) -> dict:
    """Phase D: LLaVA-NeXT-34B at full width, 4 layers: serve (the cache
    holds 1,024 patches, the 3,072-token prompt and both rounds' 32
    tokens), ``check_decode_index`` at the index of the serve's first
    decode step, ``check_llava_vs_plain``."""
    arch = "llava-next-34b"
    res, counts, n_prefill, n_decode, peak, wall, idx = run_serve(
        dev, arch, n_layers=LLAVA_LAYERS, **LLAVA_SERVE)
    serve_line(f"D ({LLAVA_LAYERS} layers)", arch, res, n_prefill, n_decode,
               peak, wall, counts)
    check_served("D", res, counts, dict(flash=LLAVA_LAYERS * n_prefill,
                                        decode=LLAVA_LAYERS * n_decode,
                                        rg_lru=0, gmm=0))
    out = dict(serve=res, launches=counts, prefills=n_prefill,
               decode_steps=n_decode, peak_gib=peak, first_index=idx[0])
    for key, check in (("index_relerr", lambda: check_decode_index(
            dev, idx[0])), ("vs_plain", lambda: check_llava_vs_plain(dev))):
        gc.collect()
        torch.cuda.empty_cache()
        out[key] = check()
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase E: training -----------------------------------------------------
# E(a): each kernel's gradient on the card against the plain version's
# autograd. Flash attention at OLMo-1B's training shape (B = 4 micro-batch
# rows, 16 MHA heads of 128, 4,096 tokens, causal), at a windowed,
# soft-capped GQA shape (Gemma-2-9B's heads: 16 q / 8 kv of 256, softcap
# 50, a 1,024 window; q and k drawn 4x wider, so that scores reach the cap
# and the softcap's factor in the backward matters: without it dq and dk
# are 35-56% off, 0.4% at unit width) and at Seamless's cross-attention
# (hd 64, 3,072 queries over 1,024 frames); the backward's blocks are the
# configs' attn_bq = attn_bk = 2,048.
TRAIN_FLASH = {
    "olmo": dict(B=4, Hq=16, Hkv=16, L=4096, S=4096, hd=128,
                 kw=dict(causal=True, window=0, softcap=0.0)),
    "windowed_softcap_gqa": dict(B=2, Hq=16, Hkv=8, L=4096, S=4096, hd=256,
                                 kw=dict(causal=True, window=1024,
                                         softcap=50.0), amp=4.0),
    "seamless_cross": dict(B=4, Hq=16, Hkv=16, L=3072, S=1024, hd=64,
                           kw=dict(causal=False, window=0, softcap=0.0)),
}
TRAIN_BLOCK = 2048
# bf16 tolerance of tests/test_kernels.py for the gradients (relative error
# of each of dq, dk, dv); the LSE within the f32 model tolerance
TRAIN_GRAD_TOL = 2e-2
LSE_TOL = 1e-4
# E(b): kernels vs plain versions on a reduced model's gradients, in bf16:
# the model tolerance of the CPU tests (tests/torch_lm_parity.py)
TRAIN_MODEL_TOL = 6e-2
TRAIN_SMALL = dict(seq=256, global_batch=8, steps=8)
# E(c): OLMo-1B at full width and depth, cut from train_4k's 256 x 4,096
# tokens to 8 x 4,096 (two micro-batches of 4) and 10 steps
OLMO_TRAIN = dict(arch="olmo-1b", preset="full", steps=10, global_batch=8,
                  seq=4096, micro_batches=2)
# E(d): crash at step 5 of 6 and resume from the step-4 checkpoint
RESUME_RUN = dict(arch="olmo-1b", preset="small", steps=6, global_batch=4,
                  seq=256, micro_batches=2, ckpt_every=2, seed=3)


def event_ms(fn, repeats: int = 3) -> float:
    """Median device time of ``fn()`` between CUDA events, after one
    warm-up call (for work a CUDA graph cannot hold: autograd's
    backward)."""
    fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def visible_pairs(L, S, causal, window) -> int:
    """(query, key) pairs the mask lets through, counted exactly."""
    i = np.arange(L)
    hi = np.minimum(i, S - 1) if causal else np.full(L, S - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(L, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def grad_errs(got, want) -> dict:
    return {n: relerr(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}


def check_flash_grads(dev) -> dict:
    """FlashAttentionFn (the kernel with its LSE, the torch-op backward)
    against autograd through the plain version, and the kernel's LSE
    against the plain one; forward + backward timed beside the plain
    version's and SDPA's (where SDPA computes the same function)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.chunked_attention import FlashAttentionFn
    out = {}
    for tag, sh in TRAIN_FLASH.items():
        B, Hq, Hkv, L, S, hd = (sh[k] for k in ("B", "Hq", "Hkv", "L", "S",
                                                  "hd"))
        kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, **sh["kw"])
        scale = 1.0 / math.sqrt(hd)
        q, k, v = flash_inputs(dev, B, Hq, Hkv, L, S, hd, seed=70)
        q, k = q * sh.get("amp", 1.0), k * sh.get("amp", 1.0)
        g = torch.Generator(device=dev).manual_seed(71)
        dout = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
        args = (Hq, Hkv, kw["causal"], kw["window"], kw["softcap"], scale, 0,
                TRAIN_BLOCK, TRAIN_BLOCK)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

        def kernel_fwd():
            return FlashAttentionFn.apply(*leaves, *args)

        def plain_fwd():
            return fa.flash_attention_plain(*leaves, scale=scale, **kw)

        res = {}
        for name, fwd in (("kernel", kernel_fwd), ("plain", plain_fwd)):
            o = fwd()
            res[name] = torch.autograd.grad(o, leaves, dout)
            del o
        errs = grad_errs(res["kernel"], res["plain"])
        _, lse_k = fa.flash_attention(q, k, v, scale=scale, lse=True, **kw)
        _, lse_p = fa.flash_attention_plain(q, k, v, scale=scale, lse=True,
                                            **kw)
        lse_err = relerr(lse_k, lse_p)
        finite = all(bool(torch.isfinite(x).all()) for x in res["kernel"])
        del res
        # times: forward + backward, and the backward alone (the graph of
        # one forward kept for repeated backward passes)
        t = {}
        for name, fwd in (("kernel", kernel_fwd), ("plain", plain_fwd)):
            t[f"{name}_fwd_bwd_ms"] = event_ms(
                lambda: torch.autograd.grad(fwd(), leaves, dout))
            o = fwd()
            t[f"{name}_bwd_ms"] = event_ms(
                lambda: torch.autograd.grad(o, leaves, dout,
                                            retain_graph=True))
            del o
        sdpa = None
        if kw["softcap"] == 0.0 and kw["window"] == 0:
            sq, sk, sv = (x.reshape(B, -1, x.shape[1], hd) for x in leaves)
            dsd = dout.reshape(B, Hq, L, hd)
            sdpa = event_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(sq, sk, sv,
                                               is_causal=kw["causal"]),
                (sq, sk, sv), dsd))
        pairs = B * Hq * visible_pairs(L, S, kw["causal"], kw["window"])
        # the backward's least work: five products of 2 * pairs * hd flops
        # (S again, dP, dV, dQ, dK); q, k, v, out, dout, lse read once, dq,
        # dk, dv written once
        nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * B * Hq * L + \
            2 * (q.numel() + 2 * k.numel())
        bwd_bound = bound(nbytes, 5 * 2 * pairs * hd, TC_BF16_FLOPS_PER_S)
        log(f"phase E(a) flash {tag} (B {B}, Hq {Hq}, Hkv {Hkv}, L {L}, S {S}, "
            f"hd {hd}, {sh['kw']}): relerr "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (limit {TRAIN_GRAD_TOL:.0e}), LSE {lse_err:.3e} (limit "
            f"{LSE_TOL:.0e}); fwd+bwd ms: kernel {t['kernel_fwd_bwd_ms']:.3f}, "
            f"plain {t['plain_fwd_bwd_ms']:.3f}, SDPA "
            f"{'n/a' if sdpa is None else f'{sdpa:.3f}'}; bwd ms: "
            f"{t['kernel_bwd_ms']:.3f} (plain {t['plain_bwd_ms']:.3f}, bound "
            f"{bwd_bound['bound_ms']:.3f} by {bwd_bound['bound_by']})")
        if max(errs.values()) > TRAIN_GRAD_TOL or lse_err > LSE_TOL or \
                not finite:
            raise SystemExit(f"phase E(a) flash {tag}: gradients or LSE off")
        out[tag] = dict(max_relerr=max(errs.values()), lse_relerr=lse_err,
                        sdpa_fwd_bwd_ms=sdpa, bwd_bound_ms=bwd_bound[
                            "bound_ms"], bwd_bound_by=bwd_bound["bound_by"],
                        **errs, **t)
        del q, k, v, dout, leaves
        gc.collect()
        torch.cuda.empty_cache()
    return out


def check_rg_lru_grads(dev) -> dict:
    """RGLRUFn (the kernel forward, its reversed kernel call backward)
    against autograd through the plain loop, at RecurrentGemma's [4,
    3,072, 4,096], with slow channels."""
    from repro_torch.kernels import rg_lru as rl
    sh = RGLRU_FULL
    a, b = rglru_inputs(dev, sh["B"], sh["L"], sh["W"], seed=72, slow=True)
    dh = torch.randn(a.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(73))
    leaves = [x.detach().requires_grad_(True) for x in (a, b)]
    got = torch.autograd.grad(rl.RGLRUFn.apply(*leaves), leaves, dh)
    want = torch.autograd.grad(rl.rg_lru_plain(*leaves), leaves, dh)
    errs = {"da": relerr(got[0], want[0]), "db": relerr(got[1], want[1])}
    h = rl.RGLRUFn.apply(*leaves)
    bwd_ms = event_ms(lambda: torch.autograd.grad(h, leaves, dh,
                                                  retain_graph=True))
    hp = rl.rg_lru_plain(*leaves)
    plain_bwd_ms = event_ms(lambda: torch.autograd.grad(hp, leaves, dh,
                                                        retain_graph=True),
                            repeats=1)
    # a, h, dh read, da, db written, float32
    bwd_bound = bound(5 * 4 * a.numel(), 4 * a.numel())
    log(f"phase E(a) rg_lru grads [4, 3072, 4096]: relerr da {errs['da']:.3e}, "
        f"db {errs['db']:.3e} (limit {RGLRU_TOL:.0e}); bwd {bwd_ms:.3f} ms "
        f"(plain autograd {plain_bwd_ms:.3f}, bound {bwd_bound['bound_ms']:.3f} "
        f"by {bwd_bound['bound_by']})")
    if max(errs.values()) > RGLRU_TOL:
        raise SystemExit("phase E(a) rg_lru: gradients off")
    return dict(max_relerr=max(errs.values()), bwd_ms=bwd_ms,
                plain_bwd_ms=plain_bwd_ms, bwd_bound_ms=bwd_bound["bound_ms"],
                bwd_bound_by=bwd_bound["bound_by"], **errs)


def check_gmm_grads(dev) -> dict:
    """GroupedMatmulFn (two more grouped matmuls backward) against autograd
    through the plain version at Qwen3-30B-A3B's prefill shapes (128
    experts, M = 960; the gate / up product and the down product)."""
    from repro_torch.kernels import grouped_matmul as gm
    out = {}
    for key, G, M, K, N in GMM_PATH[:2]:
        x, w = gmm_inputs(dev, G, M, K, N, seed=74)
        dy = torch.randn(G, M, N, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(75)
                         ).to(torch.bfloat16)
        leaves = [t.detach().requires_grad_(True) for t in (x, w)]
        got = torch.autograd.grad(gm.GroupedMatmulFn.apply(*leaves), leaves,
                                  dy)
        want = torch.autograd.grad(gm.grouped_matmul_plain(*leaves), leaves,
                                   dy)
        errs = {"dx": row_relerr(got[0], want[0]),
                "dw": row_relerr(got[1], want[1])}
        y = gm.GroupedMatmulFn.apply(*leaves)
        bwd_ms = event_ms(lambda: torch.autograd.grad(y, leaves, dy,
                                                      retain_graph=True))
        yp = gm.grouped_matmul_plain(*leaves)
        plain_bwd_ms = event_ms(lambda: torch.autograd.grad(
            yp, leaves, dy, retain_graph=True))
        lib = event_ms(lambda: (torch.bmm(dy, w.transpose(1, 2)),
                                torch.bmm(x.transpose(1, 2), dy)))
        nbytes = 2 * (x.numel() + w.numel() + dy.numel()) * 2
        bwd_bound = bound(nbytes, 2 * 2 * G * M * K * N, TC_BF16_FLOPS_PER_S)
        log(f"phase E(a) grouped matmul grads {key} [{G}, {M}, {K}] x [{G}, "
            f"{K}, {N}]: row relerr dx {errs['dx']:.3e}, dw {errs['dw']:.3e} "
            f"(limit {GMM_TOL:.0e}); bwd {bwd_ms:.3f} ms (plain autograd "
            f"{plain_bwd_ms:.3f}, two torch.bmm {lib:.3f}, bound "
            f"{bwd_bound['bound_ms']:.3f} by {bwd_bound['bound_by']})")
        if max(errs.values()) > GMM_TOL:
            raise SystemExit(f"phase E(a) grouped matmul {key}: gradients off")
        out[key] = dict(max_relerr=max(errs.values()), bwd_ms=bwd_ms,
                        plain_bwd_ms=plain_bwd_ms, bmm_bwd_ms=lib,
                        bwd_bound_ms=bwd_bound["bound_ms"],
                        bwd_bound_by=bwd_bound["bound_by"], **errs)
    return out


def check_train_kernels(dev) -> dict:
    """Phase E(a)."""
    return dict(flash=check_flash_grads(dev), rg_lru=check_rg_lru_grads(dev),
                grouped_matmul=check_gmm_grads(dev))


def lm_counts() -> dict:
    fa, da, rl, gm = lm_kernel_modules()
    return dict(flash=fa.launches, decode=da.launches, rg_lru=rl.launches,
                gmm=gm.launches)


def zero_lm_counts() -> None:
    for m in lm_kernel_modules():
        m.launches = 0


def check_train_small(dev, arch) -> dict:
    """Phase E(b): ``reduced(head_dim=64)`` of ``arch`` (two micro-batches
    a step). One micro-batch's loss and gradients through the kernels
    against the plain versions (the plain run held to the kernel run's
    experts, as phase 15 holds it), with the launches of the forward and of
    the backward (which recomputes each checkpointed layer); then
    ``TRAIN_SMALL['steps']`` steps of ``make_train_step`` on fresh batches,
    after which the loss of a batch they did not see (step 1,000's) must
    be lower than before them."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step, opt_init
    from repro_torch.models import build_model
    from repro_torch.models import layers as ly
    from repro_torch.optim import AdamWConfig
    cfg = get_config(arch).reduced(head_dim=64, train_microbatches=2)
    model = build_model(cfg)
    params = model.trainable(model.init(0, dev))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SMALL["seq"],
                                  global_batch=TRAIN_SMALL["global_batch"],
                                  seed=0))
    b0 = data.device_batch(0, dev)
    half = {k: v[: TRAIN_SMALL["global_batch"] // 2] for k, v in b0.items()}
    named = dict(params.named_parameters())
    route = ly.moe_route
    picks = []

    def run(forced=None):
        def recorded(p, x, c):
            gates, idx = route(p, x, c)
            if forced is not None:
                idx = forced[len(picks)]
                gates = torch.softmax((x.float() @ p.router).gather(-1, idx),
                                      dim=-1)
            picks.append(idx)
            return gates, idx

        ly.moe_route = recorded
        try:
            zero_lm_counts()
            loss = model.loss(params, half["tokens"], half["labels"])
            torch.cuda.synchronize()
            fwd = lm_counts()
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True)
            torch.cuda.synchronize()
            bwd = {k: v - fwd[k] for k, v in lm_counts().items()}
        finally:
            ly.moe_route = route
        return loss.detach(), grads, fwd, bwd

    loss_k, grads_k, fwd, bwd = run()
    kernel_picks = list(picks)
    picks.clear()
    with plain_versions():
        loss_p, grads_p, _, _ = run(kernel_picks)
    errs = {n: relerr(a, b) for n, a, b in zip(named, grads_k, grads_p)
            if a is not None}
    worst = max(errs, key=errs.get)
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k
                 if g is not None)
    del grads_k, grads_p
    step = make_train_step(cfg, AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=TRAIN_SMALL["steps"]),
        device=dev)
    opt = opt_init(params)
    held = data.device_batch(1000, dev)

    def held_loss():
        with torch.no_grad():
            return float(model.loss(params, held["tokens"], held["labels"]))

    before = held_loss()
    losses = []
    zero_lm_counts()
    for s in range(TRAIN_SMALL["steps"]):
        params, opt, m = step(params, opt, data.device_batch(s, dev))
        losses.append(float(m["loss"]))
    step_counts = lm_counts()
    after = held_loss()
    log(f"phase E(b) {arch} reduced(head_dim=64): loss kernels "
        f"{float(loss_k):.5f} plain {float(loss_p):.5f}; gradients relerr "
        f"worst {errs[worst]:.3e} ({worst}; limit {TRAIN_MODEL_TOL:.0e}), "
        f"finite {finite}; launches of one micro-batch: forward {fwd}, "
        f"backward {bwd}; {TRAIN_SMALL['steps']} steps' losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f", launches {step_counts}; held-out loss {before:.4f} before, "
        f"{after:.4f} after")
    if errs[worst] > TRAIN_MODEL_TOL or not finite or not after < before or \
            abs(float(loss_k) - float(loss_p)) > TRAIN_MODEL_TOL * float(loss_p):
        raise SystemExit(f"phase E(b) {arch}: gradients or losses off")
    return dict(loss_kernels=float(loss_k), loss_plain=float(loss_p),
                worst_grad_relerr=errs[worst], worst_leaf=worst,
                fwd_launches=fwd, bwd_launches=bwd, losses=losses,
                held_loss_before=before, held_loss_after=after,
                step_launches=step_counts, layers=cfg.n_layers)


def expect_launches(tag, got: dict, want: dict) -> None:
    for k, v in want.items():
        if got[k] != v:
            raise SystemExit(f"{tag}: {got[k]} {k} launches, the design "
                             f"says {v}")


def check_olmo_train(dev, smi) -> dict:
    """Phase E(c): ``repro_torch.launch.train.train`` on OLMo-1B at full
    width and depth (``OLMO_TRAIN``), launch counts zeroed before and read
    after, peak device memory; then one more step profiled: device time
    by kernel group, and the backward's attention (torch ops) on CUDA
    events."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as tr
    from repro_torch.models import count_params
    cfg = get_config(OLMO_TRAIN["arch"])
    n = count_params(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_lm_counts()
    t0 = time.perf_counter()
    res = tr.train(**OLMO_TRAIN, device=dev, log_every=1)
    wall = time.perf_counter() - t0
    counts = lm_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [h["loss"] for h in res["history"]]
    dts = [h["dt_s"] for h in res["history"]]
    step_s = statistics.median(dts[1:])
    tokens = OLMO_TRAIN["global_batch"] * OLMO_TRAIN["seq"]
    flops = 6.0 * n * tokens
    per_step = OLMO_TRAIN["micro_batches"] * cfg.n_layers * 2
    out = dict(params=n, losses=losses, step_s=dts, median_step_s=step_s,
               tokens_per_s=tokens / step_s, model_flops_per_step=flops,
               mfu_6nd=flops / step_s / TC_BF16_FLOPS_PER_S,
               bound_step_s=flops / TC_BF16_FLOPS_PER_S, peak_gib=peak,
               launches=counts, wall_s=wall)
    log(f"phase E(c) olmo-1b train, full width and depth ({n:,} parameters), "
        f"{OLMO_TRAIN['steps']} steps of {OLMO_TRAIN['global_batch']} x "
        f"{OLMO_TRAIN['seq']} tokens in {OLMO_TRAIN['micro_batches']} "
        f"micro-batches ({smi}): losses " + " ".join(f"{x:.4f}" for x in losses)
        + "; step s " + " ".join(f"{x:.3f}" for x in dts)
        + f"; median step {step_s:.3f} s, {tokens / step_s:,.0f} tokens/s, "
        f"6ND {flops:.3e} flops a step = {out['mfu_6nd']:.1%} of 989 TFLOP/s "
        f"(bound {flops / TC_BF16_FLOPS_PER_S:.3f} s); peak "
        f"{peak:.2f} GiB; launches {counts}; wall {wall:.1f} s")
    expect_launches("phase E(c)", counts,
                    dict(flash=OLMO_TRAIN["steps"] * per_step, rg_lru=0,
                         gmm=0, decode=0))
    if not (losses[-1] < losses[0]) or not all(map(math.isfinite, losses)):
        raise SystemExit("phase E(c): the loss did not fall")
    out["profile"] = profile_train_step(dev, cfg, res["params"])
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_train_step(dev, cfg, params) -> dict:
    """One more OLMo-1B step (two micro-batches and the update) under the
    profiler: device time by kernel group, with the backward's attention
    (torch ops) and the optimizer measured on CUDA events around them; the
    wall of the same step without the profiler first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model
    from repro_torch.models import chunked_attention as ca
    from repro_torch.optim import AdamWConfig
    model = build_model(cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=OLMO_TRAIN["seq"],
                                  global_batch=OLMO_TRAIN["global_batch"],
                                  seed=0))
    batch = data.device_batch(OLMO_TRAIN["steps"], dev)
    opt = st.opt_init(params)
    mb = OLMO_TRAIN["global_batch"] // OLMO_TRAIN["micro_batches"]
    spans = {"attention backward (torch ops)": [], "optimizer": [],
             "forward + loss": [], "backward": []}

    def timed(name, fn, *a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        r = fn(*a, **k)
        e1.record()
        spans[name].append((e0, e1))
        return r

    bwd = ca.attention_bwd
    ca.attention_bwd = lambda *a, **k: timed(
        "attention backward (torch ops)", bwd, *a, **k)
    named = dict(params.named_parameters())

    def one_step():
        nonlocal opt
        grads = None
        for i in range(OLMO_TRAIN["micro_batches"]):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss = timed("forward + loss", model.loss, params, part["tokens"],
                         part["labels"])
            g = timed("backward", torch.autograd.grad, loss,
                      list(named.values()))
            if grads is None:
                grads = {n: torch.zeros_like(p, dtype=torch.float32)
                         for n, p in named.items()}
            for (n, _), x in zip(named.items(), g):
                grads[n].add_(x.float() / OLMO_TRAIN["micro_batches"])
            del g, loss
        opt, _ = timed("optimizer", st.apply_update, cfg, params, opt, grads,
                       AdamWConfig())

    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for v in spans.values():
            v.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one_step()
            torch.cuda.synchronize()
    finally:
        ca.attention_bwd = bwd
    span_ms = {k: sum(a.elapsed_time(b) for a, b in v)
               for k, v in spans.items()}
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and self_device_ms(e) > 0]
    tot = sum(self_device_ms(e) for e in ev)
    groups = {}
    for e in ev:
        grp = kernel_group(e.key)
        groups[grp] = groups.get(grp, 0.0) + self_device_ms(e)
    log(f"phase E(c) profile of one olmo-1b step: device {tot:.1f} ms, wall "
        f"{wall * 1e3:.1f} ms without the profiler; device idle share "
        f"{1 - tot / (wall * 1e3):.3f}; spans (CUDA events, ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in span_ms.items()))
    for grp, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {ms:9.2f} ms {ms / tot:6.1%}  {grp}")
    ev.sort(key=lambda e: -self_device_ms(e))
    for e in ev[:10]:
        log(f"    {self_device_ms(e):9.2f} ms {self_device_ms(e) / tot:6.1%} "
            f"x{e.count:<5d} {e.key[:90]}")
    del opt
    return dict(device_ms=tot, wall_ms=wall * 1e3, idle=1 - tot / (wall * 1e3),
                spans_ms=span_ms, groups_ms=groups)


def check_resume(dev) -> dict:
    """Phase E(d): the small OLMo preset on the card, uninterrupted and
    crashed at step 5 then resumed from the step-4 checkpoint: the final
    parameters bit for bit equal."""
    import tempfile
    from repro_torch.launch.train import train
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(RESUME_RUN, device=dev, log_every=100)
        ref = train(ckpt_dir=f"{tmp}/a", **kw)
        try:
            train(ckpt_dir=f"{tmp}/b", fail_at_step=5, **kw)
            raise SystemExit("phase E(d): the injected failure did not fire")
        except RuntimeError:
            pass
        out = train(ckpt_dir=f"{tmp}/b", resume=True, **kw)
    a = dict(ref["params"].named_parameters())
    b = dict(out["params"].named_parameters())
    differ = [n for n in a if not torch.equal(a[n], b[n])]
    log(f"phase E(d) crash at step 5 and resume ({RESUME_RUN}): "
        f"{len(a) - len(differ)} of {len(a)} parameters bit-identical to the "
        f"uninterrupted run; losses {[h['loss'] for h in ref['history']]}")
    if differ:
        raise SystemExit(f"phase E(d): resumed parameters differ: {differ[:4]}")
    return dict(params=len(a), identical=True)


def check_training(dev, smi) -> dict:
    """Phase E: (a) kernel gradients, (b) reduced RecurrentGemma and
    Qwen3-MoE steps, (c) OLMo-1B at full width, (d) crash and resume."""
    t = [time.perf_counter()]
    out = dict(kernels=check_train_kernels(dev))
    t.append(time.perf_counter())
    out["small"] = {a: check_train_small(dev, a)
                    for a in ("recurrentgemma-9b", "qwen3-moe-30b-a3b")}
    for a, r in out["small"].items():
        # per micro-batch: a checkpointed rec layer scans forward, again in
        # its recompute and once reversed; a moe layer runs 3 grouped
        # matmuls forward, 3 in its recompute and 6 backward; an attention
        # layer's flash kernel runs forward and in its recompute only
        from repro_torch.configs import get_config
        from repro_torch.models.stacks import layer_kinds
        kinds = layer_kinds(get_config(a).reduced(head_dim=64))
        n_rec = sum(k == "rec" for k in kinds)
        n_moe = sum(k == "moe" for k in kinds)
        n_att = len(kinds) - n_rec
        expect_launches(f"phase E(b) {a} forward", r["fwd_launches"],
                        dict(flash=n_att, rg_lru=n_rec, gmm=3 * n_moe))
        expect_launches(f"phase E(b) {a} backward", r["bwd_launches"],
                        dict(flash=n_att, rg_lru=2 * n_rec, gmm=9 * n_moe))
    t.append(time.perf_counter())
    out["olmo"] = check_olmo_train(dev, smi)
    t.append(time.perf_counter())
    out["resume"] = check_resume(dev)
    t.append(time.perf_counter())
    out["seconds"] = dict(zip("abcd", np.diff(t).tolist()))
    log(f"phase E ({smi}): " + ", ".join(f"({k}) {v:.1f} s"
                                         for k, v in out["seconds"].items()))
    return out


# -- phase F: the expert-parallel MoE on ranks of the card, the dry run ------

EP_LAYERS = 4           # of Qwen3-30B-A3B's 48, as phase 15
EP_STRIDE = 16          # every 16th token of each MoE layer's output is kept
# phase F(b) limits: the 2-rank run against the 1-rank run, both through the
# kernels, the 2-rank run held to the 1-rank run's experts; the same metrics
# as phase 15 (largest error over the largest value, RMS over RMS), on the
# last token's logits and on each MoE layer's output. Sound runs read 1.56e-2
# to 2.71e-2 (max) and 1.34e-2 to 2.02e-2 (RMS); the reduction over "model"
# dropped reads 1.51 / 1.24, the capacity taken from the rank's 64 experts
# 1.59 / 0.98 (PERF.md, phase F)
EP_TOL = 4e-2
EP_RMS_TOL = 3.5e-2


def ep_prefill(dev, mesh, forced, *, B, L, init_seed=1, prompt_seed=7,
               cfg=None):
    """A full-width, ``EP_LAYERS``-layer Qwen3-30B-A3B prefill of a B x L
    prompt. With ``mesh`` (a DeviceMesh with a "model" axis) each MoE
    layer's expert weights are DTensors holding this rank's block of the
    experts, so ``moe_apply`` takes its expert-parallel branch. With
    ``forced`` (the expert ids of another run, one per MoE layer) the
    router takes those experts, with gates from its own logits, and counts
    the tokens whose own top-8 set differs. Runs twice: the first run's
    grouped-matmul launches are counted, the second is timed. Returns the
    last token's logits, every ``EP_STRIDE``-th token of each MoE layer's
    output, the expert ids, the flips, the launches, the timed run's
    seconds and the peak memory (GiB)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.models import build_model
    from repro_torch.models import layers as ly
    cfg = cfg or dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                                     n_layers=EP_LAYERS)
    model = build_model(cfg)
    params = model.init(init_seed, dev)
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Replicate, Shard
        n_model = mesh.size(mesh.mesh_dim_names.index("model"))
        r = mesh.get_local_rank("model")
        pl = [Shard(0) if n == "model" else Replicate()
              for n in mesh.mesh_dim_names]
        for layer in params.layers:
            for n in ("w_gate", "w_up", "w_down"):
                full = getattr(layer.moe, n).detach()
                local = full.chunk(n_model, 0)[r].clone()
                setattr(layer.moe, n, torch.nn.Parameter(
                    DTensor.from_local(local, mesh, pl, run_check=False),
                    requires_grad=False))
                del full
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    rng = np.random.default_rng(prompt_seed)
    prompt = torch.tensor(rng.integers(2, cfg.vocab, (B, L)), device=dev)
    route, apply = ly.moe_route, ly.moe_apply
    picks, outs, flips = [], [], []

    def recorded(p, x, c):
        gates, idx = route(p, x, c)
        if forced is not None:
            own = idx.sort(-1).values
            idx = forced[len(picks)].to(x.device)
            flips.append(int((own != idx.sort(-1).values).any(-1).sum()))
            gates = torch.softmax((x.float() @ p.router).gather(-1, idx),
                                  dim=-1)
        picks.append(idx)
        return gates, idx

    def sampled(p, x, c):
        y = apply(p, x, c)
        outs.append(y[:, ::EP_STRIDE].float().cpu())
        return y

    ly.moe_route, ly.moe_apply = recorded, sampled
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    try:
        sync()
        gm.launches = 0
        logits, _ = model.prefill(params, prompt, model.init_cache(B, L, dev))
        sync()
        out = dict(launches=gm.launches, logits=logits[:, -1].float().cpu(),
                   outs=list(outs), picks=[p.cpu() for p in picks],
                   flips=list(flips))
        picks.clear()
        outs.clear()
        flips.clear()
        if mesh is not None:
            import torch.distributed as dist
            dist.barrier()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model.prefill(params, prompt, model.init_cache(B, L, dev))
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                           if dev.type == "cuda" else float("nan"))
    finally:
        ly.moe_route, ly.moe_apply = route, apply
    return out


def ep_rank(mesh_shape, forced, B, L, cfg=None, device_type="cuda"):
    """Phase F on one rank of a spawned group: :func:`ep_prefill` on a
    ``mesh_shape`` mesh; rank 0 returns its result with every rank's
    launches, seconds and peak memory."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    mesh = make_mesh(mesh_shape, ("data", "model"), device_type)
    out = ep_prefill(dev, mesh, forced, B=B, L=L, cfg=cfg)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, dict(launches=out["launches"],
                                       prefill_s=out["prefill_s"],
                                       peak_gib=out["peak_gib"]))
    out["ranks"] = every
    return out


def ep_errs(got, want) -> dict:
    """The largest error over the largest value and the RMS error over the
    RMS, of the logits and of the MoE outputs (worst layer)."""
    def two(g, w):
        g, w = g.float(), w.float()
        return (float((g - w).abs().max() / w.abs().max()),
                float((g - w).square().mean().sqrt() / w.square().mean().sqrt()))
    lg = two(got["logits"], want["logits"])
    lay = [two(g, w) for g, w in zip(got["outs"], want["outs"])]
    return dict(logits_max=lg[0], logits_rms=lg[1],
                moe_max=max(e[0] for e in lay), moe_rms=max(e[1] for e in lay),
                finite=bool(torch.isfinite(got["logits"]).all()))


def ep_drops(picks, n_experts: int, capacity: int) -> list[int]:
    """Assignments past an expert's capacity in a row, per MoE layer: the
    ones the dispatch drops."""
    out = []
    for idx in picks:
        B = idx.shape[0]
        counts = torch.zeros(B, n_experts, dtype=torch.int64)
        counts.scatter_add_(1, idx.reshape(B, -1),
                            torch.ones_like(idx.reshape(B, -1)))
        out.append(int((counts - capacity).clamp(min=0).sum()))
    return out


DRYRUN_CELL = ("olmo-1b", "train_4k")


def start_dry_run():
    """Phase F(e)'s dry-run cell in a process of its own on the host (a
    fake process group, no card): returns the process, its stderr file
    and its output directory."""
    dry = ROOT / "chiprun_out" / "dryrun_torch"
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         DRYRUN_CELL[0], "--shape", DRYRUN_CELL[1], "--out-dir", str(dry)],
        stdout=subprocess.DEVNULL, stderr=err, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return proc, err, dry


def stop_dry_run(run) -> None:
    proc, _, _ = run
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def finish_dry_run(run) -> dict:
    """Waits for :func:`start_dry_run`'s process; returns its cell's JSON.
    Raises ``SystemExit`` if it failed or took over 600 s."""
    proc, err, dry = run
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        stop_dry_run(run)
        raise SystemExit("phase F(e): the dry run took over 600 s")
    if proc.returncode != 0:
        err.seek(0)
        raise SystemExit(f"phase F(e): the dry run failed:\n"
                         f"{err.read()[-3000:]}")
    return json.loads((dry / f"{DRYRUN_CELL[0]}__{DRYRUN_CELL[1]}__single"
                       ".json").read_text())


def check_expert_parallel(dev, smi, dry_run=None) -> dict:
    """Phase F: (a) one NCCL rank on a (1, 1) mesh against the one-device
    run through the plain versions held to its experts (phase 15's
    limits); (b) two gloo ranks sharing the card on a (1, 2) mesh, 64
    experts a rank, held to (a)'s experts, against (a); (c) each rank's
    grouped-matmul launches: 3 a layer; (d) prefill seconds, the all-reduce
    bytes a layer, peak memory a rank; (e) the dry run's olmo-1b x train_4k
    cell in a process of its own on the host: ``dry_run`` when the caller
    started it (:func:`start_dry_run`, beside phase E), else after (d).
    Not beside (a)-(d): the gloo ranks' all-reduce runs through the host."""
    from repro_torch.distributed import spawn
    B, L = SERVE_ARGS["batch"], SERVE_ARGS["prompt_len"]
    try:
        t = [time.perf_counter()]
        a = spawn.run_ranks(ep_rank, ((1, 1), None, B, L), 1, "nccl",
                            "cuda", timeout=600)
        t.append(time.perf_counter())
        with plain_versions():
            one = ep_prefill(dev, None, a["picks"], B=B, L=L)
        gc.collect()
        torch.cuda.empty_cache()
        ea = ep_errs(a, one)
        drops = ep_drops(a["picks"], 128, math.ceil(L * 8 / 128 * 1.25))
        log(f"phase F(a) qwen3-moe-30b-a3b {EP_LAYERS} layers, B={B} "
            f"L={L}, one NCCL rank (1, 1) against one device through the "
            f"plain versions (held to its experts, flips {one['flips']}; "
            f"assignments past capacity per layer {drops}): "
            f"{json.dumps(ea)}")
        if ea["logits_max"] > QWEN_TOL or \
                ea["logits_rms"] > QWEN_RMS_TOL or not ea["finite"]:
            raise SystemExit("phase F(a): the expert-parallel run and the "
                             "one-device run disagree")
        t.append(time.perf_counter())
        b = spawn.run_ranks(ep_rank, ((1, 2), a["picks"], B, L), 2, "gloo",
                            "cuda", timeout=600)
        t.append(time.perf_counter())
        eb = ep_errs(b, a)
        log(f"phase F(b) two gloo ranks sharing the card (1, 2), 64 "
            f"experts a rank, held to (a)'s experts (flips {b['flips']}), "
            f"against (a): {json.dumps(eb)} (limits {EP_TOL}, "
            f"{EP_RMS_TOL})")
        if max(eb["logits_max"], eb["moe_max"]) > EP_TOL or \
                max(eb["logits_rms"], eb["moe_rms"]) > EP_RMS_TOL or \
                not eb["finite"]:
            raise SystemExit("phase F(b): the 2-rank and 1-rank runs "
                             "disagree")
        want = 3 * EP_LAYERS
        launches = {"1": [r["launches"] for r in a["ranks"]],
                    "2": [r["launches"] for r in b["ranks"]]}
        log(f"phase F(c) grouped-matmul launches of a prefill per rank: "
            f"{launches} (want {want} on every rank)")
        if any(n != want for v in launches.values() for n in v):
            raise SystemExit(f"phase F(c): launches {launches}, want "
                             f"{want}")
        d_model = 2048
        reduce_bytes = B * L * d_model * 2
        timing = dict(prefill_s={k: [r["prefill_s"] for r in x["ranks"]]
                                 for k, x in (("1", a), ("2", b))},
                      peak_gib={k: [r["peak_gib"] for r in x["ranks"]]
                                for k, x in (("1", a), ("2", b))},
                      allreduce_bytes_per_layer=reduce_bytes,
                      one_device_plain_prefill_s=one["prefill_s"])
        log(f"phase F(d) ({smi}): {json.dumps(timing)}")
    except BaseException:
        if dry_run is not None:
            stop_dry_run(dry_run)
        raise
    t.append(time.perf_counter())
    cell = finish_dry_run(dry_run or start_dry_run())
    log(f"phase F(e) dry run olmo-1b x train_4k on the 16 x 16 fake mesh "
        f"(torch {torch.__version__}): cost {json.dumps(cell['cost'])}, "
        f"roofline at the H100's spec-sheet rates "
        f"{json.dumps(cell['roofline'])}, useful FLOPs ratio "
        f"{cell['useful_flops_ratio']:.4f}, {cell['run_s']} s")
    t.append(time.perf_counter())
    secs = dict(zip(("a, 1 rank", "a, one device", "b", "c-d",
                     "e" if dry_run is None else "e, past E and d"),
                    np.diff(t).tolist()))
    log(f"phase F: " + ", ".join(f"({k}) {v:.1f} s" for k, v in secs.items()))
    return dict(a=ea, b=eb, launches=launches, timing=timing,
                dryrun=dict(roofline=cell["roofline"], cost=cell["cost"]),
                seconds=secs)


def sim_diff(a, b):
    """The first field in which two ``SimResult``s differ (value, shape or
    dtype), telemetry counters included; None when they are equal."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "telemetry":
            if (x is None) != (y is None):
                return f.name
            if x is None:
                continue
            for g in dataclasses.fields(x):
                u, v = getattr(x, g.name), getattr(y, g.name)
                if g.name == "lat_edges":
                    if u != v:
                        return "telemetry.lat_edges"
                elif u.dtype != v.dtype or u.shape != v.shape or \
                        not np.array_equal(u, v):
                    return f"telemetry.{g.name}"
        elif x.dtype != y.dtype or x.shape != y.shape or \
                not np.array_equal(x, y):
            return f.name
    return None


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
                                  flow_fcts, round_robin, simulate, vlb)
    from repro_torch.core.fabric import _build_caps, stack_tables
    from repro_torch.kernels import _build, admission as adm
    from repro_torch.kernels import time_flow_lookup as tfl

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()

    # -- 1. build ----------------------------------------------------------
    phase_start("1")
    t0 = time.perf_counter()
    _build.build(KERNELS)
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s  "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    for name, out in _build.build_logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"nvidia-smi: {smi}")
    log(f"device: {kind}, count {torch.cuda.device_count()}")
    if sys.argv[1:] == ["--phase", "E"]:
        # the training phase alone (a quicker check of the training path);
        # prints no result line
        check_training(dev, smi)
        log(f"chip_smoke --phase E: {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--phase", "F"]:
        # the expert-parallel phase alone; prints no result line
        check_expert_parallel(dev, smi)
        log(f"chip_smoke --phase F: {time.perf_counter() - t_start:.1f} s")
        return 0

    # -- 2. kernels vs plain versions ----------------------------------------
    phase_start("2")
    sched = round_robin(N_TORS, 1)
    routing = vlb(sched, kpaths=4)
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    table = stack_tables(i32(routing.inj_next), i32(routing.inj_dep),
                         i32(routing.tf_next), i32(routing.tf_dep))
    # the TPU's form: the two [2, Tr, N, D, K] stacks
    stk_n = table[..., 0, :].contiguous()
    stk_d = table[..., 1, :].contiguous()
    caps = _build_caps(i32(sched.conn), FabricConfig(), N_TORS)
    log("phase 2 kernels vs plain versions")
    adm_lib = _build.load("admission", adm._SIGNATURES)
    if adm_lib.adm_smem_keys() != adm.SMEM_KEYS:
        raise SystemExit("admission: the kernel's shared-memory key limit "
                         f"{adm_lib.adm_smem_keys()} is not the wrapper's "
                         f"{adm.SMEM_KEYS}")
    tfl_mis, tfl_err = check_lookup(dev, table)
    adm_mis, adm_err = check_admission(dev, caps[0].cpu().numpy())
    if tfl_mis or adm_mis:
        raise SystemExit(f"kernel mismatches: lookup {tfl_mis}, "
                         f"admission {adm_mis}")

    # -- 3. timing at the main path's shapes -----------------------------------
    phase_start("3")
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
    # the port's form: the packed table, the hash of slice 213 formed in
    # the kernel, masks of the given densities; the TPU's form through the
    # packed table
    masks = {d: torch.tensor(rng.random(P) < d, device=dev)
             for d in (1.0, 0.1, 0.01)}

    # per-node slice offsets from [-2 Tr, 2 Tr], as a skewed fabric has
    Tr = table.shape[1]
    phase_off = t32(rng.integers(-2 * Tr, 2 * Tr + 1, N_TORS))

    def new_form(d, P=P, po=None, hp=None, hb=None):
        return lambda: tfl.time_flow_lookup(table, None, 5, sel[:P],
                                            node[:P], dstv[:P], 213,
                                            mask=masks[d][:P], phase_off=po,
                                            hash_period=hp, hash_base=hb)
    timings["tfl_packed_ms"] = graph_ms(lambda: tfl.time_flow_lookup(
        table, None, 5, sel, node, dstv, hv))
    # with and without offsets in turns: without, with, with, without
    for d, tag in ((1.0, "full"), (0.1, "10"), (0.01, "1")):
        runs = [graph_ms(new_form(d, po=po))
                for po in (None, phase_off, phase_off, None)]
        timings[f"tfl_new_{tag}_ms"] = statistics.fmean(runs[::3])
        timings[f"tfl_new_{tag}_off_ms"] = statistics.fmean(runs[1:3])
        log(f"phase 3 lookup at mask {d}, without / with / with / without "
            "offsets: "
            + " / ".join(f"{r * 1e3:.3f}" for r in runs) + " us")
    # the per-scenario hash index of an 8-scenario sweep (simulate_fleet),
    # in turns with the same calls without it: without, with, with, without
    for d, tag in ((1.0, "full"), (0.1, "10"), (0.01, "1")):
        runs = [graph_ms(new_form(d, hp=hp))
                for hp in (None, P // 8, P // 8, None)]
        timings[f"tfl_fleet_{tag}_without_ms"] = statistics.fmean(runs[::3])
        timings[f"tfl_fleet_{tag}_ms"] = statistics.fmean(runs[1:3])
        log(f"phase 3 lookup at mask {d}, without / with / with / without "
            "the per-scenario hash index: "
            + " / ".join(f"{r * 1e3:.3f}" for r in runs) + " us")
    # a sharded run's global hash index (the last of 5 ranks' base), in
    # turns with the same calls without it
    for d, tag in ((1.0, "full"), (0.1, "10"), (0.01, "1")):
        runs = [graph_ms(new_form(d, hb=hb))
                for hb in (None, 4 * P // 5, 4 * P // 5, None)]
        timings[f"tfl_base_{tag}_without_ms"] = statistics.fmean(runs[::3])
        timings[f"tfl_base_{tag}_ms"] = statistics.fmean(runs[1:3])
        log(f"phase 3 lookup at mask {d}, without / with / with / without "
            "the global hash index: "
            + " / ".join(f"{r * 1e3:.3f}" for r in runs) + " us")
    timings["tfl_new_floor_ms"] = graph_ms(new_form(1.0, P=1))
    timings["tfl_new_off_floor_ms"] = graph_ms(new_form(1.0, P=1,
                                                        po=phase_off))
    # the version axis (phase 20's controlled path: offsets and a version a
    # node): V = 2 and 3, a version drawn per node, beside the same calls
    # on the unversioned table, in turns: without, V 2, V 3, V 3, V 2,
    # without
    vrng = np.random.default_rng(4)
    vtabs = {V: versioned_tables(table, V) for V in (2, 3)}
    vsels = {V: t32(vrng.integers(0, V, N_TORS)) for V in (2, 3)}

    def ver_form(d, V=None, P=P):
        tb = table if V is None else vtabs[V]
        vs = None if V is None else vsels[V]
        return lambda: tfl.time_flow_lookup(tb, None, 5, sel[:P], node[:P],
                                            dstv[:P], 213, mask=masks[d][:P],
                                            phase_off=phase_off, vsel=vs)
    for d, tag in ((1.0, "full"), (0.1, "10"), (0.01, "1")):
        runs = [graph_ms(ver_form(d, V)) for V in (None, 2, 3, 3, 2, None)]
        timings[f"tfl_ver_{tag}_without_ms"] = statistics.fmean(runs[::5])
        timings[f"tfl_ver2_{tag}_ms"] = statistics.fmean(runs[1::3])
        timings[f"tfl_ver3_{tag}_ms"] = statistics.fmean(runs[2:4])
        log(f"phase 3 lookup at mask {d} with offsets, without / V=2 / V=3 "
            "/ V=3 / V=2 / without versions: "
            + " / ".join(f"{r * 1e3:.3f}" for r in runs) + " us")
    timings["tfl_ver_floor_ms"] = graph_ms(ver_form(1.0, 3, P=1))
    timings["tfl_ver_plain_ms"] = graph_ms(
        lambda: tfl.time_flow_lookup_plain(vtabs[3], None, 5, sel, node,
                                           dstv, 213, masks[1.0], phase_off,
                                           vsels[3]))
    del vtabs
    timings["tfl_new_plain_ms"] = graph_ms(lambda: tfl.time_flow_lookup_plain(
        table, None, 5, sel, node, dstv, 213, masks[1.0]))
    timings["adm_floor_ms"] = graph_ms(lambda: adm.admission_admit(
        key[:1], size[:1], want[:1], cap, num_keys=NK))
    log("phase 3 timing (ms per call, median): "
        + " ".join(f"{k}={v:.5f}" for k, v in timings.items()))
    for tag, args, nk in (("11772 keys", (key, size, want, cap), NK),
                          ("108 keys", (rx_key, size, want, room), N_TORS),
                          ("one packet", (key[:1], size[:1], want[:1], cap),
                           NK)):
        per = device_breakdown(lambda: adm.admission_admit(*args,
                                                           num_keys=nk))
        log(f"  admission {tag}, device us per call by kernel (profiler): "
            + " ".join(f"{k}={v:.2f}" for k, v in per.items()))

    # -- 4. main path at 108 ToRs ----------------------------------------------
    phase_start("4")
    wl = main_workload()
    P = wl.num_packets
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
    phase_start("5")
    tables = FabricTables.build(sched, vlb(sched, kpaths=4))
    for name, fab in MAIN_CONFIGS:
        cfg = FabricConfig(**fab)
        t0 = time.perf_counter()
        a = simulate(tables, wl, cfg, CPU_SLICES, device="cuda")
        b = simulate(tables, wl, cfg, CPU_SLICES, device="cpu")
        bad = sim_diff(a, b)
        if bad is not None:
            raise SystemExit(f"{name}: CUDA and CPU differ in {bad}")
        log(f"phase 5 {name}: {CPU_SLICES} slices equal on CUDA and CPU "
            f"({time.perf_counter() - t0:.1f} s)")

    # -- 6. where the device time goes -----------------------------------------
    phase_start("6")
    # 16 steady-state slices (24-39, while hosts still inject) of the
    # default configuration: once timed on the host clock, once under the
    # profiler for device time by kernel
    from repro_torch.core import fabric as fabric_mod
    from repro_torch.core.fabric import _device_arrays, _make_step
    j = _device_arrays(tables, wl, dev)
    step = _make_step(j, FabricConfig(), per_packet_mp=True)

    bare_ms, wall_ms, ev, tot, kernels_per_slice = profile_window(
        step, j, wl.num_flows)
    tfl_ev = [e for e in ev if "tfl_kernel" in e.key]
    tfl_main_us = (sum(self_device_ms(e) for e in tfl_ev) * 1e3
                   / max(sum(e.count for e in tfl_ev), 1))
    # the lookups' mask densities, in one more run of slices 0-39 that
    # syncs at each lookup (outside the timed runs)
    densities = {"fused": [], "transit": []}
    real_lookup = fabric_mod.time_flow_lookup

    def recording_lookup(tn, td, tm, sel, *a, mask=None, **kw):
        site = "fused" if isinstance(sel, torch.Tensor) else "transit"
        densities[site].append(float(mask.float().mean()))
        return real_lookup(tn, td, tm, sel, *a, mask=mask, **kw)
    fabric_mod.time_flow_lookup = recording_lookup
    try:
        window_wall_ms(step, j, wl.num_flows)
    finally:
        fabric_mod.time_flow_lookup = real_lookup
    hops = FabricConfig().hops_per_slice
    main_density = dict(                    # slices 24-39 only
        fused=statistics.fmean(densities["fused"][24:]),
        transit=statistics.fmean(densities["transit"][24 * hops:]))
    log(f"phase 6 profile, default config, slices 24-39: device time "
        f"{tot / 16:.4f} ms per slice in {len(ev)} kernels, wall time "
        f"{wall_ms / 16:.4f} ms per slice in the same profiled run "
        f"(device idle share {1 - tot / wall_ms:.3f}); wall time "
        f"{bare_ms / 16:.4f} ms per slice in a run without the profiler; "
        f"{kernels_per_slice:.2f} kernels launched per slice; lookup "
        f"{tfl_main_us:.3f} us per call on the device; mean lookup mask "
        f"density: fused site {main_density['fused']:.5f}, transit site "
        f"{main_density['transit']:.5f}")
    for e in ev[:14]:
        log(f"  {self_device_ms(e) / 16:8.4f} ms/slice "
            f"{self_device_ms(e) / tot:6.1%} x{e.count // 16:<4d}/slice "
            f"{e.key[:100]}")

    # -- 7. LM kernels vs plain versions ------------------------------------------
    phase_start("7")
    log("phase 7 LM kernels vs plain versions (relative error, bf16 inputs)")
    (flash_err, flash_abs), (decode_err, decode_abs), (rg_err, rg_abs) = (
        check_flash(dev), check_decode(dev), check_rg_lru(dev))
    if flash_err > FLASH_TOL or decode_err > DECODE_TOL or rg_err > RGLRU_TOL:
        raise SystemExit(f"LM kernels disagree: flash {flash_err:.2e}, decode "
                         f"{decode_err:.2e}, rg_lru {rg_err:.2e}")

    # -- 8. LM kernel timing ------------------------------------------------------
    phase_start("8")
    lm_t, lm_bounds = time_lm_kernels(dev)

    # -- 9. serve RecurrentGemma-9B at full width and depth ------------------------
    phase_start("9")
    res, serve_counts, n_prefill, n_decode, peak, wall, _ = run_serve(
        dev, "recurrentgemma-9b")
    log(f"phase 9 serve recurrentgemma-9b full: {json.dumps(res)}; "
        f"{n_prefill} prefills ({res['prefill_s'] / n_prefill:.3f} s each), "
        f"{n_decode} decode steps ({1e3 * res['decode_s'] / n_decode:.2f} ms "
        f"each), wall {wall:.1f} s incl. init, peak {peak:.2f} GiB; "
        f"launches {json.dumps(serve_counts)}")
    want_counts = dict(flash=12 * n_prefill, decode=12 * n_decode,
                       rg_lru=26 * n_prefill, gmm=0)
    if serve_counts != want_counts or res["requests_done"] != \
            SERVE_ARGS["requests"] or res["decode_tokens"] <= 0:
        raise SystemExit(f"serve: launches {serve_counts} (want "
                         f"{want_counts}), result {res}")

    # -- 10. whole model, kernels vs plain versions --------------------------------
    phase_start("10")
    check_model_vs_plain(dev)

    # -- 11. where the serve path's time goes ----------------------------------
    phase_start("11")
    rg_prof = profile_serve(dev, "recurrentgemma-9b", 11)
    rg_group_ms = rg_prof["prefill"]["groups"].get("rg_lru", 0.0)
    log(f"phase 11 rg_lru group: {rg_group_ms:.3f} ms of device time a "
        f"prefill (26 calls), {rg_group_ms / rg_prof['prefill']['device_ms']:.2%}"
        " of the prefill")

    # -- 12. grouped matmul vs plain version ----------------------------------
    phase_start("12")
    log("phase 12 grouped matmul vs plain version (bf16, per output row)")
    gmm_err, gmm_abs = check_gmm(dev)
    if gmm_err > GMM_TOL:
        raise SystemExit(f"grouped_matmul disagrees: {gmm_err:.2e}")
    gmm32_err, gmm32_abs = check_gmm_f32(dev)
    if gmm32_err > GMM_F32_TOL:
        raise SystemExit(f"grouped_matmul f32 disagrees: {gmm32_err:.2e}")

    # -- 13. grouped matmul timing --------------------------------------------
    phase_start("13")
    gmm_t, gmm_bounds = time_gmm(dev)
    gmm_f32 = time_gmm_f32(dev)

    # -- 14. serve Qwen3-30B-A3B at full width and depth ----------------------
    phase_start("14")
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"phase 14 before loading qwen3-moe-30b-a3b: {free / 2 ** 30:.2f} of "
        f"{total / 2 ** 30:.2f} GiB free")
    qres, qwen_counts, q_prefill, q_decode, q_peak, q_wall, _ = run_serve(
        dev, "qwen3-moe-30b-a3b")
    log(f"phase 14 serve qwen3-moe-30b-a3b full: {json.dumps(qres)}; "
        f"{q_prefill} prefills ({qres['prefill_s'] / q_prefill:.3f} s each), "
        f"{q_decode} decode steps ({1e3 * qres['decode_s'] / q_decode:.2f} ms "
        f"each), wall {q_wall:.1f} s incl. init, peak {q_peak:.2f} GiB; "
        f"launches {json.dumps(qwen_counts)}")
    want_counts = dict(flash=48 * q_prefill, decode=48 * q_decode, rg_lru=0,
                       gmm=144 * (q_prefill + q_decode))
    if qwen_counts != want_counts or qres["requests_done"] != \
            SERVE_ARGS["requests"] or qres["decode_tokens"] <= 0:
        raise SystemExit(f"serve qwen: launches {qwen_counts} (want "
                         f"{want_counts}), result {qres}")

    # -- 15. 4-layer Qwen3-30B-A3B, kernels vs plain versions -----------------
    phase_start("15")
    gc.collect()
    torch.cuda.empty_cache()
    check_qwen_vs_plain(dev)

    # -- 16. where Qwen3-30B-A3B's serve time goes ----------------------------
    phase_start("16")
    gc.collect()
    torch.cuda.empty_cache()
    profile_serve(dev, "qwen3-moe-30b-a3b", 16)

    # -- 17. the main path with failures, control and telemetry ---------------
    phase_start("17")
    gc.collect()
    torch.cuda.empty_cache()
    masked = check_masked_path(dev)
    log(f"phase 17 masked main path (failures, control, telemetry), "
        f"{SLICES} slices: {json.dumps(masked)}")
    log(f"phase 17 beside the runs without masks: slices/s "
        f"{masked['slices_per_s']:.2f} (phase 4: "
        f"{runs['default']['slices_per_s']:.2f}); device time "
        f"{masked['device_ms_per_slice']:.4f} ms a slice (phase 6: "
        f"{tot / 16:.4f}); kernels launched a slice "
        f"{masked['kernels_per_slice']:.2f} (phase 6: "
        f"{kernels_per_slice:.2f}); 48 slices equal on CUDA and CPU, every "
        f"field and counter")

    # -- 18. the clocked service ----------------------------------------------
    phase_start("18")
    gc.collect()
    torch.cuda.empty_cache()
    service = check_service(dev, masked)
    log(f"phase 18 clocked service (failures, control, telemetry), "
        f"{SLICES} slices: {json.dumps(service)}")
    log(f"phase 18 beside phase 17: advance {service['advance_wall_ms_per_slice']:.3f}"
        f" ms a slice in windows of {NET_WINDOW} (run: "
        f"{service['run_wall_ms_per_slice']:.3f}); kernels launched a slice "
        f"{service['service_kernels_per_slice']:.2f} (phase 17: "
        f"{masked['kernels_per_slice']:.2f}); set-up a window "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in service["setup_ms"].items())
        + f"; peak device memory {service['peak_mib_first']:.1f} MiB after "
        f"the first extra window ({service['packets_first']} packets), "
        f"{service['peak_mib_last']:.1f} MiB after the last "
        f"({service['packets_last']} packets, clock "
        f"{service['clock_last']}); a window's masked capacities "
        f"{service['window_caps_mib']:.1f} MiB, the whole run's would be "
        f"{service['whole_run_caps_mib']:.1f} MiB; windowed run equal to the "
        f"one-shot run, 48 slices of the service equal on CUDA and CPU")

    # -- 19. phased table swaps -------------------------------------------------
    phase_start("19")
    gc.collect()
    torch.cuda.empty_cache()
    phased = check_phased(dev)
    log(f"phase 19 phased swaps (deployed, fast reroute, repair), {SLICES} "
        f"slices: {json.dumps(phased)}")

    # -- 20. the traffic-aware reconfigure loop ---------------------------------
    phase_start("20")
    gc.collect()
    torch.cuda.empty_cache()
    reconf = check_reconfigure(dev)
    log(f"phase 20 reconfigure loop, {RECONF_EPOCHS} epochs of {RECONF_E} "
        f"slices: {json.dumps(reconf)}")
    ep = reconf["epoch"]
    log(f"phase 20 beside phases 4 and 17: slices/s "
        + ", ".join(f"{k} {v['slices_per_s']:.2f}" for k, v in reconf.items()
                    if k != "epoch")
        + f" (phase 4: {runs['default']['slices_per_s']:.2f}, phase 17: "
        f"{masked['slices_per_s']:.2f}); an epoch of the hotswap run "
        f"{ep['wall_ms']:.1f} ms: measure + schedule {ep['measure_schedule_ms']:.1f}"
        f", recompile {ep['recompile_ms']:.1f}, {RECONF_E} slices "
        f"{ep['slices_ms']:.1f}; kernels launched a slice in epoch "
        f"{RECONF_PROFILED_EPOCH} {ep['profiled_kernels_per_slice']:.2f} "
        f"(phase 17: {masked['kernels_per_slice']:.2f}), device time "
        f"{ep['profiled_device_ms_per_slice']:.4f} ms a slice; lookup with "
        f"vsel {ep['lookup_us_per_call']:.3f} us a call on the device; peak "
        f"device memory {reconf['b_hotswap']['peak_mib']:.1f} MiB (hotswap; "
        f"{reconf['b_hotswap']['loop_peak_mib']:.1f} above what was held "
        f"before), {reconf['b_2pc_degrade']['peak_mib']:.1f} MiB (2PC with "
        f"degrade; {reconf['b_2pc_degrade']['loop_peak_mib']:.1f}); "
        f"mixed-version epochs {reconf['b_hotswap']['mixed_epochs']} "
        f"(hotswap), degraded epochs "
        f"{reconf['b_2pc_degrade']['degraded_epochs']} (2PC)")

    # -- 21. the seven architectures and the scenario sweep ---------------------
    phase_start("21")
    gc.collect()
    torch.cuda.empty_cache()
    t21 = time.perf_counter()
    archs = check_architectures(dev)
    log(f"phase 21(a)-(b) seven architectures: {json.dumps(archs)}")
    gc.collect()
    torch.cuda.empty_cache()
    fleet = check_fleet(dev, phase6=(kernels_per_slice, tot / 16))
    seeds = fleet["seeds"]
    log(f"phase 21(c) simulate_fleet: {json.dumps(fleet)}")
    log(f"phase 21 ({time.perf_counter() - t21:.1f} s; {smi}): the sweep of "
        f"{FLEET_SEEDS} seeds {seeds['fleet_scenario_slices_per_s']:.1f} "
        f"scenario-slices/s against {seeds['solo_scenario_slices_per_s']:.1f}"
        f" for the solo runs; {seeds['kernels_per_slice']:.2f} kernels and "
        f"{seeds['device_ms_per_slice']:.4f} ms of device time a slice "
        f"(phase 6 at one scenario: {kernels_per_slice:.2f}, "
        f"{tot / 16:.4f}); peak device memory {seeds['peak_mib']:.1f} MiB; "
        f"the {FLEET_TRACES} traces {fleet['traces']['fleet_scenario_slices_per_s']:.1f}"
        f" against {fleet['traces']['solo_scenario_slices_per_s']:.1f}; "
        "every member equal to its solo run")

    # -- 22. reconfigure_fleet and simulate_sharded ----------------------------
    phase_start("22")
    gc.collect()
    torch.cuda.empty_cache()
    t22 = time.perf_counter()
    rfleet = check_reconfigure_fleet(dev)
    log(f"phase 22(a) reconfigure_fleet: {json.dumps(rfleet)}")
    for tag, r in rfleet.items():
        ep = r["epoch"]
        log(f"phase 22(a) {tag}: {r['scenarios']} scenarios "
            f"{r['fleet_scenario_slices_per_s']:.1f} scenario-slices/s "
            f"against {r['solo_scenario_slices_per_s']:.1f} for the solo "
            f"runs; an epoch {ep['wall_ms']:.1f} ms: measure + schedule "
            f"{ep['measure_schedule_ms']:.1f}, {r['scenarios']} recompiles "
            f"{ep['recompiles_ms']:.1f}, {RECONF_E} slices "
            f"{ep['slices_ms']:.1f}; peak device memory {r['peak_mib']:.1f} "
            f"MiB ({r['loop_peak_mib']:.1f} above what was held); every "
            "member equal to its solo run")
    gc.collect()
    torch.cuda.empty_cache()
    t22b = time.perf_counter()
    sharded = check_sharded(dev)
    for fab in ("vlb", "ucmp"):
        r = sharded[fab]
        log(f"phase 22(b) simulate_sharded {fab} ({r['paths_per_entry']:.2f} "
            f"paths an entry; one device {r['one_device_slices_per_s']:.1f} "
            "slices/s): " + "; ".join(
                f"D={D} {r[f'D{D}']['backend']} "
                f"{r[f'D{D}']['slices_per_s']:.2f} slices/s, "
                f"{r[f'D{D}']['exchanges_per_slice']:.2f} exchanges and "
                f"{r[f'D{D}']['exchanged_bytes_per_slice']:.0f} bytes a slice"
                for D, _, _ in SHARD_RUNS)
            + "; every run equal to the one-device run, check_sharding "
            "clean, both kernels launched on every rank")
    log(f"phase 22 ({time.perf_counter() - t22:.1f} s, (b) "
        f"{time.perf_counter() - t22b:.1f} s; {smi})")

    # -- A-D. EQO and the last model families ---------------------------------
    phase_start("A-D")
    gc.collect()
    torch.cuda.empty_cache()
    tA = time.perf_counter()
    eqo = check_eqo(dev)
    tB = time.perf_counter()
    xlstm = check_xlstm(dev)
    tC = time.perf_counter()
    seamless = check_seamless(dev)
    tD = time.perf_counter()
    llava = check_llava(dev)
    log(f"phases A-D ({smi}): A {tB - tA:.1f} s, B {tC - tB:.1f} s, C "
        f"{tD - tC:.1f} s, D {time.perf_counter() - tD:.1f} s")

    # -- E. training ----------------------------------------------------------
    phase_start("E")
    gc.collect()
    torch.cuda.empty_cache()
    # F(e)'s dry run is host work on a fake process group: it runs
    # beside the training phase, whose steps keep the card busy
    dry_run = start_dry_run()
    try:
        training = check_training(dev, smi)
    except BaseException:
        stop_dry_run(dry_run)
        raise

    # -- F. the expert-parallel MoE on ranks of the card, the dry run ---------
    phase_start("F")
    gc.collect()
    torch.cuda.empty_cache()
    ep = check_expert_parallel(dev, smi, dry_run)

    # -- results ----------------------------------------------------------------
    K = stk_n.shape[-1]
    # bytes each function must move: per packet its inputs and outputs,
    # plus the two slices (injection, transit) of both tables / the
    # capacities and admitted bytes per key
    tfl_bytes = P_MAIN * (4 * 4 + 2 * 4) + 2 * 2 * N_TORS * N_TORS * K * 4
    adm_bytes = P_MAIN * (4 + 4 + 1 + 1) + NK * 4 * 2
    adm_rx_bytes = P_MAIN * (4 + 4 + 1 + 1) + N_TORS * 4 * 2
    # integer operations the function needs per packet: the lookup's row
    # index, K slot tests, a modulo and two gathers; admission's key
    # check, one step of a per-key running sum, a compare and an add
    tfl_ops, adm_ops = P_MAIN * (6 + K + 3), P_MAIN * 6

    def new_form_bound(d):
        # the port's form at mask density d: every packet's mask byte and
        # outputs; node, dst and sel of the packets in the mask; one
        # packed entry (2K int32) for each of them, at most every entry
        # of the slice's two tables; the row index, K slot tests, the
        # hash (10 operations), a modulo and the pick
        n = int(d * P_MAIN)
        nbytes = P_MAIN * (1 + 8) + n * 12 + \
            min(n, 2 * N_TORS * N_TORS) * 2 * K * 4
        return bound(nbytes, n * (6 + K + 13))

    def versioned_bound(d):
        # with offsets and versions: the [N] phase_off and [N] vsel read
        # once, a node still reads one slice of one version of each table;
        # a clamp and a multiply-add more a looked-up packet
        n = int(d * P_MAIN)
        nbytes = P_MAIN * (1 + 8) + n * 12 + 2 * N_TORS * 4 + \
            min(n, 2 * N_TORS * N_TORS) * 2 * K * 4
        return bound(nbytes, n * (6 + K + 19))

    def offsets_bound(d):
        # the same with per-node offsets: the [N] phase_off read once (a
        # node still reads one slice of each table), and an add, a modulo
        # and a select more a looked-up packet
        n = int(d * P_MAIN)
        nbytes = P_MAIN * (1 + 8) + n * 12 + N_TORS * 4 + \
            min(n, 2 * N_TORS * N_TORS) * 2 * K * 4
        return bound(nbytes, n * (6 + K + 16))

    kernels = [
        dict(name="time_flow_lookup", route="cuda",
             source="src/repro_torch/csrc/time_flow_lookup.cu",
             replaces="src/repro/kernels/time_flow_lookup.py:43",
             launches=main_launches["tfl"], mismatches=tfl_mis,
             max_abs_err=tfl_err, ms=timings["tfl_ms"],
             plain_ms=timings["tfl_plain_ms"],
             **bound(tfl_bytes, tfl_ops),
             library_ms=None, launch_floor_ms=timings["tfl_floor_ms"],
             masked_path_launches=masked["launches"]["tfl"],
             service_path_launches=service["service_launches"]["tfl"],
             windowed_path_launches=service["fabric_launches"]["tfl"],
             phased_path_launches=phased["launches"]["tfl"],
             packed_ms=timings["tfl_packed_ms"],
             new_form={tag: dict(ms=timings[f"tfl_new_{tag}_ms"],
                                 mask_density=d, **new_form_bound(d))
                       for d, tag in ((1.0, "full"), (0.1, "10"),
                                      (0.01, "1"))},
             new_form_floor_ms=timings["tfl_new_floor_ms"],
             new_form_plain_ms=timings["tfl_new_plain_ms"],
             offsets={tag: dict(ms=timings[f"tfl_new_{tag}_off_ms"],
                                ms_without=timings[f"tfl_new_{tag}_ms"],
                                mask_density=d, **offsets_bound(d))
                      for d, tag in ((1.0, "full"), (0.1, "10"),
                                     (0.01, "1"))},
             offsets_floor_ms=timings["tfl_new_off_floor_ms"],
             versioned={tag: dict(v2_ms=timings[f"tfl_ver2_{tag}_ms"],
                                  v3_ms=timings[f"tfl_ver3_{tag}_ms"],
                                  ms_without=timings[
                                      f"tfl_ver_{tag}_without_ms"],
                                  mask_density=d, **versioned_bound(d))
                        for d, tag in ((1.0, "full"), (0.1, "10"),
                                       (0.01, "1"))},
             versioned_floor_ms=timings["tfl_ver_floor_ms"],
             versioned_plain_ms=timings["tfl_ver_plain_ms"],
             reconfigure_path_launches={
                 k: v["launches"]["tfl"] for k, v in reconf.items()
                 if k != "epoch"},
             reconfigure_path_us_per_call=reconf["epoch"][
                 "lookup_us_per_call"],
             architecture_path_launches_per_slice={
                 k: v["lookup_launches_per_slice"]
                 for k, v in archs["arch_108"].items()},
             fleet_path_launches={k: fleet[k]["launches"]["tfl"]
                                  for k in ("seeds", "traces")},
             reconfigure_fleet_path_launches={
                 k: v["launches"]["tfl"] for k, v in rfleet.items()},
             fleet_hash={tag: dict(ms=timings[f"tfl_fleet_{tag}_ms"],
                                   ms_without=timings[
                                       f"tfl_fleet_{tag}_without_ms"],
                                   mask_density=d, **new_form_bound(d))
                         for d, tag in ((1.0, "full"), (0.1, "10"),
                                        (0.01, "1"))},
             global_hash=dict(
                 {tag: dict(ms=timings[f"tfl_base_{tag}_ms"],
                            ms_without=timings[f"tfl_base_{tag}_without_ms"],
                            mask_density=d, **new_form_bound(d))
                  for d, tag in ((1.0, "full"), (0.1, "10"), (0.01, "1"))},
                 sharded_path_launches=sharded["launches"]["tfl"]),
             main_path=dict(mask_density=main_density,
                            device_us_per_call=tfl_main_us,
                            kernels_per_slice=kernels_per_slice)),
        dict(name="admission_admit", route="cuda",
             source="src/repro_torch/csrc/admission.cu",
             replaces="src/repro/kernels/admission.py:76",
             launches=main_launches["adm"], mismatches=adm_mis,
             max_abs_err=adm_err, ms=timings["adm_ms"],
             plain_ms=timings["adm_plain_ms"],
             **bound(adm_bytes, adm_ops),
             library_ms=None, launch_floor_ms=timings["adm_floor_ms"],
             masked_path_launches=masked["launches"]["adm"],
             service_path_launches=service["service_launches"]["adm"],
             windowed_path_launches=service["fabric_launches"]["adm"],
             phased_path_launches=phased["launches"]["adm"],
             reconfigure_path_launches={
                 k: v["launches"]["adm"] for k, v in reconf.items()
                 if k != "epoch"},
             architecture_path_launches_per_slice={
                 k: v["admission_launches_per_slice"]
                 for k, v in archs["arch_108"].items()},
             fleet_path_launches={k: fleet[k]["launches"]["adm"]
                                  for k in ("seeds", "traces")},
             reconfigure_fleet_path_launches={
                 k: v["launches"]["adm"] for k, v in rfleet.items()},
             sharded_path_launches=sharded["launches"]["adm"],
             rx_cut=dict(ms=timings["adm_rx_ms"], num_keys=N_TORS,
                         **bound(adm_rx_bytes, adm_ops))),
    ]
    for name, key, src, line, err, err_abs in (
            ("flash_attention", "flash", "flash_attention", 77, flash_err,
             flash_abs),
            ("decode_attention", "decode", "decode_attention", 63, decode_err,
             decode_abs),
            ("rg_lru", "rg_lru", "rg_lru", 43, rg_err, rg_abs)):
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}.cu",
            replaces=f"src/repro/kernels/{src}.py:{line}",
            launches=serve_counts[key], max_abs_err=err_abs, relerr=err,
            ms=lm_t[f"{key}_ms"], plain_ms=lm_t[f"{key}_plain_ms"],
            **lm_bounds[key], library_ms=lm_t.get(f"{key}_sdpa_ms"),
            launch_floor_ms=lm_t[f"{key}_floor_ms"]))
    kernels[-1].update(prefill_group_ms=rg_group_ms,
                       same_bytes_elementwise_ms=lm_t["rg_lru_same_bytes_ms"])
    kernels.append(dict(
        name="grouped_matmul", route="cuda",
        source="src/repro_torch/csrc/grouped_matmul.cu",
        replaces="src/repro/kernels/grouped_matmul.py:35",
        launches=qwen_counts["gmm"], max_abs_err=gmm_abs, relerr=gmm_err,
        ms=gmm_t["prefill_up_ms"], plain_ms=gmm_t["prefill_up_plain_ms"],
        **gmm_bounds["prefill_up"], library_ms=gmm_t["prefill_up_bmm_ms"],
        launch_floor_ms=gmm_t["floor_ms"],
        shapes={key: dict(ms=gmm_t[f"{key}_ms"],
                          plain_ms=gmm_t[f"{key}_plain_ms"],
                          library_ms=gmm_t[f"{key}_bmm_ms"], **gmm_bounds[key])
                for key in gmm_bounds},
        f32=dict(gmm_f32, max_row_relerr=gmm32_err, max_abs_err=gmm32_abs),
        expert_parallel_launches=ep["launches"]))
    # the training path: launches of the OLMo-1B run (E(c)) and of one
    # micro-batch of the reduced models (E(b)), forward and backward; the
    # gradient's times beside the plain version's autograd (E(a))
    small = training["small"]
    tk = training["kernels"]
    train_entries = {
        "flash_attention": dict(
            olmo_train_launches=training["olmo"]["launches"]["flash"],
            reduced_launches={a: dict(forward=r["fwd_launches"]["flash"],
                                      backward=r["bwd_launches"]["flash"])
                              for a, r in small.items()},
            grads=tk["flash"]),
        "rg_lru": dict(
            reduced_launches={a: dict(forward=r["fwd_launches"]["rg_lru"],
                                      backward=r["bwd_launches"]["rg_lru"])
                              for a, r in small.items()},
            grads=tk["rg_lru"]),
        "grouped_matmul": dict(
            reduced_launches={a: dict(forward=r["fwd_launches"]["gmm"],
                                      backward=r["bwd_launches"]["gmm"])
                              for a, r in small.items()},
            grads=tk["grouped_matmul"]),
    }
    for k in kernels:
        if k["name"] in train_entries:
            k["training"] = train_entries[k["name"]]
        if k["name"] in ("flash_attention", "decode_attention"):
            key = "flash" if k["name"] == "flash_attention" else "decode"
            k["qwen_launches"] = qwen_counts[key]
            k["seamless_launches"] = seamless["launches"][key]
            k["llava_launches"] = llava["launches"][key]
            k["xlstm_launches"] = xlstm["launches"][key]
            shapes = FLASH_NEW if key == "flash" else DECODE_NEW
            k["new_shapes"] = {
                tag: dict(ms=lm_t[f"{key}_{tag}_ms"],
                          plain_ms=lm_t[f"{key}_{tag}_plain_ms"],
                          library_ms=lm_t[f"{key}_{tag}_sdpa_ms"],
                          **lm_bounds[f"{key}_{tag}"]) for tag in shapes}
        if k["name"] == "flash_attention":
            k["qwen_shape"] = dict(ms=lm_t["flash_qwen_ms"],
                                   plain_ms=lm_t["flash_qwen_plain_ms"],
                                   library_ms=lm_t["flash_qwen_sdpa_ms"],
                                   **lm_bounds["flash_qwen"])
        if k["name"] == "decode_attention":
            k["qwen_shape"] = dict(ms=lm_t["decode_qwen_ms"],
                                   plain_ms=lm_t["decode_qwen_plain_ms"],
                                   library_ms=lm_t["decode_qwen_sdpa_ms"],
                                   **lm_bounds["decode_qwen"])
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the kernels' "
        f"build included; seconds by phase {json.dumps(phase_seconds())}")
    log(smi)                                # card name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        # the fork server of phases 22(b) and F, if they started one
        spawn = sys.modules.get("repro_torch.distributed.spawn")
        if spawn is not None:
            spawn.stop_fork_server()
    sys.exit(rc)
