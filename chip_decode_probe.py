#!/usr/bin/env python3
"""Where flash-decode's time goes, on one CUDA card.

    python3 chip_decode_probe.py

At the decode shapes of ``chip_smoke.py`` (RecurrentGemma-9B and
Qwen3-30B-A3B), for ``src/repro_torch/csrc/decode_attention.cu``:

1. Split sizes: the kernel's C entry point called with cache splits of
   32 to 512 slots; per size the device time of a call (CUDA-graph median,
   as ``chip_smoke.py`` times) and of each of its two passes (the profiler).
   The wrapper's own choice (``split_plan``) is marked.
2. Phases: a copy of the source with ``clock64()`` probes planted by exact
   text substitution (as ``chip_fault_probe.py`` plants faults), built into
   a temporary directory and run at the wrapper's split sizes; one block's
   thread 0 reports the cycles of its prologue, of waiting for each tile,
   of the scores, the softmax and P.V over all tiles, and of the epilogue.

Prints one line per measurement. Exits non-zero when CUDA is absent or a
probe's text is not in the source exactly once.
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SPANS = (32, 64, 128, 192, 256, 512)
# (text in the source, text put in its place): the probes of phase 2
PROBES = [
    ("namespace {\n", "__device__ long long g_probe[8];\nnamespace {\n"),
    ("  // the G heads of this kv head are rows kvh*G .. kvh*G+G-1 of q[b]; the",
     "  const bool probe = blockIdx.x == 0 && blockIdx.y == gridDim.y / 2 &&\n"
     "                     threadIdx.x == 0;\n"
     "  const long long t0 = clock64();\n"
     "  long long tl = t0, tw = 0, tsc = 0, tsm = 0, tpv = 0;\n"
     "  // the G heads of this kv head are rows kvh*G .. kvh*G+G-1 of q[b]; the"),
    ("  const int ktile = kTK * ks, vtile = kTK * HD;",
     "  if (probe) g_probe[0] = clock64() - t0;\n"
     "  const int ktile = kTK * ks, vtile = kTK * HD;"),
    ("    cp_async_wait<kBufs - 1>();   // tile t has landed (this thread's copies)\n"
     "    __syncthreads();              // ... all of them; q and the state are set\n",
     "    tl = clock64();\n"
     "    cp_async_wait<kBufs - 1>();   // tile t has landed (this thread's copies)\n"
     "    __syncthreads();              // ... all of them; q and the state are set\n"
     "    tw += clock64() - tl; tl = clock64();\n"),
    ("    __syncthreads();\n\n    // online softmax",
     "    __syncthreads();\n    tsc += clock64() - tl; tl = clock64();\n\n"
     "    // online softmax"),
    ("    __syncthreads();\n\n    if (pv) {\n      const float4 c4",
     "    __syncthreads();\n    tsm += clock64() - tl; tl = clock64();\n\n"
     "    if (pv) {\n      const float4 c4"),
    ("    __syncthreads();   // this tile's buffer and weights are free again\n  }\n",
     "    __syncthreads();   // this tile's buffer and weights are free again\n"
     "    tpv += clock64() - tl;\n  }\n"
     "  if (probe) {\n    g_probe[1] = clock64() - t0; g_probe[2] = tw;\n"
     "    g_probe[3] = tsc; g_probe[4] = tsm; g_probe[5] = tpv; g_probe[7] = nt;\n"
     "  }\n"),
    ("    ws_ml[2 * h + 1] = l_run[h];\n  }\n}\n",
     "    ws_ml[2 * h + 1] = l_run[h];\n  }\n"
     "  if (probe) g_probe[6] = clock64() - t0;\n}\n"),
]
READER = """
extern "C" int probe_read(long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_probe, sizeof(long long) * 8));
}
"""


def inputs(cs, dev, D):
    """The decode inputs of ``chip_smoke.py``'s phase 8 for shape ``D``."""
    import torch
    B, Hq, Kv, S, hd, cur = (D[x] for x in ("B", "Hq", "Kv", "S", "hd", "cur"))
    g = torch.Generator(device=dev).manual_seed(62)
    q = torch.randn(B, Hq, hd, generator=g, device=dev).to(torch.bfloat16)
    kc, vc, pos = cs.ring_cache(dev, B, S, Kv, hd, cur, 63)
    return q, kc, vc, pos


def launcher(lib, q, kc, vc, pos, D, n_split, span):
    """A call of the C entry point with the given split, on fresh buffers."""
    import torch
    B, Hq, Kv, S, hd, cur = (D[x] for x in ("B", "Hq", "Kv", "S", "hd", "cur"))
    G = Hq // Kv
    out = torch.empty_like(q)
    ws = torch.empty(B * Kv * n_split * G * (hd + 2), dtype=torch.float32,
                     device=q.device)

    def call():
        err = lib.decode_launch(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), pos.data_ptr(),
            ws.data_ptr(), out.data_ptr(), B, S, Kv, G, hd, cur,
            D["kw"].get("window", 0), 0.0, 1.0 / math.sqrt(hd), n_split, span,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"decode_launch: CUDA error {err}")
    return call


def sweep(cs, da, dev, shapes):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    lib = _build.load("decode_attention", da._SIGNATURES)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for tag, D in shapes:
        q, kc, vc, pos = inputs(cs, dev, D)
        plan = da.split_plan(D["B"] * D["Kv"], D["S"], sms)
        for span in SPANS:
            n = -(-D["S"] // span)
            call = launcher(lib, q, kc, vc, pos, D, n, span)
            ms = cs.graph_ms(call, calls=20)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
            passes = {"split": 0.0, "merge": 0.0}
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA:
                    key = "merge" if "merge" in e.key else "split"
                    passes[key] += cs.self_device_ms(e) / 20
            cs.log(f"sweep {tag} span {span} n_split {n} blocks "
                   f"{D['B'] * D['Kv'] * n}: {ms * 1e3:.2f} us a call; split "
                   f"pass {passes['split'] * 1e3:.2f} us, merge pass "
                   f"{passes['merge'] * 1e3:.2f} us"
                   + ("  <- split_plan" if (n, span) == plan else ""))


def phases(cs, da, dev, shapes, tmp: Path):
    import torch
    from repro_torch.kernels import _build
    text = (ROOT / "src/repro_torch/csrc/decode_attention.cu").read_text()
    for old, new in PROBES:
        if text.count(old) != 1:
            raise SystemExit("chip_decode_probe: a probe's text is not in "
                             f"decode_attention.cu exactly once: {old!r}")
        text = text.replace(old, new)
    src, so = tmp / "decode_probe.cu", tmp / "libdecode_probe.so"
    src.write_text(text + READER)
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"nvcc failed on the probed copy:\n{out.stdout}"
                         f"{out.stderr}")
    lib = ctypes.CDLL(str(so))
    argtypes, restype = da._SIGNATURES["decode_launch"]
    lib.decode_launch.argtypes, lib.decode_launch.restype = argtypes, restype
    lib.probe_read.argtypes, lib.probe_read.restype = [ctypes.c_void_p], ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for tag, D in shapes:
        q, kc, vc, pos = inputs(cs, dev, D)
        n, span = da.split_plan(D["B"] * D["Kv"], D["S"], sms)
        call = launcher(lib, q, kc, vc, pos, D, n, span)
        for _ in range(3):   # the last call's block is read
            call()
        torch.cuda.synchronize()
        v = (ctypes.c_longlong * 8)()
        if lib.probe_read(v):
            raise SystemExit("chip_decode_probe: reading the probes failed")
        cs.log(f"phases {tag} span {span} ({v[7]} tiles): cycles prologue "
               f"{v[0]}, waiting for tiles {v[2]}, scores {v[3]}, softmax "
               f"{v[4]}, P.V {v[5]}, to the loop's end {v[1]}, to the "
               f"block's end {v[6]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_decode_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as da
    dev = torch.device("cuda")
    cs.log(cs.nvidia_smi())
    shapes = [("recurrentgemma", cs.DECODE_FULL), ("qwen", cs.DECODE_QWEN)]
    sweep(cs, da, dev, shapes)
    with tempfile.TemporaryDirectory() as tmp:
        phases(cs, da, dev, shapes, Path(tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
