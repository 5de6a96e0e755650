#!/usr/bin/env python3
"""Where flash attention's time goes, on one CUDA card.

    python3 chip_flash_probe.py

A copy of ``src/repro_torch/csrc/flash_attention.cu`` with ``clock64()``
probes planted by exact text substitution (as ``chip_fault_probe.py``
plants faults) is built into a temporary directory and run at the prefill
shapes of ``chip_smoke.py``'s phase 8 (RecurrentGemma-9B and
Qwen3-30B-A3B). Block 0 reports, for the first thread of each consumer
warpgroup, the cycles over all its key tiles after the first of an item
spent waiting for K and V to land, issuing the S and P V products,
waiting for S, in the softmax, waiting for P V, and rescaling O and
packing P, plus its epilogues and its whole run; for the producer thread,
the cycles it waited for a free K or V stage and for the consumers to
release Q. The probes' own cost is in the numbers: the call's device time
with and without them is printed beside them.

Prints one line per shape and thread. Exits non-zero when CUDA is absent
or a probe's text is not in the source exactly once.
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

# (text in the source, text put in its place)
PROBES = [
    ("namespace {\n", "__device__ long long g_probe[32];\nnamespace {\n"),
    # the producer thread
    ("      int it = 0;   // K / V tiles loaded so far, over all work items\n",
     "      int it = 0;   // K / V tiles loaded so far, over all work items\n"
     "      long long tw_ = 0, tq_ = 0, tl_;\n"),
    ("        if (n > 0) mbar_wait(qempty, (n - 1) & 1);\n",
     "        tl_ = clock64();\n"
     "        if (n > 0) mbar_wait(qempty, (n - 1) & 1);\n"
     "        tq_ += clock64() - tl_;\n"),
    ("          if (round > 0) mbar_wait(emptyk + s, (round - 1) & 1);\n",
     "          tl_ = clock64();\n"
     "          if (round > 0) mbar_wait(emptyk + s, (round - 1) & 1);\n"
     "          tw_ += clock64() - tl_;\n"),
    ("          if (round > 0) mbar_wait(emptyv + s, (round - 1) & 1);\n",
     "          tl_ = clock64();\n"
     "          if (round > 0) mbar_wait(emptyv + s, (round - 1) & 1);\n"
     "          tw_ += clock64() - tl_;\n"),
    ("        }\n      }\n    }\n  } else {   // consumer",
     "        }\n      }\n"
     "      if (blockIdx.x == 0) { g_probe[16] = tw_; g_probe[17] = tq_; }\n"
     "    }\n  } else {   // consumer"),
    # the first thread of each consumer warpgroup
    ("    const int row = warp * 16 + g;   // this thread's rows: row, row + 8\n",
     "    const int row = warp * 16 + g;   // this thread's rows: row, row + 8\n"
     "    const bool probe = blockIdx.x == 0 && (tid & 127) == 0;\n"
     "    long long P_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "    long long tl_ = clock64(), te_ = 0;\n"
     "    const long long t0_ = tl_;\n"),
    ("          mbar_wait(fullk + s, (it / ST) & 1);\n"
     "          mbar_wait(fullv + sp, php);\n",
     "          tl_ = clock64();\n"
     "          mbar_wait(fullk + s, (it / ST) & 1);\n"
     "          mbar_wait(fullv + sp, php);\n"
     "          P_[0] += clock64() - tl_; tl_ = clock64();\n"),
    ("          wgmma_commit();\n          wgmma_wait<1>();",
     "          wgmma_commit();\n"
     "          P_[1] += clock64() - tl_; tl_ = clock64();\n"
     "          wgmma_wait<1>();"),
    ("          fence_regs(sacc);\n          if (lane == 0) mbar_arrive(emptyk + s);\n",
     "          P_[2] += clock64() - tl_; tl_ = clock64();\n"
     "          fence_regs(sacc);\n          if (lane == 0) mbar_arrive(emptyk + s);\n"),
    ("          softmax(sacc, x, m, l, corr, t);\n          wgmma_wait<0>();",
     "          softmax(sacc, x, m, l, corr, t);\n"
     "          P_[3] += clock64() - tl_; tl_ = clock64();\n"
     "          wgmma_wait<0>();"),
    ("          fence_regs(o);\n          fence_regs(p);\n          if (lane == 0) mbar_arrive(emptyv + sp);\n",
     "          P_[4] += clock64() - tl_; tl_ = clock64();\n"
     "          fence_regs(o);\n          fence_regs(p);\n          if (lane == 0) mbar_arrive(emptyv + sp);\n"),
    ("          pack_p<BK>(x, p);\n        }\n",
     "          pack_p<BK>(x, p);\n"
     "          P_[5] += clock64() - tl_; P_[7] += 1;\n        }\n"),
    ("      // o / l in bfloat16, one 64-column box at a time through this\n",
     "      te_ = clock64();\n"
     "      // o / l in bfloat16, one 64-column box at a time through this\n"),
    ("          asm volatile(\"cp.async.bulk.commit_group;\\n\" ::: \"memory\");\n"
     "        }\n      }\n    }\n",
     "          asm volatile(\"cp.async.bulk.commit_group;\\n\" ::: \"memory\");\n"
     "        }\n      }\n      P_[6] += clock64() - te_;\n    }\n"),
    ("    if ((tid & 127) == 0)   // the buffers live until the stores have read them\n",
     "    if (probe) {\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < 8; ++i) g_probe[8 * c + i] = P_[i];\n"
     "      g_probe[20 + c] = clock64() - t0_;\n"
     "    }\n"
     "    if ((tid & 127) == 0)   // the buffers live until the stores have read them\n"),
]
READER = """
extern "C" int probe_read(long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_probe, sizeof(long long) * 32));
}
"""
SHAPES = [   # B, Hq, Hkv, L, S, hd, causal, window
    ("recurrentgemma", (4, 16, 1, 3072, 3072, 256, True, 2048)),
    ("qwen", (4, 32, 4, 3072, 3072, 128, True, 0)),
]


def build(fa, tmp: Path):
    from repro_torch.kernels import _build
    text = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    for old, new in PROBES:
        if text.count(old) != 1:
            raise SystemExit("chip_flash_probe: a probe's text is not in "
                             f"flash_attention.cu exactly once: {old!r}")
        text = text.replace(old, new)
    src, so = tmp / "flash_probe.cu", tmp / "libflash_probe.so"
    src.write_text(text + READER)
    (tmp / "hopper.cuh").write_text(
        (ROOT / "src/repro_torch/csrc/hopper.cuh").read_text())
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"nvcc failed on the probed copy:\n{out.stdout}"
                         f"{out.stderr}")
    lib = ctypes.CDLL(str(so))
    argtypes, restype = fa._SIGNATURES["flash_launch"]
    lib.flash_launch.argtypes, lib.flash_launch.restype = argtypes, restype
    lib.probe_read.argtypes = [ctypes.c_void_p]
    lib.probe_read.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    cs.log(cs.nvidia_smi())
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(fa, Path(tmp))
        for tag, (B, Hq, Hkv, L, S, hd, causal, window) in SHAPES:
            q, k, v = cs.flash_inputs(dev, B, Hq, Hkv, L, S, hd, seed=60)
            out = torch.empty_like(q)
            nxt = torch.zeros(1, dtype=torch.int32, device=dev)

            def call():
                nxt.zero_()
                err = lib.flash_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None, nxt.data_ptr(), B * Hq, L, S, Hq, Hkv, hd,
                    int(causal),
                    window, 0.0, 1.0 / math.sqrt(hd), 0,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"flash_launch: CUDA error {err}")

            kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=causal,
                      window=window)
            probed_ms = cs.graph_ms(call)
            plain_ms = cs.graph_ms(lambda: fa.flash_attention(q, k, v, **kw))
            err = cs.row_relerr(out, fa.flash_attention_plain(q, k, v, **kw))
            call()
            torch.cuda.synchronize()
            p = (ctypes.c_longlong * 32)()
            if lib.probe_read(p):
                raise SystemExit("chip_flash_probe: reading the probes failed")
            cs.log(f"{tag}: {probed_ms:.4f} ms a call with the probes, "
                   f"{plain_ms:.4f} without; row relerr {err:.2e}")
            for c in (0, 1):
                v8 = p[8 * c: 8 * c + 8]
                n = max(1, v8[7])
                cs.log(f"  block 0 consumer {c}: {v8[7]} tiles after an "
                       f"item's first; cycles a tile: waiting for K and V "
                       f"{v8[0] / n:.0f}, issuing {v8[1] / n:.0f}, waiting "
                       f"for S {v8[2] / n:.0f}, softmax {v8[3] / n:.0f}, "
                       f"waiting for P V {v8[4] / n:.0f}, rescale and pack "
                       f"{v8[5] / n:.0f}; epilogues {v8[6]}, whole run "
                       f"{p[20 + c]}")
            cs.log(f"  block 0 producer: cycles waiting for a free stage "
                   f"{p[16]}, for Q to be released {p[17]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
