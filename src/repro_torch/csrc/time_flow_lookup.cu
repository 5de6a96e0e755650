// Time-flow table lookup for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/time_flow_lookup.py ::
// time_flow_lookup (body _kernel): for each packet, gather the K-slot row
// at (node, dst) of one slice's tables, count the valid slots (>= 0), pick
// slot hash % max(nvalid, 1) with the hash read as uint32_t, and write the
// (next hop, departure offset) pair. The plain version is
// time_flow_lookup_plain in src/repro_torch/kernels/time_flow_lookup.py.
//
// What bounds it: bytes. A packet reads node, dst, hash and selector
// (16 B) and writes two int32 (8 B) that stream through device memory, and
// gathers one K-slot row of each table (32 B at K = 4). The Pallas kernel
// keeps one slice's [N, D, K] tables whole in VMEM; at 108 ToRs and K = 4
// the injection and transit tables of one slice take 373 KB, more than the
// 227 KB of shared memory a block may use. So the tables stay in global
// memory, where one slice's rows are resident in the 50 MB L2 after the
// first touches; the row gathers then hit L2 and the 24 B/packet streams
// set the bound. At the fabric's 131,072 packets that is 3 MB, about 1 us
// at 3.35 TB/s, so in practice the launch latency dominates.
//
// Design: one thread per packet on a 1-D grid over packets, the ragged
// tail masked (no padding of the packet vector in device memory), no
// shared memory, read-only loads through __ldg. The tables arrive as the
// stacked [2, Tr, N, D, K] (injection, transit) tensors the fabric step
// builds, with a slice tm and a per-packet (or constant) selector, so the
// fused injection / re-lookup site is a single launch. Selector, node and
// dst are clamped into the table, as JAX clamps a gather, so no input can
// make the kernel read outside its tensors.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void tfl_kernel(const int32_t* __restrict__ tbl_next,
                           const int32_t* __restrict__ tbl_dep, int32_t Tr,
                           int32_t N, int32_t D, int32_t K, int32_t tm,
                           const int32_t* __restrict__ sel, int32_t sel_const,
                           const int32_t* __restrict__ node,
                           const int32_t* __restrict__ dst,
                           const int32_t* __restrict__ hashv,
                           int32_t* __restrict__ out_next,
                           int32_t* __restrict__ out_dep, int64_t P) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const int32_t s = min(max(sel ? __ldg(sel + i) : sel_const, 0), 1);
  const int32_t n = min(max(__ldg(node + i), 0), N - 1);
  const int32_t d = min(max(__ldg(dst + i), 0), D - 1);
  const int64_t row =
      ((((static_cast<int64_t>(s) * Tr + tm) * N + n) * D) + d) * K;
  const int32_t* rn = tbl_next + row;
  const int32_t* rd = tbl_dep + row;
  int32_t nvalid = 0;
  for (int32_t k = 0; k < K; ++k) nvalid += __ldg(rn + k) >= 0 ? 1 : 0;
  const uint32_t h = static_cast<uint32_t>(__ldg(hashv + i));
  const uint32_t slot = h % static_cast<uint32_t>(max(nvalid, 1));
  out_next[i] = __ldg(rn + slot);
  out_dep[i] = __ldg(rd + slot);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int tfl_launch(const void* tbl_next, const void* tbl_dep, int Tr,
                          int N, int D, int K, int tm, const void* sel,
                          int sel_const, const void* node, const void* dst,
                          const void* hashv, void* out_next, void* out_dep,
                          int64_t P, void* stream) {
  if (P <= 0) return 0;
  const int64_t blocks = (P + kThreads - 1) / kThreads;
  tfl_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tbl_next),
      static_cast<const int32_t*>(tbl_dep), Tr, N, D, K, tm,
      static_cast<const int32_t*>(sel), sel_const,
      static_cast<const int32_t*>(node), static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(hashv), static_cast<int32_t*>(out_next),
      static_cast<int32_t*>(out_dep), P);
  return static_cast<int>(cudaGetLastError());
}
