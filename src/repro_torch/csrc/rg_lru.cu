// RG-LRU linear recurrence for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rg_lru.py :: rg_lru
// (body _kernel): h_t = a_t * h_{t-1} + b_t along the time axis with
// h_0 = 0, for a, b, h of shape [B, L, W] in float32. The plain version is
// rg_lru_plain in src/repro_torch/kernels/rg_lru.py.
//
// What bounds it: bytes. Each element is read twice (a, b) and written once
// (h), 12 B for one fused multiply-add, far below the card's ~20 FLOP/B
// balance point for float32 outside the tensor cores.
//
// Design: the Pallas kernel blocks time and runs an associative scan inside
// each block, because the TPU's vector unit wants wide lanes. Here the
// channels give the parallelism: one thread per (batch, channel), walking
// time in order with the state in a register. Neighbouring threads hold
// neighbouring channels, so each time step is a coalesced row load. The time
// loop is unrolled so that the loads of several steps, which do not depend
// on h, are in flight together. The order of rounding is the sequential one
// (the reference's associative scan rounds in another order).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;   // small blocks spread B*W threads over all SMs
constexpr int kUnroll = 8;

__global__ void rg_lru_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              float* __restrict__ h, int32_t B, int32_t L,
                              int32_t W) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(B) * W) return;
  const int64_t batch = i / W;
  const int64_t ch = i % W;
  const int64_t base = batch * static_cast<int64_t>(L) * W + ch;
  float state = 0.0f;
  int32_t t = 0;
  for (; t + kUnroll <= L; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = base + static_cast<int64_t>(t + u) * W;
      av[u] = __ldg(a + off);
      bv[u] = __ldg(b + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      state = fmaf(av[u], state, bv[u]);
      h[base + static_cast<int64_t>(t + u) * W] = state;
    }
  }
  for (; t < L; ++t) {
    const int64_t off = base + static_cast<int64_t>(t) * W;
    state = fmaf(__ldg(a + off), state, __ldg(b + off));
    h[off] = state;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int rg_lru_launch(const void* a, const void* b, void* h, int B,
                             int L, int W, void* stream) {
  const int64_t n = static_cast<int64_t>(B) * W;
  if (n <= 0 || L <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  rg_lru_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), B, L, W);
  return static_cast<int>(cudaGetLastError());
}
