// RG-LRU linear recurrence for Hopper (sm_90a): a single-pass scan, tiled
// over time, with decoupled look-back; a plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rg_lru.py :: rg_lru
// (body _kernel): h_t = a_t * h_{t-1} + b_t along the time axis with
// h_0 = 0, for a, b, h of shape [B, L, W] in float32. The plain version is
// rg_lru_plain in src/repro_torch/kernels/rg_lru.py, and scan_plan there
// mirrors this kernel's tiling and ticket order.
//
// What bounds it: bytes. Each element is read twice (a, b) and written once
// (h), 12 B for one fused multiply-add, far below the card's ~20 FLOP/B
// balance point for float32 outside the tensor cores. At B 4, L 3,072,
// W 4,096 that is 604 MB, 0.180 ms at 3.35 TB/s.
//
// Why not the TPU's design. The Pallas kernel walks time blocks in order on
// one core and carries h in VMEM from one grid step to the next. Blocks on
// Hopper run in parallel in no order, and the previous port (one thread per
// (batch, channel) walking all of time) kept too few bytes in flight per SM
// to reach the memory rate: it was bound by latency at 2.7x the bound.
// Here time is cut into tiles too, and every tile is loaded, scanned and
// written at once; only one float per channel passes between tiles.
//
// Design. A tile is (batch b, kT time steps, kC = 128 channels); a block of
// kC threads takes one. Tiles are handed out by an atomic ticket counter,
// not by blockIdx, in time-major order: ticket = t * (B * n_stripes) +
// b * n_stripes + stripe. A tile's time predecessors thus hold lower
// tickets and belong to blocks that have already started, so every wait
// below ends (forward progress needs no co-residency). Then:
//   1. cp.async stages the tile's a and b in shared memory (16-byte copies
//      along rows of 512 B where W % 4 == 0 and the pointers are 16-byte
//      aligned, else 4-byte copies): 2 x kT x 512 B, 64 KB at kT = 64, so
//      three blocks share an SM with up to 192 KB in flight.
//   2. Thread c scans its channel's column in shared memory with a zero
//      carry: the local h and the running product A_t of a, in place.
//   3. Decoupled look-back (Merrill and Garland's single-pass scan), per
//      channel: the tile publishes its aggregate (A_tile, h_tile), then
//      walks back over its time predecessors, folding each aggregate into
//      a running transform until it meets a published inclusive prefix (h
//      at the end of that tile); the first time tile publishes its
//      inclusive prefix at once. carry = that prefix pushed through the
//      folded transform; the tile then publishes its own inclusive prefix.
//   4. h_t = h_local,t + A_t * carry (the fold the Pallas kernel applies
//      between its blocks), written back as rows: 16-byte stores where the
//      loads were 16 bytes, else one coalesced float a thread a row.
// Each element of a and b is read once and each of h written once; the
// per-channel partials (12 B and a flag per tile and channel) add ~2.5% at
// the full shape.
//
// Memory ordering. Each thread publishes its own channel: plain stores of
// the partials, then st.release.gpu of the channel's flag (1 = aggregate,
// 2 = inclusive). A reader spins on ld.acquire.gpu of that flag and then
// reads the partials with ld.relaxed.gpu, so the flag never stands for
// data it was not ordered after. The flags and the ticket counter are
// zeroed by the wrapper before every call (torch.zeros, a memset node in a
// captured CUDA graph, so every replay starts clean); there is no epoch
// argument, which a graph replay would freeze.
//
// Rounding: the local scan walks time in order, as the plain version's
// loop does (here with fmaf); the carry enters each tile through A_t, so
// the two agree to ~1e-6 relative (phase 7 of chip_smoke.py holds 1e-4, whole
// tensor and per channel).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;                 // time steps a tile
constexpr int kC = 128;                // channels a tile = threads a block
constexpr uint32_t kAggregate = 1, kInclusive = 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ float load_relaxed(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];\n"
               : "=f"(v)
               : "l"(p)
               : "memory");
  return v;
}

// flags[k * kC + c] and the partials agg_a / agg_h / incl at the same index
// belong to channel c of the tile with ticket k.
template <bool kVec>
__global__ void __launch_bounds__(kC)
    rg_lru_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, uint32_t* ticket_counter,
                  uint32_t* flags, float* agg_a, float* agg_h, float* incl,
                  int32_t B, int32_t L, int32_t W, int32_t n_time,
                  int32_t n_stripes) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                    // a, then the running product A_t
  float* sb = smem + kT * kC;          // b, then the local h, then h
  __shared__ uint32_t s_ticket;
  const int c = threadIdx.x;
  if (c == 0) s_ticket = atomicAdd(ticket_counter, 1u);
  __syncthreads();
  const int64_t ticket = s_ticket;
  const int64_t chains = static_cast<int64_t>(B) * n_stripes;
  if (ticket >= chains * n_time) return;
  const int32_t tt = static_cast<int32_t>(ticket / chains);
  const int64_t r = ticket % chains;
  const int32_t bb = static_cast<int32_t>(r / n_stripes);
  const int32_t ss = static_cast<int32_t>(r % n_stripes);
  const int32_t t0 = tt * kT, nt = min(kT, L - t0);
  const int32_t c0 = ss * kC, nc = min(kC, W - c0);
  const int64_t base = (static_cast<int64_t>(bb) * L + t0) * W + c0;

  // 1. stage a and b
  if (kVec) {
    const int q = nc / 4;              // W % 4 == 0, so nc % 4 == 0
    for (int i = c; i < nt * (kC / 4); i += kC) {
      const int row = i / (kC / 4), j = i % (kC / 4);
      if (j < q) {
        const int64_t off = base + static_cast<int64_t>(row) * W + 4 * j;
        cp_async16(sa + row * kC + 4 * j, a + off);
        cp_async16(sb + row * kC + 4 * j, b + off);
      }
    }
  } else if (c < nc) {
    for (int row = 0; row < nt; ++row) {
      const int64_t off = base + static_cast<int64_t>(row) * W + c;
      cp_async4(sa + row * kC + c, a + off);
      cp_async4(sb + row * kC + c, b + off);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  if (c < nc) {
    // 2. local scan with a zero carry
    float hl = 0.0f, prod = 1.0f;
    for (int t = 0; t < nt; ++t) {
      const float at = sa[t * kC + c];
      hl = fmaf(at, hl, sb[t * kC + c]);
      prod *= at;
      sa[t * kC + c] = prod;
      sb[t * kC + c] = hl;
    }
    // 3. publish, look back, publish
    const int64_t me = ticket * kC + c;
    float carry = 0.0f;
    if (tt == 0) {
      incl[me] = hl;
      store_release(flags + me, kInclusive);
    } else {
      agg_a[me] = prod;
      agg_h[me] = hl;
      store_release(flags + me, kAggregate);
      float acc_a = 1.0f, acc_h = 0.0f;   // the tiles between j and me
      for (int64_t j = ticket - chains;; j -= chains) {
        const int64_t pj = j * kC + c;
        uint32_t st;
        while ((st = load_acquire(flags + pj)) == 0) {
        }
        if (st == kInclusive) {
          carry = fmaf(acc_a, load_relaxed(incl + pj), acc_h);
          break;
        }
        acc_h = fmaf(acc_a, load_relaxed(agg_h + pj), acc_h);
        acc_a *= load_relaxed(agg_a + pj);
      }
      incl[me] = fmaf(prod, carry, hl);
      store_release(flags + me, kInclusive);
    }
    // 4. fold the carry in
    if (kVec) {
      for (int t = 0; t < nt; ++t)
        sb[t * kC + c] = fmaf(sa[t * kC + c], carry, sb[t * kC + c]);
    } else {
      for (int t = 0; t < nt; ++t)
        h[base + static_cast<int64_t>(t) * W + c] =
            fmaf(sa[t * kC + c], carry, sb[t * kC + c]);
    }
  }
  if (kVec) {
    __syncthreads();
    const int q = nc / 4;
    for (int i = c; i < nt * (kC / 4); i += kC) {
      const int row = i / (kC / 4), j = i % (kC / 4);
      if (j < q)
        *reinterpret_cast<float4*>(h + base + static_cast<int64_t>(row) * W +
                                   4 * j) =
            *reinterpret_cast<const float4*>(sb + row * kC + 4 * j);
    }
  }
}

template <bool kVec>
int launch(const float* a, const float* b, float* h, uint32_t* scratch,
           float* partials, int B, int L, int W, int n_time, int n_stripes,
           int64_t n_tiles, cudaStream_t stream) {
  constexpr int smem = 2 * kT * kC * static_cast<int>(sizeof(float));
  auto* kernel = rg_lru_kernel<kVec>;
  static bool configured = false;   // set once, before any graph capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int64_t n = n_tiles * kC;
  kernel<<<static_cast<unsigned>(n_tiles), kC, smem, stream>>>(
      a, b, h, scratch, scratch + 1, partials, partials + n, partials + 2 * n,
      B, L, W, n_time, n_stripes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `scratch`: 1 + n_tiles * kC zeroed uint32 (the ticket counter, then the
// flags); `partials`: 3 * n_tiles * kC floats, uninitialised. T and C are
// the tile of the wrapper's scan_plan; any other than (kT, kC) is refused.
extern "C" int rg_lru_launch(const void* a, const void* b, void* h,
                             void* scratch, void* partials, int B, int L,
                             int W, int T, int C, void* stream) {
  if (B <= 0 || L <= 0 || W <= 0) return 0;
  if (T != kT || C != kC) return static_cast<int>(cudaErrorInvalidValue);
  const int n_time = static_cast<int>((static_cast<int64_t>(L) + kT - 1) / kT);
  const int n_stripes =
      static_cast<int>((static_cast<int64_t>(W) + kC - 1) / kC);
  const int64_t n_tiles = static_cast<int64_t>(B) * n_time * n_stripes;
  if (n_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = W % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a) |
                     reinterpret_cast<uintptr_t>(b) |
                     reinterpret_cast<uintptr_t>(h)) & 15) == 0;
  auto* fa = static_cast<const float*>(a);
  auto* fb = static_cast<const float*>(b);
  auto* fh = static_cast<float*>(h);
  auto* sc = static_cast<uint32_t*>(scratch);
  auto* pa = static_cast<float*>(partials);
  auto* st = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(fa, fb, fh, sc, pa, B, L, W, n_time, n_stripes,
                            n_tiles, st)
             : launch<false>(fa, fb, fh, sc, pa, B, L, W, n_time, n_stripes,
                             n_tiles, st);
}
