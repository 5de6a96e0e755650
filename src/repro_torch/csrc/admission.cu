// FIFO queue admission for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/admission.py ::
// admission_admit (body _kernel). Packet i is admitted iff it is wanted
// and (wanted bytes of its key at indices < i) + size <= cap[key];
// rejected packets' bytes still count. It also returns the admitted bytes
// per key. Not-wanted packets, and keys outside [0, num_keys), are parked
// on the sentinel key num_keys with size 0 and never admitted. The plain
// version is admission_admit_plain in src/repro_torch/kernels/admission.py.
//
// What bounds it: bytes, and at the fabric's sizes launch latency. The
// function itself moves 10 B per packet (key, size, want in; admitted out)
// and 8 B per key (cap in, used out): 1.4 MB at 131,072 packets and 11,772
// keys, well under a microsecond at 3.35 TB/s. A carry across blocks needs
// a per-tile per-key scratch; this design keeps it to tens of tiles (3 MB
// at that size) and never zeroes it.
//
// Design. The Pallas grid is sequential: it carries a per-key byte
// accumulator from tile to tile. Hopper runs blocks in no order, so the
// carry becomes three passes over tiles of `tile` packets (256 to 2,048,
// chosen by the wrapper: about one tile per SM, and tiles x num_keys near
// 2^20 at most), all
// integer and so exact and deterministic whatever the order of the atomics:
//   1. adm_tile_totals: one block per tile totals the wanted bytes of each
//      key of its tile in shared memory (shared atomics) and writes its row
//      scratch[tile, :] whole; it also zeroes its share of `used`.
//   2. adm_scan_tiles: an exclusive scan of scratch across tiles for each
//      key, in place. A block of 512 threads takes adjacent keys (coalesced
//      rows) and splits the tiles into groups of a few: each thread sums
//      its group, the group sums are scanned in shared memory, and each
//      thread rewrites its group with running offsets.
//   3. adm_decide: one block per tile loads its offset row into shared
//      memory as a running per-key total, and stages its packets (key,
//      size, cap[key]) in steps of 32 (a warp's width): every warp takes
//      some steps and finds each
//      packet's same-key peers in the step (__match_any_sync), their
//      exclusive byte prefix and the step's total per key (pointer jumping
//      over the peers in lane order, five rounds of shuffles). One warp then
//      walks the steps in index order: each packet's prefix is the running
//      total of its key plus its in-step prefix, and the last lane of each
//      key adds the step's total to the running total before the next step.
//      Then every warp decides its packets; the admitted bytes of each key
//      gather in shared memory and reach used[key] in one global atomic
//      per key of the tile.
// A single tile needs no carry: pass 3 alone runs, from zero totals.
// Keys above kSmemKeys (N (N + 1) keys of a fabric of more than 216 ToRs)
// do not fit shared memory: that route zeroes the scratch
// (cudaMemsetAsync), builds the rows with global atomics in pass 1, and
// walks the tile's running totals in its own scratch row in pass 3. Sums
// are int32, as in the reference: the total of wanted bytes must stay
// below 2^31.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;     // threads of a pass 1 or pass 3 block
constexpr int kWarps = kThreads / 32;
constexpr int kTileMax = 2048;    // packets per tile at most
constexpr int kSmemKeys = 47104;  // keys the shared-memory route holds
constexpr int kScanThreads = 512;   // keys x tile groups of a scan block
constexpr int kScanPer = 8;         // tiles a scan thread holds at most
constexpr unsigned kFull = 0xffffffffu;

// Key and want are read side by side (no load waits on another).
__device__ __forceinline__ int32_t parked_key(const int32_t* key,
                                              const bool* want,
                                              int32_t num_keys, int64_t i) {
  const int32_t k = key[i];
  const bool w = want[i];
  return (w && k >= 0 && k < num_keys) ? k : -1;
}

// The inclusive sum of v over this lane's key group (`peers`, from
// __match_any_sync) in lane order: pointer jumping along each lane's
// nearest lower peer, five rounds for 32 lanes.
__device__ __forceinline__ int32_t group_inclusive(int32_t v, unsigned peers,
                                                   int lane) {
  const unsigned lower = peers & ((1u << lane) - 1u);
  int prev = lower ? 31 - __clz(lower) : -1;
#pragma unroll
  for (int d = 0; d < 5; ++d) {
    const int src = prev < 0 ? lane : prev;
    const int32_t pv = __shfl_sync(kFull, v, src);
    const int pp = __shfl_sync(kFull, prev, src);
    if (prev >= 0) {
      v += pv;
      prev = pp;
    }
  }
  return v;
}

// Rows of num_keys int32 in shared memory and in the scratch: 16 bytes a
// thread at a time where num_keys is a multiple of 4 (then every row is
// 16-byte aligned), else 4.
__device__ __forceinline__ void zero_row(int32_t* row, int32_t n) {
  if ((n & 3) == 0) {
    for (int32_t i = threadIdx.x; i < n / 4; i += kThreads)
      reinterpret_cast<int4*>(row)[i] = make_int4(0, 0, 0, 0);
  } else {
    for (int32_t i = threadIdx.x; i < n; i += kThreads) row[i] = 0;
  }
}

__device__ __forceinline__ void copy_row(int32_t* dst, const int32_t* src,
                                         int32_t n) {
  if ((n & 3) == 0) {
    for (int32_t i = threadIdx.x; i < n / 4; i += kThreads)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
  } else {
    for (int32_t i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  }
}

// Start an asynchronous copy of a scratch row into shared memory.
__device__ __forceinline__ void load_row_async(int32_t* dst,
                                               const int32_t* src,
                                               int32_t n) {
  const bool vec = (n & 3) == 0;
  for (int32_t i = threadIdx.x; i < (vec ? n / 4 : n); i += kThreads) {
    const uint32_t d = static_cast<uint32_t>(
        __cvta_generic_to_shared(dst + (vec ? 4 * i : i)));
    const int32_t* s = src + (vec ? 4 * i : i);
    if (vec)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(s)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(s)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    adm_tile_totals(const int32_t* __restrict__ key,
                    const int32_t* __restrict__ size,
                    const bool* __restrict__ want, int32_t num_keys,
                    int64_t P, int32_t tile, bool smem,
                    int32_t* __restrict__ tot, int32_t* __restrict__ used) {
  extern __shared__ __align__(16) int32_t hist[];   // [num_keys], shared route
  const int64_t t = blockIdx.x, i0 = t * tile;
  const int64_t i1 = i0 + tile < P ? i0 + tile : P;
  int32_t* row = tot + t * num_keys;
  // this block's share of used[] starts at zero (pass 3 adds to it)
  const int32_t share = (num_keys + gridDim.x - 1) / gridDim.x;
  for (int32_t k = t * share + threadIdx.x;
       k < num_keys && k < (t + 1) * share; k += kThreads)
    used[k] = 0;
  if (!smem) {   // the scratch was zeroed: global atomics into the row
#pragma unroll 4
    for (int64_t i = i0 + threadIdx.x; i < i1; i += kThreads) {
      const int32_t k = parked_key(key, want, num_keys, i);
      if (k >= 0) atomicAdd(row + k, size[i]);
    }
    return;
  }
  zero_row(hist, num_keys);
  __syncthreads();
#pragma unroll 4
  for (int64_t i = i0 + threadIdx.x; i < i1; i += kThreads) {
    const int32_t k = parked_key(key, want, num_keys, i);
    const int32_t s = size[i];
    if (k >= 0) atomicAdd(hist + k, s);
  }
  __syncthreads();
  copy_row(row, hist, num_keys);
}

// An exclusive scan of scratch[:, k] across the tiles for each key k, in
// place. blockDim = (keys, groups), keys x groups = kScanThreads: each
// thread holds its group's consecutive tiles of one key in registers (up
// to kScanPer of them; a longer group is read twice), the group sums are
// scanned in shared memory, and the thread writes its tiles' running
// offsets.
__global__ void __launch_bounds__(kScanThreads)
    adm_scan_tiles(int32_t* __restrict__ tot, int32_t num_keys,
                   int64_t tiles) {
  __shared__ int32_t part[kScanThreads + kScanThreads / 8];   // + padding
  const int groups = blockDim.y, keys = blockDim.x;
  const int32_t k = blockIdx.x * keys + threadIdx.x;
  const int per = static_cast<int>((tiles + groups - 1) / groups);
  const int64_t t0 = static_cast<int64_t>(threadIdx.y) * per;
  const int64_t t1 = t0 + per < tiles ? t0 + per : tiles;
  const bool held = per <= kScanPer;   // else the group is read twice
  int32_t v[kScanPer], sum = 0;
  if (held) {
#pragma unroll
    for (int u = 0; u < kScanPer; ++u) {
      v[u] = k < num_keys && t0 + u < t1 ? tot[(t0 + u) * num_keys + k] : 0;
      sum += v[u];
    }
  } else if (k < num_keys) {
#pragma unroll 8
    for (int64_t t = t0; t < t1; ++t) sum += tot[t * num_keys + k];
  }
  part[threadIdx.y * (keys + 1) + threadIdx.x] = sum;
  __syncthreads();
  int32_t run = 0;
  for (int g = 0; g < static_cast<int>(threadIdx.y); ++g)
    run += part[g * (keys + 1) + threadIdx.x];
  if (k >= num_keys) return;
  if (held) {
#pragma unroll
    for (int u = 0; u < kScanPer; ++u) {
      if (t0 + u < t1) tot[(t0 + u) * num_keys + k] = run;
      run += v[u];
    }
  } else {
#pragma unroll 8
    for (int64_t t = t0; t < t1; ++t) {
      const int64_t idx = t * num_keys + k;
      const int32_t x = tot[idx];
      tot[idx] = run;
      run += x;
    }
  }
}

struct Staged {     // per packet of the tile, in shared memory
  int32_t key[kTileMax];    // parked key, -1 when never admitted
  int32_t size[kTileMax];   // wanted bytes (0 when parked)
  int32_t cap[kTileMax];    // cap[key] (0 when parked)
  int32_t pre[kTileMax];    // in-step exclusive prefix; after the walk,
                            // the packet's whole prefix
  int32_t grp[kTileMax];    // the key's total in the step (last lane only)
  uint8_t last[kTileMax];   // the last lane of its key in the step
};

__global__ void __launch_bounds__(kThreads)
    adm_decide(const int32_t* __restrict__ key,
               const int32_t* __restrict__ size,
               const bool* __restrict__ want,
               const int32_t* __restrict__ cap, int32_t num_keys, int64_t P,
               int32_t tile, bool smem, int32_t* __restrict__ off,
               bool* __restrict__ admitted, int32_t* __restrict__ used) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Staged& st = *reinterpret_cast<Staged*>(smem_raw);
  const int64_t t = blockIdx.x, i0 = t * tile;
  const int n = static_cast<int>(i0 + tile < P ? tile : P - i0);
  const int steps = (n + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the running per-key totals: the tile's offset row, in shared memory or
  // in place in the scratch; a lone tile (off == nullptr) starts from zero
  // and zeroes used[] itself
  int32_t* run = off + t * num_keys;
  if (smem) {   // the row, copied asynchronously: every load in flight
    int32_t* srun = reinterpret_cast<int32_t*>(smem_raw + sizeof(Staged));
    if (off != nullptr) {
      load_row_async(srun, run, num_keys);
    } else {
      zero_row(srun, num_keys);
      zero_row(used, num_keys);
    }
    run = srun;
  }
  // the tile's packets: every thread's loads in flight together, then
  // the capacities of their keys
  constexpr int kPer = kTileMax / kThreads;
  int32_t kk[kPer], ss[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = threadIdx.x + u * kThreads;
    kk[u] = j < n ? parked_key(key, want, num_keys, i0 + j) : -1;
    ss[u] = j < n ? size[i0 + j] : 0;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = threadIdx.x + u * kThreads;
    if (j < 32 * steps) {
      st.key[j] = kk[u];
      st.size[j] = kk[u] >= 0 ? ss[u] : 0;
      st.cap[j] = kk[u] >= 0 ? cap[kk[u]] : 0;
    }
  }
  __syncthreads();
  for (int s = warp; s < steps; s += kWarps) {
    const int j = 32 * s + lane;
    const int32_t k = st.key[j], sz = st.size[j];
    const unsigned peers = __match_any_sync(kFull, k);
    const int32_t incl = group_inclusive(sz, peers, lane);
    st.pre[j] = incl - sz;
    st.grp[j] = incl;
    st.last[j] = (peers >> lane) == 1u;   // no peer above this lane
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (warp == 0) {   // the serial walk, one step of 32 packets at a time
    constexpr int kChunk = 8;   // steps whose staged values are read ahead
    for (int s0 = 0; s0 < steps; s0 += kChunk) {
      int32_t kk[kChunk], pre[kChunk], grp[kChunk];
      bool last[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int j = 32 * (s0 + u) + lane;
        const bool in = s0 + u < steps;
        kk[u] = in ? st.key[j] : -1;
        pre[u] = in ? st.pre[j] : 0;
        grp[u] = in ? st.grp[j] : 0;
        last[u] = in && st.last[j];
      }
      // the chain from one step to the next: a read of the running total,
      // and the write of its key's last lane
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int32_t k = kk[u];
        const int32_t r = k >= 0 ? run[k] : 0;
        pre[u] += r;
        __syncwarp();
        if (k >= 0 && last[u]) run[k] = r + grp[u];
        __syncwarp();
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
        if (s0 + u < steps) st.pre[32 * (s0 + u) + lane] = pre[u];
    }
  }
  __syncthreads();
  // the running totals are done with: on the shared route they now gather
  // the tile's admitted bytes per key, so used[] takes one global atomic
  // per key of the tile (many packets of few keys would queue on a few
  // addresses otherwise)
  if (smem) {
    zero_row(run, num_keys);
    __syncthreads();
  }
  for (int s = warp; s < steps; s += kWarps) {
    const int j = 32 * s + lane;
    const int32_t k = st.key[j], sz = st.size[j];
    const bool adm = k >= 0 && static_cast<int64_t>(st.pre[j]) + sz <=
                                   static_cast<int64_t>(st.cap[j]);
    if (j < n) admitted[i0 + j] = adm;
    const unsigned peers = __match_any_sync(kFull, k);
    const int32_t got = group_inclusive(adm ? sz : 0, peers, lane);
    if (k >= 0 && st.last[j] && got != 0)
      atomicAdd((smem ? run : used) + k, got);
  }
  if (smem) {
    __syncthreads();
    for (int32_t k = threadIdx.x; k < num_keys; k += kThreads)
      if (run[k] != 0) atomicAdd(used + k, run[k]);
  }
}

}  // namespace

// The largest num_keys of the shared-memory route.
extern "C" int adm_smem_keys() { return kSmemKeys; }

// Launch the three passes on `stream`; returns the first cudaError_t
// (0 = success). `scratch` holds ceil(P / tile) x num_keys int32; `tile`
// is a multiple of 32 of at most 2,048 packets.
extern "C" int adm_launch(const void* key, const void* size, const void* want,
                          const void* cap, int num_keys, int64_t P, int tile,
                          void* scratch, void* admitted, void* used,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile <= 0 || tile % 32 != 0 || tile > kTileMax || num_keys <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P <= 0)
    return static_cast<int>(
        cudaMemsetAsync(used, 0, sizeof(int32_t) * num_keys, st));
  const int64_t tiles = (P + tile - 1) / tile;
  if (tiles >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const bool smem = num_keys <= kSmemKeys;
  const size_t hist_bytes = smem ? sizeof(int32_t) * num_keys : 0;
  const size_t decide_bytes = sizeof(Staged) + hist_bytes;
  static bool configured = false;   // set once, before any graph capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        adm_tile_totals, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(int32_t) * kSmemKeys));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          adm_decide, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(sizeof(Staged) + sizeof(int32_t) * kSmemKeys));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const auto* k = static_cast<const int32_t*>(key);
  const auto* sz = static_cast<const int32_t*>(size);
  const auto* w = static_cast<const bool*>(want);
  auto* tot = static_cast<int32_t*>(scratch);
  auto* u = static_cast<int32_t*>(used);
  cudaError_t err = cudaSuccess;
  if (tiles == 1 && smem) {   // no carry across tiles: one launch
    adm_decide<<<1, kThreads, decide_bytes, st>>>(
        k, sz, w, static_cast<const int32_t*>(cap), num_keys, P, tile, smem,
        nullptr, static_cast<bool*>(admitted), u);
    return static_cast<int>(cudaGetLastError());
  }
  if (!smem &&
      (err = cudaMemsetAsync(scratch, 0, sizeof(int32_t) * tiles * num_keys,
                             st)) != cudaSuccess)
    return static_cast<int>(err);
  adm_tile_totals<<<static_cast<unsigned>(tiles), kThreads, hist_bytes, st>>>(
      k, sz, w, num_keys, P, tile, smem, tot, u);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // tile groups of four to seven tiles where there are enough (of more
  // beyond 511 tiles), the rest of the block's threads on keys
  int groups = 1;
  while (groups < kScanThreads / 8 && tiles >= 8ll * groups) groups *= 2;
  const int keys = kScanThreads / groups;
  adm_scan_tiles<<<(num_keys + keys - 1) / keys, dim3(keys, groups), 0,
                   st>>>(tot, num_keys, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  adm_decide<<<static_cast<unsigned>(tiles), kThreads, decide_bytes, st>>>(
      k, sz, w, static_cast<const int32_t*>(cap), num_keys, P, tile, smem,
      tot, static_cast<bool*>(admitted), u);
  return static_cast<int>(cudaGetLastError());
}
