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
// and 8 B per key (cap in, used out): 1.4 MB at 131,072 packets and
// 11,772 keys, well under a microsecond at 3.35 TB/s. This kernel also
// moves a scratch of tiles x num_keys int32 (24 MB at that size) three
// times, which makes it some ten times that bound.
//
// Design. The Pallas grid is sequential: it carries a per-key byte
// accumulator from tile to tile in a block every grid step revisits.
// Hopper runs blocks in no order, so the carry becomes three passes, all
// integer and so exact and deterministic whatever the order of the
// atomics:
//   1. adm_tile_totals: one block per tile of kTile packets totals the
//      wanted bytes of each key into scratch[tile, key] (global atomics).
//   2. adm_scan_tiles: an exclusive scan of scratch across tiles for each
//      key, in place. A block takes 32 adjacent keys (coalesced rows) and
//      splits the tiles into 32 groups: each thread sums its group, the
//      group sums are scanned in shared memory, and each thread rewrites
//      its group with running offsets.
//   3. adm_decide: one block per tile again. The tile's keys and sizes go
//      to shared memory; thread i adds the sizes of same-key packets
//      earlier in the tile (O(kTile) broadcast reads), adds the tile
//      offset of pass 2, decides, and atomically adds admitted bytes to
//      used[key].
// The scratch and `used` are zeroed here with cudaMemsetAsync, on the
// caller's stream like the kernels. Sums are int32, as in the reference:
// the total of wanted bytes must stay below 2^31.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;      // packets per tile = threads per block
constexpr int kScanKeys = 32;   // keys per scan block
constexpr int kScanGroups = 32; // tile groups per scan block

__device__ __forceinline__ int32_t parked_key(const int32_t* key,
                                              const bool* want,
                                              int32_t num_keys, int64_t i) {
  if (!want[i]) return -1;
  const int32_t k = key[i];
  return (k >= 0 && k < num_keys) ? k : -1;
}

__global__ void adm_tile_totals(const int32_t* __restrict__ key,
                                const int32_t* __restrict__ size,
                                const bool* __restrict__ want,
                                int32_t num_keys, int64_t P,
                                int32_t* __restrict__ tot) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  if (i >= P) return;
  const int32_t k = parked_key(key, want, num_keys, i);
  if (k < 0) return;
  atomicAdd(tot + static_cast<int64_t>(blockIdx.x) * num_keys + k, size[i]);
}

__global__ void adm_scan_tiles(int32_t* __restrict__ tot, int32_t num_keys,
                               int64_t tiles) {
  __shared__ int32_t part[kScanGroups][kScanKeys + 1];
  const int32_t k = blockIdx.x * kScanKeys + threadIdx.x;
  const int64_t per = (tiles + kScanGroups - 1) / kScanGroups;
  const int64_t t0 = static_cast<int64_t>(threadIdx.y) * per;
  const int64_t t1 = t0 + per < tiles ? t0 + per : tiles;
  int32_t sum = 0;
  if (k < num_keys)
    for (int64_t t = t0; t < t1; ++t) sum += tot[t * num_keys + k];
  part[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  int32_t run = 0;
  for (int g = 0; g < static_cast<int>(threadIdx.y); ++g)
    run += part[g][threadIdx.x];
  if (k >= num_keys) return;
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t idx = t * num_keys + k;
    const int32_t v = tot[idx];
    tot[idx] = run;
    run += v;
  }
}

__global__ void adm_decide(const int32_t* __restrict__ key,
                           const int32_t* __restrict__ size,
                           const bool* __restrict__ want,
                           const int32_t* __restrict__ cap, int32_t num_keys,
                           int64_t P, const int32_t* __restrict__ off,
                           bool* __restrict__ admitted,
                           int32_t* __restrict__ used) {
  __shared__ int32_t s_key[kTile];
  __shared__ int32_t s_size[kTile];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  int32_t k = -1, s = 0;
  if (i < P) {
    k = parked_key(key, want, num_keys, i);
    if (k >= 0) s = size[i];
  }
  s_key[threadIdx.x] = k;
  s_size[threadIdx.x] = s;
  __syncthreads();
  if (i >= P) return;
  if (k < 0) {
    admitted[i] = false;
    return;
  }
  int32_t pre = 0;  // same-key wanted bytes earlier in this tile
  for (int j = 0; j < static_cast<int>(threadIdx.x); ++j)
    pre += s_key[j] == k ? s_size[j] : 0;
  const int64_t prefix =
      static_cast<int64_t>(off[static_cast<int64_t>(blockIdx.x) * num_keys + k]) +
      pre;
  const bool adm = prefix + s <= static_cast<int64_t>(cap[k]);
  admitted[i] = adm;
  if (adm) atomicAdd(used + k, s);
}

}  // namespace

// Packets per tile: the caller sizes the scratch as ceil(P / tile) x
// num_keys int32.
extern "C" int adm_tile_size() { return kTile; }

// Launch the three passes on `stream`; returns the first cudaError_t
// (0 = success).
extern "C" int adm_launch(const void* key, const void* size, const void* want,
                          const void* cap, int num_keys, int64_t P,
                          void* scratch, void* admitted, void* used,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(used, 0, sizeof(int32_t) * num_keys, st);
  if (err != cudaSuccess || P <= 0) return static_cast<int>(err);
  const int64_t tiles = (P + kTile - 1) / kTile;
  err = cudaMemsetAsync(scratch, 0, sizeof(int32_t) * tiles * num_keys, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* k = static_cast<const int32_t*>(key);
  const auto* sz = static_cast<const int32_t*>(size);
  const auto* w = static_cast<const bool*>(want);
  auto* tot = static_cast<int32_t*>(scratch);
  adm_tile_totals<<<static_cast<unsigned>(tiles), kTile, 0, st>>>(
      k, sz, w, num_keys, P, tot);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  adm_scan_tiles<<<(num_keys + kScanKeys - 1) / kScanKeys,
                   dim3(kScanKeys, kScanGroups), 0, st>>>(tot, num_keys,
                                                          tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  adm_decide<<<static_cast<unsigned>(tiles), kTile, 0, st>>>(
      k, sz, w, static_cast<const int32_t*>(cap), num_keys, P, tot,
      static_cast<bool*>(admitted), static_cast<int32_t*>(used));
  return static_cast<int>(cudaGetLastError());
}
