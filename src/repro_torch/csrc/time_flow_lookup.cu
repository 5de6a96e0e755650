// Time-flow table lookup for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/time_flow_lookup.py ::
// time_flow_lookup (body _kernel): for each packet, gather the K-slot row
// at (node, dst) of one slice's tables, count the valid slots (>= 0), pick
// slot hash % max(nvalid, 1) with the hash read as uint32_t, and write the
// (next hop, departure offset) pair. The plain version is
// time_flow_lookup_plain in src/repro_torch/kernels/time_flow_lookup.py.
//
// What bounds it. A packet in the mask reads its selector, node, dst and
// hash (up to 16 B), its node's slice offset where there are offsets
// (4 B), one table entry (the next-hop and departure rows, 2K
// int32: 32 B at K = 4, one L2 sector), and every packet reads 1 B of mask
// and writes 8 B. At full density and the fabric's 131,072 packets that
// is ~3.2 MB of streams, ~1 us at 3.35 TB/s: bytes bound the work, and the
// byte bound lies below the launch floor (~2.3 us for one packet, through
// a CUDA graph). At the main path's densities (a few percent of the
// packets need a lookup) the work is the 1.2 MB of mask and outputs, and
// the launch floor is the bound.
//
// Why not the TPU's design. The Pallas kernel keeps one slice's [N, D, K]
// tables whole in VMEM and gathers from there. At 108 ToRs and K = 4 the
// injection and transit tables of one slice take 373 KB, more than the
// 227 KB of shared memory a block may use, and staging them would cost
// every block more bytes than its packets read. So the tables stay in
// global memory, where a slice's rows stay resident in the 50 MB L2 after
// the first touches, and the design cuts the dependent trips to memory:
//
// * Packed rows. The fabric packs the two stacks into one [2, Tr, N, D,
//   2, K] table (core/fabric.py :: stack_tables), so an
//   entry's next-hop and departure rows are adjacent. A packet loads both
//   at once, with 16-byte ld.global.nc.v4 where K and the alignment allow
//   (V = 4 int32 a load), 8-byte where they allow only that (V = 2), else
//   scalar loads (V = 1; K in {1, 3}), all issued before any is used; the
//   valid count and the pick then run in registers. That is one dependent
//   trip after the streams, where a gather of the next-hop row, then of
//   the chosen slot in a separate departure stack, took two. The wrapper
//   picks V (kernels/time_flow_lookup.py :: vector_width); the two
//   separate [2, Tr, N, D, K] stacks of the TPU's form take the same
//   route with a row stride of K in place of 2K. Rows wider than kMaxK
//   slots take the two-trip wide route.
// * The mask first. A packet outside the optional [P] mask reads nothing
//   beyond its mask byte and gets (-1, 0), the pair of an empty slot. The
//   fabric passes the packets whose result it uses (injected or
//   re-looked-up at the fused site, in transit at the hop site).
// * The multipath hash in the kernel. Without a hash vector the kernel
//   forms hash32(i + t * 0x9E3779B9) of the packet's index i in native
//   uint32_t (the reference's mp_hash), which spares the host ~24 int64
//   elementwise launches a slice. t and the table slice tm are kernel
//   arguments. A scenario sweep (core/fabric.py :: simulate_fleet) lays its
//   scenarios' packets end to end and passes the packets per scenario as
//   hp: the kernel then hashes i mod hp, each packet's index within its
//   own scenario (one modulo, only when hp < P). A sharded run
//   (core/fabric.py :: simulate_sharded) gives each rank a block of the
//   packets and passes the block's first global index as hb: the kernel
//   then hashes hb + i, the packet's global index, as the reference's
//   sharded mp_hash does (one add).
// * A ToR's local slice. With the optional [N] phase_off (control-plane
//   clock skew, in whole slices), a packet at node n reads slice
//   (tm + phase_off[n]) mod Tr: one more 4-byte load, after the node's
//   (the [N] vector stays in L1 and L2). The offset is negative for a ToR whose clock runs
//   behind, so the modulo is a floor modulo (JAX's %), not C's truncating
//   one; the hash keeps the global slice t as its salt, as the
//   reference's does.
// * A ToR's table version. The reconfigure loop's versioned installs
//   give the table a version axis, [2, V, Tr, N, D, 2, K], and pass an
//   optional [N] vsel: the version (old, new or safe tables) that each
//   node reads in this slice. A packet at node n reads version vsel[n],
//   one more 4-byte load after the node's, beside its offset's; the
//   version is clamped into [0, V), as JAX clamps a gather. Without vsel
//   every node reads version 0, so V = 1 is the unversioned table, the
//   same route and the same bits.
//
// One thread handles one packet: four packets a thread, with 16-byte
// loads of the int32 streams, 4 bytes of mask and 16-byte stores, lost to
// it at every density (PERF.md section 6). The ragged tail is masked (no
// padding in device memory); selector, node and dst are clamped into the
// table, as JAX clamps a gather, so no input reads outside the tensors.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 8;  // slots held in registers; wider rows go wide

struct Lookup {
  const int32_t* rows_next;  // next-hop slots of entry 0
  const int32_t* rows_dep;   // departure slots of entry 0
  int64_t stride;            // int32 from one entry's rows to the next's
  int32_t V, Tr, N, D, K, tm;
  const int32_t* phase_off;  // [N] slice offset of each node, or null
  const int32_t* vsel;       // [N] table version of each node, or null: 0
  const int32_t* sel;        // [P] selectors, or null: sel_const for all
  int32_t sel_const;
  const int32_t* node;
  const int32_t* dst;
  const int32_t* hashv;      // [P] hash bits, or null: hash32(i + t * salt)
  uint32_t t;
  int64_t hp;                // hash period: packets hash i mod hp
  int64_t hb;                // hash base: added to the hashed index
  const uint8_t* mask;       // [P] bool, or null: every packet
  int32_t* out_next;
  int32_t* out_dep;
  int64_t P;
};

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// The first int32 of entry (sel, version, slice, node, dst)'s rows, inputs
// clamped; the version is 0 or node n's vsel[n], the slice tm or node n's
// local slice (tm + phase_off[n]) mod Tr.
__device__ __forceinline__ int64_t entry(const Lookup& a, int32_t s,
                                         int32_t n, int32_t d) {
  s = min(max(s, 0), 1);
  n = min(max(n, 0), a.N - 1);
  d = min(max(d, 0), a.D - 1);
  int64_t tm = a.tm;
  if (a.phase_off) {
    const int64_t r = (tm + __ldg(a.phase_off + n)) % a.Tr;  // in (-Tr, Tr)
    tm = r < 0 ? r + a.Tr : r;                               // floor modulo
  }
  int64_t v = 0;
  if (a.vsel) v = min(max(__ldg(a.vsel + n), 0), a.V - 1);
  return ((((static_cast<int64_t>(s) * a.V + v) * a.Tr + tm) * a.N + n) *
              a.D + d) * a.stride;
}

// Both rows of an entry into registers, V int32 a load, every load issued
// before any value is used.
template <int V>
__device__ __forceinline__ void load_rows(const Lookup& a, int64_t e,
                                          int32_t (&rn)[kMaxK],
                                          int32_t (&rd)[kMaxK]) {
#pragma unroll
  for (int k = 0; k < kMaxK; k += V) {
    if (k < a.K) {
      if constexpr (V == 4) {
        const int4 n = __ldg(reinterpret_cast<const int4*>(a.rows_next + e + k));
        const int4 d = __ldg(reinterpret_cast<const int4*>(a.rows_dep + e + k));
        rn[k] = n.x, rn[k + 1] = n.y, rn[k + 2] = n.z, rn[k + 3] = n.w;
        rd[k] = d.x, rd[k + 1] = d.y, rd[k + 2] = d.z, rd[k + 3] = d.w;
      } else if constexpr (V == 2) {
        const int2 n = __ldg(reinterpret_cast<const int2*>(a.rows_next + e + k));
        const int2 d = __ldg(reinterpret_cast<const int2*>(a.rows_dep + e + k));
        rn[k] = n.x, rn[k + 1] = n.y;
        rd[k] = d.x, rd[k + 1] = d.y;
      } else {
        rn[k] = __ldg(a.rows_next + e + k);
        rd[k] = __ldg(a.rows_dep + e + k);
      }
    }
  }
}

// Count the valid slots and pick one, in registers (the indices are
// compile-time after unrolling, so the rows never leave registers).
__device__ __forceinline__ int2 pick(const Lookup& a, const int32_t (&rn)[kMaxK],
                                     const int32_t (&rd)[kMaxK], uint32_t h) {
  int32_t nvalid = 0;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) nvalid += (k < a.K && rn[k] >= 0) ? 1 : 0;
  const uint32_t slot = h % static_cast<uint32_t>(max(nvalid, 1));
  int2 r = make_int2(rn[0], rd[0]);
#pragma unroll
  for (int k = 1; k < kMaxK; ++k)
    if (static_cast<uint32_t>(k) == slot) r = make_int2(rn[k], rd[k]);
  return r;
}

// Rows wider than kMaxK: count over the next-hop row, then load the slot.
__device__ __forceinline__ int2 pick_wide(const Lookup& a, int64_t e,
                                          uint32_t h) {
  int32_t nvalid = 0;
  for (int32_t k = 0; k < a.K; ++k)
    nvalid += __ldg(a.rows_next + e + k) >= 0 ? 1 : 0;
  const uint32_t slot = h % static_cast<uint32_t>(max(nvalid, 1));
  return make_int2(__ldg(a.rows_next + e + slot), __ldg(a.rows_dep + e + slot));
}

template <int V>
__global__ void __launch_bounds__(kThreads) tfl_kernel(const Lookup a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.P) return;
  int2 r = make_int2(-1, 0);  // the empty slot's pair
  // 1. the mask first: a packet outside it reads nothing more
  if (!a.mask || __ldg(a.mask + i)) {
    // 2. the packet's streams
    const int32_t s = a.sel ? __ldg(a.sel + i) : a.sel_const;
    const int64_t e = entry(a, s, __ldg(a.node + i), __ldg(a.dst + i));
    // the index in its scenario, or its global index in a sharded run
    const int64_t ih = a.hb + (a.hp < a.P ? i % a.hp : i);
    const uint32_t h =
        a.hashv ? static_cast<uint32_t>(__ldg(a.hashv + i))
                : hash32(static_cast<uint32_t>(ih) + a.t * 0x9E3779B9u);
    // 3. both rows in flight at once, then the pick in registers
    if (a.K <= kMaxK) {
      int32_t rn[kMaxK] = {}, rd[kMaxK] = {};
      load_rows<V>(a, e, rn, rd);
      r = pick(a, rn, rd, h);
    } else {
      r = pick_wide(a, e, h);
    }
  }
  a.out_next[i] = r.x;
  a.out_dep[i] = r.y;
}

template <int V>
cudaError_t launch_v(const Lookup& a, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((a.P + kThreads - 1) / kThreads);
  tfl_kernel<V><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// vec: int32 per row load (4, 2 or 1), as vector_width chose it. Refuses
// a vec that K, the stride or the rows' alignment does not allow.
extern "C" int tfl_launch(const void* rows_next, const void* rows_dep,
                          int64_t stride, int V, int Tr, int N, int D, int K,
                          int tm, const void* phase_off, const void* vsel,
                          const void* sel, int sel_const, const void* node,
                          const void* dst, const void* hashv, unsigned t,
                          int64_t hp, int64_t hb, const void* mask,
                          void* out_next, void* out_dep, int64_t P, int vec,
                          void* stream) {
  if (P <= 0) return 0;
  if (hp < 1 || hb < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool rows_ok = V >= 1 && (vec == 1 || vec == 2 || vec == 4) &&
                       K % vec == 0 &&
                       stride % vec == 0 && aligned(rows_next, 4 * vec) &&
                       aligned(rows_dep, 4 * vec);
  if (!rows_ok) return static_cast<int>(cudaErrorInvalidValue);
  const Lookup a{static_cast<const int32_t*>(rows_next),
                 static_cast<const int32_t*>(rows_dep),
                 stride, V, Tr, N, D, K, tm,
                 static_cast<const int32_t*>(phase_off),
                 static_cast<const int32_t*>(vsel),
                 static_cast<const int32_t*>(sel), sel_const,
                 static_cast<const int32_t*>(node),
                 static_cast<const int32_t*>(dst),
                 static_cast<const int32_t*>(hashv), t, hp, hb,
                 static_cast<const uint8_t*>(mask),
                 static_cast<int32_t*>(out_next),
                 static_cast<int32_t*>(out_dep), P};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = vec == 4   ? launch_v<4>(a, s)
                          : vec == 2 ? launch_v<2>(a, s)
                                     : launch_v<1>(a, s);
  return static_cast<int>(err);
}
