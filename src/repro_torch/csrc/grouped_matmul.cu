// Grouped matmul (the MoE expert products) for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_matmul.py ::
// grouped_matmul (body _kernel): out[g] = x[g] @ w[g] for x [G, M, K] and
// w [G, K, N] in bfloat16, summed in float32 and rounded once to bfloat16
// (grouped_matmul_ref in src/repro/kernels/ref.py). The plain version is
// grouped_matmul_plain in src/repro_torch/kernels/grouped_matmul.py.
//
// What bounds it: at the MoE prefill of Qwen3-30B-A3B (G = 128 experts,
// M = 960 capacity rows, K x N = 2048 x 768 or 768 x 2048) operations: each
// byte feeds ~350 flops, above the card's ~295 flop/B balance point for
// bfloat16. At decode (M = 1) bytes: every expert's weights (403 MB) for a
// single row each, of which at batch 4 and top-8 at most 32 experts have a
// token; the dispatch zero-fills the rows of the others.
//
// Design: three routes, chosen by shape before the launch.
//
// gmm_kernel_wgmma (M > 16, or x[g] larger than the streaming route holds;
// K and N multiples of 8 and 16-byte aligned bases, so TMA can describe
// the tensors). Output tiles of (group, 128 rows, 256 columns); one
// persistent block per SM walks the tiles. One producer thread keeps TMA
// loads (cp.async.bulk.tensor over 3-D tensor maps of x [G, M, K] and w
// [G, K, N], 128-byte swizzle) in flight through a 3-stage ring of shared
// memory with full / empty mbarriers, across tile boundaries. Two consumer
// warpgroups each run wgmma m64n256k16 (bfloat16 in, float32 accumulate in
// 128 registers a thread) on 64 rows of the tile, one stage's products in
// flight while the previous stage's buffer is handed back, then stage
// their rows in shared memory for TMA stores and go on to the next tile
// while the stores drain. TMA zero-fills the ragged M tile (960 = 7.5 x
// 128) and ragged K and N per expert on load, never reading the next
// expert's rows, and clips them on store. w is stored N-contiguous
// (MN-major): the B operand takes it as it is through wgmma's transpose
// bit, so the weights need no transposing copy. cuTensorMapEncodeTiled
// comes through cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// gmm_kernel_stream (M <= 16 and x[g] within 32 KB; the decode, M = 1). A
// block owns (group g, 128 columns of N): it reads x[g] into shared memory
// and tests it for zero first. An all-zero x[g] gives zero output (0 * w
// = 0 for finite w), so the block stores zeros and reads nothing of w[g]:
// at Qwen3-30B-A3B's decode at most 32 of 128 experts' weights are read.
// Otherwise 16 K partitions of 16 threads stream the slice of w[g] with
// 16-byte loads, 4 to 8 rows in flight per thread, accumulate M x 8 float32
// values a thread, and are summed through shared memory.
//
// gmm_kernel_f32 (float32 inputs, grouped_matmul_f32_launch): plain FMA
// tiles, no tensor cores and no TF32, so the products keep float32's
// precision, as the Pallas kernel's float32 path accumulates in float32. A
// block of 256 threads owns a (group, 64-row, 64-column) tile; K advances
// 16 deep through two shared-memory tiles (x transposed), each thread
// accumulating 4 x 4 outputs strided by 16 rows and columns.
//
// gmm_kernel_mma (K or N not a multiple of 8, or a base pointer not 16-byte
// aligned, where a 16-byte or TMA copy could straddle an edge): one block
// of four warps per (group, 64-row, 128-column) tile, K in 32-deep steps
// through a 3-stage ring loaded element by element, mma.sync m16n8k16 fed
// by ldmatrix (A) and ldmatrix.trans (w). Rows of the A and B tiles are
// padded by 8 elements so each ldmatrix phase hits 32 distinct banks.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// -- gmm_kernel_mma: the element route ---------------------------------------

constexpr int kBM = 64;        // rows of x per block
constexpr int kBN = 128;       // columns of w per block
constexpr int kBK = 32;        // depth of one K step
constexpr int kStages = 3;     // K steps held in shared memory
constexpr int kThreads = 128;  // four warps, 2 x 2 over the 64 x 128 tile
constexpr int kAS = kBK + 8;   // row stride (elements) of the A tile
constexpr int kBS = kBN + 8;   // row stride of the B tile
constexpr int kATile = kBM * kAS;
constexpr int kBTile = kBK * kBS;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bfloat16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One K step: the A tile x[m0:m0+64, k0:k0+32] and the B tile
// w[k0:k0+32, n0:n0+128] of this block's group, element by element, zero
// outside the matrices.
__device__ __forceinline__ void load_step(__nv_bfloat16* As,
                                          __nv_bfloat16* Bs,
                                          const __nv_bfloat16* xg,
                                          const __nv_bfloat16* wg, int m0,
                                          int n0, int k0, int M, int N, int K,
                                          int tid) {
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    const int gm = m0 + r, gk = k0 + c;
    __nv_bfloat16* dst = As + r * kAS + c;
    const __nv_bfloat16* src = xg + static_cast<int64_t>(gm) * K + gk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[j] = (gm < M && gk + j < K) ? src[j] : zero;
  }
  for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    const int gk = k0 + r, gn = n0 + c;
    __nv_bfloat16* dst = Bs + r * kBS + c;
    const __nv_bfloat16* src = wg + static_cast<int64_t>(gk) * N + gn;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[j] = (gk < K && gn + j < N) ? src[j] : zero;
  }
}

__global__ void __launch_bounds__(kThreads)
    gmm_kernel_mma(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ out, int32_t M, int32_t K,
                   int32_t N) {
  // raw storage: a __shared__ array of a class type must not need a
  // constructor
  __shared__ __align__(16) uint16_t a_raw[kStages * kATile];
  __shared__ __align__(16) uint16_t b_raw[kStages * kBTile];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(a_raw);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(b_raw);

  const int64_t g = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const __nv_bfloat16* xg = x + g * M * K;
  const __nv_bfloat16* wg = w + g * K * N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_step(As + s * kATile, Bs + s * kBTile, xg, wg, m0, n0, s * kBK,
                M, N, K, tid);
  }

  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();   // step kt is stored; step kt-1 is consumed
    const int next = kt + kStages - 1;
    if (next < nk)
      load_step(As + (next % kStages) * kATile,
                Bs + (next % kStages) * kBTile, xg, wg, m0, n0, next * kBK, M,
                N, K, tid);

    const __nv_bfloat16* A = As + (kt % kStages) * kATile;
    const __nv_bfloat16* B = Bs + (kt % kStages) * kBTile;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // lanes 0-15 address rows 0-15 at column kk, lanes 16-31 the same
      // rows at kk + 8: the four 8 x 8 pieces of a 16 x 16 fragment
      const int fr = lane & 15, fc = (lane >> 4) * 8;
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], A + (wm + mi * 16 + fr) * kAS + kk + fc);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, B + (kk + fr) * kBS + wn + nj * 16 + fc);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  }

  __nv_bfloat16* og = out + g * M * N;
  const bool pairs = (N & 1) == 0;   // two columns as one aligned 32-bit store
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + (lane >> 2) + 8 * h;
        const int col = n0 + wn + ni * 8 + 2 * (lane & 3);
        if (row >= M || col >= N) continue;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        __nv_bfloat16* o = og + static_cast<int64_t>(row) * N + col;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);
          if (col + 1 < N) o[1] = __float2bfloat16(v1);
        }
      }
}


// -- gmm_kernel_wgmma: TMA + wgmma ------------------------------------------

constexpr int kWM = 128;        // rows of x per tile, 64 per consumer
constexpr int kWN = 256;        // columns of w per tile
constexpr int kWK = 64;         // depth of one stage: 128 bytes of bfloat16
constexpr int kWStages = 3;
constexpr int kWThreads = 384;  // a producer warpgroup, two consumers
constexpr int kATileBytes = kWM * kWK * 2;
constexpr int kBPartBytes = kWK * 64 * 2;   // 64 columns: one swizzle atom
constexpr int kBParts = kWN / 64;
constexpr int kStageBytes = kATileBytes + kBParts * kBPartBytes;
constexpr int kCPartBytes = 64 * 64 * 2;    // 64 rows x 64 columns of out
constexpr int kCBytes = 2 * kBParts * kCPartBytes;   // both consumers' rows
constexpr size_t kWSmem =
    1024 + kWStages * kStageBytes + kCBytes + 2 * kWStages * 8;

// d += A (64 x 16, K-major) * B (16 x 256, MN-major), both from shared
// memory; the immediates: scale A and B by 1, A not transposed, B
// transposed.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


struct Tile {
  int g, m0, n0;
};

// Tiles in (group, M tile, N tile) order: the blocks in flight at once
// share x rows and a few groups' w in L2.
__device__ __forceinline__ Tile tile_of(int t, int tiles_m, int tiles_n) {
  const int nt = t % tiles_n, rest = t / tiles_n;
  return Tile{rest / tiles_m, (rest % tiles_m) * kWM, nt * kWN};
}

// Persistent: block b takes tiles b, b + gridDim.x, ...; the producer's
// ring runs across tile boundaries, so the next tile's loads are in flight
// while the consumers store this one. A consumer rounds its 64 x 256 piece
// to bfloat16 into shared memory (128-byte swizzle, so the stores of a warp
// hit distinct banks) and one of its threads hands it to TMA stores, which
// clip rows past M and columns past N; the warpgroup goes on to the next
// tile while they drain.
__global__ void __launch_bounds__(kWThreads, 1)
    gmm_kernel_wgmma(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap to, int32_t G,
                     int32_t M, int32_t K, int32_t N) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: align the ring to it
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* cbuf = ring + kWStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(cbuf + kCBytes);
  uint64_t* empty = full + kWStages;

  const int tid = threadIdx.x, wg = tid / 128;
  const int tiles_m = (M + kWM - 1) / kWM, tiles_n = (N + kWN - 1) / kWN;
  const int n_tiles = G * tiles_m * tiles_n;
  const int n_kb = (K + kWK - 1) / kWK;
  if (tid == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full + s, 1);    // the producer's arrive + the TMA bytes
      mbar_init(empty + s, 8);   // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0;   // stages filled so far, over all tiles
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tl = tile_of(t, tiles_m, tiles_n);
        for (int kb = 0; kb < n_kb; ++kb, ++it) {
          const int s = it % kWStages;
          if (it >= kWStages) mbar_wait(empty + s, (it / kWStages - 1) & 1);
          unsigned char* a = ring + s * kStageBytes;
          mbar_expect_tx(full + s, kStageBytes);
          tma_load(a, &tx, full + s, kb * kWK, tl.m0, tl.g);
#pragma unroll
          for (int part = 0; part < kBParts; ++part)
            tma_load(a + kATileBytes + part * kBPartBytes, &tw, full + s,
                     tl.n0 + 64 * part, kb * kWK, tl.g);
        }
      }
    }
  } else {   // consumer c owns rows c*64 .. c*64+63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, lane = tid & 31, warp = (tid & 127) >> 5;
    int it = 0;   // stages consumed so far, over all tiles
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Tile tl = tile_of(t, tiles_m, tiles_n);
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (int kb = 0; kb < n_kb; ++kb, ++it) {
        const int s = it % kWStages;
        mbar_wait(full + s, (it / kWStages) & 1);
        const uint32_t a = smem_addr(ring + s * kStageBytes) + c * 64 * 128;
        const uint32_t b = smem_addr(ring + s * kStageBytes + kATileBytes);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kWK / 16; ++kk)
          // A: rows of 128 bytes, 8-row groups 1,024 bytes apart, the k
          // step 32 bytes along the row; B: 16 k rows (2,048 bytes) per
          // step, the 64-column parts 8,192 bytes apart
          wgmma_m64n256k16(acc, gmma_desc(a + kk * 32, 1, 64),
                           gmma_desc(b + kk * 2048, kBPartBytes / 16, 64));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the previous stage's products are done: hand its buffer back
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
        prev = s;
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);

      // accumulator fragment: register 4j + 2h + e holds row 16*warp +
      // lane/4 + 8h, column 8j + 2*(lane%4) + e of the consumer's piece;
      // part p of the staging buffer holds its columns 64p .. 64p+63, row r
      // at 128 r bytes with its 16-byte chunks permuted by r % 8
      unsigned char* cb = cbuf + c * kBParts * kCPartBytes;
      if ((tid & 127) == 0)   // the last tile's stores have read the buffer
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_sync(1 + c, 128);
#pragma unroll
      for (int j = 0; j < kWN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + (lane >> 2) + 8 * h;
          const int chunk = (j & 7) ^ (r & 7);
          *reinterpret_cast<__nv_bfloat162*>(
              cb + (j >> 3) * kCPartBytes + r * 128 + chunk * 16 +
              (lane & 3) * 4) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
        }
      }
      // make the generic-proxy writes visible to TMA, then store
      fence_proxy_async();
      named_sync(1 + c, 128);
      if ((tid & 127) == 0) {
#pragma unroll
        for (int part = 0; part < kBParts; ++part)
          tma_store(&to, cb + part * kCPartBytes, tl.n0 + 64 * part,
                    tl.m0 + c * 64, tl.g);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if ((tid & 127) == 0)   // the buffer lives until the stores have read it
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// -- gmm_kernel_stream: small M, the empty-expert skip -----------------------

constexpr int kSN = 128;                  // columns of w per block
constexpr int kSThreads = 256;
constexpr int kSParts = kSThreads / (kSN / 8);   // 16 K partitions
constexpr int kSMaxM = 16;
constexpr int kSMaxX = 16384;             // elements of x[g] held (32 KB)

template <int MT>
__global__ void __launch_bounds__(kSThreads)
    gmm_kernel_stream(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ out, int32_t M, int32_t K,
                      int32_t N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [M, K]
  __shared__ float red[kSParts][kSN];
  const int64_t g = blockIdx.y;
  const int n0 = blockIdx.x * kSN;
  const __nv_bfloat16* xg = x + g * M * K;
  const __nv_bfloat16* wg = w + g * K * N;
  __nv_bfloat16* og = out + g * M * N;
  const int tid = threadIdx.x;

  // x[g] into shared memory, and the zero test over all of it
  const int n_x = M * K;      // a multiple of 8: K is
  const int n_test = M * K;   // the elements the zero test reads
  int nz = 0;
  for (int i = tid * 8; i < n_x; i += kSThreads * 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(xg + i));
    *reinterpret_cast<uint4*>(xs + i) = v;
    if (i < n_test)   // any bit but a sign bit: a nonzero (or NaN) element
      nz |= ((v.x | v.y | v.z | v.w) & 0x7FFF7FFFu) != 0;
  }
  if (!__syncthreads_or(nz)) {
    // x[g] is all zero, so is x[g] @ w[g]: w[g] is not read
    for (int i = tid; i < M * kSN; i += kSThreads) {
      const int m = i / kSN, col = n0 + i % kSN;
      if (col < N) og[static_cast<int64_t>(m) * N + col] = __float2bfloat16(0.0f);
    }
    return;
  }

  // rows of w in flight per thread: more where the accumulators are few
  constexpr int kSUnroll = MT <= 2 ? 8 : 4;
  const int vec = tid % (kSN / 8), part = tid / (kSN / 8);
  const int col = n0 + vec * 8;
  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[m][e] = 0.0f;

  if (col < N) {   // N is a multiple of 8: the whole vector is inside
    const __nv_bfloat16* wp = wg + col;
    for (int k0 = part; k0 < K; k0 += kSUnroll * kSParts) {
      uint4 wv[kSUnroll];
#pragma unroll
      for (int u = 0; u < kSUnroll; ++u) {
        const int k = k0 + u * kSParts;
        wv[u] = k < K ? __ldg(reinterpret_cast<const uint4*>(
                            wp + static_cast<int64_t>(k) * N))
                      : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kSUnroll; ++u) {
        const int k = k0 + u * kSParts;
        if (k >= K) break;
        const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&wv[u]);
        float wf[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(w2[e]);
          wf[2 * e] = f.x;
          wf[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < M) {
            const float xm = __bfloat162float(xs[m * K + k]);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[m][e] = fmaf(xm, wf[e], acc[m][e]);
          }
        }
      }
    }
  }

  // sum the K partitions, one row of the output at a time
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red[part][vec * 8 + e] = acc[m][e];
      __syncthreads();
      if (tid < kSN && n0 + tid < N) {
        float s = 0.0f;
#pragma unroll
        for (int p = 0; p < kSParts; ++p) s += red[p][tid];
        og[static_cast<int64_t>(m) * N + n0 + tid] = __float2bfloat16(s);
      }
      __syncthreads();
    }
  }
}

// -- gmm_kernel_f32: the float32 route ----------------------------------------

constexpr int kFT = 64;        // rows and columns of the output tile
constexpr int kFK = 16;        // depth of one K step
constexpr int kFThreads = 256; // 16 x 16, each 4 x 4 outputs

__global__ void __launch_bounds__(kFThreads)
gmm_kernel_f32(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int M, int K, int N) {
  __shared__ float as[kFK][kFT + 4];   // x tile, transposed: [k][row]
  __shared__ float bs[kFK][kFT + 4];   // w tile: [k][column]
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * kFT, n0 = blockIdx.x * kFT;
  const float* xg = x + static_cast<int64_t>(g) * M * K;
  const float* wg = w + static_cast<int64_t>(g) * K * N;
  float* og = out + static_cast<int64_t>(g) * M * N;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int i = tid; i < kFT * kFK; i += kFThreads) {
      const int r = i / kFK, c = i % kFK;
      const int gm = m0 + r, gk = k0 + c;
      as[c][r] = (gm < M && gk < K) ? xg[static_cast<int64_t>(gm) * K + gk]
                                    : 0.0f;
    }
    for (int i = tid; i < kFK * kFT; i += kFThreads) {
      const int r = i / kFT, c = i % kFT;
      const int gk = k0 + r, gn = n0 + c;
      bs[r][c] = (gk < K && gn < N) ? wg[static_cast<int64_t>(gk) * N + gn]
                                    : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) og[static_cast<int64_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

// -- host ---------------------------------------------------------------------

template <int MT>
void launch_stream(const __nv_bfloat16* x, const __nv_bfloat16* w,
                   __nv_bfloat16* out, int G, int M, int K, int N,
                   cudaStream_t st) {
  const dim3 grid((N + kSN - 1) / kSN, G);
  gmm_kernel_stream<MT><<<grid, kSThreads, 2 * M * K, st>>>(x, w, out, M, K, N);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// out must not alias x or w. G and ceil(M / 64) must be below 65,536.
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* out,
                                     int G, int M, int K, int N,
                                     void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (K <= 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, 2 * static_cast<size_t>(G) * M * N, st));
  const bool vec = K % 8 == 0 && N % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!vec) {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, G);
    gmm_kernel_mma<<<grid, kThreads, 0, st>>>(xb, wb, ob, M, K, N);
  } else if (M <= kSMaxM && M * K <= kSMaxX) {
    if (M == 1)
      launch_stream<1>(xb, wb, ob, G, M, K, N, st);
    else if (M <= 2)
      launch_stream<2>(xb, wb, ob, G, M, K, N, st);
    else if (M <= 4)
      launch_stream<4>(xb, wb, ob, G, M, K, N, st);
    else if (M <= 8)
      launch_stream<8>(xb, wb, ob, G, M, K, N, st);
    else
      launch_stream<16>(xb, wb, ob, G, M, K, N, st);
  } else {
    CUtensorMap tx, tw, to;
    if (!tensor_map(&tx, x, K, M, G, kWK, kWM) ||
        !tensor_map(&tw, w, N, K, G, 64, kWK) ||
        !tensor_map(&to, out, N, M, G, 64, 64))
      return static_cast<int>(cudaErrorInvalidValue);
    static bool configured = false;   // before any graph capture
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          gmm_kernel_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kWSmem));
      if (err != cudaSuccess) return static_cast<int>(err);
      configured = true;
    }
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int64_t tiles = static_cast<int64_t>(G) * ((M + kWM - 1) / kWM) *
                          ((N + kWN - 1) / kWN);
    if (tiles >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = static_cast<int>(tiles < sms ? tiles : sms);
    gmm_kernel_wgmma<<<grid, kWThreads, kWSmem, st>>>(tx, tw, to, G, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// The float32 route: x [G, M, K], w [G, K, N], out [G, M, N], all float32
// and contiguous. Same contract as grouped_matmul_launch.
extern "C" int grouped_matmul_f32_launch(const void* x, const void* w,
                                         void* out, int G, int M, int K,
                                         int N, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, 4 * static_cast<size_t>(G) * M * N, st));
  const dim3 grid((N + kFT - 1) / kFT, (M + kFT - 1) / kFT, G);
  gmm_kernel_f32<<<grid, kFThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
