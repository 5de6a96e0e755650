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
// bfloat16. At decode (M = 1) bytes: the 403 MB of expert weights are read
// for a single row each.
//
// Design, simple first (no TMA, no wgmma, no empty-group skipping): one
// block of four warps per (group, 64-row M tile, 128-column N tile). The
// block walks K in 32-wide steps through a three-stage ring of shared
// memory filled by cp.async, so the loads of two steps are in flight while
// the tensor cores work on a third. Each warp owns a 32 x 64 piece of the
// output: per 16-deep step it loads its A fragments with ldmatrix and its B
// fragments with ldmatrix.trans (w is stored K-major, [K, N] with N
// contiguous, and .trans hands each thread the k-pairs mma.sync wants), and
// issues 16 mma.sync m16n8k16 (bfloat16 in, float32 accumulate) into 64
// float32 registers. Rows of the A tile are padded by 8 elements and rows
// of the B tile by 8, so each phase of an ldmatrix hits 32 distinct banks.
// Shared memory: 41,472 bytes per block, static. Rows past M and columns
// past N are zero-filled on load and never stored, and K need not be a
// multiple of 32: the last step's tail is zero-filled. Where K or N is not a
// multiple of 8, or a base pointer not 16-byte aligned, a 16-byte copy could
// straddle an edge, so the tiles are loaded element by element instead.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;        // rows of x per block
constexpr int kBN = 128;       // columns of w per block
constexpr int kBK = 32;        // depth of one K step
constexpr int kStages = 3;     // K steps held in shared memory
constexpr int kThreads = 128;  // four warps, 2 x 2 over the 64 x 128 tile
constexpr int kAS = kBK + 8;   // row stride (elements) of the A tile
constexpr int kBS = kBN + 8;   // row stride of the B tile
constexpr int kATile = kBM * kAS;
constexpr int kBTile = kBK * kBS;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-fills when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
// w[k0:k0+32, n0:n0+128] of this block's group, zero outside the matrices.
// kVec: 16-byte cp.async copies (K, N multiples of 8, aligned bases), each
// either wholly inside or wholly outside; otherwise element by element.
template <bool kVec>
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
    if (kVec) {
      const bool ok = gm < M && gk < K;
      cp_async16(dst, ok ? src : xg, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (gm < M && gk + j < K) ? src[j] : zero;
    }
  }
  for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    const int gk = k0 + r, gn = n0 + c;
    __nv_bfloat16* dst = Bs + r * kBS + c;
    const __nv_bfloat16* src = wg + static_cast<int64_t>(gk) * N + gn;
    if (kVec) {
      const bool ok = gk < K && gn < N;
      cp_async16(dst, ok ? src : wg, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (gk < K && gn + j < N) ? src[j] : zero;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const __nv_bfloat16* __restrict__ x,
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
      load_step<kVec>(As + s * kATile, Bs + s * kBTile, xg, wg, m0, n0,
                      s * kBK, M, N, K, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();   // step kt has landed (for this thread)
    __syncthreads();                // ... for all; step kt-1 is consumed
    const int next = kt + kStages - 1;
    if (next < nk)
      load_step<kVec>(As + (next % kStages) * kATile,
                      Bs + (next % kStages) * kBTile, xg, wg, m0, n0,
                      next * kBK, M, N, K, tid);
    cp_async_commit();

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
  cp_async_wait<0>();

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

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// out must not alias x or w. G and ceil(M / 64) must be below 65,536.
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* out,
                                     int G, int M, int K, int N,
                                     void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, G);
  const bool vec = K % 8 == 0 && N % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (vec)
    gmm_kernel<true><<<grid, kThreads, 0, st>>>(xb, wb, ob, M, K, N);
  else
    gmm_kernel<false><<<grid, kThreads, 0, st>>>(xb, wb, ob, M, K, N);
  return static_cast<int>(cudaGetLastError());
}
