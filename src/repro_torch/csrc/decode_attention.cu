// Flash-decode for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py ::
// decode_attention (body _kernel): one query token per sequence, q [B, Hq,
// hd], against a ring-buffer KV cache k, v [B, S, Kv, hd] in bfloat16, with
// the absolute position of every cache slot in pos [B, S] (int32, -1 =
// empty). Slot j is visible when pos >= 0, pos <= cur_index and, with a
// window, pos > cur_index - window. The Pallas wrapper turns pos into a mask
// tensor before the call; this kernel reads pos itself. The plain version is
// decode_attention_plain in src/repro_torch/kernels/decode_attention.py.
//
// What bounds it: bytes. Every cache slot is read once (2 * hd bfloat16
// values per kv head) for 4 * G * hd flops, ~16 flop/B at G = 16, far below
// the card's ~295 flop/B balance point for bfloat16.
//
// Design, simple first: one block per (batch, kv head), which processes the
// G query heads of its group together, as the Pallas grid does, so each
// cache slot is read once for all of them. The block walks the cache in
// tiles of 64 slots: it stages the K and V rows and the slots' validity in
// shared memory, computes the G x 64 scores in float32 (one thread per
// score; K rows are padded by 2 elements so a warp's threads, on
// neighbouring slots, read distinct banks), updates the online softmax (one
// warp per head: running max and sum in float32) and folds the tile into
// the float32 [G, hd] accumulator in shared memory (one thread per
// accumulator element). Slots are taken in ring order, whatever their
// positions; an invalid slot gets the score -1e30, as in the Pallas kernel,
// so a cache with no valid slot averages V as the reference does. The
// softmax weights stay in float32 for the product with V (the reference
// model's einsum path rounds them to bfloat16 first). With one block per
// (batch, kv head) only B * Kv SMs work; a split-S version that spreads the
// cache over more blocks is the next step.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTK = 64;         // cache slots per tile
constexpr int kThreads = 512;
constexpr float kNegInf = -1e30f;

struct Smem {
  size_t q, acc, sc, m, l, corr, valid, ks, vs, bytes;
  __host__ __device__ Smem(int G, int HD) {
    const size_t gh = static_cast<size_t>(G) * HD;
    q = 0;
    acc = q + 4 * gh;
    sc = acc + 4 * gh;
    m = sc + 4 * static_cast<size_t>(G) * kTK;
    l = m + 4 * static_cast<size_t>(G);
    corr = l + 4 * static_cast<size_t>(G);
    valid = corr + 4 * static_cast<size_t>(G);
    ks = (valid + 4 * kTK + 15) / 16 * 16;
    vs = (ks + 2 * static_cast<size_t>(kTK) * (HD + 2) + 15) / 16 * 16;
    bytes = vs + 2 * static_cast<size_t>(kTK) * HD;
  }
};

__global__ void __launch_bounds__(kThreads)
    decode_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ kc,
                  const __nv_bfloat16* __restrict__ vc,
                  const int32_t* __restrict__ pos,
                  __nv_bfloat16* __restrict__ out, int32_t S, int32_t Kv,
                  int32_t G, int32_t HD, int32_t cur, int32_t window,
                  float softcap, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem off(G, HD);
  float* qs = reinterpret_cast<float*>(smem + off.q);
  float* acc = reinterpret_cast<float*>(smem + off.acc);
  float* sc = reinterpret_cast<float*>(smem + off.sc);
  float* m_run = reinterpret_cast<float*>(smem + off.m);
  float* l_run = reinterpret_cast<float*>(smem + off.l);
  float* corr = reinterpret_cast<float*>(smem + off.corr);
  int32_t* valid = reinterpret_cast<int32_t*>(smem + off.valid);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + off.ks);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + off.vs);

  const int b = blockIdx.x / Kv, kvh = blockIdx.x % Kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GH = G * HD;
  const int kstride = HD + 2;   // padded K row (elements)
  const int vecs = HD / 8;      // 16-byte vectors per row
  // the G heads of this kv head are rows kvh*G .. kvh*G+G-1 of q[b]
  const __nv_bfloat16* qb = q + (static_cast<int64_t>(b) * Kv + kvh) * GH;
  for (int i = tid; i < GH; i += kThreads) {
    qs[i] = __bfloat162float(qb[i]);
    acc[i] = 0.0f;
  }
  for (int h = tid; h < G; h += kThreads) {
    m_run[h] = kNegInf;
    l_run[h] = 0.0f;
  }

  for (int j0 = 0; j0 < S; j0 += kTK) {
    const int nk = min(kTK, S - j0);
    __syncthreads();   // the previous tile is no longer read
    for (int i = tid; i < kTK * vecs; i += kThreads) {
      const int r = i / vecs, c = (i % vecs) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (r < nk) {
        const int64_t row =
            ((static_cast<int64_t>(b) * S + j0 + r) * Kv + kvh) * HD + c;
        kx = __ldg(reinterpret_cast<const uint4*>(kc + row));
        vx = __ldg(reinterpret_cast<const uint4*>(vc + row));
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(Ks + r * kstride + c);
      kd[0] = kx.x;
      kd[1] = kx.y;
      kd[2] = kx.z;
      kd[3] = kx.w;
      *reinterpret_cast<uint4*>(Vs + r * HD + c) = vx;
    }
    for (int j = tid; j < kTK; j += kThreads) {
      const int p = j < nk ? __ldg(pos + static_cast<int64_t>(b) * S + j0 + j)
                           : -1;
      valid[j] = p >= 0 && p <= cur && (window <= 0 || p > cur - window);
    }
    __syncthreads();

    for (int i = tid; i < G * kTK; i += kThreads) {
      const int h = i / kTK, j = i % kTK;
      float s = kNegInf;
      if (valid[j]) {
        const float2* qh = reinterpret_cast<const float2*>(qs + h * HD);
        const __nv_bfloat162* kr =
            reinterpret_cast<const __nv_bfloat162*>(Ks + j * kstride);
        float a = 0.0f;
        for (int d2 = 0; d2 < HD / 2; ++d2) {
          const float2 kf = __bfloat1622float2(kr[d2]);
          const float2 qf = qh[d2];
          a = fmaf(qf.x, kf.x, a);
          a = fmaf(qf.y, kf.y, a);
        }
        s = a * scale;
        if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
      }
      sc[i] = s;
    }
    __syncthreads();

    for (int h = warp; h < G; h += kThreads / 32) {
      float* sh = sc + h * kTK;
      float mx = m_run[h];
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, sh[j]);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      float sum = 0.0f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(sh[j] - mx);
        sh[j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_run[h] - mx);
        corr[h] = c;
        l_run[h] = l_run[h] * c + sum;
        m_run[h] = mx;
      }
    }
    __syncthreads();

    for (int i = tid; i < GH; i += kThreads) {
      const int h = i / HD, d = i % HD;
      const float* ph = sc + h * kTK;
      float a = acc[i] * corr[h];
      for (int j = 0; j < nk; ++j)
        a = fmaf(ph[j], __bfloat162float(Vs[j * HD + d]), a);
      acc[i] = a;
    }
  }
  __syncthreads();
  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * Kv + kvh) * GH;
  for (int i = tid; i < GH; i += kThreads)
    ob[i] = __float2bfloat16(acc[i] / fmaxf(l_run[i / HD], 1e-30f));
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// hd must be a multiple of 8, and the shared memory of Smem(G, hd) must fit
// the 227 KB a block may use (the wrapper checks both).
extern "C" int decode_launch(const void* q, const void* k_cache,
                             const void* v_cache, const void* pos, void* out,
                             int B, int S, int Kv, int G, int hd, int cur_index,
                             int window, float softcap, float scale,
                             void* stream) {
  if (B <= 0 || Kv <= 0 || G <= 0) return 0;
  static size_t configured = 48 * 1024;   // grown before any graph capture
  const size_t bytes = Smem(G, hd).bytes;
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = bytes;
  }
  decode_kernel<<<B * Kv, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache),
      static_cast<const int32_t*>(pos), static_cast<__nv_bfloat16*>(out), S,
      Kv, G, hd, cur_index, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}
