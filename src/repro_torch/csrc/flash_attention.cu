// Flash attention (GQA, causal, local window, logit softcap) for Hopper
// (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention (body _kernel): out = softmax(mask(softcap(q k^T *
// scale))) v for q [B*Hq, Lq, hd] and k, v [B*Hkv, S, hd] in bfloat16, with
// the query at row i sitting at absolute position q_offset + i and key j at
// position j. q-head row bh reads kv row (bh / Hq) * Hkv + (bh % Hq) / (Hq /
// Hkv), as the Pallas index maps do: K and V are never repeated. The plain
// version is flash_attention_plain in
// src/repro_torch/kernels/flash_attention.py.
//
// What bounds it: operations. At the prefill of RecurrentGemma-9B (Lq = S =
// 3072, hd 256, window 2048) each byte of q, k and v feeds ~1,000 flops, far
// above the card's ~295 flop/B balance point for bfloat16.
//
// Design, simple first (no TMA, no wgmma, no pipelining): one block of four
// warps per (q-head row, 64-query tile); each warp owns 16 query rows. The
// block stages its Q tile in shared memory once, then walks the 64-key
// tiles of K and V that the causal window can reach (tiles wholly outside it
// are skipped). Per key tile a warp computes its 16 x 64 scores with
// mma.sync m16n8k16 (bfloat16 in, float32 accumulate), applies scale,
// softcap and the mask, and updates the online softmax (running max and
// sum per row in float32, as the Pallas kernel's scratch). The
// probabilities are rounded to bfloat16 and multiplied with V by mma.sync
// into the float32 [16, hd] accumulator held in registers (128 registers a
// thread at hd = 256). V is staged transposed so that both products read
// their B operand as 32-bit words. Rows of Q and K are padded by 8 elements
// and rows of V^T by 8, so the fragment loads of a warp hit 32 distinct
// banks. Shared memory per block at hd = 256: 104,448 bytes, two blocks per
// SM. Rows past Lq and keys past S are masked, so Lq and S need not be
// multiples of the tiles.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block (16 per warp)
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // four warps
constexpr float kNegInf = -1e30f;

template <int HD>
struct Layout {
  static constexpr int kQK = HD + 8;   // row stride (elements) of Q and K
  static constexpr int kVt = kBK + 8;  // row stride of V^T
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * (kBQ * kQK + kBK * kQK + HD * kVt);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int32_t Lq, int32_t S,
                 int32_t Hq, int32_t Hkv, int32_t causal, int32_t window,
                 float softcap, float scale, int32_t q_offset) {
  using L = Layout<HD>;
  constexpr int kVec = 8;                  // bfloat16 per 16-byte vector
  constexpr int kRowVecs = HD / kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBQ * L::kQK;
  __nv_bfloat16* Vt = Ks + kBK * L::kQK;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int kv_row = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const __nv_bfloat16* qb = q + static_cast<int64_t>(bh) * Lq * HD;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(kv_row) * S * HD;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(kv_row) * S * HD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment coordinates
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < kBQ * kRowVecs; i += kThreads) {
    const int r = i / kRowVecs, c = (i % kRowVecs) * kVec;
    uint4 x = zero;
    if (q0 + r < Lq)
      x = *reinterpret_cast<const uint4*>(qb + static_cast<int64_t>(q0 + r) *
                                                   HD + c);
    *reinterpret_cast<uint4*>(Qs + r * L::kQK + c) = x;
  }

  // the key tiles some row of this query tile can see
  const int qa_lo = q0 + q_offset;
  const int qa_hi = min(q0 + kBQ, Lq) - 1 + q_offset;
  const int k_lo = window > 0 ? max(0, qa_lo - window + 1) : 0;
  const int k_hi = causal ? min(S, qa_hi + 1) : S;
  const int kt_lo = k_lo / kBK;
  const int kt_hi = k_hi > k_lo ? (k_hi + kBK - 1) / kBK : kt_lo;

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};   // rows g and g + 8 of this warp
  float l_run[2] = {0.0f, 0.0f};
  const int qrow = q0 + warp * 16 + g;   // tile row of fragment row g
  const int qpos[2] = {qrow + q_offset, qrow + 8 + q_offset};

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile is no longer read (and Q is in)
    for (int i = tid; i < kBK * kRowVecs; i += kThreads) {
      const int r = i / kRowVecs, c = (i % kRowVecs) * kVec;
      uint4 x = zero;
      if (k0 + r < S)
        x = *reinterpret_cast<const uint4*>(kb + static_cast<int64_t>(k0 + r) *
                                                     HD + c);
      *reinterpret_cast<uint4*>(Ks + r * L::kQK + c) = x;
    }
    // V^T: neighbouring threads take neighbouring keys, so the scalar
    // stores into a row of V^T fall on neighbouring addresses
    for (int i = tid; i < kBK * kRowVecs; i += kThreads) {
      const int r = i % kBK, c = (i / kBK) * kVec;
      uint4 x = zero;
      if (k0 + r < S)
        x = *reinterpret_cast<const uint4*>(vb + static_cast<int64_t>(k0 + r) *
                                                     HD + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int j = 0; j < kVec; ++j) Vt[(c + j) * L::kVt + r] = e[j];
    }
    __syncthreads();

    // scores of this warp's 16 rows against the 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      const __nv_bfloat16* qa = Qs + (warp * 16 + g) * L::kQK + kk + 2 * t4;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * L::kQK), ld32(qa + 8),
                             ld32(qa + 8 * L::kQK + 8)};
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const __nv_bfloat16* kp = Ks + (n * 8 + g) * L::kQK + kk + 2 * t4;
        const uint32_t b[2] = {ld32(kp), ld32(kp + 8)};
        mma_bf16(s[n], a, b);
      }
    }

    // scale, softcap, mask; the online softmax of the Pallas kernel
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + n * 8 + 2 * t4 + (e & 1);
        float x = s[n][e] * scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        const bool ok = kpos < S && (!causal || kpos <= qpos[r]) &&
                        (window <= 0 || kpos > qpos[r] - window);
        x = ok ? x : kNegInf;
        s[n][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float corr[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_run[e >> 1]);
        s[n][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_run[r] = l_run[r] * corr[r] + rsum[r];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // o += p v: the score fragments of two key groups of 8 are the A
    // fragment of one 16-key step
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const __nv_bfloat16* vp = Vt + (n * 8 + g) * L::kVt + kc * 16 + 2 * t4;
        const uint32_t b[2] = {ld32(vp), ld32(vp + 8)};
        mma_bf16(o[n], a, b);
      }
    }
  }

  const float inv0 = 1.0f / fmaxf(l_run[0], 1e-30f);
  const float inv1 = 1.0f / fmaxf(l_run[1], 1e-30f);
  __nv_bfloat16* ob = out + static_cast<int64_t>(bh) * Lq * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (qrow < Lq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<int64_t>(qrow) * HD + col) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (qrow + 8 < Lq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<int64_t>(qrow + 8) * HD +
                                   col) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Lq, int S, int Hq, int Hkv, int causal, int window,
           float softcap, float scale, int q_offset, cudaStream_t stream) {
  static bool configured = false;   // set once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Layout<HD>::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Lq + kBQ - 1) / kBQ, BH);
  flash_kernel<HD><<<grid, kThreads, Layout<HD>::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Lq, S, Hq, Hkv, causal, window, softcap, scale, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The kernel is built for hd in {64, 128, 256} (HEAD_DIMS in the wrapper).
extern "C" int flash_launch(const void* q, const void* k, const void* v,
                            void* out, int BH, int Lq, int S, int Hq, int Hkv,
                            int hd, int causal, int window, float softcap,
                            float scale, int q_offset, void* stream) {
  if (BH <= 0 || Lq <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, out, BH, Lq, S, Hq, Hkv, causal, window,
                        softcap, scale, q_offset, st);
    case 128:
      return launch<128>(q, k, v, out, BH, Lq, S, Hq, Hkv, causal, window,
                         softcap, scale, q_offset, st);
    case 256:
      return launch<256>(q, k, v, out, BH, Lq, S, Hq, Hkv, causal, window,
                         softcap, scale, q_offset, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
