// Flash-decode for Hopper (sm_90a), split over the cache, with a plain C
// interface.
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
// What bounds it: bytes, on paper. Every cache slot is read once (2 * hd
// bfloat16 values per kv head) for 4 * G * hd flops, ~16 flop/B at G = 16,
// far below the card's ~295 flop/B balance point for bfloat16. In practice
// the arithmetic and the latency of the steps between barriers are the
// limit: at Qwen3-30B-A3B's decode on an H100 a block of this design waits
// 72 of the ~20,800 cycles of its tile loop for the tiles' bytes
// (chip_decode_probe.py). In float32 on the CUDA cores each FMA also costs
// shared-memory loads and bfloat16 conversions, so the scores q . k run on
// the tensor cores (mma.sync m16n8k16, bfloat16 in, float32 sums): a
// product of two bfloat16 values is exact in float32, so the scores are
// the plain version's up to the order of summation. The softmax and P.V
// stay in float32 on the CUDA cores: P.V on the tensor cores would round
// the softmax weights to bfloat16, an error the model checks read.
//
// Design. Pass 1 (decode_kernel_split) spreads the cache over a grid of
// (B * Kv, n_split) blocks; the wrapper picks n_split from the shapes and
// the SM count (about two blocks per SM, each split a whole number of
// 32-slot tiles). A block serves the G query heads of its kv head, so each
// slot is read once for all of them. It first reads the validity of its
// slots; a split with no visible slot reads no K or V and reports l = 0.
// Otherwise it streams its tiles (64 slots where a split holds two or
// more, else 32) through a ring of up to three tiles in shared memory,
// filled by 16-byte cp.async copies, so the next tiles' bytes are in
// flight while one is reduced; each tile costs three barriers, whose
// latency is most of its time. Scores: each warp takes 8 slots and a share
// of hd's 16-deep steps, q (16 heads a step, zero-padded) and K fed by
// ldmatrix; the shares meet in shared memory. Online softmax: a warp per
// head, each lane on one or two slots, the tile's max and sum by
// shuffles. P.V: a thread holds 8 output columns of 4 heads (32 float32
// sums) and takes every n_sg-th slot of the tile, reading 16 bytes of V
// and the 4 heads' weights as one 16-byte load per slot; the n_sg slot
// groups are summed once, after the last tile. An invalid slot scores
// -1e30, as in the Pallas kernel. The block writes its partial state (m, l
// per head, the unnormalised acc [G, hd]) to a float32 workspace. Pass 2
// (decode_kernel_merge) rescales the splits that saw a visible slot by
// exp(m_s - max m) and writes out = sum acc / sum l in bfloat16, four
// thread groups each summing every fourth split. Where no split saw one,
// every score is -1e30 and the softmax is uniform, so the merge averages V
// over the S slots, as the reference does.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSpan = 4096;   // slots per split at most
constexpr float kNegInf = -1e30f;

// K and q rows are padded by 8 elements, so the 8 rows an ldmatrix phase
// reads (16 bytes each) hit distinct banks
__host__ __device__ inline int k_stride(int HD) { return HD + 8; }
__host__ __device__ inline int heads4(int G) { return (G + 3) / 4 * 4; }
__host__ __device__ inline int heads16(int G) { return (G + 15) / 16 * 16; }

// P.V work cells: 8 output columns x 4 heads, each held by n_sg threads
// that take every n_sg-th slot of a tile
__host__ __device__ inline int pv_cells(int G, int HD) {
  return heads4(G) / 4 * (HD / 8);
}

// Shared memory of a block that streams tiles of kTK slots, bufs at a time.
struct Smem {
  size_t q, part, sc, m, l, corr, valid, ring, ks, vs, bytes;
  __host__ __device__ Smem(int kTK, int G, int HD, int span, int bufs) {
    const size_t g4 = heads4(G);
    q = 0;                                              // bf16 [G16, HD + 8]
    part = q + 2 * static_cast<size_t>(heads16(G)) * k_stride(HD);
    sc = part + 4 * static_cast<size_t>(G) * 64;   // f32 [64 / kTK, G, kTK]
    m = sc + 4 * static_cast<size_t>(kTK) * g4;         // f32 [kTK, g4]
    l = m + 4 * g4;
    corr = l + 4 * g4;
    valid = corr + 4 * g4;
    ring = (valid + span + 15) / 16 * 16;
    ks = ring;
    vs = ks + 2 * static_cast<size_t>(bufs) * kTK * k_stride(HD);
    const size_t end = vs + 2 * static_cast<size_t>(bufs) * kTK * HD;
    // after the last tile the ring holds the P.V partial sums
    const size_t red = ring + 4 * static_cast<size_t>(kThreads) * 32;
    bytes = end > red ? end : red;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
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

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) a += __shfl_xor_sync(0xffffffffu, a, w);
  return a;
}

__device__ __forceinline__ float warp_max(float a) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, w));
  return a;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(v2[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

// Rows j0 .. j0+nk-1 of this (batch, kv head)'s K and V into one buffer.
__device__ __forceinline__ void issue_tile(__nv_bfloat16* Kt,
                                           __nv_bfloat16* Vt,
                                           const __nv_bfloat16* kc,
                                           const __nv_bfloat16* vc, int64_t b,
                                           int S, int Kv, int kvh, int HD,
                                           int j0, int nk, int tid) {
  const int vecs = HD / 8, ks = k_stride(HD);
  for (int i = tid; i < nk * vecs; i += kThreads) {
    const int r = i / vecs, c = (i % vecs) * 8;
    const int64_t src = ((b * S + j0 + r) * Kv + kvh) * HD + c;
    cp_async16(Kt + r * ks + c, kc + src);
    cp_async16(Vt + r * HD + c, vc + src);
  }
}

// Tiles of kTK slots (32 or 64), kBufs of them in a ring: kBufs - 1 in
// flight while one is reduced.
template <int kTK, int kBufs>
__global__ void __launch_bounds__(kThreads, 2)
    decode_kernel_split(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ kc,
                        const __nv_bfloat16* __restrict__ vc,
                        const int32_t* __restrict__ pos,
                        float* __restrict__ ws, int32_t S, int32_t Kv,
                        int32_t G, int32_t HD, int32_t cur, int32_t window,
                        float softcap, float scale, int32_t span) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem off(kTK, G, HD, span, kBufs);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + off.q);
  float* part = reinterpret_cast<float*>(smem + off.part);
  float* sc = reinterpret_cast<float*>(smem + off.sc);
  float* m_run = reinterpret_cast<float*>(smem + off.m);
  float* l_run = reinterpret_cast<float*>(smem + off.l);
  float* corr = reinterpret_cast<float*>(smem + off.corr);
  uint8_t* valid = smem + off.valid;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + off.ks);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + off.vs);
  float* red = reinterpret_cast<float*>(smem + off.ring);

  const int bk = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int64_t b = bk / Kv;
  const int kvh = bk % Kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GH = G * HD, G4 = heads4(G), ks = k_stride(HD), vecs = HD / 8;
  const int s0 = split * span, s1 = min(S, s0 + span);
  float* ws_acc = ws + (static_cast<int64_t>(bk) * n_split + split) * GH;
  float* ws_ml = ws + static_cast<int64_t>(gridDim.x) * n_split * GH +
                 (static_cast<int64_t>(bk) * n_split + split) * 2 * G;

  // the G heads of this kv head are rows kvh*G .. kvh*G+G-1 of q[b]; the
  // rows up to the next multiple of 16 are zero
  const __nv_bfloat16* qb = q + (b * Kv + kvh) * GH;
  for (int i = tid; i < heads16(G) * vecs; i += kThreads) {
    const int r = i / vecs, c = (i % vecs) * 8;
    *reinterpret_cast<uint4*>(qs + r * ks + c) =
        r < G ? __ldg(reinterpret_cast<const uint4*>(qb + r * HD + c))
              : make_uint4(0u, 0u, 0u, 0u);
  }
  // the slots of this split a query at cur sees
  int any = 0;
  for (int j = tid; j < s1 - s0; j += kThreads) {
    const int p = __ldg(pos + b * S + s0 + j);
    const int v = p >= 0 && p <= cur && (window <= 0 || p > cur - window);
    valid[j] = static_cast<uint8_t>(v);
    any |= v;
  }
  if (!__syncthreads_or(any)) {   // no visible slot: no K or V is read
    for (int i = tid; i < GH; i += kThreads) ws_acc[i] = 0.0f;
    for (int h = tid; h < G; h += kThreads) {
      ws_ml[2 * h] = kNegInf;
      ws_ml[2 * h + 1] = 0.0f;
    }
    return;
  }

  const int ktile = kTK * ks, vtile = kTK * HD;
  const int nt = (s1 - s0 + kTK - 1) / kTK;
#pragma unroll
  for (int u = 0; u < kBufs - 1; ++u) {
    if (u < nt)
      issue_tile(Ks + u * ktile, Vs + u * vtile, kc, vc, b, S, Kv, kvh, HD,
                 s0 + u * kTK, min(kTK, s1 - s0 - u * kTK), tid);
    cp_async_commit();
  }
  for (int h = tid; h < G4; h += kThreads) {
    m_run[h] = kNegInf;
    l_run[h] = 0.0f;
    corr[h] = 1.0f;
  }
  for (int i = tid; i < kTK * G4; i += kThreads) sc[i] = 0.0f;   // pad heads

  // P.V ownership: columns 8*dv .. 8*dv+7 of heads 4*hq .. 4*hq+3, for the
  // slots sg, sg + n_sg, ... of each tile
  const int cells = pv_cells(G, HD), n_sg = kThreads / cells;
  const int cell = tid % cells, sg = tid / cells;
  const int dv = cell % vecs, hq = cell / vecs;
  const bool pv = sg < n_sg;
  float acc[4][8];
#pragma unroll
  for (int hh = 0; hh < 4; ++hh)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[hh][e] = 0.0f;

  for (int t = 0; t < nt; ++t) {
    const int j0 = s0 + t * kTK, nk = min(kTK, s1 - j0);
    const __nv_bfloat16* Kt = Ks + (t % kBufs) * ktile;
    const __nv_bfloat16* Vt = Vs + (t % kBufs) * vtile;
    const int next = t + kBufs - 1;
    if (next < nt)
      issue_tile(Ks + (next % kBufs) * ktile, Vs + (next % kBufs) * vtile, kc,
                 vc, b, S, Kv, kvh, HD, s0 + next * kTK,
                 min(kTK, s1 - s0 - next * kTK), tid);
    cp_async_commit();
    cp_async_wait<kBufs - 1>();   // tile t has landed (this thread's copies)
    __syncthreads();              // ... all of them; q and the state are set

    // q . k on the tensor cores: bfloat16 products are exact in float32 and
    // summed in float32. Warp w takes the 8 slots 8 * (w % NB) .. + 7 and
    // the 16-deep steps of hd from w / NB on, every KS-th; the KS parts meet
    // in shared memory. Rows of K past nk hold stale values; their scores
    // are never read.
    constexpr int NB = kTK / 8, KS = kWarps / NB;
    {
      const int nb = warp % NB, kh = warp / NB;
      float* pk = part + kh * G * kTK;
      for (int m0 = 0; m0 < G; m0 += 16) {
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int kk = kh * 16; kk < HD; kk += 16 * KS) {
          uint32_t a[4], bf[2];
          ldmatrix_x4(a, qs + (m0 + (lane & 15)) * ks + kk + (lane >> 4) * 8);
          ldmatrix_x2(bf, Kt + (nb * 8 + (lane & 7)) * ks + kk +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(c, a, bf);
        }
        // c[0], c[1]: head m0 + lane/4, slots 2*(lane%4) + {0, 1} of the
        // warp's 8; c[2], c[3]: head + 8
        const int h = m0 + (lane >> 2), j = nb * 8 + 2 * (lane & 3);
        if (h < G) {
          pk[h * kTK + j] = c[0];
          pk[h * kTK + j + 1] = c[1];
        }
        if (h + 8 < G) {
          pk[(h + 8) * kTK + j] = c[2];
          pk[(h + 8) * kTK + j + 1] = c[3];
        }
      }
    }
    __syncthreads();

    // online softmax: a warp per head, lane j on slots j, j + 32, ...
    constexpr int SL = kTK / 32;
    const uint8_t* vt = valid + t * kTK;
    for (int h = warp; h < G; h += kWarps) {
      float sv[SL];
      float mt = -INFINITY;
#pragma unroll
      for (int u = 0; u < SL; ++u) {
        const int j = lane + 32 * u;
        float x = j < nk ? kNegInf : -INFINITY;
        if (j < nk && vt[j]) {
          float a = 0.0f;
#pragma unroll
          for (int k = 0; k < KS; ++k) a += part[(k * G + h) * kTK + j];
          x = a * scale;
          if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        }
        sv[u] = x;
        mt = fmaxf(mt, x);
      }
      const float m_old = m_run[h];
      const float mx = fmaxf(m_old, warp_max(mt));
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < SL; ++u) {
        const int j = lane + 32 * u;
        const float p = j < nk ? expf(sv[u] - mx) : 0.0f;
        sc[j * G4 + h] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - mx);
        corr[h] = c;
        l_run[h] = l_run[h] * c + sum;
        m_run[h] = mx;
      }
    }
    __syncthreads();

    if (pv) {
      const float4 c4 = *reinterpret_cast<const float4*>(corr + 4 * hq);
      const float cs[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[hh][e] *= cs[hh];
#pragma unroll 4
      for (int j = sg; j < nk; j += n_sg) {
        float vf[8];
        unpack8(*reinterpret_cast<const uint4*>(Vt + j * HD + 8 * dv), vf);
        const float4 p4 = *reinterpret_cast<const float4*>(sc + j * G4 + 4 * hq);
        const float ps[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int hh = 0; hh < 4; ++hh)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[hh][e] = fmaf(ps[hh], vf[e], acc[hh][e]);
      }
    }
    __syncthreads();   // this tile's buffer and weights are free again
  }

  // the P.V sums of slot groups 1 .. n_sg-1 meet group 0's in shared
  // memory, component-major so that neighbouring cells hit distinct banks
  if (pv && sg > 0) {
#pragma unroll
    for (int hh = 0; hh < 4; ++hh)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        red[((sg - 1) * 32 + hh * 8 + e) * cells + cell] = acc[hh][e];
  }
  __syncthreads();
  if (pv && sg == 0) {
    for (int g = 1; g < n_sg; ++g)
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[hh][e] += red[((g - 1) * 32 + hh * 8 + e) * cells + cell];
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      const int h = 4 * hq + hh;
      if (h < G) {
        float4* o = reinterpret_cast<float4*>(ws_acc + h * HD + 8 * dv);
        o[0] = make_float4(acc[hh][0], acc[hh][1], acc[hh][2], acc[hh][3]);
        o[1] = make_float4(acc[hh][4], acc[hh][5], acc[hh][6], acc[hh][7]);
      }
    }
  }
  for (int h = tid; h < G; h += kThreads) {
    ws_ml[2 * h] = m_run[h];
    ws_ml[2 * h + 1] = l_run[h];
  }
}

// One block per (batch * kv head, kMergeCols output elements of its G x hd);
// kMergeParts thread groups each take every kMergeParts-th split, so that a
// thread's loads of the partial sums are in flight together.
constexpr int kMergeCols = 64;
constexpr int kMergeParts = kThreads / kMergeCols;

__host__ __device__ inline int merge_heads(int HD) {
  return (kMergeCols + HD - 2) / HD + 1;   // heads a block's columns touch
}

__global__ void __launch_bounds__(kThreads)
    decode_kernel_merge(const float* __restrict__ ws,
                        const __nv_bfloat16* __restrict__ vc,
                        __nv_bfloat16* __restrict__ out, int32_t S,
                        int32_t Kv, int32_t G, int32_t HD, int32_t n_split) {
  // [heads, n_split] maxima, then weights; [heads, n_split] sums l;
  // [heads] denominators; the groups' partial sums [kMergeParts, kMergeCols]
  extern __shared__ float wts[];
  const int nh = merge_heads(HD);
  float* ls = wts + nh * n_split;
  float* den = ls + nh * n_split;
  float* psum = den + nh;
  const int bk = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GH = G * HD, e0 = blockIdx.y * kMergeCols;
  const int h0 = e0 / HD, h1 = min(G - 1, (e0 + kMergeCols - 1) / HD);
  const float* acc = ws + static_cast<int64_t>(bk) * n_split * GH;
  const float* ml = ws + static_cast<int64_t>(gridDim.x) * n_split * GH +
                    static_cast<int64_t>(bk) * n_split * 2 * G;

  // (m, l) of every split for the heads h0 .. h1, in one round of loads;
  // l > 0 marks a split that saw a visible slot
  for (int i = tid; i < (h1 - h0 + 1) * n_split; i += kThreads) {
    const int hh = i / n_split, s = i % n_split;
    const float2 v =
        *reinterpret_cast<const float2*>(ml + (s * G + h0 + hh) * 2);
    wts[i] = v.y > 0.0f ? v.x : -INFINITY;
    ls[i] = v.y;
  }
  __syncthreads();
  for (int hh = warp; hh <= h1 - h0; hh += kWarps) {
    float* w = wts + hh * n_split;
    float mx = -INFINITY;
    for (int s = lane; s < n_split; s += 32) mx = fmaxf(mx, w[s]);
    mx = warp_max(mx);
    float d = 0.0f;
    for (int s = lane; s < n_split; s += 32) {
      const float c = w[s] == -INFINITY ? 0.0f : expf(w[s] - mx);
      w[s] = c;
      d += c * ls[hh * n_split + s];
    }
    d = warp_sum(d);
    if (lane == 0) den[hh] = d;   // 0: no split saw a visible slot
  }
  __syncthreads();

  const int col = tid % kMergeCols, part = tid / kMergeCols;
  const int i = e0 + col;
  const int hh = min(i, GH - 1) / HD - h0;
  float num = 0.0f;
  if (i < GH && den[hh] > 0.0f) {
    const float* wh = wts + hh * n_split;
#pragma unroll 16
    for (int s = part; s < n_split; s += kMergeParts)
      num = fmaf(wh[s], acc[static_cast<int64_t>(s) * GH + i], num);
  }
  psum[part * kMergeCols + col] = num;
  __syncthreads();
  if (part != 0 || i >= GH) return;
  float d = den[hh];
  if (d > 0.0f) {
#pragma unroll
    for (int g = 1; g < kMergeParts; ++g) num += psum[g * kMergeCols + col];
  } else {   // every score -1e30: the softmax is uniform, V is averaged
    const int64_t b = bk / Kv;
    const int kvh = bk % Kv, c = i % HD;
    for (int j = 0; j < S; ++j)
      num += __bfloat162float(vc[((b * S + j) * Kv + kvh) * HD + c]);
    d = static_cast<float>(S);
  }
  out[static_cast<int64_t>(bk) * GH + i] = __float2bfloat16(num / d);
}

cudaError_t allow_smem(const void* fn, size_t bytes, size_t& configured) {
  if (bytes <= configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) configured = bytes;
  return err;
}

}  // namespace

// Launch both passes on `stream`; returns the cudaError_t of the launches
// (0 = success). ws is float32 scratch of B * Kv * n_split * G * (hd + 2)
// elements; the splits are n_split runs of `span` slots (a multiple of 32,
// at most 4,096) covering S. hd must be a multiple of 16 up to 512, and
// ceil(G / 4) * hd / 8 at most 256 (the wrapper checks both).
extern "C" int decode_launch(const void* q, const void* k_cache,
                             const void* v_cache, const void* pos, void* ws,
                             void* out, int B, int S, int Kv, int G, int hd,
                             int cur_index, int window, float softcap,
                             float scale, int n_split, int span,
                             void* stream) {
  if (B <= 0 || Kv <= 0 || G <= 0) return 0;
  if (hd % 16 || hd > 512 || pv_cells(G, hd) > kThreads || span % 32 ||
      span > kMaxSpan || static_cast<int64_t>(n_split) * span < S ||
      static_cast<int64_t>(n_split - 1) * span >= S)
    return static_cast<int>(cudaErrorInvalidValue);
  // 64-slot tiles where a split holds two or more (fewer barriers a slot),
  // else 32; a ring of up to three tiles, no deeper than a split is long;
  // shallower, then smaller, where that would not fit a block's shared
  // memory (wide heads)
  static int smem_max = 0;
  if (smem_max == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int tile = span % 64 == 0 && span >= 128 ? 64 : 32;
  int bufs = span / tile < 3 ? span / tile : 3;
  while (Smem(tile, G, hd, span, bufs).bytes > static_cast<size_t>(smem_max)) {
    if (bufs > 1) {
      --bufs;
    } else if (tile == 64) {
      tile = 32;
      bufs = span / tile < 3 ? span / tile : 3;
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int which = (tile == 64 ? 3 : 0) + bufs - 1;
  using Split = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                         const __nv_bfloat16*, const int32_t*, float*, int32_t,
                         int32_t, int32_t, int32_t, int32_t, int32_t, float,
                         float, int32_t);
  static const Split kernels[6] = {
      decode_kernel_split<32, 1>, decode_kernel_split<32, 2>,
      decode_kernel_split<32, 3>, decode_kernel_split<64, 1>,
      decode_kernel_split<64, 2>, decode_kernel_split<64, 3>};
  // grown before any graph capture
  static size_t split_smem[6] = {48 * 1024, 48 * 1024, 48 * 1024,
                                 48 * 1024, 48 * 1024, 48 * 1024};
  static size_t merge_smem = 48 * 1024;
  const size_t bytes = Smem(tile, G, hd, span, bufs).bytes;
  const int nh = merge_heads(hd);
  const size_t merge_bytes =
      4 * (2 * static_cast<size_t>(nh) * n_split + nh + kMergeParts * kMergeCols);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernels[which]),
                               bytes, split_smem[which]);
  if (err == cudaSuccess)
    err = allow_smem(reinterpret_cast<const void*>(decode_kernel_merge),
                     merge_bytes, merge_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* vb = static_cast<const __nv_bfloat16*>(v_cache);
  float* wsf = static_cast<float*>(ws);
  kernels[which]<<<dim3(B * Kv, n_split), kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_cache), vb,
      static_cast<const int32_t*>(pos), wsf, S, Kv, G, hd, cur_index, window,
      softcap, scale, span);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel_merge<<<dim3(B * Kv, (G * hd + kMergeCols - 1) / kMergeCols),
                        kThreads, merge_bytes, st>>>(
      wsf, vb, static_cast<__nv_bfloat16*>(out), S, Kv, G, hd, n_split);
  return static_cast<int>(cudaGetLastError());
}
