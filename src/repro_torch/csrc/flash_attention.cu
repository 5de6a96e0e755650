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
// src/repro_torch/kernels/flash_attention.py, and tile_plan there mirrors
// this kernel's walk over the key tiles.
//
// What bounds it: operations. At the prefill of RecurrentGemma-9B (Lq = S =
// 3072, hd 256, window 2048) each byte of q, k and v feeds ~1,000 flops, far
// above the card's ~295 flop/B balance point for bfloat16.
//
// Design (FlashAttention-3's shape). A persistent grid of one block per
// SM (shared memory allows one) walks work items of one 128-row query tile
// of one q-head row. A block has three warpgroups: warpgroup 0 is the
// producer, of which one thread issues every TMA load; warpgroups 1 and 2
// are consumers, each owning 64 of the query rows. setmaxnreg moves
// registers from the producer (24) to the consumers (240). Every tile in
// shared memory is rows of 128 bytes (64 bfloat16 of the head dim) with the
// 128-byte swizzle, a row of hd 128 or 256 being 2 or 4 such boxes, as TMA
// writes them:
//   Q      [128 rows x hd], one buffer with full / empty mbarriers: the
//          next item's Q loads as soon as both consumers' last S product
//          of this item is done;
//   K, V   [BK keys x hd] each, in a ring of two stages with a full and an
//          empty mbarrier per K and per V, running across items: K goes
//          back once its S product is done, V once its P V product is, so
//          the producer loads a tile's K a whole step before it is needed;
//          BK = 128 at hd <= 128 and 64 at hd 256;
//   O      two 64-row x 64-column staging boxes per consumer.
// Shared memory at hd 256: 64 + 2 x (32 + 32) + 32 = 224 KB.
// A consumer computes S = Q K^T with wgmma m64nBKk16 (both operands
// K-major in shared memory, float32 accumulate), applies the softcap and
// the mask, and runs the online softmax in registers on the accumulator's
// layout (row max and sum across each quad of threads; exp2 with the scale
// and log2(e) folded into one FMA). P is rounded to bfloat16 in registers
// and is the A operand of O += P V (wgmma m64nHDk16, A from registers); V
// is the B operand as stored, [keys, hd] = MN-major, through the transpose
// bit, so nothing is transposed. Each consumer overlaps its own work as
// FlashAttention-3 does (intra-warpgroup overlap): the S product of tile
// j + 1 and the P V product of tile j are issued together, and the softmax
// of tile j + 1 runs on the CUDA cores while P V of tile j runs on the
// tensor cores. P of tile j + 1 is packed only after P V of tile j is done:
// a register that an issued product still reads is never redefined, which
// keeps ptxas from serialising the products (its warning C7513). The two
// consumers run unsynchronised beside each other.
//
// Key tiles: an item walks the tiles that some of its rows can see (the
// causal diagonal and the window's lower edge bound them); a consumer
// skips the item's tiles that none of its own rows sees, and evaluates the
// causal, window and S-edge masks only on the tiles that hold a pair of
// its rows and keys that is not visible (tile_plan in the wrapper computes
// the same walk). Masked scores are -inf and the running max starts at
// -1e30, so masked keys weigh nothing and a row that sees no key at all
// comes out zero. Rows past Lq and keys past S arrive from TMA as zeros;
// the output is rounded to bfloat16, staged box by box and written by TMA
// stores, which clip rows past Lq.
//
// Scheduling: the items run from the last query tile (the longest causal
// walk) to the first, and within a query tile by q-head row, so the q
// heads of one kv head run side by side and read their K and V from L2.
// Block b takes item b first, then the next item of a counter in device
// memory (zero at the launch, from the wrapper): the longest walks go
// first and the blocks finish together.

#include <cmath>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 128;        // query rows per block, 64 per consumer
constexpr int kThreads = 384;   // a producer warpgroup and two consumers
constexpr float kNegInf = -1e30f;   // the running max before any key
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int kBK = HD == 256 ? 64 : 128;   // keys per tile
  static constexpr int kStages = 2;                  // K / V tiles in flight
  static constexpr int kQPart = kBQ * 128;           // a 64-column box of Q
  static constexpr int kKVPart = kBK * 128;          // ... of K or V
  static constexpr int kParts = HD / 64;
  static constexpr int kQBytes = kParts * kQPart;
  static constexpr int kKVBytes = kParts * kKVPart;
  static constexpr int kOBuf = 64 * 128;     // one box of a consumer's rows
  static constexpr int kOBufs = kParts < 2 ? kParts : 2;
  static constexpr int kOBytes = 2 * kOBufs * kOBuf;   // both consumers
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes +
                                  kOBytes + 8 * (2 + 4 * kStages) + 8;
};

// d += A (64 x 16) * B (16 x 64), both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d += A (64 x 16) * B (16 x 128), both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d = A (64 x 16) * B (16 x 64), both K-major in shared memory;
// the first k step of a product: d is only written.
__device__ __forceinline__ void wgmma_ss0_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// d = A (64 x 16) * B (16 x 128), both K-major in shared memory;
// the first k step of a product: d is only written.
__device__ __forceinline__ void wgmma_ss0_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d += A (64 x 16, bfloat16 pairs in registers) * B (16 x 64, MN-major
// in shared memory, through the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (64 x 16, bfloat16 pairs in registers) * B (16 x 128, MN-major
// in shared memory, through the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (64 x 16, bfloat16 pairs in registers) * B (16 x 256, MN-major
// in shared memory, through the transpose bit).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
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
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// d = A B for the first k step (d only written), d += A B after it.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, bool first) {
  if constexpr (N == 64) {
    if (first)
      wgmma_ss0_n64(d, da, db);
    else
      wgmma_ss_n64(d, da, db);
  } else {
    if (first)
      wgmma_ss0_n128(d, da, db);
    else
      wgmma_ss_n128(d, da, db);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Shape {
  int32_t Lq, S, BH, Hq, Hkv, causal, window, q_offset, n_qt;
  float softcap, scale;
};

// Key tiles [lo, hi) of BK keys that some query row in [r0, r1) sees.
struct Tiles {
  int lo, hi;
};

__device__ __forceinline__ Tiles key_tiles(const Shape& sh, int r0, int r1,
                                           int bk) {
  if (r1 > sh.Lq) r1 = sh.Lq;
  if (r1 <= r0) return Tiles{0, 0};
  const int a = r0 + sh.q_offset, b = r1 - 1 + sh.q_offset;
  const int k_lo = sh.window > 0 ? max(0, a - sh.window + 1) : 0;
  const int k_hi = sh.causal ? min(sh.S, b + 1) : sh.S;
  if (k_hi <= k_lo) return Tiles{0, 0};
  return Tiles{k_lo / bk, (k_hi + bk - 1) / bk};
}

// Whether tile kt holds a pair of a row in [r0, r1) and a key that is not
// visible (or a key past S): only such tiles evaluate the mask.
__device__ __forceinline__ bool tile_masked(const Shape& sh, int r0, int r1,
                                            int kt, int bk) {
  if (r1 > sh.Lq) r1 = sh.Lq;
  const int a = r0 + sh.q_offset, b = r1 - 1 + sh.q_offset;
  const int k0 = kt * bk;
  return k0 + bk > sh.S || (sh.causal && k0 + bk - 1 > a) ||
         (sh.window > 0 && k0 <= b - sh.window);
}

// A work item: one 128-row query tile of one q-head row. Items run from
// the last query tile (the longest causal walk) to the first, and within a
// query tile by q-head row, so the q heads of one kv head run side by side.
struct Work {
  int q0, bh, kv;
};

__device__ __forceinline__ Work work_item(const Shape& sh, int w) {
  const int qt = sh.n_qt - 1 - w / sh.BH, bh = w % sh.BH;
  return Work{qt * kBQ, bh,
              (bh / sh.Hq) * sh.Hkv + (bh % sh.Hq) / (sh.Hq / sh.Hkv)};
}

// The online softmax of one S tile of a consumer, on wgmma's accumulator
// layout: register 4j + 2h + e of a thread holds row 16 * warp + lane / 4 +
// 8h of the consumer's 64, key column 8j + 2 * (lane % 4) + e. Keys outside
// [klo[h], khi[h]] are masked on a masked tile. Updates the running max m
// and this thread's share of the running sum l of its two rows, returns the
// factor the output must be rescaled by in corr and the probabilities, in
// float32, in x. Neither s nor x is an operand of a product in flight, so
// this may run while P V of the previous tile does.
template <int BK, bool kMask>
__device__ __forceinline__ void softmax_tile(const Shape& sh,
                                             const float (&s)[BK / 2],
                                             float (&x)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0,
                                             const int (&klo)[2],
                                             const int (&khi)[2], int t4) {
  // x holds the scores in log2 units with the softcap, else the raw
  // scores, whose scale is folded into the exponent's FMA below
  const bool cap = sh.softcap > 0.0f;
  const float scale_log2 = sh.scale * kLog2e;
  if (cap) {
    const float inv_cap = sh.scale / sh.softcap, cap_log2 = sh.softcap * kLog2e;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) x[i] = tanhf(s[i] * inv_cap) * cap_log2;
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) x[i] = s[i];
  }
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
        if (kpos < klo[h] || kpos > khi[h]) x[4 * j + e] = -INFINITY;
      }
  }
  // four partial maxima (and sums below) a row: short dependency chains
  float mp[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int u = 0; u < 4; ++u) mp[h][u] = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& a = mp[e >> 1][2 * (j & 1) + (e & 1)];
      a = fmaxf(a, x[4 * j + e]);
    }
  float mx[2];
  const float to_log2 = cap ? 1.0f : scale_log2;   // scale > 0 keeps the order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(fmaxf(mp[h][0], mp[h][1]), fmaxf(mp[h][2], mp[h][3]));
    mx[h] = fmaxf(m[h], mx[h] * to_log2);
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = exp2_approx(m[h] - mx[h]);
    m[h] = mx[h];
    l[h] *= corr[h];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int u = 0; u < 4; ++u) mp[h][u] = 0.0f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& y = x[4 * j + e];
      y = exp2_approx(fmaf(y, to_log2, -mx[e >> 1]));
      mp[e >> 1][2 * (j & 1) + (e & 1)] += y;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    l[h] += (mp[h][0] + mp[h][1]) + (mp[h][2] + mp[h][3]);
}

// P rounded to bfloat16 pairs in the A-operand layout of P V: key group j
// of 8 is half of the 16-key step j / 2.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&x)[BK / 2],
                                       uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    p[j >> 1][(j & 1) * 2] = pack_bf16(x[4 * j], x[4 * j + 1]);
    p[j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to, const Shape sh,
                 int32_t* __restrict__ next) {
  using C = Cfg<HD>;
  constexpr int BK = C::kBK;
  constexpr int ST = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: align the tiles to it
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = qs + C::kQBytes;
  unsigned char* vs = ks + ST * C::kKVBytes;
  unsigned char* os = vs + ST * C::kKVBytes;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(os + C::kOBytes);
  uint64_t* qempty = qfull + 1;
  uint64_t* fullk = qempty + 1;
  uint64_t* fullv = fullk + ST;
  uint64_t* emptyk = fullv + ST;
  uint64_t* emptyv = emptyk + ST;
  volatile int32_t* item = reinterpret_cast<int32_t*>(emptyv + ST);

  const int tid = threadIdx.x, wg = tid / 128;
  const int n_work = sh.n_qt * sh.BH;
  if (tid == 0) {
    mbar_init(qfull, 1);          // the producer's arrive + the TMA bytes
    mbar_init(qempty, 8);         // one arrive per consumer warp
    for (int s = 0; s < ST; ++s) {
      mbar_init(fullk + s, 1);
      mbar_init(fullv + s, 1);
      mbar_init(emptyk + s, 8);
      mbar_init(emptyv + s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      int it = 0;   // K / V tiles loaded so far, over all work items
      for (int n = 0;; ++n) {
        // the first item is the block's own, the rest come from a counter
        // in the order of the items, so the longest walks go first
        const int w = n == 0 ? blockIdx.x : gridDim.x + atomicAdd(next, 1);
        // the consumers are done with the previous item's Q (and its id)
        if (n > 0) mbar_wait(qempty, (n - 1) & 1);
        *item = w;   // published by the arrive on qfull below
        if (w >= n_work) {
          mbar_arrive(qfull);
          break;
        }
        const Work wk = work_item(sh, w);
        const Tiles blk = key_tiles(sh, wk.q0, wk.q0 + kBQ, BK);
        mbar_expect_tx(qfull, C::kQBytes);
#pragma unroll
        for (int part = 0; part < C::kParts; ++part)
          tma_load(qs + part * C::kQPart, &tq, qfull, 64 * part, wk.q0, wk.bh);
        for (int t = blk.lo; t < blk.hi; ++t, ++it) {
          const int s = it % ST, round = it / ST;
          if (round > 0) mbar_wait(emptyk + s, (round - 1) & 1);
          mbar_expect_tx(fullk + s, C::kKVBytes);
#pragma unroll
          for (int part = 0; part < C::kParts; ++part)
            tma_load(ks + s * C::kKVBytes + part * C::kKVPart, &tk, fullk + s,
                     64 * part, t * BK, wk.kv);
          if (round > 0) mbar_wait(emptyv + s, (round - 1) & 1);
          mbar_expect_tx(fullv + s, C::kKVBytes);
#pragma unroll
          for (int part = 0; part < C::kParts; ++part)
            tma_load(vs + s * C::kKVBytes + part * C::kKVPart, &tv, fullv + s,
                     64 * part, t * BK, wk.kv);
        }
      }
    }
  } else {   // consumer c owns rows c*64 .. c*64+63 of each query tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1, lane = tid & 31, warp = (tid & 127) >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int row = warp * 16 + g;   // this thread's rows: row, row + 8
    const uint32_t qa = smem_addr(qs) + c * 64 * 128;
    int it = 0;                      // K / V tiles consumed, over all items

    for (int n = 0;; ++n) {
      mbar_wait(qfull, n & 1);
      const int w = *item;
      if (w >= n_work) break;
      const Work wk = work_item(sh, w);
      const Tiles blk = key_tiles(sh, wk.q0, wk.q0 + kBQ, BK);
      const int r0 = wk.q0 + c * 64;
      Tiles own = key_tiles(sh, r0, r0 + 64, BK);
      // a consumer whose rows see nothing passes every tile of the walk
      if (own.hi <= own.lo) own = Tiles{blk.hi, blk.hi};
      int klo[2], khi[2];            // the keys each of this thread's rows sees
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qpos = r0 + row + 8 * h + sh.q_offset;
        khi[h] = sh.causal ? min(qpos, sh.S - 1) : sh.S - 1;
        klo[h] = sh.window > 0 ? qpos - sh.window + 1 : INT32_MIN;
      }

      // a tile of the item's walk that this consumer's rows do not see:
      // wait until it has landed (so the empty barriers' phases stay in
      // step), then hand the stage back
      auto pass = [&]() {
        const int s = it % ST, ph = (it / ST) & 1;
        mbar_wait(fullk + s, ph);
        mbar_wait(fullv + s, ph);
        if (lane == 0) {
          mbar_arrive(emptyk + s);
          mbar_arrive(emptyv + s);
        }
        ++it;
      };
      auto qk = [&](float (&sacc)[BK / 2], int s) {
        const uint32_t kb = smem_addr(ks + s * C::kKVBytes);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          // the k step: 32 bytes along the rows of box kk / 4
          const uint32_t off = (kk & 3) * 32;
          wgmma_ss<BK>(sacc,
                       gmma_desc(qa + (kk >> 2) * C::kQPart + off, 1, 64),
                       gmma_desc(kb + (kk >> 2) * C::kKVPart + off, 1, 64),
                       kk == 0);
        }
      };
      auto pv = [&](float (&o)[HD / 2], uint32_t (&p)[BK / 16][4], int s) {
        const uint32_t vb = smem_addr(vs + s * C::kKVBytes);
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc)
          // 16 key rows (2,048 bytes) per step; the 64-column boxes of V
          // kKVPart bytes apart
          wgmma_rs<HD>(o, p[kc],
                       gmma_desc(vb + kc * 2048, C::kKVPart / 16, 64));
      };
      auto softmax = [&](float (&sacc)[BK / 2], float (&x)[BK / 2],
                         float (&m)[2], float (&l)[2], float (&corr)[2],
                         int t) {
        if (tile_masked(sh, r0, r0 + 64, t, BK))
          softmax_tile<BK, true>(sh, sacc, x, m, l, corr, t * BK, klo, khi,
                                 t4);
        else
          softmax_tile<BK, false>(sh, sacc, x, m, l, corr, t * BK, klo, khi,
                                  t4);
      };
      // S of the item's last tile is done: Q may be replaced
      auto q_done = [&](int t) {
        if (t == own.hi - 1 && lane == 0) mbar_arrive(qempty);
      };

      float o[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
      for (int t = blk.lo; t < own.lo; ++t) pass();
      if (own.hi > own.lo) {
        float sacc[BK / 2], x[BK / 2], corr[2];
        uint32_t p[BK / 16][4];
        int s = it % ST;
        mbar_wait(fullk + s, (it / ST) & 1);
        wgmma_fence();
        qk(sacc, s);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
        if (lane == 0) mbar_arrive(emptyk + s);
        q_done(own.lo);
        softmax(sacc, x, m, l, corr, own.lo);
        pack_p<BK>(x, p);
        for (int t = own.lo + 1; t < own.hi; ++t) {
          const int sp = s, php = (it / ST) & 1;   // the previous tile
          ++it;
          s = it % ST;
          mbar_wait(fullk + s, (it / ST) & 1);
          mbar_wait(fullv + sp, php);
          fence_regs(o);
          fence_regs(p);
          wgmma_fence();
          qk(sacc, s);          // S of tile t ...
          wgmma_commit();
          pv(o, p, sp);         // ... issued beside P V of tile t - 1
          wgmma_commit();
          wgmma_wait<1>();      // S is done: K goes back; P V may still run
          fence_regs(sacc);
          if (lane == 0) mbar_arrive(emptyk + s);
          q_done(t);
          softmax(sacc, x, m, l, corr, t);
          wgmma_wait<0>();      // P V is done: V goes back, P and O may change
          fence_regs(o);
          fence_regs(p);
          if (lane == 0) mbar_arrive(emptyv + sp);
#pragma unroll
          for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
          pack_p<BK>(x, p);
        }
        mbar_wait(fullv + s, (it / ST) & 1);
        fence_regs(o);
        fence_regs(p);
        wgmma_fence();
        pv(o, p, s);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        if (lane == 0) mbar_arrive(emptyv + s);
        ++it;
      } else if (lane == 0) {
        mbar_arrive(qempty);   // this consumer reads no Q for this item
      }
      for (int t = own.hi; t < blk.hi; ++t) pass();

      // o / l in bfloat16, one 64-column box at a time through this
      // consumer's staging buffers (128-byte swizzle) to TMA stores, which
      // clip the rows past Lq; a buffer is rewritten once the store two
      // boxes back has read it
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        l[h] = 1.0f / fmaxf(l[h], 1e-30f);
      }
      const bool leader = (tid & 127) == 0;
      unsigned char* ob = os + c * C::kOBufs * C::kOBuf;
#pragma unroll
      for (int part = 0; part < C::kParts; ++part) {
        if (leader) {
          if (part >= C::kOBufs)
            asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
          else   // the previous item's stores
            asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        named_sync(1 + c, 128);
        unsigned char* buf = ob + (part % C::kOBufs) * C::kOBuf;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 8 * part + jj, r = row + 8 * h;
            *reinterpret_cast<uint32_t*>(buf + r * 128 + ((jj ^ (r & 7)) * 16) +
                                         t4 * 4) =
                pack_bf16(o[4 * j + 2 * h] * l[h], o[4 * j + 2 * h + 1] * l[h]);
          }
        fence_proxy_async();
        named_sync(1 + c, 128);
        if (leader && r0 < sh.Lq) {
          tma_store(&to, buf, 64 * part, r0, wk.bh);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
    if ((tid & 127) == 0)   // the buffers live until the stores have read them
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           int32_t* next, const Shape& sh, cudaStream_t stream) {
  using C = Cfg<HD>;
  static bool configured = false;   // set once, before any graph capture
  static int sms = 0;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::kSmem));
    int dev = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int bkv = sh.BH / sh.Hq * sh.Hkv;
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map(&tq, q, HD, sh.Lq, sh.BH, 64, kBQ) ||
      !tensor_map(&tk, k, HD, sh.S, bkv, 64, C::kBK) ||
      !tensor_map(&tv, v, HD, sh.S, bkv, 64, C::kBK) ||
      !tensor_map(&to, out, HD, sh.Lq, sh.BH, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t work = static_cast<int64_t>(sh.n_qt) * sh.BH;
  if (work >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(work < sms ? work : sms);
  flash_kernel<HD><<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, to, sh, next);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The kernel is built for hd in {64, 128, 256} (HEAD_DIMS in the wrapper);
// q, k, v and out are contiguous with 16-byte aligned bases; `next` is one
// int32 in device memory, zero at the launch (the work items' counter).
extern "C" int flash_launch(const void* q, const void* k, const void* v,
                            void* out, void* next, int BH, int Lq, int S,
                            int Hq, int Hkv, int hd, int causal, int window,
                            float softcap, float scale, int q_offset,
                            void* stream) {
  if (BH <= 0 || Lq <= 0) return 0;
  if (S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || BH % Hq != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{Lq, S, BH, Hq, Hkv, causal, window, q_offset,
                 (Lq + kBQ - 1) / kBQ, softcap, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* n = static_cast<int32_t*>(next);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, out, n, sh, st);
    case 128:
      return launch<128>(q, k, v, out, n, sh, st);
    case 256:
      return launch<256>(q, k, v, out, n, sh, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
