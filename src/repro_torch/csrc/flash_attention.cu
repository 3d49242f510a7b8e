// Online-softmax (flash) attention on Hopper's tensor cores in split TF32
// (sm_90a): float32 and bfloat16, head size D from 8 to 256 in steps of 8,
// q, k, v and the output through any strides; plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel) for every input that flash_attention_sm90.cu
// (bf16, D 64 or 128, layouts a TMA map describes) does not take: float32
// at any D, and bf16 at any other D or through any other layout. For
// q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D):
//   out[b,h,i] = softmax_k(q[b,h,i] . k[b,h/g,k] / sqrt(D)) @ v[b,h/g]
// with g = Hq / Hkv (GQA: the KV head is h / g, K and V are never expanded),
// where key k is visible to query i (position q_offset + i) only if
//   k < kv_len,  k <= q_offset + i (causal),  k > q_offset + i - window.
// The scale is applied after the product. Masked scores are -1e30, not
// -inf, as in the JAX code: exp(m_prev - m_new) stays 1 while a row has seen
// only masked keys, and a real key wipes what they added. A query that sees
// no key at all gets the mean of v over all Skv keys, as the plain version's
// uniform softmax over -1e30 scores gives; the Pallas kernel's mean over its
// zero-padded block is not copied. Ragged Sq and Skv are bounds, not
// padding. The output is cast to the input type once, at the end.
//
// What bounds it on the H100. At (B 1, Hq 32, Hkv 8, S 4096, D 128, causal,
// float32) the two products take 4 * Hq * (S(S+1)/2) * D = 137.4 GFLOP
// against 84 MB of traffic (q, k, v read once, the output written once:
// 0.025 ms at 3.35 TB/s): bound by operations. On the CUDA cores (67
// TFLOP/s in float32) that is 2.05 ms. The tensor cores take float32 only as
// TF32 (8 exponent bits, 10 stored mantissa bits), and one TF32 product
// misses float32's 2e-5 tolerance by 50-70x. Split TF32 keeps it: each
// operand is x = hi + lo with hi = tf32(x) and lo = tf32(x - hi) (both
// cvt.rna), and x * y ~ hi*hi + hi*lo + lo*hi, summed in a float32
// accumulator, the two small terms first (lo*lo and the rounding of lo are
// below 2^-21 of |x * y|). Three products a multiply-add put the bound at
// 3 * 137.4 GFLOP / 495 TFLOP/s = 0.83 ms, under the CUDA cores' 2.05 ms.
// bfloat16 inputs are exact in TF32 (their lo is 0), so that route skips
// their lo products and copies: one product for Q K^T, two for P V (P is
// float32 and is split).
//
// The design:
//  * One block per work tile (64 q rows, q head, batch row): a grid of
//    (ceil(Sq/64), Hq, B) blocks whose linear index maps to the tiles so
//    that the heaviest causal q tiles of all heads and batch rows start
//    first. Two warpgroups: a consumer and a producer.
//  * The producer brings in, for each 32- or 64-key tile that some row of
//    the block can see, K and V (a "job" each), in the order K0 K1 V0 K2 V1
//    ... (K a tile ahead of V, so K of tile n + 1 is ready when Q K^T of
//    tile n is done while P V of tile n - 1 still runs). Where every row of
//    k and v starts 16-byte aligned (8-byte for bf16) with d stride 1, each
//    producer thread copies its quads of the job RAW jobs ahead into a raw
//    ring with cp.async, and reads back only what it copied once its own
//    cp.async.wait_group says they have landed: loads that waited in
//    registers would hold every thread's arrive on "full" (a release) until
//    they land. Any other layout is read by element loads into registers,
//    a job at a time, so every layout is taken. TMA is not used: it cannot
//    split, and it refuses the layouts this kernel exists for.
//    Each element is split once, where the producer reads it (a warp 4 keys
//    x 32 d a step for K, 16 keys x 8 d for V), and written to its slot,
//    each slot guarded by a "full" and an "empty" mbarrier:
//      K as [key][d] (K-major for Q K^T),
//      V transposed as [d][key]: wgmma reads .tf32 operands from shared
//      memory K-major only (the transpose bits exist for 16-bit types
//      only), and P V's K dimension is the key.
//    Tiles are 128-byte swizzled (each 16-byte group of a 128-byte row at
//    group ^ (row % 8)), the layout the wgmma descriptors below read; the
//    producer fences the async proxy before it arrives on "full".
//  * The consumer splits its Q tile once, at the block's start, into shared
//    memory (hi and lo, K-major, zero past D). S = Q K^T is wgmma m64nBKk8
//    .tf32 with both operands in shared memory (DP/8 k-steps, unrolled,
//    three products each); the online softmax runs in registers in exp2's
//    domain (running max and sum, quad shuffles), masking only the tiles
//    that touch the causal diagonal, the window's edge, kv_len or Skv; P is
//    split in registers and is the A operand of O += P V (wgmma m64nDPk8,
//    V^T from shared memory). The tf32 A fragment holds keys (t, t + 4) of
//    each 8-key step where the score accumulator holds keys (2t, 2t + 1)
//    (t = lane % 4): the keys of V^T are stored in the order 0 2 4 6 1 3 5 7
//    within each 8, so P enters the product with no shuffle. Where the
//    ring has two or more slots, tile n's Q K^T starts together with tile
//    n-1's P V and tile n's softmax runs while P V is on the tensor cores.
//    In float32 each tile's P V goes into a fresh accumulator, added to O
//    on the CUDA cores (at DP 256 in two halves of 128 columns): the tensor
//    cores' own additions into a running O drift past float32's tolerance
//    over thousands of keys. bf16 keeps O on the tensor cores.
//    wgmma's register operands are fenced so that no other instruction
//    defines them while a product is in flight (ptxas would serialise every
//    wgmma of the kernel).
//  * Epilogue: O is divided by the row sum once (guarded) and written
//    through the output's strides in its type; rows that see no key get
//    the mean of v. Where the caller asks for it (a non-null lse, as the
//    training forward does), each row's statistic m + log2(l) in exp2's
//    domain goes to a float32 (B, Hq, Sq) buffer, +inf for a row that sees
//    no key: the backward (flash_attention_bwd.cu) recomputes P from it.
//    Serving passes null and stores nothing; O is the same either way.
//
// Tiles by type and DP, the head size the tiles are built for (D rounded up
// to 32, 64, 128 or 256: Q's columns past D are zero, K's never meet
// anything else, and V^T rows past D reach only output columns past D,
// which are never stored). Shared memory = Q (64 x DP floats a copy) +
// SLOTS slots of BK x DP floats a copy (two copies, hi and lo, in float32;
// one in bf16) + RAW jobs of BK x DP elements as loaded:
//
//   type      DP   BK  SLOTS  RAW  Q      slot   raw    total   pipelined
//   float32   32   64  4      4    16 KB  16 KB   8 KB  112 KB  yes
//   float32   64   64  2      4    32 KB  32 KB  16 KB  160 KB  yes
//   float32  128   32  2      4    64 KB  32 KB  16 KB  192 KB  yes
//   float32  256   32  1      1   128 KB  64 KB  32 KB  224 KB  no
//   bf16      32   64  4      4     8 KB   8 KB   4 KB   56 KB  yes
//   bf16      64   64  4      4    16 KB  16 KB   8 KB  112 KB  yes
//   bf16     128   64  2      4    32 KB  32 KB  16 KB  160 KB  yes
//   bf16     256   32  2      4    64 KB  32 KB  16 KB  192 KB  yes
//
// (float32 at DP 256 holds one K or V job at a time, so its Q K^T and P V
// alternate with the producer's writes.)
//
// The C entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int WG = 128;             // threads of a warpgroup
constexpr int BQ = 64;              // query rows a block: one wgmma M
constexpr int THREADS = 2 * WG;     // the consumer, then the producer
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, h, s, d;   // in elements
};

// keys a tile (BK), slots of the split K/V ring (half for K, half for V;
// one slot taken in turns where SLOTS is 1) and items of the raw ring, by
// input type and DP
template <typename T, int DP>
struct Config;
template <>
struct Config<float, 32> {
  static constexpr int BK = 64, SLOTS = 4, RAW = 4;
};
template <>
struct Config<float, 64> {
  static constexpr int BK = 64, SLOTS = 2, RAW = 4;
};
template <>
struct Config<float, 128> {
  static constexpr int BK = 32, SLOTS = 2, RAW = 4;
};
template <>
struct Config<float, 256> {
  static constexpr int BK = 32, SLOTS = 1, RAW = 1;
};
template <>
struct Config<__nv_bfloat16, 32> {
  static constexpr int BK = 64, SLOTS = 4, RAW = 4;
};
template <>
struct Config<__nv_bfloat16, 64> {
  static constexpr int BK = 64, SLOTS = 4, RAW = 4;
};
template <>
struct Config<__nv_bfloat16, 128> {
  static constexpr int BK = 64, SLOTS = 2, RAW = 4;
};
template <>
struct Config<__nv_bfloat16, 256> {
  static constexpr int BK = 32, SLOTS = 2, RAW = 4;
};

template <typename T, int DP>
struct Smem {
  static constexpr bool SPLIT = std::is_same<T, float>::value;
  static constexpr int COPIES = SPLIT ? 2 : 1;           // hi (and lo)
  static constexpr int BK = Config<T, DP>::BK;
  static constexpr int SLOTS = Config<T, DP>::SLOTS;
  static constexpr int RAWN = Config<T, DP>::RAW;
  static constexpr int Q_COPY = BQ * DP * 4;              // one copy of Q
  static constexpr int ITEM_COPY = BK * DP * 4;           // of K or of V^T
  static constexpr int SLOT = COPIES * ITEM_COPY;
  static constexpr int RAW_ITEM = BK * DP * (int)sizeof(T);   // as loaded
  static constexpr int Q = 0;                             // Q hi, Q lo
  static constexpr int RING = Q + COPIES * Q_COPY;        // SLOTS slots
  static constexpr int RAW = RING + SLOTS * SLOT;         // RAWN items
  static constexpr int BAR = RAW + RAWN * RAW_ITEM;       // full, empty
  static constexpr int MEAN = BAR + 16 * SLOTS;           // DP floats
  static constexpr int BYTES = MEAN + 4 * DP + 1024;      // + alignment slack
  static_assert(BYTES <= 232448, "over the 227 KB a block can have");
};

struct Params {
  const void *q, *k, *v;
  void* o;
  Strides qs, ks, vs, os;
  int group, Sq, Skv, D, kv_end, causal, window, q_offset;
  int Hq, B, nq;                   // heads, batch rows, q tiles
  int q_vec;                       // vector loads for q
  int kv_vec;                      // cp.async for k and v
  float scale_log2;                // log2(e) / sqrt(D)
  float* lse;                      // (B, Hq, Sq) row statistic, or null
};

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// BYTES (16, or 8 for a bf16 quad) from global into shared memory, async:
// no register waits for it, and neither does an arrive's release
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst),
                 "l"(src), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's operand reads)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4), layout type 1 (SWIZZLE_128B) in bits
// 62-63. K-major tiles: rows 128 B apart, 8-row groups 1024 B apart (SBO),
// LBO unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of wgmma's register
// operands (accumulators, P's fragments) across wgmma: ptxas serialises
// every wgmma of the kernel if another instruction defines one of them
// while a product is in flight
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

#define D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (m64n32, f32) {=, +=} A (smem) * B (smem), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : D8(0), D8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n64, f32) {=, +=} A (smem) * B (smem), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n32, f32) {=, +=} A (registers, 4 x tf32) * B (smem, K-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : D8(0), D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (m64n64, f32) {=, +=} A (registers, 4 x tf32) * B (smem, K-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (m64n128, f32) {=, +=} A (registers, 4 x tf32) * B (smem, K-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40),
        D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (m64n256, f32) {=, +=} A (registers, 4 x tf32) * B (smem, K-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40),
        D8(48), D8(56), D8(64), D8(72), D8(80), D8(88),
        D8(96), D8(104), D8(112), D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef D8

// ------------------------------------------------------------- the split
// x rounded to TF32, to nearest with ties away from zero (the low 13 bits 0)
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// four consecutive d of one row: a vector load (from global memory where the
// row is aligned and its d stride 1, or from the raw ring), four element
// loads otherwise
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  float4 x;
  __device__ __forceinline__ void load(const float* p, long long sd,
                                       bool vec) {
    if (vec)
      x = *reinterpret_cast<const float4*>(p);
    else
      x = make_float4(p[0], p[sd], p[2 * sd], p[3 * sd]);
  }
  __device__ __forceinline__ void zero() {
    x = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ float at(int e) const {
    return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
  }
};
template <>
struct Quad<__nv_bfloat16> {
  uint32_t x[2];   // element e in the low (e even) or high half of x[e / 2]
  __device__ __forceinline__ void load(const __nv_bfloat16* p, long long sd,
                                       bool vec) {
    if (vec) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      x[0] = u.x;
      x[1] = u.y;
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
      x[0] = (uint32_t)s[0] | ((uint32_t)s[sd] << 16);
      x[1] = (uint32_t)s[2 * sd] | ((uint32_t)s[3 * sd] << 16);
    }
  }
  __device__ __forceinline__ void zero() { x[0] = x[1] = 0u; }
  __device__ __forceinline__ float at(int e) const {
    const uint32_t w = x[e / 2];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// byte offset of element (row, col) of a K-major tile of ROWS rows: 32-float
// chunks of col, each ROWS rows of 128 bytes, 128-byte swizzled
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return ((uint32_t)(col >> 5) * (ROWS * 128) + row * 128 + (col & 31) * 4) ^
         ((row & 7) << 4);
}

// the hi (and lo) of a quad at (row, col .. col + 3) of a K-major tile of
// ROWS rows; the lo copy lies `copy` bytes after the hi one
template <bool SPLIT, int ROWS, typename Q>
__device__ __forceinline__ void put_row(uint8_t* tile, int copy, int row,
                                        int col, const Q& q) {
  float h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x = q.at(e);
    h[e] = SPLIT ? tf32(x) : x;      // a bf16 value is a TF32 value
    l[e] = SPLIT ? tf32(x - h[e]) : 0.f;
  }
  const uint32_t off = swz<ROWS>(row, col);
  *reinterpret_cast<float4*>(tile + off) = make_float4(h[0], h[1], h[2], h[3]);
  if (SPLIT)
    *reinterpret_cast<float4*>(tile + copy + off) =
        make_float4(l[0], l[1], l[2], l[3]);
}

// the K position of key c in V^T: within each 8 keys, in the order
// 0 2 4 6 1 3 5 7 (see pack_p)
__device__ __forceinline__ int vt_col(int c) {
  return (c & ~7) | ((c & 7) >> 1) | ((c & 1) << 2);
}

// the hi (and lo) of a quad of V, key c, d .. d + 3, into V^T (DP rows)
template <bool SPLIT, int DP, typename Q>
__device__ __forceinline__ void put_col(uint8_t* tile, int copy, int c,
                                        int d, const Q& q) {
  const int col = vt_col(c);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x = q.at(e);
    const float h = SPLIT ? tf32(x) : x;
    const uint32_t off = swz<DP>(d + e, col);
    *reinterpret_cast<float*>(tile + off) = h;
    if (SPLIT) *reinterpret_cast<float*>(tile + copy + off) = tf32(x - h);
  }
}

// ---------------------------------------------------------------- masking
__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.kv_end && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}
// whether query position qpos sees any key at all
__device__ __forceinline__ bool sees_a_key(const Params& p, int qpos) {
  const int lo = p.window > 0 ? max(0, qpos - p.window + 1) : 0;
  const int hi = p.causal ? min(p.kv_end - 1, qpos) : p.kv_end - 1;
  return lo <= hi;
}

// One work tile: 64 q rows of one head of one batch row, and the key tiles
// some row of it can see, [n_lo, n_lo + ntiles). Work w = (q tile from the
// last, head, batch row): blocks start in the order of w, so the heaviest
// causal tiles of every head and batch row start first.
struct Work {
  int h, b, hk, q0, rows, first_q, n_lo, ntiles;
};

template <int BK>
__device__ __forceinline__ Work work_tile(const Params& p, int w) {
  Work t;
  const int per_qt = p.Hq * p.B;
  const int qt = p.nq - 1 - w / per_qt;
  t.h = (w % per_qt) % p.Hq;
  t.b = (w % per_qt) / p.Hq;
  t.hk = t.h / p.group;
  t.q0 = qt * BQ;
  t.rows = min(BQ, p.Sq - t.q0);
  t.first_q = p.q_offset + t.q0;
  const int last_q = t.first_q + t.rows - 1;
  const int hi = p.causal ? min(p.kv_end, last_q + 1) : p.kv_end;
  const int lo = p.window > 0 ? max(0, t.first_q - p.window + 1) : 0;
  t.n_lo = lo / BK;
  t.ntiles = hi > lo ? (hi + BK - 1) / BK - t.n_lo : 0;
  return t;
}

// ---------------------------------------------------------------- producer
// One K or V job of this producer thread (ptid, 0-127): step j of warp w
// covers one quad, key c and d .. d + 3 (i = w + 4 j):
//   K: c = 4 (i % (BK/4)) + lane / 8, d = 32 (i / (BK/4)) + 4 (lane % 8):
//      eight threads on one key's 128 contiguous bytes (float32), and a
//      quarter-warp's 16-byte stores of K hit every bank;
//   V: c = 16 (i % (BK/16)) + lane % 16, d = 8 (i / (BK/16)) + 4 (lane / 16):
//      sixteen keys a warp keep V^T's scalar stores free of bank conflicts.
// A thread reads back from the raw ring only the quads it copied there, so
// its own cp.async.wait_group is all the synchronisation the ring needs.
template <typename T, int DP, bool IS_V>
struct Item {
  static constexpr int BK = Config<T, DP>::BK;
  static constexpr int STEPS = BK * DP / 512;
  static constexpr int QUAD = 4 * (int)sizeof(T);     // bytes of a quad
  Quad<T> x[STEPS];

  __device__ __forceinline__ static void at(int j, int warp, int lane,
                                            int& c, int& d) {
    const int i = warp + 4 * j;
    if (IS_V) {
      c = (i % (BK / 16)) * 16 + (lane & 15);
      d = (i / (BK / 16)) * 8 + (lane >> 4) * 4;
    } else {
      c = (i % (BK / 4)) * 4 + (lane >> 3);
      d = (i / (BK / 4)) * 32 + (lane & 7) * 4;
    }
  }

  // element loads into registers (layouts the ring does not take)
  __device__ __forceinline__ void load(const T* base, const Strides& s,
                                       int k0, int Skv, int D, int warp,
                                       int lane) {
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      int c, d;
      at(j, warp, lane, c, d);
      if (d < D) {
        if (k0 + c < Skv)   // keys past Skv are zero: p * v must not be NaN
          x[j].load(base + (k0 + c) * s.s + d * s.d, s.d, false);
        else
          x[j].zero();
      }
    }
  }

  // this thread's quads of rows k0 .. into the raw ring (rows 16-byte
  // aligned, d stride 1), one cp.async each
  __device__ __forceinline__ static void copy(uint32_t raw, const T* base,
                                              long long ss, int k0, int Skv,
                                              int D, int warp, int lane,
                                              int ptid) {
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      int c, d;
      at(j, warp, lane, c, d);
      if (d < D && k0 + c < Skv)
        cp_async<QUAD>(raw + (j * WG + ptid) * QUAD,
                       base + (k0 + c) * ss + d);
    }
  }

  __device__ __forceinline__ void load_own(const uint8_t* raw, int k0,
                                           int Skv, int D, int warp,
                                           int lane, int ptid) {
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      int c, d;
      at(j, warp, lane, c, d);
      if (d < D) {
        if (k0 + c < Skv)
          x[j].load(reinterpret_cast<const T*>(raw + (j * WG + ptid) * QUAD),
                    1, true);
        else
          x[j].zero();
      }
    }
  }

  __device__ __forceinline__ void put(uint8_t* slot, int D, int warp,
                                      int lane) const {
    constexpr bool SPLIT = Smem<T, DP>::SPLIT;
    constexpr int COPY = Smem<T, DP>::ITEM_COPY;
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      int c, d;
      at(j, warp, lane, c, d);
      if (d < D) {
        if (IS_V)
          put_col<SPLIT, DP>(slot, COPY, c, d, x[j]);
        else
          put_row<SPLIT, BK>(slot, COPY, c, d, x[j]);
      }
    }
  }
};

// The producer's jobs, in order: with two or more slots K runs a tile ahead
// of V (K0 K1 V0 K2 V1 ... V(N-1)), so that K of tile n + 1 is written
// while the consumer's Q K^T of tile n is done and its P V of tile n - 1
// still runs; with one slot, K and V of each tile in turn.
template <int SLOTS>
__device__ __forceinline__ void job(int j, int ntiles, int& n, bool& is_v) {
  if (SLOTS == 1) {
    n = j / 2;
    is_v = j & 1;
  } else if (j == 0 || j == 2 * ntiles - 1) {
    n = j == 0 ? 0 : ntiles - 1;
    is_v = j != 0;
  } else {
    n = j & 1 ? (j + 1) / 2 : j / 2 - 1;
    is_v = !(j & 1);
  }
}

// the slot K or V of tile n takes, and the parity of that use: K in slots
// [0, SLOTS/2), V in [SLOTS/2, SLOTS); one slot taken in turns if SLOTS is 1
struct SlotUse {
  int slot, parity;
};
template <int SLOTS>
__device__ __forceinline__ SlotUse slot_use(int n, bool is_v) {
  if constexpr (SLOTS == 1) {
    return {0, (2 * n + is_v) & 1};
  } else {
    constexpr int H = SLOTS / 2;
    return {(is_v ? H : 0) + n % H, (n / H) & 1};
  }
}

// ---------------------------------------------------------------- consumer
// S = Q K^T for one key tile: DP/8 k-steps of 8 (Q's columns past D are
// zero), the cross terms first; committed as one group. Unrolled: a
// wgmma in a loop of run-time length gets its accumulators copied at the
// loop's edge, and ptxas then serialises every wgmma of the kernel.
template <typename T, int DP>
__device__ __forceinline__ void start_qk(float (&s)[Config<T, DP>::BK / 2],
                                         uint32_t q_tile, uint32_t k_tile) {
  using S = Smem<T, DP>;
  constexpr int BK = S::BK;
  if (S::SPLIT) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const uint32_t qo = (kk >> 2) * (BQ * 128) + (kk & 3) * 32;
      const uint32_t ko = (kk >> 2) * (BK * 128) + (kk & 3) * 32;
      wgmma_ss(s, sw128_desc(q_tile + S::Q_COPY + qo),      // lo hi
               sw128_desc(k_tile + ko), kk > 0);
      wgmma_ss(s, sw128_desc(q_tile + qo),                  // hi lo
               sw128_desc(k_tile + S::ITEM_COPY + ko), 1);
    }
  }
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const uint32_t qo = (kk >> 2) * (BQ * 128) + (kk & 3) * 32;
    const uint32_t ko = (kk >> 2) * (BK * 128) + (kk & 3) * 32;
    wgmma_ss(s, sw128_desc(q_tile + qo), sw128_desc(k_tile + ko),
             S::SPLIT || kk > 0);                            // hi hi
  }
  wgmma_commit();
}

// O (+)= P V for one key tile, N output columns from the V^T rows at
// v_tile: BK/8 k-steps of 8 keys, the small terms first; one group. With
// fresh, the first product overwrites o.
template <typename T, int DP, int N = DP>
__device__ __forceinline__ void start_pv(
    float (&o)[N / 2], const uint32_t (&ph)[Config<T, DP>::BK / 8][4],
    const uint32_t (&pl)[Config<T, DP>::BK / 8][4], uint32_t v_tile,
    bool fresh) {
  using S = Smem<T, DP>;
  constexpr int KSTEPS = S::BK / 8;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint32_t vo = (kk >> 2) * (DP * 128) + (kk & 3) * 32;
    wgmma_rs(o, pl[kk], sw128_desc(v_tile + vo), !fresh || kk > 0);  // lo hi
    if (S::SPLIT)
      wgmma_rs(o, ph[kk], sw128_desc(v_tile + S::ITEM_COPY + vo), 1);
  }
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint32_t vo = (kk >> 2) * (DP * 128) + (kk & 3) * 32;
    wgmma_rs(o, ph[kk], sw128_desc(v_tile + vo), 1);                 // hi hi
  }
  wgmma_commit();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// max and sum over the four lanes of a quad (the threads that share a row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// The online-softmax update of one key tile for the thread's two rows.
// s: the tile's raw scores in the wgmma accumulator layout (element i at row
// (i / 2) % 2, key 8 (i / 4) + 2 (lane % 4) + i % 2), turned into the
// probabilities p in place; m in exp2's domain; l per thread.
template <bool MASK, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Params& p, int k0,
                                             int qpos0, int lane) {
  if (MASK) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int kpos = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
      const int qpos = qpos0 + 8 * ((i / 2) & 1);
      s[i] = visible(p, qpos, kpos) ? s[i] * p.scale_log2 : NEG_INF;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = quad_max(mx);
    const float m_new = fmaxf(m[r], MASK ? mx : mx * p.scale_log2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * r + c];
        x = MASK ? ex2(x - m_new) : ex2(fmaf(x, p.scale_log2, -m_new));
        sum += x;
      }
    }
    l[r] = l[r] * alpha[r] + sum;
  }
}

// the tile at k0 for the block's rows: masked only where it touches the
// causal diagonal, the window's edge, kv_len or Skv
template <int N>
__device__ __forceinline__ void softmax(float (&s)[N], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        const Params& p, const Work& t, int k0,
                                        int qpos0, int lane) {
  constexpr int BK = 2 * N;
  const int last_q = t.first_q + BQ - 1;
  const bool mask = k0 + BK > p.kv_end ||
                    (p.causal && k0 + BK - 1 > t.first_q) ||
                    (p.window > 0 && k0 <= last_q - p.window);
  if (mask)
    softmax_tile<true>(s, m, l, alpha, p, k0, qpos0, lane);
  else
    softmax_tile<false>(s, m, l, alpha, p, k0, qpos0, lane);
}

// O *= alpha, row by row (the thread's two rows)
template <int N>
__device__ __forceinline__ void rescale_o(float (&o)[N],
                                          const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// P, split, as wgmma's tf32 A operand. For k-step kk the fragment holds
// (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4) (g = lane / 4,
// t = lane % 4); the thread's scores are keys 8 kk + 2t and 2t + 1 of rows
// g and g + 8, elements 4 kk .. 4 kk + 3. K position t takes key 2t and
// t + 4 key 2t + 1, the order V^T is stored in (vt_col).
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&ph)[N / 4][4],
                                       uint32_t (&pl)[N / 4][4],
                                       const float (&s)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 4; ++kk) {
    const float x[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1],
                        s[4 * kk + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = tf32(x[e]);
      ph[kk][e] = __float_as_uint(h);
      pl[kk][e] = __float_as_uint(tf32(x[e] - h));
    }
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(WG) : "memory");
}


template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_tf32_kernel(const __grid_constant__ Params p) {
  using S = Smem<T, DP>;
  constexpr int BK = S::BK, SLOTS = S::SLOTS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);   // 1 KB
  const uint32_t base = smem_u32(smem);
  const uint32_t bar = base + S::BAR;   // full[s] at 16 s, empty[s] at +8
  float* mean = reinterpret_cast<float*>(smem + S::MEAN);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  const Work t = work_tile<BK>(
      p, blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z));

  // K's columns past D meet Q's zero columns in Q K^T: clear the ring once
  // so that they hold no NaN
  if (p.D < DP) {
    for (int x = threadIdx.x * 16; x < SLOTS * S::SLOT; x += THREADS * 16)
      *reinterpret_cast<float4*>(smem + S::RING + x) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    fence_async_smem();
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(bar + 16 * s, WG);       // full: every producer thread
      mbar_init(bar + 16 * s + 8, WG);   // empty: every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
  // the role of this thread's warpgroup, warp-uniform (lane 0's)
  const int role = __shfl_sync(FULL, threadIdx.x / WG, 0);
  if (role == 1) {
    // ------------------------------------------------------------ producer
    const T* kb = k + t.b * p.ks.b + t.hk * p.ks.h;
    const T* vb = v + t.b * p.vs.b + t.hk * p.vs.h;
    const int jobs = 2 * t.ntiles, ptid = threadIdx.x - WG;
    auto raw = [&](int j) { return S::RAW + (j % S::RAWN) * S::RAW_ITEM; };
    // cp.async of job j's quads into its raw item, one group a job
    auto copy = [&](int j) {
      if (j < jobs) {
        int n;
        bool is_v;
        job<SLOTS>(j, t.ntiles, n, is_v);
        const int k0 = (t.n_lo + n) * BK;
        if (is_v)
          Item<T, DP, true>::copy(base + raw(j), vb, p.vs.s, k0, p.Skv, p.D,
                                  warp, lane, ptid);
        else
          Item<T, DP, false>::copy(base + raw(j), kb, p.ks.s, k0, p.Skv, p.D,
                                   warp, lane, ptid);
      }
      cp_async_commit();
    };
    // job j: its quads into registers, split into its slot
    auto run = [&](auto v_tag, int j, int n) {
      constexpr bool IS_V = decltype(v_tag)::value;
      const int k0 = (t.n_lo + n) * BK;
      Item<T, DP, IS_V> x;
      if (p.kv_vec) {
        cp_async_wait<S::RAWN - 1>();    // job j's group has landed
        x.load_own(smem + raw(j), k0, p.Skv, p.D, warp, lane, ptid);
      } else {
        x.load(IS_V ? vb : kb, IS_V ? p.vs : p.ks, k0, p.Skv, p.D, warp,
               lane);
      }
      const SlotUse u = slot_use<SLOTS>(n, IS_V);
      mbar_wait(bar + 16 * u.slot + 8, u.parity ^ 1);
      x.put(smem + S::RING + u.slot * S::SLOT, p.D, warp, lane);
      fence_async_smem();
      mbar_arrive(bar + 16 * u.slot);
    };
    // Rows 16-byte aligned (8-byte for bf16) with d stride 1: the quads of
    // RAWN jobs ahead fly as cp.async, which no arrive waits for (loads in
    // registers would hold every arrive's release until they land). Any
    // other layout: element loads into registers, a job at a time.
    if (p.kv_vec)
      for (int j = 0; j < S::RAWN; ++j) copy(j);
    for (int j = 0; j < jobs; ++j) {
      int n;
      bool is_v;
      job<SLOTS>(j, t.ntiles, n, is_v);
      if (is_v)
        run(std::true_type(), j, n);
      else
        run(std::false_type(), j, n);
      if (p.kv_vec) copy(j + S::RAWN);
    }
  } else {
    // ------------------------------------------------------------ consumer
    const int row0 = 16 * warp + lane / 4;            // and row0 + 8
    const int qpos0 = t.first_q + row0;
    const uint32_t q_tile = base + S::Q;

    // Q, split once, with the producer's mapping: a warp 4 rows x 32 d a
    // step, 8 steps' loads at once; columns [D, DP) are zero, so Q K^T runs
    // DP/8 k-steps whatever D is
    {
      constexpr int STEPS = (BQ / 4) * (DP / 32) / 4;
      constexpr int QB = STEPS < 8 ? STEPS : 8;
      const T* qb = q + t.b * p.qs.b + t.h * p.qs.h;
#pragma unroll 1
      for (int j0 = 0; j0 < STEPS; j0 += QB) {
        Quad<T> x[QB];
#pragma unroll
        for (int j = 0; j < QB; ++j) {
          const int i = warp + 4 * (j0 + j);
          const int r = (i % (BQ / 4)) * 4 + (lane >> 3);
          const int d = (i / (BQ / 4)) * 32 + (lane & 7) * 4;
          if (r < t.rows && d < p.D)
            x[j].load(qb + (t.q0 + r) * p.qs.s + d * p.qs.d, p.qs.d,
                      p.q_vec);
          else
            x[j].zero();
        }
#pragma unroll
        for (int j = 0; j < QB; ++j) {
          const int i = warp + 4 * (j0 + j);
          put_row<S::SPLIT, BQ>(smem + S::Q, S::Q_COPY,
                                (i % (BQ / 4)) * 4 + (lane >> 3),
                                (i / (BQ / 4)) * 32 + (lane & 7) * 4, x[j]);
        }
      }
      fence_async_smem();
      consumer_sync();
    }

    float s[BK / 2];
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    fence_regs(s);
    fence_regs(o);
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float alpha[2] = {1.f, 1.f};
    const int n_lo = t.n_lo, ntiles = t.ntiles;
    // K (v = false) or V (v = true) of tile n: its slot's address, and
    // the waits on its "full" and the release of its "empty" mbarrier
    auto slot_addr = [&](int n, bool v) {
      return base + S::RING + slot_use<SLOTS>(n, v).slot * S::SLOT;
    };
    auto full = [&](int n, bool v) {
      const SlotUse u = slot_use<SLOTS>(n, v);
      mbar_wait(bar + 16 * u.slot, u.parity);
    };
    auto release = [&](int n, bool v) {
      mbar_arrive(bar + 16 * slot_use<SLOTS>(n, v).slot + 8);
    };

    if constexpr (SLOTS >= 2) {
      // Software pipeline, one tile deep: tile n's Q K^T and tile n-1's
      // P V start together, and tile n's softmax runs while P V is still on
      // the tensor cores. The first and the last tile are peeled so that no
      // wgmma sits in a branch.
      // In float32 each tile's P V goes into a fresh accumulator (pv) that
      // is added to O on the CUDA cores: the tensor cores' own additions
      // into a running O over thousands of keys drift past float32's
      // tolerance (a q tile's relative error norm of 1.5e-5 at 2048 keys
      // on an H100). bf16 (2e-2) keeps O on the tensor cores.
      constexpr bool FRESH = S::SPLIT;
      float pv[FRESH ? DP / 2 : 1];
#pragma unroll
      for (int i = 0; i < (FRESH ? DP / 2 : 1); ++i) pv[i] = 0.f;
      fence_regs(pv);
      float alpha_pv[2];
      auto pv_into = [&](int n) {   // P V of tile n, into pv or into O
        if constexpr (FRESH) {
          alpha_pv[0] = alpha[0];
          alpha_pv[1] = alpha[1];
          full(n, true);
          wgmma_fence();
          start_pv<T, DP>(pv, ph, pl, slot_addr(n, true), true);
        } else {
          rescale_o(o, alpha);
          fence_regs(o);
          full(n, true);
          wgmma_fence();
          start_pv<T, DP>(o, ph, pl, slot_addr(n, true), false);
        }
      };
      auto pv_done = [&](int n) {   // after wgmma_wait<0>
        if constexpr (FRESH) {
          fence_regs(pv);
#pragma unroll
          for (int i = 0; i < DP / 2; ++i)
            o[i] = fmaf(o[i], alpha_pv[(i / 2) & 1], pv[i]);
        } else {
          fence_regs(o);
        }
        release(n, true);
      };
      if (ntiles > 0) {
        full(0, false);
        fence_regs(s);
        wgmma_fence();
        start_qk<T, DP>(s, q_tile, slot_addr(0, false));
        wgmma_wait<0>();
        fence_regs(s);
        release(0, false);
        softmax(s, m, l, alpha, p, t, n_lo * BK, qpos0, lane);
        pack_p(ph, pl, s);
        fence_regs(ph);
        fence_regs(pl);
      }
      for (int n = 1; n < ntiles; ++n) {
        full(n, false);
        fence_regs(s);
        wgmma_fence();
        start_qk<T, DP>(s, q_tile, slot_addr(n, false));      // S_n
        pv_into(n - 1);                                       // P V, n-1
        wgmma_wait<1>();           // S_n is done, P V may still run
        fence_regs(s);
        release(n, false);
        softmax(s, m, l, alpha, p, t, (n_lo + n) * BK, qpos0, lane);
        wgmma_wait<0>();
        pv_done(n - 1);
        pack_p(ph, pl, s);
        fence_regs(ph);
        fence_regs(pl);
      }
      if (ntiles > 0) {
        pv_into(ntiles - 1);
        wgmma_wait<0>();
        pv_done(ntiles - 1);
      }
    } else {
      // one slot (float32 at DP 256): K and V of a tile take turns in it;
      // P V in two halves of 128 columns, each into a fresh accumulator
      // added to O on the CUDA cores, as above
      static_assert(S::SPLIT && DP == 256, "one slot: float32 at DP 256");
      float pv[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) pv[i] = 0.f;
      fence_regs(pv);
      for (int n = 0; n < ntiles; ++n) {
        full(n, false);
        fence_regs(s);
        wgmma_fence();
        start_qk<T, DP>(s, q_tile, slot_addr(n, false));
        wgmma_wait<0>();
        fence_regs(s);
        release(n, false);
        softmax(s, m, l, alpha, p, t, (n_lo + n) * BK, qpos0, lane);
        pack_p(ph, pl, s);
        fence_regs(ph);
        fence_regs(pl);
        full(n, true);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          wgmma_fence();
          start_pv<T, DP, 128>(pv, ph, pl,
                               slot_addr(n, true) + half * 128 * 128, true);
          wgmma_wait<0>();
          fence_regs(pv);
#pragma unroll
          for (int i = 0; i < 64; ++i)
            o[64 * half + i] =
                fmaf(o[64 * half + i], alpha[(i / 2) & 1], pv[i]);
        }
        release(n, true);
      }
    }

    // ------------------------------------------------------------- epilogue
    float inv[2], lsum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] = quad_sum(l[r]);
      inv[r] = 1.f / (lsum[r] == 0.f ? 1.f : lsum[r]);
    }
    // rows that see no key get the mean of v over all Skv keys. The rows
    // that see a key form one interval of positions (each mask term is a
    // half-line), so the tile holds a blind row only if its first or its
    // last row is one: a test every consumer thread makes alike.
    bool blind[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      blind[r] = row0 + 8 * r < t.rows && !sees_a_key(p, qpos0 + 8 * r);
    // the row statistic the backward reads, where asked for: m + log2(l)
    // in exp2's domain (the row's log-sum-exp of scale * q k^T, times
    // log2(e)), +inf for a row that sees no key; one lane of the quad
    if (p.lse != nullptr && (lane & 3) == 0) {
      float* lrow = p.lse + ((long long)t.b * p.Hq + t.h) * p.Sq + t.q0;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < t.rows)
          lrow[row0 + 8 * r] =
              blind[r] ? INFINITY : m[r] + log2f(lsum[r]);
    }
    if (!sees_a_key(p, t.first_q) ||
        !sees_a_key(p, t.first_q + t.rows - 1)) {
      const T* vb = v + t.b * p.vs.b + t.hk * p.vs.h;
      for (int d = threadIdx.x; d < p.D; d += WG) {
        float sum = 0.f;
        for (int c = 0; c < p.Skv; ++c)
          sum += to_f32(vb[c * p.vs.s + d * p.vs.d]);
        mean[d] = sum / (float)p.Skv;
      }
      consumer_sync();
    }
    T* ob = static_cast<T*>(p.o) + t.b * p.os.b + t.h * p.os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= t.rows) continue;
      T* orow = ob + (long long)(t.q0 + row) * p.os.s;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * (lane & 3) + c;
          if (col < p.D)
            store(orow + col * p.os.d,
                  blind[r] ? mean[col] : o[4 * j + 2 * r + c] * inv[r]);
        }
      }
    }
  }
}

template <typename T, int DP>
int launch(const Params& p, cudaStream_t stream) {
  // the shared-memory size is an attribute of the kernel on each device: set
  // it on a device's first launch (bit dev of `ready`; every launch past
  // device 63)
  static std::atomic<unsigned long long> ready{0};
  const int smem = Smem<T, DP>::BYTES;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(flash_tf32_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit);
  }
  const dim3 grid(p.nq, p.Hq, p.B);
  flash_tf32_kernel<T, DP><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32>(p, stream);
  if (p.D <= 64) return launch<T, 64>(p, stream);
  if (p.D <= 128) return launch<T, 128>(p, stream);
  return launch<T, 256>(p, stream);
}

// whether every row of t (element strides s, d stride 1) starts on a
// `bytes`-aligned address, so a row's quads load as vectors
bool rows_aligned(const void* t, const Strides& s, int elem, int bytes) {
  const long long step = bytes / elem;
  return s.d == 1 && (uintptr_t)t % bytes == 0 && s.b % step == 0 &&
         s.h % step == 0 && s.s % step == 0;
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o (B, Hq, Sq, D): element
// (b, h, s, d) of each at ptr[b*sb + h*sh + s*ss + d*sd] (strides in
// elements). dtype 0 = float32, 1 = bfloat16 (all four the same). window <= 0
// means no window; kv_len masks keys at or past it. lse: null, or a float32
// (B, Hq, Sq) contiguous buffer that gets each row's statistic for the
// backward (flash_attention_bwd.cu).
int flash_attention(const void* q, long long qsb, long long qsh,
                    long long qss, long long qsd, const void* k,
                    long long ksb, long long ksh, long long kss,
                    long long ksd, const void* v, long long vsb,
                    long long vsh, long long vss, long long vsd, void* o,
                    long long osb, long long osh, long long oss,
                    long long osd, float* lse, int B, int Hq, int Hkv,
                    int Sq, int Skv, int D, int causal, int window,
                    int q_offset, int kv_len, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || D < 8 || D > 256 || D % 8 != 0 || B > 65535 ||
      Hq > 65535 || (dtype != 0 && dtype != 1) ||
      (long long)((Sq + BQ - 1) / BQ) * Hq * B > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.qs = Strides{qsb, qsh, qss, qsd};
  p.ks = Strides{ksb, ksh, kss, ksd};
  p.vs = Strides{vsb, vsh, vss, vsd};
  p.os = Strides{osb, osh, oss, osd};
  p.group = Hq / Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.D = D;
  p.kv_end = kv_len < Skv ? kv_len : Skv;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.Hq = Hq;
  p.B = B;
  p.nq = (Sq + BQ - 1) / BQ;
  p.scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  p.lse = lse;
  // a quad (16 bytes of float32, 8 of bf16) a vector load for q, a
  // cp.async for k and v
  const int elem = dtype == 0 ? 4 : 2;
  p.q_vec = rows_aligned(q, p.qs, elem, 4 * elem);
  p.kv_vec = rows_aligned(k, p.ks, elem, 4 * elem) &&
             rows_aligned(v, p.vs, elem, 4 * elem);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(p, s);
  return dispatch<__nv_bfloat16>(p, s);
}

}  // extern "C"
