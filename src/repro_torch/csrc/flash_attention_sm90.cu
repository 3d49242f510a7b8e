// Online-softmax (flash) attention on Hopper's tensor cores (sm_90a), bf16,
// head size D in {64, 128}; plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel) for bf16 inputs and computes exactly what
// flash_attention.cu (the split-TF32 kernel, which keeps float32 and every
// other shape) and the plain version compute. For q (B, Hq, Sq, D) and
// k, v (B, Hkv, Skv, D):
//   out[b,h,i] = softmax_k(q[b,h,i] . k[b,h/g,k] / sqrt(D)) @ v[b,h/g]
// with g = Hq / Hkv (GQA: the KV head is h / g, K and V are never expanded),
// where key k is visible to query i (position q_offset + i) only if
//   k < kv_len,  k <= q_offset + i (causal),  k > q_offset + i - window.
// Masked scores are -1e30, never -inf: exp(m_prev - m_new) stays 1 while a
// row has seen only masked keys, and a real key wipes what they added. A
// query that sees no key at all gets the mean of v over all Skv keys, on an
// explicit path, as the plain version's uniform softmax gives.
//
// What bounds it on the H100. At the prefill shape (B 2, Hq 32, Hkv 8,
// S 4096, D 128, causal) the products need 4*B*Hq*(S(S+1)/2)*D = 275 GFLOP
// against 168 MB of traffic: 0.28 ms on the bf16 tensor cores (989 TFLOP/s)
// against 0.05 ms of bytes. It is bound by operations, so the design keeps
// the tensor cores fed and everything else off their path:
//
//  * One block per work tile (128 q rows, q head, batch row): a grid of
//    (ceil(Sq/128), Hq, B) blocks, whose linear index maps to the tiles so
//    that the heaviest causal q tiles of all heads and batch rows start
//    first. Three warpgroups: a producer (setmaxnreg down to 24 registers)
//    in which one thread starts every TMA copy, and two consumers
//    (setmaxnreg up to 240) that own 64 of the 128 rows each. The role is
//    taken warp-uniformly (a shuffle), in one if-else that never rejoins,
//    so that ptxas gives each role its own register budget.
//  * TMA into shared memory: Q once, then 128-key tiles of K and V into a
//    two-stage ring, each stage with a "full" mbarrier (TMA's transaction
//    count) and an "empty" one (all 256 consumer threads arrive); Q has a
//    "full" one. The tensor maps are 4-D (D, S, H, B), encoded on the host
//    from the tensors' own byte strides, so the model's (B, S, H, D)
//    projections are read in place through their movedim views. SWIZZLE_128B with a box of 64 d x 128 rows: a D-128 row
//    arrives as two boxes, each 16 KB and 1024-byte aligned; the wgmma
//    descriptors below use the same swizzle.
//    TMA zero-fills rows past Sq and keys past Skv (a zero score is not
//    -1e30, so those keys are still masked).
//  * S = Q K^T with wgmma.m64n128k16 (bf16 in, f32 accumulator), both
//    operands K-major in shared memory, D/16 k-steps.
//  * Softmax in registers: scores scaled by log2(e)/sqrt(D) into exp2's
//    domain, masked only on tiles that touch the causal diagonal, the
//    window's edge, kv_len or Skv; row max by quad shuffles; the row sum
//    kept per thread in f32 and reduced once at the end.
//  * O += P V with P in registers: the f32 score accumulator is packed into
//    bf16x2 in place as wgmma's register A operand (its layout is the
//    accumulator's), V is the B operand read MN-major (the transpose bit),
//    so V is not transposed in memory.
//  * Overlap: each consumer starts tile n's Q K^T together with tile n-1's
//    P V and runs tile n's softmax while P V is still on the tensor cores
//    (the first and last tiles peeled, so no wgmma sits in a branch), and
//    the two consumers start their products in turn (ping-pong on two named
//    barriers), so one's softmax runs under the other's products.
//  * Epilogue: O was rescaled by alpha at each tile; it is divided by l once
//    (guarded) and cast to bf16 once, and written with direct bf16x2 stores
//    through the output's strides, bounds-checked on Sq. Where the caller
//    asks for it (a non-null lse), each row's statistic m + log2(l) in
//    exp2's domain goes to a float32 (B, Hq, Sq) buffer, +inf for a row that
//    sees no key, for the backward (flash_attention_bwd.cu).
//
// Shared memory at D 128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB (one
// block an SM); at D 64 half of that.
//
// The C entry point encodes the three tensor maps (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so no -lcuda), sets the kernel's
// shared-memory size once per device, launches on the given stream and
// returns cudaGetLastError(), or 10000 + the CUresult if a map cannot be
// encoded. It allocates nothing and does not synchronise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BM = 128;              // query rows per block
constexpr int BN = 128;              // keys per tile
constexpr int THREADS = 384;         // two consumer warpgroups + a producer
constexpr int CONSUMERS = 256;
constexpr int BOX_BYTES = 128 * 64 * 2;   // one TMA box: 128 rows x 64 bf16
constexpr int STAGES = 2;            // depth of the K/V ring
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Smem {
  static constexpr int CH = D / 64;                 // boxes per row tile
  static constexpr int TILE = CH * BOX_BYTES;       // one Q, K or V tile
  static constexpr int Q = 0;
  static constexpr int K = Q + TILE;                // K[stage]
  static constexpr int V = K + STAGES * TILE;       // V[stage]
  static constexpr int BAR = V + STAGES * TILE;     // 1 + 4 STAGES mbarriers
  static constexpr int MEAN = BAR + 128;            // D floats
  static constexpr int BYTES = MEAN + 4 * D + 1024;   // + alignment slack
};
// mbarrier offsets from Smem::BAR
constexpr int Q_FULL = 0;
__device__ __forceinline__ int k_full(int s) { return 8 + 8 * s; }
__device__ __forceinline__ int v_full(int s) { return 8 + 8 * (STAGES + s); }
__device__ __forceinline__ int k_empty(int s) {
  return 8 + 8 * (2 * STAGES + s);
}
__device__ __forceinline__ int v_empty(int s) {
  return 8 + 8 * (3 * STAGES + s);
}
// the stage of the ring that holds tile it, and which use of it that is
__device__ __forceinline__ int stage(int it) { return it % STAGES; }
__device__ __forceinline__ int use_parity(int it) {
  return (it / STAGES) & 1;
}

struct Params {
  const __nv_bfloat16* v;          // for the mean of v (no-key rows)
  long long vsb, vsh, vss;         // in elements, d stride 1
  __nv_bfloat16* o;
  long long osb, osh, oss;         // in elements, d stride 1
  int group, Sq, Skv, kv_end, causal, window, q_offset;
  int Hq, B, nq;                   // heads, batch rows, q tiles
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

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
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

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4), layout type 1 (SWIZZLE_128B) in bits
// 62-63. K-major tiles (Q, K): rows 128 B apart, 8-row groups 1024 B apart
// (SBO), LBO unused. MN-major (V as B of P V): 8-key groups 1024 B apart
// (SBO), 64-wide d chunks one box apart (LBO).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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
// keep the compiler from moving accumulator reads or writes across wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (m64n128, f32) {=, +=} A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n128, f32) += A (registers, 4 x bf16x2) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n64, f32) += A (registers, 4 x bf16x2) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef D8

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}

// S = Q K^T for one 128-key tile: D/16 k-steps, committed as one group
template <int D>
__device__ __forceinline__ void start_qk(float (&s)[64], uint32_t q_tile,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss_n128(s, sw128_desc(q_tile + off, 16, 1024),
                  sw128_desc(k_tile + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V for one 128-key tile: 8 k-steps of 16 keys, one group
template <int D>
__device__ __forceinline__ void start_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[8][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_pv<D>(o, pa[kk],
                sw128_desc(v_tile + kk * 16 * 128, BOX_BYTES, 1024));
  wgmma_commit();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&h);
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

// named barriers 2 and 3: warpgroup w waits on 2 + w until the other one
// has started its products
__device__ __forceinline__ void sched_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(2 + wg), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void sched_arrive(int wg) {
  asm volatile("bar.arrive %0, %1;" ::"r"(2 + wg), "n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

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

// The online-softmax update of one 128-key tile for the thread's two rows.
// s: the tile's raw scores in the wgmma accumulator layout (element i at row
// (i / 2) % 2, key 8 (i / 4) + 2 (lane % 4) + i % 2), turned into the
// probabilities p in place; m in exp2's domain; l per thread.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Params& p, int k0,
                                             int qpos0, int lane) {
  if (MASK) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int kpos = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
      const int qpos = qpos0 + 8 * ((i / 2) & 1);
      s[i] = visible(p, qpos, kpos) ? s[i] * p.scale_log2 : NEG_INF;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = quad_max(mx);
    const float m_new = fmaxf(m[r], MASK ? mx : mx * p.scale_log2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
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

// O *= alpha, row by row (the thread's two rows)
template <int D>
__device__ __forceinline__ void rescale_o(float (&o)[D / 2],
                                          const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// P as wgmma's A operand: keys 16 kk .. 16 kk + 15 are accumulator elements
// 8 kk .. 8 kk + 7, already in the A fragment's order
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4],
                                       const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// the tile at k0 for this warpgroup's rows [wq_first, wq_last]: masked only
// where it touches the causal diagonal, the window's edge, kv_len or Skv
__device__ __forceinline__ void softmax(float (&s)[64], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        const Params& p, int k0, int qpos0,
                                        int wq_first, int wq_last, int lane) {
  const bool mask = k0 + BN > p.kv_end ||
                    (p.causal && k0 + BN - 1 > wq_first) ||
                    (p.window > 0 && k0 <= wq_last - p.window);
  if (mask)
    softmax_tile<true>(s, m, l, alpha, p, k0, qpos0, lane);
  else
    softmax_tile<false>(s, m, l, alpha, p, k0, qpos0, lane);
}

// One work tile: 128 q rows of one head of one batch row, and the key tiles
// some row of it can see, [n_lo, n_lo + ntiles). Work w = (q tile from the
// last, head, batch row): blocks start in the order of w, so the heaviest
// causal tiles of every head and batch row start first.
struct Work {
  int h, b, hk, q0, rows, first_q, n_lo, ntiles;
};

__device__ __forceinline__ Work work_tile(const Params& p, int w) {
  Work t;
  const int per_qt = p.Hq * p.B;
  const int qt = p.nq - 1 - w / per_qt;
  t.h = (w % per_qt) % p.Hq;
  t.b = (w % per_qt) / p.Hq;
  t.hk = t.h / p.group;
  t.q0 = qt * BM;
  t.rows = min(BM, p.Sq - t.q0);
  t.first_q = p.q_offset + t.q0;
  const int last_q = t.first_q + t.rows - 1;
  const int hi = p.causal ? min(p.kv_end, last_q + 1) : p.kv_end;
  const int lo = p.window > 0 ? max(0, t.first_q - p.window + 1) : 0;
  t.n_lo = lo / BN;
  t.ntiles = hi > lo ? (hi + BN - 1) / BN - t.n_lo : 0;
  return t;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const Params p) {
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;       // swizzle atoms: 1 KB
  const uint32_t bar = base + S::BAR;
  float* mean = reinterpret_cast<float*>(smem_raw + (base - raw) + S::MEAN);

  const Work t = work_tile(
      p, blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z));

  if (threadIdx.x == 0) {
    mbar_init(bar + Q_FULL, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar + k_full(s), 1);
      mbar_init(bar + v_full(s), 1);
      mbar_init(bar + k_empty(s), CONSUMERS);
      mbar_init(bar + v_empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the role of this thread's warpgroup, warp-uniform (lane 0's), so that
  // ptxas gives each role's branch its own register budget
  const int role = __shfl_sync(FULL, threadIdx.x / 128, 0);
  if (role == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(bar + Q_FULL, S::TILE);
      for (int c = 0; c < S::CH; ++c)
        tma_load(base + S::Q + c * BOX_BYTES, &tm_q, 64 * c, t.q0, t.h, t.b,
                 bar + Q_FULL);
      for (int it = 0; it < t.ntiles; ++it) {
        const int s = stage(it), parity = use_parity(it) ^ 1;
        const int k0 = (t.n_lo + it) * BN;
        mbar_wait(bar + k_empty(s), parity);
        mbar_expect_tx(bar + k_full(s), S::TILE);
        for (int c = 0; c < S::CH; ++c)
          tma_load(base + S::K + s * S::TILE + c * BOX_BYTES, &tm_k, 64 * c,
                   k0, t.hk, t.b, bar + k_full(s));
        mbar_wait(bar + v_empty(s), parity);
        mbar_expect_tx(bar + v_full(s), S::TILE);
        for (int c = 0; c < S::CH; ++c)
          tma_load(base + S::V + s * S::TILE + c * BOX_BYTES, &tm_v, 64 * c,
                   k0, t.hk, t.b, bar + v_full(s));
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int wg = role, lane = threadIdx.x & 31;
    const int warp = (threadIdx.x & 127) / 32;
    const int row0 = 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
    const int rows = t.rows, n_lo = t.n_lo, ntiles = t.ntiles;
    const int qpos0 = t.first_q + row0;
    // this warpgroup's query positions, for the per-tile mask decision
    const int wq_first = t.first_q + 64 * wg, wq_last = wq_first + 63;
    const uint32_t q_tile = base + S::Q + wg * 64 * 128;   // 64 rows x 128 B

    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    uint32_t pa[8][4];
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];

    mbar_wait(bar + Q_FULL, 0);
    // Software pipeline, one tile deep: tile it's Q K^T and tile it-1's P V
    // start together, and tile it's softmax runs while P V is still on the
    // tensor cores. The first and the last tile are peeled so that no wgmma
    // sits in a branch.
    // Ping-pong: the two warpgroups start their products in turn (named
    // barriers 2 and 3), so one warpgroup's softmax runs under the other's
    // products.
    if (ntiles > 0) {
      if (wg == 1) sched_sync(wg);
      mbar_wait(bar + k_full(0), 0);
      wgmma_fence();
      start_qk<D>(s, q_tile, base + S::K);
      sched_arrive(wg ^ 1);
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(bar + k_empty(0));
      softmax(s, m, l, alpha, p, n_lo * BN, qpos0, wq_first, wq_last, lane);
      pack_p(pa, s);
    }
    for (int it = 1; it < ntiles; ++it) {
      const int st = stage(it), parity = use_parity(it);
      const int sp = stage(it - 1), parity_p = use_parity(it - 1);
      sched_sync(wg);
      mbar_wait(bar + k_full(st), parity);
      wgmma_fence();
      start_qk<D>(s, q_tile, base + S::K + st * S::TILE);      // S_it
      rescale_o<D>(o, alpha);
      mbar_wait(bar + v_full(sp), parity_p);
      wgmma_fence();
      start_pv<D>(o, pa, base + S::V + sp * S::TILE);         // P V, it-1
      sched_arrive(wg ^ 1);
      wgmma_wait<1>();           // S_it is done, P V may still run
      fence_regs(s);
      mbar_arrive(bar + k_empty(st));
      softmax(s, m, l, alpha, p, (n_lo + it) * BN, qpos0, wq_first, wq_last,
              lane);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(bar + v_empty(sp));
      pack_p(pa, s);
    }
    if (ntiles > 0) {
      const int sp = stage(ntiles - 1), parity_p = use_parity(ntiles - 1);
      sched_sync(wg);
      rescale_o<D>(o, alpha);
      mbar_wait(bar + v_full(sp), parity_p);
      wgmma_fence();
      start_pv<D>(o, pa, base + S::V + sp * S::TILE);
      if (wg == 0) sched_arrive(wg ^ 1);
      wgmma_wait<0>();
      fence_regs(o);
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
    // last row is one: a test every consumer makes alike.
    bool blind[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      blind[r] = row0 + 8 * r < rows && !sees_a_key(p, qpos0 + 8 * r);
    // the row statistic the backward reads, where asked for: m + log2(l)
    // in exp2's domain, +inf for a row that sees no key; one lane a quad
    if (p.lse != nullptr && (lane & 3) == 0) {
      float* lrow = p.lse + ((long long)t.b * p.Hq + t.h) * p.Sq + t.q0;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < rows)
          lrow[row0 + 8 * r] =
              blind[r] ? INFINITY : m[r] + log2f(lsum[r]);
    }
    if (!sees_a_key(p, t.first_q) || !sees_a_key(p, t.first_q + rows - 1)) {
      const __nv_bfloat16* vb = p.v + t.b * p.vsb + t.hk * p.vsh;
      for (int d = threadIdx.x; d < D; d += CONSUMERS) {
        float sum = 0.f;
        for (int c = 0; c < p.Skv; ++c)
          sum += __bfloat162float(vb[c * p.vss + d]);
        mean[d] = sum / (float)p.Skv;
      }
      consumer_sync();
    }
    __nv_bfloat16* ob = p.o + t.b * p.osb + t.h * p.osh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= rows) continue;
      __nv_bfloat16* orow = ob + (long long)(t.q0 + row) * p.oss;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        const float x0 = blind[r] ? mean[col] : o[4 * j + 2 * r] * inv[r];
        const float x1 =
            blind[r] ? mean[col + 1] : o[4 * j + 2 * r + 1] * inv[r];
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// geo: dims (D, S, H, B) innermost first, then the byte strides of S, H, B
CUresult encode(CUtensorMap* map, const void* ptr,
                const unsigned long long* geo) {
  const cuuint64_t dims[4] = {geo[0], geo[1], geo[2], geo[3]};
  const cuuint64_t strides[3] = {geo[4], geo[5], geo[6]};
  const cuuint32_t box[4] = {64, 128, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const Params& p, cudaStream_t stream) {
  // the shared-memory size is an attribute of the kernel on each device: set
  // it on a device's first launch (bit dev of `ready`; every launch past
  // device 63)
  static std::atomic<unsigned long long> ready{0};
  const int smem = Smem<D>::BYTES;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(flash_sm90_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit);
  }
  const dim3 grid(p.nq, p.Hq, p.B);
  flash_sm90_kernel<D><<<grid, THREADS, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), bf16, d stride 1; geo holds,
// for q, k and v in turn, the dims (D, S, H, B) and the byte strides of
// S, H and B (7 values each; every stride a multiple of 16, every pointer
// 16-byte aligned). o (B, Hq, Sq, D) bf16 with d stride 1 and element
// strides osb, osh, oss. window <= 0 means no window; kv_len masks keys at
// or past it. lse: null, or a float32 (B, Hq, Sq) contiguous buffer that
// gets each row's statistic.
int flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                         const unsigned long long* geo, long long osb,
                         long long osh, long long oss, float* lse, int B,
                         int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                         int window, int q_offset, int kv_len, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || (D != 64 && D != 128) || Hq > 65535 || B > 65535 ||
      (long long)((Sq + BM - 1) / BM) * Hq * B > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  CUresult res = encode(&tq, q, geo);
  if (res == CUDA_SUCCESS) res = encode(&tk, k, geo + 7);
  if (res == CUDA_SUCCESS) res = encode(&tv, v, geo + 14);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  const long long e = sizeof(__nv_bfloat16);
  Params p;
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.vsb = (long long)geo[20] / e;
  p.vsh = (long long)geo[19] / e;
  p.vss = (long long)geo[18] / e;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.osb = osb;
  p.osh = osh;
  p.oss = oss;
  p.group = Hq / Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.kv_end = kv_len < Skv ? kv_len : Skv;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.Hq = Hq;
  p.B = B;
  p.nq = (Sq + BM - 1) / BM;
  p.scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  p.lse = lse;
  const cudaStream_t s = (cudaStream_t)stream;
  if (D == 64) return launch<64>(tq, tk, tv, p, s);
  return launch<128>(tq, tk, tv, p, s);
}

}  // extern "C"
