// The backward of flash attention (sm_90a): the gradients dq, dk and dv of
// out = softmax(q k^T / sqrt(D)) v under the forward's masks, float32 and
// bfloat16, head size D from 8 to 256 in steps of 8, every tensor through
// its strides; plain C interface.
//
// It replaces no TPU kernel. The JAX package trains through its jnp
// chunked_attention (src/repro/models/layers.py:57), which XLA
// differentiates; it has no Pallas backward. The port's forward attention
// is a hand-written kernel that autograd cannot see into
// (kernels/flash_attention/ops.py::FlashAttention), so its backward is one
// too. For q (B, Hq, Sq, D), k, v (B, Hkv, Skv, D), out and dout (B, Hq, Sq,
// D), with g = Hq / Hkv, scale = 1 / sqrt(D), scale_log2 = log2(e) * scale
// and key j visible to query i (position q_offset + i) only if j < kv_len,
// j <= q_offset + i (causal) and j > q_offset + i - window:
//   lse_i = the forward's row statistic m + log2(l) in exp2's domain
//       (flash_attention.cu and flash_attention_sm90.cu write it: the
//       running max of scale_log2 * q k^T and log2 of the row sum), +inf
//       for a row that sees no key
//   P = exp2(scale_log2 * q k^T - lse) on visible keys, 0 elsewhere, with
//       the forward's own ex2.approx, so each row sums to 1 as it did there
//       (a row that sees no key: 1 / Skv on every key, as the forward's
//       -1e30 fill gives)
//   delta_i = sum_d dout_i * out_i
//   dS = P * (dout v^T - delta) on visible pairs, 0 elsewhere (the fill is
//       a constant: a masked score has no gradient)
//   dq = scale * dS k,  dk = scale * sum over the group of dS^T q,
//   dv = sum over the group of P^T dout.
// Sums are float32; each output is cast to the input type once, at the end.
//
// What bounds it on the H100. At Yi-6B's training shape (B 4, Hq 32, Hkv 4,
// S 2048, D 128, causal, float32) a backward needs five products over the
// causal pairs (Q K^T recomputed, dO V^T, dS K, dS^T Q, P^T dO), each
// 2 * B * Hq * S(S+1)/2 * D = 68.7 GFLOP: 344 GFLOP against about 0.3 GB of
// traffic, bound by operations. In split TF32 (kernel 8b's arithmetic, three
// TF32 products a float32 multiply-add at 495 TFLOP/s) that is 2.08 ms.
// This design runs seven products, not five: Q K^T and dO V^T are computed
// in both passes, so that no pass needs another's dS and nothing is summed
// across blocks (no atomics).
//
// Two routes, picked from D before the launch, the same in both input
// types (kernels/flash_attention/ops.py::bwd_route, checked again here):
//
//  * "tensor cores", D <= 128 in either type: two launches of warpgroup
//    MMAs in split TF32 (flash_bwd_dq_tf32_kernel, then
//    flash_bwd_dkdv_tf32_kernel). Each float32 operand is stored as hi +
//    lo (cvt.rna, as kernel 8b) and each product is hi*lo + lo*hi + hi*hi
//    into a float32 accumulator; bf16 inputs are exact in TF32 (lo = 0),
//    so their lo copies and products are skipped, while P and dS, float32,
//    are always split. Tiles are K-major and 128-byte swizzled, read by
//    wgmma through kernel 8b's descriptors; .tf32 operands are read K-major
//    only, so every B operand whose K dimension is the key or the query row
//    is kept a second time, transposed (K^T, Q^T, dO^T), with the rows of
//    each 8 stored in the order 0 2 4 6 1 3 5 7, the order in which the
//    accumulator's registers enter as wgmma's A fragment (kernel 8b's
//    trick for P V). Every product goes into a fresh accumulator that is
//    added to the running dq, dk or dv on the CUDA cores (kernel 8b's
//    reason: the tensor cores' own additions drift past float32's
//    tolerance over thousands of terms).
//    Each block has two warpgroups: a consumer that runs the products and
//    the elementwise work, and a producer that loads each tile from device
//    memory through the tensors' strides (16-byte vector loads where rows
//    are aligned with d stride 1, element loads otherwise), splits it and
//    writes it in both layouts, in two halves each guarded by a "full" and
//    an "empty" mbarrier: the row-major half (read by the first two
//    products) and the transposed half (read by the last ones). The loads
//    of the next tile are issued right after the arrives on "full" (an
//    arrive is a release, which would wait for loads still in flight), so
//    they land while the producer waits for an "empty" barrier. There is no
//    room for a landing ring at D 128, so neither TMA nor cp.async is used.
//    - Pass A, dq: one block per (64 q rows, q head, batch row), the
//      heaviest causal tiles first (kernel 8b's order). The consumer splits
//      Q and dO once into shared memory and computes delta (written to a
//      float32 scratch for pass B). Per key tile of BK: S = Q K^T and
//      dP = dO V^T (m64nBK, A and B from shared memory); dS in registers;
//      dq += dS K (m64nDP, dS from registers, K^T from shared memory).
//    - Pass B, dk and dv: one block per (64 keys, kv head, batch row). The
//      consumer splits K and V once. It loops over the group's q heads and,
//      for each, over the q tiles of BQ rows that see a key of the block's
//      tile or hold a row that sees none. Per q tile: S^T = K Q^T and
//      dP^T = V dO^T (m64nBQ, the keys as M); P^T and dS^T in registers;
//      dv += P^T dO and dk += dS^T Q (m64nDP, from registers, dO^T and Q^T
//      from shared memory). The q heads and tiles are summed in a fixed
//      order, so the sums over the group are deterministic.
//  * "cuda cores", D > 128: the products on the CUDA cores in 32 x 32
//    tiles (flash_bwd_dq_simt_kernel, flash_bwd_dkdv_simt_kernel): each
//    thread a 2 x 2 block of scores, one shared-memory load a multiply-add.
//    Float32 at D 256 cannot hold its tiles in 227 KB, and bf16 at D 256
//    would hold dk, dv and a fresh accumulator of 128 registers each.
//
// Tiles (DP = D rounded up to 32, 64 or 128; Q's, dO's, K's and V's
// columns past D are stored as zero), shared memory in float32 (hi and
// lo; bf16 holds the inputs once and takes about half):
//
//   route         DP    pass A: BK, smem          pass B: BQ, smem
//   tensor cores   32   64 keys,  80 KB            64 rows,  96 KB
//   tensor cores   64   64 keys, 160 KB            32 rows, 128 KB
//   tensor cores  128   32 keys, 224 KB            16 rows, 224 KB
//   cuda cores    256   32 rows x 32 keys: 133 KB (pass 1), 137 KB (pass 2)
//
// Pass A keeps Q and dO (64 x DP, both layouts not needed: they are A
// operands) and one key tile of K, V and K^T; pass B keeps K and V
// (64 x DP) and one q tile of Q, dO, Q^T and dO^T plus the tile's lse and
// delta. At BQ 16 the transposed copies are padded to 32 columns, so that
// every swizzled row is 128 bytes (the padding is never read).
//
// What the tile choice costs: with N = BK or BQ of 16 to 64, the products
// S, dP, S^T and dP^T read their A operand (64 x 8 floats, 2 KB a k-step)
// from shared memory for little work (64 x N x 8 multiply-adds), so they
// are bound by shared-memory bandwidth, not by the tensor cores, at D 128:
// shared memory cannot hold wider tiles of both layouts there.
//
// Determinism: every output element has one writer, every sum runs in a
// fixed order, and nothing is atomic, so two runs on the same inputs give
// the same bits.
//
// The C entry point launches both passes on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int WG = 128;             // threads of a warpgroup
constexpr int THREADS = 2 * WG;     // the consumer, then the producer
constexpr int BM = 64;              // wgmma's M: q rows (A), keys (B)
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s, d;   // in elements
};

struct Params {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  const float* lse;   // (B, Hq, Sq): the forward's statistic
  float* delta;       // (B, Hq, Sq) scratch: rowsum(dout * out)
  int B, Hq, Hkv, group, Sq, Skv, D;
  int kv_end;         // min(kv_len, Skv), at least 0
  int causal, window, q_offset;
  int q_vec, k_vec, v_vec, do_vec;   // rows 16-byte aligned, d stride 1
  float scale, scale_log2;
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

// make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's operand reads)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(WG) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (kernel 8b's): start
// address, LBO unused, SBO 1024 bytes between 8-row groups, layout type 1
// (SWIZZLE_128B) in bits 62-63
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of wgmma's register
// operands across wgmma (ptxas would serialise every wgmma of the kernel)
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

// d (m64n16, f32) {=, +=} A (smem) * B (smem), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : D8(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

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

#undef D8

// ------------------------------------------------------------- the split
// x rounded to TF32, to nearest with ties away from zero (the low 13 bits 0)
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// four consecutive d of one row: a vector load where the row is aligned and
// its d stride 1, four element loads otherwise
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

// the K position of row c of a transposed tile: within each 8, in the order
// 0 2 4 6 1 3 5 7 (see pack)
__device__ __forceinline__ int t_col(int c) {
  return (c & ~7) | ((c & 7) >> 1) | ((c & 1) << 2);
}

// An R-row x DP-column tile of a (., ., S, D) tensor as one warpgroup holds
// it: quad j of a thread covers row r, d .. d + 3 (i = warp + 4 j):
//   r = 16 (i % (R/16)) + lane % 16,  d = 8 (i / (R/16)) + 4 (lane / 16):
// sixteen rows a warp step, which keeps both the row-major (float4) and the
// transposed (scalar) stores below free of bank conflicts, and reads 32
// contiguous bytes of each row (float32).
template <typename T, int R, int DP>
struct Rows {
  static constexpr bool SPLIT = std::is_same<T, float>::value;
  static constexpr int STEPS = R * DP / 512;
  Quad<T> x[STEPS];

  __device__ __forceinline__ static void at(int j, int warp, int lane, int& r,
                                            int& d) {
    const int i = warp + 4 * j;
    r = (i % (R / 16)) * 16 + (lane & 15);
    d = (i / (R / 16)) * 8 + (lane >> 4) * 4;
  }

  // rows row0 .. row0 + R - 1 of base; rows at or past n_rows and columns
  // at or past D are zero
  __device__ __forceinline__ void load(const T* base, const Strides& s,
                                       int row0, int n_rows, int D, bool vec,
                                       int warp, int lane) {
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      int r, d;
      at(j, warp, lane, r, d);
      if (r < n_rows && d < D)
        x[j].load(base + (long long)(row0 + r) * s.s + (long long)d * s.d,
                  s.d, vec);
      else
        x[j].zero();
    }
  }

  // as a K-major tile of R rows (K = d): hi, and lo `copy` bytes on
  __device__ __forceinline__ void put_rows(uint8_t* tile, int copy, int warp,
                                           int lane) const {
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      int r, d;
      at(j, warp, lane, r, d);
      float h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = x[j].at(e);
        h[e] = SPLIT ? tf32(v) : v;      // a bf16 value is a TF32 value
        l[e] = SPLIT ? tf32(v - h[e]) : 0.f;
      }
      const uint32_t off = swz<R>(r, d);
      *reinterpret_cast<float4*>(tile + off) =
          make_float4(h[0], h[1], h[2], h[3]);
      if (SPLIT)
        *reinterpret_cast<float4*>(tile + copy + off) =
            make_float4(l[0], l[1], l[2], l[3]);
    }
  }

  // transposed, as a K-major tile of DP rows (K = the R rows, row r at
  // column t_col(r))
  __device__ __forceinline__ void put_cols(uint8_t* tile, int copy, int warp,
                                           int lane) const {
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      int r, d;
      at(j, warp, lane, r, d);
      const int col = t_col(r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = x[j].at(e);
        const float h = SPLIT ? tf32(v) : v;
        const uint32_t off = swz<DP>(d + e, col);
        *reinterpret_cast<float*>(tile + off) = h;
        if (SPLIT) *reinterpret_cast<float*>(tile + copy + off) = tf32(v - h);
      }
    }
  }
};

// ------------------------------------------------------------ the products
// d = A B^T over DP (A: 64 rows at a, B: N rows at b, both K-major, their lo
// copies a_copy and b_copy bytes on): DP/8 k-steps, the small terms first;
// one commit group. Unrolled: a wgmma in a loop of run-time length gets its
// accumulators copied at the loop's edge, and ptxas then serialises every
// wgmma of the kernel.
template <bool SPLIT, int DP, int N>
__device__ __forceinline__ void start_ss(float (&d)[N / 2], uint32_t a,
                                         int a_copy, uint32_t b, int b_copy) {
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const uint32_t ao = (kk >> 2) * (BM * 128) + (kk & 3) * 32;
    const uint32_t bo = (kk >> 2) * (N * 128) + (kk & 3) * 32;
    if (SPLIT) {
      wgmma_ss(d, sw128_desc(a + a_copy + ao), sw128_desc(b + bo),
               kk > 0);                                       // lo hi
      wgmma_ss(d, sw128_desc(a + ao), sw128_desc(b + b_copy + bo), 1);
    }
  }
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const uint32_t ao = (kk >> 2) * (BM * 128) + (kk & 3) * 32;
    const uint32_t bo = (kk >> 2) * (N * 128) + (kk & 3) * 32;
    wgmma_ss(d, sw128_desc(a + ao), sw128_desc(b + bo), SPLIT || kk > 0);
  }
  wgmma_commit();
}

// d = A B over K (A: the split fragments ah, al of K/8 k-steps; B: DP rows
// at b, K-major over K, its lo copy b_copy bytes on), into a fresh
// accumulator; one commit group
template <bool SPLIT, int DP, int K>
__device__ __forceinline__ void start_rs(float (&d)[DP / 2],
                                         const uint32_t (&ah)[K / 8][4],
                                         const uint32_t (&al)[K / 8][4],
                                         uint32_t b, int b_copy) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint32_t bo = (kk >> 2) * (DP * 128) + (kk & 3) * 32;
    wgmma_rs(d, al[kk], sw128_desc(b + bo), kk > 0);           // lo hi
    if (SPLIT) wgmma_rs(d, ah[kk], sw128_desc(b + b_copy + bo), 1);
  }
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint32_t bo = (kk >> 2) * (DP * 128) + (kk & 3) * 32;
    wgmma_rs(d, ah[kk], sw128_desc(b + bo), 1);                // hi hi
  }
  wgmma_commit();
}

// An accumulator of N/2 floats, split, as wgmma's tf32 A operand over its
// N columns (kernel 8b's pack_p): for k-step kk the fragment holds (row g,
// k t), (g + 8, t), (g, t + 4), (g + 8, t + 4) (g = lane / 4, t = lane % 4)
// and the thread's accumulator holds columns 8 kk + 2t and 2t + 1 of rows g
// and g + 8: K position t takes column 2t and t + 4 column 2t + 1, the
// order the transposed tiles are stored in (t_col).
template <int N>
__device__ __forceinline__ void pack(uint32_t (&ah)[N / 8][4],
                                     uint32_t (&al)[N / 8][4],
                                     const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    const float x[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1],
                        s[4 * kk + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = tf32(x[e]);
      ah[kk][e] = __float_as_uint(h);
      al[kk][e] = __float_as_uint(tf32(x[e] - h));
    }
  }
}

// ---------------------------------------------------------------- masking
__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.kv_end && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}
// the keys [lo, hi) visible to the query at position qpos (empty if hi <= lo)
__device__ __forceinline__ void visible_keys(const Params& p, int qpos,
                                             int& lo, int& hi) {
  lo = p.window > 0 ? max(0, qpos - p.window + 1) : 0;
  hi = p.causal ? min(p.kv_end, qpos + 1) : p.kv_end;
}
__device__ __forceinline__ bool sees_a_key(const Params& p, int qpos) {
  int lo, hi;
  visible_keys(p, qpos, lo, hi);
  return lo < hi;
}
// whether a q tile [i0, i0 + n) of pass B reaches the key tile [j0, j0 + nk):
// some row sees a key of it, or some row sees no key at all (its 1 / Skv
// reaches every key's dv). Rows that see no key are a prefix and a suffix
// of the positions, and lo and hi grow with the position.
__device__ __forceinline__ bool reaches(const Params& p, int i0, int n,
                                        int j0, int nk) {
  int lo_f, hi_f, lo_l, hi_l;
  visible_keys(p, p.q_offset + i0, lo_f, hi_f);
  visible_keys(p, p.q_offset + i0 + n - 1, lo_l, hi_l);
  return hi_f <= lo_f || hi_l <= lo_l || (lo_f < j0 + nk && hi_l > j0);
}

// the smem base of a block, 1 KB aligned (swizzle atoms)
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw_ptr) {
  const uint32_t raw = smem_u32(raw_ptr);
  return raw_ptr + (((raw + 1023) & ~1023u) - raw);
}

// ------------------------------------------------- the tensor-core route
template <int DP>
struct Tiles;
template <>
struct Tiles<32> {
  static constexpr int BK = 64, BQ = 64;
};
template <>
struct Tiles<64> {
  static constexpr int BK = 64, BQ = 32;
};
template <>
struct Tiles<128> {
  static constexpr int BK = 32, BQ = 16;
};

// pass A: Q, dO (64 x DP, resident), K, V (BK x DP), K^T (DP x BK), the
// copies of each float32 input hi then lo
template <typename T, int DP>
struct SmemA {
  static constexpr bool SPLIT = std::is_same<T, float>::value;
  static constexpr int C = SPLIT ? 2 : 1;
  static constexpr int BK = Tiles<DP>::BK;
  static constexpr int Q_COPY = BM * DP * 4;
  static constexpr int K_COPY = BK * DP * 4;
  static constexpr int KT_COPY = DP * BK * 4;
  static constexpr int Q = 0;
  static constexpr int DO = Q + C * Q_COPY;
  static constexpr int K = DO + C * Q_COPY;
  static constexpr int V = K + C * K_COPY;
  static constexpr int KT = V + C * K_COPY;
  static constexpr int BAR = KT + C * KT_COPY;   // 4 mbarriers
  static constexpr int DELTA = BAR + 32;         // BM floats
  static constexpr int BYTES = DELTA + 4 * BM + 1024;   // + alignment slack
  static_assert(BK >= 32, "K^T rows must be 128 bytes");
  static_assert(BYTES <= 232448, "over the 227 KB a block can have");
};

// pass B: K, V (64 x DP, resident), Q, dO (BQ x DP), Q^T, dO^T (DP x QC,
// the BQ rows padded to 32 columns), the tile's lse and delta
template <typename T, int DP>
struct SmemB {
  static constexpr bool SPLIT = std::is_same<T, float>::value;
  static constexpr int C = SPLIT ? 2 : 1;
  static constexpr int BQ = Tiles<DP>::BQ;
  static constexpr int QC = BQ < 32 ? 32 : BQ;
  static constexpr int K_COPY = BM * DP * 4;
  static constexpr int Q_COPY = BQ * DP * 4;
  static constexpr int QT_COPY = DP * QC * 4;
  static constexpr int K = 0;
  static constexpr int V = K + C * K_COPY;
  static constexpr int Q = V + C * K_COPY;
  static constexpr int DO = Q + C * Q_COPY;
  static constexpr int QT = DO + C * Q_COPY;
  static constexpr int DOT = QT + C * QT_COPY;
  static constexpr int BAR = DOT + C * QT_COPY;  // 4 mbarriers
  static constexpr int STATS = BAR + 32;         // lse[BQ], delta[BQ]
  static constexpr int BYTES = STATS + 8 * BQ + 1024;
  static_assert(BYTES <= 232448, "over the 227 KB a block can have");
};

// the four mbarriers of a block, from its BAR offset: the row-major half
// (full, empty) and the transposed half (full, empty). "full" counts the
// producer's 128 threads, "empty" the consumer's.
constexpr int ROWS_FULL = 0, ROWS_EMPTY = 8, T_FULL = 16, T_EMPTY = 24;

__device__ __forceinline__ void init_bars(uint32_t bar) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bar + 8 * i, WG);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------- pass A
// dS of one key tile in place of S, for the thread's two rows: element i at
// row (i / 2) % 2, key k0 + 8 (i / 4) + 2 (lane % 4) + i % 2
template <bool MASK, int N>
__device__ __forceinline__ void ds_rows(float (&s)[N], const float (&dp)[N],
                                        const float (&lse)[2],
                                        const float (&delta)[2],
                                        const Params& p, int k0, int qpos0,
                                        int lane) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i / 2) & 1;
    const int kpos = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
    float ds = 0.f;
    if (!MASK || visible(p, qpos0 + 8 * r, kpos)) {
      const float pr = ex2(fmaf(s[i], p.scale_log2, -lse[r]));
      ds = pr * (dp[i] - delta[r]);
    }
    s[i] = ds;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tf32_kernel(const __grid_constant__ Params p) {
  using S = SmemA<T, DP>;
  constexpr bool SPLIT = S::SPLIT;
  constexpr int BK = S::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar = base + S::BAR;
  float* delta_s = reinterpret_cast<float*>(smem + S::DELTA);

  // the work tile: 64 q rows, the heaviest causal tiles of every head and
  // batch row first
  const int w = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int nq = gridDim.x, per_qt = p.Hq * p.B;
  const int qt = nq - 1 - w / per_qt;
  const int h = (w % per_qt) % p.Hq, b = (w % per_qt) / p.Hq;
  const int hk = h / p.group;
  const int q0 = qt * BM, rows = min(BM, p.Sq - q0);
  const int first_q = p.q_offset + q0, last_q = first_q + rows - 1;
  const int hi = p.causal ? min(p.kv_end, last_q + 1) : p.kv_end;
  const int lo = p.window > 0 ? max(0, first_q - p.window + 1) : 0;
  const int n_lo = lo / BK;
  const int ntiles = hi > lo ? (hi + BK - 1) / BK - n_lo : 0;
  const long long stat = ((long long)b * p.Hq + h) * p.Sq;

  init_bars(bar);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
  const int role = __shfl_sync(FULL, threadIdx.x / WG, 0);
  if (role == 1) {
    // ------------------------------------------------------------ producer
    const T* kb = static_cast<const T*>(p.k) + b * p.ks.b + hk * p.ks.h;
    const T* vb = static_cast<const T*>(p.v) + b * p.vs.b + hk * p.vs.h;
    Rows<T, BK, DP> kx, vx;
    auto load = [&](int n) {
      const int k0 = (n_lo + n) * BK, nk = min(BK, p.Skv - k0);
      kx.load(kb, p.ks, k0, nk, p.D, p.k_vec, warp, lane);
      vx.load(vb, p.vs, k0, nk, p.D, p.v_vec, warp, lane);
    };
    if (ntiles > 0) load(0);
    for (int n = 0; n < ntiles; ++n) {
      const int par = (n & 1) ^ 1;
      mbar_wait(bar + ROWS_EMPTY, par);
      kx.put_rows(smem + S::K, S::K_COPY, warp, lane);
      vx.put_rows(smem + S::V, S::K_COPY, warp, lane);
      fence_async_smem();
      mbar_arrive(bar + ROWS_FULL);
      mbar_wait(bar + T_EMPTY, par);
      kx.put_cols(smem + S::KT, S::KT_COPY, warp, lane);
      fence_async_smem();
      mbar_arrive(bar + T_FULL);
      if (n + 1 < ntiles) load(n + 1);
    }
    return;
  }
  // -------------------------------------------------------------- consumer
  const T* qb = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
  const T* dob = static_cast<const T*>(p.dout) + b * p.dos.b + h * p.dos.h;
  const T* ob = static_cast<const T*>(p.o) + b * p.os.b + h * p.os.h;
  {
    // Q and dO, split once
    Rows<T, BM, DP> x;
    x.load(qb, p.qs, q0, rows, p.D, p.q_vec, warp, lane);
    x.put_rows(smem + S::Q, S::Q_COPY, warp, lane);
    x.load(dob, p.dos, q0, rows, p.D, p.do_vec, warp, lane);
    x.put_rows(smem + S::DO, S::Q_COPY, warp, lane);
    // delta = rowsum(dO * O): two threads a row, in a fixed order
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    float acc = 0.f;
    if (r < rows) {
      const T* dr = dob + (long long)(q0 + r) * p.dos.s;
      const T* orow = ob + (long long)(q0 + r) * p.os.s;
      for (int d = half; d < p.D; d += 2)
        acc = fmaf(to_f32(dr[d * p.dos.d]), to_f32(orow[d * p.os.d]), acc);
    }
    acc += __shfl_xor_sync(FULL, acc, 1);
    if (half == 0) {
      delta_s[r] = acc;
      if (r < rows) p.delta[stat + q0 + r] = acc;
    }
    fence_async_smem();
    consumer_sync();
  }
  const int row0 = 16 * warp + lane / 4;            // and row0 + 8
  const int qpos0 = first_q + row0;
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    // a row past Sq takes no part: exp2(s - inf) = 0
    lse[r] = row < rows ? p.lse[stat + q0 + row] : INFINITY;
    delta[r] = delta_s[row];
  }

  float s[BK / 2], dp[BK / 2], acc[DP / 2], dq[DP / 2];
  uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = dq[i] = 0.f;
  fence_regs(s);
  fence_regs(dp);
  fence_regs(acc);
  for (int n = 0; n < ntiles; ++n) {
    const int par = n & 1, k0 = (n_lo + n) * BK;
    mbar_wait(bar + ROWS_FULL, par);
    wgmma_fence();
    start_ss<SPLIT, DP, BK>(s, base + S::Q, S::Q_COPY, base + S::K,
                            S::K_COPY);                       // S = Q K^T
    start_ss<SPLIT, DP, BK>(dp, base + S::DO, S::Q_COPY, base + S::V,
                            S::K_COPY);                       // dP = dO V^T
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    mbar_arrive(bar + ROWS_EMPTY);
    // masked only where the tile touches the causal diagonal, the window's
    // edge, kv_len or Skv
    const bool mask = k0 + BK > p.kv_end ||
                      (p.causal && k0 + BK - 1 > first_q) ||
                      (p.window > 0 && k0 <= first_q + BM - 1 - p.window);
    if (mask)
      ds_rows<true>(s, dp, lse, delta, p, k0, qpos0, lane);
    else
      ds_rows<false>(s, dp, lse, delta, p, k0, qpos0, lane);
    pack<BK>(ah, al, s);
    fence_regs(ah);
    fence_regs(al);
    mbar_wait(bar + T_FULL, par);
    wgmma_fence();
    start_rs<SPLIT, DP, BK>(acc, ah, al, base + S::KT, S::KT_COPY);  // dS K
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar + T_EMPTY);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] += acc[i];
  }

  T* dqb = static_cast<T*>(p.dq) + b * p.dqs.b + h * p.dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
    T* drow = dqb + (long long)(q0 + row) * p.dqs.s;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * (lane & 3) + c;
        if (col < p.D)
          store(drow + col * p.dqs.d, dq[4 * j + 2 * r + c] * p.scale);
      }
  }
}

// ---------------------------------------------------------------- pass B
// P^T in place of S^T and dS^T in place of dP^T for one q tile: element i
// at key row (i / 2) % 2 (kpos0 + 8 of it), q column c = 8 (i / 4) +
// 2 (lane % 4) + i % 2, whose lse and delta are lse[2 (i / 4) + i % 2]
template <bool MASK, int N>
__device__ __forceinline__ void p_ds_cols(float (&s)[N], float (&dp)[N],
                                          const float (&lse)[N / 2],
                                          const float (&delta)[N / 2],
                                          const bool (&blind)[N / 2],
                                          const Params& p, int kpos0,
                                          int qpos_c0, int lane,
                                          float uniform) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = 2 * (i / 4) + (i & 1);
    const int kpos = kpos0 + 8 * ((i / 2) & 1);
    const int qpos = qpos_c0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
    float pr = 0.f, ds = 0.f;
    if (!MASK || visible(p, qpos, kpos)) {
      pr = ex2(fmaf(s[i], p.scale_log2, -lse[c]));
      ds = pr * (dp[i] - delta[c]);
    } else if (blind[c] && kpos < p.Skv) {
      pr = uniform;
    }
    s[i] = pr;
    dp[i] = ds;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_tf32_kernel(const __grid_constant__ Params p) {
  using S = SmemB<T, DP>;
  constexpr bool SPLIT = S::SPLIT;
  constexpr int BQ = S::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar = base + S::BAR;
  float* stats = reinterpret_cast<float*>(smem + S::STATS);

  // the work tile: 64 keys of one kv head and batch row, the first keys
  // (the most q rows under a causal mask) first
  const int w = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int per_kt = p.Hkv * p.B;
  const int kt = w / per_kt;
  const int hk = (w % per_kt) % p.Hkv, b = (w % per_kt) / p.Hkv;
  const int j0 = kt * BM, nk = min(BM, p.Skv - j0);
  const int nqt = (p.Sq + BQ - 1) / BQ, njobs = p.group * nqt;
  // the next job (q head g = jx / nqt, q tile jx % nqt) at or after jx
  // that reaches the key tile
  auto next = [&](int jx) {
    for (; jx < njobs; ++jx) {
      const int i0 = (jx % nqt) * BQ;
      if (reaches(p, i0, min(BQ, p.Sq - i0), j0, nk)) break;
    }
    return jx;
  };

  init_bars(bar);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
  const int role = __shfl_sync(FULL, threadIdx.x / WG, 0);
  if (role == 1) {
    // ------------------------------------------------------------ producer
    const int ptid = threadIdx.x - WG;
    Rows<T, BQ, DP> qx, dx;
    float st_lse = INFINITY, st_delta = 0.f;
    auto load = [&](int jx) {
      const int h = hk * p.group + jx / nqt, i0 = (jx % nqt) * BQ;
      const int nrows = min(BQ, p.Sq - i0);
      qx.load(static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h, p.qs,
              i0, nrows, p.D, p.q_vec, warp, lane);
      dx.load(static_cast<const T*>(p.dout) + b * p.dos.b + h * p.dos.h,
              p.dos, i0, nrows, p.D, p.do_vec, warp, lane);
      if (ptid < BQ) {
        const long long at = ((long long)b * p.Hq + h) * p.Sq + i0 + ptid;
        // a row past Sq takes no part: exp2(s - inf) = 0
        st_lse = ptid < nrows ? p.lse[at] : INFINITY;
        st_delta = ptid < nrows ? p.delta[at] : 0.f;
      }
    };
    int jx = next(0);
    if (jx < njobs) load(jx);
    for (int n = 0; jx < njobs; ++n) {
      const int par = (n & 1) ^ 1;
      mbar_wait(bar + ROWS_EMPTY, par);
      qx.put_rows(smem + S::Q, S::Q_COPY, warp, lane);
      dx.put_rows(smem + S::DO, S::Q_COPY, warp, lane);
      if (ptid < BQ) {
        stats[ptid] = st_lse;
        stats[BQ + ptid] = st_delta;
      }
      fence_async_smem();
      mbar_arrive(bar + ROWS_FULL);
      mbar_wait(bar + T_EMPTY, par);
      qx.put_cols(smem + S::QT, S::QT_COPY, warp, lane);
      dx.put_cols(smem + S::DOT, S::QT_COPY, warp, lane);
      fence_async_smem();
      mbar_arrive(bar + T_FULL);
      jx = next(jx + 1);
      if (jx < njobs) load(jx);
    }
    return;
  }
  // -------------------------------------------------------------- consumer
  {
    // K and V of the block's keys, split once
    Rows<T, BM, DP> x;
    x.load(static_cast<const T*>(p.k) + b * p.ks.b + hk * p.ks.h, p.ks, j0,
           nk, p.D, p.k_vec, warp, lane);
    x.put_rows(smem + S::K, S::K_COPY, warp, lane);
    x.load(static_cast<const T*>(p.v) + b * p.vs.b + hk * p.vs.h, p.vs, j0,
           nk, p.D, p.v_vec, warp, lane);
    x.put_rows(smem + S::V, S::K_COPY, warp, lane);
    fence_async_smem();
    consumer_sync();
  }
  const int krow0 = 16 * warp + lane / 4;           // and krow0 + 8
  const int kpos0 = j0 + krow0;
  const float uniform = 1.f / (float)p.Skv;         // a row that sees no key

  float s[BQ / 2], dp[BQ / 2], acc[DP / 2], dk[DP / 2], dv[DP / 2];
  uint32_t ah[BQ / 8][4], al[BQ / 8][4];
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = dk[i] = dv[i] = 0.f;
  fence_regs(s);
  fence_regs(dp);
  fence_regs(acc);
  int n = 0;
  for (int jx = next(0); jx < njobs; jx = next(jx + 1), ++n) {
    const int par = n & 1;
    const int i0 = (jx % nqt) * BQ, nrows = min(BQ, p.Sq - i0);
    const int qpos_first = p.q_offset + i0;
    mbar_wait(bar + ROWS_FULL, par);
    wgmma_fence();
    start_ss<SPLIT, DP, BQ>(s, base + S::K, S::K_COPY, base + S::Q,
                            S::Q_COPY);                       // S^T = K Q^T
    start_ss<SPLIT, DP, BQ>(dp, base + S::V, S::K_COPY, base + S::DO,
                            S::Q_COPY);                       // dP^T = V dO^T
    // this thread's q columns: 8 jj + 2 (lane % 4) + e
    float lse[BQ / 4], delta[BQ / 4];
    bool blind[BQ / 4];
#pragma unroll
    for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jj + 2 * (lane & 3) + e;
        lse[2 * jj + e] = stats[c];
        delta[2 * jj + e] = stats[BQ + c];
        blind[2 * jj + e] = c < nrows && !sees_a_key(p, qpos_first + c);
      }
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    mbar_arrive(bar + ROWS_EMPTY);
    // masked unless every pair of the tile is visible (then no row of it is
    // blind, and rows past Sq give 0 through their infinite lse)
    const bool mask = !(j0 + BM <= p.kv_end &&
                        (!p.causal || j0 + BM - 1 <= qpos_first) &&
                        (p.window <= 0 ||
                         j0 > qpos_first + BQ - 1 - p.window));
    if (mask)
      p_ds_cols<true>(s, dp, lse, delta, blind, p, kpos0, qpos_first, lane,
                      uniform);
    else
      p_ds_cols<false>(s, dp, lse, delta, blind, p, kpos0, qpos_first, lane,
                       uniform);
    pack<BQ>(ah, al, s);
    fence_regs(ah);
    fence_regs(al);
    mbar_wait(bar + T_FULL, par);
    wgmma_fence();
    start_rs<SPLIT, DP, BQ>(acc, ah, al, base + S::DOT, S::QT_COPY);  // P^T dO
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dv[i] += acc[i];
    pack<BQ>(ah, al, dp);
    fence_regs(ah);
    fence_regs(al);
    wgmma_fence();
    start_rs<SPLIT, DP, BQ>(acc, ah, al, base + S::QT, S::QT_COPY);   // dS^T Q
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar + T_EMPTY);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] += acc[i];
  }

  T* dkb = static_cast<T*>(p.dk) + b * p.dks.b + hk * p.dks.h;
  T* dvb = static_cast<T*>(p.dv) + b * p.dvs.b + hk * p.dvs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow0 + 8 * r;
    if (row >= nk) continue;
    T* krow = dkb + (long long)(j0 + row) * p.dks.s;
    T* vrow = dvb + (long long)(j0 + row) * p.dvs.s;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * (lane & 3) + c;
        if (col < p.D) {
          store(krow + col * p.dks.d, dk[4 * j + 2 * r + c] * p.scale);
          store(vrow + col * p.dvs.d, dv[4 * j + 2 * r + c]);
        }
      }
  }
}

// --------------------------------------------------- the CUDA-core route
constexpr int SB = 32;    // q rows and keys a tile
constexpr int LDP = SB + 1;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// Rows row0 .. row0 + 31 of a (., ., S, D) tensor at base + off into a 32 x
// (D + 1) float tile; rows at or past n_valid are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          long long off, const Strides& s,
                                          int row0, int n_valid, int D) {
  for (int idx = threadIdx.x; idx < 32 * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    float x = 0.f;
    if (r < n_valid)
      x = to_f32(base[off + (long long)(row0 + r) * s.s + (long long)d * s.d]);
    dst[r * ld + d] = x;
  }
}

// out[a][c] = A[ra + a] . B[cb + c] over D, for a, c in {0, 1}.
__device__ __forceinline__ void dots(const float* A, const float* B, int ld,
                                     int D, int ra, int cb, float out[2][2]) {
  const float* a0 = A + ra * ld;
  const float* a1 = a0 + ld;
  const float* b0 = B + cb * ld;
  const float* b1 = b0 + ld;
  float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float x0 = a0[d], x1 = a1[d], y0 = b0[d], y1 = b1[d];
    s00 = fmaf(x0, y0, s00);
    s01 = fmaf(x0, y1, s01);
    s10 = fmaf(x1, y0, s10);
    s11 = fmaf(x1, y1, s11);
  }
  out[0][0] = s00;
  out[0][1] = s01;
  out[1][0] = s10;
  out[1][1] = s11;
}

__host__ __device__ constexpr int simt_smem_floats(int D, int ps_tiles) {
  return 4 * 32 * (D + 1) + ps_tiles * 32 * LDP + 2 * 32;
}

// pass 1: one block per (32-row q tile, q head, batch row): loads Q and dO,
// computes delta (to the scratch for pass 2), reads the rows' lse, and walks
// the key tiles the rows can see: P = exp2(s - lse), dP = dO V^T, dS into
// shared memory, dQ += dS K in registers (a thread: one row, every eighth
// column)
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_simt_kernel(const Params p) {
  extern __shared__ float sm[];
  const int D = p.D, ld = D + 1;
  float* Qs = sm;
  float* dOs = Qs + SB * ld;
  float* Ks = dOs + SB * ld;
  float* Vs = Ks + SB * ld;
  float* Ss = Vs + SB * ld;          // dS, [SB][LDP]
  float* lse_s = Ss + SB * LDP;
  float* delta_s = lse_s + SB;

  const int t = threadIdx.x;
  const int i0 = blockIdx.x * SB, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int nrows = min(SB, p.Sq - i0);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* o = static_cast<const T*>(p.o);
  const T* dout = static_cast<const T*>(p.dout);
  const long long qoff = b * p.qs.b + h * p.qs.h;
  const long long ooff = b * p.os.b + h * p.os.h;
  const long long dooff = b * p.dos.b + h * p.dos.h;
  const long long koff = b * p.ks.b + hk * p.ks.h;
  const long long voff = b * p.vs.b + hk * p.vs.h;
  const long long row_stat = ((long long)b * p.Hq + h) * p.Sq + i0;

  load_tile(Qs, ld, q, qoff, p.qs, i0, nrows, D);
  load_tile(dOs, ld, dout, dooff, p.dos, i0, nrows, D);
  __syncthreads();

  // delta: a row to 8 consecutive lanes, every eighth column each
  const int r8 = t >> 3, l8 = t & 7;
  {
    float acc = 0.f;
    if (r8 < nrows)
      for (int d = l8; d < D; d += 8)
        acc = fmaf(dOs[r8 * ld + d],
                   to_f32(o[ooff + (long long)(i0 + r8) * p.os.s +
                            (long long)d * p.os.d]),
                   acc);
#pragma unroll
    for (int s = 4; s > 0; s >>= 1)
      acc += __shfl_xor_sync(FULL, acc, s);
    if (l8 == 0) {
      delta_s[r8] = acc;
      lse_s[r8] = r8 < nrows ? p.lse[row_stat + r8] : INFINITY;
      if (r8 < nrows) p.delta[row_stat + r8] = acc;
    }
  }

  // scores: rows rs, rs + 1 and keys cs, cs + 1 of a tile to each thread
  const int rs = (t >> 4) * 2, cs = (t & 15) * 2;
  int lo[2], hi[2];
  bool valid[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    valid[a] = rs + a < nrows;
    visible_keys(p, p.q_offset + i0 + rs + a, lo[a], hi[a]);
  }
  // the keys some row of the tile sees: from the first row's lo to the
  // last row's hi (both grow with the position)
  int kmin, kmax, unused;
  visible_keys(p, p.q_offset + i0, kmin, unused);
  visible_keys(p, p.q_offset + i0 + nrows - 1, unused, kmax);

  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  for (int k0 = kmin; k0 < kmax; k0 += SB) {
    __syncthreads();
    const int nk = min(SB, p.Skv - k0);
    load_tile(Ks, ld, k, koff, p.ks, k0, nk, D);
    load_tile(Vs, ld, v, voff, p.vs, k0, nk, D);
    __syncthreads();
    float s[2][2], dp[2][2];
    dots(Qs, Ks, ld, D, rs, cs, s);
    dots(dOs, Vs, ld, D, rs, cs, dp);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = k0 + cs + c;
        float ds = 0.f;
        if (valid[a] && j >= lo[a] && j < hi[a]) {
          const float pr =
              ex2(fmaf(s[a][c], p.scale_log2, -lse_s[rs + a]));
          ds = pr * (dp[a][c] - delta_s[rs + a]);
        }
        Ss[(rs + a) * LDP + cs + c] = ds;
      }
    }
    __syncthreads();
    const float* srow = Ss + r8 * LDP;
#pragma unroll 4
    for (int c = 0; c < SB; ++c) {
      const float ds = srow[c];
      const float* kr = Ks + c * ld;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int d = l8 + 8 * cc;
        if (d < D) acc[cc] = fmaf(ds, kr[d], acc[cc]);
      }
    }
  }
  if (r8 < nrows) {
    T* dq = static_cast<T*>(p.dq);
    const long long base =
        b * p.dqs.b + h * p.dqs.h + (long long)(i0 + r8) * p.dqs.s;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = l8 + 8 * cc;
      if (d < D)
        dq[base + (long long)d * p.dqs.d] = from_f<T>(acc[cc] * p.scale);
    }
  }
}

// pass 2: one block per (32-key tile, kv head, batch row): loads K and V,
// loops over the group's q heads and, for each, over the q tiles that see a
// key of the tile or hold a row that sees none; recomputes P and dS from
// the rows' lse and delta and accumulates dV += P^T dO and dK += dS^T Q in
// registers (a thread: one key, every eighth column)
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_simt_kernel(const Params p) {
  extern __shared__ float sm[];
  const int D = p.D, ld = D + 1;
  float* Ks = sm;
  float* Vs = Ks + SB * ld;
  float* Qs = Vs + SB * ld;
  float* dOs = Qs + SB * ld;
  float* Ps = dOs + SB * ld;         // P, [SB][LDP]
  float* Ds = Ps + SB * LDP;         // dS, [SB][LDP]
  float* lse_s = Ds + SB * LDP;
  float* delta_s = lse_s + SB;

  const int t = threadIdx.x;
  const int j0 = blockIdx.x * SB, hk = blockIdx.y, b = blockIdx.z;
  const int nk = min(SB, p.Skv - j0);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);

  load_tile(Ks, ld, k, b * p.ks.b + hk * p.ks.h, p.ks, j0, nk, D);
  load_tile(Vs, ld, v, b * p.vs.b + hk * p.vs.h, p.vs, j0, nk, D);

  const int rs = (t >> 4) * 2, cs = (t & 15) * 2;
  const int c8 = t >> 3, l8 = t & 7;
  const float uniform = 1.f / (float)p.Skv;   // a row that sees no key
  float dk[NC], dv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dk[c] = dv[c] = 0.f;

  const int nq = (p.Sq + SB - 1) / SB;
  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const long long qoff = b * p.qs.b + h * p.qs.h;
    const long long dooff = b * p.dos.b + h * p.dos.h;
    const long long row_stat = ((long long)b * p.Hq + h) * p.Sq;
    for (int qt = 0; qt < nq; ++qt) {
      const int i0 = qt * SB, nrows = min(SB, p.Sq - i0);
      if (!reaches(p, i0, nrows, j0, nk)) continue;
      __syncthreads();
      load_tile(Qs, ld, q, qoff, p.qs, i0, nrows, D);
      load_tile(dOs, ld, dout, dooff, p.dos, i0, nrows, D);
      if (t < SB) {
        lse_s[t] = t < nrows ? p.lse[row_stat + i0 + t] : INFINITY;
        delta_s[t] = t < nrows ? p.delta[row_stat + i0 + t] : 0.f;
      }
      __syncthreads();
      float s[2][2], dp[2][2];
      dots(Qs, Ks, ld, D, rs, cs, s);
      dots(dOs, Vs, ld, D, rs, cs, dp);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = rs + a;
        int lo, hi;
        visible_keys(p, p.q_offset + i0 + r, lo, hi);
        const bool row = r < nrows;
        const bool empty = hi <= lo;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = j0 + cs + c;
          float pr = 0.f, ds = 0.f;
          if (row && j < p.Skv) {
            if (empty) {
              pr = uniform;
            } else if (j >= lo && j < hi) {
              pr = ex2(fmaf(s[a][c], p.scale_log2, -lse_s[r]));
              ds = pr * (dp[a][c] - delta_s[r]);
            }
          }
          Ps[r * LDP + cs + c] = pr;
          Ds[r * LDP + cs + c] = ds;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < SB; ++r) {
        const float pr = Ps[r * LDP + c8], ds = Ds[r * LDP + c8];
        const float* dor = dOs + r * ld;
        const float* qr = Qs + r * ld;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int d = l8 + 8 * cc;
          if (d < D) {
            dv[cc] = fmaf(pr, dor[d], dv[cc]);
            dk[cc] = fmaf(ds, qr[d], dk[cc]);
          }
        }
      }
    }
  }
  if (c8 < nk) {
    T* dkp = static_cast<T*>(p.dk);
    T* dvp = static_cast<T*>(p.dv);
    const long long kb =
        b * p.dks.b + hk * p.dks.h + (long long)(j0 + c8) * p.dks.s;
    const long long vb =
        b * p.dvs.b + hk * p.dvs.h + (long long)(j0 + c8) * p.dvs.s;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = l8 + 8 * cc;
      if (d < D) {
        dkp[kb + (long long)d * p.dks.d] = from_f<T>(dk[cc] * p.scale);
        dvp[vb + (long long)d * p.dvs.d] = from_f<T>(dv[cc]);
      }
    }
  }
}

// ------------------------------------------------------------------ host
// set a kernel's shared-memory size on a device's first launch (bit dev of
// `ready`; every launch past device 63)
template <typename K>
cudaError_t allow_smem(K* kernel, int bytes,
                       std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit);
  }
  return cudaSuccess;
}

template <typename T, int DP>
int launch_tf32(const Params& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready_a{0}, ready_b{0};
  const int sa = SmemA<T, DP>::BYTES, sb = SmemB<T, DP>::BYTES;
  cudaError_t e = allow_smem(flash_bwd_dq_tf32_kernel<T, DP>, sa, ready_a);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_bwd_dkdv_tf32_kernel<T, DP>, sb, ready_b);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_tf32_kernel<T, DP>
      <<<dim3((p.Sq + BM - 1) / BM, p.Hq, p.B), THREADS, sa, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_tf32_kernel<T, DP>
      <<<dim3((p.Skv + BM - 1) / BM, p.Hkv, p.B), THREADS, sb, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int launch_simt(const Params& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready_a{0}, ready_b{0};
  const int sm1 = simt_smem_floats(p.D, 1) * (int)sizeof(float);
  const int sm2 = simt_smem_floats(p.D, 2) * (int)sizeof(float);
  cudaError_t e = allow_smem(flash_bwd_dq_simt_kernel<T, NC>,
                             simt_smem_floats(NC * 8, 1) * 4, ready_a);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_bwd_dkdv_simt_kernel<T, NC>,
                 simt_smem_floats(NC * 8, 2) * 4, ready_b);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_simt_kernel<T, NC>
      <<<dim3((p.Sq + SB - 1) / SB, p.Hq, p.B), THREADS, sm1, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_simt_kernel<T, NC>
      <<<dim3((p.Skv + SB - 1) / SB, p.Hkv, p.B), THREADS, sm2, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int route, cudaStream_t stream) {
  if (route == 1) return launch_simt<T, 32>(p, stream);
  if (p.D <= 32) return launch_tf32<T, 32>(p, stream);
  if (p.D <= 64) return launch_tf32<T, 64>(p, stream);
  return launch_tf32<T, 128>(p, stream);
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

// q, out, dout, dq (B, Hq, Sq, D); k, v, dk, dv (B, Hkv, Skv, D): element
// (b, h, s, d) of each at ptr[b*sb + h*sh + s*ss + d*sd] (strides in
// elements). lse: the forward's statistic, float32, contiguous (B, Hq, Sq);
// delta: float32 scratch of B * Hq * Sq. dtype 0 = float32, 1 = bfloat16
// (all eight the same). window <= 0 means no window; kv_len masks keys at
// or past it. route 0 = the tensor cores (D <= 128), 1 = the CUDA cores
// (D > 128): the caller's pick, refused if it is not this rule's.
int flash_attention_bwd(
    const void* q, long long qsb, long long qsh, long long qss, long long qsd,
    const void* k, long long ksb, long long ksh, long long kss, long long ksd,
    const void* v, long long vsb, long long vsh, long long vss, long long vsd,
    const void* o, long long osb, long long osh, long long oss, long long osd,
    const void* dout, long long dsb, long long dsh, long long dss,
    long long dsd, void* dq, long long qgb, long long qgh, long long qgs,
    long long qgd, void* dk, long long kgb, long long kgh, long long kgs,
    long long kgd, void* dv, long long vgb, long long vgh, long long vgs,
    long long vgd, const float* lse, float* delta, int B, int Hq, int Hkv,
    int Sq, int Skv, int D, int causal, int window, int q_offset, int kv_len,
    int dtype, int route, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || D < 8 || D > 256 || D % 8 != 0 || B > 65535 ||
      Hq > 65535 || (dtype != 0 && dtype != 1) ||
      route != (D > 128 ? 1 : 0) ||
      (long long)((Sq + BM - 1) / BM) * Hq * B > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.qs = Strides{qsb, qsh, qss, qsd};
  p.ks = Strides{ksb, ksh, kss, ksd};
  p.vs = Strides{vsb, vsh, vss, vsd};
  p.os = Strides{osb, osh, oss, osd};
  p.dos = Strides{dsb, dsh, dss, dsd};
  p.dqs = Strides{qgb, qgh, qgs, qgd};
  p.dks = Strides{kgb, kgh, kgs, kgd};
  p.dvs = Strides{vgb, vgh, vgs, vgd};
  p.lse = lse;
  p.delta = delta;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.group = Hq / Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.D = D;
  p.kv_end = kv_len < Skv ? (kv_len > 0 ? kv_len : 0) : Skv;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = 1.f / sqrtf((float)D);
  p.scale_log2 = LOG2E / sqrtf((float)D);
  const int elem = dtype == 0 ? 4 : 2;
  p.q_vec = rows_aligned(q, p.qs, elem, 4 * elem);
  p.k_vec = rows_aligned(k, p.ks, elem, 4 * elem);
  p.v_vec = rows_aligned(v, p.vs, elem, 4 * elem);
  p.do_vec = rows_aligned(dout, p.dos, elem, 4 * elem);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(p, route, s);
  return dispatch<__nv_bfloat16>(p, route, s);
}

}  // extern "C"
