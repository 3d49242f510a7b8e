// Exact int8 x int8 -> int32 matrix product on Hopper's int8 tensor cores
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/spike_matmul/kernel.py
// (spike_matmul_kernel): C[m, n] = sum over k of A[m, k] * B[k, n], with A
// (M, K) int8 (the batch path's {0,1} spike raster, B*T rows of N_in; any
// int8 is taken), B (K, N) int8 weights and C (M, N) int32, accumulated in
// int32 with no float detour, wrapping on overflow as XLA's int32
// dot_general does (no .satfinite). The kernel reads B K-major, as
// Bt = B^T (N, K): int8 wgmma takes both operands K-major, so the caller
// keeps one transposed copy of the weights (made once per program, in the
// program cache's bundle tier) instead of transposing a tile per launch.
// The Pallas wrapper pads M, K and N to 128; here the edges are masked (TMA
// zero-fills past them), so the caller passes the tensors as they are.
//
// What bounds it on the H100. At the serving shape (M = 64*32 = 2048,
// K = 784, N = 256) it must read the 1.6 MB raster and the 200 KB of
// weights and write the 2.1 MB of int32 currents: about 1.2 us at 3.35 TB/s,
// against 0.4 us for its 0.82 G int8 operations at the tensor cores' 1,979
// T/s. So it is bound by bytes, and behind that by one launch and the
// latency of a short K loop (7 tiles of 128).
//
// The design. A block computes a 64 x 64 tile of C (at the serving shape
// 32 x 4 = 128 blocks for the 132 SMs, one wave): one consumer warpgroup
// issues wgmma.m64n64k32.s32.s8.s8 (four per 128-deep k tile, both
// operands from shared memory, the int32 sum in 32 registers a thread), and
// one producer warp fills a ring of STAGES k tiles (A 64 x 128 and Bt
// 64 x 128 bytes each, 128-byte swizzled, the layout the wgmma descriptors
// name), each stage with a "full" and an "empty" mbarrier. Two producers:
//  * TMA (the rule): one thread starts two 2-D tensor copies a stage; the
//    hardware zero-fills rows past M or N and columns past K (K = 784 is
//    not a multiple of 128). It needs rows whose byte stride is a multiple
//    of 16 and 16-byte aligned data (K % 16 == 0), as a tensor map does.
//  * masked loads (every other K or alignment, e.g. K = 129): the producer
//    warp loads the tiles bytewise with predicated loads, zero past the
//    edges, packs 16 bytes a store into the same swizzled layout, and
//    publishes them to the tensor cores' async proxy with a proxy fence
//    before it arrives. (cp.async needs sources aligned to its 4-, 8- or
//    16-byte size, which rows of odd length do not give.)
// The epilogue stages the tile's int32 sums through shared memory (the
// ring, done by then) and writes C row by row, 16 bytes a thread, so each
// warp stores two whole 256-byte row segments: the 2.1 MB output is the
// largest of the kernel's ~3.9 MB.
//
// The C entry point encodes the tensor maps (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so no -lcuda), sets the kernel's
// shared-memory size once per device, launches on the given stream and
// returns cudaGetLastError(), or 10000 + the CUresult if a map cannot be
// encoded. It allocates nothing and does not synchronise.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BM = 64, BN = 64, BK = 128;     // BK: bytes of k per stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 128;                // one warpgroup
constexpr int THREADS = CONSUMERS + 32;       // + the producer warp
constexpr int TILE = BM * BK;                 // 8 KB: A and Bt tiles alike
constexpr int RING = STAGES * 2 * TILE;       // 64 KB
constexpr int BAR = RING;                     // 2 * STAGES mbarriers
constexpr int SMEM = BAR + 16 * STAGES + 1024;   // + 1 KB alignment slack
constexpr int CROW = BN + 4;                  // staged C row, int32 words
static_assert(BM * CROW * 4 <= RING, "the C tile is staged in the ring");

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
// one box of a 2-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// wgmma shared-memory descriptor, 128-byte swizzle, K-major: rows 128 B
// apart, 8-row groups 1024 B apart (SBO), LBO unused; layout type 1 in bits
// 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define D8(i)                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),        \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
// d (m64n64, s32) += A (smem, K-major) * Bt (smem, K-major), 32 deep
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(1));
}
#undef D8

__device__ __forceinline__ void fence_regs(int32_t (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The masked producer: rows r0 .. r0 + 63 and k0 .. k0 + 127 of the
// (rows, K) int8 matrix x into a 128-byte-swizzled tile, zero past the
// edges; a lane stores 16 chunks of 16 bytes
__device__ __forceinline__ void masked_tile(const int8_t* __restrict__ x,
                                            long long rows, int K,
                                            long long r0, int k0,
                                            uint8_t* tile, int lane) {
  for (int q = lane; q < BM * BK / 16; q += 32) {
    const int r = q / 8, c = q % 8;
    const long long row = r0 + r;
    uint32_t word[4] = {0, 0, 0, 0};
    if (row < rows) {
      const int8_t* src = x + row * K + k0 + 16 * c;
      const int n = min(16, K - (k0 + 16 * c));
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (j < n)
          word[j / 4] |= (uint32_t)(uint8_t)__ldg(src + j) << (8 * (j % 4));
    }
    *reinterpret_cast<uint4*>(tile + r * 128 + ((c ^ (r % 8)) * 16)) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

template <bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
spike_matmul_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b,
                    const int8_t* __restrict__ a,
                    const int8_t* __restrict__ bt, int32_t* __restrict__ c,
                    long long M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;       // swizzle atoms: 1 KB
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bar = base + BAR;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };
  auto tile_a = [&](int s) { return 2 * s * TILE; };
  auto tile_b = [&](int s) { return (2 * s + 1) * TILE; };
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), TMA ? 1 : 32);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ------------------------------------------------------------ producer
    const int lane = threadIdx.x - CONSUMERS;
    for (int it = 0; it < nk; ++it) {
      const int s = it % STAGES, parity = ((it / STAGES) & 1) ^ 1;
      const int k0 = it * BK;
      mbar_wait(empty(s), parity);
      if constexpr (TMA) {
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * TILE);
          tma_load(base + tile_a(s), &tm_a, k0, (int)m0, full(s));
          tma_load(base + tile_b(s), &tm_b, k0, n0, full(s));
        }
      } else {
        masked_tile(a, M, K, m0, k0, gbase + tile_a(s), lane);
        masked_tile(bt, N, K, n0, k0, gbase + tile_b(s), lane);
        // generic stores, read next by the tensor cores (async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(full(s));
      }
    }
  } else {
    // ------------------------------------------------------------ consumer
    int32_t d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0;
    for (int it = 0; it < nk; ++it) {
      const int s = it % STAGES;
      mbar_wait(full(s), (it / STAGES) & 1);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8(d, sw128_desc(base + tile_a(s) + 32 * kk),
                 sw128_desc(base + tile_b(s) + 32 * kk));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // the last tile's products are done: its stage may be refilled
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      if (it > 0) mbar_arrive(empty((it - 1) % STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(d);
    // every stage's products are done and no copy is in flight (the
    // producer starts exactly nk): the ring holds the C tile now
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
    int32_t* cs = reinterpret_cast<int32_t*>(gbase);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int row0 = 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<int2*>(cs + (row0 + 8 * r) * CROW + 8 * j +
                                 2 * (lane & 3)) =
            make_int2(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
    const bool vec = N % 4 == 0;         // 16-byte rows of C (c is aligned)
    for (int q = threadIdx.x; q < BM * BN / 4; q += CONSUMERS) {
      const int r = q / (BN / 4), col = 4 * (q % (BN / 4));
      const long long m = m0 + r;
      const int n = n0 + col;
      if (m >= M || n >= N) continue;
      const int32_t* src = cs + r * CROW + col;
      int32_t* dst = c + m * N + n;
      if (vec) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      } else {
        for (int j = 0; j < 4 && n + j < N; ++j) dst[j] = src[j];
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

// a (rows, K) row-major int8 matrix, read in boxes of 128 k x 64 rows
CUresult encode(CUtensorMap* map, const void* ptr, long long rows, int K) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t elem[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                   const_cast<void*>(ptr), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// whether tensor maps describe a and bt: rows a multiple of 16 bytes, data
// 16-byte aligned
bool tma_ok(const void* a, const void* bt, int K) {
  return K % 16 == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)bt % 16 == 0;
}

template <bool TMA>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, const int8_t* a,
           const int8_t* bt, int32_t* c, long long M, int K, int N,
           cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(spike_matmul_kernel<TMA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit);
  }
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  spike_matmul_kernel<TMA><<<grid, THREADS, SMEM, stream>>>(ta, tb, a, bt, c,
                                                            M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a (M, K) int8, bt (N, K) int8 (the weights K-major), c (M, N) int32, all
// row-major and contiguous; M < 2^31. tma: 1 to fill the ring with tensor
// copies (refused unless tma_ok: the wrapper's ops.route makes the same
// test), 0 for the masked loads.
int spike_matmul(const int8_t* a, const int8_t* bt, int32_t* c, long long M,
                 int K, int N, int tma, void* stream) {
  if (M <= 0 || M > 0x7fffffffLL || K <= 0 || N <= 0 ||
      (N + BN - 1) / BN > 65535 || (tma && !tma_ok(a, bt, K)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  CUtensorMap ta = {}, tb = {};
  if (!tma) return launch<false>(ta, tb, a, bt, c, M, K, N, s);
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUresult res = encode(&ta, a, M, K);
  if (res == CUDA_SUCCESS) res = encode(&tb, bt, N, K);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  return launch<true>(ta, tb, a, bt, c, M, K, N, s);
}

}  // extern "C"
