// Exact int8 x int8 -> int32 matrix product for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/spike_matmul/kernel.py
// (spike_matmul_kernel): C[m, n] = sum over k of A[m, k] * B[k, n], with A
// (M, K) int8 (the batch path's {0,1} spike raster, B*T rows of N_in; any
// int8 is taken), B (K, N) int8 weights and C (M, N) int32, accumulated in
// int32 with no float detour. The Pallas wrapper pads M, K and N to 128; this
// kernel masks its own ragged edges instead (K = 784 is not a multiple of the
// tile), so the caller passes the tensors as they are.
//
// What bounds it on the H100. At the serving shape (M = 64*32 = 2048,
// K = 784, N = 256) it must read the 1.6 MB raster and the 200 KB of
// weights and write the 2.1 MB of int32 currents: about 1.2 us at 3.35 TB/s,
// against 0.4 us for its 0.82 G int8 operations at the tensor cores' 1,979
// T/s. So a kernel on the tensor cores would be bound by bytes; this one
// multiplies on the integer ALUs (dp4a, below), whose rate bounds it instead.
//
// What the design does about it. A simple tiled kernel, right first: a block
// computes a 64 x 64 tile of C over K in steps of 32. Each step stages the
// A tile (64 rows x 32 k) and the B tile transposed (64 columns x 32 k) in
// shared memory, zero-filled past the edges, with rows padded to 36 bytes so
// that the word reads below do not collide in a bank. Each of the 256
// threads owns a 4 x 4 block of C (rows ty + 16i, columns tx + 16j) in
// registers and adds __dp4a products of 4 packed k at a time: 8 dp4a per
// output per step. An int8 wgmma design (tensor cores, TMA) is later work.
//
// The C entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int ROW = BK + 4;          // bytes per staged row (9 words)
constexpr int THREADS = 256;         // 16 x 16, each a 4 x 4 block of C

__global__ void __launch_bounds__(THREADS)
spike_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                    int32_t* __restrict__ c, int M, int K, int N) {
  __shared__ __align__(16) int8_t sa[BM * ROW];   // sa[m][k]
  __shared__ __align__(16) int8_t sb[BN * ROW];   // sb[n][k]: B transposed
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  int32_t acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: thread reads 8 consecutive k of one row
    {
      const int r = tid / 4, kk = (tid % 4) * 8;
      const long long m = m0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + kk + j;
        sa[r * ROW + kk + j] =
            (m < M && k < K) ? __ldg(a + m * K + k) : (int8_t)0;
      }
    }
    // B tile: thread reads 8 consecutive n of one k row, stores transposed
    {
      const int kr = tid / 8, nn = (tid % 8) * 8;
      const int k = k0 + kr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + nn + j;
        sb[(nn + j) * ROW + kr] =
            (k < K && n < N) ? __ldg(b + (long long)k * N + n) : (int8_t)0;
      }
    }
    __syncthreads();
    const int32_t* wa = reinterpret_cast<const int32_t*>(sa);
    const int32_t* wb = reinterpret_cast<const int32_t*>(sb);
#pragma unroll
    for (int kw = 0; kw < BK / 4; ++kw) {
      int32_t av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = wa[(ty + 16 * i) * (ROW / 4) + kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = wb[(tx + 16 * j) * (ROW / 4) + kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) c[m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// a (M, K) int8, b (K, N) int8, c (M, N) int32, all row-major; M < 2^31.
int spike_matmul(const int8_t* a, const int8_t* b, int32_t* c, long long M,
                 int K, int N, void* stream) {
  if (M <= 0 || M > 0x7fffffffLL || K <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  const long long mb = (M + BM - 1) / BM;
  const int nb = (N + BN - 1) / BN;
  if (nb > 65535) return (int)cudaErrorInvalidValue;
  spike_matmul_kernel<<<dim3((unsigned)mb, (unsigned)nb), THREADS, 0,
                        (cudaStream_t)stream>>>(a, b, c, (int)M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
