// LIF scan over precomputed currents for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lif/kernel.py
// (lif_fused_kernel): for each batch row b and lane n, over t = 0 .. T-1,
//   v = v - (v >> leak_shift) + currents[t, b, n];  first latches t at v >= thr
// (the update and latch of lif_step.cuh), and it writes first and v at T.
// The currents are read through strides, so the accelerator's (B, T, N_pad)
// tensor viewed as (T, B, N_pad) by movedim is read in place: no copy.
//
// What bounds it on the H100. Per served batch (B = 64, T = 32, N_pad = 256)
// it must read the 2.1 MB of int32 currents and write 131 KB of state: a
// bytes bound of about 0.7 us at 3.35 TB/s. Five integer operations per
// lane-step are far below the ALU rate. Only B * N_pad = 16,384 lanes exist,
// so the kernel is bound by the latency of its dependent memory round trips,
// not by bandwidth: the first kernel, a thread a lane that loaded eight steps
// ahead, made four of them before its store.
//
// What the design does about it: a row's window is requested at once. A
// thread a lane, v and first in registers; a warp's 32 lanes are 32
// consecutive ints of one row when the lane stride is 1, so every load is a
// coalesced 128 B line. Every load of a chunk of 32 steps is issued before
// the recurrence runs over them: one round trip for the served window. The
// loads are not predicated (with predicated loads nvcc interleaved them with
// the recurrence, which cost as much as the round trips saved). The last
// T % 32 steps go one at a time.
//
// Designs measured beside it and not kept (each held bit-exact to the plain
// version and timed in one run; PERF.md has the times): bringing each row's
// window into shared memory with the bulk-copy engine (cp.async.bulk, an
// mbarrier a chunk, the recurrence over chunk k running while the later
// chunks land), either a copy a step of a 128-lane slice or a copy a 16 KB
// chunk of a whole row's contiguous slab. The first was the slowest of all;
// the second was 2-6 % slower than this kernel at T = 32 and no faster at
// T = 16: a bulk copy's issue, transfer and completion cost more than the
// register round trip they replace. A tail loaded in batches of 16, 8, 4, 2
// and 1 steps was no faster at T = 16 and slower at T = 32, 33 and 100.
//
// The C entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include "lif_step.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 32;          // steps whose loads are issued at once

// K steps from t0: all K loads, then the recurrence over them
template <int K>
__device__ __forceinline__ void scan_steps(const int32_t* __restrict__ p,
                                           long long s_t, int t0, int T,
                                           int32_t thr, int leak_shift,
                                           int32_t& v, int32_t& first) {
  int32_t c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = __ldg(p + (t0 + k) * s_t);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v = lif_update(v, c[k], leak_shift);
    lif_latch(v, thr, first, t0 + k, T);
  }
}

__global__ void __launch_bounds__(THREADS)
lif_kernel(const int32_t* __restrict__ cur, long long s_t, long long s_b,
           long long s_n, const int32_t* __restrict__ thr,
           int32_t* __restrict__ first_out, int32_t* __restrict__ v_out,
           int B, int T, int n, int leak_shift) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * n) return;
  const int b = (int)(idx / n), lane = (int)(idx % n);
  const int32_t* p = cur + b * s_b + lane * s_n;
  const int32_t th = __ldg(thr + lane);
  int32_t v = 0, first = T;
  int t = 0;
  for (; t + CHUNK <= T; t += CHUNK)
    scan_steps<CHUNK>(p, s_t, t, T, th, leak_shift, v, first);
  for (; t < T; ++t) scan_steps<1>(p, s_t, t, T, th, leak_shift, v, first);
  first_out[idx] = first;
  v_out[idx] = v;
}

}  // namespace

extern "C" {

// cur: element (t, b, n) at cur[t*s_t + b*s_b + n*s_n] (strides in elements);
// thr (n,) int32; first_out, v_out (B, n) int32 row-major.
int lif_fused(const int32_t* cur, long long s_t, long long s_b, long long s_n,
              const int32_t* thr, int32_t* first_out, int32_t* v_out, int B,
              int T, int n, int leak_shift, void* stream) {
  if (B <= 0 || T <= 0 || n <= 0 || leak_shift < 0 || leak_shift > 31)
    return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)B * n;
  const long long blocks = (lanes + THREADS - 1) / THREADS;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  lif_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      cur, s_t, s_b, s_n, thr, first_out, v_out, B, T, n, leak_shift);
  return (int)cudaGetLastError();
}

}  // extern "C"
