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
// lane-step are far below the ALU rate.
//
// What the design does about it. One thread per (b, n) lane, v and first in
// registers for the whole T loop; a warp's 32 lanes are 32 consecutive ints
// of one row (when the lane stride is 1), so every load is a coalesced 128 B
// line. The loads do not depend on v, so the loop loads eight steps ahead
// before it updates, to keep more of the 2 MB in flight. Only B*N_pad
// threads exist (16,384 at the serving shape, about one block of 128 per
// SM), so the kernel is bound by the latency of its loads rather than by
// bandwidth; more rows per launch would fill the card.
//
// The C entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include "lif_step.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int AHEAD = 8;   // steps loaded before they are applied

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
  for (; t + AHEAD <= T; t += AHEAD) {
    int32_t c[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) c[k] = __ldg(p + (t + k) * s_t);
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      v = lif_update(v, c[k], leak_shift);
      lif_latch(v, th, first, t + k, T);
    }
  }
  for (; t < T; ++t) {
    v = lif_update(v, __ldg(p + t * s_t), leak_shift);
    lif_latch(v, th, first, t, T);
  }
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
