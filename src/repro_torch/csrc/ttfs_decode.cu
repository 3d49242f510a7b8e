// Grouped-TTFS decode for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ttfs_decode/kernel.py
// (ttfs_decode_kernel): for each row b of first-spike times and membranes
// over n = n_groups * per_group logical lanes, the label of the group with
// the earliest spike (ties to the lowest lane, hence the lowest group); if
// no lane's time is below the sentinel, the group of the first lane holding
// the largest membrane ("membrane") or 0 ("zero"). The comparator is the one
// the fused decode kernel runs (lif_step.cuh), with an int64 key.
//
// The rows are read through a row stride, so the accelerator's first[:, :n_out]
// and v[:, :n_out], slices of the (B, N_pad) LIF outputs, are read in place.
//
// What bounds it on the H100. Per served batch (B = 64, n = 150) it reads
// 77 KB (38 KB with the "zero" fallback, which needs no membrane) and writes
// 256 B: some 0.02 us at 3.35 TB/s, far below the few microseconds a launch
// takes. Launch latency bounds it.
//
// What the design does about it. One block per row, one thread per lane,
// and two block-wide int64 reductions (the packed key's min, the membrane
// key's max): a single short pass, so the launch itself is the cost.
//
// The C entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include "lif_step.cuh"

namespace {

constexpr int MAX_THREADS = 512;

__global__ void __launch_bounds__(MAX_THREADS)
ttfs_decode_kernel(const int32_t* __restrict__ first,
                   const int32_t* __restrict__ v, long long first_stride,
                   long long v_stride, int32_t* __restrict__ labels, int n,
                   int per_group, int sentinel, int fallback_membrane) {
  const int b = blockIdx.x;
  DecodeKeys keys;
  for (int lane = threadIdx.x; lane < n; lane += blockDim.x) {
    const int32_t f = __ldg(first + b * first_stride + lane);
    const int32_t m = fallback_membrane ? __ldg(v + b * v_stride + lane) : 0;
    decode_fold(keys, f, m, lane, n);
  }
  const int label = decode_label(keys, n, per_group, sentinel,
                                 fallback_membrane);
  if (threadIdx.x == 0) labels[b] = label;
}

}  // namespace

extern "C" {

// first, v: row b at first + b*first_stride, v + b*v_stride, n contiguous
// int32 each; labels (B,) int32.
int ttfs_decode(const int32_t* first, const int32_t* v, long long first_stride,
                long long v_stride, int32_t* labels, int B, int n_groups,
                int per_group, int sentinel, int fallback_membrane,
                void* stream) {
  if (B <= 0 || n_groups <= 0 || per_group <= 0 ||
      (long long)n_groups * per_group > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  const int n = n_groups * per_group;
  const int threads = n < MAX_THREADS ? ((n + 31) / 32) * 32 : MAX_THREADS;
  ttfs_decode_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      first, v, first_stride, v_stride, labels, n, per_group, sentinel,
      fallback_membrane);
  return (int)cudaGetLastError();
}

}  // extern "C"
