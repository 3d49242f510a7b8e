// Grouped-TTFS decode for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ttfs_decode/kernel.py
// (ttfs_decode_kernel): for each row b of first-spike times and membranes
// over n = n_groups * per_group logical lanes, the label of the group with
// the earliest spike (ties to the lowest lane, hence the lowest group); if
// no lane's time is below the sentinel, the group of the first lane holding
// the largest membrane ("membrane") or 0 ("zero"). The comparator is
// lif_step.cuh's 32-bit pair form (DecodePair), which the fused kernels'
// int64 keys are held to in chip_smoke.py.
//
// The rows are read through a row stride, so the accelerator's first[:, :n_out]
// and v[:, :n_out], slices of the (B, N_pad) LIF outputs, are read in place.
//
// What bounds it on the H100. Per served batch (B = 64, n = 150) it reads
// 77 KB (38 KB with the "zero" fallback, which needs no membrane) and writes
// 256 B: some 0.02 us at 3.35 TB/s, far below the few microseconds a launch
// takes. The launch and the serial chain after it bound it: a row's loads,
// its reduction and the label's arithmetic.
//
// What the design does about that: it keeps the chain short.
//  - A warp a row, ROWS rows a block (the "warp" route, which the wrapper
//    takes up to its WARP_MAX_N lanes, every serving shape): each lane
//    loads its lanes j = lane, lane + 32, ... of the row at once and folds
//    them in order, the warp reduces the (value, lane) pairs with two
//    redux.sync (four under "membrane"), and lane 0 stores the label: no
//    shared memory, no block barrier, no 64-bit arithmetic, one 32-bit
//    division.
//  - A block a row (the "block" route, the wide layers): each warp reduces
//    its pairs the same way, the warps' pairs meet once in shared memory,
//    and warp 0 reduces them.
//
// The C entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include "lif_step.cuh"

namespace {

constexpr int ROWS = 2;              // rows (warps) a block of the warp route
constexpr int BLOCK_THREADS = 512;   // a block of the block route

__global__ void __launch_bounds__(32 * ROWS)
ttfs_decode_warp_rows(const int32_t* __restrict__ first,
                      const int32_t* __restrict__ v, long long first_stride,
                      long long v_stride, int32_t* __restrict__ labels, int B,
                      int n, int per_group, int sentinel, int membrane) {
  const int b = blockIdx.x * ROWS + threadIdx.x / 32;
  if (b >= B) return;                       // the whole warp: b is its row
  const int lane = threadIdx.x % 32;
  const DecodePair p = warp_decode_reduce(
      decode_scan(first + b * first_stride, v + b * v_stride, n, lane, 32,
                  membrane),
      membrane);
  if (lane == 0)
    labels[b] = decode_pick_pair(p, per_group, sentinel, membrane);
}

__global__ void __launch_bounds__(BLOCK_THREADS)
ttfs_decode_block_rows(const int32_t* __restrict__ first,
                       const int32_t* __restrict__ v, long long first_stride,
                       long long v_stride, int32_t* __restrict__ labels, int n,
                       int per_group, int sentinel, int membrane) {
  constexpr int WARPS = BLOCK_THREADS / 32;
  __shared__ int32_t part[4][WARPS];     // each warp's pair of pairs
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  DecodePair p = warp_decode_reduce(
      decode_scan(first + b * first_stride, v + b * v_stride, n, threadIdx.x,
                  BLOCK_THREADS, membrane),
      membrane);
  if (lane == 0) {
    part[0][warp] = p.first;
    part[1][warp] = p.first_lane;
    part[2][warp] = p.v;
    part[3][warp] = p.v_lane;
  }
  __syncthreads();
  if (warp != 0) return;
  DecodePair q;                          // lanes past WARPS hold no lane
  if (lane < WARPS) {
    q.first = part[0][lane];
    q.first_lane = part[1][lane];
    q.v = part[2][lane];
    q.v_lane = part[3][lane];
  }
  p = warp_decode_reduce(q, membrane);
  if (lane == 0)
    labels[b] = decode_pick_pair(p, per_group, sentinel, membrane);
}

}  // namespace

extern "C" {

// first, v: row b at first + b*first_stride, v + b*v_stride, n contiguous
// int32 each; labels (B,) int32. block: 1 for a block a row, 0 for a warp
// a row (the wrapper's route; both decode any n).
int ttfs_decode(const int32_t* first, const int32_t* v, long long first_stride,
                long long v_stride, int32_t* labels, int B, int n_groups,
                int per_group, int sentinel, int fallback_membrane, int block,
                void* stream) {
  if (B <= 0 || n_groups <= 0 || per_group <= 0 ||
      (long long)n_groups * per_group > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  const int n = n_groups * per_group;
  const int membrane = fallback_membrane != 0;
  if (!block) {
    const unsigned blocks = (unsigned)(((long long)B + ROWS - 1) / ROWS);
    ttfs_decode_warp_rows<<<blocks, 32 * ROWS, 0, (cudaStream_t)stream>>>(
        first, v, first_stride, v_stride, labels, B, n, per_group, sentinel,
        membrane);
  } else {
    ttfs_decode_block_rows<<<B, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
        first, v, first_stride, v_stride, labels, n, per_group, sentinel,
        membrane);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
