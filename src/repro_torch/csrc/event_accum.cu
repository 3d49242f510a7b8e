// Event accumulation for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/event_accum/kernel.py
// (event_accum_kernel): for each step row r = (b, t) of the packed event
// frames and each lane n,
//   out[r, n] = sum over every slot e of ids[r, e] in [0, n_in) of w[ids[r, e], n]
// in int32. It reads no count: every slot is tested, so PAD (-1) is masked
// wherever it sits in the row, as the Pallas kernel masks it; an id at or
// past n_in is skipped too, so no id reads outside w. The served batch is
// one launch over all B*T step rows (the JAX accelerator vmaps one example
// at a time over B).
//
// What bounds it on the H100. Per served batch (B = 64, T = 32, E_max = 128,
// N_pad = 256) it must read the 1 MB of ids and the weight rows its events
// touch (at most the 200 KB of w) and write the 2.1 MB of int32 currents: a
// bytes bound of about a microsecond at 3.35 TB/s. The additions (events x
// N_pad) are far below the ALU rate. The write of the currents is the one
// cost the fused kernel (fused_event_lif.cu) does not pay.
//
// What the design does about it. One block per step row, one thread per lane
// (a thread takes lanes tid, tid + blockDim, ... when n_pad > 512). The block
// first compacts the row's live ids into shared memory (a shared counter;
// the order of integer additions does not change the sum), so the loop over
// them has no branch and no load for a PAD slot; each thread then loads its
// own byte of each live row, so a warp reads 32 consecutive bytes of one row
// from L2, eight rows in flight (unroll 8). The currents are written once,
// coalesced along the lanes.
//
// The C entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;
// ids of one step row staged in dynamic shared memory, within the 48 KB a
// block gets without opting in
constexpr int MAX_E = 12000;

__global__ void __launch_bounds__(MAX_THREADS)
event_accum_kernel(const int32_t* __restrict__ ids,
                   const int8_t* __restrict__ w, int32_t* __restrict__ out,
                   int E, int n_in, int n_pad) {
  extern __shared__ int32_t s_ids[];
  __shared__ int s_live;
  const size_t row = blockIdx.x;
  if (threadIdx.x == 0) s_live = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int id = __ldg(ids + row * E + e);
    if ((unsigned)id < (unsigned)n_in) s_ids[atomicAdd(&s_live, 1)] = id;
  }
  __syncthreads();
  const int live = s_live;
  for (int lane = threadIdx.x; lane < n_pad; lane += blockDim.x) {
    // at most MAX_E * 127 in magnitude: no int32 overflow
    int32_t acc = 0;
#pragma unroll 8
    for (int e = 0; e < live; ++e)
      acc += (int32_t)__ldg(w + (size_t)s_ids[e] * n_pad + lane);
    out[row * n_pad + lane] = acc;
  }
}

}  // namespace

extern "C" {

// ids (rows, E) int32 row-major, rows = B*T; w (n_in, n_pad) int8;
// out (rows, n_pad) int32.
int event_accum(const int32_t* ids, const int8_t* w, int32_t* out, int rows,
                int E, int n_in, int n_pad, void* stream) {
  if (rows <= 0 || E <= 0 || E > MAX_E || n_in <= 0 || n_pad <= 0)
    return (int)cudaErrorInvalidValue;
  const int threads = n_pad < MAX_THREADS ? ((n_pad + 31) / 32) * 32
                                          : MAX_THREADS;
  event_accum_kernel<<<rows, threads, (size_t)E * sizeof(int32_t),
                       (cudaStream_t)stream>>>(ids, w, out, E, n_in, n_pad);
  return (int)cudaGetLastError();
}

}  // extern "C"
