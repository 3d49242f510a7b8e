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
// The design: the fused kernels' gather (event_gather.cuh) with every slot
// tested. A warp gathers one step row (a group of 2, 4 or 8 warps a row
// wider than a warp's 128, 256 or 512 columns; blockIdx.y takes the next
// 4,096 columns of a wider row): the ids of 128 slots at once, broadcast
// by shuffle, a round of 32 slots with no live id skipped (so a packed
// row costs its events, not E_max), 4-, 8- or 16-byte predicated row
// loads, offset-binary packed sums; the int32 sums of a row stay in
// registers across flushes and are written once, 16 bytes a lane, so a
// warp stores its row's columns contiguously. Nothing is staged per row in
// shared memory, so E_max has no limit. A block of 256 threads takes 8, 4,
// 2 or 1 step rows at a time; the grid strides over the rows.
//
// Measured beside it (PERF.md): the busiest rows' slots shared by 2 or 4
// warps, their sums added in shared memory, was slower.
//
// The C entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "event_gather.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 1 << 20;        // step-row blocks, then a stride

// warps that gather one step row's columns in a block: 1, 2, 4 or 8
int row_group(int n_pad) {
  const int cpl = event_gather::cols_per_lane(n_pad);
  const int need = (n_pad + 32 * cpl - 1) / (32 * cpl);
  int g = 1;
  while (g < need && g < WARPS) g *= 2;
  return g;
}

// 2 blocks an SM at least: a thread keeps up to 128 registers, so the rows
// in flight do not spill
template <int CPL, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
event_accum_kernel(event_gather::Rows a, int32_t* __restrict__ out,
                   int rows, int group) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per_block = WARPS / group;     // step rows a block takes at once
  const int g = warp / group;
  const int col0 = ((blockIdx.y * group + warp % group) * 32 + lane) * CPL;
  const int cols = a.n_pad - col0;
  int32_t acc[CPL];
  event_gather::gather_rows<CPL, VEC, false>(
      a, col0, a.n_pad, blockIdx.x * per_block + g, gridDim.x * per_block,
      rows, [&](int s, const int32_t (&sums)[CPL], bool first, bool last) {
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          acc[j] = first ? sums[j] : acc[j] + sums[j];
        if (last)
          event_gather::store_sums<CPL, VEC>(
              out + (size_t)s * a.n_pad + col0, acc, true, cols);
      });
}

template <int CPL>
int launch(const event_gather::Rows& a, int32_t* out, int rows, bool vec,
           cudaStream_t s) {
  const int group = row_group(a.n_pad);
  const int per_block = WARPS / group;
  const long long need = (rows + per_block - 1) / per_block;
  const dim3 grid((unsigned)(need < MAX_BLOCKS ? need : MAX_BLOCKS),
                  (unsigned)((a.n_pad + group * 32 * CPL - 1) /
                             (group * 32 * CPL)));
  if (vec)
    event_accum_kernel<CPL, true><<<grid, THREADS, 0, s>>>(a, out, rows,
                                                          group);
  else
    event_accum_kernel<CPL, false><<<grid, THREADS, 0, s>>>(a, out, rows,
                                                           group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ids (rows, E) int32 row-major, rows = B*T; w (n_in, n_pad) int8;
// out (rows, n_pad) int32 (16-byte aligned).
int event_accum(const int32_t* ids, const int8_t* w, int32_t* out, int rows,
                int E, int n_in, int n_pad, void* stream) {
  if (rows <= 0 || E <= 0 || n_in <= 0 || n_pad <= 0 ||
      (n_pad + 4095) / 4096 > 65535)
    return (int)cudaErrorInvalidValue;
  const event_gather::Rows a{ids, nullptr, w, E, n_in, n_pad};
  const int cpl = event_gather::cols_per_lane(n_pad);
  // a lane's columns as one vector: n_pad a multiple of them, w and out
  // 16-byte aligned
  const bool vec = n_pad % cpl == 0 && (uintptr_t)w % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (cpl == 4) return launch<4>(a, out, rows, vec, s);
  if (cpl == 8) return launch<8>(a, out, rows, vec, s);
  return launch<16>(a, out, rows, vec, s);
}

// The bytes of a weight row a gathering lane loads at once: its columns as
// one vector, or 1 where it loads them byte by byte
int event_accum_row_load_bytes(const int8_t* w, const int32_t* out,
                               int n_pad) {
  if (n_pad <= 0) return 0;
  const int cpl = event_gather::cols_per_lane(n_pad);
  return n_pad % cpl == 0 && (uintptr_t)w % 16 == 0 &&
                 (uintptr_t)out % 16 == 0
             ? cpl
             : 1;
}

}  // extern "C"
