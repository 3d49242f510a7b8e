// Fused event -> LIF -> decode kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_event_lif/kernel.py:
//   fused_event_lif_decode      <- fused_event_lif_decode_kernel     (full T, label)
//   fused_event_lif_early_exit  <- fused_event_lif_early_exit_kernel (latency mode)
//   fused_event_lif             <- fused_event_lif_kernel            (full T, no label)
// and computes exactly what they compute. For each batch row b and step t:
//   i[n]  = sum over e < count[b,t] with ids[b,t,e] in [0, n_in) of w[ids[b,t,e], n]
//   v     = v - (v >> leak_shift) + i        (arithmetic shift on signed int)
//   first = t where (v >= thr && first == T) (first-spike latch; T = never)
// The decode kernel then applies the grouped-TTFS comparator of lif_step.cuh
// to the logical lanes [0, n_out); fused_event_lif is the same kernel compiled
// without that epilogue (a template flag). The early-exit kernel stops a row
// after the first step at which ANY of its n_pad lanes has fired and reports v
// at exit and the steps executed.
//
// What bounds it on the H100. A row must read the weight rows of its events
// (events x n_pad int8 bytes, ~520 x 256 B for an MNIST digit), its ids and
// counts, and write 2 x n_pad x 4 bytes of state: a few hundred KB for a
// batch of 64, far below what the memory system moves in a microsecond, and
// few operations. Gathering each step after the last would pay three
// dependent loads (count, ids, rows) and two barriers per step, T steps in
// series. Here only the membrane recurrence is serial, and what bounds a
// block (one batch row on one SM) is the gather: about 20 instructions an
// event per warp, most of them on the integer pipe, so the SM's issue rate
// and the warp of the heaviest step (the dim pixels of an MNIST digit share
// a few late steps), behind a fixed cost of launch, count and id latency.
//
// The design. The currents i[t] do not depend on the membrane, so a row's T
// steps are cut into chunks of C steps (the host's launch plan picks C from
// T and the block's lanes within the 227 KB of shared memory a block may
// hold; C = T at the MNIST shape, 32 KB) and each chunk runs in two phases:
//  1. gather: every step of the chunk at once, one warp per step (a group of
//     warps when the row is wider than 32 lanes x 16 bytes), a loop for more
//     steps than warps: event_gather.cuh, counting the first count[b,t]
//     slots of each step (ids 32 at a time broadcast by shuffle, 4-, 8- or
//     16-byte predicated row loads, offset-binary packed sums flushed every
//     256 events). Each step's int32 currents go to shared memory, C x n_pad.
//     One barrier closes the phase.
//  2. scan: each thread owns LPT lanes tid, tid + blockDim, ... (only the
//     threads that own a lane), with thr, v and first in registers across
//     chunks, and runs the update and latch of lif_step.cuh over the chunk's
//     steps from shared memory. The early-exit kernel scans a chunk through
//     with no barrier; each thread offers the first step at which one of its
//     lanes fired (a shared atomicMin, one barrier), and if the row's earliest
//     lies in the chunk every thread scans the chunk again from the state it
//     started with, up to that step: exactly the state the step-by-step test
//     (any of the n_pad lanes fired) leaves, and currents gathered past the
//     exit are never added.
// One block of 512 threads serves one batch row; rows run in parallel.
//
// Rows wider than one block (n_pad > 4096 lanes: 512 threads x 8 lanes)
// run on a thread-block cluster of 2, 4 or 8 blocks (the plan's `cluster`),
// launched with cudaLaunchKernelEx. Block rank r owns the contiguous slice
// of lanes [r * S, r * S + S) (S a multiple of 16, at most 4096; the last
// slice shorter) and gathers and scans that slice of every step exactly as
// one block does a row; the ids and counts are read again by each block
// (they are small). Only two things cross blocks, over distributed shared
// memory: the early-exit test, where each block's offers go to an
// atomicMin on rank 0's slot of the chunk and a cluster barrier closes the
// test before every block reads the row's exit step (three slots in turn,
// so that rank 0 can reset one between the barriers around it); and the
// decode, whose packed keys are associative: each block reduces its lanes
// of [0, n_out) and rank 0 combines the ranks' keys (ties still go to the
// first lane, the keys carry the global lane). A plan with cluster = 1 is
// the single-block kernel, compiled without a cluster.
//
// The weight matrix is not staged in shared memory: TTFS gives each input at
// most one spike per image, so a row reads each weight row at most once and
// a one-row block would gain no reuse from a copy. It is served from the 50
// MB L2 across the batch's blocks.
//
// Measured beside this design (PERF.md): the early-exit kernel at C = T and
// at C = 8 (C = T is faster, chip_smoke.py phase 7); and, in probe builds
// that are not kept, 1024 threads (spills at 64 registers), 16 rows in
// flight, sign-extended int32 sums and dp4a sums, a barrier after every
// step of the exit test, a step's events balanced over the warps (by shared
// atomics, or by a private slot for each 32 events) and a row split over a
// 2-block cluster that gathers half the steps on each SM: none was
// measurably faster.
//
// Integer semantics: the update and latch of lif_step.cuh (wrapping like XLA,
// arithmetic shift). Ids outside [0, n_in) are skipped (PAD is -1) and read
// nothing, so a bad id cannot read outside w.
//
// Each C entry point takes the launch plan (threads, lanes per thread, chunk
// steps, shared bytes, cluster) chosen on the host, returns cudaErrorInvalidValue
// before any launch if the kernel cannot run it, sets the kernel's
// shared-memory limit once per device, launches on the given stream and
// returns cudaGetLastError(); it allocates nothing and does not synchronise.
// Two queries launch nothing: fused_event_lif_plan_ok (the entry points'
// test of a plan, which chip_smoke.py holds to ops.py's check_plan) and
// fused_event_lif_row_load_bytes (which row loads a launch takes).

#include <cooperative_groups.h>

#include <atomic>

#include "event_gather.cuh"
#include "lif_step.cuh"

namespace {

namespace cg = cooperative_groups;
using event_gather::cols_per_lane;

// 512 threads leave a thread 128 registers (__launch_bounds__): 32 of them
// hold the rows in flight
constexpr int MAX_THREADS = 512;
constexpr int MAX_LPT = 8;                 // lanes per thread
constexpr int MAX_SLICE = MAX_THREADS * MAX_LPT;   // lanes a block: 4096
constexpr int MAX_CLUSTER = 8;             // blocks a row (portable cluster)
// the most dynamic shared memory a plan may ask for: the H100's 227 KB
// opt-in limit a block (232,448 B) less 1 KB for the static shared memory of
// the decode reduction and the exit test
constexpr int MAX_CUR_BYTES = 232448 - 1024;

struct RowArgs {
  const int32_t* ids;      // (B, T, E) row-major
  const int32_t* count;    // (B, T)
  const int8_t* w;         // (n_in, n_pad)
  const int32_t* thr;      // (n_pad,)
  int T, E, n_in, n_pad, leak_shift;
  int chunk;               // steps gathered before they are scanned
  int group;               // warps that gather one step of a block's slice
  int slice;               // lanes a block owns (n_pad without a cluster)
  bool vec;                // rows are loaded as CPL-byte vectors
};

// Lanes [0, n_pad) of a row split over `cluster` blocks: slices of this many
// lanes, a multiple of 16 (a whole number of a gathering lane's columns), the
// last one shorter
__host__ __device__ constexpr int slice_lanes(int n_pad, int cluster) {
  return cluster == 1 ? n_pad
                      : ((n_pad + cluster - 1) / cluster + 15) / 16 * 16;
}

// The block's batch row and its slice of the row's lanes: [lane0, lane0 +
// width), and the cluster rank that owns it (0 without a cluster)
struct Slice {
  int b, rank, lane0, width;
};

template <bool CLUSTER>
__device__ __forceinline__ Slice block_slice(const RowArgs& a) {
  if constexpr (CLUSTER) {
    const int rank = (int)cg::this_cluster().block_rank();
    const int n = (int)cg::this_cluster().num_blocks();
    const int lane0 = rank * a.slice;
    return Slice{(int)blockIdx.x / n, rank, lane0,
                 min(a.slice, a.n_pad - lane0)};
  } else {
    return Slice{(int)blockIdx.x, 0, 0, a.n_pad};
  }
}

// The two halves of a cluster barrier (cg's sync() is both): arrive early,
// wait just before the first access to another block's shared memory
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Phase 1: the currents of steps t0 .. t0 + n_steps - 1 of row b, for the
// block's slice of lanes, into s_cur[c * slice + lane]: a step to a warp
// group, the steps in turn (event_gather.cuh, count-bounded).
template <int CPL, bool VEC>
__device__ __forceinline__ void gather_chunk(const RowArgs& a, const Slice& sl,
                                             int t0, int n_steps,
                                             int32_t* s_cur) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_groups = (int)(blockDim.x / 32) / a.group;
  const int g = warp / a.group;
  if (g >= n_groups) return;
  const int col = ((warp - g * a.group) * 32 + lane) * CPL;   // in the slice
  const size_t bt = (size_t)sl.b * a.T + t0;
  const event_gather::Rows rows{a.ids + bt * a.E, a.count + bt, a.w, a.E,
                                a.n_in, a.n_pad};
  event_gather::gather_rows<CPL, VEC, true>(
      rows, sl.lane0 + col, sl.lane0 + sl.width, g, n_groups, n_steps,
      [&](int c, const int32_t (&sums)[CPL], bool first, bool) {
        event_gather::store_sums<CPL, VEC>(s_cur + (size_t)c * a.slice + col,
                                           sums, first, sl.width - col);
      });
}

template <int CPL>
__device__ __forceinline__ void gather(const RowArgs& a, const Slice& sl,
                                       int t0, int n_steps, int32_t* s_cur) {
  if (a.vec)
    gather_chunk<CPL, true>(a, sl, t0, n_steps, s_cur);
  else
    gather_chunk<CPL, false>(a, sl, t0, n_steps, s_cur);
}

// Phase 2: the LIF update and latch of steps t0 .. t0 + n - 1 on this
// thread's lanes of the slice, from the chunk's currents. Each lane's column
// pointer is formed once and stepped by the slice.
template <int LPT>
__device__ __forceinline__ void scan(const RowArgs& a, const Slice& sl,
                                     const int32_t* s_cur, int t0, int n,
                                     const int32_t (&thr)[LPT],
                                     int32_t (&v)[LPT], int32_t (&first)[LPT]) {
  const int32_t* col[LPT];
  bool live[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int lane = threadIdx.x + k * blockDim.x;
    live[k] = lane < sl.width;
    col[k] = s_cur + (live[k] ? lane : 0);
  }
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int32_t i = live[k] ? *col[k] : 0;
      col[k] += a.slice;
      v[k] = lif_update(v[k], i, a.leak_shift);
      lif_latch(v[k], thr[k], first[k], t0 + c, a.T);
    }
  }
}

template <int LPT>
__device__ __forceinline__ void load_state(const RowArgs& a, const Slice& sl,
                                           int32_t (&thr)[LPT],
                                           int32_t (&v)[LPT],
                                           int32_t (&first)[LPT]) {
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int lane = threadIdx.x + k * blockDim.x;
    // lanes past the slice never fire and are never stored
    thr[k] = lane < sl.width ? __ldg(a.thr + sl.lane0 + lane) : INT32_MAX;
    v[k] = 0;
    first[k] = a.T;
  }
}

template <int LPT>
__device__ __forceinline__ void store_state(const RowArgs& a, const Slice& sl,
                                            const int32_t (&v)[LPT],
                                            const int32_t (&first)[LPT],
                                            int32_t* first_out,
                                            int32_t* v_out) {
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int lane = threadIdx.x + k * blockDim.x;
    if (lane < sl.width) {
      const size_t at = (size_t)sl.b * a.n_pad + sl.lane0 + lane;
      first_out[at] = first[k];
      v_out[at] = v[k];
    }
  }
}

// Full T; with DECODE the grouped-TTFS label of the row is written too. With
// CLUSTER a row's lanes are split over the blocks of a thread-block cluster:
// each gathers and scans its own slice, and the decode keys of the blocks
// are combined by rank 0 over distributed shared memory.
template <int CPL, int LPT, bool DECODE, bool CLUSTER>
__global__ void __launch_bounds__(MAX_THREADS, 1)
fused_full_kernel(RowArgs a, int n_out, int per_group, int fallback_membrane,
                  int32_t* first_out, int32_t* v_out, int32_t* labels) {
  extern __shared__ __align__(16) int32_t s_cur[];   // chunk x slice currents
  const Slice sl = block_slice<CLUSTER>(a);
  // the decode's first access to rank 0's shared memory waits until every
  // block of the cluster has started
  if constexpr (CLUSTER && DECODE) cluster_arrive();
  int32_t thr[LPT], v[LPT], first[LPT];
  load_state<LPT>(a, sl, thr, v, first);
  for (int t0 = 0; t0 < a.T; t0 += a.chunk) {
    const int n = min(a.chunk, a.T - t0);
    if (t0 > 0) __syncthreads();          // the last chunk's scan is done
    gather<CPL>(a, sl, t0, n, s_cur);
    __syncthreads();
    // a thread past the slice owns no lane
    if (threadIdx.x < sl.width) scan<LPT>(a, sl, s_cur, t0, n, thr, v, first);
  }
  store_state<LPT>(a, sl, v, first, first_out, v_out);
  if constexpr (DECODE) {
    DecodeKeys keys;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int lane = sl.lane0 + threadIdx.x + k * blockDim.x;
      if (threadIdx.x + k * blockDim.x < sl.width && lane < n_out)
        decode_fold(keys, first[k], v[k], lane, n_out);
    }
    if constexpr (CLUSTER) {
      // rank 0's: every rank's reduced keys
      __shared__ long long s_keys[2][MAX_CLUSTER];
      cg::cluster_group cluster = cg::this_cluster();
      keys = decode_reduce(keys);
      cluster_wait();                     // every block of the cluster runs
      if (threadIdx.x == 0) {
        *cluster.map_shared_rank(&s_keys[0][sl.rank], 0) = keys.key;
        *cluster.map_shared_rank(&s_keys[1][sl.rank], 0) = keys.vkey;
      }
      cluster.sync();
      if (sl.rank == 0 && threadIdx.x == 0) {
        for (int r = 1; r < (int)cluster.num_blocks(); ++r) {
          DecodeKeys o;
          o.key = s_keys[0][r];
          o.vkey = s_keys[1][r];
          decode_combine(keys, o);
        }
        labels[sl.b] = decode_pick(keys, n_out, per_group, a.T,
                                   fallback_membrane);
      }
    } else {
      const int label = decode_label(keys, n_out, per_group, a.T,
                                     fallback_membrane);
      if (threadIdx.x == 0) labels[sl.b] = label;
    }
  }
}

// Latency mode. A chunk is scanned through with no barrier; each thread
// then offers the first step at which one of its lanes fired, and if the
// row's earliest lies in the chunk, every thread scans the chunk again from
// the state it started with, up to that step: the state the step-by-step
// exit test leaves (currents past the exit are never added). With CLUSTER
// the offers of every block go to rank 0's slot over distributed shared
// memory, a cluster barrier closes the test, and every block reads the
// row's exit step from rank 0.
template <int CPL, int LPT, bool CLUSTER>
__global__ void __launch_bounds__(MAX_THREADS, 1)
fused_early_exit_kernel(RowArgs a, int32_t* first_out, int32_t* v_out,
                        int32_t* steps) {
  extern __shared__ __align__(16) int32_t s_cur[];   // chunk x slice currents
  // the row's first firing, by chunk: slot k % 2 without a cluster, k % 3
  // (rank 0's) with one
  __shared__ int s_exit[3];
  const Slice sl = block_slice<CLUSTER>(a);
  int32_t thr[LPT], v[LPT], first[LPT];
  load_state<LPT>(a, sl, thr, v, first);
  if constexpr (CLUSTER) {
    if (threadIdx.x == 0) s_exit[0] = s_exit[1] = s_exit[2] = INT32_MAX;
    cg::this_cluster().sync();            // every block has started
  }
  int t_end = a.T;
  for (int t0 = 0, k = 0; t0 < a.T; t0 += a.chunk, ++k) {
    const int n = min(a.chunk, a.T - t0);
    int* slot;
    if constexpr (CLUSTER) {
      // the slot of chunk k + 1 was last read (for chunk k - 2) by every
      // block before the barrier of chunk k - 1, and is next offered to
      // after the barrier of chunk k: rank 0 resets it in between
      if (threadIdx.x == 0 && sl.rank == 0) s_exit[(k + 1) % 3] = INT32_MAX;
      slot = cg::this_cluster().map_shared_rank(&s_exit[k % 3], 0);
    } else {
      // no barrier first: every thread's scan of the last chunk ended
      // before that chunk's exit test, and each thread read the test's slot
      // before this chunk's barrier, after which only the chunk after next
      // resets it
      if (threadIdx.x == 0) s_exit[k & 1] = INT32_MAX;
      slot = &s_exit[k & 1];
    }
    gather<CPL>(a, sl, t0, n, s_cur);
    __syncthreads();
    int32_t v0[LPT], first0[LPT];
    if (threadIdx.x < sl.width) {         // a thread past the slice owns none
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        v0[j] = v[j];
        first0[j] = first[j];
      }
      scan<LPT>(a, sl, s_cur, t0, n, thr, v, first);
      int fired = INT32_MAX;              // no lane fired before this chunk
#pragma unroll
      for (int j = 0; j < LPT; ++j) fired = min(fired, first[j]);
      if (fired < a.T) atomicMin(slot, fired);
    }
    if constexpr (CLUSTER)
      cg::this_cluster().sync();
    else
      __syncthreads();
    const int exit_t = *slot;
    if (exit_t != INT32_MAX) {
      if (threadIdx.x < sl.width) {
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          v[j] = v0[j];
          first[j] = first0[j];
        }
        scan<LPT>(a, sl, s_cur, t0, exit_t - t0 + 1, thr, v, first);
      }
      t_end = exit_t + 1;
      break;
    }
  }
  store_state<LPT>(a, sl, v, first, first_out, v_out);
  if (threadIdx.x == 0 && sl.rank == 0) steps[sl.b] = t_end;
  // rank 0's slots are read by the other blocks until here
  if constexpr (CLUSTER) cg::this_cluster().sync();
}

struct Plan {
  int threads, lpt, chunk, smem, cluster;
};

// Whether the kernels can run `p` for rows of T steps, E slots and n_pad
// lanes: the host's launch_plan (kernels/fused_event_lif/ops.py) gives only
// plans this accepts. A cluster of 2, 4 or 8 blocks splits a row wider than
// 256 lanes into slices of at most 4096, the last slice not empty.
bool plan_ok(int T, int E, int n_pad, const Plan& p) {
  if (T <= 0 || E <= 0 || n_pad <= 0 || n_pad > MAX_CLUSTER * MAX_SLICE)
    return false;
  const int cpl = cols_per_lane(n_pad);
  const bool cluster_ok =
      p.cluster == 1 ||
      (cpl == 16 && (p.cluster == 2 || p.cluster == 4 || p.cluster == 8));
  if (!cluster_ok) return false;
  const int slice = slice_lanes(n_pad, p.cluster);
  if (slice > MAX_SLICE || (long long)slice * (p.cluster - 1) >= n_pad)
    return false;
  const int group = (slice + 32 * cpl - 1) / (32 * cpl);
  const bool lpt_ok =
      p.lpt == 1 || (cpl == 16 && (p.lpt == 2 || p.lpt == 4 || p.lpt == 8));
  return lpt_ok && p.threads % 32 == 0 && p.threads >= 32 * group &&
         p.threads <= MAX_THREADS && (long long)p.lpt * p.threads >= slice &&
         p.chunk >= 1 && p.chunk <= T &&
         (long long)p.chunk * slice * 4 == p.smem && p.smem <= MAX_CUR_BYTES;
}

// Whether a lane loads its CPL bytes of a row as one vector: n_pad a
// multiple of CPL and w 16-byte aligned; bytewise otherwise
bool vector_rows(const int8_t* w, int n_pad) {
  return n_pad % cols_per_lane(n_pad) == 0 && (uintptr_t)w % 16 == 0;
}

RowArgs row_args(const int32_t* ids, const int32_t* count, const int8_t* w,
                 const int32_t* thr, int T, int E, int n_in, int n_pad,
                 int leak_shift, const Plan& p) {
  const int cpl = cols_per_lane(n_pad);
  const int slice = slice_lanes(n_pad, p.cluster);
  return RowArgs{ids,    count, w,       thr,
                 T,      E,     n_in,    n_pad,
                 leak_shift, p.chunk, (slice + 32 * cpl - 1) / (32 * cpl),
                 slice,  vector_rows(w, n_pad)};
}

// Raise the kernel's dynamic shared-memory limit to MAX_CUR_BYTES on a
// device's first launch (bit dev of `ready`; every launch past device 63).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_CUR_BYTES);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

// B rows of `cluster` blocks each: a plain launch of B blocks, or a cluster
// launch of B * cluster
template <typename... Params, typename... Args>
int launch_rows(void (*kernel)(Params...),
                std::atomic<unsigned long long>& ready, const Plan& p, int B,
                cudaStream_t s, Args... args) {
  const cudaError_t err = allow_smem(kernel, ready);
  if (err != cudaSuccess) return (int)err;
  if (p.cluster == 1) {
    kernel<<<B, p.threads, p.smem, s>>>(args...);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)B * p.cluster);
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

template <int CPL, int LPT, bool DECODE, bool CLUSTER>
int launch_full(const RowArgs& a, const Plan& p, int B, int n_out,
                int per_group, int fallback_membrane, int32_t* first_out,
                int32_t* v_out, int32_t* labels, cudaStream_t s) {
  static std::atomic<unsigned long long> ready{0};
  return launch_rows(fused_full_kernel<CPL, LPT, DECODE, CLUSTER>, ready, p,
                     B, s, a, n_out, per_group, fallback_membrane, first_out,
                     v_out, labels);
}

template <int CPL, int LPT, bool CLUSTER>
int launch_early_exit(const RowArgs& a, const Plan& p, int B,
                      int32_t* first_out, int32_t* v_out, int32_t* steps,
                      cudaStream_t s) {
  static std::atomic<unsigned long long> ready{0};
  return launch_rows(fused_early_exit_kernel<CPL, LPT, CLUSTER>, ready, p, B,
                     s, a, first_out, v_out, steps);
}

// The kernel instance for the plan's columns a lane, lanes a thread and
// cluster: `return LAUNCH(CPL, LPT, CLUSTER);` for the one that runs it
#define FUSED_DISPATCH(n_pad, p, LAUNCH)                                 \
  do {                                                                   \
    if ((p).cluster > 1) {                                               \
      switch ((p).lpt) {                                                 \
        case 1: return LAUNCH(16, 1, true);                              \
        case 2: return LAUNCH(16, 2, true);                              \
        case 4: return LAUNCH(16, 4, true);                              \
        default: return LAUNCH(16, 8, true);                             \
      }                                                                  \
    }                                                                    \
    switch (cols_per_lane(n_pad) * 8 + (p).lpt) {                        \
      case 4 * 8 + 1: return LAUNCH(4, 1, false);                        \
      case 8 * 8 + 1: return LAUNCH(8, 1, false);                        \
      case 16 * 8 + 1: return LAUNCH(16, 1, false);                      \
      case 16 * 8 + 2: return LAUNCH(16, 2, false);                      \
      case 16 * 8 + 4: return LAUNCH(16, 4, false);                      \
      default: return LAUNCH(16, 8, false);                              \
    }                                                                    \
  } while (0)

}  // namespace

extern "C" {

int fused_event_lif_decode(const int32_t* ids, const int32_t* count,
                           const int8_t* w, const int32_t* thr,
                           int32_t* first_out, int32_t* v_out, int32_t* labels,
                           int B, int T, int E, int n_in, int n_pad,
                           int leak_shift, int n_out, int per_group,
                           int fallback_membrane, int threads, int lpt,
                           int chunk, int smem, int cluster, void* stream) {
  const Plan p{threads, lpt, chunk, smem, cluster};
  if (B <= 0 || n_out <= 0 || n_out > n_pad || per_group <= 0 ||
      leak_shift < 0 || leak_shift > 31 || !plan_ok(T, E, n_pad, p))
    return (int)cudaErrorInvalidValue;
  const RowArgs a = row_args(ids, count, w, thr, T, E, n_in, n_pad,
                             leak_shift, p);
  const cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(CPL, LPT, CLUSTER)                                          \
  launch_full<CPL, LPT, true, CLUSTER>(a, p, B, n_out, per_group,          \
                                       fallback_membrane, first_out, v_out, \
                                       labels, s)
  FUSED_DISPATCH(n_pad, p, LAUNCH);
#undef LAUNCH
}

int fused_event_lif(const int32_t* ids, const int32_t* count, const int8_t* w,
                    const int32_t* thr, int32_t* first_out, int32_t* v_out,
                    int B, int T, int E, int n_in, int n_pad, int leak_shift,
                    int threads, int lpt, int chunk, int smem, int cluster,
                    void* stream) {
  const Plan p{threads, lpt, chunk, smem, cluster};
  if (B <= 0 || leak_shift < 0 || leak_shift > 31 || !plan_ok(T, E, n_pad, p))
    return (int)cudaErrorInvalidValue;
  const RowArgs a = row_args(ids, count, w, thr, T, E, n_in, n_pad,
                             leak_shift, p);
  const cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(CPL, LPT, CLUSTER)                                          \
  launch_full<CPL, LPT, false, CLUSTER>(a, p, B, 0, 1, 0, first_out, v_out, \
                                        nullptr, s)
  FUSED_DISPATCH(n_pad, p, LAUNCH);
#undef LAUNCH
}

int fused_event_lif_early_exit(const int32_t* ids, const int32_t* count,
                               const int8_t* w, const int32_t* thr,
                               int32_t* first_out, int32_t* v_out,
                               int32_t* steps, int B, int T, int E, int n_in,
                               int n_pad, int leak_shift, int threads, int lpt,
                               int chunk, int smem, int cluster,
                               void* stream) {
  const Plan p{threads, lpt, chunk, smem, cluster};
  if (B <= 0 || leak_shift < 0 || leak_shift > 31 || !plan_ok(T, E, n_pad, p))
    return (int)cudaErrorInvalidValue;
  const RowArgs a = row_args(ids, count, w, thr, T, E, n_in, n_pad,
                             leak_shift, p);
  const cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(CPL, LPT, CLUSTER)                                       \
  launch_early_exit<CPL, LPT, CLUSTER>(a, p, B, first_out, v_out, steps, s)
  FUSED_DISPATCH(n_pad, p, LAUNCH);
#undef LAUNCH
}

// 1 if the kernels take the plan (threads, lpt, chunk, smem, cluster) for
// rows of T steps, E slots and n_pad lanes, 0 if every entry point refuses
// it
int fused_event_lif_plan_ok(int T, int E, int n_pad, int threads, int lpt,
                            int chunk, int smem, int cluster) {
  return plan_ok(T, E, n_pad, Plan{threads, lpt, chunk, smem, cluster});
}

// The bytes of a weight row a gathering lane loads at once from `w` with
// n_pad lanes: its CPL columns as one vector, or 1 where it loads them
// byte by byte; 0 for an n_pad the kernels do not take
int fused_event_lif_row_load_bytes(const int8_t* w, int n_pad) {
  if (n_pad <= 0 || n_pad > MAX_CLUSTER * MAX_SLICE) return 0;
  return vector_rows(w, n_pad) ? cols_per_lane(n_pad) : 1;
}

}  // extern "C"
