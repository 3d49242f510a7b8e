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
// T and n_pad within the 227 KB of shared memory a block may hold; C = T at
// the MNIST shape, 32 KB) and each chunk runs in two phases:
//  1. gather: every step of the chunk at once, one warp per step (a group of
//     warps when the row is wider than 32 lanes x 16 bytes), a loop for more
//     steps than warps. The warp loads count[b,t] and the step's first 32 ids
//     together (coalesced 4-byte loads, no shared-memory staging, no
//     barrier), the next step's under this one's rows, and broadcasts each id
//     with a shuffle. Each lane loads its 4, 8 or 16 bytes of an event's row
//     as one predicated vector load (bytewise where n_pad or w is not
//     aligned for that), 8 to 32 rows in flight a lane, the next 32 ids
//     loading under them. Lanes sum the bytes as offset binary, two columns
//     to a 32-bit word (five integer instructions per four bytes, exact for
//     256 events between flushes; integer addition in any order is
//     bit-exact) and flush the step's int32 currents to shared memory,
//     C x n_pad. One barrier closes the phase.
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
// steps, shared bytes) chosen on the host, returns cudaErrorInvalidValue
// before any launch if the kernel cannot run it, sets the kernel's
// shared-memory limit once per device, launches on the given stream and
// returns cudaGetLastError(); it allocates nothing and does not synchronise.
// Two queries launch nothing: fused_event_lif_plan_ok (the entry points'
// test of a plan, which chip_smoke.py holds to ops.py's check_plan) and
// fused_event_lif_row_load_bytes (which row loads a launch takes).

#include <atomic>

#include "lif_step.cuh"

namespace {

// 512 threads leave a thread 128 registers (__launch_bounds__): 32 of them
// hold the rows in flight
constexpr int MAX_THREADS = 512;
constexpr int MAX_LPT = 8;                 // lanes per thread: n_pad <= 4096
constexpr int IN_FLIGHT_REGS = 32;         // a lane's registers of row loads
// the most dynamic shared memory a plan may ask for: the H100's 227 KB
// opt-in limit a block (232,448 B) less 1 KB for the static shared memory of
// the decode reduction and the exit test
constexpr int MAX_CUR_BYTES = 232448 - 1024;
constexpr unsigned FULL = 0xffffffffu;

struct RowArgs {
  const int32_t* ids;      // (B, T, E) row-major
  const int32_t* count;    // (B, T)
  const int8_t* w;         // (n_in, n_pad)
  const int32_t* thr;      // (n_pad,)
  int T, E, n_in, n_pad, leak_shift;
  int chunk;               // steps gathered before they are scanned
  int group;               // warps that gather one step
  bool vec;                // rows are loaded as CPL-byte vectors
};

// int8 columns each gathering lane owns: a warp covers 128, 256 or 512 of
// a row's bytes, so a step of a wider row takes a group of warps
__host__ __device__ constexpr int cols_per_lane(int n_pad) {
  return n_pad <= 128 ? 4 : n_pad <= 256 ? 8 : 16;
}

// Rows a lane has in flight: IN_FLIGHT_REGS registers of CPL / 4 words each
template <int CPL>
__host__ __device__ constexpr int rows_in_flight() {
  return IN_FLIGHT_REGS * 4 / CPL < 32 ? IN_FLIGHT_REGS * 4 / CPL : 32;
}

// Each int8 is summed as offset binary, u = s + 128 in 0..255, two columns
// to a 32-bit word (16 bits each): a plain 32-bit add sums two columns, and
// 256 events (at most 65,280) never carry from one half into the other. A
// flush takes 128 for each event back off, in int32.
constexpr uint32_t BIAS = 0x80808080u;
constexpr int FLUSH_EVENTS = 256;

// This lane's CPL bytes of row `id` (wcol = w + col0), four to a word
// (little-endian: column col0 + j is byte j % 4 of word j / 4); BIAS for an
// id outside [0, n_in_lane) and past n_pad, which adds nothing. The vector
// load is one predicated ld.global.nc, not a branch, so the loads of a
// round issue back to back.
template <int CPL, bool VEC>
__device__ __forceinline__ void load_row(const int8_t* wcol, int n_pad,
                                         unsigned n_in_lane, int col0, int id,
                                         uint32_t (&x)[CPL / 4]) {
  const bool ok = (unsigned)id < n_in_lane;
  const int8_t* p = wcol + (long long)id * n_pad;   // read only if ok
#pragma unroll
  for (int k = 0; k < CPL / 4; ++k) x[k] = BIAS;
  if constexpr (VEC) {
    if constexpr (CPL == 4) {
      asm("{.reg .pred q; setp.ne.b32 q, %2, 0;\n\t"
          "@q ld.global.nc.u32 %0, [%1];}"
          : "+r"(x[0]) : "l"(p), "r"((int)ok));
    } else if constexpr (CPL == 8) {
      asm("{.reg .pred q; setp.ne.b32 q, %3, 0;\n\t"
          "@q ld.global.nc.v2.u32 {%0, %1}, [%2];}"
          : "+r"(x[0]), "+r"(x[1]) : "l"(p), "r"((int)ok));
    } else {
      asm("{.reg .pred q; setp.ne.b32 q, %5, 0;\n\t"
          "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];}"
          : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3])
          : "l"(p), "r"((int)ok));
    }
  } else if (ok) {
#pragma unroll
    for (int k = 0; k < CPL / 4; ++k) x[k] = 0;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const uint32_t byte = col0 + j < n_pad ? (uint8_t)__ldg(p + j) : 0x80u;
      x[j / 4] |= byte << (8 * (j % 4));
    }
  }
}

// even[k] += columns 4k and 4k + 2 of x, odd[k] += 4k + 1 and 4k + 3, each
// as u = s + 128 in a 16-bit half
template <int CPL>
__device__ __forceinline__ void add_row(const uint32_t (&x)[CPL / 4],
                                        uint32_t (&even)[CPL / 4],
                                        uint32_t (&odd)[CPL / 4]) {
#pragma unroll
  for (int k = 0; k < CPL / 4; ++k) {
    const uint32_t u = x[k] ^ BIAS;
    even[k] += __byte_perm(u, 0, 0x4240);    // bytes 0 and 2, zero-extended
    odd[k] += __byte_perm(u, 0, 0x4341);     // bytes 1 and 3
  }
}

// The int32 sums of `n` events in even/odd into this lane's columns of the
// step's currents (added to what an earlier flush stored unless `first`);
// clears even/odd.
template <int CPL, bool VEC>
__device__ __forceinline__ void flush(int n_pad, int col0,
                                      uint32_t (&even)[CPL / 4],
                                      uint32_t (&odd)[CPL / 4], int n,
                                      bool first, int32_t* dst) {
  int32_t out[CPL];
#pragma unroll
  for (int k = 0; k < CPL / 4; ++k) {
    out[4 * k] = (int32_t)(even[k] & 0xffffu) - 128 * n;
    out[4 * k + 1] = (int32_t)(odd[k] & 0xffffu) - 128 * n;
    out[4 * k + 2] = (int32_t)(even[k] >> 16) - 128 * n;
    out[4 * k + 3] = (int32_t)(odd[k] >> 16) - 128 * n;
    even[k] = odd[k] = 0;
  }
  if constexpr (VEC) {
    if (col0 >= n_pad) return;
    int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
    for (int q = 0; q < CPL / 4; ++q) {
      int4 r = make_int4(out[4 * q], out[4 * q + 1], out[4 * q + 2],
                         out[4 * q + 3]);
      if (!first) {
        const int4 o = d[q];
        r.x += o.x; r.y += o.y; r.z += o.z; r.w += o.w;
      }
      d[q] = r;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (col0 + j < n_pad) dst[j] = first ? out[j] : dst[j] + out[j];
  }
}

// Phase 1: the currents of steps t0 .. t0 + n_steps - 1 of row b into
// s_cur[c * n_pad + lane]: a step to a warp group, the steps in turn. The
// step's ids arrive 32 at a time, the next 32 loading under the rows of
// these; each round issues the loads of U rows before it adds any.
template <int CPL, bool VEC>
__device__ __forceinline__ void gather_chunk(const RowArgs& a, int b, int t0,
                                             int n_steps, int32_t* s_cur) {
  constexpr int U = rows_in_flight<CPL>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_groups = (int)(blockDim.x / 32) / a.group;
  const int g = warp / a.group;
  if (g >= n_groups) return;
  const int col0 = ((warp - g * a.group) * 32 + lane) * CPL;
  const int8_t* wcol = a.w + col0;
  const unsigned n_in_lane = col0 < a.n_pad ? a.n_in : 0;
  // a step's count and first 32 ids are loaded together (slots past the
  // count are read but never used), the next step's under this one's rows
  auto fetch = [&](int c, int& count, int& ids32) {
    const size_t bt = (size_t)b * a.T + t0 + c;
    count = __ldg(a.count + bt);
    ids32 = lane < a.E ? __ldg(a.ids + bt * a.E + lane) : -1;
  };
  int count_c = 0, ids_c = -1;
  if (g < n_steps) fetch(g, count_c, ids_c);
  for (int c = g; c < n_steps; c += n_groups) {
    const int32_t* step_ids = a.ids + ((size_t)b * a.T + t0 + c) * a.E;
    int32_t* dst = s_cur + (size_t)c * a.n_pad + col0;
    const int n_ev = min(count_c, a.E);
    int next = ids_c;
    if (c + n_groups < n_steps) fetch(c + n_groups, count_c, ids_c);
    uint32_t even[CPL / 4] = {}, odd[CPL / 4] = {};
    int added = 0;                 // events in even/odd since the last flush
    bool first = true;
    for (int base = 0; base < n_ev; base += 32) {
      const int id_lane = base + lane < n_ev ? next : -1;
      const int ahead = base + 32 + lane;
      next = ahead < n_ev ? __ldg(step_ids + ahead) : -1;   // under the rows
      added += __popc(__ballot_sync(FULL, (unsigned)id_lane <
                                              (unsigned)a.n_in));
      const int m = min(32, n_ev - base);
      for (int e0 = 0; e0 < m; e0 += U) {
        int id[U];
#pragma unroll
        for (int u = 0; u < U; ++u)      // e0 + u < 32; past m the id is -1
          id[u] = __shfl_sync(FULL, id_lane, e0 + u);
        uint32_t x[U][CPL / 4];
#pragma unroll
        for (int u = 0; u < U; ++u)
          load_row<CPL, VEC>(wcol, a.n_pad, n_in_lane, col0, id[u], x[u]);
#pragma unroll
        for (int u = 0; u < U; ++u) add_row<CPL>(x[u], even, odd);
      }
      if ((base + 32) % FLUSH_EVENTS == 0 && base + 32 < n_ev) {
        flush<CPL, VEC>(a.n_pad, col0, even, odd, added, first, dst);
        added = 0;
        first = false;
      }
    }
    flush<CPL, VEC>(a.n_pad, col0, even, odd, added, first, dst);
  }
}

template <int CPL>
__device__ __forceinline__ void gather(const RowArgs& a, int b, int t0,
                                       int n_steps, int32_t* s_cur) {
  if (a.vec)
    gather_chunk<CPL, true>(a, b, t0, n_steps, s_cur);
  else
    gather_chunk<CPL, false>(a, b, t0, n_steps, s_cur);
}

// Phase 2: the LIF update and latch of steps t0 .. t0 + n - 1 on this
// thread's lanes, from the chunk's currents. Each lane's column pointer is
// formed once and stepped by n_pad.
template <int LPT>
__device__ __forceinline__ void scan(const RowArgs& a, const int32_t* s_cur,
                                     int t0, int n, const int32_t (&thr)[LPT],
                                     int32_t (&v)[LPT], int32_t (&first)[LPT]) {
  const int32_t* col[LPT];
  bool live[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int lane = threadIdx.x + k * blockDim.x;
    live[k] = lane < a.n_pad;
    col[k] = s_cur + (live[k] ? lane : 0);
  }
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int32_t i = live[k] ? *col[k] : 0;
      col[k] += a.n_pad;
      v[k] = lif_update(v[k], i, a.leak_shift);
      lif_latch(v[k], thr[k], first[k], t0 + c, a.T);
    }
  }
}

template <int LPT>
__device__ __forceinline__ void load_state(const RowArgs& a,
                                           int32_t (&thr)[LPT],
                                           int32_t (&v)[LPT],
                                           int32_t (&first)[LPT]) {
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int lane = threadIdx.x + k * blockDim.x;
    // lanes past n_pad never fire and are never stored
    thr[k] = lane < a.n_pad ? __ldg(a.thr + lane) : INT32_MAX;
    v[k] = 0;
    first[k] = a.T;
  }
}

template <int LPT>
__device__ __forceinline__ void store_state(const RowArgs& a, int b,
                                            const int32_t (&v)[LPT],
                                            const int32_t (&first)[LPT],
                                            int32_t* first_out,
                                            int32_t* v_out) {
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int lane = threadIdx.x + k * blockDim.x;
    if (lane < a.n_pad) {
      first_out[(size_t)b * a.n_pad + lane] = first[k];
      v_out[(size_t)b * a.n_pad + lane] = v[k];
    }
  }
}

// Full T; with DECODE the grouped-TTFS label of the row is written too.
template <int CPL, int LPT, bool DECODE>
__global__ void __launch_bounds__(MAX_THREADS, 1)
fused_full_kernel(RowArgs a, int n_out, int per_group, int fallback_membrane,
                  int32_t* first_out, int32_t* v_out, int32_t* labels) {
  extern __shared__ __align__(16) int32_t s_cur[];   // chunk x n_pad currents
  const int b = blockIdx.x;
  int32_t thr[LPT], v[LPT], first[LPT];
  load_state<LPT>(a, thr, v, first);
  for (int t0 = 0; t0 < a.T; t0 += a.chunk) {
    const int n = min(a.chunk, a.T - t0);
    if (t0 > 0) __syncthreads();          // the last chunk's scan is done
    gather<CPL>(a, b, t0, n, s_cur);
    __syncthreads();
    // a thread past n_pad owns no lane
    if (threadIdx.x < a.n_pad) scan<LPT>(a, s_cur, t0, n, thr, v, first);
  }
  store_state<LPT>(a, b, v, first, first_out, v_out);
  if constexpr (DECODE) {
    DecodeKeys keys;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int lane = threadIdx.x + k * blockDim.x;
      if (lane < n_out) decode_fold(keys, first[k], v[k], lane, n_out);
    }
    const int label = decode_label(keys, n_out, per_group, a.T,
                                   fallback_membrane);
    if (threadIdx.x == 0) labels[b] = label;
  }
}

// Latency mode. A chunk is scanned through with no barrier; each thread
// then offers the first step at which one of its lanes fired, and if the
// row's earliest lies in the chunk, every thread scans the chunk again from
// the state it started with, up to that step: the state the step-by-step
// exit test leaves (currents past the exit are never added).
template <int CPL, int LPT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
fused_early_exit_kernel(RowArgs a, int32_t* first_out, int32_t* v_out,
                        int32_t* steps) {
  extern __shared__ __align__(16) int32_t s_cur[];   // chunk x n_pad currents
  __shared__ int s_exit[2];      // by chunk parity: the row's first firing
  const int b = blockIdx.x;
  int32_t thr[LPT], v[LPT], first[LPT];
  load_state<LPT>(a, thr, v, first);
  int t_end = a.T;
  for (int t0 = 0, k = 0; t0 < a.T; t0 += a.chunk, ++k) {
    const int n = min(a.chunk, a.T - t0);
    // no barrier first: every thread's scan of the last chunk ended before
    // that chunk's exit test, and each thread read the test's slot before
    // this chunk's barrier, after which only the chunk after next resets it
    if (threadIdx.x == 0) s_exit[k & 1] = INT32_MAX;
    gather<CPL>(a, b, t0, n, s_cur);
    __syncthreads();
    int32_t v0[LPT], first0[LPT];
    if (threadIdx.x < a.n_pad) {          // a thread past n_pad owns no lane
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        v0[j] = v[j];
        first0[j] = first[j];
      }
      scan<LPT>(a, s_cur, t0, n, thr, v, first);
      int fired = INT32_MAX;              // no lane fired before this chunk
#pragma unroll
      for (int j = 0; j < LPT; ++j) fired = min(fired, first[j]);
      if (fired < a.T) atomicMin(&s_exit[k & 1], fired);
    }
    __syncthreads();
    const int exit_t = s_exit[k & 1];
    if (exit_t != INT32_MAX) {
      if (threadIdx.x < a.n_pad) {
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          v[j] = v0[j];
          first[j] = first0[j];
        }
        scan<LPT>(a, s_cur, t0, exit_t - t0 + 1, thr, v, first);
      }
      t_end = exit_t + 1;
      break;
    }
  }
  store_state<LPT>(a, b, v, first, first_out, v_out);
  if (threadIdx.x == 0) steps[b] = t_end;
}

struct Plan {
  int threads, lpt, chunk, smem;
};

// Whether the kernels can run `p` for rows of T steps, E slots and n_pad
// lanes: the host's launch_plan (kernels/fused_event_lif/ops.py) gives only
// plans this accepts.
bool plan_ok(int T, int E, int n_pad, const Plan& p) {
  if (T <= 0 || E <= 0 || n_pad <= 0 || n_pad > MAX_THREADS * MAX_LPT)
    return false;
  const int cpl = cols_per_lane(n_pad);
  const int group = (n_pad + 32 * cpl - 1) / (32 * cpl);
  const bool lpt_ok =
      p.lpt == 1 || (cpl == 16 && (p.lpt == 2 || p.lpt == 4 || p.lpt == 8));
  return lpt_ok && p.threads % 32 == 0 && p.threads >= 32 * group &&
         p.threads <= MAX_THREADS && (long long)p.lpt * p.threads >= n_pad &&
         p.chunk >= 1 && p.chunk <= T &&
         (long long)p.chunk * n_pad * 4 == p.smem && p.smem <= MAX_CUR_BYTES;
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
  return RowArgs{ids, count, w, thr, T, E, n_in, n_pad, leak_shift, p.chunk,
                 (n_pad + 32 * cpl - 1) / (32 * cpl), vector_rows(w, n_pad)};
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

template <int CPL, int LPT, bool DECODE>
int launch_full(const RowArgs& a, const Plan& p, int B, int n_out,
                int per_group, int fallback_membrane, int32_t* first_out,
                int32_t* v_out, int32_t* labels, cudaStream_t s) {
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t err = allow_smem(fused_full_kernel<CPL, LPT, DECODE>,
                                     ready);
  if (err != cudaSuccess) return (int)err;
  fused_full_kernel<CPL, LPT, DECODE><<<B, p.threads, p.smem, s>>>(
      a, n_out, per_group, fallback_membrane, first_out, v_out, labels);
  return (int)cudaGetLastError();
}

template <bool DECODE>
int dispatch_full(const RowArgs& a, const Plan& p, int B, int n_out,
                  int per_group, int fallback_membrane, int32_t* first_out,
                  int32_t* v_out, int32_t* labels, cudaStream_t s) {
  switch (cols_per_lane(a.n_pad) * 8 + p.lpt) {
    case 4 * 8 + 1:
      return launch_full<4, 1, DECODE>(a, p, B, n_out, per_group,
                                       fallback_membrane, first_out, v_out,
                                       labels, s);
    case 8 * 8 + 1:
      return launch_full<8, 1, DECODE>(a, p, B, n_out, per_group,
                                       fallback_membrane, first_out, v_out,
                                       labels, s);
    case 16 * 8 + 1:
      return launch_full<16, 1, DECODE>(a, p, B, n_out, per_group,
                                        fallback_membrane, first_out, v_out,
                                        labels, s);
    case 16 * 8 + 2:
      return launch_full<16, 2, DECODE>(a, p, B, n_out, per_group,
                                        fallback_membrane, first_out, v_out,
                                        labels, s);
    case 16 * 8 + 4:
      return launch_full<16, 4, DECODE>(a, p, B, n_out, per_group,
                                        fallback_membrane, first_out, v_out,
                                        labels, s);
    default:
      return launch_full<16, 8, DECODE>(a, p, B, n_out, per_group,
                                        fallback_membrane, first_out, v_out,
                                        labels, s);
  }
}

template <int CPL, int LPT>
int launch_early_exit(const RowArgs& a, const Plan& p, int B,
                      int32_t* first_out, int32_t* v_out, int32_t* steps,
                      cudaStream_t s) {
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t err = allow_smem(fused_early_exit_kernel<CPL, LPT>, ready);
  if (err != cudaSuccess) return (int)err;
  fused_early_exit_kernel<CPL, LPT><<<B, p.threads, p.smem, s>>>(
      a, first_out, v_out, steps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_event_lif_decode(const int32_t* ids, const int32_t* count,
                           const int8_t* w, const int32_t* thr,
                           int32_t* first_out, int32_t* v_out, int32_t* labels,
                           int B, int T, int E, int n_in, int n_pad,
                           int leak_shift, int n_out, int per_group,
                           int fallback_membrane, int threads, int lpt,
                           int chunk, int smem, void* stream) {
  const Plan p{threads, lpt, chunk, smem};
  if (B <= 0 || n_out <= 0 || n_out > n_pad || per_group <= 0 ||
      leak_shift < 0 || leak_shift > 31 || !plan_ok(T, E, n_pad, p))
    return (int)cudaErrorInvalidValue;
  const RowArgs a = row_args(ids, count, w, thr, T, E, n_in, n_pad,
                             leak_shift, p);
  return dispatch_full<true>(a, p, B, n_out, per_group, fallback_membrane,
                             first_out, v_out, labels, (cudaStream_t)stream);
}

int fused_event_lif(const int32_t* ids, const int32_t* count, const int8_t* w,
                    const int32_t* thr, int32_t* first_out, int32_t* v_out,
                    int B, int T, int E, int n_in, int n_pad, int leak_shift,
                    int threads, int lpt, int chunk, int smem, void* stream) {
  const Plan p{threads, lpt, chunk, smem};
  if (B <= 0 || leak_shift < 0 || leak_shift > 31 || !plan_ok(T, E, n_pad, p))
    return (int)cudaErrorInvalidValue;
  const RowArgs a = row_args(ids, count, w, thr, T, E, n_in, n_pad,
                             leak_shift, p);
  return dispatch_full<false>(a, p, B, 0, 1, 0, first_out, v_out, nullptr,
                              (cudaStream_t)stream);
}

int fused_event_lif_early_exit(const int32_t* ids, const int32_t* count,
                               const int8_t* w, const int32_t* thr,
                               int32_t* first_out, int32_t* v_out,
                               int32_t* steps, int B, int T, int E, int n_in,
                               int n_pad, int leak_shift, int threads, int lpt,
                               int chunk, int smem, void* stream) {
  const Plan p{threads, lpt, chunk, smem};
  if (B <= 0 || leak_shift < 0 || leak_shift > 31 || !plan_ok(T, E, n_pad, p))
    return (int)cudaErrorInvalidValue;
  const RowArgs a = row_args(ids, count, w, thr, T, E, n_in, n_pad,
                             leak_shift, p);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (cols_per_lane(n_pad) * 8 + lpt) {
    case 4 * 8 + 1:
      return launch_early_exit<4, 1>(a, p, B, first_out, v_out, steps, s);
    case 8 * 8 + 1:
      return launch_early_exit<8, 1>(a, p, B, first_out, v_out, steps, s);
    case 16 * 8 + 1:
      return launch_early_exit<16, 1>(a, p, B, first_out, v_out, steps, s);
    case 16 * 8 + 2:
      return launch_early_exit<16, 2>(a, p, B, first_out, v_out, steps, s);
    case 16 * 8 + 4:
      return launch_early_exit<16, 4>(a, p, B, first_out, v_out, steps, s);
    default:
      return launch_early_exit<16, 8>(a, p, B, first_out, v_out, steps, s);
  }
}

// 1 if the kernels take the plan (threads, lpt, chunk, smem) for rows of T
// steps, E slots and n_pad lanes, 0 if every entry point refuses it
int fused_event_lif_plan_ok(int T, int E, int n_pad, int threads, int lpt,
                            int chunk, int smem) {
  return plan_ok(T, E, n_pad, Plan{threads, lpt, chunk, smem});
}

// The bytes of a weight row a gathering lane loads at once from `w` with
// n_pad lanes: its CPL columns as one vector, or 1 where it loads them
// byte by byte; 0 for an n_pad the kernels do not take
int fused_event_lif_row_load_bytes(const int8_t* w, int n_pad) {
  if (n_pad <= 0 || n_pad > MAX_THREADS * MAX_LPT) return 0;
  return vector_rows(w, n_pad) ? cols_per_lane(n_pad) : 1;
}

}  // extern "C"
