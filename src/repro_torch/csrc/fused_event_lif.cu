// Fused event -> LIF -> decode kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_event_lif/kernel.py:
//   fused_event_lif_decode      <- fused_event_lif_decode_kernel     (full T, label)
//   fused_event_lif_early_exit  <- fused_event_lif_early_exit_kernel (latency mode)
//   fused_event_lif             <- fused_event_lif_kernel            (full T, no label)
// and computes exactly what they compute. For each batch row b and step t:
//   i[n]  = sum over e < count[b,t] with ids[b,t,e] >= 0 of w[ids[b,t,e], n]   (int32)
//   v     = v - (v >> leak_shift) + i        (arithmetic shift on signed int)
//   first = t where (v >= thr && first == T) (first-spike latch; T = never)
// The decode kernel then applies the grouped-TTFS comparator of lif_step.cuh
// to the logical lanes [0, n_out); fused_event_lif is the same kernel compiled
// without that epilogue (a template flag). The early-exit kernel stops a row after the first step at which ANY of its
// n_pad lanes has fired and reports v at exit and the steps executed.
//
// What bounds it on the H100. Per image the kernel must read the weight rows
// of its events (events x n_pad int8 bytes, e.g. ~520 x 256 B for an MNIST
// digit), the step's ids (at most T*E_max*4 bytes, only count[b,t] of them are
// read) and write 2*n_pad*4 bytes of state. That is a few hundred KB for a
// batch of 64: far below what the memory system moves in the time of the
// T = 32 dependent steps, so the kernel is bound by latency (the T sequential
// steps, each waiting on its ids and then on their weight rows), not by bytes
// or operations.
//
// What the design does about it. One block per batch row; each thread owns
// LPT lanes tid, tid + blockDim, ... (n_pad <= 4096), with v and first in
// registers for the whole T loop: the (T, n_pad) currents tensor of the staged
// pipeline is never materialized. At each step the block first copies the
// step's ids into shared memory in one coalesced load; then every thread walks
// them (a broadcast read) and loads its own bytes of each weight row, so a
// warp reads 32 consecutive bytes of one row and, since the row loads no
// longer wait on one id load each, several rows are in flight at once. The
// weight matrix stays in device memory and is served from the 50 MB L2 (the
// MNIST w_padded is 784 x 256 = 200,704 B, nearly all of the 227 KB of shared
// memory a block may hold; staging it is a later redesign). Rows run in
// parallel across SMs; steps cannot, since each depends on the last.
//
// Integer semantics: the update and latch of lif_step.cuh (wrapping like XLA,
// arithmetic shift). Ids outside [0, n_in) are skipped (PAD is -1), so a bad
// id cannot read outside w.
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include "lif_step.cuh"

namespace {

// 512 threads keep a block within the SM's 65,536 registers at up to 128
// registers a thread (__launch_bounds__ holds the compiler to that)
constexpr int MAX_THREADS = 512;
constexpr int MAX_LPT = 8;     // lanes per thread: n_pad <= 4096
constexpr int ID_CHUNK = 256;  // ids staged in shared memory at a time

struct RowArgs {
  const int32_t* ids;      // (B, T, E) row-major
  const int32_t* count;    // (B, T)
  const int8_t* w;         // (n_in, n_pad)
  const int32_t* thr;      // (n_pad,)
  int T, E, n_in, n_pad, leak_shift;
};

// Sum of the step's gathered rows for this thread's LPT lanes. Every thread
// of the block calls it with the same (b, t): it synchronises the block.
template <int LPT>
__device__ __forceinline__ void gather_step(const RowArgs& a, int b, int t,
                                            int32_t* s_ids,
                                            int32_t (&acc)[LPT]) {
#pragma unroll
  for (int k = 0; k < LPT; ++k) acc[k] = 0;
  const int n_ev = __ldg(a.count + (size_t)b * a.T + t);
  const int32_t* step_ids = a.ids + ((size_t)b * a.T + t) * a.E;
  for (int base = 0; base < n_ev; base += ID_CHUNK) {
    const int m = min(ID_CHUNK, n_ev - base);
    __syncthreads();                     // the last chunk's readers are done
    for (int e = threadIdx.x; e < m; e += blockDim.x)
      s_ids[e] = __ldg(step_ids + base + e);
    __syncthreads();
#pragma unroll 8
    for (int e = 0; e < m; ++e) {
      const int id = s_ids[e];
      const bool ok = (unsigned)id < (unsigned)a.n_in;
      // a skipped id reads row 0 and adds nothing: no branch between loads
      const int8_t* row = a.w + (size_t)(ok ? id : 0) * a.n_pad;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int lane = threadIdx.x + k * blockDim.x;
        const int32_t x = lane < a.n_pad ? (int32_t)__ldg(row + lane) : 0;
        acc[k] += ok ? x : 0;
      }
    }
  }
}

// One LIF step on this thread's lanes; returns whether any of them has fired
// so far.
template <int LPT>
__device__ __forceinline__ bool lif_step(const RowArgs& a, int t,
                                         const int32_t (&acc)[LPT],
                                         const int32_t (&thr)[LPT],
                                         int32_t (&v)[LPT],
                                         int32_t (&first)[LPT]) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    v[k] = lif_update(v[k], acc[k], a.leak_shift);
    lif_latch(v[k], thr[k], first[k], t, a.T);
    any |= first[k] != a.T;
  }
  return any;
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
template <int LPT, bool DECODE>
__global__ void __launch_bounds__(MAX_THREADS)
fused_full_kernel(RowArgs a, int n_out, int per_group, int fallback_membrane,
                  int32_t* first_out, int32_t* v_out, int32_t* labels) {
  __shared__ int32_t s_ids[ID_CHUNK];
  const int b = blockIdx.x;
  int32_t thr[LPT], v[LPT], first[LPT], acc[LPT];
  load_state<LPT>(a, thr, v, first);
  for (int t = 0; t < a.T; ++t) {
    gather_step<LPT>(a, b, t, s_ids, acc);
    lif_step<LPT>(a, t, acc, thr, v, first);
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

template <int LPT>
__global__ void __launch_bounds__(MAX_THREADS)
fused_early_exit_kernel(RowArgs a, int32_t* first_out, int32_t* v_out,
                        int32_t* steps) {
  __shared__ int32_t s_ids[ID_CHUNK];
  const int b = blockIdx.x;
  int32_t thr[LPT], v[LPT], first[LPT], acc[LPT];
  load_state<LPT>(a, thr, v, first);
  int t = 0;
  while (t < a.T) {
    gather_step<LPT>(a, b, t, s_ids, acc);
    const bool fired = lif_step<LPT>(a, t, acc, thr, v, first);
    ++t;
    // the exit test spans all n_pad lanes of the row, as jnp.all(first == T)
    // does over the padded block; every thread takes the same branch
    if (__syncthreads_or(fired)) break;
  }
  store_state<LPT>(a, b, v, first, first_out, v_out);
  if (threadIdx.x == 0) steps[b] = t;
}

// Threads per block (a multiple of 32) and lanes per thread (a power of two)
// for n_pad lanes; false if n_pad is out of range.
bool launch_shape(int n_pad, int* threads, int* lpt) {
  if (n_pad <= 0 || n_pad > MAX_THREADS * MAX_LPT) return false;
  int l = 1;
  while (l * MAX_THREADS < n_pad) l *= 2;
  const int per = (n_pad + l - 1) / l;
  *threads = ((per + 31) / 32) * 32;
  *lpt = l;
  return true;
}

template <int LPT, bool DECODE>
void launch_full(const RowArgs& a, int B, int threads, int n_out,
                 int per_group, int fallback_membrane, int32_t* first_out,
                 int32_t* v_out, int32_t* labels, cudaStream_t stream) {
  fused_full_kernel<LPT, DECODE><<<B, threads, 0, stream>>>(
      a, n_out, per_group, fallback_membrane, first_out, v_out, labels);
}

template <bool DECODE>
void dispatch_full(const RowArgs& a, int B, int threads, int lpt, int n_out,
                   int per_group, int fallback_membrane, int32_t* first_out,
                   int32_t* v_out, int32_t* labels, cudaStream_t s) {
  switch (lpt) {
    case 1: launch_full<1, DECODE>(a, B, threads, n_out, per_group,
                                   fallback_membrane, first_out, v_out, labels,
                                   s);
            break;
    case 2: launch_full<2, DECODE>(a, B, threads, n_out, per_group,
                                   fallback_membrane, first_out, v_out, labels,
                                   s);
            break;
    case 4: launch_full<4, DECODE>(a, B, threads, n_out, per_group,
                                   fallback_membrane, first_out, v_out, labels,
                                   s);
            break;
    default: launch_full<8, DECODE>(a, B, threads, n_out, per_group,
                                    fallback_membrane, first_out, v_out,
                                    labels, s);
  }
}

template <int LPT>
void launch_early_exit(const RowArgs& a, int B, int threads,
                       int32_t* first_out, int32_t* v_out, int32_t* steps,
                       cudaStream_t stream) {
  fused_early_exit_kernel<LPT><<<B, threads, 0, stream>>>(a, first_out, v_out,
                                                          steps);
}

}  // namespace

extern "C" {

int fused_event_lif_decode(const int32_t* ids, const int32_t* count,
                           const int8_t* w, const int32_t* thr,
                           int32_t* first_out, int32_t* v_out, int32_t* labels,
                           int B, int T, int E, int n_in, int n_pad,
                           int leak_shift, int n_out, int per_group,
                           int fallback_membrane, void* stream) {
  int threads, lpt;
  if (B <= 0 || T <= 0 || E <= 0 || n_out <= 0 || n_out > n_pad ||
      per_group <= 0 || leak_shift < 0 || leak_shift > 31 ||
      !launch_shape(n_pad, &threads, &lpt))
    return (int)cudaErrorInvalidValue;
  const RowArgs a{ids, count, w, thr, T, E, n_in, n_pad, leak_shift};
  dispatch_full<true>(a, B, threads, lpt, n_out, per_group, fallback_membrane,
                      first_out, v_out, labels, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int fused_event_lif(const int32_t* ids, const int32_t* count, const int8_t* w,
                    const int32_t* thr, int32_t* first_out, int32_t* v_out,
                    int B, int T, int E, int n_in, int n_pad, int leak_shift,
                    void* stream) {
  int threads, lpt;
  if (B <= 0 || T <= 0 || E <= 0 || leak_shift < 0 || leak_shift > 31 ||
      !launch_shape(n_pad, &threads, &lpt))
    return (int)cudaErrorInvalidValue;
  const RowArgs a{ids, count, w, thr, T, E, n_in, n_pad, leak_shift};
  dispatch_full<false>(a, B, threads, lpt, 0, 1, 0, first_out, v_out, nullptr,
                       (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int fused_event_lif_early_exit(const int32_t* ids, const int32_t* count,
                               const int8_t* w, const int32_t* thr,
                               int32_t* first_out, int32_t* v_out,
                               int32_t* steps, int B, int T, int E, int n_in,
                               int n_pad, int leak_shift, void* stream) {
  int threads, lpt;
  if (B <= 0 || T <= 0 || E <= 0 || leak_shift < 0 || leak_shift > 31 ||
      !launch_shape(n_pad, &threads, &lpt))
    return (int)cudaErrorInvalidValue;
  const RowArgs a{ids, count, w, thr, T, E, n_in, n_pad, leak_shift};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lpt) {
    case 1: launch_early_exit<1>(a, B, threads, first_out, v_out, steps, s);
            break;
    case 2: launch_early_exit<2>(a, B, threads, first_out, v_out, steps, s);
            break;
    case 4: launch_early_exit<4>(a, B, threads, first_out, v_out, steps, s);
            break;
    default: launch_early_exit<8>(a, B, threads, first_out, v_out, steps, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
