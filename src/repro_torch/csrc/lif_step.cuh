// Shared device code of the SNN kernels: the integer LIF update and the
// grouped-TTFS comparator, so that the fused kernels (fused_event_lif.cu),
// the staged LIF kernel (lif.cu) and the staged decode kernel
// (ttfs_decode.cu) take both from one file (the comparator in two forms,
// below).
//
// LIF, per lane and step t (all int32, as core.lif_dynamics.lif_step):
//   v     = v - (v >> leak_shift) + i
//   first = t  where v >= thr and first == T   (first-spike latch; T = never)
// The sum is taken on unsigned words and cast back, so an overflowing
// membrane wraps as it does in XLA instead of being undefined behaviour in
// C++; the shift stays on the signed value (sign-extending), so
// leak_shift = 31 adds 1 per step to a negative membrane, as the reference
// does.
//
// Decode, over the logical lanes [0, n) of one row, as ttfs.decode_labels:
// the label is the group of the lane with the smallest first spike, ties to
// the lowest lane, if that first is below the sentinel; else the "membrane"
// fallback (group of the first lane holding the largest v) or 0 ("zero").
// Read lexicographically, the Pallas kernel's key first*n + lane is the pair
// (first, lane), and argmax's first index is (max v, min lane). The rule has
// two forms here, which phase 2 of chip_smoke.py holds to agree (staged
// labels equal the fused kernels' on every case):
//  - DecodeKeys, two int64 keys (first*n + lane; v*2^32 + (INT32_MAX -
//    lane)) folded with min and max: the fused kernels 1-2, whose blocks of a
//    cluster combine their keys (decode_reduce, decode_combine, decode_pick);
//  - DecodePair, the (value, lane) pairs reduced in 32 bits, a value and
//    then the lowest lane at it, each by one redux.sync (warp_decode_reduce,
//    decode_pick_pair): the staged decode kernel, ttfs_decode.cu.
// Both hold at T*n >= 2^31, where the Pallas kernel's int32 key overflows.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ int32_t lif_update(int32_t v, int32_t i,
                                              int leak_shift) {
  const int32_t leak = v >> leak_shift;
  return (int32_t)((uint32_t)v - (uint32_t)leak + (uint32_t)i);
}

__device__ __forceinline__ void lif_latch(int32_t v, int32_t thr,
                                          int32_t& first, int t, int T) {
  if (v >= thr && first == T) first = t;
}

struct DecodeKeys {
  long long key = LLONG_MAX;    // min of first*n + lane
  long long vkey = LLONG_MIN;   // max of v*2^32 + (INT32_MAX - lane)
};

__device__ __forceinline__ void decode_fold(DecodeKeys& k, int32_t first,
                                            int32_t v, int lane, int n) {
  const long long kk = (long long)first * n + lane;
  k.key = kk < k.key ? kk : k.key;
  const long long vk = (long long)v * 4294967296LL + (INT32_MAX - lane);
  k.vkey = vk > k.vkey ? vk : k.vkey;
}

// Warp-wide min of `lo` and max of `hi` (one int64 each a lane); every lane
// gets both.
__device__ __forceinline__ void warp_min_max(long long& lo, long long& hi) {
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    const long long a = __shfl_xor_sync(full, lo, off);
    const long long b = __shfl_xor_sync(full, hi, off);
    lo = a < lo ? a : lo;
    hi = b > hi ? b : hi;
  }
}

// The keys every thread folded, reduced over the block, in thread 0 (the
// other threads get keys that are no reduction). A warp whose keys are all
// untouched skips its fold; warp 0 alone folds the warps' partials.
// blockDim.x is a multiple of 32 and at most 1024; every thread of the block
// calls it once. The keys are associative, so the blocks of a cluster
// combine theirs the same way (decode_combine).
__device__ __forceinline__ DecodeKeys decode_reduce(DecodeKeys k) {
  __shared__ long long part[2][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  long long key = k.key, vkey = k.vkey;
  if (__any_sync(0xffffffffu, key != LLONG_MAX || vkey != LLONG_MIN))
    warp_min_max(key, vkey);
  if (lane == 0) {
    part[0][warp] = key;
    part[1][warp] = vkey;
  }
  __syncthreads();
  if (warp != 0) return k;
  // partials past n_warps are filled with warp 0's: min and max do not
  // change for a repeat
  key = part[0][lane < n_warps ? lane : 0];
  vkey = part[1][lane < n_warps ? lane : 0];
  warp_min_max(key, vkey);
  DecodeKeys r;
  r.key = key;
  r.vkey = vkey;
  return r;
}

__device__ __forceinline__ void decode_combine(DecodeKeys& k,
                                               const DecodeKeys& o) {
  k.key = o.key < k.key ? o.key : k.key;
  k.vkey = o.vkey > k.vkey ? o.vkey : k.vkey;
}

// The row's label from its reduced keys
__device__ __forceinline__ int decode_pick(const DecodeKeys& k, int n,
                                           int per_group, int sentinel,
                                           int fallback_membrane) {
  if (k.key < (long long)sentinel * n) {           // some lane fired
    const long long at = ((k.key % n) + n) % n;    // floor mod: first < 0 too
    return (int)(at / per_group);
  }
  if (fallback_membrane)
    return (INT32_MAX - (int)(k.vkey & 0xffffffffLL)) / per_group;
  return 0;
}

// Reduce every thread's keys over the block and return the row's label in
// thread 0 (the other threads return 0: the divisions run once).
__device__ __forceinline__ int decode_label(DecodeKeys k, int n, int per_group,
                                            int sentinel,
                                            int fallback_membrane) {
  k = decode_reduce(k);
  if (threadIdx.x != 0) return 0;
  return decode_pick(k, n, per_group, sentinel, fallback_membrane);
}

// A thread's (or, reduced, a warp's) decode state in 32 bits: the smallest
// first and the lowest lane holding it, the largest v and the lowest lane
// holding it. A lane index of INT_MAX means no lane was folded; the v pair is
// kept only under the "membrane" fallback.
struct DecodePair {
  int32_t first = INT32_MAX;
  int first_lane = INT_MAX;
  int32_t v = INT32_MIN;
  int v_lane = INT_MAX;
};

// Fold logical lane j; a thread folds its lanes in increasing order, so a
// strict comparison keeps the lowest lane of a tie. A first of INT32_MAX is
// never folded, which is harmless: it is not below any sentinel.
__device__ __forceinline__ void decode_fold_pair(DecodePair& p, int32_t first,
                                                 int32_t v, int j,
                                                 bool membrane) {
  if (first < p.first) {
    p.first = first;
    p.first_lane = j;
  }
  if (membrane && (v > p.v || p.v_lane == INT_MAX)) {
    p.v = v;
    p.v_lane = j;
  }
}

// Fold the lanes start, start + step, ... below n of one row (first and v at
// its lanes 0 .. n-1), loading DECODE_BATCH of them at once before the
// comparisons; v is read only under "membrane".
constexpr int DECODE_BATCH = 8;
__device__ __forceinline__ DecodePair decode_scan(
    const int32_t* __restrict__ first, const int32_t* __restrict__ v, int n,
    int start, int step, bool membrane) {
  DecodePair p;
  for (int j0 = start; j0 < n; j0 += DECODE_BATCH * step) {
    int32_t f[DECODE_BATCH], m[DECODE_BATCH];
#pragma unroll
    for (int k = 0; k < DECODE_BATCH; ++k) {
      const int j = j0 + k * step;
      f[k] = j < n ? __ldg(first + j) : INT32_MAX;
      m[k] = membrane && j < n ? __ldg(v + j) : INT32_MIN;
    }
#pragma unroll
    for (int k = 0; k < DECODE_BATCH; ++k) {
      const int j = j0 + k * step;
      if (j < n) decode_fold_pair(p, f[k], m[k], j, membrane);
    }
  }
  return p;
}

// The warp's pairs reduced (every lane of the warp calls it and gets the
// result): the minimum first, then the lowest lane among the warp's lanes at
// that minimum; under "membrane" the same for the maximum v. Two or four
// redux.sync, no shuffles and no 64-bit arithmetic.
__device__ __forceinline__ DecodePair warp_decode_reduce(const DecodePair& p,
                                                         bool membrane) {
  const unsigned full = 0xffffffffu;
  DecodePair r;
  r.first = __reduce_min_sync(full, p.first);
  r.first_lane = (int)__reduce_min_sync(
      full, p.first == r.first ? (unsigned)p.first_lane : (unsigned)INT_MAX);
  if (membrane) {
    r.v = __reduce_max_sync(full, p.v);
    r.v_lane = (int)__reduce_min_sync(
        full, p.v == r.v ? (unsigned)p.v_lane : (unsigned)INT_MAX);
  }
  return r;
}

// The row's label from its reduced pairs: 32-bit divisions only
__device__ __forceinline__ int decode_pick_pair(const DecodePair& p,
                                                int per_group, int sentinel,
                                                bool membrane) {
  if (p.first < sentinel) return p.first_lane / per_group;   // some lane fired
  return membrane ? p.v_lane / per_group : 0;
}
