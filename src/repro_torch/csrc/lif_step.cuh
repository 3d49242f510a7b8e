// Shared device code of the SNN kernels: the integer LIF update and the
// grouped-TTFS comparator, so that the fused kernels (fused_event_lif.cu),
// the staged LIF kernel (lif.cu) and the staged decode kernel
// (ttfs_decode.cu) run one definition of each.
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
// the label is the group of the smallest packed key first*n + lane if any
// lane's first is below the sentinel, else the "membrane" fallback (group of
// the first lane holding the largest v) or 0 ("zero"). The key is int64, so
// T*n may exceed 2^31 (the Pallas kernel's key is int32); the membrane key
// v*2^32 + (INT32_MAX - lane) breaks ties to the first lane, as jnp.argmax.

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
