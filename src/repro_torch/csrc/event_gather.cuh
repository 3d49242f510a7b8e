// The event gather the SNN kernels share: for a step row of event ids, the
// int32 sum of the int8 weight rows of its live events, over the columns a
// lane owns. The fused kernels (fused_event_lif.cu) gather each chunk of a
// batch row's steps into shared memory with it; event_accum.cu writes each
// step row's currents to device memory with it.
//
//   sum[n] = sum over slots e with ids[e] in [0, n_in) of w[ids[e], n]
//
// Which slots count is a flag:
//   COUNTED = true   the first count[s] slots of step row s (the fused
//                    kernels, whose rows come from pack_events_batched);
//   COUNTED = false  every slot, with no count read: PAD (-1) and ids at or
//                    past n_in are skipped wherever they sit in the row, as
//                    the Pallas event_accum kernel masks them.
// Either way an id outside [0, n_in) reads nothing, so a bad id cannot read
// outside w.
//
// How. A warp gathers one step row at a time (a group of warps for a row
// wider than the 128, 256 or 512 columns of a warp), over the step rows
// s0, s0 + stride, ... The warp loads the row's ids with coalesced 4-byte
// loads (no shared-memory staging, no barrier), the next ones under this
// one's weight rows (gather_rows says how each mode does), and broadcasts
// each id with a shuffle. Each lane loads its 4, 8 or 16 bytes of an event's weight row as
// one predicated vector load (bytewise where n_pad or w is not aligned for
// that), 8 to 32 rows in flight a lane, the next 32 ids loading under them.
// Lanes sum the bytes as offset binary, two columns to a 32-bit word (five
// integer instructions per four bytes, exact for 256 events between
// flushes; integer addition in any order is bit-exact) and hand the int32
// sums to the caller's sink at every flush.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace event_gather {

constexpr unsigned FULL = 0xffffffffu;
constexpr int IN_FLIGHT_REGS = 32;         // a lane's registers of row loads

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
// id outside [0, n_in_lane) and past the lane's last column (`cols` of its
// CPL are real), which adds nothing. The vector load is one predicated
// ld.global.nc, not a branch, so the loads of a round issue back to back.
template <int CPL, bool VEC>
__device__ __forceinline__ void load_row(const int8_t* wcol, int n_pad,
                                         unsigned n_in_lane, int cols, int id,
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
      const uint32_t byte = j < cols ? (uint8_t)__ldg(p + j) : 0x80u;
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

// The int32 sums of `n` events in even/odd, column by column; clears
// even/odd.
template <int CPL>
__device__ __forceinline__ void unpack(uint32_t (&even)[CPL / 4],
                                       uint32_t (&odd)[CPL / 4], int n,
                                       int32_t (&out)[CPL]) {
#pragma unroll
  for (int k = 0; k < CPL / 4; ++k) {
    out[4 * k] = (int32_t)(even[k] & 0xffffu) - 128 * n;
    out[4 * k + 1] = (int32_t)(odd[k] & 0xffffu) - 128 * n;
    out[4 * k + 2] = (int32_t)(even[k] >> 16) - 128 * n;
    out[4 * k + 3] = (int32_t)(odd[k] >> 16) - 128 * n;
    even[k] = odd[k] = 0;
  }
}

// A lane's sums into dst[0 .. cols), stored, or added to what dst holds
// unless `first`: as CPL / 4 int4 (VEC: dst 16-byte aligned, every column
// real or none) or column by column.
template <int CPL, bool VEC>
__device__ __forceinline__ void store_sums(int32_t* dst,
                                           const int32_t (&out)[CPL],
                                           bool first, int cols) {
  if constexpr (VEC) {
    if (cols <= 0) return;
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
      if (j < cols) dst[j] = first ? out[j] : dst[j] + out[j];
  }
}

struct Rows {
  const int32_t* ids;      // step rows of E slots each
  const int32_t* count;    // events of each step row (read if COUNTED)
  const int8_t* w;         // (n_in, n_pad) int8
  int E, n_in, n_pad;
};

// The weight rows of the ids that lanes 0 .. m - 1 of the warp hold
// (id_lane; an id outside [0, n_in_lane) adds nothing) into even/odd, U rows
// in flight a lane: the loads of a round issue before any add.
template <int CPL, bool VEC>
__device__ __forceinline__ void add_rows(const int8_t* wcol, int n_pad,
                                         unsigned n_in_lane, int cols,
                                         int id_lane, int m,
                                         uint32_t (&even)[CPL / 4],
                                         uint32_t (&odd)[CPL / 4]) {
  constexpr int U = rows_in_flight<CPL>();
  for (int e0 = 0; e0 < m; e0 += U) {
    int id[U];
#pragma unroll
    for (int u = 0; u < U; ++u)          // e0 + u < 32
      id[u] = __shfl_sync(FULL, id_lane, e0 + u);
    uint32_t x[U][CPL / 4];
#pragma unroll
    for (int u = 0; u < U; ++u)
      load_row<CPL, VEC>(wcol, n_pad, n_in_lane, cols, id[u], x[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) add_row<CPL>(x[u], even, odd);
  }
}

// Gathers step rows s0, s0 + stride, ... below s_end for this lane's
// columns col0 .. col0 + CPL - 1 (those below col_end are real). Every lane
// of the warp calls it alike (the ids travel by shuffle). At each flush it
// calls sink(s, sums, first, last): the int32 sums of the row's events since
// the last flush, `first` for the row's first flush, `last` for its last
// (a row with no event has one flush, of zeros).
//
// COUNTED: a row's count and first 32 ids are loaded together (slots past
// the count are read but never used), the next row's under this one's rows,
// and the slots below the count are taken 32 at a time. Every slot: the
// ids of 128 slots (4 rounds of 32) are loaded at once (the next 128, or
// the next row's first, under these rounds' rows); each round is tested
// together (a ballot), a round with no live id is skipped and the others
// are taken up to their last live slot, so that packed rows (events first,
// PAD after) cost their events only, and PAD anywhere else costs a
// predicated-off load.
template <int CPL, bool VEC, bool COUNTED, class Sink>
__device__ __forceinline__ void gather_rows(const Rows& a, int col0,
                                            int col_end, int s0, int stride,
                                            int s_end, Sink&& sink) {
  const int lane = threadIdx.x % 32;
  const int8_t* wcol = a.w + col0;
  const unsigned n_in_lane = col0 < col_end ? a.n_in : 0;
  const int cols = col_end - col0;
  if constexpr (COUNTED) {
    auto fetch = [&](int s, int& n_ev, int& ids32) {
      n_ev = min(__ldg(a.count + s), a.E);
      ids32 = lane < a.E ? __ldg(a.ids + (size_t)s * a.E + lane) : -1;
    };
    int n_c = 0, ids_c = -1;
    if (s0 < s_end) fetch(s0, n_c, ids_c);
    for (int s = s0; s < s_end; s += stride) {
      const int32_t* step_ids = a.ids + (size_t)s * a.E;
      const int n_ev = n_c;
      int next = ids_c;
      if (s + stride < s_end) fetch(s + stride, n_c, ids_c);
      uint32_t even[CPL / 4] = {}, odd[CPL / 4] = {};
      int32_t sums[CPL];
      int added = 0;               // events in even/odd since the last flush
      bool first = true;
      for (int base = 0; base < n_ev; base += 32) {
        // past the count the id is -1
        const int id_lane = base + lane < n_ev ? next : -1;
        const int ahead = base + 32 + lane;
        next = ahead < n_ev ? __ldg(step_ids + ahead) : -1;  // under the rows
        added += __popc(__ballot_sync(FULL, (unsigned)id_lane <
                                                (unsigned)a.n_in));
        add_rows<CPL, VEC>(wcol, a.n_pad, n_in_lane, cols, id_lane,
                           min(32, n_ev - base), even, odd);
        if ((base + 32) % FLUSH_EVENTS == 0 && base + 32 < n_ev) {
          unpack<CPL>(even, odd, added, sums);
          sink(s, sums, first, false);
          added = 0;
          first = false;
        }
      }
      unpack<CPL>(even, odd, added, sums);
      sink(s, sums, first, true);
    }
  } else {
    constexpr int R = 4;           // rounds of 32 slots loaded at once
    auto fetch = [&](int s, int base, int (&v)[R]) {
      const int32_t* p = a.ids + (size_t)s * a.E + base;
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = base + 32 * r + lane < a.E ? __ldg(p + 32 * r + lane) : -1;
    };
    int ahead[R];
    if (s0 < s_end) fetch(s0, 0, ahead);
    for (int s = s0; s < s_end; s += stride) {
      uint32_t even[CPL / 4] = {}, odd[CPL / 4] = {};
      int32_t sums[CPL];
      int added = 0;               // events in even/odd since the last flush
      bool first = true;
      for (int base = 0; base < a.E; base += 32 * R) {
        int v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = ahead[r];
        if (base + 32 * R < a.E)
          fetch(s, base + 32 * R, ahead);
        else if (s + stride < s_end)
          fetch(s + stride, 0, ahead);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const unsigned live = __ballot_sync(
              FULL, (unsigned)v[r] < (unsigned)a.n_in);
          if (live == 0) continue;
          added += __popc(live);
          add_rows<CPL, VEC>(wcol, a.n_pad, n_in_lane, cols, v[r],
                             32 - __clz(live), even, odd);
        }
        // 128 slots a group: flush every 2 groups, at most 256 events
        if ((base + 32 * R) % FLUSH_EVENTS == 0 && base + 32 * R < a.E) {
          unpack<CPL>(even, odd, added, sums);
          sink(s, sums, first, false);
          added = 0;
          first = false;
        }
      }
      unpack<CPL>(even, odd, added, sums);
      sink(s, sums, first, true);
    }
  }
}

}  // namespace event_gather
