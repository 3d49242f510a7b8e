// The backward of flash attention (sm_90a): the gradients dq, dk and dv of
// out = softmax(q k^T / sqrt(D)) v under the forward's masks, float32 and
// bfloat16, head size D from 8 to 256 in steps of 8, every tensor through
// its strides; plain C interface.
//
// It replaces no TPU kernel. The JAX package trains through its jnp
// chunked_attention (src/repro/models/layers.py:57), which XLA
// differentiates; it has no Pallas backward. The port's forward attention
// is a hand-written kernel that autograd cannot see into
// (kernels/flash_attention/ops.py::FlashAttention), so its backward is one
// too. For q (B, Hq, Sq, D), k, v (B, Hkv, Skv, D), out and dout (B, Hq, Sq,
// D), with g = Hq / Hkv, scale = 1 / sqrt(D) and key j visible to query i
// (position q_offset + i) only if j < kv_len, j <= q_offset + i (causal) and
// j > q_offset + i - window:
//   P = softmax over visible keys of scale * q k^T   (a row that sees no key:
//       1 / Skv on every key, as the forward's -1e30 fill gives)
//   delta_i = sum_d dout_i * out_i
//   dS = P * (dout v^T - delta) on visible pairs, 0 elsewhere (the fill is
//       a constant: a masked score has no gradient)
//   dq = scale * dS k,  dk = scale * sum over the group of dS^T q,
//   dv = sum over the group of P^T dout.
// Everything is computed in float32 on the CUDA cores, with correctly
// rounded expf and logf, and cast to the input type once, at the end.
//
// What bounds it on the H100. At the training shape (B 4, Hq 32, Hkv 4, S
// 2048, D 128, causal) each of the eight products below (Q K^T twice and
// dO V^T, dS K in pass 1; Q K^T, dO V^T, P^T dO, dS^T Q in pass 2) takes
// 2 * B * Hq * S(S+1)/2 * D = 68.7 GFLOP: 550 GFLOP against about 0.3 GB
// of traffic, bound by operations, 8.2 ms on the CUDA cores at 67 TFLOP/s.
// This first kernel is simple and right, not fast: tiles of 32 x 32 from
// shared memory, each thread a 2 x 2 block of scores (one shared load per
// multiply-add), no tensor cores.
//
// The design: two launches on the caller's stream, no atomics, every output
// element written once by one thread, in a fixed order of summation, so two
// runs on the same inputs give the same bits.
//  * Pass 1, one block per (32-row q tile, q head, batch row): loads Q and
//    dO, computes delta; walks the key tiles the tile's rows can see twice.
//    The first walk keeps each row's running max and sum (online softmax;
//    masked scores are -inf and take no part), giving its log-sum-exp
//    (+inf for a row that sees no key); lse and delta go to a float32
//    scratch for pass 2. The second walk recomputes P = exp(s - lse) and dP
//    = dO V^T, writes dS to shared memory and accumulates dQ += dS K in
//    registers (a thread: one row, every eighth column).
//  * Pass 2, one block per (32-key tile, kv head, batch row): loads K and V,
//    loops over the group's q heads and, for each, over the q tiles that see
//    a key of the tile or hold a row that sees none; recomputes P and dS
//    from the rows' lse and delta and accumulates dV += P^T dO and dK += dS^T
//    Q in registers (a thread: one key, every eighth column).
// Shared memory: four tiles of 32 x (D + 1) floats (the odd row stride
// keeps the 16 keys a half-warp reads in distinct banks) and one (pass 1) or
// two (pass 2) 32 x 33 tiles of P / dS: 70 KB at D 128, 140 KB at D 256.
//
// The C entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;    // q rows a tile
constexpr int BK = 32;    // keys a tile
constexpr int NT = 256;   // threads a block
constexpr int LDP = BK + 1;

struct Strides {
  long long b, h, s, d;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float* lse;     // (B, Hq, Sq): log-sum-exp of each row, +inf if it sees none
  float* delta;   // (B, Hq, Sq): rowsum(dout * out)
  int Hq, Hkv, group, Sq, Skv, D;
  int kv_end;     // min(kv_len, Skv), at least 0
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// The keys [lo, hi) visible to the query at position qpos (empty if hi <= lo).
__device__ __forceinline__ void visible_keys(const Params& p, int qpos,
                                             int& lo, int& hi) {
  lo = p.window > 0 ? max(0, qpos - p.window + 1) : 0;
  hi = p.causal ? min(p.kv_end, qpos + 1) : p.kv_end;
}

// Rows row0 .. row0 + 31 of a (., ., S, D) tensor at base + off into a 32 x
// (D + 1) float tile; rows at or past n_valid are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          long long off, const Strides& s,
                                          int row0, int n_valid, int D) {
  for (int idx = threadIdx.x; idx < 32 * D; idx += NT) {
    const int r = idx / D, d = idx - r * D;
    float x = 0.f;
    if (r < n_valid)
      x = to_f(base[off + (long long)(row0 + r) * s.s + (long long)d * s.d]);
    dst[r * ld + d] = x;
  }
}

// out[a][c] = A[ra + a] . B[cb + c] over D, for a, c in {0, 1}.
__device__ __forceinline__ void dots(const float* A, const float* B, int ld,
                                     int D, int ra, int cb, float out[2][2]) {
  const float* a0 = A + ra * ld;
  const float* a1 = a0 + ld;
  const float* b0 = B + cb * ld;
  const float* b1 = b0 + ld;
  float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float x0 = a0[d], x1 = a1[d], y0 = b0[d], y1 = b1[d];
    s00 = fmaf(x0, y0, s00);
    s01 = fmaf(x0, y1, s01);
    s10 = fmaf(x1, y0, s10);
    s11 = fmaf(x1, y1, s11);
  }
  out[0][0] = s00;
  out[0][1] = s01;
  out[1][0] = s10;
  out[1][1] = s11;
}

// Max and sum over the 16 lanes of a half-warp (the threads of a row pair).
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr int smem_floats(int D, int ps_tiles) {
  return 4 * 32 * (D + 1) + ps_tiles * 32 * LDP + 2 * 32;
}

// ------------------------------------------------------------------ pass 1
template <typename T, int NC>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(const Params p) {
  extern __shared__ float sm[];
  const int D = p.D, ld = D + 1;
  float* Qs = sm;
  float* dOs = Qs + BQ * ld;
  float* Ks = dOs + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* Ss = Vs + BK * ld;          // dS, [BQ][LDP]
  float* lse_s = Ss + BQ * LDP;
  float* delta_s = lse_s + BQ;

  const int t = threadIdx.x;
  const int i0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int nrows = min(BQ, p.Sq - i0);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* o = static_cast<const T*>(p.o);
  const T* dout = static_cast<const T*>(p.dout);
  const long long qoff = b * p.qs.b + h * p.qs.h;
  const long long ooff = b * p.os.b + h * p.os.h;
  const long long dooff = b * p.dos.b + h * p.dos.h;
  const long long koff = b * p.ks.b + hk * p.ks.h;
  const long long voff = b * p.vs.b + hk * p.vs.h;
  const long long row_stat = ((long long)b * p.Hq + h) * p.Sq + i0;

  load_tile(Qs, ld, q, qoff, p.qs, i0, nrows, D);
  load_tile(dOs, ld, dout, dooff, p.dos, i0, nrows, D);
  __syncthreads();

  // delta: a row to 8 consecutive lanes, every eighth column each
  const int r8 = t >> 3, l8 = t & 7;
  {
    float acc = 0.f;
    if (r8 < nrows)
      for (int d = l8; d < D; d += 8)
        acc = fmaf(dOs[r8 * ld + d],
                   to_f(o[ooff + (long long)(i0 + r8) * p.os.s +
                          (long long)d * p.os.d]),
                   acc);
#pragma unroll
    for (int s = 4; s > 0; s >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (l8 == 0) delta_s[r8] = acc;
  }

  // scores: rows rs, rs + 1 and keys cs, cs + 1 of a tile to each thread
  const int rs = (t >> 4) * 2, cs = (t & 15) * 2;
  int lo[2], hi[2];
  bool valid[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    valid[a] = rs + a < nrows;
    visible_keys(p, p.q_offset + i0 + rs + a, lo[a], hi[a]);
  }
  // the keys some row of the tile sees: from the first row's lo to the
  // last row's hi (both grow with the position)
  int kmin, kmax, unused;
  visible_keys(p, p.q_offset + i0, kmin, unused);
  visible_keys(p, p.q_offset + i0 + nrows - 1, unused, kmax);

  // walk 1: each row's running max and sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = kmin; k0 < kmax; k0 += BK) {
    __syncthreads();
    load_tile(Ks, ld, k, koff, p.ks, k0, min(BK, p.Skv - k0), D);
    __syncthreads();
    float s[2][2];
    dots(Qs, Ks, ld, D, rs, cs, s);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float sv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = k0 + cs + c;
        sv[c] = valid[a] && j >= lo[a] && j < hi[a] ? s[a][c] * p.scale
                                                    : -INFINITY;
      }
      const float m_new = fmaxf(m[a], half_max(fmaxf(sv[0], sv[1])));
      float e = 0.f;
      if (m_new != -INFINITY) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (sv[c] != -INFINITY) e += expf(sv[c] - m_new);
      }
      e = half_sum(e);
      if (m_new != -INFINITY) {
        l[a] = l[a] * expf(m[a] - m_new) + e;
        m[a] = m_new;
      }
    }
  }
  if ((t & 15) == 0) {
#pragma unroll
    for (int a = 0; a < 2; ++a)
      lse_s[rs + a] = m[a] == -INFINITY ? INFINITY : m[a] + logf(l[a]);
  }
  __syncthreads();
  if (t < nrows) {
    p.lse[row_stat + t] = lse_s[t];
    p.delta[row_stat + t] = delta_s[t];
  }

  // walk 2: dS, and dQ += dS K (a thread: row r8, columns l8 + 8 c)
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  for (int k0 = kmin; k0 < kmax; k0 += BK) {
    __syncthreads();
    const int nk = min(BK, p.Skv - k0);
    load_tile(Ks, ld, k, koff, p.ks, k0, nk, D);
    load_tile(Vs, ld, v, voff, p.vs, k0, nk, D);
    __syncthreads();
    float s[2][2], dp[2][2];
    dots(Qs, Ks, ld, D, rs, cs, s);
    dots(dOs, Vs, ld, D, rs, cs, dp);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = k0 + cs + c;
        float ds = 0.f;
        if (valid[a] && j >= lo[a] && j < hi[a]) {
          const float pr = expf(s[a][c] * p.scale - lse_s[rs + a]);
          ds = pr * (dp[a][c] - delta_s[rs + a]);
        }
        Ss[(rs + a) * LDP + cs + c] = ds;
      }
    }
    __syncthreads();
    const float* srow = Ss + r8 * LDP;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float ds = srow[c];
      const float* kr = Ks + c * ld;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int d = l8 + 8 * cc;
        if (d < D) acc[cc] = fmaf(ds, kr[d], acc[cc]);
      }
    }
  }
  if (r8 < nrows) {
    T* dq = static_cast<T*>(p.dq);
    const long long base =
        b * p.dqs.b + h * p.dqs.h + (long long)(i0 + r8) * p.dqs.s;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = l8 + 8 * cc;
      if (d < D)
        dq[base + (long long)d * p.dqs.d] = from_f<T>(acc[cc] * p.scale);
    }
  }
}

// ------------------------------------------------------------------ pass 2
template <typename T, int NC>
__global__ void __launch_bounds__(NT) bwd_dkdv_kernel(const Params p) {
  extern __shared__ float sm[];
  const int D = p.D, ld = D + 1;
  float* Ks = sm;
  float* Vs = Ks + BK * ld;
  float* Qs = Vs + BK * ld;
  float* dOs = Qs + BQ * ld;
  float* Ps = dOs + BQ * ld;         // P, [BQ][LDP]
  float* Ds = Ps + BQ * LDP;         // dS, [BQ][LDP]
  float* lse_s = Ds + BQ * LDP;
  float* delta_s = lse_s + BQ;

  const int t = threadIdx.x;
  const int j0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int nk = min(BK, p.Skv - j0);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);

  load_tile(Ks, ld, k, b * p.ks.b + hk * p.ks.h, p.ks, j0, nk, D);
  load_tile(Vs, ld, v, b * p.vs.b + hk * p.vs.h, p.vs, j0, nk, D);

  const int rs = (t >> 4) * 2, cs = (t & 15) * 2;
  const int c8 = t >> 3, l8 = t & 7;
  const float uniform = 1.f / (float)p.Skv;   // a row that sees no key
  float dk[NC], dv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dk[c] = dv[c] = 0.f;

  const int nq = (p.Sq + BQ - 1) / BQ;
  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const long long qoff = b * p.qs.b + h * p.qs.h;
    const long long dooff = b * p.dos.b + h * p.dos.h;
    const long long row_stat = ((long long)b * p.Hq + h) * p.Sq;
    for (int qt = 0; qt < nq; ++qt) {
      const int i0 = qt * BQ, nrows = min(BQ, p.Sq - i0);
      int lo_f, hi_f, lo_l, hi_l;
      visible_keys(p, p.q_offset + i0, lo_f, hi_f);
      visible_keys(p, p.q_offset + i0 + nrows - 1, lo_l, hi_l);
      // rows that see no key are a prefix and a suffix of the positions
      const bool any_empty = hi_f <= lo_f || hi_l <= lo_l;
      const bool meets = lo_f < j0 + nk && hi_l > j0;
      if (!any_empty && !meets) continue;
      __syncthreads();
      load_tile(Qs, ld, q, qoff, p.qs, i0, nrows, D);
      load_tile(dOs, ld, dout, dooff, p.dos, i0, nrows, D);
      if (t < BQ) {
        lse_s[t] = t < nrows ? p.lse[row_stat + i0 + t] : 0.f;
        delta_s[t] = t < nrows ? p.delta[row_stat + i0 + t] : 0.f;
      }
      __syncthreads();
      float s[2][2], dp[2][2];
      dots(Qs, Ks, ld, D, rs, cs, s);
      dots(dOs, Vs, ld, D, rs, cs, dp);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = rs + a;
        int lo, hi;
        visible_keys(p, p.q_offset + i0 + r, lo, hi);
        const bool row = r < nrows;
        const bool empty = hi <= lo;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = j0 + cs + c;
          float pr = 0.f, ds = 0.f;
          if (row && j < p.Skv) {
            if (empty) {
              pr = uniform;
            } else if (j >= lo && j < hi) {
              pr = expf(s[a][c] * p.scale - lse_s[r]);
              ds = pr * (dp[a][c] - delta_s[r]);
            }
          }
          Ps[r * LDP + cs + c] = pr;
          Ds[r * LDP + cs + c] = ds;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        const float pr = Ps[r * LDP + c8], ds = Ds[r * LDP + c8];
        const float* dor = dOs + r * ld;
        const float* qr = Qs + r * ld;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int d = l8 + 8 * cc;
          if (d < D) {
            dv[cc] = fmaf(pr, dor[d], dv[cc]);
            dk[cc] = fmaf(ds, qr[d], dk[cc]);
          }
        }
      }
    }
  }
  if (c8 < nk) {
    T* dkp = static_cast<T*>(p.dk);
    T* dvp = static_cast<T*>(p.dv);
    const long long kb =
        b * p.dks.b + hk * p.dks.h + (long long)(j0 + c8) * p.dks.s;
    const long long vb =
        b * p.dvs.b + hk * p.dvs.h + (long long)(j0 + c8) * p.dvs.s;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = l8 + 8 * cc;
      if (d < D) {
        dkp[kb + (long long)d * p.dks.d] = from_f<T>(dk[cc] * p.scale);
        dvp[vb + (long long)d * p.dvs.d] = from_f<T>(dv[cc]);
      }
    }
  }
}

template <typename T, int NC>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int sm1 = smem_floats(p.D, 1) * (int)sizeof(float);
  const int sm2 = smem_floats(p.D, 2) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bwd_dq_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(bwd_dkdv_kernel<T, NC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, sm2);
  if (e != cudaSuccess) return (int)e;
  bwd_dq_kernel<T, NC><<<dim3((p.Sq + BQ - 1) / BQ, p.Hq, B), NT, sm1,
                         stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dkdv_kernel<T, NC><<<dim3((p.Skv + BK - 1) / BK, p.Hkv, B), NT, sm2,
                           stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int B, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 4>(p, B, stream);
  if (p.D <= 64) return launch<T, 8>(p, B, stream);
  if (p.D <= 128) return launch<T, 16>(p, B, stream);
  return launch<T, 32>(p, B, stream);
}

}  // namespace

extern "C" {

// q, out, dout, dq (B, Hq, Sq, D); k, v, dk, dv (B, Hkv, Skv, D): element
// (b, h, s, d) of each at ptr[b*sb + h*sh + s*ss + d*sd] (strides in
// elements). lse and delta: float32 scratch of B * Hq * Sq each. dtype 0 =
// float32, 1 = bfloat16 (all eight the same). window <= 0 means no window;
// kv_len masks keys at or past it.
int flash_attention_bwd(
    const void* q, long long qsb, long long qsh, long long qss, long long qsd,
    const void* k, long long ksb, long long ksh, long long kss, long long ksd,
    const void* v, long long vsb, long long vsh, long long vss, long long vsd,
    const void* o, long long osb, long long osh, long long oss, long long osd,
    const void* dout, long long dsb, long long dsh, long long dss,
    long long dsd, void* dq, long long qgb, long long qgh, long long qgs,
    long long qgd, void* dk, long long kgb, long long kgh, long long kgs,
    long long kgd, void* dv, long long vgb, long long vgh, long long vgs,
    long long vgd, float* lse, float* delta, int B, int Hq, int Hkv, int Sq,
    int Skv, int D, int causal, int window, int q_offset, int kv_len,
    int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || D < 8 || D > 256 || D % 8 != 0 || B > 65535 ||
      Hq > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.qs = Strides{qsb, qsh, qss, qsd};
  p.ks = Strides{ksb, ksh, kss, ksd};
  p.vs = Strides{vsb, vsh, vss, vsd};
  p.os = Strides{osb, osh, oss, osd};
  p.dos = Strides{dsb, dsh, dss, dsd};
  p.dqs = Strides{qgb, qgh, qgs, qgd};
  p.dks = Strides{kgb, kgh, kgs, kgd};
  p.dvs = Strides{vgb, vgh, vgs, vgd};
  p.lse = lse;
  p.delta = delta;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.group = Hq / Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.D = D;
  p.kv_end = kv_len < Skv ? (kv_len > 0 ? kv_len : 0) : Skv;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = 1.f / sqrtf((float)D);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(p, B, s);
  return dispatch<__nv_bfloat16>(p, B, s);
}

}  // extern "C"
