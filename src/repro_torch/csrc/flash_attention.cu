// Online-softmax (flash) attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel) and computes what it and the model's
// chunked_attention compute, with the plain version's rule for a query that
// sees no key. For q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D):
//   out[b,h,i] = softmax_k(q[b,h,i] . k[b,h/g,k] / sqrt(D)) @ v[b,h/g]
// with g = Hq / Hkv (GQA: the KV head is h / g, K and V are never expanded),
// where key k is visible to query i (position q_offset + i) only if
//   k < kv_len,  k <= q_offset + i (causal),  k > q_offset + i - window.
// Masked scores are -1e30, not -inf, as in the JAX code: exp(m_prev - m_new)
// stays 1 while a row has seen only masked keys, and a real key wipes what
// they added. A query that sees no key at all gets the mean of v over all Skv
// keys, as the plain version's uniform softmax over -1e30 scores gives; the
// Pallas kernel's mean over its zero-padded block is not copied.
//
// What bounds it on the H100. At the prefill shape (B 2, Hq 32, Hkv 8,
// S 4096, D 128, causal) the causal product needs 4*B*Hq*(S(S+1)/2)*D = 275
// GFLOP and only B*S*D*2*(2*Hq + 2*Hkv) = 168 MB of bf16 traffic (q, k, v
// read once, the output written once): some 0.28 ms on the tensor cores
// (989 TFLOP/s) against 0.05 ms of bytes. It is bound by operations; in
// float32 on the CUDA cores (67 TFLOP/s) the bound is 4.1 ms.
//
// What the design does about it, simply: one block of 256 threads per
// (q tile of 64 rows, q head, batch row). The q tile is loaded once into
// shared memory (transposed, f32; the scores are divided by sqrt(D) after
// the product, as in the plain version); the block then walks the
// 64-key tiles of K and V that some row of the tile can see (tiles fully
// masked by causality, the window or kv_len are never loaded), stages each
// in shared memory as f32, and each thread computes a 4 x 4 block of scores
// from shared memory on the CUDA cores in f32. The running max, sum and the
// 4 x D/16 accumulator stay in registers; the row reductions are shuffles
// within the 16 threads that share a row. Ragged Sq and Skv are bounds
// checks, not padding; the inputs are read through their strides, so the
// model's (B, S, H, D) projections viewed as (B, H, S, D) are read in place,
// and the output is written through its own strides. The output is cast to
// the input type once, at the end. Causal q tiles are scheduled heaviest
// first. No tensor cores yet (mma.sync or wgmma is the redesign this kernel
// is timed against SDPA for).
//
// Shared memory: Qt (D x 64) + Kt (D x 68, later reused for the
// probabilities) + V (64 x D) floats = 98 KB at D = 128 (two blocks an SM),
// 196 KB at D = 256; above the 48 KB default, so the entry point raises the
// kernel's dynamic shared-memory limit.
//
// The C entry point launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16: ty owns 4 rows, tx 4 keys / columns
constexpr int KT_STRIDE = BK + 4;   // floats per d row of Kt (16 B aligned)
constexpr int PT_STRIDE = BQ + 4;   // floats per key row of the probabilities
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, h, s, d;   // in elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// max and sum over the 16 lanes that share ty (lanes 0-15 or 16-31 of a warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

struct Mask {
  int kv_end;      // min(kv_len, Skv): keys at or past it are masked
  int causal, window, q_offset;

  __device__ __forceinline__ bool visible(int qpos, int kpos) const {
    return kpos < kv_end && (!causal || kpos <= qpos) &&
           (window <= 0 || kpos > qpos - window);
  }
  // whether query position qpos sees any key at all
  __device__ __forceinline__ bool sees_a_key(int qpos) const {
    const int lo = window > 0 ? max(0, qpos - window + 1) : 0;
    const int hi = causal ? min(kv_end - 1, qpos) : kv_end - 1;
    return lo <= hi;
  }
};

size_t smem_bytes(int D) {
  const int kt = D * KT_STRIDE > BK * PT_STRIDE ? D * KT_STRIDE
                                                : BK * PT_STRIDE;
  return sizeof(float) * ((size_t)D * BQ + kt + (size_t)BK * D);
}

// NV: 64-column groups of d a thread covers (D <= 64 * NV)
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, Strides qs, const T* __restrict__ k,
             Strides ks, const T* __restrict__ v, Strides vs,
             T* __restrict__ o, Strides os, int group, int Sq, int Skv, int D,
             Mask mask, float sqrt_d) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);    // [d][row]
  float* Kt = Qt + D * BQ;                         // [d][key], then Pt [key][row]
  float* Pt = Kt;
  const int kt_floats = D * KT_STRIDE > BK * PT_STRIDE ? D * KT_STRIDE
                                                       : BK * PT_STRIDE;
  float* Vs = Kt + kt_floats;                      // [key][d]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;       // latest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int rows = min(BQ, Sq - q0);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / group) * ks.h;
  const T* vb = v + b * vs.b + (h / group) * vs.h;

  for (int r = ty; r < BQ; r += 16)
    for (int d = tx; d < D; d += 16)
      Qt[d * BQ + r] = r < rows ? to_f32(qb[(q0 + r) * qs.s + d * qs.d]) : 0.f;

  // the keys some row of this tile can see: [lo, hi)
  const int first_q = mask.q_offset + q0, last_q = first_q + rows - 1;
  int hi = mask.kv_end;
  if (mask.causal) hi = min(hi, last_q + 1);
  const int lo = mask.window > 0 ? max(0, first_q - mask.window + 1) : 0;

  float m[4], l[4], acc[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NV; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();   // the last tile's V and probabilities are consumed
    for (int c = ty; c < BK; c += 16) {
      const bool in = k0 + c < Skv;
      for (int d = tx; d < D; d += 16) {
        Kt[d * KT_STRIDE + c] = in ? to_f32(kb[(k0 + c) * ks.s + d * ks.d])
                                   : 0.f;
        Vs[c * D + d] = in ? to_f32(vb[(k0 + c) * vs.s + d * vs.d]) : 0.f;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + d * BQ + ty * 4);
      const float4 kv =
          *reinterpret_cast<const float4*>(Kt + d * KT_STRIDE + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = first_q + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = mask.visible(qpos, k0 + tx * 4 + j) ? s[i][j] / sqrt_d
                                                       : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NV; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();   // every thread is done reading Kt: reuse it for P
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * PT_STRIDE + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int c_end = min(BK, hi - k0);   // later keys are masked for all rows
    for (int c = 0; c < c_end; ++c) {
      const float4 pv =
          *reinterpret_cast<const float4*>(Pt + c * PT_STRIDE + ty * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < NV; ++g) {
        const int d = tx * 4 + 64 * g;
        if (d < D) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + c * D + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * g + 0] = fmaf(pa[i], vv.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(pa[i], vv.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(pa[i], vv.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(pa[i], vv.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

  // a row that sees no key: the mean of v over all Skv keys
  bool blind = false;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    blind |= ty * 4 + i < rows && !mask.sees_a_key(first_q + ty * 4 + i);
  float* mean = Vs;
  if (__syncthreads_or(blind)) {
    for (int d = tid; d < D; d += THREADS) {
      float sum = 0.f;
      for (int c = 0; c < Skv; ++c) sum += to_f32(vb[c * vs.s + d * vs.d]);
      mean[d] = sum / (float)Skv;
    }
    __syncthreads();
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    const bool no_key = !mask.sees_a_key(first_q + r);
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int g = 0; g < NV; ++g) {
      const int d = tx * 4 + 64 * g;
      if (d >= D) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(ob + (q0 + r) * os.s + (d + e) * os.d,
              no_key ? mean[d + e] : acc[i][4 * g + e] * inv);
    }
  }
}

template <typename T, int NV>
int launch(const void* q, Strides qs, const void* k, Strides ks,
           const void* v, Strides vs, void* o, Strides os, int B, int Hq,
           int group, int Sq, int Skv, int D, Mask mask, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_kernel<T, NV><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), qs, static_cast<const T*>(k), ks,
      static_cast<const T*>(v), vs, static_cast<T*>(o), os, group, Sq, Skv, D,
      mask, sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, Strides qs, const void* k, Strides ks,
             const void* v, Strides vs, void* o, Strides os, int B, int Hq,
             int group, int Sq, int Skv, int D, Mask mask,
             cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 1>(q, qs, k, ks, v, vs, o, os, B, Hq, group, Sq, Skv, D,
                        mask, stream);
  if (D <= 128)
    return launch<T, 2>(q, qs, k, ks, v, vs, o, os, B, Hq, group, Sq, Skv, D,
                        mask, stream);
  return launch<T, 4>(q, qs, k, ks, v, vs, o, os, B, Hq, group, Sq, Skv, D,
                      mask, stream);
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o (B, Hq, Sq, D): element
// (b, h, s, d) of each at ptr[b*sb + h*sh + s*ss + d*sd] (strides in
// elements). dtype 0 = float32, 1 = bfloat16 (all four the same). window <= 0
// means no window; kv_len masks keys at or past it.
int flash_attention(const void* q, long long qsb, long long qsh,
                    long long qss, long long qsd, const void* k,
                    long long ksb, long long ksh, long long kss,
                    long long ksd, const void* v, long long vsb,
                    long long vsh, long long vss, long long vsd, void* o,
                    long long osb, long long osh, long long oss,
                    long long osd, int B, int Hq, int Hkv, int Sq, int Skv,
                    int D, int causal, int window, int q_offset, int kv_len,
                    int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || D < 8 || D > 256 || D % 8 != 0 || B > 65535 ||
      Hq > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss, qsd}, ks{ksb, ksh, kss, ksd},
      vs{vsb, vsh, vss, vsd}, os{osb, osh, oss, osd};
  const Mask mask{kv_len < Skv ? kv_len : Skv, causal, window, q_offset};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, qs, k, ks, v, vs, o, os, B, Hq, Hq / Hkv, Sq,
                           Skv, D, mask, s);
  return dispatch<__nv_bfloat16>(q, qs, k, ks, v, vs, o, os, B, Hq, Hq / Hkv,
                                 Sq, Skv, D, mask, s);
}

}  // extern "C"
