// Decode-step attention kernels for Hopper (sm_90a).
//
// Replace the TPU kernels taiwan_whisper_tpu/ops/decode_attention.py::
// cross_decode_attention (_cross_kernel) and self_decode_attention
// (_self_kernel), with the numerics of the JAX model's own path
// (models/whisper.py::_cross_attention / _cached_self_attn): fp32 scores
// and softmax, probabilities rounded to the compute dtype, fp32 P V
// accumulation, fp32 output.
//
// Bound: bytes. Each step streams the whole cross K/V of every layer
// (large-v2, batch 32, fp8: 122.9 MB per layer) for 4 flop per element;
// the self cache adds up to 31.9 MB per layer at 195 positions.
//
// Design: one block per (b, h). The K/V slices are time-minor ([Dh, T] per
// (b, h), the JAX package's layout), so threads stride over T and every
// load is coalesced along t; int8 and fp8-e4m3 storage is dequantized in
// registers, so the stream stays 1 byte per element. Scores for the 1-8
// query rows stay in shared memory (8 x 1500 x 4 B = 48 KB at most); the
// softmax is two block reductions; P V runs with warps over d rows and
// lanes along t. The self kernel reads only positions valid_from <= t <
// index and folds the current token's logit and value in through the same
// max/rescale as the TPU kernel. Splitting T across blocks for occupancy is
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

// probabilities are rounded to the compute dtype (the dtype of q), as the
// JAX model casts its softmax output before the P V product
__device__ __forceinline__ float round_as(float p, const float*) { return p; }
__device__ __forceinline__ float round_as(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < WARPS; ++w) x = fmaxf(x, red[w]);
  return x;
}

__device__ float block_sum(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = 0.f;
  for (int w = 0; w < WARPS; ++w) x += red[w];
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct QS { long long b, r, h; };   // q / out strides (elements), d contiguous
struct KS { long long b, h, d; };   // time-minor K/V strides, t contiguous

// q [B, R, H, D] pre-scaled; k/v [B, H, D, T]; out fp32 [B, R, H, D]
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
cross_attn(const TQ* __restrict__ q, QS qs,
           const TKV* __restrict__ k, KS ks,
           const TKV* __restrict__ v, KS vs,
           float* __restrict__ o, QS os, int H, int R, int T) {
  extern __shared__ float sm[];
  float* qf = sm;              // [R, D]
  float* p = sm + R * D;       // [R, T]
  __shared__ float red[WARPS];
  const int b = blockIdx.x / H, h = blockIdx.x % H;

  for (int i = threadIdx.x; i < R * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qf[i] = to_f(q[b * qs.b + r * qs.r + h * qs.h + d]);
  }
  __syncthreads();

  const TKV* kb = k + b * ks.b + h * ks.h;
  for (int t = threadIdx.x; t < T; t += THREADS) {
    float acc[MAX_ROWS];
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kv = to_f(kb[d * ks.d + t]);
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r)
        if (r < R) acc[r] = fmaf(qf[r * D + d], kv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r)
      if (r < R) p[r * T + t] = acc[r];
  }
  __syncthreads();

  for (int r = 0; r < R; ++r) {
    float* pr = p + r * T;
    float mx = -INFINITY;
    for (int t = threadIdx.x; t < T; t += THREADS) mx = fmaxf(mx, pr[t]);
    mx = block_max(mx, red);
    float sum = 0.f;
    for (int t = threadIdx.x; t < T; t += THREADS) {
      const float e = expf(pr[t] - mx);
      pr[t] = e;
      sum += e;
    }
    sum = block_sum(sum, red);
    for (int t = threadIdx.x; t < T; t += THREADS) pr[t] = round_as(pr[t] / sum, q);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const TKV* vb = v + b * vs.b + h * vs.h;
  for (int d = warp; d < D; d += WARPS) {
    float acc[MAX_ROWS];
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) acc[r] = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float vv = to_f(vb[d * vs.d + t]);
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r)
        if (r < R) acc[r] = fmaf(p[r * T + t], vv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r < R) {
        const float s = warp_sum(acc[r]);
        if (lane == 0) o[b * os.b + r * os.r + h * os.h + d] = s;
      }
    }
  }
}

struct HS { long long b, h; };  // [B, H, D] strides, d contiguous

// q, k_t, v_t [B, H, D] (q pre-scaled); cache [B, H, D, S]; out fp32 [B, H, D]
template <typename T>
__global__ void __launch_bounds__(THREADS)
self_attn(const T* __restrict__ q, HS qs, const T* __restrict__ kt, HS kts,
          const T* __restrict__ vt, HS vts,
          const T* __restrict__ ck, KS cks, const T* __restrict__ cv, KS cvs,
          const int* __restrict__ valid_from, int index,
          float* __restrict__ o, int H) {
  extern __shared__ float p[];   // [index]
  __shared__ float qf[D];
  __shared__ float red[WARPS];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  if (threadIdx.x < D) qf[threadIdx.x] = to_f(q[b * qs.b + h * qs.h + threadIdx.x]);
  __syncthreads();

  // logit of the current token, attended to directly
  float cur = threadIdx.x < D ? qf[threadIdx.x] * to_f(kt[b * kts.b + h * kts.h + threadIdx.x]) : 0.f;
  cur = block_sum(cur, red);

  const int lo = valid_from ? max(valid_from[b], 0) : 0, hi = index;  // null: no floor
  const T* kb = ck + b * cks.b + h * cks.h;
  float mx = -INFINITY;
  for (int t = lo + threadIdx.x; t < hi; t += THREADS) {
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) acc = fmaf(qf[d], to_f(kb[d * cks.d + t]), acc);
    p[t] = acc;
    mx = fmaxf(mx, acc);
  }
  mx = fmaxf(block_max(mx, red), cur);
  float sum = 0.f;
  for (int t = lo + threadIdx.x; t < hi; t += THREADS) {
    const float e = expf(p[t] - mx);
    p[t] = e;
    sum += e;
  }
  const float e_cur = expf(cur - mx);
  const float den = block_sum(sum, red) + e_cur;
  for (int t = lo + threadIdx.x; t < hi; t += THREADS) p[t] = round_as(p[t] / den, q);
  const float p_cur = round_as(e_cur / den, q);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* vb = cv + b * cvs.b + h * cvs.h;
  for (int d = warp; d < D; d += WARPS) {
    float acc = 0.f;
    for (int t = lo + lane; t < hi; t += 32) acc = fmaf(p[t], to_f(vb[d * cvs.d + t]), acc);
    acc = warp_sum(acc);
    if (lane == 0)
      o[(b * H + h) * D + d] = acc + p_cur * to_f(vt[b * vts.b + h * vts.h + d]);
  }
}

template <typename TQ, typename TKV>
int launch_cross(const void* q, QS qs, const void* k, KS ks, const void* v, KS vs,
                 void* o, QS os, int B, int H, int R, int T, cudaStream_t st) {
  const size_t smem = (size_t)R * (D + T) * sizeof(float);
  auto kern = cross_attn<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B * H, THREADS, smem, st>>>((const TQ*)q, qs, (const TKV*)k, ks, (const TKV*)v, vs,
                                     (float*)o, os, H, R, T);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8, 3 float8_e4m3fn.
extern "C" int twt_cross_attention(
    int q_dtype, int kv_dtype, int B, int H, int R, int T,
    const void* q, long long qsb, long long qsr, long long qsh,
    const void* k, long long ksb, long long ksh, long long ksd,
    const void* v, long long vsb, long long vsh, long long vsd,
    void* o, long long osb, long long osr, long long osh, void* stream) {
  if (R < 1 || R > MAX_ROWS) return (int)cudaErrorInvalidValue;
  const QS qs{qsb, qsr, qsh}, os{osb, osr, osh};
  const KS ks{ksb, ksh, ksd}, vs{vsb, vsh, vsd};
  cudaStream_t st = (cudaStream_t)stream;
#define TWT_CROSS(TQ, TKV) launch_cross<TQ, TKV>(q, qs, k, ks, v, vs, o, os, B, H, R, T, st)
  if (q_dtype == 1) {
    if (kv_dtype == 1) return TWT_CROSS(__nv_bfloat16, __nv_bfloat16);
    if (kv_dtype == 2) return TWT_CROSS(__nv_bfloat16, int8_t);
    if (kv_dtype == 3) return TWT_CROSS(__nv_bfloat16, __nv_fp8_e4m3);
  } else if (q_dtype == 0) {
    if (kv_dtype == 0) return TWT_CROSS(float, float);
    if (kv_dtype == 2) return TWT_CROSS(float, int8_t);
    if (kv_dtype == 3) return TWT_CROSS(float, __nv_fp8_e4m3);
  }
#undef TWT_CROSS
  return (int)cudaErrorInvalidValue;
}

extern "C" int twt_self_attention(
    int dtype, int B, int H, int index,
    const void* q, long long qsb, long long qsh,
    const void* kt, long long ktsb, long long ktsh,
    const void* vt, long long vtsb, long long vtsh,
    const void* ck, long long cksb, long long cksh, long long cksd,
    const void* cv, long long cvsb, long long cvsh, long long cvsd,
    const void* valid_from, void* o, void* stream) {
  const HS qs{qsb, qsh}, kts{ktsb, ktsh}, vts{vtsb, vtsh};
  const KS cks{cksb, cksh, cksd}, cvs{cvsb, cvsh, cvsd};
  const size_t smem = (size_t)(index > 0 ? index : 1) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    self_attn<__nv_bfloat16><<<B * H, THREADS, smem, st>>>(
        (const __nv_bfloat16*)q, qs, (const __nv_bfloat16*)kt, kts, (const __nv_bfloat16*)vt, vts,
        (const __nv_bfloat16*)ck, cks, (const __nv_bfloat16*)cv, cvs,
        (const int*)valid_from, index, (float*)o, H);
  } else if (dtype == 0) {
    self_attn<float><<<B * H, THREADS, smem, st>>>(
        (const float*)q, qs, (const float*)kt, kts, (const float*)vt, vts,
        (const float*)ck, cks, (const float*)cv, cvs,
        (const int*)valid_from, index, (float*)o, H);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
