// Row LayerNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel taiwan_whisper_tpu/ops/layer_norm.py::
// layer_norm_pallas (_ln_kernel): LayerNorm over the last axis d (a
// multiple of 128) with fp32 mean and variance, input and output in the
// same type (bf16 or fp32), scale and bias in that type too (the wrapper
// rounds them to it, as the TPU kernel does).
//
// Bound: bytes. Each row is read once and written once (5 flop per element
// against 4 bytes at bf16), so the least time is 2 * N * d * itemsize over
// the card's memory rate.
//
// Design: one warp per row, eight rows per 256-thread block. A lane holds
// its d / 32 elements in registers as chunks of 4 neighbours (8- or
// 16-byte loads, d / 128 chunks, d <= 2048), so the mean, the centred
// variance and the output each take one pass over registers and the row
// touches device memory once each way. The TPU kernel's 256-row blocks and
// row padding have no use here: the grid covers the rows exactly and the
// last block masks its spare warps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_CHUNKS = 16;  // d <= 16 * 128
constexpr int ROWS_PER_BLOCK = 8;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<const uint32_t*>(&lo);
  x.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
ln_rows(const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ bias,
        T* __restrict__ y, long long n_rows, int d, float eps) {
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int chunks = d / 128;
  const T* xr = x + row * d;
  float v[MAX_CHUNKS][4];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < MAX_CHUNKS; ++c) {
    if (c < chunks) {
      load4(xr + c * 128 + lane * 4, v[c]);
      sum += (v[c][0] + v[c][1]) + (v[c][2] + v[c][3]);
    }
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < MAX_CHUNKS; ++c) {
    if (c < chunks) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[c][j] -= mean;
        sq = fmaf(v[c][j], v[c][j], sq);
      }
    }
  }
  const float rs = rsqrtf(warp_sum(sq) / d + eps);
  T* yr = y + row * d;
#pragma unroll
  for (int c = 0; c < MAX_CHUNKS; ++c) {
    if (c < chunks) {
      const int col = c * 128 + lane * 4;
      float sc[4], bi[4], out[4];
      load4(scale + col, sc);
      load4(bias + col, bi);
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] = fmaf(v[c][j] * rs, sc[j], bi[j]);
      store4(yr + col, out);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, scale, bias and y all of it).
// x and y are contiguous [n_rows, d]; d % 128 == 0 and d <= 2048.
extern "C" int twt_layer_norm(int dtype, const void* x, const void* scale, const void* bias,
                              void* y, long long n_rows, int d, float eps, void* stream) {
  if (d % 128 != 0 || d > 128 * MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK));
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    ln_rows<T><<<grid, 32 * ROWS_PER_BLOCK, 0, st>>>((const T*)x, (const T*)scale,
                                                     (const T*)bias, (T*)y, n_rows, d, eps);
  } else if (dtype == 0) {
    ln_rows<float><<<grid, 32 * ROWS_PER_BLOCK, 0, st>>>((const float*)x, (const float*)scale,
                                                         (const float*)bias, (float*)y, n_rows,
                                                         d, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
