// Row LayerNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel taiwan_whisper_tpu/ops/layer_norm.py::
// layer_norm_pallas (_ln_kernel): LayerNorm over the last axis d (a
// multiple of 128) with fp32 mean and centred variance, input and output in
// the same type (bf16 or fp32), scale and bias rounded to that type first,
// as the TPU kernel does. Scale and bias come in fp32 or in x's type; the
// kernel rounds them itself, so the wrapper launches no cast.
//
// Bound: bytes. Each row is read once and written once (5 flop per element
// against 4 bytes at bf16): at the encoder's LN shape [48000, 1280] bf16,
// 2 * 48000 * 1280 * 2 bytes = 245.8 MB, 0.0734 ms at 3.35 TB/s.
//
// Design: one warp per row, 8 rows per 256-thread block, the grid covering
// the rows (ops/layer_norm.py::launch_plan picks the route, the chunks and
// the grid). The block rounds scale and bias to x's dtype into shared
// memory once; its rows read them from there.
//  - Resident route, d <= 2048: a lane holds its share of the row in
//    registers as CH 16-byte packs (8 bf16 or 4 fp32; CH = chunks, a
//    template argument, so no pack is predicated off but a bf16 row's last
//    when d % 256 == 128), so the mean, the centred variance and the output
//    each take one pass over registers. x is read with a streaming,
//    no-L1-allocate load and y written with a streaming store: each byte is
//    touched once.
//  - Streamed route, d > 2048: two passes over the row. The first keeps each
//    lane's (count, mean, centred sum of squares) over its packs, merged
//    pack by pack and then across the warp in Chan's form, reading x with a
//    normal load so the row stays in L2; the second reads it back from L2,
//    normalises and streams y out, with scale and bias read per row.
// A persistent grid (blocks for every SM walking the rows, the next row's
// packs issued before this row's reductions) measured 4% slower at [48000,
// 1280] bf16 on the H100 (PERF.md): its last round of rows is partial,
// where the hardware's block scheduler balances one row per warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_RESIDENT_D = 2048;

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// element i of scale or bias, in fp32 or in T, rounded to T
template <typename T>
__device__ __forceinline__ float param(const void* p, int fp32, int i) {
  return fp32 ? round_to<T>(static_cast<const float*>(p)[i])
              : static_cast<float>(static_cast<const T*>(p)[i]);
}

template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void get(const uint4& u, float v[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 put(const float v[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void get(const uint4& u, float v[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 put(const float v[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 u;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w) : "l"(p));
  return u;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int CH>
__global__ void __launch_bounds__(THREADS)
ln_resident(const T* __restrict__ x, const void* __restrict__ scale,
            const void* __restrict__ bias, int params_fp32, T* __restrict__ y,
            long long n_rows, int d, float eps) {
  constexpr int V = Pack<T>::N;  // elements of one 16-byte pack
  constexpr int W = 32 * V;      // elements of one chunk (a pack per lane)
  __shared__ __align__(16) T s_sc[CH * W], s_bi[CH * W];
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  // the row's loads first, so they are in flight while scale and bias are
  // rounded into shared memory
  uint4 cur[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = c * W + lane * V;
    cur[c] = row < n_rows && col < d ? load_stream(x + row * d + col) : make_uint4(0, 0, 0, 0);
  }
  for (int i = threadIdx.x; i < d; i += THREADS) {
    s_sc[i] = static_cast<T>(param<T>(scale, params_fp32, i));
    s_bi[i] = static_cast<T>(param<T>(bias, params_fp32, i));
  }
  __syncthreads();
  if (row >= n_rows) return;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (c * W + lane * V < d) {
      float v[V];
      Pack<T>::get(cur[c], v);
#pragma unroll
      for (int j = 0; j < V; ++j) sum += v[j];
    }
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (c * W + lane * V < d) {
      float v[V];
      Pack<T>::get(cur[c], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = v[j] - mean;
        sq = fmaf(t, t, sq);
      }
    }
  }
  const float rs = rsqrtf(warp_sum(sq) / d + eps);
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = c * W + lane * V;
    if (col < d) {
      float v[V], sc[V], bi[V];
      Pack<T>::get(cur[c], v);
      Pack<T>::get(*reinterpret_cast<const uint4*>(s_sc + col), sc);
      Pack<T>::get(*reinterpret_cast<const uint4*>(s_bi + col), bi);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = fmaf((v[j] - mean) * rs, sc[j], bi[j]);
      __stcs(reinterpret_cast<uint4*>(y + row * d + col), Pack<T>::put(v));
    }
  }
}

// (n, mean, m2) <- the merge with a group of nb values of mean mb and
// centred sum of squares m2b (Chan et al.)
__device__ __forceinline__ void merge(float& n, float& mean, float& m2, float nb, float mb,
                                      float m2b) {
  const float nn = n + nb;
  if (nn == 0.f) return;
  const float delta = mb - mean;
  mean += delta * (nb / nn);
  m2 += m2b + delta * delta * (n * nb / nn);
  n = nn;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_streamed(const T* __restrict__ x, const void* __restrict__ scale,
            const void* __restrict__ bias, int params_fp32, T* __restrict__ y,
            long long n_rows, int d, float eps) {
  constexpr int V = Pack<T>::N, W = 32 * V, U = 4;  // U packs in flight per lane
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= n_rows) return;
  const T* xr = x + row * d;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int c0 = 0; c0 * W < d; c0 += U) {
    uint4 p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int col = (c0 + u) * W + lane * V;
      if (col < d) p[u] = __ldg(reinterpret_cast<const uint4*>(xr + col));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if ((c0 + u) * W + lane * V < d) {
        float v[V], s = 0.f, q = 0.f;
        Pack<T>::get(p[u], v);
#pragma unroll
        for (int j = 0; j < V; ++j) s += v[j];
        const float mb = s / V;
#pragma unroll
        for (int j = 0; j < V; ++j) q = fmaf(v[j] - mb, v[j] - mb, q);
        merge(n, mean, m2, (float)V, mb, q);
      }
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float n2 = __shfl_xor_sync(0xffffffffu, n, off);
    const float mean2 = __shfl_xor_sync(0xffffffffu, mean, off);
    const float m22 = __shfl_xor_sync(0xffffffffu, m2, off);
    merge(n, mean, m2, n2, mean2, m22);
  }
  const float rs = rsqrtf(m2 / d + eps);
  for (int c = 0; c * W < d; ++c) {
    const int col = c * W + lane * V;
    if (col < d) {
      float v[V];
      Pack<T>::get(__ldcs(reinterpret_cast<const uint4*>(xr + col)), v);
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[j] = fmaf((v[j] - mean) * rs, param<T>(scale, params_fp32, col + j),
                    param<T>(bias, params_fp32, col + j));
      __stcs(reinterpret_cast<uint4*>(y + row * d + col), Pack<T>::put(v));
    }
  }
}

template <typename T, int CH>
int launch_resident(int chunks, int grid, cudaStream_t st, const void* x, const void* scale,
                    const void* bias, int params_fp32, void* y, long long n_rows, int d,
                    float eps) {
  if constexpr (CH == 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (chunks != CH)
      return launch_resident<T, CH - 1>(chunks, grid, st, x, scale, bias, params_fp32, y,
                                        n_rows, d, eps);
    ln_resident<T, CH><<<grid, THREADS, 0, st>>>((const T*)x, scale, bias, params_fp32, (T*)y,
                                                 n_rows, d, eps);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch(int chunks, int grid, cudaStream_t st, const void* x, const void* scale,
           const void* bias, int params_fp32, void* y, long long n_rows, int d, float eps) {
  constexpr int W = 32 * Pack<T>::N;
  if (chunks != (d + W - 1) / W) return (int)cudaErrorInvalidValue;
  if (d > MAX_RESIDENT_D) {
    ln_streamed<T><<<grid, THREADS, 0, st>>>((const T*)x, scale, bias, params_fp32, (T*)y,
                                             n_rows, d, eps);
    return (int)cudaGetLastError();
  }
  return launch_resident<T, MAX_RESIDENT_D / W>(chunks, grid, st, x, scale, bias, params_fp32,
                                                y, n_rows, d, eps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y); params_fp32: scale and bias
// are float32 (1) or x's dtype (0). x and y are contiguous [n_rows, d],
// 16-byte aligned, d % 128 == 0. chunks = ceil(d / (32 * 16 bytes / the
// element size)) and grid come from ops/layer_norm.py::launch_plan.
extern "C" int twt_layer_norm(int dtype, int params_fp32, const void* x, const void* scale,
                              const void* bias, void* y, long long n_rows, int d, float eps,
                              int chunks, int grid, void* stream) {
  if (d % 128 != 0 || n_rows < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(chunks, grid, st, x, scale, bias, params_fp32, y, n_rows, d,
                                 eps);
  if (dtype == 0)
    return launch<float>(chunks, grid, st, x, scale, bias, params_fp32, y, n_rows, d, eps);
  return (int)cudaErrorInvalidValue;
}
