// Encoder self-attention forward (non-causal MHA) for Hopper (sm_90a).
//
// Replaces the TPU kernels taiwan_whisper_tpu/ops/attention.py::
// encoder_attention (_attn_kernel) and encoder_attention_flash (jax's TPU
// flash kernel, the route S=1500, Dh=64 takes): softmax(q k^T * scale) v
// with fp32 softmax statistics, over q/k/v laid out [B, S, H, Dh].
//
// Bound: operations. 4*S^2*Dh flop per (b, h): 368.6 GFLOP at large-v2,
// batch 32 against ~25 MB of q/k/v/out, far above the card's
// flop-per-byte ridge, so the [S, S] scores must never reach device memory.
//
// Design (bf16): a flash-attention forward. One block per (b, h, 64-query
// tile), four warps of 16 query rows. q fragments stay in registers; K and V
// tiles of 64 keys stream through shared memory (V stored transposed so the
// PV operand is read as packed pairs); Q K^T and P V run on the tensor
// cores as mma.sync.m16n8k16 bf16 with fp32 accumulation; the running row
// max and row sum live in registers (the TPU kernel's ones-column trick for
// the denominator has no use here). The ragged last key tile (1500 = 23*64
// + 28) is masked in the kernel; tensors are read and written through the
// strides given, with no padding copy. wgmma/TMA pipelining is later work.
//
// fp32 variant: a plain SIMT flash loop (one thread per query row) so the
// fp32 policy runs on the card too; it serves parity checks, not speed.
//
// Both variants optionally write the per-row log-sum-exp of the scaled
// scores (natural log, fp32 [B, H, S]) that the backward
// (encoder_attention_bwd.cu) recomputes the probabilities from; a null
// pointer skips it (inference and the frozen encoder).

#include <cuda_runtime.h>
#include <math.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // query rows per block (4 warps x 16)
constexpr int BK = 64;       // keys per tile
constexpr int LDS = BK + 8;  // padded shared row (bf16), conflict-free fragment reads
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Strides { long long b, s, h; };

__global__ void __launch_bounds__(128)
enc_attn_bf16(const __nv_bfloat16* __restrict__ q, Strides qs,
              const __nv_bfloat16* __restrict__ k, Strides ks,
              const __nv_bfloat16* __restrict__ v, Strides vs,
              __nv_bfloat16* __restrict__ o, Strides os, float* __restrict__ lse,
              int S, int H, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BK][LDS];
  __shared__ __align__(16) __nv_bfloat16 Vt[D][LDS];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = blockIdx.x * BQ + warp * 16 + g, r1 = r0 + 8;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  // A fragments of q for the four 16-wide d steps
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t4;
    qa[kk][0] = r0 < S ? *reinterpret_cast<const uint32_t*>(qb + r0 * qs.s + c) : 0u;
    qa[kk][1] = r1 < S ? *reinterpret_cast<const uint32_t*>(qb + r1 * qs.s + c) : 0u;
    qa[kk][2] = r0 < S ? *reinterpret_cast<const uint32_t*>(qb + r0 * qs.s + c + 8) : 0u;
    qa[kk][3] = r1 < S ? *reinterpret_cast<const uint32_t*>(qb + r1 * qs.s + c + 8) : 0u;
  }

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float oacc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;

  const int n_tiles = (S + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * D / 8; i += blockDim.x) {
      const int key = i / (D / 8), c = (i % (D / 8)) * 8;
      const int kk = kt * BK + key;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (kk < S) {
        kv = *reinterpret_cast<const uint4*>(kb + kk * ks.s + c);
        vv = *reinterpret_cast<const uint4*>(vb + kk * vs.s + c);
      }
      *reinterpret_cast<uint4*>(&Ks[key][c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[c + j][key] = ve[j];
    }
    __syncthreads();

    // scores for rows r0/r1 against the 64 keys of this tile
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Ks[n * 8 + g][kk * 16 + 2 * t4]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Ks[n * 8 + g][kk * 16 + 8 + 2 * t4]);
        mma_bf16(s[n], qa[kk], b0, b1);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int key = kt * BK + n * 8 + 2 * t4;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = key + j < S;
        s[n][j] = ok ? s[n][j] * scale_log2 : -INFINITY;
        s[n][2 + j] = ok ? s[n][2 + j] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[n][j]);
        mx1 = fmaxf(mx1, s[n][2 + j]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0; m1 = mn1;
    l0 *= al0; l1 *= al1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      oacc[n][0] *= al0; oacc[n][1] *= al0; oacc[n][2] *= al1; oacc[n][3] *= al1;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[n][j] = exp2f(s[n][j] - mn0);
        s[n][2 + j] = exp2f(s[n][2 + j] - mn1);
        l0 += s[n][j];
        l1 += s[n][2 + j];
      }
    }

    // O += P V, P re-packed from the score accumulators as A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Vt[n * 8 + g][kk * 16 + 2 * t4]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Vt[n * 8 + g][kk * 16 + 8 + 2 * t4]);
        mma_bf16(oacc[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (lse != nullptr && t4 == 0) {  // row max and sum are in log2 units
    float* lb = lse + (long long)blockIdx.y * S;
    if (r0 < S) lb[r0] = (m0 + log2f(l0)) * LN2;
    if (r1 < S) lb[r1] = (m1 + log2f(l1)) * LN2;
  }
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * os.s + c) = pack_bf16(oacc[n][0] / l0, oacc[n][1] / l0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * os.s + c) = pack_bf16(oacc[n][2] / l1, oacc[n][3] / l1);
  }
}

constexpr int F_ROWS = 128;  // fp32 variant: query rows (threads) per block
constexpr int F_KEYS = 32;   // keys per shared tile

__global__ void __launch_bounds__(F_ROWS)
enc_attn_f32(const float* __restrict__ q, Strides qs,
             const float* __restrict__ k, Strides ks,
             const float* __restrict__ v, Strides vs,
             float* __restrict__ o, Strides os, float* __restrict__ lse,
             int S, int H, float scale_log2) {
  __shared__ float Kt[F_KEYS][D];
  __shared__ float Vs[F_KEYS][D];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int row = blockIdx.x * F_ROWS + threadIdx.x;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) { qr[d] = row < S ? qb[row * qs.s + d] : 0.f; acc[d] = 0.f; }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < S; k0 += F_KEYS) {
    __syncthreads();
    for (int i = threadIdx.x; i < F_KEYS * D; i += F_ROWS) {
      const int key = i / D, d = i % D;
      const bool ok = k0 + key < S;
      Kt[key][d] = ok ? kb[(k0 + key) * ks.s + d] : 0.f;
      Vs[key][d] = ok ? vb[(k0 + key) * vs.s + d] : 0.f;
    }
    __syncthreads();
    float sc[F_KEYS];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < F_KEYS; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], Kt[j][d], dot);
      sc[j] = (k0 + j < S) ? dot * scale_log2 : -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    const float mn = fmaxf(m, mx), al = exp2f(m - mn);
    m = mn;
    l *= al;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= al;
#pragma unroll
    for (int j = 0; j < F_KEYS; ++j) {
      const float p = exp2f(sc[j] - mn);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[j][d], acc[d]);
    }
  }
  if (row < S) {
    float* ob = o + b * os.b + h * os.h + row * os.s;
#pragma unroll
    for (int d = 0; d < D; ++d) ob[d] = acc[d] / l;
    if (lse != nullptr) lse[(long long)blockIdx.y * S + row] = (m + log2f(l)) * LN2;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head dim
// is contiguous and must be 64. lse: fp32 [B, H, S] or null.
extern "C" int twt_encoder_attention(
    int dtype, int B, int S, int H,
    const void* q, long long qsb, long long qss, long long qsh,
    const void* k, long long ksb, long long kss, long long ksh,
    const void* v, long long vsb, long long vss, long long vsh,
    void* o, long long osb, long long oss, long long osh,
    float* lse, float scale, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    dim3 grid((S + BQ - 1) / BQ, B * H);
    enc_attn_bf16<<<grid, 128, 0, st>>>(
        (const __nv_bfloat16*)q, qs, (const __nv_bfloat16*)k, ks,
        (const __nv_bfloat16*)v, vs, (__nv_bfloat16*)o, os, lse, S, H, scale_log2);
  } else if (dtype == 0) {
    dim3 grid((S + F_ROWS - 1) / F_ROWS, B * H);
    enc_attn_f32<<<grid, F_ROWS, 0, st>>>(
        (const float*)q, qs, (const float*)k, ks, (const float*)v, vs,
        (float*)o, os, lse, S, H, scale_log2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
