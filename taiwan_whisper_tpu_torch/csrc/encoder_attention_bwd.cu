// Encoder self-attention backward (non-causal MHA) for Hopper (sm_90a).
//
// Replaces the backward of the TPU kernel taiwan_whisper_tpu/ops/
// attention.py::encoder_attention_flash (jax's TPU flash kernel and its
// custom VJP), which the unfrozen-encoder fine-tuning path differentiates.
// Given q, k, v, the forward's output O, its per-row log-sum-exp LSE
// (encoder_attention.cu) and dO, all [B, S, H, 64] read through their
// strides (LSE fp32 [B, H, S]), it writes dq, dk, dv:
//
//   D  = rowsum(dO * O)                      (fp32, one warp per row)
//   P  = exp(q k^T * scale - LSE)            (recomputed per tile)
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - D)
//   dK = dS^T q * scale,   dQ = dS k * scale
//
// Bound: operations. 5 products of 2*S^2*64 flop per (b, h) (S, P V's
// twin dP, and one each for dV, dK, dQ; the dK/dV kernel and the dQ
// kernel each recompute S): 10*S^2*64*2 flop counted as the work, against
// ~8 tensors of B*S*H*64 bf16, far above the card's flop-per-byte ridge.
//
// Design (FlashAttention-2's backward, deterministic): no atomics. The dK/dV
// kernel runs one block per (b, h, 64-key tile), four warps of 16 keys;
// k and v fragments stay in registers, q and dO tiles of 64 rows stream
// through shared memory in both layouts (row-major for the products that
// reduce over d, transposed for those that reduce over queries), and
// dK/dV accumulate in registers. The dQ kernel runs one block per (b, h,
// 64-query tile) the same way with k and v streaming. Products are
// mma.sync.m16n8k16 bf16 with fp32 accumulation; P and dS are rounded to
// bf16 as mma operands. The ragged tile (1500 = 23*64 + 28) is masked in
// registers: keys past S give P = 0 in the dQ kernel and their dK/dV rows
// are not written; queries past S give P = 0 in the dK/dV kernel. So the
// backward is three launches (D, dK/dV, dQ).
//
// fp32 variant: plain SIMT loops (one thread per key row, one per query
// row) so the fp32 policy differentiates on the card too; it serves parity
// checks, not speed.

#include <cuda_runtime.h>
#include <math.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 64;        // head dim
constexpr int BT = 64;       // rows (keys or queries) per block, 4 warps x 16
constexpr int LDS = BT + 8;  // padded shared row (bf16)
constexpr float LOG2E = 1.4426950408889634f;

struct Strides { long long b, s, h; };

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments (m16 x k16, 4 steps over d) of 16 rows starting at row r0:
// rows g and g + 8 of this warp, zero past S.
__device__ __forceinline__ void load_a_frags(uint32_t a[4][4], const __nv_bfloat16* base,
                                             long long stride, int r0, int r1, int S, int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t4;
    a[kk][0] = r0 < S ? ld32(base + r0 * stride + c) : 0u;
    a[kk][1] = r1 < S ? ld32(base + r1 * stride + c) : 0u;
    a[kk][2] = r0 < S ? ld32(base + r0 * stride + c + 8) : 0u;
    a[kk][3] = r1 < S ? ld32(base + r1 * stride + c + 8) : 0u;
  }
}

// Stage a 64-row tile of a [S, 64] head slice into shared memory, row-major
// (rows x d) and, when `trans` is given, transposed (d x rows); zero past S.
__device__ __forceinline__ void stage_tile(__nv_bfloat16 (*rows)[LDS], __nv_bfloat16 (*trans)[LDS],
                                           const __nv_bfloat16* base, long long stride,
                                           int row0, int S) {
  for (int i = threadIdx.x; i < BT * D / 8; i += blockDim.x) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) val = *reinterpret_cast<const uint4*>(base + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(&rows[r][c]) = val;
    if (trans != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) trans[c + j][r] = e[j];
    }
  }
}

// D[(b*H + h)*S + s] = sum_d dO * O in fp32; one warp per row.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_rowdot(const T* __restrict__ o, Strides os, const T* __restrict__ dout, Strides ds,
           float* __restrict__ Dout, int S, int H, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int s = (int)(row % S);
  const long long bh = row / S;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const T* op = o + b * os.b + h * os.h + s * os.s;
  const T* dp = dout + b * ds.b + h * ds.h + s * ds.s;
  float acc = to_f(op[lane]) * to_f(dp[lane]) + to_f(op[lane + 32]) * to_f(dp[lane + 32]);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) Dout[row] = acc;
}

__global__ void __launch_bounds__(128)
bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q, Strides qs,
              const __nv_bfloat16* __restrict__ k, Strides ks,
              const __nv_bfloat16* __restrict__ v, Strides vs,
              const __nv_bfloat16* __restrict__ dout, Strides dos,
              const float* __restrict__ lse, const float* __restrict__ Drow,
              __nv_bfloat16* __restrict__ dk, Strides dks,
              __nv_bfloat16* __restrict__ dv, Strides dvs,
              int S, int H, float scale_log2, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Qs[BT][LDS];   // [query][d]
  __shared__ __align__(16) __nv_bfloat16 Qt[D][LDS];    // [d][query]
  __shared__ __align__(16) __nv_bfloat16 dOs[BT][LDS];  // [query][d]
  __shared__ __align__(16) __nv_bfloat16 dOt[D][LDS];   // [d][query]
  __shared__ float Ls[BT], Ds[BT];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.x * BT + warp * 16 + g, c1 = c0 + 8;  // this thread's key rows

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* dob = dout + b * dos.b + h * dos.h;
  const float* lb = lse + (long long)blockIdx.y * S;
  const float* db = Drow + (long long)blockIdx.y * S;

  uint32_t ka[4][4], va[4][4];
  load_a_frags(ka, k + b * ks.b + h * ks.h, ks.s, c0, c1, S, t4);
  load_a_frags(va, v + b * vs.b + h * vs.h, vs.s, c0, c1, S, t4);

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[n][j] = dva[n][j] = 0.f;

  const int n_tiles = (S + BT - 1) / BT;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();
    stage_tile(Qs, Qt, qb, qs.s, q0, S);
    stage_tile(dOs, dOt, dob, dos.s, q0, S);
    for (int i = threadIdx.x; i < BT; i += blockDim.x) {
      const bool ok = q0 + i < S;
      Ls[i] = ok ? lb[q0 + i] * LOG2E : INFINITY;  // +inf: P = 0 past S
      Ds[i] = ok ? db[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T for this warp's 16 keys x 64 queries, then P^T
    float p[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mma_bf16(p[n], ka[kk], ld32(&Qs[n * 8 + g][kk * 16 + 2 * t4]),
                 ld32(&Qs[n * 8 + g][kk * 16 + 8 + 2 * t4]));
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float L = Ls[n * 8 + 2 * t4 + j];
        p[n][j] = exp2f(p[n][j] * scale_log2 - L);
        p[n][2 + j] = exp2f(p[n][2 + j] * scale_log2 - L);
      }

    // dV += P^T dO (k = query: dO read transposed)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mma_bf16(dva[n], pa, ld32(&dOt[n * 8 + g][kk * 16 + 2 * t4]),
                 ld32(&dOt[n * 8 + g][kk * 16 + 8 + 2 * t4]));
    }

    // dP^T = V dO^T, then dS^T = P^T (dP^T - D)
    float ds[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mma_bf16(ds[n], va[kk], ld32(&dOs[n * 8 + g][kk * 16 + 2 * t4]),
                 ld32(&dOs[n * 8 + g][kk * 16 + 8 + 2 * t4]));
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float Dq = Ds[n * 8 + 2 * t4 + j];
        ds[n][j] = p[n][j] * (ds[n][j] - Dq);
        ds[n][2 + j] = p[n][2 + j] * (ds[n][2 + j] - Dq);
      }

    // dK += dS^T Q (k = query: q read transposed)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t sa[4] = {pack_bf16(ds[2 * kk][0], ds[2 * kk][1]),
                              pack_bf16(ds[2 * kk][2], ds[2 * kk][3]),
                              pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
                              pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mma_bf16(dka[n], sa, ld32(&Qt[n * 8 + g][kk * 16 + 2 * t4]),
                 ld32(&Qt[n * 8 + g][kk * 16 + 8 + 2 * t4]));
    }
  }

  __nv_bfloat16* dkb = dk + b * dks.b + h * dks.h;
  __nv_bfloat16* dvb = dv + b * dvs.b + h * dvs.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (c0 < S) {
      *reinterpret_cast<uint32_t*>(dkb + c0 * dks.s + c) = pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + c0 * dvs.s + c) = pack_bf16(dva[n][0], dva[n][1]);
    }
    if (c1 < S) {
      *reinterpret_cast<uint32_t*>(dkb + c1 * dks.s + c) = pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + c1 * dvs.s + c) = pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

__global__ void __launch_bounds__(128)
bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, Strides qs,
            const __nv_bfloat16* __restrict__ k, Strides ks,
            const __nv_bfloat16* __restrict__ v, Strides vs,
            const __nv_bfloat16* __restrict__ dout, Strides dos,
            const float* __restrict__ lse, const float* __restrict__ Drow,
            __nv_bfloat16* __restrict__ dq, Strides dqs,
            int S, int H, float scale_log2, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BT][LDS];  // [key][d]
  __shared__ __align__(16) __nv_bfloat16 Kt[D][LDS];   // [d][key]
  __shared__ __align__(16) __nv_bfloat16 Vs[BT][LDS];  // [key][d]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = blockIdx.x * BT + warp * 16 + g, r1 = r0 + 8;  // this thread's query rows

  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const float* lb = lse + (long long)blockIdx.y * S;
  const float* db = Drow + (long long)blockIdx.y * S;

  uint32_t qa[4][4], da[4][4];
  load_a_frags(qa, q + b * qs.b + h * qs.h, qs.s, r0, r1, S, t4);
  load_a_frags(da, dout + b * dos.b + h * dos.h, dos.s, r0, r1, S, t4);
  // rows past S have q = dO = 0, so dS = 0 there whatever L and D are
  const float L0 = r0 < S ? lb[r0] * LOG2E : 0.f, L1 = r1 < S ? lb[r1] * LOG2E : 0.f;
  const float D0 = r0 < S ? db[r0] : 0.f, D1 = r1 < S ? db[r1] : 0.f;

  float dqa[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  const int n_tiles = (S + BT - 1) / BT;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    stage_tile(Ks, Kt, kb, ks.s, k0, S);
    stage_tile(Vs, nullptr, vb, vs.s, k0, S);
    __syncthreads();

    // S = Q K^T for this warp's 16 queries x 64 keys, then P (keys past S: 0)
    float p[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mma_bf16(p[n], qa[kk], ld32(&Ks[n * 8 + g][kk * 16 + 2 * t4]),
                 ld32(&Ks[n * 8 + g][kk * 16 + 8 + 2 * t4]));
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k0 + n * 8 + 2 * t4 + j < S;
        p[n][j] = ok ? exp2f(p[n][j] * scale_log2 - L0) : 0.f;
        p[n][2 + j] = ok ? exp2f(p[n][2 + j] * scale_log2 - L1) : 0.f;
      }

    // dP = dO V^T, then dS = P (dP - D)
    float ds[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mma_bf16(ds[n], da[kk], ld32(&Vs[n * 8 + g][kk * 16 + 2 * t4]),
                 ld32(&Vs[n * 8 + g][kk * 16 + 8 + 2 * t4]));
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        ds[n][j] = p[n][j] * (ds[n][j] - D0);
        ds[n][2 + j] = p[n][2 + j] * (ds[n][2 + j] - D1);
      }

    // dQ += dS K (k = key: k read transposed)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t sa[4] = {pack_bf16(ds[2 * kk][0], ds[2 * kk][1]),
                              pack_bf16(ds[2 * kk][2], ds[2 * kk][3]),
                              pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
                              pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mma_bf16(dqa[n], sa, ld32(&Kt[n * 8 + g][kk * 16 + 2 * t4]),
                 ld32(&Kt[n * 8 + g][kk * 16 + 8 + 2 * t4]));
    }
  }

  __nv_bfloat16* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(dqb + r0 * dqs.s + c) = pack_bf16(dqa[n][0] * scale, dqa[n][1] * scale);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(dqb + r1 * dqs.s + c) = pack_bf16(dqa[n][2] * scale, dqa[n][3] * scale);
  }
}

constexpr int F_ROWS = 64;  // fp32 variants: rows (threads) per block
constexpr int F_TILE = 16;  // rows of the streamed operand per shared tile

// fp32 dK/dV: one thread per key row; its k and v rows sit in padded
// shared rows (conflict-free), q and dO stream in tiles of 16 rows.
__global__ void __launch_bounds__(F_ROWS)
bwd_dkdv_f32(const float* __restrict__ q, Strides qs, const float* __restrict__ k, Strides ks,
             const float* __restrict__ v, Strides vs, const float* __restrict__ dout, Strides dos,
             const float* __restrict__ lse, const float* __restrict__ Drow,
             float* __restrict__ dk, Strides dks, float* __restrict__ dv, Strides dvs,
             int S, int H, float scale_log2, float scale) {
  __shared__ float Kp[F_ROWS][D + 1], Vp[F_ROWS][D + 1];
  __shared__ float Qs[F_TILE][D], dOs[F_TILE][D], Ls[F_TILE], Ds[F_TILE];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x;
  const int key = blockIdx.x * F_ROWS + tid;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* dob = dout + b * dos.b + h * dos.h;
  const float* lb = lse + (long long)blockIdx.y * S;
  const float* db = Drow + (long long)blockIdx.y * S;
  for (int d = 0; d < D; ++d) {
    Kp[tid][d] = key < S ? k[b * ks.b + h * ks.h + key * ks.s + d] : 0.f;
    Vp[tid][d] = key < S ? v[b * vs.b + h * vs.h + key * vs.s + d] : 0.f;
  }
  float dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;

  for (int q0 = 0; q0 < S; q0 += F_TILE) {
    __syncthreads();
    for (int i = tid; i < F_TILE * D; i += F_ROWS) {
      const int r = i / D, d = i % D;
      const bool ok = q0 + r < S;
      Qs[r][d] = ok ? qb[(q0 + r) * qs.s + d] : 0.f;
      dOs[r][d] = ok ? dob[(q0 + r) * dos.s + d] : 0.f;
    }
    if (tid < F_TILE) {
      const bool ok = q0 + tid < S;
      Ls[tid] = ok ? lb[q0 + tid] * LOG2E : INFINITY;
      Ds[tid] = ok ? db[q0 + tid] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < F_TILE; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(Qs[j][d], Kp[tid][d], s);
        dp = fmaf(dOs[j][d], Vp[tid][d], dp);
      }
      const float p = exp2f(s * scale_log2 - Ls[j]);
      const float dsv = p * (dp - Ds[j]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dva[d] = fmaf(p, dOs[j][d], dva[d]);
        dka[d] = fmaf(dsv, Qs[j][d], dka[d]);
      }
    }
  }
  if (key < S) {
    float* dkr = dk + b * dks.b + h * dks.h + key * dks.s;
    float* dvr = dv + b * dvs.b + h * dvs.h + key * dvs.s;
#pragma unroll
    for (int d = 0; d < D; ++d) { dkr[d] = dka[d] * scale; dvr[d] = dva[d]; }
  }
}

// fp32 dQ: one thread per query row; q in registers, its dO row in a padded
// shared row, k and v stream in tiles of 16 keys.
__global__ void __launch_bounds__(F_ROWS)
bwd_dq_f32(const float* __restrict__ q, Strides qs, const float* __restrict__ k, Strides ks,
           const float* __restrict__ v, Strides vs, const float* __restrict__ dout, Strides dos,
           const float* __restrict__ lse, const float* __restrict__ Drow,
           float* __restrict__ dq, Strides dqs, int S, int H, float scale_log2, float scale) {
  __shared__ float dOp[F_ROWS][D + 1];
  __shared__ float Ks[F_TILE][D], Vs[F_TILE][D];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * F_ROWS + tid;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float qr[D], dqa[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row < S ? q[b * qs.b + h * qs.h + row * qs.s + d] : 0.f;
    dOp[tid][d] = row < S ? dout[b * dos.b + h * dos.h + row * dos.s + d] : 0.f;
    dqa[d] = 0.f;
  }
  const float L = row < S ? lse[(long long)blockIdx.y * S + row] * LOG2E : 0.f;
  const float Dr = row < S ? Drow[(long long)blockIdx.y * S + row] : 0.f;

  for (int k0 = 0; k0 < S; k0 += F_TILE) {
    __syncthreads();
    for (int i = tid; i < F_TILE * D; i += F_ROWS) {
      const int r = i / D, d = i % D;
      const bool ok = k0 + r < S;
      Ks[r][d] = ok ? kb[(k0 + r) * ks.s + d] : 0.f;
      Vs[r][d] = ok ? vb[(k0 + r) * vs.s + d] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < F_TILE && k0 + j < S; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], Ks[j][d], s);
        dp = fmaf(dOp[tid][d], Vs[j][d], dp);
      }
      const float dsv = exp2f(s * scale_log2 - L) * (dp - Dr);
#pragma unroll
      for (int d = 0; d < D; ++d) dqa[d] = fmaf(dsv, Ks[j][d], dqa[d]);
    }
  }
  if (row < S) {
    float* dqr = dq + b * dqs.b + h * dqs.h + row * dqs.s;
#pragma unroll
    for (int d = 0; d < D; ++d) dqr[d] = dqa[d] * scale;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Tensors [B, S, H, 64] with strides in
// elements (head dim contiguous); lse fp32 [B, H, S] from the forward;
// Dbuf fp32 scratch of B*H*S. Launches D, dK/dV, dQ on `stream`.
extern "C" int twt_encoder_attention_bwd(
    int dtype, int B, int S, int H,
    const void* q, long long qsb, long long qss, long long qsh,
    const void* k, long long ksb, long long kss, long long ksh,
    const void* v, long long vsb, long long vss, long long vsh,
    const void* o, long long osb, long long oss, long long osh,
    const void* dout, long long dsb, long long dss, long long dsh,
    const float* lse, float* Dbuf,
    void* dq, long long dqsb, long long dqss, long long dqsh,
    void* dk, long long dksb, long long dkss, long long dksh,
    void* dv, long long dvsb, long long dvss, long long dvsh,
    float scale, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh},
      ds{dsb, dss, dsh}, dqs{dqsb, dqss, dqsh}, dks{dksb, dkss, dksh}, dvs{dvsb, dvss, dvsh};
  const float scale_log2 = scale * LOG2E;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)B * H * S;
  const dim3 rgrid((unsigned)((rows + 7) / 8));
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    bwd_rowdot<T><<<rgrid, 256, 0, st>>>((const T*)o, os, (const T*)dout, ds, Dbuf, S, H, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + BT - 1) / BT, B * H);
    bwd_dkdv_bf16<<<grid, 128, 0, st>>>((const T*)q, qs, (const T*)k, ks, (const T*)v, vs,
                                        (const T*)dout, ds, lse, Dbuf, (T*)dk, dks, (T*)dv, dvs,
                                        S, H, scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bwd_dq_bf16<<<grid, 128, 0, st>>>((const T*)q, qs, (const T*)k, ks, (const T*)v, vs,
                                      (const T*)dout, ds, lse, Dbuf, (T*)dq, dqs,
                                      S, H, scale_log2, scale);
  } else if (dtype == 0) {
    bwd_rowdot<float><<<rgrid, 256, 0, st>>>((const float*)o, os, (const float*)dout, ds, Dbuf,
                                             S, H, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + F_ROWS - 1) / F_ROWS, B * H);
    bwd_dkdv_f32<<<grid, F_ROWS, 0, st>>>((const float*)q, qs, (const float*)k, ks,
                                          (const float*)v, vs, (const float*)dout, ds, lse, Dbuf,
                                          (float*)dk, dks, (float*)dv, dvs, S, H, scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bwd_dq_f32<<<grid, F_ROWS, 0, st>>>((const float*)q, qs, (const float*)k, ks,
                                        (const float*)v, vs, (const float*)dout, ds, lse, Dbuf,
                                        (float*)dq, dqs, S, H, scale_log2, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
