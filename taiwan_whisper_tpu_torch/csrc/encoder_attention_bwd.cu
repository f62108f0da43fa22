// Encoder self-attention backward (non-causal MHA) for Hopper (sm_90a).
//
// Replaces the backward of the TPU kernel taiwan_whisper_tpu/ops/
// attention.py::encoder_attention_flash (jax's TPU flash kernel and its
// custom VJP), which the unfrozen-encoder fine-tuning path differentiates.
// Given q, k, v, the forward's output O, its per-row log-sum-exp LSE
// (encoder_attention.cu) and dO, all [B, S, H, 64] read through their
// strides (LSE fp32 [B, H, S]), it writes dq, dk, dv:
//
//   D  = rowsum(dO * O)                      (fp32)
//   P  = exp(q k^T * scale - LSE)            (recomputed per tile)
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - D)
//   dK = dS^T q * scale,   dQ = dS k * scale
//
// Bound: operations. The algorithm needs 5 products of 2*S^2*64 flop per
// (b, h): S, dP, dV, dK, dQ, 10*S^2*64 flop (0.233 ms of bf16 tensor-core
// time at [8, 1500, 20, 64]), against ~8 tensors of B*S*H*64 bf16, far
// above the card's flop-per-byte ridge. This design runs 7: the dK/dV
// kernel and the dQ kernel each recompute S, and the dQ kernel recomputes
// dP, so the best it can reach is 7/5 of the bound.
//
// Design (deterministic: no atomics, every gradient row written by one
// block), on the pieces of hopper_attention.cuh (TMA with 128-byte
// swizzle, an mbarrier ring, wgmma, setmaxnreg 24 / 240):
// * bwd_rowdot_bf16: D, memory-bound, 16-byte loads.
// * dK/dV kernel, one block per (b, h, 128 keys): the K and V tiles are
//   TMA-loaded once; a producer warp streams q and dO tiles of 128
//   queries (TMA) with their LSE (times log2 e; +inf past S, so P = 0
//   there) and D (0 past S) into a ring of STAGES stages. Two consumer
//   warpgroups of 64 keys each compute everything transposed, so nothing
//   in shared memory is ever transposed: S^T = K q^T and dP^T = V dO^T
//   (wgmma m64n128k16, operands K-major from shared memory), P^T = exp2(S^T *
//   scale * log2 e - LSE * log2 e), dS^T = P^T (dP^T - D), then dV += P^T
//   dO and dK += dS^T q with P^T and dS^T packed to bf16 in registers as
//   the A operand and dO, q read MN-major through the transpose bit.
// * dQ kernel, one block per (b, h, 128 queries): q and dO TMA-loaded
//   once, LSE and D read once into registers; K/V tiles of 128 keys
//   stream through the ring; S = q K^T and dP = dO V^T from shared memory
//   (wgmma m64n128k16), P
//   (keys past S masked to 0), dS = P (dP - D), dQ += dS K with dS from
//   registers and K read MN-major.
// Rows past S are zero-filled by TMA and never stored. The backward is
// three launches (D, dK/dV, dQ). The dQ kernel issues tile j's S and dP
// beside tile j-1's dQ product and ping-pongs its two consumer warpgroups
// as the forward does, which made it faster; the dK/dV kernel was no
// faster that way and keeps the plain order (PERF.md).
//
// fp32 variant: plain SIMT loops (one thread per key row, one per query
// row) so the fp32 policy differentiates on the card too; it serves parity
// checks, not speed.

#include <math.h>

#include "hopper_attention.cuh"

namespace {

using hopper::D;
using hopper::Strides;
constexpr float LOG2E = 1.4426950408889634f;

// D[(b*H + h)*S + s] = sum_d dO * O in fp32. bf16: eight threads of
// 16-byte loads per row; fp32: one warp per row.
__global__ void __launch_bounds__(256)
bwd_rowdot_bf16(const __nv_bfloat16* __restrict__ o, Strides os,
                const __nv_bfloat16* __restrict__ dout, Strides ds, float* __restrict__ Dout,
                int S, int H, long long rows) {
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x / 8;
  const int part = threadIdx.x & 7;  // columns 8 part .. 8 part + 7
  float acc = 0.f;
  if (row < rows) {
    const int s = (int)(row % S);
    const long long bh = row / S;
    const int b = (int)(bh / H), h = (int)(bh % H);
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * os.b + h * os.h + s * os.s +
                                                     8 * part);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + b * ds.b + h * ds.h + s * ds.s +
                                                     8 * part);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]), c = __bfloat1622float2(d2[i]);
      acc = fmaf(a.x, c.x, fmaf(a.y, c.y, acc));
    }
  }
#pragma unroll
  for (int off = 4; off >= 1; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) Dout[row] = acc;
}

__global__ void __launch_bounds__(256)
bwd_rowdot_f32(const float* __restrict__ o, Strides os, const float* __restrict__ dout,
               Strides ds, float* __restrict__ Dout, int S, int H, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int s = (int)(row % S);
  const long long bh = row / S;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const float* op = o + b * os.b + h * os.h + s * os.s;
  const float* dp = dout + b * ds.b + h * ds.h + s * ds.s;
  float acc = op[lane] * dp[lane] + op[lane + 32] * dp[lane + 32];
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) Dout[row] = acc;
}

// Rows of every tile: a block's keys (dK/dV) or queries (dQ), two consumer
// warpgroups of 64, and each streamed tile of queries or keys.
constexpr int BT = 128;
constexpr int STAGES = 3;      // ring depth of the streamed tiles
constexpr int WG_ROWS = 64;    // rows of one consumer warpgroup
constexpr int WG_BYTES = WG_ROWS * D * 2;  // its 64 rows of a tile: 8 KB

struct KvSmem {
  __nv_bfloat16 k[BT * D], v[BT * D];
  __nv_bfloat16 q[STAGES][BT * D], dout[STAGES][BT * D];
  float lse[STAGES][BT], drow[STAGES][BT];
  uint64_t kv_full, full[STAGES], empty[STAGES];
};
constexpr int KV_SMEM = sizeof(KvSmem) + 1024;

struct DqSmem {
  __nv_bfloat16 q[BT * D], dout[BT * D];
  __nv_bfloat16 k[STAGES][BT * D], v[STAGES][BT * D];
  uint64_t q_full, full[STAGES], empty[STAGES];
};
constexpr int DQ_SMEM = sizeof(DqSmem) + 1024;

__global__ void __launch_bounds__(384, 1)
bwd_dkdv_bf16(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
              const float* __restrict__ lse, const float* __restrict__ Drow,
              __nv_bfloat16* __restrict__ dk, Strides dks,
              __nv_bfloat16* __restrict__ dv, Strides dvs,
              int S, int H, float scale_log2, float scale) {
  extern __shared__ uint8_t smem_raw[];
  KvSmem& sm = *reinterpret_cast<KvSmem*>(hopper::align_1024(smem_raw));
  const int b = blockIdx.y / H, h = blockIdx.y % H, k0 = blockIdx.x * BT;
  const int n_tiles = (S + BT - 1) / BT;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&sm.full[s], 32);  // every lane of the producer warp
      hopper::mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warp: TMA for the tiles, plain loads for LSE and D
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* lb = lse + (long long)blockIdx.y * S;
      const float* db = Drow + (long long)blockIdx.y * S;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&sm.kv_full, 2 * BT * D * 2);
        hopper::tma_load(sm.k, &kmap, &sm.kv_full, h, k0, b);
        hopper::tma_load(sm.v, &vmap, &sm.kv_full, h, k0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES, q0 = j * BT;
        hopper::mbar_wait(&sm.empty[s], ((j / STAGES) & 1) ^ 1);
        if (lane == 0) {
          hopper::mbar_expect_tx(&sm.full[s], 2 * BT * D * 2);
          hopper::tma_load(sm.q[s], &qmap, &sm.full[s], h, q0, b);
          hopper::tma_load(sm.dout[s], &dmap, &sm.full[s], h, q0, b);
        }
#pragma unroll
        for (int i = lane; i < BT; i += 32) {
          const bool ok = q0 + i < S;
          sm.lse[s][i] = ok ? lb[q0 + i] * LOG2E : INFINITY;
          sm.drow[s][i] = ok ? db[q0 + i] : 0.f;
        }
        hopper::mbar_arrive(&sm.full[s]);
      }
    }
  } else {  // consumers: 64 keys each
    hopper::setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup 0 or 1
    const int t = threadIdx.x & 127, lane = t & 31, c2 = 2 * (lane & 3);
    const uint32_t k_addr = hopper::smem_u32(sm.k) + cw * WG_BYTES;
    const uint32_t v_addr = hopper::smem_u32(sm.v) + cw * WG_BYTES;
    float dka[32], dva[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;

    hopper::mbar_wait(&sm.kv_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      hopper::mbar_wait(&sm.full[s], (j / STAGES) & 1);
      const uint32_t q_addr = hopper::smem_u32(sm.q[s]), d_addr = hopper::smem_u32(sm.dout[s]);

      // S^T = K q^T and dP^T = V dO^T: [64 keys x 128 queries] each
      float st[64], dpt[64];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n128_ss(st, hopper::desc_k_major(k_addr + 32 * kk),
                                hopper::desc_k_major(q_addr + 32 * kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n128_ss(dpt, hopper::desc_k_major(v_addr + 32 * kk),
                                hopper::desc_k_major(d_addr + 32 * kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);

      // P^T and dS^T; the query is the column: 8n + c2 + e
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const float2 L = *reinterpret_cast<const float2*>(&sm.lse[s][8 * n + c2]);
        const float2 Dq = *reinterpret_cast<const float2*>(&sm.drow[s][8 * n + c2]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * n + 2 * r;
          st[i] = hopper::ex2(fmaf(st[i], scale_log2, -L.x));
          st[i + 1] = hopper::ex2(fmaf(st[i + 1], scale_log2, -L.y));
          dpt[i] = st[i] * (dpt[i] - Dq.x);
          dpt[i + 1] = st[i + 1] * (dpt[i + 1] - Dq.y);
        }
      }

      // dV += P^T dO and dK += dS^T q: k = query, 16 queries (2048 bytes)
      // per step, dO and q read MN-major
      uint32_t pa[8][4], sa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        hopper::acc_to_a(pa[kk], st, kk);
        hopper::acc_to_a(sa[kk], dpt, kk);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        hopper::wgmma_m64n64_rs(dva, pa[kk], hopper::desc_mn_major(d_addr + 2048 * kk), 1);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        hopper::wgmma_m64n64_rs(dka, sa[kk], hopper::desc_mn_major(q_addr + 2048 * kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dva);
      hopper::fence_regs(dka);
      if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
    }
    const int row0 = k0 + cw * WG_ROWS;
    hopper::store_rows(dk + b * dks.b + h * dks.h, dks.s, row0, S, dka, scale, scale);
    hopper::store_rows(dv + b * dvs.b + h * dvs.h, dvs.s, row0, S, dva, 1.f, 1.f);
  }
}

__global__ void __launch_bounds__(384, 1)
bwd_dq_bf16(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
            const float* __restrict__ lse, const float* __restrict__ Drow,
            __nv_bfloat16* __restrict__ dq, Strides dqs,
            int S, int H, float scale_log2, float scale) {
  extern __shared__ uint8_t smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(hopper::align_1024(smem_raw));
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * BT;
  const int n_tiles = (S + BT - 1) / BT;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer: one thread issues every TMA load
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(&sm.q_full, 2 * BT * D * 2);
      hopper::tma_load(sm.q, &qmap, &sm.q_full, h, q0, b);
      hopper::tma_load(sm.dout, &dmap, &sm.q_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        hopper::mbar_wait(&sm.empty[s], ((j / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&sm.full[s], 2 * BT * D * 2);
        hopper::tma_load(sm.k[s], &kmap, &sm.full[s], h, j * BT, b);
        hopper::tma_load(sm.v[s], &vmap, &sm.full[s], h, j * BT, b);
      }
    }
  } else {  // consumers: 64 queries each
    hopper::setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup 0 or 1
    const int t = threadIdx.x & 127, lane = t & 31, c2 = 2 * (lane & 3);
    const int row0 = q0 + cw * WG_ROWS, r = row0 + (t >> 5) * 16 + (lane >> 2);
    const uint32_t q_addr = hopper::smem_u32(sm.q) + cw * WG_BYTES;
    const uint32_t d_addr = hopper::smem_u32(sm.dout) + cw * WG_BYTES;
    // rows past S have q = dO = 0 (zero fill), so dS = 0 there whatever L and D are
    const float* lb = lse + (long long)blockIdx.y * S;
    const float* db = Drow + (long long)blockIdx.y * S;
    const float L0 = r < S ? lb[r] * LOG2E : 0.f, L1 = r + 8 < S ? lb[r + 8] * LOG2E : 0.f;
    const float D0 = r < S ? db[r] : 0.f, D1 = r + 8 < S ? db[r + 8] : 0.f;
    float dqa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[i] = 0.f;

    float sc[64], dp[64];
    uint32_t sa[8][4];  // dS of the previous tile as bf16 A fragments
    // S = q K^T and dP = dO V^T: [64 queries x 128 keys] each
    auto issue_scores = [&](int s) {
      const uint32_t k_addr = hopper::smem_u32(sm.k[s]), v_addr = hopper::smem_u32(sm.v[s]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n128_ss(sc, hopper::desc_k_major(q_addr + 32 * kk),
                                hopper::desc_k_major(k_addr + 32 * kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n128_ss(dp, hopper::desc_k_major(d_addr + 32 * kk),
                                hopper::desc_k_major(v_addr + 32 * kk), kk > 0);
      hopper::wgmma_commit();
    };
    // dQ += dS K: k = key, 16 keys (2048 bytes) per step, K read MN-major
    auto issue_dq = [&](int s) {
      const uint32_t k_addr = hopper::smem_u32(sm.k[s]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        hopper::wgmma_m64n64_rs(dqa, sa[kk], hopper::desc_mn_major(k_addr + 2048 * kk), 1);
      hopper::wgmma_commit();
    };
    // dS = P (dP - D) in place of dP; keys past S (the ragged last tile) give P = 0
    auto grad_scores = [&](int j) {
      if (j * BT + BT > S) {
        const int key0 = j * BT + c2;
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (key0 + 8 * n + e >= S) sc[4 * n + e] = sc[4 * n + 2 + e] = -INFINITY;
      }
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * n + e;
          dp[i] = hopper::ex2(fmaf(sc[i], scale_log2, -L0)) * (dp[i] - D0);
          dp[i + 2] = hopper::ex2(fmaf(sc[i + 2], scale_log2, -L1)) * (dp[i + 2] - D1);
        }
    };
    auto pack_ds = [&] {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) hopper::acc_to_a(sa[kk], dp, kk);
    };

    // As in the forward: tile j's S and dP are issued beside tile j-1's dQ
    // product (so tile j's dS overlaps it), and the two consumer
    // warpgroups take turns to issue.
    const hopper::PingPong turns(cw, n_tiles);
    hopper::mbar_wait(&sm.q_full, 0);
    hopper::mbar_wait(&sm.full[0], 0);
    turns.take();
    hopper::wgmma_fence();
    issue_scores(0);
    turns.pass(0);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    grad_scores(0);
    pack_ds();
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      hopper::mbar_wait(&sm.full[s], (j / STAGES) & 1);
      turns.take();
      hopper::wgmma_fence();
      issue_scores(s);
      issue_dq(sp);
      turns.pass(j);
      hopper::wgmma_wait<1>();  // S and dP (groups retire in order)
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      grad_scores(j);
      hopper::wgmma_wait<0>();  // dQ of tile j-1, which reads the A fragments
      hopper::fence_regs(dqa);
      if (lane == 0) hopper::mbar_arrive(&sm.empty[sp]);
      pack_ds();
    }
    hopper::wgmma_fence();
    issue_dq((n_tiles - 1) % STAGES);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dqa);
    hopper::store_rows(dq + b * dqs.b + h * dqs.h, dqs.s, row0, S, dqa, scale, scale);
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
// elements (head dim contiguous; bf16: strides multiples of 8 elements,
// bases 16-byte aligned, as the tensor maps need); lse fp32 [B, H, S] from
// the forward; Dbuf fp32 scratch of B*H*S; maps (bf16; null for fp32): the
// tensor-map parameters of q, k, v and dout, hopper::MapParams each.
// Launches D, dK/dV, dQ on `stream`.
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
    const hopper::MapParams* maps, float scale, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh},
      ds{dsb, dss, dsh}, dqs{dqsb, dqss, dqsh}, dks{dksb, dkss, dksh}, dvs{dvsb, dvss, dvsh};
  const float scale_log2 = scale * LOG2E;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)B * H * S;
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    // one map each for q, dO, K and V: every tile either kernel loads or
    // streams is BT rows
    if (maps == nullptr) return (int)cudaErrorInvalidValue;
    CUtensorMap qm, dm, km, vm;
    int err = hopper::make_map(&qm, q, maps[0], B, S, H, BT);
    if (!err) err = hopper::make_map(&km, k, maps[1], B, S, H, BT);
    if (!err) err = hopper::make_map(&vm, v, maps[2], B, S, H, BT);
    if (!err) err = hopper::make_map(&dm, dout, maps[3], B, S, H, BT);
    static const int kv_smem = (int)cudaFuncSetAttribute(
        bwd_dkdv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM);
    static const int dq_smem = (int)cudaFuncSetAttribute(
        bwd_dq_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
    if (!err) err = kv_smem ? kv_smem : dq_smem;
    if (err) return err;
    bwd_rowdot_bf16<<<(unsigned)((rows + 31) / 32), 256, 0, st>>>(
        (const T*)o, os, (const T*)dout, ds, Dbuf, S, H, rows);
    err = (int)cudaGetLastError();
    if (err) return err;
    bwd_dkdv_bf16<<<dim3((S + BT - 1) / BT, B * H), 384, KV_SMEM, st>>>(
        qm, km, vm, dm, lse, Dbuf, (T*)dk, dks, (T*)dv, dvs, S, H, scale_log2, scale);
    err = (int)cudaGetLastError();
    if (err) return err;
    bwd_dq_bf16<<<dim3((S + BT - 1) / BT, B * H), 384, DQ_SMEM, st>>>(
        qm, km, vm, dm, lse, Dbuf, (T*)dq, dqs, S, H, scale_log2, scale);
  } else if (dtype == 0) {
    bwd_rowdot_f32<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
        (const float*)o, os, (const float*)dout, ds, Dbuf, S, H, rows);
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
