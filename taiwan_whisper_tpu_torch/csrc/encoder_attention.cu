// Full-sequence attention forward for Hopper (sm_90a): the encoder's
// self-attention and the teacher-forcing decoder's causal self-attention and
// cross-attention.
//
// Replaces the TPU kernels taiwan_whisper_tpu/ops/attention.py::
// encoder_attention (_attn_kernel) and encoder_attention_flash (jax's TPU
// flash kernel, the route S=1500, Dh=64 takes): softmax(q k^T * scale) v
// with fp32 softmax statistics, over q/k/v laid out [B, S, H, Dh]. The
// decoder's entry (twt_decoder_attention) replaces no Pallas kernel: it
// replaces the einsum attention that the JAX model's
// taiwan_whisper_tpu/models/whisper.py::_attention leaves to XLA, which
// decode_train runs over the whole label sequence (448 queries, causal,
// against 448 keys; and against the encoder's 1500 positions).
//
// Bound: operations. 4*Sq*Sk*Dh flop per (b, h): 368.6 GFLOP at large-v2,
// batch 32 against ~25 MB of q/k/v/out, far above the card's
// flop-per-byte ridge, so the [Sq, Sk] scores must never reach device
// memory. A distillation step's 32 teacher layers at batch 32 need ~4.05
// TFLOP of decoder attention (cross 110 GFLOP a layer, causal self 16.4,
// the half the mask keeps). At Dh = 64 the softmax's exponentials cost the
// SM as many cycles as the products (16 exp2 per clock against 4096 bf16
// flop per clock), so the products have to run on wgmma and overlap the
// softmax of another warpgroup.
//
// Design (bf16), FlashAttention-3's forward: one block per (b, h,
// 128-query tile), 12 x B*H blocks at S = 1500 (the last tile holds 92
// rows), three warpgroups (hopper_attention.cuh):
// * a producer warp TMA-loads the q tile once and K/V tiles of 128 keys
//   into a ring of FWD_STAGES stages (128-byte swizzle, rows past Sq or Sk
//   zero-filled), each stage completed by bytes on its `full` mbarrier;
// * two consumer warpgroups of 64 query rows each compute S = q K^T as
//   wgmma m64n128k16 (both operands from shared memory, K-major), the
//   online softmax in fp32 registers in exp2 units (one FFMA and one
//   MUFU.EX2 per score; the ragged last key tile, 1500 = 11*128 + 92,
//   masked to -inf), then O += P V as wgmma m64n64k16 with P packed to
//   bf16 in registers as the A operand and V read in place through the
//   descriptor's transpose bit (no transposed copy, no bank conflicts),
//   and release the stage on its `empty` mbarrier. Tile j's q K^T is
//   issued beside tile j-1's P V, so each warpgroup's softmax overlaps its
//   own P V, and the two warpgroups take turns to issue (ping-pong on
//   named barriers), so one's softmax overlaps the other's products.
// setmaxnreg moves registers from the producer (24) to the consumers
// (240). The output and the LSE are stored from registers, rows past Sq
// skipped; the launch that writes the LSE runs the same code, so its
// output equals the no-LSE launch's bit for bit.
//
// The query and key lengths are separate (Sq, Sk), each with its ragged
// edge: decoder cross-attention is 3.5 query tiles (448) against 11.7 key
// tiles (1500). CAUSAL (a template flag; needs Sq == Sk) walks only the
// key tiles at or below a query tile's diagonal, skipping those above it
// (10 of 16 tiles at Sq 448), and masks keys past each row inside the
// diagonal tile to -inf before the running max; every row keeps key 0, so
// none is fully masked. Query tiles are taken longest walk first. The
// encoder's launches are the non-causal instantiation with Sq == Sk.
//
// fp32 variant: a plain SIMT flash loop (one thread per query row) so the
// fp32 policy runs the encoder on the card too; it serves parity checks,
// not speed, and takes neither CAUSAL nor Sq != Sk.
//
// Both encoder variants optionally write the per-row log-sum-exp of the
// scaled scores (natural log, fp32 [B, H, S]) that the backward
// (encoder_attention_bwd.cu) recomputes the probabilities from; a null
// pointer skips it (inference, the frozen encoder, the decoder).

#include <math.h>

#include "hopper_attention.cuh"

namespace {

using hopper::D;
using hopper::Strides;
constexpr float LN2 = 0.6931471805599453f;

constexpr int FWD_BQ = 128;     // query rows per block: two consumer warpgroups of 64
constexpr int FWD_BK = 128;     // keys per K/V tile
constexpr int FWD_STAGES = 4;   // K/V ring depth
constexpr int TILE_BYTES = FWD_BK * D * 2;  // one q, K or V tile: 16 KB
static_assert(FWD_BQ == FWD_BK, "the causal walk ends at the key tile of the query tile's index");

struct FwdSmem {
  __nv_bfloat16 q[FWD_BQ * D];
  __nv_bfloat16 k[FWD_STAGES][FWD_BK * D];
  __nv_bfloat16 v[FWD_STAGES][FWD_BK * D];
  uint64_t q_full, full[FWD_STAGES], empty[FWD_STAGES];
};
constexpr int FWD_SMEM = sizeof(FwdSmem) + 1024;  // + alignment of the tiles to 1024

// Online softmax of one [64 x 128] score tile in exp2 units, rows r and
// r + 8 of this thread: updates the running max m (scaled) and sum l,
// overwrites the scores with P and returns the factors the output
// accumulator is rescaled by. MASK: keys at or past Sk (the ragged last
// tile) get P = 0, and with CAUSAL also keys past the thread's rows (row,
// row + 8; the diagonal tile).
template <bool MASK, bool CAUSAL>
__device__ __forceinline__ void online_softmax(float (&sc)[64], float& m0, float& m1, float& l0,
                                               float& l1, float& al0, float& al1, int key0,
                                               int Sk, int row, float scale_log2) {
  if (MASK) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * n + e;
        if (key >= Sk || (CAUSAL && key > row)) sc[4 * n + e] = -INFINITY;
        if (key >= Sk || (CAUSAL && key > row + 8)) sc[4 * n + 2 + e] = -INFINITY;
      }
  }
  float mx0 = sc[0], mx1 = sc[2];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // the scale is positive, so the max of the raw scores scales to the max
  const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
  al0 = hopper::ex2(m0 - mn0);
  al1 = hopper::ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * n + e] = hopper::ex2(fmaf(sc[4 * n + e], scale_log2, -mn0));
      sc[4 * n + 2 + e] = hopper::ex2(fmaf(sc[4 * n + 2 + e], scale_log2, -mn1));
      s0 += sc[4 * n + e];
      s1 += sc[4 * n + 2 + e];
    }
  l0 = l0 * al0 + s0;
  l1 = l1 * al1 + s1;
}

template <bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
attn_bf16(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, Strides os,
          float* __restrict__ lse, int Sq, int Sk, int H, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(hopper::align_1024(smem_raw));
  // causal: the last query tile, with the longest walk, first
  const int q_tile = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = q_tile * FWD_BQ;
  // causal (FWD_BQ == FWD_BK, Sq == Sk): key tiles 0 .. the diagonal one
  const int n_tiles = CAUSAL ? q_tile + 1 : (Sk + FWD_BK - 1) / FWD_BK;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every TMA load
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(&sm.q_full, TILE_BYTES);
      hopper::tma_load(sm.q, &qmap, &sm.q_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % FWD_STAGES;
        hopper::mbar_wait(&sm.empty[s], ((j / FWD_STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&sm.full[s], 2 * TILE_BYTES);
        hopper::tma_load(sm.k[s], &kmap, &sm.full[s], h, j * FWD_BK, b);
        hopper::tma_load(sm.v[s], &vmap, &sm.full[s], h, j * FWD_BK, b);
      }
    }
  } else {  // consumers: 64 query rows each
    hopper::setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup 0 or 1
    const int t = threadIdx.x & 127, lane = t & 31, c2 = 2 * (lane & 3);
    const uint32_t q_addr = hopper::smem_u32(sm.q) + cw * 64 * hopper::ROW_BYTES;
    const bool masked_last = CAUSAL || Sk % FWD_BK != 0;
    const int row = q0 + cw * 64 + (t >> 5) * 16 + (lane >> 2);  // and row + 8
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows r and r + 8
    float al0, al1;
    float sc[64], oacc[32];
    uint32_t pa[8][4];  // P of the previous tile as bf16 A fragments
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[i] = 0.f;

    // S = q K^T over the 64 dims: four k16 steps of 32 bytes along the rows
    auto issue_scores = [&](int s) {
      const uint32_t k_addr = hopper::smem_u32(sm.k[s]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n128_ss(sc, hopper::desc_k_major(q_addr + 32 * kk),
                                 hopper::desc_k_major(k_addr + 32 * kk), kk > 0);
      hopper::wgmma_commit();
    };
    // O += P V: V [keys][d] read MN-major, 16 keys (2048 bytes) per k step
    auto issue_pv = [&](int s) {
      const uint32_t v_addr = hopper::smem_u32(sm.v[s]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        hopper::wgmma_m64n64_rs(oacc, pa[kk], hopper::desc_mn_major(v_addr + 2048 * kk), 1);
      hopper::wgmma_commit();
    };
    auto softmax = [&](int j) {
      if (masked_last && j == n_tiles - 1)
        online_softmax<true, CAUSAL>(sc, m0, m1, l0, l1, al0, al1, j * FWD_BK + c2, Sk, row,
                                     scale_log2);
      else
        online_softmax<false, CAUSAL>(sc, m0, m1, l0, l1, al0, al1, 0, Sk, row, scale_log2);
    };

    const hopper::PingPong turns(cw, n_tiles);
    hopper::mbar_wait(&sm.q_full, 0);
    hopper::mbar_wait(&sm.full[0], 0);
    turns.take();
    hopper::wgmma_fence();
    issue_scores(0);
    turns.pass(0);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    softmax(0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) hopper::acc_to_a(pa[kk], sc, kk);

    // Tile j's scores run on the tensor cores beside tile j-1's P V; the
    // softmax of tile j overlaps that P V.
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % FWD_STAGES, sp = (j - 1) % FWD_STAGES;
      hopper::mbar_wait(&sm.full[s], (j / FWD_STAGES) & 1);
      turns.take();
      hopper::wgmma_fence();
      issue_scores(s);
      issue_pv(sp);
      turns.pass(j);
      hopper::wgmma_wait<1>();  // the scores (groups retire in order)
      hopper::fence_regs(sc);
      softmax(j);
      hopper::wgmma_wait<0>();  // P V of tile j-1
      hopper::fence_regs(oacc);
      if (lane == 0) hopper::mbar_arrive(&sm.empty[sp]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        oacc[4 * n] *= al0;
        oacc[4 * n + 1] *= al0;
        oacc[4 * n + 2] *= al1;
        oacc[4 * n + 3] *= al1;
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) hopper::acc_to_a(pa[kk], sc, kk);
    }
    hopper::wgmma_fence();
    issue_pv((n_tiles - 1) % FWD_STAGES);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(oacc);

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (lse != nullptr && (lane & 3) == 0) {  // row max and sum are in log2 units
      float* lb = lse + (long long)blockIdx.y * Sq;
      if (row < Sq) lb[row] = (m0 + log2f(l0)) * LN2;
      if (row + 8 < Sq) lb[row + 8] = (m1 + log2f(l1)) * LN2;
    }
    hopper::store_rows(o + b * os.b + h * os.h, os.s, q0 + cw * 64, Sq, oacc, 1.f / l0,
                       1.f / l1);
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

// The bf16 kernel over q [B, Sq, H, 64] and k/v [B, Sk, H, 64] from the
// wrappers' tensor-map parameters (maps[0..2]). Each instantiation sets its
// own dynamic shared-memory limit once. Returns a cudaError_t code.
template <bool CAUSAL>
int launch_bf16(int B, int Sq, int Sk, int H, const void* q, const void* k, const void* v,
                void* o, Strides os, float* lse, const hopper::MapParams* maps,
                float scale_log2, cudaStream_t st) {
  if (maps == nullptr || (CAUSAL && Sq != Sk)) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  int err = hopper::make_map(&qm, q, maps[0], B, Sq, H, FWD_BQ);
  if (!err) err = hopper::make_map(&km, k, maps[1], B, Sk, H, FWD_BK);
  if (!err) err = hopper::make_map(&vm, v, maps[2], B, Sk, H, FWD_BK);
  static const int smem = (int)cudaFuncSetAttribute(
      attn_bf16<CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (!err) err = smem;
  if (err) return err;
  dim3 grid((Sq + FWD_BQ - 1) / FWD_BQ, B * H);
  attn_bf16<CAUSAL><<<grid, 384, FWD_SMEM, st>>>(qm, km, vm, (__nv_bfloat16*)o, os, lse, Sq, Sk,
                                                 H, scale_log2);
  return (int)cudaSuccess;
}

constexpr float LOG2E = 1.4426950408889634f;

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head dim
// is contiguous and must be 64 (bf16: strides multiples of 8 elements, base
// 16-byte aligned, as the tensor maps need). lse: fp32 [B, H, S] or null.
// maps (bf16; null for fp32): the tensor-map parameters of q, k and v,
// hopper::MapParams each.
extern "C" int twt_encoder_attention(
    int dtype, int B, int S, int H,
    const void* q, long long qsb, long long qss, long long qsh,
    const void* k, long long ksb, long long kss, long long ksh,
    const void* v, long long vsb, long long vss, long long vsh,
    void* o, long long osb, long long oss, long long osh,
    float* lse, const hopper::MapParams* maps, float scale, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    const int err = launch_bf16<false>(B, S, S, H, q, k, v, o, os, lse, maps, scale * LOG2E, st);
    if (err) return err;
  } else if (dtype == 0) {
    dim3 grid((S + F_ROWS - 1) / F_ROWS, B * H);
    enc_attn_f32<<<grid, F_ROWS, 0, st>>>(
        (const float*)q, qs, (const float*)k, ks, (const float*)v, vs,
        (float*)o, os, lse, S, H, scale * LOG2E);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The decoder's full-sequence attention, bf16 only: q [B, Sq, H, 64] and
// k/v [B, Sk, H, 64], read through their tensor maps (maps as above), out
// [B, Sq, H, 64] through its strides; causal (0 or 1) needs Sq == Sk. No
// LSE.
extern "C" int twt_decoder_attention(
    int B, int Sq, int Sk, int H, const void* q, const void* k, const void* v,
    void* o, long long osb, long long oss, long long osh,
    const hopper::MapParams* maps, float scale, int causal, void* stream) {
  const Strides os{osb, oss, osh};
  cudaStream_t st = (cudaStream_t)stream;
  const int err = causal ? launch_bf16<true>(B, Sq, Sk, H, q, k, v, o, os, nullptr, maps,
                                             scale * LOG2E, st)
                         : launch_bf16<false>(B, Sq, Sk, H, q, k, v, o, os, nullptr, maps,
                                              scale * LOG2E, st);
  if (err) return err;
  return (int)cudaGetLastError();
}
