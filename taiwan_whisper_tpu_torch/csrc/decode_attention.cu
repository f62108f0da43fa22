// Decode-step attention kernels for Hopper (sm_90a).
//
// Replace the TPU kernels taiwan_whisper_tpu/ops/decode_attention.py::
// cross_decode_attention (_cross_kernel) and self_decode_attention
// (_self_kernel), with the numerics of the JAX model's own path
// (models/whisper.py::_cross_attention / _cached_self_attn): fp32 scores
// and softmax, probabilities normalised and then rounded to the compute
// dtype, fp32 P V accumulation, fp32 output.
//
// Bound: bytes. Each step streams the whole cross K/V of every layer
// (large-v2, batch 32, fp8: 122.9 MB per layer, 36.7 us at 3.35 TB/s) for 4
// flop per element; the self cache adds up to 31.9 MB per layer at 195
// positions.
//
// Design: both kernels are one template, `attend`. K/V are time-minor
// ([Dh, T] per (b, h), the JAX package's layout) in storage whose rows start
// on 16 bytes (the model pads the last axis to 128 bytes; the C entries
// reject other strides). One (b, h) is a thread-block cluster of C CTAs; CTA
// c owns positions [c * span, (c + 1) * span) (C and span from
// ops/decode_attention.py::decode_split; the label path's cross split is
// C = 2, its self split C = 1). Each CTA (8 warps for cross, 4 for self)
//  1. copies its span of K and V into shared memory in 16-byte asynchronous
//     copies (cp.async). Cross issues K and V before any compute, in two
//     commit groups, so V streams in while the scores and the softmax run.
//     Self stages V into K's tile once the scores are read: one tile per
//     CTA lets all 640 CTAs of a large-v2 batch-32 step be resident at
//     once, which beat two tiles in 1.2-1.4 waves (PERF.md). One bulk copy
//     per row was slower still: ~2500 small copies per SM per call, and the
//     copy engine's issue rate set the time;
//  2. computes the scores of its tile of 1-8 query rows: a thread takes 4 positions
//     of one quarter of the 64 d rows, dequantizing int8 / fp8 in
//     registers, and the four quarters meet in 3 shuffles. Each thread keeps
//     a running (max, sum of exponentials) of its positions;
//  3. reduces (max, sum) over the warps and then over the cluster through
//     distributed shared memory, in rank order, in one exchange, so every
//     CTA normalises P by the same row max and sum and rounds it as one
//     block over all T would;
//  4. takes P V with each warp on 8 d rows at a time and lanes along t,
//     reduces the 8 rows over the lanes in 9 shuffles and writes the
//     partial into CTA 0's shared memory, where CTA 0 adds the C partials in
//     rank order and writes the fp32 output.
// Cross attention takes any number of query rows R (prefill of a long prompt,
// beams folded into the query axis): the rows are cut into tiles of 8 on the
// grid's y axis, and each tile is a cluster of its own that stages the span
// again. On int8 or fp8 storage one layer's K/V at batch 8 (30.7 MB at
// large-v2) fits in the 50 MB L2, so the tiles after the first mostly read
// L2; bf16 storage (61.4 MB) does not, and each tile re-streams it from HBM.
// A tile computes its rows exactly as a
// call with those rows alone would: each row's scores, statistics and P V
// are taken on their own, in the same order, whatever the tile's other rows.
// Calls of up to 8 rows run one tile, as before.
// No atomics: the result is deterministic. The self kernel reads positions
// valid_from <= t < index and folds the current token's logit and value in
// through the same max and sum (every CTA adds the logit after the cluster
// exchange; CTA 0 adds the value). The fp32-q variants share the design.
// A cluster of one CTA launches without the cluster attribute and syncs as
// a plain block.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper_attention.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int D = 64;
// threads per CTA: 8 warps for cross attention, 4 for the self kernel,
// whose CTAs are many and short (PERF.md, the decode-attention variant A/B)
__host__ __device__ constexpr int threads_of(bool self) { return self ? 128 : 256; }
// the self kernel stages V into K's tile once the scores are taken (step 1)
__host__ __device__ constexpr bool one_tile(bool self) { return self; }
constexpr int MAX_ROWS = 8;        // query rows per tile
constexpr int MAX_TILES = 448;     // tiles per call: up to 8 x 448 query rows
constexpr int SPAN_ALIGN = 16;     // positions: 16 bytes of fp8, 32 of bf16, 64 of fp32
constexpr int MAX_SMEM = 232448;   // the 227 KB one block may take on an H100
constexpr int QSTRIDE = D + 8;     // floats per staged q row (see q_at)
constexpr int MAX_DEVICES = 64;    // devices whose kernel attributes are cached

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// probabilities are rounded to the compute dtype (the dtype of q), as the
// JAX model casts its softmax output before the P V product
template <typename TQ> __device__ __forceinline__ float round_as(float p) { return p; }
template <> __device__ __forceinline__ float round_as<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

// A staged [D, span] tile: rows of span_b bytes, each block of 16 rows 32
// bytes further on, so the four row quarters a score load touches lie in
// four different bank octets whatever span_b is.
__host__ __device__ constexpr int row_off(int d, int span_b) { return d * span_b + 32 * (d >> 4); }
__host__ __device__ constexpr int tile_bytes(int span_b) { return D * span_b + 32 * (D / 16 - 1); }

// q row d of the staged q: the quarters (16 d each) 8 floats apart mod 32
// banks, so the four q values a score step reads never share a bank
__device__ __forceinline__ int q_at(int d) { return d + 8 * (d >> 5); }

// four consecutive positions of one shared-memory row, as fp32
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&f)[4]) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = (float)(int8_t)(x >> (8 * j));
}
__device__ __forceinline__ void load4(const __nv_fp8_e4m3* p, float (&f)[4]) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
  __nv_fp8x2_e4m3 lo, hi;  // the lower byte is the first position (.x)
  lo.__x = (__nv_fp8x2_storage_t)(x & 0xffffu);
  hi.__x = (__nv_fp8x2_storage_t)(x >> 16);
  const float2 a = static_cast<float2>(lo), b = static_cast<float2>(hi);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

__device__ __forceinline__ float shfl(float x, int off) {
  return __shfl_xor_sync(0xffffffffu, x, off);
}

// The four lanes 4g..4g+3 each hold partial scores of positions 4g..4g+3
// over one quarter of d; lane 4g + j returns the full score of position j.
__device__ __forceinline__ float reduce4(const float (&s)[4], int quarter) {
  const bool h2 = quarter & 2, h1 = quarter & 1;
  float k0 = h2 ? s[2] : s[0], k1 = h2 ? s[3] : s[1];
  k0 += shfl(h2 ? s[0] : s[2], 2);
  k1 += shfl(h2 ? s[1] : s[3], 2);
  return (h1 ? k1 : k0) + shfl(h1 ? k0 : k1, 1);
}

// Every lane holds partials of 8 rows; returns the warp's sum of row
// ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1).
__device__ __forceinline__ float reduce_rows8(float (&v)[8], int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = h16 ? v[i + 4] : v[i], send = h16 ? v[i] : v[i + 4];
    v[i] = keep + shfl(send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = h8 ? v[i + 2] : v[i], send = h8 ? v[i] : v[i + 2];
    v[i] = keep + shfl(send, 8);
  }
  float x = (h4 ? v[1] : v[0]) + shfl(h4 ? v[0] : v[1], 4);
  x += shfl(x, 2);
  return x + shfl(x, 1);
}

// softmax statistics: (m, l) = (max, sum of exp(x - m)); empty: (-inf, 0)
__device__ __forceinline__ void stat_add(float& m, float& l, float x) {
  if (x > m) {
    l = l * expf(m - x) + 1.f;
    m = x;
  } else {
    l += expf(x - m);
  }
}

__device__ __forceinline__ void stat_merge(float& m, float& l, float m2, float l2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;
  l = l * expf(m - mm) + l2 * expf(m2 - mm);
  m = mm;
}

// 16 bytes from global memory into shared memory, both 16-byte aligned,
// completing with this thread's next commit group
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(hopper::smem_u32(dst)), "l"((uint64_t)__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most `N` of this thread's commit groups are in flight
template <int N> __device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the [D, nch 16-byte chunks] tile of rows `g` (row stride `sd` elements)
// into the staged tile at `s`: thread i copies chunks i, i + NT, ...
template <int NT, typename TKV>
__device__ __forceinline__ void stage(uint8_t* s, const TKV* g, long long sd, int span_b,
                                      int nch) {
  for (int i = threadIdx.x; i < D * nch; i += NT) {
    const int d = i / nch, c = i - d * nch;
    copy16(s + row_off(d, span_b) + 16 * c, reinterpret_cast<const uint8_t*>(g + d * sd) + 16 * c);
  }
  copy_commit();
}

struct Args {
  const void* q; long long qsb, qsr, qsh;  // [B, R, H, D] pre-scaled, d contiguous
  const void* k; long long ksb, ksh, ksd;  // [B, H, D, T] time-minor, t contiguous
  const void* v; long long vsb, vsh, vsd;
  float* o; long long osb, osr, osh;       // fp32 [B, R, H, D]; cross: R rows in tiles of ROWS
  const void* kt; long long ktsb, ktsh;    // self: the current token's k, v [B, H, D]
  const void* vt; long long vtsb, vtsh;
  const int* valid_from;                   // self: first valid position per b; null: 0
  int H, R, hi, span, cluster;             // positions [lo, hi); C CTAs of `span` each
};

// Shared memory of one CTA: the K and V tiles (one tile for both when
// `one_tile`), the scores / probabilities [ROWS, span], q [ROWS, QSTRIDE],
// the partial outputs of every rank [C, ROWS, D] (filled in rank 0), and
// the statistics slots.
__host__ __device__ constexpr size_t smem_bytes(bool self, int span, int elem, int rows,
                                                int cluster) {
  return (one_tile(self) ? 1 : 2) * (size_t)tile_bytes(span * elem) +
         4 * ((size_t)rows * span + (size_t)rows * QSTRIDE + (size_t)cluster * rows * D +
              (size_t)threads_of(self) / 32 * rows * 2 + 4 * rows + 4);
}

template <typename TQ, typename TKV, int ROWS, bool SELF>
__global__ void __launch_bounds__(threads_of(SELF)) attend(const Args a) {
  constexpr int NT = threads_of(SELF), NW = NT / 32;
  constexpr int E = sizeof(TKV);
  constexpr int VEC = 16 / E;  // positions in 16 bytes
  const int C = a.cluster;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int bh = blockIdx.x / C, b = bh / a.H, h = bh % a.H;
  const int row0 = SELF ? 0 : (int)blockIdx.y * ROWS;  // this tile's first query row
  const int R = SELF ? 1 : min(a.R - row0, ROWS);
  const int span = a.span, span_b = span * E;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ks = smem;
  uint8_t* vs = one_tile(SELF) ? ks : ks + tile_bytes(span_b);
  float* ps = reinterpret_cast<float*>(vs + tile_bytes(span_b));  // [ROWS, span]
  float* qf = ps + ROWS * span;            // [ROWS, QSTRIDE]
  float* part = qf + ROWS * QSTRIDE;       // [C, ROWS, D], read in rank 0
  float* red = part + C * ROWS * D;        // [NW, ROWS, 2] warp (max, sum)
  float* stat = red + NW * ROWS * 2;       // [ROWS, 2] this CTA's, read by the cluster
  float* md = stat + ROWS * 2;             // [ROWS, 2] the row max and denominator over all T
  float* cur = md + ROWS * 2;              // self: the current token's logit

  // this CTA's positions [tb, te), staged as [ta, ta + n) on 16-byte bounds
  const int lo = SELF && a.valid_from != nullptr ? max(a.valid_from[b], 0) : 0;
  const int tb = max(lo, rank * span), te = min(a.hi, (rank + 1) * span);
  const int ta = tb & ~(VEC - 1);
  const int n = te > tb ? ((te + VEC - 1) & ~(VEC - 1)) - ta : 0;
  const int groups = n / 4;

  // q first: its loads are in flight beside the copies
  constexpr int QPT = (ROWS * D + NT - 1) / NT;  // q values per thread
  float qv[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int i = tid + j * NT, r = i / D, d = i % D;
    qv[j] = r < R ? to_f(static_cast<const TQ*>(a.q)[b * a.qsb + (row0 + r) * a.qsr + h * a.qsh + d])
                  : 0.f;
  }
  const int nch = n / VEC;
  stage<NT>(ks, static_cast<const TKV*>(a.k) + b * a.ksb + h * a.ksh + ta, a.ksd, span_b, nch);
  const TKV* vg = static_cast<const TKV*>(a.v) + b * a.vsb + h * a.vsh + ta;
  if (!one_tile(SELF)) stage<NT>(vs, vg, a.vsd, span_b, nch);
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int i = tid + j * NT;
    if (i < ROWS * D) qf[(i / D) * QSTRIDE + q_at(i % D)] = qv[j];
  }
  copy_wait<one_tile(SELF) ? 0 : 1>();  // K
  __syncthreads();
  if (SELF && warp == 0) {
    const TQ* kt = static_cast<const TQ*>(a.kt) + b * a.ktsb + h * a.ktsh;
    float c = qf[q_at(lane)] * to_f(kt[lane]) + qf[q_at(lane + 32)] * to_f(kt[lane + 32]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += shfl(c, off);
    if (lane == 0) *cur = c;
  }

  // scores: lane 4g + j of a warp takes d rows [16 j, 16 j + 16) of
  // positions ta + 4 (base + g) .. + 3 and ends with the score of position
  // ta + 4 (base + g) + j; positions outside [tb, te) get -inf
  const int quarter = lane & 3, gl = lane >> 2;
  float m_run[ROWS], l_run[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) m_run[r] = -INFINITY, l_run[r] = 0.f;
  for (int base = warp * 8; base < groups; base += NT / 4) {
    const int g = base + gl;
    const bool act = g < groups;
    float s[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
    if (act) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int d = 16 * quarter + i;
        float kv[4];
        load4(reinterpret_cast<const TKV*>(ks + row_off(d, span_b)) + 4 * g, kv);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < R) {
            const float qd = qf[r * QSTRIDE + q_at(d)];
#pragma unroll
            for (int j = 0; j < 4; ++j) s[r][j] = fmaf(qd, kv[j], s[r][j]);
          }
        }
      }
    }
    const int t = ta + 4 * g + quarter;
    const bool valid = act && t >= tb && t < te;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < R) {
        const float x = reduce4(s[r], quarter);
        if (act) ps[r * span + 4 * g + quarter] = valid ? x : -INFINITY;
        if (valid) stat_add(m_run[r], l_run[r], x);
      }
    }
  }

  // (max, sum) over the warp, the CTA and then the cluster, in rank order,
  // with the current token's logit last
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < R) {
      float m = m_run[r], l = l_run[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float m2 = shfl(m, off), l2 = shfl(l, off);
        stat_merge(m, l, m2, l2);
      }
      if (lane == 0) red[(warp * ROWS + r) * 2] = m, red[(warp * ROWS + r) * 2 + 1] = l;
    }
  }
  __syncthreads();
  if (one_tile(SELF)) stage<NT>(vs, vg, a.vsd, span_b, nch);  // K is read: V into its tile
  if (tid < R) {
    float m = red[tid * 2], l = red[tid * 2 + 1];
    for (int w = 1; w < NW; ++w) stat_merge(m, l, red[(w * ROWS + tid) * 2], red[(w * ROWS + tid) * 2 + 1]);
    stat[tid * 2] = m;
    stat[tid * 2 + 1] = l;
  }
  if (C > 1) cg::this_cluster().sync(); else __syncthreads();
  if (tid < R) {
    float m = -INFINITY, l = 0.f;
    for (int c = 0; c < C; ++c) {
      const float* sc = C > 1 ? cg::this_cluster().map_shared_rank(stat, c) : stat;
      stat_merge(m, l, sc[tid * 2], sc[tid * 2 + 1]);
    }
    if (SELF) stat_merge(m, l, *cur, 1.f);
    md[tid * 2] = m;
    md[tid * 2 + 1] = l;
  }
  __syncthreads();

  // probabilities: exp(s - max) / sum, then rounded to the compute dtype
  for (int i = tid; i < R * groups; i += NT) {
    const int r = i / groups, g = i - r * groups;
    float4* p4 = reinterpret_cast<float4*>(ps + r * span + 4 * g);
    float4 p = *p4;
    const float m = md[r * 2], den = md[r * 2 + 1];
    p.x = round_as<TQ>(expf(p.x - m) / den); p.y = round_as<TQ>(expf(p.y - m) / den);
    p.z = round_as<TQ>(expf(p.z - m) / den); p.w = round_as<TQ>(expf(p.w - m) / den);
    *p4 = p;
  }
  copy_wait<0>();  // V
  __syncthreads();

  // partial P V of this span: warp w takes d rows [8 w, 8 w + 8) (and
  // every 8 NW rows on), lanes along t in groups of 4 positions; into rank
  // 0's shared memory
  float* part0 = C > 1 ? cg::this_cluster().map_shared_rank(part, 0) : part;
  const int sub = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
  constexpr int RB = ROWS < 4 ? ROWS : 4;  // query rows per pass over V
  for (int rb = 8 * warp; rb < D; rb += 8 * NW) {
#pragma unroll
    for (int r0 = 0; r0 < ROWS; r0 += RB) {
      if (r0 >= R) break;
      float acc[RB][8];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
      for (int g = lane; g < groups; g += 32) {
        float vv[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          load4(reinterpret_cast<const TKV*>(vs + row_off(rb + i, span_b)) + 4 * g, vv[i]);
        const int t0 = ta + 4 * g;
        if (t0 < tb || t0 + 4 > te) {  // a group on an edge: drop the bytes staged past it
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (t0 + j < tb || t0 + j >= te)
#pragma unroll
              for (int i = 0; i < 8; ++i) vv[i][j] = 0.f;
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r0 + r < R) {
            const float4 p = *reinterpret_cast<const float4*>(ps + (r0 + r) * span + 4 * g);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[r][i] = fmaf(p.x, vv[i][0], acc[r][i]);
              acc[r][i] = fmaf(p.y, vv[i][1], acc[r][i]);
              acc[r][i] = fmaf(p.z, vv[i][2], acc[r][i]);
              acc[r][i] = fmaf(p.w, vv[i][3], acc[r][i]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r0 + r < R) {
          const float x = reduce_rows8(acc[r], lane);
          if ((lane & 3) == 0) part0[(rank * ROWS + r0 + r) * D + rb + sub] = x;
        }
      }
    }
  }
  if (C > 1) cg::this_cluster().sync(); else __syncthreads();

  if (rank == 0) {
    float p_cur = 0.f;
    const TQ* vt = nullptr;
    if (SELF) {
      p_cur = round_as<TQ>(expf(*cur - md[0]) / md[1]);
      vt = static_cast<const TQ*>(a.vt) + b * a.vtsb + h * a.vtsh;
    }
    for (int i = tid; i < R * D; i += NT) {
      const int r = i / D, d = i % D;
      float s = 0.f;
      for (int c = 0; c < C; ++c) s += part[(c * ROWS + r) * D + d];
      if (SELF) s += p_cur * to_f(vt[d]);
      a.o[b * a.osb + (row0 + r) * a.osr + h * a.osh + d] = s;
    }
  }
}

template <typename TQ, typename TKV, int ROWS, bool SELF>
int launch(const Args& a, int B, cudaStream_t st) {
  const size_t smem = smem_bytes(SELF, a.span, sizeof(TKV), ROWS, a.cluster);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = attend<TQ, TKV, ROWS, SELF>;
  // once per kernel and device (function attributes belong to a device's
  // context): the largest dynamic shared memory any split may ask for, and
  // all of the SM's L1 / shared split given to shared memory
  static std::atomic<bool> attr_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || !attr_set[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) attr_set[dev].store(true, std::memory_order_release);
  }
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)a.cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  // y: the tiles of ROWS query rows (one for the self kernel)
  cfg.gridDim = dim3((unsigned)(B * a.H * a.cluster), (unsigned)((a.R + ROWS - 1) / ROWS));
  cfg.blockDim = dim3(threads_of(SELF));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = a.cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// a split the kernels were built for: C in {1, 2, 4, 8}, spans on 16
// positions, covering [0, hi)
bool split_ok(int hi, int cluster, int span) {
  return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) &&
         span >= SPAN_ALIGN && span % SPAN_ALIGN == 0 && (long long)cluster * span >= hi;
}

// K/V rows the 16-byte copies can read: every row on 16 bytes, at least `hi` long
bool rows_ok(const void* p, long long sb, long long sh, long long sd, int elem, int hi) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (sb * elem) % 16 == 0 &&
         (sh * elem) % 16 == 0 && (sd * elem) % 16 == 0 && sd >= hi;
}

int elem_size(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 1; }

// the tile's row count: 1, 4 or 8 (any R above 8 runs tiles of 8)
template <typename TQ, typename TKV>
int cross(const Args& a, int B, cudaStream_t st) {
  if (a.R == 1) return launch<TQ, TKV, 1, false>(a, B, st);
  if (a.R <= 4) return launch<TQ, TKV, 4, false>(a, B, st);
  return launch<TQ, TKV, MAX_ROWS, false>(a, B, st);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8, 3 float8_e4m3fn.
extern "C" int twt_cross_attention(
    int q_dtype, int kv_dtype, int B, int H, int R, int T, int cluster, int span,
    const void* q, long long qsb, long long qsr, long long qsh,
    const void* k, long long ksb, long long ksh, long long ksd,
    const void* v, long long vsb, long long vsh, long long vsd,
    void* o, long long osb, long long osr, long long osh, void* stream) {
  const int es = elem_size(kv_dtype);
  if (R < 1 || R > MAX_ROWS * MAX_TILES || T < 1 || !split_ok(T, cluster, span) ||
      !rows_ok(k, ksb, ksh, ksd, es, T) || !rows_ok(v, vsb, vsh, vsd, es, T))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q; a.qsb = qsb; a.qsr = qsr; a.qsh = qsh;
  a.k = k; a.ksb = ksb; a.ksh = ksh; a.ksd = ksd;
  a.v = v; a.vsb = vsb; a.vsh = vsh; a.vsd = vsd;
  a.o = (float*)o; a.osb = osb; a.osr = osr; a.osh = osh;
  a.H = H; a.R = R; a.hi = T; a.span = span; a.cluster = cluster;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 1) {
    if (kv_dtype == 1) return cross<__nv_bfloat16, __nv_bfloat16>(a, B, st);
    if (kv_dtype == 2) return cross<__nv_bfloat16, int8_t>(a, B, st);
    if (kv_dtype == 3) return cross<__nv_bfloat16, __nv_fp8_e4m3>(a, B, st);
  } else if (q_dtype == 0) {
    if (kv_dtype == 0) return cross<float, float>(a, B, st);
    if (kv_dtype == 2) return cross<float, int8_t>(a, B, st);
    if (kv_dtype == 3) return cross<float, __nv_fp8_e4m3>(a, B, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int twt_self_attention(
    int dtype, int B, int H, int index, int cluster, int span,
    const void* q, long long qsb, long long qsh,
    const void* kt, long long ktsb, long long ktsh,
    const void* vt, long long vtsb, long long vtsh,
    const void* ck, long long cksb, long long cksh, long long cksd,
    const void* cv, long long cvsb, long long cvsh, long long cvsd,
    const void* valid_from, void* o, void* stream) {
  const int es = elem_size(dtype);
  if (index < 0 || !split_ok(index, cluster, span) || !rows_ok(ck, cksb, cksh, cksd, es, index) ||
      !rows_ok(cv, cvsb, cvsh, cvsd, es, index))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q; a.qsb = qsb; a.qsr = 0; a.qsh = qsh;
  a.k = ck; a.ksb = cksb; a.ksh = cksh; a.ksd = cksd;
  a.v = cv; a.vsb = cvsb; a.vsh = cvsh; a.vsd = cvsd;
  a.o = (float*)o; a.osb = (long long)H * D; a.osr = 0; a.osh = D;
  a.kt = kt; a.ktsb = ktsb; a.ktsh = ktsh;
  a.vt = vt; a.vtsb = vtsb; a.vtsh = vtsh;
  a.valid_from = (const int*)valid_from;
  a.H = H; a.R = 1; a.hi = index; a.span = span; a.cluster = cluster;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16, 1, true>(a, B, st);
  if (dtype == 0) return launch<float, float, 1, true>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
