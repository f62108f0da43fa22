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
//
// Storage variants of the cross kernel: bf16 / fp32 / int8 / fp8 (one
// element a position) and packed int4 (two positions a byte, position 2j in
// the low nibble, two's complement; the JAX package's jnp.int4 K/V). A
// staged span starts on 16 bytes whatever the width, so int4 spans are
// multiples of 32 positions; a group of 4 positions is 2 bytes and `load4`
// sign-extends its nibbles. The "8x8" variant (the JAX model's int8_dots
// route, taiwan_whisper_tpu/models/whisper.py:506-526) runs over int8
// storage with fp32 q: each row's q is quantized to int8 over its 64 d
// (qmax = max|q| + 1e-12, round half to even, clip to 127), the scores are
// int8 x int8 dot products (__dp4a over 4 d rows whose bytes are transposed
// from 4 time-minor rows) times qmax / 127, the softmax is fp32 as above,
// the probabilities are quantized after the cluster's (max, sum) exchange
// (p8 = round(p / pmax * 127), pmax = the largest probability, 1 / sum, +
// 1e-12) and P V is __dp4a over 4 positions; the C CTAs' int32 partials add
// exactly in rank 0, which scales them by pmax / 127. Integer dot products
// are exact, so only the fp32 softmax's summation order separates the
// kernel from the plain version: a probability that lands within an ulp of
// a rounding boundary of p8 can round the other way.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

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
constexpr int SPAN_ALIGN4 = 32;    // positions of packed int4 in 16 bytes
constexpr int MAX_SMEM = 232448;   // the 227 KB one block may take on an H100
constexpr int QSTRIDE = D + 8;     // floats per staged q row (see q_at)
constexpr int MAX_DEVICES = 64;    // devices whose kernel attributes are cached

// packed int4 storage: two positions a byte, position 2j in the low nibble
struct int4x2_t {
  uint8_t b;
};

// bits of storage a position takes
template <typename T> __host__ __device__ constexpr int kv_bits() { return 8 * (int)sizeof(T); }
template <> __host__ __device__ constexpr int kv_bits<int4x2_t>() { return 4; }

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
__device__ __forceinline__ void load4(const int4x2_t* p, float (&f)[4]) {
  const uint32_t x = *reinterpret_cast<const uint16_t*>(p);  // positions 0-3, low nibble first
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = (float)((int32_t)(x << (28 - 4 * j)) >> 28);
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
__device__ __forceinline__ int shfl(int x, int off) {
  return __shfl_xor_sync(0xffffffffu, x, off);
}

// 4 rows of 4 bytes (byte j of row i: position j of d row i) -> 4 words of
// the 4 rows' bytes at one position (word j: byte i = d row i at position j)
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&t)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
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
template <typename T> __device__ __forceinline__ T reduce_rows8(T (&v)[8], int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T keep = h16 ? v[i + 4] : v[i], send = h16 ? v[i] : v[i + 4];
    v[i] = keep + shfl(send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const T keep = h8 ? v[i + 2] : v[i], send = h8 ? v[i] : v[i + 2];
    v[i] = keep + shfl(send, 8);
  }
  T x = (h4 ? v[1] : v[0]) + shfl(h4 ? v[0] : v[1], 4);
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

// the [D, nch 16-byte chunks] tile of rows `g` (row stride `sd` bytes)
// into the staged tile at `s`: thread i copies chunks i, i + NT, ...
template <int NT>
__device__ __forceinline__ void stage(uint8_t* s, const uint8_t* g, long long sd, int span_b,
                                      int nch) {
  for (int i = threadIdx.x; i < D * nch; i += NT) {
    const int d = i / nch, c = i - d * nch;
    copy16(s + row_off(d, span_b) + 16 * c, g + d * sd + 16 * c);
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

// Shared memory of one CTA: the K and V tiles of `span_b` bytes a row (one
// tile for both when `one_tile`), the scores / probabilities [ROWS, span],
// q [ROWS, QSTRIDE], the partial outputs of every rank [C, ROWS, D] (filled
// in rank 0), the statistics slots, and (`i8`, the "8x8" variant only)
// its int8 q [ROWS, D / 4 words] and q scales [ROWS].
__host__ __device__ constexpr size_t smem_bytes(bool self, int span, int span_b, int rows,
                                                int cluster, bool i8) {
  return (one_tile(self) ? 1 : 2) * (size_t)tile_bytes(span_b) +
         4 * ((size_t)rows * span + (size_t)rows * QSTRIDE + (size_t)cluster * rows * D +
              (size_t)threads_of(self) / 32 * rows * 2 + 4 * rows + 4 +
              (i8 ? (size_t)rows * (D / 4 + 1) : 0));
}

// I8: the "8x8" variant (fp32 q, int8 K/V, int8 x int8 dots)
template <typename TQ, typename TKV, int ROWS, bool SELF, bool I8 = false>
__global__ void __launch_bounds__(threads_of(SELF)) attend(const Args a) {
  constexpr int NT = threads_of(SELF), NW = NT / 32;
  constexpr int BITS = kv_bits<TKV>();
  constexpr int VEC = 128 / BITS;  // positions in 16 bytes
  constexpr int GB = BITS / 2;     // bytes of a group of 4 positions
  static_assert(!I8 || (sizeof(TQ) == 4 && BITS == 8 && !SELF), "8x8 takes fp32 q, int8 K/V");
  const int C = a.cluster;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int bh = blockIdx.x / C, b = bh / a.H, h = bh % a.H;
  const int row0 = SELF ? 0 : (int)blockIdx.y * ROWS;  // this tile's first query row
  const int R = SELF ? 1 : min(a.R - row0, ROWS);
  const int span = a.span, span_b = span * BITS / 8;
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
  int* q8 = reinterpret_cast<int*>(cur + 4);  // 8x8: [ROWS, D / 4] int8 q, 4 d a word
  float* qsc = reinterpret_cast<float*>(q8 + ROWS * D / 4);  // 8x8: [ROWS] qmax / 127

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
  constexpr int ES = sizeof(TKV);  // bytes of a storage element (strides count these)
  const long long ta_b = (long long)ta * BITS / 8;
  stage<NT>(ks, static_cast<const uint8_t*>(a.k) + (b * a.ksb + h * a.ksh) * ES + ta_b,
            a.ksd * ES, span_b, nch);
  const uint8_t* vg = static_cast<const uint8_t*>(a.v) + (b * a.vsb + h * a.vsh) * ES + ta_b;
  if (!one_tile(SELF)) stage<NT>(vs, vg, a.vsd * ES, span_b, nch);
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int i = tid + j * NT;
    if (i < ROWS * D) qf[(i / D) * QSTRIDE + q_at(i % D)] = qv[j];
  }
  copy_wait<one_tile(SELF) ? 0 : 1>();  // K
  __syncthreads();
  if constexpr (I8) {
    // warp r quantizes q row r as the JAX model does: q / qmax * 127,
    // rounded half to even and clipped, qmax = max |q| + 1e-12
    if (warp < R) {
      const float x0 = qf[warp * QSTRIDE + q_at(lane)], x1 = qf[warp * QSTRIDE + q_at(lane + 32)];
      float mx = fmaxf(fabsf(x0), fabsf(x1));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, shfl(mx, off));
      const float qmax = mx + 1e-12f;
      auto quant = [qmax](float x) {
        return (uint32_t)(uint8_t)(int8_t)fminf(fmaxf(rintf(x / qmax * 127.f), -127.f), 127.f);
      };
      // lanes 0-15 pack d 4 lane .. 4 lane + 3 into one word
      if (lane < 16) {
        uint32_t w = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) w |= quant(qf[warp * QSTRIDE + q_at(4 * lane + j)]) << (8 * j);
        q8[warp * (D / 4) + lane] = (int)w;
      }
      if (lane == 0) qsc[warp] = qmax / 127.f;
    }
    __syncthreads();
  }
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
      if constexpr (I8) {
        // int8 x int8: 4 d rows at a time, their bytes transposed to one
        // word a position; the integer partials (|x| < 2^18) are exact in fp32
        int si[ROWS][4];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) si[r][j] = 0;
#pragma unroll
        for (int i = 0; i < 16; i += 4) {
          const int d = 16 * quarter + i;
          uint32_t w[4], t[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            w[k] = *reinterpret_cast<const uint32_t*>(ks + row_off(d + k, span_b) + g * GB);
          transpose4(w, t);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (r < R) {
              const int qw = q8[r * (D / 4) + d / 4];
#pragma unroll
              for (int j = 0; j < 4; ++j) si[r][j] = __dp4a((int)t[j], qw, si[r][j]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[r][j] = (float)si[r][j];
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int d = 16 * quarter + i;
          float kv[4];
          load4(reinterpret_cast<const TKV*>(ks + row_off(d, span_b) + g * GB), kv);
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
    }
    const int t = ta + 4 * g + quarter;
    const bool valid = act && t >= tb && t < te;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < R) {
        float x = reduce4(s[r], quarter);
        if constexpr (I8) x *= qsc[r];  // the exact int32 dot, then qmax / 127
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
  if (one_tile(SELF)) stage<NT>(vs, vg, a.vsd * ES, span_b, nch);  // K is read: V into its tile
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

  // probabilities: exp(s - max) / sum, then rounded to the compute dtype;
  // 8x8: quantized to int8 against the row's largest probability (exp(0) /
  // sum), the 4 of a group packed into the group's first slot
  for (int i = tid; i < R * groups; i += NT) {
    const int r = i / groups, g = i - r * groups;
    float4* p4 = reinterpret_cast<float4*>(ps + r * span + 4 * g);
    float4 p = *p4;
    const float m = md[r * 2], den = md[r * 2 + 1];
    if constexpr (I8) {
      const float pmax = 1.f / den + 1e-12f;
      const float pr[4] = {expf(p.x - m) / den, expf(p.y - m) / den, expf(p.z - m) / den,
                           expf(p.w - m) / den};
      uint32_t w = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) w |= (uint32_t)(uint8_t)(int8_t)rintf(pr[j] / pmax * 127.f) << (8 * j);
      reinterpret_cast<int*>(p4)[0] = (int)w;
    } else {
      p.x = round_as<TQ>(expf(p.x - m) / den); p.y = round_as<TQ>(expf(p.y - m) / den);
      p.z = round_as<TQ>(expf(p.z - m) / den); p.w = round_as<TQ>(expf(p.w - m) / den);
      *p4 = p;
    }
  }
  copy_wait<0>();  // V
  __syncthreads();

  // partial P V of this span: warp w takes d rows [8 w, 8 w + 8) (and
  // every 8 NW rows on), lanes along t in groups of 4 positions; into rank
  // 0's shared memory
  float* part0 = C > 1 ? cg::this_cluster().map_shared_rank(part, 0) : part;
  const int sub = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
  constexpr int RB = ROWS < 4 ? ROWS : 4;  // query rows per pass over V
  using Acc = typename std::conditional<I8, int, float>::type;
  for (int rb = 8 * warp; rb < D; rb += 8 * NW) {
#pragma unroll
    for (int r0 = 0; r0 < ROWS; r0 += RB) {
      if (r0 >= R) break;
      Acc acc[RB][8];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = 0;
      if constexpr (I8) {
        // p8 of positions 4g..4g+3 (0 outside [tb, te)) against 4 bytes of
        // each V row: exact int32 sums
        for (int g = lane; g < groups; g += 32) {
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (r0 + r < R) {
              const int pw = reinterpret_cast<const int*>(ps + (r0 + r) * span + 4 * g)[0];
#pragma unroll
              for (int i = 0; i < 8; ++i)
                acc[r][i] = __dp4a(pw, *reinterpret_cast<const int*>(
                                           vs + row_off(rb + i, span_b) + g * GB), acc[r][i]);
            }
          }
        }
      } else {
        for (int g = lane; g < groups; g += 32) {
          float vv[8][4];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            load4(reinterpret_cast<const TKV*>(vs + row_off(rb + i, span_b) + g * GB), vv[i]);
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
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r0 + r < R) {
          const Acc x = reduce_rows8(acc[r], lane);
          if ((lane & 3) == 0) reinterpret_cast<Acc*>(part0)[(rank * ROWS + r0 + r) * D + rb + sub] = x;
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
      if constexpr (I8) {
        int si = 0;
        for (int c = 0; c < C; ++c) si += reinterpret_cast<const int*>(part)[(c * ROWS + r) * D + d];
        s = (float)si * ((1.f / md[r * 2 + 1] + 1e-12f) / 127.f);  // * pmax / 127
      } else {
        for (int c = 0; c < C; ++c) s += part[(c * ROWS + r) * D + d];
      }
      if (SELF) s += p_cur * to_f(vt[d]);
      a.o[b * a.osb + (row0 + r) * a.osr + h * a.osh + d] = s;
    }
  }
}

template <typename TQ, typename TKV, int ROWS, bool SELF, bool I8 = false>
int launch(const Args& a, int B, cudaStream_t st) {
  const size_t smem = smem_bytes(SELF, a.span, a.span * kv_bits<TKV>() / 8, ROWS, a.cluster, I8);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = attend<TQ, TKV, ROWS, SELF, I8>;
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

// a split the kernels were built for: C in {1, 2, 4, 8}, spans on `align`
// positions (16 bytes of packed int4, at least 16 bytes otherwise), covering [0, hi)
bool split_ok(int hi, int cluster, int span, int align = SPAN_ALIGN) {
  return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) &&
         span >= align && span % align == 0 && (long long)cluster * span >= hi;
}

// K/V rows the 16-byte copies can read: every row on 16 bytes, at least
// `hi_b` bytes long (strides count `elem`-byte storage elements)
bool rows_ok(const void* p, long long sb, long long sh, long long sd, int elem, long long hi_b) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (sb * elem) % 16 == 0 &&
         (sh * elem) % 16 == 0 && (sd * elem) % 16 == 0 && sd * elem >= hi_b;
}

// bytes of a storage element, and bits of a position, by dtype code
int elem_size(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 1; }
int pos_bits(int dtype) { return dtype == 4 ? 4 : 8 * elem_size(dtype); }

// the tile's row count: 1, 4 or 8 (any R above 8 runs tiles of 8)
template <typename TQ, typename TKV, bool I8 = false>
int cross(const Args& a, int B, cudaStream_t st) {
  if (a.R == 1) return launch<TQ, TKV, 1, false, I8>(a, B, st);
  if (a.R <= 4) return launch<TQ, TKV, 4, false, I8>(a, B, st);
  return launch<TQ, TKV, MAX_ROWS, false, I8>(a, B, st);
}

// the checks and arguments every cross entry shares
bool cross_args(Args& a, int kv_dtype, int B, int H, int R, int T, int cluster, int span,
                const void* q, long long qsb, long long qsr, long long qsh,
                const void* k, long long ksb, long long ksh, long long ksd,
                const void* v, long long vsb, long long vsh, long long vsd,
                void* o, long long osb, long long osr, long long osh) {
  const int es = elem_size(kv_dtype), bits = pos_bits(kv_dtype);
  const long long hi_b = ((long long)T * bits + 7) / 8;
  if (B < 1 || H < 1 || R < 1 || R > MAX_ROWS * MAX_TILES || T < 1 ||
      !split_ok(T, cluster, span, bits == 4 ? SPAN_ALIGN4 : SPAN_ALIGN) ||
      !rows_ok(k, ksb, ksh, ksd, es, hi_b) || !rows_ok(v, vsb, vsh, vsd, es, hi_b))
    return false;
  a.q = q; a.qsb = qsb; a.qsr = qsr; a.qsh = qsh;
  a.k = k; a.ksb = ksb; a.ksh = ksh; a.ksd = ksd;
  a.v = v; a.vsb = vsb; a.vsh = vsh; a.vsd = vsd;
  a.o = (float*)o; a.osb = osb; a.osr = osr; a.osh = osh;
  a.H = H; a.R = R; a.hi = T; a.span = span; a.cluster = cluster;
  return true;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8, 3 float8_e4m3fn, 4 int4 packed
// two positions a byte (uint8 storage; strides in bytes, T in positions).
extern "C" int twt_cross_attention(
    int q_dtype, int kv_dtype, int B, int H, int R, int T, int cluster, int span,
    const void* q, long long qsb, long long qsr, long long qsh,
    const void* k, long long ksb, long long ksh, long long ksd,
    const void* v, long long vsb, long long vsh, long long vsd,
    void* o, long long osb, long long osr, long long osh, void* stream) {
  Args a{};
  if (!cross_args(a, kv_dtype, B, H, R, T, cluster, span, q, qsb, qsr, qsh, k, ksb, ksh, ksd,
                  v, vsb, vsh, vsd, o, osb, osr, osh))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 1) {
    if (kv_dtype == 1) return cross<__nv_bfloat16, __nv_bfloat16>(a, B, st);
    if (kv_dtype == 2) return cross<__nv_bfloat16, int8_t>(a, B, st);
    if (kv_dtype == 3) return cross<__nv_bfloat16, __nv_fp8_e4m3>(a, B, st);
    if (kv_dtype == 4) return cross<__nv_bfloat16, int4x2_t>(a, B, st);
  } else if (q_dtype == 0) {
    if (kv_dtype == 0) return cross<float, float>(a, B, st);
    if (kv_dtype == 2) return cross<float, int8_t>(a, B, st);
    if (kv_dtype == 3) return cross<float, __nv_fp8_e4m3>(a, B, st);
    if (kv_dtype == 4) return cross<float, int4x2_t>(a, B, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The "8x8" variant: fp32 q (1/sqrt(d) and the K scale folded in) over int8
// K/V, int8 x int8 dots; the output is the P V sum times pmax / 127, before
// the V scale.
extern "C" int twt_cross_attention_int8_dots(
    int B, int H, int R, int T, int cluster, int span,
    const void* q, long long qsb, long long qsr, long long qsh,
    const void* k, long long ksb, long long ksh, long long ksd,
    const void* v, long long vsb, long long vsh, long long vsd,
    void* o, long long osb, long long osr, long long osh, void* stream) {
  Args a{};
  if (!cross_args(a, 2, B, H, R, T, cluster, span, q, qsb, qsr, qsh, k, ksb, ksh, ksd,
                  v, vsb, vsh, vsd, o, osb, osr, osh))
    return (int)cudaErrorInvalidValue;
  return cross<float, int8_t, true>(a, B, (cudaStream_t)stream);
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
  if (index < 0 || !split_ok(index, cluster, span) ||
      !rows_ok(ck, cksb, cksh, cksd, es, (long long)index * es) ||
      !rows_ok(cv, cvsb, cvsh, cvsd, es, (long long)index * es))
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
