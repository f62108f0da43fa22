// Log-mel spectrum for Hopper (sm_90a): a real FFT per frame, with the
// reflect pad folded into the loads.
//
// Replaces the TPU kernel taiwan_whisper_tpu/ops/mel_kernel.py::log_mel_pallas
// (_mel_kernel): frames @ W_cos, frames @ W_sin -> power = re^2 + im^2 ->
// power @ mel_fb -> log10(max(., 1e-10)). The per-utterance max-8 floor and
// (x+4)/4 tail run outside, in PyTorch, as in the JAX package.
//
// The DFT-matrix form was the TPU's: two dense 400 x 201 products suit a
// 128 x 128 matrix unit, but on this card they are 2*2*400*201 fp32 flop a
// frame (34 GFLOP at 32 x 30 s). They compute the DFT of each windowed
// frame, and an FFT computes the same DFT exactly in real arithmetic, up to
// fp32 rounding in another order. A 400-point real FFT is a 200-point complex
// FFT of z[n] = x[2n] + i x[2n+1] and one split pass into the 201 bins,
// ~9 kflop a frame; with the power and the mel product over the filter
// bank's nonzeros (391 at 80 mels) about 10 kflop, 0.96 GFLOP at batch 32.
//
// Bound: bytes. The audio read once and the log-mel written once are
// 4 * (32 * 480000 + 32 * 3000 * 80) = 92.2 MB at batch 32: 0.0275 ms at
// 3.35 TB/s, against 0.014 ms for the flop at 67 TF fp32.
//
// Design: persistent blocks of 256 threads, two resident on each SM (their
// shared memory: 108 KB each), walk the batch's tiles of 32 frames
// (ops/mel_kernel.py::launch_grid). Per tile:
//  1. The tile's frames overlap (hop 160, window 400), so the block stages
//     ONE span of 31 * 160 + 400 samples in shared memory, read from the
//     unpadded [B, N] audio: padded[j] = audio[|j - 200|], mirrored again at
//     the far end (ops/mel_kernel.py::reflect_index). An interior span
//     starts 640 f0 - 800 bytes into a row of 640k bytes and moves in
//     16-byte cp.async copies; the first and last tiles of an utterance in
//     4-byte cp.async copies through the reflect index. No padded copy of the
//     audio is ever written. The next tile's span is staged into a second
//     buffer while this one is computed.
//  2. Pass 1, radix 8: thread (n2 < 25, frame group) windows z[25 n1 + n2]
//     (n1 < 8) as the samples leave the span, takes their 8-point DFT in
//     registers, multiplies by W_200^(n2 k1) and writes Y[k1][n2]; its
//     window pairs and twiddles live in registers for the whole launch.
//  3. Pass 2, radix 25 = 5 x 5: thread (frame, k1 < 8) reads Y[k1][.] into
//     registers, runs five 5-point DFTs, the W_25 twiddles and five more:
//     it holds Z[k] for k = k1 (mod 8). The split into the 201 bins of the
//     real input takes Z[k] and conj Z[200 - k], the latter from lane
//     8 - k1 by a shuffle, and writes |2 X[k]|^2 = |A + W' D|^2 (A and D the
//     sum and difference, W' = -i W_400^k) over the span pass 1 has read.
//  4. Mel: lane = frame; warp w takes filters w, w + 8, .. two at a time,
//     each a slice of weights against the power (start bin, count and
//     weights from ops/mel_kernel.py::mel_slices), so the warp shares one
//     trip count and the weights are broadcast; times 1/4, log10(max(.,
//     1e-10)), staged in shared memory and streamed out in whole rows.
// The window and the twiddles W_400^j come in one fp32 table computed in
// float64 by ops/mel_kernel.py::fft_tables; every other twiddle and the
// radix-8 and radix-5 constants are entries of it (W_200^m = W_400^(2m),
// W_25^m = W_400^(16m), W_8 = W_400^50, W_5 = W_400^80). The power never
// leaves shared memory. Pass 1's layout [k1][n2] and the frame stride of
// 200 complex values keep pass 2's reads of Y free of bank conflicts, and
// the power's row stride of 201 floats the mel pass's. No atomics: a rerun
// is bitwise equal.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int PAD = N_FFT / 2;
constexpr int NC = N_FFT / 2;       // points of the complex FFT: 200 = 8 x 25
constexpr int N_FREQS = NC + 1;     // 201
constexpr int TF = 32;              // frames per tile: one a lane in the mel pass
constexpr int THREADS = TF * 8;     // pass 2: one (frame, k1) task per thread
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 2;    // ops/mel_kernel.py::BLOCKS_PER_SM
constexpr int SPAN = (TF - 1) * HOP + N_FFT;
constexpr int MAX_MELS = 128;
constexpr int MAX_WEIGHTS = 512;
constexpr int MAX_DEVICES = 64;     // devices whose kernel attribute is cached

struct Smem {
  float win[N_FFT];          // the window, then
  float2 tw[N_FFT];          // W_400^j = exp(-2 pi i j / 400): the table as it comes
  int2 spans[MAX_MELS + 1];  // (first bin, first weight) of each filter
  float weights[MAX_WEIGHTS];
  // a tile's samples, reflect pad folded in; once pass 1 has read them, its
  // power [TF][N_FREQS]. Two: the next tile's samples arrive while this one
  // is computed.
  alignas(16) float span[2][SPAN > TF * N_FREQS ? SPAN : TF * N_FREQS];
  // pass 1's Y[f][k1][n2]; once pass 2 has read it, the log-mel
  // [TF][n_mels + 1] on the way out
  float2 z[TF][NC];
};

__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 operator-(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 operator*(float s, float2 a) {
  return make_float2(s * a.x, s * a.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 neg_i(float2 a) { return make_float2(a.y, -a.x); }  // -i a
__device__ __forceinline__ float norm2(float2 a) { return a.x * a.x + a.y * a.y; }

// log10(max(x, 1e-10)) by the hardware's log2 (MUFU.LG2, 2 ulp): within
// 3e-6 of log10f over the outputs' range, against the 1e-4 the kernel is
// held to
__device__ __forceinline__ float log10_of(float x) {
  return __log2f(fmaxf(x, 1e-10f)) * 0.30102999566398120f;
}

// P[k] = sum_n p_n (-i)^(nk), the 4-point DFT
__device__ __forceinline__ void dft4(float2 p0, float2 p1, float2 p2, float2 p3, float2 P[4]) {
  const float2 s0 = p0 + p2, s1 = p0 - p2, s2 = p1 + p3, s3 = neg_i(p1 - p3);
  P[0] = s0 + s2;
  P[2] = s0 - s2;
  P[1] = s1 + s3;
  P[3] = s1 - s3;
}

// x <- its 8-point DFT (W_8 = exp(-2 pi i / 8)); r = cos(pi / 4)
__device__ __forceinline__ void dft8(float2 x[8], float r) {
  float2 e[4], o[4];
  dft4(x[0], x[2], x[4], x[6], e);
  dft4(x[1], x[3], x[5], x[7], o);
  const float2 o1 = make_float2(r * (o[1].x + o[1].y), r * (o[1].y - o[1].x));  // W_8 o1
  const float2 o2 = neg_i(o[2]);                                                 // W_8^2 o2
  const float2 o3 = make_float2(r * (o[3].y - o[3].x), -r * (o[3].x + o[3].y));  // W_8^3 o3
  x[0] = e[0] + o[0];
  x[4] = e[0] - o[0];
  x[1] = e[1] + o1;
  x[5] = e[1] - o1;
  x[2] = e[2] + o2;
  x[6] = e[2] - o2;
  x[3] = e[3] + o3;
  x[7] = e[3] - o3;
}

// (x0..x4) <- their 5-point DFT; c1, s1 = cos, sin(2 pi / 5); c2, s2 = cos, sin(4 pi / 5)
__device__ __forceinline__ void dft5(float2& x0, float2& x1, float2& x2, float2& x3, float2& x4,
                                     float c1, float s1, float c2, float s2) {
  const float2 a1 = x1 + x4, b1 = x1 - x4, a2 = x2 + x3, b2 = x2 - x3;
  const float2 t1 = x0 + c1 * a1 + c2 * a2, t2 = x0 + c2 * a1 + c1 * a2;
  const float2 u1 = neg_i(s1 * b1 + s2 * b2), u2 = neg_i(s2 * b1 - s1 * b2);
  x0 = x0 + a1 + a2;
  x1 = t1 + u1;
  x4 = t1 - u1;
  x2 = t2 + u2;
  x3 = t2 - u2;
}

// 4 or 16 bytes from global into shared memory, completing with this
// thread's next commit group
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)),
                  "l"((uint64_t)__cvta_generic_to_global(src)) : "memory");
}
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)),
                  "l"((uint64_t)__cvta_generic_to_global(src)) : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void copy_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

struct Tile {
  int b, f0, nf;  // utterance, first frame, frames
};

__device__ __forceinline__ Tile tile_of(long long t, int tiles_per_utt, long long n_frames) {
  Tile r;
  r.b = (int)(t / tiles_per_utt);
  r.f0 = (int)(t - (long long)r.b * tiles_per_utt) * TF;
  r.nf = (int)min((long long)TF, n_frames - r.f0);
  return r;
}

// start the copies of tile `tl`'s span into `dst`: padded[f0 * HOP + i] for
// i < (nf - 1) * HOP + N_FFT. An interior span (start = 640 f0 - 800 bytes
// into a row of 640k bytes) moves in 16-byte copies; the first and last
// tiles of an utterance sample by sample through the reflect index.
__device__ __forceinline__ void stage(float* dst, const float* audio, long long n, Tile tl) {
  const int len = (tl.nf - 1) * HOP + N_FFT;
  const long long start = (long long)tl.f0 * HOP - PAD;
  const float* a = audio + (long long)tl.b * n;
  if (start >= 0 && start + len <= n) {
    for (int i = threadIdx.x; i < len / 4; i += THREADS) copy16(dst + 4 * i, a + start + 4 * i);
  } else {
    for (int i = threadIdx.x; i < len; i += THREADS) {
      long long j = start + i;
      j = j < 0 ? -j : j;
      j = j >= n ? 2 * (n - 1) - j : j;
      copy4(dst + i, a + j);
    }
  }
  copy_commit();
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
log_mel_kernel(const float* __restrict__ audio,   // [B, n], unpadded
               long long n, int batch,
               const float* __restrict__ table,   // window [400], then W_400^j as (re, im)
               const int2* __restrict__ spans,    // [n_mels + 1] (first bin, first weight)
               const float* __restrict__ weights, // [n_weights]
               int n_weights,
               float* __restrict__ out,           // [B, n / 160, n_mels]
               int n_mels) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n_frames = n / HOP;
  const int tiles_per_utt = (int)((n_frames + TF - 1) / TF);
  const long long n_tiles = (long long)batch * tiles_per_utt;

  // the tables once per block, and the first tile's span
  for (int i = tid; i < 3 * N_FFT / 4; i += THREADS) copy16(S.win + 4 * i, table + 4 * i);
  for (int i = tid; i <= n_mels; i += THREADS) S.spans[i] = spans[i];
  for (int i = tid; i < n_weights; i += THREADS) S.weights[i] = weights[i];
  long long t = blockIdx.x;
  if (t < n_tiles) stage(S.span[0], audio, n, tile_of(t, tiles_per_utt, n_frames));
  copy_wait_all();
  __syncthreads();
  // pass 1's thread keeps one n2 (< 25) for frames fg, fg + 10, .. (fg < 10;
  // 250 threads): its window pairs and twiddles W_200^(n2 k1) in registers
  const int n2 = tid % 25, fg = tid / 25;
  float2 wv[8], t1[8];
#pragma unroll
  for (int n1 = 0; n1 < 8; ++n1) {
    wv[n1] = reinterpret_cast<const float2*>(S.win)[25 * n1 + n2];
    t1[n1] = S.tw[2 * n2 * n1];
  }
  const float r = S.tw[50].x;
  const float c1 = S.tw[80].x, s1 = -S.tw[80].y, c2 = S.tw[160].x, s2 = -S.tw[160].y;

  for (int buf = 0; t < n_tiles; t += gridDim.x, buf ^= 1) {
    const Tile tl = tile_of(t, tiles_per_utt, n_frames);
    copy_wait_all();
    __syncthreads();  // this tile's span is in; the last tile's log-mel is out
    if (t + gridDim.x < n_tiles)
      stage(S.span[buf ^ 1], audio, n, tile_of(t + gridDim.x, tiles_per_utt, n_frames));
    float* const span = S.span[buf];

    // pass 1: radix 8 over n1, then the twiddles W_200^(n2 k1)
    if (fg < 10) {
      for (int f = fg; f < tl.nf; f += 10) {
        const float* fr = span + f * HOP;
        float2 x[8];
#pragma unroll
        for (int n1 = 0; n1 < 8; ++n1) {
          const float2 s = *reinterpret_cast<const float2*>(fr + 2 * (25 * n1 + n2));
          x[n1] = make_float2(s.x * wv[n1].x, s.y * wv[n1].y);
        }
        dft8(x, r);
        float2* y = S.z[f];
        y[n2] = x[0];
#pragma unroll
        for (int k1 = 1; k1 < 8; ++k1) y[k1 * 25 + n2] = cmul(x[k1], t1[k1]);
      }
    }
    __syncthreads();

    // pass 2: the 25-point DFTs over n2 = 5 a + b, as 5 x 5 with W_25^(b c);
    // then the split into the real input's bins and their power, in
    // registers, written over the span pass 1 has read
    {
      const int f = tid >> 3, k1 = tid & 7;
      float2 v[25];
      const float2* y = S.z[f] + k1 * 25;
#pragma unroll
      for (int i = 0; i < 25; ++i) v[i] = y[i];
#pragma unroll
      for (int b = 0; b < 5; ++b)
        dft5(v[b], v[5 + b], v[10 + b], v[15 + b], v[20 + b], c1, s1, c2, s2);
#pragma unroll
      for (int c = 1; c < 5; ++c)
#pragma unroll
        for (int b = 1; b < 5; ++b) v[5 * c + b] = cmul(v[5 * c + b], S.tw[16 * b * c]);
#pragma unroll
      for (int c = 0; c < 5; ++c)
        dft5(v[5 * c], v[5 * c + 1], v[5 * c + 2], v[5 * c + 3], v[5 * c + 4], c1, s1, c2, s2);
      // Z[k1 + 8 k2] = v[5 (k2 % 5) + k2 / 5]. X[k] takes Z[k] and conj Z[200 - k]:
      // for k1 > 0 lane 8 - k1's Z at 24 - k2 (a shuffle within the frame's 8
      // lanes), for k1 = 0 this lane's own Z at (25 - k2) % 25.
      const int partner = (lane & 24) | ((8 - k1) & 7);
      float* const row = span + f * N_FREQS;
      const bool live = f < tl.nf;
#pragma unroll
      for (int k2 = 0; k2 < 25; ++k2) {
        const int kp = 24 - k2, ks = (25 - k2) % 25;
        const float2 zk = v[5 * (k2 % 5) + k2 / 5], give = v[5 * (kp % 5) + kp / 5];
        float2 zr = make_float2(__shfl_sync(0xffffffffu, give.x, partner),
                                __shfl_sync(0xffffffffu, give.y, partner));
        if (k1 == 0) zr = v[5 * (ks % 5) + ks / 5];
        // 2 X[k] = A + W' D: A = zk + conj zr, D = zk - conj zr, W' = -i W_400^k
        const float2 w = S.tw[k1 + 8 * k2];
        const float2 A = make_float2(zk.x + zr.x, zk.y - zr.y);
        const float2 D = make_float2(zk.x - zr.x, zk.y + zr.y);
        const float2 P = cmul(make_float2(w.y, -w.x), D);
        if (live) {
          row[k1 + 8 * k2] = norm2(A + P);
          if (k1 + k2 == 0) row[NC] = norm2(A - P);  // 2 X[200] = A - W'_0 D
        }
      }
    }
    __syncthreads();

    // the sparse mel product and log10: lane = frame, warp w takes filters
    // m = w, w + 8, .. two at a time (m and m + 8): one trip count across
    // the warp, weights broadcast. The power row holds |2 X|^2: a factor 1/4
    // (exact) at the end.
    float* const mel = reinterpret_cast<float*>(S.z);  // [TF][n_mels + 1]
    if (lane < tl.nf) {
      const float* prow = span + lane * N_FREQS;
      for (int m = warp; m < n_mels; m += 2 * WARPS) {
        const int mb = min(m + WARPS, n_mels);  // n_mels: no second filter
        const int2 sa = S.spans[m], sb = S.spans[mb];
        const int ca = S.spans[m + 1].y - sa.y, cb = mb < n_mels ? S.spans[mb + 1].y - sb.y : 0;
        const float *wa = S.weights + sa.y, *wb = S.weights + sb.y;
        const float *pa = prow + sa.x, *pb = prow + sb.x;
        float acc_a = 0.f, acc_b = 0.f;
        for (int j = 0; j < max(ca, cb); ++j) {
          if (j < ca) acc_a = fmaf(wa[j], pa[j], acc_a);
          if (j < cb) acc_b = fmaf(wb[j], pb[j], acc_b);
        }
        mel[lane * (n_mels + 1) + m] = log10_of(0.25f * acc_a);
        if (mb < n_mels) mel[lane * (n_mels + 1) + mb] = log10_of(0.25f * acc_b);
      }
    }
    __syncthreads();
    float* o = out + ((long long)tl.b * n_frames + tl.f0) * n_mels;
    for (int f = warp; f < tl.nf; f += WARPS)
      for (int m = lane; m < n_mels; m += 32) __stcs(o + f * n_mels + m, mel[f * (n_mels + 1) + m]);
  }
}

}  // namespace

// audio: contiguous fp32 [batch, n], 16-byte aligned, n % 160 == 0, n > 200.
// table: fp32 [1200] (fft_tables); spans: int32 [n_mels + 1, 2] and weights:
// fp32 [n_weights] (mel_slices); out: fp32 [batch, n / 160, n_mels]. grid:
// persistent blocks walking the batch's tiles of 32 frames
// (ops/mel_kernel.py::launch_grid).
extern "C" int twt_log_mel(const void* audio, long long n, int batch, const void* table,
                           const void* spans, const void* weights, int n_weights, void* out,
                           int n_mels, int grid, void* stream) {
  if (n % HOP != 0 || n <= PAD || n_mels < 1 || n_mels > MAX_MELS || n_weights < 0 ||
      n_weights > MAX_WEIGHTS || batch < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  // once per device (function attributes belong to a device's context)
  static std::atomic<bool> attr_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || !attr_set[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Smem));
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) attr_set[dev].store(true, std::memory_order_release);
  }
  log_mel_kernel<<<grid, THREADS, sizeof(Smem), (cudaStream_t)stream>>>(
      (const float*)audio, n, batch, (const float*)table, (const int2*)spans,
      (const float*)weights, n_weights, (float*)out, n_mels);
  return (int)cudaGetLastError();
}
