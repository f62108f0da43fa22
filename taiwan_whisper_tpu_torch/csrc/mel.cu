// Fused log-mel spectrum for Hopper (sm_90a).
//
// Replaces the TPU kernel taiwan_whisper_tpu/ops/mel_kernel.py::log_mel_pallas
// (_mel_kernel): frames @ W_cos, frames @ W_sin -> power = re^2 + im^2 ->
// power @ mel_fb -> log10(max(., 1e-10)). The per-utterance max-8 floor and
// (x+4)/4 tail run outside, in PyTorch, as in the JAX package.
//
// Bound: operations. At 30 s chunks the two DFT products dominate
// (2*2*400*201 flop per frame, ~31 GFLOP at batch 32) on fp32 CUDA cores;
// the bytes (audio in, mel out) are ~92 MB.
//
// Design: one block per (utterance, tile of 32 frames). The tile's frames
// overlap (hop 160, window 400), so the block stages ONE contiguous span of
// 31*160+400 samples of the reflect-padded audio in shared memory instead of
// 32 separate frames. Thread k (< 201) owns frequency k for all 32 frames:
// it streams column k of W_cos/W_sin (640 KB together, L2-resident, read
// coalesced across k) and keeps 64 fp32 accumulators in registers, reading
// the frames as float4 broadcasts from shared memory. The power tile goes to
// shared memory and never reaches device memory; the mel product and log10
// run in the same block. Plain fp32 FMA; a tensor-core version is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int N_FREQS = 201;
constexpr int TF = 32;                          // frames per block
constexpr int SPAN = (TF - 1) * HOP + N_FFT;    // samples staged per block
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ audio,  // [B, n_pad] reflect-padded
               long long n_pad,
               const float* __restrict__ wcos,   // [N_FFT, N_FREQS]
               const float* __restrict__ wsin,   // [N_FFT, N_FREQS]
               const float* __restrict__ fb,     // [N_FREQS, n_mels]
               float* __restrict__ out,          // [B, n_frames, n_mels]
               int n_frames, int n_mels) {
  __shared__ __align__(16) float span[SPAN];
  __shared__ float power[TF * N_FREQS];

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * TF;
  const long long start = (long long)f0 * HOP;
  const float* a = audio + (long long)b * n_pad + start;
  const long long avail = n_pad - start;
  for (int i = threadIdx.x; i < SPAN; i += THREADS) span[i] = (i < avail) ? a[i] : 0.f;
  __syncthreads();

  const int k = threadIdx.x;
  if (k < N_FREQS) {
    float re[TF], im[TF];
#pragma unroll
    for (int f = 0; f < TF; ++f) { re[f] = 0.f; im[f] = 0.f; }
    for (int n = 0; n < N_FFT; n += 4) {
      const float c0 = wcos[(n + 0) * N_FREQS + k], s0 = wsin[(n + 0) * N_FREQS + k];
      const float c1 = wcos[(n + 1) * N_FREQS + k], s1 = wsin[(n + 1) * N_FREQS + k];
      const float c2 = wcos[(n + 2) * N_FREQS + k], s2 = wsin[(n + 2) * N_FREQS + k];
      const float c3 = wcos[(n + 3) * N_FREQS + k], s3 = wsin[(n + 3) * N_FREQS + k];
#pragma unroll
      for (int f = 0; f < TF; ++f) {
        const float4 x = *reinterpret_cast<const float4*>(&span[f * HOP + n]);
        re[f] = fmaf(x.x, c0, re[f]); im[f] = fmaf(x.x, s0, im[f]);
        re[f] = fmaf(x.y, c1, re[f]); im[f] = fmaf(x.y, s1, im[f]);
        re[f] = fmaf(x.z, c2, re[f]); im[f] = fmaf(x.z, s2, im[f]);
        re[f] = fmaf(x.w, c3, re[f]); im[f] = fmaf(x.w, s3, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < TF; ++f) power[f * N_FREQS + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < TF * n_mels; idx += THREADS) {
    const int f = idx / n_mels, m = idx - f * n_mels;
    if (f0 + f >= n_frames) continue;
    float acc = 0.f;
    for (int kk = 0; kk < N_FREQS; ++kk) acc = fmaf(power[f * N_FREQS + kk], fb[kk * n_mels + m], acc);
    out[((long long)b * n_frames + f0 + f) * n_mels + m] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

extern "C" int twt_log_mel(const void* audio, long long n_pad, int batch,
                           const void* wcos, const void* wsin, const void* fb,
                           void* out, int n_frames, int n_mels, void* stream) {
  dim3 grid((n_frames + TF - 1) / TF, batch);
  log_mel_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)audio, n_pad, (const float*)wcos, (const float*)wsin,
      (const float*)fb, (float*)out, n_frames, n_mels);
  return (int)cudaGetLastError();
}
