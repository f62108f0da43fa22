// Hopper (sm_90a) building blocks shared by the encoder-attention kernels
// (encoder_attention.cu, encoder_attention_bwd.cu), as raw inline PTX so that
// each library builds in seconds:
//
// * TMA tensor maps over a [B, S, H, 64] bf16 tensor read through its own
//   strides: a 4-D map over (d, h, s, b), a box of [rows x 64] (one head, a
//   run of positions), 128-byte swizzle. A bf16 row of 64 is exactly 128
//   bytes, the swizzle atom wgmma's 128-byte mode reads. Rows past S are
//   zero-filled on a load. Encoded on the host for every call from the
//   tensor's pointer and the parameters the wrapper computed from its
//   strides (ops/attention.py::tma_map_params), which make_map checks
//   against the kernels' tile shape.
// * mbarriers for the producer/consumer ring: the producer's TMA loads
//   complete a stage's `full` barrier by bytes, the consumer warps release
//   it on its `empty` barrier.
// * wgmma: shared-memory descriptors for 128-byte-swizzled tiles, fence,
//   commit and wait, and the bf16 products with fp32 accumulators in
//   registers: m64n128k16 with A from shared memory, m64n64k16 with A
//   from registers.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int D = 64;             // head dim: one 128-byte row of bf16
constexpr int ROW_BYTES = D * 2;  // bytes of one tile row in shared memory

struct Strides { long long b, s, h; };  // elements; the head dim is contiguous

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// is not linked against libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// One map's parameters as the wrappers pass them, twelve int64 words
// (ops/attention.py::tma_map_words): dims (d, h, s, b) innermost first,
// the byte strides of h, s and b, the box, the swizzle in bytes.
struct MapParams { long long dims[4], strides[3], box[4], swizzle; };
static_assert(sizeof(MapParams) == 12 * sizeof(long long), "twelve words per map");

// The map of a bf16 [B, S, H, 64] tensor from the wrapper's parameters,
// which must describe what the kernels read: dims (64, H, S, B), a box of
// `rows` positions of one head, 128-byte swizzle; zero fill. Returns a
// cudaError_t code (cudaErrorInvalidValue for other parameters or if the
// driver refuses them).
inline int make_map(CUtensorMap* map, const void* base, const MapParams& p, int B, int S, int H,
                    int rows) {
  if (p.dims[0] != D || p.dims[1] != H || p.dims[2] != S || p.dims[3] != B || p.box[0] != D ||
      p.box[1] != 1 || p.box[2] != rows || p.box[3] != 1 || p.swizzle != 128)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  for (int i = 0; i < 4; ++i) {
    dims[i] = (cuuint64_t)p.dims[i];
    box[i] = (cuuint32_t)p.box[i];
  }
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)p.strides[i];
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 128-byte-swizzled tiles must start on 1024 bytes (the swizzle reads
// address bits 7-9, which the wgmma descriptors assume start at 0).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Announce `bytes` of TMA traffic without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// TMA: the box of `map` at coordinates (0, h, s, b) into shared memory; its
// bytes (the whole box, zero fill included) complete on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int h, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(0), "r"(h), "r"(s), "r"(b)
      : "memory");
}

// ---------------------------------------------------------------------------
// device: warpgroup roles and wgmma
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Named barriers (id 0 is __syncthreads'): wait until `n` threads have
// reached barrier `id`, or arrive there without waiting.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Ping-pong between the two consumer warpgroups of a block (cw 0 and 1),
// on named barriers 1 and 2: each takes its turn before issuing a tile's
// products and passes it on right after, so one warpgroup's softmax runs
// while the other's products hold the tensor cores. Consumer 0 goes first;
// consumer 1 skips its last hand-over, so that every barrier's arrivals
// match its waits when both run `turns` turns.
struct PingPong {
  int cw, turns;
  __device__ __forceinline__ PingPong(int cw_, int turns_) : cw(cw_), turns(turns_) {
    if (cw == 1) named_arrive(1, 256);
  }
  __device__ __forceinline__ void take() const { named_sync(1 + cw, 256); }
  __device__ __forceinline__ void pass(int j) const {
    if (!(cw == 1 && j == turns - 1)) named_arrive(2 - cw, 256);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin accumulator registers in place around the asynchronous products, so
// the compiler neither reads them before the wait nor moves writes past
// the issue.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile whose rows of
// 64 bf16 (128 bytes) are stored one after another from `addr` (1024-byte
// aligned at the tile, plus a k offset of 32 bytes per 16 columns when the
// tile is K-major). Stride between 8-row groups (SBO): 1024 bytes. K-major
// tiles ignore the leading offset (1); MN-major ones span one 64-wide atom
// in n, so their leading offset is never stepped and is set to 1024 too.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)64 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]: A from registers (four bf16x2 per
// thread in the accumulator's layout), B MN-major in shared memory (the
// transpose bit: a [k rows][n] tile with n contiguous).
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// device: register fragments
// ---------------------------------------------------------------------------

// 2^x on the SFU (MUFU.EX2); 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The k16 chunk `kk` of a [64 x N] fp32 accumulator as a wgmma A operand in
// bf16: the accumulator's column pairs 16kk.. and 16kk+8.. of rows r, r+8.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[R], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// Store a [64 x 64] fp32 accumulator times `scale` as bf16 rows row0 + r of
// `out` (row stride `ld` elements), rows at or past `limit` skipped. The
// accumulator layout: warp w holds rows 16w + lane/4 and +8, columns
// 8j + 2(lane%4) and +1 in d[4j..4j+3].
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ld, int row0, int limit,
                                           const float (&d)[32], float scale0, float scale1) {
  const int t = threadIdx.x & 127, r = row0 + (t >> 5) * 16 + ((t & 31) >> 2);
  const int c = 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (r < limit)
      *reinterpret_cast<uint32_t*>(out + r * ld + 8 * j + c) =
          pack_bf16(d[4 * j] * scale0, d[4 * j + 1] * scale0);
    if (r + 8 < limit)
      *reinterpret_cast<uint32_t*>(out + (r + 8) * ld + 8 * j + c) =
          pack_bf16(d[4 * j + 2] * scale1, d[4 * j + 3] * scale1);
  }
}

}  // namespace hopper
