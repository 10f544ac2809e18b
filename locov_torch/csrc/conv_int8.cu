// KQ1: int8 convolution with int32 sums and a fused epilogue, NHWC, as
// an implicit GEMM on Hopper's wgmma tensor-core products. C must be a
// multiple of 16: the wrapper pads narrower channels with zeros, which
// leave the int32 sums exact.
//
// The int8 serving mode's trunk and res5 convolutions
// (locov_torch/ops/int8_conv.py). It has no Pallas parent: the JAX
// package computes this conv in XLA (locov_tpu/ops/int8_conv.py:
// conv_int8), and PyTorch has no int8 convolution on CUDA.
//
// out[m, o] = epi(sum_k A[m, k] * B[o, k]) with m = (n, oh, ow) an output
// pixel, k = (ky, kx, c) a tap and input channel, A[m, k] = xq[n, oh *
// stride - pad + ky, ow * stride - pad + kx, c] (0 outside the image) and
// B = wq [O, kh, kw, C] (k contiguous: both operands K-major).
// epi(acc) = relu?(T(T(f32(acc) * scale[o]) + shift[o]) + residual[m, o])
// with T the output type (float32 or bfloat16): the product rounded to
// float32, then once to T, the shift added in float32 and rounded to T,
// the residual (where given) likewise, as the plain version's
// `(acc.float() * scale).to(T) + shift + residual` does; relu writes +0
// for anything not above 0, as PyTorch's relu does on CUDA. Where a
// max-abs `amax` is given the epilogue also writes the int8 copy
// clip(rint(f32(y) / s), -127, 127), s = max(amax / 127, 1e-12), with
// correctly rounded divisions, as quantize_per_tensor_static computes it
// from the T-valued output; the float output may then be skipped.
//
// Bound on the H100: res5's conv3 on 8,000 boxes ([392,000 x 512] x
// [512 x 2048]) does 0.82 TOP of int8 products (0.42 ms at the 1,979
// TOP/s dense int8 peak) and writes 1.6 GB of bfloat16 output (0.48 ms
// at 3.35 TB/s): bytes bound it, and more so with a residual read or an
// int8 copy written. The design:
// - a persistent grid (one block an SM) walks the 128-row x BN output
//   tiles (BN 256, 128 or 64 by O), N fastest so that an A row block and
//   all of B stay in L2 while the blocks share them;
// - warp specialisation: warpgroup 0 produces, warpgroups 1 and 2
//   consume, 64 rows of the tile each, with wgmma.mma_async m64nBNk32
//   s8 x s8 -> s32 from shared memory; every thread runs at the launch
//   bound's 168 registers (ptxas allocates by it: a 512-thread variant
//   could not hold m64n256's 128 accumulators, setmaxnreg or not);
// - a ring of 128-byte k steps (16 KB of A, BN x 128 B of B) in the
//   128-byte swizzle that wgmma reads, with full and empty mbarriers;
//   B always by TMA, A in one of three modes (a template argument):
//   A_GEMM, a 2-D TMA box of 128 rows where the conv is a plain GEMM
//   (1x1, stride 1, no padding: every conv3 and the identity blocks'
//   conv1); A_SPATIAL, where C is a multiple of 128 and the conv is a
//   3x3 / 1 with padding 1 or a 1x1 / 2 (the trunk's and res5's
//   others), a tile's rows are output pixels of a spatial block (16 x 8,
//   or whole images of res5's 7 x 7) and each k step one 4-D TMA box of
//   one tap's 128 channels over the input seen at the stride, whose part
//   outside the input (the padding) TMA fills with zeros; A_GATHER, the
//   rest, gathered by the producer warpgroup's cp.async with zero fill
//   into the same swizzle, a row's 16-byte piece at chunk (piece ^ row
//   % 8) (the gather held res5's 3x3 at 3.04 ms, A_SPATIAL takes 1.85);
// - the producer fills the next tile's stages while the consumers run
//   this tile's epilogue;
// - the epilogue stages each warp's 16 rows in T through shared memory,
//   512 bytes of a row a pass, then adds the residual, applies relu and
//   quantizes 16 bytes of T a lane, four pieces at a time with their
//   loads issued first, so that the residual, the output and the int8
//   copy move as coalesced 16-byte pieces; the residual is asked into L2
//   at the tile's start, and the int8 copy's division is a corrected
//   product (div_rn).
// At res5's conv3 the mainloop takes ~0.5 ms of the kernel's 1.7: the
// epilogue's stores, which no warp overlaps with the products, hold it
// (PERF.md §6 lists what was tried).
// The tensor maps are encoded with cuTensorMapEncodeTiled, found through
// cudaGetDriverEntryPoint: the library links no -lcuda.
//
// The wgmma m64nN s32 accumulator (PTX ISA), g = lane / 4, q = lane % 4:
// warp w holds rows 16w .. 16w+15, and for each 8 columns j the values
// d[4j], d[4j+1] = row g, cols 8j+2q, 8j+2q+1; d[4j+2], d[4j+3] = row g+8.
#include <cuda.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using locov::desc;
using locov::encode_tiled;
using locov::EncodeTiled;
using locov::fence_operands;
using locov::mbar_arrive;
using locov::mbar_expect_tx;
using locov::mbar_init;
using locov::mbar_wait;
using locov::tma_load;
using locov::tma_load4;
using locov::wgmma_commit;
using locov::wgmma_fence;
using locov::wgmma_wait;

// ------------------------------------------------------------ epilogue
struct Epi {
  const float* scale;
  const void* shift;
  const void* residual;  // [m, o] of T, or null
  void* out;             // [m, o] of T, or null
  int8_t* qout;          // [m, o] int8, or null
  const float* amax;     // 0-dim float32 (with qout)
  int relu;
};

// T(T(f32(acc) * scale) + shift): the value before the residual
template <typename T>
__device__ __forceinline__ T dequant(int acc, float scale, T shift) {
  const T r = locov::from_f32<T>(__fmul_rn(__int2float_rn(acc), scale));
  return locov::from_f32<T>(
      __fadd_rn(locov::to_f32(r), locov::to_f32(shift)));
}

// the output: the residual added in float32 and rounded to T, then relu
template <typename T>
__device__ __forceinline__ T finish(T s, T res, bool has_res, bool relu) {
  T y = has_res ? locov::from_f32<T>(
                      __fadd_rn(locov::to_f32(s), locov::to_f32(res)))
                : s;
  if (relu && !(locov::to_f32(y) > 0.f)) y = locov::from_f32<T>(0.f);
  return y;
}

// the int8 copy's scale s = max(amax / 127, 1e-12) and RN(1 / s)
struct QScale {
  float s, inv;
};

__device__ __forceinline__ QScale quant_scale(const float* amax) {
  const float s = fmaxf(__fdiv_rn(__ldg(amax), 127.f), 1e-12f);
  return QScale{s, __frcp_rn(s)};
}

// y / s rounded to nearest, as __fdiv_rn gives it, in five operations:
// the product by RN(1 / s), one correction, then a second whose operand
// is within an ulp of y / s, which Markstein's theorem makes the
// correctly rounded quotient (the remainder fma is then exact). A
// quotient past 1e30 saturates the int8 copy either way and is taken as
// it is. (__fdiv_rn here cost 4 ms of the 5.7 ms of res5's conv3 with an
// int8 output.)
__device__ __forceinline__ float div_rn(float y, QScale q) {
  float d = __fmul_rn(y, q.inv);
  if (!(fabsf(d) < 1e30f)) return d;
  float r = __fmaf_rn(-q.s, d, y);
  d = __fmaf_rn(r, q.inv, d);
  r = __fmaf_rn(-q.s, d, y);
  return __fmaf_rn(r, q.inv, d);
}

template <typename T>
__device__ __forceinline__ int8_t quantize(T y, QScale qs) {
  const float v = rintf(div_rn(locov::to_f32(y), qs));
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(v, -127.f), 127.f)));
}

// ---------------------------------------------------- the wgmma kernel
namespace wg {

constexpr int BM = 128, BK = 128, THREADS = 384;
constexpr int STAGE_ROW = 528;  // a staged epilogue row: 512 bytes of T
                                // (a pass's columns) and 16 of padding
constexpr int STAGE_WARP = 16 * STAGE_ROW;
constexpr int ENCODE_FAILED = 1001;  // returned when a tensor map fails

template <int BN>
struct Cfg {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = BN == 256 ? 3 : BN == 128 ? 4 : 6;
  static constexpr int RING = STAGES * STAGE_BYTES;
  // 1024 bytes of slack to align the ring to the swizzle's 1024 bytes,
  // the ring, 8 consumer warps' staging, the row records, each consumer warp's 16 output rows, barriers
  static constexpr int SMEM =
      1024 + RING + 8 * STAGE_WARP + BM * 16 + BM * 4 + 2 * STAGES * 8;
};

// how A arrives: a 2-D TMA box (a plain GEMM), the producers' cp.async
// gather, or 4-D TMA boxes of spatial tiles
enum { A_GEMM = 0, A_GATHER = 1, A_SPATIAL = 2 };

struct Params {
  const int8_t* xq;
  Epi e;
  int n, h, w, c, o, kw, stride, pad, oh, ow, m, k, ktiles, ntiles, tiles;
  int gather;  // A by cp.async (else by TMA)
  // A by 4-D TMA boxes: a tile is tw x th output pixels of tn images
  // (rows (n, h, w), `rows` of them), a k step one tap's 128 channels
  int spatial, tw, th, tn, rows, tiles_w, tiles_h, ctiles;
};

// A tile: its first output row (contiguous tiles) or its corner (spatial
// tiles), and its first output channel.
struct Tile {
  int m0, ow0, oh0, nn0, n0;
};

template <bool SPATIAL>
__device__ __forceinline__ Tile tile_of(const Params& p, int tile, int bn) {
  Tile t;
  const int st = tile / p.ntiles;
  t.n0 = (tile % p.ntiles) * bn;
  t.m0 = SPATIAL ? 0 : st * 128;
  t.ow0 = t.oh0 = t.nn0 = 0;
  if (SPATIAL) {
    const int wi = st % p.tiles_w, r = st / p.tiles_w;
    t.ow0 = wi * p.tw;
    t.oh0 = (r % p.tiles_h) * p.th;
    t.nn0 = (r / p.tiles_h) * p.tn;
  }
  return t;
}

// The output row of a spatial tile's row r, or -1 past the output.
__device__ __forceinline__ int row_m(const Params& p, const Tile& t, int r) {
  if (r >= p.rows) return -1;
  const int w = t.ow0 + r % p.tw, q = r / p.tw;
  const int h = t.oh0 + q % p.th, n = t.nn0 + q / p.th;
  return w < p.ow && h < p.oh && n < p.n ? (n * p.oh + h) * p.ow + w : -1;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   locov::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// one arrival on bar once this thread's earlier cp.asyncs have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   locov::smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// d += A (64 x 32, descriptor a) * B^T (N x 32, descriptor b), s8 x s8 ->
// s32, one warpgroup: wgmma.mma_async m64nNk32 with scale-d 1

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2], uint64_t a,
                                      uint64_t b) {
  if constexpr (BN == 256)
    wgmma_n256(d, a, b);
  else if constexpr (BN == 128)
    wgmma_n128(d, a, b);
  else
    wgmma_n64(d, a, b);
}

// 16 bytes of T (8 bfloat16 or 4 float32 values) in a uint4, read and
// built by constant index
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ float get(const uint4& v, int i) {
    return __uint_as_float(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
  }
  static __device__ __forceinline__ uint4 make(const float (&y)[4]) {
    return make_uint4(__float_as_uint(y[0]), __float_as_uint(y[1]),
                      __float_as_uint(y[2]), __float_as_uint(y[3]));
  }
  static __device__ __forceinline__ void stage(void* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ __nv_bfloat16 get(const uint4& v,
                                                      int i) {
    const int k = i >> 1;
    const unsigned w = k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
    return __ushort_as_bfloat16(
        static_cast<unsigned short>((i & 1) ? w >> 16 : w & 0xffffu));
  }
  static __device__ __forceinline__ unsigned pair(__nv_bfloat16 lo,
                                                  __nv_bfloat16 hi) {
    return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
           (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
  }
  static __device__ __forceinline__ uint4 make(const __nv_bfloat16 (&y)[8]) {
    return make_uint4(pair(y[0], y[1]), pair(y[2], y[3]), pair(y[4], y[5]),
                      pair(y[6], y[7]));
  }
  static __device__ __forceinline__ void stage(void* p, __nv_bfloat16 a,
                                               __nv_bfloat16 b) {
    *reinterpret_cast<unsigned*>(p) = pair(a, b);
  }
};

__device__ __forceinline__ unsigned bytes4(const int8_t* q) {
  return static_cast<unsigned>(static_cast<uint8_t>(q[0])) |
         (static_cast<unsigned>(static_cast<uint8_t>(q[1])) << 8) |
         (static_cast<unsigned>(static_cast<uint8_t>(q[2])) << 16) |
         (static_cast<unsigned>(static_cast<uint8_t>(q[3])) << 24);
}

// The residual's Pack<T>::N channels at `at` (zeros without one): a
// 16-byte load where nout % N == 0 (then o + N <= nout), else n values.
template <typename T>
__device__ __forceinline__ uint4 load_residual(const Epi& e, long long at,
                                               bool whole, int n) {
  using P = Pack<T>;
  uint4 rv = make_uint4(0, 0, 0, 0);
  if (e.residual == nullptr) return rv;
  const T* res = static_cast<const T*>(e.residual) + at;
  if (whole) return __ldg(reinterpret_cast<const uint4*>(res));
  T r[P::N];
#pragma unroll
  for (int i = 0; i < P::N; ++i)
    r[i] = i < n ? res[i] : locov::from_f32<T>(0.f);
  return P::make(r);
}

// Pack<T>::N channels at `at` from their staged values and residual: the
// output and the int8 copy, as 16-byte pieces (N bytes of int8) where
// `whole`, else n values.
template <typename T>
__device__ __forceinline__ void emit16(const Epi& e, long long at,
                                       bool whole, int n, uint4 staged,
                                       uint4 rv, QScale qs) {
  using P = Pack<T>;
  constexpr int N = P::N;
  const bool has_res = e.residual != nullptr;
  T y[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    y[i] = finish(P::get(staged, i), P::get(rv, i), has_res, e.relu != 0);
  if (e.out != nullptr) {
    T* out = static_cast<T*>(e.out) + at;
    if (whole) {
      *reinterpret_cast<uint4*>(out) = P::make(y);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (i < n) out[i] = y[i];
    }
  }
  if (e.qout != nullptr) {
    int8_t qv[N];
#pragma unroll
    for (int i = 0; i < N; ++i) qv[i] = quantize(y[i], qs);
    int8_t* q = e.qout + at;
    if (whole) {
      if constexpr (N == 8)
        *reinterpret_cast<uint2*>(q) = make_uint2(bytes4(qv), bytes4(qv + 4));
      else
        *reinterpret_cast<unsigned*>(q) = bytes4(qv);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (i < n) q[i] = qv[i];
    }
  }
}

// One consumer warp's 16 rows (output rows mrow + r, or `rowm` [r] for a
// spatial tile; -1 past the output) of the tile's BN columns
// (from `n0`), in passes of 512 bytes of T a row (one pass in bfloat16):
// each lane stages its accumulators' values of the pass (rows g, g + 8;
// columns 8j + 2q, +1) in T; then the warp finishes the staged rows as
// 16-byte pieces, four a lane at a time with their loads issued first, in
// a rolled loop (an unrolled one outgrew the instruction cache and left
// each load's latency exposed).
template <typename T, int BN, bool SPATIAL>
__device__ __forceinline__ void epilogue(const int (&acc)[BN / 2],
                                         const Params& p, uint8_t* stg,
                                         int mrow, const int* rowm, int n0,
                                         int lane, QScale qs) {
  constexpr int PASS = 512 / sizeof(T);  // columns a pass
  constexpr int COLS = BN < PASS ? BN : PASS;
  constexpr int VALS = Pack<T>::N;
  constexpr int ROW_PIECES = COLS / VALS;
  constexpr int GROUPS = 16 * ROW_PIECES / (32 * 4);  // of 4 pieces a lane
  const int g = lane >> 2, q = lane & 3;
  const T* shift = static_cast<const T*>(p.e.shift);
  const T zero = locov::from_f32<T>(0.f);
  const bool whole = p.o % VALS == 0;
#pragma unroll
  for (int ps = 0; ps < BN / COLS; ++ps) {
    const int c0 = n0 + ps * COLS;
#pragma unroll
    for (int jj = 0; jj < COLS / 8; ++jj) {
      const int j = ps * (COLS / 8) + jj;
      const int col = jj * 8 + 2 * q;
      const int o = c0 + col;
      const float s0 = o < p.o ? __ldg(p.e.scale + o) : 0.f;
      const float s1 = o + 1 < p.o ? __ldg(p.e.scale + o + 1) : 0.f;
      const T h0 = o < p.o ? shift[o] : zero;
      const T h1 = o + 1 < p.o ? shift[o + 1] : zero;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        Pack<T>::stage(stg + (g + 8 * half) * STAGE_ROW + col * sizeof(T),
                       dequant(acc[4 * j + 2 * half], s0, h0),
                       dequant(acc[4 * j + 2 * half + 1], s1, h1));
    }
    __syncwarp();
#pragma unroll 1
    for (int grp = 0; grp < GROUPS; ++grp) {
      long long at[4];
      int n[4];
      uint4 sv[4], rv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pc = lane + 32 * (4 * grp + u);
        const int row = pc / ROW_PIECES, col = (pc % ROW_PIECES) * VALS;
        const int m = SPATIAL ? rowm[row] : mrow + row, o = c0 + col;
        n[u] = m >= 0 && m < p.m ? min(VALS, p.o - o) : 0;
        at[u] = (long long)m * p.o + o;
        sv[u] = *reinterpret_cast<const uint4*>(stg + row * STAGE_ROW +
                                                col * sizeof(T));
        rv[u] = n[u] > 0 ? load_residual<T>(p.e, at[u], whole, n[u])
                         : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (n[u] > 0)
          emit16<T>(p.e, at[u], whole, n[u], sv[u], rv[u], qs);
    }
    __syncwarp();
  }
}

// Ask L2 for a warp's 16 rows x BN columns of the residual, so that the
// epilogue finds them there.
template <typename T, int BN, bool SPATIAL>
__device__ __forceinline__ void prefetch_residual(const Params& p, int mrow,
                                                  const int* rowm, int n0,
                                                  int lane) {
  constexpr int LINES = (BN * (int)sizeof(T) + 127) / 128;  // a row
  if (p.e.residual == nullptr) return;
  for (int i = lane; i < 16 * LINES; i += 32) {
    const int m = SPATIAL ? rowm[i / LINES] : mrow + i / LINES;
    const int o = n0 + (i % LINES) * (128 / (int)sizeof(T));
    if (m >= 0 && m < p.m && o < p.o)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(
          static_cast<const T*>(p.e.residual) + (long long)m * p.o + o));
  }
}

// MODE: how A arrives (A_GEMM, A_GATHER or A_SPATIAL), fixed at compile
// time so that each kernel carries only its own producer and row code
template <typename T, int BN, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    conv_int8_wgmma(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const Params p) {
  using C = Cfg<BN>;
  constexpr bool gather = MODE == A_GATHER, spatial = MODE == A_SPATIAL;
  extern __shared__ uint8_t smem_raw[];
  // the ring at the first 1024-byte boundary (offsetting the shared array
  // keeps its address space known: the staging goes through st.shared)
  uint8_t* ring =
      smem_raw + ((1024 - (locov::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* staging = ring + C::RING;
  int4* rowinfo = reinterpret_cast<int4*>(staging + 8 * STAGE_WARP);
  int* rowms = reinterpret_cast<int*>(rowinfo + BM);
  uint64_t* full = reinterpret_cast<uint64_t*>(rowms + BM);
  uint64_t* empty = full + C::STAGES;

  const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      // gather: 128 cp.async arrivals and thread 0's expect_tx for B
      mbar_init(full + s, gather ? 129 : 1);
      mbar_init(empty + s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // ---------------------------------------------------- producer
    if (!gather && t != 0) return;
    int stage = 0;
    unsigned phase = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const Tile tl = tile_of<spatial>(p, tile, BN);
      const int m0 = tl.m0, n0 = tl.n0;
      if constexpr (gather) {
        producer_sync();  // every thread is past the last tile's rows
        const int m = m0 + t;
        const int mm = m < p.m ? m : 0;
        const int ow = mm % p.ow, r = mm / p.ow;
        rowinfo[t] = make_int4((r / p.oh) * p.h * p.w,
                               (r % p.oh) * p.stride - p.pad,
                               ow * p.stride - p.pad, m < p.m);
        producer_sync();
      }
      for (int kt = 0; kt < p.ktiles; ++kt) {
        mbar_wait(empty + stage, phase ^ 1);
        uint8_t* a = ring + stage * C::STAGE_BYTES;
        uint8_t* b = a + C::A_BYTES;
        if (t == 0) {
          const int a_bytes =
              gather ? 0 : spatial ? p.rows * BK : C::A_BYTES;
          mbar_expect_tx(full + stage, C::B_BYTES + a_bytes);
          tma_load(b, &map_b, kt * BK, n0, full + stage);
          if constexpr (spatial) {
            const int tap = kt / p.ctiles;
            const int ky = tap / p.kw, kx = tap - ky * p.kw;
            tma_load4(a, &map_a, (kt - tap * p.ctiles) * BK,
                      tl.ow0 + kx - p.pad, tl.oh0 + ky - p.pad, tl.nn0,
                      full + stage);
          } else if constexpr (!gather) {
            tma_load(a, &map_a, kt * BK, m0, full + stage);
          }
        }
        if constexpr (gather) {
          const int piece = t & 7;
          const int k = kt * BK + piece * 16;
          const bool kin = k < p.k;
          const int tap = kin ? k / p.c : 0;
          const int c = k - tap * p.c;
          const int ky = tap / p.kw, kx = tap - ky * p.kw;
          const int swz = (piece ^ ((t >> 3) & 7)) << 4;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = (t >> 3) + 16 * i;
            const int4 ri = rowinfo[r];
            const int ih = ri.y + ky, iw = ri.z + kx;
            const bool v = kin && ri.w && ih >= 0 && ih < p.h && iw >= 0 &&
                           iw < p.w;
            const int8_t* src =
                v ? p.xq + (long long)(ri.x + ih * p.w + iw) * p.c + c : p.xq;
            cp_async16(a + r * BK + swz, src, v);
          }
          cp_async_arrive(full + stage);
        }
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---------------------------------------------------- consumers
    const int cw = wgi - 1, warp = t >> 5, lane = t & 31;
    uint8_t* stg = staging + (cw * 4 + warp) * STAGE_WARP;
    const QScale qs =
        p.e.qout != nullptr ? quant_scale(p.e.amax) : QScale{1.f, 1.f};
    int stage = 0;
    unsigned phase = 0;
    int* rowm = rowms + cw * 64 + warp * 16;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const Tile tl = tile_of<spatial>(p, tile, BN);
      const int n0 = tl.n0, mrow = tl.m0 + cw * 64 + warp * 16;
      if constexpr (spatial) {
        // the output rows of this warp's 16 tile rows (for the epilogue)
        if (lane < 16)
          rowm[lane] = row_m(p, tl, cw * 64 + warp * 16 + lane);
        __syncwarp();
      }
      prefetch_residual<T, BN, spatial>(p, mrow, rowm, n0, lane);
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev = 0;
      for (int kt = 0; kt < p.ktiles; ++kt) {
        mbar_wait(full + stage, phase);
        // the gathered pieces were written by the generic proxy
        if constexpr (gather)
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint8_t* a = ring + stage * C::STAGE_BYTES + cw * 64 * BK;
        const uint8_t* b = ring + stage * C::STAGE_BYTES + C::A_BYTES;
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma<BN>(acc, desc(a + kk * 32), desc(b + kk * 32));
        wgmma_commit();
        // the products of the step before are done: free its stage
        wgmma_wait<1>();
        fence_operands(acc);
        if (kt > 0 && lane == 0) mbar_arrive(empty + prev);
        prev = stage;
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(empty + prev);
      epilogue<T, BN, spatial>(acc, p, stg, mrow, rowm, n0, lane, qs);
    }

  }
}

// an int8 [rows, cols] row-major map whose box is box_rows x 128 bytes in
// the 128-byte swizzle (reads past the edges give zeros)
bool make_map(CUtensorMap* map, const void* base, uint64_t cols,
              uint64_t rows, uint32_t box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {cols, rows};
  cuuint64_t strides[1] = {cols};
  cuuint32_t box[2] = {BK, box_rows};
  cuuint32_t steps[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the 4-D map of xq [n, h, w, c] seen at the conv's stride (dims c, w / s,
// h / s, n, rounded up), whose box is 128 channels of tw x th pixels of
// tn images in the 128-byte swizzle
bool make_map4(CUtensorMap* map, const Params& p) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const uint64_t s = p.stride, c = p.c;
  cuuint64_t dims[4] = {c, (p.w + s - 1) / s, (p.h + s - 1) / s,
                        (cuuint64_t)p.n};
  cuuint64_t strides[3] = {s * c, s * p.w * c, (uint64_t)p.h * p.w * c};
  cuuint32_t box[4] = {BK, (cuuint32_t)p.tw, (cuuint32_t)p.th,
                       (cuuint32_t)p.tn};
  cuuint32_t steps[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(p.xq),
            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int BN, int MODE>
int launch(const void* wq, Params p, cudaStream_t stream) {
  using C = Cfg<BN>;
  CUtensorMap map_a, map_b;
  memset(&map_a, 0, sizeof(map_a));
  if (!make_map(&map_b, wq, p.k, p.o, BN)) return ENCODE_FAILED;
  if (p.spatial ? !make_map4(&map_a, p)
                : !p.gather && !make_map(&map_a, p.xq, p.c, (uint64_t)p.m, BM))
    return ENCODE_FAILED;
  p.ntiles = (p.o + BN - 1) / BN;
  p.tiles = (p.spatial ? p.tiles_w * p.tiles_h * ((p.n + p.tn - 1) / p.tn)
                       : (p.m + BM - 1) / BM) *
            p.ntiles;
  auto kernel = conv_int8_wgmma<T, BN, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = p.tiles < sms ? p.tiles : sms;
  kernel<<<grid, THREADS, C::SMEM, stream>>>(map_a, map_b, p);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch_bn(const void* wq, const Params& p, cudaStream_t stream) {
  if (p.o % 256 == 0) return launch<T, 256, MODE>(wq, p, stream);
  if (p.o % 128 == 0) return launch<T, 128, MODE>(wq, p, stream);
  return launch<T, 64, MODE>(wq, p, stream);
}

template <typename T>
int launch_mode(const void* wq, const Params& p, cudaStream_t stream) {
  if (p.spatial) return launch_bn<T, A_SPATIAL>(wq, p, stream);
  if (p.gather) return launch_bn<T, A_GATHER>(wq, p, stream);
  return launch_bn<T, A_GEMM>(wq, p, stream);
}

}  // namespace wg

}  // namespace

// The C entry: xq int8 [n, h, w, c], wq int8 [o, kh, kw, c], scale
// float32 [o], shift [o] of `dtype` (0 = float32, 1 = bfloat16), and of
// the outputs [n, oh, ow, o]: `residual` (of dtype, or null), `out` (of
// dtype, or null) and `qout` (int8, or null; with `amax`, a 0-dim float32
// tensor), every operand contiguous and on the current device; c a
// multiple of 16 and xq, wq and residual 16-byte aligned (the tensor
// maps' row pitch and the 16-byte gathers). Returns the launch's error,
// or cudaGetLastError() after it, or 1001 where a tensor map cannot be
// encoded.
extern "C" int conv_int8_fwd(const void* xq, const void* wq,
                             const void* scale, const void* shift,
                             const void* residual, void* out, void* qout,
                             const void* amax, int n, int h, int w, int c,
                             int o, int kh, int kw, int stride, int pad,
                             int oh, int ow, int relu, int dtype,
                             void* stream) {
  wg::Params p;
  p.xq = static_cast<const int8_t*>(xq);
  p.e = Epi{static_cast<const float*>(scale), shift, residual, out,
            static_cast<int8_t*>(qout), static_cast<const float*>(amax),
            relu};
  p.h = h;
  p.w = w;
  p.c = c;
  p.o = o;
  p.kw = kw;
  p.stride = stride;
  p.pad = pad;
  p.oh = oh;
  p.ow = ow;
  p.m = n * oh * ow;
  p.k = kh * kw * c;
  p.ktiles = (p.k + wg::BK - 1) / wg::BK;
  p.n = n;
  // A by 4-D TMA boxes of output pixels where each k step is one tap's
  // 128 channels and the taps read the input at the output's stride:
  // the 3x3 / 1 / pad 1 and 1x1 / 2 convs of the trunk and res5 (C a
  // multiple of 128); by a 2-D box where the conv is a plain GEMM; else
  // by the producers' cp.async gather
  p.spatial = c % 128 == 0 && ((kh == 3 && kw == 3 && stride == 1 &&
                                pad == 1) ||
                               (kh == 1 && kw == 1 && stride == 2 &&
                                pad == 0));
  p.gather = !p.spatial && !(kh == 1 && kw == 1 && stride == 1 && pad == 0);
  p.ctiles = c / wg::BK;
  p.tw = p.th = p.tn = p.tiles_w = p.tiles_h = 1;
  p.rows = wg::BM;
  if (p.spatial) {
    if (oh * ow <= 64) {  // whole images: res5's 7 x 7
      p.tw = ow;
      p.th = oh;
      p.tn = wg::BM / (oh * ow);
    } else {  // 16 x 8 pixels, or narrower images' whole rows
      p.tw = ow < 16 ? ow : 16;
      p.th = oh < wg::BM / p.tw ? oh : wg::BM / p.tw;
    }
    p.rows = p.tw * p.th * p.tn;
    p.tiles_w = (ow + p.tw - 1) / p.tw;
    p.tiles_h = (oh + p.th - 1) / p.th;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return wg::launch_mode<float>(wq, p, s);
  return wg::launch_mode<__nv_bfloat16>(wq, p, s);
}
