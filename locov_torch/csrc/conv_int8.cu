// KQ1: int8 convolution with int32 sums and a fused dequantize epilogue,
// NHWC, as an implicit GEMM on the tensor cores.
//
// The int8 serving mode's trunk and res5 convolutions
// (locov_torch/ops/int8_conv.py). It has no Pallas parent: the JAX
// package computes this conv in XLA (locov_tpu/ops/int8_conv.py:
// conv_int8), and PyTorch has no int8 convolution on CUDA.
//
// out[m, o] = epi(sum_k A[m, k] * B[o, k]) with m = (n, oh, ow) an output
// pixel, k = (ky, kx, c) a tap and input channel, A[m, k] = xq[n, oh *
// stride - pad + ky, ow * stride - pad + kx, c] (0 outside the image) and
// B = wq [O, kh, kw, C] (k contiguous, the mma's col-major B operand).
// epi(acc) = relu?(T(f32(acc) * scale[o]) + shift[o]), T the output type
// (float32 or bfloat16): the product rounded to float32, then once to T,
// the shift added in float32 and rounded to T again, as the plain
// version's `(acc.float() * scale).to(T) + shift` does; relu writes +0
// for anything not above 0, as PyTorch's relu does on CUDA.
//
// Bound on the H100: operations. res5 on 8,000 boxes is ~11.7 TOP of
// int8 products a batch: 5.9 ms at the 1,979 TOP/s dense int8 peak,
// against 11.9 ms in bf16. This first kernel is the simple form: a block
// takes a 128 x 128 output tile; its A and B tiles (64 bytes of k a row)
// come through a ring of three shared-memory stages by cp.async of VEC
// bytes (16 where C is a multiple of 16; 8 or 4 for narrower models),
// with zero fill for the padding, the ragged M and O edges and C past the
// tap's channels, two stages ahead of the products; eight warps in a 2
// x 4 grid each take 64 x 32 of the tile as 4 x 4 m16n8k32 mma.sync
// products (int8 x int8 -> int32). The epilogue reads the accumulators
// from registers and stores two channels at a time. wgmma and the
// quantize fused into the A-tile load are later work.
//
// mma.m16n8k32 .s8 fragment layouts (PTX ISA), g = lane / 4, q = lane % 4:
//   A (16 x 32, row-major): a0 = row g, k 4q .. 4q+3; a1 = row g+8, the
//     same k; a2 = row g, k 16+4q ..; a3 = row g+8, k 16+4q ..
//   B (32 x 8, col-major): b0 = col g, k 4q .. 4q+3; b1 = col g, k 16+4q ..
//   C (16 x 8, s32): c0, c1 = row g, cols 2q, 2q+1; c2, c3 = row g+8.
#include <stdint.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3, THREADS = 256;
constexpr int SROW = BK + 16;  // a staged row in bytes: 16-byte aligned,
                               // its 32-bit words spread over the banks
constexpr int TILE_BYTES = (BM + BN) * SROW;
constexpr int SMEM = STAGES * TILE_BYTES;

// cp.async of VEC bytes (16, 8 or 4); zeros where `valid` is false
template <int VEC>
__device__ __forceinline__ void copy_piece(void* dst, const void* src,
                                           bool valid) {
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     locov::smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     locov::smem_u32(dst)),
                 "l"(src), "n"(VEC), "r"(valid ? VEC : 0));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Geom {
  int n, h, w, c, o, kw, taps, stride, pad, oh, ow, m, ctiles, ktiles;
};

// One output pixel row of the A tile: where its window starts.
struct Row {
  int base;  // n * h * w
  int ih0, iw0;
  bool valid;
};

__device__ __forceinline__ Row row_of(const Geom& g, int m) {
  Row r;
  r.valid = m < g.m;
  const int mm = r.valid ? m : 0;
  const int ow = mm % g.ow, t = mm / g.ow;
  const int oh = t % g.oh, n = t / g.oh;
  r.base = n * g.h * g.w;
  r.ih0 = oh * g.stride - g.pad;
  r.iw0 = ow * g.stride - g.pad;
  return r;
}

// The tile rows a thread stages: piece tid % PIECES of rows tid / PIECES
// + i * (THREADS / PIECES).
template <int VEC>
struct Pieces {
  static constexpr int PIECES = BK / VEC;             // pieces a row
  static constexpr int PASSES = BM * PIECES / THREADS;  // rows a thread
};

// Stage k tile `kt` (one tap, BK channels) of A and B into `buf`: each
// thread copies PASSES pieces of VEC bytes of each.
template <int VEC>
__device__ __forceinline__ void load_tile(
    uint8_t* buf, const int8_t* __restrict__ xq,
    const int8_t* __restrict__ wq, const Geom& g,
    const Row (&rows)[Pieces<VEC>::PASSES], int o0, int kt, int tid) {
  constexpr int PIECES = Pieces<VEC>::PIECES;
  const int tap = kt / g.ctiles;
  const int piece = (tid % PIECES) * VEC;
  const int c = (kt % g.ctiles) * BK + piece;
  const int ky = tap / g.kw, kx = tap % g.kw;
  const bool cin = c < g.c;
#pragma unroll
  for (int i = 0; i < Pieces<VEC>::PASSES; ++i) {
    const int r = tid / PIECES + i * (THREADS / PIECES);
    const Row& rw = rows[i];
    const int ih = rw.ih0 + ky, iw = rw.iw0 + kx;
    const bool va = cin && rw.valid && ih >= 0 && ih < g.h && iw >= 0 &&
                    iw < g.w;
    const int8_t* src =
        va ? xq + ((long long)(rw.base + ih * g.w + iw)) * g.c + c : xq;
    copy_piece<VEC>(buf + r * SROW + piece, src, va);
    const int o = o0 + r;
    const bool vb = cin && o < g.o;
    const int8_t* wsrc =
        vb ? wq + ((long long)o * g.taps + tap) * g.c + c : wq;
    copy_piece<VEC>(buf + BM * SROW + r * SROW + piece, wsrc, vb);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <typename T>
__device__ __forceinline__ T epi(int acc, float scale, T shift, bool relu) {
  const T r = locov::from_f32<T>(__fmul_rn(__int2float_rn(acc), scale));
  float s = __fadd_rn(locov::to_f32(r), locov::to_f32(shift));
  if (relu) s = s > 0.f ? s : 0.f;
  return locov::from_f32<T>(s);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* out, long long m, int o,
                                           int nout, T v0, T v1) {
  T* p = out + m * nout + o;
  if (o + 1 < nout && !(nout & 1)) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      __nv_bfloat162 v;
      v.x = v0;
      v.y = v1;
      *reinterpret_cast<__nv_bfloat162*>(p) = v;
    }
  } else {
    if (o < nout) p[0] = v0;
    if (o + 1 < nout) p[1] = v1;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
    conv_int8_kernel(const int8_t* __restrict__ xq,
                     const int8_t* __restrict__ wq,
                     const float* __restrict__ scale,
                     const T* __restrict__ shift, T* __restrict__ out,
                     Geom g, bool relu) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int m0 = blockIdx.x * BM, o0 = blockIdx.y * BN;

  constexpr int PIECES = Pieces<VEC>::PIECES;
  Row rows[Pieces<VEC>::PASSES];
#pragma unroll
  for (int i = 0; i < Pieces<VEC>::PASSES; ++i)
    rows[i] = row_of(g, m0 + tid / PIECES + i * (THREADS / PIECES));

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < g.ktiles)
      load_tile<VEC>(smem + s * TILE_BYTES, xq, wq, g, rows, o0, s, tid);
    else
      asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < g.ktiles; ++kt) {
    // tile kt is in, and every warp is done with the stage refilled next
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < g.ktiles)
      load_tile<VEC>(smem + (nk % STAGES) * TILE_BYTES, xq, wq, g, rows, o0,
                     nk, tid);
    else
      asm volatile("cp.async.commit_group;\n" ::);

    const uint8_t* As = smem + (kt % STAGES) * TILE_BYTES;
    const uint8_t* Bs = As + BM * SROW;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* p = As + (wm * 64 + i * 16 + gq) * SROW + kk + 4 * q;
        a[i][0] = *reinterpret_cast<const unsigned*>(p);
        a[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * SROW);
        a[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * SROW + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* p = Bs + (wn * 32 + j * 8 + gq) * SROW + kk + 4 * q;
        b[j][0] = *reinterpret_cast<const unsigned*>(p);
        b[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + wn * 32 + j * 8 + 2 * q;
    const float s0 = o < g.o ? scale[o] : 0.f;
    const float s1 = o + 1 < g.o ? scale[o + 1] : 0.f;
    const T h0 = o < g.o ? shift[o] : locov::from_f32<T>(0.f);
    const T h1 = o + 1 < g.o ? shift[o + 1] : locov::from_f32<T>(0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 64 + i * 16 + gq + 8 * half;
        if (m >= g.m) continue;
        store_pair(out, (long long)m, o, g.o,
                   epi(acc[i][j][2 * half], s0, h0, relu),
                   epi(acc[i][j][2 * half + 1], s1, h1, relu));
      }
    }
  }
}

template <typename T, int VEC>
int launch(const void* xq, const void* wq, const void* scale,
           const void* shift, void* out, const Geom& g, bool relu,
           cudaStream_t stream) {
  auto kernel = conv_int8_kernel<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.m + BM - 1) / BM, (g.o + BN - 1) / BN);
  kernel<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const T*>(shift),
      static_cast<T*>(out), g, relu);
  return (int)cudaGetLastError();
}

}  // namespace

template <typename T>
int launch_vec(const void* xq, const void* wq, const void* scale,
               const void* shift, void* out, const Geom& g, bool relu,
               int vec, cudaStream_t stream) {
  if (vec == 16)
    return launch<T, 16>(xq, wq, scale, shift, out, g, relu, stream);
  if (vec == 8)
    return launch<T, 8>(xq, wq, scale, shift, out, g, relu, stream);
  return launch<T, 4>(xq, wq, scale, shift, out, g, relu, stream);
}

// xq int8 [n, h, w, c], wq int8 [o, kh, kw, c], scale float32 [o],
// shift [o] and out [n, oh, ow, o] of `dtype` (0 = float32, 1 =
// bfloat16), every operand contiguous; `vec` (16, 8 or 4) divides c and
// the addresses of xq and wq: the bytes of a staged piece. Returns the
// launch's error, or cudaGetLastError() after it.
extern "C" int conv_int8_fwd(const void* xq, const void* wq,
                             const void* scale, const void* shift, void* out,
                             int n, int h, int w, int c, int o, int kh,
                             int kw, int stride, int pad, int oh, int ow,
                             int relu, int dtype, int vec, void* stream) {
  Geom g;
  g.n = n;
  g.h = h;
  g.w = w;
  g.c = c;
  g.o = o;
  g.kw = kw;
  g.taps = kh * kw;
  g.stride = stride;
  g.pad = pad;
  g.oh = oh;
  g.ow = ow;
  g.m = n * oh * ow;
  g.ctiles = (c + BK - 1) / BK;
  g.ktiles = g.taps * g.ctiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_vec<float>(xq, wq, scale, shift, out, g, relu != 0, vec, s);
  return launch_vec<__nv_bfloat16>(xq, wq, scale, shift, out, g, relu != 0,
                                   vec, s);
}
