// ResNet stem conv, 7x7 / stride 2 / pad 3 over 3 channels, plus the
// FrozenBN shift, NHWC:
//
//   out[n, oy, ox, f] = bf16(sum_{ky, kx, c} bf16(x)[n, 2oy-3+ky, 2ox-3+kx, c]
//                                            * bf16(w)[ky, kx, c, f]
//                            + shift[f])
//
// with the sum in f32 and one rounding at the end. Replaces the TPU
// kernels of locov_tpu/ops/pallas_stem.py (launched by _fwd_impl, behind
// stem_conv_bn): the four TPU variants are layouts of this one function.
// Their St4 space-to-depth repack answered the TPU's 128-lane layout,
// which this card does not have, so it is not carried over.
//
// Bound on this card: at [4, 800, 1344, 3] -> [4, 400, 672, 64] the
// conv reads x once (26 MB in bf16) and writes the output once (138 MB)
// for 20 GFLOP: bound by bytes (0.049 ms); the 20 GFLOP alone would take
// 0.30 ms on the CUDA cores, so the products run on the tensor cores.
//
// Design: a direct implicit GEMM. A block (8 warps) walks over tiles of
// (image, 8 output rows, 16 output columns), keeping the [160, F] bf16
// weight matrix (147 rows (ky, kx, c) in HWIO order, zero-padded to a
// multiple of 16) in shared memory for all its tiles. For each tile it
// stages the [21 x 37 x 3] input patch (zeros outside the image), forms
// the [128 pixels, 160] patch matrix in shared memory, multiplies it on
// the tensor cores (mma.sync m16n8k16, f32 accumulators; warp w owns
// output row w), adds the shift, rounds, stages the [128, F] tile and
// stores it as 16-byte vectors (16 pixels x F channels are contiguous in
// NHWC). Any even H and W; F 32, 64 or 128.
#include <stdint.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TR = 8;            // output rows of a tile
constexpr int TC = 16;           // output columns of a tile
constexpr int NO = TR * TC;      // output pixels of a tile
constexpr int PR = 2 * TR + 5;   // input rows of a tile's patch (21)
constexpr int PC = 2 * TC + 5;   // input columns (37)
constexpr int CIN = 3;
constexpr int KTAP = 7 * CIN;    // patch-matrix columns of one kernel row
constexpr int K = 7 * KTAP;      // 147
constexpr int KP = 160;          // K padded to a multiple of 16
constexpr int LDA = KP + 8;      // patch-matrix row (16-byte aligned)
constexpr int NPATCH = 2336;     // PR * PC * CIN = 2331, rounded up to 8
constexpr int THREADS = 256;

template <int F>
struct Layout {
  static constexpr int LDW = F + 8;  // weight rows
  static constexpr int LDO = F + 8;  // output-tile rows
  static constexpr int W = 0, A = KP * LDW, P = A + NO * LDA,
                       O = P + NPATCH;
  static constexpr size_t BYTES = (size_t)(O + NO * LDO) * sizeof(bf16);
};

__device__ __forceinline__ bf16 to_bf16(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }

template <typename TX, int F>
__global__ void __launch_bounds__(THREADS)
    stem_conv_kernel(const TX* __restrict__ x, const bf16* __restrict__ w,
                     const float* __restrict__ shift, bf16* __restrict__ out,
                     int h, int wd, int ho, int wo, int tiles_x, int tiles_y,
                     int tiles) {
  using L = Layout<F>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem) + L::W;  // [KP][LDW]
  bf16* as = reinterpret_cast<bf16*>(smem) + L::A;  // [NO][LDA]
  bf16* ps = reinterpret_cast<bf16*>(smem) + L::P;  // [PR][PC][CIN]
  bf16* os = reinterpret_cast<bf16*>(smem) + L::O;  // [NO][LDO]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16 zero = __float2bfloat16(0.0f);

  // the weights, rows K .. KP-1 zero; the patch matrix's pad columns zero
  for (int i = tid; i < KP * (F / 8); i += THREADS) {
    const int r = i / (F / 8), v = i - r * (F / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < K) val = *reinterpret_cast<const uint4*>(w + r * F + v * 8);
    *reinterpret_cast<uint4*>(ws + r * L::LDW + v * 8) = val;
  }
  for (int i = tid; i < NO * (KP - K); i += THREADS)
    as[(i / (KP - K)) * LDA + K + i % (KP - K)] = zero;
  // this thread's shift values: columns nt * 8 + 2 (lane % 4) + {0, 1}
  float sh[F / 8][2];
#pragma unroll
  for (int nt = 0; nt < F / 8; ++nt) {
    sh[nt][0] = shift[nt * 8 + 2 * (lane & 3)];
    sh[nt][1] = shift[nt * 8 + 2 * (lane & 3) + 1];
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % tiles_x;
    const int ty = (tile / tiles_x) % tiles_y;
    const long long n = tile / (tiles_x * tiles_y);
    const int oy0 = ty * TR, ox0 = tx * TC;
    const int iy0 = 2 * oy0 - 3, ix0 = 2 * ox0 - 3;
    __syncthreads();  // the last tile's patch and output tile are read
    // the input patch, rounded to bf16, zeros outside the image
    for (int i = tid; i < PR * PC * CIN; i += THREADS) {
      const int r = i / (PC * CIN), e = i - r * (PC * CIN);
      const int iy = iy0 + r, ix = ix0 + e / CIN;
      bf16 v = zero;
      if (iy >= 0 && iy < h && ix >= 0 && ix < wd)
        v = to_bf16(x[((n * h + iy) * wd + ix) * CIN + e % CIN]);
      ps[i] = v;
    }
    __syncthreads();
    // patch matrix: row p = (r, c), columns ky * 21 + (kx * 3 + ch) hold
    // the 21 contiguous patch values of input row 2r + ky from column 2c
    for (int i = tid; i < NO * 7; i += THREADS) {
      const int p = i / 7, ky = i - p * 7;
      const int r = p / TC, c = p - r * TC;
      const bf16* src = ps + ((2 * r + ky) * PC + 2 * c) * CIN;
      bf16* dst = as + p * LDA + ky * KTAP;
#pragma unroll
      for (int e = 0; e < KTAP; ++e) dst[e] = src[e];
    }
    __syncthreads();
    float acc[F / 8][4];
#pragma unroll
    for (int nt = 0; nt < F / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    const bf16* arow = as + (warp * 16 + (lane & 15)) * LDA + 8 * (lane >> 4);
#pragma unroll
    for (int k0 = 0; k0 < KP; k0 += 16) {
      unsigned a[4];
      locov::ldmatrix_a(a, arow + k0);
#pragma unroll
      for (int j = 0; j < F / 16; ++j) {
        unsigned b[4];
        locov::ldmatrix_b2(b, ws + (k0 + (lane & 15)) * L::LDW + 16 * j +
                                  8 * (lane >> 4));
        locov::mma_bf16(acc[2 * j], a, b[0], b[1]);
        locov::mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
    // + shift in f32, one rounding, into the output tile
#pragma unroll
    for (int nt = 0; nt < F / 8; ++nt) {
      const int col = nt * 8 + 2 * (lane & 3);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = warp * 16 + (lane >> 2) + 8 * hh;
        *reinterpret_cast<__nv_bfloat162*>(os + p * L::LDO + col) =
            __floats2bfloat162_rn(acc[nt][2 * hh] + sh[nt][0],
                                  acc[nt][2 * hh + 1] + sh[nt][1]);
      }
    }
    __syncthreads();
    for (int i = tid; i < NO * (F / 8); i += THREADS) {
      const int p = i / (F / 8), v = i - p * (F / 8);
      const int oy = oy0 + p / TC, ox = ox0 + p % TC;
      if (oy < ho && ox < wo)
        *reinterpret_cast<uint4*>(out + ((n * ho + oy) * wo + ox) * F +
                                  v * 8) =
            *reinterpret_cast<const uint4*>(os + p * L::LDO + v * 8);
    }
  }
}

template <typename TX, int F>
int launch(const void* x, const void* w, const void* shift, void* out,
           int n, int h, int wd, cudaStream_t stream) {
  auto kernel = stem_conv_kernel<TX, F>;
  const int bytes = (int)Layout<F>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, bytes)) != cudaSuccess)
    return (int)err;
  const int ho = h / 2, wo = wd / 2;
  const int tiles_x = (wo + TC - 1) / TC, tiles_y = (ho + TR - 1) / TR;
  const long long tiles = (long long)tiles_x * tiles_y * n;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // persistent blocks: each loads the weights once and walks its tiles
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(tiles < resident ? tiles : resident);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const TX*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(shift), static_cast<bf16*>(out), h, wd, ho,
      wo, tiles_x, tiles_y, (int)tiles);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_f(const void* x, const void* w, const void* shift, void* out,
             int n, int h, int wd, int f, cudaStream_t s) {
  if (f == 32) return launch<TX, 32>(x, w, shift, out, n, h, wd, s);
  if (f == 64) return launch<TX, 64>(x, w, shift, out, n, h, wd, s);
  if (f == 128) return launch<TX, 128>(x, w, shift, out, n, h, wd, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [n, h, w, 3] (dtype 0 = float32, 1 = bfloat16; h, w even), w
// [7, 7, 3, f] bfloat16 (HWIO, BN-folded), shift [f] float32 -> out
// [n, h/2, w/2, f] bfloat16; f 32, 64 or 128; w and out 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int stem_conv_bn_fwd(const void* x, const void* w,
                                const void* shift, void* out, int n, int h,
                                int wd, int f, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 0 || wd <= 0 || h % 2 || wd % 2) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_f<float>(x, w, shift, out, n, h, wd, f, s);
  if (dtype == 1) return launch_f<bf16>(x, w, shift, out, n, h, wd, f, s);
  return (int)cudaErrorInvalidValue;
}
