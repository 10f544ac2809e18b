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
// for 20 GFLOP: bound by bytes (0.049 ms), 84% of them the output; the
// products run on the tensor cores (mma.sync m16n8k16, f32
// accumulators), where the 20 GFLOP take about 0.03 ms.
//
// Design: a direct implicit GEMM with no patch matrix. The contraction
// index k runs over 7 segments (ky) of 24: 3 zero-weight slots, then the
// 21 values (kx, c) of one input row, which lie contiguous in NHWC x.
// For output pixel (r, c) of a tile, segment ky is then the 24
// contiguous values of patch row 2r + ky from element 6c, so each pair
// of k that an A fragment register holds is one aligned 4-byte word of
// the staged patch (8 bytes for float32 x, rounded to bf16 on the way
// to the register): A fragments are read straight from the patch. The
// weights are repacked in that order on the host
// (ops/stem_conv_bn.py:_pack_weights, [176, F], zero rows at the three
// lead slots of each segment and at 168..175), and each warp keeps its
// 32 output channels' B fragments in registers for the kernel's life.
// The three lead slots hold the previous pixel's values (or zeros
// outside the image); they are masked to 0 in the fragment, so a
// non-finite x there cannot reach an output it is not a tap of.
//
// A persistent block (4 warps) walks tiles of (image, 8 output rows, 16
// output columns): warp w takes 32 output channels and every (F / 32)-th
// tile row. The [21 x 114] input patch of each tile is staged by
// cp.async (4-byte pieces, 8 for float32; the image's zero padding by
// the zero fill) into a ring of three buffers, two tiles ahead of the
// products, with one barrier a tile. The epilogue adds the shift in f32,
// rounds once, swaps fragments within each quad of lanes so that a lane
// holds 8 consecutive channels, and stores them as 16-byte streaming
// stores, straight from registers. Any even H and W; F 32, 64 or 128.
#include <stdint.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using locov::pack_bf16;

constexpr int TR = 8;                 // output rows of a tile
constexpr int TC = 16;                // output columns of a tile (one M tile)
constexpr int PR = 2 * TR + 5;        // input rows of a tile's patch (21)
constexpr int PW = 6 * TC + 18;       // patch row: 2 TC + 6 pixels x 3 (114)
constexpr int STAGES = 3;             // patch buffers in the ring
constexpr int KSEG = 24;              // k slots of one kernel row
constexpr int KSTEPS = 11;            // 7 * KSEG = 168 k, padded to 176
constexpr int HALVES = 7 * KSEG / 8;  // 8-wide k halves that hold data (21)
constexpr int THREADS = 128;
constexpr int CH_WARP = 32;           // output channels of a warp

// 2 patch elements, read as one bf16 pair
__device__ __forceinline__ uint32_t pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// cp.async of 2 elements (4 or 8 bytes); zeros where `valid` is false
template <typename TX>
__device__ __forceinline__ void copy_pair(TX* dst, const TX* src,
                                          bool valid) {
  constexpr int bytes = 2 * sizeof(TX);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   locov::smem_u32(dst)),
               "l"(src), "n"(bytes), "r"(valid ? bytes : 0));
}

// Quad transpose: lane q of a quad holds p[j] = its word of n tile j;
// after it p[i] = lane i's word of n tile q, i.e. channels 8 q + 2 i, +1.
__device__ __forceinline__ void quad_transpose(uint32_t (&p)[4], int q) {
  const bool odd = q & 1, high = q & 2;
  uint32_t r = __shfl_xor_sync(0xffffffffu, odd ? p[0] : p[1], 1);
  if (odd) p[0] = r; else p[1] = r;
  r = __shfl_xor_sync(0xffffffffu, odd ? p[2] : p[3], 1);
  if (odd) p[2] = r; else p[3] = r;
  r = __shfl_xor_sync(0xffffffffu, high ? p[0] : p[2], 2);
  if (high) p[0] = r; else p[2] = r;
  r = __shfl_xor_sync(0xffffffffu, high ? p[1] : p[3], 2);
  if (high) p[1] = r; else p[3] = r;
}

struct Tile {
  long long n;
  int oy0, ox0;
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int tiles_y) {
  return {t / (tiles_x * tiles_y), (t / tiles_x) % tiles_y * TR,
          t % tiles_x * TC};
}

// Stage tile t's patch: rows 2 oy0 - 3 .., elements from pixel
// 2 ox0 - 4 (even, so that every piece is an aligned pair of the image
// row, wholly inside or outside it).
template <typename TX>
__device__ __forceinline__ void load_patch(TX* buf, const TX* __restrict__ x,
                                           Tile t, int h, int wd) {
  const int iy0 = 2 * t.oy0 - 3, e0 = 3 * (2 * t.ox0 - 4);
  for (int i = threadIdx.x; i < PR * (PW / 2); i += THREADS) {
    const int r = i / (PW / 2), e = e0 + 2 * (i - r * (PW / 2));
    const int iy = iy0 + r;
    const bool valid = iy >= 0 && iy < h && e >= 0 && e < 3 * wd;
    const TX* src = valid ? x + ((t.n * h + iy) * wd * 3 + e) : x;
    copy_pair(buf + r * PW + (e - e0), src, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <typename TX, int F>
__global__ void __launch_bounds__(THREADS, 3)
    stem_conv_kernel(const TX* __restrict__ x, const bf16* __restrict__ wp,
                     const float* __restrict__ shift, bf16* __restrict__ out,
                     int h, int wd, int ho, int wo, int tiles_x, int tiles_y,
                     int tiles) {
  constexpr int CGS = F / CH_WARP;  // warps over the channels
  constexpr int RSTEP = 4 / CGS;    // warps over the tile rows
  __shared__ __align__(16) TX patch[STAGES][PR * PW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int c0 = (warp % CGS) * CH_WARP;

  // B fragments of this warp's channels, all k: b[s][j] = (k 16 s + 2 q,
  // +1; col c0 + 8 j + g) and (k + 8, + 9; the same col)
  uint32_t b[KSTEPS][4][2];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const bf16* p = wp + (16 * s + 8 * hh + 2 * q) * F + c0 + 8 * j + g;
        const __nv_bfloat162 v = __halves2bfloat162(p[0], p[F]);
        b[s][j][hh] = *reinterpret_cast<const uint32_t*>(&v);
      }
  float sh[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sh[j][0] = shift[c0 + 8 * j + 2 * q];
    sh[j][1] = shift[c0 + 8 * j + 2 * q + 1];
  }
  // the three lead slots of a segment: k 0, 1 (lane q 0) and 2 (q 1)
  const uint32_t lead_mask = q == 0 ? 0u : q == 1 ? 0xffff0000u : ~0u;

  int t = blockIdx.x;
  for (int s = 0; s < STAGES - 1; ++s, t += gridDim.x) {
    if (t < tiles)
      load_patch(patch[s], x, tile_at(t, tiles_x, tiles_y), h, wd);
    else
      asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int i = 0, tile = blockIdx.x; tile < tiles;
       ++i, tile += gridDim.x, t += gridDim.x) {
    // this tile's pieces are in (the next tile's may be in flight), and
    // every warp is done with the buffer refilled below
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    if (t < tiles)
      load_patch(patch[(i + STAGES - 1) % STAGES], x,
                 tile_at(t, tiles_x, tiles_y), h, wd);
    else
      asm volatile("cp.async.commit_group;\n" ::);

    const TX* buf = patch[i % STAGES];
    const Tile tl = tile_at(tile, tiles_x, tiles_y);
    for (int r = warp / CGS; r < TR; r += RSTEP) {
      const int oy = tl.oy0 + r;
      if (oy >= ho) break;
      const TX* arow = buf + 2 * r * PW + 6 * g + 2 * q;
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        unsigned a[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int u = 2 * s + hh;  // k half: segment u / 3, piece u % 3
          if (u < HALVES) {
            const int off = (u / 3) * PW + 8 * (u % 3);
            a[2 * hh] = pair(arow + off);           // row g
            a[2 * hh + 1] = pair(arow + off + 48);  // row g + 8
            if (u % 3 == 0) {
              a[2 * hh] &= lead_mask;
              a[2 * hh + 1] &= lead_mask;
            }
          } else {
            a[2 * hh] = a[2 * hh + 1] = 0u;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          locov::mma_bf16(acc[j], a, b[s][j][0], b[s][j][1]);
      }
      // + shift in f32, one rounding; rows g and g + 8 of the M tile
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[j] = pack_bf16(acc[j][2 * hh] + sh[j][0],
                           acc[j][2 * hh + 1] + sh[j][1]);
        quad_transpose(p, q);
        const int ox = tl.ox0 + g + 8 * hh;
        if (ox < wo)
          __stcs(reinterpret_cast<int4*>(
                     out + ((tl.n * ho + oy) * wo + ox) * F + c0 + 8 * q),
                 make_int4((int)p[0], (int)p[1], (int)p[2], (int)p[3]));
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <typename TX, int F>
int launch(const void* x, const void* wp, const void* shift, void* out,
           int n, int h, int wd, cudaStream_t stream) {
  auto kernel = stem_conv_kernel<TX, F>;
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, 0)) != cudaSuccess)
    return (int)err;
  const int ho = h / 2, wo = wd / 2;
  const int tiles_x = (wo + TC - 1) / TC, tiles_y = (ho + TR - 1) / TR;
  const long long tiles = (long long)tiles_x * tiles_y * n;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // persistent blocks: each loads its B fragments once and walks its tiles
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(tiles < resident ? tiles : resident);
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const bf16*>(wp),
      static_cast<const float*>(shift), static_cast<bf16*>(out), h, wd, ho,
      wo, tiles_x, tiles_y, (int)tiles);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_f(const void* x, const void* wp, const void* shift, void* out,
             int n, int h, int wd, int f, cudaStream_t s) {
  if (f == 32) return launch<TX, 32>(x, wp, shift, out, n, h, wd, s);
  if (f == 64) return launch<TX, 64>(x, wp, shift, out, n, h, wd, s);
  if (f == 128) return launch<TX, 128>(x, wp, shift, out, n, h, wd, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [n, h, w, 3] (dtype 0 = float32, 1 = bfloat16; h, w even; 8-byte
// aligned), w the weights packed by ops/stem_conv_bn.py:_pack_weights,
// [176, f] bfloat16, shift [f] float32 -> out [n, h/2, w/2, f] bfloat16;
// f 32, 64 or 128; out 16-byte aligned. Returns cudaGetLastError()
// after the launch.
extern "C" int stem_conv_bn_fwd(const void* x, const void* w,
                                const void* shift, void* out, int n, int h,
                                int wd, int f, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 0 || wd <= 0 || h % 2 || wd % 2) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_f<float>(x, w, shift, out, n, h, wd, f, s);
  if (dtype == 1) return launch_f<bf16>(x, w, shift, out, n, h, wd, f, s);
  return (int)cudaErrorInvalidValue;
}
