// Fused ResNet bottleneck block, forward only, NHWC:
//
//   out = relu(x + W3 . relu(W2 (*) relu(W1 . x + b1) + b2) + b3)
//
// for a stride-1, identity-shortcut block with FrozenBN folded into the
// weights (w1 [C, M], w2 [3, 3, M, M] HWIO, w3 [M, C], biases f32).
//
// Replaces the TPU kernel locov_tpu/ops/pallas_block.py:_block_kernel
// (launched by bottleneck_block), with its rounding points: products in
// x's dtype with f32 sums, each bias added in f32, relu, one rounding of
// t1 and of t2 to x's dtype, the residual added from x in f32, relu, one
// rounding. conv2 pads t1 with zeros: t1 at a halo pixel outside the
// image is set to 0 (conv1 of a zero x there would give relu(b1)).
//
// Bound on this card: at res2 widths (C 256, M 64) in bf16 the block
// moves x once and out once (275 MB at [4, 200, 336, 256]) for 37 GFLOP,
// so it is bound by bytes (0.08 ms); in f32 by operations (0.56 ms at
// 67 TFLOP/s on the CUDA cores). The design keeps t1 and t2, which
// cuDNN's three convolutions write to and read from device memory, in
// shared memory.
//
// Design: one block (8 warps) per (image, strip of 8 output rows, tile
// of 16 output columns). Three phases, each a product of a shared-memory
// tile with a weight chunk streamed in from device memory (L2-resident):
//   conv1: the 10 x 18 halo of x (zeros outside the image), in chunks of
//          input channels, times W1 -> t1 for the halo (0 outside the
//          image) in shared memory;
//   conv2: nine taps, each the 16-pixel rows of t1 shifted by the tap,
//          times that tap's [M, M] matrix -> t2 for the 128 pixels;
//   conv3: t2 times W3 in chunks of 64 output channels, + b3 + x (read
//          again, from L2) -> relu -> stored.
// bf16 runs the products on the tensor cores (mma.sync m16n8k16, f32
// accumulators, operands by ldmatrix); f32 runs them as f32 FMAs on the
// CUDA cores (TF32 would break the float32 result). Any H, W >= 1; C a
// multiple of 64, M 64 or 128 (the wrapper refuses anything else).
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using locov::from_f32;
using locov::to_f32;

constexpr int TR = 8;            // output rows of a block
constexpr int TC = 16;           // output columns of a block
constexpr int HC = TC + 2;       // halo columns
constexpr int NH = (TR + 2) * HC;  // halo pixels (180)
constexpr int NHP = 192;         // halo rows rounded up to 12 tiles of 16
constexpr int NO = TR * TC;      // output pixels (128)
constexpr int THREADS = 256;
constexpr int NB = 64;           // output channels per pass of conv1, conv3

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// relu as F.relu computes it: a NaN is carried forward
__device__ __forceinline__ float relu_f32(float u) {
  return u != u ? u : fmaxf(u, 0.0f);
}

// Shared-memory layout, in elements of T. Rows are padded so that each
// row start is 16-byte aligned (ldmatrix, vector stores) and neighbouring
// rows fall in other banks.
template <typename T, int M>
struct Layout {
  static constexpr bool BF16 = std::is_same<T, bf16>::value;
  static constexpr int PAD = BF16 ? 8 : 4;
  static constexpr int KC = BF16 ? 64 : 32;  // conv1 input channels a chunk
  static constexpr int LDT = M + PAD;        // t1, t2, a W2 tap
  static constexpr int LDX = KC + PAD;       // the x chunk
  static constexpr int LDN = NB + PAD;       // a W1 or W3 chunk
  // region A: t1 (conv1, conv2), then a W3 chunk (conv3)
  static constexpr int A = cmax(NHP * LDT, M * LDN);
  // region B: the x and W1 chunks (conv1), a W2 tap (conv2), t2 (conv3)
  static constexpr int B = cmax(NHP * LDX + KC * LDN, cmax(M, NO) * LDT);
  static constexpr size_t BYTES = (size_t)(A + B) * sizeof(T);
};

// rows x cols of T from device memory (row stride gs) into shared memory
// (row stride ld), 16 bytes a thread; cols a multiple of 16 bytes
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long gs, int rows, int cols) {
  constexpr int VE = 16 / sizeof(T);
  const int vpr = cols / VE;
  for (int i = threadIdx.x; i < rows * vpr; i += THREADS) {
    const int r = i / vpr, v = i - r * vpr;
    *reinterpret_cast<uint4*>(dst + r * ld + v * VE) =
        *reinterpret_cast<const uint4*>(src + r * gs + (long long)v * VE);
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(THREADS, 1)
    bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const float* __restrict__ b2, const T* __restrict__ w3,
                      const float* __restrict__ b3, T* __restrict__ out,
                      int h, int w, int c) {
  using L = Layout<T, M>;
  constexpr int KC = L::KC, LDT = L::LDT, LDX = L::LDX, LDN = L::LDN;
  constexpr int VE = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* t1s = reinterpret_cast<T*>(smem);  // region A
  T* w3s = t1s;
  T* xs = t1s + L::A;                   // region B
  T* w1s = xs + NHP * LDX;
  T* w2s = xs;
  T* t2s = xs;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // bf16: warp tiles of the mma fragments; f32: thread (ty, tx) owns
  // rows ty + 16 i and columns tx + 16 j of each product
  const int ty = tid >> 4, tx = tid & 15;
  const int x0 = blockIdx.x * TC, y0 = blockIdx.y * TR;
  const long long img = (long long)blockIdx.z * h;
  // is halo pixel p (row-major over 10 x 18) inside the image?
  auto inside = [&](int p) {
    const int gy = y0 - 1 + p / HC, gx = x0 - 1 + p % HC;
    return p < NH && gy >= 0 && gy < h && gx >= 0 && gx < w;
  };

  // ---------------------------------------------------------------- conv1
  // [192 halo rows, 64 columns] per pass: bf16 warp = 3 row tiles x 4
  // column tiles of 8 (tile (i, nt) at acc + 4 (4 i + nt)); f32 thread =
  // 12 rows x 4 columns
  const int wm = (warp >> 1) * 3, wn = (warp & 1) * 32;
  for (int n0 = 0; n0 < M; n0 += NB) {
    float acc[48];
#pragma unroll
    for (int e = 0; e < 48; ++e) acc[e] = 0.0f;
    for (int c0 = 0; c0 < c; c0 += KC) {
      __syncthreads();  // the last chunk's readers are done
      for (int i = tid; i < NHP * (KC / VE); i += THREADS) {
        const int p = i / (KC / VE), v = i - p * (KC / VE);
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (inside(p)) {
          const int gy = y0 - 1 + p / HC, gx = x0 - 1 + p % HC;
          val = *reinterpret_cast<const uint4*>(
              x + ((img + gy) * w + gx) * c + c0 + v * VE);
        }
        *reinterpret_cast<uint4*>(xs + p * LDX + v * VE) = val;
      }
      load_tile(w1s, LDN, w1 + (long long)c0 * M + n0, M, KC, NB);
      __syncthreads();
      if constexpr (L::BF16) {
#pragma unroll
        for (int k0 = 0; k0 < KC; k0 += 16) {
          unsigned a[3][4], b[2][4];
#pragma unroll
          for (int i = 0; i < 3; ++i)
            locov::ldmatrix_a(a[i], xs + ((wm + i) * 16 + (lane & 15)) * LDX +
                                        k0 + 8 * (lane >> 4));
#pragma unroll
          for (int j = 0; j < 2; ++j)
            locov::ldmatrix_b2(b[j], w1s + (k0 + (lane & 15)) * LDN + wn +
                                         16 * j + 8 * (lane >> 4));
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              locov::mma_bf16(acc + 4 * (4 * i + 2 * j), a[i], b[j][0],
                              b[j][1]);
              locov::mma_bf16(acc + 4 * (4 * i + 2 * j + 1), a[i], b[j][2],
                              b[j][3]);
            }
        }
      } else {
#pragma unroll 4
        for (int k = 0; k < KC; ++k) {
          float a[12], b[4];
#pragma unroll
          for (int i = 0; i < 12; ++i) a[i] = xs[(ty + 16 * i) * LDX + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = w1s[k * LDN + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 12; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[4 * i + j] = fmaf(a[i], b[j], acc[4 * i + j]);
        }
      }
    }
    // t1 = round(relu(acc + b1)) inside the image, 0 outside
    if constexpr (L::BF16) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + wn + nt * 8 + 2 * (lane & 3);
          const float bb0 = b1[col], bb1 = b1[col + 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int p = (wm + i) * 16 + (lane >> 2) + 8 * hh;
            if (p >= NH) continue;
            const float* d = acc + 4 * (4 * i + nt) + 2 * hh;
            const bool in = inside(p);
            *reinterpret_cast<__nv_bfloat162*>(t1s + p * LDT + col) =
                __floats2bfloat162_rn(in ? relu_f32(d[0] + bb0) : 0.0f,
                                      in ? relu_f32(d[1] + bb1) : 0.0f);
          }
        }
    } else {
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        const int p = ty + 16 * i;
        if (p >= NH) continue;
        const bool in = inside(p);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + tx + 16 * j;
          t1s[p * LDT + col] =
              from_f32<T>(in ? relu_f32(acc[4 * i + j] + b1[col]) : 0.0f);
        }
      }
    }
  }
  __syncthreads();  // t1 complete; the x and W1 chunks are read

  // ---------------------------------------------------------------- conv2
  // [128 output pixels, M]: bf16 warp = output row `warp` (16 pixels) x
  // M/8 column tiles; f32 thread = pixels (row i, column ty) x M/16 cols
  float acc2[M / 2];
#pragma unroll
  for (int e = 0; e < M / 2; ++e) acc2[e] = 0.0f;
  for (int tap = 0; tap < 9; ++tap) {
    if (tap > 0) __syncthreads();  // the last tap's readers are done
    load_tile(w2s, LDT, w2 + (long long)tap * M * M, M, M, M);
    __syncthreads();
    const int dy = tap / 3, dx = tap % 3;
    if constexpr (L::BF16) {
      const T* arow =
          t1s + ((warp + dy) * HC + (lane & 15) + dx) * LDT + 8 * (lane >> 4);
#pragma unroll
      for (int k0 = 0; k0 < M; k0 += 16) {
        unsigned a[4];
        locov::ldmatrix_a(a, arow + k0);
#pragma unroll
        for (int j = 0; j < M / 16; ++j) {
          unsigned b[4];
          locov::ldmatrix_b2(b, w2s + (k0 + (lane & 15)) * LDT + 16 * j +
                                    8 * (lane >> 4));
          locov::mma_bf16(acc2 + 8 * j, a, b[0], b[1]);
          locov::mma_bf16(acc2 + 8 * j + 4, a, b[2], b[3]);
        }
      }
    } else {
#pragma unroll 2
      for (int k = 0; k < M; ++k) {
        float a[8], b[M / 16];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = t1s[((i + dy) * HC + ty + dx) * LDT + k];
#pragma unroll
        for (int j = 0; j < M / 16; ++j) b[j] = w2s[k * LDT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < M / 16; ++j)
            acc2[(M / 16) * i + j] =
                fmaf(a[i], b[j], acc2[(M / 16) * i + j]);
      }
    }
  }
  __syncthreads();  // every tap is read: t2 may take region B
  // t2 = round(relu(acc + b2)) at output pixel p = 16 r + c
  if constexpr (L::BF16) {
#pragma unroll
    for (int nt = 0; nt < M / 8; ++nt) {
      const int col = nt * 8 + 2 * (lane & 3);
      const float bb0 = b2[col], bb1 = b2[col + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = warp * 16 + (lane >> 2) + 8 * hh;
        const float* d = acc2 + 4 * nt + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(t2s + p * LDT + col) =
            __floats2bfloat162_rn(relu_f32(d[0] + bb0), relu_f32(d[1] + bb1));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < M / 16; ++j) {
        const int col = tx + 16 * j;
        t2s[(16 * i + ty) * LDT + col] =
            from_f32<T>(relu_f32(acc2[(M / 16) * i + j] + b2[col]));
      }
  }
  __syncthreads();  // t2 complete; t1 is read, region A is free

  // ---------------------------------------------------------------- conv3
  // [128 output pixels, 64 channels] per pass: bf16 warp = output row
  // `warp` x 8 column tiles; f32 thread = pixels (row i, column ty) x 4
  for (int n0 = 0; n0 < c; n0 += NB) {
    if (n0 > 0) __syncthreads();  // the last W3 chunk's readers are done
    load_tile(w3s, LDN, w3 + n0, c, M, NB);
    __syncthreads();
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
    if constexpr (L::BF16) {
      const T* arow = t2s + (warp * 16 + (lane & 15)) * LDT + 8 * (lane >> 4);
#pragma unroll
      for (int k0 = 0; k0 < M; k0 += 16) {
        unsigned a[4];
        locov::ldmatrix_a(a, arow + k0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned b[4];
          locov::ldmatrix_b2(b, w3s + (k0 + (lane & 15)) * LDN + 16 * j +
                                    8 * (lane >> 4));
          locov::mma_bf16(acc + 8 * j, a, b[0], b[1]);
          locov::mma_bf16(acc + 8 * j + 4, a, b[2], b[3]);
        }
      }
      // out = round(relu(acc + b3 + x)) at output pixel (warp, column)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int gy = y0 + warp, gx = x0 + (lane >> 2) + 8 * hh;
        if (gy >= h || gx >= w) continue;
        const long long pix = ((img + gy) * w + gx) * c;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = n0 + nt * 8 + 2 * (lane & 3);
          const float* d = acc + 4 * nt + 2 * hh;
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + pix + col));
          *reinterpret_cast<__nv_bfloat162*>(out + pix + col) =
              __floats2bfloat162_rn(relu_f32(d[0] + b3[col] + r.x),
                                    relu_f32(d[1] + b3[col + 1] + r.y));
        }
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < M; ++k) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = t2s[(16 * i + ty) * LDT + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = w3s[k * LDN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[4 * i + j] = fmaf(a[i], b[j], acc[4 * i + j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int gy = y0 + i, gx = x0 + ty;
        if (gy >= h || gx >= w) continue;
        const long long pix = ((img + gy) * w + gx) * c;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + tx + 16 * j;
          out[pix + col] = from_f32<T>(
              relu_f32(acc[4 * i + j] + b3[col] + to_f32(x[pix + col])));
        }
      }
    }
  }
}

template <typename T, int M>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, void* out, int n,
           int h, int w, int c, cudaStream_t stream) {
  auto kernel = bottleneck_kernel<T, M>;
  const int bytes = (int)Layout<T, M>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TC - 1) / TC, (h + TR - 1) / TR, n);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<T*>(out), h, w, c);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, h, w, c] -> out [n, h, w, c]; w1 [c, m], w2 [3, 3, m, m], w3
// [m, c] of x's dtype (0 = float32, 1 = bfloat16), b1 [m], b2 [m], b3 [c]
// float32; every pointer 16-byte aligned; c a multiple of 64, m 64 or
// 128. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a width it does not take).
extern "C" int bottleneck_block_fwd(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, const void* w3,
                                    const void* b3, void* out, int n, int h,
                                    int w, int c, int m, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 0 || c % NB != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && m == 64)
    return launch<bf16, 64>(x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, s);
  if (dtype == 1 && m == 128)
    return launch<bf16, 128>(x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, s);
  if (dtype == 0 && m == 64)
    return launch<float, 64>(x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, s);
  if (dtype == 0 && m == 128)
    return launch<float, 128>(x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}
