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
// 67 TFLOP/s on the CUDA cores). Both kernels keep t1 and t2, which
// cuDNN's three convolutions write to and read from device memory, on
// chip.
//
// Tiles: (image, 8 output rows, 16 output columns); conv1 runs on the
// tile's 10 x 18 halo (rounded up to 12 row tiles of 16), conv2 as nine
// taps, each the 16-pixel rows of t1 shifted by the tap, conv3 in chunks
// of 64 output channels.
//
// bf16 (block_bf16): persistent blocks of 8 warps, two an SM at M 64
// (one at M 128), walk the tiles in the order of their index, so the
// tiles in flight at one time are neighbours and their halos meet in L2.
// Products: mma.sync m16n8k16 (f32 accumulators, operands by ldmatrix).
//   - Loads overlap products: one ring of STAGES shared-memory stages
//     (2 at M 64, 3 at M 128) filled by cp.async STAGES - 1 steps ahead,
//     one barrier a step. A step stages a 64-channel chunk of the halo
//     with W1's 64 rows for it (conv1), 3 taps of W2 at M 64 and one at
//     M 128 (conv2), or 64
//     columns of W3 with the residual's 64 channels (conv3); the ring
//     runs on across tiles. A thread's pieces of a stage are the same
//     every step, so their offsets are reckoned once a tile.
//   - The weights stream from L2 every tile (136 KB at M 64). A resident
//     W2 (72 KB, 83 KB padded) leaves room for one block an SM, or for
//     two tile pipelines with a one-step ring, and both ran slower than
//     two streaming blocks an SM; cutting the W1 and W3 copies saved
//     nothing measurable (PERF.md, tools/ablate_block.py).
//   - x: the halo is read 1.41x from L2 (180 pixels for 128) and the
//     residual once more through the ring: 2.4x from L2, about 1x from
//     device memory (the neighbours' halos are in flight at the same
//     time). Keeping the residual from conv1's staging would take 64 KB
//     a tile (128 pixels x 256 channels).
//   - t2 never leaves registers: a warp's conv2 sums (its 16 pixels x
//     all M channels) are, by the m16n8k16 layouts, its conv3 A
//     fragments once biased, relu'd and rounded.
//   - The epilogue takes the residual's fragments by ldmatrix (the mma C
//     layout is ldmatrix's A layout), writes the rounded results back
//     over them, and reads them as 16-byte pieces of pixel rows, which it
//     stores as whole 128-byte lines (__stcs).
// f32 (block_f32) keeps the design it had: one block per tile, products
// as f32 FMAs on the CUDA cores (TF32 would break the float32 result),
// operands staged synchronously.
//
// Any H, W >= 1; C a multiple of 64, M 64 or 128 (the wrapper refuses
// anything else).
#include <stdint.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using locov::pack_bf16;

constexpr int TR = 8;            // output rows of a tile
constexpr int TC = 16;           // output columns of a tile
constexpr int HC = TC + 2;       // halo columns
constexpr int NH = (TR + 2) * HC;  // halo pixels (180)
constexpr int NHP = 192;         // halo rows rounded up to 12 tiles of 16
constexpr int NO = TR * TC;      // output pixels (128)
constexpr int THREADS = 256;     // threads a block (8 warps)
constexpr int NB = 64;           // channels of a conv1 or conv3 step

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// relu as F.relu computes it: a NaN is carried forward
__device__ __forceinline__ float relu_f32(float u) {
  return u != u ? u : fmaxf(u, 0.0f);
}

// ------------------------------------------------------------------ bf16
// Shared-memory layout of block_bf16, in bf16 elements: t1 for the
// tile's halo, and a ring of STAGES stages, each the largest of a step's
// operands (a halo chunk with W1's rows for it, TPS taps of W2, a W3
// chunk with the residual's chunk). Rows are padded by 8 elements, so that
// each row start is 16-byte aligned (ldmatrix, cp.async) and
// neighbouring rows fall in other banks.
template <int M>
struct Bf16Layout {
  static constexpr int STAGES = M == 64 ? 2 : 3;  // ring stages
  static constexpr int MINB = M == 64 ? 2 : 1;    // blocks an SM
  static constexpr int TPS = M == 64 ? 3 : 1;     // W2 taps a step
  static constexpr int LDX = NB + 8;  // a halo, W3 or residual chunk
  static constexpr int LDM = M + 8;   // t1, a W1 chunk, a W2 tap
  static constexpr int T1 = NH * LDM;
  static constexpr int STAGE = cmax(NHP * LDX + NB * LDM,
                                    cmax(TPS * M * LDM, M * LDX + NO * LDX));
  static constexpr int BYTES = 2 * (T1 + STAGES * STAGE);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   locov::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

struct Geometry {
  int h, w, c, tiles_x, tiles_y, tiles;
};

struct Tile {
  long long img;  // n * h
  int y0, x0;
};

__device__ __forceinline__ Tile tile_at(int t, const Geometry& g) {
  const int per_img = g.tiles_x * g.tiles_y;
  return {(long long)(t / per_img) * g.h, (t / g.tiles_x) % g.tiles_y * TR,
          t % g.tiles_x * TC};
}

// rows x cols bf16 (compile-time) from device memory (row stride gs)
// into shared memory (row stride ld) by cp.async, thread `tid` of
// THREADS
template <int ROWS, int COLS>
__device__ __forceinline__ void copy_rows(bf16* dst, int ld, const bf16* src,
                                          long long gs, int tid) {
  constexpr int VPR = COLS / 8;
  for (int i = tid; i < ROWS * VPR; i += THREADS)
    cp_async16(dst + (i / VPR) * ld + (i % VPR) * 8,
               src + (i / VPR) * gs + (i % VPR) * 8, true);
}

// The producer side of a block: the next step to stage (a tile, and
// within it conv1 chunk k < kc, W2 taps TPS (k - kc) .. while k - kc <
// 9 / TPS, or conv3 chunk k - kc - 9 / TPS) and this thread's pieces of
// it. A thread's pieces of the
// halo and the residual are the same every step (piece i = tid +
// THREADS j of the stage), so their offsets and whether they lie inside
// the image are reckoned once a tile.
template <int M>
struct Feeder {
  using L = Bf16Layout<M>;
  static constexpr int LDX = L::LDX, LDM = L::LDM, VR = NB / 8;
  static constexpr int XP = NHP * VR / THREADS;  // halo pieces a thread
  static constexpr int RP = NO * VR / THREADS;   // residual pieces a thread
  const bf16* x;
  const bf16* w1;
  const bf16* w2;
  const bf16* w3;
  Geometry g;
  int tid, kc, ns;
  int tile = 0, k = 0;       // the next step
  const bf16* xb = nullptr;  // x at the tile's halo origin (may lie outside)
  const bf16* rb = nullptr;  // x at the tile's first output pixel
  int xo[XP] = {}, ro[RP] = {};  // piece offsets from xb, rb
  unsigned xin = 0, rin = 0;     // pieces inside the image, a bit each

  __device__ __forceinline__ void enter(int t_) {
    tile = t_;
    k = 0;
    if (tile >= g.tiles) return;
    const Tile t = tile_at(tile, g);
    const long long c = g.c;
    xb = x + ((t.img + t.y0 - 1) * g.w + t.x0 - 1) * c;
    rb = x + ((t.img + t.y0) * g.w + t.x0) * c;
    xin = rin = 0;
#pragma unroll
    for (int j = 0; j < XP; ++j) {
      const int i = tid + THREADS * j, p = i / VR, v = i % VR;
      const int py = p / HC, px = p % HC;
      const int gy = t.y0 - 1 + py, gx = t.x0 - 1 + px;
      xo[j] = (py * g.w + px) * g.c + v * 8;
      if (p < NH && gy >= 0 && gy < g.h && gx >= 0 && gx < g.w)
        xin |= 1u << j;
    }
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      const int i = tid + THREADS * j, p = i / VR, v = i % VR;
      const int py = p / TC, px = p % TC;
      ro[j] = (py * g.w + px) * g.c + v * 8;
      if (t.y0 + py < g.h && t.x0 + px < g.w) rin |= 1u << j;
    }
  }

  // Stage the next step into `st` (one cp.async group, empty past the
  // last tile; zeros for halo pixels outside the image) and move on.
  __device__ __forceinline__ void fill(bf16* st) {
    if (tile < g.tiles) {
      if (k < kc) {
        // the halo's channels [64 k, 64 k + 64) with W1's rows
        const int c0 = k * NB;
#pragma unroll
        for (int j = 0; j < XP; ++j) {
          const int i = tid + THREADS * j;
          const bool in = (xin >> j) & 1u;
          cp_async16(st + (i / VR) * LDX + (i % VR) * 8,
                     in ? xb + xo[j] + c0 : x, in);
        }
        copy_rows<NB, M>(st + NHP * LDX, LDM, w1 + (long long)c0 * M, M,
                         tid);
      } else if (k < kc + 9 / L::TPS) {
        copy_rows<L::TPS * M, M>(
            st, LDM, w2 + (long long)(k - kc) * L::TPS * M * M, M, tid);
      } else {
        // W3's columns [64 j, 64 j + 64) and the residual's channels
        const int c0 = (k - kc - 9 / L::TPS) * NB;
        copy_rows<M, NB>(st, LDX, w3 + c0, g.c, tid);
        bf16* rs = st + M * LDX;
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          const int i = tid + THREADS * j;
          const bool in = (rin >> j) & 1u;
          cp_async16(rs + (i / VR) * LDX + (i % VR) * 8,
                     in ? rb + ro[j] + c0 : x, in);
        }
      }
    }
    cp_commit();
    if (++k == ns) enter(tile + gridDim.x);
  }
};

template <int M>
__global__ void __launch_bounds__(THREADS, Bf16Layout<M>::MINB)
    block_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, const bf16* __restrict__ w3,
               const float* __restrict__ b3, bf16* __restrict__ out,
               Geometry g) {
  using L = Bf16Layout<M>;
  constexpr int LDX = L::LDX, LDM = L::LDM, STAGES = L::STAGES;
  constexpr int NT = M / 8;    // n tiles of 8 across M
  constexpr int NT1 = M / 16;  // a conv1 warp's n tiles (half of M)
  constexpr int NT3 = NB / 8;  // a conv3 step's n tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* t1s = reinterpret_cast<bf16*>(smem);
  bf16* ring = t1s + L::T1;

  // (the modulo tells the compiler that tid < THREADS: without it ptxas
  // spilled the M 64 kernel at its 128 registers)
  const int tid = threadIdx.x % THREADS, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int kc = g.c / NB;   // conv1 and conv3 steps
  const int ns = 2 * kc + 9 / L::TPS;  // steps a tile

  Feeder<M> feed{x, w1, w2, w3, g, tid, kc, ns};
  feed.enter(blockIdx.x);
  for (int j = 0; j < STAGES - 1; ++j) feed.fill(ring + j * L::STAGE);

  int s = 0;  // this block's step
  // wait for step s's stage, and refill the stage step s - 1 read
  auto begin_step = [&]() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    feed.fill(ring + ((s + STAGES - 1) % STAGES) * L::STAGE);
    return ring + (s % STAGES) * L::STAGE;
  };

  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const Tile t = tile_at(tile, g);

    // ------------------------------------------------------------ conv1
    // [192 halo rows, M]: warp = 3 row tiles x M/2 columns
    const int wm = (warp >> 1) * 3, wn = (warp & 1) * (M / 2);
    float acc1[3][NT1][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[i][j][e] = 0.0f;
    for (int k = 0; k < kc; ++k, ++s) {
      const bf16* xs = begin_step();
      const bf16* w1s = xs + NHP * LDX;
#pragma unroll
      for (int k0 = 0; k0 < NB; k0 += 16) {
        unsigned a[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          locov::ldmatrix_a(a[i], xs + ((wm + i) * 16 + (lane & 15)) * LDX +
                                      k0 + 8 * (lane >> 4));
#pragma unroll
        for (int j = 0; j < NT1 / 2; ++j) {
          unsigned b[4];
          locov::ldmatrix_b2(b, w1s + (k0 + (lane & 15)) * LDM + wn +
                                    16 * j + 8 * (lane >> 4));
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            locov::mma_bf16(acc1[i][2 * j], a[i], b[0], b[1]);
            locov::mma_bf16(acc1[i][2 * j + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    // t1 = round(relu(acc + b1)) inside the image, 0 outside
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < NT1; ++j) {
        const int col = wn + j * 8 + 2 * q;
        const float bb0 = __ldg(b1 + col), bb1 = __ldg(b1 + col + 1);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = (wm + i) * 16 + gq + 8 * hh;
          if (p >= NH) continue;
          const int gy = t.y0 - 1 + p / HC, gx = t.x0 - 1 + p % HC;
          const bool in = gy >= 0 && gy < g.h && gx >= 0 && gx < g.w;
          *reinterpret_cast<uint32_t*>(t1s + p * LDM + col) = pack_bf16(
              in ? relu_f32(acc1[i][j][2 * hh] + bb0) : 0.0f,
              in ? relu_f32(acc1[i][j][2 * hh + 1] + bb1) : 0.0f);
        }
      }
    __syncthreads();  // t1 complete

    // ------------------------------------------------------------ conv2
    // [128 output pixels, M]: warp = output row `warp` (16 pixels) x M
    float acc2[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[j][e] = 0.0f;
    const bf16* w2c = nullptr;  // the step's taps
    for (int tap = 0; tap < 9; ++tap) {
      if (tap % L::TPS == 0) {
        w2c = begin_step();
        ++s;
      }
      const bf16* w2t = w2c + (tap % L::TPS) * M * LDM;
      const int dy = tap / 3, dx = tap % 3;
      const bf16* arow =
          t1s + ((warp + dy) * HC + (lane & 15) + dx) * LDM + 8 * (lane >> 4);
#pragma unroll
      for (int k0 = 0; k0 < M; k0 += 16) {
        unsigned a[4];
        locov::ldmatrix_a(a, arow + k0);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          unsigned b[4];
          locov::ldmatrix_b2(b, w2t + (k0 + (lane & 15)) * LDM + 16 * j +
                                    8 * (lane >> 4));
          locov::mma_bf16(acc2[2 * j], a, b[0], b[1]);
          locov::mma_bf16(acc2[2 * j + 1], a, b[2], b[3]);
        }
      }
    }
    // t2 = round(relu(acc + b2)), kept as conv3's A fragments: k step kk
    // takes n tiles 2 kk (a0: row g, a1: row g + 8) and 2 kk + 1 (a2, a3)
    unsigned t2[M / 16][4];
#pragma unroll
    for (int kk = 0; kk < M / 16; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 16 * kk + 8 * half + 2 * q;
        const float bb0 = __ldg(b2 + col), bb1 = __ldg(b2 + col + 1);
        const float* d = acc2[2 * kk + half];
        t2[kk][2 * half] = pack_bf16(relu_f32(d[0] + bb0), relu_f32(d[1] + bb1));
        t2[kk][2 * half + 1] =
            pack_bf16(relu_f32(d[2] + bb0), relu_f32(d[3] + bb1));
      }

    // ------------------------------------------------------------ conv3
    // [128 output pixels, 64 channels] a step: warp = output row `warp`
    for (int k = 0; k < kc; ++k, ++s) {
      bf16* w3s = begin_step();
      bf16* rs = w3s + M * LDX;
      const int n0 = k * NB;
      float acc[NT3][4];
#pragma unroll
      for (int j = 0; j < NT3; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < M / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < NT3 / 2; ++j) {
          unsigned b[4];
          locov::ldmatrix_b2(b, w3s + (16 * kk + (lane & 15)) * LDX + 16 * j +
                                    8 * (lane >> 4));
          locov::mma_bf16(acc[2 * j], t2[kk], b[0], b[1]);
          locov::mma_bf16(acc[2 * j + 1], t2[kk], b[2], b[3]);
        }
      }
      // out = round(relu(acc + b3 + x)) for the warp's 16 pixels. The
      // residual's fragments come by ldmatrix from the staged chunk (the
      // mma C layout is ldmatrix's A layout: block b holds n tiles 2 b,
      // 2 b + 1, rows g and g + 8); the rounded results overwrite them
      // in place, and the warp reads them back as 16-byte pieces of
      // pixel rows, which it stores as whole lines.
      bf16* rw = rs + warp * TC * LDX;  // the warp's 16 pixel rows
      unsigned r[NT3 / 2][4];
#pragma unroll
      for (int b = 0; b < NT3 / 2; ++b)
        locov::ldmatrix_a(r[b], rw + (lane & 15) * LDX + 16 * b +
                                    8 * (lane >> 4));
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NT3; ++j) {
        const int col = 8 * j + 2 * q;
        const float bb0 = __ldg(b3 + n0 + col), bb1 = __ldg(b3 + n0 + col + 1);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t xw = r[j / 2][2 * (j % 2) + hh];  // 2 bf16
          *reinterpret_cast<uint32_t*>(rw + (gq + 8 * hh) * LDX + col) =
              pack_bf16(relu_f32(acc[j][2 * hh] + bb0 + __uint_as_float(xw << 16)),
                        relu_f32(acc[j][2 * hh + 1] + bb1 +
                                 __uint_as_float(xw & 0xffff0000u)));
        }
      }
      __syncwarp();
      constexpr int PPX = NB / 8;  // 16-byte pieces of a pixel's chunk
      const int gy = t.y0 + warp;
#pragma unroll
      for (int e = 0; e < TC * PPX / 32; ++e) {
        const int px = (32 * e + lane) / PPX, v = (32 * e + lane) % PPX;
        const int4 val = *reinterpret_cast<const int4*>(rw + px * LDX + v * 8);
        const int gx = t.x0 + px;
        if (gy < g.h && gx < g.w)
          __stcs(reinterpret_cast<int4*>(
                     out + ((t.img + gy) * g.w + gx) * g.c + n0 + v * 8),
                 val);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <int M>
int launch_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, const void* w3, const void* b3, void* out,
                int n, int h, int w, int c, cudaStream_t stream) {
  using L = Bf16Layout<M>;
  auto kernel = block_bf16<M>;
  const int bytes = L::BYTES;
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, bytes)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  Geometry g{h, w, c, (w + TC - 1) / TC, (h + TR - 1) / TR, 0};
  const long long tiles = (long long)g.tiles_x * g.tiles_y * n;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  g.tiles = (int)tiles;
  // persistent blocks, MINB an SM, each walking its tiles
  const long long resident = (long long)sms * per_sm;
  const int grid = (int)(tiles < resident ? tiles : resident);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const bf16*>(w3),
      static_cast<const float*>(b3), static_cast<bf16*>(out), g);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- f32
// Shared-memory layout of block_f32, in floats: rows padded by 4.
template <int M>
struct F32Layout {
  static constexpr int KC = 32;        // conv1 input channels a chunk
  static constexpr int LDT = M + 4;    // t1, t2, a W2 tap
  static constexpr int LDX = KC + 4;   // the x chunk
  static constexpr int LDN = NB + 4;   // a W1 or W3 chunk
  // region A: t1 (conv1, conv2), then a W3 chunk (conv3)
  static constexpr int A = cmax(NHP * LDT, M * LDN);
  // region B: the x and W1 chunks (conv1), a W2 tap (conv2), t2 (conv3)
  static constexpr int B = cmax(NHP * LDX + KC * LDN, cmax(M, NO) * LDT);
  static constexpr int BYTES = 4 * (A + B);
};

// rows x cols floats from device memory (row stride gs) into shared
// memory (row stride ld), 16 bytes a thread; cols a multiple of 4
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long gs, int rows, int cols) {
  const int vpr = cols / 4;
  for (int i = threadIdx.x; i < rows * vpr; i += THREADS) {
    const int r = i / vpr, v = i - r * vpr;
    *reinterpret_cast<float4*>(dst + r * ld + v * 4) =
        *reinterpret_cast<const float4*>(src + r * gs + (long long)v * 4);
  }
}

// One block (8 warps) per tile; thread (ty, tx) owns rows ty + 16 i and
// columns tx + 16 j of each product.
template <int M>
__global__ void __launch_bounds__(THREADS, 1)
    block_f32(const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ b2, const float* __restrict__ w3,
              const float* __restrict__ b3, float* __restrict__ out, int h,
              int w, int c) {
  using L = F32Layout<M>;
  constexpr int KC = L::KC, LDT = L::LDT, LDX = L::LDX, LDN = L::LDN;
  extern __shared__ __align__(16) unsigned char smem[];
  float* t1s = reinterpret_cast<float*>(smem);  // region A
  float* w3s = t1s;
  float* xs = t1s + L::A;                       // region B
  float* w1s = xs + NHP * LDX;
  float* w2s = xs;
  float* t2s = xs;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int x0 = blockIdx.x * TC, y0 = blockIdx.y * TR;
  const long long img = (long long)blockIdx.z * h;
  // is halo pixel p (row-major over 10 x 18) inside the image?
  auto inside = [&](int p) {
    const int gy = y0 - 1 + p / HC, gx = x0 - 1 + p % HC;
    return p < NH && gy >= 0 && gy < h && gx >= 0 && gx < w;
  };

  // conv1: [192 halo rows, 64 columns] a pass: 12 rows x 4 columns a thread
  for (int n0 = 0; n0 < M; n0 += NB) {
    float acc[48];
#pragma unroll
    for (int e = 0; e < 48; ++e) acc[e] = 0.0f;
    for (int c0 = 0; c0 < c; c0 += KC) {
      __syncthreads();  // the last chunk's readers are done
      for (int i = tid; i < NHP * (KC / 4); i += THREADS) {
        const int p = i / (KC / 4), v = i - p * (KC / 4);
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (inside(p)) {
          const int gy = y0 - 1 + p / HC, gx = x0 - 1 + p % HC;
          val = *reinterpret_cast<const float4*>(
              x + ((img + gy) * w + gx) * c + c0 + v * 4);
        }
        *reinterpret_cast<float4*>(xs + p * LDX + v * 4) = val;
      }
      load_tile(w1s, LDN, w1 + (long long)c0 * M + n0, M, KC, NB);
      __syncthreads();
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
    // t1 = relu(acc + b1) inside the image, 0 outside
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const int p = ty + 16 * i;
      if (p >= NH) continue;
      const bool in = inside(p);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + 16 * j;
        t1s[p * LDT + col] = in ? relu_f32(acc[4 * i + j] + b1[col]) : 0.0f;
      }
    }
  }
  __syncthreads();  // t1 complete; the x and W1 chunks are read

  // conv2: [128 output pixels, M]: pixels (row i, column ty) x M/16
  // columns a thread
  float acc2[M / 2];
#pragma unroll
  for (int e = 0; e < M / 2; ++e) acc2[e] = 0.0f;
  for (int tap = 0; tap < 9; ++tap) {
    if (tap > 0) __syncthreads();  // the last tap's readers are done
    load_tile(w2s, LDT, w2 + (long long)tap * M * M, M, M, M);
    __syncthreads();
    const int dy = tap / 3, dx = tap % 3;
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
          acc2[(M / 16) * i + j] = fmaf(a[i], b[j], acc2[(M / 16) * i + j]);
    }
  }
  __syncthreads();  // every tap is read: t2 may take region B
  // t2 = relu(acc + b2) at output pixel p = 16 r + c
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < M / 16; ++j) {
      const int col = tx + 16 * j;
      t2s[(16 * i + ty) * LDT + col] =
          relu_f32(acc2[(M / 16) * i + j] + b2[col]);
    }
  __syncthreads();  // t2 complete; t1 is read, region A is free

  // conv3: [128 output pixels, 64 channels] a pass: pixels (row i,
  // column ty) x 4 columns a thread
  for (int n0 = 0; n0 < c; n0 += NB) {
    if (n0 > 0) __syncthreads();  // the last W3 chunk's readers are done
    load_tile(w3s, LDN, w3 + n0, c, M, NB);
    __syncthreads();
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
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
        out[pix + col] = relu_f32(acc[4 * i + j] + b3[col] + x[pix + col]);
      }
    }
  }
}

template <int M>
int launch_f32(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, const void* w3, const void* b3, void* out,
               int n, int h, int w, int c, cudaStream_t stream) {
  auto kernel = block_f32<M>;
  const int bytes = F32Layout<M>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TC - 1) / TC, (h + TR - 1) / TR, n);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out), h, w, c);
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
    return launch_bf16<64>(x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, s);
  if (dtype == 1 && m == 128)
    return launch_bf16<128>(x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, s);
  if (dtype == 0 && m == 64)
    return launch_f32<64>(x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, s);
  if (dtype == 0 && m == 128)
    return launch_f32<128>(x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}
