// ROIAlignV2 (aligned, half-pixel offset), NHWC: the forward as two
// separable contractions over each box's cells, and the gradient to the
// features, scatter-free.
//
// Forward: replaces the TPU kernels locov_tpu/ops/pallas_roi_align.py:
// _fused_kernel (inference, launched by roi_align_pallas_fused) and
// _kernel (training, launched by _forward behind roi_align_pallas),
// which compute the same function,
//   out[n,p,q,c] = sum_h Ky[n,p,h] sum_w Kx[n,q,w] F[h,w,c]
// as two dense MXU contractions against per-box interpolation matrices
// (ops/roi_align.py:roi_align_batched). Those matrices are almost all
// zeros (each row holds at most 2 * samples non-zeros), which on this
// card would waste the tensor cores on zeros; the kernel below contracts
// only the span of cells each bin weighs on, on the CUDA cores.
//
// Across pyramid levels (ViTDet's P2-P5; no TPU parent):
// roi_align_levels_fwd, one launch of roi_align_levels_fwd_kernel, whose
// blocks are the forward's (fwd_block, the same body and plan), each
// reading its box's level (an int32 a box) and pooling from that level's
// map alone.
//
// Backward: replaces pallas_roi_align.py:_bwd_kernel (launched by
// _backward_df), the feature gradient
//   dF[h,w,c] = sum_{n,p,q} Ky[n,p,h] g[n,p,q,c] Kx[n,q,w];
// the boxes get no gradient (proposals are inputs, as in the JAX
// package). The TPU kernel contracts the same dense matrices; on the
// JAX package's default path (adaptive sampling) the XLA custom VJP of
// ops/roi_align.py computes it. This kernel takes fixed and adaptive
// sampling alike.
//
// Bound on this card: memory. Forward: the output (at the detector's
// shapes 8 images x 1000 or 512 boxes x 14 x 14 x 1024, bf16: 3.2 or
// 1.6 GB) is written once, while the features (8 x 50 x 84 x 1024,
// 69 MB) are read from L2 by many boxes. Backward: the cotangent g
// (the size of the forward's output, 1.64 GB in bf16 at 512 boxes an
// image, against a 50 MB L2) is read and dF (the size of the features)
// written.
//
// Forward design: separable, in registers. One block per (box, group of
// two output rows, channel tile), blocks in box order (one image's
// features stay in L2 while its boxes run), one thread a channel vector
// of 32 bytes (16 bf16 or 8 f32 channels). The block turns the box's
// taps into its dense weights Kx[q, x] and its rows' Ky[p, h] in shared
// memory (each bin's samples summed in order over the cells they
// touch), with the span of cells each bin weighs on. Each thread then
// walks the bins q ascending and, for each column x of a bin's span,
//   t_x = sum_h Ky[p, h] F[h, x, c]      (h ascending)
//   out[p, q, c] += Kx[q, x] t_x          (x ascending)
// in f32 registers. t_x is computed once and kept in one of two slots
// by the parity of x, since neighbouring bins share their edge
// columns; so each feature cell a row weighs on is loaded once a (box,
// row), against four times a sample in the gather form before. The
// output is stored once, in its dtype, with streaming stores
// (st.global.cs), so that it does not evict the features from L2. The
// sum order depends on neither the tile, the rows a block nor the
// vector width: every plan gives the same bits. The plan is
// ops/roi_align.py:_fwd_plan; the C entry refuses a plan whose shared
// memory differs from fwd_smem_bytes.
//
// What holds it: not bytes. In ablated copies of the kernel (inference
// shapes, bf16, 16-byte vectors) dropping the stores changed little,
// and dropping every feature load still left over half the time: the
// per-thread work (the column walk, its branches, the tap phase) and
// the latency of each column's loads at the occupancy its registers
// allow hold it. 32-byte vectors halve that work per channel; one row
// loaded at a time keeps bf16 at 128 registers. Tried before it, each
// slower than the gather kernel in the same process: T = Ky F in shared
// memory (double buffered, one barrier a step) with one block per (box,
// channel tile) walking the rows (one L2 round trip and a barrier a
// step at about 20 warps an SM), also with several rows a step, and
// 16-byte vectors with the next column's loads issued ahead (spills).
//
// The gather design before it (one block per (box, output row), each
// thread loading the four taps of every sample of its bins as 16-byte
// vectors) ran at three times its byte bound.
//
// Backward design: one block per (image, band of R feature rows, tile
// of ct channels), with the band's f32 accumulator [R, W, ct] in
// dynamic shared memory (86 KB at W = 84: R = 4 x 64 f32 channels or
// R = 2 x 128 bf16 channels, two blocks an SM; the plan is
// ops/roi_align.py:_bwd_plan). The row-per-block design before it (one
// thread a channel, 2-byte loads, two barriers and a tap computation
// per box and feature row, each bin row of g read once per feature row
// its samples touch) was held by latency, not bytes: it took the same
// time in f32 and bf16. Here the block walks its image's boxes in index
// order. Its last warp finds the next box whose sample span can reach
// the band and computes that box's taps with the forward's code (Ky of
// the band's rows, the x taps) into the other of two slots, while the
// other seven warps contract the current box:
//   u[r, q, c] = sum_p Ky[p, h0 + r] g[n, p, q, c]
// in registers, one thread a (bin column q, 16-byte channel vector), the
// bin rows loaded four at a time (the first four one box ahead): each
// bin row of g is read once a band, about 1 + 2 / R times in all, and
// the per-box work and barriers (two a box) are paid once a band, not
// once a row. They also fill the box's dense Kx[q, x] over its columns.
// Then every thread spreads u over x: one thread a (column x, channel
// vector) adds Kx[q, x] u[r, q] for q ascending into its accumulator
// cells. Each cell has one owner and the boxes come in index order, so
// no atomics are needed and the result is the same bits on every run.
// The band is stored once, in g's dtype.
//
// What holds it now: the per-box latency chain (two barriers, the tap
// arithmetic, shared-memory round trips), not the bytes of g; f32 and
// bf16 again take about the same time. clock64() counters in a debug
// copy put the largest part of a step in spreading u over x.
//
// Numerics shared by both: the sample taps are computed in f32 with the
// same operations as the plain version: x*scale - 0.5 (no FMA
// contraction: IEEE __f*_rn operations, so that ceil() of an adaptive
// bin size picks the plain version's sample count), adaptive
// sr = clip(ceil(bin), 0, 8) with weight 1/max(sr, 1), torchvision's
// border rules (outside [-1, dim] gives 0, else clamp to [0, dim-1],
// high = min(low + 1, dim - 1)). Sums are kept in f32 and stored once.
// Degenerate boxes (size <= 0, adaptive) have no samples, and boxes
// wholly outside the image only zero weights: both give exactly 0
// forward and contribute exactly 0 backward.
#include <math.h>

#include "common.cuh"
#include "roi_taps.cuh"

namespace {

using locov::Box;
using locov::dense_bin;
using locov::from_f32;
using locov::load_box;
using locov::SR_MAX;
using locov::Tap;
using locov::to_f32;
using locov::Vec;
using locov::bin_taps;

constexpr int P_MAX = 32;   // largest pooled resolution taken

// The backward's block: BWD_THREADS threads, of which the last warp
// prepares the next box (finds it, computes its taps) while the others
// contract the current one. The launch plan (band rows R, channel tile
// ct) comes from ops/roi_align.py:_bwd_plan, whose shared-memory count
// mirrors bwd_smem_bytes; the C entry refuses a plan whose count differs.
constexpr int BWD_THREADS = 256;
constexpr int BWD_WORK = BWD_THREADS - 32;  // threads that contract
// bin rows a contracting thread loads in one batch (its first item's
// first batch one box ahead)
constexpr int BWD_PF = 4;

// One box's taps for a band, in shared memory: its y and x taps, Ky of
// the band's rows and a summary (box index or -1 when no box is left, the
// bin rows [pa, pb] that weigh on the band, the columns [xa, xb] that
// its non-zero x taps hit).
struct BoxTaps {
  Tap* ys;    // [pooled][SR_MAX]
  Tap* xs;    // [pooled][SR_MAX]
  int* nxs;   // [pooled]
  float* ky;  // [pooled][R]: Ky[p, h0 + r]
  int* meta;  // bi, pa, pb, xa, xb
};

__host__ __device__ inline size_t bwd_taps_bytes(int rows, int pooled) {
  return 2 * sizeof(Tap) * pooled * SR_MAX +
         4 * (size_t)pooled * (1 + rows) + 4 * 8;
}

size_t bwd_smem_bytes(int rows, int w, int ct, int pooled) {
  return 4 * ((size_t)rows * w * ct + (size_t)rows * pooled * ct +
              (size_t)pooled * w) +
         2 * bwd_taps_bytes(rows, pooled);
}

__device__ __forceinline__ BoxTaps box_taps_at(char* base, int rows,
                                               int pooled) {
  BoxTaps s;
  s.ys = reinterpret_cast<Tap*>(base);
  s.xs = s.ys + pooled * SR_MAX;
  s.nxs = reinterpret_cast<int*>(s.xs + pooled * SR_MAX);
  s.ky = reinterpret_cast<float*>(s.nxs + pooled);
  s.meta = reinterpret_cast<int*>(s.ky + pooled * rows);
  return s;
}

// By one warp: the first box of the image at or after `from` whose
// sample span can reach rows [h0, h0 + rows), or -1. A box's y samples
// lie within its extent, clamped, one cell below (the high tap) and one
// of margin each side against rounding.
__device__ __forceinline__ int next_box(const float* boxes, int from, int n,
                                        int h, int h0, int rows,
                                        float scale, int lane) {
  for (int base = from; base < n; base += 32) {
    bool hit = false;
    if (base + lane < n) {
      const Box bx = load_box(boxes + (base + lane) * 4, scale);
      const float ya = fminf(bx.y0, bx.y0 + bx.bh);
      const float yb = fmaxf(bx.y0, bx.y0 + bx.bh);
      const float top =
          floorf(fminf(fmaxf(ya, 0.0f), (float)(h - 1))) - 1.0f;
      const float bottom =
          floorf(fminf(fmaxf(yb, 0.0f), (float)(h - 1))) + 2.0f;
      hit = (float)(h0 + rows - 1) >= top && (float)h0 <= bottom;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, hit);
    if (bits) return base + __ffs(bits) - 1;
  }
  return -1;
}

// By one warp: box bi's taps for the band into `s` (lane j < pooled: y
// bin j, pooled <= j < 2 pooled: x bin j - pooled, with the forward's
// code), and its summary.
template <int R>
__device__ __forceinline__ void box_taps(const float* boxes, int bi,
                                         int h, int w, int h0, int pooled,
                                         int ratio, float scale, int lane,
                                         BoxTaps s) {
  if (bi < 0) {
    if (lane == 0) s.meta[0] = -1;
    return;
  }
  const Box bx = load_box(boxes + bi * 4, scale);
  int pa = pooled, pb = -1, xa = w, xb = -1;
  for (int j = lane; j < 2 * pooled; j += 32) {
    // the same code for both axes, so that the lanes do not diverge
    const bool y = j < pooled;
    const int bin = y ? j : j - pooled;
    Tap* tt = (y ? s.ys : s.xs) + bin * SR_MAX;
    const int nt = bin_taps(y ? bx.y0 : bx.x0, y ? bx.bh : bx.bw, pooled,
                            ratio, bin, y ? h : w, tt);
    if (y) {
      float k[R];
#pragma unroll
      for (int r = 0; r < R; ++r) k[r] = 0.0f;
      for (int t = 0; t < nt; ++t) {
        const Tap tp = tt[t];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (tp.lo == h0 + r) k[r] += tp.wlo;
          if (tp.hi == h0 + r) k[r] += tp.whi;
        }
      }
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s.ky[bin * R + r] = k[r];
        any = any || k[r] != 0.0f;
      }
      if (any) {
        pa = min(pa, bin);
        pb = max(pb, bin);
      }
    } else {
      for (int t = 0; t < nt; ++t) {
        const Tap tp = tt[t];
        if (tp.wlo != 0.0f) {
          xa = min(xa, tp.lo);
          xb = max(xb, tp.lo);
        }
        if (tp.whi != 0.0f) {
          xa = min(xa, tp.hi);
          xb = max(xb, tp.hi);
        }
      }
      s.nxs[bin] = nt;
    }
  }
  pa = __reduce_min_sync(0xffffffffu, pa);
  pb = __reduce_max_sync(0xffffffffu, pb);
  xa = __reduce_min_sync(0xffffffffu, xa);
  xb = __reduce_max_sync(0xffffffffu, xb);
  if (lane == 0) {
    s.meta[0] = bi;
    s.meta[1] = pa;
    s.meta[2] = pb;
    s.meta[3] = xa;
    s.meta[4] = xb;
  }
}

// Columns of a box's x taps in the band's work, 0 when it adds nothing
// (no weight in the band's rows, or none inside the image's columns).
__device__ __forceinline__ int box_cols(const int* meta) {
  return (meta[2] >= meta[1] && meta[4] >= meta[3]) ? meta[4] - meta[3] + 1
                                                    : 0;
}

// The first BWD_PF bin rows [pa, pa + BWD_PF) that weigh on the band,
// of box `s`'s bin column q and channel vector v, into `ahead`: loaded
// one box ahead, while the block spreads the previous box over x.
template <typename T, int VEC>
__device__ __forceinline__ void load_ahead(const BoxTaps& s, const T* gimg,
                                           long long gbox, int q, int v,
                                           int pooled, int c,
                                           Vec<T, VEC> (&ahead)[BWD_PF]) {
  const int bi = s.meta[0];
  if (bi < 0 || box_cols(s.meta) == 0) return;
  const int pa = s.meta[1], pb = s.meta[2];
  const T* gq = gimg + (long long)bi * gbox + (long long)q * c + v * VEC;
#pragma unroll
  for (int j = 0; j < BWD_PF; ++j)
    if (pa + j <= pb)
      ahead[j] = *reinterpret_cast<const Vec<T, VEC>*>(
          gq + (long long)(pa + j) * pooled * c);
}

// VEC floats of channel vector v of a [ct]-channel row in shared memory.
// Rows are laid out in 4-float quarters: quarter j of every vector, then
// quarter j + 1, so that neighbouring threads read neighbouring 16 bytes
// (no bank conflicts at 8 bf16 channels a thread).
template <int VEC>
__device__ __forceinline__ float* svec(float* row, int v, int ct, int j) {
  if constexpr (VEC % 4 == 0) return row + j * (ct * 4 / VEC) + v * 4;
  return row + v;
}

template <int VEC>
__device__ __forceinline__ void lds(float* row, int v, int ct, float* out) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      const float4 f =
          *reinterpret_cast<const float4*>(svec<VEC>(row, v, ct, j));
      out[4 * j] = f.x;
      out[4 * j + 1] = f.y;
      out[4 * j + 2] = f.z;
      out[4 * j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = row[v * VEC + e];
  }
}

template <int VEC>
__device__ __forceinline__ void sts(float* row, int v, int ct,
                                    const float* in) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j)
      *reinterpret_cast<float4*>(svec<VEC>(row, v, ct, j)) =
          make_float4(in[4 * j], in[4 * j + 1], in[4 * j + 2], in[4 * j + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) row[v * VEC + e] = in[e];
  }
}

// ------------------------------------------------------------- forward
// Threads a forward block may have (one a channel vector of its tile).
constexpr int FWD_MAX_THREADS = 256;

// Dynamic shared memory of the forward block of `rows` output rows: the
// spans [pooled + rows][2] (the x bins' columns, the rows' feature
// rows), Kx [pooled][w] and Ky of its rows [rows][h].
size_t fwd_smem_bytes(int h, int w, int rows, int pooled) {
  return 4 * ((size_t)pooled * w + (size_t)rows * h +
              2 * ((size_t)pooled + rows));
}

// One VEC-channel vector to global memory, as streaming stores
// (st.global.cs: evict first), 16 bytes at a time.
template <typename T, int VEC>
__device__ __forceinline__ void store_stream(T* p, const Vec<T, VEC>& o) {
  if constexpr (sizeof(Vec<T, VEC>) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < (int)sizeof(Vec<T, VEC>) / 16; ++i)
      __stcs(reinterpret_cast<int4*>(p) + i,
             reinterpret_cast<const int4*>(&o)[i]);
  } else if constexpr (sizeof(Vec<T, VEC>) == 4) {
    __stcs(reinterpret_cast<int*>(p), *reinterpret_cast<const int*>(&o));
  } else
    __stcs(reinterpret_cast<unsigned short*>(p),
           *reinterpret_cast<const unsigned short*>(&o));
}

// t = sum_h Ky[h] F[h, x] over the feature rows [ha, hb], h ascending,
// for one channel vector (fx: F[0, x]); rows loaded four at a time, or
// one at a time at 16 channels a thread (fewer registers, more warps).
template <typename T, int VEC>
__device__ __forceinline__ void column_sum(const T* fx, long long frow,
                                          const float* ky, int ha, int hb,
                                          float (&t)[VEC]) {
  constexpr int PF = VEC >= 16 ? 1 : 4;
#pragma unroll
  for (int e = 0; e < VEC; ++e) t[e] = 0.0f;
  for (int h0 = ha; h0 <= hb; h0 += PF) {
    Vec<T, VEC> f[PF];
#pragma unroll
    for (int j = 0; j < PF; ++j)
      if (h0 + j <= hb)
        f[j] = *reinterpret_cast<const Vec<T, VEC>*>(fx + (h0 + j) * frow);
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      if (h0 + j <= hb) {
        const float k = ky[h0 + j];
#pragma unroll
        for (int e = 0; e < VEC; ++e) t[e] += k * to_f32(f[j].v[e]);
      }
    }
  }
}

// acc += k t
template <int VEC>
__device__ __forceinline__ void axpy(float (&acc)[VEC], float k,
                                     const float (&t)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] += k * t[e];
}

// One block of the forward: box bn, the group of `rows` output rows at
// p0, the channel tile at ch0, from the features [b, h, w, c] at `feat`
// scaled by `scale`. The body of roi_align_fwd_kernel and of
// roi_align_levels_fwd_kernel.
template <typename T, int VEC>
__device__ __forceinline__ void fwd_block(const T* __restrict__ feat,
                                          const float* __restrict__ boxes,
                                          T* __restrict__ out, int h, int w,
                                          int c, int n, int pooled,
                                          int ratio, float scale, int ct,
                                          int rows, long long bn, int p0,
                                          int ch0) {
  extern __shared__ float4 smem[];
  // [pooled + rows]: the cells each x bin, then each y bin of the
  // group, weighs on
  int2* spans = reinterpret_cast<int2*>(smem);
  float* kx = reinterpret_cast<float*>(spans + pooled + rows);  // [pooled][w]
  float* ky = kx + pooled * w;                                   // [rows][h]

  const int t = threadIdx.x;
  const int nrows = min(rows, pooled - p0);
  const long long img = bn / n;
  const Box bx = load_box(boxes + bn * 4, scale);

  // the box's dense weights: thread j < pooled x bin j, then one thread
  // for each y bin of the group
  for (int j = t; j < pooled + nrows; j += blockDim.x)
    spans[j] = j < pooled
                   ? dense_bin(bx.x0, bx.bw, pooled, ratio, j, w, kx + j * w)
                   : dense_bin(bx.y0, bx.bh, pooled, ratio, p0 + j - pooled,
                               h, ky + (j - pooled) * h);
  __syncthreads();

  const int nv = min(ct, c - ch0) / VEC;
  const T* fimg = feat + img * h * w * (long long)c + ch0;
  const long long frow = (long long)w * c;
  for (int r = 0; r < nrows; ++r) {
    const int ha = spans[pooled + r].x, hb = spans[pooled + r].y;
    const float* kyr = ky + r * h;
    T* orow = out + (bn * pooled + p0 + r) * pooled * (long long)c + ch0;
    for (int v = t; v < nv; v += blockDim.x) {
      const T* fv = fimg + v * VEC;
      // the sums of the two columns computed last, by the column's
      // parity (two neighbouring columns never share a slot), and their
      // columns
      float te[VEC], to[VEC];
      int xe = -1, xo = -1;
      for (int q = 0; q < pooled; ++q) {
        const int2 sp = spans[q];
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
        // out[p, q] = sum_x Kx[q, x] t_x, x ascending; each t_x computed
        // once while neighbouring bins share it
        for (int x = sp.x; x <= sp.y; ++x) {
          const float k = kx[q * w + x];
          const T* fx = fv + (long long)x * c;
          if (x & 1) {
            if (x != xo) {
              column_sum<T, VEC>(fx, frow, kyr, ha, hb, to);
              xo = x;
            }
            axpy<VEC>(acc, k, to);
          } else {
            if (x != xe) {
              column_sum<T, VEC>(fx, frow, kyr, ha, hb, te);
              xe = x;
            }
            axpy<VEC>(acc, k, te);
          }
        }
        Vec<T, VEC> o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) o.v[e] = from_f32<T>(acc[e]);
        store_stream<T, VEC>(orow + (long long)q * c + v * VEC, o);
      }
    }
  }
}

// grid: (box, group of `rows` output rows, channel tile) in that order,
// the boxes in index order; fwd_smem_bytes(h, w, rows, pooled) of
// dynamic shared memory; threads over the tile's channel vectors, each
// walking the group's rows. VEC channels a thread (32 or 16 bytes, or
// 1).
template <typename T, int VEC>
__global__ void __launch_bounds__(FWD_MAX_THREADS)
roi_align_fwd_kernel(const T* __restrict__ feat,
                     const float* __restrict__ boxes, T* __restrict__ out,
                     int h, int w, int c, int n, int pooled, int ratio,
                     float scale, int ct, int rows) {
  const int ntiles = (c + ct - 1) / ct;
  const int groups = (pooled + rows - 1) / rows;
  const long long bn = blockIdx.x / ((long long)ntiles * groups);
  const int p0 = blockIdx.x / ntiles % groups * rows;
  const int ch0 = (blockIdx.x % ntiles) * ct;
  fwd_block<T, VEC>(feat, boxes, out, h, w, c, n, pooled, ratio, scale, ct,
                    rows, bn, p0, ch0);
}

// The feature levels of a pyramid that roi_align_levels_fwd_kernel pools
// from: each level's map [b, h, w, c] and its scale (1 / stride).
constexpr int MAX_LEVELS = 4;
struct Levels {
  const void* feat[MAX_LEVELS];
  int h[MAX_LEVELS], w[MAX_LEVELS];
  float scale[MAX_LEVELS];
};

// ROIAlign across the levels of a pyramid: the grid and the blocks of
// roi_align_fwd_kernel, each box pooled from its own level (levels[bn],
// 0 .. nlevels - 1) only; the dynamic shared memory the largest that a
// level asks for.
template <typename T, int VEC>
__global__ void __launch_bounds__(FWD_MAX_THREADS)
roi_align_levels_fwd_kernel(Levels lv, const float* __restrict__ boxes,
                            const int* __restrict__ levels,
                            T* __restrict__ out, int c, int n, int pooled,
                            int ratio, int ct, int rows) {
  const int ntiles = (c + ct - 1) / ct;
  const int groups = (pooled + rows - 1) / rows;
  const long long bn = blockIdx.x / ((long long)ntiles * groups);
  const int p0 = blockIdx.x / ntiles % groups * rows;
  const int ch0 = (blockIdx.x % ntiles) * ct;
  const int l = levels[bn];
  fwd_block<T, VEC>(static_cast<const T*>(lv.feat[l]), boxes, out, lv.h[l],
                    lv.w[l], c, n, pooled, ratio, lv.scale[l], ct, rows, bn,
                    p0, ch0);
}

// ------------------------------------------------------------ backward
// ua[r] += Ky[p, h0 + r] * g[p, q, channel vector]
template <typename T, int VEC, int R>
__device__ __forceinline__ void add_row(float (&ua)[R][VEC], const float* ky,
                                        const Vec<T, VEC>& gv) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float k = ky[r];
#pragma unroll
    for (int e = 0; e < VEC; ++e) ua[r][e] += k * to_f32(gv.v[e]);
  }
}

// grid (bands of R feature rows, channel tiles of ct, images),
// BWD_THREADS threads, bwd_smem_bytes(R, w, ct, pooled) of dynamic
// shared memory. VEC channels a thread (16 bytes, or 1).
template <typename T, int VEC, int R>
__global__ void __launch_bounds__(BWD_THREADS, 2)
roi_align_bwd_kernel(const T* __restrict__ g, const float* __restrict__ boxes,
                     T* __restrict__ df, int h, int w, int c, int n,
                     int pooled, int ratio, float scale, int ct) {
  extern __shared__ float4 smem[];
  float* acc = reinterpret_cast<float*>(smem);  // [R][w][ct]: dF of the band
  float* u = acc + R * w * ct;       // [R][pooled][ct]: Ky-contracted g
  float* kx = u + R * pooled * ct;   // [pooled][w]: Kx[q, x] of the box
  char* tb = reinterpret_cast<char*>(kx + pooled * w);
  const BoxTaps slot0 = box_taps_at(tb, R, pooled);
  const BoxTaps slot1 = box_taps_at(tb + bwd_taps_bytes(R, pooled), R,
                                    pooled);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const bool taps_warp = t >= BWD_WORK;
  const int h0 = blockIdx.x * R;
  const int ch0 = blockIdx.y * ct;
  const long long img = blockIdx.z;
  const int nv = min(ct, c - ch0) / VEC;  // channel vectors in this tile
  const float* bimg = boxes + img * n * 4;
  const long long gbox = (long long)pooled * pooled * c;
  const T* gimg = g + img * n * gbox + ch0;
  // the item (bin column q, channel vector v) a contracting thread takes
  // first; its first BWD_PF bin rows of each box are loaded one box ahead
  const bool first_item = t < BWD_WORK && t < pooled * nv;
  const int q0 = first_item ? t / nv : 0, v0 = first_item ? t % nv : 0;
  Vec<T, VEC> ahead[BWD_PF];

  for (int i = t; i < R * w * ct; i += BWD_THREADS) acc[i] = 0.0f;
  if (taps_warp)
    box_taps<R>(bimg, next_box(bimg, 0, n, h, h0, R, scale, lane), h, w, h0,
                pooled, ratio, scale, lane, slot0);
  __syncthreads();

  if (first_item)
    load_ahead<T, VEC>(slot0, gimg, gbox, q0, v0, pooled, c, ahead);

  // Two barriers a box. Box i's taps (slot i % 2) were written before
  // the barrier that starts step i and are read up to the next one; box
  // i + 1's taps go to the other slot meanwhile. u and kx are written
  // between the two barriers and read after the second.
  for (int i = 0;; ++i) {
    const BoxTaps cur = (i & 1) ? slot1 : slot0;
    const BoxTaps next = (i & 1) ? slot0 : slot1;
    const int bi = cur.meta[0];
    if (bi < 0) break;
    const int pa = cur.meta[1], pb = cur.meta[2], xa = cur.meta[3];
    const int ncols = box_cols(cur.meta);
    if (taps_warp) {
      box_taps<R>(bimg, next_box(bimg, bi + 1, n, h, h0, R, scale, lane), h,
                  w, h0, pooled, ratio, scale, lane, next);
    } else if (ncols > 0) {
      // Kx[q, x] over the box's columns, its samples summed in order
      for (int k = t; k < pooled * ncols; k += BWD_WORK) {
        const int q = k / ncols, x = xa + k % ncols;
        const Tap* xt = cur.xs + q * SR_MAX;
        float v = 0.0f;
        for (int s = 0; s < cur.nxs[q]; ++s) {
          if (xt[s].lo == x) v += xt[s].wlo;
          if (xt[s].hi == x) v += xt[s].whi;
        }
        kx[q * w + x] = v;
      }
      // u[r, q] = sum_p Ky[p, h0 + r] g[p, q] (p ascending): each bin
      // row that weighs on the band is read once for all R rows, 16
      // bytes a thread
      const T* gb = gimg + (long long)bi * gbox;
      for (int k = t; k < pooled * nv; k += BWD_WORK) {
        const int q = k / nv, v = k % nv;
        const T* gq = gb + (long long)q * c + v * VEC;
        float ua[R][VEC];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < VEC; ++e) ua[r][e] = 0.0f;
        // the first item's first rows were loaded one box ahead; later
        // batches reuse the same registers
        for (int p = pa; p <= pb; p += BWD_PF) {
          if (k != t || p != pa) {
#pragma unroll
            for (int j = 0; j < BWD_PF; ++j)
              if (p + j <= pb)
                ahead[j] = *reinterpret_cast<const Vec<T, VEC>*>(
                    gq + (long long)(p + j) * pooled * c);
          }
#pragma unroll
          for (int j = 0; j < BWD_PF; ++j)
            if (p + j <= pb)
              add_row<T, VEC, R>(ua, cur.ky + (p + j) * R, ahead[j]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
          sts<VEC>(u + (r * pooled + q) * ct, v, ct, ua[r]);
      }
    }
    __syncthreads();

    if (first_item)
      load_ahead<T, VEC>(next, gimg, gbox, q0, v0, pooled, c, ahead);
    // dF[h0 + r, x] += sum_q Kx[q, x] u[r, q] (q ascending); each
    // (column, channel vector) has one owner, so no atomics
    for (int k = t; k < ncols * nv; k += BWD_THREADS) {
      const int x = xa + k / nv, v = k % nv;
      float a[R][VEC];
#pragma unroll
      for (int r = 0; r < R; ++r)
        lds<VEC>(acc + (r * w + x) * ct, v, ct, a[r]);
      for (int q0 = 0; q0 < pooled; q0 += 8) {
        float kw[8];  // eight bins' weights read together
#pragma unroll
        for (int j = 0; j < 8; ++j)
          kw[j] = q0 + j < pooled ? kx[(q0 + j) * w + x] : 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (kw[j] == 0.0f) continue;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float uv[VEC];
            lds<VEC>(u + (r * pooled + q0 + j) * ct, v, ct, uv);
#pragma unroll
            for (int e = 0; e < VEC; ++e) a[r][e] += kw[j] * uv[e];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        sts<VEC>(acc + (r * w + x) * ct, v, ct, a[r]);
    }
    __syncthreads();
  }

  // the band's rows inside the image, stored once in g's dtype
  for (int k = t; k < R * w * nv; k += BWD_THREADS) {
    const int r = k / (w * nv), x = (k / nv) % w, v = k % nv;
    if (h0 + r >= h) break;
    float a[VEC];
    lds<VEC>(acc + (r * w + x) * ct, v, ct, a);
    Vec<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) o.v[e] = from_f32<T>(a[e]);
    *reinterpret_cast<Vec<T, VEC>*>(
        df + ((img * h + h0 + r) * (long long)w + x) * c + ch0 + v * VEC) = o;
  }
}

template <typename T, int VEC>
int launch_fwd(const void* feat, const float* boxes, void* out, int b, int h,
               int w, int c, int n, int pooled, int ratio, float scale,
               int ct, int rows, int threads, int smem,
               cudaStream_t stream) {
  auto kernel = roi_align_fwd_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)b * n * ((pooled + rows - 1) / rows) *
                           ((c + ct - 1) / ct);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(feat), boxes, static_cast<T*>(out), h, w, c, n,
      pooled, ratio, scale, ct, rows);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_levels_fwd(const Levels& lv, const float* boxes,
                      const int* levels, void* out, int b, int c, int n,
                      int pooled, int ratio, int ct, int rows, int threads,
                      int smem, cudaStream_t stream) {
  auto kernel = roi_align_levels_fwd_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)b * n * ((pooled + rows - 1) / rows) *
                           ((c + ct - 1) / ct);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      lv, boxes, levels, static_cast<T*>(out), c, n, pooled, ratio, ct,
      rows);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int R>
int launch_bwd(const void* g, const float* boxes, void* df, int b, int h,
               int w, int c, int n, int pooled, int ratio, float scale,
               int ct, int smem, cudaStream_t stream) {
  auto kernel = roi_align_bwd_kernel<T, VEC, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((h + R - 1) / R, (c + ct - 1) / ct, b);
  kernel<<<grid, BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(g), boxes, static_cast<T*>(df), h, w, c, n,
      pooled, ratio, scale, ct);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_bwd_rows(const void* g, const float* boxes, void* df, int b,
                    int h, int w, int c, int n, int pooled, int ratio,
                    float scale, int rows, int ct, int smem,
                    cudaStream_t stream) {
  switch (rows) {
    case 4:
      return launch_bwd<T, VEC, 4>(g, boxes, df, b, h, w, c, n, pooled,
                                   ratio, scale, ct, smem, stream);
    case 2:
      return launch_bwd<T, VEC, 2>(g, boxes, df, b, h, w, c, n, pooled,
                                   ratio, scale, ct, smem, stream);
    case 1:
      return launch_bwd<T, VEC, 1>(g, boxes, df, b, h, w, c, n, pooled,
                                   ratio, scale, ct, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// feat [b, h, w, c] (dtype 0 = float32, 1 = bfloat16), boxes [b, n, 4]
// float32 XYXY in image coordinates -> out [b, n, pooled, pooled, c] in
// feat's dtype, every element written. ratio > 0: fixed samples per bin
// per axis (<= 8); ratio <= 0: adaptive. pooled <= 32. vec: channels per
// thread (1; or 32 or 16 bytes' worth, as c and feat's alignment
// allow).
// The plan (ops/roi_align.py:_fwd_plan): channel_tile a multiple of 8 and
// of vec, rows output rows a block in [1, pooled], threads a multiple of
// 32 in [32, 256], smem_bytes = fwd_smem_bytes(h, w, rows, pooled).
// Returns cudaErrorInvalidValue for a plan
// the kernel does not take, else the first CUDA error of the launch, or
// 0.
extern "C" int roi_align_fwd(const void* feat, const void* boxes,
                             void* out, int b, int h, int w, int c, int n,
                             int pooled, int ratio, float scale, int dtype,
                             int vec, int channel_tile, int rows,
                             int threads, int smem_bytes, void* stream) {
  if (pooled < 1 || pooled > P_MAX || vec < 1 || channel_tile <= 0 ||
      channel_tile % 8 || channel_tile % vec || rows < 1 || rows > pooled ||
      threads < 32 || threads % 32 || threads > FWD_MAX_THREADS ||
      (size_t)smem_bytes != fwd_smem_bytes(h, w, rows, pooled))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
#define LOCOV_FWD(T, V)                                                    \
  if (vec == V)                                                            \
    return launch_fwd<T, V>(feat, bx, out, b, h, w, c, n, pooled, ratio,   \
                            scale, channel_tile, rows, threads, smem_bytes, \
                            s);
  if (dtype == 0) {
    LOCOV_FWD(float, 8)
    LOCOV_FWD(float, 4)
    LOCOV_FWD(float, 1)
  } else if (dtype == 1) {
    LOCOV_FWD(__nv_bfloat16, 16)
    LOCOV_FWD(__nv_bfloat16, 8)
    LOCOV_FWD(__nv_bfloat16, 1)
  }
#undef LOCOV_FWD
  return (int)cudaErrorInvalidValue;
}

// ROIAlign across pyramid levels: feats[l] [b, hs[l], ws[l], c] for l <
// nlevels (<= 4), one dtype, scales[l] each level's 1 / stride, levels
// [b, n] int32 each box's level -> out [b, n, pooled, pooled, c], each
// box pooled from its own level once, every element written. One
// launch; the plan as for roi_align_fwd, with smem_bytes the largest
// fwd_smem_bytes of a level.
extern "C" int roi_align_levels_fwd(const long long* feats, const int* hs,
                                    const int* ws, const float* scales,
                                    int nlevels, const void* boxes,
                                    const void* levels, void* out, int b,
                                    int c, int n, int pooled, int ratio,
                                    int dtype, int vec, int channel_tile,
                                    int rows, int threads, int smem_bytes,
                                    void* stream) {
  if (nlevels < 1 || nlevels > MAX_LEVELS || pooled < 1 || pooled > P_MAX ||
      vec < 1 || channel_tile <= 0 || channel_tile % 8 ||
      channel_tile % vec || rows < 1 || rows > pooled || threads < 32 ||
      threads % 32 || threads > FWD_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  size_t need = 0;
  for (int l = 0; l < nlevels; ++l) {
    lv.feat[l] = reinterpret_cast<const void*>(feats[l]);
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
    lv.scale[l] = scales[l];
    need = need > fwd_smem_bytes(hs[l], ws[l], rows, pooled)
               ? need
               : fwd_smem_bytes(hs[l], ws[l], rows, pooled);
  }
  if ((size_t)smem_bytes != need) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  const int* lvl = static_cast<const int*>(levels);
#define LOCOV_LEVELS(T, V)                                                 \
  if (vec == V)                                                            \
    return launch_levels_fwd<T, V>(lv, bx, lvl, out, b, c, n, pooled, ratio, \
                                   channel_tile, rows, threads, smem_bytes, \
                                   s);
  if (dtype == 0) {
    LOCOV_LEVELS(float, 8)
    LOCOV_LEVELS(float, 4)
    LOCOV_LEVELS(float, 1)
  } else if (dtype == 1) {
    LOCOV_LEVELS(__nv_bfloat16, 16)
    LOCOV_LEVELS(__nv_bfloat16, 8)
    LOCOV_LEVELS(__nv_bfloat16, 1)
  }
#undef LOCOV_LEVELS
  return (int)cudaErrorInvalidValue;
}

// g [b, n, pooled, pooled, c] (dtype 0 = float32, 1 = bfloat16), boxes
// as for the forward -> df [b, h, w, c] in g's dtype, every element
// written. The plan (ops/roi_align.py:_bwd_plan): band_rows 1, 2 or 4,
// channel_tile a multiple of 8, smem_bytes = bwd_smem_bytes(band_rows,
// w, channel_tile, pooled); vec channels a thread (1, or 16 bytes'
// worth: c % vec == 0 and g 16-byte aligned). Returns
// cudaErrorInvalidValue for a plan the kernel does not take, else the
// first CUDA error of the launch, or 0.
extern "C" int roi_align_bwd(const void* g, const void* boxes, void* df,
                             int b, int h, int w, int c, int n, int pooled,
                             int ratio, float scale, int dtype, int vec,
                             int band_rows, int channel_tile, int smem_bytes,
                             void* stream) {
  if (channel_tile <= 0 || channel_tile % 8 || pooled > P_MAX ||
      (size_t)smem_bytes !=
          bwd_smem_bytes(band_rows, w, channel_tile, pooled))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  if (dtype == 0 && vec == 4)
    return launch_bwd_rows<float, 4>(g, bx, df, b, h, w, c, n, pooled,
                                     ratio, scale, band_rows, channel_tile,
                                     smem_bytes, s);
  if (dtype == 0 && vec == 1)
    return launch_bwd_rows<float, 1>(g, bx, df, b, h, w, c, n, pooled,
                                     ratio, scale, band_rows, channel_tile,
                                     smem_bytes, s);
  if (dtype == 1 && vec == 8)
    return launch_bwd_rows<__nv_bfloat16, 8>(g, bx, df, b, h, w, c, n,
                                             pooled, ratio, scale, band_rows,
                                             channel_tile, smem_bytes, s);
  if (dtype == 1 && vec == 1)
    return launch_bwd_rows<__nv_bfloat16, 1>(g, bx, df, b, h, w, c, n,
                                             pooled, ratio, scale, band_rows,
                                             channel_tile, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
