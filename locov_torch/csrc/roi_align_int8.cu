// KQ2: the full-int8 ROIAlign of the static int8 serving mode
// (locov_torch/ops/roi_align.py: roi_align_batched_int8), from the boxes.
//
// It has no Pallas parent: the JAX package computes this op as two XLA
// einsums a chunk of boxes against interpolation matrices it builds and
// quantizes per row (locov_tpu/ops/roi_align.py: roi_align_batched_int8).
// For box (b, n), channel c:
//   kxq[q, w], sx[q]  the box's Kx row q quantized to int8 by its max-abs
//   kyq[p, h], sy[p]  the same for Ky; rescale[p] = ratio * sy[p]
//   t[q, h]  = sum_w kxq[q, w] * fq[b, h, w, c]                (int32)
//   tq[q, h] = clip(rint(f32(t) * sx[q]), -127, 127)
//   r[p, q]  = sum_h kyq[p, h] * tq[q, h]                      (int32)
//   out[b, n, p, q, c] = clip(rint(f32(r) * rescale[p]), -127, 127)
// with ratio = s_f / s_pool (a device scalar, never read on the host),
// rint half to even, and each float product rounded once, as the plain
// version (ops/roi_align.py: int8_matrices, roi_align_int8_plain)
// computes them. The matrices come from the float kernels' tap code
// (roi_taps.cuh): each bin's samples summed in ascending order from 0,
// then scale = max(amax / 127, 1e-12) and q = clip(rint(k / scale)) a row.
//
// Exactness: zero weights add exactly 0, so skipping them leaves the
// integers of the dense einsums. A row of kxq or kyq holds at most
// 2 * SR_MAX non-zeros (two taps a sample), so |t|, |r| <= 16 * 127 * 127
// < 2^22: the sums start from the bits of the float 1.5 * 2^23, so that
// they end as the float 1.5 * 2^23 + t, and less 1.5 * 2^23 that is
// f32(t), exact; rint(v) of |v| <= 127 is the low byte of 1.5 * 2^23 + v.
//
// Bound on the H100: bytes. The int8 output [8, 1000, 14, 14, 1024] is
// 1.6 GB, 0.48 ms at 3.35 TB/s, against the features' 34 MB, which the
// 50 MB L2 holds.
//
// Design: one block a box, the boxes in index order, so that the blocks
// in flight work on one image's features, which stay in L2. The block's
// first two warps build the box's quantized matrices (one axis each),
// their non-zero spans and its scales into shared memory (one barrier),
// then every thread takes a (bin column q, vector of VEC channels) at a
// time, VEC = 16 where the channels allow it, and for it:
//   (a) for each group of four feature rows that some Ky row weighs on,
//       t over q's column span, as one __dp4a a column, row and 4
//       channels (the feature word against the weight in one byte
//       lane), two columns of the four rows in flight at once; rounded
//       to tq and packed four rows to a word a channel into the thread's
//       own part of shared memory (no barrier: no other thread reads
//       it);
//   (b) for each bin p, r over the words of p's row span only, one
//       __dp4a for 4 rows (kyq's rows are row-contiguous in shared
//       memory), rounded and stored as one VEC-byte streaming store
//       (st.global.cs), so that the output does not evict the features.
// The tq rows (h x VEC bytes a thread) bound the blocks an SM: two of
// 128 threads at h = 50.
//
// What holds it: instructions, not bytes (tools/ablate_roi_int8.py on
// the H100 at the static path's shapes; PERF.md): without the feature
// loads or without the stores it runs within 2% of its time, without
// phase (a) in under half. Each int8 value made (tq, then the output)
// costs five float operations and a byte permute, more than its __dp4a
// work. Tried and slower: three or four columns at once (more wasted
// products on short spans), the loops over bins or row groups unrolled
// by two, phase (b)'s products as multiply-adds of extracted bytes, the
// last tq group held in registers for the next bin, the clip done on
// 16-bit pairs (max/min.s16x2), one builder warp for both matrices,
// persistent blocks walking the boxes with a warp building the next box
// (commit be32209: the blocks that drew large boxes finished last), and
// tq held in a ring of eight row groups for three blocks an SM (commit
// 3095684: the interleaved phases cost more than the warps gained).
#include <stdint.h>

#include <cuda_runtime.h>

#include "roi_taps.cuh"

namespace {

using locov::bin_taps;
using locov::Box;
using locov::load_box;
using locov::SR_MAX;
using locov::Tap;
using locov::tap_span;
using locov::tap_weight;

constexpr int PMAX = 16;  // bins a side the kernel takes

// 1.5 * 2^23: integers below 2^22 in magnitude sit in its mantissa.
constexpr float MAGIC = 12582912.0f;
constexpr int MAGIC_BITS = 0x4B400000;

// clip(rint(f32(t) * s), -127, 127) in the low byte, for |t| < 2^22
// given as MAGIC_BITS + t (the sums start from MAGIC_BITS).
__device__ __forceinline__ unsigned q8(int biased_t, float s) {
  float v = __fmul_rn(__fsub_rn(__int_as_float(biased_t), MAGIC), s);
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(v, MAGIC));
}

// acc + the dot product of two words' four signed bytes.
__device__ __forceinline__ int dot4(int a, int b, int acc) {
  return __dp4a(a, b, acc);
}

// One box's operands in shared memory: its quantized matrices (rows of
// wp and hp bytes, zero outside their span; hp a multiple of 4), the
// non-zero span of each row, the row scales of Kx and the rescale of Ky,
// and the rows [ya, yb] that some Ky row weighs on.
struct BoxOps {
  int8_t* kx;  // [PMAX][wp]
  int8_t* ky;  // [PMAX][hp]
  int2* xspan;  // [PMAX]
  int2* yspan;  // [PMAX]
  float* sx;    // [PMAX]
  float* rs;    // [PMAX]
  int* meta;    // ya, yb
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ inline int ops_bytes(int h, int w) {
  return round_up(PMAX * (round_up(w, 4) + round_up(h, 4)), 16) +
         4 * (6 * PMAX + 4);
}

__device__ __forceinline__ BoxOps ops_at(uint8_t* base, int h, int w) {
  BoxOps s;
  s.kx = reinterpret_cast<int8_t*>(base);
  s.ky = s.kx + PMAX * round_up(w, 4);
  int2* tail = reinterpret_cast<int2*>(
      base + round_up(PMAX * (round_up(w, 4) + round_up(h, 4)), 16));
  s.xspan = tail;
  s.yspan = tail + PMAX;
  s.sx = reinterpret_cast<float*>(tail + 2 * PMAX);
  s.rs = s.sx + PMAX;
  s.meta = reinterpret_cast<int*>(s.rs + PMAX);
  return s;
}

// By one warp: one axis of box bi's operands into `s` (lane j < p: Ky
// row j, or Kx row j), and for Ky the rows it weighs on.
__device__ __forceinline__ void build_axis(const float* boxes, int bi,
                                           bool y, int h, int w, int p,
                                           int ratio_s, float scale,
                                           float ratio, int lane, BoxOps s) {
  const Box bx = load_box(boxes + (long long)bi * 4, scale);
  const int dim = y ? h : w;
  int lo = dim, hi = -1;
  if (lane < p) {
    const int stride = round_up(dim, 4);
    int8_t* row = (y ? s.ky : s.kx) + lane * stride;
    Tap taps[SR_MAX];
    const int nt = bin_taps(y ? bx.y0 : bx.x0, y ? bx.bh : bx.bw, p,
                            ratio_s, lane, dim, taps);
    const int2 span = tap_span(taps, nt, dim);
    float amax = 0.0f;
    for (int i = span.x; i <= span.y; ++i)
      amax = fmaxf(amax, fabsf(tap_weight(taps, nt, i)));
    const float rs = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
    for (int i = 0; i < stride / 4; ++i)
      reinterpret_cast<int*>(row)[i] = 0;
    for (int i = span.x; i <= span.y; ++i) {
      const float v = rintf(__fdiv_rn(tap_weight(taps, nt, i), rs));
      const int qv = (int)fminf(fmaxf(v, -127.0f), 127.0f);
      row[i] = (int8_t)qv;
      if (qv != 0) {
        lo = min(lo, i);
        hi = i;
      }
    }
    if (y) {
      s.yspan[lane] = make_int2(lo, hi);
      s.rs[lane] = __fmul_rn(ratio, rs);
    } else {
      s.xspan[lane] = make_int2(lo, hi);
      s.sx[lane] = rs;
    }
  }
  if (y) {
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      s.meta[0] = lo;
      s.meta[1] = hi;
    }
  }
}

// VEC int8 channels as VEC / 4 words.
template <int VEC>
struct Words {
  int v[VEC / 4];
};

template <int VEC>
__device__ __forceinline__ Words<VEC> load_words(const int8_t* p) {
  Words<VEC> r;
  if constexpr (VEC == 16) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    r.v[0] = x.x;
    r.v[1] = x.y;
    r.v[2] = x.z;
    r.v[3] = x.w;
  } else if constexpr (VEC == 8) {
    const int2 x = __ldg(reinterpret_cast<const int2*>(p));
    r.v[0] = x.x;
    r.v[1] = x.y;
  } else {
    r.v[0] = __ldg(reinterpret_cast<const int*>(p));
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store_stream(int8_t* p, const Words<VEC>& o) {
  if constexpr (VEC == 16)
    __stcs(reinterpret_cast<int4*>(p),
           make_int4(o.v[0], o.v[1], o.v[2], o.v[3]));
  else if constexpr (VEC == 8)
    __stcs(reinterpret_cast<int2*>(p), make_int2(o.v[0], o.v[1]));
  else
    __stcs(reinterpret_cast<int*>(p), o.v[0]);
}

// Columns of a row that phase (a) loads at once (two, for four rows:
// eight 16-byte loads in flight).
constexpr int XB = 2;

// Threads a block may have.
constexpr int MAX_THREADS = 128;

// grid: one block a box, in index order; block: `threads` (a multiple of
// 32), whose first two warps build the box's operands before all
// contract; dynamic shared memory smem_bytes(h, w, vec, threads).
template <int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
    roi_align_int8_kernel(const int8_t* __restrict__ fq,
                          const float* __restrict__ boxes,
                          const float* __restrict__ ratio,
                          int8_t* __restrict__ out, int h, int w, int c,
                          int n, int p, int ratio_s, float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tc = blockDim.x;
  const int tid = threadIdx.x;
  const int bi = blockIdx.x;  // b * n + i
  const BoxOps cur = ops_at(smem, h, w);
  // tq of each thread: word (g, channel e) at
  // tq4[(g * VEC / 4 + e / 4) * tc + tid], element e % 4
  int4* tq4 = reinterpret_cast<int4*>(smem + ops_bytes(h, w));
  // warp 0 builds Ky, warp 1 Kx (warp 0 both in a block of one warp)
  for (int axis = tid >> 5; axis < 2; axis += tc >> 5)
    build_axis(boxes, bi, axis == 0, h, w, p, ratio_s, scale, *ratio,
               tid & 31, cur);
  __syncthreads();
  const int wp = round_up(w, 4), hp = round_up(h, 4);
  const int nv = c / VEC;
  const int ya = cur.meta[0], yb = cur.meta[1];
  const int8_t* fimg = fq + (long long)(bi / n) * h * w * c;
  int8_t* obox = out + (long long)bi * p * p * c;
  for (int it = tid; it < p * nv; it += tc) {
    const int q = it / nv, v = it - q * nv;
    const int2 xs = cur.xspan[q];
    const float sxq = cur.sx[q];
    const int8_t* kx = cur.kx + q * wp;
    const int8_t* fv = fimg + v * VEC;
    // (a) tq[q, y] for the rows [ya, yb], four rows (a word) at once
    for (int g = ya >> 2; g <= (yb >> 2) && yb >= 0; ++g) {
      bool valid[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        valid[j] = 4 * g + j >= ya && 4 * g + j <= yb;
      int t[4][VEC];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) t[j][e] = MAGIC_BITS;
      const int8_t* fg = fv + (long long)(4 * g) * w * c;
      for (int x0 = xs.x; x0 <= xs.y; x0 += XB) {
        Words<VEC> f[4][XB];
        unsigned kb[XB];
#pragma unroll
        for (int u = 0; u < XB; ++u)
          kb[u] = x0 + u <= xs.y ? (unsigned)(uint8_t)kx[x0 + u] : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int u = 0; u < XB; ++u) {
            if (valid[j] && x0 + u <= xs.y)
              f[j][u] = load_words<VEC>(
                  fg + ((long long)j * w + x0 + u) * c);
            else
#pragma unroll
              for (int i = 0; i < VEC / 4; ++i) f[j][u].v[i] = 0;
          }
#pragma unroll
        for (int u = 0; u < XB; ++u)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int k = (int)(kb[u] << (8 * (e % 4)));
#pragma unroll
            for (int j = 0; j < 4; ++j)
              t[j][e] = __dp4a(f[j][u].v[e / 4], k, t[j][e]);
          }
      }
      // row j of the word in byte j; rows outside [ya, yb] hold 0 (their
      // t, no column added, would give 0 too)
      int pk[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) pk[e] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (valid[j])
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            pk[e] = __byte_perm(pk[e], q8(t[j][e], sxq),
                                0x3210u ^ ((unsigned)(j ^ 4) << (4 * j)));
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i)
        tq4[(g * (VEC / 4) + i) * tc + tid] =
            make_int4(pk[4 * i], pk[4 * i + 1], pk[4 * i + 2],
                      pk[4 * i + 3]);
    }
    // (b) out[p, q] over p's rows only
    for (int pp = 0; pp < p; ++pp) {
      const int2 ys = cur.yspan[pp];
      int r[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) r[e] = MAGIC_BITS;
      const int8_t* kyr = cur.ky + pp * hp;
      for (int g = ys.x >> 2; g <= (ys.y >> 2) && ys.y >= 0; ++g) {
        const int kw = *reinterpret_cast<const int*>(kyr + 4 * g);
#pragma unroll
        for (int i = 0; i < VEC / 4; ++i) {
          const int4 tw = tq4[(g * (VEC / 4) + i) * tc + tid];
          r[4 * i] = dot4(tw.x, kw, r[4 * i]);
          r[4 * i + 1] = dot4(tw.y, kw, r[4 * i + 1]);
          r[4 * i + 2] = dot4(tw.z, kw, r[4 * i + 2]);
          r[4 * i + 3] = dot4(tw.w, kw, r[4 * i + 3]);
        }
      }
      const float rs = cur.rs[pp];
      Words<VEC> o;
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i) {
        const unsigned ab = __byte_perm(q8(r[4 * i], rs),
                                        q8(r[4 * i + 1], rs), 0x0040);
        const unsigned cd = __byte_perm(q8(r[4 * i + 2], rs),
                                        q8(r[4 * i + 3], rs), 0x0040);
        o.v[i] = (int)__byte_perm(ab, cd, 0x5410);
      }
      store_stream<VEC>(obox + ((long long)pp * p + q) * c + v * VEC, o);
    }
  }
}

}  // namespace

// Dynamic shared memory of a block, as ops/roi_align.py:_int8_smem counts
// it: the box's operands, and the tq rows (h rounded up to 4) of vec
// channels for each of the block's threads.
static int smem_bytes(int h, int w, int vec, int threads) {
  return ops_bytes(h, w) + threads * round_up(h, 4) * vec;
}

// fq int8 [b, h, w, c] (c a multiple of vec, the address of vec bytes'
// alignment), boxes float32 [b, n, 4], ratio float32 [1] (s_f / s_pool),
// out int8 [b, n, p, p, c]; p <= 16, sampling_ratio <= 8 (0: adaptive).
// Blocks of `threads` with `smem` bytes, which must be smem_bytes'.
// Returns the launch's error, or cudaGetLastError() after it.
extern "C" int roi_align_int8_fwd(const void* fq, const void* boxes,
                                  const void* ratio, void* out, int b, int h,
                                  int w, int c, int n, int p,
                                  int sampling_ratio, float scale, int vec,
                                  int threads, int smem, void* stream) {
  if (p < 1 || p > PMAX || sampling_ratio > SR_MAX || threads < 32 ||
      threads > MAX_THREADS || threads % 32 ||
      (vec != 16 && vec != 8 && vec != 4) || c % vec ||
      smem != smem_bytes(h, w, vec, threads))
    return (int)cudaErrorInvalidValue;
  if (b * n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const int8_t*>(fq);
  const auto* bx = static_cast<const float*>(boxes);
  const auto* rt = static_cast<const float*>(ratio);
  auto* o = static_cast<int8_t*>(out);
  cudaError_t err = cudaSuccess;
  auto launch = [&](auto kernel) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return;
    kernel<<<b * n, threads, smem, st>>>(f, bx, rt, o, h, w, c, n, p,
                                         sampling_ratio, scale);
    err = cudaGetLastError();
  };
  if (vec == 16)
    launch(roi_align_int8_kernel<16>);
  else if (vec == 8)
    launch(roi_align_int8_kernel<8>);
  else
    launch(roi_align_int8_kernel<4>);
  return (int)err;
}
