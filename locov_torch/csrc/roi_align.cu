// ROIAlignV2 (aligned, half-pixel offset), NHWC: forward in gather form,
// and the gradient to the features, scatter-free.
//
// Forward: replaces the TPU kernels locov_tpu/ops/pallas_roi_align.py:
// _fused_kernel (inference, launched by roi_align_pallas_fused) and
// _kernel (training, launched by _forward behind roi_align_pallas),
// which compute the same function,
//   out[n,p,q,c] = sum_h Ky[n,p,h] sum_w Kx[n,q,w] F[h,w,c]
// as two dense MXU contractions against per-box interpolation matrices
// (ops/roi_align.py:roi_align_batched). Those matrices are almost all
// zeros (each row holds at most 2 * samples non-zeros), which on this
// card would waste the tensor cores on zeros; the gather form below
// computes the same sum in another order: the separable weights factor
// exactly,
//   Ky[p,h] Kx[q,w] = sum_{sy,sx} a_sy a_sx hat_y(h) hat_x(w),
// so each output is the weighted sum of the 4-tap bilinear samples of
// its bin.
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
// (the size of the forward's output) is read and dF (the size of the
// features) written.
//
// Forward design: one block per (box, output row p), threads over
// channel vectors (16 bytes: 8 bf16 or 4 f32 channels), each thread
// walking the row's bins. The block first computes the row's y samples
// and every column's x samples (position, the two neighbouring cells,
// their hat weights times the sample weight) into shared memory.
//
// Backward design: one block per (image, feature row h, tile of 64 to
// 128 channels), one channel per thread, with an f32 row accumulator
// [W, tile] in shared memory (43 KB at W = 84 and 128 channels) of
// which each thread owns its channel's column, so no atomics are
// needed and the sum order is fixed: the result is the same on every
// run. The block walks the image's boxes in order and skips, by a
// bound on its sample span, each box that cannot touch row h. For a
// box that can, it computes the box's sample taps into shared memory
// with the forward's code, and each bin row p's weight Ky[p, h]; each
// thread then sums u[q] = sum_p Ky[p,h] g[n,p,q,c] in registers (a row
// of bins' loads in flight together) and adds u[q] times the x tap
// weights into the two columns of each x sample of bin q. The row is
// stored once, in the features' dtype. Neighbouring rows run in
// neighbouring blocks, so the g a box's bin touches in two or three
// rows is mostly served from L2.
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

namespace {

using locov::from_f32;
using locov::to_f32;
using locov::Vec;

constexpr int SR_MAX = 8;   // ops/roi_align.py ADAPTIVE_SR_MAX
constexpr int P_MAX = 32;   // largest pooled resolution taken

struct Tap {
  int lo, hi;
  float wlo, whi;  // hat weights times the sample weight
};

// One sample at continuous position `coord` along an axis of `dim`
// cells, with sample weight `sw` (ops/roi_align.py:_interp_matrix).
__device__ __forceinline__ Tap make_tap(float coord, int dim, float sw) {
  const bool outside = coord < -1.0f || coord > (float)dim;
  const float cc = fminf(fmaxf(coord, 0.0f), (float)(dim - 1));
  const float low = floorf(cc);
  const float frac = __fsub_rn(cc, low);
  Tap t;
  t.lo = (int)low;
  t.hi = min(t.lo + 1, dim - 1);
  t.wlo = outside ? 0.0f : __fmul_rn(__fsub_rn(1.0f, frac), sw);
  t.whi = outside ? 0.0f : __fmul_rn(frac, sw);
  return t;
}

// Samples of bin `p` of one axis of a box starting at `lo` with extent
// `size`: fixed `ratio` > 0, or adaptive (ratio <= 0). Writes up to
// SR_MAX taps, returns how many.
__device__ __forceinline__ int bin_taps(float lo, float size, int pooled,
                                        int ratio, int p, int dim,
                                        Tap* taps) {
  const float bin = __fdiv_rn(size, (float)pooled);
  if (ratio > 0) {
    const float sw = __fdiv_rn(1.0f, (float)ratio);
    for (int s = 0; s < ratio; ++s) {
      const float frac = __fdiv_rn(__fadd_rn((float)s, 0.5f), (float)ratio);
      const float coord = __fadd_rn(lo, __fmul_rn(__fadd_rn((float)p, frac),
                                                  bin));
      taps[s] = make_tap(coord, dim, sw);
    }
    return ratio;
  }
  const float sr = fminf(fmaxf(ceilf(bin), 0.0f), (float)SR_MAX);
  const float srn = fmaxf(sr, 1.0f);
  const float sw = __fdiv_rn(1.0f, srn);
  const int n = (int)sr;
  for (int s = 0; s < n; ++s) {
    const float pos = __fdiv_rn(__fadd_rn((float)s, 0.5f), srn);
    const float coord = __fadd_rn(lo, __fmul_rn(__fadd_rn((float)p, pos),
                                                bin));
    taps[s] = make_tap(coord, dim, sw);
  }
  return n;
}

// A box in feature coordinates: aligned=True (ROIAlignV2), half-pixel
// correction, no size clamping.
struct Box {
  float x0, y0, bw, bh;
};

__device__ __forceinline__ Box load_box(const float* box, float scale) {
  Box r;
  r.x0 = __fsub_rn(__fmul_rn(box[0], scale), 0.5f);
  r.y0 = __fsub_rn(__fmul_rn(box[1], scale), 0.5f);
  r.bw = __fsub_rn(__fsub_rn(__fmul_rn(box[2], scale), 0.5f), r.x0);
  r.bh = __fsub_rn(__fsub_rn(__fmul_rn(box[3], scale), 0.5f), r.y0);
  return r;
}

template <typename T, int VEC>
__global__ void roi_align_kernel(const T* __restrict__ feat,
                                 const float* __restrict__ boxes,
                                 T* __restrict__ out, int h, int w, int c,
                                 int n, int pooled, int ratio,
                                 float scale) {
  __shared__ Tap ys[SR_MAX];
  __shared__ Tap xs[P_MAX * SR_MAX];
  __shared__ int nxs[P_MAX];
  __shared__ int nys;

  const long long bn = blockIdx.x / pooled;  // box index in [0, B*N)
  const int p = blockIdx.x % pooled;
  const long long img = bn / n;
  const Box bx = load_box(boxes + bn * 4, scale);

  if (threadIdx.x == 0) nys = bin_taps(bx.y0, bx.bh, pooled, ratio, p, h, ys);
  for (int q = threadIdx.x; q < pooled; q += blockDim.x)
    nxs[q] = bin_taps(bx.x0, bx.bw, pooled, ratio, q, w, xs + q * SR_MAX);
  __syncthreads();

  const int cv = c / VEC;
  const T* fimg = feat + img * h * w * (long long)c;
  T* orow = out + (bn * pooled + p) * (long long)pooled * c;
  for (int v = threadIdx.x; v < cv; v += blockDim.x) {
    const T* fv = fimg + (long long)v * VEC;
    for (int q = 0; q < pooled; ++q) {
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
      const int nx = nxs[q];
      for (int sy = 0; sy < nys; ++sy) {
        const Tap ty = ys[sy];
        const T* rlo = fv + (long long)ty.lo * w * c;
        const T* rhi = fv + (long long)ty.hi * w * c;
        for (int sx = 0; sx < nx; ++sx) {
          const Tap tx = xs[q * SR_MAX + sx];
          const float w00 = ty.wlo * tx.wlo, w01 = ty.wlo * tx.whi;
          const float w10 = ty.whi * tx.wlo, w11 = ty.whi * tx.whi;
          const Vec<T, VEC> a =
              *reinterpret_cast<const Vec<T, VEC>*>(rlo + tx.lo * c);
          const Vec<T, VEC> b =
              *reinterpret_cast<const Vec<T, VEC>*>(rlo + tx.hi * c);
          const Vec<T, VEC> d =
              *reinterpret_cast<const Vec<T, VEC>*>(rhi + tx.lo * c);
          const Vec<T, VEC> e =
              *reinterpret_cast<const Vec<T, VEC>*>(rhi + tx.hi * c);
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            acc[k] += w00 * to_f32(a.v[k]) + w01 * to_f32(b.v[k]) +
                      w10 * to_f32(d.v[k]) + w11 * to_f32(e.v[k]);
        }
      }
      Vec<T, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<T>(acc[k]);
      *reinterpret_cast<Vec<T, VEC>*>(orow + (long long)q * c +
                                      (long long)v * VEC) = o;
    }
  }
}

// grid (h, channel tiles, images); blockDim.x channels (>= 2 * pooled);
// dynamic shared memory: w * blockDim.x floats.
template <typename T>
__global__ void roi_align_bwd_kernel(const T* __restrict__ g,
                                     const float* __restrict__ boxes,
                                     T* __restrict__ df, int h, int w,
                                     int c, int n, int pooled, int ratio,
                                     float scale) {
  extern __shared__ float acc[];  // [w][blockDim.x]
  __shared__ Tap ys[P_MAX * SR_MAX];
  __shared__ Tap xs[P_MAX * SR_MAX];
  __shared__ int nxs[P_MAX];
  __shared__ float kyh[P_MAX];  // Ky[p, hy] of the current box

  const int hy = blockIdx.x;
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const int ch = blockIdx.y * nt + t;
  const bool live = ch < c;
  const long long img = blockIdx.z;
  for (int x = 0; x < w; ++x) acc[x * nt + t] = 0.0f;

  const long long gbox = (long long)pooled * pooled * c;
  const T* gimg = g + img * n * gbox + ch;
  for (int bi = 0; bi < n; ++bi) {
    const Box bx = load_box(boxes + (img * n + bi) * 4, scale);
    // the rows the box's y samples can touch lie within its extent,
    // clamped, one cell below (the high tap) and one of margin each
    // side against rounding; skipping the box is uniform in the block
    const float ya = fminf(bx.y0, bx.y0 + bx.bh);
    const float yb = fmaxf(bx.y0, bx.y0 + bx.bh);
    const float top = floorf(fminf(fmaxf(ya, 0.0f), (float)(h - 1))) - 1.0f;
    const float bottom =
        floorf(fminf(fmaxf(yb, 0.0f), (float)(h - 1))) + 2.0f;
    if ((float)hy < top || (float)hy > bottom) continue;

    __syncthreads();  // the previous box's taps are no longer read
    if (t < pooled) {
      Tap* yt = ys + t * SR_MAX;
      const int ny = bin_taps(bx.y0, bx.bh, pooled, ratio, t, h, yt);
      float k = 0.0f;
      for (int s = 0; s < ny; ++s) {
        if (yt[s].lo == hy) k += yt[s].wlo;
        if (yt[s].hi == hy) k += yt[s].whi;
      }
      kyh[t] = k;
    } else if (t < 2 * pooled) {
      const int q = t - pooled;
      nxs[q] = bin_taps(bx.x0, bx.bw, pooled, ratio, q, w, xs + q * SR_MAX);
    }
    __syncthreads();
    if (!live) continue;

    // u[q] = sum_p Ky[p, hy] g[n, p, q, c] (the plain version's first
    // contraction), one row of loads in flight at a time; then u is
    // spread over the x samples' columns
    const T* gb = gimg + bi * gbox;
    float u[P_MAX];
#pragma unroll
    for (int q = 0; q < P_MAX; ++q) u[q] = 0.0f;
    bool any = false;
    for (int p = 0; p < pooled; ++p) {
      const float ky = kyh[p];
      if (ky == 0.0f) continue;
      any = true;
      const T* grow = gb + (long long)p * pooled * c;
#pragma unroll
      for (int q = 0; q < P_MAX; ++q)
        if (q < pooled) u[q] += ky * to_f32(grow[(long long)q * c]);
    }
    if (!any) continue;
#pragma unroll
    for (int q = 0; q < P_MAX; ++q) {
      if (q >= pooled) break;
      const int nx = nxs[q];
      for (int sx = 0; sx < nx; ++sx) {
        const Tap tx = xs[q * SR_MAX + sx];
        acc[tx.lo * nt + t] += tx.wlo * u[q];
        acc[tx.hi * nt + t] += tx.whi * u[q];
      }
    }
  }
  if (!live) return;
  T* drow = df + ((img * h + hy) * (long long)w) * c + ch;
  for (int x = 0; x < w; ++x)
    drow[(long long)x * c] = from_f32<T>(acc[x * nt + t]);
}

template <typename T, int VEC>
void launch(const void* feat, const float* boxes, void* out, int b, int h,
            int w, int c, int n, int pooled, int ratio, float scale,
            cudaStream_t stream) {
  const int cv = c / VEC;
  int threads = ((cv + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const long long blocks = (long long)b * n * pooled;
  roi_align_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(feat), boxes, static_cast<T*>(out), h, w, c, n,
      pooled, ratio, scale);
}

template <typename T>
int launch_bwd(const void* g, const float* boxes, void* df, int b, int h,
               int w, int c, int n, int pooled, int ratio, float scale,
               int threads, cudaStream_t stream) {
  const size_t smem = (size_t)w * threads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      roi_align_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(h, (c + threads - 1) / threads, b);
  roi_align_bwd_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(g), boxes, static_cast<T*>(df), h, w, c, n,
      pooled, ratio, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// feat [b, h, w, c] (dtype 0 = float32, 1 = bfloat16), boxes [b, n, 4]
// float32 XYXY in image coordinates -> out [b, n, pooled, pooled, c] in
// feat's dtype. ratio > 0: fixed samples per bin per axis (<= 8);
// ratio <= 0: adaptive. pooled <= 32. vec: channels per thread (1, or
// 16 bytes' worth). Returns cudaGetLastError() after the launch.
extern "C" int roi_align_fwd(const void* feat, const void* boxes,
                             void* out, int b, int h, int w, int c, int n,
                             int pooled, int ratio, float scale, int dtype,
                             int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  if (dtype == 0 && vec == 4)
    launch<float, 4>(feat, bx, out, b, h, w, c, n, pooled, ratio, scale, s);
  else if (dtype == 0)
    launch<float, 1>(feat, bx, out, b, h, w, c, n, pooled, ratio, scale, s);
  else if (vec == 8)
    launch<__nv_bfloat16, 8>(feat, bx, out, b, h, w, c, n, pooled, ratio,
                             scale, s);
  else
    launch<__nv_bfloat16, 1>(feat, bx, out, b, h, w, c, n, pooled, ratio,
                             scale, s);
  return (int)cudaGetLastError();
}

// g [b, n, pooled, pooled, c] (dtype 0 = float32, 1 = bfloat16), boxes
// as for the forward -> df [b, h, w, c] in g's dtype, every element
// written. threads: channels per block, a multiple of 32, >= 2 * pooled;
// the block takes w * threads * 4 bytes of shared memory. Returns the
// first CUDA error of the launch, or 0.
extern "C" int roi_align_bwd(const void* g, const void* boxes, void* df,
                             int b, int h, int w, int c, int n, int pooled,
                             int ratio, float scale, int dtype, int threads,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  if (dtype == 0)
    return launch_bwd<float>(g, bx, df, b, h, w, c, n, pooled, ratio, scale,
                             threads, s);
  return launch_bwd<__nv_bfloat16>(g, bx, df, b, h, w, c, n, pooled, ratio,
                                   scale, threads, s);
}
