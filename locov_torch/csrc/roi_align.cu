// Inference ROIAlignV2 (aligned, half-pixel offset), NHWC, gather form.
//
// Replaces the TPU kernel locov_tpu/ops/pallas_roi_align.py:_fused_kernel
// (launched by roi_align_pallas_fused), which computes
//   out[n,p,q,c] = sum_h Ky[n,p,h] sum_w Kx[n,q,w] F[h,w,c]
// as two dense MXU contractions against per-box interpolation matrices
// (the same function as ops/roi_align.py:roi_align_batched). Those
// matrices are almost all zeros (each row holds at most 2 * samples
// non-zeros), which on this card would waste the tensor cores on
// zeros; the gather form below computes the same sum in another order:
// the separable weights factor exactly,
//   Ky[p,h] Kx[q,w] = sum_{sy,sx} a_sy a_sx hat_y(h) hat_x(w),
// so each output is the weighted sum of the 4-tap bilinear samples of
// its bin.
//
// Bound on this card: memory, set by the output. At the detector's
// shapes (8 images, 1000 boxes, 14x14 bins, 1024 channels, bf16) the
// output is 3.2 GB written once, while the features (8 x 50 x 84 x 1024)
// are 69 MB and are read from L2 by many boxes.
//
// Design: one block per (box, output row p), threads over channel
// vectors (16 bytes: 8 bf16 or 4 f32 channels), each thread walking the
// row's 14 bins. The block first computes the row's y samples and every
// column's x samples (position, the two neighbouring cells, their hat
// weights times the sample weight) into shared memory, in f32 with the
// same operations as the plain version: x*scale - 0.5 (no FMA
// contraction), adaptive sr = clip(ceil(bin), 0, 8) with weight
// 1/max(sr, 1), torchvision's border rules (outside [-1, dim] gives 0,
// else clamp to [0, dim-1], high = min(low + 1, dim - 1)). The sum is
// kept in f32 and stored once in the features' dtype; the output stores
// are 16-byte and contiguous across the block. Degenerate boxes
// (size <= 0, adaptive) have no samples and give exactly 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SR_MAX = 8;   // ops/roi_align.py ADAPTIVE_SR_MAX
constexpr int P_MAX = 32;   // largest pooled resolution taken

struct Tap {
  int lo, hi;
  float wlo, whi;  // hat weights times the sample weight
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
  const float* box = boxes + bn * 4;
  // aligned=True (ROIAlignV2): half-pixel correction, no size clamping
  const float x0 = __fsub_rn(__fmul_rn(box[0], scale), 0.5f);
  const float y0 = __fsub_rn(__fmul_rn(box[1], scale), 0.5f);
  const float bw = __fsub_rn(__fsub_rn(__fmul_rn(box[2], scale), 0.5f), x0);
  const float bh = __fsub_rn(__fsub_rn(__fmul_rn(box[3], scale), 0.5f), y0);

  if (threadIdx.x == 0) nys = bin_taps(y0, bh, pooled, ratio, p, h, ys);
  for (int q = threadIdx.x; q < pooled; q += blockDim.x)
    nxs[q] = bin_taps(x0, bw, pooled, ratio, q, w, xs + q * SR_MAX);
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
