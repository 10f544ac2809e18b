// Fused ReLU + 3x3 / stride 2 / pad 1 max-pool, forward and backward,
// NHWC.
//
// Forward: replaces the TPU kernel locov_tpu/ops/pallas_pool.py:
// _fwd_kernel (launched by _fwd_impl, behind relu_maxpool), the ResNet
// stem's relu -> max_pool pair: y = maxpool3x3/s2/pad1(relu(x)), with
// taps outside the image acting as -inf.
//
// Backward: replaces pallas_pool.py:_bwd_kernel (launched by
// _bwd_impl): dx = [x > 0] * sum over the (at most 2 x 2)
// windows whose argmax is this tap of dy, in f32, rounded once.
//
// Bound on this card: memory. The forward moves x once and y once; the
// backward reads x and dy once and writes dx once. There is no
// arithmetic to speak of.
//
// Design: one thread per (pixel, vector of channels). With C = 64
// channels contiguous in NHWC, a 16-byte load holds 8 bf16 or 4 f32
// channels, neighbouring threads read neighbouring addresses, and the
// 3x3 windows of neighbouring pixels hit in L1/L2, so device memory sees
// close to one read of x. The TPU kernels' stride-2 column packing and
// H-tile halos existed for VMEM and lane layout; none of it is needed
// here. Any H, W and C are taken (a C that is not a multiple of the
// vector width, or a misaligned pointer, uses the scalar variant).
//
// Forward numerics: max is exact, so relu and max run in f32 and the
// store in the input dtype gives the plain version's result bit for
// bit; a NaN in a window gives NaN, as in the plain version.
//
// Backward (gather form, no atomics): a thread owns a 2 x 2 block of
// input pixels (and a vector of channels). The windows that contain
// them are the (at most) 2 x 2 windows from the block's own on; the
// thread recomputes each one's argmax from relu(x) of its 9 taps (each
// window is computed by 4 threads, where one thread per input pixel
// would compute it 9 times) and adds the window's dy to the owned pixel
// whose tap the argmax is. The argmax is the plain version's
// (F.max_pool2d on the card): the first strictly larger tap in
// row-major order, or the last NaN. The windows are visited in
// row-major order and summed in f32 from +0, as PyTorch's max-pool
// backward does. The relu mask passes the sum where x > 0, else +0, as
// the Pallas backward masks: a NaN tap gets 0, and so a window whose max
// is NaN (its argmax is a NaN tap) routes nothing.
#include <math.h>

#include "common.cuh"

namespace {

using locov::from_f32;
using locov::to_f32;
using locov::Vec;

// relu as F.relu computes it on the card: a NaN is carried forward
// (fmaxf alone would drop it), and relu(-0) = +0
__device__ __forceinline__ float relu_f32(float u) {
  return u != u ? u : fmaxf(u, 0.0f);
}

template <typename T, int VEC>
__global__ void relu_maxpool_kernel(const T* __restrict__ x,
                                    T* __restrict__ y, int h, int w,
                                    int c, int oh, int ow,
                                    long long total) {
  const int cv = c / VEC;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int v = (int)(idx % cv);
    long long pix = idx / cv;
    const int ox = (int)(pix % ow);
    pix /= ow;
    const int oy = (int)(pix % oh);
    const long long b = pix / oh;

    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = -INFINITY;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int iy = 2 * oy - 1 + dy;
      if (iy < 0 || iy >= h) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ix = 2 * ox - 1 + dx;
        if (ix < 0 || ix >= w) continue;
        const Vec<T, VEC> t = *reinterpret_cast<const Vec<T, VEC>*>(
            x + ((b * h + iy) * w + ix) * c + (long long)v * VEC);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          // max as F.max_pool2d takes it: a NaN tap wins
          const float r = relu_f32(to_f32(t.v[k]));
          if (r > acc[k] || r != r) acc[k] = r;
        }
      }
    }
    Vec<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<T>(acc[k]);
    *reinterpret_cast<Vec<T, VEC>*>(
        y + ((b * oh + oy) * ow + ox) * c + (long long)v * VEC) = o;
  }
}

template <typename T, int VEC>
__global__ void relu_maxpool_bwd_kernel(const T* __restrict__ x,
                                        const T* __restrict__ dy,
                                        T* __restrict__ dx, int h, int w,
                                        int c, int oh, int ow,
                                        long long total) {
  const int cv = c / VEC;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    // the thread owns the 2 x 2 input pixels (2qy + a, 2qx + b); the
    // windows that contain them are (qy or qy + 1, qx or qx + 1)
    const int v = (int)(idx % cv);
    long long pix = idx / cv;
    const int qx = (int)(pix % ow);
    pix /= ow;
    const int qy = (int)(pix % oh);
    const long long n = pix / oh;
    const T* ximg = x + n * h * (long long)w * c + (long long)v * VEC;

    float acc[4][VEC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[a][k] = 0.0f;
    // windows in row-major order, as PyTorch's backward sums them
    const int oy1 = min(qy + 1, oh - 1);
    const int ox1 = min(qx + 1, ow - 1);
    for (int oy = qy; oy <= oy1; ++oy) {
      for (int ox = qx; ox <= ox1; ++ox) {
        float best[VEC];
        int arg[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          best[k] = -INFINITY;
          arg[k] = -1;
        }
#pragma unroll
        for (int ty = 0; ty < 3; ++ty) {
          const int jy = 2 * oy - 1 + ty;
          if (jy < 0 || jy >= h) continue;
#pragma unroll
          for (int tx = 0; tx < 3; ++tx) {
            const int jx = 2 * ox - 1 + tx;
            if (jx < 0 || jx >= w) continue;
            const Vec<T, VEC> t = *reinterpret_cast<const Vec<T, VEC>*>(
                ximg + ((long long)jy * w + jx) * c);
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              const float r = relu_f32(to_f32(t.v[k]));
              if (r > best[k] || r != r) {
                best[k] = r;
                arg[k] = ty * 3 + tx;
              }
            }
          }
        }
        const Vec<T, VEC> g = *reinterpret_cast<const Vec<T, VEC>*>(
            dy + ((n * oh + oy) * ow + ox) * c + (long long)v * VEC);
        // the tap of owned pixel (a, b) in this window, if it has one
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int ty = 2 * (qy - oy) + a + 1;
          if (ty < 0) continue;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int tx = 2 * (qx - ox) + b + 1;
            if (tx < 0) continue;
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              if (arg[k] == ty * 3 + tx) acc[2 * a + b][k] += to_f32(g.v[k]);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int iy = 2 * qy + a;
      if (iy >= h) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int ix = 2 * qx + b;
        if (ix >= w) continue;
        const Vec<T, VEC> own = *reinterpret_cast<const Vec<T, VEC>*>(
            ximg + ((long long)iy * w + ix) * c);
        Vec<T, VEC> o;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          o.v[k] = to_f32(own.v[k]) > 0.0f ? from_f32<T>(acc[2 * a + b][k])
                                           : from_f32<T>(0.0f);
        *reinterpret_cast<Vec<T, VEC>*>(
            dx + ((n * h + iy) * w + ix) * c + (long long)v * VEC) = o;
      }
    }
  }
}

long long grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  return blocks < 1 ? 1 : blocks;
}

template <typename T, int VEC>
void launch(const void* x, void* y, int n, int h, int w, int c, int oh,
            int ow, cudaStream_t stream) {
  const long long total = (long long)n * oh * ow * (c / VEC);
  relu_maxpool_kernel<T, VEC><<<(unsigned)grid_for(total, 256), 256, 0,
                                stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), h, w, c, oh, ow,
      total);
}

template <typename T, int VEC>
void launch_bwd(const void* x, const void* dy, void* dx, int n, int h,
                int w, int c, int oh, int ow, cudaStream_t stream) {
  const long long total = (long long)n * oh * ow * (c / VEC);
  relu_maxpool_bwd_kernel<T, VEC><<<(unsigned)grid_for(total, 256), 256, 0,
                                    stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<T*>(dx), h, w, c, oh, ow, total);
}

}  // namespace

// x [n, h, w, c] -> y [n, oh, ow, c], oh = (h + 1) / 2, ow = (w + 1) / 2.
// dtype: 0 = float32, 1 = bfloat16. vec: channels per thread (1, or 16
// bytes' worth: 4 for float32, 8 for bfloat16). Returns
// cudaGetLastError() after the launch.
extern "C" int relu_maxpool_fwd(const void* x, void* y, int n, int h,
                                int w, int c, int oh, int ow, int dtype,
                                int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    launch<float, 4>(x, y, n, h, w, c, oh, ow, s);
  else if (dtype == 0)
    launch<float, 1>(x, y, n, h, w, c, oh, ow, s);
  else if (vec == 8)
    launch<__nv_bfloat16, 8>(x, y, n, h, w, c, oh, ow, s);
  else
    launch<__nv_bfloat16, 1>(x, y, n, h, w, c, oh, ow, s);
  return (int)cudaGetLastError();
}

// x [n, h, w, c] (the forward's input), dy [n, oh, ow, c] -> dx
// [n, h, w, c], all of one dtype (0 = float32, 1 = bfloat16); vec as
// for the forward. Returns cudaGetLastError() after the launch.
extern "C" int relu_maxpool_bwd(const void* x, const void* dy, void* dx,
                                int n, int h, int w, int c, int oh, int ow,
                                int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    launch_bwd<float, 4>(x, dy, dx, n, h, w, c, oh, ow, s);
  else if (dtype == 0)
    launch_bwd<float, 1>(x, dy, dx, n, h, w, c, oh, ow, s);
  else if (vec == 8)
    launch_bwd<__nv_bfloat16, 8>(x, dy, dx, n, h, w, c, oh, ow, s);
  else
    launch_bwd<__nv_bfloat16, 1>(x, dy, dx, n, h, w, c, oh, ow, s);
  return (int)cudaGetLastError();
}
