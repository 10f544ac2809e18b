// Fused ReLU + 3x3 / stride 2 / pad 1 max-pool, forward, NHWC.
//
// Replaces the TPU kernel locov_tpu/ops/pallas_pool.py:_fwd_kernel
// (launched by _fwd_impl, behind relu_maxpool), the ResNet stem's
// relu -> max_pool pair: y = maxpool3x3/s2/pad1(relu(x)), with taps
// outside the image acting as -inf.
//
// Bound on this card: memory. Each output reads a 3x3 window whose rows
// overlap the next window's, so the least traffic is the input once
// plus the output once (x [N,H,W,C] + y [N,H/2,W/2,C]); there is no
// arithmetic to speak of.
//
// Design: one thread per (output pixel, vector of channels). With
// C = 64 channels contiguous in NHWC, a 16-byte load holds 8 bf16 or 4
// f32 channels, neighbouring threads read neighbouring addresses, and
// the 3x3 windows of neighbouring pixels hit in L1/L2, so device memory
// sees close to one read of x. The TPU kernel's stride-2 column
// packing and H-tile halos existed for VMEM and lane layout; none of it
// is needed here. Max is exact, so relu and max run in f32 and the
// store in the input dtype gives the plain version's result bit for
// bit; a NaN in a window gives NaN, as in the plain version. Any H, W
// and C are taken (a C that is not a multiple of the vector width, or
// a misaligned pointer, uses the scalar variant).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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
  return __float2bfloat16(x);  // exact: x is a bf16 value, 0 or NaN
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
          // relu and max as F.relu and F.max_pool2d compute them on
          // the card: a NaN is carried forward (fmaxf alone would drop
          // it, where jnp.maximum keeps it too), and relu(-0) = +0
          const float u = to_f32(t.v[k]);
          const float r = u != u ? u : fmaxf(u, 0.0f);
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
void launch(const void* x, void* y, int n, int h, int w, int c, int oh,
            int ow, cudaStream_t stream) {
  const long long total = (long long)n * oh * ow * (c / VEC);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  if (blocks < 1) blocks = 1;
  relu_maxpool_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), h, w, c, oh, ow,
      total);
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
