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
// Forward design: one thread per (pixel, vector of channels). With C = 64
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
// Backward (gather form, no atomics), two passes over a strip of
// windows. Pass 1 computes each window's argmax once, from relu(x) of
// its 9 taps read as channel vectors (16 bytes in bf16, 8 in f32), as
// a 4-bit tap code per channel: the first strictly larger tap in
// row-major order, as F.max_pool2d on the card takes it, and NO_TAP
// where a tap is NaN (the plain version routes such a window to the
// NaN tap, which the relu mask zeroes anyway). Pass 2: a thread owns
// the input pixels of its window column (2 ox, 2 ox + 1) and adds, in
// row-major window order from +0 in f32, the dy of each of its (at most
// 2 x 2) windows whose code names its tap, then masks with x > 0 (a NaN
// tap gets 0) and rounds once: PyTorch's max-pool backward order, so
// float32 is bit-exact with the plain version. A block walks down a
// strip of window rows, carrying the last row's bottom taps, codes and
// dy in registers; the right neighbour's codes and dy come through
// shared memory, and the strip's last window row and column are halo
// windows recomputed from x (one extra row a strip, one column in 16 or
// 32), so no block needs another's codes. x is read about once, where the
// previous design (a thread per 2 x 2 pixels, every window's argmax
// recomputed by the four threads that touch it) read 36 taps for 4
// outputs.
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// Backward, two passes over a strip of windows (see the head note).
// A block is BWD_THREADS threads: `lanes` channel vectors (fastest) by
// `cols` window columns, the last of which is the halo column: it
// computes its windows' tap codes for its left neighbour and owns no
// pixels. The block walks window rows oy0 .. oy0 + rows (the last one
// the halo row, whose codes finish input row 2 (oy0 + rows) - 1) and
// owns input rows 2 oy0 .. 2 (oy0 + rows) - 1 and input columns
// 2 ox0 .. 2 (ox0 + cols - 1) - 1.
constexpr int BWD_THREADS = 256;
constexpr int BWD_ROWS = 8;      // window rows a block owns (default plan)
constexpr unsigned NO_TAP = 15;  // tap code: the window routes nothing

// The argmax tap (ty * 3 + tx) of each channel of one window, from
// relu(x) of its 9 taps in row-major order (`ok`: the tap is in the
// image), 4 bits a channel: the first strictly larger tap, as
// F.max_pool2d takes it; NO_TAP where a tap is NaN (the plain version
// routes to the NaN tap, whose x > 0 mask gives 0 anyway).
template <typename T, int VEC>
__device__ __forceinline__ unsigned tap_codes(const Vec<T, VEC> (&t)[9],
                                              const bool (&ok)[9]) {
  unsigned code = 0;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    float best = -1.0f;
    unsigned arg = NO_TAP;
    bool nan = false;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      if (!ok[i]) continue;
      const float u = to_f32(t[i].v[k]);
      nan |= u != u;
      const float r = fmaxf(u, 0.0f);  // -0 or +0 tie; a NaN is flagged
      if (r > best) {
        best = r;
        arg = i;
      }
    }
    code |= (nan ? NO_TAP : arg) << (4 * k);
  }
  return code;
}

__device__ __forceinline__ uint32_t max_s16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The same for bf16 pairs, on the bit patterns (faster on the card than
// the f32 compares): a signed 16-bit max with 0 is relu (every negative,
// -0 and a negative NaN give +0), a non-negative bf16 orders as its
// bits, so the key (bits << 4) | (15 - tap) has its integer max at the
// first largest tap; a tap is NaN where its |bits| exceed those of inf.
template <int VEC>
__device__ __forceinline__ unsigned tap_codes_bf16(
    const Vec<__nv_bfloat16, VEC> (&t)[9], const bool (&ok)[9]) {
  uint32_t key[VEC], amax[VEC / 2];
#pragma unroll
  for (int k = 0; k < VEC; ++k) key[k] = 0;
#pragma unroll
  for (int m = 0; m < VEC / 2; ++m) amax[m] = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    if (!ok[i]) continue;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(t[i].v);
#pragma unroll
    for (int m = 0; m < VEC / 2; ++m) {
      const uint32_t r = max_s16x2(words[m], 0u);
      amax[m] = max_u16x2(amax[m], words[m] & 0x7fff7fffu);
      key[2 * m] = max(key[2 * m], ((r << 4) & 0xffff0u) | (15u - i));
      key[2 * m + 1] =
          max(key[2 * m + 1], ((r >> 12) & 0xffff0u) | (15u - i));
    }
  }
  unsigned code = 0;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const bool nan = ((amax[k / 2] >> (16 * (k & 1))) & 0xffffu) > 0x7f80u;
    code |= (nan ? NO_TAP : 15u - (key[k] & 15u)) << (4 * k);
  }
  return code;
}

// acc[k] += dy[k] where channel k's code names `tap`
template <typename T, int VEC>
__device__ __forceinline__ void gather(float (&acc)[VEC], unsigned code,
                                       unsigned tap, const Vec<T, VEC>& d) {
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (((code >> (4 * k)) & 15u) == tap) acc[k] += to_f32(d.v[k]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_masked(T* p, const float (&acc)[VEC],
                                             const Vec<T, VEC>& own) {
  Vec<T, VEC> o;
  if constexpr (std::is_same_v<T, __nv_bfloat16> && VEC % 2 == 0) {
    // two channels an instruction: round the pair, mask it with x > 0
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(own.v);
    uint32_t* words = reinterpret_cast<uint32_t*>(o.v);
    const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
#pragma unroll
    for (int m = 0; m < VEC / 2; ++m) {
      const __nv_bfloat162 r =
          __floats2bfloat162_rn(acc[2 * m], acc[2 * m + 1]);
      words[m] = *reinterpret_cast<const uint32_t*>(&r) &
                 __hgt2_mask(x[m], zero);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      o.v[k] = to_f32(own.v[k]) > 0.0f ? from_f32<T>(acc[k])
                                       : from_f32<T>(0.0f);
  }
  if constexpr (sizeof(o) == 16)
    __stcs(reinterpret_cast<int4*>(p), *reinterpret_cast<const int4*>(&o));
  else if constexpr (sizeof(o) == 8)
    __stcs(reinterpret_cast<int2*>(p), *reinterpret_cast<const int2*>(&o));
  else
    *reinterpret_cast<Vec<T, VEC>*>(p) = o;
}

// Blocks an SM the registers are bounded for: two in bf16, three in f32
// (the fastest of two and three on the card for each).
template <typename T, int VEC>
__global__ void __launch_bounds__(BWD_THREADS, sizeof(T) == 2 ? 2 : 3)
    relu_maxpool_bwd_kernel(const T* __restrict__ x,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            int h, int w, int c, int oh, int ow, int lanes,
                            int groups, int rows) {
  using V = Vec<T, VEC>;
  __shared__ unsigned code_s[2][BWD_THREADS];
  __shared__ V dy_s[2][BWD_THREADS];
  const int tid = threadIdx.x;
  const int cols = BWD_THREADS / lanes;
  const int col = tid / lanes;
  const int ox = blockIdx.x * (cols - 1) + col;
  const int oy0 = (int)(blockIdx.y / groups) * rows;
  const int v = (int)(blockIdx.y % groups) * lanes + tid % lanes;
  const bool active = v < c / VEC;
  const bool owner = active && col < cols - 1 && ox < ow;
  const long long n = blockIdx.z;
  const T* xi = x + n * h * (long long)w * c + (long long)v * VEC;
  T* dxi = dx + n * h * (long long)w * c + (long long)v * VEC;
  const T* dyi = dy + n * oh * (long long)ow * c + (long long)v * VEC;
  const bool colok[3] = {active && 2 * ox - 1 >= 0 && 2 * ox - 1 < w,
                         active && 2 * ox < w, active && 2 * ox + 1 < w};

  auto load_row = [&](int iy, V (&t)[3], bool (&ok)[3]) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      ok[j] = colok[j] && iy >= 0 && iy < h;
      if (ok[j])
        t[j] = *reinterpret_cast<const V*>(
            xi + ((long long)iy * w + 2 * ox - 1 + j) * c);
    }
  };

  auto load_dy = [&](int oy, V& d) {
    if (active && oy < oh && ox < ow)
      d = *reinterpret_cast<const V*>(dyi + ((long long)oy * ow + ox) * c);
  };

  // input row 2 oy - 1 (the last step's bottom row), 2 oy, 2 oy + 1.
  // f32 loads the next step's rows and dy a step ahead; bf16, whose
  // vectors are twice as wide, spilled doing so and loads them in its
  // step (each the faster on the card)
  constexpr bool ahead = sizeof(T) == 4;
  V top[3], mid[3], bot[3], next_mid[3], next_bot[3];
  bool top_ok[3], mid_ok[3], bot_ok[3], next_mid_ok[3], next_bot_ok[3];
  V next_dy{};
  load_row(2 * oy0 - 1, top, top_ok);
  if constexpr (ahead) {
    load_row(2 * oy0, next_mid, next_mid_ok);
    load_row(2 * oy0 + 1, next_bot, next_bot_ok);
    load_dy(oy0, next_dy);
  }
  // the last window row's codes and dy, own column and its right
  // neighbour
  unsigned prev_code = 0, prev_code_nb = 0;
  V prev_dy{}, prev_dy_nb{};
  const int oy_end = min(oy0 + rows, oh);
  for (int oy = oy0; oy <= oy_end; ++oy) {
    V d{};
    if constexpr (ahead) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        mid[j] = next_mid[j];
        mid_ok[j] = next_mid_ok[j];
        bot[j] = next_bot[j];
        bot_ok[j] = next_bot_ok[j];
      }
      d = next_dy;
      if (oy < oy_end) {
        load_row(2 * oy + 2, next_mid, next_mid_ok);
        load_row(2 * oy + 3, next_bot, next_bot_ok);
        load_dy(oy + 1, next_dy);
      }
    } else {
      load_row(2 * oy, mid, mid_ok);
      load_row(2 * oy + 1, bot, bot_ok);
      load_dy(oy, d);
    }
    unsigned code = 0xffffffffu;  // NO_TAP in every channel
    if (active && oy < oh && ox < ow) {
      const V t[9] = {top[0], top[1], top[2], mid[0], mid[1],
                      mid[2], bot[0], bot[1], bot[2]};
      const bool ok[9] = {top_ok[0], top_ok[1], top_ok[2],
                          mid_ok[0], mid_ok[1], mid_ok[2],
                          bot_ok[0], bot_ok[1], bot_ok[2]};
      if constexpr (std::is_same_v<T, __nv_bfloat16> && VEC % 2 == 0)
        code = tap_codes_bf16(t, ok);
      else
        code = tap_codes(t, ok);
    }
    const int buf = (oy - oy0) & 1;
    code_s[buf][tid] = code;
    dy_s[buf][tid] = d;
    // double buffers: a thread rewrites this slot two steps on, after
    // every thread has passed the next step's barrier
    __syncthreads();
    if (owner) {
      const unsigned code_nb = code_s[buf][tid + lanes];
      const V d_nb = dy_s[buf][tid + lanes];
      // windows in row-major order, summed in f32 from +0
      if (oy > oy0 && 2 * oy - 1 < h) {  // input row 2 oy - 1
        T* p = dxi + ((long long)(2 * oy - 1) * w + 2 * ox) * c;
        float a[VEC] = {};
        gather<T, VEC>(a, prev_code, 7, prev_dy);
        gather<T, VEC>(a, code, 1, d);
        store_masked<T, VEC>(p, a, top[1]);
        if (colok[2]) {
          float b[VEC] = {};
          gather<T, VEC>(b, prev_code, 8, prev_dy);
          gather<T, VEC>(b, prev_code_nb, 6, prev_dy_nb);
          gather<T, VEC>(b, code, 2, d);
          gather<T, VEC>(b, code_nb, 0, d_nb);
          store_masked<T, VEC>(p + c, b, top[2]);
        }
      }
      if (oy < oy0 + rows && oy < oh) {  // input row 2 oy
        T* p = dxi + ((long long)(2 * oy) * w + 2 * ox) * c;
        float a[VEC] = {};
        gather<T, VEC>(a, code, 4, d);
        store_masked<T, VEC>(p, a, mid[1]);
        if (colok[2]) {
          float b[VEC] = {};
          gather<T, VEC>(b, code, 5, d);
          gather<T, VEC>(b, code_nb, 3, d_nb);
          store_masked<T, VEC>(p + c, b, mid[2]);
        }
      }
      prev_code = code;
      prev_code_nb = code_nb;
      prev_dy = d;
      prev_dy_nb = d_nb;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      top[j] = bot[j];
      top_ok[j] = bot_ok[j];
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

// Channel vectors a block takes side by side: up to 16, so that a block
// reads 128 bytes of a pixel (the main path's 64 channels: 8 vectors in
// bf16, 16 in f32), fewer where the pixel holds fewer.
int bwd_lanes(int cv) {
  int lanes = 1;
  while (lanes < cv && lanes < 16) lanes *= 2;
  return lanes;
}

template <typename T, int VEC>
int launch_bwd(const void* x, const void* dy, void* dx, int n, int h, int w,
               int c, int oh, int ow, int rows, cudaStream_t stream) {
  const int cv = c / VEC, lanes = bwd_lanes(cv);
  const int groups = (cv + lanes - 1) / lanes;
  const int cols = BWD_THREADS / lanes;  // one of them the halo column
  const long long gy = (long long)((oh + rows - 1) / rows) * groups;
  if (rows < 1 || gy > 65535 || n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((ow + cols - 2) / (cols - 1), (unsigned)gy, n);
  relu_maxpool_bwd_kernel<T, VEC><<<grid, BWD_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<T*>(dx), h, w, c, oh, ow, lanes, groups, rows);
  return (int)cudaGetLastError();
}

int bwd(const void* x, const void* dy, void* dx, int n, int h, int w, int c,
        int oh, int ow, int dtype, int vec, int rows, cudaStream_t s) {
  // f32 in 8-byte vectors (half of what `vec` allows), 2 channels a
  // thread: the registers of three blocks an SM; bf16 in 16-byte ones
  // (the fastest of 8 and 16 bytes on the card for each)
  if (dtype == 0 && vec == 4)
    return launch_bwd<float, 2>(x, dy, dx, n, h, w, c, oh, ow, rows, s);
  if (dtype == 0)
    return launch_bwd<float, 1>(x, dy, dx, n, h, w, c, oh, ow, rows, s);
  if (vec == 8)
    return launch_bwd<__nv_bfloat16, 8>(x, dy, dx, n, h, w, c, oh, ow, rows,
                                        s);
  return launch_bwd<__nv_bfloat16, 1>(x, dy, dx, n, h, w, c, oh, ow, rows, s);
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
// for the forward. Returns the launch's error, or cudaGetLastError()
// after it.
extern "C" int relu_maxpool_bwd(const void* x, const void* dy, void* dx,
                                int n, int h, int w, int c, int oh, int ow,
                                int dtype, int vec, void* stream) {
  return bwd(x, dy, dx, n, h, w, c, oh, ow, dtype, vec, BWD_ROWS,
             static_cast<cudaStream_t>(stream));
}

// The same under another plan: `rows` window rows a block (the bench
// times plans; every plan gives the same bits).
extern "C" int relu_maxpool_bwd_rows(const void* x, const void* dy, void* dx,
                                     int n, int h, int w, int c, int oh,
                                     int ow, int dtype, int vec, int rows,
                                     void* stream) {
  return bwd(x, dy, dx, n, h, w, c, oh, ow, dtype, vec, rows,
             static_cast<cudaStream_t>(stream));
}
