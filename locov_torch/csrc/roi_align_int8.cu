// KQ2: the integer core of the full-int8 ROIAlign of the static int8
// serving mode (locov_torch/ops/roi_align.py: roi_align_batched_int8).
//
// It has no Pallas parent: the JAX package computes this op as two XLA
// einsums a chunk of boxes (locov_tpu/ops/roi_align.py:
// roi_align_batched_int8). For box (b, n), channel c:
//   t[q, h]  = sum_w kxq[q, w] * fq[b, h, w, c]                (int32)
//   tq[q, h] = clip(rint(f32(t) * sx[q]), -127, 127)
//   r[p, q]  = sum_h kyq[p, h] * tq[q, h]                      (int32)
//   out[b, n, p, q, c] = clip(rint(f32(r) * rescale[p]), -127, 127)
// with rint half to even (the default rounding mode) and each float
// product rounded once, as jnp.round of the float32 product is. The
// interpolation matrices kyq [B, N, P, H], kxq [B, N, P, W] (int8, one
// scale a row) and the rescale are built by the plain code.
//
// Skipping zero taps is exact: the sums visit only the columns w where
// kxq[q, w] != 0 (one range a row q) and the rows h where some
// kyq[p, h] != 0, and for each such h only the bins p whose row of kyq
// is non-zero there (a range of p), as K2 visits only the box's
// footprint; zero weights add exactly 0, so the integers are the dense
// einsums'. f32(t) is exact: |t| <= 127 * 127 * W < 2^24 for W <= 1040.
//
// Bound on the H100: bytes. The int8 output [8, 1000, 14, 14, 1024] is
// 1.6 GB, 0.48 ms at 3.35 TB/s (K2 writes 3.2 GB in bf16). The simple
// form here: a block takes one box and a tile of channels, four channels
// (one 32-bit word) a thread; the box's two matrices, their non-zero
// ranges and its scales are staged in shared memory; for each bin column
// q a thread sums t over the row's columns for every needed h, rounds
// it, and adds it into P int32 sums held in registers, then writes the
// P outputs of that q as one word each. Building the matrices in the
// kernel is later work.
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int PMAX = 16;      // bins a side the kernel takes
constexpr int THREADS = 128;  // threads a block, 4 channels each

__device__ __forceinline__ int q8(float v) {
  return (int)fminf(fmaxf(rintf(v), -127.f), 127.f);
}

__global__ void __launch_bounds__(THREADS)
    roi_align_int8_kernel(const int8_t* __restrict__ fq,
                          const int8_t* __restrict__ kyq,
                          const int8_t* __restrict__ kxq,
                          const float* __restrict__ sx,
                          const float* __restrict__ rescale,
                          int8_t* __restrict__ out, int h, int w, int c,
                          int n, int p) {
  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* s_ky = reinterpret_cast<int8_t*>(smem);        // [p][h]
  int8_t* s_kx = s_ky + p * h;                           // [p][w]
  int* s_int = reinterpret_cast<int*>(
      smem + ((p * (h + w) + 15) / 16) * 16);
  int* s_wlo = s_int;             // [p]: first and last non-zero column
  int* s_whi = s_wlo + PMAX;      //      of kxq row q
  int* s_plo = s_whi + PMAX;      // [h]: first and last bin p whose kyq
  int* s_phi = s_plo + h;         //      row is non-zero at h
  float* s_sx = reinterpret_cast<float*>(s_phi + h);     // [p]
  float* s_rs = s_sx + PMAX;                             // [p]
  int* s_hrange = reinterpret_cast<int*>(s_rs + PMAX);   // lo, hi

  const int box = blockIdx.x;  // b * n + i
  const int b = box / n;
  const int tid = threadIdx.x;
  const long long mrow = (long long)box * p;
  for (int i = tid; i < p * h; i += THREADS) s_ky[i] = kyq[mrow * h + i];
  for (int i = tid; i < p * w; i += THREADS) s_kx[i] = kxq[mrow * w + i];
  if (tid < p) {
    s_sx[tid] = sx[mrow + tid];
    s_rs[tid] = rescale[mrow + tid];
  }
  if (tid == 0) {
    s_hrange[0] = h;
    s_hrange[1] = -1;
  }
  __syncthreads();
  if (tid < p) {
    int lo = w, hi = -1;
    for (int x = 0; x < w; ++x)
      if (s_kx[tid * w + x] != 0) {
        lo = min(lo, x);
        hi = x;
      }
    s_wlo[tid] = lo;
    s_whi[tid] = hi;
  }
  for (int y = tid; y < h; y += THREADS) {
    int lo = p, hi = -1;
    for (int i = 0; i < p; ++i)
      if (s_ky[i * h + y] != 0) {
        lo = min(lo, i);
        hi = i;
      }
    s_plo[y] = lo;
    s_phi[y] = hi;
    if (hi >= 0) {
      atomicMin(&s_hrange[0], y);
      atomicMax(&s_hrange[1], y);
    }
  }
  __syncthreads();

  const int c4 = (blockIdx.y * THREADS + tid) * 4;
  if (c4 >= c) return;  // no barrier below
  const int hlo = s_hrange[0], hhi = s_hrange[1];
  const char4* f4 = reinterpret_cast<const char4*>(fq) +
                    ((long long)b * h * w * c + c4) / 4;
  const int c_words = c / 4;
  char4* o4 = reinterpret_cast<char4*>(out) +
              ((long long)box * p * p * c + c4) / 4;

  for (int qq = 0; qq < p; ++qq) {
    int acc[PMAX][4];
#pragma unroll
    for (int i = 0; i < PMAX; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    const int wlo = s_wlo[qq], whi = s_whi[qq];
    const float sxq = s_sx[qq];
    const int8_t* kx = s_kx + qq * w;
    for (int y = hlo; y <= hhi && wlo <= whi; ++y) {
      const int plo = s_plo[y], phi = s_phi[y];
      if (plo > phi) continue;
      int t[4] = {0, 0, 0, 0};
      const char4* frow = f4 + (long long)y * w * c_words;
      for (int x = wlo; x <= whi; ++x) {
        const int k = kx[x];
        const char4 f = frow[(long long)x * c_words];
        t[0] += k * f.x;
        t[1] += k * f.y;
        t[2] += k * f.z;
        t[3] += k * f.w;
      }
      int tq[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tq[j] = q8(__fmul_rn(__int2float_rn(t[j]), sxq));
#pragma unroll
      for (int i = 0; i < PMAX; ++i) {
        if (i >= plo && i <= phi) {
          const int k = s_ky[i * h + y];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += k * tq[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PMAX; ++i) {
      if (i < p) {
        const float rs = s_rs[i];
        char4 v;
        v.x = (signed char)q8(__fmul_rn(__int2float_rn(acc[i][0]), rs));
        v.y = (signed char)q8(__fmul_rn(__int2float_rn(acc[i][1]), rs));
        v.z = (signed char)q8(__fmul_rn(__int2float_rn(acc[i][2]), rs));
        v.w = (signed char)q8(__fmul_rn(__int2float_rn(acc[i][3]), rs));
        o4[((long long)i * p + qq) * c_words] = v;
      }
    }
  }
}

}  // namespace

// Dynamic shared memory of a block, as ops/roi_align.py:_int8_smem
// counts it: the box's two matrices (rounded up to 16 bytes), the column
// ranges and the two scales of PMAX bins, the bin ranges of h rows and
// the row range.
static int smem_bytes(int h, int w, int p) {
  return ((p * (h + w) + 15) / 16) * 16 + 4 * (4 * PMAX + 2 * h + 2);
}

// fq int8 [b, h, w, c] (c a multiple of 4, 4-byte aligned), kyq int8
// [b, n, p, h], kxq int8 [b, n, p, w], sx and rescale float32 [b, n, p]
// -> out int8 [b, n, p, p, c] (4-byte aligned); p <= 16. Returns the
// launch's error, or cudaGetLastError() after it.
extern "C" int roi_align_int8_fwd(const void* fq, const void* kyq,
                                  const void* kxq, const void* sx,
                                  const void* rescale, void* out, int b,
                                  int h, int w, int c, int n, int p,
                                  void* stream) {
  if (p > PMAX || c % 4) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(h, w, p);
  cudaError_t err = cudaFuncSetAttribute(
      roi_align_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b * n, (c / 4 + THREADS - 1) / THREADS);
  roi_align_int8_kernel<<<grid, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(fq), static_cast<const int8_t*>(kyq),
      static_cast<const int8_t*>(kxq), static_cast<const float*>(sx),
      static_cast<const float*>(rescale), static_cast<int8_t*>(out), h, w,
      c, n, p);
  return (int)cudaGetLastError();
}
