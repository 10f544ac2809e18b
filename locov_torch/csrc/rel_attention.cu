// KA2: the ViT's multi-head self-attention with the decomposed
// relative-position bias (models/vit.py:Attention under the bfloat16
// compute dtype), forward only, one launch over every (image or window,
// head, tile of 64 query rows).
//
// Replaces no Pallas kernel: the JAX package has no ViT. The plain route
// (ops/rel_attention.py:rel_attention_plain) writes the [N, heads, L, L]
// scores, the bias added to them and the probabilities to device memory:
// at a global block of ViTDet-B (L = 4,096 tokens, 12 heads) that is
// 805 MB of float32 an image each time. Here no L x L tensor exists: the
// keys are walked in tiles of 64 with an online softmax, and each tile's
// scores get their bias as they are made.
//
// What it computes, for query i and key j of a kh x kw grid (L = kh kw):
//   s_ij = acc_ij / sqrt(hd) + rel_h[i, j / kw] + rel_w[i, j % kw]
//   ctx_i = sum_j exp(s_ij - m_i) v_j / sum_j exp(s_ij - m_i)
// with acc = q . k (bf16 products, f32 sums on the tensor cores), rel_h
// and rel_w the float32 bias terms (q . Rh and q . Rw, computed before the
// launch). The scores are kept in log2 units (s log2 e) and exponentiated
// with exp2; each tile's probabilities are rounded to bf16 for the
// product with v (f32 sums), the context divided by the row sum at the
// end and written in bf16.
//
// Design (mma.sync m16n8k16 bf16 -> f32, the helpers of mma_bf16.cuh as
// in KA1): a block of 4 warps takes 64 query rows of one (n, head), each
// warp 16 rows whose q fragments stay in registers. K and V tiles of 64
// keys (rows padded by 8 bf16) are double-buffered in shared memory by
// cp.async, the next tile loading while the current one is scored. The
// block's rows of rel_h and rel_w are staged once, scaled by log2 e
// (rows padded by one float: 33 KB at kh = kw = 64). Keys past L score
// -inf and their v rows are zeros; query rows past L are computed on
// zeros and not written. The key's grid row and column come from one
// float product: j / kw is exact as floor((j + 0.5) (1 / kw)) for the
// sizes taken (L < 2^16).
//
// Bound on the card (ViTDet-B, 8 images a call): a global block is
// 51.5 GFLOP an image of products (q . k and p . v), 412 GFLOP a launch:
// 0.42 ms at the bf16 peak; its bytes (qkv 151 MB, rel_h and rel_w
// 201 MB, context 50 MB) 0.12 ms. A windowed block (200 windows of 196
// tokens) is 23.6 GFLOP a launch (0.024 ms) and 293 MB (qkv 181 MB,
// rel_h and rel_w 53 MB, context 60 MB): 0.087 ms, bound by its bytes.
//
// Takes hd 64 and 1 <= L < 65536, any kh x kw = L with kh, kw <= 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using locov::ldmatrix_a;
using locov::ldmatrix_b2;
using locov::mma_bf16;

constexpr int HD = 64;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;  // query rows a block
constexpr int BN = 64;          // keys a tile
constexpr int RS = HD + 8;      // shared row stride of K and V, bf16
constexpr int KK = HD / 16;     // k steps of q . k
constexpr int MAX_GRID = 64;    // largest kh, kw
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   locov::smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// Keys k0 .. k0 + BN - 1 of K and V (rows of HD bf16 at stride ld in
// device memory) into shared memory; rows past l are zeros.
__device__ __forceinline__ void load_kv(bf16* ks, bf16* vs, const bf16* kg,
                                        const bf16* vg, int k0, int l,
                                        size_t ld) {
  constexpr int PIECES = HD / 8;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < BN * PIECES; i += THREADS) {
    const int r = i / PIECES, c = (i % PIECES) * 8;
    bf16* kd = ks + r * RS + c;
    bf16* vd = vs + r * RS + c;
    if (k0 + r < l) {
      const size_t off = static_cast<size_t>(k0 + r) * ld + c;
      cp_async16(kd, kg + off);
      cp_async16(vd, vg + off);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
    }
  }
}

// grid (query tiles of BM rows, heads, n); THREADS threads; dynamic
// shared memory smem_bytes(kh, kw).
__global__ void __launch_bounds__(THREADS)
    rel_attention_kernel(const bf16* __restrict__ qkv,
                         const float* __restrict__ rel_h,
                         const float* __restrict__ rel_w,
                         bf16* __restrict__ ctx, int l, int nh, int kh,
                         int kw, float scale_log2, float inv_kw) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // [2][BN][RS]
  bf16* vs = ks + 2 * BN * RS;                // [2][BN][RS]
  float* bh = reinterpret_cast<float*>(vs + 2 * BN * RS);  // [BM][kh + 1]
  float* bw = bh + BM * (kh + 1);                          // [BM][kw + 1]

  const int q0 = blockIdx.x * BM, h = blockIdx.y, n = blockIdx.z;
  const int c = nh * HD;
  const size_t ld = 3 * static_cast<size_t>(c);
  const bf16* base = qkv + static_cast<size_t>(n) * l * ld + h * HD;
  const bf16* kg = base + c;
  const bf16* vg = base + 2 * c;
  const int nkb = (l + BN - 1) / BN;

  load_kv(ks, vs, kg, vg, 0, l, ld);
  cp_async_commit();

  // the block's rows of the bias terms, in log2 units
  const size_t brow = (static_cast<size_t>(n) * nh + h) * l;
  for (int i = threadIdx.x; i < BM * kh; i += THREADS) {
    const int r = i / kh, j = i % kh;
    bh[r * (kh + 1) + j] =
        q0 + r < l ? rel_h[(brow + q0 + r) * kh + j] * LOG2E : 0.f;
  }
  for (int i = threadIdx.x; i < BM * kw; i += THREADS) {
    const int r = i / kw, j = i % kw;
    bw[r * (kw + 1) + j] =
        q0 + r < l ? rel_w[(brow + q0 + r) * kw + j] * LOG2E : 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;  // the block's rows
  const int r0 = q0 + lr0, r1 = q0 + lr1;

  // q fragments of rows r0 and r1 (zeros past l)
  unsigned qf[KK][4];
  {
    const unsigned* p0 =
        reinterpret_cast<const unsigned*>(base + static_cast<size_t>(r0) *
                                                     ld) + qd;
    const unsigned* p1 =
        reinterpret_cast<const unsigned*>(base + static_cast<size_t>(r1) *
                                                     ld) + qd;
    const bool v0 = r0 < l, v1 = r1 < l;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      qf[kk][0] = v0 ? __ldg(p0 + kk * 8) : 0u;
      qf[kk][1] = v1 ? __ldg(p1 + kk * 8) : 0u;
      qf[kk][2] = v0 ? __ldg(p0 + kk * 8 + 4) : 0u;
      qf[kk][3] = v1 ? __ldg(p1 + kk * 8 + 4) : 0u;
    }
  }

  float o[2 * KK][4];
#pragma unroll
  for (int j = 0; j < 2 * KK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
  const float* bh0 = bh + lr0 * (kh + 1);
  const float* bh1 = bh + lr1 * (kh + 1);
  const float* bw0 = bw + lr0 * (kw + 1);
  const float* bw1 = bw + lr1 * (kw + 1);

  for (int kb = 0; kb < nkb; ++kb) {
    const int buf = kb & 1;
    if (kb + 1 < nkb) {
      load_kv(ks + (buf ^ 1) * BN * RS, vs + (buf ^ 1) * BN * RS, kg, vg,
              (kb + 1) * BN, l, ld);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + buf * BN * RS;
    const bf16* vt = vs + buf * BN * RS;

    // s = q . k for the tile's 64 keys: s[t] holds keys 8 t .. 8 t + 7
    float s[BN / 8][4];
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      const bf16* p = kt + (kc * 16 + lane % 16) * RS + (lane / 16) * 8;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        unsigned b[4];
        ldmatrix_a(b, p + kk * 16);
        mma_bf16(s[2 * kc], qf[kk], b[0], b[2]);
        mma_bf16(s[2 * kc + 1], qf[kk], b[1], b[3]);
      }
    }

    // the scores in log2 units with their bias; keys past l at -inf
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = kb * BN + t * 8 + 2 * qd + (e & 1);
        const int jh = __float2int_rz((j + 0.5f) * inv_kw);
        const int jw = j - jh * kw;
        float x = -INFINITY;
        if (j < l)
          x = e < 2 ? fmaf(s[t][e], scale_log2, bh0[jh]) + bw0[jw]
                    : fmaf(s[t][e], scale_log2, bh1[jh]) + bw1[jw];
        s[t][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = fmaxf(mx[r], quad_max(tmax[r]));
      alpha[r] = exp2f(mx[r] - m);
      mx[r] = m;
      sm[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 2 * KK; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // p = exp2(s - m), its row sums, and o += p . v by 16 keys
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      unsigned a[1][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = 2 * kc + u;
        const float p0 = exp2f(s[t][0] - mx[0]);
        const float p1 = exp2f(s[t][1] - mx[0]);
        const float p2 = exp2f(s[t][2] - mx[1]);
        const float p3 = exp2f(s[t][3] - mx[1]);
        sm[0] += p0 + p1;
        sm[1] += p2 + p3;
        a[0][2 * u] = pack_bf16(p0, p1);
        a[0][2 * u + 1] = pack_bf16(p2, p3);
      }
      const bf16* p = vt + (kc * 16 + lane % 16) * RS + (lane / 16) * 8;
#pragma unroll
      for (int jj = 0; jj < KK; ++jj) {
        unsigned b[4];
        ldmatrix_b2(b, p + jj * 16);
        mma_bf16(o[2 * jj], a[0], b[0], b[1]);
        mma_bf16(o[2 * jj + 1], a[0], b[2], b[3]);
      }
    }
    __syncthreads();  // the buffer is reloaded next step
  }

  const float inv0 = 1.f / quad_sum(sm[0]), inv1 = 1.f / quad_sum(sm[1]);
  bf16* out = ctx + h * HD + 2 * qd;
#pragma unroll
  for (int j = 0; j < 2 * KK; ++j) {
    if (r0 < l)
      *reinterpret_cast<unsigned*>(
          out + (static_cast<size_t>(n) * l + r0) * c + j * 8) =
          pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < l)
      *reinterpret_cast<unsigned*>(
          out + (static_cast<size_t>(n) * l + r1) * c + j * 8) =
          pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
}

size_t smem_bytes(int kh, int kw) {
  return 4 * BN * RS * sizeof(bf16) +
         BM * (kh + 1 + kw + 1) * sizeof(float);
}

}  // namespace

// qkv [n, l, 3 nh hd] bf16 (q, k, v side by side, a head's hd columns
// together), rel_h [n, nh, l, kh] and rel_w [n, nh, l, kw] f32 -> ctx
// [n, l, nh hd] bf16, every element written. hd must be 64, l = kh kw,
// kh and kw at most 64; scale = 1 / sqrt(hd). Returns
// cudaErrorInvalidValue for shapes the kernel does not take, else the
// first CUDA error of the launch, or 0.
extern "C" int rel_attention_fwd(const void* qkv, const void* rel_h,
                                 const void* rel_w, void* ctx, int n, int l,
                                 int nh, int hd, int kh, int kw, float scale,
                                 void* stream) {
  if (hd != HD || n < 1 || nh < 1 || kh < 1 || kw < 1 || kh > MAX_GRID ||
      kw > MAX_GRID || l != kh * kw || n > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(kh, kw);
  cudaError_t err = cudaFuncSetAttribute(
      rel_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((l + BM - 1) / BM, nh, n);
  rel_attention_kernel<<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<bf16*>(ctx), l, nh, kh,
      kw, scale * LOG2E, 1.f / kw);
  return (int)cudaGetLastError();
}
