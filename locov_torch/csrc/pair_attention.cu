// KA1: the joint encoder's self-attention (models/bert.py:
// BertSelfAttention under the bfloat16 compute dtype), forward and
// backward, each one launch over every (pair, head).
//
// Replaces no Pallas kernel: JAX leaves this attention to XLA
// (locov_tpu/models/bert.py:95-100), and the port ran it as a chain of
// PyTorch ops (ops/pair_attention.py:pair_attention_plain) that wrote the
// [pairs, heads, L, L] score tensor to device memory some ten times a
// layer, forward and backward. Here the scores never leave the block.
//
// What it computes (the plain chain's rounding points, mirrored):
//   s  = bf16(bf16(q . k) * (1 / sqrt(hd)))  the product rounded, then
//        divided in bf16 (PyTorch on CUDA multiplies by the f32 reciprocal)
//   x  = f32(s) + bias[key]                  the f32 bias promotes
//   p  = exp(x - max) * (1 / sum)            an exact row softmax in f32
//   pd = u < 1 - p_drop ? p * (1 / (1 - p_drop)) : 0   torch.rand's uniforms
//   ctx = pd . v                             to f32 accuracy, rounded to bf16
// The context product is f32 in the chain; v is exactly bf16, so pd is
// split into three bf16 terms (hi + mid + lo carry its 24 bits) and the
// three bf16 products accumulate in f32 on the tensor cores: no TF32, no
// f32 GEMM on the CUDA cores. ctx is written in bf16, the consumer's
// (``Dense``'s) first rounding. For the backward the forward also writes
// the context in f32, each row's max and sum and the keep mask as bits.
//
// The backward recomputes s and p from q, k, the row statistics and the
// bits, and mirrors autograd's chain: dpd = dO . v^T (dO is bf16-exact:
// it comes through the Dense's bf16 cast, so one bf16 product with f32
// sums is exact); dv = bf16(pd^T . dO) with pd split as above; the dropout
// backward; PyTorch's softmax backward (dx = fma(-p, D, dp * p) with D
// the row sum of dp * p, taken here as the row sum of dO * ctx: the same
// products in another order); dx rounded to bf16 at the bias add, then
// multiplied by 1 / sqrt(hd) in bf16; dq = dqk . k and dk = dqk^T . q in
// bf16 products. It writes dq, dk, dv packed as the qkv input is.
//
// Design (mma.sync m16n8k16 bf16 -> f32, as K4 and K5): one block of 4
// warps a (pair, head); each warp takes 16-row tiles in turn. Q, K, V are
// read by strides from the [N, L, 3 H] qkv product. The forward stages K
// and V whole in shared memory (L padded to 16, rows padded by 8 bf16:
// 74 KB at L 170, hd 96; 168 registers, three blocks an SM) and walks the
// keys 16 at a time twice a row tile: the row max, then exp(x - max), its
// sum, the dropout and the context product, scaled by 1 / sum at the end
// (the softmax is exact with no rescaling, and the [16, L] scores need
// no room); each walk recomputes q . k from registers and shared memory,
// and the uniforms are loaded a key step ahead. The backward stages K and
// V for its row phase (dq), then Q and dO for its key phase (dv and dk
// together, over the transposed tiles: k . q^T computes the same
// products as q . k^T in the same k order). The keep bits are a
// row-major bit matrix [N, heads, L, ceil(L16 / 32)], L16 = L rounded up
// to 16.
//
// Bound on the card (L 170, hd 96, 128 pairs x 8 heads, one launch): its
// bytes. Forward ~0.33 GB (the f32 uniforms 118 MB, qkv 100 MB, the bf16
// and f32 contexts 100 MB, statistics and bits) ~0.10 ms at 3.35 TB/s;
// its products 11 GFLOP (30 GFLOP as computed: two q . k walks and three
// bf16 terms of pd . v). Backward ~0.31 GB ~0.09 ms; 23 GFLOP (55 as
// computed).
//
// Takes hd 64 or 96 and 1 <= L <= 512: shared memory 215 KB (forward)
// and 221 KB (backward) at hd 96, L 512.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using locov::ldmatrix_a;
using locov::ldmatrix_b2;
using locov::mma_bf16;
using locov::pack_bf16;
using locov::quad_max;
using locov::quad_sum;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

struct Shape {
  int l, nh;  // tokens, heads
  int lp;     // l rounded up to 16
  int w;      // 32-bit words of keep bits a row: ceil(lp / 32)
};

struct Scalars {
  float inv_sqrt;    // 1 / sqrt(hd) in f32
  float keep_below;  // 1 - p_drop in f32
  float inv_keep;    // 1 / (1 - p_drop) in f32
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   locov::smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The chain's logit from an f32 product sum.
__device__ __forceinline__ float logit(float acc, float inv_sqrt,
                                       float bias) {
  return __fadd_rn(bf16_round(__fmul_rn(bf16_round(acc), inv_sqrt)), bias);
}

__device__ __forceinline__ float expm(float x, float m) {
  return expf(__fsub_rn(x, m));
}

// The rows (of hd bf16 each) 0 .. lp-1 of a row-major matrix at src with
// row stride ld, into shared memory at row stride hd + 8; rows past l
// are zeros.
template <int HD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int l,
                                     int lp, size_t ld) {
  constexpr int PIECES = HD / 8;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < lp * PIECES; i += THREADS) {
    const int r = i / PIECES, c = i % PIECES;
    bf16* d = dst + r * (HD + 8) + c * 8;
    if (r < l)
      cp_async16(d, src + r * ld + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// The A fragments of rows r0 and r0 + 8 (r0 = 16 t + lane / 4) of a
// row-major [rows][HD] bf16 matrix in device memory (row stride ld),
// zeros past row l.
template <int KK>
__device__ __forceinline__ void load_a(unsigned (&a)[KK][4], const bf16* src,
                                       int r0, int l, size_t ld, int qd) {
  const unsigned* p0 = reinterpret_cast<const unsigned*>(src + r0 * ld) + qd;
  const unsigned* p1 =
      reinterpret_cast<const unsigned*>(src + (r0 + 8) * ld) + qd;
  const bool v0 = r0 < l, v1 = r0 + 8 < l;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    a[kk][0] = v0 ? __ldg(p0 + kk * 8) : 0u;
    a[kk][1] = v1 ? __ldg(p1 + kk * 8) : 0u;
    a[kk][2] = v0 ? __ldg(p0 + kk * 8 + 4) : 0u;
    a[kk][3] = v1 ? __ldg(p1 + kk * 8 + 4) : 0u;
  }
}

// c = a . B^T for the 16 rows of a and the 16 rows of B at `rows` (shared
// memory, row stride rs): c[t] holds columns 8 t .. 8 t + 7.
template <int KK>
__device__ __forceinline__ void tile_abt(float (&c)[2][4],
                                         const unsigned (&a)[KK][4],
                                         const bf16* rows, int rs,
                                         int lane) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[t][e] = 0.f;
  const bf16* p = rows + (lane % 16) * rs + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    unsigned b[4];
    ldmatrix_a(b, p + kk * 16);
    mma_bf16(c[0], a[kk], b[0], b[2]);
    mma_bf16(c[1], a[kk], b[1], b[3]);
  }
}

// c += sum over the T terms of a[t] . B, B the 16 x (16 KK) row-major
// tile at `rows` (shared memory, row stride rs).
template <int KK, int T>
__device__ __forceinline__ void tile_ab(float (&c)[2 * KK][4],
                                        const unsigned (&a)[T][4],
                                        const bf16* rows, int rs, int lane) {
  const bf16* p = rows + (lane % 16) * rs + (lane / 16) * 8;
#pragma unroll
  for (int j = 0; j < KK; ++j) {
    unsigned b[4];
    ldmatrix_b2(b, p + j * 16);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      mma_bf16(c[2 * j], a[t], b[0], b[1]);
      mma_bf16(c[2 * j + 1], a[t], b[2], b[3]);
    }
  }
}

// The A fragment of a 16 x 16 tile held as accumulators (c[t] its columns
// 8 t ..), in bf16: exact where the values are bf16 already.
__device__ __forceinline__ void a_frag(unsigned (&a)[4],
                                       const float (&c)[2][4]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    a[2 * t] = pack_bf16(c[t][0], c[t][1]);
    a[2 * t + 1] = pack_bf16(c[t][2], c[t][3]);
  }
}

// The same in three bf16 terms, hi + mid + lo = c to f32 accuracy (each
// difference is exact in f32).
__device__ __forceinline__ void a_frag3(unsigned (&a)[3][4],
                                        const float (&c)[2][4]) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float x0 = c[t][2 * half], x1 = c[t][2 * half + 1];
      const float h0 = bf16_round(x0), h1 = bf16_round(x1);
      const float r0 = __fsub_rn(x0, h0), r1 = __fsub_rn(x1, h1);
      const float m0 = bf16_round(r0), m1 = bf16_round(r1);
      a[0][2 * t + half] = pack_bf16(h0, h1);
      a[1][2 * t + half] = pack_bf16(m0, m1);
      a[2][2 * t + half] = pack_bf16(__fsub_rn(r0, m0), __fsub_rn(r1, m1));
    }
}

// Accumulator element e of tile t: row g (e < 2) or g + 8, column
// 8 t + 2 (lane % 4) + (e & 1).
__device__ __forceinline__ int col_of(int t, int e, int qd) {
  return t * 8 + 2 * qd + (e & 1);
}

// The dropout's uniforms at the accumulator elements of key step kb of
// rows r0 and r0 + 8; 1 (dropped) past the last row or key.
__device__ __forceinline__ void load_u(float (&uv)[2][4], const float* ub,
                                       int r0, int l, int kb, int qd) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? r0 : r0 + 8;
      const int col = kb * 16 + col_of(t, e, qd);
      uv[t][e] = row < l && col < l
                     ? __ldcs(ub + static_cast<size_t>(row) * l + col)
                     : 1.f;
    }
}

// p from its logit, the row max and the reciprocal of the row sum.
__device__ __forceinline__ float prob(float x, float m, float r) {
  return __fmul_rn(expm(x, m), r);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 3)
    pair_attention_fwd_kernel(const bf16* __restrict__ qkv,
                              const float* __restrict__ bias,
                              const float* __restrict__ u,
                              bf16* __restrict__ ctx,
                              float* __restrict__ ctx32,
                              float* __restrict__ stats,
                              unsigned* __restrict__ bits, Shape sh,
                              Scalars sc) {
  constexpr int KK = HD / 16, RS = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + sh.lp * RS;
  float* bs = reinterpret_cast<float*>(vs + sh.lp * RS);

  const int bh = blockIdx.x, n = bh / sh.nh, h = bh % sh.nh, l = sh.l;
  const int hid = sh.nh * HD;
  const size_t ld = 3 * static_cast<size_t>(hid);
  const bf16* qg = qkv + static_cast<size_t>(n) * l * ld + h * HD;
  stage<HD>(ks, qg + hid, l, sh.lp, ld);
  stage<HD>(vs, qg + 2 * hid, l, sh.lp, ld);
  for (int j = threadIdx.x; j < sh.lp; j += THREADS)
    bs[j] = j < l ? bias[static_cast<size_t>(n) * l + j] : -INFINITY;
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int nkb = sh.lp / 16;
  const float* ub = u ? u + static_cast<size_t>(bh) * l * l : nullptr;
  const bool keep_bits = ub && bits;
  for (int rt = warp; rt < nkb; rt += WARPS) {
    const int r0 = rt * 16 + g, r1 = r0 + 8;
    unsigned qf[KK][4];
    load_a<KK>(qf, qg, r0, l, ld, qd);
    float un[2][4] = {};  // the next key step's uniforms, loaded ahead
    if (ub) load_u(un, ub, r0, l, 0, qd);

    float mx[2] = {-INFINITY, -INFINITY};
    for (int kb = 0; kb < nkb; ++kb) {
      float c[2][4];
      tile_abt<KK>(c, qf, ks + kb * 16 * RS, RS, lane);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1],
                             logit(c[t][e], sc.inv_sqrt,
                                   bs[kb * 16 + col_of(t, e, qd)]));
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);

    // exp(x - max), its row sum and the dropped-out product with v in
    // one walk; the context is scaled by 1 / sum at the end.
    float sm[2] = {0.f, 0.f};
    float o[2 * KK][4];
#pragma unroll
    for (int j = 0; j < 2 * KK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    unsigned word0 = 0, word1 = 0;
    for (int kb = 0; kb < nkb; ++kb) {
      float uv[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) uv[t][e] = un[t][e];
      if (ub && kb + 1 < nkb) load_u(un, ub, r0, l, kb + 1, qd);
      float c[2][4];
      tile_abt<KK>(c, qf, ks + kb * 16 * RS, RS, lane);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kb * 16 + col_of(t, e, qd);
          float p = expm(logit(c[t][e], sc.inv_sqrt, bs[col]), mx[e >> 1]);
          sm[e >> 1] += p;
          if (ub) {
            const bool keep = uv[t][e] < sc.keep_below;
            p = keep ? __fmul_rn(p, sc.inv_keep) : 0.f;
            const unsigned bit = static_cast<unsigned>(keep)
                                 << ((kb & 1) * 16 + col_of(t, e, qd));
            if (e < 2)
              word0 |= bit;
            else
              word1 |= bit;
          }
          c[t][e] = p;
        }
      unsigned a[3][4];
      a_frag3(a, c);
      tile_ab<KK, 3>(o, a, vs + kb * 16 * RS, RS, lane);
      if (keep_bits && ((kb & 1) || kb == nkb - 1)) {
        word0 |= __shfl_xor_sync(FULL, word0, 1);
        word0 |= __shfl_xor_sync(FULL, word0, 2);
        word1 |= __shfl_xor_sync(FULL, word1, 1);
        word1 |= __shfl_xor_sync(FULL, word1, 2);
        const int row = qd == 0 ? r0 : r1;
        if (qd < 2 && row < l)
          bits[(static_cast<size_t>(bh) * l + row) * sh.w + kb / 2] =
              qd == 0 ? word0 : word1;
        word0 = word1 = 0;
      }
    }
    sm[0] = quad_sum(sm[0]);
    sm[1] = quad_sum(sm[1]);
    const float rs[2] = {__frcp_rn(sm[0]), __frcp_rn(sm[1])};

    const size_t at =
        (static_cast<size_t>(n) * l + r0) * hid + h * HD + 2 * qd;
#pragma unroll
    for (int j = 0; j < 2 * KK; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? r1 : r0;
        if (row >= l) continue;
        const float x0 = __fmul_rn(o[j][2 * half], rs[half]);
        const float x1 = __fmul_rn(o[j][2 * half + 1], rs[half]);
        const size_t off = at + half * 8 * static_cast<size_t>(hid) + j * 8;
        *reinterpret_cast<unsigned*>(ctx + off) = pack_bf16(x0, x1);
        if (ctx32)
          *reinterpret_cast<float2*>(ctx32 + off) = make_float2(x0, x1);
      }
    if (stats && qd == 0) {
      float* st = stats + (static_cast<size_t>(bh) * l + r0) * 2;
      if (r0 < l) {
        st[0] = mx[0];
        st[1] = sm[0];
      }
      if (r1 < l) {
        st[16] = mx[1];
        st[17] = sm[1];
      }
    }
  }
}

// The gradient of p from that of pd: the dropout's backward.
__device__ __forceinline__ float dprob(float dpd, bool dropout, bool keep,
                                       float inv_keep) {
  if (!dropout) return dpd;
  return keep ? __fmul_rn(dpd, inv_keep) : 0.f;
}

// dqk: the softmax backward (dx = fma(-p, D, dp * p), PyTorch's), rounded
// to bf16 at the bias add, then times 1 / sqrt(hd) in bf16.
__device__ __forceinline__ float dlogit(float p, float dp, float d,
                                        float inv_sqrt) {
  const float dx = __fmaf_rn(-p, d, __fmul_rn(dp, p));
  return bf16_round(__fmul_rn(bf16_round(dx), inv_sqrt));
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    pair_attention_bwd_kernel(const bf16* __restrict__ qkv,
                              const float* __restrict__ bias,
                              const float* __restrict__ ctx32,
                              const float* __restrict__ stats,
                              const unsigned* __restrict__ bits,
                              const bf16* __restrict__ dout,
                              bf16* __restrict__ dqkv, Shape sh,
                              Scalars sc) {
  constexpr int KK = HD / 16, RS = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);  // K, then Q
  bf16* bsm = as + sh.lp * RS;               // V, then dO
  float* bias_s = reinterpret_cast<float*>(bsm + sh.lp * RS);
  float* m_s = bias_s + sh.lp;  // row max (+inf past l: p = 0 there)
  float* r_s = m_s + sh.lp;     // 1 / row sum
  float* d_s = r_s + sh.lp;     // D: the row sum of dp * p

  const int bh = blockIdx.x, n = bh / sh.nh, h = bh % sh.nh, l = sh.l;
  const int hid = sh.nh * HD;
  const size_t ld = 3 * static_cast<size_t>(hid);
  const bf16* qg = qkv + static_cast<size_t>(n) * l * ld + h * HD;
  const bf16* dog = dout + static_cast<size_t>(n) * l * hid + h * HD;
  const float* og = ctx32 + static_cast<size_t>(n) * l * hid + h * HD;
  bf16* dg = dqkv + static_cast<size_t>(n) * l * ld + h * HD;
  const unsigned* bw = bits ? bits + static_cast<size_t>(bh) * l * sh.w
                            : nullptr;
  const bool drop = bw != nullptr;
  stage<HD>(as, qg + hid, l, sh.lp, ld);
  stage<HD>(bsm, qg + 2 * hid, l, sh.lp, ld);
  for (int j = threadIdx.x; j < sh.lp; j += THREADS) {
    const bool v = j < l;
    const float* st = stats + (static_cast<size_t>(bh) * l + j) * 2;
    bias_s[j] = v ? bias[static_cast<size_t>(n) * l + j] : -INFINITY;
    m_s[j] = v ? st[0] : INFINITY;
    r_s[j] = v ? __frcp_rn(st[1]) : 1.f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int nkb = sh.lp / 16;
  // D = sum_j dp * p = sum_d dO * O (O the forward's float32 context): the
  // same products summed in another order.
  for (int i = warp; i < sh.lp; i += WARPS) {
    float d = 0.f;
    if (i < l)
      for (int c = lane; c < HD; c += 32)
        d = __fmaf_rn(__bfloat162float(dog[static_cast<size_t>(i) * hid + c]),
                      og[static_cast<size_t>(i) * hid + c], d);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) d += __shfl_xor_sync(FULL, d, s);
    if (lane == 0) d_s[i] = d;
  }
  cp_async_wait_all();
  __syncthreads();

  // Rows: dq = dqk . k.
  for (int rt = warp; rt < nkb; rt += WARPS) {
    const int r0 = rt * 16 + g, r1 = r0 + 8;
    unsigned qf[KK][4], df[KK][4];
    load_a<KK>(qf, qg, r0, l, ld, qd);
    load_a<KK>(df, dog, r0, l, hid, qd);
    const float m[2] = {m_s[r0], m_s[r1]}, r[2] = {r_s[r0], r_s[r1]};
    const float d[2] = {d_s[r0], d_s[r1]};
    float dq[2 * KK][4];
#pragma unroll
    for (int j = 0; j < 2 * KK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
    for (int kb = 0; kb < nkb; ++kb) {
      unsigned w0 = 0, w1 = 0;
      if (drop) {
        if (r0 < l) w0 = __ldg(bw + static_cast<size_t>(r0) * sh.w + kb / 2);
        if (r1 < l) w1 = __ldg(bw + static_cast<size_t>(r1) * sh.w + kb / 2);
      }
      float c[2][4], dp[2][4];
      tile_abt<KK>(c, qf, as + kb * 16 * RS, RS, lane);
      tile_abt<KK>(dp, df, bsm + kb * 16 * RS, RS, lane);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, col = col_of(t, e, qd);
          const float p = prob(
              logit(c[t][e], sc.inv_sqrt, bias_s[kb * 16 + col]), m[i], r[i]);
          const bool keep = ((i ? w1 : w0) >> ((kb & 1) * 16 + col)) & 1u;
          c[t][e] = dlogit(p, dprob(dp[t][e], drop, keep, sc.inv_keep), d[i],
                           sc.inv_sqrt);
        }
      unsigned a[1][4];
      a_frag(a[0], c);
      tile_ab<KK, 1>(dq, a, as + kb * 16 * RS, RS, lane);
    }
    bf16* out = dg + static_cast<size_t>(r0) * ld + 2 * qd;
#pragma unroll
    for (int j = 0; j < 2 * KK; ++j) {
      if (r0 < l)
        *reinterpret_cast<unsigned*>(out + j * 8) =
            pack_bf16(dq[j][0], dq[j][1]);
      if (r1 < l)
        *reinterpret_cast<unsigned*>(out + 8 * ld + j * 8) =
            pack_bf16(dq[j][2], dq[j][3]);
    }
  }
  __syncthreads();
  stage<HD>(as, qg, l, sh.lp, ld);
  stage<HD>(bsm, dog, l, sh.lp, hid);
  cp_async_wait_all();
  __syncthreads();

  // Keys: dv = pd^T . dO and dk = dqk^T . q over the transposed tiles:
  // rows are keys, columns queries.
  for (int kt = warp; kt < nkb; kt += WARPS) {
    const int j0 = kt * 16 + g, j1 = j0 + 8;
    unsigned kf[KK][4], vf[KK][4];
    load_a<KK>(kf, qg + hid, j0, l, ld, qd);
    load_a<KK>(vf, qg + 2 * hid, j0, l, ld, qd);
    const float bj[2] = {bias_s[j0], bias_s[j1]};
    const int shift = (kt & 1) * 16 + g;
    float dv[2 * KK][4], dk[2 * KK][4];
#pragma unroll
    for (int j = 0; j < 2 * KK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[j][e] = dk[j][e] = 0.f;
    for (int qs = 0; qs < nkb; ++qs) {
      unsigned wq[2][2] = {{0, 0}, {0, 0}};  // [t][e & 1]: query's word
      if (drop) {
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int c1 = 0; c1 < 2; ++c1) {
            const int i = qs * 16 + col_of(t, c1, qd);
            if (i < l)
              wq[t][c1] = __ldg(bw + static_cast<size_t>(i) * sh.w + kt / 2);
          }
      }
      float c[2][4], dp[2][4];
      tile_abt<KK>(c, kf, as + qs * 16 * RS, RS, lane);
      tile_abt<KK>(dp, vf, bsm + qs * 16 * RS, RS, lane);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = qs * 16 + col_of(t, e, qd);
          const float p = prob(logit(c[t][e], sc.inv_sqrt, bj[e >> 1]),
                               m_s[i], r_s[i]);
          const bool keep = (wq[t][e & 1] >> (shift + 8 * (e >> 1))) & 1u;
          dp[t][e] = dlogit(p, dprob(dp[t][e], drop, keep, sc.inv_keep),
                            d_s[i], sc.inv_sqrt);
          c[t][e] = drop ? (keep ? __fmul_rn(p, sc.inv_keep) : 0.f) : p;
        }
      unsigned a3[3][4], a1[1][4];
      a_frag3(a3, c);
      tile_ab<KK, 3>(dv, a3, bsm + qs * 16 * RS, RS, lane);
      a_frag(a1[0], dp);
      tile_ab<KK, 1>(dk, a1, as + qs * 16 * RS, RS, lane);
    }
    bf16* out = dg + static_cast<size_t>(j0) * ld + hid + 2 * qd;
#pragma unroll
    for (int j = 0; j < 2 * KK; ++j) {
      if (j0 < l) {
        *reinterpret_cast<unsigned*>(out + j * 8) =
            pack_bf16(dk[j][0], dk[j][1]);
        *reinterpret_cast<unsigned*>(out + hid + j * 8) =
            pack_bf16(dv[j][0], dv[j][1]);
      }
      if (j1 < l) {
        *reinterpret_cast<unsigned*>(out + 8 * ld + j * 8) =
            pack_bf16(dk[j][2], dk[j][3]);
        *reinterpret_cast<unsigned*>(out + 8 * ld + hid + j * 8) =
            pack_bf16(dv[j][2], dv[j][3]);
      }
    }
  }
}

size_t fwd_smem_bytes(int hd, int lp) {
  return 2 * static_cast<size_t>(lp) * (hd + 8) * sizeof(bf16) +
         static_cast<size_t>(lp) * sizeof(float);
}

size_t bwd_smem_bytes(int hd, int lp) {
  return 2 * static_cast<size_t>(lp) * (hd + 8) * sizeof(bf16) +
         4 * static_cast<size_t>(lp) * sizeof(float);
}

constexpr size_t MAX_SMEM = 232448;  // a block's most on sm_90

bool make_shape(int n, int l, int nh, int hd, Shape* sh) {
  if (n < 1 || l < 1 || l > 512 || nh < 1 || (hd != 64 && hd != 96))
    return false;
  sh->l = l;
  sh->nh = nh;
  sh->lp = (l + 15) / 16 * 16;
  sh->w = (sh->lp + 31) / 32;
  return true;
}

template <typename K>
int launch(K kernel, size_t smem, int blocks, cudaStream_t stream,
           const void* const* args) {
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                         dim3(THREADS), const_cast<void**>(args), smem,
                         stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv [n, l, 3 nh hd] bf16; bias [n, l] f32; u [n, nh, l, l] f32 or null
// (no dropout); ctx [n, l, nh hd] bf16. For the backward, each or null:
// ctx32 the context in f32 (as ctx), stats [n, nh, l, 2] f32 (row max,
// row sum), bits [n, nh, l, ceil(l16 / 32)] u32 (written where u is given).
extern "C" int pair_attention_fwd(const void* qkv, const void* bias,
                                  const void* u, void* ctx, void* ctx32,
                                  void* stats, void* bits, int n, int l,
                                  int nh, int hd, float inv_sqrt,
                                  float keep_below, float inv_keep,
                                  void* stream) {
  Shape sh;
  if (!make_shape(n, l, nh, hd, &sh))
    return static_cast<int>(cudaErrorInvalidValue);
  Scalars sc{inv_sqrt, keep_below, inv_keep};
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* b = static_cast<const float*>(bias);
  const float* uu = static_cast<const float*>(u);
  bf16* c = static_cast<bf16*>(ctx);
  float* c32 = static_cast<float*>(ctx32);
  float* st = static_cast<float*>(stats);
  unsigned* bt = static_cast<unsigned*>(bits);
  const void* args[] = {&q, &b, &uu, &c, &c32, &st, &bt, &sh, &sc};
  const size_t smem = fwd_smem_bytes(hd, sh.lp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd == 64 ? launch(pair_attention_fwd_kernel<64>, smem, n * nh, s,
                           args)
                  : launch(pair_attention_fwd_kernel<96>, smem, n * nh, s,
                           args);
}

// The forward's qkv, bias, ctx32 and stats, its bits (null where it had
// no dropout); dout [n, l, nh hd] bf16 (the gradient of ctx); dqkv
// [n, l, 3 nh hd] bf16.
extern "C" int pair_attention_bwd(const void* qkv, const void* bias,
                                  const void* ctx32, const void* stats,
                                  const void* bits, const void* dout,
                                  void* dqkv, int n, int l, int nh, int hd,
                                  float inv_sqrt, float inv_keep,
                                  void* stream) {
  Shape sh;
  if (!make_shape(n, l, nh, hd, &sh))
    return static_cast<int>(cudaErrorInvalidValue);
  Scalars sc{inv_sqrt, 1.f, inv_keep};
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* b = static_cast<const float*>(bias);
  const float* c32 = static_cast<const float*>(ctx32);
  const float* st = static_cast<const float*>(stats);
  const unsigned* bt = static_cast<const unsigned*>(bits);
  const bf16* d = static_cast<const bf16*>(dout);
  bf16* dq = static_cast<bf16*>(dqkv);
  const void* args[] = {&q, &b, &c32, &st, &bt, &d, &dq, &sh, &sc};
  const size_t smem = bwd_smem_bytes(hd, sh.lp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd == 64 ? launch(pair_attention_bwd_kernel<64>, smem, n * nh, s,
                           args)
                  : launch(pair_attention_bwd_kernel<96>, smem, n * nh, s,
                           args);
}
