// KA2: the ViT's multi-head self-attention with the decomposed
// relative-position bias (models/vit.py:Attention under the bfloat16
// compute dtype), forward only, the bias formed inside the kernel from q
// and the block's two position tables: one launch over every (image or
// window, head), no bias tensor and no [L, L] tensor in device memory.
//
// Replaces no Pallas kernel: the JAX package has no ViT. The plain route
// (ops/rel_attention.py:rel_attention_plain) builds the bias terms
// rel_h [N, heads, L, kh] and rel_w [N, heads, L, kw] in float32
// (rel_pos_terms) and writes the [N, heads, L, L] scores and
// probabilities: at a global block of ViTDet-B (L = 4,096, 12 heads)
// 805 MB of float32 an image.
//
// What it computes, for query i and key j of a kh x kw grid (L = kh kw):
//   s_ij = q_i . k_j / sqrt(hd) + q_i . Rh[i_h - j_h + kh - 1]
//                               + q_i . Rw[i_w - j_w + kw - 1]
//   ctx_i = sum_j exp(s_ij - m_i) v_j / sum_j exp(s_ij - m_i)
// with Rh [2 kh - 1, hd] and Rw [2 kw - 1, hd] the float32 tables. The
// scores are kept in log2 units (s log2 e) and exponentiated with exp2
// (ex2.approx); each tile's probabilities are rounded to bf16 for the
// product with v (f32 sums), the context divided by the row sum at the
// end and written in bf16.
//
// The bias stays float32-accurate: each table is split once a block into
// bf16 hi + lo (hi = bf16(R), lo = bf16(R - hi); hi + lo is R within
// 2^-17 |R|), and q (bf16, exact) meets both on the tensor cores with f32
// sums, two products where FFMA on the CUDA cores would cost about a
// quarter of the attention's own products at ViTDet's global shape. For
// each 64-row query tile, q . T^T is taken for every table row (one
// m64n128k16 product a part for the 127 rows of a 64 x 64 grid's table,
// m64n32k16 for a 14 x 14 window's 27), and each product lands in the
// one term it is, in shared memory: bh[i][j_h] and bw[i][j_w], scaled by
// log2 e. Scoring a key tile gathers bh + bw for each score.
//
// Design (sm_90a): q, k and v come in by TMA from a 3-D map of qkv
// [N, L, 3 C] (boxes of 64 columns, one head; rows past L read as zeros)
// in the 128-byte swizzle that wgmma reads; mbarriers carry the loads.
// Consumer warpgroups of 64 query rows each take S = q k^T as wgmma from
// shared memory and O += P V as wgmma with P from registers (V read
// MN-major), the online softmax in f32 between. The kernel adapts on L:
// - long L (> 208: ViTDet's global blocks): a block takes 128 query rows
//   (two consumer warpgroups and one producer warp whose lane 0 issues
//   the loads: 288 threads, 168 registers each) and streams key tiles of
//   128 through rings of two K and two V stages, each stage freed as
//   soon as its product is done. The two warpgroups pass two tokens on
//   named barriers: one for the tensor cores, under which a warpgroup
//   issues S of this tile and P V of the tile before (FA3's ping-pong),
//   one for the softmax, so that the two softmaxes, which share each
//   sub-partition's exp2 unit, alternate and each runs against the other
//   warpgroup's products. At hd 64 the exponentials take the tensor
//   cores' time: measured on the card, dropping exp2 saves a fifth, the
//   bias gather a twentieth. At a 64-wide grid a key tile is two grid
//   rows, so a thread's bw columns are the same every tile (read as
//   float2) and the tile's two bh fold into the exponent's shift.
// - short L (<= 208: a 14 x 14 window): one key tile of 208 keys (13
//   steps of 16 for P V; 12 keys of zeros past 196), one warpgroup whose
//   thread 0 also issues the loads, walking the window's four query tiles
//   against it, two blocks an SM (255 registers) so that one block's
//   loads overlap the other's products.
// ptxas allocates every thread the launch bound's registers (setmaxnreg
// did not raise it), so the register budget is the launch's. Other grids
// take the same paths with the terms gathered a pair of keys at a time
// (j / kw by a reciprocal multiply).
//
// Bound on the card (ViTDet-B, 8 images a call): a global block is
// 51.5 GFLOP an image of products (q . k and p . v), 412 GFLOP a launch:
// 0.42 ms at the bf16 peak; its bytes (qkv 151 MB, the context 50 MB)
// 0.06 ms. A windowed block (200 windows of 196 tokens) is 23.6 GFLOP a
// launch (0.024 ms) and 241 MB (qkv 181 MB, the context 60 MB): 0.072 ms,
// bound by its bytes. The bias terms' products add 6% (global) and a
// third (windowed) to the products on the tensor cores.
//
// Takes hd 64 and any kh x kw = L with 1 <= kh, kw <= 64.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using locov::desc;
using locov::fence_operands;
using locov::mbar_arrive;
using locov::mbar_expect_tx;
using locov::mbar_init;
using locov::mbar_wait;
using locov::pack_bf16;
using locov::quad_max;
using locov::quad_sum;
using locov::smem_u32;
using locov::tma_load3;
using locov::wgmma_commit;
using locov::wgmma_fence;
using locov::wgmma_wait;

constexpr int HD = 64;
constexpr int ROW = 2 * HD;     // bytes of one head's q, k or v row
constexpr int TILE = 64 * ROW;  // a warpgroup's 64 query rows
constexpr int MAX_GRID = 64;    // largest kh, kw
constexpr int CHUNK = 32;       // table rows come in units of 32 (4 KB)
constexpr int CHUNK_BYTES = CHUNK * ROW;
constexpr int MAX_CHUNKS = (2 * MAX_GRID - 1 + CHUNK - 1) / CHUNK;  // 4
constexpr int SHORT = 208;  // the one key tile of a short L
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ENCODE_FAILED = 1001;  // a tensor map could not be encoded

// A long L: two consumer warpgroups and a producer warp (288 threads,
// 168 registers each: nine warps put three on one of the SM's four
// sub-partitions), two K and two V stages of 128 keys. A short L: one
// warpgroup whose thread 0 also issues the loads, one stage of 208 keys,
// two blocks an SM (255 registers).
template <int BN>
struct Cfg {
  static constexpr bool LONG = BN != SHORT;
  static constexpr int CWG = LONG ? 2 : 1;  // consumer warpgroups
  static constexpr int THREADS = 128 * CWG + (LONG ? 32 : 0);
  static constexpr int STAGES = LONG ? 2 : 1;
  static constexpr int KV_BYTES = BN * ROW;
  static constexpr int Q_TILES = LONG ? 2 : 4;  // query tiles a block
  static constexpr int BLOCKS = LONG ? 1 : 2;   // blocks an SM
};

struct Params {
  const float* rel_pos_h;  // [2 kh - 1, HD]
  const float* rel_pos_w;  // [2 kw - 1, HD]
  bf16* ctx;               // [n, l, nh HD]
  int l, nh, kh, kw;
  int q_tiles;     // query tiles of 64 rows a block
  int nkb;         // key tiles
  float scale_log2;
  // key / kw as __umulhi(key, kw_magic) + key kw_one: kw_magic =
  // ceil(2^32 / kw), exact for key < 2^16 and kw <= 64 (the product's
  // excess stays under key / 2^32 < 1 / kw); kw_one = (kw == 1), whose
  // magic does not fit
  unsigned kw_magic, kw_one;
  int tab_off, terms_off, bar_off;  // the shared-memory layout
};

__device__ __forceinline__ unsigned pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(unsigned (&a)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// ------------------------------------------------ wgmma, bf16 -> f32
// The m64nN f32 accumulator (PTX ISA), g = lane / 4, q = lane % 4: warp
// w of the warpgroup holds rows 16w .. 16w+15, and for each 8 columns j
// d[4j], d[4j+1] = row g, cols 8j+2q, 8j+2q+1; d[4j+2], d[4j+3] = row g+8.
// A from registers takes mma.sync's m16n8k16 A layout in each warp's 16
// rows, so a score tile's accumulator, paired into bf16, is P's operand.

// d (+)= A (64 x 16, descriptor a) * B^T (32 x 16, descriptor b), both
// K-major, bf16 -> f32; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= A (64 x 16, descriptor a) * B^T (128 x 16, descriptor b), both
// K-major, bf16 -> f32; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= A (64 x 16, descriptor a) * B^T (208 x 16, descriptor b), both
// K-major, bf16 -> f32; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_n208(float (&d)[104], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, %104, %105, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A (64 x 16 in registers, the m16n8k16 A layout a warp) * B
// (16 x 64, descriptor b, MN-major: 16 rows of 64 values), bf16 -> f32
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const unsigned (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 208)
    wgmma_n208(d, a, b, scale_d);
  else if constexpr (N == 128)
    wgmma_n128(d, a, b, scale_d);
  else
    wgmma_n32(d, a, b, scale_d);
}

// ------------------------------------------------------- the bias terms
// Rows 0 .. 32 CH - 1 of the float32 table t [rows, HD] as bf16 hi and lo
// parts, 128-byte rows in the 128-byte swizzle (16-byte piece p of row r
// at piece p ^ (r % 8)); rows past `rows` are zeros.
template <int CH>
__device__ __forceinline__ void split_table(uint8_t* hi, uint8_t* lo,
                                            const float* t, int rows,
                                            int tid, int nthreads) {
  for (int i = tid; i < CH * CHUNK * 8; i += nthreads) {
    const int r = i >> 3, piece = i & 7;
    float x[8];
    if (r < rows) {
      const float4* src =
          reinterpret_cast<const float4*>(t + r * HD + piece * 8);
      const float4 a = __ldg(src), b = __ldg(src + 1);
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
      x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = 0.f;
    }
    unsigned vh[4], vl[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bf16 h0 = __float2bfloat16_rn(x[2 * k]);
      const bf16 h1 = __float2bfloat16_rn(x[2 * k + 1]);
      vh[k] = pack2(h0, h1);
      vl[k] = pack2(__float2bfloat16_rn(x[2 * k] - __bfloat162float(h0)),
                    __float2bfloat16_rn(x[2 * k + 1] - __bfloat162float(h1)));
    }
    const int off = r * ROW + ((piece ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(vh[0], vh[1], vh[2],
                                                     vh[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(vl[0], vl[1], vl[2],
                                                     vl[3]);
  }
}

// One table's terms of a 64-row query tile (q at qt, 128-byte swizzled),
// in log2 units: out[i][jj] = q_i . T[pos_i - jj + k - 1] log2 e for
// jj < k, rows of `stride` floats, pos_i the query's grid row (Rh) or
// column (Rw). q . T^T for all 32 CH table rows, from the hi and lo parts
// into one f32 sum; each product lands in at most one term, and every
// term of a row is one of the products. pos holds the thread's rows
// 16 warp + g and + 8.
template <int CH>
__device__ __forceinline__ void table_terms(float* out, int stride,
                                            const uint8_t* qt,
                                            const uint8_t* hi,
                                            const uint8_t* lo, int k,
                                            const int (&pos)[2], int warp,
                                            int g, int qd) {
  constexpr int N = CHUNK * CH;
  float acc[N / 2];
  const uint64_t dq = desc(qt), dh = desc(hi), dl = desc(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<N>(acc, dq + 2 * kk, dh + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<N>(acc, dq + 2 * kk, dl + 2 * kk, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = v >> 1;
      const int jj = pos[r] - (8 * j + 2 * qd + (v & 1)) + k - 1;
      if (jj >= 0 && jj < k)
        out[(16 * warp + g + 8 * r) * stride + jj] = acc[4 * j + v] * LOG2E;
    }
}

// The bias terms of a thread's rows: bh[r][jh] and bw[r][jw] (rows lr0
// and lr1 of the tile's terms). Strides: bh's odd, so that the 8 rows of
// a warp read 8 banks; bw's 8 + 16 k, so that a half-warp's float2 reads
// of columns 2 qd, 2 qd + 1 of 4 rows (row offsets 0, 8, 16, 24 banks
// apart, in some order) fill the 32 banks once.
__host__ __device__ __forceinline__ int terms_stride_h(int kh) {
  return kh | 1;
}

__host__ __device__ __forceinline__ int terms_stride_w(int kw) {
  return kw <= 8 ? 8 : 8 + 16 * ((kw - 8 + 15) / 16);
}

struct Terms {
  const float* bh[2];
  const float* bw[2];
};

// The scores of a key tile on any grid, x = s scale + bh[jh] + bw[jw]
// (keys at or past l at -inf), and the thread's row maxima. A pair of
// columns 2 qd, 2 qd + 1 is one grid row where kw is even (EVEN: bw read
// as a float2), else the two keys are looked up apart.
template <int BN, bool MASK, bool EVEN>
__device__ __forceinline__ void generic_scores(float (&s)[BN / 2],
                                               float (&tmax)[2],
                                               const Params& p, int k0,
                                               int qd, const Terms& t) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    // the grid row and column of the pair's first key (clamped past l)
    const unsigned key = k0 + 8 * j + 2 * qd;
    const int jh = min(static_cast<int>(__umulhi(key, p.kw_magic) +
                                        key * p.kw_one),
                       p.kh - 1);
    const int jw = min(static_cast<int>(key) - jh * p.kw, p.kw - 1);
    float b[2][2];
    if constexpr (EVEN) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // (a key past l may clamp to the odd last column)
        const float2 w =
            *reinterpret_cast<const float2*>(t.bw[r] + min(jw, p.kw - 2));
        const float hh = t.bh[r][jh];
        b[r][0] = hh + w.x;
        b[r][1] = hh + w.y;
      }
    } else {
      const int jh1 = jw + 1 < p.kw ? jh : min(jh + 1, p.kh - 1);
      const int jw1 = jw + 1 < p.kw ? jw + 1 : 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        b[r][0] = t.bh[r][jh] + t.bw[r][jw];
        b[r][1] = t.bh[r][jh1] + t.bw[r][jw1];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = fmaf(s[4 * j + 2 * r + e], p.scale_log2, b[r][e]);
        if (MASK && static_cast<int>(key) + e >= p.l) x = -INFINITY;
        s[4 * j + 2 * r + e] = x;
        tmax[r] = fmaxf(tmax[r], x);
      }
  }
}

// The online softmax of one key tile (keys k0 .., s = q . k): s becomes
// p = exp2(x - m) in f32, x the score in log2 units with its bias (keys
// at or past l at -inf; MASK: the tile runs past l); m, the row sums and
// alpha, the factor that rescales the sums and the context so far.
// KW64: a 64-wide grid, where a tile of 128 keys is two grid rows u and
// a thread's 16 columns of bw are the same every tile: y = s scale + bw,
// m = max over u of (max y + bh[u]), p = exp2(y + (bh[u] - m)).
template <int BN, bool KW64, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2],
                                             float (&mx)[2], float (&sm)[2],
                                             float (&alpha)[2],
                                             const Params& p, int k0,
                                             int qd, const Terms& t) {
  if constexpr (KW64) {
    // y = s scale + bw; the row maximum m over y + bh[u] (the grid row's
    // term); p = exp2(y + (bh[u] - m))
    const int jh = k0 >> 6, jh1 = min(jh + 1, p.kh - 1);
    float bh[2][2], ymax[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bh[r][0] = t.bh[r][jh];
      bh[r][1] = t.bh[r][jh1];
      ymax[r][0] = ymax[r][1] = -INFINITY;
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float2 bw[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        bw[r] = *reinterpret_cast<const float2*>(t.bw[r] + 8 * jj + 2 * qd);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * (8 * u + jj) + 2 * r + e;
            float y = fmaf(s[i], p.scale_log2, e ? bw[r].y : bw[r].x);
            if (MASK && k0 + 64 * u + 8 * jj + 2 * qd + e >= p.l)
              y = -INFINITY;
            s[i] = y;
            ymax[r][u] = fmaxf(ymax[r][u], y);
          }
    }
    float c[2][2];  // bh[u] - m: the exponent's shift of grid row u
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = fmaxf(mx[r], quad_max(fmaxf(ymax[r][0] + bh[r][0],
                                                  ymax[r][1] + bh[r][1])));
      alpha[r] = ex2(mx[r] - m);
      mx[r] = m;
      sm[r] *= alpha[r];
      c[r][0] = bh[r][0] - m;
      c[r][1] = bh[r][1] - m;
    }
    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // two sums a row
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * (8 * u + jj) + 2 * r + e;
            const float pr = ex2(s[i] + c[r][u]);
            part[r][e] += pr;
            s[i] = pr;
          }
#pragma unroll
    for (int r = 0; r < 2; ++r) sm[r] += part[r][0] + part[r][1];
  } else {
    float tmax[2] = {-INFINITY, -INFINITY};
    if (p.kw & 1)
      generic_scores<BN, MASK, false>(s, tmax, p, k0, qd, t);
    else
      generic_scores<BN, MASK, true>(s, tmax, p, k0, qd, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = fmaxf(mx[r], quad_max(tmax[r]));
      alpha[r] = ex2(mx[r] - m);
      mx[r] = m;
      sm[r] *= alpha[r];
    }
    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // two sums a row
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pr = ex2(s[4 * j + 2 * r + e] - mx[r]);
          part[r][e] += pr;
          s[4 * j + 2 * r + e] = pr;
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) sm[r] += part[r][0] + part[r][1];
  }
}

template <int BN, bool KW64>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2],
                                             float (&mx)[2], float (&sm)[2],
                                             float (&alpha)[2],
                                             const Params& p, int k0,
                                             int qd, const Terms& t) {
  // k0 opaque: the per-column grid indices are worked out again each tile
  // rather than held in registers across the query tiles
  asm volatile("" : "+r"(k0));
  if (k0 + BN > p.l)
    softmax_tile<BN, KW64, true>(s, mx, sm, alpha, p, k0, qd, t);
  else
    softmax_tile<BN, KW64, false>(s, mx, sm, alpha, p, k0, qd, t);
}

// p as the A operand of P V: k step kk takes keys 16 kk .. 16 kk + 15
template <int BN>
__device__ __forceinline__ void to_operand(unsigned (&pa)[BN / 16][4],
                                           const float (&s)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// S = q k^T of a key tile (k at dk), one commit group
template <int BN>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint64_t dq,
                                         uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<BN>(s, dq + 2 * kk, dk + 2 * kk, kk);
  wgmma_commit();
}

// O += P V of a key tile (v at dv: 16 keys are 2048 bytes), one group
template <int BN>
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const unsigned (&pa)[BN / 16][4],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_n64(o, pa[kk], dv + 128 * kk);
  wgmma_commit();
}

// ------------------------------------------------------------ the kernel
// grid (query blocks: of 128 rows, or 1 with a short L; heads; n);
// Cfg<BN>::THREADS threads; dynamic shared memory as the C entry lays it
// out: the query tiles, the K and V stages, the split tables (CH chunks
// each), each consumer warpgroup's bias terms, the mbarriers.
template <int BN, bool KW64, int CH>
__global__ void __launch_bounds__(Cfg<BN>::THREADS, Cfg<BN>::BLOCKS)
    rel_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_kv,
                         const Params p) {
  using C = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles start at a 1024-byte boundary
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;
  uint8_t* ks = qs + C::Q_TILES * TILE;
  uint8_t* vs = ks + C::STAGES * C::KV_BYTES;
  uint8_t* hi_h = base + p.tab_off;
  uint8_t* lo_h = hi_h + CH * CHUNK_BYTES;
  uint8_t* hi_w = lo_h + CH * CHUNK_BYTES;
  uint8_t* lo_w = hi_w + CH * CHUNK_BYTES;
  float* terms = reinterpret_cast<float*>(base + p.terms_off);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(base + p.bar_off);
  uint64_t* full_k = qfull + 1;
  uint64_t* empty_k = full_k + C::STAGES;
  uint64_t* full_v = empty_k + C::STAGES;
  uint64_t* empty_v = full_v + C::STAGES;

  const int h = blockIdx.y, n = blockIdx.z, c = p.nh * HD;
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, 4 * C::CWG);  // lane 0 of each consumer warp
      mbar_init(empty_v + s, 4 * C::CWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ------------------------------------------------------- the loads
  // the producer warp's lane 0 (long L), or thread 0 before it consumes
  // (short L: one key tile, nothing to wait for)
  if (threadIdx.x == (C::LONG ? 128 * C::CWG : 0)) {
    const int row0 = blockIdx.x * p.q_tiles * 64;
    mbar_expect_tx(qfull, p.q_tiles * TILE);
    for (int t = 0; t < p.q_tiles; ++t)
      tma_load3(qs + t * TILE, &map_q, h * HD, row0 + t * 64, n, qfull);
    for (int kb = 0; kb < p.nkb; ++kb) {
      const int st = kb % C::STAGES;
      const unsigned ph = (kb / C::STAGES) & 1;
      mbar_wait(empty_k + st, ph ^ 1);
      mbar_expect_tx(full_k + st, C::KV_BYTES);
      tma_load3(ks + st * C::KV_BYTES, &map_kv, c + h * HD, kb * BN, n,
                full_k + st);
      mbar_wait(empty_v + st, ph ^ 1);
      mbar_expect_tx(full_v + st, C::KV_BYTES);
      tma_load3(vs + st * C::KV_BYTES, &map_kv, 2 * c + h * HD, kb * BN, n,
                full_v + st);
    }
  }
  if (threadIdx.x >= 128 * C::CWG) return;

  // ------------------------------------------------------ consumers
  // the warpgroup and warp as warp-uniform values (a shuffle from lane
  // 0), so that ptxas sees the branches on them as uniform
  const int wg = __shfl_sync(FULL, static_cast<int>(threadIdx.x) / 128, 0);
  const int warp =
      __shfl_sync(FULL, static_cast<int>(threadIdx.x / 32) & 3, 0);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;

  split_table<CH>(hi_h, lo_h, p.rel_pos_h, 2 * p.kh - 1, threadIdx.x,
                  128 * C::CWG);
  split_table<CH>(hi_w, lo_w, p.rel_pos_w, 2 * p.kw - 1, threadIdx.x,
                  128 * C::CWG);
  // the tables were written by the generic proxy, wgmma reads them
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1, 128 * C::CWG);

  const int sh = terms_stride_h(p.kh), sw = terms_stride_w(p.kw);
  float* bh = terms + wg * 64 * (sh + sw);
  float* bw = bh + 64 * sh;
  const int lr0 = 16 * warp + g, lr1 = lr0 + 8;  // the thread's tile rows
  const Terms tt = {{bh + lr0 * sh, bh + lr1 * sh},
                    {bw + lr0 * sw, bw + lr1 * sw}};
  bf16* out = p.ctx + h * HD + 2 * qd;

  mbar_wait(qfull, 0);
  for (int t = wg; t < p.q_tiles; t += C::CWG) {
    const int q0 = (blockIdx.x * p.q_tiles + t) * 64;
    const uint8_t* qt = qs + t * TILE;
    if (t != wg) named_sync(4 + wg, 128);  // the last tile's terms are read
    {
      int ih[2], iw[2];  // rows past l take the last query's terms
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = min(q0 + lr0 + 8 * r, p.l - 1);
        ih[r] = qi / p.kw;
        iw[r] = qi - ih[r] * p.kw;
      }
      table_terms<CH>(bh, sh, qt, hi_h, lo_h, p.kh, ih, warp, g, qd);
      table_terms<CH>(bw, sw, qt, hi_w, lo_w, p.kw, iw, warp, g, qd);
    }
    named_sync(4 + wg, 128);
    float o[32], s[BN / 2], alpha[2];
    unsigned pa[BN / 16][4];  // the last tile's P, the A operand of P V
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
    const uint64_t dq = desc(qt);

    // key tile 0 (long L: warpgroup 0 takes both tokens first: barriers
    // 2 + wg pass the tensor cores, 6 + wg the softmax)
    mbar_wait(full_k, 0);
    if (C::LONG) {
      if (wg == 1) named_arrive(2, 256);
      named_sync(2 + wg, 256);
    }
    wgmma_fence();
    issue_qk<BN>(s, dq, desc(ks));
    if (C::LONG && (wg == 0 || p.nkb > 1)) named_arrive(3 - wg, 256);
    wgmma_wait<0>();
    fence_operands(s);
    if (lane == 0) mbar_arrive(empty_k);
    if (C::LONG) {
      if (wg == 1) named_arrive(6, 256);
      named_sync(6 + wg, 256);
    }
    softmax_tile<BN, KW64>(s, mx, sm, alpha, p, 0, qd, tt);
    if (C::LONG && (wg == 0 || p.nkb > 1)) named_arrive(7 - wg, 256);
    to_operand<BN>(pa, s);

    // key tiles 1 ..: S of this tile and P V of the one before issued in
    // this warpgroup's turn, then the softmax while the other's run
    int pst = 0;
    unsigned pph = 0;
    for (int kb = 1; kb < p.nkb; ++kb) {
      const int st = kb % C::STAGES;
      const unsigned ph = (kb / C::STAGES) & 1;
      mbar_wait(full_k + st, ph);
      mbar_wait(full_v + pst, pph);
      if (C::LONG) named_sync(2 + wg, 256);
      wgmma_fence();
      issue_qk<BN>(s, dq, desc(ks + st * C::KV_BYTES));
      issue_pv<BN>(o, pa, desc(vs + pst * C::KV_BYTES));
      // the other warpgroup's turn (warpgroup 1 owes none after its last)
      if (C::LONG && (wg == 0 || kb + 1 < p.nkb)) named_arrive(3 - wg, 256);
      wgmma_wait<1>();
      fence_operands(s);
      if (lane == 0) mbar_arrive(empty_k + st);
      if (C::LONG) named_sync(6 + wg, 256);
      softmax_tile<BN, KW64>(s, mx, sm, alpha, p, kb * BN, qd, tt);
      if (C::LONG && (wg == 0 || kb + 1 < p.nkb)) named_arrive(7 - wg, 256);
      wgmma_wait<0>();
      fence_operands(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(empty_v + pst);
      if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
      }
      to_operand<BN>(pa, s);
      pst = st;
      pph = ph;
    }
    // P V of the last tile
    mbar_wait(full_v + pst, pph);
    wgmma_fence();
    issue_pv<BN>(o, pa, desc(vs + pst * C::KV_BYTES));
    wgmma_wait<0>();
    fence_operands(o);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(empty_v + pst);

    const float inv0 = 1.f / quad_sum(sm[0]), inv1 = 1.f / quad_sum(sm[1]);
    const int r0 = q0 + lr0, r1 = q0 + lr1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (r0 < p.l)
        *reinterpret_cast<unsigned*>(
            out + (static_cast<size_t>(n) * p.l + r0) * c + 8 * j) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < p.l)
        *reinterpret_cast<unsigned*>(
            out + (static_cast<size_t>(n) * p.l + r1) * c + 8 * j) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// --------------------------------------------------------------- launch
// qkv [n, l, 3 c] bf16 as a 3-D map whose box is one head's 64 columns
// of `rows` tokens in the 128-byte swizzle (tokens past l read as zeros)
bool make_map(CUtensorMap* map, const void* qkv, int n, int l, int c3,
              int rows) {
  locov::EncodeTiled fn = locov::encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)c3, (cuuint64_t)l, (cuuint64_t)n};
  cuuint64_t strides[2] = {(cuuint64_t)c3 * 2, (cuuint64_t)l * c3 * 2};
  cuuint32_t box[3] = {HD, (cuuint32_t)rows, 1};
  cuuint32_t steps[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(qkv), dims, strides, box, steps,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool KW64, int CH>
int launch(const void* qkv, Params p, int n, cudaStream_t stream) {
  using C = Cfg<BN>;
  auto kernel = rel_attention_kernel<BN, KW64, CH>;
  CUtensorMap map_q, map_kv;
  const int c3 = 3 * p.nh * HD;
  if (!make_map(&map_q, qkv, n, p.l, c3, 64) ||
      !make_map(&map_kv, qkv, n, p.l, c3, BN))
    return ENCODE_FAILED;
  p.q_tiles = C::LONG ? 2 : (p.l + 63) / 64;
  p.nkb = (p.l + BN - 1) / BN;
  p.tab_off = C::Q_TILES * TILE + 2 * C::STAGES * C::KV_BYTES;
  p.terms_off = p.tab_off + 4 * CH * CHUNK_BYTES;
  const int sh = terms_stride_h(p.kh), sw = terms_stride_w(p.kw);
  p.bar_off = p.terms_off + C::CWG * 64 * (sh + sw) * 4;
  p.bar_off = (p.bar_off + 7) & ~7;
  const size_t smem = 1024 + p.bar_off + (1 + 4 * C::STAGES) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // all of the SM's 228 KB as shared memory
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(C::LONG ? (p.l + 127) / 128 : 1, p.nh, n);
  kernel<<<grid, C::THREADS, smem, stream>>>(map_q, map_kv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv [n, l, 3 nh hd] bf16 (q, k, v side by side, a head's hd columns
// together; 16-byte aligned), rel_pos_h [2 kh - 1, hd] and rel_pos_w
// [2 kw - 1, hd] f32 (16-byte aligned) -> ctx [n, l, nh hd] bf16, every
// element written. hd must be 64, l = kh kw, kh and kw at most 64;
// scale = 1 / sqrt(hd). Returns cudaErrorInvalidValue for shapes the
// kernel does not take, 1001 where a tensor map cannot be encoded, else
// the first CUDA error of the launch, or 0.
extern "C" int rel_attention_fwd(const void* qkv, const void* rel_pos_h,
                                 const void* rel_pos_w, void* ctx, int n,
                                 int l, int nh, int hd, int kh, int kw,
                                 float scale, void* stream) {
  if (hd != HD || n < 1 || nh < 1 || kh < 1 || kw < 1 || kh > MAX_GRID ||
      kw > MAX_GRID || l != kh * kw || n > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.rel_pos_h = static_cast<const float*>(rel_pos_h);
  p.rel_pos_w = static_cast<const float*>(rel_pos_w);
  p.ctx = static_cast<bf16*>(ctx);
  p.l = l;
  p.nh = nh;
  p.kh = kh;
  p.kw = kw;
  p.scale_log2 = scale * LOG2E;
  p.kw_magic = static_cast<unsigned>(((1ull << 32) + kw - 1) / kw);
  p.kw_one = kw == 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the table chunks of 32 rows: all four past a short L, one in a window
  // of up to 16 x 16
  const bool one_chunk = 2 * (kh > kw ? kh : kw) - 1 <= CHUNK;
  if (l <= SHORT)
    return one_chunk ? launch<SHORT, false, 1>(qkv, p, n, s)
                     : launch<SHORT, false, MAX_CHUNKS>(qkv, p, n, s);
  if (kw == 64) return launch<128, true, MAX_CHUNKS>(qkv, p, n, s);
  return launch<128, false, MAX_CHUNKS>(qkv, p, n, s);
}
