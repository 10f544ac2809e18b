// bfloat16 tensor-core helpers shared by the port's matrix kernels:
// ldmatrix loads from shared memory and the m16n8k16 mma.sync (sm_80 and
// later; Hopper runs it on its tensor cores), f32 accumulators.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16" for .bf16), with
// g = lane / 4 and q = lane % 4:
//   A (16 x 16, row-major): a0 = (row g, cols 2q, 2q+1), a1 = (row g+8,
//     the same cols), a2 = (row g, cols 2q+8, 2q+9), a3 = (row g+8, ...).
//   B (16 x 8, K x N): b0 = (k 2q, 2q+1; col g), b1 = (k 2q+8, 2q+9; g).
//   C (16 x 8, f32): c0, c1 = (row g, cols 2q, 2q+1), c2, c3 = (row g+8).
// Both loaders take one row address per lane: row (lane % 16) of the
// 16-row tile, at column offset 8 * (lane / 16). Every row address must
// be 16-byte aligned.
#pragma once

#include <cuda_bf16.h>

namespace locov {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The A fragment of a 16 x 16 row-major tile.
__device__ __forceinline__ void ldmatrix_a(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The B fragments of two 16 x 8 tiles side by side (columns n0 .. n0+15)
// of a row-major [K][N] tile: r[0], r[1] for columns n0 .. n0+7 and
// r[2], r[3] for n0+8 .. n0+15.
__device__ __forceinline__ void ldmatrix_b2(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d[0..3] += a * b on the tensor cores, bf16 products, f32 sum.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace locov
