// Warp-level tensor-core and async-copy primitives (PTX, sm_80 and later),
// shared by the mma.sync kernels: cp.async 16-byte copies with zero fill,
// ldmatrix (x4, x2 and x4 transposed), the two mma.sync shapes the port uses,
// bf16 m16n8k16 -> f32 and s8 m16n8k32 -> s32, and the bf16 packing of f32
// pairs into one A-fragment register.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16/k32"), with
// lane = 4 * gid + tig (gid = lane / 4, tig = lane % 4):
//   bf16 A 16x16: a0 (row gid, k 2tig..+1), a1 (row gid+8, same k),
//                 a2 (row gid, k 2tig+8..+9), a3 (row gid+8, k 2tig+8..+9);
//   bf16 B 16x8:  b0 (k 2tig..+1, col gid), b1 (k 2tig+8..+9, col gid);
//   s8 A 16x32:   a0 (row gid, k 4tig..+3), a1 (row gid+8, same k),
//                 a2 (row gid, k 16+4tig..+3), a3 (row gid+8, k 16+4tig..+3);
//   s8 B 32x8:    b0 (k 4tig..+3, col gid), b1 (k 16+4tig..+3, col gid);
//   C/D 16x8:     d0, d1 (row gid, cols 2tig, 2tig+1), d2, d3 (row gid+8).
// The lower k (or column) sits in the lower bits of a packed register.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; the bytes past `src_bytes`
// (0..16) are zero-filled and not read. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and r[i] is this lane's fragment of matrix i (row gid, elements
// 2tig, 2tig+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two 8x8 b16 matrices: lanes 0-15 give the row addresses (lane l: row
// l % 8 of matrix l / 8); the other lanes' addresses are not read.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// As ldmatrix_x4, each matrix transposed: r[i] holds (row 2tig, col gid)
// and (row 2tig+1, col gid) of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += A (16x16 bf16, row-major) . B (16x8 bf16, column-major), f32.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A (16x32 s8, row-major) . B (32x8 s8, column-major), exact s32.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 as two bf16 (round to nearest even) in one register, `lo` in the
// lower half: the lower k (or column) of an A fragment or an output pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
