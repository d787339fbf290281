// wgmma on Hopper: shared-memory descriptors, fences and split-TF32
// products, shared by the SSD chunk kernel and both flash-attention kernels.
//
// A float32 operand a is split into two tf32 values, hi = tf32(a) and
// lo = tf32(a - hi), each rounded to nearest with ties away from zero (as
// cvt.rna rounds), and a product a*b is taken as
//     lo(a)*hi(b) + hi(a)*lo(b) + hi(a)*hi(b)
// in that order into one float32 accumulator (the two small terms first),
// three tf32 tensor-core products in place of one float32 product. What
// is dropped, lo*lo and the rounding of lo, is within about 2^-21 of |a*b|:
// near float32, where one tf32 product keeps about 2^-11 (CUTLASS calls
// this OpMultiplyAddFastF32; tests/test_torch_split_tf32.py holds the
// arithmetic on the CPU).
//
// wgmma takes tf32 operands K-major only (unlike bf16 it has no transpose
// bit), so every B operand sits in shared memory with the summed index
// contiguous: tiles of rows of 32 floats (128 bytes) in the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)); a k8 step is
// 32 bytes of every row, 8 rows are 1024 bytes apart.
//
// Register fragments, per warp of the warpgroup (rows 16*warp + ...;
// g = lane / 4, c = lane % 4):
//   accumulator m64nN: d[4j + e] at (g, 8j + 2c + e), d[4j + 2 + e] at
//     (g + 8, 8j + 2c + e), e in {0, 1};
//   tf32 A operand m64nNk8: a[0] at (g, c), a[1] at (g + 8, c), a[2] at
//     (g, c + 4), a[3] at (g + 8, c + 4).
// The two differ, so an accumulator (a score or decay matrix) becomes an A
// operand without any exchange between threads by permuting the summed
// index within each block of 8: A column slot s holds true column
// kSlotCol[s] = 2s (s < 4) or 2(s - 4) + 1, so a = {d[4j], d[4j+2],
// d[4j+1], d[4j+3]}, and the B operand stores true row k of the block at
// slot k / 2 + 4 (k % 2). A product over the whole block is unchanged.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace wg {

// tf32(a) as cvt.rna.tf32.f32 gives it for finite a: half a tf32 ulp added
// to the magnitude, the 13 low bits cleared. Two integer operations on the
// full-rate ALU, where cvt.rna issues on the quarter-rate unit that exp2
// also needs.
__device__ __forceinline__ uint32_t rna_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(a), lo = tf32(a - hi), as float32 bit patterns (a - hi is exact
// in float32).
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(a);
  lo = rna_tf32(a - __uint_as_float(hi));
}

// Float offset of (row, col) in a tile of rows of 32 floats in the 128-byte
// swizzle; the tile starts on a 1024-byte boundary.
__device__ __forceinline__ int swz(int row, int col) {
  return row * 32 + ((((col >> 2) ^ (row & 7))) << 2) + (col & 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (in 16-byte units), swizzle layout (1 = 128 B, 2 = 64 B, 3 = 32 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// Descriptor of a K-major tile in the 128-byte swizzle at byte `addr`.
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return make_desc(addr, 16, 1024, 1);
}

// Makes this thread's generic stores to shared memory visible to the
// tensor cores (the async proxy); a barrier must follow before wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The A fragments (hi, lo) of k8 block j of an accumulator d, columns
// permuted as above: slot c <- column 2c, slot c + 4 <- column 2c + 1.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N], int j,
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(d[4 * j], hi[0], lo[0]);
  split(d[4 * j + 2], hi[1], lo[1]);
  split(d[4 * j + 1], hi[2], lo[2]);
  split(d[4 * j + 3], hi[3], lo[3]);
}

// D[64x64] += A[64x8] * B[64x8]^T in tf32, A and B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(1));
}

// D[64x16] += A[64x8] * B[16x8]^T in tf32, A in registers (tf32 bit
// patterns in the fragment layout above), B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// D[64x32] += A[64x8] * B[32x8]^T in tf32, A in registers (tf32 bit
// patterns in the fragment layout above), B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// D[64x64] += A[64x8] * B[64x8]^T in tf32, A in registers (tf32 bit
// patterns in the fragment layout above), B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// D[64x128] += A[64x8] * B[128x8]^T in tf32, A in registers (tf32 bit
// patterns in the fragment layout above), B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

}  // namespace wg
