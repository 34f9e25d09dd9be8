// Tensor-core building blocks shared by the port's CUDA sources:
//   - sm_80 instructions, which sm_90a runs: 16-byte cp.async copies with
//     zero fill, ldmatrix, and the bf16 mma.sync.m16n8k16 product with fp32
//     accumulators;
//   - sm_90a's warpgroup products wgmma.m64n128k16 (bf16 operands read
//     from shared memory through matrix descriptors) and wgmma.m64n128k8
//     (tf32: A from registers, B from shared memory), both with fp32
//     accumulators in registers, and the fences around them;
//   - cvt.rna.tf32.f32, the rounding that splits an fp32 value into a tf32
//     big part and a tf32 small part.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, q = lane % 4):
//   A (16 x 16, row-major) a[0..3]: (row g, k 2q..2q+1), (g + 8, 2q..),
//     (g, 8 + 2q..), (g + 8, 8 + 2q..); one ldmatrix.x4 loads it when lane l
//     points at row l % 16, k 8 (l / 16) of the tile.
//   B (16 x 8, k x n) b[0..1]: (k 2q..2q+1, n g), (k 8 + 2q.., n g); from a
//     [k][n] row-major tile, one ldmatrix.x4.trans loads two n8 fragments
//     (n 0-7: r[0], r[1]; n 8-15: r[2], r[3]) when lane l points at k row
//     l % 16, n 8 (l / 16) of a 16 x 16 tile.
//   C (16 x 8, fp32) c[0..3]: (row g, n 2q..2q+1), (g + 8, 2q..2q+1).
// wgmma.m64n128k16's accumulator d[64] in a warpgroup of 4 warps: warp w
// holds rows 16 w + g and 16 w + g + 8 of the 64, as d[4 i + 0..1] and
// d[4 i + 2..3], at columns 8 i + 2q..2q+1 (i = 0..15); m64n128k8's is
// the same. wgmma.m64n128k8.tf32's A [64 x 8] from registers a[0..3]:
// warp w holds (row 16 w + g, k q), (16 w + g + 8, q), (16 w + g, q + 4),
// (16 w + g + 8, q + 4), the m16n8k8 tf32 layout per warp.
// Each pointer handed to ldmatrix and cp.async16 is 16-byte aligned.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared (L2 only); zero-fills the 16
// bytes when !pred (src is then not read but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b on bf16 operands with fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to tf32 (10 stored mantissa bits), to nearest with ties away
// from zero; the low 13 bits of the result are 0, so it is also the fp32
// value it stands for.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// Element offset of 16-byte chunk `chunk` of row `row` in a tile whose rows
// hold `kChunks` such chunks, with the chunk index XOR-swizzled by row % 8:
// the 8 rows an ldmatrix reads at one logical chunk land on 8 different
// 16-byte bank groups. kChunks is a multiple of 8. With kChunks = 8 (rows
// of 128 bytes) on a 1024-byte-aligned tile this is the hardware's 128-byte
// swizzle, which wgmma's descriptors name.
template <int kChunks>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kChunks * 8 + ((chunk ^ (row & 7)) << 3);
}

// wgmma matrix descriptor of a bf16 tile at shared address `at` made of
// 128-byte rows (64 values), 128-byte-swizzled in 8-row atoms of 1024 bytes:
// start >> 4, leading byte offset `lbo` >> 4, stride byte offset 1024 >> 4
// (the next 8 rows), swizzle mode 1 (128 bytes).
//   - K-major (a row per M or N index, 64 values of K): `lbo` is unused; a
//     16-deep k step within the 64 advances `at` by 32 bytes.
//   - MN-major (a row per K index, 64 values of M or N): `lbo` is the byte
//     stride between blocks of 64 M or N values; a 16-deep k step advances
//     `at` by 16 rows, 2,048 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t at,
                                               uint32_t lbo = 16) {
  return static_cast<uint64_t>((at & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// mbarriers in shared memory (sm_80 and later): init with the number of
// arrivals a phase needs; arrive; an arrival triggered once all of the
// thread's earlier cp.async copies have landed (.noinc: it counts as one of
// the phase's arrivals); and a wait for the phase of the given parity to
// complete. A barrier used once every R uses of a ring of R waits on parity
// (use / R) & 1.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Orders the thread's earlier shared-memory writes (cp.async included, once
// waited for) before the async proxy's reads: wgmma reads through it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// d (+)= A[64 x 16] . B[16 x 128] on the warpgroup from shared memory, A
// K-major (descriptor da) and B MN-major, N contiguous (descriptor db, the
// instruction's B transpose bit set); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float d[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// Pins the registers d[0..kN-1] here: the compiler moves no read or write
// of them across this point. After wgmma_wait it keeps the reads of a
// wgmma's accumulators behind the wait.
template <int kN>
__device__ __forceinline__ void fence_operand(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A[64 x 8] . B[8 x 128] on the warpgroup in tf32, A from registers
// (a[0..3], the layout at the head) and B K-major from shared memory
// (descriptor db: 128-byte rows of 32 fp32 values of K, 128-byte swizzle;
// a k step of 8 advances it by 32 bytes, as bf16's k step of 16 does);
// accumulate = 0 overwrites d. tf32 has no transpose bit: both operands
// are K-major.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float d[64],
                                                     const uint32_t a[4],
                                                     uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

}  // namespace tc
